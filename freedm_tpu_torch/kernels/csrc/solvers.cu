// Power-flow solver kernels for Hopper (sm_90a): the per-lane Ybus stamp,
// the fast-decoupled half-step, the residual JVP of the matrix-free Newton
// solver, the three-phase current-injection iteration, and the reverse
// modes of the residual (J2) and of the current-injection iteration (I2).
//
// Y1 ybus_stamp — replaces freedm_tpu/grid/bus.py:130-158 `ybus_dense(sys,
//   status)` under vmap (a [B, n, n] stamp per outage lane), and the lane
//   forms of freedm_tpu/pf/fdlf.py:70-90 `b_prime(status)` and
//   `b_dblprime(y)`.  Modes:
//     YBUS   (re, im) of Ybus, the shunts on the diagonal;
//     BPRIME 1/x scaled by status, pinned rows/columns identity (th_free);
//     BDBL   -Im Ybus, pinned by v_free.
//   Design: one CTA per (row, lane).  Its threads zero the row with
//   coalesced stores; then thread 0 walks the row's incidence list (the
//   bus's from-end edges, then its to-end edges, each ascending) and is
//   the one owner of every entry of the row, so parallel branches add in a
//   fixed order — the reference's scatter order: the diagonal sums its
//   from-end terms, then its to-end terms, then the shunt; an off-diagonal
//   entry its yft terms, then its ytf terms.  Bound: the output bytes,
//   B n^2 values per output (26.3 MB at mesh118 x 118 in YBUS, ~7.8 us).
//
// F1 fdlf_half_step — replaces the body of freedm_tpu/pf/fdlf.py:167-179
//   `_step` around its two LU solves, with `_mismatch` (:128-132),
//   `_err_from` (:134-138) and the lane select of `_solve_impl`'s vmapped
//   while_loop (:186-205).  Modes:
//     INIT   dp, dq at the start point;
//     THETA  theta += d th_free on active lanes, then dq at the new theta;
//     V      V += d v_free on active lanes, then dp (kept on active lanes),
//            the lane's error max(|dp V|, |dq V|), it + 1 and
//            active = it < max_iter and err >= tol (unless `fixed`).
//   Two forms.  With a shared y [n, n] and at least 4 lanes
//   (solver_kernels.TILED_MIN_LANES; the wrapper passes `splits` > 0), three
//   launches: a pre-pass applies the update and writes V's real and
//   imaginary parts; K2's tiled product (row_product.cuh: 64 rows x 64
//   lanes a block over a K slice, float64 on the tensor cores) handing each
//   (lane, row) to `FdlfEpilogue`, which leaves a max a (lane, 64-row
//   tile); in V mode a finish kernel, one warp a lane, reduces those (a
//   max: exact in any order, NaN kept) and updates it/err/active.
//   With a per-lane y [B, n, n], or fewer lanes (a tile would idle), one
//   launch a half-step (`fdlf_warp_kernel`): a CTA of 8 warps takes `rows`
//   consecutive rows of one lane (solver_kernels.fdlf_warp_plan).  It
//   first forms the lane's whole updated V (V cos theta, V sin theta) in
//   shared memory from x and the LU answer d (16 n bytes in float64: n <=
//   14,272; 8 n in float32: n <= 28,544), then a warp a row streams the
//   row with eight independent loads in flight a thread (each thread's
//   columns j = ln mod 32 in increasing order, the fixed xor-shuffle tree:
//   K2's warp form's bits) and runs the mismatch epilogue.  Two integer
//   tickets a lane (a __threadfence before each, the counter reset by its
//   last taker): the last CTA to have read x writes the half's update of
//   x (while the others stream y), the last CTA to finish runs the lane
//   finish; a CTA's row errors reach it as one max.
//   Bound at mesh2000 x 1: one read of y, 64 MB, ~19 us.
//
// J1 residual_jvp — replaces the `jax.linearize` JVP of the masked
//   residual in freedm_tpu/pf/krylov.py:594-608 (and :643-687 in float32)
//   over freedm_tpu/pf/mfree.py:34-65 `make_injection_fn`: J u for
//   x, u [B, 2n].  Per branch end, with Vc = V e^{j theta}:
//     dVc = (dV cos - V sin dtheta, dV sin + V cos dtheta),
//     I = y_self Vc_i + y_mut Vc_j, dI = y_self dVc_i + y_mut dVc_j,
//     dS = dVc_i conj(I) + Vc_i conj(dI);
//   the shunts add 2 g V dV and -2 b V dV; pinned rows pass u through.
//   Bound: the bytes of x, u, status and the output (~24.6 MB at mesh2000
//   x 256 without status, ~7.5 us).  A thread per (lane, bus) walking its
//   CSR list (the wide route below; 0.064 ms there on an H100) is held by
//   per-entry work: each entry gathers its neighbour's theta, V, dtheta,
//   dV from device memory (four 32-byte sectors for 32 bytes) and runs a
//   sincos (2m + n a lane where n would do), and every lane re-reads the
//   incidence operands uncoalesced.  Design (two routes, the same bits,
//   solver_kernels.residual_plan):
//     staged (residual_staged_kernel, below): a CTA stages each of its
//       lanes once — one sincos a bus — in shared memory and walks the
//       sliced ELL of solver_kernels.residual_layout (buses by degree, a
//       warp's step reading consecutive entries), each entry's operands
//       applied to every lane it holds; a bus's sums run in CSR order, the
//       from-end and to-end sums apart and added last, as the reference's
//       two segment sums.  No atomics, no scratch.
//     wide (jvp_kernel): a thread a (lane, bus), for a lane past the
//       staging capacity (48 n bytes in float64, 24 n in float32, plus m
//       values with a per-lane status, of 232,448).
//   Both write every rounding out (Rn, dotp, dotm: jvp_stage, jvp_term,
//   jvp_finish), so a lane's bits do not depend on the route, the plan or
//   the launch width.  Measured on an H100 80GB HBM3 at 700 W (lab runs,
//   mesh2000 x 256, queued events): 0.0256-0.0259 ms f64, 0.0180-0.0187
//   f32 (the wide route 0.064 / 0.044), of which ~5.3 us the launch as
//   this clock sees it, ~4.4 the stage (at the card's memory rate), ~4.1
//   the finish and ~11.4 the walk (its operand loads ~5.7 of it; the
//   shared-memory gathers' bank conflicts ~0.2, its arithmetic ~0.5-1);
//   deeper unrolls, a prefetch of the next slice, 768 or 1024 threads and
//   two CTAs an SM each moved it by under 5%.
//
// I1 cim_iterate — replaces freedm_tpu/pf/cim.py:157-170 `_matvec` and
//   `_iterate` with the loop's max |v_new - v| (:195-240): the injection
//   conj(S/V) on live node-phases, the complex product with A = Y_LL^-1,
//   v_base +, the phase mask, and it/active as in F1.  Design: a pre-pass
//   writes each lane's injection once an iteration into a [B, N] (re, im)
//   scratch (computed while a tile is staged, it costs two divisions in
//   every row block that stages it: N/64 times an iteration); the product
//   is row_product.cuh's tiled form over that scratch (float64 on the
//   tensor cores), its epilogue (`CimEpilogue`) v_new (into a second
//   buffer: the solver's loop keeps v and v_new apart) and the row's |dv|,
//   reduced to a max a (lane, 64-row tile); the finish kernel reduces a
//   lane's ceil(N / 64) maxima (N row errors a lane took it 8.5 us on an
//   H100 at N = 3000, B = 64).  Bound: 8 N^2 B operations at the
//   tensor-core rate (4.6 GFLOP, ~69 us at nb = 1000, B = 64) above one
//   read of A, 16 N^2 bytes (144 MB, ~43 us).
//
// J2 residual_vjp — replaces the reverse mode of the residual and of the
//   injections that jax.grad takes through the fixed solves:
//   freedm_tpu/pf/newton.py:341-352 (the `lax.scan` of `_newton_step` and
//   `build_result`'s s_calc), pf/krylov.py:594 and pf/fdlf.py:207.  w^T dF/dx
//   for x = theta || V, w [B, 2n]: MASKED, the transpose of J1's masked
//   residual Jacobian (pinned rows pass w through); FULL, the injections
//   (P, Q) of every bus.  With omega = w_P + j w_Q (masked to the free rows
//   in MASKED mode), each incidence entry of bus k (neighbour j) adds to the
//   gradient in Vc_k
//     conj(omega_k y_self) Vc_k + omega_k I + conj(omega_j y_mut') Vc_j,
//   I = y_self Vc_k + y_mut Vc_j the branch current at k's end and y_mut'
//   the other end's mutual admittance (solver_kernels.VjpOperands); then
//   theta_bar = V (G_im cos - G_re sin), V_bar = G_re cos + G_im sin +
//   2 V (omega_P g_sh - omega_Q b_sh).  Design: J1's two routes
//   (residual_staged_kernel with the masked omega staged beside Vc; wide,
//   vjp_kernel), one accumulator, no scratch, no atomics, every rounding
//   written out (vjp_term, vjp_finish).  Bound: the bytes of x, w, status
//   and the output (~24.6 MB at mesh2000 x 256 without status).  Measured
//   as J1 (lab runs): MASKED 0.0283-0.0285 ms, FULL 0.0269-0.0270 (the
//   wide route 0.077-0.081 / 0.063-0.068).
//
// I2 cim_vjp — replaces the reverse mode of the iterations of
//   freedm_tpu/pf/cim.py:163 `_iterate` (with `_matvec` :157) under
//   jax.grad of `_solve_fixed` (:215): for the masked cotangent g of v' =
//   mask (v_base + A conj(s/v)), the product p = A^H g (A^H staged once a
//   solver, solver_kernels.cim_adjoint_matrix: the real pair's transpose of
//   A's product) and each entry's 2 x 2 real derivative of conj(s/v)
//   (`CimVjpEpilogue`): with q = conj(p) on live node-phases, sbar +=
//   conj(1/v) q (the load cotangent), g_v = mask conj(-s/v^2) q (0 on dead
//   phases), the next step's cotangent, added to vbbar (v_base's).
//   Design (`cim_vjp_walk`): one persistent cooperative launch walks every
//   iteration of a backward (one step for a single call), each step two
//   phases between integer grid barriers (counters, no float atomics):
//     product  the (tile, K stage) units of A^H g — 64 rows x 64 lanes x
//              16 columns, row_product.cuh's staging (its header untouched:
//              K2, F1 and I1 keep their bits) — cut into kWalkItems even
//              runs (Stream-K: no wave tail; 47 row tiles x 188 stages at
//              N = 3000, B = 64 give items of 66 or 67 stages, one a
//              resident CTA of 16 warps an SM), six stages in flight,
//              waited for two at a time; float64 by Gauss's three real
//              products on the FP64 tensor cores (WalkMac); each run's
//              sums over a tile into its own slot of an L2-resident
//              scratch through shared memory;
//     reduce   each CTA an even share of the (lane, row) entries, each
//              entry its tile's slots added in item order, then the
//              epilogue above.
//   The items and slots are a function of the shape alone, so the bits do
//   not depend on the launch width and a walk of k steps gives the bits of
//   k single calls.  The cotangent crosses CTAs through L2 only (cp.async
//   .cg, ld.cg).  Bound: I1's, 8 N^2 B operations a step at the
//   tensor-core rate above one read of A^H (16 N^2 bytes).
//   Measured on an H100 80GB HBM3 at 700 W (lab runs, the CIM feeder x 64,
//   queued events; a call / an iteration of a 60-step walk, ms; complex128
//   torch.matmul of A^H with the cotangents 0.104-0.106): 264 items on two
//   CTAs of 8 warps an SM, four products, three stages (ptxas spilled ~200
//   bytes) 0.149 / 0.141 — its product alone 0.117, its reduce ~0.017, two
//   barriers 0.005; 132 items on that grid 0.154 / 0.146; the segment not
//   inlined 0.155 / 0.148; one CTA of 8 warps an SM (240 registers, no
//   spill) 0.138 / 0.131, with Gauss 0.132 / 0.125 (three or six stages
//   0.132 / 0.125, 0.134 / 0.127); 16 warps of 16 x 16 tiles, Gauss, six
//   stages in pairs, two entries a reduce thread 0.125-0.127 / 0.116-0.118
//   (its product alone 0.098: its products without loads 0.084, its loads
//   without products 0.062), four products there 0.133 / 0.124, one entry
//   a reduce thread 0.118 / 0.108 (this form).  The split-K form it
//   replaces (the tiled product into an [8, 2, B, N] scratch, then an
//   epilogue launch: a launch a step) took 0.130 ms a call.
//
// Every sum runs in a fixed order and no kernel uses a float atomic, so
// each is bit-identical on repeat.  Simple and right first.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "grid_sync.cuh"
#include "row_product.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void sincos_(double x, double* s, double* c) { sincos(x, s, c); }
__device__ __forceinline__ void sincos_(float x, float* s, float* c) { sincosf(x, s, c); }

template <typename T>
__device__ __forceinline__ T nan_() { return T(NAN); }

// ---------------------------------------------------------------------------
// Y1
// ---------------------------------------------------------------------------

constexpr int YBUS = 0, BPRIME = 1, BDBL = 2;
constexpr int kStampThreads = 128;

// Rows of the branch table `br` [8, m] (YBUS, BDBL): the two-port
// admittances yff, yft, ytf, ytt as (re, im).  BPRIME reads 1/x [m].
template <typename T>
__global__ void __launch_bounds__(kStampThreads) stamp_kernel(
    int mode, const int* __restrict__ inc_ptr, const int* __restrict__ inc_code,
    const int* __restrict__ inc_nbr, const T* __restrict__ br,
    const T* __restrict__ status,  // [lanes, m]
    const T* __restrict__ g_sh, const T* __restrict__ b_sh,
    const T* __restrict__ keep,  // [n] th_free (BPRIME) or v_free (BDBL)
    T* __restrict__ out_a, T* __restrict__ out_b, int n, int m) {
  const int i = blockIdx.x;
  const int64_t lane = blockIdx.y;
  const int64_t row = (lane * n + i) * (int64_t)n;
  T* ra = out_a + row;
  T* rb = mode == YBUS ? out_b + row : nullptr;
  for (int j = threadIdx.x; j < n; j += kStampThreads) {
    ra[j] = T(0);
    if (rb != nullptr) rb[j] = T(0);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  if (mode != YBUS && !(keep[i] > T(0))) {  // a pinned row: identity
    ra[i] = T(1);
    return;
  }
  const T* st = status + lane * m;
  T d_re = T(0), d_im = T(0);
  const int r1 = inc_ptr[i + 1];
  for (int r = inc_ptr[i]; r < r1; ++r) {
    const int code = inc_code[r];
    const int e = code >> 1, side = code & 1, j = inc_nbr[r];
    const T on = st[e];
    if (mode == BPRIME) {
      const T w = br[e] * on;
      d_re += w;
      if (keep[j] > T(0)) ra[j] += -w;
      continue;
    }
    // Self term: yff at the from end, ytt at the to end; mutual term: yft
    // at the from end (column t), ytf at the to end (column f).
    const int64_t s_row = side ? 6 : 0, m_row = side ? 4 : 2;
    const T s_im = br[(s_row + 1) * m + e] * on;
    const T m_im = br[(m_row + 1) * m + e] * on;
    d_im += s_im;
    if (mode == YBUS) {
      d_re += br[s_row * m + e] * on;
      ra[j] += br[m_row * m + e] * on;
      rb[j] += m_im;
    } else if (keep[j] > T(0)) {
      ra[j] += -m_im;  // -(a + b) == (-a) + (-b) exactly
    }
  }
  if (mode == YBUS) {
    ra[i] = d_re + g_sh[i];
    rb[i] = d_im + b_sh[i];
  } else if (mode == BPRIME) {
    ra[i] = d_re + T(0);
  } else {
    ra[i] = -(d_im + b_sh[i]) + T(0);
  }
}

// ---------------------------------------------------------------------------
// The lane finish shared by F1 (V mode) and I1
// ---------------------------------------------------------------------------

constexpr int kFinishLanes = 4;  // one warp a lane, four lanes a block

template <typename T>
__global__ void __launch_bounds__(32 * kFinishLanes) finish_kernel(
    const T* __restrict__ rowerr, int rows, T* __restrict__ err,
    int* __restrict__ it, unsigned char* __restrict__ active,
    const T* __restrict__ tol, int max_iter, int fixed, int lanes) {
  const int64_t lane = (int64_t)blockIdx.x * kFinishLanes + threadIdx.x / 32;
  const int ln = threadIdx.x & 31;
  if (lane >= lanes) return;  // whole warps
  T worst = T(0);
  bool nan = false;
  const T* r = rowerr + lane * rows;
  for (int k = ln; k < rows; k += 32) {
    const T e = r[k];
    if (e != e) nan = true;
    else if (e > worst) worst = e;
  }
  for (int off = 16; off > 0; off >>= 1)
    worst = fmax(worst, __shfl_xor_sync(0xffffffffu, worst, off));
  nan = __any_sync(0xffffffffu, nan);
  if (ln != 0) return;
  int i = it[lane];
  T e = err[lane];
  if (active[lane]) {
    i += 1;
    e = nan ? nan_<T>() : worst;
  }
  it[lane] = i;
  err[lane] = e;
  if (!fixed) active[lane] = (i < max_iter && e >= tol[0]) ? 1 : 0;
}

// ---------------------------------------------------------------------------
// F1
// ---------------------------------------------------------------------------

constexpr int INIT = 0, THETA = 1, VHALF = 2;

// The update of the half (THETA: theta, V: V) on active lanes, then
// vr/vm = V cos theta, V sin theta.  d[b, j] is d[b * d_bs + j * d_js]:
// the LU solve's answer is read through its own strides.
template <typename T>
__global__ void fdlf_prepass_kernel(int mode, T* __restrict__ x,
                                    const T* __restrict__ d, int64_t d_bs,
                                    int64_t d_js, const T* __restrict__ th_free,
                                    const T* __restrict__ v_free,
                                    const unsigned char* __restrict__ active,
                                    T* __restrict__ vr, T* __restrict__ vm,
                                    int lanes, int n) {
  const int64_t k = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (k >= (int64_t)lanes * n) return;
  const int64_t b = k / n, j = k - b * n;
  T* xr = x + b * 2 * n;
  T th = xr[j], v = xr[n + j];
  if (mode != INIT && active[b]) {
    const T dd = d[b * d_bs + j * d_js];
    if (mode == THETA) {
      th = th + dd * th_free[j];
      xr[j] = th;
    } else {
      v = v + dd * v_free[j];
      xr[n + j] = v;
    }
  }
  T s, c;
  sincos_(th, &s, &c);
  vr[k] = v * c;
  vm[k] = v * s;
}

// The mismatch of row i (k = b n + i) of a lane from its current injection
// I = ire + j iim, at V's parts vri, vmi and magnitude v; in V mode returns
// the row's error max(|dp V|, |dq V|) (NaN kept), else 0.
template <typename T>
__device__ __forceinline__ T fdlf_row(
    int mode, int64_t k, int i, T vri, T vmi, T v, T ire, T iim,
    const T* __restrict__ ps, const T* __restrict__ qs,
    const T* __restrict__ th_free, const T* __restrict__ v_free, bool live,
    T* __restrict__ dp, T* __restrict__ dq) {
  // Read-only inputs (__ldg): a thread's outputs need not wait for each
  // other's stores.
  const T psk = __ldg(ps + k), qsk = __ldg(qs + k);
  const T thf = __ldg(th_free + i), vf = __ldg(v_free + i);
  T P, Q;
  row_product::power(vri, vmi, ire, iim, P, Q);
  const T dpi = (psk - P) / v * thf;
  const T dqi = (qsk - Q) / v * vf;
  if (mode == INIT) {
    dp[k] = dpi;
    dq[k] = dqi;
    return T(0);
  }
  if (mode == THETA) {
    dq[k] = dqi;
    return T(0);
  }
  if (live) dp[k] = dpi;
  const T ep = fabs(dpi * v), eq = fabs(dqi * v);
  return (ep != ep || eq != eq) ? nan_<T>() : (ep > eq ? ep : eq);
}

// fdlf_row on lane b's V parts and state as the pre-pass left them.
template <typename T>
__device__ __forceinline__ T fdlf_epilogue(
    int mode, int64_t b, int i, int n, T ire, T iim, const T* __restrict__ x,
    const T* __restrict__ vr, const T* __restrict__ vm,
    const T* __restrict__ ps, const T* __restrict__ qs,
    const T* __restrict__ th_free, const T* __restrict__ v_free,
    const unsigned char* __restrict__ active, T* __restrict__ dp,
    T* __restrict__ dq) {
  const int64_t k = b * n + i;
  return fdlf_row<T>(mode, k, i, __ldg(vr + k), __ldg(vm + k),
                     __ldg(x + b * 2 * n + n + i), ire, iim, ps, qs, th_free,
                     v_free, __ldg(active + b) != 0, dp, dq);
}

using row_product::kWarpsPerBlock;
static_assert(row_product::kThreads == kThreads, "one block size");

// F1's epilogue, handed each (lane, row)'s I by the tiled product (K2's);
// in V mode a lane's row errors a row tile, reduced to their max, land in
// rowerr [B, row_tiles(n)].
template <typename T>
struct FdlfEpilogue {
  int mode;
  const T *x, *vr, *vm, *ps, *qs, *th_free, *v_free;
  const unsigned char* active;
  T *dp, *dq, *rowerr;
  int n;
  __device__ __forceinline__ T operator()(int64_t b, int i, T ire,
                                          T iim) const {
    return fdlf_epilogue<T>(mode, b, i, n, ire, iim, x, vr, vm, ps, qs,
                            th_free, v_free, active, dp, dq);
  }
  __device__ __forceinline__ void lane_tile(int64_t b, int tile, T worst,
                                            bool nan) const {
    if (mode == VHALF)
      rowerr[b * row_product::row_tiles(n) + tile] = nan ? nan_<T>() : worst;
  }
};

constexpr int kForm = 8;  // F1's warp form: columns a thread forms a pass
// solver_kernels.py reads these two: keep each a `constexpr int name =
// value;`.  A warp-form CTA's rows at most, and its dynamic shared memory
// at most (227 KB less room for the kernel's static shared memory).
constexpr int kF1MaxRows = 256;
constexpr int kF1SmemMax = 228352;

// F1's one-launch warp form: CTA (blockIdx.x, lane blockIdx.y) takes rows
// [blockIdx.x rows, + rows) of that lane (rows <= kF1MaxRows); lane b's y at
// g + b * y_stride (0: one y of every lane).  Dynamic shared memory: V's
// parts [2][n].  `ctaerr` [B, gridDim.x] gets each CTA's row-error max (V
// mode).  `ticket` [B][2], zero between launches: ticket[b][0] counts the
// CTAs that have read x (the last writes the half's update of x, while the
// others may still stream y), ticket[b][1] those that are done (the last
// runs the lane finish).  Each counter is reset by its last taker.
template <typename T>
__global__ void __launch_bounds__(kThreads) fdlf_warp_kernel(
    int mode, T* x, const T* __restrict__ d, int64_t d_bs, int64_t d_js,
    const T* __restrict__ g, const T* __restrict__ bm, int64_t y_stride,
    const T* __restrict__ ps, const T* __restrict__ qs,
    const T* __restrict__ th_free, const T* __restrict__ v_free,
    unsigned char* active, T* __restrict__ dp, T* __restrict__ dq, T* ctaerr,
    int* ticket, T* err, int* it, const T* __restrict__ tol, int max_iter,
    int fixed, int n, int rows) {
  extern __shared__ __align__(16) unsigned char f1_smem[];
  T* svr = reinterpret_cast<T*>(f1_smem);
  T* svm = svr + n;
  __shared__ T vrow[kF1MaxRows];  // the CTA's rows' updated |V|
  __shared__ T red[kWarpsPerBlock];
  __shared__ int is_last;
  const int64_t b = blockIdx.y;
  const int ctas = gridDim.x;
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int r0 = blockIdx.x * rows, r1 = min(n, r0 + rows);
  // Every CTA reads `active` and x before its first ticket; x is written
  // after every CTA has taken that ticket, `active` after the second.
  const bool live = active[b] != 0;
  const bool upd = mode != INIT && live;
  T* xb = x + b * 2 * n;
  const T* db = mode == INIT ? nullptr : d + b * d_bs;
  const T* fr = mode == THETA ? th_free : v_free;
  // kForm columns a thread a pass, every load issued before any is used.
  for (int j0 = threadIdx.x; j0 < n; j0 += kForm * kThreads) {
    T th[kForm], v[kForm], dd[kForm], f[kForm];
#pragma unroll
    for (int u = 0; u < kForm; ++u) {
      const int j = min(j0 + u * kThreads, n - 1);
      th[u] = xb[j];
      v[u] = xb[n + j];
      dd[u] = upd ? db[j * d_js] : T(0);
      f[u] = upd ? fr[j] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kForm; ++u) {
      const int j = j0 + u * kThreads;
      if (j >= n) break;
      if (upd) {
        if (mode == THETA) th[u] = th[u] + dd[u] * f[u];
        else v[u] = v[u] + dd[u] * f[u];
      }
      T s, c;
      sincos_(th[u], &s, &c);
      svr[j] = v[u] * c;
      svm[j] = v[u] * s;
      if (j >= r0 && j < r1) vrow[j - r0] = v[u];
    }
  }
  __syncthreads();
  if (upd && threadIdx.x == 0) {  // this CTA is done with x
    __threadfence();
    is_last = atomicAdd(ticket + 2 * b, 1) == ctas - 1;
  }
  __syncthreads();
  if (upd && is_last) {  // every CTA has read x: the half's update of it
    __threadfence();
    T* xh = mode == THETA ? xb : xb + n;
    for (int j0 = threadIdx.x; j0 < n; j0 += kForm * kThreads) {
      T xv[kForm], dd[kForm], f[kForm];
#pragma unroll
      for (int u = 0; u < kForm; ++u) {
        const int j = min(j0 + u * kThreads, n - 1);
        xv[u] = xh[j];
        dd[u] = db[j * d_js];
        f[u] = fr[j];
      }
#pragma unroll
      for (int u = 0; u < kForm; ++u) {
        const int j = j0 + u * kThreads;
        if (j < n) xh[j] = xv[u] + dd[u] * f[u];
      }
    }
    if (threadIdx.x == 0) ticket[2 * b] = 0;
  }
  T worst = T(0);
  bool nan = false;
  for (int i = r0 + warp; i < r1; i += kWarpsPerBlock) {
    T ire, iim;
    row_product::warp_product<T>(g + b * y_stride + (int64_t)i * n,
                                 bm + b * y_stride + (int64_t)i * n, svr, svm,
                                 n, ln, ire, iim);
    if (ln == 0) {
      const T e = fdlf_row<T>(mode, b * n + i, i, svr[i], svm[i],
                              vrow[i - r0], ire, iim, ps, qs, th_free, v_free,
                              live, dp, dq);
      if (e != e) nan = true;
      else if (e > worst) worst = e;
    }
  }
  if (mode != VHALF) return;  // no lane finish
  if (ln == 0) red[warp] = nan ? nan_<T>() : worst;
  __syncthreads();
  if (threadIdx.x == 0) {
    T w = T(0);
    bool nn = false;
    for (int k = 0; k < kWarpsPerBlock; ++k) {
      const T e = red[k];
      if (e != e) nn = true;
      else if (e > w) w = e;
    }
    ctaerr[b * ctas + blockIdx.x] = nn ? nan_<T>() : w;
    __threadfence();
    is_last = atomicAdd(ticket + 2 * b + 1, 1) == ctas - 1;
  }
  __syncthreads();
  if (!is_last || warp != 0) return;
  __threadfence();
  T w = T(0);  // the lane finish
  bool nn = false;
  for (int k = ln; k < ctas; k += 32) {
    const T e = __ldcg(ctaerr + b * ctas + k);
    if (e != e) nn = true;
    else if (e > w) w = e;
  }
  for (int off = 16; off > 0; off >>= 1)
    w = fmax(w, __shfl_xor_sync(0xffffffffu, w, off));
  nn = __any_sync(0xffffffffu, nn);
  if (ln == 0) {
    int i = it[b];
    T e = err[b];
    if (live) {
      i += 1;
      e = nn ? nan_<T>() : w;
    }
    it[b] = i;
    err[b] = e;
    if (!fixed) active[b] = (i < max_iter && e >= tol[0]) ? 1 : 0;
    ticket[2 * b + 1] = 0;
  }
}

// ---------------------------------------------------------------------------
// J1 and J2: arithmetic shared by both routes
// ---------------------------------------------------------------------------

// Every rounding of J1 and J2 is written out: a product and a sum round
// once each, a b + c d is fma(a, b, c d) and a b - c d is fma(a, b, -(c d)).
// nvcc contracts a b + c d into either of two FMAs, choosing by the code
// around the expression, so one source expression in two kernels can differ
// in its last bit; written out, the staged and the wide route give a lane
// the same bits.
template <typename T> struct Rn;
template <> struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double fma(double a, double b, double c) {
    return __fma_rn(a, b, c);
  }
};
template <> struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float fma(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
  }
};

template <typename T>
__device__ __forceinline__ T mul_(T a, T b) { return Rn<T>::mul(a, b); }
template <typename T>
__device__ __forceinline__ T add_(T a, T b) { return Rn<T>::add(a, b); }
template <typename T>  // a b + c d
__device__ __forceinline__ T dotp(T a, T b, T c, T d) {
  return Rn<T>::fma(a, b, Rn<T>::mul(c, d));
}
template <typename T>  // a b - c d
__device__ __forceinline__ T dotm(T a, T b, T c, T d) {
  return Rn<T>::fma(a, b, -Rn<T>::mul(c, d));
}

// J1's value of a bus: Vc = V e^{j theta} and dVc = (dV cos - V sin
// dtheta, dV sin + V cos dtheta).
template <typename T>
__device__ __forceinline__ void jvp_stage(T th, T v, T dth, T dv, T& vr,
                                          T& vi, T& dr, T& di) {
  T s, c;
  sincos_(th, &s, &c);
  vr = mul_(v, c);
  vi = mul_(v, s);
  dr = dotm(dv, c, vi, dth);
  di = dotp(dv, s, vr, dth);
}

// J1's term of an incidence entry (admittances y_self, y_mut; the bus's
// Vc, dVc; the neighbour's w, dw): dS = dVc conj(I) + Vc conj(dI) with
// I = y_self Vc + y_mut w and dI = y_self dVc + y_mut dw.
template <typename T>
__device__ __forceinline__ void jvp_term(T ysr, T ysi, T ymr, T ymi, T vr,
                                         T vi, T dr, T di, T wr, T wi, T er,
                                         T ei, T& re, T& im) {
  const T ir = add_(dotm(ysr, vr, ysi, vi), dotm(ymr, wr, ymi, wi));
  const T ii = add_(dotp(ysr, vi, ysi, vr), dotp(ymr, wi, ymi, wr));
  const T jr = add_(dotm(ysr, dr, ysi, di), dotm(ymr, er, ymi, ei));
  const T ji = add_(dotp(ysr, di, ysi, dr), dotp(ymr, ei, ymi, er));
  re = add_(dotp(dr, ir, di, ii), dotp(vr, jr, vi, ji));
  im = add_(dotm(di, ir, dr, ii), dotm(vi, jr, vr, ji));
}

// J1's output of a bus from its branch sums p, q (each its from-end sum
// plus its to-end sum): the shunt adds 2 g V dV to dP and -2 b V dV to dQ;
// pinned rows pass u.
template <typename T>
__device__ __forceinline__ void jvp_finish(T p, T q, T v, T dth, T dv,
                                           T gsh, T bsh, bool tf, bool vf,
                                           T* o_th, T* o_v) {
  const T vdv = mul_(mul_(T(2), v), dv);
  *o_th = tf ? Rn<T>::fma(gsh, vdv, p) : dth;
  *o_v = vf ? Rn<T>::fma(-bsh, vdv, q) : dv;
}

// J2's term of an incidence entry (y_self, y_mut, the other end's mutual
// y_mut'; the bus's Vc = k and masked omega_k; the neighbour's Vc = j and
// omega_j), added to the gradient g in Vc_k:
//   conj(omega_k y_self) k + omega_k I + conj(omega_j y_mut') j,
// I = y_self k + y_mut j.
template <typename T>
__device__ __forceinline__ void vjp_term(T ysr, T ysi, T ymr, T ymi, T ytr,
                                         T yti, T kr, T ki, T okr, T oki,
                                         T jr, T ji, T ojr, T oji, T& gr,
                                         T& gi) {
  const T ir = add_(dotm(ysr, kr, ysi, ki), dotm(ymr, jr, ymi, ji));
  const T ii = add_(dotp(ysr, ki, ysi, kr), dotp(ymr, ji, ymi, jr));
  const T ar = dotm(okr, ysr, oki, ysi), ai = dotp(okr, ysi, oki, ysr);
  const T br = dotm(ojr, ytr, oji, yti), bi = dotp(ojr, yti, oji, ytr);
  gr = add_(gr, add_(add_(dotp(ar, kr, ai, ki), dotm(okr, ir, oki, ii)),
                     dotp(br, jr, bi, ji)));
  gi = add_(gi, add_(add_(dotm(ar, ki, ai, kr), dotp(okr, ii, oki, ir)),
                     dotm(br, ji, bi, jr)));
}

// J2's output of a bus from its gradient g in Vc: theta_bar = V (g_im cos -
// g_re sin), V_bar = g_re cos + g_im sin + 2 V (omega_P g_sh - omega_Q
// b_sh); pinned rows of MASKED mode add w (theta_ref and V - V_set).
template <typename T>
__device__ __forceinline__ void vjp_finish(T gr, T gi, T th, T v, T okr,
                                           T oki, T gsh, T bsh, bool pass_th,
                                           bool pass_v, T wp, T wq, T* o_th,
                                           T* o_v) {
  T s, c;
  sincos_(th, &s, &c);
  T dth = mul_(v, dotm(gi, c, gr, s));
  T dv = Rn<T>::fma(mul_(T(2), v), dotm(okr, gsh, oki, bsh),
                    dotp(gr, c, gi, s));
  *o_th = pass_th ? add_(dth, wp) : dth;
  *o_v = pass_v ? add_(dv, wq) : dv;
}

// ---------------------------------------------------------------------------
// J1, wide route
// ---------------------------------------------------------------------------

// A thread a (lane, bus) walks the bus's incidence list in CSR order,
// forming each neighbour's Vc and dVc from x and u.
template <typename T>
__global__ void __launch_bounds__(kThreads) jvp_kernel(
    const T* __restrict__ x, const T* __restrict__ u,
    const int* __restrict__ inc_ptr, const int* __restrict__ inc_code,
    const int* __restrict__ inc_nbr, const T* __restrict__ inc_g,
    const T* __restrict__ inc_b, const T* __restrict__ inc_gs,
    const T* __restrict__ inc_bs, const T* __restrict__ g_sh,
    const T* __restrict__ b_sh, const T* __restrict__ th_free,
    const T* __restrict__ v_free, const T* __restrict__ status,
    T* __restrict__ out, int lanes, int n, int m) {
  const int64_t k = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (k >= (int64_t)lanes * n) return;
  const int64_t b = k / n;
  const int i = (int)(k - b * n);
  const T* xb = x + b * 2 * n;
  const T* ub = u + b * 2 * n;
  const T* st = status != nullptr ? status + b * m : nullptr;
  const T v = xb[n + i], dth = ub[i], dv = ub[n + i];
  T vr, vi, dr, di;
  jvp_stage(xb[i], v, dth, dv, vr, vi, dr, di);
  T acc[4] = {T(0), T(0), T(0), T(0)};  // dP from, to; dQ from, to
  const int r1 = inc_ptr[i + 1];
  for (int r = inc_ptr[i]; r < r1; ++r) {
    const int code = inc_code[r], j = inc_nbr[r];
    T ysr = inc_gs[r], ysi = inc_bs[r], ymr = inc_g[r], ymi = inc_b[r];
    if (st != nullptr) {
      const T on = st[code >> 1];
      ysr = mul_(ysr, on), ysi = mul_(ysi, on);
      ymr = mul_(ymr, on), ymi = mul_(ymi, on);
    }
    T wr, wi, er, ei, re, im;
    jvp_stage(xb[j], xb[n + j], ub[j], ub[n + j], wr, wi, er, ei);
    jvp_term(ysr, ysi, ymr, ymi, vr, vi, dr, di, wr, wi, er, ei, re, im);
    const int side = code & 1;
    acc[side] = add_(acc[side], re);
    acc[2 + side] = add_(acc[2 + side], im);
  }
  T* ob = out + b * 2 * n;
  jvp_finish(add_(acc[0], acc[1]), add_(acc[2], acc[3]), v, dth, dv, g_sh[i],
             b_sh[i], th_free[i] > T(0), v_free[i] > T(0), ob + i,
             ob + n + i);
}

// ---------------------------------------------------------------------------
// I1
// ---------------------------------------------------------------------------

// I1's pre-pass: lane b's injection conj(S / V) at node-phase j, zero
// where V is 0 (a dead phase).
template <typename T>
__global__ void cim_inject_kernel(const T* __restrict__ v_re,
                                  const T* __restrict__ v_im,
                                  const T* __restrict__ s_re,
                                  const T* __restrict__ s_im,
                                  T* __restrict__ j_re, T* __restrict__ j_im,
                                  int64_t total) {
  const int64_t q = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (q >= total) return;
  const T vr = v_re[q], vi = v_im[q];
  T jr = T(0), ji = T(0);
  if (vr * vr + vi * vi > T(0)) {
    const T sr = s_re[q], si = s_im[q];
    const T d = vr * vr + vi * vi;
    jr = (sr * vr + si * vi) / d;
    ji = -((si * vr - sr * vi) / d);
  }
  j_re[q] = jr;
  j_im[q] = ji;
}

// I1's epilogue, handed each (lane, row)'s A-product dv by the tiled
// product: v_base + dv under the phase mask, |dv| a row (0 on inactive
// lanes, which copy v), reduced to a max a row tile into rowerr [B,
// row_tiles(N)].
template <typename T>
struct CimEpilogue {
  const T *v_re, *v_im, *vb_re, *vb_im, *mask;
  const unsigned char* active;
  T *o_re, *o_im, *rowerr;
  int N;
  __device__ __forceinline__ T operator()(int64_t b, int i, T dre,
                                          T dim) const {
    // Read-only inputs (__ldg): a thread's outputs need not wait for each
    // other's stores.
    const int64_t k = b * N + i;
    const T vr = __ldg(v_re + k), vi = __ldg(v_im + k);
    if (!__ldg(active + b)) {
      o_re[k] = vr;
      o_im[k] = vi;
      return T(0);
    }
    const T mk = __ldg(mask + i);
    const T nr = (__ldg(vb_re + k) + dre) * mk;
    const T ni = (__ldg(vb_im + k) + dim) * mk;
    o_re[k] = nr;
    o_im[k] = ni;
    const T er = nr - vr, ei = ni - vi;
    return sqrt(er * er + ei * ei);
  }
  __device__ __forceinline__ void lane_tile(int64_t b, int tile, T worst,
                                            bool nan) const {
    rowerr[b * row_product::row_tiles(N) + tile] = nan ? nan_<T>() : worst;
  }
};

// ---------------------------------------------------------------------------
// J2
// ---------------------------------------------------------------------------

constexpr int MASKED = 0, FULL = 1;

template <typename T>
__global__ void __launch_bounds__(kThreads) vjp_kernel(
    int mode, const T* __restrict__ x, const T* __restrict__ w,
    const int* __restrict__ inc_ptr, const int* __restrict__ inc_code,
    const int* __restrict__ inc_nbr, const T* __restrict__ inc_g,
    const T* __restrict__ inc_b, const T* __restrict__ inc_gs,
    const T* __restrict__ inc_bs, const T* __restrict__ inc_gt,
    const T* __restrict__ inc_bt, const T* __restrict__ g_sh,
    const T* __restrict__ b_sh, const T* __restrict__ th_free,
    const T* __restrict__ v_free, const T* __restrict__ status,
    T* __restrict__ out, int lanes, int n, int m) {
  const int64_t k = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (k >= (int64_t)lanes * n) return;
  const int64_t b = k / n;
  const int i = (int)(k - b * n);
  const T* xb = x + b * 2 * n;
  const T* wb = w + b * 2 * n;
  const T* st = status != nullptr ? status + b * m : nullptr;
  const bool full = mode == FULL;
  const T th = xb[i], v = xb[n + i], wp = wb[i], wq = wb[n + i];
  const bool tf = th_free[i] > T(0), vf = v_free[i] > T(0);
  const T okr = (full || tf) ? wp : T(0), oki = (full || vf) ? wq : T(0);
  T s, c;
  sincos_(th, &s, &c);
  const T kr = mul_(v, c), ki = mul_(v, s);
  T gr = T(0), gi = T(0);
  const int r1 = inc_ptr[i + 1];
  for (int r = inc_ptr[i]; r < r1; ++r) {
    const int code = inc_code[r], j = inc_nbr[r];
    T ysr = inc_gs[r], ysi = inc_bs[r], ymr = inc_g[r], ymi = inc_b[r];
    T ytr = inc_gt[r], yti = inc_bt[r];
    if (st != nullptr) {
      const T on = st[code >> 1];
      ysr = mul_(ysr, on), ysi = mul_(ysi, on);
      ymr = mul_(ymr, on), ymi = mul_(ymi, on);
      ytr = mul_(ytr, on), yti = mul_(yti, on);
    }
    const T ojr = (full || th_free[j] > T(0)) ? wb[j] : T(0);
    const T oji = (full || v_free[j] > T(0)) ? wb[n + j] : T(0);
    T sj, cj;
    sincos_(xb[j], &sj, &cj);
    const T vj = xb[n + j];
    vjp_term(ysr, ysi, ymr, ymi, ytr, yti, kr, ki, okr, oki, mul_(vj, cj),
             mul_(vj, sj), ojr, oji, gr, gi);
  }
  T* ob = out + b * 2 * n;
  vjp_finish(gr, gi, th, v, okr, oki, g_sh[i], b_sh[i], !full && !tf,
             !full && !vf, wp, wq, ob + i, ob + n + i);
}

// ---------------------------------------------------------------------------
// J1 and J2, staged route
// ---------------------------------------------------------------------------

// A CTA's threads; solver_kernels.py reads the next three (keep each a
// `constexpr int name = value;`): the most lanes a CTA takes, the slots of
// a slice of the layout (a warp's), and the dynamic shared memory it may
// use.
constexpr int kResThreads = 512;
constexpr int kResMaxLanes = 4;
constexpr int kResSlice = 32;
constexpr int kResSmemMax = 232448;
constexpr int kResStageDepth = 4;  // buses a thread loads before it forms
constexpr int kResUnroll = 2;      // entries a walk step loads at once
constexpr int kJvp = 0, kVjp = 1;

template <typename T> struct Pair;
template <> struct Pair<double> { using type = double2; };
template <> struct Pair<float> { using type = float2; };

// What both kernels read.  The layout (solver_kernels.residual_layout): the
// buses sorted by degree (largest first, stable) fill slots of 32; slot k
// holds `slot[k]` = (bus, degree), (-1, 0) past the last bus, and bus i
// sits in slot `where[i]`; entry t of
// slot k (the bus's t-th CSR entry) sits at base[k / 32] + 32 t + k % 32:
// `idx` (code, neighbour) int32 pairs and `val` [E, K] (g, b, gs, bs; J2
// also gt, bt).  A slot walks its own degree, never the slice's padding.
template <typename T>
struct ResArgs {
  const T *x, *u;  // u: J1's tangent, J2's cotangent w
  const int2 *slot, *idx;
  const int *base, *where;
  const T* val;
  const T *g_sh, *b_sh, *th_free, *v_free, *status;
  T* out;
  int lanes, n, m, ctas_per_lane, full;
};

// CTA (group g, part p), g = blockIdx.x / ctas_per_lane, takes lanes
// [g L, g L + L) and the slices p, p + c, p + 2c, ... of the S = ceil(n /
// 32) slices, in three phases between two barriers.
//   stage   each of its lanes in shared memory, a bus a thread at a time
//           (coalesced): `sa` [L][n] and `sb` [L][n] pairs — J1: Vc and
//           dVc; J2: Vc and the masked omega — and with STATUS the lanes'
//           [L][m] status rows;
//   walk    a warp a slice: each thread owns a slot's bus for all L lanes
//           and walks its entries in CSR order, each entry's operands read
//           once (a warp's step reads consecutive entries) and applied to
//           every lane from registers, each neighbour read from shared
//           memory; the bus's sums go to `sr` [L][n] (a slot's bus is
//           anywhere in the lane: written from here, x, u and the output
//           would be read and written a sector a thread);
//   finish  consecutive threads take consecutive buses again: the sums
//           from `sr`, x, u and the output coalesced.
// The arithmetic is jvp_kernel's and vjp_kernel's (jvp_stage, jvp_term,
// ...), in the same order: a lane gets the wide route's bits.
template <typename T, int KIND, int L, bool STATUS>
__global__ void __launch_bounds__(kResThreads, 1)
    residual_staged_kernel(const ResArgs<T> a) {
  using T2 = typename Pair<T>::type;
  constexpr int kPairs = KIND == kJvp ? 2 : 3;  // value pairs an entry
  constexpr int kAcc = KIND == kJvp ? 4 : 2;
  extern __shared__ __align__(16) unsigned char res_smem[];
  const int n = a.n, m = a.m;
  T2* sa = reinterpret_cast<T2*>(res_smem);
  T2* sb = sa + L * n;
  T2* sr = sb + L * n;
  T* sst = reinterpret_cast<T*>(sr + L * n);
  const int group = blockIdx.x / a.ctas_per_lane;
  const int part = blockIdx.x - group * a.ctas_per_lane;
  const int64_t lane0 = (int64_t)group * L;
  const int nl = a.lanes - lane0 < L ? (int)(a.lanes - lane0) : L;
  const bool full = a.full != 0;

  // Stage: consecutive threads take consecutive buses of a lane, each
  // thread kResStageDepth buses' loads in flight before it forms them.
  const int items = nl * n;
  for (int q0 = threadIdx.x; q0 < items;
       q0 += kResThreads * kResStageDepth) {
    T th[kResStageDepth], v[kResStageDepth], p[kResStageDepth],
        q[kResStageDepth];
#pragma unroll
    for (int k = 0; k < kResStageDepth; ++k) {
      const int it = q0 + k * kResThreads;
      if (it < items) {
        const int l = it / n, i = it - l * n;
        const T* xb = a.x + (lane0 + l) * 2 * n;
        const T* ub = a.u + (lane0 + l) * 2 * n;
        th[k] = xb[i], v[k] = xb[n + i], p[k] = ub[i], q[k] = ub[n + i];
      }
    }
#pragma unroll
    for (int k = 0; k < kResStageDepth; ++k) {
      const int it = q0 + k * kResThreads;
      if (it < items) {
        if constexpr (KIND == kJvp) {
          T vr, vi, dr, di;
          jvp_stage(th[k], v[k], p[k], q[k], vr, vi, dr, di);
          sa[it] = T2{vr, vi};
          sb[it] = T2{dr, di};
        } else {
          const int i = it % n;
          T s, c;
          sincos_(th[k], &s, &c);
          sa[it] = T2{mul_(v[k], c), mul_(v[k], s)};
          sb[it] = T2{(full || a.th_free[i] > T(0)) ? p[k] : T(0),
                      (full || a.v_free[i] > T(0)) ? q[k] : T(0)};
        }
      }
    }
  }
  if constexpr (STATUS) {
    for (int it = threadIdx.x; it < nl * m; it += kResThreads)
      sst[it] = a.status[lane0 * m + it];
  }
  __syncthreads();

  // Walk: a warp a slice, a thread a slot.
  const int slices = (n + kResSlice - 1) / kResSlice;
  const int warp = threadIdx.x / 32, ln = threadIdx.x % 32;
  const int step = a.ctas_per_lane * (kResThreads / 32);
  const T2* val = reinterpret_cast<const T2*>(a.val);
  // Each slice's slot and base are loaded while the warp walks the slice
  // before it.
  int sl = part + a.ctas_per_lane * warp;
  int2 slot = int2{-1, 0};
  int base = 0;
  if (sl < slices) slot = a.slot[sl * kResSlice + ln], base = a.base[sl];
  for (; sl < slices; sl += step) {
    const int i = slot.x, deg = slot.y;
    int64_t e = base + ln;
    if (sl + step < slices)
      slot = a.slot[(sl + step) * kResSlice + ln], base = a.base[sl + step];
    if (i < 0) continue;
    T own[L][4], acc[L][kAcc];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const T2 x0 = sa[l * n + i], x1 = sb[l * n + i];
      own[l][0] = x0.x, own[l][1] = x0.y, own[l][2] = x1.x, own[l][3] = x1.y;
#pragma unroll
      for (int k = 0; k < kAcc; ++k) acc[l][k] = T(0);
    }
    // kResUnroll entries' loads in flight a step, their terms formed side
    // by side and added to each lane's sums in CSR order.
    for (int t = 0; t < deg; t += kResUnroll, e += kResUnroll * kResSlice) {
      int2 cn[kResUnroll];
      T2 mut[kResUnroll], self[kResUnroll], oth[kResUnroll];
#pragma unroll
      for (int k = 0; k < kResUnroll; ++k) {
        if (t + k < deg) {
          const int64_t ek = e + k * kResSlice;
          cn[k] = a.idx[ek];
          mut[k] = val[ek * kPairs];
          self[k] = val[ek * kPairs + 1];
          if constexpr (KIND == kVjp) oth[k] = val[ek * kPairs + 2];
        }
      }
#pragma unroll
      for (int k = 0; k < kResUnroll; ++k) {
        if (t + k >= deg) break;
#pragma unroll
        for (int l = 0; l < L; ++l) {
          if (l >= nl) break;
          T ymr = mut[k].x, ymi = mut[k].y, ysr = self[k].x, ysi = self[k].y;
          T ytr = T(0), yti = T(0);
          if constexpr (KIND == kVjp) ytr = oth[k].x, yti = oth[k].y;
          if constexpr (STATUS) {
            const T on = sst[l * m + (cn[k].x >> 1)];
            ysr = mul_(ysr, on), ysi = mul_(ysi, on);
            ymr = mul_(ymr, on), ymi = mul_(ymi, on);
            if constexpr (KIND == kVjp)
              ytr = mul_(ytr, on), yti = mul_(yti, on);
          }
          const T2 nj = sa[l * n + cn[k].y], dj = sb[l * n + cn[k].y];
          if constexpr (KIND == kJvp) {
            T re, im;
            jvp_term(ysr, ysi, ymr, ymi, own[l][0], own[l][1], own[l][2],
                     own[l][3], nj.x, nj.y, dj.x, dj.y, re, im);
            if (cn[k].x & 1) {
              acc[l][1] = add_(acc[l][1], re);
              acc[l][3] = add_(acc[l][3], im);
            } else {
              acc[l][0] = add_(acc[l][0], re);
              acc[l][2] = add_(acc[l][2], im);
            }
          } else {
            vjp_term(ysr, ysi, ymr, ymi, ytr, yti, own[l][0], own[l][1],
                     own[l][2], own[l][3], nj.x, nj.y, dj.x, dj.y,
                     acc[l][0], acc[l][1]);
          }
        }
      }
    }
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (l >= nl) break;
      if constexpr (KIND == kJvp)
        sr[l * n + i] = T2{add_(acc[l][0], acc[l][1]),
                           add_(acc[l][2], acc[l][3])};
      else
        sr[l * n + i] = T2{acc[l][0], acc[l][1]};
    }
  }
  __syncthreads();

  // Finish: consecutive threads take consecutive buses of a lane (those of
  // this CTA's slices), the sums from shared memory.
  for (int it = threadIdx.x; it < items; it += kResThreads) {
    const int l = it / n, i = it - l * n;
    if (a.ctas_per_lane > 1 &&
        a.where[i] / kResSlice % a.ctas_per_lane != part)
      continue;
    const T* xb = a.x + (lane0 + l) * 2 * n;
    const T* ub = a.u + (lane0 + l) * 2 * n;
    T* ob = a.out + (lane0 + l) * 2 * n;
    const T2 r = sr[it];
    const bool tf = a.th_free[i] > T(0), vf = a.v_free[i] > T(0);
    if constexpr (KIND == kJvp) {
      jvp_finish(r.x, r.y, xb[n + i], ub[i], ub[n + i], a.g_sh[i], a.b_sh[i],
                 tf, vf, ob + i, ob + n + i);
    } else {
      const T2 w = sb[it];
      vjp_finish(r.x, r.y, xb[i], xb[n + i], w.x, w.y, a.g_sh[i], a.b_sh[i],
                 !full && !tf, !full && !vf, ub[i], ub[n + i], ob + i,
                 ob + n + i);
    }
  }
}

// ---------------------------------------------------------------------------
// I2
// ---------------------------------------------------------------------------

// I2's epilogue, handed each (lane, row)'s p = (A^H g) by the walk's
// reduce phase: the load cotangent sbar += conj(1/v) conj(p), and v's
// masked cotangent mask conj(-s/v^2) conj(p) into o (and onto vbbar); dead
// node-phases (v = 0) get 0.
template <typename T>
struct CimVjpEpilogue {
  const T *v_re, *v_im, *s_re, *s_im, *mask;
  T *sbar_re, *sbar_im, *vbbar_re, *vbbar_im, *o_re, *o_im;
  int N;
  __device__ __forceinline__ void operator()(int64_t b, int i, T pre,
                                             T pim) const {
    const int64_t k = b * N + i;
    const T vr = __ldg(v_re + k), vi = __ldg(v_im + k);
    const T d = vr * vr + vi * vi;
    if (!(d > T(0))) {  // a dead node-phase: no load current, no term
      __stcg(o_re + k, T(0));
      __stcg(o_im + k, T(0));
      return;
    }
    const T qr = pre, qi = -pim;
    const T dsr = (vr * qr - vi * qi) / d, dsi = (vr * qi + vi * qr) / d;
    const T sr = __ldg(s_re + k), si = __ldg(s_im + k);
    const T ur = (sr * vr + si * vi) / d, ui = (si * vr - sr * vi) / d;
    const T cr = -(ur * vr + ui * vi) / d, ci = -(ur * vi - ui * vr) / d;
    const T mk = __ldg(mask + i);
    const T gr = (cr * qr - ci * qi) * mk, gi = (cr * qi + ci * qr) * mk;
    // sbar and vbbar are one thread's alone in every step of a walk; they,
    // and the cotangent other CTAs read next, go through L2.
    __stcg(sbar_re + k, __ldcg(sbar_re + k) + dsr);
    __stcg(sbar_im + k, __ldcg(sbar_im + k) + dsi);
    __stcg(vbbar_re + k, __ldcg(vbbar_re + k) + gr);
    __stcg(vbbar_im + k, __ldcg(vbbar_im + k) + gi);
    __stcg(o_re + k, gr);
    __stcg(o_im + k, gi);
  }
};

// ---------------------------------------------------------------------------
// I2's walk: every step of a backward in one persistent launch
// ---------------------------------------------------------------------------

// solver_kernels.py reads kWalkItems for cim_walk_plan: keep it a
// `constexpr int name = value;`.  The product phase's work items, one
// resident CTA on each of an H100's 132 SMs; the item plan is a function
// of this constant and the shape alone (never of the launch width), so
// is every sum's order.
constexpr int kWalkItems = 132;
// A CTA's threads (16 warps; the staging copies are issued by the first
// 256, row_product.cuh's block), the staging ring's depth in stages of 16
// columns, and the stages a wait and a barrier take.
constexpr int kWalkThreads = 512;
constexpr int kWalkStages = 6;
constexpr int kWalkGroup = 2;
static_assert(kWalkStages % kWalkGroup == 0, "whole groups in the ring");
static_assert(kWalkThreads % kThreads == 0, "whole copy blocks");

// The product's (tile, K stage) units cut into `items` even runs: item w
// takes units [units w / items, units (w + 1) / items), tile t = row tile
// x lane_tiles + lane tile, its stages consecutive.
struct WalkShape {
  int n, lanes, row_tiles, lane_tiles, stages, items;
  long long units;
};

__host__ __device__ inline WalkShape walk_shape(int n, int lanes) {
  WalkShape s;
  s.n = n;
  s.lanes = lanes;
  s.row_tiles = (n + row_product::kTileRows - 1) / row_product::kTileRows;
  s.lane_tiles = (lanes + row_product::kTileLanes - 1) / row_product::kTileLanes;
  s.stages = (n + row_product::kTileK - 1) / row_product::kTileK;
  s.units = (long long)s.row_tiles * s.lane_tiles * s.stages;
  s.items = (int)(s.units < kWalkItems ? s.units : kWalkItems);
  return s;
}

__host__ __device__ inline long long walk_unit_start(const WalkShape& s, int w) {
  return s.units * w / s.items;
}

// The item whose run holds unit u.
__host__ __device__ inline int walk_item_of(const WalkShape& s, long long u) {
  return (int)(((u + 1) * s.items - 1) / s.units);
}

// Partial-sum slots: item w's sums over tile t go to slot w + t (one
// slot a (item, tile) pair that overlaps: w + t is distinct for each),
// [2 (re, im)][64 lanes][64 rows].
__host__ __device__ inline int walk_slots(const WalkShape& s) {
  return s.items + s.row_tiles * s.lane_tiles - 1;
}
constexpr int kSlotElems = 2 * row_product::kTileLanes * row_product::kTileRows;

template <typename T>
struct WalkArgs {
  const T *h_re, *h_im;  // A^H [N, N]
  const T *g_re, *g_im;  // the first step's masked cotangent [B, N]
  const T *v_re, *v_im;  // the iterate of step k at v + k * v_step
  long long v_step;
  const T *s_re, *s_im, *mask;
  T *sbar_re, *sbar_im, *vbbar_re, *vbbar_im;  // added to in place
  T *o_re, *o_im;   // each step's cotangent of its v, [B, N]
  T* part;          // walk_slots(shape) slots
  unsigned* bar;    // the grid barrier's [arrivals, generation]
  int steps;
  WalkShape sh;
};

// Stage the columns [k0, k0 + kTileK) of the lanes b0.. of the running
// cotangent: through L2 only (cp.async.cg; the scalar form by ld.cg), as
// other CTAs wrote it in the step before and an SM's L1 may hold the
// step before's lines.  By the CTA's first kThreads threads.
template <typename T, int VEC>
__device__ __forceinline__ void load_lanes(T* t_re, T* t_im,
                                           const T* __restrict__ g_re,
                                           const T* __restrict__ g_im,
                                           int lanes, int n, int b0, int k0,
                                           int kend) {
  using namespace row_product;
  if constexpr (VEC > 1) {
    load_pair<T, VEC>(t_re, t_im, g_re, g_im, lanes, n, b0, k0, kend);
  } else {
    constexpr int kRounds = kTileLanes * kTileK / kThreads;
#pragma unroll
    for (int it = 0; it < 2 * kRounds; ++it) {
      const int mat = it / kRounds;
      const int e = (it % kRounds) * kThreads + threadIdx.x;
      const int r = e / kTileK, c = e % kTileK;
      const int gr = b0 + r, k = k0 + c;
      const T* base = mat ? g_im : g_re;
      const T v = (gr < lanes && k < kend) ? __ldcg(base + (int64_t)gr * n + k)
                                           : T(0);
      (mat ? t_im : t_re)[swz(r, c)] = v;
    }
  }
}

// A warp's share of the 64 x 64 tile, by dtype.  float64 by Gauss's
// three real products a complex one on the FP64 tensor cores
// (row_product.cuh's m16n8k4 fragments): t1 = sum Yr Vr, t2 = sum Yi Vi,
// t3 = sum (Yr + Yi)(Vr + Vi), then re = t1 - t2, im = t3 - t1 - t2;
// each of the 16 warps 16 rows x 16 lanes (two 16 x 8 tiles, 48
// accumulator registers).  float32 keeps the tiled product's FFMA
// micro-tiles, on the first 256 threads.
template <typename T>
struct WalkMac;

template <>
struct WalkMac<double> {
  double t1[2][4], t2[2][4], t3[2][4];
  bool on;
  int g, t, rb, lb;

  __device__ __forceinline__ void init(int n, int lanes, int i0, int b0) {
    const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
    g = ln >> 2;
    t = ln & 3;
    rb = (warp & 3) * 16;
    lb = (warp >> 2) * 16;
    on = i0 + rb < n && b0 + lb < lanes;
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) t1[b][c] = t2[b][c] = t3[b][c] = 0.0;
  }

  __device__ __forceinline__ void step(const row_product::Stage<double>& st) {
    using namespace row_product;
    if (!on) return;
#pragma unroll
    for (int ks = 0; ks < kTileK / 4; ++ks) {
      // Column 4 ks + t of a row r = g (mod 4), swizzled (swz).
      const int kk = ((ks ^ (g & 3)) << 2) + t;
      const int r = rb + g;
      const double ar0 = st.y_re[r * kTileK + kk];
      const double ar1 = st.y_re[(r + 8) * kTileK + kk];
      const double ai0 = st.y_im[r * kTileK + kk];
      const double ai1 = st.y_im[(r + 8) * kTileK + kk];
      const double as0 = ar0 + ai0, as1 = ar1 + ai1;
      double br[2], bi[2], bs[2];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int l = lb + 8 * b + g;
        br[b] = st.v_re[l * kTileK + kk];
        bi[b] = st.v_im[l * kTileK + kk];
        bs[b] = br[b] + bi[b];
      }
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        row_product::mma_f64(t1[b], ar0, ar1, br[b]);
        row_product::mma_f64(t2[b], ai0, ai1, bi[b]);
        row_product::mma_f64(t3[b], as0, as1, bs[b]);
      }
    }
  }

  template <typename F>
  __device__ __forceinline__ void each(int n, int lanes, int i0, int b0,
                                       F f) const {
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = i0 + rb + g + 8 * (c >> 1);
        const int lane = b0 + lb + 8 * b + 2 * t + (c & 1);
        if (on && row < n && lane < lanes)
          f(row, lane, t1[b][c] - t2[b][c], t3[b][c] - t1[b][c] - t2[b][c]);
      }
  }
};

template <>
struct WalkMac<float> {
  row_product::Mac<float> mac;
  bool on;
  __device__ __forceinline__ void init(int n, int lanes, int i0, int b0) {
    on = threadIdx.x < kThreads;
    mac.init(n, lanes, i0, b0);
  }
  __device__ __forceinline__ void step(const row_product::Stage<float>& st) {
    if (on) mac.step(st);
  }
  template <typename F>
  __device__ __forceinline__ void each(int n, int lanes, int i0, int b0,
                                       F f) const {
    if (on) mac.each(n, lanes, i0, b0, f);
  }
};

// Stages [s0, s1) of tile (i0, b0) of p = A^H g, kWalkGroup stages a
// wait and a barrier in a ring of kWalkStages, then the sums through
// shared memory (the ring's space, a row stride of 64 + 16 bytes) into
// `slot` with 16-byte stores.
template <typename T, int VEC>
__device__ __forceinline__ void walk_segment(row_product::Stage<T>* st,
                                             const T* __restrict__ h_re,
                                             const T* __restrict__ h_im,
                                             int n, int lanes, const T* gr,
                                             const T* gi, int i0, int b0,
                                             int s0, int s1, T* slot,
                                             uint64_t y_pol) {
  using namespace row_product;
  constexpr int kSlotsOf = kWalkStages / kWalkGroup;  // groups in the ring
  const int kb = s0 * kTileK, ke = min(n, s1 * kTileK);
  const int tiles = s1 - s0, groups = (tiles + kWalkGroup - 1) / kWalkGroup;
  const bool copies = threadIdx.x < kThreads;
  WalkMac<T> mac;
  mac.init(n, lanes, i0, b0);
  auto load_group = [&](int q) {
    if (!copies) return;
#pragma unroll
    for (int h = 0; h < kWalkGroup; ++h) {
      const int si = q * kWalkGroup + h;
      if (si < tiles) {
        Stage<T>& d = st[si % kWalkStages];
        load_pair<T, VEC>(d.y_re, d.y_im, h_re, h_im, n, n, i0,
                          kb + si * kTileK, ke, true, y_pol);
        load_lanes<T, VEC>(d.v_re, d.v_im, gr, gi, lanes, n, b0,
                           kb + si * kTileK, ke);
      }
    }
  };
#pragma unroll
  for (int q = 0; q < kSlotsOf - 1; ++q) {
    if (q < groups) load_group(q);
    cp_async_commit();
  }
  for (int q = 0; q < groups; ++q) {
    cp_async_wait<kSlotsOf - 2>();  // group q has landed (this thread's)
    __syncthreads();                // ... every thread's; q - 1 is consumed
    if (q + kSlotsOf - 1 < groups) load_group(q + kSlotsOf - 1);
    cp_async_commit();
#pragma unroll
    for (int h = 0; h < kWalkGroup; ++h) {
      const int si = q * kWalkGroup + h;
      if (si < tiles) mac.step(st[si % kWalkStages]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the flush buffer
  constexpr int ld = kTileRows + 16 / (int)sizeof(T);
  T* buf = reinterpret_cast<T*>(st);
  mac.each(n, lanes, i0, b0, [&](int row, int lane, T re, T im) {
    buf[(lane - b0) * ld + row - i0] = re;
    buf[(kTileLanes + lane - b0) * ld + row - i0] = im;
  });
  __syncthreads();
  constexpr int kV = 16 / (int)sizeof(T), kRowV = kTileRows / kV;
  for (int q = threadIdx.x; q < 2 * kTileLanes * kRowV; q += kWalkThreads) {
    const int lr = q / kRowV, c = (q - lr * kRowV) * kV;
    __stcg(reinterpret_cast<int4*>(slot + lr * kTileRows + c),
           *reinterpret_cast<const int4*>(buf + lr * ld + c));
  }
  __syncthreads();  // the buffer is the next segment's ring
}

// The reduce phase's sum of entry e = (lane b, row i): its tile's slots
// added in item order, their loads issued four at a time.
template <typename T>
__device__ __forceinline__ void walk_sum(const WalkArgs<T>& a, int64_t b,
                                         int i, T& sr, T& si) {
  using namespace row_product;
  const WalkShape& s = a.sh;
  const int t = (i / kTileRows) * s.lane_tiles + (int)(b / kTileLanes);
  const long long ut = (long long)t * s.stages;
  const int wl = walk_item_of(s, ut + s.stages - 1);
  int w = walk_item_of(s, ut);
  constexpr int kIm = kTileLanes * kTileRows;
  const T* p = a.part + (int64_t)(w + t) * kSlotElems +
               (b % kTileLanes) * kTileRows + i % kTileRows;
  sr = __ldcg(p);
  si = __ldcg(p + kIm);
  for (++w; w <= wl; w += 4) {
    T xr[4], xi[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (w + u <= wl) {
        xr[u] = __ldcg(p + (u + 1) * kSlotElems);
        xi[u] = __ldcg(p + (u + 1) * kSlotElems + kIm);
      }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (w + u <= wl) {
        sr += xr[u];
        si += xi[u];
      }
    p += 4 * kSlotElems;
  }
}

// A whole backward: for step j = 0 .. steps - 1 (the iterate k = steps -
// 1 - j), the product phase (every item's stages into its slots), a grid
// barrier, the reduce phase (each CTA an even share of the (lane, row)
// entries, a thread an entry at a time adding its tile's slots in item
// order and applying CimVjpEpilogue), and a grid barrier
// before the next step's product reads the cotangent the reduce wrote.
template <typename T, int VEC>
__global__ void __launch_bounds__(kWalkThreads, 1) cim_walk_kernel(const WalkArgs<T> a) {
  using namespace row_product;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage<T>* st = reinterpret_cast<Stage<T>*>(smem_raw);
  const WalkShape& s = a.sh;
  const int n = s.n, blocks = gridDim.x;
  const int64_t entries = (int64_t)s.lanes * n;
  const uint64_t y_pol = evict_first_policy();
  for (int step = 0; step < a.steps; ++step) {
    const T* gr = step == 0 ? a.g_re : a.o_re;
    const T* gi = step == 0 ? a.g_im : a.o_im;
    for (int w = blockIdx.x; w < s.items; w += blocks) {
      const long long u1 = walk_unit_start(s, w + 1);
      for (long long u = walk_unit_start(s, w); u < u1;) {
        const int t = (int)(u / s.stages);
        const int s0 = (int)(u - (long long)t * s.stages);
        const int s1 = (int)min((long long)s.stages, s0 + (u1 - u));
        walk_segment<T, VEC>(st, a.h_re, a.h_im, n, s.lanes, gr, gi,
                             (t / s.lane_tiles) * kTileRows,
                             (t % s.lane_tiles) * kTileLanes, s0, s1,
                             a.part + (int64_t)(w + t) * kSlotElems, y_pol);
        u += s1 - s0;
      }
    }
    grid_sync(a.bar, blocks);
    const int64_t k = a.steps - 1 - step;
    const CimVjpEpilogue<T> epi{a.v_re + k * a.v_step, a.v_im + k * a.v_step,
                                a.s_re,    a.s_im,    a.mask,
                                a.sbar_re, a.sbar_im, a.vbbar_re,
                                a.vbbar_im, a.o_re,   a.o_im,
                                n};
    const int64_t e1 = entries * (blockIdx.x + 1) / blocks;
    for (int64_t e = entries * blockIdx.x / blocks + threadIdx.x; e < e1;
         e += kWalkThreads) {
      const int64_t b = e / n;
      const int i = (int)(e - b * n);
      T pr, pi;
      walk_sum(a, b, i, pr, pi);
      epi(b, i, pr, pi);
    }
    if (step + 1 < a.steps) grid_sync(a.bar, blocks);
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

template <typename T>
int launch_stamp(int mode, const int* inc_ptr, const int* inc_code,
                 const int* inc_nbr, const T* br, const T* status,
                 const T* g_sh, const T* b_sh, const T* keep, T* out_a,
                 T* out_b, int lanes, int n, int m, cudaStream_t stream) {
  if (lanes <= 0 || lanes > 65535 || n <= 0 || m < 0 || status == nullptr ||
      (mode != YBUS && mode != BPRIME && mode != BDBL) ||
      (mode == YBUS && out_b == nullptr) || (mode != YBUS && keep == nullptr))
    return (int)cudaErrorInvalidValue;
  stamp_kernel<T><<<dim3(n, lanes), kStampThreads, 0, stream>>>(
      mode, inc_ptr, inc_code, inc_nbr, br, status, g_sh, b_sh, keep, out_a,
      out_b, n, m);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_finish(const T* rowerr, int rows, T* err, int* it,
                  unsigned char* active, const T* tol, int max_iter, int fixed,
                  int lanes, cudaStream_t stream) {
  finish_kernel<T><<<(lanes + kFinishLanes - 1) / kFinishLanes,
                      32 * kFinishLanes, 0, stream>>>(
      rowerr, rows, err, it, active, tol, max_iter, fixed, lanes);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fdlf(int mode, T* x, const T* d, int64_t d_bs, int64_t d_js,
                const T* g, const T* bm, int lane_y, const T* ps, const T* qs,
                const T* th_free, const T* v_free, T* dp, T* dq, T* vr, T* vm,
                T* part, T* rowerr, T* err, int* it, unsigned char* active,
                const T* tol, int max_iter, int fixed, int lanes, int n,
                int splits, int* ticket, int rows, cudaStream_t stream) {
  if (lanes <= 0 || lanes > 65535 || n <= 0 ||
      (mode != INIT && mode != THETA && mode != VHALF) ||
      (mode != INIT && d == nullptr) || (lane_y && splits != 0))
    return (int)cudaErrorInvalidValue;
  if (splits == 0) {  // one launch: fdlf_warp_kernel
    const int64_t smem = 2 * (int64_t)n * (int64_t)sizeof(T);
    if (rows < 1 || rows > kF1MaxRows || smem > kF1SmemMax ||
        (mode != INIT && ticket == nullptr) ||
        (mode == VHALF && rowerr == nullptr))
      return (int)cudaErrorInvalidValue;
    static bool opted[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (smem > 48 * 1024 && (dev >= 64 || !opted[dev])) {
      e = cudaFuncSetAttribute(fdlf_warp_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kF1SmemMax);
      if (e != cudaSuccess) return (int)e;
      if (dev < 64) opted[dev] = true;
    }
    const dim3 grid((n + rows - 1) / rows, lanes);
    fdlf_warp_kernel<T><<<grid, kThreads, (size_t)smem, stream>>>(
        mode, x, d, d_bs, d_js, g, bm, lane_y ? (int64_t)n * n : 0, ps, qs,
        th_free, v_free, active, dp, dq, rowerr, ticket, err, it, tol,
        max_iter, fixed, n, rows);
    return (int)cudaGetLastError();
  }
  const int64_t total = (int64_t)lanes * n;
  fdlf_prepass_kernel<T><<<(unsigned)((total + kThreads - 1) / kThreads),
                           kThreads, 0, stream>>>(
      mode, x, d, d_bs, d_js, th_free, v_free, active, vr, vm, lanes, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const FdlfEpilogue<T> epi{mode,   x,      vr, vm, ps,     qs, th_free,
                            v_free, active, dp, dq, rowerr, n};
  e = (cudaError_t)row_product::launch_tiled<T>(g, bm, vr, vm, part, lanes,
                                              n, splits, epi, stream);
  if (e != cudaSuccess || mode != VHALF) return (int)e;
  // The tile form left a max a (lane, row tile).
  return launch_finish<T>(rowerr, row_product::row_tiles(n), err, it, active,
                          tol, max_iter, fixed, lanes, stream);
}

template <typename T>
int launch_jvp(const T* x, const T* u, const int* inc_ptr,
               const int* inc_code, const int* inc_nbr, const T* inc_g,
               const T* inc_b, const T* inc_gs, const T* inc_bs,
               const T* g_sh, const T* b_sh, const T* th_free,
               const T* v_free, const T* status, T* out, int lanes, int n,
               int m, cudaStream_t stream) {
  if (lanes <= 0 || n <= 0 || m < 0) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)lanes * n;
  jvp_kernel<T><<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0,
                  stream>>>(x, u, inc_ptr, inc_code, inc_nbr, inc_g, inc_b,
                            inc_gs, inc_bs, g_sh, b_sh, th_free, v_free,
                            status, out, lanes, n, m);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cim(const T* a_re, const T* a_im, const T* v_re, const T* v_im,
               const T* s_re, const T* s_im, const T* vb_re, const T* vb_im,
               const T* mask, T* j_re, T* j_im, T* part, T* o_re, T* o_im,
               T* rowerr, T* err, int* it, unsigned char* active,
               const T* tol, int max_iter, int fixed, int lanes, int N,
               int splits, cudaStream_t stream) {
  if (lanes <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)lanes * N;
  cim_inject_kernel<T><<<(unsigned)((total + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(v_re, v_im, s_re, s_im, j_re,
                                                j_im, total);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const CimEpilogue<T> epi{v_re,   v_im, vb_re, vb_im,  mask,
                           active, o_re, o_im,  rowerr, N};
  e = (cudaError_t)row_product::launch_tiled<T>(a_re, a_im, j_re, j_im, part,
                                              lanes, N, splits, epi, stream);
  if (e != cudaSuccess) return (int)e;
  return launch_finish<T>(rowerr, row_product::row_tiles(N), err, it, active,
                          tol, max_iter, fixed, lanes, stream);
}

template <typename T>
int launch_vjp(int mode, const T* x, const T* w, const int* inc_ptr,
               const int* inc_code, const int* inc_nbr, const T* inc_g,
               const T* inc_b, const T* inc_gs, const T* inc_bs,
               const T* inc_gt, const T* inc_bt, const T* g_sh,
               const T* b_sh, const T* th_free, const T* v_free,
               const T* status, T* out, int lanes, int n, int m,
               cudaStream_t stream) {
  if (lanes <= 0 || n <= 0 || m < 0 || (mode != MASKED && mode != FULL))
    return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)lanes * n;
  vjp_kernel<T><<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0,
                  stream>>>(mode, x, w, inc_ptr, inc_code, inc_nbr, inc_g,
                            inc_b, inc_gs, inc_bs, inc_gt, inc_bt, g_sh, b_sh,
                            th_free, v_free, status, out, lanes, n, m);
  return (int)cudaGetLastError();
}

// J1's and J2's staged route: ceil(lanes / L) groups of ctas_per_lane CTAs,
// L = lanes_per_cta; the shared memory L (3 n pairs + STATUS m values).
template <typename T, int KIND, int L, bool STATUS>
int launch_staged_as(const ResArgs<T>& a, int groups, size_t smem,
                     cudaStream_t stream) {
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024 && (dev >= 64 || !opted[dev])) {
    e = cudaFuncSetAttribute(residual_staged_kernel<T, KIND, L, STATUS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kResSmemMax);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) opted[dev] = true;
  }
  residual_staged_kernel<T, KIND, L, STATUS>
      <<<(unsigned)((int64_t)groups * a.ctas_per_lane), kResThreads, smem,
         stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int KIND>
int launch_staged(const ResArgs<T>& a, int lanes_per_cta,
                  cudaStream_t stream) {
  const int slices = (a.n + kResSlice - 1) / kResSlice;
  if (a.lanes <= 0 || a.n <= 0 || a.m < 0 || lanes_per_cta < 1 ||
      lanes_per_cta > kResMaxLanes || a.ctas_per_lane < 1 ||
      a.ctas_per_lane > slices)
    return (int)cudaErrorInvalidValue;
  const bool st = a.status != nullptr;
  const int64_t smem =
      (int64_t)lanes_per_cta *
      (6 * (int64_t)a.n + (st ? (int64_t)a.m : 0)) * (int64_t)sizeof(T);
  const int64_t groups = (a.lanes + lanes_per_cta - 1) / lanes_per_cta;
  if (smem > kResSmemMax || groups * a.ctas_per_lane > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int g = (int)groups;
  switch (lanes_per_cta * 2 + (st ? 1 : 0)) {
    case 2: return launch_staged_as<T, KIND, 1, false>(a, g, smem, stream);
    case 3: return launch_staged_as<T, KIND, 1, true>(a, g, smem, stream);
    case 4: return launch_staged_as<T, KIND, 2, false>(a, g, smem, stream);
    case 5: return launch_staged_as<T, KIND, 2, true>(a, g, smem, stream);
    case 6: return launch_staged_as<T, KIND, 3, false>(a, g, smem, stream);
    case 7: return launch_staged_as<T, KIND, 3, true>(a, g, smem, stream);
    case 8: return launch_staged_as<T, KIND, 4, false>(a, g, smem, stream);
    default: return launch_staged_as<T, KIND, 4, true>(a, g, smem, stream);
  }
}
static_assert(kResMaxLanes == 4, "launch_staged instantiates L = 1..4");

// I2's walk over `steps` iterates: a cooperative launch of
// min(items, resident CTAs) CTAs (every CTA resident: the grid barriers
// need it); a narrower card runs the same items in turns, so the bits do
// not depend on the width.
template <typename T>
int launch_cim_walk(const T* h_re, const T* h_im, const T* g_re,
                    const T* g_im, const T* v_re, const T* v_im,
                    long long v_step, const T* s_re, const T* s_im,
                    const T* mask, T* sbar_re, T* sbar_im, T* vbbar_re,
                    T* vbbar_im, T* o_re, T* o_im, T* part, unsigned* bar,
                    int lanes, int N, int steps, int slots,
                    cudaStream_t stream) {
  if (lanes <= 0 || N <= 0 || steps < 1 || part == nullptr ||
      bar == nullptr || (steps > 1 && v_step < (long long)lanes * N))
    return (int)cudaErrorInvalidValue;
  const WalkShape sh = walk_shape(N, lanes);
  if (slots != walk_slots(sh)) return (int)cudaErrorInvalidValue;
  constexpr int kVec = 16 / sizeof(T);
  const bool wide = N % kVec == 0 &&
                    ((uintptr_t)h_re | (uintptr_t)h_im | (uintptr_t)g_re |
                     (uintptr_t)g_im | (uintptr_t)o_re | (uintptr_t)o_im) %
                            16 == 0;
  void (*kernel)(const WalkArgs<T>) =
      wide ? cim_walk_kernel<T, kVec> : cim_walk_kernel<T, 1>;
  constexpr int smem = kWalkStages * (int)sizeof(row_product::Stage<T>);
  // Per device and form: the opt-in to the ring's shared memory and
  // the CTAs the card holds at once.
  static int resident[2][64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int held = dev < 64 ? resident[wide][dev] : 0;
  if (held == 0) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kWalkThreads, smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    held = per_sm * sms;
    if (held < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    if (dev < 64) resident[wide][dev] = held;
  }
  const int grid = sh.items < held ? sh.items : held;
  WalkArgs<T> a{h_re,     h_im,    g_re,     g_im,     v_re, v_im,
                v_step,   s_re,    s_im,     mask,     sbar_re, sbar_im,
                vbbar_re, vbbar_im, o_re,    o_im,     part, bar,
                steps,    sh};
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                  dim3(kWalkThreads), args, (size_t)smem,
                                  stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer to a
// contiguous tensor unless a stride says otherwise (F1's `d`); `stream` is
// the caller's CUDA stream.  `it` is int32, `active` one byte a lane, `tol`
// one element.  J1's null `status` means every branch in service.  F1's and
// I1's `splits` (the tiled product's K slices) comes from
// newton_kernels.product_splits (F1 takes 0 for its warp form, and then no
// `part`, `vr` or `vm`; its `rowerr` is the [lanes, ctas] CTA maxima, its
// `ticket` [lanes, 2] int32 zeros and `rows` from solver_kernels.
// fdlf_warp_plan), `part` is the product's [splits, 2, lanes, n] scratch; I1's
// `j_re`/`j_im` are its [lanes, N] injection scratch.  J2 takes J1's
// operands plus `inc_gt`/`inc_bt`, the other end's mutual admittance of each
// incidence entry; I2 (`cim_vjp_walk`: `steps` iterations walked back
// in one launch, one for a single call) the staged A^H (`h_re`/`h_im` [N,
// N]), the first step's cotangent `g` [lanes, N], the iterate of step j at
// `v + (steps - 1 - j) v_step`, `sbar`/`vbbar` [lanes, N] added to in
// place, `o_re`/`o_im` [lanes, N] (each step's cotangent of its iterate;
// the last step's is left there), `part` the walk's `slots` partial-sum
// slots (solver_kernels.cim_walk_plan) and `bar` two uint32 (zeros before
// the first launch on a stream; each launch leaves them so).  Returns the
// cudaError_t of the launches.
#define SOLVER_ENTRY_POINTS(T, SUFFIX)                                         \
  extern "C" int ybus_stamp_##SUFFIX(                                         \
      int mode, const int* inc_ptr, const int* inc_code, const int* inc_nbr,  \
      const T* br, const T* status, const T* g_sh, const T* b_sh,            \
      const T* keep, T* out_a, T* out_b, int lanes, int n, int m,            \
      void* stream) {                                                        \
    return launch_stamp<T>(mode, inc_ptr, inc_code, inc_nbr, br, status,     \
                           g_sh, b_sh, keep, out_a, out_b, lanes, n, m,      \
                           (cudaStream_t)stream);                            \
  }                                                                          \
  extern "C" int fdlf_half_step_##SUFFIX(                                     \
      int mode, T* x, const T* d, long long d_bs, long long d_js, const T* g, \
      const T* bm, int lane_y, const T* ps, const T* qs, const T* th_free,    \
      const T* v_free, T* dp, T* dq, T* vr, T* vm, T* part, T* rowerr,        \
      T* err, int* it, unsigned char* active, const T* tol, int max_iter,     \
      int fixed, int lanes, int n, int splits, int* ticket, int rows,         \
      void* stream) {                                                        \
    return launch_fdlf<T>(mode, x, d, d_bs, d_js, g, bm, lane_y, ps, qs,     \
                          th_free, v_free, dp, dq, vr, vm, part, rowerr,     \
                          err, it, active, tol, max_iter, fixed, lanes, n,   \
                          splits, ticket, rows, (cudaStream_t)stream);       \
  }                                                                          \
  extern "C" int residual_jvp_##SUFFIX(                                       \
      const T* x, const T* u, const int* inc_ptr, const int* inc_code,        \
      const int* inc_nbr, const T* inc_g, const T* inc_b, const T* inc_gs,    \
      const T* inc_bs, const T* g_sh, const T* b_sh, const T* th_free,        \
      const T* v_free, const T* status, T* out, int lanes, int n, int m,      \
      void* stream) {                                                        \
    return launch_jvp<T>(x, u, inc_ptr, inc_code, inc_nbr, inc_g, inc_b,     \
                         inc_gs, inc_bs, g_sh, b_sh, th_free, v_free, status, \
                         out, lanes, n, m, (cudaStream_t)stream);            \
  }                                                                          \
  extern "C" int residual_jvp_staged_##SUFFIX(                                \
      const T* x, const T* u, const int* slot, const int* base,               \
      const int* where, const int* idx, const T* val, const T* g_sh,          \
      const T* b_sh,                                                          \
      const T* th_free, const T* v_free, const T* status, T* out, int lanes,  \
      int n, int m, int lanes_per_cta, int ctas_per_lane, void* stream) {     \
    const ResArgs<T> a{x,       u,       (const int2*)slot, (const int2*)idx, \
                       base,    where,   val,     g_sh,     b_sh,    th_free, \
                       v_free,  status,  out,     lanes,    n,                \
                       m,       ctas_per_lane,    0};                         \
    return launch_staged<T, kJvp>(a, lanes_per_cta, (cudaStream_t)stream);   \
  }                                                                          \
  extern "C" int cim_iterate_##SUFFIX(                                        \
      const T* a_re, const T* a_im, const T* v_re, const T* v_im,             \
      const T* s_re, const T* s_im, const T* vb_re, const T* vb_im,           \
      const T* mask, T* j_re, T* j_im, T* part, T* o_re, T* o_im,             \
      T* rowerr, T* err, int* it, unsigned char* active, const T* tol,        \
      int max_iter, int fixed, int lanes, int N, int splits, void* stream) { \
    return launch_cim<T>(a_re, a_im, v_re, v_im, s_re, s_im, vb_re, vb_im,   \
                         mask, j_re, j_im, part, o_re, o_im, rowerr, err,    \
                         it, active, tol, max_iter, fixed, lanes, N, splits, \
                         (cudaStream_t)stream);                              \
  }                                                                          \
  extern "C" int residual_vjp_##SUFFIX(                                       \
      int mode, const T* x, const T* w, const int* inc_ptr,                   \
      const int* inc_code, const int* inc_nbr, const T* inc_g,                \
      const T* inc_b, const T* inc_gs, const T* inc_bs, const T* inc_gt,      \
      const T* inc_bt, const T* g_sh, const T* b_sh, const T* th_free,        \
      const T* v_free, const T* status, T* out, int lanes, int n, int m,      \
      void* stream) {                                                        \
    return launch_vjp<T>(mode, x, w, inc_ptr, inc_code, inc_nbr, inc_g,      \
                         inc_b, inc_gs, inc_bs, inc_gt, inc_bt, g_sh, b_sh,  \
                         th_free, v_free, status, out, lanes, n, m,          \
                         (cudaStream_t)stream);                              \
  }                                                                          \
  extern "C" int residual_vjp_staged_##SUFFIX(                                \
      int mode, const T* x, const T* w, const int* slot, const int* base,     \
      const int* where, const int* idx, const T* val, const T* g_sh,          \
      const T* b_sh,                                                          \
      const T* th_free, const T* v_free, const T* status, T* out, int lanes,  \
      int n, int m, int lanes_per_cta, int ctas_per_lane, void* stream) {     \
    if (mode != MASKED && mode != FULL) return (int)cudaErrorInvalidValue;   \
    const ResArgs<T> a{x,       w,       (const int2*)slot, (const int2*)idx, \
                       base,    where,   val,     g_sh,     b_sh,    th_free, \
                       v_free,  status,  out,     lanes,    n,                \
                       m,       ctas_per_lane,    mode == FULL};              \
    return launch_staged<T, kVjp>(a, lanes_per_cta, (cudaStream_t)stream);   \
  }                                                                          \
  extern "C" int cim_vjp_walk_##SUFFIX(                                       \
      const T* h_re, const T* h_im, const T* g_re, const T* g_im,             \
      const T* v_re, const T* v_im, long long v_step, const T* s_re,          \
      const T* s_im, const T* mask, T* sbar_re, T* sbar_im, T* vbbar_re,      \
      T* vbbar_im, T* o_re, T* o_im, T* part, unsigned* bar, int lanes,       \
      int N, int steps, int slots, void* stream) {                            \
    return launch_cim_walk<T>(h_re, h_im, g_re, g_im, v_re, v_im, v_step,    \
                              s_re, s_im, mask, sbar_re, sbar_im, vbbar_re,  \
                              vbbar_im, o_re, o_im, part, bar, lanes, N,     \
                              steps, slots, (cudaStream_t)stream);           \
  }

SOLVER_ENTRY_POINTS(double, f64)
SOLVER_ENTRY_POINTS(float, f32)
