// Sparse Newton AC power-flow kernels for Hopper (sm_90a).
//
// S1 sparse_assemble — replaces the XLA program of freedm_tpu/pf/sparse.py
//   :307-344 `_assemble` plus `_residual_from` (:372-375): the BCSR value fill
//   of the polar Jacobian over the branch pattern.  Per directed edge, with
//   E = theta_f - theta_t and the branch two-port admittances,
//
//       C_ft = V_f V_t (G_ft cos E + B_ft sin E)   A_ft = V_f V_t (G_ft sin E - B_ft cos E)
//       C_tf = V_f V_t (G_tf cos E - B_tf sin E)   A_tf = -V_f V_t (G_tf sin E + B_tf cos E)
//
//   and C/V, A/V of the far end; then per bus the sums P, Q over the
//   incident edges, the four block diagonals h, n, j, l and the masked
//   mismatch f.  The off-diagonal values are stored in incidence-list
//   order (CSR): entry r of bus i's list, edge e to bus j, holds row i's
//   four values at column j, the terms of e's side at i.  One launch, in
//   one of three modes: the values in the working dtype; float32 values
//   from float64 arithmetic (the mixed Newton step's inner solve, each
//   value rounded once at its store, f kept in float64); and the residual
//   alone (P, Q and f, no values written).  With a per-lane branch status
//   (the reference's `_assemble(theta, v, status)`, the N-1 screen's
//   outage lanes), every mode scales each entry's two-port admittances by
//   status[lane, edge] and builds the lane's Ybus diagonal from the
//   entries' self admittances (yff at a from end, ytt at a to end) times
//   the same factor, summed by side in list order next to P and Q, plus
//   the bus shunt; without it the kernels are the all-in-service ones
//   (a template parameter: no test in their inner loops).
//
// S2 sparse_matvec — replaces `_matvec` (:346-370): y = J u over the same
//   pattern, pinned rows passing u through.  One thread per (lane, bus row)
//   walks the incidence list, whose values lie contiguous, and produces
//   both halves (rows i and n + i).
//
// S3 gmres_block_orth — replaces the block step of freedm_tpu/pf/krylov.py
//   `_pgmres_block` (:451-471): two-pass block Gram-Schmidt of the [s, N]
//   candidate block against the masked basis rows 0..j0, CholQR2 with the
//   ridge, the all-NaN factor on a failed Cholesky (jnp.linalg.cholesky's
//   rule, which `where(isfinite)` then turns into a zero block), the newv row
//   mask, and the writes into v_basis[j0+1 : j0+1+s] and valid.  A cluster
//   of C <= 8 CTAs per lane splits the N columns into contiguous slices.
//
// S4 gmres_lstsq — replaces the finish of `_pgmres_block` (:479-482):
//   H = (V valid) W^T of shape [mm+1, mm], the SVD minimum-norm least squares
//   min |beta e1 - H y| with jnp.linalg.lstsq's cutoff (keep sigma > 0 and
//   sigma >= eps max(mm+1, mm) sigma_max, eps of the working dtype), then
//   x = Z^T y.  The SVD is a one-sided (Hestenes) Jacobi on the [mm+1, mm]
//   matrix, column pairs in round-robin order, run by one warp.  H's dot
//   products and the SVD run in float64 for both instantiations (x = Z^T y
//   stays in the working dtype): in the mixed inner solve H's condition can
//   reach 1e5 and more, where float32 sums over N = 4000 terms fix the
//   minimizer to only ~1e-2, and the 272 numbers cost nothing in float64.

// Every sum runs in a fixed order and no kernel uses atomics, so results are
// identical run to run.  The incidence list of a bus holds first the edges
// whose from end it is, then those whose to end it is, each in ascending
// edge order: S1 sums the two sides separately and S2 in one accumulator, in
// the reference's segment_sum order.
//
// Bounds on an H100 SXM (3.35 TB/s; 34 / 67 TFLOP/s fp64 / fp32 outside the
// tensor cores), mesh2000 (n = 2000, m = 4000, N = 2n), 64 lanes, float64:
//   S1 reads x and the schedules and writes 8 values per edge (4 per list
//      entry), 6 bus values and f per lane: bytes, about 28.7 MB, 8.6 us
//      (float32 values 17.4 MB, 5.2 us; the residual alone, P, Q and f,
//      8.2 MB, 2.4 us).  A status adds B m words a call (at 256 lanes in
//      float64, 8.2 MB, 2.4 us) and the 2m self terms.  Design: see the
//      kernel.
//   S2 reads u, the values and the 4 diagonal arrays and writes y: bytes,
//      about 24.6 MB, 7.4 us (half in float32).  Design: the values of a
//      row lie contiguous, so the walks of a warp's 32 rows read ~128
//      consecutive entries of each array; only the gathers of u at the far
//      ends stay scattered.  In the reference's edge order ([lane, array,
//      edge]) the values of a bus's random chords lay scattered too, and a
//      warp of 32 lanes of one bus on a lane-innermost layout ([array,
//      edge, lane]) gathered u from 32 rows 256 KB apart: both measured
//      slower on an H100 (PERF.md), as did a cluster form, four lanes per
//      thread and 32 lanes of a bus per warp on the edge-order layout, and
//      loads issued four list entries at a time.
//   S3 reads the j0+1 basis rows and the [s, N] block once and writes the
//      s new rows: bytes, about 43 MB at j0 = 12, s = 4, 12.8 us.  Design:
//      a cluster of C CTAs per lane (512 CTAs at 64 lanes) each copies its
//      slice of those rows into shared memory once (cp.async; 68 KB at
//      mesh2000 with C = 8) and keeps it there through both Gram-Schmidt
//      passes and both CholQR passes; Q is written once.  Where the slice
//      does not fit in 227 KB (33 basis rows at mesh5000's N = 10,000) the
//      CTA reads it from global memory (L2) in every pass instead, same
//      arithmetic.  Each dot product (projection coefficients, Gram) is a
//      float64 sum: per CTA, one warp per product, lanes over the slice's
//      columns in order and a fixed shuffle tree; after a cluster barrier
//      every CTA adds the C partials in rank order through distributed
//      shared memory, so all hold the same bits, and rounds to the working
//      dtype, as a GEMM's output is (float32 sums over N = 10,000 lost the
//      orthogonality CholQR2 needs, and mixed solves at mesh5000 fell back
//      to float64).  Each CTA then runs the s x s Cholesky itself.
//   S4 reads V, W and Z once: bytes, about 100 MB, 30.6 us.  Design: three
//      kernels.  The H pass splits each lane over 8 CTAs (512 at 64 lanes)
//      that stream their columns of V and W through two cp.async tile
//      stages into float64 partials of H; one warp per lane adds the
//      partials in order and runs the Jacobi SVD with its columns in
//      registers (no barrier inside the sweeps); then one thread per
//      (lane, column) writes x = Z^T y.  The SVD is a chain of ~165 rounds
//      of dependent divisions and square roots: in one kernel with the
//      streaming pass (a cluster per lane, the SVD by warp 0) it held every
//      CTA's SM through that chain, and the clusters of a second wave
//      waited for it (0.83 ms at mesh2000 x 64 on an H100, against 0.60
//      ms for the first form, one CTA per lane).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxS = 8;       // s-step block size
constexpr int kMaxCols = 32;   // Krylov dimension mm of S4
constexpr int kMaxSweeps = 60; // Jacobi sweeps
constexpr int kMaxCluster = 8; // CTAs per lane of S3 (portable size)
constexpr int kOrthRows = kMaxCols + 1;  // basis rows of S3
constexpr int kMaxProd = 256;  // dot products of one S3 reduction (s (j0+1) <= 200)
constexpr int kMaxSmem = 232448;  // shared memory a block may use on Hopper

template <typename T> struct Lim;
template <> struct Lim<double> {
  static constexpr double eps = 2.220446049250313e-16;
  static constexpr double tiny = 2.2250738585072014e-308;
};
template <> struct Lim<float> {
  static constexpr float eps = 1.1920929e-07f;
  static constexpr float tiny = 1.17549435e-38f;
};

__device__ __forceinline__ void sincos_(double x, double* s, double* c) { sincos(x, s, c); }
__device__ __forceinline__ void sincos_(float x, float* s, float* c) { sincosf(x, s, c); }

// jnp.maximum: NaN if either operand is NaN.
template <typename T>
__device__ __forceinline__ T nanmax(T a, T b) {
  if (a != a || b != b) return a + b;
  return a > b ? a : b;
}

template <typename T>
__device__ __forceinline__ T quiet_nan() { return T(NAN); }

// ---------------------------------------------------------------------------
// S1
// ---------------------------------------------------------------------------

// Arithmetic with explicit rounding: nvcc contracts a * b + c into one fma
// where it sees one.  Every operation of S1 is one of these, so each mode
// and instantiation, and PyTorch's elementwise ops (which round each
// operation), give the same bits from the same inputs.
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

// The c/a term of one directed edge: f -> t (side 0, the from end's
// C_ft, A_ft) or t -> f (side 1, C_tf, A_tf), from the end states and the
// side's two-port admittance (g, b).  With sb = +-b and E = theta_f -
// theta_t,
//     c = V_f V_t (g cos E + sb sin E),  a = +-V_f V_t (g sin E - sb cos E),
// which is the reference's formula of either side exactly: (-b) y = -(b y)
// and x + (-y) = x - y in IEEE arithmetic.
template <typename T>
__device__ __forceinline__ void edge_term(T th_f, T th_t, T v_f, T v_t, T g,
                                          T b, bool to_side, T* c, T* a) {
  T se, ce;
  sincos_(sub_rn(th_f, th_t), &se, &ce);
  const T vv = mul_rn(v_f, v_t);
  const T sb = to_side ? -b : b;
  *c = mul_rn(vv, add_rn(mul_rn(g, ce), mul_rn(sb, se)));
  const T a0 = mul_rn(vv, sub_rn(mul_rn(g, se), mul_rn(sb, ce)));
  *a = to_side ? -a0 : a0;
}

// What S1 writes of bus i of lane b from the sums of its from-side and
// to-side terms and its Ybus diagonal (gd, bd): bv[b, k, i] (k = 0 h_d,
// 1 n_d, 2 j_d, 3 l_d, 4 p_calc, 5 q_calc) when kFull, else p[b, i] into
// bv and q[b, i] into qout; and the masked mismatch f.
template <typename T, typename V, bool kFull>
__device__ __forceinline__ void bus_outputs(
    T pf, T pt, T qf, T qt, T thi, T vi, T gd, T bd, int64_t b, int i,
    int n, const T* __restrict__ ps, const T* __restrict__ qs,
    const T* __restrict__ th_free, const T* __restrict__ v_free,
    const T* __restrict__ v_set, V* __restrict__ bv, V* __restrict__ qout,
    T* __restrict__ fout) {
  const T v2 = mul_rn(vi, vi);
  const T p = add_rn(add_rn(pf, pt), mul_rn(v2, gd));
  const T q = sub_rn(add_rn(qf, qt), mul_rn(v2, bd));
  if (kFull) {
    V* bl = bv + b * 6 * (int64_t)n + i;
    bl[0] = (V)sub_rn(mul_rn(-v2, bd), q);
    bl[n] = (V)add_rn(mul_rn(vi, gd), div_rn(p, vi));
    bl[2 * (int64_t)n] = (V)add_rn(mul_rn(-v2, gd), p);
    bl[3 * (int64_t)n] = (V)add_rn(mul_rn(-vi, bd), div_rn(q, vi));
    bl[4 * (int64_t)n] = (V)p;
    bl[5 * (int64_t)n] = (V)q;
  } else {
    bv[b * n + i] = (V)p;
    qout[b * n + i] = (V)q;
  }
  const int64_t xi = b * 2 * n + i;
  fout[xi] = th_free[i] > T(0) ? sub_rn(p, ps[b * n + i]) : thi;
  fout[xi + n] = v_free[i] > T(0) ? sub_rn(q, qs[b * n + i])
                                  : sub_rn(vi, v_set[i]);
}

// Buses of one lane per CTA of S1's value fill, and its threads: the list
// entries it takes at a time (32 buses hold ~128 entries at mesh2000, 4 a
// bus, so a tile takes one pass or two).
constexpr int kTileBuses = 32;
constexpr int kTileEntries = 128;

// S1's value fill (FULL, VALUES_F32), a CTA per tile of kTileBuses buses
// of one lane.  The tile's lists lie contiguous; its threads take them
// kTileEntries entries at a time, one entry each: the entry's edge term on
// its bus's side from x (the entry's admittance pair, g = inc_g[r] and
// b = inc_b[r], is the side's; its bus's state comes from shared memory),
// whose four values ev[b, k, r] (k = 0 a, 1 c, 2 cv = c / V_j, 3 av =
// a / V_j) a warp stores coalesced, and whose c/a go to shared memory.
// Then thread t < kTileBuses adds its bus's terms in list order, from-side
// and to-side apart: P and Q are the sums of the values written, bit for
// bit.  A thread per bus writing its own entries (a warp's stores spread
// over ~128 entries, a sector apart) and that form staging its values in
// shared memory measured slower on an H100 (PERF.md).
//
// T is the arithmetic's type and V the type ev and bv are stored in
// (float from double: each value is rounded once, at its store).  With
// kStatus the entry's thread scales its admittances and its side's self
// term by status[b, edge], and the owner adds the self terms by side
// beside the c/a terms: the lane's Ybus diagonal.
template <typename T, typename V, bool kStatus>
__global__ void __launch_bounds__(kTileEntries) assemble_kernel(
    const T* __restrict__ x, const T* __restrict__ ps,
    const T* __restrict__ qs, const T* __restrict__ th_free,
    const T* __restrict__ v_free, const T* __restrict__ v_set,
    const T* __restrict__ inc_g, const T* __restrict__ inc_b,
    const T* __restrict__ g_d, const T* __restrict__ b_d,
    const int* __restrict__ inc_ptr, const int* __restrict__ inc_code,
    const int* __restrict__ inc_nbr, const T* __restrict__ status,
    const T* __restrict__ inc_gs, const T* __restrict__ inc_bs,
    const T* __restrict__ g_sh, const T* __restrict__ b_sh,
    V* __restrict__ ev, V* __restrict__ bv, T* __restrict__ fout,
    int lanes, int n, int m) {
  __shared__ T s_c[kTileEntries], s_a[kTileEntries];
  __shared__ T s_gs[kStatus ? kTileEntries : 1], s_bs[kStatus ? kTileEntries : 1];
  __shared__ T s_th[kTileBuses], s_v[kTileBuses];
  __shared__ unsigned char s_bus[kTileEntries];
  __shared__ bool s_to[kTileEntries];
  const int tiles = (n + kTileBuses - 1) / kTileBuses;
  const int64_t b = blockIdx.x / tiles;
  const int i0 = (int)(blockIdx.x - b * tiles) * kTileBuses;
  const int i1 = min(i0 + kTileBuses, n);
  const T* th = x + b * 2 * n;
  const T* v = th + n;
  const int tid = threadIdx.x;
  const int i = i0 + tid;
  const bool own = tid < kTileBuses && i < i1;
  int r_lo = 0, r_hi = 0;
  T thi = T(0), vi = T(0);
  if (own) {
    r_lo = inc_ptr[i];
    r_hi = inc_ptr[i + 1];
    thi = th[i];
    vi = v[i];
    s_th[tid] = thi;
    s_v[tid] = vi;
  }
  const int rs = inc_ptr[i0], re = inc_ptr[i1];
  const int64_t m2 = 2 * (int64_t)m;
  V* evl = ev + b * 4 * m2;
  T pf = T(0), pt = T(0), qf = T(0), qt = T(0);
  T gf = T(0), gt = T(0), bf = T(0), bt = T(0);  // kStatus: the diagonal
  for (int c0 = rs; c0 < re; c0 += kTileEntries) {
    if (own)  // which of the tile's buses each entry of this pass is
      for (int r = max(r_lo, c0); r < min(r_hi, c0 + kTileEntries); ++r)
        s_bus[r - c0] = (unsigned char)tid;
    __syncthreads();
    const int r = c0 + tid;
    if (r < re) {
      const int code = inc_code[r];
      const bool to_side = code & 1;  // the entry's bus is the to end
      const int j = inc_nbr[r];
      const T tho = s_th[s_bus[tid]], vo = s_v[s_bus[tid]];
      const T thj = th[j], vj = v[j];
      T g = inc_g[r], bb = inc_b[r];
      if (kStatus) {
        const T st = status[b * m + (code >> 1)];
        g = mul_rn(g, st);
        bb = mul_rn(bb, st);
        s_gs[tid] = mul_rn(inc_gs[r], st);
        s_bs[tid] = mul_rn(inc_bs[r], st);
      }
      T c, a;
      edge_term(to_side ? thj : tho, to_side ? tho : thj, to_side ? vj : vo,
                to_side ? vo : vj, g, bb, to_side, &c, &a);
      evl[r] = (V)a;
      evl[m2 + r] = (V)c;
      evl[2 * m2 + r] = (V)div_rn(c, vj);
      evl[3 * m2 + r] = (V)div_rn(a, vj);
      s_c[tid] = c;
      s_a[tid] = a;
      s_to[tid] = to_side;
    }
    __syncthreads();
    if (own) {
      const int hi = min(r_hi, c0 + kTileEntries) - c0;
      for (int q = max(r_lo, c0) - c0; q < hi; ++q) {
        if (s_to[q]) {
          pt = add_rn(pt, s_c[q]);
          qt = add_rn(qt, s_a[q]);
          if (kStatus) {
            gt = add_rn(gt, s_gs[q]);
            bt = add_rn(bt, s_bs[q]);
          }
        } else {
          pf = add_rn(pf, s_c[q]);
          qf = add_rn(qf, s_a[q]);
          if (kStatus) {
            gf = add_rn(gf, s_gs[q]);
            bf = add_rn(bf, s_bs[q]);
          }
        }
      }
    }
  }
  if (own) {
    const T gd = kStatus ? add_rn(add_rn(gf, gt), g_sh[i]) : g_d[i];
    const T bd = kStatus ? add_rn(add_rn(bf, bt), b_sh[i]) : b_d[i];
    bus_outputs<T, V, true>(pf, pt, qf, qt, thi, vi, gd, bd, b, i, n, ps,
                            qs, th_free, v_free, v_set, bv, nullptr, fout);
  }
}

// S1's residual alone (RESIDUAL): one thread per (lane, bus) walks its list
// and adds the same terms in the same order as assemble_kernel, writing P,
// Q and f only, so they are that kernel's bits.  With no values to store,
// the thread per bus is the faster form: the tile's barriers cost more
// than its warps' unequal walks (PERF.md).
template <typename T, bool kStatus>
__global__ void __launch_bounds__(kThreads) residual_kernel(
    const T* __restrict__ x, const T* __restrict__ ps,
    const T* __restrict__ qs, const T* __restrict__ th_free,
    const T* __restrict__ v_free, const T* __restrict__ v_set,
    const T* __restrict__ inc_g, const T* __restrict__ inc_b,
    const T* __restrict__ g_d, const T* __restrict__ b_d,
    const int* __restrict__ inc_ptr, const int* __restrict__ inc_code,
    const int* __restrict__ inc_nbr, const T* __restrict__ status,
    const T* __restrict__ inc_gs, const T* __restrict__ inc_bs,
    const T* __restrict__ g_sh, const T* __restrict__ b_sh,
    T* __restrict__ pout, T* __restrict__ qout, T* __restrict__ fout,
    int lanes, int n, int m) {
  const int64_t k = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (k >= (int64_t)lanes * n) return;
  const int64_t b = k / n;
  const int i = (int)(k - b * n);
  const T* th = x + b * 2 * n;
  const T* v = th + n;
  const T thi = th[i], vi = v[i];
  T pf = T(0), pt = T(0), qf = T(0), qt = T(0);
  T gf = T(0), gt = T(0), bf = T(0), bt = T(0);  // kStatus: the diagonal
  for (int r = inc_ptr[i]; r < inc_ptr[i + 1]; ++r) {
    const int code = inc_code[r];
    const bool to_side = code & 1;
    const int j = inc_nbr[r];
    const T thj = th[j], vj = v[j];
    T g = inc_g[r], bb = inc_b[r], gs = T(0), bs = T(0);
    if (kStatus) {
      const T st = status[b * m + (code >> 1)];
      g = mul_rn(g, st);
      bb = mul_rn(bb, st);
      gs = mul_rn(inc_gs[r], st);
      bs = mul_rn(inc_bs[r], st);
    }
    T c, a;
    edge_term(to_side ? thj : thi, to_side ? thi : thj, to_side ? vj : vi,
              to_side ? vi : vj, g, bb, to_side, &c, &a);
    if (to_side) {
      pt = add_rn(pt, c);
      qt = add_rn(qt, a);
      if (kStatus) {
        gt = add_rn(gt, gs);
        bt = add_rn(bt, bs);
      }
    } else {
      pf = add_rn(pf, c);
      qf = add_rn(qf, a);
      if (kStatus) {
        gf = add_rn(gf, gs);
        bf = add_rn(bf, bs);
      }
    }
  }
  const T gd = kStatus ? add_rn(add_rn(gf, gt), g_sh[i]) : g_d[i];
  const T bd = kStatus ? add_rn(add_rn(bf, bt), b_sh[i]) : b_d[i];
  bus_outputs<T, T, false>(pf, pt, qf, qt, thi, vi, gd, bd, b, i, n, ps, qs,
                           th_free, v_free, v_set, pout, qout, fout);
}

// ---------------------------------------------------------------------------
// S2
// ---------------------------------------------------------------------------

// ev[b, k, r] as S1 writes it: k = 0 a, 1 c, 2 cv, 3 av of list entry r.
template <typename T>
__global__ void matvec_kernel(const T* __restrict__ ev, const T* __restrict__ bv,
                              const T* __restrict__ u,
                              const T* __restrict__ th_free,
                              const T* __restrict__ v_free,
                              const int* __restrict__ inc_ptr,
                              const int* __restrict__ inc_nbr,
                              T* __restrict__ y, int lanes, int n, int m) {
  const int64_t k = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (k >= (int64_t)lanes * n) return;
  const int64_t b = k / n;
  const int i = (int)(k - b * n);
  const int64_t m2 = 2 * (int64_t)m;
  const T* evl = ev + b * 4 * m2;
  const T* bl = bv + b * 6 * (int64_t)n;
  const T* uth = u + b * 2 * n;
  const T* uv = uth + n;
  T yp = T(0), yq = T(0);
  for (int r = inc_ptr[i]; r < inc_ptr[i + 1]; ++r) {
    const int j = inc_nbr[r];
    const T ua = uth[j], ub = uv[j];
    yp += evl[r] * ua + evl[2 * m2 + r] * ub;
    yq += -evl[m2 + r] * ua + evl[3 * m2 + r] * ub;
  }
  const T ui = uth[i], wi = uv[i];
  yp = yp + bl[i] * ui + bl[n + i] * wi;
  yq = yq + bl[2 * (int64_t)n + i] * ui + bl[3 * (int64_t)n + i] * wi;
  y[b * 2 * n + i] = th_free[i] > T(0) ? yp : ui;
  y[b * 2 * n + n + i] = v_free[i] > T(0) ? yq : wi;
}

// ---------------------------------------------------------------------------
// S3
// ---------------------------------------------------------------------------

// Lower Cholesky of the s x s matrix g + ridge I into L (one thread).  On a
// pivot that is not > 0, or any non-finite entry, L's lower triangle is NaN.
template <typename T>
__device__ void cholesky_or_nan(const T* g, T ridge, int s, T (*L)[kMaxS]) {
  bool ok = true;
  for (int i = 0; i < s; ++i)
    for (int j = 0; j < s; ++j) {
      const T a = g[i * s + j] + (i == j ? ridge : T(0));
      if (!isfinite(a)) ok = false;
      L[i][j] = T(0);
    }
  for (int j = 0; j < s && ok; ++j) {
    T d = g[j * s + j] + ridge;
    for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k];
    if (!(d > T(0))) {
      ok = false;
      break;
    }
    const T ljj = sqrt(d);
    L[j][j] = ljj;
    for (int i = j + 1; i < s; ++i) {
      T a = g[i * s + j];
      for (int k = 0; k < j; ++k) a -= L[i][k] * L[j][k];
      L[i][j] = a / ljj;
    }
  }
  if (!ok)  // jnp.linalg.cholesky's failure: an all-NaN lower triangle
    for (int i = 0; i < s; ++i)
      for (int j = 0; j < s; ++j) L[i][j] = j <= i ? quiet_nan<T>() : T(0);
}

// Element (r, k) of a block of rows at p[r * stride + k].
template <typename T>
struct Rows {
  T* p;
  int64_t stride;
  __device__ __forceinline__ T& operator()(int r, int k) const {
    return p[r * stride + k];
  }
};

// Copy one element global -> shared without staging it in registers.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// This CTA's float64 partials of out[a * nbr + b] = sum_k A(a, k) (B(b, k)
// bscale[b]) over its w columns: one warp per product (products round-robin
// over the warps); each lane keeps two sums, over k = lane + 64 i and
// k = lane + 32 + 64 i in order, adds them, and a fixed shuffle tree adds
// the lanes into lane 0.
template <typename T>
__device__ void slice_dots(Rows<T> A, int na, Rows<T> B, int nbr,
                           const T* bscale, int w, double* out) {
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int p = warp; p < na * nbr; p += nwarps) {
    const int a = p / nbr, b = p - a * nbr;
    const T sc = bscale != nullptr ? bscale[b] : T(1);
    double acc0 = 0.0, acc1 = 0.0;
    int k = ln;
    for (; k + 32 < w; k += 64) {
      acc0 += (double)A(a, k) * (double)(B(b, k) * sc);
      acc1 += (double)A(a, k + 32) * (double)(B(b, k + 32) * sc);
    }
    if (k < w) acc0 += (double)A(a, k) * (double)(B(b, k) * sc);
    double acc = acc0 + acc1;
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (ln == 0) out[p] = acc;
  }
}

// out[p] = the cluster's sum of every CTA's part[p], ranks in order, rounded
// to T: identical bits in every CTA.  Callers alternate between two `part`
// buffers, so one barrier per reduction keeps a buffer from being rewritten
// while another CTA still reads it.
template <typename T>
__device__ void cluster_sum(cg::cluster_group& cluster, double* part, int np,
                            T* out) {
  cluster.sync();
  const int C = (int)cluster.num_blocks();
  for (int p = threadIdx.x; p < np; p += blockDim.x) {
    double acc = 0.0;
    for (int c = 0; c < C; ++c) acc += cluster.map_shared_rank(part, c)[p];
    out[p] = (T)acc;
  }
  __syncthreads();
}

// Bytes of S3's shared memory ahead of the resident rows: two partial
// buffers (double), the coefficients, L, newv and the basis rows' valid.
__host__ __device__ constexpr int orth_header_bytes(int itemsize) {
  return (2 * kMaxProd * 8 +
          (kMaxProd + kMaxS * kMaxS + kMaxS + kOrthRows) * itemsize + 15) /
         16 * 16;
}

// One CTA of lane blockIdx.x / C owns the columns [c0, c1) = [rank N / C,
// (rank + 1) N / C).  kResident: it keeps the basis rows 0..j0 and the block
// of that slice in shared memory (row stride wmax) for the whole call; else
// it reads them from global memory in every pass, building Q in place in
// v_basis rows j0+1..j0+s.  Both run the same arithmetic in the same order.
template <typename T, bool kResident>
__global__ void __launch_bounds__(kThreads) block_orth_kernel(
    T* __restrict__ vbasis,     // [B, nrows, N]
    T* __restrict__ valid,      // [B, nrows]
    const T* __restrict__ wblk, // [B, s, N]
    int nrows, int s, int N, int j0, int wmax) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int64_t lane = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int c0 = (int)((int64_t)rank * N / C);
  const int w = (int)((int64_t)(rank + 1) * N / C) - c0;
  const int nb = j0 + 1;
  const T brk = T(1e-30);

  double* part = (double*)smem;  // [2][kMaxProd]
  T* coef = (T*)(part + 2 * kMaxProd);
  T* Lf = coef + kMaxProd;
  T (*L)[kMaxS] = reinterpret_cast<T (*)[kMaxS]>(Lf);
  T* newv = Lf + kMaxS * kMaxS;
  T* vs = newv + kMaxS;
  T* data = (T*)(smem + orth_header_bytes(sizeof(T)));

  T* V = vbasis + lane * nrows * (int64_t)N;
  T* val = valid + lane * nrows;
  const T* W = wblk + lane * s * (int64_t)N;
  T* out = V + (int64_t)nb * N + c0;  // v_basis rows j0+1.., this slice
  Rows<T> vr, q, src;
  if (kResident) {
    for (int r = 0; r < nb + s; ++r) {
      const T* g = (r < nb ? V + (int64_t)r * N : W + (int64_t)(r - nb) * N) + c0;
      T* d = data + (int64_t)r * wmax;
      for (int k = tid; k < w; k += blockDim.x) cp_async(d + k, g + k);
    }
    vr = {data, wmax};
    q = {data + (int64_t)nb * wmax, wmax};
    src = q;
  } else {
    vr = {V + c0, N};
    q = {out, N};
    src = {const_cast<T*>(W) + c0, N};
  }
  for (int r = tid; r < nb; r += blockDim.x) vs[r] = val[r];
  if (tid < s) newv[tid] = T(1);
  if (kResident) cp_async_wait_all();
  __syncthreads();

  int buf = 0;
  // Two passes of q <- q - (q vb^T) vb, vb = the basis rows 0..j0 times valid.
  for (int pass = 0; pass < 2; ++pass) {
    slice_dots(src, s, vr, nb, (const T*)vs, w, part + buf * kMaxProd);
    cluster_sum(cluster, part + buf * kMaxProd, s * nb, coef);
    buf ^= 1;
    for (int k = tid; k < w; k += blockDim.x) {
      T t[kMaxS];
#pragma unroll
      for (int i = 0; i < kMaxS; ++i) t[i] = T(0);
      for (int r = 0; r < nb; ++r) {
        const T v = vr(r, k) * vs[r];
#pragma unroll
        for (int i = 0; i < kMaxS; ++i)
          if (i < s) t[i] += coef[i * nb + r] * v;
      }
#pragma unroll
      for (int i = 0; i < kMaxS; ++i)
        if (i < s) q(i, k) = src(i, k) - t[i];
    }
    src = q;
    __syncthreads();
  }

  // CholQR2: Gram, ridge-guarded Cholesky, triangular solve, twice.
  for (int pass = 0; pass < 2; ++pass) {
    slice_dots(q, s, q, s, (const T*)nullptr, w, part + buf * kMaxProd);
    cluster_sum(cluster, part + buf * kMaxProd, s * s, coef);
    buf ^= 1;
    if (tid == 0) {
      T dmax = coef[0];
      for (int i = 0; i < s; ++i) {
        const T d = coef[i * s + i];
        newv[i] = newv[i] * (d > brk ? T(1) : T(0));
        if (i > 0) dmax = nanmax(dmax, d);
      }
      const T ridge = nanmax(dmax, Lim<T>::tiny) * Lim<T>::eps * T(s) +
                      Lim<T>::tiny;
      cholesky_or_nan(coef, ridge, s, L);
    }
    __syncthreads();
    for (int k = tid; k < w; k += blockDim.x) {
      // Fully unrolled over kMaxS, so yv stays in registers.
      T yv[kMaxS];
#pragma unroll
      for (int i = 0; i < kMaxS; ++i) {
        if (i < s) {
          T a = q(i, k);
#pragma unroll
          for (int j = 0; j < i; ++j) a -= L[i][j] * yv[j];
          yv[i] = a / L[i][i];
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxS; ++i) {
        if (i >= s) continue;
        if (pass == 0) {
          q(i, k) = yv[i];
        } else {
          out[(int64_t)i * N + k] =
              (isfinite(yv[i]) ? yv[i] : T(0)) * newv[i];
        }
      }
    }
    __syncthreads();
  }
  if (rank == 0 && tid < s) val[nb + tid] = newv[tid];
  cluster.sync();  // no CTA leaves while another still reads its partials
}

// ---------------------------------------------------------------------------
// S4
// ---------------------------------------------------------------------------

constexpr int kLsqTile = 64;            // columns per staged tile of the H pass
constexpr int kLsqRows = kMaxCols + 1;  // rows of H: mr = mm + 1 <= 33
constexpr int kLsqPer = 5;              // H products of one thread: ceil(33 / 8)

template <typename T, int P>
struct alignas(sizeof(T) * P) Pack {
  T v[P];
};

// Row stride of a staged tile, in elements: padded so that 16-byte copies
// stay aligned and the 16 or 32 rows a warp reads at one column fall on
// different banks (two ways at most).
template <typename T>
__host__ __device__ constexpr int lstsq_stride() {
  return kLsqTile + 16 / (int)sizeof(T);
}

// Shared memory of the H pass: valid in the working dtype, then two tile
// stages of the mm + 1 rows of V and the mm rows of W.
template <typename T>
__host__ __device__ constexpr int lstsq_smem_bytes(int mm) {
  return (kLsqRows * (int)sizeof(T) + 15) / 16 * 16 +
         2 * (2 * mm + 1) * lstsq_stride<T>() * (int)sizeof(T);
}

// Copy 16 bytes global -> shared (both 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// H pass: CTA (blockIdx.x, lane blockIdx.y) of `ctas` per lane owns the
// tiles [r T / ctas, (r + 1) T / ctas) of kLsqTile columns, T = ceil(N /
// kLsqTile), and writes its float64 partials of H [mr, mm] to
// hpart[lane, r].  It streams its columns of V's mr rows and W's mm rows
// through two cp.async stages (16-byte copies when kVec: N and the bases
// aligned); thread t owns the products (i, c) with c = t mod mmp (mmp = mm
// rounded up to a power of two) and i = t / mmp + j 256 / mmp, summed in
// column order.  The products' shared-memory reads and float64
// arithmetic, not the loads, bound this pass, so its loops carry no
// branch that differs between the threads of a warp.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) lstsq_h_kernel(
    const T* __restrict__ vbasis,  // [B, mm+1, N]
    const T* __restrict__ valid,   // [B, mm+1]
    const T* __restrict__ wstore,  // [B, mm, N]
    double* __restrict__ hpart,    // [B, ctas, mm+1, mm]
    int mm, int N, int ntiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ctas = (int)gridDim.x, r = (int)blockIdx.x;
  const int64_t lane = blockIdx.y;
  const int tid = threadIdx.x;
  const int mr = mm + 1;
  const int tile0 = (int)((int64_t)r * ntiles / ctas);
  const int tile1 = (int)((int64_t)(r + 1) * ntiles / ctas);
  constexpr int stride = lstsq_stride<T>();
  constexpr int V = kVec ? 16 / (int)sizeof(T) : 1;
  T* vs = (T*)smem;
  T* stage = (T*)(smem + (kLsqRows * sizeof(T) + 15) / 16 * 16);
  const int rows = mr + mm;  // V's rows, then W's
  const int stage_elems = rows * stride;
  const T* Vb = vbasis + lane * mr * (int64_t)N;
  const T* Wb = wstore + lane * mm * (int64_t)N;

  auto load_tile = [&](int t, int st) {
    const int g0 = t * kLsqTile;
    const int tw = min(kLsqTile, N - g0);
    T* dst = stage + st * stage_elems;
    for (int e = tid; e < rows * (kLsqTile / V); e += blockDim.x) {
      const int row = e / (kLsqTile / V);
      const int kk = (e - row * (kLsqTile / V)) * V;
      if (kk < tw) {
        const T* src = (row < mr ? Vb + (int64_t)row * N
                                 : Wb + (int64_t)(row - mr) * N) + g0 + kk;
        if (kVec)
          cp_async16(dst + row * stride + kk, src);
        else
          cp_async(dst + row * stride + kk, src);
      }
    }
    cp_async_commit();
  };

  const int nt = tile1 - tile0;
  load_tile(tile0, 0);
  for (int i = tid; i < mr; i += blockDim.x) vs[i] = valid[lane * mr + i];
  int mmp = 1;
  while (mmp < mm) mmp <<= 1;
  const int groups = kThreads / mmp;
  const int pc = tid % mmp, pg = tid / mmp;
  const int pg0 = (tid & ~31) / mmp;  // the smallest pg of this warp
  const bool owner = pc < mm;
  double acc[kLsqPer];
  T vsc[kLsqPer];
#pragma unroll
  for (int j = 0; j < kLsqPer; ++j) acc[j] = 0.0;
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) {
      load_tile(tile0 + t + 1, (t + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {  // valid, written before the first barrier
#pragma unroll
      for (int j = 0; j < kLsqPer; ++j) {
        const int i = pg + groups * j;
        vsc[j] = i < mr ? vs[i] : T(0);
      }
    }
    const T* sv = stage + (t & 1) * stage_elems;
    const int tw = min(kLsqTile, N - (tile0 + t) * kLsqTile);
    if (owner) {
      // Row by row of this thread's products, so that whether a row
      // exists is decided once a tile and alike across the warp (a row
      // past mr is read clamped, with weight 0, by the threads of a warp
      // that has it for some of its threads); 16 bytes of a row per
      // shared-memory read, the columns in order, a ragged tail one by one.
      using Pk = Pack<T, 16 / sizeof(T)>;
      constexpr int P = 16 / sizeof(T);
      const T* wrow = sv + (mr + pc) * stride;
#pragma unroll
      for (int j = 0; j < kLsqPer; ++j) {
        if (pg0 + groups * j >= mr) break;
        const T* arow = sv + min(pg + groups * j, mr - 1) * stride;
        const T vj = vsc[j];
        double s = acc[j];
        int kk = 0;
        for (; kk + P <= tw; kk += P) {
          const Pk w = *reinterpret_cast<const Pk*>(wrow + kk);
          const Pk a = *reinterpret_cast<const Pk*>(arow + kk);
#pragma unroll
          for (int q = 0; q < P; ++q) s += (double)(a.v[q] * vj) * (double)w.v[q];
        }
        for (; kk < tw; ++kk) s += (double)(arow[kk] * vj) * (double)wrow[kk];
        acc[j] = s;
      }
    }
    __syncthreads();
  }
  if (owner) {
    double* out = hpart + (lane * ctas + r) * (int64_t)(mr * mm);
#pragma unroll
    for (int j = 0; j < kLsqPer; ++j) {
      const int i = pg + groups * j;
      if (i < mr) out[i * mm + pc] = acc[j];
    }
  }
}

// The least squares: one warp per lane (blockIdx.x).  H = the ctas
// partials added in order; then the SVD minimum-norm solution of min |beta
// e1 - H y| by one-sided Jacobi, column pairs in round-robin (circle)
// order: in round r, position k holds player 0 (k = 0) or 1 + (k - 1 + r)
// mod (nc - 1), and positions k and nc - 1 - k pair.  Lane c holds column
// c of A (H, a zero column padding an odd mm) and of the rotation matrix
// in registers (kRows >= mm + 1 rows, unrolled); a pair's lanes trade
// columns by shuffles and compute the same three dot products in row
// order, so both take identical rotations, and a round needs no barrier.
// Writes y (rounded to T), NaN for a non-finite H or beta.
template <typename T, int kRows>
__global__ void __launch_bounds__(32) lstsq_svd_kernel(
    const double* __restrict__ hpart,  // [B, ctas, mm+1, mm]
    const T* __restrict__ beta,        // [B]
    T* __restrict__ yout,              // [B, mm]
    int mm, int ctas) {
  constexpr int kCols = kRows - 1;
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ double vsh[kCols][kCols + 1];
  __shared__ double coef[kCols];
  const int64_t lane = blockIdx.x;
  const int ln = threadIdx.x;
  const int mr = mm + 1;
  const int nc = mm + (mm & 1);
  const double* hp = hpart + lane * ctas * (int64_t)(mr * mm);
  T* y = yout + lane * mm;
  double a[kRows];
  bool fin = true;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    double h = 0.0;
    if (i < mr && ln < mm) {
      for (int c = 0; c < ctas; ++c) h += hp[(int64_t)c * mr * mm + i * mm + ln];
      fin = fin && isfinite(h);
    }
    a[i] = h;
  }
  const T bet_t = beta[lane];
  if (__any_sync(kAll, !fin) || !isfinite(bet_t)) {
    if (ln < mm) y[ln] = quiet_nan<T>();
    return;
  }
  const double bet = (double)bet_t;
  double v[kCols];
#pragma unroll
  for (int r = 0; r < kCols; ++r) v[r] = r == ln ? 1.0 : 0.0;

  const double eps = Lim<double>::eps;
  // The last round's rotation of this lane's column (c, s, partner): V is
  // off the rounds' critical path, so it takes that rotation during the
  // next round's sums.  The first one is the identity.
  int vpartner = ln;
  double vc = 1.0, vs = 0.0;
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    bool rotated = false;
    for (int round = 0; round < nc - 1; ++round) {
      // This lane's position k in the round and its partner's; lanes
      // beyond nc pair with themselves and never rotate.
      int partner = ln;
      bool isp = true;
      if (ln < nc) {
        int q = ln - 1 - round;  // k = 1 + (ln - 1 - round) mod (nc - 1)
        if (q < 0) q += nc - 1;
        const int k = ln == 0 ? 0 : 1 + q;
        const int kp = nc - 1 - k;
        int qp = kp - 1 + round;  // player(kp, round)
        if (qp >= nc - 1) qp -= nc - 1;
        partner = kp == 0 ? 0 : 1 + qp;
        isp = k < nc / 2;
      }
      // Rows past mr are zero and add nothing: the loops run unguarded.
      double pa[kRows];
      double so = 0.0, sp = 0.0, g = 0.0;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pa[i] = __shfl_sync(kAll, a[i], partner);
        so += a[i] * a[i];
        sp += pa[i] * pa[i];
        g += a[i] * pa[i];
        if (i < kCols) {
          const double pv = __shfl_sync(kAll, v[i], vpartner);
          v[i] = fma(vs, pv, vc * v[i]);
        }
      }
      // alpha = |a_p|^2, beta = |a_q|^2, gamma = a_p . a_q: the same
      // sums in the same order in both lanes of the pair.
      const double al = isp ? so : sp, be = isp ? sp : so, ga = g;
      // gamma == 0 implies alpha or beta is 0; the square roots and
      // divisions below get only positive normal arguments, so no lane
      // takes their slow paths (and stalls the warp).  Each lane takes the
      // root of its own column's sum, which is bit for bit its partner's
      // other sum, and the two trade roots.
      const bool nz = ln < nc && ga != 0.0;
      const double rs = sqrt(so > 0.0 ? so : 1.0);
      const double rp = __shfl_sync(kAll, rs, partner);
      const bool rot = nz && fabs(ga) > eps * (isp ? rs : rp) * (isp ? rp : rs);
      const double zeta = (rot ? be - al : 0.0) / (2.0 * (rot ? ga : 1.0));
      const double t = (zeta >= 0.0 ? 1.0 : -1.0) /
                       (fabs(zeta) + sqrt(1.0 + zeta * zeta));
      const double cr = 1.0 / sqrt(1.0 + t * t);
      const double sn = cr * t;
      // Column p: c a_p - sn a_q; column q: sn a_p + c a_q.  No rotation:
      // c = 1, s = 0.
      const double c = rot ? cr : 1.0;
      const double sg = rot ? (isp ? -sn : sn) : 0.0;
      rotated = rotated || rot;
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = fma(sg, pa[i], c * a[i]);
      vpartner = partner;
      vc = c;
      vs = sg;
    }
    if (!__any_sync(kAll, rotated)) break;
  }
#pragma unroll
  for (int r = 0; r < kCols; ++r) {
    const double pv = __shfl_sync(kAll, v[r], vpartner);
    v[r] = fma(vs, pv, vc * v[r]);
  }

  // Singular values are the column norms; the solution keeps those above
  // jnp.linalg.lstsq's cutoff: y = sum_c V[:, c] (beta u[0, c]) / sigma_c.
  double s2 = 0.0;
#pragma unroll
  for (int i = 0; i < kRows; ++i) s2 += a[i] * a[i];
  const double sc = ln < mm ? sqrt(s2) : 0.0;
  double smax = sc;
  for (int off = 16; off > 0; off >>= 1)
    smax = fmax(smax, __shfl_xor_sync(kAll, smax, off));
  const double cut = double(Lim<T>::eps) * double(mr) * smax;  // working eps
  if (ln < mm) {
    coef[ln] = (sc > 0.0 && sc >= cut) ? (1.0 / sc) * ((a[0] / sc) * bet)
                                       : 0.0;
#pragma unroll
    for (int r = 0; r < kCols; ++r)
      if (r < mm) vsh[r][ln] = v[r];
  }
  __syncwarp();
  if (ln < mm) {
    double acc = 0.0;
    for (int c = 0; c < mm; ++c) acc += vsh[ln][c] * coef[c];
    y[ln] = (T)acc;
  }
}

// x = Z^T y: one thread per (column, lane), the mm terms in order.
template <typename T>
__global__ void __launch_bounds__(kThreads) lstsq_x_kernel(
    const T* __restrict__ zstore,  // [B, mm, N]
    const T* __restrict__ y,       // [B, mm]
    T* __restrict__ xout,          // [B, N]
    int mm, int N) {
  const int64_t lane = blockIdx.y;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= N) return;
  const T* z = zstore + lane * mm * (int64_t)N + k;
  const T* yl = y + lane * mm;
  T a = T(0);
#pragma unroll 8
  for (int c = 0; c < mm; ++c) a += z[(int64_t)c * N] * yl[c];
  xout[lane * (int64_t)N + k] = a;
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

inline unsigned blocks_for(int64_t total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

// Launch `kernel` on lanes * cluster CTAs in clusters of `cluster`, with
// `smem` bytes of dynamic shared memory.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int lanes, int cluster,
                    int smem, cudaStream_t stream, Args... args) {
  cudaError_t err;
  if (smem > 48 * 1024) {  // above 48 KB a kernel has to opt in, per device
    static bool opted[64] = {};
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64 || !opted[dev]) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) return (int)err;
      if (dev < 64) opted[dev] = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(lanes * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// S1's modes (sparse_kernels.FULL, VALUES_F32, RESIDUAL).
constexpr int kFullMode = 0, kValuesF32Mode = 1, kResidualMode = 2;

// One launch in every mode.  ev and bv are T, or float in VALUES_F32 (T
// double); in RESIDUAL they are P and Q [lanes, n].
template <typename T, bool kStatus>
int launch_assemble_as(const T* x, const T* ps, const T* qs,
                       const T* th_free, const T* v_free, const T* v_set,
                       const T* inc_g, const T* inc_b, const T* g_d,
                       const T* b_d, const int* inc_ptr, const int* inc_code,
                       const int* inc_nbr, const T* status, const T* inc_gs,
                       const T* inc_bs, const T* g_sh, const T* b_sh,
                       void* ev, void* bv, T* f, int lanes, int n, int m,
                       int mode, cudaStream_t stream) {
  const unsigned tiles =
      (unsigned)((int64_t)lanes * ((n + kTileBuses - 1) / kTileBuses));
#define S1_ARGS                                                              \
  x, ps, qs, th_free, v_free, v_set, inc_g, inc_b, g_d, b_d, inc_ptr,       \
      inc_code, inc_nbr, status, inc_gs, inc_bs, g_sh, b_sh
  if (mode == kFullMode)
    assemble_kernel<T, T, kStatus><<<tiles, kTileEntries, 0, stream>>>(
        S1_ARGS, (T*)ev, (T*)bv, f, lanes, n, m);
  else if (mode == kValuesF32Mode && sizeof(T) == 8)
    assemble_kernel<T, float, kStatus><<<tiles, kTileEntries, 0, stream>>>(
        S1_ARGS, (float*)ev, (float*)bv, f, lanes, n, m);
  else if (mode == kResidualMode)
    residual_kernel<T, kStatus><<<blocks_for((int64_t)lanes * n), kThreads,
                                  0, stream>>>(S1_ARGS, (T*)ev, (T*)bv, f,
                                               lanes, n, m);
  else
    return (int)cudaErrorInvalidValue;
#undef S1_ARGS
  return (int)cudaGetLastError();
}

// status [lanes, m] or null (every branch in service: the stored diagonal).
template <typename T>
int launch_assemble(const T* x, const T* ps, const T* qs, const T* th_free,
                    const T* v_free, const T* v_set, const T* inc_g,
                    const T* inc_b, const T* g_d, const T* b_d,
                    const int* inc_ptr, const int* inc_code,
                    const int* inc_nbr, const T* status, const T* inc_gs,
                    const T* inc_bs, const T* g_sh, const T* b_sh, void* ev,
                    void* bv, T* f, int lanes, int n, int m, int mode,
                    cudaStream_t stream) {
  if (lanes <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  return status == nullptr
             ? launch_assemble_as<T, false>(
                   x, ps, qs, th_free, v_free, v_set, inc_g, inc_b, g_d, b_d,
                   inc_ptr, inc_code, inc_nbr, status, inc_gs, inc_bs, g_sh,
                   b_sh, ev, bv, f, lanes, n, m, mode, stream)
             : launch_assemble_as<T, true>(
                   x, ps, qs, th_free, v_free, v_set, inc_g, inc_b, g_d, b_d,
                   inc_ptr, inc_code, inc_nbr, status, inc_gs, inc_bs, g_sh,
                   b_sh, ev, bv, f, lanes, n, m, mode, stream);
}

template <typename T>
int launch_matvec(const T* ev, const T* bv, const T* u, const T* th_free,
                  const T* v_free, const int* inc_ptr, const int* inc_nbr,
                  T* y, int lanes, int n, int m, cudaStream_t stream) {
  if (lanes <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  matvec_kernel<T><<<blocks_for((int64_t)lanes * n), kThreads, 0, stream>>>(
      ev, bv, u, th_free, v_free, inc_ptr, inc_nbr, y, lanes, n, m);
  return (int)cudaGetLastError();
}

// The plan (cluster, wmax, smem, resident) comes from the wrapper's
// block_orth_plan; it is checked here against what the kernel needs.
template <typename T>
int launch_block_orth(T* vbasis, T* valid, const T* wblk, int lanes,
                      int nrows, int s, int N, int j0, int cluster, int wmax,
                      int smem, int resident, cudaStream_t stream) {
  const int64_t need =
      orth_header_bytes(sizeof(T)) +
      (resident ? (int64_t)(j0 + 1 + s) * wmax * (int64_t)sizeof(T) : 0);
  if (lanes <= 0 || N <= 0 || s < 1 || s > kMaxS || j0 < 0 ||
      j0 + 1 + s > nrows || nrows > kOrthRows || s * (j0 + 1) > kMaxProd ||
      cluster < 1 || cluster > kMaxCluster || cluster > N ||
      (int64_t)wmax * cluster < N || smem < need || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (resident)
    return launch_clusters(block_orth_kernel<T, true>, lanes, cluster, smem,
                           stream, vbasis, valid, wblk, nrows, s, N, j0, wmax);
  return launch_clusters(block_orth_kernel<T, false>, lanes, cluster, smem,
                         stream, vbasis, valid, wblk, nrows, s, N, j0, wmax);
}

// The plan (ctas, smem) comes from the wrapper's lstsq_plan; it is checked
// here against what the kernels need.  hpart is [lanes, ctas, mm+1, mm]
// float64 scratch, y [lanes, mm].
template <typename T>
int launch_lstsq(const T* vbasis, const T* valid, const T* wstore,
                 const T* zstore, const T* beta, T* x, double* hpart, T* y,
                 int lanes, int mm, int N, int ctas, int smem,
                 cudaStream_t stream) {
  if (lanes <= 0 || lanes > 65535 || N <= 0 || mm < 1 || mm > kMaxCols)
    return (int)cudaErrorInvalidValue;
  const int ntiles = (N + kLsqTile - 1) / kLsqTile;
  if (ctas < 1 || ctas > ntiles || smem != lstsq_smem_bytes<T>(mm) ||
      smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const bool vec = N % (16 / (int)sizeof(T)) == 0 &&
                   ((uintptr_t)vbasis | (uintptr_t)wstore) % 16 == 0;
  void (*hk)(const T*, const T*, const T*, double*, int, int, int) =
      vec ? lstsq_h_kernel<T, true> : lstsq_h_kernel<T, false>;
  cudaError_t err;
  if (smem > 48 * 1024) {  // above 48 KB a kernel has to opt in
    err = cudaFuncSetAttribute(hk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  hk<<<dim3((unsigned)ctas, (unsigned)lanes), kThreads, smem, stream>>>(
      vbasis, valid, wstore, hpart, mm, N, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (mm <= 16)
    lstsq_svd_kernel<T, 17><<<lanes, 32, 0, stream>>>(hpart, beta, y, mm, ctas);
  else
    lstsq_svd_kernel<T, 33><<<lanes, 32, 0, stream>>>(hpart, beta, y, mm, ctas);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lstsq_x_kernel<T><<<dim3((unsigned)((N + kThreads - 1) / kThreads),
                           (unsigned)lanes), kThreads, 0, stream>>>(
      zstore, y, x, mm, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer to a
// contiguous tensor; index arrays are int32; `stream` is the caller's CUDA
// stream.  Each returns the cudaError_t of its launches.
#define SPARSE_ENTRY_POINTS(T, SUFFIX)                                         \
  extern "C" int sparse_assemble_##SUFFIX(                                    \
      const T* x, const T* ps, const T* qs, const T* th_free,                \
      const T* v_free, const T* v_set, const T* inc_g, const T* inc_b,       \
      const T* g_d, const T* b_d, const int* inc_ptr, const int* inc_code,   \
      const int* inc_nbr, const T* status, const T* inc_gs, const T* inc_bs, \
      const T* g_sh, const T* b_sh, void* ev, void* bv, T* f, int lanes,     \
      int n, int m, int mode, void* stream) {                                \
    return launch_assemble<T>(x, ps, qs, th_free, v_free, v_set, inc_g,      \
                              inc_b, g_d, b_d, inc_ptr, inc_code, inc_nbr,   \
                              status, inc_gs, inc_bs, g_sh, b_sh, ev, bv, f, \
                              lanes, n, m, mode, (cudaStream_t)stream);      \
  }                                                                          \
  extern "C" int sparse_matvec_##SUFFIX(                                      \
      const T* ev, const T* bv, const T* u, const T* th_free,                \
      const T* v_free, const int* inc_ptr, const int* inc_nbr, T* y,         \
      int lanes, int n, int m, void* stream) {                               \
    return launch_matvec<T>(ev, bv, u, th_free, v_free, inc_ptr, inc_nbr, y, \
                            lanes, n, m, (cudaStream_t)stream);              \
  }                                                                          \
  extern "C" int gmres_block_orth_##SUFFIX(                                   \
      T* vbasis, T* valid, const T* wblk, int lanes, int nrows, int s, int N, \
      int j0, int cluster, int wmax, int smem, int resident, void* stream) { \
    return launch_block_orth<T>(vbasis, valid, wblk, lanes, nrows, s, N, j0, \
                                cluster, wmax, smem, resident,               \
                                (cudaStream_t)stream);                       \
  }                                                                          \
  extern "C" int gmres_lstsq_##SUFFIX(                                        \
      const T* vbasis, const T* valid, const T* wstore, const T* zstore,     \
      const T* beta, T* x, double* hpart, T* y, int lanes, int mm, int N,    \
      int ctas, int smem, void* stream) {                                    \
    return launch_lstsq<T>(vbasis, valid, wstore, zstore, beta, x, hpart, y, \
                           lanes, mm, N, ctas, smem, (cudaStream_t)stream);  \
  }

SPARSE_ENTRY_POINTS(double, f64)
SPARSE_ENTRY_POINTS(float, f32)
