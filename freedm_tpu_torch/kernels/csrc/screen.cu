// N-1 and DC screening kernels for Hopper (sm_90a), float64.
//
// N1 smw_screen — replaces the XLA program of freedm_tpu/pf/n1.py:340
//   `_make_smw_n1_screen`: the whole `_solve_lane` scan (:407-464, the scan
//   at :450) with its base triangular solves.  One launch runs, for every
//   outage lane (branch k out) of a call,
//
//       theta = 0, v = flat;  dp = mismatch(theta, v).dp
//       max_iter times:
//           theta += smw_p(dp) th_free;   dq = mismatch(theta, v).dq
//           v     += smw_q(dq) v_free;    dp, dq = mismatch(theta, v)
//       P, Q = injections(theta, v);  err = max(max |dp v|, max |dq v|)
//
//   with smw(b) = x0 - ZM_k c, c = cap_k^-1 (x0[f_k], x0[t_k]) mask_k and
//   x0 = A^-1 b = U^-1 L^-1 P^T b over the base B' (B'') LU pair, and
//   mismatch(theta, v) = ((p_s - P) / v th_free, (q_s - Q) / v v_free), P
//   and Q the branch-wise injections of freedm_tpu/pf/mfree.py:34 with
//   branch k out of service.  No host read and no library call in between.
//
// D1 dc_screen — replaces freedm_tpu/pf/dc.py:145 `_screen_impl` (mode
//   SCREEN) and the flows of `_solve_impl` (:131-139, mode SOLVE).  SCREEN,
//   per outage lane l (branch k): from theta0 = B'^-1 p and
//   z_l = B'^-1 a_k (a_k = e_f mask_f - e_t mask_t), Sherman-Morrison
//   theta_l = theta0 + (w_k a.theta0 / den) z_l with den = 1 - w_k a.z_l,
//   islanded = |den| < 1e-6 (den taken as 1 there), the flows
//   (theta_l[f] - theta_l[t]) w of every branch with branch k's set to 0,
//   and severity = max |flow| (+inf where islanded).  SOLVE: the flows of
//   [L, n] angle lanes.
//
// Design of N1 (screen_kernels.smw_plan, a function of n alone).  A CTA of
//   384 threads owns LB lanes (two where they fit, else one); the last
//   CTA's spare slots repeat the last lane, so a lane's arithmetic never
//   depends on the batch or the plan.  Past one lane's fit (n > 2880) the
//   spill route keeps two lanes' vectors in global memory, a slice of a
//   work buffer a CTA, and only the tiles in shared memory.
//   - Triangular solves.  The right-hand sides of the CTA's lanes sit in
//     shared memory (on the spill route in global memory), row-major
//     [rows][LB], as P^T b: the mismatch pass
//     writes bus i's value to row pinv[i].  The factors are lu_factor's
//     LAPACK column-major layout (leading dimension lda,
//     cache_kernels.kernel_factor), cut into 64-column blocks.  Forward with
//     the unit-lower L block by block: the diagonal block is solved by one
//     warp a lane in sub-blocks of 4 columns from one batch of shuffles
//     (C1's scheme), then a thread a row applies the block's 64 columns to
//     all LB lanes from registers, each factor value read once a CTA.  With
//     a look-ahead: the rows of block k + 1 take block k's columns first,
//     then block k + 1 is solved while the other warps apply block k to the
//     rows below.  Backward with U the same way from the last block up.
//     The diagonal tiles are staged in shared memory by cp.async, the next
//     one's copy in flight; the panels are read from global memory with an
//     L2 evict-last policy, so the pair (2 x 2.1 MB at 511 buses) stays in
//     the 50 MB L2 across all 2 max_iter solves.  At n <= 64 each factor is
//     one tile, and both are staged once for the launch.
//   - Rounding of the substitution (C1's, whose diagonal-block code
//     lu_subst.cuh shares; cache_kernels.lu_solve_mirror is its host
//     yardstick): every row takes its updates one column at a time in
//     column order (ascending for L, descending for U), each as one fma,
//     and x_c = b_c / u_cc correctly rounded (Markstein's correction of b_c
//     times the rounded reciprocal).  No inverse is formed.
//   - The SMW correction and the mismatch passes keep the explicitly
//     rounded arithmetic of the per-mode kernel this one replaced: the 2 x 2
//     capacitance solve is LAPACK's getrf/getrs, run by one thread a lane;
//     P and Q walk a bus's incidence list in order (from-end edges, then
//     to-end edges, each ascending), as the plain version's two segment
//     sums.  Given the same x0, dp, dq, P and Q are that kernel's bits.  A
//     lane's theta, v and rotated voltages live beside its right-hand side
//     (a (bus, lane) is always handled by the same thread), the answer is
//     written once; err is a max, taken by an integer atomic on the non-negative
//     doubles' bits (the same value in any order).  No floating-point
//     atomics: every result is the same bits on every run, batch width,
//     plan and route.
//   - Where the time goes (clock64 stamps of lab copies on an H100): a
//     lane's solves are chains of dependent multiply-adds and shuffles,
//     ~80-120 cycles a column in the diagonal blocks (a warp; more lanes a
//     CTA only contend for the SM, hence two), then the panels' L2 reads;
//     the passes between the solves are a tenth at 511 buses, four in ten
//     at 30.  384 threads a CTA keep the registers from spilling (512 cap
//     them at 128: 3-4% slower at case_ieee30 and mesh118, even at mesh511).
//
// Design of D1: one CTA a lane, theta_l in shared memory, then a thread per
//   branch for the flows; the lane's max |flow| is a per-thread max in
//   branch order, then a fixed shuffle tree, then the warps in order.
//
// Bounds on an H100 SXM (3.35 TB/s; fp64 67 TFLOP/s on the tensor cores,
//   34 TFLOP/s outside them).  N1 at mesh511 x 256 lanes, 24 iterations:
//   the substitutions are 2 n^2 flops a lane and solve, 6.4 GFLOP, which
//   the tensor cores could run as tile products in 0.096 ms, and the
//   correction and mismatch passes 1.8 GFLOP on the FMA pipe, 0.053 ms:
//   0.149 ms; the pair read once is 4.2 MB, 1.3 us: operations.  The
//   design is bound by each lane's chain of dependent steps instead (4.5 ms
//   on an H100).  D1 SCREEN at mesh2000 x 1024 lanes reads z (16 MB) and
//   writes theta (16 MB) and the flows (32 MB): ~64 MB, 19 us.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lu_subst.cuh"

namespace {

constexpr int kThreads = 256;  // D1
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // shared memory a block may use on Hopper
constexpr unsigned kFull = 0xffffffffu;

// N1's CTA (screen_kernels.SCREEN_THREADS reads it: keep it a
// `constexpr int name = value;`), its tiles and the most lanes a CTA owns
// (a warp each in a diagonal block; screen_kernels.SMW_MAX_LANES).
constexpr int kScreenThreads = 384;
constexpr int kTile = 64;
// Columns a diagonal sub-block solves in registers: L's and U's.
constexpr int kSubF = 4;
constexpr int kSubB = 4;
constexpr int kMaxLanes = 2;
// Shared memory N1 leaves for its static arrays
// (screen_kernels.SMW_STATIC reads it).
constexpr int kScreenStatic = 4096;

// N1's mismatch passes: dp into B''s right-hand side, dq into B'''s, or
// the answer's P, Q and err.
constexpr int kDp = 0, kDq = 1, kFin = 2;
// D1's modes (screen_kernels.SCREEN, SOLVE).
constexpr int kScreen = 0, kSolve = 1;

// The reference's island threshold on the Sherman-Morrison denominator
// (freedm_tpu/pf/dc.py `_ISLAND_EPS`).
constexpr double kIslandEps = 1e-6;

// Arithmetic with explicit rounding (no contraction into fma), as the
// plain versions' elementwise PyTorch operations round (mul_rn, fnma and
// the substitution's quot come from lu_subst.cuh).
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// jnp.maximum: NaN if either operand is NaN.
__device__ __forceinline__ double nanmax(double a, double b) {
  if (a != a || b != b) return a + b;
  return a > b ? a : b;
}

// The CTA's max of one value a thread: a fixed shuffle tree per warp, then
// warp 0 over the warps in order.  Every thread gets the result.
__device__ double block_max(double x, double* s_red) {
  for (int o = 16; o > 0; o >>= 1) x = nanmax(x, __shfl_down_sync(kFull, x, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) s_red[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    double r = s_red[0];
    for (int w = 1; w < kWarps; ++w) r = nanmax(r, s_red[w]);
    s_red[kWarps] = r;
  }
  __syncthreads();
  return s_red[kWarps];
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously, under the L2 policy `pol`;
// with `bytes` 0 the 16 bytes are zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes,
                                           uint64_t pol) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "l"(pol)
      : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A read-only double under the L2 policy `pol`.
__device__ __forceinline__ double ld_keep(const double* p, uint64_t pol) {
  double v;
  asm("ld.global.nc.L2::cache_hint.f64 %0, [%1], %2;\n" : "=d"(v) : "l"(p), "l"(pol));
  return v;
}

// ---------------------------------------------------------------------------
// N1
// ---------------------------------------------------------------------------

struct ScreenArgs {
  const int64_t* ks;     // [lanes] outaged branch of each lane slot
  double* theta;         // [lanes, n] the lanes' state, then their answer
  double* v;
  double* p_out;         // [lanes, n]
  double* q_out;
  double* err;           // [lanes]
  const double* lu[2];   // B' and B'' LU factors: (r, c) at lu[c * lda + r]
  const int* pinv[2];    // the pivots' inverse permutations: row pinv[i] of
                         //   P^T b is b[i]
  const double* rdiag[2];  // 1 / u_cc [n], rounded to nearest
  const int* inc_ptr;    // [n + 1] incidence list (CSR)
  const int* inc_code;   // [2m] 2 edge + side
  const int* inc_nbr;    // [2m] the edge's other end
  const double* y;       // [8, m] yff, yft, ytf, ytt as (re, im)
  const double* g_sh;    // [n]
  const double* b_sh;
  const double* th_free;
  const double* v_free;
  const double* v_set;
  const double* p_sched;
  const double* q_sched;
  const int64_t* f;      // [m] branch ends
  const int64_t* t;
  const double* mask;    // [2, m, 2] endpoint masks of the B' and B'' updates
  const double* zm;      // [2, m, n, 2] A^-1 U of each branch, branch-major
  const double* cap;     // [2, m, 2, 2] I + P^T A^-1 U
  double* work;          // the spill route's lane vectors, smw_work a CTA
  int n, m, lda, max_iter;
};

// The lane vectors of one CTA of LB lanes, in doubles (screen_kernels.
// smw_work): the right-hand sides [rows][LB] (rows: n rounded up to the
// tile), the lanes' theta, v and rotated voltages' re and im [n][LB] each,
// and both factors' 1 / u_cc [2][rows].
__host__ __device__ inline size_t smw_work(int n, int lb) {
  const int rows = (n + kTile - 1) / kTile * kTile;
  return (size_t)lb * (rows + 4 * (size_t)n) + 2 * (size_t)rows;
}

// Dynamic shared memory of one CTA (screen_kernels.smw_smem): two 64 x 64
// tiles, then the lane vectors, which the spill route keeps in global
// memory instead.
__host__ __device__ inline size_t smw_smem(int n, int lb, bool spill) {
  return (2 * (size_t)kTile * kTile + (spill ? 0 : smw_work(n, lb))) *
         sizeof(double);
}

// c = A^-1 b for the 2 x 2 A (row-major), as LAPACK's getrf (partial
// pivoting: rows swap only where |a10| > |a00|; the multiplier times the
// pivot's reciprocal) and getrs (unit-lower forward, then upper back
// substitution with divisions) compute it.
__device__ void solve2(const double* a, double b0, double b1, double* c0,
                       double* c1) {
  double a00 = a[0], a01 = a[1], a10 = a[2], a11 = a[3];
  if (fabs(a10) > fabs(a00)) {
    double s = a00; a00 = a10; a10 = s;
    s = a01; a01 = a11; a11 = s;
    s = b0; b0 = b1; b1 = s;
  }
  const double l = mul_rn(a10, div_rn(1.0, a00));
  const double u11 = sub_rn(a11, mul_rn(l, a01));
  const double y1 = sub_rn(b1, mul_rn(b0, l));
  const double x1 = div_rn(y1, u11);
  *c1 = x1;
  *c0 = div_rn(sub_rn(b0, mul_rn(x1, a01)), a00);
}

// P and Q of bus i of one lane with branch `out` out of service, from the
// lane's V e^{j theta} (vre[j * LB], vim[j * LB]): the side's own admittance
// times V_i plus the mutual one times V_j, s = V_i conj(i), from-end and
// to-end terms summed apart in list order (mfree.py's two segment sums),
// then the shunt.
template <int LB>
__device__ __forceinline__ void bus_pq(const ScreenArgs& a, const double* vre,
                                       const double* vim, double vi, int i,
                                       int out, double* p, double* q) {
  const double vre_i = vre[i * LB], vim_i = vim[i * LB];
  double pf = 0.0, pt = 0.0, qf = 0.0, qt = 0.0;
  const int m = a.m;
  const int r1 = __ldg(a.inc_ptr + i + 1);
  for (int r = __ldg(a.inc_ptr + i); r < r1; ++r) {
    const int code = __ldg(a.inc_code + r);
    const int e = code >> 1;
    if (e == out) continue;  // its admittances are zero in this lane
    const bool to_side = code & 1;
    const int j = __ldg(a.inc_nbr + r);
    const double vre_j = vre[j * LB], vim_j = vim[j * LB];
    const double ys_re = __ldg(a.y + (to_side ? 6 : 0) * (int64_t)m + e);
    const double ys_im = __ldg(a.y + (to_side ? 7 : 1) * (int64_t)m + e);
    const double ym_re = __ldg(a.y + (to_side ? 4 : 2) * (int64_t)m + e);
    const double ym_im = __ldg(a.y + (to_side ? 5 : 3) * (int64_t)m + e);
    const double i_re = add_rn(sub_rn(mul_rn(ys_re, vre_i), mul_rn(ys_im, vim_i)),
                               sub_rn(mul_rn(ym_re, vre_j), mul_rn(ym_im, vim_j)));
    const double i_im = add_rn(add_rn(mul_rn(ys_re, vim_i), mul_rn(ys_im, vre_i)),
                               add_rn(mul_rn(ym_re, vim_j), mul_rn(ym_im, vre_j)));
    const double s_re = add_rn(mul_rn(vre_i, i_re), mul_rn(vim_i, i_im));
    const double s_im = sub_rn(mul_rn(vim_i, i_re), mul_rn(vre_i, i_im));
    if (to_side) {
      pt = add_rn(pt, s_re);
      qt = add_rn(qt, s_im);
    } else {
      pf = add_rn(pf, s_re);
      qf = add_rn(qf, s_im);
    }
  }
  const double v2 = mul_rn(vi, vi);
  *p = add_rn(add_rn(pf, pt), mul_rn(__ldg(a.g_sh + i), v2));
  *q = sub_rn(add_rn(qf, qt), mul_rn(__ldg(a.b_sh + i), v2));
}

// Factor values a panel thread loads at once (one row's); the next
// batch's loads are issued before this one's multiply-adds.
constexpr int kPanelBatch = 8;

// The whole screen for the CTA's LB lanes.  kWhole: n <= 64, each factor
// one tile, both staged once.  kSpill: the lane vectors in the CTA's part
// of a.work (global memory, which L1 and L2 hold) where they do not fit
// the shared memory; the same arithmetic in the same order.
template <int LB, bool kWhole, bool kSpill>
__global__ void __launch_bounds__(kScreenThreads, 1)
    smw_screen_kernel(const __grid_constant__ ScreenArgs a) {
  constexpr int kU = kPanelBatch;
  constexpr int kTT = kTile * kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, m = a.m;
  const int64_t lda = a.lda;
  const int nb = (n + kTile - 1) / kTile, rows = nb * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  double* tiles = reinterpret_cast<double*>(smem);  // [2][64 * 64], column-major
  double* b = kSpill ? a.work + blockIdx.x * smw_work(n, LB)
                     : tiles + 2 * kTT;  // [rows][LB]
  double* th = b + (size_t)rows * LB;    // [n][LB]
  double* vv = th + (size_t)n * LB;
  double* vre = vv + (size_t)n * LB;
  double* vim = vre + (size_t)n * LB;
  double* rd = vim + (size_t)n * LB;     // [2][rows]
  // The lanes' outage, its branch ends, masks and capacitances by half.
  __shared__ int s_k[kMaxLanes], s_f[kMaxLanes], s_t[kMaxLanes];
  __shared__ double s_mk[2][kMaxLanes][2], s_cap[2][kMaxLanes][4];
  __shared__ double s_c[kMaxLanes][2];
  __shared__ unsigned long long s_err[kMaxLanes];
  const int64_t lane0 = (int64_t)blockIdx.x * LB;
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(pol));

  if (tid < LB) {
    const int k = (int)a.ks[lane0 + tid];
    s_k[tid] = k;
    s_f[tid] = (int)a.f[k];
    s_t[tid] = (int)a.t[k];
    for (int h = 0; h < 2; ++h) {
      for (int q = 0; q < 2; ++q) s_mk[h][tid][q] = a.mask[((int64_t)h * m + k) * 2 + q];
      for (int q = 0; q < 4; ++q) s_cap[h][tid][q] = a.cap[((int64_t)h * m + k) * 4 + q];
    }
    s_err[tid] = 0ull;
  }
  for (int p = tid; p < rows * LB; p += kScreenThreads) b[p] = 0.0;
  for (int p = tid; p < 2 * rows; p += kScreenThreads) {
    const int h = p / rows, i = p % rows;
    rd[p] = i < n ? a.rdiag[h][i] : 1.0;
  }
  if (kWhole) {
    for (int p = tid; p < 2 * kTT; p += kScreenThreads) {
      const int h = p / kTT, c = (p % kTT) / kTile, r = p % kTile;
      tiles[p] = (r < n && c < n) ? a.lu[h][c * lda + r] : 0.0;
    }
  }

  // Diagonal tile (k, k) of factor h into tile buffer `buf`, zeros past n.
  auto stage = [&](int h, int k, int buf) {
    const double* src = a.lu[h];
    double* dst = tiles + buf * kTT;
    const int base = k * kTile;
    for (int q = tid; q < kTT / 2; q += kScreenThreads) {
      const int c = q / (kTile / 2), r = 2 * (q % (kTile / 2));
      const bool in = base + c < n && base + r < n;
      cp_async16(dst + c * kTile + r,
                 in ? src + (base + c) * lda + base + r : src, in ? 16 : 0, pol);
    }
    cp_async_commit();
  };
  // Block k of L, then of U: a warp per lane (lu_subst.cuh), in
  // sub-blocks of kSubF and kSubB columns, on the rows below n.
  auto diag_fwd = [&](const double* T, int k) {
    if (warp < LB)
      lu_diag_fwd<double, kSubF, LB>(T, b + (size_t)k * kTile * LB + warp,
                                     min(kTile, n - k * kTile), lane);
  };
  auto diag_bwd = [&](const double* T, int k, const double* rdk) {
    if (warp < LB)
      lu_diag_bwd<double, kSubB, LB>(T, b + (size_t)k * kTile * LB + warp,
                                     rdk, min(kTile, n - k * kTile), lane);
  };
  // Row r's LB lanes take the block's nc columns starting at c0 in the
  // direction dir (1: ascending from c0, -1: descending from c0 + nc - 1),
  // each factor value read once; the next batch's loads are in flight
  // during this one's multiply-adds.
  auto panel_row = [&](const double* lu, int r, int c0, int nc, int dir) {
    double acc[LB], av[kU], an[kU];
#pragma unroll
    for (int l = 0; l < LB; ++l) acc[l] = b[r * LB + l];
    const int first = dir > 0 ? c0 : c0 + nc - 1;
    const double* col = lu + first * lda + r;
    const int64_t step = dir * lda;
    const int full = nc / kU * kU;
    if (full > 0) {
#pragma unroll
      for (int u = 0; u < kU; ++u) av[u] = ld_keep(col + u * step, pol);
    }
    for (int t = 0; t < full; t += kU) {
      if (t + kU < full) {
#pragma unroll
        for (int u = 0; u < kU; ++u) an[u] = ld_keep(col + (t + kU + u) * step, pol);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const double* x = b + (first + dir * (t + u)) * LB;
#pragma unroll
        for (int l = 0; l < LB; ++l) acc[l] = fnma(av[u], x[l], acc[l]);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) av[u] = an[u];
    }
    for (int t = full; t < nc; ++t) {
      const double v = ld_keep(col + t * step, pol);
      const double* x = b + (first + dir * t) * LB;
#pragma unroll
      for (int l = 0; l < LB; ++l) acc[l] = fnma(v, x[l], acc[l]);
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) b[r * LB + l] = acc[l];
  };
  // x = U^-1 L^-1 P^T rhs for the CTA's lanes, with factor h: in place.
  // Forward, block by block with a look-ahead: once block k is solved, the
  // rows of block k + 1 take its 64 columns (a thread a row), then block
  // k + 1 is solved by the first LB warps while the other warps apply
  // block k to the rows below block k + 1.  Backward the same way from the
  // last block up.  Each row thus takes the blocks' columns in the same
  // order as without the look-ahead.
  auto solve = [&](int h) {
    const double* lu = a.lu[h];
    const double* rdh = rd + h * rows;
    const int rest0 = kScreenThreads - 32 * LB, rest = tid - 32 * LB;
    auto tile = [&](int k) { return tiles + (kWhole ? h : (k & 1)) * kTT; };
    for (int p = n * LB + tid; p < rows * LB; p += kScreenThreads) b[p] = 0.0;
    if (!kWhole) {
      stage(h, 0, 0);
      cp_async_wait_all();
    }
    __syncthreads();
    if (!kWhole && nb > 1) stage(h, 1, 1);
    diag_fwd(tile(0), 0);
    __syncthreads();
    for (int k = 0; k + 1 < nb; ++k) {
      const int r1 = (k + 1) * kTile + tid;
      if (tid < kTile && r1 < n) panel_row(lu, r1, k * kTile, kTile, 1);
      if (!kWhole) cp_async_wait_all();
      __syncthreads();
      if (!kWhole && k + 2 < nb) stage(h, k + 2, k & 1);
      if (warp < LB) {
        diag_fwd(tile(k + 1), k + 1);
      } else {
        for (int r = (k + 2) * kTile + rest; r < n; r += rest0)
          panel_row(lu, r, k * kTile, kTile, 1);
      }
      __syncthreads();
    }
    // Tiles (nb - 1, nb - 1) and (nb - 2, nb - 2) are still in their
    // buffers, (nb - 1) & 1 and (nb - 2) & 1.
    diag_bwd(tile(nb - 1), nb - 1, rdh + (nb - 1) * kTile);
    __syncthreads();
    for (int k = nb - 1; k >= 1; --k) {
      const int nc = min(kTile, n - k * kTile);
      if (tid < kTile) panel_row(lu, (k - 1) * kTile + tid, k * kTile, nc, -1);
      if (!kWhole) cp_async_wait_all();
      __syncthreads();
      if (!kWhole && k >= 2) stage(h, k - 2, k & 1);
      if (warp < LB) {
        diag_bwd(tile(k - 1), k - 1, rdh + (k - 1) * kTile);
      } else {
        for (int r = rest; r < (k - 1) * kTile; r += rest0)
          panel_row(lu, r, k * kTile, nc, -1);
      }
      __syncthreads();
    }
  };
  // theta (h 0) or v (h 1) += smw(x) mask, x the solve's answer in b; the
  // rotated voltages at the new state.
  auto correct = [&](int h) {
    if (tid < LB) {
      const double g0 = mul_rn(b[s_f[tid] * LB + tid], s_mk[h][tid][0]);
      const double g1 = mul_rn(b[s_t[tid] * LB + tid], s_mk[h][tid][1]);
      solve2(s_cap[h][tid], g0, g1, &s_c[tid][0], &s_c[tid][1]);
    }
    __syncthreads();
    const double* free = h == 0 ? a.th_free : a.v_free;
    double* half = h == 0 ? th : vv;
    for (int u = tid; u < n * LB; u += kScreenThreads) {
      const int i = u / LB, l = u % LB;
      const double2 z = __ldg(reinterpret_cast<const double2*>(
          a.zm + (((int64_t)h * m + s_k[l]) * n + i) * 2));
      const double zc = add_rn(mul_rn(z.x, s_c[l][0]), mul_rn(z.y, s_c[l][1]));
      const double d = sub_rn(b[u], zc);
      half[u] = add_rn(half[u], mul_rn(d, __ldg(free + i)));
      double si, ci;
      sincos(th[u], &si, &ci);
      vre[u] = mul_rn(vv[u], ci);
      vim[u] = mul_rn(vv[u], si);
    }
    __syncthreads();
  };
  // dp (kDp) or dq (kDq) into row pinv[i] of the next solve's right-hand
  // side, or (kFin) the answer: theta, v, P, Q and the lanes' err.
  auto mismatch = [&](int mode) {
    for (int u = tid; u < n * LB; u += kScreenThreads) {
      const int i = u / LB, l = u % LB;
      const double vi = vv[u];
      double p, q;
      bus_pq<LB>(a, vre + l, vim + l, vi, i, s_k[l], &p, &q);
      const double dp = mul_rn(div_rn(sub_rn(__ldg(a.p_sched + i), p), vi),
                               __ldg(a.th_free + i));
      const double dq = mul_rn(div_rn(sub_rn(__ldg(a.q_sched + i), q), vi),
                               __ldg(a.v_free + i));
      if (mode == kFin) {
        const int64_t at = (lane0 + l) * n + i;
        a.theta[at] = th[u];
        a.v[at] = vi;
        a.p_out[at] = p;
        a.q_out[at] = q;
        const double e = nanmax(fabs(mul_rn(dp, vi)), fabs(mul_rn(dq, vi)));
        atomicMax(&s_err[l], (unsigned long long)__double_as_longlong(e));
      } else if (mode == kDp) {
        b[__ldg(a.pinv[0] + i) * LB + l] = dp;
      } else {
        b[__ldg(a.pinv[1] + i) * LB + l] = dq;
      }
    }
  };

  // ---- the screen ----
  __syncthreads();
  for (int u = tid; u < n * LB; u += kScreenThreads) {  // the flat start
    const int i = u / LB;
    const double v0 = __ldg(a.v_free + i) > 0.0 ? 1.0 : __ldg(a.v_set + i);
    th[u] = 0.0;
    vv[u] = v0;
    double si, ci;
    sincos(th[u], &si, &ci);
    vre[u] = mul_rn(v0, ci);
    vim[u] = mul_rn(v0, si);
  }
  __syncthreads();
  mismatch(a.max_iter > 0 ? kDp : kFin);
  // Half-iterations: B' and theta (dq next), then B'' and v (dp next, or
  // the answer after the last).
  for (int step = 0; step < 2 * a.max_iter; ++step) {
    const int h = step & 1;
    solve(h);
    correct(h);
    mismatch(h == 0 ? kDq : step + 1 < 2 * a.max_iter ? kDp : kFin);
  }
  __syncthreads();
  if (tid < LB) a.err[lane0 + tid] = __longlong_as_double((long long)s_err[tid]);
}

template <int LB, bool kWhole, bool kSpill>
int screen_launch(const ScreenArgs& a, unsigned grid, size_t smem,
                  cudaStream_t stream) {
  auto fn = smw_screen_kernel<LB, kWhole, kSpill>;
  if (smem > 48 * 1024) {  // above 48 KB a kernel has to opt in
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<grid, kScreenThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kWhole>
int screen_dispatch(const ScreenArgs& a, int lb, unsigned grid, size_t smem,
                    cudaStream_t st) {
  switch (lb) {
    case 1: return screen_launch<1, kWhole, false>(a, grid, smem, st);
    case 2: return screen_launch<2, kWhole, false>(a, grid, smem, st);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// D1
// ---------------------------------------------------------------------------

struct DcArgs {
  const double* theta0;  // [n] base angles (SCREEN)
  const double* z;       // B'^-1 a_k, element (i, l) at z[i * z_si + l * z_sl]
  int64_t z_si, z_sl;    //   (SCREEN); the angle lanes (SOLVE)
  const int64_t* ks;     // [lanes] outaged branch of each lane (SCREEN)
  const int64_t* f;      // [m] branch ends
  const int64_t* t;
  const double* w;       // [m] 1 / x
  const double* th_free; // [n]
  double* theta;         // [lanes, n] post-outage angles (SCREEN)
  double* flows;         // [lanes, m]
  double* severity;      // [lanes] (SCREEN)
  unsigned char* islanded;  // [lanes] bool (SCREEN)
  int n, m, lanes;
};

__global__ void __launch_bounds__(kThreads) dc_screen_kernel(const DcArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* s_th = reinterpret_cast<double*>(smem);
  __shared__ double s_red[kWarps + 1];
  const int n = a.n, m = a.m;
  const int lane = blockIdx.x, tid = threadIdx.x;
  const int k = (int)a.ks[lane];
  const int64_t fk = a.f[k], tk = a.t[k];
  const double* z = a.z + lane * a.z_sl;
  const double mf = a.th_free[fk], mt = a.th_free[tk];
  const double wk = a.w[k];
  const double a_th = sub_rn(mul_rn(a.theta0[fk], mf), mul_rn(a.theta0[tk], mt));
  const double a_z = sub_rn(mul_rn(z[fk * a.z_si], mf), mul_rn(z[tk * a.z_si], mt));
  const double den = sub_rn(1.0, mul_rn(wk, a_z));
  const bool isl = fabs(den) < kIslandEps;
  const double coef = div_rn(mul_rn(wk, a_th), isl ? 1.0 : den);
  const int64_t row = (int64_t)lane * n;
  for (int i = tid; i < n; i += kThreads) {
    s_th[i] = add_rn(a.theta0[i], mul_rn(coef, z[i * a.z_si]));
    a.theta[row + i] = s_th[i];
  }
  __syncthreads();
  double worst = 0.0;
  double* fl = a.flows + (int64_t)lane * m;
  for (int e = tid; e < m; e += kThreads) {
    const double x = e == k ? 0.0 : mul_rn(sub_rn(s_th[a.f[e]], s_th[a.t[e]]), a.w[e]);
    fl[e] = x;
    worst = nanmax(worst, fabs(x));
  }
  const double sev = block_max(worst, s_red);
  if (tid == 0) {
    a.severity[lane] = isl ? INFINITY : sev;
    a.islanded[lane] = isl ? 1 : 0;
  }
}

// SOLVE: a thread per (lane, branch).
__global__ void __launch_bounds__(kThreads) dc_flows_kernel(const DcArgs a) {
  const int64_t k = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (k >= (int64_t)a.lanes * a.m) return;
  const int64_t lane = k / a.m;
  const int e = (int)(k - lane * a.m);
  const double* th = a.z + lane * a.z_sl;
  a.flows[k] = mul_rn(sub_rn(th[a.f[e] * a.z_si], th[a.t[e] * a.z_si]), a.w[e]);
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer (index
// arrays int64 unless named otherwise, floats float64); `stream` is the
// caller's CUDA stream.  Each returns the cudaError_t of its launch.
//
// smw_screen_f64: the whole SMW screen of `lanes` lane slots (a multiple of
// `lb`, 1 or 2 lanes a CTA; `whole`: n <= 64, each factor one tile;
// `spill`: two lanes a CTA, their vectors in `work`, lanes / 2 x
// smw_work(n, 2) doubles, else work is null): ks [lanes]; theta, v, p_out,
// q_out [lanes, n] and err [lanes] written; lu_p, lu_q column-major with
// leading dimension lda (even, >= n, 16-byte aligned); pinv_p, pinv_q [n]
// int32; rdiag_p, rdiag_q [n]; the incidence list int32; the operands as
// SmwOperands holds them.
extern "C" int smw_screen_f64(
    const int64_t* ks, double* theta, double* v, double* p_out, double* q_out,
    double* err, const double* lu_p, const double* lu_q, const int* pinv_p,
    const int* pinv_q, const double* rdiag_p, const double* rdiag_q,
    const int* inc_ptr, const int* inc_code, const int* inc_nbr,
    const double* y, const double* g_sh, const double* b_sh,
    const double* th_free, const double* v_free, const double* v_set,
    const double* p_sched, const double* q_sched, const int64_t* f,
    const int64_t* t, const double* mask, const double* zm, const double* cap,
    double* work, int n, int m, int lda, int lanes, int lb, int whole,
    int spill, int max_iter, void* stream) {
  if (n <= 0 || m <= 0 || lb < 1 || lb > kMaxLanes || (lb & (lb - 1)) != 0 ||
      lanes <= 0 || lanes % lb != 0 || max_iter < 0 || lda < n || lda % 2 != 0 ||
      (whole && n > kTile) || (spill && (whole || lb != 2 || work == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(lu_p) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(lu_q) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smw_smem(n, lb, spill);
  if (smem + kScreenStatic > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  ScreenArgs a{ks, theta, v, p_out, q_out, err, {lu_p, lu_q}, {pinv_p, pinv_q},
               {rdiag_p, rdiag_q}, inc_ptr, inc_code, inc_nbr, y, g_sh, b_sh,
               th_free, v_free, v_set, p_sched, q_sched, f, t, mask, zm, cap,
               work, n, m, lda, max_iter};
  const unsigned grid = (unsigned)(lanes / lb);
  const cudaStream_t st = (cudaStream_t)stream;
  if (spill) return screen_launch<2, false, true>(a, grid, smem, st);
  return whole ? screen_dispatch<true>(a, lb, grid, smem, st)
               : screen_dispatch<false>(a, lb, grid, smem, st);
}

extern "C" int dc_screen_f64(
    const double* theta0, const double* z, int64_t z_si, int64_t z_sl,
    const int64_t* ks, const int64_t* f, const int64_t* t, const double* w,
    const double* th_free, double* theta, double* flows, double* severity,
    unsigned char* islanded, int n, int m, int lanes, int mode, void* stream) {
  if (lanes <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  DcArgs a{theta0, z, z_si, z_sl, ks, f, t, w, th_free, theta, flows,
           severity, islanded, n, m, lanes};
  if (mode == kScreen) {
    const size_t smem = (size_t)n * sizeof(double);
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          dc_screen_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    dc_screen_kernel<<<(unsigned)lanes, kThreads, smem,
                       (cudaStream_t)stream>>>(a);
  } else if (mode == kSolve) {
    const int64_t total = (int64_t)lanes * m;
    dc_flows_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads,
                      0, (cudaStream_t)stream>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
