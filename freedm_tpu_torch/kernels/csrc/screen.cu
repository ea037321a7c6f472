// N-1 and DC screening kernels for Hopper (sm_90a), float64.
//
// N1 smw_sweep — replaces the XLA program of freedm_tpu/pf/n1.py:340
//   `_make_smw_n1_screen` (the `_solve_lane` body, :407-464) around its base
//   triangular solves: per outage lane (branch k out), a fixed number of
//   fast-decoupled iterations
//
//       theta += smw_p(dp) th_free;   dq2 = mismatch(theta, v).dq
//       v     += smw_q(dq2) v_free;   dp, dq = mismatch(theta, v)
//
//   with smw(b) = x0 - ZM_k c, c = cap_k^-1 (x0[f_k], x0[t_k]) mask_k and
//   x0 = A^-1 b (the base B' or B'' LU pair, a multi-RHS
//   torch.linalg.lu_solve over every lane between two launches), and
//   mismatch(theta, v) = ((p_s - P) / v th_free, (q_s - Q) / v v_free), P
//   and Q the branch-wise injections of freedm_tpu/pf/mfree.py:34 with
//   branch k out of service.  One launch runs one of four modes for every
//   lane: INIT (the flat start and its dp), THETA (the theta half and dq2),
//   V (the v half and dp), FINISH (P, Q and err = max(max |dp v|,
//   max |dq v|)); a screen is INIT, max_iter x (solve, THETA, solve, V),
//   FINISH — 2 + 4 max_iter device operations, no host read in between.
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
// Design.  N1 is one CTA a lane: the lane's theta, v and V e^{j theta}
//   (4 n words, 16 KB at n = 511) sit in shared memory; the correction and
//   the mismatch are one pass each over the buses, a thread per bus walking
//   its incidence list (from-end edges, then to-end edges, each ascending)
//   with the explicitly rounded arithmetic of the port's other injection
//   kernels, so P and Q are the plain version's sums in its order, and the
//   2 x 2 capacitance solve is LAPACK's partial-pivoting getrf/getrs, run by
//   one thread.  The solve's right-hand side is written lane-major [L, n]
//   (the lu_solve reads it as a column-major [n, L] matrix) and its answer
//   read through its strides.  D1 SCREEN is one CTA a lane too: theta_l in
//   shared memory, then a thread per branch for the flows; the lane's
//   max |flow| is a per-thread max in branch order, then a fixed shuffle
//   tree, then the warps in order.  No atomics anywhere: every result is
//   the same bits on every run.
//
// Bounds on an H100 SXM (3.35 TB/s; 34 TFLOP/s fp64 outside the tensor
//   cores).  N1 at mesh511 x 256 lanes (n = 511, m = 1022): a correction
//   mode reads x0, the lane's ZM rows (2 n words), theta and v and writes
//   one half and the right-hand side, ~7.3 MB, 2.2 us; ~60 operations a
//   list entry and lane, ~31 MFLOP, 0.9 us: bytes.  D1 SCREEN at mesh2000 x
//   1024 lanes reads z (16 MB) and writes theta (16 MB) and the flows
//   (32 MB): ~64 MB, 19 us.  Both are simple first kernels: a CTA of 256
//   threads a lane leaves most of an SM idle at these sizes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // shared memory a block may use on Hopper

// N1's modes (screen_kernels.INIT, THETA, V, FINISH) and D1's (SCREEN,
// SOLVE).
constexpr int kInit = 0, kTheta = 1, kV = 2, kFinish = 3;
constexpr int kScreen = 0, kSolve = 1;

// The reference's island threshold on the Sherman-Morrison denominator
// (freedm_tpu/pf/dc.py `_ISLAND_EPS`).
constexpr double kIslandEps = 1e-6;

// Arithmetic with explicit rounding (no contraction into fma), as the
// plain versions' elementwise PyTorch operations round.
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
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
  for (int o = 16; o > 0; o >>= 1) x = nanmax(x, __shfl_down_sync(0xffffffffu, x, o));
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

// ---------------------------------------------------------------------------
// N1
// ---------------------------------------------------------------------------

struct SmwArgs {
  const int64_t* ks;    // [lanes] outaged branch of each lane
  double* theta;        // [lanes, n] state
  double* v;            // [lanes, n] state
  const double* x0;     // the base solve's answer, element (i, l) at
  int64_t x0_si, x0_sl; //   x0[i * x0_si + l * x0_sl] (THETA, V)
  double* rhs;          // [lanes, n] the next solve's right-hand side
  double* p_out;        // [lanes, n] (FINISH)
  double* q_out;        // [lanes, n] (FINISH)
  double* err;          // [lanes] (FINISH)
  const int* inc_ptr;   // [n + 1] incidence list (CSR)
  const int* inc_code;  // [2m] 2 edge + side
  const int* inc_nbr;   // [2m] the edge's other end
  const double* y;      // [8, m] yff, yft, ytf, ytt as (re, im)
  const double* g_sh;   // [n]
  const double* b_sh;
  const double* th_free;
  const double* v_free;
  const double* v_set;
  const double* p_sched;
  const double* q_sched;
  const int64_t* f;     // [m] branch ends
  const int64_t* t;
  const double* mask;   // [2, m, 2] endpoint masks of the B' and B'' updates
  const double* zm;     // [2, m, n, 2] A^-1 U of each branch, branch-major
  const double* cap;    // [2, m, 2, 2] I + P^T A^-1 U
  int n, m, lanes, mode;
};

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
// lane's V e^{j theta} in shared memory: the side's own admittance times
// V_i plus the mutual one times V_j, s = V_i conj(i), from-end and to-end
// terms summed apart in list order (mfree.py's two segment sums), then the
// shunt.
__device__ __forceinline__ void bus_pq(const SmwArgs& a, const double* vre,
                                       const double* vim, double vi, int i,
                                       int out, double* p, double* q) {
  const double vre_i = vre[i], vim_i = vim[i];
  double pf = 0.0, pt = 0.0, qf = 0.0, qt = 0.0;
  const int m = a.m;
  const int r1 = __ldg(a.inc_ptr + i + 1);
  for (int r = __ldg(a.inc_ptr + i); r < r1; ++r) {
    const int code = __ldg(a.inc_code + r);
    const int e = code >> 1;
    if (e == out) continue;  // its admittances are zero in this lane
    const bool to_side = code & 1;
    const int j = __ldg(a.inc_nbr + r);
    const double vre_j = vre[j], vim_j = vim[j];
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

__global__ void __launch_bounds__(kThreads) smw_sweep_kernel(const SmwArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, m = a.m, mode = a.mode;
  double* s_th = reinterpret_cast<double*>(smem);
  double* s_v = s_th + n;
  double* s_vre = s_v + n;
  double* s_vim = s_vre + n;
  __shared__ double s_c[2];
  __shared__ double s_red[kWarps + 1];
  const int lane = blockIdx.x, tid = threadIdx.x;
  const int k = (int)a.ks[lane];
  const int64_t row = (int64_t)lane * n;

  for (int i = tid; i < n; i += kThreads) {
    if (mode == kInit) {
      s_th[i] = 0.0;
      s_v[i] = a.v_free[i] > 0.0 ? 1.0 : a.v_set[i];
      a.theta[row + i] = s_th[i];
      a.v[row + i] = s_v[i];
    } else {
      s_th[i] = a.theta[row + i];
      s_v[i] = a.v[row + i];
    }
  }
  if (mode == kTheta || mode == kV) {
    const int h = mode == kTheta ? 0 : 1;  // B' (theta) or B'' (v) half
    const double* x0 = a.x0 + lane * a.x0_sl;
    if (tid == 0) {
      const double* mk = a.mask + ((int64_t)h * m + k) * 2;
      const double g0 = mul_rn(x0[a.f[k] * a.x0_si], mk[0]);
      const double g1 = mul_rn(x0[a.t[k] * a.x0_si], mk[1]);
      solve2(a.cap + ((int64_t)h * m + k) * 4, g0, g1, &s_c[0], &s_c[1]);
    }
    __syncthreads();
    const double c0 = s_c[0], c1 = s_c[1];
    const double* zk = a.zm + ((int64_t)h * m + k) * n * 2;
    double* half = h == 0 ? s_th : s_v;
    double* dst = (h == 0 ? a.theta : a.v) + row;
    const double* free = h == 0 ? a.th_free : a.v_free;
    for (int i = tid; i < n; i += kThreads) {
      const double zc = add_rn(mul_rn(zk[2 * i], c0), mul_rn(zk[2 * i + 1], c1));
      const double d = sub_rn(x0[i * a.x0_si], zc);
      half[i] = add_rn(half[i], mul_rn(d, free[i]));
      dst[i] = half[i];
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) {
    double si, ci;
    sincos(s_th[i], &si, &ci);
    s_vre[i] = mul_rn(s_v[i], ci);
    s_vim[i] = mul_rn(s_v[i], si);
  }
  __syncthreads();
  double worst = 0.0;
  for (int i = tid; i < n; i += kThreads) {
    const double vi = s_v[i];
    double p, q;
    bus_pq(a, s_vre, s_vim, vi, i, k, &p, &q);
    const double dp = mul_rn(div_rn(sub_rn(a.p_sched[i], p), vi), a.th_free[i]);
    const double dq = mul_rn(div_rn(sub_rn(a.q_sched[i], q), vi), a.v_free[i]);
    if (mode == kTheta) {
      a.rhs[row + i] = dq;
    } else if (mode == kFinish) {
      a.p_out[row + i] = p;
      a.q_out[row + i] = q;
      worst = nanmax(worst, nanmax(fabs(mul_rn(dp, vi)), fabs(mul_rn(dq, vi))));
    } else {
      a.rhs[row + i] = dp;
    }
  }
  if (mode == kFinish) {
    const double e = block_max(worst, s_red);
    if (tid == 0) a.err[lane] = e;
  }
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

int launch_with_smem(void (*kernel)(const SmwArgs), unsigned grid, size_t smem,
                     cudaStream_t stream, const SmwArgs& a) {
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // above 48 KB a kernel has to opt in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer (index
// arrays int64, floats float64); `stream` is the caller's CUDA stream.  Each
// returns the cudaError_t of its launch.
extern "C" int smw_sweep_f64(
    const int64_t* ks, double* theta, double* v, const double* x0,
    int64_t x0_si, int64_t x0_sl, double* rhs, double* p_out, double* q_out,
    double* err, const int* inc_ptr, const int* inc_code, const int* inc_nbr,
    const double* y, const double* g_sh, const double* b_sh,
    const double* th_free, const double* v_free, const double* v_set,
    const double* p_sched, const double* q_sched, const int64_t* f,
    const int64_t* t, const double* mask, const double* zm, const double* cap,
    int n, int m, int lanes, int mode, void* stream) {
  if (lanes <= 0 || n <= 0 || m <= 0 || mode < kInit || mode > kFinish)
    return (int)cudaErrorInvalidValue;
  SmwArgs a{ks, theta, v, x0, x0_si, x0_sl, rhs, p_out, q_out, err,
            inc_ptr, inc_code, inc_nbr, y, g_sh, b_sh, th_free, v_free,
            v_set, p_sched, q_sched, f, t, mask, zm, cap, n, m, lanes, mode};
  return launch_with_smem(smw_sweep_kernel, (unsigned)lanes,
                          4 * (size_t)n * sizeof(double), (cudaStream_t)stream,
                          a);
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
