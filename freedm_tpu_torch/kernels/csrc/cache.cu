// The serving cache's delta-tier kernel for Hopper (sm_90a).
//
// C1 delta_mismatch — replaces the sweep body of the XLA program of
//   freedm_tpu/serve/cache.py:284 `_build_delta_program` (:346-379): the
//   warm-started fast-decoupled correction of a cached solution, whose one
//   sweep is
//
//       theta += solve_p(dp) th_free;   dq2 = mismatch(theta, v).dq
//       v     += solve_q(dq2) v_free;   dp, dq = mismatch(theta, v)
//       err = max(max |dp v|, max |dq v|)
//
//   with mismatch(theta, v) = ((p_s - P) / v th_free, (q_s - Q) / v v_free)
//   and P, Q the branch-wise injections of freedm_tpu/pf/mfree.py:34
//   `make_injection_fn`: per branch, with V = v e^{j theta},
//
//       i_f = yff V_f + yft V_t,  i_t = ytf V_f + ytt V_t,
//       s_f = V_f conj(i_f),      s_t = V_t conj(i_t),
//       P = sum_f Re s_f + sum_t Re s_t + g_sh v^2,
//       Q = sum_f Im s_f + sum_t Im s_t - b_sh v^2.
//
//   The two triangular solves (rank-0 `smw_delta_solve` over the cached
//   B'/B'' LU pair) stay library calls; C1 is everything between them.  One
//   launch over [lanes, n] in one of four modes:
//     INIT   the mismatch at the cached start point: dp, dq, err, active;
//     THETA  theta' = theta + s th_free (s = solve_p(dp)), then dp, dq at
//            (theta', v) — dq is the next solve's right-hand side;
//     V      v' = v + s v_free (s = solve_q(dq)), then dp, dq, err at
//            (theta, v'), and the lane bookkeeping of the reference's
//            while_loop: it += 1, active = it < max_sweeps && err >= tol;
//     PQ     P and Q alone (the answer's p_calc, q_calc).
//   A lane whose `active` flag is clear keeps its state: THETA and V copy
//   the old half, V leaves err, it and active alone, so results do not
//   depend on how many sweeps the host launches after a lane is done.
//   Under mixed precision s is float32 (the solve ran on a float32 copy of
//   the LU) and is widened before it is added, as the reference's
//   `.astype(rdtype)`; `lo` receives the float32 copy of the next solve's
//   right-hand side (dp after INIT and V, dq after THETA), so the sweep has
//   no cast kernels.  Everything else is float64.
//
// Design: a thread per (lane, bus), over a cluster of up to 8 CTAs per
//   lane.  The corrected half goes to a separate output buffer; a thread
//   recomputes each neighbour's corrected value from the old value and s
//   while it gathers, with the same operations as the neighbour's own
//   thread, so no grid-wide barrier is needed.  Each thread walks its bus's
//   incidence list (the port's CSR order: the from-end edges, then the
//   to-end edges, each ascending) and adds the from-end and the to-end
//   terms in two sums in list order, which is the reference's two
//   segment_sums in edge order; every operation is an explicitly rounded
//   intrinsic, so nvcc contracts nothing into an fma and the kernel's bits
//   are PyTorch's elementwise ones wherever sin and cos agree.  The lane's
//   max of |dp v|, |dq v| is a warp-shuffle tree, then the CTA's warps in
//   order, then the cluster's CTAs in rank order through distributed shared
//   memory; a NaN propagates as jnp.max's does.  No atomics: results are
//   identical run to run.
//
// Bound on an H100 SXM (3.35 TB/s): at one lane of mesh2000 (n = 2000,
//   m = 4000) a V launch reads theta, v, s, the schedules, the masks, the
//   shunts, the incidence list and the 8 admittance rows of the branches
//   and writes v', dp, dq and the float32 copy: about 0.52 MB, 0.16 us.  It
//   is launch-bound; the design keeps it to one launch per half-sweep.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;  // portable cluster size
constexpr int kInit = 0, kTheta = 1, kV = 2, kPQ = 3;

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// jnp.maximum: NaN if either operand is NaN.
__device__ __forceinline__ double nanmax(double a, double b) {
  if (a != a || b != b) return a + b;
  return a > b ? a : b;
}

// One entry of the corrected half: x + s * mask on a live lane (s widened
// from float32 under mixed precision), x itself on a frozen one.
template <bool kS32>
__device__ __forceinline__ double corrected(const double* __restrict__ x,
                                            const void* __restrict__ s,
                                            const double* __restrict__ mask,
                                            int64_t row, int i, bool live) {
  if (!live) return x[row + i];
  const double si = kS32 ? (double)((const float*)s)[row + i]
                         : ((const double*)s)[row + i];
  return add_rn(x[row + i], mul_rn(si, mask[i]));
}

// y [8, m]: rows yff, yft, ytf, ytt of each branch as (re, im).
template <int kMode, bool kS32>
__global__ void __launch_bounds__(kThreads) delta_mismatch_kernel(
    const double* __restrict__ theta, const double* __restrict__ v,
    const void* __restrict__ s, const double* __restrict__ ps,
    const double* __restrict__ qs, const int* __restrict__ inc_ptr,
    const int* __restrict__ inc_code, const int* __restrict__ inc_nbr,
    const double* __restrict__ y, const double* __restrict__ g_sh,
    const double* __restrict__ b_sh, const double* __restrict__ th_free,
    const double* __restrict__ v_free, double* __restrict__ x_out,
    double* __restrict__ a_out, double* __restrict__ b_out,
    float* __restrict__ lo_out, double* __restrict__ err,
    int* __restrict__ it, unsigned char* __restrict__ active, int max_sweeps,
    double tol, int n, int m) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int64_t b = blockIdx.x / csize;
  const int64_t row = b * n;
  const bool live = (kMode == kTheta || kMode == kV) ? active[b] != 0 : false;
  const bool th_corr = kMode == kTheta && live;
  const bool v_corr = kMode == kV && live;
  double mx = 0.0;  // this thread's max of |dp v|, |dq v|
  for (int i = rank * kThreads + threadIdx.x; i < n; i += csize * kThreads) {
    const double thi = corrected<kS32>(theta, s, th_free, row, i, th_corr);
    const double vi = corrected<kS32>(v, s, v_free, row, i, v_corr);
    if (kMode == kTheta) x_out[row + i] = thi;
    if (kMode == kV) x_out[row + i] = vi;
    double si, ci;
    sincos(thi, &si, &ci);
    const double vre_i = mul_rn(vi, ci), vim_i = mul_rn(vi, si);
    double pf = 0.0, pt = 0.0, qf = 0.0, qt = 0.0;
    for (int r = inc_ptr[i]; r < inc_ptr[i + 1]; ++r) {
      const int code = inc_code[r];
      const int e = code >> 1;
      const bool to_side = code & 1;
      const int j = inc_nbr[r];
      const double thj = corrected<kS32>(theta, s, th_free, row, j, th_corr);
      const double vj = corrected<kS32>(v, s, v_free, row, j, v_corr);
      double sj, cj;
      sincos(thj, &sj, &cj);
      const double vre_j = mul_rn(vj, cj), vim_j = mul_rn(vj, sj);
      // The side's own admittance (yff at the from end, ytt at the to end)
      // times V_i, plus the mutual one (yft, ytf) times V_j: i_f = yff V_f
      // + yft V_t and i_t = ytf V_f + ytt V_t, the one sum in either order.
      const double ys_re = y[(to_side ? 6 : 0) * (int64_t)m + e];
      const double ys_im = y[(to_side ? 7 : 1) * (int64_t)m + e];
      const double ym_re = y[(to_side ? 4 : 2) * (int64_t)m + e];
      const double ym_im = y[(to_side ? 5 : 3) * (int64_t)m + e];
      const double i_re = add_rn(sub_rn(mul_rn(ys_re, vre_i), mul_rn(ys_im, vim_i)),
                                 sub_rn(mul_rn(ym_re, vre_j), mul_rn(ym_im, vim_j)));
      const double i_im = add_rn(add_rn(mul_rn(ys_re, vim_i), mul_rn(ys_im, vre_i)),
                                 add_rn(mul_rn(ym_re, vim_j), mul_rn(ym_im, vre_j)));
      // s = V_i conj(i): the reference's (re, im) product with conj's
      // negation folded into the signs, which IEEE arithmetic keeps exact.
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
    const double p = add_rn(add_rn(pf, pt), mul_rn(g_sh[i], v2));
    const double q = sub_rn(add_rn(qf, qt), mul_rn(b_sh[i], v2));
    if (kMode == kPQ) {
      a_out[row + i] = p;
      b_out[row + i] = q;
      continue;
    }
    const double dp = mul_rn(div_rn(sub_rn(ps[row + i], p), vi), th_free[i]);
    const double dq = mul_rn(div_rn(sub_rn(qs[row + i], q), vi), v_free[i]);
    a_out[row + i] = dp;
    b_out[row + i] = dq;
    if (lo_out != nullptr) lo_out[row + i] = (float)(kMode == kTheta ? dq : dp);
    mx = nanmax(mx, nanmax(fabs(mul_rn(dp, vi)), fabs(mul_rn(dq, vi))));
  }
  if constexpr (kMode == kInit || kMode == kV) {
    // The lane's max: a shuffle tree in each warp, the CTA's warps in order,
    // then the cluster's CTAs in rank order.
    __shared__ double warp_max[kThreads / 32];
    __shared__ double cta_max;
    for (int o = 16; o > 0; o >>= 1)
      mx = nanmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = mx;
    __syncthreads();
    if (threadIdx.x == 0) {
      double c = warp_max[0];
      for (int w = 1; w < kThreads / 32; ++w) c = nanmax(c, warp_max[w]);
      cta_max = c;
    }
    // Every thread of the cluster has read `active` before this barrier, so
    // rank 0 may rewrite it after.
    cluster.sync();
    if (rank == 0 && threadIdx.x == 0) {
      double e = cta_max;
      for (int c = 1; c < csize; ++c)
        e = nanmax(e, *cluster.map_shared_rank(&cta_max, c));
      if (kMode == kInit) {
        err[b] = e;
        active[b] = (it[b] < max_sweeps && e >= tol) ? 1 : 0;
      } else if (live) {
        const int it1 = it[b] + 1;
        err[b] = e;
        it[b] = it1;
        active[b] = (it1 < max_sweeps && e >= tol) ? 1 : 0;
      }
    }
    // No CTA leaves while rank 0 may still read its shared memory.
    cluster.sync();
  }
}

using KernelFn = void (*)(const double*, const double*, const void*,
                          const double*, const double*, const int*,
                          const int*, const int*, const double*,
                          const double*, const double*, const double*,
                          const double*, double*, double*, double*, float*,
                          double*, int*, unsigned char*, int, double, int,
                          int);

KernelFn pick(int mode, bool s32) {
  switch (mode) {
    case kInit: return delta_mismatch_kernel<kInit, false>;
    case kTheta:
      return s32 ? delta_mismatch_kernel<kTheta, true>
                 : delta_mismatch_kernel<kTheta, false>;
    case kV:
      return s32 ? delta_mismatch_kernel<kV, true>
                 : delta_mismatch_kernel<kV, false>;
    case kPQ: return delta_mismatch_kernel<kPQ, false>;
    default: return nullptr;
  }
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer to a
// contiguous tensor: theta, v, ps, qs, x_out, a_out, b_out [lanes, n]
// float64, s [lanes, n] float64 or (s_f32) float32, lo_out [lanes, n]
// float32 or null, err [lanes] float64, it [lanes] int32, active [lanes]
// bool; index arrays int32; y [8, m]; the masks and shunts [n].  `stream` is
// the caller's CUDA stream.  Returns the cudaError_t of the launch.
extern "C" int delta_mismatch_f64(
    int mode, const double* theta, const double* v, const void* s, int s_f32,
    const double* ps, const double* qs, const int* inc_ptr,
    const int* inc_code, const int* inc_nbr, const double* y,
    const double* g_sh, const double* b_sh, const double* th_free,
    const double* v_free, double* x_out, double* a_out, double* b_out,
    float* lo_out, double* err, int* it, unsigned char* active,
    int max_sweeps, double tol, int lanes, int n, int m, void* stream) {
  KernelFn fn = pick(mode, s_f32 != 0);
  const bool corrects = mode == kTheta || mode == kV;
  const bool tracks = mode == kInit || mode == kV;
  if (fn == nullptr || lanes <= 0 || lanes > 65535 || n <= 0 || m < 0 ||
      a_out == nullptr || b_out == nullptr ||
      (corrects && (s == nullptr || x_out == nullptr || active == nullptr)) ||
      (tracks && (err == nullptr || it == nullptr || active == nullptr)))
    return (int)cudaErrorInvalidValue;
  int cluster = (n + kThreads - 1) / kThreads;
  if (cluster > kMaxCluster) cluster = kMaxCluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(lanes * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, fn, theta, v, s, ps, qs, inc_ptr, inc_code, inc_nbr, y, g_sh,
      b_sh, th_free, v_free, x_out, a_out, b_out, lo_out, err, it, active,
      max_sweeps, tol, n, m);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
