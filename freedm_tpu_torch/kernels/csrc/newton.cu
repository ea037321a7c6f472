// Dense Newton AC power-flow kernels for Hopper (sm_90a).
//
// K1 newton_assemble — replaces the XLA program fused out of
//   freedm_tpu/pf/newton.py:260-301 `_newton_step` (everything except the
//   `jnp.linalg.solve`): trig outer products, the C/A intermediates, the
//   row sums P and Q, the masked mismatch f and the [2n, 2n] polar Jacobian
//
//       [[A - diag Q,  C/V_j + diag(P/V)],
//        [-C + diag P, A/V_j + diag(Q/V)]]
//
//   with identity rows for pinned theta (slack) and pinned V (PV/slack).
//   C and A are never materialised: each element is computed, written into
//   its four Jacobian slots and summed into the row's P/Q in registers.
//
// K2 power_injections — replaces `s_calc` (:144-151) and `_residual`
//   (:253-258): P + jQ = V conj(Y V) and the masked mismatch f, with no
//   Jacobian.  It uses the reference's own current-injection form
//   I_i = sum_j Y_ij V_j on V = v (cos theta + j sin theta), so every
//   (lane, i, j) costs four FMAs and no trig.
//
// K1 design: one block per (lane, row i), 256 threads striding over the
// columns j.  blockIdx.x is the lane, so the lanes of one row run side by
// side and share row i of Ybus through L2 instead of each lane re-reading
// the whole [n, n] matrix from device memory.  P_i and Q_i come from a
// fixed-order tree reduction in shared memory — no atomics, so the results
// are identical run to run.  The diagonal is written after the reduction
// by thread 0.  The trig uses the reference's product form
// cos E = c_i c_j + s_i s_j, sin E = s_i c_j - c_i s_j on per-lane cos/sin
// tables that a small pre-pass (`trig_kernel`) writes.
//
// K2 design: a pre-pass (`polar_kernel`) writes V's real and
// imaginary parts; the product I = Y V is row_product.cuh's tiled form (64
// rows x 64 lanes a block over a K slice, staged by cp.async, float64 on
// the FP64 tensor cores, float32 by FFMA micro-tiles; its K slices' partial
// sums in a [splits, 2, B, n] scratch), whose epilogue pass adds them in
// split order and runs `InjectionEpilogue`: S = V conj(I) and the masked
// mismatch.  Deterministic: fixed k order within a slice, slices added in
// order, no atomics.
//
// Bounds on an H100 SXM (3.35 TB/s, 34 TFLOP/s fp64 outside the tensor
// cores, 67 through them), for B lanes of an n-bus case in float64:
//   K1 writes 4n^2 + 2n values per lane and reads the 2n^2 Ybus once:
//      bytes-bound; at n = 2000, B = 64 that is 8.3 GB, about 2.5 ms.
//   K2 reads the 2n^2 Ybus and writes 4n values per lane; the arithmetic
//      it needs runs over the nonzeros of Ybus only, so it is bound by the
//      bytes of the dense Ybus (64 MB at n = 2000, about 19 us); a dense
//      product, which this kernel runs, has a floor of 8 n^2 B operations
//      at the tensor-core rate: 2.05 GFLOP, 31 us at mesh2000 x 64.
//   K3 reads x, dx, f and the mask and writes x: bytes, 4 * 2n * 8 per
//      lane, 8.2 MB at n = 2000, B = 64, about 2.5 us.
//
// Per-lane Ybus (the dense backend's branch status, stamped by Y1 in
// solvers.cu): K1 and K2 take a lane stride for Ybus, 0 when every lane
// shares one [n, n] matrix (the tiled path above) and n * n for a
// [B, n, n] stack.  K1 reads lane b's rows at that offset; K2 cannot share
// a Ybus tile between lanes there, so it runs `injection_lane_kernel`: a
// warp per (lane, row) reading the row coalesced, summed by a fixed
// xor-shuffle tree (row_product.cuh's warp form).  Both then read B n^2 Ybus values, the bound.
//
// K3 newton_update — replaces the per-lane select that XLA fuses out of the
//   vmapped lax.while_loop in freedm_tpu/pf/newton.py:325-336:
//
//       err_new = max |f * free|          (NaN if any element is NaN)
//       if active:  x += dx;  it += 1;  err = err_new
//       active = (it < max_iter) & (err >= tol)
//
//   err is the mismatch of the point the step started from (the reference's
//   pre-update carry); err >= tol is written as the reference writes it, so
//   a NaN lane stops.  A max and x + dx do not depend on order: the results
//   are exact whatever the split.  Design: at a small row (2n <= 1024, the
//   cases below a few hundred buses) one warp per lane; above, one block of
//   512 threads per lane with 16-byte loads, every load of a thread issued
//   before any is used.  (A cluster of up to 8 CTAs per lane, the maxima
//   meeting in distributed shared memory, took 7.6 us at mesh2000 x 64 on
//   an H100 against 5.8 us for a Triton form, one 4-warp program per
//   lane: its two cluster barriers cost more than its spread saves.)  At
//   these sizes the kernel's traffic costs less than a launch, so the
//   wrapper's host cost is the call's cost.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "row_product.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void sincos_(double x, double* s, double* c) { sincos(x, s, c); }
__device__ __forceinline__ void sincos_(float x, float* s, float* c) { sincosf(x, s, c); }

// ct/st[b, j] = cos/sin(theta[b, j]) with theta = x[b, :n].
template <typename T>
__global__ void trig_kernel(const T* __restrict__ x, T* __restrict__ ct,
                            T* __restrict__ st, int lanes, int n) {
  const int64_t k = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (k >= (int64_t)lanes * n) return;
  const int64_t b = k / n, j = k - b * n;
  T s, c;
  sincos_(x[b * 2 * n + j], &s, &c);
  ct[k] = c;
  st[k] = s;
}

// K1: one (lane, row) block.
template <typename T>
__global__ void __launch_bounds__(kThreads) assemble_kernel(
    const T* __restrict__ x,        // [B, 2n] = theta || v
    const T* __restrict__ ct,       // [B, n]
    const T* __restrict__ st,       // [B, n]
    const T* __restrict__ g,        // [n, n] Ybus real part
    const T* __restrict__ bm,       // [n, n] Ybus imaginary part
    const T* __restrict__ p_sched,  // [B, n]
    const T* __restrict__ q_sched,  // [B, n]
    const T* __restrict__ th_free,  // [n] 1 where theta is unknown
    const T* __restrict__ v_free,   // [n] 1 where V is unknown
    const T* __restrict__ v_set,    // [n]
    T* __restrict__ f,              // [B, 2n]
    T* __restrict__ jac,            // [B, 2n, 2n]
    int n, int64_t y_stride) {      // Ybus lane stride: 0 or n * n
  const int lane = blockIdx.x;
  const int i = blockIdx.y;
  const int tid = threadIdx.x;
  const int64_t m = 2 * (int64_t)n;
  const int64_t base = (int64_t)lane * n;
  const T* v = x + lane * m + n;
  const T* ctl = ct + base;
  const T* stl = st + base;
  const T* grow = g + lane * y_stride + (int64_t)i * n;
  const T* brow = bm + lane * y_stride + (int64_t)i * n;
  const T cti = ctl[i], sti = stl[i], vi = v[i];
  const bool th_pinned = !(th_free[i] > T(0));
  const bool v_pinned = !(v_free[i] > T(0));
  T* jp = jac + ((int64_t)lane * m + i) * m;      // row i
  T* jq = jac + ((int64_t)lane * m + n + i) * m;  // row n+i

  T psum = T(0), qsum = T(0);
  for (int j = tid; j < n; j += kThreads) {
    const T ctj = ctl[j], stj = stl[j], vj = v[j];
    const T cos_e = cti * ctj + sti * stj;
    const T sin_e = sti * ctj - cti * stj;
    const T vo = vi * vj;
    const T gij = grow[j], bij = brow[j];
    const T c = vo * (gij * cos_e + bij * sin_e);
    const T a = vo * (gij * sin_e - bij * cos_e);
    psum += c;
    qsum += a;
    if (j != i) {
      jp[j] = th_pinned ? T(0) : a;
      jp[n + j] = th_pinned ? T(0) : c / vj;
      jq[j] = v_pinned ? T(0) : -c;
      jq[n + j] = v_pinned ? T(0) : a / vj;
    }
  }

  __shared__ T sp[kThreads];
  __shared__ T sq[kThreads];
  sp[tid] = psum;
  sq[tid] = qsum;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
      sp[tid] += sp[tid + s];
      sq[tid] += sq[tid + s];
    }
    __syncthreads();
  }
  if (tid != 0) return;

  const T P = sp[0], Q = sq[0];
  const T theta_i = x[lane * m + i];
  f[lane * m + i] = th_pinned ? theta_i : P - p_sched[base + i];
  f[lane * m + n + i] = v_pinned ? vi - v_set[i] : Q - q_sched[base + i];
  // The (i, i) element exactly as the column loop computes it.
  const T cos_e = cti * cti + sti * sti;
  const T sin_e = sti * cti - cti * sti;
  const T vo = vi * vi;
  const T gii = grow[i], bii = brow[i];
  const T c = vo * (gii * cos_e + bii * sin_e);
  const T a = vo * (gii * sin_e - bii * cos_e);
  jp[i] = th_pinned ? T(1) : a - Q;
  jp[n + i] = th_pinned ? T(0) : c / vi + P / vi;
  jq[i] = v_pinned ? T(0) : -c + P;
  jq[n + i] = v_pinned ? T(1) : a / vi + Q / vi;
}

// vr/vm[b, j] = v cos(theta), v sin(theta) at lane b, bus j.
template <typename T>
__global__ void polar_kernel(const T* __restrict__ x, T* __restrict__ vr,
                             T* __restrict__ vm, int lanes, int n) {
  const int64_t k = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (k >= (int64_t)lanes * n) return;
  const int64_t b = k / n, j = k - b * n;
  T s, c;
  sincos_(x[b * 2 * n + j], &s, &c);
  const T v = x[b * 2 * n + n + j];
  vr[k] = v * c;
  vm[k] = v * s;
}

using row_product::kWarpsPerBlock;
static_assert(row_product::kThreads == kThreads, "one block size");

// S = V conj(I) at row i of lane `lane` and the masked mismatch there.
template <typename T>
__device__ __forceinline__ void injection_epilogue(
    int64_t lane, int i, int n, T ire, T iim, const T* __restrict__ x,
    const T* __restrict__ vr, const T* __restrict__ vm,
    const T* __restrict__ p_sched, const T* __restrict__ q_sched,
    const T* __restrict__ th_free, const T* __restrict__ v_free,
    const T* __restrict__ v_set, T* __restrict__ f, T* __restrict__ p_out,
    T* __restrict__ q_out) {
  const int64_t base = lane * n;
  const int64_t m = 2 * (int64_t)n;
  // Read-only inputs (__ldg): a thread's outputs need not wait for each
  // other's stores.
  const T vri = __ldg(vr + base + i), vmi = __ldg(vm + base + i);
  const T ps = __ldg(p_sched + base + i), qs = __ldg(q_sched + base + i);
  const bool th_pinned = !(__ldg(th_free + i) > T(0));
  const bool v_pinned = !(__ldg(v_free + i) > T(0));
  const T th = __ldg(x + lane * m + i), v = __ldg(x + lane * m + n + i);
  const T vs = __ldg(v_set + i);
  T P, Q;
  row_product::power(vri, vmi, ire, iim, P, Q);
  p_out[base + i] = P;
  q_out[base + i] = Q;
  f[lane * m + i] = th_pinned ? th : P - ps;
  f[lane * m + n + i] = v_pinned ? v - vs : Q - qs;
}

// K2's epilogue, handed each (lane, row)'s I by the tiled product.
template <typename T>
struct InjectionEpilogue {
  const T *x, *vr, *vm, *p_sched, *q_sched, *th_free, *v_free, *v_set;
  T *f, *p_out, *q_out;
  int n;
  __device__ __forceinline__ T operator()(int64_t lane, int i, T ire,
                                          T iim) const {
    injection_epilogue<T>(lane, i, n, ire, iim, x, vr, vm, p_sched, q_sched,
                          th_free, v_free, v_set, f, p_out, q_out);
    return T(0);
  }
  __device__ __forceinline__ void lane_tile(int64_t, int, T, bool) const {}
};

// K2 with a per-lane Ybus [B, n, n] (the dense backend's branch status):
// no tile of Ybus serves two lanes, so a warp owns a (lane, row)
// (row_product.cuh's warp form).
template <typename T>
__global__ void __launch_bounds__(kThreads) injection_lane_kernel(
    const T* __restrict__ x, const T* __restrict__ vr,
    const T* __restrict__ vm, const T* __restrict__ g,
    const T* __restrict__ bm, const T* __restrict__ p_sched,
    const T* __restrict__ q_sched, const T* __restrict__ th_free,
    const T* __restrict__ v_free, const T* __restrict__ v_set,
    T* __restrict__ f, T* __restrict__ p_out, T* __restrict__ q_out, int n) {
  const int i = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int ln = threadIdx.x & 31;
  const int64_t lane = blockIdx.y;
  if (i >= n) return;  // whole warps
  const int64_t base = lane * n;
  T ire, iim;
  row_product::warp_product<T>(g + (base + i) * (int64_t)n,
                               bm + (base + i) * (int64_t)n, vr + base,
                               vm + base, n, ln, ire, iim);
  if (ln != 0) return;
  injection_epilogue<T>(lane, i, n, ire, iim, x, vr, vm, p_sched, q_sched,
                        th_free, v_free, v_set, f, p_out, q_out);
}

// ---------------------------------------------------------------------------
// K3
// ---------------------------------------------------------------------------

constexpr int kUpdWarpMax = 1024;  // rows up to this length: one warp a lane
constexpr int kUpdLanesPerBlock = 4;
constexpr int kUpdThreads = 512;  // longer rows: one block a lane
constexpr int kUpdPer = 4;        // chunks a thread loads before it uses any

// |f free| into the running max; a NaN sets the flag instead.
template <typename T>
__device__ __forceinline__ void upd_max(T f, T fr, T& worst, bool& nan) {
  const T a = fabs(f * fr);
  if (a != a) nan = true;
  else if (a > worst) worst = a;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmax(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T>
__device__ __forceinline__ void finish_lane(int64_t lane, bool act, T worst,
                                            bool nan, int* it, T* err,
                                            unsigned char* active,
                                            const T* tol, int max_iter) {
  int i = it[lane];
  T e = err[lane];
  if (act) {
    i += 1;
    e = nan ? T(NAN) : worst;
  }
  it[lane] = i;
  err[lane] = e;
  active[lane] = (i < max_iter && e >= tol[0]) ? 1 : 0;
}

// One warp per lane; kUpdLanesPerBlock lanes per block.
template <typename T>
__global__ void __launch_bounds__(32 * kUpdLanesPerBlock) update_warp_kernel(
    T* __restrict__ x, const T* __restrict__ dx, const T* __restrict__ f,
    const T* __restrict__ free, int* __restrict__ it, T* __restrict__ err,
    unsigned char* __restrict__ active, const T* __restrict__ tol, int lanes,
    int m, int max_iter) {
  const int64_t lane =
      (int64_t)blockIdx.x * kUpdLanesPerBlock + threadIdx.x / 32;
  const int ln = threadIdx.x & 31;
  if (lane >= lanes) return;  // whole warps
  const bool act = active[lane] != 0;
  const int64_t row = lane * m;
  T worst = T(0);
  bool nan = false;
  for (int k = ln; k < m; k += 32) {
    upd_max(f[row + k], free[k], worst, nan);
    if (act) x[row + k] += dx[row + k];
  }
  worst = warp_max(worst);
  nan = __any_sync(0xffffffffu, nan);
  if (ln == 0)
    finish_lane(lane, act, worst, nan, it, err, active, tol, max_iter);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Chunk {
  T v[V];
};

// One block of kUpdThreads per lane (lane = blockIdx.x): the row in chunks
// of V elements (16-byte loads when V > 1), kUpdPer chunks a thread loaded
// before any is used; the block's max and NaN flag meet in shared memory.
template <typename T, int V>
__global__ void __launch_bounds__(kUpdThreads) update_block_kernel(
    T* __restrict__ x, const T* __restrict__ dx, const T* __restrict__ f,
    const T* __restrict__ free, int* __restrict__ it, T* __restrict__ err,
    unsigned char* __restrict__ active, const T* __restrict__ tol, int lanes,
    int m, int max_iter) {
  using Ch = Chunk<T, V>;
  __shared__ T red_worst[kUpdThreads / 32];
  __shared__ int red_nan[kUpdThreads / 32];
  const int64_t lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nch = m / V;
  const bool act = active[lane] != 0;
  Ch* xr = reinterpret_cast<Ch*>(x + lane * m);
  const Ch* dr = reinterpret_cast<const Ch*>(dx + lane * m);
  const Ch* fr = reinterpret_cast<const Ch*>(f + lane * m);
  const Ch* mr = reinterpret_cast<const Ch*>(free);
  T worst = T(0);
  bool nan = false;
  for (int base = tid; base < nch; base += kUpdPer * kUpdThreads) {
    Ch fv[kUpdPer], mv[kUpdPer], xv[kUpdPer], dv[kUpdPer];
#pragma unroll
    for (int j = 0; j < kUpdPer; ++j) {
      const int c = base + j * kUpdThreads;
      if (c < nch) {
        fv[j] = fr[c];
        mv[j] = mr[c];
        if (act) {
          xv[j] = xr[c];
          dv[j] = dr[c];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kUpdPer; ++j) {
      const int c = base + j * kUpdThreads;
      if (c < nch) {
#pragma unroll
        for (int q = 0; q < V; ++q) upd_max(fv[j].v[q], mv[j].v[q], worst, nan);
        if (act) {
#pragma unroll
          for (int q = 0; q < V; ++q) xv[j].v[q] += dv[j].v[q];
          xr[c] = xv[j];
        }
      }
    }
  }
  worst = warp_max(worst);
  nan = __any_sync(0xffffffffu, nan);
  if ((tid & 31) == 0) {
    red_worst[tid / 32] = worst;
    red_nan[tid / 32] = nan ? 1 : 0;
  }
  __syncthreads();
  if (tid == 0) {
    T w = T(0);
    int n = 0;
    for (int k = 0; k < kUpdThreads / 32; ++k) {
      w = fmax(w, red_worst[k]);
      n |= red_nan[k];
    }
    finish_lane(lane, act, w, n != 0, it, err, active, tol, max_iter);
  }
}

template <typename T>
int launch_assemble(const T* x, const T* g, const T* bm, const T* p_sched,
                    const T* q_sched, const T* th_free, const T* v_free,
                    const T* v_set, T* ct, T* st, T* f, T* jac, int lanes,
                    int n, int64_t y_stride, cudaStream_t stream) {
  if (lanes <= 0 || n <= 0 || n > 65535) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)lanes * n;
  trig_kernel<T><<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0,
                   stream>>>(x, ct, st, lanes, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  assemble_kernel<T><<<dim3(lanes, n), kThreads, 0, stream>>>(
      x, ct, st, g, bm, p_sched, q_sched, th_free, v_free, v_set, f, jac, n,
      y_stride);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_injections(const T* x, const T* g, const T* bm, const T* p_sched,
                      const T* q_sched, const T* th_free, const T* v_free,
                      const T* v_set, T* vr, T* vm, T* f, T* p_out, T* q_out,
                      T* part, int lanes, int n, int64_t y_stride, int splits,
                      cudaStream_t stream) {
  if (lanes <= 0 || n <= 0 || n > 65535) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)lanes * n;
  polar_kernel<T><<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0,
                    stream>>>(x, vr, vm, lanes, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (y_stride != 0) {
    if (lanes > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock, lanes);
    injection_lane_kernel<T><<<grid, kThreads, 0, stream>>>(
        x, vr, vm, g, bm, p_sched, q_sched, th_free, v_free, v_set, f, p_out,
        q_out, n);
    return (int)cudaGetLastError();
  }
  const InjectionEpilogue<T> epi{x,      vr, vm,    p_sched, q_sched, th_free,
                                 v_free, v_set, f, p_out,   q_out,   n};
  return row_product::launch_tiled<T>(g, bm, vr, vm, part, lanes, n, splits,
                                      epi, stream);
}

template <typename T>
int launch_update(T* x, const T* dx, const T* f, const T* free, int* it,
                  T* err, unsigned char* active, const T* tol, int lanes,
                  int m, int max_iter, cudaStream_t stream) {
  if (lanes <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  if (m <= kUpdWarpMax) {
    const unsigned blocks =
        (unsigned)((lanes + kUpdLanesPerBlock - 1) / kUpdLanesPerBlock);
    update_warp_kernel<T><<<blocks, 32 * kUpdLanesPerBlock, 0, stream>>>(
        x, dx, f, free, it, err, active, tol, lanes, m, max_iter);
    return (int)cudaGetLastError();
  }
  constexpr int V = 16 / sizeof(T);
  const bool vec =
      m % V == 0 && ((uintptr_t)x | (uintptr_t)dx | (uintptr_t)f |
                     (uintptr_t)free) % 16 == 0;
  if (vec)
    update_block_kernel<T, V><<<lanes, kUpdThreads, 0, stream>>>(
        x, dx, f, free, it, err, active, tol, lanes, m, max_iter);
  else
    update_block_kernel<T, 1><<<lanes, kUpdThreads, 0, stream>>>(
        x, dx, f, free, it, err, active, tol, lanes, m, max_iter);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer to a
// contiguous tensor; `stream` is the caller's CUDA stream.  K1 and K2 read
// lane b's Ybus at g + b * y_stride: 0 for one [n, n] Ybus of every lane,
// n * n for a [B, n, n] stack.  ct/st (K1) and
// vr/vm (K2) are [lanes, n] scratch; with a shared Ybus, K2's `splits`
// (the tiled product's K slices) comes from newton_kernels.product_splits
// and `part` is the product's [splits, 2, lanes, n] scratch (unused with a
// per-lane Ybus).  K3's `it` is int32, `active` one byte a lane and `tol`
// one element.  Returns the cudaError_t of the launches.
#define NEWTON_ENTRY_POINTS(T, SUFFIX)                                        \
  extern "C" int newton_assemble_##SUFFIX(                                   \
      const T* x, const T* g, const T* bm, const T* p_sched,                \
      const T* q_sched, const T* th_free, const T* v_free, const T* v_set,  \
      T* ct, T* st, T* f, T* jac, int lanes, int n, long long y_stride,     \
      void* stream) {                                                       \
    return launch_assemble<T>(x, g, bm, p_sched, q_sched, th_free, v_free,  \
                              v_set, ct, st, f, jac, lanes, n, y_stride,    \
                              (cudaStream_t)stream);                        \
  }                                                                         \
  extern "C" int power_injections_##SUFFIX(                                  \
      const T* x, const T* g, const T* bm, const T* p_sched,                \
      const T* q_sched, const T* th_free, const T* v_free, const T* v_set,  \
      T* vr, T* vm, T* f, T* p_out, T* q_out, T* part, int lanes, int n,    \
      long long y_stride, int splits, void* stream) {                       \
    return launch_injections<T>(x, g, bm, p_sched, q_sched, th_free,        \
                                v_free, v_set, vr, vm, f, p_out, q_out,     \
                                part, lanes, n, y_stride, splits,           \
                                (cudaStream_t)stream);                      \
  }                                                                         \
  extern "C" int newton_update_##SUFFIX(                                     \
      T* x, const T* dx, const T* f, const T* free, int* it, T* err,        \
      unsigned char* active, const T* tol, int lanes, int m, int max_iter,  \
      void* stream) {                                                       \
    return launch_update<T>(x, dx, f, free, it, err, active, tol, lanes, m, \
                            max_iter, (cudaStream_t)stream);                \
  }

NEWTON_ENTRY_POINTS(double, f64)
NEWTON_ENTRY_POINTS(float, f32)
