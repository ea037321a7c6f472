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
// K2 design: the product Y [n, n] x V [n, B] tiled like a GEMM.  A block
// owns 16 rows x 16 lanes and walks j in tiles of 32, staging the Ybus and
// V tiles in shared memory, so Ybus is read B/16 times and V n/16 times
// (instead of B and n times with one block per (lane, row)).  Each thread
// owns one (row, lane) and sums its j terms in order — deterministic, no
// reduction across threads.  A pre-pass (`polar_kernel`) writes V's
// real and imaginary parts.
//
// Bounds on an H100 SXM (3.35 TB/s, 34 TFLOP/s fp64 outside the tensor
// cores), for B lanes of an n-bus case in float64:
//   K1 writes 4n^2 + 2n values per lane and reads the 2n^2 Ybus once:
//      bytes-bound; at n = 2000, B = 64 that is 8.3 GB, about 2.5 ms.
//   K2 reads the 2n^2 Ybus and writes 4n values per lane; the arithmetic
//      it needs runs over the nonzeros of Ybus only, so it too is bound by
//      the bytes of the dense Ybus (64 MB at n = 2000, about 19 us), while
//      this dense kernel spends 4 FMAs on every (lane, i, j).
// Simple and right first: no TMA/wgmma staging yet.

#include <cuda_runtime.h>
#include <stdint.h>

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
    int n) {
  const int lane = blockIdx.x;
  const int i = blockIdx.y;
  const int tid = threadIdx.x;
  const int64_t m = 2 * (int64_t)n;
  const int64_t base = (int64_t)lane * n;
  const T* v = x + lane * m + n;
  const T* ctl = ct + base;
  const T* stl = st + base;
  const T* grow = g + (int64_t)i * n;
  const T* brow = bm + (int64_t)i * n;
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

constexpr int kRows = 16;   // K2 tile: rows of Ybus per block
constexpr int kLanes = 16;  // K2 tile: lanes per block
constexpr int kTileJ = 32;  // K2 tile: columns staged per step
static_assert(kRows * kLanes == kThreads, "one thread per (row, lane)");
static_assert(kRows == kLanes, "the Ybus and V tiles share one staging loop");

// K2: a (16 rows) x (16 lanes) block of I = Y V, then S = V conj(I).
template <typename T>
__global__ void __launch_bounds__(kThreads) injection_kernel(
    const T* __restrict__ x,        // [B, 2n] = theta || v
    const T* __restrict__ vr,       // [B, n] Re V
    const T* __restrict__ vm,       // [B, n] Im V
    const T* __restrict__ g,        // [n, n] Ybus real part
    const T* __restrict__ bm,       // [n, n] Ybus imaginary part
    const T* __restrict__ p_sched,  // [B, n]
    const T* __restrict__ q_sched,  // [B, n]
    const T* __restrict__ th_free,  // [n]
    const T* __restrict__ v_free,   // [n]
    const T* __restrict__ v_set,    // [n]
    T* __restrict__ f,              // [B, 2n]
    T* __restrict__ p_out,          // [B, n]
    T* __restrict__ q_out,          // [B, n]
    int lanes, int n) {
  // The +1 pads keep a warp's shared-memory reads on distinct banks.
  __shared__ T gs[kRows][kTileJ + 1];
  __shared__ T bs[kRows][kTileJ + 1];
  __shared__ T vrs[kLanes][kTileJ + 1];
  __shared__ T vms[kLanes][kTileJ + 1];
  const int tid = threadIdx.x;
  const int r = tid % kRows;  // rows fastest: the final writes coalesce
  const int l = tid / kRows;
  const int i0 = blockIdx.x * kRows;
  const int b0 = blockIdx.y * kLanes;
  const int i = i0 + r;
  const int lane = b0 + l;

  T ire = T(0), iim = T(0);
  for (int j0 = 0; j0 < n; j0 += kTileJ) {
    // 256 threads stage 16 x 32 of each tile, two elements each, with
    // consecutive threads on consecutive columns.
    for (int e = tid; e < kRows * kTileJ; e += kThreads) {
      const int rr = e / kTileJ, jj = e % kTileJ;
      const int gi = i0 + rr, gj = j0 + jj;
      const bool ok = gi < n && gj < n;
      gs[rr][jj] = ok ? g[(int64_t)gi * n + gj] : T(0);
      bs[rr][jj] = ok ? bm[(int64_t)gi * n + gj] : T(0);
      const int gb = b0 + rr;
      const bool okv = gb < lanes && gj < n;
      vrs[rr][jj] = okv ? vr[(int64_t)gb * n + gj] : T(0);
      vms[rr][jj] = okv ? vm[(int64_t)gb * n + gj] : T(0);
    }
    __syncthreads();
#pragma unroll 8
    for (int jj = 0; jj < kTileJ; ++jj) {
      const T gij = gs[r][jj], bij = bs[r][jj];
      const T a = vrs[l][jj], b = vms[l][jj];
      ire += gij * a - bij * b;
      iim += gij * b + bij * a;
    }
    __syncthreads();
  }
  if (i >= n || lane >= lanes) return;

  const int64_t base = (int64_t)lane * n;
  const int64_t m = 2 * (int64_t)n;
  const T vri = vr[base + i], vmi = vm[base + i];
  const T P = vri * ire + vmi * iim;
  const T Q = vmi * ire - vri * iim;
  p_out[base + i] = P;
  q_out[base + i] = Q;
  const bool th_pinned = !(th_free[i] > T(0));
  const bool v_pinned = !(v_free[i] > T(0));
  f[lane * m + i] = th_pinned ? x[lane * m + i] : P - p_sched[base + i];
  f[lane * m + n + i] =
      v_pinned ? x[lane * m + n + i] - v_set[i] : Q - q_sched[base + i];
}

template <typename T>
int launch_assemble(const T* x, const T* g, const T* bm, const T* p_sched,
                    const T* q_sched, const T* th_free, const T* v_free,
                    const T* v_set, T* ct, T* st, T* f, T* jac, int lanes,
                    int n, cudaStream_t stream) {
  if (lanes <= 0 || n <= 0 || n > 65535) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)lanes * n;
  trig_kernel<T><<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0,
                   stream>>>(x, ct, st, lanes, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  assemble_kernel<T><<<dim3(lanes, n), kThreads, 0, stream>>>(
      x, ct, st, g, bm, p_sched, q_sched, th_free, v_free, v_set, f, jac, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_injections(const T* x, const T* g, const T* bm, const T* p_sched,
                      const T* q_sched, const T* th_free, const T* v_free,
                      const T* v_set, T* vr, T* vm, T* f, T* p_out, T* q_out,
                      int lanes, int n, cudaStream_t stream) {
  if (lanes <= 0 || n <= 0 || n > 65535) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)lanes * n;
  polar_kernel<T><<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0,
                    stream>>>(x, vr, vm, lanes, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kRows - 1) / kRows, (lanes + kLanes - 1) / kLanes);
  injection_kernel<T><<<grid, kThreads, 0, stream>>>(
      x, vr, vm, g, bm, p_sched, q_sched, th_free, v_free, v_set, f, p_out,
      q_out, lanes, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer to a
// contiguous tensor; `stream` is the caller's CUDA stream.  ct/st (K1) and
// vr/vm (K2) are [lanes, n] scratch.  Returns the cudaError_t of the
// launches.
#define NEWTON_ENTRY_POINTS(T, SUFFIX)                                        \
  extern "C" int newton_assemble_##SUFFIX(                                   \
      const T* x, const T* g, const T* bm, const T* p_sched,                \
      const T* q_sched, const T* th_free, const T* v_free, const T* v_set,  \
      T* ct, T* st, T* f, T* jac, int lanes, int n, void* stream) {         \
    return launch_assemble<T>(x, g, bm, p_sched, q_sched, th_free, v_free,  \
                              v_set, ct, st, f, jac, lanes, n,              \
                              (cudaStream_t)stream);                        \
  }                                                                         \
  extern "C" int power_injections_##SUFFIX(                                  \
      const T* x, const T* g, const T* bm, const T* p_sched,                \
      const T* q_sched, const T* th_free, const T* v_free, const T* v_set,  \
      T* vr, T* vm, T* f, T* p_out, T* q_out, int lanes, int n,             \
      void* stream) {                                                       \
    return launch_injections<T>(x, g, bm, p_sched, q_sched, th_free,        \
                                v_free, v_set, vr, vm, f, p_out, q_out,     \
                                lanes, n, (cudaStream_t)stream);            \
  }

NEWTON_ENTRY_POINTS(double, f64)
NEWTON_ENTRY_POINTS(float, f32)
