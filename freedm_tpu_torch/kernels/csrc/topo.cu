// Topology-sweep kernels for Hopper (sm_90a).
//
// T1 topo_radiality — replaces the XLA program of freedm_tpu/pf/topo.py:182
//   `make_radiality_check` (the lane body, :199-235): per variant lane (a
//   row of up to 6 opened branch slots, -1 pads), min-label connected
//   components over the CLOSED branches, `connected` = every label 0,
//   `radial` = connected and m - n_open == n - 1, n_open counting the lane's
//   active slots (slot >= 0; an out-of-range slot opens no branch but still
//   counts, as the reference's :230 does).
//
// T2 topo_screen — replaces freedm_tpu/pf/topo.py:455 `_screen_impl` (mode
//   SCREEN) and :466 `_detail_impl` (mode DETAIL): the rank-r
//   Sherman-Morrison-Woodbury lane of `_lane_state` and `_objectives`
//   (:415-452) after theta0 = B'^-1 p.  Per lane, with S its active slots,
//   z_k = B'^-1 a_k the masked update column of branch k (row k of
//   Z^T [m, n], solved once when the screen is built):
//
//       C = I - diag(w_S) A_S^T Z_S            [r, r], inactive slots zero
//       islanded = |det C| < 1e-6              (C taken as I there)
//       y = C^-1 (w_S . A_S^T theta0)
//       theta_v = theta0 + Z_S y
//       flows_e = (theta_v[f_e] - theta_v[t_e]) w_e, 0 on opened branches
//
//   and the three objectives: loss = sum r_e flows_e^2, worst = max |flows|,
//   violations = #{e : |flows_e| > limit} (float64).  DETAIL also writes
//   theta [V, n] and flows [V, m].  A slot >= m is gathered at m - 1 and
//   zeroes no flow, as JAX's clamped gather and dropped scatter do.
//
// Design.  Both are one CTA (256 threads) a lane, simple first kernels.
//   T1 stages the branch ends in shared memory once, the opened ones marked
//   -1 (each edge tested once against the lane's <= 6 slots, held in
//   registers), beside the lane's n int32 labels (with the ends (n + 2m) 4
//   bytes, 40 KB at mesh2000).  A sweep is an atomicMin of min(lab[f],
//   lab[t]) into both ends of every closed edge, then a pointer jump
//   lab[i] = min(lab[i], lab[lab[i]]); the loop stops when a sweep changed
//   nothing (__syncthreads_or) or at `cap` sweeps.  The updates are
//   in-place and asynchronous where the reference's are Jacobi, but labels
//   only fall, every label stays a bus of its own component at or below
//   its own index, and after k sweeps every bus within k hops of its
//   component's least bus carries that bus's index: so the fixed point —
//   each label the least index of its component — and with it the verdict
//   are the reference's, within n - 1 sweeps (the default cap is n + 1).
//   Integer atomicMin is order-free: the booleans are the same on every
//   run, while the sweep count (a diagnostic output, written only when
//   asked for) follows the threads' timing.  Below the fixed point — a cap
//   under n - 1 sweeps — the two orders can stop at different labels, so
//   the wrapper refuses such a cap.  T2: warp 0 gathers C's r^2 entries
//   and the right-hand side in parallel from L2 (the lane's r rows of Z^T,
//   contiguous, and f, t, w, the masks), thread 0 factorizes C by partial
//   pivoting (LU in registers: det = sign * prod(diag)) and solves, then a
//   thread per bus forms theta_v into shared memory (8 n bytes, 16 KB at
//   mesh2000) reading the active rows of Z^T only, and a thread per branch
//   the flows and its partial objectives in branch order; the CTA reduces
//   them with a fixed shuffle tree and the warps in order.  No float
//   atomics: every result is the same bits on every run, so a sweep's
//   shortlist is the same under kill/resume and rechunking.
//
// Bounds on an H100 SXM (3.35 TB/s; 34 TFLOP/s fp64).  T2 SCREEN at mesh118
//   x 4096 lanes, r = 2: the lanes' Z^T rows (2 x 118 x 8 bytes a lane,
//   7.7 MB), the slots and four [V] outputs: ~8 MB, 2.4 us — a launch of
//   4096 CTAs on 132 SMs, launch-latency bound in practice.  At mesh2000 x
//   16384 lanes of ranks 1-3 (mean 2): 0.52 GB of Z^T rows, 0.16 ms.  T1
//   reads nothing per sweep from device memory: it moves only the ends and
//   the slots (bytes: microseconds).  Labelling a lane's components needs
//   at least one pass over its closed edges and buses; this kernel makes
//   as many passes as sweeps, data-dependent, in shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // shared memory a block may use on Hopper
constexpr int kMaxRank = 6;       // freedm_tpu/pf/topo.py MAX_TOPO_RANK

// T2's modes (topo_kernels.SCREEN, DETAIL).
constexpr int kScreen = 0, kDetail = 1;

// |det C| below this marks the capacitance matrix singular: the variant
// islands the network (freedm_tpu/pf/topo.py `_ISLAND_EPS`).
constexpr double kIslandEps = 1e-6;

// jnp.maximum: NaN if either operand is NaN.
__device__ __forceinline__ double nanmax(double a, double b) {
  if (a != a || b != b) return a + b;
  return a > b ? a : b;
}

// ---------------------------------------------------------------------------
// T1
// ---------------------------------------------------------------------------

struct RadArgs {
  const int* f;             // [m] branch ends
  const int* t;
  const int* slots;         // [lanes, r] opened branches, -1 pads
  unsigned char* connected; // [lanes] bool
  unsigned char* radial;    // [lanes] bool
  int* sweeps;              // [lanes] sweeps run, or null (a diagnostic)
  int n, m, r, lanes, cap;
};

__global__ void __launch_bounds__(kThreads) topo_radiality_kernel(const RadArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, m = a.m, r = a.r;
  int* s_lab = reinterpret_cast<int*>(smem);
  int* s_f = s_lab + n;
  int* s_t = s_f + m;
  const int lane = blockIdx.x, tid = threadIdx.x;

  int sl[kMaxRank];
  int n_open = 0;
#pragma unroll
  for (int j = 0; j < kMaxRank; ++j) {
    const int s = j < r ? a.slots[(int64_t)lane * r + j] : -1;
    sl[j] = s;  // an inactive slot (< 0) never equals an edge index
    n_open += s >= 0 ? 1 : 0;
  }
  for (int i = tid; i < n; i += kThreads) s_lab[i] = i;
  for (int e = tid; e < m; e += kThreads) {
    bool closed = true;
#pragma unroll
    for (int j = 0; j < kMaxRank; ++j) closed = closed && sl[j] != e;
    s_f[e] = closed ? a.f[e] : -1;  // an opened edge is skipped by every sweep
    s_t[e] = a.t[e];
  }
  __syncthreads();

  int it = 0;
  bool changed = true;
  while (changed && it < a.cap) {  // both uniform across the block
    bool ch = false;
    for (int e = tid; e < m; e += kThreads) {
      const int u = s_f[e];
      if (u < 0) continue;
      const int v = s_t[e];
      const int lu = s_lab[u], lv = s_lab[v];
      if (lu < lv) {
        ch |= atomicMin(s_lab + v, lu) > lu;
      } else if (lv < lu) {
        ch |= atomicMin(s_lab + u, lv) > lv;
      }
    }
    __syncthreads();
    // Pointer jump: only this thread writes lab[i] in this phase; the
    // labels it reads may fall meanwhile, which only speeds it up.
    for (int i = tid; i < n; i += kThreads) {
      const int l = s_lab[i];
      const int ll = s_lab[l];
      if (ll < l) {
        s_lab[i] = ll;
        ch = true;
      }
    }
    changed = __syncthreads_or(ch);
    ++it;
  }

  bool nonzero = false;
  for (int i = tid; i < n; i += kThreads) nonzero = nonzero || s_lab[i] != 0;
  const bool any_nonzero = __syncthreads_or(nonzero);
  if (tid == 0) {
    const bool conn = !any_nonzero;
    a.connected[lane] = conn ? 1 : 0;
    a.radial[lane] = (conn && m - n_open == n - 1) ? 1 : 0;
    if (a.sweeps != nullptr) a.sweeps[lane] = it;
  }
}

// ---------------------------------------------------------------------------
// T2
// ---------------------------------------------------------------------------

struct ScreenArgs {
  const double* zt;      // [m, n] Z^T: row k the masked update column B'^-1 a_k
  const double* theta0;  // [n] base angles
  const int* f;          // [m] branch ends
  const int* t;
  const double* w;       // [m] 1 / x
  const double* rs;      // [m] series resistance
  const double* mask_f;  // [m] th_free[f]
  const double* mask_t;  // [m] th_free[t]
  const int* slots;      // [lanes, r] opened branches, -1 pads
  double limit;          // the violations objective's flow bar, pu
  double* loss;          // [lanes]
  double* worst;         // [lanes]
  double* viol;          // [lanes]
  unsigned char* islanded;  // [lanes] bool
  double* theta;         // [lanes, n] (DETAIL)
  double* flows;         // [lanes, m] (DETAIL)
  int n, m, r, lanes, mode;
};

// The CTA's (sum, max, sum) of one triple a thread: a fixed shuffle tree per
// warp, then thread 0 over the warps in order.
__device__ void block_reduce3(double* x, double* s_red) {
  for (int o = 16; o > 0; o >>= 1) {
    x[0] += __shfl_down_sync(0xffffffffu, x[0], o);
    x[1] = nanmax(x[1], __shfl_down_sync(0xffffffffu, x[1], o));
    x[2] += __shfl_down_sync(0xffffffffu, x[2], o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_red[3 * warp] = x[0];
    s_red[3 * warp + 1] = x[1];
    s_red[3 * warp + 2] = x[2];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      x[0] += s_red[3 * w];
      x[1] = nanmax(x[1], s_red[3 * w + 1]);
      x[2] += s_red[3 * w + 2];
    }
  }
}

__global__ void __launch_bounds__(kThreads) topo_screen_kernel(const ScreenArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* s_th = reinterpret_cast<double*>(smem);  // [n] theta_v
  __shared__ double s_c[kMaxRank * kMaxRank];       // C, row-major [r, r]
  __shared__ double s_b[kMaxRank];                  // right-hand side, then y
  __shared__ int s_k[kMaxRank];                     // gather row, -1 inactive
  __shared__ int s_open[kMaxRank];                  // opened branch, -1 none
  __shared__ double s_red[3 * kWarps];
  __shared__ int s_isl;
  const int n = a.n, m = a.m, r = a.r;
  const int lane = blockIdx.x, tid = threadIdx.x;

  if (tid < kMaxRank) {
    const int s = tid < r ? a.slots[(int64_t)lane * r + tid] : -1;
    s_k[tid] = s >= 0 ? (s < m ? s : m - 1) : -1;
    s_open[tid] = (s >= 0 && s < m) ? s : -1;
  }
  __syncthreads();

  // Warp 0: C's entries (i, j) and the right-hand side, in the reference's
  // expressions (zc = z[:, k] act; a_t_z[i, j] = zc[f_i, j] mf_i -
  // zc[t_i, j] mt_i; C = I - wk[:, None] a_t_z; b = wk (theta0[f] mf -
  // theta0[t] mt)), inactive rows and columns those of I.
  if (tid < 32) {
    for (int q = tid; q < r * r + r; q += 32) {
      if (q < r * r) {
        const int i = q / r, j = q % r;
        const int ki = s_k[i], kj = s_k[j];
        double atz = 0.0, wk = 0.0;
        if (ki >= 0 && kj >= 0) {
          const double* zj = a.zt + (int64_t)kj * n;
          atz = zj[a.f[ki]] * a.mask_f[ki] - zj[a.t[ki]] * a.mask_t[ki];
          wk = a.w[ki];
        }
        s_c[q] = (i == j ? 1.0 : 0.0) - wk * atz;
      } else {
        const int i = q - r * r;
        const int ki = s_k[i];
        double b = 0.0;
        if (ki >= 0) {
          const double ath = a.theta0[a.f[ki]] * a.mask_f[ki] -
                             a.theta0[a.t[ki]] * a.mask_t[ki];
          b = a.w[ki] * ath;
        }
        s_b[i] = b;
      }
    }
  }
  __syncthreads();

  // Thread 0: partial-pivoting LU of C in registers, det, and the solve
  // (with I, y = b, where the lane islands).
  if (tid == 0) {
    double c[kMaxRank][kMaxRank], b[kMaxRank];
#pragma unroll
    for (int i = 0; i < kMaxRank; ++i) {
      b[i] = i < r ? s_b[i] : 0.0;
#pragma unroll
      for (int j = 0; j < kMaxRank; ++j)
        c[i][j] = (i < r && j < r) ? s_c[i * r + j] : (i == j ? 1.0 : 0.0);
    }
    double det = 1.0;
    int perm[kMaxRank];
#pragma unroll
    for (int i = 0; i < kMaxRank; ++i) perm[i] = i;
#pragma unroll
    for (int col = 0; col < kMaxRank; ++col) {
      int p = col;
      double best = fabs(c[col][col]);
#pragma unroll
      for (int i = col + 1; i < kMaxRank; ++i) {
        if (fabs(c[i][col]) > best) {
          best = fabs(c[i][col]);
          p = i;
        }
      }
      if (p != col) {
        det = -det;
        const int tp = perm[p]; perm[p] = perm[col]; perm[col] = tp;
#pragma unroll
        for (int j = 0; j < kMaxRank; ++j) {
          const double tc = c[p][j]; c[p][j] = c[col][j]; c[col][j] = tc;
        }
      }
      const double piv = c[col][col];
      det *= piv;
      if (piv != 0.0) {
#pragma unroll
        for (int i = col + 1; i < kMaxRank; ++i) {
          const double l = c[i][col] / piv;
          c[i][col] = l;
#pragma unroll
          for (int j = col + 1; j < kMaxRank; ++j) c[i][j] -= l * c[col][j];
        }
      }
    }
    const bool isl = fabs(det) < kIslandEps;
    if (!isl) {
      double y[kMaxRank];
#pragma unroll
      for (int i = 0; i < kMaxRank; ++i) {  // L y = P b (unit lower)
        double s = b[perm[i]];
#pragma unroll
        for (int j = 0; j < i; ++j) s -= c[i][j] * y[j];
        y[i] = s;
      }
#pragma unroll
      for (int i = kMaxRank - 1; i >= 0; --i) {  // U x = y
        double s = y[i];
#pragma unroll
        for (int j = i + 1; j < kMaxRank; ++j) s -= c[i][j] * y[j];
        y[i] = s / c[i][i];
      }
#pragma unroll
      for (int i = 0; i < kMaxRank; ++i) b[i] = y[i];
    }
    for (int i = 0; i < r; ++i) s_b[i] = b[i];
    s_isl = isl ? 1 : 0;
  }
  __syncthreads();

  // theta_v = theta0 + Z_S y, reading the active rows of Z^T only.
  const bool detail = a.mode == kDetail;
  double* th_out = detail ? a.theta + (int64_t)lane * n : nullptr;
  for (int x = tid; x < n; x += kThreads) {
    double s = 0.0;
    for (int j = 0; j < r; ++j) {
      const int kj = s_k[j];
      if (kj >= 0) s += a.zt[(int64_t)kj * n + x] * s_b[j];
    }
    const double th = a.theta0[x] + s;
    s_th[x] = th;
    if (detail) th_out[x] = th;
  }
  __syncthreads();

  // The flows and each thread's partial objectives, in branch order.
  double part[3] = {0.0, 0.0, 0.0};  // loss, worst, violations
  double* fl_out = detail ? a.flows + (int64_t)lane * m : nullptr;
  const double limit = a.limit;
  for (int e = tid; e < m; e += kThreads) {
    bool open = false;
    for (int j = 0; j < r; ++j) open = open || s_open[j] == e;
    const double fl = open ? 0.0 : (s_th[a.f[e]] - s_th[a.t[e]]) * a.w[e];
    if (detail) fl_out[e] = fl;
    part[0] += a.rs[e] * fl * fl;
    part[1] = nanmax(part[1], fabs(fl));
    part[2] += fabs(fl) > limit ? 1.0 : 0.0;
  }
  block_reduce3(part, s_red);
  if (tid == 0) {
    a.loss[lane] = part[0];
    a.worst[lane] = part[1];
    a.viol[lane] = part[2];
    a.islanded[lane] = (unsigned char)s_isl;
  }
}

template <typename Args>
int launch(void (*kernel)(const Args), unsigned grid, size_t smem,
           cudaStream_t stream, const Args& a) {
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

// Plain C interface for ctypes.  Every pointer is a device pointer (indices
// int32, floats float64, flags one byte); `stream` is the caller's CUDA
// stream.  Each returns the cudaError_t of its launch.
extern "C" int topo_radiality(const int* f, const int* t, const int* slots,
                              unsigned char* connected, unsigned char* radial,
                              int* sweeps, int n, int m, int r, int lanes,
                              int cap, void* stream) {
  if (lanes <= 0 || n <= 0 || m <= 0 || r < 1 || r > kMaxRank || cap < 0)
    return (int)cudaErrorInvalidValue;
  RadArgs a{f, t, slots, connected, radial, sweeps, n, m, r, lanes, cap};
  return launch(topo_radiality_kernel, (unsigned)lanes,
                ((size_t)n + 2 * (size_t)m) * sizeof(int),
                (cudaStream_t)stream, a);
}

extern "C" int topo_screen_f64(
    const double* zt, const double* theta0, const int* f, const int* t,
    const double* w, const double* rs, const double* mask_f,
    const double* mask_t, const int* slots, double limit, double* loss,
    double* worst, double* viol, unsigned char* islanded, double* theta,
    double* flows, int n, int m, int r, int lanes, int mode, void* stream) {
  if (lanes <= 0 || n <= 0 || m <= 0 || r < 1 || r > kMaxRank ||
      (mode != kScreen && mode != kDetail) ||
      (mode == kDetail && (theta == nullptr || flows == nullptr)))
    return (int)cudaErrorInvalidValue;
  ScreenArgs a{zt, theta0, f, t, w, rs, mask_f, mask_t, slots, limit, loss,
               worst, viol, islanded, theta, flows, n, m, r, lanes, mode};
  return launch(topo_screen_kernel, (unsigned)lanes,
                (size_t)n * sizeof(double), (cudaStream_t)stream, a);
}
