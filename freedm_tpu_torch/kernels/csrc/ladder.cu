// Ladder power-flow kernels for Hopper (sm_90a), float64 and float32.
//
// L1 ladder_solve — replaces the XLA programs of freedm_tpu/pf/ladder.py:184
//   `_solve` (a while_loop) and :209 `_solve_fixed` (a scan) with their
//   iteration `_sweep` (:138) and `_root_err` (:148), on the preorder
//   Euler-tour sweeps of freedm_tpu/pf/sweeps.py:124 `euler_sweeps`
//   (:204-226).  One ladder iteration on a lane, in preorder space
//   (branch i feeds node i + 1; every subtree is the interval [i, tout_i)):
//
//       i_load = conj(s / v) on live phases (|v|^2 > 0), 0 elsewhere
//       i_br[i] = P[tout_i] - P[i]                 P = exclusive prefix of i_load
//       drop[i, p] = sum_q i_br[i, q] z[i, q, p]   (complex)
//       path[t] = inclusive prefix of (drop[t] - q[t]),
//                 q[t] = sum of drop[k] over the k with tout_k = t
//       v' = (v0 - path) mask
//       err = max over phases and branches of |i_br - i_br_prev| root
//
//   `solve` mode: each lane iterates while it < max_iter and err >= eps, on
//   its own, with no host read, and writes its iterations, residual and
//   converged flag; `fixed` mode: exactly max_iter iterations, and when
//   asked, each iteration's input v is saved for L2.
//
// L2 ladder_vjp — replaces the reverse mode of :209 `_solve_fixed` (the
//   jax.value_and_grad of freedm_tpu/modules/vvc.py:117): from the
//   cotangents of the final v, i_br and i_load, the cotangent of s, walking
//   the saved iterates backwards.  Per iteration, with vbar the cotangent
//   of the iteration's output v:
//
//       dropbar = -B(mask vbar)                  B = subtree sums (L1's backward)
//       ibbar[q] = sum_p conj(z[q, p]) dropbar[p] (+ the final i_br's cotangent)
//       ilbar = F(ibbar)                         F = path sums (L1's forward)
//                                                (+ the final i_load's cotangent)
//       sbar += conj(ilbar / v),  vbar <- -conj(s ilbar / v^2)   on live phases,
//       0 on dead phases (the `where` of ladder.py:140-146: never NaN)
//
//   The path-sum operator is the adjoint of the subtree-sum operator and
//   vice versa, so L2 runs L1's two scans, swapped.  The root error carries
//   no gradient (ladder.py:148-157).
//
// Design.  One CTA of 512 threads a lane, the lane's state in device memory
//   (at 10k buses a lane's v, i_br, i_load and two scratch rows are 2.4 MB
//   in float64; 64 lanes stay within the 50 MB L2).  Each warp owns a
//   contiguous run of branches and walks it in chunks of 32, a branch a
//   lane, so every load is coalesced and a branch stays with one thread in
//   every pass.  A prefix is two walks of the run: the warp's sum, then,
//   after the warps' sums (added in warp order), each chunk's shuffle scan
//   on the running carry.  The order of every sum is fixed and nothing is
//   atomic, so the results are the same bits on every run.  The groups
//   {k : tout_k = t} come from the host as CSR in increasing k.  An
//   iteration is seven walks of the run and four barriers.  (A first form
//   gave each thread a contiguous run of its own, so its loads were
//   strided by the run's length.)
//
// Bounds on an H100 SXM (3.35 TB/s; 34 / 67 TFLOP/s fp64 / fp32 outside the
//   tensor cores).  At synthetic_radial(10000) x 64 lanes, 20 iterations,
//   float64: the loads read once (31 MB) and v, i_br, i_load written once
//   (92 MB), 37 us; ~150 operations a branch, phase pair and iteration
//   (a complex division, two scans, the 3 x 3 drop), 1.9 GFLOP, 57 us:
//   operations.  A CTA a lane walks its state from L2 five times an
//   iteration; a simple first kernel, it leaves the SMs beyond B idle.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// max that propagates NaN, as jnp.max and torch.amax do.
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (b > a || isnan(b)) ? b : a;
}

// The tree's constants, in preorder space.
template <typename T>
struct Tree {
  const T* mask;  // [nb, 3] phase exists at the to-node
  const T* z_re;  // [nb, 3, 3] series impedance, pu
  const T* z_im;
  const T* root;  // [nb] 1 on substation-fed branches
  const int* tout;  // [nb] end of the subtree interval
  const int* gptr;  // [nb + 1] CSR of {k : tout_k = t}, increasing k
  const int* gidx;
  int nb;
};

// A warp's contiguous run of branches [lo, hi): lane l takes branches
// lo + 32 c + l, so each load of a chunk of 32 is coalesced, and a branch
// belongs to the same thread in every pass.
struct Run {
  int lo, hi, lane, warp;
  __device__ explicit Run(int nb) {
    lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    const int per = ((nb + kWarps - 1) / kWarps + 31) / 32 * 32;
    lo = min(nb, warp * per);
    hi = min(nb, lo + per);
  }
};

// Sum over a warp of six values a lane (a fixed butterfly: every lane gets
// the same bits).
template <typename T>
__device__ __forceinline__ void warp_sum6(T (&x)[6]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < 6; ++c) x[c] += __shfl_xor_sync(kFull, x[c], o);
  }
}

// The warps' sums (sm [kWarps, 6], written by lane 0 of each warp before a
// barrier) added in warp order: `off` gets those of the warps before this
// one, `total` all of them.
template <typename T>
__device__ __forceinline__ void warp_offsets(const T* sm, int warp, T (&off)[6],
                                             T (&total)[6]) {
#pragma unroll
  for (int c = 0; c < 6; ++c) total[c] = T(0);
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) {
#pragma unroll
      for (int c = 0; c < 6; ++c) off[c] = total[c];
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) total[c] += sm[w * 6 + c];
  }
}

// Inclusive prefix over the warp's lanes of six values a lane; `last`
// gets lane 31's (the chunk's sum).
template <typename T>
__device__ __forceinline__ void warp_scan6(T (&x)[6], T (&last)[6], int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const T y = __shfl_up_sync(kFull, x[c], o);
      if (lane >= o) x[c] += y;
    }
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) last[c] = __shfl_sync(kFull, x[c], 31);
}

// Subtree sums: writes the exclusive prefix over all branches of x (six
// words a branch, read by `get`) to ps [nb + 1, 6] and returns after a
// barrier, so ps[tout_i] - ps[i] is readable by all.  Two walks of the
// run: the warp's sum, then, after the warps' sums, each chunk's scan on
// the carry.
template <typename T, typename Get>
__device__ __forceinline__ void prefix_exclusive(const Run& r, int nb, T* ps, T* sm,
                                                 Get get) {
  T acc[6] = {0, 0, 0, 0, 0, 0};
  for (int base = r.lo; base < r.hi; base += 32) {
    const int k = base + r.lane;
    if (k < r.hi) {
      T x[6];
      get(k, x);
#pragma unroll
      for (int c = 0; c < 6; ++c) acc[c] += x[c];
    }
  }
  warp_sum6(acc);
  if (r.lane == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c) sm[r.warp * 6 + c] = acc[c];
  }
  __syncthreads();
  T carry[6], tot[6];
  warp_offsets(sm, r.warp, carry, tot);
  for (int base = r.lo; base < r.hi; base += 32) {
    const int k = base + r.lane;
    T inc[6] = {0, 0, 0, 0, 0, 0}, last[6];
    if (k < r.hi) get(k, inc);
    warp_scan6(inc, last, r.lane);
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      T ex = __shfl_up_sync(kFull, inc[c], 1);
      if (r.lane == 0) ex = T(0);
      if (k < r.hi) ps[k * 6 + c] = carry[c] + ex;
      carry[c] += last[c];
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c) ps[(size_t)nb * 6 + c] = tot[c];
  }
  __syncthreads();
}

// Path sums of g [nb, 6] (written by every thread before a barrier): for
// each t of the run, y[t] = g[t] - sum_{tout_k = t} g[k] goes to ys, and
// `put(t, p)` gets the inclusive prefix p of y at t.
template <typename T, typename Put>
__device__ __forceinline__ void prefix_paths(const Run& r, const Tree<T>& tr,
                                             const T* g, T* ys, T* sm, Put put) {
  T acc[6] = {0, 0, 0, 0, 0, 0};
  for (int base = r.lo; base < r.hi; base += 32) {
    const int t = base + r.lane;
    if (t < r.hi) {
      T q[6] = {0, 0, 0, 0, 0, 0};
      for (int j = tr.gptr[t]; j < tr.gptr[t + 1]; ++j) {
        const int k = tr.gidx[j];
#pragma unroll
        for (int c = 0; c < 6; ++c) q[c] += g[k * 6 + c];
      }
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const T y = g[t * 6 + c] - q[c];
        ys[t * 6 + c] = y;
        acc[c] += y;
      }
    }
  }
  warp_sum6(acc);
  if (r.lane == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c) sm[r.warp * 6 + c] = acc[c];
  }
  __syncthreads();
  T carry[6], tot[6];
  warp_offsets(sm, r.warp, carry, tot);
  for (int base = r.lo; base < r.hi; base += 32) {
    const int t = base + r.lane;
    T inc[6] = {0, 0, 0, 0, 0, 0}, last[6];
    if (t < r.hi) {
#pragma unroll
      for (int c = 0; c < 6; ++c) inc[c] = ys[t * 6 + c];
    }
    warp_scan6(inc, last, r.lane);
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      inc[c] += carry[c];
      carry[c] += last[c];
    }
    if (t < r.hi) put(t, inc);
  }
}

template <typename T>
struct SolveArgs {
  const T* s_re;  // [B, nb, 3] loads, pu
  const T* s_im;
  const T* v0_re;  // [B, 3] source phasors
  const T* v0_im;
  Tree<T> tr;
  T* v_re;  // [B, nb, 3] out: v, i_br, i_load
  T* v_im;
  T* ib_re;
  T* ib_im;
  T* il_re;
  T* il_im;
  int* iters;  // [B] out
  T* resid;
  unsigned char* conv;
  T* saved;  // [max_iter, B, nb, 6] each iteration's input v (re3, im3), or null
  T* ps;     // scratch [B, nb + 1, 6]
  T* drop;   // scratch [B, nb, 6]
  int lanes, max_iter, fixed;
  T eps;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ladder_solve_kernel(SolveArgs<T> a) {
  __shared__ T sm_b[kWarps * 6];
  __shared__ T sm_f[kWarps * 6];
  __shared__ T sm_err[kWarps];
  const Tree<T>& tr = a.tr;
  const int b = blockIdx.x, nb = tr.nb;
  const Run r(nb);
  const size_t o3 = (size_t)b * nb * 3;
  const T* s_re = a.s_re + o3;
  const T* s_im = a.s_im + o3;
  T* v_re = a.v_re + o3;
  T* v_im = a.v_im + o3;
  T* ib_re = a.ib_re + o3;
  T* ib_im = a.ib_im + o3;
  T* il_re = a.il_re + o3;
  T* il_im = a.il_im + o3;
  T* ps = a.ps + (size_t)b * (nb + 1) * 6;
  T* drop = a.drop + (size_t)b * nb * 6;
  T v0r[3], v0i[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    v0r[p] = a.v0_re[b * 3 + p];
    v0i[p] = a.v0_im[b * 3 + p];
  }
  for (int k = r.lo + r.lane; k < r.hi; k += 32) {
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const T m = tr.mask[k * 3 + p];
      v_re[k * 3 + p] = v0r[p] * m;
      v_im[k * 3 + p] = v0i[p] * m;
      ib_re[k * 3 + p] = T(0);
      ib_im[k * 3 + p] = T(0);
      il_re[k * 3 + p] = T(0);
      il_im[k * 3 + p] = T(0);
    }
  }
  T err = T(INFINITY);
  int it = 0;
  while (it < a.max_iter && (a.fixed || err >= a.eps)) {
    if (a.saved != nullptr) {
      T* sv = a.saved + ((size_t)it * a.lanes + b) * nb * 6;
      for (int k = r.lo + r.lane; k < r.hi; k += 32) {
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          sv[k * 6 + p] = v_re[k * 3 + p];
          sv[k * 6 + 3 + p] = v_im[k * 3 + p];
        }
      }
    }
    // Load currents, then their subtree sums' prefix.
    for (int k = r.lo + r.lane; k < r.hi; k += 32) {
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const T vr = v_re[k * 3 + p], vi = v_im[k * 3 + p];
        const T sr = s_re[k * 3 + p], si = s_im[k * 3 + p];
        const T d = vr * vr + vi * vi;
        T lr = T(0), li = T(0);
        if (d > T(0)) {
          lr = (sr * vr + si * vi) / d;
          li = -((si * vr - sr * vi) / d);
        }
        il_re[k * 3 + p] = lr;
        il_im[k * 3 + p] = li;
      }
    }
    prefix_exclusive<T>(r, nb, ps, sm_b, [&](int k, T (&x)[6]) {
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        x[p] = il_re[k * 3 + p];
        x[3 + p] = il_im[k * 3 + p];
      }
    });
    // Branch currents, the root error, the drops.
    T emax = T(0);
    for (int i = r.lo + r.lane; i < r.hi; i += 32) {
      const int t = tr.tout[i];
      const T rt = tr.root[i];
      T br[3], bi[3];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        br[p] = ps[(size_t)t * 6 + p] - ps[i * 6 + p];
        bi[p] = ps[(size_t)t * 6 + 3 + p] - ps[i * 6 + 3 + p];
        const T dr = br[p] - ib_re[i * 3 + p], di = bi[p] - ib_im[i * 3 + p];
        emax = nan_max(emax, sqrt(dr * dr + di * di) * rt);
        ib_re[i * 3 + p] = br[p];
        ib_im[i * 3 + p] = bi[p];
      }
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        T dr = T(0), di = T(0);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const T zr = tr.z_re[i * 9 + q * 3 + p], zi = tr.z_im[i * 9 + q * 3 + p];
          dr += br[q] * zr - bi[q] * zi;
          di += br[q] * zi + bi[q] * zr;
        }
        drop[i * 6 + p] = dr;
        drop[i * 6 + 3 + p] = di;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) emax = nan_max(emax, __shfl_xor_sync(kFull, emax, o));
    if ((threadIdx.x & 31) == 0) sm_err[threadIdx.x >> 5] = emax;
    __syncthreads();
    err = sm_err[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) err = nan_max(err, sm_err[w]);
    // Path sums of the drops (ps is free again: its y rows), new voltages.
    prefix_paths<T>(r, tr, drop, ps, sm_f, [&](int t, const T (&path)[6]) {
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const T m = tr.mask[t * 3 + p];
        v_re[t * 3 + p] = (v0r[p] - path[p]) * m;
        v_im[t * 3 + p] = (v0i[p] - path[3 + p]) * m;
      }
    });
    ++it;
  }
  if (threadIdx.x == 0) {
    a.iters[b] = it;
    a.resid[b] = err;
    a.conv[b] = err < a.eps ? 1 : 0;
  }
}

template <typename T>
struct VjpArgs {
  const T* saved;  // [iters, B, nb, 6] each iteration's input v
  const T* s_re;   // [B, nb, 3]
  const T* s_im;
  Tree<T> tr;
  const T* gv_re;  // [B, nb, 3] cotangents of the final v, i_br, i_load
  const T* gv_im;
  const T* gb_re;
  const T* gb_im;
  const T* gl_re;
  const T* gl_im;
  T* sbar_re;  // [B, nb, 3] out
  T* sbar_im;
  T* ps;  // scratch [B, nb + 1, 6]
  T* w;   // scratch [B, nb, 6]: vbar
  T* g;   // scratch [B, nb, 6]: ibbar
  int lanes, iters;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ladder_vjp_kernel(VjpArgs<T> a) {
  __shared__ T sm_b[kWarps * 6];
  __shared__ T sm_f[kWarps * 6];
  const Tree<T>& tr = a.tr;
  const int b = blockIdx.x, nb = tr.nb;
  const Run r(nb);
  const size_t o3 = (size_t)b * nb * 3;
  const T* s_re = a.s_re + o3;
  const T* s_im = a.s_im + o3;
  T* sbar_re = a.sbar_re + o3;
  T* sbar_im = a.sbar_im + o3;
  T* ps = a.ps + (size_t)b * (nb + 1) * 6;
  T* w = a.w + (size_t)b * nb * 6;
  T* g = a.g + (size_t)b * nb * 6;
  for (int k = r.lo + r.lane; k < r.hi; k += 32) {
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      w[k * 6 + p] = a.gv_re[o3 + k * 3 + p];
      w[k * 6 + 3 + p] = a.gv_im[o3 + k * 3 + p];
      sbar_re[k * 3 + p] = T(0);
      sbar_im[k * 3 + p] = T(0);
    }
  }
  for (int it = a.iters - 1; it >= 0; --it) {
    const bool last = it == a.iters - 1;
    const T* vk = a.saved + ((size_t)it * a.lanes + b) * nb * 6;
    // dropbar = -B(mask vbar): the prefix of mask vbar.
    prefix_exclusive<T>(r, nb, ps, sm_b, [&](int k, T (&x)[6]) {
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const T m = tr.mask[k * 3 + p];
        x[p] = w[k * 6 + p] * m;
        x[3 + p] = w[k * 6 + 3 + p] * m;
      }
    });
    // ibbar = conj(z)^T dropbar (+ the final i_br's cotangent).
    for (int i = r.lo + r.lane; i < r.hi; i += 32) {
      const int t = tr.tout[i];
      T dr[3], di[3];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        dr[p] = -(ps[(size_t)t * 6 + p] - ps[i * 6 + p]);
        di[p] = -(ps[(size_t)t * 6 + 3 + p] - ps[i * 6 + 3 + p]);
      }
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        T gr = T(0), gi = T(0);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const T zr = tr.z_re[i * 9 + q * 3 + p], zi = tr.z_im[i * 9 + q * 3 + p];
          gr += zr * dr[p] + zi * di[p];
          gi += zr * di[p] - zi * dr[p];
        }
        if (last) {
          gr += a.gb_re[o3 + i * 3 + q];
          gi += a.gb_im[o3 + i * 3 + q];
        }
        g[i * 6 + q] = gr;
        g[i * 6 + 3 + q] = gi;
      }
    }
    __syncthreads();
    // ilbar = F(ibbar) (+ the final i_load's cotangent); the load-current
    // derivative in real pairs on live phases.
    prefix_paths<T>(r, tr, g, ps, sm_f, [&](int t, const T (&path)[6]) {
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        T lr = path[p], li = path[3 + p];
        if (last) {
          lr += a.gl_re[o3 + t * 3 + p];
          li += a.gl_im[o3 + t * 3 + p];
        }
        const T vr = vk[t * 6 + p], vi = vk[t * 6 + 3 + p];
        const T d = vr * vr + vi * vi;
        T wr = T(0), wi = T(0);
        if (d > T(0)) {
          // sbar += conj(ilbar / v)
          sbar_re[t * 3 + p] += (lr * vr + li * vi) / d;
          sbar_im[t * 3 + p] += -((li * vr - lr * vi) / d);
          // vbar = conj(-(s ilbar) / v^2)
          const T sr = s_re[t * 3 + p], si = s_im[t * 3 + p];
          const T pr = -(sr * lr - si * li), pi = -(sr * li + si * lr);
          const T v2r = vr * vr - vi * vi, v2i = vr * vi + vi * vr;
          const T d2 = v2r * v2r + v2i * v2i;
          wr = (pr * v2r + pi * v2i) / d2;
          wi = -((pi * v2r - pr * v2i) / d2);
        }
        w[t * 6 + p] = wr;
        w[t * 6 + 3 + p] = wi;
      }
    });
  }
}

}  // namespace

template <typename T>
static Tree<T> make_tree(const T* mask, const T* z_re, const T* z_im, const T* root,
                         const int* tout, const int* gptr, const int* gidx, int nb) {
  return Tree<T>{mask, z_re, z_im, root, tout, gptr, gidx, nb};
}

template <typename T>
static int ladder_solve(const T* s_re, const T* s_im, const T* v0_re, const T* v0_im,
                        const T* mask, const T* z_re, const T* z_im, const T* root,
                        const int* tout, const int* gptr, const int* gidx, T* v_re,
                        T* v_im, T* ib_re, T* ib_im, T* il_re, T* il_im, int* iters,
                        T* resid, unsigned char* conv, T* saved, T* ps, T* drop,
                        int nb, int lanes, int max_iter, int fixed, double eps,
                        void* stream) {
  if (nb <= 0 || lanes <= 0 || max_iter < 0) return (int)cudaErrorInvalidValue;
  SolveArgs<T> a{s_re, s_im, v0_re, v0_im,
                 make_tree<T>(mask, z_re, z_im, root, tout, gptr, gidx, nb),
                 v_re, v_im, ib_re, ib_im, il_re, il_im, iters, resid, conv,
                 saved, ps, drop, lanes, max_iter, fixed, (T)eps};
  ladder_solve_kernel<T><<<(unsigned)lanes, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
static int ladder_vjp(const T* saved, const T* s_re, const T* s_im, const T* mask,
                      const T* z_re, const T* z_im, const int* tout, const int* gptr,
                      const int* gidx, const T* gv_re, const T* gv_im, const T* gb_re,
                      const T* gb_im, const T* gl_re, const T* gl_im, T* sbar_re,
                      T* sbar_im, T* ps, T* w, T* g, int nb, int lanes, int iters,
                      void* stream) {
  if (nb <= 0 || lanes <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  VjpArgs<T> a{saved, s_re, s_im,
               make_tree<T>(mask, z_re, z_im, nullptr, tout, gptr, gidx, nb),
               gv_re, gv_im, gb_re, gb_im, gl_re, gl_im, sbar_re, sbar_im, ps, w, g,
               lanes, iters};
  ladder_vjp_kernel<T><<<(unsigned)lanes, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#define LADDER_ENTRY(SUFFIX, T)                                                     \
  extern "C" int ladder_solve_##SUFFIX(                                             \
      const T* s_re, const T* s_im, const T* v0_re, const T* v0_im, const T* mask, \
      const T* z_re, const T* z_im, const T* root, const int* tout,                \
      const int* gptr, const int* gidx, T* v_re, T* v_im, T* ib_re, T* ib_im,      \
      T* il_re, T* il_im, int* iters, T* resid, unsigned char* conv, T* saved,     \
      T* ps, T* drop, int nb, int lanes, int max_iter, int fixed, double eps,      \
      void* stream) {                                                              \
    return ladder_solve<T>(s_re, s_im, v0_re, v0_im, mask, z_re, z_im, root, tout, \
                           gptr, gidx, v_re, v_im, ib_re, ib_im, il_re, il_im,     \
                           iters, resid, conv, saved, ps, drop, nb, lanes,         \
                           max_iter, fixed, eps, stream);                          \
  }                                                                                \
  extern "C" int ladder_vjp_##SUFFIX(                                               \
      const T* saved, const T* s_re, const T* s_im, const T* mask, const T* z_re,  \
      const T* z_im, const int* tout, const int* gptr, const int* gidx,            \
      const T* gv_re, const T* gv_im, const T* gb_re, const T* gb_im,              \
      const T* gl_re, const T* gl_im, T* sbar_re, T* sbar_im, T* ps, T* w, T* g,   \
      int nb, int lanes, int iters, void* stream) {                                \
    return ladder_vjp<T>(saved, s_re, s_im, mask, z_re, z_im, tout, gptr, gidx,   \
                         gv_re, gv_im, gb_re, gb_im, gl_re, gl_im, sbar_re,        \
                         sbar_im, ps, w, g, nb, lanes, iters, stream);             \
  }

LADDER_ENTRY(f64, double)
LADDER_ENTRY(f32, float)
