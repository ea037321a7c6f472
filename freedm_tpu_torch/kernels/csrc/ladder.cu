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
//   no gradient (ladder.py:148-157).  The source phasors v0 enter every
//   iteration's v0 - path and the initial iterate v0 mask, so their
//   cotangent v0bar [B, 3] sums mask vbar over the branches for each walked
//   iteration and for the initial iterate: the total of the subtree sums'
//   prefix, added in a fixed order.
//
// L3 ladder_dense, the same iteration on the dense sweeps, lives in
//   csrc/ladder_dense.cu.
//
// L4 ladder_doubling — the same on :60 `doubling_sweeps`: ceil(log2 levels)
//   rounds, the subtree sums a scatter-add into each branch's 2^m-th
//   ancestor, the path sums a gather from it, a sentinel slot nb for the
//   roots.  A whole solve (or reverse mode) is one launch.  The scatter-add
//   is a gather-sum over host-built preimage lists {i : jump_m[i] = a}, i
//   ascending — the order of the plain version's index_add, no atomics —
//   and every operation, forward and reverse, is written with __d*_rn /
//   __f*_rn in the plain version's order (ladder_doubling_plain,
//   ladder_doubling_vjp_plain; v0bar the roots' subtree sums, roots in
//   increasing order), so L4 gives the plain version's bits in float64
//   and float32.  Two routes, by ladder_kernels.doubling_plan from (nb,
//   dtype): a lane a thread-block cluster (its rows dealt to the CTAs in
//   blocks of 32, the two round buffers in distributed shared memory, a
//   cluster barrier between rounds, a preimage list longer than kHeavyRow
//   a warp's — its rows gathered 32 at a time, then added one at a time
//   by six lanes — from a host-built plan, ladder_kernels.heavy_rows), or,
//   below the measured crossover and above the cluster capacity, one CTA a
//   lane with its [nb + 1, 6] state double-buffered in device scratch.
//
// Design of L1 and L2: two routes each, chosen by ladder_kernels.
//   ladder_plan from (nb, dtype) alone, so a lane's result is the same bits
//   whatever the lanes beside it.  L2's cluster route is L1's shape with
//   L1's two scans swapped (ladder_vjp_cluster_kernel).
//
//   Cluster route (up to 20,480 branches in float64, 32,768 in float32;
//   ladder_kernels.cluster_capacity): one lane is one thread-block cluster,
//   the smallest whose CTAs fit the dtype's thread cap and shared memory
//   (at 10k branches 8 CTAs of 640 threads in float64, 5 of 1024 in
//   float32: two or three clusters a GPC, 15 / 22 lanes at once on an
//   H100).  CTA r owns the
//   preorder interval [r per, (r + 1) per), two branches a thread.  The
//   lane's state lives in the cluster's shared memory, three [6, 2 threads]
//   buffers a CTA (v, the drops, the CTA's prefix), beside the CTA's group
//   members {k : tout_k in its interval}, staged once; the previous i_br
//   lives in a device scratch in the CTAs' row layout, as z does (a warp
//   reads a row contiguously).  An iteration:
//     1. i_load of the thread's branches (s from device memory, v from
//        shared memory); the CTA's exclusive scan (a shuffle scan a warp,
//        then warp 0's scan of the warps' sums) into `ps`, its interval sum
//        into a slot; cluster barrier;
//     2. warp 0 adds the ranks' slots by a shuffle scan over the ranks (the
//        offsets: the same bits in every CTA); i_br = P[tout_i] - P[i],
//        P[tout_i] read from the owning CTA's `ps` (distributed shared
//        memory, mapa); the root error; the drop into `drop`; barrier;
//     3. y = drop[t] - the sum of drop[k] over tout_k = t: the CTA's staged
//        members' drops gathered two a thread (remote ones through
//        distributed shared memory), their CTA prefix G, a group's sum
//        G[end] - G[start] (balanced however the groups fall); the CTA's
//        scan of y, its interval sum and error max into slots; barrier;
//     4. warp 0 adds the ranks' slots and takes the lane's error (every
//        rank's, NaN kept); v' = (v0 - path) mask into `v`.
//   Three cluster barriers an iteration; every sum in a fixed order, no
//   atomics.  The lane's error is known to every CTA before the loop test
//   (`solve` mode exits on the device, cluster-uniform); i_load is
//   written in the last iteration only, recomputed from that iteration's
//   v.  i_br on a dead phase (mask 0: the phase is dead in the whole
//   subtree) is an exact zero, not a difference of two prefixes.  Lanes
//   beyond the resident clusters run in waves.  A thread's loads are
//   issued in batches its registers hold before any is used: one at a
//   time, each costs an L2 round trip (~12k cycles an iteration for the
//   previous i_br alone, measured).
//
//   Global route (larger nb): one CTA of up to 512 threads a lane (below
//   512 branches ceil(nb / 32) warps, the runs 16 warps would take), the lane's
//   state in device memory (the port's first form).  Each warp owns a contiguous
//   run of branches and walks it in chunks of 32, a branch a lane, so every
//   load is coalesced and a branch stays with one thread in every pass.  A
//   prefix is two walks of the run: the warp's sum, then, after the warps'
//   sums (added in warp order), each chunk's shuffle scan on the running
//   carry.  The groups {k : tout_k = t} come from the host as CSR in
//   increasing k.  An iteration is seven walks of the run and four
//   barriers.  Its state is 2.4 MB a lane at 10k buses in float64, so 64
//   lanes (154 MB) do not stay in the 50 MB L2.
//
// Bound of L4 (chip_smoke.py phase 28 (c)): the function's own
//   operations, L1's a branch and iteration.  What holds L4 back is
//   latency: 2R dependent rounds an iteration, each a cluster barrier and
//   a distributed-shared-memory gather (one-CTA route: 2R + 4 passes
//   through L2 on one SM); late rounds cost several times the first
//   (%globaltimer stamps in a lab copy: the longest preimage lists'
//   gathers and the many rows that read one ancestor).
//
// Bounds on an H100 SXM (3.35 TB/s; 34 / 67 TFLOP/s fp64 / fp32 outside the
//   tensor cores).  At synthetic_radial(10000) x 64 lanes, 20 iterations,
//   float64: the loads read once (31 MB) and v, i_br, i_load written once
//   (92 MB), 37 us; ~171 operations a branch and iteration (a complex
//   division a phase, two scans, the 3 x 3 drop), 2.2 GFLOP, 64 us:
//   operations.  What holds both routes back is latency, not bytes or
//   operations: a chain of dependent steps an iteration.  The cluster route
//   puts that chain in shared memory across C SMs a lane; the global route
//   walks it from L2 on one SM a lane.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// The global route's widest CTA.  A CTA of fewer warps (global_threads in
// ladder_kernels: ceil(nb / 32) warps below 512 branches) cuts the same
// runs of 32 branches as 16 warps do and leaves out only warps whose runs
// are empty, whose sums are zeros added last: the same bits, and more
// lanes at once.
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
    const int nw = blockDim.x >> 5;
    const int per = ((nb + nw - 1) / nw + 31) / 32 * 32;
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

// The warps' sums (sm [warps, 6], written by lane 0 of each warp before a
// barrier) added in warp order: `off` gets those of the warps before this
// one, `total` all of them.
template <typename T>
__device__ __forceinline__ void warp_offsets(const T* sm, int warp, T (&off)[6],
                                             T (&total)[6]) {
#pragma unroll
  for (int c = 0; c < 6; ++c) total[c] = T(0);
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
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
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) err = nan_max(err, sm_err[w]);
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
  T* v0bar;  // [B, 6] out: the source phasors' cotangent (re3, im3)
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
  // mask vbar, the input of the subtree sums; their total is the source
  // phasors' share of vbar (v0 enters every iteration's v0 - path and the
  // initial iterate v0 mask).
  const auto masked = [&](int k, T (&x)[6]) {
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const T m = tr.mask[k * 3 + p];
      x[p] = w[k * 6 + p] * m;
      x[3 + p] = w[k * 6 + 3 + p] * m;
    }
  };
  T v0acc[6] = {0, 0, 0, 0, 0, 0};
  for (int it = a.iters - 1; it >= 0; --it) {
    const bool last = it == a.iters - 1;
    const T* vk = a.saved + ((size_t)it * a.lanes + b) * nb * 6;
    // dropbar = -B(mask vbar): the prefix of mask vbar, its total in ps[nb].
    prefix_exclusive<T>(r, nb, ps, sm_b, masked);
#pragma unroll
    for (int c = 0; c < 6; ++c) v0acc[c] += ps[(size_t)nb * 6 + c];
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
  prefix_exclusive<T>(r, nb, ps, sm_b, masked);  // the initial iterate's share
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c) a.v0bar[b * 6 + c] = v0acc[c] + ps[(size_t)nb * 6 + c];
  }
}

// ---------------------------------------------------------------------------
// L1's cluster route
// ---------------------------------------------------------------------------

// ladder_kernels.py reads these for ladder_plan: keep each a
// `constexpr int name = value;`.  Threads a CTA at most (two branches
// each) by dtype: a thread's register budget is 65536 / threads, and a
// float64 thread spills below ~100 (at 1024 threads, 64 registers, 300
// bytes).  Measured on an H100 at 10k branches x 64 lanes, 20 iterations:
// float64 on 7 CTAs of 736 threads 3.18 ms, 8 of 640 2.93 ms (15 clusters
// at once either way), 9 of 576 4.12 ms (9 at once); float32 on 5 CTAs of
// 1024 1.52 ms (22 at once), 6 of 864 1.74, 8 of 640 1.79.
constexpr int kCtaThreadsF64 = 640;
constexpr int kCtaThreadsF32 = 1024;
constexpr int kMaxCluster = 16;     // CTAs a lane at most (above 8: non-portable)
constexpr int kScratchWords = 464;  // shared words beside the three [6, ld] buffers
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may take (227 KB)

// The scratch after the buffers, in words of T.
constexpr int kWsum = 0;  // [33][6]: the warps' sums, then their offsets; row 32 the CTA's total
constexpr int kWmax = kWsum + 33 * 6;                  // [32] the warps' error maxima
constexpr int kOffA = kWmax + 32;                       // [kMaxCluster + 1][6]
constexpr int kOffC = kOffA + (kMaxCluster + 1) * 6;  // [kMaxCluster + 1][6]
constexpr int kSlotA = kOffC + (kMaxCluster + 1) * 6;  // [6] the interval sum of i_load
constexpr int kSlotC = kSlotA + 6;  // [6] the interval sum of y
constexpr int kSlotE = kSlotC + 6;  // [1] the CTA's error max
constexpr int kErrB = kSlotE + 1;   // [1] the lane's error
constexpr int kV0 = kErrB + 1;      // [6] the lane's source phasors
constexpr int kSlotG = kV0 + 6;     // [6] the CTA's total of its members' drops
static_assert(kSlotG + 6 <= kScratchWords, "the scratch fits kScratchWords");

template <typename T>
struct CtaMax {
  static constexpr int threads = sizeof(T) == 8 ? kCtaThreadsF64 : kCtaThreadsF32;
};

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// i_load of one branch from its v (six words at v[c * ld], SoA) and its
// loads s (three phases): conj(s / v) on live phases.
template <typename T>
__device__ __forceinline__ void load_current(const T* v, int ld,
                                             const T (&s_re)[3],
                                             const T (&s_im)[3], T (&x)[6]) {
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const T vr = v[p * ld], vi = v[(3 + p) * ld];
    const T sr = s_re[p], si = s_im[p];
    const T d = vr * vr + vi * vi;
    T lr = T(0), li = T(0);
    if (d > T(0)) {
      lr = (sr * vr + si * vi) / d;
      li = -((si * vr - sr * vi) / d);
    }
    x[p] = lr;
    x[3 + p] = li;
  }
}

// Exclusive prefix over the CTA's threads of six values a thread, in a
// fixed order (a shuffle scan in each warp, then warp 0's scan of the
// warps' sums), in place; thread 0 writes the CTA's total to `total`.
// With `emax`, the CTA's max of it (NaN kept) goes to *emax_out as well.
// Two CTA barriers.
template <typename T, bool kMax>
__device__ __forceinline__ void cta_scan6(T (&x)[6], T* scr, T* total,
                                          T emax = T(0),
                                          T* emax_out = nullptr) {
  T* wsum = scr + kWsum;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  T inc[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) inc[c] = x[c];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const T y = __shfl_up_sync(kFull, inc[c], o);
      if (lane >= o) inc[c] += y;
    }
  }
  if (kMax) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) emax = nan_max(emax, __shfl_xor_sync(kFull, emax, o));
  }
  if (lane == 31) {
#pragma unroll
    for (int c = 0; c < 6; ++c) wsum[warp * 6 + c] = inc[c];
  }
  if (kMax && lane == 0) scr[kWmax + warp] = emax;
  __syncthreads();
  if (warp == 0) {
    T w[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) w[c] = lane < nw ? wsum[lane * 6 + c] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const T y = __shfl_up_sync(kFull, w[c], o);
        if (lane >= o) w[c] += y;
      }
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      T e = __shfl_up_sync(kFull, w[c], 1);
      if (lane == 0) e = T(0);
      if (lane < nw) wsum[lane * 6 + c] = e;
      if (lane == 31) wsum[32 * 6 + c] = w[c];
    }
    if (kMax) {
      T m = lane < nw ? scr[kWmax + lane] : T(0);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = nan_max(m, __shfl_xor_sync(kFull, m, o));
      if (lane == 0) *emax_out = m;
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    T e = __shfl_up_sync(kFull, inc[c], 1);
    if (lane == 0) e = T(0);
    x[c] = wsum[warp * 6 + c] + e;
    if (threadIdx.x == 0) total[c] = wsum[32 * 6 + c];
  }
}

// Warp 0: the ranks' six-word slots in rank order, by a shuffle scan over
// the ranks (a fixed tree: the same bits in every CTA); off[r] gets the
// sum of the ranks below r, off[C] the lane's total.  With `slot_e`, the
// ranks' error maxima too (NaN kept): returned to every lane.
template <typename T>
__device__ __forceinline__ T rank_offsets(cg::cluster_group& cl, T* slot,
                                          T* off, int C,
                                          T* slot_e = nullptr) {
  const int lane = threadIdx.x & 31;
  T run[6];
  T e = T(0);
  if (lane < C) {
    const T* src = cl.map_shared_rank(slot, lane);
#pragma unroll
    for (int c = 0; c < 6; ++c) run[c] = src[c];
    if (slot_e != nullptr) e = *cl.map_shared_rank(slot_e, lane);
  } else {
#pragma unroll
    for (int c = 0; c < 6; ++c) run[c] = T(0);
  }
#pragma unroll
  for (int o = 1; o < kMaxCluster; o <<= 1) {
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const T y = __shfl_up_sync(kFull, run[c], o);
      if (lane >= o) run[c] += y;
    }
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    T ex = __shfl_up_sync(kFull, run[c], 1);
    if (lane == 0) ex = T(0);
    if (lane < C) off[lane * 6 + c] = ex;
    if (lane == C - 1) off[C * 6 + c] = run[c];
  }
  if (slot_e != nullptr) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) e = nan_max(e, __shfl_xor_sync(kFull, e, o));
  }
  return e;
}

// y of local branch 2t + u: its drop less the sum of its group's drops,
// G[g1] - G[g0] over the staged members (G, the CTA's exclusive prefix of
// their drops, in ps; G[ld] in `gtotal`) plus the members past them, one
// at a time; 0 for a branch the thread does not own.
template <typename T>
__device__ __forceinline__ void branch_y(cg::cluster_group& cl, int u, bool own,
                                         int g0, int g1, int gcount, int gbase,
                                         int ld, int per, int rank, int t,
                                         const T* ps_s, T* drop_s,
                                         const T* gtotal, const int* gidx,
                                         T (&y)[6]) {
  const int e0 = min(g0, gcount), e1 = min(g1, gcount);
  T q[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const T ge = e1 == ld ? gtotal[c] : ps_s[c * ld + e1];
    const T gb = e0 == ld ? gtotal[c] : ps_s[c * ld + e0];
    q[c] = e1 > e0 ? ge - gb : T(0);
  }
  for (int j = max(g0, gcount); j < g1; ++j) {  // past the staged members
    const int k = __ldg(gidx + gbase + j);
    const int rk = k / per;
    const T* src = rk == rank ? drop_s : cl.map_shared_rank(drop_s, rk);
#pragma unroll
    for (int c = 0; c < 6; ++c) q[c] += src[c * ld + k - rk * per];
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) y[c] = own ? drop_s[c * ld + 2 * t + u] - q[c] : T(0);
}

// One lane a cluster of C = gridDim.x / lanes CTAs; CTA `rank` owns the
// branches [rank per, min(nb, (rank + 1) per)), local branches 2t and
// 2t + 1 on thread t (a buffer's row `ld` = 2 blockDim.x).  Rows of width
// W = C ld hold a word a branch in the CTAs' local order (branch i of rank r
// at r ld + i - r per), so a warp's reads of a row are contiguous: z, zt
// [2][9][W] (re, im; entry 3 q + p), and the previous i_br, a scratch ibp
// [lanes][6][W].
template <typename T>
__global__ void __launch_bounds__(CtaMax<T>::threads, 1)
    ladder_cluster_kernel(SolveArgs<T> a, const T* __restrict__ zt,
                          T* __restrict__ ibp_all, int per) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = 2 * blockDim.x;
  T* v_s = reinterpret_cast<T*>(smem_raw);  // [6][ld] each
  T* drop_s = v_s + 6 * ld;
  T* ps_s = v_s + 12 * ld;
  T* scr = v_s + 18 * ld;
  int* grp_s = reinterpret_cast<int*>(scr + kScratchWords);  // [ld]
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int64_t b = blockIdx.x / C;
  const Tree<T>& tr = a.tr;
  const int nb = tr.nb;
  const int lo = rank * per, hi = min(nb, lo + per);
  // The CTA's slice of the group members {k : tout_k in [lo, hi)}, in
  // (t, k) order; its first ld entries staged here (a tree with more reads
  // the rest from device memory, one member at a time).
  const int gbase = tr.gptr[lo];
  const int gcount = min(tr.gptr[hi] - gbase, ld);
  for (int j = threadIdx.x; j < gcount; j += blockDim.x) grp_s[j] = tr.gidx[gbase + j];
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const size_t o3 = (size_t)b * nb * 3;
  const size_t wrow = (size_t)C * ld;               // a row of zt and ibp
  const size_t slot = (size_t)rank * ld + 2 * t;    // the thread's pair in it
  T* ibp = ibp_all + (size_t)b * 6 * wrow;
  // The two branches' tree constants, read once; the phase masks and
  // root flags (0 or 1) as bits: live phase p of branch u at bit 3u + p,
  // root at bit 6 + u.
  bool own[2];
  int tout[2], g0[2], g1[2];  // the group's members [g0, g1), from gbase
  unsigned bits = 0;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = lo + 2 * t + u;
    own[u] = i < hi;
    tout[u] = nb;
    g0[u] = g1[u] = 0;
    if (own[u]) {
      tout[u] = tr.tout[i];
      g0[u] = tr.gptr[i] - gbase;
      g1[u] = tr.gptr[i + 1] - gbase;
      if (tr.root[i] > T(0)) bits |= 1u << (6 + u);
#pragma unroll
      for (int p = 0; p < 3; ++p)
        if (tr.mask[i * 3 + p] > T(0)) bits |= 1u << (3 * u + p);
    }
  }
  if (t < 6) scr[kV0 + t] = t < 3 ? a.v0_re[b * 3 + t] : a.v0_im[b * 3 + t - 3];
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 6; ++c) ibp[c * wrow + slot] = ibp[c * wrow + slot + 1] = T(0);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (!own[u]) continue;
    const size_t k = o3 + (size_t)(lo + 2 * t + u) * 3;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const T m = (bits >> (3 * u + p)) & 1u ? T(1) : T(0);
      v_s[p * ld + 2 * t + u] = scr[kV0 + p] * m;
      v_s[(3 + p) * ld + 2 * t + u] = scr[kV0 + 3 + p] * m;
      if (a.max_iter == 0) {
        a.il_re[k + p] = T(0);
        a.il_im[k + p] = T(0);
      }
    }
  }
  T err = T(INFINITY);
  int it = 0;
  while (it < a.max_iter && (a.fixed || err >= a.eps)) {
    if (a.saved != nullptr) {
      T* sv = a.saved + ((size_t)it * a.lanes + b) * nb * 6;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (!own[u]) continue;
#pragma unroll
        for (int c = 0; c < 6; ++c)
          sv[(size_t)(lo + 2 * t + u) * 6 + c] = v_s[c * ld + 2 * t + u];
      }
    }
    // 1. Load currents; the CTA's exclusive prefix of them into ps (the
    //    first branch's current parked there meanwhile).  Both branches'
    //    loads are issued before either is used.
    T sre[2][3], sim[2][3];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const size_t k = o3 + (size_t)min(lo + 2 * t + u, nb - 1) * 3;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        sre[u][p] = __ldg(a.s_re + k + p);
        sim[u][p] = __ldg(a.s_im + k + p);
      }
    }
    T x[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      T xu[6];
      load_current<T>(v_s + 2 * t + u, ld, sre[u], sim[u], xu);
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        if (!own[u]) xu[c] = T(0);
        if (u == 0) ps_s[c * ld + 2 * t] = xu[c];
        x[c] += xu[c];
      }
    }
    cta_scan6<T, false>(x, scr, scr + kSlotA);
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      ps_s[c * ld + 2 * t + 1] = x[c] + ps_s[c * ld + 2 * t];
      ps_s[c * ld + 2 * t] = x[c];
    }
    cluster_sync_all();  // every CTA's prefix and interval sum are out
    // 2. Branch currents (the previous ones from the output), the root
    //    error, the drops, once warp 0 has added the interval sums.
    if (warp == 0) rank_offsets<T>(cl, scr + kSlotA, scr + kOffA, C);
    __syncthreads();  // the offsets are out
    T emax = T(0);
#pragma unroll 1
    for (int u = 0; u < 2; ++u) {
      const int r_t = tout[u] < nb ? tout[u] / per : C;  // C: P[nb], the total
      const T* src = r_t == rank || r_t == C ? ps_s : cl.map_shared_rank(ps_s, r_t);
      const int l_t = r_t < C ? tout[u] - r_t * per : 0;
      T br[6], prev[6];  // P at tout_i (then i_br), the previous i_br
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        br[c] = src[c * ld + l_t];
        prev[c] = ibp[c * wrow + slot + u];
      }
      const T* oi = scr + kOffA + rank * 6;
      const T* ot = scr + kOffA + r_t * 6;
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const T pi = ps_s[c * ld + 2 * t + u];
        // P[tout_i] - P[i]: within the CTA the offsets cancel exactly; a
        // dead phase is dead in the whole subtree, its current an exact 0.
        const T d = r_t == rank ? br[c] - pi
                    : r_t == C   ? ot[c] - (oi[c] + pi)
                                 : (ot[c] + br[c]) - (oi[c] + pi);
        br[c] = own[u] && (bits >> (3 * u + c % 3)) & 1u ? d : T(0);
        ibp[c * wrow + slot + u] = br[c];
      }
      const T rt = (bits >> (6 + u)) & 1u ? T(1) : T(0);
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const T dr = br[p] - prev[p], di = br[3 + p] - prev[3 + p];
        emax = nan_max(emax, sqrt(dr * dr + di * di) * rt);
      }
      // The drops, a column of z at a time (the pair's other half is the
      // other branch's, from L1 when its turn comes).
#pragma unroll 1
      for (int p = 0; p < 3; ++p) {
        T zr[3], zi[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          zr[q] = __ldg(zt + (size_t)(q * 3 + p) * wrow + slot + u);
          zi[q] = __ldg(zt + (size_t)(9 + q * 3 + p) * wrow + slot + u);
        }
        T dr = T(0), di = T(0);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          dr += br[q] * zr[q] - br[3 + q] * zi[q];
          di += br[q] * zi[q] + br[3 + q] * zr[q];
        }
        drop_s[p * ld + 2 * t + u] = dr;
        drop_s[(3 + p) * ld + 2 * t + u] = di;
      }
    }
    cluster_sync_all();  // every CTA's drops are out
    // 3. y = drop[t] - the sum of the group's drops (tout_k = t).  The
    //    CTA's staged members, two a thread: their drops gathered (in this
    //    CTA or another) in one batch, then the CTA's exclusive prefix G of
    //    them into ps (free now), so a group's sum is G[g1] - G[g0], G[ld]
    //    the total (members past the staged ones, in a tree that has them,
    //    added one at a time).  Then the CTA's prefix of y, its error max
    //    beside it.
    T gsum[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
    T g0v[6];
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const int j = 2 * t + w;
      T gw[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      if (j < gcount) {
        const int k = grp_s[j];
        const int rk = k / per;
        const T* src = rk == rank ? drop_s : cl.map_shared_rank(drop_s, rk);
#pragma unroll
        for (int c = 0; c < 6; ++c) gw[c] = src[c * ld + k - rk * per];
      }
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        if (w == 0) g0v[c] = gw[c];
        gsum[c] += gw[c];
      }
    }
    cta_scan6<T, false>(gsum, scr, scr + kSlotG);
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      ps_s[c * ld + 2 * t] = gsum[c];
      ps_s[c * ld + 2 * t + 1] = gsum[c] + g0v[c];
    }
    __syncthreads();  // G is out (its total in the kSlotG slot)
    T y[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
    T yp[2][6];  // each branch's y, parked in ps once every G is read
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      branch_y<T>(cl, u, own[u], g0[u], g1[u], gcount, gbase, ld, per, rank,
                  t, ps_s, drop_s, scr + kSlotG, tr.gidx, yp[u]);
#pragma unroll
      for (int c = 0; c < 6; ++c) y[c] += yp[u][c];
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      ps_s[c * ld + 2 * t] = yp[0][c];
      ps_s[c * ld + 2 * t + 1] = yp[1][c];
    }
    cta_scan6<T, true>(y, scr, scr + kSlotC, emax, scr + kSlotE);
#pragma unroll
    for (int c = 0; c < 6; ++c) {  // the CTA's inclusive prefix of y
      const T p0 = y[c] + ps_s[c * ld + 2 * t];
      ps_s[c * ld + 2 * t + 1] = p0 + ps_s[c * ld + 2 * t + 1];
      ps_s[c * ld + 2 * t] = p0;
    }
    cluster_sync_all();  // every CTA's interval sum of y and error are out
    // 4. The lane's error (every rank's), the path sums, the new voltages.
    if (warp == 0) {
      const T e = rank_offsets<T>(cl, scr + kSlotC, scr + kOffC, C, scr + kSlotE);
      if (t == 0) scr[kErrB] = e;
    }
    __syncthreads();
    err = scr[kErrB];
    const bool last = it + 1 >= a.max_iter || (!a.fixed && !(err >= a.eps));
    const T* oc = scr + kOffC + rank * 6;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (!own[u]) continue;
      const int l = 2 * t + u;
      const size_t k = o3 + (size_t)(lo + l) * 3;
      if (last) {  // this iteration's i_load, from its input v
        T sr[3], si[3], il[6];
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          sr[p] = __ldg(a.s_re + k + p);
          si[p] = __ldg(a.s_im + k + p);
        }
        load_current<T>(v_s + l, ld, sr, si, il);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          a.il_re[k + p] = il[p];
          a.il_im[k + p] = il[3 + p];
        }
      }
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const T m = (bits >> (3 * u + p)) & 1u ? T(1) : T(0);
        v_s[p * ld + l] = (scr[kV0 + p] - (oc[p] + ps_s[p * ld + l])) * m;
        v_s[(3 + p) * ld + l] =
            (scr[kV0 + 3 + p] - (oc[3 + p] + ps_s[(3 + p) * ld + l])) * m;
      }
    }
    ++it;
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (!own[u]) continue;
    const size_t k = o3 + (size_t)(lo + 2 * t + u) * 3;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      a.v_re[k + p] = v_s[p * ld + 2 * t + u];
      a.v_im[k + p] = v_s[(3 + p) * ld + 2 * t + u];
      a.ib_re[k + p] = ibp[p * wrow + slot + u];
      a.ib_im[k + p] = ibp[(3 + p) * wrow + slot + u];
    }
  }
  if (rank == 0 && t == 0) {
    a.iters[b] = it;
    a.resid[b] = err;
    a.conv[b] = err < a.eps ? 1 : 0;
  }
  cluster_sync_all();  // no CTA leaves while another may read its slots
}

// ---------------------------------------------------------------------------
// L2's cluster route
// ---------------------------------------------------------------------------

// L2 on L1's cluster shape (the same CTAs, branch intervals and shared
// memory; z in the same row layout), one lane a cluster.  Its three [6, ld]
// buffers: `gw` holds a branch's vbar from step 4 to the next step 1 and
// its ibbar from step 2 to step 3 (vbar is read by its own thread alone,
// ibbar by the groups' gathers), `sb` the loads' cotangent, added to there
// and written out once at the end, `ps` the CTA's prefixes.  Walking the
// saved iterates backwards, an iteration:
//   1. x = mask vbar of the thread's branches; the CTA's exclusive scan
//      into ps, its interval sum into a slot; cluster barrier;
//   2. warp 0 adds the ranks' slots in rank order (their total is v0's
//      share of the iteration); dropbar = -(P[tout_i] - P[i]) (an exact 0
//      on a dead phase), ibbar = conj(z)^T dropbar (+ the final i_br's
//      cotangent) into gw; cluster barrier;
//   3. y = ibbar[t] less its group's ibbar (L1's step 3); the CTA's scan of
//      y; the iteration's saved v and the loads issued into registers, so
//      the only stream is in flight across the barrier; cluster barrier;
//   4. ilbar = the rank's offset + the CTA prefix (+ the final i_load's
//      cotangent); sbar += conj(ilbar / v) and vbar = -conj(s ilbar / v^2)
//      on live phases, 0 on dead ones.
// Three cluster barriers an iteration, no atomics: every sum in a fixed
// order (a warp's shuffle scan, then the warps, then the ranks), so a lane
// gives the same bits in a launch of any width.
template <typename T>
__global__ void __launch_bounds__(CtaMax<T>::threads, 1)
    ladder_vjp_cluster_kernel(VjpArgs<T> a, const T* __restrict__ zt, int per) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = 2 * blockDim.x;
  T* gw_s = reinterpret_cast<T*>(smem_raw);  // [6][ld] each
  T* sb_s = gw_s + 6 * ld;
  T* ps_s = gw_s + 12 * ld;
  T* scr = gw_s + 18 * ld;
  int* grp_s = reinterpret_cast<int*>(scr + kScratchWords);  // [ld]
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int64_t b = blockIdx.x / C;
  const Tree<T>& tr = a.tr;
  const int nb = tr.nb;
  const int lo = rank * per, hi = min(nb, lo + per);
  const int gbase = tr.gptr[lo];
  const int gcount = min(tr.gptr[hi] - gbase, ld);
  for (int j = threadIdx.x; j < gcount; j += blockDim.x) grp_s[j] = tr.gidx[gbase + j];
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const size_t o3 = (size_t)b * nb * 3;
  const size_t wrow = (size_t)C * ld;
  const size_t slot = (size_t)rank * ld + 2 * t;
  bool own[2];
  int tout[2], g0[2], g1[2];
  unsigned bits = 0;  // live phase p of branch u at bit 3u + p
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = lo + 2 * t + u;
    own[u] = i < hi;
    tout[u] = nb;
    g0[u] = g1[u] = 0;
    if (own[u]) {
      tout[u] = tr.tout[i];
      g0[u] = tr.gptr[i] - gbase;
      g1[u] = tr.gptr[i + 1] - gbase;
#pragma unroll
      for (int p = 0; p < 3; ++p)
        if (tr.mask[i * 3 + p] > T(0)) bits |= 1u << (3 * u + p);
    }
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const size_t k = o3 + (size_t)min(i, nb - 1) * 3 + p;
      gw_s[p * ld + 2 * t + u] = own[u] ? a.gv_re[k] : T(0);
      gw_s[(3 + p) * ld + 2 * t + u] = own[u] ? a.gv_im[k] : T(0);
      sb_s[p * ld + 2 * t + u] = sb_s[(3 + p) * ld + 2 * t + u] = T(0);
    }
  }
  if (t < 6) scr[kV0 + t] = T(0);  // v0bar, added to in rank order
  __syncthreads();
  // x = mask vbar of the thread's branches (the first parked in ps), and
  // their sum.
  const auto masked = [&](T (&x)[6]) {
#pragma unroll
    for (int c = 0; c < 6; ++c) x[c] = T(0);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const T m = (bits >> (3 * u + c % 3)) & 1u ? T(1) : T(0);
        const T xu = gw_s[c * ld + 2 * t + u] * m;
        if (u == 0) ps_s[c * ld + 2 * t] = xu;
        x[c] += xu;
      }
    }
  };
  for (int it = a.iters - 1; it >= 0; --it) {
    const bool last = it == a.iters - 1;
    const T* vk = a.saved + ((size_t)it * a.lanes + b) * nb * 6;
    // 1. The CTA's exclusive prefix of mask vbar into ps.
    T x[6];
    masked(x);
    cta_scan6<T, false>(x, scr, scr + kSlotA);
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      ps_s[c * ld + 2 * t + 1] = x[c] + ps_s[c * ld + 2 * t];
      ps_s[c * ld + 2 * t] = x[c];
    }
    cluster_sync_all();  // every CTA's prefix and interval sum are out
    // 2. dropbar from the subtree sums, ibbar = conj(z)^T dropbar.
    if (warp == 0) rank_offsets<T>(cl, scr + kSlotA, scr + kOffA, C);
    __syncthreads();  // the offsets are out
    if (t < 6) scr[kV0 + t] += scr[kOffA + C * 6 + t];
#pragma unroll 1
    for (int u = 0; u < 2; ++u) {
      const int r_t = tout[u] < nb ? tout[u] / per : C;  // C: P[nb], the total
      const T* src = r_t == rank || r_t == C ? ps_s : cl.map_shared_rank(ps_s, r_t);
      const int l_t = r_t < C ? tout[u] - r_t * per : 0;
      T db[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) db[c] = src[c * ld + l_t];
      const T* oi = scr + kOffA + rank * 6;
      const T* ot = scr + kOffA + r_t * 6;
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const T pi = ps_s[c * ld + 2 * t + u];
        const T d = r_t == rank ? db[c] - pi
                    : r_t == C   ? ot[c] - (oi[c] + pi)
                                 : (ot[c] + db[c]) - (oi[c] + pi);
        db[c] = own[u] && (bits >> (3 * u + c % 3)) & 1u ? -d : T(0);
      }
      const size_t k = o3 + (size_t)min(lo + 2 * t + u, nb - 1) * 3;
#pragma unroll 1
      for (int q = 0; q < 3; ++q) {
        T zr[3], zi[3];
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          zr[p] = __ldg(zt + (size_t)(q * 3 + p) * wrow + slot + u);
          zi[p] = __ldg(zt + (size_t)(9 + q * 3 + p) * wrow + slot + u);
        }
        T gr = T(0), gi = T(0);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          gr += zr[p] * db[p] + zi[p] * db[3 + p];
          gi += zr[p] * db[3 + p] - zi[p] * db[p];
        }
        if (last && own[u]) {
          gr += a.gb_re[k + q];
          gi += a.gb_im[k + q];
        }
        gw_s[q * ld + 2 * t + u] = gr;
        gw_s[(3 + q) * ld + 2 * t + u] = gi;
      }
    }
    cluster_sync_all();  // every CTA's ibbar is out
    // 3. y = ibbar[t] - the sum of its group's ibbar (L1's step 3 on gw),
    //    then the CTA's prefix of y.
    T gsum[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
    T g0v[6];
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const int j = 2 * t + w;
      T gv[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      if (j < gcount) {
        const int k = grp_s[j];
        const int rk = k / per;
        const T* src = rk == rank ? gw_s : cl.map_shared_rank(gw_s, rk);
#pragma unroll
        for (int c = 0; c < 6; ++c) gv[c] = src[c * ld + k - rk * per];
      }
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        if (w == 0) g0v[c] = gv[c];
        gsum[c] += gv[c];
      }
    }
    cta_scan6<T, false>(gsum, scr, scr + kSlotG);
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      ps_s[c * ld + 2 * t] = gsum[c];
      ps_s[c * ld + 2 * t + 1] = gsum[c] + g0v[c];
    }
    __syncthreads();  // G is out (its total in the kSlotG slot)
    T y[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
    T yp[2][6];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      branch_y<T>(cl, u, own[u], g0[u], g1[u], gcount, gbase, ld, per, rank,
                  t, ps_s, gw_s, scr + kSlotG, tr.gidx, yp[u]);
#pragma unroll
      for (int c = 0; c < 6; ++c) y[c] += yp[u][c];
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      ps_s[c * ld + 2 * t] = yp[0][c];
      ps_s[c * ld + 2 * t + 1] = yp[1][c];
    }
    cta_scan6<T, false>(y, scr, scr + kSlotC);
#pragma unroll
    for (int c = 0; c < 6; ++c) {  // the CTA's inclusive prefix of y
      const T p0 = y[c] + ps_s[c * ld + 2 * t];
      ps_s[c * ld + 2 * t + 1] = p0 + ps_s[c * ld + 2 * t + 1];
      ps_s[c * ld + 2 * t] = p0;
    }
    // The iteration's saved v and the loads, for step 4: in flight across
    // the barrier.
    T vv[2][6], sv[2][6];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const size_t i = (size_t)min(lo + 2 * t + u, nb - 1);
#pragma unroll
      for (int c = 0; c < 6; ++c) vv[u][c] = __ldg(vk + i * 6 + c);
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        sv[u][p] = __ldg(a.s_re + o3 + i * 3 + p);
        sv[u][3 + p] = __ldg(a.s_im + o3 + i * 3 + p);
      }
    }
    cluster_sync_all();  // every CTA's interval sum of y is out
    // 4. ilbar; the loads' cotangent and the next vbar.
    if (warp == 0) rank_offsets<T>(cl, scr + kSlotC, scr + kOffC, C);
    __syncthreads();
    const T* oc = scr + kOffC + rank * 6;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (!own[u]) continue;
      const int l = 2 * t + u;
      const size_t k = o3 + (size_t)(lo + l) * 3;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        T lr = oc[p] + ps_s[p * ld + l], li = oc[3 + p] + ps_s[(3 + p) * ld + l];
        if (last) {
          lr += a.gl_re[k + p];
          li += a.gl_im[k + p];
        }
        const T vr = vv[u][p], vi = vv[u][3 + p];
        const T d = vr * vr + vi * vi;
        T wr = T(0), wi = T(0);
        if (d > T(0)) {
          sb_s[p * ld + l] += (lr * vr + li * vi) / d;
          sb_s[(3 + p) * ld + l] += -((li * vr - lr * vi) / d);
          const T sr = sv[u][p], si = sv[u][3 + p];
          const T pr = -(sr * lr - si * li), pi = -(sr * li + si * lr);
          const T v2r = vr * vr - vi * vi, v2i = vr * vi + vi * vr;
          const T d2 = v2r * v2r + v2i * v2i;
          wr = (pr * v2r + pi * v2i) / d2;
          wi = -((pi * v2r - pr * v2i) / d2);
        }
        gw_s[p * ld + l] = wr;
        gw_s[(3 + p) * ld + l] = wi;
      }
    }
  }
  // The initial iterate's share: the lane's total of mask vbar.
  T x[6];
  masked(x);
  cta_scan6<T, false>(x, scr, scr + kSlotA);
  cluster_sync_all();
  if (warp == 0) rank_offsets<T>(cl, scr + kSlotA, scr + kOffA, C);
  __syncthreads();
  if (rank == 0 && t < 6) a.v0bar[b * 6 + t] = scr[kV0 + t] + scr[kOffA + C * 6 + t];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (!own[u]) continue;
    const size_t k = o3 + (size_t)(lo + 2 * t + u) * 3;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      a.sbar_re[k + p] = sb_s[p * ld + 2 * t + u];
      a.sbar_im[k + p] = sb_s[(3 + p) * ld + 2 * t + u];
    }
  }
  cluster_sync_all();  // no CTA leaves while another may read its slots
}

// ---------------------------------------------------------------------------
// Exact rounding (no contraction), for L4's forward arithmetic
// ---------------------------------------------------------------------------

__device__ __forceinline__ double add_rn(double x, double y) { return __dadd_rn(x, y); }
__device__ __forceinline__ float add_rn(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ double sub_rn(double x, double y) { return __dsub_rn(x, y); }
__device__ __forceinline__ float sub_rn(float x, float y) { return __fsub_rn(x, y); }
__device__ __forceinline__ double mul_rn(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ float mul_rn(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ double div_rn(double x, double y) { return __ddiv_rn(x, y); }
__device__ __forceinline__ float div_rn(float x, float y) { return __fdiv_rn(x, y); }
__device__ __forceinline__ double sqrt_rn(double x) { return __dsqrt_rn(x); }
__device__ __forceinline__ float sqrt_rn(float x) { return __fsqrt_rn(x); }

// ---------------------------------------------------------------------------
// L4 ladder_doubling
// ---------------------------------------------------------------------------

// The one-CTA route's widest CTA (128 registers a thread); below 511
// branches ceil((nb + 1) / 32) warps (ladder_kernels.doubling_plan): a
// row's sums are its thread's whatever the CTA's width, so the same bits.
constexpr int kDoublingThreads = 512;
// ladder_kernels.py reads these for doubling_plan: keep each a
// `constexpr int name = value;`.  A preimage list longer than kHeavyRow
// takes a warp (a thread a row below it); a warp stages a batch of 32
// rows' values in [6][kStageLd] words (33: the six adding lanes read six
// banks); the cluster route's scratch words beside its buffers and stages.
constexpr int kHeavyRow = 8;
constexpr int kStageLd = 33;
constexpr int kDoublingScratchWords = 48;

// The cluster route's scratch, in words of T.
constexpr int kDWmax = 0;           // [32] the warps' error maxima
constexpr int kDSlotE = kDWmax + 32;  // [1] the CTA's error max
constexpr int kDErr = kDSlotE + 1;    // [1] the lane's error
constexpr int kDV0 = kDErr + 1;       // [6] the source phasors, or v0bar
static_assert(kDV0 + 6 <= kDoublingScratchWords, "the scratch fits");

template <typename T>
struct DoublingArgs {
  const T* mask;  // [nb, 3]
  const T* z_re;  // [nb, 3, 3]
  const T* z_im;
  const T* root;       // [nb]
  const int* jump;     // [rounds, nb + 1] round m's 2^m-th ancestor (nb: none)
  const int* pre_ptr;  // [rounds, nb + 1] CSR (absolute) of {i < nb : jump_m[i] = a}
  const int* pre_idx;  //   in increasing i
  const int* heavy_ptr;  // [rounds, cluster, warps + 1] each warp's heavy rows
  const int* heavy_idx;  //   (the cluster route's)
  const int* roots;      // [n_roots] the roots, increasing
  const T* s_re;       // [B, nb, 3] loads, pu
  const T* s_im;
  const T* v0_re;  // [B, 3]
  const T* v0_im;
  T* v_re;  // [B, nb, 3] the state and the outputs: v, i_br, i_load
  T* v_im;
  T* ib_re;
  T* ib_im;
  T* il_re;
  T* il_im;
  int* iters;  // [B] out
  T* resid;
  unsigned char* conv;
  T* saved;  // [max_iter, B, nb, 6] each iteration's input v, or null
  T* buf;    // [B, 2, nb + 1, 6] scratch: the rounds' two buffers (one-CTA route)
  // The reverse mode.
  const T* gv_re;
  const T* gv_im;
  const T* gb_re;
  const T* gb_im;
  const T* gl_re;
  const T* gl_im;
  T* sbar_re;  // [B, nb, 3] out
  T* sbar_im;
  T* v0bar;  // [B, 6] out
  T* w;      // [B, nb, 6] scratch: vbar (one-CTA route)
  int nb, rounds, n_roots, lanes, max_iter, fixed;
  T eps;
};

// Lanes 0-5 of a warp hold a row's component `lane` in acc; this adds to
// it the rows idx[j0, j1) in increasing order, each add rounded on its own
// (the plain version's order), and returns it.  The rows' values come in
// batches of 32, a row a lane (`row(i, v)` reads row i), through the
// warp's stage, the next batch's loads in flight while six lanes add: only
// the adds are serial.  Every lane of the warp calls it.
template <typename T, typename Row>
__device__ __forceinline__ T warp_ordered_sum(T acc, const int* __restrict__ idx, int j0,
                                              int j1, T* stage, Row row) {
  const int lane = threadIdx.x & 31;
  T v[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  int j = j0;
  if (j + lane < j1) row(__ldg(idx + j + lane), v);
  while (j < j1) {
    const int n = min(32, j1 - j);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 6; ++c) stage[c * kStageLd + lane] = v[c];
    __syncwarp();
    j += 32;
    if (j + lane < j1) row(__ldg(idx + j + lane), v);
    if (lane < 6) {  // eight loads in flight before their adds, in order
      const T* s = stage + lane * kStageLd;
      int k = 0;
      for (; k + 8 <= n; k += 8) {
        T r[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) r[q] = s[k + q];
#pragma unroll
        for (int q = 0; q < 8; ++q) acc = add_rn(acc, r[q]);
      }
      for (; k < n; ++k) acc = add_rn(acc, s[k]);
    }
  }
  __syncwarp();
  return acc;
}

// One round of the subtree sums: y[a] = x[a] plus the x[i] with jump_m[i]
// = a, added in increasing i (the order of the plain version's index_add);
// y[nb] = 0.  x and y are distinct buffers (__restrict__), so the
// compiler may issue an unrolled batch of rows' loads before their stores:
// a row at a time, each is an L2 round trip.
template <typename T>
__device__ __forceinline__ void subtree_round(const T* __restrict__ x, T* __restrict__ y,
                                              const int* __restrict__ ptr,
                                              const int* __restrict__ idx, int nb) {
#pragma unroll 4
  for (int i = threadIdx.x; i <= nb; i += blockDim.x) {
    T acc[6] = {0, 0, 0, 0, 0, 0};
    if (i < nb) {
#pragma unroll
      for (int c = 0; c < 6; ++c) acc[c] = x[(size_t)i * 6 + c];
      // Four preimages' loads in flight before their adds, which stay in
      // increasing i (a list is hundreds deep in the last rounds at 10k).
      const int hi = ptr[i + 1];
      int j = ptr[i];
      for (; j + 4 <= hi; j += 4) {
        T v[4][6];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const size_t q = (size_t)idx[j + u] * 6;
#pragma unroll
          for (int c = 0; c < 6; ++c) v[u][c] = x[q + c];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int c = 0; c < 6; ++c) acc[c] = add_rn(acc[c], v[u][c]);
        }
      }
      for (; j < hi; ++j) {
        const size_t q = (size_t)idx[j] * 6;
#pragma unroll
        for (int c = 0; c < 6; ++c) acc[c] = add_rn(acc[c], x[q + c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) y[(size_t)i * 6 + c] = acc[c];
  }
}

// One round of the path sums: y[a] = x[a] + x[jump_m[a]] (the sentinel's
// zero above a root; y[nb] = 0 + 0).
template <typename T>
__device__ __forceinline__ void path_round(const T* __restrict__ x, T* __restrict__ y,
                                           const int* __restrict__ jm, int nb) {
#pragma unroll 4
  for (int i = threadIdx.x; i <= nb; i += blockDim.x) {
    const size_t q = (size_t)jm[i] * 6;
#pragma unroll
    for (int c = 0; c < 6; ++c) y[(size_t)i * 6 + c] = add_rn(x[(size_t)i * 6 + c], x[q + c]);
  }
}

// Subtree sums of x [nb + 1, 6] (row nb zero) by the doubling rounds into
// the other buffer y and back; returns the buffer that holds them.
template <typename T>
__device__ T* doubling_subtree(const DoublingArgs<T>& a, T* x, T* y) {
  for (int m = 0; m < a.rounds; ++m) {
    subtree_round<T>(x, y, a.pre_ptr + (size_t)m * (a.nb + 1), a.pre_idx, a.nb);
    __syncthreads();
    T* s = x;
    x = y;
    y = s;
  }
  return x;
}

// Path sums of x [nb + 1, 6] (row nb zero) by the doubling rounds: round m
// adds the value of the 2^m-th ancestor; returns the buffer that holds
// them.
template <typename T>
__device__ T* doubling_path(const DoublingArgs<T>& a, T* x, T* y) {
  for (int m = 0; m < a.rounds; ++m) {
    path_round<T>(x, y, a.jump + (size_t)m * (a.nb + 1), a.nb);
    __syncthreads();
    T* s = x;
    x = y;
    y = s;
  }
  return x;
}

// The block's max of one value a thread (NaN kept), in every thread.
template <typename T>
__device__ __forceinline__ T block_max(T v, T* sm) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(kFull, v, o));
  if ((threadIdx.x & 31) == 0) sm[threadIdx.x >> 5] = v;
  __syncthreads();
  T m = sm[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = nan_max(m, sm[w]);
  __syncthreads();
  return m;
}

// The drops of one branch: sum_q i_br[q] z[q, p] as the plain version's
// four real products, each summed over q in increasing order.
template <typename T>
__device__ __forceinline__ void drop_rn(const T (&br)[6], const T* zr, const T* zi,
                                        T (&out)[6]) {
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const T rr = add_rn(add_rn(mul_rn(br[0], zr[p]), mul_rn(br[1], zr[3 + p])),
                        mul_rn(br[2], zr[6 + p]));
    const T ii = add_rn(add_rn(mul_rn(br[3], zi[p]), mul_rn(br[4], zi[3 + p])),
                        mul_rn(br[5], zi[6 + p]));
    const T ri = add_rn(add_rn(mul_rn(br[0], zi[p]), mul_rn(br[1], zi[3 + p])),
                        mul_rn(br[2], zi[6 + p]));
    const T ir = add_rn(add_rn(mul_rn(br[3], zr[p]), mul_rn(br[4], zr[3 + p])),
                        mul_rn(br[5], zr[6 + p]));
    out[p] = sub_rn(rr, ii);
    out[3 + p] = add_rn(ri, ir);
  }
}

// ibbar = conj(z)^T dropbar of one branch, with dropbar = -sub: the four
// real products sum_p z[q, p] d[p], each summed over p in increasing order
// (ladder_kernels.conj_zt_ordered's order).
template <typename T>
__device__ __forceinline__ void conj_zt_rn(const T (&sub)[6], const T* zr, const T* zi,
                                           T (&out)[6]) {
  T d[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) d[c] = -sub[c];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const T* r = zr + 3 * q;
    const T* m = zi + 3 * q;
    const T rr = add_rn(add_rn(mul_rn(d[0], r[0]), mul_rn(d[1], r[1])), mul_rn(d[2], r[2]));
    const T ii = add_rn(add_rn(mul_rn(d[3], m[0]), mul_rn(d[4], m[1])), mul_rn(d[5], m[2]));
    const T ri = add_rn(add_rn(mul_rn(d[3], r[0]), mul_rn(d[4], r[1])), mul_rn(d[5], r[2]));
    const T ir = add_rn(add_rn(mul_rn(d[0], m[0]), mul_rn(d[1], m[1])), mul_rn(d[2], m[2]));
    out[q] = add_rn(rr, ii);
    out[3 + q] = sub_rn(ri, ir);
  }
}

// One phase of the reverse mode's last step, in the plain version's
// operations: from ilbar (lr, li), the iteration's v and the load s, the
// loads' cotangent term conj(ilbar / v) and the next vbar = conj(-(s ilbar)
// / v^2), both 0 on a dead phase.
template <typename T>
__device__ __forceinline__ void load_adjoint_rn(T lr, T li, T vr, T vi, T sr, T si,
                                                T& tr, T& ti, T& wr, T& wi) {
  const T d = add_rn(mul_rn(vr, vr), mul_rn(vi, vi));
  tr = ti = wr = wi = T(0);
  if (d > T(0)) {
    tr = div_rn(add_rn(mul_rn(lr, vr), mul_rn(li, vi)), d);
    ti = -div_rn(sub_rn(mul_rn(li, vr), mul_rn(lr, vi)), d);
    const T pr = -sub_rn(mul_rn(sr, lr), mul_rn(si, li));
    const T pi = -add_rn(mul_rn(sr, li), mul_rn(si, lr));
    const T v2r = sub_rn(mul_rn(vr, vr), mul_rn(vi, vi));
    const T v2i = add_rn(mul_rn(vr, vi), mul_rn(vi, vr));
    const T d2 = add_rn(mul_rn(v2r, v2r), mul_rn(v2i, v2i));
    wr = div_rn(add_rn(mul_rn(pr, v2r), mul_rn(pi, v2i)), d2);
    wi = -div_rn(sub_rn(mul_rn(pi, v2r), mul_rn(pr, v2i)), d2);
  }
}

// i_load of one phase, conj(s / v) on a live phase, in the plain version's
// operations.
template <typename T>
__device__ __forceinline__ void load_current_rn(T vr, T vi, T sr, T si, T& lr, T& li) {
  const T d = add_rn(mul_rn(vr, vr), mul_rn(vi, vi));
  lr = li = T(0);
  if (d > T(0)) {
    lr = div_rn(add_rn(mul_rn(sr, vr), mul_rn(si, vi)), d);
    li = -div_rn(sub_rn(mul_rn(si, vr), mul_rn(sr, vi)), d);
  }
}

// A whole solve of one lane a CTA, in the plain version's operations and
// order, each rounded on its own (the plain version's bits).
template <typename T>
__global__ void __launch_bounds__(kDoublingThreads, 1) ladder_doubling_kernel(const DoublingArgs<T> a) {
  __shared__ T sm[32];
  const int b = blockIdx.x, nb = a.nb, n3 = nb * 3;
  const int tid = threadIdx.x, bd = blockDim.x;
  const size_t o3 = (size_t)b * n3;
  const T* s_re = a.s_re + o3;
  const T* s_im = a.s_im + o3;
  T* v_re = a.v_re + o3;
  T* v_im = a.v_im + o3;
  T* ib_re = a.ib_re + o3;
  T* ib_im = a.ib_im + o3;
  T* il_re = a.il_re + o3;
  T* il_im = a.il_im + o3;
  T* x = a.buf + (size_t)b * 2 * (nb + 1) * 6;
  T* y = x + (size_t)(nb + 1) * 6;
  T v0r[3], v0i[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    v0r[p] = a.v0_re[b * 3 + p];
    v0i[p] = a.v0_im[b * 3 + p];
  }
  for (int i = tid; i < n3; i += bd) {
    const T m = a.mask[i];
    v_re[i] = mul_rn(v0r[i % 3], m);
    v_im[i] = mul_rn(v0i[i % 3], m);
    ib_re[i] = ib_im[i] = il_re[i] = il_im[i] = T(0);
  }
  __syncthreads();
  T err = T(INFINITY);
  int it = 0;
  while (it < a.max_iter && (a.fixed || err >= a.eps)) {
    if (a.saved != nullptr) {
      T* sv = a.saved + ((size_t)it * a.lanes + b) * nb * 6;
      for (int i = tid; i < n3; i += bd) {
        sv[(i / 3) * 6 + i % 3] = v_re[i];
        sv[(i / 3) * 6 + 3 + i % 3] = v_im[i];
      }
    }
    // Load currents conj(s / v) on live phases, into x.
    for (int i = tid; i <= nb; i += bd) {
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        T lr = T(0), li = T(0);
        if (i < nb) {
          load_current_rn(v_re[i * 3 + p], v_im[i * 3 + p], s_re[i * 3 + p],
                          s_im[i * 3 + p], lr, li);
          il_re[i * 3 + p] = lr;
          il_im[i * 3 + p] = li;
        }
        x[(size_t)i * 6 + p] = lr;
        x[(size_t)i * 6 + 3 + p] = li;
      }
    }
    __syncthreads();
    T* br_buf = doubling_subtree(a, x, y);
    T* dr_buf = br_buf == x ? y : x;
    // Branch currents, the root error, the drops (sum over q in order).
    T emax = T(0);
    for (int i = tid; i <= nb; i += bd) {
      T out[6] = {0, 0, 0, 0, 0, 0};
      if (i < nb) {
        const T rt = a.root[i];
        T br[6];
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          br[p] = br_buf[(size_t)i * 6 + p];
          br[3 + p] = br_buf[(size_t)i * 6 + 3 + p];
          const T dr = sub_rn(br[p], ib_re[i * 3 + p]);
          const T di = sub_rn(br[3 + p], ib_im[i * 3 + p]);
          emax = nan_max(emax, mul_rn(sqrt_rn(add_rn(mul_rn(dr, dr), mul_rn(di, di))), rt));
          ib_re[i * 3 + p] = br[p];
          ib_im[i * 3 + p] = br[3 + p];
        }
        drop_rn(br, a.z_re + i * 9, a.z_im + i * 9, out);
      }
#pragma unroll
      for (int c = 0; c < 6; ++c) dr_buf[(size_t)i * 6 + c] = out[c];
    }
    err = block_max(emax, sm);
    const T* path = doubling_path(a, dr_buf, br_buf);
    for (int i = tid; i < n3; i += bd) {
      const int row = i / 3, p = i % 3;
      const T m = a.mask[i];
      v_re[i] = mul_rn(sub_rn(v0r[p], path[(size_t)row * 6 + p]), m);
      v_im[i] = mul_rn(sub_rn(v0i[p], path[(size_t)row * 6 + 3 + p]), m);
    }
    __syncthreads();
    ++it;
  }
  if (tid == 0) {
    a.iters[b] = it;
    a.resid[b] = err;
    a.conv[b] = err < a.eps ? 1 : 0;
  }
}

// L4's reverse mode, one lane a CTA: L2's recurrence on the doubling
// sweeps in the plain version's operations and order (its bits); v0bar
// adds each walked iteration's subtree sums at the roots, roots in
// increasing order, then the initial iterate's.
template <typename T>
__global__ void __launch_bounds__(kDoublingThreads, 1)
    ladder_doubling_vjp_kernel(const DoublingArgs<T> a) {
  __shared__ T stage[6 * kStageLd];
  __shared__ T v0s[6];
  const int b = blockIdx.x, nb = a.nb, n3 = nb * 3;
  const int tid = threadIdx.x, bd = blockDim.x, lane = tid & 31;
  const size_t o3 = (size_t)b * n3;
  T* x = a.buf + (size_t)b * 2 * (nb + 1) * 6;
  T* y = x + (size_t)(nb + 1) * 6;
  T* w = a.w + (size_t)b * nb * 6;
  T* sbar_re = a.sbar_re + o3;
  T* sbar_im = a.sbar_im + o3;
  for (int i = tid; i < n3; i += bd) {
    w[(i / 3) * 6 + i % 3] = a.gv_re[o3 + i];
    w[(i / 3) * 6 + 3 + i % 3] = a.gv_im[o3 + i];
    sbar_re[i] = sbar_im[i] = T(0);
  }
  if (tid < 6) v0s[tid] = T(0);
  __syncthreads();
  // x = mask vbar (row nb zero), then its subtree sums; warp 0 adds those
  // of the roots to v0s.
  const auto subtree_of_masked = [&]() -> T* {
    for (int i = tid; i <= nb; i += bd) {
#pragma unroll
      for (int c = 0; c < 6; ++c)
        x[(size_t)i * 6 + c] = i < nb ? mul_rn(w[(size_t)i * 6 + c], a.mask[i * 3 + c % 3]) : T(0);
    }
    __syncthreads();
    T* sub = doubling_subtree(a, x, y);
    if (tid < 32) {
      const T t = warp_ordered_sum(T(0), a.roots, 0, a.n_roots, stage,
                                   [&](int i, T (&v)[6]) {
#pragma unroll
                                     for (int c = 0; c < 6; ++c) v[c] = sub[(size_t)i * 6 + c];
                                   });
      if (lane < 6) v0s[lane] = add_rn(v0s[lane], t);
    }
    return sub;
  };
  for (int k = a.max_iter - 1; k >= 0; --k) {
    const bool last = k == a.max_iter - 1;
    const T* vk = a.saved + ((size_t)k * a.lanes + b) * nb * 6;
    // dropbar = -B(mask vbar); ibbar = conj(z)^T dropbar (+ the final
    // i_br's cotangent).
    T* sub = subtree_of_masked();
    T* gbuf = sub == x ? y : x;
    for (int i = tid; i <= nb; i += bd) {
      T out[6] = {0, 0, 0, 0, 0, 0};
      if (i < nb) {
        T sv[6];
#pragma unroll
        for (int c = 0; c < 6; ++c) sv[c] = sub[(size_t)i * 6 + c];
        conj_zt_rn(sv, a.z_re + i * 9, a.z_im + i * 9, out);
        if (last) {
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            out[q] = add_rn(out[q], a.gb_re[o3 + i * 3 + q]);
            out[3 + q] = add_rn(out[3 + q], a.gb_im[o3 + i * 3 + q]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 6; ++c) gbuf[(size_t)i * 6 + c] = out[c];
    }
    __syncthreads();
    // ilbar = F(ibbar) (+ the final i_load's cotangent); sbar and vbar.
    const T* path = doubling_path(a, gbuf, sub);
    for (int i = tid; i < nb; i += bd) {
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        T lr = path[(size_t)i * 6 + p], li = path[(size_t)i * 6 + 3 + p];
        if (last) {
          lr = add_rn(lr, a.gl_re[o3 + i * 3 + p]);
          li = add_rn(li, a.gl_im[o3 + i * 3 + p]);
        }
        T tr, ti, wr, wi;
        load_adjoint_rn(lr, li, vk[(size_t)i * 6 + p], vk[(size_t)i * 6 + 3 + p],
                        a.s_re[o3 + i * 3 + p], a.s_im[o3 + i * 3 + p], tr, ti, wr, wi);
        sbar_re[i * 3 + p] = add_rn(sbar_re[i * 3 + p], tr);
        sbar_im[i * 3 + p] = add_rn(sbar_im[i * 3 + p], ti);
        w[(size_t)i * 6 + p] = wr;
        w[(size_t)i * 6 + 3 + p] = wi;
      }
    }
    __syncthreads();
  }
  subtree_of_masked();  // the initial iterate v0 mask
  if (tid < 6) a.v0bar[b * 6 + tid] = v0s[tid];
}

// ---------------------------------------------------------------------------
// L4's cluster route
// ---------------------------------------------------------------------------

// One lane a cluster of C CTAs.  The rows are dealt in blocks of 32: row
// a lies in CTA (a / 32) % C, at local row 32 (a / 32C) + a % 32
// (row_at, local_of), so a warp's lanes hold 32 consecutive rows (its
// device-memory accesses coalesce) while a feeder's top rows — the
// longest preimage lists, and the ancestors every late path round reads —
// spread over all C SMs (contiguous intervals put 166 of round 4's 188
// long lists and most of the late rounds' reads on CTA 0 at 10k
// branches: its rounds were by far the slowest).  Local rows l = t and t +
// blockDim.x are thread t's.  A CTA's shared memory holds two round
// buffers and a third of thread-private rows, each [ld][6] (ld = 2
// blockDim.x >= 32 ceil(nb / 32C)), one stage a warp and the scratch; the
// sentinel row nb is never stored: it reads 0.  Another CTA's row is read
// through distributed shared memory (mapa).

// The row at local row l of CTA `rank`, and a row's local row in its CTA.
__device__ __forceinline__ int row_at(int l, int rank, int C) {
  return ((l >> 5) * C + rank) * 32 + (l & 31);
}

__device__ __forceinline__ int local_of(int i, int C) {
  return (((i >> 5) / C) << 5) | (i & 31);
}

// A row's six words, contiguous (a buffer is [ld][6]): three 16-byte
// loads in float64, three 8-byte ones in float32 — one request a pair
// where a remote row is read through distributed shared memory, whose
// requests, not its bytes, bound a round (six 8-byte loads a row in a
// [6][ld] layout took 4-9 us a round at 10k branches).
__device__ __forceinline__ void load_row(const double* p, double (&v)[6]) {
  const double2* q = reinterpret_cast<const double2*>(p);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double2 w = q[k];
    v[2 * k] = w.x;
    v[2 * k + 1] = w.y;
  }
}

__device__ __forceinline__ void load_row(const float* p, float (&v)[6]) {
  const float2* q = reinterpret_cast<const float2*>(p);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float2 w = q[k];
    v[2 * k] = w.x;
    v[2 * k + 1] = w.y;
  }
}

__device__ __forceinline__ void store_row(double* p, const double (&v)[6]) {
  double2* q = reinterpret_cast<double2*>(p);
#pragma unroll
  for (int k = 0; k < 3; ++k) q[k] = make_double2(v[2 * k], v[2 * k + 1]);
}

__device__ __forceinline__ void store_row(float* p, const float (&v)[6]) {
  float2* q = reinterpret_cast<float2*>(p);
#pragma unroll
  for (int k = 0; k < 3; ++k) q[k] = make_float2(v[2 * k], v[2 * k + 1]);
}

// The CTA that holds row i and i's local row there.
template <typename T>
__device__ __forceinline__ const T* row_of(cg::cluster_group& cl, T* buf, int i, int C,
                                           int rank, int& local) {
  const int r = (i >> 5) % C;
  local = local_of(i, C);
  return r == rank ? buf : cl.map_shared_rank(buf, r);
}

// A subtree round of the cluster route: y[a] = x[a] plus its preimages'
// x in increasing i, for the CTA's rows.  A row whose list is at most
// kHeavyRow long is its thread's (four preimages' loads in flight before
// their adds; the bounds pj of its two rows' lists loaded a round ahead);
// a longer one is a warp's, from the host-built plan hp [warps + 1] into
// hidx (warp_ordered_sum).  The adds of a row stay in increasing i, each
// rounded on its own: the plain version's bits.
template <typename T>
__device__ __forceinline__ void subtree_round_cl(cg::cluster_group& cl, T* x, T* y,
                                                 const int* __restrict__ ptr,
                                                 const int* __restrict__ idx,
                                                 const int* __restrict__ hp,
                                                 const int* __restrict__ hidx, int C,
                                                 int nb, int rank, int ld, T* stage,
                                                 const int (&pj)[2][2]) {
  const int t = threadIdx.x;
#pragma unroll 1
  for (int u = 0; u < 2; ++u) {
    const int l = t + u * blockDim.x;
    if (row_at(l, rank, C) >= nb) continue;
    int j = pj[u][0];
    const int j1 = pj[u][1];
    if (j1 - j > kHeavyRow) continue;
    T acc[6];
    load_row(x + l * 6, acc);
    for (; j + 4 <= j1; j += 4) {
      T v[4][6];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int li;
        const T* src = row_of(cl, x, __ldg(idx + j + k), C, rank, li);
        load_row(src + li * 6, v[k]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int c = 0; c < 6; ++c) acc[c] = add_rn(acc[c], v[k][c]);
      }
    }
    for (; j < j1; ++j) {
      int li;
      T v[6];
      const T* src = row_of(cl, x, __ldg(idx + j), C, rank, li);
      load_row(src + li * 6, v);
#pragma unroll
      for (int c = 0; c < 6; ++c) acc[c] = add_rn(acc[c], v[c]);
    }
    store_row(y + l * 6, acc);
  }
  const int warp = t >> 5, lane = t & 31;
  const int h1 = __ldg(hp + warp + 1);
  for (int h = __ldg(hp + warp); h < h1; ++h) {
    const int a = __ldg(hidx + h);
    const int l = local_of(a, C);
    T acc = lane < 6 ? x[l * 6 + lane] : T(0);
    acc = warp_ordered_sum(acc, idx, __ldg(ptr + a), __ldg(ptr + a + 1), stage,
                           [&](int i, T (&v)[6]) {
                             int li;
                             const T* src = row_of(cl, x, i, C, rank, li);
                             load_row(src + li * 6, v);
                           });
    if (lane < 6) y[l * 6 + lane] = acc;
  }
}

// A path round of the cluster route: y[a] = x[a] + x[jump_m[a]] (0 above
// a root) for the thread's rows, their jumps jm loaded a round ahead.
template <typename T>
__device__ __forceinline__ void path_round_cl(cg::cluster_group& cl, T* x, T* y,
                                              const int (&jm)[2], int nb, int C, int rank,
                                              int ld) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int l = threadIdx.x + u * blockDim.x;
    if (row_at(l, rank, C) >= nb) continue;
    const int i = jm[u];
    T v[6] = {T(0), T(0), T(0), T(0), T(0), T(0)}, own[6];
    if (i < nb) {
      int li;
      const T* src = row_of(cl, x, i, C, rank, li);
      load_row(src + li * 6, v);
    }
    load_row(x + l * 6, own);
#pragma unroll
    for (int c = 0; c < 6; ++c) own[c] = add_rn(own[c], v[c]);
    store_row(y + l * 6, own);
  }
}

// Round m's preimage bounds (ptr) of the thread's two rows, or its jumps
// (jm), loaded a round ahead of their use.
__device__ __forceinline__ void row_bounds(const int* __restrict__ ptr, int nb, int C,
                                           int rank, int (&pj)[2][2]) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int a = row_at(threadIdx.x + u * blockDim.x, rank, C);
    pj[u][0] = a < nb ? __ldg(ptr + a) : 0;
    pj[u][1] = a < nb ? __ldg(ptr + a + 1) : 0;
  }
}

__device__ __forceinline__ void row_jumps(const int* __restrict__ jm, int nb, int C,
                                          int rank, int (&j)[2]) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int a = row_at(threadIdx.x + u * blockDim.x, rank, C);
    j[u] = a < nb ? __ldg(jm + a) : 0;
  }
}

// The R subtree rounds of the cluster route, from x into the other buffer
// and back (x and y swapped as they go: x holds the sums at the end), a
// cluster barrier after each but, with `cta_last`, the last (a CTA barrier
// there); round 0's bounds pj0 are the caller's, each next round's loaded
// during the one before.
template <typename T>
__device__ __forceinline__ void subtree_rounds_cl(cg::cluster_group& cl,
                                                  const DoublingArgs<T>& a, T*& x, T*& y,
                                                  const int (&pj0)[2][2], int C,
                                                  int rank, int ld, int nw, T* stage,
                                                  bool cta_last) {
  const int nb = a.nb, R = a.rounds;
  int pj[2][2] = {{pj0[0][0], pj0[0][1]}, {pj0[1][0], pj0[1][1]}};
  for (int m = 0; m < R; ++m) {
    int nj[2][2] = {{0, 0}, {0, 0}};
    if (m + 1 < R) row_bounds(a.pre_ptr + (size_t)(m + 1) * (nb + 1), nb, C, rank, nj);
    subtree_round_cl<T>(cl, x, y, a.pre_ptr + (size_t)m * (nb + 1), a.pre_idx,
                        a.heavy_ptr + ((size_t)m * C + rank) * (nw + 1), a.heavy_idx, C,
                        nb, rank, ld, stage, pj);
    T* s = x;
    x = y;
    y = s;
    if (m + 1 < R || !cta_last) {
      cluster_sync_all();
    } else {
      __syncthreads();  // the warps' rows are out; x is read in this CTA alone
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) pj[u][0] = nj[u][0], pj[u][1] = nj[u][1];
  }
}

// The R path rounds of the cluster route (x and y swapped as they go), a
// cluster barrier after each but the last (its rows are the thread's own);
// round 0's jumps jm0 are the caller's, each next round's loaded during
// the one before.
template <typename T>
__device__ __forceinline__ void path_rounds_cl(cg::cluster_group& cl,
                                               const DoublingArgs<T>& a, T*& x, T*& y,
                                               const int (&jm0)[2], int C, int rank,
                                               int ld) {
  const int nb = a.nb, R = a.rounds;
  int jm[2] = {jm0[0], jm0[1]};
  for (int m = 0; m < R; ++m) {
    int nj[2] = {0, 0};
    if (m + 1 < R) row_jumps(a.jump + (size_t)(m + 1) * (nb + 1), nb, C, rank, nj);
    path_round_cl<T>(cl, x, y, jm, nb, C, rank, ld);
    T* s = x;
    x = y;
    y = s;
    if (m + 1 < R) cluster_sync_all();
    jm[0] = nj[0];
    jm[1] = nj[1];
  }
}

// The cluster route's shared memory in words of T: three [6][ld] buffers,
// a stage a warp and the scratch (ladder_kernels._doubling_smem).
__host__ __device__ constexpr int doubling_words(int threads) {
  return 36 * threads + (threads / 32) * 6 * kStageLd + kDoublingScratchWords;
}

// L4 on the cluster route: a whole solve of one lane a cluster in one
// launch, in the plain version's operations and order.  An iteration:
// i_load of the CTA's rows into x; R subtree rounds, a cluster barrier
// after each but the last (a CTA barrier there); the error, i_br into the
// output (the previous one read from it) and the drops in place; the
// CTAs' errors through a slot each, cluster barrier, the lane's error in
// every CTA (`solve` mode exits on the device, cluster-uniform); R path
// rounds, a cluster barrier after each but the last; v from the thread's
// own rows.  2R cluster barriers an iteration.
template <typename T>
__global__ void __launch_bounds__(CtaMax<T>::threads, 1)
    ladder_doubling_cluster_kernel(const DoublingArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = 2 * blockDim.x, nw = blockDim.x >> 5;
  T* x = reinterpret_cast<T*>(smem_raw);  // [ld][6] each
  T* y = x + 6 * ld;
  T* v_s = x + 12 * ld;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, bd = blockDim.x;
  T* stage = x + 18 * ld + warp * 6 * kStageLd;
  T* scr = x + 18 * ld + nw * 6 * kStageLd;
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int64_t b = blockIdx.x / C;
  const int nb = a.nb;
  const size_t o3 = (size_t)b * nb * 3;
  int pj0[2][2], jm0[2];  // round 0's tables of the thread's rows, read once
  row_bounds(a.pre_ptr, nb, C, rank, pj0);
  row_jumps(a.jump, nb, C, rank, jm0);
  if (t < 6) scr[kDV0 + t] = t < 3 ? a.v0_re[b * 3 + t] : a.v0_im[b * 3 + t - 3];
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int l = t + u * bd;
    if (row_at(l, rank, C) >= nb) continue;
    const size_t k = o3 + (size_t)(row_at(l, rank, C)) * 3;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const T m = a.mask[(row_at(l, rank, C)) * 3 + p];
      v_s[l * 6 + p] = mul_rn(scr[kDV0 + p], m);
      v_s[l * 6 + (3 + p)] = mul_rn(scr[kDV0 + 3 + p], m);
      a.ib_re[k + p] = a.ib_im[k + p] = a.il_re[k + p] = a.il_im[k + p] = T(0);
    }
  }
  T err = T(INFINITY);
  int it = 0;
  while (it < a.max_iter && (a.fixed || err >= a.eps)) {
    // The saved iterate; i_load into x (and the output).
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int l = t + u * bd;
      if (row_at(l, rank, C) >= nb) continue;
      const size_t i = (size_t)(row_at(l, rank, C));
      if (a.saved != nullptr) {
        T* sv = a.saved + ((size_t)it * a.lanes + b) * nb * 6 + i * 6;
#pragma unroll
        for (int c = 0; c < 6; ++c) sv[c] = v_s[l * 6 + c];
      }
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        T lr, li;
        load_current_rn(v_s[l * 6 + p], v_s[l * 6 + (3 + p)], __ldg(a.s_re + o3 + i * 3 + p),
                        __ldg(a.s_im + o3 + i * 3 + p), lr, li);
        a.il_re[o3 + i * 3 + p] = lr;
        a.il_im[o3 + i * 3 + p] = li;
        x[l * 6 + p] = lr;
        x[l * 6 + (3 + p)] = li;
      }
    }
    cluster_sync_all();  // every CTA's currents are out
    subtree_rounds_cl<T>(cl, a, x, y, pj0, C, rank, ld, nw, stage, true);
    // Branch currents (the previous ones from the output), the root error,
    // the drops in place of the currents.
    T emax = T(0);
#pragma unroll 1
    for (int u = 0; u < 2; ++u) {
      const int l = t + u * bd;
      if (row_at(l, rank, C) >= nb) continue;
      const int i = row_at(l, rank, C);
      const size_t k = o3 + (size_t)i * 3;
      T br[6], prev[6], zr[9], zi[9];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        prev[p] = a.ib_re[k + p];
        prev[3 + p] = a.ib_im[k + p];
      }
#pragma unroll
      for (int e = 0; e < 9; ++e) {
        zr[e] = __ldg(a.z_re + (size_t)i * 9 + e);
        zi[e] = __ldg(a.z_im + (size_t)i * 9 + e);
      }
      const T rt = __ldg(a.root + i);
#pragma unroll
      for (int c = 0; c < 6; ++c) br[c] = x[l * 6 + c];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const T dr = sub_rn(br[p], prev[p]);
        const T di = sub_rn(br[3 + p], prev[3 + p]);
        emax = nan_max(emax, mul_rn(sqrt_rn(add_rn(mul_rn(dr, dr), mul_rn(di, di))), rt));
        a.ib_re[k + p] = br[p];
        a.ib_im[k + p] = br[3 + p];
      }
      T out[6];
      drop_rn(br, zr, zi, out);
#pragma unroll
      for (int c = 0; c < 6; ++c) x[l * 6 + c] = out[c];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) emax = nan_max(emax, __shfl_xor_sync(kFull, emax, o));
    if (lane == 0) scr[kDWmax + warp] = emax;
    __syncthreads();
    if (warp == 0) {
      T e = lane < nw ? scr[kDWmax + lane] : T(0);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) e = nan_max(e, __shfl_xor_sync(kFull, e, o));
      if (lane == 0) scr[kDSlotE] = e;
    }
    cluster_sync_all();  // every CTA's drops and error are out
    if (warp == 0) {
      T e = lane < C ? *cl.map_shared_rank(scr + kDSlotE, lane) : T(0);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) e = nan_max(e, __shfl_xor_sync(kFull, e, o));
      if (lane == 0) scr[kDErr] = e;
    }
    __syncthreads();
    err = scr[kDErr];
    path_rounds_cl<T>(cl, a, x, y, jm0, C, rank, ld);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int l = t + u * bd;
      if (row_at(l, rank, C) >= nb) continue;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const T m = a.mask[(row_at(l, rank, C)) * 3 + p];
        v_s[l * 6 + p] = mul_rn(sub_rn(scr[kDV0 + p], x[l * 6 + p]), m);
        v_s[l * 6 + (3 + p)] = mul_rn(sub_rn(scr[kDV0 + 3 + p], x[l * 6 + (3 + p)]), m);
      }
    }
    ++it;
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int l = t + u * bd;
    if (row_at(l, rank, C) >= nb) continue;
    const size_t k = o3 + (size_t)(row_at(l, rank, C)) * 3;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      a.v_re[k + p] = v_s[l * 6 + p];
      a.v_im[k + p] = v_s[l * 6 + (3 + p)];
    }
  }
  if (rank == 0 && t == 0) {
    a.iters[b] = it;
    a.resid[b] = err;
    a.conv[b] = err < a.eps ? 1 : 0;
  }
  cluster_sync_all();  // no CTA leaves while another may read its rows
}

// L4's reverse mode on the cluster route, one lane a cluster: vbar in the
// third buffer (its thread's rows), the loads' cotangent in registers and
// written once.  An iteration, walked backwards: x = mask vbar; R subtree
// rounds, a cluster barrier after each; warp 0 of rank 0 adds the roots'
// subtree sums to v0bar (roots in increasing order) while every thread
// forms ibbar = conj(z)^T dropbar of its rows into the other buffer;
// cluster barrier; R path rounds, a cluster barrier after each but the
// last; the loads' cotangent and the next vbar from the thread's own rows.
// 2R + 1 cluster barriers an iteration, and the plain version's bits.
template <typename T>
__global__ void __launch_bounds__(CtaMax<T>::threads, 1)
    ladder_doubling_vjp_cluster_kernel(const DoublingArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = 2 * blockDim.x, nw = blockDim.x >> 5;
  T* x = reinterpret_cast<T*>(smem_raw);  // [ld][6] each
  T* y = x + 6 * ld;
  T* w_s = x + 12 * ld;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, bd = blockDim.x;
  T* stage = x + 18 * ld + warp * 6 * kStageLd;
  T* scr = x + 18 * ld + nw * 6 * kStageLd;
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int64_t b = blockIdx.x / C;
  const int nb = a.nb;
  const size_t o3 = (size_t)b * nb * 3;
  int pj0[2][2], jm0[2];  // round 0's tables of the thread's rows, read once
  row_bounds(a.pre_ptr, nb, C, rank, pj0);
  row_jumps(a.jump, nb, C, rank, jm0);
  T sb[2][6];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int l = t + u * bd;
#pragma unroll
    for (int c = 0; c < 6; ++c) sb[u][c] = T(0);
    if (row_at(l, rank, C) >= nb) continue;
    const size_t k = o3 + (size_t)(row_at(l, rank, C)) * 3;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      w_s[l * 6 + p] = a.gv_re[k + p];
      w_s[l * 6 + (3 + p)] = a.gv_im[k + p];
    }
  }
  if (t < 6) scr[kDV0 + t] = T(0);
  // x = mask vbar; its subtree sums by the R rounds (a cluster barrier
  // after each); warp 0 of rank 0 adds those of the roots to v0bar.
  const auto subtree_of_masked = [&]() {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int l = t + u * bd;
      if (row_at(l, rank, C) >= nb) continue;
#pragma unroll
      for (int c = 0; c < 6; ++c)
        x[l * 6 + c] = mul_rn(w_s[l * 6 + c], a.mask[(row_at(l, rank, C)) * 3 + c % 3]);
    }
    cluster_sync_all();
    subtree_rounds_cl<T>(cl, a, x, y, pj0, C, rank, ld, nw, stage, false);
    if (rank == 0 && warp == 0) {
      const T sum = warp_ordered_sum(T(0), a.roots, 0, a.n_roots, stage,
                                     [&](int i, T (&v)[6]) {
                                       int li;
                                       const T* src = row_of(cl, x, i, C, rank, li);
                                       load_row(src + li * 6, v);
                                     });
      if (lane < 6) scr[kDV0 + lane] = add_rn(scr[kDV0 + lane], sum);
    }
  };
  for (int k = a.max_iter - 1; k >= 0; --k) {
    const bool last = k == a.max_iter - 1;
    subtree_of_masked();
    // ibbar = conj(z)^T dropbar (+ the final i_br's cotangent) into y.
#pragma unroll 1
    for (int u = 0; u < 2; ++u) {
      const int l = t + u * bd;
      if (row_at(l, rank, C) >= nb) continue;
      const int i = row_at(l, rank, C);
      T sv[6], zr[9], zi[9], out[6];
#pragma unroll
      for (int e = 0; e < 9; ++e) {
        zr[e] = __ldg(a.z_re + (size_t)i * 9 + e);
        zi[e] = __ldg(a.z_im + (size_t)i * 9 + e);
      }
#pragma unroll
      for (int c = 0; c < 6; ++c) sv[c] = x[l * 6 + c];
      conj_zt_rn(sv, zr, zi, out);
      if (last) {
        const size_t kk = o3 + (size_t)i * 3;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          out[q] = add_rn(out[q], a.gb_re[kk + q]);
          out[3 + q] = add_rn(out[3 + q], a.gb_im[kk + q]);
        }
      }
#pragma unroll
      for (int c = 0; c < 6; ++c) y[l * 6 + c] = out[c];
    }
    cluster_sync_all();  // every CTA's ibbar is out, v0bar's reads are done
    {
      T* s = x;
      x = y;
      y = s;
    }
    path_rounds_cl<T>(cl, a, x, y, jm0, C, rank, ld);
    // ilbar (+ the final i_load's cotangent); the loads' cotangent, vbar.
    const T* vk = a.saved + ((size_t)k * a.lanes + b) * nb * 6;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int l = t + u * bd;
      if (row_at(l, rank, C) >= nb) continue;
      const size_t i = (size_t)(row_at(l, rank, C));
      T vv[6], ss[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) vv[c] = __ldg(vk + i * 6 + c);
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        ss[p] = __ldg(a.s_re + o3 + i * 3 + p);
        ss[3 + p] = __ldg(a.s_im + o3 + i * 3 + p);
      }
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        T lr = x[l * 6 + p], li = x[l * 6 + (3 + p)];
        if (last) {
          lr = add_rn(lr, a.gl_re[o3 + i * 3 + p]);
          li = add_rn(li, a.gl_im[o3 + i * 3 + p]);
        }
        T tr, ti, wr, wi;
        load_adjoint_rn(lr, li, vv[p], vv[3 + p], ss[p], ss[3 + p], tr, ti, wr, wi);
        sb[u][p] = add_rn(sb[u][p], tr);
        sb[u][3 + p] = add_rn(sb[u][3 + p], ti);
        w_s[l * 6 + p] = wr;
        w_s[l * 6 + (3 + p)] = wi;
      }
    }
  }
  subtree_of_masked();  // the initial iterate v0 mask
  if (rank == 0 && t < 6) a.v0bar[b * 6 + t] = scr[kDV0 + t];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int l = t + u * bd;
    if (row_at(l, rank, C) >= nb) continue;
    const size_t k = o3 + (size_t)(row_at(l, rank, C)) * 3;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      a.sbar_re[k + p] = sb[u][p];
      a.sbar_im[k + p] = sb[u][3 + p];
    }
  }
  cluster_sync_all();  // no CTA leaves while another may read its rows
}

}  // namespace

template <typename T>
static Tree<T> make_tree(const T* mask, const T* z_re, const T* z_im, const T* root,
                         const int* tout, const int* gptr, const int* gidx, int nb) {
  return Tree<T>{mask, z_re, z_im, root, tout, gptr, gidx, nb};
}

// The cluster routes' shape at (cluster, per, threads, smem) must be what
// ladder_kernels' plans give: every CTA's interval whole and non-empty, two
// branches (rows) a thread, and the shared memory of the kernel: L1's and
// L2's three [6, 2 threads] buffers, the scratch and the staged group
// indices [2 threads]; L4's three buffers, a stage a warp and its scratch.
template <typename T>
static bool cluster_shape_ok(int nb, int cluster, int per, int threads, int smem,
                             bool doubling) {
  const int64_t want =
      doubling ? (int64_t)doubling_words(threads) * (int64_t)sizeof(T)
               : (int64_t)(36 * threads + kScratchWords) * (int64_t)sizeof(T) +
                     2 * threads * (int64_t)sizeof(int);
  // L4 deals its rows in blocks of 32: a CTA holds 32 ceil(nb / 32C).
  const int64_t rows = doubling ? 32 * (((int64_t)nb + 32 * cluster - 1) / (32 * cluster)) : per;
  return cluster >= 1 && cluster <= kMaxCluster && per >= 1 &&
         (int64_t)cluster * per >= nb && (int64_t)(cluster - 1) * per < nb &&
         2 * threads >= rows && 2 * threads >= per && threads % 32 == 0 &&
         threads <= CtaMax<T>::threads && (int64_t)smem == want && smem <= kSmemLimit;
}

// The cluster kernels, by the `kind` the entries take: 0 L1, 1 L2, 2 L4, 3
// L4's reverse mode.
template <typename T>
static const void* cluster_kernel(int kind) {
  switch (kind) {
    case 0:
      return (const void*)ladder_cluster_kernel<T>;
    case 1:
      return (const void*)ladder_vjp_cluster_kernel<T>;
    case 2:
      return (const void*)ladder_doubling_cluster_kernel<T>;
    case 3:
      return (const void*)ladder_doubling_vjp_cluster_kernel<T>;
  }
  return nullptr;
}

// Opt a cluster kernel in to a non-portable cluster size and to all the
// shared memory a block may take, once a device.
template <typename T>
static cudaError_t cluster_attributes(int kind) {
  static bool opted[4][64] = {};
  const void* fn = cluster_kernel<T>(kind);
  if (fn == nullptr) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && opted[kind][dev])) return e;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (e == cudaSuccess && dev < 64) opted[kind][dev] = true;
  return e;
}

template <typename T>
static cudaLaunchConfig_t cluster_config(int lanes, int cluster, int threads, int smem,
                                         cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)lanes * (unsigned)cluster);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of this shape of cluster kernel `kind` the card holds
// at once (0: it cannot place one).
template <typename T>
static int ladder_cluster_check(int cluster, int threads, int smem, int kind, int* active) {
  cudaError_t e = cluster_attributes<T>(kind);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config<T>(1, cluster, threads, smem, nullptr, attr);
  return (int)cudaOccupancyMaxActiveClusters(active, cluster_kernel<T>(kind), &cfg);
}

// A cluster launch of kernel `kind` after its shape checks.
template <typename T, typename K, typename... Args>
static int launch_cluster(int kind, K kernel, int nb, int lanes, int cluster, int per,
                          int threads, int smem, void* stream, Args... args) {
  if (!cluster_shape_ok<T>(nb, cluster, per, threads, smem, kind >= 2) ||
      (int64_t)lanes * cluster > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cluster_attributes<T>(kind);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      cluster_config<T>(lanes, cluster, threads, smem, (cudaStream_t)stream, attr);
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// `cluster` 0 takes the global route (with its ps and drop scratch), else
// the cluster route at (cluster, per, threads, smem) from ladder_plan,
// with z in its layout (zt [2][9][cluster 2 threads]) and the previous
// i_br's scratch (ibp [lanes][6][cluster 2 threads]).
template <typename T>
static int ladder_solve(const T* s_re, const T* s_im, const T* v0_re, const T* v0_im,
                        const T* mask, const T* z_re, const T* z_im, const T* root,
                        const int* tout, const int* gptr, const int* gidx, T* v_re,
                        T* v_im, T* ib_re, T* ib_im, T* il_re, T* il_im, int* iters,
                        T* resid, unsigned char* conv, T* saved, T* ps, T* drop,
                        const T* zt, T* ibp, int nb, int lanes, int max_iter,
                        int fixed, double eps, int cluster, int per, int threads,
                        int smem, void* stream) {
  if (nb <= 0 || lanes <= 0 || max_iter < 0) return (int)cudaErrorInvalidValue;
  SolveArgs<T> a{s_re, s_im, v0_re, v0_im,
                 make_tree<T>(mask, z_re, z_im, root, tout, gptr, gidx, nb),
                 v_re, v_im, ib_re, ib_im, il_re, il_im, iters, resid, conv,
                 saved, ps, drop, lanes, max_iter, fixed, (T)eps};
  if (cluster == 0) {
    if (ps == nullptr || drop == nullptr) return (int)cudaErrorInvalidValue;
    if (threads < 32 || threads > kThreads || threads % 32 != 0)
      return (int)cudaErrorInvalidValue;
    ladder_solve_kernel<T><<<(unsigned)lanes, (unsigned)threads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  if (zt == nullptr || ibp == nullptr) return (int)cudaErrorInvalidValue;
  return launch_cluster<T>(0, ladder_cluster_kernel<T>, nb, lanes, cluster, per, threads,
                           smem, stream, a, zt, ibp, per);
}

// `cluster` 0 takes the global route (its ps, w and g scratch), else the
// cluster route on L1's shape with z in its layout.
template <typename T>
static int ladder_vjp(const T* saved, const T* s_re, const T* s_im, const T* mask,
                      const T* z_re, const T* z_im, const int* tout, const int* gptr,
                      const int* gidx, const T* gv_re, const T* gv_im, const T* gb_re,
                      const T* gb_im, const T* gl_re, const T* gl_im, T* sbar_re,
                      T* sbar_im, T* v0bar, T* ps, T* w, T* g, const T* zt, int nb,
                      int lanes, int iters, int cluster, int per, int threads, int smem,
                      void* stream) {
  if (nb <= 0 || lanes <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  VjpArgs<T> a{saved, s_re, s_im,
               make_tree<T>(mask, z_re, z_im, nullptr, tout, gptr, gidx, nb),
               gv_re, gv_im, gb_re, gb_im, gl_re, gl_im, sbar_re, sbar_im, v0bar, ps,
               w, g, lanes, iters};
  if (cluster == 0) {
    if (ps == nullptr || w == nullptr || g == nullptr) return (int)cudaErrorInvalidValue;
    if (threads < 32 || threads > kThreads || threads % 32 != 0)
      return (int)cudaErrorInvalidValue;
    ladder_vjp_kernel<T><<<(unsigned)lanes, (unsigned)threads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  if (zt == nullptr) return (int)cudaErrorInvalidValue;
  return launch_cluster<T>(1, ladder_vjp_cluster_kernel<T>, nb, lanes, cluster, per,
                           threads, smem, stream, a, zt, per);
}

// `cluster` 0 takes the one-CTA route (its buf scratch), else the cluster
// route at doubling_plan's shape with the heavy rows' plan.
template <typename T>
static int ladder_doubling(const T* mask, const T* z_re, const T* z_im, const T* root,
                           const int* jump, const int* pre_ptr, const int* pre_idx,
                           const int* heavy_ptr, const int* heavy_idx, const T* s_re,
                           const T* s_im, const T* v0_re, const T* v0_im, T* v_re,
                           T* v_im, T* ib_re, T* ib_im, T* il_re, T* il_im, int* iters,
                           T* resid, unsigned char* conv, T* saved, T* buf, int nb,
                           int rounds, int lanes, int max_iter, int fixed, double eps,
                           int cluster, int per, int threads, int smem, void* stream) {
  if (nb <= 0 || rounds <= 0 || lanes <= 0 || max_iter < 0)
    return (int)cudaErrorInvalidValue;
  DoublingArgs<T> a = {};
  a.mask = mask;
  a.z_re = z_re;
  a.z_im = z_im;
  a.root = root;
  a.jump = jump;
  a.pre_ptr = pre_ptr;
  a.pre_idx = pre_idx;
  a.heavy_ptr = heavy_ptr;
  a.heavy_idx = heavy_idx;
  a.s_re = s_re;
  a.s_im = s_im;
  a.v0_re = v0_re;
  a.v0_im = v0_im;
  a.v_re = v_re;
  a.v_im = v_im;
  a.ib_re = ib_re;
  a.ib_im = ib_im;
  a.il_re = il_re;
  a.il_im = il_im;
  a.iters = iters;
  a.resid = resid;
  a.conv = conv;
  a.saved = saved;
  a.buf = buf;
  a.nb = nb;
  a.rounds = rounds;
  a.lanes = lanes;
  a.max_iter = max_iter;
  a.fixed = fixed;
  a.eps = (T)eps;
  if (cluster == 0) {
    if (buf == nullptr) return (int)cudaErrorInvalidValue;
    if (threads < 32 || threads > kDoublingThreads || threads % 32 != 0)
      return (int)cudaErrorInvalidValue;
    ladder_doubling_kernel<T>
        <<<(unsigned)lanes, (unsigned)threads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  if (heavy_ptr == nullptr) return (int)cudaErrorInvalidValue;  // heavy_idx may be empty
  return launch_cluster<T>(2, ladder_doubling_cluster_kernel<T>, nb, lanes, cluster, per,
                           threads, smem, stream, a);
}

template <typename T>
static int ladder_doubling_vjp(const T* mask, const T* z_re, const T* z_im,
                               const int* jump, const int* pre_ptr, const int* pre_idx,
                               const int* heavy_ptr, const int* heavy_idx,
                               const int* roots, const T* saved, const T* s_re,
                               const T* s_im, const T* gv_re, const T* gv_im,
                               const T* gb_re, const T* gb_im, const T* gl_re,
                               const T* gl_im, T* sbar_re, T* sbar_im, T* v0bar, T* buf,
                               T* w, int nb, int rounds, int n_roots, int lanes,
                               int iters, int cluster, int per, int threads, int smem,
                               void* stream) {
  if (nb <= 0 || rounds <= 0 || lanes <= 0 || iters < 0 || n_roots < 1 ||
      roots == nullptr)
    return (int)cudaErrorInvalidValue;
  DoublingArgs<T> a = {};
  a.mask = mask;
  a.z_re = z_re;
  a.z_im = z_im;
  a.jump = jump;
  a.pre_ptr = pre_ptr;
  a.pre_idx = pre_idx;
  a.heavy_ptr = heavy_ptr;
  a.heavy_idx = heavy_idx;
  a.roots = roots;
  a.saved = const_cast<T*>(saved);
  a.s_re = s_re;
  a.s_im = s_im;
  a.gv_re = gv_re;
  a.gv_im = gv_im;
  a.gb_re = gb_re;
  a.gb_im = gb_im;
  a.gl_re = gl_re;
  a.gl_im = gl_im;
  a.sbar_re = sbar_re;
  a.sbar_im = sbar_im;
  a.v0bar = v0bar;
  a.buf = buf;
  a.w = w;
  a.nb = nb;
  a.rounds = rounds;
  a.n_roots = n_roots;
  a.lanes = lanes;
  a.max_iter = iters;
  if (cluster == 0) {
    if (buf == nullptr || w == nullptr) return (int)cudaErrorInvalidValue;
    if (threads < 32 || threads > kDoublingThreads || threads % 32 != 0)
      return (int)cudaErrorInvalidValue;
    ladder_doubling_vjp_kernel<T>
        <<<(unsigned)lanes, (unsigned)threads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  if (heavy_ptr == nullptr) return (int)cudaErrorInvalidValue;  // heavy_idx may be empty
  return launch_cluster<T>(3, ladder_doubling_vjp_cluster_kernel<T>, nb, lanes, cluster,
                           per, threads, smem, stream, a);
}

#define LADDER_ENTRY(SUFFIX, T)                                                     \
  extern "C" int ladder_solve_##SUFFIX(                                             \
      const T* s_re, const T* s_im, const T* v0_re, const T* v0_im, const T* mask, \
      const T* z_re, const T* z_im, const T* root, const int* tout,                \
      const int* gptr, const int* gidx, T* v_re, T* v_im, T* ib_re, T* ib_im,      \
      T* il_re, T* il_im, int* iters, T* resid, unsigned char* conv, T* saved,     \
      T* ps, T* drop, const T* zt, T* ibp, int nb, int lanes, int max_iter,        \
      int fixed, double eps, int cluster, int per, int threads, int smem,          \
      void* stream) {                                                              \
    return ladder_solve<T>(s_re, s_im, v0_re, v0_im, mask, z_re, z_im, root, tout, \
                           gptr, gidx, v_re, v_im, ib_re, ib_im, il_re, il_im,     \
                           iters, resid, conv, saved, ps, drop, zt, ibp, nb, lanes,\
                           max_iter, fixed, eps, cluster, per, threads, smem,      \
                           stream);                                                \
  }                                                                                \
  extern "C" int ladder_cluster_check_##SUFFIX(int cluster, int threads, int smem, \
                                               int kind, int* active) {            \
    return ladder_cluster_check<T>(cluster, threads, smem, kind, active);          \
  }                                                                                \
  extern "C" int ladder_vjp_##SUFFIX(                                               \
      const T* saved, const T* s_re, const T* s_im, const T* mask, const T* z_re,  \
      const T* z_im, const int* tout, const int* gptr, const int* gidx,            \
      const T* gv_re, const T* gv_im, const T* gb_re, const T* gb_im,              \
      const T* gl_re, const T* gl_im, T* sbar_re, T* sbar_im, T* v0bar, T* ps,     \
      T* w, T* g, const T* zt, int nb, int lanes, int iters, int cluster, int per, \
      int threads, int smem, void* stream) {                                       \
    return ladder_vjp<T>(saved, s_re, s_im, mask, z_re, z_im, tout, gptr, gidx,   \
                         gv_re, gv_im, gb_re, gb_im, gl_re, gl_im, sbar_re,        \
                         sbar_im, v0bar, ps, w, g, zt, nb, lanes, iters, cluster,  \
                         per, threads, smem, stream);                              \
  }

LADDER_ENTRY(f64, double)
LADDER_ENTRY(f32, float)

#define LADDER_FORMS_ENTRY(SUFFIX, T)                                                \
  extern "C" int ladder_doubling_##SUFFIX(                                           \
      const T* mask, const T* z_re, const T* z_im, const T* root, const int* jump,  \
      const int* pre_ptr, const int* pre_idx, const int* heavy_ptr,                 \
      const int* heavy_idx, const T* s_re, const T* s_im, const T* v0_re,           \
      const T* v0_im, T* v_re, T* v_im, T* ib_re, T* ib_im, T* il_re, T* il_im,     \
      int* iters, T* resid, unsigned char* conv, T* saved, T* buf, int nb,          \
      int rounds, int lanes, int max_iter, int fixed, double eps, int cluster,      \
      int per, int threads, int smem, void* stream) {                               \
    return ladder_doubling<T>(mask, z_re, z_im, root, jump, pre_ptr, pre_idx,       \
                              heavy_ptr, heavy_idx, s_re, s_im, v0_re, v0_im, v_re, \
                              v_im, ib_re, ib_im, il_re, il_im, iters, resid, conv, \
                              saved, buf, nb, rounds, lanes, max_iter, fixed, eps,  \
                              cluster, per, threads, smem, stream);                 \
  }                                                                                 \
  extern "C" int ladder_doubling_vjp_##SUFFIX(                                       \
      const T* mask, const T* z_re, const T* z_im, const int* jump,                 \
      const int* pre_ptr, const int* pre_idx, const int* heavy_ptr,                 \
      const int* heavy_idx, const int* roots, const T* saved, const T* s_re,        \
      const T* s_im, const T* gv_re, const T* gv_im, const T* gb_re,                \
      const T* gb_im, const T* gl_re, const T* gl_im, T* sbar_re, T* sbar_im,       \
      T* v0bar, T* buf, T* w, int nb, int rounds, int n_roots, int lanes,           \
      int iters, int cluster, int per, int threads, int smem, void* stream) {       \
    return ladder_doubling_vjp<T>(mask, z_re, z_im, jump, pre_ptr, pre_idx,         \
                                  heavy_ptr, heavy_idx, roots, saved, s_re, s_im,   \
                                  gv_re, gv_im, gb_re, gb_im, gl_re, gl_im,         \
                                  sbar_re, sbar_im, v0bar, buf, w, nb, rounds,      \
                                  n_roots, lanes, iters, cluster, per, threads,     \
                                  smem, stream);                                    \
  }

LADDER_FORMS_ENTRY(f64, double)
LADDER_FORMS_ENTRY(f32, float)
