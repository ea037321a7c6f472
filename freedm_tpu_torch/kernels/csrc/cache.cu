// The serving cache's delta-tier kernel for Hopper (sm_90a).
//
// C1 delta_program — replaces the XLA program of
//   freedm_tpu/serve/cache.py:284 `_build_delta_program`: the warm-started
//   fast-decoupled correction of a cached solution toward new injection
//   schedules, run to convergence.  Each lane runs the reference's
//   while_loop:
//
//       dp, dq = mismatch(theta0, v0);  it = 0
//       while it < max_sweeps and err(dp, dq, v) >= tol:
//           theta += solve_p(dp) th_free;   dq2 = mismatch(theta, v).dq
//           v     += solve_q(dq2) v_free;   dp, dq = mismatch(theta, v)
//           it += 1
//       p, q = injections(theta, v)
//
//   with mismatch(theta, v) = ((p_s - P) / v th_free, (q_s - Q) / v v_free),
//   err = max(max |dp v|, max |dq v|), P and Q the branch-wise injections of
//   freedm_tpu/pf/mfree.py:34 `make_injection_fn` (per branch, with
//   V = v e^{j theta}: i_f = yff V_f + yft V_t, i_t = ytf V_f + ytt V_t,
//   s_f = V_f conj(i_f), s_t = V_t conj(i_t); P = sum Re s + g_sh v^2,
//   Q = sum Im s - b_sh v^2), and solve_p, solve_q the rank-0
//   `smw_delta_solve` over the cached B'/B'' LU pair: x = U^-1 L^-1 P^T b.
//   One launch runs the whole program for every lane of a call: the
//   mismatch at the warm start, every sweep with its per-lane exit test,
//   and the final P and Q.  The host reads the results once, at the end.
//
// Design: one thread-block cluster per program (up to 16 CTAs of 512
//   threads, non-portable size), no grid-wide barrier, no atomics.
//   - Triangular solves.  The LU factors are column-major (LAPACK's layout,
//     leading dimension `lda`), cut into 64 x 64 tiles; row block i of the
//     right-hand side lives in the shared memory of CTA i mod C.  The
//     pivots come as a permutation built once on the host, applied as a
//     gather when the right-hand side is loaded.  Forward substitution with
//     the unit-lower L is right-looking: the owner of block k+1 applies x_k
//     to that block, solves its diagonal block and pushes x_{k+1} into
//     every CTA's shared memory (a bulk copy per CTA through distributed
//     shared memory, completing an mbarrier there); the other CTAs apply
//     x_k to their own blocks below, which overlaps the next diagonal
//     solve.  Back substitution with U runs the same way from the last
//     block up, after one cluster barrier.  A diagonal block is one warp per
//     lane, in sub-blocks of 8 columns that every lane solves in registers
//     from one batch of shuffles.
//   - Factor tiles stream into a ring of shared-memory slots (8 float32 or
//     4 float64 tiles, 128 KB) by the Tensor Memory Accelerator: one 2-D
//     tensor copy (`cp.async.bulk.tensor`, completion on an mbarrier) per
//     tile, through a tensor map encoded at launch, started as many tiles
//     ahead of the tile in use as the ring holds; rows and columns past n
//     arrive as zeros.  The float32 factors are read with an L2 evict-last
//     policy, so the pair (2 x 16 MB at mesh2000) stays in the 50 MB L2
//     across sweeps; the float64 pair (64 MB) streams from HBM.
//   - Rounding of the substitution: every row receives its updates one
//     column at a time, in column order (ascending for L, descending for
//     U), each as one fused multiply-add in the factors' type
//     (b_i = fma(-a_ic, x_c, b_i)), and x_c = b_c / u_cc correctly
//     rounded (`quot`): column-oriented substitution whatever the tiling,
//     the sub-blocks and the cluster size.  Under mixed precision that type is
//     float32: the right-hand side is the float32 rounding of dp (dq), the
//     sums run in float32, and x is widened before it is added, as the
//     reference's `.astype`.  No inverse is formed.
//   - Mismatch passes.  A warp takes 32 buses of one lane; each thread
//     walks its bus's incidence list (the port's CSR order: from-end edges,
//     then to-end edges, each ascending) with the explicitly rounded
//     intrinsics of the per-mode kernel it replaces, so dp, dq, P and Q are
//     that kernel's bits (the same operations in the same order as the
//     reference's two segment sums).  The iterates (theta, v, dp, dq) stay
//     in global memory, which L2 holds; they are read with ld.global.cg
//     (L2, not the SM's L1) because other CTAs of the cluster wrote them.
//     The lane's max of |dp v|, |dq v| is a shuffle tree per warp, the
//     CTA's warps in order, then the cluster's CTAs in rank order through
//     distributed shared memory; every CTA reduces the same values in the
//     same order, so each holds the same err, it and active flags and the
//     sweep loop's exit is uniform.  A NaN propagates as jnp.max's does.
//     A lane whose flag is clear keeps theta, v, err and it.
//
// Bound on an H100 SXM (3.35 TB/s): a sweep reads both factors once,
//   2 n^2 values (32 MB in float32 at mesh2000, 0.0096 ms; 64 MB in float64);
//   the operands, iterates and results are below 1 MB a lane.  The design's
//   limit is latency: 4 (n / 64 - 1) dependent block steps a sweep, each a
//   push of x between two CTAs, the owner's tile and its 64-column
//   diagonal solve.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap (the encoder is looked up in libcuda at run time)
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;
constexpr int kSub = 8;  // columns a diagonal sub-block solves in registers
// Ring slots: 8 float32 tiles (128 KB) or 3 float64 tiles (96 KB, which
// leaves room for 8 lanes at mesh5000).
template <typename T>
__host__ __device__ constexpr int stages() { return sizeof(T) == 4 ? 8 : 3; }
constexpr int kMaxLanes = kWarps;  // a diagonal block's lane is one warp
constexpr int kMaxCluster = 16;
constexpr int kSmemLimit = 232448;  // opt-in shared memory of a CTA, sm_90
constexpr int kStaticSmem = 4096;   // headroom for the static arrays below

__host__ __device__ inline int n_blocks(int n) { return (n + kTile - 1) / kTile; }
__host__ __device__ inline int n_local(int nb, int cs) { return (nb + cs - 1) / cs; }
__host__ __device__ inline int list_cap(int nb, int cs) {
  return n_local(nb, cs) * (nb + 1);
}

// Dynamic shared memory of one CTA: the tile ring, the owned right-hand-side
// blocks [n_local][lanes][64], the reciprocals of the owned blocks' U
// pivots [2][n_local][64], the x ring [cs + 1][lanes][64] that solved
// blocks are pushed into, the two rings' mbarriers and the CTA's two tile
// lists (forward, backward).
template <typename T>
__host__ __device__ inline size_t smem_bytes(int nb, int cs, int lanes) {
  constexpr int kStages = stages<T>();
  return (size_t)kStages * kTile * kTile * sizeof(T) +
         (size_t)n_local(nb, cs) * lanes * kTile * sizeof(T) +
         (size_t)2 * n_local(nb, cs) * kTile * sizeof(T) +
         (size_t)(cs + 1) * lanes * kTile * sizeof(T) +
         (kStages + cs + 1) * sizeof(uint64_t) +
         2 * (size_t)list_cap(nb, cs) * sizeof(int);
}

struct Args {
  CUtensorMap tile[2];  // 64 x 64 boxes of the B' and B'' LU factors
  const double* in;  // [lanes][4][n]: theta0, v0, p_sched, q_sched
  double* out;       // [lanes][4n + 2]: theta, v, P, Q, err, it (int32)
  double* dpq;       // [lanes][2][n]: dp, dq
  const int* inc_ptr;
  const int* inc_code;
  const int* inc_nbr;
  const double* y;
  const double* g_sh;
  const double* b_sh;
  const double* th_free;
  const double* v_free;
  const int* perm[2];  // the pivots as a permutation: (P^T b)_i = b_perm[i]
  const void* rdiag[2];  // 1 / u_cc of B' and B'' [n], rounded to nearest
  int lanes, n, m, max_sweeps;
  double tol;
};

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
// b - a x, rounded once.
__device__ __forceinline__ double fnma(double a, double x, double b) { return __fma_rn(-a, x, b); }
__device__ __forceinline__ float fnma(float a, float x, float b) { return __fmaf_rn(-a, x, b); }
__device__ __forceinline__ double fma_rn(double a, double x, double b) { return __fma_rn(a, x, b); }
__device__ __forceinline__ float fma_rn(float a, float x, float b) { return __fmaf_rn(a, x, b); }

// a / u rounded to nearest, given y = 1 / u rounded to nearest (made once
// per program build, `rdiag`): q = a y, then Markstein's
// correction q + (a - q u) y with the remainder exact in an fma.  With y
// the correctly rounded reciprocal and q within an ulp of a / u, the
// result is the correctly rounded quotient for normal operands; a zero a
// gives q itself, the quotient's signed zero (a non-finite a gives NaN
// where a division gives +-inf: the lane is lost either way).  The
// factors' pivots u are normal numbers; the chain of the back substitution
// then waits on three roundings a column instead of a division.
template <typename T>
__device__ __forceinline__ T quot(T a, T u, T y) {
  const T q = mul_rn(a, y);
  const T q1 = fma_rn(fnma(q, u, a), y, q);
  return a == T(0) ? q : q1;
}

// jnp.maximum: NaN if either operand is NaN.
__device__ __forceinline__ double nanmax(double a, double b) {
  if (a != a || b != b) return a + b;
  return a > b ? a : b;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One 64 x 64 factor tile (rows r0.., columns c0..), global -> shared, by
// the TMA engine: element (r, c) lands at dst[(c - c0) * 64 + r - r0]; rows
// and columns past n arrive as zeros.
__device__ __forceinline__ void tile_load(void* dst, const CUtensorMap* map,
                                          int r0, int c0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(r0), "r"(c0),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tile_load_keep(void* dst, const CUtensorMap* map,
                                               int r0, int c0, uint64_t* bar,
                                               uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(r0), "r"(c0),
      "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// The same shared-memory offset in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t remote(const void* p, unsigned rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// `bytes` of this CTA's shared memory at `src` into CTA `rank`'s shared
// memory at `dst`'s offset, completing its mbarrier at `bar`'s offset, by
// the TMA engine.
__device__ __forceinline__ void push(const void* dst, const void* src,
                                     unsigned bytes, uint64_t* bar,
                                     unsigned rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(remote(dst, rank)),
      "r"(smem_u32(src)), "r"(bytes), "r"(remote(bar, rank))
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// Global writes of this CTA are visible to every CTA of the cluster after.
__device__ __forceinline__ void cluster_sync_global() {
  __threadfence();
  cluster_arrive();
  cluster_wait();
}

__device__ __forceinline__ int pack(int i, int k) { return (i << 16) | k; }

// P and Q of bus i in lane row (th, vv), as the per-mode kernel computed
// them: the side's own admittance times V_i plus the mutual one times V_j,
// s = V_i conj(i), from-end and to-end terms summed apart in list order.
__device__ __forceinline__ void bus_pq(const Args& a, const double* th,
                                       const double* vv, int i, double* p,
                                       double* q, double* v_i) {
  const double thi = __ldcg(th + i);
  const double vi = __ldcg(vv + i);
  double si, ci;
  sincos(thi, &si, &ci);
  const double vre_i = mul_rn(vi, ci), vim_i = mul_rn(vi, si);
  double pf = 0.0, pt = 0.0, qf = 0.0, qt = 0.0;
  const int m = a.m;
  const int r1 = __ldg(a.inc_ptr + i + 1);
  for (int r = __ldg(a.inc_ptr + i); r < r1; ++r) {
    const int code = __ldg(a.inc_code + r);
    const int e = code >> 1;
    const bool to_side = code & 1;
    const int j = __ldg(a.inc_nbr + r);
    const double thj = __ldcg(th + j);
    const double vj = __ldcg(vv + j);
    double sj, cj;
    sincos(thj, &sj, &cj);
    const double vre_j = mul_rn(vj, cj), vim_j = mul_rn(vj, sj);
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
  *v_i = vi;
}

// Mismatch pass kinds.
constexpr int kErr = 0;  // dp, dq and the lanes' err
constexpr int kDq = 1;   // dq alone (after the theta half)
constexpr int kPQ = 2;   // the answer's P and Q

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    delta_program_kernel(const __grid_constant__ Args a) {
  constexpr int kStages = stages<T>();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = (int)cluster.num_blocks();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = a.n, lanes = a.lanes;
  const int nb = n_blocks(n), nloc = n_local(nb, cs), cap = list_cap(nb, cs);
  const int64_t ostride = 4 * (int64_t)n + 2;
  const int lb_elems = lanes * kTile;  // one owned block, every lane

  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  T* bvec = ring + kStages * kTile * kTile;
  const int nx = cs + 1;  // x ring slots
  T* rdg = bvec + (size_t)nloc * lb_elems;  // [2][nloc][64]
  T* xring = rdg + (size_t)2 * nloc * kTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(xring + (size_t)nx * lb_elems);
  uint64_t* xbar = full + kStages;
  int* lists = reinterpret_cast<int*>(xbar + nx);
  __shared__ double warp_max[kWarps][kMaxLanes];
  __shared__ double cta_max[kMaxLanes];
  __shared__ double err_s[kMaxLanes];
  __shared__ int it_s[kMaxLanes];
  __shared__ int act_s[kMaxLanes];
  __shared__ int list_len[2];

  // The CTA's tiles in the order it uses them: forward (L), then backward
  // (U).  `own(i)`: row block i lives here.
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    for (int s = 0; s < nx; ++s) mbar_init(&xbar[s], 1);
    int len = 0;
    int* L = lists;
    if (rank == 0) L[len++] = pack(0, 0);
    for (int k = 0; k + 1 < nb; ++k) {
      if ((k + 1) % cs == rank) {
        L[len++] = pack(k + 1, k);
        L[len++] = pack(k + 1, k + 1);
      }
      for (int i = k + 2; i < nb; ++i)
        if (i % cs == rank) L[len++] = pack(i, k);
    }
    list_len[0] = len;
    len = 0;
    L = lists + cap;
    if ((nb - 1) % cs == rank) L[len++] = pack(nb - 1, nb - 1);
    for (int k = nb - 1; k >= 1; --k) {
      if ((k - 1) % cs == rank) {
        L[len++] = pack(k - 1, k);
        L[len++] = pack(k - 1, k - 1);
      }
      for (int i = k - 2; i >= 0; --i)
        if (i % cs == rank) L[len++] = pack(i, k);
    }
    list_len[1] = len;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int p = tid; p < 2 * nloc * kTile; p += kThreads) {
    const int h = p / (nloc * kTile), rem = p % (nloc * kTile);
    const int i = (rank + (rem / kTile) * cs) * kTile + rem % kTile;
    rdg[p] = i < n ? static_cast<const T*>(a.rdiag[h])[i] : T(1);
  }
  uint64_t policy = 0;
  if constexpr (sizeof(T) == 4)
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
                 : "=l"(policy));
  __syncthreads();

  // ---- the tile ring: jp tiles started, jc used, over the whole program ----
  unsigned jp = 0, jc = 0;
  // Thread 0 starts list entry `entry` of factor `which` into ring slot
  // `slot`: one tensor copy of the whole tile.
  auto fetch = [&](int which, int entry, int slot) {
    const int bi = entry >> 16, bk = entry & 0xffff;
    T* dst = ring + slot * kTile * kTile;
    mbar_expect_tx(&full[slot], kTile * kTile * sizeof(T));
    if constexpr (sizeof(T) == 4)
      tile_load_keep(dst, &a.tile[which], bi * kTile, bk * kTile, &full[slot],
                     policy);
    else
      tile_load(dst, &a.tile[which], bi * kTile, bk * kTile, &full[slot]);
  };
  auto start = [&](int which, const int* list, int len) {
    const int pre = min(kStages, len);
    if (tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      for (int t = 0; t < pre; ++t) fetch(which, list[t], (int)((jp + t) % kStages));
    }
    jp += pre;
  };
  auto acquire = [&]() -> const T* {
    const int slot = (int)(jc % kStages);
    mbar_wait(&full[slot], (jc / kStages) & 1u);
    return ring + slot * kTile * kTile;
  };
  // Tile t of the list is used: its slot takes tile t + kStages.
  auto release = [&](int which, const int* list, int len, int t) {
    __syncthreads();
    if (t + kStages < len) {
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        fetch(which, list[t + kStages], (int)(jc % kStages));
      }
      ++jp;
    }
    ++jc;
  };

  // b_i -= tile x_k on row block bi, column by column.
  auto panel = [&](const T* tile, int bi, int bk, const T* xb, bool fwd) {
    const int rows = min(kTile, n - bi * kTile), cols = min(kTile, n - bk * kTile);
    T* bb = bvec + (size_t)(bi / cs) * lb_elems;
    for (int p = tid; p < lb_elems; p += kThreads) {
      const int r = p % kTile;
      if (r >= rows) continue;
      const T* x = xb + (p / kTile) * kTile;
      T acc = bb[p];
      if (fwd) {
#pragma unroll 8
        for (int c = 0; c < cols; ++c) acc = fnma(tile[c * kTile + r], x[c], acc);
      } else {
#pragma unroll 8
        for (int c = cols - 1; c >= 0; --c) acc = fnma(tile[c * kTile + r], x[c], acc);
      }
      bb[p] = acc;
    }
  };
  // The diagonal block bk: a warp per lane, rows lane and lane + 32, in
  // sub-blocks of kSub columns.  Every lane solves a sub-block's triangle
  // itself, in registers, from one batch of shuffles, and then applies its
  // x to its own rows beyond the sub-block; each row still takes its
  // updates one fma at a time in column order.
  auto diag = [&](const T* tile, int bk, int which, bool fwd) {
    const int rows = min(kTile, n - bk * kTile);
    T* bb = bvec + (size_t)(bk / cs) * lb_elems;
    for (int l = warp; l < lanes; l += kWarps) {
      T* bl = bb + l * kTile;
      T b0 = bl[lane], b1 = bl[lane + 32];
      T xs[kSub];
      if (fwd) {  // unit lower: x_c = b_c; rows past n stay zero
        for (int s0 = 0; s0 < kTile; s0 += kSub) {
#pragma unroll
          for (int j = 0; j < kSub; ++j)
            xs[j] = __shfl_sync(0xffffffffu, s0 < 32 ? b0 : b1, (s0 + j) & 31);
#pragma unroll
          for (int j = 0; j < kSub; ++j)
#pragma unroll
            for (int r = j + 1; r < kSub; ++r)
              xs[r] = fnma(tile[(s0 + j) * kTile + s0 + r], xs[j], xs[r]);
#pragma unroll
          for (int j = 0; j < kSub; ++j) {
            const T* col = tile + (s0 + j) * kTile;
            if (lane >= s0 + kSub) b0 = fnma(col[lane], xs[j], b0);
            if (lane + 32 >= s0 + kSub) b1 = fnma(col[lane + 32], xs[j], b1);
            if (lane == s0 + j) b0 = xs[j];
            if (lane + 32 == s0 + j) b1 = xs[j];
          }
        }
      } else {  // upper: x_c = b_c / u_cc; past n, u_cc = 1 keeps x_c zero
        for (int s0 = kTile - kSub; s0 >= 0; s0 -= kSub) {
#pragma unroll
          for (int j = 0; j < kSub; ++j)
            xs[j] = __shfl_sync(0xffffffffu, s0 < 32 ? b0 : b1, (s0 + j) & 31);
          T ys[kSub];
#pragma unroll
          for (int j = 0; j < kSub; ++j)
            ys[j] = rdg[((size_t)which * nloc + bk / cs) * kTile + s0 + j];
#pragma unroll
          for (int j = kSub - 1; j >= 0; --j) {
            const T* col = tile + (s0 + j) * kTile;
            xs[j] = quot(xs[j], s0 + j < rows ? col[s0 + j] : T(1), ys[j]);
#pragma unroll
            for (int r = 0; r < j; ++r) xs[r] = fnma(col[s0 + r], xs[j], xs[r]);
          }
#pragma unroll
          for (int j = kSub - 1; j >= 0; --j) {
            const T* col = tile + (s0 + j) * kTile;
            if (lane < s0) b0 = fnma(col[lane], xs[j], b0);
            if (lane + 32 < s0) b1 = fnma(col[lane + 32], xs[j], b1);
            if (lane == s0 + j) b0 = xs[j];
            if (lane + 32 == s0 + j) b1 = xs[j];
          }
        }
      }
      bl[lane] = b0;
      bl[lane + 32] = b1;
    }
  };
  // Solved blocks travel through the x ring: the owner of block bk copies
  // x_bk into slot g mod (cs + 1) of its own ring and pushes it into the
  // same slot of every other CTA; a CTA that needs it arms the slot's
  // mbarrier for the bytes and waits.  Slot reuse needs no acknowledgement:
  // x_k exists only after every CTA, as the owner of one of the cs blocks
  // before it, finished the steps up to k - cs - 1, the last ones to read
  // the slot that x_k overwrites (each direction starts after a cluster
  // barrier, so the window never spans two).
  unsigned gx = 0;  // x blocks pushed so far
  auto publish = [&](int bk, unsigned g) {
    const int slot = (int)(g % nx);
    T* dst = xring + (size_t)slot * lb_elems;
    const T* src = bvec + (size_t)(bk / cs) * lb_elems;
    for (int p = tid; p < lb_elems; p += kThreads) dst[p] = src[p];
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid < cs && tid != rank)
      push(dst, dst, lb_elems * sizeof(T), &xbar[slot], (unsigned)tid);
    if (tid == kThreads - 1) mbar_arrive(&xbar[slot]);  // its own phase
  };
  // x_bk, pushed as block g: this CTA's copy.
  auto receive = [&](int bk, unsigned g) -> const T* {
    const int slot = (int)(g % nx);
    if (bk % cs != rank) {
      if (tid == 0) mbar_expect_tx(&xbar[slot], lb_elems * sizeof(T));
      mbar_wait(&xbar[slot], (g / nx) & 1u);
    }
    return xring + (size_t)slot * lb_elems;
  };

  // x = U^-1 L^-1 P^T rhs for every lane, rhs = dp (which 0) or dq (1):
  // x is left in the owned blocks.
  auto solve = [&](int which) {
    const int* perm = a.perm[which];
    for (int p = tid; p < nloc * lb_elems; p += kThreads) {
      const int lb = p / lb_elems, rem = p % lb_elems;
      const int l = rem / kTile;
      const int i = (rank + lb * cs) * kTile + rem % kTile;
      bvec[p] = i < n ? (T)__ldcg(a.dpq + ((int64_t)l * 2 + which) * n +
                                   __ldg(perm + i))
                      : T(0);
    }
    __syncthreads();
    const int* fl = lists;
    int len = list_len[0], t = 0;
    start(which, fl, len);
    if (rank == 0) {
      diag(acquire(), 0, which, true);
      release(which, fl, len, t++);
      if (nb > 1) publish(0, gx);
    }
    for (int k = 0; k + 1 < nb; ++k) {
      const T* xb = receive(k, gx + k);
      if ((k + 1) % cs == rank) {
        panel(acquire(), k + 1, k, xb, true);
        release(which, fl, len, t++);
        diag(acquire(), k + 1, which, true);
        release(which, fl, len, t++);
        if (k + 2 < nb) publish(k + 1, gx + k + 1);
      }
      for (int i = k + 2; i < nb; ++i) {
        if (i % cs != rank) continue;
        panel(acquire(), i, k, xb, true);
        release(which, fl, len, t++);
      }
    }
    gx += nb - 1;
    cluster_arrive();
    cluster_wait();
    const int* bl = lists + cap;
    len = list_len[1];
    t = 0;
    start(which, bl, len);
    if ((nb - 1) % cs == rank) {
      diag(acquire(), nb - 1, which, false);
      release(which, bl, len, t++);
      if (nb > 1) publish(nb - 1, gx);
    }
    for (int k = nb - 1; k >= 1; --k) {
      const T* xb = receive(k, gx + (nb - 1 - k));
      if ((k - 1) % cs == rank) {
        panel(acquire(), k - 1, k, xb, false);
        release(which, bl, len, t++);
        diag(acquire(), k - 1, which, false);
        release(which, bl, len, t++);
        if (k - 1 >= 1) publish(k - 1, gx + (nb - k));
      }
      for (int i = k - 2; i >= 0; --i) {
        if (i % cs != rank) continue;
        panel(acquire(), i, k, xb, false);
        release(which, bl, len, t++);
      }
    }
    gx += nb - 1;
  };

  // theta (half 0) or v (half 1) += x mask on the live lanes, owned rows.
  auto correct_half = [&](int half) {
    const double* mask = half == 0 ? a.th_free : a.v_free;
    for (int p = tid; p < nloc * lb_elems; p += kThreads) {
      const int lb = p / lb_elems, rem = p % lb_elems;
      const int l = rem / kTile;
      const int i = (rank + lb * cs) * kTile + rem % kTile;
      if (i >= n || !act_s[l]) continue;
      double* x = a.out + l * ostride + (int64_t)half * n + i;
      *x = add_rn(__ldcg(x), mul_rn((double)bvec[p], __ldg(mask + i)));
    }
    cluster_sync_global();
  };

  auto mismatch = [&](int kind) {
    const int chunks = (n + 31) / 32;
    if (kind == kErr && lane < kMaxLanes) warp_max[warp][lane] = 0.0;
    __syncwarp();
    for (int u = rank * kWarps + warp; u < lanes * chunks; u += cs * kWarps) {
      const int l = u / chunks, i = (u % chunks) * 32 + lane;
      const double* th = a.out + l * ostride;
      double mx = 0.0;
      if (i < n) {
        double p, q, vi;
        bus_pq(a, th, th + n, i, &p, &q, &vi);
        if (kind == kPQ) {
          a.out[l * ostride + 2 * (int64_t)n + i] = p;
          a.out[l * ostride + 3 * (int64_t)n + i] = q;
        } else {
          const double* sched = a.in + (int64_t)l * 4 * n;
          const double dq = mul_rn(div_rn(sub_rn(__ldg(sched + 3 * n + i), q), vi),
                                   __ldg(a.v_free + i));
          double* dpq = a.dpq + (int64_t)l * 2 * n;
          dpq[n + i] = dq;
          if (kind == kErr) {
            const double dp = mul_rn(
                div_rn(sub_rn(__ldg(sched + 2 * n + i), p), vi), __ldg(a.th_free + i));
            dpq[i] = dp;
            mx = nanmax(fabs(mul_rn(dp, vi)), fabs(mul_rn(dq, vi)));
          }
        }
      }
      if (kind == kErr) {
        for (int o = 16; o > 0; o >>= 1)
          mx = nanmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        if (lane == 0) warp_max[warp][l] = nanmax(warp_max[warp][l], mx);
      }
    }
  };

  // The lanes' err after a kErr pass; `init` starts the carry, else the
  // live lanes take a sweep.  Every CTA computes the same flags.
  auto reduce = [&](bool init) {
    __syncthreads();
    if (tid < lanes) {
      double c = warp_max[0][tid];
      for (int w = 1; w < kWarps; ++w) c = nanmax(c, warp_max[w][tid]);
      cta_max[tid] = c;
    }
    cluster_sync_global();
    if (tid < lanes) {
      double e = *cluster.map_shared_rank(&cta_max[tid], 0u);
      for (int c = 1; c < cs; ++c)
        e = nanmax(e, *cluster.map_shared_rank(&cta_max[tid], (unsigned)c));
      if (init) {
        err_s[tid] = e;
        it_s[tid] = 0;
        act_s[tid] = (0 < a.max_sweeps && e >= a.tol) ? 1 : 0;
      } else if (act_s[tid]) {
        const int it1 = it_s[tid] + 1;
        err_s[tid] = e;
        it_s[tid] = it1;
        act_s[tid] = (it1 < a.max_sweeps && e >= a.tol) ? 1 : 0;
      }
    }
    __syncthreads();
  };

  // ---- the program ----
  for (int64_t p = rank * kThreads + tid; p < (int64_t)lanes * n;
       p += cs * kThreads) {
    const int64_t l = p / n, i = p % n;
    a.out[l * ostride + i] = __ldg(a.in + l * 4 * n + i);
    a.out[l * ostride + n + i] = __ldg(a.in + l * 4 * n + n + i);
  }
  cluster_sync_global();
  mismatch(kErr);
  reduce(true);
  for (int s = 0; s < a.max_sweeps; ++s) {
    bool any = false;
    for (int l = 0; l < lanes; ++l) any = any || act_s[l] != 0;
    if (!any) break;
    solve(0);
    correct_half(0);
    mismatch(kDq);
    cluster_sync_global();
    solve(1);
    correct_half(1);
    mismatch(kErr);
    reduce(false);
  }
  mismatch(kPQ);
  if (rank == 0 && tid < lanes) {
    a.out[tid * ostride + 4 * (int64_t)n] = err_s[tid];
    int* it = reinterpret_cast<int*>(a.out + tid * ostride + 4 * (int64_t)n + 1);
    it[0] = it_s[tid];
    it[1] = 0;
  }
  // No CTA leaves while another may still read its shared memory.
  cluster_arrive();
  cluster_wait();
}

template <typename T>
cudaError_t set_attributes() {
  auto fn = delta_program_kernel<T>;
  cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemLimit - kStaticSmem);
}

// The cluster size and the most lanes a launch takes at n buses: the
// largest cluster (16, else 8, else fewer) that the card can place with the
// shared memory of one lane, and the lanes that fit beside it.
template <typename T>
int configure(int n, int* cluster, int* max_lanes) {
  cudaError_t e = set_attributes<T>();
  if (e != cudaSuccess) return (int)e;
  const int nb = n_blocks(n);
  const int budget = kSmemLimit - kStaticSmem;
  for (int cs = nb < kMaxCluster ? nb : kMaxCluster; cs >= 1;
       cs = cs > 8 ? 8 : cs - 1) {
    int lanes = kMaxLanes;
    while (lanes > 0 && smem_bytes<T>(nb, cs, lanes) > (size_t)budget) --lanes;
    if (lanes == 0) continue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)cs);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem_bytes<T>(nb, cs, lanes);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int active = 0;
    e = cudaOccupancyMaxActiveClusters(&active, delta_program_kernel<T>, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (active >= 1) {
      *cluster = cs;
      *max_lanes = lanes;
      return 0;
    }
  }
  return (int)cudaErrorInvalidConfiguration;
}

// cuTensorMapEncodeTiled, looked up at run time (no link against libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of one column-major n x n factor with leading dimension
// lda: 64 x 64 boxes, rows innermost, zeros past the edges.
template <typename T>
int encode(CUtensorMap* map, const void* lu, int n, int lda) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)lda * sizeof(T)};
  const cuuint32_t box[2] = {kTile, kTile};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(
      map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
      2, const_cast<void*>(lu), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(Args& a, const void* lu_p, const void* lu_q, int lda, int cluster,
           void* stream) {
  const int nb = n_blocks(a.n);
  constexpr int kv = 16 / (int)sizeof(T);
  if (a.lanes < 1 || a.lanes > kMaxLanes || a.n < 1 || nb > 0xffff ||
      a.m < 0 || cluster < 1 || cluster > kMaxCluster || cluster > nb ||
      a.max_sweeps < 0 || lda < (a.n + kv - 1) / kv * kv ||
      ((size_t)lda * sizeof(T)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const void* lu[2] = {lu_p, lu_q};
  for (int h = 0; h < 2; ++h) {
    if (lu[h] == nullptr || a.perm[h] == nullptr || a.rdiag[h] == nullptr ||
        reinterpret_cast<uintptr_t>(lu[h]) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    const int rc = encode<T>(&a.tile[h], lu[h], a.n, lda);
    if (rc != 0) return rc;
  }
  if (a.in == nullptr || a.out == nullptr || a.dpq == nullptr ||
      a.inc_ptr == nullptr || a.y == nullptr || a.g_sh == nullptr ||
      a.b_sh == nullptr || a.th_free == nullptr || a.v_free == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(nb, cluster, a.lanes);
  if (smem > (size_t)(kSmemLimit - kStaticSmem)) return (int)cudaErrorInvalidValue;
  static bool attributes_set = false;  // configure() sets them too
  if (!attributes_set) {
    cudaError_t e = set_attributes<T>();
    if (e != cudaSuccess) return (int)e;
    attributes_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, delta_program_kernel<T>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.
//
// delta_program_config: the cluster size and the most lanes a launch of
// the float32 (f32 != 0) or float64 program takes at n buses.
extern "C" int delta_program_config(int f32, int n, int* cluster,
                                    int* max_lanes) {
  if (n < 1 || cluster == nullptr || max_lanes == nullptr)
    return (int)cudaErrorInvalidValue;
  return f32 ? configure<float>(n, cluster, max_lanes)
             : configure<double>(n, cluster, max_lanes);
}

// delta_program: one program over `lanes` lanes (1-16) on `stream`.  Every
// pointer is a device pointer to a contiguous tensor: in [lanes][4][n] and
// out [lanes][4n + 2], dpq [lanes][2][n] float64; the operands (inc_ptr
// [n+1], inc_code, inc_nbr [2m] int32, y [8][m], g_sh, b_sh, th_free,
// v_free [n] float64); lu_p, lu_q the B' and B'' LU factors, column-major
// with leading dimension lda (16-byte aligned, lda >= n rounded up to 16
// bytes), float32 (f32 != 0) or float64; perm_p, perm_q [n] int32;
// rdiag_p, rdiag_q [n] the reciprocals of the factors' U diagonals in the
// factors' type, rounded to nearest.
// Returns the cudaError_t of the launch.
extern "C" int delta_program(int f32, const double* in, double* out,
                             double* dpq, const int* inc_ptr,
                             const int* inc_code, const int* inc_nbr,
                             const double* y, const double* g_sh,
                             const double* b_sh, const double* th_free,
                             const double* v_free, const void* lu_p,
                             const void* lu_q, const int* perm_p,
                             const int* perm_q, const void* rdiag_p,
                             const void* rdiag_q, int lda, int lanes, int n,
                             int m, int max_sweeps, double tol, int cluster,
                             void* stream) {
  Args a = {};
  a.in = in;
  a.out = out;
  a.dpq = dpq;
  a.inc_ptr = inc_ptr;
  a.inc_code = inc_code;
  a.inc_nbr = inc_nbr;
  a.y = y;
  a.g_sh = g_sh;
  a.b_sh = b_sh;
  a.th_free = th_free;
  a.v_free = v_free;
  a.perm[0] = perm_p;
  a.perm[1] = perm_q;
  a.rdiag[0] = rdiag_p;
  a.rdiag[1] = rdiag_q;
  a.lanes = lanes;
  a.n = n;
  a.m = m;
  a.max_sweeps = max_sweeps;
  a.tol = tol;
  return f32 ? launch<float>(a, lu_p, lu_q, lda, cluster, stream)
             : launch<double>(a, lu_p, lu_q, lda, cluster, stream);
}
