// L3 ladder_dense for Hopper (sm_90a), float64 and float32.
//
// Replaces freedm_tpu/pf/sweeps.py:45 `dense_sweeps` under
// freedm_tpu/pf/ladder.py:184 `_solve` and :209 `_solve_fixed` (and their
// reverse mode): the ladder iteration of csrc/ladder.cu (L1's header gives
// it) with its two sweeps as products with the 0/1 subtree matrix S
// [nb, nb] (S[i][j] = 1 iff branch j lies in branch i's subtree; nb <=
// 2048):
//
//     i_load = conj(s / v) on live phases, 0 elsewhere
//     i_br = S i_load,  drop = z i_br,  v' = (v0 - S^T drop) mask
//     err = max |i_br - i_br_prev| root
//
// and the reverse mode with the products swapped (vbar the cotangent of
// an iteration's output v, walked back over the saved iterates):
//
//     ibbar = conj(z)^T (-S (mask vbar))   (+ the final i_br's cotangent)
//     ilbar = S^T ibbar                      (+ the final i_load's)
//     sbar += conj(ilbar / v),  vbar <- -conj(s ilbar / v^2)  on live phases
//     v0bar = the sum of mask vbar over the branches and the walked iterates
//
// A lane's state, outputs and saved iterates stay in the caller's branch
// order.  Two routes, chosen by ladder_kernels.dense_plan from (nb, dtype)
// alone, so a lane's result is the same bits whatever the lanes beside
// it:
//
// CTA route (a lane's state and S as bits fit one CTA's shared memory:
//   nb <= 642 in float64, 781 in float32; kCtaSmemCap): one CTA a lane runs
//   a whole solve, or a whole reverse mode, in one launch.  S and S^T
//   live in shared memory as rows of bits (the operands'
//   `bits`, caller's order), beside the lane's v, i_load, i_br and drops.
//   A thread owns the (branch, phase) items tid, tid + 256, ... in every
//   pass; a product sums the row's set bits in increasing column, so a
//   zero of S is never added.  Five barriers an iteration; the lane's
//   error is a fixed max over the threads (exact in any order).
//
// Tiled route (above): DFS preorder (Feeder.reorder_preorder, `order`
//   maps a preorder row to the caller's branch), where S's row i is the
//   interval [i, tout_i) and S^T's row j the ancestors of j.  The host
//   cuts S and S^T into blocks of 64 rows x 16 columns and keeps only the
//   nonzero ones, each row tile's list in increasing K: at
//   synthetic_radial(2048) 452 of 4096 blocks of S (11.0%) and 264 of
//   S^T (6.4%), against 1111 / 1129 in the caller's order.  A product is a
//   GEMM over those blocks alone: M = nb rows, N = 6 columns a lane (re,
//   im of three phases), K = nb.  The blocks that are all zero are never
//   staged or multiplied: their terms are exact zeros (for finite
//   right-hand sides), so skipping them changes no sum.
//   A CTA of 256 threads owns a tile of 64 rows x 16 lanes over a slice
//   of at most kSliceBlocks of its row tile's blocks: the root's tile
//   holds all 128 K blocks of S, the median 6, so a long list is cut into
//   near-equal slices of whole blocks (ladder_kernels.slice_plan, a
//   function of S alone, never of the lane count): 70 items for S and 49
//   for S^T at synthetic_radial(2048), x 4 lane tiles at 64 lanes, two
//   CTAs an SM.  A slice stages all its blocks at once by cp.async (one
//   wait): each block's 0/1 bytes (1 KB) and the lanes' right-hand side
//   [16 lanes][16 k][6] (zero-filled beyond nb and the lane count), the
//   lanes' rows padded to kLanePitch words.  float64 multiplies on the
//   FP64 tensor cores (mma.sync m16n8k4 .f64, row_product.cuh's
//   mma_f64): warp w owns rows 16 (w % 4) + [0, 16) and lanes 8 (w / 4) +
//   [0, 8), one 16 x 8 tile a column c of the six, its A fragment S's
//   bytes widened to 0.0 / 1.0 in registers (exact).  float32 keeps the
//   same staging, ownership and skipping, and adds by FFMA on the CUDA
//   cores (no TF32).
//   A tile of one slice keeps its sums in registers.  A tile of several
//   writes each slice's sums to a scratch; the last CTA to take the
//   tile's integer ticket adds the slices in slice order (the same bits
//   whichever CTA comes last) and clears the ticket for the next launch.
//   The tile's sums then go to shared memory, and the epilogue runs 16
//   threads a lane over its (row, phase) items.
//   The lanes' state lives in preorder scratch [B, nb, 6] (a lane's row
//   six contiguous words), so a warp's epilogue touches contiguous rows:
//   scattered through `order` into the caller's layout, its loads ran at
//   a few sectors an instruction and took ~50 of the S product's ~74 us
//   an iteration (H100 lab runs).  A forward call is one launch of the
//   initial state (the loads gathered into preorder), two product
//   launches an iteration and one of the outputs (out of preorder): 2 + 2
//   max_iter, issued without a host read; the reverse mode likewise, the
//   v0 cotangent summed in its last launch (2 + 2 iters).  The loads'
//   currents of an iteration are formed where its input v is written (the
//   initial state, the S^T product's epilogue) into the right-hand side
//   `x` that the S product stages, two buffers used in turn (a lane's
//   i_load is the buffer of its last iteration); the S product's
//   epilogue takes i_br, the root error, the drops (into `y`, which the
//   S^T product stages) and saves the iterate; the S^T product's
//   epilogue writes v' and the next currents.  A lane's
//   iterations and error rotate through three slots (slot it mod 3 read,
//   it + 1 written, it + 2 cleared by the S^T product), so every CTA of
//   an iteration reads the same activity: a stopped lane is frozen, and
//   a tile without an active lane returns at once.  The tiles' errors
//   meet in an integer atomicMax on the bits (a non-negative float orders
//   as its bits, a NaN above +inf).  The reverse mode's S^T epilogue also
//   adds each masked vbar to a per-(lane, branch) total, which the last
//   launch sums over the branches a lane in a fixed order.  No float
//   atomics: every sum runs in a fixed order, so results are
//   bit-identical on repeat.
//
// Both routes report the launches they issued (`launched`).
//
// Bound on an H100 SXM: the function's own work, O(nb) a sweep (L1's
// operations a branch and iteration; chip_smoke.py time_forms), 0.0132 ms
// at synthetic_radial(2048) x 64 x 20 in float64.  The block products do
// the blocks' 64 x 16 multiply-adds each: (452 + 264) blocks x 1024 x 384
// columns x 2 = 0.56 GFLOP an iteration at 64 lanes, 8.8% of the dense
// products of the form before (3.22 GFLOP a product), 8.4 us an iteration
// at the FP64 tensor cores' 67 TFLOP/s.  What holds the tiled route back
// is each launch's chain of waits, not its arithmetic: per-CTA timer
// stamps of an S product at 2048 x 64 (H100 lab runs) read ~0.7 us for
// the lanes' slots, ~6.5 us for the stages' copies (24 MB a launch out of
// L2), ~5.4 us for the products (the tensor cores near their peak), up
// to ~13 us for the root tile's sixteen-slice merge and ~12 us for the
// epilogue's loads and arithmetic, ~38 us a launch in all.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "row_product.cuh"

namespace {

using row_product::cp_async_commit;
using row_product::cp_async_wait;
using row_product::cp_async_zfill;
using row_product::mma_f64;

constexpr unsigned kFull = 0xffffffffu;

// ladder_kernels.py reads the constants below from these lines: keep each
// a `constexpr int name = value;`.
constexpr int kTileThreads = 256;
constexpr int kBlockRows = 64;   // rows of a block of S, and of a tile
constexpr int kBlockK = 16;      // columns of a block
constexpr int kTileLanes = 16;   // lanes of a tile
constexpr int kSliceBlocks = 8;  // blocks of a slice at most
constexpr int kCtaThreads = 256;
constexpr int kCtaSmemCap = 231424;  // 227 KB less 1 KB for the kernels' static arrays
constexpr int kPlanCols = 6;  // a plan row: tile, first block, blocks, slice, slices, slot
constexpr int kLanePitch = kBlockK * 6 + 4;  // words of a lane's rows in a stage
constexpr int kOut = 24;  // a thread's sums: 2 rows x 2 lanes x 6 columns
static_assert(kTileThreads == 256 && kBlockRows == 64 && kTileLanes == 16,
              "eight warps of 16 rows x 8 lanes");

// max that propagates NaN, as torch.amax does.
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (b > a || isnan(b)) ? b : a;
}

// The largest of non-negative values (or NaN) by an integer atomicMax on
// their bits (a NaN's bits, either sign, lie above +inf's).
__device__ __forceinline__ void atomic_max_bits(double* p, double x) {
  atomicMax(reinterpret_cast<unsigned long long*>(p),
            static_cast<unsigned long long>(__double_as_longlong(x)));
}
__device__ __forceinline__ void atomic_max_bits(float* p, float x) {
  atomicMax(reinterpret_cast<unsigned int*>(p), __float_as_uint(x));
}

// conj(s / v) on a live phase (|v|^2 > 0), else 0.
template <typename T>
__device__ __forceinline__ void load_current(T vr, T vi, T sr, T si, T& lr, T& li) {
  const T d = vr * vr + vi * vi;
  lr = T(0);
  li = T(0);
  if (d > T(0)) {
    lr = (sr * vr + si * vi) / d;
    li = -((si * vr - sr * vi) / d);
  }
}

// The reverse mode at one (branch, phase): ilbar (lr, li) against the
// saved iterate (vr, vi) and the load (sr, si): sbar's term and the new
// vbar (0 on a dead phase: the `where` of ladder.py:140-146, never NaN).
template <typename T>
__device__ __forceinline__ void load_adjoint(T lr, T li, T vr, T vi, T sr, T si,
                                             T& br, T& bi, T& wr, T& wi) {
  const T d = vr * vr + vi * vi;
  br = bi = wr = wi = T(0);
  if (d > T(0)) {
    br = (lr * vr + li * vi) / d;
    bi = -((li * vr - lr * vi) / d);
    const T pr = -(sr * lr - si * li), pi = -(sr * li + si * lr);
    const T v2r = vr * vr - vi * vi, v2i = vr * vi + vi * vr;
    const T d2 = v2r * v2r + v2i * v2i;
    wr = (pr * v2r + pi * v2i) / d2;
    wi = -((pi * v2r - pr * v2i) / d2);
  }
}

// ---------------------------------------------------------------------------
// The tiled route
// ---------------------------------------------------------------------------

// The four products of an iteration and of its reverse mode.
enum Mode { kSolveSub = 0, kSolveSubT = 1, kVjpSub = 2, kVjpSubT = 3 };

// The route's state lives in preorder scratch [B, nb, 6] (re of three
// phases, then im), one (lane, row) a contiguous 6 words, so a warp's
// epilogue touches contiguous rows; the caller's arrays are read and
// written once a call (the first and the last launch) but for the saved
// iterates and, in the reverse mode's last iteration, the final
// cotangents.
template <typename T>
struct TiledArgs {
  // The launch's matrix (S or S^T in preorder): its nonzero blocks
  // [n, 64, 16] (0/1 bytes, row-major), each one's K block, and the plan
  // [items, kPlanCols] of slices.
  const unsigned char* blk;
  const int* kb;
  const int* plan;
  const int* order;  // [nb] preorder row -> the caller's branch
  const T* pmask;    // [nb, 3] the phase mask in preorder
  const T* pz_re;    // [nb, 3, 3] the impedances in preorder
  const T* pz_im;
  const T* proot;  // [nb] 1 on substation-fed branches, preorder
  const T* s_re;   // [B, nb, 3] loads, pu (caller's order)
  const T* s_im;
  const T* v0_re;  // [B, 3] source phasors
  const T* v0_im;
  T* v_re;  // [B, nb, 3] the outputs v, i_br, i_load (caller's order)
  T* v_im;
  T* ib_re;
  T* ib_im;
  T* il_re;
  T* il_im;
  T* sp;     // [B, nb, 6] preorder scratch: the loads
  T* x;      // the S product's right-hand side: the loads' currents (two
             // buffers [2, B, nb, 6], iteration k reads k mod 2), mask vbar
  T* y;      // the S^T product's: the drops, ibbar
  T* vp;     // v (forward); sbar (reverse)
  T* ibp;    // i_br (forward); the walked mask vbar added up (reverse)
  T* saved;  // [max_iter, B, nb, 6] each iteration's input v (caller's order), or null
  int* it;   // [3, B] a lane's iterations, one slot an iteration mod 3
  T* err;    // [3, B] its root error, the same slots
  T* part;   // [slots, lane tiles, kOut, kTileThreads] slices' sums
  int* ticket;  // [tiles, lane tiles]
  // The reverse mode.
  const T* gv_re;  // [B, nb, 3] cotangents of the final v, i_br, i_load
  const T* gv_im;
  const T* gb_re;
  const T* gb_im;
  const T* gl_re;
  const T* gl_im;
  T* sbar_re;  // [B, nb, 3] out
  T* sbar_im;
  T* v0bar;    // [B, 6] out
  int nb, lanes, lane_tiles, tiles, max_iter, fixed, k, last;
  T eps;
};

// The forward initial state, a CTA a lane: the loads into preorder, v =
// v0 mask, i_br = 0, the first iteration's currents into x (buffer 0);
// slot 0 holds no iterations and an infinite error, slot 1 (iteration
// 0's) a zero error; CTA 0 clears the tickets.
template <typename T>
__global__ void __launch_bounds__(kTileThreads) tiled_init_kernel(const TiledArgs<T> a) {
  const int b = blockIdx.x, nb = a.nb;
  for (int q = threadIdx.x; q < nb * 3; q += blockDim.x) {
    const int row = q / 3, p = q % 3;
    const size_t o3 = ((size_t)b * nb + a.order[row]) * 3 + p;
    const size_t o6 = ((size_t)b * nb + row) * 6;
    const T sr = a.s_re[o3], si = a.s_im[o3], m = a.pmask[q];
    const T vr = a.v0_re[b * 3 + p] * m, vi = a.v0_im[b * 3 + p] * m;
    a.sp[o6 + p] = sr;
    a.sp[o6 + 3 + p] = si;
    a.vp[o6 + p] = vr;
    a.vp[o6 + 3 + p] = vi;
    a.ibp[o6 + p] = a.ibp[o6 + 3 + p] = T(0);
    load_current(vr, vi, sr, si, a.x[o6 + p], a.x[o6 + 3 + p]);
  }
  if (threadIdx.x == 0) {
    a.it[b] = 0;
    a.err[b] = T(INFINITY);
    a.err[a.lanes + b] = T(0);
  }
  if (b == 0)
    for (int q = threadIdx.x; q < a.tiles * a.lane_tiles; q += blockDim.x) a.ticket[q] = 0;
}

// The forward outputs, a CTA a lane: v, i_br, i_load out of preorder into
// the caller's order (a stopped lane's, as it stopped): i_load is the
// currents of the lane's last iteration, in x buffer (it - 1) mod 2, or 0
// before any.
template <typename T>
__global__ void __launch_bounds__(kTileThreads) tiled_final_kernel(const TiledArgs<T> a) {
  const int b = blockIdx.x, nb = a.nb;
  const int it = a.it[(a.max_iter % 3) * a.lanes + b];
  const T* il = it > 0 ? a.x + ((it - 1) & 1) * (size_t)a.lanes * nb * 6 : nullptr;
  for (int q = threadIdx.x; q < nb * 3; q += blockDim.x) {
    const int row = q / 3, p = q % 3;
    const size_t o3 = ((size_t)b * nb + a.order[row]) * 3 + p;
    const size_t o6 = ((size_t)b * nb + row) * 6;
    a.v_re[o3] = a.vp[o6 + p];
    a.v_im[o3] = a.vp[o6 + 3 + p];
    a.ib_re[o3] = a.ibp[o6 + p];
    a.ib_im[o3] = a.ibp[o6 + 3 + p];
    a.il_re[o3] = il != nullptr ? il[o6 + p] : T(0);
    a.il_im[o3] = il != nullptr ? il[o6 + 3 + p] : T(0);
  }
}

// The reverse mode's initial state, a CTA a lane: the loads into
// preorder, x = mask vbar with vbar the final v's cotangent, the same
// into the running total (ibp), sbar (vp) = 0; CTA 0 clears the tickets.
template <typename T>
__global__ void __launch_bounds__(kTileThreads) tiled_vjp_init_kernel(const TiledArgs<T> a) {
  const int b = blockIdx.x, nb = a.nb;
  for (int q = threadIdx.x; q < nb * 3; q += blockDim.x) {
    const int row = q / 3, p = q % 3;
    const size_t o3 = ((size_t)b * nb + a.order[row]) * 3 + p;
    const size_t o6 = ((size_t)b * nb + row) * 6;
    const T m = a.pmask[q];
    const T wr = a.gv_re[o3] * m, wi = a.gv_im[o3] * m;
    a.sp[o6 + p] = a.s_re[o3];
    a.sp[o6 + 3 + p] = a.s_im[o3];
    a.x[o6 + p] = wr;
    a.x[o6 + 3 + p] = wi;
    a.ibp[o6 + p] = wr;
    a.ibp[o6 + 3 + p] = wi;
    a.vp[o6 + p] = a.vp[o6 + 3 + p] = T(0);
  }
  if (b == 0)
    for (int q = threadIdx.x; q < a.tiles * a.lane_tiles; q += blockDim.x) a.ticket[q] = 0;
}

// The reverse mode's outputs, a CTA a lane: sbar into the caller's order,
// and v0bar = the sum over the branches of the walked mask vbar: each
// thread's rows in increasing order, a fixed butterfly a warp, the warps
// in order.
template <typename T>
__global__ void __launch_bounds__(kTileThreads) tiled_vjp_final_kernel(const TiledArgs<T> a) {
  __shared__ T red[(kTileThreads / 32) * 6];
  const int b = blockIdx.x, nb = a.nb;
  for (int q = threadIdx.x; q < nb * 3; q += blockDim.x) {
    const int row = q / 3, p = q % 3;
    const size_t o3 = ((size_t)b * nb + a.order[row]) * 3 + p;
    const size_t o6 = ((size_t)b * nb + row) * 6;
    a.sbar_re[o3] = a.vp[o6 + p];
    a.sbar_im[o3] = a.vp[o6 + 3 + p];
  }
  const T* w = a.ibp + (size_t)b * nb * 6;
  T part[6] = {0, 0, 0, 0, 0, 0};
  for (int row = threadIdx.x; row < nb; row += blockDim.x) {
#pragma unroll
    for (int c = 0; c < 6; ++c) part[c] += w[row * 6 + c];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < 6; ++c) part[c] += __shfl_xor_sync(kFull, part[c], o);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c) red[(threadIdx.x >> 5) * 6 + c] = part[c];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T tot[6] = {0, 0, 0, 0, 0, 0};
    for (int wp = 0; wp < kTileThreads / 32; ++wp) {
#pragma unroll
      for (int c = 0; c < 6; ++c) tot[c] += red[wp * 6 + c];
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) a.v0bar[b * 6 + c] = tot[c];
  }
}

// One stage: a block's bytes and the lanes' right-hand side rows of its K
// range.
template <typename T>
struct TileStage {
  T xs[kTileLanes * kLanePitch];
  unsigned char ss[kBlockRows * kBlockK];
};

// The product's sums of a tile [16 lanes][64 rows][6] and a second tile
// of its outputs, for the epilogue; they take the stages' place once the
// stages are consumed.
constexpr int kEpiPitch = kBlockRows * 6 + 8;  // words of a lane's rows
template <typename T>
constexpr int tile_smem() {
  return kSliceBlocks * (int)sizeof(TileStage<T>);
}
static_assert(2 * kTileLanes * kEpiPitch * 8 <= kSliceBlocks * (int)sizeof(TileStage<double>) &&
                  2 * kTileLanes * kEpiPitch * 4 <= kSliceBlocks * (int)sizeof(TileStage<float>),
              "the epilogue's two tiles fit the stages' space");

template <typename T>
__device__ __forceinline__ void stage_block(TileStage<T>& st, const TiledArgs<T>& a,
                                            const T* __restrict__ rhs, int bi, int b0) {
  const int tid = threadIdx.x;
  if (tid < kBlockRows * kBlockK / 16)
    cp_async_zfill<16>(st.ss + tid * 16, a.blk + (size_t)bi * (kBlockRows * kBlockK) + tid * 16,
                       16, false, 0);
  const int k0 = a.kb[bi] * kBlockK;
  constexpr int kChunks = kTileLanes * kBlockK * 3;  // two words a copy
  for (int e = tid; e < kChunks; e += kTileThreads) {
    const int l = e / (kBlockK * 3), r = e % (kBlockK * 3), kk = r / 3, h = r % 3;
    const int b = b0 + l, k = k0 + kk;
    const bool ok = b < a.lanes && k < a.nb;
    const T* src = ok ? rhs + ((size_t)b * a.nb + k) * 6 + 2 * h : rhs;
    cp_async_zfill<(int)(2 * sizeof(T))>(st.xs + l * kLanePitch + kk * 6 + 2 * h, src,
                                         ok ? 2 * (int)sizeof(T) : 0, false, 0);
  }
}

// A thread's share of a stage's product: its sums acc[c][e], column c of
// (row rb + g + 8 (e / 2), lane lb + 2 t + e % 2).
template <typename T>
struct TileMac;

template <>
struct TileMac<double> {
  __device__ __forceinline__ static void step(double (&acc)[6][4], const TileStage<double>& st,
                                              int rb, int lb, int g, int t) {
#pragma unroll
    for (int ks = 0; ks < kBlockK / 4; ++ks) {
      const int kk = ks * 4 + t;
      const double a0 = st.ss[(rb + g) * kBlockK + kk] ? 1.0 : 0.0;
      const double a1 = st.ss[(rb + g + 8) * kBlockK + kk] ? 1.0 : 0.0;
      const double* xb = st.xs + (lb + g) * kLanePitch + kk * 6;
#pragma unroll
      for (int c = 0; c < 6; ++c) mma_f64(acc[c], a0, a1, xb[c]);
    }
  }
};

template <>
struct TileMac<float> {
  __device__ __forceinline__ static void step(float (&acc)[6][4], const TileStage<float>& st,
                                              int rb, int lb, int g, int t) {
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      const float s0 = st.ss[(rb + g) * kBlockK + kk] ? 1.0f : 0.0f;
      const float s1 = st.ss[(rb + g + 8) * kBlockK + kk] ? 1.0f : 0.0f;
      const float* x0 = st.xs + (lb + 2 * t) * kLanePitch + kk * 6;
      const float* x1 = x0 + kLanePitch;
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        acc[c][0] = fmaf(s0, x0[c], acc[c][0]);
        acc[c][1] = fmaf(s0, x1[c], acc[c][1]);
        acc[c][2] = fmaf(s1, x0[c], acc[c][2]);
        acc[c][3] = fmaf(s1, x1[c], acc[c][3]);
      }
    }
  }
};

// The epilogue of the (preorder row, lane b, phase p) items, in two
// steps: epi_load reads an item's per-(lane, row) state from device
// memory, epi_compute computes on it and the row's sums y[6] (re of
// three phases, then im) into the tile's outputs in shared memory: `o`,
// the row of a second tile, and y itself where an item reads only its
// own phase.  A thread loads four items (two in the reverse mode's S^T
// product, which loads ten words an item) before it computes any, so
// their loads are in flight together.  The tiles then go out a lane's
// rows at a time, contiguous in the preorder state, by 16-byte stores
// (tile_out): written an item at a time, a half-warp's 8-byte stores fell
// on ten partly written sectors, and the stores took ~11 of the
// epilogue's ~14 us (H100 lab runs).
constexpr int kEpiIn = 10;  // an item's loaded words at most

template <typename T, int MODE>
__device__ __forceinline__ void epi_load(const TiledArgs<T>& a, int row, int b, int p,
                                         T (&in)[kEpiIn]) {
  const size_t o6 = ((size_t)b * a.nb + row) * 6;
  if constexpr (MODE == kSolveSub) {
    in[0] = a.ibp[o6 + p];
    in[1] = a.ibp[o6 + 3 + p];
    if (a.saved != nullptr) {
      in[4] = a.vp[o6 + p];
      in[5] = a.vp[o6 + 3 + p];
    }
  } else if constexpr (MODE == kSolveSubT) {
    in[0] = a.sp[o6 + p];
    in[1] = a.sp[o6 + 3 + p];
  } else if constexpr (MODE == kVjpSub) {
    if (a.last) {
      const size_t o3 = ((size_t)b * a.nb + __ldg(a.order + row)) * 3 + p;
      in[0] = a.gb_re[o3];
      in[1] = a.gb_im[o3];
    }
  } else {
    const int i = __ldg(a.order + row);
    const T* vk = a.saved + (((size_t)a.k * a.lanes + b) * a.nb + i) * 6;
    in[0] = vk[p];
    in[1] = vk[3 + p];
    in[2] = a.sp[o6 + p];
    in[3] = a.sp[o6 + 3 + p];
    in[4] = a.vp[o6 + p];
    in[5] = a.vp[o6 + 3 + p];
    in[6] = a.ibp[o6 + p];
    in[7] = a.ibp[o6 + 3 + p];
    if (a.last) {
      const size_t o3 = ((size_t)b * a.nb + i) * 3 + p;
      in[8] = a.gl_re[o3];
      in[9] = a.gl_im[o3];
    }
  }
}

template <typename T, int MODE>
__device__ __forceinline__ void epi_compute(const TiledArgs<T>& a, int row, int b, int p, T* y,
                                            T* o, const T (&in)[kEpiIn], T& emax) {
  const T* zr = a.pz_re + row * 9;
  const T* zi = a.pz_im + row * 9;
  if constexpr (MODE == kSolveSub) {
    // y = i_br (it goes out as it is): the root error, the drops into o
    // (out to y) and the saved iterate.
    const T yr = y[p], yi = y[3 + p];
    const T dr = yr - in[0], di = yi - in[1];
    emax = nan_max(emax, sqrt(dr * dr + di * di) * __ldg(a.proot + row));
    T er = T(0), ei = T(0);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const T zrq = __ldg(zr + q * 3 + p), ziq = __ldg(zi + q * 3 + p);
      er += y[q] * zrq - y[3 + q] * ziq;
      ei += y[q] * ziq + y[3 + q] * zrq;
    }
    o[p] = er;
    o[3 + p] = ei;
    if (a.saved != nullptr) {
      T* sv = a.saved + (((size_t)a.k * a.lanes + b) * a.nb + __ldg(a.order + row)) * 6;
      sv[p] = in[4];
      sv[3 + p] = in[5];
    }
  } else if constexpr (MODE == kSolveSubT) {
    // The path sums: v' into y (out to vp) and the next iteration's
    // currents into o (out to x).
    const T m = __ldg(a.pmask + row * 3 + p);
    const T vr = (__ldg(a.v0_re + b * 3 + p) - y[p]) * m;
    const T vi = (__ldg(a.v0_im + b * 3 + p) - y[3 + p]) * m;
    y[p] = vr;
    y[3 + p] = vi;
    load_current(vr, vi, in[0], in[1], o[p], o[3 + p]);
  } else if constexpr (MODE == kVjpSub) {
    // B(mask vbar): ibbar[p] = sum_q conj(z[p][q]) (-y[q]) (+ the final
    // i_br's cotangent) into o (out to y).
    T gr = T(0), gi = T(0);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const T zrq = __ldg(zr + p * 3 + q), ziq = __ldg(zi + p * 3 + q);
      gr += zrq * -y[q] + ziq * -y[3 + q];
      gi += zrq * -y[3 + q] - ziq * -y[q];
    }
    if (a.last) {
      gr += in[0];
      gi += in[1];
    }
    o[p] = gr;
    o[3 + p] = gi;
  } else {
    // F(ibbar) = ilbar: sbar into y (out to vp), the new mask vbar into o
    // (out to x) and onto its running total (ibp).
    T lr = y[p], li = y[3 + p];
    if (a.last) {
      lr += in[8];
      li += in[9];
    }
    T br, bi, wr, wi;
    load_adjoint(lr, li, in[0], in[1], in[2], in[3], br, bi, wr, wi);
    y[p] = in[4] + br;
    y[3 + p] = in[5] + bi;
    const T m = __ldg(a.pmask + row * 3 + p);
    wr *= m;
    wi *= m;
    o[p] = wr;
    o[3 + p] = wi;
    const size_t o6 = ((size_t)b * a.nb + row) * 6;
    a.ibp[o6 + p] = in[6] + wr;
    a.ibp[o6 + 3 + p] = in[7] + wi;
  }
}

// A lane's `words` contiguous words of a tile in shared memory out to
// device memory, two words a copy, by its 16 threads (j).
template <typename T>
__device__ __forceinline__ void tile_out(T* __restrict__ dst, const T* __restrict__ src,
                                         int words, int j) {
  using V = typename std::conditional<sizeof(T) == 8, double2, float2>::type;
  for (int w = 2 * j; w < words; w += 32)
    *reinterpret_cast<V*>(dst + w) = *reinterpret_cast<const V*>(src + w);
}

// One product of an iteration over one slice of a row tile's nonzero
// blocks (blockIdx.x, the plan's item) and one tile of 16 lanes
// (blockIdx.y).  Every block of the slice is staged at once (a slice
// holds at most kSliceBlocks).  The solve's products read the lane's
// slot (the iteration mod 3) to decide whether the lane is still active;
// item 0 (the first slice of row tile 0) keeps the books: kSolveSub
// writes the next slot's iteration count (and copies a stopped lane's
// error), kSolveSubT clears the error slot that the next iteration's
// kSolveSub takes the max into.  The epilogue runs on the tile's sums in
// shared memory, 16 threads a lane, a thread the (row, phase) items j,
// j + 16, ... of its lane: a warp's loads and stores fall on contiguous
// preorder rows.
template <typename T, int MODE>
__global__ void __launch_bounds__(kTileThreads, 2) dense_tile_kernel(const TiledArgs<T> a) {
  constexpr bool kSolve = MODE == kSolveSub || MODE == kSolveSubT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileStage<T>* st = reinterpret_cast<TileStage<T>*>(smem_raw);
  T* ys = reinterpret_cast<T*>(smem_raw);  // after the products
  __shared__ int act[kTileLanes];
  __shared__ int is_last;
  const int tid = threadIdx.x, lt = blockIdx.y, b0 = lt * kTileLanes;
  const int* pl = a.plan + blockIdx.x * kPlanCols;
  const int tile = pl[0], first = pl[1], count = pl[2], slice = pl[3], slices = pl[4],
            slot = pl[5];
  if (tid < kTileLanes) {
    const int b = b0 + tid;
    int on = 0;
    if (b < a.lanes) {
      if constexpr (kSolve) {
        const int cur = a.k % 3, nxt = (a.k + 1) % 3;
        const int itb = a.it[cur * a.lanes + b];
        const T e = a.err[cur * a.lanes + b];
        on = itb < a.max_iter && (a.fixed || e >= a.eps);
        if (blockIdx.x == 0 && MODE == kSolveSub) {
          a.it[nxt * a.lanes + b] = itb + on;
          if (!on) a.err[nxt * a.lanes + b] = e;
        }
        if (blockIdx.x == 0 && MODE == kSolveSubT) a.err[((a.k + 2) % 3) * a.lanes + b] = T(0);
      } else {
        on = 1;
      }
    }
    act[tid] = on;
  }
  __syncthreads();
  int any = 0;
#pragma unroll
  for (int j = 0; j < kTileLanes; ++j) any |= act[j];
  if (!any) return;  // every slice of the tile returns alike: no ticket taken
  const T* rhs = MODE == kSolveSub ? a.x + (size_t)(a.k & 1) * a.lanes * a.nb * 6
                                   : MODE == kVjpSub ? a.x : a.y;
  for (int j = 0; j < count; ++j) stage_block<T>(st[j], a, rhs, first + j, b0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = tid >> 5, ln = tid & 31, g = ln >> 2, t = ln & 3;
  const int rb = (warp & 3) * 16, lb = (warp >> 2) * 8;
  T acc[6][4];
#pragma unroll
  for (int c = 0; c < 6; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = T(0);
  for (int j = 0; j < count; ++j) TileMac<T>::step(acc, st[j], rb, lb, g, t);

  if (slices > 1) {
    // Each slice's sums to the scratch; the last CTA of the tile adds
    // them in slice order.
    const size_t plane = (size_t)a.lane_tiles * kOut * kTileThreads;
    T* mine = a.part + slot * plane + (size_t)lt * kOut * kTileThreads + tid;
#pragma unroll
    for (int c = 0; c < 6; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(c * 4 + e) * kTileThreads] = acc[c][e];
    __threadfence();
    __syncthreads();
    if (tid == 0)
      is_last = atomicAdd(a.ticket + tile * a.lane_tiles + lt, 1) == slices - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    const T* base = a.part + (size_t)(slot - slice) * plane + (size_t)lt * kOut * kTileThreads +
                    tid;
#pragma unroll
    for (int c = 0; c < 6; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = __ldcg(base + (c * 4 + e) * kTileThreads);
#pragma unroll 2
    for (int q = 1; q < slices; ++q) {
      const T* pq = base + q * plane;
      T v[6][4];
#pragma unroll
      for (int c = 0; c < 6; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[c][e] = __ldcg(pq + (c * 4 + e) * kTileThreads);
#pragma unroll
      for (int c = 0; c < 6; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][e] += v[c][e];
    }
    if (tid == 0) a.ticket[tile * a.lane_tiles + lt] = 0;
  }

  __syncthreads();  // every warp is done with the stages
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    T* yrow = ys + (lb + 2 * t + (e & 1)) * kEpiPitch + (rb + g + 8 * (e >> 1)) * 6;
#pragma unroll
    for (int c = 0; c < 6; ++c) yrow[c] = acc[c][e];
  }
  __syncthreads();
  const int l = tid >> 4, j = tid & 15, b = b0 + l;
  const bool on = b < a.lanes && act[l];
  const int rows = min(kBlockRows, a.nb - tile * kBlockRows);
  T* yl = ys + l * kEpiPitch;
  T* ol = ys + (kTileLanes + l) * kEpiPitch;
  T emax = T(0);
  if (on) {
    constexpr int kBatch = MODE == kVjpSubT ? 2 : 4;
    for (int u0 = j; u0 < rows * 3; u0 += 16 * kBatch) {
      T in[kBatch][kEpiIn];
#pragma unroll
      for (int h = 0; h < kBatch; ++h) {
        const int u = u0 + 16 * h, r = u / 3;
        if (u < rows * 3) epi_load<T, MODE>(a, tile * kBlockRows + r, b, u - 3 * r, in[h]);
      }
#pragma unroll
      for (int h = 0; h < kBatch; ++h) {
        const int u = u0 + 16 * h, r = u / 3;
        if (u < rows * 3)
          epi_compute<T, MODE>(a, tile * kBlockRows + r, b, u - 3 * r, yl + r * 6, ol + r * 6,
                               in[h], emax);
      }
    }
  }
  __syncthreads();
  if (on) {
    // The tile's outputs: y to ibp (kSolveSub, i_br) or vp (kSolveSubT,
    // v'; kVjpSubT, sbar), o to y (the S products) or x (the S^T ones).
    const size_t o6 = ((size_t)b * a.nb + tile * kBlockRows) * 6;
    T* to_y = MODE == kSolveSub ? a.ibp : MODE == kVjpSub ? nullptr : a.vp;
    T* to_o = MODE == kSolveSub || MODE == kVjpSub
                  ? a.y
                  : MODE == kSolveSubT ? a.x + (size_t)((a.k + 1) & 1) * a.lanes * a.nb * 6
                                       : a.x;
    if (to_y != nullptr) tile_out(to_y + o6, yl, rows * 6, j);
    tile_out(to_o + o6, ol, rows * 6, j);
  }
  if constexpr (MODE == kSolveSub) {
    // A lane's error max over its 16 threads, then into its slot.
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) emax = nan_max(emax, __shfl_xor_sync(kFull, emax, o));
    if (j == 0 && on) atomic_max_bits(a.err + ((a.k + 1) % 3) * a.lanes + b, emax);
  }
}

// ---------------------------------------------------------------------------
// The CTA route
// ---------------------------------------------------------------------------

template <typename T>
struct CtaArgs {
  const unsigned* bits;    // [nb, words] S's rows as bits, caller's order
  const unsigned* bits_t;  // S^T's
  const T* mask;
  const T* z_re;
  const T* z_im;
  const T* root;
  const T* s_re;
  const T* s_im;
  const T* v0_re;
  const T* v0_im;
  T* v_re;
  T* v_im;
  T* ib_re;
  T* ib_im;
  T* il_re;
  T* il_im;
  T* saved;
  int* it;  // [3, B]: the wrapper reads slot max_iter mod 3
  T* err;
  const T* gv_re;
  const T* gv_im;
  const T* gb_re;
  const T* gb_im;
  const T* gl_re;
  const T* gl_im;
  T* sbar_re;
  T* sbar_im;
  T* v0bar;
  int nb, lanes, max_iter, fixed;
  T eps;
};

__host__ __device__ __forceinline__ int bit_words(int nb) { return (nb + 31) / 32; }

// Shared memory of the CTA route: S and S^T as bits, four [nb, 6] buffers.
__host__ __device__ __forceinline__ size_t cta_smem(int nb, int itemsize) {
  return (size_t)2 * nb * bit_words(nb) * 4 + (size_t)24 * nb * itemsize;
}

// The sum over row `row`'s set bits j (increasing) of buf[j * 6 + p] and
// buf[j * 6 + 3 + p].
template <typename T>
__device__ __forceinline__ void bit_row_sum(const unsigned* bits, int words, int row,
                                            const T* buf, int p, T& yr, T& yi) {
  T sr = T(0), si = T(0);
  const unsigned* r = bits + row * words;
  for (int w = 0; w < words; ++w) {
    unsigned m = r[w];
    while (m) {
      const int j = w * 32 + __ffs(m) - 1;
      m &= m - 1;
      sr += buf[j * 6 + p];
      si += buf[j * 6 + 3 + p];
    }
  }
  yr = sr;
  yi = si;
}

template <typename T>
__device__ __forceinline__ void stage_bits(unsigned* sb, const CtaArgs<T>& a, int words) {
  const int n = a.nb * words;
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    sb[q] = a.bits[q];
    sb[n + q] = a.bits_t[q];
  }
}

// A whole solve of lane blockIdx.x in shared memory.
template <typename T>
__global__ void __launch_bounds__(kCtaThreads) dense_cta_kernel(const CtaArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[kCtaThreads / 32];
  __shared__ T lane_err;
  const int nb = a.nb, b = blockIdx.x, tid = threadIdx.x, words = bit_words(nb);
  unsigned* sb = reinterpret_cast<unsigned*>(smem_raw);
  unsigned* st = sb + nb * words;
  T* v = reinterpret_cast<T*>(st + nb * words);  // [nb, 6]
  T* x = v + nb * 6;   // the iteration's i_load
  T* ib = x + nb * 6;  // i_br
  T* d = ib + nb * 6;  // the drops
  stage_bits(sb, a, words);
  const size_t o3 = (size_t)b * nb * 3;
  T v0r[3], v0i[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    v0r[p] = a.v0_re[b * 3 + p];
    v0i[p] = a.v0_im[b * 3 + p];
  }
  for (int q = tid; q < nb * 3; q += blockDim.x) {
    const int i = q / 3, p = q % 3;
    const T m = a.mask[q];
    v[i * 6 + p] = v0r[p] * m;
    v[i * 6 + 3 + p] = v0i[p] * m;
    ib[i * 6 + p] = ib[i * 6 + 3 + p] = T(0);
    x[i * 6 + p] = x[i * 6 + 3 + p] = T(0);
  }
  if (tid == 0) lane_err = T(INFINITY);
  __syncthreads();
  int it = 0;
  for (; it < a.max_iter; ++it) {
    if (!a.fixed && !(lane_err >= a.eps)) break;
    for (int q = tid; q < nb * 3; q += blockDim.x) {
      const int i = q / 3, p = q % 3;
      const T vr = v[i * 6 + p], vi = v[i * 6 + 3 + p];
      load_current(vr, vi, a.s_re[o3 + q], a.s_im[o3 + q], x[i * 6 + p], x[i * 6 + 3 + p]);
      if (a.saved != nullptr) {
        T* sv = a.saved + (((size_t)it * a.lanes + b) * nb + i) * 6;
        sv[p] = vr;
        sv[3 + p] = vi;
      }
    }
    __syncthreads();
    T emax = T(0);
    for (int q = tid; q < nb * 3; q += blockDim.x) {
      const int i = q / 3, p = q % 3;
      T yr, yi;
      bit_row_sum(sb, words, i, x, p, yr, yi);
      const T dr = yr - ib[i * 6 + p], di = yi - ib[i * 6 + 3 + p];
      emax = nan_max(emax, sqrt(dr * dr + di * di) * a.root[i]);
      ib[i * 6 + p] = yr;
      ib[i * 6 + 3 + p] = yi;
    }
    __syncthreads();
    for (int q = tid; q < nb * 3; q += blockDim.x) {
      const int i = q / 3, p = q % 3;
      const T* zr = a.z_re + i * 9;
      const T* zi = a.z_im + i * 9;
      T dr = T(0), di = T(0);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const T yr = ib[i * 6 + k], yi = ib[i * 6 + 3 + k];
        dr += yr * zr[k * 3 + p] - yi * zi[k * 3 + p];
        di += yr * zi[k * 3 + p] + yi * zr[k * 3 + p];
      }
      d[i * 6 + p] = dr;
      d[i * 6 + 3 + p] = di;
    }
    __syncthreads();
    for (int q = tid; q < nb * 3; q += blockDim.x) {
      const int i = q / 3, p = q % 3;
      T yr, yi;
      bit_row_sum(st, words, i, d, p, yr, yi);
      const T m = a.mask[q];
      v[i * 6 + p] = (v0r[p] - yr) * m;
      v[i * 6 + 3 + p] = (v0i[p] - yi) * m;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) emax = nan_max(emax, __shfl_xor_sync(kFull, emax, o));
    if ((tid & 31) == 0) red[tid >> 5] = emax;
    __syncthreads();
    if (tid == 0) {
      T m = red[0];
      for (int w = 1; w < kCtaThreads / 32; ++w) m = nan_max(m, red[w]);
      lane_err = m;
    }
    __syncthreads();
  }
  for (int q = tid; q < nb * 3; q += blockDim.x) {
    const int i = q / 3, p = q % 3;
    a.v_re[o3 + q] = v[i * 6 + p];
    a.v_im[o3 + q] = v[i * 6 + 3 + p];
    a.ib_re[o3 + q] = ib[i * 6 + p];
    a.ib_im[o3 + q] = ib[i * 6 + 3 + p];
    a.il_re[o3 + q] = x[i * 6 + p];
    a.il_im[o3 + q] = x[i * 6 + 3 + p];
  }
  if (tid == 0) {
    const int slot = a.max_iter % 3;
    a.it[slot * a.lanes + b] = it;
    a.err[slot * a.lanes + b] = lane_err;
  }
}

// A whole reverse mode of lane blockIdx.x in shared memory.
template <typename T>
__global__ void __launch_bounds__(kCtaThreads) dense_cta_vjp_kernel(const CtaArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[(kCtaThreads / 32) * 6];
  const int nb = a.nb, b = blockIdx.x, tid = threadIdx.x, words = bit_words(nb);
  const int iters = a.max_iter;
  unsigned* sb = reinterpret_cast<unsigned*>(smem_raw);
  unsigned* st = sb + nb * words;
  T* w = reinterpret_cast<T*>(st + nb * words);  // [nb, 6] vbar
  T* am = w + nb * 6;   // mask vbar, then ibbar
  T* db = am + nb * 6;  // B(mask vbar)
  stage_bits(sb, a, words);
  const size_t o3 = (size_t)b * nb * 3;
  for (int q = tid; q < nb * 3; q += blockDim.x) {
    const int i = q / 3, p = q % 3;
    w[i * 6 + p] = a.gv_re[o3 + q];
    w[i * 6 + 3 + p] = a.gv_im[o3 + q];
    a.sbar_re[o3 + q] = a.sbar_im[o3 + q] = T(0);
  }
  T part[6] = {0, 0, 0, 0, 0, 0};  // this thread's items of v0bar
  __syncthreads();
  for (int k = iters - 1; k >= 0; --k) {
    const bool last = k == iters - 1;
    for (int q = tid; q < nb * 3; q += blockDim.x) {
      const int i = q / 3, p = q % 3;
      const T m = a.mask[q];
      const T ar = w[i * 6 + p] * m, ai = w[i * 6 + 3 + p] * m;
      am[i * 6 + p] = ar;
      am[i * 6 + 3 + p] = ai;
      part[p] += ar;
      part[3 + p] += ai;
    }
    __syncthreads();
    for (int q = tid; q < nb * 3; q += blockDim.x) {
      const int i = q / 3, p = q % 3;
      bit_row_sum(sb, words, i, am, p, db[i * 6 + p], db[i * 6 + 3 + p]);
    }
    __syncthreads();
    for (int q = tid; q < nb * 3; q += blockDim.x) {
      const int i = q / 3, qq = q % 3;
      const T* zr = a.z_re + i * 9;
      const T* zi = a.z_im + i * 9;
      T gr = T(0), gi = T(0);
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const T yr = db[i * 6 + p], yi = db[i * 6 + 3 + p];
        gr += zr[qq * 3 + p] * -yr + zi[qq * 3 + p] * -yi;
        gi += zr[qq * 3 + p] * -yi - zi[qq * 3 + p] * -yr;
      }
      if (last) {
        gr += a.gb_re[o3 + q];
        gi += a.gb_im[o3 + q];
      }
      am[i * 6 + qq] = gr;
      am[i * 6 + 3 + qq] = gi;
    }
    __syncthreads();
    for (int q = tid; q < nb * 3; q += blockDim.x) {
      const int i = q / 3, p = q % 3;
      T lr, li;
      bit_row_sum(st, words, i, am, p, lr, li);
      if (last) {
        lr += a.gl_re[o3 + q];
        li += a.gl_im[o3 + q];
      }
      const T* vk = a.saved + (((size_t)k * a.lanes + b) * nb + i) * 6;
      T br, bi, wr, wi;
      load_adjoint(lr, li, vk[p], vk[3 + p], a.s_re[o3 + q], a.s_im[o3 + q], br, bi, wr, wi);
      a.sbar_re[o3 + q] += br;
      a.sbar_im[o3 + q] += bi;
      w[i * 6 + p] = wr;
      w[i * 6 + 3 + p] = wi;
    }
    __syncthreads();
  }
  for (int q = tid; q < nb * 3; q += blockDim.x) {
    const int i = q / 3, p = q % 3;
    const T m = a.mask[q];
    part[p] += w[i * 6 + p] * m;
    part[3 + p] += w[i * 6 + 3 + p] * m;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < 6; ++c) part[c] += __shfl_xor_sync(kFull, part[c], o);
  }
  if ((tid & 31) == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c) red[(tid >> 5) * 6 + c] = part[c];
  }
  __syncthreads();
  if (tid == 0) {
    T tot[6] = {0, 0, 0, 0, 0, 0};
    for (int wp = 0; wp < kCtaThreads / 32; ++wp) {
#pragma unroll
      for (int c = 0; c < 6; ++c) tot[c] += red[wp * 6 + c];
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) a.v0bar[b * 6 + c] = tot[c];
  }
}

// ---------------------------------------------------------------------------
// Host entries
// ---------------------------------------------------------------------------

struct Matrix {
  const unsigned char* blk;
  const int* kb;
  const int* plan;
  int items;
};

template <typename T, int MODE>
static cudaError_t launch_product(TiledArgs<T>& a, const Matrix& m, cudaStream_t st) {
  a.blk = m.blk;
  a.kb = m.kb;
  a.plan = m.plan;
  // The stages of a slice pass 48 KB in float64, where a kernel opts in.
  constexpr int smem = tile_smem<T>();
  const cudaError_t e = cudaFuncSetAttribute(
      dense_tile_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dense_tile_kernel<T, MODE><<<dim3((unsigned)m.items, (unsigned)a.lane_tiles), kTileThreads,
                                smem, st>>>(a);
  return cudaGetLastError();
}

// The shape and the preorder tables and scratch of a tiled call; `work`
// is [6, B, nb, 6]: the loads, x (two), y, vp, ibp in preorder.
template <typename T>
static int tiled_setup(TiledArgs<T>& a, const Matrix& s, const Matrix& t, const int* order,
                       const T* pmask, const T* pz_re, const T* pz_im, const T* s_re,
                       const T* s_im, T* work, T* part, int* ticket, int nb, int lanes) {
  if (nb <= 0 || lanes <= 0 || s.items <= 0 || t.items <= 0) return (int)cudaErrorInvalidValue;
  a.nb = nb;
  a.lanes = lanes;
  a.lane_tiles = (lanes + kTileLanes - 1) / kTileLanes;
  a.tiles = (nb + kBlockRows - 1) / kBlockRows;
  if (a.lane_tiles > 65535) return (int)cudaErrorInvalidValue;
  a.order = order;
  a.pmask = pmask;
  a.pz_re = pz_re;
  a.pz_im = pz_im;
  a.s_re = s_re;
  a.s_im = s_im;
  const size_t n = (size_t)lanes * nb * 6;
  a.sp = work;
  a.x = work + n;  // two buffers in the forward mode
  a.y = work + 3 * n;
  a.vp = work + 4 * n;
  a.ibp = work + 5 * n;
  a.part = part;
  a.ticket = ticket;
  return 0;
}

template <typename T>
static int dense_tiled(const Matrix& s, const Matrix& t, const int* order, const T* pmask,
                       const T* pz_re, const T* pz_im, const T* proot, const T* s_re,
                       const T* s_im, const T* v0_re, const T* v0_im, T* v_re, T* v_im,
                       T* ib_re, T* ib_im, T* il_re, T* il_im, T* work, T* saved, int* it,
                       T* err, T* part, int* ticket, int nb, int lanes, int max_iter,
                       int fixed, double eps, int* launched, void* stream) {
  *launched = 0;
  TiledArgs<T> a = {};
  if (max_iter < 0) return (int)cudaErrorInvalidValue;
  const int bad = tiled_setup(a, s, t, order, pmask, pz_re, pz_im, s_re, s_im, work, part,
                              ticket, nb, lanes);
  if (bad) return bad;
  a.proot = proot;
  a.v0_re = v0_re;
  a.v0_im = v0_im;
  a.v_re = v_re;
  a.v_im = v_im;
  a.ib_re = ib_re;
  a.ib_im = ib_im;
  a.il_re = il_re;
  a.il_im = il_im;
  a.saved = saved;
  a.it = it;
  a.err = err;
  a.max_iter = max_iter;
  a.fixed = fixed;
  a.eps = (T)eps;
  const cudaStream_t st = (cudaStream_t)stream;
  tiled_init_kernel<T><<<(unsigned)lanes, kTileThreads, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  *launched += e == cudaSuccess;
  for (int k = 0; k < max_iter && e == cudaSuccess; ++k) {
    a.k = k;
    e = launch_product<T, kSolveSub>(a, s, st);
    if (e != cudaSuccess) break;
    ++*launched;
    e = launch_product<T, kSolveSubT>(a, t, st);
    *launched += e == cudaSuccess;
  }
  if (e != cudaSuccess) return (int)e;
  tiled_final_kernel<T><<<(unsigned)lanes, kTileThreads, 0, st>>>(a);
  e = cudaGetLastError();
  *launched += e == cudaSuccess;
  return (int)e;
}

template <typename T>
static int dense_tiled_vjp(const Matrix& s, const Matrix& t, const int* order, const T* pmask,
                           const T* pz_re, const T* pz_im, const T* saved, const T* s_re,
                           const T* s_im, const T* gv_re, const T* gv_im, const T* gb_re,
                           const T* gb_im, const T* gl_re, const T* gl_im, T* sbar_re,
                           T* sbar_im, T* v0bar, T* work, T* part, int* ticket, int nb,
                           int lanes, int iters, int* launched, void* stream) {
  *launched = 0;
  TiledArgs<T> a = {};
  if (iters < 0) return (int)cudaErrorInvalidValue;
  const int bad = tiled_setup(a, s, t, order, pmask, pz_re, pz_im, s_re, s_im, work, part,
                              ticket, nb, lanes);
  if (bad) return bad;
  a.saved = const_cast<T*>(saved);
  a.gv_re = gv_re;
  a.gv_im = gv_im;
  a.gb_re = gb_re;
  a.gb_im = gb_im;
  a.gl_re = gl_re;
  a.gl_im = gl_im;
  a.sbar_re = sbar_re;
  a.sbar_im = sbar_im;
  a.v0bar = v0bar;
  a.max_iter = iters;
  const cudaStream_t st = (cudaStream_t)stream;
  tiled_vjp_init_kernel<T><<<(unsigned)lanes, kTileThreads, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  *launched += e == cudaSuccess;
  for (int k = iters - 1; k >= 0 && e == cudaSuccess; --k) {
    a.k = k;
    a.last = k == iters - 1;
    e = launch_product<T, kVjpSub>(a, s, st);
    if (e != cudaSuccess) break;
    ++*launched;
    e = launch_product<T, kVjpSubT>(a, t, st);
    *launched += e == cudaSuccess;
  }
  if (e != cudaSuccess) return (int)e;
  tiled_vjp_final_kernel<T><<<(unsigned)lanes, kTileThreads, 0, st>>>(a);
  e = cudaGetLastError();
  *launched += e == cudaSuccess;
  return (int)e;
}

template <typename T>
static int launch_cta(void (*kernel)(CtaArgs<T>), const CtaArgs<T>& a, int* launched,
                      void* stream) {
  *launched = 0;
  if (a.nb <= 0 || a.lanes <= 0 || a.max_iter < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = cta_smem(a.nb, (int)sizeof(T));
  if (smem > (size_t)kCtaSmemCap) return (int)cudaErrorInvalidValue;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)a.lanes, kCtaThreads, smem, (cudaStream_t)stream>>>(a);
  e = cudaGetLastError();
  *launched = e == cudaSuccess;
  return (int)e;
}

}  // namespace

#define DENSE_ENTRY(SUFFIX, T)                                                               \
  extern "C" int ladder_dense_tiled_##SUFFIX(                                                \
      const unsigned char* s_blk, const int* s_kb, const int* s_plan,                        \
      const unsigned char* t_blk, const int* t_kb, const int* t_plan, const int* order,      \
      const T* pmask, const T* pz_re, const T* pz_im, const T* proot, const T* s_re,         \
      const T* s_im, const T* v0_re, const T* v0_im, T* v_re, T* v_im, T* ib_re,             \
      T* ib_im, T* il_re, T* il_im, T* work, T* saved, int* it, T* err, T* part,             \
      int* ticket, int s_items, int t_items, int nb, int lanes, int max_iter, int fixed,     \
      double eps, int* launched, void* stream) {                                             \
    const Matrix s = {s_blk, s_kb, s_plan, s_items}, t = {t_blk, t_kb, t_plan, t_items};    \
    return dense_tiled<T>(s, t, order, pmask, pz_re, pz_im, proot, s_re, s_im, v0_re,        \
                          v0_im, v_re, v_im, ib_re, ib_im, il_re, il_im, work, saved, it,    \
                          err, part, ticket, nb, lanes, max_iter, fixed, eps, launched,      \
                          stream);                                                           \
  }                                                                                          \
  extern "C" int ladder_dense_tiled_vjp_##SUFFIX(                                            \
      const unsigned char* s_blk, const int* s_kb, const int* s_plan,                        \
      const unsigned char* t_blk, const int* t_kb, const int* t_plan, const int* order,      \
      const T* pmask, const T* pz_re, const T* pz_im, const T* saved, const T* s_re,         \
      const T* s_im, const T* gv_re, const T* gv_im, const T* gb_re, const T* gb_im,         \
      const T* gl_re, const T* gl_im, T* sbar_re, T* sbar_im, T* v0bar, T* work, T* part,    \
      int* ticket, int s_items, int t_items, int nb, int lanes, int iters, int* launched,    \
      void* stream) {                                                                        \
    const Matrix s = {s_blk, s_kb, s_plan, s_items}, t = {t_blk, t_kb, t_plan, t_items};    \
    return dense_tiled_vjp<T>(s, t, order, pmask, pz_re, pz_im, saved, s_re, s_im, gv_re,    \
                              gv_im, gb_re, gb_im, gl_re, gl_im, sbar_re, sbar_im, v0bar,    \
                              work, part, ticket, nb, lanes, iters, launched, stream);       \
  }                                                                                          \
  extern "C" int ladder_dense_cta_##SUFFIX(                                                  \
      const unsigned* bits, const unsigned* bits_t, const T* mask, const T* z_re,            \
      const T* z_im, const T* root, const T* s_re, const T* s_im, const T* v0_re,            \
      const T* v0_im, T* v_re, T* v_im, T* ib_re, T* ib_im, T* il_re, T* il_im, T* saved,    \
      int* it, T* err, int nb, int lanes, int max_iter, int fixed, double eps,               \
      int* launched, void* stream) {                                                         \
    CtaArgs<T> a = {};                                                                       \
    a.bits = bits;                                                                           \
    a.bits_t = bits_t;                                                                       \
    a.mask = mask;                                                                           \
    a.z_re = z_re;                                                                           \
    a.z_im = z_im;                                                                           \
    a.root = root;                                                                           \
    a.s_re = s_re;                                                                           \
    a.s_im = s_im;                                                                           \
    a.v0_re = v0_re;                                                                         \
    a.v0_im = v0_im;                                                                         \
    a.v_re = v_re;                                                                           \
    a.v_im = v_im;                                                                           \
    a.ib_re = ib_re;                                                                         \
    a.ib_im = ib_im;                                                                         \
    a.il_re = il_re;                                                                         \
    a.il_im = il_im;                                                                         \
    a.saved = saved;                                                                         \
    a.it = it;                                                                               \
    a.err = err;                                                                             \
    a.nb = nb;                                                                               \
    a.lanes = lanes;                                                                         \
    a.max_iter = max_iter;                                                                   \
    a.fixed = fixed;                                                                         \
    a.eps = (T)eps;                                                                          \
    return launch_cta<T>(dense_cta_kernel<T>, a, launched, stream);                          \
  }                                                                                          \
  extern "C" int ladder_dense_cta_vjp_##SUFFIX(                                              \
      const unsigned* bits, const unsigned* bits_t, const T* mask, const T* z_re,            \
      const T* z_im, const T* saved, const T* s_re, const T* s_im, const T* gv_re,           \
      const T* gv_im, const T* gb_re, const T* gb_im, const T* gl_re, const T* gl_im,        \
      T* sbar_re, T* sbar_im, T* v0bar, int nb, int lanes, int iters, int* launched,         \
      void* stream) {                                                                        \
    CtaArgs<T> a = {};                                                                       \
    a.bits = bits;                                                                           \
    a.bits_t = bits_t;                                                                       \
    a.mask = mask;                                                                           \
    a.z_re = z_re;                                                                           \
    a.z_im = z_im;                                                                           \
    a.saved = const_cast<T*>(saved);                                                         \
    a.s_re = s_re;                                                                           \
    a.s_im = s_im;                                                                           \
    a.gv_re = gv_re;                                                                         \
    a.gv_im = gv_im;                                                                         \
    a.gb_re = gb_re;                                                                         \
    a.gb_im = gb_im;                                                                         \
    a.gl_re = gl_re;                                                                         \
    a.gl_im = gl_im;                                                                         \
    a.sbar_re = sbar_re;                                                                     \
    a.sbar_im = sbar_im;                                                                     \
    a.v0bar = v0bar;                                                                         \
    a.nb = nb;                                                                               \
    a.lanes = lanes;                                                                         \
    a.max_iter = iters;                                                                      \
    return launch_cta<T>(dense_cta_vjp_kernel<T>, a, launched, stream);                      \
  }

DENSE_ENTRY(f64, double)
DENSE_ENTRY(f32, float)
