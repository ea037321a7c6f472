// The complex row product I = Y V for Hopper (sm_90a), shared by K2
// (newton.cu), F1 and I1 (solvers.cu).
//
// Two forms, each summing in one fixed order, so every kernel that uses a
// form gets the same bits from the same inputs:
//
//   tiled   one Y [n, n] of every lane: a GEMM of M = n rows, N = B lanes
//           and K = n columns (launch_tiled) that hands each (lane, row)'s
//           sum to the caller's epilogue functor.  Y and V come from device
//           memory: V [B, n] is written by each caller's pre-pass (K2's and
//           F1's V = v e^{j theta}, I1's injection conj(S/V)).
//   warp_product  a warp per (lane, row): the row read coalesced, eight
//           loads in flight a thread, the lane's V beside it (F1 keeps it
//           in shared memory), reduced by a fixed xor-shuffle tree.  For a
//           per-lane Y [B, n, n], where no tile of Y serves two lanes,
//           or a lane count too small to fill a tile.
//
// Each accumulates re += y_re v_re - y_im v_im, im += y_re v_im + y_im v_re.
//
// The tiled form.  A block of kThreads = 256 threads owns a tile of
// kTileRows = 64 rows x kTileLanes = 64 lanes over one K slice and walks the
// slice in stages of kTileK = 16 columns: a ring of kStages = 3 stages of
// the Y (re, im) and V (re, im) tiles in shared memory, filled by cp.async
// (16-byte copies where n and the pointers allow, else one element a copy;
// out-of-range elements are zero-filled by the copy, so ragged n and lane
// counts need no padding by the caller) while the warps compute on the
// stage before.  A tile row keeps its 16 columns in one 128-byte line with
// its 16-byte chunks permuted by XOR with 4 (r mod 4): the 16 threads of a
// half-warp reading (row g, column t), g, t < 4, hit 16 distinct 8-byte
// slots.
//
//   float64 runs on the FP64 tensor cores: mma.sync m16n8k4 .f64 (wgmma
//   has no fp64 form; the k8 and k16 shapes reach the same 66-67 TFLOP/s
//   on an H100 and cost more registers).  A warp owns 32 rows x 16 lanes,
//   2 x 2 tiles of 16 x 8 with a real and an imaginary accumulator each
//   (64 registers); a column step of 4 takes four products a tile, Yr Vr
//   and Yi (-Vi) into re, Yr Vi and Yi Vr into im.  A warp whose rows or
//   lanes all lie beyond the matrix skips its products (one warp-uniform
//   branch a stage: branches around each tile's products cost 20-25% of
//   the rate), so 16 lanes run on two of the eight warps.
//   float32 stays off the tensor cores (no TF32 in the port): the same
//   staging, with a 4 x 4 micro-tile of (row, lane) outputs a thread
//   summed by FFMA on the CUDA cores.
//
// Split K.  The K range is cut into `splits` slices of whole stages
// (newton_kernels.product_splits, a function of (n, B) alone); each block
// writes its slice's partial sums to a [splits, 2, B, n] scratch, and a
// second kernel (epilogue_kernel), a warp a (lane, 64-row tile), adds each
// row's slices in split order and hands the sum to the caller's epilogue
// functor, whose row values it reduces to the lane's max over the tile —
// I1's and F1's row errors, which their lane finish then reduces over
// ceil(n / 64) values a lane instead of n (a max is exact in any order).
// Order, hence bits: each output sums its slice's columns in increasing k
// (the tensor core's own order within a step of 4) and the slices in split
// order; no atomics.  K2 and F1 get the same bits from the same Y and V.
// The epilogues read their inputs through __ldg.  (Two forms measured
// slower on an H100: the last block of a tile adding the slices under an
// integer ticket spent 25-45 us in those few blocks, and a cluster a tile
// adding them in distributed shared memory ran 7-8 us longer than the
// plain grid with this pass: the clusters' blocks pack two to an SM and
// the card holds 30 clusters of 8.)
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp64 through the tensor
// cores): the dense product is 8 n^2 B operations.  K2 at mesh2000 x 64:
// 2.05 GFLOP, 0.031 ms at the tensor rate, against 0.019 ms for one read
// of the 64 MB Ybus; I1 on the CIM feeder (n = 3000) x 64: 4.6 GFLOP, 0.069
// ms, A read once 0.043 ms.  Both are operation-bound once Y is read once.
// Filling the card: one 64 x 64 tile over the whole K at mesh2000 x 64
// gives 32 blocks on 132 SMs; eight slices give 256 blocks, each reading
// its 64 x 256 slice of Y once (Y comes from HBM once) and its 64 x 256
// slice of V from L2 (64 MB of V reads in all), and 16 MB of partial sums
// for the epilogue pass.  A stage is 32 KB (96 KB for three); ptxas gives
// the kernels 128 registers a thread, so two blocks fit an SM.  Measured
// on an H100 (lab runs): the product alone at 0.047 ms (43 TFLOP/s) at
// mesh2000 x 64 and 0.103 ms (45 TFLOP/s) on the CIM feeder x 64, against
// complex128 torch.matmul's 0.048 and 0.101; without its loads 0.040 and
// 0.084 ms (52-55 TFLOP/s, the loop's own ceiling), its loads alone 0.026
// and 0.060 ms.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace row_product {

// newton_kernels.py reads kTileRows, kTileLanes, kTileK and kMaxSplits from
// these lines for its split plan: keep each a `constexpr int name = value;`.
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kTileRows = 64;   // rows of Y a block
constexpr int kTileLanes = 64;  // lanes a block
constexpr int kTileK = 16;      // columns a stage
constexpr int kStages = 3;
constexpr int kMaxSplits = 16;
constexpr int kEpiWarps = 8;     // epilogue_kernel's warps a block
static_assert(kTileRows == kTileLanes, "the Y and V tiles share one layout");

// Element (r, k) of a [64][16] tile: its 16-byte chunks permuted by XOR
// with 4 (r mod 4), which keeps 16-byte (and 8-byte double) chunks whole.
__device__ __forceinline__ int swz(int r, int k) {
  return r * kTileK + (k ^ ((r & 3) << 2));
}

template <typename T>
struct Stage {
  T y_re[kTileRows * kTileK];
  T y_im[kTileRows * kTileK];
  T v_re[kTileLanes * kTileK];
  T v_im[kTileLanes * kTileK];
};

// An L2 policy that lets a copy's lines go first: Y is read once, and its
// stream should not push the partial sums (and V) out of L2 before the
// epilogue pass reads them (3-4% of the product's time on an H100).
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

// One global -> shared copy of BYTES bytes of which the first `src_bytes`
// are read and the rest zero-filled; 16-byte copies under the L2 policy
// `pol` where `hint`.
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
                                               int src_bytes, bool hint,
                                               uint64_t pol) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    if (hint)
      asm volatile(
          "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n"
          ::"r"(s), "l"(src), "r"(src_bytes), "l"(pol)
          : "memory");
    else
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                   "l"(src), "r"(src_bytes)
                   : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage the columns [k0, k0 + kTileK) of the block's Y rows (from i0) or
// V lanes (from b0) into (t_re, t_im); zeros beyond row `limit` and column
// kend.  VEC elements a copy, under the L2 policy `pol` where `hint`.
template <typename T, int VEC>
__device__ __forceinline__ void load_pair(T* t_re, T* t_im,
                                          const T* __restrict__ g_re,
                                          const T* __restrict__ g_im,
                                          int limit, int n, int r0, int k0,
                                          int kend, bool hint = false,
                                          uint64_t pol = 0) {
  constexpr int kChunks = kTileK / VEC;             // copies a tile row
  constexpr int kPerMat = kTileRows * kChunks;      // copies a tile
  constexpr int kRounds = kPerMat / kThreads;       // a thread's, a tile
  static_assert(kPerMat % kThreads == 0, "whole rounds a tile");
#pragma unroll
  for (int it = 0; it < 2 * kRounds; ++it) {
    const int mat = it / kRounds;  // re, im
    const int e = (it % kRounds) * kThreads + threadIdx.x;
    const int r = e / kChunks, c = (e % kChunks) * VEC;
    const int gr = r0 + r;
    const int k = k0 + c;
    int valid = kend - k;
    valid = valid < 0 ? 0 : (valid > VEC ? VEC : valid);
    if (gr >= limit) valid = 0;
    const T* base = mat ? g_im : g_re;
    const T* src = valid > 0 ? base + (int64_t)gr * n + k : base;
    cp_async_zfill<VEC * sizeof(T)>((mat ? t_im : t_re) + swz(r, c), src,
                                    valid * (int)sizeof(T), hint, pol);
  }
}

// The m16n8k4 fp64 tensor-core product c += a b: a (16 x 4, rows g and
// g + 8 at column t), b (4 x 8, column g at row t), c rows g (c0, c1) and
// g + 8 (c2, c3) at columns 2t, 2t + 1, for g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_f64(double (&c)[4], double a0, double a1,
                                        double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// A thread's share of the block's tile and its arithmetic, by type.
template <typename T>
struct Mac;

// float64: warp w owns rows 32 (w % 2) + [0, 32) and lanes 16 (w / 2) +
// [0, 16) of the tile, as 2 x 2 tensor-core tiles of 16 x 8.
template <>
struct Mac<double> {
  double re[2][2][4], im[2][2][4];
  bool on;  // some of the warp's rows and lanes lie in the matrix
  int g, t, rb, lb;

  __device__ __forceinline__ void init(int n, int lanes, int i0, int b0) {
    const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
    g = ln >> 2;
    t = ln & 3;
    rb = (warp & 1) * 32;
    lb = (warp >> 1) * 16;
    on = i0 + rb < n && b0 + lb < lanes;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int c = 0; c < 4; ++c) re[a][b][c] = im[a][b][c] = 0.0;
  }

  __device__ __forceinline__ void step(const Stage<double>& st) {
    if (!on) return;
#pragma unroll
    for (int ks = 0; ks < kTileK / 4; ++ks) {
      // Column 4 ks + t of a row r = g (mod 4), swizzled (swz).
      const int kk = ((ks ^ (g & 3)) << 2) + t;
      double ar[2][2], ai[2][2], br[2], bi[2], bn[2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int r = rb + 16 * a + g;
        ar[a][0] = st.y_re[r * kTileK + kk];
        ar[a][1] = st.y_re[(r + 8) * kTileK + kk];
        ai[a][0] = st.y_im[r * kTileK + kk];
        ai[a][1] = st.y_im[(r + 8) * kTileK + kk];
        const int l = lb + 8 * a + g;
        br[a] = st.v_re[l * kTileK + kk];
        bi[a] = st.v_im[l * kTileK + kk];
        bn[a] = -bi[a];
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          mma_f64(re[a][b], ar[a][0], ar[a][1], br[b]);
          mma_f64(re[a][b], ai[a][0], ai[a][1], bn[b]);
          mma_f64(im[a][b], ar[a][0], ar[a][1], bi[b]);
          mma_f64(im[a][b], ai[a][0], ai[a][1], br[b]);
        }
    }
  }

  // f(row, lane, re, im) for each of the thread's outputs in the matrix.
  template <typename F>
  __device__ __forceinline__ void each(int n, int lanes, int i0, int b0,
                                       F f) const {
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = i0 + rb + 16 * a + g + 8 * (c >> 1);
          const int lane = b0 + lb + 8 * b + 2 * t + (c & 1);
          if (row < n && lane < lanes) f(row, lane, re[a][b][c], im[a][b][c]);
        }
  }

};

// float32: thread (warp w, lane l) owns rows tr + 16 i and lanes tc + 16 j,
// i, j < 4, with tr = 4 (w % 4) + l % 4 and tc = 8 (w / 4) + l / 4: a
// warp's Y reads fall on distinct banks (rows of distinct r mod 4).
template <>
struct Mac<float> {
  float re[4][4], im[4][4];
  int tr, tc;

  __device__ __forceinline__ void init(int, int, int, int) {
    const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
    tr = (warp & 3) * 4 + (ln & 3);
    tc = (warp >> 2) * 8 + (ln >> 2);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.0f;
  }

  __device__ __forceinline__ void step(const Stage<float>& st) {
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      float yr[4], yi[4], vr[4], vi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        yr[i] = st.y_re[swz(tr + 16 * i, k)];
        yi[i] = st.y_im[swz(tr + 16 * i, k)];
        vr[i] = st.v_re[swz(tc + 16 * i, k)];
        vi[i] = st.v_im[swz(tc + 16 * i, k)];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          re[i][j] = fmaf(yr[i], vr[j], re[i][j]);
          re[i][j] = fmaf(-yi[i], vi[j], re[i][j]);
          im[i][j] = fmaf(yr[i], vi[j], im[i][j]);
          im[i][j] = fmaf(yi[i], vr[j], im[i][j]);
        }
    }
  }

  template <typename F>
  __device__ __forceinline__ void each(int n, int lanes, int i0, int b0,
                                       F f) const {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = i0 + tr + 16 * i, lane = b0 + tc + 16 * j;
        if (row < n && lane < lanes) f(row, lane, re[i][j], im[i][j]);
      }
  }

};

// Block (row tile blockIdx.x, lane tile blockIdx.y, K slice blockIdx.z) of
// I = Y V into part[2 z] (re) and part[2 z + 1] (im), [B, n] each.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) tiled_kernel(
    const T* __restrict__ y_re, const T* __restrict__ y_im,
    const T* __restrict__ v_re, const T* __restrict__ v_im,
    T* __restrict__ part, int lanes, int n, int kchunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage<T>* st = reinterpret_cast<Stage<T>*>(smem_raw);
  const int i0 = blockIdx.x * kTileRows;
  const int b0 = blockIdx.y * kTileLanes;
  const int kb = blockIdx.z * kchunk;
  const int ke = min(n, kb + kchunk);
  const int tiles = (ke - kb + kTileK - 1) / kTileK;
  Mac<T> mac;
  mac.init(n, lanes, i0, b0);
  const uint64_t y_pol = evict_first_policy();
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < tiles) {
      load_pair<T, VEC>(st[p].y_re, st[p].y_im, y_re, y_im, n, n, i0,
                        kb + p * kTileK, ke, true, y_pol);
      load_pair<T, VEC>(st[p].v_re, st[p].v_im, v_re, v_im, lanes, n, b0,
                        kb + p * kTileK, ke);
    }
    cp_async_commit();
  }
  for (int s = 0; s < tiles; ++s) {
    cp_async_wait<kStages - 2>();  // stage s has landed (this thread's)
    __syncthreads();               // ... every thread's; s - 1 is consumed
    const int next = s + kStages - 1;
    if (next < tiles) {
      Stage<T>& d = st[next % kStages];
      load_pair<T, VEC>(d.y_re, d.y_im, y_re, y_im, n, n, i0,
                        kb + next * kTileK, ke, true, y_pol);
      load_pair<T, VEC>(d.v_re, d.v_im, v_re, v_im, lanes, n, b0,
                        kb + next * kTileK, ke);
    }
    cp_async_commit();
    mac.step(st[s % kStages]);
  }
  const int64_t plane = (int64_t)lanes * n;
  T* out = part + 2 * blockIdx.z * plane;
  mac.each(n, lanes, i0, b0, [&](int row, int lane, T re, T im) {
    const int64_t k = (int64_t)lane * n + row;
    out[k] = re;
    out[plane + k] = im;
  });
}

// Row tiles of the product: the row values epi.lane_tile gets a lane.
__host__ __device__ __forceinline__ int row_tiles(int n) {
  return (n + kTileRows - 1) / kTileRows;
}

// The caller's epilogue on the product's sums, a warp a (lane, 64-row
// tile), a thread every 32nd row: epi(lane, row, re, im) gets the row's
// slices added in split order and returns the row's value (0 where the
// caller reduces none); epi.lane_tile(lane, tile, max, any NaN) gets their
// max over the tile (a NaN kept).
template <typename T, typename Epi>
__global__ void __launch_bounds__(32 * kEpiWarps) epilogue_kernel(
    const T* __restrict__ part, int splits, int lanes, int n, Epi epi) {
  const int tiles = row_tiles(n);
  const int64_t w =
      (int64_t)blockIdx.x * kEpiWarps + (int)(threadIdx.x >> 5);
  const int ln = threadIdx.x & 31;
  if (w >= (int64_t)lanes * tiles) return;  // whole warps
  const int64_t lane = w / tiles;
  const int tile = (int)(w - lane * tiles);
  const int64_t plane = (int64_t)lanes * n;
  const int r1 = min(n, (tile + 1) * kTileRows);
  T worst = T(0);
  bool nan = false;
  for (int r = tile * kTileRows + ln; r < r1; r += 32) {
    const int64_t k = lane * n + r;
    T sr = __ldg(part + k), si = __ldg(part + plane + k);
    for (int q = 1; q < splits; ++q) {
      sr += __ldg(part + 2 * q * plane + k);
      si += __ldg(part + (2 * q + 1) * plane + k);
    }
    const T v = epi(lane, r, sr, si);
    if (v != v) nan = true;
    else if (v > worst) worst = v;
  }
  for (int off = 16; off > 0; off >>= 1)
    worst = fmax(worst, __shfl_xor_sync(0xffffffffu, worst, off));
  nan = __any_sync(0xffffffffu, nan);
  if (ln == 0) epi.lane_tile(lane, tile, worst, nan);
}

// The tiled product of Y [n, n] (y_re, y_im) and V [lanes, n] (v_re, v_im)
// into `part` [splits, 2, lanes, n] (K slices of whole stages, none
// empty), then the epilogue pass handing it to `epi`.
template <typename T, typename Epi>
int launch_tiled(const T* y_re, const T* y_im, const T* v_re, const T* v_im,
                 T* part, int lanes, int n, int splits, Epi epi,
                 cudaStream_t stream) {
  const int ktiles = (n + kTileK - 1) / kTileK;
  if (lanes <= 0 || n <= 0 || splits < 1 || splits > kMaxSplits ||
      splits > ktiles || part == nullptr)
    return (int)cudaErrorInvalidValue;
  const int kchunk = (ktiles + splits - 1) / splits * kTileK;
  const int lane_tiles = (lanes + kTileLanes - 1) / kTileLanes;
  if ((int64_t)(splits - 1) * kchunk >= n || lane_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  constexpr int kVec = 16 / sizeof(T);
  const bool wide = n % kVec == 0 &&
                    ((uintptr_t)y_re | (uintptr_t)y_im | (uintptr_t)v_re |
                     (uintptr_t)v_im) % 16 == 0;
  void (*kernel)(const T*, const T*, const T*, const T*, T*, int, int, int) =
      wide ? tiled_kernel<T, kVec> : tiled_kernel<T, 1>;
  // Three stages of float64 pass 48 KB, where a kernel has to opt in.
  constexpr int smem = kStages * (int)sizeof(Stage<T>);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(row_tiles(n), lane_tiles, splits);
  kernel<<<grid, kThreads, smem, stream>>>(y_re, y_im, v_re, v_im, part,
                                           lanes, n, kchunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t warps = (int64_t)lanes * row_tiles(n);
  epilogue_kernel<T, Epi>
      <<<(unsigned)((warps + kEpiWarps - 1) / kEpiWarps), 32 * kEpiWarps, 0,
         stream>>>(part, splits, lanes, n, epi);
  return (int)cudaGetLastError();
}

// S = V conj(I) at one (lane, row): the one expression K2 and F1 share.
template <typename T>
__device__ __forceinline__ void power(T vr, T vm, T ire, T iim, T& p, T& q) {
  p = vr * ire + vm * iim;
  q = vm * ire - vr * iim;
}

// Row `row` of Y (y_re/y_im point at it) times one lane's V (vr/vm, [n], in
// device or shared memory), summed by the 32 threads of a warp (ln = the
// thread's index in it); every thread of the warp gets the sum.  A thread
// takes the columns j = ln (mod 32) in increasing order; it issues the Y
// loads of kWarpUnroll such columns before it adds any, so that many loads
// are in flight a thread, and adds them in the same order: the bits do not
// depend on the unrolling.
constexpr int kWarpUnroll = 8;

template <typename T>
__device__ __forceinline__ void warp_product(const T* __restrict__ y_re,
                                             const T* __restrict__ y_im,
                                             const T* __restrict__ vr,
                                             const T* __restrict__ vm, int n,
                                             int ln, T& ire, T& iim) {
  ire = T(0);
  iim = T(0);
  int j = ln;
  for (; j + 32 * (kWarpUnroll - 1) < n; j += 32 * kWarpUnroll) {
    T gs[kWarpUnroll], bs[kWarpUnroll];
#pragma unroll
    for (int u = 0; u < kWarpUnroll; ++u) {
      gs[u] = y_re[j + 32 * u];
      bs[u] = y_im[j + 32 * u];
    }
#pragma unroll
    for (int u = 0; u < kWarpUnroll; ++u) {
      const T gij = gs[u], bij = bs[u], a = vr[j + 32 * u], c = vm[j + 32 * u];
      ire += gij * a - bij * c;
      iim += gij * c + bij * a;
    }
  }
  for (; j < n; j += 32) {
    const T gij = y_re[j], bij = y_im[j], a = vr[j], c = vm[j];
    ire += gij * a - bij * c;
    iim += gij * c + bij * a;
  }
  for (int off = 16; off > 0; off >>= 1) {
    ire += __shfl_xor_sync(0xffffffffu, ire, off);
    iim += __shfl_xor_sync(0xffffffffu, iim, off);
  }
}

}  // namespace row_product
