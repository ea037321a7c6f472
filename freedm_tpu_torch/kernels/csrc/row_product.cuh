// The complex row product I = Y V for Hopper (sm_90a), shared by K2
// (newton.cu), F1 and I1 (solvers.cu).
//
// Two forms, each summing in one fixed order, so every kernel that uses a
// form gets the same bits from the same inputs:
//
//   tiled_product  one Y [n, n] of every lane, tiled like a GEMM: a block of
//                  kThreads owns kRows rows x kLanes lanes and walks the
//                  columns in tiles of kTileJ staged in shared memory, so a
//                  tile of Y serves kLanes lanes.  Each thread owns one
//                  (row, lane) and sums its columns in order.  The caller's
//                  loader gives lane b's V at column j while the tile is
//                  staged (a read for K2 and F1, I1's injection conj(S/V)).
//   warp_product   a warp per (lane, row): the row read coalesced, the lane's
//                  V beside it, reduced by a fixed xor-shuffle tree.  For a
//                  per-lane Y [B, n, n], where no tile of Y serves two lanes,
//                  or a lane count too small to fill a tile.
//
// Each accumulates re += y_re v_re - y_im v_im, im += y_re v_im + y_im v_re.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace row_product {

constexpr int kThreads = 256;
constexpr int kRows = 16;   // tile: rows of Y per block
constexpr int kLanes = 16;  // tile: lanes per block
constexpr int kTileJ = 32;  // tile: columns staged per step
constexpr int kWarpsPerBlock = kThreads / 32;
static_assert(kRows * kLanes == kThreads, "one thread per (row, lane)");
static_assert(kRows == kLanes, "the Y and V tiles share one staging loop");

// The block (blockIdx.x: kRows rows from i0, blockIdx.y: kLanes lanes from
// b0) of I = Y V.  load(b, j, &re, &im) gives lane b's V at column j for
// b < lanes and j < n; the tile holds 0 elsewhere.  Returns the thread's
// (row i0 + tid % kRows, lane b0 + tid / kRows) sum in (ire, iim); every
// thread of the block must call it (it synchronizes the block).
template <typename T, typename Load>
__device__ __forceinline__ void tiled_product(const T* __restrict__ y_re,
                                              const T* __restrict__ y_im,
                                              int lanes, int n, Load load,
                                              T& ire, T& iim) {
  // The +1 pads keep a warp's shared-memory reads on distinct banks.
  __shared__ T gs[kRows][kTileJ + 1];
  __shared__ T bs[kRows][kTileJ + 1];
  __shared__ T vrs[kLanes][kTileJ + 1];
  __shared__ T vms[kLanes][kTileJ + 1];
  const int tid = threadIdx.x;
  const int r = tid % kRows;  // rows fastest: the callers' writes coalesce
  const int l = tid / kRows;
  const int i0 = blockIdx.x * kRows;
  const int b0 = blockIdx.y * kLanes;
  ire = T(0);
  iim = T(0);
  for (int j0 = 0; j0 < n; j0 += kTileJ) {
    // kThreads threads stage kRows x kTileJ of each tile, consecutive
    // threads on consecutive columns.
    for (int e = tid; e < kRows * kTileJ; e += kThreads) {
      const int rr = e / kTileJ, jj = e % kTileJ;
      const int gi = i0 + rr, gj = j0 + jj;
      const bool ok = gi < n && gj < n;
      gs[rr][jj] = ok ? y_re[(int64_t)gi * n + gj] : T(0);
      bs[rr][jj] = ok ? y_im[(int64_t)gi * n + gj] : T(0);
      const int gb = b0 + rr;
      T a = T(0), c = T(0);
      if (gb < lanes && gj < n) load(gb, gj, a, c);
      vrs[rr][jj] = a;
      vms[rr][jj] = c;
    }
    __syncthreads();
#pragma unroll 8
    for (int jj = 0; jj < kTileJ; ++jj) {
      const T gij = gs[r][jj], bij = bs[r][jj];
      const T a = vrs[l][jj], c = vms[l][jj];
      ire += gij * a - bij * c;
      iim += gij * c + bij * a;
    }
    __syncthreads();
  }
}

// Row `row` of Y (y_re/y_im point at it) times one lane's V (vr/vm, [n]),
// summed by the 32 threads of a warp (ln = the thread's index in it); every
// thread of the warp gets the sum.
template <typename T>
__device__ __forceinline__ void warp_product(const T* __restrict__ y_re,
                                             const T* __restrict__ y_im,
                                             const T* __restrict__ vr,
                                             const T* __restrict__ vm, int n,
                                             int ln, T& ire, T& iim) {
  ire = T(0);
  iim = T(0);
  for (int j = ln; j < n; j += 32) {
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
