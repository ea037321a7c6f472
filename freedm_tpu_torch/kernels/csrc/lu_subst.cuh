// The substitution on one 64 x 64 diagonal block of an LU factor, for
// Hopper (sm_90a): C1 delta_program (cache.cu) and N1 smw_screen
// (screen.cu) solve their diagonal blocks with these, so both keep one
// rounding contract, the one cache_kernels.lu_solve_mirror reproduces on
// the host:
//
//   - every row takes its updates one column at a time in column order
//     (ascending for the unit-lower L, descending for U), each as one fused
//     multiply-add in the factors' type, b_i = fma(-a_ic, x_c, b_i);
//   - x_c = b_c / u_cc correctly rounded (`quot`), from the reciprocal of
//     u_cc rounded to nearest.  No inverse is formed.
//
// One warp solves one lane's block: thread `lane` holds rows lane and
// lane + 32 of the right-hand side.  The block is cut into sub-blocks of S
// columns; every thread solves a sub-block's triangle itself, in
// registers, from one batch of shuffles, then applies its x to its own
// rows beyond the sub-block.  A sub-block's factor values are read before
// its shuffles, and the rows' updates run apart from the selects that keep
// the solved rows, so only multiply-adds wait on one another.  The column
// order of every row is the same for any S.
//
// The tile is column-major, (r, c) at tile[c * 64 + r], zeros in the rows
// and columns past the factor's order.  x points at row 0 of the lane's
// right-hand side, row r at x[r * kStride].  nr is the number of rows of
// the block below the factor's order: the columns from nr on are skipped,
// which leaves every row's bits as they are (their factor values are
// zeros, and the rows past the order stay what they were).

#pragma once

#include <cuda_runtime.h>

namespace {

// a b, b - a x and a x + b, each rounded once (no contraction).
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double fnma(double a, double x, double b) { return __fma_rn(-a, x, b); }
__device__ __forceinline__ float fnma(float a, float x, float b) { return __fmaf_rn(-a, x, b); }
__device__ __forceinline__ double fma_rn(double a, double x, double b) { return __fma_rn(a, x, b); }
__device__ __forceinline__ float fma_rn(float a, float x, float b) { return __fmaf_rn(a, x, b); }

// a / u rounded to nearest, given y = 1 / u rounded to nearest: q = a y,
// then Markstein's correction q + (a - q u) y with the remainder exact in
// an fma.  With y the correctly rounded reciprocal and q within an ulp of
// a / u, the result is the correctly rounded quotient for normal operands;
// a zero a gives q itself, the quotient's signed zero (a non-finite a
// gives NaN where a division gives +-inf: the lane is lost either way).
// The factors' pivots u are normal numbers; the chain of the back
// substitution then waits on three roundings a column instead of a
// division.
template <typename T>
__device__ __forceinline__ T quot(T a, T u, T y) {
  const T q = mul_rn(a, y);
  const T q1 = fma_rn(fnma(q, u, a), y, q);
  return a == T(0) ? q : q1;
}

// Forward with the unit-lower block: x_c = b_c, rows below take x_c.
template <typename T, int S, int kStride>
__device__ __forceinline__ void lu_diag_fwd(const T* tile, T* x, int nr,
                                            int lane) {
  constexpr int kTile = 64;
  T b0 = x[lane * kStride], b1 = x[(lane + 32) * kStride];
  for (int s0 = 0; s0 < nr; s0 += S) {
    T tri[S * (S - 1) / 2], r0[S], r1[S], xs[S];
#pragma unroll
    for (int j = 0, q = 0; j < S; ++j) {
      const T* col = tile + (s0 + j) * kTile;
#pragma unroll
      for (int r = j + 1; r < S; ++r) tri[q++] = col[s0 + r];
      r0[j] = col[lane];
      r1[j] = col[lane + 32];
    }
#pragma unroll
    for (int j = 0; j < S; ++j)
      xs[j] = __shfl_sync(0xffffffffu, s0 < 32 ? b0 : b1, (s0 + j) & 31);
#pragma unroll
    for (int j = 0, q = 0; j < S; ++j)
#pragma unroll
      for (int r = j + 1; r < S; ++r) xs[r] = fnma(tri[q++], xs[j], xs[r]);
    T c0 = b0, c1 = b1;  // the rows past the sub-block
#pragma unroll
    for (int j = 0; j < S; ++j) {
      c0 = fnma(r0[j], xs[j], c0);
      c1 = fnma(r1[j], xs[j], c1);
    }
    if (lane >= s0 + S) b0 = c0;
    if (lane + 32 >= s0 + S) b1 = c1;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (lane == s0 + j) b0 = xs[j];
      if (lane + 32 == s0 + j) b1 = xs[j];
    }
  }
  x[lane * kStride] = b0;
  x[(lane + 32) * kStride] = b1;
}

// Back with the upper block, from its last sub-block with rows below nr
// up: x_c = b_c / u_cc, rd[c] = 1 / u_cc (past nr, u_cc is taken as 1 and
// rd[c] must be 1, which keeps x_c zero).
template <typename T, int S, int kStride>
__device__ __forceinline__ void lu_diag_bwd(const T* tile, T* x, const T* rd,
                                            int nr, int lane) {
  constexpr int kTile = 64;
  T b0 = x[lane * kStride], b1 = x[(lane + 32) * kStride];
  for (int s0 = (nr - 1) / S * S; s0 >= 0; s0 -= S) {
    T tri[S * (S - 1) / 2], piv[S], ys[S], r0[S], r1[S], xs[S];
#pragma unroll
    for (int j = 0, q = 0; j < S; ++j) {
      const T* col = tile + (s0 + j) * kTile;
#pragma unroll
      for (int r = 0; r < j; ++r) tri[q++] = col[s0 + r];
      piv[j] = s0 + j < nr ? col[s0 + j] : T(1);
      ys[j] = rd[s0 + j];
      r0[j] = col[lane];
      r1[j] = col[lane + 32];
    }
#pragma unroll
    for (int j = 0; j < S; ++j)
      xs[j] = __shfl_sync(0xffffffffu, s0 < 32 ? b0 : b1, (s0 + j) & 31);
#pragma unroll
    for (int j = S - 1; j >= 0; --j) {
      xs[j] = quot(xs[j], piv[j], ys[j]);
#pragma unroll
      for (int r = 0; r < j; ++r) xs[r] = fnma(tri[j * (j - 1) / 2 + r], xs[j], xs[r]);
    }
    T c0 = b0, c1 = b1;  // the rows above the sub-block
#pragma unroll
    for (int j = S - 1; j >= 0; --j) {
      c0 = fnma(r0[j], xs[j], c0);
      c1 = fnma(r1[j], xs[j], c1);
    }
    if (lane < s0) b0 = c0;
    if (lane + 32 < s0) b1 = c1;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (lane == s0 + j) b0 = xs[j];
      if (lane + 32 == s0 + j) b1 = xs[j];
    }
  }
  x[lane * kStride] = b0;
  x[(lane + 32) * kStride] = b1;
}

}  // namespace
