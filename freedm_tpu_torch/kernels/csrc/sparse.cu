// Sparse Newton AC power-flow kernels for Hopper (sm_90a).
//
// S1 sparse_assemble — replaces the XLA program of freedm_tpu/pf/sparse.py
//   :307-344 `_assemble` plus `_residual_from` (:372-375): the BCSR value fill
//   of the polar Jacobian over the branch pattern.  Per directed edge, with
//   E = theta_f - theta_t and the branch two-port admittances,
//
//       C_ft = V_f V_t (G_ft cos E + B_ft sin E)   A_ft = V_f V_t (G_ft sin E - B_ft cos E)
//       C_tf = V_f V_t (G_tf cos E - B_tf sin E)   A_tf = -V_f V_t (G_tf sin E + B_tf cos E)
//
//   and C/V, A/V of the far end; then per bus the sums P, Q over the
//   incident edges, the four block diagonals h, n, j, l and the masked
//   mismatch f.  Two kernels: one thread per (lane, edge), then one thread
//   per (lane, bus) that walks the bus's incidence list.
//
// S2 sparse_matvec — replaces `_matvec` (:346-370): y = J u over the same
//   pattern, pinned rows passing u through.  One thread per (lane, bus row)
//   walks the incidence list and produces both halves (rows i and n + i).
//
// S3 gmres_block_orth — replaces the block step of freedm_tpu/pf/krylov.py
//   `_pgmres_block` (:451-471): two-pass block Gram-Schmidt of the [s, N]
//   candidate block against the masked basis rows 0..j0, CholQR2 with the
//   ridge, the all-NaN factor on a failed Cholesky (jnp.linalg.cholesky's
//   rule, which `where(isfinite)` then turns into a zero block), the newv row
//   mask, and the writes into v_basis[j0+1 : j0+1+s] and valid.
//
// S4 gmres_lstsq — replaces the finish of `_pgmres_block` (:479-482):
//   H = (V valid) W^T of shape [mm+1, mm], the SVD minimum-norm least squares
//   min |beta e1 - H y| with jnp.linalg.lstsq's cutoff (keep sigma > 0 and
//   sigma >= eps max(mm+1, mm) sigma_max, eps of the working dtype), then
//   x = Z^T y.  The SVD is a one-sided (Hestenes) Jacobi on the [mm+1, mm]
//   matrix in shared memory, eight warps rotating disjoint column pairs in
//   round-robin order.  H's dot products and the SVD run in float64 for
//   both instantiations (x = Z^T y stays in the working dtype): in the
//   mixed inner solve H's condition can reach 1e5 and more, where float32
//   sums over N = 4000 terms fix the minimizer to only ~1e-2, and the 272
//   numbers cost nothing in float64.
//
// Every sum runs in a fixed order and no kernel uses atomics, so results are
// identical run to run.  The incidence list of a bus holds first the edges
// whose from end it is, then those whose to end it is, each in ascending
// edge order: S1 sums the two sides separately and S2 in one accumulator, in
// the reference's segment_sum order.
//
// Bounds on an H100 SXM (3.35 TB/s; 34 / 67 TFLOP/s fp64 / fp32 outside the
// tensor cores), mesh2000 (n = 2000, m = 4000, N = 2n), 64 lanes, float64:
//   S1 reads x and writes 8 edge values, 6 bus values and f per lane: bytes,
//      about 26.6 MB, 8 us.  Design: the edge pass is fully coalesced; the
//      bus pass gathers from the edge arrays, which stay in L2.
//   S2 reads u and the 8 edge + 4 diagonal arrays, writes y: bytes, about
//      24.6 MB, 7.3 us (half in float32).  Design: the gathers hit L2; no
//      scatter, no atomics.
//   S3 reads the j0+1 basis rows twice and the [s, N] block a few times: bytes
//      (about 70 MB per call at j0 = 12).  Design: one block per lane streams
//      the rows from global memory in 32-column tiles through shared memory
//      (the block does not have to fit: at mesh5000 it is 320 KB), the s x s
//      Gram matrix and its Cholesky factor live in shared memory.  Its dot
//      products (projection coefficients, Gram) accumulate in float64 and
//      are rounded to the working dtype, as a GEMM's output is: summed in
//      float32 one term after another over N = 10,000 they lost the
//      orthogonality CholQR2 needs, and mixed solves at mesh5000 fell back
//      to float64.
//   S4 reads V, W and Z once: bytes, about 100 MB.  Design: as S3 for H and
//      for Z^T y; the Jacobi SVD touches only shared memory.
// S3 and S4 run one block per lane, 64 blocks on 132 SMs at 64 lanes: simple
// and right first, they stay latency-bound well above their bounds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;      // columns staged per step of a row-dot pass
constexpr int kMaxRows = 40;   // rows of one operand of a row-dot pass
constexpr int kMaxPer = 8;     // dot products owned by one thread
constexpr int kMaxS = 8;       // s-step block size
constexpr int kMaxCols = 32;   // Krylov dimension mm of S4
constexpr int kMaxSweeps = 60; // Jacobi sweeps

template <typename T> struct Lim;
template <> struct Lim<double> {
  static constexpr double eps = 2.220446049250313e-16;
  static constexpr double tiny = 2.2250738585072014e-308;
};
template <> struct Lim<float> {
  static constexpr float eps = 1.1920929e-07f;
  static constexpr float tiny = 1.17549435e-38f;
};

__device__ __forceinline__ void sincos_(double x, double* s, double* c) { sincos(x, s, c); }
__device__ __forceinline__ void sincos_(float x, float* s, float* c) { sincosf(x, s, c); }

// jnp.maximum: NaN if either operand is NaN.
template <typename T>
__device__ __forceinline__ T nanmax(T a, T b) {
  if (a != a || b != b) return a + b;
  return a > b ? a : b;
}

template <typename T>
__device__ __forceinline__ T quiet_nan() { return T(NAN); }

// ---------------------------------------------------------------------------
// S1
// ---------------------------------------------------------------------------

// ev[b, k, e]: k = 0 a_ft, 1 a_tf, 2 c_ft, 3 c_tf, 4 cv_ft, 5 cv_tf, 6 av_ft,
// 7 av_tf (the reference's _JacValues order).
template <typename T>
__global__ void edge_kernel(const T* __restrict__ x, const int* __restrict__ fi,
                            const int* __restrict__ ti,
                            const T* __restrict__ yft_re,
                            const T* __restrict__ yft_im,
                            const T* __restrict__ ytf_re,
                            const T* __restrict__ ytf_im, T* __restrict__ ev,
                            int lanes, int n, int m) {
  const int64_t k = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (k >= (int64_t)lanes * m) return;
  const int64_t b = k / m;
  const int e = (int)(k - b * m);
  const T* th = x + b * 2 * n;
  const T* v = th + n;
  const int f = fi[e], t = ti[e];
  const T vf = v[f], vt = v[t];
  T se, ce;
  sincos_(th[f] - th[t], &se, &ce);
  const T vv = vf * vt;
  const T gft = yft_re[e], bft = yft_im[e], gtf = ytf_re[e], btf = ytf_im[e];
  const T c_ft = vv * (gft * ce + bft * se);
  const T a_ft = vv * (gft * se - bft * ce);
  const T c_tf = vv * (gtf * ce - btf * se);
  const T a_tf = -vv * (gtf * se + btf * ce);
  T* out = ev + b * 8 * (int64_t)m + e;
  out[0] = a_ft;
  out[m] = a_tf;
  out[2 * (int64_t)m] = c_ft;
  out[3 * (int64_t)m] = c_tf;
  out[4 * (int64_t)m] = c_ft / vt;
  out[5 * (int64_t)m] = c_tf / vf;
  out[6 * (int64_t)m] = a_ft / vt;
  out[7 * (int64_t)m] = a_tf / vf;
}

// bv[b, k, i]: k = 0 h_d, 1 n_d, 2 j_d, 3 l_d, 4 p_calc, 5 q_calc.
template <typename T>
__global__ void bus_kernel(const T* __restrict__ x, const T* __restrict__ ps,
                           const T* __restrict__ qs,
                           const T* __restrict__ th_free,
                           const T* __restrict__ v_free,
                           const T* __restrict__ v_set,
                           const T* __restrict__ g_d, const T* __restrict__ b_d,
                           const int* __restrict__ inc_ptr,
                           const int* __restrict__ inc_code,
                           const T* __restrict__ ev, T* __restrict__ bv,
                           T* __restrict__ fout, int lanes, int n, int m) {
  const int64_t k = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (k >= (int64_t)lanes * n) return;
  const int64_t b = k / n;
  const int i = (int)(k - b * n);
  const T* evl = ev + b * 8 * (int64_t)m;
  T pf = T(0), pt = T(0), qf = T(0), qt = T(0);
  for (int r = inc_ptr[i]; r < inc_ptr[i + 1]; ++r) {
    const int code = inc_code[r];
    const int e = code >> 1;
    if (code & 1) {  // bus i is the to end: the t->f terms
      pt += evl[3 * (int64_t)m + e];
      qt += evl[(int64_t)m + e];
    } else {
      pf += evl[2 * (int64_t)m + e];
      qf += evl[e];
    }
  }
  const int64_t xi = b * 2 * n + i;
  const T th = x[xi], vi = x[xi + n];
  const T v2 = vi * vi;
  const T gd = g_d[i], bd = b_d[i];
  const T p = (pf + pt) + v2 * gd;
  const T q = (qf + qt) - v2 * bd;
  T* bl = bv + b * 6 * (int64_t)n + i;
  bl[0] = -v2 * bd - q;
  bl[n] = vi * gd + p / vi;
  bl[2 * (int64_t)n] = -v2 * gd + p;
  bl[3 * (int64_t)n] = -vi * bd + q / vi;
  bl[4 * (int64_t)n] = p;
  bl[5 * (int64_t)n] = q;
  fout[xi] = th_free[i] > T(0) ? p - ps[b * n + i] : th;
  fout[xi + n] = v_free[i] > T(0) ? q - qs[b * n + i] : vi - v_set[i];
}

// ---------------------------------------------------------------------------
// S2
// ---------------------------------------------------------------------------

template <typename T>
__global__ void matvec_kernel(const T* __restrict__ ev, const T* __restrict__ bv,
                              const T* __restrict__ u,
                              const T* __restrict__ th_free,
                              const T* __restrict__ v_free,
                              const int* __restrict__ inc_ptr,
                              const int* __restrict__ inc_code,
                              const int* __restrict__ inc_nbr,
                              T* __restrict__ y, int lanes, int n, int m) {
  const int64_t k = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (k >= (int64_t)lanes * n) return;
  const int64_t b = k / n;
  const int i = (int)(k - b * n);
  const T* evl = ev + b * 8 * (int64_t)m;
  const T* bl = bv + b * 6 * (int64_t)n;
  const T* uth = u + b * 2 * n;
  const T* uv = uth + n;
  T yp = T(0), yq = T(0);
  for (int r = inc_ptr[i]; r < inc_ptr[i + 1]; ++r) {
    const int code = inc_code[r];
    const int e = code >> 1;
    const int j = inc_nbr[r];
    const T ua = uth[j], ub = uv[j];
    if (code & 1) {  // row t, columns f
      yp += evl[(int64_t)m + e] * ua + evl[5 * (int64_t)m + e] * ub;
      yq += -evl[3 * (int64_t)m + e] * ua + evl[7 * (int64_t)m + e] * ub;
    } else {  // row f, columns t
      yp += evl[e] * ua + evl[4 * (int64_t)m + e] * ub;
      yq += -evl[2 * (int64_t)m + e] * ua + evl[6 * (int64_t)m + e] * ub;
    }
  }
  const T ui = uth[i], wi = uv[i];
  yp = yp + bl[i] * ui + bl[n + i] * wi;
  yq = yq + bl[2 * (int64_t)n + i] * ui + bl[3 * (int64_t)n + i] * wi;
  y[b * 2 * n + i] = th_free[i] > T(0) ? yp : ui;
  y[b * 2 * n + n + i] = v_free[i] > T(0) ? yq : wi;
}

// ---------------------------------------------------------------------------
// Row dot products for S3 and S4:
//   out[i * nb + r] = sum_k (A[i, k] ascale[i]) (B[r, k] bscale[r]),
// k ascending, accumulated in Acc, rows of length N in global memory,
// staged through shared memory kTile columns at a time.  Thread t owns the
// products t, t + 256, ...
// ---------------------------------------------------------------------------

template <typename T, typename Acc>
__device__ void dot_rows(const T* A, int na, const T* ascale, const T* B,
                         int nb, const T* bscale, int N,
                         T (*sa)[kTile + 1], T (*sb)[kTile + 1], Acc* out) {
  const int tid = threadIdx.x;
  const int ne = na * nb;
  Acc acc[kMaxPer];
#pragma unroll
  for (int p = 0; p < kMaxPer; ++p) acc[p] = Acc(0);
  for (int k0 = 0; k0 < N; k0 += kTile) {
    for (int e = tid; e < na * kTile; e += blockDim.x) {
      const int i = e / kTile, kk = e % kTile, k = k0 + kk;
      T a = k < N ? A[(int64_t)i * N + k] : T(0);
      if (ascale != nullptr) a = a * ascale[i];
      sa[i][kk] = a;
    }
    for (int e = tid; e < nb * kTile; e += blockDim.x) {
      const int r = e / kTile, kk = e % kTile, k = k0 + kk;
      T bval = k < N ? B[(int64_t)r * N + k] : T(0);
      if (bscale != nullptr) bval = bval * bscale[r];
      sb[r][kk] = bval;
    }
    __syncthreads();
    const int kn = min(kTile, N - k0);
#pragma unroll
    for (int p = 0; p < kMaxPer; ++p) {
      const int e = tid + p * blockDim.x;
      if (e < ne) {
        const int i = e / nb, r = e % nb;
        Acc s = acc[p];
        for (int kk = 0; kk < kn; ++kk) s += (Acc)sa[i][kk] * (Acc)sb[r][kk];
        acc[p] = s;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < kMaxPer; ++p) {
    const int e = tid + p * blockDim.x;
    if (e < ne) out[e] = acc[p];
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// S3
// ---------------------------------------------------------------------------

// Lower Cholesky of the s x s matrix g + ridge I into L (one thread).  On a
// pivot that is not > 0, or any non-finite entry, L's lower triangle is NaN.
template <typename T>
__device__ void cholesky_or_nan(const T* g, T ridge, int s, T (*L)[kMaxS]) {
  bool ok = true;
  for (int i = 0; i < s; ++i)
    for (int j = 0; j < s; ++j) {
      const T a = g[i * s + j] + (i == j ? ridge : T(0));
      if (!isfinite(a)) ok = false;
      L[i][j] = T(0);
    }
  for (int j = 0; j < s && ok; ++j) {
    T d = g[j * s + j] + ridge;
    for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k];
    if (!(d > T(0))) {
      ok = false;
      break;
    }
    const T ljj = sqrt(d);
    L[j][j] = ljj;
    for (int i = j + 1; i < s; ++i) {
      T a = g[i * s + j];
      for (int k = 0; k < j; ++k) a -= L[i][k] * L[j][k];
      L[i][j] = a / ljj;
    }
  }
  if (!ok)  // jnp.linalg.cholesky's failure: an all-NaN lower triangle
    for (int i = 0; i < s; ++i)
      for (int j = 0; j < s; ++j) L[i][j] = j <= i ? quiet_nan<T>() : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) block_orth_kernel(
    T* __restrict__ vbasis,     // [B, nrows, N]
    T* __restrict__ valid,      // [B, nrows]
    const T* __restrict__ wblk, // [B, s, N]
    int nrows, int s, int N, int j0) {
  __shared__ T sa[kMaxRows][kTile + 1];
  __shared__ T sb[kMaxRows][kTile + 1];
  __shared__ double acc[kMaxS * kMaxRows];
  __shared__ T coef[kMaxS * kMaxRows];
  __shared__ T L[kMaxS][kMaxS];
  __shared__ T newv[kMaxS];
  const T brk = T(1e-30);
  const int tid = threadIdx.x;
  const int64_t lane = blockIdx.x;
  T* V = vbasis + lane * nrows * (int64_t)N;
  T* val = valid + lane * nrows;
  const T* W = wblk + lane * s * (int64_t)N;
  T* Q = V + (int64_t)(j0 + 1) * N;
  const int nb = j0 + 1;

  // Two passes of q <- q - (q vb^T) vb, vb = the basis rows 0..j0 times valid.
  for (int pass = 0; pass < 2; ++pass) {
    const T* src = pass == 0 ? W : Q;
    dot_rows(src, s, (const T*)nullptr, V, nb, val, N, sa, sb, acc);
    for (int e = tid; e < s * nb; e += blockDim.x) coef[e] = (T)acc[e];
    __syncthreads();
    for (int k = tid; k < N; k += blockDim.x) {
      T t[kMaxS];
#pragma unroll
      for (int i = 0; i < kMaxS; ++i) t[i] = T(0);
      for (int r = 0; r < nb; ++r) {
        const T vr = V[(int64_t)r * N + k] * val[r];
#pragma unroll
        for (int i = 0; i < kMaxS; ++i)
          if (i < s) t[i] += coef[i * nb + r] * vr;
      }
      for (int i = 0; i < s; ++i)
        Q[(int64_t)i * N + k] = src[(int64_t)i * N + k] - t[i];
    }
    __syncthreads();
  }

  // CholQR2: Gram, ridge-guarded Cholesky, triangular solve, twice.
  if (tid < s) newv[tid] = T(1);
  __syncthreads();
  for (int pass = 0; pass < 2; ++pass) {
    dot_rows((const T*)Q, s, (const T*)nullptr, (const T*)Q, s,
             (const T*)nullptr, N, sa, sb, acc);
    if (tid == 0) {
      for (int e = 0; e < s * s; ++e) coef[e] = (T)acc[e];
      T dmax = coef[0];
      for (int i = 0; i < s; ++i) {
        const T d = coef[i * s + i];
        newv[i] = newv[i] * (d > brk ? T(1) : T(0));
        if (i > 0) dmax = nanmax(dmax, d);
      }
      const T ridge = nanmax(dmax, Lim<T>::tiny) * Lim<T>::eps * T(s) +
                      Lim<T>::tiny;
      cholesky_or_nan(coef, ridge, s, L);
    }
    __syncthreads();
    for (int k = tid; k < N; k += blockDim.x) {
      T yv[kMaxS];
      for (int i = 0; i < s; ++i) {
        T a = Q[(int64_t)i * N + k];
        for (int j = 0; j < i; ++j) a -= L[i][j] * yv[j];
        yv[i] = a / L[i][i];
      }
      for (int i = 0; i < s; ++i) {
        T out = yv[i];
        if (pass == 1) out = (isfinite(out) ? out : T(0)) * newv[i];
        Q[(int64_t)i * N + k] = out;
      }
    }
    __syncthreads();
  }
  if (tid < s) val[j0 + 1 + tid] = newv[tid];
}

// ---------------------------------------------------------------------------
// S4
// ---------------------------------------------------------------------------

// Round-robin (circle) schedule: position k of round `round` holds player
// p(k); the pairs (p(k), p(nc - 1 - k)) are disjoint and every pair of
// players meets once in nc - 1 rounds.
__device__ __forceinline__ int player(int k, int round, int nc) {
  return k == 0 ? 0 : 1 + (k - 1 + round) % (nc - 1);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  // Fixed tree to lane 0, then broadcast: every lane gets identical bits.
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) lstsq_kernel(
    const T* __restrict__ vbasis,  // [B, mm+1, N]
    const T* __restrict__ valid,   // [B, mm+1]
    const T* __restrict__ wstore,  // [B, mm, N]
    const T* __restrict__ zstore,  // [B, mm, N]
    const T* __restrict__ beta,    // [B]
    T* __restrict__ xout,          // [B, N]
    int mm, int N) {
  __shared__ T sa[kMaxRows][kTile + 1];
  __shared__ T sb[kMaxRows][kTile + 1];
  using R = double;  // the SVD's arithmetic, whatever T is
  __shared__ R H[(kMaxCols + 1) * kMaxCols];
  __shared__ R Aj[kMaxCols + 1][kMaxCols + 1];
  __shared__ R Vj[kMaxCols][kMaxCols + 1];
  __shared__ R sv[kMaxCols];
  __shared__ R coef[kMaxCols];
  __shared__ T ys[kMaxCols];
  __shared__ int changed, bad;
  const int tid = threadIdx.x;
  const int64_t lane = blockIdx.x;
  const int mr = mm + 1;
  const T* V = vbasis + lane * mr * (int64_t)N;
  const T* val = valid + lane * mr;
  const T* W = wstore + lane * mm * (int64_t)N;
  const T* Z = zstore + lane * mm * (int64_t)N;
  T* x = xout + lane * (int64_t)N;
  const T bet_t = beta[lane];
  const R bet = (R)bet_t;

  dot_rows(V, mr, val, W, mm, (const T*)nullptr, N, sa, sb, H);  // H[i*mm + c]

  const int nc = mm + (mm & 1);  // a zero column pads an odd count
  if (tid == 0) bad = isfinite(bet_t) ? 0 : 1;
  __syncthreads();
  for (int e = tid; e < mr * nc; e += blockDim.x) {
    const int i = e / nc, c = e % nc;
    const R h = c < mm ? H[i * mm + c] : R(0);
    if (!isfinite(h)) bad = 1;
    Aj[i][c] = h;
  }
  for (int e = tid; e < nc * nc; e += blockDim.x)
    Vj[e / nc][e % nc] = (e / nc == e % nc) ? R(1) : R(0);
  __syncthreads();
  if (bad) {  // jnp.linalg.lstsq of a non-finite H: a NaN solution
    for (int k = tid; k < N; k += blockDim.x) x[k] = quiet_nan<T>();
    return;
  }

  const int warp = tid / 32, ln = tid % 32, nwarps = blockDim.x / 32;
  const R eps = Lim<R>::eps;
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    if (tid == 0) changed = 0;
    __syncthreads();
    for (int round = 0; round < nc - 1; ++round) {
      for (int pr = warp; pr < nc / 2; pr += nwarps) {
        const int p = player(pr, round, nc), q = player(nc - 1 - pr, round, nc);
        R al = R(0), be = R(0), ga = R(0);
        for (int i = ln; i < mr; i += 32) {
          const R ap = Aj[i][p], aq = Aj[i][q];
          al += ap * ap;
          be += aq * aq;
          ga += ap * aq;
        }
        al = warp_sum(al);
        be = warp_sum(be);
        ga = warp_sum(ga);
        if (ga != R(0) && fabs(ga) > eps * sqrt(al) * sqrt(be)) {
          const R zeta = (be - al) / (R(2) * ga);
          const R t = (zeta >= R(0) ? R(1) : R(-1)) /
                      (fabs(zeta) + sqrt(R(1) + zeta * zeta));
          const R c = R(1) / sqrt(R(1) + t * t);
          const R sn = c * t;
          for (int i = ln; i < mr; i += 32) {
            const R ap = Aj[i][p], aq = Aj[i][q];
            Aj[i][p] = c * ap - sn * aq;
            Aj[i][q] = sn * ap + c * aq;
          }
          for (int r = ln; r < nc && r < mm; r += 32) {
            const R vp = Vj[r][p], vq = Vj[r][q];
            Vj[r][p] = c * vp - sn * vq;
            Vj[r][q] = sn * vp + c * vq;
          }
          if (ln == 0) changed = 1;
        }
        __syncwarp();
      }
      __syncthreads();
    }
    const int again = changed;
    __syncthreads();
    if (!again) break;
  }

  // Singular values are the column norms; the solution keeps those above
  // jnp.linalg.lstsq's cutoff: y = sum_c V[:, c] (beta u[0, c]) / sigma_c.
  for (int c = tid; c < mm; c += blockDim.x) {
    R s2 = R(0);
    for (int i = 0; i < mr; ++i) s2 += Aj[i][c] * Aj[i][c];
    sv[c] = sqrt(s2);
  }
  __syncthreads();
  if (tid == 0) {
    R smax = sv[0];
    for (int c = 1; c < mm; ++c) smax = sv[c] > smax ? sv[c] : smax;
    const R cut = R(Lim<T>::eps) * R(mr) * smax;  // the working dtype's eps
    for (int c = 0; c < mm; ++c) {
      const R sc = sv[c];
      coef[c] = (sc > R(0) && sc >= cut) ? (R(1) / sc) * ((Aj[0][c] / sc) * bet)
                                         : R(0);
    }
  }
  __syncthreads();
  for (int r = tid; r < mm; r += blockDim.x) {
    R a = R(0);
    for (int c = 0; c < mm; ++c) a += Vj[r][c] * coef[c];
    ys[r] = (T)a;
  }
  __syncthreads();
  for (int k = tid; k < N; k += blockDim.x) {
    T a = T(0);
    for (int c = 0; c < mm; ++c) a += Z[(int64_t)c * N + k] * ys[c];
    x[k] = a;
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

inline unsigned blocks_for(int64_t total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

template <typename T>
int launch_assemble(const T* x, const T* ps, const T* qs, const T* th_free,
                    const T* v_free, const T* v_set, const T* yft_re,
                    const T* yft_im, const T* ytf_re, const T* ytf_im,
                    const T* g_d, const T* b_d, const int* fi, const int* ti,
                    const int* inc_ptr, const int* inc_code, T* ev, T* bv,
                    T* f, int lanes, int n, int m, cudaStream_t stream) {
  if (lanes <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  edge_kernel<T><<<blocks_for((int64_t)lanes * m), kThreads, 0, stream>>>(
      x, fi, ti, yft_re, yft_im, ytf_re, ytf_im, ev, lanes, n, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bus_kernel<T><<<blocks_for((int64_t)lanes * n), kThreads, 0, stream>>>(
      x, ps, qs, th_free, v_free, v_set, g_d, b_d, inc_ptr, inc_code, ev, bv, f,
      lanes, n, m);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_matvec(const T* ev, const T* bv, const T* u, const T* th_free,
                  const T* v_free, const int* inc_ptr, const int* inc_code,
                  const int* inc_nbr, T* y, int lanes, int n, int m,
                  cudaStream_t stream) {
  if (lanes <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  matvec_kernel<T><<<blocks_for((int64_t)lanes * n), kThreads, 0, stream>>>(
      ev, bv, u, th_free, v_free, inc_ptr, inc_code, inc_nbr, y, lanes, n, m);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_block_orth(T* vbasis, T* valid, const T* wblk, int lanes,
                      int nrows, int s, int N, int j0, cudaStream_t stream) {
  if (lanes <= 0 || N <= 0 || s < 1 || s > kMaxS || j0 < 0 ||
      j0 + 1 > kMaxRows || j0 + 1 + s > nrows)
    return (int)cudaErrorInvalidValue;
  block_orth_kernel<T><<<lanes, kThreads, 0, stream>>>(vbasis, valid, wblk,
                                                        nrows, s, N, j0);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_lstsq(const T* vbasis, const T* valid, const T* wstore,
                 const T* zstore, const T* beta, T* x, int lanes, int mm,
                 int N, cudaStream_t stream) {
  if (lanes <= 0 || N <= 0 || mm < 1 || mm > kMaxCols ||
      mm + 1 > kMaxRows)
    return (int)cudaErrorInvalidValue;
  lstsq_kernel<T><<<lanes, kThreads, 0, stream>>>(vbasis, valid, wstore,
                                                   zstore, beta, x, mm, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer to a
// contiguous tensor; index arrays are int32; `stream` is the caller's CUDA
// stream.  Each returns the cudaError_t of its launches.
#define SPARSE_ENTRY_POINTS(T, SUFFIX)                                         \
  extern "C" int sparse_assemble_##SUFFIX(                                    \
      const T* x, const T* ps, const T* qs, const T* th_free,                \
      const T* v_free, const T* v_set, const T* yft_re, const T* yft_im,     \
      const T* ytf_re, const T* ytf_im, const T* g_d, const T* b_d,          \
      const int* fi, const int* ti, const int* inc_ptr, const int* inc_code, \
      T* ev, T* bv, T* f, int lanes, int n, int m, void* stream) {           \
    return launch_assemble<T>(x, ps, qs, th_free, v_free, v_set, yft_re,     \
                              yft_im, ytf_re, ytf_im, g_d, b_d, fi, ti,      \
                              inc_ptr, inc_code, ev, bv, f, lanes, n, m,     \
                              (cudaStream_t)stream);                         \
  }                                                                          \
  extern "C" int sparse_matvec_##SUFFIX(                                      \
      const T* ev, const T* bv, const T* u, const T* th_free,                \
      const T* v_free, const int* inc_ptr, const int* inc_code,              \
      const int* inc_nbr, T* y, int lanes, int n, int m, void* stream) {     \
    return launch_matvec<T>(ev, bv, u, th_free, v_free, inc_ptr, inc_code,   \
                            inc_nbr, y, lanes, n, m, (cudaStream_t)stream);  \
  }                                                                          \
  extern "C" int gmres_block_orth_##SUFFIX(T* vbasis, T* valid,               \
                                           const T* wblk, int lanes,         \
                                           int nrows, int s, int N, int j0,  \
                                           void* stream) {                   \
    return launch_block_orth<T>(vbasis, valid, wblk, lanes, nrows, s, N, j0, \
                                (cudaStream_t)stream);                       \
  }                                                                          \
  extern "C" int gmres_lstsq_##SUFFIX(const T* vbasis, const T* valid,        \
                                      const T* wstore, const T* zstore,      \
                                      const T* beta, T* x, int lanes,        \
                                      int mm, int N, void* stream) {         \
    return launch_lstsq<T>(vbasis, valid, wstore, zstore, beta, x, lanes,    \
                           mm, N, (cudaStream_t)stream);                     \
  }

SPARSE_ENTRY_POINTS(double, f64)
SPARSE_ENTRY_POINTS(float, f32)
