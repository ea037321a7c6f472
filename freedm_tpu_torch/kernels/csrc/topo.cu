// Topology-sweep kernels for Hopper (sm_90a).
//
// T1 topo_radiality — replaces the XLA program of freedm_tpu/pf/topo.py:182
//   `make_radiality_check` (the lane body, :199-235): per variant lane (a
//   row of up to 6 opened branch slots, -1 pads), whether the CLOSED
//   branches connect every bus (the reference's min-label fixed point:
//   every label 0), and `radial` = connected and m - n_open == n - 1,
//   n_open counting the lane's active slots (slot >= 0; an out-of-range
//   slot opens no branch but still counts, as the reference's :230 does).
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
// T1's design: a cut test on a spanning tree, no label sweeps.  Every lane
//   differs from one base graph by at most 6 opened branches, so the host
//   builds, once per case (topo_kernels.tree_plan), a spanning tree of the
//   base graph in preorder: per branch, the child subtree [tin, tout] of a
//   tree branch, or the two positions of a non-tree branch in `ends`, the
//   non-tree branches listed once from each end in CSR order of that end's
//   preorder index (own | other << 16).  A lane's k distinct opened tree
//   branches cut the tree into k + 1 components: a bus's component is the
//   innermost cut subtree holding its preorder index (the one with the
//   largest tin), else the root's.  Uncut tree branches join nothing new,
//   so the lane is connected iff its closed non-tree branches join the
//   k + 1 components.  Only a branch with an end inside a cut subtree can
//   join two of them, and those ends are the CSR ranges of the outermost
//   cut subtrees: a warp strides over them, ORs each crossing branch's
//   (component, component) pair into a 21-bit mask, OR-reduces it
//   (redux.sync) and closes it from the root over <= 7 nodes, stopping
//   early once every component is reached.  A lane opening no tree branch
//   is connected iff the base graph is.  Every step is integer and
//   order-free, so the verdict is the same bits on every run and at any
//   launch width, and equals the reference's fixed point.  Persistent
//   CTAs (16 warps: topo_kernels.T1_WARPS), a warp a lane, the next
//   lane's slots and cut rows loaded a lane ahead; each CTA stages the
//   start offsets and ends once (one 1-D bulk copy completing an mbarrier,
//   waited for only by a lane that cuts a tree branch), or reads them from
//   global memory where they do not fit beside the barrier.
//
// T2's design: a warp a lane (plan `group` 1) or a group of warps a lane,
//   persistent CTAs (topo_kernels.screen_plan, from the shapes alone).  The
//   CTA stages the branch operands once in shared memory: w, rs, theta0,
//   f | t << 16 in one word and, where they fit, the endpoint masks.  Per
//   lane: the r^2 entries of C and the right-hand side from r^2 + r
//   threads' independent Z^T loads, issued together; every thread then
//   gathers C by shuffle and runs the same partial-pivot LU, det and solve
//   at the template rank R in registers (no broadcast needed); theta_v =
//   theta0 + sum_j y_j Z^T[k_j, :] streamed coalesced with the R loads of
//   4 buses in flight a thread (8 on a WIDE plan, n > 512, up to rank 3),
//   into the group's slice of shared memory; the next lane's slots loaded
//   a lane ahead; the flows from shared-memory gathers, each thread's
//   partials in branch order, a fixed shuffle tree, then the group's warps
//   in order.  At mesh2000 the staged operands (96 KB) leave room for 8
//   lanes' theta_v: the plan runs 16 warps, two a lane, so that twice the
//   warps hide the flows' shared-memory latency, which held 8 warps of a
//   lane each (chip_smoke.py times both plans).  The
//   worst flow is a max of bit patterns, the violations an integer count.
//   No float atomics: every result is the same bits on every run and at
//   any launch width, so a sweep's shortlist is the same under kill/resume
//   and rechunking.
//
// Bounds on an H100 SXM (3.35 TB/s; 34 TFLOP/s fp64).  T2 SCREEN at mesh118
//   x 4096 lanes, r = 2: the lanes' Z^T rows (2 x 118 x 8 bytes a lane,
//   7.7 MB), the slots and four [V] outputs: ~8 MB, 2.4 us.  At mesh2000 x
//   16384 lanes of ranks 1-3 (mean 2): 0.52 GB of Z^T rows, 0.16 ms: the
//   Z^T stream bounds it, the shared-memory gathers of the flows (36 bytes
//   a branch and lane) come next.  T1 reads the slots and their cut rows, writes two
//   flags a lane and scans a few ends a cut subtree: microseconds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;  // shared memory a block may use on Hopper
constexpr int kMaxRank = 6;       // freedm_tpu/pf/topo.py MAX_TOPO_RANK
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The number of SMs times the CTAs of `kernel` one SM holds, at most
// `want`: the grid of a persistent launch.
template <typename K>
int persistent_grid(K kernel, int threads, size_t smem, int want) {
  int dev = 0, sms = 0, per = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads,
                                                    smem) != cudaSuccess)
    return -1;
  const long cap = (long)sms * (per > 0 ? per : 1);
  return (int)(want < cap ? want : cap);
}

template <typename K>
int opt_in(K kernel, size_t smem) {
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024)  // above 48 KB a kernel has to opt in
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return 0;
}

// ---------------------------------------------------------------------------
// T1
// ---------------------------------------------------------------------------

constexpr int kT1MaxWarps = 32;

struct RadArgs {
  const int2* cut;           // [m] tree: child (tin, tout); else (-1-pa, pb)
  const uint32_t* words;     // start [n + 1] at 0, ends at ends_at
  const int* slots;          // [lanes, r] opened branches, -1 pads
  unsigned char* connected;  // [lanes] bool
  unsigned char* radial;     // [lanes] bool
  int n, m, lanes, ends_at, words_n;  // words_n: 16-byte multiple of words
  int base_connected, staged;
};

// Bit of the component pair (lo, hi), lo < hi <= 6: 21 bits in all.
__device__ __forceinline__ int pair_bit(int lo, int hi) {
  return hi * (hi - 1) / 2 + lo;
}

// The components reached from the root's (0) over the pairs' edges.
template <int R>
__device__ __forceinline__ unsigned closure(unsigned pairs) {
  unsigned adj[R + 1];
#pragma unroll
  for (int i = 0; i <= R; ++i) adj[i] = 0;
#pragma unroll
  for (int hi = 1; hi <= R; ++hi)
#pragma unroll
    for (int lo = 0; lo < hi; ++lo)
      if ((pairs >> pair_bit(lo, hi)) & 1u) {
        adj[lo] |= 1u << hi;
        adj[hi] |= 1u << lo;
      }
  unsigned reach = 1u;
#pragma unroll
  for (int round = 0; round < R; ++round)
#pragma unroll
    for (int i = 0; i <= R; ++i)
      if ((reach >> i) & 1u) reach |= adj[i];
  return reach;
}

template <int R>
__global__ void __launch_bounds__(kT1MaxWarps * 32)
    topo_radiality_kernel(const RadArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t s_bar;
  const int ln = threadIdx.x & 31;
  const bool staged = a.staged != 0;
  const uint32_t* words =
      staged ? reinterpret_cast<const uint32_t*>(smem) : a.words;
  bool ready = !staged;
  const int cta_warps = blockDim.x >> 5;
  const int warps = gridDim.x * cta_warps;
  int lane = blockIdx.x * cta_warps + (threadIdx.x >> 5);
  // Thread j < R: slot j of the warp's next lane and its row of the cut
  // table, loaded a lane ahead (the first before the staging).
  int s_next = -1;
  int2 c_next = make_int2(0, 0);
  if (lane < a.lanes && ln < R) {
    s_next = a.slots[(int64_t)lane * R + ln];
    if (s_next >= 0 && s_next < a.m) c_next = a.cut[s_next];
  }
  if (staged) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(&s_bar))
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned bytes = (unsigned)a.words_n * 4u;
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_u32(&s_bar)),
          "r"(bytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(smem)),
          "l"(a.words), "r"(bytes), "r"(smem_u32(&s_bar))
          : "memory");
    }
  }
  for (; lane < a.lanes; lane += warps) {
    const int s = s_next;
    const int2 c = c_next;
    s_next = -1;
    c_next = make_int2(0, 0);
    if (lane + warps < a.lanes && ln < R) {
      s_next = a.slots[(int64_t)(lane + warps) * R + ln];
      if (s_next >= 0 && s_next < a.m) c_next = a.cut[s_next];
    }
    const int n_open = __popc(__ballot_sync(kFull, ln < R && s >= 0));
    bool first = ln < R && s >= 0 && s < a.m;  // a repeat cuts nothing
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int sj = __shfl_sync(kFull, s, j);
      if (j < ln && sj == s) first = false;
    }
    const bool tree = first && c.x >= 0;
    const unsigned tmask = __ballot_sync(kFull, tree);
    bool conn = a.base_connected != 0;
    if (conn && tmask != 0u) {
      // The cut subtrees [lo_j, hi_j] (empty for a slot that cuts none)
      // and the opened non-tree branches' two positions in `ends`.
      int lo[R], hi[R], pa[R], pb[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        lo[j] = __shfl_sync(kFull, tree ? c.x : 0x7fffffff, j);
        hi[j] = __shfl_sync(kFull, tree ? c.y : -1, j);
        const bool nt = first && c.x < 0;
        pa[j] = __shfl_sync(kFull, nt ? -1 - c.x : -1, j);
        pb[j] = __shfl_sync(kFull, nt ? c.y : -1, j);
      }
      const unsigned target = (tmask << 1) | 1u;
      if (!ready) {
        asm volatile(
            "{\n"
            ".reg .pred P1;\n"
            "T1_WAIT:\n"
            "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n"
            "@P1 bra T1_DONE;\n"
            "bra T1_WAIT;\n"
            "T1_DONE:\n"
            "}\n" ::"r"(smem_u32(&s_bar))
            : "memory");
        ready = true;
      }
      const uint32_t* ends = words + a.ends_at;
      unsigned pairs = 0u;
      bool done = false;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        bool outer = ((tmask >> j) & 1u) != 0u;
#pragma unroll
        for (int i = 0; i < R; ++i)
          outer = outer && !(lo[i] < lo[j] && lo[j] <= hi[i]);
        if (!outer || done) continue;  // warp-uniform
        const int p0 = (int)words[lo[j]], p1 = (int)words[hi[j] + 1];
        int stride = 0;
        for (int base = p0; base < p1; base += 32, ++stride) {
          const int p = base + ln;
          if (p < p1) {
            bool closed = true;
#pragma unroll
            for (int i = 0; i < R; ++i) closed = closed && p != pa[i] && p != pb[i];
            if (closed) {
              const uint32_t e = ends[p];
              const int x = (int)(e & 0xffffu), y = (int)(e >> 16);
              int cx = 0, cy = 0, bx = -1, by = -1;
#pragma unroll
              for (int i = 0; i < R; ++i) {
                if (lo[i] <= x && x <= hi[i] && lo[i] > bx) { bx = lo[i]; cx = i + 1; }
                if (lo[i] <= y && y <= hi[i] && lo[i] > by) { by = lo[i]; cy = i + 1; }
              }
              if (cx != cy)
                pairs |= 1u << pair_bit(min(cx, cy), max(cx, cy));
            }
          }
          if ((stride & 7) == 7) {
            pairs = __reduce_or_sync(kFull, pairs);
            if ((closure<R>(pairs) & target) == target) {
              done = true;
              break;
            }
          }
        }
        if (!done) {
          pairs = __reduce_or_sync(kFull, pairs);
          done = (closure<R>(pairs) & target) == target;
        }
      }
      conn = done;
    }
    if (ln == 0) {
      a.connected[lane] = conn ? 1 : 0;
      a.radial[lane] = (conn && a.m - n_open == a.n - 1) ? 1 : 0;
    }
  }
  // No CTA leaves with its bulk copy still in flight.
  if (staged && !ready && (threadIdx.x & 31) == 0) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "T1_DRAIN:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n"
        "@P1 bra T1_DRAINED;\n"
        "bra T1_DRAIN;\n"
        "T1_DRAINED:\n"
        "}\n" ::"r"(smem_u32(&s_bar))
        : "memory");
  }
}

template <int R>
int launch_radiality(const RadArgs& a, int warps, cudaStream_t stream) {
  const size_t smem = a.staged ? (size_t)a.words_n * 4 : 0;
  int rc = opt_in(topo_radiality_kernel<R>, smem);
  if (rc != 0) return rc;
  const int want = (a.lanes + warps - 1) / warps;
  const int grid = persistent_grid(topo_radiality_kernel<R>, warps * 32,
                                   smem, want);
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  topo_radiality_kernel<R><<<grid, warps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
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
  int n, m, lanes, mode;
  int warps, group, masks;  // the plan (staged is the template's)
};

// Sync the `group` warps of lane group `g` (named barrier g + 1; one warp:
// __syncwarp).
__device__ __forceinline__ void group_sync(int g, int group) {
  if (group == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "r"(group * 32)
                 : "memory");
  }
}

// Buses a thread streams with their R loads each in flight: 4, or on a
// WIDE plan (n > 512) 8 up to rank 3.
template <int R, bool WIDE>
__host__ __device__ constexpr int stream_unroll() {
  return WIDE && R <= 3 ? 8 : 4;
}

// Warps a CTA: up to 8, on a WIDE plan up to 16 (at most 128 registers a
// thread).
template <bool WIDE>
__host__ __device__ constexpr int screen_max_warps() {
  return WIDE ? 16 : 8;
}

template <int R, bool STAGED, bool WIDE>
__global__ void __launch_bounds__(screen_max_warps<WIDE>() * 32)
    topo_screen_kernel(const ScreenArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, m = a.m, group = a.group;
  const int groups = a.warps / group;
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int g = warp / group;          // this warp's lane group
  const int q = threadIdx.x - g * group * 32;  // thread within the group
  const int gt = group * 32;
  // The slots of the group's first lane, loaded before the staging.
  int lane = blockIdx.x * groups + g;
  int s_next = -1;
  if (lane < a.lanes && ln < R) s_next = a.slots[(int64_t)lane * R + ln];

  // Shared memory: [w | rs | mask_f | mask_t | theta0 (staged)] float64,
  // the groups' theta_v [groups][n], the warps' triples (group > 1), then
  // f | t << 16 (staged).
  double* sd = reinterpret_cast<double*>(smem);
  const double *w = a.w, *rs = a.rs, *mf = a.mask_f, *mt = a.mask_t,
               *th0 = a.theta0;
  uint32_t* s_ft = nullptr;
  double* s_thv;
  if (STAGED) {
    double* s_w = sd;
    double* s_rs = s_w + m;
    double* s_mf = s_rs + m;
    double* s_mt = s_mf + (a.masks ? m : 0);
    double* s_th0 = s_mt + (a.masks ? m : 0);
    s_thv = s_th0 + n;
    s_ft = reinterpret_cast<uint32_t*>(s_thv + (int64_t)groups * n +
                                       (group > 1 ? 3 * a.warps : 0));
#pragma unroll 4
    for (int e = threadIdx.x; e < m; e += blockDim.x) {
      s_w[e] = a.w[e];
      s_rs[e] = a.rs[e];
      s_ft[e] = (uint32_t)a.f[e] | ((uint32_t)a.t[e] << 16);
      if (a.masks) {
        s_mf[e] = a.mask_f[e];
        s_mt[e] = a.mask_t[e];
      }
    }
#pragma unroll 4
    for (int x = threadIdx.x; x < n; x += blockDim.x) s_th0[x] = a.theta0[x];
    __syncthreads();
    w = s_w;
    rs = s_rs;
    th0 = s_th0;
    if (a.masks) {
      mf = s_mf;
      mt = s_mt;
    }
  } else {
    s_thv = sd;
  }
  double* thv = s_thv + (int64_t)g * n;
  double* s_red = s_thv + (int64_t)groups * n;  // [warps][3] (group > 1)
  const bool detail = a.mode == kDetail;
  const double limit = a.limit;

  const int stride = gridDim.x * groups;
  for (; lane < a.lanes; lane += stride) {
    // Every warp of the group reads the lane's slots, a lane ahead: the
    // gather rows k_j (-1 inactive) and the opened branches (-1 none), in
    // registers.
    const int s = s_next;
    s_next = -1;
    if (lane + stride < a.lanes && ln < R)
      s_next = a.slots[(int64_t)(lane + stride) * R + ln];
    int k[R], op[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int sj = __shfl_sync(kFull, s, j);
      k[j] = sj >= 0 ? (sj < m ? sj : m - 1) : -1;
      op[j] = (sj >= 0 && sj < m) ? sj : -1;
    }

    // C's entries (i, j) and the right-hand side, one a thread, in the
    // reference's expressions (zc = z[:, k] act; a_t_z[i, j] = zc[f_i, j]
    // mf_i - zc[t_i, j] mt_i; C = I - wk[:, None] a_t_z; b = wk (theta0[f]
    // mf - theta0[t] mt)), inactive rows and columns those of I.
    constexpr int kEntries = R * R + R;
    constexpr int kRounds = (kEntries + 31) / 32;
    double ent[kRounds];
#pragma unroll
    for (int rd = 0; rd < kRounds; ++rd) {
      const int e = rd * 32 + ln;
      double v = 0.0;
      if (e < R * R) {
        const int i = e / R, j = e % R;
        int ki = -1, kj = -1;
#pragma unroll
        for (int u = 0; u < R; ++u) {
          if (u == i) ki = k[u];
          if (u == j) kj = k[u];
        }
        double atz = 0.0, wk = 0.0;
        if (ki >= 0 && kj >= 0) {
          uint32_t fi, ti;
          if (STAGED) {
            const uint32_t ft = s_ft[ki];
            fi = ft & 0xffffu;
            ti = ft >> 16;
          } else {
            fi = (uint32_t)a.f[ki];
            ti = (uint32_t)a.t[ki];
          }
          const double* zj = a.zt + (int64_t)kj * n;
          atz = __ldg(zj + fi) * mf[ki] - __ldg(zj + ti) * mt[ki];
          wk = w[ki];
        }
        v = (i == j ? 1.0 : 0.0) - wk * atz;
      } else if (e < kEntries) {
        const int i = e - R * R;
        int ki = -1;
#pragma unroll
        for (int u = 0; u < R; ++u)
          if (u == i) ki = k[u];
        if (ki >= 0) {
          uint32_t fi, ti;
          if (STAGED) {
            const uint32_t ft = s_ft[ki];
            fi = ft & 0xffffu;
            ti = ft >> 16;
          } else {
            fi = (uint32_t)a.f[ki];
            ti = (uint32_t)a.t[ki];
          }
          v = w[ki] * (th0[fi] * mf[ki] - th0[ti] * mt[ki]);
        }
      }
      ent[rd] = v;
    }

    // Every thread: C and b by shuffle, the partial-pivoting LU in
    // registers, det, and the solve (y = b where the lane islands).
    double c[R][R], y[R];
#pragma unroll
    for (int e = 0; e < kEntries; ++e) {
      const double v = __shfl_sync(kFull, ent[e / 32], e % 32);
      if (e < R * R)
        c[e / R][e % R] = v;
      else
        y[e - R * R] = v;
    }
    double det = 1.0;
    int perm[R];
#pragma unroll
    for (int i = 0; i < R; ++i) perm[i] = i;
#pragma unroll
    for (int col = 0; col < R; ++col) {
      int p = col;
      double best = fabs(c[col][col]);
#pragma unroll
      for (int i = col + 1; i < R; ++i) {
        if (fabs(c[i][col]) > best) {
          best = fabs(c[i][col]);
          p = i;
        }
      }
      // Swap rows p and col with static indices (registers, not local
      // memory).
#pragma unroll
      for (int i = col + 1; i < R; ++i) {
        if (i == p) {
          det = -det;
          const int tp = perm[i]; perm[i] = perm[col]; perm[col] = tp;
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const double tc = c[i][j]; c[i][j] = c[col][j]; c[col][j] = tc;
          }
        }
      }
      const double piv = c[col][col];
      det *= piv;
      if (piv != 0.0) {
#pragma unroll
        for (int i = col + 1; i < R; ++i) {
          const double l = c[i][col] / piv;
          c[i][col] = l;
#pragma unroll
          for (int j = col + 1; j < R; ++j) c[i][j] -= l * c[col][j];
        }
      }
    }
    const bool isl = fabs(det) < kIslandEps;
    if (!isl) {
      double pb[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {  // P b with static indices
        double v = 0.0;
#pragma unroll
        for (int u = 0; u < R; ++u)
          if (perm[i] == u) v = y[u];
        pb[i] = v;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {  // L z = P b (unit lower)
        double s2 = pb[i];
#pragma unroll
        for (int j = 0; j < i; ++j) s2 -= c[i][j] * pb[j];
        pb[i] = s2;
      }
#pragma unroll
      for (int i = R - 1; i >= 0; --i) {  // U y = z
        double s2 = pb[i];
#pragma unroll
        for (int j = i + 1; j < R; ++j) s2 -= c[i][j] * pb[j];
        pb[i] = s2 / c[i][i];
      }
#pragma unroll
      for (int i = 0; i < R; ++i) y[i] = pb[i];
    }

    // theta_v = theta0 + Z_S y, the active rows of Z^T only, kU buses'
    // loads in flight a thread.
    double* th_out = detail ? a.theta + (int64_t)lane * n : nullptr;
    constexpr int kU = stream_unroll<R, WIDE>();
    for (int x0 = q; x0 < n; x0 += gt * kU) {
      double z[R][kU];
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int x = x0 + u * gt;
          z[j][u] = (k[j] >= 0 && x < n)
                        ? __ldg(a.zt + (int64_t)k[j] * n + x)
                        : 0.0;
        }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int x = x0 + u * gt;
        if (x < n) {
          double s2 = 0.0;
#pragma unroll
          for (int j = 0; j < R; ++j)
            if (k[j] >= 0) s2 += z[j][u] * y[j];
          const double th = th0[x] + s2;
          thv[x] = th;
          if (detail) th_out[x] = th;
        }
      }
    }
    group_sync(g, group);

    // The flows and each thread's partial objectives, in branch order:
    // the worst |flow| as the largest bit pattern (the order of doubles
    // >= 0; a NaN above every number, as jnp.max keeps it), the
    // violations as an integer count.
    double p0 = 0.0;  // loss
    unsigned long long worst = 0ull;
    int viol = 0;
    double* fl_out = detail ? a.flows + (int64_t)lane * m : nullptr;
#pragma unroll 4
    for (int e = q; e < m; e += gt) {
      bool open = false;
#pragma unroll
      for (int j = 0; j < R; ++j) open = open || op[j] == e;
      uint32_t fe, te;
      if (STAGED) {
        const uint32_t ft = s_ft[e];
        fe = ft & 0xffffu;
        te = ft >> 16;
      } else {
        fe = (uint32_t)a.f[e];
        te = (uint32_t)a.t[e];
      }
      const double fl = open ? 0.0 : (thv[fe] - thv[te]) * w[e];
      if (detail) fl_out[e] = fl;
      p0 += rs[e] * fl * fl;
      const unsigned long long bits =
          (unsigned long long)__double_as_longlong(fabs(fl));
      worst = bits > worst ? bits : worst;
      viol += fabs(fl) > limit ? 1 : 0;
    }
    double p1 = __longlong_as_double((long long)worst), p2 = (double)viol;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      p0 += __shfl_down_sync(kFull, p0, o);
      p1 = nanmax(p1, __shfl_down_sync(kFull, p1, o));
      p2 += __shfl_down_sync(kFull, p2, o);
    }
    if (group > 1) {
      if (ln == 0) {
        s_red[3 * warp] = p0;
        s_red[3 * warp + 1] = p1;
        s_red[3 * warp + 2] = p2;
      }
      group_sync(g, group);
      if (q == 0) {
        for (int u = 1; u < group; ++u) {
          const int wu = g * group + u;
          p0 += s_red[3 * wu];
          p1 = nanmax(p1, s_red[3 * wu + 1]);
          p2 += s_red[3 * wu + 2];
        }
      }
    }
    if (q == 0) {
      a.loss[lane] = p0;
      a.worst[lane] = p1;
      a.viol[lane] = p2;
      a.islanded[lane] = isl ? 1 : 0;
    }
    group_sync(g, group);  // theta_v and the triples are free again
  }
}

template <int R, bool STAGED, bool WIDE>
int launch_screen(const ScreenArgs& a, size_t smem, cudaStream_t stream) {
  auto kernel = topo_screen_kernel<R, STAGED, WIDE>;
  int rc = opt_in(kernel, smem);
  if (rc != 0) return rc;
  if (a.warps > screen_max_warps<WIDE>()) return (int)cudaErrorInvalidValue;
  const int groups = a.warps / a.group;
  const int want = (a.lanes + groups - 1) / groups;
  const int grid = persistent_grid(kernel, a.warps * 32, smem, want);
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  kernel<<<grid, a.warps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool STAGED, bool WIDE>
int screen_rank(int r, const ScreenArgs& a, size_t smem, cudaStream_t s) {
  switch (r) {
    case 1: return launch_screen<1, STAGED, WIDE>(a, smem, s);
    case 2: return launch_screen<2, STAGED, WIDE>(a, smem, s);
    case 3: return launch_screen<3, STAGED, WIDE>(a, smem, s);
    case 4: return launch_screen<4, STAGED, WIDE>(a, smem, s);
    case 5: return launch_screen<5, STAGED, WIDE>(a, smem, s);
    case 6: return launch_screen<6, STAGED, WIDE>(a, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer (indices
// int32, floats float64, flags one byte); `stream` is the caller's CUDA
// stream.  Each returns the cudaError_t of its launch.
//
// T1: `cut` [m, 2] and `words` (start at 0, ends at `ends_at`; `words_n`
// words, a multiple of 4) from topo_kernels.tree_plan; `staged` 1 to copy
// the words into shared memory, 0 to read them from global memory;
// `warps` a CTA (1-32).
extern "C" int topo_radiality(const int* cut, const int* words,
                              const int* slots, unsigned char* connected,
                              unsigned char* radial, int n, int m, int r,
                              int lanes, int ends_at, int words_n,
                              int base_connected, int staged, int warps,
                              void* stream) {
  if (lanes <= 0 || n <= 0 || n >= (1 << 16) || m <= 0 || r < 1 ||
      r > kMaxRank || words_n < 0 || (words_n & 3) != 0 || warps < 1 ||
      warps > kT1MaxWarps ||
      (staged && (words_n == 0 || (size_t)words_n * 4 + 16 > kMaxSmem)))
    return (int)cudaErrorInvalidValue;
  RadArgs a{reinterpret_cast<const int2*>(cut),
            reinterpret_cast<const uint32_t*>(words), slots, connected,
            radial, n, m, lanes, ends_at, words_n, base_connected, staged};
  cudaStream_t s = (cudaStream_t)stream;
  switch (r) {
    case 1: return launch_radiality<1>(a, warps, s);
    case 2: return launch_radiality<2>(a, warps, s);
    case 3: return launch_radiality<3>(a, warps, s);
    case 4: return launch_radiality<4>(a, warps, s);
    case 5: return launch_radiality<5>(a, warps, s);
    case 6: return launch_radiality<6>(a, warps, s);
  }
  return (int)cudaErrorInvalidValue;
}

// T2: the plan's `warps` a CTA (1-8; 16 if `wide`), `group` warps a lane
// (dividing warps), `staged`, `masks` and `wide` flags and `smem` bytes
// (topo_kernels.screen_plan).
extern "C" int topo_screen_f64(
    const double* zt, const double* theta0, const int* f, const int* t,
    const double* w, const double* rs, const double* mask_f,
    const double* mask_t, const int* slots, double limit, double* loss,
    double* worst, double* viol, unsigned char* islanded, double* theta,
    double* flows, int n, int m, int r, int lanes, int mode, int warps,
    int group, int staged, int masks, int wide, int smem, void* stream) {
  if (lanes <= 0 || n <= 0 || m <= 0 || r < 1 || r > kMaxRank ||
      (mode != kScreen && mode != kDetail) ||
      (mode == kDetail && (theta == nullptr || flows == nullptr)) ||
      warps < 1 || warps > 16 || group < 1 || warps % group != 0 ||
      (staged && n >= (1 << 16)) || (masks && !staged) || smem < 0)
    return (int)cudaErrorInvalidValue;
  ScreenArgs a{zt, theta0, f, t, w, rs, mask_f, mask_t, slots, limit, loss,
               worst, viol, islanded, theta, flows, n, m, lanes, mode,
               warps, group, masks};
  cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    return staged ? screen_rank<true, true>(r, a, (size_t)smem, s)
                  : screen_rank<false, true>(r, a, (size_t)smem, s);
  return staged ? screen_rank<true, false>(r, a, (size_t)smem, s)
                : screen_rank<false, false>(r, a, (size_t)smem, s);
}
