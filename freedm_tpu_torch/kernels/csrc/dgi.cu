// On-device DGI kernels for Hopper (sm_90a).
//
// G1 form_groups — replaces the XLA program of freedm_tpu/modules/gm.py:78
//   `form_groups` (:112-145): per lane (an alive mask over N nodes), the
//   connected components of the alive-masked reachability graph and their
//   coordinators.  An edge i-j exists when both nodes are alive and
//   reach[i][j] > 0.  The reference runs ceil(log2 N) + 1 rounds of "label =
//   max over my row of the labels; A = min(A @ A, 1)" from label = rank
//   (the rank-compressed priority, 1..N; 0 dead): each live node ends with
//   the largest rank in its closed row.  Outputs as :127-145: coordinator =
//   the node of that rank (-1 dead), group_mask[i][j] = both live and equal
//   labels, is_coordinator, group_size, n_groups.
//
// R1 reach_closure — replaces freedm_tpu/grid/topology.py:131
//   `make_reachability`: per FID scenario, the ungated adjacency with the
//   closed FID edges set both ways, plus I, closed by ceil(log2 V) float32
//   squarings; written [S, V, V] float32 0/1.
//
// B1 lb_rounds — replaces freedm_tpu/modules/lb.py:114 `lb_round`, iterated
//   by :256 `run_rounds` (`lb/auction_round`): per round, classification by
//   the +-step band, the stable lexicographic sort by (group id, class,
//   -|imbalance| as float32, index), the rank inside each (group, class)
//   segment, per-group supply and demand counts, rank-vs-count matching,
//   the +-step gateway update with the malicious drop.
//
// Design.  All three are exact functions (integers, 0/1 matrices, sums of
//   +-step): each kernel matches its plain version bit for bit and gives the
//   same bits on every run.  No float atomics.
//
//   G1 and R1 share the closure.  The adjacency is packed one bit an entry,
//   a row of w = ceil(N/32) words (128 KB at N = 1024), and the closure is
//   never formed as a matrix.  A symmetric adjacency — R1's always (the
//   wrapper refuses another topology; the FID gates are set both ways),
//   G1's under the reference's contract, checked in one pass — has the
//   closure "in one component": `components` (Shiloach-Vishkin hooking and
//   shortcutting, integer atomicMin) gives each node its component's least
//   index in O(log N) rounds of one pass over the packed rows each (a full
//   word through the word's least pointer), so a deep radial topology costs
//   no more rounds than a mesh.  G1's label is then the component's largest
//   live rank (integer atomicMax); R1 writes "same component".  A
//   non-symmetric G1 input falls back to `close_labels`, the reference's
//   directed closure: labels driven to the fixed point "label_i >= label_j
//   for every edge i->j" by sweeps (max over the row's set bits, then a
//   jump through the node of one's label), as many as the graph's depth.
//   Every pointer and label only moves one way and always names a node of
//   the closed row, so the result is the fixed point whatever order the
//   racing in-place updates take: the same bits on every run.  The squaring
//   the reference does costs N^3 multiply-adds a round.
//
//   G1 is one persistent cooperative launch (dgi_kernels.g1_global_plan:
//   every CTA resident, 1024 threads) in four phases between integer grid
//   barriers (grid_sync.cuh).  Pack: the lanes' rows dealt in contiguous
//   runs to the CTAs, a warp a row, 16-byte loads of reach (a nibble a
//   lane, the words ORed by shuffles), the bits to a device scratch.
//   Symmetry: the lanes' 32 x 32 bit blocks on and above the diagonal,
//   each against its mirror, dealt to the grid's warps (a flag a lane,
//   zeroed by the kernel; one CTA checking a lane's 1024 blocks alone took
//   ~20 us); meanwhile each CTA copies its first lane's packed rows into
//   shared memory where they fit (N <= 1312: 132 KB at N = 1024, rows 33
//   words apart; above, the closure reads them from L2).  Label: one CTA a
//   lane closes and writes labels, coordinator, is_coordinator, group_size
//   and n_groups.  Mask: the CTAs write their rows of group_mask from the
//   labels (staged a lane at a time in shared memory), 16-byte stores.  A
//   lane's pack and mask move its N^2 floats in and out, so they take the whole grid even for one lane.  R1 is one
//   CTA a scenario: it copies the packed ungated rows (shared memory, or a
//   device-memory scratch above V = 1344), sets the closed FID edges with
//   atomicOr, closes and writes its [V, V] rows.
//
//   B1 is one CTA a fleet, R rounds in one launch.  Below 2^15 nodes a
//   node's sort key is one 64-bit word: group id (15 bits) | class (2) |
//   ~bits(float32 |imbalance|) (32; non-negative floats order as their bits)
//   | index (15).  The key is a total order equal to the reference's stable
//   sort, so an unstable bitonic sort gives its permutation.  From 2^15
//   nodes — where the reference takes its unpacked branch (lb.py:178-189) —
//   form WIDE sorts a key pair instead, (group id (30 bits) | class (2) |
//   ~bits(|imbalance|) (32), index (32)), compared lexicographically in the
//   same bitonic network: the same total order up to N = 2^30.  Segment
//   starts come from a block max-scan, segment lengths are written at
//   segment ends, and a node reads its group's supply and demand counts
//   from its own segment and the neighbouring one (the counts the reference's
//   two segment sums give).  The working set stays in shared memory across
//   rounds (form SHARED; N <= 8192 in float64) or in a device-memory scratch
//   (form GLOBAL up to N = 2^15 - 1; form WIDE, 20 bytes a padded node and
//   the gateway: 1.8 MB a fleet at N = 2^16 in float64, L2-resident, its
//   sort 136 passes over the scratch at 2^16 in one CTA: 2.6 ms a round on
//   an H100).  Form CLUSTER (the WIDE key pairs up to 2^17 nodes,
//   dgi_kernels.lb_cluster_plan) spreads a fleet over a thread-block
//   cluster of 16 CTAs: each holds 1/16 of the padded positions' key
//   pairs, segment starts and lengths, and of the nodes' gateway, in
//   shared memory (28 bytes a padded node in float64: 224 KB a CTA at
//   2^17); bitonic steps whose partner lies in the CTA run in shared
//   memory under __syncthreads, the few across CTAs (10 of 136 at 2^16)
//   read the partner's pairs through distributed shared memory between
//   two cluster barriers; the segment starts' max-scan takes the earlier
//   CTAs' carries, lengths and gateway updates land in whichever CTA holds
//   them (DSMEM), the migrations are summed by rank 0 in rank order.
//   Above 2^17 nodes, form WIDE.  Float arithmetic is written
//   with __f*_rn / __d*_rn intrinsics (no contraction), each operation
//   rounding as the plain version's does.
//
// Bounds on an H100 SXM (3.35 TB/s).  G1 at N = 1024 x 1 lane reads reach
//   (4 MB) and writes group_mask (4 MB): 2.5 us; at B = 64 x N = 256 the
//   same 32 MB.  R1 at V = 1024 x S = 64 writes 256 MB: 80 us.  B1 reads
//   and writes a few vectors a fleet (bytes: microseconds); its work is the
//   sort, N log^2 N compare-exchanges a round, latency-bound in one CTA.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_sync.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSmem = 232448;  // shared memory a block may use on Hopper
constexpr unsigned kFull = 0xffffffffu;
// G1's CTA (dgi_kernels.G1_THREADS reads it: keep it a
// `constexpr int name = value;`).
constexpr int kG1Threads = 1024;

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Block-wide integer sum (every thread gets it); `red` is >= 32 shared ints.
__device__ int block_sum(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // red may still be read by a previous caller
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int t = 0;
  for (int k = 0; k < (int)(blockDim.x >> 5); ++k) t += red[k];
  return t;
}

// ---------------------------------------------------------------------------
// G1 / R1: labels of a packed adjacency's closure
// ---------------------------------------------------------------------------

// Drives lab[0..n) to the largest label reachable from each node along the
// (directed) set bits.  `bits`: n rows of w words, ws words apart (shared
// or device memory); lab (shared): > 0 live, 0 dead (a dead node has no
// set bit in any row); inv[l] the node whose own label is l; wmax: w
// shared ints.  Returns the sweeps run.
__device__ int close_labels(const uint32_t* bits, int n, int w, int ws, int* lab,
                            const int* inv, int* wmax) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  volatile int* vlab = lab;
  int sweeps = 0;
  for (;;) {
    for (int k = warp; k < w; k += nwarps) {  // a warp a word
      const int j = 32 * k + lane;
      const int m = warp_max(j < n ? vlab[j] : 0);
      if (lane == 0) wmax[k] = m;
    }
    __syncthreads();
    int changed = 0;
    for (int i = warp; i < n; i += nwarps) {
      const uint32_t* row = bits + (size_t)i * ws;
      int m = 0;
      for (int k = lane; k < w; k += 32) {
        uint32_t x = row[k];
        if (x == kFull) {
          m = max(m, wmax[k]);
        } else {
          while (x) {
            const int b = __ffs(x) - 1;
            x &= x - 1;
            m = max(m, vlab[32 * k + b]);
          }
        }
      }
      m = warp_max(m);
      if (lane == 0 && m > vlab[i]) {
        vlab[i] = m;
        changed = 1;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int l = vlab[i];
      if (l > 0) {
        const int l2 = vlab[inv[l]];
        if (l2 > l) {
          vlab[i] = l2;
          changed = 1;
        }
      }
    }
    ++sweeps;
    if (!__syncthreads_or(changed)) break;
  }
  return sweeps;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Nonzero when a 32 x 32 bit block of the packed adjacency breaks symmetry.
// The calling warp takes blocks first, first + step, ... < w*w: block (I, J)
// is rows 32I.. word J; it is transposed with 32 ballots, and lane t's
// transposed row is compared with row 32J + t, word I (the mirror block).
__device__ int asym_blocks(const uint32_t* bits, int n, int w, int first,
                           int step) {
  const int lane = threadIdx.x & 31;
  int bad = 0;
  for (int blk = first; blk < w * w; blk += step) {
    const int bi = blk / w, bj = blk % w;
    const int row = 32 * bi + lane, mirror = 32 * bj + lane;
    const uint32_t x = row < n ? bits[(size_t)row * w + bj] : 0u;
    const uint32_t y = mirror < n ? bits[(size_t)mirror * w + bi] : 0u;
    uint32_t t = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const uint32_t col = __ballot_sync(kFull, (x >> b) & 1u);
      if (lane == b) t = col;
    }
    bad |= t != y;
  }
  return __any_sync(kFull, bad);
}

// Connected components of a symmetric packed adjacency, Shiloach-Vishkin
// style: p[i] (shared, set to i by the caller) ends as the least node index
// of i's component.  A round shortcuts every pointer to its root (repeated
// jumps until none moves), then each node hooks its root onto the least
// root among its neighbours (integer atomicMin; a full word through the
// word's least pointer, taken at the round's start).  A pointer only falls
// and always names a node of its component, so the result is the same
// whatever order the racing updates take; a round without a hook ends the
// loop (every edge then joins equal roots).  Each round at least halves
// the trees that can still hook, so rounds grow as log N, not as the
// graph's diameter.  A word holding a neighbour whose pointer is the
// word's least (wmin, at the positions wmask) takes that least at once,
// one holding none of those but one of the next least (wmin2, wmask2) that
// one; so does every word of a dense component after its first round.
// Rows are ws words apart.  kThreadRows: a thread a row, walking its words
// (the rows in shared memory at an odd stride, so a warp's 32 rows' word k
// lie in 32 banks; a warp a row issued ~100 instructions a row, and the
// hooking held 19-37 thousand cycles a round of a 1024-node lane on an
// H100), kRowWords words' loads at once (leaving a row at its first
// neighbour pointing at node 0 made sparse lanes 2x slower); else a warp
// a row (rows in device memory: coalesced).  Not inlined: G1's
// cooperative kernel spills around it otherwise (0.76 against 0.92 ms at
// N = 4096).  wbuf: 4w shared ints.  Returns the hooking rounds.
constexpr int kRowWords = 8;
template <bool kThreadRows>
__device__ __noinline__ int components(const uint32_t* bits, int n, int w, int ws,
                                       int* p, int* wbuf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  volatile int* vp = p;
  int* wmin = wbuf;
  unsigned* wmask = (unsigned*)(wbuf + w);
  int* wmin2 = wbuf + 2 * w;
  unsigned* wmask2 = (unsigned*)(wbuf + 3 * w);
  // The least pointer among word k's set bits in x (none of them at a
  // position of the word's least pointer).
  auto rest_min = [&](int k, uint32_t x, int m) {
    if (x & wmask2[k]) return min(m, wmin2[k]);
    while (x) {
      const int b = __ffs(x) - 1;
      x &= x - 1;
      m = min(m, vp[32 * k + b]);
    }
    return m;
  };
  int rounds = 0;
  for (;;) {
    for (;;) {
      int moved = 0;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int up = vp[i], top = vp[up];
        if (top < up) {
          vp[i] = top;
          moved = 1;
        }
      }
      if (!__syncthreads_or(moved)) break;
    }
    for (int k = warp; k < w; k += nwarps) {  // a warp a word
      const int j = 32 * k + lane;
      const int v = j < n ? vp[j] : n;
      const int m = warp_min(v);
      const unsigned at = __ballot_sync(kFull, j < n && v == m);
      const int m2 = warp_min(v == m ? n : v);  // the next least pointer
      const unsigned at2 = __ballot_sync(kFull, j < n && v == m2);
      if (lane == 0) {
        wmin[k] = m;
        wmask[k] = at;
        wmin2[k] = m2;
        wmask2[k] = at2;
      }
    }
    __syncthreads();
    int hooked = 0;
    for (int i = kThreadRows ? threadIdx.x : warp; i < n;
         i += kThreadRows ? blockDim.x : nwarps) {
      const uint32_t* row = bits + (size_t)i * ws;
      int m = n;
      if (kThreadRows) {  // kRowWords words' loads in flight at once
        for (int k0 = 0; k0 < w; k0 += kRowWords) {
          uint32_t x[kRowWords], at[kRowWords];
          int lo[kRowWords];
#pragma unroll
          for (int u = 0; u < kRowWords; ++u) {
            const bool in = k0 + u < w;
            x[u] = in ? row[k0 + u] : 0u;
            at[u] = in ? wmask[k0 + u] : 0u;
            lo[u] = in ? wmin[k0 + u] : n;
          }
#pragma unroll
          for (int u = 0; u < kRowWords; ++u) {
            if (x[u] & at[u])
              m = min(m, lo[u]);
            else if (x[u])
              m = rest_min(k0 + u, x[u], m);
          }
        }
      } else {
        for (int k = lane; k < w; k += 32) {
          const uint32_t x = row[k];
          m = x & wmask[k] ? min(m, wmin[k]) : rest_min(k, x, m);
        }
        m = warp_min(m);
      }
      if (kThreadRows || lane == 0) {
        const int root = vp[i];
        if (m < root) {
          atomicMin(&p[root], m);
          hooked = 1;
        }
      }
    }
    ++rounds;
    if (!__syncthreads_or(hooked)) break;
  }
  return rounds;
}

// Row i of G1's masked adjacency, packed by one warp: bit j of word k set iff
// nodes i and j = 32k + bit are alive and reach_row[j] > 0.  Sixteen words'
// loads are issued before their ballots (a row is latency-bound otherwise).
constexpr int kPackUnroll = 16;
__device__ void pack_row(const float* reach_row, const unsigned char* alive,
                         bool alive_i, int n, int w, uint32_t* out_row) {
  const int lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < w; k0 += kPackUnroll) {
    float r[kPackUnroll];
    bool a[kPackUnroll];
#pragma unroll
    for (int u = 0; u < kPackUnroll; ++u) {
      const int j = 32 * (k0 + u) + lane;
      const bool in = alive_i && j < n;
      r[u] = in ? reach_row[j] : 0.f;
      a[u] = in && alive[j];
    }
#pragma unroll
    for (int u = 0; u < kPackUnroll; ++u) {
      const uint32_t word = __ballot_sync(kFull, a[u] && r[u] > 0.f);
      if (lane == 0 && k0 + u < w) out_row[k0 + u] = word;
    }
  }
}

// Row i of a 0/1 "same label" matrix, written by one warp (li > 0: live).
__device__ void label_row(const int* lab, int li, int n, float* out_row) {
  for (int j = threadIdx.x & 31; j < n; j += 32)
    out_row[j] = (li > 0 && lab[j] == li) ? 1.f : 0.f;
}

// pack_row with 16-byte loads (n % 4 == 0, the row and alive 16- and
// 4-byte aligned): a step of the warp covers 128 columns, lane l holding
// columns 4l..4l+3, whose bits are nibble l % 8 of word l / 8; each
// word's eight nibbles are ORed by shuffles.  Eight steps' loads (a 1024
// column row) are in flight before their bits.
constexpr int kPack4Unroll = 8;
__device__ void pack_row4(const float* reach_row, const unsigned char* alive,
                          bool alive_i, int n, int w, uint32_t* out_row) {
  const int lane = threadIdx.x & 31, n4 = n / 4;
  const float4* row4 = (const float4*)reach_row;
  const uint32_t* alive4 = (const uint32_t*)alive;
  for (int s0 = 0; 32 * s0 < n4; s0 += kPack4Unroll) {
    float4 r[kPack4Unroll];
    uint32_t al[kPack4Unroll];
#pragma unroll
    for (int u = 0; u < kPack4Unroll; ++u) {
      const int q = 32 * (s0 + u) + lane;
      const bool in = alive_i && q < n4;
      r[u] = in ? row4[q] : make_float4(0.f, 0.f, 0.f, 0.f);
      al[u] = in ? alive4[q] : 0u;
    }
#pragma unroll
    for (int u = 0; u < kPack4Unroll; ++u) {
      const uint32_t nib = ((r[u].x > 0.f && (al[u] & 0xffu)) ? 1u : 0u) |
                           ((r[u].y > 0.f && (al[u] & 0xff00u)) ? 2u : 0u) |
                           ((r[u].z > 0.f && (al[u] & 0xff0000u)) ? 4u : 0u) |
                           ((r[u].w > 0.f && (al[u] & 0xff000000u)) ? 8u : 0u);
      uint32_t word = nib << (4 * (lane & 7));
      word |= __shfl_xor_sync(kFull, word, 1);
      word |= __shfl_xor_sync(kFull, word, 2);
      word |= __shfl_xor_sync(kFull, word, 4);
      const int k = 4 * (s0 + u) + (lane >> 3);
      if ((lane & 7) == 0 && k < w) out_row[k] = word;
    }
  }
}

// label_row with 16-byte stores (n % 4 == 0, the row 16-byte aligned; lab
// in shared memory, 16-byte aligned).
__device__ void label_row4(const int* lab, int li, int n, float* out_row) {
  const int4* l4 = (const int4*)lab;
  float4* o4 = (float4*)out_row;
  for (int q = threadIdx.x & 31; q < n / 4; q += 32) {
    const int4 l = l4[q];
    o4[q] = make_float4((li > 0 && l.x == li) ? 1.f : 0.f,
                        (li > 0 && l.y == li) ? 1.f : 0.f,
                        (li > 0 && l.z == li) ? 1.f : 0.f,
                        (li > 0 && l.w == li) ? 1.f : 0.f);
  }
}

struct G1Layout {
  size_t lab, inv, wmax, cnt, red, total;
};

// Shared memory of G1's CTA a lane (dgi_kernels.g1_smem_bytes): the packed
// rows, ws words apart, when ws > 0, then labels, rank -> node, word
// maxima, group counts and a reduction buffer.
__host__ __device__ inline G1Layout g1_layout(int n, int w, int ws) {
  G1Layout s;
  size_t off = align16((size_t)n * ws * 4);
  s.lab = off;
  off = align16(off + 4 * (size_t)n);
  s.inv = off;
  off = align16(off + 4 * ((size_t)n + 1));
  s.wmax = off;  // word maxima, or two levels of word minima and masks: 4w ints
  off = align16(off + 16 * (size_t)w);
  s.cnt = off;
  off = align16(off + 4 * ((size_t)n + 1));
  s.red = off;
  s.total = off + 128;
  return s;
}

struct G1Args {
  const float* reach;
  long long reach_stride;  // floats between lanes' matrices (0: shared)
  const unsigned char* alive;  // [lanes, n]
  const int* rank;             // [n], a permutation of 1..n
  int* coord;
  float* mask;
  unsigned char* is_coord;
  int* size;
  int* ngroups;
  int* sweeps;      // [lanes] or null
  uint32_t* bits;   // [lanes, n, w]
  int* labels;      // [lanes, n]
  int* asym;        // [lanes]; nonzero: not symmetric
  unsigned* bar;    // the grid barrier's [arrivals, generation]
  int n, w;
  int lanes;
  bool staged;      // the label CTA copies the bits in
  bool vec;         // 16-byte rows (pack_row4, label_row4)
};

// Labels of lane b (bits ready: rows ws words apart; in shared memory
// when ws_smem = ws, the layout's, else 0), then coordinator,
// is_coordinator, group_size and n_groups.  A symmetric adjacency (the reference's
// contract) takes `components`, then each component's largest live rank
// (integer atomicMax); any other runs the label sweeps of `close_labels`,
// the reference's directed closure.  Leaves lab in shared memory.
__device__ void g1_groups(const G1Args& a, int b, const uint32_t* bits, int ws,
                          unsigned char* smem, int ws_smem, bool symmetric) {
  const int n = a.n, w = a.w, tid = threadIdx.x, bd = blockDim.x;
  const G1Layout L = g1_layout(n, w, ws_smem);
  int* lab = (int*)(smem + L.lab);
  int* inv = (int*)(smem + L.inv);
  int* wbuf = (int*)(smem + L.wmax);
  int* cnt = (int*)(smem + L.cnt);
  int* red = (int*)(smem + L.red);
  const unsigned char* alive = a.alive + (size_t)b * n;
  for (int i = tid; i < n; i += bd) inv[a.rank[i]] = i;
  for (int l = tid; l <= n; l += bd) cnt[l] = 0;
  __syncthreads();
  int sweeps;
  if (symmetric) {
    for (int i = tid; i < n; i += bd) lab[i] = i;
    __syncthreads();
    sweeps = ws_smem && (ws & 1) ? components<true>(bits, n, w, ws, lab, wbuf)
                                 : components<false>(bits, n, w, ws, lab, wbuf);
    for (int i = tid; i < n; i += bd)  // cnt: a component's largest rank
      if (alive[i]) atomicMax(&cnt[lab[i]], a.rank[i]);
    __syncthreads();
    for (int i = tid; i < n; i += bd) lab[i] = alive[i] ? cnt[lab[i]] : 0;
    __syncthreads();
    for (int l = tid; l <= n; l += bd) cnt[l] = 0;
  } else {
    for (int i = tid; i < n; i += bd) lab[i] = alive[i] ? a.rank[i] : 0;
    __syncthreads();
    sweeps = -close_labels(bits, n, w, ws, lab, inv, wbuf);
  }
  __syncthreads();
  for (int i = tid; i < n; i += bd)
    if (lab[i] > 0) atomicAdd(&cnt[lab[i]], 1);
  __syncthreads();
  int mine = 0;
  for (int i = tid; i < n; i += bd) {
    const int l = lab[i];
    const size_t o = (size_t)b * n + i;
    const bool c = l > 0 && a.rank[i] == l;
    a.coord[o] = l > 0 ? inv[l] : -1;
    a.is_coord[o] = c;
    a.size[o] = l > 0 ? cnt[l] : 0;
    mine += c;
  }
  const int groups = block_sum(mine, red);
  if (tid == 0) {
    a.ngroups[b] = groups;
    if (a.sweeps) a.sweeps[b] = sweeps;
  }
}

// A lane's packed rows (n rows of w words) into shared memory, ws words
// apart, by the whole CTA (no barrier).  16-byte loads where w % 4 == 0: a
// row's quads on a group of lanes, 32 / group rows a warp step (their
// stores hit 32 banks); else a warp a row.  Through L2: other CTAs wrote
// the rows in this launch.
__device__ void stage_rows(const uint32_t* bits, int n, int w, int ws, uint32_t* sb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  if (w % 4 == 0) {
    const int wq = w / 4, group = wq <= 8 ? 8 : 16;
    const int sub = lane / group, q = lane % group, step = 32 / group;
    const uint4* src = (const uint4*)bits;
#pragma unroll 4
    for (int r = warp * step + sub; r < n; r += nwarps * step) {
      if (q < wq) {
        const uint4 x = __ldcg(src + (size_t)r * wq + q);
        uint32_t* d = sb + r * ws + 4 * q;
        d[0] = x.x;
        d[1] = x.y;
        d[2] = x.z;
        d[3] = x.w;
      }
    }
  } else {
    for (int k = lane; k < w; k += 32)
      for (int r = warp; r < n; r += nwarps)
        sb[r * ws + k] = __ldcg(bits + (size_t)r * w + k);
  }
}

// G1: pack, symmetry check, label, mask, one launch; CTA c's
// rows are [rows c / G, rows (c + 1) / G) of the lanes' rows in order
// (dgi_kernels.g1_rows).
__global__ void __launch_bounds__(kG1Threads) g1_global_kernel(const G1Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, w = a.w, lanes = a.lanes, tid = threadIdx.x;
  const int warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int G = (int)gridDim.x;
  const long long rows = (long long)lanes * n;
  const long long r0 = rows * blockIdx.x / G, r1 = rows * (blockIdx.x + 1) / G;
  for (long long r = r0 + warp; r < r1; r += nwarps) {
    const int b = (int)(r / n), i = (int)(r - (long long)b * n);
    const unsigned char* alive = a.alive + (size_t)b * n;
    const float* row = a.reach + (size_t)b * a.reach_stride + (size_t)i * n;
    uint32_t* out = a.bits + (size_t)r * w;
    if (a.vec)
      pack_row4(row, alive, alive[i] != 0, n, w, out);
    else
      pack_row(row, alive, alive[i] != 0, n, w, out);
  }
  if (blockIdx.x == 0)
    for (int b = tid; b < lanes; b += blockDim.x) a.asym[b] = 0;
  grid_sync(a.bar, (unsigned)G);
  const int ws = a.staged ? (w | 1) : 0;  // an odd stride: no bank conflicts
  if (a.staged && (int)blockIdx.x < lanes)  // the CTA's first lane's rows
    stage_rows(a.bits + (size_t)blockIdx.x * n * w, n, w, ws, (uint32_t*)smem);
  {  // every lane's bit blocks (I, J >= I) against their mirrors, dealt
     // to the grid's warps
    const int blocks = w * (w + 1) / 2;
    const long long total = (long long)lanes * blocks;
    for (long long q = (long long)blockIdx.x * nwarps + warp; q < total;
         q += (long long)G * nwarps) {
      const int b = (int)(q / blocks);
      int t = (int)(q - (long long)b * blocks), bi = 0;  // t -> (bi, bj >= bi)
      while (t >= w - bi) t -= w - bi++;
      const uint32_t* bits = a.bits + (size_t)b * n * w;
      if (asym_blocks(bits, n, w, bi * w + bi + t, w * w) && (tid & 31) == 0)
        atomicOr(&a.asym[b], 1);
    }
  }
  grid_sync(a.bar, (unsigned)G);
  for (int b = blockIdx.x; b < lanes; b += G) {
    const uint32_t* bits = a.bits + (size_t)b * n * w;
    if (a.staged) {
      if (b != (int)blockIdx.x) {  // the first lane's rows came in above
        stage_rows(bits, n, w, ws, (uint32_t*)smem);
        __syncthreads();
      }
      bits = (const uint32_t*)smem;
    }
    g1_groups(a, b, bits, a.staged ? ws : w, smem, ws, __ldcg(a.asym + b) == 0);
    const int* lab = (const int*)(smem + g1_layout(n, w, ws).lab);
    for (int i = tid; i < n; i += blockDim.x) a.labels[(size_t)b * n + i] = lab[i];
    __syncthreads();  // the next lane reuses shared memory
  }
  grid_sync(a.bar, (unsigned)G);
  int* lab = (int*)smem;
  for (long long r = r0; r < r1;) {  // the lanes this CTA's rows belong to
    const int b = (int)(r / n);
    const long long end = min(r1, (long long)(b + 1) * n);
    __syncthreads();  // the previous lane's rows are written
    for (int i = tid; i < n; i += blockDim.x)
      lab[i] = __ldcg(a.labels + (size_t)b * n + i);
    __syncthreads();
    for (long long q = r + warp; q < end; q += nwarps) {
      const int i = (int)(q - (long long)b * n);
      float* out = a.mask + (size_t)q * n;
      if (a.vec)
        label_row4(lab, lab[i], n, out);
      else
        label_row(lab, lab[i], n, out);
    }
    r = end;
  }
}

struct R1Args {
  const uint32_t* base;  // [v, w] packed ungated rows
  const int* fr;
  const int* to;
  const float* closed;  // [scenarios, nf]
  float* out;           // [scenarios, v, v]
  uint32_t* scratch;    // [scenarios, v, w] above the shared-memory size
  int* sweeps;          // [scenarios] or null
  int v, w, nf;
};

// Shared memory of R1's CTA (dgi_kernels.r1_smem_bytes).
__host__ __device__ inline size_t r1_lab_offset(int v, int w, bool bits) {
  return bits ? align16((size_t)v * w * 4) : 0;
}
__host__ __device__ inline size_t r1_bytes(int v, int w, bool bits) {
  const size_t lab = r1_lab_offset(v, w, bits);
  const size_t wbuf = align16(lab + 4 * (size_t)v);
  return align16(wbuf + 16 * (size_t)w);
}

__global__ void __launch_bounds__(1024) r1_kernel(const R1Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, v = a.v, w = a.w, tid = threadIdx.x;
  const int bd = blockDim.x, warp = tid >> 5, nwarps = bd >> 5;
  const bool in_smem = a.scratch == nullptr;
  uint32_t* bits = in_smem ? (uint32_t*)smem
                           : a.scratch + (size_t)s * v * w;
  int* lab = (int*)(smem + r1_lab_offset(v, w, in_smem));
  int* wmax = (int*)(smem + align16(r1_lab_offset(v, w, in_smem) +
                                    4 * (size_t)v));
  for (size_t k = tid; k < (size_t)v * w; k += bd) bits[k] = a.base[k];
  for (int i = tid; i < v; i += bd) lab[i] = i;
  __syncthreads();
  const float* closed = a.closed + (size_t)s * a.nf;
  for (int f = tid; f < a.nf; f += bd) {
    if (closed[f] > 0.f) {
      const int x = a.fr[f], y = a.to[f];
      atomicOr(&bits[(size_t)x * w + (y >> 5)], 1u << (y & 31));
      atomicOr(&bits[(size_t)y * w + (x >> 5)], 1u << (x & 31));
    }
  }
  __syncthreads();
  const int rounds = components<false>(bits, v, w, w, lab, wmax);
  for (int i = tid; i < v; i += bd) lab[i] += 1;  // label_row's live mark
  __syncthreads();
  for (int i = warp; i < v; i += nwarps)
    label_row(lab, lab[i], v, a.out + ((size_t)s * v + i) * v);
  if (tid == 0 && a.sweeps) a.sweeps[s] = rounds;
}

// ---------------------------------------------------------------------------
// B1: the draft auction
// ---------------------------------------------------------------------------

__device__ __forceinline__ float sub_rn(float x, float y) {
  return __fsub_rn(x, y);
}
__device__ __forceinline__ double sub_rn(double x, double y) {
  return __dsub_rn(x, y);
}
__device__ __forceinline__ float add_rn(float x, float y) {
  return __fadd_rn(x, y);
}
__device__ __forceinline__ double add_rn(double x, double y) {
  return __dadd_rn(x, y);
}
// float32 |x| of the imbalance (the reference's abs(imbalance).astype(f32)).
__device__ __forceinline__ float key_of(float x) { return fabsf(x); }
__device__ __forceinline__ float key_of(double x) {
  return __double2float_rn(fabs(x));
}

// B1 sorts the packed 64-bit key below 2^15 nodes and the WIDE key pair
// from there (the reference's unpacked branch, freedm_tpu/modules/lb.py
// :178-189, begins at 2^15 nodes as well).
constexpr int kLBWideNodes = 32768;     // 2^15
constexpr int kLBMaxNodes = 1073741824;  // 2^30: the WIDE key's 30-bit group id

struct LBLayout {
  size_t keys, idx, gw, start, seglen, total;
};

// A fleet's working set (dgi_kernels.lb_state_bytes), after the 128-byte
// reduction buffer at the start of shared memory (forms SHARED and GLOBAL;
// form WIDE keeps it in device memory): the sort keys, the WIDE form's
// node indices, the gateway, the segment starts and lengths.
__host__ __device__ inline LBLayout lb_layout(int npad, int n, int gsize, bool wide) {
  LBLayout s;
  s.keys = 0;
  size_t off = align16(8 * (size_t)npad);
  s.idx = off;
  if (wide) off = align16(off + 4 * (size_t)npad);
  s.gw = off;
  off = align16(off + (size_t)gsize * n);
  s.start = off;
  off = align16(off + 4 * (size_t)npad);
  s.seglen = off;
  s.total = align16(off + 4 * (size_t)npad);
  return s;
}

template <typename T, typename G>
struct LBArgs {
  const T* ng;   // [fleets, n] in the imbalance's type
  const G* gw0;  // [fleets, n]
  const int* gid;
  long long gid_stride;
  const float* mal;
  long long mal_stride;
  const unsigned char* gate;
  long long gate_stride;
  double step;
  G* gw_out;
  int* migs;    // [fleets, rounds]
  int* states;  // [fleets, rounds, n]
  int* rank;    // round outputs (one round) or null
  float* sup;
  float* dem;
  float* intr;
  unsigned char* scratch;  // form GLOBAL: [fleets, state bytes]
  size_t scratch_stride;
  int n, npad, rounds;
};

// The sort keys of a fleet.  Packed (below 2^15 nodes): one 64-bit word,
// group id (15 bits) | class (2) | ~bits(float32 |imbalance|) (32) | index
// (15).  WIDE: a pair compared lexicographically, the 64-bit group id (30
// bits) | class (2) | ~bits(|imbalance|) (32) and the 32-bit index.  Both
// are total orders equal to the reference's stable sort by (group, class,
// -key), index order breaking ties.  `prefix` is a node's (group, class),
// `node` its index.
template <bool kWide>
struct LBKeys {
  uint64_t* key;
  uint32_t* idx;  // WIDE only
  __device__ __forceinline__ void set(int q, uint32_t gid, int cls, uint32_t kb) const {
    if (kWide) {
      key[q] = ((uint64_t)gid << 34) | ((uint64_t)cls << 32) | (uint64_t)kb;
      idx[q] = (uint32_t)q;
    } else {
      key[q] = ((uint64_t)gid << 49) | ((uint64_t)cls << 47) | ((uint64_t)kb << 15) |
               (uint64_t)q;
    }
  }
  __device__ __forceinline__ void pad(int q) const {  // padding sorts last
    key[q] = ~0ull;
    if (kWide) idx[q] = ~0u;
  }
  __device__ __forceinline__ uint32_t prefix(int q) const {
    return kWide ? (uint32_t)(key[q] >> 32) : (uint32_t)(key[q] >> 47);
  }
  __device__ __forceinline__ int node(int q) const {
    return kWide ? (int)idx[q] : (int)(key[q] & 0x7fff);
  }
};

// Ascending bitonic sort of npad (a power of two) keys.
__device__ void bitonic_sort(uint64_t* keys, int npad) {
  for (int k = 2; k <= npad; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < npad; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t x = keys[i], y = keys[ixj];
          if ((x > y) == ((i & k) == 0)) {
            keys[i] = y;
            keys[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Ascending bitonic sort of npad (a power of two) key pairs (hi, lo),
// compared lexicographically.
__device__ void bitonic_sort_wide(uint64_t* hi, uint32_t* lo, int npad) {
  for (int k = 2; k <= npad; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < npad; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t x = hi[i], y = hi[ixj];
          const uint32_t xl = lo[i], yl = lo[ixj];
          const bool gt = x > y || (x == y && xl > yl);
          if (gt == ((i & k) == 0)) {
            hi[i] = y;
            hi[ixj] = x;
            lo[i] = yl;
            lo[ixj] = xl;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Inclusive max-scan of a[0..npad) in place; npad a multiple of blockDim,
// each thread a contiguous run; `red` >= 32 shared ints.
__device__ void block_max_scan(int* a, int npad, int* red) {
  const int per = npad / blockDim.x, base = threadIdx.x * per;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int run = 0;
  for (int c = 0; c < per; ++c) {
    run = max(run, a[base + c]);
    a[base + c] = run;
  }
  int v = run;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = max(v, u);
  }
  if (lane == 31) red[warp] = v;
  __syncthreads();
  int before = __shfl_up_sync(kFull, v, 1);
  if (lane == 0) before = 0;
  for (int k = 0; k < warp; ++k) before = max(before, red[k]);
  for (int c = 0; c < per; ++c) a[base + c] = max(a[base + c], before);
  __syncthreads();
}

template <typename T, typename G, bool kWide>
__global__ void __launch_bounds__(1024) lb_rounds_kernel(const LBArgs<T, G> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, n = a.n, npad = a.npad;
  const int tid = threadIdx.x, bd = blockDim.x;
  int* red = (int*)smem;
  unsigned char* base =
      a.scratch ? a.scratch + (size_t)b * a.scratch_stride : smem + 128;
  const LBLayout L = lb_layout(npad, n, (int)sizeof(G), kWide);
  const LBKeys<kWide> keys{(uint64_t*)(base + L.keys), (uint32_t*)(base + L.idx)};
  G* gw = (G*)(base + L.gw);
  int* start = (int*)(base + L.start);
  int* seglen = (int*)(base + L.seglen);
  const T* ng = a.ng + (size_t)b * n;
  const int* gid = a.gid + (size_t)b * a.gid_stride;
  const float* mal = a.mal ? a.mal + (size_t)b * a.mal_stride : nullptr;
  const unsigned char* gate =
      a.gate ? a.gate + (size_t)b * a.gate_stride : nullptr;
  const T step = (T)a.step;
  const float step_f = (float)a.step;
  for (int i = tid; i < n; i += bd) gw[i] = a.gw0[(size_t)b * n + i];
  __syncthreads();
  for (int r = 0; r < a.rounds; ++r) {
    // Classification and sort keys, in node order.
    for (int i = tid; i < npad; i += bd) {
      if (i < n) {
        const T imb = sub_rn(ng[i], (T)gw[i]);
        const int st = imb >= step ? 1 : (imb <= -step ? -1 : 0);
        if (a.states) a.states[((size_t)b * a.rounds + r) * n + i] = st;
        const bool ok = gate == nullptr || gate[i] != 0;
        const int cls = (st == 1 && ok) ? 0 : ((st == -1 && ok) ? 1 : 2);
        const uint32_t kb = cls < 2 ? ~__float_as_uint(key_of(imb)) : 0u;
        keys.set(i, (uint32_t)gid[i], cls, kb);
      } else {
        keys.pad(i);
      }
    }
    __syncthreads();
    if (kWide)
      bitonic_sort_wide(keys.key, keys.idx, npad);
    else
      bitonic_sort(keys.key, npad);
    // Segment (group, class) starts: a max-scan of the boundaries.
    for (int q = tid; q < npad; q += bd)
      start[q] = (q == 0 || keys.prefix(q) != keys.prefix(q - 1)) ? q : 0;
    __syncthreads();
    block_max_scan(start, npad, red);
    // Segment lengths, written at each segment's start by its last node.
    for (int q = tid; q < n; q += bd)
      if (q == n - 1 || keys.prefix(q + 1) != keys.prefix(q))
        seglen[start[q]] = q - start[q] + 1;
    __syncthreads();
    int mig = 0;
    for (int q = tid; q < n; q += bd) {
      const int p = keys.node(q);
      const uint32_t pre = keys.prefix(q);
      const int cls = (int)(pre & 3);
      const int s = start[q], rin = q - s;
      int scnt = 0, dcnt = 0;
      if (cls == 0) {  // the group's demand segment follows its supply one
        scnt = seglen[s];
        const int e = s + scnt;
        if (e < n && keys.prefix(e) == pre + 1) dcnt = seglen[e];
      } else if (cls == 1) {
        dcnt = seglen[s];
        if (s > 0 && keys.prefix(s - 1) == pre - 1) scnt = seglen[start[s - 1]];
      }
      const bool sm = cls == 0 && rin < dcnt;
      const bool dm = cls == 1 && rin < scnt;
      const float one_m = __fsub_rn(1.f, mal ? mal[p] : 0.f);
      const float delta = __fsub_rn(sm ? step_f : 0.f,
                                    dm ? __fmul_rn(step_f, one_m) : 0.f);
      gw[p] = add_rn(gw[p], (G)delta);
      mig += sm;
      if (a.rank) {  // one round: lb_round's per-node outputs
        const size_t o = (size_t)b * n + p;
        const float acc = __fmul_rn(dm ? 1.f : 0.f, step_f);
        const float app = mal ? __fmul_rn(acc, one_m) : acc;
        a.rank[o] = cls < 2 ? rin : n;
        a.sup[o] = __fmul_rn(sm ? 1.f : 0.f, step_f);
        a.dem[o] = -app;
        a.intr[o] = __fsub_rn(app, acc);
      }
    }
    mig = block_sum(mig, red);
    if (tid == 0) a.migs[(size_t)b * a.rounds + r] = mig;
    __syncthreads();
  }
  for (int i = tid; i < n; i += bd) a.gw_out[(size_t)b * n + i] = gw[i];
}

// ---------------------------------------------------------------------------
// B1 form CLUSTER: a fleet's WIDE key pairs on a thread-block cluster
// ---------------------------------------------------------------------------

// dgi_kernels.py reads these for lb_cluster_plan: keep each a
// `constexpr int name = value;`.  A fleet of npad padded nodes takes
// kLBClusterMax CTAs of 1024 threads (a non-portable cluster size), each
// holding npad / kLBClusterMax padded nodes — at most kLBClusterShare —
// with their key pairs, gateway, segment starts and lengths in shared
// memory.  (The launch takes any power-of-two cluster whose share is a
// multiple of 1024 nodes; on an H100 at 2^16 nodes x 64 rounds 16 CTAs
// took 9.1 ms, 8 CTAs 14.0 ms; at 2^15 x 4 fleets 16 / 8 / 4 CTAs 5.35 /
// 7.48 / 11.9 ms.)
constexpr int kLBClusterMax = 16;
constexpr int kLBClusterShare = 8192;
constexpr int kLBClusterThreads = 1024;
constexpr int kLBClusterPer = kLBClusterShare / kLBClusterThreads;  // a thread's pairs at most

struct LBClusterLayout {
  size_t slot, hi, lo, gw, start, seglen, total;
};

// A CTA's shared memory (dgi_kernels.lb_cluster_smem): the 128-byte
// reduction buffer, four int slots (the scan carry, the migrations, the
// carry before this CTA), then `share` key words, indices, gateway
// values, segment starts and lengths.
__host__ __device__ inline LBClusterLayout lb_cluster_layout(int share, int gsize) {
  LBClusterLayout L;
  L.slot = 128;
  L.hi = L.slot + 16;
  L.lo = L.hi + 8 * (size_t)share;
  L.gw = L.lo + 4 * (size_t)share;
  L.start = align16(L.gw + (size_t)gsize * share);
  L.seglen = L.start + 4 * (size_t)share;
  L.total = L.seglen + 4 * (size_t)share;
  return L;
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A fleet's arrays spread over its cluster by position (keys, starts,
// lengths) or node (gateway): CTA `rank` holds [rank share, (rank + 1)
// share); `at` gives element q's address, in this CTA's shared memory or
// through distributed shared memory.
struct LBSpread {
  int rank, lg, mask;
  template <typename P>
  __device__ __forceinline__ P* at(P* local, int q) const {
    const int o = q >> lg;
    return (o == rank ? local : cg::cluster_group::map_shared_rank(local, o)) +
           (q & mask);
  }
};

// Ascending bitonic sort of the cluster's npad key pairs (hi, lo),
// compared lexicographically.  A step whose partner lies in this CTA's
// share (j < share) compares in shared memory under __syncthreads; one
// whose partner lies in CTA rank ^ (j / share) reads the partner's pairs
// through distributed shared memory between two cluster barriers and
// keeps this CTA's side (the min or the max) in place.
__device__ void cluster_bitonic(const LBSpread& sp, uint64_t* hi, uint32_t* lo,
                                int npad) {
  const int share = sp.mask + 1, base = sp.rank * share;
  const int tid = threadIdx.x, bd = blockDim.x, per = share / bd;
  for (int k = 2; k <= npad; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= share) {
        const int o = sp.rank ^ (j >> sp.lg);
        const uint64_t* rhi = cg::cluster_group::map_shared_rank(hi, o);
        const uint32_t* rlo = cg::cluster_group::map_shared_rank(lo, o);
        uint64_t ph[kLBClusterPer];
        uint32_t pl[kLBClusterPer];
        cluster_sync_all();  // the partner's previous step is done
#pragma unroll
        for (int e = 0; e < kLBClusterPer; ++e)
          if (e < per) {
            ph[e] = rhi[tid + e * bd];
            pl[e] = rlo[tid + e * bd];
          }
        cluster_sync_all();  // every read of this step is done
#pragma unroll
        for (int e = 0; e < kLBClusterPer; ++e)
          if (e < per) {
            const int l = tid + e * bd, q = base + l;
            const uint64_t x = hi[l];
            const uint32_t xl = lo[l];
            const bool gt = x > ph[e] || (x == ph[e] && xl > pl[e]);
            // The lower position of an ascending run (or the upper of a
            // descending one) keeps the min.
            if (((q & j) == 0) == ((q & k) == 0) ? gt : !gt) {
              hi[l] = ph[e];
              lo[l] = pl[e];
            }
          }
        __syncthreads();
      } else {
        for (int p = tid; p < (share >> 1); p += bd) {
          const int l = ((p & ~(j - 1)) << 1) | (p & (j - 1)), m = l + j;
          const uint64_t x = hi[l], y = hi[m];
          const uint32_t xl = lo[l], yl = lo[m];
          const bool gt = x > y || (x == y && xl > yl);
          if (gt == (((base + l) & k) == 0)) {
            hi[l] = y;
            hi[m] = x;
            lo[l] = yl;
            lo[m] = xl;
          }
        }
        __syncthreads();
      }
    }
  }
}

// B1's rounds of one fleet on one cluster (fleet blockIdx.x / cluster
// size): the WIDE form's arithmetic (lb_rounds_kernel) over arrays spread
// by sp.  Each round: classification and keys of this CTA's nodes; the
// cluster sort; segment starts by a max-scan in each CTA and the earlier
// CTAs' carries; segment lengths written at segment starts (in whichever
// CTA); the gateway update of each sorted position's node (in whichever
// CTA holds it) and the migrations summed by rank 0 in rank order.
template <typename T, typename G>
__global__ void __launch_bounds__(kLBClusterThreads)
    lb_cluster_kernel(const LBArgs<T, G> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const cg::cluster_group cl = cg::this_cluster();
  const int csize = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int b = blockIdx.x / csize, n = a.n, npad = a.npad;
  const int share = npad / csize, base = rank * share;
  const int tid = threadIdx.x, bd = blockDim.x;
  const LBSpread sp{rank, 31 - __clz(share), share - 1};
  const LBClusterLayout L = lb_cluster_layout(share, (int)sizeof(G));
  int* red = (int*)smem;
  int* slot = (int*)(smem + L.slot);
  uint64_t* hi = (uint64_t*)(smem + L.hi);
  uint32_t* lo = (uint32_t*)(smem + L.lo);
  G* gw = (G*)(smem + L.gw);
  int* start = (int*)(smem + L.start);
  int* seglen = (int*)(smem + L.seglen);
  const T* ng = a.ng + (size_t)b * n;
  const int* gid = a.gid + (size_t)b * a.gid_stride;
  const float* mal = a.mal ? a.mal + (size_t)b * a.mal_stride : nullptr;
  const unsigned char* gate =
      a.gate ? a.gate + (size_t)b * a.gate_stride : nullptr;
  const T step = (T)a.step;
  const float step_f = (float)a.step;
  auto prefix = [&](int q) { return (uint32_t)(*sp.at(hi, q) >> 32); };
  for (int l = tid; l < share; l += bd)
    if (base + l < n) gw[l] = a.gw0[(size_t)b * n + base + l];
  for (int r = 0; r < a.rounds; ++r) {
    for (int l = tid; l < share; l += bd) {
      const int i = base + l;
      if (i < n) {
        const T imb = sub_rn(ng[i], (T)gw[l]);
        const int st = imb >= step ? 1 : (imb <= -step ? -1 : 0);
        if (a.states) a.states[((size_t)b * a.rounds + r) * n + i] = st;
        const bool ok = gate == nullptr || gate[i] != 0;
        const int cls = (st == 1 && ok) ? 0 : ((st == -1 && ok) ? 1 : 2);
        const uint32_t kb = cls < 2 ? ~__float_as_uint(key_of(imb)) : 0u;
        hi[l] = ((uint64_t)(uint32_t)gid[i] << 34) | ((uint64_t)cls << 32) |
                (uint64_t)kb;
        lo[l] = (uint32_t)i;
      } else {  // padding sorts last
        hi[l] = ~0ull;
        lo[l] = ~0u;
      }
    }
    __syncthreads();
    cluster_bitonic(sp, hi, lo, npad);
    cluster_sync_all();  // every CTA's sorted share is readable
    for (int l = tid; l < share; l += bd) {
      const int q = base + l;
      start[l] = (q == 0 || (uint32_t)(hi[l] >> 32) != prefix(q - 1)) ? q : 0;
    }
    __syncthreads();
    block_max_scan(start, share, red);
    if (tid == 0) slot[0] = start[share - 1];
    cluster_sync_all();  // every CTA's carry is out
    if (tid < 32) {  // the carry of the CTAs before this one
      int c = tid < rank ? *cl.map_shared_rank(slot, tid) : 0;
      c = warp_max(c);
      if (tid == 0) slot[2] = c;
    }
    __syncthreads();
    const int before = slot[2];
    for (int l = tid; l < share; l += bd) start[l] = max(start[l], before);
    __syncthreads();
    for (int l = tid; l < share; l += bd) {
      const int q = base + l;
      if (q < n && (q == n - 1 || prefix(q + 1) != (uint32_t)(hi[l] >> 32)))
        *sp.at(seglen, start[l]) = q - start[l] + 1;
    }
    cluster_sync_all();  // every segment's length is out
    int mig = 0;
    for (int l = tid; l < share; l += bd) {
      const int q = base + l;
      if (q >= n) break;
      const int p = (int)lo[l];
      const uint32_t pre = (uint32_t)(hi[l] >> 32);
      const int cls = (int)(pre & 3);
      const int s = start[l], rin = q - s;
      int scnt = 0, dcnt = 0;
      if (cls == 0) {  // the group's demand segment follows its supply one
        scnt = *sp.at(seglen, s);
        const int e = s + scnt;
        if (e < n && prefix(e) == pre + 1) dcnt = *sp.at(seglen, e);
      } else if (cls == 1) {
        dcnt = *sp.at(seglen, s);
        if (s > 0 && prefix(s - 1) == pre - 1)
          scnt = *sp.at(seglen, *sp.at(start, s - 1));
      }
      const bool sm = cls == 0 && rin < dcnt;
      const bool dm = cls == 1 && rin < scnt;
      const float one_m = __fsub_rn(1.f, mal ? mal[p] : 0.f);
      const float delta = __fsub_rn(sm ? step_f : 0.f,
                                    dm ? __fmul_rn(step_f, one_m) : 0.f);
      G* g = sp.at(gw, p);
      *g = add_rn(*g, (G)delta);
      mig += sm;
      if (a.rank) {  // one round: lb_round's per-node outputs
        const size_t o = (size_t)b * n + p;
        const float acc = __fmul_rn(dm ? 1.f : 0.f, step_f);
        const float app = mal ? __fmul_rn(acc, one_m) : acc;
        a.rank[o] = cls < 2 ? rin : n;
        a.sup[o] = __fmul_rn(sm ? 1.f : 0.f, step_f);
        a.dem[o] = -app;
        a.intr[o] = __fsub_rn(app, acc);
      }
    }
    mig = block_sum(mig, red);
    if (tid == 0) slot[1] = mig;
    cluster_sync_all();  // every gateway update and count is out
    if (rank == 0 && tid == 0) {
      int total = 0;
      for (int o = 0; o < csize; ++o) total += *cl.map_shared_rank(slot + 1, o);
      a.migs[(size_t)b * a.rounds + r] = total;
    }
  }
  for (int l = tid; l < share; l += bd)
    if (base + l < n) a.gw_out[(size_t)b * n + base + l] = gw[l];
  cluster_sync_all();  // no CTA leaves while rank 0 may read its slot
}

// Opt the cluster kernel in to a non-portable cluster size and to all the
// shared memory a block may take, once a device.
template <typename T, typename G>
cudaError_t lb_cluster_attributes() {
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && opted[dev])) return e;
  e = cudaFuncSetAttribute(lb_cluster_kernel<T, G>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(lb_cluster_kernel<T, G>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess && dev < 64) opted[dev] = true;
  return e;
}

template <typename T, typename G>
int lb_cluster_launch(const LBArgs<T, G>& a, int fleets, int cluster,
                      cudaStream_t stream) {
  const int share = a.npad / cluster;
  if (cluster < 1 || cluster > kLBClusterMax || share * cluster != a.npad ||
      share % kLBClusterThreads != 0 || share > kLBClusterShare ||
      (int64_t)fleets * cluster > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const size_t smem = lb_cluster_layout(share, (int)sizeof(G)).total;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = lb_cluster_attributes<T, G>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)fleets * (unsigned)cluster);
  cfg.blockDim = dim3(kLBClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, lb_cluster_kernel<T, G>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename Args>
int launch(void (*kernel)(const Args), dim3 grid, int threads, size_t smem,
           cudaStream_t stream, const Args& a) {
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // above 48 KB a kernel has to opt in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Threads of a CTA that works through n rows or nodes.
int cta_threads(int n) { return n <= 64 ? 64 : (n <= 256 ? 256 : 1024); }

template <typename T, typename G>
int lb_launch(const T* ng, const G* gw0, const int* gid, long long gid_stride,
              const float* mal, long long mal_stride,
              const unsigned char* gate, long long gate_stride, double step,
              G* gw_out, int* migs, int* states, int* rank, float* sup,
              float* dem, float* intr, void* scratch, int n, int rounds,
              int fleets, int cluster, void* stream) {
  const bool wide = n >= kLBWideNodes;
  if (n <= 0 || n > kLBMaxNodes || rounds <= 0 || fleets <= 0 ||
      (wide && !scratch && cluster == 0) || (cluster && (!wide || scratch)) ||
      (rank && (rounds != 1 || !sup || !dem || !intr)))
    return (int)cudaErrorInvalidValue;
  int npad = 32;
  while (npad < n) npad <<= 1;
  const LBLayout L = lb_layout(npad, n, (int)sizeof(G), wide);
  LBArgs<T, G> a{ng,     gw0,     gid,  gid_stride, mal,   mal_stride,
                 gate,   gate_stride, step, gw_out,  migs,  states,
                 rank,   sup,     dem,  intr,       (unsigned char*)scratch,
                 L.total, n,      npad, rounds};
  if (cluster)
    return lb_cluster_launch(a, fleets, cluster, (cudaStream_t)stream);
  const size_t smem = 128 + (scratch ? 0 : L.total);
  if (wide)
    return launch(lb_rounds_kernel<T, G, true>, dim3(fleets), 1024, smem,
                  (cudaStream_t)stream, a);
  return launch(lb_rounds_kernel<T, G, false>, dim3(fleets), min(npad, 1024), smem,
                (cudaStream_t)stream, a);
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer (indices
// int32, masks one byte); `stream` is the caller's CUDA stream.  Each
// returns the cudaError_t of its launches.
// G1's shared memory a CTA (dgi_kernels.g1_smem_bytes): the label CTA's
// layout, with the packed rows at an odd stride when staged.
size_t g1_global_smem(int n, bool staged) {
  const int w = (n + 31) / 32;
  return g1_layout(n, w, staged ? (w | 1) : 0).total;
}

// The CTAs of G1 an SM holds with `smem` bytes each, times the
// SMs: the most a cooperative launch may take.
extern "C" int g1_resident(long long smem, int* out) {
  if (smem < 0 || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(g1_global_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, g1_global_kernel,
                                                    kG1Threads, (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  *out = per_sm * sms;
  return 0;
}

// `grid` CTAs, every one resident (dgi_kernels.g1_global_plan); `bar` two
// uint32 zeros that every launch leaves as it found them; `scratch` the
// packed rows [lanes, n, w], then labels [lanes, n] and flags [lanes].
extern "C" int form_groups_global(const float* reach, long long reach_stride,
                                  const unsigned char* alive, const int* rank,
                                  int* coord, float* mask,
                                  unsigned char* is_coord, int* size,
                                  int* ngroups, int* sweeps, int* scratch,
                                  unsigned* bar, int n, int lanes, int grid,
                                  int staged, void* stream) {
  if (n <= 0 || lanes <= 0 || grid <= 0 || !bar || !scratch)
    return (int)cudaErrorInvalidValue;
  const int w = (n + 31) / 32;
  const size_t smem = g1_global_smem(n, staged != 0);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && ((uintptr_t)reach | (uintptr_t)mask) % 16 == 0 &&
                   (uintptr_t)alive % 4 == 0;
  uint32_t* bits = (uint32_t*)scratch;
  int* labels = scratch + (size_t)lanes * n * w;
  G1Args a{reach, reach_stride, alive, rank,   coord,  mask,  is_coord,
           size,  ngroups,      sweeps, bits,  labels, labels + (size_t)lanes * n,
           bar,   n,            w,      lanes, staged != 0, vec};
  cudaError_t e = cudaFuncSetAttribute(
      g1_global_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)g1_global_kernel, dim3(grid),
                                  dim3(kG1Threads), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int reach_closure(const uint32_t* base, const int* fr,
                             const int* to, const float* closed, float* out,
                             uint32_t* scratch, int* sweeps, int v, int nf,
                             int scenarios, void* stream) {
  if (v <= 0 || nf < 0 || scenarios <= 0) return (int)cudaErrorInvalidValue;
  const int w = (v + 31) / 32;
  R1Args a{base, fr, to, closed, out, scratch, sweeps, v, w, nf};
  return launch(r1_kernel, dim3(scenarios), cta_threads(v),
                r1_bytes(v, w, scratch == nullptr), (cudaStream_t)stream, a);
}

extern "C" int lb_rounds_ff(const float* ng, const float* gw0, const int* gid,
                            long long gid_stride, const float* mal,
                            long long mal_stride, const unsigned char* gate,
                            long long gate_stride, double step, float* gw_out,
                            int* migs, int* states, int* rank, float* sup,
                            float* dem, float* intr, void* scratch, int n,
                            int rounds, int fleets, int cluster,
                            void* stream) {
  return lb_launch<float, float>(ng, gw0, gid, gid_stride, mal, mal_stride,
                                 gate, gate_stride, step, gw_out, migs,
                                 states, rank, sup, dem, intr, scratch, n,
                                 rounds, fleets, cluster, stream);
}

extern "C" int lb_rounds_dd(const double* ng, const double* gw0,
                            const int* gid, long long gid_stride,
                            const float* mal, long long mal_stride,
                            const unsigned char* gate, long long gate_stride,
                            double step, double* gw_out, int* migs,
                            int* states, int* rank, float* sup, float* dem,
                            float* intr, void* scratch, int n, int rounds,
                            int fleets, int cluster, void* stream) {
  return lb_launch<double, double>(ng, gw0, gid, gid_stride, mal, mal_stride,
                                   gate, gate_stride, step, gw_out, migs,
                                   states, rank, sup, dem, intr, scratch, n,
                                   rounds, fleets, cluster, stream);
}

extern "C" int lb_rounds_df(const double* ng, const float* gw0,
                            const int* gid, long long gid_stride,
                            const float* mal, long long mal_stride,
                            const unsigned char* gate, long long gate_stride,
                            double step, float* gw_out, int* migs,
                            int* states, int* rank, float* sup, float* dem,
                            float* intr, void* scratch, int n, int rounds,
                            int fleets, int cluster, void* stream) {
  return lb_launch<double, float>(ng, gw0, gid, gid_stride, mal, mal_stride,
                                  gate, gate_stride, step, gw_out, migs,
                                  states, rank, sup, dem, intr, scratch, n,
                                  rounds, fleets, cluster, stream);
}
