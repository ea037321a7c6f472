// QSTS kernels for Hopper (sm_90a), float64.  Built with -fmad=false
// (kernels/build.py EXTRA_FLAGS): no multiply-add is contracted, so every
// operation rounds as the plain PyTorch version's operation does.
//
// A1 agent_step — replaces freedm_tpu/scenarios/agents.py:459
//   `population_step` with its per-kind steps (`ev_step` :386,
//   `thermostat_step` :413, `inverter_step` :431, `dr_step` :446), vmapped
//   over the scenario lanes at scenarios/engine.py:500.  One timestep of
//   every agent of every lane: each agent's state update from its bus's
//   observed |V|, the hour and its lane's DR signal; the kinds' injections
//   summed per bus; the solver's inputs p_t + ((0 + ev) + th) + dr and
//   q_t + (0 + inv); the lane's served agent load and largest inverter |q|.
//
//   Design.  The host sorts each kind's agents by bus (stable) and cuts
//   them into tiles of 256; a segment is one bus's run inside one tile.  A
//   block steps one tile of one lane, a thread an agent: neighbouring
//   threads read neighbouring parameters, so every load coalesces.  Each
//   segment is then summed in increasing agent index by one thread, from
//   shared memory, into a per-lane segment array.  After a __threadfence
//   each block adds one to its lane's integer counter; the lane's last
//   block sums each bus's segments of each kind in tile order (one thread a
//   kind and bus, its loads eight ahead of its adds) and writes the
//   solver's inputs, then resets the counter.  The
//   served load is a fixed-shape tree over the buses, the |q| peak a max.
//   No floating-point atomics: the results are the same bits on every run
//   and whatever the chunking.
//
// Q1 qsts_bus_reduce — replaces the streaming reductions of
//   scenarios/engine.py:401 `_build_bus_chunk` (:430-457, with `flow_peak`
//   :423).  From a solved step's |V|, theta, realized P, iterations and
//   flag: the lane's violation minutes, losses (sum P dt) and iteration
//   sum, and the lane's partials of the study's worst iteration count,
//   non-converged count, |V| envelope and peak branch |S| over both ends.
//   The accumulators update in place (the reference donates its carry);
//   the engine folds the partials into the study's scalars at the chunk's
//   end with min / max / integer sums, which do not depend on order.
//
//   Design (qsts_kernels.bus_reduce_plan, a function of n alone: the lane
//   count never changes a lane's launch, nor its bits).  One CTA of 512
//   threads a lane rotates every bus's voltage once, v cos theta and v sin
//   theta by one sincos (the bits of cos() and sin()), into shared memory
//   (16 n bytes: 32 KB at mesh2000), the loads of a round issued before
//   their use; then walks the branches, f_idx, t_idx and y read coalesced,
//   four branches' loads in flight a thread, the ends' voltages from
//   shared memory.  Its first 256 threads also take the bus pass
//   (violations, P, the envelope) in the order every earlier form took
//   it: thread t adds buses t, t + 256, ... in turn, the warp by
//   __shfl_down_sync, the warps' sums in warp order; so the losses keep
//   their bits.  The CTA's five values go through one fused reduction
//   (one __syncthreads), and thread 0 updates the accumulators (no float
//   atomics).  Counts, the envelope and the peak (a max of values computed
//   by the same operations) do not depend on the walk's order.  Past the
//   shared memory (n > 14,500) the ends are rotated where they are read,
//   as before.  One CTA of 256 threads a lane computing 16,000 trig calls
//   (the first form) took 0.030 ms at mesh2000 x 64 by queued events on an
//   H100, 0.0136 now; 256 threads a CTA, a lane on several CTAs meeting
//   under an integer ticket, or a cluster sharing one stage through DSMEM,
//   were no faster at mesh2000 from 64 lanes (measured variants).
//
// Q2 qsts_feeder_reduce — replaces the step of scenarios/engine.py:647
//   `_build_feeder_chunk` after its solve (:662-684).  The ladder restarts
//   cold every step, so a chunk's Tc * S lanes are solved by one L1 launch;
//   Q2 then reduces each scenario's timesteps: live-phase band minutes,
//   total_loss_kw * dt (the losses summed in step order, as the reference's
//   scan adds them), iterations, and the partials of the |V| envelope (dead
//   phases read 1.0) and the peak |branch_power_kva|.
//
//   Design (qsts_kernels.feeder_reduce_plan, a function of the branch count
//   alone).  A step's partials — the band count, v_lo, v_hi, peak, the
//   load's P and the three root-phase current sums (re, im), which give
//   the substation's P — do not depend on one another across steps, so a
//   CTA of 16 warps (one scenario) computes them side by side: W warps a
//   step (1 on a feeder of up to 170 branches), its entries dealt to the
//   W * 32 threads in a fixed order, each warp reduced by shuffles alone;
//   no block barrier inside a step.  A batch of up to 32 steps' partials
//   meets in shared memory, a thread a step combines its W warps' partials
//   in warp order, and one thread folds the steps into the scenario's
//   accumulators in step order with the plain version's expressions
//   (qsts_kernels._update_acc).  A step's bits thus depend on W alone,
//   never on how many steps or scenarios a launch holds
//   (qsts_kernels.feeder_reduce_mirror is the kernel on the host).  The first form walked the steps in turn, a CTA of 256 threads
//   doing about ten block reductions (two barriers each) a step with at
//   most 27 threads busy at vvc_9bus: 0.053-0.057 ms at vvc_9bus x 24 * 64.
//
// Every block sum is a fixed tree (warp shuffles, then the warps' sums in
// warp order); min and max propagate NaN as jnp.minimum / torch.minimum do.
//
// Bounds on an H100 SXM (3.35 TB/s; 34 TFLOP/s fp64 outside the tensor
// cores), each input read once, each output written once.  A1 at the
// reference's bench_agents shape (400k EV, 300k thermostats, 150k
// inverters, 150k DR on case_ieee30): 45.2 MB of parameters and bus
// indices, 20.8 MB of state read and written a lane and step: 66 MB,
// 19.7 us at S = 1, 128 MB, 38 us at S = 4 (bytes: ~60 operations an
// agent).  Q1 at mesh2000 x 64: |V|, theta, P read (3 MB) and the branch
// tables (0.3 MB), ~1 us; ~60 operations a branch end (two complex
// products, a square root) and a sincos a bus, 15 MFLOP: bytes.  Q2 at
// vvc_9bus x 24 * 64 lanes: the ladder's outputs read once, 1.6 MB, ~0.5 us.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;  // agents a tile = threads a block of A1
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

constexpr double kEvVMin = 0.88;  // agents.py EV_V_MIN
constexpr double kEvVFull = 0.94;  // EV_V_FULL
constexpr double kAmbMean = 24.0;  // AMB_MEAN_C
constexpr double kAmbSwing = 8.0;  // AMB_SWING_C
constexpr double kAmbPeakH = 15.0;  // AMB_PEAK_H
constexpr double kDrTauH = 0.25;  // DR_TAU_H
constexpr double kTwoPi = 2.0 * 3.141592653589793;  // 2.0 * math.pi

__device__ __forceinline__ double nan_min(double a, double b) {
  return (b < a || isnan(b)) ? b : a;
}
__device__ __forceinline__ double nan_max(double a, double b) {
  return (b > a || isnan(b)) ? b : a;
}
// jnp.clip(x, 0, 1) / torch.clamp: NaN stays NaN.
__device__ __forceinline__ double clip01(double x) {
  return x < 0.0 ? 0.0 : (x > 1.0 ? 1.0 : x);
}

// Fixed-shape block reductions; the result is valid in thread 0.  `sh`
// holds kWarps values; the leading __syncthreads lets callers reuse it.
__device__ double block_sum(double x, double* sh) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFull, x, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = x;
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) t += sh[w];
  return t;
}

template <bool kMax>
__device__ double block_ext(double x, double* sh) {
  for (int o = 16; o > 0; o >>= 1) {
    double y = __shfl_down_sync(kFull, x, o);
    x = kMax ? nan_max(x, y) : nan_min(x, y);
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = x;
  __syncthreads();
  double t = sh[0];
  if (threadIdx.x == 0)
    for (int w = 1; w < kWarps; ++w) t = kMax ? nan_max(t, sh[w]) : nan_min(t, sh[w]);
  return t;
}

// ---------------------------------------------------------------------------
// A1
// ---------------------------------------------------------------------------

// seg[j] + ... + seg[e - 1] added from 0.0 in increasing j; the loads run
// eight ahead of the adds (they hit L2), the order of the adds is kept.
__device__ double chain_sum(const double* seg, int j, int e) {
  double acc = 0.0;
  for (; j + 8 <= e; j += 8) {
    double t[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) t[u] = __ldcg(seg + j + u);
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += t[u];
  }
  for (; j < e; ++j) acc += __ldcg(seg + j);
  return acc;
}

struct AgentArgs {
  const double* prm[4];  // [rows, n_k] each, bus-sorted
  const int* bus[4];     // [n_k]
  double* ev_soc;        // [S, n_ev] ...
  double* th_temp;
  double* th_on;
  double* inv_q;
  double* dr_eng;
  const double* obs;  // [S, n] or null: the flat 1.0 pu
  const double* sig;  // [S]
  const double* p_t;  // [S, n]
  const double* q_t;
  double* p_out;
  double* q_out;
  double* puh;     // [S]
  double* qpk;     // [S]
  double* served;  // [S]
  const int* seg_start;     // [n_seg], agent index in its kind
  const int* seg_end;
  const int* tile_seg_ptr;  // [n_tiles + 1]
  const int* bus_seg_ptr;   // [4, n + 1]
  double* segpart;          // [S, n_seg]
  double* tilemax;          // [S, n_tiles]
  double* ksum;             // [S, 4, n] each kind's bus sums
  int* counter;             // [S], zero between launches
  int count[4];
  int tile_start[5];
  int n, n_seg;
  double h, dt_h;
};

__global__ void __launch_bounds__(kThreads) agent_step_kernel(AgentArgs a) {
  __shared__ double c[kTile];
  __shared__ double sh[kWarps];
  __shared__ int last;
  const int g = blockIdx.x, s = blockIdx.y, tid = threadIdx.x;
  const int k = g < a.tile_start[1] ? 0 : g < a.tile_start[2] ? 1 : g < a.tile_start[3] ? 2 : 3;
  const int nk = a.count[k];
  const int base = (g - a.tile_start[k]) * kTile;
  const int i = base + tid;
  const double* P = a.prm[k];
  const double h = a.h, dt = a.dt_h;
  double contrib = 0.0;
  double qabs = -INFINITY;
  if (i < nk) {
    const size_t si = (size_t)s * nk + i;
    // The observed |V| at the agent's bus (read by the voltage-driven kinds).
    auto seen = [&]() { return a.obs ? a.obs[(size_t)s * a.n + a.bus[k][i]] : 1.0; };
    if (k == 0) {  // ev_step
      const double arr = P[i], dep = P[nk + i], rate = P[2 * nk + i];
      const double cap = P[3 * nk + i], soc0 = P[4 * nk + i];
      const double soc = a.ev_soc[si], v = seen();
      const bool present = arr <= dep ? (h >= arr && h < dep) : (h >= arr || h < dep);
      const double droop = clip01((v - kEvVMin) / (kEvVFull - kEvVMin));
      const bool charging = present && soc < 1.0;
      const double p_chg = rate * droop * (charging ? 1.0 : 0.0);
      const double soc_chg = nan_min(soc + p_chg * dt / cap, 1.0);
      a.ev_soc[si] = present ? soc_chg : soc0;
      contrib = -p_chg;
    } else if (k == 1) {  // thermostat_step
      const double amb_off = P[i], tau = P[nk + i], gain = P[2 * nk + i];
      const double set = P[3 * nk + i], db = P[4 * nk + i], pp = P[5 * nk + i];
      const double temp = a.th_temp[si], on = a.th_on[si];
      const double on_next =
          temp > set + 0.5 * db ? 1.0 : (temp < set - 0.5 * db ? 0.0 : on);
      const double amb = kAmbMean + amb_off + kAmbSwing * cos(kTwoPi * (h - kAmbPeakH) / 24.0);
      const double e = exp(-dt / tau);
      a.th_temp[si] = amb + (temp - amb) * e - gain * (1.0 - e) * on_next;
      a.th_on[si] = on_next;
      contrib = -pp * on_next;
    } else if (k == 2) {  // inverter_step
      const double v1 = P[i], v2 = P[nk + i], v3 = P[2 * nk + i];
      const double v4 = P[3 * nk + i], qmax = P[4 * nk + i], tau = P[5 * nk + i];
      const double q = a.inv_q[si], v = seen();
      const double rise = clip01((v2 - v) / (v2 - v1));
      const double fall = clip01((v - v3) / (v4 - v3));
      const double q_tgt = qmax * (rise - fall);
      const double alpha = 1.0 - exp(-dt / tau);
      const double q_next = q + alpha * (q_tgt - q);
      a.inv_q[si] = q_next;
      contrib = q_next;
      qabs = fabs(q_next);
    } else {  // dr_step
      const double pp = P[i], comply = P[nk + i], depth = P[2 * nk + i];
      const double eng = a.dr_eng[si];
      const double alpha = 1.0 - exp(-dt / kDrTauH);
      const double eng_next = eng + alpha * (a.sig[s] * comply - eng);
      a.dr_eng[si] = eng_next;
      contrib = -pp * (1.0 - depth * eng_next);
    }
  }
  c[tid] = contrib;
  const double tmax = block_ext<true>(qabs, sh);  // syncs: c is complete
  if (tid == 0) a.tilemax[(size_t)s * gridDim.x + g] = tmax;
  // This tile's segments, each by one thread in increasing agent index.
  const int j0 = a.tile_seg_ptr[g], j1 = a.tile_seg_ptr[g + 1];
  for (int j = j0 + tid; j < j1; j += kThreads) {
    const int lo = a.seg_start[j] - base, hi = a.seg_end[j] - base;
    double acc = 0.0;
    for (int t = lo; t < hi; ++t) acc += c[t];
    a.segpart[(size_t)s * a.n_seg + j] = acc;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&a.counter[s], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The lane's last block: every (kind, bus) chain of segments, in tile
  // order, one thread a chain; then every bus's injections.
  const double* seg = a.segpart + (size_t)s * a.n_seg;
  double* ks = a.ksum + (size_t)s * 4 * a.n;
  for (int t = tid; t < 4 * a.n; t += kThreads) {
    const int kk = t / a.n, b = t - kk * a.n;
    const int* ptr = a.bus_seg_ptr + kk * (a.n + 1);
    ks[t] = chain_sum(seg, ptr[b], ptr[b + 1]);
  }
  __syncthreads();
  double tot[3] = {0.0, 0.0, 0.0};  // this thread's buses: ev, th, dr
  for (int b = tid; b < a.n; b += kThreads) {
    const double ev = ks[b], th = ks[a.n + b], inv = ks[2 * a.n + b];
    const double dr = ks[3 * a.n + b];
    const size_t sb = (size_t)s * a.n + b;
    a.p_out[sb] = a.p_t[sb] + (((0.0 + ev) + th) + dr);
    a.q_out[sb] = a.q_t[sb] + (0.0 + inv);
    tot[0] += ev;
    tot[1] += th;
    tot[2] += dr;
  }
  const double ev = block_sum(tot[0], sh);
  const double th = block_sum(tot[1], sh);
  const double dr = block_sum(tot[2], sh);
  double m = -INFINITY;
  for (int t = a.tile_start[2] + tid; t < a.tile_start[3]; t += kThreads)
    m = nan_max(m, __ldcg(a.tilemax + (size_t)s * gridDim.x + t));
  m = block_ext<true>(m, sh);
  if (tid == 0) {
    const double served = ((0.0 - ev) - th) - dr;
    a.served[s] = served;
    a.puh[s] = a.puh[s] + served * a.dt_h;
    if (a.count[2] > 0) a.qpk[s] = nan_max(a.qpk[s], m);
    a.counter[s] = 0;
  }
}

// ---------------------------------------------------------------------------
// Q1 and Q2
// ---------------------------------------------------------------------------

struct Acc {
  double* viol;  // [S] bus-minutes outside the band
  double* loss;  // [S]
  int* it_sum;   // [S]
  int* it_max;   // [S] partials of the study's scalars
  int* nonconv;
  double* v_lo;
  double* v_hi;
  double* peak;
};

struct BusArgs {
  const double* v;  // [S, n]
  const double* th;
  const double* p;
  const int* it;               // [S]
  const unsigned char* conv;   // [S]
  const int* f_idx;            // [m]
  const int* t_idx;
  const double* y;  // [8, m]: yff, yft, ytf, ytt as re, im rows
  Acc acc;
  int n, m;
  double dt_min, dt_h, lo, hi;
};

// |a conj(y1 vf + y2 vt)|, in the plain version's order of operations.
__device__ __forceinline__ double flow_abs(double ar, double ai, double y1r, double y1i,
                                           double y2r, double y2i, double fr, double fi,
                                           double tr, double ti) {
  const double x1r = y1r * fr - y1i * fi, x1i = y1r * fi + y1i * fr;
  const double x2r = y2r * tr - y2i * ti, x2i = y2r * ti + y2i * tr;
  const double br = x1r + x2r, bi = -(x1i + x2i);
  const double sr = ar * br - ai * bi, si = ar * bi + ai * br;
  return sqrt(sr * sr + si * si);
}

// Q1's CTA (qsts_kernels.BUS_CTA_THREADS reads it: keep it a
// `constexpr int name = value;`): a lane a CTA.
constexpr int kBusThreads = 512;
constexpr int kBusWarps = kBusThreads / 32;

// Shared memory (qsts_kernels.bus_reduce_smem): the staged voltages (16 n
// bytes when staged: a bus's re, im together), then each warp's psum,
// vmin, vmax and peak and each warp's count.
__host__ __device__ inline size_t bus_reduce_smem(int n, bool staged) {
  return (staged ? 16 * (size_t)n : 0) + (8 * 4 + 4) * (size_t)kBusWarps;
}

// Loads a thread keeps in flight in Q1's passes (unrolled; the order of
// each thread's additions is kept).  Loading the walk's first batch
// before the stage, to overlap the two, spilled registers and was slower.
constexpr int kBusUnroll = 8;
constexpr int kWalkUnroll = 4;

// A lane a CTA.  kStaged: every bus's rotated voltage in shared memory,
// else rotated where it is read.
template <bool kStaged>
__global__ void __launch_bounds__(kBusThreads) bus_reduce_kernel(BusArgs a) {
  constexpr int kT = kBusThreads, kW = kBusWarps;
  extern __shared__ __align__(16) double2 stage[];
  const int n = a.n, m = a.m, tid = threadIdx.x, s = blockIdx.x;
  double* rd = (double*)(stage + (kStaged ? n : 0));  // [4][kW]
  int* ri = (int*)(rd + 4 * kW);
  const double* v = a.v + (size_t)s * n;
  const double* th = a.th + (size_t)s * n;
  const double* p = a.p + (size_t)s * n;
  // Thread 0 reads the lane's accumulators now (used at the end).
  double o_viol = 0.0, o_loss = 0.0, o_lo = 0.0, o_hi = 0.0, o_peak = 0.0;
  int o_sum = 0, o_max = 0, o_nc = 0, it = 0;
  bool conv = true;
  if (tid == 0) {
    o_viol = a.acc.viol[s];
    o_loss = a.acc.loss[s];
    o_sum = a.acc.it_sum[s];
    o_max = a.acc.it_max[s];
    o_nc = a.acc.nonconv[s];
    o_lo = a.acc.v_lo[s];
    o_hi = a.acc.v_hi[s];
    o_peak = a.acc.peak[s];
    it = a.it[s];
    conv = a.conv[s] != 0;
  }
  // Staging (every thread: buses tid + j kT) and the bus pass (threads
  // t < 256: buses t + j 256, in turn): each round's loads of both issued
  // before either is used.
  const bool bus_pass = tid < kThreads;
  int cnt = 0;
  double psum = 0.0, vmin = INFINITY, vmax = -INFINITY, peak = -INFINITY;
  for (int j0 = 0; (kStaged && j0 * kT < n) || (bus_pass && j0 * kThreads < n);
       j0 += kBusUnroll) {
    double vs[kBusUnroll], ts[kBusUnroll], vb[kBusUnroll], pb[kBusUnroll];
#pragma unroll
    for (int u = 0; u < kBusUnroll; ++u) {
      const int b = tid + (j0 + u) * kT, e = tid + (j0 + u) * kThreads;
      const bool sin_ = kStaged && b < n, bin = bus_pass && e < n;
      vs[u] = sin_ ? v[b] : 0.0;
      ts[u] = sin_ ? th[b] : 0.0;
      vb[u] = bin ? v[e] : 0.0;
      pb[u] = bin ? p[e] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kBusUnroll; ++u) {
      const int b = tid + (j0 + u) * kT;
      if (kStaged && b < n) {
        double sn, cs;
        sincos(ts[u], &sn, &cs);  // the bits of sin() and cos()
        stage[b] = make_double2(vs[u] * cs, vs[u] * sn);
      }
      if (bus_pass && tid + (j0 + u) * kThreads < n) {
        cnt += (vb[u] < a.lo || vb[u] > a.hi) ? 1 : 0;
        psum += pb[u];
        vmin = nan_min(vmin, vb[u]);
        vmax = nan_max(vmax, vb[u]);
      }
    }
  }
  if (kStaged) __syncthreads();
  const double* y = a.y;
  for (int k0 = tid; k0 < m; k0 += kT * kWalkUnroll) {
    int f[kWalkUnroll], t[kWalkUnroll];
    double yy[kWalkUnroll][8];
#pragma unroll
    for (int u = 0; u < kWalkUnroll; ++u) {
      const int k = k0 + u * kT;
      const bool in = k < m;
      f[u] = in ? a.f_idx[k] : 0;
      t[u] = in ? a.t_idx[k] : 0;
#pragma unroll
      for (int r = 0; r < 8; ++r) yy[u][r] = in ? y[(size_t)r * m + k] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kWalkUnroll; ++u) {
      if (k0 + u * kT >= m) continue;
      double fr, fi, tr, ti;
      if (kStaged) {
        const double2 vf = stage[f[u]], vt = stage[t[u]];
        fr = vf.x;
        fi = vf.y;
        tr = vt.x;
        ti = vt.y;
      } else {
        fr = v[f[u]] * cos(th[f[u]]);
        fi = v[f[u]] * sin(th[f[u]]);
        tr = v[t[u]] * cos(th[t[u]]);
        ti = v[t[u]] * sin(th[t[u]]);
      }
      const double sf = flow_abs(fr, fi, yy[u][0], yy[u][1], yy[u][2], yy[u][3],
                                 fr, fi, tr, ti);
      const double st = flow_abs(tr, ti, yy[u][4], yy[u][5], yy[u][6], yy[u][7],
                                 fr, fi, tr, ti);
      peak = nan_max(peak, nan_max(sf, st));
    }
  }
  // One fused block reduction: the warps by shuffles, their values in
  // shared memory, thread 0 in warp order (the losses' order of old: the
  // bus pass's eight warps).
  for (int o = 16; o > 0; o >>= 1) {
    psum += __shfl_down_sync(kFull, psum, o);
    cnt += __shfl_down_sync(kFull, cnt, o);
    vmin = nan_min(vmin, __shfl_down_sync(kFull, vmin, o));
    vmax = nan_max(vmax, __shfl_down_sync(kFull, vmax, o));
    peak = nan_max(peak, __shfl_down_sync(kFull, peak, o));
  }
  if ((tid & 31) == 0) {
    const int w = tid >> 5;
    rd[w] = psum;
    rd[kW + w] = vmin;
    rd[2 * kW + w] = vmax;
    rd[3 * kW + w] = peak;
    ri[w] = cnt;
  }
  __syncthreads();
  if (tid != 0) return;
  psum = 0.0;
  cnt = 0;
  for (int w = 0; w < kWarps; ++w) {
    psum += rd[w];
    cnt += ri[w];
  }
  vmin = rd[kW];
  vmax = rd[2 * kW];
  peak = rd[3 * kW];
  for (int w = 1; w < kW; ++w) {
    vmin = nan_min(vmin, rd[kW + w]);
    vmax = nan_max(vmax, rd[2 * kW + w]);
    peak = nan_max(peak, rd[3 * kW + w]);
  }
  // The plain version's expressions (qsts_kernels._update_acc), on the
  // values read at the start.
  a.acc.viol[s] = o_viol + a.dt_min * (double)cnt;
  a.acc.loss[s] = o_loss + psum * a.dt_h;
  a.acc.it_sum[s] = o_sum + it;
  a.acc.it_max[s] = max(o_max, it);
  a.acc.nonconv[s] = o_nc + (conv ? 0 : 1);
  a.acc.v_lo[s] = nan_min(o_lo, vmin);
  a.acc.v_hi[s] = nan_max(o_hi, vmax);
  a.acc.peak[s] = nan_max(o_peak, peak);
}

struct FeederArgs {
  const double* v_re;  // [B, nb + 1, 3], B = steps * S, timestep-major
  const double* v_im;
  const double* ib_re;  // [B, nb, 3]
  const double* ib_im;
  const double* il_re;
  const double* il_im;
  const int* it;              // [B]
  const unsigned char* conv;  // [B]
  const double* root;         // [nb]
  const double* live;         // [nb + 1, 3]
  Acc acc;
  int lanes, steps, nb, warps;
  double s_base, dt_min, dt_h, lo, hi;
};

// Q2's CTA (16 warps, one scenario), the steps whose partials meet in
// shared memory at once (a batch), and the most warps a step
// (qsts_kernels.FEEDER_MAX_WARPS reads it).
constexpr int kFeederThreads = 512;
constexpr int kFeederBatch = 32;
constexpr int kFeederMaxWarps = 8;
// A warp's partials of one step: vmin, vmax, peak, pload, ir[3], ii[3].
constexpr int kFeederParts = 10;

// A CTA of kFeederThreads a scenario; W = a.warps warps a step.  The
// inputs are read through the read-only path (__ldg), so a warp's loads of
// its steps are free to be issued ahead of its shared-memory stores.
__global__ void __launch_bounds__(kFeederThreads) feeder_reduce_kernel(FeederArgs a) {
  __shared__ double part[kFeederBatch * kFeederMaxWarps][kFeederParts];
  __shared__ int pcnt[kFeederBatch * kFeederMaxWarps];
  __shared__ double s_loss[kFeederBatch], s_lo[kFeederBatch], s_hi[kFeederBatch],
      s_peak[kFeederBatch], s_v0[kFeederBatch][6];
  __shared__ int s_cnt[kFeederBatch], s_it[kFeederBatch], s_conv[kFeederBatch];
  const int s = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = a.warps, groups = kFeederThreads / 32 / W;
  const int g = warp / W, wg = warp % W, stride = 32 * W, j0 = wg * 32 + lane;
  const int nn3 = (a.nb + 1) * 3, nb3 = a.nb * 3;
  const double sb = a.s_base;
  // Thread 0 carries the scenario's accumulators through the launch.
  double o_viol = 0.0, o_loss = 0.0, o_lo = 0.0, o_hi = 0.0, o_peak = 0.0;
  int o_sum = 0, o_max = 0, o_nc = 0;
  if (tid == 0) {
    o_viol = a.acc.viol[s];
    o_loss = a.acc.loss[s];
    o_sum = a.acc.it_sum[s];
    o_max = a.acc.it_max[s];
    o_nc = a.acc.nonconv[s];
    o_lo = a.acc.v_lo[s];
    o_hi = a.acc.v_hi[s];
    o_peak = a.acc.peak[s];
  }
  for (int t0 = 0; t0 < a.steps; t0 += kFeederBatch) {
    const int nsb = min(kFeederBatch, a.steps - t0);
    // Each group of W warps: the partials of steps t0 + g, t0 + g + groups, ...
    for (int j = g; j < nsb; j += groups) {
      const size_t ln = (size_t)(t0 + j) * a.lanes + s;
      const double* vr = a.v_re + ln * nn3;
      const double* vi = a.v_im + ln * nn3;
      const double* br = a.ib_re + ln * nb3;
      const double* bi = a.ib_im + ln * nb3;
      const double* lr = a.il_re + ln * nb3;
      const double* li = a.il_im + ln * nb3;
      // The step's iterations, flag and substation voltage (the first
      // warp's lane 0), read with the entries.
      int it = 0, cv = 0;
      double v0[6];
      if (wg == 0 && lane == 0) {
        it = __ldg(a.it + ln);
        cv = __ldg(a.conv + ln) != 0;
        for (int ph = 0; ph < 3; ++ph) {
          v0[ph] = __ldg(vr + ph);
          v0[3 + ph] = __ldg(vi + ph);
        }
      }
      int cnt = 0;
      double vmin = INFINITY, vmax = -INFINITY, peak = -INFINITY, pload = 0.0;
      double ir0 = 0.0, ir1 = 0.0, ir2 = 0.0, ii0 = 0.0, ii1 = 0.0, ii2 = 0.0;
      // Node-phase entries e < nn3; branch-phase entries e < nb3 = nn3 - 3,
      // each thread's in increasing e.
      for (int e = j0; e < nn3; e += stride) {
        const double xr = __ldg(vr + e), xi = __ldg(vi + e);
        const bool live = __ldg(a.live + e) > 0.0;
        const bool br_in = e < nb3;
        double nr = 0.0, ni = 0.0, cr = 0.0, ci = 0.0, ldr = 0.0, ldi = 0.0;
        bool root = false;
        if (br_in) {
          nr = __ldg(vr + e + 3);  // the branch's receiving node
          ni = __ldg(vi + e + 3);
          cr = __ldg(br + e);
          ci = __ldg(bi + e);
          ldr = __ldg(lr + e);
          ldi = __ldg(li + e);
          root = __ldg(a.root + e / 3) > 0.0;
        }
        const double vm = sqrt(xr * xr + xi * xi);
        cnt += (live && (vm < a.lo || vm > a.hi)) ? 1 : 0;
        const double vl = live ? vm : 1.0;
        vmin = nan_min(vmin, vl);
        vmax = nan_max(vmax, vl);
        if (br_in) {
          const double pr = (nr * cr + ni * ci) * sb, pi = (ni * cr - nr * ci) * sb;
          peak = nan_max(peak, sqrt(pr * pr + pi * pi));
          pload += (nr * ldr + ni * ldi) * sb;
          if (root) {
            const int ph = e % 3;
            if (ph == 0) {
              ir0 += cr;
              ii0 += ci;
            } else if (ph == 1) {
              ir1 += cr;
              ii1 += ci;
            } else {
              ir2 += cr;
              ii2 += ci;
            }
          }
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        cnt += __shfl_down_sync(kFull, cnt, o);
        vmin = nan_min(vmin, __shfl_down_sync(kFull, vmin, o));
        vmax = nan_max(vmax, __shfl_down_sync(kFull, vmax, o));
        peak = nan_max(peak, __shfl_down_sync(kFull, peak, o));
        pload += __shfl_down_sync(kFull, pload, o);
        ir0 += __shfl_down_sync(kFull, ir0, o);
        ir1 += __shfl_down_sync(kFull, ir1, o);
        ir2 += __shfl_down_sync(kFull, ir2, o);
        ii0 += __shfl_down_sync(kFull, ii0, o);
        ii1 += __shfl_down_sync(kFull, ii1, o);
        ii2 += __shfl_down_sync(kFull, ii2, o);
      }
      if (lane == 0) {
        double* pp = part[j * W + wg];
        pp[0] = vmin;
        pp[1] = vmax;
        pp[2] = peak;
        pp[3] = pload;
        pp[4] = ir0;
        pp[5] = ir1;
        pp[6] = ir2;
        pp[7] = ii0;
        pp[8] = ii1;
        pp[9] = ii2;
        pcnt[j * W + wg] = cnt;
        if (wg == 0) {
          s_it[j] = it;
          s_conv[j] = cv;
          for (int q = 0; q < 6; ++q) s_v0[j][q] = v0[q];
        }
      }
    }
    __syncthreads();
    // A thread a step: its W warps' partials in warp order, then its losses.
    if (tid < nsb) {
      const int j = tid;
      const double* pp = part[j * W];
      int cnt = pcnt[j * W];
      double vmin = pp[0], vmax = pp[1], peak = pp[2], pload = pp[3];
      double ir[3] = {pp[4], pp[5], pp[6]}, ii[3] = {pp[7], pp[8], pp[9]};
      for (int w = 1; w < W; ++w) {
        const double* q = part[j * W + w];
        cnt += pcnt[j * W + w];
        vmin = nan_min(vmin, q[0]);
        vmax = nan_max(vmax, q[1]);
        peak = nan_max(peak, q[2]);
        pload = pload + q[3];
        for (int ph = 0; ph < 3; ++ph) {
          ir[ph] = ir[ph] + q[4 + ph];
          ii[ph] = ii[ph] + q[7 + ph];
        }
      }
      double psub = 0.0;
      for (int ph = 0; ph < 3; ++ph)
        psub += (s_v0[j][ph] * ir[ph] + s_v0[j][3 + ph] * ii[ph]) * sb;
      s_loss[j] = psub - pload;
      s_cnt[j] = cnt;
      s_lo[j] = vmin;
      s_hi[j] = vmax;
      s_peak[j] = peak;
    }
    __syncthreads();
    if (tid == 0) {  // the fold, in step order (qsts_kernels._update_acc)
#pragma unroll 4
      for (int j = 0; j < nsb; ++j) {
        o_viol = o_viol + a.dt_min * (double)s_cnt[j];
        o_loss = o_loss + s_loss[j] * a.dt_h;
        o_sum = o_sum + s_it[j];
        o_max = max(o_max, s_it[j]);
        o_nc = o_nc + (s_conv[j] ? 0 : 1);
        o_lo = nan_min(o_lo, s_lo[j]);
        o_hi = nan_max(o_hi, s_hi[j]);
        o_peak = nan_max(o_peak, s_peak[j]);
      }
    }
    // The next batch's partials overwrite part only after every step of
    // this one was combined (the barrier above), and s_* only after the
    // fold (the next batch's barrier, which thread 0 reaches after it).
  }
  if (tid == 0) {
    a.acc.viol[s] = o_viol;
    a.acc.loss[s] = o_loss;
    a.acc.it_sum[s] = o_sum;
    a.acc.it_max[s] = o_max;
    a.acc.nonconv[s] = o_nc;
    a.acc.v_lo[s] = o_lo;
    a.acc.v_hi[s] = o_hi;
    a.acc.peak[s] = o_peak;
  }
}

}  // namespace

extern "C" int agent_step(
    const double* ev_prm, const double* th_prm, const double* inv_prm,
    const double* dr_prm, const int* ev_bus, const int* th_bus, const int* inv_bus,
    const int* dr_bus, double* ev_soc, double* th_temp, double* th_on, double* inv_q,
    double* dr_eng, const double* obs, const double* sig, const double* p_t,
    const double* q_t, double* p_out, double* q_out, double* puh, double* qpk,
    double* served, const int* seg_start, const int* seg_end, const int* tile_seg_ptr,
    const int* bus_seg_ptr, double* segpart, double* tilemax, double* ksum, int* counter,
    int n_ev,
    int n_th, int n_inv, int n_dr, int t1, int t2, int t3, int n_tiles, int n, int n_seg,
    int lanes, double h, double dt_h, void* stream) {
  if (n_tiles <= 0 || lanes <= 0 || lanes > 65535 || n <= 0)
    return (int)cudaErrorInvalidValue;
  AgentArgs a{{ev_prm, th_prm, inv_prm, dr_prm},
              {ev_bus, th_bus, inv_bus, dr_bus},
              ev_soc, th_temp, th_on, inv_q, dr_eng, obs, sig, p_t, q_t, p_out, q_out,
              puh, qpk, served, seg_start, seg_end, tile_seg_ptr, bus_seg_ptr, segpart,
              tilemax, ksum, counter, {n_ev, n_th, n_inv, n_dr}, {0, t1, t2, t3, n_tiles},
              n, n_seg, h, dt_h};
  agent_step_kernel<<<dim3((unsigned)n_tiles, (unsigned)lanes), kThreads, 0,
                      (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Q1's launch: a CTA a lane, `staged` when 16 n bytes of rotated
// voltages fit its shared memory (qsts_kernels.bus_reduce_plan).
constexpr int kBusMaxSmem = 232448;

template <bool kStaged>
int bus_reduce_launch(const BusArgs& a, int lanes, cudaStream_t stream) {
  const size_t smem = bus_reduce_smem(a.n, kStaged);
  if (smem > (size_t)kBusMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // above 48 KB a kernel has to opt in
    const cudaError_t e = cudaFuncSetAttribute(
        bus_reduce_kernel<kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bus_reduce_kernel<kStaged><<<(unsigned)lanes, kBusThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int qsts_bus_reduce(const double* v, const double* th, const double* p,
                               const int* it, const unsigned char* conv,
                               const int* f_idx, const int* t_idx, const double* y,
                               double* viol, double* loss, int* it_sum, int* it_max,
                               int* nonconv, double* v_lo, double* v_hi, double* peak,
                               int lanes, int n, int m, int staged, double dt_min,
                               double dt_h, double lo, double hi, void* stream) {
  if (lanes <= 0 || n <= 0 || m < 0) return (int)cudaErrorInvalidValue;
  BusArgs a{v, th, p, it, conv, f_idx, t_idx, y,
            Acc{viol, loss, it_sum, it_max, nonconv, v_lo, v_hi, peak},
            n, m, dt_min, dt_h, lo, hi};
  const cudaStream_t st = (cudaStream_t)stream;
  return staged ? bus_reduce_launch<true>(a, lanes, st)
                : bus_reduce_launch<false>(a, lanes, st);
}

extern "C" int qsts_feeder_reduce(const double* v_re, const double* v_im,
                                  const double* ib_re, const double* ib_im,
                                  const double* il_re, const double* il_im,
                                  const int* it, const unsigned char* conv,
                                  const double* root, const double* live, double* viol,
                                  double* loss, int* it_sum, int* it_max, int* nonconv,
                                  double* v_lo, double* v_hi, double* peak, int lanes,
                                  int steps, int nb, int warps, double s_base,
                                  double dt_min, double dt_h, double lo, double hi,
                                  void* stream) {
  if (lanes <= 0 || steps <= 0 || nb <= 0 || warps < 1 || warps > kFeederMaxWarps ||
      (warps & (warps - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  FeederArgs a{v_re, v_im, ib_re, ib_im, il_re, il_im, it, conv, root, live,
               Acc{viol, loss, it_sum, it_max, nonconv, v_lo, v_hi, peak},
               lanes, steps, nb, warps, s_base, dt_min, dt_h, lo, hi};
  feeder_reduce_kernel<<<(unsigned)lanes, kFeederThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
