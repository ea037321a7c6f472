"""Wrappers, plain versions and launch counters of the QSTS kernels.

================================  ===========================================  =====
wrapper                           replaces                                     route
================================  ===========================================  =====
:func:`agent_step` (A1)           ``freedm_tpu/scenarios/agents.py:459``        CUDA
                                  ``population_step`` (with ``ev_step``
                                  :386, ``thermostat_step`` :413,
                                  ``inverter_step`` :431, ``dr_step`` :446),
                                  vmapped over lanes at
                                  ``scenarios/engine.py:500``
:func:`qsts_bus_reduce` (Q1)      the streaming reductions of                  CUDA
                                  ``scenarios/engine.py:401``
                                  ``_build_bus_chunk`` (:430-457, with
                                  ``flow_peak`` :423)
:func:`qsts_feeder_reduce` (Q2)   the step of ``scenarios/engine.py:647``      CUDA
                                  ``_build_feeder_chunk`` after its solve
                                  (:662-684)
================================  ===========================================  =====

All three live in ``csrc/qsts.cu`` (float64), built without FMA
contraction (``build.EXTRA_FLAGS``) so each operation rounds as the
plain version's PyTorch operation does.  A wrapper given CPU tensors runs
its plain PyTorch version; given CUDA tensors it launches its kernel or
raises; any other device is refused before a library is loaded.  Each
launch counts in :data:`LAUNCHES`.

**A1.**  The agents of each kind are sorted by bus once
(:func:`agent_operands`, a stable sort: a bus's agents keep their
increasing index) and cut into tiles of :data:`TILE`; a *segment* is the
run of one bus's agents inside one tile.  One launch steps every agent
of every lane: a block a (tile, lane), a thread an agent, each segment
summed in increasing agent index by one thread, then the lane's last
block (an integer counter per lane) sums each bus's segments in tile
order and writes the solver's inputs ``p_t + (ev + th + dr)`` and ``q_t +
inv``.  No floating-point atomics: the sums are the same bits on every
run and under any chunking.  The plain version adds in the same order
(a column a tile position, then a column a segment).

**Q1/Q2.**  The lane's accumulators (violation minutes, losses, the
iteration sum) update in place, and so do per-lane partials of the
study's scalars (worst iteration count, non-converged count, voltage
envelope, peak branch power).  The engine folds those partials into the
scalars at the chunk's end with ``amin``/``amax``/integer sums, which do
not depend on order.

**Q1's launch** follows :func:`bus_reduce_plan`, a function of the bus
count alone: a CTA a lane stages every bus's rotated voltage once and
walks the branches.  The bus pass keeps one order on every plan and lane
count (:func:`bus_reduce_mirror` is that order on the host), so the
accumulators are the same bits whatever the plan and the lane count.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from freedm_tpu_torch.kernels import build
from freedm_tpu_torch.kernels.sparse_kernels import SMEM_LIMIT

Tensor = torch.Tensor

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"agent_step": 0, "qsts_bus_reduce": 0,
                            "qsts_feeder_reduce": 0}
_launch_lock = threading.Lock()

#: Agents a tile (threads a block of A1).
TILE = 256


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launches() -> Dict[str, int]:
    with _launch_lock:
        return dict(LAUNCHES)


# ---------------------------------------------------------------------------
# A1 operands: the population sorted by bus, its tiles and segments
# ---------------------------------------------------------------------------

#: Parameter rows of each kind, in the order ``csrc/qsts.cu`` reads them.
KIND_PARAMS = (
    ("ev", ("arr_h", "dep_h", "rate_pu", "cap_puh", "soc0")),
    ("th", ("amb_off_c", "tau_h", "gain_c", "set_c", "db_c", "p_pu")),
    ("inv", ("v1", "v2", "v3", "v4", "qmax_pu", "tau_h")),
    ("dr", ("p_pu", "comply", "depth")),
)

#: The per-agent state fields of each kind (the reference's
#: ``AgentState`` names).
KIND_STATE = (("ev_soc",), ("th_temp", "th_on"), ("inv_q",), ("dr_eng",))


class AgentOperands:
    """One population laid out for A1 on one device.

    Per kind ``k`` (ev, th, inv, dr): ``order[k]`` (the stable sort by
    bus), ``params[k] [rows, n_k]`` float64 in that order, ``bus[k]
    [n_k]`` int32.  Tiles of :data:`TILE` agents, kinds one after the
    other (``tile_start [5]``); segments (one bus's run in one tile) with
    ``seg_start``/``seg_end`` (agent index in its kind), ``tile_seg_ptr
    [n_tiles + 1]`` and ``bus_seg_ptr [4, n + 1]`` (each bus's segments of
    each kind, in tile order).  The plain version's tables:
    ``seg_pos[k] [tiles_k, TILE]`` (a tile position's segment, the dummy
    ``n_seg`` past the kind's end) and ``bus_table[k] [n, width]`` (a
    bus's segments, padded with the dummy)."""

    def __init__(self, pop, n_bus: int, device: torch.device):
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.n_bus = int(n_bus)
        self.device = device
        self.order: List[np.ndarray] = []
        self.params: List[Tensor] = []
        self.bus: List[Tensor] = []
        self.counts: List[int] = []
        tile_start = [0]
        seg_start, seg_end, seg_tile, seg_bus = [], [], [], []
        for field, rows in KIND_PARAMS:
            prm = getattr(pop, field)
            bus = np.asarray(prm.bus, np.int64)
            if bus.size and (bus.min() < 0 or bus.max() >= self.n_bus):
                raise ValueError(f"{field} agent sited off the {self.n_bus} "
                                 f"buses")
            order = np.argsort(bus, kind="stable")
            sb = bus[order]
            n_k = int(sb.size)
            self.order.append(order)
            self.counts.append(n_k)
            mat = np.stack([np.asarray(getattr(prm, r), np.float64)[order]
                            for r in rows]) if n_k else np.zeros((len(rows), 0))
            self.params.append(torch.as_tensor(np.ascontiguousarray(mat),
                                               device=device))
            self.bus.append(torch.as_tensor(sb.astype(np.int32),
                                            device=device))
            tiles = -(-n_k // TILE)
            t0 = tile_start[-1]
            tile_start.append(t0 + tiles)
            a = np.arange(n_k)
            head = (a % TILE == 0) | np.concatenate(
                [[True], sb[1:] != sb[:-1]])[:n_k]
            starts = a[head]
            ends = np.append(starts[1:], n_k)[:starts.size]
            seg_start.append(starts)
            seg_end.append(ends)
            seg_tile.append(t0 + starts // TILE)
            seg_bus.append(sb[starts])
        self.tile_start = tile_start
        self.n_tiles = tile_start[-1]
        if self.n_tiles == 0:
            raise ValueError("agent population is empty")
        n_per_kind = [s.size for s in seg_start]
        seg_off = np.concatenate([[0], np.cumsum(n_per_kind)])
        self.n_seg = int(seg_off[-1])
        all_tile = np.concatenate(seg_tile)
        tile_ptr = np.searchsorted(all_tile, np.arange(self.n_tiles + 1))
        bus_ptr = np.stack([
            seg_off[k] + np.searchsorted(seg_bus[k], np.arange(n_bus + 1))
            for k in range(4)])

        def idx(x):
            return torch.as_tensor(np.asarray(x, np.int32), device=device)

        self.seg_start = idx(np.concatenate(seg_start))
        self.seg_end = idx(np.concatenate(seg_end))
        self.tile_seg_ptr = idx(tile_ptr)
        self.bus_seg_ptr = idx(bus_ptr)
        # The plain version's gather tables.
        self.seg_pos: List[Tensor] = []
        self.bus_table: List[Tensor] = []
        for k in range(4):
            n_k = self.counts[k]
            tiles = tile_start[k + 1] - tile_start[k]
            pos = np.full(tiles * TILE, self.n_seg, np.int64)
            lens = seg_end[k] - seg_start[k]
            pos[:n_k] = np.repeat(seg_off[k] + np.arange(n_per_kind[k]), lens)
            self.seg_pos.append(torch.as_tensor(pos.reshape(tiles, TILE),
                                                device=device))
            cnt = np.diff(bus_ptr[k])
            width = max(int(cnt.max()) if cnt.size else 0, 1)
            table = np.full((n_bus, width), self.n_seg, np.int64)
            rows_ = np.repeat(np.arange(n_bus), cnt)
            cols = np.arange(int(cnt.sum())) - np.repeat(bus_ptr[k][:-1]
                                                         - seg_off[k], cnt)
            table[rows_, cols] = np.arange(seg_off[k], seg_off[k + 1])
            self.bus_table.append(torch.as_tensor(table, device=device))
        self._scratch: Dict[int, tuple] = {}

    def scratch(self, lanes: int):
        """A1's scratch for ``lanes`` lanes: segment sums, tile maxima, each
        kind's bus sums and the lanes' block counters (zero; the last block
        of a lane resets its counter)."""
        sc = self._scratch.get(lanes)
        if sc is None:
            dev, f64 = self.device, torch.float64
            sc = self._scratch[lanes] = (
                torch.empty(lanes, self.n_seg, dtype=f64, device=dev),
                torch.empty(lanes, self.n_tiles, dtype=f64, device=dev),
                torch.empty(lanes, 4, self.n_bus, dtype=f64, device=dev),
                torch.zeros(lanes, dtype=torch.int32, device=dev))
        return sc

    def to_sorted(self, ag, lanes: int) -> List[Tensor]:
        """The state fields (``AgentState`` or a dict of ``[S, n_k]`` or
        ``[n_k]`` arrays in the reference's order) as contiguous float64
        ``[lanes, n_k]`` tensors in bus-sorted order, in
        :data:`KIND_STATE` order."""
        get = ag.get if isinstance(ag, dict) else (lambda f: getattr(ag, f))
        out = []
        for k, fields in enumerate(KIND_STATE):
            order = torch.as_tensor(self.order[k], device=self.device)
            for f in fields:
                x = torch.as_tensor(np.asarray(get(f)), dtype=torch.float64,
                                    device=self.device)
                x = x.expand(lanes, self.counts[k]) if x.dim() == 1 else x
                out.append(x[:, order].contiguous())
        return out

    def to_reference(self, state: List[Tensor]) -> Dict[str, Tensor]:
        """Sorted state tensors back in the reference's agent order."""
        out = {}
        i = 0
        for k, fields in enumerate(KIND_STATE):
            inv = torch.as_tensor(np.argsort(self.order[k]),
                                  device=self.device)
            for f in fields:
                out[f] = state[i][:, inv]
                i += 1
        return out

    def param_views(self, k: int):
        """Kind ``k``'s parameters as the reference's record of ``[n_k]``
        rows (``bus`` left out)."""
        from freedm_tpu_torch.scenarios import agents

        cls = (agents.EvParams, agents.ThermostatParams,
               agents.InverterParams, agents.DrParams)[k]
        rows = KIND_PARAMS[k][1]
        return cls(bus=self.bus[k], **{r: self.params[k][i]
                                       for i, r in enumerate(rows)})


def agent_operands(pop, n_bus: int, device) -> AgentOperands:
    """:class:`AgentOperands` of a :class:`~freedm_tpu_torch.scenarios.
    agents.Population` over ``n_bus`` buses on ``device``."""
    return AgentOperands(pop, n_bus, torch.device(device))


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the on-card comparison's reference)
# ---------------------------------------------------------------------------


def _segment_sums(op: AgentOperands, k: int, c: Tensor, acc: Tensor) -> None:
    """Sum kind ``k``'s contributions ``c [S, n_k]`` (sorted) into its
    segments ``acc [S, n_seg + 1]``, each in increasing agent index
    from 0.0 — a column a tile position, as A1's segment threads add."""
    lanes, n_k = c.shape
    if n_k == 0:
        return
    pos = op.seg_pos[k]
    pad = torch.zeros(lanes, pos.numel(), dtype=c.dtype, device=c.device)
    pad[:, :n_k] = c
    pad = pad.view(lanes, pos.shape[0], TILE)
    for j in range(min(TILE, n_k)):
        col = pos[:, j]
        acc[:, col] = acc[:, col] + pad[:, :, j]


def _bus_sums(op: AgentOperands, k: int, seg: Tensor) -> Tensor:
    """``[S, n]``: each bus's segments of kind ``k`` added in tile order
    from 0.0 (the dummy column adds 0.0)."""
    table = op.bus_table[k]
    out = torch.zeros(seg.shape[0], op.n_bus, dtype=seg.dtype,
                      device=seg.device)
    for j in range(table.shape[1]):
        out = out + seg[:, table[:, j]]
    return out


def agent_step_plain(op: AgentOperands, state: List[Tensor],
                     obs: Optional[Tensor], sig: Tensor, h: float,
                     dt_h: float, p_t: Tensor, q_t: Tensor, p_out: Tensor,
                     q_out: Tensor, puh: Tensor, qpk: Tensor,
                     served: Tensor) -> None:
    """A1's plain version, in place like the kernel: steps ``state``
    (:data:`KIND_STATE` order, sorted, ``[S, n_k]``), writes ``p_out = p_t
    + ((0 + ev) + th) + dr`` and ``q_out = q_t + (0 + inv)`` ``[S, n]``,
    ``served [S]`` (the agent load served, pu), adds ``served · dt_h`` to
    ``puh`` and raises ``qpk`` to the lanes' largest inverter ``|q|``.
    ``obs`` is the observed ``|V| [S, n]``, ``None`` for the flat 1.0 pu
    of a replayed study."""
    from freedm_tpu_torch.scenarios import agents

    lanes = p_t.shape[0]
    dev, f64 = p_t.device, p_t.dtype
    seg = torch.zeros(lanes, op.n_seg + 1, dtype=f64, device=dev)
    ev_soc, th_temp, th_on, inv_q, dr_eng = state

    def seen(k):
        if obs is None:
            return torch.ones(lanes, op.counts[k], dtype=f64, device=dev)
        return obs[:, op.bus[k].long()]

    q_abs = None
    if op.counts[0]:
        soc, p, _ = agents.ev_step(ev_soc, seen(0), h, op.param_views(0),
                                   dt_h)
        ev_soc.copy_(soc)
        _segment_sums(op, 0, p, seg)
    if op.counts[1]:
        (temp, on), p, _ = agents.thermostat_step(
            th_temp, th_on, None, h, op.param_views(1), dt_h)
        th_temp.copy_(temp)
        th_on.copy_(on)
        _segment_sums(op, 1, p, seg)
    if op.counts[2]:
        qv, _, q = agents.inverter_step(inv_q, seen(2), h, op.param_views(2),
                                        dt_h)
        inv_q.copy_(qv)
        _segment_sums(op, 2, q, seg)
        q_abs = torch.amax(torch.abs(qv), dim=1)
    if op.counts[3]:
        eng, p, _ = agents.dr_step(dr_eng, sig[:, None], h,
                                   op.param_views(3), dt_h)
        dr_eng.copy_(eng)
        _segment_sums(op, 3, p, seg)
    ev, th, inv, dr = (_bus_sums(op, k, seg) for k in range(4))
    zero = torch.zeros_like(ev)
    p_out.copy_(p_t + (zero + ev + th + dr))
    q_out.copy_(q_t + (zero + inv))
    tot = [torch.sum(x, dim=1) for x in (ev, th, dr)]
    served.copy_(0.0 - tot[0] - tot[1] - tot[2])
    puh.copy_(puh + served * dt_h)
    if q_abs is not None:
        qpk.copy_(torch.maximum(qpk, q_abs))


class BusReduceOperands(NamedTuple):
    """Q1's branch data on one device: ``f_idx``, ``t_idx [m]`` int32 and
    the branch admittances ``y [8, m]`` float64 (``yff``, ``yft``,
    ``ytf``, ``ytt`` as re, im rows)."""

    f_idx: Tensor
    t_idx: Tensor
    y: Tensor


def bus_reduce_operands(sys_, device) -> BusReduceOperands:
    from freedm_tpu_torch.grid.bus import branch_admittances

    y = np.stack([part for pair in branch_admittances(sys_)
                  for part in pair])
    dev = torch.device(device)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    return BusReduceOperands(i32(sys_.from_bus), i32(sys_.to_bus),
                             torch.as_tensor(np.ascontiguousarray(y),
                                             device=dev))


class StepAcc(NamedTuple):
    """A chunk's per-lane accumulators on the device, ``[S]`` each,
    updated in place by Q1/Q2: ``viol`` (bus-minutes outside the band),
    ``loss`` (pu·h or kWh), ``it_sum`` (int32), and the partials of the
    study's scalars ``it_max``, ``nonconv`` (int32), ``v_lo``, ``v_hi``,
    ``peak``."""

    viol: Tensor
    loss: Tensor
    it_sum: Tensor
    it_max: Tensor
    nonconv: Tensor
    v_lo: Tensor
    v_hi: Tensor
    peak: Tensor


def _update_acc(acc: StepAcc, count: Tensor, loss: Tensor, it: Tensor,
                conv: Tensor, vmin: Tensor, vmax: Tensor, peak: Tensor,
                dt_min: float, dt_h: float) -> None:
    acc.viol.copy_(acc.viol + dt_min * count.to(acc.viol.dtype))
    acc.loss.copy_(acc.loss + loss * dt_h)
    it = it.to(torch.int32)
    acc.it_sum.copy_(acc.it_sum + it)
    acc.it_max.copy_(torch.maximum(acc.it_max, it))
    acc.nonconv.copy_(acc.nonconv + (~conv).to(torch.int32))
    # torch.minimum / maximum propagate NaN, as jnp.minimum does.
    acc.v_lo.copy_(torch.minimum(acc.v_lo, vmin))
    acc.v_hi.copy_(torch.maximum(acc.v_hi, vmax))
    acc.peak.copy_(torch.maximum(acc.peak, peak))


def qsts_bus_reduce_plain(v: Tensor, theta: Tensor, p: Tensor, it: Tensor,
                          conv: Tensor, op: BusReduceOperands, acc: StepAcc,
                          dt_min: float, dt_h: float, lo: float,
                          hi: float) -> None:
    """Q1's plain version: one solved step's ``[S, n]`` ``v``, ``theta``,
    ``p`` and ``[S]`` iterations and flags into ``acc``
    (``scenarios/engine.py:430-457`` of the reference, per lane)."""
    outside = (v < lo) | (v > hi)
    vr, vi = v * torch.cos(theta), v * torch.sin(theta)
    f, t = op.f_idx.long(), op.t_idx.long()
    fr, fi, tr, ti = vr[:, f], vi[:, f], vr[:, t], vi[:, t]
    y = op.y

    def cmul(ar, ai, br, bi):
        return ar * br - ai * bi, ar * bi + ai * br

    def flow(ar, ai, k1, k2):
        # s = a · conj(y1 · vf + y2 · vt)
        x1r, x1i = cmul(y[2 * k1], y[2 * k1 + 1], fr, fi)
        x2r, x2i = cmul(y[2 * k2], y[2 * k2 + 1], tr, ti)
        sr, si = cmul(ar, ai, x1r + x2r, -(x1i + x2i))
        return torch.sqrt(sr * sr + si * si)

    s_f = flow(fr, fi, 0, 1)
    s_t = flow(tr, ti, 2, 3)
    peak = torch.maximum(torch.amax(s_f, dim=1), torch.amax(s_t, dim=1))
    _update_acc(acc, torch.sum(outside, dim=1), torch.sum(p, dim=1), it,
                conv, torch.amin(v, dim=1), torch.amax(v, dim=1), peak,
                dt_min, dt_h)


#: Q1's bus pass (``csrc/qsts.cu`` ``kThreads``): thread t of 256 adds
#: buses t, t + 256, ... in turn, whatever the CTA's width.
BUS_THREADS = 256
_BUS_WARPS = BUS_THREADS // 32
#: Threads of Q1's CTA, a lane a CTA (``kBusThreads``).
(BUS_CTA_THREADS,) = build.constants("qsts.cu", "kBusThreads")


class BusReducePlan(NamedTuple):
    """Q1's launch: ``staged`` when every bus's rotated voltage fits a
    CTA's shared memory, ``smem`` bytes a CTA."""

    staged: bool
    smem: int


def bus_reduce_smem(n: int, staged: bool) -> int:
    """Q1's shared memory a CTA (``csrc/qsts.cu`` ``bus_reduce_smem``):
    16 bytes a bus when staged, then the fused reduction's buffer."""
    return (16 * n if staged else 0) + 36 * (BUS_CTA_THREADS // 32)


def bus_reduce_plan(n: int) -> BusReducePlan:
    """Q1's launch for ``n`` buses, never the lane count: staged while
    ``16 n`` bytes fit a CTA's shared memory (n ≤ 14,500)."""
    if n < 1:
        raise ValueError(f"bus_reduce_plan needs n >= 1, got {n}")
    staged = bus_reduce_smem(n, True) <= SMEM_LIMIT
    return BusReducePlan(staged, bus_reduce_smem(n, staged))


def bus_reduce_mirror(v: Tensor, theta: Tensor, p: Tensor, it: Tensor,
                      conv: Tensor, op: BusReduceOperands, acc: StepAcc,
                      dt_min: float, dt_h: float, lo: float,
                      hi: float) -> None:
    """Q1's kernel on the host, for tests: the arguments of
    :func:`qsts_bus_reduce_plain`, in its order.  The losses' sum is the
    bus pass's — thread t of :data:`BUS_THREADS` adds buses t, t + 256,
    ... in turn from 0.0, each warp by ``__shfl_down_sync`` (offsets 16 to
    1), the warps' sums added in warp order from 0.0."""
    lanes, n = (int(d) for d in v.shape)
    f64 = torch.float64
    part = torch.zeros(lanes, BUS_THREADS, dtype=f64, device=v.device)
    for b0 in range(0, n, BUS_THREADS):
        w = min(BUS_THREADS, n - b0)
        part[:, :w] = part[:, :w] + p[:, b0:b0 + w]
    x = part.view(lanes, _BUS_WARPS, 32)
    for o in (16, 8, 4, 2, 1):
        x = x[..., :o] + x[..., o:2 * o]
    psum = torch.zeros(lanes, dtype=f64, device=v.device)
    for w in range(_BUS_WARPS):
        psum = psum + x[:, w, 0]
    vr, vi = v * torch.cos(theta), v * torch.sin(theta)
    y = op.y
    f, t = op.f_idx.long(), op.t_idx.long()
    fr, fi, tr, ti = vr[:, f], vi[:, f], vr[:, t], vi[:, t]

    def flow(ar, ai, k1, k2):
        y1r, y1i, y2r, y2i = (y[r] for r in (2 * k1, 2 * k1 + 1, 2 * k2,
                                             2 * k2 + 1))
        x1r, x1i = y1r * fr - y1i * fi, y1r * fi + y1i * fr
        x2r, x2i = y2r * tr - y2i * ti, y2r * ti + y2i * tr
        br, bi = x1r + x2r, -(x1i + x2i)
        sr, si = ar * br - ai * bi, ar * bi + ai * br
        return torch.sqrt(sr * sr + si * si)

    if int(f.shape[0]):
        peak = torch.maximum(torch.amax(flow(fr, fi, 0, 1), dim=1),
                             torch.amax(flow(tr, ti, 2, 3), dim=1))
    else:
        peak = torch.full((lanes,), -float("inf"), dtype=f64, device=v.device)
    outside = (v < lo) | (v > hi)
    _update_acc(acc, torch.sum(outside, dim=1), psum, it, conv,
                torch.amin(v, dim=1), torch.amax(v, dim=1), peak, dt_min,
                dt_h)


class FeederReduceOperands(NamedTuple):
    """Q2's feeder data: ``root [nb]`` (1.0 on substation-fed branches),
    ``live [nn, 3]`` (1.0 where a node has the phase; the substation's
    three), float64, and the per-phase kVA base."""

    root: Tensor
    live: Tensor
    s_base: float


def feeder_reduce_operands(feeder, device) -> FeederReduceOperands:
    dev = torch.device(device)
    live = np.concatenate([np.ones((1, 3)), np.asarray(feeder.phase_mask)])
    return FeederReduceOperands(
        torch.as_tensor((np.asarray(feeder.parent) < 0).astype(np.float64),
                        device=dev),
        torch.as_tensor((live > 0).astype(np.float64), device=dev),
        float(feeder.s_base_per_phase_kva))


def qsts_feeder_reduce_plain(res, op: FeederReduceOperands, acc: StepAcc,
                             steps: int, dt_min: float, dt_h: float,
                             lo: float, hi: float) -> None:
    """Q2's plain version: ``steps`` timesteps of ladder results (``res``
    a :class:`~freedm_tpu_torch.pf.ladder.LadderResult` of ``steps · S``
    lanes, timestep-major) reduced into ``acc [S]`` step after step
    (``scenarios/engine.py:662-684`` of the reference)."""
    lanes = acc.viol.shape[0]
    live = op.live > 0
    root = op.root[:, None] > 0
    sb = op.s_base
    for t in range(steps):
        sl = slice(t * lanes, (t + 1) * lanes)
        vre, vim = res.v_node.re[sl], res.v_node.im[sl]
        ibr, ibi = res.i_branch.re[sl], res.i_branch.im[sl]
        ilr, ili = res.i_load.re[sl], res.i_load.im[sl]
        vm = torch.sqrt(vre * vre + vim * vim)
        outside = ((vm < lo) | (vm > hi)) & live
        vm_live = torch.where(live, vm, torch.ones_like(vm))
        nr, ni = vre[:, 1:], vim[:, 1:]
        # branch_power_kva: (v · conj(i)) · s_base
        br, bi = (nr * ibr + ni * ibi) * sb, (ni * ibr - nr * ibi) * sb
        peak = torch.amax(torch.sqrt(br * br + bi * bi).reshape(lanes, -1),
                          dim=1)
        zero = torch.zeros((), dtype=vre.dtype, device=vre.device)
        i_re = torch.where(root, ibr, zero).sum(dim=1)
        i_im = torch.where(root, ibi, zero).sum(dim=1)
        v0r, v0i = vre[:, 0], vim[:, 0]
        p_sub = torch.sum((v0r * i_re + v0i * i_im) * sb, dim=1)
        p_load = torch.sum(((nr * ilr + ni * ili) * sb).reshape(lanes, -1),
                           dim=1)
        _update_acc(acc, torch.sum(outside.reshape(lanes, -1), dim=1),
                    p_sub - p_load, res.iterations[sl],
                    res.converged[sl],
                    torch.amin(vm_live.reshape(lanes, -1), dim=1),
                    torch.amax(vm_live.reshape(lanes, -1), dim=1), peak,
                    dt_min, dt_h)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGS = {
    "agent_step": [_P] * 30 + [_I] * 11 + [_D] * 2 + [_P],
    "qsts_bus_reduce": [_P] * 16 + [_I] * 4 + [_D] * 4 + [_P],
    "qsts_feeder_reduce": [_P] * 18 + [_I] * 3 + [_D] * 5 + [_P],
}
_lib_lock = threading.Lock()
_fns: Dict[str, object] = {}


def _fn(name: str):
    """The C entry point ``name``; the library is built and loaded at the
    first call."""
    fn = _fns.get(name)
    if fn is None:
        with _lib_lock:
            if not _fns:
                lib = build.load("qsts")
                for base, args in _SIGS.items():
                    f = getattr(lib, base)
                    f.argtypes = args
                    f.restype = _I
                    _fns[base] = f
        fn = _fns[name]
    return fn


def _qsts_lib() -> None:
    """Build and load the kernels' library now (it happens at the first
    launch otherwise)."""
    _fn("agent_step")


def _on_card(t: Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got "
                         f"{t.device}")
    return True


def _want(dev, **tensors) -> None:
    """Device, dtype, shape and contiguity of a launch's operands."""
    for name, (t, shape, dtype) in tensors.items():
        if t.device != dev or t.dtype is not dtype:
            raise ValueError(f"{name} must be {dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {tuple(shape)} "
                             f"tensor, got {tuple(t.shape)}")


def _acc_args(dev, acc: StepAcc, lanes: int) -> list:
    f64, i32 = torch.float64, torch.int32
    _want(dev, viol=(acc.viol, (lanes,), f64), loss=(acc.loss, (lanes,), f64),
          it_sum=(acc.it_sum, (lanes,), i32),
          it_max=(acc.it_max, (lanes,), i32),
          nonconv=(acc.nonconv, (lanes,), i32),
          v_lo=(acc.v_lo, (lanes,), f64), v_hi=(acc.v_hi, (lanes,), f64),
          peak=(acc.peak, (lanes,), f64))
    return [t.data_ptr() for t in acc]


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _stream(t: Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def agent_step(op: AgentOperands, state: List[Tensor], obs: Optional[Tensor],
               sig: Tensor, h: float, dt_h: float, p_t: Tensor, q_t: Tensor,
               p_out: Tensor, q_out: Tensor, puh: Tensor, qpk: Tensor,
               served: Tensor) -> None:
    """A1: one timestep of every agent of every lane, in place (the
    arguments of :func:`agent_step_plain`), in one launch."""
    if not _on_card(p_t, "agent_step"):
        return agent_step_plain(op, state, obs, sig, h, dt_h, p_t, q_t,
                                p_out, q_out, puh, qpk, served)
    dev, f64 = p_t.device, torch.float64
    lanes, n = int(p_t.shape[0]), op.n_bus
    if op.device != dev:
        raise ValueError(f"operands on {op.device}, inputs on {dev}")
    checks = {f"state_{i}": (x, (lanes, op.counts[k]), f64)
              for i, (x, k) in enumerate(zip(state, (0, 1, 1, 2, 3)))}
    if obs is not None:
        checks["obs"] = (obs, (lanes, n), f64)
    _want(dev, sig=(sig, (lanes,), f64), p_t=(p_t, (lanes, n), f64),
          q_t=(q_t, (lanes, n), f64), p_out=(p_out, (lanes, n), f64),
          q_out=(q_out, (lanes, n), f64), puh=(puh, (lanes,), f64),
          qpk=(qpk, (lanes,), f64), served=(served, (lanes,), f64), **checks)
    if lanes < 1 or lanes > 65535:
        raise ValueError(f"agent_step takes 1-65535 lanes, got {lanes}")
    segpart, tilemax, ksum, counter = op.scratch(lanes)
    ts = op.tile_start
    with torch.cuda.device(dev):
        rc = _fn("agent_step")(
            *(p.data_ptr() for p in op.params),
            *(b.data_ptr() for b in op.bus),
            *(x.data_ptr() for x in state),
            None if obs is None else obs.data_ptr(), sig.data_ptr(),
            p_t.data_ptr(), q_t.data_ptr(), p_out.data_ptr(),
            q_out.data_ptr(), puh.data_ptr(), qpk.data_ptr(),
            served.data_ptr(), op.seg_start.data_ptr(),
            op.seg_end.data_ptr(), op.tile_seg_ptr.data_ptr(),
            op.bus_seg_ptr.data_ptr(), segpart.data_ptr(),
            tilemax.data_ptr(), ksum.data_ptr(), counter.data_ptr(),
            *op.counts, ts[1], ts[2], ts[3], ts[4], n, op.n_seg, lanes,
            float(h), float(dt_h), _stream(p_t))
    if rc != 0:
        op._scratch.pop(lanes, None)  # a counter may be left mid-count
    _raise_on(rc, "agent_step")
    _count("agent_step")


def qsts_bus_reduce(v: Tensor, theta: Tensor, p: Tensor, it: Tensor,
                    conv: Tensor, op: BusReduceOperands, acc: StepAcc,
                    dt_min: float, dt_h: float, lo: float, hi: float,
                    plan: Optional[BusReducePlan] = None) -> None:
    """Q1: one solved step into the lanes' accumulators, in one launch
    (the arguments of :func:`qsts_bus_reduce_plain`).  ``plan`` forces a
    launch (default :func:`bus_reduce_plan`); both give the same bits."""
    if not _on_card(v, "qsts_bus_reduce"):
        return qsts_bus_reduce_plain(v, theta, p, it, conv, op, acc, dt_min,
                                     dt_h, lo, hi)
    dev, f64 = v.device, torch.float64
    lanes, n = (int(d) for d in v.shape)
    m = int(op.f_idx.shape[0])
    plan = bus_reduce_plan(n) if plan is None else plan
    if bus_reduce_smem(n, plan.staged) > SMEM_LIMIT:
        raise ValueError(f"qsts_bus_reduce has no plan {plan} at n = {n}")
    _want(dev, v=(v, (lanes, n), f64), theta=(theta, (lanes, n), f64),
          p=(p, (lanes, n), f64), it=(it, (lanes,), torch.int32),
          conv=(conv, (lanes,), torch.bool),
          f_idx=(op.f_idx, (m,), torch.int32),
          t_idx=(op.t_idx, (m,), torch.int32), y=(op.y, (8, m), f64))
    args = _acc_args(dev, acc, lanes)
    with torch.cuda.device(dev):
        rc = _fn("qsts_bus_reduce")(
            v.data_ptr(), theta.data_ptr(), p.data_ptr(), it.data_ptr(),
            conv.data_ptr(), op.f_idx.data_ptr(), op.t_idx.data_ptr(),
            op.y.data_ptr(), *args, lanes, n, m, int(plan.staged),
            float(dt_min), float(dt_h), float(lo), float(hi), _stream(v))
    _raise_on(rc, "qsts_bus_reduce")
    _count("qsts_bus_reduce")


def qsts_feeder_reduce(res, op: FeederReduceOperands, acc: StepAcc,
                       steps: int, dt_min: float, dt_h: float, lo: float,
                       hi: float) -> None:
    """Q2: ``steps`` timesteps of ladder results into the lanes'
    accumulators, in step order, in one launch (the arguments of
    :func:`qsts_feeder_reduce_plain`)."""
    v = res.v_node.re
    if not _on_card(v, "qsts_feeder_reduce"):
        return qsts_feeder_reduce_plain(res, op, acc, steps, dt_min, dt_h,
                                        lo, hi)
    dev, f64 = v.device, torch.float64
    lanes = int(acc.viol.shape[0])
    nb = int(op.root.shape[0])
    b = steps * lanes
    node3, br3 = (b, nb + 1, 3), (b, nb, 3)
    _want(dev, v_re=(res.v_node.re, node3, f64),
          v_im=(res.v_node.im, node3, f64),
          ib_re=(res.i_branch.re, br3, f64), ib_im=(res.i_branch.im, br3, f64),
          il_re=(res.i_load.re, br3, f64), il_im=(res.i_load.im, br3, f64),
          it=(res.iterations, (b,), torch.int32),
          conv=(res.converged, (b,), torch.bool),
          root=(op.root, (nb,), f64), live=(op.live, (nb + 1, 3), f64))
    args = _acc_args(dev, acc, lanes)
    with torch.cuda.device(dev):
        rc = _fn("qsts_feeder_reduce")(
            res.v_node.re.data_ptr(), res.v_node.im.data_ptr(),
            res.i_branch.re.data_ptr(), res.i_branch.im.data_ptr(),
            res.i_load.re.data_ptr(), res.i_load.im.data_ptr(),
            res.iterations.data_ptr(), res.converged.data_ptr(),
            op.root.data_ptr(), op.live.data_ptr(), *args, lanes, steps, nb,
            float(op.s_base), float(dt_min), float(dt_h), float(lo),
            float(hi), _stream(v))
    _raise_on(rc, "qsts_feeder_reduce")
    _count("qsts_feeder_reduce")
