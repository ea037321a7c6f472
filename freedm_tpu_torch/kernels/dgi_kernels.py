"""Wrappers, plain versions and launch counters of the DGI kernels.

=============================  ============================================  =====
wrapper                        replaces                                      route
=============================  ============================================  =====
:func:`form_groups` (G1)       ``freedm_tpu/modules/gm.py`` ``form_groups``  CUDA
                               (:78; the label propagation :112-145)
:func:`reach_closure` (R1)     ``freedm_tpu/grid/topology.py``               CUDA
                               ``make_reachability`` (:131)
:func:`lb_rounds` (B1)         ``freedm_tpu/modules/lb.py`` ``lb_round``     CUDA
                               (:114) iterated by ``run_rounds`` (:256)
=============================  ============================================  =====

All three live in ``csrc/dgi.cu``.  A wrapper given CPU tensors runs its
plain PyTorch version; given CUDA tensors it launches its kernel or
raises; any other device is refused before a library loads.  Each call
that launches counts one in :data:`LAUNCHES`.

The three compute exact functions — integers, 0/1 matrices and sums of
±step — so a kernel and its plain version agree bit for bit, and a
kernel gives the same bits on every run (no float atomics).

- **G1** takes ``alive [B, N]`` (bool), ``reach [1 or B, N, N]`` (float32)
  and ``rank [N]`` (int32, a permutation of 1..N: the caller's
  rank-compressed priority) and returns :class:`GroupLanes`.  An edge
  ``i→j`` exists when both nodes are alive and ``reach[i, j] > 0``; each
  live node's label is the largest rank it reaches (the fixed point of
  the reference's label propagation: on a symmetric ``reach``, the
  contract, its component's), the coordinator the node of that rank.
  One cooperative launch on :func:`g1_global_plan`: the grid packs every
  lane's rows into a device scratch, one CTA a lane closes them (copied
  into its shared memory where they fit), the grid writes the mask —
  between integer grid barriers (:func:`build.grid_barrier`).
- **R1** takes :class:`ReachOperands` (the topology's packed adjacency
  and FID ends, built once by :func:`reach_operands`) and ``closed [S,
  n_fids]`` (float32, > 0 closed) and returns ``[S, V, V]`` float32 0/1.
- **B1** runs ``n_rounds`` rounds of the draft auction over ``[B, N]``
  fleets in one launch (:class:`LBLanes`); ``round_outputs=True`` (one
  round) also writes the per-node rank and the step, demand and
  in-transit vectors ``lb_round`` returns.  Its form (:func:`lb_form`)
  follows ``N``: the packed sort key below 2¹⁵ nodes, the WIDE key pair
  from there (the reference's unpacked branch) up to
  :data:`LB_MAX_NODES` — sorted on a thread-block cluster (form
  :data:`CLUSTER`, a fleet's working set in the cluster's shared memory)
  up to :func:`lb_cluster_capacity`, by one CTA in device memory above.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from freedm_tpu_torch.kernels import build
from freedm_tpu_torch.kernels.sparse_kernels import SMEM_LIMIT

Tensor = torch.Tensor

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"form_groups": 0, "reach_closure": 0,
                            "lb_rounds": 0}
_launch_lock = threading.Lock()

#: The forms of B1: the working set in a CTA's shared memory, or in
#: device memory; its WIDE form sorts a key pair (one CTA, device memory),
#: its CLUSTER form the same key pairs on a thread-block cluster.
SHARED, GLOBAL, WIDE, CLUSTER = "SHARED", "GLOBAL", "WIDE", "CLUSTER"

#: B1 packs a node's group id and index in 15 bits each of its sort key
#: below this many nodes; from it on (where the reference takes its
#: unpacked branch, ``freedm_tpu/modules/lb.py`` :178-189) the WIDE form
#: sorts (group id (30 bits) | class | key, index (32 bits)) pairs.
LB_WIDE_NODES, _LB_MAX = build.constants("dgi.cu", "kLBWideNodes",
                                         "kLBMaxNodes")
#: The most nodes B1 takes: the WIDE key's 30-bit group id.
LB_MAX_NODES = _LB_MAX
#: B1's CLUSTER form: CTAs a fleet, padded nodes a CTA holds at most,
#: threads a CTA (``csrc/dgi.cu``).
LB_CLUSTER_MAX, LB_CLUSTER_SHARE, LB_CLUSTER_THREADS = build.constants(
    "dgi.cu", "kLBClusterMax", "kLBClusterShare", "kLBClusterThreads")


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


class GroupLanes(NamedTuple):
    """G1's outputs, a leading lane axis on each."""

    coordinator: Tensor  # [B, N] int32, -1 for dead nodes
    group_mask: Tensor  # [B, N, N] float32 0/1
    is_coordinator: Tensor  # [B, N] bool
    group_size: Tensor  # [B, N] int32
    n_groups: Tensor  # [B] int32


class ReachOperands(NamedTuple):
    """What R1 needs of one topology, on one device: the vertex count, the
    ungated adjacency ``adj [V, V]`` (float32; the plain version's) and
    its rows packed 32 columns a word (``bits [V, W]`` int32; the
    kernel's), and the FID edges' ends ``fr``, ``to [n_fids]`` (int32)."""

    n: int
    adj: Tensor
    bits: Tensor
    fr: Tensor
    to: Tensor

    @property
    def n_fids(self) -> int:
        return int(self.fr.shape[0])


class LBLanes(NamedTuple):
    """B1's outputs.  ``rank`` to ``intransit`` with ``round_outputs``
    only (one round)."""

    gateway: Tensor  # [B, N] after the last round (the gateway's dtype)
    migrations: Tensor  # [B, R] int32
    states: Tensor  # [B, R, N] int32: -1 demand / 0 normal / +1 supply
    rank: Optional[Tensor] = None  # [B, N] int32 in-class rank, N if none
    supply_step: Optional[Tensor] = None  # [B, N] float32
    demand_step: Optional[Tensor] = None  # [B, N] float32
    intransit: Optional[Tensor] = None  # [B, N] float32


def _words(n: int) -> int:
    return (n + 31) // 32


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def g1_smem_bytes(n: int, stride: int = 0) -> int:
    """G1's shared memory a CTA (``csrc/dgi.cu`` ``g1_layout``): the packed
    rows, ``stride`` words apart (0: none), labels, the rank-to-node map,
    four ints a word, the group counts and a reduction buffer."""
    w = _words(n)
    off = _align16(n * stride * 4)
    off = _align16(off + 4 * n)
    off = _align16(off + 4 * (n + 1))
    off = _align16(off + 16 * w)
    off = _align16(off + 4 * (n + 1))
    return off + 128


#: G1's threads a CTA (``csrc/dgi.cu`` ``kG1Threads``).
(G1_THREADS,) = build.constants("dgi.cu", "kG1Threads")
#: G1's grid: a CTA for this many of the lanes' rows, at least one a lane,
#: at most as many as the card holds at once.
G1_ROWS_PER_CTA = 8


class G1Plan(NamedTuple):
    """G1's cooperative launch: ``grid`` CTAs of
    :data:`G1_THREADS`, ``staged`` when a lane's packed rows fit a CTA's
    shared memory (copied in for its closure), ``smem`` bytes a CTA."""

    grid: int
    staged: bool
    smem: int


def g1_stride(n: int) -> int:
    """Words between the packed rows G1 copies into a CTA's shared memory:
    odd, so a warp's rows' word k lie in 32 banks."""
    return _words(n) | 1


def g1_staged(n: int) -> bool:
    """Whether G1 copies a lane's packed rows into shared memory for its
    closure: while they fit (n ≤ 1312)."""
    return g1_smem_bytes(n, g1_stride(n)) <= SMEM_LIMIT


@functools.lru_cache(maxsize=256)
def g1_global_plan(n: int, lanes: int, resident: int) -> G1Plan:
    """G1's launch for ``lanes`` lanes of ``n`` nodes on a card
    that holds ``resident`` of its CTAs at once: a CTA for every
    :data:`G1_ROWS_PER_CTA` rows, at least one a lane, at most
    ``resident`` (every CTA resident: the grid barriers need it; a lane
    beyond takes a CTA's next turn)."""
    if n < 1 or lanes < 1 or resident < 1:
        raise ValueError(f"g1_global_plan needs n, lanes, resident >= 1, "
                         f"got {n}, {lanes}, {resident}")
    staged = g1_staged(n)
    want = max(lanes, -(-(lanes * n) // G1_ROWS_PER_CTA))
    return G1Plan(min(resident, want), staged,
                  g1_smem_bytes(n, g1_stride(n) if staged else 0))


def g1_rows(n: int, lanes: int, grid: int) -> list:
    """The rows (lane-major, ``lane · n + node``) each CTA of G1 packs and
    masks: contiguous, ``[R c / grid, R (c + 1) / grid)`` of the
    ``R = lanes · n``."""
    rows = lanes * n
    return [range(rows * c // grid, rows * (c + 1) // grid)
            for c in range(grid)]


def r1_smem_bytes(n: int, with_bits: bool) -> int:
    """R1's shared memory a CTA (``csrc/dgi.cu`` ``r1_layout``)."""
    w = _words(n)
    off = _align16(n * w * 4) if with_bits else 0
    off = _align16(off + 4 * n)
    return _align16(off + 16 * w)


def lb_pad(n: int) -> int:
    """B1's sort width: the power of two at or above ``n``, at least 32."""
    return max(32, 1 << max(0, (n - 1).bit_length()))


def lb_state_bytes(n: int, gw_size: int) -> int:
    """B1's working set a fleet (``csrc/dgi.cu`` ``lb_layout``): the sort
    keys, the WIDE form's node indices (n ≥ :data:`LB_WIDE_NODES`), the
    gateway, the segment starts and lengths."""
    npad = lb_pad(n)
    off = _align16(8 * npad)
    if n >= LB_WIDE_NODES:
        off = _align16(off + 4 * npad)
    off = _align16(off + gw_size * n)
    off = _align16(off + 4 * npad)
    return _align16(off + 4 * npad)


def lb_cluster_smem(share: int, gw_size: int) -> int:
    """B1's CLUSTER form's shared memory a CTA (``csrc/dgi.cu``
    ``lb_cluster_layout``): the reduction buffer and four slots, then
    ``share`` key words, indices, gateway values, segment starts and
    lengths."""
    start = _align16(128 + 16 + 12 * share + gw_size * share)
    return start + 8 * share


def lb_cluster_plan(n: int, gw_size: int) -> int:
    """The CTAs of the cluster that holds a fleet of ``n`` nodes in B1's
    CLUSTER form, or 0 where that form does not take it: below
    :data:`LB_WIDE_NODES` (the packed forms) or above
    :func:`lb_cluster_capacity`.  Always :data:`LB_CLUSTER_MAX` (16) CTAs,
    ``lb_pad(n) / 16`` padded nodes each: on an H100 at 2¹⁶ nodes × 1 fleet
    × 64 rounds 9.1 ms on 16 CTAs against 14.0 on 8; at 2¹⁵ × 4 fleets 5.35
    / 7.48 / 11.9 ms on 16 / 8 / 4.  A function of ``(n, gw_size)``
    alone."""
    if n < LB_WIDE_NODES:
        return 0
    share = lb_pad(n) // LB_CLUSTER_MAX
    if share > LB_CLUSTER_SHARE or \
            lb_cluster_smem(share, gw_size) > SMEM_LIMIT:
        return 0
    return LB_CLUSTER_MAX


def lb_cluster_capacity(gw_size: int) -> int:
    """The most nodes B1's CLUSTER form takes with a ``gw_size``-byte
    gateway: :data:`LB_CLUSTER_MAX` CTAs of :data:`LB_CLUSTER_SHARE`
    padded nodes (2¹⁷ in float32 and float64), 0 where a share does not
    fit a CTA's shared memory."""
    if lb_cluster_smem(LB_CLUSTER_SHARE, gw_size) > SMEM_LIMIT:
        return 0
    return LB_CLUSTER_MAX * LB_CLUSTER_SHARE


def lb_form(n: int, gw_size: int) -> str:
    """The form B1 takes, by shape alone (a route, not a fallback: a
    launch that fails raises).  From :data:`LB_WIDE_NODES` nodes the WIDE
    key pair: on a thread-block cluster (:data:`CLUSTER`) up to
    :func:`lb_cluster_capacity` nodes, above it by one CTA in device
    memory (:data:`WIDE`).  Below, the packed key: SHARED while a fleet's
    working set fits a CTA's shared memory (n ≤ 8192 in float64), else
    GLOBAL."""
    if n >= LB_WIDE_NODES:
        return CLUSTER if lb_cluster_plan(n, gw_size) else WIDE
    return SHARED if 128 + lb_state_bytes(n, gw_size) <= SMEM_LIMIT else GLOBAL


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the on-card comparison's reference)
# ---------------------------------------------------------------------------


def closure_rounds(n: int) -> int:
    """The reference's squarings of an ``n``-node adjacency
    (``make_reachability``: ``ceil(log2 n)``, at least 1)."""
    return max(1, math.ceil(math.log2(max(n, 2))))


def form_groups_plain(alive: Tensor, reach: Tensor, rank: Tensor) -> GroupLanes:
    """G1 in the reference's expressions (``freedm_tpu/modules/gm.py``
    :112-145), over lanes: ``ceil(log2 N) + 1`` rounds of label max and
    ``min(A @ A, 1)`` float32 squarings."""
    n = int(alive.shape[-1])
    f32 = torch.float32
    a = alive.to(f32)
    prio_f = rank.to(f32) * a
    adj = reach.to(f32) * a[:, :, None] * a[:, None, :]
    eye = torch.eye(n, dtype=f32, device=alive.device)
    adj = torch.maximum(adj, eye * a[:, None, :])
    one = torch.ones((), dtype=f32, device=alive.device)
    zero = torch.zeros((), dtype=f32, device=alive.device)
    rounds = closure_rounds(n) + 1
    label = prio_f
    for r in range(rounds):
        label = torch.amax(torch.where(adj > 0, label[:, None, :], zero),
                           dim=-1)
        label = torch.maximum(label, prio_f)
        if r < rounds - 1:  # the reference's last squaring feeds nothing
            adj = torch.minimum(adj @ adj, one)
    eq = (torch.abs(label[:, :, None] - prio_f[:, None, :]) < 0.5).to(f32)
    coord = torch.argmax(eq, dim=-1).to(torch.int32)
    dead = a < 0.5
    coord = torch.where(dead, -1, coord)
    same = (torch.abs(label[:, :, None] - label[:, None, :]) < 0.5).to(f32)
    group_mask = same * a[:, :, None] * a[:, None, :]
    idx = torch.arange(n, dtype=torch.int32, device=alive.device)
    is_coord = (coord == idx) & ~dead
    return GroupLanes(
        coordinator=coord,
        group_mask=group_mask,
        is_coordinator=is_coord,
        group_size=torch.sum(group_mask, dim=-1).to(torch.int32),
        n_groups=torch.sum(is_coord, dim=-1).to(torch.int32),
    )


def reach_operands(adj: np.ndarray, fid_edges: Sequence[Tuple[int, int]],
                   device: torch.device) -> ReachOperands:
    """R1's operands of a topology's ungated 0/1 adjacency and FID edges,
    built once on the host.  The adjacency must be symmetric: R1 labels
    components, which is the closure of an undirected graph only."""
    adj = np.asarray(adj, np.float32)
    n = int(adj.shape[0])
    if adj.shape != (n, n):
        raise ValueError(f"adjacency must be square, got {adj.shape}")
    edge = adj > 0
    if not np.array_equal(edge, edge.T):
        raise ValueError("the topology's adjacency must be symmetric (an "
                         "undirected graph, as parse_topology builds it)")
    w = _words(n)
    padded = np.zeros((n, w * 32), np.uint64)
    padded[:, :n] = edge
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    words = (padded.reshape(n, w, 32) * weights).sum(axis=-1)
    bits = words.astype(np.uint32).view(np.int32)
    fr = np.asarray([e[0] for e in fid_edges], np.int32)
    to = np.asarray([e[1] for e in fid_edges], np.int32)
    return ReachOperands(
        n=n,
        adj=torch.as_tensor(adj, device=device),
        bits=torch.as_tensor(np.ascontiguousarray(bits), device=device),
        fr=torch.as_tensor(fr, device=device),
        to=torch.as_tensor(to, device=device),
    )


def reach_closure_plain(op: ReachOperands, closed: Tensor) -> Tensor:
    """R1 in the reference's expressions (``make_reachability``): the FID
    gates scattered in by max both ways, ``+ I``, then ``ceil(log2 V)``
    float32 squarings ``min(R @ R, 1)``."""
    n, s = op.n, int(closed.shape[0])
    f32 = torch.float32
    adj = op.adj.to(f32).expand(s, n, n).reshape(s, n * n).clone()
    if op.n_fids:
        fr, to = op.fr.long(), op.to.long()
        c = closed.to(f32)
        adj.scatter_reduce_(1, (fr * n + to).expand(s, -1), c, "amax")
        adj.scatter_reduce_(1, (to * n + fr).expand(s, -1), c, "amax")
    one = torch.ones((), dtype=f32, device=closed.device)
    eye = torch.eye(n, dtype=f32, device=closed.device)
    reach = torch.minimum(adj.reshape(s, n, n) + eye, one)
    for _ in range(closure_rounds(n)):
        reach = torch.minimum(reach @ reach, one)
    return reach


def _lb_round_plain(ng: Tensor, gw: Tensor, gid: Tensor, step: float,
                    mal: Optional[Tensor], gate: Optional[Tensor]):
    """One round in the reference's expressions (``freedm_tpu/modules/
    lb.py`` :138-238) over ``[B, N]`` fleets; the lexicographic stable
    sort by ``(group, class, -key)`` as three stable argsorts."""
    b, n = int(gw.shape[0]), int(gw.shape[1])
    dev = gw.device
    imb = ng - gw.to(ng.dtype)
    step_t = torch.tensor(step, dtype=ng.dtype, device=dev)
    state = torch.where(imb >= step_t, 1,
                        torch.where(imb <= -step_t, -1, 0)).to(torch.int32)
    ok = (torch.ones((), dtype=torch.bool, device=dev) if gate is None
          else gate)
    mem_s = (state == 1) & ok
    mem_d = (state == -1) & ok
    key = torch.abs(imb).to(torch.float32)
    cls = torch.where(mem_s, 0, torch.where(mem_d, 1, 2))
    gid = gid.expand(b, n).long()
    p = torch.argsort(-key, dim=-1, stable=True)
    p = p.gather(-1, torch.argsort(cls.gather(-1, p), dim=-1, stable=True))
    p = p.gather(-1, torch.argsort(gid.gather(-1, p), dim=-1, stable=True))
    gid_s, cls_s = gid.gather(-1, p), cls.gather(-1, p)
    idx = torch.arange(n, device=dev).expand(b, n)
    seg = torch.ones(b, n, dtype=torch.bool, device=dev)
    seg[:, 1:] = (gid_s[:, 1:] != gid_s[:, :-1]) | (cls_s[:, 1:] != cls_s[:, :-1])
    start = torch.cummax(torch.where(seg, idx, 0), dim=-1).values
    rank_in = idx - start
    is_s, is_d = cls_s == 0, cls_s == 1
    zeros = torch.zeros(b, n, dtype=torch.int64, device=dev)
    s_cnt = zeros.scatter_add(1, gid_s, is_s.long()).gather(1, gid_s)
    d_cnt = zeros.scatter_add(1, gid_s, is_d.long()).gather(1, gid_s)
    sup_s = is_s & (rank_in < d_cnt)
    dem_s = is_d & (rank_in < s_cnt)
    f32 = torch.float32
    s32 = torch.tensor(step, dtype=f32, device=dev)
    z32 = torch.zeros((), dtype=f32, device=dev)
    mal_s = (torch.zeros(b, n, dtype=f32, device=dev) if mal is None
             else mal.expand(b, n).gather(-1, p))
    delta_s = (torch.where(sup_s, s32, z32)
               - torch.where(dem_s, s32 * (1.0 - mal_s), z32))
    delta = torch.zeros(b, n, dtype=f32, device=dev).scatter(1, p, delta_s)
    gw_new = gw + delta
    unsorted = lambda v: torch.zeros_like(v).scatter(1, p, v)  # noqa: E731
    rank = unsorted(torch.where(cls_s < 2, rank_in, n)).to(torch.int32)
    sup_m, dem_m = unsorted(sup_s), unsorted(dem_s)
    supply = sup_m.to(f32) * s32
    accepted = dem_m.to(f32) * s32
    applied = accepted if mal is None else accepted * (1.0 - mal.expand(b, n))
    return (state, gw_new, sup_s.sum(-1).to(torch.int32), rank, supply,
            -applied, applied - accepted)


def lb_rounds_plain(net_generation: Tensor, gateway: Tensor, gid: Tensor,
                    migration_step: float, n_rounds: int,
                    malicious: Optional[Tensor] = None,
                    gate: Optional[Tensor] = None,
                    round_outputs: bool = False) -> LBLanes:
    """B1 as the reference iterates it: ``n_rounds`` plain rounds, the
    gateway carried (``run_rounds``, ``lax.scan``)."""
    ng, gw = _lb_inputs(net_generation, gateway)
    states, migs = [], []
    out = None
    for _ in range(int(n_rounds)):
        out = _lb_round_plain(ng, gw, gid, migration_step, malicious, gate)
        states.append(out[0])
        migs.append(out[2])
        gw = out[1]
    b, n = int(gw.shape[0]), int(gw.shape[1])
    res = LBLanes(
        gateway=gw,
        migrations=(torch.stack(migs, dim=1) if migs else
                    torch.zeros(b, 0, dtype=torch.int32, device=gw.device)),
        states=(torch.stack(states, dim=1) if states else
                torch.zeros(b, 0, n, dtype=torch.int32, device=gw.device)),
    )
    if round_outputs:
        _check_round_outputs(n_rounds)
        res = res._replace(rank=out[3], supply_step=out[4],
                           demand_step=out[5], intransit=out[6])
    return res


def _check_round_outputs(n_rounds: int) -> None:
    if int(n_rounds) != 1:
        raise ValueError("round_outputs needs exactly one round")


def _lb_inputs(net_generation: Tensor, gateway: Tensor) -> Tuple[Tensor, Tensor]:
    """Net generation in the imbalance's dtype (the two inputs' promotion,
    as the reference's ``net_generation - gateway``), the gateway in its
    own: float32 or float64 each."""
    for name, t in (("net_generation", net_generation), ("gateway", gateway)):
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name} must be float32 or float64, got "
                            f"{t.dtype}")
    imb_dtype = torch.promote_types(net_generation.dtype, gateway.dtype)
    return net_generation.to(imb_dtype), gateway


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
_LB_SIG = [_P, _P, _P, _L, _P, _L, _P, _L, _D] + [_P] * 8 + [_I] * 4 + [_P]
_SIGS = {
    "form_groups_global": [_P, _L, _P, _P] + [_P] * 8 + [_I] * 4 + [_P],
    "g1_resident": [ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)],
    "reach_closure": [_P] * 7 + [_I] * 3 + [_P],
    "lb_rounds_ff": _LB_SIG,
    "lb_rounds_dd": _LB_SIG,
    "lb_rounds_df": _LB_SIG,
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
                lib = build.load("dgi")
                for sym, args in _SIGS.items():
                    f = getattr(lib, sym)
                    f.argtypes = args
                    f.restype = _I
                    _fns[sym] = f
        fn = _fns[name]
    return fn


def _dgi_lib() -> None:
    """Build and load the kernels' library now (it happens at the first
    launch otherwise)."""
    _fn("lb_rounds_ff")


def _on_card(t: Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other
    device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got "
                         f"{t.device}")
    return True


def _want(dev, **tensors) -> None:
    """Device, dtype, shape and contiguity of a launch's operands."""
    for name, (t, dtype, shape) in tensors.items():
        if t.device != dev or t.dtype is not dtype:
            raise ValueError(f"{name} must be {dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {tuple(shape)} "
                             f"tensor, got {tuple(t.shape)}")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _stream(t: Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


#: G1's resident CTAs by (device, shared memory a CTA).
_resident: Dict[Tuple[int, int], int] = {}


def g1_resident(device: torch.device, smem: int) -> int:
    """The CTAs of G1 ``device`` holds at once with ``smem`` bytes
    of shared memory each (the occupancy API, asked once)."""
    key = (device.index, smem)
    held = _resident.get(key)
    if held is None:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            _raise_on(_fn("g1_resident")(smem, ctypes.byref(out)),
                      "form_groups")
        held = _resident[key] = int(out.value)
    return held


def form_groups(alive: Tensor, reach: Tensor, rank: Tensor,
                sweeps: Optional[Tensor] = None) -> GroupLanes:
    """G1: groups and coordinators of ``B`` lanes, ``alive [B, N]``
    (bool), ``reach [1 or B, N, N]`` (float32), ``rank [N]`` (int32, a
    permutation of 1..N).  On the card an int32 ``sweeps [B]`` receives
    a diagnostic a lane: the hooking rounds of its components (a symmetric
    reach, the contract), or minus the label sweeps of the directed
    closure (any other; the last round or sweep changed nothing)."""
    if not _on_card(alive, "form_groups"):
        return form_groups_plain(alive, reach, rank)
    dev = alive.device
    if alive.dim() != 2 or reach.dim() != 3:
        raise ValueError(f"alive must be [B, N] and reach [1 or B, N, N], "
                         f"got {tuple(alive.shape)} and "
                         f"{tuple(reach.shape)}")
    lanes, n = int(alive.shape[0]), int(alive.shape[1])
    if lanes < 1 or n < 1:
        raise ValueError("form_groups needs at least one lane and one node")
    if int(reach.shape[0]) not in (1, lanes):
        raise ValueError(f"reach must hold 1 or {lanes} lanes, got "
                         f"{int(reach.shape[0])}")
    if g1_smem_bytes(n) > SMEM_LIMIT:
        raise ValueError(f"form_groups keeps a lane's labels in shared "
                         f"memory: n = {n} is too large")
    _want(dev, alive=(alive, torch.bool, (lanes, n)),
          reach=(reach, torch.float32, (int(reach.shape[0]), n, n)),
          rank=(rank, torch.int32, (n,)))
    if sweeps is not None:
        _want(dev, sweeps=(sweeps, torch.int32, (lanes,)))
    stride = 0 if int(reach.shape[0]) == 1 else n * n
    coord = torch.empty(lanes, n, dtype=torch.int32, device=dev)
    mask = torch.empty(lanes, n, n, dtype=torch.float32, device=dev)
    is_coord = torch.empty(lanes, n, dtype=torch.bool, device=dev)
    size = torch.empty(lanes, n, dtype=torch.int32, device=dev)
    n_groups = torch.empty(lanes, dtype=torch.int32, device=dev)
    stream = _stream(alive)
    with torch.cuda.device(dev):
        plan = g1_global_plan(n, lanes, g1_resident(
            dev, g1_global_plan(n, lanes, 1).smem))
        scratch = torch.empty(lanes * (n * _words(n) + n + 1),
                              dtype=torch.int32, device=dev)
        rc = _fn("form_groups_global")(
            reach.data_ptr(), stride, alive.data_ptr(), rank.data_ptr(),
            coord.data_ptr(), mask.data_ptr(), is_coord.data_ptr(),
            size.data_ptr(), n_groups.data_ptr(), _ptr(sweeps),
            scratch.data_ptr(), build.grid_barrier(dev, stream).data_ptr(),
            n, lanes, plan.grid, int(plan.staged), stream)
    _raise_on(rc, "form_groups")
    _count("form_groups")
    return GroupLanes(coord, mask, is_coord, size, n_groups)


def reach_closure(op: ReachOperands, closed: Tensor,
                  sweeps: Optional[Tensor] = None) -> Tensor:
    """R1: the FID-gated closure ``[S, V, V]`` (float32 0/1) of ``closed
    [S, n_fids]`` (float32) scenarios, one CTA a scenario.  On the card an
    int32 ``sweeps [S]`` receives each scenario's hooking rounds."""
    if not _on_card(closed, "reach_closure"):
        return reach_closure_plain(op, closed)
    dev = closed.device
    n, nf = op.n, op.n_fids
    if closed.dim() != 2 or int(closed.shape[0]) < 1:
        raise ValueError(f"closed must be [S, n_fids] with S >= 1, got "
                         f"{tuple(closed.shape)}")
    s = int(closed.shape[0])
    if r1_smem_bytes(n, False) > SMEM_LIMIT:
        raise ValueError(f"reach_closure keeps a scenario's labels in shared "
                         f"memory: V = {n} is too large")
    _want(dev, closed=(closed, torch.float32, (s, nf)),
          bits=(op.bits, torch.int32, (n, _words(n))),
          fr=(op.fr, torch.int32, (nf,)), to=(op.to, torch.int32, (nf,)))
    if sweeps is not None:
        _want(dev, sweeps=(sweeps, torch.int32, (s,)))
    out = torch.empty(s, n, n, dtype=torch.float32, device=dev)
    scratch = None
    if r1_smem_bytes(n, True) > SMEM_LIMIT:
        scratch = torch.empty(s, n, _words(n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _fn("reach_closure")(
            op.bits.data_ptr(), op.fr.data_ptr(), op.to.data_ptr(),
            closed.data_ptr(), out.data_ptr(), _ptr(scratch), _ptr(sweeps),
            n, nf, s, _stream(closed))
    _raise_on(rc, "reach_closure")
    _count("reach_closure")
    return out


_LB_SUFFIX = {(torch.float32, torch.float32): "ff",
              (torch.float64, torch.float64): "dd",
              (torch.float64, torch.float32): "df"}


def _lanes_of(t: Optional[Tensor], lanes: int, n: int, dtype, dev, name):
    """A per-node operand shared by every fleet (``[N]`` or ``[1, N]``:
    stride 0) or one a fleet (``[B, N]``), contiguous; its lane stride."""
    if t is None:
        return None, 0
    if t.dim() == 1:
        t = t[None]
    if t.dim() != 2 or int(t.shape[0]) not in (1, lanes):
        raise ValueError(f"{name} must be [N], [1, N] or [B, N], got "
                         f"{tuple(t.shape)}")
    _want(dev, **{name: (t, dtype, tuple(t.shape))})
    if int(t.shape[1]) != n:
        raise ValueError(f"{name} must hold {n} nodes, got {int(t.shape[1])}")
    return t, (0 if int(t.shape[0]) == 1 else n)


def lb_rounds(net_generation: Tensor, gateway: Tensor, gid: Tensor,
              migration_step: float, n_rounds: int,
              malicious: Optional[Tensor] = None,
              gate: Optional[Tensor] = None,
              round_outputs: bool = False) -> LBLanes:
    """B1: ``n_rounds`` LB rounds of ``B`` fleets in one launch, one CTA
    (a cluster in form :data:`CLUSTER`) a fleet.  ``net_generation``,
    ``gateway [B, N]`` (float32 or float64 each), ``gid`` the fleets'
    group ids (:func:`~freedm_tpu_torch.modules.lb.group_ids`; int32
    ``[N]`` shared or ``[B, N]``), ``malicious`` (float32) and ``gate``
    (bool) likewise, or None."""
    if not _on_card(gateway, "lb_rounds"):
        return lb_rounds_plain(net_generation, gateway, gid, migration_step,
                               n_rounds, malicious, gate, round_outputs)
    if round_outputs:
        _check_round_outputs(n_rounds)
    dev = gateway.device
    ng, gw = _lb_inputs(net_generation, gateway)
    if gw.dim() != 2:
        raise ValueError(f"gateway must be [B, N], got {tuple(gw.shape)}")
    lanes, n = int(gw.shape[0]), int(gw.shape[1])
    rounds = int(n_rounds)
    if lanes < 1 or n < 1 or rounds < 0:
        raise ValueError("lb_rounds needs a fleet, a node and rounds >= 0")
    if n > LB_MAX_NODES:
        raise ValueError(f"lb_rounds takes at most {LB_MAX_NODES} nodes (a "
                         f"30-bit group id), got {n}")
    _want(dev, net_generation=(ng, ng.dtype, (lanes, n)),
          gateway=(gw, gw.dtype, (lanes, n)))
    gid, gid_stride = _lanes_of(gid, lanes, n, torch.int32, dev, "gid")
    mal, mal_stride = _lanes_of(malicious, lanes, n, torch.float32, dev,
                                "malicious")
    gate, gate_stride = _lanes_of(gate, lanes, n, torch.bool, dev, "gate")
    out_gw = torch.empty_like(gw)
    migs = torch.empty(lanes, rounds, dtype=torch.int32, device=dev)
    states = torch.empty(lanes, rounds, n, dtype=torch.int32, device=dev)
    extra = [None] * 4
    if round_outputs:
        extra = [torch.empty(lanes, n, dtype=torch.int32, device=dev)] + [
            torch.empty(lanes, n, dtype=torch.float32, device=dev)
            for _ in range(3)]
    if rounds == 0:
        out_gw.copy_(gw)
        return LBLanes(out_gw, migs, states)
    form = lb_form(n, gw.element_size())
    cluster = lb_cluster_plan(n, gw.element_size()) if form == CLUSTER else 0
    scratch = None
    if form in (GLOBAL, WIDE):
        scratch = torch.empty(lanes, lb_state_bytes(n, gw.element_size()),
                              dtype=torch.uint8, device=dev)
    suffix = _LB_SUFFIX[(ng.dtype, gw.dtype)]
    with torch.cuda.device(dev):
        rc = _fn("lb_rounds_" + suffix)(
            ng.data_ptr(), gw.data_ptr(), gid.data_ptr(), gid_stride,
            _ptr(mal), mal_stride, _ptr(gate), gate_stride,
            float(migration_step), out_gw.data_ptr(), migs.data_ptr(),
            states.data_ptr(), *(_ptr(t) for t in extra), _ptr(scratch),
            n, rounds, lanes, cluster, _stream(gw))
    _raise_on(rc, "lb_rounds")
    _count("lb_rounds")
    return LBLanes(out_gw, migs, states, *extra)
