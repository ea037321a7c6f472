"""Wrappers, plain versions and launch counters of the topology-sweep kernels.

============================  =============================================  =====
wrapper                       replaces                                       route
============================  =============================================  =====
:func:`topo_radiality` (T1)   ``freedm_tpu/pf/topo.py`` ``make_radiality_``   CUDA
                              ``check`` (:182, the lane body :199-235)
:func:`topo_screen` (T2)      ``freedm_tpu/pf/topo.py`` ``_screen_impl``     CUDA
                              (:455) and ``_detail_impl`` (:466):
                              ``_lane_state`` and ``_objectives``
                              (:415-452) after θ0's solve
============================  =============================================  =====

Both live in ``csrc/topo.cu``.  A wrapper given CPU tensors runs its plain
PyTorch version; given CUDA tensors it launches its kernel or raises; any
other device is refused before a library loads.  Each launch counts in
:data:`LAUNCHES` (T2's also by mode in :data:`MODE_LAUNCHES`).

A variant lane is a row of ``slots [V, r]`` (int32, ``r ≤`` :data:`MAX_RANK`):
the branches it opens, ``-1`` pads.  T1 returns ``(connected, radial)``.
Its plain version runs the reference's min-label sweeps (Jacobi, to the
fixed point or ``cap``; ``with_sweeps=True`` also returns the sweeps each
lane ran).  The kernel runs no sweeps: it is a cut test on a spanning
tree of the base graph (:func:`tree_plan`, built once per case).  A
lane's ``k ≤ r`` opened tree branches cut the tree into ``k + 1``
components, and the lane is connected iff its closed non-tree branches
join them; :func:`radiality_mirror` is that per-lane logic on the host,
for the tests.  Both give the fixed point's verdict, so the kernel
refuses a ``cap`` under ``n − 1`` (below it the reference's labels are
another function) and ``with_sweeps=True``.  T2 returns
:class:`ScreenLanes`: the rank-r Sherman–Morrison–Woodbury lane's three
objectives and islanding flag from ``zt = (B′⁻¹A)ᵀ [m, n]`` and the base
angles ``theta0 [n]`` (float64), and in mode :data:`DETAIL` the lanes'
angles ``[V, n]`` and flows ``[V, m]``.  Its launch follows
:func:`screen_plan`, a function of ``(n, m, r)`` alone, so a lane gives
the same bits at any launch width.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from freedm_tpu_torch.kernels import build
from freedm_tpu_torch.kernels.sparse_kernels import SMEM_LIMIT

Tensor = torch.Tensor

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"topo_radiality": 0, "topo_screen": 0}
#: T2's launches by mode (their sum is ``LAUNCHES["topo_screen"]``).
MODE_LAUNCHES: Dict[str, Dict[str, int]] = {
    "topo_screen": {"SCREEN": 0, "DETAIL": 0}}
_launch_lock = threading.Lock()

#: T2's modes.
SCREEN, DETAIL = 0, 1
_MODES = ("SCREEN", "DETAIL")

#: Most slots a lane (``freedm_tpu/pf/topo.py`` ``MAX_TOPO_RANK``).
MAX_RANK = 6

#: |det C| below this marks the capacitance matrix singular: the variant
#: islands the network (``freedm_tpu/pf/topo.py`` ``_ISLAND_EPS``).
ISLAND_EPS = 1e-6


def _count(name: str, mode: Optional[str] = None) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1
        if mode is not None:
            MODE_LAUNCHES[name][mode] += 1


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        for modes in MODE_LAUNCHES.values():
            for k in modes:
                modes[k] = 0


def launches() -> Dict[str, int]:
    with _launch_lock:
        return dict(LAUNCHES)


def mode_launches() -> Dict[str, Dict[str, int]]:
    with _launch_lock:
        return {k: dict(v) for k, v in MODE_LAUNCHES.items()}


class TreePlan(NamedTuple):
    """T1's plan of one bus system (:func:`tree_plan`), host numpy arrays.

    A spanning forest of the base graph (every branch closed), found
    breadth first from bus 0 and numbered in preorder.  ``cut`` is the
    per-branch table the kernel reads for each opened slot: a tree
    branch's child subtree ``(tin, tout)`` (``tin ≥ 1``), else the
    non-tree branch's two positions in ``ends`` as ``(−1 − pos_a,
    pos_b)``.  ``ends`` lists every non-tree branch once from each end, as
    ``own | other << 16`` (preorder indices), in CSR order of ``own``:
    the ends whose own bus lies in a subtree ``[a, b]`` are
    ``ends[start[a]:start[b + 1]]``."""

    connected: bool  # the base graph is one island
    tin: np.ndarray  # [n] preorder index of each bus
    tout: np.ndarray  # [n] last preorder index of the bus's subtree
    tree: np.ndarray  # [m] bool: the branch is a forest edge
    cut: np.ndarray  # [m, 2] int32
    start: np.ndarray  # [n + 1] int32 CSR offsets into ends
    ends: np.ndarray  # [2 (m - forest edges)] uint32


class TopoOperands(NamedTuple):
    """What T1 and T2 need of one bus system, on one device: the bus count,
    the branch ends ``f``, ``t [m]`` (int32), ``w = 1/x``, the series
    resistance ``r_series`` and the endpoint masks ``mask_f = th_free[f]``,
    ``mask_t = th_free[t]`` (``[m]`` float64); T1's :class:`TreePlan` on
    the host, its ``cut`` table ``[m, 2]`` and its staged words
    ``tree_words`` (``start`` then ``ends``, each padded to 16 bytes;
    int32) on the device."""

    n: int
    f: Tensor
    t: Tensor
    w: Tensor
    r_series: Tensor
    mask_f: Tensor
    mask_t: Tensor
    tree: TreePlan
    cut: Tensor
    tree_words: Tensor

    @property
    def m(self) -> int:
        return int(self.f.shape[0])


def _pad4(k: int) -> int:
    return (int(k) + 3) // 4 * 4


def tree_plan(n: int, f, t) -> TreePlan:
    """The spanning-forest plan of the graph of ``n`` buses and branches
    ``f[e]``–``t[e]``: breadth first from bus 0 (then from each bus not yet
    reached, in index order), each bus's tree branch the first that
    reached it, children in the order they were reached.  Self-loops and
    parallel branches fall out as non-tree branches."""
    n = int(n)
    f = np.asarray(f, np.int64)
    t = np.asarray(t, np.int64)
    m = int(f.shape[0])
    if n >= 1 << 16:
        raise ValueError(f"tree_plan packs preorder indices in 16 bits: "
                         f"n = {n} is too large")
    adj = [[] for _ in range(n)]
    for e in range(m):
        adj[f[e]].append((e, t[e]))
        adj[t[e]].append((e, f[e]))
    seen = np.zeros(n, bool)
    tree = np.zeros(m, bool)
    children = [[] for _ in range(n)]
    roots = []
    for s in range(n):
        if seen[s]:
            continue
        roots.append(s)
        seen[s] = True
        queue, head = [s], 0
        while head < len(queue):
            u = queue[head]
            head += 1
            for e, v in adj[u]:
                if not seen[v]:
                    seen[v] = True
                    tree[e] = True
                    children[u].append((e, v))
                    queue.append(v)
    tin = np.zeros(n, np.int64)
    tout = np.zeros(n, np.int64)
    child_edge = np.full(n, -1, np.int64)
    k = 0
    for s in roots:
        stack = [(s, 0)]
        tin[s] = k
        k += 1
        while stack:
            u, i = stack[-1]
            if i < len(children[u]):
                stack[-1] = (u, i + 1)
                e, v = children[u][i]
                child_edge[v] = e
                tin[v] = k
                k += 1
                stack.append((v, 0))
            else:
                tout[u] = k - 1
                stack.pop()
    cut = np.zeros((m, 2), np.int64)
    kids = np.nonzero(child_edge >= 0)[0]
    cut[child_edge[kids], 0] = tin[kids]
    cut[child_edge[kids], 1] = tout[kids]
    nt = np.nonzero(~tree)[0]
    own = np.stack([tin[f[nt]], tin[t[nt]]], axis=1).reshape(-1)
    other = np.stack([tin[t[nt]], tin[f[nt]]], axis=1).reshape(-1)
    order = np.argsort(own, kind="stable")
    pos = np.empty_like(order)
    pos[order] = np.arange(order.shape[0])
    cut[nt, 0] = -1 - pos[0::2]
    cut[nt, 1] = pos[1::2]
    start = np.zeros(n + 1, np.int64)
    np.add.at(start, own + 1, 1)
    return TreePlan(
        connected=len(roots) == 1, tin=tin.astype(np.int32),
        tout=tout.astype(np.int32), tree=tree, cut=cut.astype(np.int32),
        start=np.cumsum(start).astype(np.int32),
        ends=(own[order] | other[order] << 16).astype(np.uint32))


def tree_words(n: int, m: int) -> int:
    """The int32 words of T1's staged plan on a connected case of ``n``
    buses and ``m`` branches: ``start`` and the ``2 (m − n + 1)`` ends,
    each padded to 16 bytes (a function of ``(n, m)`` alone)."""
    return _pad4(n + 1) + _pad4(2 * max(m - n + 1, 0))


def tree_buffer(plan: TreePlan) -> np.ndarray:
    """The words T1 stages: ``start`` and ``ends``, each padded to 16
    bytes (int32)."""
    n = int(plan.tin.shape[0])
    words = np.zeros(_pad4(n + 1) + _pad4(plan.ends.shape[0]), np.int32)
    words[:n + 1] = plan.start
    words[_pad4(n + 1):_pad4(n + 1) + plan.ends.shape[0]] = \
        plan.ends.view(np.int32)
    return words


def radiality_mirror(slots, plan: TreePlan, n: int, m: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """T1's per-lane cut-and-reconnect logic on the host, lane by lane, as
    the kernel runs it (a plain function for the tests): ``(connected,
    radial)`` bool arrays of the ``[V, r]`` slots."""
    slots = np.asarray(slots, np.int64)
    lanes, r = slots.shape
    conn = np.zeros(lanes, bool)
    for v in range(lanes):
        row = slots[v]
        a, b, pa, pb = [], [], [], []
        for j in range(r):
            s = int(row[j])
            if not 0 <= s < m or s in row[:j]:
                continue  # pads, out-of-range slots and repeats cut nothing
            x, y = (int(c) for c in plan.cut[s])
            if x >= 0:
                a.append(x)
                b.append(y)
            else:
                pa.append(-1 - x)
                pb.append(y)
        if not plan.connected or not a:
            conn[v] = plan.connected
            continue
        k = len(a)

        def comp(x):  # the innermost cut subtree holding preorder index x
            c, best = 0, -1
            for j in range(k):
                if a[j] <= x <= b[j] and a[j] > best:
                    c, best = j + 1, a[j]
            return c

        joined = set()
        for j in range(k):
            if any(a[i] < a[j] <= b[i] for i in range(k)):
                continue  # inside another cut subtree: scanned with it
            for p in range(int(plan.start[a[j]]), int(plan.start[b[j] + 1])):
                if p in pa or p in pb:
                    continue  # an opened non-tree branch
                word = int(plan.ends[p])
                cu, cv = comp(word & 0xFFFF), comp(word >> 16)
                if cu != cv:
                    joined.add((min(cu, cv), max(cu, cv)))
        reach = {0}
        for _ in range(k):
            for lo, hi in joined:
                if lo in reach or hi in reach:
                    reach |= {lo, hi}
        conn[v] = len(reach) == k + 1
    n_open = (slots >= 0).sum(axis=1)
    return conn, conn & (m - n_open == n - 1)


#: Warps in a CTA of T1 (a warp a lane).
T1_WARPS = 16

#: Above this many buses T2's plan streams Zᵀ wide (``ScreenPlan.wide``).
WIDE_FROM = 512


class ScreenPlan(NamedTuple):
    """T2's launch of one shape (:func:`screen_plan`): ``warps`` a CTA,
    ``group`` warps a lane, whether the CTA stages the branch operands
    (``staged``; f and t packed in one word) and the endpoint masks
    (``masks``) in shared memory, the dynamic shared memory a CTA takes,
    and ``wide``: up to 16 warps a CTA (8 otherwise), and a thread streams
    8 buses' rows of Zᵀ at once up to rank 3 (4 otherwise)."""

    warps: int
    group: int
    staged: bool
    masks: bool
    smem: int
    wide: bool = False


def screen_smem(n: int, m: int, warps: int, group: int, staged: bool,
                masks: bool) -> int:
    """Bytes of T2's shared memory: the staged operands (w, rs, [mask_f,
    mask_t], θ0 as float64, f | t << 16 as one word), each lane group's
    θ_v ``[n]`` and, for groups of more than one warp, a triple a warp."""
    b = 8 * n * (warps // group)
    if staged:
        b += 8 * (2 * m + n + (2 * m if masks else 0)) + 4 * _pad4(m)
    if group > 1:
        b += 8 * 3 * warps
    return b


def screen_plan(n: int, m: int, r: int) -> ScreenPlan:
    """T2's launch for ``n`` buses, ``m`` branches and slot width ``r``,
    from the shapes alone.  Up to :data:`WIDE_FROM` buses: a warp a lane,
    8 warps a CTA, every operand staged where it fits (mesh118: 17.0 KB).
    Above it (``wide``): 16 warps a CTA, two a lane, every operand staged
    where it fits, else without the masks (read from global memory for
    the r² entries of C only; mesh2000: 224.4 KB).  Else fewer lanes a
    CTA; else the same shapes reading the operands from global memory;
    else one warp a CTA that keeps only θ_v (8 n bytes, as much as any
    shape T2 takes)."""
    if not 1 <= int(r) <= MAX_RANK:
        raise ValueError(f"slot width must be in [1, {MAX_RANK}], got {r}")
    wide = n > WIDE_FROM
    shapes = (((16, 2), (8, 2), (8, 1), (4, 1)) if wide else
              ((8, 1), (7, 1), (6, 1), (5, 1), (4, 1)))
    for staged in (True, False):
        for warps, group in shapes:
            for masks in (True, False) if staged else (False,):
                b = screen_smem(n, m, warps, group, staged, masks)
                if b <= SMEM_LIMIT:
                    return ScreenPlan(warps, group, staged, masks, b, wide)
    b = screen_smem(n, m, 1, 1, False, False)
    if b > SMEM_LIMIT:
        raise ValueError(f"topo_screen keeps a lane's n angles in shared "
                         f"memory: n = {n} is too large")
    return ScreenPlan(1, 1, False, False, b, wide)


class ScreenLanes(NamedTuple):
    """T2's outputs; ``theta`` and ``flows`` in mode DETAIL only."""

    loss: Tensor  # [V] Σ r·f², pu
    worst_flow: Tensor  # [V] max |f|, pu
    violations: Tensor  # [V] float64 count of |f| > limit
    islanded: Tensor  # [V] bool
    theta: Optional[Tensor] = None  # [V, n]
    flows: Optional[Tensor] = None  # [V, m]


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the on-card comparison's reference)
# ---------------------------------------------------------------------------


def _dropped(slots: Tensor, m: int) -> Tensor:
    """The column each slot zeroes in an ``[V, m + 1]`` table: its branch
    when active and in range, else the spare column ``m`` (the reference's
    ``.at[drop].set(..., mode="drop")``)."""
    sl = slots.long()
    return torch.where((sl >= 0) & (sl < m), sl, m)


def topo_radiality_plain(slots: Tensor, op: TopoOperands, cap: int,
                         with_sweeps: bool = False) -> Tuple[Tensor, ...]:
    """T1 as the reference computes it, vectorized over lanes: Jacobi
    sweeps of scatter-min over the closed edges and a pointer jump, each
    lane until a sweep changes nothing or ``cap`` sweeps."""
    lanes, n, m = int(slots.shape[0]), op.n, op.m
    dev = slots.device
    closed = torch.ones(lanes, m + 1, dtype=torch.bool, device=dev)
    closed.scatter_(1, _dropped(slots, m), False)
    closed = closed[:, :m]
    f = op.f.long().expand(lanes, m)
    t = op.t.long().expand(lanes, m)
    lab = torch.arange(n, device=dev).repeat(lanes, 1)
    sweeps = torch.zeros(lanes, dtype=torch.int32, device=dev)
    going = torch.ones(lanes, dtype=torch.bool, device=dev)
    for _ in range(int(cap)):
        prop = torch.where(closed, torch.minimum(lab.gather(1, f),
                                                 lab.gather(1, t)), n)
        new = lab.scatter_reduce(1, f, prop, "amin")
        new = new.scatter_reduce(1, t, prop, "amin")
        new = torch.minimum(new, new.gather(1, new))  # pointer jump
        sweeps += going.to(torch.int32)
        going &= (new != lab).any(dim=1)
        lab = new
        if not bool(going.any()):
            break
    connected = (lab == 0).all(dim=1)
    n_open = (slots >= 0).sum(dim=1)
    radial = connected & (m - n_open == n - 1)
    return (connected, radial, sweeps) if with_sweeps else (connected, radial)


def _lanes(zt: Tensor, slots: Tensor, op: TopoOperands):
    """The lanes' gathers and capacitance matrices ``C [V, r, r]`` in the
    reference's expressions (``_lane_state``, ``freedm_tpu/pf/topo.py``
    :421-433)."""
    lanes, r = int(slots.shape[0]), int(slots.shape[1])
    m = op.m
    sl = slots.long()
    active = sl >= 0
    act = active.to(zt.dtype)
    # JAX clamps an out-of-range gather index: a slot >= m reads row m - 1.
    k = torch.where(active, sl, 0).clamp(max=m - 1)
    zc = zt[k] * act[..., None]  # [V, r, n]: zc[v, j] = z[:, k_j] act_j
    wk = op.w[k] * act
    fi, ti = op.f.long()[k], op.t.long()[k]
    mf = op.mask_f[k] * act
    mt = op.mask_t[k] * act
    # a_t_z[v, i, j] = zc[v, j, f_i] mf_i - zc[v, j, t_i] mt_i
    z_f = zc.gather(2, fi[:, None, :].expand(lanes, r, r)).mT
    z_t = zc.gather(2, ti[:, None, :].expand(lanes, r, r)).mT
    a_t_z = z_f * mf[..., None] - z_t * mt[..., None]
    eye = torch.eye(r, dtype=zt.dtype, device=zt.device)
    cmat = eye - wk[..., None] * a_t_z
    return zc, wk, fi, ti, mf, mt, eye, cmat


def capacitance_det(zt: Tensor, slots: Tensor, op: TopoOperands) -> Tensor:
    """``det C [V]`` of the lanes (``torch.linalg.det``): the quantity the
    islanding flag thresholds at :data:`ISLAND_EPS`."""
    return torch.linalg.det(_lanes(zt, slots, op)[-1])


def topo_screen_plain(zt: Tensor, theta0: Tensor, slots: Tensor,
                      limit: float, op: TopoOperands, mode: int = SCREEN
                      ) -> ScreenLanes:
    """T2 in the reference's expressions, batched over lanes
    (``torch.linalg.det`` and ``torch.linalg.solve`` on the ``[V, r, r]``
    capacitance matrices)."""
    _check_mode(mode)
    lanes, m = int(slots.shape[0]), op.m
    zc, wk, fi, ti, mf, mt, eye, cmat = _lanes(zt, slots, op)
    islanded = torch.abs(torch.linalg.det(cmat)) < ISLAND_EPS
    safe = torch.where(islanded[:, None, None], eye, cmat)
    a_t_th = theta0[fi] * mf - theta0[ti] * mt
    y = torch.linalg.solve(safe, (wk * a_t_th)[..., None])
    theta = theta0 + torch.bmm(zc.mT, y)[..., 0]
    flows = (theta[:, op.f.long()] - theta[:, op.t.long()]) * op.w
    flows = torch.cat([flows, flows.new_zeros(lanes, 1)], dim=1)
    flows.scatter_(1, _dropped(slots, m), 0.0)
    flows = flows[:, :m]
    absf = torch.abs(flows)
    res = ScreenLanes(
        loss=torch.sum(op.r_series * flows * flows, dim=-1),
        worst_flow=torch.amax(absf, dim=-1),
        violations=torch.sum((absf > limit).to(zt.dtype), dim=-1),
        islanded=islanded,
    )
    if mode == DETAIL:
        res = res._replace(theta=theta, flows=flows)
    return res


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGS = {
    "topo_radiality": [_P] * 5 + [_I] * 9 + [_P],
    "topo_screen_f64": [_P] * 9 + [_D] + [_P] * 6 + [_I] * 11 + [_P],
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
                lib = build.load("topo")
                for sym, args in _SIGS.items():
                    f = getattr(lib, sym)
                    f.argtypes = args
                    f.restype = _I
                    _fns[sym] = f
        fn = _fns[name]
    return fn


def _topo_lib() -> None:
    """Build and load the kernels' library now (it happens at the first
    launch otherwise)."""
    _fn("topo_radiality")


def _check_mode(mode: int) -> None:
    if mode not in (SCREEN, DETAIL):
        raise ValueError(f"unknown topo_screen mode {mode!r}")


def _want(dev, **tensors) -> None:
    """Device, dtype, shape and contiguity of a launch's operands."""
    for name, (t, dtype, shape) in tensors.items():
        if t.device != dev or t.dtype is not dtype:
            raise ValueError(f"{name} must be {dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {tuple(shape)} "
                             f"tensor, got {tuple(t.shape)}")


def _slots_shape(slots: Tensor) -> Tuple[int, int]:
    if slots.dim() != 2 or not 1 <= int(slots.shape[1]) <= MAX_RANK:
        raise ValueError(f"slots must be [V, r] with 1 <= r <= {MAX_RANK}, "
                         f"got {tuple(slots.shape)}")
    if int(slots.shape[0]) < 1:
        raise ValueError("slots must hold at least one lane")
    return int(slots.shape[0]), int(slots.shape[1])


def _on_card(t: Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other
    device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got "
                         f"{t.device}")
    return True


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _stream(t: Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _checked_ends(op: TopoOperands, dev, floats: bool) -> None:
    m = op.m
    _want(dev, f=(op.f, torch.int32, (m,)), t=(op.t, torch.int32, (m,)))
    if floats:
        f64 = torch.float64
        _want(dev, w=(op.w, f64, (m,)), r_series=(op.r_series, f64, (m,)),
              mask_f=(op.mask_f, f64, (m,)), mask_t=(op.mask_t, f64, (m,)))


def topo_radiality(slots: Tensor, op: TopoOperands, cap: int,
                   with_sweeps: bool = False) -> Tuple[Tensor, ...]:
    """T1: ``(connected [V] bool, radial [V] bool)`` of the variant lanes
    ``slots [V, r]`` (int32).  On the CPU the plain version's sweeps, at
    most ``cap`` a lane (``with_sweeps``: also ``sweeps [V] int32``).  On
    the card the tree cut test, which gives the fixed point's verdict: it
    refuses a ``cap`` under ``n − 1`` and ``with_sweeps``."""
    if not _on_card(slots, "topo_radiality"):
        return topo_radiality_plain(slots, op, cap, with_sweeps)
    if with_sweeps:
        raise ValueError("topo_radiality runs no sweeps on the card (a "
                         "spanning-tree cut test); topo_radiality_plain "
                         "counts the reference's sweeps")
    if int(cap) < op.n - 1:
        raise ValueError(f"topo_radiality takes at least n - 1 = "
                         f"{op.n - 1} sweeps on the card, got cap = {cap}: "
                         f"its verdict is the fixed point's, and below it "
                         f"the reference's sweeps may stop at other labels")
    return radiality_launch(slots, op, T1_WARPS)


def radiality_launch(slots: Tensor, op: TopoOperands, warps: int
                     ) -> Tuple[Tensor, Tensor]:
    """T1's kernel with ``warps`` a CTA (CUDA tensors):
    :func:`topo_radiality` passes :data:`T1_WARPS`; a lab run may time
    others."""
    dev = slots.device
    lanes, r = _slots_shape(slots)
    n, m = op.n, op.m
    if (n + 2 * m) * 4 > SMEM_LIMIT:
        raise ValueError(f"topo_radiality takes n + 2m <= "
                         f"{SMEM_LIMIT // 4}: n = {n}, m = {m} is too large")
    _want(dev, slots=(slots, torch.int32, (lanes, r)),
          cut=(op.cut, torch.int32, (m, 2)))
    _checked_ends(op, dev, floats=False)
    # A disconnected base graph needs no words: every lane is disconnected.
    words = tree_words(n, m) if op.tree.connected else 0
    if words:
        _want(dev, tree_words=(op.tree_words, torch.int32, (words,)))
    connected = torch.empty(lanes, dtype=torch.bool, device=dev)
    radial = torch.empty(lanes, dtype=torch.bool, device=dev)
    # Staged where the words fit beside the CTA's 16-byte barrier.
    staged = words > 0 and words * 4 + 16 <= SMEM_LIMIT
    with torch.cuda.device(dev):
        rc = _fn("topo_radiality")(
            op.cut.data_ptr(), op.tree_words.data_ptr(), slots.data_ptr(),
            connected.data_ptr(), radial.data_ptr(), n, m, r, lanes,
            _pad4(n + 1), words, int(op.tree.connected), int(staged),
            int(warps), _stream(slots))
    _raise_on(rc, "topo_radiality")
    _count("topo_radiality")
    return connected, radial


def topo_screen(zt: Tensor, theta0: Tensor, slots: Tensor, limit: float,
                op: TopoOperands, mode: int = SCREEN) -> ScreenLanes:
    """T2: the SMW lanes of ``slots [V, r]`` (int32) from ``zt [m, n]`` and
    ``theta0 [n]`` (float64, contiguous), in mode SCREEN or DETAIL, at the
    launch :func:`screen_plan` picks for ``(n, m, r)``."""
    if not _on_card(zt, "topo_screen"):
        return topo_screen_plain(zt, theta0, slots, limit, op, mode)
    _check_mode(mode)
    r = _slots_shape(slots)[1]
    return screen_launch(zt, theta0, slots, limit, op, mode,
                         screen_plan(op.n, op.m, r))


def screen_launch(zt: Tensor, theta0: Tensor, slots: Tensor, limit: float,
                  op: TopoOperands, mode: int, plan: ScreenPlan
                  ) -> ScreenLanes:
    """T2's kernel at a given plan (CUDA tensors): :func:`topo_screen`
    passes :func:`screen_plan`'s; a lab run may time others."""
    _check_mode(mode)
    dev = zt.device
    lanes, r = _slots_shape(slots)
    n, m = op.n, op.m
    if plan.smem > SMEM_LIMIT or plan.warps % plan.group:
        raise ValueError(f"topo_screen cannot launch {plan}")
    f64 = torch.float64
    _want(dev, zt=(zt, f64, (m, n)), theta0=(theta0, f64, (n,)),
          slots=(slots, torch.int32, (lanes, r)))
    _checked_ends(op, dev, floats=True)
    out = [torch.empty(lanes, dtype=f64, device=dev) for _ in range(3)]
    isl = torch.empty(lanes, dtype=torch.bool, device=dev)
    theta = flows = None
    if mode == DETAIL:
        theta = torch.empty(lanes, n, dtype=f64, device=dev)
        flows = torch.empty(lanes, m, dtype=f64, device=dev)
    with torch.cuda.device(dev):
        rc = _fn("topo_screen_f64")(
            zt.data_ptr(), theta0.data_ptr(), op.f.data_ptr(),
            op.t.data_ptr(), op.w.data_ptr(), op.r_series.data_ptr(),
            op.mask_f.data_ptr(), op.mask_t.data_ptr(), slots.data_ptr(),
            float(limit), *(o.data_ptr() for o in out), isl.data_ptr(),
            None if theta is None else theta.data_ptr(),
            None if flows is None else flows.data_ptr(), n, m, r, lanes,
            mode, plan.warps, plan.group, int(plan.staged), int(plan.masks),
            int(plan.wide), plan.smem, _stream(zt))
    _raise_on(rc, "topo_screen")
    _count("topo_screen", _MODES[mode])
    return ScreenLanes(*out, isl, theta, flows)
