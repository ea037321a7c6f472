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
the branches it opens, ``-1`` pads.  T1 returns ``(connected, radial)``:
the min-label connected-components verdict over the closed branches, and
with ``with_sweeps=True`` also the sweeps each lane ran (the last changed
nothing), a diagnostic.  The kernel's asynchronous sweeps and the plain
version's Jacobi sweeps reach the same fixed point within ``n − 1``
sweeps, so the booleans are equal and the same on every run; below the
fixed point the two orders can stop at different labels, so the kernel
refuses a ``cap`` under ``n − 1``.  The kernel's sweep count depends on
its threads' timing and may differ from run to run.  T2 returns
:class:`ScreenLanes`: the rank-r Sherman–Morrison–Woodbury lane's three
objectives and islanding flag from ``zt = (B′⁻¹A)ᵀ [m, n]`` and the base
angles ``theta0 [n]`` (float64), and in mode :data:`DETAIL` the lanes'
angles ``[V, n]`` and flows ``[V, m]``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from freedm_tpu_torch.kernels import build
# T1 keeps (n + 2m) int32 words of a lane in shared memory, T2 n float64.
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


class TopoOperands(NamedTuple):
    """What T1 and T2 need of one bus system, on one device: the bus count,
    the branch ends ``f``, ``t [m]`` (int32), ``w = 1/x``, the series
    resistance ``r_series`` and the endpoint masks ``mask_f = th_free[f]``,
    ``mask_t = th_free[t]`` (``[m]`` float64)."""

    n: int
    f: Tensor
    t: Tensor
    w: Tensor
    r_series: Tensor
    mask_f: Tensor
    mask_t: Tensor

    @property
    def m(self) -> int:
        return int(self.f.shape[0])


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
    "topo_radiality": [_P] * 6 + [_I] * 5 + [_P],
    "topo_screen_f64": [_P] * 9 + [_D] + [_P] * 6 + [_I] * 5 + [_P],
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
    ``slots [V, r]`` (int32), at most ``cap`` sweeps a lane; with
    ``with_sweeps`` also ``sweeps [V] int32``.  On the card ``cap`` must
    be at least ``n − 1``, where every lane has reached the fixed point."""
    if not _on_card(slots, "topo_radiality"):
        return topo_radiality_plain(slots, op, cap, with_sweeps)
    dev = slots.device
    lanes, r = _slots_shape(slots)
    n, m = op.n, op.m
    if int(cap) < n - 1:
        raise ValueError(f"topo_radiality takes at least n - 1 = {n - 1} "
                         f"sweeps on the card, got cap = {cap}: below the "
                         f"fixed point its asynchronous sweeps may stop at "
                         f"other labels than the reference's Jacobi sweeps")
    if (n + 2 * m) * 4 > SMEM_LIMIT:
        raise ValueError(f"topo_radiality keeps n + 2m int32 words of a "
                         f"lane in shared memory: n = {n}, m = {m} is too "
                         f"large")
    _want(dev, slots=(slots, torch.int32, (lanes, r)))
    _checked_ends(op, dev, floats=False)
    connected = torch.empty(lanes, dtype=torch.bool, device=dev)
    radial = torch.empty(lanes, dtype=torch.bool, device=dev)
    sweeps = (torch.empty(lanes, dtype=torch.int32, device=dev)
              if with_sweeps else None)
    with torch.cuda.device(dev):
        rc = _fn("topo_radiality")(
            op.f.data_ptr(), op.t.data_ptr(), slots.data_ptr(),
            connected.data_ptr(), radial.data_ptr(),
            None if sweeps is None else sweeps.data_ptr(), n, m, r, lanes,
            int(cap), _stream(slots))
    _raise_on(rc, "topo_radiality")
    _count("topo_radiality")
    return (connected, radial, sweeps) if with_sweeps else (connected, radial)


def topo_screen(zt: Tensor, theta0: Tensor, slots: Tensor, limit: float,
                op: TopoOperands, mode: int = SCREEN) -> ScreenLanes:
    """T2: the SMW lanes of ``slots [V, r]`` (int32) from ``zt [m, n]`` and
    ``theta0 [n]`` (float64, contiguous), in mode SCREEN or DETAIL."""
    if not _on_card(zt, "topo_screen"):
        return topo_screen_plain(zt, theta0, slots, limit, op, mode)
    _check_mode(mode)
    dev = zt.device
    lanes, r = _slots_shape(slots)
    n, m = op.n, op.m
    if n * 8 > SMEM_LIMIT:
        raise ValueError(f"topo_screen keeps a lane's n angles in shared "
                         f"memory: n = {n} is too large")
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
            mode, _stream(zt))
    _raise_on(rc, "topo_screen")
    _count("topo_screen", _MODES[mode])
    return ScreenLanes(*out, isl, theta, flows)
