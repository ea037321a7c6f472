"""Wrappers, plain versions and launch counters of the screening kernels.

==========================  =============================================  =====
wrapper                     replaces                                       route
==========================  =============================================  =====
:func:`smw_sweep`           ``freedm_tpu/pf/n1.py`` ``_make_smw_n1_screen``  CUDA
                            (:340-495): the ``_solve_lane`` body around
                            its base triangular solves
:func:`dc_screen`           ``freedm_tpu/pf/dc.py`` ``_screen_impl``       CUDA
                            (:145-184) after its solves; with
                            :func:`dc_flows` the flows of ``_solve_impl``
                            (:131-139)
==========================  =============================================  =====

Both live in ``csrc/screen.cu`` (float64).  A wrapper given CPU tensors
runs its plain PyTorch version; given CUDA tensors it launches its kernel
or raises.  Each launch counts in :data:`LAUNCHES` (and by mode in
:data:`MODE_LAUNCHES`).

N1 runs one of four modes over ``L`` outage lanes (``ks [L]``, int64
branch indices) whose state ``theta``, ``v [L, n]`` it updates in place:

- :data:`INIT` — the flat start (θ = 0, V = 1 on PQ buses and the set
  point elsewhere), and ``rhs ← dp`` at it;
- :data:`THETA` — ``θ += smw_p(x0)·th_free`` from ``x0 = B′⁻¹ rhs``, then
  ``rhs ← dq`` at the new state;
- :data:`V` — ``V += smw_q(x0)·v_free`` from ``x0 = B″⁻¹ rhs``, then
  ``rhs ← dp``;
- :data:`FINISH` — returns ``(P, Q, err)`` at the state, ``err = max(max
  |dp·V|, max |dq·V|)``.

``smw(x0) = x0 − ZM_k·c``, ``c = cap_k⁻¹ (x0[f_k], x0[t_k])·mask_k`` (the
2 × 2 solve as LAPACK's ``getrf``/``getrs``), and the mismatch is the
reference's ``((p_s − P)/V·th_free, (q_s − Q)/V·v_free)`` with P and Q
the branch-wise injections with branch ``k`` out of service.  ``rhs`` is
``[L, n]``, lane-major: the base solve takes it as the column-major
``[n, L]`` matrix ``rhs.mT`` and N1 reads the solve's answer through its
strides.

D1 :func:`dc_screen` (mode SCREEN) takes the base angles ``theta0 [n]``,
``z = B′⁻¹ A [n, L]`` (any strides; column ``l`` the masked update
column of branch ``ks[l]``) and returns ``(theta [L, n], flows [L, m],
severity [L], islanded [L])``; :func:`dc_flows` (mode SOLVE) returns the
flows ``[L, m]`` of angle lanes ``theta [L, n]`` (any strides).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from freedm_tpu_torch.kernels import build
from freedm_tpu_torch.kernels.cache_kernels import (DeltaOperands,
                                                    branch_injections)
# N1 keeps 4 n float64 words of a lane in shared memory, D1 n.
from freedm_tpu_torch.kernels.sparse_kernels import SMEM_LIMIT

Tensor = torch.Tensor

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"smw_sweep": 0, "dc_screen": 0}
#: The launches by mode (their sums are :data:`LAUNCHES`).
MODE_LAUNCHES: Dict[str, Dict[str, int]] = {
    "smw_sweep": {"INIT": 0, "THETA": 0, "V": 0, "FINISH": 0},
    "dc_screen": {"SCREEN": 0, "SOLVE": 0},
}
_launch_lock = threading.Lock()

#: N1's modes.
INIT, THETA, V, FINISH = 0, 1, 2, 3
_SMW_MODES = ("INIT", "THETA", "V", "FINISH")
#: D1's modes.
SCREEN, SOLVE = 0, 1

#: |1 − w·aᵀz| below this marks the Sherman–Morrison denominator singular:
#: the outage islands the network (``freedm_tpu/pf/dc.py`` ``_ISLAND_EPS``).
ISLAND_EPS = 1e-6


def _count(name: str, mode: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1
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


class SmwOperands(NamedTuple):
    """What N1 needs of one bus system, on one device (float64): the
    injection operands ``dop`` (incidence list, branch ends, admittances,
    shunts, masks), the set points and schedules ``v_set``, ``p_sched``,
    ``q_sched [n]``, and per branch and half (0: B′ and θ, 1: B″ and V) the
    endpoint masks ``mask [2, m, 2]``, ``ZM = A⁻¹U`` branch-major ``zm [2,
    m, n, 2]`` and the capacitance ``cap [2, m, 2, 2] = I₂ + PᵀA⁻¹U``."""

    dop: DeltaOperands
    v_set: Tensor
    p_sched: Tensor
    q_sched: Tensor
    mask: Tensor
    zm: Tensor
    cap: Tensor

    @property
    def n(self) -> int:
        return self.dop.n

    @property
    def m(self) -> int:
        return self.dop.m


class DcOperands(NamedTuple):
    """What D1 needs of one bus system: the branch ends ``f``, ``t [m]``
    (int64), ``w = 1/x [m]`` and ``th_free [n]`` (float64)."""

    f: Tensor
    t: Tensor
    w: Tensor
    th_free: Tensor


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the on-card comparison's reference)
# ---------------------------------------------------------------------------


def solve2_plain(cap: Tensor, b: Tensor) -> Tensor:
    """``cap⁻¹ b`` for ``[L, 2, 2]`` and ``[L, 2]``, as LAPACK's ``getrf``
    (rows swap only where ``|a10| > |a00|``; the multiplier is ``a10``
    times the pivot's reciprocal) and ``getrs`` compute it."""
    a00, a01, a10, a11 = cap[:, 0, 0], cap[:, 0, 1], cap[:, 1, 0], cap[:, 1, 1]
    b0, b1 = b[:, 0], b[:, 1]
    sw = torch.abs(a10) > torch.abs(a00)

    def pick(x, y):
        return torch.where(sw, y, x), torch.where(sw, x, y)

    (a00, a10), (a01, a11), (b0, b1) = pick(a00, a10), pick(a01, a11), pick(b0, b1)
    lo = a10 * (1.0 / a00)
    u11 = a11 - lo * a01
    x1 = (b1 - b0 * lo) / u11
    x0 = (b0 - x1 * a01) / a00
    return torch.stack([x0, x1], dim=1)


def _outage_status(ks: Tensor, m: int, dtype) -> Tensor:
    st = torch.ones(ks.shape[0], m, dtype=dtype, device=ks.device)
    st[torch.arange(ks.shape[0], device=ks.device), ks] = 0.0
    return st


def smw_sweep_plain(mode: int, ks: Tensor, theta: Tensor, v: Tensor,
                    rhs: Tensor, op: SmwOperands,
                    x0: Optional[Tensor] = None):
    """N1's plain version (the module docstring's modes; ``theta``, ``v``
    and ``rhs`` are written in place; FINISH returns ``(P, Q, err)``)."""
    _check_smw_mode(mode)
    d = op.dop
    if mode == INIT:
        theta.zero_()
        v.copy_(torch.where(d.v_free > 0, torch.ones_like(op.v_set),
                            op.v_set).expand_as(v))
    elif mode in (THETA, V):
        h = 0 if mode == THETA else 1
        x = x0.mT  # [L, n] lane rows
        ends = torch.stack([d.f[ks], d.t[ks]], dim=1)
        g = torch.gather(x, 1, ends) * op.mask[h][ks]
        c = solve2_plain(op.cap[h][ks], g)
        zm = op.zm[h][ks]
        delta = x - (zm[..., 0] * c[:, 0:1] + zm[..., 1] * c[:, 1:2])
        if mode == THETA:
            theta.copy_(theta + delta * d.th_free)
        else:
            v.copy_(v + delta * d.v_free)
    st = _outage_status(ks, op.m, theta.dtype)
    p, q = branch_injections(theta, v, d, st)
    dp = (op.p_sched - p) / v * d.th_free
    dq = (op.q_sched - q) / v * d.v_free
    if mode == FINISH:
        err = torch.maximum(torch.amax(torch.abs(dp * v), dim=1),
                            torch.amax(torch.abs(dq * v), dim=1))
        return p, q, err
    rhs.copy_(dq if mode == THETA else dp)
    return None


def dc_screen_plain(theta0: Tensor, z: Tensor, ks: Tensor,
                    op: DcOperands) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """D1's SCREEN mode in the reference's expressions and order."""
    lanes = torch.arange(ks.shape[0], device=ks.device)
    fk, tk = op.f[ks], op.t[ks]
    mf, mt = op.th_free[fk], op.th_free[tk]
    wk = op.w[ks]
    a_dot_th = theta0[fk] * mf - theta0[tk] * mt
    a_dot_z = z[fk, lanes] * mf - z[tk, lanes] * mt
    den = 1.0 - wk * a_dot_z
    islanded = torch.abs(den) < ISLAND_EPS
    safe_den = torch.where(islanded, torch.ones_like(den), den)
    theta = theta0[None, :] + (wk * a_dot_th / safe_den)[:, None] * z.mT
    flows = dc_flows_plain(theta, op)
    flows[lanes, ks] = 0.0
    severity = torch.where(islanded, torch.full_like(den, float("inf")),
                           torch.amax(torch.abs(flows), dim=1))
    return theta, flows, severity, islanded


def dc_flows_plain(theta: Tensor, op: DcOperands) -> Tensor:
    """D1's SOLVE mode: ``(θ[f] − θ[t])·w`` per lane."""
    return (theta[..., op.f] - theta[..., op.t]) * op.w


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGS = {
    "smw_sweep_f64": [_P] * 4 + [_L] * 2 + [_P] * 20 + [_I] * 4 + [_P],
    "dc_screen_f64": [_P] * 2 + [_L] * 2 + [_P] * 9 + [_I] * 4 + [_P],
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
                lib = build.load("screen")
                for sym, args in _SIGS.items():
                    f = getattr(lib, sym)
                    f.argtypes = args
                    f.restype = _I
                    _fns[sym] = f
        fn = _fns[name]
    return fn


def _screen_lib() -> None:
    """Build and load the kernels' library now (it happens at the first
    launch otherwise)."""
    _fn("smw_sweep_f64")


def _check_smw_mode(mode: int) -> None:
    if mode not in (INIT, THETA, V, FINISH):
        raise ValueError(f"unknown smw_sweep mode {mode!r}")


def _want(dev, **tensors) -> None:
    """Device, dtype and contiguity of a launch's operands: float tensors
    float64, index tensors int64 or int32 as named."""
    for name, (t, dtype, shape) in tensors.items():
        if t.device != dev or t.dtype is not dtype:
            raise ValueError(f"{name} must be {dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if shape is not None and (tuple(t.shape) != tuple(shape)
                                  or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {tuple(shape)} "
                             f"tensor, got {tuple(t.shape)}")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _stream(t: Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _checked_smw(op: SmwOperands, dev) -> None:
    f64, i32, i64 = torch.float64, torch.int32, torch.int64
    n, m = op.n, op.m
    d = op.dop
    _want(dev, inc_ptr=(d.inc_ptr, i32, (n + 1,)),
          inc_code=(d.inc_code, i32, (2 * m,)),
          inc_nbr=(d.inc_nbr, i32, (2 * m,)), y=(d.y, f64, (8, m)),
          g_sh=(d.g_sh, f64, (n,)), b_sh=(d.b_sh, f64, (n,)),
          th_free=(d.th_free, f64, (n,)), v_free=(d.v_free, f64, (n,)),
          v_set=(op.v_set, f64, (n,)), p_sched=(op.p_sched, f64, (n,)),
          q_sched=(op.q_sched, f64, (n,)), f=(d.f, i64, (m,)),
          t=(d.t, i64, (m,)), mask=(op.mask, f64, (2, m, 2)),
          zm=(op.zm, f64, (2, m, n, 2)), cap=(op.cap, f64, (2, m, 2, 2)))


#: Operand sets already checked (by id, with the set kept alive).
_checked: Dict[int, object] = {}


def _check_once(op, dev, check) -> None:
    key = id(op)
    if _checked.get(key) is op:
        return
    check(op, dev)
    with _launch_lock:
        if len(_checked) >= 64:
            _checked.clear()
        _checked[key] = op


def smw_sweep(mode: int, ks: Tensor, theta: Tensor, v: Tensor, rhs: Tensor,
              op: SmwOperands, x0: Optional[Tensor] = None):
    """N1: one mode of the SMW screen over every lane, in one launch (the
    module docstring's modes).  ``ks [L]`` int64; ``theta``, ``v``, ``rhs``
    contiguous ``[L, n]`` float64, updated in place; ``x0`` the base
    solve's ``[n, L]`` answer (THETA and V, any strides).  FINISH returns
    ``(P [L, n], Q [L, n], err [L])``."""
    if theta.device.type == "cpu":
        return smw_sweep_plain(mode, ks, theta, v, rhs, op, x0)
    _check_smw_mode(mode)
    if theta.device.type != "cuda":
        raise ValueError(f"smw_sweep runs on CPU or CUDA tensors, got "
                         f"{theta.device}")
    dev = theta.device
    n, m = op.n, op.m
    lanes = int(ks.shape[0])
    if 4 * n * 8 > SMEM_LIMIT:
        raise ValueError(f"smw_sweep keeps 4 n words of a lane in shared "
                         f"memory: n = {n} is too large")
    f64 = torch.float64
    _want(dev, ks=(ks, torch.int64, (lanes,)), theta=(theta, f64, (lanes, n)),
          v=(v, f64, (lanes, n)), rhs=(rhs, f64, (lanes, n)))
    _check_once(op, dev, _checked_smw)
    x0_ptr, x0_si, x0_sl = 0, 0, 0
    if mode in (THETA, V):
        _want(dev, x0=(x0, f64, None))
        if tuple(x0.shape) != (n, lanes):
            raise ValueError(f"x0 must be [{n}, {lanes}], got "
                             f"{tuple(x0.shape)}")
        x0_ptr, (x0_si, x0_sl) = x0.data_ptr(), x0.stride()
    p = q = err = None
    if mode == FINISH:
        p = torch.empty(lanes, n, dtype=f64, device=dev)
        q = torch.empty(lanes, n, dtype=f64, device=dev)
        err = torch.empty(lanes, dtype=f64, device=dev)
    d = op.dop

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        rc = _fn("smw_sweep_f64")(
            ks.data_ptr(), theta.data_ptr(), v.data_ptr(), x0_ptr or None,
            x0_si, x0_sl, rhs.data_ptr(), ptr(p), ptr(q), ptr(err),
            d.inc_ptr.data_ptr(), d.inc_code.data_ptr(), d.inc_nbr.data_ptr(),
            d.y.data_ptr(), d.g_sh.data_ptr(), d.b_sh.data_ptr(),
            d.th_free.data_ptr(), d.v_free.data_ptr(), op.v_set.data_ptr(),
            op.p_sched.data_ptr(), op.q_sched.data_ptr(), d.f.data_ptr(),
            d.t.data_ptr(), op.mask.data_ptr(), op.zm.data_ptr(),
            op.cap.data_ptr(), n, m, lanes, mode, _stream(theta))
    _raise_on(rc, "smw_sweep")
    _count("smw_sweep", _SMW_MODES[mode])
    return (p, q, err) if mode == FINISH else None


def _checked_dc(op: DcOperands, dev) -> None:
    m = int(op.f.shape[0])
    _want(dev, f=(op.f, torch.int64, (m,)), t=(op.t, torch.int64, (m,)),
          w=(op.w, torch.float64, (m,)),
          th_free=(op.th_free, torch.float64, (int(op.th_free.shape[0]),)))


def dc_screen(theta0: Tensor, z: Tensor, ks: Tensor, op: DcOperands
              ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """D1 SCREEN: the Sherman–Morrison outage lanes, their flows and
    severity from ``theta0 [n]`` and ``z [n, L]``; ``(theta [L, n], flows
    [L, m], severity [L], islanded [L] bool)``."""
    if theta0.device.type == "cpu":
        return dc_screen_plain(theta0, z, ks, op)
    if theta0.device.type != "cuda":
        raise ValueError(f"dc_screen runs on CPU or CUDA tensors, got "
                         f"{theta0.device}")
    dev = theta0.device
    n, m, lanes = int(theta0.shape[0]), int(op.f.shape[0]), int(ks.shape[0])
    if n * 8 > SMEM_LIMIT:
        raise ValueError(f"dc_screen keeps a lane's n angles in shared "
                         f"memory: n = {n} is too large")
    f64 = torch.float64
    _want(dev, theta0=(theta0, f64, (n,)), ks=(ks, torch.int64, (lanes,)),
          z=(z, f64, None))
    if tuple(z.shape) != (n, lanes):
        raise ValueError(f"z must be [{n}, {lanes}], got {tuple(z.shape)}")
    _check_once(op, dev, _checked_dc)
    theta = torch.empty(lanes, n, dtype=f64, device=dev)
    flows = torch.empty(lanes, m, dtype=f64, device=dev)
    sev = torch.empty(lanes, dtype=f64, device=dev)
    isl = torch.empty(lanes, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = _fn("dc_screen_f64")(
            theta0.data_ptr(), z.data_ptr(), z.stride(0), z.stride(1),
            ks.data_ptr(), op.f.data_ptr(), op.t.data_ptr(), op.w.data_ptr(),
            op.th_free.data_ptr(), theta.data_ptr(), flows.data_ptr(),
            sev.data_ptr(), isl.data_ptr(), n, m, lanes, SCREEN,
            _stream(theta0))
    _raise_on(rc, "dc_screen")
    _count("dc_screen", "SCREEN")
    return theta, flows, sev, isl


def dc_flows(theta: Tensor, op: DcOperands) -> Tensor:
    """D1 SOLVE: the flows ``[L, m]`` of angle lanes ``theta [L, n]`` (any
    strides)."""
    if theta.device.type == "cpu":
        return dc_flows_plain(theta, op)
    if theta.device.type != "cuda":
        raise ValueError(f"dc_flows runs on CPU or CUDA tensors, got "
                         f"{theta.device}")
    dev = theta.device
    if theta.dim() != 2:
        raise ValueError(f"theta must be [L, n], got {tuple(theta.shape)}")
    lanes, n = int(theta.shape[0]), int(theta.shape[1])
    m = int(op.f.shape[0])
    _want(dev, theta=(theta, torch.float64, None))
    _check_once(op, dev, _checked_dc)
    flows = torch.empty(lanes, m, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        rc = _fn("dc_screen_f64")(
            None, theta.data_ptr(), theta.stride(1), theta.stride(0), None,
            op.f.data_ptr(), op.t.data_ptr(), op.w.data_ptr(),
            op.th_free.data_ptr(), None, flows.data_ptr(), None, None, n, m,
            lanes, SOLVE, _stream(theta))
    _raise_on(rc, "dc_screen")
    _count("dc_screen", "SOLVE")
    return flows
