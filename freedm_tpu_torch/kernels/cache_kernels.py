"""Wrapper, plain version and launch counter of the serving cache's kernel.

==========================  =============================================  =====
wrapper                     replaces                                       route
==========================  =============================================  =====
:func:`delta_mismatch`      the sweep body of                              CUDA
                            ``freedm_tpu/serve/cache.py``
                            ``_build_delta_program`` (:346-379) with its
                            injections, ``freedm_tpu/pf/mfree.py``
                            ``make_injection_fn`` (:34-65)
==========================  =============================================  =====

C1 lives in ``csrc/cache.cu`` (float64 state; the correction it adds may
be float32).  As in :mod:`~freedm_tpu_torch.kernels.sparse_kernels`, the
wrapper given CPU tensors runs its plain PyTorch version; given CUDA
tensors it launches its kernel or raises.  Each launch counts in
:data:`LAUNCHES`, and by mode in :func:`mode_launches`.

One call runs one of four modes over ``[B, n]`` lanes (``th``, ``v``,
the schedules ``ps``, ``qs``; a mode that corrects a half takes ``s``,
the triangular solve's answer):

- :data:`INIT` — ``dp``, ``dq`` at ``(th, v)``; writes ``err`` and sets
  ``active = it < max_sweeps & err >= tol`` in the :class:`DeltaState`;
- :data:`THETA` — ``th' = th + s·th_free`` on active lanes, then
  ``dp``, ``dq`` at ``(th', v)``;
- :data:`V` — ``v' = v + s·v_free`` on active lanes, then ``dp``, ``dq``
  and ``err`` at ``(th, v')``, ``it += 1`` and ``active = it <
  max_sweeps & err >= tol`` on those lanes;
- :data:`PQ` — the injections ``P``, ``Q`` alone.

Each returns ``(x_new, a, b, lo)``: the corrected half (``None`` for
INIT and PQ), ``dp`` and ``dq`` (``P`` and ``Q`` for PQ), and with
``lo=True`` the float32 copy of the next triangular solve's right-hand
side (``dp`` after INIT and V, ``dq`` after THETA), else ``None``.
``dp = (ps − P)/v·th_free``, ``dq = (qs − Q)/v·v_free`` and ``err =
max(max|dp·v|, max|dq·v|)`` are the reference's formulas in its order of
operations.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from freedm_tpu_torch.kernels import build

Tensor = torch.Tensor

#: Kernel launches since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"delta_mismatch": 0}
_MODE_NAMES = ("INIT", "THETA", "V", "PQ")
#: C1's launches by mode (their sum is ``LAUNCHES["delta_mismatch"]``).
_MODE_LAUNCHES: Dict[str, int] = dict.fromkeys(_MODE_NAMES, 0)
_launch_lock = threading.Lock()

#: C1's modes (``mode`` of :func:`delta_mismatch`).
INIT, THETA, V, PQ = 0, 1, 2, 3


def _count(mode: int) -> None:
    with _launch_lock:
        LAUNCHES["delta_mismatch"] += 1
        _MODE_LAUNCHES[_MODE_NAMES[mode]] += 1


def reset_launches() -> None:
    with _launch_lock:
        for counts in (LAUNCHES, _MODE_LAUNCHES):
            for k in counts:
                counts[k] = 0


def launches() -> Dict[str, int]:
    with _launch_lock:
        return dict(LAUNCHES)


def mode_launches() -> Dict[str, int]:
    """C1's launches by mode since the last :func:`reset_launches`."""
    with _launch_lock:
        return dict(_MODE_LAUNCHES)


class DeltaOperands(NamedTuple):
    """What C1 needs of one bus system, on one device (float64).

    The bus-sorted incidence list of
    :func:`freedm_tpu_torch.pf.sparse.jacobian_pattern` in CSR form, int32
    (``inc_ptr [n+1]``, ``inc_code [2m]`` = 2·edge + side, ``inc_nbr
    [2m]``); the branch ends ``f``, ``t [m]`` (int64, the plain version's
    gathers); the two-port admittances ``y [8, m]``, rows ``yff, yft, ytf,
    ytt`` as (re, im); the bus shunts ``g_sh``, ``b_sh`` and the masks
    ``th_free``, ``v_free [n]``.
    """

    inc_ptr: Tensor
    inc_code: Tensor
    inc_nbr: Tensor
    f: Tensor
    t: Tensor
    y: Tensor
    g_sh: Tensor
    b_sh: Tensor
    th_free: Tensor
    v_free: Tensor

    @property
    def n(self) -> int:
        return int(self.g_sh.shape[0])

    @property
    def m(self) -> int:
        return int(self.f.shape[0])


class DeltaState(NamedTuple):
    """The per-lane carry of the correction loop: ``err [B]`` float64,
    ``it [B]`` int32, ``active [B]`` bool."""

    err: Tensor
    it: Tensor
    active: Tensor


def new_state(lanes: int, device) -> DeltaState:
    """A fresh carry: ``it = 0``; :data:`INIT` fills ``err`` and
    ``active``."""
    return DeltaState(
        torch.zeros(lanes, dtype=torch.float64, device=device),
        torch.zeros(lanes, dtype=torch.int32, device=device),
        torch.zeros(lanes, dtype=torch.bool, device=device),
    )


# ---------------------------------------------------------------------------
# Plain PyTorch version (CPU path; the on-card comparison's reference)
# ---------------------------------------------------------------------------


def _cmul(a: Tuple[Tensor, Tensor], b: Tuple[Tensor, Tensor]):
    """The reference's (re, im) product, in its order of operations."""
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def _seg(vals: Tensor, idx: Tensor, n: int) -> Tensor:
    """``jax.ops.segment_sum`` along the last dim."""
    out = vals.new_zeros(*vals.shape[:-1], n)
    return out.index_add_(out.dim() - 1, idx, vals)


def branch_injections(theta: Tensor, v: Tensor,
                      op: DeltaOperands) -> Tuple[Tensor, Tensor]:
    """``(P, Q)`` at ``theta``, ``v`` (``[n]`` or ``[B, n]``): the
    reference ``make_injection_fn``'s branch-wise arithmetic, operation
    for operation — two gathers, four complex products, two segment sums
    per part, then the shunts."""
    n = op.n
    y = op.y.unbind(0)
    yff, yft, ytf, ytt = (y[0], y[1]), (y[2], y[3]), (y[4], y[5]), (y[6], y[7])
    vc = (v * torch.cos(theta), v * torch.sin(theta))
    vf = (vc[0][..., op.f], vc[1][..., op.f])
    vt = (vc[0][..., op.t], vc[1][..., op.t])
    a, b = _cmul(yff, vf), _cmul(yft, vt)
    i_f = (a[0] + b[0], a[1] + b[1])
    a, b = _cmul(ytf, vf), _cmul(ytt, vt)
    i_t = (a[0] + b[0], a[1] + b[1])
    s_f = _cmul(vf, (i_f[0], -i_f[1]))
    s_t = _cmul(vt, (i_t[0], -i_t[1]))
    p = _seg(s_f[0], op.f, n) + _seg(s_t[0], op.t, n)
    q = _seg(s_f[1], op.f, n) + _seg(s_t[1], op.t, n)
    v2 = v * v
    return p + op.g_sh * v2, q - op.b_sh * v2


def delta_mismatch_plain(mode: int, theta, v, ps, qs, op: DeltaOperands,
                         s=None, state: Optional[DeltaState] = None,
                         lo: bool = False, max_sweeps: int = 0,
                         tol: float = 0.0):
    """C1's plain version in each mode (same arguments and results as
    :func:`delta_mismatch`; ``state`` is updated in place)."""
    _check_mode(mode)
    x_new = None
    if mode in (THETA, V):
        live = state.active[:, None]
        if mode == THETA:
            theta = torch.where(live, theta + s.to(theta.dtype) * op.th_free,
                                theta)
            x_new = theta
        else:
            v = torch.where(live, v + s.to(v.dtype) * op.v_free, v)
            x_new = v
    p, q = branch_injections(theta, v, op)
    if mode == PQ:
        return None, p, q, None
    dp = (ps - p) / v * op.th_free
    dq = (qs - q) / v * op.v_free
    lo_t = (dq if mode == THETA else dp).to(torch.float32) if lo else None
    if mode in (INIT, V):
        err = torch.maximum(torch.amax(torch.abs(dp * v), dim=1),
                            torch.amax(torch.abs(dq * v), dim=1))
        if mode == INIT:
            state.err.copy_(err)
            state.active.copy_((state.it < max_sweeps) & (err >= tol))
        else:
            live = state.active.clone()
            state.err.copy_(torch.where(live, err, state.err))
            state.it.add_(live.to(torch.int32))
            state.active.copy_(live & (state.it < max_sweeps)
                               & (state.err >= tol))
    return x_new, dp, dq, lo_t


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = ([_I] + [_P] * 3 + [_I] + [_P] * 17 + [_I, ctypes.c_double]
             + [_I] * 3 + [_P])


@functools.lru_cache(maxsize=1)
def _fn():
    """C1's C entry point; the library is built and loaded at the first
    call (``build.load`` serializes concurrent first calls)."""
    fn = build.load("cache").delta_mismatch_f64
    fn.argtypes = _ARGTYPES
    fn.restype = _I
    return fn


def _cache_lib() -> None:
    """Build and load the kernel's library now (it happens at the first
    launch otherwise)."""
    _fn()


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def _check_mode(mode: int) -> None:
    if mode not in (INIT, THETA, V, PQ):
        raise ValueError(f"unknown delta_mismatch mode {mode!r}")


def _want(name: str, t: Tensor, dtype: torch.dtype, shape: tuple,
          dev: torch.device) -> None:
    if t.dtype is not dtype or t.device != dev:
        raise ValueError(f"{name} must be {dtype} on {dev}, got {t.dtype} "
                         f"on {t.device}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {shape} tensor, got "
                         f"{tuple(t.shape)}")


def _check(mode, theta, v, ps, qs, op, s, state) -> None:
    """Device, dtype, shape and contiguity of every operand."""
    if theta.dim() != 2:
        raise ValueError(f"theta must be [B, n], got {tuple(theta.shape)}")
    lanes, n = theta.shape
    dev, f64 = theta.device, torch.float64
    m = op.m
    for name, t in (("theta", theta), ("v", v), ("ps", ps), ("qs", qs)):
        _want(name, t, f64, (lanes, n), dev)
    i32 = torch.int32
    _want("inc_ptr", op.inc_ptr, i32, (n + 1,), dev)
    _want("inc_code", op.inc_code, i32, (2 * m,), dev)
    _want("inc_nbr", op.inc_nbr, i32, (2 * m,), dev)
    _want("y", op.y, f64, (8, m), dev)
    for name in ("g_sh", "b_sh", "th_free", "v_free"):
        _want(name, getattr(op, name), f64, (n,), dev)
    if mode in (THETA, V):
        if s is None or s.dtype not in (torch.float64, torch.float32):
            raise ValueError("THETA and V take a float64 or float32 "
                             "correction s")
        _want("s", s, s.dtype, (lanes, n), dev)
    if mode != PQ:
        if state is None:
            raise ValueError(f"mode {_MODE_NAMES[mode]} needs a DeltaState")
        _want("err", state.err, f64, (lanes,), dev)
        _want("it", state.it, i32, (lanes,), dev)
        _want("active", state.active, torch.bool, (lanes,), dev)


def delta_mismatch(mode: int, theta, v, ps, qs, op: DeltaOperands, s=None,
                   state: Optional[DeltaState] = None, lo: bool = False,
                   max_sweeps: int = 0, tol: float = 0.0):
    """C1: one mode of the delta tier's sweep over ``[B, n]`` float64 lanes
    in one launch (see the module docstring); ``state`` is updated in
    place."""
    if theta.device.type == "cpu":
        return delta_mismatch_plain(mode, theta, v, ps, qs, op, s, state, lo,
                                    max_sweeps, tol)
    _check_mode(mode)
    if theta.device.type != "cuda":
        raise ValueError(f"delta_mismatch runs on CPU or CUDA tensors, got "
                         f"{theta.device}")
    _check(mode, theta, v, ps, qs, op, s, state)
    lanes, n = theta.shape
    dev = theta.device
    fn = _fn()
    idx = theta.get_device()
    ctx = (contextlib.nullcontext() if idx == torch.cuda.current_device()
           else torch.cuda.device(idx))
    with ctx:
        stream = torch._C._cuda_getCurrentRawStream(idx)
        x_new = (torch.empty_like(theta) if mode in (THETA, V) else None)
        a = torch.empty_like(theta)
        b = torch.empty_like(theta)
        lo_t = (torch.empty(lanes, n, dtype=torch.float32, device=dev)
                if lo and mode != PQ else None)
        # PQ reads no state, and is handed none.
        st = state if mode != PQ else DeltaState(None, None, None)
        rc = fn(mode, theta.data_ptr(), v.data_ptr(), _ptr(s),
                int(s is not None and s.dtype == torch.float32),
                ps.data_ptr(), qs.data_ptr(), op.inc_ptr.data_ptr(),
                op.inc_code.data_ptr(), op.inc_nbr.data_ptr(),
                op.y.data_ptr(), op.g_sh.data_ptr(), op.b_sh.data_ptr(),
                op.th_free.data_ptr(), op.v_free.data_ptr(), _ptr(x_new),
                a.data_ptr(), b.data_ptr(), _ptr(lo_t), _ptr(st.err),
                _ptr(st.it), _ptr(st.active), int(max_sweeps), float(tol),
                lanes, n, op.m, stream)
    if rc != 0:
        raise RuntimeError(f"delta_mismatch kernel launch failed: CUDA error "
                           f"{rc}")
    _count(mode)
    return x_new, a, b, lo_t
