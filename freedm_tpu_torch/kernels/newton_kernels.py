"""Wrappers, plain versions and launch counters of the Newton kernels.

==========================  ==========================================  =======
wrapper                     replaces (``freedm_tpu/pf/newton.py``)      route
==========================  ==========================================  =======
:func:`newton_assemble`     ``_newton_step`` (:260-301) minus the solve  CUDA
:func:`power_injections`    ``s_calc`` (:144-151), ``_residual``         CUDA
                            (:253-258)
:func:`newton_update`       the per-lane ``select`` of the vmapped       Triton
                            ``while_loop`` (:325-336)
==========================  ==========================================  =======

A wrapper given CPU tensors runs its plain PyTorch version (the CPU
tests' path); given CUDA tensors it launches its kernel or raises —
there is no fallback.  The plain versions (``*_plain``) repeat the
kernels' arithmetic in PyTorch; ``chip_smoke.py`` holds each kernel
against its plain version on the card.  Each wrapper counts its kernel
launches in :data:`LAUNCHES` (CPU calls count nothing), so a run can
show that the main path went through the kernels.

Layout: the Newton state ``x`` is ``[B, 2n]`` = θ ‖ V per lane (the
reference's ``x``); Ybus is a ``(re, im)`` pair of ``[n, n]`` tensors
shared by every lane; the masks ``th_free``, ``v_free`` (1 where the
quantity is unknown), ``v_set`` are ``[n]`` and ``free`` is ``[2n]``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import torch

from freedm_tpu_torch.kernels import build

Tensor = torch.Tensor

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {
    "newton_assemble": 0,
    "power_injections": 0,
    "newton_update": 0,
}
_launch_lock = threading.Lock()


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
# Plain PyTorch versions (CPU path; the on-card comparison's reference)
# ---------------------------------------------------------------------------


def _c_a(x: Tensor, y_re: Tensor, y_im: Tensor):
    """The reference's shared intermediates, ``[B, n, n]`` each:
    C = V_iV_j(G cos E + B sin E), A = V_iV_j(G sin E − B cos E)."""
    n = y_re.shape[0]
    theta, v = x[:, :n], x[:, n:]
    ct, st = torch.cos(theta), torch.sin(theta)
    cos_e = ct[:, :, None] * ct[:, None, :] + st[:, :, None] * st[:, None, :]
    sin_e = st[:, :, None] * ct[:, None, :] - ct[:, :, None] * st[:, None, :]
    vo = v[:, :, None] * v[:, None, :]
    c = vo * (y_re * cos_e + y_im * sin_e)
    a = vo * (y_re * sin_e - y_im * cos_e)
    return c, a


def _mismatch(x, p, q, p_sched, q_sched, th_free, v_free, v_set):
    n = p.shape[1]
    theta, v = x[:, :n], x[:, n:]
    f_p = torch.where(th_free > 0, p - p_sched, theta)
    f_q = torch.where(v_free > 0, q - q_sched, v - v_set)
    return torch.cat([f_p, f_q], dim=1)


def newton_assemble_plain(x, y_re, y_im, p_sched, q_sched, th_free, v_free,
                          v_set) -> Tuple[Tensor, Tensor]:
    """K1's plain version: ``(jac [B, 2n, 2n], f [B, 2n])``."""
    n = y_re.shape[0]
    lanes = x.shape[0]
    c, a = _c_a(x, y_re, y_im)
    p, q = c.sum(dim=2), a.sum(dim=2)
    f = _mismatch(x, p, q, p_sched, q_sched, th_free, v_free, v_set)
    v = x[:, n:]
    jac = x.new_empty(lanes, 2 * n, 2 * n)
    jac[:, :n, :n] = a
    jac[:, :n, n:] = c / v[:, None, :]
    jac[:, n:, :n] = -c
    jac[:, n:, n:] = a / v[:, None, :]
    d = torch.arange(n, device=x.device)
    jac[:, d, d] -= q
    jac[:, d, n + d] += p / v
    jac[:, n + d, d] += p
    jac[:, n + d, n + d] += q / v
    pinned = torch.nonzero(torch.cat([th_free, v_free]) == 0).flatten()
    jac[:, pinned, :] = 0.0
    jac[:, pinned, pinned] = 1.0
    return jac, f


def power_injections_plain(x, y_re, y_im, p_sched, q_sched, th_free, v_free,
                           v_set) -> Tuple[Tensor, Tensor, Tensor]:
    """K2's plain version: ``(p [B, n], q [B, n], f [B, 2n])``, in the
    reference ``s_calc``'s current-injection form S = V conj(Y V)."""
    n = y_re.shape[0]
    theta, v = x[:, :n], x[:, n:]
    vr, vm = v * torch.cos(theta), v * torch.sin(theta)
    i_re = vr @ y_re.T - vm @ y_im.T
    i_im = vm @ y_re.T + vr @ y_im.T
    p, q = vr * i_re + vm * i_im, vm * i_re - vr * i_im
    f = _mismatch(x, p, q, p_sched, q_sched, th_free, v_free, v_set)
    return p, q, f


def newton_update_plain(x, dx, f, free, it, err, active, max_iter: int,
                        tol: Tensor) -> None:
    """K3's plain version (in place on x, it, err, active)."""
    err_new = torch.amax(torch.abs(f * free), dim=1)  # propagates NaN
    x.copy_(torch.where(active[:, None], x + dx, x))
    it.add_(active.to(it.dtype))
    err.copy_(torch.where(active, err_new, err))
    active.copy_((it < max_iter) & (err >= tol))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib_lock = threading.Lock()
_lib = None


def _newton_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("newton")
            for suffix in ("f64", "f32"):
                fn = getattr(lib, f"newton_assemble_{suffix}")
                fn.argtypes = [_P] * 12 + [_I, _I, _P]
                fn.restype = _I
                fn = getattr(lib, f"power_injections_{suffix}")
                fn.argtypes = [_P] * 13 + [_I, _I, _P]
                fn.restype = _I
            _lib = lib
        return _lib


_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def _check(x: Tensor, y_re: Tensor, y_im: Tensor, vecs: Dict[str, Tensor],
           masks: Dict[str, Tensor]) -> int:
    """Validate the shared K1/K2 inputs on the card; returns n."""
    if x.dim() != 2 or x.shape[1] % 2:
        raise ValueError(f"x must be [B, 2n], got {tuple(x.shape)}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"kernels take float64 or float32, got {x.dtype}")
    lanes, n = x.shape[0], x.shape[1] // 2
    want = {"x": (x, (lanes, 2 * n)), "y_re": (y_re, (n, n)),
            "y_im": (y_im, (n, n))}
    want.update({k: (t, (lanes, n)) for k, t in vecs.items()})
    want.update({k: (t, (n,)) for k, t in masks.items()})
    for name, (t, shape) in want.items():
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(
                f"{name} must be {x.dtype} on {x.device}, got {t.dtype} on "
                f"{t.device}"
            )
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {shape} tensor, got "
                f"{tuple(t.shape)}"
            )
    if lanes == 0 or n > 65535:
        raise ValueError(f"unsupported shape: {lanes} lanes, {n} buses")
    return n


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _ptr(t: Tensor) -> int:
    return t.data_ptr()


def newton_assemble(x, y_re, y_im, p_sched, q_sched, th_free, v_free,
                    v_set) -> Tuple[Tensor, Tensor]:
    """K1: the masked mismatch and the polar Jacobian at ``x``.

    Returns ``(jac [B, 2n, 2n], f [B, 2n])``."""
    if x.device.type == "cpu":
        return newton_assemble_plain(x, y_re, y_im, p_sched, q_sched,
                                     th_free, v_free, v_set)
    n = _check(x, y_re, y_im, {"p_sched": p_sched, "q_sched": q_sched},
               {"th_free": th_free, "v_free": v_free, "v_set": v_set})
    lanes = x.shape[0]
    fn = getattr(_newton_lib(), f"newton_assemble_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        jac = torch.empty(lanes, 2 * n, 2 * n, dtype=x.dtype, device=x.device)
        f = torch.empty(lanes, 2 * n, dtype=x.dtype, device=x.device)
        ct = torch.empty(lanes, n, dtype=x.dtype, device=x.device)
        st = torch.empty_like(ct)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*map(_ptr, (x, y_re, y_im, p_sched, q_sched, th_free, v_free,
                            v_set, ct, st, f, jac)), lanes, n, stream)
    _raise_on(rc, "newton_assemble")
    _count("newton_assemble")
    return jac, f


def power_injections(x, y_re, y_im, p_sched, q_sched, th_free, v_free,
                     v_set) -> Tuple[Tensor, Tensor, Tensor]:
    """K2: realized injections and the masked mismatch at ``x``.

    Returns ``(p [B, n], q [B, n], f [B, 2n])``."""
    if x.device.type == "cpu":
        return power_injections_plain(x, y_re, y_im, p_sched, q_sched,
                                      th_free, v_free, v_set)
    n = _check(x, y_re, y_im, {"p_sched": p_sched, "q_sched": q_sched},
               {"th_free": th_free, "v_free": v_free, "v_set": v_set})
    lanes = x.shape[0]
    fn = getattr(_newton_lib(), f"power_injections_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        p = torch.empty(lanes, n, dtype=x.dtype, device=x.device)
        q = torch.empty_like(p)
        f = torch.empty(lanes, 2 * n, dtype=x.dtype, device=x.device)
        vr = torch.empty_like(p)
        vm = torch.empty_like(p)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*map(_ptr, (x, y_re, y_im, p_sched, q_sched, th_free, v_free,
                            v_set, vr, vm, f, p, q)), lanes, n, stream)
    _raise_on(rc, "power_injections")
    _count("power_injections")
    return p, q, f


def newton_update(x, dx, f, free, it, err, active, max_iter: int,
                  tol: Tensor) -> None:
    """K3: the per-lane masked update, in place on ``x [B, 2n]``,
    ``it [B]`` (int32), ``err [B]`` and ``active [B]`` (bool).  ``tol``
    is a one-element tensor of x's dtype (a float64 comparison needs a
    float64 operand; a Python float would reach Triton as float32)."""
    if x.device.type == "cpu":
        newton_update_plain(x, dx, f, free, it, err, active, max_iter, tol)
        return
    lanes, m = x.shape
    want = {"x": (x, x.dtype, (lanes, m)), "dx": (dx, x.dtype, (lanes, m)),
            "f": (f, x.dtype, (lanes, m)), "free": (free, x.dtype, (m,)),
            "it": (it, torch.int32, (lanes,)),
            "err": (err, x.dtype, (lanes,)),
            "active": (active, torch.bool, (lanes,)),
            "tol": (tol, x.dtype, (1,))}
    for name, (t, dtype, shape) in want.items():
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(
                f"{name} must be {dtype} on {x.device}, got {t.dtype} on "
                f"{t.device}"
            )
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {shape} tensor, got "
                f"{tuple(t.shape)}"
            )
    from freedm_tpu_torch.kernels import newton_update_triton

    with torch.cuda.device(x.device):
        newton_update_triton.launch(x, dx, f, free, it, err, active,
                                    max_iter, tol)
    _count("newton_update")
