"""Wrappers, plain versions and launch counters of the Newton kernels.

==========================  ==========================================  =======
wrapper                     replaces (``freedm_tpu/pf/newton.py``)      route
==========================  ==========================================  =======
:func:`newton_assemble`     ``_newton_step`` (:260-301) minus the solve  CUDA
:func:`power_injections`    ``s_calc`` (:144-151), ``_residual``         CUDA
                            (:253-258)
:func:`newton_update`       the per-lane ``select`` of the vmapped       CUDA
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
shared by every lane (lane stride 0), or of ``[B, n, n]`` tensors, one
per lane (the dense backend's branch ``status``); the masks ``th_free``,
``v_free`` (1 where the quantity is unknown), ``v_set`` are ``[n]`` and
``free`` is ``[2n]``.

K2's product with one Ybus for every lane is ``csrc/row_product.cuh``'s
tiled form, which F1 and I1 (:mod:`~freedm_tpu_torch.kernels.solver_kernels`)
share: a GEMM of n rows, B lanes and n columns in 64 × 64 tiles, its
columns cut into :func:`product_splits` slices whose partial sums the
wrapper's scratch holds (:func:`product_scratch`) and an epilogue pass
adds in split order; float64 runs on the tensor cores, float32 by FFMA
on the CUDA cores.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
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
    n = y_re.shape[-1]
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
    n = y_re.shape[-1]
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


def injections_plain(vr: Tensor, vm: Tensor, y_re: Tensor, y_im: Tensor):
    """``(P, Q)`` of S = V conj(Y V) for ``[B, n]`` voltages (rectangular
    ``vr``, ``vm``) and a shared ``[n, n]`` or per-lane ``[B, n, n]``
    Ybus."""
    if y_re.dim() == 2:
        i_re = vr @ y_re.T - vm @ y_im.T
        i_im = vm @ y_re.T + vr @ y_im.T
    else:
        i_re = (y_re @ vr[:, :, None] - y_im @ vm[:, :, None])[:, :, 0]
        i_im = (y_re @ vm[:, :, None] + y_im @ vr[:, :, None])[:, :, 0]
    return vr * i_re + vm * i_im, vm * i_re - vr * i_im


def power_injections_plain(x, y_re, y_im, p_sched, q_sched, th_free, v_free,
                           v_set) -> Tuple[Tensor, Tensor, Tensor]:
    """K2's plain version: ``(p [B, n], q [B, n], f [B, 2n])``, in the
    reference ``s_calc``'s current-injection form S = V conj(Y V)."""
    n = y_re.shape[-1]
    theta, v = x[:, :n], x[:, n:]
    p, q = injections_plain(v * torch.cos(theta), v * torch.sin(theta), y_re,
                            y_im)
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
# The tiled product's launch plan
# ---------------------------------------------------------------------------


#: ``csrc/row_product.cuh``'s tile: rows of Y and lanes a block, columns a
#: pipeline stage, and the most K slices a launch takes.
TILE_ROWS, TILE_LANES, TILE_K, MAX_SPLITS = build.constants(
    "row_product.cuh", "kTileRows", "kTileLanes", "kTileK", "kMaxSplits")
#: SMs of an H100 SXM.  A card with another SM count runs the same plan
#: (the bits do not depend on the card).
PLAN_SMS = 132
#: Two blocks on one SM take this share of the time of running them one
#: after the other (they fill each other's barrier and load stalls;
#: measured at mesh2000 × 64 and the CIM feeder × 64 on an H100).
PLAN_SHARED_SM = 0.87


def product_splits(n: int, lanes: int) -> int:
    """The K slices of the tiled product of an ``[n, n]`` Y with ``lanes``
    lanes.  A function of the shape alone, so every kernel on the product
    (K2, F1, I1) gets the same bits from the same operands.

    Cost of ``s`` slices, in a stage's time on one SM: the blocks an SM
    runs (``tiles × s`` over :data:`PLAN_SMS`, rounded up) times a
    block's stages (its slice, plus two for the pipeline's fill and its
    store), times :data:`PLAN_SHARED_SM` when SMs run more than one
    block, plus half a stage a slice for the epilogue pass's reads.  The
    smallest cost wins, ties to fewer slices; no slice is empty.  On an
    H100 this picks 8 at mesh2000 × 64 (the product 0.047 ms against 0.053
    for 4) and on the CIM feeder (n = 3000) × 64 (0.103 ms against 0.108
    for 5)."""
    if n <= 0 or lanes <= 0:
        raise ValueError(f"product_splits needs n, lanes > 0, got {n}, "
                         f"{lanes}")
    tiles = math.ceil(n / TILE_ROWS) * math.ceil(lanes / TILE_LANES)
    stages = math.ceil(n / TILE_K)
    best, best_cost = 1, None
    for s in range(1, min(MAX_SPLITS, stages) + 1):
        per = math.ceil(stages / s)
        if (s - 1) * per >= stages:
            continue
        waves = math.ceil(tiles * s / PLAN_SMS)
        cost = waves * (per + 2) * (PLAN_SHARED_SM if waves > 1 else 1.0) \
            + s / 2
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def product_scratch(n: int, lanes: int, dtype: torch.dtype,
                    device: torch.device) -> Tuple[int, Tensor]:
    """``(splits, part)``: the plan and the ``[splits, 2, lanes, n]``
    partial sums the tiled product writes and its epilogue pass reads."""
    splits = product_splits(n, lanes)
    return splits, torch.empty(splits, 2, lanes, n, dtype=dtype,
                               device=device)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_lib_lock = threading.Lock()
_lib = None


def _newton_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("newton")
            for suffix in ("f64", "f32"):
                fn = getattr(lib, f"newton_assemble_{suffix}")
                fn.argtypes = [_P] * 12 + [_I, _I, _L, _P]
                fn.restype = _I
                fn = getattr(lib, f"power_injections_{suffix}")
                fn.argtypes = [_P] * 14 + [_I, _I, _L, _I, _P]
                fn.restype = _I
                fn = getattr(lib, f"newton_update_{suffix}")
                fn.argtypes = [_P] * 8 + [_I] * 3 + [_P]
                fn.restype = _I
            _lib = lib
        return _lib


_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def _check(x: Tensor, y_re: Tensor, y_im: Tensor, vecs: Dict[str, Tensor],
           masks: Dict[str, Tensor]) -> int:
    """Validate the shared K1/K2 inputs on the card; returns n.  Ybus is
    ``[n, n]`` or ``[B, n, n]``."""
    if x.dim() != 2 or x.shape[1] % 2:
        raise ValueError(f"x must be [B, 2n], got {tuple(x.shape)}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"kernels take float64 or float32, got {x.dtype}")
    lanes, n = x.shape[0], x.shape[1] // 2
    ysh = (n, n) if y_re.dim() == 2 else (lanes, n, n)
    want = {"x": (x, (lanes, 2 * n)), "y_re": (y_re, ysh),
            "y_im": (y_im, ysh)}
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
    if lanes == 0 or n > 65535 or (len(ysh) == 3 and lanes > 65535):
        raise ValueError(f"unsupported shape: {lanes} lanes, {n} buses")
    return n


def _lane_stride(y_re: Tensor) -> int:
    """K1/K2's Ybus lane stride: 0 for ``[n, n]``, n² for a stack."""
    return 0 if y_re.dim() == 2 else y_re.shape[1] * y_re.shape[2]


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
    y_stride = _lane_stride(y_re)
    lanes = x.shape[0]
    fn = getattr(_newton_lib(), f"newton_assemble_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        jac = torch.empty(lanes, 2 * n, 2 * n, dtype=x.dtype, device=x.device)
        f = torch.empty(lanes, 2 * n, dtype=x.dtype, device=x.device)
        ct = torch.empty(lanes, n, dtype=x.dtype, device=x.device)
        st = torch.empty_like(ct)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*map(_ptr, (x, y_re, y_im, p_sched, q_sched, th_free, v_free,
                            v_set, ct, st, f, jac)), lanes, n, y_stride,
                stream)
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
    y_stride = _lane_stride(y_re)
    lanes = x.shape[0]
    fn = getattr(_newton_lib(), f"power_injections_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        p = torch.empty(lanes, n, dtype=x.dtype, device=x.device)
        q = torch.empty_like(p)
        f = torch.empty(lanes, 2 * n, dtype=x.dtype, device=x.device)
        vr = torch.empty_like(p)
        vm = torch.empty_like(p)
        splits, part = ((0, None) if y_stride else
                        product_scratch(n, lanes, x.dtype, x.device))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*map(_ptr, (x, y_re, y_im, p_sched, q_sched, th_free, v_free,
                            v_set, vr, vm, f, p, q)),
                None if part is None else part.data_ptr(), lanes, n,
                y_stride, splits, stream)
    _raise_on(rc, "power_injections")
    _count("power_injections")
    return p, q, f


#: The last carry K3 checked: its tensors, their device pointers, (lanes,
#: m) and the entry point.  A solve calls K3 once per iteration on one
#: carry (x, free, it, err, active, tol updated in place), so the carry is
#: checked at its first call and only the step's new dx and f afterwards;
#: the entry keeps one solve's carry alive until the next solve replaces it.
_k3_carry = None


def _update_carry(x, free, it, err, active, tol):
    global _k3_carry
    carry = (x, free, it, err, active, tol)
    hit = _k3_carry
    if hit is not None and all(a is b for a, b in zip(hit[0], carry)):
        return hit
    if x.dim() != 2 or x.dtype not in _SUFFIX:
        raise ValueError(f"x must be a float64 or float32 [B, 2n] tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    lanes, m = x.shape
    want = {"x": (x, x.dtype, (lanes, m)), "free": (free, x.dtype, (m,)),
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
    if lanes == 0:
        raise ValueError("unsupported shape: 0 lanes")
    if x.device.type != "cuda":
        raise ValueError(f"newton_update runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    fn = getattr(_newton_lib(), f"newton_update_{_SUFFIX[x.dtype]}")
    hit = _k3_carry = (carry, tuple(t.data_ptr() for t in carry), lanes, m,
                       fn)
    return hit


def newton_update(x, dx, f, free, it, err, active, max_iter: int,
                  tol: Tensor) -> None:
    """K3: the per-lane masked update, in place on ``x [B, 2n]``,
    ``it [B]`` (int32), ``err [B]`` and ``active [B]`` (bool).  ``tol``
    is a one-element tensor of x's dtype (the comparison runs in x's
    dtype, as the plain version's)."""
    if x.device.type == "cpu":
        newton_update_plain(x, dx, f, free, it, err, active, max_iter, tol)
        return
    _, ptrs, lanes, m, fn = _update_carry(x, free, it, err, active, tol)
    for name, t in (("dx", dx), ("f", f)):
        if (t.dtype != x.dtype or t.device != x.device or t.shape != x.shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {x.dtype} "
                             f"{tuple(x.shape)} tensor on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    idx = x.get_device()
    ctx = (contextlib.nullcontext() if idx == torch.cuda.current_device()
           else torch.cuda.device(idx))
    with ctx:
        rc = fn(ptrs[0], dx.data_ptr(), f.data_ptr(), ptrs[1], ptrs[2],
                ptrs[3], ptrs[4], ptrs[5], lanes, m, int(max_iter),
                torch._C._cuda_getCurrentRawStream(idx))
    _raise_on(rc, "newton_update")
    _count("newton_update")
