"""Wrappers, plain versions and launch counters of the screening kernels.

==========================  =============================================  =====
wrapper                     replaces                                       route
==========================  =============================================  =====
:func:`smw_screen`          ``freedm_tpu/pf/n1.py`` ``_make_smw_n1_screen``  CUDA
                            (:340-495): the whole ``_solve_lane`` scan
                            with its base triangular solves
:func:`dc_screen`           ``freedm_tpu/pf/dc.py`` ``_screen_impl``       CUDA
                            (:145-184) after its solves; with
                            :func:`dc_flows` the flows of ``_solve_impl``
                            (:131-139)
==========================  =============================================  =====

Both live in ``csrc/screen.cu`` (float64).  A wrapper given CPU tensors
runs its plain PyTorch version; given CUDA tensors it launches its kernel
or raises.  Each launch counts in :data:`LAUNCHES` (D1's also by mode in
:data:`MODE_LAUNCHES`).

N1 runs a whole SMW screen over ``L`` outage lanes (``ks [L]``, int64
branch indices) in one launch: the flat start, ``max_iter`` fast-decoupled
iterations, and the answer ``(θ, V, P, Q, err)``.  Its plain version,
:func:`smw_screen_plain`, is the host loop of :func:`smw_sweep_plain` in
its four modes around the base solves:

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
the branch-wise injections with branch ``k`` out of service.  The base
solves are ``torch.linalg.lu_solve`` by default;
``solve=cache_kernels.lu_solve_mirror`` gives the kernel's own
substitution order (each row's updates one column at a time in column
order, as C1's), which makes the plain screen the kernel's yardstick.

The kernel takes the factors as :func:`smw_factors` lays them out once a
screen (C1's column-major copies, the pivots' inverse permutations and the
reciprocals of U's diagonal) and launches on :func:`smw_plan`, a function
of the bus count alone: the lanes a CTA owns never depend on the batch,
so a lane's bits do not either.

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
                                                    branch_injections,
                                                    kernel_factor,
                                                    lu_permutation)
# D1 keeps a lane's n angles in shared memory.
from freedm_tpu_torch.kernels.sparse_kernels import SMEM_LIMIT

Tensor = torch.Tensor

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"smw_screen": 0, "dc_screen": 0}
#: D1's launches by mode (their sum is its :data:`LAUNCHES`).
MODE_LAUNCHES: Dict[str, Dict[str, int]] = {
    "dc_screen": {"SCREEN": 0, "SOLVE": 0},
}
_launch_lock = threading.Lock()

#: The modes of N1's plain building block :func:`smw_sweep_plain`.
INIT, THETA, V, FINISH = 0, 1, 2, 3
#: D1's modes.
SCREEN, SOLVE = 0, 1

#: |1 − w·aᵀz| below this marks the Sherman–Morrison denominator singular:
#: the outage islands the network (``freedm_tpu/pf/dc.py`` ``_ISLAND_EPS``).
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


class SmwFactors(NamedTuple):
    """The base B′ and B″ ``lu_factor`` pairs ``lu_p``, ``lu_q`` as the
    plain screen takes them, and N1's copies: ``lu`` the two factors
    column-major ``[n, lda]`` (:func:`~freedm_tpu_torch.kernels.cache_kernels.kernel_factor`,
    float64, ``lda`` even), ``pinv [2, n]`` int32 the pivots' inverse
    permutations (row ``pinv[i]`` of ``Pᵀb`` is ``b[i]``) and ``rdiag [2,
    n]`` the reciprocals of U's diagonal, rounded to nearest."""

    lu_p: tuple
    lu_q: tuple
    lu: Tuple[Tensor, Tensor]
    lda: int
    pinv: Tensor
    rdiag: Tensor


def smw_factors(lu_p, lu_q) -> SmwFactors:
    """Lay the base pair out for N1, once a screen, on the pair's device."""
    dev = lu_p[0].device
    lu, pinv, rdiag = [], [], []
    lda = 0
    for lu_mat, piv in (lu_p, lu_q):
        buf, lda = kernel_factor(lu_mat, torch.float64)
        perm = lu_permutation(piv)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(perm.shape[0])
        lu.append(buf)
        pinv.append(inv.to(torch.int32))
        rdiag.append(torch.reciprocal(torch.diagonal(lu_mat)))
    return SmwFactors(lu_p, lu_q, tuple(lu), lda,
                      torch.stack(pinv).to(dev).contiguous(),
                      torch.stack(rdiag).contiguous())


#: Threads of N1's CTA, the shared memory it keeps for its static arrays,
#: the most lanes a CTA and the rows and columns of its tiles (a factor of
#: at most one tile is staged whole for the launch): ``csrc/screen.cu``
#: ``kScreenThreads``, ``kScreenStatic``, ``kMaxLanes``, ``kTile``.
SCREEN_THREADS, SMW_STATIC, SMW_MAX_LANES, SMW_TILE = build.constants(
    "screen.cu", "kScreenThreads", "kScreenStatic", "kMaxLanes", "kTile")


class SmwPlan(NamedTuple):
    """N1's launch: ``lanes`` a CTA (1 or 2), ``whole`` (each factor one
    tile, staged once), ``smem`` dynamic shared bytes a CTA and ``spill``
    (the lanes' vectors in a global work buffer, two lanes a CTA)."""

    lanes: int
    whole: bool
    smem: int
    spill: bool = False


def smw_work(n: int, lanes: int) -> int:
    """The lane vectors of one CTA in float64 values (``csrc/screen.cu``
    ``smw_work``): the right-hand sides ``[rows, lanes]`` (rows: ``n``
    rounded up to the tile), the lanes' θ, V and rotated voltages ``[4, n,
    lanes]`` and both factors' ``1 / u_cc`` ``[2, rows]``."""
    rows = -(-n // SMW_TILE) * SMW_TILE
    return lanes * (rows + 4 * n) + 2 * rows


def smw_smem(n: int, lanes: int, spill: bool = False) -> int:
    """N1's dynamic shared memory a CTA (``csrc/screen.cu`` ``smw_smem``):
    two 64 × 64 float64 tiles, then the lane vectors (:func:`smw_work`)
    unless they spill to global memory."""
    return 8 * (2 * SMW_TILE * SMW_TILE + (0 if spill else smw_work(n, lanes)))


#: The most buses whose lane vectors fit a CTA's shared memory (one lane a
#: CTA); past it N1 takes the spill route.
SMW_SHARED_MAX_N = max(n for n in range(1, 8192)
                       if smw_smem(n, 1) + SMW_STATIC <= SMEM_LIMIT)


def smw_plan(n: int) -> SmwPlan:
    """N1's launch at ``n`` buses — never from the lane count, so a lane's
    bits do not depend on the batch: two lanes a CTA (one where two do not
    fit its shared memory), each factor staged whole where it is one tile.
    A lane's solves are chains of dependent multiply-adds, one warp long in
    each diagonal block, so a CTA's time hardly depends on its lane count
    while warps of more lanes contend for the SM: two lanes a CTA measured
    fastest at mesh511 × 256 and mesh118 × 64 on an H100 (one lane 5-10%
    faster at case14 and case_ieee30, where it doubles the CTAs a wide
    batch needs; ``PERF.md`` §6).  Past :data:`SMW_SHARED_MAX_N` buses the
    spill route: two lanes a CTA, their vectors in global memory (the same
    bits)."""
    if n < 1:
        raise ValueError(f"smw_plan needs n >= 1, got {n}")
    whole = n <= SMW_TILE
    for lanes in (2, 1):
        smem = smw_smem(n, lanes)
        if smem + SMW_STATIC <= SMEM_LIMIT:
            return SmwPlan(lanes, whole, smem)
    return SmwPlan(2, False, smw_smem(n, 2, True), True)


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


def smw_screen_plain(ks: Tensor, op: SmwOperands, lu_p, lu_q,
                     max_iter: int, solve=None):
    """N1's plain version: the whole screen as a host loop, INIT, then
    ``max_iter`` × (base solve, THETA, base solve, V), then FINISH
    (:func:`smw_sweep_plain`).  ``solve(lu, rhs [L, n]) -> [L, n]`` is the
    base solve, ``torch.linalg.lu_solve`` by default; tests pass
    :func:`~freedm_tpu_torch.kernels.cache_kernels.lu_solve_mirror`.
    Returns ``(theta, v, P, Q, err)``."""
    lanes, n = int(ks.shape[0]), op.n
    theta, v, rhs = (torch.empty(lanes, n, dtype=torch.float64,
                                 device=ks.device) for _ in range(3))

    def base(lu):
        if solve is None:
            return torch.linalg.lu_solve(lu[0], lu[1], rhs.mT)
        return solve(lu, rhs).mT

    smw_sweep_plain(INIT, ks, theta, v, rhs, op)
    for _ in range(int(max_iter)):
        smw_sweep_plain(THETA, ks, theta, v, rhs, op, base(lu_p))
        smw_sweep_plain(V, ks, theta, v, rhs, op, base(lu_q))
    p, q, err = smw_sweep_plain(FINISH, ks, theta, v, rhs, op)
    return theta, v, p, q, err


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
    "smw_screen_f64": [_P] * 29 + [_I] * 8 + [_P],
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
    _fn("smw_screen_f64")


def _check_smw_mode(mode: int) -> None:
    if mode not in (INIT, THETA, V, FINISH):
        raise ValueError(f"unknown smw_sweep_plain mode {mode!r}")


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


def _checked_factors(fac: SmwFactors, dev, n: int) -> None:
    f64 = torch.float64
    lda = int(fac.lda)
    if lda < n or lda % 2:
        raise ValueError(f"the factors' leading dimension must be even and "
                         f">= {n}, got {lda}")
    _want(dev, lu_p=(fac.lu[0], f64, (n, lda)), lu_q=(fac.lu[1], f64, (n, lda)),
          pinv=(fac.pinv, torch.int32, (2, n)), rdiag=(fac.rdiag, f64, (2, n)))
    for name, t in (("lu_p", fac.lu[0]), ("lu_q", fac.lu[1])):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


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


def smw_screen_check(ks: Tensor, op: SmwOperands, fac: SmwFactors,
                     max_iter: int, plan: SmwPlan, dev) -> None:
    """Everything :func:`smw_screen` checks before its launch, for
    ``dev``: the lanes, the plan and every operand's device, dtype, shape
    and contiguity."""
    n = op.n
    if ks.dim() != 1 or ks.shape[0] < 1:
        raise ValueError(f"ks must be a [L] tensor of at least one outage, "
                         f"got {tuple(ks.shape)}")
    _want(dev, ks=(ks, torch.int64, (int(ks.shape[0]),)))
    if int(max_iter) < 0:
        raise ValueError(f"max_iter must be >= 0, got {max_iter}")
    lanes, spill = int(plan.lanes), bool(plan.spill)
    if (lanes < 1 or lanes > SMW_MAX_LANES or lanes & (lanes - 1)
            or (plan.whole and (n > SMW_TILE or spill))
            or (spill and lanes != 2)
            or int(plan.smem) != smw_smem(n, lanes, spill)
            or plan.smem + SMW_STATIC > SMEM_LIMIT):
        raise ValueError(f"smw_screen has no plan {plan} at n = {n}")
    _check_once(op, dev, _checked_smw)
    _checked_factors(fac, dev, n)


def smw_screen(ks: Tensor, op: SmwOperands, fac: SmwFactors, max_iter: int,
               plan: Optional[SmwPlan] = None):
    """N1: the whole SMW screen of the outage lanes ``ks [L]`` (int64), in
    one launch (the module docstring): ``max_iter`` fast-decoupled
    iterations from the flat start on the base pair of ``fac``.  Returns
    ``(theta, v, P, Q [L, n], err [L])``.  ``plan`` forces a launch
    (default :func:`smw_plan`); a lane's bits are the same on every plan
    and batch width, and on the spill route."""
    if ks.device.type == "cpu":
        return smw_screen_plain(ks, op, fac.lu_p, fac.lu_q, max_iter)
    if ks.device.type != "cuda":
        raise ValueError(f"smw_screen runs on CPU or CUDA tensors, got "
                         f"{ks.device}")
    dev = ks.device
    n, m = op.n, op.m
    plan = smw_plan(n) if plan is None else plan
    smw_screen_check(ks, op, fac, max_iter, plan, dev)
    lanes = int(ks.shape[0])
    slots = -(-lanes // plan.lanes) * plan.lanes
    if slots > lanes:  # the last CTA's spare slots repeat the last lane
        ks = torch.cat([ks, ks[-1:].expand(slots - lanes)])
    f64 = torch.float64
    theta, v, p, q = (torch.empty(slots, n, dtype=f64, device=dev)
                      for _ in range(4))
    err = torch.empty(slots, dtype=f64, device=dev)
    work = (torch.empty(slots // plan.lanes * smw_work(n, plan.lanes),
                        dtype=f64, device=dev) if plan.spill else None)
    d = op.dop
    with torch.cuda.device(dev):
        rc = _fn("smw_screen_f64")(
            ks.data_ptr(), theta.data_ptr(), v.data_ptr(), p.data_ptr(),
            q.data_ptr(), err.data_ptr(), fac.lu[0].data_ptr(),
            fac.lu[1].data_ptr(), fac.pinv[0].data_ptr(),
            fac.pinv[1].data_ptr(), fac.rdiag[0].data_ptr(),
            fac.rdiag[1].data_ptr(), d.inc_ptr.data_ptr(),
            d.inc_code.data_ptr(), d.inc_nbr.data_ptr(), d.y.data_ptr(),
            d.g_sh.data_ptr(), d.b_sh.data_ptr(), d.th_free.data_ptr(),
            d.v_free.data_ptr(), op.v_set.data_ptr(), op.p_sched.data_ptr(),
            op.q_sched.data_ptr(), d.f.data_ptr(), d.t.data_ptr(),
            op.mask.data_ptr(), op.zm.data_ptr(), op.cap.data_ptr(),
            None if work is None else work.data_ptr(), n, m, int(fac.lda),
            slots, int(plan.lanes), int(plan.whole), int(plan.spill),
            int(max_iter), _stream(ks))
    _raise_on(rc, "smw_screen")
    _count("smw_screen")
    return theta[:lanes], v[:lanes], p[:lanes], q[:lanes], err[:lanes]


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
