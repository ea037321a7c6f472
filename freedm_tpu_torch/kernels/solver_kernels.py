"""Wrappers, plain versions and launch counters of the solver kernels.

==========================  =============================================  =====
wrapper                     replaces                                       route
==========================  =============================================  =====
:func:`ybus_stamp`          ``freedm_tpu/grid/bus.py`` ``ybus_dense(sys,   CUDA
                            status)`` (:130-158) per lane; the lane forms
                            of ``pf/fdlf.py`` ``b_prime``/``b_dblprime``
                            (:70-90)
:func:`fdlf_half_step`      ``freedm_tpu/pf/fdlf.py`` ``_step`` around its  CUDA
                            LU solves (:167-179), ``_mismatch``,
                            ``_err_from`` (:128-138) and the lane select
                            of ``_solve_impl`` (:186-205)
:func:`residual_jvp`        the ``jax.linearize`` JVP of the residual in   CUDA
                            ``freedm_tpu/pf/krylov.py`` (:594-608,
                            :643-687) over ``pf/mfree.py:34-65``
:func:`cim_iterate`         ``freedm_tpu/pf/cim.py`` ``_matvec`` and       CUDA
                            ``_iterate`` (:157-170) with the loop's
                            ``max |v_new − v|`` (:195-240)
:func:`residual_vjp`        the reverse mode of the residual and the       CUDA
                            injections under ``jax.grad`` of the fixed
                            solves (``pf/newton.py:341-352``,
                            ``pf/krylov.py:594``, ``pf/fdlf.py:207``)
:func:`cim_vjp`,            the reverse mode of ``_iterate``               CUDA
:func:`cim_vjp_walk`        (``freedm_tpu/pf/cim.py:163``) under
                            ``jax.grad`` of ``_solve_fixed`` (:215): one
                            iteration, or every iteration of a backward in
                            one launch
==========================  =============================================  =====

All six live in ``csrc/solvers.cu`` (float64 and float32).  As in the
other kernel modules, a wrapper given CPU tensors runs its plain PyTorch
version; given CUDA tensors it launches its kernel or raises.  Each
launch counts in :data:`LAUNCHES` (Y1 and F1 also by mode).

Layouts: Y1 writes ``[L, n, n]`` per output; F1 works in place on the
Newton state ``x [B, 2n]`` (θ ‖ V), the carried mismatch ``dp``, ``dq
[B, n]`` and the lane carry ``err [B]``, ``it [B]`` (int32), ``active
[B]`` (bool); its ``y`` is ``[n, n]`` (one for every lane) or ``[B, n,
n]``.  J1 takes the sparse backend's
:class:`~freedm_tpu_torch.kernels.sparse_kernels.SparseOperands` (the
incidence list with each entry's mutual and self admittance) and returns
``[B, 2n]``.  I1 works on the three-phase load-node voltages as (re, im)
pairs of ``[B, N]`` tensors, ``N = 3 nb``.  J2 is J1's transpose on the
same operands plus :class:`VjpOperands`.  On the card J1 and J2 take the
route of :func:`residual_plan` (a function of the shape alone; ``plan=``
forces one): the staged route walks the operands' :class:`ResidualLayout`
(built at the first staged launch on an operand set and kept with it),
the wide route reads the CSR list; both give a lane the same bits
(:func:`residual_mirror` is the staged walk on the host, for the tests),
and :data:`ROUTE_LAUNCHES` counts their launches by route.  I2 walks I1's
iterations back
on the staged ``Aᴴ`` (:func:`cim_adjoint_matrix`): one a call
(:func:`cim_vjp`), or the saved iterates ``vs [k + 1, 2, B, N]`` of a
whole fixed solve in one launch (:func:`cim_vjp_walk`, a function of the
shape alone: :func:`cim_walk_plan`).
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from freedm_tpu_torch.kernels import build
from freedm_tpu_torch.kernels.newton_kernels import (TILE_K, TILE_LANES,
                                                     TILE_ROWS,
                                                     injections_plain,
                                                     product_scratch)
from freedm_tpu_torch.kernels.sparse_kernels import (SparseOperands,
                                                     _launch_on, _need_cuda,
                                                     _op_ptrs, _raise_on,
                                                     _want)

Tensor = torch.Tensor

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {
    "ybus_stamp": 0,
    "fdlf_half_step": 0,
    "residual_jvp": 0,
    "cim_iterate": 0,
    "residual_vjp": 0,
    "cim_vjp": 0,
}

#: Y1's modes: Ybus ``(re, im)``; B′ (1/x scaled by status, pinned by
#: ``th_free``); B″ (−Im Ybus, pinned by ``v_free``).
YBUS, BPRIME, BDBL = 0, 1, 2
#: F1's modes: the start point's mismatch; the θ half; the V half.
INIT, THETA, VHALF = 0, 1, 2
#: J2's modes: the transpose of the masked residual's Jacobian (J1's;
#: pinned rows pass through), and the injections' VJP over every row.
MASKED, FULL = 0, 1
#: F1 takes K2's tiled product (``csrc/row_product.cuh``) for one Ybus of
#: every lane from this many lanes; below, a 64-lane tile would idle and a
#: warp a (lane, row) reads Ybus once a lane.
TILED_MIN_LANES = 4
#: F1's warp form: warps a CTA (``csrc/solvers.cu``'s block of 256
#: threads), the CTAs a launch aims at (two to each of an H100's 132 SMs:
#: at mesh2000 × 2 lanes 250 CTAs ran its V half in 0.0356 ms, 500 in
#: 0.0570), the most rows a CTA takes and the shared memory its lane's V
#: parts may fill (``csrc/solvers.cu``), and the most buses it takes by
#: dtype (``2 n`` values of V parts a CTA).
FDLF_WARPS = 8
FDLF_TARGET_CTAS = 2 * 132
FDLF_MAX_ROWS, FDLF_WARP_SMEM = build.constants("solvers.cu", "kF1MaxRows",
                                                "kF1SmemMax")
FDLF_WARP_MAX_N = {torch.float64: FDLF_WARP_SMEM // 16,
                   torch.float32: FDLF_WARP_SMEM // 8}
#: I2's work items a product phase (``csrc/solvers.cu``): one resident CTA
#: on each of an H100's 132 SMs.
(WALK_ITEMS,) = build.constants("solvers.cu", "kWalkItems")
#: J1's and J2's staged route (``csrc/solvers.cu``): the most lanes a CTA
#: stages, the slots of a slice of :class:`ResidualLayout` (a warp's), and
#: the shared memory a CTA may use.
RES_MAX_LANES, RES_SLICE, RES_SMEM = build.constants(
    "solvers.cu", "kResMaxLanes", "kResSlice", "kResSmemMax")
#: The CTAs a staged launch aims at: one on each of an H100's 132 SMs.
RES_TARGET_CTAS = 132
#: J1's and J2's routes: a CTA stages whole lanes in shared memory and
#: walks :class:`ResidualLayout`; or a thread a (lane, bus) reads its
#: neighbours from global memory (the route for a lane that does not fit).
STAGED, WIDE = "staged", "wide"
_MODES = {"ybus_stamp": ("YBUS", "BPRIME", "BDBL"),
          "fdlf_half_step": ("INIT", "THETA", "V"),
          "residual_vjp": ("MASKED", "FULL")}
#: Y1's, F1's and J2's launches by mode (their sums are in
#: :data:`LAUNCHES`).
MODE_LAUNCHES: Dict[str, Dict[str, int]] = {
    k: dict.fromkeys(v, 0) for k, v in _MODES.items()}
#: J1's and J2's launches by route (:data:`STAGED`, :data:`WIDE`).
ROUTE_LAUNCHES: Dict[str, Dict[str, int]] = {
    k: {STAGED: 0, WIDE: 0} for k in ("residual_jvp", "residual_vjp")}
_launch_lock = threading.Lock()


def _count(name: str, mode: Optional[int] = None,
           route: Optional[str] = None) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1
        if mode is not None:
            MODE_LAUNCHES[name][_MODES[name][mode]] += 1
        if route is not None:
            ROUTE_LAUNCHES[name][route] += 1


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        for counts in (*MODE_LAUNCHES.values(), *ROUTE_LAUNCHES.values()):
            for k in counts:
                counts[k] = 0


def launches() -> Dict[str, int]:
    with _launch_lock:
        return dict(LAUNCHES)


def mode_launches() -> Dict[str, Dict[str, int]]:
    with _launch_lock:
        return {k: dict(v) for k, v in MODE_LAUNCHES.items()}


def route_launches() -> Dict[str, Dict[str, int]]:
    with _launch_lock:
        return {k: dict(v) for k, v in ROUTE_LAUNCHES.items()}


class StampOperands(NamedTuple):
    """What Y1 needs of one bus system, on one device, in one dtype.

    The bus-sorted incidence list of
    :func:`~freedm_tpu_torch.pf.sparse.jacobian_pattern` (int32 CSR
    ``inc_ptr [n+1]``, ``inc_code [2m]`` = 2·edge + side, ``inc_nbr
    [2m]``), the branch ends ``f``, ``t [m]`` (int64, the plain version's
    scatters), the two-port admittances ``br [8, m]`` (rows ``yff, yft,
    ytf, ytt`` as (re, im), all in service, stamped on the host in
    float64), ``inv_x [m]`` = 1/x, the bus shunts ``g_sh``, ``b_sh`` and
    the masks ``th_free``, ``v_free [n]``."""

    inc_ptr: Tensor
    inc_code: Tensor
    inc_nbr: Tensor
    f: Tensor
    t: Tensor
    br: Tensor
    inv_x: Tensor
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


class VjpOperands(NamedTuple):
    """What J2 needs beside :class:`SparseOperands`: per incidence-list
    entry the mutual admittance of the same branch's other end (the
    entry's transpose in J), ``inc_gt``/``inc_bt [2m]``, and the list
    position of that other end, ``inc_pair [2m]`` (int64)."""

    inc_gt: Tensor
    inc_bt: Tensor
    inc_pair: Tensor


def vjp_operands(op: SparseOperands) -> VjpOperands:
    """J2's :class:`VjpOperands` for ``op`` (same device and dtype)."""
    code = op.inc_code.long()
    pos = torch.empty_like(code)
    pos[code] = torch.arange(code.numel(), device=code.device)
    pair = pos[code ^ 1]
    return VjpOperands(op.inc_g[pair].contiguous(),
                       op.inc_b[pair].contiguous(), pair)


class ResidualLayout(NamedTuple):
    """J1's and J2's incidence operands as a sliced ELL, a function of the
    incidence list alone (:func:`residual_layout`).  The buses, sorted by
    degree (largest first, stable), fill slots of which each
    :data:`RES_SLICE` make a slice (a warp's): ``slot [K, 2]`` int32 holds
    slot ``k``'s (bus, degree), (−1, 0) past the last bus, and ``where
    [n]`` int32 each bus's slot.  Entry ``t`` of
    slot ``k`` (its bus's ``t``-th CSR entry) sits at ``slice_base[k //
    32] + 32 t + k % 32``, so a warp's ``t``-th step reads consecutive
    entries: ``idx [E, 2]`` int32 (code, neighbour) and ``val [E, V]``
    (``g, b, gs, bs`` for J1; J2 also ``gt, bt``).  A slice is padded to
    its first slot's degree: padding has ``idx`` −1 and values 0, and a
    slot walks its own degree, never the padding."""

    slot: Tensor
    slice_base: Tensor
    where: Tensor
    idx: Tensor
    val: Tensor

    @property
    def entries(self) -> int:
        return int(self.idx.shape[0])


def residual_layout(op: SparseOperands,
                    vop: Optional[VjpOperands] = None) -> ResidualLayout:
    """``op``'s :class:`ResidualLayout` on its device and in its dtype:
    J1's four values an entry, or J2's six with ``vop``."""
    n, dev = op.n, op.inc_ptr.device
    ptr = op.inc_ptr.long().cpu()
    deg = torch.diff(ptr)
    slices = -(-n // RES_SLICE)
    order = torch.sort(deg, descending=True, stable=True).indices
    slot = torch.full((slices * RES_SLICE, 2), -1, dtype=torch.int64)
    slot[:n, 0] = order
    slot[:n, 1] = deg[order]
    slot[n:, 1] = 0
    width = slot[::RES_SLICE, 1]  # a slice's first slot is its widest
    base = torch.zeros(slices + 1, dtype=torch.int64)
    base[1:] = torch.cumsum(RES_SLICE * width, 0)
    entries = int(base[-1])
    if entries >= 2**31:
        raise ValueError(f"the residual layout holds {entries} entries; "
                         f"int32 offsets take < 2^31")
    where = torch.empty(n, dtype=torch.int64)  # each bus's slot
    where[order] = torch.arange(n)
    rows = torch.repeat_interleave(torch.arange(n), deg)
    t = torch.arange(rows.numel()) - ptr[rows]
    k = where[rows]
    pos = (base[k // RES_SLICE] + RES_SLICE * t + k % RES_SLICE).to(dev)
    idx = torch.full((entries, 2), -1, dtype=torch.int32, device=dev)
    idx[pos, 0] = op.inc_code
    idx[pos, 1] = op.inc_nbr
    cols = [op.inc_g, op.inc_b, op.inc_gs, op.inc_bs]
    if vop is not None:
        cols += [vop.inc_gt, vop.inc_bt]
    val = torch.zeros(entries, len(cols), dtype=op.inc_g.dtype, device=dev)
    val[pos] = torch.stack(cols, dim=1)
    i32 = torch.int32
    return ResidualLayout(slot.to(device=dev, dtype=i32),
                          base.to(device=dev, dtype=i32),
                          where.to(device=dev, dtype=i32), idx, val)


class ResidualPlan(NamedTuple):
    """J1's or J2's launch: the route (:data:`STAGED` or :data:`WIDE`);
    on the staged route ``lanes_per_cta`` lanes staged a CTA,
    ``ctas_per_lane`` CTAs a lane group (each stages the group's whole
    lanes and walks its share of the slices) and ``smem`` bytes of shared
    memory a CTA."""

    route: str
    lanes_per_cta: int
    ctas_per_lane: int
    smem: int


def residual_stage_bytes(n: int, m: int, dtype: torch.dtype,
                         status: bool) -> int:
    """Shared memory one lane takes on the staged route: six values a bus
    (J1: Vc, dVc and the bus's two sums; J2: Vc, the masked ω and the
    gradient in Vc) and, with a per-lane ``status``, its ``[m]`` row."""
    if dtype not in (torch.float64, torch.float32):
        raise TypeError(f"kernels take float64 or float32, got {dtype}")
    itemsize = 8 if dtype == torch.float64 else 4
    return itemsize * (6 * int(n) + (int(m) if status else 0))


@functools.lru_cache(maxsize=256)
def residual_plan(n: int, m: int, lanes: int, dtype: torch.dtype,
                  status: bool, lanes_per_cta: Optional[int] = None,
                  ctas_per_lane: Optional[int] = None,
                  route: Optional[str] = None) -> ResidualPlan:
    """J1's and J2's launch at ``lanes`` lanes of ``n`` buses and ``m``
    branches, a function of these arguments alone.  By default: the
    staged route where one lane's stage fits :data:`RES_SMEM`, else
    :data:`WIDE`; the fewest lanes a CTA (at most :data:`RES_MAX_LANES`,
    and as fit) that let every CTA be resident at once —
    :data:`RES_TARGET_CTAS` of them, twice that in float32 where two fit
    an SM's shared memory (a float32 CTA takes 47-64 registers a thread,
    a float64 one more than 64: one CTA of 512 threads an SM); and, where
    the lane groups are fewer than that, each group's slices dealt to that
    many CTAs (at most one slice each).  On the H100 at mesh2000 this is
    2 lanes a CTA in float64 at 256 lanes, 1 in float32 and with status,
    and 2 CTAs a lane at 64 lanes: the fastest of the plans timed there.
    ``lanes_per_cta``, ``ctas_per_lane`` and ``route`` force a plan
    (raising where it does not fit).  No choice changes a bit: every
    route walks each bus's entries in CSR order with the same roundings."""
    n, m, lanes = int(n), int(m), int(lanes)
    if n < 1 or m < 0 or lanes < 1:
        raise ValueError(f"residual_plan needs n, lanes >= 1 and m >= 0, "
                         f"got {n}, {lanes}, {m}")
    per = residual_stage_bytes(n, m, dtype, status)
    fit = min(RES_MAX_LANES, RES_SMEM // per)
    if route is None:
        route = STAGED if fit >= 1 else WIDE
    if route == WIDE:
        if lanes_per_cta not in (None, 1) or ctas_per_lane not in (None, 1):
            raise ValueError("the wide route takes a thread a (lane, bus)")
        return ResidualPlan(WIDE, 1, 1, 0)
    if route != STAGED:
        raise ValueError(f"unknown residual route {route!r}")
    slices = -(-n // RES_SLICE)

    def resident(lpc):  # CTAs an SM holds at once
        f32 = dtype == torch.float32 and 2 * lpc * per <= RES_SMEM
        return RES_TARGET_CTAS * (2 if f32 else 1)

    lpc = lanes_per_cta
    if lpc is None:
        lpc = next((k for k in range(1, fit + 1)
                    if -(-lanes // k) <= resident(k)), max(fit, 1))
    lpc = int(lpc)
    if not 1 <= lpc <= fit:
        raise ValueError(
            f"the staged route takes 1 to {fit} lanes a CTA at n = {n}, "
            f"m = {m}, {dtype}, status {status} ({per} bytes a lane of "
            f"{RES_SMEM}), got {lpc}")
    groups = -(-lanes // lpc)
    cpl = (max(1, min(slices, resident(lpc) // groups))
           if ctas_per_lane is None else int(ctas_per_lane))
    if not 1 <= cpl <= slices:
        raise ValueError(f"the staged route deals {slices} slices to 1 to "
                         f"{slices} CTAs a lane, got {cpl}")
    return ResidualPlan(STAGED, lpc, cpl, lpc * per)


class FdlfWarpPlan(NamedTuple):
    """F1's warp-form launch: ``rows`` consecutive rows of one lane a CTA,
    ``ctas`` CTAs a lane, ``smem`` bytes of V parts a CTA."""

    rows: int
    ctas: int
    smem: int


def fdlf_warp_plan(n: int, lanes: int, dtype: torch.dtype) -> FdlfWarpPlan:
    """The rows a CTA of F1's one-launch warp form takes: a multiple of
    :data:`FDLF_WARPS`, the fewest that keep the launch near
    :data:`FDLF_TARGET_CTAS` CTAs (each CTA forms its lane's whole V in
    shared memory, so fewer CTAs a lane repeat that less).  The rows' bits
    do not depend on it.  Raises above :data:`FDLF_WARP_MAX_N` buses."""
    n, lanes = int(n), int(lanes)
    if n < 1 or lanes < 1:
        raise ValueError(f"fdlf_warp_plan needs n, lanes >= 1, got {n}, "
                         f"{lanes}")
    if dtype not in FDLF_WARP_MAX_N:
        raise TypeError(f"kernels take float64 or float32, got {dtype}")
    if n > FDLF_WARP_MAX_N[dtype]:
        raise ValueError(
            f"fdlf_half_step's warp form takes at most "
            f"{FDLF_WARP_MAX_N[dtype]} buses in {dtype} (its lane's V in "
            f"shared memory), got {n}")
    per_warp = max(1, math.ceil(lanes * n / (FDLF_TARGET_CTAS * FDLF_WARPS)))
    rows = min(FDLF_WARPS * per_warp, FDLF_WARPS * math.ceil(n / FDLF_WARPS),
               FDLF_MAX_ROWS)
    itemsize = 8 if dtype == torch.float64 else 4
    return FdlfWarpPlan(rows, math.ceil(n / rows), 2 * n * itemsize)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the on-card comparison's reference)
# ---------------------------------------------------------------------------


def _scatter_add(lanes: int, n: int, rows: Tensor, cols: Tensor,
                 vals: Tensor) -> Tensor:
    """``[lanes, n, n]`` zeros with ``vals [lanes, k]`` added at ``(rows,
    cols) [k]`` of each lane, one addition after another in ``k``'s order
    (the reference's scatter order)."""
    out = vals.new_zeros(lanes * n * n)
    base = torch.arange(lanes, device=vals.device)[:, None] * (n * n)
    idx = (base + (rows * n + cols)[None, :]).reshape(-1)
    out.index_add_(0, idx, vals.reshape(-1))
    return out.view(lanes, n, n)


def _pin(mat: Tensor, keep: Tensor) -> Tensor:
    """Pinned rows and columns become identity, as the reference writes it:
    ``m * keep[:, None] * keep[None, :] + diag(1 − keep)``."""
    return mat * keep[:, None] * keep[None, :] + torch.diag(1.0 - keep)


def ybus_stamp_plain(mode: int, op: StampOperands, status: Tensor):
    """Y1's plain version: ``(y_re, y_im)`` in :data:`YBUS` mode, else one
    ``[L, n, n]`` tensor for ``status [L, m]``.  The stamps run in the
    reference's order: ff, tt, ft, tf, then the shunt diagonal."""
    _check_stamp_mode(mode)
    n, lanes, on = op.n, status.shape[0], status
    f, t = op.f, op.t
    if mode == BPRIME:
        w = op.inv_x * on
        mat = _scatter_add(lanes, n, torch.cat([f, t, f, t]),
                           torch.cat([f, t, t, f]),
                           torch.cat([w, w, -w, -w], dim=1))
        return _pin(mat, op.th_free)
    y = op.br[:, None, :] * on[None]  # [8, L, m]

    def stamp(part):
        return _scatter_add(lanes, n, torch.cat([f, t, f, t]),
                            torch.cat([f, t, t, f]),
                            torch.cat([y[part], y[6 + part], y[2 + part],
                                       y[4 + part]], dim=1))

    y_im = stamp(1) + torch.diag(op.b_sh)
    if mode == BDBL:
        return _pin(-y_im, op.v_free)
    return stamp(0) + torch.diag(op.g_sh), y_im


def fdlf_half_step_plain(mode: int, x, d, y_re, y_im, ps, qs, th_free,
                         v_free, dp, dq, err, it, active, tol: Tensor,
                         max_iter: int, fixed: bool) -> None:
    """F1's plain version (in place on ``x``, ``dp``, ``dq`` and the lane
    carry; the module docstring's modes).  The half's state is formed out
    of place and copied into ``x``, so that ``torch.autograd`` records the
    iteration: the injections save the new state, which no later half
    writes."""
    _check_fdlf_mode(mode)
    n = dp.shape[1]
    live = active[:, None]
    theta, v = x[:, :n], x[:, n:]
    if mode == THETA:
        theta = torch.where(live, theta + d * th_free, theta)
    elif mode == VHALF:
        v = torch.where(live, v + d * v_free, v)
    xn = torch.cat([theta, v], dim=1)
    if mode != INIT:
        x.copy_(xn)
    theta, v = xn[:, :n], xn[:, n:]
    p, q = injections_plain(v * torch.cos(theta), v * torch.sin(theta), y_re,
                            y_im)
    dpi = (ps - p) / v * th_free
    dqi = (qs - q) / v * v_free
    if mode == INIT:
        dp.copy_(dpi)
        dq.copy_(dqi)
        return
    if mode == THETA:
        dq.copy_(dqi)
        return
    dp.copy_(torch.where(live, dpi, dp))
    e = torch.maximum(torch.amax(torch.abs(dpi * v), dim=1),
                      torch.amax(torch.abs(dqi * v), dim=1))
    _finish_plain(e, err, it, active, tol, max_iter, fixed)


def _finish_plain(e, err, it, active, tol, max_iter, fixed) -> None:
    """The lane finish of F1's V mode and I1: on active lanes ``it + 1``
    and ``err = e``; then, unless ``fixed``, ``active = it < max_iter and
    err >= tol``."""
    it.add_(active.to(it.dtype))
    err.copy_(torch.where(active, e.to(err.dtype), err))
    if not fixed:
        active.copy_((it < max_iter) & (err >= tol))


def residual_jvp_plain(x: Tensor, u: Tensor, op: SparseOperands,
                       status: Optional[Tensor] = None) -> Tensor:
    """J1's plain version: ``J u [B, 2n]``, the derivative of the masked
    residual at ``x`` along ``u``, written out branch end by branch end
    (the kernel's arithmetic; not ``torch.func``, so that it stays the
    kernel's yardstick)."""
    n = op.n
    rows = op.inc_rows()
    j = op.inc_nbr.long()
    side = (op.inc_code & 1).bool()
    theta, v, dth, dv = x[:, :n], x[:, n:], u[:, :n], u[:, n:]
    c, s = torch.cos(theta), torch.sin(theta)
    vc = (v * c, v * s)
    dvc = (dv * c - vc[1] * dth, dv * s + vc[0] * dth)
    ys, ym = (op.inc_gs, op.inc_bs), (op.inc_g, op.inc_b)
    if status is not None:
        on = status[:, (op.inc_code >> 1).long()]
        ys, ym = (ys[0] * on, ys[1] * on), (ym[0] * on, ym[1] * on)

    def at(a, idx):
        return a[0][:, idx], a[1][:, idx]

    def mul(a, b):
        return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]

    def add(a, b):
        return a[0] + b[0], a[1] + b[1]

    def mul_conj(a, b):  # a · conj(b)
        return a[0] * b[0] + a[1] * b[1], a[1] * b[0] - a[0] * b[1]

    vi, vj, dvi, dvj = at(vc, rows), at(vc, j), at(dvc, rows), at(dvc, j)
    cur = add(mul(ys, vi), mul(ym, vj))
    dcur = add(mul(ys, dvi), mul(ym, dvj))
    ds = add(mul_conj(dvi, cur), mul_conj(vi, dcur))

    def seg(vals, pick):
        out = vals.new_zeros(vals.shape[0], n)
        return out.index_add_(1, rows, torch.where(pick, vals,
                                                   torch.zeros_like(vals)))

    d_p = seg(ds[0], ~side) + seg(ds[0], side)
    d_q = seg(ds[1], ~side) + seg(ds[1], side)
    vdv = 2.0 * v * dv
    d_p = d_p + op.g_sh * vdv
    d_q = d_q - op.b_sh * vdv
    return torch.cat([torch.where(op.th_free > 0, d_p, dth),
                      torch.where(op.v_free > 0, d_q, dv)], dim=1)


def residual_vjp_plain(x: Tensor, w: Tensor, op: SparseOperands,
                       vop: VjpOperands, mode: int,
                       status: Optional[Tensor] = None) -> Tensor:
    """J2's plain version: ``wᵀ ∂F/∂x [B, 2n]`` at ``x`` for ``w [B,
    2n]`` — in :data:`MASKED` mode ``F`` is the masked residual (J1's
    transpose), in :data:`FULL` mode the injections ``(P, Q)`` of every
    bus.  Written out entry by entry as the kernel computes it: with
    ``ω = w_P + j w_Q`` (masked to the free rows in :data:`MASKED` mode)
    and ``Vc = V e^{jθ}``, each incidence entry at bus ``k`` (neighbour
    ``j``) adds to the gradient in ``Vc_k``

        conj(ω_k y_self) Vc_k + ω_k I + conj(ω_j y_mut′) Vc_j,

    ``I = y_self Vc_k + y_mut Vc_j`` its branch current and ``y_mut′`` the
    other end's mutual admittance; the shunts add ``2 V (ω_P g − ω_Q b)``
    to ``V̄``; pinned rows of :data:`MASKED` mode pass ``w`` through."""
    _check_vjp_mode(mode)
    n = op.n
    rows = op.inc_rows()
    j = op.inc_nbr.long()
    theta, v = x[:, :n], x[:, n:]
    c, s = torch.cos(theta), torch.sin(theta)
    vr, vi = v * c, v * s
    w_p, w_q = w[:, :n], w[:, n:]
    if mode == MASKED:
        o_r = torch.where(op.th_free > 0, w_p, torch.zeros_like(w_p))
        o_i = torch.where(op.v_free > 0, w_q, torch.zeros_like(w_q))
    else:
        o_r, o_i = w_p, w_q
    ysr, ysi, ymr, ymi = op.inc_gs, op.inc_bs, op.inc_g, op.inc_b
    ytr, yti = vop.inc_gt, vop.inc_bt
    if status is not None:
        on = status[:, (op.inc_code >> 1).long()]
        ysr, ysi, ymr, ymi = ysr * on, ysi * on, ymr * on, ymi * on
        ytr, yti = ytr * on, yti * on
    kr, ki, jr, ji = vr[:, rows], vi[:, rows], vr[:, j], vi[:, j]
    okr, oki, ojr, oji = o_r[:, rows], o_i[:, rows], o_r[:, j], o_i[:, j]
    ir = (ysr * kr - ysi * ki) + (ymr * jr - ymi * ji)
    ii = (ysr * ki + ysi * kr) + (ymr * ji + ymi * jr)
    ar, ai = okr * ysr - oki * ysi, okr * ysi + oki * ysr
    br, bi = ojr * ytr - oji * yti, ojr * yti + oji * ytr
    t_r = ((ar * kr + ai * ki) + (okr * ir - oki * ii)) + (br * jr + bi * ji)
    t_i = ((ar * ki - ai * kr) + (okr * ii + oki * ir)) + (br * ji - bi * jr)
    g_r = t_r.new_zeros(t_r.shape[0], n).index_add_(1, rows, t_r)
    g_i = t_i.new_zeros(t_i.shape[0], n).index_add_(1, rows, t_i)
    d_th = v * (g_i * c - g_r * s)
    d_v = (g_r * c + g_i * s) + 2.0 * v * (o_r * op.g_sh - o_i * op.b_sh)
    if mode == MASKED:
        d_th = torch.where(op.th_free > 0, d_th, d_th + w_p)
        d_v = torch.where(op.v_free > 0, d_v, d_v + w_q)
    return torch.cat([d_th, d_v], dim=1)


def residual_mirror(x: Tensor, u: Tensor, op: SparseOperands,
                    layout: ResidualLayout, plan: ResidualPlan, vjp: bool,
                    mode: int = MASKED,
                    status: Optional[Tensor] = None) -> Tensor:
    """The staged route's walk on the host, for the tests: J1 (``u`` the
    tangent) or J2 (``vjp``, ``u`` the cotangent ``w``, in ``mode``) CTA
    by CTA of ``plan`` over ``layout`` — each lane's staged pairs, then
    each slot's entries step by step in CSR order, read through the
    layout, with the plain version's expressions and roundings (the
    kernels fuse the multiply-adds that ``csrc/solvers.cu``'s ``dotp`` and
    ``dotm`` write out, so they agree with it within rounding).  Entries
    no CTA writes stay NaN."""
    n = op.n
    lanes = x.shape[0]
    lpc, cpl = plan.lanes_per_cta, plan.ctas_per_lane
    slices = -(-n // RES_SLICE)
    slot = layout.slot.long()
    base = layout.slice_base.long()
    theta, v = x[:, :n], x[:, n:]
    c, s = torch.cos(theta), torch.sin(theta)
    sa = (v * c, v * s)
    if vjp:
        w_p, w_q = u[:, :n], u[:, n:]
        if mode == MASKED:
            sb = (torch.where(op.th_free > 0, w_p, torch.zeros_like(w_p)),
                  torch.where(op.v_free > 0, w_q, torch.zeros_like(w_q)))
        else:
            sb = (w_p, w_q)
    else:
        dth, dv = u[:, :n], u[:, n:]
        sb = (dv * c - sa[1] * dth, dv * s + sa[0] * dth)
    out = torch.full_like(x, float("nan"))
    for g in range(-(-lanes // lpc)):
        ls = slice(g * lpc, min(lanes, (g + 1) * lpc))
        for part in range(cpl):
            k = torch.cat([torch.arange(sl * RES_SLICE, (sl + 1) * RES_SLICE)
                           for sl in range(part, slices, cpl)])
            k = k[slot[k, 0] >= 0]
            bus, deg = slot[k, 0], slot[k, 1]
            first = base[k // RES_SLICE] + k % RES_SLICE
            own = [a[ls][:, bus] for a in sa + sb]
            acc = [torch.zeros_like(own[0]) for _ in range(2 if vjp else 4)]
            for t in range(int(deg.max())):
                live = deg > t
                e = first[live] + RES_SLICE * t
                code = layout.idx[e, 0].long()
                j = layout.idx[e, 1].long()
                yv = [layout.val[e, q] for q in range(6 if vjp else 4)]
                if status is not None:
                    on = status[ls][:, code >> 1]
                    yv = [y * on for y in yv]
                ymr, ymi, ysr, ysi = yv[:4]
                kr, ki, okr, oki = (o[:, live] for o in own)
                jr, ji = sa[0][ls][:, j], sa[1][ls][:, j]
                ojr, oji = sb[0][ls][:, j], sb[1][ls][:, j]
                ir = (ysr * kr - ysi * ki) + (ymr * jr - ymi * ji)
                ii = (ysr * ki + ysi * kr) + (ymr * ji + ymi * jr)
                if vjp:
                    ytr, yti = yv[4:]
                    ar, ai = okr * ysr - oki * ysi, okr * ysi + oki * ysr
                    br, bi = ojr * ytr - oji * yti, ojr * yti + oji * ytr
                    terms = (((ar * kr + ai * ki) + (okr * ir - oki * ii))
                             + (br * jr + bi * ji),
                             ((ar * ki - ai * kr) + (okr * ii + oki * ir))
                             + (br * ji - bi * jr))
                    for q, term in enumerate(terms):
                        acc[q][:, live] = acc[q][:, live] + term
                    continue
                # J1: kr, ki = Vc and okr, oki = dVc of the slot's bus
                dir_ = (ysr * okr - ysi * oki) + (ymr * ojr - ymi * oji)
                dii = (ysr * oki + ysi * okr) + (ymr * oji + ymi * ojr)
                terms = ((okr * ir + oki * ii) + (kr * dir_ + ki * dii),
                         (oki * ir - okr * ii) + (ki * dir_ - kr * dii))
                side = (code & 1).bool()
                for q, term in enumerate(terms):
                    for sd, pick in ((0, ~side), (1, side)):
                        cols = live.nonzero()[:, 0][pick]
                        acc[2 * q + sd][:, cols] = (acc[2 * q + sd][:, cols]
                                                    + term[:, pick])
            xv, uv = x[ls][:, n + bus], u[ls]
            if vjp:
                gr, gi = acc
                cb, sbus = c[ls][:, bus], s[ls][:, bus]
                d_th = xv * (gi * cb - gr * sbus)
                d_v = (gr * cb + gi * sbus) + 2.0 * xv * (
                    own[2] * op.g_sh[bus] - own[3] * op.b_sh[bus])
                if mode == MASKED:
                    d_th = torch.where(op.th_free[bus] > 0, d_th,
                                       d_th + uv[:, bus])
                    d_v = torch.where(op.v_free[bus] > 0, d_v,
                                      d_v + uv[:, n + bus])
            else:
                vdv = 2.0 * xv * uv[:, n + bus]
                d_th = torch.where(op.th_free[bus] > 0,
                                   (acc[0] + acc[1]) + op.g_sh[bus] * vdv,
                                   uv[:, bus])
                d_v = torch.where(op.v_free[bus] > 0,
                                  (acc[2] + acc[3]) - op.b_sh[bus] * vdv,
                                  uv[:, n + bus])
            out[ls, bus] = d_th
            out[ls, n + bus] = d_v
    return out


def cim_adjoint_matrix(a_re: Tensor, a_im: Tensor) -> Tuple[Tensor, Tensor]:
    """I2's staged ``Aᴴ = conj(A)ᵀ`` as ``(re, im)`` ``[N, N]``: the real
    pair's transpose of the product ``A j`` is the product with ``Aᴴ``."""
    return a_re.T.contiguous(), (-a_im).T.contiguous()


def cim_vjp_plain(h_re, h_im, g_re, g_im, v_re, v_im, s_re, s_im, mask,
                  sbar_re, sbar_im, vbbar_re, vbbar_im
                  ) -> Tuple[Tensor, Tensor]:
    """I2's plain version: one CIM iteration ``v′ = mask (v_base + A
    conj(s / v))`` walked back.  ``g`` is the masked cotangent of ``v′``;
    with ``ḡ = Aᴴ g`` (``h = Aᴴ``, :func:`cim_adjoint_matrix`) and ``q̄ =
    conj(ḡ)`` on live node-phases it adds ``conj(1/v) q̄`` to the load
    cotangent ``sbar`` and returns the masked cotangent of ``v``,
    ``mask conj(−s/v²) q̄`` (0 where ``v`` is 0), which it also adds to
    ``vbbar`` (``v_base``'s); ``sbar`` and ``vbbar`` in place."""
    p_re = g_re @ h_re.T - g_im @ h_im.T
    p_im = g_im @ h_re.T + g_re @ h_im.T
    q_re, q_im = p_re, -p_im
    d = v_re * v_re + v_im * v_im
    live = d > 0
    dd = torch.where(live, d, torch.ones_like(d))
    # conj(1/v) = v / |v|²
    ds_re = (v_re * q_re - v_im * q_im) / dd
    ds_im = (v_re * q_im + v_im * q_re) / dd
    # u = s / v; conj(−s/v²) = −conj(u) v / |v|²
    u_re = (s_re * v_re + s_im * v_im) / dd
    u_im = (s_im * v_re - s_re * v_im) / dd
    c_re = -(u_re * v_re + u_im * v_im) / dd
    c_im = -(u_re * v_im - u_im * v_re) / dd
    o_re = (c_re * q_re - c_im * q_im) * mask
    o_im = (c_re * q_im + c_im * q_re) * mask
    zero = torch.zeros_like(d)
    sbar_re.add_(torch.where(live, ds_re, zero))
    sbar_im.add_(torch.where(live, ds_im, zero))
    o_re = torch.where(live, o_re, zero)
    o_im = torch.where(live, o_im, zero)
    vbbar_re.add_(o_re)
    vbbar_im.add_(o_im)
    return o_re, o_im


def cim_vjp_walk_plain(h_re, h_im, g_re, g_im, vs, s_re, s_im, mask,
                       steps: int) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """I2's walk in plain PyTorch: ``steps`` calls of :func:`cim_vjp_plain`
    from the iterate ``vs[steps − 1]`` down to ``vs[0]`` (``vs [≥ steps,
    2, B, N]``, as :class:`~freedm_tpu_torch.pf.adjoint.CimFixed` saves
    them), the first on the masked cotangent ``g``; returns ``(sbar_re,
    sbar_im, vbbar_re, vbbar_im)``, ``vbbar`` starting at ``g``."""
    sbar_re, sbar_im = torch.zeros_like(s_re), torch.zeros_like(s_re)
    vbbar_re, vbbar_im = g_re.clone(), g_im.clone()
    for k in reversed(range(steps)):
        g_re, g_im = cim_vjp_plain(h_re, h_im, g_re, g_im, vs[k, 0], vs[k, 1],
                                   s_re, s_im, mask, sbar_re, sbar_im,
                                   vbbar_re, vbbar_im)
    return sbar_re, sbar_im, vbbar_re, vbbar_im


class CimWalkPlan(NamedTuple):
    """I2's product split (``csrc/solvers.cu`` ``walk_shape``): the
    ``units`` (tile, K stage) pairs — tile ``t = row tile × lane_tiles +
    lane tile`` of 64 rows × 64 lanes, ``stages`` of 16 columns each —
    cut into ``items`` even runs, item ``w`` the units ``[units·w //
    items, units·(w+1) // items)``; its sums over tile ``t`` go to slot
    ``w + t`` of ``slots``.  A function of ``(n, lanes)`` alone."""

    row_tiles: int
    lane_tiles: int
    stages: int
    units: int
    items: int
    slots: int

    def item_units(self, w: int) -> Tuple[int, int]:
        """Item ``w``'s run ``[u0, u1)`` of units."""
        return (self.units * w // self.items,
                self.units * (w + 1) // self.items)

    def item_of(self, u: int) -> int:
        """The item whose run holds unit ``u``."""
        return ((u + 1) * self.items - 1) // self.units

    def tile_items(self, t: int) -> Tuple[int, int]:
        """The first and last item over tile ``t``'s stages: the reduce
        adds their slots in this order."""
        u = t * self.stages
        return self.item_of(u), self.item_of(u + self.stages - 1)


def cim_walk_plan(n: int, lanes: int) -> CimWalkPlan:
    """I2's :class:`CimWalkPlan` at ``[n, n] × lanes``."""
    if n <= 0 or lanes <= 0:
        raise ValueError(f"cim_walk_plan needs n, lanes > 0, got {n}, "
                         f"{lanes}")
    row_tiles = -(-n // TILE_ROWS)
    lane_tiles = -(-lanes // TILE_LANES)
    stages = -(-n // TILE_K)
    units = row_tiles * lane_tiles * stages
    items = min(WALK_ITEMS, units)
    return CimWalkPlan(row_tiles, lane_tiles, stages, units, items,
                       items + row_tiles * lane_tiles - 1)


def cim_iterate_plain(a_re, a_im, v_re, v_im, s_re, s_im, vb_re, vb_im, mask,
                      err, it, active, tol: Tensor, max_iter: int,
                      fixed: bool) -> Tuple[Tensor, Tensor]:
    """I1's plain version: returns ``v_new`` as ``(re, im)`` (inactive
    lanes keep ``v``) and updates the lane carry in place.  Functional in
    ``v``: ``torch.autograd`` differentiates it (the residual is taken
    without a gradient, as the reference's ``stop_gradient`` does)."""
    live = v_re * v_re + v_im * v_im > 0
    safe_re = torch.where(live, v_re, torch.ones_like(v_re))
    safe_im = torch.where(live, v_im, torch.zeros_like(v_im))
    d = safe_re * safe_re + safe_im * safe_im
    q_re = (s_re * safe_re + s_im * safe_im) / d
    q_im = (s_im * safe_re - s_re * safe_im) / d
    j_re = torch.where(live, q_re, torch.zeros_like(q_re))
    j_im = torch.where(live, -q_im, torch.zeros_like(q_im))
    dv_re = j_re @ a_re.T - j_im @ a_im.T
    dv_im = j_im @ a_re.T + j_re @ a_im.T
    n_re = (vb_re + dv_re) * mask
    n_im = (vb_im + dv_im) * mask
    lane = active[:, None]
    n_re = torch.where(lane, n_re, v_re)
    n_im = torch.where(lane, n_im, v_im)
    with torch.no_grad():
        e = torch.amax(torch.sqrt((n_re - v_re) ** 2 + (n_im - v_im) ** 2),
                       dim=1)
        _finish_plain(e, err, it, active, tol, max_iter, fixed)
    return n_re, n_im


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_lib_lock = threading.Lock()
_fns: Dict[Tuple[str, torch.dtype], object] = {}
_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
_SIGS = {
    "ybus_stamp": [_I] + [_P] * 10 + [_I] * 3 + [_P],
    "fdlf_half_step": [_I, _P, _P, _L, _L, _P, _P, _I] + [_P] * 14
    + [_I] * 5 + [_P, _I, _P],
    "residual_jvp": [_P] * 15 + [_I] * 3 + [_P],
    "cim_iterate": [_P] * 19 + [_I] * 5 + [_P],
    "residual_vjp": [_I] + [_P] * 17 + [_I] * 3 + [_P],
    "residual_jvp_staged": [_P] * 13 + [_I] * 5 + [_P],
    "residual_vjp_staged": [_I] + [_P] * 13 + [_I] * 5 + [_P],
    "cim_vjp_walk": [_P] * 6 + [_L] + [_P] * 11 + [_I] * 4 + [_P],
}


def _fn(name: str, dtype: torch.dtype):
    """The C entry point of kernel ``name`` for ``dtype``; the library is
    built and loaded at the first call."""
    fn = _fns.get((name, dtype))
    if fn is None:
        with _lib_lock:
            if not _fns:
                lib = build.load("solvers")
                for dt, suffix in _SUFFIX.items():
                    for kname, args in _SIGS.items():
                        f = getattr(lib, f"{kname}_{suffix}")
                        f.argtypes = args
                        f.restype = _I
                        _fns[(kname, dt)] = f
        fn = _fns[(name, dtype)]
    return fn


def _solvers_lib() -> None:
    """Build and load the kernels' library now (it happens at the first
    launch otherwise)."""
    _fn("ybus_stamp", torch.float64)


def _check_stamp_mode(mode: int) -> None:
    if mode not in (YBUS, BPRIME, BDBL):
        raise ValueError(f"unknown ybus_stamp mode {mode!r}")


def _check_fdlf_mode(mode: int) -> None:
    if mode not in (INIT, THETA, VHALF):
        raise ValueError(f"unknown fdlf_half_step mode {mode!r}")


def _check_vjp_mode(mode: int) -> None:
    if mode not in (MASKED, FULL):
        raise ValueError(f"unknown residual_vjp mode {mode!r}")


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


#: F1's lane tickets (two int32 a lane, ``[lanes, 2]``) by (device,
#: stream): zeros that each launch's last takers reset, so launches on one
#: stream share them.
_tickets: Dict[Tuple[int, int], Tensor] = {}


def _lane_tickets(device: torch.device, stream: int, lanes: int) -> Tensor:
    key = (device.index, stream)
    with _launch_lock:
        t = _tickets.get(key)
        if t is None or t.numel() < 2 * lanes:
            if len(_tickets) >= 64:
                _tickets.clear()
            t = _tickets[key] = torch.zeros(max(lanes, 64), 2,
                                            dtype=torch.int32, device=device)
    return t


#: Each operand set's :class:`ResidualLayout` by (operands, VJP operands),
#: built at its first staged launch and kept while the operands live here.
_layouts: Dict[Tuple[int, int], tuple] = {}


def _layout_of(op: SparseOperands,
               vop: Optional[VjpOperands]) -> ResidualLayout:
    key = (id(op), id(vop))
    hit = _layouts.get(key)
    if hit is not None and hit[0] is op and hit[1] is vop:
        return hit[2]
    layout = residual_layout(op, vop)
    with _launch_lock:
        if len(_layouts) >= 64:
            _layouts.clear()
        _layouts[key] = (op, vop, layout)
    return layout


def _residual_launch(name: str, x: Tensor, u: Tensor, op: SparseOperands,
                     vop: Optional[VjpOperands], mode: Optional[int],
                     status: Optional[Tensor],
                     plan: Optional[ResidualPlan]) -> Tensor:
    """J1 (``vop`` None) or J2 on the card, on ``plan``'s route (default
    :func:`residual_plan`)."""
    lanes, n, m, dt = x.shape[0], op.n, op.m, x.dtype
    if plan is None:
        plan = residual_plan(n, m, lanes, dt, status is not None)
    elif plan != residual_plan(n, m, lanes, dt, status is not None,
                               plan.lanes_per_cta, plan.ctas_per_lane,
                               plan.route):
        raise ValueError(f"{name}: {plan} is not a plan of this shape")
    o = _op_ptrs(op, x)
    head = () if mode is None else (mode,)
    tail = (o["g_sh"], o["b_sh"], o["th_free"], o["v_free"], _ptr(status))
    ctx, stream = _launch_on(x)
    with ctx:
        out = torch.empty_like(x)
        if plan.route == WIDE:
            mid = () if vop is None else (vop.inc_gt.data_ptr(),
                                          vop.inc_bt.data_ptr())
            rc = _fn(name, dt)(*head, x.data_ptr(), u.data_ptr(),
                               o["inc_ptr"], o["inc_code"], o["inc_nbr"],
                               o["inc_g"], o["inc_b"], o["inc_gs"],
                               o["inc_bs"], *mid, *tail, out.data_ptr(),
                               lanes, n, m, stream)
        else:
            lay = _layout_of(op, vop)
            rc = _fn(name + "_staged", dt)(
                *head, x.data_ptr(), u.data_ptr(), lay.slot.data_ptr(),
                lay.slice_base.data_ptr(), lay.where.data_ptr(),
                lay.idx.data_ptr(),
                lay.val.data_ptr(), *tail, out.data_ptr(), lanes, n, m,
                plan.lanes_per_cta, plan.ctas_per_lane, stream)
    _raise_on(rc, name)
    _count(name, mode, plan.route)
    return out


def ybus_stamp(mode: int, op: StampOperands, status: Tensor):
    """Y1: the per-lane stamp of Ybus (:data:`YBUS`, returns ``(y_re,
    y_im)``), B′ (:data:`BPRIME`) or B″ (:data:`BDBL`), ``[L, n, n]`` in
    ``op``'s dtype for ``status [L, m]``."""
    if op.g_sh.device.type == "cpu":
        return ybus_stamp_plain(mode, op, status)
    _need_cuda(op.g_sh, "ybus_stamp")
    _check_stamp_mode(mode)
    n, m, dt = op.n, op.m, op.g_sh.dtype
    lanes = status.shape[0]
    i32 = torch.int32
    spec = {"inc_ptr": (op.inc_ptr, i32, (n + 1,)),
            "inc_code": (op.inc_code, i32, (2 * m,)),
            "inc_nbr": (op.inc_nbr, i32, (2 * m,)),
            "br": (op.br, dt, (8, m)), "inv_x": (op.inv_x, dt, (m,))}
    for name in ("g_sh", "b_sh", "th_free", "v_free"):
        spec[name] = (getattr(op, name), dt, (n,))
    spec["status"] = (status, dt, (lanes, m))
    _want(op.g_sh, spec)
    if not 1 <= lanes <= 65535:
        raise ValueError(f"ybus_stamp takes 1-65535 lanes, got {lanes}")
    fn = _fn("ybus_stamp", dt)
    ctx, stream = _launch_on(op.g_sh)
    with ctx:
        out_a = torch.empty(lanes, n, n, dtype=dt, device=op.g_sh.device)
        out_b = torch.empty_like(out_a) if mode == YBUS else None
        keep = {YBUS: None, BPRIME: op.th_free, BDBL: op.v_free}[mode]
        br = op.inv_x if mode == BPRIME else op.br
        rc = fn(mode, op.inc_ptr.data_ptr(), op.inc_code.data_ptr(),
                op.inc_nbr.data_ptr(), br.data_ptr(), status.data_ptr(),
                op.g_sh.data_ptr(), op.b_sh.data_ptr(), _ptr(keep),
                out_a.data_ptr(), _ptr(out_b), lanes, n, m, stream)
    _raise_on(rc, "ybus_stamp")
    _count("ybus_stamp", mode)
    return (out_a, out_b) if mode == YBUS else out_a


def fdlf_half_step(mode: int, x, d, y_re, y_im, ps, qs, th_free, v_free, dp,
                   dq, err, it, active, tol: Tensor, max_iter: int,
                   fixed: bool) -> None:
    """F1: one half of a fast-decoupled iteration, in place (the module
    docstring's modes).  ``d [B, n]`` is the half's LU solve (unused in
    :data:`INIT`), read through its strides; ``y`` is ``[n, n]`` for
    every lane or ``[B, n, n]``.  ``fixed`` keeps every lane active (the
    reference's ``solve_fixed``)."""
    if x.device.type == "cpu":
        fdlf_half_step_plain(mode, x, d, y_re, y_im, ps, qs, th_free, v_free,
                             dp, dq, err, it, active, tol, max_iter, fixed)
        return
    _need_cuda(x, "fdlf_half_step")
    _check_fdlf_mode(mode)
    dt = x.dtype
    lanes, n = x.shape[0], x.shape[1] // 2
    lane_y = y_re.dim() == 3
    warp_form = lane_y or lanes < TILED_MIN_LANES
    plan = fdlf_warp_plan(n, lanes, dt) if warp_form else None
    ysh = (lanes, n, n) if lane_y else (n, n)
    spec = {"x": (x, dt, (lanes, 2 * n)), "y_re": (y_re, dt, ysh),
            "y_im": (y_im, dt, ysh), "ps": (ps, dt, (lanes, n)),
            "qs": (qs, dt, (lanes, n)), "th_free": (th_free, dt, (n,)),
            "v_free": (v_free, dt, (n,)), "dp": (dp, dt, (lanes, n)),
            "dq": (dq, dt, (lanes, n)), "err": (err, dt, (lanes,)),
            "it": (it, torch.int32, (lanes,)),
            "active": (active, torch.bool, (lanes,)), "tol": (tol, dt, (1,))}
    _want(x, spec)
    if mode != INIT and (d is None or d.dtype is not dt or d.device != x.device
                         or tuple(d.shape) != (lanes, n)):
        raise ValueError(f"d must be a {dt} [{lanes}, {n}] tensor on "
                         f"{x.device}")
    if not 1 <= lanes <= 65535:
        raise ValueError(f"fdlf_half_step takes 1-65535 lanes, got {lanes}")
    fn = _fn("fdlf_half_step", dt)
    ctx, stream = _launch_on(x)
    with ctx:
        if warp_form:  # one launch: V in shared memory, a lane's tickets
            vr = vm = part = None
            splits = 0
            rowerr = (torch.empty(lanes, plan.ctas, dtype=dt,
                                  device=x.device)
                      if mode == VHALF else None)
            ticket = _lane_tickets(x.device, stream, lanes)
        else:
            vr = torch.empty(lanes, n, dtype=dt, device=x.device)
            vm = torch.empty_like(vr)
            rowerr = torch.empty_like(vr) if mode == VHALF else None
            splits, part = product_scratch(n, lanes, dt, x.device)
            ticket = None
        d_bs, d_js = (0, 0) if mode == INIT else d.stride()
        rc = fn(mode, x.data_ptr(), None if mode == INIT else d.data_ptr(),
                d_bs, d_js, y_re.data_ptr(), y_im.data_ptr(), int(lane_y),
                ps.data_ptr(), qs.data_ptr(), th_free.data_ptr(),
                v_free.data_ptr(), dp.data_ptr(), dq.data_ptr(),
                _ptr(vr), _ptr(vm), _ptr(part), _ptr(rowerr),
                err.data_ptr(), it.data_ptr(), active.data_ptr(),
                tol.data_ptr(), int(max_iter), int(bool(fixed)), lanes, n,
                splits, _ptr(ticket), plan.rows if plan else 0, stream)
    _raise_on(rc, "fdlf_half_step")
    _count("fdlf_half_step", mode)


def residual_jvp(x: Tensor, u: Tensor, op: SparseOperands,
                 status: Optional[Tensor] = None,
                 plan: Optional[ResidualPlan] = None) -> Tensor:
    """J1: ``J u [B, 2n]``, the masked residual's derivative at ``x [B,
    2n]`` along ``u [B, 2n]``; ``status [B, m]`` (``x``'s dtype) scales
    each lane's branch admittances.  The operands are in ``x``'s dtype
    (float32 for the mixed inner solve: ``op.to_dtype(torch.float32)``).
    ``plan`` forces a :func:`residual_plan` of this shape (the bits do not
    depend on it)."""
    if x.device.type == "cpu":
        return residual_jvp_plain(x, u, op, status)
    _need_cuda(x, "residual_jvp")
    lanes, n, m, dt = x.shape[0], op.n, op.m, x.dtype
    spec = {"x": (x, dt, (lanes, 2 * n)), "u": (u, dt, (lanes, 2 * n))}
    if status is not None:
        spec["status"] = (status, dt, (lanes, m))
    _want(x, spec)
    return _residual_launch("residual_jvp", x, u, op, None, None, status,
                            plan)


def cim_iterate(a_re, a_im, v_re, v_im, s_re, s_im, vb_re, vb_im, mask, err,
                it, active, tol: Tensor, max_iter: int, fixed: bool,
                out: Optional[Tuple[Tensor, Tensor]] = None
                ) -> Tuple[Tensor, Tensor]:
    """I1: one current-injection iteration of every lane: returns
    ``v_new`` as ``(re, im)`` ``[B, N]`` (inactive lanes keep ``v``;
    written into ``out`` when given, which must not be ``v``) and updates
    ``err``, ``it`` and ``active`` in place.  ``A = Y_LL⁻¹`` is ``[N,
    N]``, the loads ``s`` and the no-load profile ``vb`` are ``[B, N]``,
    the phase mask ``[N]``."""
    if v_re.device.type == "cpu":
        n_re, n_im = cim_iterate_plain(a_re, a_im, v_re, v_im, s_re, s_im,
                                       vb_re, vb_im, mask, err, it, active,
                                       tol, max_iter, fixed)
        if out is None:
            return n_re, n_im
        out[0].copy_(n_re)
        out[1].copy_(n_im)
        return out
    _need_cuda(v_re, "cim_iterate")
    dt = v_re.dtype
    lanes, big_n = v_re.shape
    lane = (lanes, big_n)
    if out is None:
        out = (torch.empty_like(v_re), torch.empty_like(v_im))
    spec = {"a_re": (a_re, dt, (big_n, big_n)),
            "a_im": (a_im, dt, (big_n, big_n)), "v_re": (v_re, dt, lane),
            "v_im": (v_im, dt, lane), "s_re": (s_re, dt, lane),
            "s_im": (s_im, dt, lane), "vb_re": (vb_re, dt, lane),
            "vb_im": (vb_im, dt, lane), "mask": (mask, dt, (big_n,)),
            "out_re": (out[0], dt, lane), "out_im": (out[1], dt, lane),
            "err": (err, dt, (lanes,)), "it": (it, torch.int32, (lanes,)),
            "active": (active, torch.bool, (lanes,)), "tol": (tol, dt, (1,))}
    _want(v_re, spec)
    if out[0].data_ptr() in (v_re.data_ptr(), v_im.data_ptr()):
        raise ValueError("cim_iterate writes v_new beside v, not over it")
    fn = _fn("cim_iterate", dt)
    ctx, stream = _launch_on(v_re)
    with ctx:
        rowerr = torch.empty_like(v_re)
        j_re, j_im = torch.empty_like(v_re), torch.empty_like(v_re)
        splits, part = product_scratch(big_n, lanes, dt, v_re.device)
        rc = fn(a_re.data_ptr(), a_im.data_ptr(), v_re.data_ptr(),
                v_im.data_ptr(), s_re.data_ptr(), s_im.data_ptr(),
                vb_re.data_ptr(), vb_im.data_ptr(), mask.data_ptr(),
                j_re.data_ptr(), j_im.data_ptr(), part.data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), rowerr.data_ptr(),
                err.data_ptr(), it.data_ptr(), active.data_ptr(),
                tol.data_ptr(), int(max_iter), int(bool(fixed)), lanes, big_n,
                splits, stream)
    _raise_on(rc, "cim_iterate")
    _count("cim_iterate")
    return out


def residual_vjp(x: Tensor, w: Tensor, op: SparseOperands, vop: VjpOperands,
                 mode: int, status: Optional[Tensor] = None,
                 plan: Optional[ResidualPlan] = None) -> Tensor:
    """J2: ``wᵀ ∂F/∂x [B, 2n]`` at ``x [B, 2n]`` for ``w [B, 2n]``
    (:func:`residual_vjp_plain`'s modes); ``status [B, m]`` (``x``'s
    dtype) scales each lane's branch admittances.  The operands are in
    ``x``'s dtype.  ``plan`` forces a :func:`residual_plan` of this shape
    (the bits do not depend on it)."""
    if x.device.type == "cpu":
        return residual_vjp_plain(x, w, op, vop, mode, status)
    _need_cuda(x, "residual_vjp")
    _check_vjp_mode(mode)
    lanes, n, m, dt = x.shape[0], op.n, op.m, x.dtype
    spec = {"x": (x, dt, (lanes, 2 * n)), "w": (w, dt, (lanes, 2 * n)),
            "inc_gt": (vop.inc_gt, dt, (2 * m,)),
            "inc_bt": (vop.inc_bt, dt, (2 * m,))}
    if status is not None:
        spec["status"] = (status, dt, (lanes, m))
    _want(x, spec)
    return _residual_launch("residual_vjp", x, w, op, vop, mode, status,
                            plan)


def cim_vjp(h_re, h_im, g_re, g_im, v_re, v_im, s_re, s_im, mask, sbar_re,
            sbar_im, vbbar_re, vbbar_im) -> Tuple[Tensor, Tensor]:
    """I2: one CIM iteration walked back (:func:`cim_vjp_plain`): returns
    the masked cotangent of ``v`` as ``(re, im)`` ``[B, N]`` and adds to
    ``sbar`` and ``vbbar`` in place.  ``h = Aᴴ`` is ``[N, N]``
    (:func:`cim_adjoint_matrix`), every other tensor ``[B, N]`` but the
    phase mask ``[N]``.  On the card: the walk's kernel with one step."""
    if v_re.device.type == "cpu":
        return cim_vjp_plain(h_re, h_im, g_re, g_im, v_re, v_im, s_re, s_im,
                             mask, sbar_re, sbar_im, vbbar_re, vbbar_im)
    _need_cuda(v_re, "cim_vjp")
    lanes, big_n = v_re.shape
    lane = (lanes, big_n)
    tensors = {"v_re": (v_re, lane), "v_im": (v_im, lane)}
    o_re, o_im = torch.empty_like(v_re), torch.empty_like(v_re)
    _walk_launch(h_re, h_im, g_re, g_im, v_re, v_im, 0, s_re, s_im, mask,
                 sbar_re, sbar_im, vbbar_re, vbbar_im, o_re, o_im, 1,
                 tensors, lane)
    return o_re, o_im


def cim_vjp_walk(h_re, h_im, g_re, g_im, vs, s_re, s_im, mask, steps: int
                 ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """I2 over a whole backward (:func:`cim_vjp_walk_plain`): ``steps``
    iterations walked back from ``vs[steps − 1]`` to ``vs[0]`` in one
    launch; returns ``(sbar_re, sbar_im, vbbar_re, vbbar_im)``.  ``vs``
    is ``[≥ steps, 2, B, N]`` contiguous (the iterates
    :class:`~freedm_tpu_torch.pf.adjoint.CimFixed` saves), ``g`` the masked
    cotangent of the last iterate ``[B, N]``.  On CPU tensors the plain
    per-iteration loop."""
    if vs.device.type == "cpu":
        return cim_vjp_walk_plain(h_re, h_im, g_re, g_im, vs, s_re, s_im,
                                  mask, steps)
    _need_cuda(vs, "cim_vjp_walk")
    steps = int(steps)
    if vs.dim() != 4 or vs.shape[1] != 2 or not vs.is_contiguous() \
            or not 1 <= steps <= vs.shape[0]:
        raise ValueError(f"cim_vjp_walk needs vs [>= steps, 2, B, N] "
                         f"contiguous and steps >= 1, got "
                         f"{tuple(vs.shape)} and {steps}")
    lanes, big_n = int(vs.shape[2]), int(vs.shape[3])
    lane = (lanes, big_n)
    sbar_re, sbar_im = torch.zeros_like(s_re), torch.zeros_like(s_re)
    vbbar_re, vbbar_im = g_re.clone(), g_im.clone()
    o_re, o_im = torch.empty_like(s_re), torch.empty_like(s_re)
    _walk_launch(h_re, h_im, g_re, g_im, vs[0, 0], vs[0, 1], 2 * lanes * big_n,
                 s_re, s_im, mask, sbar_re, sbar_im, vbbar_re, vbbar_im,
                 o_re, o_im, steps, {"vs": (vs, tuple(vs.shape))}, lane)
    return sbar_re, sbar_im, vbbar_re, vbbar_im


def _walk_launch(h_re, h_im, g_re, g_im, v_re, v_im, v_step, s_re, s_im,
                 mask, sbar_re, sbar_im, vbbar_re, vbbar_im, o_re, o_im,
                 steps, tensors, lane) -> None:
    """Check I2's operands and launch its walk (one count)."""
    dt = s_re.dtype
    lanes, big_n = lane
    spec = {"h_re": (h_re, dt, (big_n, big_n)),
            "h_im": (h_im, dt, (big_n, big_n)), "mask": (mask, dt, (big_n,))}
    for name, t in (("g_re", g_re), ("g_im", g_im), ("s_re", s_re),
                    ("s_im", s_im), ("sbar_re", sbar_re),
                    ("sbar_im", sbar_im), ("vbbar_re", vbbar_re),
                    ("vbbar_im", vbbar_im)):
        spec[name] = (t, dt, lane)
    for name, (t, shape) in tensors.items():
        spec[name] = (t, dt, shape)
    _want(s_re, spec)
    plan = cim_walk_plan(big_n, lanes)
    fn = _fn("cim_vjp_walk", dt)
    ctx, stream = _launch_on(s_re)
    with ctx:
        part = torch.empty(plan.slots, 2, TILE_LANES, TILE_ROWS, dtype=dt,
                           device=s_re.device)
        bar = build.grid_barrier(s_re.device, stream)
        rc = fn(h_re.data_ptr(), h_im.data_ptr(), g_re.data_ptr(),
                g_im.data_ptr(), v_re.data_ptr(), v_im.data_ptr(),
                int(v_step), s_re.data_ptr(), s_im.data_ptr(),
                mask.data_ptr(), sbar_re.data_ptr(), sbar_im.data_ptr(),
                vbbar_re.data_ptr(), vbbar_im.data_ptr(), o_re.data_ptr(),
                o_im.data_ptr(), part.data_ptr(), bar.data_ptr(), lanes,
                big_n, steps, plan.slots, stream)
    _raise_on(rc, "cim_vjp")
    _count("cim_vjp")
