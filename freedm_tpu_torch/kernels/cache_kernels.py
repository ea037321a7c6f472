"""Wrapper, plain version and launch counter of the serving cache's kernel.

==========================  =============================================  =====
wrapper                     replaces                                       route
==========================  =============================================  =====
:class:`DeltaProgram`       ``freedm_tpu/serve/cache.py``                  CUDA
                            ``_build_delta_program`` (:284-381): the
                            whole correction program, with the
                            injections of ``freedm_tpu/pf/mfree.py``
                            ``make_injection_fn`` (:34-65) and the
                            rank-0 ``smw_delta_solve`` of
                            ``freedm_tpu/pf/n1.py`` (:86)
==========================  =============================================  =====

C1 lives in ``csrc/cache.cu``: one launch runs a delta answer's whole
program — the mismatch at the warm start, every fast-decoupled sweep with
its per-lane exit test, its two triangular-solve pairs on the cached
B′/B″ LU factors, and the final P and Q.  A :class:`DeltaProgram` is built
once per cached entry: it checks the operands, lays the factors out for
the kernel, turns the pivots into permutations and allocates its buffers
then, so a call is one host-to-device copy, one launch and one
device-to-host copy.  Built for the CPU, a :class:`DeltaProgram` runs its
plain version, :func:`delta_program_plain`: the loop of
:func:`delta_mismatch_plain` (the mismatch, correction and exit test of a
half-sweep, in four modes) and ``torch.linalg.lu_solve``; for the card it
launches the kernel or raises.  Each launch counts in :data:`LAUNCHES`.

:func:`lu_solve_mirror` is the kernel's substitution in PyTorch (the
pivots as a permutation gather, then column-oriented forward and back
substitution): tests and ``chip_smoke.py`` hold the kernel's algorithm to
``lu_solve`` and to the JAX package with it.  The main path never calls it.

:func:`delta_mismatch_plain` runs one of four modes over ``[B, n]`` lanes
(``th``, ``v``, the schedules ``ps``, ``qs``; a mode that corrects a half
takes ``s``, the triangular solve's answer):

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

import ctypes
import functools
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from freedm_tpu_torch.kernels import build

Tensor = torch.Tensor

#: Kernel launches since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"delta_program": 0}
_MODE_NAMES = ("INIT", "THETA", "V", "PQ")
_launch_lock = threading.Lock()

#: :func:`delta_mismatch_plain`'s modes.
INIT, THETA, V, PQ = 0, 1, 2, 3

#: Rows and columns of the kernel's factor tiles (and of the mirror's
#: blocks).
TILE = 64


def _count() -> None:
    with _launch_lock:
        LAUNCHES["delta_program"] += 1


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launches() -> Dict[str, int]:
    with _launch_lock:
        return dict(LAUNCHES)


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


def branch_injections(theta: Tensor, v: Tensor, op: DeltaOperands,
                      status: Optional[Tensor] = None
                      ) -> Tuple[Tensor, Tensor]:
    """``(P, Q)`` at ``theta``, ``v`` (``[n]`` or ``[B, n]``): the
    reference ``make_injection_fn``'s branch-wise arithmetic, operation
    for operation — two gathers, four complex products, two segment sums
    per part, then the shunts.  ``status`` (``[m]`` or ``[B, m]``, float64)
    scales the four admittances of each branch first, as the reference's
    ``branch_admittances(sys, status)`` does."""
    n = op.n
    if status is None:
        y = op.y.unbind(0)
    else:
        y = (op.y * status.unsqueeze(-2)).unbind(-2)
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
    """One half-sweep of :func:`delta_program_plain` in ``mode`` (the
    module docstring's four modes; ``state`` is updated in place)."""
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


def _check_mode(mode: int) -> None:
    if mode not in (INIT, THETA, V, PQ):
        raise ValueError(f"unknown delta_mismatch mode {mode!r}")


def lu_permutation(pivots) -> Tensor:
    """LAPACK's row interchanges (``torch.linalg.lu_factor``'s 1-based
    ``pivots [n]``: row ``i`` swapped with row ``pivots[i] − 1``, in turn)
    as one permutation ``perm [n]`` (int64, on the CPU): ``(Pᵀb)_i =
    b[perm[i]]``, the gather ``lu_solve`` does with its swaps."""
    piv = np.asarray(torch.as_tensor(pivots).cpu(), np.int64) - 1
    perm = np.arange(piv.shape[0])
    for i, j in enumerate(piv):
        perm[i], perm[j] = perm[j], perm[i]
    return torch.from_numpy(perm)


def lu_solve_mirror(lu, rhs: Tensor) -> Tensor:
    """The kernel's solve in PyTorch: ``x = U⁻¹ L⁻¹ Pᵀ rhs`` for ``rhs [B,
    n]`` on ``lu = (LU, pivots)`` (``torch.linalg.lu_factor``'s pair, in
    the dtype the arithmetic runs in).  The pivots are applied as the
    gather of :func:`lu_permutation`; then the substitution runs in the
    kernel's order, a block of :data:`TILE` columns at a time: forward
    with the unit-lower L (block k's columns, ascending, each updating
    every row below it), then back with U (blocks from the last, columns
    descending, ``x_c = b_c / u_cc``).  Every row thus receives its
    updates one column at a time in column order, as in the kernel, which
    fuses each into one rounding (an fma) where this takes two."""
    lu_mat, piv = lu
    b = rhs[..., lu_permutation(piv).to(rhs.device)].clone()
    n = b.shape[-1]
    for k0 in range(0, n, TILE):
        for c in range(k0, min(k0 + TILE, n)):
            b[..., c + 1:] -= lu_mat[c + 1:, c] * b[..., c:c + 1]
    for k1 in range(n, 0, -TILE):
        for c in range(k1 - 1, max(k1 - TILE, 0) - 1, -1):
            b[..., c] /= lu_mat[c, c]
            b[..., :c] -= lu_mat[:c, c] * b[..., c:c + 1]
    return b


def _lu_solve(lu, rhs: Tensor) -> Tensor:
    """The base solve over lanes, ``rhs [B, n]`` -> ``[B, n]``: rank-0
    ``smw_delta_solve`` (``torch.linalg.lu_solve``)."""
    # Imported here: importing freedm_tpu_torch.pf imports this module.
    from freedm_tpu_torch.pf.n1 import smw_delta_solve

    return smw_delta_solve(lu, None, None, rhs.T).T.contiguous()


def delta_program_plain(op: DeltaOperands, lu_p, lu_q, theta, v, ps, qs,
                        max_sweeps: int, tol: float, mixed: bool = False,
                        solve=None):
    """C1's plain version: the delta program over ``[B, n]`` float64
    lanes as a host loop — :func:`delta_mismatch_plain` in its four modes
    around two triangular solves a sweep, ``solve(lu, rhs [B, n])`` (rank-0
    ``smw_delta_solve`` by default; tests pass :func:`lu_solve_mirror`),
    on ``lu_p``, ``lu_q`` (float32 factors with ``mixed``, whose
    right-hand sides are the float32 copies the mismatch writes).  The
    loop reads the lanes' ``active`` flags before each sweep.  Returns
    ``(theta, v, p_calc, q_calc, err [B], it [B])``."""
    solve = _lu_solve if solve is None else solve
    state = new_state(theta.shape[0], theta.device)
    args = dict(lo=mixed, max_sweeps=max_sweeps, tol=tol)
    _, dp, dq, lo = delta_mismatch_plain(INIT, theta, v, ps, qs, op,
                                         state=state, **args)
    for _ in range(max_sweeps):
        if not bool(state.active.any()):
            break
        theta, dp, dq, lo = delta_mismatch_plain(
            THETA, theta, v, ps, qs, op, solve(lu_p, lo if mixed else dp),
            state, **args)
        v, dp, dq, lo = delta_mismatch_plain(
            V, theta, v, ps, qs, op, solve(lu_q, lo if mixed else dq),
            state, **args)
    _, p_calc, q_calc, _ = delta_mismatch_plain(PQ, theta, v, ps, qs, op)
    return theta, v, p_calc, q_calc, state.err, state.it


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=1)
def _lib():
    """C1's library, built and loaded at the first call (``build.load``
    serializes concurrent first calls), with its entry points typed."""
    lib = build.load("cache")
    lib.delta_program_config.argtypes = [_I, _I, ctypes.POINTER(_I),
                                         ctypes.POINTER(_I)]
    lib.delta_program_config.restype = _I
    lib.delta_program.argtypes = ([_I] + [_P] * 17 + [_I] * 5
                                  + [ctypes.c_double, _I, _P])
    lib.delta_program.restype = _I
    return lib


def _cache_lib() -> None:
    """Build and load the kernel's library now (it happens at the first
    program build otherwise)."""
    _lib()


def _want(name: str, t: Tensor, dtype: torch.dtype, shape: tuple,
          dev: torch.device) -> None:
    if t.dtype is not dtype or t.device != dev:
        raise ValueError(f"{name} must be {dtype} on {dev}, got {t.dtype} "
                         f"on {t.device}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {shape} tensor, got "
                         f"{tuple(t.shape)}")


def _check_program(op: DeltaOperands, lu_p, lu_q, dev: torch.device) -> None:
    """Device, dtype, shape and contiguity of every operand of a program,
    checked once when it is built."""
    n, m = op.n, op.m
    i32, f64 = torch.int32, torch.float64
    _want("inc_ptr", op.inc_ptr, i32, (n + 1,), dev)
    _want("inc_code", op.inc_code, i32, (2 * m,), dev)
    _want("inc_nbr", op.inc_nbr, i32, (2 * m,), dev)
    _want("y", op.y, f64, (8, m), dev)
    for name in ("g_sh", "b_sh", "th_free", "v_free"):
        _want(name, getattr(op, name), f64, (n,), dev)
    for name, (lu_mat, piv) in (("lu_p", lu_p), ("lu_q", lu_q)):
        if lu_mat.dtype is not f64 or lu_mat.device != dev \
                or tuple(lu_mat.shape) != (n, n):
            raise ValueError(f"{name} must be a float64 ({n}, {n}) LU factor "
                             f"on {dev}, got {lu_mat.dtype} "
                             f"{tuple(lu_mat.shape)} on {lu_mat.device}")
        if tuple(piv.shape) != (n,):
            raise ValueError(f"{name}'s pivots must be ({n},), got "
                             f"{tuple(piv.shape)}")


def kernel_factor(lu_mat: Tensor, dtype: torch.dtype) -> Tuple[Tensor, int]:
    """The kernel's copy of one LU factor: column-major (as LAPACK writes
    it) in ``dtype``, with a leading dimension ``lda`` that is ``n``
    rounded up to 16 bytes, so every tile column is a whole number of the
    TMA's 16-byte units.  Returns ``(buf [n, lda], lda)``: ``buf[c, r] =
    LU[r, c]``.  A float64 factor from ``lu_factor`` whose rows are
    already aligned is used in place (no copy)."""
    n = lu_mat.shape[-1]
    unit = 16 // torch.empty((), dtype=dtype).element_size()
    lda = -(-n // unit) * unit
    cm = lu_mat.mT
    if lda == n and cm.dtype is dtype and cm.is_contiguous():
        return cm, lda
    buf = torch.zeros(n, lda, dtype=dtype, device=lu_mat.device)
    buf[:, :n] = cm
    return buf, lda


class DeltaResult(tuple):
    """``(theta, v, p_calc, q_calc, err, sweeps)`` of a program on the
    card: views of its output buffer ``packed [B, 4n + 2]``, which the
    program's next call overwrites (:func:`results_to_host` copies them
    out in one transfer)."""

    packed: Optional[Tensor] = None


def results_to_host(res) -> tuple:
    """A program's results as host numpy arrays — one device-to-host copy
    for a :class:`DeltaResult`, one per result otherwise."""
    packed = getattr(res, "packed", None)
    if packed is None:
        return tuple(r.cpu().numpy() for r in res)
    h = packed.cpu().numpy()
    n = (h.shape[-1] - 2) // 4
    it = h.view(np.int32)[..., 2 * (4 * n + 1)]
    return (h[..., :n], h[..., n:2 * n], h[..., 2 * n:3 * n],
            h[..., 3 * n:4 * n], h[..., 4 * n], it)


class DeltaProgram:
    """The delta tier's correction program over one bus system's operands
    ``op`` and cached LU pair ``lu_p``, ``lu_q`` (float64 ``lu_factor``
    pairs): ``program(theta0, v0, p_sched, q_sched) -> (theta, v, p_calc,
    q_calc, err, sweeps)`` for ``[n]`` (one answer: ``err`` and ``sweeps``
    0-d) or ``[B, n]`` lanes, numpy or float64 tensors; see
    :func:`delta_program_plain` for its semantics.  ``mixed`` runs the
    triangular solves in float32 on float32 copies of the factors, made
    here once.

    Built on the CPU (``op`` there), a call runs :func:`delta_program_plain`.
    Built for the card, the operands are checked here, the factors laid
    out for the kernel (:func:`kernel_factor`), the pivots turned into
    permutations (:func:`lu_permutation`) and the buffers allocated, for
    the most lanes one launch takes; a call copies the inputs in, launches
    C1 once for every such group of lanes on the current stream (each
    launch counts), and returns a :class:`DeltaResult` of views into the
    output buffer.  Calls must not overlap (the serving cache runs one
    program at a time)."""

    def __init__(self, op: DeltaOperands, lu_p, lu_q, max_sweeps: int,
                 tol: float, mixed: bool = False):
        self.op = op
        self.max_sweeps = int(max_sweeps)
        self.tol = float(tol)
        self.mixed = bool(mixed)
        dev = self.device = op.g_sh.device
        n = self.n = op.n
        if dev.type == "cpu":
            if mixed:
                lu_p = (lu_p[0].to(torch.float32), lu_p[1])
                lu_q = (lu_q[0].to(torch.float32), lu_q[1])
            self.lu_p, self.lu_q = lu_p, lu_q
            return
        if dev.type != "cuda":
            raise ValueError(f"the delta program runs on CPU or CUDA tensors, "
                             f"got {dev}")
        _check_program(op, lu_p, lu_q, dev)
        dtype = torch.float32 if mixed else torch.float64
        (self._lu_p, lda), (self._lu_q, _) = (kernel_factor(lu[0], dtype)
                                              for lu in (lu_p, lu_q))
        self._lda = lda
        self._perm_p, self._perm_q = (
            lu_permutation(lu[1]).to(device=dev, dtype=torch.int32)
            for lu in (lu_p, lu_q))
        # 1 / u_cc in the factors' type, rounded to nearest: the kernel's
        # back substitution divides with them (Markstein's correction).
        self._rdiag_p, self._rdiag_q = (
            torch.reciprocal(torch.diagonal(f[:, :n])).contiguous()
            for f in (self._lu_p, self._lu_q))
        lib = _lib()
        cluster, lanes = _I(), _I()
        with torch.cuda.device(dev):
            rc = lib.delta_program_config(int(mixed), n, ctypes.byref(cluster),
                                          ctypes.byref(lanes))
        if rc != 0:
            raise RuntimeError(f"delta_program has no launch configuration "
                               f"at n = {n}: CUDA error {rc}")
        self.cluster, self.max_lanes = cluster.value, lanes.value
        self._alloc(self.max_lanes)

    def _alloc(self, lanes: int) -> None:
        f64, n, dev = torch.float64, self.n, self.device
        self._in = torch.empty(lanes, 4, n, dtype=f64, device=dev)
        self._out = torch.zeros(lanes, 4 * n + 2, dtype=f64, device=dev)
        self._dpq = torch.empty(lanes, 2, n, dtype=f64, device=dev)

    def __call__(self, theta0, v0, p_sched, q_sched):
        n, dev = self.n, self.device
        args = [a if isinstance(a, torch.Tensor)
                else torch.from_numpy(np.array(a, np.float64))
                for a in (theta0, v0, p_sched, q_sched)]
        one = args[0].dim() == 1
        args = [a.reshape(-1, n) for a in args]
        lanes = args[0].shape[0]
        if any(a.shape[0] != lanes for a in args):
            raise ValueError(f"theta0, v0, p_sched and q_sched must have one "
                             f"shape, got {[tuple(a.shape) for a in args]}")
        if dev.type == "cpu":
            out = delta_program_plain(
                self.op, self.lu_p, self.lu_q,
                *(a.to(torch.float64).contiguous() for a in args),
                self.max_sweeps, self.tol, self.mixed)
            return tuple(o[0] for o in out) if one else out
        if lanes > self._in.shape[0]:
            self._alloc(lanes)
        if all(a.device.type == "cpu" for a in args):
            self._in[:lanes].copy_(torch.stack(args, dim=1))
        else:
            for k, a in enumerate(args):
                self._in[:lanes, k].copy_(a)
        self._launch(lanes)
        packed = self._out[:lanes]
        it = self._out.view(torch.int32)[:lanes, 2 * (4 * n + 1)]
        res = (packed[:, :n], packed[:, n:2 * n], packed[:, 2 * n:3 * n],
               packed[:, 3 * n:4 * n], packed[:, 4 * n], it)
        if one:
            res, packed = tuple(r[0] for r in res), packed[0]
        res = DeltaResult(res)
        res.packed = packed
        return res

    def _launch(self, lanes: int) -> None:
        op, n = self.op, self.n
        lib = _lib()
        idx = self.device.index
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            for l0 in range(0, lanes, self.max_lanes):
                count = min(self.max_lanes, lanes - l0)
                rc = lib.delta_program(
                    int(self.mixed), self._in[l0].data_ptr(),
                    self._out[l0].data_ptr(), self._dpq[l0].data_ptr(),
                    op.inc_ptr.data_ptr(), op.inc_code.data_ptr(),
                    op.inc_nbr.data_ptr(), op.y.data_ptr(),
                    op.g_sh.data_ptr(), op.b_sh.data_ptr(),
                    op.th_free.data_ptr(), op.v_free.data_ptr(),
                    self._lu_p.data_ptr(), self._lu_q.data_ptr(),
                    self._perm_p.data_ptr(), self._perm_q.data_ptr(),
                    self._rdiag_p.data_ptr(), self._rdiag_q.data_ptr(),
                    self._lda, count, n, op.m, self.max_sweeps, self.tol,
                    self.cluster, stream)
                if rc != 0:
                    raise RuntimeError(f"delta_program kernel launch failed "
                                       f"on cuda:{idx}: CUDA error {rc}")
                _count()
