"""Sparse (BCSR) batched Newton power flow with pattern-reuse Krylov solves.

Port of ``freedm_tpu/pf/sparse.py``.  The polar Jacobian is never
materialized: its pattern is the branch incidence structure, computed
once per (case, topology) by :func:`jacobian_pattern`, and every Newton
step only re-fills its values — kernel S1
:func:`~freedm_tpu_torch.kernels.sparse_kernels.sparse_assemble`, which
also gives the masked mismatch.  The update solves J dx = −f with one
cycle of the s-step right-preconditioned block GMRES
(:func:`~freedm_tpu_torch.pf.krylov._pgmres_block`, kernels S3 and S4)
whose operator is S2
:func:`~freedm_tpu_torch.kernels.sparse_kernels.sparse_matvec` and whose
preconditioner is the FDLF pair, built once per solver
(:func:`~freedm_tpu_torch.pf.krylov.build_fdlf_precond`).

Where the reference ``vmap``s ``lax.while_loop``s, the lane axis is
written out, as in :mod:`freedm_tpu_torch.pf.newton`:

- ``precision="f64"``: a lane steps while ``it < max_iter`` and the
  mismatch its last step started from is ``>= tol`` — K3
  :func:`~freedm_tpu_torch.kernels.newton_kernels.newton_update`'s
  contract, reused unchanged.
- ``precision="mixed"``: two batched loops in sequence, as a ``vmap`` of
  two ``while_loop``s runs.  Phase 1 takes float32 inner solves under the
  full-precision acceptance oracle (best iterate, ``_MIXED_ACCEPT_RATIO``,
  a lane stops after ``_MIXED_STALL_STEPS`` steps without progress);
  phase 2 resumes every lane from its best iterate with full-precision
  steps, each counted on ``fallbacks``.

Each loop reads "any lane active?" on the host once per Newton
iteration; the GMRES cycle reads nothing back.  A lane's non-finite
inner solve falls back to one preconditioned first-order step for that
lane alone.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from freedm_tpu_torch.device import DeviceLike, platform_name, resolve_device
from freedm_tpu_torch.grid.bus import PQ, SLACK, BusSystem, branch_admittances
from freedm_tpu_torch.kernels import newton_kernels as nk
from freedm_tpu_torch.kernels import sparse_kernels as sk
from freedm_tpu_torch.pf.backend import resolve_precision
from freedm_tpu_torch.pf.krylov import (
    _MIXED_ACCEPT_RATIO,
    _MIXED_STALL_STEPS,
    _pgmres_block,
    build_fdlf_precond,
    fdlf_apply,
)
from freedm_tpu_torch.pf.newton import build_result, default_tol, lane_prep


class JacobianPattern(NamedTuple):
    """The symbolic half of the BCSR Jacobian for one (case, topology),
    as host numpy arrays: the branch ends (the column gathers), the
    bus-sorted incidence list the kernels reduce over (see
    :class:`~freedm_tpu_torch.kernels.sparse_kernels.SparseOperands`),
    and the bookkeeping (nnz of the [2n, 2n] Jacobian, block count)."""

    n: int
    m: int
    f: np.ndarray  # [m] branch from-bus
    t: np.ndarray  # [m] branch to-bus
    nnz: int
    blocks: int
    inc_ptr: np.ndarray  # [n+1] int32
    inc_code: np.ndarray  # [2m] int32: 2·edge + side
    inc_nbr: np.ndarray  # [2m] int32: the edge's other end


#: (n_bus, from_bus bytes, to_bus bytes) -> JacobianPattern, bounded.
_PATTERN_CACHE: "OrderedDict[tuple, JacobianPattern]" = OrderedDict()
_PATTERN_CACHE_MAX = 64
#: Engines are built from executor threads: one lock guards the cache
#: and the counter.
_PATTERN_LOCK = threading.Lock()

#: Patterns actually built (cache misses) since import: one per (case,
#: topology), however many solvers and lanes use it.
pattern_builds = 0


def _incidence(n: int, f: np.ndarray, t: np.ndarray):
    """Per bus: the edges it is the from end of, then those it is the to
    end of, each ascending — as CSR ``(ptr, code, nbr)`` int32 arrays."""
    m = f.shape[0]
    edges = np.arange(m)
    bus = np.concatenate([f, t])
    side = np.concatenate([np.zeros(m, np.int64), np.ones(m, np.int64)])
    edge = np.concatenate([edges, edges])
    nbr = np.concatenate([t, f])
    order = np.lexsort((edge, side, bus))
    ptr = np.concatenate([[0], np.cumsum(np.bincount(bus, minlength=n))])
    code = 2 * edge[order] + side[order]
    return (ptr.astype(np.int32), code.astype(np.int32),
            nbr[order].astype(np.int32))


def jacobian_pattern(sys: BusSystem) -> JacobianPattern:
    """The cached symbolic pattern of ``sys``'s branch incidence; the key
    is the topology itself, so solvers over the same case (any dtype,
    dense and sparse side by side) share one pattern."""
    global pattern_builds
    f_np = np.asarray(sys.from_bus, np.int64)
    t_np = np.asarray(sys.to_bus, np.int64)
    key = (sys.n_bus, f_np.tobytes(), t_np.tobytes())
    with _PATTERN_LOCK:
        pat = _PATTERN_CACHE.get(key)
        if pat is not None:
            _PATTERN_CACHE.move_to_end(key)
            return pat
        # Each of the 4 polar blocks has the Ybus pattern: n diagonal
        # entries + one per unique off-diagonal pair (parallel branches
        # merge).
        pairs = np.unique(
            np.stack([np.minimum(f_np, t_np), np.maximum(f_np, t_np)], 1),
            axis=0,
        )
        off_pairs = int(np.sum(pairs[:, 0] != pairs[:, 1]))
        ptr, code, nbr = _incidence(sys.n_bus, f_np, t_np)
        pat = JacobianPattern(
            n=sys.n_bus, m=sys.n_branch, f=f_np, t=t_np,
            nnz=4 * (sys.n_bus + 2 * off_pairs), blocks=4,
            inc_ptr=ptr, inc_code=code, inc_nbr=nbr,
        )
        pattern_builds += 1
        _PATTERN_CACHE[key] = pat
        while len(_PATTERN_CACHE) > _PATTERN_CACHE_MAX:
            _PATTERN_CACHE.popitem(last=False)
        return pat


def sparse_operands(sys: BusSystem, dtype: torch.dtype = torch.float64,
                    device: DeviceLike = None) -> sk.SparseOperands:
    """The kernels' operands for ``sys`` on ``device``: its pattern, the
    per-edge admittances and the Ybus diagonal (all in service), the
    latter stamped on the host in float64 in the reference's order
    (from-end terms, then to-end terms, then the shunt)."""
    dev = resolve_device(device)
    pat = jacobian_pattern(sys)
    yff, yft, ytf, ytt = branch_admittances(sys)
    n = sys.n_bus

    def seg(vals, idx):
        out = np.zeros(n)
        np.add.at(out, idx, vals)
        return out

    g_d = seg(yff[0], pat.f) + seg(ytt[0], pat.t) + np.asarray(sys.g_shunt,
                                                                 np.float64)
    b_d = seg(yff[1], pat.f) + seg(ytt[1], pat.t) + np.asarray(sys.b_shunt,
                                                                 np.float64)
    bt = np.asarray(sys.bus_type)

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    def vec(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev).to(dtype)

    return sk.SparseOperands(
        f_idx=idx(pat.f), t_idx=idx(pat.t), inc_ptr=idx(pat.inc_ptr),
        inc_code=idx(pat.inc_code), inc_nbr=idx(pat.inc_nbr),
        yft_re=vec(yft[0]), yft_im=vec(yft[1]), ytf_re=vec(ytf[0]),
        ytf_im=vec(ytf[1]), g_d=vec(g_d), b_d=vec(b_d),
        th_free=vec(bt != SLACK), v_free=vec(bt == PQ), v_set=vec(sys.v_set),
    )


def make_sparse_newton_solver(
    sys: BusSystem,
    tol: Optional[float] = None,
    max_iter: int = 12,
    inner_iters: int = 16,
    dtype: torch.dtype = torch.float64,
    precond_dtype: torch.dtype = torch.bfloat16,
    precond=None,
    precond_kind: Optional[str] = None,
    precision: str = "auto",
    block_size: int = 4,
    device: DeviceLike = None,
    plain: bool = False,
    mesh=None,
):
    """Build the BCSR sparse Newton solvers for a bus system.

    Returns ``(solve, solve_fixed)`` with the call signature and the
    :class:`~freedm_tpu_torch.pf.newton.NewtonResult` output of
    :func:`~freedm_tpu_torch.pf.newton.make_newton_solver`, which hands
    ``backend="sparse"`` (and ``"auto"`` at 512 buses or more) here.

    ``inner_iters`` is the GMRES dimension of the inexact-Newton inner
    solve and ``block_size`` its s-step block.  ``precond`` optionally
    passes a built :class:`~freedm_tpu_torch.pf.krylov.FdlfPrecond`;
    otherwise one is built here (``precond_kind`` and ``precond_dtype``
    as in ``build_fdlf_precond``).  ``precision``: ``"f64"`` runs the
    inner solve in ``dtype``, ``"mixed"`` in float32 with the
    full-precision acceptance oracle and per-lane fallback, ``"auto"``
    picks mixed on the card and f64 on the CPU.  ``plain=True`` runs the
    kernels' plain versions on any device.  ``solve_fixed`` takes
    ``max_iter`` steps on every lane (for mixed: ``max_iter − 1`` mixed
    steps and one full-precision step, ``fallbacks`` counting stalled
    steps) and is forward-only on the card.  Per-lane branch ``status``
    and the ``mesh=`` form are not ported and raise.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the mesh-sharded solver form is not ported (ROADMAP.md, module "
            "queue item 16: multi-GPU lane sharding)"
        )
    dev = resolve_device(device)
    precision = resolve_precision(precision, platform_name(dev))
    if dtype not in (torch.float64, torch.float32):
        raise TypeError(f"dtype must be float64 or float32, got {dtype}")
    tol = float(default_tol(dtype) if tol is None else tol)
    max_iter = int(max_iter)
    n = sys.n_bus
    inner_dtype = torch.float32

    op = sparse_operands(sys, dtype=dtype, device=dev)
    op_lo = op.to_dtype(inner_dtype)
    free = torch.cat([op.th_free, op.v_free])
    v_flat = torch.where(op.v_free > 0, torch.ones_like(op.v_set), op.v_set)
    p_sched0 = torch.as_tensor(np.asarray(sys.p_inj, np.float64),
                               device=dev).to(dtype)
    q_sched0 = torch.as_tensor(np.asarray(sys.q_inj, np.float64),
                               device=dev).to(dtype)
    tol_t = torch.full((1,), tol, dtype=dtype, device=dev)
    if precond is None:
        precond = build_fdlf_precond(sys, dtype=dtype,
                                     precond_dtype=precond_dtype,
                                     kind=precond_kind, device=dev)

    if plain:
        assemble, matvec, update = (sk.sparse_assemble_plain,
                                    sk.sparse_matvec_plain,
                                    nk.newton_update_plain)
    else:
        assemble, matvec, update = (sk.sparse_assemble, sk.sparse_matvec,
                                    nk.newton_update)

    def mismatch(f):
        return torch.amax(torch.abs(f * free), dim=1)

    def apply_precond(u, v_now, out_dtype):
        return fdlf_apply(precond, op.th_free, op.v_free, u, v_now,
                          out_dtype)

    def gmres(ev, bv, o, rhs, v_now):
        return _pgmres_block(
            lambda u: matvec(ev, bv, u, o),
            lambda u: apply_precond(u, v_now, rhs.dtype),
            rhs, m=inner_iters, s=block_size, plain=plain,
        )

    def safe(dx, fres, v):
        """The breakdown net, lane by lane: a lane whose inner solve is
        not finite takes one preconditioned first-order step."""
        ok = torch.isfinite(dx).all(dim=1, keepdim=True)
        return torch.where(ok, dx, apply_precond(-fres, v, dtype))

    def step(x, ps, qs):
        """Full-precision update: ``(dx, f)`` with ``f`` the mismatch
        the step starts from."""
        ev, bv, fres = assemble(x, ps, qs, op)
        v = x[:, n:]
        return safe(gmres(ev, bv, op, -fres, v), fres, v), fres

    def step_mixed(x, ps, qs):
        """Mixed update: float32 inner solve, then ``(x_new, err1)`` with
        ``err1`` the full-precision mismatch at ``x_new``."""
        ev, bv, fres = assemble(x, ps, qs, op)
        v = x[:, n:]
        dx = gmres(ev.to(inner_dtype), bv.to(inner_dtype), op_lo,
                   (-fres).to(inner_dtype), v.to(inner_dtype))
        x_new = x + safe(dx.to(dtype), fres, v)
        return x_new, mismatch(assemble(x_new, ps, qs, op)[2])

    def finish(x, ps, qs, it, fallbacks):
        _, bv, f = assemble(x, ps, qs, op)
        r = build_result(x, bv[:, 4].contiguous(), bv[:, 5].contiguous(), f,
                         free, it, tol)
        return r._replace(fallbacks=fallbacks)

    prep = lane_prep(n, dtype, dev, p_sched0, q_sched0, v_flat)

    def lane_zeros(x):
        return torch.zeros(x.shape[0], dtype=torch.int32, device=dev)

    def solve_f64(x, ps, qs):
        it = lane_zeros(x)
        err = torch.full((x.shape[0],), float("inf"), dtype=dtype, device=dev)
        active = (it < max_iter) & (err >= tol_t)
        while bool(active.any()):  # the one host sync per iteration
            dx, f = step(x, ps, qs)
            update(x, dx, f, free, it, err, active, max_iter, tol_t)
        return finish(x, ps, qs, it, lane_zeros(x))

    def solve_mixed(x, ps, qs):
        # Phase 1: mixed steps under the best-iterate oracle, seeded with
        # the start point's full-precision mismatch.
        best = mismatch(assemble(x, ps, qs, op)[2])
        x_best = x.clone()
        it, stall = lane_zeros(x), lane_zeros(x)

        def phase1_active():
            return ((it < max_iter) & (best >= tol_t)
                    & (stall < _MIXED_STALL_STEPS))

        active = phase1_active()
        while bool(active.any()):
            x_new, err1 = step_mixed(x, ps, qs)
            improved = err1 < _MIXED_ACCEPT_RATIO * best
            x_best = torch.where((active & (err1 < best))[:, None], x_new,
                                 x_best)
            best = torch.where(active, torch.minimum(best, err1), best)
            stall = torch.where(active, torch.where(improved, 0, stall + 1),
                                stall).to(torch.int32)
            x = torch.where(active[:, None], x_new, x)
            it = it + active.to(torch.int32)
            active = phase1_active()
        # Phase 2: full-precision steps from each lane's best iterate,
        # carrying the post-update mismatch; each step is a fallback.
        x, err, fb = x_best, best, lane_zeros(x)
        active = (it < max_iter) & (err >= tol_t)
        while bool(active.any()):
            dx, _ = step(x, ps, qs)
            f_post = assemble(x + dx, ps, qs, op)[2]
            fb += active.to(torch.int32)
            update(x, dx, f_post, free, it, err, active, max_iter, tol_t)
        return finish(x, ps, qs, it, fb)

    def solve(p_inj=None, q_inj=None, status=None, v0=None, theta0=None):
        x, ps, qs = prep(p_inj, q_inj, status, v0, theta0)
        if precision == "mixed":
            return solve_mixed(x, ps, qs)
        return solve_f64(x, ps, qs)

    def solve_fixed(p_inj=None, q_inj=None, status=None, v0=None,
                    theta0=None):
        tensors = [a for a in (p_inj, q_inj, v0, theta0)
                   if isinstance(a, torch.Tensor)]
        if dev.type == "cuda" and any(t.requires_grad for t in tensors):
            raise NotImplementedError(
                "solve_fixed is forward-only on the card: its backward "
                "kernels come with the VVC/gradient slice (ROADMAP.md)"
            )
        x, ps, qs = prep(p_inj, q_inj, status, v0, theta0)
        fb = lane_zeros(x)
        if precision == "mixed":
            best = torch.full((x.shape[0],), float("inf"), dtype=dtype,
                              device=dev)
            for _ in range(max(max_iter - 1, 0)):
                x, err1 = step_mixed(x, ps, qs)
                stalled = ((err1 >= _MIXED_ACCEPT_RATIO * best)
                           & (best >= tol_t))
                best = torch.minimum(best, err1)
                fb = fb + stalled.to(torch.int32)
            steps = 1 if max_iter > 0 else 0  # the full-precision endgame
        else:
            steps = max_iter
        for _ in range(steps):
            x = x + step(x, ps, qs)[0]
        it = torch.full((x.shape[0],), max_iter, dtype=torch.int32,
                        device=dev)
        return finish(x, ps, qs, it, fb)

    return solve, solve_fixed
