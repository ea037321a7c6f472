"""Sparse (BCSR) batched Newton power flow with pattern-reuse Krylov solves.

Port of ``freedm_tpu/pf/sparse.py``.  The polar Jacobian is never
materialized: its pattern is the branch incidence structure, computed
once per (case, topology) by :func:`jacobian_pattern`, and every Newton
step only re-fills its values — kernel S1
:func:`~freedm_tpu_torch.kernels.sparse_kernels.sparse_assemble`, which
also gives the masked mismatch: the mixed step takes its float32 values
straight from the float64 arithmetic (``VALUES_F32``), and where only the
mismatch or P and Q are read, S1 runs its ``RESIDUAL`` mode.  The update
solves J dx = −f with one cycle of the s-step right-preconditioned block
GMRES (:func:`~freedm_tpu_torch.pf.krylov._pgmres_block`, kernels S3 and
S4) whose operator is S2
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
from freedm_tpu_torch.kernels import solver_kernels as sol
from freedm_tpu_torch.kernels import sparse_kernels as sk
from freedm_tpu_torch.pf import adjoint as adj
from freedm_tpu_torch.pf.backend import resolve_precision
from freedm_tpu_torch.pf.krylov import (
    _MIXED_ACCEPT_RATIO,
    _MIXED_STALL_STEPS,
    _pgmres_block,
    build_fdlf_precond,
    fdlf_apply,
)
from freedm_tpu_torch.pf.newton import (any_active, build_result, default_tol,
                                        lane_prep)


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
    two-port admittance of each incidence-list entry's side and the Ybus
    diagonal (all in service), the latter stamped on the host in float64
    in the reference's order (from-end terms, then to-end terms, then the
    shunt); for a per-lane status, each entry's self admittance and the
    shunts."""
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

    edge, to = pat.inc_code >> 1, (pat.inc_code & 1).astype(bool)
    return sk.SparseOperands(
        inc_ptr=idx(pat.inc_ptr), inc_code=idx(pat.inc_code),
        inc_nbr=idx(pat.inc_nbr),
        inc_g=vec(np.where(to, ytf[0][edge], yft[0][edge])),
        inc_b=vec(np.where(to, ytf[1][edge], yft[1][edge])),
        g_d=vec(g_d), b_d=vec(b_d),
        th_free=vec(bt != SLACK), v_free=vec(bt == PQ), v_set=vec(sys.v_set),
        inc_gs=vec(np.where(to, ytt[0][edge], yff[0][edge])),
        inc_bs=vec(np.where(to, ytt[1][edge], yff[1][edge])),
        g_sh=vec(sys.g_shunt), b_sh=vec(sys.b_shunt),
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
    adjoint: bool = False,
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
    steps); its gradient on the card is one adjoint solve at the last
    iterate (``adjoint`` as in
    :func:`~freedm_tpu_torch.pf.newton.make_newton_solver`;
    :func:`newton_krylov`).  ``status`` (``[m]`` or
    ``[B, m]`` 0/1 branch in-service factors) runs each lane on its own
    topology, every S1 call scaling that lane's admittances; the
    preconditioner stays the base topology's pair, as in the reference.
    The ``mesh=`` form is not ported and raises.
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
    op = sparse_operands(sys, dtype=dtype, device=dev)
    op_lo = op.to_dtype(torch.float32)
    if precond is None:
        precond = build_fdlf_precond(sys, dtype=dtype,
                                     precond_dtype=precond_dtype,
                                     kind=precond_kind, device=dev)
    assemble = sk.sparse_assemble_plain if plain else sk.sparse_assemble
    matvec = sk.sparse_matvec_plain if plain else sk.sparse_matvec
    # S1's float32 value fill for the mixed inner solve (from float64
    # arithmetic; in a float32 solver the full fill already is float32).
    values_lo = sk.VALUES_F32 if dtype == torch.float64 else sk.FULL

    def linearize(x, ps, qs, st):
        """J's values at ``x`` (S1) and ``u -> J u`` (S2)."""
        ev, bv, fres = assemble(x, ps, qs, op, sk.FULL, st)
        return (lambda u: matvec(ev, bv, u, op)), fres

    def linearize_lo(x, ps, qs, st):
        ev, bv, fres = assemble(x, ps, qs, op, values_lo, st)
        return (lambda u: matvec(ev, bv, u, op_lo)), fres

    return newton_krylov(sys, op, precond, linearize, linearize_lo, tol=tol,
                         max_iter=max_iter, inner_iters=inner_iters,
                         dtype=dtype, precision=precision,
                         block_size=block_size, plain=plain, adjoint=adjoint)


def newton_krylov(sys: BusSystem, op: sk.SparseOperands, precond,
                  linearize, linearize_lo, tol: Optional[float],
                  max_iter: int, inner_iters: int, dtype: torch.dtype,
                  precision: str, block_size: int, plain: bool,
                  adjoint: bool = False):
    """The inexact-Newton loops over lanes that the sparse backend and the
    matrix-free solver (:func:`~freedm_tpu_torch.pf.krylov.
    make_krylov_solver`) share; they differ in the operator of the inner
    solve alone.

    ``linearize(x, ps, qs, st) -> (a_op, f)`` gives the full-precision
    operator ``u -> J u`` at ``x`` and the mismatch ``f`` there;
    ``linearize_lo`` the float32 operator of the mixed step with ``f`` in
    ``dtype``.  ``precision`` is resolved (``"f64"`` or ``"mixed"``);
    ``op`` (on the solver's device, in ``dtype``) gives the masks and S1's
    residual mode.  Returns ``(solve, solve_fixed)`` (module docstring).

    ``solve_fixed``'s Function route (``adjoint``, as in
    :func:`~freedm_tpu_torch.pf.newton.make_newton_solver`) solves ``J(x*)ᵀ
    λ = ḡ`` in float64 whatever ``precision``: restarted GMRES
    (:func:`~freedm_tpu_torch.pf.adjoint.adjoint_gmres`, the cycle's
    dimension and block as the forward's) with J2 in MASKED mode as the
    operator and the FDLF pair transposed as the preconditioner.
    """
    dev = op.th_free.device
    tol = float(default_tol(dtype) if tol is None else tol)
    max_iter = int(max_iter)
    n = sys.n_bus
    inner_dtype = torch.float32
    free = torch.cat([op.th_free, op.v_free])
    v_flat = torch.where(op.v_free > 0, torch.ones_like(op.v_set), op.v_set)
    p_sched0 = torch.as_tensor(np.asarray(sys.p_inj, np.float64),
                               device=dev).to(dtype)
    q_sched0 = torch.as_tensor(np.asarray(sys.q_inj, np.float64),
                               device=dev).to(dtype)
    tol_t = torch.full((1,), tol, dtype=dtype, device=dev)
    assemble = sk.sparse_assemble_plain if plain else sk.sparse_assemble
    update = nk.newton_update_plain if plain else nk.newton_update

    def mismatch(f):
        return torch.amax(torch.abs(f * free), dim=1)

    def residual(x, ps, qs, st):
        """``f`` at ``x`` (S1's residual mode)."""
        return assemble(x, ps, qs, op, sk.RESIDUAL, st)[2]

    def apply_precond(u, v_now, out_dtype):
        return fdlf_apply(precond, op.th_free, op.v_free, u, v_now,
                          out_dtype)

    def gmres(a_op, rhs, v_now):
        return _pgmres_block(
            a_op, lambda u: apply_precond(u, v_now, rhs.dtype),
            rhs, m=inner_iters, s=block_size, plain=plain,
        )

    def safe(dx, fres, v):
        """The breakdown net, lane by lane: a lane whose inner solve is
        not finite takes one preconditioned first-order step."""
        ok = torch.isfinite(dx).all(dim=1, keepdim=True)
        return torch.where(ok, dx, apply_precond(-fres, v, dtype))

    def step(x, ps, qs, st):
        """Full-precision update: ``(dx, f)`` with ``f`` the mismatch
        the step starts from."""
        a_op, fres = linearize(x, ps, qs, st)
        v = x[:, n:]
        return safe(gmres(a_op, -fres, v), fres, v), fres

    def step_mixed(x, ps, qs, st):
        """Mixed update: float32 inner solve, then ``(x_new, err1)`` with
        ``err1`` the full-precision mismatch at ``x_new``."""
        a_op, fres = linearize_lo(x, ps, qs, st)
        v = x[:, n:]
        dx = gmres(a_op, (-fres).to(inner_dtype), v.to(inner_dtype))
        x_new = x + safe(dx.to(dtype), fres, v)
        return x_new, mismatch(residual(x_new, ps, qs, st))

    def finish(x, ps, qs, st, it, fallbacks):
        p, q, f = assemble(x, ps, qs, op, sk.RESIDUAL, st)
        r = build_result(x, p, q, f, free, it, tol)
        return r._replace(fallbacks=fallbacks)

    prep = lane_prep(n, dtype, dev, p_sched0, q_sched0, v_flat,
                     m=sys.n_branch)

    def lane_zeros(x):
        return torch.zeros(x.shape[0], dtype=torch.int32, device=dev)

    def solve_f64(x, ps, qs, st):
        it = lane_zeros(x)
        err = torch.full((x.shape[0],), float("inf"), dtype=dtype, device=dev)
        active = (it < max_iter) & (err >= tol_t)
        while any_active(active):  # the one host sync per iteration
            dx, f = step(x, ps, qs, st)
            update(x, dx, f, free, it, err, active, max_iter, tol_t)
        return finish(x, ps, qs, st, it, lane_zeros(x))

    def solve_mixed(x, ps, qs, st):
        # Phase 1: mixed steps under the best-iterate oracle, seeded with
        # the start point's full-precision mismatch.
        best = mismatch(residual(x, ps, qs, st))
        x_best = x.clone()
        it, stall = lane_zeros(x), lane_zeros(x)

        def phase1_active():
            return ((it < max_iter) & (best >= tol_t)
                    & (stall < _MIXED_STALL_STEPS))

        active = phase1_active()
        while any_active(active):
            x_new, err1 = step_mixed(x, ps, qs, st)
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
        while any_active(active):
            dx, _ = step(x, ps, qs, st)
            f_post = residual(x + dx, ps, qs, st)
            fb += active.to(torch.int32)
            update(x, dx, f_post, free, it, err, active, max_iter, tol_t)
        return finish(x, ps, qs, st, it, fb)

    def solve(p_inj=None, q_inj=None, status=None, v0=None, theta0=None):
        x, ps, qs, st = prep(p_inj, q_inj, status, v0, theta0)
        if precision == "mixed":
            return solve_mixed(x, ps, qs, st)
        return solve_f64(x, ps, qs, st)

    j2 = adj.lazy_residual_vjp(  # float64, whatever the working dtype
        lambda: op.to_dtype(torch.float64), plain)

    def route(st, box):
        """Route B of :mod:`~freedm_tpu_torch.pf.adjoint`: GMRES on Jᵀ
        (J2 MASKED, S3, S4, Mᵀ) in float64."""
        st64 = None if st is None else st.to(torch.float64)
        f64 = torch.float64

        def forward(ps, qs, x0):
            x, box["fb"] = fixed_steps(x0, ps, qs, st)
            p, q, f = assemble(x, ps, qs, op, sk.RESIDUAL, st)
            return x, p, q, f

        def adjoint_solve(x, ps, qs, g):
            x64 = x.to(f64)
            lam, _, _ = adj.adjoint_gmres(
                lambda u: j2(x64, u, sol.MASKED, st64),
                adj.transposed_precond(precond, free[:n].to(f64),
                                       free[n:].to(f64), x64[:, n:]),
                g.to(f64), m=inner_iters, s=block_size, plain=plain)
            return lam.to(dtype)

        def injections_vjp(x, w):
            return j2(x.to(f64), w.to(f64), sol.FULL, st64).to(dtype)

        return adj.NewtonRoute(forward, adjoint_solve, injections_vjp,
                               op.th_free, op.v_free)

    def fixed_steps(x, ps, qs, st):
        """``max_iter`` steps on every lane: ``(x, fallbacks)``."""
        fb = lane_zeros(x)
        if precision == "mixed":
            best = torch.full((x.shape[0],), float("inf"), dtype=dtype,
                              device=dev)
            for _ in range(max(max_iter - 1, 0)):
                x, err1 = step_mixed(x, ps, qs, st)
                stalled = ((err1 >= _MIXED_ACCEPT_RATIO * best)
                           & (best >= tol_t))
                best = torch.minimum(best, err1)
                fb = fb + stalled.to(torch.int32)
            steps = 1 if max_iter > 0 else 0  # the full-precision endgame
        else:
            steps = max_iter
        for _ in range(steps):
            x = x + step(x, ps, qs, st)[0]
        return x, fb

    def solve_fixed(p_inj=None, q_inj=None, status=None, v0=None,
                    theta0=None):
        x, ps, qs, st = prep(p_inj, q_inj, status, v0, theta0)
        it = torch.full((x.shape[0],), max_iter, dtype=torch.int32,
                        device=dev)
        if adj.function_route(adjoint, dev, plain, x, ps, qs, st):
            adj.refuse_status_grad(st)
            box = {}
            x, p, q, f = adj.NewtonFixed.apply(ps, qs, x, route(st, box))
            r = build_result(x, p, q, f, free, it, tol)
            return r._replace(fallbacks=box["fb"])
        x, fb = fixed_steps(x, ps, qs, st)
        return finish(x, ps, qs, st, it, fb)

    return solve, solve_fixed
