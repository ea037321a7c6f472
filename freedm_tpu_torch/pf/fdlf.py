"""Fast-decoupled load flow (XB scheme): B′, B″ and the batched solver.

Port of ``freedm_tpu/pf/fdlf.py``.  The Stott–Alsac decoupling splits the
Newton system into two constant matrices,

    B′ · Δθ = ΔP / V        (P–θ half-iteration)
    B″ · ΔV = ΔQ / V        (Q–V half-iteration),

with B′ from branch 1/x alone and B″ = −Im Ybus, pinned rows and columns
identity.  :func:`decoupled_parts` stamps both on the host in float64, in
the reference's ``.at[].add`` order — (f, f), (t, t), (f, t), (t, f) —
the way :func:`~freedm_tpu_torch.grid.bus.ybus_pair` stamps Ybus; the
sparse backend's preconditioner, the SMW N-1 screen and the DC screen
use it.

:func:`make_fdlf_solver` is the reference's solver with its lane axis
written out.  Without a branch status B′ and B″ are LU-factorized once,
at build time, and every lane shares the factors: one
``torch.linalg.lu_solve`` a half-step carries all lanes as right-hand
sides.  With a per-lane status each lane stamps its Ybus, B′ and B″ (Y1,
:func:`~freedm_tpu_torch.kernels.solver_kernels.ybus_stamp`) and
factorizes them once per solve (batched ``lu_factor``), as the
reference's ``_prep`` does.  Around the two LU solves an iteration is two
launches of F1 (:func:`~freedm_tpu_torch.kernels.solver_kernels.
fdlf_half_step`): the θ half (update, then ΔQ at the new θ) and the V
half (update, then ΔP, ΔQ, the lane's error, its count and its flag).
``solve`` reads the lanes' flags on the host once an iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from freedm_tpu_torch.device import DeviceLike, resolve_device
from freedm_tpu_torch.grid.bus import (PQ, SLACK, BusSystem, stamp_lanes,
                                       stamp_operands, ybus_dense, ybus_pair)
from freedm_tpu_torch.kernels import newton_kernels as nk
from freedm_tpu_torch.kernels import solver_kernels as sol


class DecoupledParts(NamedTuple):
    """Masks and the functions that build B′ and B″."""

    th_free: torch.Tensor  # [n] 1.0 where θ is unknown
    v_free: torch.Tensor  # [n] 1.0 where V is unknown
    b_prime: Callable  # (status | None) -> [n, n]
    b_dblprime: Callable  # (Im Ybus [n, n], numpy or tensor) -> [n, n]


def _pin(m: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """Pinned rows and columns become identity (the reference's
    ``m * keep[:, None] * keep[None, :] + diag(1 - keep)``)."""
    m = m * keep[:, None] * keep[None, :]
    return m + np.diag(1.0 - keep)


def decoupled_parts(sys: BusSystem, dtype: torch.dtype = torch.float64,
                    device: DeviceLike = None) -> DecoupledParts:
    """The XB-scheme decoupled matrices of a bus system.

    B′ comes from series 1/x alone (r, shunts and taps dropped); B″ is
    −Im(Ybus) on the PQ block.  Pinned rows and columns (slack θ,
    PV/slack V) are identity.  Matrices come back as ``dtype`` tensors on
    ``device`` (``cuda`` unless the CPU is asked for).
    """
    dev = resolve_device(device)
    bus_type = np.asarray(sys.bus_type)
    th_keep = (bus_type != SLACK).astype(np.float64)
    v_keep = (bus_type == PQ).astype(np.float64)
    n = sys.n_bus
    inv_x = 1.0 / np.asarray(sys.x, np.float64)
    f = np.asarray(sys.from_bus)
    t = np.asarray(sys.to_bus)

    def to_dev(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    def b_prime(status=None) -> torch.Tensor:
        on = (np.ones(sys.n_branch) if status is None
              else np.asarray(status, np.float64))
        w = inv_x * on
        m = np.zeros((n, n))
        np.add.at(m, (f, f), w)
        np.add.at(m, (t, t), w)
        np.add.at(m, (f, t), -w)
        np.add.at(m, (t, f), -w)
        return to_dev(_pin(m, th_keep))

    def b_dblprime(y_im) -> torch.Tensor:
        if isinstance(y_im, torch.Tensor):
            y_im = y_im.detach().cpu().numpy()
        return to_dev(_pin(-np.asarray(y_im, np.float64), v_keep))

    return DecoupledParts(to_dev(th_keep), to_dev(v_keep), b_prime,
                          b_dblprime)


def lane_parts(sys: BusSystem, status, op, plain: bool = False):
    """Ybus, B′ and B″ for a branch ``status`` on ``op``'s device (Y1 in
    its three modes, or Y1's plain version): ``((y_re, y_im), b_p, b_q)``,
    each ``[n, n]`` for a shared ``[m]`` status and ``[B, n, n]`` for
    ``[B, m]`` (:func:`~freedm_tpu_torch.grid.bus.stamp_lanes`)."""
    dt, dev = op.g_sh.dtype, op.g_sh.device
    return tuple(stamp_lanes(mode, sys, status, dtype=dt, device=dev, op=op,
                             plain=plain)
                 for mode in (sol.YBUS, sol.BPRIME, sol.BDBL))


def record_result(result) -> None:
    """Publish an FDLF result to the solver metrics under
    ``solver="fdlf"`` (:func:`freedm_tpu_torch.pf.newton.record_result`'s
    contract: call it where the result is read on the host anyway)."""
    from freedm_tpu_torch.pf.newton import record_result as record

    record(result, solver="fdlf")


def make_fdlf_solver(
    sys: BusSystem,
    tol: Optional[float] = None,
    max_iter: int = 40,
    dtype: torch.dtype = torch.float64,
    device: DeviceLike = None,
    plain: bool = False,
    adjoint: bool = False,
):
    """Build the fast-decoupled solvers of a bus system.

    Returns ``(solve, solve_fixed)`` with the call signature and the
    :class:`~freedm_tpu_torch.pf.newton.NewtonResult` output of
    :func:`~freedm_tpu_torch.pf.newton.make_newton_solver`: optional ``[B,
    n]`` overrides ``p_inj, q_inj, v0, theta0`` and a branch ``status``
    (``[m]`` or ``[B, m]``).  ``solve`` iterates each lane while ``it <
    max_iter`` and the error of its last iteration (``max |ΔP·V| ∨
    |ΔQ·V|``, infinite before the first) is ``>= tol``, freezing converged
    lanes as the reference's vmapped ``while_loop`` does; ``solve_fixed``
    runs exactly ``max_iter`` iterations on every lane.  ``mismatch`` is
    that error and ``converged`` is ``mismatch < tol``.  ``tol=None`` is
    1e-8 in float64 and 3e-5 in float32.  ``plain=True`` runs the kernels'
    plain versions on any device.  ``device`` is ``cuda`` unless the CPU
    is asked for.

    ``solve_fixed`` is differentiable in ``p_inj``, ``q_inj``, ``v0`` and
    ``theta0``: on the CPU and with ``plain=True`` autograd records the
    plain versions' iterations; on the card
    :class:`~freedm_tpu_torch.pf.adjoint.FdlfFixed` saves the state after
    every half-step and walks them back (the library LU's adjoint solves
    and J2).  ``adjoint`` as in
    :func:`~freedm_tpu_torch.pf.newton.make_newton_solver`.
    """
    from freedm_tpu_torch.pf import adjoint as adj
    from freedm_tpu_torch.pf.newton import (NewtonResult, any_active,
                                            default_tol, lane_prep)

    dev = resolve_device(device)
    if dtype not in (torch.float64, torch.float32):
        raise TypeError(f"dtype must be float64 or float32, got {dtype}")
    tol = float(default_tol(dtype) if tol is None else tol)
    max_iter = int(max_iter)
    n = sys.n_bus
    half = sol.fdlf_half_step_plain if plain else sol.fdlf_half_step
    injections = nk.power_injections_plain if plain else nk.power_injections

    parts = decoupled_parts(sys, dtype=dtype, device=dev)
    th_free, v_free = parts.th_free, parts.v_free
    v_set = torch.as_tensor(np.asarray(sys.v_set, np.float64),
                            device=dev).to(dtype)
    p_sched0 = torch.as_tensor(np.asarray(sys.p_inj, np.float64),
                               device=dev).to(dtype)
    q_sched0 = torch.as_tensor(np.asarray(sys.q_inj, np.float64),
                               device=dev).to(dtype)
    v_flat = torch.where(v_free > 0, torch.ones_like(v_set), v_set)
    tol_t = torch.full((1,), tol, dtype=dtype, device=dev)
    # Without a status B′ and B″ are solver constants: factorized once here
    # and shared by every solve and every lane.
    y0 = ybus_dense(sys, dtype=dtype, device=dev)
    lu_p0 = torch.linalg.lu_factor(parts.b_prime(None))
    lu_q0 = torch.linalg.lu_factor(parts.b_dblprime(ybus_pair(sys)[1]))
    stamp_op = stamp_operands(sys, dtype=dtype, device=dev)  # Y1's
    prep = lane_prep(n, dtype, dev, p_sched0, q_sched0, v_flat,
                     m=sys.n_branch)

    def factors(status):
        """``(y, lu_p, lu_q, shared)`` for the lanes' topology."""
        if status is None:
            return y0, lu_p0, lu_q0, True
        y, b_p, b_q = lane_parts(sys, status, stamp_op, plain)
        # An islanded lane's singular matrix gives inf/NaN in that lane
        # alone, as the reference's lu_factor does, instead of an error.
        lu_p, lu_q = (torch.linalg.lu_factor_ex(b)[:2] for b in (b_p, b_q))
        return y, lu_p, lu_q, b_p.dim() == 2

    lu_half = adj.lu_half  # [B, n], F1 reads the solve through its strides

    def sparse_ops():
        from freedm_tpu_torch.pf.sparse import sparse_operands

        return sparse_operands(sys, dtype=dtype, device=dev)

    j2 = adj.lazy_residual_vjp(sparse_ops, plain)

    def result(x, p, q, it, err):
        return NewtonResult(v=x[:, n:].contiguous(), theta=x[:, :n].contiguous(),
                            p=p, q=q, iterations=it, converged=err < tol,
                            mismatch=err, fallbacks=torch.zeros_like(it))

    def run(p_inj, q_inj, status, v0, theta0, fixed):
        x, ps, qs, st = prep(p_inj, q_inj, status, v0, theta0)
        y, lu_p, lu_q, shared = factors(status)
        if fixed and adj.function_route(adjoint, dev, plain, x, ps, qs, st):
            adj.refuse_status_grad(st)
            route = adj.FdlfRoute(
                half, y, lu_p, lu_q, shared, injections,
                lambda xx, w: j2(xx, w, sol.FULL, st), th_free, v_free,
                v_set, tol_t, max_iter)
            x, p, q, err = adj.FdlfFixed.apply(ps, qs, x, route)
            it = torch.full((x.shape[0],), max_iter, dtype=torch.int32,
                            device=dev)
            return result(x, p, q, it, err)
        lanes = x.shape[0]
        dp = torch.empty(lanes, n, dtype=dtype, device=dev)
        dq = torch.empty_like(dp)
        it = torch.zeros(lanes, dtype=torch.int32, device=dev)
        err = torch.full((lanes,), float("inf"), dtype=dtype, device=dev)
        active = ((it < max_iter) & (err >= tol_t)) if not fixed else (
            torch.ones(lanes, dtype=torch.bool, device=dev))
        carry = (th_free, v_free, dp, dq, err, it, active, tol_t, max_iter,
                 fixed)

        def iteration():
            half(sol.THETA, x, lu_half(lu_p, dp, shared), y[0], y[1], ps, qs,
                 *carry)
            half(sol.VHALF, x, lu_half(lu_q, dq, shared), y[0], y[1], ps, qs,
                 *carry)

        half(sol.INIT, x, None, y[0], y[1], ps, qs, *carry)
        if fixed:
            for _ in range(max_iter):
                iteration()
            if max_iter == 0:  # the start point's error
                v = x[:, n:]
                err = torch.maximum(torch.amax(torch.abs(dp * v), dim=1),
                                    torch.amax(torch.abs(dq * v), dim=1))
        else:
            while any_active(active):  # the one host sync per iteration
                iteration()
        p, q, _ = injections(x, y[0], y[1], ps, qs, th_free, v_free, v_set)
        return result(x, p, q, it, err)

    def solve(p_inj=None, q_inj=None, status=None, v0=None, theta0=None):
        return run(p_inj, q_inj, status, v0, theta0, fixed=False)

    def solve_fixed(p_inj=None, q_inj=None, status=None, v0=None,
                    theta0=None):
        return run(p_inj, q_inj, status, v0, theta0, fixed=True)

    return solve, solve_fixed
