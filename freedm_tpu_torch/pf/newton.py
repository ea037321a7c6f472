"""Batched Newton-Raphson AC power flow on the bus admittance matrix.

Port of ``freedm_tpu/pf/newton.py`` for the dense Jacobian backend.  The
formulation is the reference's: a masked full-size state ``x = θ ‖ V``
(``[2n]`` per lane) whose pinned quantities (slack θ, PV/slack V) get
trivial equations with identity Jacobian rows, and a hand-assembled
[2n, 2n] polar Jacobian.

Where the reference ``vmap``s a ``lax.while_loop``, the port writes the
lane axis out: every input is ``[B, n]`` and one iteration runs

1. K1 :func:`~freedm_tpu_torch.kernels.newton_kernels.newton_assemble`
   — mismatch and Jacobian for all lanes;
2. a batched LU solve (``torch.linalg.solve_ex``: a singular lane gets
   inf/NaN like ``jnp.linalg.solve`` instead of failing the batch);
3. K3 :func:`~freedm_tpu_torch.kernels.newton_kernels.newton_update` —
   the per-lane select: a lane steps only while ``it < max_iter`` and
   ``err >= tol`` held on its carry before the step, ``err`` being the
   mismatch the step started from.

The loop ends when no lane is active, which costs one host sync per
Newton iteration (the ``any()`` read) plus one for the last check.  The
final mismatch, P and Q come from K2
(:func:`~freedm_tpu_torch.kernels.newton_kernels.power_injections`).

A branch ``status`` runs each lane on its own topology, as the
reference's ``_prep`` stamps ``ybus_dense(sys, status)`` under ``vmap``:
``[B, m]`` stamps one Ybus a lane (Y1,
:func:`~freedm_tpu_torch.kernels.solver_kernels.ybus_stamp`) and K1/K2
read the ``[B, n, n]`` stack; a shared ``[m]`` status stamps once and
every lane reads that one matrix.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from freedm_tpu_torch.device import DeviceLike, platform_name, resolve_device
from freedm_tpu_torch.grid.bus import (PQ, SLACK, BusSystem, branch_admittances,
                                       stamp_operands, ybus_dense, ybus_lanes)
from freedm_tpu_torch.kernels import newton_kernels as nk
from freedm_tpu_torch.kernels import solver_kernels as sol
from freedm_tpu_torch.pf import adjoint as adj
from freedm_tpu_torch.pf.backend import resolve_backend, resolve_precision


class NewtonResult(NamedTuple):
    """Power-flow solution in per-unit, one row per lane."""

    v: torch.Tensor  # [B, n] voltage magnitudes
    theta: torch.Tensor  # [B, n] voltage angles, radians
    p: torch.Tensor  # [B, n] realized P injections (incl. slack)
    q: torch.Tensor  # [B, n] realized Q injections (incl. PV/slack)
    iterations: torch.Tensor  # [B] int32
    converged: torch.Tensor  # [B] bool
    mismatch: torch.Tensor  # [B] float: max |free-equation residual|
    #: [B] int32: mixed-precision fallbacks — always 0 on the dense path,
    #: which has no reduced-precision inner solve.
    fallbacks: torch.Tensor


def default_tol(dtype: torch.dtype) -> float:
    """The reference's dtype-dependent default: 1e-8 in float64, 3e-5
    in float32 (``freedm_tpu/pf/newton.py:241-242``)."""
    return 1e-8 if dtype == torch.float64 else 3e-5


def s_calc(y_re, y_im, theta, v):
    """Realized ``(P, Q)`` bus injections at ``[B, n]`` voltage profiles
    (K2, :func:`~freedm_tpu_torch.kernels.newton_kernels.power_injections`)."""
    n = y_re.shape[0]
    x = torch.cat([theta, v], dim=1).contiguous()
    zero = torch.zeros_like(theta)
    ones = torch.ones(n, dtype=x.dtype, device=x.device)
    p, q, _ = nk.power_injections(x, y_re, y_im, zero, zero, ones, ones,
                                  torch.zeros_like(ones))
    return p, q


def any_active(active: torch.Tensor) -> bool:
    """The Newton loops' condition, the reference ``while_loop``'s cond
    over the lanes: whether any lane of the ``[B]`` bool flags K3 (or the
    mixed phase's test) left is still active.  One copy of the flag bytes
    to the host — the loop's one sync — and no reduction launch on the
    card."""
    return bool(active.cpu().numpy().any())


def build_result(x, p, q, f, free, it, tol: float) -> NewtonResult:
    """Assemble the result record from a final state and K2's outputs."""
    n = p.shape[1]
    mismatch = torch.amax(torch.abs(f * free), dim=1)
    return NewtonResult(
        v=x[:, n:].contiguous(),
        theta=x[:, :n].contiguous(),
        p=p,
        q=q,
        iterations=it,
        converged=mismatch < tol,
        mismatch=mismatch,
        fallbacks=torch.zeros_like(it),
    )


def lane_prep(n: int, dtype: torch.dtype, dev: torch.device,
              p_sched0: torch.Tensor, q_sched0: torch.Tensor,
              v_flat: torch.Tensor, m: int):
    """The solvers' argument handling: ``prep(p_inj, q_inj, status, v0,
    theta0) -> (x [B, 2n], ps [B, n], qs [B, n], st)``, each optional
    ``[B, n]`` override (numpy or tensor) cast to ``dtype`` on ``dev``;
    omitted ones broadcast the stored schedule / the flat start, and
    ``B`` is 1 when every one is omitted.  ``status`` (the 0/1 branch
    in-service vector of ``m`` branches, ``[m]`` for every lane or ``[B,
    m]``) comes back as a contiguous ``[B, m]`` ``st``, ``None`` when
    omitted.  The caller's tensors are only read: ``x`` is new and the
    schedules are never written."""

    def as_lanes(a, name):
        if a is None:
            return None
        t = torch.as_tensor(a, dtype=dtype, device=dev)
        if t.dim() != 2 or t.shape[1] != n:
            raise ValueError(
                f"{name} must be [B, {n}] (one row per lane), got "
                f"{tuple(t.shape)}"
            )
        return t

    def as_status(a):
        if a is None:
            return None
        t = torch.as_tensor(a, dtype=dtype, device=dev)
        if t.shape[-1:] != (m,) or t.dim() not in (1, 2):
            raise ValueError(
                f"status must be [{m}] or [B, {m}], got {tuple(t.shape)}"
            )
        return t

    def prep(p_inj, q_inj, status, v0, theta0):
        st = as_status(status)
        args = {"p_inj": as_lanes(p_inj, "p_inj"),
                "q_inj": as_lanes(q_inj, "q_inj"),
                "v0": as_lanes(v0, "v0"), "theta0": as_lanes(theta0, "theta0")}
        lanes = {t.shape[0] for t in args.values() if t is not None}
        if st is not None and st.dim() == 2:
            lanes.add(st.shape[0])
        if len(lanes) > 1:
            raise ValueError(f"lane counts differ across arguments: {lanes}")
        b = lanes.pop() if lanes else 1
        if st is not None:
            st = st.expand(b, m).contiguous()

        def fill(t, default):
            return default.expand(b, n) if t is None else t

        ps = fill(args["p_inj"], p_sched0).contiguous()
        qs = fill(args["q_inj"], q_sched0).contiguous()
        x = torch.cat([fill(args["theta0"], torch.zeros_like(v_flat)),
                       fill(args["v0"], v_flat)], dim=1).contiguous()
        return x, ps, qs, st

    return prep


def make_newton_solver(
    sys: BusSystem,
    tol: Optional[float] = None,
    max_iter: int = 10,
    dtype: torch.dtype = torch.float64,
    backend: str = "dense",
    precision: str = "auto",
    device: DeviceLike = None,
    mesh=None,
    plain: bool = False,
    adjoint: bool = False,
):
    """Build the batched NR solvers for a bus system.

    Returns ``(solve, solve_fixed)``, each taking optional ``[B, n]``
    overrides ``p_inj, q_inj, v0, theta0`` (numpy or tensors; omitted
    ones broadcast the system's stored injections / the flat start, and
    ``B`` is 1 when every one is omitted) and returning a
    :class:`NewtonResult` of ``[B, ...]`` tensors on ``device``:

    - ``solve`` — iterates each lane until its max mismatch (pu) drops
      below ``tol`` or ``max_iter`` is hit, with the reference's
      vmapped ``while_loop`` semantics (per-lane iteration counts);
    - ``solve_fixed`` — always ``max_iter`` steps on every lane,
      differentiable in ``p_inj``, ``q_inj``, ``v0`` and ``theta0``.  On
      the CPU and with ``plain=True`` autograd records the plain versions'
      iterations (the reference's unrolled program); on the card the
      backward is one adjoint solve at the last iterate
      (:class:`~freedm_tpu_torch.pf.adjoint.NewtonFixed`: J2 and the library
      LU on K1's Jacobian).  ``adjoint=True`` takes that Function on any
      device (its plain route on the CPU or with ``plain``).  A ``status``
      that requires grad raises there.

    ``tol=None`` picks the dtype's default (:func:`default_tol`).
    ``backend`` resolves through
    :func:`~freedm_tpu_torch.pf.backend.resolve_backend`: ``"sparse"``
    (and ``"auto"`` at 512 buses or more) returns
    :func:`~freedm_tpu_torch.pf.sparse.make_sparse_newton_solver`'s
    solvers, which take ``precision``; on the dense path ``precision``
    validates only — the LU runs in ``dtype`` regardless, and TF32 never
    enters.  ``device`` is
    ``cuda`` unless the caller asks for the CPU.  ``status`` (0/1 branch
    in-service factors, ``[m]`` or ``[B, m]``) runs each lane on its own
    topology on either backend: the dense one stamps the lanes' Ybus (Y1,
    module docstring).  ``mesh`` (the reference's
    sharded form) is not ported and raises.  ``plain=True``
    runs the kernels' plain PyTorch versions on any device — the
    on-card reference ``chip_smoke.py`` compares the kernel path with.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the mesh-sharded solver form is not ported (ROADMAP.md, module "
            "queue item 16: multi-GPU lane sharding)"
        )
    if resolve_backend(backend, sys.n_bus) == "sparse":
        from freedm_tpu_torch.pf.sparse import make_sparse_newton_solver

        return make_sparse_newton_solver(
            sys, tol=tol, max_iter=max_iter, dtype=dtype,
            precision=precision, device=device, plain=plain, adjoint=adjoint,
        )
    dev = resolve_device(device)
    resolve_precision(precision, platform_name(dev))  # typed error only
    if dtype not in (torch.float64, torch.float32):
        raise TypeError(f"dtype must be float64 or float32, got {dtype}")
    if tol is None:
        tol = default_tol(dtype)
    tol = float(tol)
    max_iter = int(max_iter)
    n = sys.n_bus

    if plain:
        assemble, injections, update = (
            nk.newton_assemble_plain, nk.power_injections_plain,
            nk.newton_update_plain,
        )
    else:
        assemble, injections, update = (
            nk.newton_assemble, nk.power_injections, nk.newton_update,
        )

    def vec(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    bus_type = np.asarray(sys.bus_type)
    th_free = vec(bus_type != SLACK)  # θ unknown
    v_free = vec(bus_type == PQ)  # V unknown
    free = torch.cat([th_free, v_free])
    v_set = vec(sys.v_set)
    p_sched0 = vec(sys.p_inj)
    q_sched0 = vec(sys.q_inj)
    v_flat = torch.where(v_free > 0, torch.ones_like(v_set), v_set)
    y0 = ybus_dense(sys, dtype=dtype, device=dev)
    tol_t = torch.full((1,), tol, dtype=dtype, device=dev)
    stamp_op = stamp_operands(sys, dtype=dtype, device=dev)  # Y1's

    prep = lane_prep(n, dtype, dev, p_sched0, q_sched0, v_flat,
                     m=sys.n_branch)

    def lanes_ybus(status):
        """The lanes' Ybus: the stored one without a status, one stamp
        for a shared ``[m]`` status, a ``[B, n, n]`` stack for ``[B, m]``."""
        if status is None:
            return y0
        return ybus_lanes(sys, status, dtype=dtype, device=dev, op=stamp_op,
                          plain=plain)

    def step(x, ps, qs, y):
        jac, f = assemble(x, y[0], y[1], ps, qs, th_free, v_free, v_set)
        dx = torch.linalg.solve_ex(jac, -f.unsqueeze(-1),
                                   check_errors=False).result.squeeze(-1)
        return dx, f

    def finish(x, ps, qs, it, y):
        p, q, f = injections(x, y[0], y[1], ps, qs, th_free, v_free, v_set)
        return build_result(x, p, q, f, free, it, tol)

    def fixed_steps(x, ps, qs, y):
        for _ in range(max_iter):
            dx, _f = step(x, ps, qs, y)
            x = x + dx
        return x

    def sparse_ops():
        from freedm_tpu_torch.pf.sparse import sparse_operands

        return sparse_operands(sys, dtype=dtype, device=dev)

    j2 = adj.lazy_residual_vjp(sparse_ops, plain)

    def route(y, st):
        """Route B of :mod:`~freedm_tpu_torch.pf.adjoint` on K1, the
        library LU and J2."""
        def forward(ps, qs, x0):
            x = fixed_steps(x0, ps, qs, y)
            p, q, f = injections(x, y[0], y[1], ps, qs, th_free, v_free,
                                 v_set)
            return x, p, q, f

        def adjoint_solve(x, ps, qs, g):
            jac, _ = assemble(x, y[0], y[1], ps, qs, th_free, v_free, v_set)
            return adj.dense_adjoint_solve(jac, g)

        return adj.NewtonRoute(forward, adjoint_solve,
                               lambda x, w: j2(x, w, sol.FULL, st),
                               th_free, v_free)

    def solve(p_inj=None, q_inj=None, status=None, v0=None, theta0=None):
        x, ps, qs, _ = prep(p_inj, q_inj, status, v0, theta0)
        y = lanes_ybus(status)
        lanes = x.shape[0]
        it = torch.zeros(lanes, dtype=torch.int32, device=dev)
        err = torch.full((lanes,), float("inf"), dtype=dtype, device=dev)
        active = (it < max_iter) & (err >= tol_t)
        while any_active(active):  # the one host sync per iteration
            dx, f = step(x, ps, qs, y)
            update(x, dx, f, free, it, err, active, max_iter, tol_t)
        return finish(x, ps, qs, it, y)

    def solve_fixed(p_inj=None, q_inj=None, status=None, v0=None,
                    theta0=None):
        x, ps, qs, st = prep(p_inj, q_inj, status, v0, theta0)
        y = lanes_ybus(status)
        it = torch.full((x.shape[0],), max_iter, dtype=torch.int32,
                        device=dev)
        if adj.function_route(adjoint, dev, plain, x, ps, qs, st):
            adj.refuse_status_grad(st)
            x, p, q, f = adj.NewtonFixed.apply(ps, qs, x, route(y, st))
            return build_result(x, p, q, f, free, it, tol)
        return finish(fixed_steps(x, ps, qs, y), ps, qs, it, y)

    return solve, solve_fixed


def record_result(result: NewtonResult, solver: str = "newton") -> None:
    """Publish a result's per-lane iteration counts, its worst lane's
    final mismatch and its fallbacks to the solver metrics
    (``pf_newton_iterations``, ``pf_residual_pu``,
    ``pf_precision_fallbacks_total``; :mod:`freedm_tpu_torch.core.metrics`).
    Call it where the result is read on the host anyway: it copies the
    small per-lane fields and adds no device work."""
    from freedm_tpu_torch.core import metrics

    metrics.observe_pf_result(solver, result)


def branch_flows(sys: BusSystem, result: NewtonResult, status=None):
    """Complex power flows ``(S_from, S_to)`` per branch and lane, pu, as
    ``((re, im), (re, im))`` pairs of ``[B, m]`` tensors on the result's
    device (plain PyTorch; not on the served path)."""
    v, theta = result.v, result.theta
    dtype, dev = v.dtype, v.device
    f = torch.as_tensor(np.asarray(sys.from_bus), device=dev)
    t = torch.as_tensor(np.asarray(sys.to_bus), device=dev)
    yff, yft, ytf, ytt = (
        tuple(torch.as_tensor(part, dtype=dtype, device=dev) for part in y)
        for y in branch_admittances(sys, status=status)
    )
    vr, vi = v * torch.cos(theta), v * torch.sin(theta)
    vf, vt = (vr[:, f], vi[:, f]), (vr[:, t], vi[:, t])

    def mul(a, b):
        return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]

    def add(a, b):
        return a[0] + b[0], a[1] + b[1]

    def conj(a):
        return a[0], -a[1]

    i_f = add(mul(yff, vf), mul(yft, vt))
    i_t = add(mul(ytf, vf), mul(ytt, vt))
    return mul(vf, conj(i_f)), mul(vt, conj(i_t))
