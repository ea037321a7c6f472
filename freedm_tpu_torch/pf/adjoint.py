"""Reverse mode of the fixed-iteration solves: the autograd Functions
that ``solve_fixed`` takes on the card, and their shared adjoint code.

The reference differentiates every ``solve_fixed`` by ``jax.grad``
through its ``lax.scan`` of iterations.  The port keeps that unrolled
program on the CPU and under ``plain=True`` (autograd through the plain
versions), and on the card takes one of two routes, each a
``torch.autograd.Function`` over hand-written kernels:

- **Route B** (:class:`NewtonFixed`; dense and sparse Newton, matrix-free
  Newton–Krylov).  One adjoint solve at the last iterate ``x*``: with the
  upstream cotangents of ``(θ, V)`` and of the realized injections
  ``(p, q) = S(x*)``,

      ḡ = g_(θ,V) + J_S(x*)ᵀ g_(p,q)        (J2 in FULL mode)
      λ = J(x*)⁻ᵀ ḡ                          (the masked Jacobian)

  and, since the free rows of the residual are ``S(x) − S_sched``, the
  schedules' cotangents are ``λ`` on the free P and Q rows.  The start
  point enters the fixed point nowhere: ``lane_prep`` puts ``v0`` and
  ``theta0`` into ``x₀`` alone, and the pinned rows hold ``θ = 0`` and ``V
  = V_set``, so their cotangent is 0.  This is the implicit derivative,
  which equals the unrolled one to convergence accuracy (the reference's
  own docstring, ``freedm_tpu/pf/newton.py:190-193``).  The dense backend
  solves with the library LU on K1's Jacobian; the sparse and matrix-free
  ones by restarted GMRES on ``Jᵀ`` (:func:`adjoint_gmres`: S3, S4 and J2
  in MASKED mode, the FDLF preconditioner transposed) in float64.
- **Route A** (:class:`FdlfFixed`, :class:`CimFixed`).  FDLF and the CIM
  converge linearly: at the reference's iteration counts their unrolled
  gradient is not yet the implicit one, so the forward saves every
  iterate and the backward walks them back — FDLF a half-step at a time
  (the library LU's adjoint solve, J2 FULL on the masked 1/V-scaled
  cotangent, the 1/V term), the CIM an iteration at a time on I2.

A branch ``status`` gets no gradient on either route
(:class:`StatusGradientError`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from freedm_tpu_torch.kernels import solver_kernels as sol

Tensor = torch.Tensor

#: The adjoint GMRES stops a lane when ‖b − Jᵀλ‖ / ‖b‖ falls under this,
#: or after :data:`ADJOINT_MAX_CYCLES` restarts.  Two solves of one system
#: that each stop there differ by up to this times J's conditioning: at
#: 1e-10 the kernel and plain routes at mesh2000 × 256 were 5.3e-10 apart
#: (an H100), at the edge of the 1e-9 they are held to; 1e-12 costs about a
#: cycle more.
ADJOINT_RTOL = 1e-12
ADJOINT_MAX_CYCLES = 64

#: The last adjoint GMRES: its restarts and its worst lane's relative
#: residual (``chip_smoke.py`` prints them).
ADJOINT_STATS = {"cycles": 0, "residual": 0.0}


class StatusGradientError(TypeError):
    """A branch ``status`` that requires grad on a route of this module:
    the card's reverse modes differentiate the injections and the start
    point, never the topology."""


def function_route(adjoint: bool, dev: torch.device, plain: bool,
                   *tensors: Optional[Tensor]) -> bool:
    """Whether ``solve_fixed`` takes this module's Function: on the card
    unless ``plain``, and anywhere with ``adjoint`` (the plain route on the
    CPU or with ``plain``) — where autograd records a tensor of the call."""
    if not adjoint and (dev.type != "cuda" or plain):
        return False
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_status_grad(st: Optional[Tensor]) -> None:
    if st is not None and st.requires_grad:
        raise StatusGradientError(
            "status gets no gradient on the fixed solves' adjoint routes: "
            "pass it without requires_grad (the reference traces it, but no "
            "caller differentiates the topology)")


def lazy_residual_vjp(make_op: Callable, plain: bool) -> Callable:
    """``vjp(x, w, mode, status) -> wᵀ ∂F/∂x``: J2 (or its plain version)
    on the operands ``make_op()`` returns, built at the first call — the
    solvers' first backward — with their :func:`~freedm_tpu_torch.kernels.
    solver_kernels.vjp_operands`."""
    ops = []

    def vjp(x, w, mode, status=None):
        if not ops:
            op = make_op()
            ops.append((op, sol.vjp_operands(op)))
        op, vop = ops[0]
        fn = sol.residual_vjp_plain if plain else sol.residual_vjp
        return fn(x, w, op, vop, mode, status)

    return vjp


def _cat_pq(gp: Optional[Tensor], gq: Optional[Tensor],
            like: Tensor) -> Tensor:
    n = like.shape[1] // 2
    zero = like.new_zeros(like.shape[0], n)
    return torch.cat([zero if gp is None else gp,
                      zero if gq is None else gq], dim=1).contiguous()


# ---------------------------------------------------------------------------
# Route B: the Newton family
# ---------------------------------------------------------------------------


class NewtonRoute(NamedTuple):
    """What :class:`NewtonFixed` needs of a solver: ``forward(ps, qs, x0)
    -> (x*, p, q, f)`` (the fixed solve, ``f`` its masked mismatch);
    ``adjoint_solve(x*, ps, qs, g) -> J(x*)⁻ᵀ g``; ``injections_vjp(x, w)
    -> J_S(x)ᵀ w`` (J2 FULL); the masks."""

    forward: Callable
    adjoint_solve: Callable
    injections_vjp: Callable
    th_free: Tensor
    v_free: Tensor


class NewtonFixed(torch.autograd.Function):
    """``apply(ps, qs, x0, route) -> (x*, p, q, f)``: a Newton-family
    fixed solve whose backward is one adjoint solve at ``x*`` (route B,
    module docstring); ``f`` gets no gradient."""

    @staticmethod
    def forward(ctx, ps, qs, x0, route: NewtonRoute):
        x, p, q, f = route.forward(ps, qs, x0)
        ctx.route = route
        ctx.save_for_backward(x, ps, qs)
        ctx.mark_non_differentiable(f)
        return x, p, q, f

    @staticmethod
    def backward(ctx, gx, gp, gq, _gf):
        x, ps, qs = ctx.saved_tensors
        route = ctx.route
        n = ps.shape[1]
        g = torch.zeros_like(x) if gx is None else gx.contiguous()
        if gp is not None or gq is not None:
            g = g + route.injections_vjp(x, _cat_pq(gp, gq, x))
        lam = route.adjoint_solve(x, ps, qs, g)
        return (lam[:, :n] * route.th_free, lam[:, n:] * route.v_free,
                torch.zeros_like(x), None)


def dense_adjoint_solve(jac: Tensor, g: Tensor) -> Tensor:
    """``J⁻ᵀ g`` over lanes for K1's Jacobian ``jac [B, 2n, 2n]``: the
    library LU, as the forward's solve (a singular lane gets inf/NaN in
    that lane alone)."""
    lu, piv, _ = torch.linalg.lu_factor_ex(jac)
    return torch.linalg.lu_solve(lu, piv, g[:, :, None], adjoint=True)[:, :, 0]


def transposed_precond(precond, th_free: Tensor, v_free: Tensor,
                       v: Tensor) -> Callable:
    """``u -> M⁻ᵀ u`` for the FDLF preconditioner ``M = blockdiag(diag(V)
    B′, diag(V) B″)`` (pinned rows unscaled) at voltages ``v [B, n]``:
    the half-systems' transposed solves, then the 1/V scaling of the free
    rows; float64 out.  ``precond.kind`` ``"inverse"``: the product with
    the stored inverse, transposed; ``"lu"``: ``lu_solve(adjoint=True)``."""
    n = v.shape[1]
    if precond.kind == "inverse":
        def half(b, s):
            return (s.to(b.dtype) @ b).to(torch.float64)
    else:
        def half(b, s):
            return torch.linalg.lu_solve(b[0], b[1], s.to(b[0].dtype).T,
                                         adjoint=True).T.to(torch.float64)
    vv = v.to(torch.float64)

    def apply(u):
        s_p = half(precond.bp, u[:, :n])
        s_q = half(precond.bq, u[:, n:])
        return torch.cat([torch.where(th_free > 0, s_p / vv, s_p),
                          torch.where(v_free > 0, s_q / vv, s_q)], dim=1)

    return apply


def adjoint_gmres(a_t: Callable, m_t: Callable, b: Tensor, m: int, s: int,
                  plain: bool, rtol: float = ADJOINT_RTOL,
                  max_cycles: int = ADJOINT_MAX_CYCLES
                  ) -> Tuple[Tensor, int, float]:
    """Restarted right-preconditioned s-step GMRES(m) for ``a_t(λ) = b``
    over lanes (``b [B, N]``, float64): cycles of
    :func:`~freedm_tpu_torch.pf.krylov._pgmres_block` (S3, S4) on the
    residual until every lane's ‖b − a_t(λ)‖ / ‖b‖ is under ``rtol`` or
    ``max_cycles`` have run; a lane that met it keeps its λ.  Returns
    ``(λ, cycles, worst relative residual)``; one host read a cycle."""
    from freedm_tpu_torch.pf.krylov import _pgmres_block

    tiny = torch.finfo(b.dtype).tiny
    bn = torch.clamp(torch.linalg.vector_norm(b, dim=1), min=tiny)
    lam = torch.zeros_like(b)
    r = b
    active = torch.ones(b.shape[0], dtype=torch.bool, device=b.device)
    rel = torch.zeros(b.shape[0], dtype=b.dtype, device=b.device)
    cycles = 0
    while cycles < max_cycles:
        cycles += 1
        d = _pgmres_block(a_t, m_t, r, m=m, s=s, plain=plain)
        d = torch.where(torch.isfinite(d).all(dim=1, keepdim=True), d,
                        m_t(r))
        lam = torch.where(active[:, None], lam + d, lam)
        r = b - a_t(lam)
        rel = torch.linalg.vector_norm(r, dim=1) / bn
        active = ~(rel < rtol)
        if not bool(active.cpu().numpy().any()):  # the cycle's host read
            break
    worst = float(rel.max()) if rel.numel() else 0.0
    ADJOINT_STATS.update(cycles=cycles, residual=worst)
    return lam, cycles, worst


# ---------------------------------------------------------------------------
# Route A: FDLF
# ---------------------------------------------------------------------------


class FdlfRoute(NamedTuple):
    """What :class:`FdlfFixed` needs of an FDLF solver: F1 (``half``, the
    wrapper or its plain version), the lanes' Ybus ``y = (re, im)``, the
    B′/B″ factors and whether every lane shares them, K2 (``injections``),
    J2 FULL (``injections_vjp(x, w)``), the masks, ``v_set``, the
    tolerance tensor and the iteration count."""

    half: Callable
    y: Tuple[Tensor, Tensor]
    lu_p: Tuple[Tensor, Tensor]
    lu_q: Tuple[Tensor, Tensor]
    shared: bool
    injections: Callable
    injections_vjp: Callable
    th_free: Tensor
    v_free: Tensor
    v_set: Tensor
    tol: Tensor
    max_iter: int


def lu_half(lu, rhs: Tensor, shared: bool, adjoint: bool = False) -> Tensor:
    """A half-step's solve for every lane: one factorization with the
    lanes as right-hand sides (``shared``, a view through the solve's own
    strides) or one per lane; ``adjoint`` solves with the transpose."""
    if shared:
        return torch.linalg.lu_solve(lu[0], lu[1], rhs.T, adjoint=adjoint).T
    return torch.linalg.lu_solve(lu[0], lu[1], rhs[:, :, None],
                                 adjoint=adjoint)[:, :, 0]


class FdlfFixed(torch.autograd.Function):
    """``apply(ps, qs, x0, route) -> (x, p, q, err)``: ``max_iter`` FDLF
    iterations on every lane (F1 around the library LU), saving the state
    after every half-step and the mismatch each half carries; backward
    walks them back (route A).  ``err`` gets no gradient."""

    @staticmethod
    def forward(ctx, ps, qs, x0, route: FdlfRoute):
        r = route
        lanes, n = ps.shape
        k_max = r.max_iter
        x = x0.clone()
        dp = torch.empty_like(ps)
        dq = torch.empty_like(ps)
        it = torch.zeros(lanes, dtype=torch.int32, device=ps.device)
        err = torch.full((lanes,), float("inf"), dtype=ps.dtype,
                         device=ps.device)
        active = torch.ones(lanes, dtype=torch.bool, device=ps.device)
        carry = (r.th_free, r.v_free, dp, dq, err, it, active, r.tol,
                 k_max, True)
        y_re, y_im = r.y
        xs = x.new_empty(2 * k_max + 1, lanes, 2 * n)
        dps = ps.new_empty(k_max + 1, lanes, n)
        dqs = ps.new_empty(k_max, lanes, n)
        xs[0] = x
        r.half(sol.INIT, x, None, y_re, y_im, ps, qs, *carry)
        dps[0] = dp
        for k in range(k_max):
            r.half(sol.THETA, x, lu_half(r.lu_p, dp, r.shared), y_re, y_im,
                   ps, qs, *carry)
            xs[2 * k + 1] = x
            dqs[k] = dq
            r.half(sol.VHALF, x, lu_half(r.lu_q, dq, r.shared), y_re, y_im,
                   ps, qs, *carry)
            xs[2 * k + 2] = x
            dps[k + 1] = dp
        if k_max == 0:  # the start point's error
            v = x[:, n:]
            err = torch.maximum(torch.amax(torch.abs(dp * v), dim=1),
                                torch.amax(torch.abs(dq * v), dim=1))
        p, q, _ = r.injections(x, y_re, y_im, ps, qs, r.th_free, r.v_free,
                               r.v_set)
        ctx.route = r
        ctx.save_for_backward(xs, dps, dqs)
        ctx.mark_non_differentiable(err)
        return x, p, q, err

    @staticmethod
    def backward(ctx, gx, gp, gq, _gerr):
        xs, dps, dqs = ctx.saved_tensors
        r = ctx.route
        k_max = r.max_iter
        n = dps.shape[2]
        x_end = xs[2 * k_max]
        xbar = torch.zeros_like(x_end) if gx is None else gx.clone()
        if gp is not None or gq is not None:
            xbar = xbar + r.injections_vjp(x_end, _cat_pq(gp, gq, x_end))
        psbar = torch.zeros_like(xbar[:, :n])
        qsbar = torch.zeros_like(psbar)
        zero = torch.zeros_like(psbar)

        def mismatch_term(xbar, sbar, x, dbar, dvals, q_half):
            """The carried mismatch ``d = (s − S(x)) / V · mask`` of one
            half walked back: ``s̄ += d̄ mask / V``, ``x̄ += J_Sᵀ(−d̄ mask /
            V)`` (J2 FULL) and the 1/V term ``V̄ −= d̄ d / V``."""
            v = x[:, n:]
            a = dbar * (r.v_free if q_half else r.th_free) / v
            w = torch.cat([zero, -a] if q_half else [-a, zero], dim=1)
            xbar = xbar + r.injections_vjp(x, w.contiguous())
            xbar = torch.cat([xbar[:, :n], xbar[:, n:] - dbar * dvals / v],
                             dim=1)
            return xbar, sbar + a

        dpbar = None
        for k in reversed(range(k_max)):
            if dpbar is not None:  # dp_{k+1} = m_p(x_{k+1}) fed iteration k+1
                xbar, psbar = mismatch_term(xbar, psbar, xs[2 * k + 2], dpbar,
                                            dps[k + 1], False)
            # V_{k+1} = V_k + v_free · B″⁻¹ dq′
            dqbar = lu_half(r.lu_q, r.v_free * xbar[:, n:], r.shared,
                            adjoint=True)
            xbar, qsbar = mismatch_term(xbar, qsbar, xs[2 * k + 1], dqbar,
                                        dqs[k], True)
            # θ_{k+1} = θ_k + th_free · B′⁻¹ dp_k
            dpbar = lu_half(r.lu_p, r.th_free * xbar[:, :n], r.shared,
                            adjoint=True)
        if dpbar is not None:  # dp_0 = m_p(x_0)
            xbar, psbar = mismatch_term(xbar, psbar, xs[0], dpbar, dps[0],
                                        False)
        return psbar, qsbar, xbar, None


# ---------------------------------------------------------------------------
# Route A: the CIM
# ---------------------------------------------------------------------------


class CimRoute(NamedTuple):
    """What :class:`CimFixed` needs of a CIM solver: ``iterate(v_re, v_im,
    s_re, s_im, vb_re, vb_im, err, it, active, out)`` (I1 in fixed mode,
    writing ``v_new`` into ``out``), ``walk`` (I2's walk over the saved
    iterates, ``cim_vjp_walk``, or its plain per-iteration loop), the
    staged ``Aᴴ`` (``h_re``, ``h_im``), the phase mask and the iteration
    count."""

    iterate: Callable
    walk: Callable
    h_re: Tensor
    h_im: Tensor
    mask: Tensor
    max_iter: int


class CimFixed(torch.autograd.Function):
    """``apply(s_re, s_im, vb_re, vb_im, route) -> (v_re, v_im, err)``:
    ``max_iter`` current-injection iterations on every lane from ``v_base``
    (I1), saving every iterate; backward walks them back on I2 (route A),
    every iteration in one launch on the card.
    ``err`` gets no gradient."""

    @staticmethod
    def forward(ctx, s_re, s_im, vb_re, vb_im, route: CimRoute):
        r = route
        lanes, big_n = s_re.shape
        k_max = r.max_iter
        vs = s_re.new_empty(k_max + 1, 2, lanes, big_n)
        vs[0, 0] = vb_re
        vs[0, 1] = vb_im
        err = torch.full((lanes,), float("inf"), dtype=s_re.dtype,
                         device=s_re.device)
        it = torch.zeros(lanes, dtype=torch.int32, device=s_re.device)
        active = torch.ones(lanes, dtype=torch.bool, device=s_re.device)
        for k in range(k_max):
            r.iterate(vs[k, 0], vs[k, 1], s_re, s_im, vb_re, vb_im, err, it,
                      active, (vs[k + 1, 0], vs[k + 1, 1]))
        ctx.route = r
        ctx.save_for_backward(vs, s_re, s_im)
        ctx.mark_non_differentiable(err)
        return vs[k_max, 0].clone(), vs[k_max, 1].clone(), err

    @staticmethod
    def backward(ctx, g_re, g_im, _gerr):
        vs, s_re, s_im = ctx.saved_tensors
        r = ctx.route
        k_max = r.max_iter
        zero = torch.zeros_like(s_re)
        g_re = zero if g_re is None else g_re
        g_im = zero if g_im is None else g_im
        if k_max == 0:  # v = v_base
            return zero, zero.clone(), g_re, g_im, None
        gm_re = (g_re * r.mask).contiguous()
        gm_im = (g_im * r.mask).contiguous()
        sbar_re, sbar_im, vbbar_re, vbbar_im = r.walk(
            r.h_re, r.h_im, gm_re, gm_im, vs, s_re, s_im, r.mask, k_max)
        return sbar_re, sbar_im, vbbar_re, vbbar_im, None
