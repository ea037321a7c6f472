"""N-1 contingency screening: one factorization, rank-2
Sherman–Morrison–Woodbury updates per outage lane.

Port of ``freedm_tpu/pf/n1.py``.  A single-branch outage changes the
fast-decoupled pair by a matrix supported on the branch's two endpoint
rows and columns,

    B′_k = B′ − w_k·a_k a_kᵀ                  (rank 1, a_k = e_f − e_t)
    B″_k = B″ + P_k·Im(Y_stamp_k)·P_kᵀ        (rank ≤ 2, P_k = [e_f, e_t])

so with the base pair factorized once every outage lane solves through

    (A + P M Pᵀ)⁻¹ b = A⁻¹b − (Z M)·(I₂ + Pᵀ Z M)⁻¹·(Pᵀ A⁻¹ b)

with ``Z = A⁻¹P`` precomputed for every branch in one multi-RHS solve a
matrix.  The pinned rows of B′/B″ (slack θ, PV/slack V) are identity, so
the update columns are masked by ``th_free`` / ``v_free``.

Two screens, chosen by case size as the reference chooses
(:func:`~freedm_tpu_torch.pf.backend.resolve_backend`):

- ``backend="dense"`` (below 512 buses under ``"auto"``): the SMW
  fast-decoupled screen, a fixed ``max_iter`` iterations per lane with no
  exit test.  The whole screen of every lane is one launch of kernel N1
  (:func:`~freedm_tpu_torch.kernels.screen_kernels.smw_screen`): the flat
  start, each half-iteration's base triangular solve on the B′ or B″ LU
  pair (written by hand, the reference leaves it to XLA's triangular
  solve), its rank-2 correction and mismatch, and the answer — no host
  read and no library call in between.
- ``backend="sparse"``: the base case solved once, then every outage lane
  a status-traced sparse Newton solve warm-started from it — one batched
  call of :func:`~freedm_tpu_torch.pf.sparse.make_sparse_newton_solver`'s
  ``solve`` over ``[k, m]`` status (S1 with per-lane status, S2-S4, K3),
  sharing one pattern and the base topology's preconditioner.

``dc_prefilter=k`` ranks the requested outages with the DC screen
(:mod:`freedm_tpu_torch.pf.dc`) and AC-verifies the ``k`` DC-worst.

A bridge outage islands part of the network and makes B′_k singular: the
AC lanes assume connectivity, so callers filter with
:func:`secure_outages` (the serving engine rejects islanding outages at
validation) or screen through ``dc_prefilter``, which flags them.

Here also: :func:`smw_delta_solve`, the correction solve of the
incremental machinery, which the serving cache's delta program runs at
rank 0.  Not ported: the ``mesh=`` form (ROADMAP item 16).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


def secure_outages(sys) -> list:
    """Branch indices whose single removal does NOT island the network
    (union-find over the surviving branches) — the reference's pass,
    copied, so the list is the reference's.  A build-time host pass."""
    out = []
    for k in range(sys.n_branch):
        parent = list(range(sys.n_bus))

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for j in range(sys.n_branch):
            if j != k:
                ra, rb = find(int(sys.from_bus[j])), find(int(sys.to_bus[j]))
                if ra != rb:
                    parent[ra] = rb
        if len({find(i) for i in range(sys.n_bus)}) == 1:
            out.append(k)
    return out


def smw_delta_solve(lu, u, v, b, z=None, cap=None, vt=None):
    """Solve ``(A + U Vᵀ) x = b`` through the Sherman–Morrison–Woodbury
    identity, given the factorized base ``lu = torch.linalg.lu_factor(A)``
    (an ``(LU, pivots)`` pair):

        x = A⁻¹b − Z · (I_k + Vᵀ Z)⁻¹ · (Vᵀ A⁻¹ b),     Z = A⁻¹ U

    — one base triangular solve plus O(n·k) correction work.  ``b`` is
    ``[n]`` or ``[n, r]`` (``r`` right-hand sides, solved at once).

    ``u``/``v`` are ``[n, k]`` low-rank factors; ``u`` may be omitted
    when ``z`` is supplied, and with ``u``, ``v`` and ``z`` all ``None``
    the update is empty (rank 0) and the answer is the base solve.
    ``vt`` optionally replaces the dense ``Vᵀ·`` application with a
    structured one; it is applied to the right-hand side's base solve
    (and to ``z`` only when ``cap`` is not precomputed), and ``v`` may
    then be ``None``.  The base solve is ``torch.linalg.lu_solve``: the
    reference leaves it to XLA's triangular solve, outside any fused
    program.
    """
    lu_mat, piv = lu
    vec = b.dim() == 1
    x0 = torch.linalg.lu_solve(lu_mat, piv, b[:, None] if vec else b)
    if vec:
        x0 = x0[:, 0]
    if u is None and z is None:
        return x0  # rank 0: the update is empty, A⁻¹b is the answer
    if z is None:
        z = torch.linalg.lu_solve(lu_mat, piv, u)
    apply_vt = vt if vt is not None else (lambda x: v.T @ x)
    if cap is None:
        k = z.shape[-1]
        cap = torch.eye(k, dtype=z.dtype, device=z.device) + apply_vt(z)
    return x0 - z @ torch.linalg.solve(cap, apply_vt(x0))


class N1Prefiltered(NamedTuple):
    """Output of a DC-prefiltered screen: the AC-verified shortlist
    (DC-worst first) plus the full DC severity ranking.  Bridge outages
    (``islanded``) never enter the shortlist."""

    outages: np.ndarray  # [top_k] AC-verified branch indices
    dc_severity: np.ndarray  # [top_k] their DC post-outage max |flow|, pu
    dc_severity_all: np.ndarray  # [k] severity of every requested outage
    islanded: np.ndarray  # [k] bool per requested outage: bridge, skipped
    result: object  # NewtonResult of the AC lanes for ``outages``


def _outage_ks(outages, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(outages, np.int64).reshape(-1),
                           device=device)


def make_n1_screen(sys, tol: Optional[float] = None, max_iter: int = 40,
                   dtype: torch.dtype = torch.float64, mesh=None,
                   batch_spec=None, backend: str = "dense",
                   precision: str = "auto",
                   dc_prefilter: Optional[int] = None, device=None,
                   plain: bool = False, precond=None):
    """Build the batched N-1 screen.

    Returns ``screen(outages)``: ``outages`` is a ``[k]`` sequence of
    branch indices (each lane removes exactly that branch); the result is
    a lane-batched :class:`~freedm_tpu_torch.pf.newton.NewtonResult` of
    ``[k, ...]`` tensors on ``device`` (``cuda`` unless the CPU is asked
    for).  ``backend``: ``"dense"`` is the SMW fast-decoupled screen,
    ``"sparse"`` the status-traced warm-started sparse Newton screen,
    ``"auto"`` picks by case size.  ``precision`` threads to the sparse
    backend's inner solve; the SMW path validates it only.  ``dc_prefilter
    = k`` DC-ranks every requested outage first and AC-verifies the ``k``
    DC-worst, returning an :class:`N1Prefiltered`.  ``plain=True`` runs
    the kernels' plain versions on any device (the on-card reference);
    ``precond`` optionally hands the sparse screen a built FDLF pair
    (:class:`~freedm_tpu_torch.pf.krylov.FdlfPrecond`).
    The SMW screen and the DC screen run in float64; the sparse screen
    also in float32.  ``mesh`` is not ported and raises.
    """
    from freedm_tpu_torch.device import platform_name, resolve_device
    from freedm_tpu_torch.pf.backend import resolve_backend, resolve_precision

    if mesh is not None or batch_spec is not None:
        raise NotImplementedError(
            "the mesh-sharded screen form is not ported (ROADMAP.md, module "
            "queue item 16: multi-GPU lane sharding)"
        )
    dev = resolve_device(device)
    if resolve_backend(backend, sys.n_bus) == "sparse":
        screen = _make_sparse_n1_screen(sys, tol, max_iter, dtype, precision,
                                        dev, plain, precond)
    else:
        resolve_precision(precision, platform_name(dev))  # typed error only
        screen = _make_smw_n1_screen(sys, tol, max_iter, dtype, dev, plain)
    if dc_prefilter is None:
        return screen
    return _with_dc_prefilter(sys, screen, int(dc_prefilter), dtype, dev,
                              plain)


def _with_dc_prefilter(sys, ac_screen, top_k: int, dtype, device, plain):
    """Wrap an AC screen with the DC first pass (see make_n1_screen)."""
    from freedm_tpu_torch.pf.dc import make_dc_solver

    if top_k < 1:
        raise ValueError(f"dc_prefilter must be >= 1, got {top_k}")
    dc = make_dc_solver(sys, dtype=dtype, device=device, plain=plain)

    def screen(outages) -> N1Prefiltered:
        ks = np.asarray(outages, np.int64).reshape(-1)
        dc_r = dc.screen_outages(ks)
        sev = dc_r.severity.cpu().numpy()
        isl = dc_r.islanded.cpu().numpy()
        # Bridge outages are flagged, not verified: the DC screen is the
        # islanding filter the AC lanes require.
        cand = np.flatnonzero(~isl)
        if cand.size == 0:
            raise ValueError(
                "dc_prefilter: every requested outage islands the "
                "network (all lanes flagged islanded by the DC screen)"
            )
        # DC-worst first; stable, so equal-severity ties keep request
        # order.
        order = cand[np.argsort(-sev[cand], kind="stable")]
        order = order[: min(top_k, cand.size)]
        short = ks[order]
        return N1Prefiltered(
            outages=short,
            dc_severity=sev[order],
            dc_severity_all=sev,
            islanded=isl,
            result=ac_screen(short),
        )

    return screen


def _make_sparse_n1_screen(sys, tol, max_iter, dtype, precision, device,
                           plain, precond=None):
    """The sparse-backend screen: the base case once, then every outage
    lane a status-traced sparse solve warm-started from it, all lanes in
    one batched call (one pattern, one preconditioner)."""
    from freedm_tpu_torch.pf.sparse import make_sparse_newton_solver

    m, n = sys.n_branch, sys.n_bus
    solve, _ = make_sparse_newton_solver(
        sys, tol=tol, max_iter=max_iter, dtype=dtype, precision=precision,
        device=device, plain=plain, precond=precond,
    )
    base = solve()
    base_v, base_th = base.v, base.theta

    def screen(outages):
        ks = _outage_ks(outages, device)
        k = int(ks.shape[0])
        status = torch.ones(k, m, dtype=dtype, device=device)
        status[torch.arange(k, device=device), ks] = 0.0
        return solve(status=status, v0=base_v.expand(k, n),
                     theta0=base_th.expand(k, n))

    return screen


def smw_operands(sys, device=None):
    """Build the SMW screen's operands on ``device`` (float64): the base
    B′/B″ ``lu_factor`` pairs and N1's
    :class:`~freedm_tpu_torch.kernels.screen_kernels.SmwOperands` — the
    injection operands, and per branch the masked update blocks: ``Z =
    A⁻¹P`` for every branch endpoint (one multi-RHS ``lu_solve`` a
    matrix), ``ZM`` laid out branch-major ``[m, n, 2]`` so that a lane
    reads its own block contiguous, and ``cap = I₂ + ZM[idx]·mask`` with
    the reference's operations.  Returns ``(lu_p, lu_q, op)``."""
    from freedm_tpu_torch.device import resolve_device
    from freedm_tpu_torch.grid.bus import branch_admittances, ybus_pair
    from freedm_tpu_torch.kernels.screen_kernels import SmwOperands
    from freedm_tpu_torch.pf.fdlf import decoupled_parts
    from freedm_tpu_torch.pf.mfree import delta_operands

    dev = resolve_device(device)
    f64 = torch.float64
    n, m = sys.n_bus, sys.n_branch
    parts = decoupled_parts(sys, dtype=f64, device=dev)
    lu_p = torch.linalg.lu_factor(parts.b_prime(None))
    lu_q = torch.linalg.lu_factor(parts.b_dblprime(ybus_pair(sys)[1]))

    f = np.asarray(sys.from_bus, np.int64)
    t = np.asarray(sys.to_bus, np.int64)
    idx = np.stack([f, t], axis=1)  # [m, 2]
    bt_free = (parts.th_free.cpu().numpy(), parts.v_free.cpu().numpy())
    cols = np.arange(m)

    def update_columns(free):
        mask = free[idx]  # [m, 2]
        rhs = np.zeros((n, 2 * m))
        rhs[f, 2 * cols] = mask[:, 0]
        rhs[t, 2 * cols + 1] = mask[:, 1]
        return mask, torch.as_tensor(rhs, device=dev)

    yff, yft, ytf, ytt = branch_admittances(sys)
    w = 1.0 / np.asarray(sys.x, np.float64)
    m_p = -w[:, None, None] * np.array([[1.0, -1.0], [-1.0, 1.0]])[None]
    m_q = np.stack([np.stack([yff[1], yft[1]], axis=-1),
                    np.stack([ytf[1], ytt[1]], axis=-1)], axis=-2)
    eye2 = torch.eye(2, dtype=f64, device=dev)
    idx_t = torch.as_tensor(idx, device=dev)
    rows = torch.arange(m, device=dev)[:, None]
    masks, zms, caps = [], [], []
    for lu, free, mm in ((lu_p, bt_free[0], m_p), (lu_q, bt_free[1], m_q)):
        mask, rhs = update_columns(free)
        z = torch.linalg.lu_solve(lu[0], lu[1], rhs).reshape(n, m, 2)
        z = z.permute(1, 0, 2)  # [m, n, 2], branch-major
        mt = torch.as_tensor(mm, dtype=f64, device=dev)
        # ZM = Z_k @ M_k per branch, as the two products and their sum.
        zm = (z[..., 0:1] * mt[:, None, 0, :]
              + z[..., 1:2] * mt[:, None, 1, :]).contiguous()
        mask_t = torch.as_tensor(mask, dtype=f64, device=dev)
        cap = eye2 + zm[rows, idx_t] * mask_t[:, :, None]
        masks.append(mask_t)
        zms.append(zm)
        caps.append(cap)
    dop = delta_operands(sys, device=dev)

    def vec(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)

    op = SmwOperands(
        dop=dop, v_set=vec(sys.v_set), p_sched=vec(sys.p_inj),
        q_sched=vec(sys.q_inj), mask=torch.stack(masks).contiguous(),
        zm=torch.stack(zms).contiguous(), cap=torch.stack(caps).contiguous(),
    )
    return lu_p, lu_q, op


def _make_smw_n1_screen(sys, tol, max_iter, dtype, device, plain):
    """The SMW fast-decoupled screen (the ``backend="dense"`` path)."""
    from freedm_tpu_torch.kernels import screen_kernels as sck
    from freedm_tpu_torch.pf.newton import NewtonResult, default_tol

    if dtype != torch.float64:
        raise TypeError(f"the SMW screen runs in float64, got {dtype}")
    tol = float(default_tol(dtype) if tol is None else tol)
    max_iter = int(max_iter)
    lu_p, lu_q, op = smw_operands(sys, device=device)
    fac = None if plain else sck.smw_factors(lu_p, lu_q)

    def screen(outages):
        ks = _outage_ks(outages, device)
        lanes = int(ks.shape[0])
        if plain:
            theta, v, p, q, err = sck.smw_screen_plain(ks, op, lu_p, lu_q,
                                                       max_iter)
        else:
            theta, v, p, q, err = sck.smw_screen(ks, op, fac, max_iter)
        it = torch.full((lanes,), max_iter, dtype=torch.int32, device=device)
        return NewtonResult(v=v, theta=theta, p=p, q=q, iterations=it,
                            converged=err < tol, mismatch=err,
                            fallbacks=torch.zeros_like(it))

    return screen
