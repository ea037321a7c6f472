"""The Krylov toolkit of the sparse Newton backend.

Port of the parts of ``freedm_tpu/pf/krylov.py`` that
:mod:`freedm_tpu_torch.pf.sparse` runs: the FDLF preconditioner (built
once per engine — B′/B″ inverted by the Newton–Schulz GEMM iteration and
stored in bf16, or LU-factorized), its half-system apply, the s-step
block GMRES cycle with a written-out lane axis, the scalar GMRES cycle it
is held against, and the host float64 oracles.  The matrix-free solver
``make_krylov_solver`` is a later slice (ROADMAP item 12).

Where the reference ``vmap``s one GMRES cycle per lane, every vector here
is ``[B, N]`` and every per-lane scalar (``β``, the chain's ``alive``
flag, the basis mask ``valid``) carries the lane axis, so lanes never
interact: a lane that breaks down freezes alone.  On CUDA tensors the
block step and the least-squares finish are the kernels S3
:func:`~freedm_tpu_torch.kernels.sparse_kernels.gmres_block_orth` and S4
:func:`~freedm_tpu_torch.kernels.sparse_kernels.gmres_lstsq`; the cycle
itself reads nothing back to the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from freedm_tpu_torch.device import DeviceLike, platform_name, resolve_device
from freedm_tpu_torch.grid.bus import PQ, SLACK, BusSystem, ybus_pair
from freedm_tpu_torch.kernels import sparse_kernels as sk
from freedm_tpu_torch.pf.fdlf import decoupled_parts

_NS_TARGET = 0.05  # ‖I − A·X‖_max good enough for a preconditioner

#: Mixed-precision acceptance oracle: a mixed Newton step counts as
#: progress only if its full-precision mismatch falls below this
#: fraction of the lane's best so far.
_MIXED_ACCEPT_RATIO = 0.9

#: ...and a lane falls back to full-precision inner solves after this
#: many consecutive mixed steps without progress.
_MIXED_STALL_STEPS = 2

#: At and above this many buses an unspecified preconditioner build
#: takes the LU kind: the bf16 inverse pair is 2·2n² bytes.
PRECOND_INVERSE_MAX_BUSES = 4096

#: ``kind`` vocabulary of :func:`build_fdlf_precond`.
PRECOND_KINDS = ("inverse", "lu", "auto")


def default_precond_kind(n_bus: int) -> str:
    """The kind an unspecified build resolves to: explicit inverses
    below :data:`PRECOND_INVERSE_MAX_BUSES` buses, the LU pair at and
    above."""
    return "inverse" if n_bus < PRECOND_INVERSE_MAX_BUSES else "lu"


def _resolve_precond_kind(kind: str, n_bus: int, platform: str) -> str:
    """``"auto"`` picks ``"lu"`` on ``cpu`` and at or above
    :data:`PRECOND_INVERSE_MAX_BUSES` buses on any platform, ``"inverse"``
    elsewhere; explicit kinds are kept (typed error on unknown ones)."""
    if kind not in PRECOND_KINDS:
        raise ValueError(
            f"unknown preconditioner kind {kind!r} "
            f"(have: {', '.join(PRECOND_KINDS)})"
        )
    if kind == "auto":
        if platform == "cpu" or n_bus >= PRECOND_INVERSE_MAX_BUSES:
            return "lu"
        return "inverse"
    return kind


def _newton_schulz(a: torch.Tensor, max_steps: int = 120):
    """Approximate inverse by the Newton–Schulz GEMM iteration
    X ← X (2I − A X) from X₀ = Aᵀ/(‖A‖₁‖A‖∞), stepping while
    ``‖I − A X‖_max`` of the current iterate exceeds ``_NS_TARGET``
    (at most ``max_steps``), as the reference's ``while_loop`` does.

    Returns ``(x, resid)`` with ``resid`` the final iterate's residual
    (a 0-d tensor).  The loop condition reads the residual on the host
    once per step: this runs once per engine build, never in a solve.
    """
    n = a.shape[0]
    norm1 = torch.amax(torch.sum(torch.abs(a), dim=0))
    norminf = torch.amax(torch.sum(torch.abs(a), dim=1))
    x = a.T / (norm1 * norminf)
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    for _ in range(max_steps):
        ax = a @ x
        resid = torch.amax(torch.abs(eye - ax))
        x = x @ (2.0 * eye - ax)
        if not float(resid) > _NS_TARGET:
            break
    return x, torch.amax(torch.abs(eye - a @ x))


def _precond_inv(mat: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Explicit inverse in ``out_dtype``: Newton–Schulz on the device,
    or a host LAPACK inverse where the iteration stalls above
    ``_NS_TARGET`` (a one-time build cost)."""
    x, resid = _newton_schulz(mat)
    if float(resid) <= _NS_TARGET:
        return x.to(out_dtype)
    host = np.linalg.inv(mat.detach().cpu().numpy().astype(np.float64))
    return torch.as_tensor(host, device=mat.device).to(out_dtype)


class FdlfPrecond(NamedTuple):
    """A built FDLF preconditioner: the B′/B″ pair and how to apply it.
    ``kind="inverse"`` holds explicit ``[n, n]`` inverses in the storage
    dtype (bf16 by default); ``kind="lu"`` holds
    ``torch.linalg.lu_factor`` ``(LU, pivots)`` pairs in the working
    dtype."""

    bp: object
    bq: object
    kind: str

    @classmethod
    def from_arrays(cls, bp, bq, kind: str = "inverse",
                    dtype: torch.dtype = torch.bfloat16,
                    device: DeviceLike = None) -> "FdlfPrecond":
        """An inverse pair from host arrays (e.g. the JAX package's bf16
        pair, passed as numpy): each goes to float32 on the host — exact
        for bf16 — and then to ``dtype`` on ``device``."""
        if kind != "inverse":
            raise ValueError("from_arrays carries explicit inverses only")
        dev = resolve_device(device)

        def conv(a):
            host = np.asarray(np.asarray(a, dtype=np.float32))
            return torch.as_tensor(host, device=dev).to(dtype)

        return cls(conv(bp), conv(bq), "inverse")


def precond_apply_half(kind: str) -> Callable:
    """The half-system M⁻¹ apply of a built pair, over lanes:
    ``apply(b, s [B, n]) -> [B, n]``.  ``"inverse"``: ``s`` cast to the
    pair's dtype times ``bᵀ`` (the reference's ``b @ s`` per lane), left
    in that dtype; ``"lu"``: triangular solves in the factors' dtype."""
    if kind == "inverse":
        return lambda b, s: s.to(b.dtype) @ b.T
    return lambda b, s: torch.linalg.lu_solve(
        b[0], b[1], s.to(b[0].dtype).T).T


def fdlf_apply(precond: FdlfPrecond, th_free: torch.Tensor,
               v_free: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    """M⁻¹u over lanes with M = blockdiag(diag(V)B′, diag(V)B″), for
    ``u [B, 2n]`` at voltages ``v [B, n]``; pinned rows (mask 0) pass
    through unscaled.  The result is ``out_dtype``."""
    n = v.shape[1]
    half = precond_apply_half(precond.kind)
    u_p, u_q = u[:, :n], u[:, n:]
    s_p = torch.where(th_free > 0, u_p / v, u_p)
    s_q = torch.where(v_free > 0, u_q / v, u_q)
    return torch.cat([half(precond.bp, s_p).to(out_dtype),
                      half(precond.bq, s_q).to(out_dtype)], dim=1)


def build_fdlf_precond(sys: BusSystem, dtype: torch.dtype = torch.float64,
                       precond_dtype: torch.dtype = torch.bfloat16,
                       kind: Optional[str] = None,
                       device: DeviceLike = None) -> FdlfPrecond:
    """Build the FDLF preconditioner pair, J ≈ blockdiag(diag(V)·B′,
    diag(V)·B″), once per (case, dtype).

    ``kind=None`` resolves by case size (:func:`default_precond_kind`);
    ``"inverse"`` inverts both matrices (:func:`_precond_inv`) and stores
    them in ``precond_dtype``; ``"lu"`` factorizes them in ``dtype``;
    ``"auto"`` picks by platform and size (:func:`_resolve_precond_kind`).
    The products are plain ``torch.matmul`` GEMMs, as the reference
    leaves them to XLA's dot.
    """
    dev = resolve_device(device)
    if kind is None:
        kind = default_precond_kind(sys.n_bus)
    else:
        kind = _resolve_precond_kind(kind, sys.n_bus, platform_name(dev))
    parts = decoupled_parts(sys, dtype=dtype, device=dev)
    b_p = parts.b_prime(None)
    b_q = parts.b_dblprime(ybus_pair(sys)[1])
    if kind == "inverse":
        return FdlfPrecond(_precond_inv(b_p, precond_dtype),
                           _precond_inv(b_q, precond_dtype), kind)
    return FdlfPrecond(torch.linalg.lu_factor(b_p),
                       torch.linalg.lu_factor(b_q), kind)


def _pgmres(a_op, m_op, b: torch.Tensor, m: int) -> torch.Tensor:
    """Right-preconditioned GMRES(m), one cycle, for one vector ``b [N]``
    — the scalar cycle of the reference (masked two-pass Gram–Schmidt,
    guarded normalizations, dense least-squares finish).  Plain PyTorch;
    the tests hold :func:`_pgmres_block` against it."""
    dtype = b.dtype
    nvec = b.shape[0]
    tiny = torch.finfo(dtype).tiny
    beta = torch.linalg.vector_norm(b)
    safe_beta = torch.clamp(beta, min=tiny)
    v_basis = b.new_zeros(m + 1, nvec)
    v_basis[0] = b / safe_beta
    z_store = b.new_zeros(m, nvec)
    h_mat = b.new_zeros(m + 1, m)
    valid = b.new_zeros(m + 1)
    valid[0] = 1.0
    rows = torch.arange(m + 1, device=b.device)
    for j in range(m):
        z = m_op(v_basis[j])
        w = a_op(z)
        mask = valid * (rows <= j).to(dtype)
        h1 = (v_basis @ w) * mask
        w = w - v_basis.T @ h1
        h2 = (v_basis @ w) * mask
        w = w - v_basis.T @ h2
        h_col = h1 + h2
        nrm = torch.linalg.vector_norm(w)
        alive = (nrm > 1e-30).to(dtype) * valid[j]
        h_col[j + 1] = nrm
        v_basis[j + 1] = w / torch.clamp(nrm, min=tiny) * alive
        z_store[j] = z * valid[j]
        h_mat[:, j] = h_col * valid[j]
        valid[j + 1] = alive
    # The SVD minimum-norm min ‖β e₁ − H y‖ with jnp.linalg.lstsq's cutoff.
    u, sv, vh = torch.linalg.svd(h_mat, full_matrices=False)
    cut = torch.finfo(dtype).eps * (m + 1) * sv[0]
    keep = (sv > 0) & (sv >= cut)
    s_inv = torch.where(keep, 1.0 / torch.where(keep, sv, torch.ones_like(sv)),
                        torch.zeros_like(sv))
    y = vh.T @ (s_inv * (u[0] * beta))
    return z_store.T @ y


def _pgmres_block(a_op, m_op, b: torch.Tensor, m: int, s: int = 4,
                  plain: bool = False) -> torch.Tensor:
    """s-step right-preconditioned GMRES, one cycle, over lanes.

    ``b`` is ``[B, N]``; ``a_op``/``m_op`` map ``[B, N]`` to ``[B, N]``.
    Each block runs the normalized power chain z = M⁻¹u, w = A z for
    ``s`` steps (a lane whose ‖w‖ falls to the breakdown threshold stops
    contributing), then S3 orthogonalizes the block into the basis; at
    the end S4 solves the small least squares and returns ``x = Zᵀ y``
    (``[B, N]``).  ``m`` rounds up to a multiple of ``s``.  ``plain``
    takes the kernels' plain versions on any device.
    """
    orth = sk.gmres_block_orth_plain if plain else sk.gmres_block_orth
    lstsq = sk.gmres_lstsq_plain if plain else sk.gmres_lstsq
    dtype = b.dtype
    lanes, nvec = b.shape
    s = max(1, min(int(s), int(m)))
    nb = -(-int(m) // s)
    mm = nb * s
    tiny = torch.finfo(dtype).tiny
    beta = torch.linalg.vector_norm(b, dim=1)
    safe_beta = torch.clamp(beta, min=tiny)

    v_basis = b.new_zeros(lanes, mm + 1, nvec)
    v_basis[:, 0] = b / safe_beta[:, None]
    z_store = b.new_zeros(lanes, mm, nvec)
    w_store = b.new_zeros(lanes, mm, nvec)
    valid = b.new_zeros(lanes, mm + 1)
    valid[:, 0] = 1.0
    alive = b.new_ones(lanes)
    for k in range(nb):
        j0 = k * s
        u = v_basis[:, j0]
        a = alive * valid[:, j0]
        ws = []
        for i in range(s):  # the serial chain
            z = m_op(u)
            w = a_op(z)
            z_store[:, j0 + i] = z * a[:, None]
            ws.append(w * a[:, None])
            nrm = torch.linalg.vector_norm(w, dim=1)
            a = a * (nrm > sk.BREAKDOWN).to(dtype)
            u = w / torch.clamp(nrm, min=tiny)[:, None]
        w_blk = torch.stack(ws, dim=1)
        w_store[:, j0:j0 + s] = w_blk
        orth(v_basis, valid, w_blk, j0)
        alive = a
    return lstsq(v_basis, valid, w_store, z_store, beta)


def host_injections(sys: BusSystem, theta, v, status=None):
    """Host float64 realized bus injections ``(p, q)`` at ``(θ, V)``
    (one lane): the MATPOWER branch model evaluated branch-wise in
    numpy double precision, status masking included."""
    n = sys.n_bus
    theta = np.asarray(theta, np.float64)
    v = np.asarray(v, np.float64)
    ys = 1.0 / (sys.r.astype(np.float64) + 1j * sys.x.astype(np.float64))
    bc2 = 1j * sys.b_chg.astype(np.float64) / 2.0
    if status is not None:
        on = np.asarray(status, np.float64)
        ys = ys * on
        bc2 = bc2 * on
    tap_shift = sys.tap.astype(np.float64) * np.exp(
        1j * sys.shift.astype(np.float64)
    )
    yff = (ys + bc2) / (sys.tap.astype(np.float64) ** 2)
    ytt = ys + bc2
    yft = -(ys / np.conj(tap_shift))
    ytf = -(ys / tap_shift)
    f, t = sys.from_bus, sys.to_bus
    vc = v * np.exp(1j * theta)
    i_f = yff * vc[f] + yft * vc[t]
    i_t = ytf * vc[f] + ytt * vc[t]
    s_f = vc[f] * np.conj(i_f)
    s_t = vc[t] * np.conj(i_t)
    p = np.zeros(n)
    q = np.zeros(n)
    np.add.at(p, f, s_f.real)
    np.add.at(p, t, s_t.real)
    np.add.at(q, f, s_f.imag)
    np.add.at(q, t, s_t.imag)
    v2 = v * v
    p += sys.g_shunt * v2
    q -= sys.b_shunt * v2
    return p, q


def true_mismatch(sys: BusSystem, result, status=None) -> np.ndarray:
    """Host float64 oracle: the max masked power-flow residual of each
    lane of a result (``[B]``), independent of every device dtype."""
    th_free = sys.bus_type != SLACK
    v_free = sys.bus_type == PQ
    theta = np.atleast_2d(np.asarray(torch.as_tensor(result.theta).cpu(),
                                     np.float64))
    v = np.atleast_2d(np.asarray(torch.as_tensor(result.v).cpu(), np.float64))
    out = np.empty(theta.shape[0])
    for b in range(theta.shape[0]):
        p, q = host_injections(sys, theta[b], v[b], status=status)
        fp = np.where(th_free, p - sys.p_inj, 0.0)
        fq = np.where(v_free, q - sys.q_inj, 0.0)
        out[b] = max(np.max(np.abs(fp)), np.max(np.abs(fq)))
    return out
