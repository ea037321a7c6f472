"""The Sherman–Morrison–Woodbury correction solve.

Port of ``smw_delta_solve`` (``freedm_tpu/pf/n1.py:86-121``), the
correction solve of the incremental machinery: the serving cache's
delta program runs it at rank 0 on the CPU and in the plain version of
kernel C1, which solves on the card itself (an injection delta moves the
right-hand side, not B′/B″), and the N-1 screen (ROADMAP item 8) at rank ≤ 2 with
``z``/``cap`` precomputed for every branch.  The rest of the reference
module — the SMW and sparse N-1 screens, ``secure_outages``,
``dc_prefilter`` — belongs to item 8.
"""

from __future__ import annotations

import torch


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
