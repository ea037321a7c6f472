"""Batched DC loadflow screening: one B′ factorization amortized over
many injection and single-outage lanes.

Port of ``freedm_tpu/pf/dc.py``.  Under the DC approximation (|V| ≡ 1,
sin E ≈ E, losses dropped) the network reduces to the constant system
B′·θ = P, with B′ the series-1/x matrix of the fast-decoupled solver
(:func:`freedm_tpu_torch.pf.fdlf.decoupled_parts`, pinned slack row
identity).  Factorized once, every query is linear algebra on the
factors:

- injection lanes: a ``[L, n]`` P stack is one multi-RHS
  ``torch.linalg.lu_solve``, then kernel D1's SOLVE mode for the flows;
- single-outage lanes: removing branch k is the rank-1 update
  B′ − w_k a_k a_kᵀ (a_k = e_f − e_t masked by the free-θ rows,
  w_k = 1/x_k), a Sherman–Morrison correction off the same base solve:
  one more multi-RHS solve for the requested update columns, then D1's
  SCREEN mode per lane (angles, flows, severity).  A (numerically)
  singular denominator marks a bridge outage: the lane is flagged
  ``islanded`` — the filter the AC screens need.

The screen is a ranker, not a verifier:
:func:`freedm_tpu_torch.pf.n1.make_n1_screen` takes ``dc_prefilter=k`` to
DC-rank an outage list and AC-verify only the ``k`` worst.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from freedm_tpu_torch.device import DeviceLike, resolve_device
from freedm_tpu_torch.kernels import screen_kernels as sck
from freedm_tpu_torch.pf.fdlf import decoupled_parts

#: |1 − w·aᵀz| below this marks the Sherman–Morrison denominator
#: singular — the outage islands the network (bridge branch).
_ISLAND_EPS = sck.ISLAND_EPS


class DcResult(NamedTuple):
    """One DC solve's output."""

    theta: torch.Tensor  # [..., n] bus angles, radians
    flows: torch.Tensor  # [..., m] per-branch P flows, pu (from → to)


class DcScreenResult(NamedTuple):
    """DC N-1 screen output, one lane per requested outage."""

    theta: torch.Tensor  # [k, n] post-outage angles
    flows: torch.Tensor  # [k, m] post-outage branch flows (outaged col = 0)
    severity: torch.Tensor  # [k] max |flow| pu; +inf on islanded lanes
    islanded: torch.Tensor  # [k] bool: bridge outage (lane not usable)


class DcSolver(NamedTuple):
    """The DC operators of one case (see :func:`make_dc_solver`)."""

    solve: Callable  # (p [n] | [L, n] | None) -> DcResult
    screen_outages: Callable  # (outages [k], p=None) -> DcScreenResult
    n_bus: int
    n_branch: int


def dc_operands(sys, device: DeviceLike = None) -> sck.DcOperands:
    """D1's operands for ``sys`` on ``device``: the branch ends, ``w =
    1/x`` and the free-θ mask (float64)."""
    dev = resolve_device(device)
    return sck.DcOperands(
        f=torch.as_tensor(np.asarray(sys.from_bus, np.int64), device=dev),
        t=torch.as_tensor(np.asarray(sys.to_bus, np.int64), device=dev),
        w=torch.as_tensor(1.0 / np.asarray(sys.x, np.float64), device=dev),
        th_free=decoupled_parts(sys, device=dev).th_free,
    )


def outage_columns(op: sck.DcOperands, ks: torch.Tensor) -> torch.Tensor:
    """The masked update columns ``a_k = e_f·mask_f − e_t·mask_t`` of the
    requested branches ``ks [k]``, lane-major ``[k, n]`` (a solve reads
    them as the column-major ``[n, k]`` matrix ``.mT``)."""
    k, n = int(ks.shape[0]), int(op.th_free.shape[0])
    lanes = torch.arange(k, device=ks.device)
    fk, tk = op.f[ks], op.t[ks]
    cols = torch.zeros(k, n, dtype=op.th_free.dtype, device=ks.device)
    cols.index_put_((lanes, fk), op.th_free[fk], accumulate=True)
    cols.index_put_((lanes, tk), -op.th_free[tk], accumulate=True)
    return cols


def make_dc_solver(sys, dtype: torch.dtype = torch.float64, lu=None,
                   device: DeviceLike = None, plain: bool = False
                   ) -> DcSolver:
    """Factorize B′ once and build the DC lane operators on ``device``
    (``cuda`` unless the CPU is asked for), float64.

    ``solve`` accepts a single ``[n]`` injection vector or a ``[L, n]``
    lane stack (one triangular solve either way; ``None`` = the case's
    own injections); ``screen_outages`` takes branch indices and an
    optional injection vector and returns the Sherman–Morrison-corrected
    post-outage angles, flows and severity.  ``lu`` optionally passes an
    already-computed ``torch.linalg.lu_factor`` pair of this case's B′
    (the serving cache's entries hold exactly that pair), so no second
    factorization runs.  ``plain=True`` runs D1's plain version on any
    device.
    """
    if dtype != torch.float64:
        raise TypeError(f"the DC screen runs in float64, got {dtype}")
    dev = resolve_device(device)
    n, m = sys.n_bus, sys.n_branch
    op = dc_operands(sys, device=dev)
    th_free = op.th_free
    p0 = torch.as_tensor(np.asarray(sys.p_inj, np.float64), device=dev)
    if lu is None:
        lu = torch.linalg.lu_factor(
            decoupled_parts(sys, dtype=dtype, device=dev).b_prime(None))
    lu_mat, piv = lu
    screen_fn = sck.dc_screen_plain if plain else sck.dc_screen
    flows_kernel = sck.dc_flows_plain if plain else sck.dc_flows

    def flows_fn(theta):
        return flows_kernel(theta, op)

    def injections(p):
        pj = p0 if p is None else torch.as_tensor(p, dtype=dtype, device=dev)
        return torch.where(th_free > 0, pj, torch.zeros_like(pj))

    def solve(p=None) -> DcResult:
        rhs = injections(p)
        if rhs.dim() == 1:
            theta = torch.linalg.lu_solve(lu_mat, piv, rhs[:, None])[:, 0]
            return DcResult(theta=theta, flows=flows_fn(theta[None])[0])
        # [L, n] lanes: one multi-RHS triangular solve.
        theta = torch.linalg.lu_solve(lu_mat, piv, rhs.mT).mT
        return DcResult(theta=theta, flows=flows_fn(theta))

    def screen_outages(outages, p=None) -> DcScreenResult:
        ks = torch.as_tensor(np.asarray(outages, np.int64).reshape(-1),
                             device=dev)
        rhs = injections(p)
        theta0 = torch.linalg.lu_solve(lu_mat, piv, rhs[:, None])[:, 0]
        # The requested branches' update columns only ([n, k], never
        # [n, m]), solved in one multi-RHS pass.
        z = torch.linalg.lu_solve(lu_mat, piv, outage_columns(op, ks).mT)
        theta, flows, sev, isl = screen_fn(theta0, z, ks, op)
        return DcScreenResult(theta=theta, flows=flows, severity=sev,
                              islanded=isl)

    return DcSolver(solve=solve, screen_outages=screen_outages, n_bus=n,
                    n_branch=m)
