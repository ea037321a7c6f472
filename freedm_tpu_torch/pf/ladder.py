"""Unbalanced 3-phase radial power flow — the ladder (forward/backward
sweep) method.

Port of ``freedm_tpu/pf/ladder.py``: iterate

1. load currents   ``I_L = conj(S_load / V)`` on live phases,
2. backward sweep  branch currents accumulate rootward,
3. forward sweep   voltage drops accumulate leafward,

until the substation branch current stops changing (``eps = 1e-4``,
``max_iter = 20``).  ``solve`` runs each lane to that criterion (the
reference's ``while_loop``), ``solve_fixed`` exactly ``max_iter``
iterations, differentiable in the loads (the VVC gradient).  The lane
axis is written out: loads may carry a leading ``[B]`` axis.

On the card a whole solve is one launch of the hand-written kernel L1
(:func:`~freedm_tpu_torch.kernels.ladder_kernels.ladder_solve`) in DFS
preorder space — the permutation in and its inverse out are applied once
a call, as the reference applies them — and ``solve_fixed``'s backward is
L2 (:class:`~freedm_tpu_torch.kernels.ladder_kernels.LadderFixed`).  On
the CPU ``sweep_method=None`` selects as the reference does — the dense
subtree matmul when the feeder compiled one, else the Euler-tour sweeps
(L1's plain version in preorder space) — so parity tests compare like
with like; ``"dense"`` and ``"doubling"`` run only there.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from freedm_tpu_torch import cplx
from freedm_tpu_torch.cplx import C
from freedm_tpu_torch.device import DeviceLike, resolve_device
from freedm_tpu_torch.grid.feeder import Feeder
from freedm_tpu_torch.kernels import ladder_kernels as lk
from freedm_tpu_torch.pf.sweeps import make_sweeps

Tensor = torch.Tensor

#: 120°-displaced unit source phasors (phases a, b, c).
SOURCE_UNIT = np.array([1.0, np.exp(-2j * np.pi / 3), np.exp(2j * np.pi / 3)])


class LadderResult(NamedTuple):
    """Power-flow solution, per unit: ``v_node [..., nn, 3]`` (node 0 the
    substation), ``i_branch``, ``i_load [..., nb, 3]`` pairs; per lane the
    iterations (int32), the converged flag and the final substation-current
    change.  The lane axis is there when the loads had one."""

    v_node: C
    i_branch: C
    i_load: C
    iterations: Tensor
    converged: Tensor
    residual: Tensor


def make_ladder_solver(
    feeder: Feeder,
    eps: float = 1e-4,
    max_iter: int = 20,
    dtype: torch.dtype = torch.float64,
    sweep_method: Optional[str] = None,
    device: DeviceLike = None,
    plain: bool = False,
    mesh=None,
):
    """Build the ladder solvers of a feeder.

    Returns ``(solve, solve_fixed)``, each ``(s_load_kva, v_source_pu=None)
    -> LadderResult`` with the loads in kW + j·kvar as a complex array or
    tensor, or a ``(re, im)`` pair, ``[nb, 3]`` or ``[B, nb, 3]``;
    ``v_source_pu`` a scalar or a ``[B]`` tensor (default the feeder's).
    ``solve_fixed`` is differentiable in the loads: on the card through
    :class:`~freedm_tpu_torch.kernels.ladder_kernels.LadderFixed` (L1
    forward, L2 backward), on the CPU through the plain versions; a
    ``v_source_pu`` that requires a gradient raises on the card.

    ``sweep_method`` is ``None``, ``"euler"``, ``"dense"`` or
    ``"doubling"`` (module docstring); ``plain=True`` runs L1's plain
    version on any device — the on-card reference ``chip_smoke.py``
    holds the kernel to.  ``mesh`` (the reference's sharded form) is not
    ported and raises.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the mesh-sharded ladder form is not ported (ROADMAP.md, module "
            "queue item 16: multi-GPU lane sharding)"
        )
    dev = resolve_device(device)
    if dtype not in (torch.float64, torch.float32):
        raise TypeError(f"dtype must be float64 or float32, got {dtype}")
    if sweep_method not in (None, "dense", "doubling", "euler"):
        raise ValueError(f"unknown sweep method: {sweep_method!r}")
    on_card = dev.type == "cuda"
    if on_card and sweep_method in ("dense", "doubling"):
        raise NotImplementedError(
            f"sweep_method={sweep_method!r} runs on the CPU only: the card "
            f"runs the ladder on L1 in preorder space (sweep_method=None or "
            f"'euler'); the dense and doubling sweeps on the card are module "
            f"queue item 9's remainder (ROADMAP.md)"
        )
    eps = float(eps)
    max_iter = int(max_iter)
    nb = feeder.n_branches
    use_l1 = sweep_method == "euler" or (
        sweep_method is None and (on_card or feeder.subtree is None))

    perm = inv = None
    if use_l1:
        work, order = feeder.reorder_preorder()
        if work is not feeder:
            perm = torch.as_tensor(order, dtype=torch.int64, device=dev)
            inv = torch.as_tensor(np.argsort(order), dtype=torch.int64,
                                  device=dev)
        op = lk.ladder_operands(work, dtype, dev)
        mask, z_re, z_im, root = op.mask, op.z_re, op.z_im, op.root
        backward, forward = lk.preorder_sweeps(op)
    else:
        op = None
        backward, forward = make_sweeps(feeder, dtype, sweep_method, dev)

        def real(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        mask = real(feeder.phase_mask)
        z_re, z_im = real(feeder.z_pu.real), real(feeder.z_pu.imag)
        root = real((feeder.parent < 0).astype(np.float64))
    s_base = feeder.s_base_per_phase_kva
    unit = cplx.as_c(SOURCE_UNIT, dtype, dev)

    def prep(s_load_kva, v_source_pu):
        s = cplx.as_c(s_load_kva, dtype, dev)
        batched = s.re.dim() == 3
        if not batched:
            s = C(s.re[None], s.im[None])
        if s.re.dim() != 3 or tuple(s.re.shape[1:]) != (nb, 3):
            raise ValueError(f"s_load_kva must be [{nb}, 3] or [B, {nb}, 3], "
                             f"got {tuple(s.re.shape)}")
        lanes = s.re.shape[0]
        s_pu = s / s_base
        if perm is not None:
            s_pu = C(s_pu.re[:, perm], s_pu.im[:, perm])
        vs = feeder.v_source_pu if v_source_pu is None else v_source_pu
        vs = torch.as_tensor(vs, dtype=dtype, device=dev)
        if vs.dim() == 0:
            vs = vs.expand(lanes)
        if tuple(vs.shape) != (lanes,):
            raise ValueError(f"v_source_pu must be a scalar or [{lanes}], "
                             f"got {tuple(vs.shape)}")
        v0 = C((unit.re[None, :] * vs[:, None]).contiguous(),
               (unit.im[None, :] * vs[:, None]).contiguous())
        return C(s_pu.re.contiguous(), s_pu.im.contiguous()), v0, batched

    def finish(v0: C, v: C, ib: C, il: C, it, conv, err, batched):
        if inv is not None:
            v, ib, il = (C(x.re[:, inv], x.im[:, inv]) for x in (v, ib, il))
        v_node = C(torch.cat([v0.re[:, None, :], v.re], dim=1),
                   torch.cat([v0.im[:, None, :], v.im], dim=1))
        res = LadderResult(v_node, ib, il, it, conv, err)
        if batched:
            return res
        return LadderResult(*(C(x.re[0], x.im[0]) if isinstance(x, C)
                              else x[0] for x in res))

    def iterate_plain(s_pu, v0, fixed):
        return lk.ladder_iterate_plain(s_pu, v0, mask, z_re, z_im, root,
                                       backward, forward, eps, max_iter,
                                       fixed)

    def solve(s_load_kva, v_source_pu=None) -> LadderResult:
        s_pu, v0, batched = prep(s_load_kva, v_source_pu)
        if not use_l1:
            out = iterate_plain(s_pu, v0, fixed=False)
        elif plain:
            out = lk.ladder_solve_plain(s_pu, v0, op, eps, max_iter, False)
        else:
            out = lk.ladder_solve(s_pu, v0, op, eps, max_iter, False)
        return finish(v0, out.v, out.i_branch, out.i_load, out.iterations,
                      out.converged, out.residual, batched)

    def solve_fixed(s_load_kva, v_source_pu=None) -> LadderResult:
        if isinstance(v_source_pu, Tensor) and v_source_pu.requires_grad \
                and on_card and not plain:
            raise NotImplementedError(
                "solve_fixed differentiates the loads only on the card: L2 "
                "gives no v_source_pu gradient (pass a plain value)"
            )
        s_pu, v0, batched = prep(s_load_kva, v_source_pu)
        grad = torch.is_grad_enabled() and (
            s_pu.re.requires_grad or s_pu.im.requires_grad)
        if use_l1 and grad and not plain and not v0.re.requires_grad:
            (v_re, v_im, ib_re, ib_im, il_re, il_im, it, conv,
             err) = lk.LadderFixed.apply(s_pu.re, s_pu.im, v0.re, v0.im, op,
                                         eps, max_iter)
            return finish(v0, C(v_re, v_im), C(ib_re, ib_im),
                          C(il_re, il_im), it, conv, err, batched)
        if use_l1 and not grad and not plain:
            out = lk.ladder_solve(s_pu, v0, op, eps, max_iter, True)
        else:  # the plain loop, differentiable by torch.autograd
            out = iterate_plain(s_pu, v0, fixed=True)
        return finish(v0, out.v, out.i_branch, out.i_load, out.iterations,
                      out.converged, out.residual, batched)

    return solve, solve_fixed


# ---------------------------------------------------------------------------
# Derived quantities (plain tensor functions; a leading lane axis passes)
# ---------------------------------------------------------------------------


def _nodes(x: C, sl) -> C:
    return C(x.re[..., sl, :], x.im[..., sl, :])


def v_polar(result: LadderResult):
    """(|V| pu, angle degrees) per node and phase."""
    mag = result.v_node.abs()
    ang = torch.rad2deg(result.v_node.angle())
    return mag, torch.where(mag > 0, ang, torch.zeros_like(ang))


def branch_power_kva(feeder: Feeder, result: LadderResult) -> C:
    """``[..., nb, 3]`` kVA flowing into each branch's receiving node."""
    return (_nodes(result.v_node, slice(1, None)) * result.i_branch.conj()
            ) * feeder.s_base_per_phase_kva


def substation_power_kva(feeder: Feeder, result: LadderResult) -> C:
    """``[..., 3]`` kVA leaving the substation."""
    root = torch.as_tensor(feeder.parent < 0, device=result.i_branch.re.device)
    i_root = result.i_branch.where(root[:, None]).sum(dim=-2)
    v0 = C(result.v_node.re[..., 0, :], result.v_node.im[..., 0, :])
    return (v0 * i_root.conj()) * feeder.s_base_per_phase_kva


def load_power_kva(feeder: Feeder, result: LadderResult) -> C:
    """``[..., nb, 3]`` kVA drawn by each load."""
    return (_nodes(result.v_node, slice(1, None)) * result.i_load.conj()
            ) * feeder.s_base_per_phase_kva


def total_loss_kw(feeder: Feeder, result: LadderResult) -> Tensor:
    """Total real losses = substation injection − total load (the VVC
    objective), per lane."""
    p_sub = torch.sum(substation_power_kva(feeder, result).re, dim=-1)
    p_load = torch.sum(load_power_kva(feeder, result).re, dim=(-2, -1))
    return p_sub - p_load
