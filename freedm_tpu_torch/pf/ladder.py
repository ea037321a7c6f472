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

On the card the sweep method picks a hand-written kernel
(:mod:`~freedm_tpu_torch.kernels.ladder_kernels`): ``None`` and
``"euler"`` run L1 ``ladder_solve`` in DFS preorder space — a whole solve
is one launch, the permutation in and its inverse out applied once a
call, as the reference applies them — with ``solve_fixed``'s backward on
L2; ``"dense"`` runs L3 ``ladder_dense`` (products with the subtree
matrix) and ``"doubling"`` L4 ``ladder_doubling`` (pointer jumping), both
in the caller's branch order as the reference's dense and doubling sweeps
are, each with its own reverse mode.  ``solve_fixed`` takes the
differentiable :class:`~freedm_tpu_torch.kernels.ladder_kernels.
LadderFixed` whenever the loads or ``v_source_pu`` require a gradient.
One deviation: where the reference's ``sweep_method=None`` auto-selects
the dense sweeps (a feeder that compiled its subtree matrix, ≤ 2048
branches), the card runs L1 — the same function, summed in another
order.  On the CPU each route runs its kernel's plain version (a wrapper
takes it for CPU tensors; the dense and doubling forms' sweeps are those
of :mod:`~freedm_tpu_torch.pf.sweeps`) — ``solve_fixed``'s gradient
through L2's plain version on the Euler form, by ``torch.autograd`` of
the plain solve on the dense and doubling ones, as the reference
differentiates them — and ``sweep_method=None`` selects as
the reference does — L3's plain version when the feeder compiled its
subtree matrix, else L1's in preorder space — so parity tests compare
like with like.
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
    ``solve_fixed`` is differentiable in the loads and in
    ``v_source_pu``: on the card, and for the Euler form on the CPU,
    through :class:`~freedm_tpu_torch.kernels.ladder_kernels.LadderFixed`
    (the form's fixed solve forward, its reverse mode backward), else by
    ``torch.autograd`` of the plain solve.

    ``sweep_method`` is ``None``, ``"euler"``, ``"dense"`` or
    ``"doubling"`` (module docstring); ``plain=True`` runs the kernel's
    plain version on any device — the on-card reference ``chip_smoke.py``
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
    eps = float(eps)
    max_iter = int(max_iter)
    nb = feeder.n_branches
    use_l1 = sweep_method == "euler" or (
        sweep_method is None and (on_card or feeder.subtree is None))

    # The route's operands, kernel and plain version; whether solve_fixed
    # differentiates through LadderFixed.  The CPU's dense and doubling
    # forms take torch.autograd of the plain solve instead: it adds in the
    # reference's order, and a reverse mode's rounding moves the CPU's VVC
    # trajectory (vvc_9bus, dense) past its 1e-9 parity within 12 rounds.
    reverse_mode = on_card or use_l1
    perm = inv = None
    if use_l1:
        work, order = feeder.reorder_preorder()
        if work is not feeder:
            perm = torch.as_tensor(order, dtype=torch.int64, device=dev)
            inv = torch.as_tensor(np.argsort(order), dtype=torch.int64,
                                  device=dev)
        op = lk.ladder_operands(work, dtype, dev)
        kernel, plain_fn = lk.ladder_solve, lk.ladder_solve_plain
    elif sweep_method != "doubling":
        op = lk.dense_operands(feeder, dtype, dev)
        kernel, plain_fn = lk.ladder_dense, lk.ladder_dense_plain
    else:
        op = lk.doubling_operands(feeder, dtype, dev)
        kernel, plain_fn = lk.ladder_doubling, lk.ladder_doubling_plain
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

    def solve(s_load_kva, v_source_pu=None) -> LadderResult:
        s_pu, v0, batched = prep(s_load_kva, v_source_pu)
        out = (plain_fn if plain else kernel)(s_pu, v0, op, eps, max_iter,
                                              False)
        return finish(v0, out.v, out.i_branch, out.i_load, out.iterations,
                      out.converged, out.residual, batched)

    def solve_fixed(s_load_kva, v_source_pu=None) -> LadderResult:
        s_pu, v0, batched = prep(s_load_kva, v_source_pu)
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (s_pu.re, s_pu.im, v0.re, v0.im))
        if grad and reverse_mode and not plain:
            (v_re, v_im, ib_re, ib_im, il_re, il_im, it, conv,
             err) = lk.LadderFixed.apply(s_pu.re, s_pu.im, v0.re, v0.im, op,
                                         eps, max_iter)
            return finish(v0, C(v_re, v_im), C(ib_re, ib_im),
                          C(il_re, il_im), it, conv, err, batched)
        # plain: differentiable by torch.autograd
        out = (plain_fn if plain else kernel)(s_pu, v0, op, eps, max_iter,
                                              True)
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
