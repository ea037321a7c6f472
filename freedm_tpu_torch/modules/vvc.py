"""Gradient Volt-VAR control (VVC).

Port of ``freedm_tpu/modules/vvc.py``.  One round:

1. the loss and its gradient in the controllable Q injections,
   ``torch.autograd.grad`` through the fixed-iteration ladder solve — on
   the card :class:`~freedm_tpu_torch.kernels.ladder_kernels.LadderFixed`:
   L1 forward, L2 backward (the reference: ``jax.value_and_grad``);
2. a projected step, the Q setpoints clipped to the SST kvar limits;
3. backtracking: the step size halves until the loss decreases, each
   trial one fixed solve (one L1 launch over every lane).

The backtracking loop keeps the per-lane semantics of the reference's
``vmap``ped ``while_loop``: a lane freezes at its first accepted trial,
and the others keep halving, up to ``max_backtracks`` trials.  It is a
host loop with one read of the lanes' acceptance flags a trial (the
loop's only host syncs; the gradient needs none), so a step on the card
costs one L1 and one L2 launch for the gradient and one L1 launch a
trial.  :func:`run_rounds` is a host loop over rounds with the
reference's step-size warm start.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from freedm_tpu_torch import cplx
from freedm_tpu_torch.cplx import C
from freedm_tpu_torch.device import DeviceLike, resolve_device
from freedm_tpu_torch.grid.feeder import Feeder
from freedm_tpu_torch.pf import ladder

Tensor = torch.Tensor


class VVCConfig(NamedTuple):
    """Controller knobs: the initial step ``alpha0``, its shrink factor a
    rejected trial, the most trials, the ladder iterations of a trial
    solve, and the SST kvar limits ``q_min_kvar``/``q_max_kvar``."""

    q_min_kvar: float = -500.0
    q_max_kvar: float = 500.0
    alpha0: float = 1.0
    backtrack: float = 0.5  # step shrink factor per rejected trial
    max_backtracks: int = 12
    pf_iters: int = 20  # fixed ladder iterations per trial solve


class VVCStep(NamedTuple):
    """One VVC round (a leading lane axis when the loads had one)."""

    q_ctrl_kvar: Tensor  # [nb, 3] accepted Q setpoints (0 where not controlled)
    loss_before_kw: Tensor  # [] base-solve losses
    loss_after_kw: Tensor  # [] losses at the accepted setpoints
    alpha: Tensor  # [] accepted step size (0 if no improving step found)
    improved: Tensor  # [] bool: a descent step was accepted
    grad_kw_per_kvar: Tensor  # [nb, 3] loss gradient at the start point
    v_delta_pu: Tensor  # [nn, 3] voltage magnitude change vs the base solve


def make_vvc_controller(
    feeder: Feeder,
    ctrl_mask: Optional[np.ndarray] = None,
    config: VVCConfig = VVCConfig(),
    dtype: torch.dtype = torch.float64,
    device: DeviceLike = None,
    plain: bool = False,
):
    """Build the VVC round function.

    ``ctrl_mask`` is a ``[nb, 3]`` 0/1 array marking the controllable
    node-phases (default: every live node-phase).  Returns ``step(
    s_load_kva, q_ctrl_kvar, alpha0=None) -> VVCStep`` with the loads
    ``[nb, 3]`` or ``[B, nb, 3]`` (complex, or a ``(re, im)`` pair), the
    setpoints accepted last round (same shape, real) and the starting
    step size (a scalar or ``[B]``; default ``config.alpha0``).
    ``plain=True`` runs the ladder's plain version on any device.
    """
    dev = resolve_device(device)
    mask = torch.as_tensor(
        np.asarray(feeder.phase_mask if ctrl_mask is None else ctrl_mask),
        dtype=dtype, device=dev)
    _, solve_fixed = ladder.make_ladder_solver(
        feeder, max_iter=config.pf_iters, dtype=dtype, device=dev,
        plain=plain)

    def loss_aux(q_kvar: Tensor, s: C):
        # Injecting reactive power reduces the load's Q draw.
        result = solve_fixed(C(s.re, s.im - q_kvar * mask))
        return ladder.total_loss_kw(feeder, result), result

    def project(q_kvar: Tensor) -> Tensor:
        return torch.clamp(q_kvar, config.q_min_kvar, config.q_max_kvar) * mask

    def step(s_load_kva, q_ctrl_kvar, alpha0=None) -> VVCStep:
        s = cplx.as_c(s_load_kva, dtype, dev)
        batched = s.re.dim() == 3
        if not batched:
            s = C(s.re[None], s.im[None])
        lanes = s.re.shape[0]
        q0 = torch.as_tensor(q_ctrl_kvar, dtype=dtype, device=dev)
        q0 = q0.detach().expand_as(s.re).clone()
        alpha = torch.as_tensor(config.alpha0 if alpha0 is None else alpha0,
                                dtype=dtype, device=dev)
        alpha = alpha.detach().expand(lanes).clone()
        with torch.enable_grad():
            qg = q0.clone().requires_grad_(True)
            loss0, base = loss_aux(qg, s)
            (g,) = torch.autograd.grad(loss0.sum(), qg)
        loss0 = loss0.detach()
        v_base_c = C(base.v_node.re.detach(), base.v_node.im.detach())
        with torch.no_grad():
            accepted = torch.zeros(lanes, dtype=torch.bool, device=dev)
            loss1 = loss0.clone()
            v_trial = v_base_c
            for _ in range(config.max_backtracks):
                active = ~accepted
                a3 = active[:, None, None]
                loss_try, res_try = loss_aux(
                    project(q0 - alpha[:, None, None] * g), s)
                ok = loss_try < loss0
                alpha = torch.where(active & ~ok, alpha * config.backtrack,
                                    alpha)
                loss1 = torch.where(active, torch.where(ok, loss_try, loss0),
                                    loss1)
                v_trial = C(torch.where(a3, res_try.v_node.re, v_trial.re),
                            torch.where(a3, res_try.v_node.im, v_trial.im))
                accepted = accepted | (active & ok)
                if bool(accepted.all()):  # the trial's one host read
                    break
            acc3 = accepted[:, None, None]
            q1 = torch.where(acc3, project(q0 - alpha[:, None, None] * g), q0)
            v_after = C(torch.where(acc3, v_trial.re, v_base_c.re),
                        torch.where(acc3, v_trial.im, v_base_c.im)).abs()
            out = VVCStep(
                q_ctrl_kvar=q1,
                loss_before_kw=loss0,
                loss_after_kw=torch.where(accepted, loss1, loss0),
                alpha=torch.where(accepted, alpha, torch.zeros_like(alpha)),
                improved=accepted,
                grad_kw_per_kvar=g,
                v_delta_pu=v_after - v_base_c.abs(),
            )
        if batched:
            return out
        return VVCStep(*(x[0] for x in out))

    return step


def run_rounds(step, s_load_kva, q0_kvar, n_rounds: int,
               alpha0: float = 2000.0):
    """Iterate ``n_rounds`` VVC rounds (a host loop).

    The accepted step size is warm-started across rounds: doubled after
    an accepted round, halved after a dry one, never below 1e-3.  Returns
    the final setpoints and the per-round losses, step sizes and
    acceptance flags, stacked on a leading round axis.
    """
    q = torch.as_tensor(q0_kvar)
    alpha = float(alpha0)
    losses, alphas, improved = [], [], []
    for _ in range(int(n_rounds)):
        out = step(s_load_kva, q, alpha)
        alpha = torch.where(out.improved, out.alpha * 2.0, alpha * 0.5)
        alpha = torch.clamp_min(alpha, 1e-3)
        q = out.q_ctrl_kvar
        losses.append(out.loss_after_kw)
        alphas.append(out.alpha)
        improved.append(out.improved)
    return q, torch.stack(losses), torch.stack(alphas), torch.stack(improved)
