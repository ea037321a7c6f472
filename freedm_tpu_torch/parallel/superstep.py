"""The superstep: one full DGI round on one card.

Port of ``freedm_tpu/parallel/superstep.py`` — the framework's "training
step", the composition the reference's ``dryrun_multichip`` runs:

    gm.form_groups  — G1 over the fleet's alive mask and reachability
    lb.lb_round     — B1, one round of the draft auction
    sc.collect      — the group-masked snapshot, one ``torch.matmul``
    vvc step        — the scenario lanes' VVC step (L1/L2) at once

The reference shards this over a device mesh (``nodes`` × ``batch``); the
port runs it on one card, and a mesh of more than one device raises
(ROADMAP.md, module queue item 16: multi-GPU sharding).  The state is
float32, the reference's state dtype.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from freedm_tpu_torch import cplx
from freedm_tpu_torch.cplx import C
from freedm_tpu_torch.device import DeviceLike, resolve_device
from freedm_tpu_torch.grid.feeder import Feeder
from freedm_tpu_torch.modules import gm, lb, sc, vvc

Tensor = torch.Tensor


class FleetState(NamedTuple):
    """Per-round fleet state."""

    alive: Tensor  # [N]
    reachable: Tensor  # [N, N]
    netgen: Tensor  # [N]
    gateway: Tensor  # [N]
    s_load: C  # [B, nb, 3]: per-scenario feeder loads (kVA)
    q_ctrl: Tensor  # [B, nb, 3]: VVC setpoints


class SuperstepOut(NamedTuple):
    state: FleetState
    group: gm.GroupState
    lb_out: lb.LBRound
    collected: sc.CollectedState
    vvc_loss: Tensor  # [B] per-scenario losses after the VVC step


def _mesh_devices(mesh) -> int:
    """Devices of a mesh: an int, or an object with ``size`` (an int or a
    method, as JAX's and PyTorch's meshes have), or ``devices``."""
    if isinstance(mesh, int):
        return mesh
    size = getattr(mesh, "size", None)
    if size is not None:
        return int(size() if callable(size) else size)
    return int(np.asarray(getattr(mesh, "devices")).size)


def make_superstep(
    mesh=None,
    feeder: Optional[Feeder] = None,
    migration_step: float = 1.0,
    vvc_config: vvc.VVCConfig = vvc.VVCConfig(),
    device: DeviceLike = None,
    plain: bool = False,
):
    """Build the superstep for one card (and an optional feeder).

    Returns ``(step, shard_state)``: ``step(state, invariant_ok=None,
    record=None) -> SuperstepOut`` runs one round; ``record``, if given,
    is called with ``"gm"``, ``"lb"``, ``"sc"`` and ``"vvc"`` after each
    phase is queued (a timing hook: ``chip_smoke.py`` records a CUDA event
    there).  ``shard_state`` places a host state on the device.
    ``feeder=None`` runs the round without a VVC leg (the config
    contract: no vvc-case = no VVC phase); the scenario leaves collapse
    to placeholder [B, 1, 3] zeros and ``vvc_loss`` is all-zero.
    ``mesh=None`` (or a one-device mesh) is the card; ``device`` is
    ``cuda`` unless the caller asks for the CPU; ``plain=True`` runs every
    kernel's plain version.
    """
    if mesh is not None and _mesh_devices(mesh) > 1:
        raise NotImplementedError(
            "the mesh-sharded superstep is not ported (ROADMAP.md, module "
            "queue item 16: multi-GPU sharding); pass mesh=None for one card"
        )
    dev = resolve_device(device)
    f32 = torch.float32
    vvc_step = (
        vvc.make_vvc_controller(feeder, config=vvc_config, dtype=f32,
                                device=dev, plain=plain)
        if feeder is not None
        else None
    )

    def step(state: FleetState, invariant_ok=None,
             record: Optional[Callable[[str], None]] = None) -> SuperstepOut:
        mark = record or (lambda _: None)
        group = gm.form_groups(state.alive, state.reachable, device=dev,
                               plain=plain)
        mark("gm")
        lb_out = lb.lb_round(state.netgen, state.gateway, group.group_mask,
                             migration_step, invariant_ok=invariant_ok,
                             device=dev, plain=plain)
        mark("lb")
        zeros = torch.zeros_like(state.gateway)
        collected = sc.collect(group.group_mask, lb_out.gateway, zeros, zeros,
                               zeros, zeros, lb_out.intransit)
        mark("sc")
        if vvc_step is not None:
            vvc_out = vvc_step(state.s_load, state.q_ctrl)
            new_state = state._replace(gateway=lb_out.gateway,
                                       q_ctrl=vvc_out.q_ctrl_kvar)
            vvc_loss = vvc_out.loss_after_kw
        else:
            new_state = state._replace(gateway=lb_out.gateway)
            vvc_loss = torch.zeros(state.q_ctrl.shape[0], dtype=f32,
                                   device=dev)
        mark("vvc")
        return SuperstepOut(state=new_state, group=group, lb_out=lb_out,
                            collected=collected, vvc_loss=vvc_loss)

    def shard_state(
        netgen: np.ndarray,
        gateway: np.ndarray,
        scenario_scale: np.ndarray,
        alive: Optional[np.ndarray] = None,
        reachable: Optional[np.ndarray] = None,
    ) -> FleetState:
        """The fleet state on the device, float32, from host arrays."""
        n = len(netgen)
        b = len(scenario_scale)
        base = (np.asarray(feeder.s_load) if feeder is not None
                else np.zeros((1, 3), np.complex128))
        s = base[None] * np.asarray(scenario_scale)[:, None, None]

        def put(x):
            return torch.as_tensor(np.asarray(x), dtype=f32, device=dev)

        return FleetState(
            alive=put(np.ones(n) if alive is None else alive),
            reachable=put(np.ones((n, n)) if reachable is None
                          else reachable),
            netgen=put(netgen),
            gateway=put(gateway),
            s_load=cplx.as_c(s, dtype=f32, device=dev),
            q_ctrl=torch.zeros(b, base.shape[0], 3, dtype=f32, device=dev),
        )

    return step, shard_state
