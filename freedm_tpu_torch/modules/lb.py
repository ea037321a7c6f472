"""Load balancing: the draft auction as vectorized matching.

Port of ``freedm_tpu/modules/lb.py``.  The reference's Akella power
balancing (``docs/modules/load_balance.rst``; ``lb/LoadBalance.cpp``):
each node classifies itself SUPPLY/DEMAND/NORMAL by a ±migration-step
band (``:412-453``), and the draft auction — DraftRequest → DraftAge →
``DraftStandard`` picks the largest age (``:749-797``) → DraftSelect →
DraftAccept or TooLate (``:854-956``) — becomes rank matching within
each group: the r-th ranked supply pairs with the r-th ranked demand,
demand ranked by age (deficit).  Acceptance, the malicious-node drop
(``:862-865``) and the invariant gate (``InvariantCheck``,
``:1237-1277``) are masks; actuation is a ±step gateway update, and the
in-flight ledger feeds :mod:`freedm_tpu_torch.modules.sc`.

On the card a round is B1 ``lb_rounds``
(:mod:`freedm_tpu_torch.kernels.dgi_kernels`), and :func:`run_rounds`
runs every round in that one launch, the gateway kept on chip; from 2¹⁵
nodes (the reference's unpacked branch) B1 sorts its WIDE key pairs — on
a thread-block cluster up to ``dk.lb_cluster_capacity`` nodes, by one
CTA above — so any ``N`` up to ``dk.LB_MAX_NODES`` that fits the card
runs.  The
``[N, N]`` ``matched`` matrix of :func:`lb_round` is one broadcast
compare of the ranks and group ids B1 writes.  :func:`group_ids` is
hoisted out of the rounds, as the reference does; :func:`_group_rank`
stays the O(N²) pairwise oracle.  Inputs may carry a leading fleet axis
(``[B, N]``, ``[B, N, N]``): the reference's ``vmap``, one launch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from freedm_tpu_torch.device import DeviceLike, resolve_device
from freedm_tpu_torch.kernels import dgi_kernels as dk

Tensor = torch.Tensor

# Node states (reference LBAgent::EState).
DEMAND = -1
NORMAL = 0
SUPPLY = 1


class LBRound(NamedTuple):
    """Result of one vectorized load-balance round."""

    state: Tensor  # [N] int32: -1 demand / 0 normal / +1 supply
    gateway: Tensor  # [N] updated gateway (predicted, post-migration)
    matched: Tensor  # [N, N] float32 0/1: migration supply i -> demand j
    supply_step: Tensor  # [N] float32 gateway delta applied at supply side
    demand_step: Tensor  # [N] float32 gateway delta applied at demand side
    intransit: Tensor  # [N] float32 signed pending gateway delta
    n_migrations: Tensor  # [] int32


def classify(net_generation: Tensor, gateway: Tensor, step: float) -> Tensor:
    """SUPPLY/DEMAND/NORMAL by the ±migration-step band
    (``UpdateState``, ``lb/LoadBalance.cpp:412-453``); ``step`` compares
    in the imbalance's dtype, as the reference's weakly typed scalar."""
    imbalance = net_generation - gateway
    s = torch.tensor(step, dtype=imbalance.dtype, device=imbalance.device)
    return torch.where(imbalance >= s, SUPPLY,
                       torch.where(imbalance <= -s, DEMAND, NORMAL)
                       ).to(torch.int32)


def _group_rank(key: Tensor, member: Tensor, group_mask: Tensor) -> Tensor:
    """Rank of each member *within its group* by descending key — the
    O(N²) pairwise oracle (the reference keeps it for its tests; no path
    calls it).  ``member``: [N] 0/1; ties break by node index; rank 0 is
    best; non-members get rank N."""
    n = key.shape[0]
    idx = torch.arange(n, device=key.device)
    key_j = key[:, None]
    key_i = key[None, :]
    beats = (key_j > key_i) | ((key_j == key_i) & (idx[:, None] < idx[None, :]))
    both = member[:, None] * member[None, :] * group_mask
    rank = torch.sum(beats.to(torch.float32) * both, dim=0)
    return torch.where(member > 0, rank,
                       torch.tensor(float(n), device=key.device)
                       ).to(torch.int32)


def group_ids(group_mask: Tensor) -> Tensor:
    """``[N]`` (``[B, N]``) partition id per node: the smallest member
    index of its group.  ``group_mask`` is gm's membership matrix — an
    equivalence relation, so equal ids ⟺ same group."""
    n = group_mask.shape[-1]
    idx = torch.arange(n, device=group_mask.device)
    # The first member of each row (torch.max returns the first index of
    # a row's largest value) — one byte an entry, where the reference's
    # min over where(mask > 0, idx, n) forms N² indices.
    hit, first = torch.max((group_mask > 0).view(torch.uint8), dim=-1)
    gid = torch.where(hit > 0, first, n)
    # A node is always in its own group even if the mask's diagonal is 0.
    return torch.minimum(gid, idx).to(torch.int32)


def _inputs(dev, net_generation, gateway, group_mask, malicious):
    ng = torch.as_tensor(net_generation, device=dev)
    gw = torch.as_tensor(gateway, device=dev)
    if not ng.is_floating_point():
        ng = ng.to(torch.float32)
    if not gw.is_floating_point():
        gw = gw.to(torch.float32)
    batched = gw.dim() == 2
    ng, gw = (ng, gw) if batched else (ng[None], gw[None])
    ng = ng.expand_as(gw).contiguous()
    gw = gw.contiguous()
    mask = torch.as_tensor(group_mask, device=dev)
    mal = None
    if malicious is not None:
        mal = torch.as_tensor(malicious, device=dev).to(torch.float32)
        mal = (mal if mal.dim() == 2 else mal[None]).contiguous()
    return batched, ng, gw, mask, mal


def lb_round(
    net_generation,
    gateway,
    group_mask,
    migration_step: float,
    malicious=None,
    invariant_ok=None,
    gid: Optional[Tensor] = None,
    device: DeviceLike = None,
    plain: bool = False,
) -> LBRound:
    """One complete LB round for all nodes (one B1 launch).

    ``net_generation``/``gateway``: [N] device readings (kW), float32 or
    float64; ``group_mask``: [N, N] from gm; ``malicious``: [N] 0/1 nodes
    that accept but never actuate (``--malicious-behavior``);
    ``invariant_ok``: [] or [N] 0/1 gate on migrations (frequency /
    power-flow feasibility; default pass); ``gid``: precomputed
    :func:`group_ids` (hoist it when the mask is loop-invariant).
    A node migrates iff its in-class rank in its group is below the
    opposite class's member count (the reference's sorted matching).
    ``device`` is ``cuda`` unless the caller asks for the CPU;
    ``plain=True`` runs B1's plain version on any device.
    """
    dev = resolve_device(device)
    batched, ng, gw, mask, mal = _inputs(dev, net_generation, gateway,
                                         group_mask, malicious)
    if gid is None:
        gid = group_ids(mask)
    gid = torch.as_tensor(gid, device=dev).to(torch.int32)
    gid = (gid if gid.dim() == 2 else gid[None]).contiguous()
    gate = None
    if invariant_ok is not None:
        gate = torch.as_tensor(invariant_ok, device=dev)
        gate = (torch.broadcast_to(gate, gw.shape) > 0).contiguous()
    fn = dk.lb_rounds_plain if plain else dk.lb_rounds
    out = fn(ng, gw, gid, migration_step, 1, mal, gate, round_outputs=True)
    state = out.states[:, 0]
    ok = (torch.ones((), dtype=torch.bool, device=dev) if gate is None
          else gate)
    mem_s = (state == SUPPLY) & ok
    mem_d = (state == DEMAND) & ok
    pair = ((out.rank[:, :, None] == out.rank[:, None, :])
            & (gid[:, :, None] == gid[:, None, :])
            & mem_s[:, :, None] & mem_d[:, None, :]).to(torch.float32)
    res = LBRound(
        state=state,
        gateway=out.gateway,
        matched=pair,
        supply_step=out.supply_step,
        demand_step=out.demand_step,
        intransit=out.intransit,
        n_migrations=out.migrations[:, 0],
    )
    return res if batched else LBRound(*(t[0] for t in res))


def synchronize(gateway: Tensor, collected_total: Tensor,
                members: Tensor) -> Tensor:
    """Reset each node's power-differential prediction from a collected
    snapshot: the group's conserved total spread over members
    (``HandleCollectedState`` → ``Synchronize``,
    ``lb/LoadBalance.cpp:1160-1236``).  Returns the per-node "normal"
    (target gateway) the reference centers its next round on."""
    return collected_total / torch.clamp(members, min=1)


def run_rounds(
    net_generation,
    gateway0,
    group_mask,
    migration_step: float,
    n_rounds: int,
    malicious=None,
    device: DeviceLike = None,
    plain: bool = False,
):
    """Iterate LB rounds until (typically) convergence — every round in
    one B1 launch on the card.

    Returns the final gateway vector, the per-round migration counts
    ``[R]`` and states ``[R, N]`` (a leading fleet axis when the inputs
    had one) — the trajectory the reference's ``lax.scan`` produces.
    The group partition is loop-invariant: :func:`group_ids` runs once.
    """
    dev = resolve_device(device)
    batched, ng, gw, mask, mal = _inputs(dev, net_generation, gateway0,
                                         group_mask, malicious)
    gid = group_ids(mask)
    gid = (gid if gid.dim() == 2 else gid[None]).contiguous()
    fn = dk.lb_rounds_plain if plain else dk.lb_rounds
    out = fn(ng, gw, gid, migration_step, n_rounds, mal)
    if batched:
        return out.gateway, out.migrations, out.states
    return out.gateway[0], out.migrations[0], out.states[0]
