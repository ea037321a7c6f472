"""Group management: membership and leader election.

Port of ``freedm_tpu/modules/gm.py``.  The reference's Garcia-Molina
invitation election (``Broker/src/gm/GroupManagement.hpp:44``) collapses
to one call over every node: groups are the connected components of the
alive-masked reachability graph, and each group's coordinator is its
highest-priority member (priority = salted hash of the node id, the
reference's string-hash priority, ``GroupManagement.cpp:653-679``).

On the card :func:`form_groups` is G1 ``form_groups``
(:mod:`freedm_tpu_torch.kernels.dgi_kernels`): one launch over every lane,
the adjacency packed one bit an entry and its labels driven to the
fixed point the reference's ``ceil(log2 N) + 1`` rounds of label
propagation and adjacency squaring reach.  The priority's rank
compression stays two stable argsorts.  On the CPU (and with
``plain=True``) the reference's rounds run as written.

Outputs mirror what the reference pushes to every module via
``PeerListMessage`` (``ProcessPeerList``, ``GroupManagement.cpp:895-936``):
per-node coordinator index and same-group membership mask, plus the
counters GM keeps for its ``SystemState()`` table
(``GroupManagement.hpp:184-195``), from diffing successive states.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from freedm_tpu_torch.device import DeviceLike, resolve_device
from freedm_tpu_torch.kernels import dgi_kernels as dk

Tensor = torch.Tensor


class GroupState(NamedTuple):
    """Per-node group view (``[N]`` or ``[N, N]``; a leading lane axis
    when ``alive`` had one)."""

    coordinator: Tensor  # [N] int32: node index of my group's leader (-1 if dead)
    group_mask: Tensor  # [N, N] float32 0/1: j in my group (row i = my view)
    is_coordinator: Tensor  # [N] bool
    group_size: Tensor  # [N] int32: members in my group
    n_groups: Tensor  # [] int32: live groups in the system


def node_priority(n_nodes: int, salt: int = 0x9E3779B9) -> np.ndarray:
    """Election priority per node — a salted integer hash, matching the
    reference's "priority = hash of UUID" (GroupManagement.cpp:653-679).

    Deterministic, collision-free for any n (a bijective mix of the node
    index), and host-computable so tests can predict leaders; ranked to a
    permutation of 1..n.
    """
    idx = np.arange(n_nodes, dtype=np.uint32)
    x = (idx + np.uint32(salt)) * np.uint32(2654435761)
    x ^= x >> np.uint32(16)
    x = x * np.uint32(2246822519)
    x ^= x >> np.uint32(13)
    rank = np.argsort(np.argsort(x, kind="stable"), kind="stable")
    return (rank + 1).astype(np.int32)


def _rank(priority: Tensor) -> Tensor:
    """Rank-compress to 1..N so labels stay exact whatever the caller
    supplied; the stable argsort breaks ties by node index."""
    return (torch.argsort(torch.argsort(priority, stable=True), stable=True)
            + 1).to(torch.int32)


@functools.lru_cache(maxsize=8)
def _default_rank(n: int, device: torch.device) -> Tensor:
    """The rank of :func:`node_priority` on ``device`` — the same every
    round of a fleet, so it is made once (read-only)."""
    return _rank(torch.as_tensor(node_priority(n), device=device))


def form_groups(
    alive,
    reachable,
    priority=None,
    device: DeviceLike = None,
    plain: bool = False,
) -> GroupState:
    """Form groups and elect coordinators — one call (one G1 launch).

    ``alive``: ``[N]`` (or ``[B, N]`` lanes) 0/1 node health mask; a value
    of 0.5 or more is alive.  ``reachable``: ``[N, N]`` (or ``[B, N, N]``)
    0/1 symmetric comm/physical reachability (e.g. from
    :func:`freedm_tpu_torch.grid.topology.node_reachability`); the
    diagonal is implied, dead rows and columns are masked out.
    ``priority``: ``[N]`` election priority (default
    :func:`node_priority`), any magnitude — raw UUID hashes included —
    rank-compressed to 1..N, ties broken by node index.  ``device`` is
    ``cuda`` unless the caller asks for the CPU; ``plain=True`` runs G1's
    plain version on any device.
    """
    dev = resolve_device(device)
    alive_t = torch.as_tensor(alive, device=dev)
    batched = alive_t.dim() == 2
    lanes = alive_t if batched else alive_t[None]
    n = int(lanes.shape[-1])
    rank = (_default_rank(n, dev) if priority is None
            else _rank(torch.as_tensor(priority, device=dev)))
    reach = torch.as_tensor(reachable, dtype=torch.float32, device=dev)
    reach = (reach if reach.dim() == 3 else reach[None]).contiguous()
    alive_b = (lanes.to(torch.float32) >= 0.5).contiguous()
    fn = dk.form_groups_plain if plain else dk.form_groups
    out = fn(alive_b, reach, rank)
    if not batched:
        out = dk.GroupLanes(*(t[0] for t in out))
    return GroupState(*out)


class GroupCounters(NamedTuple):
    """Event counters between two group states — the statistics GM keeps
    for its ``SystemState()`` table (``GroupManagement.hpp:184-195``)."""

    groups_formed: Tensor  # [] int32: nodes whose coordinator changed
    groups_broken: Tensor  # [] int32: pairs that lost same-group status
    elections: Tensor  # [] int32: coordinators that changed identity


def diff_counters(prev: GroupState, new: GroupState) -> GroupCounters:
    """Counters between two group states (torch reductions)."""
    i32 = torch.int32
    changed = torch.sum((prev.coordinator != new.coordinator)
                        & (new.coordinator >= 0)).to(i32)
    broken = torch.sum((prev.group_mask > 0) & (new.group_mask == 0)).to(i32)
    elections = torch.sum(new.is_coordinator & ~prev.is_coordinator).to(i32)
    return GroupCounters(changed, broken, elections)
