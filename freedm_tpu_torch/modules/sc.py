"""State collection: consistent global snapshots.

Port of ``freedm_tpu/modules/sc.py``.  The reference's Chandy-Lamport
snapshot (``Broker/src/sc/StateCollection.cpp:9-23``) reduces, on a
synchronous step, to the step boundary itself (every node's signals at
the end of a superstep are a consistent cut) plus the group-masked
aggregation and the in-flight migration ledger LB keeps.

:func:`collect` is one ``torch.matmul`` of the group mask with the six
signals stacked as ``[N, 6]`` — a plain matrix product the reference
leaves to XLA's dot outside any kernel, so no hand kernel sits here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class CollectedState(NamedTuple):
    """Per-initiator aggregated snapshot (rows = each node's group view).

    Field names mirror ``CollectedStateMessage``
    (``StateCollection.proto:52-74``).
    """

    gateway: Tensor  # [N] Σ SST gateway over my group
    generation: Tensor  # [N] Σ DRER generation
    storage: Tensor  # [N] Σ DESD storage
    drain: Tensor  # [N] Σ Load drain
    state: Tensor  # [N] Σ FID state
    num_intransit_accepts: Tensor  # [N] Σ in-flight migration quanta
    members: Tensor  # [N] int32 group size (peers in the cut)


def collect(
    group_mask: Tensor,
    gateway: Tensor,
    generation: Tensor,
    storage: Tensor,
    drain: Tensor,
    fid_state: Tensor,
    intransit: Tensor,
) -> CollectedState:
    """Aggregate a consistent cut over each node's group.

    ``group_mask``: [N, N] 0/1 same-group indicator (row i = node i's
    view, from :func:`freedm_tpu_torch.modules.gm.form_groups`); signal
    tensors are [N], computed in ``gateway``'s dtype — the snapshot every
    node would get by initiating the reference protocol at once.
    """
    m = group_mask.to(gateway.dtype)
    signals = torch.stack([gateway, generation, storage, drain, fid_state,
                           intransit], dim=-1).to(gateway.dtype)
    sums = torch.matmul(m, signals)
    return CollectedState(
        *sums.unbind(-1),
        members=torch.sum(m, dim=-1).to(torch.int32),
    )


def invariant_total(cs: CollectedState) -> Tensor:
    """The conserved quantity LB synchronizes against: group gateway sum
    plus in-flight quanta (``HandleCollectedState`` → ``Synchronize``,
    ``lb/LoadBalance.cpp:1160-1236``)."""
    return cs.gateway + cs.num_intransit_accepts
