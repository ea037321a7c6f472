"""The device tensor: fleet state and commands as padded tensors with masks.

Port of ``freedm_tpu/devices/tensor.py``.  The reference's per-object
device registry (``CDeviceManager``, ``Broker/src/device/
CDeviceManager.hpp:66-76``) becomes

    state   [capacity, n_signals]  float
    command [capacity, n_signals]  float (NULL_COMMAND = "no command")
    type_id [capacity]             int32 (row's device class, -1 empty)
    alive   [capacity]             0/1   (plug-and-play slots)

and ``CDeviceManager::GetNetValue`` (``CDeviceManager.cpp:296-312``) a
masked reduction.  Every function also takes leading node axes
(``state [N, cap, ns]``, ``type_id``/``alive [N, cap]``): the fleet-wide
reads the reference makes under ``vmap`` are one call here — the
superstep's ``netgen`` and ``gateway`` come from :func:`net_value` over a
node axis.  Masked reductions in PyTorch; no kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from freedm_tpu_torch.core.config import NULL_COMMAND
from freedm_tpu_torch.device import DeviceLike, resolve_device
from freedm_tpu_torch.devices.schema import SignalLayout

Tensor = torch.Tensor


class DeviceTensor(NamedTuple):
    """Fleet snapshot (leading node axes allowed)."""

    state: Tensor  # [..., cap, ns]
    command: Tensor  # [..., cap, ns], NULL_COMMAND where unset
    type_id: Tensor  # [..., cap] int32 (-1 for empty slots)
    alive: Tensor  # [..., cap] float 0/1

    @property
    def capacity(self) -> int:
        return self.state.shape[-2]


def empty(layout: SignalLayout, capacity: int, dtype=torch.float32,
          device: DeviceLike = None) -> DeviceTensor:
    dev = resolve_device(device)
    ns = layout.n_signals
    return DeviceTensor(
        state=torch.zeros(capacity, ns, dtype=dtype, device=dev),
        command=torch.full((capacity, ns), NULL_COMMAND, dtype=dtype,
                           device=dev),
        type_id=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
        alive=torch.zeros(capacity, dtype=dtype, device=dev),
    )


def type_mask(t: DeviceTensor, type_id: int) -> Tensor:
    """``[..., cap]`` 0/1: live rows of the given device class."""
    return torch.where(t.type_id == type_id, t.alive,
                       torch.zeros((), dtype=t.alive.dtype,
                                   device=t.alive.device))


def net_value(t: DeviceTensor, type_id: int, signal_idx: int) -> Tensor:
    """Sum a signal over live devices of a type, per node when the tensor
    has a node axis (``[N, cap, ns]`` → ``[N]``).

    Reference: ``CDeviceManager::GetNetValue`` — e.g. net DRER generation
    or net Load drain feeding the LB SUPPLY/DEMAND decision
    (``lb/LoadBalance.cpp:382-402``).
    """
    return torch.sum(t.state[..., signal_idx] * type_mask(t, type_id), dim=-1)


def count_devices(t: DeviceTensor, type_id: int) -> Tensor:
    """Live-device count of a type (``CDeviceManager::DeviceCount``)."""
    return torch.sum(type_mask(t, type_id), dim=-1).to(torch.int32)


def set_commands(
    t: DeviceTensor,
    type_id: int,
    signal_idx: int,
    values,
    rows: Optional[Tensor] = None,
) -> DeviceTensor:
    """Write a command signal on live devices of a type.

    ``values`` is scalar or ``[cap]``; ``rows`` optionally restricts to a
    0/1 row mask.  Dead or non-matching rows keep their previous command.
    Returns a new tensor; ``t`` is not changed.
    """
    sel = type_mask(t, type_id)
    if rows is not None:
        sel = sel * rows
    col = t.command[..., signal_idx]
    values = torch.as_tensor(values, dtype=col.dtype, device=col.device)
    command = t.command.clone()
    command[..., signal_idx] = torch.where(sel > 0, values, col)
    return t._replace(command=command)


def clear_commands(t: DeviceTensor) -> DeviceTensor:
    """Reset all commands to NULL_COMMAND (start of a scheduler round)."""
    return t._replace(command=torch.full_like(t.command, NULL_COMMAND))


def commanded(t: DeviceTensor) -> Tensor:
    """``[..., cap, ns]`` 0/1: entries holding a real command (not NULL)."""
    return (torch.abs(t.command - NULL_COMMAND) > 0.5).to(t.command.dtype)


def from_host(
    layout: SignalLayout,
    capacity: int,
    type_names,
    states: np.ndarray,
    dtype=torch.float32,
    device: DeviceLike = None,
) -> DeviceTensor:
    """Build a padded tensor from host rows (one per device, in order)."""
    n = len(type_names)
    if n > capacity:
        raise ValueError(f"{n} devices exceed capacity {capacity}")
    t = empty(layout, capacity, dtype, device)
    tid = np.full(capacity, -1, np.int32)
    alive = np.zeros(capacity, np.float64)
    st = np.zeros((capacity, layout.n_signals), np.float64)
    for i, name in enumerate(type_names):
        tid[i] = layout.type_ids[name]
        alive[i] = 1.0
        st[i] = states[i]
    dev = t.state.device
    return t._replace(
        state=torch.as_tensor(st, dtype=dtype, device=dev),
        type_id=torch.as_tensor(tid, device=dev),
        alive=torch.as_tensor(alive, dtype=dtype, device=dev),
    )
