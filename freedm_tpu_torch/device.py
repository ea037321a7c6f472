"""Device policy: the card unless the caller asks for the CPU.

Every entry point of the port takes ``device=None`` and resolves it
here.  ``None`` means ``cuda``; when no CUDA device is present that is
an error, never a quiet run on the CPU.  Tests pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` when ``device`` is
    ``None``; raises ``RuntimeError`` if a CUDA device is asked for (or
    implied) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (have: cuda, cpu)")
    return dev


def platform_name(device: torch.device) -> str:
    """The reference's backend vocabulary for a device (``"gpu"`` for
    ``cuda``, ``"cpu"`` for ``cpu``) — what ``resolve_precision``'s
    ``"auto"`` keys on."""
    return {"cuda": "gpu", "cpu": "cpu"}[device.type]


def stream_synchronize(device: Optional[torch.device]) -> None:
    """Wait for the work queued on ``device``'s current stream (no-op on
    the CPU).  Work on other streams — the serving cache's delta program
    runs on one of its own — is not waited for."""
    if device is not None and device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
