"""The fast-decoupled (XB scheme) matrices B′ and B″.

Port of ``DecoupledParts``/``decoupled_parts`` (``freedm_tpu/pf/fdlf.py:
44-91``), the part of the FDLF module that the sparse Newton backend's
preconditioner needs (:func:`freedm_tpu_torch.pf.krylov.build_fdlf_precond`).
The FDLF solver itself belongs to the N-1 slice.

Both matrices are stamped on the host in float64, in the reference's
``.at[].add`` order — (f, f), (t, t), (f, t), (t, f) — the same way
:func:`~freedm_tpu_torch.grid.bus.ybus_pair` stamps Ybus, and then moved
to the requested device and dtype.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from freedm_tpu_torch.device import DeviceLike, resolve_device
from freedm_tpu_torch.grid.bus import PQ, SLACK, BusSystem


class DecoupledParts(NamedTuple):
    """Masks and the functions that build B′ and B″."""

    th_free: torch.Tensor  # [n] 1.0 where θ is unknown
    v_free: torch.Tensor  # [n] 1.0 where V is unknown
    b_prime: Callable  # (status | None) -> [n, n]
    b_dblprime: Callable  # (Im Ybus [n, n], numpy or tensor) -> [n, n]


def _pin(m: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """Pinned rows and columns become identity (the reference's
    ``m * keep[:, None] * keep[None, :] + diag(1 - keep)``)."""
    m = m * keep[:, None] * keep[None, :]
    return m + np.diag(1.0 - keep)


def decoupled_parts(sys: BusSystem, dtype: torch.dtype = torch.float64,
                    device: DeviceLike = None) -> DecoupledParts:
    """The XB-scheme decoupled matrices of a bus system.

    B′ comes from series 1/x alone (r, shunts and taps dropped); B″ is
    −Im(Ybus) on the PQ block.  Pinned rows and columns (slack θ,
    PV/slack V) are identity.  Matrices come back as ``dtype`` tensors on
    ``device`` (``cuda`` unless the CPU is asked for).
    """
    dev = resolve_device(device)
    bus_type = np.asarray(sys.bus_type)
    th_keep = (bus_type != SLACK).astype(np.float64)
    v_keep = (bus_type == PQ).astype(np.float64)
    n = sys.n_bus
    inv_x = 1.0 / np.asarray(sys.x, np.float64)
    f = np.asarray(sys.from_bus)
    t = np.asarray(sys.to_bus)

    def to_dev(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    def b_prime(status=None) -> torch.Tensor:
        on = (np.ones(sys.n_branch) if status is None
              else np.asarray(status, np.float64))
        w = inv_x * on
        m = np.zeros((n, n))
        np.add.at(m, (f, f), w)
        np.add.at(m, (t, t), w)
        np.add.at(m, (f, t), -w)
        np.add.at(m, (t, f), -w)
        return to_dev(_pin(m, th_keep))

    def b_dblprime(y_im) -> torch.Tensor:
        if isinstance(y_im, torch.Tensor):
            y_im = y_im.detach().cpu().numpy()
        return to_dev(_pin(-np.asarray(y_im, np.float64), v_keep))

    return DecoupledParts(to_dev(th_keep), to_dev(v_keep), b_prime,
                          b_dblprime)
