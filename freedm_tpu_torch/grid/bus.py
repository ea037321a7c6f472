"""Generic (meshed) bus/branch network model and Ybus assembly.

Port of ``freedm_tpu/grid/bus.py``.  A :class:`BusSystem` holds numpy
columns sized ``[n_bus]`` / ``[n_branch]`` with MATPOWER-standard branch
parameters.  The bus admittance matrix is stamped **on the host in
float64**, in the reference's stamp order and with its exact (re, im)
pair arithmetic, then moved to the requested device as a ``(re, im)``
pair of real tensors: deterministic, no atomics, and bit-identical to
the reference's eager ``ybus_dense`` on the same network.  The serve
path builds it once per engine (branch ``status`` is ``None`` there); a
per-lane ``status`` stamp on the card belongs to the N-1 slice.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from freedm_tpu_torch.device import DeviceLike, resolve_device

# Bus types (MATPOWER convention minus isolated).
PQ = 0
PV = 1
SLACK = 2

#: A complex quantity as a (re, im) pair of float64 numpy arrays.
Pair = Tuple[np.ndarray, np.ndarray]


@dataclass(frozen=True)
class BusSystem:
    """A positive-sequence bus/branch network, per unit on ``base_mva``."""

    # Buses ------------------------------------------------------------------
    bus_type: np.ndarray  # [n] int: PQ=0, PV=1, SLACK=2
    p_inj: np.ndarray  # [n] float: scheduled P injection (gen - load), pu
    q_inj: np.ndarray  # [n] float: scheduled Q injection at PQ buses, pu
    v_set: np.ndarray  # [n] float: voltage setpoint at PV/SLACK buses, pu
    g_shunt: np.ndarray  # [n] float: bus shunt conductance, pu
    b_shunt: np.ndarray  # [n] float: bus shunt susceptance, pu

    # Branches ---------------------------------------------------------------
    from_bus: np.ndarray  # [m] int
    to_bus: np.ndarray  # [m] int
    r: np.ndarray  # [m] float: series resistance, pu
    x: np.ndarray  # [m] float: series reactance, pu
    b_chg: np.ndarray  # [m] float: total line-charging susceptance, pu
    tap: np.ndarray  # [m] float: off-nominal tap ratio (1.0 = none)
    shift: np.ndarray  # [m] float: phase-shift angle, radians

    base_mva: float = 100.0

    @classmethod
    def from_arrays(cls, fields_: Dict[str, np.ndarray],
                    base_mva: Optional[float] = None) -> "BusSystem":
        """Build a system from a field dict — e.g. the JAX package's
        ``dataclasses.asdict(sys)`` — so both packages solve the
        identical network.  Unknown keys raise; ``base_mva`` defaults to
        the dict's own entry (100 when absent)."""
        names = [f.name for f in fields(cls) if f.name != "base_mva"]
        extra = set(fields_) - set(names) - {"base_mva"}
        if extra:
            raise ValueError(f"unknown BusSystem fields {sorted(extra)}")
        missing = [k for k in names if k not in fields_]
        if missing:
            raise ValueError(f"missing BusSystem fields {missing}")
        if base_mva is None:
            base_mva = float(fields_.get("base_mva", 100.0))
        return cls(**{k: np.array(fields_[k]) for k in names},
                   base_mva=float(base_mva)).validate()

    @property
    def n_bus(self) -> int:
        return int(self.bus_type.shape[0])

    @property
    def n_branch(self) -> int:
        return int(self.from_bus.shape[0])

    @property
    def slack(self) -> int:
        return int(np.argmax(self.bus_type == SLACK))

    def validate(self) -> "BusSystem":
        if np.sum(self.bus_type == SLACK) != 1:
            raise ValueError("exactly one slack bus required")
        n = self.n_bus
        for ends in (self.from_bus, self.to_bus):
            if ends.size and (ends.min() < 0 or ends.max() >= n):
                raise ValueError("branch endpoints out of range")
        if np.any(self.x == 0):
            raise ValueError("zero branch reactance")
        return self

    def with_injections(self, p_inj=None, q_inj=None) -> "BusSystem":
        kw = {}
        if p_inj is not None:
            kw["p_inj"] = np.asarray(p_inj)
        if q_inj is not None:
            kw["q_inj"] = np.asarray(q_inj)
        return replace(self, **kw)


# (re, im) pair arithmetic in the reference's operation order
# (freedm_tpu/utils/cplx.py ``C``), so the stamped values round alike.


def _div(a: Pair, b: Pair) -> Pair:
    d = b[0] * b[0] + b[1] * b[1]
    return (a[0] * b[0] + a[1] * b[1]) / d, (a[1] * b[0] - a[0] * b[1]) / d


def _add(a: Pair, b: Pair) -> Pair:
    return a[0] + b[0], a[1] + b[1]


def branch_admittances(sys: BusSystem, status=None) -> Tuple[Pair, Pair, Pair, Pair]:
    """Per-branch two-port admittance terms ``(yff, yft, ytf, ytt)`` as
    float64 (re, im) numpy pairs.

    Standard branch model (MATPOWER convention):

        Yff = (ys + j·b/2) / tap²     Yft = -ys / (tap·e^{-jθ})
        Ytf = -ys / (tap·e^{+jθ})     Ytt =  ys + j·b/2

    scaled by the 0/1 in-service ``status`` vector (all in service when
    ``None``).  Shared by :func:`ybus_dense` and
    :func:`freedm_tpu_torch.pf.newton.branch_flows`.
    """
    f64 = np.float64
    z = (np.asarray(sys.r, f64), np.asarray(sys.x, f64))
    ys = _div((np.ones_like(z[0]), np.zeros_like(z[0])), z)
    bc2 = (np.zeros_like(z[0]), np.asarray(sys.b_chg, f64) / 2.0)
    tap = np.asarray(sys.tap, f64)
    shift = np.asarray(sys.shift, f64)
    tap_shift = (tap * np.cos(shift), tap * np.sin(shift))  # tap·e^{jθ}
    on = (np.ones(sys.n_branch, f64) if status is None
          else np.asarray(status, f64))
    if on.shape != (sys.n_branch,):
        raise ValueError(
            f"status must be a length-{sys.n_branch} vector, got {on.shape}"
        )

    sh = _add(ys, bc2)
    tt = tap * tap
    yff = (sh[0] / tt * on, sh[1] / tt * on)
    ytt = (sh[0] * on, sh[1] * on)
    q = _div(ys, (tap_shift[0], -tap_shift[1]))
    yft = (-q[0] * on, -q[1] * on)
    q = _div(ys, tap_shift)
    ytf = (-q[0] * on, -q[1] * on)
    return yff, yft, ytf, ytt


def ybus_pair(sys: BusSystem, status=None) -> Pair:
    """The dense ``[n, n]`` bus admittance matrix as a float64 (re, im)
    numpy pair, stamped in the reference's order (ff, tt, ft, tf, then
    the shunt diagonal)."""
    n = sys.n_bus
    f = np.asarray(sys.from_bus)
    t = np.asarray(sys.to_bus)
    yff, yft, ytf, ytt = branch_admittances(sys, status=status)

    def stamp(yf, yt, yft_, ytf_):
        m = np.zeros((n, n), np.float64)
        np.add.at(m, (f, f), yf)
        np.add.at(m, (t, t), yt)
        np.add.at(m, (f, t), yft_)
        np.add.at(m, (t, f), ytf_)
        return m

    y_re = stamp(yff[0], ytt[0], yft[0], ytf[0])
    y_im = stamp(yff[1], ytt[1], yft[1], ytf[1])
    y_re = y_re + np.diag(np.asarray(sys.g_shunt, np.float64))
    y_im = y_im + np.diag(np.asarray(sys.b_shunt, np.float64))
    return y_re, y_im


def ybus_dense(sys: BusSystem, status=None, dtype: torch.dtype = torch.float64,
               device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense ``[n, n]`` bus admittance matrix as a ``(re, im)`` pair
    of ``dtype`` tensors on ``device`` (``cuda`` unless asked for the
    CPU)."""
    dev = resolve_device(device)
    y_re, y_im = ybus_pair(sys, status=status)
    return (torch.as_tensor(y_re, dtype=dtype, device=dev),
            torch.as_tensor(y_im, dtype=dtype, device=dev))
