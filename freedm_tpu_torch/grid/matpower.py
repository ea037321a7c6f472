"""MATPOWER case-file loader (port of ``freedm_tpu/grid/matpower.py``).

Parses the standard MATPOWER ``.m`` case format (``mpc.bus``,
``mpc.gen``, ``mpc.branch``, ``mpc.baseMVA`` matrices) into a
:class:`~freedm_tpu_torch.grid.bus.BusSystem`, so the IEEE 14/30/118-bus
benchmark cases (BASELINE.md configs #3-4) can be used when their case
files are available.  The reference has no equivalent — its only data
ingestion is the hard-coded feeder in
``Broker/src/vvc/load_system_data.cpp`` and the ASCII Armadillo matrix
``Broker/Dl_new.mat``.

Only the fields the power-flow needs are consumed:

- bus: BUS_I, BUS_TYPE, PD, QD, GS, BS, VM (cols 1, 2, 3, 4, 5, 6, 8)
- gen: GEN_BUS, PG, QG, VG, GEN_STATUS (cols 1, 2, 3, 6, 8)
- branch: F_BUS, T_BUS, BR_R, BR_X, BR_B, TAP, SHIFT, BR_STATUS
  (cols 1-5, 9, 10, 11)
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Union

import numpy as np

from freedm_tpu_torch.grid.bus import PQ, PV, SLACK, BusSystem

_MATRIX_RE = re.compile(
    r"mpc\.(?P<name>\w+)\s*=\s*\[(?P<body>.*?)\]\s*;", re.DOTALL
)
_SCALAR_RE = re.compile(r"mpc\.(?P<name>\w+)\s*=\s*(?P<val>[0-9.eE+-]+)\s*;")


def parse_case_text(text: str) -> Dict[str, np.ndarray]:
    """Extract mpc.* matrices/scalars from MATPOWER .m source."""
    # Strip MATLAB comments.
    text = re.sub(r"%.*", "", text)
    out: Dict[str, np.ndarray] = {}
    for m in _SCALAR_RE.finditer(text):
        out[m.group("name")] = np.float64(m.group("val"))
    for m in _MATRIX_RE.finditer(text):
        rows = []
        for line in m.group("body").split(";"):
            vals = line.replace(",", " ").split()
            if vals:
                rows.append([float(v) for v in vals])
        if rows:
            out[m.group("name")] = np.asarray(rows, dtype=np.float64)
    return out


def load_case(path: Union[str, Path]) -> BusSystem:
    """Load a MATPOWER .m case file into a :class:`BusSystem`."""
    return from_mpc(parse_case_text(Path(path).read_text()))


DATA_DIR = Path(__file__).parent / "data"


def builtin_case_names() -> tuple:
    """Names of the bundled IEEE cases (``grid/data/*.m``)."""
    return tuple(sorted(p.stem for p in DATA_DIR.glob("*.m")))


def _builtin_path(name: str) -> Path:
    path = DATA_DIR / f"{name}.m"
    if not path.exists():
        raise KeyError(f"no builtin case {name!r}; have {builtin_case_names()}")
    return path


def load_builtin(name: str) -> BusSystem:
    """Load a bundled IEEE case by name (e.g. ``case14``,
    ``case_ieee30``).

    These are the recognized public test systems BASELINE.md's meshed
    benchmarks anchor to.  IEEE 118-bus is NOT bundled: this build
    environment has no offline copy of its 186-branch dataset and
    fabricating one would be worse than absent — 118-bus-scale runs use
    :func:`freedm_tpu_torch.grid.cases.synthetic_mesh` and say so.
    """
    return load_case(_builtin_path(name))


def builtin_solved_state(name: str):
    """(vm, va_deg) columns of a bundled case's bus matrix.

    For ``case14`` these are the published solved operating point (the
    validation oracle); for cases whose file carries a flat start they
    are just that, and the caller should not treat them as a solution.
    """
    mpc = parse_case_text(_builtin_path(name).read_text())
    return mpc["bus"][:, 7].copy(), mpc["bus"][:, 8].copy()


def from_mpc(mpc: Dict[str, np.ndarray]) -> BusSystem:
    """Build a :class:`BusSystem` from parsed mpc matrices."""
    bus = mpc["bus"]
    branch = mpc["branch"]
    gen = mpc.get("gen")
    base_mva = float(mpc.get("baseMVA", 100.0))

    bus_ids = bus[:, 0].astype(np.int64)
    idx = {int(b): i for i, b in enumerate(bus_ids)}
    n = len(bus_ids)

    type_map = {1: PQ, 2: PV, 3: SLACK}
    bus_type = np.array([type_map.get(int(t), PQ) for t in bus[:, 1]], dtype=np.int64)

    # Injections: generation minus demand, pu.
    p_inj = -bus[:, 2] / base_mva
    q_inj = -bus[:, 3] / base_mva
    v_set = bus[:, 7].copy() if bus.shape[1] > 7 else np.ones(n)
    g_shunt = bus[:, 4] / base_mva
    b_shunt = bus[:, 5] / base_mva

    if gen is not None and gen.size:
        live_gen_buses = set()
        for row in gen:
            if gen.shape[1] > 7 and row[7] <= 0:
                continue  # out-of-service unit
            i = idx[int(row[0])]
            live_gen_buses.add(i)
            p_inj[i] += row[1] / base_mva
            q_inj[i] += row[2] / base_mva
            if bus_type[i] != PQ and row[5] > 0:
                v_set[i] = row[5]  # VG overrides bus VM at PV/slack buses
        # MATPOWER bustypes semantics: a PV bus with no in-service
        # generator has nothing to hold its voltage — treat it as PQ.
        for i in range(n):
            if bus_type[i] == PV and i not in live_gen_buses:
                bus_type[i] = PQ

    status = branch[:, 10] if branch.shape[1] > 10 else np.ones(len(branch))
    live = status > 0
    br = branch[live]
    tap = br[:, 8].copy() if br.shape[1] > 8 else np.ones(len(br))
    tap[tap == 0] = 1.0
    shift = np.deg2rad(br[:, 9]) if br.shape[1] > 9 else np.zeros(len(br))

    return BusSystem(
        bus_type=bus_type,
        p_inj=p_inj,
        q_inj=q_inj,
        v_set=v_set,
        g_shunt=g_shunt,
        b_shunt=b_shunt,
        from_bus=np.array([idx[int(b)] for b in br[:, 0]], dtype=np.int64),
        to_bus=np.array([idx[int(b)] for b in br[:, 1]], dtype=np.int64),
        r=br[:, 2].copy(),
        x=br[:, 3].copy(),
        b_chg=br[:, 4].copy(),
        tap=tap,
        shift=shift,
        base_mva=base_mva,
    ).validate()
