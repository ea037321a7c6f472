"""Built-in grid cases (port of ``freedm_tpu/grid/cases.py``).

- :func:`vvc_9bus` — the reference VVC module's own 9-node, 8-branch
  3-phase feeder, with its line-code library :data:`Z_CODES_9BUS`;
- :func:`default_z_codes` — the generic overhead-line library for Dl
  tables that carry line-code indices only;
- :func:`synthetic_radial` — the radial feeder generator (the 10k-bus
  ladder configuration);
- :func:`synthetic_mesh` — the meshed transmission-style generator
  behind the serve path's ``meshN`` tenants.

The generators draw from ``np.random.default_rng`` in the reference's
order, so the arrays are bit-identical for every seed and size.
"""

from __future__ import annotations

import numpy as np

from freedm_tpu_torch.grid.bus import PQ, PV, SLACK, BusSystem
from freedm_tpu_torch.grid.feeder import Feeder, from_branch_table

# Line-code library of the reference 9-bus feeder
# (load_system_data.cpp:44-58): code 1 = 3-phase feeder line, code 2 =
# substation transformer (decoupled phases).  Ohms per unit length.
_FEEDER_R = 2.56769666666667
_FEEDER_RM = 1.02707866666667
_FEEDER_X = 7.41305
_FEEDER_XM = 2.96522
_XFMR_R = 0.8293381333333333
_XFMR_X = 3.7320216

Z_CODES_9BUS = np.stack(
    [
        np.full((3, 3), _FEEDER_RM + 1j * _FEEDER_XM)
        + np.eye(3) * ((_FEEDER_R - _FEEDER_RM) + 1j * (_FEEDER_X - _FEEDER_XM)),
        np.eye(3) * (_XFMR_R + 1j * _XFMR_X),
    ]
)


def vvc_9bus(rpv: float = 1.0) -> Feeder:
    """The reference's in-tree VVC feeder.

    Topology: substation —(xfmr)→ 1 → 2 → 3 → 4 → 5 on the main, with a
    lateral 1 → 6 → 7 → 8.  Balanced constant-power loads scaled by ``rpv``
    (the reference's PV scaling knob ``Rpv``, ``load_system_data.cpp:9``);
    negative loads are distributed generation.
    """
    loads = {  # node -> per-phase kW (balanced, Q = 0)
        2: 80.0 * rpv,
        3: -100.0 / 3.0 * rpv,
        4: 220.0 / 3.0 * rpv,
        5: 50.0 * rpv,
        6: 260.0 / 3.0 * rpv,
        7: -80.0 / 3.0 * rpv,
        8: 75.0 * rpv,
    }
    edges = [  # (from, to, line_code)
        (0, 1, 2),
        (1, 2, 1),
        (2, 3, 1),
        (3, 4, 1),
        (4, 5, 1),
        (1, 6, 1),
        (6, 7, 1),
        (7, 8, 1),
    ]
    dl = np.zeros((len(edges), 13))
    for i, (f, t, code) in enumerate(edges):
        p = loads.get(t, 0.0)
        dl[i] = [i + 1, f, t, code, 1.0, 1, p, 0, p, 0, p, 0, 0]
    return from_branch_table(dl, Z_CODES_9BUS, base_kva=1000.0, base_kv=12.47, v_source_pu=1.015)


def default_z_codes(n: int) -> np.ndarray:
    """A generic n-entry line-code library (ohms/unit-length).

    Entry k scales a typical 12.47 kV overhead 3-phase geometry; used when a
    Dl table arrives without its impedance library.
    """
    base = np.full((3, 3), 0.2 + 1j * 0.6) + np.eye(3) * (0.3 + 1j * 0.8)
    scale = 0.4 + 0.12 * np.arange(1, n + 1)
    return base[None] * scale[:, None, None]


def synthetic_radial(
    n_bus: int,
    seed: int = 0,
    lateral_prob: float = 0.3,
    load_kw: float = 50.0,
    pv_frac: float = 0.2,
    base_kva: float = 10000.0,
    base_kv: float = 12.47,
) -> Feeder:
    """Random radial feeder with ``n_bus`` non-substation nodes.

    Trunk-with-laterals topology: each new node attaches to the previous
    node with probability ``1 - lateral_prob`` (extending a feeder run) or
    to a uniformly random earlier node (starting/extending a lateral).
    Loads are lognormal around ``load_kw`` with a ``pv_frac`` fraction of
    nodes flipped to generation.  This is the scale-out case of
    BASELINE.md (synthetic 10k-bus grid).
    """
    rng = np.random.default_rng(seed)
    nb = int(n_bus)
    dl = np.zeros((nb, 13))
    for i in range(nb):
        node = i + 1
        if i == 0:
            src = 0
        elif rng.uniform() > lateral_prob:
            src = node - 1
        else:
            src = int(rng.integers(0, node - 1))
        p = rng.lognormal(mean=0.0, sigma=0.5) * load_kw
        if rng.uniform() < pv_frac:
            p = -p
        q = p * rng.uniform(0.1, 0.4)
        length = rng.uniform(0.05, 0.5)
        dl[i] = [node, src, node, 1, length, 1, p, q, p, q, p, q, 0]
    z_codes = default_z_codes(1)
    return from_branch_table(dl, z_codes, base_kva=base_kva, base_kv=base_kv, v_source_pu=1.02)



def synthetic_mesh(
    n_bus: int,
    seed: int = 0,
    chord_frac: float = 0.3,
    pv_frac: float = 0.2,
    load_mw: float = 40.0,
    base_mva: float = 100.0,
) -> BusSystem:
    """Random meshed transmission network with a feasible operating point.

    Ring backbone over all buses plus ``chord_frac * n_bus`` random
    chords; one slack (bus 0), ``pv_frac`` PV buses with dispatched
    generation balancing the PQ load to a lossless first order (NR picks
    up the losses at the slack).  Impedances are typical 230 kV line
    values; loads are lognormal around ``load_mw``.
    """
    rng = np.random.default_rng(seed)
    n = int(n_bus)
    # Ring backbone edges + chords.
    f = list(range(n))
    t = [(i + 1) % n for i in range(n)]
    n_chord = int(chord_frac * n)
    for _ in range(n_chord):
        a, b = rng.integers(0, n, size=2)
        if a != b:
            f.append(int(a))
            t.append(int(b))
    m = len(f)
    r = rng.uniform(0.01, 0.03, m)
    x = rng.uniform(0.05, 0.15, m)
    b_chg = rng.uniform(0.0, 0.04, m)

    bus_type = np.full(n, PQ, dtype=np.int64)
    bus_type[0] = SLACK
    n_pv = max(1, int(pv_frac * n))
    pv_buses = rng.choice(np.arange(1, n), size=min(n_pv, n - 1), replace=False)
    bus_type[pv_buses] = PV

    load = rng.lognormal(0.0, 0.4, n) * load_mw / base_mva
    load[bus_type != PQ] = 0.0
    p_inj = -load
    total_load = load.sum()
    gen_share = rng.uniform(0.5, 1.5, len(pv_buses))
    p_inj[pv_buses] = total_load * gen_share / gen_share.sum()
    q_inj = -load * rng.uniform(0.1, 0.4, n)

    v_set = np.ones(n)
    v_set[bus_type != PQ] = rng.uniform(1.0, 1.05, np.sum(bus_type != PQ))

    return BusSystem(
        bus_type=bus_type,
        p_inj=p_inj,
        q_inj=q_inj,
        v_set=v_set,
        g_shunt=np.zeros(n),
        b_shunt=np.zeros(n),
        from_bus=np.array(f, dtype=np.int64),
        to_bus=np.array(t, dtype=np.int64),
        r=r,
        x=x,
        b_chg=b_chg,
        tap=np.ones(m),
        shift=np.zeros(m),
        base_mva=base_mva,
    ).validate()
