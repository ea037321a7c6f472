"""Built-in grid cases (port of ``freedm_tpu/grid/cases.py``).

Only :func:`synthetic_mesh` is ported so far — the meshed
transmission-style generator behind the serve path's ``meshN`` tenants.
Its ``np.random.default_rng`` draws come in the reference's order, so
the arrays are bit-identical for every seed and size.  The radial
feeder builders wait for the feeder slice.
"""

from __future__ import annotations

import numpy as np

from freedm_tpu_torch.grid.bus import PQ, PV, SLACK, BusSystem


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
