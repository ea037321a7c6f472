"""Grid-edge agent populations: stateful device agents that drive QSTS
studies closed-loop.

Port of ``freedm_tpu/scenarios/agents.py``.  The host half — the spec,
its validation with the reference's messages, the parameter records and
:func:`build_population` / :func:`dr_signal` — is copied array for
array: one seed gives the same bytes in both packages.  The device half
is plain PyTorch with the lane axis written out (state ``[S, n_kind]``,
observed voltages ``[S, n]``, the DR signal ``[S]``, a scalar hour):
the per-kind steps below, and :func:`population_step`, which runs them
through the agent-step kernel A1's wrapper
(:func:`freedm_tpu_torch.kernels.qsts_kernels.agent_step`) — on the CPU
its plain version, on the card the kernel.  The per-bus sums are
segmented sums over each kind's agents sorted by bus (a stable sort, so
a bus's agents keep their increasing index), never ``index_add_``, which
is atomic and order-nondeterministic on the card.

The profile generators (:mod:`freedm_tpu_torch.scenarios.profiles`)
replay *statistical* diversity fixed before the first solve; agents add
a demand side whose injections REACT to the voltages the solver produced
one timestep earlier, stepped inside the QSTS chunk loop on the card.

Agent kinds (:data:`AGENT_KINDS`), each a pure per-agent
``step(state, obs, t) -> (state', p_inj, q_inj)`` in per-unit on the
system base, summed per bus:

- ``ev`` — charging sessions: an arrival/departure window (wrapping
  past midnight) with an SoC state machine; charging power droops
  linearly to zero between :data:`EV_V_FULL` and :data:`EV_V_MIN` pu,
  so undervoltage sheds EV load (closed-loop).  Outside the session
  the SoC re-arms to its arrival value (the next day's session).
- ``thermostat`` — cooling duty cycles: a first-order thermal-mass ODE
  (exact exponential step) against a sinusoidal ambient, switched by a
  deadband hysteresis around the setpoint.
- ``inverter`` — smart-inverter Volt-VAR: the IEEE-1547-shaped
  piecewise q(v) curve evaluated at the agent's *solved* bus voltage
  from the previous step, tracked through a first-order response lag.
  This is the kind that makes closed-loop vs replayed diverge by
  construction: at the replayed flat 1.0 pu observation the curve's
  deadband yields q = 0 everywhere.
- ``dr`` — demand response: broadcast curtailment events (drawn per
  scenario at construction) with per-agent compliance; engagement
  ramps with a short time constant rather than stepping.

Determinism: every random quantity — siting, parameters, event windows,
initial state — is drawn ONCE in :func:`build_population`, in a fixed
order, from the :func:`freedm_tpu_torch.scenarios.profiles.population_rng`
seam, which derives from the SAME study seed as the profile draws.
Stepping is a pure function of ``(state, obs, t)``; agent state rides
the chunk carry and the chunk checkpoint (in the reference's agent
order), so kill/resume is bit for bit with agents as without them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from freedm_tpu_torch.scenarios.profiles import ProfileSet, population_rng

AGENT_KINDS = ("ev", "thermostat", "inverter", "dr")

#: EV charging-power voltage droop: full rate at/above ``EV_V_FULL``,
#: zero at/below ``EV_V_MIN`` (linear between) — undervoltage load relief.
EV_V_MIN = 0.88
EV_V_FULL = 0.94

#: Thermostat ambient model: mean + swing * cos peaking at 15:00.
AMB_MEAN_C = 24.0
AMB_SWING_C = 8.0
AMB_PEAK_H = 15.0

#: Demand-response engagement time constant (hours) — compliant agents
#: ramp into/out of a curtailment event rather than stepping.
DR_TAU_H = 0.25

#: Bound on per-request curtailment events per scenario-day.
MAX_DR_EVENTS = 8

#: Residential-bus siting bias for EV / thermostat agents (relative
#: weight vs a commercial bus of equal load).
_RESIDENTIAL_BIAS = 3.0


@dataclass(frozen=True)
class AgentSpec:
    """One agent population: per-kind counts + behaviour knobs.

    Part of the study's checkpoint identity (it rides
    ``StudySpec.to_dict``): a resubmission with a different population
    does not match the old checkpoint and restarts clean.

    Aggregate sizing is *fractional*: each kind's total capacity is the
    given fraction of the case's total base load, split over its agents
    (with per-agent jitter) — so a million-agent population loads the
    case exactly as hard as a hundred-agent one.
    """

    ev: int = 0
    thermostat: int = 0
    inverter: int = 0
    dr: int = 0
    #: Aggregate EV charger capacity as a fraction of total base load.
    ev_frac: float = 0.08
    #: Aggregate thermostat (cooling) power as a fraction of base load.
    therm_frac: float = 0.10
    #: Aggregate inverter Volt-VAR capability (qmax) as a fraction.
    inv_frac: float = 0.08
    #: Aggregate flexible (curtailable) load as a fraction of base load.
    dr_frac: float = 0.10
    #: Curtailment depth on a fully-engaged compliant agent, [0, 1].
    dr_depth: float = 0.5
    #: Broadcast curtailment events per scenario-day.
    dr_events: int = 2
    #: False = replayed mode: agents observe a flat 1.0 pu voltage
    #: instead of the previous step's solved voltage (the open-loop
    #: baseline the bench's closed-vs-replayed deltas quantify).
    closed_loop: bool = True

    def total(self) -> int:
        return int(self.ev) + int(self.thermostat) + \
            int(self.inverter) + int(self.dr)


def validate_agent_spec(spec: AgentSpec) -> None:
    """Range-check an :class:`AgentSpec` (ValueError on violation) —
    the engine-side twin of the jobs API's typed validation."""
    for k in ("ev", "thermostat", "inverter", "dr", "dr_events"):
        v = getattr(spec, k)
        if isinstance(v, bool) or not isinstance(v, int) or v < 0:
            raise ValueError(f"agents.{k} must be a non-negative integer")
    if spec.total() < 1:
        raise ValueError("agent population is empty: at least one of "
                         "ev/thermostat/inverter/dr must be positive")
    if spec.dr_events > MAX_DR_EVENTS:
        raise ValueError(
            f"agents.dr_events must be <= {MAX_DR_EVENTS}")
    for k in ("ev_frac", "therm_frac", "inv_frac", "dr_frac", "dr_depth"):
        v = getattr(spec, k)
        if isinstance(v, bool) or not isinstance(v, (int, float)) \
                or not math.isfinite(v) or not 0.0 <= v <= 1.0:
            raise ValueError(f"agents.{k} must be a number in [0, 1]")
    if not isinstance(spec.closed_loop, bool):
        raise ValueError("agents.closed_loop must be a boolean")


_AGENT_FIELDS = {
    "ev", "thermostat", "inverter", "dr",
    "ev_frac", "therm_frac", "inv_frac", "dr_frac",
    "dr_depth", "dr_events", "closed_loop",
}


def parse_agents_field(payload, scenarios: int, max_agents: int,
                       max_cells: int) -> AgentSpec:
    """``AgentSpec`` from the jobs API's ``agents`` request field, every
    key range-checked with typed errors (jobs-layer twin of
    :func:`validate_agent_spec`).  ``max_agents`` bounds the population,
    ``max_cells`` bounds ``scenarios * agents`` — the agent-state lane
    cells the chunk carry materializes (the ``--qsts-agents-*`` keys).
    """
    from freedm_tpu_torch.serve.queue import InvalidRequest

    if not isinstance(payload, dict):
        raise InvalidRequest("'agents' must be a JSON object")
    unknown = set(payload) - _AGENT_FIELDS
    if unknown:
        raise InvalidRequest(
            f"unknown field(s) {sorted(unknown)} for agents")
    try:
        spec = AgentSpec(**payload)
        validate_agent_spec(spec)
    except TypeError as e:
        raise InvalidRequest(f"bad agents spec: {e}") from None
    except ValueError as e:
        raise InvalidRequest(str(e)) from None
    total = spec.total()
    if total > max_agents:
        raise InvalidRequest(
            f"agent population {total} exceeds the {max_agents} "
            f"qsts_agents_max ceiling")
    if scenarios * total > max_cells:
        raise InvalidRequest(
            f"scenarios x agents = {scenarios * total} exceeds the "
            f"{max_cells} qsts_agents_cells_max ceiling; lower "
            f"'scenarios' or the population")
    return spec


# -- struct-of-arrays population (all numpy, built once) --------------------
class EvParams(NamedTuple):
    """Per-agent EV session parameters, [n_ev] each."""

    bus: np.ndarray       # int32 site
    arr_h: np.ndarray     # session arrival, hour of day
    dep_h: np.ndarray     # session departure (may wrap past midnight)
    rate_pu: np.ndarray   # charger rating
    cap_puh: np.ndarray   # battery capacity, pu·h
    soc0: np.ndarray      # state of charge at arrival, [0, 1]


class ThermostatParams(NamedTuple):
    """Per-agent thermostat parameters, [n_th] each."""

    bus: np.ndarray       # int32 site
    amb_off_c: np.ndarray  # ambient offset (micro-climate + building)
    tau_h: np.ndarray     # thermal time constant, hours
    gain_c: np.ndarray    # steady-state cooling depth when on, deg C
    set_c: np.ndarray     # setpoint
    db_c: np.ndarray      # hysteresis deadband width
    p_pu: np.ndarray      # electrical draw while on


class InverterParams(NamedTuple):
    """Per-agent Volt-VAR curve, [n_inv] each (v1<v2<=v3<v4)."""

    bus: np.ndarray       # int32 site (PV buses)
    v1: np.ndarray
    v2: np.ndarray
    v3: np.ndarray
    v4: np.ndarray
    qmax_pu: np.ndarray   # reactive capability
    tau_h: np.ndarray     # first-order response lag, hours


class DrParams(NamedTuple):
    """Per-agent demand-response parameters, [n_dr] each."""

    bus: np.ndarray       # int32 site
    p_pu: np.ndarray      # flexible load block
    comply: np.ndarray    # 0/1 participates in broadcast events
    depth: np.ndarray     # curtailment depth when fully engaged


class DrEvents(NamedTuple):
    """Per-scenario broadcast curtailment windows, [S, E] each."""

    start_h: np.ndarray
    dur_h: np.ndarray


class Population(NamedTuple):
    """The full struct-of-arrays population (numpy at rest; the engine
    puts it on device once and feeds it to the chunk program as a
    non-donated runtime argument)."""

    ev: EvParams
    th: ThermostatParams
    inv: InverterParams
    dr: DrParams


class AgentState(NamedTuple):
    """Per-agent dynamic state for one scenario lane ([n_kind] each;
    the engine broadcasts to [S, n_kind] and carries it in the chunk
    scan alongside the solver's warm-start point)."""

    ev_soc: np.ndarray    # EV state of charge, [0, 1]
    th_temp: np.ndarray   # thermostat indoor temperature, deg C
    th_on: np.ndarray     # thermostat relay (0.0 / 1.0)
    inv_q: np.ndarray     # inverter reactive output, pu
    dr_eng: np.ndarray    # DR engagement level, [0, 1]


def _site_weights(load: np.ndarray, residential: Optional[np.ndarray],
                  cap: Optional[np.ndarray]) -> np.ndarray:
    """Normalized siting probabilities over buses: proportional to base
    load (or ``cap`` for inverters), optionally biased toward the
    profile set's residential buses.  Degenerate cases fall back to
    uniform so tiny synthetic cases still site agents."""
    if cap is not None and float(cap.sum()) > 0.0:
        w = cap.astype(np.float64).copy()
    else:
        w = load.astype(np.float64).copy()
        if residential is not None:
            w = w * np.where(residential, _RESIDENTIAL_BIAS, 1.0)
    if float(w.sum()) <= 0.0:
        w = np.ones_like(w)
    return w / w.sum()


def build_population(
    spec: AgentSpec, profiles: ProfileSet, p0: np.ndarray,
) -> Tuple[Population, AgentState, DrEvents]:
    """All random draws for one agent population, fixed at construction.

    Draw order is part of the determinism contract — NEVER reorder or
    make a draw conditional on anything but the spec (zero-count kinds
    still draw their size-0 arrays).  Randomness comes from the
    :func:`~freedm_tpu_torch.scenarios.profiles.population_rng` seam — the
    profile seed drives it, and the per-bus diversity draws the profile
    set already made (``pv_cap``, ``bus_residential``, ``bus_jitter_h``)
    steer siting and micro-climate, so one seed yields one byte-exact
    (profiles, agents) world under any chunking.

    ``p0`` is the case's base real-power injection [nb] (loads
    negative); aggregate agent capacity is sized from it.
    """
    validate_agent_spec(spec)
    nb = profiles.n_bus
    load = np.abs(np.minimum(np.asarray(p0, np.float64), 0.0))
    total_load = float(load.sum())
    if total_load <= 0.0:
        total_load = 1.0
    rng = population_rng(profiles.spec.seed, "agents")
    res = profiles.bus_residential

    # -- EV charging sessions ------------------------------------------------
    n = int(spec.ev)
    per = spec.ev_frac * total_load / max(n, 1)
    ev_bus = rng.choice(
        nb, size=n, p=_site_weights(load, res, None)).astype(np.int32)
    ev_arr = np.mod(rng.normal(18.0, 1.5, n), 24.0)
    ev_dep = np.mod(ev_arr + rng.uniform(6.0, 10.0, n), 24.0)
    ev_rate = per * rng.uniform(0.7, 1.3, n)
    ev_cap = ev_rate * rng.uniform(4.0, 8.0, n)
    ev_soc0 = rng.uniform(0.2, 0.6, n)
    ev = EvParams(bus=ev_bus, arr_h=ev_arr, dep_h=ev_dep,
                  rate_pu=ev_rate, cap_puh=ev_cap, soc0=ev_soc0)

    # -- thermostat duty cycles ----------------------------------------------
    n = int(spec.thermostat)
    per = spec.therm_frac * total_load / max(n, 1)
    th_bus = rng.choice(
        nb, size=n, p=_site_weights(load, res, None)).astype(np.int32)
    # Micro-climate: the profile set's per-bus diversity jitter plus a
    # per-building draw.
    th_amb = 2.0 * profiles.bus_jitter_h[th_bus] + rng.normal(0.0, 1.0, n)
    th_tau = rng.uniform(2.0, 4.0, n)
    th_gain = rng.uniform(9.0, 14.0, n)
    th_set = rng.uniform(21.0, 24.0, n)
    th_db = rng.uniform(0.8, 1.5, n)
    th_p = per * rng.uniform(0.7, 1.3, n)
    th_temp0 = th_set + rng.uniform(-0.5, 0.5, n) * th_db
    th = ThermostatParams(bus=th_bus, amb_off_c=th_amb, tau_h=th_tau,
                          gain_c=th_gain, set_c=th_set, db_c=th_db,
                          p_pu=th_p)

    # -- smart-inverter Volt-VAR ---------------------------------------------
    n = int(spec.inverter)
    per = spec.inv_frac * total_load / max(n, 1)
    inv_bus = rng.choice(
        nb, size=n, p=_site_weights(load, None, profiles.pv_cap),
    ).astype(np.int32)
    dv = rng.uniform(-0.01, 0.01, n)
    inv_qmax = per * rng.uniform(0.7, 1.3, n)
    inv_tau = rng.uniform(0.1, 0.5, n)
    inv = InverterParams(bus=inv_bus, v1=0.92 + dv, v2=0.98 + dv,
                         v3=1.02 + dv, v4=1.08 + dv,
                         qmax_pu=inv_qmax, tau_h=inv_tau)

    # -- demand-response blocks ----------------------------------------------
    n = int(spec.dr)
    per = spec.dr_frac * total_load / max(n, 1)
    dr_bus = rng.choice(
        nb, size=n, p=_site_weights(load, None, None)).astype(np.int32)
    dr_p = per * rng.uniform(0.7, 1.3, n)
    dr_comply = (rng.uniform(0.0, 1.0, n) < 0.8).astype(np.float64)
    dr_depth = np.full(n, float(spec.dr_depth))
    dr = DrParams(bus=dr_bus, p_pu=dr_p, comply=dr_comply, depth=dr_depth)

    # -- broadcast curtailment windows (per scenario) ------------------------
    s, e = int(profiles.spec.scenarios), int(spec.dr_events)
    ev_start = rng.uniform(8.0, 20.0, (s, e))
    ev_dur = rng.uniform(0.5, 2.0, (s, e))
    events = DrEvents(start_h=ev_start, dur_h=ev_dur)

    state0 = AgentState(
        ev_soc=ev_soc0.copy(),
        th_temp=th_temp0,
        th_on=np.zeros(int(spec.thermostat)),
        inv_q=np.zeros(int(spec.inverter)),
        dr_eng=np.zeros(int(spec.dr)),
    )
    return Population(ev=ev, th=th, inv=inv, dr=dr), state0, events


def dr_signal(events: DrEvents, hours: np.ndarray) -> np.ndarray:
    """``[Tc, S]`` broadcast curtailment signal (0/1) for the given
    hour-of-day vector — a pure function of the timestep index (the
    windows were drawn at construction), evaluated host-side per chunk
    like the profile tensors.  Windows wrap past midnight."""
    h = np.asarray(hours, np.float64)
    if events.start_h.size == 0:
        return np.zeros((h.size, events.start_h.shape[0]))
    d = np.mod(h[:, None, None] - events.start_h[None], 24.0)  # [Tc,S,E]
    return np.any(d < events.dur_h[None], axis=-1).astype(np.float64)


# -- per-agent steps: plain PyTorch, elementwise over [S, n_kind] -----------
#
# Parameters are ``[n_kind]`` tensors (broadcast over lanes), state and
# observations ``[S, n_kind]``, ``h`` a Python float (the hour, one per
# timestep), ``dt_h`` the step in hours.  Every expression keeps the
# reference's association, which the kernel A1 (``csrc/qsts.cu``)
# repeats operation for operation.  Scalar terms that depend only on
# ``h`` or ``dt_h`` are evaluated as 0-d tensors on the state's device,
# so the plain version on the card uses the card's ``exp``/``cos``, as
# the kernel does.


def _clip01(x):
    """``jnp.clip(x, 0, 1)``: NaN stays NaN."""
    return torch.clamp(x, 0.0, 1.0)


def _scalar(x: float, like):
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def ev_step(soc, obs_v, h, prm: EvParams, dt_h: float):
    """One EV session step: ``(soc, v, h) -> (soc', p_inj, q_inj)``."""
    present = torch.where(
        prm.arr_h <= prm.dep_h,
        (h >= prm.arr_h) & (h < prm.dep_h),
        (h >= prm.arr_h) | (h < prm.dep_h),
    )
    droop = _clip01((obs_v - EV_V_MIN) / (EV_V_FULL - EV_V_MIN))
    charging = present & (soc < 1.0)
    p_chg = prm.rate_pu * droop * torch.where(charging, 1.0, 0.0).to(
        soc.dtype)
    soc_chg = torch.minimum(soc + p_chg * dt_h / prm.cap_puh,
                            _scalar(1.0, soc))
    # Departure re-arms the next session at the arrival SoC.
    soc_next = torch.where(present, soc_chg, prm.soc0)
    return soc_next, -p_chg, torch.zeros_like(p_chg)


def ambient_c(h, amb_off_c):
    """Sinusoidal ambient temperature peaking at :data:`AMB_PEAK_H`."""
    c = torch.cos(_scalar(2.0 * math.pi * (h - AMB_PEAK_H) / 24.0,
                          amb_off_c))
    return AMB_MEAN_C + amb_off_c + AMB_SWING_C * c


def thermostat_step(temp, on, obs_v, h, prm: ThermostatParams, dt_h: float):
    """One thermostat step: hysteresis switch, then the exact
    exponential step of the first-order thermal ODE with the relay's
    cooling applied.  Voltage-independent (``obs_v`` unused — the
    signature matches the kind contract)."""
    del obs_v
    on_next = torch.where(
        temp > prm.set_c + 0.5 * prm.db_c, 1.0,
        torch.where(temp < prm.set_c - 0.5 * prm.db_c, 0.0, on))
    amb = ambient_c(h, prm.amb_off_c)
    a = torch.exp(-dt_h / prm.tau_h)
    temp_next = amb + (temp - amb) * a - prm.gain_c * (1.0 - a) * on_next
    p = -prm.p_pu * on_next
    return (temp_next, on_next), p, torch.zeros_like(p)


def inverter_step(q, obs_v, h, prm: InverterParams, dt_h: float):
    """One Volt-VAR step: the piecewise q(v) target at the observed
    (previous-step solved) bus voltage, tracked through a first-order
    lag.  Injects reactive power only."""
    del h
    rise = _clip01((prm.v2 - obs_v) / (prm.v2 - prm.v1))
    fall = _clip01((obs_v - prm.v3) / (prm.v4 - prm.v3))
    q_tgt = prm.qmax_pu * (rise - fall)
    alpha = 1.0 - torch.exp(-dt_h / prm.tau_h)
    q_next = q + alpha * (q_tgt - q)
    return q_next, torch.zeros_like(q_next), q_next


def dr_step(eng, sig, h, prm: DrParams, dt_h: float):
    """One demand-response step: engagement ramps toward the broadcast
    signal (compliant agents only) with :data:`DR_TAU_H`; the flexible
    block draws its load shaved by ``depth * engagement``.  ``sig`` is
    the lanes' signal ``[S, 1]`` (or a scalar)."""
    del h
    alpha = 1.0 - torch.exp(_scalar(-dt_h / DR_TAU_H, eng))
    eng_next = eng + alpha * (sig * prm.comply - eng)
    p = -prm.p_pu * (1.0 - prm.depth * eng_next)
    return eng_next, p, torch.zeros_like(p)


def population_step(pop: Population, ag: AgentState, obs_v, sig, h,
                    dt_h: float, n_bus: int, device=None):
    """Step every agent of every lane and aggregate per bus.

    ``ag`` holds ``[S, n_kind]`` states in the reference's agent order,
    ``obs_v [S, n_bus]`` the lanes' observed bus voltages, ``sig [S]``
    the broadcast DR signal, ``h`` the hour.  Returns ``(state', p_bus
    [S, n], q_bus [S, n], served_pu [S], q_abs_peak [S])`` as tensors on
    ``device`` (``cuda`` unless asked otherwise), the state again in the
    reference's order.  A convenience over the engine's form: it builds
    the bus-sorted operands of ``pop`` on each call, then makes one call
    of :func:`~freedm_tpu_torch.kernels.qsts_kernels.agent_step` (A1)."""
    from freedm_tpu_torch.device import resolve_device
    from freedm_tpu_torch.kernels import qsts_kernels as qk

    dev = resolve_device(device)
    f64 = torch.float64
    op = qk.agent_operands(pop, n_bus, dev)
    obs = torch.as_tensor(np.asarray(obs_v), dtype=f64, device=dev)
    lanes = int(obs.shape[0])
    state = op.to_sorted(ag, lanes)
    zeros = torch.zeros(lanes, n_bus, dtype=f64, device=dev)
    p_bus, q_bus = torch.empty_like(zeros), torch.empty_like(zeros)
    puh = torch.zeros(lanes, dtype=f64, device=dev)
    qpk = torch.zeros(lanes, dtype=f64, device=dev)
    served = torch.empty(lanes, dtype=f64, device=dev)
    qk.agent_step(op, state, obs,
                  torch.as_tensor(np.asarray(sig), dtype=f64, device=dev),
                  float(h), float(dt_h), zeros, zeros, p_bus, q_bus, puh,
                  qpk, served)
    return op.to_reference(state), p_bus, q_bus, served, qpk
