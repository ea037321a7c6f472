"""Batched quasi-static time-series (QSTS) runner.

Port of ``freedm_tpu/scenarios/engine.py``: sweep a day (or many days) of
per-bus injections over a Monte-Carlo population of scenarios, on the
port's batched solvers — the Newton path for bus cases
(:mod:`freedm_tpu_torch.pf.newton`, dense K1-K3 or sparse S1-S4) and the
ladder for feeder cases (:mod:`freedm_tpu_torch.pf.ladder`, L1).

Where the reference runs a chunk as one ``lax.scan`` over timesteps of a
``vmap`` over scenarios, the port runs a host loop over the chunk's
timesteps, each step one batched solve of all ``S`` lanes, with the carry
on the card: it crosses to host numpy only at the chunk boundary, which
is the reference's checkpoint contract.  Per step:

- **bus cases** — the solve from the carry's seed point (the previous
  step's solution with ``warm_start``, else the flat start), then the
  streaming reductions on the kernel Q1
  (:func:`~freedm_tpu_torch.kernels.qsts_kernels.qsts_bus_reduce`):
  band minutes, losses, iterations, the envelope and the peak branch |S|;
- **with agents** — first the agent step on the kernel A1
  (:func:`~freedm_tpu_torch.kernels.qsts_kernels.agent_step`), which
  writes the solver's inputs (the profile plus the agents' per-bus
  injections), then the solve and Q1; the carry always holds the solved
  point (the agents' next observation);
- **feeder cases** — the ladder restarts cold every step, so a chunk's
  ``Tc · S`` lanes are independent: one L1 launch solves them all (a few
  when they would pass :data:`FEEDER_LAUNCH_BYTES`), then one Q2 launch
  (:func:`~freedm_tpu_torch.kernels.qsts_kernels.qsts_feeder_reduce`)
  reduces them in step order.

The study's scalars (worst iteration count, non-converged lane-steps,
envelope, peak) ride the chunk as per-lane partials and fold into the
carried scalars at the chunk's end with min, max and integer sums, which
do not depend on order; every sum on the card is a fixed-order one.  So a
killed study resumed from its chunk checkpoint, or the same study cut
into other chunks, gives the same bits.  Agent state is kept sorted by
bus on the card and permuted back to the reference's agent order at the
boundary, so checkpoints have the reference's layout.

On the card the engine runs on a CUDA stream of its own (and syncs only
that stream), so a study does not stall the serving batcher.
``compiles`` keeps the reference's meaning as the count of distinct
chunk lengths the engine has set up (at most two a study).  The sharded
form (``mesh_devices`` > 1) is ROADMAP.md module queue item 16.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from freedm_tpu_torch.cplx import C
from freedm_tpu_torch.device import DeviceLike, platform_name, resolve_device
from freedm_tpu_torch.kernels import qsts_kernels as qk
from freedm_tpu_torch.pf.backend import (
    BACKENDS,
    PF_PRECISIONS,
    resolve_backend,
    resolve_precision,
)
from freedm_tpu_torch.scenarios.agents import (
    AgentSpec,
    build_population,
    dr_signal,
    validate_agent_spec,
)
from freedm_tpu_torch.scenarios.profiles import (
    PROFILE_KINDS,
    ProfileSet,
    ProfileSpec,
)

#: Voltage band for violation accounting, pu (ANSI C84.1 service band —
#: same band the VVC what-if reports against).
V_BAND = (0.95, 1.05)

CKPT_VERSION = 1

#: Summary keys that legitimately differ between two runs of the same
#: study (wall-clock and bookkeeping): the resume-exactness contract is
#: "summaries equal modulo these".
SUMMARY_TIMING_KEYS = ("wall_s", "scenario_steps_per_sec",
                       "agent_steps_per_sec", "compiles",
                       "resumed_from_chunk", "chunks_done", "mesh_devices")

#: StudySpec keys that describe EXECUTION PLACEMENT, not the study —
#: checkpoint spec matching ignores them.
MESH_SPEC_KEYS = ("mesh_devices",)

#: Working set a feeder chunk's single L1 launch may take, bytes: a
#: chunk's ``Tc · S`` lanes go to L1 in as few launches as keep each under
#: it (L1's loads, outputs and scratch and the solver's permuted copies,
#: counted as 64 float64 values a branch and lane).
FEEDER_LAUNCH_BYTES = 1 << 30

#: Finite envelope sentinels (any real voltage replaces them; keeps the
#: checkpoint JSON free of Infinity literals).
_V_LO_INIT = 100.0
_V_HI_INIT = -100.0


def placement_free_spec(d: dict) -> dict:
    """The checkpoint-compatibility view of a spec dict: placement keys
    (:data:`MESH_SPEC_KEYS`) out."""
    return {k: v for k, v in d.items() if k not in MESH_SPEC_KEYS}


def strip_timing(summary: dict) -> dict:
    """The comparison view of a summary: timing/bookkeeping keys out."""
    return {k: v for k, v in summary.items() if k not in SUMMARY_TIMING_KEYS}


class StudyCancelled(Exception):
    """Raised between chunks when the caller's cancel event is set; the
    last chunk checkpoint (if any) stays on disk for a later resume."""


@dataclass(frozen=True)
class StudySpec:
    """One QSTS study: case + horizon + profile population (the
    reference's fields and defaults, so ``to_dict`` is the reference's
    checkpoint identity).

    ``case`` is the serving registry's vocabulary (bus cases ``case14``
    / ``case_ieee30`` / ``meshN``, feeder case ``vvc_9bus``).
    ``pf_backend`` and ``pf_precision`` are part of the study's identity
    (backends agree to solver tolerance, not bit for bit); feeder studies
    validate and ignore them.  ``mesh_devices`` is placement, not
    identity: 0 or 1, or -1 where that resolves to one device.
    ``agents`` is an optional grid-edge population (bus cases only).
    """

    case: str
    scenarios: int = 16
    steps: int = 96
    dt_minutes: float = 15.0
    seed: int = 0
    profile: str = "residential"
    chunk_steps: int = 24
    warm_start: bool = True
    max_iter: int = 12
    pf_backend: str = "auto"
    pf_precision: str = "auto"
    mesh_devices: int = 0
    agents: Optional[AgentSpec] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "StudySpec":
        d = dict(d)
        if isinstance(d.get("agents"), dict):
            d["agents"] = AgentSpec(**d["agents"])
        return cls(**d)

    def profile_spec(self) -> ProfileSpec:
        return ProfileSpec(
            scenarios=self.scenarios,
            steps=self.steps,
            dt_minutes=self.dt_minutes,
            seed=self.seed,
            kind=self.profile,
        )


class BusState(NamedTuple):
    """Bus-case chunk carry: warm-start point + streaming accumulators."""

    v: np.ndarray  # [S, n] warm-start voltage magnitudes
    theta: np.ndarray  # [S, n] warm-start angles
    viol_min: np.ndarray  # [S] bus-minutes outside V_BAND
    loss_puh: np.ndarray  # [S] cumulative losses, pu·h
    it_sum: np.ndarray  # [S] total Newton iterations
    it_max: np.ndarray  # [] worst per-step iteration count
    nonconv: np.ndarray  # [] lane-steps that failed to converge
    v_lo: np.ndarray  # [] envelope min
    v_hi: np.ndarray  # [] envelope max
    peak_pu: np.ndarray  # [] peak branch apparent power, pu


class AgentBusState(NamedTuple):
    """Bus-case chunk carry with an agent population: the
    :class:`BusState` fields (``v``/``theta`` always the last SOLVED
    point — the agents' observation) plus per-agent state in the
    reference's agent order and two agent accumulators."""

    v: np.ndarray  # [S, n] last solved voltage magnitudes (the obs)
    theta: np.ndarray  # [S, n] last solved angles
    viol_min: np.ndarray  # [S]
    loss_puh: np.ndarray  # [S]
    it_sum: np.ndarray  # [S]
    it_max: np.ndarray  # []
    nonconv: np.ndarray  # []
    v_lo: np.ndarray  # []
    v_hi: np.ndarray  # []
    peak_pu: np.ndarray  # []
    ev_soc: np.ndarray  # [S, n_ev] EV state of charge
    th_temp: np.ndarray  # [S, n_th] thermostat indoor temperature
    th_on: np.ndarray  # [S, n_th] thermostat relay (0/1)
    inv_q: np.ndarray  # [S, n_inv] inverter reactive output
    dr_eng: np.ndarray  # [S, n_dr] DR engagement level
    agent_puh: np.ndarray  # [S] cumulative served agent energy, pu·h
    agent_qpk: np.ndarray  # [] peak inverter |q|, pu


class FeederState(NamedTuple):
    """Feeder-case chunk carry (ladder restarts cold; no warm carry)."""

    viol_min: np.ndarray  # [S]
    loss_kwh: np.ndarray  # [S]
    it_sum: np.ndarray  # [S]
    it_max: np.ndarray  # []
    nonconv: np.ndarray  # []
    v_lo: np.ndarray  # []
    v_hi: np.ndarray  # []
    peak_kva: np.ndarray  # []


def _resolve_case(name: str):
    """(kind, case object) via the serving registry's vocabulary — QSTS
    and the synchronous queries must agree on what a case name means."""
    from freedm_tpu_torch.serve.service import (
        FEEDER_CASES,
        _resolve_bus_case,
        _resolve_feeder_case,
    )

    if name in FEEDER_CASES:
        return "feeder", _resolve_feeder_case(name)
    return "bus", _resolve_bus_case(name)


def resolve_mesh_devices(mesh_devices: int) -> int:
    """The devices a study's scenario axis spans: 0 and 1 mean one; -1
    means every local card, which must come to one.  More raises: the
    sharded chunk form is not ported."""
    n = int(mesh_devices)
    count = torch.cuda.device_count() if n < 0 else n
    if count > 1:
        raise NotImplementedError(
            f"mesh_devices={n} ({count} devices): the sharded QSTS chunk "
            f"form is not ported (ROADMAP.md, module queue item 16: "
            f"multi-GPU lane sharding)"
        )
    return 1


class QstsEngine:
    """Chunk runner for one :class:`StudySpec` on one device.

    ``run_chunk`` takes and returns *numpy* state — the host round-trip
    between chunks is what makes chunk-boundary checkpoints exact.
    ``device`` is ``cuda`` unless the caller asks for the CPU;
    ``plain=True`` runs the kernels' plain PyTorch versions on any device
    (the on-card reference the kernel path is held to).  ``stream``: the
    CUDA stream to run on (a new one by default).  ``wall_split`` sums
    each chunk's host wall in four parts: ``materialize`` (the profile
    tensors on the host), ``copy_in``, ``steps`` and ``copy_out``.
    """

    def __init__(self, spec: StudySpec, device: DeviceLike = None,
                 plain: bool = False,
                 stream: Optional["torch.cuda.Stream"] = None):
        if spec.profile not in PROFILE_KINDS:
            raise ValueError(
                f"unknown profile {spec.profile!r} "
                f"(have: {', '.join(PROFILE_KINDS)})"
            )
        if spec.pf_backend not in BACKENDS:
            raise ValueError(
                f"unknown pf_backend {spec.pf_backend!r} "
                f"(have: {', '.join(BACKENDS)})"
            )
        if spec.pf_precision not in PF_PRECISIONS:
            raise ValueError(
                f"unknown pf_precision {spec.pf_precision!r} "
                f"(have: {', '.join(PF_PRECISIONS)})"
            )
        self.spec = spec
        self.device = resolve_device(device)
        self.plain = bool(plain)
        self.kind, self._case = _resolve_case(spec.case)
        self.mesh_devices = resolve_mesh_devices(spec.mesh_devices)
        self.compiles = 0  # distinct chunk lengths set up
        self._lengths = set()
        self.wall_split = dict.fromkeys(
            ("materialize", "copy_in", "steps", "copy_out"), 0.0)
        self._stream = None
        if self.device.type == "cuda":
            self._stream = stream or torch.cuda.Stream(self.device)
        self.rdtype = np.dtype(np.float64)
        self._pop = None
        self._agents_total = 0
        with self._on_stream():
            if self.kind == "bus":
                self._init_bus()
            else:
                self._init_feeder()
            self.profiles = ProfileSet(spec.profile_spec(), self._n_profile)
            if spec.agents is not None:
                if self.kind != "bus":
                    raise ValueError(
                        "agent populations require a bus case: the feeder "
                        "ladder has no per-bus voltage state for agents to "
                        "observe (closed-loop q(v) needs the Newton path)"
                    )
                validate_agent_spec(spec.agents)
                self._agents_total = spec.agents.total()
                self._pop, self._ag0, self._events = build_population(
                    spec.agents, self.profiles, self._p0
                )
                self._aop = qk.agent_operands(self._pop, self._case.n_bus,
                                              self.device)
        self._sync()

    # -- device plumbing ----------------------------------------------------
    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _sync(self) -> None:
        if self._stream is not None:
            self._stream.synchronize()

    def _tensor(self, a, dtype=torch.float64):
        """A contiguous device copy of a host array (never a view of it:
        numpy's ``astype`` may hand back a column-major copy)."""
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=self.device)

    def _lanes(self, x, dtype=torch.float64):
        """``[S]`` on the device filled with the scalar ``x``."""
        return torch.full((self.spec.scenarios,), np.asarray(x).item(),
                          dtype=dtype, device=self.device)

    def _acc(self, state, loss: np.ndarray) -> qk.StepAcc:
        i32 = torch.int32
        return qk.StepAcc(
            viol=self._tensor(state.viol_min), loss=self._tensor(loss),
            it_sum=self._tensor(state.it_sum, i32),
            it_max=self._lanes(state.it_max, i32),
            nonconv=torch.zeros(self.spec.scenarios, dtype=i32,
                                device=self.device),
            v_lo=self._lanes(state.v_lo), v_hi=self._lanes(state.v_hi),
            peak=self._lanes(state.peak_pu if self.kind == "bus"
                             else state.peak_kva))

    @staticmethod
    def _fold(acc: qk.StepAcc, state) -> dict:
        """The accumulators back on the host, the lanes' partials folded
        into the study's scalars (min, max, integer sum: order-free)."""
        def host(t):
            return t.cpu().numpy()

        return dict(
            viol_min=host(acc.viol), it_sum=host(acc.it_sum),
            it_max=np.asarray(host(torch.amax(acc.it_max)), np.int32),
            nonconv=np.asarray(np.int32(state.nonconv)
                               + host(torch.sum(acc.nonconv)), np.int32),
            v_lo=host(torch.amin(acc.v_lo)), v_hi=host(torch.amax(acc.v_hi)),
            peak=host(torch.amax(acc.peak)), loss=host(acc.loss))

    # -- bus (Newton) path ---------------------------------------------------
    def _init_bus(self):
        from freedm_tpu_torch.grid.bus import PQ
        from freedm_tpu_torch.pf.newton import make_newton_solver

        sys_ = self._case
        dev = self.device
        self.solver_name = "newton"
        self.pf_backend = resolve_backend(self.spec.pf_backend, sys_.n_bus)
        self.pf_precision = resolve_precision(self.spec.pf_precision,
                                              platform_name(dev))
        n = sys_.n_bus
        self._n_profile = n
        self._p0 = np.asarray(sys_.p_inj, np.float64)
        self._q0 = np.asarray(sys_.q_inj, np.float64)
        load = np.abs(self._p0[self._p0 < 0])
        self._pv_base = float(load.mean()) if load.size else 0.0
        self.base_mva = float(sys_.base_mva)
        bt = np.asarray(sys_.bus_type)
        self._v_flat = np.where(
            bt == PQ, 1.0, np.asarray(sys_.v_set, np.float64)
        ).astype(self.rdtype)
        self._solve, _ = make_newton_solver(
            sys_, max_iter=self.spec.max_iter, backend=self.pf_backend,
            precision=self.pf_precision, device=dev, plain=self.plain,
        )
        self._red = qk.bus_reduce_operands(sys_, dev)
        self._flat_row = torch.as_tensor(self._v_flat, device=dev)

    def _bus_injections(self, t0: int, t1: int):
        """[Tc, S, n] scheduled injections for timesteps [t0, t1):
        generation tracks load through the common multiplier, PV rides on
        top as positive injection at its sited buses."""
        load, pv = self.profiles.chunk(t0, t1)  # [S, Tc, n]
        p = self._p0[None, None, :] * load + pv * self._pv_base
        q = self._q0[None, None, :] * load
        p = np.ascontiguousarray(p.swapaxes(0, 1)).astype(self.rdtype)
        q = np.ascontiguousarray(q.swapaxes(0, 1)).astype(self.rdtype)
        return p, q

    def _agent_arrays(self, t0: int, t1: int):
        """The broadcast DR signal [Tc, S] and the hour of day [Tc] for
        timesteps ``[t0, t1)`` (pure functions of the timestep index)."""
        h = self.profiles.hours(t0, t1)
        return dr_signal(self._events, h).astype(self.rdtype), h

    def _bus_chunk(self, state, t0: int, t1: int):
        spec = self.spec
        s, n = spec.scenarios, self._case.n_bus
        dt_min = float(spec.dt_minutes)
        dt_h = dt_min / 60.0
        lo, hi = V_BAND
        agents = self._pop is not None
        warm = spec.warm_start
        split = self.wall_split
        c0 = time.monotonic()
        p, q = self._bus_injections(t0, t1)
        if agents:
            sig, hours = self._agent_arrays(t0, t1)
        c1 = time.monotonic()
        P, Q = self._tensor(p), self._tensor(q)
        v, th = self._tensor(state.v), self._tensor(state.theta)
        acc = self._acc(state, state.loss_puh)
        flat = self._flat_row.expand(s, n)
        zero = torch.zeros(s, n, dtype=torch.float64, device=self.device)
        if agents:
            aop = self._aop
            ag = aop.to_sorted(state._asdict(), s)
            SIG = self._tensor(sig)
            puh = self._tensor(state.agent_puh)
            qpk = self._lanes(state.agent_qpk)
            served = torch.empty_like(puh)
            p_in, q_in = torch.empty_like(zero), torch.empty_like(zero)
            obs_flat = not spec.agents.closed_loop
            step_agents = qk.agent_step_plain if self.plain else qk.agent_step
        reduce = (qk.qsts_bus_reduce_plain if self.plain
                  else qk.qsts_bus_reduce)
        self._sync()
        c2 = time.monotonic()
        for i in range(t1 - t0):
            p_t, q_t = P[i], Q[i]
            if agents:
                # The agents observe the carry: the previous step's solved
                # |V| (the flat start at t=0), or 1.0 pu when replayed.
                step_agents(aop, ag, None if obs_flat else v, SIG[i],
                            float(hours[i]), dt_h, p_t, q_t, p_in, q_in, puh,
                            qpk, served)
                p_t, q_t = p_in, q_in
            r = self._solve(p_inj=p_t, q_inj=q_t, v0=v if warm else flat,
                            theta0=th if warm else zero)
            reduce(r.v.contiguous(), r.theta.contiguous(), r.p.contiguous(),
                   r.iterations, r.converged, self._red, acc, dt_min, dt_h,
                   lo, hi)
            if warm or agents:
                # With agents the carry always holds the solved point.
                v, th = r.v.contiguous(), r.theta.contiguous()
        self._sync()
        c3 = time.monotonic()
        f = self._fold(acc, state)
        out = dict(v=v.cpu().numpy(), theta=th.cpu().numpy(),
                   viol_min=f["viol_min"], loss_puh=f["loss"],
                   it_sum=f["it_sum"], it_max=f["it_max"],
                   nonconv=f["nonconv"], v_lo=f["v_lo"], v_hi=f["v_hi"],
                   peak_pu=f["peak"])
        if agents:
            out.update({k: x.cpu().numpy()
                        for k, x in aop.to_reference(ag).items()})
            out["agent_puh"] = puh.cpu().numpy()
            out["agent_qpk"] = torch.amax(qpk).cpu().numpy()
            result = AgentBusState(**out)
        else:
            result = BusState(**out)
        c4 = time.monotonic()
        split["materialize"] += c1 - c0
        split["copy_in"] += c2 - c1
        split["steps"] += c3 - c2
        split["copy_out"] += c4 - c3
        return result

    # -- feeder (ladder) path ------------------------------------------------
    def _init_feeder(self):
        from freedm_tpu_torch.pf.ladder import make_ladder_solver

        feeder = self._case
        self.solver_name = "ladder"
        self.pf_backend = "sweep"  # the ladder has no Jacobian at all
        self.pf_precision = "f64"  # ...and no Krylov inner to mix
        self._n_profile = feeder.n_branches
        s0 = np.asarray(feeder.s_load)
        self._s0_re = np.asarray(s0.real, np.float64)  # [nb, 3] kW
        self._s0_im = np.asarray(s0.imag, np.float64)  # [nb, 3] kvar
        load = self._s0_re[self._s0_re > 0]
        self._pv_base = float(load.mean()) if load.size else 0.0
        self._solve, _ = make_ladder_solver(
            feeder, max_iter=self.spec.max_iter, device=self.device,
            plain=self.plain,
        )
        self._fred = qk.feeder_reduce_operands(feeder, self.device)
        lane_bytes = 8 * 64 * (feeder.n_branches + 1)
        self._launch_lanes = max(1, FEEDER_LAUNCH_BYTES // lane_bytes)

    def _feeder_injections(self, t0: int, t1: int):
        """[Tc, S, nb, 3] net loads: base loads under the multiplier,
        PV offsetting real power at its sited nodes."""
        load, pv = self.profiles.chunk(t0, t1)  # [S, Tc, nb]
        s_re = (
            self._s0_re[None, None, :, :] * load[..., None]
            - (pv * self._pv_base)[..., None]
        )
        s_im = self._s0_im[None, None, :, :] * load[..., None]
        s_re = np.ascontiguousarray(s_re.swapaxes(0, 1)).astype(self.rdtype)
        s_im = np.ascontiguousarray(s_im.swapaxes(0, 1)).astype(self.rdtype)
        return s_re, s_im

    def _feeder_chunk(self, state, t0: int, t1: int):
        spec = self.spec
        s, tc = spec.scenarios, t1 - t0
        dt_min = float(spec.dt_minutes)
        dt_h = dt_min / 60.0
        lo, hi = V_BAND
        split = self.wall_split
        c0 = time.monotonic()
        s_re, s_im = self._feeder_injections(t0, t1)
        c1 = time.monotonic()
        nb = s_re.shape[2]
        lanes_re = self._tensor(s_re.reshape(tc * s, nb, 3))
        lanes_im = self._tensor(s_im.reshape(tc * s, nb, 3))
        acc = self._acc(state, state.loss_kwh)
        reduce = (qk.qsts_feeder_reduce_plain if self.plain
                  else qk.qsts_feeder_reduce)
        self._sync()
        c2 = time.monotonic()
        per = max(1, self._launch_lanes // s)  # timesteps a launch
        for g0 in range(0, tc, per):
            g1 = min(tc, g0 + per)
            sl = slice(g0 * s, g1 * s)
            r = self._solve(C(lanes_re[sl], lanes_im[sl]))
            reduce(r, self._fred, acc, g1 - g0, dt_min, dt_h, lo, hi)
        self._sync()
        c3 = time.monotonic()
        f = self._fold(acc, state)
        result = FeederState(
            viol_min=f["viol_min"], loss_kwh=f["loss"], it_sum=f["it_sum"],
            it_max=f["it_max"], nonconv=f["nonconv"], v_lo=f["v_lo"],
            v_hi=f["v_hi"], peak_kva=f["peak"])
        c4 = time.monotonic()
        split["materialize"] += c1 - c0
        split["copy_in"] += c2 - c1
        split["steps"] += c3 - c2
        split["copy_out"] += c4 - c3
        return result

    # -- state lifecycle -----------------------------------------------------
    def initial_state(self):
        s = self.spec.scenarios
        rd = self.rdtype
        if self.kind == "bus":
            n = self._case.n_bus
            base = BusState(
                v=np.broadcast_to(self._v_flat, (s, n)).astype(rd),
                theta=np.zeros((s, n), rd),
                viol_min=np.zeros(s, rd),
                loss_puh=np.zeros(s, rd),
                it_sum=np.zeros(s, np.int32),
                it_max=np.int32(0),
                nonconv=np.int32(0),
                v_lo=rd.type(_V_LO_INIT),
                v_hi=rd.type(_V_HI_INIT),
                peak_pu=rd.type(0.0),
            )
            if self._pop is None:
                return base
            # Per-agent initial state (drawn at construction) broadcast
            # over the scenario axis; scenarios diverge through the
            # voltages and profiles they observe.
            ag = self._ag0

            def rep(x):
                return np.broadcast_to(x, (s,) + x.shape).astype(rd)

            return AgentBusState(
                *base,
                ev_soc=rep(ag.ev_soc),
                th_temp=rep(ag.th_temp),
                th_on=rep(ag.th_on),
                inv_q=rep(ag.inv_q),
                dr_eng=rep(ag.dr_eng),
                agent_puh=np.zeros(s, rd),
                agent_qpk=rd.type(0.0),
            )
        return FeederState(
            viol_min=np.zeros(s, rd),
            loss_kwh=np.zeros(s, rd),
            it_sum=np.zeros(s, np.int32),
            it_max=np.int32(0),
            nonconv=np.int32(0),
            v_lo=rd.type(_V_LO_INIT),
            v_hi=rd.type(_V_HI_INIT),
            peak_kva=rd.type(0.0),
        )

    def run_chunk(self, state, t0: int, t1: int):
        """One chunk on the device; numpy state in, numpy state out."""
        tc = int(t1 - t0)
        if tc not in self._lengths:
            self._lengths.add(tc)
            self.compiles += 1
        with self._on_stream():
            if self.kind == "bus":
                return self._bus_chunk(state, t0, t1)
            return self._feeder_chunk(state, t0, t1)

    # -- checkpoint serialization -------------------------------------------
    def state_to_jsonable(self, state) -> dict:
        # float -> repr-roundtrip-exact JSON; the restored state is
        # bit-identical, which the resume-equality contract needs.
        return {k: np.asarray(v).tolist() for k, v in state._asdict().items()}

    def state_from_jsonable(self, d: dict):
        if self.kind == "bus":
            cls = AgentBusState if self._pop is not None else BusState
        else:
            cls = FeederState
        ref = self.initial_state()
        return cls(**{
            k: np.asarray(d[k], dtype=np.asarray(getattr(ref, k)).dtype)
            for k in cls._fields
        })

    # -- summary -------------------------------------------------------------
    def summarize(self, state, steps_done: int, wall_s: float = 0.0) -> dict:
        spec = self.spec
        lane_steps = max(int(steps_done) * spec.scenarios, 1)
        out = {
            "case": spec.case,
            "solver": self.solver_name,
            "scenarios": spec.scenarios,
            "steps": int(steps_done),
            "dt_minutes": spec.dt_minutes,
            "warm_start": bool(spec.warm_start and self.kind == "bus"),
            "violation_bus_minutes_mean": round(
                float(np.mean(state.viol_min)), 6
            ),
            "violation_bus_minutes_max": round(
                float(np.max(state.viol_min)), 6
            ),
            "v_min_pu": round(float(state.v_lo), 6),
            "v_max_pu": round(float(state.v_hi), 6),
            "iters_mean": round(float(np.sum(state.it_sum)) / lane_steps, 4),
            "iters_max": int(state.it_max),
            "lane_steps_not_converged": int(state.nonconv),
            "compiles": self.compiles,
            "mesh_devices": self.mesh_devices,
            "pf_backend": self.pf_backend,
            "pf_precision": self.pf_precision,
            "wall_s": round(float(wall_s), 3),
        }
        if self.kind == "bus":
            loss_mwh = np.asarray(state.loss_puh, np.float64) * self.base_mva
            out["energy_loss_mwh_mean"] = float(np.mean(loss_mwh))
            out["energy_loss_mwh_max"] = float(np.max(loss_mwh))
            out["peak_branch_mva"] = float(state.peak_pu) * self.base_mva
            # Conservation stamp: Σ realized P = network losses — small
            # and non-negative on a sane trajectory.
            out["energy_balance_ok"] = bool(
                np.min(np.asarray(state.loss_puh, np.float64)) > -1e-4
            )
            if self._pop is not None:
                out["agents_total"] = self._agents_total
                out["agents_closed_loop"] = bool(spec.agents.closed_loop)
                out["agent_energy_puh_mean"] = round(
                    float(np.mean(state.agent_puh)), 6
                )
                out["agent_q_peak_pu"] = round(float(state.agent_qpk), 6)
                if wall_s > 0:
                    out["agent_steps_per_sec"] = round(
                        lane_steps * self._agents_total / wall_s, 1
                    )
        else:
            loss_kwh = np.asarray(state.loss_kwh, np.float64)
            out["energy_loss_kwh_mean"] = float(np.mean(loss_kwh))
            out["energy_loss_kwh_max"] = float(np.max(loss_kwh))
            out["peak_branch_kva"] = float(state.peak_kva)
            # PV backfeed can push a scenario's net substation draw
            # negative; the stamp bounds the magnitude instead.
            out["energy_balance_ok"] = bool(
                np.all(np.isfinite(loss_kwh))
            )
        if wall_s > 0:
            out["scenario_steps_per_sec"] = round(lane_steps / wall_s, 1)
        return out


def run_study(
    spec: StudySpec,
    checkpoint_path: Optional[str] = None,
    resume: bool = True,
    cancel=None,
    on_chunk=None,
    stop_after_chunks: Optional[int] = None,
    engine: Optional[QstsEngine] = None,
    device: DeviceLike = None,
) -> dict:
    """Run a QSTS study chunk by chunk; returns the summary dict.

    - ``checkpoint_path``: write the chunk-boundary state there (atomic
      tmp+rename) and, with ``resume=True``, continue a matching
      previous study from its last completed chunk.  A checkpoint whose
      spec differs is ignored (the study restarts clean).
    - ``cancel``: a ``threading.Event``-like object checked between
      chunks; set -> :class:`StudyCancelled` (checkpoint retained).
    - ``on_chunk(done, total, chunk_s, lane_steps)``: progress callback
      (the jobs layer's metrics hook).
    - ``stop_after_chunks``: run at most this many chunks this call and
      return a partial result (``"completed": False``) — a simulated kill.
    - ``engine``: reuse an already-built :class:`QstsEngine` across
      calls (steady-state throughput); its spec must match.
    - ``device``: where a new engine runs (``cuda`` unless asked
      otherwise).

    The returned summary carries ``"completed"``/``"resumed_from_chunk"``
    alongside the engine's reductions.
    """
    from freedm_tpu_torch.runtime import checkpoint as ckpt

    if engine is None:
        engine = QstsEngine(spec, device=device)
    elif engine.spec != spec:
        raise ValueError("engine was built for a different StudySpec")
    chunk = max(int(spec.chunk_steps), 1)
    n_chunks = math.ceil(spec.steps / chunk)
    state = engine.initial_state()
    start_chunk = 0
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        saved = ckpt.load(checkpoint_path)
        # Placement keys are stripped from both sides: the chunk state
        # was gathered to host numpy, so it carries no placement.
        if (
            saved.get("version") == CKPT_VERSION
            and isinstance(saved.get("spec"), dict)
            and placement_free_spec(saved["spec"])
            == placement_free_spec(spec.to_dict())
        ):
            state = engine.state_from_jsonable(saved["state"])
            start_chunk = int(saved["chunk_index"])
    t_start = time.monotonic()
    done_chunks_this_call = 0
    for k in range(start_chunk, n_chunks):
        if cancel is not None and cancel.is_set():
            raise StudyCancelled(f"cancelled before chunk {k}")
        t0 = k * chunk
        t1 = min(spec.steps, t0 + chunk)
        c0 = time.monotonic()
        state = engine.run_chunk(state, t0, t1)
        chunk_s = time.monotonic() - c0
        if checkpoint_path:
            ckpt.save(checkpoint_path, {
                "version": CKPT_VERSION,
                "spec": spec.to_dict(),
                "chunk_index": k + 1,
                "state": engine.state_to_jsonable(state),
            })
        if on_chunk is not None:
            on_chunk(k + 1, n_chunks, chunk_s, (t1 - t0) * spec.scenarios)
        done_chunks_this_call += 1
        if (
            stop_after_chunks is not None
            and done_chunks_this_call >= stop_after_chunks
            and k + 1 < n_chunks
        ):
            partial = engine.summarize(
                state, t1, wall_s=time.monotonic() - t_start
            )
            partial["completed"] = False
            partial["chunks_done"] = k + 1
            partial["chunks_total"] = n_chunks
            partial["resumed_from_chunk"] = start_chunk
            return partial
    summary = engine.summarize(
        state, spec.steps, wall_s=time.monotonic() - t_start
    )
    summary["completed"] = True
    summary["chunks_done"] = n_chunks
    summary["chunks_total"] = n_chunks
    summary["resumed_from_chunk"] = start_chunk
    return summary
