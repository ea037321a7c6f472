"""Seeded, deterministic synthetic load/PV profiles for QSTS studies.

A quasi-static time-series study sweeps a day (or many days) of
injections over a Monte-Carlo population of scenarios.  This module is
the profile model: per-scenario daily load shapes (residential evening
peak / commercial midday plateau), PV irradiance with per-scenario
cloud transients, and smooth Monte-Carlo perturbations.

Port of ``freedm_tpu/scenarios/profiles.py``, array for array: the same
draws in the same order, so one seed gives the same bytes in both
packages.  Host numpy; nothing here touches a device.

Two properties are load-bearing for the engine built on top
(:mod:`freedm_tpu_torch.scenarios.engine`):

- **Determinism independent of chunking.**  Every random quantity is
  drawn ONCE at construction, in a fixed order, from
  ``np.random.default_rng(seed)``; the time axis is then a *pure
  function* of the timestep index (base shapes, harmonic noise with
  per-scenario phases, Gaussian cloud dips at per-scenario centers).
  ``chunk(t0, t1)`` therefore returns byte-identical values no matter
  how the study is chunked — which is what makes a killed job's
  checkpoint resume reproduce the uninterrupted run exactly.
- **Lazy chunk materialization.**  The full ``[S, T, nb]`` tensor is
  never built; callers ask for ``[S, t1-t0, nb]`` windows (a chunk of a
  few dozen timesteps is megabytes even at thousands of scenarios).

Construction cost is O(S·C + nb) host memory — scenario parameters, not
scenario trajectories.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Tuple

import numpy as np

PROFILE_KINDS = ("residential", "commercial", "mixed")

#: Floor on the load multiplier: a "night valley" scenario still draws
#: something, and solvers never see an exactly-zero system.
MIN_LOAD_MULT = 0.05


def population_rng(seed: int, stream: str) -> np.random.Generator:
    """The documented construction seam for populations built ON TOP of
    a profile set (agent populations — :mod:`freedm_tpu_torch.scenarios.agents`).

    One study seed drives everything: the profile draws consume
    ``default_rng(seed)`` in :class:`ProfileSet.__init__`'s fixed order,
    and any sibling population derives an INDEPENDENT stream from the
    same seed plus a stable stream label — so adding agents never
    perturbs the profile bytes, and the same seed yields byte-identical
    populations under any chunking (there is no second RNG convention
    to keep in sync).  It is the only place outside ``__init__`` where
    this module constructs an RNG, and callers draw from it only inside
    their own construction seams (``build_population``).
    """
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed), zlib.crc32(stream.encode("utf-8"))]))


@dataclass(frozen=True)
class ProfileSpec:
    """Shape of one profile population (validated by the jobs layer)."""

    scenarios: int
    steps: int
    dt_minutes: float = 15.0
    seed: int = 0
    kind: str = "residential"
    #: Fraction of buses carrying PV (drawn per bus from the same seed).
    pv_frac: float = 0.3
    #: PV plant size relative to the case's mean load magnitude.
    pv_scale: float = 0.6
    #: Per-scenario lognormal spread of the overall load level.
    sigma_scale: float = 0.15
    #: Amplitude of the smooth per-scenario temporal noise.
    sigma_noise: float = 0.05
    #: Cloud transits per scenario-day (PV dips).
    n_clouds: int = 6
    #: Harmonics in the temporal noise model.
    harmonics: int = 4


def residential_shape(h: np.ndarray) -> np.ndarray:
    """Morning shoulder + evening peak, normalized to ~1 at the peak."""
    return (
        0.45
        + 0.25 * np.exp(-(((h - 7.5) / 1.8) ** 2))
        + 0.55 * np.exp(-(((h - 19.0) / 2.5) ** 2))
    )


def commercial_shape(h: np.ndarray) -> np.ndarray:
    """Business-hours plateau (8..18) over a night base."""
    ramp_up = 1.0 / (1.0 + np.exp(-(h - 8.0) * 2.0))
    ramp_dn = 1.0 / (1.0 + np.exp((h - 18.0) * 2.0))
    return 0.35 + 0.65 * ramp_up * ramp_dn


def clear_sky(h: np.ndarray) -> np.ndarray:
    """Clear-sky irradiance fraction: a daylight half-sine (6..18),
    sharpened toward realistic shoulder falloff."""
    s = np.sin(np.pi * (h - 6.0) / 12.0)
    return np.where((h >= 6.0) & (h <= 18.0), np.maximum(s, 0.0) ** 1.2, 0.0)


class ProfileSet:
    """All random draws for one (spec, n_bus) population, fixed at
    construction; chunk methods are pure functions of the time index."""

    def __init__(self, spec: ProfileSpec, n_bus: int):
        if spec.kind not in PROFILE_KINDS:
            raise ValueError(
                f"unknown profile kind {spec.kind!r} "
                f"(have: {', '.join(PROFILE_KINDS)})"
            )
        self.spec = spec
        self.n_bus = int(n_bus)
        s, nb = int(spec.scenarios), int(n_bus)
        rng = np.random.default_rng(spec.seed)
        # Draw order is part of the determinism contract — NEVER reorder
        # or make a draw conditional on anything but the spec.
        self.scale = rng.lognormal(0.0, spec.sigma_scale, s)
        self.noise_phase = rng.uniform(0.0, 2.0 * np.pi, (s, spec.harmonics))
        amps = rng.uniform(0.5, 1.0, (s, spec.harmonics))
        self.noise_amp = amps / np.sum(amps, axis=1, keepdims=True)
        self.cloud_c = rng.uniform(7.0, 19.0, (s, spec.n_clouds))
        self.cloud_w = rng.uniform(0.08, 0.5, (s, spec.n_clouds))
        self.cloud_d = rng.uniform(0.2, 0.9, (s, spec.n_clouds))
        # Bus-level draws: diversity jitter on the daily shape, PV
        # siting.  Agent populations (scenarios/agents.py) reuse these
        # as their per-bus diversity — siting bias from
        # ``bus_residential``/``pv_cap``, micro-climate from
        # ``bus_jitter_h`` — instead of inventing a second convention.
        self.bus_jitter_h = rng.uniform(-0.75, 0.75, nb)
        self.pv_cap = np.where(
            rng.uniform(0.0, 1.0, nb) < spec.pv_frac,
            rng.uniform(0.3, 1.0, nb) * spec.pv_scale,
            0.0,
        )
        self.bus_residential = rng.uniform(0.0, 1.0, nb) < 0.6

    # -- time axis -----------------------------------------------------------
    def hours(self, t0: int, t1: int) -> np.ndarray:
        """Hour-of-day for timesteps ``[t0, t1)`` (wraps past midnight)."""
        t = np.arange(int(t0), int(t1), dtype=np.float64)
        return (t * self.spec.dt_minutes / 60.0) % 24.0

    # -- chunk materialization -----------------------------------------------
    def load_chunk(self, t0: int, t1: int) -> np.ndarray:
        """``[S, t1-t0, nb]`` load multipliers (apply to base injections)."""
        spec = self.spec
        h = self.hours(t0, t1)  # [Tc]
        hb = h[:, None] + self.bus_jitter_h[None, :]  # [Tc, nb]
        if spec.kind == "residential":
            base = residential_shape(hb % 24.0)
        elif spec.kind == "commercial":
            base = commercial_shape(hb % 24.0)
        else:  # mixed: per-bus class assignment
            base = np.where(
                self.bus_residential[None, :],
                residential_shape(hb % 24.0),
                commercial_shape(hb % 24.0),
            )
        k = np.arange(1, spec.harmonics + 1, dtype=np.float64)
        # [S, Tc]: smooth noise = per-scenario random-phase harmonics of
        # the day, so any chunk window evaluates without history.
        arg = (
            2.0 * np.pi * k[None, None, :] * h[None, :, None] / 24.0
            + self.noise_phase[:, None, :]
        )
        noise = spec.sigma_noise * np.sum(
            self.noise_amp[:, None, :] * np.sin(arg), axis=-1
        )
        mult = (
            self.scale[:, None, None]
            * base[None, :, :]
            * (1.0 + noise[:, :, None])
        )
        return np.maximum(mult, MIN_LOAD_MULT)

    def pv_chunk(self, t0: int, t1: int) -> np.ndarray:
        """``[S, t1-t0, nb]`` PV output fractions (of the per-bus
        capacity factor in ``pv_cap``): clear-sky irradiance times the
        scenario's cloud-transit dips."""
        h = self.hours(t0, t1)  # [Tc]
        irr = clear_sky(h)  # [Tc]
        # [S, Tc]: product of Gaussian dips at per-scenario cloud centers.
        d = h[None, :, None] - self.cloud_c[:, None, :]
        dips = 1.0 - self.cloud_d[:, None, :] * np.exp(
            -((d / self.cloud_w[:, None, :]) ** 2)
        )
        cloud = np.prod(dips, axis=-1)
        return self.pv_cap[None, None, :] * (irr[None, :] * cloud)[:, :, None]

    def chunk(self, t0: int, t1: int) -> Tuple[np.ndarray, np.ndarray]:
        """Both tensors for timesteps ``[t0, t1)``: ``(load_mult, pv)``."""
        return self.load_chunk(t0, t1), self.pv_chunk(t0, t1)
