"""The port's QSTS host data against ``freedm_tpu``, byte for byte:
profile chunks (every kind, several chunkings), agent populations and
DR signals, ``StudySpec.to_dict`` (the checkpoint identity), and the
atomic checkpoint file."""

import json
import os

import numpy as np
import pytest

from freedm_tpu.runtime import checkpoint as ref_ckpt
from freedm_tpu.scenarios import agents as ref_agents
from freedm_tpu.scenarios import engine as ref_engine
from freedm_tpu.scenarios import profiles as ref_profiles
from freedm_tpu_torch.runtime import checkpoint
from freedm_tpu_torch.scenarios import agents, engine, profiles

KINDS = profiles.PROFILE_KINDS


def _pair(kind, scenarios=5, steps=96, n_bus=23, seed=4, dt=15.0):
    kw = dict(scenarios=scenarios, steps=steps, dt_minutes=dt, seed=seed,
              kind=kind)
    return (profiles.ProfileSet(profiles.ProfileSpec(**kw), n_bus),
            ref_profiles.ProfileSet(ref_profiles.ProfileSpec(**kw), n_bus))


def _same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def test_profile_vocabulary_matches_reference():
    assert KINDS == ref_profiles.PROFILE_KINDS
    assert profiles.MIN_LOAD_MULT == ref_profiles.MIN_LOAD_MULT
    assert profiles.ProfileSpec(scenarios=1, steps=1) == \
        profiles.ProfileSpec(**vars(ref_profiles.ProfileSpec(scenarios=1,
                                                             steps=1)))
    with pytest.raises(ValueError, match="unknown profile kind"):
        profiles.ProfileSet(profiles.ProfileSpec(1, 1, kind="lunar"), 3)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("cuts", [(0, 96), (0, 24, 96), (0, 7, 50, 96),
                                  (30, 31, 130)])
def test_profile_chunks_are_the_reference_bytes(kind, cuts):
    port, ref = _pair(kind)
    for name in ("scale", "noise_phase", "noise_amp", "cloud_c", "cloud_w",
                 "cloud_d", "bus_jitter_h", "pv_cap", "bus_residential"):
        assert _same_bytes(getattr(port, name), getattr(ref, name)), name
    for a, b in zip(cuts, cuts[1:]):
        assert _same_bytes(port.hours(a, b), ref.hours(a, b))
        for got, want in zip(port.chunk(a, b), ref.chunk(a, b)):
            assert _same_bytes(got, want)


@pytest.mark.parametrize("seed,dt", [(0, 60.0), (11, 7.5)])
def test_population_rng_and_dr_signal_are_the_reference_bytes(seed, dt):
    a = profiles.population_rng(seed, "agents").uniform(size=16)
    b = ref_profiles.population_rng(seed, "agents").uniform(size=16)
    assert _same_bytes(a, b)
    port, ref = _pair("mixed", scenarios=3, steps=48, n_bus=6, seed=seed,
                      dt=dt)
    p0 = np.array([-1.0, -0.5, 0.0, -2.0, -0.3, 0.2])
    kw = dict(ev=12, thermostat=10, inverter=8, dr=6, dr_events=3)
    pop, st, ev = agents.build_population(agents.AgentSpec(**kw), port, p0)
    rpop, rst, rev = ref_agents.build_population(
        ref_agents.AgentSpec(**kw), ref, p0)
    for mine, theirs in ((pop.ev, rpop.ev), (pop.th, rpop.th),
                         (pop.inv, rpop.inv), (pop.dr, rpop.dr), (st, rst),
                         (ev, rev)):
        assert mine._fields == theirs._fields
        for x, y in zip(mine, theirs):
            assert _same_bytes(x, y)
    for a, b in ((0, 48), (5, 9)):
        assert _same_bytes(agents.dr_signal(ev, port.hours(a, b)),
                           ref_agents.dr_signal(rev, ref.hours(a, b)))


def test_population_with_zero_count_kinds_and_case_loads():
    from freedm_tpu_torch.grid.matpower import load_builtin

    sys_ = load_builtin("case_ieee30")
    port, ref = _pair("residential", scenarios=2, n_bus=sys_.n_bus, seed=3)
    kw = dict(ev=50, thermostat=0, inverter=7, dr=0)
    out = agents.build_population(agents.AgentSpec(**kw), port,
                                  np.asarray(sys_.p_inj))
    want = ref_agents.build_population(ref_agents.AgentSpec(**kw), ref,
                                       np.asarray(sys_.p_inj))
    for mine, theirs in zip(out, want):
        for x, y in zip(mine, theirs):
            for u, v in zip(x if isinstance(x, tuple) else (x,),
                            y if isinstance(y, tuple) else (y,)):
                assert _same_bytes(u, v)


@pytest.mark.parametrize("agents_kw", [None, dict(ev=5, closed_loop=False)])
def test_study_spec_to_dict_is_the_reference_identity(agents_kw):
    kw = dict(case="case14", scenarios=3, steps=8, chunk_steps=3, seed=2,
              pf_backend="sparse", pf_precision="f64")
    mine = engine.StudySpec(
        **kw, agents=agents.AgentSpec(**agents_kw) if agents_kw else None)
    theirs = ref_engine.StudySpec(
        **kw, agents=ref_agents.AgentSpec(**agents_kw) if agents_kw else None)
    assert mine.to_dict() == theirs.to_dict()
    assert list(mine.to_dict()) == list(theirs.to_dict())
    assert engine.StudySpec.from_dict(theirs.to_dict()) == mine
    assert mine.profile_spec() == profiles.ProfileSpec(
        **vars(theirs.profile_spec()))
    assert engine.placement_free_spec(mine.to_dict()) == \
        ref_engine.placement_free_spec(theirs.to_dict())
    for name in ("V_BAND", "CKPT_VERSION", "SUMMARY_TIMING_KEYS",
                 "MESH_SPEC_KEYS"):
        assert getattr(engine, name) == getattr(ref_engine, name), name


def test_checkpoint_is_atomic_and_reads_the_reference_files(tmp_path):
    path = str(tmp_path / "ck.json")
    state = {"version": 1, "state": {"v": [[1.0, 0.1 + 0.2]]},
             "chunk_index": 3}
    checkpoint.save(path, state)
    assert not os.path.exists(path + ".tmp")
    assert checkpoint.load(path) == state == ref_ckpt.load(path)
    ref_ckpt.save(path, {"x": [1e-300, 2.5]})
    assert checkpoint.load(path) == {"x": [1e-300, 2.5]}
    # A stale tmp file from a killed write is simply replaced.
    with open(path + ".tmp", "w") as f:
        f.write("{torn")
    checkpoint.save(path, state)
    with open(path) as f:
        assert json.load(f) == state
