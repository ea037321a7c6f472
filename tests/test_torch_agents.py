"""The port's grid-edge agents against ``freedm_tpu.scenarios.agents``:
each per-kind step and ``population_step`` with the lane axis written out
(S = 3) within 1e-12 of ``jax.vmap`` of the reference's; the bus-sorted
layout of the agent-step kernel A1 (tiles, segments, the sums' order);
the typed validation with the reference's messages.  The ``cuda``-marked
tests hold A1 to its plain version on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freedm_tpu.scenarios import agents as ref
from freedm_tpu.scenarios.profiles import ProfileSet as RefProfileSet
from freedm_tpu.scenarios.profiles import ProfileSpec as RefProfileSpec
from freedm_tpu.serve import InvalidRequest as RefInvalidRequest
from freedm_tpu_torch.kernels import qsts_kernels as qk
from freedm_tpu_torch.scenarios import agents
from freedm_tpu_torch.scenarios.profiles import ProfileSet, ProfileSpec
from freedm_tpu_torch.serve.queue import InvalidRequest

F64 = torch.float64
TOL = 1e-12
SMALL = dict(ev=12, thermostat=10, inverter=8, dr=6)
HOURS = (0.0, 7.5, 15.0, 19.0, 23.75)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is many small ops; on a shared host a
    multi-threaded pool spends longer waking its threads than computing,
    so these tests run torch on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _world(kw, n_bus, p0, lanes=3, seed=5):
    prof = ProfileSet(ProfileSpec(scenarios=lanes, steps=8, seed=seed), n_bus)
    rprof = RefProfileSet(RefProfileSpec(scenarios=lanes, steps=8, seed=seed),
                          n_bus)
    mine = agents.build_population(agents.AgentSpec(**kw), prof, p0)
    theirs = ref.build_population(ref.AgentSpec(**kw), rprof, p0)
    return mine, theirs


@pytest.fixture(scope="module")
def small_world():
    """The reference tests' 6-bus shape, three lanes of varied state."""
    p0 = np.array([-1.0, -0.5, 0.0, -2.0, -0.3, 0.2])
    (pop, st0, _), (rpop, _, _) = _world(SMALL, 6, p0)
    rng = np.random.default_rng(7)
    lanes = 3
    state = {f: np.broadcast_to(getattr(st0, f),
                                (lanes,) + getattr(st0, f).shape).copy()
             for f in st0._fields}
    state["ev_soc"][1] = rng.uniform(0.2, 1.0, state["ev_soc"].shape[1])
    state["ev_soc"][2, :3] = 1.0
    state["th_temp"] += rng.normal(0.0, 1.5, state["th_temp"].shape)
    state["th_on"] = rng.integers(0, 2, state["th_on"].shape).astype(float)
    state["inv_q"] = rng.uniform(-0.02, 0.02, state["inv_q"].shape)
    state["dr_eng"] = rng.uniform(0.0, 1.0, state["dr_eng"].shape)
    obs = rng.uniform(0.86, 1.1, (lanes, 6))
    return pop, rpop, state, obs


def _torch_params(prm):
    return type(prm)(*(torch.as_tensor(np.asarray(x)) for x in prm))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _lanes2(fn):
    """``jax.vmap`` over lanes (state and observation rows; the parameters
    shared) of the vmap over agents, for ``fn(state, obs, params)``."""
    return jax.vmap(jax.vmap(fn, in_axes=(0, 0, 0)), in_axes=(0, 0, None))


def test_constants_match_reference():
    for name in ("AGENT_KINDS", "EV_V_MIN", "EV_V_FULL", "AMB_MEAN_C",
                 "AMB_SWING_C", "AMB_PEAK_H", "DR_TAU_H", "MAX_DR_EVENTS"):
        assert getattr(agents, name) == getattr(ref, name), name
    assert agents.AgentSpec() == agents.AgentSpec(**vars(ref.AgentSpec()))
    for mine, theirs in ((agents.EvParams, ref.EvParams),
                         (agents.ThermostatParams, ref.ThermostatParams),
                         (agents.InverterParams, ref.InverterParams),
                         (agents.DrParams, ref.DrParams),
                         (agents.AgentState, ref.AgentState),
                         (agents.DrEvents, ref.DrEvents),
                         (agents.Population, ref.Population)):
        assert mine._fields == theirs._fields


@pytest.mark.parametrize("h", HOURS)
def test_ev_step_matches_vmapped_reference(small_world, h):
    pop, rpop, state, obs = small_world
    ob = obs[:, rpop.ev.bus]
    want = _lanes2(lambda s, v, p: ref.ev_step(s, v, h, p, 0.25))(
        jnp.asarray(state["ev_soc"]), jnp.asarray(ob), rpop.ev)
    got = agents.ev_step(torch.as_tensor(state["ev_soc"]),
                         torch.as_tensor(ob), h, _torch_params(pop.ev), 0.25)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("h", HOURS)
def test_thermostat_step_matches_vmapped_reference(small_world, h):
    pop, rpop, state, obs = small_world
    (wt, won), wp, wq = _lanes2(
        lambda t, o, p: ref.thermostat_step(t, o, 1.0, h, p, 0.25))(
        jnp.asarray(state["th_temp"]), jnp.asarray(state["th_on"]), rpop.th)
    (gt, gon), gp, gq = agents.thermostat_step(
        torch.as_tensor(state["th_temp"]), torch.as_tensor(state["th_on"]),
        None, h, _torch_params(pop.th), 0.25)
    _close(gt, wt)
    assert np.array_equal(gon.numpy(), np.asarray(won))
    _close(gp, wp)
    _close(gq, wq)


@pytest.mark.parametrize("h", (3.0, 12.0))
def test_inverter_step_matches_vmapped_reference(small_world, h):
    pop, rpop, state, obs = small_world
    ob = obs[:, rpop.inv.bus]
    want = _lanes2(lambda q, v, p: ref.inverter_step(q, v, h, p, 0.25))(
        jnp.asarray(state["inv_q"]), jnp.asarray(ob), rpop.inv)
    got = agents.inverter_step(torch.as_tensor(state["inv_q"]),
                               torch.as_tensor(ob), h,
                               _torch_params(pop.inv), 0.25)
    for g, w in zip(got, want):
        _close(g, w)


def test_dr_step_matches_vmapped_reference(small_world):
    pop, rpop, state, _ = small_world
    sig = np.array([0.0, 1.0, 1.0])
    want = jax.vmap(jax.vmap(lambda e, p, s: ref.dr_step(e, s, 12.0, p, 0.25),
                             in_axes=(0, 0, None)),
                    in_axes=(0, None, 0))(jnp.asarray(state["dr_eng"]),
                                          rpop.dr, jnp.asarray(sig))
    got = agents.dr_step(torch.as_tensor(state["dr_eng"]),
                         torch.as_tensor(sig)[:, None], 12.0,
                         _torch_params(pop.dr), 0.25)
    for g, w in zip(got, want):
        _close(g, w)


def _vmapped_population_step(rpop, state, obs, sig, h, dt, n_bus):
    rag = ref.AgentState(**{k: jnp.asarray(v) for k, v in state.items()})
    return jax.vmap(lambda v, ag, s: ref.population_step(
        rpop, ag, v, s, h, dt, n_bus))(jnp.asarray(obs), rag,
                                       jnp.asarray(sig))


@pytest.mark.parametrize("h", HOURS)
def test_population_step_matches_vmapped_reference(small_world, h):
    pop, rpop, state, obs = small_world
    sig = np.array([0.0, 1.0, 1.0])
    want = _vmapped_population_step(rpop, state, obs, sig, h, 0.25, 6)
    got = agents.population_step(pop, agents.AgentState(**state), obs, sig,
                                 h, 0.25, 6, device="cpu")
    for f in agents.AgentState._fields:
        _close(got[0][f], getattr(want[0], f))
    assert np.array_equal(got[0]["th_on"].numpy(), np.asarray(want[0].th_on))
    for g, w in zip(got[1:], want[1:]):
        _close(g, w)


def test_population_step_many_tiles_on_case30():
    """~10k agents over case_ieee30: many tiles and segments a bus."""
    from freedm_tpu_torch.grid.matpower import load_builtin

    sys_ = load_builtin("case_ieee30")
    kw = dict(ev=4000, thermostat=3000, inverter=1500, dr=1500)
    (pop, st0, _), (rpop, _, _) = _world(kw, sys_.n_bus,
                                         np.asarray(sys_.p_inj), lanes=2,
                                         seed=11)
    rng = np.random.default_rng(1)
    state = {f: np.broadcast_to(getattr(st0, f),
                                (2,) + getattr(st0, f).shape).copy()
             for f in st0._fields}
    state["inv_q"] = rng.uniform(-0.01, 0.01, state["inv_q"].shape)
    obs = rng.uniform(0.9, 1.07, (2, sys_.n_bus))
    sig = np.array([1.0, 0.0])
    want = _vmapped_population_step(rpop, state, obs, sig, 19.0, 1.0,
                                    sys_.n_bus)
    got = agents.population_step(pop, agents.AgentState(**state), obs, sig,
                                 19.0, 1.0, sys_.n_bus, device="cpu")
    for f in agents.AgentState._fields:
        _close(got[0][f], getattr(want[0], f))
    for g, w in zip(got[1:], want[1:]):
        _close(g, w)


def test_agent_operands_layout_and_sum_order():
    """Segments tile each kind's bus-sorted agents; the plain version's
    bus sums are the sequential sums over each tile's segment, then the
    segments in tile order, bit for bit."""
    from freedm_tpu_torch.grid.matpower import load_builtin

    sys_ = load_builtin("case14")
    kw = dict(ev=700, thermostat=3, inverter=0, dr=300)
    (pop, st0, _), _ = _world(kw, sys_.n_bus, np.asarray(sys_.p_inj),
                              lanes=1)
    op = qk.agent_operands(pop, sys_.n_bus, "cpu")
    assert op.counts == [700, 3, 0, 300]
    assert op.tile_start == [0, 3, 4, 4, 6]
    starts, ends = op.seg_start.numpy(), op.seg_end.numpy()
    ptr = op.tile_seg_ptr.numpy()
    for k in range(4):
        order = op.order[k]
        bus = np.asarray(getattr(pop, ("ev", "th", "inv", "dr")[k]).bus)
        assert np.array_equal(order, np.argsort(bus, kind="stable"))
        sb = bus[order]
        for g in range(op.tile_start[k], op.tile_start[k + 1]):
            segs = range(ptr[g], ptr[g + 1])
            tile0 = (g - op.tile_start[k]) * qk.TILE
            assert starts[segs[0]] == tile0
            assert ends[segs[-1]] == min(tile0 + qk.TILE, op.counts[k])
            for j in segs:  # one bus a segment
                assert len(set(sb[starts[j]:ends[j]])) == 1
    # Sums: the kernel's order, bit for bit.
    state = op.to_sorted(st0, 1)
    c = torch.as_tensor(np.random.default_rng(3).normal(size=(1, 700)))
    seg = torch.zeros(1, op.n_seg + 1, dtype=F64)
    qk._segment_sums(op, 0, c, seg)
    got = qk._bus_sums(op, 0, seg)[0].numpy()
    cs = c[0].numpy()
    bus_ptr = op.bus_seg_ptr.numpy()[0]
    for b in range(sys_.n_bus):
        want = 0.0
        for j in range(bus_ptr[b], bus_ptr[b + 1]):
            part = 0.0
            for i in range(starts[j], ends[j]):
                part += cs[i]
            want += part
        assert got[b] == want
    back = op.to_reference(state)
    for f in ("ev_soc", "th_temp", "dr_eng"):
        assert np.array_equal(back[f].numpy()[0], getattr(st0, f))


def test_agent_step_refuses_other_devices():
    p0 = np.array([-1.0, -0.5, 0.0, -2.0, -0.3, 0.2])
    (pop, _, _), _ = _world(SMALL, 6, p0, lanes=1)
    op = qk.agent_operands(pop, 6, "cpu")
    meta = torch.empty(1, 6, dtype=F64, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        qk.agent_step(op, [], None, meta[:, 0], 0.0, 1.0, meta, meta, meta,
                      meta, meta[:, 0], meta[:, 0], meta[:, 0])
    with pytest.raises(ValueError, match="sited off"):
        qk.agent_operands(pop, 3, "cpu")
    assert set(qk.launches()) == {"agent_step", "qsts_bus_reduce",
                                  "qsts_feeder_reduce"}


_BAD_SPECS = [
    dict(), dict(ev=-1), dict(ev=True), dict(ev=1, dr_events=9),
    dict(ev=1, ev_frac=1.5), dict(ev=1, dr_depth=-0.1),
    dict(ev=1, closed_loop=1), dict(ev=1, inv_frac=float("nan")),
]


@pytest.mark.parametrize("kw", _BAD_SPECS)
def test_validate_agent_spec_messages_match_reference(kw):
    with pytest.raises(ValueError) as want:
        ref.validate_agent_spec(ref.AgentSpec(**kw))
    with pytest.raises(ValueError) as got:
        agents.validate_agent_spec(agents.AgentSpec(**kw))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("payload", [
    "not-an-object", {"evs": 3}, {"ev": "three"}, {"ev": 0}, {"ev": 200},
    {"ev": 90}, {"ev": 3, "dr_events": 12}, {"ev": 3, "bogus": 1, "x": 2},
    {"ev": 40, "thermostat": 11},
])
def test_parse_agents_field_messages_match_reference(payload):
    with pytest.raises(RefInvalidRequest) as want:
        ref.parse_agents_field(payload, 2, max_agents=100, max_cells=100)
    with pytest.raises(InvalidRequest) as got:
        agents.parse_agents_field(payload, 2, max_agents=100, max_cells=100)
    assert str(got.value) == str(want.value)
    spec = agents.parse_agents_field({"ev": 3, "closed_loop": False}, 2,
                                     max_agents=100, max_cells=1000)
    assert spec.ev == 3 and spec.closed_loop is False


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kw,n_case", [(SMALL, None),
                                       (dict(ev=40000, thermostat=30000,
                                             inverter=15000, dr=15000),
                                        "case_ieee30")])
@pytest.mark.parametrize("closed", [True, False])
def test_a1_matches_plain_on_card(cuda_device, kw, n_case, closed):
    from freedm_tpu_torch.grid.matpower import load_builtin

    if n_case is None:
        n, p0 = 6, np.array([-1.0, -0.5, 0.0, -2.0, -0.3, 0.2])
    else:
        sys_ = load_builtin(n_case)
        n, p0 = sys_.n_bus, np.asarray(sys_.p_inj)
    lanes = 4
    (pop, st0, _), _ = _world(kw, n, p0, lanes=lanes)
    op = qk.agent_operands(pop, n, cuda_device)
    rng = np.random.default_rng(2)
    obs = torch.as_tensor(rng.uniform(0.88, 1.08, (lanes, n)),
                          device=cuda_device) if closed else None
    sig = torch.tensor([0.0, 1.0, 1.0, 0.0], dtype=F64, device=cuda_device)
    p_t = torch.as_tensor(rng.normal(size=(lanes, n)), device=cuda_device)
    q_t = torch.as_tensor(rng.normal(size=(lanes, n)), device=cuda_device)
    for h in HOURS:
        outs = []
        for fn in (qk.agent_step, qk.agent_step_plain, qk.agent_step):
            state = op.to_sorted(st0, lanes)
            bufs = [torch.zeros(lanes, n, dtype=F64, device=cuda_device)
                    for _ in range(2)]
            acc = [torch.full((lanes,), 0.5, dtype=F64, device=cuda_device)
                   for _ in range(3)]
            fn(op, state, obs, sig, h, 0.25, p_t, q_t, *bufs, *acc)
            outs.append(state + bufs + acc)
        torch.cuda.synchronize()
        kernel, plain, again = outs
        for a, b, c in zip(kernel, plain, again):
            assert torch.equal(a, c)  # bit-identical on repeat
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       rtol=1e-12, atol=1e-13)
        assert torch.equal(kernel[2], plain[2])  # th_on
