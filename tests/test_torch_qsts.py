"""The port's QSTS engine against ``freedm_tpu.scenarios.engine``.

Both packages run the same studies chunk by chunk (``run_chunk``) and the
final carried states are compared array for array: bus studies within
1e-9 pu with equal iteration sums, worst counts and non-converged counts
(dense float64, warm and cold); the sparse backend in float64 within
1e-6 pu with iterations within one a lane-step; agent studies within
1e-9 with equal relays; feeder studies within 1e-9.  Summaries have the
reference's keys and types.  Within the port: kill and resume and a
different chunking give the same bits, a mismatched checkpoint restarts
clean, closed-loop differs from replayed, warm starts save iterations,
and a checkpoint the reference wrote resumes in the port.  The
``cuda``-marked tests hold Q1, Q2 and the engine's kernel path to their
plain versions on the card."""

import dataclasses

import numpy as np
import pytest
import torch

from freedm_tpu.scenarios import agents as ref_agents
from freedm_tpu.scenarios import engine as ref_engine
from freedm_tpu_torch.kernels import qsts_kernels as qk
from freedm_tpu_torch.scenarios import agents, engine

F64 = torch.float64
ATOL = 1e-9
SPARSE_ATOL = 1e-6
SMALL = dict(ev=12, thermostat=10, inverter=8, dr=6)
_SPEC = dict(case="case14", scenarios=3, steps=8, chunk_steps=3,
             dt_minutes=15.0, seed=2)
_AGENT_SPEC = dict(case="case14", scenarios=4, steps=12, dt_minutes=60.0,
                   chunk_steps=4, seed=7)
_FEEDER_SPEC = dict(case="vvc_9bus", scenarios=2, steps=4, chunk_steps=2,
                    dt_minutes=60.0, seed=1)
_SPARSE_SPEC = dict(case="mesh118", scenarios=2, steps=4, chunk_steps=2,
                    seed=3, pf_backend="sparse", pf_precision="f64")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is many small ops; on a shared host a
    multi-threaded pool spends longer waking its threads than computing,
    so these tests run torch on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _specs(kw, agents_kw=None):
    return (engine.StudySpec(**kw, agents=agents.AgentSpec(**agents_kw)
                             if agents_kw else None),
            ref_engine.StudySpec(**kw, agents=ref_agents.AgentSpec(**agents_kw)
                                 if agents_kw else None))


def _chunks(eng, state=None, first=0):
    spec = eng.spec
    state = eng.initial_state() if state is None else state
    for t0 in range(first * spec.chunk_steps, spec.steps, spec.chunk_steps):
        state = eng.run_chunk(state, t0, min(spec.steps, t0 + spec.chunk_steps))
    return state


_CACHE = {}


def _both(kw, agents_kw=None):
    """Final states and summaries of both packages (cached a module)."""
    key = (tuple(sorted(kw.items())), tuple(sorted((agents_kw or {}).items())))
    if key not in _CACHE:
        mine, theirs = _specs(kw, agents_kw)
        pe = engine.QstsEngine(mine, device="cpu")
        re_ = ref_engine.QstsEngine(theirs)
        ps, rs = _chunks(pe), _chunks(re_)
        _CACHE[key] = (ps, rs, pe.summarize(ps, mine.steps, 1.0),
                       re_.summarize(rs, theirs.steps, 1.0))
    return _CACHE[key]


def _compare_states(ps, rs, atol, int_exact=True):
    assert type(ps).__name__ == type(rs).__name__
    assert ps._fields == rs._fields
    for f in rs._fields:
        a, b = np.asarray(getattr(ps, f)), np.asarray(getattr(rs, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.dtype.kind in "iu":
            if int_exact:
                assert np.array_equal(a, b), f
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=f)


def _compare_summaries(mine, theirs, rtol):
    assert set(mine) == set(theirs)
    for k in theirs:
        assert type(mine[k]) is type(theirs[k]), k
        if isinstance(theirs[k], float):
            np.testing.assert_allclose(mine[k], theirs[k], rtol=rtol,
                                       atol=1e-6, err_msg=k)
        elif k != "wall_s":
            assert mine[k] == theirs[k], k


@pytest.mark.parametrize("warm", [True, False])
def test_bus_study_matches_reference(warm):
    kw = dict(_SPEC, warm_start=warm)
    ps, rs, msum, rsum = _both(kw)
    _compare_states(ps, rs, ATOL)
    _compare_summaries(msum, rsum, 1e-9)
    assert msum["pf_backend"] == "dense" and msum["pf_precision"] == "f64"


def test_sparse_f64_study_matches_reference():
    ps, rs, msum, rsum = _both(_SPARSE_SPEC)
    _compare_states(ps, rs, SPARSE_ATOL, int_exact=False)
    # Iterations within one a lane-step; the flags equal.
    steps = _SPARSE_SPEC["steps"]
    assert np.all(np.abs(ps.it_sum - rs.it_sum) <= steps)
    assert abs(int(ps.it_max) - int(rs.it_max)) <= 1
    assert int(ps.nonconv) == int(rs.nonconv) == 0
    assert set(msum) == set(rsum)
    assert msum["pf_backend"] == "sparse"


def test_agent_study_matches_reference():
    ps, rs, msum, rsum = _both(_AGENT_SPEC, SMALL)
    _compare_states(ps, rs, ATOL)
    assert np.array_equal(ps.th_on, rs.th_on)
    _compare_summaries(msum, rsum, 1e-9)


def test_feeder_study_matches_reference():
    ps, rs, msum, rsum = _both(_FEEDER_SPEC)
    _compare_states(ps, rs, ATOL)
    _compare_summaries(msum, rsum, 1e-9)
    assert msum["solver"] == "ladder" and msum["warm_start"] is False


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference writes a checkpoint after one chunk; the port resumes
    it and ends where the reference's uninterrupted run ends."""
    mine, theirs = _specs(_AGENT_SPEC, SMALL)
    ck = str(tmp_path / "ref.json")
    ref_engine.run_study(theirs, checkpoint_path=ck, stop_after_chunks=1)
    out = engine.run_study(mine, checkpoint_path=ck, device="cpu")
    assert out["resumed_from_chunk"] == 1 and out["completed"]
    from freedm_tpu_torch.runtime import checkpoint

    pe = engine.QstsEngine(mine, device="cpu")
    final = pe.state_from_jsonable(checkpoint.load(ck)["state"])
    _, rs, _, _ = _both(_AGENT_SPEC, SMALL)
    _compare_states(final, rs, ATOL)


# ---------------------------------------------------------------------------
# Within the port
# ---------------------------------------------------------------------------


def _run(spec, **kw):
    return engine.run_study(spec, device="cpu", **kw)


def _same(a, b):
    assert engine.strip_timing(a) == engine.strip_timing(b)


@pytest.mark.parametrize("agents_kw", [None, SMALL])
def test_resume_from_chunk_checkpoint_is_exact(tmp_path, agents_kw):
    spec, _ = _specs(_AGENT_SPEC if agents_kw else _SPEC, agents_kw)
    ck = str(tmp_path / "study.json")
    partial = _run(spec, checkpoint_path=ck, stop_after_chunks=1)
    assert partial["completed"] is False and partial["chunks_done"] == 1
    resumed = _run(spec, checkpoint_path=ck)
    assert resumed["resumed_from_chunk"] == 1
    _same(resumed, _run(spec))


def test_agent_summary_stamped_and_chunking_invariant():
    spec, _ = _specs(_AGENT_SPEC, SMALL)
    s = _run(spec)
    assert s["agents_total"] == sum(SMALL.values())
    assert s["agents_closed_loop"] is True
    assert s["agent_energy_puh_mean"] > 0 and s["agent_steps_per_sec"] > 0
    assert s["lane_steps_not_converged"] == 0
    other = _run(dataclasses.replace(spec, chunk_steps=5))
    drop = ("chunks_total", "compiles")
    a = {k: v for k, v in engine.strip_timing(s).items() if k not in drop}
    b = {k: v for k, v in engine.strip_timing(other).items() if k not in drop}
    assert a == b


def test_mismatched_checkpoint_spec_restarts_clean(tmp_path):
    spec, _ = _specs(_AGENT_SPEC, SMALL)
    ck = str(tmp_path / "study.json")
    _run(spec, checkpoint_path=ck, stop_after_chunks=1)
    other = dataclasses.replace(
        spec, agents=dataclasses.replace(spec.agents, ev=13))
    s = _run(other, checkpoint_path=ck)
    assert s["resumed_from_chunk"] == 0 and s["completed"]
    # Placement is not identity: mesh_devices=1 resumes mesh_devices=0.
    _run(spec, checkpoint_path=ck, stop_after_chunks=1)
    s = _run(dataclasses.replace(spec, mesh_devices=1), checkpoint_path=ck)
    assert s["resumed_from_chunk"] == 1


def test_closed_loop_diverges_from_replayed():
    spec, _ = _specs(_AGENT_SPEC, SMALL)
    closed = _run(spec)
    replayed = _run(dataclasses.replace(
        spec, agents=dataclasses.replace(spec.agents, closed_loop=False)))
    assert replayed["agents_closed_loop"] is False
    # The flat 1.0 pu observation sits in every inverter's deadband.
    assert replayed["agent_q_peak_pu"] == 0.0
    assert closed["agent_q_peak_pu"] > 0.0
    assert closed["energy_loss_mwh_mean"] != replayed["energy_loss_mwh_mean"]


def test_warm_start_saves_iterations_and_two_chunk_lengths():
    _, _, warm, _ = _both(_SPEC)
    _, _, cold, _ = _both(dict(_SPEC, warm_start=False))
    assert cold["iters_mean"] > warm["iters_mean"]
    # 8 steps in chunks of 3: lengths 3 and the ragged 2.
    assert warm["compiles"] == 2
    s = _run(engine.StudySpec(**_SPEC))
    assert s["compiles"] == 2 and s["completed"]
    assert s["lane_steps_not_converged"] == 0 and s["energy_balance_ok"]


def test_engine_refusals():
    with pytest.raises(ValueError, match="bus case"):
        engine.QstsEngine(engine.StudySpec(
            **_FEEDER_SPEC, agents=agents.AgentSpec(ev=2)), device="cpu")
    with pytest.raises(NotImplementedError, match="item 16"):
        engine.QstsEngine(engine.StudySpec(**_SPEC, mesh_devices=4),
                          device="cpu")
    for field, value, msg in (("profile", "lunar", "unknown profile"),
                              ("pf_backend", "banded", "unknown pf_backend"),
                              ("pf_precision", "bf16",
                               "unknown pf_precision")):
        with pytest.raises(ValueError, match=msg):
            engine.QstsEngine(engine.StudySpec(**{**_SPEC, field: value}),
                              device="cpu")
    eng = engine.QstsEngine(engine.StudySpec(**_SPEC), device="cpu")
    with pytest.raises(ValueError, match="different StudySpec"):
        engine.run_study(engine.StudySpec(**{**_SPEC, "seed": 9}), engine=eng)
    assert set(eng.wall_split) == {"materialize", "copy_in", "steps",
                                   "copy_out"}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")
    return torch.device("cuda")


def _acc(lanes, dev, seed):
    rng = np.random.default_rng(seed)

    def f(lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, lanes), device=dev)

    def i(hi):
        return torch.as_tensor(rng.integers(0, hi, lanes).astype(np.int32),
                               device=dev)

    return qk.StepAcc(f(0, 5), f(0, 1), i(50), i(5), i(3), f(0.9, 1.1),
                      f(0.9, 1.1), f(0, 1))


def _clone(acc):
    return qk.StepAcc(*(t.clone() for t in acc))


def _acc_close(a, b, again):
    for x, y, z in zip(a, b, again):
        assert torch.equal(x, z)
        if x.dtype == torch.int32:
            assert torch.equal(x, y)
    for x, y in ((a.v_lo, b.v_lo), (a.v_hi, b.v_hi)):
        assert torch.equal(x, y)
    for x, y in ((a.viol, b.viol), (a.loss, b.loss), (a.peak, b.peak)):
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(),
                                   rtol=1e-12, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case,lanes", [("case_ieee30", 1), ("mesh118", 8)])
def test_q1_matches_plain_on_card(cuda_device, case, lanes):
    from freedm_tpu_torch.pf.newton import make_newton_solver
    from freedm_tpu_torch.serve.service import _resolve_bus_case

    sys_ = _resolve_bus_case(case)
    rng = np.random.default_rng(4)
    scale = rng.uniform(0.6, 1.2, (lanes, 1))
    solve, _ = make_newton_solver(sys_, backend="dense", device=cuda_device)
    r = solve(p_inj=scale * sys_.p_inj, q_inj=scale * sys_.q_inj)
    op = qk.bus_reduce_operands(sys_, cuda_device)
    acc0 = _acc(lanes, cuda_device, 5)
    outs = []
    for fn in (qk.qsts_bus_reduce, qk.qsts_bus_reduce_plain,
               qk.qsts_bus_reduce):
        acc = _clone(acc0)
        fn(r.v, r.theta, r.p, r.iterations, r.converged, op, acc, 15.0,
           0.25, 0.95, 1.05)
        outs.append(acc)
    torch.cuda.synchronize()
    _acc_close(*outs)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 64, 256])
def test_q1_plans_on_card(cuda_device, lanes):
    """Q1 at mesh2000 (a lane on one CTA of 512 threads): counts, envelope
    and peak equal to the plain version's, the losses within 1e-12 and bit
    for bit the host mirror's; staged or not, the same bits."""
    from freedm_tpu_torch.serve.service import _resolve_bus_case

    sys_ = _resolve_bus_case("mesh2000")
    n = sys_.n_bus
    rng = np.random.default_rng(lanes)
    v = torch.as_tensor(rng.uniform(0.93, 1.07, (lanes, n)),
                        device=cuda_device)
    th = torch.as_tensor(rng.normal(0.0, 0.3, (lanes, n)),
                         device=cuda_device)
    p = torch.as_tensor(rng.normal(0.0, 1.0, (lanes, n)), device=cuda_device)
    it = torch.as_tensor(rng.integers(1, 9, lanes).astype(np.int32),
                         device=cuda_device)
    conv = torch.as_tensor(rng.uniform(size=lanes) > 0.1, device=cuda_device)
    op = qk.bus_reduce_operands(sys_, cuda_device)
    acc0 = _acc(lanes, cuda_device, 5)

    def run(fn, **kw):
        acc = _clone(acc0)
        fn(v, th, p, it, conv, op, acc, 15.0, 0.25, 0.95, 1.05, **kw)
        return acc

    got = run(qk.qsts_bus_reduce)
    _acc_close(got, run(qk.qsts_bus_reduce_plain), run(qk.qsts_bus_reduce))
    assert torch.equal(got.peak, run(qk.qsts_bus_reduce_plain).peak)
    for x, y in zip(got, run(qk.bus_reduce_mirror)):
        assert torch.equal(x, y)
    for staged in (True, False):
        plan = qk.BusReducePlan(staged, qk.bus_reduce_smem(n, staged))
        for x, y in zip(got, run(qk.qsts_bus_reduce, plan=plan)):
            assert torch.equal(x, y), plan


@pytest.mark.cuda
def test_q2_matches_plain_on_card(cuda_device):
    from freedm_tpu_torch.grid.cases import vvc_9bus
    from freedm_tpu_torch.pf.ladder import make_ladder_solver

    f = vvc_9bus()
    steps, lanes = 6, 8
    scale = np.random.default_rng(6).uniform(0.5, 1.3, (steps * lanes, 1, 1))
    solve, _ = make_ladder_solver(f, device=cuda_device)
    r = solve(scale * f.s_load)
    op = qk.feeder_reduce_operands(f, cuda_device)
    acc0 = _acc(lanes, cuda_device, 7)
    outs = []
    for fn in (qk.qsts_feeder_reduce, qk.qsts_feeder_reduce_plain,
               qk.qsts_feeder_reduce):
        acc = _clone(acc0)
        fn(r, op, acc, steps, 60.0, 1.0, 0.95, 1.05)
        outs.append(acc)
    torch.cuda.synchronize()
    _acc_close(*outs)


@pytest.mark.cuda
@pytest.mark.parametrize("kw,agents_kw", [(_SPEC, None),
                                          (_AGENT_SPEC, SMALL),
                                          (_FEEDER_SPEC, None)])
def test_engine_kernel_path_matches_plain_on_card(cuda_device, kw, agents_kw):
    spec, _ = _specs(kw, agents_kw)
    qk.reset_launches()
    got = _chunks(engine.QstsEngine(spec, device=cuda_device))
    launched = qk.launches()
    want = _chunks(engine.QstsEngine(spec, device=cuda_device, plain=True))
    _compare_states(got, want, ATOL)
    if agents_kw:
        assert launched["agent_step"] == kw["steps"]
        assert np.array_equal(got.th_on, want.th_on)
    key = "qsts_feeder_reduce" if kw is _FEEDER_SPEC else "qsts_bus_reduce"
    assert launched[key] > 0
