"""The port's serving cache (exact, delta and warm tiers) against the JAX
package's ``freedm_tpu.serve.cache``.

Programs, on seeded numpy inputs handed to both packages, float64:

- ``make_injection_fn`` gives the reference's P and Q (1e-12: the same
  operations, sin and cos from two libraries);
- ``smw_delta_solve`` at rank 0 and rank 2, with ``z``/``cap``
  precomputed and a structured ``vt`` (1e-10: two LU libraries);
- the delta program (``_build_delta_program``) from the same cached base
  solution over the same 1-16-bus deltas: f64 within 1e-9 pu with the
  same sweep counts and the same ``err < tol`` outcomes; mixed within
  2e-4 pu and sweeps within ±1;
- C1's plain version in every mode against the reference's injections
  and mismatch formula (1e-12), its float32 copies bit for bit, and the
  frozen-lane bookkeeping.

Then the service contracts of ``tests/test_serve_cache.py``, re-run
against the port on ``device="cpu"``, and the digests and byte accounting
against the reference's.  The ``cuda``-marked test holds C1 to its plain
version on the card (``chip_smoke.py`` does so at full size).
"""

import dataclasses
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from freedm_tpu.grid import cases as ref_cases
from freedm_tpu.grid import matpower as ref_matpower
from freedm_tpu.pf.krylov import build_fdlf_precond as ref_build_fdlf_precond
from freedm_tpu.pf.mfree import make_injection_fn as ref_make_injection_fn
from freedm_tpu.pf.n1 import smw_delta_solve as ref_smw_delta_solve
from freedm_tpu.pf.newton import make_newton_solver as ref_make_newton_solver
from freedm_tpu.serve import cache as ref_cache
from freedm_tpu.serve.service import ServeConfig as RefServeConfig
from freedm_tpu.serve.service import Service as RefService
from freedm_tpu_torch.core import metrics as M
from freedm_tpu_torch.grid.bus import BusSystem
from freedm_tpu_torch.kernels import cache_kernels as ck
from freedm_tpu_torch.pf.krylov import build_fdlf_precond
from freedm_tpu_torch.pf.mfree import delta_operands, make_injection_fn
from freedm_tpu_torch.pf.n1 import smw_delta_solve
from freedm_tpu_torch.serve.cache import (
    DELTA_MAX_SWEEPS,
    ServeCache,
    _build_delta_program,
    injection_digest,
    topology_digest,
)
from freedm_tpu_torch.serve.queue import ServeError
from freedm_tpu_torch.serve.service import (PowerFlowRequest, ServeConfig,
                                            Service)

F64 = torch.float64
TOL = 1e-8  # the engines' float64 tolerance, the delta program's exit bar
BUCKETS = (1, 2, 4)
T = 300  # per-request timeout


def _ref_system(name):
    if name.startswith("mesh"):
        return ref_cases.synthetic_mesh(int(name[4:]), seed=1, load_mw=10.0,
                                        chord_frac=1.0)
    return ref_matpower.load_builtin(name)


def _systems(name):
    ref = _ref_system(name)
    return ref, BusSystem.from_arrays(dataclasses.asdict(ref))


def _deltas(sys, rng, count):
    """``count`` requests, each moving 1-16 buses by up to ±0.05 pu in P
    and ±0.02 pu in Q from the case's own injections."""
    out = []
    for _ in range(count):
        p = np.asarray(sys.p_inj, np.float64).copy()
        q = np.asarray(sys.q_inj, np.float64).copy()
        k = int(min(rng.integers(1, 17), sys.n_bus))
        for j in rng.choice(sys.n_bus, size=k, replace=False):
            p[j] += rng.uniform(-0.05, 0.05)
            q[j] += rng.uniform(-0.02, 0.02)
        out.append((p, q))
    return out


# ---------------------------------------------------------------------------
# Programs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["mesh118", "case14"])
def test_injection_fn_matches_reference(name):
    ref, sys = _systems(name)
    n = sys.n_bus
    rng = np.random.default_rng(3 + n)
    theta = rng.uniform(-0.3, 0.3, (3, n))
    v = rng.uniform(0.9, 1.1, (3, n))
    ref_inject = ref_make_injection_fn(ref, jnp.float64)
    inject = make_injection_fn(sys, device="cpu")
    p, q = inject(torch.as_tensor(theta), torch.as_tensor(v))
    for b in range(3):
        rp, rq = ref_inject(jnp.asarray(theta[b]), jnp.asarray(v[b]))
        assert np.max(np.abs(p[b].numpy() - np.asarray(rp))) <= 1e-12
        assert np.max(np.abs(q[b].numpy() - np.asarray(rq))) <= 1e-12
        p1, q1 = inject(torch.as_tensor(theta[b]), torch.as_tensor(v[b]))
        assert torch.equal(p1, p[b]) and torch.equal(q1, q[b])
    # A per-lane branch status: the reference's make_injection_fn(...,
    # status), each lane its own row, within 1e-12.
    status = (rng.uniform(size=(3, sys.n_branch)) > 0.2).astype(np.float64)
    p, q = inject(torch.as_tensor(theta), torch.as_tensor(v), status=status)
    for b in range(3):
        rp, rq = ref_inject(jnp.asarray(theta[b]), jnp.asarray(v[b]),
                            status=jnp.asarray(status[b]))
        assert np.max(np.abs(p[b].numpy() - np.asarray(rp))) <= 1e-12
        assert np.max(np.abs(q[b].numpy() - np.asarray(rq))) <= 1e-12


def _smw_problem(n=30, k=2, seed=4):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n)) + n * np.eye(n)
    return (a, rng.normal(size=(n, k)), rng.normal(size=(n, k)),
            rng.normal(size=n), rng.normal(size=(n, 3)))


@pytest.mark.parametrize("form", ["rank0", "rank0_columns", "rank2",
                                  "rank2_precomputed", "rank2_vt"])
def test_smw_delta_solve_matches_reference(form):
    a, u, vv, b, bm = _smw_problem()
    ref_lu = jax.scipy.linalg.lu_factor(jnp.asarray(a))
    lu = torch.linalg.lu_factor(torch.as_tensor(a))
    tu, tv, tb = (torch.as_tensor(x) for x in (u, vv, b))
    if form == "rank0":
        want = ref_smw_delta_solve(ref_lu, None, None, jnp.asarray(b))
        got = smw_delta_solve(lu, None, None, tb)
    elif form == "rank0_columns":
        want = ref_smw_delta_solve(ref_lu, None, None, jnp.asarray(bm))
        got = smw_delta_solve(lu, None, None, torch.as_tensor(bm))
    elif form == "rank2":
        want = ref_smw_delta_solve(ref_lu, jnp.asarray(u), jnp.asarray(vv),
                                   jnp.asarray(b))
        got = smw_delta_solve(lu, tu, tv, tb)
    elif form == "rank2_precomputed":
        z = np.linalg.solve(a, u)
        cap = np.eye(2) + vv.T @ z
        want = ref_smw_delta_solve(ref_lu, None, jnp.asarray(vv),
                                   jnp.asarray(b), z=jnp.asarray(z),
                                   cap=jnp.asarray(cap))
        got = smw_delta_solve(lu, None, tv, tb, z=torch.as_tensor(z),
                              cap=torch.as_tensor(cap))
    else:
        idx = np.array([3, 17])
        mask = np.array([1.0, 0.0])
        vt_ref = lambda x: x[idx] * (mask if x.ndim == 1 else mask[:, None])  # noqa: E731
        vt = lambda x: x[torch.as_tensor(idx)] * torch.as_tensor(  # noqa: E731
            mask if x.dim() == 1 else mask[:, None])
        want = ref_smw_delta_solve(ref_lu, jnp.asarray(u), None,
                                   jnp.asarray(b), vt=vt_ref)
        got = smw_delta_solve(lu, tu, None, tb, vt=vt)
        # The identity itself: (A + U Vᵀ) x = b with Vᵀ the masked gather.
        vfull = np.zeros((30, 2))
        vfull[idx, [0, 1]] = mask
        assert np.allclose((a + u @ vfull.T) @ got.numpy(), b, atol=1e-10)
    assert got.shape == tuple(want.shape)
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= 1e-10


@pytest.fixture(scope="module", params=["mesh118", "case14"])
def base(request):
    """``(reference system, port system, converged base (theta, v))`` —
    the reference's own solve, handed to both programs."""
    ref, sys = _systems(request.param)
    solve, _ = ref_make_newton_solver(ref)
    r = solve()
    assert bool(r.converged)
    return ref, sys, np.asarray(r.theta), np.asarray(r.v)


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_delta_program_matches_reference(base, precision):
    ref, sys, th0, v0 = base
    ref_fn = ref_cache._build_delta_program(
        ref, ref_build_fdlf_precond(ref, dtype=jnp.float64, kind="lu"), TOL,
        DELTA_MAX_SWEEPS, jnp.float64, precision=precision)
    fn = _build_delta_program(
        sys, build_fdlf_precond(sys, kind="lu", device="cpu"), TOL,
        DELTA_MAX_SWEEPS, precision=precision, device="cpu")
    rng = np.random.default_rng(17 + sys.n_bus)
    deltas = _deltas(sys, rng, 6)
    bound = 1e-9 if precision == "f64" else 2e-4
    for p, q in deltas:
        want = ref_fn(th0, v0, p, q)
        got = fn(th0, v0, p, q)
        for k in range(4):  # theta, v, p_calc, q_calc
            assert np.max(np.abs(got[k].numpy() - np.asarray(want[k]))) \
                <= bound, k
        sweeps, ref_sweeps = int(got[5]), int(want[5])
        if precision == "f64":
            assert sweeps == ref_sweeps
        else:
            assert abs(sweeps - ref_sweeps) <= 1
        assert (float(got[4]) < TOL) == (float(want[4]) < TOL)
        assert 0 < sweeps <= DELTA_MAX_SWEEPS
    # The same deltas as lanes of one call: each lane stops on its own
    # (a lane that is done no longer updates), so every lane is the
    # single-request answer.
    lanes = fn(np.repeat(th0[None], len(deltas), 0),
               np.repeat(v0[None], len(deltas), 0),
               np.stack([p for p, _ in deltas]),
               np.stack([q for _, q in deltas]))
    for b, (p, q) in enumerate(deltas):
        one = fn(th0, v0, p, q)
        assert int(lanes[5][b]) == int(one[5])
        for k in range(4):
            assert float((lanes[k][b] - one[k]).abs().max()) <= 1e-12


def test_delta_program_stops_at_max_sweeps(base):
    """A lane that cannot clear the bar runs exactly ``max_sweeps`` sweeps
    and reports its last mismatch, as the reference's while_loop does."""
    ref, sys, th0, v0 = base
    p = np.asarray(sys.p_inj, np.float64) * 1.4
    q = np.asarray(sys.q_inj, np.float64)
    ref_fn = ref_cache._build_delta_program(
        ref, ref_build_fdlf_precond(ref, dtype=jnp.float64, kind="lu"),
        1e-15, 3, jnp.float64)
    fn = _build_delta_program(sys, build_fdlf_precond(sys, kind="lu",
                                                      device="cpu"),
                              1e-15, 3, device="cpu")
    want, got = ref_fn(th0, v0, p, q), fn(th0, v0, p, q)
    assert int(got[5]) == int(want[5]) == 3
    assert abs(float(got[4]) - float(want[4])) <= 1e-9
    assert np.max(np.abs(got[1].numpy() - np.asarray(want[1]))) <= 1e-9


@pytest.fixture(scope="module", params=["mesh118", "case14"])
def c1_case(request):
    """Seeded lanes for C1: ``(reference system, operands, theta, v, ps,
    qs, s)``, three lanes."""
    ref, sys = _systems(request.param)
    n = sys.n_bus
    rng = np.random.default_rng(29 + n)
    theta = rng.uniform(-0.3, 0.3, (3, n))
    v = rng.uniform(0.9, 1.1, (3, n))
    ps, qs, s = (rng.normal(size=(3, n)) * 0.1 for _ in range(3))
    return (ref, delta_operands(sys, device="cpu"),
            *(torch.as_tensor(a) for a in (theta, v, ps, qs, s)))


def _ref_mismatch(ref, theta, v, ps, qs):
    """The reference's injections and its mismatch formula, lane by
    lane, in numpy: ``(P, Q, dp, dq, err)``."""
    inject = ref_make_injection_fn(ref, jnp.float64)
    th_free = (np.asarray(ref.bus_type) != 2).astype(np.float64)
    v_free = (np.asarray(ref.bus_type) == 0).astype(np.float64)
    out = [[] for _ in range(5)]
    for b in range(theta.shape[0]):
        p, q = (np.asarray(a) for a in inject(jnp.asarray(theta[b]),
                                              jnp.asarray(v[b])))
        dp = (ps[b] - p) / v[b] * th_free
        dq = (qs[b] - q) / v[b] * v_free
        for k, a in enumerate((p, q, dp, dq, max(np.max(np.abs(dp * v[b])),
                                                  np.max(np.abs(dq * v[b]))))):
            out[k].append(a)
    return [np.array(a) for a in out]


@pytest.mark.parametrize("s_dtype", [F64, torch.float32])
def test_c1_plain_version_in_every_mode(c1_case, s_dtype):
    ref, op, theta, v, ps, qs, s = c1_case
    s = s.to(s_dtype)
    ck.reset_launches()
    state = ck.new_state(3, "cpu")
    state.active[:] = torch.tensor([True, True, False])
    # INIT overwrites active from it and err (it = 0 < max_sweeps).
    x, dp, dq, lo = ck.delta_mismatch_plain(ck.INIT, theta, v, ps, qs, op,
                                      state=state, lo=True, max_sweeps=5,
                                      tol=TOL)
    want = _ref_mismatch(ref, theta.numpy(), v.numpy(), ps.numpy(),
                         qs.numpy())
    assert x is None and torch.equal(lo, dp.to(torch.float32))
    assert np.max(np.abs(dp.numpy() - want[2])) <= 1e-12
    assert np.max(np.abs(dq.numpy() - want[3])) <= 1e-12
    assert np.max(np.abs(state.err.numpy() - want[4])) <= 1e-12
    assert state.active.tolist() == [True] * 3
    # THETA with lane 2 frozen: its theta is copied, lanes 0-1 corrected.
    state.active[2] = False
    th1, dp, dq, lo = ck.delta_mismatch_plain(ck.THETA, theta, v, ps, qs, op, s,
                                        state, lo=True)
    s64 = s.to(F64)
    want_th = torch.where(torch.tensor([[True], [True], [False]]),
                          theta + s64 * op.th_free, theta)
    assert torch.equal(th1, want_th)
    assert torch.equal(lo, dq.to(torch.float32))
    want = _ref_mismatch(ref, th1.numpy(), v.numpy(), ps.numpy(), qs.numpy())
    assert np.max(np.abs(dq.numpy() - want[3])) <= 1e-12
    # V: lane 0 converges (tol above its err), lane 1 does not, lane 2 is
    # frozen and keeps err, it and active.
    state.it[:] = torch.tensor([2, 4, 1], dtype=torch.int32)
    state.err[2] = 123.0
    v1, dp, dq, lo = ck.delta_mismatch_plain(ck.V, th1, v, ps, qs, op, s, state,
                                       lo=True, max_sweeps=5, tol=TOL)
    assert torch.equal(v1[2], v[2])
    assert torch.equal(v1[:2], (v + s64 * op.v_free)[:2])
    want = _ref_mismatch(ref, th1.numpy(), v1.numpy(), ps.numpy(),
                         qs.numpy())
    assert np.max(np.abs(dp.numpy() - want[2])) <= 1e-12
    assert torch.equal(lo, dp.to(torch.float32))
    assert np.max(np.abs(state.err[:2].numpy() - want[4][:2])) <= 1e-12
    assert float(state.err[2]) == 123.0
    # Lane 1 reached it = 5 = max_sweeps: done whatever its err.
    assert state.it.tolist() == [3, 5, 1]
    assert state.active.tolist() == [True, False, False]
    # A zero correction leaves v1 and the mismatch; a bar between the two
    # smallest lane errors retires exactly the lane with the smallest.
    errs = np.sort(want[4])
    bar = float(errs[0] + errs[1]) / 2
    state.active[:] = True
    state.it[:] = 0
    ck.delta_mismatch_plain(ck.V, th1, v1, ps, qs, op, s * 0, state,
                      max_sweeps=50, tol=bar)
    assert state.active.tolist() == (want[4] >= bar).tolist()
    assert state.active.sum() == 2 and state.it.tolist() == [1, 1, 1]
    _, p, q, lo = ck.delta_mismatch_plain(ck.PQ, th1, v1, ps, qs, op)
    assert lo is None
    assert np.max(np.abs(p.numpy() - want[0])) <= 1e-12
    assert np.max(np.abs(q.numpy() - want[1])) <= 1e-12
    # The plain version counts no launch.
    assert ck.launches() == {"delta_program": 0}
    with pytest.raises(ValueError, match="unknown delta_mismatch mode"):
        ck.delta_mismatch_plain(7, theta, v, ps, qs, op, state=state)


def test_c1_wrapper_refuses_bad_inputs_before_any_launch(c1_case):
    """The validator a program built for the card runs once, before its
    first launch (a CPU program runs the plain version and never reaches
    it), and the program's refusal of other devices."""
    ref, op, *_ = c1_case
    sys = BusSystem.from_arrays(dataclasses.asdict(ref))
    pc = build_fdlf_precond(sys, kind="lu", device="cpu")
    dev = torch.device("cpu")
    ck._check_program(op, pc.bp, pc.bq, dev)
    bad = op._replace(y=op.y[:, :-1])
    with pytest.raises(ValueError, match="contiguous"):
        ck._check_program(bad, pc.bp, pc.bq, dev)
    with pytest.raises(ValueError, match="float64"):
        ck._check_program(op._replace(g_sh=op.g_sh.float()), pc.bp, pc.bq,
                          dev)
    with pytest.raises(ValueError, match="int32"):
        ck._check_program(op._replace(inc_ptr=op.inc_ptr.long()), pc.bp,
                          pc.bq, dev)
    with pytest.raises(ValueError, match="LU factor"):
        ck._check_program(op, (pc.bp[0].float(), pc.bp[1]), pc.bq, dev)
    with pytest.raises(ValueError, match="pivots"):
        ck._check_program(op, pc.bp, (pc.bq[0], pc.bq[1][:-1]), dev)
    meta = op._replace(g_sh=op.g_sh.to("meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ck.DeltaProgram(meta, pc.bp, pc.bq, 5, TOL)


@pytest.mark.parametrize("name", ["case14", "case_ieee30", "mesh118"])
def test_digests_equal_the_reference(name):
    ref, sys = _systems(name)
    assert topology_digest(sys) == ref_cache.topology_digest(ref)
    rng = np.random.default_rng(1)
    p, q = rng.normal(size=sys.n_bus), rng.normal(size=sys.n_bus)
    assert injection_digest(p, q) == ref_cache.injection_digest(p, q)
    assert injection_digest(np.asarray(sys.p_inj), np.asarray(sys.q_inj)) \
        == ref_cache.injection_digest(np.asarray(ref.p_inj),
                                      np.asarray(ref.q_inj))


@pytest.mark.parametrize("name,backend", [("case14", "dense"),
                                          ("mesh600", "sparse")])
def test_entry_byte_accounting_equals_the_reference(name, backend):
    ref, sys = _systems(name)
    ref_entry = ref_cache.ServeCache(max_bytes=64 << 20).entry(name, ref,
                                                               backend)
    entry = ServeCache(max_bytes=64 << 20, device="cpu").entry(name, sys,
                                                               backend)
    assert entry.artifact_bytes == ref_entry.artifact_bytes > 0
    assert (entry.pattern is None) == (backend == "dense")
    assert entry.key == ref_entry.key
    dc = entry.dc_solver()  # the DC screen on the entry's own B′ pair
    assert entry.dc_solver() is dc


# ---------------------------------------------------------------------------
# Service contracts (tests/test_serve_cache.py, against the port)
# ---------------------------------------------------------------------------


def _cfg(**kw):
    base = dict(max_batch=4, max_wait_ms=5.0, queue_depth=64,
                buckets=BUCKETS, device="cpu")
    base.update(kw)
    return ServeConfig(**base)


@pytest.fixture(scope="module")
def svc():
    s = Service(_cfg())
    # Prime the base case once: every test below starts from a warm
    # engine and a populated base entry.
    r = s.request("pf", PowerFlowRequest(case="case14", timeout_s=T))
    assert r.converged and r.batch.tier == "full"
    yield s
    s.stop()


@pytest.fixture(scope="module")
def cold_svc():
    """The cache-off service the correctness tests compare against."""
    s = Service(_cfg(cache_mb=0.0))
    yield s
    s.stop()


def _base_inj(svc):
    eng = svc.engine("pf", "case14")
    return np.array(eng._p0), np.array(eng._q0)


def test_default_config_builds_a_cache():
    cfg = ServeConfig()
    assert (cfg.cache_mb, cfg.cache_ttl_s, cfg.delta_max_rank,
            cfg.cache_verify_tol) == (64.0, 600.0, 16, None)
    ref = RefServeConfig()
    assert (cfg.cache_mb, cfg.cache_ttl_s, cfg.delta_max_rank,
            cfg.cache_verify_tol) == (ref.cache_mb, ref.cache_ttl_s,
                                      ref.delta_max_rank,
                                      ref.cache_verify_tol)
    s = Service(ServeConfig(device="cpu"), start=False)
    try:
        assert s.cache is not None and s.cache.max_bytes == 64 << 20
        assert s.cache.precision == "f64"  # auto on the CPU
    finally:
        s.stop()


def test_exact_hit_serves_from_cache_without_dispatch(svc):
    before = M.SERVE_BATCH_LANES.labels("pf").count
    r1 = svc.request("pf", PowerFlowRequest(case="case14", timeout_s=T))
    r2 = svc.request("pf", PowerFlowRequest(case="case14", timeout_s=T,
                                            return_state=True))
    assert r1.batch.tier == "exact" and r2.batch.tier == "exact"
    assert r1.batch.bucket == 0 and r1.batch.solve_ms == 0.0
    assert M.SERVE_BATCH_LANES.labels("pf").count == before
    assert r2.converged and len(r2.v) == 14
    assert r1.iterations == r2.iterations
    assert svc.stats()["cache"]["hits"]["exact"] >= 2


def test_delta_hits_match_full_solves_across_random_deltas(svc, cold_svc):
    """Random small-rank injection deltas answered by the delta tier agree
    with cache-off full solves within 1e-6 pu, each with a host-verified
    residual."""
    p0, q0 = _base_inj(svc)
    rng = np.random.default_rng(11)
    served_delta = 0
    for _ in range(5):
        p = p0.copy()
        q = q0.copy()
        for j in rng.choice(14, size=rng.integers(1, 4), replace=False):
            p[j] += rng.uniform(-0.05, 0.05)
            q[j] += rng.uniform(-0.02, 0.02)
        req = dict(case="case14", p_inj=p.tolist(), q_inj=q.tolist(),
                   return_state=True, timeout_s=T)
        warm = svc.request("pf", PowerFlowRequest(**req))
        full = cold_svc.request("pf", PowerFlowRequest(**req))
        assert warm.converged and full.converged
        if warm.batch.tier == "delta":
            served_delta += 1
            assert warm.residual_pu <= 1e-8  # host-verified, not claimed
            assert warm.batch.bucket == 0
        assert np.max(np.abs(np.array(warm.v) - np.array(full.v))) < 1e-6
        assert np.max(np.abs(np.array(warm.theta)
                             - np.array(full.theta))) < 1e-6
    assert served_delta >= 4


def test_delta_residual_fallthrough_never_serves_unverified(svc):
    """An impossible verify bar makes every delta attempt fall through: the
    answer comes from a warm-seeded full solve and the delta count holds."""
    p0, q0 = _base_inj(svc)
    p = p0.copy()
    p[2] += 0.031
    cache = svc.cache
    before = dict(svc.stats()["cache"]["hits"])
    old_tol = cache.verify_tol
    cache.verify_tol = 1e-300
    try:
        r = svc.request("pf", PowerFlowRequest(
            case="case14", p_inj=p.tolist(), q_inj=q0.tolist(), timeout_s=T))
    finally:
        cache.verify_tol = old_tol
    assert r.converged and r.batch.tier == "full"
    after = svc.stats()["cache"]["hits"]
    assert after["delta"] == before["delta"]
    assert after["warm"] == before["warm"] + 1


def test_warm_tier_seeds_and_cuts_iterations(svc, cold_svc):
    warm = svc.request("pf", PowerFlowRequest(case="case14", scale=1.35,
                                              timeout_s=T))
    cold = cold_svc.request("pf", PowerFlowRequest(case="case14", scale=1.35,
                                                   timeout_s=T))
    assert warm.converged and cold.converged
    assert warm.batch.tier == "full"
    assert warm.iterations < cold.iterations
    assert svc.stats()["cache"]["hits"]["warm"] >= 1


def test_client_supplied_seed_bypasses_cache_both_ways():
    svc3 = Service(_cfg(delta_max_rank=0))
    try:
        r0 = svc3.request("pf", PowerFlowRequest(
            case="case14", return_state=True, timeout_s=T))
        before = svc3.stats()["cache"]
        seeded = PowerFlowRequest(case="case14", scale=1.28, v0=r0.v,
                                  theta0=r0.theta, timeout_s=T)
        r = svc3.request("pf", seeded)
        assert r.converged and r.batch.tier == "full"
        after = svc3.stats()["cache"]
        assert after["hits"] == before["hits"]
        assert after["misses"] == before["misses"]
        flat = PowerFlowRequest(case="case14", scale=1.28, timeout_s=T)
        assert svc3.request("pf", flat).batch.tier == "full"
        assert svc3.request("pf", flat).batch.tier == "exact"
    finally:
        svc3.stop()


def test_topology_mutation_means_stale_entry_unreachable():
    _, sys14 = _systems("case14")
    mutated = dataclasses.replace(
        sys14, x=np.array(sys14.x) * np.where(
            np.arange(sys14.n_branch) == 3, 1e6, 1.0)
    )
    assert topology_digest(sys14) != topology_digest(mutated)
    cache = ServeCache(max_bytes=32 << 20, device="cpu")
    e1 = cache.entry("case14", sys14, "dense")
    p, q = np.array(sys14.p_inj), np.array(sys14.q_inj)
    dig = injection_digest(p, q)
    cache.insert(e1, dig, p, q, np.ones(14), np.zeros(14), p, q, 3,
                 1e-10, True)
    assert cache.lookup(e1, dig, p, q)[0] == "exact"
    e2 = cache.entry("case14", mutated, "dense")
    assert e2 is not e1 and e2.key != e1.key
    assert cache.lookup(e2, dig, p, q)[0] == "miss"


def test_service_invalidate_drops_entries(svc):
    svc.request("pf", PowerFlowRequest(case="case14", timeout_s=T))
    assert svc.stats()["cache"]["solutions"] >= 1
    assert svc.cache.invalidate("case14") >= 1
    r = svc.request("pf", PowerFlowRequest(case="case14", timeout_s=T))
    assert r.batch.tier == "full"  # nothing stale survived to answer
    assert svc.stats()["cache"]["evictions"]["invalidate"] >= 1


def test_lru_eviction_under_tiny_budget():
    _, sys14 = _systems("case14")
    cache = ServeCache(max_bytes=5500, device="cpu")
    ent = cache.entry("case14", sys14, "dense")
    assert ent is not None and ent.artifact_bytes > 0
    p0, q0 = np.array(sys14.p_inj), np.array(sys14.q_inj)
    digs = []
    for i in range(6):
        p = p0 + 0.01 * (i + 1)
        d = injection_digest(p, q0)
        digs.append(d)
        cache.insert(ent, d, p, q0, np.ones(14), np.zeros(14), p, q0,
                     3, 1e-10, True)
        assert cache.bytes <= cache.max_bytes
    assert cache.stats()["evictions"]["lru"] >= 4
    assert cache.lookup(ent, digs[0], p0 + 0.01, q0)[0] != "exact"
    assert cache.lookup(ent, digs[-1], p0 + 0.06, q0)[0] == "exact"


def test_over_budget_case_is_never_cached():
    _, sys14 = _systems("case14")
    assert ServeCache(max_bytes=1024, device="cpu").entry(
        "case14", sys14, "dense") is None


def test_ttl_expiry_evicts_at_next_touch():
    _, sys14 = _systems("case14")
    cache = ServeCache(max_bytes=32 << 20, ttl_s=0.05, device="cpu")
    ent = cache.entry("case14", sys14, "dense")
    p, q = np.array(sys14.p_inj), np.array(sys14.q_inj)
    dig = injection_digest(p, q)
    cache.insert(ent, dig, p, q, np.ones(14), np.zeros(14), p, q, 3,
                 1e-10, True)
    assert cache.lookup(ent, dig, p, q)[0] == "exact"
    time.sleep(0.08)
    assert cache.lookup(ent, dig, p, q)[0] == "miss"
    assert cache.stats()["evictions"]["ttl"] >= 1


def test_cold_herd_populates_once():
    svc2 = Service(_cfg(delta_max_rank=0))
    try:
        svc2.request("pf", PowerFlowRequest(case="case14", timeout_s=T))
        before = M.SERVE_BATCH_LANES.labels("pf").count
        req = PowerFlowRequest(case="case14", scale=0.93, timeout_s=T)
        n = 6
        barrier = threading.Barrier(n)
        results = [None] * n

        def worker(i):
            barrier.wait(timeout=60)
            results[i] = svc2.request("pf", req)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=T)
        assert all(r is not None and r.converged for r in results)
        vals = {(r.iterations, r.residual_pu, r.v_min_pu) for r in results}
        assert len(vals) == 1  # everyone got the leader's solution
        assert M.SERVE_BATCH_LANES.labels("pf").count == before + 1
        st = svc2.stats()["cache"]
        assert st["flight_joins"] + st["hits"]["exact"] >= n - 1
        tiers = sorted(r.batch.tier for r in results)
        assert tiers.count("full") == 1 and tiers.count("exact") == n - 1
    finally:
        svc2.stop()


def test_flight_followers_fail_with_their_leader():
    svc2 = Service(_cfg(), start=False)
    try:
        req = PowerFlowRequest(case="case14", timeout_s=T)
        f_lead = svc2.submit("pf", req)
        f_join = svc2.submit("pf", req)
        assert svc2.queue.depth_lanes == 1  # the follower is parked
        eng = svc2.engine("pf", "case14")
        eng.solve = lambda batch: (_ for _ in ()).throw(
            RuntimeError("injected cold-solve crash"))
        svc2.start()
        for f in (f_lead, f_join):
            with pytest.raises(ServeError) as ei:
                f.result(timeout=T)
            assert ei.value.code == "internal"
    finally:
        svc2.stop()


def test_invalidate_mid_flight_insert_lands_nowhere():
    svc2 = Service(_cfg(delta_max_rank=0), start=False)
    try:
        req = PowerFlowRequest(case="case14", timeout_s=T)
        f_lead = svc2.submit("pf", req)
        f_join = svc2.submit("pf", req)
        assert svc2.cache.invalidate("case14") == 0  # entries, no solutions
        svc2.start()
        r_lead = f_lead.result(timeout=T)
        r_join = f_join.result(timeout=T)
        assert r_lead.converged and r_join.converged
        assert r_lead.batch.tier == "full"
        assert r_join.batch.tier == "exact" and r_join.batch.bucket == 0
        st = svc2.stats()["cache"]
        assert st["entries"] == 0 and st["solutions"] == 0
    finally:
        svc2.stop()


def _strip_batch(resp) -> str:
    d = resp.to_dict()
    tier = d.pop("batch")["tier"]
    return json.dumps({"tier": tier, **d}, sort_keys=True)


def _ladder(p0, q0):
    p_d = p0.copy()
    p_d[4] += 0.02
    return [
        PowerFlowRequest(case="case14", timeout_s=T),
        PowerFlowRequest(case="case14", timeout_s=T),  # exact
        PowerFlowRequest(case="case14", p_inj=p_d.tolist(),
                         q_inj=q0.tolist(), return_state=True,
                         timeout_s=T),  # delta
        PowerFlowRequest(case="case14", scale=1.35, timeout_s=T),  # warm
    ]


def test_depth0_oracle_byte_identity_with_cache_on():
    svc_pipe = Service(_cfg(pipeline_depth=2))
    svc_ser = Service(_cfg(pipeline_depth=0))
    try:
        ladder = _ladder(*_base_inj(svc_pipe))
        got_p = [_strip_batch(svc_pipe.request("pf", r)) for r in ladder]
        got_s = [_strip_batch(svc_ser.request("pf", r)) for r in ladder]
        assert got_p == got_s
        assert [json.loads(g)["tier"] for g in got_p] == [
            "full", "exact", "delta", "full"]
    finally:
        svc_pipe.stop()
        svc_ser.stop()


def test_tier_ladder_matches_the_reference_service():
    """The same ladder (cold, exact, delta, warm) through the reference's
    default-cache service and the port's: the same tiers and iteration
    counts, answers within 1e-9 pu."""
    ref = RefService(RefServeConfig(max_batch=4, max_wait_ms=5.0,
                                    queue_depth=64, buckets=BUCKETS))
    port = Service(_cfg())
    try:
        ladder = _ladder(*_base_inj(port))
        for req in ladder:
            want = ref.request("pf", req)
            got = port.request("pf", req)
            assert got.batch.tier == want.batch.tier
            assert got.iterations == want.iterations
            assert got.converged and want.converged
            for k in ("p_balance_pu", "q_balance_pu", "v_min_pu",
                      "v_max_pu"):
                assert abs(getattr(got, k) - getattr(want, k)) <= 1e-9, k
            if want.v is not None:
                np.testing.assert_allclose(got.v, want.v, atol=1e-9)
        assert port.stats()["cache"]["hits"] == ref.stats()["cache"]["hits"]
    finally:
        port.stop()
        ref.stop()


def test_prewarm_builds_delta_program():
    svc2 = Service(_cfg(prewarm=("pf/case14",)))
    try:
        ent = svc2.cache.entry(
            "case14", svc2.engine("pf", "case14")._sys, "dense")
        assert ent is not None and ent.delta_fn is not None
    finally:
        svc2.stop()


def test_stats_expose_cache_block(svc):
    st = svc.stats()["cache"]
    assert st["enabled"] is True
    for key in ("bytes", "budget_bytes", "entries", "solutions", "hits",
                "misses", "evictions", "hit_ratio", "flight_joins",
                "errors"):
        assert key in st
    assert st["bytes"] <= st["budget_bytes"]
    assert st["errors"] == 0
    svc_off = Service(_cfg(cache_mb=0.0), start=False)
    assert svc_off.stats()["cache"] == {"enabled": False}
    svc_off.stop()


def test_cache_tier_failure_is_counted_and_served_full(caplog):
    """A delta program that raises (a kernel build or launch failure on
    the card) costs the request its delta answer, not the answer: it is
    served by a full solve, the failure is counted in /stats and
    ``serve_cache_errors_total``, and the first one is logged."""
    svc2 = Service(_cfg())
    try:
        p0, q0 = _base_inj(svc2)
        r = svc2.request("pf", PowerFlowRequest(case="case14", timeout_s=T))
        assert r.batch.tier == "full"
        # The base solution is inserted after its future resolves: wait
        # for it, so each delta request below reaches the delta tier.
        deadline = time.monotonic() + 10
        while svc2.batcher.busy() and time.monotonic() < deadline:
            time.sleep(0.005)

        def boom(*args, **kwargs):
            raise RuntimeError("delta_mismatch kernel launch failed")

        svc2.cache.delta_answer = boom
        before = M.SERVE_CACHE_ERRORS.value
        for k in (2, 3):
            p = p0.copy()
            p[k] += 0.02
            with caplog.at_level("ERROR"):
                r = svc2.request("pf", PowerFlowRequest(
                    case="case14", p_inj=p.tolist(), q_inj=q0.tolist(),
                    timeout_s=T))
            assert r.converged and r.batch.tier == "full"
        assert svc2.stats()["cache"]["errors"] == 2
        assert M.SERVE_CACHE_ERRORS.value == before + 2
        logged = [rec for rec in caplog.records
                  if "cache tier failed" in rec.getMessage()]
        assert len(logged) == 1 and logged[0].exc_info is not None
    finally:
        svc2.stop()


def _ieee30_base():
    ref, sys = _systems("case_ieee30")
    solve, _ = ref_make_newton_solver(ref)
    r = solve()
    return sys, r


def test_delta_mixed_precision_verified_by_f64_oracle():
    sys_, r = _ieee30_base()
    p0 = np.asarray(sys_.p_inj, np.float64)
    q0 = np.asarray(sys_.q_inj, np.float64)
    answers = {}
    for prec in ("mixed", "f64"):
        cache = ServeCache(max_bytes=64 << 20, precision=prec, device="cpu")
        entry = cache.entry("case_ieee30", sys_, "dense")
        assert entry.precision == prec
        cache.insert(
            entry, injection_digest(p0, q0), p0, q0,
            np.asarray(r.v), np.asarray(r.theta), np.asarray(r.p),
            np.asarray(r.q), int(np.asarray(r.iterations)),
            float(np.asarray(r.mismatch)), True,
        )
        p1 = p0.copy()
        p1[5] += 0.01
        tier, near = cache.lookup(entry, injection_digest(p1, q0), p1, q0)
        assert tier == "delta"
        ans = cache.delta_answer(entry, near, p1, q0)
        assert ans is not None, f"{prec} delta fell through"
        assert ans["mismatch"] <= entry.tol
        answers[prec] = ans
    dv = float(np.max(np.abs(answers["mixed"]["v"] - answers["f64"]["v"])))
    assert dv < 1e-6, dv


def _combined(cache, entry, near, reqs, q):
    """``delta_answer`` for each of ``reqs`` from a thread of its own,
    all queued while the program lock is held, so one program call takes
    them all: the answers, or the exceptions raised."""
    out = [None] * len(reqs)

    def one(i):
        try:
            out[i] = cache.delta_answer(entry, near, reqs[i], q)
        except Exception as e:  # noqa: BLE001 — returned to the test
            out[i] = e

    with cache._delta_run:
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        while len(cache._delta_jobs) < len(reqs):
            assert time.monotonic() < deadline
            time.sleep(0.001)
    for t in threads:
        t.join(30)
    return out


def _ieee30_cache():
    sys_, r = _ieee30_base()
    p0 = np.asarray(sys_.p_inj, np.float64)
    q0 = np.asarray(sys_.q_inj, np.float64)
    cache = ServeCache(max_bytes=64 << 20, precision="f64", device="cpu")
    entry = cache.entry("case_ieee30", sys_, "dense")
    near = cache.insert(
        entry, injection_digest(p0, q0), p0, q0,
        np.asarray(r.v), np.asarray(r.theta), np.asarray(r.p),
        np.asarray(r.q), int(np.asarray(r.iterations)),
        float(np.asarray(r.mismatch)), True,
    )
    return cache, entry, near, p0, q0


def test_concurrent_delta_answers_run_as_lanes_of_one_program():
    """Delta requests that queue while a program runs are answered by one
    program call, a lane each, with the answer each gets alone."""
    cache, entry, near, p0, q0 = _ieee30_cache()
    rng = np.random.default_rng(5)
    reqs = []
    for _ in range(4):
        p = p0.copy()
        p[rng.choice(30, size=2, replace=False)] += rng.uniform(-0.03, 0.03,
                                                                2)
        reqs.append(p)
    alone = [cache.delta_answer(entry, near, p, q0) for p in reqs]
    runs = cache.stats()["delta_runs"]
    assert runs == len(reqs)
    together = _combined(cache, entry, near, reqs, q0)
    assert cache.stats()["delta_runs"] == runs + 1
    for a, b in zip(alone, together):
        assert a is not None and isinstance(b, dict)
        assert b["iterations"] == a["iterations"]
        for k in ("theta", "v", "p", "q"):
            assert np.max(np.abs(b[k] - a[k])) <= 1e-12
        assert b["mismatch"] <= entry.tol


def test_failing_delta_program_raises_in_every_combined_caller():
    cache, entry, near, p0, q0 = _ieee30_cache()

    def boom(*args):
        raise RuntimeError("delta_mismatch kernel launch failed")

    entry.ensure_delta_fn()
    entry.delta_fn = boom
    p1, p2 = p0.copy(), p0.copy()
    p1[3] += 0.01
    p2[4] += 0.01
    out = _combined(cache, entry, near, [p1, p2], q0)
    assert all(isinstance(e, RuntimeError) for e in out), out
    assert cache.stats()["delta_runs"] == 1
    assert not cache._delta_jobs


def test_delta_mixed_fallthrough_on_verify_miss():
    sys_, r = _ieee30_base()
    p0 = np.asarray(sys_.p_inj, np.float64)
    q0 = np.asarray(sys_.q_inj, np.float64)
    cache = ServeCache(max_bytes=64 << 20, precision="mixed",
                       verify_tol=1e-16, device="cpu")
    entry = cache.entry("case_ieee30", sys_, "dense")
    cache.insert(
        entry, injection_digest(p0, q0), p0, q0,
        np.asarray(r.v), np.asarray(r.theta), np.asarray(r.p),
        np.asarray(r.q), 3, 1e-10, True,
    )
    p1 = p0.copy()
    p1[5] += 0.01
    tier, near = cache.lookup(entry, injection_digest(p1, q0), p1, q0)
    assert tier == "delta"
    assert cache.delta_answer(entry, near, p1, q0) is None


@pytest.mark.parametrize("precision,platform_device,want", [
    ("auto", "cpu", "f64"), ("f64", "cpu", "f64"), ("mixed", "cpu", "mixed"),
])
def test_cache_precision_resolves_and_validates(precision, platform_device,
                                                want):
    assert ServeCache(max_bytes=1 << 20, precision=precision,
                      device=platform_device).precision == want
    assert ref_cache.ServeCache(max_bytes=1 << 20,
                                precision=precision).precision == want
    with pytest.raises(ValueError):
        ServeCache(max_bytes=1 << 20, precision="nope", device="cpu")


# ---------------------------------------------------------------------------
# On the card (skipped on the CPU)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mesh118", "case14"])
def test_c1_matches_plain_version_on_card(cuda_device, name):
    """C1, the whole delta program in one launch, against its plain
    version (the host loop around ``torch.linalg.lu_solve``) on 1 and 8
    random deltas from a converged base, f64 and mixed, within
    ``chip_smoke.PROGRAM_ATOL``, bit-identical on repeat, and beside the
    plain loop on the mirror's solves (``chip_smoke.compare_program``)."""
    case = chip_smoke.DeltaCase(torch, ck, name, dev=cuda_device)
    for lanes in (1, 8):
        for precision in ("f64", "mixed"):
            chip_smoke.compare_program(torch, ck, case, lanes, precision,
                                       seed=lanes, mirror=lanes == 1)
