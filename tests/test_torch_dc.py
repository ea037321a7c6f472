"""DC screening of the PyTorch port against the JAX package.

``freedm_tpu_torch.pf.dc`` and the ``dc_prefilter`` of
``freedm_tpu_torch.pf.n1.make_n1_screen`` against ``freedm_tpu.pf.dc``
and ``freedm_tpu.pf.n1`` (CPU, x64) on the same networks, float64:

- ``make_dc_solver``: ``solve`` (one ``[n]`` vector and ``[L, n]``
  lanes) and ``screen_outages`` within 1e-10 of the reference (two LU
  libraries), ``islanded`` exactly, on mesh118 and case14 (whose bridge
  branches island);
- the prefilter: the same shortlist in the same order, bridges flagged
  and excluded, equal-severity ties in request order, and the AC lanes
  within 1e-9 pu on the SMW screen; on the sparse one within 1e-7 pu
  (each package on its own bf16 preconditioner pair at the default
  tolerance, where a lane may stop one step apart: see
  ``tests/test_torch_n1.py``);
- the serving cache's ``CaseEntry.dc_solver()``: built once, on the
  entry's own B′ pair, with no second factorization.

The ``cuda``-marked test holds D1 to its plain version on the card
(``chip_smoke.py`` does so at full size).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freedm_tpu.grid import cases as ref_cases
from freedm_tpu.grid import matpower as ref_matpower
from freedm_tpu.grid.bus import BusSystem as RefBusSystem
from freedm_tpu.pf.dc import make_dc_solver as ref_make_dc_solver
from freedm_tpu.pf.n1 import make_n1_screen as ref_make_n1_screen
from freedm_tpu_torch.grid.bus import PQ, SLACK, BusSystem
from freedm_tpu_torch.kernels import screen_kernels as sck
from freedm_tpu_torch.pf.dc import (dc_operands, make_dc_solver,
                                    outage_columns)
from freedm_tpu_torch.pf.fdlf import decoupled_parts
from freedm_tpu_torch.pf.n1 import make_n1_screen, secure_outages
from freedm_tpu_torch.serve.cache import ServeCache

ATOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(ref):
    return ref, BusSystem.from_arrays(dataclasses.asdict(ref))


@pytest.fixture(scope="module")
def mesh118():
    return _pair(ref_cases.synthetic_mesh(118, seed=1, load_mw=10.0,
                                          chord_frac=1.0))


@pytest.fixture(scope="module")
def case14():
    return _pair(ref_matpower.load_builtin("case14"))


def _small(bus_type, p, q, f, t):
    """A small network in both packages (r = 0.01, x = 0.1 pu)."""
    n, m = len(bus_type), len(f)
    fields = dict(
        bus_type=np.asarray(bus_type), p_inj=np.asarray(p, float),
        q_inj=np.asarray(q, float), v_set=np.ones(n), g_shunt=np.zeros(n),
        b_shunt=np.zeros(n), from_bus=np.asarray(f), to_bus=np.asarray(t),
        r=np.full(m, 0.01), x=np.full(m, 0.1), b_chg=np.zeros(m),
        tap=np.ones(m), shift=np.zeros(m))
    return RefBusSystem(**fields).validate(), BusSystem.from_arrays(fields)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def test_dc_solve_matches_reference(mesh118):
    ref, sys = mesh118
    dc, want = make_dc_solver(sys, device="cpu"), ref_make_dc_solver(ref)
    r, w = dc.solve(), want.solve()
    assert r.theta.shape == (sys.n_bus,) and r.flows.shape == (sys.n_branch,)
    _close(r.theta, w.theta)
    _close(r.flows, w.flows)
    lanes = np.stack([sys.p_inj * s for s in (0.8, 1.0, 1.2)])
    lanes[1, 5] += 0.3
    r, w = dc.solve(lanes), want.solve(jnp.asarray(lanes))
    assert r.theta.shape == (3, sys.n_bus)
    _close(r.theta, w.theta)
    _close(r.flows, w.flows)
    # Row i of a lane stack is the solo solve of row i.
    solo = dc.solve(lanes[2])
    _close(r.theta[2], solo.theta.numpy(), atol=1e-13)


def _dc_oracle(sys, outage):
    """Dense re-factorization of the outaged B′ (numpy)."""
    parts = decoupled_parts(sys, device="cpu")
    b = parts.b_prime(None).numpy()
    tf = parts.th_free.numpy()
    a = np.zeros(sys.n_bus)
    fb, tb = int(sys.from_bus[outage]), int(sys.to_bus[outage])
    a[fb] += tf[fb]
    a[tb] -= tf[tb]
    b = b - np.outer(a, a) / float(sys.x[outage])
    return np.linalg.solve(b, np.where(tf > 0, sys.p_inj, 0.0))


def test_dc_screen_matches_reference_and_refactorization(mesh118):
    ref, sys = mesh118
    ks = np.arange(sys.n_branch)
    r = make_dc_solver(sys, device="cpu").screen_outages(ks)
    w = ref_make_dc_solver(ref).screen_outages(jnp.asarray(ks))
    np.testing.assert_array_equal(r.islanded.numpy(), np.asarray(w.islanded))
    live = ~r.islanded.numpy()
    for k in ("theta", "flows", "severity"):
        np.testing.assert_allclose(getattr(r, k).numpy()[live],
                                   np.asarray(getattr(w, k))[live], rtol=0,
                                   atol=ATOL, err_msg=k)
    assert np.all(np.isinf(r.severity.numpy()[~live]))
    for i, k in enumerate([120, 127, 140, 160]):
        np.testing.assert_allclose(r.theta[k].numpy(), _dc_oracle(sys, k),
                                   rtol=0, atol=1e-9)
        assert float(r.flows[k, k]) == 0.0  # the outaged branch is empty
    # An injection vector given: the screen of those injections.
    p = np.asarray(sys.p_inj) * 1.1
    r2 = make_dc_solver(sys, device="cpu").screen_outages([130], p=p)
    w2 = ref_make_dc_solver(ref).screen_outages(jnp.asarray([130]),
                                                p=jnp.asarray(p))
    _close(r2.theta, w2.theta)


def test_dc_bridge_outages_flag_islanded_as_the_reference(case14):
    ref, sys = case14
    ks = np.arange(sys.n_branch)
    r = make_dc_solver(sys, device="cpu").screen_outages(ks)
    w = ref_make_dc_solver(ref).screen_outages(jnp.asarray(ks))
    isl = r.islanded.numpy()
    np.testing.assert_array_equal(isl, np.asarray(w.islanded))
    bridges = sorted(set(range(sys.n_branch)) - set(secure_outages(sys)))
    assert bridges and np.flatnonzero(isl).tolist() == bridges
    assert np.all(np.isinf(r.severity.numpy()[isl]))
    np.testing.assert_allclose(r.severity.numpy()[~isl],
                               np.asarray(w.severity)[~isl], rtol=0,
                               atol=ATOL)
    # The radial three-bus system: its second branch islands bus 2.
    ref3, sys3 = _small([SLACK, PQ, PQ], [0.0, -0.5, -0.3], [0.0] * 3,
                        [0, 1], [1, 2])
    r3 = make_dc_solver(sys3, device="cpu").screen_outages([1])
    w3 = ref_make_dc_solver(ref3).screen_outages(jnp.asarray([1]))
    assert bool(r3.islanded[0]) and bool(w3.islanded[0])
    assert np.isinf(float(r3.severity[0]))


def _bridge_and_triangle():
    """Buses 0-1 by a bridge, 1-2-3 a triangle: outage 0 islands."""
    return _small([SLACK, PQ, PQ, PQ], [0.0, -0.3, -0.4, -0.3],
                  [0.0, -0.1, -0.1, -0.1], [0, 1, 2, 3], [1, 2, 3, 1])


def test_dc_prefilter_excludes_islanding_bridges_as_the_reference():
    ref, sys = _bridge_and_triangle()
    got = make_n1_screen(sys, max_iter=24, dc_prefilter=2, device="cpu")(
        np.array([1, 2, 0]))
    want = ref_make_n1_screen(ref, max_iter=24, dc_prefilter=2)(
        np.array([1, 2, 0]))
    np.testing.assert_array_equal(got.islanded, [False, False, True])
    np.testing.assert_array_equal(got.islanded, want.islanded)
    np.testing.assert_array_equal(got.outages, want.outages)
    assert 0 not in got.outages and got.outages.shape == (2,)
    np.testing.assert_allclose(got.dc_severity, want.dc_severity, rtol=0,
                               atol=ATOL)
    assert bool(got.result.converged.all())
    np.testing.assert_allclose(got.result.v.numpy(), np.asarray(want.result.v),
                               rtol=0, atol=1e-9)
    screen = make_n1_screen(sys, max_iter=24, dc_prefilter=2, device="cpu")
    with pytest.raises(ValueError, match="islands the network"):
        screen(np.array([0]))


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_dc_prefilter_shortlist_matches_reference(mesh118, backend):
    """The DC-worst four of sixteen chord outages (a repeated outage
    among them: equal severities keep request order), the same list in
    the same order as the reference's, and their AC lanes."""
    ref, sys = mesh118
    ks = np.concatenate([np.arange(118, 134), [121]])
    got = make_n1_screen(sys, max_iter=24, dc_prefilter=4, backend=backend,
                         device="cpu")(ks)
    want = ref_make_n1_screen(ref, max_iter=24, dc_prefilter=4,
                              backend=backend)(ks)
    np.testing.assert_array_equal(got.outages, want.outages)
    np.testing.assert_array_equal(got.islanded, want.islanded)
    np.testing.assert_allclose(got.dc_severity_all, want.dc_severity_all,
                               rtol=0, atol=ATOL)
    assert np.all(np.diff(got.dc_severity) <= 0)
    assert got.dc_severity[0] == np.max(got.dc_severity_all)
    sev = got.dc_severity_all
    order = np.argsort(-sev, kind="stable")[:4]
    np.testing.assert_array_equal(got.outages, ks[order])
    assert bool(got.result.converged.all())
    assert got.result.v.shape == (4, sys.n_bus)
    np.testing.assert_allclose(got.result.v.numpy(),
                               np.asarray(want.result.v), rtol=0,
                               atol=1e-9 if backend == "dense" else 1e-7)


def test_cache_entry_dc_solver_reuses_the_entrys_b_prime(case14,
                                                         monkeypatch):
    """``CaseEntry.dc_solver()`` is built once, on the entry's own B′ LU
    pair: no ``torch.linalg.lu_factor`` runs while it is built, and its
    answers are those of a DC solver that factorizes B′ itself."""
    ref, sys = case14
    cache = ServeCache(max_bytes=32 << 20, device="cpu")
    ent = cache.entry("case14", sys, "dense")
    ent.build_artifacts()
    calls = []
    real = torch.linalg.lu_factor

    def counting(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(torch.linalg, "lu_factor", counting)
    dc = ent.dc_solver()
    assert ent.dc_solver() is dc  # built once
    assert calls == []  # the cached LU was reused
    monkeypatch.undo()
    r = dc.solve()
    assert r.theta.shape == (14,) and torch.isfinite(r.theta).all()
    _close(r.theta, make_dc_solver(sys, device="cpu").solve().theta.numpy(),
           atol=1e-13)
    _close(r.theta, ref_make_dc_solver(ref).solve().theta)


def test_dc_arguments_are_typed(case14):
    _, sys = case14
    with pytest.raises(TypeError, match="float64"):
        make_dc_solver(sys, dtype=torch.float32, device="cpu")
    if not torch.cuda.is_available():  # device=None is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_dc_solver(sys)


def test_dc_flows_take_any_lane_layout(mesh118):
    """D1's SOLVE mode reads its angle lanes through their strides: the
    lu_solve answer transposed (column-major lanes) gives the flows of the
    same lanes laid out row-major."""
    _, sys = mesh118
    dc = make_dc_solver(sys, device="cpu")
    theta = torch.as_tensor(np.random.default_rng(2).normal(
        size=(sys.n_bus, 5))).mT
    op = dc_operands(sys, device="cpu")
    assert torch.equal(sck.dc_flows(theta, op),
                       sck.dc_flows(theta.contiguous(), op))
    assert dc.n_bus == sys.n_bus and dc.n_branch == sys.n_branch
    # The update columns: e_f - e_t, a pinned (slack) end masked out.
    cols = outage_columns(op, torch.as_tensor([0, 130]))
    assert cols.shape == (2, sys.n_bus)
    for row, k in zip(cols, (0, 130)):
        f, t = int(sys.from_bus[k]), int(sys.to_bus[k])
        want = torch.zeros(sys.n_bus, dtype=torch.float64)
        want[f] += op.th_free[f]
        want[t] -= op.th_free[t]
        assert torch.equal(row, want)


@pytest.mark.cuda
def test_dc_screen_kernel_matches_plain_on_card(case14, mesh118):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    for _, sys in (case14, mesh118):
        dc = make_dc_solver(sys, device="cuda")
        plain = make_dc_solver(sys, device="cuda", plain=True)
        ks = np.arange(sys.n_branch)
        got, want = dc.screen_outages(ks), plain.screen_outages(ks)
        again = dc.screen_outages(ks)
        assert torch.equal(got.islanded, want.islanded)
        for k in ("theta", "flows", "severity"):
            assert torch.equal(getattr(got, k), getattr(again, k))
            torch.testing.assert_close(getattr(got, k), getattr(want, k),
                                       rtol=0, atol=1e-12)
        lanes = torch.randn(8, sys.n_bus, dtype=torch.float64, device="cuda")
        torch.testing.assert_close(dc.solve(lanes).flows,
                                   plain.solve(lanes).flows, rtol=0,
                                   atol=1e-12)
    torch.cuda.synchronize()
