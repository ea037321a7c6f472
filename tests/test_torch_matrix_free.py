"""Parity of the port's matrix-free Newton–Krylov solver with the JAX
package.

J1's plain version (the residual's JVP, written out branch by branch) is
held to ``jax.jvp`` of the reference residual (``make_injection_fn`` and
the masks) at random points, with and without status: float64 within
1e-12 relative, float32 within 1e-5.  ``make_krylov_solver`` is held to
the reference's contracts (``tests/test_krylov.py:32-80`` at ≤ 300 buses;
``tests/test_precision.py:153-260`` for the krylov solver) and to the
reference's own solver lane by lane, both packages on the reference's
bf16 preconditioner pair: float64 at ``tol=1e-10`` (the verify skill's
note on the bf16 pair) with equal iterations and v/θ within 1e-9; mixed
with equal flags, iterations and fallbacks within ±1 and v within 2e-4
of the reference's mixed and f64.  The ``cuda``-marked test holds the
kernel path to the plain path on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freedm_tpu.grid.bus import PQ as REF_PQ
from freedm_tpu.grid.bus import SLACK as REF_SLACK
from freedm_tpu.grid.cases import synthetic_mesh as ref_synthetic_mesh
from freedm_tpu.grid.matpower import load_builtin as ref_load_builtin
from freedm_tpu.pf.krylov import build_fdlf_precond as ref_build_precond
from freedm_tpu.pf.krylov import make_krylov_solver as ref_make_krylov
from freedm_tpu.pf.mfree import make_injection_fn as ref_injection_fn
from freedm_tpu_torch.core import metrics as obs
from freedm_tpu_torch.grid.bus import BusSystem
from freedm_tpu_torch.kernels import solver_kernels as sol
from freedm_tpu_torch.pf.krylov import (FdlfPrecond, KrylovResult,
                                        build_fdlf_precond,
                                        host_injections, make_krylov_solver,
                                        record_result)
from freedm_tpu_torch.pf.mfree import residual_jvp
from freedm_tpu_torch.pf.newton import make_newton_solver
from freedm_tpu_torch.pf.sparse import (make_sparse_newton_solver,
                                        sparse_operands)

TOL = 1e-10  # the float64 solves' tolerance (module docstring)
MIXED_DV_BOUND = 2e-4
REF_MESH300 = ref_synthetic_mesh(300, seed=4, load_mw=2.0, chord_frac=1.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is thousands of tiny ops; on a shared host a
    multi-threaded pool spends longer waking its threads than computing."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port(ref):
    return BusSystem.from_arrays(dataclasses.asdict(ref))


def _pairs(ref):
    """The reference's bf16 pair and the same pair carried into the port."""
    pair = ref_build_precond(ref, dtype=jnp.float64)
    return pair, FdlfPrecond.from_arrays(np.asarray(pair.bp, np.float32),
                                         np.asarray(pair.bq, np.float32),
                                         device="cpu")


@pytest.fixture(scope="module")
def mesh300():
    return (REF_MESH300, _port(REF_MESH300)) + _pairs(REF_MESH300)


def _ill_conditioned(ref):
    """``tests/test_precision.py:46``: one chord's reactance shrunk 1e7×."""
    x = np.asarray(ref.x).copy()
    x[ref.n_bus + 5] *= 1e-7
    return dataclasses.replace(ref, x=x)


# ---------------------------------------------------------------------------
# J1's plain version against jax.jvp of the reference residual
# ---------------------------------------------------------------------------


def _ref_residual(ref):
    inj = ref_injection_fn(ref, jnp.float64)
    n = ref.n_bus
    th_free = jnp.asarray(ref.bus_type != REF_SLACK, jnp.float64)
    v_free = jnp.asarray(ref.bus_type == REF_PQ, jnp.float64)

    def resid(x, status):
        p, q = inj(x[:n], x[n:], status=status)
        return jnp.concatenate([
            jnp.where(th_free > 0, p - ref.p_inj, x[:n]),
            jnp.where(v_free > 0, q - ref.q_inj, x[n:] - ref.v_set)])

    return resid


@pytest.mark.parametrize("case", ["case_ieee30", "mesh118"])
@pytest.mark.parametrize("with_status", [False, True])
def test_j1_plain_version_matches_reference_jvp(case, with_status):
    ref = (ref_load_builtin(case) if case.startswith("case") else
           ref_synthetic_mesh(118, seed=1, load_mw=10.0, chord_frac=1.0))
    sys_ = _port(ref)
    n, m, lanes = sys_.n_bus, sys_.n_branch, 4
    rng = np.random.default_rng(8)
    x = np.concatenate([rng.normal(0, 0.2, (lanes, n)),
                        rng.uniform(0.9, 1.1, (lanes, n))], 1)
    u = rng.normal(size=(lanes, 2 * n))
    st = (rng.random((lanes, m)) > 0.1).astype(np.float64)
    resid = _ref_residual(ref)
    want = np.stack([np.asarray(jax.jvp(
        lambda z: resid(z, jnp.asarray(st[b]) if with_status else None),
        (jnp.asarray(x[b]),), (jnp.asarray(u[b]),))[1]) for b in range(lanes)])
    scale = np.abs(want).max()
    jvp = residual_jvp(sys_, device="cpu")
    got = jvp(x, u, st if with_status else None)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * scale)
    jvp32 = residual_jvp(sys_, dtype=torch.float32, device="cpu")
    got32 = jvp32(x, u, st if with_status else None)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), want, rtol=0, atol=1e-5 * scale)
    # Pinned rows pass u through.
    pinned = np.concatenate([sys_.bus_type == 2, sys_.bus_type != 0])
    np.testing.assert_array_equal(got.numpy()[:, pinned], u[:, pinned])


def test_j1_is_the_assembled_jacobian_times_u():
    """J1 against S1's assembled values through S2 (the same J u)."""
    from freedm_tpu_torch.kernels import sparse_kernels as sk

    sys_ = _port(ref_synthetic_mesh(60, seed=2))
    op = sparse_operands(sys_, device="cpu")
    rng = np.random.default_rng(1)
    n = sys_.n_bus
    x = torch.as_tensor(np.concatenate([rng.normal(0, 0.1, (3, n)),
                                        rng.uniform(0.95, 1.05, (3, n))], 1))
    u = torch.as_tensor(rng.normal(size=(3, 2 * n)))
    ps = torch.zeros(3, n, dtype=torch.float64)
    st = torch.as_tensor((rng.random((3, sys_.n_branch)) > 0.2) * 1.0)
    for status in (None, st):
        ev, bv, _ = sk.sparse_assemble(x, ps, ps, op, sk.FULL, status)
        want = sk.sparse_matvec(ev, bv, u, op)
        got = sol.residual_jvp(x, u, op, status)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-12 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# The solver: tests/test_krylov.py's contracts at <= 300 buses
# ---------------------------------------------------------------------------


def _compare_dense(sys_, atol, **kw):
    solve_d, _ = make_newton_solver(sys_, max_iter=12, device="cpu")
    solve_k, _ = make_krylov_solver(sys_, max_iter=15, device="cpu")
    rd, rk = solve_d(**kw), solve_k(**kw)
    assert isinstance(rk, KrylovResult)
    assert bool(rd.converged.all()) and bool(rk.converged.all())
    np.testing.assert_allclose(rk.v.numpy(), rd.v.numpy(), atol=atol)
    np.testing.assert_allclose(rk.theta.numpy(), rd.theta.numpy(),
                               atol=atol)


def test_matches_dense_newton_small_mesh(mesh300):
    _compare_dense(mesh300[1], atol=5e-9)


def test_matches_dense_on_real_ieee_case():
    _compare_dense(_port(ref_load_builtin("case_ieee30")), atol=1e-8)


def test_branch_outage_status_is_traced(mesh300):
    sys_ = mesh300[1]
    status = np.ones(sys_.n_branch)
    status[sys_.n_bus + 3] = 0.0  # a chord; the ring stays intact
    _compare_dense(sys_, atol=5e-9, status=status)


def test_injection_overrides_are_traced(mesh300):
    sys_ = mesh300[1]
    _compare_dense(sys_, atol=5e-9, p_inj=sys_.p_inj[None] * 1.1,
                   q_inj=sys_.q_inj[None] * 0.9)


def test_reports_nonconvergence():
    sys_ = _port(ref_synthetic_mesh(120, seed=4, load_mw=2.0,
                                    chord_frac=1.0))
    solve, _ = make_krylov_solver(sys_, max_iter=15, device="cpu")
    r = solve(p_inj=sys_.p_inj[None] * 500.0)
    assert not bool(r.converged[0])


# ---------------------------------------------------------------------------
# Lane-by-lane parity with the reference's solver
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lanes300(mesh300):
    """Four lanes at load scales 0.6-1.2 and two single-chord outages."""
    _, sys_, _, _ = mesh300
    scales = np.linspace(0.6, 1.2, 4)[:, None]
    status = np.ones((4, sys_.n_branch))
    status[1, sys_.n_bus + 7] = 0.0
    status[3, sys_.n_bus + 40] = 0.0
    return scales * sys_.p_inj, scales * sys_.q_inj, status


def _ref_lanes(mesh300, lanes, precision, fixed=False, **kw):
    ref, _, pair, _ = mesh300
    solve, solve_fixed = ref_make_krylov(ref, precond=pair, tol=TOL,
                                         precision=precision, **kw)
    fn = solve_fixed if fixed else solve
    return jax.vmap(lambda a, b, c: fn(p_inj=a, q_inj=b, status=c))(
        *(jnp.asarray(t) for t in lanes))


def _port_lanes(mesh300, lanes, precision, fixed=False, **kw):
    _, sys_, _, port_pair = mesh300
    solve, solve_fixed = make_krylov_solver(sys_, precond=port_pair,
                                            tol=TOL, precision=precision,
                                            device="cpu", **kw)
    p, q, st = lanes
    return (solve_fixed if fixed else solve)(p_inj=p, q_inj=q, status=st)


@pytest.mark.parametrize("fixed", [False, True])
def test_f64_lanes_match_reference(mesh300, lanes300, fixed):
    want = _ref_lanes(mesh300, lanes300, "f64", fixed, max_iter=8)
    got = _port_lanes(mesh300, lanes300, "f64", fixed, max_iter=8)
    assert got.iterations.tolist() == np.asarray(want.iterations).tolist()
    assert got.converged.tolist() == np.asarray(want.converged).tolist()
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.mismatch.numpy(),
                               np.asarray(want.mismatch), rtol=0, atol=1e-9)


@pytest.mark.parametrize("fixed", [False, True])
def test_mixed_lanes_match_reference(mesh300, lanes300, fixed):
    want = _ref_lanes(mesh300, lanes300, "mixed", fixed, max_iter=8)
    want64 = _ref_lanes(mesh300, lanes300, "f64", fixed, max_iter=8)
    got = _port_lanes(mesh300, lanes300, "mixed", fixed, max_iter=8)
    assert got.converged.tolist() == np.asarray(want.converged).tolist()
    assert np.all(np.abs(got.iterations.numpy()
                         - np.asarray(want.iterations)) <= 1)
    assert np.all(np.abs(got.fallbacks.numpy()
                         - np.asarray(want.fallbacks)) <= 1)
    for w in (want, want64):
        np.testing.assert_allclose(got.v.numpy(), np.asarray(w.v), rtol=0,
                                   atol=MIXED_DV_BOUND)


# ---------------------------------------------------------------------------
# tests/test_precision.py's contracts for the krylov solver
# ---------------------------------------------------------------------------


def test_mixed_krylov_matches_dense_and_f64(mesh300):
    """``tests/test_precision.py:153``."""
    sys_ = mesh300[1]
    solve_d, _ = make_newton_solver(sys_, max_iter=12, device="cpu")
    solve_f, _ = make_krylov_solver(sys_, max_iter=15, precision="f64",
                                    device="cpu")
    solve_m, _ = make_krylov_solver(sys_, max_iter=15, precision="mixed",
                                    device="cpu")
    rd, rf, rm = solve_d(), solve_f(), solve_m()
    assert bool(rd.converged[0]) and bool(rf.converged[0])
    assert bool(rm.converged[0])
    np.testing.assert_allclose(rm.v.numpy(), rd.v.numpy(),
                               atol=MIXED_DV_BOUND)
    np.testing.assert_allclose(rm.theta.numpy(), rd.theta.numpy(),
                               atol=MIXED_DV_BOUND)
    assert int(rm.fallbacks[0]) == 0 and int(rf.fallbacks[0]) == 0


def test_mixed_fixed_iteration_variant_converges(mesh300):
    """``tests/test_precision.py:192``."""
    _, fixed_m = make_krylov_solver(mesh300[1], max_iter=8,
                                    precision="mixed", device="cpu")
    r = fixed_m()
    assert bool(r.converged[0])
    assert r.fallbacks.dtype == torch.int32


@pytest.fixture(scope="module")
def ill():
    ref = _ill_conditioned(REF_MESH300)
    return (ref, _port(ref)) + _pairs(ref)


def test_fallback_runs_on_ill_conditioned_case_and_keeps_contract(ill):
    """``tests/test_precision.py:207``, and the reference's counts ±1."""
    ref, sys_, pair, port_pair = ill
    sm, _ = make_krylov_solver(sys_, max_iter=20, precision="mixed",
                               precond=port_pair, device="cpu")
    sf, _ = make_krylov_solver(sys_, max_iter=20, precision="f64",
                               precond=port_pair, device="cpu")
    rm, rf = sm(), sf()
    assert int(rm.fallbacks[0]) > 0
    assert bool(rm.converged[0]) == bool(rf.converged[0])
    assert float(rm.mismatch[0]) <= 2.0 * max(float(rf.mismatch[0]), 1e-12)
    want = ref_make_krylov(ref, max_iter=20, precision="mixed",
                           precond=pair)[0]()
    assert bool(rm.converged[0]) == bool(want.converged)
    assert int(want.fallbacks) > 0
    if bool(want.converged):  # a lane that never converges wanders apart
        assert abs(int(rm.fallbacks[0]) - int(want.fallbacks)) <= 1
        assert abs(int(rm.iterations[0]) - int(want.iterations)) <= 1


def test_fallback_is_per_lane(ill):
    """``tests/test_precision.py:241``: a lane at its own solution never
    falls back; the ill-conditioned lane does."""
    _, sys_, _, port_pair = ill
    n = sys_.n_bus
    v_flat = np.where(sys_.bus_type == 0, 1.0, sys_.v_set)
    p0, q0 = host_injections(sys_, np.zeros(n), v_flat)
    solve_m, _ = make_krylov_solver(sys_, max_iter=20, precision="mixed",
                                    precond=port_pair, device="cpu")
    r = solve_m(p_inj=np.stack([p0, sys_.p_inj]),
                q_inj=np.stack([q0, sys_.q_inj]))
    fb = r.fallbacks.tolist()
    assert fb[0] == 0 and fb[1] > 0
    assert bool(r.converged[0])


def test_fallbacks_feed_the_metrics_counter(ill):
    """``tests/test_precision.py:270``."""
    _, sys_, _, port_pair = ill
    sm, _ = make_krylov_solver(sys_, max_iter=20, precision="mixed",
                               precond=port_pair, device="cpu")
    r = sm()
    assert int(r.fallbacks[0]) > 0
    counter = obs.PF_FALLBACKS.labels("krylov")
    before = counter.value
    record_result(r)
    assert counter.value == before + int(r.fallbacks.sum())


def test_arguments_are_typed(mesh300):
    sys_ = mesh300[1]
    with pytest.raises(NotImplementedError, match="item 16"):
        make_krylov_solver(sys_, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="precision"):
        make_krylov_solver(sys_, precision="f16", device="cpu")
    with pytest.raises(TypeError, match="float64 or float32"):
        make_krylov_solver(sys_, dtype=torch.float16, device="cpu")
    # donate is accepted and ignored (no donation in PyTorch).
    solve, _ = make_krylov_solver(sys_, donate=False, max_iter=1,
                                  device="cpu")
    p = np.tile(sys_.p_inj, (2, 1))
    solve(p_inj=p)
    assert np.array_equal(p, np.tile(sys_.p_inj, (2, 1)))


def test_gradient_through_fixed_solver_on_the_cpu():
    """``tests/test_krylov.py:85``: d(slack P)/d(q_inj) by reverse mode
    through the fixed-iteration solve (the plain path on the CPU) against
    central differences."""
    sys_ = _port(ref_synthetic_mesh(120, seed=4, load_mw=2.0,
                                    chord_frac=1.0))
    _, solve_fixed = make_krylov_solver(
        sys_, max_iter=6, inner_iters=16, device="cpu",
        precond=build_fdlf_precond(sys_, kind="lu", device="cpu"))
    q0 = torch.as_tensor(sys_.q_inj[None].copy(), dtype=torch.float64)

    def slack_p(q):
        return solve_fixed(q_inj=q).p[0, sys_.slack]

    q = q0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(slack_p(q), q)
    h = 1e-5
    for idx in (3, 47, 101):
        e = torch.zeros_like(q0)
        e[0, idx] = h
        fd = (slack_p(q0 + e) - slack_p(q0 - e)) / (2 * h)
        np.testing.assert_allclose(float(g[0, idx]), float(fd), rtol=1e-4,
                                   atol=1e-8)


def test_sparse_gradient_through_fixed_solver_on_the_cpu():
    """The same check through ``make_sparse_newton_solver(precision=
    "f64")``: its plain GMRES cycle is recorded by autograd on the CPU
    too."""
    sys_ = _port(ref_synthetic_mesh(120, seed=4, load_mw=2.0,
                                    chord_frac=1.0))
    _, solve_fixed = make_sparse_newton_solver(
        sys_, max_iter=6, inner_iters=16, precision="f64", device="cpu",
        precond=build_fdlf_precond(sys_, kind="lu", device="cpu"))
    q0 = torch.as_tensor(sys_.q_inj[None].copy(), dtype=torch.float64)

    def slack_p(q):
        return solve_fixed(q_inj=q).p[0, sys_.slack]

    q = q0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(slack_p(q), q)
    h = 1e-5
    for idx in (3, 47, 101):
        e = torch.zeros_like(q0)
        e[0, idx] = h
        fd = (slack_p(q0 + e) - slack_p(q0 - e)) / (2 * h)
        np.testing.assert_allclose(float(g[0, idx]), float(fd), rtol=1e-4,
                                   atol=1e-8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_krylov_kernel_path_matches_plain_path_on_card(cuda_device):
    sys_ = _port(ref_synthetic_mesh(300, seed=4, load_mw=2.0,
                                    chord_frac=1.0))
    status = np.ones((3, sys_.n_branch))
    status[np.arange(3), sys_.n_bus + np.arange(3)] = 0.0
    precond = build_fdlf_precond(sys_, kind="lu", device=cuda_device)
    for prec in ("f64", "mixed"):
        solve, _ = make_krylov_solver(sys_, precision=prec, tol=1e-10,
                                      precond=precond, device=cuda_device)
        solve_p, _ = make_krylov_solver(sys_, precision=prec, tol=1e-10,
                                        precond=precond,
                                        device=cuda_device, plain=True)
        sol.reset_launches()
        r = solve(status=status)
        torch.cuda.synchronize()
        assert sol.launches()["residual_jvp"] > 0
        rp = solve_p(status=status)
        assert bool(r.converged.all())
        assert float((r.v - rp.v).abs().max()) <= 1e-9
