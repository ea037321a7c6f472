"""Parity of the port's fast-decoupled solver with the JAX package.

``freedm_tpu_torch.pf.fdlf.make_fdlf_solver`` against
``freedm_tpu.pf.fdlf.make_fdlf_solver`` (vmapped, CPU, x64) on the same
inputs: the reference's contracts (``tests/test_newton.py:297-345``,
``tests/test_ieee_cases.py:59-105``) plus lane-by-lane parity of ``solve``
and ``solve_fixed`` — v and θ within 1e-10 with equal iterations and
flags — with and without a per-lane branch status.  F1's plain version
is held to the reference's mismatch and error on random states (its
``solve_fixed`` after 0 and 1 iterations).  F1's warp-form launch plan
(``fdlf_warp_plan``) is plain Python, tested here.  The ``cuda``-marked
test holds F1 to its plain version on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freedm_tpu.grid import cases as ref_cases
from freedm_tpu.grid.matpower import load_builtin as ref_load_builtin
from freedm_tpu.pf.fdlf import make_fdlf_solver as ref_make_fdlf
from freedm_tpu.pf.n1 import secure_outages as ref_secure_outages
from freedm_tpu_torch.core import metrics as obs
from freedm_tpu_torch.grid.bus import PQ, SLACK, BusSystem, ybus_dense
from freedm_tpu_torch.kernels import solver_kernels as sol
from freedm_tpu_torch.pf import make_fdlf_solver
from freedm_tpu_torch.pf.fdlf import record_result
from freedm_tpu_torch.pf.newton import make_newton_solver

ATOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Batched LU on the CPU runs on one thread (the MKL note in the
    verify skill); the CPU path is many small ops anyway."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port(ref):
    return BusSystem.from_arrays(dataclasses.asdict(ref))


def _same(port_result, ref_result, atol=ATOL):
    """Lane by lane: v and θ within ``atol``, equal iterations and flags."""
    def lanes(a):
        return np.atleast_2d(np.asarray(a))

    np.testing.assert_allclose(port_result.v.numpy(), lanes(ref_result.v),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(port_result.theta.numpy(),
                               lanes(ref_result.theta), rtol=0, atol=atol)
    assert port_result.iterations.tolist() == np.atleast_1d(
        np.asarray(ref_result.iterations)).tolist()
    assert port_result.converged.tolist() == np.atleast_1d(
        np.asarray(ref_result.converged)).tolist()


def test_fdlf_matches_reference_and_newton():
    """``tests/test_newton.py:297``: mesh50 seed 8 at tol 1e-10 converges
    to Newton's point; here also to the reference's iteration."""
    ref = ref_cases.synthetic_mesh(50, seed=8)
    sys_ = _port(ref)
    solve, _ = make_fdlf_solver(sys_, tol=1e-10, max_iter=80, device="cpu")
    r = solve()
    assert bool(r.converged[0]), float(r.mismatch[0])
    _same(r, ref_make_fdlf(ref, tol=1e-10, max_iter=80)[0]())
    nr, _ = make_newton_solver(sys_, tol=1e-10, device="cpu")
    rn = nr()
    np.testing.assert_allclose(r.v.numpy(), rn.v.numpy(), atol=1e-8)
    np.testing.assert_allclose(r.theta.numpy(), rn.theta.numpy(), atol=1e-8)


def test_fdlf_status_lanes_refactorize_per_lane():
    """``tests/test_newton.py:314`` at 200 buses: the base converges; an
    N-1 batch of 4 lanes re-forms and re-factorizes B′/B″ per lane, and
    each lane matches the reference's vmapped lane."""
    ref = ref_cases.synthetic_mesh(200, seed=4, load_mw=2.0, chord_frac=1.0)
    sys_ = _port(ref)
    solve, fixed = make_fdlf_solver(sys_, max_iter=30, device="cpu")
    ref_solve, ref_fixed = ref_make_fdlf(ref, max_iter=30)
    base = solve()
    assert bool(base.converged[0]), float(base.mismatch[0])
    _same(base, ref_solve())
    k, m = 4, sys_.n_branch
    status = np.ones((k, m))
    status[np.arange(k), np.arange(k)] = 0.0
    r = fixed(status=status)
    assert bool(r.converged.all()), r.mismatch
    want = jax.vmap(lambda s: ref_fixed(status=s))(jnp.asarray(status))
    _same(r, want)
    r = solve(status=status)
    _same(r, jax.vmap(lambda s: ref_solve(status=s))(jnp.asarray(status)))
    # A shared [m] status stamps once and is every lane's.
    r = solve(status=status[2], p_inj=np.tile(sys_.p_inj, (3, 1)))
    one = ref_solve(status=jnp.asarray(status[2]))
    for lane in range(3):
        np.testing.assert_allclose(r.v[lane].numpy(), np.asarray(one.v),
                                   rtol=0, atol=ATOL)


def test_fdlf_respects_pins_over_injection_scales():
    """``tests/test_newton.py:331`` over 8 injection scales: PV and slack
    hold v_set, the slack angle stays 0, every lane as the reference's."""
    ref = ref_cases.synthetic_mesh(40, seed=9)
    sys_ = _port(ref)
    solve, fixed = make_fdlf_solver(sys_, device="cpu")
    ref_solve, ref_fixed = ref_make_fdlf(ref)
    scales = np.linspace(0.5, 1.2, 8)[:, None]
    p, q = scales * sys_.p_inj, scales * sys_.q_inj
    r = solve(p_inj=p, q_inj=q)
    assert bool(r.converged.all())
    pinned = sys_.bus_type != PQ
    np.testing.assert_allclose(r.v.numpy()[:, pinned],
                               np.tile(sys_.v_set[pinned], (8, 1)),
                               atol=1e-9)
    np.testing.assert_allclose(r.theta.numpy()[:, sys_.bus_type == SLACK],
                               0.0, atol=1e-12)
    _same(r, jax.vmap(lambda a, b: ref_solve(p_inj=a, q_inj=b))(
        jnp.asarray(p), jnp.asarray(q)))
    _same(fixed(p_inj=p, q_inj=q), jax.vmap(
        lambda a, b: ref_fixed(p_inj=a, q_inj=b))(jnp.asarray(p),
                                                  jnp.asarray(q)))


@pytest.mark.parametrize("case, max_iter", [("case14", 60),
                                            ("case_ieee30", 80)])
def test_ieee_cases_agree_with_newton_and_reference(case, max_iter):
    """``tests/test_ieee_cases.py:59`` and ``:92``."""
    ref = ref_load_builtin(case)
    sys_ = _port(ref)
    solve, _ = make_fdlf_solver(sys_, max_iter=max_iter, device="cpu")
    r = solve()
    assert bool(r.converged[0])
    nr, _ = make_newton_solver(sys_, max_iter=15, device="cpu")
    rn = nr()
    np.testing.assert_allclose(r.v.numpy(), rn.v.numpy(), atol=1e-6)
    np.testing.assert_allclose(r.theta.numpy(), rn.theta.numpy(), atol=1e-6)
    _same(r, ref_make_fdlf(ref, max_iter=max_iter)[0]())


def test_case30_secure_outages_against_reference():
    """The case_ieee30 N-1 over ``secure_outages`` (the dense reference's
    ``tests/test_ieee_cases.py:97`` screen, on the FDLF solver)."""
    ref = ref_load_builtin("case_ieee30")
    sys_ = _port(ref)
    secure = ref_secure_outages(ref)
    status = np.ones((len(secure), sys_.n_branch))
    status[np.arange(len(secure)), secure] = 0.0
    _, fixed = make_fdlf_solver(sys_, max_iter=40, device="cpu")
    _, ref_fixed = ref_make_fdlf(ref, max_iter=40)
    r = fixed(status=status)
    want = jax.vmap(lambda s: ref_fixed(status=s))(jnp.asarray(status))
    np.testing.assert_allclose(r.v.numpy(), np.asarray(want.v), rtol=0,
                               atol=1e-9)
    assert r.converged.tolist() == np.asarray(want.converged).tolist()


def test_f1_plain_version_against_reference_on_random_states():
    """F1's INIT mismatch and V-mode error against the reference's
    ``_mismatch``/``_err_from``, read through its ``solve_fixed`` at 0
    and 1 iterations from random start points, per lane."""
    ref = ref_cases.synthetic_mesh(60, seed=3)
    sys_ = _port(ref)
    n, lanes = sys_.n_bus, 5
    rng = np.random.default_rng(11)
    th0 = rng.normal(0, 0.05, (lanes, n))
    v0 = np.where(sys_.bus_type == PQ, rng.uniform(0.95, 1.05, (lanes, n)),
                  sys_.v_set)
    th0[:, sys_.bus_type == SLACK] = 0.0
    for iters in (0, 1):
        _, fixed = make_fdlf_solver(sys_, max_iter=iters, device="cpu")
        _, ref_fixed = ref_make_fdlf(ref, max_iter=iters)
        r = fixed(v0=v0, theta0=th0)
        want = jax.vmap(lambda a, b: ref_fixed(v0=a, theta0=b))(
            jnp.asarray(v0), jnp.asarray(th0))
        np.testing.assert_allclose(r.mismatch.numpy(),
                                   np.asarray(want.mismatch), rtol=1e-12,
                                   atol=1e-13)
        np.testing.assert_allclose(r.v.numpy(), np.asarray(want.v), rtol=0,
                                   atol=1e-13)
        np.testing.assert_allclose(r.theta.numpy(), np.asarray(want.theta),
                                   rtol=0, atol=1e-13)


def test_frozen_lanes_keep_their_state():
    """A lane that stopped keeps θ, V, ΔP, its count and its error while
    the others step (F1's plain version, V mode on an inactive lane)."""
    sys_ = _port(ref_cases.synthetic_mesh(30, seed=2))
    n = sys_.n_bus
    y_re, y_im = ybus_dense(sys_, device="cpu")
    f64 = torch.float64
    x = torch.cat([torch.zeros(2, n, dtype=f64), torch.ones(2, n, dtype=f64)],
                  1)
    ps = torch.as_tensor(np.tile(sys_.p_inj, (2, 1)))
    qs = torch.as_tensor(np.tile(sys_.q_inj, (2, 1)))
    th = torch.as_tensor(sys_.bus_type != SLACK, dtype=f64)
    vf = torch.as_tensor(sys_.bus_type == PQ, dtype=f64)
    dp, dq = torch.zeros(2, n, dtype=f64), torch.zeros(2, n, dtype=f64)
    err = torch.tensor([1.0, 2.0], dtype=f64)
    it = torch.tensor([3, 4], dtype=torch.int32)
    active = torch.tensor([True, False])
    tol = torch.full((1,), 1e-8, dtype=f64)
    sol.fdlf_half_step(sol.INIT, x, None, y_re, y_im, ps, qs, th, vf, dp, dq,
                       err, it, active, tol, 10, False)
    before = (x[1].clone(), dp[1].clone())
    d = torch.full((2, n), 1e-3, dtype=f64)
    sol.fdlf_half_step(sol.VHALF, x, d, y_re, y_im, ps, qs, th, vf, dp, dq,
                       err, it, active, tol, 10, False)
    assert torch.equal(x[1], before[0]) and torch.equal(dp[1], before[1])
    assert it.tolist() == [4, 4] and float(err[1]) == 2.0
    assert not torch.equal(x[0, n:], torch.ones(n, dtype=f64))


def test_record_result_feeds_the_metrics():
    sys_ = _port(ref_cases.synthetic_mesh(30, seed=2))
    solve, _ = make_fdlf_solver(sys_, device="cpu")
    hist = obs.PF_ITERATIONS.labels("fdlf")
    before = hist.count
    r = solve(p_inj=np.tile(sys_.p_inj, (3, 1)))
    record_result(r)
    assert hist.count == before + 3
    assert obs.PF_RESIDUAL.labels("fdlf").value == pytest.approx(
        float(r.mismatch.max()))


def test_arguments_are_typed():
    sys_ = _port(ref_cases.synthetic_mesh(30, seed=2))
    with pytest.raises(TypeError, match="float64 or float32"):
        make_fdlf_solver(sys_, dtype=torch.float16, device="cpu")
    solve, _ = make_fdlf_solver(sys_, device="cpu")
    with pytest.raises(ValueError, match="one row per lane"):
        solve(p_inj=sys_.p_inj)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 118, 2000, 10000])
@pytest.mark.parametrize("lanes", [1, 2, 3, 16, 256])
def test_f1_warp_plan_covers_every_row(n, lanes):
    for dtype, item in ((torch.float64, 8), (torch.float32, 4)):
        plan = sol.fdlf_warp_plan(n, lanes, dtype)
        assert plan.rows % sol.FDLF_WARPS == 0 and plan.rows >= 1
        assert plan.ctas == -(-n // plan.rows)
        assert (plan.ctas - 1) * plan.rows < n  # the last CTA holds a row
        assert plan.smem == 2 * n * item
        assert plan == sol.fdlf_warp_plan(n, lanes, dtype)


def test_f1_warp_plan_spreads_small_batches_thin():
    one = sol.fdlf_warp_plan(2000, 1, torch.float64)
    assert (one.rows, one.ctas) == (8, 250)  # a warp a row at mesh2000 x 1
    two = sol.fdlf_warp_plan(2000, 2, torch.float64)
    assert (two.rows, two.ctas) == (16, 125)
    many = sol.fdlf_warp_plan(2000, 16, torch.float64)
    assert many.rows > two.rows
    assert many.ctas * 16 <= 2 * sol.FDLF_TARGET_CTAS


def test_f1_warp_plan_refuses_what_shared_memory_cannot_hold():
    for dtype in (torch.float64, torch.float32):
        top = sol.FDLF_WARP_MAX_N[dtype]
        assert sol.fdlf_warp_plan(top, 1, dtype).smem <= sol.FDLF_WARP_SMEM
        with pytest.raises(ValueError, match="at most"):
            sol.fdlf_warp_plan(top + 1, 1, dtype)
    assert sol.FDLF_WARP_MAX_N[torch.float64] == 14272
    with pytest.raises(ValueError):
        sol.fdlf_warp_plan(0, 1, torch.float64)
    with pytest.raises(TypeError):
        sol.fdlf_warp_plan(10, 1, torch.float16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fdlf_kernel_path_matches_plain_path_on_card(cuda_device):
    sys_ = _port(ref_cases.synthetic_mesh(118, seed=1, load_mw=10.0,
                                          chord_frac=1.0))
    status = np.ones((3, sys_.n_branch))
    status[np.arange(3), sys_.n_bus + np.arange(3)] = 0.0
    for kw in ({}, {"status": status}):
        solve, _ = make_fdlf_solver(sys_, device=cuda_device)
        solve_p, _ = make_fdlf_solver(sys_, device=cuda_device, plain=True)
        before = sol.launches()["fdlf_half_step"]
        r, rp = solve(**kw), solve_p(**kw)
        torch.cuda.synchronize()
        assert sol.launches()["fdlf_half_step"] > before
        assert float((r.v - rp.v).abs().max()) <= 1e-9
        assert r.iterations.tolist() == rp.iterations.tolist()
        assert bool(r.converged.all())
