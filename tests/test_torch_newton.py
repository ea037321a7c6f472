"""Parity of the PyTorch port's dense Newton solver with the JAX package.

On the CPU the kernel wrappers run their plain PyTorch versions; the
kernels themselves are held against those versions on the card by
``chip_smoke.py`` and by the ``cuda``-marked tests here.  Inputs are made
with numpy from a seed and handed to both packages; the reference runs
as its own tests run it (CPU, x64).  Tolerances: float64 throughout,
1e-9 pu on states and injections (sums run in another order), iteration
counts and convergence flags exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freedm_tpu.grid import cases as ref_cases
from freedm_tpu.grid import matpower as ref_matpower
from freedm_tpu.grid.bus import PQ as REF_PQ
from freedm_tpu.grid.bus import SLACK as REF_SLACK
from freedm_tpu.grid.bus import ybus_dense as ref_ybus_dense
from freedm_tpu.pf.newton import branch_flows as ref_branch_flows
from freedm_tpu.pf.newton import make_newton_solver as ref_make_newton_solver
from freedm_tpu.pf.newton import s_calc as ref_s_calc
from freedm_tpu.utils import cplx
from freedm_tpu_torch.grid import matpower
from freedm_tpu_torch.grid.bus import PQ, SLACK, BusSystem, ybus_dense
from freedm_tpu_torch.kernels import newton_kernels as nk
from freedm_tpu_torch.pf.newton import (any_active, branch_flows,
                                        make_newton_solver, s_calc)

F64 = torch.float64


def _port(ref_sys):
    return BusSystem.from_arrays(dataclasses.asdict(ref_sys))


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _masks(sys):
    bt = np.asarray(sys.bus_type)
    return _t(bt != SLACK), _t(bt == PQ), _t(sys.v_set)


def _ref_residual(ref_sys):
    """The reference's masked residual (as tests/test_newton.py builds it
    for its jacfwd check)."""
    n = ref_sys.n_bus
    y = ref_ybus_dense(ref_sys, dtype=jnp.float64)
    bus_type = jnp.asarray(ref_sys.bus_type)
    th_free = (bus_type != REF_SLACK).astype(jnp.float64)
    v_free = (bus_type == REF_PQ).astype(jnp.float64)
    v_set = jnp.asarray(ref_sys.v_set, jnp.float64)

    def residual(x, p_sched, q_sched):
        theta, v = x[:n], x[n:]
        vc = cplx.polar(v, theta)
        i = cplx.C(y.re @ vc.re - y.im @ vc.im, y.re @ vc.im + y.im @ vc.re)
        s = vc * i.conj()
        f_p = jnp.where(th_free > 0, s.re - p_sched, theta)
        f_q = jnp.where(v_free > 0, s.im - q_sched, v - v_set)
        return jnp.concatenate([f_p, f_q])

    return residual


def _random_state(n, lanes, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-0.2, 0.2, (lanes, n)),
                           rng.uniform(0.95, 1.05, (lanes, n))], axis=1)


def test_assemble_plain_matches_reference_jacobian_and_step():
    """K1's plain version against jax.jacfwd of the reference residual
    and against one reference Newton step (solve_fixed, max_iter=1) —
    the check of tests/test_newton.py::test_hand_jacobian_matches_jacfwd,
    on three lanes at once."""
    ref = ref_cases.synthetic_mesh(24, seed=12)
    sys = _port(ref)
    n, lanes = ref.n_bus, 3
    x = _random_state(n, lanes, seed=3)
    scale = np.array([0.7, 1.0, 1.3])[:, None]
    ps, qs = scale * ref.p_inj, scale * ref.q_inj

    y_re, y_im = ybus_dense(sys, device="cpu")
    jac, f = nk.newton_assemble(_t(x), y_re, y_im, _t(ps), _t(qs), *_masks(sys))
    assert jac.shape == (lanes, 2 * n, 2 * n) and f.shape == (lanes, 2 * n)
    dx = torch.linalg.solve(jac, -f.unsqueeze(-1)).squeeze(-1)
    got_x1 = x + dx.numpy()

    residual = _ref_residual(ref)
    _, ref_fixed1 = ref_make_newton_solver(ref, max_iter=1, dtype=jnp.float64)
    for b in range(lanes):
        xb = jnp.asarray(x[b])
        want_f = residual(xb, ps[b], qs[b])
        want_jac = jax.jacfwd(residual)(xb, ps[b], qs[b])
        np.testing.assert_allclose(f[b].numpy(), np.asarray(want_f), atol=1e-9)
        np.testing.assert_allclose(jac[b].numpy(), np.asarray(want_jac),
                                   atol=1e-9)
        one = ref_fixed1(p_inj=ps[b], q_inj=qs[b], v0=x[b, n:],
                         theta0=x[b, :n])
        want_x1 = np.concatenate([np.asarray(one.theta), np.asarray(one.v)])
        np.testing.assert_allclose(got_x1[b], want_x1, atol=1e-9)


def test_injections_plain_matches_reference_s_calc():
    """K2's plain version against the reference's s_calc and residual."""
    ref = ref_cases.synthetic_mesh(24, seed=12)
    sys = _port(ref)
    n, lanes = ref.n_bus, 4
    x = _random_state(n, lanes, seed=5)
    ps = np.random.default_rng(6).normal(size=(lanes, n))
    qs = np.random.default_rng(7).normal(size=(lanes, n))
    y_re, y_im = ybus_dense(sys, device="cpu")
    p, q, f = nk.power_injections(_t(x), y_re, y_im, _t(ps), _t(qs),
                                  *_masks(sys))
    y = ref_ybus_dense(ref, dtype=jnp.float64)
    residual = _ref_residual(ref)
    for b in range(lanes):
        want_p, want_q = ref_s_calc(y, jnp.asarray(x[b, :n]),
                                    jnp.asarray(x[b, n:]))
        np.testing.assert_allclose(p[b].numpy(), np.asarray(want_p), atol=1e-9)
        np.testing.assert_allclose(q[b].numpy(), np.asarray(want_q), atol=1e-9)
        np.testing.assert_allclose(
            f[b].numpy(), np.asarray(residual(jnp.asarray(x[b]), ps[b], qs[b])),
            atol=1e-9)
    # The public s_calc goes through the same kernel.
    p2, q2 = s_calc(y_re, y_im, _t(x[:, :n]), _t(x[:, n:]))
    np.testing.assert_array_equal(p2.numpy(), p.numpy())
    np.testing.assert_array_equal(q2.numpy(), q.numpy())


def _oracle_update(x, dx, f, free, it, err, active, max_iter, tol):
    """numpy oracle of the vmapped while_loop's per-lane select
    (freedm_tpu/pf/newton.py:325-336): an active lane takes its step and
    carries the pre-update mismatch; every lane re-evaluates cond."""
    x, it, err, active = x.copy(), it.copy(), err.copy(), active.copy()
    for b in range(x.shape[0]):
        if active[b]:
            a = np.abs(f[b] * free)
            err_new = np.nan if np.isnan(a).any() else a.max()
            x[b] = x[b] + dx[b]
            it[b] += 1
            err[b] = err_new
        active[b] = bool(it[b] < max_iter) and bool(err[b] >= tol)
    return x, it, err, active


def test_update_plain_matches_while_loop_oracle():
    rng = np.random.default_rng(11)
    lanes, m, max_iter, tol = 6, 10, 5, 1e-8
    x = rng.normal(size=(lanes, m))
    dx = rng.normal(size=(lanes, m))
    f = rng.normal(size=(lanes, m))
    f[3] *= 1e-12  # steps, then stops converged
    f[1, 4] = np.nan  # NaN lane: steps once, then stops
    free = (rng.uniform(size=m) < 0.8).astype(np.float64)
    free[4] = 0.0  # NaN on a pinned row still poisons f*free (NaN*0)
    it = np.array([0, 0, 4, 0, 5, 2], np.int32)  # lane 2 reaches max_iter
    err = np.array([np.inf, np.inf, 1.0, np.inf, 1.0, 1e-9])
    active = np.array([True, True, True, True, False, False])
    want = _oracle_update(x, dx, f, free, it, err, active, max_iter, tol)

    got = [_t(x), torch.as_tensor(it), _t(err), torch.as_tensor(active)]
    nk.newton_update(got[0], _t(dx), _t(f), _t(free), got[1], got[2], got[3],
                     max_iter, torch.full((1,), tol, dtype=F64))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[3].numpy().tolist() == [True, False, False, False, False,
                                       False]
    assert np.isnan(got[2][1].item())


@pytest.mark.parametrize("max_iter", [0, 1, 5])
def test_host_active_read_equals_the_while_loop_cond(max_iter):
    """The loops' host read of K3's flags (``any_active``) equals the
    reference ``while_loop``'s cond over the lanes, vmapped: every subset
    of four lanes — a NaN lane, a lane at max_iter, a converged lane and
    a lane still stepping — after one K3 update, and at max_iter = 0,
    where no lane may step."""
    tol = 1e-8
    rng = np.random.default_rng(max_iter)
    m = 6
    x, dx = rng.normal(size=(4, m)), rng.normal(size=(4, m))
    f = rng.normal(size=(4, m))
    f[0, 2] = np.nan  # its err becomes NaN
    f[2] *= 1e-12  # converged
    free = np.ones(m)
    it0 = np.array([0, max(max_iter - 1, 0), 0, 0], np.int32)
    err0 = np.full(4, np.inf)

    def ref_cond(it, err):
        return jax.vmap(lambda i, e: jnp.logical_and(i < max_iter, e >= tol))(
            jnp.asarray(it), jnp.asarray(err))

    active0 = np.array(ref_cond(it0, err0))
    got = [_t(x), torch.as_tensor(it0), _t(err0), torch.as_tensor(active0)]
    nk.newton_update(got[0], _t(dx), _t(f), _t(free), got[1], got[2], got[3],
                     max_iter, torch.full((1,), tol, dtype=F64))
    want = np.asarray(ref_cond(got[1].numpy(), got[2].numpy()))
    np.testing.assert_array_equal(got[3].numpy(), want)
    assert not want[0] and not want[2]  # the NaN and the converged lane stop
    for mask in range(16):
        lanes = [b for b in range(4) if mask >> b & 1]
        assert any_active(got[3][lanes]) == bool(want[lanes].any())
        assert any_active(torch.as_tensor(active0[lanes])) == bool(
            active0[lanes].any())
    if max_iter == 0:
        assert not any_active(torch.as_tensor(active0))
        np.testing.assert_array_equal(got[0].numpy(), x)  # nothing stepped


@pytest.fixture(scope="module")
def mesh40():
    ref = ref_cases.synthetic_mesh(40, seed=9)
    return ref, _port(ref)


def test_batched_solve_matches_vmapped_reference(mesh40):
    ref, sys = mesh40
    scales = np.linspace(0.6, 1.6, 8)[:, None]
    p, q = scales * ref.p_inj, scales * ref.q_inj
    ref_solve, _ = ref_make_newton_solver(ref, dtype=jnp.float64)
    want = jax.vmap(lambda a, b: ref_solve(p_inj=a, q_inj=b))(p, q)
    solve, _ = make_newton_solver(sys, dtype=F64, device="cpu")
    got = solve(p_inj=p, q_inj=q)

    assert got.v.shape == (8, ref.n_bus) and got.iterations.dtype == torch.int32
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    assert got.converged.all()
    for k in ("v", "theta", "p", "q"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), atol=1e-9,
                                   err_msg=k)
    assert (got.mismatch < 1e-8).all()
    np.testing.assert_array_equal(got.fallbacks.numpy(), 0)


def test_max_iter_zero_takes_no_step_as_the_reference(mesh40):
    ref, sys = mesh40
    scales = np.linspace(0.8, 1.2, 3)[:, None]
    p, q = scales * ref.p_inj, scales * ref.q_inj
    ref_solve, _ = ref_make_newton_solver(ref, max_iter=0)
    want = jax.vmap(lambda a, b: ref_solve(p_inj=a, q_inj=b))(p, q)
    solve, _ = make_newton_solver(sys, max_iter=0, device="cpu")
    got = solve(p_inj=p, q_inj=q)
    np.testing.assert_array_equal(got.iterations.numpy(), 0)
    np.testing.assert_array_equal(np.asarray(want.iterations), 0)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=1e-12)


def test_warm_start_lanes_match_reference(mesh40):
    """Per-lane start points (the serve path's v0/theta0) keep the
    per-lane iteration counts of the reference."""
    ref, sys = mesh40
    solve, _ = make_newton_solver(sys, device="cpu")
    base = solve(p_inj=ref.p_inj[None], q_inj=ref.q_inj[None])
    scales = np.array([1.0, 1.01, 1.2, 0.9])[:, None]
    p, q = scales * ref.p_inj, scales * ref.q_inj
    v0 = np.repeat(base.v.numpy(), 4, axis=0)
    th0 = np.repeat(base.theta.numpy(), 4, axis=0)
    ref_solve, _ = ref_make_newton_solver(ref)
    want = jax.vmap(lambda a, b, c, d: ref_solve(
        p_inj=a, q_inj=b, v0=c, theta0=d))(p, q, v0, th0)
    got = solve(p_inj=p, q_inj=q, v0=v0, theta0=th0)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=1e-9)
    assert got.iterations[0] < base.iterations[0]


def test_case14_matches_published_solution():
    sys = matpower.load_builtin("case14")
    solve, _ = make_newton_solver(sys, device="cpu")
    r = solve()
    assert r.v.shape == (1, 14) and bool(r.converged[0])
    vm_pub, va_pub = matpower.builtin_solved_state("case14")
    # Published values are rounded to 3 decimals (1e-3 / 1e-2 deg).
    np.testing.assert_allclose(r.v[0].numpy(), vm_pub, atol=2e-3)
    np.testing.assert_allclose(np.degrees(r.theta[0].numpy()), va_pub,
                               atol=5e-2)
    assert abs(float(r.p[0, 0]) * 100.0 - 232.4) < 0.2  # slack generation, MW
    assert abs(float(r.p[0].sum()) * 100.0 - 13.39) < 0.1  # losses, MW


def test_diverging_and_singular_lanes_do_not_fail_the_batch():
    """A lane driven past the nose point and a lane started at V = 0
    (a singular Jacobian: NaN mismatch) report converged=False with the
    reference's iteration counts, while the other lanes converge."""
    ref = ref_matpower.load_builtin("case14")
    sys = matpower.load_builtin("case14")
    scales = np.array([1.0, 4.0, 6.0, 9.0, 1.2])[:, None]
    p, q = scales * ref.p_inj, scales * ref.q_inj
    v0 = np.tile(np.where(ref.bus_type == REF_PQ, 1.0, ref.v_set), (5, 1))
    v0[4] = 0.0
    th0 = np.zeros((5, 14))
    ref_solve, _ = ref_make_newton_solver(ref, max_iter=12)
    want = jax.vmap(lambda a, b, c, d: ref_solve(
        p_inj=a, q_inj=b, v0=c, theta0=d))(p, q, v0, th0)
    solve, _ = make_newton_solver(sys, max_iter=12, device="cpu")
    got = solve(p_inj=p, q_inj=q, v0=v0, theta0=th0)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    assert got.converged.numpy().tolist() == [True, True, False, False, False]
    assert np.isnan(got.mismatch[4].item())
    for b in (0, 1):
        np.testing.assert_allclose(got.v[b].numpy(), np.asarray(want.v[b]),
                                   atol=1e-9)


def test_solve_fixed_matches_reference_and_differentiates_on_cpu(mesh40):
    ref, sys = mesh40
    scales = np.array([0.8, 1.1])[:, None]
    p, q = scales * ref.p_inj, scales * ref.q_inj
    _, ref_fixed = ref_make_newton_solver(ref, max_iter=3)
    want = jax.vmap(lambda a, b: ref_fixed(p_inj=a, q_inj=b))(p, q)
    _, fixed = make_newton_solver(sys, max_iter=3, device="cpu")
    got = fixed(p_inj=p, q_inj=q)
    np.testing.assert_array_equal(got.iterations.numpy(), [3, 3])
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=1e-9)
    np.testing.assert_allclose(got.mismatch.numpy(), np.asarray(want.mismatch),
                               atol=1e-9)
    # Reverse mode through the plain versions (CPU): d Σv / d p_inj.
    pt = _t(p[:1]).requires_grad_(True)
    fixed(p_inj=pt, q_inj=q[:1]).v.sum().backward()
    want_g = jax.grad(lambda a: jnp.sum(ref_fixed(p_inj=a, q_inj=q[0]).v))(
        jnp.asarray(p[0]))
    np.testing.assert_allclose(pt.grad[0].numpy(), np.asarray(want_g),
                               atol=1e-8)


def test_branch_flows_match_reference(mesh40):
    ref, sys = mesh40
    solve, _ = make_newton_solver(sys, device="cpu")
    r = solve()
    ref_solve, _ = ref_make_newton_solver(ref)
    want_f, want_t = ref_branch_flows(ref, ref_solve())
    got_f, got_t = branch_flows(sys, r)
    for g, w in ((got_f, want_f), (got_t, want_t)):
        np.testing.assert_allclose(g[0][0].numpy(), np.asarray(w.re), atol=1e-9)
        np.testing.assert_allclose(g[1][0].numpy(), np.asarray(w.im), atol=1e-9)


def test_solver_argument_errors_are_typed(mesh40):
    _, sys = mesh40
    solve, fixed = make_newton_solver(sys, device="cpu")
    n = sys.n_bus
    with pytest.raises(ValueError, match="one row per lane"):
        solve(p_inj=np.zeros(n))
    with pytest.raises(ValueError, match="lane counts"):
        solve(p_inj=np.zeros((2, n)), q_inj=np.zeros((3, n)))
    with pytest.raises(ValueError, match="status must be"):
        solve(status=np.ones(sys.n_branch + 1))
    with pytest.raises(NotImplementedError, match="mesh"):
        make_newton_solver(sys, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="precision"):
        make_newton_solver(sys, device="cpu", precision="f16")


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version (skipped on the CPU)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,lanes", [("case14", 3), ("case_ieee30", 5)])
def test_kernels_match_plain_versions_on_card(cuda_device, name, lanes):
    sys = matpower.load_builtin(name)
    n = sys.n_bus
    x = torch.as_tensor(_random_state(n, lanes, seed=2), device=cuda_device)
    y_re, y_im = ybus_dense(sys, device=cuda_device)
    scale = torch.linspace(0.5, 1.5, lanes, dtype=F64, device=cuda_device)[:, None]
    args = (x, y_re, y_im, scale * _t(sys.p_inj).to(cuda_device),
            scale * _t(sys.q_inj).to(cuda_device),
            *(t.to(cuda_device) for t in _masks(sys)))
    for kern, plain in ((nk.newton_assemble, nk.newton_assemble_plain),
                        (nk.power_injections, nk.power_injections_plain)):
        for a, b in zip(kern(*args), plain(*args)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-10)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_solve_on_card_matches_plain_and_refuses_grad(cuda_device):
    """The card's solve against the plain path; ``solve_fixed`` on the
    card differentiates (route B: J2 and the LU's adjoint solve) to the
    plain route's gradient — the refusal it once checked is gone."""
    sys = matpower.load_builtin("case_ieee30")
    solve, fixed = make_newton_solver(sys, device=cuda_device)
    plain, fixed_plain = make_newton_solver(sys, device=cuda_device,
                                            plain=True, adjoint=True)
    p = np.linspace(0.8, 1.2, 4)[:, None] * sys.p_inj
    got, want = solve(p_inj=p), plain(p_inj=p)
    torch.testing.assert_close(got.v, want.v, rtol=0, atol=1e-9)
    assert torch.equal(got.iterations, want.iterations)
    grads = []
    for fn in (fixed, fixed_plain):
        pt = torch.as_tensor(p, device=cuda_device).requires_grad_(True)
        r = fn(p_inj=pt)
        (g,) = torch.autograd.grad(r.p[:, sys.slack].sum() + r.v.sum(), pt)
        grads.append(g)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-9,
                               atol=1e-9 * float(grads[1].abs().max()))
