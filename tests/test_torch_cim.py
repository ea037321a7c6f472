"""Parity of the port's three-phase current-injection solver (CIM) with the
JAX package.

``freedm_tpu_torch.pf.cim`` against ``freedm_tpu.pf.cim`` on the same
feeders and loads: the reference's contracts (``tests/test_cim.py:28-113``:
radial against the ladder on vvc_9bus and ``synthetic_radial(200)``, a
closed tie meets KCL, an open tie equals no tie, unbalanced meshed
loads, fixed against while, the gradient through the fixed solve) and
``CimResult`` against the reference's within 1e-10 pu with equal
iterations, lane by lane.  I1's plain version is held to the reference's
``_iterate`` through its ``solve_fixed`` at 1 and 3 iterations.  The
``cuda``-marked test holds I1 to its plain version on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freedm_tpu.grid import cases as ref_cases
from freedm_tpu.pf.cim import assemble_yabc as ref_assemble_yabc
from freedm_tpu.pf.cim import kcl_residual_kva as ref_kcl
from freedm_tpu.pf.cim import make_cim_solver as ref_make_cim
from freedm_tpu.utils import cplx as ref_cplx
from freedm_tpu_torch.grid import cases
from freedm_tpu_torch.kernels import solver_kernels as sol
from freedm_tpu_torch.pf.cim import (assemble_yabc, kcl_residual_kva,
                                     make_cim_solver)
from freedm_tpu_torch.pf.ladder import make_ladder_solver

ATOL = 1e-10
#: The 9-bus feeder's tie candidate (``tests/test_cim.py:20``): nodes 5
#: (end of the main) and 8 (end of the lateral), one unit-length line.
TIE_5_8 = (5, 8, cases.Z_CODES_9BUS[0] / (1000.0 * 12.47**2 / 1000.0))


def _v(result):
    return result.v_node.to_numpy()


def _same(port, ref, atol=ATOL):
    np.testing.assert_allclose(_v(port), ref.v_node.to_numpy(), rtol=0,
                               atol=atol)
    assert np.asarray(port.iterations).tolist() == np.asarray(
        ref.iterations).tolist()
    assert np.asarray(port.converged).tolist() == np.asarray(
        ref.converged).tolist()


def _ladder(feeder, s):
    solve, _ = make_ladder_solver(feeder, eps=1e-12, max_iter=200,
                                  device="cpu")
    r = solve(s)
    assert bool(r.converged)
    return r


def test_yabc_matches_reference():
    f, rf = cases.vvc_9bus(), ref_cases.vvc_9bus()
    for ties in ((), (TIE_5_8,)):
        y, mask = assemble_yabc(f, ties)
        ry, rmask = ref_assemble_yabc(rf, ties)
        np.testing.assert_array_equal(y, ry)
        np.testing.assert_array_equal(mask, rmask)
    with pytest.raises(ValueError, match="bad tie endpoints"):
        assemble_yabc(f, [(3, 3, TIE_5_8[2])])


def test_radial_matches_ladder_9bus():
    f = cases.vvc_9bus()
    solve, _ = make_cim_solver(f, max_iter=200, device="cpu")
    rc = solve(f.s_load)
    assert bool(rc.converged)
    np.testing.assert_allclose(_v(rc), _v(_ladder(f, f.s_load)), atol=1e-8)
    _same(rc, ref_make_cim(ref_cases.vvc_9bus(), max_iter=200)[0](
        ref_cases.vvc_9bus().s_load))


def test_radial_matches_ladder_synthetic_200bus():
    f = cases.synthetic_radial(200, seed=3, load_kw=30.0)
    solve, _ = make_cim_solver(f, max_iter=400, device="cpu")
    rc = solve(f.s_load)
    assert bool(rc.converged)
    np.testing.assert_allclose(_v(rc), _v(_ladder(f, f.s_load)), atol=1e-7)
    rf = ref_cases.synthetic_radial(200, seed=3, load_kw=30.0)
    _same(rc, ref_make_cim(rf, max_iter=400)[0](rf.s_load))


def test_closed_tie_switch_solves_and_satisfies_kcl():
    f = cases.vvc_9bus()
    solve, _ = make_cim_solver(f, ties=[TIE_5_8], max_iter=200, device="cpu")
    rc = solve(f.s_load)
    assert bool(rc.converged)
    resid = kcl_residual_kva(f, [TIE_5_8], rc)
    assert resid.shape == (f.n_branches, 3) and resid.max() < 1e-6
    rf = ref_cases.vvc_9bus()
    ref_r = ref_make_cim(rf, ties=[TIE_5_8], max_iter=200)[0](rf.s_load)
    _same(rc, ref_r)
    np.testing.assert_allclose(resid, ref_kcl(rf, [TIE_5_8], ref_r),
                               rtol=0, atol=1e-7)


def test_tie_reduces_voltage_spread():
    f = cases.vvc_9bus()
    open_solve, _ = make_cim_solver(f, max_iter=200, device="cpu")
    closed_solve, _ = make_cim_solver(f, ties=[TIE_5_8], max_iter=200,
                                      device="cpu")
    vo = np.abs(_v(open_solve(f.s_load)))
    vc = np.abs(_v(closed_solve(f.s_load)))
    assert np.abs(vc[5] - vc[8]).max() < np.abs(vo[5] - vo[8]).max()


def test_open_tie_equals_no_tie():
    f = cases.vvc_9bus()
    radial_solve, _ = make_cim_solver(f, max_iter=200, device="cpu")
    np.testing.assert_allclose(_v(radial_solve(f.s_load)),
                               _v(_ladder(f, f.s_load)), atol=1e-8)


def test_unbalanced_loads_meshed():
    f = cases.vvc_9bus()
    s = f.s_load.copy()
    s[:, 0] *= 1.5
    s[:, 2] *= 0.5
    solve, _ = make_cim_solver(f, ties=[TIE_5_8], max_iter=300, device="cpu")
    rc = solve(s)
    assert bool(rc.converged)
    assert kcl_residual_kva(f, [TIE_5_8], rc, s_load_kva=s).max() < 1e-6
    rf = ref_cases.vvc_9bus()
    _same(rc, ref_make_cim(rf, ties=[TIE_5_8], max_iter=300)[0](s))


def test_fixed_variant_matches_while_loop():
    f = cases.vvc_9bus()
    solve, solve_fixed = make_cim_solver(f, ties=[TIE_5_8], max_iter=120,
                                         device="cpu")
    a, b = solve(f.s_load), solve_fixed(f.s_load)
    np.testing.assert_allclose(_v(a), _v(b), atol=1e-9)
    assert int(b.iterations) == 120
    rf = ref_cases.vvc_9bus()
    _same(b, ref_make_cim(rf, ties=[TIE_5_8], max_iter=120)[1](rf.s_load))


def test_lanes_match_reference_vmap():
    """A batch of 6 load scales (one past convergence in 40 iterations
    is allowed to disagree only if the reference's does) and a per-lane
    source voltage, lane by lane against ``jax.vmap``."""
    f, rf = cases.vvc_9bus(), ref_cases.vvc_9bus()
    scales = np.linspace(0.3, 1.8, 6)
    s = scales[:, None, None] * f.s_load[None]
    vs = np.linspace(1.0, 1.04, 6)
    solve, fixed = make_cim_solver(f, ties=[TIE_5_8], max_iter=40,
                                   device="cpu")
    ref_solve, ref_fixed = ref_make_cim(rf, ties=[TIE_5_8], max_iter=40)
    for port_fn, ref_fn in ((solve, ref_solve), (fixed, ref_fixed)):
        r = port_fn(s, vs)
        want = jax.vmap(lambda a, b: ref_fn(a, b))(
            ref_cplx.as_c(s, dtype=jnp.float64), jnp.asarray(vs))
        _same(r, want)
        np.testing.assert_allclose(r.residual.numpy(),
                                   np.asarray(want.residual), rtol=1e-6,
                                   atol=1e-12)


@pytest.mark.parametrize("iters", [1, 3])
def test_i1_plain_version_against_reference_iterate(iters):
    """I1's plain version, ``iters`` iterations from the no-load profile on
    random unbalanced loads, against the reference's ``_iterate`` (its
    ``solve_fixed`` with that many iterations), residual included."""
    f, rf = cases.synthetic_radial(60, seed=2), ref_cases.synthetic_radial(
        60, seed=2)
    rng = np.random.default_rng(iters)
    s = f.s_load[None] * rng.uniform(0.5, 1.5, (4, f.n_branches, 3))
    ties = [(10, 40, f.z_pu[0])]
    _, fixed = make_cim_solver(f, ties=ties, max_iter=iters, device="cpu")
    _, ref_fixed = ref_make_cim(rf, ties=ties, max_iter=iters)
    r = fixed(s)
    want = jax.vmap(ref_fixed)(ref_cplx.as_c(s, dtype=jnp.float64))
    np.testing.assert_allclose(_v(r), want.v_node.to_numpy(), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(r.residual.numpy(), np.asarray(want.residual),
                               rtol=1e-10, atol=1e-15)


def test_gradient_through_fixed_solver():
    """``tests/test_cim.py:113``: the gradient of a voltage-profile
    objective in the per-phase reactive loads, by reverse mode through
    the fixed solve (the plain path on the CPU), against central
    differences and against ``jax.grad`` of the reference."""
    f, rf = cases.vvc_9bus(), ref_cases.vvc_9bus()
    _, solve_fixed = make_cim_solver(f, ties=[TIE_5_8], max_iter=80,
                                     device="cpu")
    p0 = torch.as_tensor(f.s_load.real)
    q00 = torch.as_tensor(f.s_load.imag)

    def profile_loss(q):
        r = solve_fixed((p0, q))
        return torch.sum((r.v_node.abs2()[1:] - 1.0) ** 2)

    q = q00.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(profile_loss(q), q)
    h = 1e-3
    for idx in ((1, 0), (4, 2), (7, 1)):
        e = torch.zeros_like(q00)
        e[idx] = h
        fd = (profile_loss(q00 + e) - profile_loss(q00 - e)) / (2 * h)
        np.testing.assert_allclose(float(g[idx]), float(fd), rtol=1e-4,
                                   atol=1e-10)
    _, ref_fixed = ref_make_cim(rf, ties=[TIE_5_8], max_iter=80)

    def ref_loss(qq):
        r = ref_fixed(ref_cplx.C(jnp.asarray(rf.s_load.real), qq))
        return jnp.sum((r.v_node.abs2()[1:] - 1.0) ** 2)

    want = jax.grad(ref_loss)(jnp.asarray(rf.s_load.imag))
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-8,
                               atol=1e-14)


def test_arguments_are_typed():
    f = cases.vvc_9bus()
    with pytest.raises(TypeError, match="float64 or float32"):
        make_cim_solver(f, dtype=torch.float16, device="cpu")
    solve, _ = make_cim_solver(f, device="cpu")
    with pytest.raises(ValueError, match="s_load_kva must be"):
        solve(f.s_load[:-1])
    with pytest.raises(ValueError, match="v_source_pu must be"):
        solve(np.stack([f.s_load] * 2), np.ones(3))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cim_kernel_matches_plain_version_on_card(cuda_device):
    f = cases.synthetic_radial(300, seed=1, load_kw=5.0)
    ties = [(20, 250, f.z_pu[0]), (77, 199, f.z_pu[0])]
    s = np.linspace(0.6, 1.4, 20)[:, None, None] * f.s_load[None]
    for dtype, atol in ((torch.float64, 1e-10), (torch.float32, 1e-3)):
        solve, fixed = make_cim_solver(f, ties=ties, dtype=dtype,
                                       device=cuda_device)
        solve_p, fixed_p = make_cim_solver(f, ties=ties, dtype=dtype,
                                           device=cuda_device, plain=True)
        before = sol.launches()["cim_iterate"]
        a, b = solve(s), solve_p(s)
        torch.cuda.synchronize()
        assert sol.launches()["cim_iterate"] > before
        assert a.iterations.tolist() == b.iterations.tolist()
        assert float((a.v_node.re - b.v_node.re).abs().max()) <= atol
        c, d = fixed(s), fixed_p(s)
        assert float((c.v_node.im - d.v_node.im).abs().max()) <= atol
