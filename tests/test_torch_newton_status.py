"""Parity of the port's dense Newton backend with a per-lane branch status.

``make_newton_solver(...)`` with ``status`` ``[m]`` and ``[B, m]``
against the JAX package's ``vmap`` over ``solve(status=...)``
(``tests/test_newton.py:140-160``'s setup), the case_ieee30 N-1 over
``secure_outages`` (``tests/test_ieee_cases.py:97``) and the reference
bench's ``bench_n1_118`` shape at mesh30 × its chords: v and θ within
1e-10 with equal iterations.  Without a status the results are the same
bits as before per-lane Ybus came (one Ybus of every lane, K1/K2's shared
form).  The ``cuda``-marked test holds the kernel path to the plain path
on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freedm_tpu.grid import cases as ref_cases
from freedm_tpu.grid.matpower import load_builtin as ref_load_builtin
from freedm_tpu.pf.n1 import secure_outages as ref_secure_outages
from freedm_tpu.pf.newton import make_newton_solver as ref_make_newton
from freedm_tpu_torch.grid.bus import BusSystem, ybus_dense, ybus_lanes
from freedm_tpu_torch.kernels import newton_kernels as nk
from freedm_tpu_torch.kernels import solver_kernels as sol
from freedm_tpu_torch.pf.newton import make_newton_solver

ATOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Batched LU on the CPU runs on one thread (the MKL note in the
    verify skill)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port(ref):
    return BusSystem.from_arrays(dataclasses.asdict(ref))


def _same(port_result, ref_result, atol=ATOL):
    np.testing.assert_allclose(port_result.v.numpy(),
                               np.atleast_2d(np.asarray(ref_result.v)),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(port_result.theta.numpy(),
                               np.atleast_2d(np.asarray(ref_result.theta)),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(port_result.p.numpy(),
                               np.atleast_2d(np.asarray(ref_result.p)),
                               rtol=0, atol=1e-8)
    assert port_result.iterations.tolist() == np.atleast_1d(
        np.asarray(ref_result.iterations)).tolist()
    assert port_result.converged.tolist() == np.atleast_1d(
        np.asarray(ref_result.converged)).tolist()


@pytest.fixture(scope="module")
def mesh40():
    ref = ref_cases.synthetic_mesh(40, seed=9)
    m, n = ref.n_branch, ref.n_bus
    outages = np.ones((m - n, m))
    outages[np.arange(m - n), np.arange(n, m)] = 0.0  # the chords
    return ref, _port(ref), outages


def test_status_lanes_match_reference_vmap(mesh40):
    ref, sys_, outages = mesh40
    solve, fixed = make_newton_solver(sys_, device="cpu")
    ref_solve, ref_fixed = ref_make_newton(ref)
    r = solve(status=outages)
    assert bool(r.converged.all())
    _same(r, jax.vmap(lambda s: ref_solve(status=s))(jnp.asarray(outages)))
    _same(fixed(status=outages),
          jax.vmap(lambda s: ref_fixed(status=s))(jnp.asarray(outages)))
    base = solve()
    assert float((r.v - base.v).abs().max()) > 1e-9  # outages change it


def test_shared_status_is_every_lanes(mesh40):
    ref, sys_, outages = mesh40
    solve, _ = make_newton_solver(sys_, device="cpu")
    scales = np.linspace(0.6, 1.1, 4)[:, None]
    r = solve(status=outages[1], p_inj=scales * sys_.p_inj,
              q_inj=scales * sys_.q_inj)
    ref_solve, _ = ref_make_newton(ref)
    want = jax.vmap(lambda a, b: ref_solve(p_inj=a, q_inj=b,
                                           status=jnp.asarray(outages[1])))(
        jnp.asarray(scales * ref.p_inj), jnp.asarray(scales * ref.q_inj))
    _same(r, want)


def test_all_in_service_status_equals_no_status(mesh40):
    _, sys_, _ = mesh40
    solve, _ = make_newton_solver(sys_, device="cpu")
    a = solve()
    b = solve(status=np.ones((1, sys_.n_branch)))
    np.testing.assert_array_equal(a.v.numpy(), b.v.numpy())
    assert a.iterations.tolist() == b.iterations.tolist()


def test_case30_secure_outages_match_reference():
    """``tests/test_ieee_cases.py:97``: every non-islanding outage of the
    IEEE 30-bus case solves, lane for lane as the reference's."""
    ref = ref_load_builtin("case_ieee30")
    sys_ = _port(ref)
    secure = ref_secure_outages(ref)
    assert len(secure) >= 30
    status = np.ones((len(secure), sys_.n_branch))
    status[np.arange(len(secure)), secure] = 0.0
    _, fixed = make_newton_solver(sys_, max_iter=8, device="cpu")
    _, ref_fixed = ref_make_newton(ref, max_iter=8)
    r = fixed(status=status)
    assert bool(r.converged.all())
    assert float(r.v.min()) > 0.8
    _same(r, jax.vmap(lambda s: ref_fixed(status=s))(jnp.asarray(status)))


def test_bench_n1_shape_at_mesh30():
    """The reference bench's ``bench_n1_118`` shape (dense ``solve_fixed``,
    one outage a lane, ``max_iter=6``) at mesh30 over its chords."""
    ref = ref_cases.synthetic_mesh(30, seed=1, load_mw=10.0, chord_frac=1.0)
    sys_ = _port(ref)
    n, m = sys_.n_bus, sys_.n_branch
    status = np.ones((m - n, m))
    status[np.arange(m - n), np.arange(n, m)] = 0.0
    _, fixed = make_newton_solver(sys_, max_iter=6, device="cpu")
    _, ref_fixed = ref_make_newton(ref, max_iter=6)
    _same(fixed(status=status),
          jax.vmap(lambda s: ref_fixed(status=s))(jnp.asarray(status)))


def test_no_status_path_is_the_shared_ybus_bit_for_bit(mesh40):
    """The no-status solve reads the one host-stamped ``[n, n]`` Ybus, as
    before per-lane stamps existed; a per-lane stack of that same Ybus
    gives the same values (another sum order is allowed), each lane its
    own rows."""
    _, sys_, outages = mesh40
    n = sys_.n_bus
    rng = np.random.default_rng(3)
    x = torch.as_tensor(np.concatenate(
        [rng.normal(0, 0.1, (4, n)), rng.uniform(0.95, 1.05, (4, n))], 1))
    y_re, y_im = ybus_dense(sys_, device="cpu")
    ys = ybus_lanes(sys_, None, device="cpu")
    assert torch.equal(ys[0], y_re) and torch.equal(ys[1], y_im)
    ps = torch.as_tensor(rng.normal(size=(4, n)))
    masks = [torch.ones(n, dtype=torch.float64)] * 3
    # K2's plain version on the shared Ybus: the shared-matrix products,
    # bit for bit.
    theta, v = x[:, :n], x[:, n:]
    vr, vm = v * torch.cos(theta), v * torch.sin(theta)
    i_re = vr @ y_re.T - vm @ y_im.T
    i_im = vm @ y_re.T + vr @ y_im.T
    p, q, _ = nk.power_injections(x, y_re, y_im, ps, ps, *masks)
    assert torch.equal(p, vr * i_re + vm * i_im)
    assert torch.equal(q, vm * i_re - vr * i_im)
    stack = (y_re.expand(4, n, n).contiguous(),
             y_im.expand(4, n, n).contiguous())
    for fn in (nk.newton_assemble, nk.power_injections):
        a = fn(x, y_re, y_im, ps, ps, *masks)
        c = fn(x, *stack, ps, ps, *masks)
        for u, v in zip(a, c):
            np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=0,
                                       atol=1e-13)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_status_solve_kernel_path_matches_plain_path_on_card(cuda_device):
    sys_ = _port(ref_cases.synthetic_mesh(118, seed=1, load_mw=10.0,
                                          chord_frac=1.0))
    status = np.ones((16, sys_.n_branch))
    status[np.arange(16), np.arange(16)] = 0.0
    _, fixed = make_newton_solver(sys_, max_iter=6, device=cuda_device)
    _, fixed_p = make_newton_solver(sys_, max_iter=6, device=cuda_device,
                                    plain=True)
    sol.reset_launches()
    nk.reset_launches()
    r = fixed(status=status)
    torch.cuda.synchronize()
    assert sol.launches()["ybus_stamp"] == 1
    assert nk.launches()["newton_assemble"] == 6
    rp = fixed_p(status=status)
    assert float((r.v - rp.v).abs().max()) <= 1e-9
    assert bool(r.converged.all())
