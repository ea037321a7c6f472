"""Parity of the PyTorch port's Krylov toolkit with the JAX package.

The FDLF matrices, the Newton–Schulz preconditioner build, the scalar
and block GMRES cycles and the host float64 oracles of
``freedm_tpu_torch.pf.krylov`` against ``freedm_tpu.pf.fdlf`` and
``freedm_tpu.pf.krylov`` on the same inputs (numpy, from a seed), float64
on the CPU, where the S3/S4 wrappers run their plain versions.
Tolerances: B′/B″ 1e-15 (the same float64 stamp); GMRES updates 1e-10
(the same cycle, sums in another order); oracles 1e-12.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freedm_tpu.grid import cases as ref_cases
from freedm_tpu.grid import matpower as ref_matpower
from freedm_tpu.grid.bus import ybus_dense as ref_ybus_dense
from freedm_tpu.pf.fdlf import decoupled_parts as ref_decoupled_parts
from freedm_tpu.pf.krylov import _newton_schulz as ref_newton_schulz
from freedm_tpu.pf.krylov import _pgmres as ref_pgmres
from freedm_tpu.pf.krylov import _pgmres_block as ref_pgmres_block
from freedm_tpu.pf.krylov import _resolve_precond_kind as ref_resolve_kind
from freedm_tpu.pf.krylov import build_fdlf_precond as ref_build_precond
from freedm_tpu.pf.krylov import default_precond_kind as ref_default_kind
from freedm_tpu.pf.krylov import host_injections as ref_host_injections
from freedm_tpu.pf.krylov import true_mismatch as ref_true_mismatch
from freedm_tpu_torch.grid.bus import BusSystem
from freedm_tpu_torch.kernels import sparse_kernels as sk
from freedm_tpu_torch.pf import krylov
from freedm_tpu_torch.pf.fdlf import decoupled_parts
from freedm_tpu_torch.pf.newton import NewtonResult

F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is thousands of tiny ops; on a shared host a
    multi-threaded pool spends far longer waking its threads than
    computing, so these tests run torch on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port(ref_sys):
    return BusSystem.from_arrays(dataclasses.asdict(ref_sys))


def _ref_case(name):
    if name == "case14":
        return ref_matpower.load_builtin("case14")
    return ref_cases.synthetic_mesh(118, seed=1, load_mw=10.0, chord_frac=1.0)


@pytest.fixture(scope="module", params=["case14", "mesh118"])
def case(request):
    ref = _ref_case(request.param)
    return ref, _port(ref)


def test_decoupled_parts_match_reference(case):
    ref, sys = case
    want = ref_decoupled_parts(ref, jnp.float64)
    got = decoupled_parts(sys, device="cpu")
    y = ref_ybus_dense(ref, dtype=jnp.float64)
    np.testing.assert_allclose(got.b_prime(None).numpy(),
                               np.asarray(want.b_prime(None)), rtol=0,
                               atol=1e-15)
    np.testing.assert_allclose(got.b_dblprime(np.asarray(y.im)).numpy(),
                               np.asarray(want.b_dblprime(y)), rtol=0,
                               atol=1e-15)
    np.testing.assert_array_equal(got.th_free.numpy(),
                                  np.asarray(want.th_free))
    np.testing.assert_array_equal(got.v_free.numpy(), np.asarray(want.v_free))


def test_newton_schulz_pair_matches_reference(case):
    ref, sys = case
    parts = decoupled_parts(sys, device="cpu")
    b_p = parts.b_prime(None)
    x, resid = krylov._newton_schulz(b_p)
    want_x, want_resid = ref_newton_schulz(jnp.asarray(b_p.numpy()))
    assert float(resid) <= krylov._NS_TARGET
    assert abs(float(resid) - float(want_resid)) < 1e-12
    np.testing.assert_allclose(x.numpy(), np.asarray(want_x), rtol=1e-9,
                               atol=1e-12)
    want = ref_build_precond(ref, dtype=jnp.float64)
    got = krylov.build_fdlf_precond(sys, device="cpu")
    assert got.kind == want.kind == "inverse"
    for g, w in ((got.bp, want.bp), (got.bq, want.bq)):
        assert g.dtype == torch.bfloat16
        g32 = g.float().numpy()
        w32 = np.asarray(w, np.float32)
        same = g32 == w32
        assert same.mean() >= 0.999
        # The rest differ by at most one bf16 ulp (2^-7 relative).
        rel = np.abs(g32 - w32)[~same] / np.abs(w32)[~same]
        assert np.all(rel <= 2.0 ** -7)


def test_precond_from_arrays_is_exact_and_lu_kind_agrees():
    ref = _ref_case("mesh118")
    sys = _port(ref)
    want = ref_build_precond(ref, dtype=jnp.float64)
    pc = krylov.FdlfPrecond.from_arrays(np.asarray(want.bp, np.float32),
                                        np.asarray(want.bq, np.float32),
                                        device="cpu")
    np.testing.assert_array_equal(pc.bp.float().numpy(),
                                  np.asarray(want.bp, np.float32))
    lu = krylov.build_fdlf_precond(sys, kind="lu", device="cpu")
    assert lu.kind == "lu" and lu.bp[0].dtype == F64
    s = torch.as_tensor(np.random.default_rng(4).normal(size=(3, 118)))
    d_th = krylov.precond_apply_half("lu")(lu.bp, s)
    b_p = decoupled_parts(sys, device="cpu").b_prime(None)
    np.testing.assert_allclose((d_th @ b_p.T).numpy(), s.numpy(), rtol=0,
                               atol=1e-12)
    d_inv = krylov.precond_apply_half("inverse")(pc.bp, s)
    assert d_inv.dtype == torch.bfloat16 and d_inv.shape == s.shape


@pytest.mark.parametrize("kind,n,platform", [
    ("auto", 100, "gpu"), ("auto", 5000, "gpu"), ("auto", 100, "cpu"),
    ("inverse", 5000, "gpu"), ("lu", 100, "gpu"),
])
def test_precond_kind_resolution_matches_reference(kind, n, platform):
    assert (krylov._resolve_precond_kind(kind, n, platform)
            == ref_resolve_kind(kind, n, backend=platform))
    assert krylov.default_precond_kind(n) == ref_default_kind(n)
    with pytest.raises(ValueError, match="unknown preconditioner kind"):
        krylov._resolve_precond_kind("qr", n, platform)


def _operators(seed, lanes, n=48):
    """Per-lane nonsymmetric, diagonally dominant operators with a
    Jacobi preconditioner."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1, (lanes, n, n))
    a = a @ a.transpose(0, 2, 1) + n * np.eye(n) + rng.normal(0, 2, (lanes, n, n))
    b = rng.normal(0, 1, (lanes, n))
    return a, b


def _ref_block(a, b, m, s):
    aj = jnp.asarray(a)
    d = jnp.diagonal(aj)
    return np.asarray(ref_pgmres_block(lambda u: aj @ u, lambda u: u / d,
                                       jnp.asarray(b), m=m, s=s))


def _port_block(a, b, m, s):
    at = torch.as_tensor(a)
    d = torch.diagonal(at, dim1=1, dim2=2)
    return krylov._pgmres_block(
        lambda u: torch.einsum("bij,bj->bi", at, u), lambda u: u / d,
        torch.as_tensor(b), m=m, s=s).numpy()


def test_scalar_gmres_matches_reference():
    a, b = _operators(0, 1)
    aj, at = jnp.asarray(a[0]), torch.as_tensor(a[0])
    want = ref_pgmres(lambda u: aj @ u, lambda u: u / jnp.diagonal(aj),
                      jnp.asarray(b[0]), m=16)
    got = krylov._pgmres(lambda u: at @ u, lambda u: u / torch.diagonal(at),
                         torch.as_tensor(b[0]), m=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_block_gmres_matches_reference_lane_by_lane(s):
    a, b = _operators(1, 3)
    got = _port_block(a, b, m=16, s=s)
    for lane in range(3):
        np.testing.assert_allclose(got[lane], _ref_block(a[lane], b[lane],
                                                         16, s),
                                   rtol=0, atol=1e-10)


def test_block_gmres_breakdown_lane_leaves_other_lanes_alone():
    """Lane 0 is tests/test_precision.py's breakdown case (2I, b = e₀: the
    chain dies at once); lanes 1-2 are healthy.  Each lane equals the
    reference's cycle on its own operator, and the broken-down lane
    returns the exact solve."""
    a, b = _operators(2, 3)
    a[0] = 2.0 * np.eye(48)
    b[0] = np.eye(48)[0]
    got = _port_block(a, b, m=8, s=4)
    assert np.all(np.isfinite(got))
    for lane in range(3):
        np.testing.assert_allclose(got[lane], _ref_block(a[lane], b[lane], 8, 4),
                                   rtol=0, atol=1e-10)
    assert np.linalg.norm(a[0] @ got[0] - b[0]) < 1e-10


def test_failed_cholesky_is_all_nan_and_zeroes_the_block():
    """jnp.linalg.cholesky returns an all-NaN factor for a matrix that is
    not positive definite, where torch's cholesky_ex keeps a partial one;
    the port keeps the reference's rule, so CholQR2 zeroes the block."""
    bad = np.diag([1.0, 1.0, -1.0, 1.0])
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(bad)))
    fac = sk._cholesky_or_nan(torch.as_tensor(np.stack([bad, np.eye(4)])))
    np.testing.assert_array_equal(fac[0].numpy(), want)  # NaN lower, 0 upper
    assert np.isnan(want[np.tril_indices(4)]).all()
    np.testing.assert_array_equal(fac[1].numpy(), np.eye(4))

    rng = np.random.default_rng(5)
    lanes, nvec, s = 2, 32, 4
    v_basis = torch.zeros(lanes, 9, nvec, dtype=F64)
    v0 = torch.as_tensor(rng.normal(size=(lanes, nvec)))
    v_basis[:, 0] = v0 / torch.linalg.vector_norm(v0, dim=1, keepdim=True)
    valid = torch.zeros(lanes, 9, dtype=F64)
    valid[:, 0] = 1.0
    w_blk = torch.as_tensor(rng.normal(size=(lanes, s, nvec)))
    w_blk[0, 1, 3] = float("inf")  # lane 0's Gram matrix is not finite
    one_v, one_valid = v_basis[1:].clone(), valid[1:].clone()
    sk.gmres_block_orth(v_basis, valid, w_blk, 0)
    assert (v_basis[0, 1:1 + s] == 0).all() and (valid[0, 1:1 + s] == 0).all()
    sk.gmres_block_orth(one_v, one_valid, w_blk[1:].clone(), 0)
    np.testing.assert_array_equal(v_basis[1].numpy(), one_v[0].numpy())
    np.testing.assert_array_equal(valid[1].numpy(), one_valid[0].numpy())
    assert (valid[1, 1:1 + s] == 1).all()


def test_host_oracles_match_reference():
    ref = _ref_case("mesh118")
    sys = _port(ref)
    n = ref.n_bus
    rng = np.random.default_rng(9)
    theta = rng.uniform(-0.2, 0.2, (2, n))
    v = rng.uniform(0.95, 1.05, (2, n))
    status = np.ones(ref.n_branch)
    status[[3, 40]] = 0.0
    for b in range(2):
        for st in (None, status):
            got = krylov.host_injections(sys, theta[b], v[b], status=st)
            want = ref_host_injections(ref, theta[b], v[b], status=st)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    lanes = NewtonResult(*[None] * 8)._replace(theta=torch.as_tensor(theta),
                                               v=torch.as_tensor(v))
    got = krylov.true_mismatch(sys, lanes)
    assert got.shape == (2,)
    for b in range(2):
        want = ref_true_mismatch(ref, NewtonResult(*[None] * 8)._replace(
            theta=theta[b], v=v[b]))
        assert abs(got[b] - want) <= 1e-12
