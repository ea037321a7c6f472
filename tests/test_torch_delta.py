"""C1's algorithm on the CPU: the pivots as a permutation, the kernel's
substitution mirror, and the delta program run on the mirror's solves,
against ``torch.linalg.lu_solve`` and the JAX package.

- ``lu_permutation`` + ``lu_solve_mirror`` equal ``lu_solve`` on the
  cached B′ and B″ factors of mesh118 and mesh2000, one and eight
  right-hand sides: 1e-12 relative in float64 and 1e-5 in float32 (two
  orders of the same substitution);
- the delta program on the mirror's solves (``delta_program_plain``)
  against the reference's ``_build_delta_program`` at mesh118 over
  seeded 1-16-bus deltas: f64 within 1e-9 pu with equal sweep counts,
  mixed within 2e-4 pu and ±1 sweep, as ``tests/test_torch_cache.py``
  holds the plain loop;
- the host-side pieces of the card's program: the factor layout the
  kernel's tensor maps read, and the one-copy unpacking of its results.

The kernel itself runs only on the card (``chip_smoke.py`` and the
``cuda``-marked test in ``tests/test_torch_cache.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freedm_tpu.grid import cases as ref_cases
from freedm_tpu.pf.krylov import build_fdlf_precond as ref_build_fdlf_precond
from freedm_tpu.pf.newton import make_newton_solver as ref_make_newton_solver
from freedm_tpu.serve import cache as ref_cache
from freedm_tpu_torch.grid.bus import BusSystem
from freedm_tpu_torch.kernels import cache_kernels as ck
from freedm_tpu_torch.pf.krylov import build_fdlf_precond
from freedm_tpu_torch.pf.mfree import delta_operands
from freedm_tpu_torch.serve.cache import DELTA_MAX_SWEEPS

TOL = 1e-8  # the delta program's exit bar
REL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _mesh(n):
    ref = ref_cases.synthetic_mesh(n, seed=1, load_mw=10.0, chord_frac=1.0)
    return ref, BusSystem.from_arrays(dataclasses.asdict(ref))


@pytest.fixture(scope="module", params=[118, 2000])
def factors(request):
    """The cached B′/B″ LU pair of one mesh, as the serving cache builds
    it."""
    _, sys = _mesh(request.param)
    pc = build_fdlf_precond(sys, kind="lu", device="cpu")
    return sys.n_bus, {"bp": pc.bp, "bq": pc.bq}


@pytest.mark.parametrize("which", ["bp", "bq"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lanes", [1, 8])
def test_mirror_solve_matches_lu_solve(factors, which, dtype, lanes):
    n, pair = factors
    lu = (pair[which][0].to(dtype), pair[which][1])
    rhs = torch.as_tensor(np.random.default_rng(n + lanes).normal(
        size=(lanes, n)), dtype=dtype)
    got = ck.lu_solve_mirror(lu, rhs)
    want = torch.linalg.lu_solve(lu[0], lu[1], rhs.T).T
    assert got.dtype is dtype and got.shape == (lanes, n)
    rel = float((got - want).norm() / want.norm())
    assert rel <= REL[dtype], rel


def test_lu_permutation_is_the_pivots_row_swaps():
    a = torch.as_tensor(np.random.default_rng(3).normal(size=(37, 37)))
    lu_mat, piv = torch.linalg.lu_factor(a)
    perm = ck.lu_permutation(piv)
    p, _, _ = torch.lu_unpack(lu_mat, piv)
    b = torch.arange(37, dtype=torch.float64)
    assert perm.dtype is torch.int64
    assert sorted(perm.tolist()) == list(range(37))
    assert torch.equal(b[perm], p.T @ b)


@pytest.fixture(scope="module")
def mesh118_base():
    """``(reference system, port system, converged (theta, v))``."""
    ref, sys = _mesh(118)
    solve, _ = ref_make_newton_solver(ref)
    r = solve()
    assert bool(r.converged)
    return ref, sys, np.asarray(r.theta), np.asarray(r.v)


def _deltas(sys, rng, count):
    out = []
    for _ in range(count):
        p = np.asarray(sys.p_inj, np.float64).copy()
        q = np.asarray(sys.q_inj, np.float64).copy()
        for j in rng.choice(sys.n_bus, size=int(rng.integers(1, 17)),
                            replace=False):
            p[j] += rng.uniform(-0.05, 0.05)
            q[j] += rng.uniform(-0.02, 0.02)
        out.append((p, q))
    return out


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_program_on_mirror_solves_matches_reference(mesh118_base, precision):
    ref, sys, th0, v0 = mesh118_base
    mixed = precision == "mixed"
    ref_fn = ref_cache._build_delta_program(
        ref, ref_build_fdlf_precond(ref, dtype=jnp.float64, kind="lu"), TOL,
        DELTA_MAX_SWEEPS, jnp.float64, precision=precision)
    pc = build_fdlf_precond(sys, kind="lu", device="cpu")
    lu_p, lu_q = pc.bp, pc.bq
    if mixed:
        lu_p = (lu_p[0].float(), lu_p[1])
        lu_q = (lu_q[0].float(), lu_q[1])
    op = delta_operands(sys, device="cpu")
    deltas = _deltas(sys, np.random.default_rng(71), 6)
    lanes = [torch.as_tensor(np.stack(a)) for a in (
        [th0] * len(deltas), [v0] * len(deltas), [p for p, _ in deltas],
        [q for _, q in deltas])]
    got = ck.delta_program_plain(op, lu_p, lu_q, *lanes, DELTA_MAX_SWEEPS,
                                 TOL, mixed, solve=ck.lu_solve_mirror)
    bound = 2e-4 if mixed else 1e-9
    for b, (p, q) in enumerate(deltas):
        want = ref_fn(th0, v0, p, q)
        for k in range(4):  # theta, v, p_calc, q_calc
            assert np.max(np.abs(got[k][b].numpy()
                                 - np.asarray(want[k]))) <= bound, (b, k)
        sweeps, ref_sweeps = int(got[5][b]), int(want[5])
        assert 0 < sweeps <= DELTA_MAX_SWEEPS
        if mixed:
            assert abs(sweeps - ref_sweeps) <= 1
        else:
            assert sweeps == ref_sweeps
            assert (float(got[4][b]) < TOL) == (float(want[4]) < TOL)


@pytest.mark.parametrize("n,dtype,lda", [
    (118, torch.float32, 120), (118, torch.float64, 118),
    (117, torch.float64, 118), (2000, torch.float32, 2000)])
def test_kernel_factor_is_column_major_with_aligned_columns(n, dtype, lda):
    lu_mat, _ = torch.linalg.lu_factor(torch.as_tensor(
        np.random.default_rng(n).normal(size=(n, n))))
    buf, got_lda = ck.kernel_factor(lu_mat, dtype)
    assert got_lda == lda and buf.shape == (n, lda) and buf.is_contiguous()
    assert (lda * buf.element_size()) % 16 == 0
    assert torch.equal(buf[:, :n], lu_mat.T.to(dtype))
    # An aligned float64 factor is read in place.
    assert (buf.data_ptr() == lu_mat.data_ptr()) == (
        dtype is torch.float64 and lda == n)


def test_results_to_host_unpacks_one_buffer():
    n, lanes = 5, 3
    packed = torch.arange(lanes * (4 * n + 2), dtype=torch.float64).reshape(
        lanes, 4 * n + 2)
    packed.view(torch.int32)[:, 2 * (4 * n + 1)] = torch.tensor(
        [4, 6, 30], dtype=torch.int32)
    res = ck.DeltaResult(())
    res.packed = packed
    theta, v, p, q, err, sweeps = ck.results_to_host(res)
    for k, part in enumerate((theta, v, p, q)):
        assert np.array_equal(part, packed[:, k * n:(k + 1) * n].numpy())
    assert np.array_equal(err, packed[:, 4 * n].numpy())
    assert sweeps.tolist() == [4, 6, 30]
    one = ck.DeltaResult(())
    one.packed = packed[1]
    assert int(ck.results_to_host(one)[5]) == 6
    # Results without a packed buffer come back one copy each.
    plain = (torch.zeros(2), torch.ones(2))
    assert [a.tolist() for a in ck.results_to_host(plain)] == [[0, 0], [1, 1]]


def test_program_refuses_lanes_of_different_shapes(mesh118_base):
    _, sys, th0, v0 = mesh118_base
    pc = build_fdlf_precond(sys, kind="lu", device="cpu")
    prog = ck.DeltaProgram(delta_operands(sys, device="cpu"), pc.bp, pc.bq,
                           5, TOL)
    p = np.asarray(sys.p_inj, np.float64)
    with pytest.raises(ValueError, match="one shape"):
        prog(np.stack([th0, th0]), v0, p, p)
