"""S4 ``gmres_lstsq``'s algorithm on the CPU, where its kernel cannot run.

``sparse_kernels.jacobi_lstsq`` / ``gmres_lstsq_jacobi`` mirror the
kernel's one-sided Jacobi least squares in PyTorch (its pair schedule,
rotation, convergence test and cutoff); here they are held against
``jnp.linalg.lstsq`` of the JAX reference, run on the CPU, on inputs made
with numpy from a seed: a GMRES cycle captured from the port's mesh118
Newton system, a rank-deficient H, an H of condition ~1e8 under the
float32 cutoff, an odd and the largest Krylov dimension, and non-finite
inputs.  Tolerance: 1e-10 relative (max |Δ| over max |reference|) in
float64 — the two SVDs are backward stable and the kept singular values
here lie within a condition of ~1e4, so their answers differ by a few
hundred ulps.  Also S4's launch plan (``lstsq_plan``) and the wrappers'
refusal of a device that is neither the CPU nor a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from freedm_tpu_torch.kernels import newton_kernels as nk
from freedm_tpu_torch.kernels import sparse_kernels as sk

F64 = torch.float64
REL = 1e-10
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The CPU path is many tiny ops: one torch thread (as in
    test_torch_krylov.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel(got, want):
    """max |got - want| / max |want| over the finite entries; the NaNs
    must sit in the same places."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    if not fin.any():
        return 0.0
    return np.abs(got[fin] - want[fin]).max() / np.abs(want[fin]).max()


def _ref_x(vb, valid, ws, zs, beta, rcond=None):
    """The reference's finish of ``_pgmres_block``, lane by lane."""
    def one(v, a, w, z, b):
        h = (v * a[:, None]) @ w.T
        rhs = jnp.zeros(h.shape[0], h.dtype).at[0].set(b)
        y, *_ = jnp.linalg.lstsq(h, rhs, rcond=rcond)
        return z.T @ y
    return np.asarray(jax.vmap(one)(*(jnp.asarray(np.asarray(t))
                                      for t in (vb, valid, ws, zs, beta))))


def _ref_y(h, beta, rcond=None):
    def one(hh, b):
        rhs = jnp.zeros(hh.shape[0], hh.dtype).at[0].set(b)
        return jnp.linalg.lstsq(hh, rhs, rcond=rcond)[0]
    return np.asarray(jax.vmap(one)(jnp.asarray(h), jnp.asarray(beta)))


@pytest.fixture(scope="module")
def mesh118_cycle():
    """The S4 inputs of one plain GMRES cycle (m = 16, s = 4) of the
    port's mesh118 Newton system at a random state, three lanes, lane 1
    with a zero right-hand side (its chain breaks down at once)."""
    sys_ = chip_smoke.case_system("mesh118")
    op, x, ps, qs, _, m_op = chip_smoke.sparse_setup(torch, sys_, 3, 13, F64,
                                                     device="cpu")
    ev, bv, f = sk.sparse_assemble_plain(x, ps, qs, op)
    caps = chip_smoke.gmres_captures(torch, sk, op, ev, bv, f, x, m_op)
    (_, vb, valid, ws, zs, beta), = [c for c in caps if c[0] == "lstsq"]
    return vb, valid, ws, zs, beta


def test_mirror_matches_reference_on_a_mesh118_cycle(mesh118_cycle):
    vb, valid, ws, zs, beta = mesh118_cycle
    assert vb.shape == (3, 17, 236) and float(beta[1]) == 0.0
    x, sweeps = sk.gmres_lstsq_jacobi(vb, valid, ws, zs, beta)
    assert _rel(x.numpy(), _ref_x(vb, valid, ws, zs, beta)) <= REL
    # ... and the plain version the CPU path takes.
    assert _rel(x.numpy(), sk.gmres_lstsq_plain(vb, valid, ws, zs,
                                                beta).numpy()) <= REL
    assert float(x[1].abs().max()) == 0.0
    # A zero H rotates nothing: its lane stops after one sweep.
    assert int(sweeps[1]) == 1
    assert all(3 <= int(sweeps[b]) < sk.MAX_SWEEPS for b in (0, 2))


def test_mirror_keeps_the_minimum_norm_solution_of_a_rank_deficient_h(
        mesh118_cycle):
    """Dead rows of V·valid: 4 of H's 17 rows are zero, so H has rank 13
    of 16 and the cutoff must drop three singular values."""
    vb, valid, ws, zs, beta = mesh118_cycle
    valid = valid.clone()
    valid[:, 5:9] = 0.0
    x, _ = sk.gmres_lstsq_jacobi(vb, valid, ws, zs, beta)
    want = _ref_x(vb, valid, ws, zs, beta)
    assert _rel(x.numpy(), want) <= REL
    h = (vb * valid[:, :, None]) @ ws.mT
    assert int(torch.linalg.matrix_rank(h[0])) == 13


def _conditioned(rng, lanes, mr, mm, sigma):
    h = np.empty((lanes, mr, mm))
    for b in range(lanes):
        u, _ = np.linalg.qr(rng.normal(size=(mr, mm)))
        v, _ = np.linalg.qr(rng.normal(size=(mm, mm)))
        h[b] = (u * sigma) @ v.T
    return h


def test_mirror_applies_the_float32_cutoff_at_condition_1e8():
    """Twelve singular values in [1e-4, 1], four in [1e-8, 3e-8]: the
    float32 cutoff (17 eps32 σ_max ≈ 2e-6) drops the four, as
    ``jnp.linalg.lstsq`` with the same ``rcond`` does."""
    rng = np.random.default_rng(21)
    sigma = np.concatenate([np.logspace(0, -4, 12), np.logspace(-7.5, -8, 4)])
    h = _conditioned(rng, 3, 17, 16, sigma)
    beta = rng.uniform(0.5, 2.0, 3)
    assert np.linalg.cond(h[0]) == pytest.approx(1e8, rel=1e-6)
    y, _ = sk.jacobi_lstsq(torch.as_tensor(h), torch.as_tensor(beta), EPS32)
    want = _ref_y(h, beta, rcond=EPS32 * 17)
    assert _rel(y.numpy(), want) <= REL
    # The float64 cutoff would keep all sixteen: another answer.
    y64, _ = sk.jacobi_lstsq(torch.as_tensor(h), torch.as_tensor(beta),
                             float(np.finfo(np.float64).eps))
    assert _rel(y64.numpy(), want) > 1.0


def _random_cycle(rng, lanes, mm, nvec):
    vb = rng.normal(size=(lanes, mm + 1, nvec))
    valid = np.ones((lanes, mm + 1))
    ws = rng.normal(size=(lanes, mm, nvec))
    zs = rng.normal(size=(lanes, mm, nvec))
    beta = rng.uniform(0.5, 2.0, lanes)
    return tuple(torch.as_tensor(a) for a in (vb, valid, ws, zs, beta))


@pytest.mark.parametrize("mm", [15, 32])
def test_mirror_matches_reference_at_odd_and_largest_krylov_dimension(mm):
    """mm = 15 pads a zero column (16 players); mm = 32 is MAX_KRYLOV,
    33 rows."""
    args = _random_cycle(np.random.default_rng(mm), 2, mm, 96)
    x, sweeps = sk.gmres_lstsq_jacobi(*args)
    assert x.shape == (2, 96)
    assert _rel(x.numpy(), _ref_x(*args)) <= REL
    assert (sweeps >= 3).all() and (sweeps < sk.MAX_SWEEPS).all()


def test_non_finite_h_or_beta_gives_nan():
    vb, valid, ws, zs, beta = _random_cycle(np.random.default_rng(5), 3, 16, 64)
    beta[0] = float("nan")
    vb[1, 3, 7] = float("inf")
    x, _ = sk.gmres_lstsq_jacobi(vb, valid, ws, zs, beta)
    want = _ref_x(vb, valid, ws, zs, beta)
    assert np.isnan(want[:2]).all() and not np.isnan(want[2]).any()
    assert _rel(x.numpy(), want) <= REL  # NaNs in the same places
    assert torch.equal(torch.isnan(x), torch.isnan(
        sk.gmres_lstsq_plain(vb, valid, ws, zs, beta)))


# ---------------------------------------------------------------------------
# The launch plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nvec", [28, 236, 4000, 10000])
@pytest.mark.parametrize("mm", [1, 15, 16, 32])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_lstsq_plan_tiles_the_columns_within_shared_memory(nvec, mm,
                                                           itemsize):
    plan = sk.lstsq_plan(nvec, mm, itemsize)
    b = plan.bounds
    assert len(b) == plan.ctas + 1 and 1 <= plan.ctas <= sk.LSTSQ_CTAS
    assert b[0] == 0 and b[-1] == nvec
    assert all(lo < hi for lo, hi in zip(b, b[1:]))  # a tile or more each
    assert all(c % sk.LSTSQ_TILE == 0 for c in b[:-1])
    tiles = -(-nvec // sk.LSTSQ_TILE)
    assert plan.ctas == min(sk.LSTSQ_CTAS, tiles)
    stages = 2 * (2 * mm + 1) * sk.LSTSQ_TILE * itemsize
    assert stages < plan.smem <= sk.SMEM_LIMIT


def test_lstsq_plan_at_the_served_shapes():
    """mesh2000 (N = 4000): 8 CTAs of 7-8 tiles, 35 KB each in float64
    (six CTAs an SM); mesh118 (N = 236): 4 CTAs of one tile."""
    plan = sk.lstsq_plan(4000, 16, 8)
    assert plan.ctas == 8 and plan.smem == 35120
    assert plan.bounds == (0, 448, 960, 1472, 1984, 2496, 3008, 3520, 4000)
    assert sk.lstsq_plan(4000, 16, 4).smem < plan.smem
    assert sk.lstsq_plan(236, 16, 8).bounds == (0, 64, 128, 192, 236)
    assert sk.lstsq_plan(10000, 32, 8).smem <= sk.SMEM_LIMIT


@pytest.mark.parametrize("nvec,mm", [(64, 0), (64, 33), (0, 16)])
def test_lstsq_plan_refuses_what_the_kernel_does_not_take(nvec, mm):
    with pytest.raises(ValueError, match="unsupported"):
        sk.lstsq_plan(nvec, mm, 8)


# ---------------------------------------------------------------------------
# The wrappers take the plain version on the CPU and launch only on a card
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=F64):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_lstsq_wrapper_refuses_a_device_that_is_not_a_card(monkeypatch):
    """Meta tensors of a shape S4 takes pass the checks but are not CUDA
    tensors: the wrapper raises before the library is loaded."""
    def no_launch(*args):
        raise AssertionError("reached the kernel library")

    monkeypatch.setattr(sk, "_fn", no_launch)
    before = sk.launches()
    with pytest.raises(ValueError, match="CPU or CUDA tensors"):
        sk.gmres_lstsq(_meta(2, 17, 64), _meta(2, 17), _meta(2, 16, 64),
                       _meta(2, 16, 64), _meta(2))
    assert sk.launches() == before


def test_update_wrapper_refuses_a_device_that_is_not_a_card(monkeypatch):
    def no_lib():
        raise AssertionError("reached the kernel library")

    monkeypatch.setattr(nk, "_newton_lib", no_lib)
    monkeypatch.setattr(nk, "_k3_carry", None)
    before = nk.launches()
    x = _meta(3, 28)
    with pytest.raises(ValueError, match="CPU or CUDA tensors"):
        nk.newton_update(x, _meta(3, 28), _meta(3, 28), _meta(28),
                         _meta(3, dtype=torch.int32), _meta(3),
                         _meta(3, dtype=torch.bool), 5, _meta(1))
    with pytest.raises(ValueError, match="it must be"):
        nk.newton_update(x, _meta(3, 28), _meta(3, 28), _meta(28),
                         _meta(3), _meta(3), _meta(3, dtype=torch.bool), 5,
                         _meta(1))
    assert nk.launches() == before


def test_update_wrapper_takes_the_plain_version_on_the_cpu():
    """On CPU tensors K3's wrapper runs its plain version, whatever carry
    it saw last, and counts no launch."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(2, 6)))
    dx = torch.as_tensor(rng.normal(size=(2, 6)))
    f = torch.as_tensor(rng.normal(size=(2, 6)))
    free = torch.ones(6, dtype=F64)
    carry = [torch.zeros(2, dtype=torch.int32), torch.full((2,), np.inf,
                                                            dtype=F64),
             torch.ones(2, dtype=torch.bool)]
    want = x + dx
    before = nk.launches()
    nk.newton_update(x, dx, f, free, *carry, 5, torch.zeros(1, dtype=F64))
    assert torch.equal(x, want) and carry[0].tolist() == [1, 1]
    assert nk.launches() == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mm,nvec", [(1, 28), (15, 236), (16, 4000),
                                     (32, 10000)])
def test_lstsq_kernel_matches_plain_version_and_mirror_on_card(cuda_device,
                                                               mm, nvec):
    """S4 at odd, served and largest Krylov dimensions, ragged last
    tiles, in both dtypes: within chip_smoke.py's SPARSE_TOL of its plain
    version and of its mirror, bit-identical on repeat."""
    from chip_smoke import SPARSE_TOL

    for dtype in (F64, torch.float32):
        tol = SPARSE_TOL[str(dtype)[6:]][1]
        args = [a.to(cuda_device, dtype) for a in _random_cycle(
            np.random.default_rng(mm + nvec), 3, mm, nvec)]
        args[1][2, mm // 2:] = 0.0  # dead rows in lane 2
        got = sk.gmres_lstsq(*args)
        assert torch.equal(got, sk.gmres_lstsq(*args))
        for want in (sk.gmres_lstsq_plain(*args),
                     sk.gmres_lstsq_jacobi(*args)[0]):
            assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= tol
    torch.cuda.synchronize()
