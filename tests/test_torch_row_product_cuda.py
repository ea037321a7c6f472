"""The tiled complex product of ``csrc/row_product.cuh`` (K2
``power_injections`` with one Ybus, F1 ``fdlf_half_step`` in its tile mode
and I1 ``cim_iterate``) on the card against the plain PyTorch versions, at
ragged bus and lane counts in float64 and float32; bit-identical on
repeat; F1's tiled product K2's bits; the wrappers' refusals.  Every
``cuda`` test skips without a card (``chip_smoke.py`` runs the same checks
at the full widths).  The split plan (``newton_kernels.product_splits``)
is plain Python and tested here on the CPU.  No JAX: the plain versions
are held to the reference by ``tests/test_torch_newton.py``,
``test_torch_fdlf.py`` and ``test_torch_cim.py``."""

import math

import numpy as np
import pytest
import torch

from freedm_tpu_torch.grid.bus import PQ, SLACK, ybus_dense
from freedm_tpu_torch.grid.cases import synthetic_mesh, synthetic_radial
from freedm_tpu_torch.grid.matpower import load_builtin
from freedm_tpu_torch.kernels import build
from freedm_tpu_torch.kernels import newton_kernels as nk
from freedm_tpu_torch.kernels import solver_kernels as sol
from freedm_tpu_torch.pf.cim import make_cim_solver

ATOL = {torch.float64: 1e-10, torch.float32: 1e-3}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")
    return torch.device("cuda")


def system(name):
    if name.startswith("mesh"):  # 31 buses: odd n, one-element copies
        return synthetic_mesh(int(name[4:]), seed=1, load_mw=10.0,
                              chord_frac=1.0)
    return load_builtin(name)


def k2_inputs(sys_, lanes, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    n = sys_.n_bus

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    x = np.concatenate([rng.uniform(-0.3, 0.3, (lanes, n)),
                        rng.uniform(0.9, 1.1, (lanes, n))], axis=1)
    scale = rng.uniform(0.5, 1.2, (lanes, 1))
    y_re, y_im = ybus_dense(sys_, dtype=dtype, device=device)
    bt = np.asarray(sys_.bus_type)
    return (t(x), y_re, y_im, t(scale * sys_.p_inj), t(scale * sys_.q_inj),
            t(bt != SLACK), t(bt == PQ), t(sys_.v_set))


def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# The split plan (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 16, 17, 118, 511, 2000, 3000])
@pytest.mark.parametrize("lanes", [1, 3, 64, 67, 1024])
def test_split_plan_cuts_whole_nonempty_slices(n, lanes):
    s = nk.product_splits(n, lanes)
    stages = math.ceil(n / nk.TILE_K)
    assert 1 <= s <= min(nk.MAX_SPLITS, stages)
    per = math.ceil(stages / s)
    assert (s - 1) * per < stages  # the last slice holds a column
    assert s == nk.product_splits(n, lanes)  # the shape alone decides


def test_split_plan_picks_the_measured_best():
    # mesh2000 x 64 (K2) and the CIM feeder, n = 3000, x 64 (I1): the
    # slice counts the H100 ran fastest (newton_kernels.product_splits).
    assert nk.product_splits(2000, 64) == 8
    assert nk.product_splits(3000, 64) == 8
    # Wide lane counts fill the card without cutting K.
    assert nk.product_splits(2000, 1024) == 1
    assert all(nk.product_splits(n, 1) <= nk.MAX_SPLITS
               for n in range(1, 4000, 97))


def test_split_plan_reads_the_tile_from_the_header():
    text = (build.CSRC_DIR / "row_product.cuh").read_text()
    for name, value in (("kTileRows", nk.TILE_ROWS),
                        ("kTileLanes", nk.TILE_LANES),
                        ("kTileK", nk.TILE_K), ("kMaxSplits", nk.MAX_SPLITS)):
        assert f"constexpr int {name} = {value};" in text


def test_split_plan_refuses_empty_shapes():
    with pytest.raises(ValueError, match="n, lanes > 0"):
        nk.product_splits(0, 4)
    with pytest.raises(ValueError, match="n, lanes > 0"):
        nk.product_splits(10, 0)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["case14", "mesh31", "mesh118"])
@pytest.mark.parametrize("lanes", [1, 3, 67])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k2_matches_plain_on_card(cuda_device, name, lanes, dtype):
    args = k2_inputs(system(name), lanes, dtype, cuda_device, seed=lanes)
    got = nk.power_injections(*args)
    want = nk.power_injections_plain(*args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=ATOL[dtype])
    assert same(got, nk.power_injections(*args))


def f1_modes(fn, x, y, ps, thf, vf, d, active):
    lanes, n = ps.shape
    x = x.clone()
    dp, dq = torch.zeros_like(ps), torch.zeros_like(ps)
    err = torch.full((lanes,), float("inf"), dtype=x.dtype, device=x.device)
    it = torch.zeros(lanes, dtype=torch.int32, device=x.device)
    act = active.clone()
    tol = torch.full((1,), 1e-8, dtype=x.dtype, device=x.device)
    for mode in (sol.INIT, sol.THETA, sol.VHALF):
        fn(mode, x, None if mode == sol.INIT else d, y[0], y[1], ps,
           0.3 * ps, thf, vf, dp, dq, err, it, act, tol, 10, False)
    return x, dp, dq, err, it, act


@pytest.mark.cuda
@pytest.mark.parametrize("name,lanes", [("case14", 5), ("mesh31", 67),
                                        ("mesh118", 130)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_f1_tile_mode_matches_plain_on_card(cuda_device, name, lanes, dtype):
    assert lanes >= sol.TILED_MIN_LANES
    sys_ = system(name)
    args = k2_inputs(sys_, lanes, dtype, cuda_device, seed=7)
    x, y, ps, thf, vf = args[0], args[1:3], args[3], args[5], args[6]
    rng = np.random.default_rng(3)
    d = torch.as_tensor(rng.normal(0, 1e-3, ps.shape), dtype=dtype,
                        device=cuda_device)
    active = torch.as_tensor(np.arange(lanes) % 3 != 1, device=cuda_device)
    got = f1_modes(sol.fdlf_half_step, x, y, ps, thf, vf, d, active)
    want = f1_modes(sol.fdlf_half_step_plain, x, y, ps, thf, vf, d, active)
    for a, b in zip(got, want):
        if a.is_floating_point():
            torch.testing.assert_close(a, b, rtol=0, atol=ATOL[dtype])
        else:
            assert torch.equal(a, b)
    assert same(got, f1_modes(sol.fdlf_half_step, x, y, ps, thf, vf, d,
                               active))


@pytest.mark.cuda
@pytest.mark.parametrize("name,lanes", [("case14", 5), ("mesh31", 67)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_f1_tiled_product_is_k2_bits(cuda_device, name, lanes, dtype):
    # |V| = 1, zero schedules, every quantity free: F1's INIT mismatch is
    # exactly -(P, Q) of its product.
    sys_ = system(name)
    n = sys_.n_bus
    rng = np.random.default_rng(11)
    th = torch.as_tensor(rng.uniform(-0.3, 0.3, (lanes, n)), dtype=dtype,
                         device=cuda_device)
    x = torch.cat([th, torch.ones_like(th)], 1)
    y = ybus_dense(sys_, dtype=dtype, device=cuda_device)
    zero, one = torch.zeros_like(th), torch.ones(n, dtype=dtype,
                                                  device=cuda_device)
    p, q, _ = nk.power_injections(x, y[0], y[1], zero, zero, one, one, one)
    dp, dq = torch.zeros_like(th), torch.zeros_like(th)
    sol.fdlf_half_step(sol.INIT, x, None, y[0], y[1], zero, zero, one, one,
                       dp, dq, torch.zeros(lanes, dtype=dtype,
                                           device=cuda_device),
                       torch.zeros(lanes, dtype=torch.int32,
                                   device=cuda_device),
                       torch.ones(lanes, dtype=torch.bool, device=cuda_device),
                       torch.zeros(1, dtype=dtype, device=cuda_device), 10,
                       False)
    assert torch.equal(dp, -p) and torch.equal(dq, -q)


@pytest.mark.cuda
@pytest.mark.parametrize("nodes", [40, 41])  # N = 117, 120 node-phases
@pytest.mark.parametrize("lanes", [3, 67])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_i1_matches_plain_on_card(cuda_device, nodes, lanes, dtype):
    f = synthetic_radial(nodes, seed=0, load_kw=1.0)
    ties = [(f.n_nodes - 1, f.n_nodes // 2, f.z_pu[0])]
    rng = np.random.default_rng(nodes + lanes)
    s = rng.uniform(0.7, 1.3, (lanes, 1, 1)) * f.s_load[None]
    runs = []
    for plain in (False, True, False):
        solve, _ = make_cim_solver(f, ties=ties, dtype=dtype,
                                   device=cuda_device, plain=plain,
                                   max_iter=40)
        r = solve(s)
        runs.append((r.v_node.re, r.v_node.im, r.iterations, r.converged))
    got, want, again = runs
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=ATOL[dtype])
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert same(got, again)


@pytest.mark.cuda
def test_wrappers_refuse_bad_operands_on_card(cuda_device):
    args = list(k2_inputs(system("case14"), 4, torch.float64, cuda_device))
    bad = list(args)
    bad[0] = torch.cat([args[0], args[0]], 1)[:, ::2]  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        nk.power_injections(*bad)
    bad = list(args)
    bad[1] = args[1][:-1]  # Ybus of the wrong shape
    with pytest.raises(ValueError, match="contiguous"):
        nk.power_injections(*bad)
    f = synthetic_radial(40, seed=0, load_kw=1.0)
    solve, _ = make_cim_solver(f, device=cuda_device)
    lanes, big_n = 2, 3 * f.n_branches
    v = torch.ones(lanes, big_n, dtype=torch.float64, device=cuda_device)
    a = torch.zeros(big_n, big_n + 1, dtype=torch.float64, device=cuda_device)
    carry = (torch.zeros(lanes, dtype=torch.float64, device=cuda_device),
             torch.zeros(lanes, dtype=torch.int32, device=cuda_device),
             torch.ones(lanes, dtype=torch.bool, device=cuda_device),
             torch.zeros(1, dtype=torch.float64, device=cuda_device))
    with pytest.raises(ValueError):
        sol.cim_iterate(a, a, v, v, v, v, v, v, v[0], *carry, 5, True)
