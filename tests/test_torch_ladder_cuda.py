"""L1 ``ladder_solve`` on the card: its cluster route (a lane a
thread-block cluster, the lane's state in distributed shared memory) at
``synthetic_radial(10000)`` × {1, 8, 64} lanes and its global route above
the cluster route's capacity, against the plain PyTorch version in fixed,
fixed-with-saved-iterates and solve modes, float64 (1e-10 pu) and float32
(1e-4 pu; a lane's flag is held only where its residual lies more than
``F32_FLAG_ULPS`` float32 ulps of the root current from eps); a lane's
outputs the same bits in launches of 1, 8 and 64 lanes and on repeat; L2's
gradient from the cluster route's saved iterates within rtol 1e-8 of
``torch.autograd`` of the plain fixed solve.  Every test needs a CUDA card
and skips without one (``chip_smoke.py`` runs these checks at the full
widths).  No JAX: the plain version is held to the reference on the CPU by
``tests/test_torch_ladder.py``, which also tests ``ladder_plan``."""

import numpy as np
import pytest
import torch

from freedm_tpu_torch.cplx import C
import chip_smoke
from chip_smoke import broom_feeder
from freedm_tpu_torch.grid import cases
from freedm_tpu_torch.kernels import ladder_kernels as lk
from freedm_tpu_torch.pf.ladder import make_ladder_solver, total_loss_kw

F64, F32 = torch.float64, torch.float32
ATOL = {F64: 1e-10, F32: 1e-4}
EPS = 1e-4
ITERS = 20
F32_FLAG_ULPS = 64
GRAD_RTOL = 1e-8
FIELDS = ("v", "i_branch", "i_load")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")
    return torch.device("cuda")


_FEEDERS = {}


def feeder(nb):
    if nb not in _FEEDERS:
        _FEEDERS[nb] = cases.synthetic_radial(nb, seed=0, load_kw=1.0)
    return _FEEDERS[nb]


def preorder_inputs(f, lanes, dtype, device):
    return chip_smoke.preorder_inputs(torch, lk, f, lanes, dtype)


def lane(x, k):
    return C(x.re[k:k + 1].contiguous(), x.im[k:k + 1].contiguous())


def gap(a, b, pick):
    return max(float((getattr(a, f).re - getattr(b, f).re)[pick].abs().max())
               for f in FIELDS)


def check_against_plain(s, v0, op, dtype, fixed, save):
    got = lk.ladder_solve(s, v0, op, EPS, ITERS, fixed, save)
    again = lk.ladder_solve(s, v0, op, EPS, ITERS, fixed, save)
    want = lk.ladder_solve_plain(s, v0, op, EPS, ITERS, fixed, save)
    torch.cuda.synchronize()
    for f in FIELDS:
        assert torch.equal(getattr(got, f).re, getattr(again, f).re), f
        assert torch.equal(getattr(got, f).im, getattr(again, f).im), f
    clear = torch.ones_like(want.converged)
    if dtype == F32:
        i_root = want.i_branch.abs()[:, op.root > 0].flatten(1).amax(1)
        band = F32_FLAG_ULPS * torch.finfo(F32).eps * i_root
        clear = (want.residual - EPS).abs() > band
    assert torch.equal(got.converged[clear], want.converged[clear])
    pick = (torch.ones_like(clear) if fixed
            else got.converged & want.converged)
    if dtype == F64:
        assert torch.equal(got.iterations, want.iterations)
    assert gap(got, want, pick) <= ATOL[dtype]
    if save:
        assert got.saved.shape == (ITERS,) + tuple(s.re.shape[:2]) + (6,)
        assert float((got.saved - want.saved).abs().max()) <= ATOL[dtype]
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 8, 64])
@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("mode", ["fixed", "save", "solve"])
def test_cluster_route_matches_plain_at_10k(cuda_device, lanes, dtype, mode):
    s, v0, op = preorder_inputs(feeder(10000), lanes, dtype, cuda_device)
    assert lk.ladder_plan(op.nb, dtype).route == "cluster"
    check_against_plain(s, v0, op, dtype, fixed=mode != "solve",
                        save=mode == "save")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("fixed", [True, False])
def test_a_lane_is_the_same_bits_in_launches_of_1_8_and_64(cuda_device,
                                                            dtype, fixed):
    s, v0, op = preorder_inputs(feeder(10000), 64, dtype, cuda_device)
    wide = lk.ladder_solve(s, v0, op, EPS, ITERS, fixed)
    mid = lk.ladder_solve(C(s.re[:8].contiguous(), s.im[:8].contiguous()),
                          C(v0.re[:8].contiguous(), v0.im[:8].contiguous()),
                          op, EPS, ITERS, fixed)
    for k in (0, 5, 7):
        one = lk.ladder_solve(lane(s, k), lane(v0, k), op, EPS, ITERS, fixed)
        torch.cuda.synchronize()
        for f in FIELDS:
            for part in ("re", "im"):
                a = getattr(getattr(one, f), part)[0]
                assert torch.equal(a, getattr(getattr(mid, f), part)[k]), f
                assert torch.equal(a, getattr(getattr(wide, f), part)[k]), f
        assert int(one.iterations[0]) == int(wide.iterations[k])
        assert torch.equal(one.residual[0], wide.residual[k])


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [9, 512, 2000, 20000])
def test_cluster_route_matches_plain_on_other_feeders(cuda_device, nb):
    # float32 flags of a 20k-branch lane are rounding: its root current
    # sums 20k rounded terms, beyond the F32_FLAG_ULPS band (a lane's flag
    # differed on an H100); 20k runs in float64, flags held exactly.
    f = cases.vvc_9bus() if nb == 9 else feeder(nb)
    for dtype in (F64,) if nb > 10000 else (F64, F32):
        s, v0, op = preorder_inputs(f, 8, dtype, cuda_device)
        assert lk.ladder_plan(op.nb, dtype).route == "cluster"
        for fixed in (True, False):
            check_against_plain(s, v0, op, dtype, fixed, save=False)


@pytest.mark.cuda
def test_cluster_route_past_the_staged_group_members(cuda_device):
    f = broom_feeder(10000, 3000)
    for dtype in (F64, F32):
        s, v0, op = preorder_inputs(f, 4, dtype, cuda_device)
        plan = lk.ladder_plan(op.nb, dtype)
        ptr = op.grp_ptr.cpu().numpy()
        slices = [ptr[hi] - ptr[lo] for lo, hi in plan.intervals(op.nb)]
        assert max(slices) > 2 * plan.threads  # the overflow path runs
        for fixed in (True, False):
            check_against_plain(s, v0, op, dtype, fixed, save=False)


@pytest.mark.cuda
def test_global_route_above_the_cluster_capacity(cuda_device):
    f = cases.synthetic_radial(lk.cluster_capacity(F64) + 424, seed=3,
                               load_kw=1.0)
    s, v0, op = preorder_inputs(f, 3, F64, cuda_device)
    assert lk.ladder_plan(op.nb, F64).route == "global"
    for fixed, save in ((True, False), (True, True), (False, False)):
        check_against_plain(s, v0, op, F64, fixed, save)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 8])
def test_l2_gradient_from_the_cluster_route(cuda_device, lanes):
    f = feeder(10000)
    scale = np.random.default_rng(1).uniform(0.7, 1.3, (lanes, 1, 1))
    loads = scale * f.s_load[None]
    p = torch.tensor(loads.real, dtype=F64, device=cuda_device)
    grads = []
    for plain in (False, True):
        _, fixed = make_ladder_solver(f, device=cuda_device, plain=plain)
        q = torch.tensor(loads.imag, dtype=F64, device=cuda_device,
                         requires_grad=True)
        loss = total_loss_kw(f, fixed((p, q))).sum()
        grads.append(torch.autograd.grad(loss, q)[0])
    torch.cuda.synchronize()
    g, want = grads
    assert torch.all(torch.isfinite(g))
    np.testing.assert_allclose(g.cpu().numpy(), want.cpu().numpy(),
                               rtol=GRAD_RTOL, atol=1e-10)


@pytest.mark.cuda
def test_resident_clusters_of_the_10k_plan(cuda_device):
    for dtype in (F64, F32):
        plan = lk.ladder_plan(10000, dtype)
        assert lk.resident_clusters(plan, dtype, cuda_device) >= 1
