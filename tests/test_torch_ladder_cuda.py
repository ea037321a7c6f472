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
widths).  L2's two routes (``ladder_plan``, since the cluster route came to
L2): the cluster route at 10k × {1, 8, 64, 65} lanes in float64 and
float32 against its plain version on the same saved iterates (rtol
``GRAD_RTOL`` / ``L2_F32_RTOL`` of the largest cotangent) and against
``torch.autograd`` of the plain fixed solve, a lane's bits the same in
launches of 1, 8 and 64 lanes, and both routes at the cluster capacity
and one branch above.  No JAX: the plain version is held to the reference
on the CPU by ``tests/test_torch_ladder.py``, which also tests
``ladder_plan`` (``tests/test_torch_ladder_vjp_plan.py`` L4's plan and
the crossover)."""

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
L2_F32_RTOL = chip_smoke.L2_F32_RTOL
# The float32 loss gradient against autograd of the plain float32 solve:
# it goes through each one's forward solve too (L1 against its plain
# version, 1e-4 pu in float32) and the loss, a difference of two sums of
# the lane's power (1.0e-4 of the largest gradient at 10k x 8 on an H100).
L2_F32_GRAD_RTOL = 1e-3
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


def check_against_plain(s, v0, op, dtype, fixed, save, plan=None):
    got = lk.ladder_solve(s, v0, op, EPS, ITERS, fixed, save, plan=plan)
    again = lk.ladder_solve(s, v0, op, EPS, ITERS, fixed, save, plan=plan)
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
    # Below the measured crossover (vvc_9bus) the plan takes the global
    # route; the cluster route is launched there through its own plan.
    f = cases.vvc_9bus() if nb == 9 else feeder(nb)
    for dtype in (F64,) if nb > 10000 else (F64, F32):
        s, v0, op = preorder_inputs(f, 8, dtype, cuda_device)
        plan = lk.route_plan(op.nb, dtype, "cluster")
        assert (lk.ladder_plan(op.nb, dtype) == plan) == (
            op.nb >= lk.CLUSTER_FROM)
        for fixed in (True, False):
            check_against_plain(s, v0, op, dtype, fixed, save=False,
                                plan=plan)


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
@pytest.mark.parametrize("lanes", [64, 1536])
@pytest.mark.parametrize("route", ["cluster", "global"])
@pytest.mark.parametrize("nb", [9, 128, 511])
def test_both_routes_of_l1_and_l2_below_the_crossover(cuda_device, nb, route,
                                                      lanes):
    """Either route, launched through its plan, against the plain
    versions at the widths the small feeders run (the served bursts' 64
    lanes, QSTS's 24 x 64): L1 in float64 and float32, L2 on the plain
    solve's saved iterates."""
    f = cases.vvc_9bus() if nb == 9 else feeder(nb)
    for dtype in (F64, F32):
        s, v0, op = preorder_inputs(f, lanes, dtype, cuda_device)
        plan = lk.route_plan(op.nb, dtype, route)
        check_against_plain(s, v0, op, dtype, True, save=False, plan=plan)
        want = lk.ladder_solve_plain(s, v0, op, EPS, ITERS, True, save=True)
        gs = chip_smoke._cotangents(torch, np.random.default_rng(4), lanes,
                                    op.nb, dtype)
        got = chip_smoke._flat_vjp(lk.ladder_vjp(want.saved, s, op, *gs,
                                                 plan=plan))
        ref = chip_smoke._flat_vjp(lk.ladder_vjp_plain(want.saved, s, op,
                                                       *gs))
        top = max(float(w.abs().max()) for w in ref)
        rel = max(float((g - w).abs().max()) for g, w in zip(got, ref)) / top
        assert rel <= (GRAD_RTOL if dtype == F64 else L2_F32_RTOL)


@pytest.mark.cuda
def test_a_plan_of_neither_route_is_refused(cuda_device):
    s, v0, op = preorder_inputs(cases.vvc_9bus(), 2, F64, cuda_device)
    bad = lk.route_plan(op.nb, F64, "global")._replace(threads=96)
    with pytest.raises(ValueError, match="no route's plan"):
        lk.ladder_solve(s, v0, op, EPS, ITERS, True, plan=bad)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 8, 64, 65])
@pytest.mark.parametrize("dtype", [F64, F32])
def test_l2_gradient_from_the_cluster_route(cuda_device, lanes, dtype):
    f = feeder(10000)
    assert lk.ladder_plan(f.n_branches, dtype).route == "cluster"
    scale = np.random.default_rng(1).uniform(0.7, 1.3, (lanes, 1, 1))
    loads = scale * f.s_load[None]
    p = torch.tensor(loads.real, dtype=dtype, device=cuda_device)
    grads = []
    lk.reset_launches()
    for plain in (False, True):
        _, fixed = make_ladder_solver(f, dtype=dtype, device=cuda_device,
                                      plain=plain)
        q = torch.tensor(loads.imag, dtype=dtype, device=cuda_device,
                         requires_grad=True)
        loss = total_loss_kw(f, fixed((p, q))).sum()
        grads.append(torch.autograd.grad(loss, q)[0])
    torch.cuda.synchronize()
    assert lk.launches()["ladder_vjp"] == 1
    g, want = grads
    assert torch.all(torch.isfinite(g))
    if dtype == F64:
        np.testing.assert_allclose(g.cpu().numpy(), want.cpu().numpy(),
                                   rtol=GRAD_RTOL, atol=1e-10)
    else:
        top = float(want.abs().max())
        assert float((g - want).abs().max()) <= L2_F32_GRAD_RTOL * top


def vjp_against_plain(f, lanes, dtype, device, seed=2):
    """L2 and its plain version on the same saved iterates and seeded
    cotangents; returns the kernel's four outputs, their largest gap to
    the plain version's as a share of its largest, and the inputs."""
    s, v0, op = preorder_inputs(f, lanes, dtype, device)
    saved = lk.ladder_solve(s, v0, op, EPS, ITERS, True, save=True).saved
    gs = chip_smoke._cotangents(torch, np.random.default_rng(seed), lanes,
                                op.nb, dtype)
    got = chip_smoke._flat_vjp(lk.ladder_vjp(saved, s, op, *gs))
    again = chip_smoke._flat_vjp(lk.ladder_vjp(saved, s, op, *gs))
    want = chip_smoke._flat_vjp(lk.ladder_vjp_plain(saved, s, op, *gs))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(bool(torch.isfinite(a).all()) for a in got)
    top = max(float(w.abs().max()) for w in want)
    rel = max(float((a - w).abs().max()) for a, w in zip(got, want)) / top
    return got, rel, (s, saved, gs, op)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 8, 64, 65])
@pytest.mark.parametrize("dtype", [F64, F32])
def test_l2_cluster_route_matches_plain_at_10k(cuda_device, lanes, dtype):
    f = feeder(10000)
    assert lk.ladder_plan(f.n_branches, dtype).route == "cluster"
    _, rel, _ = vjp_against_plain(f, lanes, dtype, cuda_device)
    assert rel <= (GRAD_RTOL if dtype == F64 else L2_F32_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F64, F32])
def test_l2_lane_is_the_same_bits_in_launches_of_1_8_and_64(cuda_device,
                                                            dtype):
    wide, _, (s, saved, gs, op) = vjp_against_plain(feeder(10000), 64,
                                                    dtype, cuda_device)
    for k0, k1 in ((0, 1), (5, 6), (63, 64), (0, 8)):
        part = chip_smoke._flat_vjp(lk.ladder_vjp(
            saved[:, k0:k1].contiguous(),
            C(s.re[k0:k1].contiguous(), s.im[k0:k1].contiguous()), op,
            *[C(g.re[k0:k1].contiguous(), g.im[k0:k1].contiguous())
              for g in gs]))
        torch.cuda.synchronize()
        assert all(torch.equal(a, w[k0:k1]) for a, w in zip(part, wide))


@pytest.mark.cuda
@pytest.mark.parametrize("above", [0, 1])
@pytest.mark.parametrize("dtype", [F64, F32])
def test_l2_routes_at_the_cluster_capacity(cuda_device, dtype, above):
    nb = lk.cluster_capacity(dtype) + above
    f = cases.synthetic_radial(nb, seed=3, load_kw=1.0)
    assert lk.ladder_plan(nb, dtype).route == ("global" if above else "cluster")
    _, rel, _ = vjp_against_plain(f, 2, dtype, cuda_device)
    assert rel <= (GRAD_RTOL if dtype == F64 else L2_F32_RTOL)


@pytest.mark.cuda
def test_resident_clusters_of_the_10k_plan(cuda_device):
    for dtype in (F64, F32):
        plan = lk.ladder_plan(10000, dtype)
        assert lk.resident_clusters(plan, dtype, cuda_device) >= 1
        for kernel, fn in (("ladder_vjp", lk.ladder_plan),
                           ("ladder_doubling", lk.doubling_plan),
                           ("ladder_doubling_vjp", lk.doubling_plan)):
            assert lk.resident_clusters(fn(10000, dtype), dtype, cuda_device,
                                        kernel) >= 1
