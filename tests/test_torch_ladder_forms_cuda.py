"""L3 ``ladder_dense`` and L4 ``ladder_doubling`` on the card, and the
source phasors' cotangent of every ladder reverse mode, against the plain
PyTorch versions on the same card: ``make_ladder_solver(sweep_method=
"dense" | "doubling")`` against its ``plain=True`` twin in solve and fixed
modes, float64 (``ATOL`` pu with equal iterations; L4 bit for bit) and
float32 (``ATOL_F32`` on lanes whose flags both versions agree on; a
lane's flag is held only where its residual lies more than
``F32_FLAG_ULPS`` float32 ulps of the root current from eps); a lane's
bits the same in launches of 1 and 64 lanes and on repeat; each form's
gradient in the loads and in ``v_source_pu`` against ``torch.autograd``
of its plain fixed solve (rtol ``GRAD_RTOL``).  L3 runs both of its
routes here (``lk.dense_plan``): the CTA route on vvc_9bus, radial300 and
the dead-phase feeder, the tiled route on radial2048, and a feeder at
the CTA route's capacity and one branch above it in each dtype.  L4's
two routes (``lk.doubling_plan``): its cluster route (a lane a
thread-block cluster, the rows in distributed shared memory, the long
preimage lists a warp's) and its one-CTA route, forward and reverse, bit
for bit their plain versions in float64 and float32 — on radial2048 and
radial10k, at its cluster capacity and one branch above, and vvc_9bus
below the crossover.  Every test needs a CUDA card and skips without one (``chip_smoke.py`` runs
these checks at the full widths).  No JAX: the plain versions are held
to the reference on the CPU by ``tests/test_torch_ladder_forms.py``."""

import numpy as np
import pytest
import torch

from freedm_tpu_torch.cplx import C
from freedm_tpu_torch.grid import cases, feeder
from freedm_tpu_torch.kernels import ladder_kernels as lk
from freedm_tpu_torch.pf.ladder import (SOURCE_UNIT, make_ladder_solver,
                                        total_loss_kw)

F64, F32 = torch.float64, torch.float32
ATOL = 1e-10
ATOL_F32 = 1e-4
EPS = 1e-4
F32_FLAG_ULPS = 64
GRAD_RTOL = 1e-8
MAX_ITER = 20  # make_ladder_solver's default
FIELDS = ("v_node", "i_branch", "i_load")


def launches_of(form, f, dtype=F64):
    """Kernel launches of a solve and of a reverse mode: L3's tiled route
    issues its initial state, two products an iteration and its outputs
    out of preorder (a reverse mode likewise, the source phasors' sum in
    its last launch), its CTA route and L4 one each."""
    tiled = lk.dense_plan(f.n_branches, dtype).route == "tiled"
    if form == "dense" and tiled:
        return 2 + 2 * MAX_ITER, 2 + 2 * MAX_ITER
    return 1, 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")
    return torch.device("cuda")


def dead_phase_feeder():
    """Branch 2 carries phase a only: phases b and c are dead below it."""
    z3 = np.full((3, 3), 0.3 + 0.9j) + np.eye(3) * (0.6 + 1.4j)
    z1 = np.zeros((3, 3), dtype=complex)
    z1[0, 0] = 0.9 + 2.3j
    dl = np.array([
        [1, 0, 1, 1, 1.0, 1, 10, 2, 10, 2, 10, 2, 0],
        [2, 1, 2, 2, 1.0, 1, 5, 1, 5, 1, 5, 1, 0],
        [3, 2, 3, 1, 0.5, 1, 4, 1, 4, 1, 4, 1, 0],
        [4, 1, 4, 1, 0.7, 1, 6, 2, 6, 2, 6, 2, 0],
    ])
    return feeder.from_branch_table(dl, np.stack([z3, z1]))


FEEDERS = {
    "9bus": cases.vvc_9bus,
    "radial300": lambda: cases.synthetic_radial(300, seed=5),
    # At its default load every lane of synthetic_radial(2048, seed=0) is
    # in voltage collapse (no version converges); 1 kW a load, as the 10k
    # feeder of chip_smoke.py's ladder phases.
    "radial2048": lambda: cases.synthetic_radial(2048, seed=0, load_kw=1.0),
    "dead": dead_phase_feeder,
}


def loads_of(f, lanes, seed=0):
    return np.random.default_rng(seed).uniform(0.7, 1.3, (lanes, 1, 1)) \
        * f.s_load[None]


def same_bits(a, b):
    return all(torch.equal(getattr(getattr(a, k), p), getattr(getattr(b, k), p))
               for k in FIELDS for p in ("re", "im"))


def gap(a, b, pick):
    return max(float((getattr(getattr(a, k), p)
                      - getattr(getattr(b, k), p))[pick].abs().max())
               for k in FIELDS for p in ("re", "im"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FEEDERS))
@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("form", ["dense", "doubling"])
def test_form_matches_plain_on_card(cuda_device, form, dtype, name):
    f = FEEDERS[name]()
    loads = loads_of(f, 8)
    vs = torch.linspace(0.98, 1.04, 8, dtype=dtype, device=cuda_device)
    kernel = make_ladder_solver(f, dtype=dtype, sweep_method=form,
                                device=cuda_device)
    plain = make_ladder_solver(f, dtype=dtype, sweep_method=form,
                               device=cuda_device, plain=True)
    key = "ladder_" + form
    forward, _ = launches_of(form, f, dtype)
    for mode in (0, 1):
        lk.reset_launches()
        got, again = kernel[mode](loads, vs), kernel[mode](loads, vs)
        assert lk.launches()[key] == 2 * forward
        assert lk.mode_launches()[key] == {"forward": 2 * forward,
                                           "reverse": 0}
        want = plain[mode](loads, vs)
        # the plain version launches nothing
        assert lk.launches()[key] == 2 * forward
        torch.cuda.synchronize()
        assert same_bits(got, again)
        clear = torch.ones_like(want.converged)
        if dtype == F32:
            root = torch.as_tensor(f.parent < 0, device=cuda_device)
            i_root = want.i_branch.abs()[:, root].flatten(1).amax(1)
            band = F32_FLAG_ULPS * torch.finfo(F32).eps * i_root
            clear = (want.residual - EPS).abs() > band
        assert torch.equal(got.converged[clear], want.converged[clear])
        pick = got.converged & want.converged
        assert bool(pick.any())
        assert gap(got, want, pick) <= (ATOL if dtype == F64 else ATOL_F32)
        if dtype == F64:
            assert torch.equal(got.iterations, want.iterations)
        if form == "doubling":  # L4 rounds as its plain version does
            assert same_bits(got, want)
            assert torch.equal(got.iterations, want.iterations)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["dense", "doubling"])
@pytest.mark.parametrize("fixed", [True, False])
def test_a_lane_is_the_same_bits_in_launches_of_1_and_64(cuda_device, form,
                                                         fixed):
    f = FEEDERS["radial2048"]()
    loads = loads_of(f, 64, seed=3)
    solve = make_ladder_solver(f, sweep_method=form,
                               device=cuda_device)[int(fixed)]
    _same_bits_at_1_and_64(solve, loads)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("fixed", [True, False])
def test_dense_cta_route_lane_bits_at_1_and_64(cuda_device, dtype, fixed):
    f = FEEDERS["radial300"]()
    assert lk.dense_plan(f.n_branches, dtype).route == "cta"
    solve = make_ladder_solver(f, dtype=dtype, sweep_method="dense",
                               device=cuda_device)[int(fixed)]
    _same_bits_at_1_and_64(solve, loads_of(f, 64, seed=3))


def _same_bits_at_1_and_64(solve, loads):
    wide = solve(loads)
    for k in (0, 17, 63):
        one = solve(loads[k:k + 1])
        torch.cuda.synchronize()
        for name in FIELDS:
            for p in ("re", "im"):
                assert torch.equal(getattr(getattr(one, name), p)[0],
                                   getattr(getattr(wide, name), p)[k])
        assert int(one.iterations[0]) == int(wide.iterations[k])


def grads(f, form, loads, vs, device, plain):
    _, fixed = make_ladder_solver(f, sweep_method=form, device=device,
                                  plain=plain)
    p = torch.tensor(loads.real, dtype=F64, device=device)
    q = torch.tensor(loads.imag, dtype=F64, device=device,
                     requires_grad=True)
    v = torch.tensor(vs, dtype=F64, device=device, requires_grad=True)
    loss = total_loss_kw(f, fixed((p, q), v)).sum()
    return torch.autograd.grad(loss, (q, v))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["9bus", "radial300", "dead"])
@pytest.mark.parametrize("form", ["dense", "doubling", "euler"])
def test_reverse_modes_match_plain_on_card(cuda_device, form, name):
    _reverse_mode_matches_plain(FEEDERS[name](), form, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["radial2048", "above_cap"])
def test_dense_tiled_reverse_mode_matches_plain_on_card(cuda_device, name):
    f = (FEEDERS["radial2048"]() if name == "radial2048"
         else cap_feeder(F64, 1))
    assert lk.dense_plan(f.n_branches, F64).route == "tiled"
    _reverse_mode_matches_plain(f, "dense", cuda_device)


def _reverse_mode_matches_plain(f, form, cuda_device):
    loads = loads_of(f, 4, seed=1)
    vs = np.linspace(0.98, 1.04, 4)
    key = {"dense": "ladder_dense", "doubling": "ladder_doubling",
           "euler": "ladder_vjp"}[form]
    lk.reset_launches()
    got = grads(f, form, loads, vs, cuda_device, plain=False)
    if form == "euler":
        assert lk.launches()[key] == 1
    else:
        forward, reverse = launches_of(form, f)
        assert lk.mode_launches()[key] == {"forward": forward,
                                           "reverse": reverse}
    want = grads(f, form, loads, vs, cuda_device, plain=True)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.all(torch.isfinite(g))
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["dense", "doubling", "euler"])
def test_source_only_gradient_on_card(cuda_device, form):
    f = FEEDERS["9bus"]()
    _, fixed = make_ladder_solver(f, sweep_method=form, device=cuda_device)
    vs = torch.tensor(1.01, dtype=F64, device=cuda_device, requires_grad=True)
    (g,) = torch.autograd.grad(total_loss_kw(f, fixed(f.s_load, vs)), vs)
    _, plain = make_ladder_solver(f, sweep_method=form, device=cuda_device,
                                  plain=True)
    vp = vs.detach().clone().requires_grad_(True)
    (want,) = torch.autograd.grad(total_loss_kw(f, plain(f.s_load, vp)), vp)
    np.testing.assert_allclose(float(g), float(want), rtol=GRAD_RTOL)


def cap_feeder(dtype, above):
    """A feeder of exactly L3's CTA-route capacity in ``dtype`` branches,
    or one branch more (``above=1``), at 1 kW a load."""
    return cases.synthetic_radial(lk.dense_cta_capacity(dtype) + above,
                                  seed=4, load_kw=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("above", [0, 1])
@pytest.mark.parametrize("dtype", [F64, F32])
def test_dense_routes_at_the_cta_cap(cuda_device, dtype, above):
    f = cap_feeder(dtype, above)
    want_route = "tiled" if above else "cta"
    assert lk.dense_plan(f.n_branches, dtype).route == want_route
    loads = loads_of(f, 64, seed=2)
    kernel = make_ladder_solver(f, dtype=dtype, sweep_method="dense",
                                device=cuda_device)
    plain = make_ladder_solver(f, dtype=dtype, sweep_method="dense",
                               device=cuda_device, plain=True)
    forward, _ = launches_of("dense", f, dtype)
    for mode in (0, 1):
        lk.reset_launches()
        got = kernel[mode](loads)
        assert lk.mode_launches()["ladder_dense"] == {"forward": forward,
                                                      "reverse": 0}
        want = plain[mode](loads)
        torch.cuda.synchronize()
        pick = got.converged & want.converged
        assert bool(pick.all())
        assert gap(got, want, pick) <= (ATOL if dtype == F64 else ATOL_F32)
        if dtype == F64:
            assert torch.equal(got.iterations, want.iterations)
        assert same_bits(got, kernel[mode](loads))


def doubling_bits(f, dtype, device, lanes=2, seed=8, plan=None):
    """L4's fixed (saving), solve and reverse modes (on ``plan``'s route,
    or the kernel's own) against their plain versions on the same card:
    every output the same bits."""
    loads = loads_of(f, lanes, seed=seed)
    s = C(torch.tensor(loads.real / f.s_base_per_phase_kva, dtype=dtype,
                       device=device),
          torch.tensor(loads.imag / f.s_base_per_phase_kva, dtype=dtype,
                       device=device))
    u = SOURCE_UNIT * f.v_source_pu
    v0 = C(torch.tensor(np.tile(u.real, (lanes, 1)), dtype=dtype,
                        device=device),
           torch.tensor(np.tile(u.imag, (lanes, 1)), dtype=dtype,
                        device=device))
    op = lk.doubling_operands(f, dtype, device)
    for fixed in (True, False):
        got = lk.ladder_doubling(s, v0, op, EPS, MAX_ITER, fixed, save=fixed,
                                 plan=plan)
        want = lk.ladder_doubling_plain(s, v0, op, EPS, MAX_ITER, fixed,
                                        save=fixed)
        torch.cuda.synchronize()
        for k in ("v", "i_branch", "i_load"):
            for p in ("re", "im"):
                assert torch.equal(getattr(getattr(got, k), p),
                                   getattr(getattr(want, k), p)), (k, fixed)
        assert torch.equal(got.iterations, want.iterations)
        if fixed:
            assert torch.equal(got.saved, want.saved)
            rng = np.random.default_rng(seed)
            gs = [C(torch.tensor(rng.normal(size=loads.shape), dtype=dtype,
                                 device=device),
                    torch.tensor(rng.normal(size=loads.shape), dtype=dtype,
                                 device=device)) for _ in range(3)]
            sb, v0b = lk.ladder_doubling_vjp(got.saved, s, op, *gs, plan=plan)
            wsb, wv0b = lk.ladder_doubling_vjp_plain(got.saved, s, op, *gs)
            torch.cuda.synchronize()
            for a, b in ((sb.re, wsb.re), (sb.im, wsb.im), (v0b.re, wv0b.re),
                         (v0b.im, wv0b.im)):
                assert torch.all(torch.isfinite(a)) and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["9bus", "radial2048"])
@pytest.mark.parametrize("dtype", [F64, F32])
def test_doubling_routes_give_the_plain_bits(cuda_device, name, dtype):
    f = FEEDERS[name]()
    route = lk.doubling_plan(f.n_branches, dtype).route
    assert route == ("cta" if f.n_branches < lk.CLUSTER_FROM else "cluster")
    doubling_bits(f, dtype, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [64, 1536])
@pytest.mark.parametrize("route", ["cluster", "cta"])
@pytest.mark.parametrize("nb", [9, 511])
@pytest.mark.parametrize("dtype", [F64, F32])
def test_both_doubling_routes_below_the_crossover_give_the_plain_bits(
        cuda_device, dtype, nb, route, lanes):
    """Either L4 route, launched through its plan, forward and reverse,
    at the widths the small feeders run (64 lanes, QSTS's 24 x 64)."""
    f = (FEEDERS["9bus"]() if nb == 9
         else cases.synthetic_radial(nb, seed=0, load_kw=1.0))
    plan = lk.route_plan(f.n_branches, dtype, route, doubling=True)
    doubling_bits(f, dtype, cuda_device, lanes=lanes, plan=plan)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F64, F32])
def test_doubling_cluster_route_at_10k_gives_the_plain_bits(cuda_device,
                                                            dtype):
    f = cases.synthetic_radial(10000, seed=0, load_kw=1.0)
    assert lk.doubling_plan(f.n_branches, dtype).route == "cluster"
    doubling_bits(f, dtype, cuda_device, lanes=3)


@pytest.mark.cuda
@pytest.mark.parametrize("above", [0, 1])
@pytest.mark.parametrize("dtype", [F64, F32])
def test_doubling_routes_at_the_cluster_capacity(cuda_device, dtype, above):
    nb = lk.doubling_capacity(dtype) + above
    f = cases.synthetic_radial(nb, seed=4, load_kw=1.0)
    assert lk.doubling_plan(nb, dtype).route == ("cta" if above
                                                 else "cluster")
    doubling_bits(f, dtype, cuda_device, lanes=1)
