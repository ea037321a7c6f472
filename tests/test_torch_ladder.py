"""The ladder power flow of the PyTorch port against the JAX package's.

``freedm_tpu_torch`` against ``freedm_tpu`` (CPU, x64) on the same numpy
inputs, float64:

- the sweeps (``dense``, ``doubling``, ``euler`` in its general and its
  preorder branch) and L1's preorder sweeps against the reference's
  operators: 1e-12 (the same operations in another library; L1's path
  sums take one prefix of ``x − q`` where the reference subtracts two);
- ``solve`` and ``solve_fixed`` for every method on ``vvc_9bus``,
  ``synthetic_radial`` at 300 and 5000 buses and the reference's Dl
  table: ``v_node``, ``i_branch``, ``i_load`` within 1e-10 pu with equal
  iterations and flags; lanes (a written-out leading axis) against
  ``jax.vmap``, per-lane source voltages too; a feeder with dead phases;
  the 9-bus solution pin of ``tests/test_ladder.py``; the derived powers;
- gradients of the total loss in Q against ``jax.grad`` at rtol 1e-8,
  through the plain loop (dense, doubling) and through ``LadderFixed``
  (L1's and L2's plain versions on the CPU), at dead phases too; L2's
  plain version against ``torch.autograd`` of L1's plain version on
  random cotangents; a central finite difference;
- L1's launch plan (``ladder_plan``): a function of the branch count and
  dtype alone, whole contiguous intervals that cover the branches, the
  route switching only at the cluster route's capacity.

The ``cuda``-marked tests hold L1 and L2 to their plain versions on the
card (``chip_smoke.py`` does so at full size).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freedm_tpu.grid import cases as ref_cases
from freedm_tpu.grid import feeder as ref_feeder
from freedm_tpu.pf import ladder as ref_ladder
from freedm_tpu.pf import sweeps as ref_sweeps
from freedm_tpu.utils import cplx as ref_cplx
from freedm_tpu_torch.cplx import C
from freedm_tpu_torch.grid import cases, feeder
from freedm_tpu_torch.kernels import ladder_kernels as lk
from freedm_tpu_torch.pf import ladder, sweeps
from refdata import resolve

F64 = torch.float64
ATOL = 1e-10
SWEEP_ATOL = 1e-12
GRAD_RTOL = 1e-8
# The reference checkout's copy, a fallback behind the committed fixture.
REF_DL_MAT = "reference/Broker/Dl_new.mat"

FEEDERS = {
    "9bus": lambda m: m.vvc_9bus(),
    "rand200": lambda m: m.synthetic_radial(200, seed=1),
    "trunk64": lambda m: m.synthetic_radial(64, seed=2, lateral_prob=0.0),
    "shallow64": lambda m: m.synthetic_radial(64, seed=3, lateral_prob=1.0),
    "radial300": lambda m: m.synthetic_radial(300, seed=5),
    "radial5000": lambda m: m.synthetic_radial(5000, seed=6, pv_frac=0.1,
                                               load_kw=2.0),
}


def _dead_phase_feeders(m):
    """Branch 2 carries phase a only, so phases b and c are dead at its
    to-node and below (``tests/test_ladder.py``'s case, one level
    deeper)."""
    z3 = np.full((3, 3), 0.3 + 0.9j) + np.eye(3) * (0.6 + 1.4j)
    z1 = np.zeros((3, 3), dtype=complex)
    z1[0, 0] = 0.9 + 2.3j
    dl = np.array([
        [1, 0, 1, 1, 1.0, 1, 10, 2, 10, 2, 10, 2, 0],
        [2, 1, 2, 2, 1.0, 1, 5, 1, 5, 1, 5, 1, 0],
        [3, 2, 3, 1, 0.5, 1, 4, 1, 4, 1, 4, 1, 0],
        [4, 1, 4, 1, 0.7, 1, 6, 2, 6, 2, 6, 2, 0],
    ])
    return m.from_branch_table(dl, np.stack([z3, z1]))


def _both(name):
    if name == "dead":
        return _dead_phase_feeders(feeder), _dead_phase_feeders(ref_feeder)
    if name == "dl":
        path = resolve("Dl_new.mat", REF_DL_MAT)
        return feeder.load_dl_mat(path), ref_feeder.load_dl_mat(path)
    return FEEDERS[name](cases), FEEDERS[name](ref_cases)


def _np(x):
    """A port pair or a reference pair as numpy complex."""
    return x.to_numpy()


def _rand_pair(rng, shape):
    a, b = rng.normal(size=shape), rng.normal(size=shape)
    return (C(torch.tensor(a, dtype=F64), torch.tensor(b, dtype=F64)),
            ref_cplx.as_c(a + 1j * b))


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["9bus", "rand200", "trunk64", "shallow64"])
@pytest.mark.parametrize("method", ["dense", "doubling", "euler",
                                    "euler_preorder"])
def test_sweeps_match_reference(name, method):
    f, rf = _both(name)
    if method == "euler_preorder":
        f, rf = f.reorder_preorder()[0], rf.reorder_preorder()[0]
        method = "euler"
    else:
        assert np.any(f.parent[1:] >= 0)
    maker = {"dense": sweeps.dense_sweeps, "doubling": sweeps.doubling_sweeps,
             "euler": sweeps.euler_sweeps}[method]
    ref_maker = {"dense": ref_sweeps.dense_sweeps,
                 "doubling": ref_sweeps.doubling_sweeps,
                 "euler": ref_sweeps.euler_sweeps}[method]
    bwd, fwd = maker(f, F64, device="cpu")
    rb, rfw = ref_maker(rf, jnp.float64)
    rng = np.random.default_rng(7)
    for shape in ((f.n_branches, 3), (4, f.n_branches, 3)):
        x, rx = _rand_pair(rng, shape)
        if len(shape) == 3:
            want_b, want_f = jax.vmap(rb)(rx), jax.vmap(rfw)(rx)
        else:
            want_b, want_f = rb(rx), rfw(rx)
        np.testing.assert_allclose(_np(bwd(x)), _np(want_b), rtol=0,
                                   atol=SWEEP_ATOL)
        np.testing.assert_allclose(_np(fwd(x)), _np(want_f), rtol=0,
                                   atol=SWEEP_ATOL)


def test_euler_takes_the_preorder_branch_only_when_preordered():
    f = cases.synthetic_radial(200, seed=1)
    assert not np.array_equal(sweeps.euler_tour(f)[1], np.arange(200))
    w = f.reorder_preorder()[0]
    np.testing.assert_array_equal(sweeps.euler_tour(w)[1], np.arange(200))


@pytest.mark.parametrize("name", ["9bus", "rand200", "trunk64", "radial5000"])
def test_l1_sweeps_match_reference_preorder_sweeps(name):
    f, rf = _both(name)
    w, rw = f.reorder_preorder()[0], rf.reorder_preorder()[0]
    op = lk.ladder_operands(w, F64, torch.device("cpu"))
    bwd, fwd = lk.preorder_sweeps(op)
    rb, rfw = ref_sweeps.euler_sweeps(rw, jnp.float64)
    x, rx = _rand_pair(np.random.default_rng(3), (2, w.n_branches, 3))
    np.testing.assert_allclose(_np(bwd(x)), _np(jax.vmap(rb)(rx)), rtol=0,
                               atol=SWEEP_ATOL)
    np.testing.assert_allclose(_np(fwd(x)), _np(jax.vmap(rfw)(rx)), rtol=0,
                               atol=SWEEP_ATOL)
    # The groups {k : tout_k = t}: CSR in increasing k.
    ptr, idx = op.grp_ptr.numpy(), op.grp_idx.numpy()
    tout = op.tout.numpy()
    for t in range(w.n_branches):
        ks = idx[ptr[t]:ptr[t + 1]]
        assert np.all(np.diff(ks) > 0) and np.all(tout[ks] == t)


def test_operands_refuse_a_feeder_not_in_preorder():
    f = cases.synthetic_radial(200, seed=1)
    with pytest.raises(ValueError, match="preorder"):
        lk.ladder_operands(f, F64, torch.device("cpu"))


# ---------------------------------------------------------------------------
# Solves
# ---------------------------------------------------------------------------


def _assert_result(got, want, atol=ATOL):
    for k in ("v_node", "i_branch", "i_load"):
        np.testing.assert_allclose(_np(getattr(got, k)),
                                   _np(getattr(want, k)), rtol=0, atol=atol,
                                   err_msg=k)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    assert got.iterations.dtype == torch.int32


SOLVE_CASES = [("9bus", None), ("9bus", "dense"), ("9bus", "doubling"),
               ("9bus", "euler"), ("radial300", None),
               ("radial300", "doubling"), ("radial300", "euler"),
               ("radial5000", None), ("radial5000", "doubling"),
               ("dead", None), ("dead", "euler")]


@pytest.mark.parametrize("name,method", SOLVE_CASES)
def test_solve_and_fixed_match_reference(name, method):
    f, rf = _both(name)
    solve, fixed = ladder.make_ladder_solver(f, sweep_method=method,
                                             device="cpu")
    r_solve, r_fixed = ref_ladder.make_ladder_solver(rf, sweep_method=method)
    got, want = solve(f.s_load), r_solve(rf.s_load)
    assert bool(got.converged)
    _assert_result(got, want)
    np.testing.assert_allclose(float(got.residual), float(want.residual),
                               rtol=1e-6, atol=1e-13)
    _assert_result(fixed(f.s_load), r_fixed(rf.s_load))


def test_dl_table_at_half_load_matches_reference():
    f, rf = _both("dl")
    solve, fixed = ladder.make_ladder_solver(f, max_iter=60, device="cpu")
    r_solve, r_fixed = ref_ladder.make_ladder_solver(rf, max_iter=60)
    got = solve(0.5 * f.s_load)
    assert bool(got.converged)
    _assert_result(got, r_solve(0.5 * rf.s_load))
    _assert_result(fixed(0.5 * f.s_load), r_fixed(0.5 * rf.s_load))
    assert float(got.v_node.abs().min()) > 0.5


@pytest.mark.parametrize("name,method", [("9bus", None), ("radial300", None),
                                         ("radial300", "euler"),
                                         ("radial5000", None)])
def test_lanes_match_reference_vmap(name, method):
    f, rf = _both(name)
    scale = np.random.default_rng(0).uniform(0.7, 1.3, (5, 1, 1))
    loads = scale * f.s_load[None]
    vs = np.linspace(0.98, 1.04, 5)
    solve, fixed = ladder.make_ladder_solver(f, sweep_method=method,
                                             device="cpu")
    r_solve, r_fixed = ref_ladder.make_ladder_solver(rf, sweep_method=method)
    rl = ref_cplx.as_c(loads)
    _assert_result(solve(loads), jax.vmap(r_solve)(rl))
    _assert_result(fixed(loads), jax.vmap(r_fixed)(rl))
    got = solve(loads, torch.tensor(vs, dtype=F64))
    _assert_result(got, jax.vmap(r_solve)(rl, jnp.asarray(vs)))
    assert len(set(got.iterations.tolist())) > 1  # lanes stop on their own


def test_dead_phases_give_exact_zeros():
    f, _ = _both("dead")
    assert f.phase_mask.tolist() == [[1, 1, 1], [1, 0, 0], [1, 0, 0],
                                     [1, 1, 1]]
    for method in (None, "euler", "doubling"):
        res = ladder.make_ladder_solver(f, sweep_method=method,
                                        device="cpu")[0](f.s_load)
        v = res.v_node.to_numpy()
        assert np.all(v[2:4, 1:] == 0) and np.all(np.abs(v[2:4, 0]) > 0.9)
        assert np.all(res.i_load.to_numpy()[1:3, 1:] == 0)


# Solved 9-bus profile (tests/test_ladder.py, cross-validated there
# against the reference's independent current-injection solver).
VMAG_9BUS = [
    1.015, 1.00939711, 1.0040465, 1.00119821, 0.99744601,
    0.99594453, 1.00527471, 1.00378899, 1.00154268,
]
VANG_A_DEG_9BUS = [
    0.0, -1.23164922, -2.05637049, -2.49655225, -3.10376139,
    -3.35122193, -1.88576639, -2.12126044, -2.48804538,
]


@pytest.mark.parametrize("method", [None, "euler"])
def test_9bus_value_pin(method):
    f = cases.vvc_9bus()
    solve, _ = ladder.make_ladder_solver(f, eps=1e-12, max_iter=200,
                                         sweep_method=method, device="cpu")
    r = solve(f.s_load)
    assert bool(r.converged)
    mag, ang = (x.numpy() for x in ladder.v_polar(r))
    np.testing.assert_allclose(mag[:, 0], VMAG_9BUS, atol=1e-6)
    np.testing.assert_allclose(mag[:, 1], VMAG_9BUS, atol=1e-6)
    np.testing.assert_allclose(ang[:, 0], VANG_A_DEG_9BUS, atol=1e-5)
    np.testing.assert_allclose(ang[:, 1], np.asarray(VANG_A_DEG_9BUS) - 120.0,
                               atol=1e-5)
    np.testing.assert_allclose(float(ladder.total_loss_kw(f, r)), 11.674965,
                               atol=1e-4)
    s = ladder.substation_power_kva(f, r)
    np.testing.assert_allclose(s.re.numpy(), 308.891655, atol=1e-4)
    np.testing.assert_allclose(s.im.numpy(), 13.630167, atol=1e-4)


@pytest.mark.parametrize("name", ["9bus", "radial300", "dead"])
def test_derived_powers_match_reference(name):
    f, rf = _both(name)
    scale = np.array([0.8, 1.1])[:, None, None]
    got = ladder.make_ladder_solver(f, device="cpu")[0](scale * f.s_load)
    want = jax.vmap(ref_ladder.make_ladder_solver(rf)[0])(
        ref_cplx.as_c(scale * rf.s_load))
    for fn in ("branch_power_kva", "substation_power_kva", "load_power_kva"):
        np.testing.assert_allclose(
            _np(getattr(ladder, fn)(f, got)),
            _np(jax.vmap(lambda r: getattr(ref_ladder, fn)(rf, r))(want)),
            rtol=0, atol=1e-7, err_msg=fn)
    np.testing.assert_allclose(
        ladder.total_loss_kw(f, got).numpy(),
        np.asarray(jax.vmap(lambda r: ref_ladder.total_loss_kw(rf, r))(want)),
        rtol=0, atol=1e-8)
    mag, ang = ladder.v_polar(got)
    rmag, rang = jax.vmap(ref_ladder.v_polar)(want)
    np.testing.assert_allclose(mag.numpy(), np.asarray(rmag), atol=ATOL)
    np.testing.assert_allclose(ang.numpy(), np.asarray(rang), atol=1e-8)


def test_solver_refusals():
    f = cases.vvc_9bus()
    with pytest.raises(NotImplementedError, match="item 16"):
        ladder.make_ladder_solver(f, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="unknown sweep method"):
        ladder.make_ladder_solver(f, sweep_method="banded", device="cpu")
    with pytest.raises(TypeError, match="float64 or float32"):
        ladder.make_ladder_solver(f, dtype=torch.float16, device="cpu")
    solve, _ = ladder.make_ladder_solver(f, device="cpu")
    with pytest.raises(ValueError, match="s_load_kva must be"):
        solve(np.zeros((3, 3)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ladder.make_ladder_solver(f)


def test_float32_solve_tracks_float64():
    f = cases.synthetic_radial(300, seed=5)
    s64 = ladder.make_ladder_solver(f, device="cpu")[0](f.s_load)
    s32 = ladder.make_ladder_solver(f, dtype=torch.float32, device="cpu",
                                    sweep_method="euler")[0](f.s_load)
    assert bool(s32.converged) and s32.v_node.re.dtype == torch.float32
    np.testing.assert_allclose(_np(s32.v_node), _np(s64.v_node), atol=1e-4)


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------


def _ref_grad(rf, max_iter, method=None, p_scale=1.0):
    _, r_fixed = ref_ladder.make_ladder_solver(rf, max_iter=max_iter,
                                               sweep_method=method)
    p0 = jnp.asarray(p_scale * rf.s_load.real)

    def loss(q):
        return ref_ladder.total_loss_kw(rf, r_fixed(ref_cplx.C(p0, q)))

    q = jnp.asarray(rf.s_load.imag)
    return np.asarray(jax.grad(loss)(q)), float(loss(q))


def _port_grad(f, max_iter, method=None, plain=False):
    _, fixed = ladder.make_ladder_solver(f, max_iter=max_iter,
                                         sweep_method=method, device="cpu",
                                         plain=plain)
    p = torch.tensor(f.s_load.real, dtype=F64)
    q = torch.tensor(f.s_load.imag, dtype=F64, requires_grad=True)
    loss = ladder.total_loss_kw(f, fixed((p, q)))
    (g,) = torch.autograd.grad(loss, q)
    return g.numpy(), float(loss.detach())


@pytest.mark.parametrize("name,method,plain", [
    ("9bus", None, False), ("9bus", "doubling", False),
    ("9bus", "euler", False), ("9bus", "euler", True),
    ("radial300", "euler", False), ("radial5000", None, False),
    ("dead", None, False), ("dead", "euler", False), ("dead", "euler", True),
])
def test_loss_gradient_matches_jax_grad(name, method, plain):
    f, rf = _both(name)
    got, loss = _port_grad(f, 20, method, plain)
    want, ref_loss = _ref_grad(rf, 20, method)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-12)
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * np.abs(want).max())
    if name == "dead":  # no Q on a dead phase moves anything
        assert np.all(got[f.phase_mask == 0] == 0)


def test_euler_gradient_goes_through_ladder_fixed():
    f = cases.vvc_9bus()
    _, fixed = ladder.make_ladder_solver(f, sweep_method="euler",
                                         device="cpu")
    q = torch.zeros(8, 3, dtype=F64, requires_grad=True)
    res = fixed((torch.tensor(f.s_load.real), q))
    names = set()
    stack = [res.i_branch.re.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or type(fn).__name__ in names:
            continue
        names.add(type(fn).__name__)
        stack.extend(n for n, _ in fn.next_functions)
    assert "LadderFixedBackward" in names


@pytest.mark.parametrize("name", ["9bus", "radial300", "dead"])
def test_l2_plain_matches_autograd_of_l1_plain(name):
    f, _ = _both(name)
    w = f.reorder_preorder()[0]
    op = lk.ladder_operands(w, F64, torch.device("cpu"))
    rng = np.random.default_rng(11)
    lanes, nb = 3, w.n_branches
    sc = rng.uniform(0.7, 1.3, (lanes, 1, 1)) * w.s_load[None] / (
        w.s_base_per_phase_kva)
    s = C(torch.tensor(sc.real, requires_grad=True),
          torch.tensor(sc.imag, requires_grad=True))
    u = ladder.SOURCE_UNIT * w.v_source_pu
    v0 = C(torch.tensor(np.tile(u.real, (lanes, 1))),
           torch.tensor(np.tile(u.imag, (lanes, 1))))
    out = lk.ladder_solve_plain(s, v0, op, 1e-4, 15, fixed=True)
    cots = [C(torch.tensor(rng.normal(size=(lanes, nb, 3))),
              torch.tensor(rng.normal(size=(lanes, nb, 3)))) for _ in range(3)]
    dead = torch.tensor(w.phase_mask == 0)
    for c in cots:  # a cotangent on a dead phase must not leak through
        c.re[:, dead] = 0.0
        c.im[:, dead] = 0.0
    total = sum((o.re * c.re).sum() + (o.im * c.im).sum()
                for o, c in zip((out.v, out.i_branch, out.i_load), cots))
    want = torch.autograd.grad(total, [s.re, s.im])
    with torch.no_grad():
        saved = lk.ladder_solve_plain(C(s.re.detach(), s.im.detach()), v0,
                                      op, 1e-4, 15, fixed=True,
                                      save=True).saved
        got, _ = lk.ladder_vjp(saved, C(s.re.detach(), s.im.detach()), op,
                               *cots)
    assert saved.shape == (15, lanes, nb, 6)
    for a, b in ((got.re, want[0]), (got.im, want[1])):
        assert torch.all(torch.isfinite(a))
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(b.abs().max()))


def test_gradient_matches_central_difference():
    f = cases.vvc_9bus()
    _, fixed = ladder.make_ladder_solver(f, max_iter=30, sweep_method="euler",
                                         device="cpu")
    p = torch.tensor(f.s_load.real, dtype=F64)

    def loss(q):
        return ladder.total_loss_kw(f, fixed((p, q)))

    q = torch.zeros(8, 3, dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(loss(q), q)
    h = 1e-3
    with torch.no_grad():
        for idx in [(1, 0), (4, 2), (6, 1)]:
            e = torch.zeros(8, 3, dtype=F64)
            e[idx] = h
            fd = (loss(q + e) - loss(q - e)) / (2 * h)
            np.testing.assert_allclose(float(g[idx]), float(fd), rtol=1e-4,
                                       atol=1e-7)


def test_v_source_gradient_runs_the_plain_loop_on_the_cpu():
    f = cases.vvc_9bus()
    _, fixed = ladder.make_ladder_solver(f, sweep_method="euler",
                                         device="cpu")
    vs = torch.tensor(1.01, dtype=F64, requires_grad=True)
    loss = ladder.total_loss_kw(f, fixed(f.s_load, vs))
    (g,) = torch.autograd.grad(loss, vs)
    _, r_fixed = ref_ladder.make_ladder_solver(ref_cases.vvc_9bus())
    want = jax.grad(lambda v: ref_ladder.total_loss_kw(
        ref_cases.vvc_9bus(), r_fixed(ref_cases.vvc_9bus().s_load, v)))(1.01)
    np.testing.assert_allclose(float(g), float(want), rtol=GRAD_RTOL)


# ---------------------------------------------------------------------------
# L1's launch plan (plain Python)
# ---------------------------------------------------------------------------

PLAN_NBS = [1, 8, 31, 32, 33, 64, 65, 512, 1023, 1024, 2048, 2049, 5000,
            10000, 16384, 20480, 24576, 32768]


@pytest.mark.parametrize("dtype", [F64, torch.float32])
@pytest.mark.parametrize("nb", PLAN_NBS)
def test_ladder_plan_cuts_whole_contiguous_intervals(nb, dtype):
    plan = lk.ladder_plan(nb, dtype)
    if nb > lk.cluster_capacity(dtype) or nb < lk.CLUSTER_FROM:
        assert plan.route == "global"
        return
    assert plan.route == "cluster"
    assert 1 <= plan.cluster <= lk.MAX_CLUSTER
    assert plan.per <= 2 * plan.threads  # two branches a thread
    assert plan.threads % 32 == 0 and plan.threads <= lk.CTA_THREADS[dtype]
    spans = plan.intervals(nb)
    assert len(spans) == plan.cluster
    assert spans[0][0] == 0 and spans[-1][1] == nb
    for (lo, hi), (lo2, _) in zip(spans, spans[1:]):
        assert hi == lo2  # contiguous, in rank order
    assert all(hi > lo for lo, hi in spans)  # every CTA owns a branch
    item = 8 if dtype == F64 else 4
    assert plan.smem == ((36 * plan.threads + lk.SCRATCH_WORDS) * item
                         + 8 * plan.threads)
    assert plan.smem <= lk.SMEM_LIMIT == 232448  # an H100 block's


@pytest.mark.parametrize("nb", [1, 9, 1000, 10000, 20480, 20481, 40000])
def test_ladder_plan_is_a_function_of_nb_and_dtype_alone(nb):
    for dtype in (F64, torch.float32):
        first = lk.ladder_plan(nb, dtype)
        assert lk.ladder_plan(int(np.int64(nb)), dtype) == first
        assert lk.ladder_plan(nb, dtype) == first
    params = set(inspect.signature(lk.ladder_plan).parameters)
    assert params == {"nb", "dtype"}


@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_ladder_plan_route_changes_only_at_capacity(dtype):
    cap = lk.cluster_capacity(dtype)
    assert cap == {F64: 20480, torch.float32: 32768}[dtype]
    start = lk.CLUSTER_FROM  # the small-feeder crossover
    for nb in (1, 2, 3, 17, start - 1):
        assert lk.ladder_plan(nb, dtype).route == "global", nb
    for nb in (start, start + 1, 1000, cap // 2, cap - 1, cap):
        assert lk.ladder_plan(nb, dtype).route == "cluster", nb
    for nb in (cap + 1, cap + 2, 2 * cap, 100000):
        plan = lk.ladder_plan(nb, dtype)
        assert plan.route == "global"
        assert plan.cluster == 1 and plan.smem == 0
        assert plan.threads == lk.GLOBAL_THREADS
        assert plan.intervals(nb) == ((0, nb),)


def test_ladder_plan_at_the_served_feeders():
    assert lk.ladder_plan(8, F64).cluster == 1  # vvc_9bus: one CTA a lane
    assert lk.ladder_plan(10000, F64)[:3] == ("cluster", 8, 1250)
    assert lk.ladder_plan(10000, torch.float32)[:3] == ("cluster", 5, 2000)


@pytest.mark.parametrize("nb", [0, -1, -16384])
def test_ladder_plan_refuses_no_branches(nb):
    with pytest.raises(ValueError, match="nb >= 1"):
        lk.ladder_plan(nb, F64)


def test_ladder_plan_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float64 or float32"):
        lk.ladder_plan(100, torch.float16)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["9bus", "radial300", "dead"])
@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_l1_matches_plain_on_card(cuda_device, name, dtype):
    f, _ = _both(name)
    loads = np.random.default_rng(0).uniform(0.7, 1.3, (8, 1, 1)) * f.s_load
    atol = ATOL if dtype == F64 else 1e-4
    kernel = ladder.make_ladder_solver(f, dtype=dtype, device=cuda_device)
    plain = ladder.make_ladder_solver(f, dtype=dtype, device=cuda_device,
                                      plain=True)
    for i in (0, 1):
        got, want = kernel[i](loads), plain[i](loads)
        again = kernel[i](loads)
        torch.cuda.synchronize()
        for k in ("v_node", "i_branch", "i_load"):
            a, b = getattr(got, k), getattr(want, k)
            assert float((a.re - b.re).abs().max()) <= atol, k
            assert float((a.im - b.im).abs().max()) <= atol, k
            assert torch.equal(a.re, getattr(again, k).re), k
        assert torch.equal(got.converged, want.converged)
        if dtype == F64:
            assert torch.equal(got.iterations, want.iterations)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["9bus", "radial300", "dead"])
def test_l2_matches_plain_on_card(cuda_device, name):
    f, _ = _both(name)
    grads = []
    for plain in (False, True):
        _, fixed = ladder.make_ladder_solver(f, device=cuda_device,
                                             plain=plain)
        p = torch.tensor(f.s_load.real, dtype=F64, device=cuda_device)
        q = torch.zeros(4, f.n_branches, 3, dtype=F64, device=cuda_device,
                        requires_grad=True)
        scale = torch.linspace(0.7, 1.3, 4, dtype=F64,
                               device=cuda_device)[:, None, None]
        loss = ladder.total_loss_kw(f, fixed((scale * p, q))).sum()
        grads.append(torch.autograd.grad(loss, q)[0])
    torch.cuda.synchronize()
    g, want = grads
    assert torch.all(torch.isfinite(g))
    np.testing.assert_allclose(g.cpu().numpy(), want.cpu().numpy(),
                               rtol=GRAD_RTOL, atol=1e-10)
