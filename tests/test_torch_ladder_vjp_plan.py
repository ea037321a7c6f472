"""The launch plans of L1 and L2 (``ladder_plan``) and L4
``ladder_doubling`` (plain Python, no card): ``ladder_plan`` and
``doubling_plan`` are functions of the branch count and the dtype alone,
with their capacities and the measured small-feeder crossover
(``CLUSTER_FROM``, one CTA a lane below it); L4's
heavy-row plan (``heavy_rows``) covers every preimage of every round
exactly once, each row's in increasing index, and a CPU walk of its warp
gather-then-add (batches of 32 staged, then added one at a time) gives the
plain subtree round's bits; the operands carry the plan and the roots;
L4's plain reverse mode adds the source phasors' cotangent as the roots'
subtree sums.  The kernels themselves are held to these plain versions on
the card by ``tests/test_torch_ladder_cuda.py`` and
``tests/test_torch_ladder_forms_cuda.py``."""

import inspect

import numpy as np
import pytest
import torch

from freedm_tpu_torch.cplx import C
from freedm_tpu_torch.grid import cases, feeder
from freedm_tpu_torch.kernels import ladder_kernels as lk
from freedm_tpu_torch.pf import sweeps

F64, F32 = torch.float64, torch.float32
CPU = torch.device("cpu")
NBS = [1, 8, 9, 100, 127, 128, 129, 300, 2048, 10000, 20480, 20481, 32768,
       32769, 50000]
PLANS = {"doubling_plan": lk.doubling_plan, "ladder_plan": lk.ladder_plan}
SMALL = {"doubling_plan": "cta", "ladder_plan": "global"}


@pytest.mark.parametrize("name", list(PLANS))
@pytest.mark.parametrize("nb", [1, 9, 1000, 10000, 20481, 40000])
def test_plans_are_functions_of_nb_and_dtype_alone(name, nb):
    plan = PLANS[name]
    assert set(inspect.signature(plan).parameters) == {"nb", "dtype"}
    for dtype in (F64, F32):
        first = plan(nb, dtype)
        assert plan(int(np.int64(nb)), dtype) == first
        assert plan(nb, dtype) == first


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("nb", NBS)
@pytest.mark.parametrize("name", list(PLANS))
def test_plan_routes_by_capacity_and_crossover(name, nb, dtype):
    plan = PLANS[name](nb, dtype)
    cap = (lk.doubling_capacity(dtype) if name == "doubling_plan"
           else lk.cluster_capacity(dtype))
    if nb > cap or nb < lk.CLUSTER_FROM:
        assert plan.route == SMALL[name]
        assert plan.cluster == 1 and plan.smem == 0
        assert plan.intervals(nb) == ((0, nb),)
        rows = nb + 1 if name == "doubling_plan" else nb
        assert plan.threads == lk.global_threads(rows)
        return
    assert plan.route == "cluster"
    assert 1 <= plan.cluster <= lk.MAX_CLUSTER
    assert plan.per <= 2 * plan.threads  # two branches (rows) a thread
    assert plan.threads % 32 == 0 and plan.threads <= lk.CTA_THREADS[dtype]
    spans = plan.intervals(nb)
    assert spans[0][0] == 0 and spans[-1][1] == nb
    assert all(hi > lo for lo, hi in spans)
    assert all(hi == lo2 for (_, hi), (lo2, _) in zip(spans, spans[1:]))
    item = 8 if dtype == F64 else 4
    if name == "doubling_plan":
        words = (36 * plan.threads + plan.threads // 32 * 6 * lk.STAGE_LD
                 + lk.DOUBLING_SCRATCH_WORDS)
        assert plan.smem == words * item
    else:
        assert plan.smem == ((36 * plan.threads + lk.SCRATCH_WORDS) * item
                             + 8 * plan.threads)
    assert plan.smem <= lk.SMEM_LIMIT


@pytest.mark.parametrize("dtype", [F64, F32])
def test_capacities(dtype):
    cap = {F64: 20480, F32: 32768}[dtype]
    assert lk.cluster_capacity(dtype) == lk.doubling_capacity(dtype) == cap
    for name in PLANS:
        assert PLANS[name](cap, dtype).route == "cluster"
        assert PLANS[name](cap + 1, dtype).route == SMALL[name]


def test_the_crossover_routes_the_small_feeders_to_one_cta():
    """The measured crossover (``CLUSTER_FROM``): vvc_9bus runs one CTA a
    lane in L1, L2 and L4; from the crossover on, the cluster route."""
    assert lk.CLUSTER_FROM == 256  # measured on an H100 (PERF.md §6)
    for dtype in (F64, F32):
        for name in PLANS:
            start = lk.CLUSTER_FROM
            assert PLANS[name](8, dtype).route == SMALL[name]
            assert PLANS[name](start - 1, dtype).route == SMALL[name]
            assert PLANS[name](start, dtype).route == "cluster"
    # vvc_9bus: one warp a lane (its 8 branches, L4's 9 rows)
    assert lk.ladder_plan(8, F64).threads == lk.doubling_plan(8, F64).threads
    assert lk.ladder_plan(8, F64).threads == 32
    assert lk.ladder_plan(10000, F64)[:3] == ("cluster", 8, 1250)
    assert lk.doubling_plan(10000, F64)[:4] == ("cluster", 8, 1250, 640)
    assert lk.doubling_plan(10000, F32)[:4] == ("cluster", 5, 2000, 1024)


def _runs(nb, warps):
    """The global kernel's ``Run``: each warp's branches ``[lo, hi)``."""
    per = ((nb + warps - 1) // warps + 31) // 32 * 32
    return [(min(nb, w * per), min(nb, min(nb, w * per) + per))
            for w in range(warps)]


@pytest.mark.parametrize("nb", [1, 8, 9, 31, 32, 33, 100, 255, 256, 480,
                                481, 511, 512, 513, 2048, 10000, 50000])
def test_global_threads_cut_the_runs_of_sixteen_warps(nb):
    """A narrow global CTA's warps take the runs that 16 warps take; the
    warps it leaves out own no branch (their sums, zeros, came last): L1's
    and L2's global route keeps its bits at any width the plan picks."""
    warps = lk.global_threads(nb) // 32
    assert 1 <= warps <= lk.GLOBAL_THREADS // 32
    wide = _runs(nb, lk.GLOBAL_THREADS // 32)
    assert _runs(nb, warps) == wide[:warps]
    assert all(lo == hi for lo, hi in wide[warps:])
    assert lk.global_threads(nb) == 32 * min(16, -(-nb // 32))


@pytest.mark.parametrize("doubling", [False, True])
@pytest.mark.parametrize("nb", [8, 300, 10000])
@pytest.mark.parametrize("dtype", [F64, F32])
def test_route_plan_gives_either_route_whatever_the_crossover(nb, dtype,
                                                              doubling):
    one = "cta" if doubling else "global"
    own = (lk.doubling_plan if doubling else lk.ladder_plan)(nb, dtype)
    cluster = lk.route_plan(nb, dtype, "cluster", doubling)
    single = lk.route_plan(nb, dtype, one, doubling)
    assert cluster.route == "cluster" and single.route == one
    assert own in (cluster, single)
    assert (own == cluster) == (nb >= lk.CLUSTER_FROM)
    assert cluster == ((lk._doubling_shape if doubling else lk._ladder_shape)
                       (nb, dtype))
    for plan in (cluster, single):
        assert lk._plan_for(plan, nb, dtype, doubling) is plan
    assert lk._plan_for(None, nb, dtype, doubling) == own


def test_a_plan_of_neither_route_is_refused():
    with pytest.raises(ValueError, match="no route's plan"):
        lk._plan_for(lk.route_plan(9, F64, "global")._replace(threads=64), 9,
                     F64, False)
    with pytest.raises(ValueError, match="no route's plan"):
        lk._plan_for(lk.route_plan(9, F64, "global"), 9, F64, True)
    with pytest.raises(ValueError, match="no route's plan"):
        lk._plan_for(lk.route_plan(600, F64, "cluster"), 601, F64, False)
    with pytest.raises(ValueError, match="capacity"):
        lk.route_plan(lk.cluster_capacity(F64) + 1, F64, "cluster")
    with pytest.raises(ValueError, match="no route"):
        lk.route_plan(9, F64, "cta")


def _feeder_tables(f):
    parent = np.asarray(f.parent)
    jumps = sweeps.doubling_jumps(parent, f.levels)
    return jumps, *sweeps.preimage_lists(jumps)


def fan_feeder(nb, hub_of):
    """``nb`` single-phase branches, branch ``i`` fed from the bus of
    branch ``hub_of(i)`` (``-1``: the substation)."""
    rng = np.random.default_rng(11)
    dl = np.zeros((nb, 13))
    for i in range(nb):
        p = rng.uniform(0.5, 1.5)
        dl[i] = [i + 1, hub_of(i) + 1, i + 1, 1, rng.uniform(0.001, 0.01), 1,
                 p, 0.3 * p, p, 0.3 * p, p, 0.3 * p, 0]
    return feeder.from_branch_table(dl, cases.default_z_codes(1),
                                    base_kva=10000.0)


FEEDERS = {"9bus": cases.vvc_9bus,
           "radial2048": lambda: cases.synthetic_radial(2048, seed=0),
           "radial10k": lambda: cases.synthetic_radial(10000, seed=0),
           # 599 children of one branch: a list of 599 in the first round
           "star": lambda: fan_feeder(600, lambda i: 0 if i else -1),
           # a path of 40 and 260 roots beside it
           "broom": lambda: fan_feeder(300, lambda i: i - 1 if 0 < i < 40
                                       else -1)}


@pytest.fixture(scope="module")
def tables():
    return {k: _feeder_tables(f()) for k, f in FEEDERS.items()}


def _shape(nb, dtype):
    shape = lk._doubling_shape(nb, dtype)
    assert shape is not None
    return shape


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("name", list(FEEDERS))
def test_heavy_rows_cover_every_preimage_once_in_order(tables, name, dtype):
    jumps, ptr, idx = tables[name]
    rounds, nb = jumps.shape[0], jumps.shape[1] - 1
    plan = _shape(nb, dtype)
    hptr, hidx = lk.heavy_rows(ptr, plan)
    warps = plan.threads // 32
    assert hptr.shape == (rounds, plan.cluster, warps + 1)
    flat = hptr.reshape(rounds * plan.cluster, warps + 1)
    assert flat[0, 0] == 0 and hidx.shape[0] == flat[-1, -1]
    assert np.all(np.diff(flat, axis=1) >= 0)
    assert np.all(flat[1:, 0] == flat[:-1, -1])  # the lists follow on
    lens = np.diff(ptr, axis=1)
    for m in range(rounds):
        seen = np.zeros(idx.shape[0], np.int64)
        heavy = []
        owned = np.concatenate([lk.doubling_rows(nb, plan, r)
                                for r in range(plan.cluster)])
        assert np.array_equal(np.sort(owned), np.arange(nb))  # dealt once
        for r in range(plan.cluster):
            rows = hidx[hptr[m, r, 0]:hptr[m, r, warps]]
            assert np.all((rows // 32) % plan.cluster == r)  # the owner's
            assert len(lk.doubling_rows(nb, plan, r)) <= 2 * plan.threads
            heavy.extend(int(a) for a in rows)
        assert len(heavy) == len(set(heavy))  # a row is one warp's
        assert set(heavy) == set(np.nonzero(lens[m] > lk.HEAVY_ROW)[0].tolist())
        # Every row's list, taken by its thread or its warp, in increasing i.
        for a in range(nb):
            j0, j1 = ptr[m, a], ptr[m, a + 1]
            seen[j0:j1] += 1
            got = idx[j0:j1]
            assert np.all(np.diff(got) > 0)
            assert np.all(jumps[m, got] == a)
        assert np.all(seen[ptr[m, 0]:ptr[m, -1]] == 1)
        assert ptr[m, -1] - ptr[m, 0] == int(np.sum(jumps[m, :nb] < nb))


def test_heavy_rows_balance_the_warps(tables):
    jumps, ptr, _ = tables["radial10k"]
    plan = _shape(jumps.shape[1] - 1, F64)
    hptr, hidx = lk.heavy_rows(ptr, plan)
    lens = np.diff(ptr, axis=1)
    cost = lens + 64 * -(-lens // 32)  # a batch of 32 loads as 64 adds
    busy = 0
    for m in range(jumps.shape[0]):
        for r in range(plan.cluster):
            loads = [int(sum(cost[m, a] for a in hidx[hptr[m, r, w]:
                                                      hptr[m, r, w + 1]]))
                     for w in range(plan.threads // 32)]
            top = max((cost[m, a] for a in
                       hidx[hptr[m, r, 0]:hptr[m, r, -1]]), default=0)
            # A greedy list schedule: no warp holds more than the even share
            # plus the dearest row.
            assert max(loads) <= sum(loads) / len(loads) + top
            busy += sum(1 for x in loads if x)
    assert busy > 0


def _warp_walk(x, row, pre):
    """The kernel's warp gather-then-add of one heavy row in numpy: the
    preimages' rows gathered 32 at a time into a stage, then added to
    x[row] one at a time in increasing index, each add rounded."""
    acc = x[row].copy()
    for b in range(0, len(pre), 32):
        stage = x[pre[b:b + 32]].copy()
        for k in range(stage.shape[0]):
            acc = acc + stage[k]
    return acc


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["radial2048", "radial10k", "star"])
def test_warp_gather_then_add_gives_the_plain_rounds_bits(tables, name,
                                                          dtype):
    jumps, ptr, idx = tables[name]
    nb = jumps.shape[1] - 1
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(nb, 6)) * 10.0 ** rng.integers(-6, 6, (nb, 1))
         ).astype(dtype)
    backward, _ = sweeps.jump_sweeps(jumps[:1], ptr[:1], idx, device=CPU)
    torch_dt = torch.float64 if dtype == np.float64 else torch.float32
    want = backward(C(torch.tensor(x[:, :3], dtype=torch_dt),
                      torch.tensor(x[:, 3:], dtype=torch_dt)))
    want = np.concatenate([want.re.numpy(), want.im.numpy()], axis=1)
    lens = np.diff(ptr[0])
    rows = np.nonzero(lens > 0)[0]
    for a in rows:
        got = _warp_walk(x, a, idx[ptr[0, a]:ptr[0, a + 1]])
        assert np.array_equal(got, want[a]), a
    # every round's heavy rows on the same walk, against the round's sums
    for m in range(1, jumps.shape[0]):
        backward, _ = sweeps.jump_sweeps(jumps[m:m + 1], ptr[m:m + 1], idx,
                                         device=CPU)
        want = backward(C(torch.tensor(x[:, :3], dtype=torch_dt),
                          torch.tensor(x[:, 3:], dtype=torch_dt)))
        want = np.concatenate([want.re.numpy(), want.im.numpy()], axis=1)
        for a in np.nonzero(np.diff(ptr[m]) > lk.HEAVY_ROW)[0]:
            got = _warp_walk(x, a, idx[ptr[m, a]:ptr[m, a + 1]])
            assert np.array_equal(got, want[a]), (m, a)


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("name", ["9bus", "radial10k"])
def test_doubling_operands_carry_the_plan_and_roots(name, dtype):
    f = FEEDERS[name]()
    op = lk.doubling_operands(f, dtype, CPU)
    plan = _shape(f.n_branches, dtype)
    jumps, ptr, _ = _feeder_tables(f)
    hptr, hidx = lk.heavy_rows(ptr, plan)
    assert torch.equal(op.heavy_ptr, torch.as_tensor(hptr, dtype=torch.int32))
    assert torch.equal(op.heavy_idx, torch.as_tensor(hidx, dtype=torch.int32))
    assert op.roots.tolist() == np.nonzero(np.asarray(f.parent) < 0)[0].tolist()
    assert op.heavy_ptr.dtype == op.roots.dtype == torch.int32


def test_doubling_operands_above_the_capacity_carry_no_heavy_plan():
    f = cases.synthetic_radial(lk.doubling_capacity(F64) + 1, seed=3,
                               load_kw=1.0)
    op = lk.doubling_operands(f, F64, CPU)
    assert lk.doubling_plan(f.n_branches, F64).route == "cta"
    assert tuple(op.heavy_ptr.shape) == (op.rounds, 1, 1)
    assert op.heavy_idx.numel() == 0


def test_root_sum_adds_the_roots_in_order():
    x = C(torch.arange(2 * 5 * 3, dtype=F64).reshape(2, 5, 3) * 0.1,
          -torch.arange(2 * 5 * 3, dtype=F64).reshape(2, 5, 3))
    got = lk.root_sum(x, [0, 3])
    assert torch.equal(got.re, (torch.zeros(2, 3, dtype=F64) + x.re[:, 0])
                       + x.re[:, 3])
    assert torch.equal(got.im, (torch.zeros(2, 3, dtype=F64) + x.im[:, 0])
                       + x.im[:, 3])


@pytest.mark.parametrize("name", ["9bus", "star", "broom", "radial2048",
                                  "radial10k"])
def test_doubling_reverse_modes_source_share_is_the_branch_total(name):
    """The plain reverse mode's ``v0`` cotangent (the roots' subtree sums)
    against the sum of ``mask · vbar`` over every branch that the other
    forms' plain reverse mode takes (``vjp_iterate_plain``)."""
    f = FEEDERS[name]()
    op = lk.doubling_operands(f, F64, CPU)
    rng = np.random.default_rng(3)
    lanes, nb = 2, f.n_branches
    s = C(torch.tensor(rng.uniform(0.01, 0.02, (lanes, nb, 3))),
          torch.tensor(rng.uniform(0.0, 0.01, (lanes, nb, 3))))
    v0 = C(torch.tensor(np.tile([1.0, -0.5, -0.5], (lanes, 1))),
           torch.tensor(np.tile([0.0, -0.866, 0.866], (lanes, 1))))
    saved = lk.ladder_doubling_plain(s, v0, op, 1e-4, 6, True,
                                     save=True).saved
    gs = [C(torch.tensor(rng.normal(size=(lanes, nb, 3))),
            torch.tensor(rng.normal(size=(lanes, nb, 3)))) for _ in range(3)]
    sbar, v0bar = lk.ladder_doubling_vjp_plain(saved, s, op, *gs)
    backward, forward = lk.form_sweeps(op)
    want_s, want_v0 = lk.vjp_iterate_plain(saved, s, op.mask, op.z_re,
                                           op.z_im, backward, forward, *gs)
    for a, b in ((sbar, want_s), (v0bar, want_v0)):
        for x, y in ((a.re, b.re), (a.im, b.im)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-10,
                                       atol=1e-12 * float(y.abs().max()))
