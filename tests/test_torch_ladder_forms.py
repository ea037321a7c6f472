"""The dense and doubling ladder forms (L3, L4) and the source phasors'
cotangent of every ladder reverse mode, against the JAX package.

``freedm_tpu_torch.kernels.ladder_kernels`` against ``freedm_tpu.pf``
(CPU, x64) on the same numpy inputs, float64:

- the plain versions of L3 and L4 (``ladder_dense_plain``,
  ``ladder_doubling_plain``), ``solve`` and ``fixed``, against the
  reference's ``make_ladder_solver(sweep_method="dense" | "doubling")``
  under ``jax.vmap`` on vvc_9bus, rand200, trunk64 and radial300 × 3
  lanes with per-lane source voltages: states within ``ATOL`` pu, equal
  iterations and flags;
- their reverse modes (``ladder_dense_vjp_plain``,
  ``ladder_doubling_vjp_plain``, through ``LadderFixed`` on CPU tensors)
  and the Euler form's (L2's plain version through ``make_ladder_solver``)
  against ``jax.grad`` of the reference's ``solve_fixed`` total loss in the
  loads and in ``v_source_pu`` (``[B]``), rtol ``GRAD_RTOL``; each reverse
  mode against ``torch.autograd`` of its plain solve on random cotangents;
- ``solve_fixed`` takes ``LadderFixed`` when only ``v_source_pu`` requires
  a gradient;
- the doubling tables: the jump chain equal to the reference's, and the
  preimage lists a gather-sum with ``index_add``'s bits on random trees;
- L3's tables (numpy only): the nonzero blocks of the subtree matrix and
  its transpose cover every nonzero and list no zero block (vvc_9bus,
  synthetic_radial(2048), a random forest), the preorder permutation
  goes in and back out unchanged, the route is a function of ``(nb,
  dtype)`` with its cap, the slice plan a function of the matrix alone,
  and the block products over the plan, added in slice order, give the
  dense product.

The ``cuda``-marked checks of the kernels are in
``tests/test_torch_ladder_forms_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freedm_tpu.grid import cases as ref_cases
from freedm_tpu.pf import ladder as ref_ladder
from freedm_tpu.pf import sweeps as ref_sweeps
from freedm_tpu.utils import cplx as ref_cplx
from freedm_tpu_torch.cplx import C
from freedm_tpu_torch.grid import cases, feeder
from freedm_tpu_torch.kernels import ladder_kernels as lk
from freedm_tpu_torch.pf import ladder, sweeps

F64 = torch.float64
CPU = torch.device("cpu")
ATOL = 1e-10
GRAD_RTOL = 1e-8
EPS = 1e-4
LANES = 3

FEEDERS = {
    "9bus": lambda m: m.vvc_9bus(),
    "rand200": lambda m: m.synthetic_radial(200, seed=1),
    "trunk64": lambda m: m.synthetic_radial(64, seed=2, lateral_prob=0.0),
    "radial300": lambda m: m.synthetic_radial(300, seed=5),
}
OPERANDS = {"dense": lk.dense_operands, "doubling": lk.doubling_operands}
PLAIN = {"dense": lk.ladder_dense_plain, "doubling": lk.ladder_doubling_plain}
VJP_PLAIN = {"dense": lk.ladder_dense_vjp_plain,
             "doubling": lk.ladder_doubling_vjp_plain}


def _both(name):
    return FEEDERS[name](cases), FEEDERS[name](ref_cases)


def _lanes(f, seed=0):
    """``LANES`` load lanes (the feeder's loads × uniform 0.7-1.3) and
    per-lane source voltages, numpy."""
    rng = np.random.default_rng(seed)
    loads = rng.uniform(0.7, 1.3, (LANES, 1, 1)) * f.s_load[None]
    vs = np.linspace(0.98, 1.04, LANES)
    return loads, vs


def _port_inputs(f, loads, vs):
    """The kernels' inputs: loads in pu and source phasors ``[B, 3]``."""
    s = loads / f.s_base_per_phase_kva
    u = ladder.SOURCE_UNIT[None, :] * vs[:, None]
    return (C(torch.tensor(s.real), torch.tensor(s.imag)),
            C(torch.tensor(u.real), torch.tensor(u.imag)))


def _assert_out(out, want):
    for got, k in ((out.v, "v_node"), (out.i_branch, "i_branch"),
                   (out.i_load, "i_load")):
        ref = getattr(want, k)
        if k == "v_node":
            ref = ref_cplx.C(ref.re[:, 1:], ref.im[:, 1:])
        np.testing.assert_allclose(got.to_numpy(), ref.to_numpy(), rtol=0,
                                   atol=ATOL, err_msg=k)
    np.testing.assert_array_equal(out.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(want.converged))


@pytest.mark.parametrize("name", list(FEEDERS))
@pytest.mark.parametrize("form", ["dense", "doubling"])
def test_plain_forms_match_reference(form, name):
    f, rf = _both(name)
    op = OPERANDS[form](f, F64, CPU)
    loads, vs = _lanes(f)
    s, v0 = _port_inputs(f, loads, vs)
    r_solve, r_fixed = ref_ladder.make_ladder_solver(rf, sweep_method=form)
    rl, rv = ref_cplx.as_c(loads), jnp.asarray(vs)
    for fixed, ref_fn in ((False, r_solve), (True, r_fixed)):
        out = PLAIN[form](s, v0, op, EPS, 20, fixed)
        _assert_out(out, jax.vmap(ref_fn)(rl, rv))
    assert not bool(out.i_branch.re.isnan().any())


@pytest.mark.parametrize("name", ["9bus", "rand200", "trunk64"])
@pytest.mark.parametrize("form", ["dense", "doubling"])
def test_plain_sweeps_match_reference_operators(form, name):
    f, rf = _both(name)
    op = OPERANDS[form](f, F64, CPU)
    mine = lk.form_sweeps(op)
    theirs = {"dense": ref_sweeps.dense_sweeps,
              "doubling": ref_sweeps.doubling_sweeps}[form](rf, jnp.float64)
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(2, f.n_branches, 3)), rng.normal(
        size=(2, f.n_branches, 3))
    x = C(torch.tensor(a), torch.tensor(b))
    for got_fn, want_fn in zip(mine, theirs):
        want = jax.vmap(want_fn)(ref_cplx.as_c(a + 1j * b))
        np.testing.assert_allclose(got_fn(x).to_numpy(), want.to_numpy(),
                                   rtol=0, atol=1e-12)


def _ref_grads(rf, form, loads, vs, max_iter=20):
    """``jax.grad`` of the lanes' summed total loss in (Q, vs)."""
    _, r_fixed = ref_ladder.make_ladder_solver(rf, max_iter=max_iter,
                                               sweep_method=form)
    p = jnp.asarray(loads.real)

    def loss(q, v):
        res = jax.vmap(r_fixed)(ref_cplx.C(p, q), v)
        return jnp.sum(jax.vmap(lambda r: ref_ladder.total_loss_kw(rf, r))(
            res))

    gq, gv = jax.grad(loss, argnums=(0, 1))(jnp.asarray(loads.imag),
                                            jnp.asarray(vs))
    return np.asarray(gq), np.asarray(gv)


def _assert_grad(got, want):
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * np.abs(want).max())


def _function_loss(f, op, p, q, vs, max_iter=20):
    """The total loss through ``LadderFixed`` on CPU tensors (the form's
    plain fixed solve forward, its plain reverse mode backward), as
    ``make_ladder_solver``'s ``prep`` and ``finish`` wrap it."""
    base = f.s_base_per_phase_kva
    unit = ladder.SOURCE_UNIT
    v0 = C(torch.tensor(unit.real)[None] * vs[:, None],
           torch.tensor(unit.imag)[None] * vs[:, None])
    out = lk.LadderFixed.apply(p / base, q / base, v0.re, v0.im, op, EPS,
                               max_iter)
    v_node = C(torch.cat([v0.re[:, None], out[0]], dim=1),
               torch.cat([v0.im[:, None], out[1]], dim=1))
    res = ladder.LadderResult(v_node, C(out[2], out[3]), C(out[4], out[5]),
                              *out[6:])
    return ladder.total_loss_kw(f, res).sum()


@pytest.mark.parametrize("name", list(FEEDERS))
@pytest.mark.parametrize("form", ["dense", "doubling"])
def test_plain_reverse_modes_match_jax_grad(form, name):
    f, rf = _both(name)
    op = OPERANDS[form](f, F64, CPU)
    loads, vs = _lanes(f, seed=1)
    p = torch.tensor(loads.real)
    q = torch.tensor(loads.imag, requires_grad=True)
    v = torch.tensor(vs, requires_grad=True)
    loss = _function_loss(f, op, p, q, v)
    gq, gv = torch.autograd.grad(loss, (q, v))
    want_q, want_v = _ref_grads(rf, form, loads, vs)
    _assert_grad(gq.numpy(), want_q)
    _assert_grad(gv.numpy(), want_v)
    # Dead or absent: no Q on a missing phase moves anything.
    assert np.all(gq.numpy()[:, f.phase_mask == 0] == 0)


@pytest.mark.parametrize("name", ["9bus", "radial300"])
@pytest.mark.parametrize("form", ["dense", "doubling", "euler"])
def test_reverse_modes_match_autograd_of_the_plain_solve(form, name):
    """Each plain reverse mode, ``v0``'s cotangent too, against
    ``torch.autograd`` of its plain fixed solve on random cotangents of
    ``v``, ``i_branch`` and ``i_load``."""
    f, _ = _both(name)
    if form == "euler":
        f = f.reorder_preorder()[0]
        op = lk.ladder_operands(f, F64, CPU)
        solve, vjp = lk.ladder_solve_plain, lk.ladder_vjp_plain
    else:
        op = OPERANDS[form](f, F64, CPU)
        solve, vjp = PLAIN[form], VJP_PLAIN[form]
    loads, vs = _lanes(f, seed=2)
    s0, v00 = _port_inputs(f, loads, vs)
    s = C(s0.re.clone().requires_grad_(), s0.im.clone().requires_grad_())
    v0 = C(v00.re.clone().requires_grad_(), v00.im.clone().requires_grad_())
    out = solve(s, v0, op, EPS, 12, True)
    rng = np.random.default_rng(11)
    shape = (LANES, f.n_branches, 3)
    cots = [C(torch.tensor(rng.normal(size=shape)),
              torch.tensor(rng.normal(size=shape))) for _ in range(3)]
    for c in cots:  # a cotangent on a dead phase must not leak through
        c.re[:, f.phase_mask == 0] = 0.0
        c.im[:, f.phase_mask == 0] = 0.0
    total = sum((o.re * c.re).sum() + (o.im * c.im).sum()
                for o, c in zip((out.v, out.i_branch, out.i_load), cots))
    want = torch.autograd.grad(total, [s.re, s.im, v0.re, v0.im])
    with torch.no_grad():
        saved = solve(s0, v00, op, EPS, 12, True, save=True).saved
        sbar, v0bar = vjp(saved, s0, op, *cots)
    assert saved.shape == (12, LANES, f.n_branches, 6)
    for a, b in zip((sbar.re, sbar.im, v0bar.re, v0bar.im), want):
        assert a.shape == b.shape and torch.all(torch.isfinite(a))
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(b.abs().max()))


def _grad_fn_names(t):
    names, stack = set(), [t.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or type(fn).__name__ in names:
            continue
        names.add(type(fn).__name__)
        stack.extend(n for n, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("name", ["9bus", "radial300"])
def test_euler_source_gradient_goes_through_ladder_fixed(name):
    """L2's plain version's ``v0`` cotangent, through ``make_ladder_solver``
    on the CPU (``"euler"``: ``LadderFixed``), against ``jax.grad``."""
    f, rf = _both(name)
    loads, vs = _lanes(f, seed=4)
    _, fixed = ladder.make_ladder_solver(f, sweep_method="euler",
                                         device="cpu")
    q = torch.tensor(loads.imag, requires_grad=True)
    v = torch.tensor(vs, requires_grad=True)
    res = fixed((torch.tensor(loads.real), q), v)
    assert "LadderFixedBackward" in _grad_fn_names(res.i_branch.re)
    gq, gv = torch.autograd.grad(ladder.total_loss_kw(f, res).sum(), (q, v))
    want_q, want_v = _ref_grads(rf, "euler", loads, vs)
    _assert_grad(gq.numpy(), want_q)
    _assert_grad(gv.numpy(), want_v)


def test_source_only_loss_takes_the_differentiable_route():
    """``solve_fixed`` decides on ``LadderFixed`` from ``v_source_pu`` as
    well as from the loads: a loss of the source voltage alone takes it."""
    f, rf = _both("9bus")
    _, fixed = ladder.make_ladder_solver(f, sweep_method="euler",
                                         device="cpu")
    vs = torch.tensor(1.01, dtype=F64, requires_grad=True)
    res = fixed(f.s_load, vs)
    assert "LadderFixedBackward" in _grad_fn_names(res.i_branch.re)
    (g,) = torch.autograd.grad(ladder.total_loss_kw(f, res), vs)
    _, r_fixed = ref_ladder.make_ladder_solver(rf, sweep_method="euler")
    want = jax.grad(lambda v: ref_ladder.total_loss_kw(
        rf, r_fixed(rf.s_load, v)))(1.01)
    np.testing.assert_allclose(float(g), float(want), rtol=GRAD_RTOL)


def _random_tree(rng, nb):
    """A random forest in the caller's order: a few roots, every other
    branch hung under an earlier one or, now and then, a later root."""
    parent = np.full(nb, -1, np.int64)
    order = rng.permutation(nb)
    for k in range(1, nb):
        if rng.uniform() > 0.05:
            parent[order[k]] = order[rng.integers(0, k)]
    depth = np.zeros(nb, np.int64)
    for i in order:
        depth[i] = 0 if parent[i] < 0 else depth[parent[i]] + 1
    return parent, int(depth.max()) + 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_preimage_lists_give_index_adds_bits(seed):
    rng = np.random.default_rng(seed)
    nb = int(rng.integers(50, 400))
    parent, levels = _random_tree(rng, nb)
    jumps = sweeps.doubling_jumps(parent, levels)
    # The jump chain: parent pointers with the sentinel, then squarings.
    j = np.concatenate([np.where(parent < 0, nb, parent), [nb]])
    assert jumps.shape[0] == max(1, int(np.ceil(np.log2(max(levels, 2)))))
    for m in range(jumps.shape[0]):
        np.testing.assert_array_equal(jumps[m], j)
        j = j[j]
    ptr, idx = sweeps.preimage_lists(jumps)
    x = torch.tensor(rng.normal(size=(2, nb + 1, 6)))
    x[:, nb] = 0.0
    for m in range(jumps.shape[0]):
        lists = [idx[ptr[m, a]:ptr[m, a + 1]] for a in range(nb)]
        assert all(np.all(np.diff(ls) > 0) for ls in lists)
        assert sorted(np.concatenate(lists).tolist()) == [
            i for i in range(nb) if jumps[m, i] < nb]
        want = x.index_add(1, torch.as_tensor(jumps[m]), x)
        got = x.clone()
        for a, ls in enumerate(lists):
            for i in ls:
                got[:, a] = got[:, a] + x[:, i]
        assert torch.equal(got[:, :nb], want[:, :nb])


@pytest.mark.parametrize("seed", [0, 1])
def test_doubling_sweeps_keep_index_adds_bits(seed):
    """The one plain doubling form (``pf.sweeps.jump_sweeps``, which L4's
    plain version and the CPU route run) adds a round's preimages in
    ``index_add``'s order: its subtree sums are the bits of the
    scatter-add rounds on random trees."""
    rng = np.random.default_rng(seed)
    nb = int(rng.integers(50, 400))
    parent, levels = _random_tree(rng, nb)
    jumps = sweeps.doubling_jumps(parent, levels)
    a, b = rng.normal(size=(2, 2, nb, 3))
    x = torch.tensor(np.concatenate([a, b], -1))
    want = torch.cat([x, torch.zeros(2, 1, 6, dtype=F64)], 1)
    for j in jumps:
        want = want.index_add(1, torch.as_tensor(j), want)
        want[:, nb] = 0.0
    backward, _ = sweeps.jump_sweeps(jumps, *sweeps.preimage_lists(jumps),
                                     device=CPU)
    got = backward(C(torch.tensor(a), torch.tensor(b)))
    assert torch.equal(torch.cat([got.re, got.im], -1), want[:, :nb])


def test_doubling_sweeps_share_the_jump_tables():
    f = cases.synthetic_radial(200, seed=1)
    op = lk.doubling_operands(f, F64, CPU)
    np.testing.assert_array_equal(
        op.jump.numpy(), sweeps.doubling_jumps(f.parent, f.levels))
    assert op.rounds == int(np.ceil(np.log2(f.levels)))
    assert op.pre_idx.dtype == torch.int32 and op.jump.dtype == torch.int32


def test_dense_operands_need_the_subtree_matrix():
    f = cases.synthetic_radial(200, seed=1)
    op = lk.dense_operands(f, F64, CPU)
    np.testing.assert_array_equal(op.sub.numpy(), f.subtree != 0)
    np.testing.assert_array_equal(op.sub_t.numpy(), (f.subtree != 0).T)
    assert op.sub.dtype == torch.uint8
    big = cases.synthetic_radial(sweeps.DENSE_MAX_BRANCHES + 1, seed=0)
    assert big.subtree is None
    with pytest.raises(ValueError, match="subtree"):
        lk.dense_operands(big, F64, CPU)


def test_forms_refuse_other_operands():
    with pytest.raises(TypeError, match="no ladder form"):
        lk._form(object())
    f = feeder.from_branch_table(
        np.array([[1, 0, 1, 1, 1.0, 1, 10, 2, 10, 2, 10, 2, 0]]),
        cases.default_z_codes(1))
    assert lk._form(lk.doubling_operands(f, F64, CPU))[0] is lk.ladder_doubling
    assert lk._form(lk.dense_operands(f, F64, CPU))[0] is lk.ladder_dense


def _subtree_of(parent):
    """The 0/1 subtree matrix of a forest in the caller's order: ``S[i,
    j] = 1`` iff branch ``j`` lies in branch ``i``'s subtree."""
    nb = parent.shape[0]
    sub = np.eye(nb, dtype=bool)
    for j in range(nb):
        i = parent[j]
        while i >= 0:
            sub[i, j] = True
            i = parent[i]
    return sub


def _dense_from_blocks(ptr, kb, data, nb):
    rows, cols = lk.DENSE_BLOCK_ROWS, lk.DENSE_BLOCK_K
    tiles, kbs = len(ptr) - 1, -(-nb // cols)
    out = np.zeros((tiles * rows, kbs * cols), np.uint8)
    for r in range(tiles):
        for n in range(ptr[r], ptr[r + 1]):
            out[r * rows:(r + 1) * rows, kb[n] * cols:(kb[n] + 1) * cols] = \
                data[n]
    return out[:nb, :nb]


def _dense_matrices():
    rng = np.random.default_rng(7)
    parent, _ = _random_tree(rng, 300)
    return {"9bus": cases.vvc_9bus().subtree != 0,
            "radial2048": cases.synthetic_radial(2048, seed=0).subtree != 0,
            "forest300": _subtree_of(parent)}


@pytest.mark.parametrize("name", ["9bus", "radial2048", "forest300"])
@pytest.mark.parametrize("transpose", [False, True])
def test_dense_blocks_cover_every_nonzero(name, transpose):
    m = _dense_matrices()[name]
    m = m.T if transpose else m
    ptr, kb, data = lk.nonzero_blocks(m)
    nb = m.shape[0]
    assert ptr[0] == 0 and ptr[-1] == kb.shape[0] == data.shape[0]
    assert len(ptr) - 1 == -(-nb // lk.DENSE_BLOCK_ROWS)
    # every nonzero once, nothing else; no block all zero
    np.testing.assert_array_equal(_dense_from_blocks(ptr, kb, data, nb),
                                  m.astype(np.uint8))
    assert bool(data.reshape(data.shape[0], -1).any(axis=1).all())
    assert set(np.unique(data)) <= {0, 1}
    for r in range(len(ptr) - 1):
        assert np.all(np.diff(kb[ptr[r]:ptr[r + 1]]) > 0)


def test_dense_blocks_in_preorder_count_as_measured():
    """At synthetic_radial(2048) the preorder keeps 452 of S's 4096
    blocks of 64 × 16 and 264 of Sᵀ's (the caller's order: 1111)."""
    f = cases.synthetic_radial(2048, seed=0, load_kw=1.0)
    op = lk.dense_operands(f, F64, CPU)
    assert lk.dense_plan(f.n_branches, F64).route == "tiled"
    assert (op.s_blocks.kb.shape[0], op.t_blocks.kb.shape[0]) == (452, 264)
    assert lk.nonzero_blocks(f.subtree != 0)[1].shape[0] == 1111


@pytest.mark.parametrize("name", ["rand200", "radial2048"])
def test_dense_preorder_round_trip(name):
    f = (cases.synthetic_radial(2048, seed=0, load_kw=1.0)
         if name == "radial2048" else FEEDERS[name](cases))
    _, perm = f.reorder_preorder()
    order = np.asarray(perm)
    assert sorted(order.tolist()) == list(range(f.n_branches))
    x = np.random.default_rng(1).normal(size=(2, f.n_branches, 6))
    pre = x[:, order]
    back = np.empty_like(pre)
    back[:, order] = pre
    np.testing.assert_array_equal(back, x)
    # in preorder every row of S is one interval [i, tout_i)
    sub = (f.subtree != 0)[np.ix_(order, order)]
    for i in range(f.n_branches):
        cols = np.flatnonzero(sub[i])
        assert cols[0] == i and np.all(np.diff(cols) == 1)
    if name == "radial2048":
        op = lk.dense_operands(f, F64, CPU)
        np.testing.assert_array_equal(op.order.numpy(), order)
        np.testing.assert_array_equal(op.pmask.numpy(),
                                      np.asarray(f.phase_mask)[order])
        np.testing.assert_array_equal(op.pz_re.numpy(),
                                      np.asarray(f.z_pu).real[order])


@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_dense_route_plan_depends_on_nb_and_dtype(dtype):
    cap = lk.dense_cta_capacity(dtype)
    assert cap == {F64: 642, torch.float32: 781}[dtype]
    for nb in (1, 8, cap):
        assert lk.dense_plan(nb, dtype).route == "cta"
        assert lk.dense_plan(nb, dtype).smem <= lk.DENSE_CTA_SMEM_CAP
    for nb in (cap + 1, 2048):
        assert lk.dense_plan(nb, dtype).route == "tiled"
    assert lk.dense_plan(cap, dtype) == lk.dense_plan(cap, dtype)
    assert lk.dense_plan(cap + 1, dtype) == lk.dense_plan(cap + 1, dtype)
    for above in (0, 1):
        f = cases.synthetic_radial(cap + above, seed=4, load_kw=1.0)
        op = lk.dense_operands(f, dtype, CPU)
        if above:
            assert op.bits is None and op.s_blocks is not None
        else:
            assert op.order is None
            np.testing.assert_array_equal(
                np.unpackbits(op.bits.numpy().view(np.uint8), axis=1,
                              bitorder="little")[:, :f.n_branches],
                (f.subtree != 0).astype(np.uint8))
    with pytest.raises(ValueError, match="at least one branch"):
        lk.dense_plan(0, dtype)


def test_dense_slice_plan_is_a_function_of_s_alone():
    f = cases.synthetic_radial(2048, seed=0, load_kw=1.0)
    op64, op32 = (lk.dense_operands(f, dt, CPU)
                  for dt in (F64, torch.float32))
    for a, b in ((op64.s_blocks, op32.s_blocks), (op64.t_blocks,
                                                  op32.t_blocks)):
        assert torch.equal(a.plan, b.plan) and a.slots == b.slots
    ptr, _, _ = lk.nonzero_blocks((f.subtree != 0))
    plan, slots = lk.slice_plan(ptr)
    again, slots2 = lk.slice_plan(ptr.copy())
    np.testing.assert_array_equal(plan, again)
    assert slots == slots2
    for r in range(len(ptr) - 1):
        rows = plan[plan[:, 0] == r]
        n = int(ptr[r + 1] - ptr[r])
        assert rows[:, 2].sum() == n and rows[0, 1] == ptr[r]
        assert np.all(rows[:, 2] <= lk.DENSE_SLICE_BLOCKS)
        assert rows[:, 2].max() - rows[:, 2].min() <= 1
        np.testing.assert_array_equal(rows[:, 3], np.arange(len(rows)))
        assert np.all(rows[:, 4] == len(rows))
        np.testing.assert_array_equal(rows[1:, 1], rows[:-1, 1] + rows[:-1, 2])
        if len(rows) > 1:
            np.testing.assert_array_equal(np.diff(rows[:, 5]), 1)
        else:
            assert rows[0, 5] == -1
    used = plan[plan[:, 5] >= 0, 5]
    assert sorted(used.tolist()) == list(range(slots))


@pytest.mark.parametrize("transpose", [False, True])
def test_dense_block_products_give_the_dense_product(transpose):
    """The tiled route's arithmetic on the CPU: each slice's blocks times
    the right-hand side's K rows, the slices of a tile added in slice
    order, equal the preorder matrix's dense product."""
    f = cases.synthetic_radial(2048, seed=0, load_kw=1.0)
    op = lk.dense_operands(f, F64, CPU)
    m = op.t_blocks if transpose else op.s_blocks
    order = op.order.numpy()
    pre = (f.subtree != 0)[np.ix_(order, order)]
    pre = pre.T if transpose else pre
    x = np.random.default_rng(2).normal(size=(f.n_branches, 6 * 3))
    rows, cols = lk.DENSE_BLOCK_ROWS, lk.DENSE_BLOCK_K
    tiles = -(-f.n_branches // rows)
    xp = np.zeros((-(-f.n_branches // cols) * cols, x.shape[1]))
    xp[:f.n_branches] = x
    data, kb = m.data.numpy().astype(np.float64), m.kb.numpy()
    out = np.zeros((tiles * rows, x.shape[1]))
    for tile, first, count, _, _, _ in m.plan.numpy():
        part = np.zeros((rows, x.shape[1]))
        for n in range(first, first + count):
            part += data[n] @ xp[kb[n] * cols:(kb[n] + 1) * cols]
        out[tile * rows:(tile + 1) * rows] += part
    np.testing.assert_allclose(out[:f.n_branches], pre.astype(np.float64) @ x,
                               rtol=0, atol=1e-11)
