"""J1's and J2's staged route, held on the CPU.

On the card J1 (``residual_jvp``) and J2 (``residual_vjp``) stage each
lane's rotated voltages once in shared memory and walk the incidence
operands as a sliced ELL (``solver_kernels.residual_layout``) on a
shape-only plan (``solver_kernels.residual_plan``).  The walk is mirrored
on the host by ``solver_kernels.residual_mirror``; these tests hold:

- the plan: a function of its arguments alone, within the card's 232,448
  bytes of shared memory a block, the wide route (a thread a lane and bus)
  above the staging capacity, forced plans checked;
- the layout: every bus in one slot, by degree, its CSR entries in order
  at ``slice_base[k // 32] + 32 t + k % 32``, the padding marked;
- the mirror, CTA by CTA of every plan, bit for bit equal to
  ``residual_jvp_plain`` and ``residual_vjp_plain`` (both modes, with and
  without status, float64 and float32) on case14, case_ieee30, mesh118
  and a mesh with parallel branches;
- the mirror against ``jax.jvp`` / ``jax.vjp`` of the reference's masked
  residual and injections (float64, 1e-12 of the largest entry).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freedm_tpu.grid.bus import PQ as REF_PQ
from freedm_tpu.grid.bus import SLACK as REF_SLACK
from freedm_tpu.grid import cases as ref_cases
from freedm_tpu.grid.matpower import load_builtin as ref_load_builtin
from freedm_tpu.pf.mfree import make_injection_fn as ref_injection_fn
from freedm_tpu_torch.grid.bus import BusSystem
from freedm_tpu_torch.kernels import solver_kernels as sol
from freedm_tpu_torch.pf.sparse import sparse_operands

SMEM = 232_448  # shared memory a block may use on an H100
F64, F32 = torch.float64, torch.float32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The mirror is many small ops; one thread avoids waking a pool."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _parallel_mesh():
    """A 60-bus mesh with three branches doubled (one of them reversed,
    one with a tap) beside the originals."""
    ref = ref_cases.synthetic_mesh(60, seed=2)
    pick = np.array([0, 7, 31])
    f = np.concatenate([ref.from_bus, ref.from_bus[pick[:2]],
                        ref.to_bus[pick[2:]]])
    t = np.concatenate([ref.to_bus, ref.to_bus[pick[:2]],
                        ref.from_bus[pick[2:]]])

    def more(a, scale):
        return np.concatenate([a, np.asarray(a)[pick] * scale])

    tap = np.concatenate([ref.tap, [1.0, 1.02, 1.0]])
    return dataclasses.replace(
        ref, from_bus=f, to_bus=t, r=more(ref.r, 1.5), x=more(ref.x, 0.7),
        b_chg=more(ref.b_chg, 1.0), tap=tap, shift=more(ref.shift, 0.0))


REF_CASES = {
    "case14": lambda: ref_load_builtin("case14"),
    "case_ieee30": lambda: ref_load_builtin("case_ieee30"),
    "mesh118": lambda: ref_cases.synthetic_mesh(118, seed=1, load_mw=10.0,
                                                chord_frac=1.0),
    "parallel60": _parallel_mesh,
}


def _port(ref):
    return BusSystem.from_arrays(dataclasses.asdict(ref))


def _inputs(sys_, lanes, dtype, seed):
    n, m = sys_.n_bus, sys_.n_branch
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(0, 0.2, (lanes, n)),
                        rng.uniform(0.9, 1.1, (lanes, n))], 1)
    u = rng.normal(size=(lanes, 2 * n))
    st = (rng.random((lanes, m)) > 0.1).astype(np.float64)
    return [torch.as_tensor(a, dtype=dtype) for a in (x, u, st)]


def _plans(n, m, lanes, dtype, status):
    """The default plan and the forced ones: every lanes-a-CTA that fits,
    one, two and every slice's CTA a lane group."""
    out = {sol.residual_plan(n, m, lanes, dtype, status)}
    fit = min(sol.RES_MAX_LANES,
              SMEM // sol.residual_stage_bytes(n, m, dtype, status))
    slices = -(-n // sol.RES_SLICE)
    for lpc in range(1, fit + 1):
        for cpl in sorted({1, min(2, slices), slices}):
            out.add(sol.residual_plan(n, m, lanes, dtype, status, lpc, cpl))
    return sorted(out)


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


SHAPES = [(14, 20), (118, 179), (2000, 4000), (4842, 9000), (4843, 9000),
          (5000, 10000), (10000, 20000)]


@pytest.mark.parametrize("n,m", SHAPES)
@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("status", [False, True])
def test_plan_is_a_function_of_its_arguments_within_shared_memory(
        n, m, dtype, status):
    per = sol.residual_stage_bytes(n, m, dtype, status)
    assert per == (8 if dtype == F64 else 4) * (6 * n + (m if status
                                                         else 0))
    for lanes in (1, 3, 64, 256, 1024):
        plan = sol.residual_plan(n, m, lanes, dtype, status)
        sol.residual_plan.cache_clear()
        assert sol.residual_plan(n, m, lanes, dtype, status) == plan
        if per > SMEM:
            assert plan == sol.ResidualPlan(sol.WIDE, 1, 1, 0)
            continue
        assert plan.route == sol.STAGED
        assert 1 <= plan.lanes_per_cta <= sol.RES_MAX_LANES
        assert plan.smem == plan.lanes_per_cta * per <= SMEM
        slices = -(-n // sol.RES_SLICE)
        assert 1 <= plan.ctas_per_lane <= slices
        groups = -(-lanes // plan.lanes_per_cta)
        # Never more CTAs than an H100 holds at once (twice the target in
        # float32, where two fit an SM) unless the lane groups alone are
        # more.
        limit = sol.RES_TARGET_CTAS * (2 if dtype == F32 else 1)
        ctas = groups * plan.ctas_per_lane
        assert ctas <= max(groups, limit)


def test_plan_routes_to_the_wide_kernel_above_the_staging_capacity():
    # float64: 48 n bytes a lane; 4842 buses fit, 4843 do not.
    assert sol.residual_plan(4842, 9000, 1, F64, False).route == sol.STAGED
    assert sol.residual_plan(4843, 9000, 1, F64, False).route == sol.WIDE
    # A per-lane status row takes 8 m bytes more.
    assert sol.residual_plan(4000, 5056, 1, F64, True).route == sol.STAGED
    assert sol.residual_plan(4000, 5057, 1, F64, True).route == sol.WIDE
    assert sol.residual_plan(4000, 5057, 1, F32, True).route == sol.STAGED
    # float32 halves the stage: 9685 buses fit.
    assert sol.residual_plan(9685, 9000, 8, F32, False).route == sol.STAGED
    assert sol.residual_plan(9686, 9000, 8, F32, False).route == sol.WIDE


def test_forced_plans_are_checked():
    plan = sol.residual_plan(2000, 4000, 256, F32, False, 3, 2)
    assert plan == sol.ResidualPlan(sol.STAGED, 3, 2, 3 * 48000)
    assert sol.residual_plan(2000, 4000, 256, F64, False,
                             route=sol.WIDE).route == sol.WIDE
    with pytest.raises(ValueError):  # 3 lanes of 96 KB do not fit
        sol.residual_plan(2000, 4000, 256, F64, False, 3, 1)
    with pytest.raises(ValueError):  # 63 slices at mesh2000
        sol.residual_plan(2000, 4000, 256, F64, False, 1, 64)
    with pytest.raises(ValueError):
        sol.residual_plan(2000, 4000, 256, F64, False, 0, 1)
    with pytest.raises(ValueError):
        sol.residual_plan(2000, 4000, 256, F64, False, route="rows")
    with pytest.raises(ValueError):
        sol.residual_plan(2000, 4000, 256, F64, False, 2, route=sol.WIDE)
    with pytest.raises(TypeError):
        sol.residual_plan(2000, 4000, 256, torch.float16, False)


def test_the_cpu_path_is_the_plain_version_whatever_the_plan():
    sys_ = _port(REF_CASES["case14"]())
    op = sparse_operands(sys_, device="cpu")
    x, u, _ = _inputs(sys_, 2, F64, 0)
    # On the CPU the plan is not read: the plain version runs.
    other = sol.residual_plan(118, 179, 2, F64, False)
    got = sol.residual_jvp(x, u, op, plan=other)
    assert torch.equal(got, sol.residual_jvp_plain(x, u, op))
    with pytest.raises(ValueError):  # not a CUDA or CPU tensor
        sol.residual_jvp(x.to("meta"), u.to("meta"), op)


# ---------------------------------------------------------------------------
# The layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(REF_CASES))
def test_layout_holds_every_bus_entries_in_order(name):
    op = sparse_operands(_port(REF_CASES[name]()), device="cpu")
    vop = sol.vjp_operands(op)
    lay = sol.residual_layout(op, vop)
    n, m = op.n, op.m
    ptr = op.inc_ptr.long()
    deg = torch.diff(ptr)
    slices = -(-n // sol.RES_SLICE)
    slot = lay.slot.long()
    base = lay.slice_base.long()
    assert lay.slot.dtype == lay.slice_base.dtype == torch.int32
    assert slot.shape == (32 * slices, 2)
    assert base.shape == (slices + 1,) and int(base[0]) == 0
    assert lay.val.shape == (lay.entries, 6) and lay.idx.shape == (
        lay.entries, 2)
    assert int(base[-1]) == lay.entries
    # Every bus in one slot, by degree (largest first, ties in bus order),
    # the slots past the last bus (-1, 0).
    assert sorted(slot[:n, 0].tolist()) == list(range(n))
    assert torch.equal(slot[:n, 1], deg[slot[:n, 0]])
    keys = [(-int(d), int(b)) for b, d in slot[:n].tolist()]
    assert keys == sorted(keys)
    assert bool((slot[n:, 0] == -1).all()) and bool((slot[n:, 1] == 0).all())
    assert lay.where.dtype == torch.int32
    assert torch.equal(slot[lay.where.long(), 0], torch.arange(n))
    for s in range(slices):
        assert int(base[s + 1] - base[s]) == 32 * int(slot[32 * s, 1])
    seen = torch.zeros(lay.entries, dtype=torch.bool)
    cols = [op.inc_g, op.inc_b, op.inc_gs, op.inc_bs, vop.inc_gt,
            vop.inc_bt]
    for k in range(n):
        i = int(slot[k, 0])
        for t in range(int(deg[i])):
            e = int(base[k // 32]) + 32 * t + k % 32
            r = int(ptr[i]) + t
            assert not seen[e]
            seen[e] = True
            assert int(lay.idx[e, 0]) == int(op.inc_code[r])
            assert int(lay.idx[e, 1]) == int(op.inc_nbr[r])
            for q, col in enumerate(cols):
                assert lay.val[e, q] == col[r]
    assert int(seen.sum()) == 2 * m
    pad = ~seen
    assert bool((lay.idx[pad] == -1).all())
    assert bool((lay.val[pad] == 0).all())
    # J1's layout holds the first four values alone, in its dtype.
    lo = sol.residual_layout(op.to_dtype(F32))
    assert lo.val.shape == (lay.entries, 4) and lo.val.dtype == F32
    assert torch.equal(lo.idx, lay.idx) and torch.equal(lo.slot, lay.slot)
    assert torch.equal(lo.val, lay.val[:, :4].float())


# ---------------------------------------------------------------------------
# The mirror against the plain versions, bit for bit
# ---------------------------------------------------------------------------


def _bits_equal(a, b):
    return a.shape == b.shape and torch.equal(
        a.view(torch.int64 if a.dtype == F64 else torch.int32),
        b.view(torch.int64 if b.dtype == F64 else torch.int32))


@pytest.mark.parametrize("name", sorted(REF_CASES))
@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("with_status", [False, True])
def test_mirror_equals_the_plain_jvp_bit_for_bit(name, dtype, with_status):
    sys_ = _port(REF_CASES[name]())
    op = sparse_operands(sys_, dtype=dtype, device="cpu")
    lanes = 5
    x, u, st = _inputs(sys_, lanes, dtype, seed=22)
    st = st if with_status else None
    lay = sol.residual_layout(op)
    want = sol.residual_jvp_plain(x, u, op, st)
    for plan in _plans(op.n, op.m, lanes, dtype, with_status):
        got = sol.residual_mirror(x, u, op, lay, plan, vjp=False, status=st)
        assert _bits_equal(got, want), plan


@pytest.mark.parametrize("name", sorted(REF_CASES))
@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("mode", [sol.MASKED, sol.FULL])
@pytest.mark.parametrize("with_status", [False, True])
def test_mirror_equals_the_plain_vjp_bit_for_bit(name, dtype, mode,
                                                 with_status):
    sys_ = _port(REF_CASES[name]())
    op = sparse_operands(sys_, dtype=dtype, device="cpu")
    vop = sol.vjp_operands(op)
    lanes = 5
    x, w, st = _inputs(sys_, lanes, dtype, seed=23)
    st = st if with_status else None
    lay = sol.residual_layout(op, vop)
    want = sol.residual_vjp_plain(x, w, op, vop, mode, st)
    for plan in _plans(op.n, op.m, lanes, dtype, with_status):
        got = sol.residual_mirror(x, w, op, lay, plan, vjp=True, mode=mode,
                                  status=st)
        assert _bits_equal(got, want), plan


def test_a_lane_gives_the_same_bits_at_any_width():
    """Lane 3's result alone, among 5 lanes and among 9, under each plan."""
    sys_ = _port(REF_CASES["mesh118"]())
    op = sparse_operands(sys_, device="cpu")
    vop = sol.vjp_operands(op)
    lay = sol.residual_layout(op, vop)
    x, u, st = _inputs(sys_, 9, F64, seed=24)
    outs = []
    for lanes in (1, 5, 9):
        sl = slice(3, 4) if lanes == 1 else slice(0, lanes)
        pick = 0 if lanes == 1 else 3
        for plan in _plans(op.n, op.m, lanes, F64, True):
            for vjp in (False, True):
                got = sol.residual_mirror(x[sl], u[sl], op, lay, plan, vjp,
                                          sol.MASKED, st[sl])
                outs.append((vjp, got[pick]))
    for vjp in (False, True):
        rows = [g for v, g in outs if v == vjp]
        assert all(_bits_equal(r, rows[0]) for r in rows)


# ---------------------------------------------------------------------------
# The mirror against the reference
# ---------------------------------------------------------------------------


def _ref_functions(ref):
    inj = ref_injection_fn(ref, jnp.float64)
    n = ref.n_bus
    th_free = jnp.asarray(ref.bus_type != REF_SLACK, jnp.float64)
    v_free = jnp.asarray(ref.bus_type == REF_PQ, jnp.float64)

    def full(x, status):
        p, q = inj(x[:n], x[n:], status=status)
        return jnp.concatenate([p, q])

    def masked(x, status):
        p, q = inj(x[:n], x[n:], status=status)
        return jnp.concatenate([
            jnp.where(th_free > 0, p - ref.p_inj, x[:n]),
            jnp.where(v_free > 0, q - ref.q_inj, x[n:] - ref.v_set)])

    return {sol.FULL: full, sol.MASKED: masked}


@pytest.mark.parametrize("name", sorted(REF_CASES))
@pytest.mark.parametrize("with_status", [False, True])
def test_mirror_matches_the_reference(name, with_status):
    ref = REF_CASES[name]()
    sys_ = _port(ref)
    op = sparse_operands(sys_, device="cpu")
    vop = sol.vjp_operands(op)
    lay = sol.residual_layout(op, vop)
    lanes = 3
    x, u, st = _inputs(sys_, lanes, F64, seed=25)
    xs, us, sts = x.numpy(), u.numpy(), st.numpy()
    st = st if with_status else None
    plan = sol.residual_plan(op.n, op.m, lanes, F64, with_status)
    fns = _ref_functions(ref)

    def lane_status(b):
        return jnp.asarray(sts[b]) if with_status else None

    want = np.stack([np.asarray(jax.jvp(
        lambda z: fns[sol.MASKED](z, lane_status(b)), (jnp.asarray(xs[b]),),
        (jnp.asarray(us[b]),))[1]) for b in range(lanes)])
    got = sol.residual_mirror(x, u, op, lay, plan, vjp=False, status=st)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    for mode in (sol.MASKED, sol.FULL):
        want = np.stack([np.asarray(jax.vjp(
            lambda z: fns[mode](z, lane_status(b)),
            jnp.asarray(xs[b]))[1](jnp.asarray(us[b]))[0])
            for b in range(lanes)])
        got = sol.residual_mirror(x, u, op, lay, plan, vjp=True, mode=mode,
                                  status=st)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
