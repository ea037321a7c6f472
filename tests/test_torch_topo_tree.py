"""T1's spanning-tree cut test, held to the reference on the CPU.

On the card T1 (``topo_radiality``) runs no label sweeps: it cuts one
spanning tree of the base graph (``topo_kernels.tree_plan``) at a lane's
opened branches and asks whether the closed non-tree branches join the
pieces.  Its per-lane logic is mirrored on the host by
``topo_kernels.radiality_mirror``; these tests hold that mirror, on
booleans, to ``freedm_tpu.pf.topo.make_radiality_check`` (CPU, x64):

- the tree plan: every bus in one preorder, the subtree intervals nested
  or disjoint, the ends' CSR table and the cut rows consistent, n − 1 tree
  branches on a connected case and the base flag false on a case made
  disconnected;
- the mirror on case14, case_ieee30, mesh118, a 30-bus mesh with few
  chords, a radial feeder's graph and graphs with parallel branches and
  self-loops: every rank-≤ 2 variant, and seeded random rank-≤ 6 rows with
  repeats, ``-1`` pads, slots ≥ m and bridges;
- ``screen_plan(n, m, r)``: a function of the shapes alone, within the
  card's 232,448 bytes of shared memory a block for every case the tests
  and ``chip_smoke.py`` use.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from freedm_tpu.grid import cases as ref_cases
from freedm_tpu.grid import matpower as ref_matpower
from freedm_tpu.pf import topo as rtp
from freedm_tpu_torch.kernels import topo_kernels as tk
from freedm_tpu_torch.pf import topo as tp

SMEM = 232_448  # shared memory a block may use on an H100


def _graph(n, f, t):
    f = np.asarray(f, np.int64)
    return SimpleNamespace(n_bus=int(n), n_branch=int(f.shape[0]),
                           from_bus=f, to_bus=np.asarray(t, np.int64))


def _feeder():
    feeder = ref_cases.synthetic_radial(40, seed=3)
    m = int(feeder.from_node.shape[0])
    return _graph(m + 1, feeder.from_node, np.arange(1, m + 1))


def _parallel():
    """A 12-bus ring with a parallel copy of two ring branches, a chord and
    two self-loops."""
    f = list(range(12)) + [3, 7, 2, 5, 9]
    t = [(i + 1) % 12 for i in range(12)] + [4, 8, 9, 5, 9]
    return _graph(12, f, t)


GRAPHS = {
    "case14": lambda: ref_matpower.load_builtin("case14"),
    "case_ieee30": lambda: ref_matpower.load_builtin("case_ieee30"),
    "mesh118": lambda: ref_cases.synthetic_mesh(118, seed=1, load_mw=10.0,
                                                chord_frac=1.0),
    "mesh30": lambda: ref_cases.synthetic_mesh(30, seed=4, load_mw=5.0,
                                               chord_frac=0.3),
    "feeder": _feeder,
    "parallel": _parallel,
}


def _plan(g):
    return tk.tree_plan(g.n_bus, np.asarray(g.from_bus), np.asarray(g.to_bus))


def _bridges(g):
    """Branches whose opening alone disconnects the graph (host search)."""
    n, m = g.n_bus, g.n_branch
    f, t = np.asarray(g.from_bus), np.asarray(g.to_bus)
    out = []
    for e in range(m):
        parent = list(range(n))

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for j in range(m):
            if j != e:
                parent[find(int(f[j]))] = find(int(t[j]))
        if len({find(i) for i in range(n)}) > 1:
            out.append(e)
    return out


def _random_rows(g, rng, lanes, r=6):
    """Rows of up to ``r`` slots: random branches, repeats, ``-1`` pads,
    slots >= m, the graph's bridges and every branch of a bus (an island
    of one bus)."""
    m = g.n_branch
    bridges = _bridges(g)
    f, t = np.asarray(g.from_bus), np.asarray(g.to_bus)
    stars = [np.nonzero((f == x) | (t == x))[0] for x in range(g.n_bus)]
    stars = [s for s in stars if 0 < s.shape[0] <= r - 1]
    rows = np.full((lanes, r), -1, np.int32)
    for v in range(lanes):
        k = int(rng.integers(0, r + 1))
        row = rng.integers(0, m, size=k)
        if stars and rng.random() < 0.15:
            star = stars[int(rng.integers(0, len(stars)))]
            k = star.shape[0] + 1
            row = np.append(star, rng.integers(0, m))
        if k and rng.random() < 0.2:
            row[-1] = row[0]  # a repeat
        if k and rng.random() < 0.15:
            row[int(rng.integers(0, k))] = m + int(rng.integers(0, 3))
        if k and bridges and rng.random() < 0.2:
            row[0] = bridges[int(rng.integers(0, len(bridges)))]
        rows[v, :k] = row
        rng.shuffle(rows[v])  # pads anywhere in the row
    return rows


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_tree_plan_is_a_preorder_of_one_spanning_tree(name):
    g = GRAPHS[name]()
    n, m = g.n_bus, g.n_branch
    plan = _plan(g)
    f, t = np.asarray(g.from_bus), np.asarray(g.to_bus)
    assert plan.connected
    assert sorted(plan.tin.tolist()) == list(range(n))
    assert int(plan.tree.sum()) == n - 1
    assert (plan.tout >= plan.tin).all() and int(plan.tout.max()) == n - 1
    # Each tree branch's child interval sits inside its parent's.
    iv = [tuple(plan.cut[e]) for e in np.nonzero(plan.tree)[0]]
    assert all(1 <= a <= b < n for a, b in iv)
    for a1, b1 in iv:
        for a2, b2 in iv:
            assert b1 < a2 or b2 < a1 or (a1 <= a2 and b2 <= b1) or (
                a2 <= a1 and b1 <= b2)
    for e in np.nonzero(plan.tree)[0]:
        a, b = plan.cut[e]
        child = f[e] if plan.tin[f[e]] == a else t[e]
        parent = t[e] if child == f[e] else f[e]
        assert plan.tin[child] == a and plan.tout[child] == b
        assert plan.tin[parent] < a and b <= plan.tout[parent]
    # The non-tree branches: both ends in the CSR table, in order of own.
    nt = np.nonzero(~plan.tree)[0]
    assert plan.ends.shape == (2 * nt.shape[0],)
    own = plan.ends & 0xFFFF
    assert (np.diff(own.astype(np.int64)) >= 0).all()
    assert plan.start[0] == 0 and plan.start[n] == 2 * nt.shape[0]
    for x in range(n):
        assert (own[plan.start[x]:plan.start[x + 1]] == x).all()
    for e in nt:
        pa, pb = -1 - int(plan.cut[e, 0]), int(plan.cut[e, 1])
        assert pa != pb
        assert int(plan.ends[pa]) == int(plan.tin[f[e]]) | int(
            plan.tin[t[e]]) << 16
        assert int(plan.ends[pb]) == int(plan.tin[t[e]]) | int(
            plan.tin[f[e]]) << 16
    words = tk.tree_buffer(plan)
    assert words.shape == (tk.tree_words(n, m),)
    assert 4 * words.shape[0] + 16 <= SMEM


def test_tree_plan_flags_a_disconnected_base():
    g = GRAPHS["case14"]()
    keep = [e for e in range(g.n_branch) if e not in _bridges(g)]
    cut = _graph(g.n_bus, np.asarray(g.from_bus)[keep],
                 np.asarray(g.to_bus)[keep])
    plan = _plan(cut)
    assert not plan.connected
    assert int(plan.tree.sum()) < g.n_bus - 1
    assert sorted(plan.tin.tolist()) == list(range(g.n_bus))
    # Every lane of a disconnected base is disconnected, in both.
    slots = np.array([[-1, -1], [0, -1], [1, 1]], np.int32)
    conn, rad = tk.radiality_mirror(slots, plan, cut.n_bus, cut.n_branch)
    want = rtp.make_radiality_check(cut, r_max=2)(slots)
    assert not conn.any() and not rad.any()
    np.testing.assert_array_equal(conn, np.asarray(want.connected))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_mirror_matches_the_reference_on_every_rank2_variant(name):
    g = GRAPHS[name]()
    slots = tp.enumerate_variants(np.arange(g.n_branch), 2)
    conn, rad = tk.radiality_mirror(slots, _plan(g), g.n_bus, g.n_branch)
    want = rtp.make_radiality_check(g, r_max=2)(slots)
    np.testing.assert_array_equal(conn, np.asarray(want.connected))
    np.testing.assert_array_equal(rad, np.asarray(want.radial))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_mirror_matches_the_reference_on_random_rank6_rows(name):
    g = GRAPHS[name]()
    rng = np.random.default_rng(sorted(GRAPHS).index(name))
    slots = _random_rows(g, rng, 400)
    conn, rad = tk.radiality_mirror(slots, _plan(g), g.n_bus, g.n_branch)
    want = rtp.make_radiality_check(g, r_max=6)(slots)
    np.testing.assert_array_equal(conn, np.asarray(want.connected))
    np.testing.assert_array_equal(rad, np.asarray(want.radial))
    # Both verdicts occur, so neither side passes by being constant.
    assert conn.any() and not conn.all()


def test_mirror_on_the_parallel_branches_and_self_loops():
    g = _parallel()
    plan = _plan(g)
    # The self-loops (15, 16) and one of each parallel pair are non-tree.
    assert not plan.tree[15] and not plan.tree[16]
    assert plan.tree[[3, 12]].sum() == 1 and plan.tree[[7, 13]].sum() == 1
    pad = [-1] * 6
    rows = [[3], [3, 12], [3, 12, 7, 13], [3, 3, 12], [15, 16], [0, 6],
            [0, 6, 14], [17, 3], [12, 13, 14, 15, 16, 0]]
    slots = np.array([(row + pad)[:6] for row in rows], np.int32)
    conn, rad = tk.radiality_mirror(slots, plan, g.n_bus, g.n_branch)
    want = rtp.make_radiality_check(g, r_max=6)(slots)
    np.testing.assert_array_equal(conn, np.asarray(want.connected))
    np.testing.assert_array_equal(rad, np.asarray(want.radial))
    # The parallel copy keeps 3-4 joined; with both pairs open the arc
    # 4-7 is an island; without the chord the ring's two arcs part; the
    # ring less one branch, every extra open, is a spanning tree.
    assert conn.tolist() == [True, True, False, True, True, True, False,
                             True, True]
    assert rad.tolist() == [False] * 8 + [True]


def test_operands_carry_the_plan():
    sys_ = tp.BusSystem.from_arrays(
        dataclasses.asdict(ref_matpower.load_builtin("case14")))
    op = tp.topo_operands(sys_, device="cpu")
    plan = _plan(sys_)
    assert op.tree.connected and np.array_equal(op.tree.tin, plan.tin)
    assert op.cut.tolist() == plan.cut.tolist()
    assert op.tree_words.tolist() == tk.tree_buffer(plan).tolist()


CASE_SHAPES = {"case14": (14, 20), "case_ieee30": (30, 41),
               "mesh118": (118, 236), "mesh2000": (2000, 4000),
               "mesh30": (30, 39), "mesh511": (511, 1022)}


@pytest.mark.parametrize("name", sorted(CASE_SHAPES))
def test_screen_plan_is_a_function_of_shapes_within_shared_memory(name):
    n, m = CASE_SHAPES[name]
    for r in range(1, tk.MAX_RANK + 1):
        plan = tk.screen_plan(n, m, r)
        assert plan == tk.screen_plan(n, m, r)
        assert plan.smem == tk.screen_smem(n, m, plan.warps, plan.group,
                                           plan.staged, plan.masks)
        assert plan.smem <= SMEM
        assert plan.warps % plan.group == 0
        assert plan.warps <= (16 if plan.wide else 8)
        assert plan.wide == (n > tk.WIDE_FROM)
    assert tk.screen_plan(118, 236, 2) == tk.ScreenPlan(
        8, 1, True, True, tk.screen_smem(118, 236, 8, 1, True, True), False)
    assert tk.screen_plan(2000, 4000, 3)[:3] == (16, 2, True)
    with pytest.raises(ValueError, match="slot width"):
        tk.screen_plan(n, m, 7)
    assert 4 * tk.tree_words(n, m) + 16 <= SMEM


def test_screen_plan_takes_every_shape_the_screen_takes():
    # A lane's n angles are the least T2 keeps: any n with 8 n bytes fits.
    for n, m in ((29_056, 1), (10_000, 20_000), (5_000, 10_000)):
        plan = tk.screen_plan(n, m, 6)
        assert plan.smem <= SMEM
    with pytest.raises(ValueError, match="too large"):
        tk.screen_plan(29_057, 1, 1)
