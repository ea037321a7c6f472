"""Topology sweeps of the PyTorch port against the JAX package.

``freedm_tpu_torch.pf.topo`` (plain path, ``device="cpu"``, float64)
against ``freedm_tpu.pf.topo`` (CPU, x64) on the same networks and the
same inputs, made with numpy from a seed:

- the variant lists (exhaustive and neighborhood draws) byte for byte,
  order included — a checkpoint's resume relies on it;
- T1's plain version: ``connected``/``radial`` equal to the reference's
  and to a host union-find (the ring's spanning tree, case14's bridges);
- T2's plain version: islanding flags and violation counts equal, θ and
  flows within 1e-10 of the reference's (two LU libraries) and 1e-9 of a
  dense refactorization per variant; rank 0 is the base case; an adopted
  LU gives the screen of the screen's own LU;
- the merge: chunking-invariant, the lowest gid first on ties, equal to
  the reference's;
- sweeps: kill/resume exact, rechunking invariant, a spec mismatch
  restarts clean, the typed errors, islanded variants never verified; a
  checkpoint of either package resumed by the other (shortlist branches
  and gids equal, objectives within 1e-12 relative), and the mesh118
  rank-2 sweep's whole summary within 1e-9 pu of the reference's (AC
  verify f64 in both: ``precision="auto"`` on the CPU), flags and counts
  equal.

The ``cuda``-marked tests hold T1 and T2 to their plain versions on the
card (``chip_smoke.py`` does so at full size).
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freedm_tpu.grid import cases as ref_cases
from freedm_tpu.grid import matpower as ref_matpower
from freedm_tpu.pf import topo as rtp
from freedm_tpu_torch.grid.bus import BusSystem
from freedm_tpu_torch.grid.cases import synthetic_mesh
from freedm_tpu_torch.grid.matpower import load_builtin
from freedm_tpu_torch.kernels import topo_kernels as tk
from freedm_tpu_torch.pf import topo as tp
from freedm_tpu_torch.pf.fdlf import decoupled_parts
from freedm_tpu_torch.pf.n1 import secure_outages

ATOL = 1e-10  # the port against the reference: two LU libraries
DENSE_ATOL = 1e-9  # against a dense refactorization per variant
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(ref):
    return ref, BusSystem.from_arrays(dataclasses.asdict(ref))


def _mesh(n, seed, chord_frac=1.0):
    return _pair(ref_cases.synthetic_mesh(n, seed=seed, load_mw=5.0,
                                          chord_frac=chord_frac))


def _host_components(sys_, open_set):
    """Union-find component count over the closed branches."""
    parent = list(range(sys_.n_bus))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    open_set = set(int(s) for s in open_set)
    for j in range(sys_.n_branch):
        if j not in open_set:
            ra, rb = find(int(sys_.from_bus[j])), find(int(sys_.to_bus[j]))
            if ra != rb:
                parent[ra] = rb
    return len({find(i) for i in range(sys_.n_bus)})


def _random_variants(m, rng, n, r_max=2):
    """Distinct random open-sets of rank 1..r_max as a slot matrix."""
    rows, seen = [], set()
    while len(rows) < n:
        r = int(rng.integers(1, r_max + 1))
        combo = tuple(sorted(rng.choice(m, size=r, replace=False).tolist()))
        if combo in seen:
            continue
        seen.add(combo)
        row = np.full(r_max, -1, np.int32)
        row[:len(combo)] = combo
        rows.append(row)
    return np.stack(rows)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# Enumeration
# ---------------------------------------------------------------------------


class TestEnumeration:
    def test_exhaustive_counts_and_order(self):
        v = tp.enumerate_variants(np.arange(5), 2)
        assert v.shape == (tp.count_exhaustive(5, 2), 2) == (15, 2)
        # Rank ascending, lexicographic within a rank; -1 pads.
        assert v[0].tolist() == [0, -1]
        assert v[4].tolist() == [4, -1]
        assert v[5].tolist() == [0, 1]
        assert v[-1].tolist() == [3, 4]
        keys = {tuple(sorted(s for s in row if s >= 0)) for row in v}
        assert len(keys) == v.shape[0]

    def test_neighborhood_deterministic_and_distinct(self):
        a = tp.neighborhood_variants(np.arange(30), 3, 50, seed=7)
        b = tp.neighborhood_variants(np.arange(30), 3, 50, seed=7)
        assert np.array_equal(a, b)
        c = tp.neighborhood_variants(np.arange(30), 3, 50, seed=8)
        assert not np.array_equal(a, c)
        keys = {tuple(sorted(s for s in row if s >= 0)) for row in a}
        assert len(keys) == a.shape[0] == 50

    def test_neighborhood_caps_at_space_size(self):
        v = tp.neighborhood_variants(np.arange(4), 1, 100, seed=0)
        assert v.shape[0] == 4

    def test_neighborhood_rank_caps_at_switch_count(self):
        v = tp.neighborhood_variants(np.asarray([3]), 2, 5, seed=0)
        assert v.shape == (1, 2)
        assert v[0].tolist() == [3, -1]

    @pytest.mark.parametrize("switches,rank", [
        (np.arange(5), 2), (np.arange(20), 3), ([7, 3, 11, 2], 4),
        (np.arange(41), 2), ([], 2)])
    def test_exhaustive_byte_equal_to_reference(self, switches, rank):
        mine = tp.enumerate_variants(switches, rank)
        theirs = rtp.enumerate_variants(switches, rank)
        assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
        assert mine.tobytes() == theirs.tobytes()

    @pytest.mark.parametrize("switches,rank,samples,seed", [
        (np.arange(30), 3, 50, 7), (np.arange(236), 2, 1000, 1),
        (np.arange(4000), 3, 4096, 7), (np.arange(4), 1, 100, 0),
        ([3], 2, 5, 0), ([], 2, 5, 0)])
    def test_neighborhood_byte_equal_to_reference(self, switches, rank,
                                                  samples, seed):
        mine = tp.neighborhood_variants(switches, rank, samples, seed)
        theirs = rtp.neighborhood_variants(switches, rank, samples, seed)
        assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
        assert mine.tobytes() == theirs.tobytes()

    def test_sweep_variants_of_a_spec_equal_the_reference(self):
        for kw in ({"max_rank": 2}, {"switches": (4, 1, 9), "max_rank": 3},
                   {"search": "neighborhood", "samples": 300, "seed": 5,
                    "max_rank": 3}):
            mine = tp.sweep_variants(tp.TopoSweepSpec(case="case14", **kw),
                                     20)
            theirs = rtp.sweep_variants(
                rtp.TopoSweepSpec(case="case14", **kw), 20)
            assert mine.tobytes() == theirs.tobytes()
            assert (tp.TopoSweepSpec(case="case14", **kw).to_dict()
                    == rtp.TopoSweepSpec(case="case14", **kw).to_dict())


# ---------------------------------------------------------------------------
# T2: the SMW screen
# ---------------------------------------------------------------------------


class TestScreenOracle:
    """Multi-flip SMW lanes vs per-variant dense refactorization and vs
    the reference's lanes."""

    def test_smw_matches_dense_refactorization(self, rng):
        ref, sys_ = _mesh(40, 3)
        m = sys_.n_branch
        variants = _random_variants(m, rng, 60)
        det = tp.make_topo_screen(sys_, r_max=2, device=CPU).detail(
            variants, flow_limit=1.0)
        theirs = rtp.make_topo_screen(ref, r_max=2).detail(variants,
                                                           flow_limit=1.0)
        parts = decoupled_parts(sys_, device=CPU)
        th_free = _np(parts.th_free)
        rhs = np.where(th_free > 0, np.asarray(sys_.p_inj, np.float64), 0.0)
        w = 1.0 / np.asarray(sys_.x, np.float64)
        f, t = np.asarray(sys_.from_bus), np.asarray(sys_.to_bus)
        islanded = _np(det.islanded)
        np.testing.assert_array_equal(islanded, np.asarray(theirs.islanded))
        np.testing.assert_array_equal(_np(det.violations),
                                      np.asarray(theirs.violations))
        for field in ("theta", "flows", "loss", "worst_flow"):
            np.testing.assert_allclose(_np(getattr(det, field)),
                                       np.asarray(getattr(theirs, field)),
                                       atol=ATOL, rtol=0, err_msg=field)
        for i in range(variants.shape[0]):
            open_set = [int(s) for s in variants[i] if s >= 0]
            connected = _host_components(sys_, open_set) == 1
            assert bool(islanded[i]) == (not connected), open_set
            if not connected:
                continue
            status = np.ones(m)
            status[open_set] = 0.0
            theta_ref = np.linalg.solve(_np(parts.b_prime(status)), rhs)
            np.testing.assert_allclose(_np(det.theta[i]), theta_ref,
                                       atol=DENSE_ATOL)
            flows_ref = (theta_ref[f] - theta_ref[t]) * w
            flows_ref[open_set] = 0.0
            np.testing.assert_allclose(_np(det.flows[i]), flows_ref,
                                       atol=DENSE_ATOL)
            r_series = np.asarray(sys_.r, np.float64)
            assert math.isclose(float(det.loss[i]),
                                float(np.sum(r_series * flows_ref ** 2)),
                                abs_tol=DENSE_ATOL)
            assert math.isclose(float(det.worst_flow[i]),
                                float(np.max(np.abs(flows_ref))),
                                abs_tol=DENSE_ATOL)

    def test_rank0_lane_is_base_case(self):
        ref, sys_ = _mesh(24, 1)
        base = tp.make_topo_screen(sys_, r_max=2, device=CPU).detail(
            np.full((1, 2), -1, np.int32), flow_limit=1.0)
        parts = decoupled_parts(sys_, device=CPU)
        rhs = np.where(_np(parts.th_free) > 0, np.asarray(sys_.p_inj), 0.0)
        theta_ref = np.linalg.solve(_np(parts.b_prime(None)), rhs)
        assert not bool(base.islanded[0])
        np.testing.assert_allclose(_np(base.theta[0]), theta_ref, atol=1e-10)

    def test_screen_ranking_matches_detail(self, rng):
        ref, sys_ = _mesh(30, 2)
        ts = tp.make_topo_screen(sys_, r_max=2, device=CPU)
        variants = _random_variants(sys_.n_branch, rng, 40)
        s = ts.screen(variants, flow_limit=1.0)
        d = ts.detail(variants, flow_limit=1.0)
        for field in ("loss", "worst_flow", "violations", "islanded"):
            assert torch.equal(getattr(s, field), getattr(d, field)), field

    def test_shared_lu_matches_own_factorization(self):
        # The serving-cache seam: an adopted B′ LU pair gives the screen
        # of a self-factorized one, bit for bit.
        ref, sys_ = _mesh(24, 5)
        parts = decoupled_parts(sys_, device=CPU)
        lu = torch.linalg.lu_factor(parts.b_prime(None))
        own = tp.make_topo_screen(sys_, r_max=1, device=CPU)
        shared = tp.make_topo_screen(sys_, r_max=1, lu=lu, device=CPU)
        variants = tp.enumerate_variants(np.arange(sys_.n_branch), 1)
        a = own.screen(variants, flow_limit=1.0)
        b = shared.screen(variants, flow_limit=1.0)
        assert torch.equal(a.loss, b.loss)
        assert torch.equal(a.islanded, b.islanded)

    @pytest.mark.parametrize("name,rank", [("case14", 2),
                                           ("case_ieee30", 2),
                                           ("mesh118", 2)])
    def test_every_low_rank_variant_equals_the_reference(self, name, rank):
        """Every rank-<=2 variant: flags, violation counts and the
        structural verdict equal, θ, flows and objectives within 1e-10."""
        if name.startswith("mesh"):
            ref, sys_ = _pair(ref_cases.synthetic_mesh(
                118, seed=1, load_mw=10.0, chord_frac=1.0))
        else:
            ref, sys_ = _pair(ref_matpower.load_builtin(name))
        variants = tp.enumerate_variants(np.arange(sys_.n_branch), rank)
        mine = tp.make_topo_screen(sys_, rank, device=CPU).detail(
            variants, flow_limit=0.5)
        theirs = rtp.make_topo_screen(ref, rank).detail(variants,
                                                        flow_limit=0.5)
        np.testing.assert_array_equal(_np(mine.islanded),
                                      np.asarray(theirs.islanded))
        np.testing.assert_array_equal(_np(mine.violations),
                                      np.asarray(theirs.violations))
        for field in ("theta", "flows", "loss", "worst_flow"):
            np.testing.assert_allclose(_np(getattr(mine, field)),
                                       np.asarray(getattr(theirs, field)),
                                       atol=ATOL, rtol=0, err_msg=field)
        rr_m = tp.make_radiality_check(sys_, rank, device=CPU)(variants)
        rr_t = rtp.make_radiality_check(ref, rank)(variants)
        np.testing.assert_array_equal(_np(rr_m.connected),
                                      np.asarray(rr_t.connected))
        np.testing.assert_array_equal(_np(rr_m.radial),
                                      np.asarray(rr_t.radial))

    def test_p_override_and_out_of_range_slots_follow_the_reference(self,
                                                                    rng):
        ref, sys_ = _mesh(20, 8)
        m = sys_.n_branch
        slots = _random_variants(m, rng, 12, r_max=3)
        slots[0, 2] = m + 3  # JAX clamps the gather and drops the scatter
        slots[1, 1] = -1
        p = rng.normal(0.0, 0.2, sys_.n_bus)
        mine = tp.make_topo_screen(sys_, 3, device=CPU).detail(
            slots, flow_limit=0.3, p=p)
        theirs = rtp.make_topo_screen(ref, 3).detail(slots, flow_limit=0.3,
                                                     p=jnp.asarray(p))
        np.testing.assert_array_equal(_np(mine.islanded),
                                      np.asarray(theirs.islanded))
        np.testing.assert_array_equal(_np(mine.violations),
                                      np.asarray(theirs.violations))
        np.testing.assert_allclose(_np(mine.flows), np.asarray(theirs.flows),
                                   atol=ATOL, rtol=0)
        rr_m = tp.make_radiality_check(sys_, 3, device=CPU)(slots)
        rr_t = rtp.make_radiality_check(ref, 3)(slots)
        np.testing.assert_array_equal(_np(rr_m.connected),
                                      np.asarray(rr_t.connected))
        np.testing.assert_array_equal(_np(rr_m.radial),
                                      np.asarray(rr_t.radial))

    def test_shape_and_form_errors(self):
        ref, sys_ = _mesh(12, 0)
        ts = tp.make_topo_screen(sys_, r_max=2, device=CPU)
        with pytest.raises(ValueError, match=r"slots must be \[V, 2\]"):
            ts.screen(np.zeros((3, 3), np.int32))
        with pytest.raises(ValueError, match="r_max must be in"):
            tp.make_topo_screen(sys_, r_max=7, device=CPU)
        with pytest.raises(NotImplementedError, match="item 16"):
            tp.make_topo_screen(sys_, r_max=2, device=CPU, mesh=object())
        with pytest.raises(TypeError, match="float64"):
            tp.make_topo_screen(sys_, 2, dtype=torch.float32, device=CPU)


# ---------------------------------------------------------------------------
# T1: radiality
# ---------------------------------------------------------------------------


class TestRadiality:
    def test_connectivity_matches_union_find(self, rng):
        ref, sys_ = _mesh(30, 4, chord_frac=0.3)
        variants = _random_variants(sys_.n_branch, rng, 80, r_max=3)
        rr = tp.make_radiality_check(sys_, r_max=3, device=CPU)(variants)
        theirs = rtp.make_radiality_check(ref, r_max=3)(variants)
        conn, rad = _np(rr.connected), _np(rr.radial)
        np.testing.assert_array_equal(conn, np.asarray(theirs.connected))
        np.testing.assert_array_equal(rad, np.asarray(theirs.radial))
        n, m = sys_.n_bus, sys_.n_branch
        for i in range(variants.shape[0]):
            open_set = [int(s) for s in variants[i] if s >= 0]
            comps = _host_components(sys_, open_set)
            assert bool(conn[i]) == (comps == 1), open_set
            want_radial = comps == 1 and (m - len(open_set)) == n - 1
            assert bool(rad[i]) == want_radial, open_set

    def test_radial_detects_spanning_tree(self):
        # A ring of n buses has m == n: opening exactly one branch leaves
        # a spanning tree (radial); opening none leaves a mesh.
        sys_ = synthetic_mesh(12, seed=0, load_mw=5.0, chord_frac=0.0)
        assert sys_.n_branch == sys_.n_bus
        slots = np.full((2, 2), -1, np.int32)
        slots[1, 0] = 3
        rr = tp.make_radiality_check(sys_, r_max=2, device=CPU)(slots)
        assert rr.connected.tolist() == [True, True]
        assert rr.radial.tolist() == [False, True]

    def test_bridge_outage_flags_both_checks(self):
        sys_ = load_builtin("case14")
        bridges = sorted(set(range(sys_.n_branch))
                         - set(secure_outages(sys_)))
        assert bridges, "case14 should have at least one bridge"
        slots = np.full((len(bridges), 2), -1, np.int32)
        slots[:, 0] = bridges
        rr = tp.make_radiality_check(sys_, r_max=2, device=CPU)(slots)
        res = tp.make_topo_screen(sys_, r_max=2, device=CPU).screen(
            slots, flow_limit=1.0)
        assert not rr.connected.any()
        assert res.islanded.all()
        assert torch.isinf(tp.select_objective(res, "loss")).all()

    def test_sweep_cap_and_counts(self):
        sys_ = synthetic_mesh(30, seed=4, load_mw=5.0, chord_frac=0.3)
        op = tp.topo_operands(sys_, device=CPU)
        slots = torch.as_tensor(_random_variants(sys_.n_branch,
                                                 np.random.default_rng(1),
                                                 16, r_max=2))
        conn, rad, sweeps = tk.topo_radiality_plain(
            slots, op, sys_.n_bus + 1, with_sweeps=True)
        assert len(tk.topo_radiality_plain(slots, op, sys_.n_bus + 1)) == 2
        # Every lane stops on a sweep that changed nothing, well inside
        # the default cap.
        assert int(sweeps.min()) >= 2 and int(sweeps.max()) < sys_.n_bus
        # One sweep cannot settle a 30-bus ring: a capped check reports
        # the labels it reached.
        short, _, one = tk.topo_radiality_plain(slots, op, 1,
                                                with_sweeps=True)
        assert one.tolist() == [1] * 16 and not short.any()


# ---------------------------------------------------------------------------
# The merge and the status rows
# ---------------------------------------------------------------------------


class TestTopkMerge:
    def test_merge_is_chunking_invariant(self):
        rng = np.random.default_rng(3)
        obj = rng.uniform(0, 1, 100)
        obj[rng.choice(100, 10, replace=False)] = np.inf
        obj[rng.choice(100, 10, replace=False)] = 0.25  # ties
        slots = rng.integers(0, 20, (100, 2)).astype(np.int32)
        gid = np.arange(100, dtype=np.int32)
        merge = tp.make_topk_merge(2, 8, device=CPU)
        ref_merge = rtp.make_topk_merge(2, 8)

        def run(chunk):
            best = merge.init()
            for v0 in range(0, 100, chunk):
                best = merge(*best, torch.as_tensor(obj[v0:v0 + chunk]),
                             torch.as_tensor(slots[v0:v0 + chunk]),
                             torch.as_tensor(gid[v0:v0 + chunk]))
            return [b.tolist() for b in best]

        assert run(10) == run(25) == run(100)
        best = run(100)
        np.testing.assert_allclose(best[0], np.sort(obj)[:8])
        theirs = ref_merge(*ref_merge.init(), jnp.asarray(obj),
                           jnp.asarray(slots), jnp.asarray(gid))
        assert best == [np.asarray(x).tolist() for x in theirs]

    def test_merge_ties_keep_lowest_gid(self):
        merge = tp.make_topk_merge(1, 2, device=CPU)
        out = merge(*merge.init(), torch.tensor([0.5, 0.5, 0.5],
                                                dtype=torch.float64),
                    torch.tensor([[0], [1], [2]], dtype=torch.int32),
                    torch.tensor([10, 11, 12], dtype=torch.int32))
        assert out[2].tolist() == [10, 11]
        init = merge.init()
        assert init[0].dtype == torch.float64 and torch.isinf(init[0]).all()
        assert init[1].tolist() == [[-1], [-1]] and init[2].tolist() == [-1,
                                                                          -1]

    def test_status_from_slots_equals_the_reference(self):
        slots = np.asarray([[3, -1], [0, 7], [-1, -1], [9, 2]], np.int32)
        mine = tp.status_from_slots(torch.as_tensor(slots), 8)
        theirs = np.asarray(rtp.status_from_slots(slots, 8))
        assert mine.dtype == torch.float64
        np.testing.assert_array_equal(_np(mine), theirs)


# ---------------------------------------------------------------------------
# The AC verifier and the screen ladder
# ---------------------------------------------------------------------------


def test_ac_verifier_matches_the_reference():
    ref, sys_ = _pair(ref_matpower.load_builtin("case14"))
    slots = np.asarray([[18, -1], [8, 15], [-1, -1]], np.int32)
    mine = tp.make_ac_verifier(sys_, k=3, precision="f64", device=CPU)
    theirs = rtp.make_ac_verifier(ref, k=3, precision="f64")
    st = tp.status_from_slots(torch.as_tensor(slots), sys_.n_branch)
    a = mine(st)
    b = theirs(np.asarray(rtp.status_from_slots(slots, ref.n_branch)))
    np.testing.assert_array_equal(_np(a.converged), np.asarray(b.converged))
    np.testing.assert_allclose(_np(a.v), np.asarray(b.v), atol=1e-9)
    np.testing.assert_allclose(_np(a.theta), np.asarray(b.theta), atol=1e-9)
    # The port's base solve is one lane, [1, n]; the reference's is [n].
    np.testing.assert_allclose(_np(mine.base.v)[0],
                               np.asarray(theirs.base.v), atol=1e-9)
    with pytest.raises(ValueError, match=r"status must be \[3, 20\]"):
        mine(torch.ones(2, sys_.n_branch, dtype=torch.float64))


@pytest.mark.parametrize("mode", ["mesh", "radial"])
def test_screen_chunk_counts_partition_like_the_reference(mode):
    ref, sys_ = _pair(ref_matpower.load_builtin("case_ieee30"))
    variants = tp.enumerate_variants(np.arange(sys_.n_branch), 2)[:500]
    valid = np.arange(variants.shape[0]) < 480
    v = tp.screen_chunk(
        tp.make_topo_screen(sys_, 2, device=CPU),
        tp.make_radiality_check(sys_, 2, device=CPU), variants, valid,
        mode, "violations", 0.4)
    r = rtp.screen_chunk(rtp.make_topo_screen(ref, 2),
                         rtp.make_radiality_check(ref, 2), variants, valid,
                         mode, "violations", 0.4)
    np.testing.assert_array_equal(_np(v.objective), np.asarray(r.objective))
    for field in ("feasible", "disconnected", "nonradial", "islanded"):
        assert int(getattr(v, field)) == int(getattr(r, field)), field
    assert (int(v.feasible) + int(v.disconnected) + int(v.nonradial)
            + int(v.islanded)) == 480


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------


def _sweep(spec, **kw):
    return tp.run_topo_sweep(spec, device=CPU, **kw)


class TestSweep:
    def test_islanded_variants_never_reach_ac_verify(self):
        sys_ = load_builtin("case14")
        bridges = set(range(sys_.n_branch)) - set(secure_outages(sys_))
        s = _sweep(tp.TopoSweepSpec(case="case14", max_rank=2,
                                    chunk_variants=128, top_k=6))
        assert s["completed"]
        assert s["disconnected"] > 0 and s["islanded"] == 0
        assert s["shortlist"]
        for e in s["shortlist"]:
            assert not (set(e["open_branches"]) & bridges), e
            assert e["ac_converged"]
            assert e["ac_true_mismatch_pu"] < 1e-6
        objs = [e["objective"] for e in s["shortlist"]]
        assert objs == sorted(objs)

    def test_sweep_resume_exact_after_midsweep_kill(self, tmp_path):
        ck = str(tmp_path / "topo.json")
        spec = tp.TopoSweepSpec(case="case14", max_rank=2,
                                chunk_variants=48, top_k=4,
                                ac_verify=False)
        part = _sweep(spec, checkpoint_path=ck, stop_after_chunks=2)
        assert part["completed"] is False and part["chunks_done"] == 2
        resumed = _sweep(spec, checkpoint_path=ck)
        assert resumed["resumed_from_chunk"] == 2
        ref = _sweep(spec)
        assert tp.strip_topo_timing(resumed) == tp.strip_topo_timing(ref)

    def test_sweep_chunking_invariant(self):
        a = _sweep(tp.TopoSweepSpec(case="case14", max_rank=2,
                                    chunk_variants=32, ac_verify=False))
        b = _sweep(tp.TopoSweepSpec(case="case14", max_rank=2,
                                    chunk_variants=128, ac_verify=False))
        assert (tp.strip_topo_timing({**a, "chunks_total": 0})
                == tp.strip_topo_timing({**b, "chunks_total": 0}))

    def test_checkpoint_spec_mismatch_restarts_clean(self, tmp_path):
        ck = str(tmp_path / "topo.json")
        _sweep(tp.TopoSweepSpec(case="case14", max_rank=1, chunk_variants=64,
                                ac_verify=False), checkpoint_path=ck)
        s = _sweep(tp.TopoSweepSpec(case="case14", max_rank=2,
                                    chunk_variants=64, ac_verify=False),
                   checkpoint_path=ck)
        assert s["resumed_from_chunk"] == 0 and s["completed"]

    @pytest.mark.parametrize("kw,match", [
        ({"objective": "nope"}, "objective"),
        ({"objective": "violations", "flow_limit": 0.0}, "flow_limit"),
        ({"switches": (0, 999)}, "switch indices"),
        ({"search": "neighborhood", "samples": 0}, "samples"),
        ({"mode": "tree"}, "mode"),
        ({"max_rank": 7}, "max_rank"),
        ({"switches": (1, 1)}, "duplicates"),
    ])
    def test_validate_sweep_spec_typed_errors(self, kw, match):
        with pytest.raises(ValueError, match=match) as mine:
            _sweep(tp.TopoSweepSpec(case="case14", **kw))
        with pytest.raises(ValueError) as theirs:
            rtp.validate_sweep_spec(rtp.TopoSweepSpec(case="case14", **kw),
                                    20)
        assert str(mine.value) == str(theirs.value)

    def test_more_than_one_device_is_refused(self):
        with pytest.raises(NotImplementedError, match="item 16"):
            _sweep(tp.TopoSweepSpec(case="case14", mesh_devices=2))

    def test_cancel_keeps_the_checkpoint(self, tmp_path):
        import threading

        ck = str(tmp_path / "topo.json")
        ev = threading.Event()
        spec = tp.TopoSweepSpec(case="case14", max_rank=2, chunk_variants=64,
                                ac_verify=False)
        seen = []

        def on_chunk(done, total, chunk_s, real):
            seen.append((done, total, real))
            ev.set()

        with pytest.raises(tp.SweepCancelled):
            _sweep(spec, checkpoint_path=ck, cancel=ev, on_chunk=on_chunk)
        assert seen == [(1, 4, 64)]
        out = _sweep(spec, checkpoint_path=ck)
        assert out["resumed_from_chunk"] == 1


def _same_shortlist(mine, theirs):
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert a["open_branches"] == b["open_branches"]
        assert a["gid"] == b["gid"]
        assert math.isclose(a["objective"], b["objective"], rel_tol=1e-12)


@pytest.mark.parametrize("first", ["port", "reference"])
def test_checkpoint_resumes_across_packages(tmp_path, first):
    """A sweep killed after chunk 1 by one package is finished by the
    other from its checkpoint."""
    ck = str(tmp_path / "topo.json")
    kw = dict(case="case14", max_rank=2, chunk_variants=64, top_k=5,
              ac_verify=False)
    mine, theirs = tp.TopoSweepSpec(**kw), rtp.TopoSweepSpec(**kw)
    if first == "port":
        _sweep(mine, checkpoint_path=ck, stop_after_chunks=1)
        out = rtp.run_topo_sweep(theirs, checkpoint_path=ck)
    else:
        rtp.run_topo_sweep(theirs, checkpoint_path=ck, stop_after_chunks=1)
        out = _sweep(mine, checkpoint_path=ck)
    assert out["resumed_from_chunk"] == 1 and out["completed"]
    whole = _sweep(mine)
    assert (tp.strip_topo_timing({**out, "shortlist": []})
            == tp.strip_topo_timing({**whole, "shortlist": []}))
    _same_shortlist(out["shortlist"], whole["shortlist"])


def test_mesh118_sweep_summary_equals_the_reference():
    spec = dict(case="mesh118", max_rank=2, chunk_variants=4096)
    mine = _sweep(tp.TopoSweepSpec(**spec))
    theirs = rtp.run_topo_sweep(rtp.TopoSweepSpec(**spec))
    a, b = tp.strip_topo_timing(mine), rtp.strip_topo_timing(theirs)
    assert {k: v for k, v in a.items() if k != "shortlist"} == \
        {k: v for k, v in b.items() if k != "shortlist"}
    assert a["variants_total"] == 27966
    _same_shortlist(a["shortlist"], b["shortlist"])
    for x, y in zip(a["shortlist"], b["shortlist"]):
        assert x["ac_converged"] == y["ac_converged"] is True
        for key in ("ac_residual_pu", "ac_true_mismatch_pu", "v_min_pu",
                    "v_max_pu"):
            assert abs(x[key] - y[key]) <= 1e-9, key


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,lanes,rank", [("case14", 105, 2),
                                             ("mesh118", 512, 6)])
def test_t1_t2_match_plain_on_card(cuda_device, name, lanes, rank):
    sys_ = (load_builtin(name) if not name.startswith("mesh")
            else synthetic_mesh(118, seed=1, load_mw=10.0, chord_frac=1.0))
    slots = torch.as_tensor(
        _random_variants(sys_.n_branch, np.random.default_rng(2), lanes,
                         r_max=rank), device=cuda_device)
    op = tp.topo_operands(sys_, device=cuda_device)
    cap = sys_.n_bus + 1
    got = tk.topo_radiality(slots, op, cap)
    want = tk.topo_radiality_plain(slots, op, cap)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    *same, sweeps = tk.topo_radiality(slots, op, cap, with_sweeps=True)
    assert torch.equal(same[0], got[0]) and torch.equal(same[1], got[1])
    assert 1 <= int(sweeps.min()) and int(sweeps.max()) <= cap
    # Below the fixed point the kernel's sweeps and the reference's may
    # stop at other labels: the card refuses such a cap.
    with pytest.raises(ValueError, match="n - 1"):
        tk.topo_radiality(slots, op, sys_.n_bus - 2)
    ts = tp.make_topo_screen(sys_, rank, device=cuda_device)
    plain = tp.make_topo_screen(sys_, rank, device=cuda_device, plain=True)
    a = ts.detail(slots, flow_limit=0.5)
    again = ts.detail(slots, flow_limit=0.5)
    b = plain.detail(slots, flow_limit=0.5)
    torch.cuda.synchronize()
    assert torch.equal(a.islanded, b.islanded)
    assert torch.equal(a.violations, b.violations)
    for field in ("theta", "flows", "loss", "worst_flow"):
        assert float((getattr(a, field) - getattr(b, field)).abs().max()) \
            <= ATOL, field
    for field in a._fields:
        assert torch.equal(getattr(a, field), getattr(again, field)), field
