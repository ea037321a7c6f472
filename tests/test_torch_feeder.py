"""The radial feeder model and cases of the PyTorch port against the JAX
package's.

``freedm_tpu_torch.grid.feeder`` and ``grid.cases`` are host numpy, so
every array is held equal to the reference's (``np.array_equal`` and the
same dtype): the structure, impedances, loads, masks, depths and dense
subtree incidence of ``vvc_9bus``, ``synthetic_radial`` at 300 and 5000
buses (the latter without a subtree matrix) and the reference's Dl table
(``tests/data/Dl_new.mat``); the DFS preorder relabeling and its
permutation; the Dl round trip; and the same errors on cycles, duplicate
receiving buses and unknown source buses.
"""

import numpy as np
import pytest

from freedm_tpu.grid import cases as ref_cases
from freedm_tpu.grid import feeder as ref_feeder
from freedm_tpu_torch.grid import cases, feeder
from refdata import resolve

# The reference checkout's copy, a fallback behind the committed fixture.
REF_DL_MAT = "reference/Broker/Dl_new.mat"
ARRAYS = ("parent", "from_node", "z_pu", "s_load", "q_shunt", "load_type",
          "subtree", "phase_mask", "depth")
SCALARS = ("base_kva", "base_kv", "v_source_pu", "levels", "n_branches",
           "n_nodes", "z_base_ohm", "s_base_per_phase_kva")


def _assert_same_feeder(got, want):
    for k in ARRAYS:
        a, b = getattr(got, k), getattr(want, k)
        if b is None:
            assert a is None, k
            continue
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in SCALARS:
        assert getattr(got, k) == getattr(want, k), k


BUILDERS = {
    "vvc_9bus": lambda m: m.vvc_9bus(),
    "vvc_9bus_rpv": lambda m: m.vvc_9bus(rpv=0.4),
    "radial300": lambda m: m.synthetic_radial(300, seed=5),
    "radial5000": lambda m: m.synthetic_radial(5000, seed=6, pv_frac=0.1,
                                               load_kw=2.0),
    "trunk64": lambda m: m.synthetic_radial(64, seed=2, lateral_prob=0.0),
    "shallow64": lambda m: m.synthetic_radial(64, seed=3, lateral_prob=1.0),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_case_arrays_equal_reference(name):
    got, want = BUILDERS[name](cases), BUILDERS[name](ref_cases)
    _assert_same_feeder(got, want)
    if name == "radial5000":
        assert got.subtree is None  # above DENSE_MAX_BRANCHES


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_preorder_relabel_equals_reference(name):
    got, p_got = BUILDERS[name](cases).reorder_preorder()
    want, p_want = BUILDERS[name](ref_cases).reorder_preorder()
    np.testing.assert_array_equal(p_got, p_want)
    assert p_got.dtype == p_want.dtype
    _assert_same_feeder(got, want)
    # A preordered feeder returns itself.
    again, ident = got.reorder_preorder()
    assert again is got
    np.testing.assert_array_equal(ident, np.arange(got.n_branches))


def test_dl_table_equals_reference():
    path = resolve("Dl_new.mat", REF_DL_MAT)
    got, want = feeder.load_dl_mat(path), ref_feeder.load_dl_mat(path)
    assert got.n_branches == 33
    _assert_same_feeder(got, want)
    kw = dict(base_kva=500.0, base_kv=4.16, v_source_pu=1.0)
    _assert_same_feeder(
        feeder.load_dl_mat(path, z_codes=cases.default_z_codes(3), **kw),
        ref_feeder.load_dl_mat(path, z_codes=ref_cases.default_z_codes(3),
                               **kw))


def test_constants_and_conversions_equal_reference():
    assert feeder.DL_COLS == ref_feeder.DL_COLS
    assert feeder.z_base_ohm(12.47, 1000.0) == ref_feeder.z_base_ohm(
        12.47, 1000.0)
    np.testing.assert_array_equal(cases.Z_CODES_9BUS, ref_cases.Z_CODES_9BUS)
    for n in (1, 3, 7):
        np.testing.assert_array_equal(cases.default_z_codes(n),
                                      ref_cases.default_z_codes(n))
    f, rf = cases.vvc_9bus(), ref_cases.vvc_9bus()
    np.testing.assert_array_equal(f.to_dl(), rf.to_dl())
    np.testing.assert_array_equal(f.s_load_pu(), rf.s_load_pu())
    s = f.s_load * 0.7
    np.testing.assert_array_equal(f.s_load_pu(s), rf.s_load_pu(s))
    # The Dl round trip keeps the topology and the loads.
    z = np.stack([f.z_pu[i] * f.z_base_ohm for i in range(8)])
    f2 = feeder.from_branch_table(f.to_dl(), z)
    np.testing.assert_array_equal(f2.parent, f.parent)
    np.testing.assert_allclose(f2.s_load, f.s_load)


def test_out_of_order_rows_compile_like_reference():
    dl = np.zeros((3, 13))
    dl[0] = [1, 5, 7, 1, 1, 1, 10, 0, 10, 0, 10, 0, 0]  # child of node 5
    dl[1] = [2, 0, 5, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]  # root branch
    dl[2] = [3, 7, 9, 1, 1, 1, 5, 0, 5, 0, 5, 0, 0]  # grandchild
    got = feeder.from_branch_table(dl, cases.Z_CODES_9BUS)
    _assert_same_feeder(got, ref_feeder.from_branch_table(
        dl, ref_cases.Z_CODES_9BUS))
    assert got.depth.tolist() == [1, 0, 2]


def _bad_tables():
    dup = np.zeros((2, 13))
    dup[0] = [1, 0, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
    dup[1] = [2, 0, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
    unknown = np.zeros((1, 13))
    unknown[0] = [1, 7, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
    cycle = np.zeros((3, 13))
    cycle[0] = [1, 0, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
    cycle[1] = [2, 3, 2, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
    cycle[2] = [3, 2, 3, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
    return {"duplicate": (dup, "duplicate receiving bus"),
            "unknown_sbus": (unknown, "source bus"),
            "cycle": (cycle, "cycle or disconnected"),
            "columns": (np.zeros((2, 12)), r"Dl must be \[\*, 13\]")}


@pytest.mark.parametrize("kind", sorted(_bad_tables()))
def test_errors_equal_reference(kind):
    dl, match = _bad_tables()[kind]
    with pytest.raises(ValueError, match=match) as got:
        feeder.from_branch_table(dl, cases.Z_CODES_9BUS)
    with pytest.raises(ValueError) as want:
        ref_feeder.from_branch_table(dl, ref_cases.Z_CODES_9BUS)
    assert str(got.value) == str(want.value)


def test_bad_z_codes_rejected_like_reference():
    f = cases.vvc_9bus()
    with pytest.raises(ValueError, match="z_codes must be"):
        feeder.from_branch_table(f.to_dl(), np.ones((2, 3)))
