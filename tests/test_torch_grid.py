"""Parity of the PyTorch port's grid data model with the JAX package.

The same networks go through ``freedm_tpu.grid`` and
``freedm_tpu_torch.grid``: the Ybus must agree to 1e-15 (the port stamps
on the host in the reference's order with its pair arithmetic, so the
values are in fact identical), the seeded synthetic meshes must be
bit-identical, and the MATPOWER parser must build the same fields.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freedm_tpu.grid import cases as ref_cases
from freedm_tpu.grid import matpower as ref_matpower
from freedm_tpu.grid.bus import ybus_dense as ref_ybus_dense
from freedm_tpu_torch.grid import cases, matpower
from freedm_tpu_torch.grid.bus import PQ, PV, SLACK, BusSystem, ybus_dense, ybus_pair

CASE4 = """
function mpc = case4
mpc.version = '2';
mpc.baseMVA = 100;
mpc.bus = [
  1 3 0   0  0 0 1 1.00 0 230 1 1.1 0.9;
  2 2 0   0  0 0 1 1.00 0 230 1 1.1 0.9;
  3 2 90  30 0 0 1 1.00 0 230 1 1.1 0.9; % PV on paper, but its only unit is off
  4 1 50  10 0 5 1 1.00 0 230 1 1.1 0.9;
];
mpc.gen = [
  1 0  0 300 -300 1.02 100 1 250 10;
  2 80 0 300 -300 1.03 100 1 250 10;
  3 10 5 300 -300 1.00 100 0 250 10; % out of service
];
mpc.branch = [
  1 2 0.01 0.06 0.02 250 250 250 0    0  1 -360 360;
  1 3 0.02 0.08 0.01 250 250 250 0    0  1 -360 360;
  2 4 0.01 0.05 0.02 250 250 250 0.98 2  1 -360 360;
  3 4 0.03 0.09 0.00 250 250 250 0    0  0 -360 360; % out of service
];
"""

FIELDS = [f.name for f in dataclasses.fields(BusSystem)]


def _pair(name):
    """The same case from both packages."""
    if name.startswith("mesh"):
        n = int(name[4:])
        return ref_cases.synthetic_mesh(n), cases.synthetic_mesh(n)
    return ref_matpower.load_builtin(name), matpower.load_builtin(name)


def _assert_same_system(got, want):
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        if k == "base_mva":
            assert a == b
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
            assert np.asarray(a).dtype == np.asarray(b).dtype, k


@pytest.mark.parametrize("name", ["case14", "case_ieee30", "mesh118"])
def test_ybus_matches_reference(name):
    ref, port = _pair(name)
    want = ref_ybus_dense(ref, dtype=jnp.float64)
    y_re, y_im = ybus_dense(port, dtype=torch.float64, device="cpu")
    assert y_re.dtype == torch.float64 and y_re.device.type == "cpu"
    assert y_re.shape == (port.n_bus, port.n_bus)
    np.testing.assert_allclose(y_re.numpy(), np.asarray(want.re),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(y_im.numpy(), np.asarray(want.im),
                               rtol=0, atol=1e-15)


def test_ybus_with_branch_status_matches_reference():
    ref, port = _pair("case_ieee30")
    status = np.random.default_rng(4).uniform(size=ref.n_branch) > 0.2
    want = ref_ybus_dense(ref, status=jnp.asarray(status, jnp.float64),
                          dtype=jnp.float64)
    y_re, y_im = ybus_pair(port, status=status)
    np.testing.assert_allclose(y_re, np.asarray(want.re), rtol=0, atol=1e-15)
    np.testing.assert_allclose(y_im, np.asarray(want.im), rtol=0, atol=1e-15)
    with pytest.raises(ValueError, match="status"):
        ybus_pair(port, status=status[:-1])


@pytest.mark.parametrize("n,seed,kw", [
    (5, 0, {}),
    (40, 9, {}),
    (118, 1, {"load_mw": 10.0, "chord_frac": 1.0}),
    (300, 3, {"pv_frac": 0.4, "chord_frac": 0.5}),
])
def test_synthetic_mesh_bit_identical(n, seed, kw):
    _assert_same_system(cases.synthetic_mesh(n, seed=seed, **kw),
                        ref_cases.synthetic_mesh(n, seed=seed, **kw))


def test_matpower_parser_case4_field_by_field():
    want = ref_matpower.from_mpc(ref_matpower.parse_case_text(CASE4))
    got = matpower.from_mpc(matpower.parse_case_text(CASE4))
    _assert_same_system(got, want)
    # The reference test's own pins (tests/test_newton.py::test_matpower_parser).
    assert got.n_bus == 4
    assert got.n_branch == 3  # out-of-service branch dropped
    assert got.bus_type[0] == SLACK and got.bus_type[1] == PV
    assert got.bus_type[2] == PQ  # PV bus with no live unit degrades to PQ
    assert got.p_inj[1] == pytest.approx(0.8)
    assert got.p_inj[2] == pytest.approx(-0.9)
    assert got.v_set[0] == pytest.approx(1.02)
    assert got.v_set[1] == pytest.approx(1.03)
    assert got.b_shunt[3] == pytest.approx(0.05)
    assert got.tap[2] == pytest.approx(0.98)
    assert got.shift[2] == pytest.approx(np.deg2rad(2))


def test_builtin_cases_and_solved_states_match_reference():
    assert matpower.builtin_case_names() == ref_matpower.builtin_case_names()
    for name in matpower.builtin_case_names():
        ref, port = _pair(name)
        _assert_same_system(port, ref)
        for a, b in zip(matpower.builtin_solved_state(name),
                        ref_matpower.builtin_solved_state(name)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError):
        matpower.load_builtin("case9999")


@pytest.mark.parametrize("name", ["case14", "mesh118"])
def test_from_arrays_round_trips_reference_system(name):
    ref, _ = _pair(name)
    got = BusSystem.from_arrays(dataclasses.asdict(ref))
    _assert_same_system(got, ref)
    assert BusSystem.from_arrays(dataclasses.asdict(ref),
                                 base_mva=50.0).base_mva == 50.0
    fields = dataclasses.asdict(ref)
    with pytest.raises(ValueError, match="unknown"):
        BusSystem.from_arrays({**fields, "bogus": np.zeros(3)})
    fields.pop("r")
    with pytest.raises(ValueError, match="missing"):
        BusSystem.from_arrays(fields)
