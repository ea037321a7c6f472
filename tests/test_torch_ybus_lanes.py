"""Parity of the port's per-lane Ybus stamp (Y1's plain version) with the
JAX package's ``ybus_dense(sys, status)`` and ``decoupled_parts``.

Y1's plain version stamps in the reference's scatter order (ff, tt, ft,
tf, then the shunt diagonal), so on the CPU it is held to 1e-14 absolute
in all three modes — for each lane, on case14, case_ieee30 and mesh118,
with parallel branches added and a lane with every branch in service.
The ``cuda``-marked test holds the kernel to its plain version on the
card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freedm_tpu.grid import cases as ref_cases
from freedm_tpu.grid.bus import BusSystem as RefBusSystem
from freedm_tpu.grid.bus import ybus_dense as ref_ybus_dense
from freedm_tpu.grid.matpower import load_builtin as ref_load_builtin
from freedm_tpu.pf.fdlf import decoupled_parts as ref_decoupled_parts
from freedm_tpu_torch.grid.bus import BusSystem, stamp_operands, ybus_lanes
from freedm_tpu_torch.kernels import solver_kernels as sol

ATOL = 1e-14
LANES = 4


def _with_parallel_branches(ref):
    """The case with its first three branches doubled (a parallel circuit
    of other impedance each), so entries sum more than one branch."""
    fields = dataclasses.asdict(ref)
    for name in ("from_bus", "to_bus", "r", "x", "b_chg", "tap", "shift"):
        extra = np.asarray(fields[name])[:3]
        if name in ("r", "x"):
            extra = extra * np.array([1.3, 0.7, 2.0])
        fields[name] = np.concatenate([np.asarray(fields[name]), extra])
    return RefBusSystem(**fields)


def _case(name):
    if name == "mesh118":
        return ref_cases.synthetic_mesh(118, seed=1, load_mw=10.0,
                                        chord_frac=1.0)
    return ref_load_builtin(name)


@pytest.fixture(scope="module", params=["case14", "case_ieee30", "mesh118"])
def systems(request):
    ref = _with_parallel_branches(_case(request.param))
    port = BusSystem.from_arrays(dataclasses.asdict(ref))
    rng = np.random.default_rng(5)
    st = (rng.random((LANES, port.n_branch)) > 0.15).astype(np.float64)
    st[0] = 1.0  # every branch in service
    st[1, :3] = 0.0  # a circuit of each doubled pair out
    return ref, port, st


def test_ybus_mode_matches_reference_per_lane(systems):
    ref, port, st = systems
    op = stamp_operands(port, device="cpu")
    y_re, y_im = sol.ybus_stamp(sol.YBUS, op, torch.as_tensor(st))
    assert y_re.shape == (LANES, port.n_bus, port.n_bus)
    for b in range(LANES):
        want = ref_ybus_dense(ref, status=jnp.asarray(st[b]),
                              dtype=jnp.float64)
        np.testing.assert_allclose(y_re[b].numpy(), np.asarray(want.re),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(y_im[b].numpy(), np.asarray(want.im),
                                   rtol=0, atol=ATOL)


def test_bprime_and_bdblprime_modes_match_reference_per_lane(systems):
    ref, port, st = systems
    op = stamp_operands(port, device="cpu")
    parts = ref_decoupled_parts(ref, jnp.float64)
    b_p = sol.ybus_stamp(sol.BPRIME, op, torch.as_tensor(st))
    b_q = sol.ybus_stamp(sol.BDBL, op, torch.as_tensor(st))
    for b in range(LANES):
        lane = jnp.asarray(st[b])
        np.testing.assert_allclose(b_p[b].numpy(),
                                   np.asarray(parts.b_prime(lane)),
                                   rtol=0, atol=ATOL)
        y = ref_ybus_dense(ref, status=lane, dtype=jnp.float64)
        np.testing.assert_allclose(b_q[b].numpy(),
                                   np.asarray(parts.b_dblprime(y)),
                                   rtol=0, atol=ATOL)


def test_all_in_service_lane_is_the_host_stamp_bit_for_bit(systems):
    """Lane 0 (every branch in service) equals the engines' host stamp."""
    _, port, st = systems
    y = ybus_lanes(port, st, device="cpu")
    host = ybus_lanes(port, None, device="cpu")
    assert torch.equal(y[0][0], host[0]) and torch.equal(y[1][0], host[1])
    assert host[0].shape == (port.n_bus, port.n_bus)


def test_shared_status_stamps_once_with_lane_stride_zero(systems):
    """A shared ``[m]`` status gives one ``[n, n]`` stamp, which K1/K2
    read for every lane with a lane stride of 0."""
    _, port, st = systems
    y = ybus_lanes(port, st[2], device="cpu")
    assert y[0].shape == (port.n_bus, port.n_bus)
    lane = ybus_lanes(port, st[2:3], device="cpu")
    assert torch.equal(y[0], lane[0][0]) and torch.equal(y[1], lane[1][0])
    with pytest.raises(ValueError, match="status must be"):
        ybus_lanes(port, st[:, :-1], device="cpu")


def test_plain_version_is_float32_where_asked(systems):
    ref, port, st = systems
    op = stamp_operands(port, dtype=torch.float32, device="cpu")
    y_re, _ = sol.ybus_stamp(sol.YBUS, op, torch.as_tensor(st).float())
    assert y_re.dtype == torch.float32
    want = ref_ybus_dense(ref, status=jnp.asarray(st[3]), dtype=jnp.float64)
    scale = float(np.abs(np.asarray(want.re)).max())
    np.testing.assert_allclose(y_re[3].numpy(), np.asarray(want.re),
                               rtol=0, atol=1e-6 * scale)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_stamp_kernel_matches_plain_version_on_card(cuda_device):
    ref = _with_parallel_branches(_case("mesh118"))
    port = BusSystem.from_arrays(dataclasses.asdict(ref))
    rng = np.random.default_rng(6)
    for dtype, atol in ((torch.float64, 1e-10), (torch.float32, 1e-3)):
        op = stamp_operands(port, dtype=dtype, device=cuda_device)
        st = torch.as_tensor(rng.random((7, port.n_branch)) > 0.2,
                             dtype=dtype, device=cuda_device)
        before = sol.launches()["ybus_stamp"]
        for mode in (sol.YBUS, sol.BPRIME, sol.BDBL):
            k = sol.ybus_stamp(mode, op, st)
            again = sol.ybus_stamp(mode, op, st)
            p = sol.ybus_stamp_plain(mode, op, st)
            k, again, p = ((t,) if mode != sol.YBUS else t
                           for t in (k, again, p))
            for a, b, c in zip(k, again, p):
                assert torch.equal(a, b)
                assert float((a - c).abs().max()) <= atol
        torch.cuda.synchronize()
        assert sol.launches()["ybus_stamp"] == before + 6
