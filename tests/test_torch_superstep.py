"""The port's one-card superstep (``freedm_tpu_torch.parallel``) against
``freedm_tpu.parallel.superstep.make_superstep`` on a one-device mesh:
one state built in numpy and handed to both; groups and the LB round
equal, the snapshot within 1e-5 relative, the VVC leg (the port's float32
ladder against the reference's) within 1e-4 relative in loss and 1e-3
kvar in q."""

import jax
import numpy as np
import pytest
import torch

from freedm_tpu.grid import cases as ref_cases
from freedm_tpu.parallel.mesh import make_mesh
from freedm_tpu.parallel.superstep import make_superstep as ref_superstep
from freedm_tpu_torch.cplx import C
from freedm_tpu_torch.grid import cases
from freedm_tpu_torch.parallel import FleetState, SuperstepOut, make_superstep

N, B = 8, 4


def host_state(seed=0):
    rng = np.random.default_rng(seed)
    netgen = rng.normal(0, 5, N)
    scales = np.linspace(0.8, 1.2, B)
    alive = np.ones(N)
    alive[5] = 0.0
    reach = np.ones((N, N))
    reach[:3, 3:] = reach[3:, :3] = 0.0  # two groups
    return netgen, np.zeros(N), scales, alive, reach


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(1, axes=("nodes", "batch"))


def rel(a, b, floor=1.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), floor)))


def assert_out_close(want, got, q_atol=1e-3):
    for name, a, b in zip(want.group._fields, want.group, got.group):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    for name, a, b in zip(want.lb_out._fields, want.lb_out, got.lb_out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    for name, a, b in zip(want.collected._fields, want.collected,
                          got.collected):
        if name == "members":
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        else:
            assert rel(b.numpy(), a) <= 1e-5, name
    assert rel(got.vvc_loss.numpy(), want.vvc_loss, floor=1e-30) <= 1e-4
    if q_atol is not None:
        np.testing.assert_allclose(got.state.q_ctrl.numpy(),
                                   np.asarray(want.state.q_ctrl), atol=q_atol)
    np.testing.assert_array_equal(got.state.gateway.numpy(),
                                  np.asarray(want.state.gateway))


def to_port(s) -> FleetState:
    """A reference state as the port's (float32 tensors on the CPU)."""
    t = lambda x: torch.as_tensor(np.array(x), dtype=torch.float32)  # noqa: E731
    return FleetState(alive=t(s.alive), reachable=t(s.reachable),
                      netgen=t(s.netgen), gateway=t(s.gateway),
                      s_load=C(t(s.s_load.re), t(s.s_load.im)),
                      q_ctrl=t(s.q_ctrl))


def test_superstep_equals_reference(mesh1):
    ref_step, ref_shard = ref_superstep(mesh1, ref_cases.vvc_9bus(),
                                        migration_step=1.0)
    step, shard = make_superstep(feeder=cases.vvc_9bus(), migration_step=1.0,
                                 device="cpu")
    host = host_state()
    rs, st = ref_shard(*host), shard(*host)
    assert isinstance(st, FleetState)
    assert st.s_load.re.dtype == torch.float32 and st.q_ctrl.shape == (B, 8, 3)
    want, got = ref_step(rs), step(st)
    assert isinstance(got, SuperstepOut)
    assert_out_close(want, got)
    # Two more rounds, each package from the reference's state.  The
    # step's loss change here is ~1e-6 relative, below float32's
    # resolution: the port's float32 backtracking can accept another step
    # size than the reference's float64 one (measured: q ~1e-3 kvar
    # apart from identical states), so q is held to the loss alone.
    for _ in range(2):
        rs = want.state
        want, got = ref_step(rs), step(to_port(rs))
        assert_out_close(want, got, q_atol=None)
    # Gated round: invariant_ok blocks every migration.
    want, got = (ref_step(want.state, np.float32(0.0)),
                 step(to_port(want.state), np.float32(0.0)))
    assert_out_close(want, got, q_atol=None)
    assert int(got.lb_out.n_migrations) == 0


def test_iterated_superstep_converges_lb():
    step, shard = make_superstep(feeder=cases.vvc_9bus(), device="cpu")
    rng = np.random.default_rng(0)
    st = shard(rng.normal(0, 5, N), np.zeros(N), np.linspace(0.8, 1.2, B))
    phases = []
    out = step(st, record=phases.append)
    assert phases == ["gm", "lb", "sc", "vvc"]
    assert out.vvc_loss.shape == (B,) and bool(torch.isfinite(
        out.vvc_loss).all())
    st = out.state
    for _ in range(30):
        out = step(st)
        st = out.state
    assert int(out.lb_out.n_migrations) == 0


def test_superstep_without_feeder_equals_reference(mesh1):
    ref_step, ref_shard = ref_superstep(mesh1, None)
    step, shard = make_superstep(device="cpu")
    host = host_state(1)
    want, got = ref_step(ref_shard(*host)), step(shard(*host))
    assert got.state.s_load.re.shape == (B, 1, 3)
    assert torch.equal(got.vvc_loss, torch.zeros(B))
    assert_out_close(want, got)


def test_a_mesh_of_more_than_one_device_raises():
    with pytest.raises(NotImplementedError, match="item 16"):
        make_superstep(4, device="cpu")
    if len(jax.devices()) >= 2:
        with pytest.raises(NotImplementedError, match="item 16"):
            make_superstep(make_mesh(2), device="cpu")
    make_superstep(make_mesh(1), device="cpu")  # one device: the card
