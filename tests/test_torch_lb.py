"""The port's load balancing (``freedm_tpu_torch.modules.lb``) against
``freedm_tpu.modules.lb``: ``lb_round`` and ``run_rounds`` — B1's plain
version on the CPU — equal to the reference on every field and every
round (the float fields too: sums of ±step), the pairwise oracle of
``tests/test_gm_sc_lb.py`` and the reference's LB contracts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freedm_tpu.modules import lb as ref
from freedm_tpu_torch.modules import lb
from test_gm_sc_lb import _pairwise_lb_round


def partition_mask(rng, n, n_groups):
    g = rng.integers(0, n_groups, n)
    return (g[:, None] == g[None, :]).astype(np.float32)


def assert_round_equal(want, got):
    for name, a, b in zip(ref.LBRound._fields, want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("gate", ["none", "scalar", "vector"])
@pytest.mark.parametrize("seed", [0, 1])
def test_lb_round_equals_reference(dtype, gate, seed):
    rng = np.random.default_rng(seed)
    n = 64
    mask = partition_mask(rng, n, rng.integers(1, 9))
    netgen = rng.normal(0, 10, n).astype(dtype)
    gw = rng.normal(0, 2, n).astype(dtype)
    mal = (rng.uniform(size=n) < 0.2).astype(np.float32)
    inv = {"none": None, "scalar": np.float32(1.0),
           "vector": (rng.uniform(size=n) < 0.8).astype(np.float32)}[gate]
    for step, m in ((1.0, mal), (0.3, None)):
        want = ref.lb_round(jnp.asarray(netgen), jnp.asarray(gw),
                            jnp.asarray(mask), step,
                            malicious=None if m is None else jnp.asarray(m),
                            invariant_ok=None if inv is None
                            else jnp.asarray(inv))
        got = lb.lb_round(netgen, gw, mask, step, malicious=m,
                          invariant_ok=inv, device="cpu")
        assert_round_equal(want, got)
        assert got.gateway.dtype == torch.from_numpy(gw).dtype


def test_lb_round_closed_gate_and_mixed_dtypes():
    rng = np.random.default_rng(5)
    n = 48
    mask = partition_mask(rng, n, 3)
    netgen = rng.normal(0, 10, n)  # float64 readings
    gw = rng.normal(0, 2, n).astype(np.float32)  # float32 gateway
    for inv in (np.float32(0.0), None):
        want = ref.lb_round(jnp.asarray(netgen), jnp.asarray(gw),
                            jnp.asarray(mask), 1.0,
                            invariant_ok=None if inv is None
                            else jnp.asarray(inv))
        got = lb.lb_round(netgen, gw, mask, 1.0, invariant_ok=inv,
                          device="cpu")
        assert_round_equal(want, got)
        assert got.gateway.dtype == torch.float32


@pytest.mark.parametrize("n,seed", [(48, 3), (64, 4), (64, 5)])
def test_run_rounds_trajectory_equals_reference(n, seed):
    rng = np.random.default_rng(seed)
    mask = partition_mask(rng, n, 4)
    netgen = rng.normal(0, 10, n).astype(np.float32)
    mal = (rng.uniform(size=n) < 0.1).astype(np.float32)
    for m in (None, mal):
        gw, migs, states = ref.run_rounds(
            jnp.asarray(netgen), jnp.zeros(n, jnp.float32), jnp.asarray(mask),
            1.0, 40, None if m is None else jnp.asarray(m))
        g2, m2, s2 = lb.run_rounds(netgen, np.zeros(n, np.float32), mask, 1.0,
                                   40, m, device="cpu")
        np.testing.assert_array_equal(np.asarray(migs), m2.numpy())
        np.testing.assert_array_equal(np.asarray(states), s2.numpy())
        np.testing.assert_array_equal(np.asarray(gw), g2.numpy())
    assert int(m2[-1]) == 0


def test_bench_lb_256_fleet_converges_like_reference():
    # bench.py bench_lb_256: N = 256, normal(0, 10), seed 0, 64 rounds.
    n = 256
    rng = np.random.default_rng(0)
    netgen = rng.normal(0, 10, n)
    gw, migs, states = ref.run_rounds(jnp.asarray(netgen), jnp.zeros(n),
                                      jnp.ones((n, n)), 1.0, 64)
    g2, m2, s2 = lb.run_rounds(netgen, np.zeros(n), np.ones((n, n)), 1.0, 64,
                               device="cpu")
    np.testing.assert_array_equal(np.asarray(migs), m2.numpy())
    np.testing.assert_array_equal(np.asarray(states), s2.numpy())
    np.testing.assert_array_equal(np.asarray(gw), g2.numpy())
    assert int(m2[-1]) == 0  # converged within the budget


def test_fleet_axis_equals_per_fleet_rounds():
    rng = np.random.default_rng(9)
    b, n = 3, 40
    netgen = rng.normal(0, 10, (b, n)).astype(np.float32)
    masks = np.stack([partition_mask(rng, n, 3) for _ in range(b)])
    gw, migs, states = lb.run_rounds(netgen, np.zeros((b, n), np.float32),
                                     masks, 1.0, 20, device="cpu")
    assert gw.shape == (b, n) and migs.shape == (b, 20)
    for k in range(b):
        want = ref.run_rounds(jnp.asarray(netgen[k]), jnp.zeros(n, jnp.float32),
                              jnp.asarray(masks[k]), 1.0, 20)
        for a, c in zip(want, (gw[k], migs[k], states[k])):
            np.testing.assert_array_equal(np.asarray(a), c.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_round_matches_pairwise_oracle(seed):
    rng = np.random.default_rng(seed)
    n = 64
    mask = partition_mask(rng, n, rng.integers(1, 9))
    netgen = rng.normal(0, 10, n).astype(np.float32)
    gw = rng.normal(0, 2, n).astype(np.float32)
    mal = (rng.uniform(size=n) < 0.2).astype(np.float32)
    got = lb.lb_round(netgen, gw, mask, 1.0, malicious=mal, device="cpu")
    want = _pairwise_lb_round(jnp.asarray(netgen), jnp.asarray(gw),
                              jnp.asarray(mask), 1.0,
                              malicious=jnp.asarray(mal))
    np.testing.assert_array_equal(np.asarray(want.state), got.state.numpy())
    np.testing.assert_array_equal(np.asarray(want.matched),
                                  got.matched.numpy())
    for name in ("gateway", "supply_step", "demand_step", "intransit"):
        np.testing.assert_allclose(np.asarray(getattr(want, name)),
                                   getattr(got, name).numpy(), atol=1e-5)
    assert int(want.n_migrations) == int(got.n_migrations)


def test_group_rank_oracle_equals_reference():
    rng = np.random.default_rng(11)
    n = 20
    key = np.round(rng.normal(0, 3, n)).astype(np.float32)  # ties
    member = (rng.uniform(size=n) < 0.7).astype(np.float32)
    mask = partition_mask(rng, n, 3)
    want = ref._group_rank(jnp.asarray(key), jnp.asarray(member),
                           jnp.asarray(mask))
    got = lb._group_rank(torch.as_tensor(key), torch.as_tensor(member),
                         torch.as_tensor(mask))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_classify_group_ids_and_synchronize_equal_reference():
    rng = np.random.default_rng(12)
    n = 30
    ng = rng.normal(0, 3, n).astype(np.float32)
    gw = rng.normal(0, 3, n).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(ref.classify(jnp.asarray(ng), jnp.asarray(gw), 0.7)),
        lb.classify(torch.as_tensor(ng), torch.as_tensor(gw), 0.7).numpy())
    mask = partition_mask(rng, n, 5)
    mask[3, 3] = 0.0  # a node is always in its own group
    np.testing.assert_array_equal(np.asarray(ref.group_ids(jnp.asarray(mask))),
                                  lb.group_ids(torch.as_tensor(mask)).numpy())
    total = rng.normal(0, 5, n).astype(np.float32)
    members = rng.integers(0, 4, n).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(ref.synchronize(jnp.asarray(gw), jnp.asarray(total),
                                   jnp.asarray(members))),
        lb.synchronize(torch.as_tensor(gw), torch.as_tensor(total),
                       torch.as_tensor(members)).numpy())


def full_mesh(n):
    return np.ones((n, n), np.float32)


def test_three_node_convergence():
    gw, migs, states = lb.run_rounds(np.asarray([10.0, -10.0, 0.0]),
                                     np.zeros(3), full_mesh(3), 1.0, 15,
                                     device="cpu")
    migs = migs.numpy()
    assert migs[:10].min() >= 1 and migs[-1] == 0
    np.testing.assert_allclose(gw.numpy(), [10.0, -10.0, 0.0], atol=1e-6)
    assert (states[-1] == lb.NORMAL).all()


def test_total_gateway_conserved_honest():
    rng = np.random.default_rng(0)
    gw, _, _ = lb.run_rounds(rng.normal(0, 5, 8), np.zeros(8), full_mesh(8),
                             0.5, 30, device="cpu")
    assert float(gw.sum()) == pytest.approx(0.0, abs=1e-5)


def test_matching_respects_groups():
    group = np.zeros((4, 4))
    group[:2, :2] = 1
    group[2:, 2:] = 1
    out = lb.lb_round(np.asarray([5.0, 0.0, -5.0, 0.0]), np.zeros(4), group,
                      1.0, device="cpu")
    assert int(out.n_migrations) == 0
    np.testing.assert_allclose(out.gateway.numpy(), np.zeros(4), atol=1e-7)


def test_rank_matching_pairs_distinct_partners():
    out = lb.lb_round(np.asarray([4.0, 3.0, -5.0, -2.0]), np.zeros(4),
                      full_mesh(4), 1.0, device="cpu")
    m = out.matched.numpy()
    assert int(out.n_migrations) == 2
    assert m[:, 2].sum() == 1 and m[:, 3].sum() == 1
    assert m[0, 2] == 1 and m[1, 3] == 1


def test_malicious_node_breaks_conservation_but_ledger_accounts():
    out = lb.lb_round(np.asarray([5.0, -5.0, 0.0]), np.zeros(3), full_mesh(3),
                      1.0, malicious=np.asarray([0.0, 1.0, 0.0]),
                      device="cpu")
    assert float(out.gateway.sum()) == pytest.approx(1.0)
    assert float(out.gateway.sum() + out.intransit.sum()) == pytest.approx(0.0)


def test_invariant_gate_blocks_migrations():
    out = lb.lb_round(np.asarray([5.0, -5.0]), np.zeros(2), full_mesh(2), 1.0,
                      invariant_ok=np.zeros(()), device="cpu")
    assert int(out.n_migrations) == 0
    assert int(out.state[0]) == lb.SUPPLY


def test_b1_plain_round_at_2_15_nodes_equals_reference():
    """At 2^15 nodes, where the reference takes its unpacked branch and B1
    its WIDE form, B1's plain route (``dk.lb_rounds`` on CPU tensors) equals
    the reference's jitted ``lb_round(..., gid=gid)``; neither builds the
    ``[N, N]`` mask or ``matched`` matrix (4 GB at this size), so the entry
    points that do are held at 2^15 on the card."""
    import jax

    from freedm_tpu_torch.kernels import dgi_kernels as dk

    n = 1 << 15
    rng = np.random.default_rng(15)
    netgen = rng.normal(0, 10, n)
    gw = rng.normal(0, 2, n)
    gid = (np.arange(n) // 512 * 512).astype(np.int32)
    want = jax.jit(lambda a, b, c: (lambda r: (r.gateway, r.state,
                                               r.n_migrations))(
        ref.lb_round(a, b, None, 1.0, gid=c)))(
        jnp.asarray(netgen), jnp.asarray(gw), jnp.asarray(gid))
    got = dk.lb_rounds(torch.from_numpy(netgen)[None],
                       torch.from_numpy(gw)[None],
                       torch.from_numpy(gid)[None], 1.0, 1,
                       round_outputs=True)
    np.testing.assert_array_equal(got.gateway[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got.states[0, 0].numpy(),
                                  np.asarray(want[1]))
    assert int(got.migrations[0, 0]) == int(want[2]) > 0
