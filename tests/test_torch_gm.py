"""The port's group management (``freedm_tpu_torch.modules.gm``) against
``freedm_tpu.modules.gm``: ``form_groups`` — G1's plain version on the
CPU — equal to the reference's outputs field for field, and the
reference's GM contracts (``tests/test_gm_sc_lb.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freedm_tpu.modules import gm as ref
from freedm_tpu_torch.modules import gm


def assert_groups_equal(want, got):
    for name, a, b in zip(ref.GroupState._fields, want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


def random_graph(rng, n, chain=False):
    """Sparse symmetric reachability: a random path per group plus chords,
    or one path through every node (diameter n)."""
    reach = np.zeros((n, n), np.float32)
    groups = (np.zeros(n, int) if chain
              else rng.integers(0, max(1, n // 6), n))
    for g in np.unique(groups):
        m = rng.permutation(np.nonzero(groups == g)[0])
        reach[m[:-1], m[1:]] = 1.0
        if not chain and len(m) > 3:
            a, b = rng.choice(m, (2, len(m) // 3))
            reach[a, b] = 1.0
    return np.maximum(reach, reach.T)


@pytest.mark.parametrize("n", [1, 2, 3, 17, 64])
@pytest.mark.parametrize("kind", ["partition", "chain", "dead", "raw"])
def test_form_groups_equals_reference(n, kind):
    rng = np.random.default_rng(n)
    if kind == "partition":
        g = rng.integers(0, 4, n)
        reach = (g[:, None] == g[None, :]).astype(np.float32)
    else:
        reach = random_graph(rng, n, chain=kind == "chain")
    alive = np.ones(n, np.float32)
    if kind in ("dead", "raw"):
        alive = (rng.uniform(size=n) > 0.25).astype(np.float32)
    prio = None
    if kind == "raw":  # raw 2^31-magnitude hashes, rank-compressed inside
        prio = (np.uint64(2 ** 31) + rng.permutation(n).astype(np.uint64)
                * 3).astype(np.float64)
    want = ref.form_groups(jnp.asarray(alive), jnp.asarray(reach),
                           None if prio is None else jnp.asarray(prio))
    got = gm.form_groups(alive, reach, prio, device="cpu")
    assert_groups_equal(want, got)


@pytest.mark.parametrize("n", [3, 17, 64])
def test_batched_alive_equals_vmap(n):
    rng = np.random.default_rng(7 + n)
    reach = random_graph(rng, n)
    alive = (rng.uniform(size=(5, n)) > 0.2).astype(np.float32)
    alive[0] = 1.0
    want = jax.vmap(lambda a: ref.form_groups(a, jnp.asarray(reach)))(
        jnp.asarray(alive))
    got = gm.form_groups(alive, reach, device="cpu")
    assert got.coordinator.shape == (5, n) and got.n_groups.shape == (5,)
    assert_groups_equal(want, got)
    # A reachability a lane: [B, N, N].
    reaches = np.stack([random_graph(np.random.default_rng(k), n)
                        for k in range(5)])
    want = jax.vmap(ref.form_groups)(jnp.asarray(alive), jnp.asarray(reaches))
    assert_groups_equal(want, gm.form_groups(alive, reaches, device="cpu"))


def test_node_priority_matches_reference():
    for n in (1, 5, 64, 1000):
        np.testing.assert_array_equal(ref.node_priority(n), gm.node_priority(n))
        np.testing.assert_array_equal(ref.node_priority(n, salt=7),
                                      gm.node_priority(n, salt=7))


def test_diff_counters_equals_reference():
    rng = np.random.default_rng(3)
    n = 24
    reach = random_graph(rng, n)
    alive0 = np.ones(n, np.float32)
    alive1 = (rng.uniform(size=n) > 0.3).astype(np.float32)
    r0, r1 = (ref.form_groups(jnp.asarray(a), jnp.asarray(reach))
              for a in (alive0, alive1))
    p0, p1 = (gm.form_groups(a, reach, device="cpu") for a in (alive0, alive1))
    for want, got in ((ref.diff_counters(r0, r1), gm.diff_counters(p0, p1)),
                      (ref.diff_counters(r1, r0), gm.diff_counters(p1, p0))):
        for a, b in zip(want, got):
            assert int(a) == int(b)


def full_mesh(n):
    return np.ones((n, n), np.float32)


def test_single_group_elects_max_priority():
    n = 8
    g = gm.form_groups(np.ones(n), full_mesh(n), device="cpu")
    want = int(np.argmax(gm.node_priority(n)))
    assert int(g.n_groups) == 1
    assert (g.coordinator == want).all()
    assert bool(g.is_coordinator[want])
    assert (g.group_size == n).all()


def test_partition_forms_two_groups():
    n = 6
    reach = np.zeros((n, n))
    reach[:3, :3] = 1
    reach[3:, 3:] = 1
    g = gm.form_groups(np.ones(n), reach, device="cpu")
    prio = gm.node_priority(n)
    c = g.coordinator.numpy()
    assert int(g.n_groups) == 2
    assert len(set(c[:3])) == 1 and len(set(c[3:])) == 1
    assert c[0] == np.argmax(prio[:3]) and c[3] == 3 + np.argmax(prio[3:])
    assert float(g.group_mask[:3, 3:].sum()) == 0.0


def test_chain_diameter_converges():
    n = 16
    reach = np.zeros((n, n))
    for i in range(n - 1):
        reach[i, i + 1] = reach[i + 1, i] = 1
    g = gm.form_groups(np.ones(n), reach, device="cpu")
    assert int(g.n_groups) == 1
    assert len(set(g.coordinator.tolist())) == 1


def test_dead_node_excluded_and_counters():
    n = 5
    g0 = gm.form_groups(np.ones(n), full_mesh(n), device="cpu")
    leader = int(g0.coordinator[0])
    alive = np.ones(n)
    alive[leader] = 0.0
    g1 = gm.form_groups(alive, full_mesh(n), device="cpu")
    assert int(g1.coordinator[leader]) == -1
    c = g1.coordinator.numpy()
    live = [i for i in range(n) if i != leader]
    assert len(set(c[live])) == 1 and c[live[0]] != leader
    counters = gm.diff_counters(g0, g1)
    assert int(counters.elections) == 1
    assert int(counters.groups_broken) > 0


def test_election_is_batchable():
    n = 6
    alive = np.ones((2, n))
    alive[1, 0] = 0.0
    out = gm.form_groups(alive, full_mesh(n), device="cpu")
    assert out.coordinator.shape == (2, n)
    assert out.coordinator.dtype == torch.int32
    assert out.group_mask.dtype == torch.float32
    assert out.is_coordinator.dtype == torch.bool


def test_form_groups_with_raw_hash_priorities():
    n = 6
    prio = (np.uint64(2 ** 31) + np.arange(n, dtype=np.uint64) * 3).astype(
        np.float64)
    g = gm.form_groups(np.ones(n), np.ones((n, n)), prio, device="cpu")
    assert int(g.n_groups) == 1
    assert g.coordinator.tolist() == [n - 1] * n
