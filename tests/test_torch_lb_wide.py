"""The LB round at 2¹⁵ nodes and more — where the reference takes its
unpacked branch (``freedm_tpu/modules/lb.py`` :178-189) and B1 its WIDE
form — on the CPU: B1's plain route through the wrapper
``dk.lb_rounds`` on CPU tensors against the reference's own ``lb_round(...,
gid=gid)`` under ``jax.jit``, at N = 2¹⁵ and 40,961 (the sort pads to
2¹⁶), 2 fleets × 8 rounds and single rounds with ``round_outputs``:
integers equal, gateways bit for bit.

The reference's jitted round returns only the gateway, the states and the
migrations, so that XLA drops its ``[N, N]`` ``matched`` matrix (4 GB in
float32 at 2¹⁵).  For the same reason no test here calls ``lb.lb_round``,
``lb.run_rounds`` or either package's ``run_rounds`` at these sizes: they
build ``[N, N]`` temporaries (``group_ids``' ``where``, ``lb_round``'s
``matched``).  Those entry points run at 2¹⁵ on the card
(``tests/test_torch_dgi_cuda.py``, ``chip_smoke.py`` phase 28)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freedm_tpu.modules import lb as ref
from freedm_tpu_torch.kernels import dgi_kernels as dk

STEP = 1.0
ROUNDS = 8


def fleets(n, count, dtype, seed):
    """``count`` fleets of ``n`` nodes: readings ``normal(0, 10)``, a
    gateway ``normal(0, 2)``, random groups (their smallest members as
    ids) in the first fleet and 512-node blocks in the others."""
    rng = np.random.default_rng(seed)
    gids = []
    for k in range(count):
        g = rng.integers(0, n // 64 + 1, n) if k == 0 else np.arange(n) // 512
        labels, first = np.unique(g, return_index=True)
        gids.append(first[np.searchsorted(labels, g)].astype(np.int32))
    ng = rng.normal(0, 10, (count, n)).astype(dtype)
    gw = rng.normal(0, 2, (count, n)).astype(dtype)
    mal = (rng.uniform(size=(count, n)) < 0.1).astype(np.float32)
    return ng, gw, np.stack(gids), mal


@jax.jit
def _ref_round(ng, gw, gid, mal):
    r = ref.lb_round(ng, gw, None, STEP, malicious=mal, gid=gid)
    return r.gateway, r.state, r.n_migrations


@jax.jit
def _ref_round_honest(ng, gw, gid):
    r = ref.lb_round(ng, gw, None, STEP, gid=gid)
    return r.gateway, r.state, r.n_migrations


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [1 << 15, 40961])
def test_b1_plain_rounds_match_reference_past_2_15(n, dtype):
    assert dk.lb_form(n, np.dtype(dtype).itemsize) == dk.CLUSTER
    ng, gw, gid, _ = fleets(n, 2, dtype, seed=n % 7)
    got = dk.lb_rounds(torch.from_numpy(ng), torch.from_numpy(gw),
                       torch.from_numpy(gid), STEP, ROUNDS)
    for k in range(2):
        g = jnp.asarray(gw[k])
        for r in range(ROUNDS):
            g, state, migs = _ref_round_honest(jnp.asarray(ng[k]), g,
                                               jnp.asarray(gid[k]))
            np.testing.assert_array_equal(got.states[k, r].numpy(),
                                          np.asarray(state))
            assert int(got.migrations[k, r]) == int(migs)
        np.testing.assert_array_equal(got.gateway[k].numpy(), np.asarray(g))
    assert int(got.migrations[:, 0].min()) > 0


@pytest.mark.parametrize("n", [1 << 15, 40961])
def test_b1_plain_single_round_outputs_past_2_15(n):
    ng, gw, gid, mal = fleets(n, 2, np.float64, seed=3)
    got = dk.lb_rounds(torch.from_numpy(ng), torch.from_numpy(gw),
                       torch.from_numpy(gid), STEP, 1,
                       malicious=torch.from_numpy(mal), round_outputs=True)
    for k in range(2):
        g, state, migs = _ref_round(*(jnp.asarray(a[k])
                                      for a in (ng, gw, gid, mal)))
        np.testing.assert_array_equal(got.gateway[k].numpy(), np.asarray(g))
        np.testing.assert_array_equal(got.states[k, 0].numpy(),
                                      np.asarray(state))
        assert int(got.migrations[k, 0]) == int(migs)
        assert int(migs) > 0
        assert got.rank[k].max() == n  # non-members rank N


# ---------------------------------------------------------------------------
# B1's route from 2¹⁵ nodes: the CLUSTER form up to its capacity, the
# one-CTA WIDE form above it, decided by (n, gateway dtype) alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gw_size", [4, 8])
def test_b1_cluster_capacity_and_plan(gw_size):
    cap = dk.lb_cluster_capacity(gw_size)
    assert cap == dk.LB_CLUSTER_MAX * dk.LB_CLUSTER_SHARE == 1 << 17
    want = {1 << 15: 16, 40961: 16, 1 << 16: 16, (1 << 16) + 1: 16,
            cap: 16, cap + 1: 0, 1 << 18: 0, dk.LB_MAX_NODES: 0,
            (1 << 15) - 1: 0, 256: 0}
    for n, cluster in want.items():
        assert dk.lb_cluster_plan(n, gw_size) == cluster, n
        if cluster:
            share = dk.lb_pad(n) // cluster
            assert share * cluster == dk.lb_pad(n)
            assert share % dk.LB_CLUSTER_THREADS == 0
            assert cluster == dk.LB_CLUSTER_MAX
            assert share <= dk.LB_CLUSTER_SHARE
            assert dk.lb_cluster_smem(share, gw_size) <= dk.SMEM_LIMIT


@pytest.mark.parametrize("gw_size", [4, 8])
@pytest.mark.parametrize("n", [1 << 15, 40961, 1 << 16, 1 << 17])
def test_b1_cluster_form_below_the_capacity(n, gw_size):
    assert dk.lb_form(n, gw_size) == dk.CLUSTER
    assert dk.lb_form(n, gw_size) == dk.lb_form(int(n), int(gw_size))


@pytest.mark.parametrize("gw_size", [4, 8])
@pytest.mark.parametrize("n", [(1 << 17) + 1, 1 << 18, 1 << 30])
def test_b1_wide_form_above_the_capacity(n, gw_size):
    assert n > dk.lb_cluster_capacity(gw_size)
    assert dk.lb_form(n, gw_size) == dk.WIDE
    assert dk.lb_cluster_plan(n, gw_size) == 0


@pytest.mark.parametrize("gw_size", [4, 8])
def test_b1_packed_forms_below_2_15_are_unchanged(gw_size):
    assert dk.lb_form(256, gw_size) == dk.SHARED
    assert dk.lb_form(8192, gw_size) == dk.SHARED
    assert dk.lb_form(16384, gw_size) == dk.GLOBAL
    assert dk.lb_form((1 << 15) - 1, gw_size) == dk.GLOBAL
    assert dk.lb_cluster_plan((1 << 15) - 1, gw_size) == 0


def test_b1_cluster_smem_layout():
    """``lb_cluster_smem`` as ``csrc/dgi.cu``'s ``lb_cluster_layout``
    lays a CTA out: 144 bytes of buffer and slots, then 12 bytes a key
    pair, the gateway (16-byte aligned after it) and 8 bytes of segment
    start and length a padded node."""
    for share in (1024, 4096, 8192):
        for gw_size in (4, 8):
            gw_end = 144 + 12 * share + gw_size * share
            assert dk.lb_cluster_smem(share, gw_size) == \
                (gw_end + 15) // 16 * 16 + 8 * share
    assert dk.lb_cluster_smem(8192, 8) == 229_520 <= dk.SMEM_LIMIT
