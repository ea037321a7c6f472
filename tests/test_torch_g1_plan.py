"""G1 ``form_groups``'s launch plans, and its plain version at the
superstep's width, on the CPU.

On the card G1 is one cooperative launch on
``dgi_kernels.g1_global_plan``: every CTA resident, the lanes' rows dealt
in contiguous runs (``g1_rows``), a lane's packed rows copied into one
CTA's shared memory at an odd stride where they fit.  These tests hold:

- the plan: its grid within the resident count and at least one CTA a
  lane where the card holds them, every row dealt once, its shared memory
  within the card's 232,448 bytes a block at N in {1, 31, 32, 33, 1024,
  1312, 1313, 4096} and lanes in {1, 16, 64}, staged up to N = 1312;
- the plan at the port's shapes: the superstep's N = 1024 x 1, the
  SST's 256 x 64 and N = 4096 x 1;
- ``form_groups_plain`` against the reference's ``freedm_tpu.modules.gm.
  form_groups`` at N = 1024 on a 98%-dense symmetric reach of several
  islands and on a directed one, field for field.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freedm_tpu.modules import gm as ref
from freedm_tpu_torch.kernels import dgi_kernels as dk

SMEM = 232_448  # shared memory a block may use on an H100
NODES = (1, 31, 32, 33, 1024, 1312, 1313, 4096)


@pytest.mark.parametrize("n", NODES)
@pytest.mark.parametrize("lanes", [1, 16, 64])
def test_global_plan_fits_and_deals_each_row_once(n, lanes):
    for resident in (1, 7, 132, 264):
        plan = dk.g1_global_plan(n, lanes, resident)
        assert 1 <= plan.grid <= resident
        assert plan.grid >= min(lanes, resident)  # a CTA a lane where held
        assert plan.grid == min(resident, max(
            lanes, -(-(lanes * n) // dk.G1_ROWS_PER_CTA)))
        assert plan.staged == (n <= 1312)
        assert plan.smem <= SMEM
        assert plan.smem == dk.g1_smem_bytes(
            n, dk.g1_stride(n) if plan.staged else 0)
        rows = dk.g1_rows(n, lanes, plan.grid)
        assert len(rows) == plan.grid
        assert [r for run in rows for r in run] == list(range(lanes * n))


def test_staged_rows_sit_at_an_odd_stride():
    for n in range(1, 1313):
        stride = dk.g1_stride(n)
        assert stride % 2 == 1 and dk._words(n) <= stride <= dk._words(n) + 1
        assert dk.g1_staged(n)
    assert not dk.g1_staged(1313)
    assert dk.g1_smem_bytes(4096) <= SMEM  # labels alone: the rows in L2


@pytest.mark.parametrize("n,lanes,grid,staged", [(1024, 1, 128, True),
                                                 (256, 64, 264, True),
                                                 (4096, 1, 264, False)])
def test_plan_at_the_port_shapes(n, lanes, grid, staged):
    plan = dk.g1_global_plan(n, lanes, 264)  # 2 CTAs an SM x 132 SMs
    assert (plan.grid, plan.staged) == (grid, staged)
    assert plan.smem == dk.g1_smem_bytes(n, dk.g1_stride(n) if staged else 0)
    if n == 1024:  # the superstep's: its rows 33 words apart, 132 KB
        assert 132 * 1024 <= plan.smem <= SMEM


def islands(rng, n, k, density):
    """A symmetric reach of k islands, each `density` dense."""
    part = rng.integers(0, k, n)
    reach = (rng.uniform(size=(n, n)) < density) & (part[:, None]
                                                    == part[None, :])
    reach = np.triu(reach, 1)
    return (reach | reach.T).astype(np.float32)


@pytest.mark.parametrize("kind", ["dense", "directed"])
def test_plain_against_reference_at_the_superstep_width(kind):
    n = 1024
    rng = np.random.default_rng(23 if kind == "dense" else 24)
    reach = islands(rng, n, 5, 0.98)
    if kind == "directed":  # outside the contract: the directed closure
        sparse = islands(rng, n, 40, 0.02)
        reach = np.triu(sparse)
    alive = (rng.uniform(size=n) >= 0.02).astype(np.float32)
    prio = rng.permutation(n).astype(np.float64)
    want = ref.form_groups(jnp.asarray(alive), jnp.asarray(reach),
                           jnp.asarray(prio))
    rank = torch.as_tensor((np.argsort(np.argsort(prio, kind="stable"),
                                       kind="stable") + 1).astype(np.int32))
    got = dk.form_groups_plain(torch.as_tensor(alive >= 0.5)[None],
                               torch.as_tensor(reach)[None], rank)
    for name, a, b in zip(ref.GroupState._fields, want, got):
        np.testing.assert_array_equal(np.asarray(a), b[0].numpy(),
                                      err_msg=name)
    assert int(got.n_groups[0]) > 1
