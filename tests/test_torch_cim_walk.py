"""I2's walk on the CPU: the product split of ``cim_vjp_walk``
(``solver_kernels.cim_walk_plan``, ``csrc/solvers.cu`` ``walk_shape``)
and the walk's plain route.  The plan is a function of the shape alone:
every (tile, K stage) unit of ``Aᴴ g`` taken by exactly one item, each
item one run of consecutive units, each (item, tile) pair its own slot;
summing the slots of a tile in item order gives the dense product.  The
walk on CPU tensors is the plain per-iteration loop, bit for bit.  The
kernel itself is held to these on the card
(``tests/test_torch_adjoint_cuda.py``, ``chip_smoke.py`` phase 27)."""

import numpy as np
import pytest
import torch

from freedm_tpu_torch.kernels import solver_kernels as sol
from freedm_tpu_torch.kernels.newton_kernels import (TILE_K, TILE_LANES,
                                                     TILE_ROWS)

SHAPES = [(3000, 64), (3000, 65), (3000, 1), (24, 64), (27, 3), (5, 200),
          (2000, 1024), (700, 130)]


@pytest.mark.parametrize("n,lanes", SHAPES)
def test_walk_plan_takes_every_unit_once(n, lanes):
    plan = sol.cim_walk_plan(n, lanes)
    assert plan == sol.cim_walk_plan(n, lanes)
    assert plan.row_tiles == -(-n // TILE_ROWS)
    assert plan.lane_tiles == -(-lanes // TILE_LANES)
    assert plan.stages == -(-n // TILE_K)
    assert plan.units == plan.row_tiles * plan.lane_tiles * plan.stages
    assert plan.items == min(sol.WALK_ITEMS, plan.units)
    tiles = plan.row_tiles * plan.lane_tiles
    assert plan.slots == plan.items + tiles - 1
    taken = np.zeros(plan.units, np.int64)
    slots = set()
    end = 0
    for w in range(plan.items):
        u0, u1 = plan.item_units(w)
        assert u0 == end and u1 > u0  # one run, consecutive, not empty
        end = u1
        taken[u0:u1] += 1
        for u in (u0, u1 - 1):
            assert plan.item_of(u) == w
        for t in range(u0 // plan.stages, (u1 - 1) // plan.stages + 1):
            assert w + t not in slots and w + t < plan.slots
            slots.add(w + t)
    assert end == plan.units and bool((taken == 1).all())
    for t in range(tiles):
        first, last = plan.tile_items(t)
        over = [w for w in range(plan.items)
                if plan.item_units(w)[0] < (t + 1) * plan.stages
                and plan.item_units(w)[1] > t * plan.stages]
        assert over == list(range(first, last + 1))


def test_walk_plan_at_the_cim_feeder():
    """The CIM feeder (N = 3000) × 64: 47 row tiles × 188 stages in 132
    items (one an H100 SM) of 66 or 67 stages, 178 slots."""
    plan = sol.cim_walk_plan(3000, 64)
    assert (plan.row_tiles, plan.lane_tiles, plan.stages) == (47, 1, 188)
    assert (plan.units, plan.items, plan.slots) == (8836, 132, 178)
    sizes = {plan.item_units(w)[1] - plan.item_units(w)[0]
             for w in range(plan.items)}
    assert sizes == {66, 67}


def _split_product(plan, h, g):
    """``p = h gᵀ`` as the walk forms it: each item's stages of each tile
    into the slot ``w + t`` in increasing column order, each tile's slots
    added in item order."""
    n, lanes = h.shape[0], g.shape[0]
    part = np.zeros((plan.slots, TILE_LANES, TILE_ROWS), h.dtype)
    for w in range(plan.items):
        u0, u1 = plan.item_units(w)
        for u in range(u0, u1):
            t, st = divmod(u, plan.stages)
            rt, lt = divmod(t, plan.lane_tiles)
            rows = slice(rt * TILE_ROWS, min(n, (rt + 1) * TILE_ROWS))
            lns = slice(lt * TILE_LANES, min(lanes, (lt + 1) * TILE_LANES))
            cols = slice(st * TILE_K, min(n, (st + 1) * TILE_K))
            blk = g[lns, cols] @ h[rows, cols].T
            part[w + t, :blk.shape[0], :blk.shape[1]] += blk
    p = np.zeros((lanes, n), h.dtype)
    for b in range(lanes):
        for i in range(n):
            t = (i // TILE_ROWS) * plan.lane_tiles + b // TILE_LANES
            first, last = plan.tile_items(t)
            p[b, i] = sum(part[w + t, b % TILE_LANES, i % TILE_ROWS]
                          for w in range(first, last + 1))
    return p


@pytest.mark.parametrize("n,lanes", [(100, 3), (27, 65), (300, 2)])
def test_walk_split_sums_to_the_product(n, lanes):
    rng = np.random.default_rng(n + lanes)
    h = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    g = rng.normal(size=(lanes, n)) + 1j * rng.normal(size=(lanes, n))
    got = _split_product(sol.cim_walk_plan(n, lanes), h, g)
    np.testing.assert_allclose(got, g @ h.T, rtol=1e-12, atol=1e-12)


def test_walk_split_with_fewer_items_than_tiles():
    """More tiles than items (an item spans several tiles): the plan
    still covers every unit once and sums to the product."""
    n, lanes = 64 * 20, 64 * 7  # 140 tiles > 132 items
    plan = sol.cim_walk_plan(n, lanes)
    assert plan.items == sol.WALK_ITEMS < plan.row_tiles * plan.lane_tiles
    spans = [plan.item_units(w) for w in range(plan.items)]
    assert max((u1 - 1) // plan.stages - u0 // plan.stages
               for u0, u1 in spans) >= 1
    assert sum(u1 - u0 for u0, u1 in spans) == plan.units


@pytest.mark.parametrize("lanes", [1, 3])
def test_walk_on_cpu_is_the_plain_loop(lanes):
    """``cim_vjp_walk`` on CPU tensors: the chained ``cim_vjp_plain``
    calls from the last saved iterate down, bit for bit."""
    rng = np.random.default_rng(lanes)
    n, steps = 27, 5
    a = torch.as_tensor(rng.normal(size=(n, n)) * 0.1)
    ai = torch.as_tensor(rng.normal(size=(n, n)) * 0.1)
    h = sol.cim_adjoint_matrix(a, ai)
    mask = torch.as_tensor((rng.uniform(size=n) < 0.8).astype(np.float64))
    vs = torch.as_tensor(rng.normal(1.0, 0.05, (steps + 1, 2, lanes, n)))
    vs[:, :, :, 3] = 0.0  # a dead node-phase
    s = [torch.as_tensor(rng.normal(0, 0.3, (lanes, n))) for _ in range(2)]
    g = [torch.as_tensor(rng.normal(size=(lanes, n))) * mask
         for _ in range(2)]
    got = sol.cim_vjp_walk(*h, *g, vs, *s, mask, steps)
    acc = [torch.zeros(lanes, n, dtype=torch.float64),
           torch.zeros(lanes, n, dtype=torch.float64), g[0].clone(),
           g[1].clone()]
    gk = g
    for k in reversed(range(steps)):
        gk = sol.cim_vjp_plain(*h, *gk, vs[k, 0], vs[k, 1], *s, mask, *acc)
    for x, y in zip(got, acc):
        assert torch.equal(x, y)
    assert float(got[0][:, 3].abs().max()) == 0.0
