"""G1 ``form_groups``, R1 ``reach_closure`` and B1 ``lb_rounds`` on the
card against their plain PyTorch versions, bit for bit and bit-identical
on repeat.  Every test here needs a CUDA card and skips without one;
``chip_smoke.py`` runs the same checks at the full widths.  No JAX: the
plain versions are held to the reference on the CPU by
``tests/test_torch_gm.py``, ``test_torch_lb.py`` and
``test_torch_topology.py``."""

import numpy as np
import pytest
import torch

from freedm_tpu_torch.grid import topology as top
from freedm_tpu_torch.kernels import dgi_kernels as dk


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")
    return torch.device("cuda")


def same(a, b):
    return all(x is None and y is None or torch.equal(x, y)
               for x, y in zip(a, b))


def sparse_graph(rng, n):
    reach = np.zeros((n, n), np.float32)
    groups = rng.integers(0, n // 16 + 1, n)
    for g in np.unique(groups):
        m = rng.permutation(np.nonzero(groups == g)[0])
        reach[m[:-1], m[1:]] = 1.0
    return np.maximum(reach, reach.T)


@pytest.mark.cuda
@pytest.mark.parametrize("n,lanes", [(1, 1), (3, 4), (64, 8), (300, 2),
                                     (1500, 1)])
@pytest.mark.parametrize("directed", [False, True])
def test_g1_matches_plain_on_card(cuda_device, n, lanes, directed):
    rng = np.random.default_rng(n)
    graph = sparse_graph(rng, n)
    if directed:  # outside the contract: the reference's directed closure
        graph = np.triu(graph)
    reach = torch.as_tensor(graph, device=cuda_device)[None]
    alive = torch.as_tensor(rng.uniform(size=(lanes, n)) > 0.1,
                            device=cuda_device)
    rank = (torch.as_tensor(rng.permutation(n), device=cuda_device)
            + 1).to(torch.int32)
    want = dk.form_groups_plain(alive, reach, rank)
    got = dk.form_groups(alive, reach, rank)
    assert same(got, want)  # bit for bit, and on repeat
    assert same(got, dk.form_groups(alive, reach, rank))


@pytest.mark.cuda
@pytest.mark.parametrize("v", [12, 200, 1400])
def test_r1_matches_plain_on_card(cuda_device, v):
    rng = np.random.default_rng(v)
    lines = [f"edge a{i} a{i + 1}" for i in range(v - 1) if i % 9]
    lines += [f"fid a{i} a{i + 1} F{i}" for i in range(v - 1) if not i % 9]
    topo = top.parse_topology("\n".join(lines))
    closed = rng.uniform(size=(3, topo.n_fids)) > 0.5
    fn = top.make_reachability(topo, device=cuda_device)
    plain = top.make_reachability(topo, device=cuda_device, plain=True)
    got = fn(closed)
    assert torch.equal(got, plain(closed)) and torch.equal(got, fn(closed))


@pytest.mark.cuda
@pytest.mark.parametrize("n,fleets", [(3, 1), (256, 1), (256, 16), (9000, 1)])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.float64, torch.float64),
                                    (torch.float64, torch.float32)])
def test_b1_matches_plain_on_card(cuda_device, n, fleets, dtypes):
    rng = np.random.default_rng(n + fleets)
    g = rng.integers(0, n // 40 + 1, (fleets, n))
    gid = torch.as_tensor(np.stack([[list(row).index(x) for x in row]
                                    for row in g]), dtype=torch.int32,
                          device=cuda_device)
    ng = torch.as_tensor(rng.normal(0, 10, (fleets, n)), dtype=dtypes[0],
                         device=cuda_device)
    gw = torch.as_tensor(rng.normal(0, 2, (fleets, n)), dtype=dtypes[1],
                         device=cuda_device)
    mal = torch.as_tensor(rng.uniform(size=(fleets, n)) < 0.2,
                          dtype=torch.float32, device=cuda_device)
    gate = torch.as_tensor(rng.uniform(size=(fleets, n)) < 0.9,
                           device=cuda_device)
    for rounds, kw in ((1, dict(malicious=mal, gate=gate,
                                round_outputs=True)),
                       (12, dict(malicious=mal))):
        got = dk.lb_rounds(ng, gw, gid, 0.5, rounds, **kw)
        assert same(got, dk.lb_rounds_plain(ng, gw, gid, 0.5, rounds, **kw))
        assert same(got, dk.lb_rounds(ng, gw, gid, 0.5, rounds, **kw))


def wide_fleets(n, fleets, dtypes, device, seed=0):
    """``fleets`` fleets of ``n`` nodes: readings ``normal(0, 10)`` and a
    gateway ``normal(0, 2)``, random groups (their smallest members as
    ids) in the first fleet and 512-node blocks in the others."""
    rng = np.random.default_rng(seed)
    rows = []
    for k in range(fleets):
        g = (rng.integers(0, n // 64 + 1, n) if k == 0
             else np.arange(n) // 512)
        first = np.unique(g, return_index=True)
        rows.append(first[1][np.searchsorted(first[0], g)])
    gid = torch.as_tensor(np.stack(rows), dtype=torch.int32, device=device)
    ng = torch.as_tensor(rng.normal(0, 10, (fleets, n)), dtype=dtypes[0],
                         device=device)
    gw = torch.as_tensor(rng.normal(0, 2, (fleets, n)), dtype=dtypes[1],
                         device=device)
    return ng, gw, gid


@pytest.mark.cuda
@pytest.mark.parametrize("n,fleets", [(1 << 15, 2), (40961, 1)])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.float64, torch.float64)])
def test_b1_wide_matches_plain_on_card(cuda_device, n, fleets, dtypes):
    assert dk.lb_form(n, dtypes[1].itemsize) == dk.CLUSTER
    ng, gw, gid = wide_fleets(n, fleets, dtypes, cuda_device)
    rng = np.random.default_rng(n)
    mal = torch.as_tensor(rng.uniform(size=(fleets, n)) < 0.1,
                          dtype=torch.float32, device=cuda_device)
    gate = torch.as_tensor(rng.uniform(size=(fleets, n)) < 0.9,
                           device=cuda_device)
    for rounds, kw in ((1, dict(malicious=mal, gate=gate,
                                round_outputs=True)),
                       (8, dict(malicious=mal))):
        got = dk.lb_rounds(ng, gw, gid, 1.0, rounds, **kw)
        assert same(got, dk.lb_rounds_plain(ng, gw, gid, 1.0, rounds, **kw))
        assert same(got, dk.lb_rounds(ng, gw, gid, 1.0, rounds, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("above", [0, 1])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.float64, torch.float64)])
def test_b1_at_the_cluster_capacity_on_card(cuda_device, above, dtypes):
    """B1 at its CLUSTER form's capacity (16 CTAs a fleet) and one node
    above it (the one-CTA WIDE form), float32 and float64 gateways: its
    plain version's bits, and on repeat."""
    size = dtypes[1].itemsize
    n = dk.lb_cluster_capacity(size) + above
    assert dk.lb_form(n, size) == (dk.WIDE if above else dk.CLUSTER)
    ng, gw, gid = wide_fleets(n, 1, dtypes, cuda_device, seed=3)
    mal = torch.as_tensor(np.random.default_rng(n).uniform(size=(1, n)) < 0.1,
                          dtype=torch.float32, device=cuda_device)
    for rounds, kw in ((1, dict(malicious=mal, round_outputs=True)),
                       (3, dict(malicious=mal))):
        dk.reset_launches()
        got = dk.lb_rounds(ng, gw, gid, 1.0, rounds, **kw)
        assert dk.launches()["lb_rounds"] == 1
        assert same(got, dk.lb_rounds_plain(ng, gw, gid, 1.0, rounds, **kw))
        assert same(got, dk.lb_rounds(ng, gw, gid, 1.0, rounds, **kw))


@pytest.mark.cuda
def test_b1_packed_form_below_2_15_is_unchanged(cuda_device):
    n = (1 << 15) - 1
    assert dk.lb_form(n, 8) == dk.GLOBAL
    ng, gw, gid = wide_fleets(n, 1, (torch.float64, torch.float64),
                              cuda_device, seed=1)
    got = dk.lb_rounds(ng, gw, gid, 1.0, 8)
    assert same(got, dk.lb_rounds_plain(ng, gw, gid, 1.0, 8))


@pytest.mark.cuda
def test_lb_entry_points_at_2_15_nodes_on_card(cuda_device):
    """``lb.lb_round(..., gid=...)`` and ``lb.run_rounds`` at 2^15 nodes
    (B1's CLUSTER form) against B1's plain version, from a block-diagonal
    group mask of 512-node groups built on the card."""
    from freedm_tpu_torch.modules import lb

    n = 1 << 15
    ng, gw, _ = wide_fleets(n, 2, (torch.float64, torch.float64),
                            cuda_device, seed=2)
    ng, gw = ng[1], torch.zeros_like(gw[1])
    blk = torch.arange(n, device=cuda_device) // 512
    mask = (blk[:, None] == blk[None, :]).to(torch.float32)
    gid = lb.group_ids(mask)
    assert torch.equal(gid, (blk * 512).to(torch.int32))
    dk.reset_launches()
    got = lb.run_rounds(ng, gw, mask, 1.0, 16, device=cuda_device)
    assert dk.launches()["lb_rounds"] == 1
    want = dk.lb_rounds_plain(ng[None], gw[None], gid[None], 1.0, 16)
    for a, b in zip(got, (want.gateway[0], want.migrations[0],
                          want.states[0])):
        assert torch.equal(a, b)
    rnd = lb.lb_round(ng, got[0], mask, 1.0, gid=gid, device=cuda_device)
    one = dk.lb_rounds_plain(ng[None], got[0][None], gid[None], 1.0, 1,
                             round_outputs=True)
    assert torch.equal(rnd.gateway, one.gateway[0])
    assert torch.equal(rnd.state, one.states[0, 0])
    assert int(rnd.n_migrations) == int(one.migrations[0, 0])
    assert torch.equal(rnd.intransit, one.intransit[0])


def islands(rng, n, k, density):
    """A symmetric reach of k islands, each `density` dense (the
    superstep's reach is 98% dense, split by its open switches)."""
    part = rng.integers(0, k, n)
    reach = (rng.uniform(size=(n, n)) < density) & (part[:, None]
                                                    == part[None, :])
    reach = np.triu(reach, 1)
    return (reach | reach.T).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("n,lanes,kind", [(1024, 1, "dense"),
                                          (1024, 1, "directed"),
                                          (4096, 1, "sparse"),
                                          (1026, 3, "dense"),
                                          (256, 200, "sparse")])
def test_g1_global_launch_on_card(cuda_device, n, lanes, kind):
    """G1's cooperative launch: the superstep's N = 1024 x 1 on a
    98%-dense reach, N = 4096 (the rows read from L2), a width off the
    16-byte path and more lanes than the card holds CTAs."""
    rng = np.random.default_rng(n + lanes)
    graph = (sparse_graph(rng, n) if kind == "sparse"
             else islands(rng, n, 4, 0.98))
    if kind == "directed":
        graph = np.triu(graph)
    reach = torch.as_tensor(graph, device=cuda_device)[None]
    alive = torch.as_tensor(rng.uniform(size=(lanes, n)) >= 0.02,
                            device=cuda_device)
    rank = (torch.as_tensor(rng.permutation(n), device=cuda_device)
            + 1).to(torch.int32)
    want = dk.form_groups_plain(alive, reach, rank)
    got = dk.form_groups(alive, reach, rank)
    assert same(got, want)
    assert same(got, dk.form_groups(alive, reach, rank))
    assert dk.launches()["form_groups"] >= 2
