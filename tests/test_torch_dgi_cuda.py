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
    forms = [dk.GLOBAL] + ([dk.SHARED] if n < 1500 else [])
    for form in forms:  # each form, bit for bit and on repeat
        got = dk.form_groups(alive, reach, rank, form=form)
        assert same(got, want)
        assert same(got, dk.form_groups(alive, reach, rank, form=form))


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
