"""The port's grid topology (``freedm_tpu_torch.grid.topology``) against
``freedm_tpu.grid.topology``: the ``topology.cfg`` parser with its
errors, and FID-gated reachability — R1's plain version on the CPU —
equal to the reference's, per scenario and batched."""

import jax.numpy as jnp
import numpy as np
import pytest

from freedm_tpu.grid import topology as ref
from freedm_tpu_torch.grid import topology as top
from freedm_tpu_torch.modules import gm

TOPOLOGY_CFG = """
# 4-node ring with FID-controlled cross-ties
edge a b
edge b c
edge c d
fid d a FID_DA
fid b d FID_BD
sst a host1:50000
sst b host2:50000
sst c host3:50000
sst d host4:50000
"""


def random_topology(seed, n_vertices=48, n_fids=10):
    """A random tree with some FIDs on its edges and some ties, an ``sst``
    on most vertices (a few DUMMY)."""
    rng = np.random.default_rng(seed)
    lines, k = [], 0
    fid_edges = set(rng.choice(n_vertices - 1, n_fids // 2, replace=False))
    for c in range(1, n_vertices):
        p = int(rng.integers(max(0, c - 6), c))
        if c - 1 in fid_edges:
            lines.append(f"fid v{p} v{c} F{k}")
            k += 1
        else:
            lines.append(f"edge v{p} v{c}")
    while k < n_fids:
        a, b = rng.integers(0, n_vertices, 2)
        if abs(int(a) - int(b)) > 8:
            lines.append(f"fid v{a} v{b} F{k}")
            k += 1
    for v in range(n_vertices):
        uuid = f"DUMMY{v}" if v % 7 == 3 else f"h{v}:1"
        lines.append(f"sst v{v} {uuid}")
    return "\n".join(lines) + "\n"


def test_parse_matches_reference():
    for text in (TOPOLOGY_CFG, random_topology(0), random_topology(1)):
        a, b = ref.parse_topology(text), top.parse_topology(text)
        assert a.vertices == b.vertices
        np.testing.assert_array_equal(a.adj, b.adj)
        assert a.fid_edges == b.fid_edges
        assert a.fid_names == b.fid_names
        assert a.sst_uuid == b.sst_uuid
        uuids = ("h3:1", "host2:50000", "nobody", "h9:1")
        np.testing.assert_array_equal(a.node_vertices(uuids),
                                      b.node_vertices(uuids))


@pytest.mark.parametrize("text,match", [
    ("edge a b\nfid a b F1\nfid b a F2\n", "duplicate fid declaration"),
    ("edge a b\nfid a b F1\nfid b c F1\n", "duplicate fid device name"),
    ("edge a b c\n", "malformed topology line"),
    ("node a\n", "malformed topology line"),
])
def test_parse_errors_match_reference(text, match):
    with pytest.raises(ValueError, match=match):
        ref.parse_topology(text)
    with pytest.raises(ValueError, match=match):
        top.parse_topology(text)


def test_single_line_raw_topology_parses():
    # A marker-free one-liner is raw text, not a path.
    assert top.parse_topology("edge a b").vertices == ("a", "b")
    with pytest.raises(FileNotFoundError):
        top.parse_topology("no/such/topology.cfg")


def test_topology_parse_and_fid_gating():
    topo = top.parse_topology(TOPOLOGY_CFG)
    assert topo.n_vertices == 4 and topo.n_fids == 2
    assert topo.fid_names == ("FID_DA", "FID_BD")
    reach = top.make_reachability(topo, device="cpu")
    assert float(reach(np.ones(2)).min()) == 1.0
    assert float(reach(np.asarray([0.0, 1.0]))[0, 3]) == 1.0
    assert float(reach(np.zeros(2))[0, 3]) == 1.0  # a-b-c-d chain intact
    node_reach = top.node_reachability(
        topo, ("host4:50000", "host1:50000", "host2:50000", "host3:50000"),
        device="cpu")
    nr = node_reach(np.zeros(2))
    assert nr.shape == (4, 4)
    assert float(nr[0, 1]) == 1.0  # d..a via chain


def test_groups_never_span_open_fid():
    cfg = "edge a b\nfid b c FID1\nsst a h1:1\nsst b h2:1\nsst c h3:1\n"
    topo = top.parse_topology(cfg)
    node_reach = top.node_reachability(topo, ("h1:1", "h2:1", "h3:1"),
                                       device="cpu")
    g_closed = gm.form_groups(np.ones(3), node_reach(np.ones(1)), device="cpu")
    g_open = gm.form_groups(np.ones(3), node_reach(np.zeros(1)), device="cpu")
    assert int(g_closed.n_groups) == 1
    assert int(g_open.n_groups) == 2
    assert float(g_open.group_mask[0, 2]) == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reachability_equals_reference(seed):
    text = random_topology(seed)
    ra, rb = ref.parse_topology(text), top.parse_topology(text)
    rng = np.random.default_rng(seed)
    scenarios = (rng.uniform(size=(4, rb.n_fids)) > 0.5).astype(np.float32)
    scenarios[0] = 0.0
    scenarios[1] = 1.0
    reach_a = ref.make_reachability(ra)
    reach_b = top.make_reachability(rb, device="cpu")
    uuids = tuple(rng.permutation([f"h{v}:1" for v in range(48)])[:20]) + (
        "missing:1",)
    node_a = ref.node_reachability(ra, uuids)
    node_b = top.node_reachability(rb, uuids, device="cpu")
    for fc in scenarios:
        np.testing.assert_array_equal(
            np.asarray(reach_a(jnp.asarray(fc))), reach_b(fc).numpy())
        np.testing.assert_array_equal(
            np.asarray(node_a(jnp.asarray(fc))), node_b(fc).numpy())
    # The batched form: the reference's vmap over FID scenarios.
    import jax

    np.testing.assert_array_equal(
        np.asarray(jax.vmap(reach_a)(jnp.asarray(scenarios))),
        reach_b(scenarios).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(node_a)(jnp.asarray(scenarios))),
        node_b(scenarios).numpy())


def test_reachability_refuses_bad_inputs():
    topo = top.parse_topology(TOPOLOGY_CFG)
    with pytest.raises(ValueError, match=r"\[n_fids\]"):
        top.make_reachability(topo, device="cpu")(np.ones(3))
    bent = top.Topology(vertices=("a", "b"),
                        adj=np.array([[0, 1], [0, 0]], np.float32),
                        fid_edges=(), fid_names=(), sst_uuid={})
    with pytest.raises(ValueError, match="symmetric"):
        top.make_reachability(bent, device="cpu")
