"""Physical grid topology with FID-gated reachability.

Port of ``freedm_tpu/grid/topology.py``.  The reference's
``topology.cfg`` DSL — ``edge v1 v2`` physical lines, ``sst v uuid``
vertex→DGI mapping, ``fid v1 v2 name`` breaker-controlled edges
(``CPhysicalTopology``, ``Broker/src/CPhysicalTopology.cpp``) — compiles
to arrays, and reachability for **all sources at once** is the closure of
the adjacency gated by the live FID state vector: edges whose Fault
Isolation Device is open or unknown are broken (``ReachablePeers``,
``CPhysicalTopology.cpp:92-169``), so cyber groups never span an open
breaker.

On the card the closure is R1 ``reach_closure``
(:mod:`freedm_tpu_torch.kernels.dgi_kernels`): one CTA a FID scenario
gates the FID edges into the packed adjacency, labels its components and
writes the ``[V, V]`` 0/1 matrix.  The reference closes by ``ceil(log2
V)`` float32 squarings; the graph is undirected, so the closure is "in
the same component" and the two give the same matrix.  On the CPU (and
with ``plain=True``) the squarings run as the reference writes them.

``fid_closed`` is ``[n_fids]`` or ``[S, n_fids]`` 0/1 (1 closed, 0 open
or unknown); the second form is the reference's "vmap over FID
scenarios for contingency studies", written out as a batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Tuple, Union

import numpy as np
import torch

from freedm_tpu_torch.device import DeviceLike, resolve_device
from freedm_tpu_torch.kernels import dgi_kernels as dk
from freedm_tpu_torch.utils.textio import read_source

Tensor = torch.Tensor


@dataclass(frozen=True)
class Topology:
    """Compiled physical topology."""

    vertices: Tuple[str, ...]  # vertex names
    adj: np.ndarray  # [V, V] 0/1 ungated edges (FID edges excluded)
    fid_edges: Tuple[Tuple[int, int], ...]  # FID-controlled edges
    fid_names: Tuple[str, ...]  # FID device name per controlled edge
    sst_uuid: Dict[str, str]  # vertex -> DGI uuid ("" for DUMMY)

    @property
    def n_vertices(self) -> int:
        return len(self.vertices)

    @property
    def n_fids(self) -> int:
        return len(self.fid_edges)

    def vertex_index(self, name: str) -> int:
        return self.vertices.index(name)

    def node_vertices(self, uuids: Tuple[str, ...]) -> np.ndarray:
        """[len(uuids)] vertex index per DGI uuid (-1 if absent)."""
        by_uuid = {u: v for v, u in self.sst_uuid.items() if u}
        index = {v: i for i, v in enumerate(self.vertices)}
        return np.array(
            [index[by_uuid[u]] if u in by_uuid else -1 for u in uuids],
            dtype=np.int32,
        )


def parse_topology(source: Union[str, Path]) -> Topology:
    """Parse the reference ``topology.cfg`` DSL (path or raw text).

    Unknown directives are an error, like the reference's loader
    (``LoadTopology``, ``CPhysicalTopology.cpp:182-260``); so are two
    ``fid`` lines over one vertex pair and one FID name on two edges.
    """
    text = read_source(source, "\n")
    verts: List[str] = []
    seen: Dict[str, int] = {}
    edges: List[Tuple[str, str]] = []
    fids: List[Tuple[str, str, str]] = []
    ssts: Dict[str, str] = {}

    def vert(v: str) -> str:
        if v not in seen:
            seen[v] = len(verts)
            verts.append(v)
        return v

    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        if parts[0] == "edge" and len(parts) == 3:
            edges.append((vert(parts[1]), vert(parts[2])))
        elif parts[0] == "fid" and len(parts) == 4:
            # Two gate entries over one pair would let an open state on one
            # be overridden by a closed state on the other; one name on two
            # edges would gate both with one breaker's state.
            pair = frozenset((parts[1], parts[2]))
            if any(frozenset((a, b)) == pair for a, b, _ in fids):
                raise ValueError(f"duplicate fid declaration: {raw!r}")
            if any(name == parts[3] for _, _, name in fids):
                raise ValueError(f"duplicate fid device name: {raw!r}")
            fids.append((vert(parts[1]), vert(parts[2]), parts[3]))
        elif parts[0] == "sst" and len(parts) == 3:
            uuid = parts[2]
            ssts[vert(parts[1])] = "" if uuid.startswith("DUMMY") else uuid
        else:
            raise ValueError(f"malformed topology line: {raw!r}")

    n = len(verts)
    # FID directives *gate* an existing or implicit edge; the reference
    # treats "fid a b NAME" as declaring the controlled edge itself.
    fid_set = {frozenset((a, b)) for a, b, _ in fids}
    adj = np.zeros((n, n), np.float32)
    for a, b in edges:
        if frozenset((a, b)) in fid_set:
            continue  # controlled edges live in fid_edges
        adj[seen[a], seen[b]] = adj[seen[b], seen[a]] = 1.0
    return Topology(
        vertices=tuple(verts),
        adj=adj,
        fid_edges=tuple((seen[a], seen[b]) for a, b, _ in fids),
        fid_names=tuple(name for _, _, name in fids),
        sst_uuid=ssts,
    )


def make_reachability(topo: Topology, device: DeviceLike = None,
                      plain: bool = False):
    """Build ``reachable(fid_closed) -> [V, V]`` (``[S, V, V]`` for
    ``[S, n_fids]`` scenarios), float32 0/1, for a topology.

    ``fid_closed`` values are 1 (closed) or 0 (open); the reference also
    breaks edges whose FID state is *unknown* — encode unknown as 0
    (``ReachablePeers`` drops edges unless the FID is known-closed).  On
    the card each call is one R1 launch; ``plain=True`` runs R1's plain
    version (the reference's squarings) on any device.  The adjacency must
    be symmetric, as :func:`parse_topology` builds it.
    """
    dev = resolve_device(device)
    op = dk.reach_operands(topo.adj, topo.fid_edges, dev)

    def reachable(fid_closed) -> Tensor:
        closed = torch.as_tensor(fid_closed, dtype=torch.float32, device=dev)
        batched = closed.dim() == 2
        if closed.dim() not in (1, 2) or closed.shape[-1] != topo.n_fids:
            raise ValueError(f"fid_closed must be [n_fids] or [S, n_fids] "
                             f"with n_fids = {topo.n_fids}, got "
                             f"{tuple(closed.shape)}")
        closed = closed.reshape(-1, topo.n_fids).contiguous()
        fn = dk.reach_closure_plain if plain else dk.reach_closure
        reach = fn(op, closed)
        return reach if batched else reach[0]

    return reachable


def node_reachability(topo: Topology, uuids: Tuple[str, ...],
                      device: DeviceLike = None, plain: bool = False):
    """Build ``node_reach(fid_closed) -> [N, N]`` (``[S, N, N]``)
    reachability between DGI nodes.

    Rows/columns follow ``uuids`` order; a node without a topology vertex
    is reachable only from itself (the reference treats missing vertices
    as isolated).  R1's closure, then a row and column gather in torch
    indexing.  Feed the result to
    :func:`freedm_tpu_torch.modules.gm.form_groups`.
    """
    dev = resolve_device(device)
    vidx = topo.node_vertices(uuids)
    reach_fn = make_reachability(topo, device=dev, plain=plain)
    has_vertex = torch.as_tensor((vidx >= 0).astype(np.float32), device=dev)
    safe = torch.as_tensor(np.maximum(vidx, 0).astype(np.int64), device=dev)
    eye = torch.eye(len(uuids), dtype=torch.float32, device=dev)

    def node_reach(fid_closed) -> Tensor:
        r = reach_fn(fid_closed)
        nr = r[..., safe, :][..., :, safe]
        nr = nr * has_vertex[:, None] * has_vertex[None, :]
        return torch.maximum(nr, eye)

    return node_reach
