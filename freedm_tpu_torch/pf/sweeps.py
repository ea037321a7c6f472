"""Tree-sweep operators for radial power flow (plain PyTorch).

Port of ``freedm_tpu/pf/sweeps.py``.  The ladder method's two sweeps are
linear operators fixed by the feeder tree:

- **backward**: ``I_branch[i] = Σ_{j ∈ subtree(i)} I_load[j]`` — subtree
  sums (rootward accumulation of load currents);
- **forward**: ``path[i] = Σ_{k ∈ ancestors(i) ∪ {i}} drop[k]`` — root-to-
  node path sums (leafward accumulation of voltage drops).

Three realizations, each in the reference's operations and order:

- :func:`dense_sweeps` — a ``torch.matmul`` against the ``[nb, nb]``
  subtree incidence matrix (the reference leaves it to a plain matmul);
- :func:`doubling_sweeps` — pointer jumping, ``ceil(log2(levels))``
  gather or scatter-add rounds;
- :func:`euler_sweeps` — Euler-tour prefix sums, with the reference's
  shorter form when the feeder is already in DFS preorder.

These are the plain versions.  On the card the ladder does not call
them: its whole iteration, sweeps included, is a hand-written kernel of
:mod:`freedm_tpu_torch.kernels.ladder_kernels` — L1 on the Euler-tour
sweeps in preorder space, L3 on the dense ones, L4 on the doubling ones.
L3's and L4's plain versions run the dense and doubling sweeps of this
module (:func:`subtree_sweeps`, :func:`jump_sweeps`) on their operands,
so each form has one plain implementation on every device.

Operands are :class:`~freedm_tpu_torch.cplx.C` pairs whose tree axis is
the second to last (``[..., nb, p]``), so a leading lane axis passes
through — the reference's ``vmap`` written out.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from freedm_tpu_torch.cplx import C
from freedm_tpu_torch.device import DeviceLike, resolve_device
from freedm_tpu_torch.grid.feeder import Feeder

SweepFn = Callable[[C], C]

# Above this branch count the dense [nb, nb] subtree matrix is not built
# (10k buses would need ~400 MB) and the sweeps take another form.
DENSE_MAX_BRANCHES = 2048


def _pack(val: C) -> torch.Tensor:
    # (re ‖ im) on the last axis: one prefix, gather or scatter a step.
    return torch.cat([val.re, val.im], dim=-1)


def _unpack(x: torch.Tensor, p: int) -> C:
    return C(x[..., :p], x[..., p:])


def _zero_row(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros(x.shape[:-2] + (1, x.shape[-1]), dtype=x.dtype,
                       device=x.device)


def dense_sweeps(feeder: Feeder, dtype, device: DeviceLike = None
                 ) -> Tuple[SweepFn, SweepFn]:
    """Sweeps as matmuls against the subtree incidence matrix."""
    if feeder.subtree is None:
        raise ValueError("feeder compiled without a dense subtree matrix")
    return subtree_sweeps(torch.as_tensor(feeder.subtree, dtype=dtype,
                                          device=resolve_device(device)))


def subtree_sweeps(sub: torch.Tensor) -> Tuple[SweepFn, SweepFn]:
    """The dense sweeps on a subtree matrix ``sub [nb, nb]`` in the
    working dtype (``sub[i, j] = 1`` iff branch ``j`` lies in branch
    ``i``'s subtree): ``sub @ x`` backward, ``subᵀ @ x`` forward."""
    sub_t = sub.T

    def backward(i_load: C) -> C:
        return C(torch.matmul(sub, i_load.re), torch.matmul(sub, i_load.im))

    def forward(drop: C) -> C:
        return C(torch.matmul(sub_t, drop.re), torch.matmul(sub_t, drop.im))

    return backward, forward


def doubling_jumps(parent: np.ndarray, levels: int) -> np.ndarray:
    """The doubling sweeps' jump tables ``[rounds, nb + 1]``: round 0 the
    parent pointer with the roots sent to the sentinel slot ``nb`` (which
    points to itself), each next round the last composed with itself;
    ``ceil(log2(levels))`` rounds, at least one."""
    nb = int(parent.shape[0])
    rounds = max(1, math.ceil(math.log2(max(int(levels), 2))))
    j = np.concatenate([np.where(parent < 0, nb, parent), [nb]]).astype(
        np.int64)
    out = np.empty((rounds, nb + 1), np.int64)
    for m in range(rounds):
        out[m] = j
        j = j[j]
    return out


def preimage_lists(jumps: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Each round's preimage lists ``{i < nb : jump_m[i] = a}`` for ``a <
    nb``, in increasing ``i``: ``(ptr [rounds, nb + 1], idx)`` with
    absolute offsets.  The doubling backward sweep's scatter-add
    ``out[a] = x[a] + Σ x[i]`` is then a gather-sum in a fixed order —
    the order in which ``index_add`` adds on the CPU."""
    rounds, nb = jumps.shape[0], jumps.shape[1] - 1
    ptr = np.zeros((rounds, nb + 1), np.int64)
    idx = []
    base = 0
    for m in range(rounds):
        tgt = jumps[m, :nb]
        keep = np.nonzero(tgt < nb)[0]
        order = keep[np.argsort(tgt[keep], kind="stable")]
        cnt = np.bincount(tgt[keep], minlength=nb)
        ptr[m] = base + np.concatenate([[0], np.cumsum(cnt)])
        idx.append(order)
        base += order.shape[0]
    return ptr, (np.concatenate(idx) if idx else np.zeros(0, np.int64))


def doubling_sweeps(feeder: Feeder, dtype, device: DeviceLike = None
                    ) -> Tuple[SweepFn, SweepFn]:
    """Sweeps by pointer jumping — O(log depth) gather rounds
    (:func:`jump_sweeps` on the feeder's :func:`doubling_jumps` and
    :func:`preimage_lists`, made once on the host)."""
    jumps = doubling_jumps(np.asarray(feeder.parent), feeder.levels)
    return jump_sweeps(jumps, *preimage_lists(jumps),
                       device=resolve_device(device))


def jump_sweeps(jumps: np.ndarray, ptr: np.ndarray, idx: np.ndarray,
                device: DeviceLike = None) -> Tuple[SweepFn, SweepFn]:
    """The doubling sweeps on host tables: ``jumps [rounds, nb + 1]``
    and their :func:`preimage_lists` ``(ptr, idx)``.

    Each round does ``val ← val + P^(2^m)·val``: for the subtree sums a
    scatter-add into the ``2^m``-th ancestor, written as a gather-sum —
    each ``a`` adds its preimages in increasing index (a gather a column
    of the lists padded to the longest, the padding reading the zero
    sentinel row), which is ``index_add``'s order on the CPU and takes no
    atomics on the card; for the path sums a gather from it (``x +
    x[jump]``).  The sentinel slot ``nb`` takes the roots' pointers; its
    row stays zero.
    """
    dev = resolve_device(device)
    nb = int(jumps.shape[1]) - 1
    columns = []
    for m in range(jumps.shape[0]):
        cnt = np.diff(ptr[m])
        table = np.full((nb, int(cnt.max())), nb, np.int64)
        pos = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        table[np.repeat(np.arange(nb), cnt), pos] = idx[ptr[m, 0]:ptr[m, -1]]
        columns.append([torch.as_tensor(table[:, j], device=dev)
                        for j in range(table.shape[1])])
    steps = [torch.as_tensor(j, device=dev) for j in jumps]

    def _rounds(val: C, step) -> C:
        x = _pack(val)
        x = torch.cat([x, _zero_row(x)], dim=-2)
        for m in range(len(steps)):
            x = step(x, m)
        return _unpack(x[..., :nb, :], val.re.shape[-1])

    def _gather_sum(x, m):
        out = x[..., :nb, :]
        for col in columns[m]:  # index_select: its backward is an index_add
            out = out + x.index_select(x.dim() - 2, col)
        return torch.cat([out, _zero_row(x)], dim=-2)

    def _gather(x, m):
        return x + x[..., steps[m], :]

    def backward(i_load: C) -> C:
        return _rounds(i_load, _gather_sum)

    def forward(drop: C) -> C:
        return _rounds(drop, _gather)

    return backward, forward


def euler_tour(feeder: Feeder):
    """The DFS numbering of the Euler-tour sweeps: ``(preorder, tin,
    tout, entry, exit)`` — the preorder list, each branch's preorder
    position, the end of its subtree's interval (``tin + size``) and its
    entry and exit events on the 2·nb-event tour."""
    nb = feeder.n_branches
    parent = feeder.parent
    children: list[list[int]] = [[] for _ in range(nb)]
    roots = []
    for i in range(nb):
        if parent[i] < 0:
            roots.append(i)
        else:
            children[parent[i]].append(i)
    tin = np.zeros(nb, np.int64)
    size = np.ones(nb, np.int64)
    entry = np.zeros(nb, np.int64)
    exit_ = np.zeros(nb, np.int64)
    preorder = np.zeros(nb, np.int64)
    t = 0
    ev = 0
    stack = [(r, False) for r in reversed(roots)]
    while stack:
        node, done = stack.pop()
        if done:
            exit_[node] = ev
            ev += 1
            for c in children[node]:
                size[node] += size[c]
            continue
        tin[node] = t
        preorder[t] = node
        t += 1
        entry[node] = ev
        ev += 1
        stack.append((node, True))
        for c in reversed(children[node]):
            stack.append((c, False))
    return preorder, tin, tin + size, entry, exit_


def euler_sweeps(feeder: Feeder, dtype, device: DeviceLike = None
                 ) -> Tuple[SweepFn, SweepFn]:
    """Sweeps by Euler-tour prefix sums — a fixed number of operations
    at any depth.

    - **backward** (subtree sums): in DFS preorder every subtree is a
      contiguous interval, so ``sub[i] = P[tout_i] − P[tin_i]`` with
      ``P`` the exclusive prefix sum of the preorder-permuted values;
    - **forward** (path sums): on the 2·nb-event Euler tour (+x at
      entry, −x at exit) the inclusive prefix at a node's entry event is
      its path sum.

    A feeder already in DFS preorder (:meth:`Feeder.reorder_preorder`)
    takes the reference's shorter form: ``backward[i] = P[tout_i] −
    P[i]`` and ``forward[i] = P_incl[i] − cumsum(q)[i]`` with ``q`` the
    scatter of ``x`` onto ``tout`` — ancestors-or-self of ``i`` are the
    ``k ≤ i`` whose subtree interval is still open at ``i``.
    """
    dev = resolve_device(device)
    nb = feeder.n_branches
    preorder, tin, tout, entry, exit_ = euler_tour(feeder)
    preorder_t = torch.as_tensor(preorder, device=dev)
    tin_t = torch.as_tensor(tin, device=dev)
    tout_t = torch.as_tensor(tout, device=dev)
    entry_t = torch.as_tensor(entry, device=dev)
    exit_t = torch.as_tensor(exit_, device=dev)

    if bool(np.all(tin == np.arange(nb))):

        def backward(i_load: C) -> C:
            x = _pack(i_load)
            ps = torch.cat([_zero_row(x), torch.cumsum(x, dim=-2)], dim=-2)
            return _unpack(ps[..., tout_t, :] - ps[..., :nb, :],
                           i_load.re.shape[-1])

        def forward(drop: C) -> C:
            x = _pack(drop)
            p_incl = torch.cumsum(x, dim=-2)
            q = torch.zeros(x.shape[:-2] + (nb + 1, x.shape[-1]),
                            dtype=x.dtype, device=x.device)
            q = q.index_add(x.dim() - 2, tout_t, x)
            return _unpack(p_incl - torch.cumsum(q, dim=-2)[..., :nb, :],
                           drop.re.shape[-1])

        return backward, forward

    def backward(i_load: C) -> C:
        x = _pack(i_load)
        ps = torch.cumsum(x[..., preorder_t, :], dim=-2)
        ps = torch.cat([_zero_row(x), ps], dim=-2)  # exclusive prefix
        return _unpack(ps[..., tout_t, :] - ps[..., tin_t, :],
                       i_load.re.shape[-1])

    def forward(drop: C) -> C:
        x = _pack(drop)
        events = torch.zeros(x.shape[:-2] + (2 * nb, x.shape[-1]),
                             dtype=x.dtype, device=x.device)
        events[..., entry_t, :] = x
        events[..., exit_t, :] = -x
        es = torch.cumsum(events, dim=-2)
        return _unpack(es[..., entry_t, :], drop.re.shape[-1])

    return backward, forward


def make_sweeps(feeder: Feeder, dtype, method: Optional[str] = None,
                device: DeviceLike = None) -> Tuple[SweepFn, SweepFn]:
    """Pick the sweep realization: ``method`` in {"dense", "doubling",
    "euler", None}.  ``None`` selects as the reference does: dense
    whenever the incidence matrix was built, Euler-tour otherwise."""
    if method == "dense":
        return dense_sweeps(feeder, dtype, device)
    if method == "doubling":
        return doubling_sweeps(feeder, dtype, device)
    if method == "euler":
        return euler_sweeps(feeder, dtype, device)
    if method is not None:
        raise ValueError(f"unknown sweep method: {method!r}")
    if feeder.subtree is not None:
        return dense_sweeps(feeder, dtype, device)
    return euler_sweeps(feeder, dtype, device)
