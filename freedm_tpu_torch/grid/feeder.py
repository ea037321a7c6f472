"""Radial distribution feeder data model.

Port of ``freedm_tpu/grid/feeder.py``, array for array: host numpy, the
same relabeling, compile order, masks, depths, subtree incidence and
errors, so every solver of the port sees the feeder the reference sees.

The branch list is relabeled to contiguous node ids with the substation
at node 0, and every non-root node is identified with its unique
incoming branch (radial, so a bijection): per-node and per-branch
quantities share one axis.  ``compile`` precomputes parent-before-child
depths, node-phase masks (a phase exists at a node iff every branch on
its path carries it) and, for feeders of at most
:data:`~freedm_tpu_torch.pf.sweeps.DENSE_MAX_BRANCHES` branches, the
dense ``subtree`` incidence matrix (``subtree[i, j] = 1`` iff branch
``j`` lies in the subtree below branch ``i``).  ``reorder_preorder``
relabels into DFS preorder, where every subtree is a contiguous interval
— the layout the ladder kernel (L1) works in.

Per-phase impedances come from a line-code library ``z_codes`` (ohms
per unit length, 3×3 complex blocks); a phase is absent on a branch
whose diagonal impedance entry is zero.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

# Dl column layout of the reference branch table (load_system_data.cpp:29).
DL_COLS = ("ln", "sbus", "rbus", "lcod", "lng", "ldty", "P1", "Q1", "P2", "Q2", "P3", "Q3", "QC")


def z_base_ohm(base_kv: float, base_kva: float) -> float:
    """Base impedance; reference: Zb = 1000·bkv²/bkva (DPF_return7.cpp:62)."""
    return 1000.0 * base_kv**2 / base_kva


@dataclass
class Feeder:
    """A compiled radial feeder.

    All arrays are host numpy; solvers lift what they need onto the device.
    Branch ``i`` feeds node ``i + 1`` (node 0 = substation / slack).
    """

    # Structure -------------------------------------------------------------
    parent: np.ndarray  # [nb] int: parent branch index of branch i, -1 if fed by substation
    from_node: np.ndarray  # [nb] int: sending node (0 = substation)
    # (to_node of branch i is i + 1 by construction)

    # Electrical ------------------------------------------------------------
    z_pu: np.ndarray  # [nb, 3, 3] complex: series impedance, per unit
    s_load: np.ndarray  # [nb, 3] complex: spot load at to-node, kW + j·kvar
    q_shunt: np.ndarray  # [nb] float: shunt capacitor kvar at to-node (Dl QC column)
    load_type: np.ndarray  # [nb] int: Dl ldty column (constant-power only today)

    # Bases -----------------------------------------------------------------
    base_kva: float = 1000.0
    base_kv: float = 12.47
    v_source_pu: float = 1.015  # substation voltage (DPF_return7.cpp:13 uses 12.47*1.015)

    # Compiled operators ----------------------------------------------------
    subtree: np.ndarray = field(default=None)  # [nb, nb] float32 incidence
    phase_mask: np.ndarray = field(default=None)  # [nb, 3] float32: phase exists at to-node
    depth: np.ndarray = field(default=None)  # [nb] int: 0 for substation-fed branches
    levels: int = 0  # max depth + 1

    @property
    def n_branches(self) -> int:
        return int(self.parent.shape[0])

    @property
    def n_nodes(self) -> int:
        """Including the substation."""
        return self.n_branches + 1

    @property
    def z_base_ohm(self) -> float:
        return z_base_ohm(self.base_kv, self.base_kva)

    @property
    def s_base_per_phase_kva(self) -> float:
        # Reference scales loads by bkva/3 (DPF_return7.cpp:49).
        return self.base_kva / 3.0

    def compile(self, dense_subtree: Optional[bool] = None) -> "Feeder":
        """Precompute subtree incidence, phase masks and depths.

        Branch rows may arrive in any order (a child row before its
        parent's), so depth/mask propagation runs in a parent-before-child
        (DFS preorder) traversal from the substation-fed roots; a row set
        that isn't a forest rooted at the substation (cycle or
        disconnected island) is rejected.

        ``dense_subtree`` controls whether the O(n²) subtree incidence
        matrix is materialized (the matmul sweep path); ``None`` builds it
        only for feeders of at most ``DENSE_MAX_BRANCHES`` branches —
        larger feeders use the Euler-tour or pointer-jumping sweeps
        (:mod:`freedm_tpu_torch.pf.sweeps`), which need only
        ``parent``/``depth``.
        """
        nb = self.n_branches
        parent = self.parent
        children: list[list[int]] = [[] for _ in range(nb)]
        roots = []
        for i in range(nb):
            if parent[i] < 0:
                roots.append(i)
            else:
                children[parent[i]].append(i)
        order: list[int] = []
        queue = list(roots)
        while queue:
            i = queue.pop()
            order.append(i)
            queue.extend(children[i])
        if len(order) != nb:
            bad = sorted(set(range(nb)) - set(order))
            raise ValueError(
                f"branches {bad} are not reachable from the substation "
                "(cycle or disconnected island — not a radial feeder)"
            )
        depth = np.zeros(nb, dtype=np.int32)
        # Phase masks: a phase exists at a node iff every branch on the path
        # from the substation carries it (nonzero diagonal impedance).
        branch_has_phase = (np.abs(np.einsum("bpp->bp", self.z_pu)) > 0).astype(np.float32)
        mask = np.zeros((nb, 3), dtype=np.float32)
        for i in order:
            if parent[i] >= 0:
                depth[i] = depth[parent[i]] + 1
                mask[i] = branch_has_phase[i] * mask[parent[i]]
            else:
                mask[i] = branch_has_phase[i]
        if dense_subtree is None:
            from freedm_tpu_torch.pf.sweeps import DENSE_MAX_BRANCHES

            dense_subtree = nb <= DENSE_MAX_BRANCHES
        if dense_subtree:
            # subtree[i, j]: walk j's ancestor chain, marking every
            # ancestor incl. j.
            sub = np.zeros((nb, nb), dtype=np.float32)
            for j in range(nb):
                k = j
                while k >= 0:
                    sub[k, j] = 1.0
                    k = parent[k]
            self.subtree = sub
        else:
            self.subtree = None
        self.phase_mask = mask
        self.depth = depth
        self.levels = int(depth.max()) + 1 if nb else 0
        return self

    def reorder_preorder(self) -> tuple["Feeder", np.ndarray]:
        """Relabel branches (and their to-nodes) into DFS preorder.

        In preorder, every subtree is a contiguous branch interval and
        ``tin`` is the identity — the Euler-tour sweeps
        (:func:`freedm_tpu_torch.pf.sweeps.euler_sweeps`) then need one
        gather and one scatter per iteration instead of four and two, and
        the ladder kernel's sweeps become two prefix sums.  Returns ``(reordered, perm)`` with ``perm``
        the preorder list (``new index -> old branch index``); per-branch
        inputs map forward as ``x_new = x_old[perm]`` and results map
        back as ``y_old = y_new[inv]`` with ``inv = argsort(perm)``.
        Already-preordered feeders return ``(self, identity)``.
        """
        nb = self.n_branches
        parent = self.parent
        children: list[list[int]] = [[] for _ in range(nb)]
        roots = []
        for i in range(nb):
            if parent[i] < 0:
                roots.append(i)
            else:
                children[parent[i]].append(i)
        perm = np.zeros(nb, dtype=np.int32)
        t = 0
        stack = list(reversed(roots))
        while stack:
            i = stack.pop()
            perm[t] = i
            t += 1
            stack.extend(reversed(children[i]))
        if t != nb:
            raise ValueError("not a forest rooted at the substation")
        if np.array_equal(perm, np.arange(nb)):
            return self, perm
        tin = np.argsort(perm).astype(np.int32)  # old -> new
        # Node relabeling follows branches (branch i feeds node i+1).
        new_from = np.where(
            self.from_node[perm] == 0, 0, tin[self.from_node[perm] - 1] + 1
        ).astype(np.int32)
        out = Feeder(
            parent=new_from - 1,
            from_node=new_from,
            z_pu=self.z_pu[perm],
            s_load=self.s_load[perm],
            q_shunt=self.q_shunt[perm],
            load_type=self.load_type[perm],
            base_kva=self.base_kva,
            base_kv=self.base_kv,
            v_source_pu=self.v_source_pu,
        ).compile(dense_subtree=self.subtree is not None)
        return out, perm

    # -- Conversions --------------------------------------------------------

    def s_load_pu(self, s_load_kva: Optional[np.ndarray] = None) -> np.ndarray:
        s = self.s_load if s_load_kva is None else s_load_kva
        return s / self.s_base_per_phase_kva

    def to_dl(self) -> np.ndarray:
        """Round-trip to the reference's 13-column Dl layout (no zero rows)."""
        nb = self.n_branches
        dl = np.zeros((nb, 13))
        dl[:, 0] = np.arange(1, nb + 1)
        dl[:, 1] = self.from_node
        dl[:, 2] = np.arange(1, nb + 1)
        dl[:, 3] = 1  # line codes are baked into z_pu; emit a placeholder
        dl[:, 4] = 1.0
        dl[:, 5] = self.load_type
        dl[:, 6] = self.s_load[:, 0].real
        dl[:, 7] = self.s_load[:, 0].imag
        dl[:, 8] = self.s_load[:, 1].real
        dl[:, 9] = self.s_load[:, 1].imag
        dl[:, 10] = self.s_load[:, 2].real
        dl[:, 11] = self.s_load[:, 2].imag
        dl[:, 12] = self.q_shunt
        return dl


def from_branch_table(
    dl: np.ndarray,
    z_codes: np.ndarray,
    base_kva: float = 1000.0,
    base_kv: float = 12.47,
    v_source_pu: float = 1.015,
) -> Feeder:
    """Build a :class:`Feeder` from a reference-format branch table.

    ``dl`` is the 13-column Dl matrix (rows of all zeros — the reference's
    lateral separators, e.g. ``Broker/Dl_new.mat`` — are ignored; they only
    steer the C++ sweep order, which the compiled subtree matrix subsumes).
    ``z_codes`` is ``[n_codes, 3, 3]`` complex ohms-per-unit-length, i.e. the
    reference's stacked ``Z`` matrix reshaped into blocks.
    """
    dl = np.asarray(dl, dtype=np.float64)
    if dl.ndim != 2 or dl.shape[1] != 13:
        raise ValueError(f"Dl must be [*, 13], got {dl.shape}")
    rows = dl[dl[:, 0] != 0]  # drop separator rows
    nb = rows.shape[0]
    sbus_raw = rows[:, 1].astype(np.int64)
    rbus_raw = rows[:, 2].astype(np.int64)
    # Relabel receiving buses to 1..nb in row order (the reference requires
    # rbus to be unique; source buses must appear as some rbus or be 0).
    relabel = {0: 0}
    for i, r in enumerate(rbus_raw):
        if r in relabel:
            raise ValueError(f"duplicate receiving bus {r} — not a radial feeder")
        relabel[int(r)] = i + 1
    try:
        from_node = np.array([relabel[int(s)] for s in sbus_raw], dtype=np.int32)
    except KeyError as e:
        raise ValueError(f"source bus {e} never appears as a receiving bus") from e
    parent = from_node - 1  # branch feeding node n is n-1; substation -> -1

    lcod = rows[:, 3].astype(np.int64) - 1
    lng = rows[:, 4]
    z_codes = np.asarray(z_codes)
    if z_codes.ndim != 3 or z_codes.shape[1:] != (3, 3):
        raise ValueError(f"z_codes must be [n, 3, 3], got {z_codes.shape}")
    z_pu = z_codes[lcod] * (lng / z_base_ohm(base_kv, base_kva))[:, None, None]

    s_load = rows[:, 6:12:2] + 1j * rows[:, 7:12:2]
    return Feeder(
        parent=parent,
        from_node=from_node,
        z_pu=z_pu.astype(np.complex128),
        s_load=s_load.astype(np.complex128),
        q_shunt=rows[:, 12].copy(),
        load_type=rows[:, 5].astype(np.int32),
        base_kva=base_kva,
        base_kv=base_kv,
        v_source_pu=v_source_pu,
    ).compile()


def load_dl_mat(path, z_codes: Optional[np.ndarray] = None, **kwargs) -> Feeder:
    """Load an ASCII Armadillo-format Dl matrix (e.g. the reference's
    ``Broker/Dl_new.mat``: whitespace-separated floats, 13 columns).

    The Dl format carries line-code *indices* but not the impedance library
    itself (the reference compiles its library into
    ``load_system_data.cpp:44-58``); pass ``z_codes`` explicitly, or a
    generic overhead-line library sized to the table is synthesized.
    """
    dl = np.loadtxt(path, ndmin=2)
    if z_codes is None:
        from freedm_tpu_torch.grid.cases import default_z_codes

        rows = dl[dl[:, 0] != 0]
        z_codes = default_z_codes(int(rows[:, 3].max()))
    return from_branch_table(dl, z_codes, **kwargs)
