"""Batched topology sweeps: switching-screen lanes over one B′ LU.

Port of ``freedm_tpu/pf/topo.py``.  Enumerate or sample switch-state
*variants* of a case — up to ``max_rank`` simultaneous line flips — and
screen thousands of them against ONE B′ factorization.  The ladder,
cheapest first:

1. **Radiality/connectivity check** — kernel T1
   (:func:`~freedm_tpu_torch.kernels.topo_kernels.topo_radiality`):
   min-label connected components over each lane's closed branches, one
   launch a chunk; variants that disconnect the network (or, in
   ``mode="radial"``, fail the spanning-tree count) are excluded before
   any solve.
2. **Rank-r Sherman–Morrison–Woodbury screen** — opening the branch set
   S changes B′ by ``−Σ_{k∈S} w_k a_k a_kᵀ``, so every variant lane is a
   capacitance-matrix solve off the same base factorization:

       C = I_r − diag(w_S)·A_Sᵀ Z,   Z = B′⁻¹ A   (one multi-RHS solve
       θ_v = θ0 + Z_S C⁻¹ diag(w_S) A_Sᵀ θ0        at build time)

   kernel T2 (:func:`~freedm_tpu_torch.kernels.topo_kernels.topo_screen`)
   over Zᵀ ``[m, n]`` (a lane reads its r columns of Z as r contiguous
   rows), after θ0's ``torch.linalg.lu_solve``.  A (numerically)
   singular C flags the variant islanded.  Padded slots (``-1``) carry
   zero weight, so one ``[V, r]`` shape serves every rank ≤ r; rank 0 is
   the base case.
3. **Objective ranking** — DC loss proxy (Σ r·f²), worst loading (max
   |f|), or violation count against a flow limit; islanding lanes rank
   +inf.  The running shortlist is merged across chunks on the device by
   a stable sort (:func:`make_topk_merge`).
4. **AC verify** — the shortlist is re-solved on the sparse backend
   (status-traced warm-started lanes: S1 with status, S2-S4, K3) before
   any answer is returned; an infeasible shortlist slot is replaced by
   the base topology, so an islanding variant never reaches an AC lane.

Served two ways with this one implementation: the sync ``POST /v1/topo``
engine (:mod:`freedm_tpu_torch.serve.service`) and the async sweep job
(:mod:`freedm_tpu_torch.scenarios.jobs`: chunked, checkpointed, exact
resume; the checkpoint is the reference's JSON, so either package resumes
the other's).  Not ported: the ``mesh=`` screen form and sweeps over more
than one device (ROADMAP.md, module queue item 16), and the sweep's
``topo.sweep``/``topo.chunk`` spans, profiler samples and roofline
dispatch records (item 15).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
import time
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from freedm_tpu_torch.core import metrics as obs
from freedm_tpu_torch.device import DeviceLike, resolve_device
from freedm_tpu_torch.grid.bus import PQ, SLACK, BusSystem
from freedm_tpu_torch.kernels import topo_kernels as tk
from freedm_tpu_torch.pf.fdlf import decoupled_parts

#: |det C| below this marks the rank-r capacitance matrix singular —
#: the variant islands the network (rank-r analogue of dc._ISLAND_EPS).
_ISLAND_EPS = tk.ISLAND_EPS

TOPO_OBJECTIVES = ("loss", "max_flow", "violations")
TOPO_MODES = ("mesh", "radial")
TOPO_SEARCHES = ("exhaustive", "neighborhood")

#: Hard cap on simultaneous flips per variant: the capacitance matrix
#: is [r, r] per lane and enumeration is combinatorial in r.
MAX_TOPO_RANK = 6

#: Summary keys that legitimately differ between two runs of the same
#: sweep (wall clock + bookkeeping) — the resume-exactness contract is
#: "summaries equal modulo these".
TOPO_TIMING_KEYS = ("wall_s", "variants_per_sec", "chunks_done",
                    "resumed_from_chunk", "mesh_devices")

#: TopoSweepSpec keys that describe execution placement, not the sweep.
_MESH_SPEC_KEYS = ("mesh_devices",)

CKPT_VERSION = 1


class SweepCancelled(Exception):
    """Raised between chunks when the caller's cancel event is set; the
    last chunk checkpoint (if any) stays on disk for a later resume."""


def strip_topo_timing(summary: dict) -> dict:
    """The comparison view of a sweep summary: timing keys out."""
    return {k: v for k, v in summary.items() if k not in TOPO_TIMING_KEYS}


def _placement_free(d: dict) -> dict:
    return {k: v for k, v in d.items() if k not in _MESH_SPEC_KEYS}


# ---------------------------------------------------------------------------
# Variant generation (host side, deterministic in the spec)
# ---------------------------------------------------------------------------


def count_exhaustive(n_switches: int, max_rank: int) -> int:
    """Variants an exhaustive enumeration produces (ranks 1..max_rank)."""
    return sum(math.comb(int(n_switches), r)
               for r in range(1, int(max_rank) + 1))


def enumerate_variants(switches, max_rank: int) -> np.ndarray:
    """All open-sets of 1..``max_rank`` switches as a ``[V, max_rank]``
    int32 slot matrix of BRANCH indices, ``-1``-padded — rank ascending,
    lexicographic within a rank (deterministic, resume-stable)."""
    sw = np.asarray(switches, np.int64)
    r_max = int(max_rank)
    rows = []
    for r in range(1, r_max + 1):
        for combo in itertools.combinations(range(sw.shape[0]), r):
            row = np.full(r_max, -1, np.int32)
            row[:r] = sw[list(combo)]
            rows.append(row)
    if not rows:
        return np.empty((0, r_max), np.int32)
    return np.stack(rows).astype(np.int32)


def neighborhood_variants(switches, max_rank: int, samples: int,
                          seed: int) -> np.ndarray:
    """Seeded neighborhood sample for spaces too large to enumerate:
    ``samples`` distinct open-sets of rank 1..``max_rank``, drawn by a
    seeded generator — a pure function of (switches, max_rank, samples,
    seed), so a killed sweep regenerates the identical variant list."""
    sw = np.asarray(switches, np.int64)
    width = int(max_rank)  # slot-matrix columns stay the REQUESTED rank
    # A drawn rank can never exceed the candidate count (choice without
    # replacement) — fewer switches than max_rank just caps the draw.
    r_cap = min(width, int(sw.shape[0]))
    if r_cap < 1:
        return np.empty((0, max(width, 1)), np.int32)
    rng = np.random.default_rng(int(seed))
    seen = set()
    rows = []
    # Bounded draw loop: the distinct-subset space can be smaller than
    # ``samples``, so cap attempts rather than spin forever.
    space = count_exhaustive(sw.shape[0], r_cap)
    want = min(int(samples), space)
    attempts = 0
    while len(rows) < want and attempts < 50 * max(want, 1):
        attempts += 1
        r = int(rng.integers(1, r_cap + 1))
        combo = tuple(sorted(rng.choice(sw.shape[0], size=r,
                                        replace=False).tolist()))
        if combo in seen:
            continue
        seen.add(combo)
        row = np.full(width, -1, np.int32)
        row[:r] = sw[list(combo)]
        rows.append(row)
    if not rows:
        return np.empty((0, width), np.int32)
    return np.stack(rows).astype(np.int32)


# ---------------------------------------------------------------------------
# Radiality / connectivity check (T1)
# ---------------------------------------------------------------------------


class RadialityResult(NamedTuple):
    """Structural verdict per variant lane."""

    connected: torch.Tensor  # [V] bool: closed-branch graph is one island
    radial: torch.Tensor  # [V] bool: connected AND a spanning tree


def topo_operands(sys: BusSystem, device: DeviceLike = None
                  ) -> tk.TopoOperands:
    """T1's and T2's operands for ``sys`` on ``device``: the branch ends
    (int32), ``w = 1/x``, the series resistance and the free-θ masks of
    the branch ends (float64)."""
    dev = resolve_device(device)
    f = np.asarray(sys.from_bus, np.int64)
    t = np.asarray(sys.to_bus, np.int64)
    th_free = decoupled_parts(sys, device=dev).th_free

    def idx(a):
        return torch.as_tensor(a.astype(np.int32), device=dev)

    def vec(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)

    return tk.TopoOperands(
        n=int(sys.n_bus), f=idx(f), t=idx(t), w=vec(1.0 / np.asarray(sys.x)),
        r_series=vec(sys.r), mask_f=th_free[torch.as_tensor(f, device=dev)],
        mask_t=th_free[torch.as_tensor(t, device=dev)],
    )


def make_radiality_check(sys: BusSystem, r_max: int, max_sweeps: int = 0,
                         device: DeviceLike = None, plain: bool = False
                         ) -> Callable:
    """Build the batched connectivity/radiality check on ``device``
    (``cuda`` unless the CPU is asked for).

    Returns ``check(slots)`` with ``slots`` a ``[V, r_max]`` int array of
    opened branch indices (``-1`` = unused slot): per lane, min-label
    connected components over the CLOSED branches, one launch of T1 for
    every lane, no host loop.  ``radial`` additionally requires the
    spanning-tree branch count ``m − r == n − 1``.  ``max_sweeps`` caps
    the sweeps a lane (default ``n + 1``, enough to reach the fixed
    point).  The verdict equals the reference's at the fixed point only:
    T1's in-place sweeps and the reference's Jacobi sweeps may stop at
    other labels below it, so on the card a cap under ``n − 1`` raises
    ``ValueError``; the plain version runs the reference's sweeps at any
    cap.  ``plain=True`` runs T1's plain version on any device.  Any
    slot width up to ``MAX_TOPO_RANK`` runs the same kernel; ``r_max`` is
    kept for the reference's signature.
    """
    dev = resolve_device(device)
    op = topo_operands(sys, device=dev)
    cap = int(max_sweeps) if max_sweeps else sys.n_bus + 1
    fn = tk.topo_radiality_plain if plain else tk.topo_radiality

    def check(slots) -> RadialityResult:
        sl = torch.as_tensor(slots, dtype=torch.int32, device=dev).contiguous()
        connected, radial = fn(sl, op, cap)
        return RadialityResult(connected=connected, radial=radial)

    return check


# ---------------------------------------------------------------------------
# Rank-r SMW screen lanes (T2)
# ---------------------------------------------------------------------------


class TopoScreenResult(NamedTuple):
    """One screen pass's lane-batched output (all three objectives are
    computed in one launch; callers select with :func:`select_objective`)."""

    loss: torch.Tensor  # [V] DC loss proxy Σ r·f², pu
    worst_flow: torch.Tensor  # [V] max |flow|, pu
    violations: torch.Tensor  # [V] branches with |flow| > flow_limit
    islanded: torch.Tensor  # [V] bool: singular capacitance matrix


class TopoDetail(NamedTuple):
    """Full per-variant state, for shortlist reporting and the oracle
    tests (small V only — [V, n]/[V, m] outputs)."""

    theta: torch.Tensor  # [V, n]
    flows: torch.Tensor  # [V, m] (opened branches carry 0)
    loss: torch.Tensor  # [V]
    worst_flow: torch.Tensor  # [V]
    violations: torch.Tensor  # [V]
    islanded: torch.Tensor  # [V] bool


class TopoScreen(NamedTuple):
    """The screen operators of one case (:func:`make_topo_screen`)."""

    screen: Callable  # (slots [V,r], flow_limit, p=None) -> TopoScreenResult
    detail: Callable  # same args -> TopoDetail
    n_bus: int
    n_branch: int
    r_max: int


def select_objective(res, objective: str) -> torch.Tensor:
    """The ranking scalar of one screen result (+inf on islanded lanes;
    lower is better for every objective)."""
    if objective == "loss":
        ob = res.loss
    elif objective == "max_flow":
        ob = res.worst_flow
    elif objective == "violations":
        ob = res.violations
    else:
        raise ValueError(
            f"unknown objective {objective!r} "
            f"(have: {', '.join(TOPO_OBJECTIVES)})"
        )
    return torch.where(res.islanded, torch.full_like(ob, math.inf), ob)


class ChunkVerdict(NamedTuple):
    """One screened chunk's ranking vector + exclusion accounting — the
    shared per-chunk ladder of the sync engine and the sweep loop, so
    masking, objective and accounting cannot drift between them.

    The counts (0-d device tensors) partition the chunk's valid lanes
    exactly: ``feasible + disconnected + nonradial + islanded == valid
    count`` — ``islanded`` counts the lanes only the SMW singular-
    capacitance backstop excluded (structurally connected/radial but
    numerically singular; 0 whenever the structural check catches
    everything).
    """

    objective: torch.Tensor  # [V] ranking scalar; +inf = excluded
    screen: TopoScreenResult
    radiality: RadialityResult
    feasible: torch.Tensor  # [] lanes with a finite objective
    disconnected: torch.Tensor  # [] structural connectivity fires
    nonradial: torch.Tensor  # [] connected but not a tree (radial mode)
    islanded: torch.Tensor  # [] SMW backstop fires ALONE (see above)


def screen_chunk(ts: TopoScreen, rad_check, slots, valid, mode: str,
                 objective: str, flow_limit) -> ChunkVerdict:
    """Run one ``[V, r]`` slot block through the screen ladder:
    structural radiality/connectivity check, rank-r SMW lanes, and the
    mode/objective composition.  ``valid`` masks pad rows out of every
    count and out of the ranking (their objective is +inf)."""
    rr = rad_check(slots)
    res = ts.screen(slots, flow_limit=flow_limit)
    valid = torch.as_tensor(valid, dtype=torch.bool,
                            device=rr.connected.device)
    structural = rr.connected & valid
    if mode == "radial":
        structural = structural & rr.radial
    obj = torch.where(structural & ~res.islanded,
                      select_objective(res, objective),
                      torch.full_like(res.loss, math.inf))
    nonradial = (
        (rr.connected & ~rr.radial & valid).sum() if mode == "radial"
        else torch.zeros((), dtype=torch.int64, device=valid.device)
    )
    return ChunkVerdict(
        objective=obj,
        screen=res,
        radiality=rr,
        feasible=torch.isfinite(obj).sum(),
        disconnected=(~rr.connected & valid).sum(),
        nonradial=nonradial,
        islanded=(res.islanded & structural).sum(),
    )


def z_transpose(sys: BusSystem, lu, op: tk.TopoOperands) -> torch.Tensor:
    """Zᵀ ``[m, n]``: ``Z = B′⁻¹A`` for every branch's masked update
    column ``a_k = e_f·mask_f − e_t·mask_t``, one multi-RHS
    ``torch.linalg.lu_solve`` on the pair ``lu`` — per-variant work is then
    pure gathers.  Kept transposed, so a lane reads its r columns as r
    contiguous rows."""
    n, m = sys.n_bus, sys.n_branch
    rhs = np.zeros((n, m), np.float64)
    rhs[np.asarray(sys.from_bus), np.arange(m)] += op.mask_f.cpu().numpy()
    rhs[np.asarray(sys.to_bus), np.arange(m)] -= op.mask_t.cpu().numpy()
    z = torch.linalg.lu_solve(*lu, torch.as_tensor(rhs,
                                                   device=op.f.device))
    return z.mT.contiguous()


def make_topo_screen(
    sys: BusSystem,
    r_max: int,
    dtype: torch.dtype = torch.float64,
    lu=None,
    device: DeviceLike = None,
    plain: bool = False,
    mesh=None,
) -> TopoScreen:
    """Factorize B′ once (or adopt a ``torch.linalg.lu_factor`` pair
    ``lu`` — the serving cache's B′ half, the contract of
    :func:`freedm_tpu_torch.pf.dc.make_dc_solver`), solve the masked
    incidence columns of EVERY branch in one multi-RHS pass (``Z =
    B′⁻¹A``, kept as Zᵀ ``[m, n]``), and build the rank-``r_max`` SMW
    screen lanes on ``device`` (``cuda`` unless the CPU is asked for),
    float64.

    ``screen(slots, flow_limit, p=None)``: ``slots`` is ``[V, r_max]``
    int branch indices (``-1`` pads; rank 0 = the base case), returning
    the three objective columns plus the islanding flag (T2 SCREEN);
    ``detail`` additionally returns per-variant angles and flows (T2
    DETAIL).  Each call solves θ0 from ``p`` (the case's injections by
    default) with one ``torch.linalg.lu_solve``.  ``plain=True`` runs
    T2's plain version on any device.  The ``mesh=`` form is not ported
    and raises.
    """
    if not 1 <= int(r_max) <= MAX_TOPO_RANK:
        raise ValueError(
            f"r_max must be in [1, {MAX_TOPO_RANK}], got {r_max}"
        )
    if mesh is not None:
        raise NotImplementedError(
            "the mesh-sharded topology screen is not ported (ROADMAP.md, "
            "module queue item 16: multi-GPU lane sharding)"
        )
    if dtype != torch.float64:
        raise TypeError(f"the topology screen runs in float64, got {dtype}")
    r_max = int(r_max)
    dev = resolve_device(device)
    n, m = sys.n_bus, sys.n_branch
    parts = decoupled_parts(sys, dtype=dtype, device=dev)
    th_free = parts.th_free
    op = topo_operands(sys, device=dev)
    p0 = torch.as_tensor(np.asarray(sys.p_inj, np.float64), device=dev)
    if lu is None:
        lu = torch.linalg.lu_factor(parts.b_prime(None))
    lu_mat, piv = lu

    zt = z_transpose(sys, lu, op)
    screen_fn = tk.topo_screen_plain if plain else tk.topo_screen

    def _coerce(slots, limit, p):
        sl = torch.as_tensor(slots, dtype=torch.int32, device=dev)
        if sl.dim() != 2 or sl.shape[1] != r_max:
            raise ValueError(
                f"slots must be [V, {r_max}] (this screen's r_max; pad "
                f"unused columns with -1), got {tuple(sl.shape)}"
            )
        pj = p0 if p is None else torch.as_tensor(p, dtype=dtype, device=dev)
        rhs_p = torch.where(th_free > 0, pj, torch.zeros_like(pj))
        theta0 = torch.linalg.lu_solve(lu_mat, piv, rhs_p[:, None])[:, 0]
        return sl.contiguous(), float(limit), theta0.contiguous()

    def screen(slots, flow_limit=0.0, p=None) -> TopoScreenResult:
        sl, lim, theta0 = _coerce(slots, flow_limit, p)
        out = screen_fn(zt, theta0, sl, lim, op, tk.SCREEN)
        return TopoScreenResult(loss=out.loss, worst_flow=out.worst_flow,
                                violations=out.violations,
                                islanded=out.islanded)

    def detail(slots, flow_limit=0.0, p=None) -> TopoDetail:
        sl, lim, theta0 = _coerce(slots, flow_limit, p)
        out = screen_fn(zt, theta0, sl, lim, op, tk.DETAIL)
        return TopoDetail(theta=out.theta, flows=out.flows, loss=out.loss,
                          worst_flow=out.worst_flow,
                          violations=out.violations, islanded=out.islanded)

    return TopoScreen(screen=screen, detail=detail, n_bus=n, n_branch=m,
                      r_max=r_max)


# ---------------------------------------------------------------------------
# Top-k merge (the screen-lane accumulator)
# ---------------------------------------------------------------------------


def make_topk_merge(r_max: int, k: int, device: DeviceLike = None):
    """The running-shortlist merge on ``device``: the carried best-``k``
    (objective, slots, global id) triples are concatenated with a
    chunk's lanes, stably sorted by objective
    (``torch.sort(stable=True)``, the reference's one ``argsort``), and
    truncated back to ``k``.

    Stability is the resume-exactness lever: equal objectives keep
    concatenation order, carried entries precede the chunk's lanes, and
    lanes arrive in global-id order — so the merged shortlist is
    independent of how the variant list was chunked.
    """
    r_max = int(r_max)
    k = int(k)
    dev = resolve_device(device)

    def merge(best_obj, best_slots, best_gid, obj, slots, gid):
        all_obj = torch.cat([best_obj, obj])
        all_slots = torch.cat([best_slots, slots])
        all_gid = torch.cat([best_gid, gid])
        order = torch.sort(all_obj, stable=True).indices[:k]
        return all_obj[order], all_slots[order], all_gid[order]

    def init():
        return (
            torch.full((k,), math.inf, dtype=torch.float64, device=dev),
            torch.full((k, r_max), -1, dtype=torch.int32, device=dev),
            torch.full((k,), -1, dtype=torch.int32, device=dev),
        )

    merge.init = init
    return merge


# ---------------------------------------------------------------------------
# AC verification of the shortlist (sparse backend)
# ---------------------------------------------------------------------------


def make_ac_verifier(
    sys: BusSystem,
    k: int,
    max_iter: int = 30,
    dtype: torch.dtype = torch.float64,
    precision: str = "auto",
    device: DeviceLike = None,
    plain: bool = False,
):
    """The shortlist verifier: ``k`` status-traced sparse Newton lanes
    (one Jacobian pattern, one preconditioner, shared by every lane),
    warm-started from the base-case solution, which is solved once here —
    the same screen-then-verify ladder the DC-prefiltered N-1 screen uses,
    with per-lane branch-status vectors so simultaneous flips verify.

    ``verify(status)`` takes ``[k, m]`` status rows (0 = open) and
    returns a lane-batched :class:`~freedm_tpu_torch.pf.newton.
    NewtonResult` (one batched solve).  ``precision="auto"`` is mixed on
    the card and f64 on the CPU.  Callers must feed it feasible
    (non-islanding) variants only — the AC lanes assume connectivity.
    """
    from freedm_tpu_torch.pf.sparse import make_sparse_newton_solver

    dev = resolve_device(device)
    n, m = sys.n_bus, sys.n_branch
    solve, _ = make_sparse_newton_solver(
        sys, max_iter=max_iter, dtype=dtype, precision=precision,
        device=dev, plain=plain,
    )
    base = solve()
    k = int(k)
    base_v = base.v.expand(k, n)
    base_th = base.theta.expand(k, n)

    def verify(status):
        status = torch.as_tensor(status, dtype=dtype, device=dev)
        if status.dim() != 2 or status.shape[0] != k:
            raise ValueError(
                f"status must be [{k}, {m}] (this verifier's lane count), "
                f"got {tuple(status.shape)}"
            )
        return solve(status=status, v0=base_v, theta0=base_th)

    verify.base = base
    return verify


#: Per-process cache of sweep verifiers keyed (case, k, device, plain): a
#: long-lived jobs server must not pay the sparse-Newton build and the
#: base solve again for every completed sweep of the same case/shortlist
#: size (the sync engine builds its verifier once per engine).
_AC_VERIFIER_CACHE: dict = {}
_AC_VERIFIER_CACHE_MAX = 8


def _cached_ac_verifier(case: str, sys_, k: int, device: DeviceLike = None,
                        plain: bool = False):
    dev = resolve_device(device)
    key = (case, int(k), str(dev), bool(plain))
    fn = _AC_VERIFIER_CACHE.get(key)
    if fn is None:
        fn = make_ac_verifier(sys_, k=k, device=dev, plain=plain)
        if len(_AC_VERIFIER_CACHE) >= _AC_VERIFIER_CACHE_MAX:
            _AC_VERIFIER_CACHE.pop(next(iter(_AC_VERIFIER_CACHE)))
        _AC_VERIFIER_CACHE[key] = fn
    return fn


def status_from_slots(slots, n_branch: int) -> torch.Tensor:
    """``[V, m]`` float64 status rows (0 = open) from ``[V, r]`` slot rows,
    on the slots' device (out-of-range pad slots dropped)."""
    sl = torch.as_tensor(slots).long()
    st = torch.ones(sl.shape[0], n_branch + 1, dtype=torch.float64,
                    device=sl.device)
    st.scatter_(1, torch.where((sl >= 0) & (sl < n_branch), sl, n_branch),
                0.0)
    return st[:, :n_branch]


# ---------------------------------------------------------------------------
# The chunked, checkpointed sweep (jobs API)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TopoSweepSpec:
    """One topology sweep: case + variant space + screening policy.

    ``case`` uses the serving registry's bus-case vocabulary;
    ``switches`` is the candidate branch list (``None`` = every
    branch); ``search`` picks combinatorial enumeration up to
    ``max_rank`` or the seeded ``samples``-sized neighborhood draw.
    ``mesh_devices`` is execution placement only — a checkpoint resumes
    across device counts (same contract as QSTS studies).
    """

    case: str
    switches: Optional[Tuple[int, ...]] = None
    max_rank: int = 2
    mode: str = "mesh"  # mesh | radial
    objective: str = "loss"  # loss | max_flow | violations
    flow_limit: float = 1.0  # pu bar for the violations objective
    top_k: int = 8
    search: str = "exhaustive"  # exhaustive | neighborhood
    samples: int = 0  # neighborhood draw size
    seed: int = 0
    chunk_variants: int = 4096
    ac_verify: bool = True
    mesh_devices: int = 0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if d["switches"] is not None:
            d["switches"] = list(d["switches"])
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TopoSweepSpec":
        d = dict(d)
        if d.get("switches") is not None:
            d["switches"] = tuple(int(s) for s in d["switches"])
        return cls(**d)


def validate_sweep_spec(spec: TopoSweepSpec, n_branch: int) -> None:
    """Range-check one spec against a case's branch table (typed
    ValueError — the jobs layer maps it to ``invalid_request``)."""
    if spec.mode not in TOPO_MODES:
        raise ValueError(
            f"unknown mode {spec.mode!r} (have: {', '.join(TOPO_MODES)})"
        )
    if spec.objective not in TOPO_OBJECTIVES:
        raise ValueError(
            f"unknown objective {spec.objective!r} "
            f"(have: {', '.join(TOPO_OBJECTIVES)})"
        )
    if spec.search not in TOPO_SEARCHES:
        raise ValueError(
            f"unknown search {spec.search!r} "
            f"(have: {', '.join(TOPO_SEARCHES)})"
        )
    if not 1 <= spec.max_rank <= MAX_TOPO_RANK:
        raise ValueError(
            f"max_rank must be in [1, {MAX_TOPO_RANK}], got {spec.max_rank}"
        )
    if spec.search == "neighborhood" and spec.samples < 1:
        raise ValueError("neighborhood search needs samples >= 1")
    if spec.objective == "violations" and not spec.flow_limit > 0:
        raise ValueError("the violations objective needs flow_limit > 0")
    if spec.top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {spec.top_k}")
    if spec.chunk_variants < 1:
        raise ValueError("chunk_variants must be >= 1")
    if spec.switches is not None:
        bad = [s for s in spec.switches
               if not 0 <= int(s) < n_branch]
        if bad:
            raise ValueError(
                f"switch indices must be in [0, {n_branch}), got {bad}"
            )
        if len(set(int(s) for s in spec.switches)) != len(spec.switches):
            raise ValueError("switch list contains duplicates")


def sweep_variants(spec: TopoSweepSpec, n_branch: int) -> np.ndarray:
    """The spec's full (deterministic) variant matrix ``[V, max_rank]``."""
    switches = (
        np.arange(n_branch, dtype=np.int64)
        if spec.switches is None
        else np.asarray(spec.switches, np.int64)
    )
    if spec.search == "neighborhood":
        return neighborhood_variants(
            switches, spec.max_rank, spec.samples, spec.seed
        )
    return enumerate_variants(switches, spec.max_rank)


def _resolve_sweep_case(name: str):
    from freedm_tpu_torch.serve.service import _resolve_bus_case

    return _resolve_bus_case(name)


def run_topo_sweep(
    spec: TopoSweepSpec,
    checkpoint_path: Optional[str] = None,
    resume: bool = True,
    cancel=None,
    on_chunk=None,
    stop_after_chunks: Optional[int] = None,
    lu=None,
    device: DeviceLike = None,
    plain: bool = False,
) -> dict:
    """Run one sweep chunk by chunk; returns the summary dict.

    Mirrors :func:`freedm_tpu_torch.scenarios.engine.run_study`'s
    contract: ``checkpoint_path`` gets an atomic chunk-boundary
    checkpoint (the shortlist + counters, host JSON — placement-free, and
    the reference's format), ``resume=True`` continues a matching killed
    sweep from its last completed chunk bit-for-bit (variant generation is
    a pure function of the spec), ``cancel`` raises
    :class:`SweepCancelled` between chunks, ``stop_after_chunks`` returns
    a partial summary (a simulated kill), and ``on_chunk(done, total,
    chunk_s, variants)`` is the jobs layer's progress hook.  ``lu``
    optionally adopts an existing B′ ``lu_factor`` pair (the serving
    cache's artifact).  The sweep runs on ``device`` (``cuda`` unless the
    CPU is asked for; ``plain=True`` runs the kernels' plain versions),
    with one device-to-host copy a chunk.  ``mesh_devices`` may come to
    one card; more raises (module queue item 16).
    """
    from freedm_tpu_torch.runtime import checkpoint as ckpt

    sys_ = _resolve_sweep_case(spec.case)
    m = sys_.n_branch
    validate_sweep_spec(spec, m)
    if spec.mesh_devices not in (0, 1):
        from freedm_tpu_torch.scenarios.engine import resolve_mesh_devices

        resolve_mesh_devices(spec.mesh_devices)
    variants = sweep_variants(spec, m)
    v_total = int(variants.shape[0])
    if v_total == 0:
        raise ValueError("the spec produces zero variants")
    chunk = int(spec.chunk_variants)
    n_chunks = math.ceil(v_total / chunk)
    dev = resolve_device(device)

    ts = make_topo_screen(sys_, r_max=spec.max_rank, lu=lu, device=dev,
                          plain=plain)
    rad_check = make_radiality_check(sys_, r_max=spec.max_rank, device=dev,
                                     plain=plain)
    merge = make_topk_merge(spec.max_rank, spec.top_k, device=dev)

    best = merge.init()
    counts = {"islanded": 0, "disconnected": 0, "nonradial": 0}
    start_chunk = 0
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        saved = ckpt.load(checkpoint_path)
        if (
            saved.get("version") == CKPT_VERSION
            and isinstance(saved.get("spec"), dict)
            and _placement_free(saved["spec"])
            == _placement_free(spec.to_dict())
        ):
            sb = saved["best"]
            best = (
                torch.as_tensor(np.asarray(sb["objective"], np.float64),
                                device=dev),
                torch.as_tensor(np.asarray(sb["slots"], np.int32),
                                device=dev),
                torch.as_tensor(np.asarray(sb["gid"], np.int32), device=dev),
            )
            counts = {k: int(v) for k, v in saved["counts"].items()}
            start_chunk = int(saved["chunk_index"])

    # The whole variant list goes to the device once, its last chunk
    # padded with repeats of its last row (a real lane, masked out of every
    # count and the ranking): a per-chunk copy from pageable host memory
    # would sync the stream.
    padded = np.concatenate([
        variants,
        np.repeat(variants[-1:], n_chunks * chunk - v_total, axis=0),
    ])
    slots_dev = torch.as_tensor(padded, device=dev)
    # Spans, profiler samples and the roofline dispatch record of the
    # reference's sweep are not ported (ROADMAP.md, module queue item 15).
    return _sweep_loop(
        spec, sys_, v_total, chunk, n_chunks, start_chunk, slots_dev, ts,
        rad_check, merge, best, counts, checkpoint_path, cancel, on_chunk,
        stop_after_chunks, time.monotonic(), dev, plain,
    )


def _pull_chunk(verdict: ChunkVerdict, best) -> Tuple[np.ndarray, dict]:
    """The chunk's three exclusion counts and the merged shortlist on the
    host, in one device-to-host copy."""
    best_obj, best_slots, best_gid = best
    k = int(best_obj.shape[0])
    counts = torch.stack([verdict.disconnected, verdict.nonradial,
                          verdict.islanded])
    flat = torch.cat([counts.to(torch.float64), best_obj,
                      best_slots.flatten().to(torch.float64),
                      best_gid.to(torch.float64)]).cpu().numpy()
    slots = flat[3 + k:-k].reshape(k, -1).astype(np.int32)
    return flat[:3].astype(np.int64), {
        "objective": flat[3:3 + k].tolist(),
        "slots": slots.tolist(),
        "gid": flat[-k:].astype(np.int32).tolist(),
    }


def _host_best(best) -> dict:
    obj, slots, gid = (x.cpu().numpy() for x in best)
    return {"objective": obj.astype(np.float64).tolist(),
            "slots": slots.astype(np.int32).tolist(),
            "gid": gid.astype(np.int32).tolist()}


def _sweep_loop(spec, sys_, v_total, chunk, n_chunks, start_chunk,
                slots_dev, ts, rad_check, merge, best, counts,
                checkpoint_path, cancel, on_chunk, stop_after_chunks,
                t_start, dev, plain):
    from freedm_tpu_torch.runtime import checkpoint as ckpt

    screened = 0
    done_this_call = 0
    best_host = None
    lane_ids = torch.arange(chunk, dtype=torch.int32, device=dev)
    for kc in range(start_chunk, n_chunks):
        if cancel is not None and cancel.is_set():
            raise SweepCancelled(f"cancelled before chunk {kc}")
        v0, v1 = kc * chunk, min(v_total, (kc + 1) * chunk)
        real = v1 - v0
        c0 = time.monotonic()
        sl = slots_dev[v0:v0 + chunk]
        verdict = screen_chunk(ts, rad_check, sl, lane_ids < real, spec.mode,
                               spec.objective, spec.flow_limit)
        best = merge(*best, verdict.objective, sl, lane_ids + v0)
        # The chunk-exit pull (the designed host boundary): counters and
        # the checkpointed shortlist are host values from here.
        excl, best_host = _pull_chunk(verdict, best)
        counts["disconnected"] += int(excl[0])
        counts["nonradial"] += int(excl[1])
        counts["islanded"] += int(excl[2])
        chunk_s = time.monotonic() - c0
        screened += real
        obs.TOPO_VARIANTS.inc(real)
        obs.TOPO_SCREEN_SECONDS.observe(chunk_s)
        if chunk_s > 0:
            obs.TOPO_RATE.set(real / chunk_s)
        if checkpoint_path:
            ckpt.save(checkpoint_path, {
                "version": CKPT_VERSION,
                "spec": spec.to_dict(),
                "chunk_index": kc + 1,
                "best": best_host,
                "counts": dict(counts),
            })
        if on_chunk is not None:
            on_chunk(kc + 1, n_chunks, chunk_s, real)
        done_this_call += 1
        if (
            stop_after_chunks is not None
            and done_this_call >= stop_after_chunks
            and kc + 1 < n_chunks
        ):
            partial = _sweep_summary(
                spec, sys_, v_total, counts, best_host,
                wall_s=time.monotonic() - t_start, screened=screened,
            )
            partial["completed"] = False
            partial["chunks_done"] = kc + 1
            partial["chunks_total"] = n_chunks
            partial["resumed_from_chunk"] = start_chunk
            return partial
    if best_host is None:  # resumed past the last chunk: nothing ran
        best_host = _host_best(best)
    summary = _sweep_summary(
        spec, sys_, v_total, counts, best_host,
        wall_s=time.monotonic() - t_start, screened=screened, ac=True,
        device=dev, plain=plain,
    )
    summary["completed"] = True
    summary["chunks_done"] = n_chunks
    summary["chunks_total"] = n_chunks
    summary["resumed_from_chunk"] = start_chunk
    return summary


def _sweep_summary(spec, sys_, v_total, counts, best_host: dict,
                   wall_s: float, screened: int, ac: bool = False,
                   device: DeviceLike = None, plain: bool = False) -> dict:
    """Assemble the sweep summary from the host shortlist; with ``ac=True``
    the feasible shortlist is verified on the sparse AC backend and
    stamped with the host float64 residual of each variant's own
    topology."""
    obj = np.asarray(best_host["objective"], np.float64)
    slots = np.asarray(best_host["slots"], np.int64)
    gids = np.asarray(best_host["gid"], np.int64)
    feasible = np.isfinite(obj)
    shortlist = []
    for i in np.flatnonzero(feasible):
        shortlist.append({
            "open_branches": sorted(
                int(s) for s in slots[i] if s >= 0
            ),
            "gid": int(gids[i]),
            "objective": float(obj[i]),
        })
    out = {
        "case": spec.case,
        "mode": spec.mode,
        "objective": spec.objective,
        "max_rank": spec.max_rank,
        "search": spec.search,
        "variants_total": int(v_total),
        "islanded": int(counts["islanded"]),
        "disconnected": int(counts["disconnected"]),
        "nonradial": int(counts["nonradial"]),
        "mesh_devices": int(spec.mesh_devices) or 1,
        "wall_s": round(float(wall_s), 3),
    }
    if wall_s > 0:
        out["variants_per_sec"] = round(screened / wall_s, 1)
    if ac and spec.ac_verify and shortlist:
        from freedm_tpu_torch.pf.krylov import host_injections

        dev = resolve_device(device)
        k = len(shortlist)
        verifier = _cached_ac_verifier(spec.case, sys_, k, device=dev,
                                       plain=plain)
        status_t = status_from_slots(
            torch.as_tensor(slots[feasible][:k].astype(np.int32),
                            device=dev), sys_.n_branch)
        r = verifier(status_t)
        status = status_t.cpu().numpy()
        v = r.v.cpu().numpy().astype(np.float64)
        theta = r.theta.cpu().numpy().astype(np.float64)
        conv = r.converged.cpu().numpy()
        mism = r.mismatch.cpu().numpy().astype(np.float64)
        th_free = np.asarray(sys_.bus_type) != SLACK
        v_free = np.asarray(sys_.bus_type) == PQ
        p_req = np.asarray(sys_.p_inj, np.float64)
        q_req = np.asarray(sys_.q_inj, np.float64)
        for i, entry in enumerate(shortlist):
            # Host float64 residual against THIS variant's topology —
            # the same oracle discipline as the serve cache's verify.
            p_c, q_c = host_injections(
                sys_, theta[i], v[i], status=status[i]
            )
            fp = np.where(th_free, p_c - p_req, 0.0)
            fq = np.where(v_free, q_c - q_req, 0.0)
            entry.update({
                "ac_converged": bool(conv[i]),
                "ac_residual_pu": float(mism[i]),
                "ac_true_mismatch_pu": float(
                    max(np.max(np.abs(fp)), np.max(np.abs(fq)))
                ),
                "v_min_pu": float(np.min(v[i])),
                "v_max_pu": float(np.max(v[i])),
            })
    out["shortlist"] = shortlist
    return out
