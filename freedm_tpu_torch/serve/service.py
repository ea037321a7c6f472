"""The served power-flow, N-1, Volt-VAR and topology workloads and the
serving facade.

Port of ``freedm_tpu/serve/service.py``:

- **pf** — snapshot AC power flow: a named case plus per-bus injection
  overrides (or a uniform stress ``scale``), solved by the batched Newton
  path, one lane per request: the dense backend
  (:mod:`freedm_tpu_torch.pf.newton`) below 512 buses and the sparse one
  (:mod:`freedm_tpu_torch.pf.sparse`) at and above, under the default
  ``pf_backend="auto"``.
- **n1** — N-1 contingency screen over a subset of branches
  (:mod:`freedm_tpu_torch.pf.n1`): the SMW fast-decoupled screen below
  512 buses, the status-traced sparse screen at and above.  One request
  = ``len(outages)`` lanes; islanding (bridge) outages are rejected at
  validation, because their lanes are singular.
- **vvc** — Volt-VAR what-if: a proposed ``[nb, 3]`` Q-setpoint table
  for a feeder case, answered with the fixed-iteration ladder solve's
  losses (against the zero-injection baseline), voltage extremes and
  band violations; a batch is one launch of the ladder kernel L1 over
  its lanes (:mod:`freedm_tpu_torch.pf.ladder`).
- **topo** — switching screen: enumerate (or neighborhood-sample) the
  open-sets of up to ``max_rank`` candidate switches, screen every variant
  (kernels T1 and T2, :mod:`freedm_tpu_torch.pf.topo`) over the case's B′
  LU — the serving cache's, when the cache is on —, rank them and
  AC-verify the ``top_k`` shortlist on the sparse backend.  One request =
  one sweep.

Every response carries the solver's own convergence evidence
(``residual_pu``/``converged``) plus a conservation check (Σ realized P
= network losses, small and non-negative), so a client never has to
trust a 200 status alone.

:class:`Service` ties the pieces together: synchronous per-request
validation (an invalid request never occupies queue depth), admission
(:mod:`freedm_tpu_torch.serve.queue`), micro-batched dispatch
(:mod:`freedm_tpu_torch.serve.batcher`), one engine per case, and the
incremental cache tier (:mod:`freedm_tpu_torch.serve.cache`, on by
default as in the reference: exact and verified-delta answers complete
at submit time, warm hits seed the full solve).  Not ported yet
(``ROADMAP.md``): provenance receipts, the consistent-cut ledger and the
lane mesh.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time as _time
from concurrent.futures import TimeoutError as _FuturesTimeout
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from freedm_tpu_torch.core import metrics as obs
from freedm_tpu_torch.device import (
    DeviceLike,
    platform_name,
    resolve_device,
    stream_synchronize,
)
from freedm_tpu_torch.grid.bus import PQ
from freedm_tpu_torch.pf.backend import (
    BACKENDS,
    PF_PRECISIONS,
    resolve_backend,
    resolve_precision,
)
from freedm_tpu_torch.pf.ladder import make_ladder_solver, total_loss_kw
from freedm_tpu_torch.pf.newton import make_newton_solver
from freedm_tpu_torch.serve.queue import (
    AdmissionQueue,
    DeadlineExceeded,
    InvalidRequest,
    Overloaded,
    ServeError,
    ShuttingDown,
    Ticket,
)

WORKLOADS = ("pf", "n1", "vvc", "topo")

#: Voltage band for the VVC report, pu (ANSI C84.1 service band).
V_BAND = (0.95, 1.05)


# ---------------------------------------------------------------------------
# Request / response records
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PowerFlowRequest:
    """Snapshot power flow: ``case`` + injection overrides.

    ``p_inj``/``q_inj`` are full per-bus vectors in system pu (length
    ``n_bus``); omitted, the case's stored injections scaled by
    ``scale`` are used.  ``v0``/``theta0`` optionally warm-start the
    Newton iteration from a previous solution; omitted, the flat start
    is used.
    """

    case: str
    p_inj: Optional[Sequence[float]] = None
    q_inj: Optional[Sequence[float]] = None
    v0: Optional[Sequence[float]] = None
    theta0: Optional[Sequence[float]] = None
    scale: float = 1.0
    # Full [n] voltage/angle vectors in the response (off by default).
    return_state: bool = False
    timeout_s: float = 30.0


@dataclass
class BatchInfo:
    """How this request was served — the micro-batching receipt.

    ``tier`` names the incremental-tier path that answered it:
    ``"full"`` = a dispatched device solve (warm-started or not),
    ``"exact"`` = the cached solution verbatim (single-flight followers
    too: they ride the leader's solve and are answered from its
    solution), ``"delta"`` = the residual-verified fast-decoupled
    correction off the cached factorization (``bucket`` 0: no batch was
    dispatched for the cache tiers).
    """

    lanes: int  # real lanes in the dispatched batch (all requests)
    bucket: int  # padded static shape the batch ran at
    queue_ms: float  # admission -> dispatch
    solve_ms: float  # batched solve wall time (shared by the batch)
    tier: str = "full"  # incremental tier: full | exact | delta

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass
class PowerFlowResponse:
    workload: str
    case: str
    scale: float
    converged: bool
    iterations: int
    residual_pu: float
    p_balance_pu: float  # Σ realized P = network losses (small, >= ~0)
    q_balance_pu: float
    v_min_pu: float
    v_max_pu: float
    batch: BatchInfo
    v: Optional[List[float]] = None  # per-bus |V| (return_state=True)
    theta: Optional[List[float]] = None  # per-bus angle, rad

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["batch"] = self.batch.to_dict()
        return d


@dataclass(frozen=True)
class N1Request:
    """Contingency screen over a branch subset (indices into the case's
    branch table; each must be non-islanding)."""

    case: str
    outages: Sequence[int] = ()
    timeout_s: float = 30.0


@dataclass(frozen=True)
class VVCRequest:
    """Volt-VAR what-if: a proposed ``[nb, 3]`` Q-setpoint table (kvar,
    0 where not controlled) for a feeder case."""

    case: str
    q_ctrl_kvar: Sequence[Sequence[float]] = ()
    timeout_s: float = 30.0


@dataclass(frozen=True)
class TopoRequest:
    """Switching screen: enumerate (or neighborhood-sample) open-sets of
    up to ``max_rank`` candidate switches, DC-screen every variant
    through the rank-r SMW lanes over the case's B′ LU, rank by
    ``objective`` (lower is better), and AC-verify the ``top_k``
    shortlist on the sparse backend before answering
    (:mod:`freedm_tpu_torch.pf.topo`).

    ``switches`` is the candidate branch list (``None`` = every
    branch); ``mode="radial"`` additionally requires each surviving
    variant's closed set to be a spanning tree.  Caps: ``max_rank`` ≤
    ``--topo-max-rank``, variant count ≤ ``--topo-max-variants``,
    ``top_k`` ≤ ``--topo-top-k``.
    """

    case: str
    switches: Optional[Sequence[int]] = None
    max_rank: int = 2
    mode: str = "mesh"
    objective: str = "loss"
    flow_limit: float = 1.0
    top_k: int = 4
    search: str = "exhaustive"
    samples: int = 0
    seed: int = 0
    timeout_s: float = 30.0


@dataclass
class N1Response:
    workload: str
    case: str
    outages: List[int]
    converged: List[bool]
    residual_pu: List[float]
    v_min_pu: List[float]
    v_max_pu: List[float]
    worst_residual_pu: float
    all_converged: bool
    batch: BatchInfo

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["batch"] = self.batch.to_dict()
        return d


@dataclass
class VVCResponse:
    workload: str
    case: str
    converged: bool
    residual: float
    loss_kw: float
    loss_base_kw: float  # losses at the zero-injection baseline
    loss_delta_kw: float  # loss_kw - loss_base_kw (negative = improvement)
    v_min_pu: float
    v_max_pu: float
    band_violations: int  # live node-phases outside V_BAND
    batch: BatchInfo

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["batch"] = self.batch.to_dict()
        return d


@dataclass
class TopoResponse:
    """One switching screen's verdict: exclusion accounting (structural
    + SMW backstop), the AC-verified shortlist, and the batch receipt."""

    workload: str
    case: str
    mode: str
    objective: str
    max_rank: int
    n_variants: int
    # The exclusion accounting partitions the variant space exactly:
    # n_feasible + n_disconnected + n_nonradial + n_islanded
    # == n_variants.
    n_feasible: int
    n_islanded: int  # SMW singular-capacitance backstop fired ALONE
    n_disconnected: int  # structural connectivity check fires
    n_nonradial: int  # connected but not a spanning tree (mode=radial)
    shortlist: List[dict]  # open_branches/objective/ac stamps per entry
    all_verified: bool  # every shortlist entry's AC lane converged
    batch: BatchInfo

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["batch"] = self.batch.to_dict()
        return d


# ---------------------------------------------------------------------------
# Case registry
# ---------------------------------------------------------------------------

#: Bus-system cases servable by pf/n1 (MATPOWER builtins).
BUS_CASES = ("case14", "case_ieee30")
#: Feeder cases servable by vvc.
FEEDER_CASES = ("vvc_9bus",)

#: Cap on the client-named synthetic meshN size: the case name is
#: attacker-controlled input, and engine builds cost O(n^2) memory.
MAX_MESH_BUSES = 2000


def _resolve_bus_case(name: str):
    if name in BUS_CASES:
        from freedm_tpu_torch.grid.matpower import load_builtin

        return load_builtin(name)
    if name.startswith("mesh") and name[4:].isdigit():
        # meshN: the synthetic transmission generator at N buses.
        n = int(name[4:])
        if not 2 <= n <= MAX_MESH_BUSES:
            raise InvalidRequest(
                f"meshN size must be in [2, {MAX_MESH_BUSES}], got {n}"
            )
        from freedm_tpu_torch.grid.cases import synthetic_mesh

        return synthetic_mesh(n, seed=1, load_mw=10.0, chord_frac=1.0)
    raise InvalidRequest(
        f"unknown bus case {name!r} (have: {', '.join(BUS_CASES)}, meshN)"
    )


def _resolve_feeder_case(name: str):
    if name in FEEDER_CASES:
        from freedm_tpu_torch.grid import cases

        return getattr(cases, name)()
    raise InvalidRequest(
        f"unknown feeder case {name!r} (have: {', '.join(FEEDER_CASES)})"
    )


def _pad_rows(arr: np.ndarray, bucket: int) -> np.ndarray:
    """Pad a stacked batch up to its bucket by repeating the last row —
    a real, convergent lane, so padding can never poison batch numerics."""
    pad = bucket - arr.shape[0]
    if pad <= 0:
        return arr
    return np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])


def _as_vector(val, n: int, what: str) -> np.ndarray:
    arr = np.asarray(val, np.float64)
    if arr.shape != (n,):
        raise InvalidRequest(f"{what} must be a length-{n} vector, got shape {arr.shape}")
    if not np.all(np.isfinite(arr)):
        raise InvalidRequest(f"{what} contains non-finite values")
    return arr


# ---------------------------------------------------------------------------
# Engines: one solver front per (workload, case)
# ---------------------------------------------------------------------------


class _Engine:
    """Common engine shape the batcher drives.

    ``validate`` runs on the submitter's thread (before admission);
    ``assemble`` runs on the batch-assembly lane; ``solve``/``scatter``
    run on the workload's executor lane (or inline on the dispatch
    thread at ``pipeline_depth=0``).  ``solve`` returns device tensors;
    the batcher waits for the device once, at its measurement boundary
    (:meth:`synchronize`), and ``scatter`` pulls the results to the host
    and returns what the engine's ``publish`` hook (if any) takes.
    """

    workload = ""

    def __init__(self, case: str, device: torch.device):
        self.case = case
        self.key = (self.workload, case)
        self.device = device
        self.compiled_buckets: set = set()
        self.pf_backend: Optional[str] = None
        self.pf_precision: Optional[str] = None
        # Set by Service.engine() when a cache is configured: the
        # scatter-side callback the batcher feeds converged solutions
        # (and flight settlements) into.
        self.publish = None

    def validate(self, req):  # -> prepared payload (host arrays)
        raise NotImplementedError

    def example_request(self):
        """A minimal valid request — what :meth:`Service.prewarm` pushes
        through every bucket at startup."""
        raise NotImplementedError

    def lanes(self, prepared) -> int:
        return 1

    def assemble(self, group: List[Ticket], bucket: int):
        raise NotImplementedError

    def solve(self, batch):
        raise NotImplementedError

    def synchronize(self) -> None:
        """Wait for the engine's device work (the batcher's one sync): the
        stream ``solve`` ran on, not the device, so a delta answer's
        program on a stream of its own neither waits here nor counts in
        the solve time."""
        stream_synchronize(self.device)

    def scatter(self, group: List[Ticket], results, info: BatchInfo):
        raise NotImplementedError


class PowerFlowEngine(_Engine):
    workload = "pf"

    def __init__(self, case: str, max_iter: int = 12,
                 backend: str = "auto", precision: str = "auto",
                 device: DeviceLike = None):
        super().__init__(case, resolve_device(device))
        sys_ = _resolve_bus_case(case)
        self._sys = sys_  # the serving cache keys its entry off this
        self.pf_backend = resolve_backend(backend, sys_.n_bus)
        # Only the sparse backend has a reduced-precision inner solve;
        # the dense LU runs in the working dtype.
        inner = resolve_precision(precision, platform_name(self.device))
        self.pf_precision = inner if self.pf_backend == "sparse" else "f64"
        # Cache attach points, set by Service.engine() when a cache is
        # configured: the cache key's backend, and the topology digest
        # computed once (BusSystem is frozen), so per-request entry
        # resolution is a dict probe, not an O(n + m) hash.
        self.cache_backend: Optional[str] = None
        self.cache_topo: Optional[str] = None
        self.n_bus = sys_.n_bus
        self._p0 = np.asarray(sys_.p_inj, np.float64)
        self._q0 = np.asarray(sys_.q_inj, np.float64)
        # Flat start (the solver's own default): PQ magnitudes at 1.0,
        # pinned buses at their setpoint, zero angles.
        bt = np.asarray(sys_.bus_type)
        self._v0_flat = np.where(
            bt == PQ, 1.0, np.asarray(sys_.v_set, np.float64)
        )
        self._theta0_flat = np.zeros(self.n_bus)
        # The while-loop solve: per-lane iteration counts are real
        # (converged lanes stop updating), so `iterations` shows what a
        # warm start saves.
        self._solve, _ = make_newton_solver(
            sys_, max_iter=max_iter, dtype=torch.float64, backend=backend,
            precision=precision, device=self.device,
        )

    def solve(self, batch):
        # Host -> device copies, then the batched Newton solve.  Returns
        # device tensors; the batcher synchronizes once, at its
        # measurement boundary.
        p, q, v0, th0 = (
            torch.as_tensor(a, dtype=torch.float64).to(self.device,
                                                        non_blocking=True)
            for a in batch
        )
        return self._solve(p_inj=p, q_inj=q, v0=v0, theta0=th0)

    def example_request(self):
        return PowerFlowRequest(case=self.case)

    def validate(self, req: PowerFlowRequest):
        if not (math.isfinite(req.scale) and 0.0 < req.scale <= 10.0):
            raise InvalidRequest(f"scale must be in (0, 10], got {req.scale!r}")
        p = (
            _as_vector(req.p_inj, self.n_bus, "p_inj")
            if req.p_inj is not None
            else self._p0 * req.scale
        )
        q = (
            _as_vector(req.q_inj, self.n_bus, "q_inj")
            if req.q_inj is not None
            else self._q0 * req.scale
        )
        if req.v0 is not None:
            v0 = _as_vector(req.v0, self.n_bus, "v0")
            if np.any(v0 < 0.1) or np.any(v0 > 2.0):
                raise InvalidRequest(
                    "v0 magnitudes must be in [0.1, 2.0] pu"
                )
        else:
            v0 = self._v0_flat
        if req.theta0 is not None:
            th0 = _as_vector(req.theta0, self.n_bus, "theta0")
            if np.any(np.abs(th0) > 2.0 * np.pi):
                raise InvalidRequest("theta0 angles must be within ±2π rad")
        else:
            th0 = self._theta0_flat
        if req.v0 is not None or req.theta0 is not None:
            obs.SERVE_WARM_START.inc()
        return {"p": p, "q": q, "v0": v0, "th0": th0}

    def assemble(self, group: List[Ticket], bucket: int):
        p = _pad_rows(np.stack([t.prepared["p"] for t in group]), bucket)
        q = _pad_rows(np.stack([t.prepared["q"] for t in group]), bucket)
        v0 = _pad_rows(np.stack([t.prepared["v0"] for t in group]), bucket)
        th0 = _pad_rows(np.stack([t.prepared["th0"] for t in group]), bucket)
        return p, q, v0, th0

    def scatter(self, group: List[Ticket], r, info: BatchInfo):
        """Answer the batch's tickets; returns the host arrays ``(v,
        theta, p, q, iterations, converged, mismatch)`` the ``publish``
        hook takes."""
        v = r.v.cpu().numpy()
        theta = r.theta.cpu().numpy()
        p = r.p.cpu().numpy()
        q = r.q.cpu().numpy()
        its = r.iterations.cpu().numpy()
        conv = r.converged.cpu().numpy()
        mism = r.mismatch.cpu().numpy()
        # Record the served lanes' iteration counts on the pf metrics.
        obs.PF_ITERATIONS.labels("newton").observe(its[: len(group)])
        obs.PF_RESIDUAL.labels("newton").set(float(mism[: len(group)].max()))
        p_bal = p.sum(axis=1)
        q_bal = q.sum(axis=1)
        v_min = v.min(axis=1)
        v_max = v.max(axis=1)
        for i, t in enumerate(group):
            want_state = bool(t.request.return_state)
            t.future.set_result(PowerFlowResponse(
                workload="pf",
                case=self.case,
                scale=float(t.request.scale),
                converged=bool(conv[i]),
                iterations=int(its[i]),
                residual_pu=float(mism[i]),
                p_balance_pu=float(p_bal[i]),
                q_balance_pu=float(q_bal[i]),
                v_min_pu=float(v_min[i]),
                v_max_pu=float(v_max[i]),
                v=np.round(v[i], 9).tolist() if want_state else None,
                theta=np.round(theta[i], 9).tolist() if want_state else None,
                batch=info,
            ))
        return v, theta, p, q, its, conv, mism


class N1Engine(_Engine):
    workload = "n1"

    #: Validation cap on outages per request.
    MAX_OUTAGES = 256

    def __init__(self, case: str, max_iter: int = 24, backend: str = "auto",
                 precision: str = "auto", device: DeviceLike = None):
        super().__init__(case, resolve_device(device))
        from freedm_tpu_torch.pf.n1 import make_n1_screen, secure_outages

        sys_ = _resolve_bus_case(case)
        self.pf_backend = resolve_backend(backend, sys_.n_bus)
        inner = resolve_precision(precision, platform_name(self.device))
        self.pf_precision = inner if self.pf_backend == "sparse" else "f64"
        self.n_branch = sys_.n_branch
        self._secure = sorted(secure_outages(sys_))
        self._secure_set = frozenset(self._secure)
        self._screen = make_n1_screen(sys_, max_iter=max_iter,
                                      backend=backend, precision=precision,
                                      device=self.device)

    def validate(self, req: N1Request):
        ks = list(req.outages)
        if not ks:
            raise InvalidRequest(
                "outages must be a non-empty list of branch indices")
        if len(ks) > self.MAX_OUTAGES:
            raise InvalidRequest(
                f"at most {self.MAX_OUTAGES} outages per request, got "
                f"{len(ks)}"
            )
        bad = [
            k for k in ks
            if not (isinstance(k, (int, np.integer)) and 0 <= k < self.n_branch)
        ]
        if bad:
            raise InvalidRequest(
                f"outage indices must be ints in [0, {self.n_branch}), got "
                f"{bad}"
            )
        islanding = [k for k in ks if k not in self._secure_set]
        if islanding:
            raise InvalidRequest(
                f"outages {islanding} island the network (bridge branches); "
                f"their screen lanes would be singular"
            )
        return {"ks": np.asarray(ks, np.int64)}

    def lanes(self, prepared) -> int:
        return int(prepared["ks"].shape[0])

    def assemble(self, group: List[Ticket], bucket: int):
        ks = np.concatenate([t.prepared["ks"] for t in group])
        if ks.shape[0] < bucket:
            # Pad with replicas of the first requested outage: a real
            # non-islanding lane the screen solves anyway.
            ks = np.concatenate(
                [ks, np.full(bucket - ks.shape[0], ks[0], np.int64)]
            )
        return ks

    def solve(self, batch):
        return self._screen(batch)  # device tensors; the batcher syncs

    def example_request(self):
        return N1Request(case=self.case, outages=[self._secure[0]])

    def scatter(self, group: List[Ticket], r, info: BatchInfo):
        v = r.v.cpu().numpy()
        conv = r.converged.cpu().numpy()
        mism = r.mismatch.cpu().numpy()
        off = 0
        for t in group:
            k = int(t.prepared["ks"].shape[0])
            sl = slice(off, off + k)
            off += k
            res = mism[sl].astype(np.float64).tolist()
            t.future.set_result(N1Response(
                workload="n1",
                case=self.case,
                outages=t.prepared["ks"].tolist(),
                converged=conv[sl].tolist(),
                residual_pu=res,
                v_min_pu=v[sl].min(axis=1).astype(np.float64).tolist(),
                v_max_pu=v[sl].max(axis=1).astype(np.float64).tolist(),
                worst_residual_pu=max(res),
                all_converged=bool(conv[sl].all()),
                batch=info,
            ))
        return None


class VVCEngine(_Engine):
    workload = "vvc"

    def __init__(self, case: str, pf_iters: int = 20, backend: str = "auto",
                 precision: str = "auto", device: DeviceLike = None):
        # ``backend``/``precision`` are accepted for engine-construction
        # uniformity; the ladder sweep has no Jacobian and no Krylov
        # inner, so both are no-ops here.
        super().__init__(case, resolve_device(device))
        feeder = _resolve_feeder_case(case)
        self._feeder = feeder
        self.nb = feeder.n_branches
        mask = np.asarray(feeder.phase_mask, np.float64)
        self._mask = mask
        # Live node-phases incl. the always-3-phase substation row — the
        # denominator of the voltage-band report.
        live = np.concatenate([np.ones((1, 3)), mask]) > 0
        # As flat indices: a boolean-mask gather on the card would sync.
        self._live = torch.as_tensor(np.flatnonzero(live), device=self.device)
        _, self._solve_fixed = make_ladder_solver(
            feeder, max_iter=pf_iters, dtype=torch.float64,
            device=self.device)

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   dtype=torch.float64, device=self.device)

        self._s_re, self._s_im = t(feeder.s_load.real), t(feeder.s_load.imag)
        self._mask_t = t(mask)
        base = self._solve_fixed(feeder.s_load)
        self.loss_base_kw = float(total_loss_kw(feeder, base))

    def validate(self, req: VVCRequest):
        q = np.asarray(req.q_ctrl_kvar, np.float64)
        if q.shape != (self.nb, 3):
            raise InvalidRequest(
                f"q_ctrl_kvar must be [{self.nb}, 3] (kvar per node-phase), "
                f"got shape {q.shape}"
            )
        if not np.all(np.isfinite(q)):
            raise InvalidRequest("q_ctrl_kvar contains non-finite values")
        dead = (self._mask == 0) & (q != 0)
        if dead.any():
            raise InvalidRequest(
                f"q_ctrl_kvar proposes injection on {int(dead.sum())} dead "
                f"node-phase(s) (phase does not exist there)"
            )
        return {"q": q}

    def assemble(self, group: List[Ticket], bucket: int):
        return _pad_rows(np.stack([t.prepared["q"] for t in group]), bucket)

    def solve(self, batch):
        # One L1 launch over the bucket's lanes, then the loss and the
        # band report as torch reductions; device tensors, the batcher
        # syncs.  Injecting Q reduces the load's Q draw.
        q = torch.as_tensor(batch, dtype=torch.float64).to(
            self.device, non_blocking=True)
        s_im = self._s_im - q * self._mask_t
        res = self._solve_fixed((self._s_re.expand_as(s_im), s_im))
        loss = total_loss_kw(self._feeder, res)
        vm = res.v_node.abs().flatten(1)[:, self._live]  # [b, n_live]
        viols = ((vm < V_BAND[0]) | (vm > V_BAND[1])).sum(dim=1)
        return (loss, vm.amin(dim=1), vm.amax(dim=1), viols, res.converged,
                res.residual)

    def example_request(self):
        return VVCRequest(case=self.case, q_ctrl_kvar=np.zeros((self.nb, 3)))

    def scatter(self, group: List[Ticket], out, info: BatchInfo) -> None:
        loss, v_min, v_max, viols, conv, residual = (
            x.cpu().numpy() for x in out)
        for i, t in enumerate(group):
            t.future.set_result(VVCResponse(
                workload="vvc",
                case=self.case,
                converged=bool(conv[i]),
                residual=float(residual[i]),
                loss_kw=float(loss[i]),
                loss_base_kw=self.loss_base_kw,
                loss_delta_kw=float(loss[i]) - self.loss_base_kw,
                v_min_pu=float(v_min[i]),
                v_max_pu=float(v_max[i]),
                band_violations=int(viols[i]),
                batch=info,
            ))
        return None


class TopoEngine(_Engine):
    """The switching-screen workload: one request = one full variant
    sweep (enumerate → radiality check T1 → SMW screen T2 → top-k select
    → AC verify), dispatched as a single lane through the micro-batcher.

    With the serving cache on, :meth:`Service.engine` hands this engine
    the case's already-factorized B′ LU pair (:meth:`attach_cache_lu`), so
    a served case pays no second factorization.  Variant counts are
    shape-bucketed (powers of two up to the cap), as in the reference.
    """

    workload = "topo"

    def __init__(self, case: str, backend: str = "auto",
                 precision: str = "auto", max_rank: int = 2,
                 max_variants: int = 20000, top_k: int = 8,
                 device: DeviceLike = None):
        super().__init__(case, resolve_device(device))
        from freedm_tpu_torch.pf.topo import MAX_TOPO_RANK

        sys_ = _resolve_bus_case(case)
        self._sys = sys_
        self.n_branch = sys_.n_branch
        self.max_rank = min(int(max_rank), MAX_TOPO_RANK)
        self.max_variants = int(max_variants)
        self.top_k = max(int(top_k), 1)
        self._precision = precision
        self._lu = None  # serving-cache B′ LU pair (attach_cache_lu)
        self._built = False
        self._build_lock = threading.Lock()
        # Variant-lane shape buckets: powers of two up to the variant cap.
        b, buckets = 1, []
        while b < self.max_variants:
            buckets.append(b)
            b *= 2
        buckets.append(self.max_variants)
        self._vbuckets = tuple(sorted(set(buckets)))

    def attach_cache_lu(self, lu) -> None:
        """Adopt a cached B′ ``lu_factor`` pair (must be called before
        the first solve; the lazily-built screen factorizes its own
        otherwise)."""
        if not self._built:
            self._lu = lu

    def _ensure_built(self) -> None:
        """Build the screen, radiality check and verifier once (on the
        submitter's thread, under a lock so a first-touch herd builds one
        set)."""
        if self._built:
            return
        with self._build_lock:
            if self._built:
                return
            from freedm_tpu_torch.pf import topo as tp

            self._screen = tp.make_topo_screen(
                self._sys, r_max=self.max_rank, lu=self._lu,
                device=self.device,
            )
            self._rad = tp.make_radiality_check(
                self._sys, self.max_rank, device=self.device)
            self._verify = tp.make_ac_verifier(
                self._sys, k=self.top_k, precision=self._precision,
                device=self.device,
            )
            self._built = True

    def example_request(self):
        return TopoRequest(case=self.case, switches=[0], max_rank=1,
                           top_k=1)

    def validate(self, req: TopoRequest):
        from freedm_tpu_torch.pf import topo as tp

        # Build NOW, on the submitter's thread — before the ticket
        # deadline starts — so a first-touch request pays the build like
        # every other engine's first touch, not against its own timeout.
        self._ensure_built()
        # Field/vocabulary validation is the one checker the async path
        # shares (pf/topo.validate_sweep_spec); the engine layers its
        # serving caps (--topo-* flags) on top.
        int_fields = {"max_rank": req.max_rank, "top_k": req.top_k,
                      "samples": req.samples, "seed": req.seed}
        for name, v in int_fields.items():
            if isinstance(v, bool) or not isinstance(v, (int, np.integer)):
                raise InvalidRequest(f"{name!r} must be an integer")
        if isinstance(req.flow_limit, bool) or not isinstance(
            req.flow_limit, (int, float)
        ) or not math.isfinite(req.flow_limit):
            raise InvalidRequest("'flow_limit' must be a finite number")
        if req.switches is not None and (
            not isinstance(req.switches, (list, tuple))
            or not req.switches
            or any(isinstance(k, bool)
                   or not isinstance(k, (int, np.integer))
                   for k in req.switches)
        ):
            raise InvalidRequest(
                "'switches' must be a non-empty list of integer branch "
                "indices (or omitted for the full branch set)"
            )
        try:
            spec = tp.TopoSweepSpec(
                case=self.case,
                switches=(None if req.switches is None
                          else tuple(int(k) for k in req.switches)),
                max_rank=int(req.max_rank), mode=req.mode,
                objective=req.objective,
                flow_limit=float(req.flow_limit), top_k=int(req.top_k),
                search=req.search, samples=int(req.samples),
                seed=int(req.seed),
            )
            tp.validate_sweep_spec(spec, self.n_branch)
        except (TypeError, ValueError) as e:
            raise InvalidRequest(str(e)) from None
        if req.max_rank > self.max_rank:
            raise InvalidRequest(
                f"max_rank must be <= {self.max_rank} "
                f"(--topo-max-rank), got {req.max_rank}"
            )
        if req.top_k > self.top_k:
            raise InvalidRequest(
                f"top_k must be <= {self.top_k} (--topo-top-k), "
                f"got {req.top_k}"
            )
        if spec.search == "neighborhood" and spec.samples > self.max_variants:
            raise InvalidRequest(
                f"neighborhood search needs samples in "
                f"[1, {self.max_variants}], got {spec.samples}"
            )
        if spec.search == "exhaustive":
            n_switch = (self.n_branch if spec.switches is None
                        else len(spec.switches))
            count = tp.count_exhaustive(n_switch, spec.max_rank)
            if count > self.max_variants:
                raise InvalidRequest(
                    f"exhaustive enumeration is {count} variants, over "
                    f"the {self.max_variants} cap (--topo-max-variants); "
                    f"lower max_rank, shrink switches, or use "
                    f"search='neighborhood'"
                )
        variants = tp.sweep_variants(spec, self.n_branch)
        if variants.shape[0] == 0:
            raise InvalidRequest("the request produces zero variants")
        # Pad the rank axis to the engine's r_max: one screen serves every
        # requested rank.
        if variants.shape[1] < self.max_rank:
            variants = np.concatenate([
                variants,
                np.full((variants.shape[0],
                         self.max_rank - variants.shape[1]), -1, np.int32),
            ], axis=1)
        return {
            "variants": variants,
            "mode": req.mode,
            "objective": req.objective,
            "flow_limit": float(req.flow_limit),
            "top_k": int(req.top_k),
        }

    def assemble(self, group: List[Ticket], bucket: int):
        # One request = one sweep; the group shares a dispatch slot but
        # each sweep is its own chain of launches (no padding).
        return [t.prepared for t in group]

    def solve(self, batch):
        # Device work only (screen → top-k select → AC verify); the
        # batcher syncs once, at its measurement boundary.
        self._ensure_built()
        return [self._solve_one(prep) for prep in batch]

    def _solve_one(self, prep):
        from freedm_tpu_torch.pf import topo as tp

        variants = prep["variants"]
        v_real = int(variants.shape[0])
        bucket = next(b for b in self._vbuckets if b >= v_real)
        if v_real < bucket:
            variants = np.concatenate([
                variants,
                np.repeat(variants[-1:], bucket - v_real, axis=0),
            ])
        slots = torch.as_tensor(variants, device=self.device)
        valid = torch.arange(bucket, device=self.device) < v_real
        # The shared per-chunk ladder (pf/topo.screen_chunk): the sync
        # endpoint and the async sweep compose masking, objective and
        # exclusion accounting through this one helper.
        verdict = tp.screen_chunk(
            self._screen, self._rad, slots, valid, prep["mode"],
            prep["objective"], prep["flow_limit"],
        )
        obj = verdict.objective
        # top_k cannot exceed the lane count (a 2-variant request under
        # an 8-deep shortlist cap is legal); the shortlist pads back to
        # the verifier's K with infeasible rows.  A stable ascending sort
        # puts the lower index first among ties, as the reference's
        # lax.top_k(-obj) does (torch.topk promises no order there).
        k_eff = min(self.top_k, int(obj.shape[0]))
        idx = torch.sort(obj, stable=True).indices[:k_eff]
        short_obj = obj[idx]
        short_feas = torch.isfinite(short_obj)
        # Infeasible shortlist slots collapse to the base topology — an
        # islanding/disconnected variant can never reach an AC lane.
        short_slots = torch.where(short_feas[:, None], slots[idx],
                                  torch.full_like(slots[idx], -1))
        short_worst = verdict.screen.worst_flow[idx]
        if k_eff < self.top_k:
            pad = self.top_k - k_eff
            short_obj = torch.cat(
                [short_obj, short_obj.new_full((pad,), math.inf)])
            short_feas = torch.cat([short_feas, short_feas.new_zeros(pad)])
            short_slots = torch.cat([
                short_slots,
                short_slots.new_full((pad, short_slots.shape[1]), -1)])
            short_worst = torch.cat([short_worst,
                                     short_worst.new_zeros(pad)])
        ac = self._verify(tp.status_from_slots(short_slots, self.n_branch))
        return {
            "n_variants": v_real,
            "short_obj": short_obj,
            "short_slots": short_slots,
            "short_feas": short_feas,
            "short_worst": short_worst,
            "ac_converged": ac.converged,
            "ac_mismatch": ac.mismatch,
            "ac_v": ac.v,
            # The exclusion accounting partitions the variant space
            # exactly: feasible + disconnected + nonradial + islanded
            # (the SMW backstop firing ALONE) == n_variants.
            "counts": torch.stack([verdict.feasible, verdict.islanded,
                                   verdict.disconnected, verdict.nonradial]),
        }

    def scatter(self, group: List[Ticket], results,
                info: BatchInfo) -> None:
        for j, t in enumerate(group):
            r = results[j]
            obj = r["short_obj"].cpu().numpy()
            slots = r["short_slots"].cpu().numpy()
            feas = r["short_feas"].cpu().numpy()
            worst = r["short_worst"].cpu().numpy()
            conv = r["ac_converged"].cpu().numpy()
            mism = r["ac_mismatch"].cpu().numpy()
            v = r["ac_v"].cpu().numpy()
            nf, ni, nd, nr = (int(c) for c in r["counts"].cpu().numpy())
            want = int(t.prepared["top_k"])
            shortlist = []
            for i in range(min(want, obj.shape[0])):
                if not feas[i]:
                    break  # trailing slots past the feasible count
                shortlist.append({
                    "open_branches": sorted(
                        int(s) for s in slots[i] if s >= 0
                    ),
                    "objective": float(obj[i]),
                    "worst_flow_pu": float(worst[i]),
                    "ac_converged": bool(conv[i]),
                    "ac_residual_pu": float(mism[i]),
                    "v_min_pu": float(v[i].min()),
                    "v_max_pu": float(v[i].max()),
                })
            n_variants = int(r["n_variants"])
            obs.TOPO_VARIANTS.inc(n_variants)
            t.future.set_result(TopoResponse(
                workload="topo",
                case=self.case,
                mode=t.prepared["mode"],
                objective=t.prepared["objective"],
                max_rank=int(t.request.max_rank),
                n_variants=n_variants,
                n_feasible=nf,
                n_islanded=ni,
                n_disconnected=nd,
                n_nonradial=nr,
                shortlist=shortlist,
                all_verified=bool(
                    all(e["ac_converged"] for e in shortlist)
                ) if shortlist else False,
                batch=info,
            ))
        return None


def _response_from_solution(eng, request: PowerFlowRequest, sol,
                            info: BatchInfo) -> PowerFlowResponse:
    """A pf response from a cached or corrected solution record
    (``CachedSolution``-shaped: host numpy state and stamps) — the same
    fields the scatter path computes, honoring ``return_state``."""
    want_state = bool(request.return_state)
    return PowerFlowResponse(
        workload="pf",
        case=eng.case,
        scale=float(request.scale),
        converged=bool(sol.converged),
        iterations=int(sol.iterations),
        residual_pu=float(sol.mismatch),
        p_balance_pu=float(np.sum(sol.p)),
        q_balance_pu=float(np.sum(sol.q)),
        v_min_pu=float(np.min(sol.v)),
        v_max_pu=float(np.max(sol.v)),
        v=np.round(sol.v, 9).tolist() if want_state else None,
        theta=np.round(sol.theta, 9).tolist() if want_state else None,
        batch=info,
    )


_ENGINE_TYPES = {"pf": PowerFlowEngine, "n1": N1Engine, "vvc": VVCEngine,
                 "topo": TopoEngine}
_REQUEST_TYPES = {"pf": PowerFlowRequest, "n1": N1Request,
                  "vvc": VVCRequest, "topo": TopoRequest}


def parse_request(workload: str, payload: dict):
    """Build the typed request record from a JSON payload, rejecting
    unknown workloads and unknown fields with typed errors."""
    cls = _REQUEST_TYPES.get(workload)
    if cls is None:
        raise InvalidRequest(
            f"unknown workload {workload!r} (have: {', '.join(WORKLOADS)})"
        )
    if not isinstance(payload, dict):
        raise InvalidRequest("request body must be a JSON object")
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(payload) - names
    if unknown:
        raise InvalidRequest(
            f"unknown field(s) {sorted(unknown)} for workload {workload!r}"
        )
    if "case" not in payload:
        raise InvalidRequest("missing required field 'case'")
    try:
        return cls(**payload)
    except TypeError as e:
        raise InvalidRequest(str(e)) from None


# ---------------------------------------------------------------------------
# Service facade
# ---------------------------------------------------------------------------


def default_buckets(max_batch: int) -> Tuple[int, ...]:
    """Powers of two plus their 1.5x intermediates up to (and
    including) ``max_batch`` — the static batch shapes the engines run.
    The intermediates (3, 6, 12, 24, 48, ...) halve the worst-case
    padding waste of the pure power-of-two table (from ~50% of a
    dispatch's lanes to ~33%)."""
    out = set()
    b = 1
    while b < max_batch:
        out.add(b)
        mid = b + b // 2  # the 1.5x intermediate (integer for b >= 2)
        if b >= 2 and mid < max_batch:
            out.add(mid)
        b *= 2
    out.add(int(max_batch))
    return tuple(sorted(out))


def padding_waste_pct(buckets: Tuple[int, ...]) -> float:
    """Worst-case padded-lane share of a bucket table: the maximum,
    over every real lane count up to the largest bucket, of
    ``(bucket - lanes) / bucket`` for the bucket that lane count lands
    in."""
    table = tuple(sorted(set(int(b) for b in buckets)))
    worst = 0.0
    for lanes in range(1, table[-1] + 1):
        bucket = next(b for b in table if b >= lanes)
        worst = max(worst, (bucket - lanes) / bucket)
    return round(100.0 * worst, 2)


class ServeConfig(NamedTuple):
    """Serving knobs.

    ``max_batch`` bounds lanes per dispatch; ``max_wait_ms`` is the
    coalescing window (adaptive: a lone request with an empty queue
    behind it skips it); ``queue_depth`` is the admission bound in lanes
    (beyond it, requests shed with ``overloaded``); ``buckets`` defaults
    to :func:`default_buckets`.  ``device`` is where the engines solve —
    ``cuda`` unless ``"cpu"`` is asked for.  ``mesh_devices`` must stay 0
    or 1 until lane sharding is ported.
    """

    max_batch: int = 64
    max_wait_ms: float = 2.0
    queue_depth: int = 512
    default_timeout_s: float = 30.0
    pf_max_iter: int = 12
    n1_max_iter: int = 24
    vvc_pf_iters: int = 20
    buckets: Optional[Tuple[int, ...]] = None
    mesh_devices: int = 0
    pf_backend: str = "auto"
    pf_precision: str = "auto"
    # Assembled batches buffered per workload's executor lane (0 =
    # single-thread dispatch, the equivalence oracle; 1 = double
    # buffering, the default).
    pipeline_depth: int = 1
    # "workload/case" engines to run through every bucket at startup.
    prewarm: Tuple[str, ...] = ()
    # Incremental serving tier (serve/cache.py; CLI --cache-mb,
    # --cache-ttl-s, --delta-max-rank): byte budget of the
    # per-(case, topology, backend) cache — solutions plus the reusable
    # artifacts (FDLF LU pair, Jacobian pattern); 0 disables the tier.
    # Then the solution TTL, and the largest changed-bus count the delta
    # tier attempts before falling to warm-start seeding.
    cache_mb: float = 64.0
    cache_ttl_s: float = 600.0
    delta_max_rank: int = 16
    # Delta-tier verify override (None = the engine tolerance).  Tests
    # tighten it to force fall-through; never loosen it in service.
    cache_verify_tol: Optional[float] = None
    device: Optional[str] = None
    # Topology sweeps (the topo workload; CLI --topo-max-rank,
    # --topo-max-variants, --topo-top-k): simultaneous flips a variant,
    # variants a sync request, and the AC-verified shortlist's size (the
    # verifier's lane count).
    topo_max_rank: int = 2
    topo_max_variants: int = 20000
    topo_top_k: int = 8

    def bucket_table(self) -> Tuple[int, ...]:
        bs = self.buckets if self.buckets else default_buckets(self.max_batch)
        bs = tuple(sorted(set(int(b) for b in bs)))
        if bs[-1] < self.max_batch:
            bs = bs + (int(self.max_batch),)
        return bs


class Service:
    """The query service: validate → admit → micro-batch → solve →
    scatter.

    ``submit`` returns a :class:`concurrent.futures.Future` resolving to
    a typed response (or raising a :class:`ServeError`); ``request`` is
    the blocking convenience.  Engines are built lazily per
    (workload, case) and kept for the service's lifetime.
    """

    #: Distinct (workload, case) engines one service will build.
    MAX_ENGINES = 32

    def __init__(self, config: ServeConfig = ServeConfig(), start: bool = True):
        from freedm_tpu_torch.serve.batcher import MicroBatcher

        if config.pf_backend not in BACKENDS:
            raise ValueError(
                f"unknown pf_backend {config.pf_backend!r} "
                f"(have: {', '.join(BACKENDS)})"
            )
        if config.pf_precision not in PF_PRECISIONS:
            raise ValueError(
                f"unknown pf_precision {config.pf_precision!r} "
                f"(have: {', '.join(PF_PRECISIONS)})"
            )
        if config.pipeline_depth < 0:
            raise ValueError(
                f"pipeline_depth must be >= 0 (0 = serialized dispatch), "
                f"got {config.pipeline_depth}"
            )
        if config.mesh_devices not in (0, 1):
            raise NotImplementedError(
                "lane sharding over several devices is not ported yet "
                "(ROADMAP.md, module queue item 16); use mesh_devices=0"
            )
        self.config = config
        self.device = resolve_device(config.device)
        # The incremental serving tier (exact/delta/warm answers off
        # cached base-case solutions and factorizations); None = off.
        self.cache = None
        if config.cache_mb and config.cache_mb > 0:
            from freedm_tpu_torch.serve.cache import ServeCache

            self.cache = ServeCache(
                max_bytes=int(config.cache_mb * 1024 * 1024),
                ttl_s=config.cache_ttl_s,
                delta_max_rank=config.delta_max_rank,
                precision=config.pf_precision,
                verify_tol=config.cache_verify_tol,
                device=self.device,
            )
        self._engines: Dict[Tuple[str, str], _Engine] = {}
        # The global lock guards the maps only; engine construction
        # (case load, Ybus stamp) runs under a per-key build lock.
        self._engines_lock = threading.Lock()
        self._build_locks: Dict[Tuple[str, str], threading.Lock] = {}
        self._ok_counters = {
            w: obs.SERVE_REQUESTS.labels(w, "ok") for w in WORKLOADS
        }
        self.queue = AdmissionQueue(
            max_depth=config.queue_depth,
            depth_gauge=obs.SERVE_QUEUE_DEPTH,
            on_expired=self._expire,
        )
        self.batcher = MicroBatcher(self, config)
        if start:
            self.batcher.start()
        if config.prewarm:
            try:
                self.prewarm(config.prewarm)
            except BaseException:
                # The constructor won't return, so nobody could call
                # stop() — don't leak the assembly/executor threads.
                self.batcher.stop()
                raise

    # -- engine cache --------------------------------------------------------
    def engine(self, workload: str, case: str) -> _Engine:
        if workload not in _ENGINE_TYPES:
            raise InvalidRequest(
                f"unknown workload {workload!r} (have: {', '.join(WORKLOADS)})"
            )
        if not isinstance(case, str) or not case:
            raise InvalidRequest("'case' must be a non-empty string")
        key = (workload, case)
        with self._engines_lock:
            eng = self._engines.get(key)
            if eng is not None:
                return eng
            if len(self._engines) >= self.MAX_ENGINES:
                raise InvalidRequest(
                    f"engine cache full ({self.MAX_ENGINES} cases); "
                    f"reuse an already-served case"
                )
            build_lock = self._build_locks.get(key)
            if build_lock is None:
                build_lock = self._build_locks[key] = threading.Lock()
        with build_lock:
            with self._engines_lock:
                eng = self._engines.get(key)
            if eng is not None:  # another submitter built it meanwhile
                return eng
            cfg = self.config
            kwargs = {
                "pf": {"max_iter": cfg.pf_max_iter},
                "n1": {"max_iter": cfg.n1_max_iter},
                "vvc": {"pf_iters": cfg.vvc_pf_iters},
                "topo": {"max_rank": cfg.topo_max_rank,
                         "max_variants": cfg.topo_max_variants,
                         "top_k": cfg.topo_top_k},
            }[workload]
            eng = _ENGINE_TYPES[workload](
                case, backend=cfg.pf_backend, precision=cfg.pf_precision,
                device=self.device, **kwargs,
            )
            if workload == "topo" and self.cache is not None:
                from freedm_tpu_torch.serve.cache import topology_digest

                # The topology screen rides the serving cache's B′ LU: a
                # case already served by pf answers switching sweeps with
                # no second factorization.  A topo-first tenant builds the
                # whole entry (B″ and the pattern too), which a later pf
                # engine of the case reuses; a case over the byte budget
                # gets None, and the engine factorizes B′ itself.
                entry = self.cache.entry(
                    case, eng._sys, resolve_backend(cfg.pf_backend,
                                                    eng._sys.n_bus),
                    topo=topology_digest(eng._sys),
                )
                if entry is not None:
                    eng.attach_cache_lu(entry.precond.bp)
            if workload == "pf" and self.cache is not None:
                from freedm_tpu_torch.serve.cache import topology_digest

                # The backend is part of the cache key (dense and sparse
                # solutions agree only to solver tolerance).  The entry's
                # artifacts are factorized here, inside the engine build
                # lock: first-touch cost, off the steady-state submit path.
                eng.cache_backend = eng.pf_backend
                eng.cache_topo = topology_digest(eng._sys)
                eng.publish = self._publish_pf
                self.cache.entry(case, eng._sys, eng.cache_backend,
                                 topo=eng.cache_topo)
            with self._engines_lock:
                self._engines[key] = eng
            return eng

    # -- prewarm -------------------------------------------------------------
    def prewarm(self, specs: Sequence[str]) -> List[str]:
        """Run every bucket of each ``"workload/case"`` engine named in
        ``specs`` once before traffic arrives.  Each shape is recorded
        in the batcher's prewarm table and never counts on
        ``serve_recompiles_total``.  Returns the
        ``"workload/case:bucket"`` keys run."""
        done: List[str] = []
        for spec in specs:
            workload, sep, case = str(spec).partition("/")
            if not sep or not case:
                raise InvalidRequest(
                    f"prewarm spec must be 'workload/case', got {spec!r}"
                )
            eng = self.engine(workload, case)
            req = eng.example_request()
            prepared = eng.validate(req)
            lanes = eng.lanes(prepared)
            for bucket in self.config.bucket_table():
                if bucket in eng.compiled_buckets or lanes > bucket:
                    continue
                t = Ticket(eng.key, req, prepared, lanes, None)
                eng.solve(eng.assemble([t], bucket))
                eng.synchronize()
                self.batcher.note_prewarmed(eng, bucket)
                done.append(f"{workload}/{case}:{bucket}")
            if workload == "pf" and self.cache is not None \
                    and eng.cache_backend is not None:
                # Build and run the delta program too, so the first
                # delta hit pays a correction, not a build.
                entry = self.cache.entry(case, eng._sys, eng.cache_backend,
                                         topo=eng.cache_topo)
                if entry is not None:
                    self.cache.prewarm_entry(entry)
        return done

    # -- submission ----------------------------------------------------------
    def submit(self, workload: str, request):
        """Validate and admit one request; returns its Future.

        ``request`` may be a typed record or a JSON-shaped dict.  Raises
        :class:`InvalidRequest` / :class:`Overloaded` synchronously —
        an unservable request never occupies queue depth.
        """
        wl = workload if workload in WORKLOADS else "unknown"
        try:
            if isinstance(request, dict):
                request = parse_request(workload, request)
            eng = self.engine(workload, request.case)
            prepared = eng.validate(request)
            lanes = eng.lanes(prepared)
            if lanes > self.config.max_batch:
                raise InvalidRequest(
                    f"request needs {lanes} lanes but max_batch is "
                    f"{self.config.max_batch}; split it"
                )
            timeout = float(getattr(request, "timeout_s", 0) or 0)
        except InvalidRequest:
            obs.SERVE_REQUESTS.labels(wl, "invalid").inc()
            raise
        except (TypeError, ValueError) as e:
            # Wrong-typed field VALUES (e.g. scale="1.1") come out of
            # numpy/float coercion as raw TypeError/ValueError — still
            # the client's fault, still a typed 400.
            obs.SERVE_REQUESTS.labels(wl, "invalid").inc()
            raise InvalidRequest(f"malformed request field: {e}") from None
        if timeout <= 0:
            timeout = self.config.default_timeout_s
        ticket = Ticket(
            key=eng.key, request=request, prepared=prepared, lanes=lanes,
            deadline=_time.monotonic() + timeout,
        )
        # Incremental tier (pf with the cache on): exact and delta hits
        # return a completed future without occupying queue depth or a
        # batch; single-flight followers return a pending future parked
        # on the leader's solve; warm hits seed the prepared arrays and
        # fall through to admission.  A request carrying its own
        # v0/theta0 bypasses the cache both ways: the client is steering
        # the solver (possibly toward another solution branch), so the
        # cache may neither answer it nor serve its solution later.
        if self.cache is not None and workload == "pf" \
                and eng.cache_backend is not None \
                and request.v0 is None and request.theta0 is None:
            try:
                fut = self._cache_tier(eng, ticket)
            except Exception as e:  # noqa: BLE001 — the tier is an
                # optimization: a failing delta build or launch (or any
                # cache-side surprise) must never turn an answerable
                # request into an error — fall through to the full path,
                # counted in serve_cache_errors_total and /stats.
                self.cache.record_error(e)
                fut = None
            if fut is not None:
                return fut
        try:
            self.queue.put(ticket)
        except Overloaded as e:
            obs.SERVE_SHED.inc()
            obs.SERVE_REQUESTS.labels(workload, "overloaded").inc()
            self._abort_flight(ticket, e)
            raise
        except ShuttingDown as e:
            obs.SERVE_REQUESTS.labels(workload, "shutdown").inc()
            self._abort_flight(ticket, e)
            raise
        return ticket.future

    def request(self, workload: str, request,
                timeout_s: Optional[float] = None):
        """Blocking submit: the typed response, or a raised ServeError.

        The wait honors the request's own ``timeout_s`` (plus a margin
        for the in-flight solve, which is never cancelled); an explicit
        ``timeout_s`` argument replaces the record's value; a wait that
        still runs out surfaces as the typed :class:`DeadlineExceeded`.
        """
        if isinstance(request, dict):
            try:
                request = parse_request(workload, request)
            except InvalidRequest:
                wl = workload if workload in WORKLOADS else "unknown"
                obs.SERVE_REQUESTS.labels(wl, "invalid").inc()
                raise
        if timeout_s is not None and hasattr(request, "timeout_s"):
            request = dataclasses.replace(request, timeout_s=float(timeout_s))
        fut = self.submit(workload, request)
        t = float(getattr(request, "timeout_s", 0) or 0)
        if t <= 0:
            t = self.config.default_timeout_s
        wait = t + 10.0
        try:
            return fut.result(timeout=wait)
        except _FuturesTimeout:
            raise DeadlineExceeded(
                f"no result within {wait:.0f}s (the batch may still "
                f"be solving; its result is discarded)"
            ) from None

    # -- incremental serving tier (serve/cache.py) ---------------------------
    def _cache_tier(self, eng, ticket: Ticket):
        """Run one validated pf ticket through the tier ladder.

        Returns the ticket's future when the cache answered (exact or
        verified delta) or parked it on an in-flight leader (single
        flight); returns ``None`` when the ticket must take the full path
        — possibly warm-seeded, and marked as its digest's flight leader
        so an identical herd coalesces onto this one solve.
        """
        from freedm_tpu_torch.serve.cache import (CachedSolution,
                                                  injection_digest)

        cache = self.cache
        entry = cache.entry(eng.case, eng._sys, eng.cache_backend,
                            topo=eng.cache_topo)
        if entry is None:  # case over the byte budget: stays uncached
            return None
        prepared = ticket.prepared
        p, q = prepared["p"], prepared["q"]
        digest = injection_digest(p, q)
        tier, near = cache.lookup(entry, digest, p, q)
        if tier == "exact":
            cache.record("exact")
            return self._respond_cached(eng, ticket, near, "exact", 0.0)
        if tier == "delta":
            t1 = _time.monotonic()
            ans = cache.delta_answer(entry, near, p, q)
            if ans is not None:
                fields = (ans["v"], ans["theta"], ans["p"], ans["q"],
                          ans["iterations"], ans["mismatch"], True)
                sol = cache.insert(entry, digest, p, q, *fields)
                if sol is None:  # entry died mid-answer: serve transient
                    sol = CachedSolution(digest, p, q, *fields)
                cache.record("delta")
                return self._respond_cached(
                    eng, ticket, sol, "delta",
                    round((_time.monotonic() - t1) * 1e3, 3),
                )
            tier = "warm"  # residual fall-through: never served unverified
        # Full-solve path: claim the digest's flight (or join one).
        outcome, late = cache.flight_claim(entry, digest, ticket)
        if outcome == "exact":  # a leader finished while we classified
            cache.record("exact")
            return self._respond_cached(eng, ticket, late, "exact", 0.0)
        if outcome == "joined":
            cache.record("miss")
            return ticket.future
        ticket.cache_flight = (entry.key, digest)
        if tier == "warm" and near is not None:
            # Seed the full solve from the nearest cached solution.
            prepared["v0"] = near.v
            prepared["th0"] = near.theta
            cache.record("warm")
        else:
            cache.record("miss")
        return None

    def _respond_cached(self, eng, ticket: Ticket, sol, tier: str,
                        solve_ms: float):
        """Complete one ticket from a cached or corrected solution — no
        admission, no batch, no device (exact) or one correction
        (delta)."""
        info = BatchInfo(lanes=1, bucket=0, queue_ms=0.0,
                         solve_ms=solve_ms, tier=tier)
        ticket.future.set_result(
            _response_from_solution(eng, ticket.request, sol, info))
        self._complete_ok(ticket, info)
        return ticket.future

    def _publish_pf(self, eng, group: List[Ticket], v, theta, p, q, its,
                    conv, mism, info: BatchInfo) -> None:
        """Scatter-side cache population and single-flight settlement.

        Runs on the executor lane with host arrays only (the scatter
        already pulled them): converged lanes are inserted as cached
        solutions; followers parked on a lane's flight are answered from
        that lane's numbers with an ``exact``-tier receipt.
        """
        cache = self.cache
        from freedm_tpu_torch.serve.cache import (CachedSolution,
                                                  injection_digest)

        # Peek, never build: an invalidated or evicted entry means the
        # in-flight inserts land nowhere, and no factorization may run on
        # the executor lane.
        entry = cache.peek_entry(eng.case, eng.cache_topo,
                                 eng.cache_backend)
        for i, t in enumerate(group):
            fl = t.cache_flight
            if fl is None and (t.request.v0 is not None
                               or t.request.theta0 is not None):
                # Client-steered solve: never published under an
                # injections-only digest.
                continue
            digest = fl[1] if fl is not None else None
            sol = None
            if entry is not None and bool(conv[i]):
                if digest is None:
                    digest = injection_digest(t.prepared["p"],
                                              t.prepared["q"])
                sol = cache.insert(
                    entry, digest, t.prepared["p"], t.prepared["q"],
                    v[i], theta[i], p[i], q[i], int(its[i]),
                    float(mism[i]), True,
                )
            if fl is None:
                continue
            # Settle before clearing the ticket's flight mark: an
            # exception above leaves the mark, so the batcher's error path
            # still aborts the flight and no follower hangs.
            _fentry, followers = cache.settle_flight(fl)
            t.cache_flight = None
            if not followers:
                continue
            if sol is None:  # dead entry or not converged: transient
                sol = CachedSolution(
                    fl[1], t.prepared["p"], t.prepared["q"], v[i],
                    theta[i], p[i], q[i], int(its[i]), float(mism[i]),
                    bool(conv[i]),
                )
            # Followers are answered from the leader's solution — an
            # exact hit in substance, so the receipt matches one.
            finfo = BatchInfo(lanes=1, bucket=0, queue_ms=0.0,
                              solve_ms=0.0, tier="exact")
            for f in followers:
                try:
                    f.future.set_result(
                        _response_from_solution(eng, f.request, sol, finfo))
                    self._complete_ok(f, finfo)
                except Exception as e:  # noqa: BLE001 — never hang the rest
                    self._complete_error(f, e)

    def _abort_flight(self, ticket: Ticket, err: BaseException) -> None:
        """A flight leader failed, expired or was shed before populating
        the cache: fail its followers with the same typed error."""
        fl = ticket.cache_flight
        if fl is None or self.cache is None:
            return
        ticket.cache_flight = None
        for f in self.cache.abort_flight(fl):
            self._complete_error(f, err)

    # -- completion accounting (called by the batcher / queue) ---------------
    def _expire(self, ticket: Ticket) -> None:
        obs.SERVE_REQUESTS.labels(ticket.key[0], "deadline").inc()
        obs.SERVE_REQUEST_LATENCY.observe(
            max(_time.monotonic() - ticket.enqueued_at, 0.0)
        )
        err = DeadlineExceeded("deadline passed while queued")
        ticket.future.set_exception(err)
        self._abort_flight(ticket, err)

    def _complete_ok(self, ticket: Ticket, info: BatchInfo) -> None:
        self._ok_counters[ticket.key[0]].inc()
        obs.SERVE_REQUEST_LATENCY.observe(
            max(_time.monotonic() - ticket.enqueued_at, 0.0)
        )

    def _complete_error(self, ticket: Ticket, err: BaseException) -> None:
        outcome = err.code if isinstance(err, ServeError) else "error"
        obs.SERVE_REQUESTS.labels(ticket.key[0], outcome).inc()
        obs.SERVE_REQUEST_LATENCY.observe(
            max(_time.monotonic() - ticket.enqueued_at, 0.0)
        )
        if not ticket.future.done():
            ticket.future.set_exception(err)
        self._abort_flight(ticket, err)

    # -- introspection / lifecycle -------------------------------------------
    def stats(self) -> dict:
        snap = obs.REGISTRY.snapshot()

        def metric(name):
            return snap.get(name, {}).get("values", {})

        return {
            "device": str(self.device),
            "queue_depth_lanes": self.queue.depth_lanes,
            "engines": sorted(f"{w}/{c}" for (w, c) in self._engines),
            "buckets": list(self.config.bucket_table()),
            "padding": {
                "worst_case_pad_pct": padding_waste_pct(
                    self.config.bucket_table()
                ),
                "dispatched_lanes": self.batcher.dispatched_lanes,
                "padded_lanes": self.batcher.padded_lanes,
                "observed_pad_pct": round(
                    100.0 * self.batcher.padded_lanes
                    / max(self.batcher.dispatched_lanes
                          + self.batcher.padded_lanes, 1), 2
                ),
            },
            "max_batch": self.config.max_batch,
            "max_wait_ms": self.config.max_wait_ms,
            "pf_backend": self.config.pf_backend,
            "pf_precision": self.config.pf_precision,
            "pipeline_depth": self.config.pipeline_depth,
            "executor_lanes": {
                w: {"queued": lane.queued(), "busy": lane.busy()}
                for w, lane in sorted(self.batcher.lanes.items())
            },
            "prewarmed": sorted(self.batcher.prewarmed),
            "requests": metric("serve_requests_total"),
            "shed": metric("serve_shed_total"),
            "recompiles": metric("serve_recompiles_total"),
            "recompiles_by_bucket": dict(
                sorted(self.batcher.shape_table().items())
            ),
            # Incremental-tier state: hit/miss/eviction counts, byte
            # budget occupancy, flight joins.
            "cache": (
                {"enabled": True, **self.cache.stats()}
                if self.cache is not None else {"enabled": False}
            ),
            "batch_lanes": metric("serve_batch_lanes"),
            "queue_wait_seconds": metric("serve_queue_wait_seconds"),
            "solve_seconds": metric("serve_solve_seconds"),
            "request_seconds": metric("serve_request_seconds"),
        }

    def start(self) -> "Service":
        self.batcher.start()
        return self

    def stop(self, drain_s: float = 5.0) -> None:
        """Graceful shutdown: seal admission (new submissions raise the
        typed ``shutting_down``), let the batcher finish every already-
        admitted ticket for up to ``drain_s`` seconds, then fail
        whatever is still queued and stop the pipeline."""
        self.queue.seal()
        deadline = _time.monotonic() + max(drain_s, 0.0)
        while _time.monotonic() < deadline:
            if self.queue.depth_lanes == 0 and not self.batcher.busy():
                break
            _time.sleep(0.02)
        for t in self.queue.close():
            self._complete_error(t, ShuttingDown("service stopped"))
        self.batcher.stop()
