"""Async jobs API for QSTS studies and topology sweeps.

Port of ``freedm_tpu/scenarios/jobs.py``.  A QSTS study (or a large
switching sweep) is seconds to minutes of device work, not the
milliseconds the synchronous micro-batched queries answer in, so both get
the long-running-batch contract instead: ``POST /v1/qsts`` (or ``POST
/v1/topo/sweep``) validates and **returns immediately** with a
``job_id``; ``GET /v1/jobs/<id>`` polls progress and, once
completed, the summary; ``POST /v1/jobs/<id>/cancel`` stops the job at
its next chunk boundary (the chunk checkpoint stays on disk, so a
cancelled or killed job resumes when an identical spec is resubmitted
with the same ``job_key``).  One worker pool, one lifecycle and requeue
machinery, two job kinds (``JobRecord.kind``): QSTS studies chunk over
timesteps (:func:`freedm_tpu_torch.scenarios.engine.run_study`), topology
sweeps over variants (:func:`freedm_tpu_torch.pf.topo.run_topo_sweep`).

Errors reuse the serving hierarchy (:mod:`freedm_tpu_torch.serve.queue`):
``invalid_request`` for a malformed spec, ``overloaded`` when the bounded
pending queue is full, ``not_found`` for unknown job ids,
``shutting_down`` after :meth:`JobManager.stop`.

A bounded worker pool (default 1 — the studies share one card) drains the
pending queue.  On the card each worker runs its jobs on a CUDA stream of
its own and syncs only that stream, so a job does not stall the
``/v1/pf`` batcher.  Metrics (:mod:`freedm_tpu_torch.core.metrics`, the
reference's names): ``qsts_jobs_submitted_total``,
``qsts_jobs_total{outcome}``, ``qsts_jobs_running``,
``qsts_chunk_seconds``, ``qsts_scenario_steps_per_sec``,
``qsts_agent_steps_per_sec`` / ``qsts_agents_total``,
``qsts_resumes_total``, ``qsts_jobs_requeued_total``; for sweeps
``topo_sweeps_total{outcome}``, ``topo_sweeps_running``,
``topo_resumes_total``, ``topo_sweeps_requeued_total`` (the sweep records
its own ``topo_*`` chunk metrics).

Not ported: the ``qsts.job``/``topo.job`` tracing spans and the journal's
job events (item 15), the ``qsts.worker.crash``/``topo.worker.crash``
fault points (item 14).
"""

from __future__ import annotations

import contextlib
import math
import os
import re
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from freedm_tpu_torch.core import metrics as obs
from freedm_tpu_torch.device import DeviceLike, resolve_device
from freedm_tpu_torch.pf.backend import BACKENDS, PF_PRECISIONS
from freedm_tpu_torch.pf.topo import (
    MAX_TOPO_RANK,
    SweepCancelled,
    TopoSweepSpec,
    _resolve_sweep_case,
    count_exhaustive,
    run_topo_sweep,
    validate_sweep_spec,
)
from freedm_tpu_torch.scenarios.engine import (
    QstsEngine,
    StudyCancelled,
    StudySpec,
    resolve_mesh_devices,
    run_study,
)
from freedm_tpu_torch.scenarios.profiles import PROFILE_KINDS
from freedm_tpu_torch.serve.queue import (
    InvalidRequest,
    NotFound,
    Overloaded,
    ShuttingDown,
)

#: Validation bounds: the jobs API refuses requests whose tensors could
#: not fit a card (S·nb bounds the per-timestep batch).
MAX_SCENARIOS = 1024
MAX_STEPS = 100_000
MAX_CHUNK_STEPS = 2048
MAX_LANE_CELLS = 1_000_000  # scenarios * n_bus ceiling

#: Agent-population defaults for the ``--qsts-agents-*`` flags:
#: population ceiling per job and scenarios*agents state-cell ceiling
#: (the chunk carry holds that many per-agent state lanes).
DEFAULT_AGENTS_MAX = 1_000_000
DEFAULT_AGENTS_CELLS_MAX = 4_000_000

#: Topology sweep job bounds (``POST /v1/topo/sweep``): async sweeps may
#: enumerate far past the sync endpoint's per-request cap, but the variant
#: space must still be bounded up front.
MAX_TOPO_JOB_VARIANTS = 500_000
MAX_TOPO_JOB_TOPK = 32
MIN_TOPO_CHUNK = 64
MAX_TOPO_CHUNK = 16_384

_JOB_KEY_RE = re.compile(r"^[A-Za-z0-9_.-]{1,64}$")

_FIELDS = {
    "case", "scenarios", "steps", "dt_minutes", "seed", "profile",
    "chunk_steps", "warm_start", "max_iter", "job_key", "mesh_devices",
    "pf_backend", "pf_precision", "agents",
}


def _mesh_devices(mesh_devices: int) -> None:
    """A value that comes to one card runs; more is an ``InvalidRequest``
    (the sharded forms are module queue item 16)."""
    if mesh_devices not in (0, 1):
        try:
            resolve_mesh_devices(mesh_devices)
        except NotImplementedError as e:
            raise InvalidRequest(str(e)) from None


def parse_job_request(payload: dict, default_chunk_steps: int = 24,
                      default_mesh_devices: int = 0,
                      agents_max: int = DEFAULT_AGENTS_MAX,
                      agents_cells_max: int = DEFAULT_AGENTS_CELLS_MAX):
    """``(StudySpec, job_key)`` from a JSON payload, every field range-
    checked with typed errors and the reference's messages.

    ``mesh_devices`` (request field, default from the server config) may
    be 0, 1 or -1 on a host with one card; more is refused (the sharded
    form is module queue item 16).  ``agents`` (optional
    object) attaches a grid-edge agent population, bounded by
    ``agents_max`` / ``agents_cells_max``."""
    if not isinstance(payload, dict):
        raise InvalidRequest("request body must be a JSON object")
    unknown = set(payload) - _FIELDS
    if unknown:
        raise InvalidRequest(f"unknown field(s) {sorted(unknown)} for qsts")
    if "case" not in payload:
        raise InvalidRequest("missing required field 'case'")
    case = payload["case"]
    if not isinstance(case, str) or not case:
        raise InvalidRequest("'case' must be a non-empty string")

    def _int(name, default, lo, hi):
        v = payload.get(name, default)
        if isinstance(v, bool) or not isinstance(v, int):
            raise InvalidRequest(f"{name!r} must be an integer")
        if not lo <= v <= hi:
            raise InvalidRequest(f"{name!r} must be in [{lo}, {hi}], got {v}")
        return v

    scenarios = _int("scenarios", 16, 1, MAX_SCENARIOS)
    steps = _int("steps", 96, 1, MAX_STEPS)
    chunk_steps = _int("chunk_steps", int(default_chunk_steps), 1,
                       MAX_CHUNK_STEPS)
    seed = _int("seed", 0, 0, 2**31 - 1)
    max_iter = _int("max_iter", 12, 1, 64)
    dt = payload.get("dt_minutes", 15.0)
    if isinstance(dt, bool) or not isinstance(dt, (int, float)) \
            or not math.isfinite(dt) or not 0.1 <= dt <= 1440.0:
        raise InvalidRequest("'dt_minutes' must be in [0.1, 1440]")
    profile = payload.get("profile", "residential")
    if profile not in PROFILE_KINDS:
        raise InvalidRequest(
            f"unknown profile {profile!r} (have: {', '.join(PROFILE_KINDS)})"
        )
    warm = payload.get("warm_start", True)
    if not isinstance(warm, bool):
        raise InvalidRequest("'warm_start' must be a boolean")
    pf_backend = payload.get("pf_backend", "auto")
    if pf_backend not in BACKENDS:
        raise InvalidRequest(
            f"unknown pf_backend {pf_backend!r} "
            f"(have: {', '.join(BACKENDS)})"
        )
    pf_precision = payload.get("pf_precision", "auto")
    if pf_precision not in PF_PRECISIONS:
        raise InvalidRequest(
            f"unknown pf_precision {pf_precision!r} "
            f"(have: {', '.join(PF_PRECISIONS)})"
        )
    agents = None
    if payload.get("agents") is not None:
        from freedm_tpu_torch.scenarios.agents import parse_agents_field

        agents = parse_agents_field(
            payload["agents"], scenarios,
            max_agents=int(agents_max), max_cells=int(agents_cells_max),
        )
    mesh_devices = _int("mesh_devices", int(default_mesh_devices), -1, 4096)
    _mesh_devices(mesh_devices)
    job_key = payload.get("job_key")
    if job_key is not None and (
        not isinstance(job_key, str) or not _JOB_KEY_RE.match(job_key)
    ):
        raise InvalidRequest(
            "'job_key' must match [A-Za-z0-9_.-]{1,64} (it names the "
            "checkpoint file)"
        )
    spec = StudySpec(
        case=case, scenarios=scenarios, steps=steps, dt_minutes=float(dt),
        seed=seed, profile=profile, chunk_steps=chunk_steps,
        warm_start=warm, max_iter=max_iter, mesh_devices=mesh_devices,
        pf_backend=pf_backend, pf_precision=pf_precision, agents=agents,
    )
    # Resolve the case NOW (typed error, and the lane-cell bound needs
    # its size); the engine built later resolves it again.
    from freedm_tpu_torch.scenarios.engine import _resolve_case

    kind, case_obj = _resolve_case(case)
    if agents is not None and kind != "bus":
        raise InvalidRequest(
            f"'agents' requires a bus case (got feeder case {case!r}): "
            f"the ladder has no per-bus voltage state for agents to "
            f"observe"
        )
    n = case_obj.n_bus if kind == "bus" else case_obj.n_branches
    if scenarios * n > MAX_LANE_CELLS:
        raise InvalidRequest(
            f"scenarios x buses = {scenarios * n} exceeds the "
            f"{MAX_LANE_CELLS} lane-cell ceiling; lower 'scenarios'"
        )
    return spec, job_key


_TOPO_FIELDS = {
    "case", "switches", "max_rank", "mode", "objective", "flow_limit",
    "top_k", "search", "samples", "seed", "chunk_variants", "ac_verify",
    "job_key", "mesh_devices",
}


def parse_topo_job_request(payload: dict, default_chunk: int = 4096,
                           default_mesh_devices: int = 0):
    """``(TopoSweepSpec, job_key, v_total)`` from a ``POST
    /v1/topo/sweep`` payload, every field range-checked with typed errors
    and the reference's messages — the async twin of the sync workload's
    ``TopoEngine.validate``.  ``mesh_devices`` follows the QSTS rule."""
    if not isinstance(payload, dict):
        raise InvalidRequest("request body must be a JSON object")
    unknown = set(payload) - _TOPO_FIELDS
    if unknown:
        raise InvalidRequest(
            f"unknown field(s) {sorted(unknown)} for topo sweep"
        )
    if "case" not in payload:
        raise InvalidRequest("missing required field 'case'")
    case = payload["case"]
    if not isinstance(case, str) or not case:
        raise InvalidRequest("'case' must be a non-empty string")

    def _int(name, default, lo, hi):
        v = payload.get(name, default)
        if isinstance(v, bool) or not isinstance(v, int):
            raise InvalidRequest(f"{name!r} must be an integer")
        if not lo <= v <= hi:
            raise InvalidRequest(f"{name!r} must be in [{lo}, {hi}], got {v}")
        return v

    max_rank = _int("max_rank", 2, 1, MAX_TOPO_RANK)
    top_k = _int("top_k", 8, 1, MAX_TOPO_JOB_TOPK)
    samples = _int("samples", 0, 0, MAX_TOPO_JOB_VARIANTS)
    seed = _int("seed", 0, 0, 2**31 - 1)
    chunk = _int("chunk_variants", int(default_chunk), MIN_TOPO_CHUNK,
                 MAX_TOPO_CHUNK)
    flow_limit = payload.get("flow_limit", 1.0)
    if isinstance(flow_limit, bool) or not isinstance(
        flow_limit, (int, float)
    ) or not math.isfinite(flow_limit):
        raise InvalidRequest("'flow_limit' must be a finite number")
    ac_verify = payload.get("ac_verify", True)
    if not isinstance(ac_verify, bool):
        raise InvalidRequest("'ac_verify' must be a boolean")
    switches = payload.get("switches")
    if switches is not None:
        if not isinstance(switches, (list, tuple)) or not switches or any(
            isinstance(s, bool) or not isinstance(s, int) for s in switches
        ):
            raise InvalidRequest(
                "'switches' must be a non-empty list of branch indices "
                "(or omitted for the full branch set)"
            )
        switches = tuple(int(s) for s in switches)
    mesh_devices = _int("mesh_devices", int(default_mesh_devices),
                        -1, 4096)
    _mesh_devices(mesh_devices)
    job_key = payload.get("job_key")
    if job_key is not None and (
        not isinstance(job_key, str) or not _JOB_KEY_RE.match(job_key)
    ):
        raise InvalidRequest(
            "'job_key' must match [A-Za-z0-9_.-]{1,64} (it names the "
            "checkpoint file)"
        )
    spec = TopoSweepSpec(
        case=case, switches=switches, max_rank=max_rank,
        mode=payload.get("mode", "mesh"),
        objective=payload.get("objective", "loss"),
        flow_limit=float(flow_limit), top_k=top_k,
        search=payload.get("search", "exhaustive"), samples=samples,
        seed=seed, chunk_variants=chunk, ac_verify=ac_verify,
        mesh_devices=mesh_devices,
    )
    # Resolve the case NOW (typed error + the variant-space bound).
    try:
        sys_ = _resolve_sweep_case(case)
        validate_sweep_spec(spec, sys_.n_branch)
    except ValueError as e:
        raise InvalidRequest(str(e)) from None
    n_switch = (sys_.n_branch if spec.switches is None
                else len(spec.switches))
    # Neighborhood draws are capped by the distinct-subset space, so the
    # admission response's chunks_total cannot over-report a tiny space.
    v_total = (min(spec.samples, count_exhaustive(n_switch, spec.max_rank))
               if spec.search == "neighborhood"
               else count_exhaustive(n_switch, spec.max_rank))
    if v_total > MAX_TOPO_JOB_VARIANTS:
        raise InvalidRequest(
            f"the sweep enumerates {v_total} variants, over the "
            f"{MAX_TOPO_JOB_VARIANTS} job ceiling; lower max_rank, "
            f"shrink switches, or use search='neighborhood'"
        )
    return spec, job_key, v_total


@dataclass
class JobRecord:
    """One submitted study/sweep and its lifecycle."""

    id: str
    spec: object  # StudySpec | TopoSweepSpec
    job_key: Optional[str]
    kind: str = "qsts"  # qsts | topo
    state: str = "queued"  # queued|running|completed|failed|cancelled
    submitted_ts: float = field(default_factory=time.time)
    started_ts: Optional[float] = None
    finished_ts: Optional[float] = None
    chunks_done: int = 0
    chunks_total: int = 0
    resumed_from_chunk: int = 0
    requeues: int = 0  # worker-crash auto-requeues consumed so far
    summary: Optional[dict] = None
    error: Optional[str] = None
    cancel: threading.Event = field(default_factory=threading.Event)

    def to_dict(self) -> dict:
        out = {
            "job_id": self.id,
            "kind": self.kind,
            "state": self.state,
            "spec": self.spec.to_dict(),
            "submitted_ts": round(self.submitted_ts, 3),
            "chunks_done": self.chunks_done,
            "chunks_total": self.chunks_total,
            "resumed_from_chunk": self.resumed_from_chunk,
            "requeues": self.requeues,
        }
        if self.job_key is not None:
            out["job_key"] = self.job_key
        if self.started_ts is not None:
            out["started_ts"] = round(self.started_ts, 3)
        if self.finished_ts is not None:
            out["finished_ts"] = round(self.finished_ts, 3)
        if self.summary is not None:
            out["summary"] = self.summary
        if self.error is not None:
            out["error"] = self.error
        return out


class JobManager:
    """Bounded background execution of QSTS studies and topology sweeps.

    ``submit`` / ``submit_topo`` -> job dict (typed errors synchronously); ``get``/
    ``cancel`` by job id.  Finished jobs stay pollable until the table
    (``MAX_TABLE``) evicts the oldest finished entries.  Studies run on
    ``device`` (``cuda`` unless asked otherwise).
    """

    MAX_TABLE = 256

    #: Worker-crash auto-requeues per job: a job whose worker died
    #: mid-chunk is resumed from its last checkpoint this many times
    #: before it is declared failed (a deterministic bug would requeue
    #: forever otherwise).
    MAX_REQUEUES = 2

    def __init__(self, workers: int = 1, max_pending: int = 16,
                 checkpoint_dir: Optional[str] = None,
                 default_chunk_steps: int = 24,
                 default_mesh_devices: int = 0,
                 default_topo_chunk: int = 4096,
                 agents_max: int = DEFAULT_AGENTS_MAX,
                 agents_cells_max: int = DEFAULT_AGENTS_CELLS_MAX,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.workers = max(int(workers), 1)
        self.max_pending = max(int(max_pending), 1)
        self.checkpoint_dir = checkpoint_dir
        self.default_chunk_steps = int(default_chunk_steps)
        self.default_mesh_devices = int(default_mesh_devices)
        self.default_topo_chunk = int(default_topo_chunk)
        self.agents_max = int(agents_max)
        self.agents_cells_max = int(agents_cells_max)
        self._cond = threading.Condition()
        self._pending: deque = deque()
        self._jobs: "OrderedDict[str, JobRecord]" = OrderedDict()
        self._closed = False
        self._threads: List[threading.Thread] = []
        # Watchdog surface: each executing worker keeps its own beat
        # (keyed by thread ident, present only while it runs a job),
        # refreshed at pickup and every chunk boundary.
        self._worker_beats: Dict[int, float] = {}

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "JobManager":
        if not self._threads:
            self._threads = [
                threading.Thread(
                    target=self._run, name=f"qsts-worker-{i}", daemon=True
                )
                for i in range(self.workers)
            ]
            for t in self._threads:
                t.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        with self._cond:
            self._closed = True
            for rec in self._jobs.values():
                rec.cancel.set()
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=timeout)

    # -- submission / polling ------------------------------------------------
    def submit(self, payload: dict) -> dict:
        spec, job_key = parse_job_request(
            payload, self.default_chunk_steps,
            default_mesh_devices=self.default_mesh_devices,
            agents_max=self.agents_max,
            agents_cells_max=self.agents_cells_max,
        )
        rec = JobRecord(id=os.urandom(8).hex(), spec=spec, job_key=job_key)
        rec.chunks_total = math.ceil(spec.steps / spec.chunk_steps)
        out = self._admit(rec)
        obs.QSTS_SUBMITTED.inc()
        return out

    def submit_topo(self, payload: dict) -> dict:
        """Admit one async topology sweep (``POST /v1/topo/sweep``) — the
        QSTS studies' lifecycle, polling and cancel contract, run by
        :func:`freedm_tpu_torch.pf.topo.run_topo_sweep` (chunked,
        checkpointed under the job key, exact resume)."""
        spec, job_key, v_total = parse_topo_job_request(
            payload, self.default_topo_chunk,
            default_mesh_devices=self.default_mesh_devices,
        )
        rec = JobRecord(id=os.urandom(8).hex(), spec=spec,
                        job_key=job_key, kind="topo")
        rec.chunks_total = math.ceil(v_total / spec.chunk_variants)
        return self._admit(rec)

    def _admit(self, rec: JobRecord) -> dict:
        with self._cond:
            if self._closed:
                raise ShuttingDown("jobs API is stopping")
            if len(self._pending) >= self.max_pending:
                raise Overloaded(
                    f"qsts queue at depth ({len(self._pending)}/"
                    f"{self.max_pending} jobs); retry with backoff"
                )
            while len(self._jobs) >= self.MAX_TABLE:
                evicted = next(
                    (k for k, r in self._jobs.items()
                     if r.state in ("completed", "failed", "cancelled")),
                    None,
                )
                if evicted is None:
                    raise Overloaded("job table full of live jobs")
                del self._jobs[evicted]
            self._jobs[rec.id] = rec
            self._pending.append(rec)
            # Snapshot under the lock: the response reflects admission
            # ("queued"), not a race with a worker that already started.
            out = rec.to_dict()
            self._cond.notify()
        return out

    def get(self, job_id: str) -> dict:
        with self._cond:
            rec = self._jobs.get(job_id)
        if rec is None:
            raise NotFound(f"no such job: {job_id!r}")
        return rec.to_dict()

    def cancel(self, job_id: str) -> dict:
        with self._cond:
            rec = self._jobs.get(job_id)
            if rec is None:
                raise NotFound(f"no such job: {job_id!r}")
            rec.cancel.set()
            if rec.state == "queued":
                # Never started: settle it here (the worker skips it).
                rec.state = "cancelled"
                rec.finished_ts = time.time()
                self._outcome_counter(rec).labels("cancelled").inc()
        return rec.to_dict()

    @staticmethod
    def _outcome_counter(rec: JobRecord):
        return obs.TOPO_SWEEPS if rec.kind == "topo" else obs.QSTS_JOBS

    # -- watchdog surface ----------------------------------------------------
    def progress_age(self) -> float:
        """Seconds since the STALEST currently-executing worker last
        reported progress (0 while idle)."""
        with self._cond:
            if not self._worker_beats:
                return 0.0
            oldest = min(self._worker_beats.values())
        return time.monotonic() - oldest

    def busy(self) -> bool:
        """True while a study is executing on a worker."""
        with self._cond:
            return bool(self._worker_beats)

    def stats(self) -> dict:
        with self._cond:
            states: Dict[str, int] = {}
            for rec in self._jobs.values():
                states[rec.state] = states.get(rec.state, 0) + 1
            return {
                "jobs": len(self._jobs),
                "pending": len(self._pending),
                "by_state": states,
                "workers": self.workers,
            }

    def snapshot_state(self) -> dict:
        """Job-table cut: ``total`` and ``by_state`` read in one lock
        hold, so ``total == Σ by_state`` always holds."""
        with self._cond:
            states: Dict[str, int] = {}
            for rec in self._jobs.values():
                states[rec.state] = states.get(rec.state, 0) + 1
            return {
                "total": len(self._jobs),
                "by_state": states,
                "pending": len(self._pending),
            }

    # -- worker --------------------------------------------------------------
    def _checkpoint_path(self, rec: JobRecord) -> Optional[str]:
        if rec.job_key is None or not self.checkpoint_dir:
            return None
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        return os.path.join(self.checkpoint_dir,
                            f"{rec.kind}_{rec.job_key}.json")

    def _run(self) -> None:
        # The worker's own stream: its studies sync it, never the device.
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait(0.5)
                if self._closed and not self._pending:
                    return
                rec = self._pending.popleft() if self._pending else None
                if rec is None:
                    continue
                if rec.state != "queued":  # cancelled while queued
                    continue
                rec.state = "running"
                rec.started_ts = time.time()
            self._execute(rec, stream)

    def _execute(self, rec: JobRecord, stream=None) -> None:
        spec = rec.spec
        is_topo = rec.kind == "topo"
        running = obs.TOPO_RUNNING if is_topo else obs.QSTS_RUNNING
        running.inc()
        ident = threading.get_ident()
        with self._cond:
            self._worker_beats[ident] = time.monotonic()
        n_agents = (spec.agents.total()
                    if not is_topo and spec.agents is not None else 0)

        def on_chunk(done, total, chunk_s, lane_steps):
            rec.chunks_done = done
            rec.chunks_total = total
            self._worker_beats[ident] = time.monotonic()
            if is_topo:
                # The sweep records its own topo_* chunk metrics.
                return
            obs.QSTS_CHUNK_SECONDS.observe(chunk_s)
            if chunk_s > 0:
                obs.QSTS_SCENARIO_RATE.set(lane_steps / chunk_s)
                if n_agents:
                    # lane_steps is scenario-steps; every one stepped
                    # the full agent population once.
                    obs.QSTS_AGENT_RATE.set(lane_steps * n_agents / chunk_s)
            if n_agents:
                obs.QSTS_AGENTS_TOTAL.set(n_agents)

        ckpt_path = self._checkpoint_path(rec)
        outcome_counter = self._outcome_counter(rec)
        try:
            if is_topo:
                # On the worker's stream: the sweep's one copy to the host
                # a chunk syncs only that stream.
                with (contextlib.nullcontext() if stream is None
                      else torch.cuda.stream(stream)):
                    summary = run_topo_sweep(
                        spec, checkpoint_path=ckpt_path, resume=True,
                        cancel=rec.cancel, on_chunk=on_chunk,
                        device=self.device,
                    )
            else:
                engine = QstsEngine(spec, device=self.device, stream=stream)
                summary = run_study(
                    spec, checkpoint_path=ckpt_path, resume=True,
                    cancel=rec.cancel, on_chunk=on_chunk, engine=engine,
                )
            rec.summary = summary
            rec.error = None  # clear a prior requeue's crash record
            rec.resumed_from_chunk = summary.get("resumed_from_chunk", 0)
            if rec.resumed_from_chunk:
                (obs.TOPO_RESUMES if is_topo else obs.QSTS_RESUMES).inc()
            rec.state = "completed"
            outcome_counter.labels("completed").inc()
        except (StudyCancelled, SweepCancelled):
            rec.state = "cancelled"
            outcome_counter.labels("cancelled").inc()
        except Exception as e:  # noqa: BLE001 — pollers must see failures
            if self._try_requeue(rec, ckpt_path, e):
                return  # back on the pending queue; not terminal
            rec.state = "failed"
            rec.error = repr(e)
            outcome_counter.labels("failed").inc()
        finally:
            if rec.state in ("completed", "failed", "cancelled"):
                rec.finished_ts = time.time()
            with self._cond:
                self._worker_beats.pop(ident, None)
            running.dec()

    def _try_requeue(self, rec: JobRecord, ckpt_path: Optional[str],
                     err: BaseException) -> bool:
        """A worker died mid-study: requeue the job to resume from its
        chunk checkpoint instead of demanding a manual resubmission.
        Only checkpointed (keyed) jobs requeue — an unkeyed job would
        silently restart from scratch — and only ``MAX_REQUEUES`` times,
        so a deterministic crash still terminates as failed."""
        if ckpt_path is None or rec.cancel.is_set():
            return False
        with self._cond:
            if self._closed or rec.requeues >= self.MAX_REQUEUES:
                return False
            rec.requeues += 1
            rec.state = "queued"
            rec.error = repr(err)  # visible to pollers mid-requeue
            self._pending.append(rec)
            self._cond.notify()
        (obs.TOPO_REQUEUED if rec.kind == "topo"
         else obs.QSTS_REQUEUED).inc()
        return True
