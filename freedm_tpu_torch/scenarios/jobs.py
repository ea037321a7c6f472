"""Async jobs API for QSTS studies.

Port of ``freedm_tpu/scenarios/jobs.py``.  A QSTS study is seconds to
minutes of device work, not the milliseconds the synchronous
micro-batched queries answer in, so it gets the long-running-batch
contract instead: ``POST /v1/qsts`` validates and **returns immediately**
with a ``job_id``; ``GET /v1/jobs/<id>`` polls progress and, once
completed, the summary; ``POST /v1/jobs/<id>/cancel`` stops the job at
its next chunk boundary (the chunk checkpoint stays on disk, so a
cancelled or killed job resumes when an identical spec is resubmitted
with the same ``job_key``).

Errors reuse the serving hierarchy (:mod:`freedm_tpu_torch.serve.queue`):
``invalid_request`` for a malformed spec, ``overloaded`` when the bounded
pending queue is full, ``not_found`` for unknown job ids,
``shutting_down`` after :meth:`JobManager.stop`.

A bounded worker pool (default 1 — the studies share one card) drains the
pending queue.  On the card each worker runs its studies on a CUDA stream
of its own and syncs only that stream, so a study does not stall the
``/v1/pf`` batcher.  Metrics (:mod:`freedm_tpu_torch.core.metrics`, the
reference's names): ``qsts_jobs_submitted_total``,
``qsts_jobs_total{outcome}``, ``qsts_jobs_running``,
``qsts_chunk_seconds``, ``qsts_scenario_steps_per_sec``,
``qsts_agent_steps_per_sec`` / ``qsts_agents_total``,
``qsts_resumes_total``, ``qsts_jobs_requeued_total``.

Not ported: topology sweep jobs (``submit_topo``, ROADMAP.md module queue
item 11), the ``qsts.job`` tracing span and the journal's job events
(item 15), the ``qsts.worker.crash`` fault point (item 14).
"""

from __future__ import annotations

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

_JOB_KEY_RE = re.compile(r"^[A-Za-z0-9_.-]{1,64}$")

_FIELDS = {
    "case", "scenarios", "steps", "dt_minutes", "seed", "profile",
    "chunk_steps", "warm_start", "max_iter", "job_key", "mesh_devices",
    "pf_backend", "pf_precision", "agents",
}

_TOPO_NOT_PORTED = (
    "topology sweep jobs (POST /v1/topo/sweep) are not ported (ROADMAP.md, "
    "module queue item 11: topology sweeps)"
)


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
    if mesh_devices not in (0, 1):
        try:
            resolve_mesh_devices(mesh_devices)
        except NotImplementedError as e:
            raise InvalidRequest(str(e)) from None
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


def parse_topo_job_request(payload: dict, default_chunk: int = 4096,
                           default_mesh_devices: int = 0):
    """Not ported: raises ``NotImplementedError`` (module queue item 11)."""
    raise NotImplementedError(_TOPO_NOT_PORTED)


@dataclass
class JobRecord:
    """One submitted study and its lifecycle."""

    id: str
    spec: StudySpec
    job_key: Optional[str]
    kind: str = "qsts"
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
    """Bounded background execution of QSTS studies.

    ``submit`` -> job dict (typed errors synchronously); ``get``/
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
                 agents_max: int = DEFAULT_AGENTS_MAX,
                 agents_cells_max: int = DEFAULT_AGENTS_CELLS_MAX,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.workers = max(int(workers), 1)
        self.max_pending = max(int(max_pending), 1)
        self.checkpoint_dir = checkpoint_dir
        self.default_chunk_steps = int(default_chunk_steps)
        self.default_mesh_devices = int(default_mesh_devices)
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
        """Not ported: raises ``NotImplementedError`` (module queue item
        11)."""
        raise NotImplementedError(_TOPO_NOT_PORTED)

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
                obs.QSTS_JOBS.labels("cancelled").inc()
        return rec.to_dict()

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
        obs.QSTS_RUNNING.inc()
        ident = threading.get_ident()
        with self._cond:
            self._worker_beats[ident] = time.monotonic()
        n_agents = spec.agents.total() if spec.agents is not None else 0

        def on_chunk(done, total, chunk_s, lane_steps):
            rec.chunks_done = done
            rec.chunks_total = total
            self._worker_beats[ident] = time.monotonic()
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
        try:
            engine = QstsEngine(spec, device=self.device, stream=stream)
            summary = run_study(
                spec, checkpoint_path=ckpt_path, resume=True,
                cancel=rec.cancel, on_chunk=on_chunk, engine=engine,
            )
            rec.summary = summary
            rec.error = None  # clear a prior requeue's crash record
            rec.resumed_from_chunk = summary.get("resumed_from_chunk", 0)
            if rec.resumed_from_chunk:
                obs.QSTS_RESUMES.inc()
            rec.state = "completed"
            obs.QSTS_JOBS.labels("completed").inc()
        except StudyCancelled:
            rec.state = "cancelled"
            obs.QSTS_JOBS.labels("cancelled").inc()
        except Exception as e:  # noqa: BLE001 — pollers must see failures
            if self._try_requeue(rec, ckpt_path, e):
                return  # back on the pending queue; not terminal
            rec.state = "failed"
            rec.error = repr(e)
            obs.QSTS_JOBS.labels("failed").inc()
        finally:
            if rec.state in ("completed", "failed", "cancelled"):
                rec.finished_ts = time.time()
            with self._cond:
                self._worker_beats.pop(ident, None)
            obs.QSTS_RUNNING.dec()

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
        obs.QSTS_REQUEUED.inc()
        return True
