"""Serve-path metrics: registry, text exposition, background HTTP server.

The part of ``freedm_tpu/core/metrics.py`` the served power-flow path
records into, copied (the port imports nothing of the JAX package):

- :class:`MetricsRegistry` — process-wide counters, gauges and
  fixed-bucket histograms.  Everything is host-side numpy/float state
  behind one lock: recording never touches a device tensor, so the hot
  paths pay nanoseconds, not syncs.
- :meth:`MetricsRegistry.render_prometheus` — the text exposition
  ``GET /metrics`` serves.
- :class:`BackgroundHttpServer` — the stdlib ``ThreadingHTTPServer``
  scaffold of the serve front end.

The bottom of the module is the metric catalogue the engine, the
service and the micro-batcher record into, under the reference's names.
"""

from __future__ import annotations

import threading
from http.server import ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _fmt(v: float) -> str:
    """Prometheus sample formatting: integers without the trailing .0."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(names: Tuple[str, ...], values: Tuple[str, ...], extra: str = "") -> str:
    parts = [f'{n}="{v}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def estimate_quantiles(bounds, counts, qs: Sequence[float] = (0.5, 0.95, 0.99)):
    """Estimated quantiles from a fixed-bucket histogram.

    ``bounds`` are the finite upper bucket bounds (ascending);
    ``counts`` the per-bucket observation counts, one slot per finite
    bucket plus the trailing +Inf overflow slot.  Semantics follow
    Prometheus ``histogram_quantile``: linear interpolation inside the
    winning bucket (from 0 below the first bound), and a quantile that
    lands in the overflow bucket saturates at the largest finite bound.
    Returns a list of floats (one per ``q``), or ``None`` for an empty
    histogram.

    Interpolation is anchored at the bucket's sample ranks: the k
    observations of a bucket ``(lo, hi]`` sit at
    ``lo + (hi - lo) * j/k`` for ranks ``j = 1..k``, so an estimate can
    never fall below the bucket's first-rank position.  In particular a
    single-sample bucket reports its upper bound exactly — an
    observation sitting ON a bucket edge (iteration counts, one compile
    hit) used to smear to the bucket midpoint, which made integer-count
    histograms report impossible values like "p99 = 1.5 iterations".

    This is what lets ``snapshot()`` (and ``GET /stats``) report
    latency p50/p95/p99 without external tooling.
    """
    bounds = np.asarray(bounds, np.float64)
    counts = np.asarray(counts, np.float64)
    total = float(counts.sum())
    if total <= 0:
        return None
    cum = np.cumsum(counts)
    out: List[float] = []
    for q in qs:
        target = min(max(float(q), 0.0), 1.0) * total
        idx = int(np.searchsorted(cum, target, side="left"))
        if idx >= len(bounds):
            out.append(float(bounds[-1]))
            continue
        lo = 0.0 if idx == 0 else float(bounds[idx - 1])
        hi = float(bounds[idx])
        prev = 0.0 if idx == 0 else float(cum[idx - 1])
        in_bucket = float(cum[idx]) - prev
        if in_bucket > 0:
            # Rank-anchored: clamp the fractional in-bucket rank to the
            # first sample's position (j >= 1).
            frac = min(max(target - prev, 1.0), in_bucket) / in_bucket
        else:
            frac = 1.0
        out.append(lo + (hi - lo) * frac)
    return out


class _Child:
    """One labelled series of a metric; shares the parent's lock."""

    __slots__ = ("_lock",)

    def __init__(self, lock: threading.RLock):
        self._lock = lock


class _CounterChild(_Child):
    __slots__ = ("_value",)

    def __init__(self, lock):
        super().__init__(lock)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _GaugeChild(_Child):
    __slots__ = ("_value",)

    def __init__(self, lock):
        super().__init__(lock)
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _HistogramChild(_Child):
    __slots__ = ("_bounds", "_counts", "_sum")

    def __init__(self, lock, bounds: np.ndarray):
        super().__init__(lock)
        self._bounds = bounds
        # One slot per finite bucket + the +Inf overflow slot.
        self._counts = np.zeros(len(bounds) + 1, np.int64)
        self._sum = 0.0

    def observe(self, value) -> None:
        """Record one value or an array of values (no device syncs: the
        caller hands host data)."""
        vals = np.atleast_1d(np.asarray(value, np.float64))
        idx = np.searchsorted(self._bounds, vals, side="left")
        with self._lock:
            np.add.at(self._counts, idx, 1)
            self._sum += float(vals.sum())

    @property
    def count(self) -> int:
        with self._lock:
            return int(self._counts.sum())

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def buckets(self) -> Dict[str, int]:
        """Cumulative counts keyed by upper bound (Prometheus `le`)."""
        with self._lock:
            cum = np.cumsum(self._counts)
        out = {_fmt(b): int(c) for b, c in zip(self._bounds, cum[:-1])}
        out["+Inf"] = int(cum[-1])
        return out

    def quantiles(self, qs: Sequence[float] = (0.5, 0.95, 0.99)) -> Optional[Dict[str, float]]:
        """Estimated quantiles as ``{"p50": ..., "p95": ..., "p99": ...}``
        (:func:`estimate_quantiles`); ``None`` while empty."""
        with self._lock:
            counts = self._counts.copy()
        vals = estimate_quantiles(self._bounds, counts, qs)
        if vals is None:
            return None
        return {f"p{int(round(q * 100))}": round(v, 9) for q, v in zip(qs, vals)}


class _Metric:
    """Base: a named family of children keyed by label values."""

    kind = ""

    def __init__(self, name: str, help: str, label_names: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.RLock()
        self._children: Dict[Tuple[str, ...], _Child] = {}
        if not self.label_names:
            self._children[()] = self._new_child()

    def _new_child(self) -> _Child:
        raise NotImplementedError

    def labels(self, *values) -> _Child:
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, got {values!r}"
            )
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    def children(self) -> List[Tuple[Tuple[str, ...], _Child]]:
        with self._lock:
            return sorted(self._children.items())

    # Unlabelled convenience pass-throughs.
    @property
    def value(self) -> float:
        return self.labels().value  # type: ignore[attr-defined]


class Counter(_Metric):
    kind = "counter"

    def _new_child(self):
        return _CounterChild(self._lock)

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)  # type: ignore[attr-defined]


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild(self._lock)

    def set(self, value: float) -> None:
        self.labels().set(value)  # type: ignore[attr-defined]

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)  # type: ignore[attr-defined]

    def dec(self, amount: float = 1.0) -> None:
        self.labels().dec(amount)  # type: ignore[attr-defined]



#: Default histogram buckets: wall-time-ish spread, seconds.
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, buckets: Sequence[float] = DEFAULT_BUCKETS,
                 label_names: Sequence[str] = ()):
        bounds = np.asarray(sorted(float(b) for b in buckets), np.float64)
        if bounds.size == 0:
            raise ValueError(f"{name}: histograms need at least one bucket")
        self._bounds = bounds
        super().__init__(name, help, label_names)

    def _new_child(self):
        return _HistogramChild(self._lock, self._bounds)

    def observe(self, value) -> None:
        self.labels().observe(value)  # type: ignore[attr-defined]

    @property
    def count(self) -> int:
        return self.labels().count  # type: ignore[attr-defined]

    @property
    def sum(self) -> float:
        return self.labels().sum  # type: ignore[attr-defined]


class MetricsRegistry:
    """Process-wide metric table.

    Registration is idempotent: asking for an existing name returns the
    existing metric (so module reloads and repeated constructions share
    series), but a kind or label mismatch is a hard error — two meanings
    for one name is a bug, not a merge.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, cls, name: str, help: str, labels: Sequence[str],
                  **kwargs) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind} "
                        f"with labels {m.label_names}"
                    )
                buckets = kwargs.get("buckets")
                if buckets is not None and not np.array_equal(
                    m._bounds, np.asarray(sorted(float(b) for b in buckets))
                ):
                    raise ValueError(
                        f"histogram {name!r} already registered with buckets "
                        f"{tuple(m._bounds)}"
                    )
                return m
            m = self._metrics[name] = cls(name, help, label_names=labels, **kwargs)
            return m

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  labels: Sequence[str] = ()) -> Histogram:
        return self._register(Histogram, name, help, labels, buckets=buckets)

    def _items(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def render_prometheus(self) -> str:
        """The text exposition format (version 0.0.4)."""
        lines: List[str] = []
        for m in self._items():
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key, child in m.children():
                if isinstance(child, _HistogramChild):
                    for le, c in child.buckets().items():
                        ls = _label_str(m.label_names, key, f'le="{le}"')
                        lines.append(f"{m.name}_bucket{ls} {c}")
                    ls = _label_str(m.label_names, key)
                    lines.append(f"{m.name}_sum{ls} {_fmt(child.sum)}")
                    lines.append(f"{m.name}_count{ls} {child.count}")
                else:
                    ls = _label_str(m.label_names, key)
                    lines.append(f"{m.name}{ls} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, dict]:
        """JSON-serializable dump (the ``/stats`` metric blocks)."""
        out: Dict[str, dict] = {}
        for m in self._items():
            entry: Dict[str, object] = {"type": m.kind}
            values: Dict[str, object] = {}
            for key, child in m.children():
                k = ",".join(key)
                if isinstance(child, _HistogramChild):
                    entry_h: Dict[str, object] = {
                        "count": child.count,
                        "sum": child.sum,
                        "buckets": child.buckets(),
                    }
                    q = child.quantiles()
                    if q is not None:
                        entry_h.update(q)
                    values[k] = entry_h
                else:
                    values[k] = child.value
            entry["values"] = values
            out[m.name] = entry
        return out


class _Server(ThreadingHTTPServer):
    # A burst of concurrent clients (what the micro-batcher coalesces)
    # must not overflow the listen backlog (socketserver's default is 5).
    request_queue_size = 128


class BackgroundHttpServer:
    """Scaffold of the zero-dependency serve front end: a
    ``ThreadingHTTPServer`` with daemon worker threads, run on
    a daemon thread by :meth:`start`; ``port=0`` binds an ephemeral
    port (read back from ``.port``)."""

    def __init__(self, handler_cls, port: int = 0, host: str = "127.0.0.1"):
        self._httpd = _Server((host, int(port)), handler_cls)
        self._httpd.daemon_threads = True
        self.port = int(self._httpd.server_address[1])
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


# ---------------------------------------------------------------------------
# Metric catalogue
# ---------------------------------------------------------------------------

#: The process-wide registry every layer records into.
REGISTRY = MetricsRegistry()

# -- power-flow solvers (freedm_tpu_torch.pf) ------------------------------
PF_ITERATIONS = REGISTRY.histogram(
    "pf_newton_iterations",
    "Outer iterations per solve, from already-materialized result tuples",
    buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 40), labels=("solver",))
PF_RESIDUAL = REGISTRY.gauge(
    "pf_residual_pu", "Final masked power mismatch of the last recorded solve",
    labels=("solver",))
PF_FALLBACKS = REGISTRY.counter(
    "pf_precision_fallbacks_total",
    "Newton iterations re-run at full precision after a mixed-precision "
    "inner solve stalled a lane (--pf-precision mixed; summed over lanes "
    "from already-materialized result tuples)",
    labels=("solver",))
for _solver in ("newton", "fdlf", "krylov"):
    PF_ITERATIONS.labels(_solver)
    PF_RESIDUAL.labels(_solver)
    PF_FALLBACKS.labels(_solver)

# -- query serving (freedm_tpu_torch.serve) --------------------------------
SERVE_REQUESTS = REGISTRY.counter(
    "serve_requests_total",
    "Serving requests by final outcome "
    "(ok/invalid/overloaded/deadline/shutdown/error)",
    labels=("workload", "outcome"))
SERVE_SHED = REGISTRY.counter(
    "serve_shed_total",
    "Requests rejected at admission because the queue was at depth")
SERVE_RECOMPILES = REGISTRY.counter(
    "serve_recompiles_total",
    "First dispatches of a (workload, case, bucket) shape; bounded by the "
    "bucket table",
    labels=("workload",))
SERVE_QUEUE_DEPTH = REGISTRY.gauge(
    "serve_queue_depth", "Lanes admitted but not yet dispatched")
SERVE_INFLIGHT = REGISTRY.gauge(
    "serve_inflight_batches",
    "Assembled batches handed to a device-executor lane but not yet "
    "scattered (queued + executing, per workload lane; stays 0 on the "
    "serialized --serve-pipeline-depth 0 path)",
    labels=("workload",))
SERVE_BATCH_LANES = REGISTRY.histogram(
    "serve_batch_lanes", "Real (pre-padding) lanes per dispatched batch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256), labels=("workload",))
SERVE_QUEUE_WAIT = REGISTRY.histogram(
    "serve_queue_wait_seconds", "Admission to batch dispatch, per request",
    buckets=(0.0005, 0.002, 0.005, 0.02, 0.05, 0.2, 0.5, 2.0, 10.0))
SERVE_SOLVE_LATENCY = REGISTRY.histogram(
    "serve_solve_seconds",
    "Batched solve wall time (ends at a device synchronize), per dispatch",
    buckets=(0.001, 0.005, 0.02, 0.05, 0.1, 0.5, 1.0, 5.0, 20.0),
    labels=("workload",))
SERVE_WARM_START = REGISTRY.counter(
    "serve_warm_start_total",
    "pf requests that supplied a v0/theta0 warm start")
SERVE_REQUEST_LATENCY = REGISTRY.histogram(
    "serve_request_seconds",
    "Admission to completion per settled request (ok or failed) — the "
    "user-perceived latency the serve_p99 SLO is judged on",
    buckets=(0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0, 60.0))
SERVE_CACHE_HITS = REGISTRY.counter(
    "serve_cache_hits_total",
    "Incremental-tier answers by tier: exact = identical injections "
    "served from the cached solution without touching the device, "
    "delta = SMW/FDLF correction off the cached factorization (residual-"
    "verified), warm = full solve seeded from the nearest cached solution",
    labels=("tier",))
for _tier in ("exact", "delta", "warm"):
    SERVE_CACHE_HITS.labels(_tier)
SERVE_CACHE_MISSES = REGISTRY.counter(
    "serve_cache_misses_total",
    "pf cache lookups that fell through to a cold full solve "
    "(no usable cached solution for the case/topology/backend)")
SERVE_CACHE_EVICTIONS = REGISTRY.counter(
    "serve_cache_evictions_total",
    "Cached solutions/entries dropped, by reason (lru = byte budget, "
    "ttl = age, invalidate = explicit/topology invalidation)",
    labels=("reason",))
for _reason in ("lru", "ttl", "invalidate"):
    SERVE_CACHE_EVICTIONS.labels(_reason)
SERVE_CACHE_HIT_RATIO = REGISTRY.gauge(
    "serve_cache_hit_ratio",
    "(exact + delta hits) / lookups since start — the fraction of pf "
    "traffic answered without a full solve")
SERVE_CACHE_BYTES = REGISTRY.gauge(
    "serve_cache_bytes",
    "Bytes held by the serving cache (solutions + per-case artifacts) "
    "against the --cache-mb budget")
SERVE_CACHE_ERRORS = REGISTRY.counter(
    "serve_cache_errors_total",
    "pf requests whose cache tier raised (a delta program's build or "
    "launch, or any cache-side failure) and that took the full path "
    "instead; the first is logged with its traceback")

# -- QSTS scenario engine (freedm_tpu_torch.scenarios) ----------------------
QSTS_SUBMITTED = REGISTRY.counter(
    "qsts_jobs_submitted_total", "QSTS jobs accepted by the jobs API")
QSTS_JOBS = REGISTRY.counter(
    "qsts_jobs_total",
    "QSTS jobs by final outcome (completed/failed/cancelled)",
    labels=("outcome",))
for _outcome in ("completed", "failed", "cancelled"):
    QSTS_JOBS.labels(_outcome)
QSTS_RUNNING = REGISTRY.gauge(
    "qsts_jobs_running", "QSTS jobs currently executing on a worker")
QSTS_CHUNK_SECONDS = REGISTRY.histogram(
    "qsts_chunk_seconds",
    "Wall time per QSTS time-chunk (profile materialize + batched solve)",
    buckets=(0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 20.0, 60.0, 240.0))
QSTS_SCENARIO_RATE = REGISTRY.gauge(
    "qsts_scenario_steps_per_sec",
    "Scenario-timesteps per second of the most recent QSTS chunk")
QSTS_AGENT_RATE = REGISTRY.gauge(
    "qsts_agent_steps_per_sec",
    "Agent-steps per second of the most recent QSTS chunk (scenario-"
    "timesteps x population size; zero unless the study attached an "
    "agent population)")
QSTS_AGENTS_TOTAL = REGISTRY.gauge(
    "qsts_agents_total",
    "Agent population size of the most recently executed agent-"
    "population QSTS study")
QSTS_RESUMES = REGISTRY.counter(
    "qsts_resumes_total", "QSTS jobs resumed from a chunk checkpoint")
QSTS_REQUEUED = REGISTRY.counter(
    "qsts_jobs_requeued_total",
    "QSTS jobs auto-requeued after a worker crash (resumed from their "
    "last chunk checkpoint instead of requiring manual resubmission)")

# -- topology sweeps (freedm_tpu_torch.pf.topo / POST /v1/topo) -------------
TOPO_VARIANTS = REGISTRY.counter(
    "topo_variants_screened_total",
    "Switch-state variants DC-screened by the topology sweep engine "
    "(sync /v1/topo requests and async sweep jobs combined)")
TOPO_RATE = REGISTRY.gauge(
    "topo_variants_per_sec",
    "Screen throughput of the most recent topology sweep chunk "
    "(radiality check + rank-r SMW lanes)")
TOPO_SCREEN_SECONDS = REGISTRY.histogram(
    "topo_screen_seconds",
    "Wall time per topology screen chunk (connectivity + SMW lanes + "
    "top-k merge)",
    buckets=(0.005, 0.02, 0.1, 0.5, 1.0, 5.0, 20.0, 60.0))
TOPO_SWEEPS = REGISTRY.counter(
    "topo_sweeps_total",
    "Async topology sweep jobs by final outcome "
    "(completed/failed/cancelled)",
    labels=("outcome",))
for _outcome in ("completed", "failed", "cancelled"):
    TOPO_SWEEPS.labels(_outcome)
TOPO_RESUMES = REGISTRY.counter(
    "topo_resumes_total",
    "Topology sweep jobs resumed from a chunk checkpoint")
TOPO_RUNNING = REGISTRY.gauge(
    "topo_sweeps_running",
    "Async topology sweeps currently executing on a job worker")
TOPO_REQUEUED = REGISTRY.counter(
    "topo_sweeps_requeued_total",
    "Topology sweeps auto-requeued after a worker crash (resumed from "
    "their last chunk checkpoint)")


def observe_pf_result(solver: str, result) -> None:
    """Record a solver result's iteration count and final residual.

    ``result`` is a Newton/Krylov-style result tuple whose
    ``iterations``/``mismatch`` fields the caller is already pulling to
    the host (a convergence check, a bench report, a summary); this reads
    them once more and adds no device work of its own.  Batched results
    record every lane's iteration count and the worst lane's residual;
    ``fallbacks``, where the result has them, add to
    ``pf_precision_fallbacks_total``."""

    def host(t):
        if hasattr(t, "detach"):
            t = t.detach().cpu().numpy()
        return np.asarray(t)

    PF_ITERATIONS.labels(solver).observe(np.ravel(host(result.iterations)))
    PF_RESIDUAL.labels(solver).set(float(np.max(host(result.mismatch))))
    fb = getattr(result, "fallbacks", None)
    if fb is not None:
        total = int(np.sum(host(fb)))
        if total:
            PF_FALLBACKS.labels(solver).inc(total)
