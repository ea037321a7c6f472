"""Pipelined micro-batching dispatch: assemble on one lane, execute on
per-workload lanes, scatter after the one device sync.

Port of ``freedm_tpu/serve/batcher.py``.  A batched dense Newton solve
costs far less per lane than a lone one, so the batcher turns concurrent
independent requests into batched device work.  It is a two-stage
pipeline:

- **Batch-assembly lane** (one thread) — pops the admission queue
  *fairly across (workload, case) keys* (:meth:`AdmissionQueue.pop_fair`),
  coalesces compatible tickets, buckets/pads them (``engine.assemble``,
  host numpy), and hands the assembled batch to its workload's executor
  lane over a **bounded handoff queue** (``pipeline_depth`` batches
  deep), so assembly of batch N+1 overlaps the device work of batch N.
- **Device-executor lanes** (one thread per workload) — run
  ``engine.solve`` (kernels launch on the thread's current CUDA stream;
  ctypes launches release the interpreter lock), wait for the device
  ONCE at the measurement boundary (``engine.synchronize()``, a sync of
  the stream the solve ran on — so ``serve_solve_seconds`` is honest
  device wall, not enqueue time, and waits for no delta answer's work
  on its own stream), and scatter results to the waiters.

``pipeline_depth=0`` keeps the single-thread path — the same
``_assemble``/``_execute`` code run inline on the dispatch thread — as
the equivalence oracle.

Batching semantics:

- **Coalescing window** — the first admitted ticket opens a batch; the
  assembly lane drains compatible tickets (same (workload, case) key)
  for up to ``max_wait_ms`` or ``max_batch`` lanes.  Adaptive: a lone
  ticket whose device lane would otherwise starve dispatches at once;
  while the lane is busy the batch keeps coalescing (self-clocking
  batch sizing).
- **Shape buckets** — real lanes pad up to the smallest bucket.  The
  first dispatch of each (engine, bucket) is counted on
  ``serve_recompiles_total`` and attributed in ``recompiles_by_bucket``.
- **Failure containment** — a solver exception on an executor lane
  fails only that batch's tickets with a typed ``internal`` error; the
  lane thread and the assembly lane keep running.  A failed batch also
  fails any single-flight followers parked on its tickets' cache digests
  (``Service._complete_error`` → ``_abort_flight``).
- **Incremental tier upstream** — with the serving cache on, exact and
  verified-delta pf answers complete at submit time
  (:mod:`freedm_tpu_torch.serve.cache`) and never occupy queue depth, a
  coalescing window or a dispatch here; the batches this loop does
  dispatch populate the cache after their scatter (the engine's
  ``publish`` hook), which is where single-flight followers are answered
  from their leader's lane.

The reference's tracing spans, profiler, roofline and fault-injection
hooks are not ported yet (``ROADMAP.md``).
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from typing import Dict, List, Optional

from freedm_tpu_torch.core import metrics as obs
from freedm_tpu_torch.serve.queue import ServeError, ShuttingDown, Ticket


class _InternalError(ServeError):
    code = "internal"
    http_status = 500


class _KeyState:
    """Per-(workload, case) accumulation state on the assembly lane.

    ``open_*`` is the batch currently coalescing (its ``deadline`` is
    the coalescing-window expiry); ``ready`` is an overflow batch that
    filled while its executor lane had no room and waits for a slot.
    Batches accumulate exactly while the device is busy — the
    self-clocking dynamic-batching effect the pipeline exists for."""

    __slots__ = ("open_group", "open_lanes", "deadline", "ready")

    def __init__(self):
        self.open_group: List[Ticket] = []
        self.open_lanes = 0
        self.deadline = 0.0
        self.ready = None  # Optional[(group, lanes)]


class _Assembled:
    """One assembled batch in flight between the stages."""

    __slots__ = ("group", "lanes", "workload", "case", "engine", "bucket",
                 "batch", "new_shape", "inline")

    def __init__(self, group, lanes, workload, case, engine, bucket, batch,
                 new_shape, inline):
        self.group = group
        self.lanes = lanes
        self.workload = workload
        self.case = case
        self.engine = engine
        self.bucket = bucket
        self.batch = batch
        self.new_shape = new_shape
        self.inline = inline


class ExecutorLane:
    """One bounded device-executor lane (one daemon thread) per workload.

    The assembly lane feeds it assembled batches over a
    ``pipeline_depth``-deep queue; the lane dispatches the solve,
    blocks at the deferred sync point, and scatters.  A crashed batch
    fails only its own tickets; the lane keeps consuming."""

    def __init__(self, batcher: "MicroBatcher", workload: str, depth: int):
        self.batcher = batcher
        self.workload = workload
        self.depth = max(int(depth), 1)
        self._q: _queue.Queue = _queue.Queue(maxsize=self.depth)
        self._executing = False
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ExecutorLane":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name=f"serve-exec-{self.workload}",
                daemon=True,
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        self._drain()

    def _drain(self) -> None:
        while True:
            try:
                work = self._q.get_nowait()
            except _queue.Empty:
                break
            self._fail(work, ShuttingDown("service stopped"))
        self._set_inflight()

    def _fail(self, work: _Assembled, err: BaseException) -> None:
        for t in work.group:
            self.batcher.service._complete_error(t, err)

    # -- handoff (assembly lane side) ----------------------------------------
    def has_room(self) -> bool:
        """True while the handoff queue can take another batch — the
        assembly lane's ``pop_fair`` predicate, so a full lane's key is
        skipped instead of blocking assembly for everyone."""
        return self._q.qsize() < self.depth

    def submit(self, work: _Assembled) -> bool:
        """Enqueue one assembled batch (bounded; the pop_fair gate
        makes blocking here a rare race, not the steady state)."""
        while not self._stop.is_set():
            try:
                self._q.put(work, timeout=0.1)
            except _queue.Full:
                continue
            self._set_inflight()
            return True
        self._fail(work, ShuttingDown("service stopped"))
        return False

    # -- state for /stats and the assembly lane -----------------------------
    def busy(self) -> bool:
        return self._executing or not self._q.empty()

    def queued(self) -> int:
        return self._q.qsize()

    def _set_inflight(self) -> None:
        obs.SERVE_INFLIGHT.labels(self.workload).set(
            self._q.qsize() + (1 if self._executing else 0)
        )

    # -- executor loop -------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                work = self._q.get(timeout=0.2)
            except _queue.Empty:
                continue
            self._executing = True
            try:
                self._set_inflight()
                self.batcher._execute(work)
            finally:
                self._executing = False
                self._set_inflight()
        self._drain()


class MicroBatcher:
    """The two-stage dispatch pipeline of a
    :class:`~freedm_tpu_torch.serve.service.Service` (assembly thread +
    per-workload :class:`ExecutorLane` threads; one inline thread when
    ``pipeline_depth=0``)."""

    def __init__(self, service, config):
        self.service = service
        self.config = config
        self.buckets = config.bucket_table()
        self.pipeline_depth = max(
            int(getattr(config, "pipeline_depth", 0)), 0
        )
        #: Executor lanes by workload; empty on the legacy
        #: (``pipeline_depth=0``) path.  Built at :meth:`start`.
        self.lanes: Dict[str, ExecutorLane] = {}
        # Per-shape attribution: "workload/case:bucket" -> first
        # dispatches of that shape, exposed by /stats.  Guarded by
        # _shapes_lock together with every engine's compiled_buckets set:
        # the assembly lane claims shapes while executor lanes run and
        # /stats readers iterate.
        self.recompiles_by_bucket: dict = {}
        #: Shapes run at startup by :meth:`Service.prewarm` — shown
        #: in /stats, excluded from ``serve_recompiles_total``.
        self.prewarmed: set = set()
        # Measured padding accounting (ints mutated under the GIL, read
        # by /stats): real lanes dispatched vs pad lanes the bucket
        # table added on top.  /stats derives the observed padding
        # fraction from these — the live counterpart of the table's
        # analytic worst case (service.padding_waste_pct).
        self.dispatched_lanes = 0
        self.padded_lanes = 0
        self._shapes_lock = threading.Lock()
        self._dispatching = False
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "MicroBatcher":
        if self.pipeline_depth > 0 and not self.lanes:
            from freedm_tpu_torch.serve.service import WORKLOADS

            for w in WORKLOADS:
                self.lanes[w] = ExecutorLane(
                    self, w, self.pipeline_depth
                ).start()
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="serve-batcher", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        for lane in self.lanes.values():
            lane.stop(timeout=timeout)

    # -- bucketing -----------------------------------------------------------
    def bucket_for(self, lanes: int) -> int:
        for b in self.buckets:
            if lanes <= b:
                return b
        return self.buckets[-1]

    # -- shape claims (assembly lane + prewarm + /stats) ---------------------
    def _claim_shape(self, engine, workload: str, case: str,
                     bucket: int) -> bool:
        """Atomically claim the first dispatch of (engine, bucket);
        True exactly once per shape.  Prewarmed shapes were claimed at
        startup and never count on ``serve_recompiles_total``."""
        with self._shapes_lock:
            if bucket in engine.compiled_buckets:
                return False
            engine.compiled_buckets.add(bucket)
            key = f"{workload}/{case}:{bucket}"
            self.recompiles_by_bucket[key] = (
                self.recompiles_by_bucket.get(key, 0) + 1
            )
        obs.SERVE_RECOMPILES.labels(workload).inc()
        return True

    def _unclaim_shape(self, engine, bucket: int) -> None:
        """A claimed first dispatch failed before its solve completed:
        un-mark the bucket so the retry re-claims it.  The counter/table
        keep their increment — the retry counts again."""
        with self._shapes_lock:
            engine.compiled_buckets.discard(bucket)

    def note_prewarmed(self, engine, bucket: int) -> None:
        """Record a startup-run (engine, bucket): tagged in the
        /stats table (count 0 = no request-driven first dispatch) and
        excluded from ``serve_recompiles_total``."""
        workload, case = engine.key
        key = f"{workload}/{case}:{bucket}"
        with self._shapes_lock:
            engine.compiled_buckets.add(bucket)
            self.recompiles_by_bucket.setdefault(key, 0)
            self.prewarmed.add(key)

    def shape_table(self) -> dict:
        """Locked snapshot of ``recompiles_by_bucket`` for /stats."""
        with self._shapes_lock:
            return dict(self.recompiles_by_bucket)

    def busy(self) -> bool:
        """True while the pipeline owes progress: a batch is being
        assembled/executed, or admitted lanes are waiting for one."""
        return (
            self._dispatching
            or self.service.queue.depth_lanes > 0
            or any(lane.busy() for lane in self.lanes.values())
        )

    # -- assembly loop -------------------------------------------------------
    def _run(self) -> None:
        if self.lanes:
            self._run_pipelined()
        else:
            self._run_serial()

    def _run_serial(self) -> None:
        """The legacy single-thread path (``--serve-pipeline-depth 0``):
        coalesce, assemble, solve, block, and scatter inline — the
        equivalence oracle the pipeline is tested against."""
        q = self.service.queue
        window_s = max(self.config.max_wait_ms, 0.0) / 1000.0
        while not self._stop.is_set():
            head = q.pop(timeout=0.2)
            if head is None:
                continue
            group = [head]
            lanes = head.lanes
            window_end = time.monotonic() + window_s
            while lanes < self.config.max_batch:
                if q.depth_lanes == 0:
                    # Adaptive coalescing: nothing queued behind this
                    # batch — dispatch now instead of sleeping out the
                    # window (the old flat low-load latency tax).
                    break
                remaining = window_end - time.monotonic()
                if remaining <= 0:
                    break
                t = q.pop_compatible(
                    head.key, self.config.max_batch - lanes, remaining
                )
                if t is None:
                    break
                group.append(t)
                lanes += t.lanes
            self._dispatch(group, lanes)

    def _run_pipelined(self) -> None:
        """The pipelined assembly loop: shared coalescing windows.

        Unlike the serial path, the assembly thread never sits inside
        one key's window while other keys' work waits — it pops tickets
        fairly into per-key *open batches* and flushes each batch when
        it fills, its window expires, or nothing else is queued
        (adaptive).  A batch whose executor lane is full keeps
        accumulating instead of blocking — batch size self-clocks to
        device speed, which is what keeps dispatch overhead off the
        critical path."""
        q = self.service.queue
        window_s = max(self.config.max_wait_ms, 0.0) / 1000.0
        states: dict = {}  # key -> _KeyState
        max_batch = self.config.max_batch

        def lane_room(key) -> bool:
            lane = self.lanes.get(key[0])
            return lane.has_room() if lane is not None else True

        def lane_idle(key) -> bool:
            lane = self.lanes.get(key[0])
            return not lane.busy() if lane is not None else True

        def flush_open(key, st) -> None:
            group, lanes = st.open_group, st.open_lanes
            st.open_group, st.open_lanes = [], 0
            self._dispatch(group, lanes)

        def key_can_take(key) -> bool:
            st = states.get(key)
            if st is None:
                return True
            # Stop popping a key only when both its buffers are spoken
            # for: an overflow batch parked AND a full open batch.
            return not (st.ready is not None
                        and st.open_lanes >= max_batch)

        while not self._stop.is_set():
            now = time.monotonic()
            pending = False  # anything coalescing or parked
            for key, st in states.items():
                room = lane_room(key)
                if st.ready is not None and room:
                    group, lanes = st.ready
                    st.ready = None
                    self._dispatch(group, lanes)
                    room = lane_room(key)
                if st.open_lanes:
                    # Flush when full, when the window expired, or when
                    # there is no coalescing upside left (nothing
                    # admitted and the lane is starving).
                    due = (st.open_lanes >= max_batch
                           or now >= st.deadline
                           or (q.depth_lanes == 0 and lane_idle(key)))
                    if due and st.ready is None and room:
                        flush_open(key, st)
                    else:
                        pending = True
                elif st.ready is not None:
                    pending = True
            timeout = 0.2
            if pending:
                # Window expiry and lane drains do not signal the
                # admission queue's condition — poll on a short bound
                # while anything is coalescing or parked.
                timeout = 0.002
            t = q.pop_fair(timeout=timeout, key_ok=key_can_take)
            if t is None:
                if q.depth_lanes == 0:
                    # Adaptive: nothing admitted and the lane would
                    # starve — flush its open batch now.  A BUSY lane's
                    # batch keeps coalescing instead (it could not
                    # start any sooner anyway, so waiting costs no
                    # latency and buys batch fill).
                    for key, st in states.items():
                        if st.open_lanes and st.ready is None \
                                and lane_idle(key):
                            flush_open(key, st)
                continue
            st = states.get(t.key)
            if st is None:
                st = states[t.key] = _KeyState()
            if st.open_lanes and st.open_lanes + t.lanes > max_batch:
                # The ticket straddles the batch boundary: park the
                # full open batch.  If an older batch is already
                # parked, force IT out first (blocking submit, bounded
                # by the lane's execution time) — the older tickets
                # must dispatch before the newer ones so same-key FIFO
                # completion order holds.
                if st.ready is not None:
                    group, lanes = st.ready
                    st.ready = None
                    self._dispatch(group, lanes)
                st.ready = (st.open_group, st.open_lanes)
                st.open_group, st.open_lanes = [], 0
            if not st.open_lanes:
                st.deadline = time.monotonic() + window_s
            st.open_group.append(t)
            st.open_lanes += t.lanes
            if q.depth_lanes == 0 and st.ready is None \
                    and lane_idle(t.key):
                # Adaptive coalescing: nothing queued behind this
                # ticket and its lane is starving — dispatch now
                # instead of waiting the window.
                flush_open(t.key, st)
        # Stop: fail whatever was still coalescing (the admission queue
        # was already drained by Service.stop with the same error).
        err = ShuttingDown("service stopped")
        for st in states.values():
            groups = []
            if st.ready is not None:
                groups.append(st.ready[0])
            if st.open_lanes:
                groups.append(st.open_group)
            for group in groups:
                for t in group:
                    self.service._complete_error(t, err)

    # -- dispatch ------------------------------------------------------------
    def _dispatch(self, group: List[Ticket], lanes: int) -> None:
        self._dispatching = True
        try:
            work = self._assemble(group, lanes)
            if work is None:
                return  # assembly failed; its tickets were completed
            lane = self.lanes.get(work.workload)
            if lane is not None:
                lane.submit(work)
            else:
                self._execute(work)
        finally:
            self._dispatching = False

    # -- stage 1: host-side assembly -----------------------------------------
    def _assemble(self, group: List[Ticket],
                  lanes: int) -> Optional[_Assembled]:
        workload, case = group[0].key
        try:
            engine = self.service.engine(workload, case)
            bucket = self.bucket_for(lanes)
            obs.SERVE_BATCH_LANES.labels(workload).observe(lanes)
            self.dispatched_lanes += lanes
            self.padded_lanes += max(bucket - lanes, 0)
            batch = engine.assemble(group, bucket)
            # Claim the shape only once assembly succeeded: a failed
            # batch must not mark its bucket run.
            new_shape = self._claim_shape(engine, workload, case, bucket)
            return _Assembled(
                group=group, lanes=lanes, workload=workload, case=case,
                engine=engine, bucket=bucket, batch=batch,
                new_shape=new_shape, inline=not self.lanes,
            )
        except Exception as e:  # noqa: BLE001 — waiters must never hang
            err = _InternalError(f"batch assembly failed: {e!r}")
            for t in group:
                self.service._complete_error(t, err)
            return None

    # -- stage 2: device execution + scatter (executor lane / inline) --------
    def _execute(self, work: _Assembled) -> None:
        from freedm_tpu_torch.serve.service import BatchInfo

        group = work.group
        engine = work.engine
        workload = work.workload
        t_host0 = time.monotonic()
        # Queue wait is admission -> start of device dispatch, so the
        # handoff-queue time on the executor lane is included.
        obs.SERVE_QUEUE_WAIT.observe(
            [max(t_host0 - t.enqueued_at, 0.0) for t in group]
        )
        try:
            t0 = time.monotonic()
            results = engine.solve(work.batch)
            # The ONE designed device sync, at the measurement boundary:
            # solve_s is device wall time, not enqueue time.
            engine.synchronize()
            solve_s = time.monotonic() - t0
            obs.SERVE_SOLVE_LATENCY.labels(workload).observe(solve_s)
            info = BatchInfo(
                lanes=work.lanes,
                bucket=work.bucket,
                # Admission -> device dispatch (incl. the executor
                # handoff), measured from the head-of-batch ticket.
                queue_ms=round((t_host0 - group[0].enqueued_at) * 1e3, 3),
                solve_ms=round(solve_s * 1e3, 3),
                tier="full",
            )
            host = engine.scatter(group, results, info)
            if engine.publish is not None:
                # Incremental tier: insert converged lanes into the serving
                # cache and settle the single-flight followers parked on
                # these tickets' digests (host arrays only).
                engine.publish(engine, group, *host, info)
            for t in group:
                self.service._complete_ok(t, info)
        except Exception as e:  # noqa: BLE001 — waiters must never hang
            if work.new_shape:
                self._unclaim_shape(engine, work.bucket)
            err = _InternalError(f"batch dispatch failed: {e!r}")
            for t in group:
                self.service._complete_error(t, err)
