"""Admission control for the query-serving subsystem.

A copy of ``freedm_tpu/serve/queue.py`` (the port imports nothing of the
JAX package).

The serving path must never "queue forever": a grid operator's what-if
console and a planning screen's 500-outage sweep share one device, and
the only honest behaviors under overload are (a) a bounded wait and
(b) an explicit, *typed* rejection the client can back off on.  This
module is that boundary:

- the :class:`ServeError` hierarchy — every way a request can fail
  without an answer, each with a stable wire ``code`` and an HTTP status
  the front end (:mod:`freedm_tpu_torch.serve.http`) maps directly;
- :class:`Ticket` — one admitted request: its validated payload, its
  lane weight (an N-1 screen of 40 outages costs 40 lanes, a power-flow
  snapshot costs 1), its monotonic deadline, and the future its waiter
  blocks on;
- :class:`AdmissionQueue` — a bounded FIFO measured in *lanes*, not
  requests, so a single huge screen cannot sneak past a depth limit
  sized for snapshots.  ``put`` raises :class:`Overloaded` instead of
  blocking (shed-on-overload; the client retries with backoff, the
  server's latency distribution stays bounded); expired tickets are
  completed with :class:`DeadlineExceeded` at pop time so a stale
  request never wastes a solve.

Depth accounting feeds the ``serve_queue_depth`` gauge
(:mod:`freedm_tpu_torch.core.metrics`) on every transition, so a scrape sees
backpressure building before the shed counter moves.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple


class ServeError(Exception):
    """Base of the typed serving errors.

    ``code`` is the stable wire identifier (the JSON ``error.type``
    field); ``http_status`` is the front-end mapping.  Clients switch on
    ``code``, never on the message text.
    """

    code = "internal"
    http_status = 500
    #: Back-off hint (seconds) carried as a ``Retry-After`` header by
    #: the HTTP front end on retryable statuses (429/503); ``None`` on
    #: errors a client must not retry.
    retry_after_s: Optional[float] = None


class Overloaded(ServeError):
    """Admission rejected: the queue is at depth.  Shed-on-overload is
    deliberate — rejecting now with a typed error beats an unbounded
    queue whose p99 grows with depth."""

    code = "overloaded"
    http_status = 429
    retry_after_s = 1.0


class DeadlineExceeded(ServeError):
    """The request's deadline passed before a batch picked it up."""

    code = "deadline_exceeded"
    http_status = 504


class InvalidRequest(ServeError):
    """The request failed validation (unknown case, wrong vector length,
    islanding outage, non-finite values, ...)."""

    code = "invalid_request"
    http_status = 400


class ShuttingDown(ServeError):
    """The service is stopping.  Since the graceful-drain change this
    is only raised for work that was never admitted (submission after
    :meth:`AdmissionQueue.seal`, or tickets still queued when the drain
    budget ran out) — already-admitted tickets finish normally."""

    code = "shutting_down"
    http_status = 503
    retry_after_s = 2.0


class NotFound(ServeError):
    """The named resource (a job id, a disabled subsystem) does not
    exist on this server."""

    code = "not_found"
    http_status = 404


class Ticket:
    """One admitted request, queued for a batch slot."""

    __slots__ = (
        "key", "request", "prepared", "lanes", "enqueued_at",
        "deadline", "future", "taken", "cache_flight",
    )

    def __init__(self, key: Tuple[str, str], request, prepared, lanes: int,
                 deadline: Optional[float]):
        self.key = key  # (workload, case) — only same-key tickets batch
        self.request = request
        self.prepared = prepared  # engine-validated arrays
        self.lanes = int(lanes)
        self.enqueued_at = time.monotonic()
        self.deadline = deadline  # monotonic, or None
        self.future: Future = Future()
        self.taken = False  # popped from one index; lazily dropped from the other
        # Single-flight leadership (serve/cache.py): the (entry key,
        # injection digest) this ticket's solve populates, or None.
        self.cache_flight = None

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (time.monotonic() if now is None else now) > self.deadline


class AdmissionQueue:
    """Bounded FIFO of :class:`Ticket`\\ s, measured in lanes.

    Two indexes over the same tickets, both O(1) per operation at
    serving rates: a global arrival-order deque (head-of-line fairness
    across keys) and a per-key deque (the batcher's compatible-ticket
    drain).  A ticket popped through one index is flagged ``taken`` and
    lazily discarded when it surfaces at the other's head — no linear
    scans on the hot path.

    ``max_depth`` bounds the *sum of lane weights* waiting — the
    quantity that actually determines how much solve work is promised
    but not delivered.  Expired tickets are completed with
    :class:`DeadlineExceeded` when they surface at a head, so a stale
    request never wastes a solve.
    """

    def __init__(self, max_depth: int = 512, depth_gauge=None,
                 on_expired=None):
        self.max_depth = int(max_depth)
        self._cond = threading.Condition()
        self._fifo: deque = deque()
        self._by_key: Dict[Tuple[str, str], deque] = {}
        # Round-robin rotation over keys for pop_fair: every key ever
        # admitted, oldest-served first.  Bounded by the engine cache
        # (MAX_ENGINES × workloads), so empty keys just get skipped.
        self._rr: deque = deque()
        self._lanes = 0
        self._closed = False
        self._depth_gauge = depth_gauge
        self._on_expired = on_expired  # callback(ticket) for accounting

    # -- accounting ----------------------------------------------------------
    def _set_gauge_locked(self) -> None:
        if self._depth_gauge is not None:
            self._depth_gauge.set(self._lanes)

    @property
    def depth_lanes(self) -> int:
        with self._cond:
            return self._lanes

    # -- producer side -------------------------------------------------------
    def put(self, ticket: Ticket) -> None:
        """Admit or shed.  Raises :class:`Overloaded` when the ticket's
        lanes would push the queue past ``max_depth`` (the caller
        completes the future with the error and counts the shed), and
        :class:`ShuttingDown` after :meth:`close`."""
        with self._cond:
            if self._closed:
                raise ShuttingDown("service is stopping")
            if self._lanes + ticket.lanes > self.max_depth:
                raise Overloaded(
                    f"queue at depth ({self._lanes}/{self.max_depth} lanes); "
                    f"retry with backoff"
                )
            self._fifo.append(ticket)
            kq = self._by_key.get(ticket.key)
            if kq is None:
                kq = self._by_key[ticket.key] = deque()
                self._rr.append(ticket.key)
            kq.append(ticket)
            self._lanes += ticket.lanes
            self._set_gauge_locked()
            self._cond.notify_all()

    # -- consumer side (batcher thread) --------------------------------------
    def _take_locked(self, ticket: Ticket) -> None:
        ticket.taken = True
        self._lanes -= ticket.lanes
        self._set_gauge_locked()

    def pop(self, timeout: Optional[float] = None) -> Optional[Ticket]:
        """Oldest live ticket, blocking up to ``timeout`` seconds.
        Expired tickets encountered on the way are completed with
        :class:`DeadlineExceeded` and skipped."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            dead: List[Ticket] = []
            took = None
            with self._cond:
                now = time.monotonic()
                while self._fifo:
                    t = self._fifo[0]
                    if t.taken:
                        self._fifo.popleft()
                        continue
                    if t.expired(now):
                        self._fifo.popleft()
                        self._take_locked(t)
                        dead.append(t)
                        continue
                    self._fifo.popleft()
                    self._take_locked(t)
                    took = t
                    break
                if took is None and not dead:
                    remaining = None if deadline is None else deadline - now
                    if remaining is not None and remaining <= 0:
                        return None
                    if self._closed:
                        # Sealed and empty: nothing can arrive (put
                        # raises), but honoring the timeout keeps the
                        # draining batcher from spinning hot.
                        self._cond.wait(remaining if remaining is not None
                                        else 0.2)
                        return None
                    self._cond.wait(remaining)
                    continue
            self._fail_expired(dead)
            if took is not None:
                return took

    def pop_fair(self, timeout: Optional[float] = None,
                 key_ok=None) -> Optional[Ticket]:
        """Oldest live ticket of the least-recently-served (workload,
        case) key — round-robin across keys, so one hot tenant cannot
        starve the others' batch assembly.  ``key_ok(key)`` (optional)
        gates keys for this pass: the pipelined batcher passes its
        executor-lane capacity check, so a key whose lane is full is
        skipped instead of blocking assembly for everyone.  Expired
        tickets encountered on the way are completed with
        :class:`DeadlineExceeded` and skipped."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            dead: List[Ticket] = []
            took = None
            skipped = False  # a live key was gated off by key_ok
            with self._cond:
                now = time.monotonic()
                # Amortized cleanup of the global index: pop_fair never
                # reads _fifo, so lazily drop the taken heads here to
                # keep it from growing without bound.
                while self._fifo and self._fifo[0].taken:
                    self._fifo.popleft()
                for _ in range(len(self._rr)):
                    key = self._rr[0]
                    self._rr.rotate(-1)
                    kq = self._by_key.get(key)
                    while kq:
                        t = kq[0]
                        if t.taken:
                            kq.popleft()
                            continue
                        if t.expired(now):
                            kq.popleft()
                            self._take_locked(t)
                            dead.append(t)
                            continue
                        break
                    if not kq:
                        continue
                    if key_ok is not None and not key_ok(key):
                        skipped = True
                        continue
                    t = kq.popleft()
                    self._take_locked(t)
                    took = t
                    break
                if took is None and not dead:
                    remaining = None if deadline is None else deadline - now
                    if remaining is not None and remaining <= 0:
                        return None
                    if self._closed:
                        # Sealed and empty (see pop()): wait out the
                        # timeout instead of hot-spinning the caller —
                        # but keep the short re-check bound while a
                        # gated key still holds drainable tickets.
                        w = remaining if remaining is not None else 0.2
                        self._cond.wait(min(w, 0.05) if skipped else w)
                        return None
                    # A gated key's lane drains without notifying this
                    # condition — wake on a short bound to re-check.
                    if skipped:
                        remaining = 0.05 if remaining is None \
                            else min(remaining, 0.05)
                    self._cond.wait(remaining)
                    continue
            self._fail_expired(dead)
            if took is not None:
                return took

    def pop_compatible(self, key: Tuple[str, str], max_lanes: int,
                       timeout: float) -> Optional[Ticket]:
        """Oldest queued ticket with this ``key`` whose lanes fit in
        ``max_lanes``, blocking up to ``timeout`` for one to arrive.
        A head ticket too big for the remaining batch space stays put
        (it opens the next batch); other keys' tickets are untouched."""
        deadline = time.monotonic() + max(timeout, 0.0)
        while True:
            dead: List[Ticket] = []
            took = None
            blocked = False  # head fits the key but not the batch space
            with self._cond:
                now = time.monotonic()
                kq = self._by_key.get(key)
                while kq:
                    t = kq[0]
                    if t.taken:
                        kq.popleft()
                        continue
                    if t.expired(now):
                        kq.popleft()
                        self._take_locked(t)
                        dead.append(t)
                        continue
                    if t.lanes <= max_lanes:
                        kq.popleft()
                        self._take_locked(t)
                        took = t
                    else:
                        blocked = True
                    break
                if took is None and not dead:
                    if blocked or self._closed:
                        return None
                    remaining = deadline - now
                    if remaining <= 0:
                        return None
                    self._cond.wait(remaining)
                    continue
            self._fail_expired(dead)
            if took is not None:
                return took
            if time.monotonic() >= deadline:
                return None

    def _fail_expired(self, dead: List[Ticket]) -> None:
        for t in dead:
            if self._on_expired is not None:
                self._on_expired(t)
            else:
                t.future.set_exception(
                    DeadlineExceeded("deadline passed while queued")
                )

    # -- shutdown ------------------------------------------------------------
    def seal(self) -> None:
        """Refuse NEW work (``put`` raises :class:`ShuttingDown`) while
        keeping every already-admitted ticket poppable — the graceful-
        drain half of shutdown: the batcher keeps dispatching what was
        promised, only not-yet-admitted work sees the typed error."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def close(self) -> List[Ticket]:
        """Refuse new work and return the still-queued tickets (the
        service drains them with :class:`ShuttingDown`)."""
        with self._cond:
            self._closed = True
            drained = [t for t in self._fifo if not t.taken]
            for t in drained:
                self._take_locked(t)
            self._fifo.clear()
            self._by_key.clear()
            self._cond.notify_all()
        return drained
