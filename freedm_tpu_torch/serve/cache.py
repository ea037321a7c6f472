"""Incremental serving tier: base-case factorization and solution reuse.

Port of ``freedm_tpu/serve/cache.py``.  Most what-if queries are small
deltas against a shared base case, yet a cold serve path runs every
``POST /v1/pf`` as a full Newton solve from flat start.  This module
keeps, per (case, topology, pf_backend), the case's converged solutions
plus the reusable solve artifacts:

- the FDLF B′/B″ LU pair
  (:func:`freedm_tpu_torch.pf.krylov.build_fdlf_precond` with
  ``kind="lu"``), factorized once per (case, topology) and reused by
  every delta answer;
- the symbolic Jacobian pattern
  (:func:`freedm_tpu_torch.pf.sparse.jacobian_pattern`) for
  sparse-backend cases.

Three answer tiers, cheapest first (:class:`ServeCache` classifies,
:class:`~freedm_tpu_torch.serve.service.Service` acts):

1. **exact** — the request's injection vector is byte-identical to a
   cached solution: answered from host memory, no device touch at all.
2. **delta** — the injections differ from a cached solution at ≤
   ``delta_max_rank`` buses (and ≤ ``delta_max_pu`` per bus): answered by
   warm-started fast-decoupled sweeps whose inner solve is rank-0
   :func:`freedm_tpu_torch.pf.n1.smw_delta_solve` over the cached LU pair
   (:func:`_build_delta_program`; on the card the whole program is one
   launch of kernel C1, :class:`~freedm_tpu_torch.kernels.cache_kernels.
   DeltaProgram`).  Every delta answer is verified by a host float64
   residual check (:func:`freedm_tpu_torch.pf.krylov.host_injections`);
   a residual above the engine tolerance falls through to tier 3, so a
   wrong answer is never served.
3. **warm** — too big a delta to correct: the full solve proceeds,
   seeded with the nearest cached solution through the ``v0``/``theta0``
   warm-start path.

Plus the machinery a shared cache needs: **invalidation** keyed on a
topology digest (a mutated case hashes to a different entry, so a stale
solution is unreachable), **LRU + TTL eviction** accounted in bytes
against the ``cache_mb`` budget (artifacts included), and
**single-flight population** — concurrent identical cold requests elect
one leader ticket; followers ride its solve and are answered at scatter
time.

Threading and streams: one cache lock guards the maps and the byte
account (lookups are host work: dict probes and O(n) numpy compares);
artifact builds run under a per-entry build lock.  Delta programs run
one at a time, combined: the submitting thread that holds the program
lock runs every pending delta request of its entry as the lanes of one
program call, so concurrent answers share one launch and one thread's
host work (each extra thread would contend with the batcher's
host-bound solve for the interpreter lock).
On the card the program runs on a CUDA stream of the cache's own and its
results come back with a sync of that stream alone: it is not queued
behind a batched solve in stream order, though it shares the card's SMs
and the interpreter lock with one, and the batcher's sync of its own
stream waits for no delta work.  An entry's LU pair is factorized on the building thread's stream,
which is synchronized before the build returns; the delta program's
operands (and on the card the factors in the kernel's layout — a
float32 copy under ``precision="mixed"``, the float64 factors themselves
where their columns are 16-byte aligned — and its buffers) are
synchronized the same way when the program is built, so no other stream
reads them unfinished.  A copy is made once per entry and is not counted
in the byte account (the reference does not count its float32 copy
either).

``CaseEntry.dc_solver`` builds the DC screen of
:mod:`freedm_tpu_torch.pf.dc` on the entry's own B′ LU pair, once, and the
``topo`` engine screens its variants on the same pair
(``TopoEngine.attach_cache_lu``).  Not ported here: provenance receipts, the
``serve.cache.corrupt`` fault point, the profiler's host spans, the
loose-accept event journal and ``snapshot_state`` (item 15).
"""

from __future__ import annotations

import contextlib
import hashlib
import logging
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from freedm_tpu_torch.core import metrics as obs
from freedm_tpu_torch.device import (DeviceLike, platform_name,
                                     resolve_device, stream_synchronize)
from freedm_tpu_torch.grid.bus import PQ, SLACK
from freedm_tpu_torch.kernels import cache_kernels as ck
from freedm_tpu_torch.pf.backend import resolve_backend, resolve_precision
from freedm_tpu_torch.pf.krylov import build_fdlf_precond, host_injections
from freedm_tpu_torch.pf.mfree import delta_operands
from freedm_tpu_torch.pf.sparse import jacobian_pattern

#: Recent solutions scanned per lookup for the nearest delta/warm base.
DELTA_SCAN = 8

#: Fast-decoupled correction sweeps the delta tier may spend before the
#: residual check decides (the program exits early on convergence).
DELTA_MAX_SWEEPS = 30

#: Per-bus injection deltas above this (pu) are not worth a
#: linear-regime correction: straight to the warm tier.
DELTA_MAX_PU = 0.5

#: Minimum seconds between full TTL sweeps of one entry's solution list:
#: a sweep is O(solutions) under the global lock, so it must not run on
#: every lookup (freshness is still enforced per served candidate).
_TTL_SWEEP_S = 1.0

_TIERS = ("exact", "delta", "warm", "miss")

_log = logging.getLogger(__name__)


def injection_digest(p: np.ndarray, q: np.ndarray) -> str:
    """Content key of one injection pair (exact-hit identity)."""
    return hashlib.sha1(p.tobytes() + q.tobytes()).hexdigest()


def topology_digest(sys) -> str:
    """Digest of everything that shapes the network matrices — bus
    types, shunts, setpoints and the full branch table.  Injections are
    excluded (they are the delta dimension); any other mutation (an
    outage baked into ``x``, a retap, an added branch) changes the
    digest, so a stale entry is unreachable rather than invalid."""
    h = hashlib.sha1()
    for arr in (sys.bus_type, sys.v_set, sys.g_shunt, sys.b_shunt,
                sys.from_bus, sys.to_bus, sys.r, sys.x, sys.b_chg,
                sys.tap, sys.shift):
        h.update(np.ascontiguousarray(arr).tobytes())
    h.update(repr((sys.n_bus, sys.n_branch, float(sys.base_mva))).encode())
    return h.hexdigest()[:16]


def _nbytes(x) -> int:
    """Recursive byte size of numpy arrays and torch tensors (tuples and
    lists walked)."""
    if x is None:
        return 0
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(e) for e in x)
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    size = getattr(x, "size", None)
    itemsize = getattr(getattr(x, "dtype", None), "itemsize", None)
    if size is not None and itemsize is not None:
        return int(size) * int(itemsize)
    return 0


class CachedSolution:
    """One converged operating point of a cached case: the injections it
    answers exactly, the solution state, and the response stamps."""

    __slots__ = ("digest", "p_inj", "q_inj", "v", "theta", "p", "q",
                 "iterations", "mismatch", "converged", "stamp", "nbytes")

    def __init__(self, digest: str, p_inj, q_inj, v, theta, p, q,
                 iterations: int, mismatch: float, converged: bool):
        self.digest = digest
        # Copies: scatter hands batch-row views, and storing them would
        # pin the whole padded batch and falsify the byte accounting.
        self.p_inj = np.array(p_inj, np.float64)
        self.q_inj = np.array(q_inj, np.float64)
        self.v = np.array(v, np.float64)
        self.theta = np.array(theta, np.float64)
        self.p = np.array(p, np.float64)
        self.q = np.array(q, np.float64)
        self.iterations = int(iterations)
        self.mismatch = float(mismatch)
        self.converged = bool(converged)
        self.stamp = time.monotonic()
        self.nbytes = sum(
            a.nbytes for a in (self.p_inj, self.q_inj, self.v, self.theta,
                               self.p, self.q)
        ) + 128  # key/slot overhead, order-of-magnitude honest


class CaseEntry:
    """One (case, topology, pf_backend)'s artifacts and solution store.

    ``precond`` is the ``kind="lu"`` FDLF pair on the cache's device;
    ``pattern`` the symbolic Jacobian pattern (sparse-backend cases);
    ``delta_fn`` the correction program.  ``solutions`` is digest →
    :class:`CachedSolution`, LRU-ordered, manipulated only under the
    owning cache's lock."""

    __slots__ = ("key", "case", "sys", "backend", "tol", "device",
                 "build_lock", "precond", "pattern", "delta_fn",
                 "solutions", "artifact_bytes", "accounted", "alive",
                 "last_used", "ttl_sweep", "_th_free", "_v_free",
                 "precision", "_dc")

    def __init__(self, case: str, sys, backend: str, topo: str,
                 precision: str = "f64", device: DeviceLike = None):
        self.key = (case, topo, backend)
        self.case = case
        self.sys = sys
        self.backend = backend
        self.precision = precision
        self.device = resolve_device(device)
        self.build_lock = threading.Lock()
        self.precond = None
        self.pattern = None
        self.delta_fn = None
        self._dc = None
        self.solutions: "OrderedDict[str, CachedSolution]" = OrderedDict()
        self.artifact_bytes = 0
        # artifact_bytes has been added to the owning cache's byte
        # account (guarded by the cache lock on the add and on every
        # subtract, so a racing invalidate never drives it negative).
        self.accounted = False
        self.alive = True
        self.last_used = time.monotonic()
        self.ttl_sweep = 0.0  # last full TTL sweep (time-gated)
        self._th_free = np.asarray(sys.bus_type) != SLACK
        self._v_free = np.asarray(sys.bus_type) == PQ
        # The engines' working dtype is float64, the reference's
        # tolerance for it.
        self.tol = 1e-8

    # -- artifacts (built once, under build_lock) ----------------------------
    def build_artifacts(self) -> None:
        """Factorize the FDLF pair (and take the Jacobian pattern on
        sparse-backend cases) — the one-time per-(case, topology) cost
        every tier amortizes.  Idempotent; callers serialize on
        ``build_lock``.  The factorization is complete on the device
        when this returns."""
        if self.precond is not None:
            return
        precond = build_fdlf_precond(self.sys, dtype=torch.float64,
                                     kind="lu", device=self.device)
        stream_synchronize(self.device)
        pattern = None
        if resolve_backend(self.backend, self.sys.n_bus) == "sparse":
            pattern = jacobian_pattern(self.sys)
        self.artifact_bytes = _nbytes(precond.bp) + _nbytes(precond.bq)
        if pattern is not None:
            # The pattern's index arrays are held alive by this entry:
            # the branch ends and the row-scatter indices (the
            # reference's ``rows``, 2m int64; here the incidence list's
            # codes and neighbours, 2 × 2m int32 — the same bytes).
            self.artifact_bytes += (
                _nbytes(pattern.f) + _nbytes(pattern.t)
                + _nbytes(pattern.inc_code) + _nbytes(pattern.inc_nbr)
            )
        self.pattern = pattern
        self.precond = precond

    def ensure_delta_fn(self):
        """The correction program (built lazily on the first delta
        answer, or at :meth:`ServeCache.prewarm_entry`)."""
        with self.build_lock:
            self.build_artifacts()
            if self.delta_fn is None:
                self.delta_fn = _build_delta_program(
                    self.sys, self.precond, self.tol, DELTA_MAX_SWEEPS,
                    precision=self.precision, device=self.device,
                )
        return self.delta_fn

    def dc_solver(self):
        """DC screen over this case, sharing the entry's B′ LU pair (no
        second factorization — ``make_dc_solver(lu=...)``); built once,
        under the build lock."""
        with self.build_lock:
            self.build_artifacts()
            if self._dc is None:
                from freedm_tpu_torch.pf.dc import make_dc_solver

                self._dc = make_dc_solver(self.sys, lu=self.precond.bp,
                                          device=self.device)
        return self._dc

    def verify(self, theta: np.ndarray, v: np.ndarray, p_req: np.ndarray,
               q_req: np.ndarray) -> float:
        """Host float64 residual of a candidate solution against the
        request's injections — the delta tier's accept/fall-through
        gate, the solver oracles' own
        :func:`~freedm_tpu_torch.pf.krylov.host_injections`."""
        p_calc, q_calc = host_injections(self.sys, theta, v)
        fp = np.where(self._th_free, p_calc - p_req, 0.0)
        fq = np.where(self._v_free, q_calc - q_req, 0.0)
        return np.float64(max(np.max(np.abs(fp)), np.max(np.abs(fq))))


def _build_delta_program(sys, precond, tol: float, max_sweeps: int,
                         precision: str = "f64", device: DeviceLike = None):
    """The delta tier's correction: warm-started fast-decoupled sweeps
    whose inner solve is rank-0 ``smw_delta_solve`` over the cached LU
    pair (an injection delta moves only the right-hand side), iterated
    until the mismatch clears ``tol`` or ``max_sweeps`` run out.

    Returns ``correct(theta0, v0, p_sched, q_sched) -> (theta, v, p_calc,
    q_calc, err, sweeps)``, a :class:`~freedm_tpu_torch.kernels.
    cache_kernels.DeltaProgram`.  The arguments are ``[n]`` (one answer;
    then ``err`` and ``sweeps`` are 0-d) or ``[B, n]`` lanes, numpy or
    float64 tensors.  Each lane runs the reference's ``while_loop``: the
    exit test ``it < max_sweeps and err >= tol`` before each sweep, the
    sweep ``theta += solve_p(dp)·th_free``, ``dq = mismatch(theta,
    v).dq``, ``v += solve_q(dq)·v_free``, ``dp, dq = mismatch(theta, v)``;
    a lane that is done stops updating.  On the card one launch of kernel
    C1 runs the whole program (its own triangular solves on the factors,
    the pivots as a permutation, the exit tests on the device) and the
    results come back in one copy; on the CPU it is the plain host loop
    of C1's mismatch modes around ``torch.linalg.lu_solve``.

    ``precision="mixed"`` runs the triangular solves in float32, on a
    float32 copy of the LU factors made here once, as mixed-precision
    iterative refinement: the iterates, the mismatch and the exit test
    stay in float64, and the right-hand sides are the float32 roundings
    of dp and dq.  The acceptance contract is unchanged: the host float64
    verify is the only gate between a delta answer and the client.
    """
    dev = resolve_device(device)
    program = ck.DeltaProgram(delta_operands(sys, device=dev), precond.bp,
                              precond.bq, max_sweeps, tol,
                              mixed=precision == "mixed")
    # The operands, copies and buffers are done before any stream may
    # read them.
    stream_synchronize(dev)
    return program


class _DeltaJob:
    """One delta request waiting for (or holding) its lane's result:
    ``out`` is ``(theta, v, p_calc, q_calc, sweeps)`` host arrays, or the
    exception the program raised."""

    __slots__ = ("entry", "near", "p", "q", "out")

    def __init__(self, entry: CaseEntry, near: CachedSolution,
                 p: np.ndarray, q: np.ndarray):
        self.entry = entry
        self.near = near
        self.p = p
        self.q = q
        self.out = None


class _Flight:
    """One in-progress cold solve and the followers riding it."""

    __slots__ = ("entry", "digest", "followers")

    def __init__(self, entry: CaseEntry, digest: str):
        self.entry = entry
        self.digest = digest
        self.followers: List[object] = []  # Ticket-shaped records


class ServeCache:
    """The bounded incremental-tier store (see the module docstring).

    ``max_bytes`` budgets solutions plus artifacts; a case whose
    artifacts alone would overrun it is never cached (``entry`` returns
    ``None`` and the serve path stays cold).  ``verify_tol`` overrides
    the engine-tolerance accept bar of the delta tier (tests use it to
    force fall-through).  ``precision`` is the ``pf_precision`` key,
    resolved for ``device`` (``cuda`` unless the CPU is asked for):
    ``"auto"`` is ``"mixed"`` on the card, as in the reference.
    """

    def __init__(self, max_bytes: int, ttl_s: float = 600.0,
                 delta_max_rank: int = 16, delta_max_pu: float = DELTA_MAX_PU,
                 verify_tol: Optional[float] = None,
                 precision: str = "f64", device: DeviceLike = None):
        self.device = resolve_device(device)
        self.max_bytes = int(max_bytes)
        self.ttl_s = float(ttl_s)
        self.delta_max_rank = int(delta_max_rank)
        self.delta_max_pu = float(delta_max_pu)
        self.verify_tol = verify_tol
        # Inner precision of the delta program, resolved once so every
        # entry builds the same program kind.
        self.precision = resolve_precision(precision,
                                           platform_name(self.device))
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, str, str], CaseEntry] = {}
        self._lru: "OrderedDict[Tuple[Tuple[str, str, str], str], CaseEntry]" \
            = OrderedDict()
        self._flights: Dict[Tuple[Tuple[str, str, str], str], _Flight] = {}
        self.bytes = 0
        self._counts = {t: 0 for t in _TIERS}
        self._joins = 0
        self._evictions = {"lru": 0, "ttl": 0, "invalidate": 0}
        self._errors = 0
        # Delta programs: one runs at a time (under _delta_run), over
        # every pending job of its entry (_delta_jobs, under _lock).
        self._delta_run = threading.Lock()
        self._delta_jobs: List[_DeltaJob] = []
        self._delta_runs = 0
        self._stream = None  # the delta program's CUDA stream (lazy)

    def _on_stream(self):
        """The context the delta program runs in (callers hold
        ``_delta_run``): the cache's own CUDA stream on the card, nothing
        on the CPU."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return torch.cuda.stream(self._stream)

    # -- entries -------------------------------------------------------------
    def entry(self, case: str, sys, backend: str,
              topo: Optional[str] = None) -> Optional[CaseEntry]:
        """The live entry for (case, topology, backend) — created (and
        its artifacts factorized, single-flight) on first touch, or
        ``None`` when the case cannot fit the byte budget.  Callers
        re-fetch per request: an evicted or invalidated entry is dead and
        its key resolves to a fresh rebuild."""
        if topo is None:
            topo = topology_digest(sys)
        key = (case, topo, backend)
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                ent.last_used = time.monotonic()
                return ent
            n = sys.n_bus
            # Two [n, n] LU factors (+ pivots) in the working dtype.
            est = 2 * (n * n + n) * 8
            if est > self.max_bytes:
                return None
            ent = CaseEntry(case, sys, backend, topo,
                            precision=self.precision, device=self.device)
            self._entries[key] = ent
        with ent.build_lock:
            ent.build_artifacts()
        with self._lock:
            # `accounted` pairs the one add with the (at most one)
            # subtract in invalidate/_evict_locked.
            if ent.alive and not ent.accounted:
                ent.accounted = True
                self.bytes += ent.artifact_bytes
                self._evict_locked()
            self._set_gauges_locked()
        return ent

    def peek_entry(self, case: str, topo: Optional[str],
                   backend: str) -> Optional[CaseEntry]:
        """The live entry for the key, or ``None`` — never builds, so an
        invalidated or evicted entry's in-flight inserts land nowhere and
        no factorization runs on the executor lane."""
        with self._lock:
            ent = self._entries.get((case, topo, backend))
            if ent is not None:
                ent.last_used = time.monotonic()
            return ent

    # -- lookup (host only) --------------------------------------------------
    def lookup(self, entry: CaseEntry, digest: str, p: np.ndarray,
               q: np.ndarray):
        """Classify one pf request against the entry's solutions.

        Returns ``(tier, payload)``: ``("exact", solution)`` /
        ``("delta", nearest)`` / ``("warm", nearest)`` / ``("miss",
        None)``.  Host work only — dict probes plus O(n) numpy compares
        over at most :data:`DELTA_SCAN` recent solutions.
        """
        now = time.monotonic()
        ttl = self.ttl_s
        with self._lock:
            entry.last_used = now
            if ttl > 0 and now - entry.ttl_sweep >= _TTL_SWEEP_S:
                entry.ttl_sweep = now
                self._prune_expired_locked(entry, now)
            sol = entry.solutions.get(digest)
            if sol is not None and ttl > 0 and now - sol.stamp > ttl:
                # Freshness is enforced on the candidate itself too.
                self._drop_expired_locked(entry, sol)
                sol = None
            if sol is not None and np.array_equal(sol.p_inj, p) \
                    and np.array_equal(sol.q_inj, q):
                self._touch_locked(entry, sol, now)
                return "exact", sol
            best_delta = None
            best_delta_rank = None
            best_warm = None
            best_warm_l1 = None
            scanned = 0
            for s in reversed(entry.solutions.values()):
                if scanned >= DELTA_SCAN:
                    break
                scanned += 1
                if ttl > 0 and now - s.stamp > ttl:
                    continue  # expired: never served (the sweep reaps it)
                dp = p - s.p_inj
                dq = q - s.q_inj
                changed = (np.abs(dp) > 1e-12) | (np.abs(dq) > 1e-12)
                rank = int(np.count_nonzero(changed))
                mag = float(max(np.max(np.abs(dp)), np.max(np.abs(dq))))
                l1 = float(np.sum(np.abs(dp)) + np.sum(np.abs(dq)))
                if rank <= self.delta_max_rank and mag <= self.delta_max_pu:
                    if best_delta_rank is None or rank < best_delta_rank:
                        best_delta, best_delta_rank = s, rank
                if best_warm_l1 is None or l1 < best_warm_l1:
                    best_warm, best_warm_l1 = s, l1
            if best_delta is not None:
                self._touch_locked(entry, best_delta, now)
                return "delta", best_delta
            if best_warm is not None:
                self._touch_locked(entry, best_warm, now)
                return "warm", best_warm
            return "miss", None

    # -- delta tier (device correction + the one verify pull) ----------------
    def delta_answer(self, entry: CaseEntry, near: CachedSolution,
                     p: np.ndarray, q: np.ndarray) -> Optional[dict]:
        """Correct ``near`` to the requested injections off the cached
        factorization; verify on the host; ``None`` on a residual miss
        (the caller falls through to the warm tier).  The correction runs
        combined with the entry's other pending requests
        (:meth:`_run_delta_jobs`); a program that raises raises here, in
        every caller whose lane it carried."""
        job = _DeltaJob(entry, near, p, q)
        with self._lock:
            self._delta_jobs.append(job)
        with self._delta_run:
            if job.out is None:  # no other caller ran it: run the batch
                with self._lock:
                    jobs = [j for j in self._delta_jobs if j.entry is entry]
                    self._delta_jobs = [j for j in self._delta_jobs
                                        if j.entry is not entry]
                self._run_delta_jobs(entry, jobs)
        if isinstance(job.out, BaseException):
            raise job.out
        theta, v, p_calc, q_calc, sweeps = job.out
        if not (np.all(np.isfinite(theta)) and np.all(np.isfinite(v))):
            return None
        err = entry.verify(theta, v, p, q)
        tol = self.verify_tol if self.verify_tol is not None else entry.tol
        if err > tol:
            return None  # fall through to the warm tier: never served
        return {
            "theta": theta, "v": v, "p": p_calc, "q": q_calc,
            "iterations": sweeps, "mismatch": err, "converged": True,
        }

    def _run_delta_jobs(self, entry: CaseEntry, jobs: List[_DeltaJob]):
        """One program call with a lane per job (the caller holds
        ``_delta_run``); the one device-to-host copy of its results is a
        sync of the cache's stream alone."""
        self._delta_runs += 1
        try:
            with self._on_stream():
                fn = entry.ensure_delta_fn()
                res = fn(*(np.stack(a) for a in zip(
                    *((j.near.theta, j.near.v, j.p, j.q) for j in jobs))))
                theta, v, p_calc, q_calc, _, sweeps = ck.results_to_host(res)
        except Exception as e:  # noqa: BLE001 — raised in each caller
            for j in jobs:
                j.out = e
            return
        for i, j in enumerate(jobs):
            j.out = (theta[i], v[i], p_calc[i], q_calc[i], int(sweeps[i]))

    # -- insertion (host only) -----------------------------------------------
    def insert(self, entry: CaseEntry, digest: str, p: np.ndarray,
               q: np.ndarray, v, theta, p_calc, q_calc, iterations: int,
               mismatch: float, converged: bool) -> Optional[CachedSolution]:
        """Store one converged operating point (a full-solve scatter or a
        verified delta answer); evicts LRU/TTL victims past the byte
        budget.  Dead entries (evicted or invalidated while the solve was
        in flight) are skipped."""
        if not converged:
            return None
        sol = CachedSolution(digest, p, q, v, theta, p_calc, q_calc,
                             iterations, mismatch, converged)
        with self._lock:
            if not entry.alive:
                return None
            old = entry.solutions.pop(digest, None)
            if old is not None:
                self._lru.pop((entry.key, digest), None)
                self.bytes -= old.nbytes
            entry.solutions[digest] = sol
            self._lru[(entry.key, digest)] = entry
            self.bytes += sol.nbytes
            entry.last_used = sol.stamp
            self._evict_locked()
            self._set_gauges_locked()
        return sol

    # -- single flight -------------------------------------------------------
    def flight_claim(self, entry: CaseEntry, digest: str, follower):
        """Atomically: late exact hit, join an in-progress solve, or lead
        a new one.  Returns ``("exact", solution)``, ``("joined",
        None)`` (the follower is parked on the flight), or ``("lead",
        None)`` (the caller enqueues the real solve and settles or aborts
        the flight when it completes)."""
        key = (entry.key, digest)
        with self._lock:
            sol = entry.solutions.get(digest)
            if sol is not None:
                self._touch_locked(entry, sol, time.monotonic())
                return "exact", sol
            fl = self._flights.get(key)
            if fl is not None:
                fl.followers.append(follower)
                self._joins += 1
                return "joined", None
            self._flights[key] = _Flight(entry, digest)
            return "lead", None

    def settle_flight(self, key) -> Tuple[Optional[CaseEntry], List[object]]:
        """Pop one flight at leader completion: ``(entry, followers)``
        (entry ``None`` if the flight vanished)."""
        with self._lock:
            fl = self._flights.pop(key, None)
            if fl is None:
                return None, []
            return fl.entry, fl.followers

    def abort_flight(self, key) -> List[object]:
        """Pop a flight whose leader failed, expired or was shed: its
        followers (the caller fails them with the leader's error)."""
        with self._lock:
            fl = self._flights.pop(key, None)
            return [] if fl is None else fl.followers

    # -- invalidation / eviction ---------------------------------------------
    def invalidate(self, case: Optional[str] = None) -> int:
        """Drop every entry (artifacts and solutions) of ``case`` (or of
        all cases) — the explicit topology/status-change hook.  Returns
        the dropped solution count.  In-flight solves against a dropped
        entry still answer their waiters; their insert lands nowhere."""
        dropped = 0
        with self._lock:
            for key in [k for k in self._entries
                        if case is None or k[0] == case]:
                ent = self._entries.pop(key)
                ent.alive = False
                for dig in list(ent.solutions):
                    sol = ent.solutions.pop(dig)
                    self._lru.pop((key, dig), None)
                    self.bytes -= sol.nbytes
                    dropped += 1
                if ent.accounted:
                    ent.accounted = False
                    self.bytes -= ent.artifact_bytes
                self._evictions["invalidate"] += 1
                obs.SERVE_CACHE_EVICTIONS.labels("invalidate").inc()
            self._set_gauges_locked()
        return dropped

    def _drop_expired_locked(self, entry: CaseEntry,
                             sol: CachedSolution) -> None:
        entry.solutions.pop(sol.digest, None)
        self._lru.pop((entry.key, sol.digest), None)
        self.bytes -= sol.nbytes
        self._evictions["ttl"] += 1
        obs.SERVE_CACHE_EVICTIONS.labels("ttl").inc()

    def _prune_expired_locked(self, entry: CaseEntry, now: float) -> None:
        if self.ttl_s <= 0:
            return
        for sol in [s for s in entry.solutions.values()
                    if now - s.stamp > self.ttl_s]:
            self._drop_expired_locked(entry, sol)

    def _touch_locked(self, entry: CaseEntry, sol: CachedSolution,
                      now: float) -> None:
        # A touch refreshes LRU order only; TTL ages from insert time.
        entry.solutions.move_to_end(sol.digest)
        self._lru.move_to_end((entry.key, sol.digest), last=True)

    def _evict_locked(self) -> None:
        """LRU victims until the budget holds: solutions first (oldest
        touch anywhere), then whole idle entries' artifacts."""
        while self.bytes > self.max_bytes and self._lru:
            (ekey, dig), ent = self._lru.popitem(last=False)
            sol = ent.solutions.pop(dig, None)
            if sol is not None:
                self.bytes -= sol.nbytes
                self._evictions["lru"] += 1
                obs.SERVE_CACHE_EVICTIONS.labels("lru").inc()
        if self.bytes > self.max_bytes and len(self._entries) > 1:
            for key in sorted(self._entries,
                              key=lambda k: self._entries[k].last_used):
                if self.bytes <= self.max_bytes:
                    break
                ent = self._entries.pop(key)
                ent.alive = False
                if ent.accounted:
                    ent.accounted = False
                    self.bytes -= ent.artifact_bytes
                self._evictions["lru"] += 1
                obs.SERVE_CACHE_EVICTIONS.labels("lru").inc()

    # -- accounting ----------------------------------------------------------
    def record(self, tier: str) -> None:
        """Count one resolved lookup (tier ∈ exact/delta/warm/miss) and
        refresh the hit-ratio gauge."""
        with self._lock:
            self._counts[tier] += 1
            lookups = sum(self._counts.values())
            served = self._counts["exact"] + self._counts["delta"]
            ratio = served / lookups if lookups else 0.0
        if tier == "miss":
            obs.SERVE_CACHE_MISSES.inc()
        else:
            obs.SERVE_CACHE_HITS.labels(tier).inc()
        obs.SERVE_CACHE_HIT_RATIO.set(ratio)

    def record_error(self, exc: BaseException) -> None:
        """Count one exception the serve path caught in the cache tier
        (the request then takes the full path): ``serve_cache_errors_total``
        and the ``/stats`` block's ``errors``; the first is logged with
        its traceback."""
        with self._lock:
            self._errors += 1
            first = self._errors == 1
        obs.SERVE_CACHE_ERRORS.inc()
        if first:
            _log.error("serving cache tier failed; the request takes the "
                       "full path (further failures are only counted in "
                       "serve_cache_errors_total)", exc_info=exc)

    def _set_gauges_locked(self) -> None:
        obs.SERVE_CACHE_BYTES.set(self.bytes)

    def prewarm_entry(self, entry: CaseEntry) -> None:
        """Build the delta program at startup and run it once from the
        flat start on the case's own injections, so the first delta
        request pays a correction, not the program's build and the
        kernel library's first load."""
        sys = entry.sys
        v0 = np.where(entry._v_free, 1.0, np.asarray(sys.v_set, np.float64))
        with self._delta_run, self._on_stream():
            fn = entry.ensure_delta_fn()
            out = fn(np.zeros(sys.n_bus), v0,
                     np.asarray(sys.p_inj, np.float64),
                     np.asarray(sys.q_inj, np.float64))
            out[0].cpu()  # the stream's work is done when we return

    def stats(self) -> dict:
        """The ``/stats`` cache block."""
        with self._lock:
            return {
                "bytes": self.bytes,
                "budget_bytes": self.max_bytes,
                "ttl_s": self.ttl_s,
                "delta_max_rank": self.delta_max_rank,
                "entries": len(self._entries),
                "solutions": sum(len(e.solutions)
                                 for e in self._entries.values()),
                "hits": {t: self._counts[t] for t in ("exact", "delta",
                                                      "warm")},
                "misses": self._counts["miss"],
                "flight_joins": self._joins,
                "delta_runs": self._delta_runs,
                "errors": self._errors,
                "inflight": len(self._flights),
                "evictions": dict(self._evictions),
                "hit_ratio": round(
                    (self._counts["exact"] + self._counts["delta"])
                    / max(sum(self._counts.values()), 1), 4
                ),
            }
