#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``freedm_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card; builds the kernels from the sources in this
checkout and drives the served paths end to end: ``POST /v1/pf`` on the
dense Newton backend (K1-K3), the sparse one (S1-S4), which the default
server takes at 512 buses and more, and the serving cache's delta tier
(C1); ``POST /v1/n1`` on the SMW screen (N1) below 512 buses and the
status-traced sparse screen (S1 with status, S2-S4, K3) at and above;
the DC solver and ``dc_prefilter`` (D1); the radial ladder solve (L1)
and its adjoint (L2) under the VVC controller, and ``POST /v1/vvc`` (L1);
QSTS studies through ``run_study`` — the agent step (A1), the bus and
feeder streaming reductions (Q1, Q2), feeder chunks on L1 — and the jobs
API behind ``POST /v1/qsts``; topology sweeps through ``run_topo_sweep``
— the radiality check (T1) and the rank-r SMW screen (T2), the AC verify
on S1 with status, S2-S4 and K3 —, ``POST /v1/topo`` and ``POST
/v1/topo/sweep``.
Phases (any failure exits non-zero, and no result line is printed):

1. build: seven ``nvcc`` runs started together compile
   ``freedm_tpu_torch/kernels/csrc/newton.cu``, ``sparse.cu``,
   ``cache.cu``, ``screen.cu``, ``ladder.cu``, ``qsts.cu`` and ``topo.cu`` for
   ``sm_90a``; prints the build seconds and the ``-Xptxas -v`` reports;
2. kernels: each kernel against its plain PyTorch version on the card at
   n ∈ {14, 30, 118, 2000} buses and B ∈ {1, 3, 64} lanes (float64,
   1e-10 absolute on J, f, P, Q — the sums run in another order; K3
   exactly, and bit-identical on repeat), then each kernel's time (CUDA
   events) at the main path's shape (mesh2000, 64 lanes) beside its plain
   version's, its bound and, for K2, one ``torch.matmul`` of the complex
   pair, K3 also by device time; also the Newton step's library LU
   (``torch.linalg.solve_ex``) on K1's Jacobian, batched as the solver
   calls it and one lane at a time;
3. solve: ``make_newton_solver`` on mesh2000 over 64 lanes at load
   scales 0.5-1.2 — every lane converges, Σp (the losses) is small and
   non-negative, three lanes match the plain-version solve on the card
   within 1e-9 pu with identical iteration counts; then a float32 solve
   of mesh118 over 4 lanes, within 1e-4 pu of the float32 plain-version
   solve and of the float64 solve;
4. sparse kernels: S1-S4 against their plain versions at mesh118,
   mesh2000 and mesh5000, B ∈ {1, 3, 64} (B ≤ 8 at mesh5000), float64
   and float32 — S1 in each of its modes (``compare_assemble``: the
   float32 values of ``VALUES_F32`` are the full fill's cast, bit for
   bit, the ``RESIDUAL`` outputs the full fill's, P and Q the ordered
   sums of the c/a values it wrote, every mode bit-identical on repeat)
   —, with a breakdown lane and a forced Cholesky failure
   (``SPARSE_TOL`` gives each tolerance and its reason), S3 on the
   blocks of GMRES cycles with (m, s) ∈ {(16, 4), (16, 1), (16, 8),
   (32, 4)} (j0 up to 28, 33 basis rows; mesh118's N = 236 splits into
   ragged slices, mesh5000's 33 rows stream from L2; the float32 blocks
   of the 8-step chain at mesh5000 are held to the float64 result, see
   ``ORTH_F64_LIMIT``), S4 also on a rank-deficient H (dead rows of
   V·valid) and on a non-finite H and β (NaN lanes), S2, S3 and S4 run
   twice on identical inputs (identical bits), S3 also in both its
   shared- and its global-memory form (identical bits); the sweeps of
   S4's Jacobi SVD on the served mesh2000 cycles, from its PyTorch mirror
   (``gmres_lstsq_jacobi``, held to the kernel); then their times at
   mesh2000 × 64 (CUDA events over back-to-back calls, and device time
   from ``torch.profiler``) beside their plain versions, their bounds,
   the preconditioner apply and, for S2, one ``torch.sparse.mm`` over a
   block-diagonal CSR matrix of every lane's J, for S4 the SVD
   minimum-norm solve of its float64 H (``torch.linalg.pinv``; the card's
   ``torch.linalg.lstsq`` refuses a rank-deficient H) — S1 in each mode, all in
   float64 and float32;
5. sparse solves: mesh2000 × 64 in f64 and in mixed — every lane
   converges, losses ≥ 0, three lanes within 1e-9 pu of the plain-version
   sparse solve and 1e-6 pu of the dense solve — with launches per
   Newton step (S1's by mode), a ``torch.profiler`` breakdown and the
   device operations per Newton step; then mesh5000 × 8 on the LU-kind
   preconditioner;
6. serve (the dense kernels' main path): ``ServeServer`` with
   ``pf_backend="dense"`` and ``max_batch=64``; 64 concurrent ``POST /v1/pf`` per case to
   case14, case_ieee30, mesh118 and mesh2000 — every answer 200 and
   converged, at least one batch with more than one lane; prints p50/p99
   latency and solves/s per case.  Every dense kernel's launch count
   over this phase must be > 0;
7. default server (the main path of the sparse kernels): ``ServeServer``
   with the default ``pf_backend="auto"``/``pf_precision="auto"`` and
   ``max_batch=64``; 64 concurrent ``POST /v1/pf`` for mesh2000, all 200
   and converged, solved sparse and mixed; every S1-S4 launch count over
   the burst must be > 0.  Phases 6 and 7 run with ``cache_mb=0``;
8. serve cache: C1, the whole delta program in one launch, against its
   plain version (the host loop around ``torch.linalg.lu_solve``) at
   mesh118, mesh2000 and mesh5000, B ∈ {1, 8}, f64 and mixed, from a
   converged base over random 1-16-bus deltas (``PROGRAM_ATOL``; sweep
   counts equal or one apart on a lane, counted), bit-identical on
   repeat, and at mesh118 and mesh2000 also against the plain program on
   the mirror's solves (``lu_solve_mirror``, printed); its times at
   mesh2000 × {1, 8} lanes in mixed and f64 (events, and device time per
   program and per sweep), with no ``lu_solve`` kernel in its profile;
   then the default server with the cache on at mesh2000
   (:func:`serve_cache`): exact, delta, warm and fall-through answers,
   deltas while a 64-request burst is in flight, every answer within
   ``CACHE_ATOL`` of a ``cache_mb=0`` service; C1's launch count over it
   must be > 0, one a delta program, and a profiled answer's device time,
   operations and CUDA runtime calls are printed;
9. screen kernels: S1 with a per-lane status in each mode against its
   plain version at mesh118 and mesh2000, B ∈ {1, 3, 64, 256}, float64
   and float32, random 0/1 status and single outages
   (``compare_assemble``: ``SPARSE_TOL``, bit-identical on repeat, the
   modes' bit relations; an all-in-service status gives the no-status
   bits); N1 in every mode on identical inputs at case_ieee30, mesh118
   and mesh511 × L ∈ {1, 64, 256} (``SMW_ATOL``); D1 in both modes at
   mesh118 and mesh2000 × L ∈ {1, 1024} (``DC_ATOL``), and the bridges
   of case14 and case_ieee30 flagged islanded by kernel and plain
   version; then their times (events and device time) beside the plain
   versions and the bounds: S1 with status at mesh2000 × 64 and × 256,
   device time in turns with S1 without status on the same inputs
   (with, without, without, with), N1 at mesh511 × 256 and
   case_ieee30 × 64 in each mode, D1 SCREEN at mesh2000 × 1024 and SOLVE
   at × 4096;
10. n1 screens: ``make_n1_screen`` on mesh2000 × 256 chord outages
   (sparse; mixed on the served bf16 pair, f64 on the float64 LU pair)
   against the plain-version screen (every lane converged; f64: three
   lanes within 1e-9 pu with equal iterations, every lane's fallbacks
   equal and iterations ±1; mixed: equal flags and fallbacks, iterations
   ±1), its
   launches (every S1
   call with the lanes' status) and a profile; the SMW screen over every
   secure outage of case_ieee30 and mesh511 × 256 against its plain
   version (1e-9 pu), 2 + 2 × 24 N1 launches a screen; ``make_dc_solver``
   at mesh2000 (4096 injection lanes, 1024 outage lanes) and
   ``dc_prefilter=8`` over 64 chord outages against their plain versions;
11. serve n1: the default config but ``max_batch=256`` (a request of
   more lanes than ``max_batch`` is refused, as the reference's is),
   engines prewarmed (build and prewarm times printed apart): mesh2000
   — one request of 64 outages, 16 concurrent requests of 1-16, one of
   256 — and case_ieee30 over all its secure outages, each answer
   all_converged with ``v_min_pu``/``v_max_pu`` within 1e-9 pu of the
   direct screen of the same outages; an islanding outage refused (400);
   p50/p99 latency and lanes a batch; S1 (with status on every call),
   S2-S4 and N1 launched;
12. ladder kernels: L1 against its plain version through
   ``make_ladder_solver`` and its ``plain=True`` twin on vvc_9bus, the Dl
   table (``tests/data/Dl_new.mat``, 0.5 × load, 60 iterations),
   ``synthetic_radial(512, seed=0)`` and ``synthetic_radial(10000,
   seed=0, load_kw=1.0)`` × B ∈ {1, 8, 64} (load scales uniform in
   0.7-1.3, ``default_rng(0)``) × {solve, solve_fixed} × {float64,
   float32} (``LADDER_ATOL``: 1e-10 pu with equal iterations and flags,
   1e-4 pu with equal flags, on the lanes that converge; a lane in
   voltage collapse is held to equal flags and iterations and every
   lane's single iteration to the same limits; a float32 flag whose
   residual lies within rounding of eps, ``F32_FLAG_ULPS``, is printed;
   bit-identical on repeat); L2 through
   ``LadderFixed`` against ``torch.autograd.grad`` of the plain fixed
   solve for the total loss in Q on vvc_9bus and the 10k feeder × {1,
   64} (rtol 1e-8, atol 1e-10) and a central difference on three live
   coordinates at 10k × 1 (1e-4); then their times (events and device
   time) at the 10k feeder × 64 and × 1 and vvc_9bus × 64 beside the
   plain versions and the bounds;
13. vvc: one controller step on vvc_9bus from zero q at loads P·(1 +
   0.6j) — it improves and is within 1e-9 of the plain step, one L2
   launch —, 120 rounds (non-increasing, below 0.92 of the base, L2
   once a round), one step on the 10k feeder × 64 lanes (per-lane alphas
   equal to the plain step's, losses within 1e-9 relative);
14. serve vvc: the default server, 64 concurrent ``POST /v1/vvc`` to
   vvc_9bus with random q in ±50 kvar on live phases (seed 9): every
   answer 200 and converged, loss and voltage extremes within 1e-9 of a
   direct ``solve_fixed``; p50/p99; L1 launched over the burst;
15. qsts kernels: A1 against its plain version on the 6-bus world × 2 and
   the million-agent population (400k EV, 300k thermostats, 150k
   inverters, 150k DR) on case_ieee30 × {1, 4}, observations flat and
   solved, hours 0, 7.5, 15, 19 and 23.75, DR signal 0 and 1
   (``A1_STATE_RTOL``, ``QSTS_SUM_RTOL``, relays equal, bit-identical on
   repeat); Q1 at mesh2000 × 64 (a solved mixed step) and case_ieee30 × 1,
   Q2 at vvc_9bus × 24·64 lanes (counts, worst count and envelope equal,
   losses and peak within ``QSTS_SUM_RTOL``, bit-identical on repeat);
   then their times (events and device time) beside the plain versions
   and the bounds;
16. qsts: studies through ``run_study`` — (a) case14 × 16, 96 steps of
   15 min, chunks of 24, seed 5: warm against cold iterations, kill after
   2 chunks and resume exactly, the kernel path within ``QSTS_ATOL`` of
   ``plain=True`` with equal iteration sums; (b) mesh2000 × 64 (sparse,
   mixed), 96 steps, chunks of 24, residential, seed 5: every lane-step
   of the ``MIDDAY_STEP`` steps before midday converged, the whole day
   completed (its non-converged count printed), Q1 once a step, a second
   run, kill and resume and chunks of 32 equal, scenario-steps/s, Newton
   steps a lane-step and the chunk wall split; mesh2000 × 8 × 4 steps
   within ``QSTS_MIXED_ATOL`` of ``plain=True``, flags equal; (c) the
   million-agent day on case_ieee30 × {1, 4}, 24 one-hour steps, chunks
   of 8: agent-steps/s on the engine's second run, A1 and Q1 once a step,
   closed-loop against replayed, kill and resume; (d) vvc_9bus × 64, 96
   steps: L1 and Q2 once a chunk, within ``QSTS_ATOL`` of ``plain=True``,
   kill and resume;
17. serve qsts: a ``ServeServer`` with a ``JobManager`` over a temporary
   checkpoint directory: a mesh2000 × 16 job while the 64-request
   ``/v1/pf`` burst on case14 runs (p50/p99 beside the burst alone; every
   answer 200 and converged), its summary equal to a direct
   ``run_study``; a keyed job cancelled mid-run and resubmitted (resumed,
   equal); an agents job (A1 launched); an unknown id 404; ``/healthz``
   ``qsts``;
18. topo kernels: T1 and T2 (both modes) against their plain versions at
   case14, case_ieee30, mesh118 and mesh2000 × V ∈ {1, 4096} (capped at a
   rank's distinct open-sets) × r ∈ {1, 2, 6}, random distinct open-sets
   (seeded), and every rank-<=2 variant of case14, case_ieee30 and mesh118
   (``TOPO_ATOL``; T1's booleans, T2's islanding flags and violation
   counts equal; both bit-identical on repeat, SCREEN equal to DETAIL);
   the bridges of case14 and case_ieee30 flagged by both; the least |det
   C| of a connected lane and the largest of an islanded one; then their
   times (events and device time) beside the plain versions and the
   bounds: T1 and T2 SCREEN at mesh118 × 4096, r = 2 (a chunk of the gate
   sweep) and mesh2000 × 16384, r ≤ 3, T2 DETAIL at mesh118 × 4096; the
   library row: ``torch.linalg.solve_ex`` of the chunk's re-formed B′,
   and per variant on the reference bench's 32 mixed-rank lanes;
19. topo sweeps through ``run_topo_sweep``: (a) every rank-<=2 variant of
   mesh118 in chunks of 4096, top 8 by loss — variants/s beside the
   reference bench's floor (10⁴), the AC verify of the top 8 apart, every
   entry converged under ``AC_TRUE_MISMATCH`` and no bridge, a second
   run, a kill after 3 chunks and its resume, chunks of 1024 and the
   plain versions' sweep equal; T1 and T2 once a chunk; (b) full width:
   mesh2000, ``TOPO_FULL_SAMPLES`` neighborhood samples of rank <= 3 (seed
   7) in chunks of ``TOPO_FULL_CHUNK`` — variants/s, the host draw, the
   chunk walls and T1 + T2's share, T1's sweeps, the excluded counts;
20. serve topo: the default server (cache on) with a ``JobManager``:
   ``POST /v1/topo`` case14 at rank 2 (210 variants, counts partition,
   verified, the shortlist of ``run_topo_sweep``), mesh118 after a
   ``/v1/pf`` request (the cache entry's B′ LU adopted: no
   ``lu_factor``), 16 concurrent mesh118 rank-1 requests (p50/p99), an
   invalid spec 400; a keyed mesh118 rank-2 ``POST /v1/topo/sweep`` job
   cancelled mid-run and resubmitted (resumed, equal to a direct sweep,
   ``kind: "topo"``), an invalid job 400; T1 and T2 launched on both.

The line before the last is the kernel table as one JSON object (K3,
S1-S4 also carry ``device_ms``, S1-S4 float32 ``*_f32`` times, S1 its
other modes' ``*_values_f32``/``*_residual`` times and bounds, its
status-mode times ``*_status_x64``/``*_status_x256`` with device times
in turns with and without status on the same inputs
(``device_ms_turns_*``), its served launches by mode,
``launches_by_mode``, and those of the n1 path, all with status; N1 and
D1 their other modes' times; L1 and L2 their per-iteration device times
and other shapes; A1 its S = 4 times; A1, Q1 and Q2 the path of their
launches; T1 and T2 their mesh2000 × 16384 times, T2 DETAIL, the
refactorization head-to-head and the |det C| margin, both their launches
on the served paths); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import http.client
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp64 FLOP/s
#: outside the tensor cores (the kernels' arithmetic is elementwise).
PEAK_BYTES = 3.35e12
PEAK_FP64 = 34e12
PEAK_FP32 = 67e12

MAIN_LANES = 64
KERNEL_ATOL = 1e-10
KERNEL_ATOL_F32 = 1e-3
SOLVE_ATOL = 1e-9
SOLVE_ATOL_F32 = 1e-4
TIGHT_TOL = 1e-11  # solver tolerance of the sparse kernel-vs-plain solves


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------


def build_kernels(torch, nk, sk, ck, sck, lk, qk, tk, build):
    t0 = time.monotonic()
    box = {}

    def run_nvcc(name):
        try:
            box[name] = (build.build(name), time.monotonic() - t0)
        except Exception as e:  # noqa: BLE001 — re-raised on the main thread
            box["error"] = e

    names = ("newton", "sparse", "cache", "screen", "ladder", "qsts", "topo")
    threads = [threading.Thread(target=run_nvcc, args=(name,))
               for name in names]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if "error" in box:
        raise box["error"]
    nk._newton_lib()
    sk._sparse_lib()
    ck._cache_lib()
    sck._screen_lib()
    lk._ladder_lib()
    qk._qsts_lib()
    tk._topo_lib()
    t_all = time.monotonic() - t0
    log(f"build: nvcc x{len(names)} {t_all:.1f} s ("
        + ", ".join(f"{k}.cu {box[k][1]:.1f} s" for k in names) + "), "
        + ", ".join(box[k][0].name for k in names))
    for name in names:
        log(build.build_log(name).strip())


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions, then timings
# ---------------------------------------------------------------------------


def case_system(name):
    from freedm_tpu_torch.grid.cases import synthetic_mesh
    from freedm_tpu_torch.grid.matpower import load_builtin

    if name.startswith("mesh"):
        return synthetic_mesh(int(name[4:]), seed=1, load_mw=10.0,
                              chord_frac=1.0)
    return load_builtin(name)


def newton_inputs(torch, sys_, lanes, seed):
    """Random (θ, V) states and scaled injections for one case on the
    card, plus the case's Ybus and masks — the K1/K2 argument tuple."""
    from freedm_tpu_torch.grid.bus import PQ, SLACK, ybus_dense

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    n = sys_.n_bus
    f64 = torch.float64

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=f64, device=dev)

    scale = rng.uniform(0.5, 1.2, (lanes, 1))
    x = np.concatenate([rng.uniform(-0.3, 0.3, (lanes, n)),
                        rng.uniform(0.9, 1.1, (lanes, n))], axis=1)
    y_re, y_im = ybus_dense(sys_, dtype=f64, device=dev)
    bt = np.asarray(sys_.bus_type)
    return (t(x), y_re, y_im, t(scale * sys_.p_inj), t(scale * sys_.q_inj),
            t(bt != SLACK), t(bt == PQ), t(sys_.v_set))


def max_err(a, b):
    return float((a - b).abs().max())


def compare_kernels(torch, nk, errs):
    """Each kernel against its plain version at every (case, lanes)."""
    cases = ("case14", "case_ieee30", "mesh118", "mesh2000")
    for ci, name in enumerate(cases):
        sys_ = case_system(name)
        for lanes in (1, 3, MAIN_LANES):
            args = newton_inputs(torch, sys_, lanes, seed=100 * ci + lanes)
            jac_k, f_k = nk.newton_assemble(*args)
            jac_p, f_p = nk.newton_assemble_plain(*args)
            e_jac = float(jac_k.sub_(jac_p).abs_().max())
            del jac_k, jac_p
            e1 = max(e_jac, max_err(f_k, f_p))
            p_k, q_k, g_k = nk.power_injections(*args)
            p_p, q_p, g_p = nk.power_injections_plain(*args)
            e2 = max(max_err(p_k, p_p), max_err(q_k, q_p), max_err(g_k, g_p))
            e3 = compare_update(torch, nk, args[0], f_p, lanes, ci)
            torch.cuda.synchronize()
            log(f"kernels: {name:>11} n={sys_.n_bus:<5} B={lanes:<3} "
                f"K1 {e1:.2e}  K2 {e2:.2e}  K3 {e3:.2e}")
            check(e1 <= KERNEL_ATOL, f"K1 disagrees on {name} B={lanes}: {e1}")
            check(e2 <= KERNEL_ATOL, f"K2 disagrees on {name} B={lanes}: {e2}")
            check(e3 == 0.0, f"K3 disagrees on {name} B={lanes}: {e3}")
            errs["newton_assemble"] = max(errs["newton_assemble"], e1)
            errs["power_injections"] = max(errs["power_injections"], e2)
            errs["newton_update"] = max(errs["newton_update"], e3)
            del args, f_k, f_p
            torch.cuda.empty_cache()
    # float32, the kernels' other instantiation: sums of ~1e2-sized terms
    # in another order differ by a few float32 ulps of the largest term;
    # K3's max and add are exact in any dtype.
    args = [a.float() for a in newton_inputs(torch, case_system("mesh118"),
                                             3, seed=1)]
    f32 = nk.newton_assemble_plain(*args)
    e32 = max(max_err(k, p) for k, p in zip(
        nk.newton_assemble(*args) + nk.power_injections(*args),
        f32 + nk.power_injections_plain(*args)))
    e32_k3 = compare_update(torch, nk, args[0], f32[1], 3, seed=5)
    log(f"kernels: float32 mesh118 B=3 K1/K2 {e32:.2e}  K3 {e32_k3:.2e}")
    check(e32 <= KERNEL_ATOL_F32, f"float32 K1/K2 disagree: {e32}")
    check(e32_k3 == 0.0, f"float32 K3 disagrees: {e32_k3}")


def compare_update(torch, nk, x, f, lanes, seed):
    """K3 against its plain version, with a NaN lane and a lane at
    max_iter when there are lanes enough; returns the max |Δ| (NaNs
    must sit in the same places)."""
    dev, dtype = x.device, x.dtype
    rng = np.random.default_rng(seed)
    m = x.shape[1]
    max_iter = 5
    f = f.clone()
    if lanes >= 3:
        f[1, m // 3] = float("nan")
    it = torch.as_tensor(rng.integers(0, max_iter, lanes), dtype=torch.int32,
                         device=dev)
    if lanes >= 3:
        it[2] = max_iter
    err = torch.as_tensor(rng.uniform(0.0, 1e-6, lanes), dtype=dtype,
                          device=dev)
    active = torch.as_tensor(rng.uniform(size=lanes) < 0.8, device=dev)
    if lanes >= 3:
        active[1] = True
    free = torch.as_tensor(rng.uniform(size=m) < 0.9, dtype=dtype, device=dev)
    dx = torch.as_tensor(rng.normal(0, 1e-3, (lanes, m)), dtype=dtype,
                         device=dev)
    tol = torch.full((1,), 1e-8 if dtype == torch.float64 else 3e-5,
                     dtype=dtype, device=dev)
    states = []
    for fn in (nk.newton_update, nk.newton_update, nk.newton_update_plain):
        st = (x.clone(), it.clone(), err.clone(), active.clone())
        fn(st[0], dx, f, free, st[1], st[2], st[3], max_iter, tol)
        states.append(st)
    (xk, ik, ek, ak), again, (xp, ip, ep, ap) = states
    check(all(same_bits(torch, a, b) for a, b in zip((xk, ek), again[::2]))
          and torch.equal(ik, again[1]) and torch.equal(ak, again[3]),
          f"K3 not bit-identical on repeat: B={lanes} {dtype}")
    same_nan = bool(torch.equal(torch.isnan(ek), torch.isnan(ep)))
    if not (same_nan and torch.equal(ik, ip) and torch.equal(ak, ap)):
        return float("inf")
    fin = ~torch.isnan(ep)
    return max(max_err(xk, xp), max_err(ek[fin], ep[fin]))


def time_ms(torch, fn, reps, warmup=1):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms_by_kernel(torch, fn, reps):
    """Mean device time of one call of ``fn`` by kernel name: the kernel
    rows of a ``torch.profiler`` trace over ``reps`` calls (after one warm
    call), without the host's launch cost that CUDA events over
    back-to-back calls also count when a call launches faster than Python
    issues it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    rows = {}
    # A trace now and then comes back without its device events (seen once
    # in a hundred-odd windows on the H100): take another window then.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = {e.key: e.self_device_time_total / 1e3 / reps
                for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")
                and getattr(e, "self_device_time_total", 0) > 0}
        if rows:
            break
    check(bool(rows), "the profiler recorded no device time")
    return rows


def device_ms(torch, fn, reps):
    """Mean device time of one call of ``fn`` (all its kernels)."""
    return sum(device_ms_by_kernel(torch, fn, reps).values())


def bound(bytes_, ops, fp64=True):
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    t_ops = ops / (PEAK_FP64 if fp64 else PEAK_FP32) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(torch, nk):
    """Times at the main path's shape: mesh2000, 64 lanes, float64."""
    sys_ = case_system("mesh2000")
    args = newton_inputs(torch, sys_, MAIN_LANES, seed=7)
    x, y_re, y_im = args[0], args[1], args[2]
    lanes, n = MAIN_LANES, sys_.n_bus
    m = 2 * n
    w = 8  # float64 bytes
    nnz = int(((y_re != 0) | (y_im != 0)).sum())
    rows = {}

    # K1: reads x, the schedules, Ybus and the masks; writes J and f.
    # Arithmetic: ~20 fp64 operations per nonzero of Ybus per lane (trig
    # products, C and A, the sums, two divisions, a negation) and ~10 per
    # row (diagonal and mismatch); zeros of Ybus need only their writes.
    b1 = w * (lanes * m + 2 * lanes * n + 2 * n * n + 3 * n
              + lanes * m * m + lanes * m)
    o1 = lanes * (20 * nnz + 10 * n)
    k = time_ms(torch, lambda: nk.newton_assemble(*args), reps=5)
    p = time_ms(torch, lambda: nk.newton_assemble_plain(*args), reps=2)
    rows["newton_assemble"] = (k, p, None, *bound(b1, o1))
    time_lu(torch, nk, args)
    torch.cuda.empty_cache()

    # K2: same reads; writes P, Q and f.  4 FMAs (8 operations) per
    # nonzero of Ybus per lane for I = Y V; ~12 per row for V's parts, S
    # and the mismatch.
    b2 = w * (lanes * m + 2 * lanes * n + 2 * n * n + 3 * n
              + 2 * lanes * n + lanes * m)
    o2 = lanes * (8 * nnz + 12 * n)
    k = time_ms(torch, lambda: nk.power_injections(*args), reps=20)
    p = time_ms(torch, lambda: nk.power_injections_plain(*args), reps=3)
    # Library yardstick: one complex matmul I = Y V, then S = V conj(I).
    yc = torch.complex(y_re, y_im)
    theta, v = x[:, :n].T.contiguous(), x[:, n:].T.contiguous()
    vc = torch.polar(v, theta)

    def library():
        return vc * torch.matmul(yc, vc).conj()

    lib = time_ms(torch, library, reps=20)
    rows["power_injections"] = (k, p, lib, *bound(b2, o2))
    del yc, vc

    # K3: reads x, dx, f, the mask and the lane carries; writes x and the
    # carries.  ~4 operations per element.
    f = torch.randn(lanes, m, dtype=torch.float64, device=x.device)
    dx = 1e-12 * torch.randn_like(f)
    free = torch.ones(m, dtype=torch.float64, device=x.device)
    it = torch.zeros(lanes, dtype=torch.int32, device=x.device)
    err = torch.zeros(lanes, dtype=torch.float64, device=x.device)
    active = torch.ones(lanes, dtype=torch.bool, device=x.device)
    tol = torch.zeros(1, dtype=torch.float64, device=x.device)
    big = 1 << 30  # every lane stays active: each rep does the full update
    xk, xp = x.clone(), x.clone()
    carries = [(it.clone(), err.clone(), active.clone()) for _ in range(2)]
    # reads x, dx, f, free, it, err, active, tol; writes x, it, err, active
    b3 = (w * (3 * lanes * m + m) + (4 + w + 1) * lanes + w
          + w * lanes * m + (4 + w + 1) * lanes)
    o3 = lanes * m * 4
    k = time_ms(torch, lambda: nk.newton_update(
        xk, dx, f, free, *carries[0], big, tol), reps=100)
    k_dev = device_ms(torch, lambda: nk.newton_update(
        xk, dx, f, free, *carries[0], big, tol), reps=50)
    p = time_ms(torch, lambda: nk.newton_update_plain(
        xp, dx, f, free, *carries[1], big, tol), reps=100)
    rows["newton_update"] = (k, p, None, *bound(b3, o3))
    extra = {"newton_update": {"device_ms": k_dev}}
    for name, (k, p, lib, b, by) in rows.items():
        log(f"timing: {name:<17} kernel {k:.4f} ms  plain {p:.4f} ms  "
            f"bound {b:.4f} ms ({by})"
            + (f"  library {lib:.4f} ms" if lib is not None else "")
            + (f"  device {extra[name]['device_ms']:.4f} ms"
               if name in extra else ""))
    return rows, extra


def time_lu(torch, nk, args):
    """The Newton step's library LU (``torch.linalg.solve_ex``, not a
    kernel of the port) on K1's Jacobian at the main path's shape, timed
    as the kernels are; and the same 64 systems solved one at a time,
    the route a later change might take."""
    jac, f = nk.newton_assemble(*args)
    rhs = -f.unsqueeze(-1)
    lanes, m = f.shape
    flop = lanes * (2.0 / 3.0 * m ** 3 + 2.0 * m ** 2)

    def batched():
        return torch.linalg.solve_ex(jac, rhs, check_errors=False)

    def per_lane():
        for b in range(lanes):
            torch.linalg.solve_ex(jac[b], rhs[b], check_errors=False)

    t_b = time_ms(torch, batched, reps=2)
    t_l = time_ms(torch, per_lane, reps=2)
    log(f"timing: LU solve_ex [{lanes}, {m}, {m}] batched {t_b:.1f} ms "
        f"({flop / t_b / 1e9:.2f} TFLOP/s)  one lane at a time "
        f"{t_l:.1f} ms ({flop / t_l / 1e9:.2f} TFLOP/s)")
    del jac, f, rhs


def solve_f32(torch, nk):
    """The float32 solve (the solver's other dtype) on a few lanes:
    kernels against plain versions on the card, and both against the
    float64 kernel solve."""
    from freedm_tpu_torch.pf.newton import make_newton_solver

    sys_ = case_system("mesh118")
    p = np.linspace(0.6, 1.2, 4)[:, None] * sys_.p_inj[None]
    q = np.linspace(0.6, 1.2, 4)[:, None] * sys_.q_inj[None]
    out = {}
    for label, dtype, plain in (("kernels", torch.float32, False),
                                ("plain", torch.float32, True),
                                ("f64", torch.float64, False)):
        solve, _ = make_newton_solver(sys_, dtype=dtype, device="cuda",
                                      plain=plain)
        out[label] = solve(p_inj=p, q_inj=q)
    k, pl, r = out["kernels"], out["plain"], out["f64"]
    dv = max(max_err(k.v, pl.v), max_err(k.theta, pl.theta))
    dref = max(max_err(k.v.double(), r.v), max_err(k.theta.double(), r.theta))
    log(f"solve: float32 mesh118 x4 vs plain |d| {dv:.2e}, vs float64 "
        f"|d| {dref:.2e}, iterations {k.iterations.cpu().tolist()} vs "
        f"{pl.iterations.cpu().tolist()}, max mismatch "
        f"{float(k.mismatch.max()):.2e}")
    check(bool(k.converged.all()) and bool(pl.converged.all()),
          "float32 lanes not converged")
    check(dv <= SOLVE_ATOL_F32 and dref <= SOLVE_ATOL_F32,
          f"float32 solve disagrees: {dv}, {dref}")


# ---------------------------------------------------------------------------
# Phase 3: the batched solver on mesh2000
# ---------------------------------------------------------------------------


def solve_mesh2000(torch, nk):
    from freedm_tpu_torch.pf.newton import make_newton_solver

    sys_ = case_system("mesh2000")
    scales = np.linspace(0.5, 1.2, MAIN_LANES)[:, None]
    p = scales * sys_.p_inj[None]
    q = scales * sys_.q_inj[None]
    solve, _ = make_newton_solver(sys_, backend="dense", device="cuda")
    solve(p_inj=p[:2], q_inj=q[:2])  # warm (cuSOLVER handles, allocator)
    torch.cuda.synchronize()
    nk.reset_launches()
    t0 = time.monotonic()
    r = solve(p_inj=p, q_inj=q)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = nk.launches()
    its = r.iterations.cpu().numpy()
    conv = r.converged.cpu().numpy()
    losses = r.p.sum(dim=1).cpu().numpy()
    load = float(-sys_.p_inj[sys_.p_inj < 0].sum())
    log(f"solve: mesh2000 x{MAIN_LANES} lanes in {wall * 1e3:.1f} ms "
        f"({MAIN_LANES / wall:.1f} lane-solves/s), iterations "
        f"{its.min()}-{its.max()}, max mismatch "
        f"{float(r.mismatch.max()):.2e}, losses {losses.min():.4f}-"
        f"{losses.max():.4f} pu, launches {counts}")
    check(bool(conv.all()), f"mesh2000 lanes not converged: {np.where(~conv)}")
    check(bool(np.all(losses >= -1e-9)), f"negative losses: {losses.min()}")
    check(bool(np.all(losses < 0.05 * load * scales.max())),
          f"losses not small: {losses.max()} pu of {load} pu load")
    check(all(c > 0 for c in counts.values()),
          f"a kernel was not launched by the solve: {counts}")
    idx = [0, MAIN_LANES // 2, MAIN_LANES - 1]
    plain, _ = make_newton_solver(sys_, backend="dense", device="cuda",
                                  plain=True)
    rp = plain(p_inj=p[idx], q_inj=q[idx])
    dv = max_err(r.v[idx], rp.v)
    dth = max_err(r.theta[idx], rp.theta)
    log(f"solve: vs plain on the card, lanes {idx}: |dv| {dv:.2e}, "
        f"|dtheta| {dth:.2e}, iterations {its[idx].tolist()} vs "
        f"{rp.iterations.cpu().tolist()}")
    check(dv <= SOLVE_ATOL and dth <= SOLVE_ATOL,
          f"kernel solve disagrees with the plain solve: {dv}, {dth}")
    check(its[idx].tolist() == rp.iterations.cpu().tolist(),
          "iteration counts differ from the plain solve")
    del r, rp
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phases 4 and 5: the sparse backend — S1-S4 against their plain versions,
# their times, and the sparse solves
# ---------------------------------------------------------------------------

#: Relative tolerances (max |kernel - plain| / max |plain|): S1/S2 differ
#: from their plain versions only in the order of their sums and FMA
#: contraction; S3/S4 also in the Cholesky/triangular-solve order and,
#: for S4, a Jacobi SVD against cuSOLVER's.
SPARSE_TOL = {"float64": (1e-12, 1e-9), "float32": (1e-5, 1e-3)}
#: The one shape S3 is not held to its plain version at SPARSE_TOL: the
#: float32 blocks of the 8-step chain at mesh5000.  The LU-kind
#: preconditioner makes M⁻¹J nearly the identity there, so the chain's
#: eight normalized vectors are nearly parallel: the block's condition
#: after Gram-Schmidt is ~2e5 and its Gram's ~6e10, past float32's 1/eps,
#: and rounding the Gram-Schmidt update once instead of twice moves the
#: plain version's own result by ~6e-3
#: (``tests/test_torch_krylov.py::test_s8_float32_chain_at_mesh5000_is_ill_posed``).
#: Those blocks are held to ``ORTH_F64_LIMIT`` of the float64 result of the
#: same inputs instead (sound float32 results read up to 6e-3 there; the
#: plain algorithm without its second CholQR pass, its ridge or its
#: Gram-Schmidt reads 0.3-1), and their distance from the plain version
#: is printed.
ORTH_F64_LIMIT = 2e-2
ILL_POSED_ORTH = ("mesh5000", "float32", (16, 8))
SPARSE_CASES = (("mesh118", (1, 3, MAIN_LANES)),
                ("mesh2000", (1, 3, MAIN_LANES)),
                ("mesh5000", (1, 3, 8)))
KRYLOV_M, KRYLOV_S = 16, 4
#: GMRES cycles (m, s) whose S3 blocks phase 4 compares at B = 3: the
#: solver's (16, 4) at every lane count, then s = 1 and 8, and 33 basis
#: rows (j0 up to 28).
ORTH_CYCLES = ((KRYLOV_M, KRYLOV_S), (16, 1), (16, 8), (32, 4))


def rel_abs_err(torch, k, p):
    """``(max |k - p| / max |p|, max |k - p|)`` over the finite entries;
    both inf if the NaNs of the two differ in place."""
    if not torch.equal(torch.isnan(k), torch.isnan(p)):
        return float("inf"), float("inf")
    fin = ~torch.isnan(p)
    if not bool(fin.any()):
        return 0.0, 0.0
    scale = float(p[fin].abs().max())
    d = float((k[fin] - p[fin]).abs().max())
    return (d / scale if scale > 0 else d), d


def worst(pairs):
    """Elementwise max of ``(rel, abs)`` pairs."""
    pairs = list(pairs)
    return max(r for r, _ in pairs), max(a for _, a in pairs)


def sparse_setup(torch, sys_, lanes, seed, dtype, pc=None, device="cuda"):
    """Operands, a random state and scaled schedules for one case on the
    card (or ``device``), the FDLF pair (built once per case) and the M⁻¹
    apply."""
    from freedm_tpu_torch.pf.krylov import build_fdlf_precond, fdlf_apply
    from freedm_tpu_torch.pf.sparse import sparse_operands

    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    n = sys_.n_bus
    op = sparse_operands(sys_, dtype=dtype, device=dev)
    scale = rng.uniform(0.5, 1.2, (lanes, 1))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    x = t(np.concatenate([rng.uniform(-0.3, 0.3, (lanes, n)),
                          rng.uniform(0.9, 1.1, (lanes, n))], axis=1))
    ps, qs = t(scale * sys_.p_inj), t(scale * sys_.q_inj)
    if pc is None:
        pc = build_fdlf_precond(sys_, device=dev)

    def m_op(u, v):
        return fdlf_apply(pc, op.th_free, op.v_free, u, v, u.dtype)

    return op, x, ps, qs, pc, m_op


def gmres_captures(torch, sk, op, ev, bv, f, x, m_op, m=KRYLOV_M,
                   s=KRYLOV_S):
    """The inputs of every S3 and S4 call of one plain GMRES cycle of
    dimension m and block size s on the Newton system at x (lane 1, when
    there is one, has a zero right-hand side: its chain breaks down at
    once)."""
    from freedm_tpu_torch.pf.krylov import _pgmres_block

    n = op.n
    b = -f.clone()
    if b.shape[0] >= 3:
        b[1] = 0.0
    caps = []
    orth, lstsq = sk.gmres_block_orth_plain, sk.gmres_lstsq_plain

    def spy_orth(vb, valid, w, j0):
        caps.append(("orth", vb.clone(), valid.clone(), w.clone(), j0))
        orth(vb, valid, w, j0)

    def spy_lstsq(vb, valid, ws, zs, beta):
        caps.append(("lstsq", vb.clone(), valid.clone(), ws.clone(),
                     zs.clone(), beta.clone()))
        return lstsq(vb, valid, ws, zs, beta)

    sk.gmres_block_orth_plain, sk.gmres_lstsq_plain = spy_orth, spy_lstsq
    try:
        _pgmres_block(lambda u: sk.sparse_matvec_plain(ev, bv, u, op),
                      lambda u: m_op(u, x[:, n:]), b, m=m, s=s, plain=True)
    finally:
        sk.gmres_block_orth_plain, sk.gmres_lstsq_plain = orth, lstsq
    return caps


def run_orth(fn, cap):
    _, vb, valid, w, j0 = cap
    vb, valid = vb.clone(), valid.clone()
    fn(vb, valid, w, j0)
    return vb, valid


def same_bits(torch, a, b):
    """Bit-for-bit equality (NaNs included)."""
    ints = {torch.float64: torch.int64, torch.float32: torch.int32}
    return a.dtype == b.dtype and torch.equal(a.view(ints[a.dtype]),
                                              b.view(ints[b.dtype]))


def compare_orth(torch, sk, cap, label, tol, f64_limit=None):
    """S3 on one captured block against its plain version; ``(rel, abs)``.
    At the second block of a cycle (j0 = s) with 3 lanes or more, lane 2's
    candidate block holds an inf: its Cholesky fails and the block must
    come out zero.  The kernel runs twice and must give the same bits.
    With ``f64_limit`` (``ILL_POSED_ORTH``) the block is held to that
    distance from the float64 result instead, and the returned error is
    that of the ``valid`` flags alone."""
    _, vb, valid, w, j0 = cap
    s_ = w.shape[1]
    fail = w.shape[0] >= 3 and j0 == s_
    if fail:
        w = w.clone()
        w[2, 0, 0] = float("inf")
    cap = ("orth", vb, valid, w, j0)
    vk, ak = run_orth(sk.gmres_block_orth, cap)
    vk2, ak2 = run_orth(sk.gmres_block_orth, cap)
    check(same_bits(torch, vk, vk2) and same_bits(torch, ak, ak2),
          f"S3 not bit-identical on repeat: {label} s={s_} j0={j0}")
    vp, ap = run_orth(sk.gmres_block_orth_plain, cap)
    if fail:
        rows = slice(j0 + 1, j0 + 1 + s_)
        check(bool((vk[2, rows] == 0).all()) and bool((ak[2, rows] == 0).all()),
              f"S3 kept a failed block: {label} s={s_}")
    d_valid = float((ak - ap).abs().max())
    err = rel_abs_err(torch, vk, vp)
    if f64_limit is None:
        return worst([err, (d_valid, d_valid)])
    c64 = ("orth", vb.double(), valid.double(), w.double(), j0)
    ref, _ = run_orth(sk.gmres_block_orth_plain, c64)
    e_k = rel_abs_err(torch, vk.double(), ref)[0]
    e_p = rel_abs_err(torch, vp.double(), ref)[0]
    log(f"sparse kernels: {label} S3 s={s_} j0={j0}: kernel vs plain "
        f"{err[0]:.2e}; vs the float64 result kernel {e_k:.2e} (limit "
        f"{f64_limit:g}), plain {e_p:.2e}")
    check(e_k <= f64_limit, f"gmres_block_orth {label} s={s_} j0={j0}: "
                            f"{e_k} from the float64 result > {f64_limit}")
    return d_valid, d_valid


def compare_lstsq(torch, sk, cap, label, served=False):
    """S4 on one captured cycle against its plain version; ``(rel,
    abs)``.  Also on the same cycle with four dead rows of V·valid (a
    rank-deficient H) and, with 3 lanes or more, with an inf in lane 0's
    basis and a NaN β in lane 2 (NaN lanes, in the same places as the
    plain version's).  The kernel runs twice and must give the same bits.
    ``served``: also the sweeps of the Jacobi SVD on this cycle, from
    S4's PyTorch mirror, whose solution is held to the kernel's."""
    _, vb, valid, ws, zs, beta = cap
    xk = sk.gmres_lstsq(vb, valid, ws, zs, beta)
    check(same_bits(torch, xk, sk.gmres_lstsq(vb, valid, ws, zs, beta)),
          f"S4 not bit-identical on repeat: {label}")
    errs = [rel_abs_err(torch, xk, sk.gmres_lstsq_plain(vb, valid, ws, zs,
                                                        beta))]
    dead = valid.clone()
    dead[:, 5:9] = 0.0
    errs.append(rel_abs_err(torch, sk.gmres_lstsq(vb, dead, ws, zs, beta),
                            sk.gmres_lstsq_plain(vb, dead, ws, zs, beta)))
    if vb.shape[0] >= 3:
        vbad, bbad = vb.clone(), beta.clone()
        vbad[0, 3, 7] = float("inf")
        bbad[2] = float("nan")
        xbad = sk.gmres_lstsq(vbad, valid, ws, zs, bbad)
        check(bool(torch.isnan(xbad[[0, 2]]).all())
              and not bool(torch.isnan(xbad[1]).any()),
              f"S4's NaN lanes are not lanes 0 and 2: {label}")
        errs.append(rel_abs_err(torch, xbad, sk.gmres_lstsq_plain(
            vbad, valid, ws, zs, bbad)))
    if served:
        xm, sweeps = sk.gmres_lstsq_jacobi(vb, valid, ws, zs, beta)
        e_m = rel_abs_err(torch, xk, xm)[0]
        sw = sweeps.cpu().numpy()
        log(f"sparse kernels: {label} S4 Jacobi sweeps (mirror) "
            f"{sw.min()}-{sw.max()}, mean {sw.mean():.2f} over {len(sw)} "
            f"lanes; kernel vs mirror {e_m:.2e}")
        tol = SPARSE_TOL[str(vb.dtype)[6:]][1]
        check(e_m <= tol, f"S4 disagrees with its mirror on {label}: {e_m}")
    return worst(errs)


def check_forms(torch, sk, cap, label):
    """S3 reading its rows from global memory gives the bits of its
    shared-memory form (the same cluster, the same arithmetic)."""
    _, vb, valid, w, j0 = cap
    nrows, nvec = vb.shape[1:]
    outs = []
    for r in (None, False):
        plan = sk.block_orth_plan(nvec, nrows, w.shape[1], j0,
                                  vb.element_size(), resident=r)
        vk, ak = vb.clone(), valid.clone()
        sk._launch_block_orth(vk, ak, w, j0, plan)
        outs.append((vk, ak))
    (v1, a1), (v2, a2) = outs
    check(same_bits(torch, v1, v2) and same_bits(torch, a1, a2),
          f"S3's two forms differ: {label} j0={j0}")


def ordered_bus_sums(torch, op, ev, x):
    """P and Q [B, n] from the c/a values S1 wrote into ``ev`` (rows 1 and
    0 of ``[B, 4, 2m]``), summed per bus as S1 sums them: the from-side
    terms, then the to-side terms, each in incidence-list order, one
    rounded operation at a time; then ``(P_from + P_to) + V² g_d`` and
    ``(Q_from + Q_to) − V² b_d``."""
    ptr = op.inc_ptr.cpu().numpy().astype(np.int64)
    side = op.inc_code.cpu().numpy() & 1
    deg = np.diff(ptr)
    dev = ev.device
    sums = {(s_, k): torch.zeros_like(x[:, :op.n])
            for s_ in (0, 1) for k in (1, 0)}
    for slot in range(int(deg.max())):
        has = deg > slot
        r = np.where(has, ptr[:-1] + slot, 0)
        entry = torch.as_tensor(r, device=dev)
        for s_ in (0, 1):
            mask = torch.as_tensor(has & (side[r] == s_), device=dev)
            for k in (1, 0):
                acc = sums[s_, k]
                acc.copy_(torch.where(mask, acc + ev[:, k][:, entry], acc))
    v = x[:, op.n:]
    v2 = v * v
    p = (sums[0, 1] + sums[1, 1]) + v2 * op.g_d
    q = (sums[0, 0] + sums[1, 0]) - v2 * op.b_d
    return p, q


def compare_assemble(torch, sk, op, x, ps, qs, label, status=None):
    """S1 in each of its modes against its plain version (each output at
    ``SPARSE_TOL`` of its own dtype), twice on identical inputs (identical
    bits), and the modes against each other bit for bit: ``VALUES_F32``'s
    ``ev``/``bv`` are ``FULL``'s cast to float32 and its ``f`` is
    ``FULL``'s; ``RESIDUAL``'s ``p``, ``q``, ``f`` are ``FULL``'s ``bv[:,
    4]``, ``bv[:, 5]`` and ``f``; without a ``status``, the bus role's P
    and Q are the ordered sums of the c/a values the edge role wrote
    (:func:`ordered_bus_sums`, on the stored diagonal).  Returns the worst
    ``(rel, abs)`` over the outputs in ``x``'s dtype."""
    modes = [sk.FULL, sk.RESIDUAL]
    if x.dtype == torch.float64:
        modes.append(sk.VALUES_F32)
    out, errs = {}, []
    for mode in modes:
        k = sk.sparse_assemble(x, ps, qs, op, mode, status)
        check(all(same_bits(torch, a, b) for a, b in zip(
            k, sk.sparse_assemble(x, ps, qs, op, mode, status))),
            f"S1 mode {mode} not bit-identical on repeat: {label}")
        for a, b in zip(k, sk.sparse_assemble_plain(x, ps, qs, op, mode,
                                                    status)):
            rel, ab = rel_abs_err(torch, a, b)
            tol = SPARSE_TOL[str(a.dtype)[6:]][0]
            check(rel <= tol, f"sparse_assemble mode {mode} disagrees on "
                              f"{label}: {rel} > {tol}")
            if a.dtype == x.dtype:
                errs.append((rel, ab))
        out[mode] = k
    ev, bv, f = out[sk.FULL]
    p, q, f3 = out[sk.RESIDUAL]
    check(same_bits(torch, p, bv[:, 4].contiguous())
          and same_bits(torch, q, bv[:, 5].contiguous())
          and same_bits(torch, f3, f),
          f"S1's residual mode differs from its full mode: {label}")
    if sk.VALUES_F32 in out:
        ev2, bv2, f2 = out[sk.VALUES_F32]
        check(same_bits(torch, ev2, ev.float())
              and same_bits(torch, bv2, bv.float())
              and same_bits(torch, f2, f),
              f"S1's float32 values are not its float64 values cast: {label}")
    if status is None:
        ps_, qs_ = ordered_bus_sums(torch, op, ev, x)
        check(same_bits(torch, ps_, bv[:, 4].contiguous())
              and same_bits(torch, qs_, bv[:, 5].contiguous()),
              f"S1's P/Q are not the ordered sums of its edge values: "
              f"{label}")
    return worst(errs)


def compare_sparse_kernels(torch, sk, errs):
    """S1-S4 against their plain versions at mesh118/2000/5000, several
    lane counts, float64 and float32, with a breakdown lane and a forced
    Cholesky failure (an inf in a candidate block: its lane's factor is
    all NaN, so the block must come out zero); S3 also over
    ``ORTH_CYCLES``; S2 and S3 bit-identical on repeat, S3 also across
    its two forms."""
    for ci, (name, lane_counts) in enumerate(SPARSE_CASES):
        sys_ = case_system(name)
        pc = None
        for lanes in lane_counts:
            for dtype in (torch.float64, torch.float32):
                tol12, tol34 = SPARSE_TOL[str(dtype).split(".")[-1]]
                label = f"{name} B={lanes} {str(dtype)[6:]}"
                op, x, ps, qs, pc, m_op = sparse_setup(
                    torch, sys_, lanes, 10 * ci + lanes, dtype, pc)
                e1 = compare_assemble(torch, sk, op, x, ps, qs, label)
                ev, bv, f = sk.sparse_assemble_plain(x, ps, qs, op)
                u = torch.randn_like(x)
                y2 = sk.sparse_matvec(ev, bv, u, op)
                e2 = rel_abs_err(torch, y2,
                                 sk.sparse_matvec_plain(ev, bv, u, op))
                check(same_bits(torch, y2, sk.sparse_matvec(ev, bv, u, op)),
                      f"S2 not bit-identical on repeat: {label}")
                e3 = e4 = (0.0, 0.0)
                cycles = ORTH_CYCLES if lanes == 3 else ORTH_CYCLES[:1]
                for m_k, s_k in cycles:
                    caps = gmres_captures(torch, sk, op, ev, bv, f, x, m_op,
                                          m_k, s_k)
                    ill = (name, str(dtype)[6:], (m_k, s_k)) == ILL_POSED_ORTH
                    for cap in caps:
                        if cap[0] == "orth":
                            e3 = worst([e3, compare_orth(
                                torch, sk, cap, label, tol34,
                                ORTH_F64_LIMIT if ill else None)])
                        elif (m_k, s_k) == ORTH_CYCLES[0]:
                            e4 = worst([e4, compare_lstsq(
                                torch, sk, cap, label,
                                served=(name, lanes) == ("mesh2000",
                                                         MAIN_LANES))])
                    if lanes == 3 and (m_k, s_k) == ORTH_CYCLES[0]:
                        check_forms(torch, sk,
                                    [c for c in caps if c[0] == "orth"][-1],
                                    label)
                torch.cuda.synchronize()
                log(f"sparse kernels: {name:>8} B={lanes:<3} {str(dtype)[6:]:<7}"
                    f" relative S1 {e1[0]:.1e}  S2 {e2[0]:.1e}  S3 {e3[0]:.1e}"
                    f"  S4 {e4[0]:.1e}")
                for kname, (rel, ab), tol in (
                        ("sparse_matvec", e2, tol12),
                        ("gmres_block_orth", e3, tol34),
                        ("gmres_lstsq", e4, tol34)):
                    check(rel <= tol, f"{kname} disagrees on {label}: "
                                      f"{rel} > {tol}")
                    if dtype == torch.float64:
                        errs[kname] = max(errs[kname], ab)
                if dtype == torch.float64:
                    errs["sparse_assemble"] = max(errs["sparse_assemble"],
                                                  e1[1])
                del ev, bv, f, caps
        del pc
        torch.cuda.empty_cache()


def sparse_library_matvec(torch, op, ev, bv):
    """One ``torch.sparse.mm`` of a block-diagonal CSR matrix holding every
    lane's J (from S1's values; pinned rows identity) — S2's library
    yardstick, built here and never called by the port."""
    lanes, n = ev.shape[0], op.n
    dev = ev.device
    i, j = op.inc_rows(), op.inc_nbr.long()
    ar = torch.arange(n, device=dev)
    # (row, column, sign) of each of ev's four rows, then bv's diagonals.
    entries = ((i, j, 1), (n + i, j, -1), (i, n + j, 1), (n + i, n + j, 1))
    r_list, c_list, v_list = [], [], []
    for k, (r, c, sign) in enumerate(entries):
        r_list.append(r)
        c_list.append(c)
        v_list.append(sign * ev[:, k])
    for k, (r, c) in enumerate(((ar, ar), (ar, n + ar), (n + ar, ar),
                                (n + ar, n + ar))):
        r_list.append(r)
        c_list.append(c)
        v_list.append(bv[:, k])
    r = torch.cat(r_list)
    c = torch.cat(c_list)
    v = torch.cat(v_list, dim=1)  # [B, nnz]
    free = torch.cat([op.th_free, op.v_free])
    keep = free[r] > 0
    r, c, v = r[keep], c[keep], v[:, keep]
    pinned = torch.nonzero(free == 0).flatten()
    r = torch.cat([r, pinned])
    c = torch.cat([c, pinned])
    v = torch.cat([v, torch.ones(lanes, pinned.numel(), dtype=v.dtype,
                                 device=dev)], dim=1)
    off = (torch.arange(lanes, device=dev) * 2 * n)[:, None]
    idx = torch.stack([(r[None] + off).flatten(), (c[None] + off).flatten()])
    mat = torch.sparse_coo_tensor(idx, v.flatten(),
                                  (lanes * 2 * n, lanes * 2 * n))
    return mat.coalesce().to_sparse_csr()


#: S1's modes as the kernel table names them (suffixes of its fields).
ASSEMBLE_MODES = (("", "FULL"), ("_values_f32", "VALUES_F32"),
                  ("_residual", "RESIDUAL"))


def time_assemble(torch, sk, op, x, ps, qs, rows, extra):
    """S1 in each mode at the main path's shape by CUDA events and device
    time, beside its plain version and its bound; the float64 full mode is
    the table row, the other modes (and float32) fields of its entry."""
    lanes, n, m = x.shape[0], op.n, op.m
    f64 = x.dtype == torch.float64
    w, iw = x.element_size(), 4
    # Every mode reads x and the schedules once, the incidence list with
    # its entries' admittances and the per-bus operands; the full modes
    # write ev, bv (in float32 for VALUES_F32) and f, the residual P, Q
    # and f.  Operations: ~45 per
    # edge and lane (sincos ~20), ~25 per bus and lane plus 1 per
    # incidence; the residual needs the edges' c/a terms (~35) and the
    # sums (~15 per bus).
    reads = (w * (4 * lanes * n + 4 * m + 5 * n)
             + iw * (n + 1 + 4 * m))
    for sfx, name in ASSEMBLE_MODES:
        if name == "VALUES_F32" and not f64:
            continue
        mode = getattr(sk, name)
        vw = 4 if name == "VALUES_F32" else w
        if name == "RESIDUAL":
            b1 = reads + w * 4 * lanes * n
            o1 = lanes * (35 * m + 15 * n + 2 * m)
        else:
            b1 = reads + vw * lanes * (8 * m + 6 * n) + w * 2 * lanes * n
            o1 = lanes * (45 * m + 25 * n + 2 * m)
        k = time_ms(torch, lambda: sk.sparse_assemble(x, ps, qs, op, mode),
                    reps=50)
        k_dev = device_ms(torch, lambda: sk.sparse_assemble(x, ps, qs, op,
                                                            mode), reps=20)
        p = time_ms(torch, lambda: sk.sparse_assemble_plain(x, ps, qs, op,
                                                            mode), reps=10)
        b, by = bound(b1, o1, fp64=f64)
        key = sfx + ("" if f64 else "_f32")
        if not key:
            rows["sparse_assemble"] = (k, p, None, b, by)
        else:
            extra["sparse_assemble"].update({
                "ms" + key: k, "plain_ms" + key: p, "bound_ms" + key: b,
                "library_ms" + key: None})
        extra["sparse_assemble"]["device_ms" + key] = k_dev
        log(f"timing: sparse_assemble{key:<15} kernel {k:.4f} ms (device "
            f"{k_dev:.4f})  plain {p:.4f} ms  bound {b:.4f} ms ({by})")


def time_sparse_kernels(torch, sk):
    """Each of S1-S4 at the main path's shape (mesh2000, 64 lanes,
    float64) against its plain version, its bound and, for S2, the
    library sparse product (for S4 the SVD minimum-norm solve of its H,
    ``torch.linalg.pinv``), by
    CUDA events and by device time; S2-S4
    (and the library product) also in float32, the dtype of the default
    mixed path's inner solve.  Returns ``(rows, extra)``: the float64
    table rows and the further fields of their table entries."""
    sys_ = case_system("mesh2000")
    lanes, n, m = MAIN_LANES, sys_.n_bus, sys_.n_branch
    nvec, iw = 2 * n, 4
    rows = {}
    extra = {"sparse_assemble": {}, "sparse_matvec": {},
             "gmres_block_orth": {}, "gmres_lstsq": {}}
    for dtype in (torch.float64, torch.float32):
        f64 = dtype == torch.float64
        sfx = "" if f64 else "_f32"
        w = 8 if f64 else 4
        op, x, ps, qs, pc, m_op = sparse_setup(torch, sys_, lanes, 3, dtype)
        time_assemble(torch, sk, op, x, ps, qs, rows, extra)
        ev, bv, f = sk.sparse_assemble(x, ps, qs, op)
        # S2: reads u, ev, the four diagonals, masks, the incidence
        # pointers and far ends; writes y.  4 FMAs (8 operations) per
        # incidence and lane, 4 per row.
        u = torch.randn_like(x)
        b2 = (w * (lanes * nvec + 8 * lanes * m + 4 * lanes * n + 2 * n
                   + lanes * nvec) + iw * (n + 1 + 2 * m))
        o2 = lanes * (2 * m * 8 + 8 * n)
        k = time_ms(torch, lambda: sk.sparse_matvec(ev, bv, u, op), reps=200)
        k_dev = device_ms(torch, lambda: sk.sparse_matvec(ev, bv, u, op),
                          reps=50)
        p = time_ms(torch, lambda: sk.sparse_matvec_plain(ev, bv, u, op),
                    reps=20)
        csr = sparse_library_matvec(torch, op, ev, bv)
        ucol = u.reshape(-1, 1)
        e_lib = rel_abs_err(torch, (csr @ ucol).reshape(lanes, nvec),
                            sk.sparse_matvec(ev, bv, u, op))[0]
        lib_tol = SPARSE_TOL[str(dtype)[6:]][0]
        check(e_lib <= lib_tol,
              f"library CSR product disagrees with S2 ({dtype}): {e_lib}")
        lib = time_ms(torch, lambda: csr @ ucol, reps=200)
        lib_dev = device_ms(torch, lambda: csr @ ucol, reps=50)
        b, by = bound(b2, o2, fp64=f64)
        if f64:
            rows["sparse_matvec"] = (k, p, lib, b, by)
        else:
            extra["sparse_matvec"].update(
                ms_f32=k, plain_ms_f32=p, bound_ms_f32=b, library_ms_f32=lib)
        extra["sparse_matvec"].update(
            {"device_ms" + sfx: k_dev, "library_device_ms" + sfx: lib_dev})
        log(f"timing: sparse_matvec{sfx:<4} kernel {k:.4f} ms (device "
            f"{k_dev:.4f})  plain {p:.4f} ms  bound {b:.4f} ms ({by})  "
            f"library torch.sparse.mm {lib:.4f} ms (device {lib_dev:.4f})")
        del csr
        # S3 and S4 on the inputs of a real cycle at this state.
        caps = gmres_captures(torch, sk, op, ev, bv, f, x, m_op)
        orth = [c for c in caps if c[0] == "orth"][-1]  # j0 = 12
        _, vb, valid, wb, j0 = orth
        s_ = wb.shape[1]
        vk, vp = vb.clone(), vb.clone()
        ak, ap = valid.clone(), valid.clone()
        b3 = w * lanes * ((j0 + 1) * nvec + s_ * nvec + s_ * nvec
                          + (j0 + 1) + s_)
        o3 = lanes * nvec * (2 * 4 * s_ * (j0 + 1) + 2 * 3 * s_ * s_)
        k = time_ms(torch, lambda: sk.gmres_block_orth(vk, ak, wb, j0),
                    reps=50)
        k_dev = device_ms(torch, lambda: sk.gmres_block_orth(vk, ak, wb, j0),
                          reps=20)
        p = time_ms(torch, lambda: sk.gmres_block_orth_plain(vp, ap, wb, j0),
                    reps=10)
        b, by = bound(b3, o3, fp64=f64)
        plan = sk.block_orth_plan(nvec, vb.shape[1], s_, j0, w)
        if f64:
            rows["gmres_block_orth"] = (k, p, None, b, by)
        else:
            extra["gmres_block_orth"].update(
                ms_f32=k, plain_ms_f32=p, bound_ms_f32=b, library_ms_f32=None)
        extra["gmres_block_orth"]["device_ms" + sfx] = k_dev
        log(f"timing: gmres_block_orth{sfx:<4} kernel {k:.4f} ms (device "
            f"{k_dev:.4f})  plain {p:.4f} ms  bound {b:.4f} ms ({by})  "
            f"[j0={j0}, s={s_}, cluster {plan.cluster}, "
            f"{plan.smem} B shared, resident {plan.resident}]")
        _, vb, valid, ws, zs, beta = caps[-1]
        mm = ws.shape[1]
        # S4: reads V, valid, W, Z and beta, writes x.  2 (mm+1) mm
        # operations per column for H, 2 mm for x = Z^T y (the SVD's few
        # thousand are nothing beside them).
        b4 = w * lanes * ((mm + 1) * nvec + (mm + 1) + 2 * mm * nvec + 1
                          + nvec)
        o4 = lanes * nvec * (2 * (mm + 1) * mm + 2 * mm)
        k = time_ms(torch, lambda: sk.gmres_lstsq(vb, valid, ws, zs, beta),
                    reps=50)
        parts = device_ms_by_kernel(
            torch, lambda: sk.gmres_lstsq(vb, valid, ws, zs, beta), reps=20)
        k_dev = sum(parts.values())
        p = time_ms(torch, lambda: sk.gmres_lstsq_plain(vb, valid, ws, zs,
                                                        beta), reps=10)
        b, by = bound(b4, o4, fp64=f64)
        plan = sk.lstsq_plan(nvec, mm, w)
        # The library yardstick: the SVD minimum-norm solve of the same
        # float64 H [B, mm+1, mm] and β e₁ with S4's cutoff,
        # torch.linalg.pinv and its product — the least-squares solve
        # alone, without H = Vᵀ W and x = Zᵀ y.  torch.linalg.lstsq on the
        # card takes only full-rank H (LAPACK's gels) and refuses a cycle
        # whose lanes have dead rows.
        h = (vb * valid[:, :, None]).double() @ ws.double().mT
        e1 = torch.zeros(lanes, mm + 1, 1, dtype=torch.float64,
                         device=h.device)
        e1[:, 0, 0] = beta.double()
        rtol = torch.finfo(dtype).eps * (mm + 1)
        lib = time_ms(torch, lambda: torch.linalg.pinv(h, rtol=rtol) @ e1,
                      reps=20)
        if f64:
            rows["gmres_lstsq"] = (k, p, lib, b, by)
        else:
            extra["gmres_lstsq"].update(
                ms_f32=k, plain_ms_f32=p, bound_ms_f32=b, library_ms_f32=lib)
        extra["gmres_lstsq"]["device_ms" + sfx] = k_dev
        extra["gmres_lstsq"]["library"] = (
            "torch.linalg.pinv(H, rtol) @ beta e1 of the same float64 H (the "
            "least-squares solve alone; torch.linalg.lstsq on the card "
            "refuses rank-deficient H)")
        log(f"timing: gmres_lstsq{sfx:<4}      kernel {k:.4f} ms (device "
            f"{k_dev:.4f})  plain {p:.4f} ms  bound {b:.4f} ms ({by})  "
            f"library torch.linalg.pinv @ b {lib:.4f} ms  "
            f"[mm={mm}, {plan.ctas} CTAs a lane, {plan.smem} B shared]; "
            "device by kernel: " + ", ".join(
                f"{name.split('::')[-1].split('<')[0]} {ms:.4f} ms"
                for name, ms in parts.items()))
        if f64:
            # The preconditioner apply (two bf16 products, a library call
            # of the port): reads the two [n, n] bf16 inverses and [B, 2n],
            # writes [B, 2n].
            v = x[:, n:]
            t_apply = time_ms(torch, lambda: m_op(u, v), reps=100)
            b_apply = 2 * 2 * n * n + w * 2 * lanes * nvec
            log(f"timing: precond apply (2 x bf16 [{lanes}, {n}] x [{n}, "
                f"{n}], torch.matmul) {t_apply:.4f} ms  bound "
                f"{b_apply / PEAK_BYTES * 1e3:.4f} ms (bytes)")
        del caps, vb, vk, vp, op, x, ev, bv, f, u
        torch.cuda.empty_cache()
    return rows, extra


def profile_solve(torch, fn, label, top=8):
    """One more run of ``fn`` under ``torch.profiler``: device time by
    kernel and the device's busy share of the wall.  Only the kernel
    events count (an aten op's own row repeats its kernels' time); their
    times are summed, so overlap would count twice — this path runs on
    one stream.  Returns ``(operations, busy_ms, wall_ms)``: the device
    operations it recorded (kernel launches and copies), their summed
    device time and the run's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and getattr(e, "self_device_time_total", 0) > 0]
    busy = sum(e.self_device_time_total for e in events)
    if not events:
        log(f"profile: {label}: the profiler recorded no device time")
        return 0, 0.0, wall_us / 1e3
    log(f"profile: {label}: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%, idle "
        f"{100 - 100 * busy / wall_us:.1f}%)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"profile:   {e.self_device_time_total / 1e3:8.2f} ms "
            f"{e.count:6d}x  {e.key[:90]}")
    return sum(e.count for e in events), busy / 1e3, wall_us / 1e3


def solve_sparse(torch, nk, sk):
    """mesh2000 x 64 on the sparse backend in f64 and in mixed precision:
    every lane converges with losses >= 0; three lanes within 1e-9 pu of
    the plain-version sparse solve and 1e-6 pu of the dense kernel solve.
    Then mesh5000 x 8 with the LU-kind preconditioner."""
    from freedm_tpu_torch.pf.krylov import build_fdlf_precond
    from freedm_tpu_torch.pf.newton import make_newton_solver
    from freedm_tpu_torch.pf.sparse import make_sparse_newton_solver

    sys_ = case_system("mesh2000")
    scales = np.linspace(0.5, 1.2, MAIN_LANES)[:, None]
    p = scales * sys_.p_inj[None]
    q = scales * sys_.q_inj[None]
    idx = [0, MAIN_LANES // 2, MAIN_LANES - 1]
    dense, _ = make_newton_solver(sys_, backend="dense", device="cuda")
    rd = dense(p_inj=p[idx], q_inj=q[idx])
    torch.cuda.synchronize()
    t0 = time.monotonic()
    pc = build_fdlf_precond(sys_, device="cuda")
    torch.cuda.synchronize()
    t_ns = time.monotonic() - t0
    log(f"solve: sparse mesh2000 FDLF pair ({pc.kind}, bf16, Newton-Schulz "
        f"on the card) built in {t_ns * 1e3:.1f} ms")
    load = float(-sys_.p_inj[sys_.p_inj < 0].sum())
    for prec in ("f64", "mixed"):
        solve, _ = make_sparse_newton_solver(sys_, precision=prec,
                                             precond=pc, device="cuda")
        solve(p_inj=p[:2], q_inj=q[:2])  # warm (cuBLAS handles, allocator)
        torch.cuda.synchronize()
        nk.reset_launches()
        sk.reset_launches()
        t0 = time.monotonic()
        r = solve(p_inj=p, q_inj=q)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = {**sk.launches(), **nk.launches()}
        modes = sk.assemble_launches()
        its = r.iterations.cpu().numpy()
        conv = r.converged.cpu().numpy()
        losses = r.p.sum(dim=1).cpu().numpy()
        log(f"solve: sparse {prec:<5} mesh2000 x{MAIN_LANES} in "
            f"{wall * 1e3:.1f} ms ({MAIN_LANES / wall:.1f} lane-solves/s), "
            f"iterations {its.min()}-{its.max()}, fallbacks "
            f"{int(r.fallbacks.sum())}, max mismatch "
            f"{float(r.mismatch.max()):.2e}, losses {losses.min():.4f}-"
            f"{losses.max():.4f} pu, launches {counts}, S1 by mode {modes}")
        steps = counts["gmres_lstsq"]  # one GMRES cycle per batched step
        log(f"solve: sparse {prec:<5} {steps} batched Newton steps; launches "
            f"per step " + ", ".join(
                f"{k} {v / max(steps, 1):g}" for k, v in counts.items() if v))
        kernels = profile_solve(torch, lambda: solve(p_inj=p, q_inj=q),
                                f"sparse {prec} mesh2000 x{MAIN_LANES}")[0]
        log(f"profile: sparse {prec} mesh2000 x{MAIN_LANES}: {kernels} device "
            f"operations (kernels and copies), {kernels / max(steps, 1):.1f} "
            f"per Newton step")
        check(bool(conv.all()),
              f"sparse {prec} lanes not converged: {np.where(~conv)}")
        check(bool(np.all(losses >= -1e-9)), f"negative losses: {losses.min()}")
        check(bool(np.all(losses < 0.05 * load * scales.max())),
              f"losses not small: {losses.max()} pu of {load} pu load")
        # Kernels against plain versions at a tolerance below the
        # comparison's: two correct solves stopped at tol = 1e-8 may sit
        # ~1e-8 pu apart (one stops a step earlier), so both paths run
        # to 1e-11 here.
        pair = [make_sparse_newton_solver(sys_, precision=prec, precond=pc,
                                          tol=TIGHT_TOL, device="cuda",
                                          plain=plain)[0](p_inj=p[idx],
                                                          q_inj=q[idx])
                for plain in (False, True)]
        rk, rp = pair
        dp = max(max_err(rk.v, rp.v), max_err(rk.theta, rp.theta))
        dd = max(max_err(r.v[idx], rd.v), max_err(r.theta[idx], rd.theta))
        log(f"solve: sparse {prec} lanes {idx} at tol {TIGHT_TOL:g}: kernels "
            f"vs plain |d| {dp:.2e} (iterations "
            f"{rk.iterations.cpu().tolist()} vs "
            f"{rp.iterations.cpu().tolist()}); at the default tol vs dense "
            f"|d| {dd:.2e}")
        check(bool(rk.converged.all()) and bool(rp.converged.all()),
              f"sparse {prec} lanes {idx} not converged at {TIGHT_TOL}")
        check(dp <= SOLVE_ATOL, f"sparse {prec} disagrees with plain: {dp}")
        check(dd <= 1e-6, f"sparse {prec} disagrees with dense: {dd}")
        del r, rk, rp, solve, pair
    del pc, rd, dense
    torch.cuda.empty_cache()

    sys5 = case_system("mesh5000")
    p5 = np.linspace(0.6, 1.2, 8)[:, None] * sys5.p_inj[None]
    q5 = np.linspace(0.6, 1.2, 8)[:, None] * sys5.q_inj[None]
    t0 = time.monotonic()
    pc5 = build_fdlf_precond(sys5, device="cuda")
    torch.cuda.synchronize()
    t_build = time.monotonic() - t0
    check(pc5.kind == "lu", f"mesh5000 took the {pc5.kind} preconditioner")
    solve5, _ = make_sparse_newton_solver(sys5, precond=pc5, device="cuda")
    t0 = time.monotonic()
    r5 = solve5(p_inj=p5, q_inj=q5)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    its = r5.iterations.cpu().numpy()
    log(f"solve: sparse auto mesh5000 x8 (LU-kind FDLF pair, factored in "
        f"{t_build * 1e3:.1f} ms) in {wall * 1e3:.1f} ms, iterations "
        f"{its.min()}-{its.max()}, fallbacks {int(r5.fallbacks.sum())}, "
        f"max mismatch {float(r5.mismatch.max()):.2e}")
    check(bool(r5.converged.all()), "mesh5000 lanes not converged")
    check(bool((r5.p.sum(dim=1) >= -1e-9).all()), "mesh5000 negative losses")
    del r5, solve5, pc5
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phases 6 and 7: the served paths, POST /v1/pf
# ---------------------------------------------------------------------------


def post_round(port, case, scales):
    """``len(scales)`` concurrent POST /v1/pf; returns (wall_s,
    [(status, body, latency_s)])."""

    def one(scale):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        body = json.dumps({"case": case, "scale": float(scale),
                           "timeout_s": 240.0})
        t0 = time.monotonic()
        conn.request("POST", "/v1/pf", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        lat = time.monotonic() - t0
        conn.close()
        return resp.status, json.loads(data), lat

    t0 = time.monotonic()
    with cf.ThreadPoolExecutor(len(scales)) as ex:
        out = list(ex.map(one, scales))
    return time.monotonic() - t0, out


def serve(torch, nk):
    from freedm_tpu_torch.serve.http import ServeServer
    from freedm_tpu_torch.serve.service import ServeConfig, Service

    # Cache off: this phase measures the cold dense path (serve_cache
    # measures the cache).
    svc = Service(ServeConfig(max_batch=MAIN_LANES, pf_backend="dense",
                              device="cuda", cache_mb=0.0))
    server = ServeServer(svc).start()
    try:
        cases = ("case14", "case_ieee30", "mesh118", "mesh2000")
        scales = np.linspace(0.6, 1.2, MAIN_LANES)
        for case in cases:  # engine builds + first dispatch per bucket
            post_round(server.port, case, scales[:4])
        nk.reset_launches()
        multi = False
        for case in cases:
            wall, out = post_round(server.port, case, scales)
            for status, body, _ in out:
                check(status == 200, f"{case}: HTTP {status}: {body}")
                check(body["converged"], f"{case}: not converged: {body}")
                check(body["p_balance_pu"] >= -1e-9,
                      f"{case}: negative losses {body['p_balance_pu']}")
            lanes = [b["batch"]["lanes"] for _, b, _ in out]
            multi = multi or max(lanes) > 1
            lat = np.array([x for _, _, x in out]) * 1e3
            its = [b["iterations"] for _, b, _ in out]
            log(f"serve: {case:>11} {len(out)} requests  "
                f"{len(out) / wall:.1f} solves/s  p50 "
                f"{np.percentile(lat, 50):.1f} ms  p99 "
                f"{np.percentile(lat, 99):.1f} ms  batch lanes max "
                f"{max(lanes)}  iterations {min(its)}-{max(its)}")
        counts = nk.launches()
        log(f"serve: launches {counts}")
        check(multi, "no batch coalesced more than one request")
        check(all(c > 0 for c in counts.values()),
              f"a kernel was not launched on the served path: {counts}")
        return counts
    finally:
        server.stop()
        svc.stop()


def serve_default(torch, sk):
    """The default-config server (``pf_backend="auto"``,
    ``pf_precision="auto"``: sparse and mixed at mesh2000 on the card):
    64 concurrent ``POST /v1/pf`` for mesh2000, every answer 200 and
    converged, one batch with more than one lane; S1-S4 launch counts
    over the burst must be > 0."""
    from freedm_tpu_torch.serve.http import ServeServer
    from freedm_tpu_torch.serve.service import ServeConfig, Service

    # Cache off: this phase measures the cold sparse path (serve_cache
    # measures the cache).
    svc = Service(ServeConfig(max_batch=MAIN_LANES, device="cuda",
                              cache_mb=0.0))
    server = ServeServer(svc).start()
    try:
        scales = np.linspace(0.6, 1.2, MAIN_LANES)
        t0 = time.monotonic()
        post_round(server.port, "mesh2000", scales[:4])  # engine build
        log(f"serve default: engine build + first round "
            f"{time.monotonic() - t0:.2f} s")
        sk.reset_launches()
        wall, out = post_round(server.port, "mesh2000", scales)
        counts = sk.launches()
        modes = sk.assemble_launches()
        for status, body, _ in out:
            check(status == 200, f"default mesh2000: HTTP {status}: {body}")
            check(body["converged"], f"default mesh2000: not converged: {body}")
            check(body["p_balance_pu"] >= -1e-9,
                  f"default mesh2000: negative losses {body['p_balance_pu']}")
        lanes = [b["batch"]["lanes"] for _, b, _ in out]
        lat = np.array([x for _, _, x in out]) * 1e3
        its = [b["iterations"] for _, b, _ in out]
        stats = svc.stats()
        log(f"serve default: mesh2000 {len(out)} requests  "
            f"{len(out) / wall:.1f} solves/s  p50 "
            f"{np.percentile(lat, 50):.1f} ms  p99 "
            f"{np.percentile(lat, 99):.1f} ms  batch lanes max {max(lanes)}  "
            f"iterations {min(its)}-{max(its)}  backend "
            f"{stats['pf_backend']}/{svc.engine('pf', 'mesh2000').pf_backend}"
            f" precision {svc.engine('pf', 'mesh2000').pf_precision}")
        log(f"serve default: launches {counts}, S1 by mode {modes}")
        check(svc.engine("pf", "mesh2000").pf_backend == "sparse",
              "the default server did not take the sparse backend")
        check(max(lanes) > 1, "no batch coalesced more than one request")
        check(all(c > 0 for c in counts.values()),
              f"a sparse kernel was not launched on the served path: {counts}")
        return counts, modes
    finally:
        server.stop()
        svc.stop()


# ---------------------------------------------------------------------------
# Phase 8: the serving cache (C1 and the exact, delta and warm tiers)
# ---------------------------------------------------------------------------

#: C1, the delta program, against its plain version (the host loop of
#: the mismatch modes around ``torch.linalg.lu_solve``, on the card):
#: theta and v within 1e-9 pu in f64 on every lane whose sweep count
#: agrees (the substitutions round in another order, ~1e-15 relative,
#: and each lane stops below tol = 1e-8); within ``CACHE_ATOL`` under
#: mixed, whose float32 solves in two orders propose directions ~1e-6
#: apart (relative), and on a lane one sweep apart.  Sweep counts equal,
#: or one apart on a lane (counted and printed).
PROGRAM_ATOL = {"f64": 1e-9, "mixed": 1e-6}
DELTA_CASES = (("mesh118", (1, 8)), ("mesh2000", (1, 8)),
               ("mesh5000", (1, 8)))
#: Cases whose programs also run with the mirror's solves.
MIRROR_CASES = ("mesh118", "mesh2000")
DELTA_TOL = 1e-8  # the delta program's exit bar (the engines' tolerance)
#: Requests of the serve cache phase: exact repeats and random deltas.
CACHE_REPEATS = 8
CACHE_DELTAS = 16
#: Each answer of the phase against the cache-off service's (pu).
CACHE_ATOL = 1e-6
#: Client threads that send the cache requests while a burst is in flight.
LOAD_CLIENTS = 4
#: Device cycles of the sleep queued on the cache's stream in the stream
#: check (~0.5 s at the H100's 1.98 GHz), and the checks' limits (s): the
#: engine's sync must not wait for it, the cache stream's sync must.
SLEEP_CYCLES = 1_000_000_000
ENGINE_SYNC_LIMIT_S = 0.1
CACHE_SYNC_MIN_S = 0.2
#: Kernels of ``torch.linalg.lu_solve`` that a delta program must not run.
LIBRARY_SOLVE_KERNELS = ("unpack_pivots", "trsv", "trsm", "getrs")


class DeltaCase:
    """One case's delta-program operands on ``dev``: the operands, the
    cached LU pair (``build_fdlf_precond(kind="lu")``, as the serving
    cache builds it) and a converged base state, the plain program from
    the flat start (fast-decoupled sweeps to 1e-11)."""

    def __init__(self, torch, ck, name, dev="cuda"):
        from freedm_tpu_torch.grid.bus import PQ
        from freedm_tpu_torch.pf.krylov import build_fdlf_precond
        from freedm_tpu_torch.pf.mfree import delta_operands

        self.name = name
        self.sys = sys_ = case_system(name)
        self.op = delta_operands(sys_, device=dev)
        self.pc = build_fdlf_precond(sys_, kind="lu", device=dev)
        n = sys_.n_bus
        v_flat = np.where(np.asarray(sys_.bus_type) == PQ, 1.0,
                          np.asarray(sys_.v_set, np.float64))
        flat = [torch.as_tensor(a, dtype=torch.float64, device=dev)[None]
                for a in (np.zeros(n), v_flat, sys_.p_inj, sys_.q_inj)]
        out = ck.delta_program_plain(self.op, self.pc.bp, self.pc.bq, *flat,
                                     100, 1e-11)
        check(float(out[4][0]) < 1e-11, f"{name}: no converged base state")
        self.theta0 = out[0][0].cpu().numpy()
        self.v0 = out[1][0].cpu().numpy()

    def inputs(self, lanes, seed):
        """``lanes`` random 1-16-bus deltas from the base state, as the
        program's ``[lanes, n]`` numpy arguments."""
        d = random_deltas(self.sys, np.random.default_rng(seed), lanes)
        return (np.repeat(self.theta0[None], lanes, 0),
                np.repeat(self.v0[None], lanes, 0),
                np.stack([p for p, _ in d]), np.stack([q for _, q in d]))

    def program(self, ck, precision):
        from freedm_tpu_torch.serve.cache import DELTA_MAX_SWEEPS

        return ck.DeltaProgram(self.op, self.pc.bp, self.pc.bq,
                               DELTA_MAX_SWEEPS, DELTA_TOL,
                               mixed=precision == "mixed")

    def plain(self, torch, ck, args, precision, solve=None):
        """The plain program on the card (``solve``: its triangular
        solve, ``lu_solve`` by default)."""
        from freedm_tpu_torch.serve.cache import DELTA_MAX_SWEEPS

        mixed = precision == "mixed"
        lu_p, lu_q = self.pc.bp, self.pc.bq
        if mixed:
            lu_p = (lu_p[0].float(), lu_p[1])
            lu_q = (lu_q[0].float(), lu_q[1])
        dev = self.op.g_sh.device
        t = [torch.as_tensor(a, dtype=torch.float64, device=dev)
             for a in args]
        return ck.delta_program_plain(self.op, lu_p, lu_q, *t,
                                      DELTA_MAX_SWEEPS, DELTA_TOL, mixed,
                                      solve)


def program_gap(torch, a, b):
    """Per lane: the largest |Δtheta|, |Δv| of two programs' results, and
    their sweep counts."""
    d = torch.maximum((a[0] - b[0]).abs().amax(dim=-1),
                      (a[1] - b[1]).abs().amax(dim=-1))
    return d.cpu().tolist(), a[5].cpu().tolist(), b[5].cpu().tolist()


def compare_program(torch, ck, case, lanes, precision, seed, mirror=False):
    """The kernel's program against the plain one at ``lanes`` random
    deltas (``PROGRAM_ATOL``), run twice (identical bits); with
    ``mirror``, also against the plain program on the mirror's solves
    (printed).  Returns ``(worst gap, lanes one sweep apart, sweeps)``."""
    args = case.inputs(lanes, seed)
    prog = case.program(ck, precision)
    first = [r.clone() for r in prog(*args)]
    again = prog(*args)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          f"delta program {case.name} B={lanes} {precision}: not "
          f"bit-identical on repeat")
    plain = case.plain(torch, ck, args, precision)
    gaps, sk_, sp_ = program_gap(torch, first, plain)
    apart = 0
    for lane, (g, a, b) in enumerate(zip(gaps, sk_, sp_)):
        check(abs(a - b) <= 1, f"delta program {case.name} B={lanes} "
              f"{precision} lane {lane}: {a} sweeps, plain {b}")
        apart += a != b
        limit = PROGRAM_ATOL[precision] if a == b else CACHE_ATOL
        check(g <= limit, f"delta program {case.name} B={lanes} "
              f"{precision} lane {lane}: {g:.3e} pu off the plain program "
              f"(limit {limit})")
    for k in (2, 3):  # P and Q at the answer
        check(bool(torch.isfinite(first[k]).all()),
              f"delta program {case.name}: non-finite P or Q")
    line = (f"cache kernels: C1 {case.name:>8} B={lanes} {precision:<5} vs "
            f"plain {max(gaps):.2e} pu, sweeps {sk_} (plain {sp_}, {apart} "
            f"lane(s) one apart), bit-identical on repeat")
    if mirror:
        mir = case.plain(torch, ck, args, precision, ck.lu_solve_mirror)
        gm, _, sm = program_gap(torch, first, mir)
        gpm, _, _ = program_gap(torch, plain, mir)
        line += (f"; mirror's solves: kernel {max(gm):.2e} pu, plain "
                 f"{max(gpm):.2e} pu from it, sweeps {sm}")
    log(line)
    return max(gaps), apart, sk_


def compare_delta_programs(torch, ck, errs, extra):
    """C1 against its plain program at mesh118, mesh2000 and mesh5000,
    B ∈ {1, 8}, f64 and mixed.  Returns the cases (their base states are
    reused by the timings)."""
    cases = {}
    worst = {"f64": 0.0, "mixed": 0.0}
    apart = 0
    for ci, (name, lane_counts) in enumerate(DELTA_CASES):
        case = cases[name] = DeltaCase(torch, ck, name)
        for lanes in lane_counts:
            for precision in ("f64", "mixed"):
                g, a, _ = compare_program(
                    torch, ck, case, lanes, precision,
                    seed=300 + 10 * ci + lanes, mirror=name in MIRROR_CASES)
                worst[precision] = max(worst[precision], g)
                apart += a
    errs["delta_program"] = worst["f64"]
    extra["delta_program"] = {"max_abs_err_mixed": worst["mixed"],
                              "lanes_one_sweep_apart": apart}
    return cases


def runtime_calls(prof):
    """CUDA runtime calls in a profile (the host's calls into the card)."""
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith("cuda") and not e.key.startswith("cudaGet"))


def runtime_call_names(prof):
    return ", ".join(f"{e.key} {e.count}" for e in prof.key_averages()
                     if e.key.startswith("cuda")
                     and not e.key.startswith("cudaGet"))


def device_kernels(prof):
    return [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and getattr(e, "self_device_time_total", 0) > 0]


def program_bound(case, sweeps, lanes, mixed):
    """The least time for a program: each input read once (the factor
    pair, the operands and the lanes' states and schedules), each output
    written once; the operations are the substitutions' multiply-adds
    (2 n² a solve, two solves a sweep) for the sweeps this run took."""
    n, m = case.sys.n_bus, case.sys.n_branch
    esz = 4 if mixed else 8
    bytes_ = (2 * n * n * esz + 2 * 4 * n  # factors, permutations
              + 4 * (n + 1) + 8 * 2 * m + 8 * 8 * m + 4 * 8 * n  # operands
              + lanes * (4 * 8 * n + (4 * 8 * n + 16)))  # in, out
    ops = sum(sweeps) * 2 * 2 * n * n + lanes * 50 * 2 * m
    return bound(bytes_, ops, fp64=not mixed)


def time_delta(torch, ck, cases):
    """C1 at the served path's shape (mesh2000, one lane, mixed; also 8
    lanes and f64): CUDA events over back-to-back calls (the wrapper's
    input copy and the launch) and device time per program and per sweep
    from ``torch.profiler``, beside the plain program on the card and the
    bound.  A program's profile must hold C1 alone: no ``lu_solve``
    kernel.  Mixed × 1 is the table row."""
    from torch.profiler import ProfilerActivity, profile

    case = cases["mesh2000"]
    extra = {}
    row = None
    for precision in ("mixed", "f64"):
        prog = case.program(ck, precision)
        for lanes in (1, 8):
            args = case.inputs(lanes, seed=41 + lanes)
            sweeps = prog(*args)[5].cpu().tolist()

            def call():
                return prog(*args)

            k = time_ms(torch, call, reps=20)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    ck.results_to_host(call())
            kern = device_kernels(prof)
            names = [e.key for e in kern]
            check(not any(lib in key for key in names
                          for lib in LIBRARY_SOLVE_KERNELS),
                  f"a delta program ran a library solve kernel: {names}")
            dev_ms = sum(e.self_device_time_total for e in kern
                         if "delta_program" in e.key) / 1e3 / 5
            check(dev_ms > 0, "the profiler recorded no C1 device time")
            p = time_ms(torch, lambda: case.plain(torch, ck, args, precision),
                        reps=3)
            b, by = program_bound(case, sweeps, lanes, precision == "mixed")
            per_sweep = dev_ms / max(max(sweeps), 1)
            tag = f"{precision}_B{lanes}"
            extra.update({f"ms_{tag}": k, f"device_ms_{tag}": dev_ms,
                          f"device_ms_per_sweep_{tag}": per_sweep,
                          f"sweeps_{tag}": sweeps, f"plain_ms_{tag}": p,
                          f"bound_ms_{tag}": b,
                          f"runtime_calls_per_program_{tag}":
                              runtime_calls(prof) / 5})
            log(f"timing: delta_program {precision:<5} B={lanes} kernel "
                f"{k:.4f} ms a program (device {dev_ms:.4f} ms, "
                f"{per_sweep:.4f} a sweep, sweeps {sweeps})  plain "
                f"{p:.4f} ms  bound {b:.5f} ms ({by}); profile: "
                f"{', '.join(sorted(set(names)))[:200]}; "
                f"{runtime_calls(prof) / 5:.1f} CUDA runtime calls a program "
                f"({runtime_call_names(prof)}, over 5 programs)")
            if precision == "mixed" and lanes == 1:
                row = (k, p, None, b, by)
                extra["device_ms"] = dev_ms
                extra["device_ms_per_sweep"] = per_sweep
    return {"delta_program": row}, {"delta_program": extra}


def post_pf(port, body):
    """One ``POST /v1/pf``: ``(status, body, latency_s, end)`` (``end`` on
    the monotonic clock)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.monotonic()
    conn.request("POST", "/v1/pf", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    end = time.monotonic()
    conn.close()
    return resp.status, data, end - t0, end


def random_deltas(sys_, rng, count):
    """``count`` injection pairs, each the case's own with 1-16 random
    buses moved by up to ±0.05 pu P and ±0.02 pu Q."""
    p0 = np.asarray(sys_.p_inj, np.float64)
    q0 = np.asarray(sys_.q_inj, np.float64)
    out = []
    for _ in range(count):
        p, q = p0.copy(), q0.copy()
        k = min(int(rng.integers(1, 17)), sys_.n_bus)
        for j in rng.choice(sys_.n_bus, size=k, replace=False):
            p[j] += rng.uniform(-0.05, 0.05)
            q[j] += rng.uniform(-0.02, 0.02)
        out.append((p, q))
    return out


def check_delta(label, status, data):
    check(status == 200, f"{label}: HTTP {status}: {str(data)[:300]}")
    check(data["converged"], f"{label}: not converged")
    check(data["batch"]["tier"] == "delta",
          f"{label}: tier {data['batch']['tier']}, not delta")
    check(data["residual_pu"] <= 1e-8,
          f"{label}: residual {data['residual_pu']}")


def cache_under_load(svc, port, case, deltas):
    """Cache requests while a 64-request burst of the same case is in
    flight, in turns: the burst alone; with :data:`CACHE_DELTAS` new
    deltas of the base case (tier ``delta``, the base case requested just
    before); with the same requests again (now tier
    ``exact``: the same HTTP and JSON work, no device work); twice more
    with new deltas and their repeat; alone.  :data:`LOAD_CLIENTS` client
    threads send a turn's requests, each thread one after another (the
    cache combines deltas that meet into lanes of one program call).  The
    burst's requests carry ``theta0`` = the flat start, which bypasses the
    cache both ways, so every turn's burst is the same cold batched work.
    Checks every answer and that the requests ran while the burst did;
    prints their p50/p99 beside the burst's wall and its
    ``serve_solve_seconds`` (sum over its batches), and their means by
    turn kind.  Returns the delta answers ``[(kind, body, data,
    latency_s)]``."""
    from freedm_tpu_torch.core import metrics as obs

    hist = obs.SERVE_SOLVE_LATENCY.labels("pf")
    n = len(deltas[0][0])
    burst = [{"case": case, "scale": float(x), "theta0": [0.0] * n,
              "timeout_s": 240.0}
             for x in np.linspace(0.6, 1.2, MAIN_LANES)]
    todo = iter(deltas)
    solve = {"alone": [], "delta": [], "exact": []}
    answers = []

    def send(bodies):
        return [(body, *post_pf(port, body)) for body in bodies]

    bodies = []
    for kind in ("alone", "delta", "exact", "delta", "exact", "alone"):
        if kind == "delta":
            bodies = [{"case": case, "p_inj": p.tolist(), "q_inj": q.tolist(),
                       "return_state": True, "timeout_s": 240.0}
                      for p, q in (next(todo) for _ in range(CACHE_DELTAS))]
            # The base case again, so its solution is among the DELTA_SCAN
            # most recent ones the deltas are measured against.
            status, data, _, _ = post_pf(port, {"case": case})
            check(status == 200 and data["batch"]["tier"] == "exact",
                  f"base repeat: HTTP {status}: {str(data)[:300]}")
        mine = bodies if kind != "alone" else []
        s0, c0 = hist.sum, hist.count
        runs0 = svc.stats()["cache"]["delta_runs"]
        with cf.ThreadPoolExecutor(MAIN_LANES + LOAD_CLIENTS) as ex:
            t0 = time.monotonic()
            bfuts = [ex.submit(post_pf, port, body) for body in burst]
            time.sleep(0.05)  # the burst is admitted first
            dfuts = [ex.submit(send, mine[i::LOAD_CLIENTS])
                     for i in range(LOAD_CLIENTS)]
            bout = [f.result() for f in bfuts]
            dout = [x for f in dfuts for x in f.result()]
        burst_end = max(x[3] for x in bout)
        wall = burst_end - t0
        solve_s, batches = hist.sum - s0, hist.count - c0
        solve[kind].append(solve_s)
        for status, data, _, _ in bout:
            check(status == 200, f"load burst: HTTP {status}: "
                  f"{str(data)[:300]}")
            check(data["converged"] and data["batch"]["tier"] == "full",
                  f"load burst: {data['batch']}")
        blat = np.array([x[2] for x in bout]) * 1e3
        line = (f"serve cache: under load, {kind:<5} burst of {len(bout)} "
                f"(theta0 given: no cache) wall {wall * 1e3:.1f} ms, p50 "
                f"{np.percentile(blat, 50):.1f} ms, serve_solve_seconds "
                f"{solve_s * 1e3:.1f} ms over {batches} batches")
        if mine:
            for body, status, data, lat, end in dout:
                if kind == "delta":
                    check_delta("delta under load", status, data)
                    answers.append(("delta_load", body, data, lat))
                else:
                    check(status == 200 and data["batch"]["tier"] == "exact",
                          f"repeat under load: HTTP {status}: "
                          f"{str(data)[:300]}")
            dlat = np.array([x[3] for x in dout]) * 1e3
            inside = sum(x[4] < burst_end for x in dout)
            runs = svc.stats()["cache"]["delta_runs"] - runs0
            line += (f"; {len(dout)} {kind} requests from {LOAD_CLIENTS} "
                     f"clients ({runs} delta programs), p50 "
                     f"{np.percentile(dlat, 50):.2f} ms p99 "
                     f"{np.percentile(dlat, 99):.2f} ms, solve_ms "
                     f"{np.median([x[2]['batch']['solve_ms'] for x in dout]):.2f}"
                     f" (median), {inside} answered before the burst ended")
            check(2 * inside >= len(dout),
                  f"only {inside} of {len(dout)} requests ran during the "
                  f"burst")
        log(line)
    mean = {k: float(np.mean(v)) for k, v in solve.items()}
    log(f"serve cache: the burst's serve_solve_seconds, mean ms: alone "
        f"{mean['alone'] * 1e3:.1f}, with exact repeats "
        f"{mean['exact'] * 1e3:.1f} ({mean['exact'] / mean['alone']:.3f}x), "
        f"with deltas {mean['delta'] * 1e3:.1f} "
        f"({mean['delta'] / mean['alone']:.3f}x)")
    return answers


def serve_cache(torch, ck, sk, dev="cuda", case="mesh2000"):
    """The default-config server with the cache on (cache_mb=64; mesh2000,
    sparse and mixed): prime the base case, repeats (exact), random deltas
    of 1-16 buses (delta), one request with every bus scaled (warm: full,
    ``hits.warm`` + 1), one delta with the verify bar forced to 1e-300
    (falls through to a warm-seeded full solve), then deltas under a burst
    (:func:`cache_under_load`).  Every answer converged and within
    ``CACHE_ATOL`` of the same request on a ``cache_mb=0`` service; every
    delta answer's host-verified residual ≤ 1e-8; the engine's sync does
    not wait for the cache's stream (:func:`stream_isolation`); no
    request's cache tier raised (``/stats`` ``errors`` 0); C1 launched once
    a delta program.  Then the delta program's wall per answer in two
    turns (identical results) and profiled answers' device time, device
    operations and CUDA runtime calls (no ``lu_solve`` kernel among
    them).  Returns C1's launches over the served requests.  (``dev`` and ``case`` let a
    rehearsal run the phase on the CPU at a small case.)"""
    from freedm_tpu_torch.serve.cache import injection_digest
    from freedm_tpu_torch.serve.http import ServeServer
    from freedm_tpu_torch.serve.service import ServeConfig, Service

    card = dev == "cuda"
    svc = Service(ServeConfig(max_batch=MAIN_LANES, device=dev))
    check(svc.cache is not None
          and svc.cache.precision == ("mixed" if card else "f64"),
          "the default server has no cache tier of the default precision")
    server = ServeServer(svc).start()
    try:
        sys_ = case_system(case)
        p0 = np.asarray(sys_.p_inj, np.float64)
        q0 = np.asarray(sys_.q_inj, np.float64)
        rng = np.random.default_rng(2026)
        deltas = random_deltas(sys_, rng, CACHE_DELTAS + 1)
        base = {"case": case}
        plan = ([("full", base)] + [("exact", base)] * CACHE_REPEATS
                + [("delta", {"case": case, "p_inj": p.tolist(),
                              "q_inj": q.tolist()})
                   for p, q in deltas[:CACHE_DELTAS]]
                + [("warm", {"case": case, "scale": 1.1}),
                   ("fallthrough", {"case": case,
                                    "p_inj": deltas[-1][0].tolist(),
                                    "q_inj": deltas[-1][1].tolist()})])
        ck.reset_launches()
        sk.reset_launches()
        answers = []
        for kind, body in plan:
            hits = svc.stats()["cache"]["hits"]
            if kind == "fallthrough":
                svc.cache.verify_tol = 1e-300
            try:
                status, data, lat, _ = post_pf(
                    server.port,
                    {**body, "return_state": True, "timeout_s": 240.0})
            finally:
                svc.cache.verify_tol = None
            after = svc.stats()["cache"]["hits"]
            if kind == "delta":
                check_delta("cache delta", status, data)
            check(status == 200, f"cache {kind}: HTTP {status}: "
                  f"{str(data)[:300]}")
            check(data["converged"], f"cache {kind}: not converged")
            tier = data["batch"]["tier"]
            want = {"full": "full", "exact": "exact", "delta": "delta",
                    "warm": "full", "fallthrough": "full"}[kind]
            check(tier == want, f"cache {kind}: tier {tier}, not {want}")
            if kind in ("warm", "fallthrough"):
                check(after["warm"] == hits["warm"] + 1
                      and after["delta"] == hits["delta"],
                      f"cache {kind}: hits {hits} -> {after}")
            answers.append((kind, body, data, lat))
        c1_counts = ck.launches()
        s_counts = sk.launches()
        stats = svc.stats()["cache"]
        log(f"serve cache: launches C1 {c1_counts}, S1-S4 {s_counts}; "
            f"cache {json.dumps(stats)}")
        check(not card or c1_counts["delta_program"] > 0,
              "C1 was not launched on the served delta path")
        check(not card or c1_counts["delta_program"] == stats["delta_runs"],
              f"C1 launches {c1_counts} are not one a delta program "
              f"({stats['delta_runs']} programs)")
        check(not card or all(c > 0 for c in s_counts.values()),
              f"a sparse kernel was not launched by the full solves: "
              f"{s_counts}")
        eng = svc.engine("pf", case)
        entry = svc.cache.entry(case, eng._sys, eng.cache_backend,
                                topo=eng.cache_topo)
        for kind in ("full", "exact", "delta", "warm", "fallthrough"):
            lat = np.array([a[3] for a in answers if a[0] == kind]) * 1e3
            its = [a[2]["iterations"] for a in answers if a[0] == kind]
            solve = [a[2]["batch"]["solve_ms"] for a in answers
                     if a[0] == kind]
            log(f"serve cache: {kind:<11} {len(lat):2d} requests  p50 "
                f"{np.percentile(lat, 50):.2f} ms  p99 "
                f"{np.percentile(lat, 99):.2f} ms  iterations/sweeps "
                f"{its}  solve_ms {solve}")
        answers += cache_under_load(svc, server.port, case,
                                    random_deltas(sys_, rng,
                                                  2 * CACHE_DELTAS))
        if card:
            stream_isolation(torch, svc, case)
        stats = svc.stats()["cache"]
        log(f"serve cache: after the load turns {json.dumps(stats)}")
        check(stats["errors"] == 0,
              f"the cache tier raised {stats['errors']} time(s): see the log")
    finally:
        server.stop()
        svc.stop()

    cold = Service(ServeConfig(max_batch=MAIN_LANES, device=dev,
                               cache_mb=0.0))
    try:
        worst_d = 0.0
        cold.request("pf", {"case": case, "scale": 0.9})  # engine build
        cold_lat = {}
        for kind, body, data, _ in answers:
            t0 = time.monotonic()
            r = cold.request("pf", {**body, "return_state": True,
                                    "timeout_s": 240.0})
            cold_lat.setdefault(kind, []).append(time.monotonic() - t0)
            check(r.converged, f"cold {kind}: not converged")
            d = max(float(np.max(np.abs(np.array(r.v) - np.array(data["v"])))),
                    float(np.max(np.abs(np.array(r.theta)
                                        - np.array(data["theta"])))))
            worst_d = max(worst_d, d)
            check(d <= CACHE_ATOL, f"cache {kind}: {d:.3e} pu from the "
                  f"cache-off service")
        log(f"serve cache: every answer within {worst_d:.2e} pu of the "
            f"cache-off service (limit {CACHE_ATOL})")
        for kind, lat in cold_lat.items():
            lat = np.array(lat) * 1e3
            log(f"serve cache: the same {kind} requests on the cache-off "
                f"service (in process): p50 {np.percentile(lat, 50):.2f} ms "
                f"p99 {np.percentile(lat, 99):.2f} ms")
    finally:
        cold.stop()

    # The served delta program alone, on a stream of its own, from the
    # base solution to each of the first turn's deltas.
    near = entry.solutions.get(injection_digest(p0, q0))
    check(near is not None, "the base solution was evicted")
    deltas = deltas[:CACHE_DELTAS]
    stream = torch.cuda.Stream() if card else None
    program = entry.ensure_delta_fn()

    def on_stream():
        return (torch.cuda.stream(stream) if card
                else contextlib.nullcontext())

    def run_all():
        outs = []
        t0 = time.monotonic()
        with on_stream():
            for p, q in deltas:
                out = ck.results_to_host(program(near.theta, near.v, p, q))
                outs.append(tuple(np.array(o) for o in out))
        return (time.monotonic() - t0) / len(deltas) * 1e3, outs

    walls = []
    ref_outs = None
    for _ in range(2):
        w, outs = run_all()
        walls.append(w)
        if ref_outs is None:
            ref_outs = outs
        check(all(np.array_equal(a, b) for o1, o2 in zip(outs, ref_outs)
                  for a, b in zip(o1, o2)),
              "the delta program is not bit-identical on repeat")
    sweeps = [int(o[5]) for o in ref_outs]
    log(f"serve cache: delta program sweeps {sweeps} (mean "
        f"{np.mean(sweeps):.2f}); wall per answer {walls[0]:.3f} / "
        f"{walls[1]:.3f} ms (two turns, identical results)")
    from torch.profiler import ProfilerActivity, profile

    # Three answers a window; a window that comes back without device
    # events (now and then on the H100) is taken again.
    answers_in_window = 3
    for _ in range(3):
        with on_stream():
            ck.results_to_host(program(near.theta, near.v, *deltas[0]))
            if card:
                torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.monotonic()
                outs = [ck.results_to_host(program(near.theta, near.v, p, q))
                        for p, q in deltas[:answers_in_window]]
                wall = (time.monotonic() - t0) * 1e3 / answers_in_window
        events = device_kernels(prof)
        if events or not card:
            break
    nsw = float(np.mean([int(o[5]) for o in outs]))
    per = answers_in_window
    c1_us = sum(e.self_device_time_total for e in events
                if "delta_program" in e.key) / per
    other_us = sum(e.self_device_time_total for e in events
                   if "delta_program" not in e.key) / per
    ops = sum(e.count for e in events) / per
    calls = runtime_calls(prof) / per
    log(f"serve cache: profiled delta answers ({per} in the window), "
        f"{nsw:.2f} sweeps each: wall {wall:.3f} ms an answer "
        f"({wall / max(nsw, 1):.3f} ms a sweep); device C1 "
        f"{c1_us / 1e3:.4f} ms ({c1_us / 1e3 / max(nsw, 1):.4f} a sweep), "
        f"copies and the rest {other_us / 1e3:.4f} ms; {ops:.1f} device "
        f"operations and {calls:.1f} CUDA runtime calls an answer "
        f"({runtime_call_names(prof)})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"profile:   {e.self_device_time_total / 1e3:8.4f} ms "
            f"{e.count:6d}x  {e.key[:240]}")
    if card:
        names = [e.key for e in events]
        check(c1_us > 0, "the profiled delta answer ran no C1")
        check(not any(lib in key for key in names
                      for lib in LIBRARY_SOLVE_KERNELS),
              f"the delta answer ran a library solve kernel: {names}")
    return c1_counts


def stream_isolation(torch, svc, case):
    """The batcher's one sync waits for the solve's stream alone: with a
    ~0.5 s device sleep queued on the cache's stream, the pf engine's
    ``synchronize`` (called from a thread on the default stream, as the
    batcher's lane is) returns at once, and a sync of the cache's stream
    waits for the sleep."""
    eng = svc.engine("pf", case)
    cache = svc.cache
    torch.cuda.synchronize()
    with cache._delta_run:
        with cache._on_stream():
            torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.monotonic()
        eng.synchronize()
        t_eng = time.monotonic() - t0
        cache._stream.synchronize()
        t_cache = time.monotonic() - t0
    log(f"serve cache: stream check, {SLEEP_CYCLES:.0e} cycles asleep on the "
        f"cache's stream: the engine's sync returned in {t_eng * 1e3:.3f} ms, "
        f"the cache stream's in {t_cache * 1e3:.1f} ms")
    check(t_eng < ENGINE_SYNC_LIMIT_S,
          f"the engine's sync waited {t_eng:.3f} s for the cache's stream")
    check(t_cache > CACHE_SYNC_MIN_S,
          f"the cache stream's sleep took only {t_cache:.3f} s")


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phase 9: the screening kernels (S1 with status, N1, D1)
# ---------------------------------------------------------------------------

#: S1 with a per-lane status against its plain version: the cases and
#: lane counts (the served N-1 shape is mesh2000 × up to 256 lanes).
STATUS_CASES = (("mesh118", (1, 3, 64, 256)), ("mesh2000", (1, 3, 64, 256)))
#: N1 against its plain version: every mode on identical inputs, θ, V, the
#: right-hand sides, P, Q and err within 1e-12 absolute (the two differ in
#: sin/cos and the order of the lane's sums only; ≤ 3.1e-14 on an H100).
SMW_ATOL = 1e-12
SMW_CASES = ("case_ieee30", "mesh118", "mesh511")
SMW_LANES = (1, 64, 256)
#: D1 against its plain version: angles, flows and severity within 1e-12
#: absolute, ``islanded`` exactly.
DC_ATOL = 1e-12
DC_CASES = (("mesh118", (1, 1024)), ("mesh2000", (1, 1024)))
#: The served screens' sizes: mesh2000 × 256 chord outages (sparse), the
#: DC solver's 4096 injection lanes and 1024 outage lanes.
N1_LANES = 256
DC_INJECTION_LANES = 4096
DC_OUTAGE_LANES = 1024
N1_MAX_ITER = 24  # ServeConfig.n1_max_iter


def sync(torch, dev):
    """Wait for the card (no-op for a CPU rehearsal of a phase)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def chords(sys_, count, start=0):
    """``count`` chord outages of a synthetic mesh (branches past the
    first n, which never island it)."""
    return np.asarray(sys_.n_bus + (start + np.arange(count))
                      % (sys_.n_branch - sys_.n_bus), np.int64)


def outage_status(torch, sys_, lanes, seed, single, dtype, dev):
    """``[lanes, m]`` 0/1 status: one chord out a lane (``single``) or
    about one branch in ten out at random."""
    m = sys_.n_branch
    if single:
        st = np.ones((lanes, m))
        st[np.arange(lanes), chords(sys_, lanes, seed)] = 0.0
    else:
        st = (np.random.default_rng(seed).uniform(size=(lanes, m))
              > 0.1).astype(np.float64)
    return torch.as_tensor(st, device=dev).to(dtype)


def compare_status_assemble(torch, sk, errs, dev="cuda"):
    """S1 with a per-lane status in each mode against its plain version
    (``compare_assemble``: ``SPARSE_TOL``, bit-identical on repeat, the
    modes' bit relations), random and single-outage status, float64 and
    float32; in float64 an all-in-service status gives the no-status
    bits."""
    for name, lane_counts in STATUS_CASES:
        sys_ = case_system(name)
        for lanes in lane_counts:
            for dtype in (torch.float64, torch.float32):
                op, x, ps, qs, _, _ = sparse_setup(torch, sys_, lanes,
                                                   lanes + 5, dtype,
                                                   pc=False, device=dev)
                e = (0.0, 0.0)
                for single in (False, True):
                    st = outage_status(torch, sys_, lanes, lanes, single,
                                       dtype, x.device)
                    label = (f"{name} B={lanes} {str(dtype)[6:]} status "
                             f"{'single' if single else 'random'}")
                    e = worst([e, compare_assemble(torch, sk, op, x, ps, qs,
                                                   label, status=st)])
                if dtype == torch.float64:
                    ones = torch.ones(lanes, sys_.n_branch, dtype=dtype,
                                      device=x.device)
                    for mode in (sk.FULL, sk.VALUES_F32, sk.RESIDUAL):
                        check(all(same_bits(torch, a, b) for a, b in zip(
                            sk.sparse_assemble(x, ps, qs, op, mode, ones),
                            sk.sparse_assemble(x, ps, qs, op, mode))),
                            f"S1 with an all-in-service status differs from "
                            f"S1 without one: {name} B={lanes} mode {mode}")
                    errs["sparse_assemble"] = max(errs["sparse_assemble"],
                                                  e[1])
                sync(torch, dev)
                log(f"screen kernels: S1 status {name:>8} B={lanes:<3} "
                    f"{str(dtype)[6:]:<7} relative {e[0]:.1e} abs "
                    f"{e[1]:.1e}")


def smw_steps(torch, sck, lu_p, lu_q, op, ks, sweep):
    """One INIT, THETA, V, FINISH chain of N1 (``sweep``: the wrapper or
    its plain version) from the flat start: every mode's outputs."""
    lanes, n = int(ks.shape[0]), op.n
    th, v, rhs = (torch.empty(lanes, n, dtype=torch.float64,
                              device=ks.device) for _ in range(3))
    outs = []
    sweep(sck.INIT, ks, th, v, rhs, op)
    outs += [th.clone(), v.clone(), rhs.clone()]
    for mode, lu in ((sck.THETA, lu_p), (sck.V, lu_q)):
        x0 = torch.linalg.lu_solve(lu[0], lu[1], rhs.mT)
        sweep(mode, ks, th, v, rhs, op, x0)
        outs += [th.clone(), v.clone(), rhs.clone()]
    outs += list(sweep(sck.FINISH, ks, th, v, rhs, op))
    return outs


def compare_smw(torch, sck, errs, dev="cuda"):
    """N1 in every mode against its plain version on identical inputs
    (``SMW_ATOL``) and bit-identical on repeat, at case_ieee30, mesh118
    and mesh511 over ``SMW_LANES`` of their secure outages (the pinned
    endpoints of case_ieee30 among them)."""
    from freedm_tpu_torch.pf.n1 import secure_outages, smw_operands

    for name in SMW_CASES:
        sys_ = case_system(name)
        sec = np.asarray(secure_outages(sys_), np.int64)
        lu_p, lu_q, op = smw_operands(sys_, device=dev)
        worst_e = 0.0
        for lanes in SMW_LANES:
            ks = torch.as_tensor(np.resize(sec, lanes), device=dev)
            got = smw_steps(torch, sck, lu_p, lu_q, op, ks, sck.smw_sweep)
            again = smw_steps(torch, sck, lu_p, lu_q, op, ks, sck.smw_sweep)
            check(all(same_bits(torch, a, b) for a, b in zip(got, again)),
                  f"N1 not bit-identical on repeat: {name} L={lanes}")
            # Each mode on the kernel's own inputs: the plain chain from
            # the same start would drift apart by its own roundings.
            th, v, rhs = (t.clone() for t in got[:3])
            for i, (mode, lu) in enumerate(((sck.THETA, lu_p),
                                            (sck.V, lu_q))):
                th0, v0, r0 = (t.clone() for t in got[3 * i:3 * i + 3])
                x0 = torch.linalg.lu_solve(lu[0], lu[1], r0.mT)
                sck.smw_sweep_plain(mode, ks, th0, v0, r0, op, x0)
                for a, b in zip((th0, v0, r0), got[3 * i + 3:3 * i + 6]):
                    worst_e = max(worst_e, float((a - b).abs().max()))
            p_th, p_v, p_r = (t.clone() for t in got[6:9])
            for a, b in zip(sck.smw_sweep_plain(sck.FINISH, ks, p_th, p_v,
                                                p_r, op), got[9:]):
                worst_e = max(worst_e, float((a - b).abs().max()))
            sck.smw_sweep_plain(sck.INIT, ks, th, v, rhs, op)
            for a, b in zip((th, v, rhs), got[:3]):
                worst_e = max(worst_e, float((a - b).abs().max()))
        sync(torch, dev)
        log(f"screen kernels: N1 {name:>11} L in {SMW_LANES} "
            f"({len(sec)} secure outages) max abs {worst_e:.1e}")
        check(worst_e <= SMW_ATOL, f"smw_sweep disagrees on {name}: "
                                   f"{worst_e} > {SMW_ATOL}")
        errs["smw_sweep"] = max(errs["smw_sweep"], worst_e)


def compare_dc(torch, sck, errs, dev="cuda"):
    """D1 in both modes against its plain version (``DC_ATOL``,
    ``islanded`` exactly), bit-identical on repeat, at mesh118 and
    mesh2000 (L ∈ {1, 1024}); the bridges of case14 and case_ieee30
    flagged islanded by both, exactly the branches whose removal islands
    the network."""
    from freedm_tpu_torch.pf.dc import make_dc_solver
    from freedm_tpu_torch.pf.n1 import secure_outages

    worst_e = 0.0

    def agree(a, b, label):
        nonlocal worst_e
        check(torch.equal(a.islanded, b.islanded),
              f"dc_screen islanded flags differ: {label}")
        for k in ("theta", "flows", "severity"):
            x, y = getattr(a, k), getattr(b, k)
            fin = torch.isfinite(y)
            check(torch.equal(fin, torch.isfinite(x)),
                  f"dc_screen {k}: finite entries differ: {label}")
            worst_e = max(worst_e, float((x[fin] - y[fin]).abs().max()))

    for name in ("case14", "case_ieee30"):
        sys_ = case_system(name)
        ks = np.arange(sys_.n_branch)
        dc = make_dc_solver(sys_, device=dev)
        got = dc.screen_outages(ks)
        agree(got, make_dc_solver(sys_, device=dev,
                                  plain=True).screen_outages(ks), name)
        bridges = sorted(set(range(sys_.n_branch)) - set(secure_outages(sys_)))
        flagged = torch.nonzero(got.islanded).flatten().cpu().tolist()
        check(bridges and flagged == bridges,
              f"{name}: islanded lanes {flagged} are not the bridges "
              f"{bridges}")
        log(f"screen kernels: D1 {name}: bridges {bridges} flagged islanded "
            f"(severity inf) by kernel and plain version")
    for name, lane_counts in DC_CASES:
        sys_ = case_system(name)
        dc = make_dc_solver(sys_, device=dev)
        plain = make_dc_solver(sys_, device=dev, plain=True)
        for lanes in lane_counts:
            ks = chords(sys_, lanes)
            got = dc.screen_outages(ks)
            again = dc.screen_outages(ks)
            check(all(same_bits(torch, getattr(got, k), getattr(again, k))
                      for k in ("theta", "flows", "severity"))
                  and torch.equal(got.islanded, again.islanded),
                  f"D1 SCREEN not bit-identical on repeat: {name} L={lanes}")
            agree(got, plain.screen_outages(ks), f"{name} L={lanes}")
            pj = torch.as_tensor(np.random.default_rng(lanes).uniform(
                0.5, 1.5, (lanes, 1)) * sys_.p_inj, device=dev)
            a, b = dc.solve(pj), plain.solve(pj)
            check(same_bits(torch, a.flows, dc.solve(pj).flows),
                  f"D1 SOLVE not bit-identical on repeat: {name} L={lanes}")
            worst_e = max(worst_e, float((a.flows - b.flows).abs().max()))
        sync(torch, dev)
        log(f"screen kernels: D1 {name:>8} L in {lane_counts} max abs "
            f"{worst_e:.1e}")
    check(worst_e <= DC_ATOL, f"dc_screen disagrees: {worst_e} > {DC_ATOL}")
    errs["dc_screen"] = max(errs["dc_screen"], worst_e)


def time_screen_kernels(torch, sk, sck, rows, extra, dev="cuda"):
    """Times at the served shapes, CUDA events and device time, beside
    the plain versions and the bounds: S1 with status at mesh2000 × 256
    (and × 64, beside S1 without status on the same inputs); N1 at
    mesh511 × 256 (each mode) and case_ieee30 × 64; D1 SCREEN at mesh2000
    × 1024 and SOLVE at × 4096."""
    from freedm_tpu_torch.pf.dc import (dc_operands, make_dc_solver,
                                        outage_columns)
    from freedm_tpu_torch.pf.fdlf import decoupled_parts
    from freedm_tpu_torch.pf.n1 import secure_outages, smw_operands

    sys_ = case_system("mesh2000")
    n, m = sys_.n_bus, sys_.n_branch
    w = 8
    for lanes in (MAIN_LANES, N1_LANES):
        op, x, ps, qs, _, _ = sparse_setup(torch, sys_, lanes, 9,
                                           torch.float64, pc=False, device=dev)
        st = outage_status(torch, sys_, lanes, 0, True, torch.float64,
                           x.device)
        reads = w * (4 * lanes * n + 6 * m + 7 * n) + 4 * (n + 1 + 4 * m)
        for sfx, name in ASSEMBLE_MODES:
            mode = getattr(sk, name)
            vw = 4 if name == "VALUES_F32" else w
            if name == "RESIDUAL":
                b1 = reads + w * 4 * lanes * n
                o1 = lanes * (35 * m + 15 * n + 2 * m)
            else:
                b1 = reads + vw * lanes * (8 * m + 6 * n) + w * 2 * lanes * n
                o1 = lanes * (45 * m + 25 * n + 2 * m)
            b1 += w * lanes * m  # the status
            o1 += lanes * 8 * m  # the scaled admittances and self terms
            b, by = bound(b1, o1)

            def fn(s_):
                return lambda: sk.sparse_assemble(x, ps, qs, op, mode, s_)
            k = time_ms(torch, fn(st), reps=50)
            # Device time in turns: with, without, without, with status.
            turns = [device_ms(torch, fn(s_), reps=20)
                     for s_ in (st, None, None, st)]
            with_st, without = (turns[0] + turns[3]) / 2, turns[1:3]
            p = time_ms(torch, lambda: sk.sparse_assemble_plain(
                x, ps, qs, op, mode, st), reps=5)
            key = f"{sfx}_status_x{lanes}"
            extra["sparse_assemble"].update({
                "ms" + key: k, "device_ms" + key: with_st,
                "plain_ms" + key: p, "bound_ms" + key: b,
                "device_ms_turns" + key: turns})
            log(f"timing: sparse_assemble{sfx} status x{lanes:<4} kernel "
                f"{k:.4f} ms (device {with_st:.4f}; in turns with / "
                f"without / without / with status "
                + " / ".join(f"{t_:.4f}" for t_ in turns)
                + f")  plain {p:.4f} ms  bound {b:.4f} ms ({by})")
        del op, x, ps, qs, st
    # N1: the served SMW shapes.
    for name, lanes, main in (("mesh511", N1_LANES, True),
                              ("case_ieee30", MAIN_LANES, False)):
        sys5 = case_system(name)
        n5, m5 = sys5.n_bus, sys5.n_branch
        sec = np.asarray(secure_outages(sys5), np.int64)
        lu_p, lu_q, op5 = smw_operands(sys5, device=dev)
        ks = torch.as_tensor(np.resize(sec, lanes), device=dev)
        th, v, rhs = (torch.empty(lanes, n5, dtype=torch.float64,
                                  device=dev) for _ in range(3))
        sck.smw_sweep(sck.INIT, ks, th, v, rhs, op5)
        x0 = torch.linalg.lu_solve(lu_p[0], lu_p[1], rhs.mT)
        # Bytes: x0, the lane's ZM rows, θ and V read, a half and the
        # right-hand side written; the operands once.  Operations: sincos
        # (~40) a bus, ~30 a list entry, ~8 a bus for the update.
        opnd = 8 * (8 * m5 + 9 * n5) + 4 * (n5 + 1 + 4 * m5) + 16 * m5
        b_mode = {
            "INIT": opnd + w * 3 * lanes * n5,
            "THETA": opnd + w * lanes * n5 * 7,
            "V": opnd + w * lanes * n5 * 7,
            "FINISH": opnd + w * lanes * (4 * n5 + 1)}
        o_mode = lanes * (48 * n5 + 60 * m5)
        times = {}
        for mname in ("INIT", "THETA", "V", "FINISH"):
            mode = getattr(sck, mname)

            def fn(mode=mode):
                # THETA and V rewrite θ (V) from the same x0 each call:
                # the timed work of one half-iteration.
                return sck.smw_sweep(mode, ks, th, v, rhs, op5,
                                     x0 if mode in (sck.THETA, sck.V)
                                     else None)
            k = time_ms(torch, fn, reps=50)
            kd = device_ms(torch, fn, reps=20)
            pl = time_ms(torch, lambda mode=mode: sck.smw_sweep_plain(
                mode, ks, th.clone(), v.clone(), rhs.clone(), op5,
                x0 if mode in (sck.THETA, sck.V) else None), reps=5)
            b, by = bound(b_mode[mname], o_mode)
            times[mname] = (k, kd, pl, b, by)
            log(f"timing: smw_sweep {name} x{lanes} {mname:<6} kernel "
                f"{k:.4f} ms (device {kd:.4f})  plain {pl:.4f} ms  bound "
                f"{b:.5f} ms ({by})")
        lu_ms = device_ms(torch, lambda: torch.linalg.lu_solve(
            lu_p[0], lu_p[1], rhs.mT), reps=20)
        log(f"timing: lu_solve {name} [{n5}, {lanes}] device {lu_ms:.4f} ms "
            f"(the SMW screen's base solve, 2 an iteration)")
        key = "" if main else f"_{name}_x{lanes}"
        if main:
            k, kd, pl, b, by = times["THETA"]
            rows["smw_sweep"] = (k, pl, None, b, by)
            extra["smw_sweep"] = {"device_ms": kd, "shape": f"{name} x{lanes}"
                                  " THETA (a half-iteration)",
                                  "lu_solve_device_ms": lu_ms}
        for mname, (k, kd, pl, b, by) in times.items():
            extra["smw_sweep"].update({
                f"ms_{mname}{key}": k, f"device_ms_{mname}{key}": kd,
                f"plain_ms_{mname}{key}": pl, f"bound_ms_{mname}{key}": b})
        del op5, lu_p, lu_q
    # D1 at mesh2000, on the operands screen_outages hands it.
    dcs = make_dc_solver(sys_, device=dev)
    ks = torch.as_tensor(chords(sys_, DC_OUTAGE_LANES), device=dev)
    theta0 = dcs.solve().theta
    lanes = DC_OUTAGE_LANES
    op_d = dc_operands(sys_, device=dev)
    lu = torch.linalg.lu_factor(decoupled_parts(sys_, device=dev)
                                .b_prime(None))
    z = torch.linalg.lu_solve(lu[0], lu[1], outage_columns(op_d, ks).mT)
    log(f"timing: dc_screen z [{n}, {lanes}] strides {tuple(z.stride())} "
        f"(lanes read contiguous: {z.stride(0) == 1})")
    fn = lambda: sck.dc_screen(theta0, z, ks, op_d)  # noqa: E731
    k, kd = time_ms(torch, fn, reps=50), device_ms(torch, fn, reps=20)
    pl = time_ms(torch, lambda: sck.dc_screen_plain(theta0, z, ks, op_d),
                 reps=10)
    b, by = bound(w * (2 * lanes * n + n + lanes * m + 3 * m + 2 * lanes)
                  + 8 * lanes, lanes * (2 * n + 3 * m + 12))
    rows["dc_screen"] = (k, pl, None, b, by)
    extra["dc_screen"] = {"device_ms": kd,
                          "shape": f"mesh2000 x{lanes} SCREEN"}
    log(f"timing: dc_screen  mesh2000 x{lanes} SCREEN kernel {k:.4f} ms "
        f"(device {kd:.4f})  plain {pl:.4f} ms  bound {b:.5f} ms ({by})")
    lanes = DC_INJECTION_LANES
    theta = dcs.solve(torch.as_tensor(np.random.default_rng(4).uniform(
        0.5, 1.5, (lanes, 1)) * sys_.p_inj, device=dev)).theta
    fn = lambda: sck.dc_flows(theta, op_d)  # noqa: E731
    k, kd = time_ms(torch, fn, reps=50), device_ms(torch, fn, reps=20)
    pl = time_ms(torch, lambda: sck.dc_flows_plain(theta, op_d), reps=10)
    b, by = bound(w * (lanes * n + lanes * m + 3 * m), 2 * lanes * m)
    extra["dc_screen"].update({"ms_SOLVE": k, "device_ms_SOLVE": kd,
                               "plain_ms_SOLVE": pl, "bound_ms_SOLVE": b,
                               "shape_SOLVE": f"mesh2000 x{lanes} SOLVE"})
    log(f"timing: dc_screen  mesh2000 x{lanes} SOLVE  kernel {k:.4f} ms "
        f"(device {kd:.4f})  plain {pl:.4f} ms  bound {b:.5f} ms ({by}); "
        f"theta strides {tuple(theta.stride())}")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 10: the N-1 and DC screens (solver level)
# ---------------------------------------------------------------------------


def screen_launches(torch, sk, sck, nk, fn, dev):
    """``fn()`` with every count at 0 before it; returns (result, wall
    ms, launches by kernel, S1's status launches, N1 and D1 by mode)."""
    for mod in (sk, sck, nk):
        mod.reset_launches()
    sync(torch, dev)
    t0 = time.monotonic()
    r = fn()
    sync(torch, dev)
    wall = (time.monotonic() - t0) * 1e3
    counts = {**sk.launches(), **nk.launches(), **sck.launches()}
    return r, wall, counts, sk.status_launches(), sck.mode_launches()


def n1_screens(torch, sk, sck, nk, dev="cuda"):
    """The screens through their entry points on the card: the sparse
    screen at mesh2000 × 256 chord outages (mixed and f64) against its
    plain-version screen, the SMW screen over case_ieee30's secure
    outages and mesh511 × 256 against its plain version, the DC solver at
    mesh2000 (4096 injection lanes, 1024 outage lanes) and dc_prefilter=8
    over 64 chord outages on the sparse screen; launches, walls and a
    profile of the mesh2000 screen.  Returns the launch counts of the DC
    runs (D1's main path at solver level)."""
    from freedm_tpu_torch.pf.dc import make_dc_solver
    from freedm_tpu_torch.pf.krylov import build_fdlf_precond
    from freedm_tpu_torch.pf.n1 import make_n1_screen, secure_outages

    on_card = torch.device(dev).type == "cuda"
    sys_ = case_system("mesh2000")
    ks = chords(sys_, N1_LANES)
    for prec in ("mixed", "f64"):
        # f64 on the float64 LU pair (kind="lu"): on the default bf16 pair
        # the inexact inner solve moves a warm-started lane's mismatch by
        # tens of percent between two roundings, and a lane whose step
        # starts near tol stops one step apart (2 of 256 lanes on an H100,
        # 8e-13 pu apart); mixed runs on the served default pair.
        pc = (build_fdlf_precond(sys_, kind="lu", device=dev)
              if prec == "f64" else None)
        t0 = time.monotonic()
        screen = make_n1_screen(sys_, max_iter=N1_MAX_ITER, backend="sparse",
                                precision=prec, device=dev, precond=pc)
        build = time.monotonic() - t0
        screen(ks)  # the first calls of these shapes
        r, wall, counts, st, _ = screen_launches(torch, sk, sck, nk,
                                                 lambda: screen(ks), dev)
        plain = make_n1_screen(sys_, max_iter=N1_MAX_ITER, backend="sparse",
                               precision=prec, device=dev, plain=True,
                               precond=pc)
        rp = plain(ks)
        its, itp = r.iterations.cpu().numpy(), rp.iterations.cpu().numpy()
        conv = r.converged.cpu().numpy()
        check(conv.all(), f"n1 sparse {prec}: lanes not converged: "
                          f"{np.flatnonzero(~conv)}")
        check(torch.equal(r.converged, rp.converged),
              f"n1 sparse {prec}: flags differ from the plain screen")
        dv = float((r.v - rp.v).abs().max())
        dth = float((r.theta - rp.theta).abs().max())
        apart = int(np.abs(its - itp).max())
        n_apart = int(np.sum(its != itp))
        fb, fbp = int(r.fallbacks.sum()), int(rp.fallbacks.sum())
        lanes3 = [0, N1_LANES // 2, N1_LANES - 1]
        d3 = max(float((r.v[lanes3] - rp.v[lanes3]).abs().max()),
                 float((r.theta[lanes3] - rp.theta[lanes3]).abs().max()))
        if prec == "f64":
            check(d3 <= SOLVE_ATOL and np.array_equal(its[lanes3],
                                                      itp[lanes3])
                  and apart <= 1 and torch.equal(r.fallbacks, rp.fallbacks),
                  f"n1 sparse f64 vs plain: {d3:.2e} pu on lanes {lanes3}, "
                  f"iterations {its[lanes3]} vs {itp[lanes3]} ({apart} "
                  f"apart at most), fallbacks {fb} vs {fbp}")
        else:
            check(apart <= 1 and torch.equal(r.fallbacks, rp.fallbacks),
                  f"n1 sparse mixed vs plain: iterations {apart} apart, "
                  f"fallbacks {fb} vs {fbp}")
        check(not on_card or (sum(st.values()) == counts["sparse_assemble"]
                              and counts["sparse_assemble"] > 0),
              f"n1 sparse {prec}: S1 ran without the lanes' status: {st}, "
              f"{counts}")
        log(f"n1 screens: sparse {prec:<5} "
            f"({'LU' if pc is not None else 'bf16'} pair) mesh2000 "
            f"x{N1_LANES} chord "
            f"outages: build {build:.2f} s, wall {wall:.1f} ms, iterations "
            f"{its.min()}-{its.max()} (plain {itp.min()}-{itp.max()}; "
            f"{n_apart} lanes one apart), fallbacks {fb} (plain {fbp}), vs "
            f"plain max "
            f"|dv| {dv:.2e} |dtheta| {dth:.2e} (3 lanes {d3:.2e}), v_min "
            f"{float(r.v.min()):.4f}; launches {counts}, S1 with status "
            f"{st}")
        if prec == "mixed":
            profile_solve(torch, lambda: screen(ks),
                          f"n1 sparse mixed mesh2000 x{N1_LANES}")
        del screen, plain, r, rp
        torch.cuda.empty_cache()
    for name, lanes in (("case_ieee30", None), ("mesh511", N1_LANES)):
        sys5 = case_system(name)
        sec = np.asarray(secure_outages(sys5), np.int64)
        ks5 = sec if lanes is None else np.resize(sec, lanes)
        t0 = time.monotonic()
        screen = make_n1_screen(sys5, max_iter=N1_MAX_ITER, device=dev)
        build = time.monotonic() - t0
        screen(ks5)  # the first calls of these shapes
        r, wall, counts, _, modes = screen_launches(torch, sk, sck, nk,
                                                    lambda: screen(ks5), dev)
        rp = make_n1_screen(sys5, max_iter=N1_MAX_ITER, device=dev,
                            plain=True)(ks5)
        d = max(float((getattr(r, k) - getattr(rp, k)).abs().max())
                for k in ("v", "theta", "p", "q"))
        check(d <= SOLVE_ATOL and torch.equal(r.converged, rp.converged)
              and bool(r.converged.all()),
              f"n1 SMW {name}: {d:.2e} pu from the plain screen, converged "
              f"{int(r.converged.sum())}/{len(ks5)}")
        check(not on_card or counts["smw_sweep"] == 2 + 2 * N1_MAX_ITER,
              f"n1 SMW {name}: {counts['smw_sweep']} N1 launches, want "
              f"{2 + 2 * N1_MAX_ITER}")
        ops, busy, pwall = profile_solve(
            torch, lambda: screen(ks5), f"n1 SMW {name} x{len(ks5)}", top=4)
        log(f"n1 screens: SMW {name} x{len(ks5)}: build {build:.2f} s, wall "
            f"{wall:.2f} ms, max mismatch {float(r.mismatch.max()):.2e}, vs "
            f"plain {d:.2e} pu; N1 launches {modes['smw_sweep']}, device "
            f"operations {ops} (2 + 4 x {N1_MAX_ITER} = "
            f"{2 + 4 * N1_MAX_ITER} calls: lu_solve's own kernels counted "
            f"apart)")
    dc = make_dc_solver(sys_, device=dev)
    dcp = make_dc_solver(sys_, device=dev, plain=True)
    pj = torch.as_tensor(np.random.default_rng(8).uniform(
        0.5, 1.5, (DC_INJECTION_LANES, 1)) * sys_.p_inj, device=dev)
    dc.solve(pj[:4])
    ko = chords(sys_, DC_OUTAGE_LANES)
    rs, w1, c1, _, _ = screen_launches(torch, sk, sck, nk,
                                       lambda: dc.solve(pj), dev)
    ro, w2, c2, _, _ = screen_launches(torch, sk, sck, nk,
                                       lambda: dc.screen_outages(ko), dev)
    es = float((rs.flows - dcp.solve(pj).flows).abs().max())
    po = dcp.screen_outages(ko)
    eo = max(float((ro.theta - po.theta).abs().max()),
             float((ro.flows - po.flows).abs().max()))
    check(es <= DC_ATOL and eo <= DC_ATOL
          and torch.equal(ro.islanded, po.islanded)
          and not bool(ro.islanded.any()),
          f"DC solver vs plain: injections {es:.2e}, outages {eo:.2e}")
    log(f"n1 screens: DC mesh2000 {DC_INJECTION_LANES} injection lanes "
        f"{w1:.2f} ms, {DC_OUTAGE_LANES} outage lanes {w2:.2f} ms (walls "
        f"with the lu_solves), vs plain {es:.1e} / {eo:.1e}, max severity "
        f"{float(ro.severity.max()):.3f} pu")
    ac = make_n1_screen(sys_, max_iter=N1_MAX_ITER, backend="sparse",
                        dc_prefilter=8, device=dev)
    acp = make_n1_screen(sys_, max_iter=N1_MAX_ITER, backend="sparse",
                         dc_prefilter=8, device=dev, plain=True)
    k64 = chords(sys_, 64, 500)
    out, w3, c3, _, _ = screen_launches(torch, sk, sck, nk,
                                        lambda: ac(k64), dev)
    outp = acp(k64)
    check(np.array_equal(out.outages, outp.outages)
          and bool(out.result.converged.all())
          and float(np.abs(out.dc_severity_all
                           - outp.dc_severity_all).max()) <= DC_ATOL,
          f"dc_prefilter: shortlist {out.outages} vs plain {outp.outages}")
    log(f"n1 screens: dc_prefilter=8 over 64 chord outages: {w3:.1f} ms, "
        f"shortlist {out.outages.tolist()} (the plain version's), AC lanes "
        f"converged, launches {c3}")
    return {k: c2.get(k, 0) + c3.get(k, 0) + c1.get(k, 0)
            for k in ("dc_screen",)}


# ---------------------------------------------------------------------------
# Phase 11: the served n1 workload
# ---------------------------------------------------------------------------

N1_BURST = 16


def post_n1(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.monotonic()
    conn.request("POST", "/v1/n1", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    lat = time.monotonic() - t0
    conn.close()
    return resp.status, data, lat


def serve_n1(torch, sk, sck, nk, dev="cuda", case="mesh2000"):
    """``POST /v1/n1`` on a server with the default config but
    ``max_batch=256`` (``N1Engine.MAX_OUTAGES``: a request of more lanes
    than ``max_batch`` is refused, as the reference refuses it):
    mesh2000 (the sparse screen, mixed) — one request of 64 outages, a
    burst of 16 concurrent requests of 1-16 outages, one of 256 — and
    case_ieee30 (the SMW screen) over all its secure outages, and an
    islanding outage refused with 400.  Every answer all_converged, with
    ``v_min_pu``/``v_max_pu`` within 1e-9 pu of the same outages through
    the direct screen.  Returns the launch counts over the served
    requests."""
    from freedm_tpu_torch.pf.n1 import make_n1_screen
    from freedm_tpu_torch.serve.http import ServeServer
    from freedm_tpu_torch.serve.service import ServeConfig, Service

    t0 = time.monotonic()
    svc = Service(ServeConfig(max_batch=N1_LANES, device=dev))
    eng = svc.engine("n1", case)
    build = time.monotonic() - t0
    t0 = time.monotonic()
    svc.prewarm((f"n1/{case}", "n1/case_ieee30"))
    prewarm = time.monotonic() - t0
    eng30 = svc.engine("n1", "case_ieee30")
    mixed = "mixed" if torch.device(dev).type == "cuda" else "f64"
    check(eng.pf_backend == "sparse" and eng.pf_precision == mixed
          and eng30.pf_backend == "dense",
          f"n1 engines: {case} {eng.pf_backend}/{eng.pf_precision}, "
          f"case_ieee30 {eng30.pf_backend}")
    log(f"serve n1: {case} engine build {build:.2f} s (secure_outages, "
        f"the base solve), prewarm of {len(svc.config.bucket_table())} "
        f"buckets x 2 cases {prewarm:.2f} s")
    server = ServeServer(svc).start()
    rng = np.random.default_rng(81)
    sys_ = case_system(case)
    sec = np.asarray(eng._secure)
    try:
        for mod in (sk, sck, nk):
            mod.reset_launches()
        runs = []
        one = chords(sys_, 64, 1000).tolist()
        runs.append(("64 outages", [one],
                     [post_n1(server.port, {"case": case,
                                            "outages": one})]))
        burst = [rng.choice(sec, size=int(rng.integers(1, 17)),
                            replace=False).tolist()
                 for _ in range(N1_BURST)]
        with cf.ThreadPoolExecutor(N1_BURST) as ex:
            out = list(ex.map(lambda ks: post_n1(
                server.port, {"case": case, "outages": ks}), burst))
        runs.append((f"burst of {N1_BURST}", burst, out))
        big = chords(sys_, N1_LANES, 1200).tolist()
        runs.append((f"{N1_LANES} outages", [big],
                     [post_n1(server.port, {"case": case,
                                            "outages": big})]))
        s30 = list(eng30._secure)
        runs.append(("case_ieee30 all secure", [s30],
                     [post_n1(server.port, {"case": "case_ieee30",
                                            "outages": s30})]))
        counts = {**sk.launches(), **nk.launches(), **sck.launches()}
        st = sk.status_launches()
        bridge = sorted(set(range(eng30.n_branch)) - set(s30))[0]
        status, data, _ = post_n1(server.port, {"case": "case_ieee30",
                                                "outages": [bridge]})
        check(status == 400 and "island" in data["error"]["detail"],
              f"islanding outage {bridge}: HTTP {status} {data}")
        direct = {case: make_n1_screen(
            sys_, max_iter=N1_MAX_ITER, backend="auto", device=dev),
            "case_ieee30": make_n1_screen(
                case_system("case_ieee30"), max_iter=N1_MAX_ITER,
                backend="auto", device=dev)}
        worst_pu = 0.0
        for label, reqs, outs in runs:
            name = "case_ieee30" if label.startswith("case") else case
            lat = []
            for ks, (status, body, sec_) in zip(reqs, outs):
                check(status == 200 and body["all_converged"],
                      f"serve n1 {label}: HTTP {status}: "
                      f"{str(body)[:300]}")
                check(body["outages"] == list(ks),
                      f"serve n1 {label}: outages echoed {body['outages']}")
                r = direct[name](ks)
                for k, red in (("v_min_pu", r.v.min(dim=1).values),
                               ("v_max_pu", r.v.max(dim=1).values)):
                    worst_pu = max(worst_pu, float(np.abs(
                        np.asarray(body[k]) - red.cpu().numpy()).max()))
                lat.append(sec_ * 1e3)
            lanes = [o[1]["batch"]["lanes"] for o in outs]
            buckets = [o[1]["batch"]["bucket"] for o in outs]
            solve = [o[1]["batch"]["solve_ms"] for o in outs]
            log(f"serve n1: {name} {label}: {len(outs)} requests, latency "
                f"p50 {np.percentile(lat, 50):.1f} ms p99 "
                f"{np.percentile(lat, 99):.1f} ms, lanes a batch "
                f"{min(lanes)}-{max(lanes)} (buckets {sorted(set(buckets))})"
                f", solve_ms {min(solve):.1f}-{max(solve):.1f}, v_min "
                f"{min(min(o[1]['v_min_pu']) for o in outs):.4f}")
        check(worst_pu <= SOLVE_ATOL,
              f"serve n1: answers {worst_pu:.2e} pu from the direct screen")
        log(f"serve n1: every answer all_converged, max |v_min/v_max - "
            f"direct screen| {worst_pu:.2e} pu; islanding outage {bridge} "
            f"refused (400); launches {counts}, S1 with status {st}")
        on_card = torch.device(dev).type == "cuda"
        # K3 runs on the mixed path only in its full-precision phase.
        check(not on_card or all(counts[k] > 0 for k in (
            "sparse_assemble", "sparse_matvec", "gmres_block_orth",
            "gmres_lstsq", "smw_sweep")),
              f"a kernel of the n1 path was not launched: {counts}")
        check(sum(st.values()) == counts["sparse_assemble"],
              f"S1 ran without status on the n1 path: {st}")
        return counts, st
    finally:
        server.stop()
        svc.stop()


# ---------------------------------------------------------------------------
# Phases 12-14: the ladder kernels (L1, L2), the VVC controller, serve vvc
# ---------------------------------------------------------------------------

LADDER_LANES = (1, 8, MAIN_LANES)
#: f64: the sums run in another order than the plain version's (1e-14
#: seen); f32: a 10k-bus feeder's prefix sums lose relative precision.
LADDER_ATOL = {"float64": 1e-10, "float32": 1e-4}
#: The ladder's convergence threshold (``make_ladder_solver``'s eps).
LADDER_EPS = 1e-4
#: float32 flags: a lane whose residual lies within this many float32
#: ulps of its largest root current from eps converges or not by rounding
#: (the residual is the change of a root current that sums nb rounded
#: terms a sweep), so its flag is printed, not gated.
F32_FLAG_ULPS = 64
GRAD_RTOL = 1e-8
GRAD_ATOL = 1e-10
FD_REL = 1e-4
VVC_ATOL = 1e-9
VVC_ROUNDS = 120
VVC_BURST = 64
#: Operations a branch and iteration: L1 (the complex division of the
#: load currents ~30, the two prefixes ~24 with their y and group sums,
#: the branch currents and root error ~21, the 3 × 3 complex drop 72, the
#: voltage update 12) and L2 (the masked prefix ~18, the adjoint drop 72,
#: the path prefix ~18, the two complex divisions of the load-current
#: derivative ~96).
L1_OPS = 171
L2_OPS = 210


def ladder_feeders():
    """The phase's feeders: (name, feeder, load factor, max_iter)."""
    from pathlib import Path

    from freedm_tpu_torch.grid import cases, feeder

    dl = Path(__file__).resolve().parent / "tests" / "data" / "Dl_new.mat"
    return (("vvc_9bus", cases.vvc_9bus(), 1.0, 20),
            ("Dl_new", feeder.load_dl_mat(str(dl)), 0.5, 60),
            ("radial512", cases.synthetic_radial(512, seed=0), 1.0, 20),
            ("radial10k", cases.synthetic_radial(10000, seed=0, load_kw=1.0),
             1.0, 20))


def lane_loads(f, lanes, factor=1.0):
    """``lanes`` load lanes: the feeder's loads times scales uniform in
    0.7-1.3 from ``default_rng(0)`` (the reference's ``bench.py``)."""
    scale = np.random.default_rng(0).uniform(0.7, 1.3, (lanes, 1, 1))
    return factor * scale * f.s_load[None]


def ladder_same_bits(torch, a, b):
    return all(torch.equal(getattr(a, k).re, getattr(b, k).re)
               and torch.equal(getattr(a, k).im, getattr(b, k).im)
               for k in ("v_node", "i_branch", "i_load"))


def lane_gaps(torch, a, b):
    """Per lane, the largest |a - b| over v_node, i_branch and i_load."""
    out = None
    for k in ("v_node", "i_branch", "i_load"):
        for part in ("re", "im"):
            d = (getattr(getattr(a, k), part) - getattr(getattr(b, k), part))
            d = d.abs().flatten(1).amax(dim=1)
            out = d if out is None else torch.maximum(out, d)
    return out


def compare_ladder(torch, errs):
    """L1 against its plain version on the card: every feeder of
    :func:`ladder_feeders` × B ∈ {1, 8, 64} × {solve, solve_fixed} ×
    {float64, float32} through ``make_ladder_solver`` and its
    ``plain=True`` twin, and bit-identical on repeat.  Lanes the plain
    version finds converged are held to ``LADDER_ATOL``; a lane in
    voltage collapse (radial512 at 1.1-1.3 × load: the ladder diverges
    there, as the reference's does) is held to equal flags and
    iterations, its gap printed — its iteration is no contraction, and
    two float64 summation orders part exponentially on it (on the CPU
    L1's plain sweeps and the doubling sweeps: 8e-15 after one
    iteration, 7.6e-11 after 20) — and every lane's iteration map is held
    to ``LADDER_ATOL`` by a one-iteration fixed solve.  In float32 a
    lane's flag is gated unless its residual lies within
    ``F32_FLAG_ULPS`` of eps."""
    from freedm_tpu_torch.pf.ladder import make_ladder_solver

    worst = {"float64": 0.0, "float32": 0.0}
    for name, f, factor, max_iter in ladder_feeders():
        for dtype in (torch.float64, torch.float32):
            dn = str(dtype).split(".")[-1]
            tol = LADDER_ATOL[dn]
            kern = make_ladder_solver(f, max_iter=max_iter, dtype=dtype,
                                      device="cuda")
            plain = make_ladder_solver(f, max_iter=max_iter, dtype=dtype,
                                       device="cuda", plain=True)
            its, diverged, div_gap, near, flipped = set(), 0, 0.0, 0, 0
            root = torch.as_tensor(f.parent < 0, device="cuda")
            for lanes in LADDER_LANES:
                loads = lane_loads(f, lanes, factor)
                for mode, label in ((0, "solve"), (1, "solve_fixed")):
                    a, a2 = kern[mode](loads), kern[mode](loads)
                    p = plain[mode](loads)
                    torch.cuda.synchronize()
                    gaps = lane_gaps(torch, a, p)
                    where = f"ladder {name} {dn} x{lanes} {label}"
                    clear = torch.ones_like(p.converged)
                    if dn == "float32":
                        i_root = p.i_branch.abs()[:, root].flatten(1).amax(1)
                        band = F32_FLAG_ULPS * torch.finfo(dtype).eps * i_root
                        clear = (p.residual - LADDER_EPS).abs() > band
                        near += int((~clear).sum())
                        flipped += int((a.converged != p.converged).sum())
                    check(torch.equal(a.converged[clear],
                                      p.converged[clear]),
                          f"{where}: converged flags differ")
                    conv = p.converged & a.converged
                    err = float(gaps[conv].max()) if bool(conv.any()) else 0.0
                    check(err <= tol, f"{where}: {err:.3e} from the plain "
                          f"version on a converged lane")
                    check(dn == "float32"
                          or torch.equal(a.iterations, p.iterations),
                          f"{where}: iterations {a.iterations.tolist()} vs "
                          f"{p.iterations.tolist()}")
                    check(ladder_same_bits(torch, a, a2),
                          f"{where}: not bit-identical on repeat")
                    worst[dn] = max(worst[dn], err)
                    its.update(a.iterations.tolist())
                    if not bool(conv.all()):
                        diverged += int((~conv).sum())
                        div_gap = max(div_gap, float(gaps[~conv].max()))
            loads = lane_loads(f, LADDER_LANES[-1], factor)
            one = [make_ladder_solver(f, max_iter=1, dtype=dtype,
                                      device="cuda", plain=pl)[1](loads)
                   for pl in (False, True)]
            torch.cuda.synchronize()
            err1 = float(lane_gaps(torch, *one).max())
            check(err1 <= tol, f"ladder {name} {dn}: one iteration "
                  f"{err1:.3e} from the plain version")
            worst[dn] = max(worst[dn], err1)
            log(f"ladder kernels: {name:<9} (nb {f.n_branches}) {dn} B "
                f"{LADDER_LANES} solve/fixed: iterations {min(its)}-"
                f"{max(its)}, flags equal, bit-identical on repeat; one "
                f"iteration x{LADDER_LANES[-1]} {err1:.2e}"
                + (f"; {diverged} lane solves not converged (voltage collapse), "
                   f"their gap {div_gap:.2e}, not gated" if diverged else "")
                + (f"; {near} lane solves within {F32_FLAG_ULPS} ulps of eps "
                   f"(flags not gated, {flipped} differ)" if near else ""))
    errs["ladder_solve"] = worst["float64"]
    log(f"ladder kernels: L1 max |kernel - plain| f64 {worst['float64']:.3e}"
        f" pu (limit 1e-10), f32 {worst['float32']:.3e} (limit 1e-4)")
    return worst


def compare_ladder_vjp(torch, errs):
    """L2 (through ``LadderFixed``) against ``torch.autograd.grad`` of
    the plain fixed solve, for the total loss in Q, on vvc_9bus and the
    10k feeder × {1, 64}; then a central difference on three live
    coordinates at 10k × 1."""
    from freedm_tpu_torch.pf.ladder import make_ladder_solver, total_loss_kw

    feeders = {n: f for n, f, _, _ in ladder_feeders()}
    worst = 0.0
    dev = torch.device("cuda")
    for name in ("vvc_9bus", "radial10k"):
        f = feeders[name]
        for lanes in (1, MAIN_LANES):
            loads = lane_loads(f, lanes)
            p = torch.tensor(loads.real, dtype=torch.float64, device=dev)
            grads = []
            for plain in (False, True):
                _, fixed = make_ladder_solver(f, device=dev, plain=plain)
                q = torch.tensor(loads.imag, dtype=torch.float64, device=dev,
                                 requires_grad=True)
                loss = total_loss_kw(f, fixed((p, q))).sum()
                grads.append(torch.autograd.grad(loss, q)[0])
            torch.cuda.synchronize()
            g, want = grads
            check(bool(torch.isfinite(g).all()), f"L2 {name}: non-finite")
            excess = float(((g - want).abs() - GRAD_RTOL * want.abs()).max())
            check(excess <= GRAD_ATOL,
                  f"L2 {name} x{lanes}: |g - autograd| beyond rtol 1e-8 by "
                  f"{excess:.3e} (atol 1e-10)")
            gap = max_err(g, want)
            worst = max(worst, gap)
            log(f"ladder vjp: {name} x{lanes}: max |L2 - autograd of the "
                f"plain fixed solve| {gap:.3e} (max |g| "
                f"{float(want.abs().max()):.3e})")
    f = feeders["radial10k"]
    _, fixed = make_ladder_solver(f, device=dev)
    p = torch.tensor(f.s_load.real, dtype=torch.float64, device=dev)
    q0 = torch.tensor(f.s_load.imag, dtype=torch.float64, device=dev)

    def loss(q):
        return float(total_loss_kw(f, fixed((p, q))))

    qg = q0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(total_loss_kw(f, fixed((p, qg))), qg)
    h = 1e-3
    for idx in ((0, 0), (f.n_branches // 2, 1), (f.n_branches - 1, 2)):
        e = torch.zeros_like(q0)
        e[idx] = h
        fd = (loss(q0 + e) - loss(q0 - e)) / (2 * h)
        rel = abs(fd - float(g[idx])) / max(abs(fd), 1e-30)
        check(rel <= FD_REL, f"L2 radial10k x1 {idx}: gradient "
              f"{float(g[idx]):.6e} vs central difference {fd:.6e}")
        log(f"ladder vjp: radial10k x1 dloss/dq{idx} = {float(g[idx]):.9e}, "
            f"central difference {fd:.9e} (rel {rel:.2e})")
    errs["ladder_vjp"] = worst


def ladder_device_ms(torch, fn, reps, log_key):
    """Device time of one call of ``fn``: the profiler's kernel rows
    (:func:`device_ms`), or, where a trace holds no device events for the
    ladder kernels, CUDA events around each call with the device idle
    before it (the launch gap counted in: a few µs).  Returns (ms,
    source)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and getattr(e, "self_device_time_total", 0) > 0]
    if rows:
        return sum(e.self_device_time_total for e in rows) / 1e3 / reps, \
            "profiler"
    top = sorted(prof.key_averages(), key=lambda e: -e.cpu_time_total)
    n_dev = sum(1 for e in prof.events()
                if str(getattr(e, "device_type", "")).endswith("CUDA"))
    log(f"timing: {log_key}: the trace holds no device time "
        f"({len(prof.events())} events, {n_dev} on the device; top CPU rows "
        + ", ".join(f"{e.key} {getattr(e, 'device_type', '')}"
                    for e in top[:4]) + "); CUDA events per call")
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts)), "events per call"



def preorder_inputs(torch, lk, f, lanes, dtype):
    """L1's raw operands for ``lanes`` load lanes of feeder ``f``."""
    from freedm_tpu_torch.cplx import C
    from freedm_tpu_torch.pf.ladder import SOURCE_UNIT

    dev = torch.device("cuda")
    work, perm = f.reorder_preorder()
    op = lk.ladder_operands(work, dtype, dev)
    s = lane_loads(f, lanes)[:, perm] / f.s_base_per_phase_kva
    u = SOURCE_UNIT * f.v_source_pu

    def t(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    return (C(t(s.real), t(s.imag)),
            C(t(np.tile(u.real, (lanes, 1))), t(np.tile(u.imag, (lanes, 1)))),
            op)


def ladder_bytes(op, lanes, w, iters, save):
    """L1's inputs read once and outputs written once (the saved iterates
    too, when asked)."""
    nb = op.nb
    tree = w * (3 * nb + 18 * nb + nb) + 4 * (2 * nb + 1
                                              + int(op.grp_idx.shape[0]))
    out = w * 18 * lanes * nb + (4 + w + 1) * lanes
    return (w * (6 * lanes * nb + 6 * lanes) + tree + out
            + (w * 6 * lanes * nb * iters if save else 0))


def time_ladder(torch, lk, rows, extra):
    """L1 and L2 at the VVC shapes, CUDA events and device time, beside
    the plain versions and the bounds: the 10k feeder × 64 (the table's
    row) and × 1 lanes, 20 fixed iterations, float64 (and float32 for
    L1), and L1 on the served vvc_9bus × 64.  Device time by
    :func:`ladder_device_ms`, its source recorded."""
    feeders = {n: f for n, f, _, _ in ladder_feeders()}
    eps, iters = LADDER_EPS, 20
    for name, lanes, dtype in (("radial10k", MAIN_LANES, torch.float64),
                               ("radial10k", 1, torch.float64),
                               ("radial10k", MAIN_LANES, torch.float32),
                               ("vvc_9bus", MAIN_LANES, torch.float64)):
        f = feeders[name]
        s, v0, op = preorder_inputs(torch, lk, f, lanes, dtype)
        nb, w = op.nb, (8 if dtype == torch.float64 else 4)
        fp64 = dtype == torch.float64
        fixed = lambda: lk.ladder_solve(s, v0, op, eps, iters, True)  # noqa: E731
        saving = lambda: lk.ladder_solve(s, v0, op, eps, iters, True,  # noqa: E731
                                         save=True)
        solving = lambda: lk.ladder_solve(s, v0, op, eps, iters, False)  # noqa: E731
        tag = f"{name} x{lanes} {str(dtype).split('.')[-1]}"
        k = time_ms(torch, fixed, reps=10)
        kd, src = ladder_device_ms(torch, fixed, 5, f"L1 fixed {tag}")
        k_save = time_ms(torch, saving, reps=5)
        kd_save, src_save = ladder_device_ms(torch, saving, 5,
                                             f"L1 fixed+save {tag}")
        k_solve = time_ms(torch, solving, reps=10)
        kd_solve, src_solve = ladder_device_ms(torch, solving, 5,
                                               f"L1 solve {tag}")
        pl = time_ms(torch, lambda: lk.ladder_solve_plain(
            s, v0, op, eps, iters, True), reps=2)
        b, by = bound(ladder_bytes(op, lanes, w, iters, False),
                      L1_OPS * nb * lanes * iters, fp64)
        sv = saving()
        n_it = int(solving().iterations.sum())
        key = f"{name}_x{lanes}_{str(dtype).split('.')[-1]}"
        row = {"ms": k, "device_ms": kd, "plain_ms": pl, "bound_ms": b,
               "bound_by": by, "device_ms_per_iteration": kd / iters,
               "device_ms_source": src, "ms_save": k_save,
               "device_ms_save": kd_save, "device_ms_source_save": src_save,
               "ms_solve": k_solve, "device_ms_solve": kd_solve,
               "device_ms_source_solve": src_solve,
               "solve_iterations": n_it}
        log(f"timing: ladder_solve {tag} fixed x{iters}: kernel {k:.4f} ms "
            f"(device {kd:.4f} [{src}], {kd / iters:.5f} an iteration); "
            f"saving iterates {k_save:.4f} (device {kd_save:.4f} "
            f"[{src_save}]); solve mode {k_solve:.4f} (device "
            f"{kd_solve:.4f} [{src_solve}]) for {n_it} lane-iterations; "
            f"plain {pl:.4f} ms  bound {b:.5f} ms ({by})")
        if name == "radial10k" and lanes == MAIN_LANES and fp64:
            rows["ladder_solve"] = (k, pl, None, b, by)
            extra["ladder_solve"] = {"device_ms": kd, "shape": (
                f"synthetic_radial(10000) x{lanes} f64, solve_fixed, "
                f"{iters} iterations"), **{k_: v for k_, v in row.items()
                                           if k_ not in ("ms", "plain_ms",
                                                         "bound_ms",
                                                         "bound_by")}}
        else:
            extra["ladder_solve"].setdefault("shapes", {})[key] = row
        if not fp64:
            continue
        rng = np.random.default_rng(5)
        from freedm_tpu_torch.cplx import C

        gs = [C(torch.tensor(rng.normal(size=(lanes, nb, 3)), dtype=dtype,
                             device="cuda"),
                torch.tensor(rng.normal(size=(lanes, nb, 3)), dtype=dtype,
                             device="cuda")) for _ in range(3)]
        vjp = lambda: lk.ladder_vjp(sv.saved, s, op, *gs)  # noqa: E731
        k2 = time_ms(torch, vjp, reps=10)
        kd2, src2 = ladder_device_ms(torch, vjp, 5, f"L2 {tag}")
        pl2 = time_ms(torch, lambda: lk.ladder_vjp_plain(sv.saved, s, op,
                                                         *gs), reps=1)
        tree = w * (3 * nb + 18 * nb) + 4 * (2 * nb + 1
                                             + int(op.grp_idx.shape[0]))
        b2, by2 = bound(w * 6 * lanes * nb * iters + w * 6 * lanes * nb * 4
                        + tree, L2_OPS * nb * lanes * iters)
        log(f"timing: ladder_vjp   {tag} {iters} iterates: kernel {k2:.4f} ms "
            f"(device {kd2:.4f} [{src2}], {kd2 / iters:.5f} an iteration)  "
            f"plain {pl2:.4f} ms  bound {b2:.5f} ms ({by2})")
        if name == "radial10k" and lanes == MAIN_LANES:
            rows["ladder_vjp"] = (k2, pl2, None, b2, by2)
            extra["ladder_vjp"] = {
                "device_ms": kd2, "device_ms_per_iteration": kd2 / iters,
                "device_ms_source": src2,
                "shape": f"synthetic_radial(10000) x{lanes} f64, {iters} "
                         f"saved iterates"}
        else:
            extra["ladder_vjp"].update({f"ms_{key}": k2,
                                        f"device_ms_{key}": kd2,
                                        f"device_ms_source_{key}": src2,
                                        f"plain_ms_{key}": pl2,
                                        f"bound_ms_{key}": b2})
        del sv, gs
    torch.cuda.empty_cache()


def vvc_phase(torch, lk):
    """The controller through its entry points on the card: one step on
    vvc_9bus from zero q at loads P·(1 + 0.6j) against the plain step,
    120 rounds, one step on the 10k feeder × 64 lanes against the plain
    step.  Counts reset before each and read after; L2 launches once a
    step.  Returns the counts of the 10k step."""
    from freedm_tpu_torch.grid import cases
    from freedm_tpu_torch.modules import vvc

    f = cases.vvc_9bus()
    s = f.s_load.real * (1 + 0.6j)
    q0 = np.zeros((f.n_branches, 3))
    step = vvc.make_vvc_controller(f, device="cuda")
    plain = vvc.make_vvc_controller(f, device="cuda", plain=True)
    step(s, q0)  # warm-up: the timed step below is a steady one
    lk.reset_launches()
    t0 = time.monotonic()
    out = step(s, q0)
    torch.cuda.synchronize()
    wall = (time.monotonic() - t0) * 1e3
    counts = lk.launches()
    want = plain(s, q0)
    gap = 0.0
    for k in vvc.VVCStep._fields:
        a, b = getattr(out, k), getattr(want, k)
        if a.dtype == torch.bool:
            check(torch.equal(a, b), f"vvc 9bus step: {k} differs")
        else:
            gap = max(gap, max_err(a, b))
    check(gap <= VVC_ATOL, f"vvc 9bus step: {gap:.3e} from the plain step")
    check(bool(out.improved) and float(out.loss_after_kw)
          < float(out.loss_before_kw), f"vvc 9bus step did not improve: {out}")
    check(counts["ladder_vjp"] == 1 and counts["ladder_solve"] >= 2,
          f"vvc 9bus step launches {counts}")
    log(f"vvc: 9bus step {float(out.loss_before_kw):.6f} -> "
        f"{float(out.loss_after_kw):.6f} kW, alpha {float(out.alpha):g}, "
        f"{wall:.2f} ms wall, launches {counts}, max |kernel - plain step| "
        f"{gap:.3e}")
    lk.reset_launches()
    t0 = time.monotonic()
    qf, losses, alphas, improved = vvc.run_rounds(step, s, q0, VVC_ROUNDS)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = lk.launches()
    ls = losses.cpu().numpy()
    check(bool(np.all(np.diff(ls) <= 1e-12)), "vvc rounds: loss increased")
    check(ls[-1] < 0.92 * float(out.loss_before_kw),
          f"vvc rounds: {ls[-1]:.6f} kW not below 0.92 x base "
          f"{float(out.loss_before_kw):.6f}")
    check(counts["ladder_vjp"] == VVC_ROUNDS,
          f"vvc rounds: L2 launched {counts['ladder_vjp']} times")
    log(f"vvc: {VVC_ROUNDS} rounds {ls[0]:.6f} -> {ls[-1]:.6f} kW "
        f"({ls[-1] / float(out.loss_before_kw):.4f} of the base), "
        f"{int(improved.sum())} improved, {wall:.2f} s "
        f"({wall / VVC_ROUNDS * 1e3:.2f} ms a round), launches {counts}")
    f10 = cases.synthetic_radial(10000, seed=0, load_kw=1.0)
    loads = lane_loads(f10, MAIN_LANES)
    q10 = np.zeros((f10.n_branches, 3))
    step10 = vvc.make_vvc_controller(f10, device="cuda")
    plain10 = vvc.make_vvc_controller(f10, device="cuda", plain=True)
    step10(loads, q10)
    lk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    got = step10(loads, q10)
    torch.cuda.synchronize()
    wall = (time.monotonic() - t0) * 1e3
    counts = lk.launches()
    t0 = time.monotonic()
    want = plain10(loads, q10)
    torch.cuda.synchronize()
    plain_wall = (time.monotonic() - t0) * 1e3
    check(torch.equal(got.alpha, want.alpha)
          and torch.equal(got.improved, want.improved),
          f"vvc 10k x64: alphas {got.alpha.tolist()} vs "
          f"{want.alpha.tolist()}")
    rel = max(float(((getattr(got, k) - getattr(want, k)).abs()
                     / getattr(want, k).abs().clamp_min(1.0)).max())
              for k in ("loss_before_kw", "loss_after_kw"))
    check(rel <= VVC_ATOL, f"vvc 10k x64: losses {rel:.3e} from the plain "
          f"step's")
    check(counts["ladder_vjp"] == 1, f"vvc 10k x64 launches {counts}")
    log(f"vvc: 10k x{MAIN_LANES} step: {wall:.2f} ms wall (plain step "
        f"{plain_wall:.1f} ms), alphas {sorted(set(got.alpha.tolist()))}, "
        f"{int(got.improved.sum())} of {MAIN_LANES} improved, losses "
        f"{float(got.loss_before_kw.mean()):.4f} -> "
        f"{float(got.loss_after_kw.mean()):.4f} kW a lane, max relative "
        f"|kernel - plain| of the losses {rel:.3e}, launches {counts}")
    return counts


def post_vvc(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.monotonic()
    conn.request("POST", "/v1/vvc", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    lat = time.monotonic() - t0
    conn.close()
    return resp.status, data, lat


def serve_vvc(torch, lk):
    """``POST /v1/vvc`` on the default config: 64 concurrent what-ifs to
    vvc_9bus, random q in ±50 kvar on live phases (seed 9), each answer
    200 and converged, its loss and voltage extremes within 1e-9 of a
    direct ``solve_fixed``.  Returns the launch counts over the burst."""
    from freedm_tpu_torch.pf.ladder import make_ladder_solver, total_loss_kw
    from freedm_tpu_torch.serve.http import ServeServer
    from freedm_tpu_torch.serve.service import ServeConfig, Service

    svc = Service(ServeConfig(device="cuda"))
    server = ServeServer(svc).start()
    try:
        eng = svc.engine("vvc", "vvc_9bus")
        f = eng._feeder
        mask = f.phase_mask
        rng = np.random.default_rng(9)
        qs = [rng.uniform(-50.0, 50.0, (f.n_branches, 3)) * mask
              for _ in range(VVC_BURST)]
        status, data, _ = post_vvc(server.port, {
            "case": "vvc_9bus", "q_ctrl_kvar": qs[0].tolist()})
        check(status == 200, f"serve vvc warm-up: HTTP {status} {data}")
        lk.reset_launches()
        t0 = time.monotonic()
        with cf.ThreadPoolExecutor(VVC_BURST) as ex:
            out = list(ex.map(lambda q: post_vvc(server.port, {
                "case": "vvc_9bus", "q_ctrl_kvar": q.tolist()}), qs))
        wall = time.monotonic() - t0
        counts = lk.launches()
        _, fixed = make_ladder_solver(f, max_iter=20, device="cuda")
        s = np.stack([f.s_load.real + 1j * (f.s_load.imag - q) for q in qs])
        res = fixed(s)
        loss = total_loss_kw(f, res).cpu().numpy()
        live = np.concatenate([np.ones((1, 3)), mask]) > 0
        vm = res.v_node.abs().cpu().numpy()[:, live]
        worst = 0.0
        for i, (status, body, _) in enumerate(out):
            check(status == 200 and body["converged"],
                  f"serve vvc: HTTP {status}: {str(body)[:300]}")
            worst = max(worst, abs(body["loss_kw"] - loss[i]),
                        abs(body["v_min_pu"] - vm[i].min()),
                        abs(body["v_max_pu"] - vm[i].max()))
        check(worst <= VVC_ATOL,
              f"serve vvc: answers {worst:.3e} from the direct solve")
        lat = np.array([x for _, _, x in out]) * 1e3
        lanes = [b["batch"]["lanes"] for _, b, _ in out]
        log(f"serve vvc: {VVC_BURST} concurrent requests {VVC_BURST / wall:.1f}"
            f" what-ifs/s  p50 {np.percentile(lat, 50):.1f} ms  p99 "
            f"{np.percentile(lat, 99):.1f} ms  lanes a batch "
            f"{min(lanes)}-{max(lanes)}, max |answer - direct solve_fixed| "
            f"{worst:.3e}, launches {counts}")
        check(counts["ladder_solve"] > 0,
              f"L1 was not launched on the vvc path: {counts}")
        return counts
    finally:
        server.stop()
        svc.stop()


# ---------------------------------------------------------------------------
# Phases 15-17: QSTS — A1 agent_step, Q1 qsts_bus_reduce, Q2
# qsts_feeder_reduce, the studies through run_study, the jobs API
# ---------------------------------------------------------------------------

#: The reference's bench_agents population (bench.py:1192).
BENCH_AGENTS = dict(ev=400_000, thermostat=300_000, inverter=150_000,
                    dr=150_000)
SMALL_AGENTS = dict(ev=12, thermostat=10, inverter=8, dr=6)
SMALL_P0 = np.array([-1.0, -0.5, 0.0, -2.0, -0.3, 0.2])
AGENT_HOURS = (0.0, 7.5, 15.0, 19.0, 23.75)
#: A1 against its plain version: the state within 1e-13 of the largest
#: value of its array (the kernel repeats the plain version's operations
#: without contraction; libm's exp and cos on the card are shared), the
#: per-bus and served sums within 1e-12 (the served load is a tree over
#: buses in the kernel, torch.sum in the plain version).
A1_STATE_RTOL = 1e-13
QSTS_SUM_RTOL = 1e-12
QSTS_ATOL = 1e-9  # kernel-path study vs plain=True (f64)
QSTS_MIXED_ATOL = 2e-4  # the same on the mixed sparse solver
#: The residential day of mesh2000 (seed 5) is solvable through the first
#: 40 steps (10:00); after that some lanes diverge at the midday PV peak,
#: in the JAX package as in the port (CPU runs of both, 4 lanes: 7
#: non-converged lane-steps by step 48).
MIDDAY_STEP = 40
#: Operations an agent and step (exp and cos counted as 20 each), a
#: branch end of Q1 (sin, cos, two complex products, |.|), a branch
#: phase of Q2 (three complex products, |.|): rough counts for the bounds.
A1_OPS = 40
Q1_OPS = 60
Q2_OPS = 40


def rel_err(a, b):
    """max |a - b| over max |b| (the plain version's scale)."""
    d = float((a - b).abs().max()) if a.numel() else 0.0
    s = float(b.abs().max()) if b.numel() else 0.0
    return d / s if s > 0 else d


def agent_world(torch, qk, kw, case, lanes, seed=11):
    """A1's operands and a varied sorted-order state for ``kw`` agents on
    ``case`` (None: the 6-bus world) × ``lanes``, with the solved |V| of
    one step (the 6-bus world: random |V|)."""
    from freedm_tpu_torch.pf.newton import make_newton_solver
    from freedm_tpu_torch.scenarios import agents
    from freedm_tpu_torch.scenarios.profiles import ProfileSet, ProfileSpec
    from freedm_tpu_torch.serve.service import _resolve_bus_case

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    if case is None:
        n, p0 = 6, SMALL_P0
        obs = torch.tensor(rng.uniform(0.86, 1.1, (lanes, n)), device=dev)
    else:
        sys_ = _resolve_bus_case(case)
        n, p0 = sys_.n_bus, np.asarray(sys_.p_inj)
        solve, _ = make_newton_solver(sys_, device=dev)
        scale = rng.uniform(0.8, 1.2, (lanes, 1))
        r = solve(p_inj=scale * sys_.p_inj, q_inj=scale * sys_.q_inj)
        check(bool(r.converged.all()), f"agent world {case}: not converged")
        obs = r.v.contiguous()
    prof = ProfileSet(ProfileSpec(scenarios=lanes, steps=96, seed=seed), n)
    pop, st0, _ = agents.build_population(agents.AgentSpec(**kw), prof, p0)
    op = qk.agent_operands(pop, n, dev)
    st = st0._asdict()
    st["th_on"] = rng.integers(0, 2, st["th_on"].shape).astype(np.float64)
    st["th_temp"] = st["th_temp"] + rng.normal(0.0, 1.5, st["th_temp"].shape)
    st["inv_q"] = rng.uniform(-0.02, 0.02, st["inv_q"].shape)
    st["dr_eng"] = rng.uniform(0.0, 1.0, st["dr_eng"].shape)
    return op, st, n, obs


def a1_call(torch, qk, fn, op, st, lanes, n, obs, sig, h):
    dev = torch.device("cuda")
    state = op.to_sorted(st, lanes)
    zero = torch.zeros(lanes, n, dtype=torch.float64, device=dev)
    out = [torch.empty_like(zero), torch.empty_like(zero)]
    acc = [torch.full((lanes,), 0.5, dtype=torch.float64, device=dev),
           torch.zeros(lanes, dtype=torch.float64, device=dev),
           torch.empty(lanes, dtype=torch.float64, device=dev)]
    fn(op, state, obs, sig, h, 0.25, zero, zero, *out, *acc)
    return state, out, acc


def compare_a1(torch, qk, errs):
    """A1 against its plain version: the 6-bus world × 2 and the
    million-agent population on case_ieee30 × {1, 4}; observations flat
    and solved; hours 0, 7.5, 15, 19, 23.75; the DR signal 0 and 1."""
    worst = {"state": 0.0, "sums": 0.0}
    for kw, case, lanes in ((SMALL_AGENTS, None, 2),
                            (BENCH_AGENTS, "case_ieee30", 1),
                            (BENCH_AGENTS, "case_ieee30", 4)):
        op, st, n, solved = agent_world(torch, qk, kw, case, lanes)
        for obs in (None, solved):
            for h in AGENT_HOURS:
                for sv in (0.0, 1.0):
                    sig = torch.full((lanes,), sv, dtype=torch.float64,
                                     device="cuda")
                    k = a1_call(torch, qk, qk.agent_step, op, st, lanes, n,
                                obs, sig, h)
                    p = a1_call(torch, qk, qk.agent_step_plain, op, st,
                                lanes, n, obs, sig, h)
                    again = a1_call(torch, qk, qk.agent_step, op, st, lanes,
                                    n, obs, sig, h)
                    torch.cuda.synchronize()
                    tag = (f"A1 {case or '6-bus'} x{lanes} "
                           f"{'flat' if obs is None else 'solved'} h={h} "
                           f"sig={sv}")
                    for a, c in zip(sum(k, []), sum(again, [])):
                        check(torch.equal(a, c), f"{tag}: not bit-identical "
                              f"on repeat")
                    check(torch.equal(k[0][2], p[0][2]),
                          f"{tag}: thermostat relays differ")
                    e_state = max(rel_err(a, b) for a, b in zip(k[0], p[0]))
                    e_sums = max(rel_err(a, b) for a, b in
                                 zip(k[1] + k[2], p[1] + p[2]))
                    check(e_state <= A1_STATE_RTOL,
                          f"{tag}: state {e_state:.3e} from the plain version")
                    check(e_sums <= QSTS_SUM_RTOL,
                          f"{tag}: sums {e_sums:.3e} from the plain version")
                    worst["state"] = max(worst["state"], e_state)
                    worst["sums"] = max(worst["sums"], e_sums)
        log(f"qsts kernels: A1 {case or '6-bus'} ({sum(kw.values())} agents, "
            f"{op.n_tiles} tiles, {op.n_seg} segments) x{lanes}: state "
            f"rel {worst['state']:.3e}, sums rel {worst['sums']:.3e}, "
            f"relays equal, bit-identical on repeat")
        del op
    errs["agent_step"] = max(worst.values())
    torch.cuda.empty_cache()


def random_acc(torch, qk, lanes, seed):
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def f(lo, hi):
        return torch.tensor(rng.uniform(lo, hi, lanes), device=dev)

    def i(hi):
        return torch.tensor(rng.integers(0, hi, lanes).astype(np.int32),
                            device=dev)

    return qk.StepAcc(f(0, 5), f(0, 1), i(50), i(5), i(3), f(0.9, 1.1),
                      f(0.9, 1.1), f(0, 1))


def compare_acc(torch, tag, k, p, again):
    """Q1/Q2 accumulators: the counts, worst count, violation minutes and
    envelope equal, the losses and peak within QSTS_SUM_RTOL; the kernel
    bit-identical on repeat.  Returns the largest relative gap."""
    for a, c in zip(k, again):
        check(torch.equal(a, c), f"{tag}: not bit-identical on repeat")
    for name in ("viol", "it_sum", "it_max", "nonconv", "v_lo", "v_hi"):
        check(torch.equal(getattr(k, name), getattr(p, name)),
              f"{tag}: {name} differs from the plain version")
    e = max(rel_err(k.loss, p.loss), rel_err(k.peak, p.peak))
    check(e <= QSTS_SUM_RTOL, f"{tag}: sums {e:.3e} from the plain version")
    return e


def reduce_calls(torch, qk, kernel, plain, acc0):
    outs = []
    for fn in (kernel, plain, kernel):
        acc = qk.StepAcc(*(t.clone() for t in acc0))
        fn(acc)
        outs.append(acc)
    torch.cuda.synchronize()
    return outs


def q1_inputs(torch, case, lanes, seed=4):
    """A solved step of ``case`` × ``lanes`` as the engine solves it
    (mesh2000: sparse, mixed; below 512 buses dense)."""
    from freedm_tpu_torch.pf.newton import make_newton_solver
    from freedm_tpu_torch.serve.service import _resolve_bus_case

    sys_ = _resolve_bus_case(case)
    solve, _ = make_newton_solver(sys_, backend="auto", precision="auto",
                                  device="cuda")
    scale = np.random.default_rng(seed).uniform(0.6, 1.2, (lanes, 1))
    r = solve(p_inj=scale * sys_.p_inj, q_inj=scale * sys_.q_inj)
    check(bool(r.converged.all()), f"Q1 inputs {case}: not converged")
    return sys_, r


def q2_inputs(torch, steps, lanes, seed=6):
    """vvc_9bus: ``steps · lanes`` ladder lanes solved by L1 at load scales
    0.5-1.3."""
    from freedm_tpu_torch.grid.cases import vvc_9bus
    from freedm_tpu_torch.pf.ladder import make_ladder_solver

    f = vvc_9bus()
    scale = np.random.default_rng(seed).uniform(0.5, 1.3,
                                                (steps * lanes, 1, 1))
    solve, _ = make_ladder_solver(f, device="cuda")
    return f, solve(scale * f.s_load)


def compare_q(torch, qk, errs):
    """Q1 at mesh2000 × 64 (a solved mixed step) and case_ieee30 × 1, Q2
    at vvc_9bus × 24·64 lanes, against their plain versions."""
    dev = torch.device("cuda")
    worst = 0.0
    for case, lanes in (("mesh2000", MAIN_LANES), ("case_ieee30", 1)):
        sys_, r = q1_inputs(torch, case, lanes)
        op = qk.bus_reduce_operands(sys_, dev)

        def run(fn):
            return lambda acc: fn(r.v, r.theta, r.p, r.iterations,
                                  r.converged, op, acc, 15.0, 0.25, 0.95,
                                  1.05)

        k, p, again = reduce_calls(torch, qk, run(qk.qsts_bus_reduce),
                                   run(qk.qsts_bus_reduce_plain),
                                   random_acc(torch, qk, lanes, 5))
        e = compare_acc(torch, f"Q1 {case} x{lanes}", k, p, again)
        worst = max(worst, e)
        log(f"qsts kernels: Q1 {case} x{lanes}: counts, envelope equal, "
            f"losses/peak rel {e:.3e}, bit-identical on repeat")
    errs["qsts_bus_reduce"] = worst
    steps, lanes = 24, MAIN_LANES
    f, r = q2_inputs(torch, steps, lanes)
    op = qk.feeder_reduce_operands(f, dev)

    def run2(fn):
        return lambda acc: fn(r, op, acc, steps, 15.0, 0.25, 0.95, 1.05)

    k, p, again = reduce_calls(torch, qk, run2(qk.qsts_feeder_reduce),
                               run2(qk.qsts_feeder_reduce_plain),
                               random_acc(torch, qk, lanes, 7))
    e = compare_acc(torch, f"Q2 vvc_9bus x{steps}*{lanes}", k, p, again)
    errs["qsts_feeder_reduce"] = e
    log(f"qsts kernels: Q2 vvc_9bus {steps} steps x{lanes} lanes: counts, "
        f"envelope equal, losses/peak rel {e:.3e}, bit-identical on repeat")


def tensor_bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def time_qsts(torch, qk, rows, extra):
    """A1 at the bench_agents shape × {1, 4} (the row: × 1), Q1 at
    mesh2000 × 64, Q2 at vvc_9bus × 24·64: CUDA events over back-to-back
    calls and device time, beside the plain versions and the bounds.  No
    single PyTorch call computes any of them: library "none"."""
    dev = torch.device("cuda")
    for lanes in (1, 4):
        op, st, n, obs = agent_world(torch, qk, BENCH_AGENTS, "case_ieee30",
                                     lanes)
        state = op.to_sorted(st, lanes)
        zero = torch.zeros(lanes, n, dtype=torch.float64, device=dev)
        outs = [torch.empty_like(zero), torch.empty_like(zero)]
        acc = [torch.zeros(lanes, dtype=torch.float64, device=dev)
               for _ in range(3)]
        sig = torch.ones(lanes, dtype=torch.float64, device=dev)

        def call(fn=qk.agent_step):
            fn(op, state, obs, sig, 19.0, 0.25, zero, zero, *outs, *acc)

        k = time_ms(torch, call, reps=20)
        kd, src = ladder_device_ms(torch, call, 10, f"A1 x{lanes}")
        pl = time_ms(torch, lambda: call(qk.agent_step_plain), reps=2)
        tables = (op.seg_start, op.seg_end, op.tile_seg_ptr, op.bus_seg_ptr)
        nbytes = (tensor_bytes(*op.params, *op.bus, *tables, obs, sig, zero,
                               zero, *outs) + 2 * tensor_bytes(*state)
                  + 5 * 8 * lanes)
        b, by = bound(nbytes, A1_OPS * sum(op.counts) * lanes)
        log(f"timing: agent_step bench_agents x{lanes}: kernel {k:.4f} ms "
            f"(device {kd:.4f} [{src}])  plain {pl:.4f} ms  bound {b:.5f} ms "
            f"({by}, {nbytes / 1e6:.1f} MB)")
        if lanes == 1:
            rows["agent_step"] = (k, pl, None, b, by)
            extra["agent_step"] = {
                "device_ms": kd, "device_ms_source": src, "bytes": nbytes,
                "shape": "bench_agents: 400k EV, 300k thermostats, 150k "
                         "inverters, 150k DR on case_ieee30 x1"}
        else:
            extra["agent_step"].update({
                "ms_x4": k, "device_ms_x4": kd, "plain_ms_x4": pl,
                "bound_ms_x4": b, "bytes_x4": nbytes})
        del op, state
        torch.cuda.empty_cache()
    sys_, r = q1_inputs(torch, "mesh2000", MAIN_LANES)
    op = qk.bus_reduce_operands(sys_, dev)
    acc = random_acc(torch, qk, MAIN_LANES, 5)
    v, th, p = r.v.contiguous(), r.theta.contiguous(), r.p.contiguous()

    def q1(fn=qk.qsts_bus_reduce):
        fn(v, th, p, r.iterations, r.converged, op, acc, 15.0, 0.25, 0.95,
           1.05)

    k = time_ms(torch, q1, reps=50)
    kd, src = ladder_device_ms(torch, q1, 20, "Q1 mesh2000 x64")
    pl = time_ms(torch, lambda: q1(qk.qsts_bus_reduce_plain), reps=5)
    nbytes = (tensor_bytes(v, th, p, r.iterations, r.converged, *op)
              + 2 * tensor_bytes(*acc))
    b, by = bound(nbytes, Q1_OPS * 2 * int(op.f_idx.shape[0]) * MAIN_LANES)
    log(f"timing: qsts_bus_reduce mesh2000 x{MAIN_LANES}: kernel {k:.4f} ms "
        f"(device {kd:.4f} [{src}])  plain {pl:.4f} ms  bound {b:.5f} ms "
        f"({by})")
    rows["qsts_bus_reduce"] = (k, pl, None, b, by)
    extra["qsts_bus_reduce"] = {"device_ms": kd, "device_ms_source": src,
                                "shape": "mesh2000 x64, a solved mixed step"}
    steps, lanes = 24, MAIN_LANES
    f, res = q2_inputs(torch, steps, lanes)
    op2 = qk.feeder_reduce_operands(f, dev)
    acc2 = random_acc(torch, qk, lanes, 7)

    def q2(fn=qk.qsts_feeder_reduce):
        fn(res, op2, acc2, steps, 15.0, 0.25, 0.95, 1.05)

    k = time_ms(torch, q2, reps=50)
    kd, src = ladder_device_ms(torch, q2, 20, "Q2 vvc_9bus")
    pl = time_ms(torch, lambda: q2(qk.qsts_feeder_reduce_plain), reps=3)
    nbytes = (tensor_bytes(*res.v_node, *res.i_branch, *res.i_load,
                           res.iterations, res.converged, op2.root,
                           op2.live) + 2 * tensor_bytes(*acc2))
    b, by = bound(nbytes, Q2_OPS * 3 * f.n_branches * steps * lanes)
    log(f"timing: qsts_feeder_reduce vvc_9bus {steps} steps x{lanes}: kernel "
        f"{k:.4f} ms (device {kd:.4f} [{src}])  plain {pl:.4f} ms  bound "
        f"{b:.5f} ms ({by})")
    rows["qsts_feeder_reduce"] = (k, pl, None, b, by)
    extra["qsts_feeder_reduce"] = {
        "device_ms": kd, "device_ms_source": src,
        "shape": f"vvc_9bus, {steps} steps x{lanes} lanes"}


def study_states(eng):
    """The engine's final carried state, chunk by chunk."""
    spec = eng.spec
    state = eng.initial_state()
    for t0 in range(0, spec.steps, spec.chunk_steps):
        state = eng.run_chunk(state, t0, min(spec.steps, t0 + spec.chunk_steps))
    return state


def compare_states(tag, a, b, atol, exact_ints=True):
    """Float fields within ``atol``; integer fields equal (with
    ``exact_ints``: else only ``nonconv``, the flags)."""
    worst = 0.0
    for name in a._fields:
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        if x.dtype.kind in "iu":
            if exact_ints or name == "nonconv":
                check(np.array_equal(x, y), f"{tag}: {name} {x} vs {y}")
            continue
        gap = float(np.max(np.abs(x - y))) if x.size else 0.0
        check(gap <= atol, f"{tag}: {name} {gap:.3e} from plain=True")
        worst = max(worst, gap)
    return worst


def same_summary(a, b, drop=()):
    """Two summaries equal but for their timing keys (and ``drop``), NaN
    equal to NaN (a diverged lane's envelope is NaN in both)."""
    from freedm_tpu_torch.scenarios.engine import strip_timing

    def view(x):
        return json.dumps({k: v for k, v in strip_timing(x).items()
                           if k not in drop}, sort_keys=True)

    return view(a) == view(b)


def kill_and_resume(tag, spec, want, tmp, **kw):
    """Stop after ``kw['stop']`` chunks, resume from the checkpoint; the
    resumed summary must equal ``want`` (strip_timing)."""
    from freedm_tpu_torch.scenarios.engine import run_study, strip_timing

    ck = os.path.join(tmp, f"{tag}.json")
    t0 = time.monotonic()
    part = run_study(spec, checkpoint_path=ck, stop_after_chunks=kw["stop"])
    check(part["completed"] is False, f"{tag}: the killed run completed")
    out = run_study(spec, checkpoint_path=ck)
    check(out["resumed_from_chunk"] == kw["stop"],
          f"{tag}: resumed from {out['resumed_from_chunk']}")
    check(same_summary(out, want),
          f"{tag}: the resumed summary differs: {strip_timing(out)} vs "
          f"{strip_timing(want)}")
    log(f"qsts: {tag}: killed after {kw['stop']} chunks and resumed: equal "
        f"to the uninterrupted run ({time.monotonic() - t0:.1f} s with "
        f"checkpoints, {os.path.getsize(ck) / 1e6:.1f} MB)")


def split_line(eng, before):
    parts = {k: eng.wall_split[k] - before.get(k, 0.0)
             for k in eng.wall_split}
    return ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())


def qsts_phase(torch, qk, lk):
    """The studies through ``run_study`` on the card: (a) the bench_qsts
    shape, (b) mesh2000 × 64 at full width, (c) the million-agent day,
    (d) the vvc_9bus feeder.  Returns the kernels' launches on their
    paths: Q1 over (b), A1 over (c)'s second run, Q2 and L1 over (d)."""
    import dataclasses
    import tempfile

    from freedm_tpu_torch.scenarios.agents import AgentSpec
    from freedm_tpu_torch.scenarios.engine import (QstsEngine, StudySpec,
                                                   run_study, strip_timing)

    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) bench_qsts: case14 x16, 96 steps of 15 min, chunks of 24.
        spec = StudySpec(case="case14", scenarios=16, steps=96,
                         dt_minutes=15.0, chunk_steps=24, seed=5)
        warm = run_study(spec)
        cold = run_study(dataclasses.replace(spec, warm_start=False))
        log(f"qsts: (a) case14 x16 x96: warm iters_mean {warm['iters_mean']}"
            f" vs cold {cold['iters_mean']}; {warm['scenario_steps_per_sec']}"
            f" scenario-steps/s warm, {cold['scenario_steps_per_sec']} cold")
        check(warm["completed"] and warm["lane_steps_not_converged"] == 0,
              f"(a): {warm}")
        check(cold["iters_mean"] > warm["iters_mean"],
              "(a): warm starts saved no iterations")
        kill_and_resume("a-case14", spec, warm, tmp, stop=2)
        got = study_states(QstsEngine(spec))
        want = study_states(QstsEngine(spec, plain=True))
        gap = compare_states("(a) vs plain=True", got, want, QSTS_ATOL)
        log(f"qsts: (a) kernel path vs plain=True: states within {gap:.3e} "
            f"pu, iteration sums equal")

        # (b) full width, the served default path.  The residential day
        # of this case is not solvable at midday: the reference diverges
        # on it too (MIDDAY_STEP), and a lane that diverges seeds its next
        # step with its diverged point, as the reference's carry does.  So
        # every lane-step must converge before midday, and the whole day
        # must complete and be reproducible.
        spec = StudySpec(case="mesh2000", scenarios=MAIN_LANES, steps=96,
                         dt_minutes=15.0, chunk_steps=24, seed=5,
                         profile="residential")
        morning = run_study(dataclasses.replace(spec, steps=MIDDAY_STEP))
        check(morning["completed"]
              and morning["lane_steps_not_converged"] == 0
              and morning["energy_balance_ok"],
              f"(b) mesh2000 before midday: {morning}")
        log(f"qsts: (b) mesh2000 x{MAIN_LANES}, the {MIDDAY_STEP} steps "
            f"before midday: every lane-step converged, "
            f"{morning['iters_mean']} Newton steps a lane-step, "
            f"{morning['scenario_steps_per_sec']} scenario-steps/s")
        t0 = time.monotonic()
        eng = QstsEngine(spec)
        build_s = time.monotonic() - t0
        qk.reset_launches()
        before = dict(eng.wall_split)
        full = run_study(spec, engine=eng)
        counts["qsts_bus_reduce"] = qk.launches()["qsts_bus_reduce"]
        check(full["completed"] and full["compiles"] <= 2,
              f"(b) mesh2000: {full}")
        check(counts["qsts_bus_reduce"] == spec.steps,
              f"(b): Q1 launched {counts['qsts_bus_reduce']} times")
        log(f"qsts: (b) mesh2000 x{MAIN_LANES} x96 ({full['pf_backend']}, "
            f"{full['pf_precision']}): {full['scenario_steps_per_sec']} "
            f"scenario-steps/s, {full['iters_mean']} Newton steps a "
            f"lane-step (max {full['iters_max']}), "
            f"{full['lane_steps_not_converged']} of "
            f"{MAIN_LANES * spec.steps} lane-steps not converged, wall "
            f"{full['wall_s']} s (engine build {build_s:.1f} s); chunk wall "
            f"split: {split_line(eng, before)}; v {full['v_min_pu']}-"
            f"{full['v_max_pu']} pu, Q1 launches "
            f"{counts['qsts_bus_reduce']}")
        again = run_study(spec, engine=eng)
        log(f"qsts: (b) second run on the built engine: "
            f"{again['scenario_steps_per_sec']} scenario-steps/s")
        check(same_summary(again, full),
              "(b): a second run differs from the first")
        kill_and_resume("b-mesh2000", spec, full, tmp, stop=2)
        other = run_study(dataclasses.replace(spec, chunk_steps=32))
        check(same_summary(full, other, drop=("chunks_total", "compiles")),
              f"(b): chunks of 32 differ: {strip_timing(full)} vs "
              f"{strip_timing(other)}")
        log("qsts: (b) chunks of 32: the summary equals chunks of 24")
        small = StudySpec(case="mesh2000", scenarios=8, steps=4,
                          chunk_steps=4, seed=5)
        got = study_states(QstsEngine(small))
        want = study_states(QstsEngine(small, plain=True))
        gap = compare_states("(b) mesh2000 x8 x4 vs plain=True", got, want,
                             QSTS_MIXED_ATOL, exact_ints=False)
        log(f"qsts: (b) mesh2000 x8 x4 kernel path vs plain=True: within "
            f"{gap:.3e} pu, flags equal (iteration sums {got.it_sum.tolist()}"
            f" vs {want.it_sum.tolist()})")
        del eng
        torch.cuda.empty_cache()

        # (c) bench_agents: a million agents on case_ieee30, 24 h steps.
        for lanes in (1, 4):
            spec = StudySpec(case="case_ieee30", scenarios=lanes, steps=24,
                             dt_minutes=60.0, chunk_steps=8, seed=11,
                             agents=AgentSpec(**BENCH_AGENTS))
            t0 = time.monotonic()
            eng = QstsEngine(spec)
            build_s = time.monotonic() - t0
            first = run_study(spec, engine=eng)
            qk.reset_launches()
            lk.reset_launches()
            before = dict(eng.wall_split)
            closed = run_study(spec, engine=eng)
            launched = qk.launches()
            if lanes == 1:
                counts["agent_step"] = launched["agent_step"]
            check(launched["agent_step"] == spec.steps
                  and launched["qsts_bus_reduce"] == spec.steps,
                  f"(c): launches {launched}")
            check(same_summary(closed, first),
                  "(c): a second run differs from the first")
            check(closed["completed"]
                  and closed["lane_steps_not_converged"] == 0,
                  f"(c): {closed}")
            log(f"qsts: (c) case_ieee30 x{lanes}, 10^6 agents, 24 h: "
                f"{closed['agent_steps_per_sec']} agent-steps/s on the "
                f"engine's second run (first {first['agent_steps_per_sec']}; "
                f"engine build {build_s:.1f} s), {closed['iters_mean']} "
                f"Newton steps a lane-step; chunk wall split: "
                f"{split_line(eng, before)}; launches {launched}; served "
                f"{closed['agent_energy_puh_mean']} pu·h, |q| peak "
                f"{closed['agent_q_peak_pu']} pu")
            if lanes == 1:
                replayed = run_study(dataclasses.replace(
                    spec, agents=dataclasses.replace(spec.agents,
                                                     closed_loop=False)))
                check(replayed["agent_q_peak_pu"] == 0.0
                      and closed["agent_q_peak_pu"] > 0.0
                      and closed["energy_loss_mwh_mean"]
                      != replayed["energy_loss_mwh_mean"],
                      f"(c): closed {closed} vs replayed {replayed}")
                log(f"qsts: (c) closed-loop |q| peak "
                    f"{closed['agent_q_peak_pu']} vs replayed "
                    f"{replayed['agent_q_peak_pu']}; losses "
                    f"{closed['energy_loss_mwh_mean']:.6f} vs "
                    f"{replayed['energy_loss_mwh_mean']:.6f} MWh")
            kill_and_resume(f"c-agents-x{lanes}", spec, closed, tmp, stop=1)
            del eng
            torch.cuda.empty_cache()

        # (d) the feeder: vvc_9bus x64, 96 steps, one L1 launch a chunk.
        spec = StudySpec(case="vvc_9bus", scenarios=MAIN_LANES, steps=96,
                         dt_minutes=15.0, chunk_steps=24, seed=5)
        eng = QstsEngine(spec)
        qk.reset_launches()
        lk.reset_launches()
        feeder = run_study(spec, engine=eng)
        counts["qsts_feeder_reduce"] = qk.launches()["qsts_feeder_reduce"]
        l1 = lk.launches()["ladder_solve"]
        n_chunks = spec.steps // spec.chunk_steps
        check(l1 == n_chunks and counts["qsts_feeder_reduce"] == n_chunks,
              f"(d): L1 {l1}, Q2 {counts['qsts_feeder_reduce']} launches for "
              f"{n_chunks} chunks")
        check(feeder["completed"] and feeder["energy_balance_ok"]
              and feeder["lane_steps_not_converged"] == 0, f"(d): {feeder}")
        got = study_states(QstsEngine(spec))
        want = study_states(QstsEngine(spec, plain=True))
        gap = compare_states("(d) vs plain=True", got, want, QSTS_ATOL)
        kill_and_resume("d-feeder", spec, feeder, tmp, stop=2)
        log(f"qsts: (d) vvc_9bus x{MAIN_LANES} x96: "
            f"{feeder['scenario_steps_per_sec']} scenario-steps/s, L1 "
            f"{l1} and Q2 {counts['qsts_feeder_reduce']} launches for "
            f"{n_chunks} chunks, within {gap:.3e} of plain=True, losses "
            f"{feeder['energy_loss_kwh_mean']:.3f} kWh a scenario")
    return counts


def post_json(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request(method, path, body=None if body is None else json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


def wait_job(port, job_id, until=("completed", "failed", "cancelled"),
             timeout_s=600.0, pred=None):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        status, j = post_json(port, "GET", f"/v1/jobs/{job_id}")
        check(status == 200, f"GET /v1/jobs/{job_id}: HTTP {status} {j}")
        if j["state"] in until or (pred is not None and pred(j)):
            return j
        time.sleep(0.02)
    raise SmokeFailure(f"job {job_id} did not finish: {j}")


def serve_qsts(torch, qk):
    """``ServeServer`` with a ``JobManager`` over a temporary checkpoint
    directory: a mesh2000 study while a 64-request ``/v1/pf`` burst runs
    on case14, its summary against a direct ``run_study``, a cancelled
    keyed job resumed, an agents job, and the typed 404s."""
    import tempfile

    from freedm_tpu_torch.scenarios.engine import run_study
    from freedm_tpu_torch.scenarios.jobs import JobManager, parse_job_request
    from freedm_tpu_torch.serve.http import ServeServer
    from freedm_tpu_torch.serve.service import ServeConfig, Service

    def burst(tag):
        wall, out = post_round(server.port, "case14", scales)
        for status, body, _ in out:
            check(status == 200 and body["converged"],
                  f"serve qsts {tag}: HTTP {status}: {str(body)[:300]}")
        lat = np.array([x for _, _, x in out]) * 1e3
        return float(np.percentile(lat, 50)), float(np.percentile(lat, 99))

    with tempfile.TemporaryDirectory() as tmp:
        svc = Service(ServeConfig(max_batch=MAIN_LANES, device="cuda",
                                  cache_mb=0.0))
        jm = JobManager(workers=1, checkpoint_dir=tmp, device="cuda").start()
        server = ServeServer(svc, jobs=jm).start()
        try:
            scales = np.linspace(0.6, 1.2, MAIN_LANES)
            post_round(server.port, "case14", scales[:4])  # engine build
            alone = burst("alone")
            payload = {"case": "mesh2000", "scenarios": 16, "steps": 48,
                       "chunk_steps": 12, "seed": 5, "job_key": "s1"}
            status, d = post_json(server.port, "POST", "/v1/qsts", payload)
            check(status == 202 and d["state"] == "queued",
                  f"POST /v1/qsts: HTTP {status} {d}")
            wait_job(server.port, d["job_id"],
                     pred=lambda j: j["state"] == "running")
            during = burst("during a job")
            _, jstate = post_json(server.port, "GET", f"/v1/jobs/{d['job_id']}")
            job = wait_job(server.port, d["job_id"])
            check(job["state"] == "completed", f"job s1: {job}")
            spec, _ = parse_job_request(payload)
            direct = run_study(spec)
            check(same_summary(job["summary"], direct),
                  f"job s1 differs from a direct run_study: "
                  f"{job['summary']} vs {direct}")
            log(f"serve qsts: 64-request /v1/pf burst on case14 p50/p99 "
                f"{alone[0]:.1f}/{alone[1]:.1f} ms alone, "
                f"{during[0]:.1f}/{during[1]:.1f} ms while a mesh2000 x16 "
                f"job ran (job {jstate['state']} after the burst, chunk "
                f"{jstate['chunks_done']}/{jstate['chunks_total']}); the "
                f"job's summary equals a direct run_study "
                f"({job['summary']['scenario_steps_per_sec']} scenario-"
                f"steps/s)")
            payload2 = dict(payload, steps=96, job_key="s2")
            _, d2 = post_json(server.port, "POST", "/v1/qsts", payload2)
            wait_job(server.port, d2["job_id"],
                     pred=lambda j: j["chunks_done"] >= 1)
            status, c = post_json(server.port, "POST",
                                  f"/v1/jobs/{d2['job_id']}/cancel", {})
            check(status == 200, f"cancel: HTTP {status} {c}")
            j2 = wait_job(server.port, d2["job_id"])
            ck = os.path.join(tmp, "qsts_s2.json")
            check(j2["state"] == "cancelled" and os.path.exists(ck),
                  f"job s2 after cancel: {j2}")
            _, d3 = post_json(server.port, "POST", "/v1/qsts", payload2)
            j3 = wait_job(server.port, d3["job_id"])
            spec2, _ = parse_job_request(payload2)
            check(j3["state"] == "completed"
                  and j3["resumed_from_chunk"] > 0
                  and same_summary(j3["summary"], run_study(spec2)),
                  f"job s2 resubmitted: {j3}")
            log(f"serve qsts: job s2 cancelled after chunk "
                f"{j2['chunks_done']}, resubmitted: resumed from chunk "
                f"{j3['resumed_from_chunk']}, equal to the uninterrupted run")
            qk.reset_launches()
            _, d4 = post_json(server.port, "POST", "/v1/qsts", {
                "case": "case_ieee30", "scenarios": 2, "steps": 8,
                "chunk_steps": 4, "agents": {"ev": 4000, "thermostat": 3000,
                                             "inverter": 1500, "dr": 1500}})
            j4 = wait_job(server.port, d4["job_id"])
            a1 = qk.launches()["agent_step"]
            check(j4["state"] == "completed" and a1 == 8,
                  f"agents job: {j4.get('error')} A1 launches {a1}")
            status, e = post_json(server.port, "GET", "/v1/jobs/deadbeef")
            check(status == 404 and e["error"]["type"] == "not_found",
                  f"unknown job id: HTTP {status} {e}")
            status, h = post_json(server.port, "GET", "/healthz")
            check(status == 200 and h["qsts"] is True, f"/healthz: {h}")
            log(f"serve qsts: agents job (10^4 agents on case_ieee30 x2) "
                f"completed, A1 launched {a1} times; unknown id 404 "
                f"not_found; /healthz qsts {h['qsts']}")
        finally:
            server.stop()
            jm.stop()
            svc.stop()


# ---------------------------------------------------------------------------
# Phase 18: the topology kernels (T1, T2)
# ---------------------------------------------------------------------------

#: T2 against its plain version: θ, flows, loss and worst flow within
#: 1e-10 pu absolute (the r × r solve and the sums round in another
#: order); T2's islanding flags and violation counts and T1's booleans
#: equal; both bit-identical on repeat.
TOPO_ATOL = 1e-10
TOPO_CASES = ("case14", "case_ieee30", "mesh118", "mesh2000")
TOPO_LANES = (1, 4096)  # capped by a case's distinct open-sets of a rank
TOPO_RANKS = (1, 2, 6)
#: The flow bar of the compared and timed screens, pu.
TOPO_LIMIT = 0.5
#: H100 SXM int32 rate outside the tensor cores: 64 INT32 lanes an SM a
#: clock (Hopper architecture white paper) x 132 SMs x 1.98 GHz.
PEAK_INT32 = 16.7e12
#: The integer operations that labelling a lane's components needs at
#: least, one pass over its inputs (loads not counted): per closed edge a
#: compare and a min, per bus the compare of the connected test.
T1_EDGE_OPS, T1_BUS_OPS = 2, 1
#: T2's float64 operations a lane: per bus and active slot a multiply and
#: an add, per bus an add, per branch a subtract, three multiplies, an
#: add, an abs and a compare.
T2_SLOT_OPS, T2_BUS_OPS, T2_EDGE_OPS = 2, 1, 7
#: The sweep gate of the reference's bench (``bench.py`` ``bench_topo``):
#: variants/s over every rank-<=2 variant of mesh118 — its gate value, for
#: orientation only; no time of another device is quoted here.
TOPO_GATE_FLOOR = 10_000
#: The full-width sweep: mesh2000 neighborhood samples of rank <= 3, in
#: chunks of this many (the largest chunk a job takes).
TOPO_FULL_SAMPLES = 65536
TOPO_FULL_CHUNK = 16384
#: The served shortlist's AC lanes: converged, and the host float64
#: residual of each variant's own topology under this bar.
AC_TRUE_MISMATCH = 1e-6


def random_open_sets(m, lanes, rank, seed):
    """``lanes`` distinct random open-sets of rank 1..``rank`` of ``m``
    branches (int32, ``-1`` pads)."""
    rng = np.random.default_rng(seed)
    rows, seen = [], set()
    while len(rows) < lanes:
        r = int(rng.integers(1, rank + 1))
        combo = tuple(sorted(rng.choice(m, size=r, replace=False).tolist()))
        if combo in seen:
            continue
        seen.add(combo)
        row = np.full(rank, -1, np.int32)
        row[:r] = combo
        rows.append(row)
    return np.stack(rows)


def topo_inputs(torch, tp, name, dev="cuda"):
    """One case's T1/T2 operands on the card, its Zᵀ and base angles θ0."""
    from freedm_tpu_torch.pf.fdlf import decoupled_parts

    sys_ = case_system(name)
    dev = torch.device(dev)
    op = tp.topo_operands(sys_, device=dev)
    parts = decoupled_parts(sys_, device=dev)
    lu = torch.linalg.lu_factor(parts.b_prime(None))
    zt = tp.z_transpose(sys_, lu, op)
    p0 = torch.as_tensor(np.asarray(sys_.p_inj, np.float64), device=dev)
    rhs = torch.where(parts.th_free > 0, p0, torch.zeros_like(p0))
    theta0 = torch.linalg.lu_solve(*lu, rhs[:, None])[:, 0].contiguous()
    return sys_, op, zt, theta0


def compare_topo_block(torch, tk, op, zt, theta0, sl, tag):
    """T1 and T2 (both modes) against their plain versions on one slot
    block; returns (T2's worst gap, |det C| max over islanded lanes, min
    over the others)."""
    cap = op.n + 1
    k1 = tk.topo_radiality(sl, op, cap)
    again1 = tk.topo_radiality(sl, op, cap)
    p1 = tk.topo_radiality_plain(sl, op, cap)
    check(torch.equal(k1[0], p1[0]) and torch.equal(k1[1], p1[1]),
          f"topo_radiality {tag}: connected/radial differ from the plain "
          f"version")
    # The verdict is the fixed point's; the sweep count of the asynchronous
    # sweeps depends on the threads' timing and is not compared.
    check(torch.equal(k1[0], again1[0]) and torch.equal(k1[1], again1[1]),
          f"topo_radiality {tag}: not bit-identical on repeat")
    k2 = tk.topo_screen(zt, theta0, sl, TOPO_LIMIT, op, tk.DETAIL)
    again2 = tk.topo_screen(zt, theta0, sl, TOPO_LIMIT, op, tk.DETAIL)
    s2 = tk.topo_screen(zt, theta0, sl, TOPO_LIMIT, op, tk.SCREEN)
    p2 = tk.topo_screen_plain(zt, theta0, sl, TOPO_LIMIT, op, tk.DETAIL)
    check(torch.equal(k2.islanded, p2.islanded),
          f"topo_screen {tag}: islanding flags differ "
          f"({int((k2.islanded != p2.islanded).sum())} lanes)")
    check(torch.equal(k2.violations, p2.violations),
          f"topo_screen {tag}: violation counts differ")
    gap = 0.0
    for field in ("theta", "flows", "loss", "worst_flow"):
        g = max_err(getattr(k2, field), getattr(p2, field))
        check(g <= TOPO_ATOL, f"topo_screen {tag}: {field} {g:.3e} from the "
              f"plain version")
        gap = max(gap, g)
    check(all(torch.equal(getattr(k2, f), getattr(again2, f))
              for f in k2._fields),
          f"topo_screen {tag}: not bit-identical on repeat")
    check(all(torch.equal(getattr(k2, f), getattr(s2, f))
              for f in ("loss", "worst_flow", "violations", "islanded")),
          f"topo_screen {tag}: SCREEN differs from DETAIL")
    det = tk.capacitance_det(zt, sl, op).abs()
    isl = k2.islanded
    hi = float(det[isl].max()) if bool(isl.any()) else 0.0
    lo = float(det[~isl].min()) if bool((~isl).any()) else float("inf")
    return gap, hi, lo, int(isl.sum()), int((~k1[0]).sum())


def compare_topo(torch, tk, tp, errs, dev="cuda", cases=TOPO_CASES):
    """T1 and T2 against their plain versions at case14, case_ieee30,
    mesh118 and mesh2000 × V ∈ {1, 4096} × r ∈ {1, 2, 6} (random distinct
    open-sets, seeded), every rank-<=2 variant of case14, case_ieee30 and
    mesh118, and the bridges of case14 and case_ieee30."""
    from freedm_tpu_torch.pf.n1 import secure_outages

    t0 = time.monotonic()
    worst, det_hi, det_lo, blocks = 0.0, 0.0, float("inf"), 0
    for ci, name in enumerate(cases):
        sys_, op, zt, theta0 = topo_inputs(torch, tp, name, dev)
        m = sys_.n_branch
        cases = [(f"r{rank} x{lanes}", random_open_sets(
            m, min(lanes, tp.count_exhaustive(m, rank)), rank,
            seed=100 * ci + 10 * rank + (lanes > 1)))
            for rank in TOPO_RANKS for lanes in TOPO_LANES]
        if name != "mesh2000":
            cases.append(("every rank<=2",
                          tp.enumerate_variants(np.arange(m), 2)))
        line = []
        for tag, slots in cases:
            sl = torch.as_tensor(slots, device=dev)
            gap, hi, lo, n_isl, n_disc = compare_topo_block(
                torch, tk, op, zt, theta0, sl, f"{name} {tag}")
            worst, det_hi, det_lo = max(worst, gap), max(det_hi, hi), \
                min(det_lo, lo)
            blocks += 1
            line.append(f"{tag} ({sl.shape[0]} lanes, {n_disc} disconnected, "
                        f"{n_isl} islanded) {gap:.1e}")
        log(f"topo kernels: {name}: " + "; ".join(line))
        if name in ("case14", "case_ieee30"):
            bridges = sorted(set(range(m)) - set(secure_outages(sys_)))
            slots = np.full((len(bridges), 2), -1, np.int32)
            slots[:, 0] = bridges
            sl = torch.as_tensor(slots, device=dev)
            conn = tk.topo_radiality(sl, op, sys_.n_bus + 1)[0]
            isl = tk.topo_screen(zt, theta0, sl, TOPO_LIMIT, op).islanded
            check(not bool(conn.any()) and bool(isl.all()),
                  f"topo kernels: {name}'s bridges {bridges} not all flagged "
                  f"(T1 connected {conn.tolist()}, T2 islanded "
                  f"{isl.tolist()})")
            log(f"topo kernels: {name}'s {len(bridges)} bridges flagged by T1 "
                f"and T2")
    sync(torch, torch.device(dev))
    errs["topo_radiality"] = 0.0  # booleans: equal
    errs["topo_screen"] = worst
    log(f"topo kernels: {blocks} blocks, T1 booleans equal, T2 flags and "
        f"violations equal, theta/flows/loss/worst within {worst:.2e} "
        f"(<= {TOPO_ATOL:g}), both bit-identical on repeat; |det C| <= "
        f"{det_hi:.3e} on islanded lanes, >= {det_lo:.3e} on the others "
        f"(threshold {tk.ISLAND_EPS:g}) "
        f"({time.monotonic() - t0:.1f} s)")
    return {"det_max_islanded": det_hi, "det_min_connected": det_lo}


def t1_bound(op, sl):
    """T1's least time from its inputs alone: its bytes (slots, branch
    ends, the two boolean outputs) or one pass of integer operations over
    each lane's closed edges and buses — not the sweeps the kernel makes."""
    lanes, r = int(sl.shape[0]), int(sl.shape[1])
    nbytes = lanes * r * 4 + 2 * op.m * 4 + lanes * 2
    closed = op.m - ((sl >= 0) & (sl < op.m)).sum(dim=1)
    ops = float((T1_EDGE_OPS * closed.double() + T1_BUS_OPS * op.n).sum())
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_INT32 * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"),
            nbytes)


def t2_bound(op, sl, detail=False):
    """T2's least time: the active rows of Zᵀ, θ0, the branch arrays, the
    slots and the outputs (DETAIL: the [V, n] and [V, m] writes too), or
    its float64 operations."""
    lanes, r = int(sl.shape[0]), int(sl.shape[1])
    n, m = op.n, op.m
    active = int(((sl >= 0) & (sl < m)).sum())
    nbytes = (active * n * 8 + n * 8 + m * (4 + 4 + 4 * 8) + lanes * r * 4
              + lanes * (3 * 8 + 1))
    if detail:
        nbytes += lanes * (n + m) * 8
    ops = (T2_SLOT_OPS * n * active + lanes * (T2_BUS_OPS * n
                                               + T2_EDGE_OPS * m
                                               + 4 * r * r + r ** 3))
    return bound(nbytes, ops), nbytes


def time_t1_t2(torch, tk, op, zt, theta0, sl, tag, detail_too=False):
    """Events, device time and the plain versions' times of T1 and T2
    SCREEN (and DETAIL) on one block, with their bounds."""
    cap = op.n + 1
    out = {}
    t1 = lambda: tk.topo_radiality(sl, op, cap)  # noqa: E731
    # The sweep count is a diagnostic (it follows the threads' timing).
    sweeps = tk.topo_radiality(sl, op, cap, with_sweeps=True)[2]
    (b1, by1), bytes1 = t1_bound(op, sl)
    k = time_ms(torch, t1, reps=20)
    kd, src = ladder_device_ms(torch, t1, 10, f"T1 {tag}")
    pl = time_ms(torch, lambda: tk.topo_radiality_plain(sl, op, cap), reps=2)
    out["topo_radiality"] = dict(
        ms=k, device_ms=kd, device_ms_source=src, plain_ms=pl, bound_ms=b1,
        bound_by=by1, bytes=bytes1, sweeps_max=int(sweeps.max()),
        sweeps_mean=float(sweeps.double().mean()))
    log(f"timing: topo_radiality {tag}: kernel {k:.4f} ms (device {kd:.4f} "
        f"[{src}])  plain {pl:.3f} ms  bound {b1:.5f} ms ({by1}); sweeps "
        f"{int(sweeps.min())}-{int(sweeps.max())}, mean "
        f"{float(sweeps.double().mean()):.2f}")
    modes = (("SCREEN", tk.SCREEN),) + ((("DETAIL", tk.DETAIL),)
                                        if detail_too else ())
    for label, mode in modes:
        def t2(fn=tk.topo_screen, mode=mode):
            fn(zt, theta0, sl, TOPO_LIMIT, op, mode)

        (b2, by2), bytes2 = t2_bound(op, sl, detail=mode == tk.DETAIL)
        k = time_ms(torch, t2, reps=20)
        kd, src = ladder_device_ms(torch, t2, 10, f"T2 {label} {tag}")
        pl = time_ms(torch, lambda: t2(tk.topo_screen_plain), reps=2)
        out[f"topo_screen_{label}"] = dict(
            ms=k, device_ms=kd, device_ms_source=src, plain_ms=pl,
            bound_ms=b2, bound_by=by2, bytes=bytes2)
        log(f"timing: topo_screen {label} {tag}: kernel {k:.4f} ms (device "
            f"{kd:.4f} [{src}])  plain {pl:.3f} ms  bound {b2:.5f} ms "
            f"({by2}, {bytes2 / 1e6:.2f} MB)")
    return out


def refactor_solve(torch, sys_, op, sl):
    """The per-variant refactorization the SMW lanes replace (the
    reference bench's head-to-head): B′ re-formed with each lane's
    branches open, ``B′ − Σ_S w_k a_k a_kᵀ`` ``[V, n, n]``, and the
    right-hand side; the timed library call is ``torch.linalg.solve_ex``
    of the stack."""
    from freedm_tpu_torch.pf.fdlf import decoupled_parts

    dev = sl.device
    parts = decoupled_parts(sys_, device=dev)
    lanes, r = int(sl.shape[0]), int(sl.shape[1])
    ok = (sl >= 0) & (sl < op.m)
    k = torch.where(ok, sl, 0).long()
    a = torch.zeros(lanes, op.n, r, dtype=torch.float64, device=dev)
    lane = torch.arange(lanes, device=dev)[:, None].expand(lanes, r)
    col = torch.arange(r, device=dev)[None, :].expand(lanes, r)
    act = ok.double()
    a.index_put_((lane, op.f.long()[k], col), op.mask_f[k] * act,
                 accumulate=True)
    a.index_put_((lane, op.t.long()[k], col), -op.mask_t[k] * act,
                 accumulate=True)
    w = op.w[k] * act
    b = parts.b_prime(None) - torch.bmm(a * w[:, None, :], a.mT)
    p0 = torch.as_tensor(np.asarray(sys_.p_inj, np.float64), device=dev)
    rhs = torch.where(parts.th_free > 0, p0, torch.zeros_like(p0))
    return b, rhs[None, :, None].expand(lanes, op.n, 1).contiguous()


def time_topo(torch, tk, tp, rows, extra):
    """T1 and T2 SCREEN at mesh118 × 4096, r = 2 (a chunk of the gate
    sweep) and mesh2000 × 16384, r = 3 (the first chunk of the full-width
    neighborhood sweep), T2 DETAIL at mesh118 × 4096; the library row: the
    re-formed B′ stack of the mesh118 chunk through
    ``torch.linalg.solve_ex``, and per variant on the reference bench's 32
    mixed-rank lanes."""
    dev = torch.device("cuda")
    sys_, op, zt, theta0 = topo_inputs(torch, tp, "mesh118")
    chunk = tp.enumerate_variants(np.arange(sys_.n_branch), 2)[4096:8192]
    sl = torch.as_tensor(chunk, device=dev)
    small = time_t1_t2(torch, tk, op, zt, theta0, sl, "mesh118 x4096 r2",
                       detail_too=True)
    b, rhs = refactor_solve(torch, sys_, op, sl)
    lib = time_ms(torch, lambda: torch.linalg.solve_ex(b, rhs), reps=5)
    # The reference bench's head-to-head: 32 mixed-rank lanes (8 rank 1,
    # 24 rank 2 of branches 0-8), per variant, each side one call.
    pool = tp.enumerate_variants(np.arange(9), 2)
    sample = np.concatenate([pool[pool[:, 1] < 0][:8],
                             pool[pool[:, 1] >= 0][:24]])
    s32 = torch.as_tensor(sample, device=dev)
    b32, rhs32 = refactor_solve(torch, sys_, op, s32)
    ref_theta = torch.linalg.solve_ex(b32, rhs32)[0][..., 0]
    det32 = tk.topo_screen(zt, theta0, s32, TOPO_LIMIT, op, tk.DETAIL)
    okl = ~det32.islanded
    dth = max_err(ref_theta[okl], det32.theta[okl])
    check(dth < 1e-8, f"topo: SMW lanes {dth:.3e} from refactorization")
    lib32 = time_ms(torch, lambda: torch.linalg.solve_ex(b32, rhs32),
                    reps=20) * 1e3 / 32
    smw32 = time_ms(torch, lambda: tk.topo_screen(zt, theta0, s32,
                                                  TOPO_LIMIT, op),
                    reps=20) * 1e3 / 32
    log(f"timing: refactorization head-to-head, mesh118: torch.linalg."
        f"solve_ex of 4096 re-formed B' {lib:.3f} ms; 32 mixed-rank lanes "
        f"{lib32:.2f} us a variant against T2 SCREEN {smw32:.2f} us a "
        f"variant (x{lib32 / smw32:.1f}); theta within {dth:.1e}")
    del b, b32
    sys2, op2, zt2, th2 = topo_inputs(torch, tp, "mesh2000")
    big = tp.neighborhood_variants(np.arange(sys2.n_branch), 3, 16384, 7)
    sl2 = torch.as_tensor(big, device=dev)
    large = time_t1_t2(torch, tk, op2, zt2, th2, sl2, "mesh2000 x16384 r<=3")
    del zt2
    torch.cuda.empty_cache()
    r1, r2 = small["topo_radiality"], small["topo_screen_SCREEN"]
    rows["topo_radiality"] = (r1["ms"], r1["plain_ms"], None, r1["bound_ms"],
                              r1["bound_by"])
    rows["topo_screen"] = (r2["ms"], r2["plain_ms"], lib, r2["bound_ms"],
                           r2["bound_by"])
    shape = "mesh118 x4096 lanes, rank 2 (rows 4096-8191 of the gate sweep)"
    extra["topo_radiality"] = {
        "shape": shape, **{k: v for k, v in r1.items()
                           if k not in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")},
        "mesh2000_x16384": large["topo_radiality"]}
    extra["topo_screen"] = {
        "shape": shape, **{k: v for k, v in r2.items()
                           if k not in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")},
        "library": "torch.linalg.solve_ex of the 4096 re-formed B' "
                   "[4096, 118, 118] (forming excluded)",
        "detail_mesh118_x4096": small["topo_screen_DETAIL"],
        "mesh2000_x16384": large["topo_screen_SCREEN"],
        "refactor_us_per_variant_32": lib32,
        "smw_us_per_variant_32": smw32}
    return {"mesh2000": large, "mesh118": small}


# ---------------------------------------------------------------------------
# Phase 19: topology sweeps through run_topo_sweep
# ---------------------------------------------------------------------------


def same_topo(a, b, drop=()):
    """Two sweep summaries equal but for the timing keys (and ``drop``)."""
    from freedm_tpu_torch.pf.topo import strip_topo_timing

    def view(x):
        return json.dumps({k: v for k, v in strip_topo_timing(x).items()
                           if k not in drop}, sort_keys=True)

    return view(a) == view(b)


def check_shortlist(tag, summary, bridges=frozenset()):
    sl = summary["shortlist"]
    check(sl, f"{tag}: empty shortlist")
    for e in sl:
        check(e["ac_converged"], f"{tag}: AC lane not converged: {e}")
        check(e["ac_true_mismatch_pu"] < AC_TRUE_MISMATCH,
              f"{tag}: AC true mismatch {e['ac_true_mismatch_pu']:.3e}")
        check(not set(e["open_branches"]) & set(bridges),
              f"{tag}: a bridge in the shortlist: {e}")
    return max(e["ac_true_mismatch_pu"] for e in sl)


def topo_sweeps(torch, tk, tp, timed, dev="cuda"):
    """(a) the reference bench's gate shape: every rank-<=2 variant of
    mesh118 in chunks of 4096, top 8 by loss — variants/s beside the
    reference's floor, the AC verify of the top 8 apart, kill after 3 chunks
    and resume, chunks of 1024, the plain versions' shortlist, T1 and T2
    once a chunk; (b) full width: mesh2000, 65,536 neighborhood samples of
    rank <= 3 (seed 7) in four chunks of 16,384.  Returns T1's and T2's
    launches over (a)'s timed run."""
    import dataclasses
    import tempfile

    from freedm_tpu_torch.pf.n1 import secure_outages

    dev = torch.device(dev)

    def run(spec, **kw):
        return tp.run_topo_sweep(spec, device=dev, **kw)

    t_phase = time.monotonic()
    spec = tp.TopoSweepSpec(case="mesh118", max_rank=2, chunk_variants=4096,
                            top_k=8, objective="loss")
    first = run(spec)  # builds the verifier of the case
    tk.reset_launches()
    summary = run(spec)
    counts = tk.launches()
    modes = tk.mode_launches()["topo_screen"]
    n_chunks = summary["chunks_total"]
    check(summary["variants_total"] == 27966 and summary["completed"],
          f"topo sweep (a): {summary}")
    want = n_chunks if dev.type == "cuda" else 0
    check(counts == {"topo_radiality": want, "topo_screen": want}
          and modes["SCREEN"] == want,
          f"topo sweep (a): launches {counts} {modes} over {n_chunks} chunks")
    check(same_topo(first, summary), "topo sweep (a): a second run differs")
    sys_ = case_system("mesh118")
    bridges = set(range(sys_.n_branch)) - set(secure_outages(sys_))
    worst_ac = check_shortlist("topo sweep (a)", summary, bridges)
    check(len(summary["shortlist"]) == 8, "topo sweep (a): short shortlist")
    verifier = tp._cached_ac_verifier("mesh118", sys_, 8, device=dev)
    status = tp.status_from_slots(torch.as_tensor(np.array(
        [e["open_branches"] + [-1] * (2 - len(e["open_branches"]))
         for e in summary["shortlist"]], np.int32), device=dev),
        sys_.n_branch)
    verifier(status)
    sync(torch, dev)
    ts = []
    for _ in range(3):
        t0 = time.monotonic()
        verifier(status).v.cpu()
        ts.append((time.monotonic() - t0) * 1e3)
    ac_ms = float(np.median(ts))
    log(f"topo sweep (a): mesh118, {summary['variants_total']} rank<=2 "
        f"variants in {n_chunks} chunks of 4096: {summary['variants_per_sec']}"
        f" variants/s (wall {summary['wall_s']} s; the reference bench's "
        f"floor {TOPO_GATE_FLOOR}), disconnected {summary['disconnected']}, "
        f"islanded {summary['islanded']}; AC verify of the top 8: {ac_ms:.1f} "
        f"ms (median of 3), every lane converged, true mismatch <= "
        f"{worst_ac:.2e}, no bridge; T1 and T2 launched {counts} times")
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "topo.json")
        part = run(spec, checkpoint_path=ck, stop_after_chunks=3)
        check(part["completed"] is False and part["chunks_done"] == 3,
              f"topo sweep (a): the kill: {part}")
        resumed = run(spec, checkpoint_path=ck)
        check(resumed["resumed_from_chunk"] == 3
              and same_topo(resumed, summary),
              f"topo sweep (a): resumed {tp.strip_topo_timing(resumed)} vs "
              f"{tp.strip_topo_timing(summary)}")
    rechunked = run(dataclasses.replace(spec, chunk_variants=1024))
    check(same_topo(rechunked, summary, drop=("chunks_total",)),
          "topo sweep (a): chunks of 1024 differ from chunks of 4096")
    screen_only = dataclasses.replace(spec, ac_verify=False)
    mine = run(screen_only)
    plain = run(screen_only, plain=True)
    check([(e["open_branches"], e["gid"]) for e in mine["shortlist"]]
          == [(e["open_branches"], e["gid"]) for e in plain["shortlist"]]
          and same_topo(mine, plain, drop=("shortlist",)),
          f"topo sweep (a): the plain versions' shortlist differs: "
          f"{plain['shortlist']} vs {mine['shortlist']}")
    gap = max(abs(a["objective"] - b["objective"])
              for a, b in zip(mine["shortlist"], plain["shortlist"]))
    log(f"topo sweep (a): killed after 3 chunks and resumed, chunks of 1024: "
        f"equal; the plain versions' sweep: the same shortlist, objectives "
        f"within {gap:.1e}")

    spec_b = tp.TopoSweepSpec(case="mesh2000", max_rank=3,
                              search="neighborhood",
                              samples=TOPO_FULL_SAMPLES, seed=7,
                              chunk_variants=TOPO_FULL_CHUNK, top_k=8)
    t0 = time.monotonic()
    tp.sweep_variants(spec_b, case_system("mesh2000").n_branch)
    draw_s = time.monotonic() - t0
    chunk_s = []
    t0 = time.monotonic()
    big = run(spec_b,
              on_chunk=lambda done, total, s, real: chunk_s.append(s))
    total_s = time.monotonic() - t0
    check(big["completed"] and big["variants_total"] == TOPO_FULL_SAMPLES,
          f"topo sweep (b): {tp.strip_topo_timing(big)}")
    worst_b = check_shortlist("topo sweep (b)", big)
    k = timed["mesh2000"]
    t12 = (k["topo_radiality"]["ms"] + k["topo_screen_SCREEN"]["ms"])
    log(f"topo sweep (b): mesh2000 (4000 branches, Z^T 64 MB), "
        f"{TOPO_FULL_SAMPLES} neighborhood samples of rank <= 3 in "
        f"{big['chunks_total']} chunks of {TOPO_FULL_CHUNK}: "
        f"{big['variants_per_sec']} variants/s (wall {big['wall_s']} s; "
        f"{total_s:.2f} s with the builds, the draw and the AC verify); the "
        f"host draw {draw_s:.2f} s; chunk walls "
        + ", ".join(f"{s * 1e3:.1f}" for s in chunk_s)
        + f" ms, T1 + T2 on a chunk {t12:.2f} ms by events "
        f"({100 * t12 / (np.mean(chunk_s[1:] or chunk_s) * 1e3):.0f}% of a "
        f"later chunk's wall); T1 sweeps {k['topo_radiality']['sweeps_max']} "
        f"at most, mean {k['topo_radiality']['sweeps_mean']:.2f}; "
        f"disconnected {big['disconnected']}, islanded {big['islanded']}; "
        f"top {len(big['shortlist'])} verified, true mismatch <= "
        f"{worst_b:.2e} ({time.monotonic() - t_phase:.1f} s phase)")
    return counts


# ---------------------------------------------------------------------------
# Phase 20: the served topology workload and the sweep jobs
# ---------------------------------------------------------------------------


def serve_topo(torch, tk, tp, dev="cuda"):
    """The default server (cache on) with a ``JobManager``: ``POST
    /v1/topo`` on case14 at rank 2 and mesh118 (16 concurrent rank-1
    requests, after a ``/v1/pf`` request to mesh118: the engine adopts the
    cache entry's B′ LU, no second ``lu_factor``), the sync shortlist
    against ``run_topo_sweep``'s, a keyed mesh118 rank-2 sweep job
    cancelled mid-run and resubmitted, and an invalid spec.  Returns T1's
    and T2's launches on the sync path and the job path."""
    import tempfile

    from freedm_tpu_torch.pf.n1 import secure_outages
    from freedm_tpu_torch.scenarios.jobs import (JobManager,
                                                 parse_topo_job_request)
    from freedm_tpu_torch.serve.http import ServeServer
    from freedm_tpu_torch.serve.service import ServeConfig, Service

    t_phase = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        svc = Service(ServeConfig(device=dev))
        jm = JobManager(workers=1, checkpoint_dir=tmp, device=dev).start()
        server = ServeServer(svc, jobs=jm).start()
        port = server.port
        on_card = svc.device.type == "cuda"
        try:
            sweep14 = tp.run_topo_sweep(tp.TopoSweepSpec(
                case="case14", max_rank=2, top_k=4, ac_verify=False),
                device=dev)
            tk.reset_launches()
            status, r14 = post_json(port, "POST", "/v1/topo", {
                "case": "case14", "max_rank": 2, "timeout_s": 240})
            check(status == 200, f"POST /v1/topo case14: HTTP {status} {r14}")
            parts = (r14["n_feasible"] + r14["n_disconnected"]
                     + r14["n_nonradial"] + r14["n_islanded"])
            bridges = (set(range(20))
                       - set(secure_outages(case_system("case14"))))
            check(r14["n_variants"] == 210 and parts == 210
                  and r14["all_verified"] and len(r14["shortlist"]) == 4
                  and not any(set(e["open_branches"]) & bridges
                              for e in r14["shortlist"]),
                  f"POST /v1/topo case14: {r14}")
            check([e["open_branches"] for e in r14["shortlist"]]
                  == [e["open_branches"] for e in sweep14["shortlist"]],
                  "POST /v1/topo case14: the shortlist differs from "
                  "run_topo_sweep's")
            status, pf = post_json(port, "POST", "/v1/pf",
                                   {"case": "mesh118", "timeout_s": 240})
            check(status == 200 and pf["converged"],
                  f"POST /v1/pf mesh118: {status} {pf}")
            calls = []
            real = torch.linalg.lu_factor

            def counted(*a, **kw):
                calls.append(tuple(a[0].shape))
                return real(*a, **kw)

            torch.linalg.lu_factor = counted
            try:
                t0 = time.monotonic()
                status, r118 = post_json(port, "POST", "/v1/topo", {
                    "case": "mesh118", "max_rank": 1, "timeout_s": 240})
                build_s = time.monotonic() - t0
            finally:
                torch.linalg.lu_factor = real
            eng = svc.engine("topo", "mesh118")
            entry = svc.cache.entry("mesh118", eng._sys, "dense")
            check(status == 200 and r118["all_verified"],
                  f"POST /v1/topo mesh118: {status} {r118}")
            check(eng._lu is entry.precond.bp and (118, 118) not in calls,
                  f"the mesh118 topo engine factorized B' again: {calls}")

            def one(_):
                t0 = time.monotonic()
                st, body = post_json(port, "POST", "/v1/topo", {
                    "case": "mesh118", "max_rank": 1, "timeout_s": 240})
                return st, body, time.monotonic() - t0

            t0 = time.monotonic()
            with cf.ThreadPoolExecutor(16) as ex:
                out = list(ex.map(one, range(16)))
            wall = time.monotonic() - t0
            for st, body, _ in out:
                check(st == 200 and body["all_verified"]
                      and body["n_variants"] == 236
                      and body["shortlist"] == r118["shortlist"],
                      f"16 x POST /v1/topo mesh118: {st} {str(body)[:300]}")
            lat = np.array([x for _, _, x in out]) * 1e3
            sync_counts = tk.launches()
            check(all(c > 0 for c in sync_counts.values()) or not on_card,
                  f"POST /v1/topo: T1/T2 not launched: {sync_counts}")
            status, bad = post_json(port, "POST", "/v1/topo", {
                "case": "mesh118", "objective": "nope"})
            check(status == 400 and bad["error"]["type"] == "invalid_request",
                  f"an invalid topo spec: {status} {bad}")
            log(f"serve topo: case14 rank 2: 210 variants, counts partition, "
                f"top 4 verified and equal to run_topo_sweep's; mesh118 after "
                f"/v1/pf: the cache entry's B' LU adopted, no lu_factor "
                f"({build_s:.2f} s with the engine build); 16 concurrent "
                f"mesh118 rank-1 requests: p50 {np.percentile(lat, 50):.1f} "
                f"ms p99 {np.percentile(lat, 99):.1f} ms, "
                f"{16 / wall:.1f} requests/s; launches {sync_counts}; an "
                f"invalid spec 400")

            tk.reset_launches()
            payload = {"case": "mesh118", "max_rank": 2, "chunk_variants": 64,
                       "job_key": "sweep1"}
            status, d = post_json(port, "POST", "/v1/topo/sweep", payload)
            check(status == 202 and d["kind"] == "topo",
                  f"POST /v1/topo/sweep: {status} {d}")
            wait_job(port, d["job_id"], pred=lambda j: j["chunks_done"] >= 1)
            status, c = post_json(port, "POST",
                                  f"/v1/jobs/{d['job_id']}/cancel", {})
            check(status == 200, f"cancel: {status} {c}")
            j1 = wait_job(port, d["job_id"])
            ck = os.path.join(tmp, "topo_sweep1.json")
            check(j1["state"] == "cancelled" and j1["kind"] == "topo"
                  and os.path.exists(ck), f"sweep job after cancel: {j1}")
            _, d2 = post_json(port, "POST", "/v1/topo/sweep", payload)
            j2 = wait_job(port, d2["job_id"])
            job_counts = tk.launches()
            spec, _, _ = parse_topo_job_request(payload)
            direct = tp.run_topo_sweep(spec, device=dev)
            check(j2["state"] == "completed" and j2["kind"] == "topo"
                  and j2["resumed_from_chunk"] > 0
                  and same_topo(j2["summary"], direct),
                  f"sweep job resubmitted: {j2}")
            check(all(c > 0 for c in job_counts.values()) or not on_card,
                  f"the sweep job did not launch T1/T2: {job_counts}")
            status, bad = post_json(port, "POST", "/v1/topo/sweep",
                                    {"case": "mesh118", "max_rank": 9})
            check(status == 400, f"an invalid sweep job: {status} {bad}")
            log(f"serve topo: a keyed mesh118 rank-2 sweep job (437 chunks of "
                f"64) cancelled after chunk {j1['chunks_done']}, resubmitted: "
                f"resumed from chunk {j2['resumed_from_chunk']}, equal to a "
                f"direct run_topo_sweep; kind 'topo'; launches {job_counts}; "
                f"an invalid job 400 ({time.monotonic() - t_phase:.1f} s "
                f"phase)")
            return sync_counts, job_counts
        finally:
            server.stop()
            jm.stop()
            svc.stop()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from freedm_tpu_torch.kernels import build
    from freedm_tpu_torch.kernels import cache_kernels as ck
    from freedm_tpu_torch.kernels import ladder_kernels as lk
    from freedm_tpu_torch.kernels import newton_kernels as nk
    from freedm_tpu_torch.kernels import qsts_kernels as qk
    from freedm_tpu_torch.kernels import screen_kernels as sck
    from freedm_tpu_torch.kernels import sparse_kernels as sk
    from freedm_tpu_torch.kernels import topo_kernels as tk
    from freedm_tpu_torch.pf import topo as tp

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        build_kernels(torch, nk, sk, ck, sck, lk, qk, tk, build)
        errs = dict.fromkeys([*nk.LAUNCHES, *sk.LAUNCHES, *ck.LAUNCHES,
                              *sck.LAUNCHES, *lk.LAUNCHES, *qk.LAUNCHES,
                              *tk.LAUNCHES], 0.0)
        compare_kernels(torch, nk, errs)
        rows, extra = time_kernels(torch, nk)
        solve_mesh2000(torch, nk)
        solve_f32(torch, nk)
        compare_sparse_kernels(torch, sk, errs)
        sparse_rows, sparse_extra = time_sparse_kernels(torch, sk)
        rows.update(sparse_rows)
        extra.update(sparse_extra)
        solve_sparse(torch, nk, sk)
        counts = serve(torch, nk)
        sparse_counts, s1_modes = serve_default(torch, sk)
        counts.update(sparse_counts)
        extra["sparse_assemble"]["launches_by_mode"] = s1_modes
        cases = compare_delta_programs(torch, ck, errs, extra)
        delta_rows, delta_extra = time_delta(torch, ck, cases)
        rows.update(delta_rows)
        extra["delta_program"].update(delta_extra["delta_program"])
        counts.update(serve_cache(torch, ck, sk))
        compare_status_assemble(torch, sk, errs)
        compare_smw(torch, sck, errs)
        compare_dc(torch, sck, errs)
        time_screen_kernels(torch, sk, sck, rows, extra)
        counts.update(n1_screens(torch, sk, sck, nk))
        n1_counts, n1_status = serve_n1(torch, sk, sck, nk)
        counts["smw_sweep"] = n1_counts["smw_sweep"]
        extra["sparse_assemble"]["launches_n1_with_status"] = n1_status
        extra["smw_sweep"]["launches_path"] = "serve n1 phase"
        extra["dc_screen"]["launches_path"] = (
            "n1 screens phase: make_dc_solver and dc_prefilter")
        worst = compare_ladder(torch, errs)
        compare_ladder_vjp(torch, errs)
        time_ladder(torch, lk, rows, extra)
        extra["ladder_solve"]["max_abs_err_f32"] = worst["float32"]
        vvc_counts = vvc_phase(torch, lk)
        serve_counts = serve_vvc(torch, lk)
        counts["ladder_solve"] = serve_counts["ladder_solve"]
        counts["ladder_vjp"] = vvc_counts["ladder_vjp"]
        extra["ladder_solve"]["launches_path"] = (
            "serve vvc phase: 64 concurrent POST /v1/vvc")
        extra["ladder_solve"]["launches_vvc_step_10k_x64"] = (
            vvc_counts["ladder_solve"])
        extra["ladder_vjp"]["launches_path"] = (
            "vvc phase: one controller step on synthetic_radial(10000) x64")
        compare_a1(torch, qk, errs)
        compare_q(torch, qk, errs)
        time_qsts(torch, qk, rows, extra)
        counts.update(qsts_phase(torch, qk, lk))
        extra["agent_step"]["launches_path"] = (
            "qsts phase (c): the million-agent day on case_ieee30 x1, the "
            "engine's second run")
        extra["qsts_bus_reduce"]["launches_path"] = (
            "qsts phase (b): mesh2000 x64 x96 steps, sparse mixed")
        extra["qsts_feeder_reduce"]["launches_path"] = (
            "qsts phase (d): vvc_9bus x64 x96 steps, chunks of 24")
        serve_qsts(torch, qk)
        t_topo = time.monotonic()
        margin = compare_topo(torch, tk, tp, errs)
        timed = time_topo(torch, tk, tp, rows, extra)
        extra["topo_screen"].update(margin)
        log(f"topo: phase 18 {time.monotonic() - t_topo:.1f} s")
        t19 = time.monotonic()
        counts.update(topo_sweeps(torch, tk, tp, timed))
        log(f"topo: phase 19 {time.monotonic() - t19:.1f} s")
        t20 = time.monotonic()
        sync_counts, job_counts = serve_topo(torch, tk, tp)
        log(f"topo: phase 20 {time.monotonic() - t20:.1f} s; phases 18-20 "
            f"{time.monotonic() - t_topo:.1f} s")
        for name in tk.LAUNCHES:
            extra[name]["launches_path"] = (
                "topo sweeps phase (a): mesh118, every rank<=2 variant, "
                "chunks of 4096")
            extra[name]["launches_serve_sync"] = sync_counts[name]
            extra[name]["launches_serve_job"] = job_counts[name]
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    source = "freedm_tpu_torch/kernels/"
    meta = {
        "newton_assemble": ("cuda", source + "csrc/newton.cu",
                            "freedm_tpu/pf/newton.py:260"),
        "power_injections": ("cuda", source + "csrc/newton.cu",
                             "freedm_tpu/pf/newton.py:144"),
        "newton_update": ("cuda", source + "csrc/newton.cu",
                          "freedm_tpu/pf/newton.py:325"),
        "sparse_assemble": ("cuda", source + "csrc/sparse.cu",
                            "freedm_tpu/pf/sparse.py:307"),
        "sparse_matvec": ("cuda", source + "csrc/sparse.cu",
                          "freedm_tpu/pf/sparse.py:346"),
        "gmres_block_orth": ("cuda", source + "csrc/sparse.cu",
                             "freedm_tpu/pf/krylov.py:451"),
        "gmres_lstsq": ("cuda", source + "csrc/sparse.cu",
                        "freedm_tpu/pf/krylov.py:479"),
        "delta_program": ("cuda", source + "csrc/cache.cu",
                          "freedm_tpu/serve/cache.py:284"),
        "smw_sweep": ("cuda", source + "csrc/screen.cu",
                      "freedm_tpu/pf/n1.py:340"),
        "dc_screen": ("cuda", source + "csrc/screen.cu",
                      "freedm_tpu/pf/dc.py:145"),
        "ladder_solve": ("cuda", source + "csrc/ladder.cu",
                         "freedm_tpu/pf/ladder.py:184"),
        "ladder_vjp": ("cuda", source + "csrc/ladder.cu",
                       "freedm_tpu/pf/ladder.py:209"),
        "agent_step": ("cuda", source + "csrc/qsts.cu",
                       "freedm_tpu/scenarios/agents.py:459"),
        "qsts_bus_reduce": ("cuda", source + "csrc/qsts.cu",
                            "freedm_tpu/scenarios/engine.py:401"),
        "qsts_feeder_reduce": ("cuda", source + "csrc/qsts.cu",
                               "freedm_tpu/scenarios/engine.py:647"),
        "topo_radiality": ("cuda", source + "csrc/topo.cu",
                           "freedm_tpu/pf/topo.py:182"),
        "topo_screen": ("cuda", source + "csrc/topo.cu",
                        "freedm_tpu/pf/topo.py:455"),
    }
    table = []
    for name, (route, src, replaces) in meta.items():
        k, p, lib, b, by = rows[name]
        table.append({
            "name": name, "route": route, "source": src,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": errs[name], "ms": k, "plain_ms": p,
            "bound_ms": b, "bound_by": by, "library_ms": lib,
            **extra.get(name, {}),
        })
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
