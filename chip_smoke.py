#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``freedm_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card; builds the kernels from the sources in this
checkout and drives the served power-flow paths end to end: the dense
Newton backend (K1-K3), the sparse one (S1-S4), which the default
server takes at 512 buses and more, and the serving cache's delta tier
(C1).
Phases (any failure exits non-zero, and no result line is printed):

1. build: three ``nvcc`` runs started together compile
   ``freedm_tpu_torch/kernels/csrc/newton.cu``, ``sparse.cu`` and
   ``cache.cu`` for ``sm_90a``; prints the build seconds and the ``-Xptxas -v`` reports;
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
   block-diagonal CSR matrix of every lane's J — S1 in each mode, all in
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
8. serve cache: C1 against its plain version in every mode at mesh118,
   mesh2000 and mesh5000, B ∈ {1, 8} (``DELTA_TOL``), bit-identical on
   repeat, and its times per mode at mesh2000 × 1; then the default
   server with the cache on at mesh2000 (:func:`serve_cache`): exact,
   delta, warm and fall-through answers, deltas while a 64-request
   burst is in flight, every answer within ``CACHE_ATOL`` of a
   ``cache_mb=0`` service; C1's launch count over it must be > 0.

The line before the last is the kernel table as one JSON object (K3,
S1-S4 also carry ``device_ms``, S1-S4 float32 ``*_f32`` times, S1 its
other modes' ``*_values_f32``/``*_residual`` times and bounds and its
served launches by mode, ``launches_by_mode``); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import http.client
import json
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


def build_kernels(torch, nk, sk, ck, build):
    t0 = time.monotonic()
    box = {}

    def run_nvcc(name):
        try:
            box[name] = (build.build(name), time.monotonic() - t0)
        except Exception as e:  # noqa: BLE001 — re-raised on the main thread
            box["error"] = e

    threads = [threading.Thread(target=run_nvcc, args=(name,))
               for name in ("newton", "sparse", "cache")]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if "error" in box:
        raise box["error"]
    nk._newton_lib()
    sk._sparse_lib()
    ck._cache_lib()
    t_all = time.monotonic() - t0
    log(f"build: nvcc x3 {t_all:.1f} s (newton.cu {box['newton'][1]:.1f} s, "
        f"sparse.cu {box['sparse'][1]:.1f} s, cache.cu "
        f"{box['cache'][1]:.1f} s), {box['newton'][0].name}, "
        f"{box['sparse'][0].name}, {box['cache'][0].name}")
    for name in ("newton", "sparse", "cache"):
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


def compare_assemble(torch, sk, op, x, ps, qs, label):
    """S1 in each of its modes against its plain version (each output at
    ``SPARSE_TOL`` of its own dtype), twice on identical inputs (identical
    bits), and the modes against each other bit for bit: ``VALUES_F32``'s
    ``ev``/``bv`` are ``FULL``'s cast to float32 and its ``f`` is
    ``FULL``'s; ``RESIDUAL``'s ``p``, ``q``, ``f`` are ``FULL``'s ``bv[:,
    4]``, ``bv[:, 5]`` and ``f``; the bus role's P and Q are the ordered
    sums of the c/a values the edge role wrote (:func:`ordered_bus_sums`).
    Returns the worst ``(rel, abs)`` over the outputs in ``x``'s dtype."""
    modes = [sk.FULL, sk.RESIDUAL]
    if x.dtype == torch.float64:
        modes.append(sk.VALUES_F32)
    out, errs = {}, []
    for mode in modes:
        k = sk.sparse_assemble(x, ps, qs, op, mode)
        check(all(same_bits(torch, a, b) for a, b in zip(
            k, sk.sparse_assemble(x, ps, qs, op, mode))),
            f"S1 mode {mode} not bit-identical on repeat: {label}")
        for a, b in zip(k, sk.sparse_assemble_plain(x, ps, qs, op, mode)):
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
    ps_, qs_ = ordered_bus_sums(torch, op, ev, x)
    check(same_bits(torch, ps_, bv[:, 4].contiguous())
          and same_bits(torch, qs_, bv[:, 5].contiguous()),
          f"S1's P/Q are not the ordered sums of its edge values: {label}")
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
    library sparse product, by CUDA events and by device time; S2-S4
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
        if f64:
            rows["gmres_lstsq"] = (k, p, None, b, by)
        else:
            extra["gmres_lstsq"].update(
                ms_f32=k, plain_ms_f32=p, bound_ms_f32=b, library_ms_f32=None)
        extra["gmres_lstsq"]["device_ms" + sfx] = k_dev
        log(f"timing: gmres_lstsq{sfx:<4}      kernel {k:.4f} ms (device "
            f"{k_dev:.4f})  plain {p:.4f} ms  bound {b:.4f} ms ({by})  "
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

#: C1 against its plain version: 1e-10 absolute on dp, dq, P, Q and err
#: (bus sums of terms up to ~1e2 pu at mesh5000, whose plain version on
#: the card adds with index_add_ in another order); the corrected half,
#: it and active exactly (the same rounded operations); the float32
#: copies bit for bit against the kernel's own dp or dq cast, and within
#: one float32 rounding of the plain version's.
DELTA_TOL = 1e-10
DELTA_CASES = (("mesh118", (1, 8)), ("mesh2000", (1, 8)),
               ("mesh5000", (1, 8)))
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


def delta_inputs(torch, sys_, lanes, seed, dev="cuda"):
    """Random states, schedules and a correction for C1 on the card."""
    rng = np.random.default_rng(seed)
    n = sys_.n_bus

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                               device=dev)

    return (t(rng.uniform(-0.3, 0.3, (lanes, n))),
            t(rng.uniform(0.9, 1.1, (lanes, n))),
            t(rng.normal(size=(lanes, n)) * 0.1),
            t(rng.normal(size=(lanes, n)) * 0.1),
            t(rng.normal(size=(lanes, n)) * 1e-3))


def compare_delta(torch, ck, op, theta, v, ps, qs, s, label):
    """C1 in every mode — INIT, THETA and V with a float64 and a float32
    correction, with and without the float32 copy, and PQ — against its
    plain version (``DELTA_TOL``), run twice (identical bits), with lane 1
    frozen (when there is one) and lane 0 reaching ``max_sweeps`` in V.
    Returns the largest difference."""
    lanes = theta.shape[0]
    max_sweeps, tol = 5, 1e-8
    worst_err = 0.0

    def state0(mode):
        st = ck.new_state(lanes, theta.device)
        if mode != ck.INIT:
            st.active.fill_(True)
            if lanes > 1:
                st.active[1] = False
            st.it.fill_(1)
            st.it[0] = max_sweeps - 1
            st.err.fill_(7.0)
        return st

    def close(k, p, what):
        nonlocal worst_err
        d = max_err(k, p)
        scale = max(1.0, float(p.abs().max()))
        worst_err = max(worst_err, d)
        check(d <= DELTA_TOL * scale,
              f"C1 {label}: {what} off its plain version by {d:.3e}")

    configs = [(ck.INIT, None, False), (ck.INIT, None, True), (ck.PQ, None, False)]
    for mode in (ck.THETA, ck.V):
        for sdt in (torch.float64, torch.float32):
            for lo in (False, True):
                configs.append((mode, s.to(sdt), lo))
    for mode, s_, lo in configs:
        name = f"{ck._MODE_NAMES[mode]}" + (
            "" if s_ is None else f" s {str(s_.dtype)[6:]}") + (
            " lo" if lo else "")
        st_k, st_k2, st_p = state0(mode), state0(mode), state0(mode)
        args = dict(s=s_, lo=lo, max_sweeps=max_sweeps, tol=tol)
        out_k = ck.delta_mismatch(mode, theta, v, ps, qs, op, state=st_k,
                                  **args)
        out_k2 = ck.delta_mismatch(mode, theta, v, ps, qs, op, state=st_k2,
                                   **args)
        out_p = ck.delta_mismatch_plain(mode, theta, v, ps, qs, op,
                                        state=st_p, **args)
        torch.cuda.synchronize()
        for a, b in zip(out_k + st_k, out_k2 + st_k2):
            check((a is None and b is None) or torch.equal(a, b),
                  f"C1 {label} {name}: not bit-identical on repeat")
        x_k, a_k, b_k, lo_k = out_k
        x_p, a_p, b_p, lo_p = out_p
        if x_p is not None:
            check(torch.equal(x_k, x_p),
                  f"C1 {label} {name}: corrected half differs")
        close(a_k, a_p, f"{name} dp/P")
        close(b_k, b_p, f"{name} dq/Q")
        if lo:
            want = (b_k if mode == ck.THETA else a_k).float()
            check(torch.equal(lo_k, want),
                  f"C1 {label} {name}: float32 copy is not its cast")
            d32 = float(((lo_k.double() - lo_p.double()).abs()
                         - lo_p.double().abs() * 2.0 ** -23).max())
            check(d32 <= DELTA_TOL * max(1.0, float(lo_p.abs().max())),
                  f"C1 {label} {name}: float32 copy off by {d32:.3e}")
        else:
            check(lo_k is None and lo_p is None, f"C1 {label} {name}: lo")
        if mode != ck.PQ:
            close(st_k.err, st_p.err, f"{name} err")
            check(torch.equal(st_k.it, st_p.it)
                  and torch.equal(st_k.active, st_p.active),
                  f"C1 {label} {name}: lane bookkeeping differs: "
                  f"{st_k.it.tolist()} {st_k.active.tolist()} vs "
                  f"{st_p.it.tolist()} {st_p.active.tolist()}")
            if mode == ck.V:
                check(not bool(st_k.active[0]) and int(st_k.it[0]) == max_sweeps,
                      f"C1 {label} {name}: lane 0 did not stop at max_sweeps")
                if lanes > 1:
                    check(int(st_k.it[1]) == 1 and float(st_k.err[1]) == 7.0,
                          f"C1 {label} {name}: a frozen lane moved")
    return worst_err


def compare_delta_kernels(torch, ck, errs):
    """C1 against its plain version at mesh118, mesh2000 and mesh5000,
    B ∈ {1, 8}."""
    from freedm_tpu_torch.pf.mfree import delta_operands

    for ci, (name, lane_counts) in enumerate(DELTA_CASES):
        sys_ = case_system(name)
        op = delta_operands(sys_, device="cuda")
        for lanes in lane_counts:
            args = delta_inputs(torch, sys_, lanes, seed=300 + 10 * ci + lanes)
            e = compare_delta(torch, ck, op, *args, f"{name} B={lanes}")
            errs["delta_mismatch"] = max(errs["delta_mismatch"], e)
            log(f"cache kernels: C1 {name:>8} B={lanes}  every mode vs plain "
                f"{e:.2e} (bit-identical on repeat)")


def time_delta(torch, ck):
    """C1 at the served path's shape (mesh2000, one lane, the mixed
    program's float32 correction and copies) in each mode, by CUDA events
    and device time, beside its plain version and its bound.  The V mode
    (the one that also reduces and updates the lane) is the table row."""
    from freedm_tpu_torch.pf.mfree import delta_operands

    sys_ = case_system("mesh2000")
    n, m = sys_.n_bus, sys_.n_branch
    op = delta_operands(sys_, device="cuda")
    theta, v, ps, qs, s = delta_inputs(torch, sys_, 1, seed=41)
    s32 = s.float()
    st = ck.new_state(1, theta.device)
    st.active.fill_(True)
    extra = {}
    row = None
    # Every mode reads θ, V and the shunts (8 B per bus each), the
    # incidence list (4 B per bus, 8 B per entry, 2m entries) and the
    # branch admittances (8 rows of m), and writes two [n] float64
    # outputs (dp, dq or P, Q); the mismatch modes also read the
    # schedules and masks (4 × 8 B per bus), write the float32 copy and
    # the lane's carry (13 B); THETA and V also read s (float32) and write
    # the corrected half.  Operations: ~50 per list entry (a sincos ~20,
    # the four complex products and the sums), ~20 per bus.
    base = 4 * 8 * n + 4 * (n + 1) + 8 * 2 * m + 8 * 8 * m + 16 * n
    for mode in (ck.INIT, ck.THETA, ck.V, ck.PQ):
        name = ck._MODE_NAMES[mode]
        corr = mode in (ck.THETA, ck.V)
        s_ = s32 if corr else None
        b1 = base + (32 * n + 4 * n + 13 if mode != ck.PQ else 0) + (
            4 * n + 8 * n if corr else 0)
        o1 = 50 * 2 * m + 20 * n

        # tol 0 and no sweep limit: the lane stays active in every call.
        def call(mode=mode, s_=s_):
            return ck.delta_mismatch(mode, theta, v, ps, qs, op, s_, st,
                                     lo=mode != ck.PQ, max_sweeps=1 << 30,
                                     tol=0.0)

        def plain(mode=mode, s_=s_):
            return ck.delta_mismatch_plain(mode, theta, v, ps, qs, op, s_, st,
                                           lo=mode != ck.PQ,
                                           max_sweeps=1 << 30, tol=0.0)

        k = time_ms(torch, call, reps=200)
        k_dev = device_ms_by_kernel(torch, call, reps=50)
        k_c1 = sum(t for key, t in k_dev.items() if "delta_mismatch" in key)
        p = time_ms(torch, plain, reps=20)
        b, by = bound(b1, o1)
        extra.update({f"ms_{name}": k, f"device_ms_{name}": k_c1,
                      f"plain_ms_{name}": p, f"bound_ms_{name}": b})
        log(f"timing: delta_mismatch {name:<6} kernel {k:.4f} ms (device "
            f"{k_c1:.4f})  plain {p:.4f} ms  bound {b:.5f} ms ({by}, "
            f"{b1 / 1e6:.3f} MB)")
        if mode == ck.V:
            row = (k, p, None, b, by)
            extra["device_ms"] = k_c1
    return {"delta_mismatch": row}, {"delta_mismatch": extra}


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
        for j in rng.choice(sys_.n_bus, size=int(rng.integers(1, 17)),
                            replace=False):
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
    request's cache tier raised (``/stats`` ``errors`` 0).  Then the delta program's wall per
    answer in two turns (identical results) and a profiled answer's device
    time per sweep, split into C1 and the triangular solves.  Returns C1's
    launches over the served requests.  (``dev`` and ``case`` let a
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
        c1_modes = ck.mode_launches()
        s_counts = sk.launches()
        stats = svc.stats()["cache"]
        log(f"serve cache: launches C1 {c1_counts} by mode {c1_modes}, "
            f"S1-S4 {s_counts}; cache {json.dumps(stats)}")
        check(not card or c1_counts["delta_mismatch"] > 0,
              "C1 was not launched on the served delta path")
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
                out = program(near.theta, near.v, p, q)
                outs.append(tuple(o.cpu() for o in out))
        return (time.monotonic() - t0) / len(deltas) * 1e3, outs

    walls = []
    ref_outs = None
    for _ in range(2):
        w, outs = run_all()
        walls.append(w)
        if ref_outs is None:
            ref_outs = outs
        check(all(torch.equal(a, b) for o1, o2 in zip(outs, ref_outs)
                  for a, b in zip(o1, o2)),
              "the delta program is not bit-identical on repeat")
    sweeps = [int(o[5]) for o in ref_outs]
    log(f"serve cache: delta program sweeps {sweeps} (mean "
        f"{np.mean(sweeps):.2f}); wall per answer {walls[0]:.3f} / "
        f"{walls[1]:.3f} ms (two turns, identical results)")
    from torch.profiler import ProfilerActivity, profile

    p, q = deltas[0]
    with on_stream():
        program(near.theta, near.v, p, q)[0].cpu()
        if card:
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            out = program(near.theta, near.v, p, q)
            nsw = int(out[5].cpu())
            wall = (time.monotonic() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and getattr(e, "self_device_time_total", 0) > 0]
    c1_us = sum(e.self_device_time_total for e in events
                if "delta_mismatch" in e.key)
    other_us = sum(e.self_device_time_total for e in events
                   if "delta_mismatch" not in e.key)
    log(f"serve cache: profiled delta answer, {nsw} sweeps: wall {wall:.3f} "
        f"ms ({wall / max(nsw, 1):.3f} ms a sweep); device C1 "
        f"{c1_us / 1e3:.4f} ms ({c1_us / 1e3 / max(nsw, 1):.4f} a sweep), "
        f"triangular solves and copies {other_us / 1e3:.4f} ms "
        f"({other_us / 1e3 / max(nsw, 1):.4f} a sweep)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"profile:   {e.self_device_time_total / 1e3:8.4f} ms "
            f"{e.count:6d}x  {e.key[:240]}")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from freedm_tpu_torch.kernels import build
    from freedm_tpu_torch.kernels import cache_kernels as ck
    from freedm_tpu_torch.kernels import newton_kernels as nk
    from freedm_tpu_torch.kernels import sparse_kernels as sk

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
        build_kernels(torch, nk, sk, ck, build)
        errs = dict.fromkeys([*nk.LAUNCHES, *sk.LAUNCHES, *ck.LAUNCHES], 0.0)
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
        compare_delta_kernels(torch, ck, errs)
        delta_rows, delta_extra = time_delta(torch, ck)
        rows.update(delta_rows)
        extra.update(delta_extra)
        counts.update(serve_cache(torch, ck, sk))
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
        "delta_mismatch": ("cuda", source + "csrc/cache.cu",
                           "freedm_tpu/serve/cache.py:284"),
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
