#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``freedm_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card; builds the kernels from the sources in this
checkout and drives the served power-flow paths end to end: the dense
Newton backend (K1-K3) and the sparse one (S1-S4), which the default
server takes at 512 buses and more.
Phases (any failure exits non-zero, and no result line is printed):

1. build: two ``nvcc`` runs started together compile
   ``freedm_tpu_torch/kernels/csrc/newton.cu`` and ``sparse.cu`` for
   ``sm_90a`` while Triton compiles K3; prints the build seconds and the
   ``-Xptxas -v`` reports;
2. kernels: each kernel against its plain PyTorch version on the card at
   n ∈ {14, 30, 118, 2000} buses and B ∈ {1, 3, 64} lanes (float64,
   1e-10 absolute on J, f, P, Q — the sums run in another order; K3
   exactly), then each kernel's time (CUDA events) at the main path's
   shape (mesh2000, 64 lanes) beside its plain version's, its bound
   and, for K2, one ``torch.matmul`` of the complex pair; also the
   Newton step's library LU (``torch.linalg.solve_ex``) on K1's
   Jacobian, batched as the solver calls it and one lane at a time;
3. solve: ``make_newton_solver`` on mesh2000 over 64 lanes at load
   scales 0.5-1.2 — every lane converges, Σp (the losses) is small and
   non-negative, three lanes match the plain-version solve on the card
   within 1e-9 pu with identical iteration counts; then a float32 solve
   of mesh118 over 4 lanes, within 1e-4 pu of the float32 plain-version
   solve and of the float64 solve;
4. sparse kernels: S1-S4 against their plain versions at mesh118,
   mesh2000 and mesh5000, B ∈ {1, 3, 64} (B ≤ 8 at mesh5000), float64
   and float32, with a breakdown lane and a forced Cholesky failure
   (``SPARSE_TOL`` gives each tolerance and its reason); then their
   times at mesh2000 × 64 beside their plain versions, their bounds,
   the preconditioner apply and, for S2, one ``torch.sparse.mm`` over a
   block-diagonal CSR matrix of every lane's J;
5. sparse solves: mesh2000 × 64 in f64 and in mixed — every lane
   converges, losses ≥ 0, three lanes within 1e-9 pu of the plain-version
   sparse solve and 1e-6 pu of the dense solve — with launches per
   Newton step and a ``torch.profiler`` breakdown; then mesh5000 × 8 on
   the LU-kind preconditioner;
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
   the burst must be > 0.

The line before the last is the kernel table as one JSON object; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures as cf
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


def build_kernels(torch, nk, sk, build):
    t0 = time.monotonic()
    box = {}

    def run_nvcc(name):
        try:
            box[name] = (build.build(name), time.monotonic() - t0)
        except Exception as e:  # noqa: BLE001 — re-raised on the main thread
            box["error"] = e

    threads = [threading.Thread(target=run_nvcc, args=(name,))
               for name in ("newton", "sparse")]
    for th in threads:
        th.start()
    # Triton compiles K3 while nvcc runs (a short real launch).
    dev = torch.device("cuda")
    m = 28
    x = torch.zeros(2, m, dtype=torch.float64, device=dev)
    nk.newton_update(x, torch.ones_like(x), torch.ones_like(x),
                     torch.ones(m, dtype=torch.float64, device=dev),
                     torch.zeros(2, dtype=torch.int32, device=dev),
                     torch.zeros(2, dtype=torch.float64, device=dev),
                     torch.ones(2, dtype=torch.bool, device=dev), 4,
                     torch.zeros(1, dtype=torch.float64, device=dev))
    torch.cuda.synchronize()
    t_triton = time.monotonic() - t0
    for th in threads:
        th.join()
    if "error" in box:
        raise box["error"]
    nk._newton_lib()
    sk._sparse_lib()
    t_all = time.monotonic() - t0
    log(f"build: nvcc x2 + triton {t_all:.1f} s (triton K3 {t_triton:.1f} s, "
        f"newton.cu {box['newton'][1]:.1f} s, sparse.cu "
        f"{box['sparse'][1]:.1f} s), {box['newton'][0].name}, "
        f"{box['sparse'][0].name}")
    for name in ("newton", "sparse"):
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
    for fn in (nk.newton_update, nk.newton_update_plain):
        st = (x.clone(), it.clone(), err.clone(), active.clone())
        fn(st[0], dx, f, free, st[1], st[2], st[3], max_iter, tol)
        states.append(st)
    (xk, ik, ek, ak), (xp, ip, ep, ap) = states
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
    p = time_ms(torch, lambda: nk.newton_update_plain(
        xp, dx, f, free, *carries[1], big, tol), reps=100)
    rows["newton_update"] = (k, p, None, *bound(b3, o3))
    for name, (k, p, lib, b, by) in rows.items():
        log(f"timing: {name:<17} kernel {k:.4f} ms  plain {p:.4f} ms  "
            f"bound {b:.4f} ms ({by})"
            + (f"  library {lib:.4f} ms" if lib is not None else ""))
    return rows


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
SPARSE_CASES = (("mesh118", (1, 3, MAIN_LANES)),
                ("mesh2000", (1, 3, MAIN_LANES)),
                ("mesh5000", (1, 3, 8)))
KRYLOV_M, KRYLOV_S = 16, 4


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


def sparse_setup(torch, sys_, lanes, seed, dtype, pc=None):
    """Operands, a random state and scaled schedules for one case on the
    card, the FDLF pair (built once per case) and the M⁻¹ apply."""
    from freedm_tpu_torch.pf.krylov import build_fdlf_precond, fdlf_apply
    from freedm_tpu_torch.pf.sparse import sparse_operands

    dev = torch.device("cuda")
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


def gmres_captures(torch, sk, op, ev, bv, f, x, m_op):
    """The inputs of every S3 and S4 call of one plain GMRES cycle on the
    Newton system at x (lane 1, when there is one, has a zero right-hand
    side: its chain breaks down at once)."""
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
                      lambda u: m_op(u, x[:, n:]), b, m=KRYLOV_M,
                      s=KRYLOV_S, plain=True)
    finally:
        sk.gmres_block_orth_plain, sk.gmres_lstsq_plain = orth, lstsq
    return caps


def run_orth(fn, cap):
    _, vb, valid, w, j0 = cap
    vb, valid = vb.clone(), valid.clone()
    fn(vb, valid, w, j0)
    return vb, valid


def compare_sparse_kernels(torch, sk, errs):
    """S1-S4 against their plain versions at mesh118/2000/5000, several
    lane counts, float64 and float32, with a breakdown lane and a forced
    Cholesky failure (an inf in a candidate block: its lane's factor is
    all NaN, so the block must come out zero)."""
    for ci, (name, lane_counts) in enumerate(SPARSE_CASES):
        sys_ = case_system(name)
        pc = None
        for lanes in lane_counts:
            for dtype in (torch.float64, torch.float32):
                tol12, tol34 = SPARSE_TOL[str(dtype).split(".")[-1]]
                op, x, ps, qs, pc, m_op = sparse_setup(
                    torch, sys_, lanes, 10 * ci + lanes, dtype, pc)
                k1 = sk.sparse_assemble(x, ps, qs, op)
                p1 = sk.sparse_assemble_plain(x, ps, qs, op)
                e1 = worst(rel_abs_err(torch, a, b) for a, b in zip(k1, p1))
                ev, bv, f = p1
                u = torch.randn_like(x)
                e2 = rel_abs_err(torch, sk.sparse_matvec(ev, bv, u, op),
                                 sk.sparse_matvec_plain(ev, bv, u, op))
                caps = gmres_captures(torch, sk, op, ev, bv, f, x, m_op)
                e3 = e4 = (0.0, 0.0)
                for cap in caps:
                    if cap[0] == "orth":
                        cap = list(cap)
                        if lanes >= 3 and cap[4] == KRYLOV_S:
                            cap[3] = cap[3].clone()
                            cap[3][2, 0, 0] = float("inf")
                        vk, ak = run_orth(sk.gmres_block_orth, cap)
                        vp, ap = run_orth(sk.gmres_block_orth_plain, cap)
                        d_valid = float((ak - ap).abs().max())
                        e3 = worst([e3, rel_abs_err(torch, vk, vp),
                                    (d_valid, d_valid)])
                        if lanes >= 3 and cap[4] == KRYLOV_S:
                            rows = slice(cap[4] + 1, cap[4] + 1 + KRYLOV_S)
                            check(bool((vk[2, rows] == 0).all())
                                  and bool((ak[2, rows] == 0).all()),
                                  f"S3 kept a failed block on {name}")
                    else:
                        _, vb, valid, ws, zs, beta = cap
                        e4 = worst([e4, rel_abs_err(
                            torch, sk.gmres_lstsq(vb, valid, ws, zs, beta),
                            sk.gmres_lstsq_plain(vb, valid, ws, zs, beta))])
                torch.cuda.synchronize()
                log(f"sparse kernels: {name:>8} B={lanes:<3} {str(dtype)[6:]:<7}"
                    f" relative S1 {e1[0]:.1e}  S2 {e2[0]:.1e}  S3 {e3[0]:.1e}"
                    f"  S4 {e4[0]:.1e}")
                for kname, (rel, ab), tol in (
                        ("sparse_assemble", e1, tol12),
                        ("sparse_matvec", e2, tol12),
                        ("gmres_block_orth", e3, tol34),
                        ("gmres_lstsq", e4, tol34)):
                    check(rel <= tol, f"{kname} disagrees on {name} B={lanes} "
                                      f"{dtype}: {rel} > {tol}")
                    if dtype == torch.float64:
                        errs[kname] = max(errs[kname], ab)
                del k1, p1, ev, bv, f, caps
        del pc
        torch.cuda.empty_cache()


def sparse_library_matvec(torch, op, ev, bv):
    """One ``torch.sparse.mm`` of a block-diagonal CSR matrix holding every
    lane's J (from S1's values; pinned rows identity) — S2's library
    yardstick, built here and never called by the port."""
    lanes, n = ev.shape[0], op.n
    dev = ev.device
    f, t = op.f_idx.long(), op.t_idx.long()
    ar = torch.arange(n, device=dev)
    # (row, column, sign) of each of ev's eight rows, then bv's diagonals.
    entries = ((f, t, 1), (t, f, 1), (n + f, t, -1), (n + t, f, -1),
               (f, n + t, 1), (t, n + f, 1), (n + f, n + t, 1),
               (n + t, n + f, 1))
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


def time_sparse_kernels(torch, sk):
    """Each of S1-S4 at the main path's shape (mesh2000, 64 lanes,
    float64) against its plain version, its bound and, for S2, the
    library sparse product."""
    sys_ = case_system("mesh2000")
    lanes, n, m = MAIN_LANES, sys_.n_bus, sys_.n_branch
    nvec, w, iw = 2 * n, 8, 4
    op, x, ps, qs, pc, m_op = sparse_setup(torch, sys_, lanes, 3,
                                           torch.float64)
    rows = {}
    # S1: reads x, the schedules, the per-edge and per-bus operands and
    # the index arrays; writes ev, bv, f.  ~45 operations per edge and
    # lane (sincos ~20), ~25 per bus and lane plus 1 per incidence.
    b1 = (w * (lanes * nvec + 2 * lanes * n + 4 * m + 5 * n
               + 8 * lanes * m + 6 * lanes * n + lanes * nvec)
          + iw * (2 * m + n + 1 + 2 * m))
    o1 = lanes * (45 * m + 25 * n + 2 * m)
    k = time_ms(torch, lambda: sk.sparse_assemble(x, ps, qs, op), reps=50)
    p = time_ms(torch, lambda: sk.sparse_assemble_plain(x, ps, qs, op),
                reps=10)
    rows["sparse_assemble"] = (k, p, None, *bound(b1, o1))
    ev, bv, f = sk.sparse_assemble(x, ps, qs, op)
    # S2: reads u, ev, the four diagonals, masks and the incidence;
    # writes y.  4 FMAs (8 operations) per incidence and lane, 4 per row.
    u = torch.randn_like(x)
    b2 = (w * (lanes * nvec + 8 * lanes * m + 4 * lanes * n + 2 * n
               + lanes * nvec) + iw * (n + 1 + 4 * m))
    o2 = lanes * (2 * m * 8 + 8 * n)
    k = time_ms(torch, lambda: sk.sparse_matvec(ev, bv, u, op), reps=200)
    p = time_ms(torch, lambda: sk.sparse_matvec_plain(ev, bv, u, op),
                reps=20)
    csr = sparse_library_matvec(torch, op, ev, bv)
    ucol = u.reshape(-1, 1)
    e_lib = rel_abs_err(torch, (csr @ ucol).reshape(lanes, nvec),
                        sk.sparse_matvec(ev, bv, u, op))[0]
    check(e_lib <= 1e-12, f"library CSR product disagrees with S2: {e_lib}")
    lib = time_ms(torch, lambda: csr @ ucol, reps=50)
    rows["sparse_matvec"] = (k, p, lib, *bound(b2, o2))
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
    k = time_ms(torch, lambda: sk.gmres_block_orth(vk, ak, wb, j0), reps=50)
    p = time_ms(torch, lambda: sk.gmres_block_orth_plain(vp, ap, wb, j0),
                reps=10)
    rows["gmres_block_orth"] = (k, p, None, *bound(b3, o3))
    _, vb, valid, ws, zs, beta = caps[-1]
    mm = ws.shape[1]
    b4 = w * lanes * ((mm + 1) * nvec + (mm + 1) + 2 * mm * nvec + 1 + nvec)
    o4 = lanes * nvec * (2 * (mm + 1) * mm + 2 * mm)
    k = time_ms(torch, lambda: sk.gmres_lstsq(vb, valid, ws, zs, beta),
                reps=50)
    p = time_ms(torch, lambda: sk.gmres_lstsq_plain(vb, valid, ws, zs, beta),
                reps=10)
    rows["gmres_lstsq"] = (k, p, None, *bound(b4, o4))
    # The preconditioner apply (two bf16 products, a library call of the
    # port): reads the two [n, n] bf16 inverses and [B, 2n], writes [B, 2n].
    v = x[:, n:]
    t_apply = time_ms(torch, lambda: m_op(u, v), reps=100)
    b_apply = 2 * 2 * n * n + w * 2 * lanes * nvec
    log(f"timing: precond apply (2 x bf16 [{lanes}, {n}] x [{n}, {n}], "
        f"torch.matmul) {t_apply:.4f} ms  bound "
        f"{b_apply / PEAK_BYTES * 1e3:.4f} ms (bytes)")
    for name, (k, p, lib, b, by) in rows.items():
        log(f"timing: {name:<17} kernel {k:.4f} ms  plain {p:.4f} ms  "
            f"bound {b:.4f} ms ({by})"
            + (f"  library {lib:.4f} ms" if lib is not None else ""))
    del caps, vb, vk, vp
    torch.cuda.empty_cache()
    return rows


def profile_solve(torch, fn, label, top=8):
    """One more run of ``fn`` under ``torch.profiler``: device time by
    kernel and the device's busy share of the wall.  Only the kernel
    events count (an aten op's own row repeats its kernels' time); their
    times are summed, so overlap would count twice — this path runs on
    one stream."""
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
        return
    log(f"profile: {label}: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%, idle "
        f"{100 - 100 * busy / wall_us:.1f}%)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"profile:   {e.self_device_time_total / 1e3:8.2f} ms "
            f"{e.count:6d}x  {e.key[:90]}")


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
        its = r.iterations.cpu().numpy()
        conv = r.converged.cpu().numpy()
        losses = r.p.sum(dim=1).cpu().numpy()
        log(f"solve: sparse {prec:<5} mesh2000 x{MAIN_LANES} in "
            f"{wall * 1e3:.1f} ms ({MAIN_LANES / wall:.1f} lane-solves/s), "
            f"iterations {its.min()}-{its.max()}, fallbacks "
            f"{int(r.fallbacks.sum())}, max mismatch "
            f"{float(r.mismatch.max()):.2e}, losses {losses.min():.4f}-"
            f"{losses.max():.4f} pu, launches {counts}")
        steps = counts["gmres_lstsq"]  # one GMRES cycle per batched step
        log(f"solve: sparse {prec:<5} {steps} batched Newton steps; launches "
            f"per step " + ", ".join(
                f"{k} {v / max(steps, 1):g}" for k, v in counts.items() if v))
        profile_solve(torch, lambda: solve(p_inj=p, q_inj=q),
                      f"sparse {prec} mesh2000 x{MAIN_LANES}")
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

    svc = Service(ServeConfig(max_batch=MAIN_LANES, pf_backend="dense",
                              device="cuda"))
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

    svc = Service(ServeConfig(max_batch=MAIN_LANES, device="cuda"))
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
        log(f"serve default: launches {counts}")
        check(svc.engine("pf", "mesh2000").pf_backend == "sparse",
              "the default server did not take the sparse backend")
        check(max(lanes) > 1, "no batch coalesced more than one request")
        check(all(c > 0 for c in counts.values()),
              f"a sparse kernel was not launched on the served path: {counts}")
        return counts
    finally:
        server.stop()
        svc.stop()


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from freedm_tpu_torch.kernels import build
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
        build_kernels(torch, nk, sk, build)
        errs = dict.fromkeys([*nk.LAUNCHES, *sk.LAUNCHES], 0.0)
        compare_kernels(torch, nk, errs)
        rows = time_kernels(torch, nk)
        solve_mesh2000(torch, nk)
        solve_f32(torch, nk)
        compare_sparse_kernels(torch, sk, errs)
        rows.update(time_sparse_kernels(torch, sk))
        solve_sparse(torch, nk, sk)
        counts = serve(torch, nk)
        counts.update(serve_default(torch, sk))
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    source = "freedm_tpu_torch/kernels/"
    meta = {
        "newton_assemble": ("cuda", source + "csrc/newton.cu",
                            "freedm_tpu/pf/newton.py:260"),
        "power_injections": ("cuda", source + "csrc/newton.cu",
                             "freedm_tpu/pf/newton.py:144"),
        "newton_update": ("triton", source + "newton_update_triton.py",
                          "freedm_tpu/pf/newton.py:325"),
        "sparse_assemble": ("cuda", source + "csrc/sparse.cu",
                            "freedm_tpu/pf/sparse.py:307"),
        "sparse_matvec": ("cuda", source + "csrc/sparse.cu",
                          "freedm_tpu/pf/sparse.py:346"),
        "gmres_block_orth": ("cuda", source + "csrc/sparse.cu",
                             "freedm_tpu/pf/krylov.py:451"),
        "gmres_lstsq": ("cuda", source + "csrc/sparse.cu",
                        "freedm_tpu/pf/krylov.py:479"),
    }
    table = []
    for name, (route, src, replaces) in meta.items():
        k, p, lib, b, by = rows[name]
        table.append({
            "name": name, "route": route, "source": src,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": errs[name], "ms": k, "plain_ms": p,
            "bound_ms": b, "bound_by": by, "library_ms": lib,
        })
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
