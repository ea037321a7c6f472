#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``freedm_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card; builds the kernels from the sources in this
checkout and drives the served dense Newton power-flow path end to end.
Phases (any failure exits non-zero, and no result line is printed):

1. build: ``nvcc`` compiles ``freedm_tpu_torch/kernels/csrc/newton.cu``
   for ``sm_90a`` while Triton compiles K3; prints the build seconds and
   the ``-Xptxas -v`` report;
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
4. serve (the main path): ``ServeServer`` with ``pf_backend="dense"``
   and ``max_batch=64``; 64 concurrent ``POST /v1/pf`` per case to
   case14, case_ieee30, mesh118 and mesh2000 — every answer 200 and
   converged, at least one batch with more than one lane; prints p50/p99
   latency and solves/s per case.  Every kernel's launch count over this
   phase must be > 0.

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


def build_kernels(torch, nk, build):
    t0 = time.monotonic()
    box = {}

    def run_nvcc():
        try:
            box["path"] = build.build("newton")
        except Exception as e:  # noqa: BLE001 — re-raised on the main thread
            box["error"] = e

    th = threading.Thread(target=run_nvcc)
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
    th.join()
    if "error" in box:
        raise box["error"]
    nk._newton_lib()
    t_all = time.monotonic() - t0
    log(f"build: nvcc+triton {t_all:.1f} s (triton K3 {t_triton:.1f} s), "
        f"{box['path'].name}")
    log(build.build_log("newton").strip())


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
# Phase 4: the served path, POST /v1/pf
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


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from freedm_tpu_torch.kernels import build
    from freedm_tpu_torch.kernels import newton_kernels as nk

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
        build_kernels(torch, nk, build)
        errs = dict.fromkeys(nk.LAUNCHES, 0.0)
        compare_kernels(torch, nk, errs)
        rows = time_kernels(torch, nk)
        solve_mesh2000(torch, nk)
        solve_f32(torch, nk)
        counts = serve(torch, nk)
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
