#!/usr/bin/env python3
"""Time S1 ``sparse_assemble`` (each mode), S2 ``sparse_matvec``, S3
``gmres_block_orth``, S4 ``gmres_lstsq``, K3 ``newton_update``, K1
``newton_assemble``, K2 ``power_injections``, I1 ``cim_iterate``, F1
``fdlf_half_step`` in its tile mode and the serving cache's delta program
(C1) of this checkout against those of other checkouts of the repo, in
turns on one card.

    python3 kernel_ab.py OTHER [OTHER ...]
                         [--sections sparse,delta,newton,solvers]
                         [--out FILE]

Each ``OTHER`` is the root of another checkout, for example one written
by ``git archive <commit> | tar -x -C _archive/parent`` into a directory
that ``.gitignore`` lists.  Every turn runs in a process of its own with
one checkout first on ``sys.path`` and calls that checkout's own
wrappers, whose kernels build there at first use: the checkouts may
differ in their kernels' C signatures, routes and layouts, not in the
wrappers' Python ones.  The inputs are made once, in this checkout, at
mesh2000 × 64 lanes in float64 and float32 — those ``chip_smoke.py``
times: a state ``x`` with its schedules, a random vector ``u``, S3 at the
last block of a real GMRES cycle (j0 = 12, s = 4), S4 at that cycle's
finish (mm = 16), K3 on a random step of every lane (each timed call
updates every lane: ``max_iter`` is never reached and ``tol`` is 0) —
and every turn reads them.  Each checkout fills S2's values with its own
S1 from the same ``x``, so checkouts whose S1 writes another layout time
S2 on the same function.  S1 is timed in each of its modes; a checkout
whose S1 has no modes (before they came) is timed on what its solver ran
in their place: the full fill, plus two float32 casts of ``ev`` and
``bv`` for ``values_f32``, and the full fill read for P, Q and f for
``residual``.  For each ``OTHER`` the turns run OTHER, this, this, OTHER;
each turn gives the mean of CUDA events over back-to-back calls (wrapper
included) and the mean device time from ``torch.profiler`` (the kernels
alone), and one default mesh2000 × 64 sparse solve in f64 and in
mixed is profiled (Newton steps, device operations, device busy and wall
time).  Each ``OTHER``'s outputs must agree with this checkout's within
``chip_smoke.SPARSE_TOL`` (K3 exactly): S1's P, Q and f, S2's y, S3's
block and S4's update; whether S1's outputs (P, Q, f and the full fill's
values) are the same bits is reported as ``sparse_assemble_same_bits``.

The ``delta`` section times each checkout's delta program as the serving
cache builds it (``serve.cache._build_delta_program`` over its own
``build_fdlf_precond(kind="lu")``) at mesh2000 × {1, 8} lanes, f64 and
mixed, on 8 random 1-16-bus deltas from a converged base made once here:
the wall per program with its results on the host (one answer's device
work, host calls and copies), and from ``torch.profiler`` its device time,
device operations and CUDA runtime calls per program.  The checkouts'
theta and v must agree within ``chip_smoke.CACHE_ATOL`` with sweep counts
at most one apart (each turn factorizes the pair anew, and cuSOLVER's
factors may differ in the last bits between processes).

The ``newton`` section times K1 and K2 at mesh2000 × 64 lanes in
float64 with one Ybus for every lane (the dense backend without a branch
status), on the state ``chip_smoke.newton_inputs`` makes once here: CUDA
events over back-to-back calls and device time, K1's from the profiler
as above, K2's from queued events (``chip_smoke.queued_events_ms``).  The
checkouts' K1 Jacobians and mismatches must be the same bits
(``newton_same_bits``); K2's P, Q and mismatch agree within
``chip_smoke.KERNEL_ATOL`` (its product's summation order is not a
contract: ``power_injections_max_abs`` is printed, and
``power_injections_same_bits``).

The ``solvers`` section times I1 on the CIM feeder × 64 lanes
(``chip_smoke.cim_feeder``, one fixed iteration a call, the operands
``chip_smoke._cim_operands`` forms) and F1's V half in its tile mode at
mesh118 × 1024 lanes (one Ybus, the reference bench's Monte-Carlo
batch), float64: CUDA events over back-to-back calls, and device time
from CUDA events around each call queued behind a sleep kernel
(``chip_smoke.queued_events_ms``: the profiler's I1 times come back
short).  Each checkout's I1 iteration (v_new, err, it) and F1's three
modes (x, dp, dq, err, it) from the same inputs agree within
``KERNEL_ATOL`` (``*_max_abs``, ``*_same_bits`` printed).

Prints the card's name and power limit, one line per turn and a JSON
summary as the last line (also written to ``--out``).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
DTYPES = ("float64", "float32")
KERNELS = ("sparse_assemble", "sparse_assemble_values_f32",
           "sparse_assemble_residual", "sparse_matvec", "gmres_block_orth",
           "gmres_lstsq", "newton_update")
SECTIONS = ("sparse", "delta", "newton", "solvers")
SOLVER_KERNELS = ("cim_iterate", "fdlf_half_step")
#: F1's tile-mode lanes in the ``solvers`` section (``bench_mc_1024``).
F1_LANES = 1024
NEWTON_KERNELS = ("newton_assemble", "power_injections")
DELTA_LANES = (1, 8)
DELTA_PRECISIONS = ("f64", "mixed")


def _smoke():
    """This checkout's ``chip_smoke`` helpers, whatever checkout's package
    comes first on ``sys.path`` (they import it lazily)."""
    spec = importlib.util.spec_from_file_location("_ab_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def prepare(path: Path, sections) -> None:
    import torch

    cs = _smoke()
    from freedm_tpu_torch.kernels import cache_kernels as ck
    from freedm_tpu_torch.kernels import sparse_kernels as sk

    sys_ = cs.case_system("mesh2000")
    data = {}
    if "newton" in sections:
        data["newton"] = [a.cpu() for a in cs.newton_inputs(
            torch, sys_, cs.MAIN_LANES, seed=7)]
    if "solvers" in sections:
        data["solvers"] = solver_inputs(torch, cs)
    if "delta" in sections:
        case = cs.DeltaCase(torch, ck, "mesh2000")
        data["delta"] = [np.asarray(a) for a in case.inputs(
            max(DELTA_LANES), seed=77)]
    for name in DTYPES if "sparse" in sections else ():
        dtype = getattr(torch, name)
        op, x, ps, qs, _, m_op = cs.sparse_setup(torch, sys_, cs.MAIN_LANES,
                                                 3, dtype)
        ev, bv, f = sk.sparse_assemble(x, ps, qs, op)
        u = torch.randn_like(x)
        caps = cs.gmres_captures(torch, sk, op, ev, bv, f, x, m_op)
        _, vb, valid, w, j0 = [c for c in caps if c[0] == "orth"][-1]
        _, lvb, lvalid, ws, zs, beta = [c for c in caps
                                        if c[0] == "lstsq"][-1]
        data[name] = {"u": u, "vb": vb, "valid": valid, "w": w,
                      "j0": int(j0), "lvb": lvb, "lvalid": lvalid, "ws": ws,
                      "zs": zs, "beta": beta, "x": x, "ps": ps, "qs": qs,
                      "dx": 1e-12 * torch.randn_like(x), "f": f,
                      "free": torch.cat([op.th_free, op.v_free])}
        data[name] = {k: v.cpu() if torch.is_tensor(v) else v
                      for k, v in data[name].items()}
    torch.save(data, path)


def solver_inputs(torch, cs) -> dict:
    """I1's arguments on the CIM feeder × ``cs.CIM_LANES`` and F1's at
    mesh118 × ``F1_LANES`` (one Ybus), on the CPU."""
    from freedm_tpu_torch.grid.bus import ybus_dense
    from freedm_tpu_torch.pf.sparse import sparse_operands

    cpu = torch.device("cpu")
    f, ties = cs.cim_feeder()
    cim = cs._cim_operands(torch, f, ties, cs.cim_loads(f, cs.CIM_LANES),
                           cpu)
    sys_ = cs.case_system("mesh118")
    n = sys_.n_bus
    rng = np.random.default_rng(118)
    y = ybus_dense(sys_, dtype=torch.float64, device=cpu)
    sop = sparse_operands(sys_, dtype=torch.float64, device=cpu)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64)

    x = torch.cat([t(rng.normal(0, 0.1, (F1_LANES, n))),
                   t(rng.uniform(0.95, 1.05, (F1_LANES, n)))], 1)
    ps = t(rng.normal(size=(F1_LANES, n)))
    return {"cim": cim, "f1": {
        "x": x, "y": y, "ps": ps, "qs": 0.3 * ps, "thf": sop.th_free,
        "vf": sop.v_free, "d_th": t(rng.normal(0, 1e-3, (F1_LANES, n))),
        "d_v": t(rng.normal(0, 1e-3, (F1_LANES, n))),
        "active": torch.as_tensor(np.arange(F1_LANES) % 3 != 1)}}


def measure_solvers(torch, cs, data, dev):
    """This checkout's I1 and F1 tile mode on ``solver_inputs``: times
    (events back to back, events a call) and outputs."""
    from freedm_tpu_torch.kernels import solver_kernels as sol

    def on(a):
        if isinstance(a, tuple):
            return tuple(on(t) for t in a)
        return a.to(dev) if torch.is_tensor(a) else a

    cim = [on(a) for a in data["cim"]]
    carry = [a.clone() for a in cim[9:12]]
    out = sol.cim_iterate(*cim[:9], *carry, *cim[12:])
    outs = {"cim_iterate": [t.cpu() for t in (*out, *carry)]}
    f = {k: on(v) for k, v in data["f1"].items()}
    outs["fdlf_half_step"] = [t.cpu() for t in cs.f1_run(
        torch, sol.fdlf_half_step, sol, f["x"], f["d_th"], f["d_v"], f["y"],
        f["ps"], f["qs"], f["thf"], f["vf"], f["active"])[:5]]
    lanes, n = f["ps"].shape
    z = torch.zeros_like(f["ps"])
    v_args = (sol.VHALF, f["x"].clone(), z, f["y"][0], f["y"][1], f["ps"],
              f["qs"], f["thf"], f["vf"], torch.zeros_like(z),
              torch.zeros_like(z), torch.zeros(lanes, dtype=z.dtype,
                                               device=dev),
              torch.zeros(lanes, dtype=torch.int32, device=dev),
              torch.ones(lanes, dtype=torch.bool, device=dev),
              torch.zeros(1, dtype=z.dtype, device=dev), 1 << 30, True)
    fns = {"cim_iterate": (lambda: sol.cim_iterate(*cim), 20),
           "fdlf_half_step": (lambda: sol.fdlf_half_step(*v_args), 50)}
    times = {k: (cs.time_ms(torch, fn, reps=reps),
                 cs.queued_events_ms(torch, fn, reps))
             for k, (fn, reps) in fns.items()}
    return times, outs


def assemble_fns(torch, sk, x, ps, qs, op) -> dict:
    """S1's modes as ``KERNELS`` names them, each a call returning its
    outputs (``values_f32`` only for float64); the stand-ins of a checkout
    whose S1 has no modes are the module docstring's."""
    f64 = x.dtype == torch.float64
    if hasattr(sk, "RESIDUAL"):
        fns = {"sparse_assemble": sk.FULL,
               "sparse_assemble_residual": sk.RESIDUAL}
        if f64:
            fns["sparse_assemble_values_f32"] = sk.VALUES_F32
        return {k: (lambda mode=mode: sk.sparse_assemble(x, ps, qs, op, mode))
                for k, mode in fns.items()}

    def values_f32():
        ev, bv, f = sk.sparse_assemble(x, ps, qs, op)
        return ev.float(), bv.float(), f

    def residual():
        _, bv, f = sk.sparse_assemble(x, ps, qs, op)
        return bv[:, 4], bv[:, 5], f

    fns = {"sparse_assemble": lambda: sk.sparse_assemble(x, ps, qs, op),
           "sparse_assemble_residual": residual}
    if f64:
        fns["sparse_assemble_values_f32"] = values_f32
    return fns


def measure(root: Path, inputs: Path, outputs: Path, sections) -> None:
    sys.path.insert(0, str(root))
    import torch

    cs = _smoke()
    from freedm_tpu_torch.kernels import newton_kernels as nk
    from freedm_tpu_torch.kernels import sparse_kernels as sk
    from freedm_tpu_torch.pf.sparse import sparse_operands

    dev = torch.device("cuda")
    sys_ = cs.case_system("mesh2000")
    data = torch.load(inputs, weights_only=False)
    times, outs = {}, {}
    if "newton" in sections:
        args = [a.to(dev) for a in data["newton"]]
        jac, f = nk.newton_assemble(*args)
        p, q, f2 = nk.power_injections(*args)
        outs["newton"] = [t.cpu() for t in (jac, f, p, q, f2)]
        times["newton"] = {
            "newton_assemble": (cs.time_ms(torch, lambda: nk.newton_assemble(
                *args), reps=20), cs.device_ms(
                torch, lambda: nk.newton_assemble(*args), reps=10)),
            "power_injections": (cs.time_ms(
                torch, lambda: nk.power_injections(*args), reps=200),
                cs.queued_events_ms(torch, lambda: nk.power_injections(*args),
                                    reps=50))}
    if "solvers" in sections:
        times["solvers"], outs["solvers"] = measure_solvers(
            torch, cs, data["solvers"], dev)
    if "delta" in sections:
        times["delta"], outs["delta"] = measure_delta(torch, cs, sys_,
                                                      data["delta"], dev)
    for name in DTYPES if "sparse" in sections else ():
        dtype = getattr(torch, name)
        d = {k: v.to(dev) if torch.is_tensor(v) else v
             for k, v in data[name].items()}
        op = sparse_operands(sys_, dtype=dtype, device=dev)
        s1 = assemble_fns(torch, sk, d["x"], d["ps"], d["qs"], op)
        ev, bv, _ = s1["sparse_assemble"]()
        p_res, q_res, f_res = s1["sparse_assemble_residual"]()
        u, w, j0 = d["u"], d["w"], d["j0"]
        lvb, lvalid, ws, zs, beta = (d[k] for k in ("lvb", "lvalid", "ws",
                                                    "zs", "beta"))
        lanes = u.shape[0]

        def carry(active=True):
            return (d["x"].clone(), torch.zeros(lanes, dtype=torch.int32,
                                                device=dev),
                    torch.full((lanes,), float("inf"), dtype=dtype,
                               device=dev),
                    torch.full((lanes,), active, dtype=torch.bool,
                               device=dev))

        tol = torch.full((1,), 1e-8, dtype=dtype, device=dev)
        zero = torch.zeros(1, dtype=dtype, device=dev)
        vb, valid = d["vb"].clone(), d["valid"].clone()
        y = sk.sparse_matvec(ev, bv, u, op)
        sk.gmres_block_orth(vb, valid, w, j0)
        xs = sk.gmres_lstsq(lvb, lvalid, ws, zs, beta)
        k3 = carry()
        nk.newton_update(k3[0], d["dx"], d["f"], d["free"], *k3[1:], 5, tol)
        outs[name] = {"p": p_res.cpu(), "q": q_res.cpu(), "f": f_res.cpu(),
                      "ev": ev.cpu(), "bv": bv.cpu(),
                      "y": y.cpu(), "vb": vb.cpu(), "valid": valid.cpu(),
                      "xs": xs.cpu(), "k3": [t.cpu() for t in k3]}
        vt, at = d["vb"].clone(), d["valid"].clone()
        kt = carry()
        fns = {k: (fn, 50) for k, fn in s1.items()}
        fns.update({
            "sparse_matvec": (lambda: sk.sparse_matvec(ev, bv, u, op), 200),
            "gmres_block_orth": (
                lambda: sk.gmres_block_orth(vt, at, w, j0), 50),
            "gmres_lstsq": (
                lambda: sk.gmres_lstsq(lvb, lvalid, ws, zs, beta), 50),
            "newton_update": (
                lambda: nk.newton_update(kt[0], d["dx"], d["f"], d["free"],
                                         *kt[1:], 1 << 30, zero), 200)})
        times[name] = {k: (cs.time_ms(torch, fn, reps=reps),
                           cs.device_ms(torch, fn, reps=max(reps // 4, 10)))
                       for k, (fn, reps) in fns.items()}
    if "sparse" in sections:
        times["solves"] = profile_solves(torch, cs, sk, sys_, dev)
    torch.save(outs, outputs)
    print(json.dumps(times))


def measure_delta(torch, cs, sys_, args, dev):
    """This checkout's delta program at mesh2000 (``DELTA_LANES`` ×
    ``DELTA_PRECISIONS``): per configuration the wall per program with
    its results on the host (host clock over back-to-back programs), and
    from one ``torch.profiler`` window over 3 programs the device time,
    device operations and CUDA runtime calls per program; and the first
    program's (theta, v, sweeps)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from freedm_tpu_torch.kernels import cache_kernels as ck
    from freedm_tpu_torch.pf.krylov import build_fdlf_precond
    from freedm_tpu_torch.serve.cache import (DELTA_MAX_SWEEPS,
                                              _build_delta_program)

    to_host = getattr(ck, "results_to_host", None) or (
        lambda res: tuple(r.cpu().numpy() for r in res))
    pc = build_fdlf_precond(sys_, kind="lu", device=dev)
    times, outs = {}, {}
    for prec in DELTA_PRECISIONS:
        fn = _build_delta_program(sys_, pc, cs.DELTA_TOL, DELTA_MAX_SWEEPS,
                                  precision=prec, device=dev)
        for lanes in DELTA_LANES:
            a = [x[:lanes] for x in args]
            out = to_host(fn(*a))
            key = f"{prec}_B{lanes}"
            outs[key] = [torch.as_tensor(np.array(out[k])) for k in (0, 1, 5)]
            reps = 10
            torch.cuda.synchronize()
            t0 = time.monotonic()
            for _ in range(reps):
                to_host(fn(*a))
            wall = (time.monotonic() - t0) / reps * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    to_host(fn(*a))
            kern = cs.device_kernels(prof)
            times[key] = {
                "wall_ms": wall,
                "device_ms": sum(e.self_device_time_total for e in kern)
                / 1e3 / 3,
                "device_operations": sum(e.count for e in kern) / 3,
                "runtime_calls": cs.runtime_calls(prof) / 3,
                "sweeps": [int(x) for x in np.atleast_1d(out[5])]}
    return times, outs


def profile_solves(torch, cs, sk, sys_, dev) -> dict:
    """The default mesh2000 × 64 sparse solve in f64 and in mixed through
    this checkout's solver, once under ``torch.profiler``: Newton steps,
    device operations (kernels and copies), device busy and wall ms."""
    import numpy as np

    from freedm_tpu_torch.pf.krylov import build_fdlf_precond
    from freedm_tpu_torch.pf.sparse import make_sparse_newton_solver

    scales = np.linspace(0.5, 1.2, cs.MAIN_LANES)[:, None]
    p, q = scales * sys_.p_inj[None], scales * sys_.q_inj[None]
    pc = build_fdlf_precond(sys_, device=dev)
    out = {}
    for prec in ("f64", "mixed"):
        solve, _ = make_sparse_newton_solver(sys_, precision=prec,
                                             precond=pc, device=dev)
        solve(p_inj=p, q_inj=q)
        torch.cuda.synchronize()
        sk.reset_launches()
        solve(p_inj=p, q_inj=q)
        torch.cuda.synchronize()
        steps = sk.launches()["gmres_lstsq"]  # one GMRES cycle a step
        ops, busy, wall = cs.profile_solve(
            torch, lambda: solve(p_inj=p, q_inj=q), f"sparse {prec}")
        out[prec] = {"steps": steps, "operations": ops, "busy_ms": busy,
                     "wall_ms": wall}
    return out


def _run(*args: str) -> str:
    proc = subprocess.run([sys.executable, str(HERE / "kernel_ab.py"), *args],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel_ab {' '.join(args)} failed:\n"
                           f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    return proc.stdout


def agree(cs, torch, a: dict, b: dict, label: str) -> dict:
    """Relative S1/S2/S3/S4 differences of two turns' outputs; raises
    beyond ``SPARSE_TOL``, on different ``valid`` flags or on any K3
    difference; the delta programs' largest |Δtheta|, |Δv| (limit
    ``CACHE_ATOL``, sweeps at most one apart)."""
    errs = {}
    if "newton" in a:
        same = all(cs.same_bits(torch, x, y)
                   for x, y in zip(a["newton"][:2], b["newton"][:2]))
        cs.check(same, f"{label}: K1 outputs differ from this checkout's")
        errs["newton_same_bits"] = same
        k2 = max(cs.max_err(x, y) for x, y in zip(a["newton"][2:],
                                                   b["newton"][2:]))
        cs.check(k2 <= cs.KERNEL_ATOL,
                 f"{label}: K2 outputs {k2:.3e} from this checkout's")
        errs["power_injections_max_abs"] = k2
        errs["power_injections_same_bits"] = all(
            cs.same_bits(torch, x, y)
            for x, y in zip(a["newton"][2:], b["newton"][2:]))
    for kern, outs in a.get("solvers", {}).items():
        other = b["solvers"][kern]
        d = max(cs.exact_or_close(torch, x, y) for x, y in zip(outs, other))
        cs.check(d <= cs.KERNEL_ATOL,
                 f"{label}: {kern} outputs {d:.3e} from this checkout's")
        errs[f"{kern}_max_abs"] = d
        errs[f"{kern}_same_bits"] = all(
            torch.equal(x, y) or cs.same_bits(torch, x, y)
            for x, y in zip(outs, other))
    for key, (ta, va, sa) in a.get("delta", {}).items():
        tb, vb, sb = b["delta"][key]
        d = max(float((ta - tb).abs().max()), float((va - vb).abs().max()))
        apart = int((sa.long() - sb.long()).abs().max())
        cs.check(d <= cs.CACHE_ATOL and apart <= 1,
                 f"{label} disagrees with this checkout (delta {key}): "
                 f"{d:.3e} pu, sweeps {sa.tolist()} vs {sb.tolist()}")
        errs[f"delta_{key}"] = {"max_abs_pu": d, "sweeps_apart": apart}
    for name in DTYPES:
        if name not in a:
            continue
        tol12, tol34 = cs.SPARSE_TOL[name]
        e1 = max(cs.rel_abs_err(torch, a[name][k], b[name][k])[0]
                 for k in ("p", "q", "f"))
        e2 = cs.rel_abs_err(torch, a[name]["y"], b[name]["y"])[0]
        e3 = cs.rel_abs_err(torch, a[name]["vb"], b[name]["vb"])[0]
        e4 = cs.rel_abs_err(torch, a[name]["xs"], b[name]["xs"])[0]
        same3 = all(torch.equal(p, q) for p, q in zip(a[name]["k3"],
                                                     b[name]["k3"]))
        cs.check(e1 <= tol12 and e2 <= tol12 and e3 <= tol34
                 and e4 <= tol34 and same3
                 and torch.equal(a[name]["valid"], b[name]["valid"]),
                 f"{label} disagrees with this checkout ({name}): S1 {e1}, "
                 f"S2 {e2}, S3 {e3}, S4 {e4}, K3 identical {same3}")
        errs[name] = {"sparse_assemble": e1, "sparse_matvec": e2,
                      "gmres_block_orth": e3,
                      "gmres_lstsq": e4, "newton_update": 0.0,
                      # S1's outputs bit for bit (checkouts of one layout)
                      "sparse_assemble_same_bits": all(
                          cs.same_bits(torch, a[name][k], b[name][k])
                          for k in ("p", "q", "f", "ev", "bv"))}
    return errs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", type=Path, nargs="*",
                    help="roots of other checkouts")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON summary here")
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help="comma-separated: sparse (S1-S4, K3 and the "
                         "solves), delta (the delta program), newton (K1 "
                         "and K2), solvers (I1 and F1's tile mode)")
    ap.add_argument("--prepare", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--inputs", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--outputs", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    sections = [x for x in args.sections.split(",") if x]
    if any(x not in SECTIONS for x in sections):
        ap.error(f"unknown section in {args.sections!r}")
    if args.prepare is not None:
        prepare(args.prepare, sections)
        return 0
    if args.measure is not None:
        measure(args.measure, args.inputs, args.outputs, sections)
        return 0
    import torch

    import chip_smoke as cs

    if not args.others:
        ap.error("name at least one other checkout")
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    summary = {"card": smi, "sections": sections,
               "shape": "mesh2000 x 64, S3 at j0 = 12, s = 4, S4 at mm = 16;"
                        " K1/K2 mesh2000 x 64, one Ybus; delta programs "
                        "mesh2000 x {1, 8} lanes; I1 the CIM feeder x 64; "
                        "F1 tile mode mesh118 x 1024",
               "turns": "other, this, this, other", "others": {}}
    with tempfile.TemporaryDirectory() as tmp:
        inputs = Path(tmp) / "inputs.pt"
        _run("--prepare", str(inputs), "--sections", args.sections)
        for other in args.others:
            other = other.resolve()
            turns, outs = [], []
            for k, root in enumerate((other, HERE, HERE, other)):
                out = Path(tmp) / f"out{k}.pt"
                times = json.loads(_run("--measure", str(root), "--inputs",
                                        str(inputs), "--outputs", str(out),
                                        "--sections", args.sections)
                                   .strip().splitlines()[-1])
                which = "this" if root == HERE else "other"
                turns.append({"checkout": which, "times": times})
                outs.append(torch.load(out))
                for key, dv in times.get("delta", {}).items():
                    print(f"ab {other.name} delta {key:<9} {which:<5} wall "
                          f"{dv['wall_ms']:.3f} ms a program, device "
                          f"{dv['device_ms']:.4f} ms, "
                          f"{dv['device_operations']:.1f} device operations "
                          f"and {dv['runtime_calls']:.1f} CUDA runtime calls "
                          f"a program, sweeps {dv['sweeps']}", flush=True)
                for prec, sv in times.get("solves", {}).items():
                    print(f"ab {other.name} solve {prec:<5} {which:<5} "
                          f"{sv['steps']} steps, {sv['operations']} device "
                          f"operations ({sv['operations'] / sv['steps']:.1f}"
                          f" a step), busy {sv['busy_ms']:.2f} ms, wall "
                          f"{sv['wall_ms']:.1f} ms", flush=True)
                for kern, (ms, dev) in times.get("newton", {}).items():
                    print(f"ab {other.name} float64 {kern:<26} {which:<5} "
                          f"{ms:.4f} ms  device {dev:.4f} ms", flush=True)
                for kern, (ms, dev) in times.get("solvers", {}).items():
                    print(f"ab {other.name} float64 {kern:<26} {which:<5} "
                          f"{ms:.4f} ms  device (queued events) {dev:.4f} "
                          f"ms", flush=True)
                for name in DTYPES:
                    for kern in KERNELS:
                        if kern not in times.get(name, {}):
                            continue
                        ms, dev = times[name][kern]
                        print(f"ab {other.name} {name} {kern:<26} {which:<5} "
                              f"{ms:.4f} ms  device {dev:.4f} ms", flush=True)
            errs = agree(cs, torch, outs[0], outs[1], str(other))
            print(f"ab {other.name} agreement {json.dumps(errs)}", flush=True)
            summary["others"][str(other)] = {"turns": turns, "rel_err": errs}
    line = json.dumps(summary)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
