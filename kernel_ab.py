#!/usr/bin/env python3
"""Time S1 ``sparse_assemble`` (each mode), S2 ``sparse_matvec``, S3
``gmres_block_orth``, S4 ``gmres_lstsq``, K3 ``newton_update``, K1
``newton_assemble``, K2 ``power_injections``, I1 ``cim_iterate``, F1
``fdlf_half_step`` in its tile mode, the serving cache's delta program
(C1), L1 ``ladder_solve``, L2 ``ladder_vjp``, L3 ``ladder_dense``, L4
``ladder_doubling``, I2 ``cim_vjp``, B1 ``lb_rounds`` from 2¹⁵ nodes, T1
``topo_radiality``, T2 ``topo_screen``, J1 ``residual_jvp`` and J2
``residual_vjp``, Q1 ``qsts_bus_reduce`` and G1 ``form_groups`` of this
checkout against those of other checkouts of the repo, in turns on one
card.

    python3 kernel_ab.py OTHER [OTHER ...]
                         [--sections sparse,delta,newton,solvers,ladder,
                                     vjp,dense,doubling,superstep,qsts,
                                     i2,wide,topo,residual,bus_reduce,
                                     groups]
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
``KERNEL_ATOL`` (``*_max_abs``, ``*_same_bits`` printed).  It also times
F1's warp form (one Ybus below four lanes) at mesh2000 × 1 beside the
complex128 ``torch.matmul`` of Ybus with V by the same clock
(``fdlf_half_step_warp_library``) and with a per-lane Ybus at mesh2000 ×
16 (``fdlf_half_step_lanes16``, timed only), and runs K2 on a per-lane
Ybus (mesh118 × 118), whose warp form shares F1's row product
(``power_injections_lanes_same_bits``).

The ``ladder`` section times L1 ``ladder_solve`` at ``LADDER_SHAPES``
(``synthetic_radial(10000)`` × 1 and × 64 in float64 and float32,
``vvc_9bus`` × 64), 20 iterations in fixed and in solve mode, by queued
events, each checkout on its own operands built from the same feeder and
loads; their outputs agree within ``chip_smoke.LADDER_ATOL`` on lanes both
converge (float64: equal iterations).

The ``vjp`` section times L2 ``ladder_vjp`` at ``VJP_SHAPES``
(``synthetic_radial(10000)`` × 64 and × 1 in float64 and float32, ``vvc_9bus``
× 64), 20 saved iterates, by queued events, each checkout on its own
operands and its own L1's saved iterates from the same feeder and loads,
and seeded random cotangents; the checkouts' cotangents of the loads and
the source phasors agree within ``chip_smoke.GRAD_RTOL`` (float64) or
``chip_smoke.L2_F32_RTOL`` (float32) of the largest.

The ``doubling`` section times L4 ``ladder_doubling`` at
``DOUBLING_SHAPES`` (``synthetic_radial(10000)`` × 64 and × 1 in float64,
× 64 in float32, ``synthetic_radial(2048, load_kw=1.0)`` × 64 and
``vvc_9bus`` × 64 in float64), 20 iterations: a fixed solve, a solve and
the reverse mode (on the checkout's own saved iterates and seeded random
cotangents), by queued events, each checkout on its own operands
(``doubling_operands``).  The checkouts' forward outputs are the same bits
(both are their plain version's); their reverse modes' cotangents agree
within ``chip_smoke.GRAD_RTOL`` of the largest (float64;
``chip_smoke.L2_F32_RTOL`` in float32).

The ``superstep`` section runs ``chip_smoke``'s phase 26 (b) without its
plain twin: the DGI superstep of ``chip_smoke.SUPERSTEP_NODES`` nodes over
``synthetic_radial(10000)`` × ``chip_smoke.SUPERSTEP_LANES`` scenario
lanes (its VVC leg in float32), ``chip_smoke.SUPERSTEP_ROUNDS`` rounds,
each checkout's own ``make_superstep``; the median of rounds 2 on of a
round and of its VVC leg by CUDA events (the ``record`` hook); the last
round's losses finite in every checkout (their trajectories may part:
each checkout's float32 sums decide the VVC steps' acceptance).

The ``qsts`` section runs ``chip_smoke``'s QSTS phase (d) — vvc_9bus × 64
scenarios × 96 steps in chunks of 24, one L1 launch of 1536 lanes a chunk
— through each checkout's own ``run_study``: after one warm run, the
median wall scenario-steps/s of ``QSTS_RUNS`` runs; the checkouts' final
per-scenario losses agree within ``chip_smoke.QSTS_ATOL`` (relative).

The ``dense`` section times L3 ``ladder_dense`` at ``DENSE_SHAPES``
(``synthetic_radial(2048, load_kw=1.0)`` × 64 in float64 and float32,
``vvc_9bus`` × 64), 20 iterations, fixed and solve mode and the reverse
mode (``ladder_dense_vjp`` on the checkout's own saved iterates and
seeded random cotangents), by queued events, each checkout on its own
operands (``dense_operands``) from the same feeder and loads (phase 28's
``form_inputs``).  The forward outputs agree within
``chip_smoke.LADDER_ATOL`` on lanes both converge (float64: equal
iterations), the reverse mode's cotangents within ``GRAD_RTOL`` of the
largest in float64 (``DENSE_F32_RTOL`` in float32).

The ``i2`` section times I2 on the CIM feeder × 64 lanes
(``chip_smoke.cim_walk_inputs``: the iterates of 60 fixed iterations from
the no-load profile, a seeded masked cotangent), float64, by queued
events: one call at the last iterate (``cim_vjp``), and a whole backward
over the 60 iterates — ``cim_vjp_walk`` where the checkout has it (one
launch), else the 60 calls in a row its ``CimFixed`` made.  The call's
outputs and the backward's load and ``v_base`` cotangents agree within
``chip_smoke.KERNEL_ATOL`` of the largest entry (``i2_*_max_abs``,
``i2_*_same_bits`` printed).

The ``wide`` section times B1 at ``WIDE_SHAPES`` (``chip_smoke.WIDE_SHAPES``:
2¹⁵ × 4 fleets, 40,961 × 1 and 2¹⁶ × 1, 64 rounds of ``bench_lb_256``'s
draw, float32) by CUDA events around each call, each checkout on its own
route (this checkout's ``lb_form``: CLUSTER); the gateways, migrations
and states of the checkouts are the same bits.

The ``topo`` section times T1 and T2 (SCREEN and DETAIL) at
``TOPO_SHAPES``: mesh118 × 4096 lanes of rank 2 (rows 4096-8191 of the
gate sweep's variant list), × 64 (its first 64: a chunk of the served
sweep job) and mesh2000 × 16,384 neighborhood samples of rank ≤ 3 (seed
7: the full-width sweep's first chunk), each checkout on its own operands
(``topo_operands``, Zᵀ and θ0 as ``chip_smoke.topo_inputs`` makes them),
device time by queued events.  T1's booleans are equal; T2's islanding
flags and violation counts equal, loss, worst flow and DETAIL's θ and
flows (its first 256 lanes) within ``chip_smoke.TOPO_ATOL``.

The ``residual`` section times J1 (float64, float32 on float32
operands — the mixed inner solve's —, float64 with a per-lane status)
and J2 (MASKED and FULL, float64) at the krylov lane batch's case
(``chip_smoke.synthetic_mesh_bench(2000, 1.0)``) × 256 and × 64 lanes on
one seeded state, tangent and cotangent made here, each checkout through
its own wrappers' default route and operands, device time by queued
events.  The checkouts' outputs agree within ``chip_smoke.KERNEL_ATOL``
(float32 ``KERNEL_ATOL_F32``) of the largest entry above 1, and whether
they are the same bits is printed (``residual_*_same_bits``).

The ``bus_reduce`` section times Q1 ``qsts_bus_reduce`` at
``BUS_REDUCE_SHAPES`` (mesh2000 x 1, x 64 and x 256, mesh5000 x 64) on
seeded |V|, theta, P, iterations and flags made here, each checkout on
its own operands and default launch, device time by queued events; one
call's eight accumulators from the same seeded start must be the same
bits in every checkout.

The ``groups`` section times G1 ``form_groups`` at ``GROUPS_SHAPES``
(the superstep's reach, ``chip_smoke.superstep_reach``, at N = 1024 x 1;
``chip_smoke.g1_graph``'s sparse reach at 1024 x 1, x 16, x 64 and 4096 x
1) through each checkout's default route, by queued events and by CUDA
events a call (the wrapper's host time counted in); every field of the
outputs must be equal across the checkouts.

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
SECTIONS = ("sparse", "delta", "newton", "solvers", "ladder", "vjp", "dense",
            "doubling", "superstep", "qsts", "i2", "wide", "topo",
            "residual", "bus_reduce", "groups")
#: The ``bus_reduce`` section's shapes: (case, lanes).
BUS_REDUCE_SHAPES = (("mesh2000", 1), ("mesh2000", 64), ("mesh2000", 256),
                     ("mesh5000", 64))
#: The ``groups`` section's shapes: (reach, N, lanes).
GROUPS_SHAPES = (("superstep", 1024, 1), ("sparse", 1024, 1),
                 ("sparse", 1024, 16), ("sparse", 1024, 64),
                 ("sparse", 4096, 1))
#: The ``residual`` section's lane counts: the krylov lane batch and the
#: sparse backward.
RESIDUAL_LANES = (256, 64)
#: The ``topo`` section's shapes: (case, lanes, rank).
TOPO_SHAPES = (("mesh118", 4096, 2), ("mesh118", 64, 2),
               ("mesh2000", 16384, 3))
#: DETAIL's θ and flows are compared on this many lanes of a shape.
TOPO_DETAIL_LANES = 256
SOLVER_KERNELS = ("cim_iterate", "fdlf_half_step", "fdlf_half_step_warp",
                  "power_injections_lanes")
#: The ``ladder`` section's L1 shapes: (feeder, lanes, dtype).
LADDER_SHAPES = (("radial10k", 1, "float64"), ("radial10k", 64, "float64"),
                 ("radial10k", 1, "float32"), ("radial10k", 64, "float32"),
                 ("vvc_9bus", 64, "float64"), ("vvc_9bus", 1536, "float64"),
                 ("vvc_9bus", 1536, "float32"))
#: The ``qsts`` section's study: ``chip_smoke.py``'s QSTS phase (d), one
#: L1 launch of 24 steps x 64 scenarios a chunk, run this many times.
QSTS_RUNS = 3
#: The ``vjp`` section's L2 shapes: (feeder, lanes, dtype).
VJP_SHAPES = (("radial10k", 64, "float64"), ("radial10k", 1, "float64"),
              ("radial10k", 64, "float32"), ("radial10k", 1, "float32"),
              ("vvc_9bus", 64, "float64"))
#: The ``doubling`` section's L4 shapes: (feeder, lanes, dtype).
DOUBLING_SHAPES = (("radial10k", 64, "float64"), ("radial10k", 1, "float64"),
                   ("radial10k", 64, "float32"),
                   ("radial2048", 64, "float64"), ("vvc_9bus", 64, "float64"))
#: The ``dense`` section's L3 shapes: (feeder, lanes, dtype).
DENSE_SHAPES = (("radial2048", 64, "float64"), ("radial2048", 64, "float32"),
                ("vvc_9bus", 64, "float64"))
#: Float32 reverse modes of two checkouts agree within this share of the
#: largest cotangent (20 walked iterations summed in other orders).
DENSE_F32_RTOL = 1e-3
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
    if "residual" in sections:
        sys2k = cs.synthetic_mesh_bench(2000, 1.0)
        n, m, lanes = sys2k.n_bus, sys2k.n_branch, max(RESIDUAL_LANES)
        rng = np.random.default_rng(22)
        st = np.ones((lanes, m))
        st[np.arange(lanes), n + np.arange(lanes)] = 0.0
        data["residual"] = {
            "x": torch.as_tensor(np.concatenate(
                [rng.normal(0, 0.1, (lanes, n)),
                 rng.uniform(0.95, 1.05, (lanes, n))], 1)),
            "u": torch.as_tensor(rng.normal(size=(lanes, 2 * n))),
            "status": torch.as_tensor(st)}
    if "bus_reduce" in sections:
        data["bus_reduce"] = bus_reduce_inputs(cs)
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


def bus_reduce_inputs(cs) -> dict:
    """Q1's seeded inputs by case, at the widest lane count of
    ``BUS_REDUCE_SHAPES`` (a narrower shape takes the first lanes)."""
    out = {}
    for case in sorted({c for c, _ in BUS_REDUCE_SHAPES}):
        n = cs.case_system(case).n_bus
        lanes = max(w for c, w in BUS_REDUCE_SHAPES if c == case)
        rng = np.random.default_rng(23)
        out[case] = (rng.uniform(0.93, 1.07, (lanes, n)),
                     rng.normal(0.0, 0.3, (lanes, n)),
                     rng.normal(0.0, 1.0, (lanes, n)),
                     rng.integers(1, 9, lanes).astype(np.int32),
                     rng.uniform(size=lanes) > 0.1)
    return out


def measure_bus_reduce(torch, cs, data, dev):
    """Q1 at ``BUS_REDUCE_SHAPES`` through this checkout's wrapper and
    operands: queued-event times, and one call's accumulators."""
    from freedm_tpu_torch.kernels import qsts_kernels as qk

    times, outs = {}, {}
    for case, lanes in BUS_REDUCE_SHAPES:
        op = qk.bus_reduce_operands(cs.case_system(case), dev)
        v, th, p, it, conv = (torch.as_tensor(x[:lanes], device=dev)
                              for x in data[case])
        acc = cs.random_acc(torch, qk, lanes, 5)

        def call(acc=acc):
            qk.qsts_bus_reduce(v, th, p, it, conv, op, acc, 15.0, 0.25, 0.95,
                               1.05)
        call()
        key = f"{case}_x{lanes}"
        outs[key] = [x.cpu() for x in acc]
        times[key] = cs.queued_events_ms(torch, call, 50)
    return times, outs


def measure_groups(torch, cs, dev):
    """G1 at ``GROUPS_SHAPES`` through this checkout's wrapper and its
    default route: queued-event times, CUDA events a call, and the
    outputs."""
    from freedm_tpu_torch.kernels import dgi_kernels as dk

    times, outs = {}, {}
    for kind, n, lanes in GROUPS_SHAPES:
        if kind == "superstep":
            rs, al = cs.superstep_reach(torch, dev)
            rank = cs.g1_rank(torch, cs.gm_priority(n), dev)
        else:
            reach, alive, prio = cs.g1_graph(n, lanes, seed=7 * n)
            rank = cs.g1_rank(torch, prio, dev)
            al = torch.as_tensor(alive, device=dev)
            rs = torch.as_tensor(reach, device=dev)[None].contiguous()
        key = f"{kind}_{n}x{lanes}"
        outs[key] = [x.cpu() for x in dk.form_groups(al, rs, rank)]

        def call():
            return dk.form_groups(al, rs, rank)
        times[key] = cs.queued_events_ms(torch, call, 30)
        times[f"{key}_a_call"] = cs.events_ms(torch, call, 30)
        torch.cuda.empty_cache()
    return times, outs


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
    """This checkout's I1 and F1 tile mode on ``solver_inputs``, F1's warp
    form and K2's per-lane form on states made here: times (events back to
    back, events a call) and outputs."""
    from freedm_tpu_torch.kernels import newton_kernels as nk
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
    # F1's warp form at bench_nr_2000's shape (mesh2000 x 1, one Ybus): its
    # three modes for agreement, its V half timed beside the library row.
    w = warp_inputs(torch, cs, dev)
    outs["fdlf_half_step_warp"] = [t.cpu() for t in cs.f1_run(
        torch, sol.fdlf_half_step, sol, w["x"], w["d_th"], w["d_v"], w["y"],
        w["ps"], w["qs"], w["thf"], w["vf"], w["active"])[:5]]
    zw = torch.zeros_like(w["ps"])
    w_args = (sol.VHALF, w["x"].clone(), zw, w["y"][0], w["y"][1], w["ps"],
              w["qs"], w["thf"], w["vf"], torch.zeros_like(zw),
              torch.zeros_like(zw), torch.zeros(1, dtype=zw.dtype, device=dev),
              torch.zeros(1, dtype=torch.int32, device=dev),
              torch.ones(1, dtype=torch.bool, device=dev),
              torch.zeros(1, dtype=zw.dtype, device=dev), 1 << 30, True)
    fns["fdlf_half_step_warp"] = (lambda: sol.fdlf_half_step(*w_args), 50)
    # ... and with a per-lane Ybus, the FDLF N-1 shape (mesh2000 x 16).
    l16 = lanes16_inputs(torch, cs, sol, dev)
    fns["fdlf_half_step_lanes16"] = (lambda: sol.fdlf_half_step(*l16), 20)
    # K2's per-lane warp form (the dense N-1 shape, mesh118 x 118): its bits
    # must not move (it shares row_product::warp_product with F1).
    k2 = lanes_k2_inputs(torch, cs, dev)
    outs["power_injections_lanes"] = [
        t.cpu() for t in nk.power_injections(*k2)]
    fns["power_injections_lanes"] = (lambda: nk.power_injections(*k2), 50)
    times = {k: (cs.time_ms(torch, fn, reps=reps),
                 cs.queued_events_ms(torch, fn, reps))
             for k, (fn, reps) in fns.items()}
    yc = torch.complex(w["y"][0], w["y"][1])
    vc = torch.polar(w["x"][:, w["ps"].shape[1]:].T.contiguous(),
                     w["x"][:, :w["ps"].shape[1]].T.contiguous())
    lib = cs.queued_events_ms(torch, lambda: torch.matmul(yc, vc), 50)
    times["fdlf_half_step_warp_library"] = (cs.time_ms(
        torch, lambda: torch.matmul(yc, vc), reps=50), lib)
    return times, outs


def warp_inputs(torch, cs, dev) -> dict:
    """F1's warp-form state at mesh2000 x 1 (``chip_smoke``'s
    ``synthetic_mesh_bench(2000, 1.0)``, one Ybus), made from a seed in
    every turn."""
    from freedm_tpu_torch.grid.bus import ybus_dense
    from freedm_tpu_torch.pf.sparse import sparse_operands

    sys_ = cs.synthetic_mesh_bench(2000, 1.0)
    n = sys_.n_bus
    rng = np.random.default_rng(2000)
    f64 = torch.float64

    def t(a):
        return torch.as_tensor(a, dtype=f64, device=dev)

    sop = sparse_operands(sys_, dtype=f64, device=dev)
    ps = t(np.tile(sys_.p_inj, (1, 1)))
    return {"x": torch.cat([t(rng.normal(0, 0.1, (1, n))),
                            t(rng.uniform(0.95, 1.05, (1, n)))], 1),
            "y": ybus_dense(sys_, dtype=f64, device=dev), "ps": ps,
            "qs": t(np.tile(sys_.q_inj, (1, 1))), "thf": sop.th_free,
            "vf": sop.v_free, "d_th": t(rng.normal(0, 1e-3, (n, 1))).T,
            "d_v": t(rng.normal(0, 1e-3, (1, n))),
            "active": torch.ones(1, dtype=torch.bool, device=dev)}


def lanes16_inputs(torch, cs, sol, dev):
    """F1's V half at mesh2000 x 16 chord outages, a per-lane Ybus stamped
    by this checkout's Y1 (``chip_smoke``'s phase 22 shape)."""
    from freedm_tpu_torch.grid.bus import stamp_operands
    from freedm_tpu_torch.pf.sparse import sparse_operands

    sys_ = cs.synthetic_mesh_bench(2000, 1.0)
    n, f64 = sys_.n_bus, torch.float64
    st = torch.ones(16, sys_.n_branch, dtype=f64, device=dev)
    st[torch.arange(16), n + torch.arange(16)] = 0.0
    y = sol.ybus_stamp(sol.YBUS, stamp_operands(sys_, dtype=f64, device=dev),
                       st)
    sop = sparse_operands(sys_, dtype=f64, device=dev)
    z = torch.zeros(16, n, dtype=f64, device=dev)
    x = torch.cat([z, torch.ones_like(z)], 1)
    ps = torch.as_tensor(np.tile(sys_.p_inj, (16, 1)), device=dev)
    return (sol.VHALF, x, z.clone(), y[0], y[1], ps, ps, sop.th_free,
            sop.v_free, z.clone(), z.clone(),
            torch.zeros(16, dtype=f64, device=dev),
            torch.zeros(16, dtype=torch.int32, device=dev),
            torch.ones(16, dtype=torch.bool, device=dev),
            torch.zeros(1, dtype=f64, device=dev), 1 << 30, True)


def lanes_k2_inputs(torch, cs, dev):
    """K2's arguments with a per-lane Ybus: mesh118 x 118 single outages
    (``chip_smoke.n1_118_status``), the state of ``chip_smoke``'s phase
    22."""
    from freedm_tpu_torch.grid.bus import stamp_operands, ybus_lanes
    from freedm_tpu_torch.pf.sparse import sparse_operands

    sys_ = cs.case_system("mesh118")
    n = sys_.n_bus
    f64 = torch.float64
    op = stamp_operands(sys_, dtype=f64, device=dev)
    st = torch.as_tensor(cs.n1_118_status(sys_), dtype=f64, device=dev)
    lanes = st.shape[0]
    y = ybus_lanes(sys_, st, dtype=f64, device=dev, op=op)
    rng = np.random.default_rng(22)
    x = torch.cat([torch.as_tensor(rng.normal(0, 0.05, (lanes, n)),
                                   device=dev),
                   torch.ones(lanes, n, dtype=f64, device=dev)], 1)
    sop = sparse_operands(sys_, dtype=f64, device=dev)
    ps = torch.as_tensor(np.tile(sys_.p_inj, (lanes, 1)), device=dev)
    qs = torch.as_tensor(np.tile(sys_.q_inj, (lanes, 1)), device=dev)
    return (x, y[0], y[1], ps, qs, sop.th_free, sop.v_free, sop.v_set)


def measure_ladder(torch, cs, dev):
    """L1 at ``LADDER_SHAPES`` through this checkout's own operands (made
    from the feeder in every turn), 20 iterations: fixed and solve mode
    device times by queued events, and the fixed and solve outputs."""
    from freedm_tpu_torch.kernels import ladder_kernels as lk

    feeders = {n: f for n, f, _, _ in cs.ladder_feeders()}
    times, outs = {}, {}
    for name, lanes, dn in LADDER_SHAPES:
        dtype = getattr(torch, dn)
        s, v0, op = cs.preorder_inputs(torch, lk, feeders[name], lanes,
                                       dtype)
        key = f"{name}_x{lanes}_{dn}"
        for mode, fixed in (("fixed", True), ("solve", False)):
            def fn(fixed=fixed):
                return lk.ladder_solve(s, v0, op, cs.LADDER_EPS, 20, fixed)
            o = fn()
            outs[f"{key}_{mode}"] = [x.cpu() for x in (
                o.v.re, o.v.im, o.i_branch.re, o.i_branch.im, o.i_load.re,
                o.i_load.im, o.iterations, o.converged)]
            times[f"{key}_{mode}"] = cs.queued_events_ms(torch, fn, 7)
    return times, outs


def measure_vjp(torch, cs, dev):
    """L2 at ``VJP_SHAPES`` on this checkout's own operands and saved
    iterates, 20 iterates: device times by queued events, and the
    cotangents."""
    from freedm_tpu_torch.kernels import ladder_kernels as lk

    feeders = {n: f for n, f, _, _ in cs.ladder_feeders()}
    times, outs = {}, {}
    for name, lanes, dn in VJP_SHAPES:
        dtype = getattr(torch, dn)
        s, v0, op = cs.preorder_inputs(torch, lk, feeders[name], lanes,
                                       dtype)
        saved = lk.ladder_solve(s, v0, op, cs.LADDER_EPS, 20, True,
                                save=True).saved
        gs = cs._cotangents(torch, np.random.default_rng(5), lanes, op.nb,
                            dtype, dev)

        def back():
            return lk.ladder_vjp(saved, s, op, *gs)
        key = f"{name}_x{lanes}_{dn}"
        outs[key] = [x.cpu() for x in cs._flat_vjp(back())]
        times[key] = cs.queued_events_ms(torch, back, 7)
    return times, outs


def measure_doubling(torch, cs, dev):
    """L4 at ``DOUBLING_SHAPES`` on this checkout's own operands, 20
    iterations: fixed and solve mode and the reverse mode, device times by
    queued events, and their outputs."""
    from freedm_tpu_torch.kernels import ladder_kernels as lk

    feeders = cs.form_feeders()
    times, outs = {}, {}
    for name, lanes, dn in DOUBLING_SHAPES:
        dtype = getattr(torch, dn)
        f = feeders[name]
        s, v0 = cs.form_inputs(torch, f, lanes, dtype, dev)
        op = lk.doubling_operands(f, dtype, dev)
        key = f"{name}_x{lanes}_{dn}"
        for mode, fixed in (("fixed", True), ("solve", False)):
            def fn(fixed=fixed):
                return lk.ladder_doubling(s, v0, op, cs.LADDER_EPS, 20, fixed)
            o = fn()
            outs[f"{key}_{mode}"] = [x.cpu() for x in (
                o.v.re, o.v.im, o.i_branch.re, o.i_branch.im, o.i_load.re,
                o.i_load.im, o.iterations, o.converged)]
            times[f"{key}_{mode}"] = cs.queued_events_ms(torch, fn, 5)
        saved = lk.ladder_doubling(s, v0, op, cs.LADDER_EPS, 20, True,
                                   save=True).saved
        gs = cs._cotangents(torch, np.random.default_rng(5), lanes,
                            f.n_branches, dtype, dev)

        def back():
            return lk.ladder_doubling_vjp(saved, s, op, *gs)
        outs[f"{key}_reverse"] = [x.cpu() for x in cs._flat_vjp(back())]
        times[f"{key}_reverse"] = cs.queued_events_ms(torch, back, 5)
    return times, outs


def measure_superstep(torch, cs, dev):
    """Phase 26 (b)'s superstep on this checkout's ``make_superstep``:
    the median round and VVC leg (ms, CUDA events) over rounds 2 on, and
    the last round's losses."""
    from freedm_tpu_torch.grid import topology as top
    from freedm_tpu_torch.grid.cases import synthetic_radial
    from freedm_tpu_torch.parallel import make_superstep

    n = cs.SUPERSTEP_NODES
    feeder = synthetic_radial(cs.SUPERSTEP_FEEDER, seed=0, load_kw=1.0)
    rng = np.random.default_rng(26)
    reach = top.node_reachability(
        top.parse_topology(cs.dgi_topology_text()),
        tuple(f"n{i}" for i in range(n)), device=dev)(
        rng.uniform(size=cs.DGI_FIDS) > 0.1)
    step, shard = make_superstep(feeder=feeder, device=dev)
    netgen, gateway = cs.superstep_fleet(torch, n, 1, dev)
    alive = (rng.uniform(size=n) >= 0.02).astype(np.float32)
    st = shard(netgen.cpu().numpy(), gateway.cpu().numpy(),
               rng.uniform(0.7, 1.3, cs.SUPERSTEP_LANES), alive=alive,
               reachable=reach.cpu().numpy())
    rounds, vvc = [], []
    for r in range(cs.SUPERSTEP_ROUNDS):
        marks, names = [], []

        def record(name=None):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
            names.append(name)

        torch.cuda.synchronize()
        record()
        out = step(st, record=record)
        torch.cuda.synchronize()
        if r > 0:
            rounds.append(marks[0].elapsed_time(marks[-1]))
            i = names.index("vvc")
            vvc.append(marks[i - 1].elapsed_time(marks[i]))
        st = out.state
    return ({"round_ms": float(np.median(rounds)),
             "vvc_ms": float(np.median(vvc))},
            [out.vvc_loss.cpu()])


def measure_qsts(torch, cs, dev):
    """QSTS phase (d) (vvc_9bus x 64 scenarios x 96 steps, chunks of 24)
    through this checkout's ``run_study``, after one warm run: the median
    wall scenario-steps/s over ``QSTS_RUNS`` runs, and the last run's
    per-scenario losses."""
    from freedm_tpu_torch.scenarios.engine import (QstsEngine, StudySpec,
                                                   run_study)

    spec = StudySpec(case="vvc_9bus", scenarios=cs.MAIN_LANES, steps=96,
                     dt_minutes=15.0, chunk_steps=24, seed=5)
    eng = QstsEngine(spec)
    run_study(spec, engine=eng)
    rates = []
    for _ in range(QSTS_RUNS):
        torch.cuda.synchronize()
        out = run_study(spec, engine=eng)
        rates.append(out["scenario_steps_per_sec"])
    state = cs.study_states(eng)
    return ({"scenario_steps_per_sec": float(np.median(rates)),
             "runs": rates},
            [torch.as_tensor(np.asarray(state.loss_kwh, np.float64))])


def measure_dense(torch, cs, dev):
    """L3 at ``DENSE_SHAPES`` through this checkout's own operands, 20
    iterations: fixed and solve mode and the reverse mode, device times by
    queued events, and their outputs."""
    from freedm_tpu_torch.cplx import C
    from freedm_tpu_torch.kernels import ladder_kernels as lk

    feeders = cs.form_feeders()
    times, outs = {}, {}
    for name, lanes, dn in DENSE_SHAPES:
        dtype = getattr(torch, dn)
        f = feeders[name]
        s, v0 = cs.form_inputs(torch, f, lanes, dtype, dev)
        op = lk.dense_operands(f, dtype, dev)
        key = f"{name}_x{lanes}_{dn}"
        for mode, fixed in (("fixed", True), ("solve", False)):
            def fn(fixed=fixed):
                return lk.ladder_dense(s, v0, op, cs.LADDER_EPS, 20, fixed)
            o = fn()
            outs[f"{key}_{mode}"] = [x.cpu() for x in (
                o.v.re, o.v.im, o.i_branch.re, o.i_branch.im, o.i_load.re,
                o.i_load.im, o.iterations, o.converged)]
            times[f"{key}_{mode}"] = cs.queued_events_ms(torch, fn, 7)
        saved = lk.ladder_dense(s, v0, op, cs.LADDER_EPS, 20, True,
                                save=True).saved
        rng = np.random.default_rng(5)
        gs = [C(torch.tensor(rng.normal(size=(lanes, f.n_branches, 3)),
                             dtype=dtype, device=dev),
                torch.tensor(rng.normal(size=(lanes, f.n_branches, 3)),
                             dtype=dtype, device=dev)) for _ in range(3)]

        def back():
            return lk.ladder_dense_vjp(saved, s, op, *gs)
        sbar, v0bar = back()
        outs[f"{key}_reverse"] = [x.cpu() for x in (sbar.re, sbar.im,
                                                    v0bar.re, v0bar.im)]
        times[f"{key}_reverse"] = cs.queued_events_ms(torch, back, 7)
    return times, outs


def measure_i2(torch, cs, dev):
    """I2 on the CIM feeder × 64: a call at the last iterate and a whole
    backward over ``CIM_WALK_STEPS`` iterates (the walk, or the calls in a
    row of a checkout without it), by queued events, and their
    outputs."""
    from freedm_tpu_torch.kernels import solver_kernels as sol

    f, ties = cs.cim_feeder()
    steps = cs.CIM_WALK_STEPS
    h, g, vs, s, mask = cs.cim_walk_inputs(torch, sol, f, ties, cs.CIM_LANES,
                                           steps, dev)
    acc = [torch.zeros_like(s[0]) for _ in range(4)]

    def call():
        return sol.cim_vjp(*h, *g, vs[steps - 1, 0], vs[steps - 1, 1], *s,
                           mask, *acc)

    def backward():
        if hasattr(sol, "cim_vjp_walk"):
            return sol.cim_vjp_walk(*h, *g, vs, *s, mask, steps)
        out = [torch.zeros_like(s[0]), torch.zeros_like(s[0]), g[0].clone(),
               g[1].clone()]
        gk = g
        for k in reversed(range(steps)):
            gk = sol.cim_vjp(*h, *gk, vs[k, 0], vs[k, 1], *s, mask, *out)
        return out

    outs = {"call": [x.cpu() for x in call()] + [x.cpu() for x in acc],
            "backward": [x.cpu() for x in backward()]}
    times = {"call": cs.queued_events_ms(torch, call, 20),
             f"backward_{steps}": cs.queued_events_ms(torch, backward, 5),
             "form": "walk" if hasattr(sol, "cim_vjp_walk") else "calls"}
    return times, outs


def measure_wide(torch, cs, dev):
    """B1 at ``chip_smoke.WIDE_SHAPES`` over ``WIDE_ROUNDS`` rounds by
    CUDA events, and its outputs."""
    from freedm_tpu_torch.kernels import dgi_kernels as dk

    times, outs = {}, {}
    for n, fleets in cs.WIDE_SHAPES:
        ng, gw, gid = cs.wide_inputs(torch, n, fleets, dev)

        def call():
            return dk.lb_rounds(ng, gw, gid, 1.0, cs.WIDE_ROUNDS)
        key = f"{n}x{fleets}"
        out = call()
        outs[key] = [out.gateway.cpu(), out.migrations.cpu(),
                     out.states.cpu()]
        times[key] = cs.events_ms(torch, call, 5)
        times[key + "_form"] = dk.lb_form(n, 4)
    return times, outs


def measure_residual(torch, cs, data, dev):
    """J1 and J2 at ``RESIDUAL_LANES`` on this checkout's own operands, by
    queued events, and their outputs."""
    from freedm_tpu_torch.kernels import solver_kernels as sol
    from freedm_tpu_torch.pf.sparse import sparse_operands

    sys2k = cs.synthetic_mesh_bench(2000, 1.0)
    op = sparse_operands(sys2k, device=dev)
    op32 = op.to_dtype(torch.float32)
    vop = sol.vjp_operands(op)
    times, outs = {}, {}
    for lanes in RESIDUAL_LANES:
        x = data["x"][:lanes].to(dev)
        u = data["u"][:lanes].to(dev)
        st = data["status"][:lanes].to(dev)
        x32, u32 = x.float(), u.float()
        calls = {
            "j1_f64": lambda: sol.residual_jvp(x, u, op),
            "j1_f32": lambda: sol.residual_jvp(x32, u32, op32),
            "j1_status": lambda: sol.residual_jvp(x, u, op, st),
            "j2_masked": lambda: sol.residual_vjp(x, u, op, vop, sol.MASKED),
            "j2_full": lambda: sol.residual_vjp(x, u, op, vop, sol.FULL)}
        for name, fn in calls.items():
            key = f"{name}_x{lanes}"
            outs[key] = fn().cpu()
            times[key] = cs.queued_events_ms(torch, fn, 50)
    return times, outs


def measure_topo(torch, cs, dev):
    """T1 and T2 at ``TOPO_SHAPES`` on this checkout's own operands:
    device times by queued events, and their outputs."""
    from freedm_tpu_torch.kernels import topo_kernels as tk
    from freedm_tpu_torch.pf import topo as tp

    times, outs = {}, {}
    for name, lanes, rank in TOPO_SHAPES:
        sys_, op, zt, theta0 = cs.topo_inputs(torch, tp, name, dev)
        m = sys_.n_branch
        slots = (tp.enumerate_variants(np.arange(m), 2)[4096:4096 + lanes]
                 if name == "mesh118" else
                 tp.neighborhood_variants(np.arange(m), rank, lanes, 7))
        sl = torch.as_tensor(slots, device=dev)
        key = f"{name}_x{lanes}"

        def t1():
            return tk.topo_radiality(sl, op, op.n + 1)

        def t2(mode):
            return tk.topo_screen(zt, theta0, sl, cs.TOPO_LIMIT, op, mode)
        c, r = t1()
        s = t2(tk.SCREEN)
        d = t2(tk.DETAIL)
        k = TOPO_DETAIL_LANES
        outs[key] = {"t1": [c.cpu(), r.cpu()],
                     "screen": [x.cpu() for x in s[:4]],
                     "detail": [d.theta[:k].cpu(), d.flows[:k].cpu()]}
        del d
        times[f"{key}_T1"] = cs.queued_events_ms(torch, t1, 20)
        times[f"{key}_T2_SCREEN"] = cs.queued_events_ms(
            torch, lambda: t2(tk.SCREEN), 20)
        times[f"{key}_T2_DETAIL"] = cs.queued_events_ms(
            torch, lambda: t2(tk.DETAIL), 10)
        del zt
        torch.cuda.empty_cache()
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
    if "ladder" in sections:
        times["ladder"], outs["ladder"] = measure_ladder(torch, cs, dev)
    if "vjp" in sections:
        times["vjp"], outs["vjp"] = measure_vjp(torch, cs, dev)
    if "dense" in sections:
        times["dense"], outs["dense"] = measure_dense(torch, cs, dev)
    if "doubling" in sections:
        times["doubling"], outs["doubling"] = measure_doubling(torch, cs, dev)
    if "superstep" in sections:
        times["superstep"], outs["superstep"] = measure_superstep(torch, cs,
                                                                  dev)
    if "qsts" in sections:
        times["qsts"], outs["qsts"] = measure_qsts(torch, cs, dev)
    if "i2" in sections:
        times["i2"], outs["i2"] = measure_i2(torch, cs, dev)
    if "wide" in sections:
        times["wide"], outs["wide"] = measure_wide(torch, cs, dev)
    if "topo" in sections:
        times["topo"], outs["topo"] = measure_topo(torch, cs, dev)
    if "residual" in sections:
        times["residual"], outs["residual"] = measure_residual(
            torch, cs, data["residual"], dev)
    if "bus_reduce" in sections:
        times["bus_reduce"], outs["bus_reduce"] = measure_bus_reduce(
            torch, cs, data["bus_reduce"], dev)
    if "groups" in sections:
        times["groups"], outs["groups"] = measure_groups(torch, cs, dev)
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
    for key, outs in a.get("ladder", {}).items():
        other = b["ladder"][key]
        tol = cs.LADDER_ATOL["float32" if "float32" in key else "float64"]
        conv = outs[7] & other[7]
        d = max(float((x - y)[conv].abs().max()) if bool(conv.any()) else 0.0
                for x, y in zip(outs[:6], other[:6]))
        cs.check(d <= tol and ("float32" in key
                               or torch.equal(outs[6], other[6])),
                 f"{label}: ladder {key} outputs {d:.3e} from this "
                 f"checkout's (iterations {outs[6].tolist()[:4]} vs "
                 f"{other[6].tolist()[:4]})")
        errs[f"ladder_{key}_max_abs"] = d
    if "superstep" in a:
        ok = all(bool(torch.isfinite(x).all()) for x in a["superstep"]
                 + b["superstep"])
        cs.check(ok, f"{label}: the superstep's losses are not finite")
        errs["superstep_loss_max_rel"] = max(
            float(((x - y).abs() / y.abs().clamp(min=1e-30)).max())
            for x, y in zip(a["superstep"], b["superstep"]))
    if "qsts" in a:
        x, y = a["qsts"][0], b["qsts"][0]
        d = float(((x - y).abs() / y.abs().clamp(min=1e-30)).max())
        cs.check(bool(torch.isfinite(x).all()) and d <= cs.QSTS_ATOL,
                 f"{label}: QSTS (d) losses {d:.3e} (relative) from this "
                 f"checkout's")
        errs["qsts_loss_max_rel"] = d
    for key, outs in a.get("vjp", {}).items():
        other = b["vjp"][key]
        top = max(float(y.abs().max()) for y in other)
        d = max(float((x - y).abs().max()) for x, y in zip(outs, other))
        rtol = cs.L2_F32_RTOL if "float32" in key else cs.GRAD_RTOL
        cs.check(d <= rtol * top, f"{label}: L2 {key} cotangents {d:.3e} "
                 f"from this checkout's (largest {top:.3e})")
        errs[f"ladder_vjp_{key}_max_rel"] = d / max(top, 1e-300)
    for key, outs in a.get("doubling", {}).items():
        other = b["doubling"][key]
        if key.endswith("_reverse"):
            top = max(float(y.abs().max()) for y in other)
            d = max(float((x - y).abs().max()) for x, y in zip(outs, other))
            rtol = cs.L2_F32_RTOL if "float32" in key else cs.GRAD_RTOL
            cs.check(d <= rtol * top, f"{label}: L4 {key} cotangents "
                     f"{d:.3e} from this checkout's (largest {top:.3e})")
            errs[f"ladder_doubling_{key}_max_rel"] = d / max(top, 1e-300)
            errs[f"ladder_doubling_{key}_same_bits"] = all(
                torch.equal(x, y) for x, y in zip(outs, other))
            continue
        same = all(torch.equal(x, y) for x, y in zip(outs, other))
        cs.check(same, f"{label}: L4 {key} outputs differ from this "
                 f"checkout's")
        errs[f"ladder_doubling_{key}_same_bits"] = same
    for key, outs in a.get("dense", {}).items():
        other = b["dense"][key]
        f32 = "float32" in key
        if key.endswith("_reverse"):
            top = max(float(y.abs().max()) for y in other)
            d = max(float((x - y).abs().max()) for x, y in zip(outs, other))
            rtol = DENSE_F32_RTOL if f32 else cs.GRAD_RTOL
            cs.check(d <= rtol * top, f"{label}: L3 {key} cotangents {d:.3e} "
                     f"from this checkout's (largest {top:.3e})")
            errs[f"ladder_dense_{key}_max_rel"] = d / max(top, 1e-300)
            continue
        tol = cs.LADDER_ATOL["float32" if f32 else "float64"]
        conv = outs[7] & other[7]
        d = max(float((x - y)[conv].abs().max()) if bool(conv.any()) else 0.0
                for x, y in zip(outs[:6], other[:6]))
        cs.check(d <= tol and (f32 or torch.equal(outs[6], other[6])),
                 f"{label}: L3 {key} outputs {d:.3e} from this checkout's "
                 f"(iterations {outs[6].tolist()[:4]} vs "
                 f"{other[6].tolist()[:4]})")
        errs[f"ladder_dense_{key}_max_abs"] = d
    for key, outs in a.get("i2", {}).items():
        other = b["i2"][key]
        d = max(cs.max_err(x, y) / max(1.0, float(y.abs().max()))
                for x, y in zip(outs, other))
        cs.check(d <= cs.KERNEL_ATOL,
                 f"{label}: I2 {key} outputs {d:.3e} from this checkout's")
        errs[f"i2_{key}_max_abs"] = d
        errs[f"i2_{key}_same_bits"] = all(
            cs.same_bits(torch, x, y) for x, y in zip(outs, other))
    for key, outs in a.get("wide", {}).items():
        same = all(torch.equal(x, y) for x, y in zip(outs, b["wide"][key]))
        cs.check(same, f"{label}: B1 {key} outputs differ from this "
                 f"checkout's")
        errs[f"wide_{key}_same_bits"] = same
    for key, outs in a.get("topo", {}).items():
        other = b["topo"][key]
        same1 = all(torch.equal(x, y) for x, y in zip(outs["t1"],
                                                        other["t1"]))
        cs.check(same1, f"{label}: T1 {key} booleans differ from this "
                 f"checkout's")
        (la, wa, va, ia), (lb, wb, vb, ib) = outs["screen"], other["screen"]
        d = max(cs.max_err(la, lb), cs.max_err(wa, wb),
                *(cs.max_err(x, y) for x, y in zip(outs["detail"],
                                                   other["detail"])))
        cs.check(torch.equal(ia, ib) and torch.equal(va, vb)
                 and d <= cs.TOPO_ATOL,
                 f"{label}: T2 {key} outputs {d:.3e} from this checkout's "
                 f"(flags equal {torch.equal(ia, ib)}, violations equal "
                 f"{torch.equal(va, vb)})")
        errs[f"topo_{key}_t2_max_abs"] = d
        errs[f"topo_{key}_t2_same_bits"] = all(
            torch.equal(x, y) for x, y in zip(outs["screen"] + outs["detail"],
                                              other["screen"]
                                              + other["detail"]))
    for key, x in a.get("residual", {}).items():
        y = b["residual"][key]
        d = cs.max_err(x, y) / max(1.0, float(y.abs().max()))
        tol = cs.KERNEL_ATOL_F32 if "f32" in key else cs.KERNEL_ATOL
        cs.check(d <= tol, f"{label}: residual {key} outputs {d:.3e} from "
                 f"this checkout's")
        errs[f"residual_{key}_max_abs"] = d
        errs[f"residual_{key}_same_bits"] = cs.same_bits(torch, x, y)
        # entries whose bits differ, in the theta rows and in the V rows
        n = x.shape[1] // 2
        ints = torch.int64 if x.dtype == torch.float64 else torch.int32
        moved = x.view(ints) != y.view(ints)
        errs[f"residual_{key}_moved_theta_v"] = [int(moved[:, :n].sum()),
                                                 int(moved[:, n:].sum())]
    for key, outs in a.get("bus_reduce", {}).items():
        same = all(torch.equal(x, y) if x.dtype == torch.int32
                   else cs.same_bits(torch, x, y)
                   for x, y in zip(outs, b["bus_reduce"][key]))
        cs.check(same, f"{label}: Q1 {key} accumulators differ from this "
                 f"checkout's")
        errs[f"bus_reduce_{key}_same_bits"] = same
    for key, outs in a.get("groups", {}).items():
        same = all(torch.equal(x, y) for x, y in zip(outs, b["groups"][key]))
        cs.check(same, f"{label}: G1 {key} outputs differ from this "
                 f"checkout's")
        errs[f"groups_{key}_same"] = same
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
                         "and K2), solvers (I1, F1's tile mode and warp "
                         "form, K2's per-lane form), ladder (L1), vjp (L2), "
                         "dense (L3), doubling (L4 and its reverse mode), "
                         "superstep (phase 26 (b)'s rounds), qsts (QSTS "
                         "phase (d)'s scenario-steps/s), "
                         "i2 (I2 a call and a backward), wide (B1 from "
                         "2^15 nodes), topo (T1 and T2 at mesh118 x 4096 "
                         "and x 64, mesh2000 x 16384), residual (J1 and J2 "
                         "at mesh2000 x 256 and x 64), bus_reduce (Q1 at "
                         "mesh2000 x 1/64/256, mesh5000 x 64), groups (G1 "
                         "at N = 1024 x 1/16/64 and 4096 x 1)")
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
                        "F1 tile mode mesh118 x 1024, warp form mesh2000 x "
                        "1; K2 per-lane mesh118 x 118; L1 radial10k x "
                        "{1, 64} f64/f32, vvc_9bus x 64, 20 iterations; "
                        "L2 radial10k x {1, 64} f64/f32, vvc_9bus x 64, 20 "
                        "iterates; L3 radial2048 x 64 f64/f32, vvc_9bus x "
                        "64, 20 iterations, fixed, solve and reverse; L4 "
                        "radial10k x {1, 64} f64, x 64 f32, radial2048 x "
                        "64, vvc_9bus x 64, fixed, solve and reverse; I2 "
                        "the CIM "
                        "feeder x 64, a call and a 60-iteration backward; "
                        "B1 2^15 x 4, 40961 x 1, 2^16 x 1, 64 rounds; T1 "
                        "and T2 mesh118 x 4096 and x 64 (rank 2), mesh2000 "
                        "x 16384 (rank <= 3); J1 (f64, f32, status) and J2 "
                        "(MASKED, FULL) at the bench's mesh2000 x 256 and "
                        "x 64; Q1 mesh2000 x 1/64/256, mesh5000 x 64; G1 "
                        "N = 1024 x 1 (the superstep's reach; sparse x 1, "
                        "16, 64) and 4096 x 1",
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
                for key, dev in times.get("ladder", {}).items():
                    print(f"ab {other.name} ladder_solve {key:<28} {which:<5}"
                          f" device (queued events) {dev:.4f} ms", flush=True)
                for key, ms in times.get("superstep", {}).items():
                    print(f"ab {other.name} superstep {key:<10} {which:<5} "
                          f"(CUDA events, median of rounds 2-"
                          f"{cs.SUPERSTEP_ROUNDS}) {ms:.4f} ms", flush=True)
                qv = times.get("qsts")
                if qv:
                    print(f"ab {other.name} qsts (d) vvc_9bus x64 x96 "
                          f"{which:<5} {qv['scenario_steps_per_sec']:.1f} "
                          f"scenario-steps/s (median of {qv['runs']})",
                          flush=True)
                for key, dev in times.get("vjp", {}).items():
                    print(f"ab {other.name} ladder_vjp {key:<28} {which:<5}"
                          f" device (queued events) {dev:.4f} ms", flush=True)
                for key, dev in times.get("doubling", {}).items():
                    print(f"ab {other.name} ladder_doubling {key:<34} "
                          f"{which:<5} device (queued events) {dev:.4f} ms",
                          flush=True)
                for key, dev in times.get("dense", {}).items():
                    print(f"ab {other.name} ladder_dense {key:<34} {which:<5}"
                          f" device (queued events) {dev:.4f} ms", flush=True)
                for key, dev in times.get("i2", {}).items():
                    if key != "form":
                        print(f"ab {other.name} cim_vjp {key:<14} {which:<5} "
                              f"({times['i2']['form']}) device (queued "
                              f"events) {dev:.4f} ms", flush=True)
                for key, dev in times.get("topo", {}).items():
                    print(f"ab {other.name} topo {key:<28} {which:<5} "
                          f"device (queued events) {dev:.4f} ms", flush=True)
                for key, dev in times.get("residual", {}).items():
                    print(f"ab {other.name} residual {key:<16} {which:<5} "
                          f"device (queued events) {dev:.4f} ms", flush=True)
                for key, dev in times.get("bus_reduce", {}).items():
                    print(f"ab {other.name} qsts_bus_reduce {key:<16} "
                          f"{which:<5} device (queued events) {dev:.4f} ms",
                          flush=True)
                for key, dev in times.get("groups", {}).items():
                    how = ("CUDA events a call" if key.endswith("_a_call")
                           else "device (queued events)")
                    print(f"ab {other.name} form_groups {key:<34} {which:<5}"
                          f" {how} {dev:.4f} ms", flush=True)
                for key, ms in times.get("wide", {}).items():
                    if not key.endswith("_form"):
                        print(f"ab {other.name} lb_rounds {key:<12} {which:<5}"
                              f" ({times['wide'][key + '_form']}) "
                              f"{cs.WIDE_ROUNDS} rounds {ms:.3f} ms",
                              flush=True)
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
