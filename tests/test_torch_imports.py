"""The PyTorch port stands alone: no JAX, nothing of ``freedm_tpu``, the
card unless the CPU is asked for, and the reference's backend and
precision resolution."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from freedm_tpu.pf.krylov import resolve_precision as ref_resolve_precision
from freedm_tpu.pf.sparse import resolve_backend as ref_resolve_backend
from freedm_tpu_torch import device as port_device
from freedm_tpu_torch.grid import cases, matpower
from freedm_tpu_torch.grid.bus import ybus_dense
from freedm_tpu_torch.pf.backend import (
    SPARSE_AUTO_MIN_BUSES,
    resolve_backend,
    resolve_precision,
)
from freedm_tpu_torch.pf.newton import make_newton_solver

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "freedm_tpu_torch"


def _is_forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "freedm_tpu")


def test_importing_every_module_pulls_in_no_jax_or_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import freedm_tpu_torch\n"
        "for m in pkgutil.walk_packages(freedm_tpu_torch.__path__,\n"
        "                               'freedm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('freedm_tpu_torch.serve.cache', 'freedm_tpu_torch.pf.mfree',\n"
        "          'freedm_tpu_torch.pf.n1', 'freedm_tpu_torch.pf.dc',\n"
        "          'freedm_tpu_torch.kernels.cache_kernels',\n"
        "          'freedm_tpu_torch.kernels.screen_kernels',\n"
        "          'freedm_tpu_torch.kernels.ladder_kernels',\n"
        "          'freedm_tpu_torch.grid.feeder', 'freedm_tpu_torch.cplx',\n"
        "          'freedm_tpu_torch.pf.sweeps', 'freedm_tpu_torch.pf.ladder',\n"
        "          'freedm_tpu_torch.modules.vvc',\n"
        "          'freedm_tpu_torch.kernels.qsts_kernels',\n"
        "          'freedm_tpu_torch.runtime.checkpoint',\n"
        "          'freedm_tpu_torch.scenarios.profiles',\n"
        "          'freedm_tpu_torch.scenarios.agents',\n"
        "          'freedm_tpu_torch.scenarios.engine',\n"
        "          'freedm_tpu_torch.scenarios.jobs',\n"
        "          'freedm_tpu_torch.pf.topo',\n"
        "          'freedm_tpu_torch.kernels.topo_kernels',\n"
        "          'freedm_tpu_torch.kernels.solver_kernels',\n"
        "          'freedm_tpu_torch.pf.fdlf', 'freedm_tpu_torch.pf.krylov',\n"
        "          'freedm_tpu_torch.pf.cim',\n"
        "          'freedm_tpu_torch.grid.topology',\n"
        "          'freedm_tpu_torch.modules.gm', 'freedm_tpu_torch.modules.lb',\n"
        "          'freedm_tpu_torch.modules.sc',\n"
        "          'freedm_tpu_torch.parallel.superstep',\n"
        "          'freedm_tpu_torch.devices.schema',\n"
        "          'freedm_tpu_torch.devices.tensor',\n"
        "          'freedm_tpu_torch.kernels.dgi_kernels',\n"
        "          'freedm_tpu_torch.utils.textio',\n"
        "          'freedm_tpu_torch.core.config'):\n"
        "    assert m in sys.modules, m\n"
        "import chip_smoke, kernel_ab\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'freedm_tpu'))\n"
        "print(len([k for k in sys.modules if k.startswith('freedm_tpu_torch')]))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 30  # every module was imported


def test_static_scan_finds_no_jax_or_reference_import():
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py",
                                             REPO / "kernel_ab.py"]
    assert len(files) >= 15
    # Among them the modules the kernel redesigns touch, the cache
    # slice's and the screening slice's.
    assert {PACKAGE / "kernels" / "newton_kernels.py",
            PACKAGE / "kernels" / "screen_kernels.py",
            PACKAGE / "pf" / "dc.py",
            PACKAGE / "kernels" / "sparse_kernels.py",
            PACKAGE / "pf" / "newton.py", PACKAGE / "pf" / "sparse.py",
            PACKAGE / "pf" / "krylov.py",
            PACKAGE / "kernels" / "cache_kernels.py",
            PACKAGE / "pf" / "mfree.py", PACKAGE / "pf" / "n1.py",
            PACKAGE / "serve" / "cache.py",
            PACKAGE / "kernels" / "ladder_kernels.py",
            PACKAGE / "grid" / "feeder.py", PACKAGE / "pf" / "sweeps.py",
            PACKAGE / "pf" / "ladder.py", PACKAGE / "modules" / "vvc.py",
            PACKAGE / "cplx.py", PACKAGE / "kernels" / "qsts_kernels.py",
            PACKAGE / "runtime" / "checkpoint.py",
            PACKAGE / "scenarios" / "profiles.py",
            PACKAGE / "scenarios" / "agents.py",
            PACKAGE / "scenarios" / "engine.py",
            PACKAGE / "scenarios" / "jobs.py",
            PACKAGE / "pf" / "topo.py",
            PACKAGE / "kernels" / "topo_kernels.py",
            PACKAGE / "kernels" / "solver_kernels.py",
            PACKAGE / "pf" / "fdlf.py", PACKAGE / "pf" / "cim.py",
            PACKAGE / "grid" / "bus.py",
            PACKAGE / "core" / "metrics.py",
            PACKAGE / "grid" / "topology.py", PACKAGE / "modules" / "gm.py",
            PACKAGE / "modules" / "lb.py", PACKAGE / "modules" / "sc.py",
            PACKAGE / "parallel" / "superstep.py",
            PACKAGE / "devices" / "schema.py",
            PACKAGE / "devices" / "tensor.py",
            PACKAGE / "kernels" / "dgi_kernels.py",
            PACKAGE / "utils" / "textio.py",
            PACKAGE / "core" / "config.py"} <= set(files)
    found = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.name}:{node.lineno} {n}" for n in names
                      if _is_forbidden(n)]
    assert found == []


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    sys_ = matpower.load_builtin("case14")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_newton_solver(sys_)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ybus_dense(sys_)
    assert port_device.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        port_device.resolve_device("meta")
    assert port_device.platform_name(torch.device("cuda")) == "gpu"
    assert port_device.platform_name(torch.device("cpu")) == "cpu"


def test_dgi_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    from freedm_tpu_torch.grid import topology
    from freedm_tpu_torch.modules import gm, lb
    from freedm_tpu_torch.parallel import make_superstep

    topo = topology.parse_topology("edge a b\nfid b c F\n")
    calls = (
        lambda: gm.form_groups(np.ones(3), np.ones((3, 3))),
        lambda: lb.lb_round(np.zeros(3), np.zeros(3), np.ones((3, 3)), 1.0),
        lambda: lb.run_rounds(np.zeros(3), np.zeros(3), np.ones((3, 3)), 1.0,
                              2),
        lambda: topology.make_reachability(topo),
        lambda: topology.node_reachability(topo, ("x",)),
        lambda: make_superstep(),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("backend,n", [
    ("dense", 14), ("dense", 2000), ("auto", 118),
    ("auto", SPARSE_AUTO_MIN_BUSES - 1),
    ("sparse", 14), ("auto", SPARSE_AUTO_MIN_BUSES), ("auto", 2000),
])
def test_backend_resolution_matches_reference(backend, n):
    assert resolve_backend(backend, n) == ref_resolve_backend(backend, n)


def test_auto_backend_hands_large_mesh_to_the_sparse_solver():
    sys_ = cases.synthetic_mesh(SPARSE_AUTO_MIN_BUSES, seed=3)
    solve, fixed = make_newton_solver(sys_, backend="auto", device="cpu")
    # The sparse backend's loops (shared with the matrix-free solver).
    assert solve.__qualname__.startswith("newton_krylov")
    assert fixed.__qualname__.startswith("newton_krylov")
    dense, _ = make_newton_solver(cases.synthetic_mesh(40), backend="auto",
                                  device="cpu")
    assert dense.__qualname__.startswith("make_newton_solver")
    with pytest.raises(ValueError, match="unknown pf backend"):
        resolve_backend("banded", 14)


@pytest.mark.parametrize("precision", ["f64", "mixed", "auto"])
@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_precision_resolution_matches_reference(precision, platform):
    assert (resolve_precision(precision, platform)
            == ref_resolve_precision(precision, backend=platform))


def test_unknown_precision_is_a_typed_error():
    with pytest.raises(ValueError, match="unknown pf precision"):
        resolve_precision("bf16", "gpu")


def test_kernel_wrappers_refuse_bad_inputs_before_any_launch():
    """The validator the wrappers run on CUDA inputs before a launch
    (a CPU call goes to the plain version and never reaches it)."""
    from freedm_tpu_torch.kernels import newton_kernels as nk

    n = 4
    x = torch.zeros(2, 2 * n, dtype=torch.float64)
    y = torch.zeros(n, n, dtype=torch.float64)
    vec = torch.zeros(2, n, dtype=torch.float64)
    mask = torch.zeros(n, dtype=torch.float64)
    assert nk._check(x, y, y, {"p": vec}, {"m": mask}) == n
    with pytest.raises(ValueError, match="contiguous"):
        nk._check(x, y, y, {"p": vec[:, :3]}, {"m": mask})
    with pytest.raises(ValueError, match="float64"):
        nk._check(x, y.float(), y, {"p": vec}, {"m": mask})
    with pytest.raises(TypeError, match="float64 or float32"):
        nk._check(x.half(), y, y, {}, {})
    with pytest.raises(ValueError, match=r"\[B, 2n\]"):
        nk._check(torch.zeros(2, 7, dtype=torch.float64), y, y, {}, {})
    assert set(nk.launches()) == {"newton_assemble", "power_injections",
                                  "newton_update"}
    from freedm_tpu_torch.kernels import sparse_kernels as sk

    assert set(sk.launches()) == {"sparse_assemble", "sparse_matvec",
                                  "gmres_block_orth", "gmres_lstsq"}
    from freedm_tpu_torch.kernels import cache_kernels as ck

    assert set(ck.launches()) == {"delta_program"}
    from freedm_tpu_torch.kernels import screen_kernels as sck

    assert set(sck.launches()) == {"smw_sweep", "dc_screen"}
    from freedm_tpu_torch.kernels import ladder_kernels as lk

    assert set(lk.launches()) == {"ladder_solve", "ladder_vjp",
                                  "ladder_dense", "ladder_doubling"}
    assert {k: set(v) for k, v in lk.mode_launches().items()} == {
        k: {"forward", "reverse"} for k in ("ladder_dense",
                                            "ladder_doubling")}
    from freedm_tpu_torch.cplx import C

    meta64 = torch.zeros(2, 4, 3, dtype=torch.float64, device="meta")
    for fn in (lk.ladder_dense, lk.ladder_doubling):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            fn(C(meta64, meta64), None, None, 1e-4, 20, True)
    for fn in (lk.ladder_dense_vjp, lk.ladder_doubling_vjp):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            fn(meta64, C(meta64, meta64), None, None, None, None)
    from freedm_tpu_torch.kernels import qsts_kernels as qk

    assert set(qk.launches()) == {"agent_step", "qsts_bus_reduce",
                                  "qsts_feeder_reduce"}
    from freedm_tpu_torch.kernels import topo_kernels as tk

    assert set(tk.launches()) == {"topo_radiality", "topo_screen"}
    from freedm_tpu_torch.kernels import solver_kernels as sol

    assert set(sol.launches()) == {"ybus_stamp", "fdlf_half_step",
                                   "residual_jvp", "cim_iterate",
                                   "residual_vjp", "cim_vjp"}
    from freedm_tpu_torch.kernels import dgi_kernels as dk

    assert set(dk.launches()) == {"form_groups", "reach_closure",
                                  "lb_rounds"}
    meta32 = torch.zeros(2, 4, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        dk.form_groups(meta32.bool(), meta32[None], None)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        dk.reach_closure(None, meta32)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        dk.lb_rounds(meta32, meta32, None, 1.0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        dk._want(torch.device("cpu"), gid=(
            torch.zeros(4, 4, dtype=torch.int32)[:, :2], torch.int32, (4, 2)))
    with pytest.raises(TypeError, match="float32 or float64"):
        dk._lb_inputs(torch.zeros(3, dtype=torch.float16), torch.zeros(3))
    with pytest.raises(ValueError, match="exactly one round"):
        dk.lb_rounds_plain(torch.zeros(1, 3), torch.zeros(1, 3),
                           torch.zeros(1, 3, dtype=torch.int32), 1.0, 2,
                           round_outputs=True)
    assert dk.g1_global_plan(1024, 1, 132).grid == 128 and dk.g1_staged(1024)
    assert dk.g1_global_plan(4096, 1, 132).grid == 132
    assert not dk.g1_staged(4096)
    assert dk.g1_global_plan(256, 256, 264).grid == 264
    assert dk.lb_form(4096, 8) == dk.SHARED
    assert dk.lb_form(dk.LB_WIDE_NODES - 1, 8) == dk.GLOBAL
    assert dk.lb_form(dk.LB_WIDE_NODES, 4) == dk.CLUSTER
    assert dk.lb_form(dk.LB_MAX_NODES, 8) == dk.WIDE
    assert dk.LB_WIDE_NODES == 1 << 15 and dk.LB_MAX_NODES >= 1 << 30
    assert dk.lb_state_bytes(1 << 16, 8) == 20 * (1 << 16) + 8 * (1 << 16)
    for x in (torch.zeros(2, 8, dtype=torch.float64, device="meta"),):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            sol.residual_jvp(x, x, None)
        with pytest.raises(ValueError, match="CPU or CUDA"):
            sol.fdlf_half_step(sol.INIT, x, *[None] * 15)
        with pytest.raises(ValueError, match="CPU or CUDA"):
            sol.residual_vjp(x, x, None, None, sol.MASKED)
        with pytest.raises(ValueError, match="CPU or CUDA"):
            sol.cim_vjp(*[None] * 4, x, *[None] * 8)
    with pytest.raises(ValueError, match="unknown ybus_stamp mode"):
        sol._check_stamp_mode(7)
    with pytest.raises(ValueError, match="unknown fdlf_half_step mode"):
        sol._check_fdlf_mode(3)
    # Neither CPU nor CUDA: refused before the library loads.
    meta = torch.zeros(2, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.topo_radiality(meta, None, 3)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.topo_screen(meta.double(), None, meta, 1.0, None)
    with pytest.raises(ValueError, match=r"\[V, r\]"):
        tk._slots_shape(torch.zeros(2, 7, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        tk._want(torch.device("cpu"), slots=(
            torch.zeros(4, 4, dtype=torch.int32)[:, :2], torch.int32,
            (4, 2)))
    with pytest.raises(TypeError, match="float64 or float32"):
        lk._suffix(torch.float16)
    vb = torch.zeros(2, 17, 8, dtype=torch.float64)
    with pytest.raises(ValueError, match="contiguous"):
        sk._want(vb, {"w": (vb[:, :4], torch.float64, (2, 4, 8))})
    with pytest.raises(TypeError, match="float64 or float32"):
        sk._want(vb.half(), {})
