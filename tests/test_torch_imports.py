"""The PyTorch port stands alone: no JAX, nothing of ``freedm_tpu``, the
card unless the CPU is asked for, and the reference's backend and
precision resolution."""

import ast
import os
import subprocess
import sys
from pathlib import Path

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
        "          'freedm_tpu_torch.kernels.topo_kernels'):\n"
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
    assert int(out.stdout.split()[-1]) >= 28  # every module was imported


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
            PACKAGE / "kernels" / "topo_kernels.py"} <= set(files)
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
    assert solve.__qualname__.startswith("make_sparse_newton_solver")
    assert fixed.__qualname__.startswith("make_sparse_newton_solver")
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

    assert set(lk.launches()) == {"ladder_solve", "ladder_vjp"}
    from freedm_tpu_torch.kernels import qsts_kernels as qk

    assert set(qk.launches()) == {"agent_step", "qsts_bus_reduce",
                                  "qsts_feeder_reduce"}
    from freedm_tpu_torch.kernels import topo_kernels as tk

    assert set(tk.launches()) == {"topo_radiality", "topo_screen"}
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
