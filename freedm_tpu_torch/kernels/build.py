"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded
with :mod:`ctypes` — seconds per build, where a source that includes
PyTorch's headers takes minutes.  The library lands in ``_build/``
beside this file (listed in ``.gitignore``) under a name that carries a
hash of the source, the shared ``csrc/*.cuh`` headers it may include and
the flags, so an edited source or header is rebuilt and a stale library
is never loaded.

Builds run at first use, never at import.  A process-wide lock keeps two
executor threads from building at once; a file lock does the same for
two processes sharing the checkout.  A failed build raises with the
compiler's output.  ``nvcc``'s ``-Xptxas -v`` report (registers, shared
memory, spills per kernel) is kept beside the library as ``<lib>.log``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

CSRC_DIR = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: Flags of one source on top of :data:`NVCC_FLAGS`: the QSTS kernels are
#: compiled without multiply-add contraction, so each operation rounds as
#: the plain PyTorch version's operation does.
EXTRA_FLAGS = {"qsts": ("-fmad=false",)}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else the one on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels are built "
            "from source at first use"
        )
    return found


def _flags(name: str):
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (content-addressed: the source,
    the shared ``csrc/*.cuh`` headers and the flags)."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        src += b"\0" + header.name.encode() + b"\0" + header.read_bytes()
    digest = hashlib.sha256(src + "\0".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists;
    returns the library's path.  Raises ``RuntimeError`` on failure."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if out.exists():  # another process built it while we waited
                return out
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
            cmd = [nvcc_path(), *_flags(name), "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib


def constants(source: str, *names: str) -> Tuple[int, ...]:
    """``constexpr int`` values of ``csrc/<source>``, the one place each is
    written (a wrapper's launch plan reads them)."""
    text = (CSRC_DIR / source).read_text()
    out = []
    for name in names:
        m = re.search(rf"^constexpr int {name} = (\d+);", text, re.MULTILINE)
        if m is None:
            raise RuntimeError(f"{source} defines no {name}")
        out.append(int(m.group(1)))
    return tuple(out)


def build_log(name: str) -> str:
    """The compiler's report of the last build of ``csrc/<name>.cu``."""
    return library_path(name).with_suffix(".log").read_text()


#: The grid barriers of the persistent cooperative launches by (device,
#: stream): see :func:`grid_barrier`.
_barriers: Dict[Tuple[int, int], torch.Tensor] = {}
_barrier_lock = threading.Lock()


def grid_barrier(device: torch.device, stream: int) -> torch.Tensor:
    """The grid barrier (two int32: arrivals, generation) of the
    persistent cooperative launches on ``stream`` of ``device`` — I2
    ``cim_vjp_walk`` and G1 ``form_groups``, both through
    ``csrc/grid_sync.cuh``.  Zeros, made once a (device, stream), that
    every launch leaves as it found them; launches on one stream run in
    turn, so they share it."""
    key = (device.index, stream)
    with _barrier_lock:
        t = _barriers.get(key)
        if t is None:
            if len(_barriers) >= 64:
                _barriers.clear()
            t = _barriers[key] = torch.zeros(2, dtype=torch.int32,
                                             device=device)
    return t
