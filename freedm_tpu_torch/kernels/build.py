"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded
with :mod:`ctypes` — seconds per build, where a source that includes
PyTorch's headers takes minutes.  The library lands in ``_build/``
beside this file (listed in ``.gitignore``) under a name that carries a
hash of the source and the flags, so an edited source is rebuilt and a
stale library is never loaded.

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
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

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


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (content-addressed)."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + "\0".join(NVCC_FLAGS).encode()).hexdigest()
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
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
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


def build_log(name: str) -> str:
    """The compiler's report of the last build of ``csrc/<name>.cu``."""
    return library_path(name).with_suffix(".log").read_text()


def triton_cache_dir() -> str:
    """Point Triton's compile cache into ``_build/`` (unless the caller
    chose one), so kernels compiled from this checkout stay inside it."""
    path = str(BUILD_DIR / "triton")
    os.environ.setdefault("TRITON_CACHE_DIR", path)
    return os.environ["TRITON_CACHE_DIR"]
