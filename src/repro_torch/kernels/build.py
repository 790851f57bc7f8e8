"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one source ``csrc/<name>.cu`` with a plain C interface.  On
first use it is compiled with ``nvcc`` for ``sm_90a`` into a shared library
under ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source and the flags so that an
edited source rebuilds, and loaded with ``ctypes``.  Nothing is built when
this module is imported.

Every wrapper counts its launches here (:func:`count_launch`), so a run can
show that it went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LAUNCHES: Dict[str, int] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` is built, keyed by content."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> str:
    """Compile kernel ``name`` unless it is built already.  Returns the
    compiler log (register and shared-memory use from ``-Xptxas -v``; empty
    when nothing was built); raises if ``nvcc`` fails."""
    out = library_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(".tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if need be."""
    lib = _LIBS.get(name)
    if lib is None:
        build(name)
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def count_launch(name: str) -> None:
    _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel name since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()
