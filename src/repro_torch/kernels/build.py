"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one source ``csrc/<name>.cu`` with a plain C interface
(:data:`KERNELS` lists them).  On first use, or all at once through
:func:`build_all` (one ``nvcc`` per source, started together), it is
compiled for ``sm_90a`` into a shared library under ``build/kernels/`` at
the root of the checkout (listed in ``.gitignore``), named by a hash of the
source and the flags so that an edited source rebuilds, and loaded with
``ctypes``.  Nothing is built when this module is imported.

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
from typing import Dict, Iterable

KERNELS = ("profiled_matmul", "ssd_state_passing", "flash_attention")
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
    return build_all((name,))[name]


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every kernel of ``names`` that is not built yet, one ``nvcc``
    per source, all started together.  Returns each kernel's compiler log
    (empty when nothing was built); raises if any ``nvcc`` fails."""
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        jobs[name] = (out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {name: "" for name in names}
    failed = []
    for name, (out, tmp, proc) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


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
