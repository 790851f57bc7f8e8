"""Hand-written Hopper kernels for the in-band profiled hot spots.

Each ported kernel has a CUDA source (``csrc/<name>.cu``, built on first
use by :mod:`.build`), a wrapper with a plain PyTorch version beside it
(``<name>.py``), an entry point (``ops.py``) and a plain oracle
(``ref.py``).  Ported so far: ``profiled_matmul``.
"""
from .build import launch_counts, reset_launch_counts
from .profiled_matmul import profiled_matmul
from . import ops, ref

__all__ = ["launch_counts", "reset_launch_counts", "profiled_matmul",
           "ops", "ref"]
