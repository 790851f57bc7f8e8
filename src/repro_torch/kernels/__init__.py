"""Hand-written Hopper kernels for the in-band profiled hot spots.

Each ported kernel has a CUDA source (``csrc/<name>.cu``, built on first
use by :mod:`.build`), a wrapper with a plain PyTorch version beside it
(``<module>.py``), an entry point (``ops.py``) and a plain oracle
(``ref.py``).  Ported so far: ``profiled_matmul``, ``ssd_state_passing``
(``ssd_scan.py``) and ``flash_attention``.
"""
from .build import launch_counts, reset_launch_counts
from .flash_attention import flash_attention
from .profiled_matmul import profiled_matmul
from .ssd_scan import ssd_state_passing
from . import ops, ref

__all__ = ["launch_counts", "reset_launch_counts", "flash_attention",
           "profiled_matmul", "ssd_state_passing", "ops", "ref"]
