"""Public entry points of the kernel layer (port of :mod:`repro.kernels.ops`).

The reference's signatures minus ``interpret``: PyTorch runs eagerly, and
the device of the tensors decides between the plain version (CPU) and the
Hopper kernel (CUDA).
"""
from __future__ import annotations

from .profiled_matmul import profiled_matmul


def profiled_matmul_op(a, b, *, block_m=256, block_n=256, block_k=512,
                       profile=True):
    """``(a @ b, per-(block_m, block_n) tile max |acc|)``; see
    :func:`repro_torch.kernels.profiled_matmul.profiled_matmul`."""
    return profiled_matmul(a, b, block_m=block_m, block_n=block_n,
                           block_k=block_k, profile=profile)
