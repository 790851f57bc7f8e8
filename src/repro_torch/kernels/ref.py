"""Plain torch oracles for the ported kernels (port of :mod:`repro.kernels.ref`)."""
from __future__ import annotations

from typing import Tuple

import torch


def matmul_reference(a: torch.Tensor,
                     b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(a @ b`` in ``a.dtype``, the fp32 product``)``."""
    out = a.to(torch.float32) @ b.to(torch.float32)
    return out.to(a.dtype), out


def tile_absmax_reference(a: torch.Tensor, b: torch.Tensor, block_m: int,
                          block_n: int) -> torch.Tensor:
    """``max |a @ b|`` over each ``(block_m, block_n)`` tile, in fp32."""
    out = a.to(torch.float32) @ b.to(torch.float32)
    M, N = out.shape
    tiles = out.reshape(M // block_m, block_m, N // block_n, block_n)
    return tiles.abs().amax(dim=(1, 3))
