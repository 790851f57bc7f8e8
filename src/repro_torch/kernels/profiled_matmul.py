"""Blocked matmul with an in-band profile epilogue: the Hopper kernel's wrapper
and its plain PyTorch version.

The port of :mod:`repro.kernels.profiled_matmul`, the paper's Listing 1 in a
GEMM: the product ``a @ b`` (fp32 accumulator, output in ``a.dtype``) plus
one profile word per ``(block_m, block_n)`` output tile, the tile's
``max |acc|`` taken from the fp32 accumulator before the cast.  The blocks
fix the profile's granularity and are validated as in the reference
(``min(block, dim)`` must divide the dim); the CUDA kernel chooses its own
tiling (``csrc/profiled_matmul.cu``).

:func:`profiled_matmul` sends CPU tensors to the plain version and CUDA
tensors to the kernel, which raises on what it does not take; it never
falls back from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

KERNEL = "profiled_matmul"
_ENTRY = {torch.float32: "profiled_matmul_f32",
          torch.bfloat16: "profiled_matmul_bf16"}
_FNS = {}


def profile_blocks(a: torch.Tensor, b: torch.Tensor, block_m: int,
                   block_n: int, block_k: int) -> Tuple[int, int]:
    """The profile tile ``(bm, bn)``; raises as the reference does."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"need a [M,K] @ [K,N], got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    (M, K), N = a.shape, b.shape[1]
    bm, bn, bk = min(block_m, M), min(block_n, N), min(block_k, K)
    if M % bm or N % bn or K % bk:
        raise ValueError(f"dims {(M, K, N)} must divide blocks {(bm, bk, bn)}")
    return bm, bn


def profiled_matmul_plain(
    a: torch.Tensor, b: torch.Tensor, *, block_m: int = 256,
    block_n: int = 256, block_k: int = 512, profile: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain PyTorch version: widen to fp32, multiply, cast, profile."""
    bm, bn = profile_blocks(a, b, block_m, block_n, block_k)
    acc = a.to(torch.float32) @ b.to(torch.float32)
    M, N = acc.shape
    prof = (acc.abs().reshape(M // bm, bm, N // bn, bn).amax(dim=(1, 3))
            if profile else None)
    return acc.to(a.dtype), prof


def _entry(dtype: torch.dtype):
    fn = _FNS.get(dtype)
    if fn is None:
        fn = getattr(build.load(KERNEL), _ENTRY[dtype])
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return fn


def profiled_matmul_cuda(
    a: torch.Tensor, b: torch.Tensor, *, block_m: int = 256,
    block_n: int = 256, block_k: int = 512, profile: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the Hopper kernel on the current stream (no synchronise)."""
    bm, bn = profile_blocks(a, b, block_m, block_n, block_k)
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError("profiled_matmul_cuda needs both operands on one "
                         f"CUDA device, got {a.device} and {b.device}")
    if a.dtype not in _ENTRY or b.dtype != a.dtype:
        raise TypeError("profiled_matmul_cuda takes float32 or bfloat16 "
                        f"operands of one dtype, got {a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("profiled_matmul_cuda needs contiguous operands")
    (M, K), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    prof = (torch.zeros((M // bm, N // bn), dtype=torch.float32,
                        device=a.device) if profile else None)
    fn = _entry(a.dtype)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 prof.data_ptr() if profile else None, M, N, K, bm, bn,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"profiled_matmul kernel launch failed: "
                           f"cudaError_t {err}")
    build.count_launch(_ENTRY[a.dtype])
    return out, prof


def profiled_matmul(
    a: torch.Tensor, b: torch.Tensor, *, block_m: int = 256,
    block_n: int = 256, block_k: int = 512, profile: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns ``(a @ b, tile_absmax [M/bm, N/bn])`` (``None`` without
    ``profile``): the plain version for CPU tensors, else the kernel."""
    kw = dict(block_m=block_m, block_n=block_n, block_k=block_k,
              profile=profile)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return profiled_matmul_plain(a, b, **kw)
    return profiled_matmul_cuda(a, b, **kw)
