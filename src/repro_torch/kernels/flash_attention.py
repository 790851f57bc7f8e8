"""Flash attention with an in-band logit-max profile: the Hopper kernel's
wrapper and its plain PyTorch version.

The port of :mod:`repro.kernels.flash_attention`: causal or non-causal
attention over ``q [B, H, T, D]`` and ``k, v [B, H, S, D]`` (KV heads
already broadcast), bf16 or fp32 in, output in the input type, plus one
profile word per ``(b, h, q_block)``, the running max of the scaled logits
``q k^T / sqrt(D)`` over that block's rows (masked logits count as -1e30,
as in the reference).  q is scaled by ``1/sqrt(D)`` in fp32 before the
dot, and the output is ``acc / max(l, 1e-30)`` cast to the input type.

``q_block``/``kv_block`` are validated as in the reference
(``min(block, dim)`` must divide the dim); ``q_block`` fixes only the
profile's granularity, and the CUDA kernel (``csrc/flash_attention.cu``)
chooses its own tiles.

:func:`flash_attention` sends CPU tensors to the plain version and CUDA
tensors to the kernel, which raises on what it does not take; it never
falls back from one to the other.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import build

KERNEL = "flash_attention"
NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


def blocks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_block: int,
           kv_block: int) -> Tuple[int, int]:
    """The profile's ``q_blk`` and ``kv_blk``; raises as the reference does."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"need q [B,H,T,D], k = v [B,H,S,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, T, D = q.shape
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch, heads or head dim")
    S = k.shape[2]
    q_blk, kv_blk = min(q_block, T), min(kv_block, S)
    if T % q_blk or S % kv_blk:
        raise ValueError(f"T={T}/S={S} must divide blocks {q_blk}/{kv_blk}")
    return q_blk, kv_blk


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, q_block: int = 128, kv_block: int = 128,
    profile: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain PyTorch version: the whole score matrix in fp32, one
    softmax, one product with V."""
    q_blk, _ = blocks(q, k, v, q_block, kv_block)
    B, H, T, D = q.shape
    S = k.shape[2]
    s = (q.to(torch.float32) * (1.0 / math.sqrt(D))) @ \
        k.to(torch.float32).transpose(-1, -2)                 # [B,H,T,S]
    if causal:
        mask = (torch.arange(S, device=q.device)[None, :]
                <= torch.arange(T, device=q.device)[:, None])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    out = (p @ v.to(torch.float32)) / torch.clamp(l, min=1e-30)
    prof = (torch.amax(m.reshape(B, H, T // q_blk, q_blk), dim=-1)
            if profile else None)
    return out.to(q.dtype), prof


@functools.cache
def _entry(dtype: torch.dtype):
    fn = getattr(build.load(KERNEL), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, q_block: int = 128, kv_block: int = 128,
    profile: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the Hopper kernel on the current stream (no synchronise)."""
    q_blk, _ = blocks(q, k, v, q_block, kv_block)
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention_cuda takes float32 or bfloat16 "
                        f"operands of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention_cuda needs contiguous operands")
    B, H, T, D = q.shape
    S = k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda takes head dims {HEAD_DIMS}, "
                         f"got {D}")
    out = torch.empty_like(q)
    # profile words are folded across CUDA blocks as order-preserving int
    # keys; the zeroed buffer is below every float's key
    prof = (torch.zeros((B, H, T // q_blk), dtype=torch.float32,
                        device=q.device) if profile else None)
    fn = _entry(q.dtype)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 prof.data_ptr() if profile else None, B * H, T, S, D,
                 q_blk, int(causal), 1.0 / math.sqrt(D),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {err}")
    build.count_launch(KERNEL)
    return out, prof


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, q_block: int = 128, kv_block: int = 128,
    profile: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns ``(out [B, H, T, D], profile [B, H, T/q_blk] or None)``: the
    plain version for CPU tensors, else the kernel."""
    kw = dict(causal=causal, q_block=q_block, kv_block=kv_block,
              profile=profile)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, **kw)
    return flash_attention_cuda(q, k, v, **kw)
