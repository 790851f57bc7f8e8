"""Grouped-query attention with three execution paths (port of
:mod:`repro.models.attention`).

  * ``naive``      — full [T, S] scores; smoke tests and tiny shapes.
  * ``flash_tri``  — causal self-attention (T == S) through the Hopper flash
                     attention kernel (``kernels.flash_attention``; its plain
                     PyTorch version for CPU tensors).  The reference's XLA
                     form walks Q chunks over their causal KV prefix; the
                     kernel does the same triangle with its own tiles.
  * ``flash_scan`` — online softmax over KV chunks with masking (any
                     offset, causal or not).

All paths return ``(output, logit_max)`` — the max attention logit is the
in-band profiling tap (overflow sentinel), SPRING-style.

GQA is computed in grouped form [B, T, KV, G, Dh] without repeating KV
heads, except on the kernel path, which takes the KV heads broadcast: query
head ``h`` reads KV head ``h // G``, the grouping of :func:`_group`.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..kernels import flash_attention

NEG_INF = -1e30
KERNEL_BLOCK = 128


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B, T, H, Dh] -> [B, T, KV, G, Dh]."""
    b, t, h, dh = q.shape
    return q.reshape(b, t, n_kv, h // n_kv, dh)


def _scores(qg: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """einsum to [B, KV, G, Tq, Tk] in fp32."""
    return torch.einsum("btkgd,bskd->bkgts", qg.to(torch.float32),
                        k.to(torch.float32)) * scale


def naive_attention(q, k, v, *, causal: bool, q_offset=0,
                    bias=None) -> Tuple[torch.Tensor, torch.Tensor]:
    b, t, h, dh = q.shape
    s = k.shape[1]
    kv = k.shape[2]
    qg = _group(q, kv)
    logits = _scores(qg, k, 1.0 / math.sqrt(dh))
    if causal:
        q_pos = q_offset + torch.arange(t, device=q.device)[:, None]
        kv_pos = torch.arange(s, device=q.device)[None, :]
        logits = logits + torch.where(kv_pos <= q_pos, 0.0, NEG_INF)
    if bias is not None:
        logits = logits + bias
    lmax = torch.amax(logits)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", w, v)
    return out.reshape(b, t, h, dh), lmax


def _online_update(m, l, acc, logits, v_chunk):
    """One online-softmax accumulation step (fp32 state)."""
    m_new = torch.maximum(m, torch.amax(logits, dim=-1))       # [B,KV,G,T]
    alpha = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])                   # [B,KV,G,T,S]
    l_new = l * alpha + torch.sum(p, dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bkgts,bskd->bkgtd", p.to(v_chunk.dtype).to(torch.float32),
        v_chunk.to(torch.float32))
    return m_new, l_new, acc_new


def flash_tri_attention(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal self-attention (T == S) through the flash attention kernel.

    The reference's ``q_chunk``/``kv_chunk`` chose its XLA chunks; the
    kernel picks its own tiles, so the port takes neither.  The profile's
    granularity is 128 rows when T is a multiple of 128, else T (one word
    per head); ``logit_max`` is the max of the profile.
    """
    b, t, h, dh = q.shape
    s, kv = k.shape[1], k.shape[2]
    if t != s:
        raise ValueError("flash_tri is a self-attention path (T == S)")
    g = h // kv
    if g > 1:
        k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    blk = KERNEL_BLOCK if t % KERNEL_BLOCK == 0 else t
    qh = q.transpose(1, 2).contiguous()                       # [B, H, T, D]
    kh = k.transpose(1, 2).contiguous()
    vh = v.transpose(1, 2).contiguous()
    out, prof = flash_attention(qh, kh, vh, causal=True, q_block=blk,
                                kv_block=blk, profile=True)
    return out.transpose(1, 2), torch.amax(prof)


def flash_scan_attention(q, k, v, *, causal: bool, q_offset=0,
                         kv_chunk: int = 2048
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online-softmax attention over KV chunks (long S)."""
    b, t, h, dh = q.shape
    s, n_kv = k.shape[1], k.shape[2]
    kc = min(kv_chunk, s)
    if s % kc:  # pad KV to a chunk multiple; padded positions are masked out
        pad = kc - s % kc
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    n_chunks = k.shape[1] // kc
    qg = _group(q, n_kv)
    scale = 1.0 / math.sqrt(dh)
    g = h // n_kv
    m = torch.full((b, n_kv, g, t), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, n_kv, g, t), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, n_kv, g, t, dh), dtype=torch.float32,
                      device=q.device)
    q_pos = q_offset + torch.arange(t, device=q.device)[:, None]
    for j in range(n_chunks):
        kc_, vc_ = k[:, j * kc:(j + 1) * kc], v[:, j * kc:(j + 1) * kc]
        logits = _scores(qg, kc_, scale)
        kv_pos = j * kc + torch.arange(kc, device=q.device)[None, :]
        if causal:
            logits = logits + torch.where(kv_pos <= q_pos, 0.0, NEG_INF)
        if k.shape[1] != s:  # mask KV padding
            logits = logits + torch.where(kv_pos < s, 0.0, NEG_INF)
        m, l, acc = _online_update(m, l, acc, logits, vc_)
    out = (acc / l[..., None]).to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, dh), torch.amax(m)


def decode_attention(
    q,                      # [B, 1, H, Dh]
    k_cache, v_cache,       # [B, S, KV, Dh]
    cache_len,              # valid positions (int or 0-d tensor)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token attention over a (possibly padded) KV cache."""
    b, t, h, dh = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    qg = _group(q, kv)
    logits = _scores(qg, k_cache, 1.0 / math.sqrt(dh))
    valid = (torch.arange(s, device=q.device) < cache_len)[
        None, None, None, None, :]
    logits = torch.where(valid, logits, NEG_INF)
    lmax = torch.amax(logits)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", w, v_cache)
    return out.reshape(b, t, h, dh), lmax


def attention(
    q, k, v, *, impl: str, causal: bool = True, q_offset=0,
    q_chunk: int = 1024, kv_chunk: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if impl == "naive" or q.shape[1] <= max(64, q_chunk // 8):
        return naive_attention(q, k, v, causal=causal, q_offset=q_offset)
    if impl == "flash_tri" and causal and q.shape[1] == k.shape[1]:
        return flash_tri_attention(q, k, v)
    if impl in ("flash_scan", "flash_tri"):
        return flash_scan_attention(q, k, v, causal=causal, q_offset=q_offset,
                                    kv_chunk=kv_chunk)
    raise ValueError(f"unknown attention impl {impl!r}")
