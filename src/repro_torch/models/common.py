"""Shared model components: norms, rotary embeddings, activation helpers
(port of :mod:`repro.models.common`)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: fp32 reduction, native-dtype application.

    Only the mean-square reduction runs in fp32; the full-width multiply
    stays in the input dtype, as in the reference.
    """
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return x * scale * weight.to(x.dtype)


def rotary_angles(positions: torch.Tensor, dim: int,
                  theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for ``dim`` rotary features at integer ``positions``."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=positions.device) / dim))
    angles = positions.to(torch.float32)[..., None] * inv_freq  # [..., dim/2]
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(
    x: torch.Tensor,            # [..., T, H, Dh]
    positions: torch.Tensor,    # [..., T]
    theta: float = 1e4,
    rotary_fraction: float = 1.0,
) -> torch.Tensor:
    """RoPE on the leading ``rotary_fraction`` of head dims (interleaved
    pairs, as the reference); ``0.5`` gives ChatGLM's "2d" layout."""
    dh = x.shape[-1]
    rot = int(dh * rotary_fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    cos, sin = rotary_angles(positions, rot, theta)     # [..., T, rot/2]
    cos = cos[..., None, :]                              # broadcast over heads
    sin = sin[..., None, :]
    x1 = xr[..., 0::2].to(torch.float32)
    x2 = xr[..., 1::2].to(torch.float32)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([yr, xp], dim=-1) if rot < dh else yr


def silu(x):
    return x * torch.sigmoid(x)


def gelu(x):
    """GELU, tanh approximation (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"silu": silu, "gelu": gelu, "relu": torch.relu}


def causal_mask_bias(q_len: int, kv_len: int, q_offset,
                     device=None) -> torch.Tensor:
    """Additive causal bias [q_len, kv_len]; q position i attends kv <= offset+i."""
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(kv_pos <= q_pos, zero,
                       torch.full((), -1e30, device=device))
