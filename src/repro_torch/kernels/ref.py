"""Plain torch oracles for the ported kernels (port of :mod:`repro.kernels.ref`)."""
from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30


def _causal_mask(t: int, s: int, device) -> torch.Tensor:
    return (torch.arange(s, device=device)[None, :]
            <= torch.arange(t, device=device)[:, None])


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    s = torch.einsum("bhtd,bhsd->bhts", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(q.shape[-1])
    if causal:
        s = torch.where(_causal_mask(s.shape[-2], s.shape[-1], s.device), s,
                        torch.full_like(s, NEG_INF))
    return s


def mha_reference(q, k, v, *, causal: bool = True):
    """[B, H, T, D] x [B, H, S, D] -> [B, H, T, D], plus logit max."""
    s = _scores(q, k, causal)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhts,bhsd->bhtd", w, v.to(torch.float32))
    return out.to(q.dtype), torch.amax(s)


def block_logit_max_reference(q, k, *, causal: bool, q_block: int):
    """Per-(head, q_block) max logit — oracle for the in-band profile."""
    B, H, T, D = q.shape
    s = _scores(q, k, causal)
    return torch.amax(s.reshape(B, H, T // q_block, q_block, -1), dim=(3, 4))


def ssd_state_passing_reference(states, decays):
    """[B, NC, H, P, N], [B, NC, H] -> states BEFORE each chunk."""
    B, NC, H, P, N = states.shape
    carry = torch.zeros((B, H, P, N), dtype=torch.float32,
                        device=states.device)
    outs = []
    for c in range(NC):
        outs.append(carry)
        carry = (decays[:, c].to(torch.float32)[:, :, None, None] * carry
                 + states[:, c].to(torch.float32))
    return torch.stack(outs, dim=1)


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
