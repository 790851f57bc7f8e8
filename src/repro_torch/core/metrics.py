"""Metric taps appended to the in-band stream (port of :mod:`repro.core.metrics`).

The paper's metric is FIFO fullness sampled at read time (Listing 1).  The
generic signal-monitoring taps (activation RMS / absmax, attention logit
max) stand in for the paper's "over 200 internal signals".  Every tap is a
cheap reduction returning a small 1-D tensor ready to ``append``.
"""
from __future__ import annotations

from typing import Tuple

import torch


def act_rms(x: torch.Tensor) -> torch.Tensor:
    """Root-mean-square of an activation tensor (1 word)."""
    return torch.sqrt(torch.mean(torch.square(x.to(torch.float32))) + 1e-30)[None]


def act_absmax(x: torch.Tensor) -> torch.Tensor:
    """Max |activation| (1 word) — numerical-health signal."""
    return torch.amax(torch.abs(x.to(torch.float32)))[None]


def logit_max(scores: torch.Tensor) -> torch.Tensor:
    """Max attention logit (1 word) — overflow sentinel for softmax."""
    return torch.amax(scores.to(torch.float32))[None]


def expert_fullness(
    expert_counts: torch.Tensor, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE expert-buffer fullness — the FIFO-fullness metric at scale.

    Returns ``fullness`` (occupancy saturated at ``capacity``) and
    ``overflow`` (tokens that found the buffer full), both ``[E]`` float32.
    """
    counts = expert_counts.to(torch.float32)
    fullness = torch.clamp(counts, max=float(capacity))
    overflow = torch.clamp(counts - float(capacity), min=0.0)
    return fullness, overflow


def kv_occupancy(used_positions: torch.Tensor, cache_len: int) -> torch.Tensor:
    """KV-cache fullness in positions (1 word per sequence or scalar)."""
    used = torch.amax(used_positions.to(torch.float32))
    return torch.stack([used, used.new_tensor(float(cache_len))])


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def grad_global_norm(grads) -> torch.Tensor:
    """Global L2 norm of nested dicts/lists of gradient tensors (1 word)."""
    sq = sum(torch.sum(torch.square(l.to(torch.float32)))
             for l in _leaves(grads))
    return torch.sqrt(sq + 1e-30)[None]


def running_max(prev: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """The paper's ``if (max_depth < ffsize) max_depth = ffsize`` register."""
    return torch.maximum(prev, new)
