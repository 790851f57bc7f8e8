"""Serve step factory (port of the serving part of :mod:`repro.train.step`;
the train step comes with the train slice)."""
from __future__ import annotations

import torch

from ..models.api import decode_fn


def make_serve_step(cfg):
    """One-token greedy decode step: ``(params, caches, tokens, pos) ->
    (next_tokens [B, 1], new_caches, rows)``."""
    def serve_step(params, caches, tokens, pos):
        logits, new_caches, rows = decode_fn(cfg, params, caches, tokens, pos)
        # mask vocab-padding slots (the embed table is padded)
        pad = torch.arange(logits.shape[-1], device=logits.device)
        pad_mask = torch.where(pad >= cfg.vocab_size, -1e30, 0.0)
        next_tok = torch.argmax(logits[:, -1, :] + pad_mask, dim=-1)[:, None]
        return next_tok.to(tokens.dtype), new_caches, rows

    return serve_step
