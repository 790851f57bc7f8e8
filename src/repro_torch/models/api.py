"""Family-dispatch API (port of :mod:`repro.models.api`): one surface over
the architectures, the family switch in one place.

Ported so far: the hybrid family (zamba2).  The other families raise
``NotImplementedError`` naming the slice of the port that brings them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..device import resolve_device
from . import hybrid, transformer

_LATER = {
    "dense": "the MoE slice (with the lm_* paths of models/transformer.py)",
    "moe": "the MoE slice",
    "ssm": "the MoE slice (with the lm_* paths of models/transformer.py)",
    "vlm": "the MoE slice (with the lm_* paths of models/transformer.py)",
    "audio": "a later slice (the encoder-decoder family)",
}


def _hybrid_only(cfg) -> None:
    if cfg.family != "hybrid":
        fam = "audio" if cfg.is_encdec else cfg.family
        raise NotImplementedError(
            f"the {fam} family ({cfg.name}) is not ported to repro_torch yet; "
            f"it comes with {_LATER.get(fam, 'a later slice')}")


def model_specs(cfg):
    _hybrid_only(cfg)
    return hybrid.hybrid_specs(cfg)


def loss_fn(cfg, params, batch: Dict[str, torch.Tensor]):
    """Returns (total_loss, (ce_loss, profile_rows)); forward only."""
    _hybrid_only(cfg)
    return hybrid.hybrid_loss(cfg, params, batch["tokens"], batch["labels"])


def init_caches(cfg, batch: int, max_len: int, device=None):
    _hybrid_only(cfg)
    return hybrid.hybrid_caches_init(
        cfg, batch, window=min(max_len, hybrid.SHARED_WINDOW),
        device=resolve_device(device))


def decode_fn(cfg, params, caches, tokens, pos):
    """One-token serve step: returns (logits, new_caches, profile_rows)."""
    _hybrid_only(cfg)
    return hybrid.hybrid_decode_step(cfg, params, caches, tokens, pos)


def prefill_fn(cfg, params, batch):
    """The hybrid returns its last hidden state ``h[:, -1:, :]`` (not
    logits) and no caches, as the reference does."""
    _hybrid_only(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    h, _, _ = hybrid.hybrid_hidden(cfg, params, tokens, positions)
    return h[:, -1:, :], None


def tape_spec(cfg):
    _hybrid_only(cfg)
    return transformer.tape_spec_for(cfg)


def make_batch(cfg, batch_size: int, seq_len: int,
               generator: Optional[torch.Generator] = None,
               device=None) -> Dict[str, torch.Tensor]:
    """Concrete random batch in the family's input format (smoke tests);
    token ids drawn from ``generator`` (seed 0 on ``device`` if absent)."""
    _hybrid_only(cfg)
    dev = resolve_device(device)
    gen = (generator if generator is not None
           else torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (batch_size, seq_len),
                         generator=gen, device=dev)
    return {"tokens": toks, "labels": toks}
