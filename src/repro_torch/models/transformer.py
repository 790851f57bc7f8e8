"""Decoder-only LM pieces that the hybrid family shares (port of the parts
of :mod:`repro.models.transformer` that ``models/hybrid.py`` imports).

Ported so far: the attention parameter specs and projection, the profile
tape's label schema, the LM head and the chunked cross-entropy (forward).
``_remat`` is the identity: the port runs forward only until the train
slice.  The ``lm_*`` paths and the dense / MoE / SSM blocks come with the
MoE slice.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..core import Label, TapeSpec
from .common import rms_norm
from .params import ParamSpec


def attn_specs(cfg, stacked: int = 0) -> Dict[str, ParamSpec]:
    d, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dtype = cfg.dtype()

    def spec(shape, axes, **kw):
        if stacked:
            return ParamSpec((stacked,) + shape, dtype, ("layers",) + axes, **kw)
        return ParamSpec(shape, dtype, axes, **kw)

    out = {
        "wq": spec((d, H * dh), ("embed", "heads")),
        "wk": spec((d, KV * dh), ("embed", "kv_heads")),
        "wv": spec((d, KV * dh), ("embed", "kv_heads")),
        "wo": spec((H * dh, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        out["bq"] = spec((H * dh,), ("heads",), init="zeros")
        out["bk"] = spec((KV * dh,), ("kv_heads",), init="zeros")
        out["bv"] = spec((KV * dh,), ("kv_heads",), init="zeros")
    if cfg.qk_norm:
        out["q_norm"] = spec((dh,), (None,), init="ones")
        out["k_norm"] = spec((dh,), (None,), init="ones")
    return out


def tape_spec_for(cfg) -> TapeSpec:
    labels = [Label("act_rms", "act_rms", 1), Label("act_absmax", "act_absmax", 1)]
    if cfg.family == "ssm":
        labels.append(Label("state_rms", "state_rms", 1))
    else:
        labels.append(Label("attn_logit_max", "logit_max", 1))
    if cfg.family == "moe":
        labels += [
            Label("expert_fullness", "fifo_fullness", cfg.n_experts),
            Label("expert_overflow", "fifo_overflow", cfg.n_experts),
            Label("capacity", "capacity", 1),
        ]
    if cfg.family == "hybrid":
        labels.append(Label("state_rms", "state_rms", 1))
    return TapeSpec(labels=tuple(labels))


def _attn_project(cfg, p, x):
    B, T, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, T, H, dh)
    k = k.reshape(B, T, KV, dh)
    v = v.reshape(B, T, KV, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _remat(fn, cfg):
    """Rematerialisation is a training memory policy; forward only, the
    port runs ``fn`` as it is."""
    return fn


def lm_logits(cfg, params, h):
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return h @ head


def chunked_ce_loss(cfg, params, h, labels):
    """Cross-entropy with the vocab projection chunked over sequence."""
    B, S, d = h.shape
    chunk = min(cfg.loss_chunk, S)
    if S % chunk:
        chunk = S
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    pad_mask = (torch.arange(cfg.padded_vocab, device=h.device)
                >= cfg.vocab_size) * -1e30
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(S // chunk):
        hc = h[:, i * chunk:(i + 1) * chunk]
        lc = labels[:, i * chunk:(i + 1) * chunk]
        logits = (hc @ head).to(torch.float32) + pad_mask
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            lc.clamp(min=0)[..., None].long())[..., 0]
        mask = (lc >= 0).to(torch.float32)
        total = total + torch.sum((logz - gold) * mask)
        cnt = cnt + torch.sum(mask)
    return total / torch.clamp(cnt, min=1.0)
