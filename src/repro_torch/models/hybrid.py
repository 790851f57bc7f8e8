"""Zamba2-style hybrid: Mamba2 backbone + one *shared* attention block
(port of :mod:`repro.models.hybrid`).

The backbone is a loop over mamba blocks; every ``shared_attn_every``
layers the single shared (attention + MLP) parameter set is applied
(Zamba2's weight-shared global block, arXiv:2411.15242, minus the
per-invocation LoRA).  The reference's ``lax.cond`` on the layer index is
a Python ``if`` here.

Decode runs the shared attention against a sliding-window KV ring.  As in
the reference, decode applies the shared sites after the whole Mamba stack
while prefill interleaves them, so hybrid decode logits are not the
prefill's; the port reproduces this.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from .attention import attention, decode_attention
from .common import apply_rotary, rms_norm
from .mlp import mlp_apply, mlp_specs
from .params import ParamSpec
from .ssm import (
    SsmCache, ssm_block_apply, ssm_block_decode, ssm_cache_init, ssm_specs,
)
from .transformer import (
    _attn_project, _remat, attn_specs, chunked_ce_loss, lm_logits,
    tape_spec_for,
)
from ..configs import torch_dtype

SHARED_WINDOW = 4096  # sliding-window KV for the shared attention block
NO_LOGIT = -1e30      # the logit-max word of a layer without attention


def hybrid_specs(cfg) -> Dict[str, Any]:
    dtype = cfg.dtype()
    L = cfg.n_layers

    def nspec(shape, stacked=0, **kw):
        if stacked:
            return ParamSpec((stacked,) + shape, dtype,
                             ("layers",) + ("embed_act",) * len(shape),
                             init="ones", **kw)
        return ParamSpec(shape, dtype, ("embed_act",) * len(shape),
                         init="ones", **kw)

    return {
        "embed": ParamSpec((cfg.padded_vocab, cfg.d_model), dtype,
                           ("vocab", "embed"), scale=1.0),
        "final_norm": nspec((cfg.d_model,)),
        "lm_head": ParamSpec((cfg.d_model, cfg.padded_vocab), dtype,
                             ("embed", "vocab")),
        "blocks": {
            "norm1": nspec((cfg.d_model,), stacked=L),
            "ssm": ssm_specs(cfg, stacked=L),
        },
        "shared": {
            "norm_attn": nspec((cfg.d_model,)),
            "norm_mlp": nspec((cfg.d_model,)),
            "attn": attn_specs(cfg),
            "mlp": mlp_specs(cfg.d_model, cfg.d_ff, dtype, gated=cfg.mlp_gated),
        },
    }


def layer_params(blocks, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    if isinstance(blocks, dict):
        return {k: layer_params(v, i) for k, v in blocks.items()}
    return blocks[i]


def _shared_block_train(cfg, shared, x, positions):
    q, k, v = _attn_project(cfg, shared["attn"],
                            rms_norm(x, shared["norm_attn"], cfg.norm_eps))
    q = apply_rotary(q, positions, cfg.rope_theta, cfg.rotary_fraction)
    k = apply_rotary(k, positions, cfg.rope_theta, cfg.rotary_fraction)
    out, lmax = attention(q, k, v, impl=cfg.attn_impl, causal=True,
                          q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)
    B, T = x.shape[:2]
    x = x + out.reshape(B, T, -1) @ shared["attn"]["wo"]
    h = mlp_apply(shared["mlp"], rms_norm(x, shared["norm_mlp"], cfg.norm_eps),
                  cfg.activation)
    return x + h, lmax


def hybrid_hidden(cfg, params, tokens, positions):
    """Returns (h, rows, aux)."""
    spec = tape_spec_for(cfg)
    pdtype = torch_dtype(cfg.profile_dtype)
    x = params["embed"][tokens].to(cfg.act_dtype())
    shared = params["shared"]
    every = max(1, cfg.shared_attn_every)

    def body(xc, p_l, idx):
        h, prof = ssm_block_apply(cfg, p_l["ssm"],
                                  rms_norm(xc, p_l["norm1"], cfg.norm_eps))
        xc = xc + h
        if idx % every == every - 1:
            xc, lmax = _shared_block_train(cfg, shared, xc, positions)
        else:
            lmax = torch.full((), NO_LOGIT, dtype=torch.float32,
                              device=xc.device)
        xf = xc.to(torch.float32)
        tape = {
            "state_rms": prof["state_rms"],
            "attn_logit_max": lmax.to(torch.float32)[None],
            "act_rms": torch.sqrt(torch.mean(torch.square(xf)) + 1e-30)[None],
            "act_absmax": torch.amax(torch.abs(xf))[None],
        }
        row = (spec.emit(tape, pdtype, device=xc.device)
               if cfg.profile_policy == "shortcut"
               else torch.zeros((0,), dtype=pdtype, device=xc.device))
        return xc, row

    body = _remat(body, cfg)
    rows = []
    for idx in range(cfg.n_layers):
        x, row = body(x, layer_params(params["blocks"], idx), idx)
        rows.append(row)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.stack(rows), torch.zeros((), dtype=torch.float32,
                                             device=x.device)


def hybrid_loss(cfg, params, tokens, labels):
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    h, rows, aux = hybrid_hidden(cfg, params, tokens, positions)
    loss = chunked_ce_loss(cfg, params, h, labels)
    return loss + aux, (loss, rows)


class HybridCaches(NamedTuple):
    ssm: SsmCache             # each field stacked over layers [L, ...]
    shared_k: torch.Tensor    # [n_shared_sites, B, W, KV, dh]
    shared_v: torch.Tensor
    window_pos: int           # next slot in the ring window


def hybrid_caches_init(cfg, batch: int, window: int = SHARED_WINDOW,
                       device=None) -> HybridCaches:
    dt = cfg.act_dtype()
    one = ssm_cache_init(cfg, batch, dt, device=device)
    ssm = SsmCache(*(a[None].expand((cfg.n_layers,) + a.shape).contiguous()
                     for a in one))
    every = max(1, cfg.shared_attn_every)
    n_sites = cfg.n_layers // every
    shape = (n_sites, batch, window, cfg.n_kv_heads, cfg.head_dim)
    return HybridCaches(ssm, torch.zeros(shape, dtype=dt, device=device),
                        torch.zeros(shape, dtype=dt, device=device), 0)


def _shared_block_decode(cfg, shared, x, k_cache, v_cache, slot, n_valid):
    """Sliding-window decode for the shared block (ring buffer)."""
    B = x.shape[0]
    positions = torch.full((B, 1), n_valid, dtype=torch.int64,
                           device=x.device)
    q, k, v = _attn_project(cfg, shared["attn"],
                            rms_norm(x, shared["norm_attn"], cfg.norm_eps))
    q = apply_rotary(q, positions, cfg.rope_theta, cfg.rotary_fraction)
    k = apply_rotary(k, positions, cfg.rope_theta, cfg.rotary_fraction)
    k_cache = k_cache.clone()
    v_cache = v_cache.clone()
    k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
    window = k_cache.shape[1]
    out, lmax = decode_attention(q, k_cache, v_cache,
                                 min(n_valid + 1, window))
    x = x + out.reshape(B, 1, -1) @ shared["attn"]["wo"]
    h = mlp_apply(shared["mlp"], rms_norm(x, shared["norm_mlp"], cfg.norm_eps),
                  cfg.activation)
    return x + h, lmax, k_cache, v_cache


def hybrid_decode_step(cfg, params, caches: HybridCaches, tokens, pos: int):
    """One-token decode.  SSM state is O(1); shared attn uses the ring
    window.  Returns (logits [B, 1, V], new caches, rows)."""
    x = params["embed"][tokens].to(cfg.act_dtype())
    shared = params["shared"]
    window = caches.shared_k.shape[2]
    slot = caches.window_pos % window

    new_ssm, state_rms = [], []
    for idx in range(cfg.n_layers):
        p_l = layer_params(params["blocks"], idx)
        h, cache_l, prof = ssm_block_decode(
            cfg, p_l["ssm"], rms_norm(x, p_l["norm1"], cfg.norm_eps),
            SsmCache(*(a[idx] for a in caches.ssm)))
        x = x + h
        new_ssm.append(cache_l)
        state_rms.append(prof["state_rms"])

    # shared attention sites run after the Mamba stack, one per site, over
    # the window
    n_sites = caches.shared_k.shape[0]
    ks, vs, lmaxes = [], [], []
    for s in range(n_sites):
        x, lmax, k_c, v_c = _shared_block_decode(
            cfg, shared, x, caches.shared_k[s], caches.shared_v[s],
            slot, min(pos, window - 1))
        ks.append(k_c)
        vs.append(v_c)
        lmaxes.append(lmax)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(cfg, params, x)
    ssm = SsmCache(*(torch.stack(f) for f in zip(*new_ssm)))
    new_caches = HybridCaches(ssm, torch.stack(ks), torch.stack(vs),
                              caches.window_pos + 1)
    rows = torch.cat([torch.stack(state_rms).reshape(-1),
                      torch.stack(lmaxes).reshape(-1)]).to(torch.float32)
    return logits, new_caches, rows
