"""Mamba2 (SSD — state-space duality) block, chunked form (port of
:mod:`repro.models.ssm`).

The SSD computation follows arXiv:2405.21060: within chunks of length Q the
recurrence is evaluated as a (masked, decay-weighted) quadratic
attention-like product; across chunks a small state-passing recurrence
carries [H, P, N] states.  Here that inter-chunk recurrence runs in the
Hopper kernel ``kernels.ssd_state_passing`` (its plain PyTorch version for
CPU tensors), in place of the reference's ``lax.scan``.

The reference pins activations to a sharding at a few waypoints
(``shard_act``); on one card that has no effect, so the port leaves it out
until the ``distributed/`` slice.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..kernels import ssd_state_passing
from .common import rms_norm, silu
from .params import ParamSpec


def ssm_specs(cfg, stacked: int = 0) -> Dict[str, ParamSpec]:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h, k = cfg.ssm_heads, cfg.ssm_conv_dim
    dtype = cfg.dtype()

    def spec(shape, axes, **kw):
        if stacked:
            return ParamSpec((stacked,) + shape, dtype, ("layers",) + axes, **kw)
        return ParamSpec(shape, dtype, axes, **kw)

    return {
        "zx_proj": spec((d, 2 * di), ("embed", "mlp")),
        "bc_proj": spec((d, 2 * n), ("embed", None)),
        "dt_proj": spec((d, h), ("embed", "heads")),
        "conv_x_w": spec((k, di), (None, "mlp")),
        "conv_x_b": spec((di,), ("mlp",), init="zeros"),
        "conv_bc_w": spec((k, 2 * n), (None, None)),
        "conv_bc_b": spec((2 * n,), (None,), init="zeros"),
        "A_log": spec((h,), ("heads",), init="zeros"),
        "D": spec((h,), ("heads",), init="ones"),
        "dt_bias": spec((h,), ("heads",), init="zeros"),
        "norm_w": spec((di,), ("mlp",), init="ones"),
        "out_proj": spec((di, d), ("mlp", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal 1-D conv, kernel k, over [B, T, C]."""
    k = w.shape[0]
    t = x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    out = pad[:, 0:t, :] * w[0][None, None, :]
    for i in range(1, k):
        out = out + pad[:, i:i + t, :] * w[i][None, None, :]
    return out + b[None, None, :]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_chunked(
    x: torch.Tensor,    # [B, T, H, P]
    dt: torch.Tensor,   # [B, T, H]  (post-softplus)
    A: torch.Tensor,    # [H]        (negative)
    Bm: torch.Tensor,   # [B, T, N]
    Cm: torch.Tensor,   # [B, T, N]
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact SSD over chunks; returns (y [B,T,H,P], final_state [B,H,P,N]).

    The states and the inter-chunk pass are fp32; ``y`` comes back in
    fp32 (the model calls it with fp32 inputs).
    """
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, T)
    if T % Q:
        raise ValueError(f"T={T} not divisible by chunk={Q}")
    nc = T // Q

    xc = x.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)

    a = dtc * A[None, None, None, :]                       # [B,nc,Q,H] (<= 0)
    cum = torch.cumsum(a, dim=2)                           # within-chunk cumsum

    # ---- intra-chunk (masked decay attention) ----
    # L[i,j] = exp(cum[i] - cum[j]) for i >= j.  The [B,nc,Q,Q,H] tensors
    # (268 MB each at the full-width prefill) are freed as soon as used.
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # [B,nc,Qi,Qj,H]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.where(mask[None, None, :, :, None], torch.exp(seg),
                    torch.zeros((), dtype=seg.dtype, device=x.device))
    del seg
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)           # [B,nc,Qi,Qj]
    w = cb[..., None] * L * dtc[:, :, None, :, :]          # [B,nc,Qi,Qj,H]
    del L
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", w, xc)
    del w

    # ---- chunk states ----
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)      # [B,nc,Q,H]
    wstate = decay_to_end * dtc                            # [B,nc,Q,H]
    S = torch.einsum("bcqhp,bcqn->bchpn", wstate[..., None] * xc, Bc)

    # ---- inter-chunk state passing: the kernel ----
    chunk_decay = torch.exp(cum[:, :, -1, :])              # [B,nc,H]
    S = S.to(torch.float32).contiguous()
    chunk_decay = chunk_decay.to(torch.float32).contiguous()
    s0 = (None if init_state is None
          else init_state.to(torch.float32).contiguous())
    states_before = ssd_state_passing(S, chunk_decay, head_block=H,
                                      init_state=s0)      # [B,nc,H,P,N]
    # the scan's own last step
    final_state = (chunk_decay[:, -1, :, None, None] * states_before[:, -1]
                   + S[:, -1])

    # ---- inter-chunk contribution ----
    decay_in = torch.exp(cum)                              # [B,nc,Q,H]
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cc.to(torch.float32),
                         states_before) * decay_in[..., None]

    y = (y_diag + y_off).reshape(Bsz, T, H, P)
    return y, final_state


class SsmCache(NamedTuple):
    conv_x: torch.Tensor   # [B, k-1, di]
    conv_bc: torch.Tensor  # [B, k-1, 2n]
    state: torch.Tensor    # [B, H, P, N]


def ssm_cache_init(cfg, batch: int, dtype, device=None) -> SsmCache:
    k = cfg.ssm_conv_dim
    kw = dict(dtype=dtype, device=device)
    return SsmCache(
        conv_x=torch.zeros((batch, k - 1, cfg.d_inner), **kw),
        conv_bc=torch.zeros((batch, k - 1, 2 * cfg.ssm_state), **kw),
        state=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state), **kw),
    )


def _split_heads(x, h, p):
    return x.reshape(x.shape[:-1] + (h, p))


def ssm_block_apply(
    cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training/prefill path: full-sequence SSD. x: [B, T, d]."""
    di, n, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zx = x @ p["zx_proj"]
    z, xin = zx[..., :di], zx[..., di:]
    bc = x @ p["bc_proj"]
    dt_raw = x @ p["dt_proj"]

    xin = silu(_causal_conv(xin, p["conv_x_w"], p["conv_x_b"]))
    bc = silu(_causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"]))
    Bm, Cm = bc[..., :n], bc[..., n:]

    f32 = torch.float32
    dt = _softplus(dt_raw.to(f32) + p["dt_bias"].to(f32))
    A = -torch.exp(p["A_log"].to(f32))

    xh = _split_heads(xin, H, P)
    y, final_state = ssd_chunked(xh.to(f32), dt, A, Bm.to(f32), Cm.to(f32),
                                 cfg.ssm_chunk)
    y = y + xh.to(f32) * p["D"].to(f32)[None, None, :, None]
    y = y.reshape(x.shape[0], x.shape[1], di).to(x.dtype)

    y = rms_norm(y * silu(z), p["norm_w"], cfg.norm_eps)
    out = y @ p["out_proj"]
    profile = {"state_rms": torch.sqrt(torch.mean(torch.square(
        final_state.to(f32))) + 1e-30)[None]}
    return out, profile


def ssm_block_decode(
    cfg, p: Dict[str, torch.Tensor], x: torch.Tensor, cache: SsmCache,
) -> Tuple[torch.Tensor, SsmCache, Dict[str, torch.Tensor]]:
    """Single-token recurrent step. x: [B, 1, d]."""
    di, n, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    B = x.shape[0]
    f32 = torch.float32
    zx = x @ p["zx_proj"]
    z, xin = zx[..., :di], zx[..., di:]
    bc = x @ p["bc_proj"]
    dt_raw = x @ p["dt_proj"]

    # rolling conv windows
    win_x = torch.cat([cache.conv_x, xin], dim=1)            # [B, k, di]
    win_bc = torch.cat([cache.conv_bc, bc], dim=1)
    xin = silu(torch.einsum("bkc,kc->bc", win_x, p["conv_x_w"])
               + p["conv_x_b"])[:, None, :]
    bc_c = silu(torch.einsum("bkc,kc->bc", win_bc, p["conv_bc_w"])
                + p["conv_bc_b"])[:, None, :]
    Bm, Cm = bc_c[..., :n], bc_c[..., n:]

    dt = _softplus(dt_raw.to(f32) + p["dt_bias"].to(f32))[:, 0]    # [B, H]
    A = -torch.exp(p["A_log"].to(f32))
    xh = _split_heads(xin[:, 0], H, P).to(f32)                     # [B, H, P]

    decay = torch.exp(dt * A[None, :])                             # [B, H]
    upd = torch.einsum("bh,bn,bhp->bhpn", dt, Bm[:, 0].to(f32), xh)
    state = decay[:, :, None, None] * cache.state.to(f32) + upd
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].to(f32), state)
    y = y + xh * p["D"].to(f32)[None, :, None]
    y = y.reshape(B, 1, di).to(x.dtype)

    y = rms_norm(y * silu(z), p["norm_w"], cfg.norm_eps)
    out = y @ p["out_proj"]
    new_cache = SsmCache(
        conv_x=win_x[:, 1:, :], conv_bc=win_bc[:, 1:, :],
        state=state.to(cache.state.dtype))
    profile = {"state_rms": torch.sqrt(torch.mean(torch.square(state))
                                       + 1e-30)[None]}
    return out, new_cache, profile


def ssd_reference(x, dt, A, Bm, Cm, init_state=None):
    """Sequential O(T) recurrence — oracle for the chunked/kernel versions."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    s = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.to(torch.float32))
    ys = []
    for t in range(T):
        decay = torch.exp(dt[:, t] * A[None, :])                   # [B,H]
        s = decay[:, :, None, None] * s + torch.einsum(
            "bh,bn,bhp->bhpn", dt[:, t], Bm[:, t], x[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], s))
    return torch.stack(ys, dim=1), s
