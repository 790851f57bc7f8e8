"""Architecture configuration schema (port of :mod:`repro.configs.base`).

One frozen dataclass covers all ten assigned families; family-specific
fields default to inert values.  ``reduced()`` derives the smoke-test
configuration (same family, tiny dims).  Dtypes are kept as names
(``"bfloat16"``, ``"float32"``), as in the reference, and map to torch
dtypes through :func:`torch_dtype`.  The reference's analytic parameter
count and shape cells wait for the slices that use them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (and so on for any torch dtype)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None            # defaults to d_model // n_heads

    # --- attention flavor ---
    rope_theta: float = 1e4
    rotary_fraction: float = 1.0            # chatglm "RoPE 2d" uses 0.5
    qkv_bias: bool = False                  # qwen2.5
    qk_norm: bool = False                   # chameleon / qwen3
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_dim: int = 4
    ssm_chunk: int = 128

    # --- hybrid (zamba2): shared attention block every k mamba layers ---
    shared_attn_every: int = 0

    # --- encoder-decoder (whisper) ---
    n_encoder_layers: int = 0
    encoder_seq: int = 1500                 # whisper frame count after conv stub

    # --- activations / norms ---
    activation: str = "silu"
    mlp_gated: bool = True                  # False = 2-matrix MLP (GPT-BigCode)
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    norm_eps: float = 1e-6

    # --- numerics ---
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"

    # --- SPRING profiling (first-class feature) ---
    profile_policy: str = "shortcut"        # off | inline | shortcut
    profile_dtype: str = "float32"

    # --- execution knobs (hillclimb levers) ---
    attn_impl: str = "flash_tri"            # flash_tri | flash_scan | naive
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    remat: bool = True
    remat_policy: str = "nothing"           # nothing | dots | full
    scan_layers: bool = True
    loss_chunk: int = 512                   # CE loss seq chunking

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"family must be one of {FAMILIES}")
        if self.family in ("moe",) and (self.n_experts <= 0 or self.top_k <= 0):
            raise ValueError("moe family needs n_experts and top_k")

    # ------------------------------------------------------------------ #
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so the vocab axis shards cleanly
        (Megatron-style padding; padded logits are masked in the loss)."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def dtype(self) -> torch.dtype:
        """The parameters' torch dtype."""
        return torch_dtype(self.param_dtype)

    def act_dtype(self) -> torch.dtype:
        """The activations' (and caches') torch dtype."""
        return torch_dtype(self.activation_dtype)

    # ------------------------------------------------------------------ #
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_head=16,
            d_ff=128,
            vocab_size=256,
            encoder_seq=16,
            attn_q_chunk=8,
            attn_kv_chunk=8,
            loss_chunk=8,
            ssm_head_dim=16,
            ssm_state=16 if self.ssm_state else 0,
            ssm_chunk=8,
            scan_layers=self.scan_layers,
        )
        if self.n_experts:
            small.update(n_experts=4, top_k=2)
        if self.n_encoder_layers:
            small.update(n_encoder_layers=2)
        if self.shared_attn_every:
            small.update(shared_attn_every=2)
        return dataclasses.replace(self, **small)
