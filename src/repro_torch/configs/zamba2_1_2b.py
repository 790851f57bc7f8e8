"""zamba2-1.2b [hybrid] (arXiv:2411.15242).

Mamba2 backbone with ONE weight-shared attention+MLP block applied every 6
layers (LoRA-free variant).  ``long_500k`` decode keeps the shared block
sub-quadratic with a sliding-window KV ring (DESIGN.md §8).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_head=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    shared_attn_every=6,
    activation="gelu",
)
