"""granite-34b [dense] code model (arXiv:2405.04324).

Llama-style backbone with multi-query attention (a single KV head): the KV
projection is replicated across the tensor-parallel axis (the sharding rules
engine falls back automatically when kv_heads < model-axis size).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_head=128,
    d_ff=24576,
    vocab_size=49152,
    activation="gelu",
    mlp_gated=False,   # GPT-BigCode 2-matrix MLP (4*d expansion) -> 34B total
)
