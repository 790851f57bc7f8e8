"""qwen2.5-14b [dense] (hf:Qwen/Qwen2.5-14B).

GQA with QKV bias; the 152k vocabulary makes the embedding/LM-head sharding
the interesting part of this cell.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    activation="silu",
)
