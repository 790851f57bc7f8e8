"""qwen3-moe-235b-a22b [moe] (hf:Qwen/Qwen3-235B-A22B).

128 experts, top-8, per-expert d_ff=1536, QK-norm.  The biggest assignment
by total parameters; EP shards experts over the model axis (8 per chip on a
16-way axis).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_head=128,
    d_ff=1536,
    vocab_size=151936,
    n_experts=128,
    top_k=8,
    qk_norm=True,
    activation="silu",
)
