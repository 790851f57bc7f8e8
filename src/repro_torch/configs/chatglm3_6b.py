"""chatglm3-6b [dense] (arXiv:2406.12793, hf:THUDM/chatglm3-6b).

GLM applies rotary position encoding to half of each head's dims ("RoPE 2d")
— ``rotary_fraction=0.5``.  GQA with 2 KV heads.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_head=128,
    d_ff=13696,
    vocab_size=65024,
    rotary_fraction=0.5,
    activation="silu",
)
