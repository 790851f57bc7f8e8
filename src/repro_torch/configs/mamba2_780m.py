"""mamba2-780m [ssm] (arXiv:2405.21060).

Attention-free SSD backbone: d_inner = 2*1536 = 3072, head_dim 64 -> 48 SSD
heads, state 128.  ``long_500k`` runs here (O(1) decode state).  The paper's
attention-logit profile tap is inapplicable; the in-band stream carries SSD
state norms instead (DESIGN.md §8).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=24,        # unused (attention-free); kept for schema uniformity
    n_kv_heads=24,
    d_head=64,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    tie_embeddings=True,
)
