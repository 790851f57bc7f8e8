"""whisper-base [audio] (arXiv:2212.04356).

Encoder-decoder backbone only: the two-conv audio stem is a stub — the data
pipeline / input_specs provide precomputed frame embeddings [B, 1500, 512].
Decode cells exercise the decoder step (self-KV + cross-KV).  Backbone
deviations from upstream Whisper (RMSNorm for LayerNorm, RoPE for learned
positions on the decoder) are noted in DESIGN.md — the assignment specifies
backbone shape, not weights parity.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    n_encoder_layers=6,
    encoder_seq=1500,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_head=64,
    d_ff=2048,
    vocab_size=51865,
    activation="gelu",
)
