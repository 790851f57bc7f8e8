"""chameleon-34b [vlm]: early-fusion multimodal LM (arXiv:2405.09818).

Text + VQ-quantized image tokens share one 65536-entry vocabulary, so the
backbone is a plain decoder-only transformer; the VQ image tokenizer is the
stubbed modality frontend (``input_specs()`` feeds token ids directly).
Chameleon stabilizes training with QK-norm — enabled here.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
    activation="silu",
)
