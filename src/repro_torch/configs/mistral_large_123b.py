"""mistral-large-123b [dense] (hf:mistralai/Mistral-Large-Instruct-2407).

The largest dense assignment: 123B parameters — the cell that stresses FSDP
(params + optimizer states fully sharded over pod x data x model).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_head=128,
    d_ff=28672,
    vocab_size=32768,
    activation="silu",
)
