"""Architecture configs: the ten assigned archs (port of
:mod:`repro.configs`; the config modules are data only)."""
from .base import FAMILIES, ModelConfig, torch_dtype
from .registry import ARCH_IDS, all_configs, get_config

__all__ = ["FAMILIES", "ModelConfig", "torch_dtype", "ARCH_IDS",
           "all_configs", "get_config"]
