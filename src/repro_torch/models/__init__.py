"""Model zoo (port of :mod:`repro.models`).  Ported so far: the hybrid
family (zamba2) and what it is built from: ``common``, ``mlp``,
``attention``, ``ssm``, the shared parts of ``transformer``, ``params``
and the hybrid branches of ``api``."""
from . import api, attention, common, hybrid, mlp, params, ssm, transformer
from .params import (
    ParamSpec, count_params, init_params, param_bytes, params_from_numpy,
)

__all__ = [
    "api", "attention", "common", "hybrid", "mlp", "params", "ssm",
    "transformer",
    "ParamSpec", "count_params", "init_params", "param_bytes",
    "params_from_numpy",
]
