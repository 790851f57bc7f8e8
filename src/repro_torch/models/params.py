"""Parameter specification system (port of :mod:`repro.models.params`).

Every model declares its parameters as a nested dict of :class:`ParamSpec`
leaves.  From one spec tree come the concrete parameters
(:func:`init_params`) and their count and size.  The logical ``axes`` are
kept for the ``distributed/`` slice, which brings ``abstract_params`` and
``shardings_for``; on one card they place nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device

Axes = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    axes: Axes = ()                 # logical axis name per dim (None = replicated)
    init: str = "normal"            # normal | zeros | ones | scaled
    scale: Optional[float] = None   # stddev override

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} rank != shape {self.shape}")

    @property
    def fan_in(self) -> int:
        return self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]


def tree_map(fn: Callable, tree):
    """``fn`` on every leaf of nested dicts (keys in sorted order, as
    ``jax.tree_util`` walks them)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree) -> Iterator[Any]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


def _init_leaf(spec: ParamSpec, gen: torch.Generator,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    std = (spec.scale if spec.scale is not None
           else 1.0 / math.sqrt(max(1, spec.fan_in)))
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (x * std).to(spec.dtype)


def init_params(specs, generator: Union[int, torch.Generator] = 0,
                device=None):
    """Concrete init, one draw per leaf in tree order (the reference's
    distributions: normal with std ``1/sqrt(fan_in)`` unless ``scale``
    overrides it, drawn in fp32 and cast; zeros; ones).

    ``generator`` is a ``torch.Generator`` on ``device`` or an int seed for
    one; the draws happen on ``device`` (the card by default), so the
    numbers depend on the device type, and differ from ``jax.random``'s.
    To hold two devices to one set of parameters, copy them across.
    """
    dev = resolve_device(device)
    gen = (generator if isinstance(generator, torch.Generator)
           else torch.Generator(device=dev).manual_seed(int(generator)))
    return tree_map(lambda s: _init_leaf(s, gen, dev), specs)


def params_from_numpy(tree, device=None):
    """The reference's parameter tree (each leaf a numpy array, same
    nesting) as the port's tensors on ``device``.  bfloat16 leaves cross
    through float32, which holds them exactly."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.tensor(a, device=dev)

    return tree_map(leaf, tree)


def count_params(specs) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))


def param_bytes(specs) -> int:
    return sum(math.prod(s.shape) * torch.empty((), dtype=s.dtype).element_size()
               for s in tree_leaves(specs))
