"""Layer specs for randomly interconnected neural networks (paper §II.B).

The port of :mod:`repro.rinn.layers`.  Each spec knows its shape semantics,
its functional semantics (parameter init + a torch ``apply``) and its
streaming semantics (beats, pipeline fill, initiation interval, burst).

The public layouts are the JAX package's, so both packages compute the same
function from the same parameters: images are ``(H, W, C)`` (NHWC without
the batch), Dense ``w`` is ``[in, units]``, convolution weights are HWIO.
``apply`` permutes to PyTorch's NCHW/OIHW for ``F.conv2d`` internally.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Shape = Tuple[int, ...]


def beats_for_shape(shape: Shape) -> int:
    """Stream beats occupied by a tensor of ``shape`` (io_stream granularity)."""
    if len(shape) == 3:  # (H, W, C): pixel beats
        return shape[0] * shape[1]
    return 1  # flat vector: single pack


def _uniform(gen: torch.Generator, shape: Shape, scale: float) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32).uniform_(
        -scale, scale, generator=gen)


def _conv_same(x: torch.Tensor, w_hwio: torch.Tensor, groups: int = 1):
    """XLA's ``padding="SAME"`` at stride 1 on one HWC image.

    SAME pads ``k-1`` in total, the smaller half before: asymmetric for an
    even kernel, so the padding is explicit rather than ``padding="same"``.
    """
    kh, kw = w_hwio.shape[0], w_hwio.shape[1]
    top, left = (kh - 1) // 2, (kw - 1) // 2
    xp = F.pad(x.permute(2, 0, 1)[None],
               (left, kw - 1 - left, top, kh - 1 - top))
    y = F.conv2d(xp, w_hwio.permute(3, 2, 0, 1), groups=groups)
    return y[0].permute(1, 2, 0)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Base class: one node of the RINN dataflow graph."""

    name: str

    # ---------------- shape semantics ----------------
    def out_shape(self, in_shapes: Sequence[Shape]) -> Shape:
        raise NotImplementedError

    # ---------------- functional semantics ----------------
    def init(self, gen: torch.Generator, in_shapes: Sequence[Shape]):
        return {}

    def apply(self, params, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    # ---------------- streaming semantics ----------------
    def fill_beats(self, in_shapes: Sequence[Shape], timing) -> int:
        """Beats that must be consumed before the first output beat."""
        return 0

    def ii_cycles(self, in_shapes: Sequence[Shape], timing) -> int:
        """Cycles between consecutive consume firings (initiation interval)."""
        return 1

    def burst(self) -> bool:
        """True if outputs are emitted only after the full input is consumed."""
        return False

    @property
    def profiled(self) -> bool:
        """Whether SPRING taps this node's input FIFO (merge/split must be)."""
        return True


@dataclasses.dataclass(frozen=True)
class InputSpec(LayerSpec):
    shape: Shape = (16,)

    def out_shape(self, in_shapes):
        return self.shape

    def apply(self, params, xs):
        raise RuntimeError("InputSpec has no apply")

    @property
    def profiled(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class DenseSpec(LayerSpec):
    units: int = 16
    activation: Optional[str] = None  # None | "relu" | "sigmoid"

    def out_shape(self, in_shapes):
        (s,) = in_shapes
        if len(s) != 1:
            raise ValueError(f"Dense {self.name} needs flat input, got {s}")
        return (self.units,)

    def init(self, gen, in_shapes):
        (s,) = in_shapes
        return {
            "w": _uniform(gen, (s[0], self.units), 1.0 / math.sqrt(s[0])),
            "b": torch.zeros((self.units,), dtype=torch.float32),
        }

    def apply(self, params, xs):
        (x,) = xs
        y = x @ params["w"] + params["b"]
        if self.activation == "relu":
            y = torch.relu(y)
        elif self.activation == "sigmoid":
            y = torch.sigmoid(y)
        return y

    def ii_cycles(self, in_shapes, timing):
        (s,) = in_shapes
        mults = s[0] * self.units
        # reuse_factor serializes multipliers: cycles per (pack) firing
        return max(1, math.ceil(mults / max(1, mults // timing.reuse_factor)))

    def burst(self) -> bool:
        return True  # emits its single output pack after consuming the input


@dataclasses.dataclass(frozen=True)
class Conv2DSpec(LayerSpec):
    filters: int = 1
    kernel: int = 3  # square kernel, 'same' padding, stride 1 (paper's setup)

    def out_shape(self, in_shapes):
        (s,) = in_shapes
        if len(s) != 3:
            raise ValueError(f"Conv2D {self.name} needs (H,W,C), got {s}")
        return (s[0], s[1], self.filters)

    def init(self, gen, in_shapes):
        (s,) = in_shapes
        fan_in = self.kernel * self.kernel * s[2]
        return {
            "w": _uniform(gen, (self.kernel, self.kernel, s[2], self.filters),
                          1.0 / math.sqrt(fan_in)),
            "b": torch.zeros((self.filters,), dtype=torch.float32),
        }

    def apply(self, params, xs):
        (x,) = xs
        return _conv_same(x, params["w"]) + params["b"]

    def fill_beats(self, in_shapes, timing):
        (s,) = in_shapes
        # line buffer: (k-1) full rows + k pixels before the first window
        return (self.kernel - 1) * s[1] + self.kernel

    def ii_cycles(self, in_shapes, timing):
        (s,) = in_shapes
        mults = self.kernel * self.kernel * s[2] * self.filters
        parallel = max(1, mults // timing.reuse_factor)
        return max(1, math.ceil(mults / parallel))


@dataclasses.dataclass(frozen=True)
class AddSpec(LayerSpec):
    def out_shape(self, in_shapes):
        first = in_shapes[0]
        for s in in_shapes[1:]:
            if s != first:
                raise ValueError(f"Add {self.name}: mismatched shapes {in_shapes}")
        return first

    def apply(self, params, xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out


@dataclasses.dataclass(frozen=True)
class ConcatSpec(LayerSpec):
    """Channel concat for images, feature concat for flat vectors."""

    def out_shape(self, in_shapes):
        first = in_shapes[0]
        if len(first) == 3:
            for s in in_shapes[1:]:
                if s[:2] != first[:2]:
                    raise ValueError(f"Concat {self.name}: spatial mismatch")
            return (first[0], first[1], sum(s[2] for s in in_shapes))
        return (sum(s[0] for s in in_shapes),)

    def apply(self, params, xs):
        return torch.cat(list(xs), dim=-1)


@dataclasses.dataclass(frozen=True)
class ReluSpec(LayerSpec):
    def out_shape(self, in_shapes):
        return in_shapes[0]

    def apply(self, params, xs):
        return torch.relu(xs[0])


@dataclasses.dataclass(frozen=True)
class SigmoidSpec(LayerSpec):
    def out_shape(self, in_shapes):
        return in_shapes[0]

    def apply(self, params, xs):
        return torch.sigmoid(xs[0])

    def ii_cycles(self, in_shapes, timing):
        return timing.sigmoid_ii  # LUT-based sigmoid is slower per beat


@dataclasses.dataclass(frozen=True)
class ReshapeSpec(LayerSpec):
    target: Shape = ()

    def out_shape(self, in_shapes):
        (s,) = in_shapes
        if math.prod(s) != math.prod(self.target):
            raise ValueError(f"Reshape {self.name}: {s} -> {self.target}")
        return self.target

    def apply(self, params, xs):
        return xs[0].reshape(self.target)

    def burst(self) -> bool:
        # pack -> pixel-stream conversion waits for the full pack
        return True

    @property
    def profiled(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class FlattenSpec(LayerSpec):
    def out_shape(self, in_shapes):
        (s,) = in_shapes
        return (math.prod(s),)

    def apply(self, params, xs):
        return xs[0].reshape(-1)

    def burst(self) -> bool:
        return True  # emits the flat pack once the last pixel arrives

    @property
    def profiled(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class CloneSpec(LayerSpec):
    """hls4ml clone function: explicit fan-out of a stream (paper splits here)."""

    n_copies: int = 2

    def out_shape(self, in_shapes):
        return in_shapes[0]

    def apply(self, params, xs):
        return xs[0]  # graph wiring duplicates the edge


@dataclasses.dataclass(frozen=True)
class MaxPool2DSpec(LayerSpec):
    """2x2 max pool, stride 2: a rate-changing actor (1 output beat per
    ``pool*pool`` input beats after a row-plus-``pool`` fill)."""

    pool: int = 2

    def out_shape(self, in_shapes):
        (s,) = in_shapes
        if len(s) != 3 or s[0] % self.pool or s[1] % self.pool:
            raise ValueError(f"MaxPool {self.name}: bad input {s}")
        return (s[0] // self.pool, s[1] // self.pool, s[2])

    def apply(self, params, xs):
        (x,) = xs
        h, w, c = x.shape
        p = self.pool
        return x.reshape(h // p, p, w // p, p, c).amax(dim=(1, 3))

    def fill_beats(self, in_shapes, timing):
        (s,) = in_shapes
        return (self.pool - 1) * s[1] + self.pool


@dataclasses.dataclass(frozen=True)
class AvgPool2DSpec(MaxPool2DSpec):
    def apply(self, params, xs):
        (x,) = xs
        h, w, c = x.shape
        p = self.pool
        return x.reshape(h // p, p, w // p, p, c).mean(dim=(1, 3))


@dataclasses.dataclass(frozen=True)
class DepthwiseConv2DSpec(LayerSpec):
    """Depthwise (per-channel) conv: conv streaming behaviour, ~C x fewer
    multipliers, so the II under a given reuse factor is lower."""

    kernel: int = 3

    def out_shape(self, in_shapes):
        (s,) = in_shapes
        if len(s) != 3:
            raise ValueError(f"DWConv {self.name} needs (H,W,C), got {s}")
        return s

    def init(self, gen, in_shapes):
        (s,) = in_shapes
        return {
            # HWIO with one filter per channel: I=1, O=C
            "w": _uniform(gen, (self.kernel, self.kernel, 1, s[2]),
                          1.0 / math.sqrt(self.kernel * self.kernel)),
            "b": torch.zeros((s[2],), dtype=torch.float32),
        }

    def apply(self, params, xs):
        (x,) = xs
        return _conv_same(x, params["w"], groups=x.shape[-1]) + params["b"]

    def fill_beats(self, in_shapes, timing):
        (s,) = in_shapes
        return (self.kernel - 1) * s[1] + self.kernel

    def ii_cycles(self, in_shapes, timing):
        (s,) = in_shapes
        mults = self.kernel * self.kernel * s[2]   # no cross-channel fan-in
        parallel = max(1, mults // timing.reuse_factor)
        return max(1, math.ceil(mults / parallel))
