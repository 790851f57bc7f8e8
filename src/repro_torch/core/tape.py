"""Shortcut-policy collection: fixed-width per-layer records.

The port of :mod:`repro.core.tape`.  Each layer emits one fixed-width record
row; the stacked ``[L, width]`` rows are rebound into a flat
:class:`ProfileStream` whose label list is the per-layer template unrolled
over layers, so host-side decoding is identical to the inline policy and
each word is written once (O(L) copies instead of the inline O(L²)).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..device import resolve_device
from .stream import Label, ProfileStream


@dataclasses.dataclass(frozen=True)
class TapeSpec:
    """Static description of one layer's record row."""

    labels: Tuple[Label, ...]

    @property
    def width(self) -> int:
        return sum(l.size for l in self.labels)

    def offsets(self) -> Dict[str, Tuple[int, int]]:
        out, cur = {}, 0
        for l in self.labels:
            out[l.name] = (cur, cur + l.size)
            cur += l.size
        return out

    def emit(self, values: Dict[str, torch.Tensor], dtype=torch.float32,
             device=None) -> torch.Tensor:
        """Pack one layer's metric values into a single record row.

        Missing labels are filled with the placeholder value so the row width
        is always static.  The row lives on ``device``, else on the device of
        the first value given.
        """
        if device is None:
            first = next((v for v in values.values()
                          if isinstance(v, torch.Tensor)), None)
            device = resolve_device(None, like=first)
        parts = []
        for l in self.labels:
            if l.name in values:
                v = torch.atleast_1d(
                    torch.as_tensor(values[l.name], device=device)).reshape(-1)
                if v.shape[0] != l.size:
                    raise ValueError(
                        f"tape label {l.name!r} expects {l.size} words, got {v.shape[0]}"
                    )
                parts.append(v.detach().to(dtype))
            else:
                parts.append(torch.full((l.size,), -1.0, dtype=dtype,
                                        device=device))
        if not parts:
            return torch.zeros((0,), dtype=dtype, device=device)
        return torch.cat(parts)


def rows_to_stream(
    spec: TapeSpec, rows: torch.Tensor, layer_prefix: str = "layer"
) -> ProfileStream:
    """Bind stacked rows ``[L, width]`` into a flat ProfileStream."""
    if rows.ndim != 2 or rows.shape[1] != spec.width:
        raise ValueError(f"rows shape {tuple(rows.shape)} != [L, {spec.width}]")
    schema = []
    for i in range(rows.shape[0]):
        for l in spec.labels:
            schema.append(
                Label(name=f"{layer_prefix}{i}/{l.name}", metric=l.metric, size=l.size)
            )
    return ProfileStream(rows.reshape(-1), tuple(schema))


def concat_streams_and_rows(
    head: ProfileStream, spec: TapeSpec, rows: torch.Tensor, tail: ProfileStream
) -> ProfileStream:
    """Final-merge assembly: head (pre-layer) words, the rows, tail words."""
    return ProfileStream.merge(head, rows_to_stream(spec, rows), tail)
