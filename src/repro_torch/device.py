"""Device selection shared by every entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None,
                   like: Optional[torch.Tensor] = None) -> torch.device:
    """The device an entry point runs on.

    An explicit ``device`` wins; otherwise a tensor argument ``like`` decides;
    otherwise the card.  With no card and nothing given this raises: the
    port never falls back to the CPU on its own.
    """
    if device is not None:
        return torch.device(device)
    if like is not None:
        return like.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or CPU tensors) "
            "to run on the CPU")
    return torch.device("cuda")
