"""Mamba2 SSD inter-chunk state passing: the Hopper kernel's wrapper and its
plain PyTorch version.

The port of :mod:`repro.kernels.ssd_scan`.  The chunked SSD form
(``models/ssm.py``) leaves one sequential recurrence over per-chunk states,
an exclusive scan over chunks::

    out[c]    = S_running            (state BEFORE chunk c)
    S_running = decay[c] * S_running + S[c]

on states ``[B, NC, H, P, N]`` and decays ``[B, NC, H]``, in fp32.
``init_state [B, H, P, N]`` is the optional starting value of
``S_running`` (zero when absent): the same recurrence, started elsewhere.
``head_block`` tiled the heads on the TPU; here it keeps only the
reference's validation (``H % head_block``).  The kernel
(``csrc/ssd_state_passing.cu``) computes each update as a correctly rounded
multiply followed by a correctly rounded add, as the plain version's two
tensor ops do, so on one card the two agree bit for bit.

:func:`ssd_state_passing` sends CPU tensors to the plain version and CUDA
tensors to the kernel, which raises on what it does not take; it never
falls back from one to the other.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build

KERNEL = "ssd_state_passing"


def check_shapes(states: torch.Tensor, decays: torch.Tensor,
                 head_block: int, init_state: Optional[torch.Tensor]) -> None:
    """Raises on what the reference refuses, and on mismatched shapes."""
    if states.ndim != 5:
        raise ValueError(f"states must be [B, NC, H, P, N], got "
                         f"{tuple(states.shape)}")
    B, NC, H, P, N = states.shape
    if tuple(decays.shape) != (B, NC, H):
        raise ValueError(f"decays must be {(B, NC, H)}, got "
                         f"{tuple(decays.shape)}")
    hb = min(head_block, H)
    if H % hb:
        raise ValueError(f"H={H} must divide head_block={hb}")
    if init_state is not None and tuple(init_state.shape) != (B, H, P, N):
        raise ValueError(f"init_state must be {(B, H, P, N)}, got "
                         f"{tuple(init_state.shape)}")


def ssd_state_passing_plain(
    states: torch.Tensor, decays: torch.Tensor, *, head_block: int = 8,
    init_state: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch version: the scan as a loop over chunks, in fp32."""
    check_shapes(states, decays, head_block, init_state)
    B, NC, H, P, N = states.shape
    s = (torch.zeros((B, H, P, N), dtype=torch.float32, device=states.device)
         if init_state is None else init_state.to(torch.float32))
    s_f, d_f = states.to(torch.float32), decays.to(torch.float32)
    outs = []
    for c in range(NC):
        outs.append(s)
        s = d_f[:, c, :, None, None] * s + s_f[:, c]
    return torch.stack(outs, dim=1)


@functools.cache
def _entry():
    fn = build.load(KERNEL).ssd_state_passing_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssd_state_passing_cuda(
    states: torch.Tensor, decays: torch.Tensor, *, head_block: int = 8,
    init_state: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the Hopper kernel on the current stream (no synchronise)."""
    check_shapes(states, decays, head_block, init_state)
    given = [states, decays] + ([init_state] if init_state is not None
                                else [])
    if not all(t.is_cuda and t.device == states.device for t in given):
        raise ValueError("ssd_state_passing_cuda needs all operands on one "
                         "CUDA device, got "
                         f"{[str(t.device) for t in given]}")
    if any(t.dtype != torch.float32 for t in given):
        raise TypeError("ssd_state_passing_cuda takes float32 operands, got "
                        f"{[t.dtype for t in given]}")
    if not all(t.is_contiguous() for t in given):
        raise ValueError("ssd_state_passing_cuda needs contiguous operands")
    B, NC, H, P, N = states.shape
    out = torch.empty_like(states)
    with torch.cuda.device(states.device):
        err = _entry()(states.data_ptr(), decays.data_ptr(),
                       None if init_state is None else init_state.data_ptr(),
                       out.data_ptr(), B, NC, H, P, N,
                       torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_state_passing kernel launch failed: "
                           f"cudaError_t {err}")
    build.count_launch(KERNEL)
    return out


def ssd_state_passing(
    states: torch.Tensor, decays: torch.Tensor, *, head_block: int = 8,
    init_state: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """States before each chunk ``[B, NC, H, P, N]`` (fp32): the plain
    version for CPU tensors, else the kernel."""
    kw = dict(head_block=head_block, init_state=init_state)
    if states.device.type == "cpu":
        return ssd_state_passing_plain(states, decays, **kw)
    return ssd_state_passing_cuda(states, decays, **kw)
