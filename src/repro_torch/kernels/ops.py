"""Public entry points of the kernel layer (port of :mod:`repro.kernels.ops`).

The reference's signatures minus ``interpret``: PyTorch runs eagerly, and
the device of the tensors decides between the plain version (CPU) and the
Hopper kernel (CUDA).
"""
from __future__ import annotations

from .flash_attention import flash_attention
from .profiled_matmul import profiled_matmul
from .ssd_scan import ssd_state_passing


def flash_attention_op(q, k, v, *, causal=True, q_block=128, kv_block=128,
                       profile=True):
    """``(attention [B, H, T, D], per-(head, q_block) max logit)``; see
    :func:`repro_torch.kernels.flash_attention.flash_attention`."""
    return flash_attention(q, k, v, causal=causal, q_block=q_block,
                           kv_block=kv_block, profile=profile)


def ssd_state_passing_op(states, decays, *, head_block=8, init_state=None):
    """States before each chunk; see
    :func:`repro_torch.kernels.ssd_scan.ssd_state_passing`."""
    return ssd_state_passing(states, decays, head_block=head_block,
                             init_state=init_state)


def profiled_matmul_op(a, b, *, block_m=256, block_n=256, block_k=512,
                       profile=True):
    """``(a @ b, per-(block_m, block_n) tile max |acc|)``; see
    :func:`repro_torch.kernels.profiled_matmul.profiled_matmul`."""
    return profiled_matmul(a, b, block_m=block_m, block_n=block_n,
                           block_k=block_k, profile=profile)
