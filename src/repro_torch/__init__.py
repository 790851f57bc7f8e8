"""SPRING on PyTorch and CUDA: the port of :mod:`repro` to an NVIDIA H100.

The subpackages mirror the JAX package's layout (``rinn/``, ``core/``,
``kernels/``) in PyTorch's idiom: plain functions on tensors, an explicit
``device``, and ``torch.Generator`` for randomness.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"`` or CPU tensors; with no
card and no device they raise ``RuntimeError`` (see :mod:`.device`).

This package imports ``torch`` and ``numpy`` only, never ``jax`` and
nothing of ``repro``: the JAX package is the reference the tests hold it
against.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
