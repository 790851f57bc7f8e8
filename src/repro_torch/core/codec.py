"""Profile-word precision control and integrity guard words, in torch.

The port of :mod:`repro.core.codec`: the saturating ``ap_fixed<W,I>`` codec
of the paper's Fig. 4 sweep, and the two guard-word checksums that ride the
profile stream.  The guard words are bit-exact with the reference's.  Their
uint32 arithmetic runs in int64 masked to 32 bits, because torch has no
uint32 shifts and an int32 ``>>`` is arithmetic where the reference's is
logical.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

# dtypes usable directly as the stream/tape buffer element type.
FLOAT_FORMATS = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float8_e4m3": torch.float8_e4m3fn,
}

_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class FixedPointCodec:
    """Saturating signed fixed-point ``ap_fixed<total_bits, int_bits>``.

    ``encode`` quantizes to the grid and saturates; ``decode`` returns the
    dequantized float.  ``total_bits == int_bits`` gives the paper's pure
    integer profile words.  The storage container follows ``total_bits``.
    """

    total_bits: int
    int_bits: Optional[int] = None  # defaults to total_bits (pure integer)

    def __post_init__(self):
        if not (2 <= self.total_bits <= 32):
            raise ValueError("total_bits must be in [2, 32]")
        ib = self.total_bits if self.int_bits is None else self.int_bits
        if ib > self.total_bits:
            raise ValueError("int_bits cannot exceed total_bits")

    @property
    def _int_bits(self) -> int:
        return self.total_bits if self.int_bits is None else self.int_bits

    @property
    def frac_bits(self) -> int:
        return self.total_bits - self._int_bits

    @property
    def scale(self) -> float:
        return float(2 ** self.frac_bits)

    @property
    def max_value(self) -> float:
        return (2 ** (self.total_bits - 1) - 1) / self.scale

    @property
    def min_value(self) -> float:
        return -(2 ** (self.total_bits - 1)) / self.scale

    @property
    def storage_dtype(self) -> torch.dtype:
        if self.total_bits <= 8:
            return torch.int8
        if self.total_bits <= 16:
            return torch.int16
        return torch.int32

    @property
    def storage_bytes_per_word(self) -> int:
        return self.storage_dtype.itemsize

    def encode(self, x) -> torch.Tensor:
        # torch.round rounds half to even, as jnp.round does
        q = torch.round(torch.as_tensor(x, dtype=torch.float32) * self.scale)
        # saturate as XLA's float-to-int cast does (NaN -> 0), clamping in
        # float64: in float32 the 32-bit top 2**31 - 1 rounds up to 2**31,
        # which wraps to the minimum on a plain cast
        q = torch.nan_to_num(q.to(torch.float64), nan=0.0)
        q = torch.clamp(q, -(2 ** (self.total_bits - 1)),
                        2 ** (self.total_bits - 1) - 1)
        return q.to(self.storage_dtype)

    def decode(self, q: torch.Tensor) -> torch.Tensor:
        return q.to(torch.float32) / self.scale

    def roundtrip(self, x) -> torch.Tensor:
        """Quantize-dequantize; saturation makes overflow observable."""
        return self.decode(self.encode(x))

    def overflows(self, x) -> torch.Tensor:
        """True where the value cannot be represented (paper's Fig. 4 cliff)."""
        x = torch.as_tensor(x, dtype=torch.float32)
        return (x > self.max_value) | (x < self.min_value)


# --------------------------------------------------------------------- #
# profile-word integrity checksum
# --------------------------------------------------------------------- #
CHECKSUM_BITS = 24  # integers < 2**24 survive a float32 word exactly


def _f32_bits(values) -> torch.Tensor:
    """The uint32 bit patterns of ``values`` as float32, held in int64."""
    v = torch.atleast_1d(torch.as_tensor(values)).reshape(-1)
    v = v.to(torch.float32).contiguous()
    return v.view(torch.int32).to(torch.int64) & _MASK32


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR of all elements (0 for none), by pairwise halving."""
    while x.numel() > 1:
        if x.numel() % 2:
            x = torch.cat([x, x.new_zeros(1)])
        x = x[0::2] ^ x[1::2]
    return x.reshape(()) if x.numel() else x.new_zeros(())


def word_checksum(values) -> torch.Tensor:
    """XOR-fold checksum of profile words, exact through a float32 stream.

    Folds the float32 bit patterns of ``values``, each mixed with its
    position times ``0x9E3779B1`` (mod 2**32), into one integer below
    ``2**CHECKSUM_BITS``, returned as a float32 scalar: it rides the stream
    as an ordinary profile word with zero quantization loss.
    """
    bits = _f32_bits(values)
    pos = torch.arange(1, bits.shape[0] + 1, dtype=torch.int64,
                       device=bits.device)
    bits = bits ^ ((pos * 0x9E3779B1) & _MASK32)
    folded = _xor_reduce(bits)
    # both operands are non-negative int64, so >> is the logical shift
    folded = (folded ^ (folded >> CHECKSUM_BITS)) & ((1 << CHECKSUM_BITS) - 1)
    return folded.to(torch.float32)


def verify_checksum(values, checksum_word) -> bool:
    """Host-side re-computation; True when the payload is intact."""
    return float(checksum_word) == float(word_checksum(values))


# --------------------------------------------------------------------- #
# CRC-32 guard mode (optional; stronger than the default 24-bit XOR fold)
# --------------------------------------------------------------------- #
_CRC32_POLY = 0xEDB88320  # IEEE 802.3, reflected


@functools.lru_cache(maxsize=None)
def _crc32_table() -> np.ndarray:
    """The 256-entry byte-at-a-time CRC-32 table (built once, host-side)."""
    t = np.arange(256, dtype=np.int64)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ _CRC32_POLY, t >> 1)
    return t


def word_crc32(values) -> torch.Tensor:
    """CRC-32 of the payload's float32 byte stream, as two stream words.

    The standard CRC-32 (``binascii.crc32``) over the little-endian bytes of
    the float32 bit patterns, table-driven one byte at a time.  The digest
    is returned as ``[lo16, hi16]`` float32 words: each half is below
    ``2**16``, so both ride a float32 stream exactly.
    """
    bits = _f32_bits(values)
    stream = torch.stack([(bits >> (8 * k)) & 0xFF for k in range(4)],
                         dim=1).reshape(-1)
    table = torch.from_numpy(_crc32_table()).to(bits.device)
    crc = torch.full((), _MASK32, dtype=torch.int64, device=bits.device)
    for b in stream:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    crc = crc ^ _MASK32
    return torch.stack([crc & 0xFFFF, crc >> 16]).to(torch.float32)


def verify_crc32(values, guard_words) -> bool:
    """Host-side CRC re-computation; True when the payload is intact."""
    expect = word_crc32(values).to(torch.float64).cpu().numpy()
    got = np.asarray(guard_words, dtype=np.float64).reshape(-1)
    return (got.shape[0] == 2 and float(got[0]) == float(expect[0])
            and float(got[1]) == float(expect[1]))
