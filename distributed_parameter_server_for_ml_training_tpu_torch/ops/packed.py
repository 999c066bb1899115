"""Packed-nibble int4 tensor type: the wire's ``int4`` dtype carrier.

numpy has no packed 4-bit dtype, so int4 tensors travel as
:class:`PackedInt4` — a uint8 ndarray of packed nibbles (two signed 4-bit
values per byte, low nibble = even flat index) that remembers the LOGICAL
shape of the tensor it encodes. The wire codec (``comms/wire.py``) maps it
to/from the ``int4`` header dtype; the quantization math lives in
``ops/compression.py``.

This module is a dependency LEAF (numpy only): both the wire codec and the
compression layer import it, and neither package's ``__init__`` chain runs
underneath it — which is what keeps ``ops.compression`` ↔ ``comms``
acyclic.
"""

from __future__ import annotations

import math

import numpy as np


class PackedInt4(np.ndarray):
    """uint8 array of packed nibbles + the logical tensor shape it encodes.

    ``logical_shape`` is the shape of the dequantized tensor; the packed
    buffer is ``ceil(prod(shape)/2)`` bytes. Built via
    :func:`as_packed_int4`; survives the wire encode/decode round trip
    (decode re-wraps the zero-copy uint8 view)."""

    logical_shape: tuple = ()

    def __array_finalize__(self, obj):
        if obj is not None:
            self.logical_shape = getattr(obj, "logical_shape", ())


def packed_int4_nbytes(logical_shape) -> int:
    """Packed byte count for a logical element shape (two per byte)."""
    return (math.prod(logical_shape) + 1) // 2


def as_packed_int4(data, logical_shape) -> PackedInt4:
    """Wrap packed nibble bytes as :class:`PackedInt4`. ``data`` must hold
    exactly ``ceil(prod(logical_shape)/2)`` uint8s."""
    arr = np.asarray(data, np.uint8).reshape(-1).view(PackedInt4)
    shape = tuple(int(s) for s in logical_shape)
    if arr.nbytes != packed_int4_nbytes(shape):
        raise ValueError(
            f"packed int4 buffer holds {arr.nbytes} bytes; logical shape "
            f"{shape} needs {packed_int4_nbytes(shape)}")
    arr.logical_shape = shape
    return arr


def pack_nibbles(q: np.ndarray) -> np.ndarray:
    """Pack an int8 array of values in [-8, 7] into uint8 nibble pairs
    (flat, ceil(n/2) bytes; a trailing odd element rides the low nibble of
    the last byte)."""
    flat = np.asarray(q, np.int8).reshape(-1)
    if flat.size % 2:
        flat = np.concatenate([flat, np.zeros(1, np.int8)])
    lo = (flat[0::2].astype(np.uint8)) & 0x0F
    hi = ((flat[1::2].astype(np.uint8)) & 0x0F) << 4
    return (lo | hi).astype(np.uint8)


def unpack_nibbles(packed: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_nibbles`: first ``n`` signed int8 values
    (sign-extended from the 4-bit two's-complement nibbles)."""
    p = np.asarray(packed, np.uint8).reshape(-1)
    out = np.empty(p.size * 2, np.int8)
    out[0::2] = (p & 0x0F).astype(np.int8)
    out[1::2] = ((p >> 4) & 0x0F).astype(np.int8)
    # Sign-extend: nibble values 8..15 are -8..-1.
    out[out > 7] -= 16
    return out[:n]
