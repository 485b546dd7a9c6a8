"""Validity bit-mask helpers: 1 bit per pixel, MSB-first within each byte.

The port's own copy of ``lerc_tpu/codec/bitmask.py`` (``mask_size_bytes``
:11, ``bool_to_bits`` :15, ``bits_to_bool`` :31). The bit layout is the reference's
(BitMask.h:67, ``bit(k) = 0x80 >> (k & 7)``), numpy's "big" bitorder.
"""
from __future__ import annotations

import numpy as np


def mask_size_bytes(n_cols: int, n_rows: int) -> int:
    return (n_cols * n_rows + 7) >> 3


def bool_to_bits(mask: np.ndarray) -> np.ndarray:
    """[nRows, nCols] or flat bool array -> packed uint8 bit array (MSB-first).

    Trailing pad bits in the last byte are set to 1, as the reference
    encoder's SetAllValid-then-clear construction leaves them
    (BitMask.cpp:54-62), so the RLE'd mask section is byte-identical.
    """
    flat = mask.ravel().astype(bool)
    bits = np.packbits(flat)
    pad = (-flat.size) % 8
    if pad:
        bits = bits.copy()
        bits[-1] |= (1 << pad) - 1
    return bits


def bits_to_bool(bits: np.ndarray | bytes, n_cols: int, n_rows: int) -> np.ndarray:
    """Packed uint8 bit array -> [nRows, nCols] bool array."""
    arr = np.frombuffer(memoryview(bits), dtype=np.uint8) if not isinstance(bits, np.ndarray) else bits
    flat = np.unpackbits(arr, count=n_cols * n_rows).astype(bool)
    return flat.reshape(n_rows, n_cols)
