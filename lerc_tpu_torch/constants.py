"""Constants of the LERC wire format used by the resident codec.

The port's own copy of the subset of ``lerc_tpu.constants`` it needs (the
port imports nothing of the JAX package), plus ``MAX_BITS`` from
``lerc_tpu/ops/pack_tables.py``.
"""
from __future__ import annotations

import enum

import numpy as np

CURRENT_VERSION = 6
FILE_KEY_LERC2 = b"Lerc2 "

# widest numBits of a bit-stuffed block (quantized values are < 2**31)
MAX_BITS = 31


class DataType(enum.IntEnum):
    """Pixel data types, wire codes 0..7 (Lerc2.h:100)."""

    CHAR = 0
    BYTE = 1
    SHORT = 2
    USHORT = 3
    INT = 4
    UINT = 5
    FLOAT = 6
    DOUBLE = 7


DT_TO_NUMPY = {
    DataType.CHAR: np.int8,
    DataType.BYTE: np.uint8,
    DataType.SHORT: np.int16,
    DataType.USHORT: np.uint16,
    DataType.INT: np.int32,
    DataType.UINT: np.uint32,
    DataType.FLOAT: np.float32,
    DataType.DOUBLE: np.float64,
}

NUMPY_TO_DT = {np.dtype(v): DataType(k) for k, v in DT_TO_NUMPY.items()}

DT_SIZE = {
    DataType.CHAR: 1,
    DataType.BYTE: 1,
    DataType.SHORT: 2,
    DataType.USHORT: 2,
    DataType.INT: 4,
    DataType.UINT: 4,
    DataType.FLOAT: 4,
    DataType.DOUBLE: 8,
}


def dt_is_int(dt: DataType) -> bool:
    return dt < DataType.FLOAT
