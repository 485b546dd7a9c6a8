"""Constants of the LERC wire format used by the resident and band codecs.

The port's own copy of ``lerc_tpu.constants`` (the port imports nothing of
the JAX package), plus ``MAX_BITS`` from
``lerc_tpu/ops/pack_tables.py`` and the per-dtype widths of
``lerc_tpu/ops/device_encode.py:514-519``.
"""
from __future__ import annotations

import enum

import numpy as np
import torch

CURRENT_VERSION = 6
FILE_KEY_LERC2 = b"Lerc2 "
FILE_KEY_LERC1 = b"CntZImage "

MICRO_BLOCK_SIZE = 8  # doubled to 16 when the bitrate is low; decoder accepts <= 32
MAX_MICRO_BLOCK_SIZE = 32

# per-band input data limit (2 GB) and blob limits (2 GB / band, 4 GB total)
MAX_BYTES_PER_BAND = 0x7FFFFFFF
MAX_BLOB_BYTES_TOTAL = 0xFFFFFFFF

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


class ErrCode(enum.IntEnum):
    """Error codes of the public API (Lerc_types.h:11-20)."""

    OK = 0
    FAILED = 1
    WRONG_PARAM = 2
    BUFFER_TOO_SMALL = 3
    NAN = 4
    HAS_NO_DATA = 5
    DIMENSIONS_TOO_LARGE = 6


class ImageEncodeMode(enum.IntEnum):
    """Whole-image encode modes (Lerc2.h:143)."""

    TILING = 0
    DELTA_HUFFMAN = 1
    HUFFMAN = 2
    DELTA_DELTA_HUFFMAN = 3  # v6 lossless float path


class BlockEncodeMode(enum.IntEnum):
    """Per-micro-block encode modes (Lerc2.h:144)."""

    RAW_BINARY = 0
    BITSTUFF_SIMPLE = 1
    BITSTUFF_LUT = 2


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


DT_TO_TORCH = {
    DataType.CHAR: torch.int8,
    DataType.BYTE: torch.uint8,
    DataType.SHORT: torch.int16,
    DataType.USHORT: torch.uint16,
    DataType.INT: torch.int32,
    DataType.UINT: torch.uint32,
    DataType.FLOAT: torch.float32,
    DataType.DOUBLE: torch.float64,
}

# kernel-name suffix of each dtype's instances (build.LAUNCHES); float32
# keeps the plain names of the first slices
DT_SUFFIX = {
    DataType.CHAR: "_i8",
    DataType.BYTE: "_u8",
    DataType.SHORT: "_i16",
    DataType.USHORT: "_u16",
    DataType.INT: "_i32",
    DataType.UINT: "_u32",
    DataType.FLOAT: "",
    DataType.DOUBLE: "_f64",
}

# widest numBits of an encoded bit-stuffed block per value size
# (device_encode.py:519); the decoder sizes its window for 32 at 4 B
ENC_MAX_NB = {1: 8, 2: 16, 4: MAX_BITS}
DEC_MAX_NB = {1: 8, 2: 16, 4: 32}


_SIGNED_TWIN = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def as_signed(t: torch.Tensor) -> torch.Tensor:
    """A uint16/uint32 tensor viewed as its signed twin of the same width
    (other dtypes as they are): torch's CPU uint16/uint32 lack index_put and
    masked_fill, so masked writes go through the view."""
    return t.view(_SIGNED_TWIN.get(t.dtype, t.dtype))


def dt_is_int(dt: DataType) -> bool:
    return dt < DataType.FLOAT


def max_val_to_quantize(dt: DataType) -> int:
    """Quantized values above this cap force raw block encoding (Lerc2.h:686-703)."""
    if dt in (DataType.CHAR, DataType.BYTE, DataType.SHORT, DataType.USHORT):
        return (1 << 15) - 1
    return (1 << 30) - 1


def dt_is_signed(dt: DataType) -> bool:
    return dt in (DataType.CHAR, DataType.SHORT, DataType.INT)
