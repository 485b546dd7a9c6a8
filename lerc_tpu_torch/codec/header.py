"""Lerc2 blob header read/write (codec versions 1..6).

Layout (Esri LERC, Lerc2.cpp:710-917; the port's copy of lerc_tpu/codec/header.py):

  "Lerc2 "                         6 bytes
  version                          int32
  checksum                         uint32        (v >= 3)
  nRows, nCols                     int32 each
  nDepth                           int32         (v >= 4)
  numValidPixel, microBlockSize,
  blobSize, dataType               int32 each
  nBlobsMore                       int32         (v >= 6)
  bPassNoDataValues, bIsInt, r3, r4  1 byte each (v >= 6)
  maxZError, zMin, zMax            float64 each
  noDataVal, noDataValOrig         float64 each  (v >= 6)

All integers little-endian.
"""
from __future__ import annotations

import dataclasses
import struct

from ..constants import CURRENT_VERSION, DT_SIZE, FILE_KEY_LERC2, DataType


@dataclasses.dataclass
class HeaderInfo:
    version: int = CURRENT_VERSION
    checksum: int = 0
    n_rows: int = 0
    n_cols: int = 0
    n_depth: int = 1
    num_valid_pixel: int = 0
    micro_block_size: int = 8
    blob_size: int = 0
    n_blobs_more: int = 0
    b_pass_no_data_values: int = 0
    b_is_int: int = 0
    dt: DataType = DataType.FLOAT
    max_z_error: float = 0.0
    z_min: float = 0.0
    z_max: float = 0.0
    no_data_val: float = 0.0
    no_data_val_orig: float = 0.0

    def try_huffman_int(self) -> bool:
        return (
            self.version >= 2
            and self.dt in (DataType.BYTE, DataType.CHAR)
            and self.max_z_error == 0.5
        )

    def try_huffman_flt(self) -> bool:
        return (
            self.version >= 6
            and self.dt in (DataType.FLOAT, DataType.DOUBLE)
            and self.max_z_error == 0
        )


def header_size(version: int) -> int:
    n = len(FILE_KEY_LERC2) + 4
    n += 4 if version >= 3 else 0
    n += (7 if version >= 4 else 6) * 4
    n += 4 if version >= 6 else 0  # nBlobsMore
    n += 4 if version >= 6 else 0  # the 4 flag bytes
    n += (5 if version >= 6 else 3) * 8
    return n


def checksum_skip(version: int) -> int:
    """Offset where the checksummed region starts (right after the checksum)."""
    return len(FILE_KEY_LERC2) + 4 + 4


def write_header(hd: HeaderInfo) -> bytes:
    out = bytearray()
    out += FILE_KEY_LERC2
    out += struct.pack("<i", hd.version)
    if hd.version >= 3:
        out += struct.pack("<I", hd.checksum)
    ints = [hd.n_rows, hd.n_cols]
    if hd.version >= 4:
        ints.append(hd.n_depth)
    ints += [hd.num_valid_pixel, hd.micro_block_size, hd.blob_size, int(hd.dt)]
    if hd.version >= 6:
        ints.append(hd.n_blobs_more)
    out += struct.pack(f"<{len(ints)}i", *ints)
    if hd.version >= 6:
        out += bytes([hd.b_pass_no_data_values, hd.b_is_int, 0, 0])
    dbls = [hd.max_z_error, hd.z_min, hd.z_max]
    if hd.version >= 6:
        dbls += [hd.no_data_val, hd.no_data_val_orig]
    out += struct.pack(f"<{len(dbls)}d", *dbls)
    return bytes(out)


def read_header(buf: memoryview | bytes) -> tuple[HeaderInfo, int]:
    """Returns (header, bytes consumed). Raises ValueError on malformed input."""
    try:
        return _read_header(buf)
    except struct.error as e:
        raise ValueError(f"truncated Lerc2 header: {e}") from e


def _read_header(buf: memoryview | bytes) -> tuple[HeaderInfo, int]:
    src = memoryview(buf)
    key_len = len(FILE_KEY_LERC2)
    if len(src) < key_len or bytes(src[:key_len]) != FILE_KEY_LERC2:
        raise ValueError("not a Lerc2 blob")
    pos = key_len
    (version,) = struct.unpack_from("<i", src, pos)
    pos += 4
    if version < 0 or version > CURRENT_VERSION:
        raise ValueError(f"unsupported codec version {version}")
    hd = HeaderInfo(version=version)
    if version >= 3:
        (hd.checksum,) = struct.unpack_from("<I", src, pos)
        pos += 4
    n_ints = 6 + (1 if version >= 4 else 0) + (1 if version >= 6 else 0)
    ints = struct.unpack_from(f"<{n_ints}i", src, pos)
    pos += 4 * n_ints
    if version >= 6:
        flags = bytes(src[pos : pos + 4])
        pos += 4
    else:
        flags = b"\0\0\0\0"
    n_dbls = 3 + (2 if version >= 6 else 0)
    dbls = struct.unpack_from(f"<{n_dbls}d", src, pos)
    pos += 8 * n_dbls

    i = 0
    hd.n_rows = ints[i]; i += 1
    hd.n_cols = ints[i]; i += 1
    hd.n_depth = ints[i] if version >= 4 else 1
    i += 1 if version >= 4 else 0
    hd.num_valid_pixel = ints[i]; i += 1
    hd.micro_block_size = ints[i]; i += 1
    hd.blob_size = ints[i]; i += 1
    dt = ints[i]; i += 1
    if (
        hd.n_rows <= 0 or hd.n_cols <= 0 or hd.n_depth <= 0 or hd.num_valid_pixel < 0
        or hd.micro_block_size <= 0 or hd.blob_size <= 0
        or dt < DataType.CHAR or dt > DataType.DOUBLE
    ):
        raise ValueError("malformed Lerc2 header")
    hd.dt = DataType(dt)
    hd.n_blobs_more = ints[i] if version >= 6 else 0
    hd.b_pass_no_data_values = flags[0]
    hd.b_is_int = flags[1]
    hd.max_z_error, hd.z_min, hd.z_max = dbls[0], dbls[1], dbls[2]
    if version >= 6:
        hd.no_data_val, hd.no_data_val_orig = dbls[3], dbls[4]

    # dimension guards (Lerc2.cpp:897-911)
    num_pixel = hd.n_rows * hd.n_cols
    maxint32 = 0x7FFFFFFF
    nbpp = DT_SIZE[hd.dt]
    if num_pixel > maxint32 or hd.num_valid_pixel > num_pixel:
        raise ValueError("dimensions too large")
    if hd.micro_block_size > 32 or nbpp * hd.n_depth > maxint32 or nbpp * hd.n_depth * num_pixel > maxint32:
        raise ValueError("dimensions too large")
    return hd, pos
