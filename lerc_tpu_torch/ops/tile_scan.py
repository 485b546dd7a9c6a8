"""The band decoder's host record scanner (``kernels/tile_scan.cpp``) and
its plain Python version.

Port of ``lerc_tpu/native/__init__.py::tile_scan`` (:104-118) over
``lerc_native.cpp::lerc_tile_scan`` (:70-145). The record walk is serial:
a raw record holds ``cnt * size`` bytes and a stuffed one a count of its own,
where cnt is the valid count of the record's block, so the device scan K5
(byte-wise pointer doubling, all-valid 8x8 streams only) cannot find masked
or edge records. The band codec and the masked index-free resident decode
scan on the host and hand the descriptors to K6 on the device.

``tile_scan`` calls the compiled scanner (built by ``kernels.build`` with the
host compiler on first use); ``tile_scan_ref`` is the same walk in Python.
Callers on ``device="cpu"`` take the plain version, as with every kernel.
Both raise ValueError on a corrupt stream.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..constants import DT_SIZE, DataType
from ..kernels import build

# one record's descriptor, the layout of the C struct RecordDesc
REC_DTYPE = np.dtype(
    [
        ("payload_pos", np.int64),
        ("offset", np.float64),
        ("mode", np.int32),
        ("num_bits", np.int32),
        ("num_elements", np.int32),
        ("_pad", np.int32),
        ("lut_pos", np.int64),
        ("n_lut", np.int32),
        ("nbits_lut", np.int32),
    ],
    align=True,
)


def _reduced(dt: DataType, tc: int) -> DataType | None:
    """The reduced dtype of a block offset (Lerc2.h:528-542), None where
    the code names no type (a corrupt flag byte)."""
    if dt in (DataType.SHORT, DataType.INT):
        code = dt - tc
    elif dt in (DataType.USHORT, DataType.UINT):
        code = dt - 2 * tc
    elif dt == DataType.FLOAT:
        code = (6, 2, 1, 1)[tc]
    elif dt == DataType.DOUBLE:
        code = 7 if tc == 0 else 8 - 2 * tc
    else:
        code = dt
    return DataType(code) if code >= 0 else None


_NP = {DataType.CHAR: "<i1", DataType.BYTE: "<u1", DataType.SHORT: "<i2",
       DataType.USHORT: "<u2", DataType.INT: "<i4", DataType.UINT: "<u4",
       DataType.FLOAT: "<f4", DataType.DOUBLE: "<f8"}


def block_scan_inputs(mask: np.ndarray, mb: int):
    """(cnts [nBlocks] int32 valid count per block, j0s [nBlocks] int32
    first column per block, nBlocks) of an [H, W] bool mask in mb x mb
    blocks, row-major over the blocks; edge blocks count their in-image
    valid pixels."""
    h, w = mask.shape
    nbv, nbh = -(-h // mb), -(-w // mb)
    j0s = np.tile(np.arange(nbh, dtype=np.int32) * mb, nbv)
    if mask.all():  # the in-image area of each block, without a pass over the pixels
        rows = np.minimum(mb, h - mb * np.arange(nbv, dtype=np.int32))
        cols = np.minimum(mb, w - mb * np.arange(nbh, dtype=np.int32))
        return (rows[:, None] * cols[None, :]).reshape(-1), j0s, nbv * nbh
    padded = np.zeros((nbv * mb, nbh * mb), np.uint8)
    padded[:h, :w] = mask
    cnts = padded.reshape(nbv, mb, nbh, mb).sum(axis=(1, 3), dtype=np.int32).reshape(-1)
    return cnts, j0s, nbv * nbh


def tile_scan(stream: np.ndarray, cnts, j0s, n_blocks: int, n_depth: int, dt: int,
              version: int):
    """Compiled scan of `stream` (uint8, the tile section) -> (records
    [nBlocks * nDepth] of REC_DTYPE, bytes consumed)."""
    stream, cnts, j0s = _check(stream, cnts, j0s, n_blocks, dt)
    fn = build.library("tile_scan").tile_scan
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int64
    recs = np.zeros(n_blocks * n_depth, dtype=REC_DTYPE)
    used = fn(stream.ctypes.data, stream.size, cnts.ctypes.data, j0s.ctypes.data, n_blocks,
              n_depth, int(dt), version, recs.ctypes.data)
    build.LAUNCHES["tile_scan"] += 1
    if used < 0:
        raise ValueError("corrupt Lerc2 tile stream")
    return recs, int(used)


def _check(stream, cnts, j0s, n_blocks, dt):
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    cnts = np.ascontiguousarray(cnts, dtype=np.int32)
    j0s = np.ascontiguousarray(j0s, dtype=np.int32)
    if cnts.shape != (n_blocks,) or j0s.shape != (n_blocks,):
        raise ValueError(f"cnts and j0s must hold {n_blocks} blocks")
    if not 0 <= int(dt) <= 7:
        raise ValueError(f"bad dtype code {dt}")
    return stream, cnts, j0s


def tile_scan_ref(stream: np.ndarray, cnts, j0s, n_blocks: int, n_depth: int, dt: int,
                  version: int):
    """Plain Python version of the scanner: the same walk, record by
    record."""
    buf, cnts, j0s = _check(stream, cnts, j0s, n_blocks, dt)
    dt = DataType(int(dt))
    recs = np.zeros(n_blocks * n_depth, dtype=REC_DTYPE)
    n = buf.size
    pattern = 14 if version >= 5 else 15
    pos = 0

    def corrupt():
        return ValueError("corrupt Lerc2 tile stream")

    for b in range(n_blocks):
        cnt = int(cnts[b])
        for di in range(n_depth):
            r = recs[b * n_depth + di]
            if pos >= n:
                raise corrupt()
            flag = int(buf[pos])
            pos += 1
            diff = version >= 5 and (flag & 4) != 0
            if diff and di == 0:
                raise corrupt()
            if ((flag >> 2) & pattern) != ((int(j0s[b]) >> 3) & pattern):
                raise corrupt()
            code, bits67 = flag & 3, flag >> 6
            r["mode"] = code + (8 if diff else 0)
            if code == 2:
                continue
            if code == 0:
                r["payload_pos"] = pos
                pos += cnt * DT_SIZE[dt]
                if pos > n:
                    raise corrupt()
                continue
            base = DataType.INT if diff and dt < DataType.FLOAT else dt
            used = _reduced(base, bits67)
            if used is None:
                raise corrupt()
            width = DT_SIZE[used]
            if pos + width > n:
                raise corrupt()
            r["offset"] = float(np.frombuffer(buf[pos:pos + width].tobytes(), _NP[used])[0])
            pos += width
            if code == 3:
                continue
            if pos >= n:
                raise corrupt()
            nbb = int(buf[pos])
            pos += 1
            cw = 4 if nbb >> 6 == 0 else 3 - (nbb >> 6)
            lut, nb = (nbb & 32) != 0, nbb & 31
            if pos + cw > n:
                raise corrupt()
            n_elem = int.from_bytes(buf[pos:pos + cw].tobytes(), "little")
            pos += cw
            if n_elem > 64 * 64:
                raise corrupt()
            r["num_elements"], r["num_bits"] = n_elem, nb
            if not lut:
                r["payload_pos"] = pos
                pos += (n_elem * nb + 7) >> 3
                if pos > n:
                    raise corrupt()
                continue
            if nb == 0 or pos >= n:
                raise corrupt()
            n_lut = int(buf[pos]) - 1
            pos += 1
            if n_lut < 0:
                raise corrupt()
            r["mode"] = 4 + (8 if diff else 0)
            r["n_lut"], r["lut_pos"] = n_lut, pos
            pos += (n_lut * nb + 7) >> 3
            nbits_lut = n_lut.bit_length()
            if nbits_lut == 0:
                raise corrupt()
            r["nbits_lut"], r["payload_pos"] = nbits_lut, pos
            pos += (n_elem * nbits_lut + 7) >> 3
            if pos > n:
                raise corrupt()
    return recs, pos
