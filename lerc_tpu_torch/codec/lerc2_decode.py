"""Single-band Lerc2 blob decoder (codec v1..v6) on the host, in numpy.

The port's own copy of ``lerc_tpu/codec/lerc2_decode.py``: the semantics of
Lerc2::Decode (Lerc2.cpp:577-694) and ReadTiles/ReadTile (Lerc2.cpp:1672-2230)
with vectorized numpy per-block inner loops, for any micro block up to 32,
the legacy bit order of versions < 3, one-sweep, whole-image Huffman and fpl
sections. The orchestrator decodes with it every band it does not route to
``device_codec.decode_band_device``.

Output data layout is [nRows, nCols, nDepth] (band-interleaved-by-pixel,
as on the wire).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import DT_SIZE, DT_TO_NUMPY, DataType, ImageEncodeMode
from . import bitstuffer, fletcher32, fpl_impl, huffman, rle
from . import header as hdr
from .bitmask import bits_to_bool, mask_size_bytes


@dataclasses.dataclass
class HostDecodedBand:
    """One band decoded on the host (numpy data; the device codec's
    ``DecodedBand`` holds a tensor)."""

    hd: hdr.HeaderInfo
    mask: np.ndarray  # [nRows, nCols] bool
    data: np.ndarray  # [nRows, nCols, nDepth]
    z_min_vec: np.ndarray | None
    z_max_vec: np.ndarray | None
    consumed: int


# -------------------------------------------------------------------------
# reduced data types for block offsets (Lerc2.h:528-542)
# -------------------------------------------------------------------------

def data_type_used(dt: DataType, tc: int) -> DataType:
    if dt in (DataType.SHORT, DataType.INT):
        return DataType(dt - tc)
    if dt in (DataType.USHORT, DataType.UINT):
        return DataType(dt - 2 * tc)
    if dt == DataType.FLOAT:
        return dt if tc == 0 else (DataType.SHORT if tc == 1 else DataType.BYTE)
    if dt == DataType.DOUBLE:
        return dt if tc == 0 else DataType(dt - 2 * tc + 1)
    return dt


def read_variable_value(src: memoryview, dt_used: DataType) -> tuple[float, int]:
    np_dt = DT_TO_NUMPY[dt_used]
    size = DT_SIZE[dt_used]
    val = np.frombuffer(src[:size], dtype=np_dt)[0]
    return float(val), size


# -------------------------------------------------------------------------
# main decode
# -------------------------------------------------------------------------

def read_band_ranges(buf: bytes | memoryview):
    """Per-depth (z_min_vec, z_max_vec) of one band WITHOUT pixel decode:
    header + mask-section skip + ranges-section read only, mirroring
    Lerc2::GetRanges (reference Lerc2.cpp:514-573). Falls back to the
    header's scalar zMin/zMax for v<4 blobs or const images."""
    src = memoryview(buf)
    hd, pos = hdr.read_header(src)
    n_depth = hd.n_depth
    num_bytes_mask = int.from_bytes(src[pos : pos + 4], "little", signed=True)
    if num_bytes_mask < 0:
        raise ValueError("negative mask size")
    pos += 4 + num_bytes_mask  # skip the RLE mask payload untouched
    scalar = (np.full(n_depth, hd.z_min), np.full(n_depth, hd.z_max))
    if hd.num_valid_pixel == 0 or hd.z_min == hd.z_max or hd.version < 4:
        return hd, scalar
    np_dt = DT_TO_NUMPY[hd.dt]
    nb = n_depth * DT_SIZE[hd.dt]
    z_mins = np.frombuffer(src[pos : pos + nb], dtype=np_dt).astype(np.float64)
    z_maxs = np.frombuffer(src[pos + nb : pos + 2 * nb], dtype=np_dt).astype(np.float64)
    if len(z_mins) != n_depth or len(z_maxs) != n_depth:
        raise ValueError("truncated ranges section")
    return hd, (z_mins, z_maxs)


def decode_band(
    buf: bytes | memoryview,
    prev_mask: np.ndarray | None = None,
    verify_checksum: bool = True,
) -> HostDecodedBand:
    src = memoryview(buf)
    hd, pos = hdr.read_header(src)
    if len(src) < hd.blob_size:
        raise ValueError("buffer shorter than blobSize")

    if hd.version >= 3 and verify_checksum:
        skip = hdr.checksum_skip(hd.version)
        computed = fletcher32.fletcher32(src[skip : hd.blob_size])
        if computed != hd.checksum:
            raise ValueError("Lerc2 checksum mismatch")

    n_rows, n_cols, n_depth = hd.n_rows, hd.n_cols, hd.n_depth
    np_dt = DT_TO_NUMPY[hd.dt]

    # ---- mask section (Lerc2.cpp:961-1008)
    num_bytes_mask = int.from_bytes(src[pos : pos + 4], "little", signed=True)
    pos += 4
    if num_bytes_mask < 0 or num_bytes_mask > len(src) - pos:
        raise ValueError("bad mask section size")
    num_total = n_rows * n_cols
    if (hd.num_valid_pixel in (0, num_total)) and num_bytes_mask != 0:
        raise ValueError("unexpected mask bytes")
    if hd.num_valid_pixel == 0:
        mask = np.zeros((n_rows, n_cols), dtype=bool)
    elif hd.num_valid_pixel == num_total:
        mask = np.ones((n_rows, n_cols), dtype=bool)
    elif num_bytes_mask > 0:
        mask_bits = rle.decompress(src[pos : pos + num_bytes_mask], mask_size_bytes(n_cols, n_rows))
        mask = bits_to_bool(mask_bits, n_cols, n_rows)
        pos += num_bytes_mask
    else:
        if prev_mask is None:
            raise ValueError("mask reuse requested but no previous mask")
        mask = prev_mask.copy()

    data = np.zeros((n_rows, n_cols, n_depth), dtype=np_dt)
    out = HostDecodedBand(hd, mask, data, None, None, hd.blob_size)

    if hd.num_valid_pixel == 0:
        return out

    if hd.z_min == hd.z_max:  # const image
        _fill_const(out)
        return out

    if hd.version >= 4:
        z_mins = np.frombuffer(src[pos : pos + n_depth * DT_SIZE[hd.dt]], dtype=np_dt).astype(np.float64)
        pos += n_depth * DT_SIZE[hd.dt]
        z_maxs = np.frombuffer(src[pos : pos + n_depth * DT_SIZE[hd.dt]], dtype=np_dt).astype(np.float64)
        pos += n_depth * DT_SIZE[hd.dt]
        out.z_min_vec, out.z_max_vec = z_mins, z_maxs
        if np.array_equal(z_mins, z_maxs):
            _fill_const(out)
            return out

    if pos >= len(src):
        raise ValueError("truncated blob: missing flag bytes")
    read_one_sweep = src[pos]
    pos += 1

    if read_one_sweep:
        _read_data_one_sweep(src, pos, out)
        return out

    if hd.try_huffman_int() or hd.try_huffman_flt():
        if pos >= len(src):
            raise ValueError("truncated blob: missing image-mode byte")
        flag = src[pos]
        pos += 1
        if flag > 3 or (flag > 2 and hd.version < 6) or (flag > 1 and hd.version < 4):
            raise ValueError("bad image encode mode flag")
        mode = ImageEncodeMode(flag)
        if mode != ImageEncodeMode.TILING:
            if hd.try_huffman_int():
                if mode == ImageEncodeMode.DELTA_HUFFMAN or (
                    hd.version >= 4 and mode == ImageEncodeMode.HUFFMAN
                ):
                    _decode_huffman(src, pos, out, mode)
                    return out
                raise ValueError("bad huffman mode")
            elif hd.try_huffman_flt() and mode == ImageEncodeMode.DELTA_DELTA_HUFFMAN:
                fpl_impl.decode_flt(src, pos, out)
                return out
            else:
                raise ValueError("bad image encode mode")

    _read_tiles(src, pos, out)
    return out


def _fill_const(out: HostDecodedBand) -> None:
    hd = out.hd
    np_dt = DT_TO_NUMPY[hd.dt]
    if hd.n_depth == 1 or hd.z_min == hd.z_max:
        vals = np.full(hd.n_depth, np_dt(hd.z_min))
    else:
        vals = out.z_min_vec.astype(np_dt)
    out.data[out.mask] = vals


def _read_data_one_sweep(src: memoryview, pos: int, out: HostDecodedBand) -> None:
    hd = out.hd
    np_dt = DT_TO_NUMPY[hd.dt]
    n_valid = int(np.count_nonzero(out.mask))
    n = n_valid * hd.n_depth
    nbytes = n * DT_SIZE[hd.dt]
    if len(src) - pos < nbytes:
        raise ValueError("truncated one-sweep data")
    vals = np.frombuffer(src[pos : pos + nbytes], dtype=np_dt).reshape(n_valid, hd.n_depth)
    out.data[out.mask] = vals


# -------------------------------------------------------------------------
# tiling path
# -------------------------------------------------------------------------

def _read_tiles(src: memoryview, pos: int, out: HostDecodedBand) -> None:
    hd = out.hd
    mb = hd.micro_block_size
    if mb > 32:
        raise ValueError("microBlockSize too large")
    n_rows, n_cols, n_depth = hd.n_rows, hd.n_cols, hd.n_depth
    np_dt = DT_TO_NUMPY[hd.dt]
    dt_is_int = hd.dt < DataType.FLOAT
    inv_scale = 2.0 * hd.max_z_error
    num_tiles_v = (n_rows + mb - 1) // mb
    num_tiles_h = (n_cols + mb - 1) // mb

    for it in range(num_tiles_v):
        i0 = it * mb
        i1 = min(i0 + mb, n_rows)
        for jt in range(num_tiles_h):
            j0 = jt * mb
            j1 = min(j0 + mb, n_cols)
            block_mask = out.mask[i0:i1, j0:j1]
            n_valid = int(np.count_nonzero(block_mask))
            for idepth in range(n_depth):
                pos = _read_tile(
                    src, pos, out, i0, i1, j0, j1, idepth, block_mask, n_valid,
                    np_dt, dt_is_int, inv_scale,
                )


def _read_tile(
    src, pos, out, i0, i1, j0, j1, idepth, block_mask, n_valid, np_dt, dt_is_int, inv_scale
):
    hd = out.hd
    if pos >= len(src):
        raise ValueError("truncated tile stream")
    compr_flag = src[pos]
    pos += 1
    b_diff = (hd.version >= 5) and bool(compr_flag & 4)
    pattern = 14 if hd.version >= 5 else 15
    if ((compr_flag >> 2) & pattern) != ((j0 >> 3) & pattern):
        raise ValueError("micro-block integrity check failed")
    if b_diff and idepth == 0:
        raise ValueError("diff encoding on depth slice 0")
    bits67 = compr_flag >> 6
    code = compr_flag & 3

    sub = out.data[i0:i1, j0:j1, idepth]

    if code == 2:  # const 0 (or diff: equal to previous slice)
        if b_diff:
            sub[block_mask] = out.data[i0:i1, j0:j1, idepth - 1][block_mask]
        # else: already zero-initialized
        return pos

    if code == 0:  # raw binary
        if b_diff:
            raise ValueError("raw block cannot be diff encoded")
        nbytes = n_valid * DT_SIZE[hd.dt]
        if len(src) - pos < nbytes:
            raise ValueError("truncated raw block")
        vals = np.frombuffer(src[pos : pos + nbytes], dtype=np_dt)
        sub[block_mask] = vals
        return pos + nbytes

    # code 1 or 3: offset + optionally bit-stuffed values
    base_dt = DataType.INT if (b_diff and dt_is_int) else hd.dt
    dt_used = data_type_used(base_dt, bits67)
    offset, used = read_variable_value(src[pos:], dt_used)
    pos += used
    z_max = (
        out.z_max_vec[idepth]
        if (hd.version >= 4 and hd.n_depth > 1)
        else hd.z_max
    )

    if code == 3:  # const offset
        if not b_diff:
            sub[block_mask] = np_dt(offset)
        else:
            z = offset + out.data[i0:i1, j0:j1, idepth - 1][block_mask].astype(np.float64)
            sub[block_mask] = np.minimum(z, z_max).astype(np_dt)
        return pos

    # code == 1: bit stuffed
    max_elem_count = (i1 - i0) * (j1 - j0)
    quant, used = bitstuffer.decode(src[pos:], max_elem_count, hd.version)
    pos += used
    if quant.size == max_elem_count:
        q = quant.reshape(i1 - i0, j1 - j0)
        z = offset + q.astype(np.float64) * inv_scale
        if b_diff:
            z = z + out.data[i0:i1, j0:j1, idepth - 1].astype(np.float64)
        np.minimum(z, z_max, out=z)
        out.data[i0:i1, j0:j1, idepth] = z.astype(np_dt)
    else:
        if quant.size < n_valid:
            raise ValueError("not enough stuffed values for valid pixels")
        z = offset + quant[:n_valid].astype(np.float64) * inv_scale
        if b_diff:
            z = z + out.data[i0:i1, j0:j1, idepth - 1][block_mask].astype(np.float64)
        sub = out.data[i0:i1, j0:j1, idepth]
        sub[block_mask] = np.minimum(z, z_max).astype(np_dt)
    return pos


# -------------------------------------------------------------------------
# whole-image Huffman path (8-bit types)
# -------------------------------------------------------------------------

def _decode_huffman(src: memoryview, pos: int, out: HostDecodedBand, mode: ImageEncodeMode) -> None:
    hd = out.hd
    np_dt = DT_TO_NUMPY[hd.dt]
    offset = 128 if hd.dt == DataType.CHAR else 0
    h, w, n_depth = hd.n_rows, hd.n_cols, hd.n_depth

    lengths, codes, used = huffman.read_code_table(src[pos:], hd.version)
    pos += used
    n_valid = int(np.count_nonzero(out.mask))
    n_symbols = n_valid * n_depth
    syms, used = huffman.decode_symbols(src[pos:], lengths, codes, n_symbols)
    vals = (syms - offset).astype(np_dt)

    all_valid = n_valid == h * w

    if mode == ImageEncodeMode.HUFFMAN:
        # pixel-major: for each valid pixel, nDepth values
        out.data[out.mask] = vals.reshape(n_valid, n_depth)
        return

    # DELTA_HUFFMAN: depth-major, row-scan delta chain
    if all_valid:
        for d in range(n_depth):
            delta = vals[d * h * w : (d + 1) * h * w].reshape(h, w)
            first_col = np.cumsum(delta[:, 0], dtype=np_dt)
            e = delta.copy()
            e[:, 0] = first_col
            out.data[:, :, d] = np.cumsum(e, axis=1, dtype=np_dt)
        return

    # masked delta chain (serial semantics, Lerc2.cpp:2546-2575), vectorized
    # per row. Only the "pixel above is valid but left neighbor is not" case
    # breaks the running scan-order chain; everything else is a cumulative sum
    # in mod-256 arithmetic, so each row is a segmented cumsum whose segment
    # bases come from the (already decoded) previous row.
    mask = out.mask
    for d in range(n_depth):
        dv = vals[d * n_valid : (d + 1) * n_valid].view(np.uint8)
        data2d = np.zeros((h, w), dtype=np.uint8)
        carry = np.uint8(0)
        t = 0
        for i in range(h):
            row_mask = mask[i]
            m = int(np.count_nonzero(row_mask))
            if m == 0:
                continue
            cols = np.flatnonzero(row_mask)
            drow = dv[t : t + m]
            t += m
            # break where left neighbor invalid/absent but pixel above valid
            left_ok = np.zeros(m, dtype=bool)
            left_ok[1:] = cols[1:] == cols[:-1] + 1
            if cols[0] > 0:
                left_ok[0] = row_mask[cols[0] - 1]  # always False (maximal run start)
            above_ok = mask[i - 1][cols] if i > 0 else np.zeros(m, dtype=bool)
            is_break = (~left_ok) & above_ok
            # segment bases: v_above at breaks, running carry at position 0
            cs = np.cumsum(drow, dtype=np.uint8)
            base = np.zeros(m, dtype=np.uint8)
            if i > 0:
                base[is_break] = data2d[i - 1][cols[is_break]]
            seg_start = is_break.copy()
            seg_start[0] = True
            if not is_break[0]:
                base[0] = carry
            # offset per segment: base_s - cs[s-1] (mod 256)
            start_idx = np.flatnonzero(seg_start)
            cs_before = np.zeros(m, dtype=np.uint8)
            cs_before[1:] = cs[:-1]
            seg_id = np.cumsum(seg_start) - 1
            offsets = (base[start_idx] - cs_before[start_idx]).astype(np.uint8)
            v = (cs + offsets[seg_id]).astype(np.uint8)
            data2d[i][cols] = v
            carry = v[-1]
        out.data[:, :, d][mask] = data2d.view(np_dt)[mask]
