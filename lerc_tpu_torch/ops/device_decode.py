"""Index-driven Lerc2 tile decoding (kernel K4 ``decode_records`` and its
plain version).

Port of ``lerc_tpu/ops/device_decode.py::decode_tiles_fast`` (:64): for the
resident codec's path float32 and the integer dtypes, 8x8 micro blocks,
all-valid or masked, one tile, no LUT; for the mosaic's
(``decode_records_lut``, below) LUT records, 8x8 and 16x16 blocks, n units
in one launch, the depth-diff chain of ``decode_tiles`` (:625-698),
per-unit flags. Each record is parsed at its entry of the encoder's
``starts`` index; values are extracted LSB-first and float32 dequantizes
with the exact double ScaleBack of ``_exact_f32_scale_back`` (:30):
``(float)min(zMin + q*invScale, zMax)``, one rounding per operation,
narrowed to f32 and then clamped with std::min's pick. ``invScale`` is the
f64 ``2*maxZError`` of the header's double, as the reference decoder uses
it. On Hopper this is native f64; the TPU's softfloat modules have no port.

The resident K4 (float32 ``decode_records``, the integer
``decode_records_int``) is one strip kernel (kernels/decode.cu
``decode_records_strip_kernel``): a CTA owns ``strip_blocks(8, D, size)``
consecutive blocks of a block row, stages their records' bytes (from the
first record's start to the next strip's) and their image in shared
memory, parses each record once and decodes a pixel a thread; a read
outside the staged bytes (a hostile index, a record past the stage) goes
to the stream in the same kernel, 0 outside it. Its plain version is
``decode_records_ref`` (``decode_records_int_ref``), which the CPU path
runs.

With a mask (the block validity words of ``device_encode.block_valid_words``)
a record holds its block's valid values in position order: valid position
j reads the value at its rank among the valid positions -- the inverse
routing of ``make_expander`` (device_encode.py:357), whose plain version is
``device_encode.expand_ref`` -- and invalid positions decode to +0.0
(``decode_records_masked``).

The index is untrusted: a record whose parsed length disagrees with the
next index entry, a stuffed count other than the block's valid count (64
without a mask), or a LUT bit clears ``index_ok``; so does a mask that
disagrees with the stream. Records wider than ``nb_cap`` clear ``fits``.

Integer dtypes (:189-198 and the integer dequant :390-408) run the integer
instances of K4 (``decode_records_int``, counted as e.g.
``decode_records_i16``): per-dtype offset widths and signs, raw values of
1, 2 or 4 bytes, exact ``min(offset + q * round(2 mze), zMax)`` in int32,
the image in the native dtype. A depth-diff record (flag bit 2 at version
>= 5) clears ``index_ok`` in every instance, float32 included: it needs the
previous slice, which only the scanned decode adds (the host decoder and
the reference apply the diff to float32 records too; JAX's
decode_tiles_fast checks no diff bit for any dtype, and reads a float32
diff record as an absolute one).

Kernel K6 ``decode_scanned`` decodes from record descriptors without any
index -- those of the device record scan (``device_scan.scan_records``, K5)
or of the host scanner (``tile_scan``) -- a port of ``decode_tiles``
(:493-708) with ``_unpack_records`` (:464): 8x8 and 16x16 blocks, float32,
float64 and every integer dtype, all-valid, masked or with edge blocks, every
record mode with LUT records (mode 4, ``lut_full = [0] + entries``), and the
depth-diff chains, integer (:625-648) and the exact f32 one (:650-698,
``z = (float)min(a_diff_f64 + (double)prev, zMax)``). Its float64 instances
port ``decode_tiles_f64`` (:716-879, LUT records and the depth-diff chain
:818-869 included) in native f64: ``z = min(offset + q * invScale, zMax)``
with each operation rounded, std::min's pick, and ``min(a + prev, zMax)``
down the chain. Where JAX's softfloat leaves a blob to the host (subnormal
or non-finite offsets, an extreme invScale, a sum that underflows), K6
decodes it. Its instances are counted as ``decode_scanned`` + ``16`` (16x16
blocks) + ``_masked`` (validity words: masks, edge blocks) + the dtype's
suffix (``_f64`` for float64).

Where it decodes a block the host decoder refuses (lerc2_decode.py
:233-306, bitstuffer.py:191-222), ``ok`` drops: a stuffed count over the
block's in-image area or under its valid count (and not the area), a LUT
index past the LUT, a raw diff record, a diff record on slice 0. uint32's
diff chain clamps in u32 order, as its plain values do.
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import numpy as np
import torch

from ..constants import DEC_MAX_NB, DT_SIZE, DT_SUFFIX, DT_TO_TORCH, DataType, dt_is_int, dt_is_signed
from ..kernels import build
from .device_encode import _n_blocks, _record_lanes, _valid_args, expand_ref, valid_lanes
from .device_scan import (_as_i32, _i32, float_offset_ref, int_offset_ref, offset_width_ref,
                          raw_int_ref)

_WIN = 264  # bytes read per record: the widest record and its 5-byte tail


def decode_tiles_fast(stream: torch.Tensor, starts: torch.Tensor, max_z_error: float,
                      z_max_vec: torch.Tensor, h: int, w: int, d: int, dt: DataType,
                      version: int, nb_cap: int = 0, mask=None, mb: int = 8,
                      n_tiles: int = 1, enable_lut: bool = False):
    """The resident codecs' form -- one tile of 8x8 records, enable_lut
    False -- returns (img [H, W, D], index_ok 0-d bool, fits 0-d bool); a
    depth-diff record clears index_ok. The mosaic's form -- enable_lut,
    mb = 16 or n_tiles > 1 -- returns per unit (img [nTiles, H, W, D] for
    every n_tiles, index_ok [nTiles], fits [nTiles], scanned [nTiles]): it
    adds the depth-diff chain, and `scanned` marks, apart from index errors,
    a unit with a diff record the chain cannot take (on slice 0, or raw;
    the host decoder refuses both) (``decode_records_lut``). Both
    on the stream's device, with no host synchronization; img is float32,
    or the native dtype of an integer `dt`.

    starts: [nTiles * nRec] int32 absolute byte offsets (each tile's records
    in turn). z_max_vec: [D] or [nTiles, D] float32 clamp values, int32 for
    integer dtypes (uint32 as its bits). mask: None, or the block validity
    words of the tiles' masks stacked in tile order
    (``device_encode.block_valid_words(masks.reshape(nTiles * H, W), mb)``)
    on the stream's device."""
    if dt == DataType.DOUBLE:
        raise NotImplementedError(
            "float64 has no indexed decode (JAX's decode_tiles_fast has none): decode float64 "
            "blobs with decode_band_device")
    if mb not in (8, 16) or h % mb or w % mb or d < 1 or n_tiles < 1:
        raise NotImplementedError(
            "the indexed decode of edge blocks (H, W not multiples of the block size): JAX's "
            "decode_tiles_fast has none either (it asserts H % mb == W % mb == 0); decode such "
            "tiles with decode_band_device")
    max_nb = DEC_MAX_NB[DT_SIZE[dt]]
    eff_cap = max_nb if nb_cap <= 0 else min(nb_cap, max_nb)
    cap_nb = 32 if eff_cap >= max_nb else eff_cap  # 32: every record fits
    if enable_lut or mb != 8 or n_tiles != 1:
        img, flags = decode_records_lut(stream, starts, z_max_vec.reshape(n_tiles, d),
                                        max_z_error, h, w, d, dt, version, mb, n_tiles,
                                        enable_lut, cap_nb, mask)
        return img, flags[:, 0] != 0, flags[:, 1] != 0, flags[:, 2] != 0
    if dt_is_int(dt):
        img, flags = decode_records_int(stream, starts, z_max_vec, _inv_i(max_z_error), h, w, d,
                                        dt, version, cap_nb, 0 < nb_cap <= 16, mask)
    else:
        img, flags = decode_records(stream, starts, z_max_vec, 2.0 * float(max_z_error),
                                    h, w, d, version, cap_nb, 0 < nb_cap <= 16, mask)
    return img, flags[0] != 0, flags[1] != 0


def strip_shape(mb: int, d: int, size: int, lead: int = 0) -> tuple[int, int]:
    """(blocks a strip, depths a chunk) of the strip kernels, the integer
    K4 and K6 (lead 0) and the integer K1 (lead 1): ``strip_shape`` of
    kernels/record.cuh, whose strips hold at most 2,048 pixels and 8 KB of
    image; a block past that is a strip of its own, its depths in chunks,
    each with ``lead`` slices before its own beside it (K1 stages the slice
    before a chunk for its depth-diff candidate). The edge cases of tests
    and chip_smoke.py take their widths from it."""
    bp, pb = mb * mb, d * size
    if bp * pb <= 8192:
        return max(1, min(2048, 8192 // pb) // bp), d
    return 1, max(1, 8192 // (bp * size) - lead)


def strip_blocks(mb: int, d: int, size: int) -> int:
    """Blocks a CTA of the integer K4 and K6 owns (``strip_shape``)."""
    return strip_shape(mb, d, size)[0]


def _inv_i(max_z_error: float) -> int:
    """The integer dequantization step round(f32(2 * f32(maxZError)))."""
    return int(np.round(np.float32(2.0) * np.float32(max_z_error)))


def _check_records(stream, starts, zmax, n_rec, d, ztype):
    if stream.dtype != torch.int32 or stream.dim() != 1 or not stream.is_contiguous():
        raise TypeError("stream must be a contiguous 1-D int32 tensor of u32 words")
    if starts.dtype != torch.int32 or starts.shape != (n_rec,) or not starts.is_contiguous():
        raise ValueError(f"starts must be a contiguous int32 [{n_rec}] tensor")
    if zmax.dtype != ztype or zmax.shape != (d,) or not zmax.is_contiguous():
        raise ValueError(f"zmax must be a contiguous {ztype} [{d}] tensor")


def decode_records(stream: torch.Tensor, starts: torch.Tensor, zmax: torch.Tensor,
                   inv: float, h: int, w: int, d: int, version: int, cap_nb: int,
                   lut_unfit: bool, valid: torch.Tensor | None = None):
    """(img [H, W, D] f32, flags [2] int32 = {index_ok, fits}).

    stream: [S] int32 u32 words; starts: [nRec] int32 byte offsets; zmax:
    [D] f32 clamp values; inv: f64 invScale; version: the blob's (at >= 5 a
    depth-diff record clears index_ok); cap_nb: widest record that fits
    (32: all); lut_unfit: a LUT record also clears fits; valid: block
    validity words, or None when every pixel is valid."""
    n_rec = (h // 8) * (w // 8) * d
    _check_records(stream, starts, zmax, n_rec, d, torch.float32)
    vt, sfx, valid_ptr = _valid_args(valid, h, w)
    if not build.on_cuda(stream, starts, zmax, *vt):
        return decode_records_ref(stream, starts, zmax, inv, h, w, d, version, cap_nb, lut_unfit,
                                  valid)
    fn = build.library("decode").decode_records
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_double] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    dev = stream.device
    with torch.cuda.device(dev):
        img = torch.empty(h, w, d, dtype=torch.float32, device=dev)
        flags = torch.ones(2, dtype=torch.int32, device=dev)
        err = fn(stream.data_ptr(), 4 * stream.numel(), starts.data_ptr(), valid_ptr,
                 zmax.data_ptr(), inv, h, w, d, int(version >= 5), cap_nb, int(lut_unfit),
                 img.data_ptr(), flags.data_ptr(), build.launch_stream(stream))
        build.check(err, "decode_records" + sfx)
    build.LAUNCHES["decode_records" + sfx] += 1
    return img, flags


def _to_image(z: torch.Tensor, h: int, w: int, d: int, dtype) -> torch.Tensor:
    """Record-major values [nRec, 64] (r = b*D + di) -> [H, W, D] of dtype
    (integers wrap to the dtype's width)."""
    return (z.reshape(h // 8, w // 8, d, 8, 8).permute(0, 3, 1, 4, 2)
            .reshape(h, w, d).to(dtype).contiguous())


def _parse_records(stream: torch.Tensor, starts: torch.Tensor, dt: DataType, d: int,
                   valid: torch.Tensor | None) -> SimpleNamespace:
    """What both plain K4s read of each record at its index entry, from a
    byte window per record (int64 bit arithmetic): flag fields, the offset
    bytes `acc`, the values `q` [nRec, 64] (raw words or stuffed quants, in
    block positions: masked values go back through ``expand_ref``), the
    lane validity `vb`, and the parsed record length."""
    dev = stream.device
    sb = stream.view(torch.uint8)
    n_bytes = sb.numel()
    p = starts.to(torch.int64)
    n = p.numel()
    idx = p[:, None] + torch.arange(_WIN, device=dev)[None, :]
    inb = (idx >= 0) & (idx < n_bytes)
    win = torch.where(inb, sb[idx.clamp(0, n_bytes - 1)], 0).to(torch.int64)

    def byte(off):  # record byte at a per-record offset [n]
        return win.gather(1, off[:, None]).squeeze(1)

    flag = win[:, 0]
    mode, b67 = flag & 3, flag >> 6
    off_w = offset_width_ref(dt, b67)
    acc = win[:, 1] | win[:, 2] << 8 | win[:, 3] << 16 | win[:, 4] << 24
    acc = torch.where(off_w == 1, acc & 0xFF, torch.where(off_w == 2, acc & 0xFFFF, acc))
    nbb = byte(1 + off_w)
    cw_code = nbb >> 6
    cw = torch.where(cw_code == 0, 4, 3 - cw_code)
    nb = nbb & 31
    is_lut = ((nbb & 32) > 0) & (mode == 1)
    size = DT_SIZE[dt]
    width = torch.where(mode == 0, 8 * size, nb)
    pay = torch.where(mode == 0, 1, 2 + off_w + cw)

    bitpos = torch.arange(64, device=dev)[None, :] * width[:, None]
    at = (pay[:, None] + (bitpos >> 3)).clamp(max=_WIN - 5)
    v = sum(win.gather(1, at + t) << (8 * t) for t in range(5))
    vmask = torch.where(width == 32, 0xFFFFFFFF, (1 << width) - 1)[:, None]
    q = (v >> (bitpos & 7)) & vmask
    vb, cnt = _record_lanes(valid, d, n, dev)
    if valid is not None:
        q = expand_ref(q, vb)

    ne = byte(2 + off_w) | torch.where(cw == 2, byte(3 + off_w) << 8, 0)
    stuff_bytes = (ne * nb + 7) >> 3
    length = torch.where(mode == 2, 1, torch.where(
        mode == 3, 1 + off_w, torch.where(mode == 0, 1 + size * cnt,
                                          1 + off_w + 1 + cw + stuff_bytes)))
    return SimpleNamespace(p=p, flag=flag, mode=mode, b67=b67, off_w=off_w, acc=acc, ne=ne,
                           is_lut=is_lut, width=width, q=q, vb=vb, cnt=cnt, length=length)


def _index_flags(r: SimpleNamespace, cap_nb: int, lut_unfit: bool, bad):
    """{index_ok, fits}: a record whose parsed length disagrees with the
    next index entry (int32 wrap, as the kernels), a stuffed count other
    than the block's value count, a LUT record or any record marked `bad`
    clears index_ok; a record wider than cap_nb clears fits."""
    bad = bad | ((r.mode == 1) & (r.ne != r.cnt)) | r.is_lut
    delta = ((r.p[1:] - r.p[:-1] + 2**31) % 2**32) - 2**31
    bad[:-1] |= delta != r.length[:-1]
    unfit = (((r.mode == 0) | (r.mode == 1)) & (r.width > cap_nb)) | (r.is_lut & lut_unfit)
    return torch.stack([~bad.any(), ~unfit.any()]).to(torch.int32)


def decode_records_ref(stream: torch.Tensor, starts: torch.Tensor, zmax: torch.Tensor,
                       inv: float, h: int, w: int, d: int, version: int, cap_nb: int,
                       lut_unfit: bool, valid: torch.Tensor | None = None):
    """Plain PyTorch version of K4: f64 ScaleBack as two separately rounded
    operations, invalid positions +0.0; a depth-diff record (flag bit 2 at
    version >= 5) clears index_ok."""
    r = _parse_records(stream, starts, DataType.FLOAT, d, valid)
    offset = float_offset_ref(r.acc, r.b67)
    zm = zmax.repeat(r.p.numel() // d)[:, None]
    z_stuff = (offset.double()[:, None] + r.q.double() * inv).float()
    z_stuff = torch.where(zm < z_stuff, zm, z_stuff)
    z_raw = _as_i32(r.q).view(torch.float32)
    m2 = r.mode[:, None]
    z = torch.where(m2 == 0, z_raw,
                    torch.where(m2 == 2, 0.0, torch.where(m2 == 3, offset[:, None], z_stuff)))
    img = _to_image(torch.where(r.vb, z, 0.0), h, w, d, torch.float32)
    diff = ((r.flag & 4) != 0) & (version >= 5)
    return img, _index_flags(r, cap_nb, lut_unfit, diff)


# ---------------------------------------------------------------------------
# integer K4
# ---------------------------------------------------------------------------


def decode_records_int(stream: torch.Tensor, starts: torch.Tensor, zmax: torch.Tensor,
                       inv_i: int, h: int, w: int, d: int, dt: DataType, version: int,
                       cap_nb: int, lut_unfit: bool, valid: torch.Tensor | None = None):
    """(img [H, W, D] in dt's dtype, flags [2] int32 = {index_ok, fits}).

    zmax: [D] int32 clamp values; inv_i: the integer step round(2 mze);
    otherwise as ``decode_records``."""
    n_rec = (h // 8) * (w // 8) * d
    _check_records(stream, starts, zmax, n_rec, d, torch.int32)
    vt, sfx, valid_ptr = _valid_args(valid, h, w)
    if not build.on_cuda(stream, starts, zmax, *vt):
        return decode_records_int_ref(stream, starts, zmax, inv_i, h, w, d, dt, version, cap_nb,
                                      lut_unfit, valid)
    fn = build.library("decode").decode_records_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p] + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    dev = stream.device
    name = "decode_records" + sfx + DT_SUFFIX[dt]
    with torch.cuda.device(dev):
        img = torch.empty(h, w, d, dtype=DT_TO_TORCH[dt], device=dev)
        flags = torch.ones(2, dtype=torch.int32, device=dev)
        err = fn(stream.data_ptr(), 4 * stream.numel(), starts.data_ptr(), valid_ptr,
                 zmax.data_ptr(), inv_i, h, w, d, int(dt), DT_SIZE[dt], int(dt_is_signed(dt)),
                 int(version >= 5), cap_nb, int(lut_unfit), img.data_ptr(), flags.data_ptr(),
                 build.launch_stream(stream))
        build.check(err, name)
    build.LAUNCHES[name] += 1
    return img, flags


def decode_records_int_ref(stream, starts, zmax, inv_i: int, h: int, w: int, d: int,
                           dt: DataType, version: int, cap_nb: int, lut_unfit: bool,
                           valid: torch.Tensor | None = None):
    """Plain PyTorch version of the integer K4 instances (int64 arithmetic
    wrapped to int32 where JAX computes in int32); a depth-diff record
    (flag bit 2 at version >= 5) clears index_ok."""
    r = _parse_records(stream, starts, dt, d, valid)
    off2 = int_offset_ref(r.acc, r.off_w, dt, r.b67)[:, None]
    zm = zmax.to(torch.int64).repeat(r.p.numel() // d)[:, None]
    z_stuff = torch.minimum(_i32(off2 + r.q * inv_i), zm)
    m2 = r.mode[:, None]
    z = torch.where(m2 == 0, raw_int_ref(r.q, DT_SIZE[dt], dt_is_signed(dt)),
                    torch.where(m2 == 2, 0, torch.where(m2 == 3, off2, z_stuff)))
    img = _to_image(torch.where(r.vb, z, 0), h, w, d, DT_TO_TORCH[dt])
    diff = ((r.flag & 4) != 0) & (version >= 5)
    return img, _index_flags(r, cap_nb, lut_unfit, diff)


# ---------------------------------------------------------------------------
# K4 for the mosaic: LUT records, 16x16 blocks, n units in one record axis
# ---------------------------------------------------------------------------


def decode_records_lut(stream: torch.Tensor, starts: torch.Tensor, zmax: torch.Tensor,
                       max_z_error: float, h: int, w: int, d: int, dt: DataType, version: int,
                       mb: int, n_units: int, lut: bool = True, cap_nb: int = 32,
                       valid: torch.Tensor | None = None):
    """(img [nUnits, H, W, D] in dt's dtype (float32 for FLOAT), flags
    [nUnits, 3] int32 = {index_ok, fits, scanned}) -- one launch over every
    unit's records with the depth-diff chain (kernels/decode.cu,
    ``decode_records_lut``); scanned: a diff record on slice 0 or a raw one.

    stream: [S] int32 u32 words; starts: [nUnits * nRec] int32 absolute byte
    offsets; zmax: [nUnits, D] float32, or int32 for integers (uint32 as its
    bits); lut: LUT records decode (else a LUT bit clears index_ok); cap_nb:
    widest record that fits; valid: the units' block validity words
    [nUnits * nBlocks, mb*mb/32], or None when every pixel is valid."""
    n_rec = (h // mb) * (w // mb) * d * n_units
    ztype = torch.int32 if dt_is_int(dt) else torch.float32
    if stream.dtype != torch.int32 or stream.dim() != 1 or not stream.is_contiguous():
        raise TypeError("stream must be a contiguous 1-D int32 tensor of u32 words")
    if starts.dtype != torch.int32 or starts.shape != (n_rec,) or not starts.is_contiguous():
        raise ValueError(f"starts must be a contiguous int32 [{n_rec}] tensor")
    if zmax.dtype != ztype or zmax.shape != (n_units, d) or not zmax.is_contiguous():
        raise ValueError(f"zmax must be a contiguous {ztype} [{n_units}, {d}] tensor")
    vt, sfx, valid_ptr = _valid_args(valid, n_units * h, w, mb)
    inv, inv_i = 2.0 * float(max_z_error), _inv_i(max_z_error)
    if not build.on_cuda(stream, starts, zmax, *vt):
        return decode_records_lut_ref(stream, starts, zmax, inv, inv_i, h, w, d, dt, version, mb,
                                      n_units, lut, cap_nb, valid)
    fn = build.library("decode").decode_records_lut
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 3 + [
        ctypes.c_double] + [ctypes.c_int] * 12 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    dev = stream.device
    name = "decode_records_lut" + ("16" if mb == 16 else "") + sfx + DT_SUFFIX[dt]
    with torch.cuda.device(dev):
        img = torch.empty(n_units, h, w, d, dtype=DT_TO_TORCH[dt], device=dev)
        flags = torch.tensor([[1, 1, 0]], dtype=torch.int32, device=dev).repeat(n_units, 1)
        err = fn(stream.data_ptr(), 4 * stream.numel(), starts.data_ptr(), valid_ptr,
                 zmax.data_ptr(), inv, inv_i, h, w, d, mb, n_units, int(dt), DT_SIZE[dt],
                 int(dt_is_signed(dt)), int(version >= 5), int(lut), cap_nb, img.data_ptr(),
                 flags.data_ptr(), build.launch_stream(stream))
        build.check(err, name)
    build.LAUNCHES[name] += 1
    return img, flags


def decode_records_lut_ref(stream, starts, zmax, inv: float, inv_i: int, h: int, w: int, d: int,
                           dt: DataType, version: int, mb: int, n_units: int, lut: bool,
                           cap_nb: int, valid: torch.Tensor | None = None):
    """Plain PyTorch version of the mosaic's K4 (int64 bit arithmetic; the
    f64 ScaleBack as two separately rounded operations; the depth-diff
    chain as a loop over depth, as ``decode_scanned_ref``)."""
    dev = stream.device
    bs = mb * mb
    sb = stream.view(torch.uint8).to(torch.int64)
    n_bytes = sb.numel()

    def rd(idx):  # bytes outside the stream read 0
        return torch.where((idx >= 0) & (idx < n_bytes), sb[idx.clamp(0, n_bytes - 1)], 0)

    def extract(pos, i, width):  # LSB-first values of `width` bits at byte pos, index i
        bitpos = i * width
        at, sh = pos + (bitpos >> 3), bitpos & 7
        v = sum(rd(at + t) << (8 * t) for t in range(5))
        return (v >> sh) & ((1 << width.clamp(max=32)) - 1)

    p = starts.to(torch.int64)
    n = p.numel()
    flag = rd(p)
    mode, b67 = flag & 3, flag >> 6
    dif = ((flag & 4) != 0) & (version >= 5)
    odt = torch.where(dif, int(DataType.INT), int(dt)) if dt_is_int(dt) else torch.full_like(p, int(dt))
    off_w = offset_width_ref(odt, b67)
    acc = rd(p + 1) | rd(p + 2) << 8 | rd(p + 3) << 16 | rd(p + 4) << 24
    acc = torch.where(off_w == 1, acc & 0xFF, torch.where(off_w == 2, acc & 0xFFFF, acc))
    nbb = rd(p + 1 + off_w)
    cw_code = nbb >> 6
    cw = torch.where(cw_code == 0, 4, 3 - cw_code)
    nb = nbb & 31
    is_lut = ((nbb & 32) > 0) & (mode == 1)
    n_lut = torch.where(is_lut, rd(p + 2 + off_w + cw) - 1, 0)
    nbits_lut = sum((n_lut >= (1 << k)).to(torch.int64) for k in range(8))
    lut_bytes = (n_lut * nb + 7) >> 3
    pay = torch.where(mode == 0, p + 1, p + 2 + off_w + cw + is_lut.to(torch.int64))
    size = DT_SIZE[dt]
    width = torch.where(mode == 0, 8 * size, nb)

    vb, cnt = _record_lanes(valid, d, n, dev, bs)
    rank = (vb.cumsum(1) - 1).clamp(min=0)
    q = extract(pay[:, None], rank, width[:, None])
    idx = extract((pay + lut_bytes)[:, None], rank, nbits_lut[:, None])
    q_lut = torch.where(idx == 0, 0, extract(pay[:, None], (idx - 1).clamp(min=0), nb[:, None]))
    q = torch.where(is_lut[:, None], q_lut, q)
    qs = torch.where((mode == 1)[:, None], q, 0)  # the quanta of stuffed and LUT records

    zm = zmax.to(torch.int64 if dt_is_int(dt) else torch.float32)[:, None, :].expand(
        n_units, n // (n_units * d), d).reshape(n)[:, None]
    m2 = mode[:, None]
    if dt_is_int(dt):
        off2 = int_offset_ref(acc, off_w, odt, b67)[:, None]
        a = _i32(off2 + qs * inv_i)  # the pre-clamp sum (the offset for other modes)
        if dt == DataType.UINT:  # the clamp in u32 order
            def clamp(x, zm_d):
                return torch.minimum(x & 0xFFFFFFFF, zm_d & 0xFFFFFFFF)
        else:
            def clamp(x, zm_d):
                return torch.minimum(x, zm_d)
        z = torch.where(m2 == 0, raw_int_ref(q, size, dt_is_signed(dt)),
                        torch.where(m2 == 2, 0, torch.where(m2 == 3, off2, clamp(a, zm))))

        def chain(prev, ad_d, zm_d, c0):  # decode_tiles :641-644
            return torch.where(c0, prev, clamp(_i32(ad_d + prev), zm_d))
    else:
        offset = float_offset_ref(acc, b67)[:, None]
        a = offset.double() + qs.double() * inv  # the pre-clamp f64 sum
        z_stuff = a.float()
        z_stuff = torch.where(zm < z_stuff, zm, z_stuff)
        z_raw = _as_i32(q).view(torch.float32)
        z = torch.where(m2 == 0, z_raw,
                        torch.where(m2 == 2, 0.0, torch.where(m2 == 3, offset, z_stuff)))

        def chain(prev, ad_d, zm_d, c0):  # (float)(a + (double)prev), then the clamp
            t = (ad_d + prev.double()).float()
            return torch.where(c0, prev, torch.where(zm_d < t, zm_d, t))
    z = torch.where(vb, z, 0)
    # the depth-diff chain, slice by slice (a diff record on slice 0 adds 0)
    z, ad, zmd, vbd = (t.expand(n, bs).reshape(-1, d, bs) for t in (z, a, zm, vb))
    m2d, difd = m2.reshape(-1, d, 1), dif.reshape(-1, d, 1)
    slices, prev = [], torch.zeros_like(z[:, 0])
    for di in range(d):
        zd = chain(prev, ad[:, di], zmd[:, di], m2d[:, di] == 2)
        prev = torch.where(difd[:, di], torch.where(vbd[:, di], zd, 0), z[:, di])
        slices.append(prev)
    z = torch.stack(slices, 1).reshape(n, bs)
    nbv, nbh = h // mb, w // mb
    img = (z.reshape(n_units, nbv, nbh, d, mb, mb).permute(0, 1, 4, 2, 5, 3)
           .reshape(n_units, h, w, d).to(DT_TO_TORCH[dt]).contiguous())

    ne = rd(p + 2 + off_w) | torch.where(cw == 2, rd(p + 3 + off_w) << 8, 0)
    length = torch.where(mode == 2, 1, torch.where(
        mode == 3, 1 + off_w, torch.where(mode == 0, 1 + size * cnt, torch.where(
            is_lut, 1 + off_w + 1 + cw + 1 + lut_bytes + ((ne * nbits_lut + 7) >> 3),
            1 + off_w + 1 + cw + ((ne * nb + 7) >> 3)))))
    bad = ((mode == 1) & (ne != cnt)) | (is_lut & (not lut))
    delta = ((p[1:] - p[:-1] + 2**31) % 2**32) - 2**31
    last = (torch.arange(n, device=dev) % (n // n_units)) == n // n_units - 1
    bad[:-1] |= (delta != length[:-1]) & ~last[:-1]
    unfit = ((mode == 0) | (mode == 1)) & (width > cap_nb)
    di = torch.arange(n, device=dev) % d
    scanned = dif & ((di == 0) | (mode == 0))  # the chain cannot take it: the host refuses it
    flags = torch.stack([~bad.view(n_units, -1).any(1), ~unfit.view(n_units, -1).any(1),
                         scanned.view(n_units, -1).any(1)], 1)
    return img, flags.to(torch.int32)


# ---------------------------------------------------------------------------
# K6 decode_scanned
# ---------------------------------------------------------------------------


def decode_scanned(stream: torch.Tensor, mode: torch.Tensor, payload_pos: torch.Tensor,
                   offset: torch.Tensor, num_bits: torch.Tensor, num_elements: torch.Tensor,
                   lut_pos: torch.Tensor, n_lut: torch.Tensor, nbits_lut: torch.Tensor,
                   mask, max_z_error: float, z_max_vec: torch.Tensor, h: int, w: int, d: int,
                   dt: DataType, all_valid: bool, has_lut: bool, mb: int = 8):
    """Decode from record descriptors (``decode_tiles``, device_decode.py:493,
    same arguments, with the block size `mb`). Returns (img [H, W, D] in the
    native dtype, ok 0-d bool) with no host synchronization; ok is False
    where the host decoder would refuse the stream.

    stream: [S / 4] int32 u32 words; payload_pos and lut_pos are byte
    offsets into it. offset: [nRec] float32, float64 (``decode_tiles_f64``
    :716) or int32 (integer dtypes);
    z_max_vec: [D] of the same type; the other descriptors [nRec] int32.
    mask: the [nBlocks, mb*mb/32] validity words of the [H, W] mask
    (``device_encode.block_valid_words(mask, mb)``), ignored when all_valid.
    LUT records decode whether or not has_lut is set (JAX sizes its graph
    by it)."""
    if mb not in (8, 16):
        raise NotImplementedError("micro blocks other than 8x8 and 16x16 are the host codec's: "
                                  "codec/orchestrator.decode_blob decodes such blobs")
    if d < 1:
        raise ValueError("depth must be >= 1")
    n_rec = _n_blocks(h, w, mb) * d
    ztype = torch.int32 if dt_is_int(dt) else DT_TO_TORCH[dt]
    if stream.dtype != torch.int32 or stream.dim() != 1 or not stream.is_contiguous():
        raise TypeError("stream must be a contiguous 1-D int32 tensor of u32 words")
    descs = (("mode", mode, torch.int32), ("payload_pos", payload_pos, torch.int32),
             ("offset", offset, ztype), ("num_bits", num_bits, torch.int32),
             ("num_elements", num_elements, torch.int32), ("lut_pos", lut_pos, torch.int32),
             ("n_lut", n_lut, torch.int32), ("nbits_lut", nbits_lut, torch.int32))
    for name, t, kind in descs:
        if t.dtype != kind or t.shape != (n_rec,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {kind} [{n_rec}] tensor")
    if z_max_vec.dtype != ztype or z_max_vec.shape != (d,) or not z_max_vec.is_contiguous():
        raise ValueError(f"z_max_vec must be a contiguous {ztype} [{d}] tensor")
    valid = None if all_valid else mask
    if not all_valid and mask is None:
        raise ValueError("a masked decode needs the block validity words")
    vt, sfx, valid_ptr = _valid_args(valid, h, w, mb)
    inv, inv_i = 2.0 * float(max_z_error), _inv_i(max_z_error)
    if not build.on_cuda(stream, z_max_vec, *(t for _, t, _ in descs), *vt):
        return decode_scanned_ref(stream, mode, payload_pos, offset, num_bits, num_elements,
                                  lut_pos, n_lut, nbits_lut, valid, inv, inv_i, z_max_vec, h, w,
                                  d, dt, mb)
    fn = build.library("decode").decode_scanned
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 10 + [
        ctypes.c_double] + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    dev = stream.device
    name = "decode_scanned" + ("16" if mb == 16 else "") + sfx + DT_SUFFIX[dt]
    with torch.cuda.device(dev):
        img = torch.empty(h, w, d, dtype=DT_TO_TORCH[dt], device=dev)
        ok = torch.ones(1, dtype=torch.int32, device=dev)
        err = fn(stream.data_ptr(), 4 * stream.numel(), mode.data_ptr(), payload_pos.data_ptr(),
                 offset.data_ptr(), num_bits.data_ptr(), num_elements.data_ptr(),
                 lut_pos.data_ptr(), n_lut.data_ptr(), nbits_lut.data_ptr(), valid_ptr,
                 z_max_vec.data_ptr(), inv, inv_i, h, w, d, mb, int(dt), DT_SIZE[dt],
                 int(dt_is_signed(dt)), img.data_ptr(), ok.data_ptr(), build.launch_stream(stream))
        build.check(err, name)
    build.LAUNCHES[name] += 1
    return img, ok[0] != 0


def scanned_args(words: torch.Tensor, base: int, recs: np.ndarray, valid: torch.Tensor | None,
                 head, z_max: np.ndarray) -> tuple:
    """The arguments of ``decode_scanned`` for the host scanner's descriptors
    `recs` (``tile_scan``) of a tile stream that starts at byte `base` of
    `words`, on the words' device. head: the blob's ``HeaderInfo``; valid:
    the block validity words at its micro-block size, or None for an
    all-valid band; z_max: the [D] clamp values."""
    dev = words.device

    def i32(field, add=0):
        return torch.from_numpy((recs[field] + add).astype(np.int32)).to(dev)

    if dt_is_int(head.dt):  # uint32 values of 2^31 and more as their int32 bits
        def bits(v):
            return torch.from_numpy((np.round(v).astype(np.int64) & 0xFFFFFFFF).astype(
                np.uint32).view(np.int32)).to(dev)

        offset, zmax = bits(recs["offset"]), bits(np.asarray(z_max))
    else:
        ft = np.float64 if head.dt == DataType.DOUBLE else np.float32
        offset = torch.from_numpy(recs["offset"].astype(ft)).to(dev)
        zmax = torch.from_numpy(np.asarray(z_max).astype(ft)).to(dev)
    return (words, i32("mode"), i32("payload_pos", base), offset, i32("num_bits"),
            i32("num_elements"), i32("lut_pos", base), i32("n_lut"), i32("nbits_lut"), valid,
            head.max_z_error, zmax, head.n_rows, head.n_cols, head.n_depth, head.dt, valid is None,
            bool((recs["mode"] % 8 == 4).any()), head.micro_block_size)


def decode_tiles(words: torch.Tensor, base: int, recs: np.ndarray, valid: torch.Tensor | None,
                 head, z_max: np.ndarray) -> torch.Tensor:
    """K6 over the host scanner's descriptors (``scanned_args``) ->
    [H, W, D] on the words' device. Raises ValueError where the host decoder
    refuses the stream."""
    img, ok = decode_scanned(*scanned_args(words, base, recs, valid, head, z_max))
    if not bool(ok):
        raise ValueError("corrupt Lerc2 tile stream")
    return img


def _in_image(h: int, w: int, mb: int, dev) -> torch.Tensor:
    """[nBlocks, mb*mb] bool: the block positions inside the image."""
    nbv, nbh = -(-h // mb), -(-w // mb)
    rows = torch.arange(nbv * mb, device=dev) < h
    cols = torch.arange(nbh * mb, device=dev) < w
    return (rows[:, None] & cols[None, :]).reshape(nbv, mb, nbh, mb).permute(0, 2, 1, 3).reshape(
        -1, mb * mb)


def decode_scanned_ref(stream, mode, payload_pos, offset, num_bits, num_elements, lut_pos, n_lut,
                       nbits_lut, valid, inv: float, inv_i: int, z_max_vec, h: int, w: int, d: int,
                       dt: DataType, mb: int = 8):
    """Plain PyTorch version of K6 (int64 arithmetic; f64 ScaleBack as two
    separately rounded operations; the diff chains as a loop over depth).
    valid: validity words, or None for an all-valid image."""
    dev = stream.device
    sb = stream.view(torch.uint8).to(torch.int64)
    n_bytes = sb.numel()
    bs = mb * mb

    def rd(idx):  # clamped reads, as JAX's gathers
        return sb[idx.clamp(0, n_bytes - 1)]

    def extract(pos, idx, width):  # LSB-first values of `width` bits at byte pos, index idx
        bitpos = idx * width
        at, sh = pos + (bitpos >> 3), bitpos & 7
        acc = sum(rd(at + t) << (8 * t) for t in range(4))
        hi = torch.where(sh > 0, (rd(at + 4) << (32 - sh)) & 0xFFFFFFFF, 0)
        qmask = torch.where(width >= 32, 0xFFFFFFFF, (1 << width.clamp(max=32)) - 1)
        return ((acc >> sh) | hi) & qmask

    n = mode.numel()
    in_img = _in_image(h, w, mb, dev).repeat_interleave(d, 0)
    vb = in_img if valid is None else valid_lanes(valid).repeat_interleave(d, 0) & in_img
    cnt, area = vb.sum(1, keepdim=True), in_img.sum(1, keepdim=True)
    m = mode.to(torch.int64)[:, None]
    m8, dif = m & 7, m >= 8
    ne = num_elements.to(torch.int64)[:, None]
    stuffed = (m8 == 1) | (m8 == 4)
    use_all = stuffed & (ne == area)
    eff = torch.where(use_all, in_img, vb)  # the positions a record writes
    rank = (eff.cumsum(1) - 1).clamp(min=0)
    nb = num_bits.to(torch.int64)[:, None]
    pp = payload_pos.to(torch.int64)[:, None]
    q = extract(pp, rank, nb)
    # LUT records: index i -> [0] + entries at lut_pos; every stuffed index
    # must lie in the LUT (bitstuffer.py:220)
    nbl = nbits_lut.to(torch.int64)[:, None]
    seq = torch.arange(bs, device=dev)[None, :]
    all_idx = extract(pp, seq, nbl)
    bad_lut = (m8 == 4) & ((all_idx > n_lut.to(torch.int64)[:, None]) & (seq < ne)).any(1,
                                                                                     keepdim=True)
    idx = all_idx.gather(1, rank)
    lut_q = extract(lut_pos.to(torch.int64)[:, None], (idx - 1).clamp(min=0), nb)
    q = torch.where(m8 == 4, torch.where(idx == 0, 0, lut_q), q)
    size = DT_SIZE[dt]
    word = sum(rd(pp + rank * size + t) << (8 * t) for t in range(size))
    zm = z_max_vec.repeat(n // d)[:, None]
    write = torch.where((m8 == 3) | (m8 == 0), vb, eff)
    if dt_is_int(dt):
        off = offset.to(torch.int64)[:, None]
        zm = zm.to(torch.int64)
        a = _i32(off + q * inv_i)
        z = torch.where(m8 == 0, raw_int_ref(word, size, dt_is_signed(dt)), torch.where(
            m8 == 2, 0, torch.where(m8 == 3, off, torch.minimum(a & 0xFFFFFFFF, zm & 0xFFFFFFFF)
                                    if dt == DataType.UINT else torch.minimum(a, zm))))
        ad = torch.where(m8 == 3, off, a)

        def chain(prev, ad_d, zm_d, c0):  # :641-644; uint32 clamps in u32 order
            t = _i32(ad_d + prev)
            if dt == DataType.UINT:
                return torch.where(c0, prev, torch.minimum(t & 0xFFFFFFFF, zm_d & 0xFFFFFFFF))
            return torch.where(c0, prev, torch.minimum(t, zm_d))
    elif dt == DataType.DOUBLE:
        off = offset[:, None]
        a = off + q.double() * inv  # the pre-clamp sum
        z = torch.where(m8 == 0, word.view(torch.float64), torch.where(
            m8 == 2, 0.0, torch.where(m8 == 3, off, torch.where(zm < a, zm, a))))
        ad = torch.where(m8 == 3, off, a)

        def chain(prev, ad_d, zm_d, c0):  # a + prev, then the clamp
            t = ad_d + prev
            return torch.where(c0, prev, torch.where(zm_d < t, zm_d, t))
    else:
        off = offset[:, None]
        a = off.double() + q.double() * inv  # the pre-clamp f64 sum
        zs = a.float()
        z = torch.where(m8 == 0, _as_i32(word).view(torch.float32), torch.where(
            m8 == 2, 0.0, torch.where(m8 == 3, off, torch.where(zm < zs, zm, zs))))
        ad = torch.where(m8 == 3, off.double(), a)

        def chain(prev, ad_d, zm_d, c0):  # (float)(a + (double)prev), then the clamp
            t = (ad_d + prev.double()).float()
            return torch.where(c0, prev, torch.where(zm_d < t, zm_d, t))
    z = torch.where(write, z, 0)
    if d > 1:  # the depth-diff chain, slice by slice
        z, ad, zm, write = (t.expand(n, bs).reshape(-1, d, bs) for t in (z, ad, zm, write))
        m8d, difd = m8.reshape(-1, d, 1), dif.reshape(-1, d, 1)
        slices, prev = [], torch.zeros_like(z[:, 0])
        for di in range(d):
            zd = chain(prev, ad[:, di], zm[:, di], m8d[:, di] == 2)
            prev = torch.where(difd[:, di], torch.where(write[:, di], zd, 0), z[:, di])
            slices.append(prev)
        z = torch.stack(slices, 1).reshape(n, bs)
    di = (torch.arange(n, device=dev) % d)[:, None]
    bad = ((dif & ((m8 == 0) | (di == 0))) | bad_lut
           | (stuffed & ((ne > area) | ((ne != area) & (ne < cnt)))))
    nbv, nbh = -(-h // mb), -(-w // mb)
    img = (z.reshape(nbv, nbh, d, mb, mb).permute(0, 3, 1, 4, 2)
           .reshape(nbv * mb, nbh * mb, d)[:h, :w].to(DT_TO_TORCH[dt]).contiguous())
    return img, ~bad.any()
