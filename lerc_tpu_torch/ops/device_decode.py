"""Index-driven Lerc2 tile decoding (kernel K4 ``decode_records`` and its
plain version).

Port of ``lerc_tpu/ops/device_decode.py::decode_tiles_fast`` (:64) for the
resident codec's path: float32, 8x8 micro blocks, all-valid or masked, one
tile, no LUT. Each record is parsed at its entry of the encoder's ``starts`` index;
values are extracted LSB-first and dequantized with the exact double
ScaleBack of ``_exact_f32_scale_back`` (:30): ``(float)min(zMin +
q*invScale, zMax)``, one rounding per operation, narrowed to f32 and then
clamped with std::min's pick. ``invScale`` is the f64 ``2*maxZError`` of the
header's double, as the reference decoder uses it. On Hopper this is native
f64; the TPU's softfloat modules have no port.

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
"""
from __future__ import annotations

import ctypes

import torch

from ..constants import DataType
from ..kernels import build
from .device_encode import _record_lanes, _valid_args, expand_ref
from .device_scan import _as_i32

_WIN = 264  # bytes read per record: the widest record and its 5-byte tail


def decode_tiles_fast(stream: torch.Tensor, starts: torch.Tensor, max_z_error: float,
                      z_max_vec: torch.Tensor, h: int, w: int, d: int, dt: DataType,
                      version: int, nb_cap: int = 0, mask=None, mb: int = 8,
                      n_tiles: int = 1, enable_lut: bool = False):
    """Returns (img [H, W, D] float32, index_ok 0-d bool, fits 0-d bool) on
    the stream's device, with no host synchronization.

    mask: None, or the [nBlocks, 2] int32 block validity words of the
    [H, W] mask (``device_encode.block_valid_words``) on the stream's
    device."""
    if enable_lut or mb != 8:
        raise NotImplementedError("LUT blocks and the 16x16 retrial: ROADMAP queue 1 item 6")
    if n_tiles != 1:
        raise NotImplementedError("batched tiles: ROADMAP queue 1 item 10 (mosaic)")
    if dt != DataType.FLOAT:
        raise NotImplementedError("integer dtypes: ROADMAP queue 1 item 5; float64: item 9")
    if version < 4:
        raise NotImplementedError("versions < 4: ROADMAP queue 1 item 6 (band codec)")
    if h % 8 or w % 8 or d < 1:
        raise NotImplementedError("H, W not multiples of 8: ROADMAP queue 1 item 6 (band codec)")
    cap_nb = 32 if nb_cap <= 0 else min(nb_cap, 32)
    img, flags = decode_records(stream, starts, z_max_vec, 2.0 * float(max_z_error),
                                h, w, d, cap_nb, 0 < nb_cap <= 16, mask)
    return img, flags[0] != 0, flags[1] != 0


def decode_records(stream: torch.Tensor, starts: torch.Tensor, zmax: torch.Tensor,
                   inv: float, h: int, w: int, d: int, cap_nb: int, lut_unfit: bool,
                   valid: torch.Tensor | None = None):
    """(img [H, W, D] f32, flags [2] int32 = {index_ok, fits}).

    stream: [S] int32 u32 words; starts: [nRec] int32 byte offsets; zmax:
    [D] f32 clamp values; inv: f64 invScale; cap_nb: widest record that
    fits (32: all); lut_unfit: a LUT record also clears fits; valid: block
    validity words, or None when every pixel is valid."""
    n_rec = (h // 8) * (w // 8) * d
    if stream.dtype != torch.int32 or stream.dim() != 1 or not stream.is_contiguous():
        raise TypeError("stream must be a contiguous 1-D int32 tensor of u32 words")
    if starts.dtype != torch.int32 or starts.shape != (n_rec,) or not starts.is_contiguous():
        raise ValueError(f"starts must be a contiguous int32 [{n_rec}] tensor")
    if zmax.dtype != torch.float32 or zmax.shape != (d,) or not zmax.is_contiguous():
        raise ValueError(f"zmax must be a contiguous float32 [{d}] tensor")
    vt, sfx, valid_ptr = _valid_args(valid, h, w)
    if not build.on_cuda(stream, starts, zmax, *vt):
        return decode_records_ref(stream, starts, zmax, inv, h, w, d, cap_nb, lut_unfit, valid)
    fn = build.library("decode").decode_records
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = stream.device
    with torch.cuda.device(dev):
        img = torch.empty(h, w, d, dtype=torch.float32, device=dev)
        flags = torch.ones(2, dtype=torch.int32, device=dev)
        err = fn(stream.data_ptr(), 4 * stream.numel(), starts.data_ptr(), valid_ptr,
                 zmax.data_ptr(), inv, h, w, d, cap_nb, int(lut_unfit), img.data_ptr(),
                 flags.data_ptr(), build.launch_stream(stream))
        build.check(err, "decode_records" + sfx)
    build.LAUNCHES["decode_records" + sfx] += 1
    return img, flags


def decode_records_ref(stream: torch.Tensor, starts: torch.Tensor, zmax: torch.Tensor,
                       inv: float, h: int, w: int, d: int, cap_nb: int, lut_unfit: bool,
                       valid: torch.Tensor | None = None):
    """Plain PyTorch version of K4: a byte window per record, int64 bit
    arithmetic, f64 ScaleBack as two separately rounded operations; masked
    values go back to their positions through ``expand_ref``."""
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
    off_w = torch.where(b67 == 2, 1, torch.where(b67 == 1, 2, 4))
    acc = win[:, 1] | win[:, 2] << 8 | win[:, 3] << 16 | win[:, 4] << 24
    acc = torch.where(off_w == 1, acc & 0xFF, torch.where(off_w == 2, acc & 0xFFFF, acc))
    i16 = ((acc & 0xFFFF) ^ 0x8000) - 0x8000
    offset = torch.where(b67 == 2, (acc & 0xFF).float(),
                         torch.where(b67 == 1, i16.float(), _as_i32(acc).view(torch.float32)))
    nbb = byte(1 + off_w)
    cw_code = nbb >> 6
    cw = torch.where(cw_code == 0, 4, 3 - cw_code)
    nb = nbb & 31
    is_lut = ((nbb & 32) > 0) & (mode == 1)
    width = torch.where(mode == 0, 32, nb)
    pay = torch.where(mode == 0, 1, 2 + off_w + cw)

    bitpos = torch.arange(64, device=dev)[None, :] * width[:, None]
    at = (pay[:, None] + (bitpos >> 3)).clamp(max=_WIN - 5)
    v = sum(win.gather(1, at + t) << (8 * t) for t in range(5))
    vmask = torch.where(width == 32, 0xFFFFFFFF, (1 << width) - 1)[:, None]
    q = (v >> (bitpos & 7)) & vmask
    vb, cnt = _record_lanes(valid, d, n, dev)
    if valid is not None:
        q = expand_ref(q, vb)

    zm = zmax.repeat(n // d)[:, None]
    z_stuff = (offset.double()[:, None] + q.double() * inv).float()
    z_stuff = torch.where(zm < z_stuff, zm, z_stuff)
    z_raw = _as_i32(q).view(torch.float32)
    m2 = mode[:, None]
    z = torch.where(m2 == 0, z_raw,
                    torch.where(m2 == 2, 0.0, torch.where(m2 == 3, offset[:, None], z_stuff)))
    z = torch.where(vb, z, 0.0)
    img = (z.reshape(h // 8, w // 8, d, 8, 8).permute(0, 3, 1, 4, 2)
           .reshape(h, w, d).contiguous())

    ne = byte(2 + off_w) | torch.where(cw == 2, byte(3 + off_w) << 8, 0)
    stuff_bytes = (ne * nb + 7) >> 3
    length = torch.where(mode == 2, 1, torch.where(
        mode == 3, 1 + off_w, torch.where(mode == 0, 1 + 4 * cnt, 1 + off_w + 1 + cw + stuff_bytes)))
    bad = ((mode == 1) & (ne != cnt)) | is_lut
    delta = ((p[1:] - p[:-1] + 2**31) % 2**32) - 2**31  # int32 wrap, as the kernel
    bad[:-1] |= delta != length[:-1]
    unfit = (((mode == 0) | (mode == 1)) & (width > cap_nb)) | (is_lut & lut_unfit)
    flags = torch.stack([~bad.any(), ~unfit.any()]).to(torch.int32)
    return img, flags
