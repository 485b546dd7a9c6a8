"""Device Lerc2 tile encoding (kernels K1 ``encode_blocks`` and K2
``write_records``, with their plain versions).

Port of ``lerc_tpu/ops/device_encode.py::encode_tiles`` (:486): float32
and every integer dtype, all-valid or masked, any H, W and depth, version
>= 3, 8x8 micro blocks, and for the band codec the LUT block candidate on
8x8 and 16x16 blocks; and of ``lerc_tpu/ops/device_f64.py::encode_tiles_f64``
(:95) for float64 (``encode_tiles_f64``, the end of this module: native f64
in place of JAX's double-single pairs, JAX's wire choices); and of the
mosaic's per-tile encode (``encode_tiles_batched``: a stack of tiles in one
K1/K2 launch, K1 keeping per-tile ranges). It makes the same encoder choices byte for byte:
block min/max, f32 quantization with round-half-even and the
sign-directed +-1 fixup, numBits, the mode
(const-0, const-offset, raw, bit-stuffed), the reduced offset width, the
integrity bits and the record layout. Records are numbered r = b*D + di.

Masks: the [H, W] bool mask becomes two u32 validity words per 8x8 block
(eight per 16x16 block; ``block_valid_words``), bit j = block position j in
row-major order, once per codec. The masked kernels (``encode_blocks_masked``,
``write_records_masked``) reduce over the valid lanes only, count a
block's values as popc of its words, and write value j at its rank among
the valid positions -- the stable left compaction of ``make_compactor``
(:303), whose plain version is ``compact_ref``. One mask serves every depth.

K1 reduces each block and decides its record; ``starts`` is the exclusive
scan of the record lengths (``torch.cumsum`` on the int32 lengths); K2
writes each record at byte ``starts[r]`` into a zeroed stream of u32 words
(held in an int32 tensor). One pack serves every ``nb_cap``: the cap only
decides ``fits``, as in the JAX encoder.

FMA: XLA:CPU contracts the fixup's reconstruction ``zmin + q * inv_scale``
into a fused multiply-add (device_encode.py:621,623), so K1 writes exactly
that as ``__fmaf_rn`` and the plain version emulates it (``_fmaf``). A
tie-prone test (values half a quantization step off the grid) holds both to
the JAX encoder.

K1 is a strip kernel for float32, float64 and the integer dtypes: a CTA
owns a strip of consecutive blocks of one block row with all their records
(``device_decode.strip_shape``), stages its image in shared memory and
decides a record a lane (float64: four lanes a record, a CTA of two warps;
integers at depths 1 and 3: a block a lane). The float K1s take numBits
from the block max's own quantum where that settles it, and count the
quanta in a second pass over the stage only where it does not.

Integer dtypes (:591-614, :651-653, :677-722) run their own template
instances of K1 and K2 (``encode_blocks_int``/``write_records_int``,
counted as e.g. ``encode_blocks_i16``): int32 block
minimum, f32 block maximum for the mode heuristics, lossless
``q = x - zmin`` at maxZError 0.5, the lossy f32 ``q0`` with the
sign-directed fixup against the exact integer reconstruction, offsets reduced per dtype (``_reduce_offset_int``
:79), raw records of ``1 + cnt * size`` native bytes, and the depth-diff
candidate of 8/16-bit lossless slices at version >= 5. The input is the
codec's own dtype or int32 (as JAX's ``xb.astype(int32)`` takes either).

Edge blocks (H or W not a multiple of the block size, :556-571) take the
masked instances: the validity words of the in-image area, ANDed with the
mask if there is one. The integrity bits are ``((j0 >> 3) & 15) << 2`` with
j0 the block's first column (:573-577).

The LUT candidate (``_lut_candidate_pre`` :407, ``_lut_candidate_post``
:440; BitStuffer2::EncodeLut) has instances of K1 and K2 of its own
(``encode_blocks_lut``, ``write_records_lut``; ``_lut16`` on 16x16 blocks,
``_int`` for the integer dtypes, whose input is int32): per block the
sorted distinct non-zero quantized values, n_lut of them, each value's
index = the number of distinct non-zero values <= it (0 for 0), and the
record ``[n_lut + 1][LUT at numBits][indices at bitlen(n_lut)]``, taken when
``max_q > 0``, ``1 <= n_lut < 255`` and it is shorter than the plain
stuffed record (:662-671), also inside the integer depth-diff candidate
(:691-698). K1 counts the distinct values without sorting (a set in shared
memory), and only where the LUT record can be the shorter one
(``lut_possible``: its length grows with n_lut, so a block where the LUT
loses at n_lut = 1, or whose max_q is 0, or which is const-0 or forced raw,
takes no count); the plain version counts exactly there too. K2 writes a
LUT record from the set of its distinct values, with no sort either. Both
read no validity words for an aligned all-valid image. A 16x16 block holds 256
values; its count takes two bytes only at 256 values (``cw``, :561).
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..constants import DT_SIZE, DT_SUFFIX, DT_TO_TORCH, ENC_MAX_NB, DataType, dt_is_int
from ..kernels import build
from .device_scan import _as_i32, _i32

RAW_LEN = 1 + 64 * 4  # flag + 64 raw f32 values
_REC_BYTES = 264       # widest record (257 B) rounded up to whole words
_I32_MAX, _I32_MIN = 2**31 - 1, -(2**31)


@dataclasses.dataclass(frozen=True)
class EncodeParams:
    """Scalars of one encoder configuration, computed on the host once."""

    mze: float         # maxZError as f32
    scale: float       # f32 1 / (2 * mze), 0 when mze == 0
    inv: float         # f32 2 * mze
    integ_mask: int    # integrity bits kept in the flag byte (version >= 5: bits 3-5)
    cap_nb: int        # widest bit-stuffed record that fits (32: no cap)
    raw_ok: bool       # raw records fit under the cap
    dt: DataType = DataType.FLOAT
    inv_i: int = 0          # integers: round(2 * mze), the exact reconstruction step
    lossless: bool = False  # integers at maxZError 0.5: q = x - zmin
    diff_ok: bool = False   # depth-diff candidates (v >= 5, 8/16-bit integers)
    maxq_cap: float = 1073741823.0  # widest quantized range before raw (:516)


def encode_params(max_z_error: float, version: int, nb_cap: int = 0,
                  dt: DataType = DataType.FLOAT, mb: int = 8) -> EncodeParams:
    """The f32 scalars exactly as the JAX encoder derives them
    (device_encode.py:551-554, :606) and the nb_cap window arithmetic
    (:514-546) that decides `fits`, for dtype `dt`."""
    mze = np.float32(max_z_error)
    if not mze >= 0:
        raise ValueError(f"max_z_error must be >= 0, got {max_z_error}")
    inv = np.float32(2.0) * mze
    scale = np.float32(1.0) / inv if mze > 0 else np.float32(0.0)
    size = DT_SIZE[dt]
    max_nb = ENC_MAX_NB[size]
    eff_cap = max_nb if nb_cap <= 0 else min(nb_cap, max_nb)
    always_fits = eff_cap >= max_nb
    bs = mb * mb
    pw = (bs * eff_cap + 31) // 32 + 1
    stuff_w = max((8 + 4 * (pw - 1) + 3) // 4, pw + 3) + 1
    raw_w = (1 + bs * size + 3) // 4
    is_int = dt_is_int(dt)
    return EncodeParams(
        mze=float(mze), scale=float(scale), inv=float(inv),
        integ_mask=0b111000 if version >= 5 else 0b111100,
        cap_nb=32 if always_fits else eff_cap,
        raw_ok=always_fits or raw_w <= stuff_w,
        dt=dt, inv_i=int(np.round(inv)) if is_int else 0,
        lossless=bool(is_int and mze == 0.5),
        diff_ok=is_int and version >= 5 and size <= 2,
        maxq_cap=float((1 << 15) - 1) if size <= 2 else 1073741823.0,
    )


def encode_tiles(data: torch.Tensor, mask, max_z_error: float, h: int, w: int, d: int,
                 dt: DataType, all_valid: bool, version: int, cap: int,
                 enable_lut: bool = False, mb: int = 8, nb_cap: int = 0):
    """Returns (stream [cap/4] int32 u32 words, total 0-d int32, z_min [D],
    z_max [D], starts [nRec] int32, fits 0-d bool), all on data's device,
    with no host synchronization. z_min/z_max are f32 for float32 data and
    int32 for the integer dtypes (as JAX's); for uint32 they are the bits of
    the unsigned range (``range_values`` reads them; JAX's are in signed
    order).

    data: [H, W, D] float32, or for an integer `dt` that dtype or int32.
    mask: the block validity words of the [H, W] mask
    (``block_valid_words(mask, mb)``), on data's device; ignored when
    all_valid. enable_lut adds the LUT candidate; mb is 8, or 16 with it.
    float64 data goes to ``encode_tiles_f64`` (8x8 blocks; no LUT candidate,
    as JAX's); its z_min/z_max are float64."""
    if version < 3:
        raise NotImplementedError(
            "versions < 3 (legacy bit order) are the host codec's: codec/lerc2_encode.BandEncoder "
            "writes them")
    if mb not in (8, 16) or (mb == 16 and not enable_lut):
        raise NotImplementedError(
            "micro blocks other than 8x8, or 16x16 without the LUT candidate, are the host "
            "codec's: codec/lerc2_encode.BandEncoder writes them")
    if d < 1:
        raise ValueError("depth must be >= 1")
    if cap % 4:
        raise ValueError("cap must be a multiple of 4")
    if dt == DataType.DOUBLE:  # 8x8 blocks, no LUT candidate, as JAX's: fits always
        if mb != 8 or nb_cap:
            raise ValueError("float64 blocks are 8x8, with no bit cap")
        out = encode_tiles_f64(data, mask, max_z_error, h, w, d, all_valid, version, cap)
        return *out, torch.ones((), dtype=torch.bool, device=data.device)
    _check_data(data, h, w, d, dt)
    if not all_valid and mask is None:
        raise ValueError("a masked encode needs the block validity words")
    valid = None if all_valid else mask
    if valid is None and (h % mb or w % mb):  # edge blocks read the in-image area's words
        valid = block_valid_words(torch.ones(h, w, dtype=torch.bool, device=data.device), mb)
    if enable_lut and dt_is_int(dt):
        data = data.to(torch.int32)
    p = encode_params(max_z_error, version, nb_cap, dt, mb)
    rec_info, zrange, fits = encode_blocks(data, p, valid, mb, enable_lut)
    length = rec_info[:, 0]
    starts = torch.cumsum(length, 0, dtype=torch.int32) - length
    total = starts[-1] + length[-1]
    stream = write_records(data, rec_info, starts, cap // 4, p, valid, mb, enable_lut)
    return stream, total, zrange[:d], zrange[d:], starts, fits[0] != 0


def encode_tiles_batched(tiles: torch.Tensor, masks: torch.Tensor, max_z_error: float,
                         dt: DataType, version: int, mb: int = 8, all_valid: bool = False):
    """The tile-batched encode (``_encode_tiles_sharded``'s ``vmap(encode_one)``,
    lerc_tpu/parallel/sharding.py:79-125, one micro-block size; and
    ``_encode_tiles_f64_sharded`` :137-163): every tile of a [T, tileH,
    tileW, D] stack with its [T, tileH, tileW] bool masks, as
    ``encode_tiles(..., all_valid=False, enable_lut=True, mb=mb)`` encodes
    each alone (float64: ``encode_tiles_f64``, 8x8, no LUT candidate).

    Each tile is padded to whole blocks (the padding invalid), and the stack
    is encoded as one image of T * tileH' rows: its blocks, hence its
    records, come tile after tile. One K1 launch decides every record and
    the per-tile ranges (tile_rec), one ``torch.cumsum`` gives the record
    starts, one K2 launch writes the tiles' record streams back to back.
    Returns, on the stack's device with no host synchronization: (stream
    [S/4] int32 u32 words, bases [T] int32 (each tile's first byte), totals
    [T] int32, starts [T, nRec] int32 relative to each tile's first byte,
    z_min [T, D], z_max [T, D] (float32, int32, int64 in unsigned order for
    uint32, or float64, over each tile's valid values; the type's max and
    min for a tile with none), fits [1] int32). The stream stays under 2^31 bytes: the
    caller splits larger stacks. all_valid: the caller's word that every
    mask is all set; with tiles of whole blocks the LUT K1 and K2 then read
    no validity words."""
    if version < 3:
        raise NotImplementedError(
            "versions < 3 (legacy bit order) are the host codec's: codec/lerc2_encode.BandEncoder "
            "writes them")
    f64 = dt == DataType.DOUBLE
    if mb not in (8, 16) or (f64 and mb != 8):
        raise ValueError("blocks are 8x8, or 16x16 (not float64)")
    n_t, th, tw, d = tiles.shape
    if masks.dtype != torch.bool or tuple(masks.shape) != (n_t, th, tw):
        raise ValueError(f"masks must be bool [{n_t}, {th}, {tw}]")
    hp, wp = -(-th // mb) * mb, -(-tw // mb) * mb
    if (hp, wp) != (th, tw):  # whole blocks; the padding is invalid
        tiles = torch.nn.functional.pad(tiles, (0, 0, 0, wp - tw, 0, hp - th))
        masks = torch.nn.functional.pad(masks, (0, wp - tw, 0, hp - th))
    size = DT_SIZE[dt]
    tile_rec = (hp // mb) * (wp // mb) * d
    rec_bound = 1 + mb * mb * size  # a raw record; every record taken is no longer
    cap = n_t * tile_rec * rec_bound
    if cap >= 2**31:
        raise ValueError("a tile batch of 2^31 stream bytes or more: split the stack")
    kind = torch.float64 if f64 else torch.int32 if dt_is_int(dt) else torch.float32
    data = tiles.to(kind).reshape(n_t * hp, wp, d).contiguous()
    valid = block_valid_words(masks.reshape(n_t * hp, wp), mb)
    if f64:
        p = encode_params_f64(max_z_error, version)
        rec_info, zrange = encode_blocks_f64(data, p, valid, tile_rec)
        fits = torch.ones(1, dtype=torch.int32, device=data.device)
    else:
        p = encode_params(max_z_error, version, 0, dt, mb)
        if all_valid and (hp, wp) == (th, tw):  # K1 and K2 then read no validity words
            valid = None
        rec_info, zrange, fits = encode_blocks(data, p, valid, mb, True, tile_rec)
    length = rec_info[:, 0]
    starts = torch.cumsum(length, 0, dtype=torch.int32) - length
    cap_w = -(-cap // 4)
    if f64:
        stream = write_records_f64(data, rec_info, starts, cap_w, p, valid)
    else:
        stream = write_records(data, rec_info, starts, cap_w, p, valid, mb, True)
    starts = starts.view(n_t, tile_rec)
    bases = starts[:, 0].contiguous()
    totals = length.view(n_t, tile_rec).sum(1, dtype=torch.int32)
    zr = range_values(zrange, dt).view(n_t, 2, d)
    zmin, zmax = zr[:, 0], zr[:, 1]
    return (stream, bases, totals, (starts - bases[:, None]).contiguous(), zmin, zmax, fits)


def range_values(z: torch.Tensor, dt: DataType) -> torch.Tensor:
    """K1's ranges as values: uint32's int32 bits as int64, else as they are."""
    return z.to(torch.int64) & 0xFFFFFFFF if dt == DataType.UINT else z


def _check_data(data, h, w, d, dt=DataType.FLOAT):
    kinds = (torch.float32,) if dt == DataType.FLOAT else tuple(dict.fromkeys((DT_TO_TORCH[dt], torch.int32)))
    if data.dtype not in kinds or tuple(data.shape) != (h, w, d):
        want = " or ".join(str(k).removeprefix("torch.") for k in kinds)
        raise ValueError(f"data must be {want} [{h}, {w}, {d}], got {data.dtype} {tuple(data.shape)}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")


def _n_blocks(h: int, w: int, mb: int = 8) -> int:
    return -(-h // mb) * -(-w // mb)


def _n_rec(data, mb: int = 8) -> int:
    h, w, d = data.shape
    return _n_blocks(h, w, mb) * d


# ---------------------------------------------------------------------------
# block validity words and the plain rank routing
# ---------------------------------------------------------------------------


def block_valid_words(mask: torch.Tensor, mb: int = 8) -> torch.Tensor:
    """[H, W] bool mask -> [nBlocks, mb*mb/32] int32 u32 validity words on
    the mask's device: bit j of word k is position 32k + j of the mb x mb
    block in row-major order (the order of ``_blocks`` and the kernels'
    lanes); positions past the image's edge are 0. Built once per codec;
    the kernels read these 8 B per 8x8 block instead of 64 B of bools."""
    if mask.dtype != torch.bool or mask.dim() != 2:
        raise ValueError(f"mask must be bool [H, W], got {mask.dtype} {tuple(mask.shape)}")
    h, w = mask.shape
    nbv, nbh = -(-h // mb), -(-w // mb)
    if h % mb or w % mb:
        mask = torch.nn.functional.pad(mask, (0, nbh * mb - w, 0, nbv * mb - h))
    vb = (mask.reshape(nbv, mb, nbh, mb).permute(0, 2, 1, 3)
          .reshape(-1, mb * mb // 32, 32).to(torch.int64))
    words = (vb << torch.arange(32, device=mask.device)).sum(2)
    return _as_i32(words).contiguous()


def valid_lanes(valid: torch.Tensor) -> torch.Tensor:
    """[nBlocks, k] validity words -> [nBlocks, 32k] bool, position order."""
    bits = (valid.to(torch.int64)[:, :, None] >> torch.arange(32, device=valid.device)) & 1
    return bits.reshape(valid.shape[0], -1) != 0


def _check_valid(valid: torch.Tensor, n_blocks: int, mb: int = 8) -> None:
    shape = (n_blocks, mb * mb // 32)
    if valid.dtype != torch.int32 or tuple(valid.shape) != shape or not valid.is_contiguous():
        raise ValueError(f"validity words must be a contiguous int32 {list(shape)} tensor")


def _record_lanes(valid, d: int, n_rec: int, dev, bs: int = 64):
    """Per-record validity [nRec, bs] bool (record r = b*D + di takes block
    b's lanes) and value count [nRec] int64; all lanes when valid is None."""
    if valid is None:
        return (torch.ones(n_rec, bs, dtype=torch.bool, device=dev),
                torch.full((n_rec,), bs, dtype=torch.int64, device=dev))
    vb = valid_lanes(valid).repeat_interleave(d, 0)
    return vb, vb.sum(1)


def compact_ref(vals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Stable left compaction of each row (``make_compactor``,
    device_encode.py:303): the value at valid position j moves to slot
    rank(j) = number of valid positions before j; the other slots are 0."""
    rank = (valid.cumsum(1) - 1).clamp(min=0)
    return torch.zeros_like(vals).scatter_add_(1, rank, torch.where(valid, vals, 0))


def expand_ref(vals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The inverse (``make_expander``, device_encode.py:357): valid position
    j takes the value of slot rank(j); invalid positions are 0."""
    rank = (valid.cumsum(1) - 1).clamp(min=0)
    return torch.where(valid, vals.gather(1, rank), 0)


# ---------------------------------------------------------------------------
# K1 encode_blocks
# ---------------------------------------------------------------------------


def _valid_args(valid, h: int, w: int, mb: int = 8):
    """(the validity tensor as a tuple, to share the other inputs' device;
    the kernel's name suffix; the validity pointer) for an all-valid (None)
    or masked launch."""
    if valid is None:
        return (), "", None
    _check_valid(valid, _n_blocks(h, w, mb), mb)
    return (valid,), "_masked", valid.data_ptr()


def _lut_args(data, p: EncodeParams, valid, mb: int, lut: bool):
    """Checks the block size and the LUT flag against the inputs; the LUT
    instances' kernel name (``..._lut``/``_lut16``, ``_int`` for integers).
    They take no validity words for an aligned all-valid image."""
    if mb not in (8, 16) or (mb == 16 and not lut):
        raise ValueError("blocks are 8x8, or 16x16 with the LUT candidate")
    if not lut:
        return None
    h, w, _ = data.shape
    if valid is None and (h % mb or w % mb):
        raise ValueError("the LUT instances read validity words where the image ends inside "
                         "its blocks (all set for an all-valid image)")
    if dt_is_int(p.dt) and data.dtype != torch.int32:
        raise ValueError("the integer LUT instances take int32 data")
    return ("_lut16" if mb == 16 else "_lut") + ("_int" if dt_is_int(p.dt) else "")


def encode_blocks(data: torch.Tensor, p: EncodeParams, valid: torch.Tensor | None = None,
                  mb: int = 8, lut: bool = False, tile_rec: int = 0):
    """Per-record decisions: (rec_info [nRec, 4] int32 = {length, desc,
    offset word, zq}, desc = flag | mode<<8 | diff<<10 | lut<<11 |
    numBits<<16 | offset width<<24; zrange [2D] = per-depth min then max
    over the valid values, f32 or int32; fits [1] int32). valid: block
    validity words, or None when every pixel of an aligned image is valid.

    tile_rec > 0 (the LUT instances): data is a stack of tiles of tile_rec
    records each, and zrange is [nTiles * 2D], each tile's ranges in turn
    (counted as ``encode_tiles_lut...``).

    Launches encode_blocks_float_kernel<float> (the float32 strips; an
    all-valid image must be aligned to 8x8 blocks, else the launch is
    refused), encode_blocks_int_kernel (the integer strips) or, with
    `lut`, encode_blocks_lut_kernel."""
    h, w, d = data.shape
    lut_sfx = _lut_args(data, p, valid, mb, lut)
    vt, sfx, valid_ptr = _valid_args(valid, h, w, mb)
    _check_tile_rec(tile_rec, _n_rec(data, mb), d, lut)
    if not build.on_cuda(data, *vt):
        return encode_blocks_ref(data, p, valid, mb, lut, tile_rec)
    if lut:
        name = ("encode_tiles" if tile_rec else "encode_blocks") + lut_sfx
        return _encode_blocks_lut(data, p, valid_ptr, mb, name, tile_rec)
    if dt_is_int(p.dt):
        return _encode_blocks_int(data, p, valid_ptr, sfx)
    fn = build.library("encode").encode_blocks
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(data.device):
        rec_info, zrange, fits = _k1_outputs(data, p, mb)
        err = fn(data.data_ptr(), valid_ptr, h, w, d, p.mze, p.scale, p.inv,
                 p.integ_mask, p.cap_nb, int(p.raw_ok), rec_info.data_ptr(),
                 zrange.data_ptr(), fits.data_ptr(), build.launch_stream(data))
        build.check(err, "encode_blocks" + sfx)
    build.LAUNCHES["encode_blocks" + sfx] += 1
    return rec_info, zrange, fits


def _check_tile_rec(tile_rec: int, n_rec: int, d: int, lut: bool = True) -> None:
    if tile_rec and (not lut or tile_rec < 0 or tile_rec % d or n_rec % tile_rec):
        raise ValueError("tile_rec: the LUT or float64 instances, a whole number of tiles of "
                         "whole blocks")


def _k1_outputs(data, p: EncodeParams, mb: int, tile_rec: int = 0):
    """K1's outputs: rec_info, the range set to (+max, -max) of its type
    (per tile of tile_rec records), fits set to 1."""
    dev, d = data.device, data.shape[2]
    n_rec = _n_rec(data, mb)
    n = (n_rec // tile_rec if tile_rec else 1) * d
    if p.dt == DataType.UINT:  # unsigned order: 2^32 - 1 and 0 as int32 bits
        lo, hi, kind = -1, 0, torch.int32
    elif dt_is_int(p.dt):
        lo, hi, kind = _I32_MAX, _I32_MIN, torch.int32
    else:
        lo, hi, kind = float("inf"), float("-inf"), torch.float32
    zrange = torch.tensor([lo, hi], dtype=kind, device=dev).repeat_interleave(d).repeat(n // d)
    return (torch.empty(n_rec, 4, dtype=torch.int32, device=dev), zrange,
            torch.ones(1, dtype=torch.int32, device=dev))


def _encode_blocks_lut(data, p: EncodeParams, valid_ptr, mb: int, name: str, tile_rec: int = 0):
    """Launch a LUT instance of K1 (float32 or int32 data)."""
    h, w, d = data.shape
    fn = build.library("encode").encode_blocks_lut
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    with torch.cuda.device(data.device):
        rec_info, zrange, fits = _k1_outputs(data, p, mb, tile_rec)
        err = fn(data.data_ptr(), int(dt_is_int(p.dt)), valid_ptr, h, w, d, mb, int(p.dt),
                 DT_SIZE[p.dt], p.mze, p.scale, p.inv, p.inv_i, int(p.lossless), p.maxq_cap,
                 p.integ_mask, p.cap_nb, int(p.raw_ok), int(p.diff_ok and d > 1), tile_rec,
                 rec_info.data_ptr(), zrange.data_ptr(), fits.data_ptr(),
                 build.launch_stream(data))
        build.check(err, name)
    build.LAUNCHES[name] += 1
    return rec_info, zrange, fits


def _in_type(data: torch.Tensor) -> int:
    """The integer kernels' input element code (the DataType of the dtype)."""
    for dt, t in DT_TO_TORCH.items():
        if data.dtype == t and dt_is_int(dt):
            return int(dt)
    raise ValueError(f"no integer kernel takes {data.dtype}")


def _encode_blocks_int(data, p: EncodeParams, valid_ptr, sfx: str):
    """Launch the integer K1 instance; zrange is [2D] int32."""
    h, w, d = data.shape
    fn = build.library("encode").encode_blocks_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    name = "encode_blocks" + sfx + DT_SUFFIX[p.dt]
    with torch.cuda.device(data.device):
        rec_info, zrange, fits = _k1_outputs(data, p, 8)
        err = fn(data.data_ptr(), _in_type(data), valid_ptr, h, w, d, int(p.dt),
                 DT_SIZE[p.dt], p.mze, p.scale, p.inv_i, int(p.lossless), p.maxq_cap,
                 p.integ_mask, p.cap_nb, int(p.raw_ok), int(p.diff_ok and d > 1),
                 rec_info.data_ptr(), zrange.data_ptr(), fits.data_ptr(), build.launch_stream(data))
        build.check(err, name)
    build.LAUNCHES[name] += 1
    return rec_info, zrange, fits


def _blocks(data: torch.Tensor, mb: int = 8) -> torch.Tensor:
    """[H, W, D] -> [nRec, mb*mb], record r = b*D + di, row-major in the
    block; positions past the image's edge are 0."""
    h, w, d = data.shape
    nbv, nbh = -(-h // mb), -(-w // mb)
    if h % mb or w % mb:
        data = torch.nn.functional.pad(data, (0, 0, 0, nbh * mb - w, 0, nbv * mb - h))
    return (data.reshape(nbv, mb, nbh, mb, d).permute(0, 2, 4, 1, 3)
            .reshape(-1, mb * mb).contiguous())


def _fmaf(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 fused multiply-add a*b + c without an FMA
    instruction: the f64 product of two f32 values is exact; the f64 sum is
    made round-to-odd (TwoSum error term, then a one-ulp step toward it when
    the sum is inexact and its last bit is even), and round-to-odd in 53
    bits followed by one rounding to 24 bits is the correctly rounded
    result. Plain f64 rounding twice would be wrong exactly when the f64
    sum lands on an f32 rounding midpoint."""
    prod = a.double() * b.double()
    cd = c.double()
    s = prod + cd
    bv = s - prod
    err = (prod - (s - bv)) + (cd - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def quantize_ref(x: torch.Tensor, zmin: torch.Tensor, p: EncodeParams) -> torch.Tensor:
    """int64 quantized values of f32 x against per-row zmin [n, 1]
    (device_encode.py:617-625)."""
    f32 = dict(dtype=torch.float32, device=x.device)
    scale, inv = torch.tensor(p.scale, **f32), torch.tensor(p.inv, **f32)
    q0 = torch.round((x - zmin) * scale)
    resid = x - _fmaf(q0, inv, zmin)
    qc = torch.clamp_min(q0 + torch.sign(resid), 0.0)
    errc = (x - _fmaf(qc, inv, zmin)).abs()
    best = torch.where(errc < resid.abs(), qc, q0)
    return best.clamp(0.0, 2.0**31).to(torch.int64)


def _integ_bits(n: int, d: int, w: int, mb: int, p: EncodeParams, dev) -> torch.Tensor:
    """Integrity bits of each record's flag: ((j0 >> 3) & 15) << 2, j0 the
    block's first column (device_encode.py:573-577)."""
    b = torch.arange(n, device=dev) // d
    j0 = (b % -(-w // mb)) * mb
    return (((j0 >> 3) & 15) << 2) & p.integ_mask


def _first_nonzero(srt: torch.Tensor) -> torch.Tensor:
    """[n, bs] rows sorted ascending -> the first element of each run of
    equal non-zero values."""
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    return first & (srt > 0)


def lut_possible(nb, cnt):
    """Whether a LUT record of nb-bit entries over cnt values can be
    shorter than the stuffed record for some n_lut >= 1: lut_len <
    stuff_len at n_lut = 1, where it is weakest (both of the LUT's terms
    grow with n_lut; the header bytes cancel). Elementwise on tensors or
    numpy arrays."""
    return 1 + (nb + 7) // 8 + (cnt + 7) // 8 < (cnt * nb + 7) // 8


def _lut_candidate_ref(q, cnt, nb, max_q, off_w, cw, stuff_len, skip):
    """The LUT record against the stuffed one (device_encode.py:662-671):
    q [n, bs] position-space quantized values, 0 where invalid. n_lut (the
    distinct non-zero values) is counted only for the rows K1 counts: not
    where `skip` (const-0, forced raw, no diff taken), max_q is 0 or the
    LUT cannot win (lut_possible); elsewhere the LUT is not taken. Returns
    (the shorter length, LUT taken)."""
    need = ~skip & (max_q > 0) & lut_possible(nb, cnt)
    n_lut = torch.zeros_like(max_q)
    if bool(need.any()):
        n_lut[need] = _first_nonzero(q[need].sort(1).values).sum(1)
    lut_len = 2 + cw + off_w + 1 + (n_lut * nb + 7) // 8 + (cnt * _bit_len(n_lut) + 7) // 8
    use = need & (n_lut >= 1) & (n_lut < 255) & (lut_len < stuff_len)
    return torch.where(use, lut_len, stuff_len), use


def _tile_ranges(lo: torch.Tensor, hi: torch.Tensor, d: int, tile_rec: int) -> torch.Tensor:
    """Per-record range contributions [nRec] -> per-depth min then max, per
    tile of tile_rec records ([nTiles * 2D]; one tile when tile_rec is 0)."""
    n_tiles = lo.numel() // tile_rec if tile_rec else 1
    return torch.cat([lo.view(n_tiles, -1, d).amin(1), hi.view(n_tiles, -1, d).amax(1)],
                     1).reshape(-1)


def encode_blocks_ref(data: torch.Tensor, p: EncodeParams, valid: torch.Tensor | None = None,
                      mb: int = 8, lut: bool = False, tile_rec: int = 0):
    """Plain PyTorch version of K1 (int64 bit arithmetic)."""
    if dt_is_int(p.dt):
        return encode_blocks_int_ref(data, p, valid, mb, lut, tile_rec)
    h, w, d = data.shape
    x = _blocks(data, mb)
    n = x.shape[0]
    dev = x.device
    vb, cnt = _record_lanes(valid, d, n, dev, mb * mb)
    has = cnt > 0
    zmin = torch.where(has, torch.where(vb, x, float("inf")).amin(1), 0.0)
    zmax = torch.where(has, torch.where(vb, x, float("-inf")).amax(1), 0.0)
    q = torch.where(vb, quantize_ref(x, zmin[:, None], p), 0)
    max_q = q.amax(1)
    nb = _bit_len(max_q)
    max_val = (zmax - zmin) * torch.tensor(p.scale, dtype=torch.float32, device=dev)
    const0 = (zmin == 0) & (zmax == 0)
    # maxZError 0 stores every non-constant block raw; otherwise blocks whose
    # quantized range passes 2^30 - 1 (f32: 2^30) do
    force_raw = (zmax > zmin) if p.mze == 0 else (max_val > 1073741823.0)
    is_int = (zmin == torch.round(zmin)) & (zmin.abs() < 2.0**31)
    tc = torch.where(is_int & (zmin >= 0) & (zmin <= 255), 2,
                     torch.where(is_int & (zmin >= -32768) & (zmin <= 32767), 1, 0))
    off_w = torch.where(tc == 2, 1, torch.where(tc == 1, 2, 4))
    as_i = torch.where(tc > 0, torch.round(zmin), 0.0).to(torch.int64)
    zbits = zmin.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    off_word = torch.where(tc == 2, as_i & 0xFF, torch.where(tc == 1, as_i & 0xFFFF, zbits))
    cw = torch.where(cnt < 256, 1, 2)  # count byte width (2 only for a full 16x16 block)
    stuff_len = 1 + off_w + torch.where(max_q > 0, 1 + cw + (cnt * nb + 7) // 8, 0)
    raw_len = 1 + 4 * cnt
    use_lut = torch.zeros_like(has)
    if lut:
        stuff_len, use_lut = _lut_candidate_ref(q, cnt, nb, max_q, off_w, cw, stuff_len,
                                                const0 | force_raw)
    use_stuff = ~force_raw & (stuff_len < raw_len)
    mode = torch.where(const0, 2, torch.where(use_stuff, torch.where(max_q > 0, 1, 3), 0))
    length = torch.where(mode == 2, 1, torch.where(mode == 0, raw_len, stuff_len))
    flag = _integ_bits(n, d, w, mb, p, dev) | mode | torch.where((mode == 1) | (mode == 3),
                                                                  tc << 6, 0)
    lut_bit = (use_lut & (mode == 1)).to(torch.int64)
    desc = flag | (mode << 8) | (lut_bit << 11) | (nb << 16) | (off_w << 24)
    rec_info = torch.stack([length, desc, _as_i32(off_word).to(torch.int64),
                            zmin.view(torch.int32).to(torch.int64)], 1).to(torch.int32)
    # blocks without a valid value take no part in the per-depth range
    zrange = _tile_ranges(torch.where(has, zmin, float("inf")),
                          torch.where(has, zmax, float("-inf")), d, tile_rec)
    bad = ((mode == 1) & (nb > p.cap_nb)) | ((mode == 0) & (not p.raw_ok))
    fits = (~bad.any()).to(torch.int32).reshape(1)
    return rec_info, zrange, fits


def _wrap_abs(x: torch.Tensor) -> torch.Tensor:
    """|x| in int32 (|-2^31| stays -2^31, as jnp.abs)."""
    return _i32(torch.where(x < 0, -x, x))


def _bit_len(v: torch.Tensor) -> torch.Tensor:
    return (v[:, None] >= (1 << torch.arange(32, device=v.device))).sum(1)


def reduce_offset_int_ref(z: torch.Tensor, dt: DataType):
    """(tc, byte width) of integer block offsets (``_reduce_offset_int``,
    device_encode.py:79; Lerc2.h:457-492)."""
    fb, fc = (z >= 0) & (z <= 255), (z >= -128) & (z <= 127)
    fs, fu = (z >= -32768) & (z <= 32767), (z >= 0) & (z <= 65535)
    zero = torch.zeros_like(z)
    if dt in (DataType.CHAR, DataType.BYTE):
        return zero, zero + 1
    if dt == DataType.SHORT:
        tc = torch.where(fc, 2, torch.where(fb, 1, 0))
        return tc, torch.where(tc > 0, 1, 2)
    if dt == DataType.USHORT:
        tc = torch.where(fb, 1, 0)
        return tc, torch.where(tc > 0, 1, 2)
    if dt == DataType.INT:
        tc = torch.where(fb, 3, torch.where(fs, 2, torch.where(fu, 1, 0)))
        return tc, torch.where(tc == 3, 1, torch.where(tc > 0, 2, 4))
    tc = torch.where(fb, 2, torch.where(fu, 1, 0))  # UINT
    return tc, torch.where(tc == 2, 1, torch.where(tc == 1, 2, 4))


def _low_bytes(v: torch.Tensor, nbytes) -> torch.Tensor:
    """The low `nbytes` (1, 2 or 4; per element or scalar) of int64 v."""
    nbytes = torch.as_tensor(nbytes, device=v.device)
    return v & ((1 << (8 * nbytes)) - 1)


def quantize_int_ref(xi: torch.Tensor, zmin: torch.Tensor, p: EncodeParams) -> torch.Tensor:
    """Quantized integer values (u32 in int64) of int32 values xi against
    per-row zmin [n, 1] (device_encode.py:601-613), int32 wrapping."""
    dx = _i32(xi - zmin)
    if p.lossless:
        return dx & 0xFFFFFFFF
    scale = torch.tensor(p.scale, dtype=torch.float32, device=xi.device)
    q0 = torch.round(dx.to(torch.float32) * scale).double().clamp(_I32_MIN, _I32_MAX).to(torch.int64)
    resid = _i32(xi - _i32(zmin + q0 * p.inv_i))
    qc = torch.clamp_min(_i32(q0 + torch.sign(resid)), 0)
    errc = _wrap_abs(_i32(xi - _i32(zmin + qc * p.inv_i)))
    return torch.where(errc < _wrap_abs(resid), qc, q0) & 0xFFFFFFFF


def _prev_slice(v: torch.Tensor, d: int) -> torch.Tensor:
    """Rows of record r - 1 (slice di-1 of the same block for di > 0)."""
    return v[(torch.arange(v.shape[0], device=v.device) - 1).clamp(min=0)] if d > 1 else v


def encode_blocks_int_ref(data: torch.Tensor, p: EncodeParams, valid: torch.Tensor | None = None,
                          mb: int = 8, lut: bool = False, tile_rec: int = 0):
    """Plain PyTorch version of the integer K1 instances (int64 arithmetic
    wrapped to int32 where JAX computes in int32); zrange is [2D] int32
    (uint32: its bits, in unsigned order)."""
    h, w, d = data.shape
    x = _blocks(data, mb)
    n = x.shape[0]
    dev = x.device
    xi = _i32(x.to(torch.int64))
    # the order and f32 value of a value: uint32 unsigned, else int32
    uns = p.dt == DataType.UINT
    key = xi & 0xFFFFFFFF if uns else xi
    kmax, kmin = (2**32 - 1, 0) if uns else (_I32_MAX, _I32_MIN)
    xf = key.to(torch.float32)
    vb, cnt = _record_lanes(valid, d, n, dev, mb * mb)
    has = cnt > 0
    lo_k = torch.where(vb, key, kmax).amin(1)
    hi_k = torch.where(vb, key, kmin).amax(1)
    zmin = torch.where(has, _i32(lo_k), 0)
    fmax = torch.where(has, torch.where(vb, xf, float("-inf")).amax(1), 0.0)
    q = torch.where(vb, quantize_int_ref(xi, zmin[:, None], p), 0)
    max_q = q.amax(1)
    nb = _bit_len(max_q)
    zmin_f = torch.where(has, lo_k, 0).to(torch.float32)
    max_val = (fmax - zmin_f) * torch.tensor(p.scale, dtype=torch.float32, device=dev)
    const0 = ~has | ((zmin_f == 0) & (fmax == 0))
    force_raw = (fmax > zmin_f) if p.mze == 0 else (max_val > p.maxq_cap)
    force_raw = force_raw | (has & (hi_k - lo_k >= 2**31))  # a wide block: raw (K1's wide_block)
    tc, off_w = reduce_offset_int_ref(zmin, p.dt)
    off_word = _low_bytes(zmin, off_w)
    cw = torch.where(cnt < 256, 1, 2)
    stuff_len = 1 + off_w + torch.where(max_q > 0, 1 + cw + (cnt * nb + 7) // 8, 0)
    raw_len = 1 + cnt * DT_SIZE[p.dt]
    use_lut = torch.zeros_like(has)
    if lut:
        stuff_len, use_lut = _lut_candidate_ref(q, cnt, nb, max_q, off_w, cw, stuff_len,
                                                const0 | force_raw)
    zq = zmin
    use_diff = torch.zeros(n, dtype=torch.bool, device=dev)
    if p.diff_ok and d > 1:
        # depth-diff candidate against slice di-1 (device_encode.py:677-722)
        dv = _i32(xi - _prev_slice(xi, d))
        dmin = torch.where(has, torch.where(vb, dv, 2**30).amin(1), 0)
        dmax = torch.where(has, torch.where(vb, dv, -(2**30)).amax(1), 0)
        qd = torch.where(vb, _i32(dv - dmin[:, None]) & 0xFFFFFFFF, 0)
        max_qd = qd.amax(1)
        nbd = _bit_len(max_qd)
        tc_d, off_w_d = reduce_offset_int_ref(dmin, DataType.INT)
        stuff_len_d = 1 + off_w_d + torch.where(max_qd > 0, 1 + cw + (cnt * nbd + 7) // 8, 0)
        # the diff is taken only over a lossless, valued absolute record that
        # is neither const-0 nor forced raw: a block forced raw stays
        # absolute, as the reference tries no diff for it (lerc2_encode.py),
        # where JAX writes it raw with the diff bit
        diff_ok = (torch.arange(n, device=dev) % d > 0) & p.lossless & has & ~const0 & ~force_raw
        use_lut_d = torch.zeros_like(has)
        if lut:
            stuff_len_d, use_lut_d = _lut_candidate_ref(qd, cnt, nbd, max_qd, off_w_d, cw,
                                                        stuff_len_d, ~diff_ok)
        const0_d = (dmin == 0) & (dmax == 0)
        diff_len = torch.where(const0_d, 1, stuff_len_d)
        use_diff = diff_ok & (diff_len < stuff_len) & (diff_len < raw_len)
        const0 = const0 | (use_diff & const0_d)
        stuff_len = torch.where(use_diff, stuff_len_d, stuff_len)
        nb = torch.where(use_diff, nbd, nb)
        max_q = torch.where(use_diff, max_qd, max_q)
        tc = torch.where(use_diff, tc_d, tc)
        off_w = torch.where(use_diff, off_w_d, off_w)
        off_word = torch.where(use_diff, _low_bytes(dmin, off_w_d), off_word)
        zq = torch.where(use_diff, dmin, zq)
        use_lut = torch.where(use_diff, use_lut_d, use_lut)
    use_stuff = ~force_raw & (stuff_len < raw_len)
    mode = torch.where(const0, 2, torch.where(use_stuff, torch.where(max_q > 0, 1, 3), 0))
    length = torch.where(mode == 2, 1, torch.where(mode == 0, raw_len, stuff_len))
    ud = use_diff.to(torch.int64)
    flag = (_integ_bits(n, d, w, mb, p, dev) | (ud << 2) | mode
            | torch.where((mode == 1) | (mode == 3), tc << 6, 0))
    lut_bit = (use_lut & (mode == 1)).to(torch.int64)
    desc = flag | (mode << 8) | (ud << 10) | (lut_bit << 11) | (nb << 16) | (off_w << 24)
    rec_info = torch.stack([length, desc, _i32(off_word), zq], 1).to(torch.int32)
    zrange = _i32(_tile_ranges(torch.where(has, lo_k, kmax), torch.where(has, hi_k, kmin), d,
                               tile_rec)).to(torch.int32)
    bad = ((mode == 1) & (nb > p.cap_nb)) | ((mode == 0) & (not p.raw_ok))
    fits = (~bad.any()).to(torch.int32).reshape(1)
    return rec_info, zrange, fits


# ---------------------------------------------------------------------------
# K2 write_records
# ---------------------------------------------------------------------------


def write_records(data: torch.Tensor, rec_info: torch.Tensor, starts: torch.Tensor,
                  cap_w: int, p: EncodeParams, valid: torch.Tensor | None = None,
                  mb: int = 8, lut: bool = False) -> torch.Tensor:
    """The record stream: [cap_w] int32 u32 words, zero past the last
    record. Records running past the capacity are cut (K1 has cleared
    `fits` for them). With validity words, each record holds its block's
    valid values only, in position order. Launches write_records_kernel /
    write_records_masked_kernel (float32, a warp a record),
    write_records_int_kernel (the integer strips) or, with `lut`,
    write_records_lut_kernel (strips)."""
    h, w, d = data.shape
    n = _n_rec(data, mb)
    if rec_info.shape != (n, 4) or starts.shape != (n,):
        raise ValueError("rec_info / starts do not match the data's record count")
    lut_sfx = _lut_args(data, p, valid, mb, lut)
    vt, sfx, valid_ptr = _valid_args(valid, h, w, mb)
    if not build.on_cuda(data, *vt, rec_info, starts):
        return write_records_ref(data, rec_info, starts, cap_w, p, valid, mb, lut)
    if lut:
        return _write_records_lut(data, rec_info, starts, cap_w, p, valid_ptr, mb,
                                  "write_records" + lut_sfx)
    if dt_is_int(p.dt):
        return _write_records_int(data, rec_info, starts, cap_w, p, valid_ptr, sfx)
    fn = build.library("encode").write_records
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(data.device):
        out = torch.zeros(cap_w, dtype=torch.int32, device=data.device)
        err = fn(data.data_ptr(), valid_ptr, h, w, d, p.scale, p.inv, rec_info.data_ptr(),
                 starts.data_ptr(), out.data_ptr(), cap_w, build.launch_stream(data))
        build.check(err, "write_records" + sfx)
    build.LAUNCHES["write_records" + sfx] += 1
    return out


def _write_records_lut(data, rec_info, starts, cap_w: int, p: EncodeParams, valid_ptr, mb: int,
                       name: str):
    """Launch a LUT instance of K2 (float32 or int32 data)."""
    h, w, d = data.shape
    fn = build.library("encode").write_records_lut
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(data.device):
        out = torch.zeros(cap_w, dtype=torch.int32, device=data.device)
        err = fn(data.data_ptr(), int(dt_is_int(p.dt)), valid_ptr, h, w, d, mb, DT_SIZE[p.dt],
                 p.scale, p.inv, p.inv_i, int(p.lossless), rec_info.data_ptr(), starts.data_ptr(),
                 out.data_ptr(), cap_w, build.launch_stream(data))
        build.check(err, name)
    build.LAUNCHES[name] += 1
    return out


def _write_records_int(data, rec_info, starts, cap_w: int, p: EncodeParams, valid_ptr, sfx: str):
    """Launch the integer K2 instance."""
    h, w, d = data.shape
    fn = build.library("encode").write_records_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    name = "write_records" + sfx + DT_SUFFIX[p.dt]
    with torch.cuda.device(data.device):
        out = torch.zeros(cap_w, dtype=torch.int32, device=data.device)
        err = fn(data.data_ptr(), _in_type(data), valid_ptr, h, w, d, DT_SIZE[p.dt], p.scale,
                 p.inv_i, int(p.lossless), rec_info.data_ptr(), starts.data_ptr(),
                 out.data_ptr(), cap_w, build.launch_stream(data))
        build.check(err, name)
    build.LAUNCHES[name] += 1
    return out


def _pack_fields(n: int, n_words: int, fields) -> torch.Tensor:
    """LSB-first bit fields -> [n, 4 * n_words] payload bytes (int64). Each
    field is (bitpos [n, F], value [n, F] < 2**width, width [n, F] or
    scalar); fields never overlap, so adding is or-ing."""
    dev = fields[0][0].device
    words = torch.zeros(n, n_words + 1, dtype=torch.int64, device=dev)
    for bitpos, vals, _width in fields:
        wi, bit = bitpos >> 5, bitpos & 31
        words.scatter_add_(1, wi, (vals << bit) & 0xFFFFFFFF)
        words.scatter_add_(1, wi + 1, torch.where(bit > 0, vals >> (32 - bit), 0))
    shifts = torch.arange(0, 32, 8, device=dev)
    return ((words[:, :n_words, None] >> shifts) & 0xFF).reshape(n, -1)


def write_records_ref(data: torch.Tensor, rec_info: torch.Tensor, starts: torch.Tensor,
                      cap_w: int, p: EncodeParams, valid: torch.Tensor | None = None,
                      mb: int = 8, lut: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K2: each record as a byte row, scattered at
    its start; masked payloads go through ``compact_ref``; a LUT record's
    entries are the sorted distinct non-zero values and its indices come
    from ``torch.searchsorted`` over them."""
    bs = mb * mb
    x = _blocks(data, mb)
    n = x.shape[0]
    dev = x.device
    vb, cnt = _record_lanes(valid, data.shape[2], n, dev, bs)
    info = rec_info.to(torch.int64)
    length, desc = info[:, 0], info[:, 1]
    off_word = info[:, 2] & 0xFFFFFFFF
    flag, mode = desc & 0xFF, (desc >> 8) & 3
    is_lut = ((desc >> 11) & 1 == 1) & (mode == 1) & lut
    nb, off_w = (desc >> 16) & 0xFF, desc >> 24
    cw = torch.where(cnt < 256, 1, 2)

    # values: raw native bits, or the quantized values (integers: or the
    # differences to slice di-1 less the diff minimum, desc bit 10)
    if dt_is_int(p.dt):
        size = DT_SIZE[p.dt]
        xi = _i32(x.to(torch.int64))
        zq = info[:, 3:4]
        diff = ((desc >> 10) & 1 == 1)[:, None]
        stuffed = torch.where(diff, _i32(_i32(xi - _prev_slice(xi, data.shape[2])) - zq) & 0xFFFFFFFF,
                              quantize_int_ref(xi, zq, p))
        raw = _low_bytes(xi, size)
        raw_width = 8 * size
    else:
        zmin = rec_info[:, 3].contiguous().view(torch.float32)
        raw = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        stuffed = quantize_ref(x, zmin[:, None], p)
        raw_width = 32
    stuffed = torch.where(vb, stuffed, 0)
    vals = torch.where((mode == 0)[:, None], raw, stuffed)
    seq = torch.arange(bs, device=dev)[None, :]
    width = torch.where(mode == 0, raw_width, nb)[:, None]
    plain = torch.where(is_lut[:, None], 0, compact_ref(vals, vb))
    fields = [(seq * width, plain, width)]
    if lut:
        # [n_lut + 1][entries at nb bits][indices at bitlen(n_lut) bits]
        srt = stuffed.sort(1).values
        first = _first_nonzero(srt)
        n_lut = first.sum(1)
        nbits_lut = _bit_len(n_lut)[:, None]
        at = (torch.searchsorted(srt, stuffed, right=True) - 1).clamp(min=0)
        idx = first.cumsum(1).gather(1, at)
        idx_base = 8 * (1 + (n_lut * nb + 7) // 8)[:, None]
        lm = is_lut[:, None]
        # the entries and indices of LUT records only: the other lanes hold
        # 0 at bit 0, as a non-LUT record's n_lut * nb may reach past the
        # payload's bs + 2 words
        ent_at = torch.where(lm & (seq < n_lut[:, None]), 8 + seq * nb[:, None], 0)
        idx_at = torch.where(lm & (seq < cnt[:, None]), idx_base + seq * nbits_lut, 0)
        fields += [
            (torch.zeros(n, 1, dtype=torch.int64, device=dev),
             torch.where(lm, n_lut[:, None] + 1, 0), 8),
            (ent_at, torch.where(lm, compact_ref(srt, first), 0), nb[:, None]),
            (idx_at, torch.where(lm, compact_ref(idx, vb), 0), nbits_lut),
        ]
    payload = _pack_fields(n, bs + 2, fields)

    # header: flag, offset bytes (modes 1, 3), numBits byte and count (mode 1)
    k9 = torch.arange(9, device=dev)[None, :]
    hdr = torch.zeros(n, 9, dtype=torch.int64, device=dev)
    hdr[:, 0] = flag
    offb = (off_word[:, None] >> (8 * (k9 - 1)).clamp(min=0)) & 0xFF
    has_off = ((mode == 1) | (mode == 3))[:, None] & (k9 >= 1) & (k9 <= off_w[:, None])
    hdr = torch.where(has_off, offb, hdr)
    is_stuff = mode == 1
    nbb = nb | (is_lut.to(torch.int64) << 5) | ((3 - cw) << 6)
    hdr.scatter_(1, (1 + off_w)[:, None], torch.where(is_stuff, nbb, 0)[:, None])
    hdr.scatter_(1, (2 + off_w)[:, None], torch.where(is_stuff, cnt & 0xFF, 0)[:, None])
    hdr.scatter_(1, (3 + off_w)[:, None], torch.where(is_stuff & (cw == 2), cnt >> 8, 0)[:, None])
    hl = torch.where(mode == 0, 1, torch.where(is_stuff, 2 + off_w + cw,
                                               torch.where(mode == 3, 1 + off_w, 1)))[:, None]

    kk = torch.arange(payload.shape[1] + 9, device=dev)[None, :]
    rec = torch.where(kk < hl, hdr.gather(1, kk.clamp(max=8).expand(n, -1)),
                      payload.gather(1, (kk - hl).clamp(min=0, max=payload.shape[1] - 1)))
    pos = starts.to(torch.int64)[:, None] + kk
    keep = (kk < length[:, None]) & (pos >= 0) & (pos < 4 * cap_w)
    out = torch.zeros(4 * cap_w, dtype=torch.uint8, device=dev)
    out[pos[keep]] = rec[keep].to(torch.uint8)
    return out.view(torch.int32)


# ---------------------------------------------------------------------------
# float64: K1 encode_blocks_f64 and K2 write_records_f64
# ---------------------------------------------------------------------------

F64_RAW_LEN = 1 + 64 * 8  # a raw float64 record: flag + 64 values


def encode_params_f64(max_z_error: float, version: int) -> EncodeParams:
    """The float64 encoder's scalars: maxZError, scale = 1 / (2 maxZError)
    and inv = 2 maxZError in f64 (the decoder's invScale), the integrity
    mask; no bit cap."""
    mze = float(max_z_error)
    if not mze > 0:
        raise ValueError(f"the float64 tile encode needs maxZError > 0, got {max_z_error}")
    return EncodeParams(mze=mze, scale=1.0 / (2.0 * mze), inv=2.0 * mze,
                        integ_mask=0b111000 if version >= 5 else 0b111100, cap_nb=32,
                        raw_ok=True, dt=DataType.DOUBLE)


def encode_tiles_f64(data: torch.Tensor, mask, max_z_error: float, h: int, w: int, d: int,
                     all_valid: bool, version: int, cap: int):
    """Lossy float64 tile encode (``device_f64.encode_tiles_f64`` :95) on 8x8
    blocks: returns (stream [cap/4] int32 u32 words, total 0-d int32, z_min
    [D] f64, z_max [D] f64, starts [nRec] int32), all on data's device, with
    no host synchronization. The wire is JAX's (the full 8-byte offset, no
    LUT, modes const-0, stuffed, const-offset and raw); the quanta are native
    f64, each within maxZError of its value under the decoder's arithmetic
    (kernels/encode.cu). mask: the block validity words, ignored when
    all_valid."""
    if version < 3:
        raise NotImplementedError(
            "versions < 3 (legacy bit order) are the host codec's: codec/lerc2_encode.BandEncoder "
            "writes them")
    if cap % 4:
        raise ValueError("cap must be a multiple of 4")
    _check_f64(data, h, w, d)
    if not all_valid and mask is None:
        raise ValueError("a masked encode needs the block validity words")
    valid = None if all_valid else mask
    if valid is None and (h % 8 or w % 8):
        valid = block_valid_words(torch.ones(h, w, dtype=torch.bool, device=data.device))
    p = encode_params_f64(max_z_error, version)
    rec_info, zrange = encode_blocks_f64(data, p, valid)
    length = rec_info[:, 0]
    starts = torch.cumsum(length, 0, dtype=torch.int32) - length
    total = starts[-1] + length[-1]
    stream = write_records_f64(data, rec_info, starts, cap // 4, p, valid)
    return stream, total, zrange[:d], zrange[d:], starts


def _check_f64(data, h, w, d):
    if data.dtype != torch.float64 or tuple(data.shape) != (h, w, d) or not data.is_contiguous():
        raise ValueError(f"data must be a contiguous float64 [{h}, {w}, {d}] tensor, got "
                         f"{data.dtype} {tuple(data.shape)}")


def encode_blocks_f64(data: torch.Tensor, p: EncodeParams, valid: torch.Tensor | None = None,
                      tile_rec: int = 0):
    """K1 f64: (rec_info [nRec, 4] int32 = {length, desc, offset bits low
    word, high word}, desc = flag | mode << 8 | numBits << 16 | 8 << 24;
    zrange [2D] f64 = per-depth min then max over the valid values). valid:
    block validity words, or None when every pixel is valid (H, W multiples
    of 8). tile_rec > 0: a stack of tiles of tile_rec records each, zrange
    [nTiles * 2D] (counted as ``encode_tiles_f64``). Launches
    encode_blocks_float_kernel<double>: the float32 K1's strips, four lanes
    a record."""
    h, w, d = data.shape
    _check_f64(data, h, w, d)
    vt, sfx, valid_ptr = _valid_args(valid, h, w)
    n_rec = _n_rec(data)
    _check_tile_rec(tile_rec, n_rec, d)
    if not build.on_cuda(data, *vt):
        return encode_blocks_f64_ref(data, p, valid, tile_rec)
    fn = build.library("encode").encode_blocks_f64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    name = "encode_tiles_f64" if tile_rec else "encode_blocks" + sfx + "_f64"
    dev = data.device
    n_tiles = n_rec // tile_rec if tile_rec else 1
    with torch.cuda.device(dev):
        rec_info = torch.empty(n_rec, 4, dtype=torch.int32, device=dev)
        zrange = torch.tensor([float("inf"), float("-inf")], dtype=torch.float64,
                              device=dev).repeat_interleave(d).repeat(n_tiles)
        err = fn(data.data_ptr(), valid_ptr, h, w, d, p.scale, p.inv, p.integ_mask, tile_rec,
                 rec_info.data_ptr(), zrange.data_ptr(), build.launch_stream(data))
        build.check(err, name)
    build.LAUNCHES[name] += 1
    return rec_info, zrange


def quantize_f64_ref(x: torch.Tensor, zmin: torch.Tensor, p: EncodeParams) -> torch.Tensor:
    """int64 quanta of f64 x against per-row offsets zmin [n, 1]: q0 =
    round-half-even((x - zmin) * scale) clamped to [0, 2^30], and q0 +
    sign(x - recon(q0)) when its reconstruction zmin + q * inv (each
    operation rounded, as the decoder's) is strictly closer."""
    cap = float(1 << 30)
    q0 = torch.round((x - zmin) * p.scale).clamp(0.0, cap)
    resid = x - (zmin + q0 * p.inv)
    qc = (q0 + torch.sign(resid)).clamp(0.0, cap)
    errc = (x - (zmin + qc * p.inv)).abs()
    return torch.where(errc < resid.abs(), qc, q0).to(torch.int64)


def encode_blocks_f64_ref(data: torch.Tensor, p: EncodeParams, valid: torch.Tensor | None = None,
                          tile_rec: int = 0):
    """Plain PyTorch version of K1 f64."""
    h, w, d = data.shape
    x = _blocks(data)
    n = x.shape[0]
    dev = x.device
    vb, cnt = _record_lanes(valid, d, n, dev)
    has = cnt > 0
    zmin = torch.where(has, torch.where(vb, x, float("inf")).amin(1), 0.0)
    zmax = torch.where(has, torch.where(vb, x, float("-inf")).amax(1), 0.0)
    # the offset: the bits of the first valid position holding the minimum
    at_min = vb & (x == zmin[:, None])
    first = at_min.to(torch.int8).argmax(1, keepdim=True)
    off_bits = torch.where(at_min.any(1), x.view(torch.int64).gather(1, first)[:, 0], 0)
    off = off_bits.view(torch.float64)
    q = torch.where(vb, quantize_f64_ref(x, off[:, None], p), 0)
    max_q = q.amax(1)
    nb = _bit_len(max_q)
    const0 = ~has | ((zmin == 0) & (zmax == 0))
    force_raw = (zmax - zmin) * p.scale > 1073741823.0
    stuff_len = 9 + torch.where(max_q > 0, 2 + (cnt * nb + 7) // 8, 0)
    raw_len = 1 + 8 * cnt
    use_stuff = ~force_raw & (stuff_len < raw_len)
    mode = torch.where(const0, 2, torch.where(use_stuff, torch.where(max_q > 0, 1, 3), 0))
    length = torch.where(mode == 2, 1, torch.where(mode == 0, raw_len, stuff_len))
    desc = (_integ_bits(n, d, w, 8, p, dev) | mode) | (mode << 8) | (nb << 16) | (8 << 24)
    rec_info = torch.stack([length, desc, _as_i32(off_bits & 0xFFFFFFFF).to(torch.int64),
                            _as_i32((off_bits >> 32) & 0xFFFFFFFF).to(torch.int64)],
                           1).to(torch.int32)
    zrange = _tile_ranges(torch.where(has, zmin, float("inf")),
                          torch.where(has, zmax, float("-inf")), d, tile_rec)
    return rec_info, zrange


def write_records_f64(data: torch.Tensor, rec_info: torch.Tensor, starts: torch.Tensor,
                      cap_w: int, p: EncodeParams, valid: torch.Tensor | None = None) -> torch.Tensor:
    """K2 f64: the record stream, [cap_w] int32 u32 words, zero past the
    last record: [flag], [flag][offset 8 B], [flag][offset][numBits | 0x80]
    [count][quanta at numBits] or [flag][the valid values, 8 B each].
    Launches write_records_f64_kernel (a warp a record)."""
    h, w, d = data.shape
    _check_f64(data, h, w, d)
    n = _n_rec(data)
    if rec_info.shape != (n, 4) or starts.shape != (n,):
        raise ValueError("rec_info / starts do not match the data's record count")
    vt, sfx, valid_ptr = _valid_args(valid, h, w)
    if not build.on_cuda(data, *vt, rec_info, starts):
        return write_records_f64_ref(data, rec_info, starts, cap_w, p, valid)
    fn = build.library("encode").write_records_f64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_double, ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    name = "write_records" + sfx + "_f64"
    with torch.cuda.device(data.device):
        out = torch.zeros(cap_w, dtype=torch.int32, device=data.device)
        err = fn(data.data_ptr(), valid_ptr, h, w, d, p.scale, p.inv, rec_info.data_ptr(),
                 starts.data_ptr(), out.data_ptr(), cap_w, build.launch_stream(data))
        build.check(err, name)
    build.LAUNCHES[name] += 1
    return out


def write_records_f64_ref(data: torch.Tensor, rec_info: torch.Tensor, starts: torch.Tensor,
                          cap_w: int, p: EncodeParams,
                          valid: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K2 f64: each record as a byte row, scattered
    at its start; the values compacted by ``compact_ref``."""
    x = _blocks(data)
    n = x.shape[0]
    dev = x.device
    vb, cnt = _record_lanes(valid, data.shape[2], n, dev)
    info = rec_info.to(torch.int64)
    length, desc = info[:, 0], info[:, 1]
    flag, mode, nb = desc & 0xFF, (desc >> 8) & 3, (desc >> 16) & 0xFF
    off_bits = (info[:, 2] & 0xFFFFFFFF) | (info[:, 3] << 32)
    q = torch.where(vb, quantize_f64_ref(x, off_bits.view(torch.float64)[:, None], p), 0)
    seq = torch.arange(64, device=dev)[None, :]
    stuffed = _pack_fields(n, 64, [(seq * nb[:, None], compact_ref(q, vb), nb[:, None])])
    raw = compact_ref(x.view(torch.int64), vb)
    raw = ((raw[:, :, None] >> torch.arange(0, 64, 8, device=dev)) & 0xFF).reshape(n, -1)
    k = torch.arange(F64_RAW_LEN, device=dev)[None, :]
    offb = (off_bits[:, None] >> (8 * (k - 1)).clamp(0, 56)) & 0xFF
    # the stuffed record [flag][offset 8 B][numBits | 0x80][count][payload]
    head = torch.where(k <= 8, offb, torch.where(k == 9, nb[:, None] | 0x80, cnt[:, None]))
    stuff = torch.where(k <= 10, head, stuffed.gather(1, (k - 11).clamp(0, 255).expand(n, -1)))
    m2 = mode[:, None]
    rec = torch.where(m2 == 0, raw.gather(1, (k - 1).clamp(0, 511).expand(n, -1)),
                      torch.where(m2 == 1, stuff, torch.where(m2 == 3, offb, 0)))
    rec = torch.where(k == 0, flag[:, None], rec)
    pos = starts.to(torch.int64)[:, None] + k
    keep = (k < length[:, None]) & (pos >= 0) & (pos < 4 * cap_w)
    out = torch.zeros(4 * cap_w, dtype=torch.uint8, device=dev)
    out[pos[keep]] = rec[keep].to(torch.uint8)
    return out.view(torch.int32)
