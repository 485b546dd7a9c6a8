"""Device Lerc2 tile encoding (kernels K1 ``encode_blocks`` and K2
``write_records``, with their plain versions).

Port of ``lerc_tpu/ops/device_encode.py::encode_tiles`` (:486) for the
resident codec's float32 path, all-valid or masked: 8x8 micro blocks, H
and W multiples of 8, no LUT mode, version >= 4, any depth. It makes the
same encoder choices byte for byte: block min/max, f32 quantization with
round-half-even and the sign-directed +-1 fixup, numBits, the mode
(const-0, const-offset, raw, bit-stuffed), the reduced offset width, the
integrity bits and the record layout. Records are numbered r = b*D + di.

Masks: the [H, W] bool mask becomes two u32 validity words per 8x8 block
(``block_valid_words``), bit j = block position j in row-major order, once
per codec. The masked kernels (``encode_blocks_masked``,
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

Integer dtypes (:591-614, :651-653, :677-722) run their own template
instances of K1 and K2 (``encode_blocks_int``/``write_records_int``,
counted as e.g. ``encode_blocks_i16``): int32 block minimum, f32 block
maximum for the mode heuristics, lossless ``q = x - zmin`` at maxZError
0.5, the lossy f32 ``q0`` with the sign-directed fixup against the exact
integer reconstruction, offsets reduced per dtype (``_reduce_offset_int``
:79), raw records of ``1 + cnt * size`` native bytes, and the depth-diff
candidate of 8/16-bit lossless slices at version >= 5. The input is the
codec's own dtype or int32 (as JAX's ``xb.astype(int32)`` takes either).
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
                  dt: DataType = DataType.FLOAT) -> EncodeParams:
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
    pw = (64 * eff_cap + 31) // 32 + 1
    stuff_w = max((8 + 4 * (pw - 1) + 3) // 4, pw + 3) + 1
    raw_w = (1 + 64 * size + 3) // 4
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
    int32 for the integer dtypes (as JAX's).

    data: [H, W, D] float32, or for an integer `dt` that dtype or int32.
    mask: the [nBlocks, 2] int32 block validity words of the [H, W] mask
    (``block_valid_words``), on data's device; ignored when all_valid."""
    valid = None if all_valid else mask
    if not all_valid and mask is None:
        raise ValueError("a masked encode needs the block validity words")
    if enable_lut or mb != 8:
        raise NotImplementedError("LUT blocks and the 16x16 retrial: ROADMAP queue 1 item 6")
    if dt == DataType.DOUBLE:
        raise NotImplementedError("float64: ROADMAP queue 1 item 9")
    if version < 4:
        raise NotImplementedError("versions < 4: ROADMAP queue 1 item 6 (band codec)")
    if h % 8 or w % 8 or d < 1:
        raise NotImplementedError("H, W not multiples of 8: ROADMAP queue 1 item 6 (band codec)")
    if cap % 4:
        raise ValueError("cap must be a multiple of 4")
    _check_data(data, h, w, d, dt)
    p = encode_params(max_z_error, version, nb_cap, dt)
    rec_info, zrange, fits = encode_blocks(data, p, valid)
    length = rec_info[:, 0]
    starts = torch.cumsum(length, 0, dtype=torch.int32) - length
    total = starts[-1] + length[-1]
    stream = write_records(data, rec_info, starts, cap // 4, p, valid)
    return stream, total, zrange[:d], zrange[d:], starts, fits[0] != 0


def _check_data(data, h, w, d, dt=DataType.FLOAT):
    kinds = (torch.float32,) if dt == DataType.FLOAT else tuple(dict.fromkeys((DT_TO_TORCH[dt], torch.int32)))
    if data.dtype not in kinds or tuple(data.shape) != (h, w, d):
        want = " or ".join(str(k).removeprefix("torch.") for k in kinds)
        raise ValueError(f"data must be {want} [{h}, {w}, {d}], got {data.dtype} {tuple(data.shape)}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")


def _n_rec(data) -> int:
    h, w, d = data.shape
    return (h // 8) * (w // 8) * d


# ---------------------------------------------------------------------------
# block validity words and the plain rank routing
# ---------------------------------------------------------------------------


def block_valid_words(mask: torch.Tensor) -> torch.Tensor:
    """[H, W] bool mask -> [nBlocks, 2] int32 u32 validity words on the
    mask's device: bit j of word k is position 32k + j of the 8x8 block in
    row-major order (the order of ``_blocks`` and the kernels' lanes).
    Built once per codec; the kernels read these 8 B per block instead of
    64 B of bools."""
    h, w = mask.shape
    if mask.dtype != torch.bool or h % 8 or w % 8:
        raise ValueError(f"mask must be bool [H, W] with H, W multiples of 8, got {mask.dtype} {tuple(mask.shape)}")
    vb = (mask.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3)
          .reshape(-1, 2, 32).to(torch.int64))
    words = (vb << torch.arange(32, device=mask.device)).sum(2)
    return _as_i32(words).contiguous()


def valid_lanes(valid: torch.Tensor) -> torch.Tensor:
    """[nBlocks, 2] validity words -> [nBlocks, 64] bool, position order."""
    bits = (valid.to(torch.int64)[:, :, None] >> torch.arange(32, device=valid.device)) & 1
    return bits.reshape(-1, 64) != 0


def _check_valid(valid: torch.Tensor, n_blocks: int) -> None:
    if (valid.dtype != torch.int32 or tuple(valid.shape) != (n_blocks, 2)
            or not valid.is_contiguous()):
        raise ValueError(f"validity words must be a contiguous int32 [{n_blocks}, 2] tensor")


def _record_lanes(valid, d: int, n_rec: int, dev):
    """Per-record validity [nRec, 64] bool (record r = b*D + di takes block
    b's lanes) and value count [nRec] int64; all lanes when valid is None."""
    if valid is None:
        return (torch.ones(n_rec, 64, dtype=torch.bool, device=dev),
                torch.full((n_rec,), 64, dtype=torch.int64, device=dev))
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


def _valid_args(valid, h: int, w: int):
    """(the validity tensor as a tuple, to share the other inputs' device;
    the kernel's name suffix; the validity pointer) for an all-valid (None)
    or masked launch."""
    if valid is None:
        return (), "", None
    _check_valid(valid, (h // 8) * (w // 8))
    return (valid,), "_masked", valid.data_ptr()


def encode_blocks(data: torch.Tensor, p: EncodeParams, valid: torch.Tensor | None = None):
    """Per-record decisions: (rec_info [nRec, 4] int32 = {length, desc,
    offset word, zmin bits}, desc = flag | mode<<8 | numBits<<16 |
    offset width<<24; zrange [2D] f32 = per-depth min then max over the
    valid values; fits [1] int32). valid: block validity words, or None
    when every pixel is valid."""
    h, w, d = data.shape
    vt, sfx, valid_ptr = _valid_args(valid, h, w)
    if not build.on_cuda(data, *vt):
        return encode_blocks_ref(data, p, valid)
    if dt_is_int(p.dt):
        return _encode_blocks_int(data, p, valid_ptr, sfx)
    fn = build.library("encode").encode_blocks
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = data.device
    with torch.cuda.device(dev):
        rec_info = torch.empty(_n_rec(data), 4, dtype=torch.int32, device=dev)
        zrange = torch.cat([torch.full((d,), float("inf"), device=dev),
                            torch.full((d,), float("-inf"), device=dev)])
        fits = torch.ones(1, dtype=torch.int32, device=dev)
        err = fn(data.data_ptr(), valid_ptr, h, w, d, p.mze, p.scale, p.inv,
                 p.integ_mask, p.cap_nb, int(p.raw_ok), rec_info.data_ptr(),
                 zrange.data_ptr(), fits.data_ptr(), build.launch_stream(data))
        build.check(err, "encode_blocks" + sfx)
    build.LAUNCHES["encode_blocks" + sfx] += 1
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
    dev = data.device
    name = "encode_blocks" + sfx + DT_SUFFIX[p.dt]
    with torch.cuda.device(dev):
        rec_info = torch.empty(_n_rec(data), 4, dtype=torch.int32, device=dev)
        zrange = torch.cat([torch.full((d,), _I32_MAX, dtype=torch.int32, device=dev),
                            torch.full((d,), _I32_MIN, dtype=torch.int32, device=dev)])
        fits = torch.ones(1, dtype=torch.int32, device=dev)
        err = fn(data.data_ptr(), _in_type(data), valid_ptr, h, w, d, int(p.dt),
                 DT_SIZE[p.dt], p.mze, p.scale, p.inv_i, int(p.lossless), p.maxq_cap,
                 p.integ_mask, p.cap_nb, int(p.raw_ok), int(p.diff_ok and d > 1),
                 rec_info.data_ptr(), zrange.data_ptr(), fits.data_ptr(), build.launch_stream(data))
        build.check(err, name)
    build.LAUNCHES[name] += 1
    return rec_info, zrange, fits


def _blocks(data: torch.Tensor) -> torch.Tensor:
    """[H, W, D] -> [nRec, 64], record r = b*D + di, row-major in the block."""
    h, w, d = data.shape
    return (data.reshape(h // 8, 8, w // 8, 8, d).permute(0, 2, 4, 1, 3)
            .reshape(-1, 64).contiguous())


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


def encode_blocks_ref(data: torch.Tensor, p: EncodeParams, valid: torch.Tensor | None = None):
    """Plain PyTorch version of K1 (int64 bit arithmetic)."""
    if dt_is_int(p.dt):
        return encode_blocks_int_ref(data, p, valid)
    h, w, d = data.shape
    x = _blocks(data)
    n = x.shape[0]
    dev = x.device
    vb, cnt = _record_lanes(valid, d, n, dev)
    has = cnt > 0
    zmin = torch.where(has, torch.where(vb, x, float("inf")).amin(1), 0.0)
    zmax = torch.where(has, torch.where(vb, x, float("-inf")).amax(1), 0.0)
    q = torch.where(vb, quantize_ref(x, zmin[:, None], p), 0)
    max_q = q.amax(1)
    nb = (max_q[:, None] >= (1 << torch.arange(32, device=dev))).sum(1)
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
    # count byte width 1 (an 8x8 block has < 256 values); raw: 4 B a value
    stuff_len = 1 + off_w + torch.where(max_q > 0, 2 + (cnt * nb + 7) // 8, 0)
    raw_len = 1 + 4 * cnt
    use_stuff = ~force_raw & (stuff_len < raw_len)
    mode = torch.where(const0, 2, torch.where(use_stuff, torch.where(max_q > 0, 1, 3), 0))
    length = torch.where(mode == 2, 1, torch.where(mode == 0, raw_len, stuff_len))
    b = torch.arange(n, device=dev) // d
    integ = (((b % (w // 8)) & 15) << 2) & p.integ_mask
    flag = integ | mode | torch.where((mode == 1) | (mode == 3), tc << 6, 0)
    desc = flag | (mode << 8) | (nb << 16) | (off_w << 24)
    rec_info = torch.stack([length, desc, _as_i32(off_word).to(torch.int64),
                            zmin.view(torch.int32).to(torch.int64)], 1).to(torch.int32)
    # blocks without a valid value take no part in the per-depth range
    zrange = torch.cat([torch.where(has, zmin, float("inf")).view(-1, d).amin(0),
                        torch.where(has, zmax, float("-inf")).view(-1, d).amax(0)])
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


def encode_blocks_int_ref(data: torch.Tensor, p: EncodeParams, valid: torch.Tensor | None = None):
    """Plain PyTorch version of the integer K1 instances (int64 arithmetic
    wrapped to int32 where JAX computes in int32); zrange is [2D] int32."""
    h, w, d = data.shape
    x = _blocks(data)
    n = x.shape[0]
    dev = x.device
    xi, xf = _i32(x.to(torch.int64)), x.to(torch.float32)
    vb, cnt = _record_lanes(valid, d, n, dev)
    has = cnt > 0
    lo = torch.where(vb, xi, _I32_MAX).amin(1)
    hi = torch.where(vb, xi, _I32_MIN).amax(1)
    zmin = torch.where(has, lo, 0)
    fmax = torch.where(has, torch.where(vb, xf, float("-inf")).amax(1), 0.0)
    q = torch.where(vb, quantize_int_ref(xi, zmin[:, None], p), 0)
    max_q = q.amax(1)
    nb = _bit_len(max_q)
    zmin_f = zmin.to(torch.float32)
    max_val = (fmax - zmin_f) * torch.tensor(p.scale, dtype=torch.float32, device=dev)
    const0 = ~has | ((zmin_f == 0) & (fmax == 0))
    force_raw = (fmax > zmin_f) if p.mze == 0 else (max_val > p.maxq_cap)
    tc, off_w = reduce_offset_int_ref(zmin, p.dt)
    off_word = _low_bytes(zmin, off_w)
    stuff_len = 1 + off_w + torch.where(max_q > 0, 2 + (cnt * nb + 7) // 8, 0)
    raw_len = 1 + cnt * DT_SIZE[p.dt]
    zq = zmin
    use_diff = torch.zeros(n, dtype=torch.bool, device=dev)
    if p.diff_ok and d > 1:
        # depth-diff candidate against slice di-1 (device_encode.py:677-722)
        dv = _i32(xi - _prev_slice(xi, d))
        dmin = torch.where(has, torch.where(vb, dv, 2**30).amin(1), 0)
        dmax = torch.where(has, torch.where(vb, dv, -(2**30)).amax(1), 0)
        max_qd = torch.where(vb, _i32(dv - dmin[:, None]) & 0xFFFFFFFF, 0).amax(1)
        nbd = _bit_len(max_qd)
        tc_d, off_w_d = reduce_offset_int_ref(dmin, DataType.INT)
        stuff_len_d = 1 + off_w_d + torch.where(max_qd > 0, 2 + (cnt * nbd + 7) // 8, 0)
        const0_d = (dmin == 0) & (dmax == 0)
        diff_len = torch.where(const0_d, 1, stuff_len_d)
        use_diff = ((torch.arange(n, device=dev) % d > 0) & p.lossless & has & ~const0
                    & (diff_len < stuff_len) & (diff_len < raw_len))
        const0 = const0 | (use_diff & const0_d)
        stuff_len = torch.where(use_diff, stuff_len_d, stuff_len)
        nb = torch.where(use_diff, nbd, nb)
        max_q = torch.where(use_diff, max_qd, max_q)
        tc = torch.where(use_diff, tc_d, tc)
        off_w = torch.where(use_diff, off_w_d, off_w)
        off_word = torch.where(use_diff, _low_bytes(dmin, off_w_d), off_word)
        zq = torch.where(use_diff, dmin, zq)
    use_stuff = ~force_raw & (stuff_len < raw_len)
    mode = torch.where(const0, 2, torch.where(use_stuff, torch.where(max_q > 0, 1, 3), 0))
    length = torch.where(mode == 2, 1, torch.where(mode == 0, raw_len, stuff_len))
    b = torch.arange(n, device=dev) // d
    integ = (((b % (w // 8)) & 15) << 2) & p.integ_mask
    ud = use_diff.to(torch.int64)
    flag = integ | (ud << 2) | mode | torch.where((mode == 1) | (mode == 3), tc << 6, 0)
    desc = flag | (mode << 8) | (ud << 10) | (nb << 16) | (off_w << 24)
    rec_info = torch.stack([length, desc, _i32(off_word), zq], 1).to(torch.int32)
    zrange = torch.cat([torch.where(has, lo, _I32_MAX).view(-1, d).amin(0),
                        torch.where(has, hi, _I32_MIN).view(-1, d).amax(0)]).to(torch.int32)
    bad = ((mode == 1) & (nb > p.cap_nb)) | ((mode == 0) & (not p.raw_ok))
    fits = (~bad.any()).to(torch.int32).reshape(1)
    return rec_info, zrange, fits


# ---------------------------------------------------------------------------
# K2 write_records
# ---------------------------------------------------------------------------


def write_records(data: torch.Tensor, rec_info: torch.Tensor, starts: torch.Tensor,
                  cap_w: int, p: EncodeParams, valid: torch.Tensor | None = None) -> torch.Tensor:
    """The record stream: [cap_w] int32 u32 words, zero past the last
    record. Records running past the capacity are cut (K1 has cleared
    `fits` for them). With validity words, each record holds its block's
    valid values only, in position order."""
    h, w, d = data.shape
    n = _n_rec(data)
    if rec_info.shape != (n, 4) or starts.shape != (n,):
        raise ValueError("rec_info / starts do not match the data's record count")
    vt, sfx, valid_ptr = _valid_args(valid, h, w)
    if not build.on_cuda(data, *vt, rec_info, starts):
        return write_records_ref(data, rec_info, starts, cap_w, p, valid)
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


def write_records_ref(data: torch.Tensor, rec_info: torch.Tensor, starts: torch.Tensor,
                      cap_w: int, p: EncodeParams, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K2: each record as a byte row, scattered at
    its start; masked payloads go through ``compact_ref``."""
    x = _blocks(data)
    n = x.shape[0]
    dev = x.device
    vb, cnt = _record_lanes(valid, data.shape[2], n, dev)
    info = rec_info.to(torch.int64)
    length, desc = info[:, 0], info[:, 1]
    off_word = info[:, 2] & 0xFFFFFFFF
    flag, mode = desc & 0xFF, (desc >> 8) & 3
    nb, off_w = (desc >> 16) & 0xFF, desc >> 24

    # payload bits, LSB-first: value j at bits [j*width, (j+1)*width)
    if dt_is_int(p.dt):
        # raw: native LE bytes; stuffed: quantized values, or differences to
        # slice di-1 less the diff minimum (desc bit 10)
        size = DT_SIZE[p.dt]
        xi = _i32(x.to(torch.int64))
        zq = info[:, 3:4]
        diff = ((desc >> 10) & 1 == 1)[:, None]
        stuffed = torch.where(diff, _i32(_i32(xi - _prev_slice(xi, data.shape[2])) - zq) & 0xFFFFFFFF,
                              quantize_int_ref(xi, zq, p))
        vals = torch.where((mode == 0)[:, None], _low_bytes(xi, size), stuffed)
        raw_width = 8 * size
    else:
        zmin = rec_info[:, 3].contiguous().view(torch.float32)
        raw = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        vals = torch.where((mode == 0)[:, None], raw, quantize_ref(x, zmin[:, None], p))
        raw_width = 32
    if valid is not None:
        vals = compact_ref(vals, vb)
    width = torch.where(mode == 0, raw_width, nb)[:, None]
    bitpos = torch.arange(64, device=dev)[None, :] * width
    wi, bit = bitpos >> 5, bitpos & 31
    lo = (vals << bit) & 0xFFFFFFFF
    hi = torch.where(bit > 0, vals >> (32 - bit), 0)
    words = torch.zeros(n, _REC_BYTES // 4 + 1, dtype=torch.int64, device=dev)
    words.scatter_add_(1, wi, lo).scatter_add_(1, wi + 1, hi)
    shifts = torch.arange(0, 32, 8, device=dev)
    payload = ((words[:, :, None] >> shifts) & 0xFF).reshape(n, -1)

    # header: flag, offset bytes (modes 1, 3), numBits byte and count (mode 1)
    k8 = torch.arange(8, device=dev)[None, :]
    hdr = torch.zeros(n, 8, dtype=torch.int64, device=dev)
    hdr[:, 0] = flag
    offb = (off_word[:, None] >> (8 * (k8 - 1)).clamp(min=0)) & 0xFF
    has_off = ((mode == 1) | (mode == 3))[:, None] & (k8 >= 1) & (k8 <= off_w[:, None])
    hdr = torch.where(has_off, offb, hdr)
    is_stuff = mode == 1
    hdr.scatter_(1, (1 + off_w)[:, None], torch.where(is_stuff, nb | 0x80, 0)[:, None])
    hdr.scatter_(1, (2 + off_w)[:, None], torch.where(is_stuff, cnt, 0)[:, None])
    hl = torch.where(mode == 0, 1, torch.where(is_stuff, 3 + off_w,
                                               torch.where(mode == 3, 1 + off_w, 1)))[:, None]

    kk = torch.arange(_REC_BYTES, device=dev)[None, :]
    rec = torch.where(kk < hl, hdr.gather(1, kk.clamp(max=7).expand(n, -1)),
                      payload.gather(1, (kk - hl).clamp(min=0)))
    pos = starts.to(torch.int64)[:, None] + kk
    keep = (kk < length[:, None]) & (pos >= 0) & (pos < 4 * cap_w)
    out = torch.zeros(4 * cap_w, dtype=torch.uint8, device=dev)
    out[pos[keep]] = rec[keep].to(torch.uint8)
    return out.view(torch.int32)
