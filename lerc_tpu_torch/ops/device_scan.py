"""Device Fletcher32 of a resident Lerc2 blob (kernel K3) and the
index-free record scan (kernel K5), with their plain versions.

Port of ``lerc_tpu/ops/device_scan.py::fletcher32_device_parts`` (:306).
The message is four pieces: ``pre`` (the header bytes after the checksum
field, even length), a STATIC middle given only by its partial sums
``static_ab = (A, B, n_bytes)`` (``codec.fletcher32.fletcher32_partials``),
``tail`` (any length, even start) and ``stream[:total]``. The stream is a
zero-past-`total` int32 tensor holding little-endian u32 words; ``total`` is
a 0-d int32 tensor, so nothing is read back to the host.

Both versions weigh every byte by itself (a byte at message position n adds
to word n >> 1 with weight 256 when n is even, else 1), which makes an odd
prefix need no funnel shift. Sum(w) and Sum(i*w) then give the closed form
s1 = 0xffff + A, s2 = 0xffff*(M+1) + M*A - B (mod 65535, 0 -> 65535).
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

from ..constants import DT_SIZE, DataType, dt_is_int
from ..kernels import build

_MOD = 65535


def fletcher32_parts(pre: torch.Tensor, static_ab: tuple[int, int, int],
                     tail: torch.Tensor, stream: torch.Tensor,
                     total: torch.Tensor) -> torch.Tensor:
    """Fletcher32 of pre || STATIC || tail || stream[:total] as a 0-d int32
    tensor holding the u32 checksum bits. K3 on CUDA tensors (one launch:
    the whole grid reads every part, whatever its length and alignment);
    the plain version on CPU tensors."""
    _check(pre, tail, stream, total, static_ab)
    if not build.on_cuda(pre, tail, stream, total):
        return fletcher32_parts_ref(pre, static_ab, tail, stream, total)
    lib = build.library("fletcher32")
    fn = lib.fletcher32_parts
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    a, b, n_static = static_ab
    with torch.cuda.device(stream.device):
        acc = torch.zeros(3, dtype=torch.int64, device=stream.device)
        out = torch.empty((), dtype=torch.int32, device=stream.device)
        err = fn(pre.data_ptr(), pre.numel(), tail.data_ptr(), tail.numel(),
                 a, b, n_static, stream.data_ptr(), stream.numel(), total.data_ptr(),
                 acc.data_ptr(), out.data_ptr(), build.launch_stream(stream))
        build.check(err, "fletcher32_parts")
    build.LAUNCHES["fletcher32_parts"] += 1
    return out


def fletcher32_parts_ref(pre: torch.Tensor, static_ab: tuple[int, int, int],
                         tail: torch.Tensor, stream: torch.Tensor,
                         total: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3 (int64 arithmetic; torch's uint32 lacks
    shifts and reductions on the CPU)."""
    a_static, b_static, n_static = static_ab
    dev = stream.device
    n_pre, n_tail = pre.numel(), tail.numel()
    p_all = n_pre + n_static + n_tail
    total64 = total.reshape(()).to(torch.int64)

    def sums(byts, pos):
        v = byts.to(torch.int64) << torch.where((pos & 1) == 1, 0, 8)
        return v.sum(), (((pos >> 1) % _MOD) * v).sum()

    head_bytes = torch.cat([pre, tail]).to(dev)
    head_pos = torch.cat([torch.arange(n_pre, device=dev),
                          n_pre + n_static + torch.arange(n_tail, device=dev)])
    s1h, s2h = sums(head_bytes, head_pos)
    sb = stream.contiguous().view(torch.uint8)
    k = torch.arange(sb.numel(), device=dev, dtype=torch.int64)
    live = k < total64
    s1s, s2s = sums(torch.where(live, sb, 0), p_all + k)
    a = (s1h + s1s + a_static) % _MOD
    b = (s2h + s2s + b_static) % _MOD
    m = (p_all + total64 + 1) // 2
    wsum = ((m % _MOD) * a + _MOD - b) % _MOD
    r1 = (0xFFFF + a) % _MOD
    r2 = (0xFFFF * ((m + 1) % _MOD) + wsum) % _MOD
    r1 = torch.where(r1 == 0, _MOD, r1)
    r2 = torch.where(r2 == 0, _MOD, r2)
    return _as_i32((r2 << 16) | r1)


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 bits held in int64 -> the same bits as int32."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _check(pre, tail, stream, total, static_ab):
    if pre.dtype != torch.uint8 or tail.dtype != torch.uint8:
        raise TypeError("pre and tail must be uint8 tensors")
    if stream.dtype != torch.int32 or stream.dim() != 1 or not stream.is_contiguous():
        raise TypeError("stream must be a contiguous 1-D int32 tensor of u32 words")
    if total.dtype != torch.int32 or total.numel() != 1:
        raise TypeError("total must be a one-element int32 tensor")
    if not pre.is_contiguous() or not tail.is_contiguous():
        raise ValueError("pre and tail must be contiguous")
    if pre.numel() % 2 or static_ab[2] % 2:
        raise ValueError("pre and the static segment must have even lengths")


# ---------------------------------------------------------------------------
# record-header fields shared by the plain decoders (kernels/record.cuh)
# ---------------------------------------------------------------------------


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 it wraps to, still held in int64."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def offset_width_ref(dt, b67: torch.Tensor) -> torch.Tensor:
    """Offset byte width by dtype code (a DataType or a tensor of codes;
    0..5 integers, 6 float) and flag bits 6-7 (Lerc2.h:457-499)."""
    dt = torch.as_tensor(int(dt) if isinstance(dt, DataType) else dt, device=b67.device)
    w_short = torch.where(b67 > 0, 1, 2)
    w_int = torch.where(b67 == 3, 1, torch.where(b67 > 0, 2, 4))
    w_other = torch.where(b67 == 2, 1, torch.where(b67 == 1, 2, 4))  # UINT, FLOAT
    return torch.where(dt <= 1, 1, torch.where(dt <= 3, w_short,
                                               torch.where(dt == 4, w_int, w_other)))


def int_offset_ref(acc, off_w, dt, b67) -> torch.Tensor:
    """Integer offset (int64) from its off_w LE bytes in acc, sign-extended
    when its reduced type is signed (CHAR; SHORT at tc 0 or 2; INT at tc 2)."""
    dt = torch.as_tensor(int(dt) if isinstance(dt, DataType) else dt, device=acc.device)
    s8 = (dt == 0) | ((dt == 2) & (b67 == 2))
    s16 = ((dt == 4) & (b67 == 2)) | ((dt == 2) & (b67 == 0))
    v8, v16 = acc & 0xFF, acc & 0xFFFF
    v8 = torch.where(s8, (v8 ^ 0x80) - 0x80, v8)
    v16 = torch.where(s16, (v16 ^ 0x8000) - 0x8000, v16)
    return torch.where(off_w == 1, v8, torch.where(off_w == 2, v16, _i32(acc)))


def float_offset_ref(acc: torch.Tensor, b67: torch.Tensor) -> torch.Tensor:
    """Float offset (f32): byte (tc 2), short (tc 1) or the f32 bits."""
    i16 = ((acc & 0xFFFF) ^ 0x8000) - 0x8000
    return torch.where(b67 == 2, (acc & 0xFF).float(),
                       torch.where(b67 == 1, i16.float(), _as_i32(acc & 0xFFFFFFFF).view(torch.float32)))


def raw_int_ref(v: torch.Tensor, size: int, signed: bool) -> torch.Tensor:
    """A raw integer value of `size` bytes (int64), sign-extended if signed."""
    if size == 4:
        return _i32(v)
    top = 1 << (8 * size - 1)
    v = v & (2 * top - 1)
    return (v ^ top) - top if signed else v


# ---------------------------------------------------------------------------
# K5 scan_records: record starts and descriptors without the index
# ---------------------------------------------------------------------------


def _scan_consts(dt: DataType, version: int):
    """(dtype code, diff flag meaningful, raw record length) of a scan. Raw
    records hold a whole 8x8 block: the scan serves all-valid streams."""
    if dt == DataType.DOUBLE:
        raise NotImplementedError(
            "float64 has no device record scan (JAX's scan_records_device has none): the band "
            "codec scans float64 streams on the host")
    return int(dt), int(version >= 5), _raw_len(dt)


def _raw_len(dt: DataType) -> int:
    return 1 + 64 * DT_SIZE[dt]


def _check_stream(stream):
    if stream.dtype != torch.int32 or stream.dim() != 1 or not stream.is_contiguous():
        raise TypeError("stream must be a contiguous 1-D int32 tensor of u32 words")


def scan_scratch(s: int) -> tuple[int, int, int, int]:
    """Elements of K5's scratch for an s-byte stream, as kernels/scan.cu's
    chunking gives them: u32 chunk-map words, u16 chunk-local J, int32 plan
    words (three a chunk), u64 look-back words of the join."""
    fn = build.library("scan").scan_records_scratch
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sizes = (ctypes.c_longlong * 4)()
    build.check(fn(s, sizes), "scan_records_scratch")
    return tuple(sizes)


def scan_records(stream: torch.Tensor, n_rec: int, dt: DataType, version: int,
                 total: torch.Tensor):
    """Record starts of a tile stream without the record-offset index
    (``scan_records_device``, device_scan.py:35), on the stream's device
    with no host synchronization. Returns (rp, mode, offset, num_bits,
    num_elements, payload_pos, lut_pos, n_lut, nbits_lut, chain_ok): [nRec]
    int32 each but offset (f32 for float32, int32 for integer dtypes), and
    chain_ok, a 0-d bool: the last record ends exactly at `total` (a 0-d or
    one-element int32 tensor). rp[i] = J^i(0) for the jump table J of
    ``scan_records_sizes_ref`` (S past the chain's end). Diff records
    (version >= 5, flag bit 2) have mode + 8 and, for integer dtypes,
    offsets reduced as DataType INT.

    stream: [S / 4] int32 u32 words; record 0 starts at byte 0. On CUDA
    tensors K5's three kernels (kernels/scan.cu: chunk maps, their join,
    the chunks' starts and descriptors); the plain version on CPU tensors."""
    _check_stream(stream)
    code, diff_v5, raw_len = _scan_consts(dt, version)
    if total.dtype != torch.int32 or total.numel() != 1:
        raise TypeError("total must be a one-element int32 tensor")
    if n_rec < 1 or stream.numel() < 1:
        raise ValueError("a scan needs at least one record and a non-empty stream")
    if not build.on_cuda(stream, total):
        return scan_records_ref(stream, n_rec, dt, version, total)
    lib = build.library("scan")
    s = 4 * stream.numel()
    n_maps, n_jl, n_plan, n_lb = scan_scratch(s)
    dev = stream.device
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    def launch(name, argtypes, *values):
        fn = getattr(lib, name)
        fn.argtypes = [P, L, I, I, I, P, *argtypes, P]
        fn.restype = ctypes.c_int
        build.check(fn(stream.data_ptr(), s, code, diff_v5, raw_len, total.data_ptr(), *values,
                       build.launch_stream(stream)), name)
        build.LAUNCHES[name] += 1

    with torch.cuda.device(dev):
        maps = torch.empty(n_maps, dtype=torch.int32, device=dev)
        jl = torch.empty(n_jl, dtype=torch.int16, device=dev)  # J, chunk-local
        plan = torch.empty(n_plan, dtype=torch.int32, device=dev)
        lb = torch.empty(n_lb, dtype=torch.int64, device=dev)  # the join's look-back words
        rp = torch.empty(n_rec, dtype=torch.int32, device=dev)
        out = torch.empty(8, n_rec, dtype=torch.int32, device=dev)
        chain_ok = torch.empty(1, dtype=torch.int32, device=dev)
        outs = (rp.data_ptr(), out.data_ptr(), chain_ok.data_ptr())
        launch("scan_records_maps", [P, P, P, P], maps.data_ptr(), jl.data_ptr(),
               plan.data_ptr(), lb.data_ptr())
        launch("scan_records_join", [L, P, P, P, P, P, P], n_rec, maps.data_ptr(),
               plan.data_ptr(), lb.data_ptr(), *outs)
        launch("scan_records_emit", [L, P, P, P, P, P], n_rec, jl.data_ptr(), plan.data_ptr(),
               *outs)
    mode, offset, *rest = out.unbind(0)
    if dt == DataType.FLOAT:
        offset = offset.view(torch.float32)
    return (rp, mode, offset, *rest, chain_ok[0] != 0)


def scan_records_ref(stream: torch.Tensor, n_rec: int, dt: DataType, version: int,
                     total: torch.Tensor):
    """Plain PyTorch version of K5 (the JAX design): the jump table at every
    byte, ceil(log2 nRec) doubling steps, the descriptors at the starts."""
    rp = scan_records_chain_ref(scan_records_sizes_ref(stream, dt, version), n_rec)
    return (rp, *scan_records_describe_ref(stream, rp, dt, version, total))


def scan_records_chain_ref(jump: torch.Tensor, n_rec: int) -> torch.Tensor:
    """rp[i] = J^i(0) for i < n_rec by ceil(log2 n_rec) doubling steps over
    the jump table of ``scan_records_sizes_ref``."""
    rp = torch.zeros(n_rec, dtype=torch.int32, device=jump.device)
    filled = 1
    while filled < n_rec:
        take = min(filled, n_rec - filled)
        jump, rp = scan_records_double_ref(jump, rp, filled, take, filled + take < n_rec)
        filled += take
    return rp


def _stream_bytes(stream: torch.Tensor):
    u = stream.view(torch.uint8).to(torch.int64)
    s = u.numel()
    return u, s, lambda idx: u[idx.clamp(0, s - 1)]


def _offset_dtype(flag, dt: DataType, version: int):
    """Per-record offset dtype codes: integer diff records reduce as INT."""
    if version >= 5 and dt_is_int(dt):
        return torch.where((flag & 4) != 0, int(DataType.INT), int(dt))
    return torch.full_like(flag, int(dt))


def _read_head_ref(g, p, dt: DataType, version: int) -> SimpleNamespace:
    """Header fields of records starting at byte positions p (int64),
    read through the clamped byte reader g (device_scan.py:50-100)."""
    flag = g(p)
    code, b67 = flag & 3, flag >> 6
    odt = _offset_dtype(flag, dt, version)
    off_w = offset_width_ref(odt, b67)
    nbb_pos = p + 1 + off_w
    nbb = g(nbb_pos)
    cw_code = nbb >> 6
    cw = torch.where(cw_code == 0, 4, 3 - cw_code)
    ne = _i32(sum(torch.where(i < cw, g(nbb_pos + 1 + i) << (8 * i), 0) for i in range(4)))
    n_lut = g(nbb_pos + 1 + cw) - 1
    nbits_lut = sum(((n_lut >> i) > 0).to(torch.int64) for i in range(8))
    return SimpleNamespace(flag=flag, code=code, b67=b67, odt=odt, off_w=off_w,
                           nbb_pos=nbb_pos, cw=cw, is_lut=(nbb & 32) > 0, nb=nbb & 31, ne=ne,
                           n_lut=n_lut, nbits_lut=nbits_lut)


def _record_size_ref(h: SimpleNamespace, s: int, dt: DataType):
    """Record sizes from their header fields, clamped to [1, S]."""
    ne = h.ne.clamp(0, 64 * 64)
    head = 1 + h.off_w + 1 + h.cw
    sz_lut = head + 1 + ((h.n_lut * h.nb + 7) >> 3) + ((ne * h.nbits_lut + 7) >> 3)
    sz_simple = head + ((ne * h.nb + 7) >> 3)
    size = torch.where(h.code == 2, 1, torch.where(
        h.code == 3, 1 + h.off_w, torch.where(h.code == 0, _raw_len(dt),
                                              torch.where(h.is_lut, sz_lut, sz_simple))))
    return size.clamp(1, s)


def scan_records_sizes_ref(stream: torch.Tensor, dt: DataType, version: int) -> torch.Tensor:
    """Plain PyTorch version of the sizes kernel (int64 arithmetic)."""
    _scan_consts(dt, version)
    _u, s, g = _stream_bytes(stream)
    p = torch.arange(s, device=stream.device)
    size = _record_size_ref(_read_head_ref(g, p, dt, version), s, dt)
    jump = torch.minimum(p + size, torch.tensor(s, device=stream.device))
    return torch.cat([jump, jump.new_tensor([s])]).to(torch.int32)


def scan_records_double_ref(jump: torch.Tensor, rp: torch.Tensor, filled: int, take: int,
                            square: bool):
    """Plain PyTorch version of one doubling step (returns new tensors)."""
    rp = rp.clone()
    rp[filled : filled + take] = jump[rp[:take].long()]
    return (jump[jump.long()] if square else jump), rp


def scan_records_describe_ref(stream: torch.Tensor, rp: torch.Tensor, dt: DataType,
                              version: int, total: torch.Tensor):
    """Plain PyTorch version of the describe kernel (device_scan.py:116-181,
    with the diff-record offsets and modes of the native scanner)."""
    _scan_consts(dt, version)
    _u, s, g = _stream_bytes(stream)
    rp64 = rp.to(torch.int64)
    h = _read_head_ref(g, rp64, dt, version)
    lut_pos = h.nbb_pos + 1 + h.cw + 1
    payload_pos = torch.where(h.code == 0, rp64 + 1, torch.where(
        h.is_lut, lut_pos + ((h.n_lut * h.nb + 7) >> 3), h.nbb_pos + 1 + h.cw))
    mode = torch.where(h.code == 1, torch.where(h.is_lut, 4, 1), h.code)
    if version >= 5:
        mode = mode + torch.where((h.flag & 4) != 0, 8, 0)
    acc = sum(torch.where(i < h.off_w, g(rp64 + 1 + i) << (8 * i), 0) for i in range(4))
    if dt == DataType.FLOAT:
        offset = float_offset_ref(acc, h.b67)
    else:
        offset = int_offset_ref(acc, h.off_w, h.odt, h.b67).to(torch.int32)
    last, tot = rp64[-1], total.reshape(()).to(torch.int64)
    end = last + _record_size_ref(h, s, dt)[-1]
    chain_ok = (last < tot) & (end == tot)
    i32 = [t.to(torch.int32) for t in (mode, h.nb, h.ne, payload_pos, lut_pos, h.n_lut,
                                       h.nbits_lut)]
    return (i32[0], offset, *i32[1:], chain_ok)
