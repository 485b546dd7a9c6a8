"""Whole-image Huffman for 8-bit bands on the device: kernels H1-H4 and their
plain PyTorch versions.

Port of ``lerc_tpu/ops/device_huffman.py``. The reference encodes Byte/Char
bands losslessly with a 256-symbol canonical Huffman code over direct or
delta-vs-neighbour symbols (Lerc2.cpp:2311-2606). The wrappers keep the JAX
functions' names:

  H1 ``symbol_streams_device`` (``symbol_streams_device`` :50,
     ``symbol_streams_masked_device`` :72 and ``histogram256`` :118): the
     direct (pixel-major) and delta (depth-major) u8 symbols and both 256-bin
     histograms of the live symbols; all-valid one thread per pixel, masked
     one kernel over tiles in ticket order whose ranks come from a look-back;
  H2 ``encode_stream_device`` (:160 with ``_map256`` :141): a memset and
     one kernel (``huffman_encode``): tiles of 8,192 symbols in ticket
     order, each tile's bits summed, its first bit from a look-back over the
     tiles before it (each group's start bit, the sidecar ``sbits``, and
     the total), its MSB-first codes packed in shared memory and stored as
     LE u32 words;
  H3 ``decode_stream_device`` (:278): a decode table of the code's 12-bit
     prefixes (one small kernel), then one thread per group decodes its 64
     symbols serially from ``sbits[g]`` through that table;
  H4 ``symbols_to_image`` (:477), ``expand_compacted_device`` (:389) and
     ``undelta_masked_device`` (:432): symbols back to the [H, W, D] image.

Symbol layouts, as JAX's (the sidecar's groups are counted over them): with
a mask, the direct stream is the valid pixels' values, depth inner; the
delta stream is depth-major with H*W slots per plane, the valid pixels'
ranks first and zero gaps at each plane's tail. A position i of a stream of
n_total symbols is live when ``i % plane < n_live`` (``live_layout``); dead
positions emit and consume no bits.

On CPU tensors each wrapper runs its plain version (``*_ref``); on CUDA
tensors it launches its kernel (``kernels/huffman.cu``) or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import DataType
from ..kernels import build
from .device_scan import _as_i32

GROUP = 64    # symbols per packing group (the sidecar's unit)
CHUNK = 256   # pixels per rank chunk (the masked direct restore)


def live_layout(npx: int, d: int, n_valid: int | None, delta: bool) -> tuple[int, int, int]:
    """(n_total, plane, n_live) of a symbol stream: n_valid None = all-valid."""
    n_total = npx * d
    if n_valid is None:
        return n_total, n_total, n_total
    return (n_total, npx, n_valid) if delta else (n_total, n_total, n_valid * d)


def live_counts(n_groups: int, layout: tuple[int, int, int]) -> np.ndarray:
    """Live symbols per 64-symbol group (int32 [n_groups]) of a layout."""
    n_total, plane, n_live = layout
    x = np.minimum(np.arange(n_groups + 1, dtype=np.int64) * GROUP, n_total)
    cum = (x // plane) * n_live + np.minimum(x % plane, n_live)
    return np.diff(cum).astype(np.int32)


def _offset(dt: DataType) -> int:
    return 128 if dt == DataType.CHAR else 0


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 holding u32 bits -> int64 in [0, 2^32)."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _ctypes_fn(name: str, argtypes, restype=ctypes.c_int):
    fn = getattr(build.library("huffman"), name)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


# ---------------------------------------------------------------------------
# rank chunks: a pixel's rank among the valid pixels (glue of H4's masked direct restore)
# ---------------------------------------------------------------------------


def rank_chunks(mask_flat: torch.Tensor) -> torch.Tensor:
    """Per CHUNK-pixel chunk of a flat bool mask, the valid pixels before
    the chunk (int32 [nc]): the exclusive scan of per-chunk counts, as K2's
    record offsets; a pixel's rank is its chunk's base plus its popc
    prefix."""
    npx = mask_flat.numel()
    nc = -(-npx // CHUNK)
    m = torch.zeros(nc * CHUNK, dtype=torch.bool, device=mask_flat.device)
    m[:npx] = mask_flat
    cnt = m.view(nc, CHUNK).sum(1, dtype=torch.int32)
    return (torch.cumsum(cnt, 0, dtype=torch.int32) - cnt).contiguous()


# ---------------------------------------------------------------------------
# H1 symbol streams and histograms
# ---------------------------------------------------------------------------


def _check_data(data: torch.Tensor):
    if data.dtype != torch.int32 or data.dim() != 3 or not data.is_contiguous():
        raise TypeError("data must be a contiguous [H, W, D] int32 tensor")


def symbol_streams_device(data: torch.Tensor, mask: torch.Tensor | None, dt: DataType):
    """H1: (direct u8, delta u8, histos int32 [2, 256]) of an [H, W, D]
    int32 band (8-bit values) with an optional [H, W] bool mask. Both
    streams have ceil(H*W*D / 64) * 64 entries, zero past the live symbols
    (layouts in the module docstring); histos[0] counts the direct and
    histos[1] the delta stream's live symbols. All-valid: one thread per
    pixel. Masked: one kernel and one memset, no torch op: tiles of 2,048
    pixels in ticket order, each tile's base rank and the last valid pixel
    before it from a decoupled look-back over (valid count, last valid
    pixel), its symbols staged in shared memory and stored contiguously
    (its valid pixels' ranks are consecutive), one shared histogram a CTA;
    histos is then a view of the call's zeroed scratch."""
    _check_data(data)
    if mask is not None and (mask.dtype != torch.bool or mask.shape != data.shape[:2]):
        raise TypeError("mask must be an [H, W] bool tensor")
    if not build.on_cuda(data, *(() if mask is None else (mask,))):
        return symbol_streams_device_ref(data, mask, dt)
    h, w, d = data.shape
    npx = h * w
    n_pad = -(-npx * d // GROUP) * GROUP
    dev = data.device
    stream = build.launch_stream(data)
    if mask is None:
        fn = _ctypes_fn("huffman_symbols", [_P, _I, _I, _I, _I, _P, _P, _P, _P])
        with torch.cuda.device(dev):
            direct = torch.zeros(n_pad, dtype=torch.uint8, device=dev)
            delta = torch.zeros(n_pad, dtype=torch.uint8, device=dev)
            histos = torch.zeros(2, 256, dtype=torch.int32, device=dev)
            err = fn(data.data_ptr(), h, w, d, _offset(dt), direct.data_ptr(), delta.data_ptr(),
                     histos.data_ptr(), stream)
            build.check(err, "huffman_symbols")
        build.LAUNCHES["huffman_symbols"] += 1
        return direct, delta, histos
    m = mask.contiguous()
    n_scratch = _ctypes_fn("huffman_symbols_masked_scratch", [_I, _I], ctypes.c_longlong)(h, w)
    fn = _ctypes_fn("huffman_symbols_masked", [_P, _P, _I, _I, _I, _I, _P, _L, _P, _P, _L, _P])
    with torch.cuda.device(dev):
        scratch = torch.empty(n_scratch, dtype=torch.uint8, device=dev)
        direct = torch.empty(n_pad, dtype=torch.uint8, device=dev)
        delta = torch.empty(n_pad, dtype=torch.uint8, device=dev)
        err = fn(data.data_ptr(), m.data_ptr(), h, w, d, _offset(dt), scratch.data_ptr(),
                 n_scratch, direct.data_ptr(), delta.data_ptr(), n_pad, stream)
        build.check(err, "huffman_symbols_masked")
    build.LAUNCHES["huffman_symbols_masked"] += 1
    return direct, delta, scratch[:2048].view(torch.int32).view(2, 256)


def symbol_streams_device_ref(data: torch.Tensor, mask: torch.Tensor | None, dt: DataType):
    """Plain PyTorch version of H1 (symbol_streams_device,
    symbol_streams_masked_device, then histogram256 of the live symbols)."""
    h, w, d = data.shape
    npx = h * w
    dev = data.device
    off = _offset(dt)
    x = data.to(torch.int64)
    n_pad = -(-npx * d // GROUP) * GROUP
    direct = torch.zeros(n_pad, dtype=torch.uint8, device=dev)
    delta = torch.zeros(n_pad, dtype=torch.uint8, device=dev)
    if mask is None:
        left = torch.cat([x.new_zeros(h, 1, d), x[:, :-1]], 1)
        above = torch.cat([x.new_zeros(1, w, d), x[:-1]], 0)
        col = torch.arange(w, device=dev)[None, :, None]
        row = torch.arange(h, device=dev)[:, None, None]
        prev = torch.where(col > 0, left, torch.where(row > 0, above, 0))
        direct[:npx * d] = ((x + off) & 0xFF).reshape(-1).to(torch.uint8)
        dl = ((x - prev + off) & 0xFF).permute(2, 0, 1).reshape(-1)
        delta[:npx * d] = dl.to(torch.uint8)
        live_d, live_e = direct[:npx * d], delta[:npx * d]
    else:
        m = mask.reshape(npx)
        nv = int(m.sum())
        xs = x.reshape(npx, d)
        idx = torch.arange(npx, device=dev)
        last_valid = torch.cummax(torch.where(m, idx, -1), 0).values
        prev_idx = torch.cat([idx.new_full((1,), -1), last_valid[:-1]])
        left_ok = torch.zeros(h, w, dtype=torch.bool, device=dev)
        left_ok[:, 1:] = mask[:, 1:] & mask[:, :-1]
        above_ok = torch.zeros(h, w, dtype=torch.bool, device=dev)
        above_ok[1:] = mask[1:] & mask[:-1]
        use_above = (~left_ok.reshape(npx)) & above_ok.reshape(npx) & m
        src = torch.where(use_above, idx - w, prev_idx)
        prev = torch.where((src >= 0)[:, None], xs[src.clamp(0, npx - 1)], 0)
        vx, vp = xs[m], prev[m]  # [nv, d], scan order
        direct[:nv * d] = ((vx + off) & 0xFF).reshape(-1).to(torch.uint8)
        dl = ((vx - vp + off) & 0xFF).to(torch.uint8)  # [nv, d]
        planes = delta[:npx * d].view(d, npx)
        planes[:, :nv] = dl.T
        live_d = direct[:nv * d]
        live_e = planes[:, :nv].reshape(-1)
    histos = torch.stack([torch.bincount(live_d.to(torch.int64), minlength=256),
                          torch.bincount(live_e.to(torch.int64), minlength=256)])
    return direct, delta, histos.to(torch.int32)


# ---------------------------------------------------------------------------
# H2 group pack
# ---------------------------------------------------------------------------


def code_table(lengths: np.ndarray, codes: np.ndarray, device) -> torch.Tensor:
    """[2, 256] int32 (lengths, code bits) of a 256-symbol code table."""
    t = np.zeros((2, 256), np.int64)
    t[0, :lengths.size] = lengths
    t[1, :codes.size] = codes
    return torch.from_numpy(((t + 2**31) % 2**32 - 2**31).astype(np.int32)).to(device)


def _check_stream_args(sym, layout):
    if sym.dtype != torch.uint8 or sym.dim() != 1 or not sym.is_contiguous() \
            or sym.numel() % GROUP:
        raise TypeError("sym must be a contiguous 1-D uint8 tensor of whole 64-symbol groups")
    n_total, plane, n_live = layout
    if not (0 <= n_total <= sym.numel() and plane > 0 and 0 <= n_live <= plane):
        raise ValueError(f"bad live layout {layout} for {sym.numel()} symbols")


def encode_stream_device(sym: torch.Tensor, table: torch.Tensor, layout, cap_words: int):
    """H2: pack the live symbols of `sym` (u8, whole groups) with the code
    `table` ([2, 256] int32, ``code_table``) into the reference's MSB-first
    bitstream. Returns (words int32 [cap_words] of u32 bits, zero past the
    codes; total_bits 0-d int32; sbits int32 [n_groups], each group's first
    bit: the decode sidecar). cap_words must hold ceil(total_bits / 32)
    words; the caller knows total_bits from the histogram. On CUDA one
    memset (of one buffer: the total, the words, the tiles' look-back words)
    and one launch; words and total_bits are views of that buffer."""
    _check_stream_args(sym, layout)
    if table.dtype != torch.int32 or table.shape != (2, 256):
        raise TypeError("table must be a [2, 256] int32 tensor")
    if not build.on_cuda(sym, table):
        return encode_stream_device_ref(sym, table, layout, cap_words)
    n_total, plane, n_live = layout
    g = sym.numel() // GROUP
    table = table.contiguous()
    n_buf = _ctypes_fn("huffman_encode_scratch", [_L, _L], _L)(sym.numel(), cap_words)
    fn = _ctypes_fn("huffman_encode", [_P, _L, _P, _L, _L, _L, _P, _L, _P, _L, _P])
    with torch.cuda.device(sym.device):
        buf = torch.empty(n_buf, dtype=torch.uint8, device=sym.device)  # total, words, look-back
        sbits = torch.empty(g, dtype=torch.int32, device=sym.device)
        err = fn(sym.data_ptr(), sym.numel(), table.data_ptr(), n_total, plane, n_live,
                 buf.data_ptr(), n_buf, sbits.data_ptr(), cap_words, build.launch_stream(sym))
        build.check(err, "huffman_encode")
    build.LAUNCHES["huffman_encode"] += 1
    return buf[16:16 + 4 * cap_words].view(torch.int32), buf[:4].view(torch.int32)[0], sbits


def _live_mask(numel: int, layout, device) -> torch.Tensor:
    n_total, plane, n_live = layout
    i = torch.arange(numel, device=device)
    return (i < n_total) & (i % plane < n_live)


def encode_stream_device_ref(sym: torch.Tensor, table: torch.Tensor, layout, cap_words: int):
    """Plain PyTorch version of H2 (int64 arithmetic: each code's top-aligned
    bits split over two words and added, the words' bits being disjoint)."""
    dev = sym.device
    g = sym.numel() // GROUP
    s = sym.to(torch.int64)
    lens = torch.where(_live_mask(sym.numel(), layout, dev), table[0].to(torch.int64)[s], 0)
    code = _u32(table[1])[s]
    lens2 = lens.view(g, GROUP)
    cum = torch.cumsum(lens2, 1)
    gbits = cum[:, -1]
    sbits = torch.cumsum(gbits, 0) - gbits
    bp = (sbits[:, None] + cum - lens2).reshape(-1)  # each code's first bit
    top = torch.where(lens > 0, (code << (32 - lens)) & 0xFFFFFFFF, 0)
    sh = bp & 31
    lo = top >> sh
    hi = torch.where(sh > 0, (top << (32 - sh)) & 0xFFFFFFFF, 0)
    acc = torch.zeros(cap_words + 1, dtype=torch.int64, device=dev)
    acc.index_add_(0, bp >> 5, lo)
    acc.index_add_(0, (bp >> 5) + 1, hi)
    return _as_i32(acc[:cap_words]), (sbits[-1] + gbits[-1]).to(torch.int32), sbits.to(torch.int32)


def encode_stream_tiled_ref(sym: torch.Tensor, table: torch.Tensor, layout, cap_words: int,
                            tile: int):
    """H2's tile algebra in plain numpy at any tile of whole groups (tests
    only; the kernel's tile is 8,192 symbols). Per tile: the sum of its
    live symbols' lengths; its first bit P, the exclusive scan of the sums
    before it (the look-back); each group's sbits, P plus the lengths before
    it in the tile; the tile's codes packed MSB-first into words from the
    tile's own bit 0; the words stored shifted by P mod 32 (each output word
    from two neighbouring buffer words), the ones strictly inside the
    tile's bits assigned, its first and last ORed into the zeroed output
    (tiles before and after may share them). Returns encode_stream_device's
    (words, total_bits, sbits)."""
    if tile <= 0 or tile % GROUP:
        raise ValueError("tile must be a positive number of whole 64-symbol groups")
    n = sym.numel()
    s = sym.cpu().numpy().astype(np.int64)
    t = table.cpu().numpy().astype(np.int64)
    live = _live_mask(n, layout, "cpu").numpy()
    lens = np.where(live, t[0][s], 0)
    top = np.where(lens > 0, (t[1][s] << (32 - np.clip(lens, 1, 32))) & 0xFFFFFFFF, 0)
    out = np.zeros(cap_words, np.int64)
    sbits = np.zeros(n // GROUP, np.int64)
    p = 0  # the look-back: the bits of the tiles before
    for t0 in range(0, n, tile):
        ln, tp = lens[t0:t0 + tile], top[t0:t0 + tile]
        off = np.cumsum(ln) - ln  # each code's first bit in the tile
        sbits[t0 // GROUP:(t0 + ln.size) // GROUP] = p + off[::GROUP]
        tot = int(ln.sum())
        if tot:
            nw = -(-tot // 32)
            buf = np.zeros(nw + 3, np.int64)  # a zero word before the tile's words, two after
            sh = off & 31
            np.bitwise_or.at(buf, 1 + (off >> 5), tp >> sh)
            np.bitwise_or.at(buf, 2 + (off >> 5), np.where(sh > 0, (tp << (32 - sh)) & 0xFFFFFFFF,
                                                            0))
            f, last, r = p >> 5, (p + tot - 1) >> 5, p & 31
            k = np.arange(last - f + 1)
            word = ((buf[k] << (32 - r)) & 0xFFFFFFFF) | (buf[k + 1] >> r) if r else buf[k + 1]
            x = f + k
            keep = x < cap_words
            inner = keep & (x > f) & (x < last)
            out[x[inner]] = word[inner]
            for e in {f, last}:  # the edge words, shared with the tiles around
                if e < cap_words:
                    out[e] |= word[e - f]
        p += tot
    return (_as_i32(torch.from_numpy(out)), torch.tensor(p, dtype=torch.int32),
            torch.from_numpy(sbits.astype(np.int32)))


# ---------------------------------------------------------------------------
# H3 group-parallel decode
# ---------------------------------------------------------------------------


def decode_stream_device(words: torch.Tensor, n_bits: int, sbits: torch.Tensor,
                         consts: torch.Tensor, sorted_syms: torch.Tensor, layout):
    """H3: decode the live symbols of a canonical-Huffman stream with its
    per-group start bits. words: int32 u32 words of the stream (its first n_bits
    bits are the stream; a code running past them is corrupt); sbits: int32
    [n_groups]; consts: [33, 3] int64 (first, first + count, base) per code
    length; sorted_syms: [256] uint8 canonical-order symbols. Returns (syms
    u8 [n_groups * 64], dead positions 0; used int32 [n_groups], bits each
    group consumed; ok 0-d bool: every live prefix matched a code within the
    stream, sbits[0] == 0 and each group's bits end where the next begins)."""
    if words.dtype != torch.int32 or words.dim() != 1 or not words.is_contiguous():
        raise TypeError("words must be a contiguous 1-D int32 tensor of u32 words")
    if sbits.dtype != torch.int32 or sbits.dim() != 1 or sbits.numel() == 0:
        raise TypeError("sbits must be a non-empty 1-D int32 tensor")
    if consts.dtype != torch.int64 or consts.shape != (33, 3):
        raise TypeError("consts must be a [33, 3] int64 tensor")
    if sorted_syms.dtype != torch.uint8 or sorted_syms.shape != (256,):
        raise TypeError("sorted_syms must be a [256] uint8 tensor")
    n_total, plane, n_live = layout
    g = sbits.numel()
    if not (n_total <= g * GROUP and plane > 0 and 0 <= n_live <= plane):
        raise ValueError(f"bad live layout {layout} for {g} groups")
    if not 0 <= n_bits <= 32 * words.numel():
        raise ValueError("n_bits exceeds the words given")
    if not build.on_cuda(words, sbits, consts, sorted_syms):
        return decode_stream_device_ref(words, n_bits, sbits, consts, sorted_syms, layout)
    fn = _ctypes_fn("huffman_decode",
                    [_P, _L, _L, _P, _I, _P, _P, _L, _L, _L, _P, _L, _P, _P, _P, _P])
    n_scratch = _ctypes_fn("huffman_decode_scratch", [], _L)()
    with torch.cuda.device(words.device):
        scratch = torch.empty(n_scratch, dtype=torch.uint8, device=words.device)  # the table
        syms = torch.empty(g * GROUP, dtype=torch.uint8, device=words.device)
        used = torch.empty(g, dtype=torch.int32, device=words.device)
        ok = torch.ones(1, dtype=torch.int32, device=words.device)
        err = fn(words.data_ptr(), words.numel(), n_bits, sbits.contiguous().data_ptr(), g,
                 consts.contiguous().data_ptr(), sorted_syms.data_ptr(), n_total, plane, n_live,
                 scratch.data_ptr(), n_scratch, syms.data_ptr(), used.data_ptr(), ok.data_ptr(),
                 build.launch_stream(words))
        build.check(err, "huffman_decode")
    build.LAUNCHES["huffman_decode"] += 1
    return syms, used, ok[0] != 0


def decode_stream_device_ref(words, n_bits, sbits, consts, sorted_syms, layout):
    """Plain PyTorch version of H3: the 64 steps serially, all groups at
    once, each step matching the 32-bit window against every code length."""
    dev = words.device
    g = sbits.numel()
    u = torch.cat([_u32(words), torch.zeros(2, dtype=torch.int64, device=dev)])
    n_w = words.numel()
    present = [L for L in range(1, 33) if int(consts[L, 1]) > int(consts[L, 0])]
    lv = torch.tensor(present, dtype=torch.int64, device=dev)
    first, limit, base = (consts[lv, j] for j in range(3))
    live = _live_mask(g * GROUP, layout, dev).view(g, GROUP)
    pos = sbits.to(torch.int64)
    bad = pos < 0
    used = torch.zeros(g, dtype=torch.int64, device=dev)
    out = torch.zeros(g, GROUP, dtype=torch.int64, device=dev)
    for s in range(GROUP):
        lv_s = live[:, s] & ~bad
        wi = (pos >> 5).clamp(0, n_w)
        sh = pos & 31
        hi, lo = u[wi], u[wi + 1]
        peek = torch.where(sh > 0, ((hi << sh) & 0xFFFFFFFF) | (lo >> (32 - sh)), hi)
        c = peek[:, None] >> (32 - lv)[None, :]
        hit = (c >= first[None, :]) & (c < limit[None, :])
        found = hit.any(1)
        j = hit.to(torch.int8).argmax(1)  # the shortest matching length
        length = lv[j]
        ok_s = found & (pos + length <= n_bits)
        bad = bad | (lv_s & ~ok_s)
        take = lv_s & ok_s
        idx = base[j] + c.gather(1, j[:, None])[:, 0] - first[j]
        out[:, s] = torch.where(take, sorted_syms.to(torch.int64)[idx.clamp(0, 255)], 0)
        length = torch.where(take, length, 0)
        pos = pos + length
        used = used + length
    nxt = sbits.to(torch.int64)
    match = torch.cat([(nxt[1:] - nxt[:-1]) == used[:-1], used.new_ones(1, dtype=torch.bool)])
    ok = ~bad.any() & match.all() & (nxt[0] == 0)
    return out.view(-1).to(torch.uint8), used.to(torch.int32), ok


# ---------------------------------------------------------------------------
# H4 image restore
# ---------------------------------------------------------------------------


def _as_dtype(img: torch.Tensor, dt: DataType) -> torch.Tensor:
    return img.view(torch.int8) if dt == DataType.CHAR else img


def symbols_to_image(sym: torch.Tensor, h: int, w: int, d: int, dt: DataType, delta: bool):
    """H4, all-valid: the [H, W, D] uint8 (int8 for CHAR) image of decoded
    symbols. Direct: pixel-major, value = symbol - offset. Delta: depth-major;
    the scan-order un-delta (prev = left, or above at column 0) is a mod-256
    scan down column 0 (``huffman_restore_col0``) then one along each row
    (``huffman_restore_delta``)."""
    if sym.dtype != torch.uint8 or sym.dim() != 1 or sym.numel() < h * w * d:
        raise TypeError("sym must be a 1-D uint8 tensor of at least H*W*D symbols")
    if not build.on_cuda(sym):
        return symbols_to_image_ref(sym, h, w, d, dt, delta)
    sym = sym.contiguous()
    with torch.cuda.device(sym.device):
        img = torch.empty(h, w, d, dtype=torch.uint8, device=sym.device)
        stream = build.launch_stream(sym)
        if not delta:
            fn = _ctypes_fn("huffman_restore", [_P, _L, _I, _P, _P])
            err = fn(sym.data_ptr(), h * w * d, _offset(dt), img.data_ptr(), stream)
            build.check(err, "huffman_restore")
            build.LAUNCHES["huffman_restore"] += 1
            return _as_dtype(img, dt)
        col0 = torch.empty(d, h, dtype=torch.uint8, device=sym.device)
        n_totals = -(-d // 4) * _ctypes_fn("huffman_restore_col0_ctas", [_I])(h)
        agg = torch.empty(n_totals, dtype=torch.int64, device=sym.device)  # CTA totals
        fn = _ctypes_fn("huffman_restore_col0", [_P, _I, _I, _I, _I, _P, _I, _P, _P])
        err = fn(sym.data_ptr(), h, w, d, _offset(dt), agg.data_ptr(), n_totals, col0.data_ptr(),
                 stream)
        build.check(err, "huffman_restore_col0")
        build.LAUNCHES["huffman_restore_col0"] += 1
        fn = _ctypes_fn("huffman_restore_delta", [_P, _P, _I, _I, _I, _I, _P, _P])
        err = fn(sym.data_ptr(), col0.data_ptr(), h, w, d, _offset(dt), img.data_ptr(), stream)
        build.check(err, "huffman_restore_delta")
    build.LAUNCHES["huffman_restore_delta"] += 1
    return _as_dtype(img, dt)


def symbols_to_image_ref(sym, h, w, d, dt, delta):
    """Plain PyTorch version of the all-valid H4."""
    off = _offset(dt)
    s = sym[:h * w * d].to(torch.int64) - off
    if not delta:
        img = (s & 0xFF).view(h, w, d)
    else:
        e = s.view(d, h, w)
        col0 = torch.cumsum(e[:, :, 0], 1) & 0xFF
        rows = torch.cat([col0[:, :, None], e[:, :, 1:]], 2)
        img = (torch.cumsum(rows, 2) & 0xFF).permute(1, 2, 0)
    return _as_dtype(img.to(torch.uint8).contiguous(), dt)


def _check_masked(sym, mask, d):
    if sym.dtype != torch.uint8 or sym.dim() != 1 or not sym.is_contiguous():
        raise TypeError("sym must be a contiguous 1-D uint8 tensor")
    if mask.dtype != torch.bool or mask.dim() != 2:
        raise TypeError("mask must be an [H, W] bool tensor")
    if sym.numel() < mask.numel() * d:
        raise ValueError("sym must hold H*W*D slots")


def expand_compacted_device(sym: torch.Tensor, mask: torch.Tensor, d: int, dt: DataType):
    """H4, masked direct: the [H, W, D] image whose valid pixel p (rank r in
    scan order) holds sym[r * D + k] - offset in slice k, 0 elsewhere."""
    _check_masked(sym, mask, d)
    if not build.on_cuda(sym, mask):
        return expand_compacted_device_ref(sym, mask, d, dt)
    h, w = mask.shape
    m = mask.contiguous().view(-1)
    fn = _ctypes_fn("huffman_restore_masked", [_P, _P, _P, _L, _I, _I, _P, _P])
    with torch.cuda.device(sym.device):
        base = rank_chunks(m)
        img = torch.empty(h, w, d, dtype=torch.uint8, device=sym.device)
        err = fn(sym.data_ptr(), m.data_ptr(), base.data_ptr(), h * w, d, _offset(dt),
                 img.data_ptr(), build.launch_stream(sym))
        build.check(err, "huffman_restore_masked")
    build.LAUNCHES["huffman_restore_masked"] += 1
    return _as_dtype(img, dt)


def expand_compacted_device_ref(sym, mask, d, dt):
    """Plain PyTorch version of the masked direct H4."""
    h, w = mask.shape
    m = mask.reshape(-1)
    nv = int(m.sum())
    img = torch.zeros(h * w, d, dtype=torch.int64, device=sym.device)
    img[m] = (sym[:nv * d].to(torch.int64).view(nv, d) - _offset(dt)) & 0xFF
    return _as_dtype(img.view(h, w, d).to(torch.uint8), dt)


def undelta_masked_device(sym: torch.Tensor, mask: torch.Tensor, d: int, dt: DataType):
    """H4, masked delta: the [H, W, D] image from depth-major delta symbols
    (plane k's ranks at k * H * W). A valid pixel's value is its delta plus
    its left neighbour's value if that is valid, else the value above if
    that is valid, else the previous valid pixel's in scan order
    (Lerc2.cpp:2546-2575); 0 at invalid pixels. The kernels work in rank
    space, as the plain version: ranks and segments (a segment starts at
    each use-above pixel) by a look-back scan of the mask, the prefix sum s
    of the deltas written at each valid pixel, then each segment's base
    (the value above its start, less s before it, plus its parent
    segment's base) resolved by pointer jumping and added in place. No
    limit on the number of segments."""
    _check_masked(sym, mask, d)
    if not build.on_cuda(sym, mask):
        return undelta_masked_device_ref(sym, mask, d, dt)
    h, w = mask.shape
    m = mask.contiguous().view(-1)
    n_scratch = _ctypes_fn("huffman_restore_delta_masked_scratch", [_I, _I, _I], _L)(h, w, d)
    fn = _ctypes_fn("huffman_restore_delta_masked", [_P, _P, _I, _I, _I, _I, _P, _L, _P, _P])
    with torch.cuda.device(sym.device):
        img = torch.empty(h, w, d, dtype=torch.uint8, device=sym.device)
        scratch = torch.empty(n_scratch, dtype=torch.int64, device=sym.device)
        err = fn(sym.data_ptr(), m.data_ptr(), h, w, d, _offset(dt), scratch.data_ptr(),
                 scratch.numel(), img.data_ptr(), build.launch_stream(sym))
        build.check(err, "huffman_restore_delta_masked")
    build.LAUNCHES["huffman_restore_delta_masked"] += 1
    return _as_dtype(img, dt)


def masked_delta_segments_ref(mask: torch.Tensor):
    """The segment table of the masked un-delta (the kernels' pass 2), as
    JAX's ``_masked_delta_segments``: (seg_b, seg_t, seg_par) int64 [m + 1],
    entry 0 the root segment (0, 0, 0), entry k >= 1 the k-th use-above
    pixel in scan order (valid, left invalid or column 0, above valid): its
    rank, the rank of the pixel above it, and the segment holding that."""
    h, w = mask.shape
    npx = h * w
    dev = mask.device
    m = mask.reshape(npx)
    rank = torch.cumsum(m, 0) - 1
    left_ok = torch.zeros(h, w, dtype=torch.bool, device=dev)
    left_ok[:, 1:] = mask[:, 1:] & mask[:, :-1]
    above_ok = torch.zeros(h, w, dtype=torch.bool, device=dev)
    above_ok[1:] = mask[1:] & mask[:-1]
    ua = torch.nonzero((~left_ok.reshape(npx)) & above_ok.reshape(npx) & m)[:, 0]
    seg_b, seg_t = rank[ua], rank[ua - w]
    seg_par = torch.searchsorted(seg_b, seg_t, right=True)  # 0 = the root segment
    zero = seg_b.new_zeros(1)
    return torch.cat([zero, seg_b]), torch.cat([zero, seg_t]), torch.cat([zero, seg_par])


def undelta_masked_device_ref(sym, mask, d, dt):
    """Plain PyTorch version of the masked delta H4: the kernels' (and JAX's)
    rank-space design, a prefix sum s of the deltas broken into segments at
    the use-above pixels, segment k's base B_k = c_k + B_parent(k) with c_k =
    s[t_k] - s[b_k - 1], the segment forest resolved by pointer doubling."""
    h, w = mask.shape
    npx = h * w
    dev = sym.device
    m = mask.reshape(npx)
    nv = int(m.sum())
    img = torch.zeros(npx, d, dtype=torch.int64, device=dev)
    if nv:
        seg_b, seg_t, par = masked_delta_segments_ref(mask)
        seg_b, seg_t = seg_b[1:], seg_t[1:]
        deltas = sym[:npx * d].to(torch.int64).view(d, npx)[:, :nv] - _offset(dt)
        s = torch.cumsum(deltas, 1)
        c = torch.cat([s.new_zeros(d, 1), s[:, seg_t] - s[:, seg_b - 1]], 1)  # B_0 = 0
        for _ in range(max(1, par.numel().bit_length())):
            c = c + c[:, par]
            par = par[par]
        seg_of = torch.searchsorted(seg_b, torch.arange(nv, device=dev), right=True)
        img[m] = ((s + c[:, seg_of]) & 0xFF).T
    return _as_dtype(img.view(h, w, d).to(torch.uint8), dt)
