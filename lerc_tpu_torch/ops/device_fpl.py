"""Lossless float32 and float64 (fpl, Lerc2 v6 "delta-delta Huffman") on
the device: kernels F1, F2, F2b and F3, their plain PyTorch versions, and
the host choice and plane packing between them.

Port of ``lerc_tpu/ops/device_fpl.py``, both halves. The section codes each
value's bits under a predictor (0 none, 1 the left neighbour, 2 the left then
the upper neighbour, in split-field arithmetic), as byte planes, each with
0..5 extra byte-delta levels (:70); every plane is then coded by Huffman,
RLE-const, raw bytes or PackBits, whichever is smallest. The image is
[H, W] at depth 1 and [H * W, D] deeper (``codec/fpl_impl.slice_shape``).
float32 words are float-transformed (exponent above sign above mantissa,
``float_transform_dev`` :43) and split as mantissa mod 2^23 and
exponent+sign mod 2^9 (:50, :58): four planes. float64 words are the raw
bits (no transform) split as mantissa mod 2^52 and exponent+sign mod 2^12
(``split_sub64_dev`` :277, ``apply_predictor64_dev`` :285): eight planes.
The float64 instances are counted with an ``_f64`` suffix; F2b is one
kernel for both, over 4 or 8 planes.

  F1 ``fpl_sample_histograms`` (``fpl_choose_device`` :123, ``_f64`` :300):
     every stride-th row of the word image (stride the largest listed prime
     <= pixels / 2^19), each predictor on that sample (predictor 2's "up" is
     the previous sampled row), byte levels 0..5 along the flattened sample,
     and the 256-bin histograms of every 7th position: int32
     [3, planes, 6, 256].
  ``fpl_choose`` (host): JAX's entropy estimate (:79) of those counts in
     float32, in JAX's order: the level of least estimate per plane (the
     first on ties, levels above 5 - {0, 1, 2}[pred] left out), the
     estimates summed over the planes in order, the predictor of least sum.
  F2 ``fpl_finalize`` (``fpl_finalize_device`` :168, ``_f64`` :344): the
     chosen level's planes (u8 [planes, n_pad], zero past n) and their
     histograms (int32 [planes, 256]) in one pass: an output byte needs its
     pixel, its left, upper and upper-left neighbours and at most 5 earlier
     bytes of its plane.
  F2b ``fpl_packbits_size`` (``packbits_size_device`` :88): each plane's
     PackBits size from its runs, JAX's formula exactly, with its
     ``lit_total // 128`` stand-in for the literal headers: it decides
     PackBits against Huffman.
  ``fpl_pack_planes`` (``fpl_pack_planes_device`` :434): the Huffman planes
     through H2 (``device_huffman.encode_stream_device``), whole 64-symbol
     groups, every position live.
  F3 ``fpl_restore`` (``fpl_restore_device`` :235, ``_f64`` :407): the level
     undo (nested prefix sums mod 256 from index level - 1), the words, the
     split-field prefix sums along the rows (predictors 1, 2) and down the
     columns (predictor 2), the transform undone (float32): [H, W, D] of
     the planes' float type. The kernel reads each plane once: the level
     undo runs on the words bytewise, tile by tile, its carries from a
     look-back over the tiles' affine carry maps; in u32 and u64 words the
     split-field add is associative, so the row scan rides a second
     look-back and the column scan is a chunked parallel scan; there is no
     2^25-element limit (JAX's ``_cumsum_mod52_pair`` :366 has one).

On CPU tensors each wrapper runs its plain version (``*_ref``: u32 words in
int64, u64 words as int64 bits with a mask after every right shift -- CPU
uint32 and uint64 are shell dtypes); on CUDA tensors it launches its kernel
(``kernels/fpl.cu``) or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..codec.fpl_impl import MAX_DELTA, PRIME_MULT, slice_shape
from ..kernels import build
from . import device_huffman

MANT = 0x7FFFFF
MANT52 = (1 << 52) - 1
SAMPLE_PRIMES = (1, 3, 7, 13, 31, 61, 127, 251)
N_PREDICTORS, N_PLANES, N_LEVELS = 3, 4, MAX_DELTA + 1
N_PLANES64 = 8

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _ctypes_fn(name: str, argtypes, restype=ctypes.c_int):
    fn = getattr(build.library("fpl"), name)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


def sample_stride(n: int) -> int:
    """Row stride of F1's sample of an image of n values (:130-135)."""
    target = max(1, n // (1 << 19))
    return max(p for p in SAMPLE_PRIMES if p <= target)


def n_planes(dtype: torch.dtype) -> int:
    """Byte planes of a float type's words: 4 (float32) or 8 (float64)."""
    return N_PLANES64 if dtype == torch.float64 else N_PLANES


def _sfx(dtype: torch.dtype) -> str:
    return "_f64" if dtype == torch.float64 else ""


def _check_data(data: torch.Tensor):
    if data.dtype not in (torch.float32, torch.float64) or data.dim() != 3 \
            or not data.is_contiguous():
        raise TypeError("data must be a contiguous [H, W, D] float32 or float64 tensor")


def padded(n: int) -> int:
    """n rounded up to whole 64-symbol groups (the planes' row length)."""
    return -(-n // device_huffman.GROUP) * device_huffman.GROUP


def _levels_arg(levels):
    return (ctypes.c_int * len(levels))(*(int(v) for v in levels))


# ---------------------------------------------------------------------------
# word arithmetic of the plain versions: u32 in int64 holding [0, 2^32); u64
# as the int64 of the same bits (every right shift masked)
# ---------------------------------------------------------------------------


def _words(data: torch.Tensor) -> torch.Tensor:
    return data.reshape(-1).view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def float_transform(u: torch.Tensor) -> torch.Tensor:
    """(:43) mantissa | exponent << 24 | sign << 23."""
    return (u & MANT) | (((u >> 23) & 0xFF) << 24) | ((u >> 31) << 23)


def undo_float_transform(u: torch.Tensor) -> torch.Tensor:
    """(:227) the inverse of float_transform."""
    return (u & MANT) | (((u >> 24) & 0xFF) << 23) | (((u >> 23) & 1) << 31)


def split_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(:50) mantissa and exponent+sign subtracted apart, each wrapping."""
    return ((a - b) & MANT) | ((((a >> 23) - (b >> 23)) & 0x1FF) << 23)


def split_sub64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(:277) the 52-bit mantissas and 12-bit exponents+signs of u64 words
    (int64 bits) subtracted apart, each wrapping."""
    return ((a - b) & MANT52) | (((((a >> 52) & 0xFFF) - ((b >> 52) & 0xFFF)) & 0xFFF) << 52)


def _pred_words(data: torch.Tensor) -> torch.Tensor:
    """The flat words the predictor works on: float-transformed float32
    bits, or float64 bits as they are."""
    if data.dtype == torch.float64:
        return data.reshape(-1).view(torch.int64)
    return float_transform(_words(data))


def apply_predictor(img: torch.Tensor, pred: int, sub=split_sub) -> torch.Tensor:
    """(:58, :285) the predictor on a [rows, cols] word image."""
    if pred == 0:
        return img
    d1 = img.clone()
    d1[:, 1:] = sub(img[:, 1:], img[:, :-1])
    if pred == 1:
        return d1
    out = d1.clone()
    out[1:] = sub(d1[1:], d1[:-1])
    return out


def _predicted(data: torch.Tensor, rows: int, cols: int, pred: int, stride: int = 1):
    sub = split_sub64 if data.dtype == torch.float64 else split_sub
    return apply_predictor(_pred_words(data).view(rows, cols)[::stride], pred, sub).reshape(-1)


def byte_levels(plane: torch.Tensor, top: int = MAX_DELTA) -> list[torch.Tensor]:
    """Byte-delta levels 0..top of a flat byte plane (int64): level k
    subtracts each position's predecessor from positions >= k of level
    k - 1 (:70, setDerivative); a level above the length changes nothing
    (JAX's concatenation fails there, ROADMAP queue 3)."""
    out = [plane]
    for k in range(1, top + 1):
        nxt = out[-1].clone()
        if k < plane.numel():
            nxt[k:] = (out[-1][k:] - out[-1][k - 1:-1]) & 0xFF
        out.append(nxt)
    return out


# ---------------------------------------------------------------------------
# F1 sampled histograms, and the choice on the host
# ---------------------------------------------------------------------------


def fpl_sample_histograms(data: torch.Tensor) -> torch.Tensor:
    """F1: int32 [3 predictors, planes, 6 levels, 256] histograms of every
    7th position of the sampled rows' byte levels (module docstring)."""
    _check_data(data)
    if not build.on_cuda(data):
        return fpl_sample_histograms_ref(data)
    h, w, d = data.shape
    rows, cols = slice_shape(h, w, d)
    stride = sample_stride(rows * cols)
    m = -(-rows // stride) * cols
    name = "fpl_sample_histograms" + _sfx(data.dtype)
    fn = _ctypes_fn(name, [_P, _L, _I, _I, _L, _P, _P])
    with torch.cuda.device(data.device):
        hist = torch.zeros(N_PREDICTORS, n_planes(data.dtype), N_LEVELS, 256, dtype=torch.int32,
                           device=data.device)
        err = fn(data.data_ptr(), rows, cols, stride, m, hist.data_ptr(),
                 build.launch_stream(data))
        build.check(err, name)
    build.LAUNCHES[name] += 1
    return hist


def fpl_sample_histograms_ref(data: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of F1, JAX's steps one by one."""
    h, w, d = data.shape
    rows, cols = slice_shape(h, w, d)
    stride = sample_stride(rows * cols)
    n_pl = n_planes(data.dtype)
    hist = torch.zeros(N_PREDICTORS, n_pl, N_LEVELS * 256, dtype=torch.int64, device=data.device)
    lev = torch.arange(N_LEVELS, device=data.device)[:, None] * 256
    for p in range(N_PREDICTORS):
        t = _predicted(data, rows, cols, p, stride)
        for b in range(n_pl):
            lv = torch.stack(byte_levels((t >> (8 * b)) & 0xFF))[:, ::PRIME_MULT]
            hist[p, b] = torch.bincount((lv + lev).reshape(-1), minlength=N_LEVELS * 256)
    return hist.view(N_PREDICTORS, n_pl, N_LEVELS, 256).to(torch.int32)


def _fma32(a, b, c) -> np.ndarray:
    """Correctly rounded float32 a * b + c: the float64 product is exact, the
    float64 sum made round-to-odd, then one rounding to float32."""
    a, b, c = (np.asarray(v, np.float32) for v in (a, b, c))
    prod = a.astype(np.float64) * b.astype(np.float64)
    cd = c.astype(np.float64)
    s = prod + cd
    bv = s - prod
    err = (prod - (s - bv)) + (cd - bv)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((err != 0) & even, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


# the float32 log of XLA on the CPU (Cephes' logf polynomial, as Eigen's
# plog, with the multiply-adds that LLVM contracts fused), for x >= 1
_LOG_P = tuple(np.float32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
    -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = np.float32(-2.12194440e-4), np.float32(0.693359375)
_INV_LN2 = np.float32(1.44269502)  # XLA folds x / log(2) into x * (1 / log(2))


def _log32(v) -> np.ndarray:
    v = np.asarray(v, np.float32)
    bits = v.view(np.uint32)
    e = ((bits >> 23).astype(np.int32) - 126).astype(np.float32)
    x = ((bits & np.uint32(0x807FFFFF)) | np.uint32(0x3F000000)).view(np.float32)
    low = x < np.float32(0.707106781186547524)
    x = (x - np.float32(1)) + np.where(low, x, np.float32(0))
    e = e - low.astype(np.float32)
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = _fma32(_fma32(p[0], x, p[1]), x, p[2])
    y1 = _fma32(_fma32(p[3], x, p[4]), x, p[5])
    y2 = _fma32(_fma32(p[6], x, p[7]), x, p[8])
    y = _fma32(_fma32(_fma32(y, x3, y1), x3, y2), x3, e * _LOG_Q1)
    x = _fma32(-x2, np.float32(0.5), x) + y
    return _fma32(e, _LOG_Q2, x)


def entropy_estimates(hist: np.ndarray) -> np.ndarray:
    """JAX's ``_entropy_bits`` (:79) of each 256-bin histogram of `hist`
    ([..., 256] counts) in float32, bit-equal to XLA on the CPU: sum over the
    bins of h * (log2(total) - log2(h)), with XLA's log, its fused
    multiply-add and its reduction order (eight windows of 32 bins summed in
    order, then the eight in order). Equal estimates of differently placed
    bins then tie, or not, as they do in JAX."""
    h = np.asarray(hist).astype(np.float32)
    total = h.sum(-1, keepdims=True, dtype=np.float32)  # exact: counts < 2^24
    p = np.where(h > 0, h, np.float32(1))
    t = h * _fma32(-_log32(p), _INV_LN2, _log32(total) * _INV_LN2)
    t = np.where(h > 0, t, np.float32(0)).reshape(*h.shape[:-1], 8, 32)
    win = np.zeros(t.shape[:-1], np.float32)
    for i in range(32):
        win = win + t[..., i]
    out = np.zeros(t.shape[:-2], np.float32)
    for i in range(8):
        out = out + win[..., i]
    return out


def fpl_choose(hist: np.ndarray) -> tuple[int, tuple[int, ...], np.ndarray]:
    """(predictor, each plane's level, the three predictors' float32
    estimates) from F1's counts [3, planes, 6, 256], in
    ``fpl_choose_device``'s (``_f64``'s) order."""
    es = entropy_estimates(hist)  # [3, planes, 6]
    n_pl = es.shape[1]
    ests = np.zeros(N_PREDICTORS, np.float32)
    levels = np.zeros((N_PREDICTORS, n_pl), np.int64)
    for p in range(N_PREDICTORS):
        e = es[p].copy()
        e[:, MAX_DELTA - p + 1:] = np.inf  # max_delta_eff = 5 - {0, 1, 2}[p]
        levels[p] = np.argmin(e, axis=1)
        est = np.float32(0)
        for b in range(n_pl):
            est = np.float32(est + e[b].min())
        ests[p] = est
    pred = int(np.argmin(ests))
    return pred, tuple(int(v) for v in levels[pred]), ests


# ---------------------------------------------------------------------------
# F2 finalize
# ---------------------------------------------------------------------------


def _check_choice(pred: int, levels, n_pl: int = N_PLANES):
    if pred not in (0, 1, 2) or len(levels) != n_pl \
            or not all(0 <= int(v) <= MAX_DELTA for v in levels):
        raise ValueError(f"bad predictor {pred} or levels {levels}")


def fpl_finalize(data: torch.Tensor, pred: int, levels):
    """F2: (planes u8 [planes, n_pad]: each plane at its level, zero past n;
    histos int32 [planes, 256] of the planes' n bytes)."""
    _check_data(data)
    n_pl = n_planes(data.dtype)
    _check_choice(pred, levels, n_pl)
    if not build.on_cuda(data):
        return fpl_finalize_ref(data, pred, levels)
    h, w, d = data.shape
    rows, cols = slice_shape(h, w, d)
    n = rows * cols
    name = "fpl_finalize" + _sfx(data.dtype)
    fn = _ctypes_fn(name, [_P, _L, _I, _I, _P, _P, _L, _P, _P])
    with torch.cuda.device(data.device):
        # every byte of the planes is the kernel's, the zero tail too
        planes = torch.empty(n_pl, padded(n), dtype=torch.uint8, device=data.device)
        histos = torch.zeros(n_pl, 256, dtype=torch.int32, device=data.device)
        err = fn(data.data_ptr(), n, cols, pred, _levels_arg(levels), planes.data_ptr(),
                 planes.shape[1], histos.data_ptr(), build.launch_stream(data))
        build.check(err, name)
    build.LAUNCHES[name] += 1
    return planes, histos


def fpl_finalize_ref(data: torch.Tensor, pred: int, levels):
    """Plain PyTorch version of F2."""
    h, w, d = data.shape
    rows, cols = slice_shape(h, w, d)
    n = rows * cols
    n_pl = n_planes(data.dtype)
    t = _predicted(data, rows, cols, pred)
    planes = torch.zeros(n_pl, padded(n), dtype=torch.uint8, device=data.device)
    histos = torch.zeros(n_pl, 256, dtype=torch.int32, device=data.device)
    for b in range(n_pl):
        final = byte_levels((t >> (8 * b)) & 0xFF, int(levels[b]))[-1]
        planes[b, :n] = final.to(torch.uint8)
        histos[b] = torch.bincount(final, minlength=256).to(torch.int32)
    return planes, histos


# ---------------------------------------------------------------------------
# F2b PackBits sizes
# ---------------------------------------------------------------------------


def _check_planes(planes: torch.Tensor, n: int):
    if planes.dtype != torch.uint8 or planes.dim() != 2 \
            or planes.shape[0] not in (N_PLANES, N_PLANES64) \
            or not planes.is_contiguous() or not 0 < n <= planes.shape[1]:
        raise TypeError(f"planes must be a contiguous [4 or 8, >= {n}] uint8 tensor")


def fpl_packbits_size(planes: torch.Tensor, n: int) -> torch.Tensor:
    """F2b: int32 [planes], the PackBits size of each plane's first n bytes
    by JAX's formula (``packbits_size_device``). Per run of equal bytes of
    length L after a run of length Lp: 2 * (L // 129 + (L % 129 >= 2))
    bytes of repeats, a literal when L % 129 == 1, which opens a literal
    stretch when L >= 130 or the run before left none; plus
    literals // 128. The kernel reads each plane once, a CTA per 16 KB
    tile: the runs inside a tile add their terms there, and the plane's
    last tile to finish joins the tiles' summaries (first and last start,
    sums, two flags; ``packbits_size_tiled_ref`` is the same algebra in
    plain PyTorch). A memset and one launch a call; scratch of a summary a
    tile, sized by the source's ``fpl_packbits_scratch``."""
    _check_planes(planes, n)
    if not build.on_cuda(planes):
        return fpl_packbits_size_ref(planes, n)
    n_pl = planes.shape[0]
    n_scratch = _ctypes_fn("fpl_packbits_scratch", [_L, _I], ctypes.c_longlong)(n, n_pl)
    fn = _ctypes_fn("fpl_packbits_size", [_P, _I, _L, _L, _P, _L, _P, _P])
    dev = planes.device
    with torch.cuda.device(dev):
        scratch = torch.empty(n_scratch, dtype=torch.uint8, device=dev)
        sizes = torch.empty(n_pl, dtype=torch.int32, device=dev)
        err = fn(planes.data_ptr(), n_pl, planes.shape[1], n, scratch.data_ptr(), n_scratch,
                 sizes.data_ptr(), build.launch_stream(planes))
        build.check(err, "fpl_packbits_size")
    build.LAUNCHES["fpl_packbits_size"] += 1
    return sizes


def fpl_packbits_size_ref(planes: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch version of F2b: JAX's per-position formula (cummax /
    cummin of the change positions), not the run compaction."""
    x = planes[:, :n].to(torch.int64)
    n_pl = x.shape[0]
    dev = x.device
    idx = torch.arange(n, device=dev).expand(n_pl, n)
    change = torch.ones(n_pl, n, dtype=torch.bool, device=dev)
    change[:, 1:] = x[:, 1:] != x[:, :-1]
    run_start = torch.cummax(torch.where(change, idx, 0), 1).values
    ncv = torch.where(change, idx, n)
    rc = torch.flip(torch.cummin(torch.flip(ncv, [1]), 1).values, [1])
    next_change = torch.cat([rc[:, 1:], torch.full((n_pl, 1), n, device=dev)], 1)
    length = next_change - run_start
    segs = torch.where(change, length // 129 + ((length % 129) >= 2).to(torch.int64), 0)
    lit_pos = (length % 129) == 1
    lit = change & lit_pos
    prev_run_lit = torch.zeros_like(lit_pos)
    prev_run_lit[:, 1:] = lit_pos[:, :-1]
    stretch = lit & ((change & (length >= 130)) | ~prev_run_lit)
    lit_total = lit.sum(1)
    return (2 * segs.sum(1) + lit_total + stretch.sum(1) + lit_total // 128).to(torch.int32)


def packbits_size_tiled_ref(planes: torch.Tensor, n: int, tile: int) -> torch.Tensor:
    """F2b's algebra in plain PyTorch, at any tile size (tests only; the
    kernel's tile is 16 KB). Each tile of `tile` bytes sums the terms of the
    runs that start in it and end before its last start, and exports its
    first start f, its last start l, whether the run at f leaves a literal
    of length < 130 (it opens a stretch unless the run before left a
    literal) and whether the run before l, inside the tile, left one. The
    join, in tile order: P_U, the last start before tile U, is an exclusive
    max scan of l + 1; the run at P_U ends at f_U; whether the run before
    P_U left a literal is the low bit of a second exclusive max scan, of
    2 l + that flag of each tile + 1. The run at the last start ends at n."""
    x = planes[:, :n].to(torch.int64)
    n_tiles = -(-n // tile)
    out = []
    for p in x:
        start = torch.ones(n, dtype=torch.bool, device=p.device)
        start[1:] = p[1:] != p[:-1]
        pos = torch.nonzero(start).flatten()
        tid = pos // tile
        first = torch.ones_like(start[:pos.numel()])   # the tile's first start
        first[1:] = tid[1:] != tid[:-1]
        closed = torch.zeros_like(first)                 # the next start is in the tile
        closed[:-1] = ~first[1:]
        ln = torch.zeros_like(pos)
        ln[:-1] = pos[1:] - pos[:-1]
        lt = closed & (ln % 129 == 1)
        prev_lt = torch.zeros_like(lt)
        prev_lt[1:] = lt[:-1]
        prev_lt &= ~first
        opens = lt & ((ln >= 130) | (~first & ~prev_lt))
        segs = int(torch.where(closed, ln // 129 + (ln % 129 >= 2).to(torch.int64), 0).sum())
        lit, stretch = int(lt.sum()), int(opens.sum())
        last = ~closed                                   # the tile's last start
        f = torch.full((n_tiles,), -1, dtype=torch.int64, device=p.device)
        l = f.clone()
        f[tid[first]] = pos[first]
        l[tid[last]] = pos[last]
        needs_f = torch.zeros(n_tiles, dtype=torch.bool, device=p.device)
        needs_f[tid[first]] = lt[first] & (ln[first] < 130)
        plit_l = torch.zeros_like(needs_f)
        plit_l[tid[last]] = prev_lt[last]
        has = f >= 0

        def excl_max(v):
            c = torch.cummax(v, 0).values
            return torch.cat([c.new_zeros(1), c[:-1]]), int(c[-1])

        P = excl_max(torch.where(has, l + 1, 0))[0] - 1
        out_lit = torch.where(f != l, plit_l, (P >= 0) & ((f - P) % 129 == 1))
        ek, k_total = excl_max(torch.where(has, 2 * l + out_lit.to(torch.int64) + 1, 0))
        closes = has & (P >= 0)
        L = f - P
        r = L % 129
        lt_p = closes & (r == 1)
        segs += int(torch.where(closes, L // 129 + (r >= 2).to(torch.int64), 0).sum())
        lit += int(lt_p.sum())
        stretch += int((lt_p & ((L >= 130) | ((ek - 1) % 2 == 0))).sum())
        stretch += int((has & (f != l) & needs_f & ~lt_p).sum())
        Lz = n - (k_total - 1) // 2  # the run at the plane's last start
        segs += Lz // 129 + (Lz % 129 >= 2)
        if Lz % 129 == 1:
            lit += 1
            stretch += Lz >= 130 or (k_total - 1) % 2 == 0
        out.append(2 * segs + lit + stretch + lit // 128)
    return torch.tensor(out, dtype=torch.int32)


# ---------------------------------------------------------------------------
# the Huffman planes through H2
# ---------------------------------------------------------------------------


def fpl_pack_planes(planes: torch.Tensor, n: int, tables: dict) -> dict:
    """The Huffman planes' streams through H2: tables maps plane -> (code
    lengths, codes, total bits). Every one of a plane's n positions is
    live; its zero padding to whole groups adds no code. Returns plane ->
    (words int32 [ceil(bits / 32) + 1], the stream and its read-ahead pad
    word; sbits int32 [n_groups], each group's first bit)."""
    _check_planes(planes, n)
    if planes.shape[1] % device_huffman.GROUP:
        raise TypeError("planes must hold whole 64-symbol groups")
    out = {}
    for b, (lengths, codes, total_bits) in sorted(tables.items()):
        n_words = -(-total_bits // 32) + 1  # + the read-ahead pad word
        words, tb, sbits = device_huffman.encode_stream_device(
            planes[b], device_huffman.code_table(lengths, codes, planes.device), (n, n, n),
            n_words)
        if int(tb) != total_bits:
            raise RuntimeError("fpl pack: stream length differs from the histogram's")
        out[b] = (words, sbits)
    return out


# ---------------------------------------------------------------------------
# F3 restore
# ---------------------------------------------------------------------------


def fpl_restore(planes: torch.Tensor, h: int, w: int, d: int, pred: int, levels) -> torch.Tensor:
    """F3: [H, W, D] from the planes' first H * W * D bytes (uint8 [planes,
    >= n]; the kernel only reads them, so `planes` is left unchanged) at
    their levels under the predictor: float32 from four planes, float64
    from eight. On CUDA one pass over the planes (the level undo, the words,
    the row scan, the transform undone) and, under predictor 2, the column
    scan over the words."""
    n = h * w * d
    _check_planes(planes, n)
    n_pl = planes.shape[0]
    _check_choice(pred, levels, n_pl)
    if not build.on_cuda(planes):
        return fpl_restore_ref(planes, h, w, d, pred, levels)
    rows, cols = slice_shape(h, w, d)
    f64 = n_pl == N_PLANES64
    scratch = _ctypes_fn("fpl_restore_scratch", [_L, _L, _I, _I], ctypes.c_longlong)(
        n, rows, cols, 8 if f64 else 4)
    name = "fpl_restore_f64" if f64 else "fpl_restore"
    fn = _ctypes_fn(name, [_P, _L, _L, _L, _I, _I, _P, _P, _L, _P, _P])
    dev = planes.device
    with torch.cuda.device(dev):
        part = torch.empty(scratch, dtype=torch.uint8, device=dev)
        out = torch.empty(h, w, d, dtype=torch.float64 if f64 else torch.float32, device=dev)
        err = fn(planes.data_ptr(), planes.shape[1], n, rows, cols, pred, _levels_arg(levels),
                 part.data_ptr(), scratch, out.data_ptr(), build.launch_stream(planes))
        build.check(err, name)
    build.LAUNCHES[name] += 1
    return out


def _split_cumsum(img: torch.Tensor, axis: int) -> torch.Tensor:
    """(:218) mantissa and exponent+sign prefix sums apart, each wrapping."""
    mant = torch.cumsum(img & MANT, axis) & MANT
    hi = torch.cumsum(img >> 23, axis) & 0x1FF
    return mant | (hi << 23)


def _split_cumsum64(img: torch.Tensor, axis: int) -> torch.Tensor:
    """(:398) the 52-bit mantissas (as two 26-bit halves, so no int64 sum
    overflows) and the 12-bit exponents+signs of u64 words (int64 bits)
    summed apart, each wrapping."""
    m26 = (1 << 26) - 1
    lo = torch.cumsum(img & m26, axis)
    hi = torch.cumsum((img >> 26) & m26, axis)
    mant = (lo + ((hi & m26) << 26)) & MANT52
    top = torch.cumsum((img >> 52) & 0xFFF, axis) & 0xFFF
    return mant | (top << 52)


def fpl_restore_ref(planes: torch.Tensor, h: int, w: int, d: int, pred: int, levels):
    """Plain PyTorch version of F3, JAX's steps one by one."""
    rows, cols = slice_shape(h, w, d)
    n = rows * cols
    n_pl = planes.shape[0]
    word = torch.zeros(n, dtype=torch.int64, device=planes.device)
    for b in range(n_pl):
        p = planes[b, :n].to(torch.int64)
        for lev in range(int(levels[b]), 0, -1):  # restoreSequence
            p = p.clone()
            p[lev - 1:] = torch.cumsum(p[lev - 1:], 0) & 0xFF
        word |= p << (8 * b)
    img = word.view(rows, cols)
    cumsum = _split_cumsum64 if n_pl == N_PLANES64 else _split_cumsum
    if pred == 2:
        img = cumsum(img, 0)
    if pred >= 1:
        img = cumsum(img, 1)
    if n_pl == N_PLANES64:
        return img.reshape(-1).view(torch.float64).view(h, w, d)
    bits = undo_float_transform(img.reshape(-1))
    return ((bits + 2**31) % 2**32 - 2**31).to(torch.int32).view(torch.float32).view(h, w, d)
