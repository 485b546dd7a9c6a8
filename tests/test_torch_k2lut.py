"""The LUT K2 (``write_records_lut``; its plain version
``write_records_ref(..., lut=True)``) on crafted tiles.

The kernel writes a LUT record from the set of its distinct non-zero
quanta: a bitmap where nb is at most 12 (``K2L_BITMAP_NB`` in
kernels/encode.cu), an ordered list past it. The first test holds the
plain version, as the band codec (``encode_tiles``) and the mosaic
(``encode_tiles_batched``) call it, byte for byte to JAX's
``encode_tiles(..., enable_lut=True, mb=...)`` on two of
chip_smoke.k2lut_tiles' three tiles, whose LUT records take both paths:
n_lut on both sides of the LUT/stuffed tie at nb 2-16 and a few values
spread up to 2^9, 2^14 and 2^21, on an aligned all-valid 8x8 tile (no
validity words reach K2); a stack of two masked int16 tiles (its first
slice: the tile is depth 2, its second slice taking the depth-diff LUT in
the stand-in test; test_torch_k1lut.py's depth-3 case holds diff LUT
records to JAX). The third, masked 16x16 blocks of 63, 255 and 256 values,
goes to the stand-in only: test_torch_k1lut.py holds such blocks to JAX. The second test runs the CUDA sources of the
redesigned LUT K2 and F2 (``fpl_finalize``) on the CPU (tools/cuda_standin)
against their plain versions, with their inputs and F2's planes ending at
a page with no access: a byte read or written past them kills the process.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lerc_tpu.constants import DataType as JDT
from lerc_tpu.ops import device_encode as jenc
from lerc_tpu_torch.constants import DataType
from lerc_tpu_torch.ops import device_encode as enc

JDTS = {DataType.INT: JDT.INT, DataType.USHORT: JDT.USHORT, DataType.SHORT: JDT.SHORT}


def _jax_stream(data, mask, dt, mb):
    h, w, d = data.shape
    cap = -(-(h * w * d * 4 + 4096) // 512) * 512  # JAX packs rows of 128 words
    out, total, *_ = jenc.encode_tiles(
        jnp.asarray(data), None if mask is None else jnp.asarray(mask), jnp.float32(0.5), h, w,
        d, JDTS[dt], mask is None, 6, cap, enable_lut=True, mb=mb)
    return np.asarray(out)[:int(total)].tobytes()


JAX_TILES = (0, 2)  # the masked 16x16 tile's blocks are test_torch_k1lut.py's (JAX compiles)


@pytest.mark.parametrize("i", JAX_TILES, ids=[chip_smoke.k2lut_tiles()[i][0] for i in JAX_TILES])
def test_plain_k2_matches_jax(i):
    tag, data, dt, mask, mb, n_t = chip_smoke.k2lut_tiles()[i]
    h, w, d = data.shape
    x = torch.from_numpy(data)
    p = enc.encode_params(0.5, 6, 0, dt, mb)
    valid = None if mask is None else enc.block_valid_words(torch.from_numpy(mask), mb)
    desc = enc.encode_blocks_ref(x, p, valid, mb, True)[0][:, 1]
    lut = ((desc >> 11) & 1) == 1
    nb = (desc >> 16) & 0xFF
    assert int(lut.sum()) > 0, tag
    if i == 0:  # both of the kernel's paths, and no validity words in the call
        assert bool((lut & (nb <= 12)).any()) and bool((lut & (nb > 12)).any()), tag
        assert enc._lut_args(x, p, None, mb, True) == "_lut_int"
    if i == 2:  # the diff LUT records the stand-in test runs through the kernel
        assert bool((lut & (((desc >> 10) & 1) == 1)).any()), tag
    if n_t == 1:  # the band codec's call
        stream, total, *_ = enc.encode_tiles(x, valid, 0.5, h, w, d, dt, mask is None, 6,
                                             h * w * d * 4 + 4096, enable_lut=True, mb=mb)
        got = stream.numpy().view(np.uint8)[:int(total)].tobytes()
        assert got == _jax_stream(data, mask, dt, mb), tag
        return
    # the mosaic's call: a stack of masked tiles, each JAX-encoded alone, at
    # depth 1 (JAX compiles a depth-2 encode for ~15 s; its diff LUT records
    # are test_torch_k1lut.py's depth-3 case and the stand-in test's below)
    data = np.ascontiguousarray(data[:, :, :1])
    th = h // n_t
    tm = mask.reshape(n_t, th, w)
    stream, bases, totals, *_ = enc.encode_tiles_batched(
        torch.from_numpy(data).reshape(n_t, th, w, 1), torch.from_numpy(tm), 0.5, dt, 6, mb)
    raw = stream.numpy().view(np.uint8)
    for t in range(n_t):
        want = _jax_stream(data[t * th:(t + 1) * th], tm[t], dt, mb)
        assert raw[int(bases[t]):int(bases[t]) + int(totals[t])].tobytes() == want, (tag, t)


STANDIN_RUN = r"""
import ctypes, mmap, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/tools/cuda_standin")
import standin
import chip_smoke
from lerc_tpu_torch.kernels import build
from lerc_tpu_torch.ops import device_encode as enc
from lerc_tpu_torch.ops import device_fpl as F

libs = standin.build(["encode", "fpl"], out=standin.OUT / "k2lut_f2", opt="-O0")
standin.install(libs, ["write_records"])
page = mmap.PAGESIZE
libc = ctypes.CDLL(None, use_errno=True)
libc.mprotect.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]


def at_page_end(nbytes):
    # nbytes of writable memory that end where a page with no access begins
    pages = -(-nbytes // page)
    buf = mmap.mmap(-1, (pages + 1) * page)
    base = ctypes.addressof(ctypes.c_char.from_buffer(buf))
    assert libc.mprotect(base + pages * page, page, 0) == 0
    keep.append(buf)
    return np.frombuffer(buf, np.uint8, count=pages * page)[pages * page - nbytes:]


keep = []
for tag, data, dt, mask, mb, n_t in chip_smoke.k2lut_tiles():
    h, w, d = data.shape
    x = torch.from_numpy(at_page_end(data.nbytes).view(np.int32).reshape(data.shape))
    x.copy_(torch.from_numpy(data))
    p = enc.encode_params(0.5, 6, 0, dt, mb)
    variants = [None] if mask is None else []
    if mask is not None:
        words = enc.block_valid_words(torch.from_numpy(mask), mb)
        v = torch.from_numpy(at_page_end(words.numel() * 4).view(np.int32).reshape(words.shape))
        v.copy_(words)
        variants.append(v)
    for valid in variants:
        rk = enc.encode_blocks_ref(x, p, valid, mb, True)[0]
        length = rk[:, 0]
        starts = torch.cumsum(length, 0, dtype=torch.int32) - length
        cap_w = (int(length.sum()) + 64) // 4
        build.LAUNCHES["write_records_lut_int"] = build.LAUNCHES["write_records_lut16_int"] = 0
        got = enc.write_records(x, rk, starts, cap_w, p, valid, mb, True)
        assert sum(build.LAUNCHES[k] for k in ("write_records_lut_int",
                                               "write_records_lut16_int")) == 1, tag
        assert torch.equal(got, enc.write_records_ref(x, rk, starts, cap_w, p, valid, mb, True)), tag
        print("ok K2", tag, flush=True)

fn = build.library("fpl").fpl_finalize
fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
fn64 = build.library("fpl").fpl_finalize_f64
fn64.argtypes = fn.argtypes
rng = np.random.default_rng(5)
for kind, f, levels in ((np.float32, fn, (1, 2, 0, 5)), (np.float64, fn64, (5, 4, 3, 2, 1, 0, 1, 2))):
    for h, w, d, pred in ((1, 1, 1, 0), (3, 5, 1, 1), (7, 3, 2, 2), (61, 47, 1, 2), (1, 2049, 1, 1)):
        n = h * w * d
        vals = (100.0 + np.cumsum(rng.normal(0, 0.01, n))).astype(kind).reshape(h, w, d)
        x = torch.from_numpy(at_page_end(vals.nbytes).view(kind).reshape(h, w, d))
        x.copy_(torch.from_numpy(vals))
        pstride = F.padded(n)
        planes = at_page_end(len(levels) * pstride)
        planes[:] = 0xA5
        histos = np.zeros((len(levels), 256), np.int32)
        lv = (ctypes.c_int * len(levels))(*levels)
        err = f(x.data_ptr(), n, w if d == 1 else d, pred, lv, planes.ctypes.data, pstride,
                histos.ctypes.data, None)
        assert err == 0, err
        pr, hr = F.fpl_finalize_ref(x, pred, levels)
        assert np.array_equal(planes.reshape(len(levels), pstride), pr.numpy()), (kind, h, w, d)
        assert np.array_equal(histos, hr.numpy()), (kind, h, w, d)
        print("ok F2", np.dtype(kind).name, n, flush=True)
"""


def test_standin_k2lut_and_f2_stay_inside_their_buffers():
    """The CUDA sources of the LUT K2 (encode.cu) and F2 (fpl.cu), built for
    the CPU stand-in, against their plain versions: K2 on the three tiles
    with and without validity words (the wrapper's launch counted),
    F2 at odd n, predictors 0-2, every level, float32 and float64, its
    planes filled with 0xA5 first (every byte, the zero tail too, must be
    written). Inputs, validity words and planes end at a page with no
    access; a subprocess of its own, so a stray access fails the test."""
    root = str(Path(__file__).resolve().parents[1])
    r = subprocess.run([sys.executable, "-c", STANDIN_RUN, root], capture_output=True, text=True,
                       timeout=600, cwd=root)
    assert r.returncode == 0, (r.returncode, r.stdout[-2000:], r.stderr[-4000:])
    assert r.stdout.count("ok K2") == 3 and r.stdout.count("ok F2") == 10, r.stdout
