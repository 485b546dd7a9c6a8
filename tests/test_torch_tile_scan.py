"""Port parity for the band decoder's host record scanner: the compiled
``tile_scan`` (kernels/tile_scan.cpp, built with the host compiler) and the
plain ``tile_scan_ref`` vs the JAX package's ``lerc_tpu.native.tile_scan``
on the same tile streams -- all-valid, masked and edge blocks, 8x8 and
16x16, LUT and depth-diff records, from the port's band encoder and from the
host BandEncoder -- and their refusals of corrupt streams.

Criteria (exact): the eight descriptor fields of every record and the bytes
consumed equal; each corruption the native scanner refuses raises ValueError
in both.
"""
import shutil
import struct

import numpy as np
import pytest
import torch

from lerc_tpu import native
from lerc_tpu.codec.lerc2_encode import BandEncoder
from lerc_tpu_torch.codec import device_codec, header as hdr, rle
from lerc_tpu_torch.codec.bitmask import bits_to_bool
from lerc_tpu_torch.constants import DT_SIZE
from lerc_tpu_torch.kernels import build
from lerc_tpu_torch.ops import tile_scan as ts

H, W = 48, 41


def make(dtype, d=1, h=H, w=W):
    x, y = np.meshgrid(np.linspace(0, 10, w), np.linspace(0, 8, h))
    base = np.stack([np.sin(x + i) * np.cos(y) * 100.0 + x * y for i in range(d)], -1)
    return np.round(base).astype(dtype) if np.issubdtype(dtype, np.integer) else base.astype(dtype)


MASK = np.random.default_rng(0).random((H, W)) > 0.3


def class_grid():
    rng = np.random.default_rng(9)
    classes = np.array([100, 2000, 35000, 41000, 52000], np.int32)
    patch = rng.integers(0, 5, (8, 8))
    g = classes[np.repeat(np.repeat(patch, 12, 0), 12, 1)]
    return (g + rng.integers(0, 3, (96, 96))).astype(np.int32)[:, :, None]


def low_rate():
    rng = np.random.default_rng(3)
    base = np.full((128, 192), 100.0)
    base[:, :128] += 0.6 * rng.integers(0, 2, (128, 128))
    return base.astype(np.float32)[:, :, None]


def tile_section(blob: bytes):
    """(tile stream uint8, mask, header) of a tiling blob."""
    src = memoryview(blob)
    head, pos = hdr.read_header(src)
    n_mask = struct.unpack_from("<i", src, pos)[0]
    pos += 4
    if 0 < head.num_valid_pixel < head.n_rows * head.n_cols:
        mask = bits_to_bool(rle.decompress(src[pos:pos + n_mask],
                                           (head.n_rows * head.n_cols + 7) // 8),
                            head.n_cols, head.n_rows)
    else:
        mask = np.full((head.n_rows, head.n_cols), head.num_valid_pixel > 0)
    pos += n_mask
    if head.version >= 4:
        pos += 2 * head.n_depth * DT_SIZE[head.dt]
    assert src[pos] == 0, "one-sweep blob"
    pos += 1
    if head.try_huffman_int() or head.try_huffman_flt():
        assert src[pos] == 0, "not a tiling blob"
        pos += 1
    return np.frombuffer(src[pos:head.blob_size], np.uint8).copy(), mask, head


STREAMS = {
    "f32": lambda: device_codec.encode_band_device(make(np.float32), None, 0.001, device="cpu"),
    "f32-mask": lambda: device_codec.encode_band_device(make(np.float32), MASK, 0.05,
                                                        device="cpu"),
    "i16-d3-diff": lambda: device_codec.encode_band_device(make(np.int16, 3), MASK, 0.5,
                                                           device="cpu"),
    "u16-v3": lambda: device_codec.encode_band_device(make(np.uint16), MASK, 0.5, version=3,
                                                      device="cpu"),
    "i32-lut": lambda: device_codec.encode_band_device(class_grid(), None, 0.5, device="cpu"),
    "f32-16x16": lambda: device_codec.encode_band_device(low_rate(), None, 0.3, device="cpu"),
    "host-lut-f32": lambda: BandEncoder(
        ((np.floor(np.meshgrid(np.linspace(0, 10, W), np.linspace(0, 8, H))[0] * 2)
          + np.floor(np.meshgrid(np.linspace(0, 10, W), np.linspace(0, 8, H))[1] * 3)) * 10)
        .astype(np.float32)[:, :, None], None, 0.5).encode(),
    "host-16x16-mask": lambda: BandEncoder(low_rate(), np.random.default_rng(4).random(
        (128, 192)) > 0.05, 0.3).encode(),
}


def _scan_all(stream, mask, head):
    cnts, j0s, n_blocks = ts.block_scan_inputs(mask, head.micro_block_size)
    args = (stream, cnts, j0s, n_blocks, head.n_depth, int(head.dt), head.version)
    return args, ts.tile_scan_ref(*args), native.tile_scan(*args)


def _has_cxx():
    if not shutil.which("c++"):
        pytest.skip("no host compiler: the compiled scanner cannot be built here")


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_scanners_match_the_native_scanner(name):
    stream, mask, head = tile_section(STREAMS[name]())
    args, (recs_r, used_r), (recs_n, used_n) = _scan_all(stream, mask, head)
    assert used_r == used_n == stream.size
    assert recs_r.tobytes() == recs_n.tobytes()
    _has_cxx()
    recs_c, used_c = ts.tile_scan(*args)
    assert used_c == used_n and recs_c.tobytes() == recs_n.tobytes()
    modes = recs_n["mode"]
    if name in ("i32-lut", "host-lut-f32"):
        assert (modes % 8 == 4).any()
    if name == "i16-d3-diff":
        assert (modes >= 8).any()
    if "16x16" in name:
        assert head.micro_block_size == 16


def test_block_scan_inputs_count_edge_blocks():
    mask = np.ones((20, 13), bool)
    mask[0, 0] = False
    cnts, j0s, n = ts.block_scan_inputs(mask, 8)
    assert n == 3 * 2
    np.testing.assert_array_equal(cnts, [63, 40, 64, 40, 32, 20])
    np.testing.assert_array_equal(j0s, [0, 8, 0, 8, 0, 8])
    cnts16, j0s16, n16 = ts.block_scan_inputs(mask, 16)
    assert n16 == 2 and cnts16.tolist() == [16 * 13 - 1, 4 * 13] and j0s16.tolist() == [0, 0]


def _corruptions():
    """(label, stream, mask, head) of corrupt variants of two streams."""
    out = []
    stream, mask, head = tile_section(STREAMS["i16-d3-diff"]())
    out.append(("truncated", stream[:-3], mask, head))
    bad = stream.copy()
    bad[0] ^= 0b1000  # an integrity bit of block 0 (j0 = 0)
    out.append(("integrity bits", bad, mask, head))
    diff0 = stream.copy()
    diff0[0] |= 4  # a diff record on depth slice 0
    out.append(("diff on slice 0", diff0, mask, head))
    lstream, lmask, lhead = tile_section(STREAMS["i32-lut"]())
    out.append(("truncated LUT stream", lstream[: lstream.size // 2], lmask, lhead))
    return out


@pytest.mark.parametrize("case", range(4))
def test_scanners_refuse_corrupt_streams(case):
    label, stream, mask, head = _corruptions()[case]
    cnts, j0s, n_blocks = ts.block_scan_inputs(mask, head.micro_block_size)
    args = (stream, cnts, j0s, n_blocks, head.n_depth, int(head.dt), head.version)
    with pytest.raises(ValueError):
        native.tile_scan(*args)
    with pytest.raises(ValueError, match="corrupt"):
        ts.tile_scan_ref(*args)
    _has_cxx()
    with pytest.raises(ValueError, match="corrupt"):
        ts.tile_scan(*args)


def test_scanner_counts_its_launches_and_checks_its_inputs():
    stream, mask, head = tile_section(STREAMS["f32"]())
    cnts, j0s, n_blocks = ts.block_scan_inputs(mask, 8)
    with pytest.raises(ValueError, match="blocks"):
        ts.tile_scan_ref(stream, cnts[:-1], j0s, n_blocks, 1, int(head.dt), head.version)
    _has_cxx()
    build.reset_launches()
    ts.tile_scan(stream, cnts, j0s, n_blocks, 1, int(head.dt), head.version)
    ts.tile_scan_ref(stream, cnts, j0s, n_blocks, 1, int(head.dt), head.version)
    assert build.LAUNCHES["tile_scan"] == 1  # the plain version counts no launch


def test_band_decode_on_the_cpu_scans_with_the_plain_version(monkeypatch):
    """device="cpu" takes tile_scan_ref; the compiled scanner is the CUDA
    path's."""
    calls = []
    monkeypatch.setattr(ts, "tile_scan", lambda *a: calls.append(a) or (_ for _ in ()).throw(
        AssertionError("compiled scanner on the CPU path")))
    blob = STREAMS["f32-mask"]()
    out = device_codec.decode_band_device(blob, device="cpu")
    assert out.data.device.type == "cpu" and not calls
    assert torch.isfinite(out.data).all()
