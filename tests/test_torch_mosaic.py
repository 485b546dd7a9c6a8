"""Port parity for the tile mosaic (``lerc_tpu_torch.parallel.sharding``,
device="cpu": the kernels' plain versions) against JAX's
``lerc_tpu.parallel.sharding`` on its 4-device CPU mesh, mirroring
``tests/test_sharding.py``.

Criteria (exact): the port's container byte-equal to JAX's
``MosaicEncoder(make_mesh(4))`` -- float32, int16, uint8 x3, LUT and 16x16
rasters, masked and ragged edges, multi-band with shared and per-band masks,
``encode_streamed``, float64 on data without half-step ties; its
``decode_mosaic_device``, ``decode_mosaic_region`` and ``decode_mosaic``
bit-equal to JAX's host ``decode_mosaic``; lossy decodes within maxZError.
Where JAX is at fault (ROADMAP queue 3) the test records JAX's output and
holds the port to the host decoder: ``test_jax_mosaic_*_fault``. A
two-process gloo run encodes byte-identically to one rank and decodes
equal to it.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from lerc_tpu.codec import device_codec as JC
from lerc_tpu.codec import lerc2_decode
from lerc_tpu.codec.lerc2_encode import BandEncoder
from lerc_tpu.parallel import sharding as J
from lerc_tpu_torch import decode_band_device
from lerc_tpu_torch.ops import device_decode
from lerc_tpu_torch.parallel import sharding as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MESH = []


def _jax_mesh():
    if not _MESH:
        _MESH.append(J.make_mesh(4))
    return _MESH[0]


def _raster(h, w, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 9, w)[None, :, None]
    y = np.linspace(0, 7, h)[:, None, None]
    return (800 * np.exp(-((x - 5) ** 2 + (y - 3) ** 2) / 6)
            + 30 * np.sin(x + y) + 0.2 * rng.standard_normal((h, w, 1))).astype(np.float32)


def _noise_quads(h, w, tile, hi, seed):
    """100.0 with a 16x16 patch of integer noise in [0, hi) at each tile's
    corner: low bit rates that take the 16x16 retrial."""
    rng = np.random.default_rng(seed)
    data = np.full((h, w, 1), 100.0, np.float32)
    for r0 in range(0, h, tile):
        for c0 in range(0, w, tile):
            data[r0:r0 + 16, c0:c0 + 16, 0] += rng.integers(0, hi, (16, 16))
    return data


def _lut_raster(h, w, seed=11):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 40, (h // 8, w // 8)).astype(np.float32) * 500
    data = np.repeat(np.repeat(base, 8, 0), 8, 1)[:, :, None]
    return data + rng.choice([0, 200.0, 450.0], (h, w, 1), p=[0.8, 0.1, 0.1])


def _correlated(np_dt, h=64, w=64, seed=1):
    """Three band-correlated slices: slices 1-2 are slice 0 plus noise."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 200, (h, w, 1))
    return np.concatenate([base, base + rng.integers(0, 3, (h, w, 1)),
                           base + rng.integers(0, 5, (h, w, 1))], 2).astype(np_dt)


def _masks3(h, w):
    masks = np.ones((3, h, w), bool)
    masks[0, :10, :30] = False
    masks[2, 40:, 20:50] = False
    return masks


def _bands(h, w):
    rng = np.random.default_rng(21)
    return np.stack([_raster(h, w, seed=1)[:, :, 0], _raster(h, w, seed=2)[:, :, 0] * 3 + 100,
                     rng.normal(0, 10, (h, w)).astype(np.float32).cumsum(axis=1)])[..., None]


def _hole(h, w, r=(10, 20), c=(15, 40)):
    mask = np.ones((h, w), bool)
    mask[r[0]:r[1], c[0]:c[1]] = False
    return mask


CASES = {  # id -> (data, mask, maxZError, dtype, tile, depth, try_16)
    "f32-roundtrip": lambda: (_raster(64, 64), None, 0.005, np.float32, 32, 1, True),
    "f32-masked-ragged": lambda: (_raster(100, 90, seed=2), _hole(100, 90), 0.01, np.float32,
                                  32, 1, False),
    "int16": lambda: ((_raster(64, 64, seed=3) * 10).astype(np.int16), None, 0.5, np.int16, 32,
                      1, False),
    "uint8x3": lambda: (_correlated(np.uint8), None, 0.5, np.uint8, 32, 3, False),
    "lut": lambda: (_lut_raster(64, 64), None, 0.001, np.float32, 32, 1, False),
    "16x16": lambda: (_noise_quads(64, 64, 32, 2, seed=3), None, 0.5, np.float32, 32, 1, True),
    "multiband-shared-mask": lambda: (_bands(64, 64), _hole(64, 64, (5, 20), (30, 60)), 0.01,
                                      np.float32, 32, 1, True),
    "multiband-per-band-masks": lambda: (_bands(64, 64), _masks3(64, 64), 0.005, np.float32, 32,
                                         1, True),
    "f64": lambda: (np.random.default_rng(21).normal(1e7, 1e3, (64, 64, 1)), None, 0.25,
                    np.float64, 32, 1, True),
}
_CONTAINERS = {}


def _containers(name):
    """(data, mask, maxZError, JAX's container, the port's), each made once."""
    if name not in _CONTAINERS:
        data, mask, mze, np_dt, tile, d, try_16 = CASES[name]()
        jblob = J.MosaicEncoder(_jax_mesh(), tile, tile, np_dt, n_depth=d,
                                try_16=try_16).encode(data, mask, mze)
        blob = P.MosaicEncoder(None, tile, tile, np_dt, n_depth=d, try_16=try_16,
                               device="cpu").encode(data, mask, mze)
        _CONTAINERS[name] = (data, mask, mze, jblob, blob)
    return _CONTAINERS[name]


def _valid(data, mask):
    """Per-pixel validity in the shape of the decode ([B,] H, W)."""
    shape = data.shape[:-1]
    if mask is None:
        return np.ones(shape, bool)
    return np.broadcast_to(mask, shape)


def _n_lut_records(info, views) -> int:
    """LUT records of single-band float32 tiles: stuffed (mode 1) records
    whose numBits byte has bit 5 set."""
    n = 0
    for t, v in enumerate(views):
        so = int(info["stream_offs"][t])
        if so < 0:
            continue
        for s in info["starts"][t]:
            if s < 0:
                break
            flag = v[so + s]
            b67 = flag >> 6
            off_w = 1 if b67 == 2 else 2 if b67 == 1 else 4
            n += flag & 3 == 1 and v[so + s + 1 + off_w] & 32 != 0
    return n


def _assert_decodes_like_the_host(blob):
    host = J.decode_mosaic(blob)
    np.testing.assert_array_equal(P.decode_mosaic_device(blob, device="cpu"), host)
    np.testing.assert_array_equal(P.decode_mosaic(blob, device="cpu"), host)
    return host


@pytest.mark.parametrize("name", sorted(CASES))
def test_container_matches_jax_and_decodes_like_the_host(name):
    data, mask, mze, jblob, blob = _containers(name)
    assert blob == jblob
    host = _assert_decodes_like_the_host(blob)
    sel = _valid(data, mask)
    err = np.abs(host.astype(np.float64) - data.astype(np.float64))[sel]
    lossless = np.issubdtype(data.dtype, np.integer)
    # float32 values themselves round near a bin's edge (test_sharding.py's 1.01)
    assert err.max() <= (0 if lossless else mze * (1.01 if data.dtype == np.float32 else 1))
    assert (host[~sel] == 0).all()


@pytest.mark.parametrize("name,want", [("16x16", 16), ("lut", 8)])
def test_16x16_and_lut_tiles_stay_on_k4(name, want, monkeypatch):
    """The rasters of test_mosaic_16x16_tiles_device_decode and
    test_mosaic_lut_tiles_device_decode: 16x16 tiles, LUT records, and one
    K4 call per micro-block group; no tile takes the scanned decode."""
    _data, _mask, _mze, _jblob, blob = _containers(name)
    info, views = P.read_mosaic(blob)
    heads = [P._tile_band_layouts([v], 1)[0][0][1] for v in views]
    assert {h.micro_block_size for h in heads} == {want}
    if name == "lut":  # LUT records really are there
        assert _n_lut_records(info, views) > 0
    calls = []
    real = device_decode.decode_tiles_fast
    monkeypatch.setattr(P.device_decode, "decode_tiles_fast",
                        lambda *a, **k: (calls.append(k["mb"]), real(*a, **k))[1])
    monkeypatch.setattr(P, "_decode_tile_blob", lambda *a, **k: pytest.fail("scanned decode"))
    out = P.decode_mosaic_device(blob, device="cpu")
    assert calls == [want]
    np.testing.assert_array_equal(out, J.decode_mosaic(blob))


def test_masked_ragged_tiles_and_region_stay_on_k4(monkeypatch):
    _data, _mask, _mze, _jblob, blob = _containers("f32-masked-ragged")
    host = J.decode_mosaic(blob)
    monkeypatch.setattr(P, "_decode_tile_blob", lambda *a, **k: pytest.fail("scanned decode"))
    np.testing.assert_array_equal(P.decode_mosaic_device(blob, device="cpu"), host)
    np.testing.assert_array_equal(P.decode_mosaic_region(blob, 10, 70, 40, 90, device="cpu"),
                                  host[10:70, 40:90])


def test_region_decode_and_multiband_region():
    _data, _mask, _mze, _jblob, blob = _containers("f32-roundtrip")
    host = J.decode_mosaic(blob)
    for win in ((3, 9, 4, 30), (10, 60, 20, 50), (-5, 200, 31, 33)):
        r0, r1, c0, c1 = win
        want = host[max(r0, 0):min(r1, 64), max(c0, 0):min(c1, 64)]
        for indexed in (True, False):
            np.testing.assert_array_equal(
                P.decode_mosaic_region(blob, r0, r1, c0, c1, indexed, device="cpu"), want)
    with pytest.raises(ValueError, match="empty region"):
        P.decode_mosaic_region(blob, 10, 10, 0, 5, device="cpu")
    _data, _mask, _mze, _jblob, mblob = _containers("multiband-shared-mask")
    reg = P.decode_mosaic_region(mblob, 15, 60, 20, 50, device="cpu")
    assert reg.shape == (3, 45, 30, 1)
    np.testing.assert_array_equal(reg, J.decode_mosaic(mblob)[:, 15:60, 20:50])


def test_global_ranges_and_mask_reuse():
    data, _mask, _mze, _jblob, blob = _containers("f32-roundtrip")
    info, _ = P.read_mosaic(blob)
    assert info["z_min"] <= float(data.min()) + 0.005 and info["z_max"] >= float(data.max()) - 0.005
    # a shared mask: bands 1 and 2 of a masked tile reuse band 0's mask section
    _data, _mask, _mze, _jblob, mblob = _containers("multiband-shared-mask")
    info, views = P.read_mosaic(mblob)
    assert info["n_bands"] == 3
    from lerc_tpu_torch.codec import header as hdr

    reused = 0
    for t, lay in enumerate(P._tile_band_layouts(views, 3)):
        sizes = [int.from_bytes(views[t][b + hdr.header_size(hd.version):][:4], "little",
                                signed=True) for b, hd in lay]
        if 0 < lay[0][1].num_valid_pixel < 32 * 32:
            assert sizes[0] > 0 and sizes[1] == sizes[2] == 0
            reused += 1
    assert reused


def test_streamed_encode_matches_whole():
    h, w = 80, 96  # a ragged last band
    data = _raster(h, w, seed=10)
    mask = _hole(h, w, (5, 20), (40, 70))
    enc = P.MosaicEncoder(None, 32, 32, np.float32, device="cpu")
    whole = enc.encode(data, mask, 0.01)
    streamed = enc.encode_streamed(lambda i: data[i * 32:min((i + 1) * 32, h)], h, w, 0.01,
                                   mask_provider=lambda i: mask[i * 32:min((i + 1) * 32, h)])
    assert streamed == whole
    jenc = J.MosaicEncoder(_jax_mesh(), 32, 32, np.float32)
    assert whole == jenc.encode_streamed(lambda i: data[i * 32:min((i + 1) * 32, h)], h, w, 0.01,
                                         mask_provider=lambda i: mask[i * 32:min((i + 1) * 32, h)])
    _assert_decodes_like_the_host(streamed)


def test_tampered_index_raises_and_unported_versions_name_item_12():
    _data, _mask, _mze, _jblob, blob = _containers("f32-roundtrip")
    info, _ = P.read_mosaic(blob)
    n_units = 4
    at = len(blob) - sum(len(v) for v in P.read_mosaic(blob)[1]) - 4 * n_units * info["starts"].shape[1]
    bad = bytearray(blob)
    pos = at + 4 * 5  # unit 0, record 5
    bad[pos:pos + 4] = (int.from_bytes(bad[pos:pos + 4], "little") + 1).to_bytes(4, "little")
    with pytest.raises(ValueError, match="index inconsistent"):
        P.decode_mosaic_device(bytes(bad), device="cpu")
    np.testing.assert_array_equal(P.decode_mosaic(bytes(bad), device="cpu"),
                                  J.decode_mosaic(blob))
    bad = bytearray(blob)
    bad[-3] ^= 0x40
    with pytest.raises(ValueError, match="checksum"):
        P.decode_mosaic_device(bytes(bad), device="cpu")
    with pytest.raises(NotImplementedError, match="host codec"):  # item 12 landed: its message
        P.MosaicEncoder(None, 32, 32, np.float32, version=2, device="cpu").encode(
            _raster(32, 32), None, 0.01)


# ---------------------------------------------------------------------------
# JAX faults (ROADMAP queue 3): JAX's output recorded, the port held to the
# host decoder
# ---------------------------------------------------------------------------


def test_jax_mosaic_single_unit_group_fault():
    """A micro-block group of one unit: JAX's decode_tiles_fast(n_tiles=1)
    returns [H, W, D] and the batched decode takes its row 0 as the image
    (sharding.py:663, :724-726)."""
    data = _raster(128, 128, seed=0)  # (the port's containers: JAX's encoder writes the same)
    blob = P.MosaicEncoder(None, 128, 128, np.float32, try_16=False,
                           device="cpu").encode(data, None, 0.01)
    host = J.decode_mosaic(blob)
    assert (J.decode_mosaic_device(blob) != host).sum() > 16000  # JAX: 16,256 of 16,384
    np.testing.assert_array_equal(_assert_decodes_like_the_host(blob), host)
    # four 64x64 tiles: a window inside tile 0 is a group of one unit
    blob = P.MosaicEncoder(None, 64, 64, np.float32, try_16=False,
                           device="cpu").encode(data, None, 0.01)
    with pytest.raises(IndexError):
        J.decode_mosaic_region(blob, 0, 10, 0, 10)
    np.testing.assert_array_equal(P.decode_mosaic_region(blob, 0, 10, 0, 10, device="cpu"),
                                  J.decode_mosaic(blob)[:10, :10])


def test_jax_mosaic_wide_16x16_fault():
    """16x16 records wider than 11 bits: JAX's decode_tiles_fast clears
    `fits` (device_decode.py:118-123) and the batched decode uses the image
    anyway (sharding.py:707-718)."""
    data = _noise_quads(128, 128, 64, 4096, seed=4)
    blob = P.MosaicEncoder(None, 64, 64, np.float32, device="cpu").encode(data, None, 0.5)
    info, views = P.read_mosaic(blob)
    assert all(P._tile_band_layouts([v], 1)[0][0][1].micro_block_size == 16 for v in views)
    host = J.decode_mosaic(blob)
    wrong = J.decode_mosaic_device(blob) != host
    assert wrong.sum() > 0  # JAX: 75 pixels, max error 4050
    np.testing.assert_array_equal(_assert_decodes_like_the_host(blob), host)
    assert np.abs(host.astype(np.float64) - data).max() <= 0.5


@pytest.mark.parametrize("np_dt", [np.uint8, np.int16])
def test_jax_mosaic_depth_diff_fault(np_dt):
    """Depth-diff integer tiles: JAX's batched decode has no diff chain and
    raises; the port's K4 adds the chain and decodes the units itself
    (test_depth_diff_units_stay_on_k4)."""
    data = _correlated(np_dt)
    blob = P.MosaicEncoder(None, 32, 32, np_dt, n_depth=3, device="cpu").encode(data, None, 0.5)
    if np_dt == np.uint8:  # JAX's encoder writes the same container
        assert blob == _containers("uint8x3")[3]
    with pytest.raises(ValueError, match="index inconsistent"):
        J.decode_mosaic_device(blob)
    np.testing.assert_array_equal(_assert_decodes_like_the_host(blob), data)


@pytest.mark.parametrize("np_dt", [np.uint8, np.int16])
def test_depth_diff_units_stay_on_k4(np_dt, monkeypatch):
    """The correlated three-band rasters: every unit holds depth-diff records
    and K4's chain decodes them; no unit goes to the scanned decode, and the
    decode equals the host's."""
    data = _correlated(np_dt)
    blob = P.MosaicEncoder(None, 32, 32, np_dt, n_depth=3, device="cpu").encode(data, None, 0.5)
    info, views = P.read_mosaic(blob)
    so, st = int(info["stream_offs"][0]), info["starts"][0]
    assert sum(views[0][so + s] & 4 != 0 for s in st if s >= 0) > 10  # diff records
    monkeypatch.setattr(P, "_decode_tile_blob", lambda *a, **k: pytest.fail("scanned decode"))
    out = P.decode_mosaic_device(blob, device="cpu")
    np.testing.assert_array_equal(out, J.decode_mosaic(blob))
    np.testing.assert_array_equal(out, data)


@pytest.mark.parametrize("np_dt,lo", [(np.int32, 2**25 + 1), (np.uint32, 3_000_000_001)])
def test_jax_mosaic_integer_range_fault(np_dt, lo):
    """Integer ranges through float32 (sharding.py:111, :469-473) and uint32
    encoded as int32 (:365): the host decoder reads JAX's lossless blobs
    wrong; the port keeps the ranges in int64."""
    rng = np.random.default_rng(5)
    data = (lo + rng.permutation(4096).reshape(64, 64, 1) % 1002).astype(np_dt)
    jblob = J.MosaicEncoder(_jax_mesh(), 32, 32, np_dt, try_16=False).encode(data, None, 0.5)
    blob = P.MosaicEncoder(None, 32, 32, np_dt, try_16=False, device="cpu").encode(data, None,
                                                                                   0.5)
    jhost = J.decode_mosaic(jblob)
    assert (jhost != data).sum() > 0  # JAX: int32 4 of 4,096 pixels, uint32 all
    host = _assert_decodes_like_the_host(blob)
    np.testing.assert_array_equal(host, data)
    info, _ = P.read_mosaic(blob)
    assert (info["z_min"], info["z_max"]) == (float(data.min()), float(data.max()))


def test_uint32_tile_straddling_2_31_repair():
    """Port fault P5: the tile-batched K1 merged uint32 tile ranges as int32
    bits (signed order), so a tile with values on both sides of 2^31 got
    zMax < zMin and its values above 2^31 decoded wrong under the clamp.
    Column 20 on is 1000 higher: tile 0 has 8x8 blocks below 2^31, one
    across it (cols 16-23) and one above; tile 1 lies above."""
    rng = np.random.default_rng(5)
    data = (2**31 - 600 + rng.integers(0, 100, (64, 64, 1))
            + np.where(np.arange(64)[None, :, None] >= 20, 1000, 0)).astype(np.uint32)
    jblob = J.MosaicEncoder(_jax_mesh(), 32, 32, np.uint32, try_16=False).encode(data, None, 0.5)
    assert (J.decode_mosaic(jblob) != data).sum() > 0  # JAX (fault 4): 2,669 pixels, by up to 1011
    blob = P.MosaicEncoder(None, 32, 32, np.uint32, try_16=False, device="cpu").encode(data, None,
                                                                                       0.5)
    np.testing.assert_array_equal(_assert_decodes_like_the_host(blob), data)
    info, _ = P.read_mosaic(blob)
    assert (info["z_min"], info["z_max"]) == (float(data.min()), float(data.max()))


def _wrap_tile():
    """8x8 blocks of values near 0 and near 2^32 (signed -5..5)."""
    a = np.zeros((64, 64, 1), np.uint32)
    a[::2] = 5
    a[1::2, ::3] = 2**32 - 5
    return a


@pytest.mark.parametrize("case,mze", [("across", 2.0), ("across", 4.0), ("wrap", 0.5),
                                      ("wrap", 4.0)])
def test_uint32_tile_blocks_across_2_31_lossy(case, mze):
    """P6 in the tile-batched K1: a block across 2^31 at maxZError 2 and 4
    (under the raw cap), and blocks of values near 0 and near 2^32, took
    their minima in signed order; K1 orders uint32 as unsigned now, and the
    ranges come from it."""
    if case == "across":
        rng = np.random.default_rng(5)
        data = (2**31 - 600 + rng.integers(0, 100, (64, 64, 1))
                + np.where(np.arange(64)[None, :, None] >= 20, 1000, 0)).astype(np.uint32)
    else:
        data = _wrap_tile()
    blob = P.MosaicEncoder(None, 32, 32, np.uint32, try_16=False, device="cpu").encode(data, None,
                                                                                       mze)
    host = _assert_decodes_like_the_host(blob)
    err = np.abs(host.astype(np.int64) - data.astype(np.int64)).max()
    assert err <= (int(mze) if mze > 0.5 else 0)
    info, _ = P.read_mosaic(blob)
    assert (info["z_min"], info["z_max"]) == (float(data.min()), float(data.max()))


def test_uint32_band_above_2_31_repair():
    """Port fault P4: decode_band_device cast uint32 block offsets and zMax of
    2^31 and more through int32 (and K6 clamped in int32 order); the host
    encoder's blob now decodes equal to the host decoder."""
    data = (3_000_000_001 + np.arange(48 * 41).reshape(48, 41, 1) % 999).astype(np.uint32)
    blob = BandEncoder(data, None, 0.5).encode()
    np.testing.assert_array_equal(lerc2_decode.decode_band(blob).data, data)
    np.testing.assert_array_equal(decode_band_device(blob, device="cpu").data.numpy(), data)


@pytest.mark.parametrize("hole", [False, True], ids=["all-valid", "hole"])
@pytest.mark.parametrize("base", [100, 2**31 - 600, 3_000_000_001])
def test_jax_band_decode_uint32_fault(base, hole):
    """JAX's decode_band_device reads an integer band's zMax and record
    offsets through int32 (device_codec.py:972-973): on the host encoder's
    48x41x1 uint32 band of base + [0, 1000) it is exact at base 100 and
    wrong at 2^31 - 600 (values across 2^31) and 3,000,000,001, all-valid
    and with a 15x27 hole; the port's decode_band_device and the host
    decoder are exact on all six."""
    data = (base + np.random.default_rng(0).integers(0, 1000, (48, 41, 1))).astype(np.uint32)
    mask = None
    if hole:
        mask = np.ones((48, 41), bool)
        mask[10:25, 7:34] = False
    blob = BandEncoder(data, mask, 0.5).encode()
    valid = np.ones((48, 41), bool) if mask is None else mask
    host = lerc2_decode.decode_band(blob).data
    port = decode_band_device(blob, device="cpu").data.numpy()
    with np.errstate(invalid="ignore"):  # JAX's own casts of values past int32
        jax_out = np.asarray(JC.decode_band_device(blob).data)
    np.testing.assert_array_equal(host[valid], data[valid])
    np.testing.assert_array_equal(port, host)
    jax_err = int(np.abs(jax_out.astype(np.int64) - data.astype(np.int64))[valid].max())
    if base == 100:
        assert jax_err == 0
    else:  # JAX: off by up to 600 across 2^31, by 852,517,352 above it
        assert jax_err > 0, f"JAX's uint32 band decode is now exact at base {base}"


# ---------------------------------------------------------------------------
# two ranks on gloo
# ---------------------------------------------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _mp_raster():
    """The raster of tests/test_multiprocess.py:29-42."""
    h = w = 96
    x, y = np.meshgrid(np.linspace(0, 9, w), np.linspace(0, 7, h))
    rng = np.random.default_rng(11)
    data = (np.sin(x) * np.cos(y) * 400 + 0.5 * rng.standard_normal((h, w))
            ).astype(np.float32)[:, :, None]
    mask = np.ones((h, w), bool)
    mask[10:30, 20:70] = False
    return data, mask


def test_two_rank_gloo_mosaic(tmp_path):
    data, mask = _mp_raster()
    want = P.MosaicEncoder(None, 32, 32, np.float32, device="cpu").encode(data, mask, 0.001)
    want_dec = P.decode_mosaic_device(want, device="cpu")
    assert want == J.MosaicEncoder(_jax_mesh(), 32, 32, np.float32).encode(data, mask, 0.001)
    np.testing.assert_array_equal(want_dec, J.decode_mosaic(want))
    np.save(tmp_path / "data.npy", data)
    np.save(tmp_path / "mask.npy", mask)
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", "torch_mosaic_worker.py"),
         str(_free_port()), "2", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for r in range(2):
        assert (tmp_path / f"container{r}.bin").read_bytes() == want
        np.testing.assert_array_equal(np.load(tmp_path / f"decode{r}.npy"), want_dec)
