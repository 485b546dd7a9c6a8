"""Port parity for the mosaic's K4 instances (``device_decode.decode_tiles_fast``
with enable_lut, mb = 16 and n_tiles > 1, per-unit flags; the plain version
``decode_records_lut_ref`` runs on the CPU) against JAX's
``lerc_tpu.ops.device_decode.decode_tiles_fast``.

Streams come from JAX's ``encode_tiles(..., enable_lut=True, mb=mb)`` on
LUT-prone tiles, concatenated at 512-byte bases as the mosaic does, with
absolute starts. Criteria (exact): images bit-equal to JAX's wherever JAX's
``fits`` holds (JAX caps 16x16 records at 11 bits and clears ``fits`` for
wider ones -- ROADMAP queue 3; there the port decodes, and the mosaic tests
hold it to the host decoder); every unit's index_ok where JAX's holds; a
tampered start clears index_ok of its unit only; a depth-diff record sets
the unit's diff flag and leaves index_ok.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lerc_tpu.constants import DataType as JDT
from lerc_tpu.ops import device_decode as jdec
from lerc_tpu.ops import device_encode as jenc
from lerc_tpu_torch.constants import DataType
from lerc_tpu_torch.ops import device_decode, device_encode

H = W = 32


def _tiles(np_dt, n, d, seed, wide_unit=None):
    """n LUT-prone tiles: 8x8 plateaus plus a few recurring offsets; the
    unit `wide_unit` adds 12-bit noise (wide records)."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        base = rng.integers(0, 40, (H // 8, W // 8)).astype(np.float64) * 3
        x = np.repeat(np.repeat(base, 8, 0), 8, 1)[:, :, None] + rng.choice(
            [0, 2.0, 5.0], (H, W, d), p=[0.8, 0.1, 0.1])
        if t == wide_unit:
            x = x + rng.integers(0, 3000, (H, W, d))
        out.append(x.astype(np_dt))
    return out


def _units(tiles, masks, dt, mze, mb, version):
    """JAX-encoded units -> (stream words, absolute starts, zmax [n, D])."""
    parts, starts, zmaxs = [], [], []
    off = 0
    d = tiles[0].shape[2]
    for x, m in zip(tiles, masks):
        xin = x.astype(np.int32) if dt < JDT.FLOAT else x
        s, tot, _zmn, zmx, st, _f = jenc.encode_tiles(
            jnp.asarray(xin), jnp.asarray(m), jnp.float32(mze), H, W, d, dt, False, version,
            1 << 16, enable_lut=True, mb=mb)
        tot = int(tot)
        pad = -(-max(tot, 1) // 512) * 512
        sp = np.zeros(pad, np.uint8)
        sp[:tot] = np.asarray(s)[:tot]
        parts.append(sp)
        starts.append(np.asarray(st).astype(np.int64) + off)
        off += pad
        zmaxs.append(np.asarray(zmx))
    zmax = np.stack(zmaxs)
    zmax = np.round(zmax).astype(np.int32) if dt < JDT.FLOAT else zmax.astype(np.float32)
    return np.concatenate(parts), np.concatenate(starts).astype(np.int32), zmax


def _both(stream, starts, zmax, masks, dt, mze, mb, version, d):
    n = len(masks)
    mk = np.stack(masks)
    masked = not mk.all()
    jimg, jok, jfits = jdec.decode_tiles_fast(
        jnp.asarray(stream.view(np.uint32)), jnp.asarray(starts), jnp.float32(mze),
        jnp.asarray(zmax), H, W, d, dt, version, mask=jnp.asarray(mk) if masked else None,
        mb=mb, n_tiles=n, enable_lut=True)
    jimg = np.asarray(jimg).reshape(n, H, W, d)
    valid = (device_encode.block_valid_words(torch.from_numpy(mk.reshape(n * H, W)), mb)
             if masked else None)
    img, ok, fits, diff = device_decode.decode_tiles_fast(
        torch.from_numpy(stream.view(np.int32).copy()), torch.from_numpy(starts), mze,
        torch.from_numpy(zmax), H, W, d, DataType(int(dt)), version, mask=valid, mb=mb,
        n_tiles=n, enable_lut=True)
    return (jimg, bool(jok), bool(jfits)), (img.numpy(), ok.numpy(), fits.numpy(), diff.numpy())


CASES = {  # id -> (numpy dtype, maxZError, mb, units, depth, masked, version, wide unit)
    "f32-lut8-3units": (np.float32, 0.01, 8, 3, 1, False, 6, None),
    "f32-lut16-masked-d2": (np.float32, 0.5, 16, 2, 2, True, 6, None),
    "i16-lut8-masked-4units-v3": (np.int16, 0.5, 8, 4, 1, True, 3, None),
    "u16-lut16-1unit": (np.uint16, 1.0, 16, 1, 1, False, 6, None),
    "i32-lut16-wide": (np.int32, 0.5, 16, 2, 1, True, 6, 0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_k4_instances_match_jax(name):
    np_dt, mze, mb, n, d, masked, version, wide = CASES[name]
    dt = {np.float32: JDT.FLOAT, np.int16: JDT.SHORT, np.uint16: JDT.USHORT,
          np.int32: JDT.INT}[np_dt]
    rng = np.random.default_rng(7)
    tiles = _tiles(np_dt, n, d, seed=3, wide_unit=wide)
    masks = [rng.random((H, W)) > 0.15 if masked else np.ones((H, W), bool) for _ in range(n)]
    stream, starts, zmax = _units(tiles, masks, dt, mze, mb, version)
    (jimg, jok, jfits), (img, ok, fits, diff) = _both(stream, starts, zmax, masks, dt, mze, mb,
                                                      version, d)
    assert jok and ok.all() and fits.all() and not diff.any()
    assert img.shape == (n, H, W, d) and img.dtype == jimg.dtype
    if wide is None:
        assert jfits
        np.testing.assert_array_equal(img.view(np.uint8), jimg.view(np.uint8))
    else:  # JAX's 11-bit cap on 16x16 records: its fits drops
        assert not jfits
        others = [u for u in range(n) if u != wide]
        np.testing.assert_array_equal(img[others].view(np.uint8), jimg[others].view(np.uint8))
    # the valid pixels of each unit within maxZError of its input
    for u in range(n):
        err = np.abs(img[u].astype(np.float64) - tiles[u].astype(np.float64))[masks[u]]
        assert err.max() <= mze * (1.0001 if dt == JDT.FLOAT else 1)
        assert (img[u][~masks[u]] == 0).all()


def test_tampered_start_clears_its_unit_only():
    tiles = _tiles(np.float32, 3, 1, seed=5)  # the shapes of "f32-lut8-3units"
    masks = [np.ones((H, W), bool)] * 3
    stream, starts, zmax = _units(tiles, masks, JDT.FLOAT, 0.01, 8, 6)
    bad = starts.copy()
    bad[16 + 5] += 1  # unit 1, record 5
    (_j, jok, _jf), (_img, ok, _f, _d) = _both(stream, bad, zmax, masks, JDT.FLOAT, 0.01, 8, 6, 1)
    assert not jok
    assert ok.tolist() == [True, False, True]
    # each unit's last record is exempt from the delta check: its successor
    # is the next unit's first record, at a padded base
    g = int(starts[16])  # unit 1's base
    stream2 = np.concatenate([stream[:g], np.zeros(512, np.uint8), stream[g:]])
    bad = starts.copy()
    bad[16:] += 512
    (jimg, jok, _jf), (img, ok, _f, _d) = _both(stream2, bad, zmax, masks, JDT.FLOAT, 0.01, 8,
                                                6, 1)
    assert jok and ok.all()
    np.testing.assert_array_equal(img, jimg)


def test_depth_diff_records_flag_their_unit():
    """uint8 slices 1-2 close to slice 0: the encoder (JAX's, and the port's
    byte-equal copy used here) writes depth-diff records (flag bit 2) at
    version >= 5; K4 has no previous slice to add, so it flags the unit (the
    mosaic decodes it through K6) and keeps index_ok, the diff record's
    offset read as INT."""
    rng = np.random.default_rng(2)
    base = rng.integers(0, 200, (H, W, 1))
    x = np.concatenate([base, base + rng.integers(0, 3, (H, W, 1)),
                        base + rng.integers(0, 5, (H, W, 1))], 2).astype(np.uint8)
    tiles = [_tiles(np.uint8, 1, 3, seed=1)[0], x]
    parts, starts, zmax = [], [], []
    for t in tiles:
        s, tot, _zmn, zmx, st, _f = device_encode.encode_tiles(
            torch.from_numpy(t), None, 0.5, H, W, 3, DataType.BYTE, True, 6, 1 << 14,
            enable_lut=True)
        parts.append(s[: -(-int(tot) // 4)])
        starts.append(st + 4 * sum(p.numel() for p in parts[:-1]))
        zmax.append(zmx)
    img, ok, fits, diff = device_decode.decode_tiles_fast(
        torch.cat(parts), torch.cat(starts), 0.5, torch.stack(zmax), H, W, 3, DataType.BYTE, 6,
        n_tiles=2, enable_lut=True)
    assert diff.tolist() == [False, True] and ok.all() and fits.all()
    np.testing.assert_array_equal(img[0].numpy(), tiles[0])
