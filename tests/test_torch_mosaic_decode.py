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
tampered start clears index_ok of its unit only; depth-diff records
decode through the chain, and a diff record the chain cannot take (on slice
0, or raw) flags its unit for the scanned decode and leaves index_ok. The
chain is also held to JAX's host decoder (``lerc2_decode.decode_band``) on
host-encoded blobs of every integer width and a float32 blob with diff
records written in by hand.
"""
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lerc_tpu.codec import lerc2_decode as jax_host
from lerc_tpu.codec.lerc2_encode import BandEncoder
from lerc_tpu.constants import DataType as JDT
from lerc_tpu.ops import device_decode as jdec
from lerc_tpu.ops import device_encode as jenc
from lerc_tpu_torch import encode_band_device
from lerc_tpu_torch.codec import fletcher32, header as hdr
from lerc_tpu_torch.codec.device_codec import band_sections
from lerc_tpu_torch.constants import DT_SIZE, DataType, dt_is_int
from lerc_tpu_torch.ops import device_decode, device_encode
from lerc_tpu_torch.ops import tile_scan as ts
from lerc_tpu_torch.parallel import sharding as P

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
    version >= 5; K4 adds the previous slice (its offset read as INT) and
    decodes the unit itself, index_ok kept, no unit flagged. A diff bit set
    on a slice-0 record, which the host decoder refuses, flags that unit
    alone for the scanned decode."""
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
    stream, starts, zmax = torch.cat(parts), torch.cat(starts), torch.stack(zmax)
    flags = stream.view(torch.uint8)[starts.long()]
    assert ((flags[len(flags) // 2:] & 4) != 0).sum() > 10  # tile 1 holds diff records
    img, ok, fits, scanned = device_decode.decode_tiles_fast(
        stream, starts, 0.5, zmax, H, W, 3, DataType.BYTE, 6, n_tiles=2, enable_lut=True)
    assert scanned.tolist() == [False, False] and ok.all() and fits.all()
    np.testing.assert_array_equal(img[0].numpy(), tiles[0])
    np.testing.assert_array_equal(img[1].numpy(), x)
    bad = stream.clone()
    r0 = int(starts[len(starts) // 2])  # tile 1, block 0, slice 0
    bad.view(torch.uint8)[r0] |= 4
    _img, ok, fits, scanned = device_decode.decode_tiles_fast(
        bad, starts, 0.5, zmax, H, W, 3, DataType.BYTE, 6, n_tiles=2, enable_lut=True)
    assert scanned.tolist() == [False, True] and ok.all() and fits.all()


# ---------------------------------------------------------------------------
# the diff chain against the host decoder, on host-encoded blobs
# ---------------------------------------------------------------------------

CH = CW = 48
CHAIN_BASE = {np.uint8: 20, np.int16: -3000, np.int32: -70000, np.uint32: 2**31 - 150}


def _chain_data(np_dt, mb, seed=1):
    """[48, 48, 3] slices each close to the one before (lossless integer
    encodes at v6 write depth-diff records). mb 16: 16x16 plateaus that
    step by a whole block, noise in the first block (stuffed diff records),
    low-rate enough for the host encoder's 16x16 retrial; mb 8: noise.
    uint32 straddles 2^31."""
    rng = np.random.default_rng(seed)
    if mb == 16:
        def blocks(hi):
            return np.repeat(np.repeat(rng.integers(0, hi, (CH // 16, CW // 16)), 16, 0), 16, 1)

        def step():
            z = blocks(3)
            z[:16, :16] += rng.integers(0, 3, (16, 16))
            return z
        s = [blocks(40) * 5]
    else:
        def step():
            return rng.integers(0, 4, (CH, CW))
        s = [rng.integers(0, 200, (CH, CW))]
    for _ in range(2):
        s.append(s[-1] + step())
    return (np.stack(s, -1) + CHAIN_BASE[np_dt]).astype(np_dt)


def _offset_width(dt: int, b67: int) -> int:
    """A block offset's byte width by dtype code and flag bits 6-7
    (Lerc2.h:457-499)."""
    if dt <= 1:
        return 1
    if dt <= 3:
        return 1 if b67 else 2
    if dt == 4:
        return 1 if b67 == 3 else 2 if b67 else 4
    return 1 if b67 == 2 else 2 if b67 == 1 else 4


def _blob_unit(blob):
    """A tiling band blob as one K4 unit: (stream words, record starts,
    zmax [1, D], validity words or None, header, the stream's first byte in
    the blob), the starts found by walking the host scanner's records."""
    sec = band_sections(memoryview(blob))
    hd = sec.head
    assert sec.kind == "tiling"
    stream = np.frombuffer(blob, np.uint8)[sec.pos:hd.blob_size]
    cnts, j0s, n = ts.block_scan_inputs(sec.mask, hd.micro_block_size)
    recs = ts.tile_scan_ref(stream, cnts, j0s, n, hd.n_depth, int(hd.dt), hd.version)[0]
    starts, pos = [], 0
    for r, rec in enumerate(recs):
        starts.append(pos)
        flag, m = int(stream[pos]), int(rec["mode"]) % 8
        if m == 2:
            pos += 1
        elif m == 3:
            dif = flag & 4 and dt_is_int(hd.dt)
            pos += 1 + _offset_width(int(DataType.INT) if dif else int(hd.dt), flag >> 6)
        elif m == 0:
            pos = int(rec["payload_pos"]) + int(cnts[r // hd.n_depth]) * DT_SIZE[hd.dt]
        else:
            nbits = rec["nbits_lut"] if m == 4 else rec["num_bits"]
            pos = int(rec["payload_pos"]) + (int(rec["num_elements"]) * int(nbits) + 7) // 8
    assert pos == stream.size
    words = np.zeros(-(-stream.size // 4) * 4 + 8, np.uint8)
    words[:stream.size] = stream
    valid = None
    if not sec.mask.all():
        valid = device_encode.block_valid_words(torch.from_numpy(sec.mask), hd.micro_block_size)
    return (torch.from_numpy(words.view(np.int32)), torch.tensor(starts, dtype=torch.int32),
            torch.from_numpy(P._zmax_arg(sec, hd)[None, :].copy()), valid, hd, sec.pos)


def _k4_decode(blob):
    """The plain K4 of a blob's unit -> (image [H, W, D] numpy, index_ok,
    fits, scanned)."""
    stream, starts, zmax, valid, hd, _pos = _blob_unit(blob)
    img, ok, fits, scanned = device_decode.decode_tiles_fast(
        stream, starts, hd.max_z_error, zmax, hd.n_rows, hd.n_cols, hd.n_depth, hd.dt,
        hd.version, mask=valid, mb=hd.micro_block_size, n_tiles=1, enable_lut=True)
    return img[0].numpy(), bool(ok[0]), bool(fits[0]), bool(scanned[0])


def _refix_checksum(blob: bytearray) -> bytes:
    head, _ = hdr.read_header(bytes(blob))
    skip = hdr.checksum_skip(head.version)
    struct.pack_into("<I", blob, skip - 4, fletcher32.fletcher32(bytes(blob[skip:head.blob_size])))
    return bytes(blob)


@pytest.mark.parametrize("masked", [False, True], ids=["all-valid", "masked"])
@pytest.mark.parametrize("mb", [8, 16])
@pytest.mark.parametrize("np_dt", [np.uint8, np.int16, np.int32, np.uint32])
def test_plain_k4_diff_chain_matches_host_decoder(np_dt, mb, masked):
    data = _chain_data(np_dt, mb)
    mask = np.random.default_rng(4).random((CH, CW)) > 0.2 if masked else None
    blob = BandEncoder(data, mask, 0.0).encode()
    head, _ = hdr.read_header(blob)
    assert head.micro_block_size == mb
    host = np.asarray(jax_host.decode_band(blob).data)
    img, ok, fits, scanned = _k4_decode(blob)
    assert ok and fits and not scanned
    np.testing.assert_array_equal(img, host)
    sel = np.ones((CH, CW), bool) if mask is None else mask
    np.testing.assert_array_equal(img[sel], data[sel])


def test_plain_k4_float_diff_chain_matches_host_decoder():
    """A float32 depth-2 band (slice 1 = slice 0 plus a wave, const and
    LUT-sized blocks) whose slice-1 records (const-0, const-offset, stuffed,
    LUT) are rewritten as diff records, as test_torch_band_decode's
    float_diff_blob builds its blob: K4's exact f32 chain, (float)min(a +
    (double)prev, zMax), equals the host decoder."""
    rng = np.random.default_rng(6)
    mask = rng.random((CH, CW)) > 0.3
    s0 = np.cumsum(rng.normal(0, 1, (CH, CW)), 1).astype(np.float32) * 10
    data = np.stack([s0, s0 + 0.25 * np.sin(np.arange(CW))[None, :]], -1).astype(np.float32)
    data[8:16, 8:24, 1] = 5.0
    data[24:32, 0:8, :] = 0.0
    data[32:40, 16:24, 1] = np.where(np.arange(8) % 2, 1.0, 9.0)
    blob = bytearray(encode_band_device(data, mask, 0.01, device="cpu"))
    _stream, starts, _zmax, _valid, head, pos = _blob_unit(bytes(blob))
    flipped = set()
    for r in range(1, len(starts), 2):  # slice 1 of every block
        flag = blob[pos + int(starts[r])]
        if flag & 3 != 0:
            blob[pos + int(starts[r])] = flag | 4
            flipped.add(flag & 3)
    assert {1, 2, 3} <= flipped
    blob = _refix_checksum(blob)
    host = np.asarray(jax_host.decode_band(blob).data)
    img, ok, fits, scanned = _k4_decode(blob)
    assert ok and fits and not scanned
    np.testing.assert_array_equal(img.view(np.uint32), host.view(np.uint32))


def test_slice0_diff_record_raises_as_before():
    """A diff bit on a slice-0 record of a mosaic tile (its checksum
    refixed): K4 flags the unit, the scanned decode raises the ValueError it
    raises today, as the host decoder does."""
    data = _chain_data(np.uint8, 8)[:32, :32]
    blob = bytearray(P.MosaicEncoder(None, 32, 32, np.uint8, n_depth=3, try_16=False,
                                      device="cpu").encode(data, None, 0.5))
    info, views = P.read_mosaic(bytes(blob))
    base = len(blob) - len(views[0])  # the one tile's blob ends the container
    at = base + int(info["stream_offs"][0]) + int(info["starts"][0][0])
    assert not blob[at] & 4
    blob[at] |= 4
    tile = _refix_checksum(bytearray(blob[base:]))
    blob[base:] = tile
    with pytest.raises(ValueError, match="slice 0"):
        jax_host.decode_band(tile)
    with pytest.raises(ValueError):
        P.decode_mosaic_device(bytes(blob), device="cpu")
