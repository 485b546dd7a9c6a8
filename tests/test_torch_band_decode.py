"""Port parity for the band codec beyond the 48x41 bands of
tests/test_torch_band.py: LUT blocks, the 16x16 retrial, the maxZError
analyses, depth-diff records at version 5, one-sweep blobs, foreign blobs of
the host BandEncoder, a hand-built float depth-diff blob, the masked
index-free ResidentCodec decode, and what the slice refuses.

Criteria (exact): blobs byte-equal to JAX ``encode_band_device``; decodes
bit-equal to the host decoder ``lerc2_decode.decode_band`` and to JAX's
device decode where JAX decodes on its device; the configurations of ROADMAP
queue 1 items 7 (8-bit Huffman), 8 (fpl lossless float32) and 9 (float64),
refused until they were ported, now encode as JAX does and decode like the
host decoder; legacy versions (item 12) raise NotImplementedError naming
their item, before any work.
"""
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lerc_tpu.codec import device_codec as jax_codec
from lerc_tpu.codec import header as jax_hdr
from lerc_tpu.codec import lerc2_decode
from lerc_tpu.codec.lerc2_encode import BandEncoder
from lerc_tpu.codec.resident import ResidentBlob as JaxBlob
from lerc_tpu.codec.resident import ResidentCodec as JaxResident
from lerc_tpu_torch import ResidentCodec, decode_band_device, encode_band_device
from lerc_tpu_torch.codec import fletcher32, header as hdr
from lerc_tpu_torch.codec.device_codec import band_sections
from lerc_tpu_torch.interop import codec_kwargs
from lerc_tpu_torch.ops import tile_scan as ts

from .test_torch_band import MASK, H, W, _bits, assert_decodes_like_the_host, make
from .test_torch_tile_scan import class_grid, low_rate, tile_section


def _parity(data, mask, mze, jax_too=True, **kw):
    """The port's blob equals JAX's; its decode equals the host's (and
    JAX's device decode on 8x8 tiling blobs). Returns (blob, port
    DecodedBand)."""
    jblob = jax_codec.encode_band_device(data, mask, mze, **kw)
    assert encode_band_device(data, mask, mze, device="cpu", **kw) == jblob
    return jblob, assert_decodes_like_the_host(jblob, jax_too)


def _modes(blob):
    stream, mask, head = tile_section(blob)
    cnts, j0s, n = ts.block_scan_inputs(mask, head.micro_block_size)
    return ts.tile_scan_ref(stream, cnts, j0s, n, head.n_depth, int(head.dt), head.version)[0]


def masked_16x16_depth2():
    rng = np.random.default_rng(21)
    h, w, d = 96, 112, 2
    base = (np.arange(h)[:, None, None] // 24 * 8
            + np.arange(w)[None, :, None] // 28 * 8).astype(np.float32)
    data = np.broadcast_to(base, (h, w, d)).copy()
    data[:, :, 1] += 3
    return data, rng.random((h, w)) > 0.1


def test_lut_class_grid():
    blob, port = _parity(class_grid(), None, 0.5)
    assert (_modes(blob)["mode"] % 8 == 4).any(), "no LUT records"
    np.testing.assert_array_equal(port.data.numpy(), class_grid())


def test_16x16_retrial():
    data = low_rate()
    blob, port = _parity(data, None, 0.3)
    assert port.hd.micro_block_size == 16
    assert jax_codec.decode_band_device(blob) is None  # JAX sends 16x16 blobs to the host
    assert np.abs(port.data.numpy() - data).max() <= 0.3 * 1.1


def test_16x16_with_mask_and_depth():
    data, mask = masked_16x16_depth2()
    _blob, port = _parity(data, mask, 0.5)
    assert np.abs(port.data.numpy() - data)[mask].max() <= 0.55


def test_max_z_error_auto_raise():
    rng = np.random.default_rng(31)
    data = (np.round(rng.normal(50, 20, (96, 104)) * 10) / 10).astype(np.float32)[:, :, None]
    _blob, port = _parity(data, None, 0.0004)
    host_head, _ = hdr.read_header(BandEncoder(data, None, 0.0004).encode())
    assert port.hd.max_z_error == host_head.max_z_error > 0.0004


def test_bit_plane_cut_777():
    rng = np.random.default_rng(33)
    signal = np.arange(128)[:, None] * 16 + np.arange(128)[None, :] * 8
    data = (signal + rng.integers(0, 4, (128, 128))).astype(np.int32)[:, :, None]
    _blob, port = _parity(data, None, 777)
    host_head, _ = hdr.read_header(BandEncoder(data, None, 777).encode())
    assert port.hd.max_z_error == host_head.max_z_error >= 0.5


def test_int16_depth3_v5_diff_records():
    blob, port = _parity(make(np.int16, 3), MASK, 0, version=5)
    assert (_modes(blob)["mode"] >= 8).any(), "no depth-diff records"
    np.testing.assert_array_equal(port.data.numpy()[MASK], make(np.int16, 3)[MASK])


def test_one_sweep_noise_band():
    noisy = np.random.default_rng(1).normal(0, 50, (H, W, 1)).astype(np.float32)
    # raw blocks: more than the values alone. JAX sends one-sweep blobs to
    # the host; the port scatters the values on the device
    blob, port = _parity(noisy, MASK, 1e-8, jax_too=False)
    assert band_sections(blob).kind == "one_sweep"
    assert jax_codec.decode_band_device(blob) is None
    np.testing.assert_array_equal(port.data.numpy()[MASK], noisy[MASK])


def _seg():
    x, y = np.meshgrid(np.linspace(0, 10, W), np.linspace(0, 8, H))
    return ((np.floor(x * 2) + np.floor(y * 3)) * 10).astype(np.float32)[:, :, None]


FOREIGN = {
    "lut-f32": lambda: BandEncoder(_seg(), None, 0.5).encode(),
    "lut-i32": lambda: BandEncoder(class_grid(), None, 0.5).encode(),
    "16x16-mask": lambda: BandEncoder(low_rate(), np.random.default_rng(4).random((128, 192))
                                      > 0.05, 0.3).encode(),
    "16x16-mask-d2": lambda: BandEncoder(*masked_16x16_depth2(), 0.5).encode(),
    "i16-d3-diff-mask": lambda: BandEncoder(make(np.int16, 3), MASK, 0.0).encode(),
    "f32-mask-v3": lambda: BandEncoder(make(np.float32), MASK, 0.01, version=3).encode(),
}


@pytest.mark.parametrize("name", sorted(FOREIGN))
def test_foreign_host_blobs_decode_like_the_host(name):
    blob = FOREIGN[name]()
    assert_decodes_like_the_host(blob)


def float_diff_blob():
    """A float32 depth-2 blob whose slice-1 records (const-0, const-offset,
    bit-stuffed, LUT) are rewritten as depth-diff records (flag bit 2) and
    its checksum refixed: slice 1 then decodes as offset (+ q * invScale) +
    slice 0, clamped to zMax (Lerc2.cpp:2026-2230)."""
    data = make(np.float32, 2)
    data[:, :, 1] = data[:, :, 0] + 0.25 * np.sin(np.arange(W))[None, :]
    data[8:16, 8:24, 1] = 5.0    # const-offset records
    data[24:32, 0:8, :] = 0.0    # const-0 records
    data[32:40, 16:24, 1] = np.where(np.arange(8) % 2, 1.0, 9.0)  # LUT-sized blocks
    blob = bytearray(encode_band_device(data, MASK, 0.01, device="cpu"))
    stream, mask, head = tile_section(bytes(blob))
    base = head.blob_size - stream.size
    cnts, j0s, n = ts.block_scan_inputs(mask, 8)
    recs = ts.tile_scan_ref(stream, cnts, j0s, n, 2, int(head.dt), head.version)[0]
    pos, flipped = 0, []
    for r, rec in enumerate(recs):
        flag = stream[pos]
        m = rec["mode"] % 8
        if r % 2 == 1 and m != 0:
            blob[base + pos] = flag | 4
            flipped.append(int(m))
        if m == 2:
            pos += 1
        elif m == 3:
            pos += 1 + {2: 1, 1: 2}.get(int(flag) >> 6, 4)
        elif m == 0:
            pos = int(rec["payload_pos"]) + int(cnts[r // 2]) * 4
        else:
            nbits = rec["nbits_lut"] if m == 4 else rec["num_bits"]
            pos = int(rec["payload_pos"]) + (int(rec["num_elements"]) * int(nbits) + 7) // 8
    assert pos == stream.size
    skip = hdr.checksum_skip(head.version)
    struct.pack_into("<I", blob, skip - 4, fletcher32.fletcher32(bytes(blob[skip:head.blob_size])))
    return bytes(blob), sorted(set(flipped))


def test_hand_built_float_depth_diff_blob():
    blob, flipped = float_diff_blob()
    assert {1, 2, 3} <= set(flipped), flipped
    port = assert_decodes_like_the_host(blob, jax_too=False)
    recs = _modes(blob)
    assert (recs["mode"] >= 8).sum() > 10
    assert torch.isfinite(port.data).all()


RESIDENT = [  # (dtype, depth, maxZError)
    (np.float32, 1, 0.01), (np.float32, 2, 0.001), (np.uint16, 1, 0.5), (np.int16, 3, 0.5),
]


@pytest.mark.parametrize("npdt,d,mze", RESIDENT,
                         ids=[f"{np.dtype(c[0]).name}-d{c[1]}" for c in RESIDENT])
def test_masked_resident_decode_without_the_index(npdt, d, mze):
    """ResidentCodec.decode of a masked blob without `starts`: the host
    scanner and the masked K6, equal to the indexed decode, to JAX's
    ResidentCodec.decode and to the host decoder -- and on integer
    depth-diff records, where JAX refuses, to the host decoder."""
    rng = np.random.default_rng(5)
    h, w = 48, 40
    mask = rng.random((h, w)) > 0.25
    x = np.cumsum(rng.integers(-2, 3, (h, w, d)), axis=2) + np.arange(w)[None, :, None] * 7
    data = (x + 300).astype(npdt) if npdt != np.float32 else (x * 0.37).astype(npdt)
    kw = codec_kwargs(h, w, d, npdt, mze, 6, 0, mask)
    codec = ResidentCodec(**kw, device="cpu")
    blob = codec.encode(torch.from_numpy(data))
    host = lerc2_decode.decode_band(blob.to_bytes()).data
    blob.starts = None
    got = codec.decode(blob).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(host))
    jcodec = JaxResident(h, w, d, npdt, mze, mask=mask)
    jhead = jax_hdr.read_header(blob.header)[0]
    jblob = JaxBlob(blob.header, jnp.asarray(blob.stream.numpy().view(np.uint32)), blob.total,
                    blob.checksum, jhead, None)
    has_diff = (_modes(blob.to_bytes())["mode"] >= 8).any()
    if has_diff:  # JAX's masked scan refuses depth-diff records (queue 3)
        with pytest.raises(ValueError, match="depth-diff"):
            jcodec.decode(jblob)
    else:
        np.testing.assert_array_equal(_bits(np.asarray(jcodec.decode(jblob))), _bits(got))
    assert has_diff == (npdt == np.int16)


UNPORTED_ENCODE = [  # (dtype, maxZError, version, item); None: items 7, 8 and 9, ported since
    (np.uint8, 0.5, 6, None), (np.int8, 0.0, 3, None), (np.float32, 0.0, 6, None),
    (np.float64, 0.1, 6, None), (np.float32, 0.1, 2, "item 12"),
]


@pytest.mark.parametrize("npdt,mze,version,item", UNPORTED_ENCODE,
                         ids=[f"{np.dtype(c[0]).name}-{c[1]}-v{c[2]}" for c in UNPORTED_ENCODE])
def test_unported_encodes_name_their_roadmap_item(npdt, mze, version, item, monkeypatch):
    from lerc_tpu_torch.ops import device_encode

    if item is None:  # 8-bit Huffman, fpl or float64 tiling: the blob JAX writes
        data = make(npdt)
        blob = encode_band_device(data, None, mze, version=version, device="cpu")
        assert blob == jax_codec.encode_band_device(data, None, mze, version=version)
        modes = {np.float32: (3,), np.float64: (None,)}.get(npdt, (1, 2))  # lossy: no mode byte
        assert band_sections(blob).mode in modes
        assert band_sections(blob).kind == {np.float64: "tiling"}.get(npdt, band_sections(blob).kind)
        assert_decodes_like_the_host(blob, jax_too=npdt == np.float64)
        return

    monkeypatch.setattr(device_encode, "encode_tiles",
                        lambda *a, **k: pytest.fail("encode work before the refusal"))
    with pytest.raises(NotImplementedError, match=item):
        encode_band_device(make(npdt), None, mze, version=version, device="cpu")


def _huffman_blob():
    rng = np.random.default_rng(42)
    data = np.clip(128 + np.cumsum(rng.integers(-2, 3, (H, W)), axis=1), 0, 255).astype(np.uint8)
    return BandEncoder(data[:, :, None], None, 0.0).encode()


UNPORTED_DECODE = {  # None: items 7, 8 and 9, ported since
    "huffman": (_huffman_blob, None),
    "fpl": (lambda: BandEncoder(make(np.float32), None, 0.0).encode(), None),
    "f64": (lambda: BandEncoder(make(np.float64), None, 0.01).encode(), None),
}


@pytest.mark.parametrize("name", sorted(UNPORTED_DECODE))
def test_unported_decodes_name_their_roadmap_item(name):
    make_blob, item = UNPORTED_DECODE[name]
    blob = make_blob()
    if name != "f64":  # the blob really is a Huffman / fpl one
        assert band_sections(blob).mode in ((1, 2) if name == "huffman" else (3,))
    else:  # a float64 tiling blob
        assert band_sections(blob).kind == "tiling" and band_sections(blob).head.dt == 7
    if item is None:  # 8-bit Huffman, fpl, float64: decodes like the host decoder
        assert_decodes_like_the_host(blob, jax_too=False)
        return
    with pytest.raises(NotImplementedError, match=item):
        decode_band_device(blob, device="cpu")


def test_corrupt_blobs_raise():
    blob = bytearray(encode_band_device(make(np.float32), MASK, 0.01, device="cpu"))
    bad = bytearray(blob)
    bad[-5] ^= 0x10
    with pytest.raises(ValueError, match="checksum"):
        decode_band_device(bytes(bad), device="cpu")
    with pytest.raises(ValueError):
        lerc2_decode.decode_band(bytes(bad))
    short = bytes(blob[:-20])
    with pytest.raises(ValueError):
        decode_band_device(short, device="cpu")
    # a tile stream cut short, its checksum and blob size refixed
    head, _ = hdr.read_header(bytes(blob))
    cut = bytearray(blob[:-40])
    struct.pack_into("<i", cut, 6 + 4 + 4 + 4 * 5, len(cut))
    skip = hdr.checksum_skip(head.version)
    struct.pack_into("<I", cut, skip - 4, fletcher32.fletcher32(bytes(cut[skip:])))
    with pytest.raises(ValueError, match="corrupt"):
        decode_band_device(bytes(cut), device="cpu")
    with pytest.raises(ValueError):
        lerc2_decode.decode_band(bytes(cut))


def test_supports_encode_and_round_cap_match_the_slice():
    from lerc_tpu_torch.codec.device_codec import _round_cap, supports_encode
    from lerc_tpu_torch.constants import DataType

    assert supports_encode(DataType.FLOAT, 0.001, 1) and supports_encode(DataType.SHORT, 0.5, 3)
    assert supports_encode(DataType.BYTE, 1.0, 1) and supports_encode(DataType.FLOAT, 0.0, 1,
                                                                     version=5)
    assert supports_encode(DataType.BYTE, 0.5, 1)  # 8-bit Huffman: item 7, ported since
    assert supports_encode(DataType.FLOAT, 0.0, 1)  # fpl: item 8, ported since
    assert supports_encode(DataType.DOUBLE, 0.1, 1)  # float64: item 9, ported since
    assert supports_encode(DataType.DOUBLE, 0.0, 3, version=6)
    assert not supports_encode(DataType.FLOAT, 0.1, 1, version=2)  # legacy bit order: item 12
    for n in (1, 4096, 4097, 100_000):
        assert _round_cap(n) == jax_codec._round_cap(n)


def test_jax_band_encoder_v2_fault():
    """ROADMAP queue 3: JAX's band encoder writes version-2 blobs in the v3+
    bit order, so the host decoder (legacy order at v2) reads them far out
    of bound; the port refuses version 2 (item 12)."""
    data = make(np.float32)
    blob = jax_codec.encode_band_device(data, MASK, 0.05, version=2)
    host = lerc2_decode.decode_band(blob)
    assert np.abs(host.data - data)[MASK].max() > 1.0
    with pytest.raises(NotImplementedError, match="item 12"):
        encode_band_device(data, MASK, 0.05, version=2, device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        decode_band_device(blob, device="cpu")
