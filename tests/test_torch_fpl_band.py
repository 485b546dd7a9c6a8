"""Port parity for lossless float32 (fpl) through the band codec:
``encode_band_device`` / ``decode_band_device`` of the port (plain PyTorch
versions, device="cpu") against JAX's and the host decoder, at maxZError 0,
version 6.

Criteria (exact): blobs byte-equal to JAX ``encode_band_device`` and the
``fpl_sbits`` index equal, the predictor and every plane's method asserted
(together the bands reach predictors 0, 1 and 2 and the methods Huffman,
RLE-const, raw and PackBits); decodes bit-equal to the input, to the host
decoder ``lerc2_decode.decode_band`` and to JAX's ``decode_band_device``, with
the port's index, with JAX's and without one (the host lengths-only scan);
masked bands (fpl codes every pixel); foreign ``BandEncoder`` blobs; the 10%
acceptance rule and the 16x16 gate the fpl size feeds; a tampered index and
corrupt sections raise ValueError; bands of 2-4 pixels, where JAX's encoder
fails (ROADMAP queue 3), held to the host decoder.

JAX compiles one program per shape, predictor and plane tables: the bands
share the 48x41 shape where they can, and JAX's blobs are made once per
module.
"""
import struct

import numpy as np
import pytest

from lerc_tpu.codec import device_codec as jax_codec
from lerc_tpu.codec import lerc2_decode
from lerc_tpu.codec.lerc2_encode import BandEncoder
from lerc_tpu_torch import decode_band_device, encode_band_device
from lerc_tpu_torch.codec import fletcher32, header as hdr
from lerc_tpu_torch.codec.device_codec import band_sections

from .test_torch_band import _bits, assert_decodes_like_the_host

H, W = 48, 41
HUFF, RLE, RAW, PACKBITS = 0, 1, 2, 3


def recipe(name):
    """(float32 [h, w, d] band, mask or None) of a named case."""
    base = name.removesuffix("-mask")
    rng = np.random.default_rng(sum(map(ord, base)))
    x, y = np.meshgrid(np.linspace(0, 10, W), np.linspace(0, 8, H))
    mask = np.random.default_rng(7).random((H, W)) > 0.3
    if base == "smooth":  # a hill: predictor 2, Huffman and PackBits planes
        data = 1000 + 200 * np.sin(x / 2.5) * np.cos(y / 2.7)
    elif base == "walk":  # random walks along the rows: predictor 1, raw planes
        data = np.cumsum(rng.normal(0, 1, (H, W)), 1)
    elif base == "steps":  # quarter steps along the rows: predictor 1, RLE-const planes
        data = np.cumsum(rng.integers(-3, 4, (H, W)), 1) * 0.25 + 7
    elif base == "sparse":  # rare spikes on 1.0: predictor 0, PackBits
        data = np.where(rng.random((H, W)) > 0.95, rng.normal(0, 1, (H, W)), 0.0) + 1.0
    elif base == "dem":  # the bench generator's shape at 48x41: hill, sinusoid, noise
        data = (1500 * np.exp(-((x - 5) ** 2 + (y - 4) ** 2) / 20) + 50 * np.sin(x) * np.cos(y)
                + rng.random((H, W)) - 0.5)
    elif base == "d3":  # depth 3: an [H * W, 3] image
        data = (1000 + 200 * np.sin(x / 2.5) * np.cos(y / 2.7))[:, :, None] + np.array(
            [0.0, 0.25, -3.5]) + 0.01 * rng.standard_normal((H, W, 3))
    else:
        raise KeyError(name)
    data = np.asarray(data, np.float32)
    if data.ndim == 2:
        data = data[:, :, None]
    return data, (mask if name.endswith("-mask") else None)


CASES = {  # name -> (predictor, plane methods)
    "smooth": (2, (HUFF, HUFF, HUFF, PACKBITS)),
    "walk": (1, (RAW, RAW, RAW, HUFF)),
    "steps": (1, (RLE, RLE, HUFF, HUFF)),
    "sparse": (0, (PACKBITS,) * 4),
    "dem": (2, (RAW, RAW, HUFF, HUFF)),
    "d3": (2, None),
    "smooth-mask": (2, (HUFF, HUFF, HUFF, PACKBITS)),
    "steps-mask": (1, (RLE, RLE, HUFF, HUFF)),
    "d3-mask": (2, None),
}


def fpl_planes(blob):
    """(predictor, [(byte index, level, method)]) of an fpl blob."""
    sec = band_sections(blob)
    assert sec.kind == "fpl" and sec.mode == 3
    src, pos = memoryview(blob), sec.pos
    pred, pos, planes = src[pos], pos + 1, []
    for _ in range(4):
        csize = struct.unpack_from("<I", src, pos + 2)[0]
        planes.append((src[pos], src[pos + 1], src[pos + 6]))
        pos += 6 + csize
    assert pos == len(blob)
    return pred, planes


@pytest.fixture(scope="module")
def jax_blobs():
    """JAX's (blob, index) of each case, made on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            data, mask = recipe(name)
            cache[name] = jax_codec.encode_band_device(data, mask, 0.0, return_index=True)
        return cache[name]
    return get


def _index_equal(a, b):
    assert a.keys() == b.keys() == {"fpl_sbits"}
    assert a["fpl_sbits"].keys() == b["fpl_sbits"].keys()
    for k, v in a["fpl_sbits"].items():
        assert v.dtype == np.int32
        np.testing.assert_array_equal(v, b["fpl_sbits"][k])


@pytest.mark.parametrize("name", list(CASES))
def test_fpl_blob_and_index_match_jax(name, jax_blobs):
    data, mask = recipe(name)
    jblob, jindex = jax_blobs(name)
    pred, methods = CASES[name]
    jpred, planes = fpl_planes(jblob)
    assert jpred == pred
    if methods is not None:
        assert tuple(p[2] for p in planes) == methods
    blob, index = encode_band_device(data, mask, 0.0, return_index=True, device="cpu")
    assert blob == jblob
    _index_equal(index, jindex)
    assert sorted(index["fpl_sbits"]) == [b for b, _lev, m in planes if m == HUFF]
    assert encode_band_device(data, mask, 0.0, verify=True, device="cpu") == blob


def test_the_cases_reach_every_predictor_and_method():
    assert {c[0] for c in CASES.values()} == {0, 1, 2}
    assert {m for c in CASES.values() if c[1] for m in c[1]} == {HUFF, RLE, RAW, PACKBITS}


@pytest.mark.parametrize("name", list(CASES))
def test_fpl_decode_matches_input_host_and_jax(name, jax_blobs):
    data, mask = recipe(name)
    jblob, jindex = jax_blobs(name)
    _, pindex = encode_band_device(data, mask, 0.0, return_index=True, device="cpu")
    host = lerc2_decode.decode_band(jblob)
    np.testing.assert_array_equal(_bits(host.data), _bits(data))  # every pixel rides the wire
    for index in (pindex, jindex, None):
        got = decode_band_device(jblob, index=index, device="cpu")
        np.testing.assert_array_equal(_bits(got.data.numpy()), _bits(host.data))
        np.testing.assert_array_equal(got.mask, host.mask)
    assert_decodes_like_the_host(jblob, jax_too=False)
    for index in (jindex, pindex):  # JAX decodes with either index
        jd = jax_codec.decode_band_device(jblob, index=index)
        np.testing.assert_array_equal(_bits(np.asarray(jd.data)), _bits(host.data))


FOREIGN = {
    "smooth": lambda: recipe("smooth"),
    "steps-mask": lambda: recipe("steps-mask"),
    "d3-mask": lambda: recipe("d3-mask"),
    "sparse": lambda: recipe("sparse"),
}


@pytest.mark.parametrize("name", sorted(FOREIGN))
def test_foreign_band_encoder_blobs(name):
    data, mask = FOREIGN[name]()
    blob = BandEncoder(data, mask, 0.0).encode()
    assert band_sections(blob).kind == "fpl"
    port = assert_decodes_like_the_host(blob, jax_too=False)
    sel = np.ones((H, W), bool) if mask is None else mask
    np.testing.assert_array_equal(_bits(port.data.numpy()[sel]), _bits(data[sel]))


def _blocks(h, w, bs, seed):
    """Bands constant on bs x bs blocks, 0, 0.5 or 1.0 each: low bit rates."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 3, (h // bs + 1, w // bs + 1)) * 0.5
    yy, xx = np.mgrid[0:h, 0:w]
    return vals[yy // bs, xx // bs].astype(np.float32)[:, :, None]


GATES = {  # name -> (band, the blob's kind, its micro block size)
    # fpl is not 10% smaller than tiling: tiling is taken
    "fpl-loses-10pct": (lambda: np.where(np.mgrid[0:H, 0:W][0] >= 24, 5.0, np.random.default_rng(
        1).normal(0, 1, (H, W))).astype(np.float32)[:, :, None], "tiling", 8),
    # fpl wins, tiling < 2x its size opens the 16x16 retrial, and 16x16 wins
    "fpl-wins-16x16-wins": (lambda: _blocks(64, 96, 32, 0), "tiling", 16),
    # fpl wins by more than 2x: the gate stays shut though 16x16 would be smaller
    "fpl-shuts-the-16x16-gate": (lambda: _blocks(128, 128, 32, 0), "fpl", 8),
}


@pytest.mark.parametrize("name", list(GATES))
def test_the_10pct_rule_and_the_16x16_gate(name):
    make, kind, mb = GATES[name]
    data = make()
    jblob, jindex = jax_codec.encode_band_device(data, None, 0.0, return_index=True)
    blob, index = encode_band_device(data, None, 0.0, return_index=True, device="cpu")
    assert blob == jblob
    sec = band_sections(blob)
    assert sec.kind == kind and sec.head.micro_block_size == mb
    if kind == "fpl":
        _index_equal(index, jindex)
    else:
        assert index is None and jindex is None
    port = assert_decodes_like_the_host(blob, jax_too=False)
    np.testing.assert_array_equal(_bits(port.data.numpy()), _bits(data))


def _refix(blob: bytearray) -> bytes:
    """The blob with its size and checksum fields set to its bytes."""
    head, _ = hdr.read_header(bytes(blob))
    struct.pack_into("<i", blob, 6 + 4 + 4 + 4 * 5, len(blob))
    skip = hdr.checksum_skip(head.version)
    struct.pack_into("<I", blob, skip - 4, fletcher32.fletcher32(bytes(blob[skip:])))
    return bytes(blob)


def _corrupt(name, blob):
    sec = band_sections(blob)
    b = bytearray(blob)
    p0 = sec.pos + 1  # plane 0's header
    csize = struct.unpack_from("<I", b, p0 + 2)[0]
    if name == "predictor-3":
        b[sec.pos] = 3
    elif name == "byte-index-4":
        b[p0] = 4
    elif name == "level-6":
        b[p0 + 1] = 6
    elif name == "payload-past-the-end":
        struct.pack_into("<I", b, p0 + 2, len(b))
    elif name == "payload-size-0":
        struct.pack_into("<I", b, p0 + 2, 0)
    elif name == "method-4":
        b[p0 + 6] = 4
    elif name == "truncated-section":
        b = b[: p0 + 6 + csize + 3]
    elif name == "cut-huffman-stream":
        del b[p0 + 6 + csize - 12 : p0 + 6 + csize]
        struct.pack_into("<I", b, p0 + 2, csize - 12)
    return _refix(b)


CORRUPT = ["predictor-3", "byte-index-4", "level-6", "payload-past-the-end", "payload-size-0",
           "method-4", "truncated-section", "cut-huffman-stream"]


@pytest.mark.parametrize("name", CORRUPT)
def test_corrupt_sections_raise_like_jax(name, jax_blobs):
    jblob, _ = jax_blobs("smooth")
    assert fpl_planes(jblob)[1][0][2] == HUFF
    bad = _corrupt(name, jblob)
    with pytest.raises(ValueError):
        lerc2_decode.decode_band(bad)
    with pytest.raises(ValueError):
        decode_band_device(bad, device="cpu")
    if name != "cut-huffman-stream":  # JAX's decode raises too (a cut stream: the host path)
        with pytest.raises(ValueError):
            jax_codec.decode_band_device(bad)


def test_tampered_index_raises_and_a_short_one_is_rescanned(jax_blobs):
    jblob, jindex = jax_blobs("smooth")
    k0 = min(jindex["fpl_sbits"])
    bad = {"fpl_sbits": {k: v.copy() for k, v in jindex["fpl_sbits"].items()}}
    assert bad["fpl_sbits"][k0].size > 3
    bad["fpl_sbits"][k0][2] += 4
    with pytest.raises(ValueError, match="sidecar"):
        decode_band_device(jblob, index=bad, device="cpu")
    with pytest.raises(ValueError):
        jax_codec.decode_band_device(jblob, index=bad)
    # a plane whose offsets have another count: JAX takes its host path, the port scans
    short = {"fpl_sbits": {k: v[:-1] for k, v in jindex["fpl_sbits"].items()}}
    assert jax_codec.decode_band_device(jblob, index=short) is None
    got = decode_band_device(jblob, index=short, device="cpu").data.numpy()
    np.testing.assert_array_equal(_bits(got), _bits(recipe("smooth")[0]))


@pytest.mark.parametrize("shape", [(1, 2, 1), (1, 3, 1), (2, 2, 1), (1, 4, 1), (4, 1, 1),
                                   (1, 2, 2)])
def test_jax_tiny_fpl_band_fault(shape):
    """ROADMAP queue 3: JAX's encoder fails on float32 bands of 2-4 values at
    maxZError 0, version 6 (``_byte_deriv1`` concatenates more than the
    plane's length when the level exceeds it); the port encodes them, and
    they decode like the host decoder and equal to the input."""
    data = np.random.default_rng(int(np.prod(shape))).normal(0, 1, shape).astype(np.float32)
    with pytest.raises(TypeError):
        jax_codec.encode_band_device(data, None, 0.0)
    blob, index = encode_band_device(data, None, 0.0, return_index=True, device="cpu")
    port = assert_decodes_like_the_host(blob, jax_too=False)
    np.testing.assert_array_equal(_bits(port.data.numpy()), _bits(data))
    if band_sections(blob).kind == "fpl":
        assert set(index) == {"fpl_sbits"}
    got = decode_band_device(blob, index=index, device="cpu").data.numpy()
    np.testing.assert_array_equal(_bits(got), _bits(data))
