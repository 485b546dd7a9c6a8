"""Port parity for float64 bands through the band codec: the port's
``encode_band_device`` / ``decode_band_device`` (device="cpu", the kernels'
plain versions) against the JAX package's band codec and the host decoder
``lerc2_decode.decode_band``: lossy tiling through K1/K2/K6 f64, lossless fpl
at version 6 through F1-F3 over u64 words (eight planes), one-sweep,
constant and foreign blobs, and the three JAX faults of ROADMAP queue 3.

Criteria (exact, but for the maxZError bound of lossy decodes): blobs and
``fpl_sbits`` indexes equal to JAX's -- lossy wherever JAX's double-single
quanta are within maxZError, lossless on every band of at least 5 values;
every decode (the port's, JAX's and the host encoder's blobs; with the
port's index, with JAX's and without one) bit-equal to the host decoder, and
lossless decodes bit-equal to the input; lossy decodes within maxZError at
every valid pixel. Where JAX is at fault the port is held to the host
decoder and the bound: ``test_jax_f64_tie_quant_fault`` (JAX's quanta past
maxZError on a band of values on a 0.001 grid), ``test_jax_f64_tiny_fpl_band
_fault`` (JAX raises TypeError on lossless bands of 2-4 values) and
``test_jax_f64_lossless_below_v6_fault`` (below version 6 JAX writes an fpl
section no decoder reads; the port goes one-sweep).
"""
import numpy as np
import pytest
import torch

from lerc_tpu.codec import device_codec as jax_codec
from lerc_tpu.codec import lerc2_decode
from lerc_tpu.codec.lerc2_encode import BandEncoder
from lerc_tpu_torch import decode_band_device, encode_band_device
from lerc_tpu_torch.codec.device_codec import band_sections
from lerc_tpu_torch.constants import DataType

from .test_torch_band import assert_decodes_like_the_host
from .test_torch_f64 import class64, dem64, diff_blob, fband, hole_mask


def _u64(a):
    return np.ascontiguousarray(a).view(np.uint64)


def _sel(mask, shape):
    return np.ones(shape[:2], bool) if mask is None else mask


LOSSY = {  # id -> (data, mask, maxZError, version)
    "48x41-0.001-v6": lambda: (dem64(48, 41, 1), None, 0.001, 6),
    "48x41-mask-0.01-v5": lambda: (dem64(48, 41, 1), hole_mask(48, 41), 0.01, 5),
    "61x47x3-mask-0.01-v6": lambda: (dem64(61, 47, 3), hole_mask(61, 47), 0.01, 6),
    "64x64-1e-6-v4": lambda: (dem64(64, 64, 1), None, 1e-6, 4),
    "48x41-mask-0.01-v3": lambda: (dem64(48, 41, 1), hole_mask(48, 41), 0.01, 3),
    "noise-one-sweep": lambda: (fband(48, 41, 1, "noise") * 1e6, None, 1e-9, 6),
    "auto-raise": lambda: (np.round(dem64(48, 41, 1), 1), None, 0.0004, 6),
}


@pytest.mark.parametrize("name", sorted(LOSSY))
def test_f64_lossy_blob_matches_jax_and_decodes_like_the_host(name):
    data, mask, mze, version = LOSSY[name]()
    jblob = jax_codec.encode_band_device(data, mask, mze, version=version)
    blob = encode_band_device(data, mask, mze, version=version, device="cpu")
    assert blob == jblob
    kind = band_sections(blob).kind
    assert kind == ("one_sweep" if name == "noise-one-sweep" else "tiling")
    port = assert_decodes_like_the_host(blob, jax_too=kind == "tiling")
    limit = port.hd.max_z_error
    if name == "auto-raise":
        assert limit > mze
    err = np.abs(port.data.numpy() - data)[_sel(mask, data.shape)].max()
    assert err <= limit
    assert port.data.dtype == torch.float64


LOSSLESS = {  # id -> (data, mask)
    "48x41-smooth": lambda: (fband(48, 41, 1, "smooth"), None),
    "61x47x3-mask": lambda: (fband(61, 47, 3, "smooth", seed=2), hole_mask(61, 47)),
    "48x41-rows": lambda: (fband(48, 41, 1, "rows"), None),
    "13x11x3-noise": lambda: (fband(13, 11, 3, "noise"), None),
    "64x1-rows": lambda: (fband(64, 1, 1, "rows", seed=4), None),
}


@pytest.fixture(scope="module")
def jax_lossless():
    out = {}
    for name, make in LOSSLESS.items():
        data, mask = make()
        out[name] = jax_codec.encode_band_device(data, mask, 0.0, return_index=True)
    return out


@pytest.mark.parametrize("name", sorted(LOSSLESS))
def test_f64_fpl_blob_and_index_match_jax(name, jax_lossless):
    data, mask = LOSSLESS[name]()
    blob, index = encode_band_device(data, mask, 0.0, return_index=True, device="cpu")
    jblob, jindex = jax_lossless[name]
    assert blob == jblob
    assert band_sections(blob).kind == "fpl"
    assert set(index) == set(jindex) == {"fpl_sbits"}
    assert sorted(index["fpl_sbits"]) == sorted(jindex["fpl_sbits"])
    for b, sb in index["fpl_sbits"].items():
        assert 0 <= b < 8
        np.testing.assert_array_equal(sb, jindex["fpl_sbits"][b])


@pytest.mark.parametrize("name", sorted(LOSSLESS))
def test_f64_fpl_decodes_match_input_host_and_jax(name, jax_lossless):
    data, mask = LOSSLESS[name]()
    blob, jindex = jax_lossless[name]
    host = lerc2_decode.decode_band(blob).data
    np.testing.assert_array_equal(_u64(host), _u64(data))  # fpl codes every pixel, valid or not
    for index in (None, jindex, {"fpl_sbits": {}}):
        got = decode_band_device(blob, index=index, device="cpu")
        assert got.data.dtype == torch.float64
        np.testing.assert_array_equal(_u64(got.data.numpy()), _u64(host))
        np.testing.assert_array_equal(got.mask, _sel(mask, data.shape))
    jd = jax_codec.decode_band_device(blob, index=jindex)
    np.testing.assert_array_equal(_u64(np.asarray(jd.data)), _u64(host))


def test_the_f64_fpl_cases_reach_every_predictor_and_plane_method():
    preds, methods = set(), set()
    for name, make in LOSSLESS.items():
        data, mask = make()
        blob = encode_band_device(data, mask, 0.0, device="cpu")
        src, pos = memoryview(blob), band_sections(blob).pos
        preds.add(src[pos])
        pos += 1
        for _ in range(8):
            methods.add(src[pos + 6])
            pos += 6 + int.from_bytes(src[pos + 2:pos + 6], "little")
        assert pos == len(blob)
    assert preds == {0, 1, 2}
    assert methods == {0, 1, 2, 3}  # Huffman, RLE-const, raw and PackBits planes


def test_jax_f64_tie_quant_fault():
    """A 128x128 float64 DEM on a 0.001 grid (np.round(dem, 3)) at maxZError
    0.001 puts quanta near half-steps. JAX's double-single rounding
    (device_f64.py:163-199) picks quanta whose reconstruction is off by more
    than maxZError at some pixels (2,107 of 16,384 on this band, by up to
    9.0e-14: ROADMAP queue 3); the port's native f64 quanta, judged under the decoder's own
    arithmetic, keep every pixel within maxZError, and its blob decodes
    bit-equal through the host decoder and JAX's device decoder."""
    rng = np.random.default_rng(0)
    x, y = np.meshgrid(np.linspace(0, 6, 128), np.linspace(0, 5, 128))
    dem = 800 + 120 * np.sin(x) * np.cos(y) + 5 * rng.standard_normal((128, 128))
    data = np.round(dem, 3)[:, :, None]
    jblob = jax_codec.encode_band_device(data, None, 0.001)
    blob = encode_band_device(data, None, 0.001, device="cpu")
    jerr = np.abs(lerc2_decode.decode_band(jblob).data - data)
    assert (jerr > 0.001).sum() > 100 and jerr.max() < 0.001 + 1e-9
    port = assert_decodes_like_the_host(blob, jax_too=True)
    assert port.hd.max_z_error == 0.001
    assert np.abs(port.data.numpy() - data).max() <= 0.001
    assert blob != jblob and len(blob) == len(jblob)


@pytest.mark.parametrize("shape", [(1, 2, 1), (1, 3, 1), (2, 2, 1), (4, 1, 1)])
def test_jax_f64_tiny_fpl_band_fault(shape):
    """Lossless float64 bands of 2-4 values: JAX's ``_byte_deriv1``
    (device_fpl.py:70-76, reached from fpl_choose_device_f64 :323-324)
    raises TypeError (ROADMAP queue 3); the port, whose level rule leaves a
    plane as it is past its length, encodes them and decodes them like the
    host decoder, equal to the input."""
    data = fband(*shape, "noise", seed=7) + 10.0
    with pytest.raises(TypeError):
        jax_codec.encode_band_device(data, None, 0.0)
    blob, index = encode_band_device(data, None, 0.0, return_index=True, device="cpu")
    assert band_sections(blob).kind in ("fpl", "one_sweep")
    port = assert_decodes_like_the_host(blob, jax_too=False)
    np.testing.assert_array_equal(_u64(port.data.numpy()), _u64(data))
    got = decode_band_device(blob, index=index, device="cpu")
    np.testing.assert_array_equal(_u64(got.data.numpy()), _u64(data))


def test_jax_f64_lossless_below_v6_fault():
    """Lossless float64 below version 6: JAX still takes its fpl section and
    writes it without the image-mode byte (device_codec.py:194-198, :262),
    a blob the host decoder refuses (ROADMAP queue 3); the port has no
    candidate there and writes the valid values one-sweep."""
    data = fband(48, 41, 1, "smooth")
    jblob = jax_codec.encode_band_device(data, None, 0.0, version=5)
    with pytest.raises(ValueError):
        lerc2_decode.decode_band(jblob)
    blob = encode_band_device(data, None, 0.0, version=5, device="cpu")
    assert band_sections(blob).kind == "one_sweep"
    port = assert_decodes_like_the_host(blob, jax_too=False)
    np.testing.assert_array_equal(_u64(port.data.numpy()), _u64(data))


def test_f64_constant_empty_and_verify():
    flat = np.full((20, 19, 2), 3.5)
    flat[:, :, 1] = -1.25
    for data, mask, mze in ((flat, None, 0.01), (flat, None, 0.0), (flat[:, :, :1], None, 0.0),
                            (dem64(20, 19, 1), np.zeros((20, 19), bool), 0.01)):
        blob = encode_band_device(data, mask, mze, device="cpu")
        assert blob == jax_codec.encode_band_device(data, mask, mze)
        assert band_sections(blob).kind in ("constant", "empty")
        assert_decodes_like_the_host(blob, jax_too=False)
    mask = hole_mask(48, 41)
    for mze in (0.001, 0.0):
        blob = encode_band_device(dem64(48, 41, 1), mask, mze, verify=True, device="cpu")
        assert blob == jax_codec.encode_band_device(dem64(48, 41, 1), mask, mze)


FOREIGN = {  # the host encoder's float64 blobs, and their depth-diff rewrites
    "host-lut": lambda: BandEncoder(class64(48, 41, 1), None, 0.5).encode(),
    "host-mask-v3": lambda: BandEncoder(dem64(48, 41, 1), hole_mask(48, 41), 0.01,
                                        version=3).encode(),
    "host-fpl-d3": lambda: BandEncoder(fband(13, 11, 3, "smooth"), None, 0.0).encode(),
    "host-lut-d3-diff": lambda: diff_blob(BandEncoder(class64(48, 41, 3), hole_mask(48, 41),
                                                      0.5).encode())[0],
}


@pytest.mark.parametrize("name", sorted(FOREIGN))
def test_foreign_f64_blobs_decode_like_the_host(name):
    blob = FOREIGN[name]()
    assert band_sections(blob).head.dt == DataType.DOUBLE
    jd = jax_codec.decode_band_device(blob)
    port = assert_decodes_like_the_host(blob, jax_too=jd is not None)
    if name == "host-fpl-d3":
        np.testing.assert_array_equal(_u64(port.data.numpy()), _u64(fband(13, 11, 3, "smooth")))
