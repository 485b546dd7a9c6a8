"""Three faults of the port's CPU path, each held to the reference here:

P1: ``decode_band_device`` of uint16/uint32 constant and one-sweep blobs
    (torch's CPU uint16/uint32 have no index_put or masked_fill), equal to
    the host decoder ``lerc2_decode.decode_band``;
P2: the plain K2's LUT instance on blocks of 30 bits and more (a non-LUT
    record's LUT fields fell past its payload), blobs byte-equal to JAX
    ``encode_band_device``;
P3: a masked constant ``ResidentCodec`` image decodes its invalid pixels to
    0, as the host decoder reads the same wire bytes; JAX writes the
    constant there too (its output is recorded).
"""
import numpy as np
import pytest
import torch

from lerc_tpu.codec import device_codec as jax_codec
from lerc_tpu.codec import lerc2_decode
from lerc_tpu.codec.lerc2_encode import BandEncoder
from lerc_tpu.codec.resident import ResidentCodec as JaxResident
from lerc_tpu_torch import ResidentCodec, encode_band_device
from lerc_tpu_torch.codec.device_codec import band_sections
from lerc_tpu_torch.interop import codec_kwargs

from .test_torch_band import _bits, assert_decodes_like_the_host

P1_MASK = np.random.default_rng(11).random((24, 19)) > 0.3


def _p1_data(npdt, kind, d):
    if kind == "constant":
        return np.full((24, 19, d), 7, npdt)
    rng = np.random.default_rng(12)
    return rng.integers(0, np.iinfo(npdt).max, (24, 19, d), dtype=np.uint64,
                        endpoint=True).astype(npdt)


P1_CASES = [(npdt, kind, d, masked) for npdt in (np.uint16, np.uint32)
            for kind in ("constant", "one_sweep") for d in (1, 2) for masked in (False, True)]


@pytest.mark.parametrize("npdt,kind,d,masked", P1_CASES,
                         ids=[f"{np.dtype(c[0]).name}-{c[1]}-d{c[2]}{'-mask' if c[3] else ''}"
                              for c in P1_CASES])
def test_p1_unsigned_constant_and_one_sweep_decode(npdt, kind, d, masked):
    data = _p1_data(npdt, kind, d)
    mask = P1_MASK if masked else None
    blob = BandEncoder(data, mask, 0.5).encode()
    assert band_sections(blob).kind == kind
    port = assert_decodes_like_the_host(blob, jax_too=False)
    sel = np.ones((24, 19), bool) if mask is None else mask
    np.testing.assert_array_equal(port.data.numpy()[sel], data[sel])
    # the port's own encoder writes the same blob as JAX, and verify decodes it
    assert encode_band_device(data, mask, 0.5, verify=True, device="cpu") == \
        jax_codec.encode_band_device(data, mask, 0.5)


def _p2_band(name):
    if name.startswith("f32"):
        h, w = {"f32-24x24": (24, 24), "f32-24x19": (24, 19), "f32-64x64": (64, 64)}[name]
        return np.random.default_rng(2).normal(0, 40, (h, w, 1)).astype(np.float32), 1e-7
    npdt = np.int32 if name == "i32-24x19" else np.uint32
    data = np.random.default_rng(3).integers(0, 2**30, (24, 19, 1)).astype(npdt)
    return data, 0.5


@pytest.mark.parametrize("name", ["f32-24x24", "f32-24x19", "f32-64x64", "i32-24x19",
                                  "u32-24x19"])
def test_p2_wide_blocks_through_the_plain_lut_k2(name):
    data, mze = _p2_band(name)
    jblob = jax_codec.encode_band_device(data, None, mze)
    assert encode_band_device(data, None, mze, device="cpu") == jblob
    port = assert_decodes_like_the_host(jblob, jax_too=False)
    if data.dtype != np.float32:  # lossless; at 1e-7 the float32 bands sit at their ulp
        np.testing.assert_array_equal(port.data.numpy(), data)


@pytest.mark.parametrize("npdt", [np.float32, np.int16, np.uint16])
def test_p3_masked_constant_resident_image(npdt):
    mask = np.random.default_rng(0).random((16, 16)) > 0.3
    data = np.full((16, 16, 1), 5, npdt)
    codec = ResidentCodec(**codec_kwargs(16, 16, 1, npdt, 0.5, 6, 0, mask), device="cpu")
    blob = codec.encode(torch.from_numpy(data))
    got = codec.decode(blob).numpy()
    host = lerc2_decode.decode_band(blob.to_bytes())
    np.testing.assert_array_equal(_bits(got), _bits(host.data))
    assert (got[mask] == 5).all() and (got[~mask] == 0).all()
    # JAX's ResidentCodec writes the constant at the invalid pixels too
    jcodec = JaxResident(16, 16, 1, npdt, 0.5, mask=mask)
    jgot = np.asarray(jcodec.decode(jcodec.encode(data)))
    assert (jgot[~mask] == 5).all() and (jgot[mask] == 5).all()
