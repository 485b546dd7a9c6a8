"""Port parity for the band codec's encode: ``encode_band_device`` of the port
(plain PyTorch versions, device="cpu") vs the JAX package's
``lerc_tpu.codec.device_codec.encode_band_device`` on the same bands, with
the data recipes of tests/test_device_codec.py (48x41: partial edge blocks,
with and without its random mask), and the decode of each blob.

Criteria (exact): the blobs are byte-equal; the port's
``decode_band_device`` is bit-equal to JAX's ``decode_band_device`` (8x8
blobs; JAX sends 16x16 blobs to the host) and, field by field, to the host
decoder ``lerc_tpu.codec.lerc2_decode.decode_band``; lossy float stays
within 1.1 * maxZError of the input at the valid pixels, lossless integers
are exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

from lerc_tpu.codec import device_codec as jax_codec
from lerc_tpu.codec import lerc2_decode
from lerc_tpu_torch import decode_band_device, encode_band_device
from lerc_tpu_torch.interop import decoded_band_to_numpy

H, W = 48, 41  # includes partial edge blocks


def make(dtype, d=1, scale=100.0):
    x, y = np.meshgrid(np.linspace(0, 10, W), np.linspace(0, 8, H))
    base = np.stack([np.sin(x + i) * np.cos(y) * scale + x * y for i in range(d)], -1)
    if np.issubdtype(dtype, np.integer):
        return np.round(base).astype(dtype)
    return base.astype(dtype)


MASK = np.random.default_rng(0).random((H, W)) > 0.3


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def assert_decodes_like_the_host(blob: bytes, jax_too: bool = True):
    """The port's decode of `blob` equals the host decoder field by field,
    and JAX's device decode where JAX decodes on its device. Returns the
    port's DecodedBand."""
    port = decode_band_device(blob, device="cpu")
    got = decoded_band_to_numpy(port)
    host = lerc2_decode.decode_band(blob)
    assert got["hd"] | {"dt": int(got["hd"]["dt"])} == dataclasses.asdict(host.hd) | {
        "dt": int(host.hd.dt)}
    np.testing.assert_array_equal(got["mask"], host.mask)
    assert got["data"].dtype == host.data.dtype and got["data"].shape == host.data.shape
    np.testing.assert_array_equal(_bits(got["data"]), _bits(host.data))
    for k in ("z_min_vec", "z_max_vec"):
        if host.__dict__[k] is None:
            assert got[k] is None
        else:
            np.testing.assert_array_equal(got[k], host.__dict__[k])
    assert got["consumed"] == host.consumed
    if jax_too and port.hd.micro_block_size == 8:
        jd = jax_codec.decode_band_device(blob)
        assert jd is not None, "JAX sent an 8x8 tiling blob to the host"
        np.testing.assert_array_equal(_bits(got["data"]), _bits(np.asarray(jd.data)))
    return port


def assert_within_bound(port, data, mask, mze_user):
    sel = np.ones((H, W), bool) if mask is None else mask
    got = port.data.numpy().astype(np.float64)
    err = np.abs(got - data.astype(np.float64))[sel].max()
    if np.issubdtype(data.dtype, np.integer):
        limit = 0 if max(0.5, np.floor(mze_user)) == 0.5 else np.floor(mze_user)
    else:
        limit = port.hd.max_z_error * 1.1
    assert err <= limit


CASES = [  # (id, dtype, depth, masked, maxZError, version)
    ("f32-0.001", np.float32, 1, False, 0.001, 6),
    ("f32-0.001-mask", np.float32, 1, True, 0.001, 6),
    ("f32-0.05", np.float32, 1, False, 0.05, 6),
    ("f32-0.05-mask", np.float32, 1, True, 0.05, 6),
    ("i16", np.int16, 1, False, 0.0, 6),
    ("i16-mask", np.int16, 1, True, 0.0, 6),
    ("u16", np.uint16, 1, False, 0.0, 6),
    ("u16-mask", np.uint16, 1, True, 0.0, 6),
    ("i32", np.int32, 1, False, 0.0, 6),
    ("i32-mask", np.int32, 1, True, 0.0, 6),
    ("u8-1", np.uint8, 1, False, 1.0, 6),
    ("u8-1-mask", np.uint8, 1, True, 1.0, 6),
    ("f32-d3-0.01-mask", np.float32, 3, True, 0.01, 6),
    ("i16-d3-v6", np.int16, 3, False, 0.0, 6),
    ("f32-v3-mask", np.float32, 1, True, 0.05, 3),
    ("f32-v5-mask", np.float32, 1, True, 0.05, 5),
]


@pytest.mark.parametrize("dtype,d,masked,mze,version", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_band_blob_matches_jax(dtype, d, masked, mze, version):
    data = make(dtype, d)
    mask = MASK if masked else None
    jblob = jax_codec.encode_band_device(data, mask, mze, version=version)
    pblob = encode_band_device(data, mask, mze, version=version, device="cpu")
    assert pblob == jblob
    port = assert_decodes_like_the_host(jblob)
    assert_within_bound(port, data, mask, mze)
    if masked:
        np.testing.assert_array_equal(port.mask, MASK)
        assert not port.data.numpy()[~MASK].any()  # invalid pixels decode to 0


def test_band_encode_takes_tensors_and_returns_the_index():
    """A tensor band encodes like its numpy array; return_index gives
    (blob, None) as JAX's tiling blobs; verify decodes the fresh blob."""
    data = make(np.float32)
    blob = encode_band_device(data, MASK, 0.05, device="cpu")
    t_blob, index = encode_band_device(torch.from_numpy(data), MASK, 0.05, return_index=True,
                                       verify=True, device="cpu")
    assert t_blob == blob and index is None
    assert jax_codec.encode_band_device(data, MASK, 0.05, return_index=True)[1] is None


def test_band_decode_reuses_the_previous_mask():
    """A blob whose mask section is empty (encode_mask=False) takes the
    previous band's mask, and refuses to decode without one."""
    data = make(np.float32)
    blob = encode_band_device(data, MASK, 0.05, encode_mask=False, device="cpu")
    assert blob == jax_codec.encode_band_device(data, MASK, 0.05, encode_mask=False)
    with pytest.raises(ValueError, match="previous mask"):
        decode_band_device(blob, device="cpu")
    port = decode_band_device(blob, prev_mask=MASK, device="cpu")
    host = lerc2_decode.decode_band(blob, prev_mask=MASK)
    np.testing.assert_array_equal(port.data.numpy(), host.data)
    np.testing.assert_array_equal(port.mask, MASK)
