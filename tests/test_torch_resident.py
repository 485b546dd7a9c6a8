"""The port's slice end to end on the CPU: lerc_tpu_torch FusedResidentCodec
(plain versions of K1-K4) vs the JAX FusedResidentCodec and the host
decoder, on the same tiles.

Criteria: header, stream bytes, meta and starts equal to the JAX
_encode_fused; image and ok equal to _decode_fused_fast (image bit-equal);
blob_to_bytes equal to the JAX blob and decoded bit-equal by the JAX host
decoder; blobs cross between the packages through lerc_tpu_torch.interop.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lerc_tpu.codec.orchestrator import decode_blob
from lerc_tpu.codec.resident import FusedResidentCodec as JaxCodec
from lerc_tpu_torch import FusedResidentCodec
from lerc_tpu_torch.codec import header as hdr
from lerc_tpu_torch.interop import blob_from_numpy, blob_to_numpy, codec_kwargs


def _dem(h, w, d, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 8, w)[None, :, None]
    y = np.linspace(0, 5, h)[:, None, None]
    z = 900 * np.exp(-((x - 4) ** 2 + (y - 2) ** 2) / 9) + 40 * np.sin(x + y)
    return (z + 0.3 * rng.standard_normal((h, w, d))).astype(np.float32)


def _limit(data, mze):
    # quantization error (<= mze) plus the final cast's half ulp, as
    # tests/test_resident.py:47
    return mze * 1.01 + float(np.spacing(np.abs(data).max().astype(np.float32))) / 2


def _port(h, w, d, mze, nb_cap=0):
    return FusedResidentCodec(**codec_kwargs(h, w, d, np.float32, mze, 6, nb_cap),
                              device="cpu")


CASES = [
    # (h, w, d, mze, nb_cap, seed)
    (64, 64, 1, 0.001, 0, 0),
    (64, 64, 1, 0.01, 16, 11),
    (72, 72, 1, 0.005, 0, 5),
    (32, 32, 3, 0.001, 0, 7),
    (32, 32, 1, 0.0, 0, 1),  # lossless: raw records and the image-encode-mode byte
]


@pytest.mark.parametrize("h,w,d,mze,nb_cap,seed", CASES,
                         ids=[f"{c[0]}x{c[1]}x{c[2]}-{c[3]}-cap{c[4]}" for c in CASES])
def test_fused_codec_matches_jax(h, w, d, mze, nb_cap, seed):
    data = _dem(h, w, d, seed)
    jax_codec = JaxCodec(h, w, d, np.float32, mze, nb_cap=nb_cap)
    jblob = [np.asarray(a) for a in jax_codec.encode_fast(jnp.asarray(data))]
    jimg, jok = jax_codec.decode_fast(*(jnp.asarray(a) for a in (jblob[0], jblob[1], jblob[3])))
    codec = _port(h, w, d, mze, nb_cap)
    header, stream, meta, starts = codec.encode_fast(torch.from_numpy(data))

    np.testing.assert_array_equal(header.numpy(), jblob[0])
    np.testing.assert_array_equal(meta.numpy(), jblob[2])
    np.testing.assert_array_equal(starts.numpy(), jblob[3])
    total = int(meta[0])
    assert stream.numpy().tobytes()[:total] == jblob[1].tobytes()[:total]
    assert int(meta[2]) == 1

    img, ok = codec.decode_fast(header, stream, starts)
    assert bool(ok) and bool(jok)
    assert img.shape == (h, w, d)
    np.testing.assert_array_equal(img.numpy().view(np.uint32), np.asarray(jimg).view(np.uint32))
    assert np.abs(img.numpy().astype(np.float64) - data).max() <= _limit(data, mze)

    # wire: the same bytes as the JAX blob; the host decoder (which checks
    # Fletcher32 itself) reproduces the port's pixels bit for bit
    blob = codec.blob_to_bytes(header, stream, meta)
    assert blob == jax_codec.blob_to_bytes(*(jnp.asarray(a) for a in jblob[:3]))
    head, _ = hdr.read_header(blob)
    assert (head.n_rows, head.n_cols, head.n_depth, head.blob_size) == (h, w, d, len(blob))
    host = decode_blob(blob).data[0]
    np.testing.assert_array_equal(host.reshape(h, w, d), img.numpy())


def test_blobs_cross_between_packages():
    h = w = 64
    data = _dem(h, w, 1, seed=3)
    jax_codec = JaxCodec(h, w, 1, np.float32, 0.004)
    codec = _port(h, w, 1, 0.004)
    # JAX blob -> port decode
    jblob = [np.asarray(a) for a in jax_codec.encode_fast(jnp.asarray(data))]
    header, stream, _meta, starts = blob_from_numpy(*jblob, device="cpu")
    img, ok = codec.decode_fast(header, stream, starts)
    assert bool(ok)
    jimg, _ = jax_codec.decode_fast(*(jnp.asarray(jblob[i]) for i in (0, 1, 3)))
    np.testing.assert_array_equal(img.numpy(), np.asarray(jimg))
    # port blob -> JAX decode
    pblob = blob_to_numpy(*codec.encode_fast(torch.from_numpy(data)))
    assert pblob[1].dtype == np.uint32
    jimg2, jok2 = jax_codec.decode_fast(*(jnp.asarray(pblob[i]) for i in (0, 1, 3)))
    assert bool(jok2)
    np.testing.assert_array_equal(np.asarray(jimg2), img.numpy())


def test_nb_cap_grouped_matches_full():
    """As tests/test_resident.py:138: when every block fits the cap, the
    capped codec's header, wire bytes and index equal the uncapped ones."""
    h = w = 64
    data = torch.from_numpy(_dem(h, w, 1, seed=11))
    full, capped = _port(h, w, 1, 0.01), _port(h, w, 1, 0.01, nb_cap=16)
    h0, s0, m0, st0 = full.encode_fast(data)
    h1, s1, m1, st1 = capped.encode_fast(data)
    assert int(m1[2]) == 1
    assert capped.cap < full.cap
    np.testing.assert_array_equal(h0.numpy(), h1.numpy())
    total = int(m0[0])
    assert int(m1[0]) == total
    assert s0.numpy().tobytes()[:total] == s1.numpy().tobytes()[:total]
    np.testing.assert_array_equal(st0.numpy(), st1.numpy())
    img0, ok0 = full.decode_fast(h0, s0, st0)
    img1, ok1 = capped.decode_fast(h1, s1, st1)
    assert bool(ok0) and bool(ok1)
    np.testing.assert_array_equal(img0.numpy(), img1.numpy())  # one ScaleBack: bit-equal


def test_nb_cap_unfit_flags():
    """As tests/test_resident.py:168: blocks needing > 16 packed bits make
    the capped codec report unfit (meta[2] == 0, decode ok False); the
    uncapped codec encodes them within the error bound."""
    h = w = 64
    data = np.random.default_rng(5).normal(0, 150, (h, w, 1)).astype(np.float32)
    capped = _port(h, w, 1, 0.001, nb_cap=16)
    hh, ss, mm, st = capped.encode_fast(torch.from_numpy(data))
    assert int(mm[2]) == 0
    _img, ok = capped.decode_fast(hh, ss, st)
    assert not bool(ok)
    full = _port(h, w, 1, 0.001)
    hh, ss, mm, st = full.encode_fast(torch.from_numpy(data))
    img, ok = full.decode_fast(hh, ss, st)
    assert bool(ok) and int(mm[2]) == 1
    assert np.abs(img.numpy() - data).max() <= 0.001 * 1.1
    res = decode_blob(full.blob_to_bytes(hh, ss, mm))
    assert np.abs(res.data[0] - data).max() <= 0.001 * 1.1


def test_constant_tile_keeps_the_fused_layout():
    """A constant image keeps the ranges, flags and record bytes (the fused
    JAX encoder's layout), and round-trips exactly."""
    h = w = 32
    data = np.full((h, w, 1), 7.25, np.float32)
    jax_codec = JaxCodec(h, w, 1, np.float32, 0.01)
    jblob = [np.asarray(a) for a in jax_codec.encode_fast(jnp.asarray(data))]
    codec = _port(h, w, 1, 0.01)
    header, stream, meta, starts = codec.encode_fast(torch.from_numpy(data))
    np.testing.assert_array_equal(header.numpy(), jblob[0])
    np.testing.assert_array_equal(meta.numpy(), jblob[2])
    assert int(meta[0]) == (h // 8) * (w // 8) * 5  # flag + 4-byte float offset
    img, ok = codec.decode_fast(header, stream, starts)
    assert bool(ok)
    np.testing.assert_array_equal(img.numpy(), data)


def test_tampered_checksum_and_index_detected():
    h = w = 64
    codec = _port(h, w, 1, 0.01)
    header, stream, meta, starts = codec.encode_fast(torch.from_numpy(_dem(h, w, 1, seed=11)))
    bad = starts.clone()
    bad[3] += 2
    assert not bool(codec.decode_fast(header, stream, bad)[1])
    flipped = stream.clone()
    flipped[5] ^= 1 << 9
    assert not bool(codec.decode_fast(header, flipped, starts)[1])
    assert bool(codec.decode_fast(header, stream, starts)[1])


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedResidentCodec(64, 64)


def test_unported_paths_name_their_roadmap_item():
    # integer dtypes and decode without the index are ported (queue 1 item
    # 5), a masked decode without the index too (item 6: the host record
    # scanner and the masked K6); float64 has none (nor has JAX's)
    from lerc_tpu_torch import ResidentCodec

    mask = np.ones((16, 16), bool)
    mask[3, 4] = False
    codec = ResidentCodec(16, 16, 1, np.float32, 0.01, mask=mask, device="cpu")
    blob = codec.encode(torch.arange(256, dtype=torch.float32).reshape(16, 16, 1))
    indexed = codec.decode(blob)
    blob.starts = None
    assert torch.equal(codec.decode(blob), indexed)
    with pytest.raises(NotImplementedError, match="float64 has no resident codec"):
        FusedResidentCodec(16, 16, 1, np.float64, 0.5, device="cpu")
