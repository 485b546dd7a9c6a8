"""The port's masked resident path on the CPU (plain versions of the masked
K1, K2 and K4) against the JAX package on the same numpy inputs.

Criteria: the plain rank compaction and expansion equal JAX make_compactor
and make_expander exactly; masked encode_tiles equals the JAX encoder on
stream bytes, total, starts, zmin/zmax and fits; masked decode_tiles_fast
is bit-equal to the JAX decoder with the exact ScaleBack; the masked
FusedResidentCodec equals the JAX codec on header, stream, meta and starts,
decodes bit-equal with +0.0 at invalid pixels, and its blob is the JAX
blob, which the host decoder reads back with the same pixels and mask.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lerc_tpu import native
from lerc_tpu.codec import rle as jax_rle
from lerc_tpu.codec.orchestrator import decode_blob
from lerc_tpu.codec.resident import FusedResidentCodec as JaxCodec
from lerc_tpu.constants import DataType as JDataType
from lerc_tpu.ops import device_decode as jax_decode
from lerc_tpu.ops import device_encode as jax_encode
from lerc_tpu.ops.device_softf64 import decompose_scalar
from lerc_tpu_torch import FusedResidentCodec
from lerc_tpu_torch.codec import bitmask, rle
from lerc_tpu_torch.codec import header as hdr
from lerc_tpu_torch.constants import DataType
from lerc_tpu_torch.interop import codec_kwargs
from lerc_tpu_torch.ops import device_decode, device_encode


def _dem(h, w, d, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 8, w)[None, :, None]
    y = np.linspace(0, 5, h)[:, None, None]
    z = 900 * np.exp(-((x - 4) ** 2 + (y - 2) ** 2) / 9) + 40 * np.sin(x + y)
    return (z + 0.3 * rng.standard_normal((h, w, d))).astype(np.float32)


def _hole_speckle(h, w, seed=0, speckle=0.1):
    """The bench's mask shape at a small size: a rectangular hole plus
    random speckle (bench.py:249-252)."""
    rng = np.random.default_rng(seed)
    mask = np.ones((h, w), bool)
    mask[h // 8 : h // 3, w // 4 : 3 * w // 4] = False
    mask[rng.random((h, w)) > 1 - speckle] = False
    return mask


def _sparse_blocks(h, w, seed=0):
    """Blocks with 0, 1 and 2 valid pixels beside speckled ones; the data
    puts non-integer values on the single pixels (cnt 1: stuff length 5 ties
    raw length 5, so the record is raw) and an integer on one (byte offset,
    const-offset record)."""
    mask = _hole_speckle(h, w, seed, speckle=0.2)
    mask[0:8, 0:8] = False
    mask[3, 5] = True          # block 0: one valid pixel
    mask[0:8, 8:16] = False    # block 1: empty
    mask[8:16, 0:8] = False
    mask[9, 2] = True          # one valid pixel, integer value below
    mask[0:8, 16:24] = False
    mask[1, 17] = mask[6, 22] = True  # two valid pixels
    data = _dem(h, w, 1, seed)
    data[9, 2] = 17.0
    return mask, data


def _rle_len(mask):
    return len(rle.compress(bitmask.bool_to_bits(mask)))


def _mask_with_rle_parity(h, w, parity, seed=0):
    """A hole-and-speckle mask whose RLE length has the given parity (the
    mask section is 4 + that length: odd moves a byte into the dynamic
    header tail)."""
    for s in range(seed, seed + 64):
        mask = _hole_speckle(h, w, s)
        if _rle_len(mask) % 2 == parity:
            return mask
    raise AssertionError("no mask with that RLE parity")


def _case(kind, h, w, d):
    """(mask [H, W] bool, data [H, W, D] float32)."""
    if kind == "sparse":
        mask, data = _sparse_blocks(h, w)
        return mask, np.repeat(data, d, axis=2)
    data = _dem(h, w, d, seed=h + d)
    if kind == "odd":
        return _mask_with_rle_parity(h, w, 1), data
    if kind == "even":
        return _mask_with_rle_parity(h, w, 0), data
    if kind == "raw":  # block range / (2 maxZError) > 2^30 - 1 among valid values
        data[0:8, 0:16] = np.where(np.arange(16) % 2, 3.0e6, -1.0)[None, :, None]
    mask = _hole_speckle(h, w, seed=d)
    if kind == "nan":  # invalid pixels may hold anything
        data[~mask] = np.nan
    return mask, data


def _limit(data, mze):
    return mze * 1.01 + float(np.spacing(np.abs(data).max().astype(np.float32))) / 2


# ---------------------------------------------------------------------------
# the rank routing, the validity words and the mask section
# ---------------------------------------------------------------------------


def _patterns(seed):
    rng = np.random.default_rng(seed)
    density = rng.choice([0.0, 0.02, 0.3, 0.5, 0.9, 1.0], size=(256, 1))
    valid = rng.random((256, 64)) < density
    valid[0], valid[1] = False, True  # an empty and a full block
    vals = rng.integers(0, 2**32, (256, 64), dtype=np.uint64).astype(np.uint32)
    return valid, vals


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_routing_matches_jax(seed):
    valid, vals = _patterns(seed)
    (jc,) = jax_encode.make_compactor(jnp.asarray(valid))(jnp.asarray(vals))
    (je,) = jax_encode.make_expander(jnp.asarray(valid))(jnp.asarray(vals))
    tv, tvals = torch.from_numpy(valid), torch.from_numpy(vals.astype(np.int64))
    tc = device_encode.compact_ref(tvals, tv)
    te = device_encode.expand_ref(tvals, tv)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je).astype(np.int64))
    # expansion inverts compaction on the valid lanes
    np.testing.assert_array_equal(device_encode.expand_ref(tc, tv).numpy(),
                                  np.where(valid, vals, 0).astype(np.int64))


def test_block_valid_words():
    mask, _ = _sparse_blocks(64, 72)
    words = device_encode.block_valid_words(torch.from_numpy(mask))
    assert words.dtype == torch.int32 and words.shape == (8 * 9, 2)
    lanes = device_encode.valid_lanes(words).numpy()
    blocks = mask.reshape(8, 8, 9, 8).transpose(0, 2, 1, 3).reshape(-1, 64)
    np.testing.assert_array_equal(lanes, blocks)
    assert lanes[0].sum() == 1 and lanes[1].sum() == 0 and lanes[2].sum() == 2


@pytest.mark.parametrize("size,seed", [(2048, 0), (64, 1), (72, 2), (40, 3)])
def test_rle_matches_the_jax_package(size, seed):
    """The port's numpy RLE writes the bytes of the native encoder the JAX
    codec uses (and of its Python fallback), on the bench's speckled mask
    at 2048^2 and on small ones; decompress and bits_to_bool invert it."""
    if size == 2048:
        rng = np.random.default_rng(0)
        mask = np.ones((size, size), bool)
        mask[300:800, 500:1500] = False
        mask[rng.random((size, size)) > 0.98] = False
    else:
        mask = _hole_speckle(size, size, seed)
    bits = bitmask.bool_to_bits(mask)
    out = rle.compress(bits)
    assert out == jax_rle.compress(bits)
    if native.available():
        assert out == native.rle_compress(bits)
    back = rle.decompress(out, bits.size)
    assert rle.decompressed_length(out + b"tail") == len(out)
    np.testing.assert_array_equal(bitmask.bits_to_bool(back, size, size), mask)


# ---------------------------------------------------------------------------
# masked encode_tiles and decode_tiles_fast
# ---------------------------------------------------------------------------


def _cap(h, w, d, nb_cap):
    n_rec = (h // 8) * (w // 8) * d
    cap = -(-(h * w * 4 * d + n_rec * 12 + 4096) // 1024) * 1024
    if nb_cap:
        tight = n_rec * (8 + (64 * min(nb_cap, 32) + 7) // 8) + 4096
        cap = min(cap, -(-tight // 1024) * 1024)
    return cap


ENC_CASES = [
    # (kind, h, w, d, mze, nb_cap)
    ("hole", 64, 64, 1, 0.001, 0),
    ("hole", 64, 64, 1, 0.01, 0),
    ("hole", 72, 72, 1, 0.005, 0),
    ("hole", 32, 32, 3, 0.001, 0),
    ("hole", 64, 64, 1, 0.0, 0),
    ("sparse", 64, 64, 1, 0.001, 0),
    ("sparse", 32, 32, 3, 0.002, 0),
    ("raw", 64, 64, 1, 0.001, 0),
    ("nan", 64, 64, 1, 0.001, 0),
]


@functools.lru_cache(maxsize=None)
def _jax_encoded(kind, h, w, d, mze, nb_cap):
    mask, data = _case(kind, h, w, d)
    out = jax_encode.encode_tiles(
        jnp.asarray(data), jnp.asarray(mask), jnp.float32(mze), h, w, d, JDataType.FLOAT,
        False, 6, _cap(h, w, d, nb_cap), nb_cap=nb_cap, out_u32=True)
    return mask, data, tuple(np.array(a) for a in out)


@pytest.mark.parametrize("kind,h,w,d,mze,nb_cap", ENC_CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}x{c[3]}-{c[4]}-cap{c[5]}" for c in ENC_CASES])
def test_masked_encode_tiles_matches_jax(kind, h, w, d, mze, nb_cap):
    mask, data, (js, jtotal, jzmin, jzmax, jstarts, jfits) = _jax_encoded(kind, h, w, d, mze, nb_cap)
    valid = device_encode.block_valid_words(torch.from_numpy(mask))
    cap = _cap(h, w, d, nb_cap)
    ts, ttotal, tzmin, tzmax, tstarts, tfits = device_encode.encode_tiles(
        torch.from_numpy(data), valid, mze, h, w, d, DataType.FLOAT, False, 6, cap,
        nb_cap=nb_cap)
    assert int(ttotal) == int(jtotal)
    assert bool(tfits) == bool(jfits)
    np.testing.assert_array_equal(tstarts.numpy(), jstarts)
    np.testing.assert_array_equal(tzmin.numpy(), jzmin)
    np.testing.assert_array_equal(tzmax.numpy(), jzmax)
    assert bool(jfits)
    total = int(jtotal)
    assert ts.numpy().tobytes()[:total] == js.tobytes()[:total]
    assert not ts.numpy().view(np.uint8)[total:].any(), "stream not zero past total"


def test_masked_encode_record_lengths():
    """The sparse tile reaches the small-count records: an empty block is
    one const-0 byte, a single non-integer pixel is raw (1 + 4 B, the
    stuff record ties it), a single integer pixel is a const-offset record
    with a byte offset (1 + 1 B)."""
    mask, data = _sparse_blocks(64, 64)
    valid = device_encode.block_valid_words(torch.from_numpy(mask))
    p = device_encode.encode_params(0.001, 6)
    rec_info, _, _ = device_encode.encode_blocks_ref(torch.from_numpy(data), p, valid)
    length, mode = rec_info[:, 0], (rec_info[:, 1] >> 8) & 3
    assert (int(length[0]), int(mode[0])) == (5, 0)
    assert (int(length[1]), int(mode[1])) == (1, 2)
    assert (int(length[8]), int(mode[8])) == (2, 3)


def test_masked_encode_needs_the_validity_words():
    with pytest.raises(ValueError, match="validity words"):
        device_encode.encode_tiles(torch.zeros(16, 16, 1), None, 0.01, 16, 16, 1,
                                   DataType.FLOAT, False, 6, 4096)
    with pytest.raises(ValueError, match="int32"):
        device_encode.encode_tiles(torch.zeros(16, 16, 1), torch.zeros(4, 2), 0.01, 16, 16, 1,
                                   DataType.FLOAT, False, 6, 4096)


DEC_CASES = [c for c in ENC_CASES if c[0] in ("hole", "sparse", "raw")]


@pytest.mark.parametrize("kind,h,w,d,mze,nb_cap", DEC_CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}x{c[3]}-{c[4]}-cap{c[5]}" for c in DEC_CASES])
def test_masked_decode_tiles_fast_matches_jax(kind, h, w, d, mze, nb_cap):
    mask, data, (js, _total, _zmin, jzmax, jstarts, _fits) = _jax_encoded(kind, h, w, d, mze, nb_cap)
    inv_kw = {}
    if mze:
        limbs, bexp = decompose_scalar(2.0 * mze)
        inv_kw = dict(inv_limbs=limbs, inv_bexp=bexp)
    jimg, jidx, jfits = jax_decode.decode_tiles_fast(
        jnp.asarray(js), jnp.asarray(jstarts), jnp.float32(mze), jnp.asarray(jzmax),
        h, w, d, JDataType.FLOAT, 6, nb_cap=nb_cap, mask=jnp.asarray(mask), **inv_kw)
    valid = device_encode.block_valid_words(torch.from_numpy(mask))
    timg, tidx, tfits = device_decode.decode_tiles_fast(
        torch.from_numpy(js.view(np.int32)), torch.from_numpy(jstarts), mze,
        torch.from_numpy(jzmax), h, w, d, DataType.FLOAT, 6, nb_cap=nb_cap, mask=valid)
    assert (bool(tidx), bool(tfits)) == (bool(jidx), bool(jfits)) == (True, True)
    timg = timg.numpy()
    np.testing.assert_array_equal(timg.view(np.uint32), np.asarray(jimg).view(np.uint32))
    assert not timg.view(np.uint32)[~mask].any(), "invalid pixels must be +0.0"
    assert np.abs(timg.astype(np.float64) - data)[mask].max() <= _limit(data[mask], mze)


def test_masked_decode_with_a_wrong_mask_fails_the_index():
    mask, _data, (js, _t, _zmin, jzmax, jstarts, _f) = _jax_encoded("hole", 64, 64, 1, 0.001, 0)
    wrong = mask.copy()
    wrong[40:48, :] = ~wrong[40:48, :]
    valid = device_encode.block_valid_words(torch.from_numpy(wrong))
    _img, idx, _fits = device_decode.decode_tiles_fast(
        torch.from_numpy(js.view(np.int32)), torch.from_numpy(jstarts), 0.001,
        torch.from_numpy(jzmax), 64, 64, 1, DataType.FLOAT, 6, mask=valid)
    assert not bool(idx)


# ---------------------------------------------------------------------------
# FusedResidentCodec(mask=...) end to end
# ---------------------------------------------------------------------------


CODEC_CASES = [
    # (kind, h, w, d, mze, nb_cap)
    ("hole", 64, 64, 1, 0.001, 0),
    ("hole", 64, 64, 1, 0.01, 16),
    ("hole", 72, 72, 1, 0.005, 0),
    ("hole", 32, 32, 3, 0.001, 0),
    ("hole", 32, 32, 1, 0.0, 0),
    ("odd", 48, 48, 1, 0.002, 0),
    ("even", 48, 48, 1, 0.002, 0),
    ("sparse", 64, 64, 1, 0.001, 0),
]


# nb_cap 16 (one JAX compile of its static-chain kernels) runs here only:
# the port packs every cap alike, and the cap decides just `fits`
@pytest.mark.parametrize("kind,h,w,d,mze,nb_cap", CODEC_CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}x{c[3]}-{c[4]}-cap{c[5]}" for c in CODEC_CASES])
def test_masked_codec_matches_jax(kind, h, w, d, mze, nb_cap):
    mask, data = _case(kind, h, w, d)
    if kind in ("odd", "even"):
        assert (4 + _rle_len(mask)) % 2 == (kind == "odd")
    jax_codec = JaxCodec(h, w, d, np.float32, mze, nb_cap=nb_cap, mask=mask)
    jblob = [np.asarray(a) for a in jax_codec.encode_fast(jnp.asarray(data))]
    jimg, jok = jax_codec.decode_fast(*(jnp.asarray(a) for a in (jblob[0], jblob[1], jblob[3])))
    codec = FusedResidentCodec(**codec_kwargs(h, w, d, np.float32, mze, 6, nb_cap, mask),
                               device="cpu")
    assert codec.num_valid == int(mask.sum()) and codec.valid is not None
    header, stream, meta, starts = codec.encode_fast(torch.from_numpy(data))

    np.testing.assert_array_equal(header.numpy(), jblob[0])
    np.testing.assert_array_equal(meta.numpy(), jblob[2])
    np.testing.assert_array_equal(starts.numpy(), jblob[3])
    total = int(meta[0])
    assert stream.numpy().tobytes()[:total] == jblob[1].tobytes()[:total]
    assert int(meta[2]) == 1

    img, ok = codec.decode_fast(header, stream, starts)
    assert bool(ok) and bool(jok)
    img = img.numpy()
    np.testing.assert_array_equal(img.view(np.uint32), np.asarray(jimg).view(np.uint32))
    assert not img.view(np.uint32)[~mask].any(), "invalid pixels must be +0.0"
    assert np.abs(img.astype(np.float64) - data)[mask].max() <= _limit(data[mask], mze)

    blob = codec.blob_to_bytes(header, stream, meta)
    assert blob == jax_codec.blob_to_bytes(*(jnp.asarray(a) for a in jblob[:3]))
    head, _ = hdr.read_header(blob)
    assert (head.num_valid_pixel, head.blob_size) == (int(mask.sum()), len(blob))
    res = decode_blob(blob)
    np.testing.assert_array_equal(res.masks[0], mask)
    host = res.data[0].reshape(h, w, d)
    np.testing.assert_array_equal(host[mask], img[mask])


def test_all_true_mask_gives_the_all_valid_blob():
    h = w = 64
    data = torch.from_numpy(_dem(h, w, 1, seed=4))
    plain = FusedResidentCodec(h, w, 1, np.float32, 0.001, device="cpu")
    ones = FusedResidentCodec(h, w, 1, np.float32, 0.001, mask=np.ones((h, w), bool),
                              device="cpu")
    assert ones.valid is None and ones.num_valid == h * w
    a, b = plain.encode_fast(data), ones.encode_fast(data)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert plain.blob_to_bytes(*a[:3]) == ones.blob_to_bytes(*b[:3])


def test_mask_errors():
    with pytest.raises(ValueError, match="valid pixel"):
        FusedResidentCodec(16, 16, 1, np.float32, 0.01, mask=np.zeros((16, 16), bool),
                           device="cpu")
    with pytest.raises(ValueError, match="shape"):
        FusedResidentCodec(16, 16, 1, np.float32, 0.01, mask=np.ones((16, 8), bool),
                           device="cpu")
    codec = FusedResidentCodec(16, 16, 1, np.float32, 0.01, mask=_hole_speckle(16, 16),
                               device="cpu")
    header, stream, _meta, _starts = codec.encode_fast(torch.zeros(16, 16, 1))
    with pytest.raises(ValueError, match="record-offset index"):
        codec.decode_fast(header, stream)


def test_torch_mask_equals_numpy_mask():
    mask = _hole_speckle(32, 32, seed=5)
    a = FusedResidentCodec(32, 32, 1, np.float32, 0.01, mask=mask, device="cpu")
    b = FusedResidentCodec(32, 32, 1, np.float32, 0.01, mask=torch.from_numpy(mask),
                           device="cpu")
    assert a._static_mid == b._static_mid and torch.equal(a.valid, b.valid)


def test_wrong_mask_detected():
    """As tests/test_resident.py:221: a decode mask inconsistent with the
    stream fails by ok False, or by ValueError when the header layouts
    differ."""
    h = w = 64
    mask = np.ones((h, w), bool)
    mask[8:24, 8:40] = False
    data = torch.from_numpy(_dem(h, w, 1, seed=14))
    enc = FusedResidentCodec(h, w, 1, np.float32, 0.01, nb_cap=16, mask=mask, device="cpu")
    hh, ss, _mm, st = enc.encode_fast(data)
    for rows in (slice(32, 40), slice(33, 34)):
        wrong = mask.copy()
        wrong[rows, :] = ~wrong[rows, :]
        dec = FusedResidentCodec(h, w, 1, np.float32, 0.01, nb_cap=16, mask=wrong,
                                 device="cpu")
        try:
            _img, ok = dec.decode_fast(hh, ss, st)
        except ValueError:
            continue  # a differing header layout is rejected up front
        assert not bool(ok)
    assert bool(enc.decode_fast(hh, ss, st)[1])
