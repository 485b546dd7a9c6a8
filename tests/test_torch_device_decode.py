"""Port parity: the plain version of K4 (decode_tiles_fast) vs the JAX
device_decode.decode_tiles_fast with the exact ScaleBack (inv_limbs of
decompose_scalar), on the same JAX-made stream and record index.
Criterion: bit-equal image (where `fits`), equal index_ok and fits."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lerc_tpu.constants import DataType as JDataType
from lerc_tpu.ops import device_decode as jax_decode
from lerc_tpu.ops import device_encode as jax_encode
from lerc_tpu.ops.device_softf64 import decompose_scalar
from lerc_tpu_torch.constants import DataType
from lerc_tpu_torch.ops import device_decode


def _dem(h, w, d, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 8, w)[None, :, None]
    y = np.linspace(0, 5, h)[:, None, None]
    z = 900 * np.exp(-((x - 4) ** 2 + (y - 2) ** 2) / 9) + 40 * np.sin(x + y)
    return (z + 0.3 * rng.standard_normal((h, w, d))).astype(np.float32)


def _tile(kind, h, w, d):
    z = _dem(h, w, d)
    if kind == "raw":
        z[0:8, 0:16] = np.where(np.arange(16) % 2, 3.0e6, -1.0)[None, :, None]
    elif kind == "mixed":  # const-0, const-offset and integer-offset blocks
        z[0:8, 0:8] = 0.0
        z[8:16, 0:8] = -12.0
        z[16:24, :] = np.round(z[16:24, :]) - 500
    return z


def _jax_encode(data, mze, nb_cap):
    h, w, d = data.shape
    n_rec = (h // 8) * (w // 8) * d
    cap = -(-(h * w * 4 * d + n_rec * 12 + 4096) // 1024) * 1024
    stream, total, _zmin, zmax, starts, fits = jax_encode.encode_tiles(
        jnp.asarray(data), jnp.ones((h, w), bool), jnp.float32(mze), h, w, d,
        JDataType.FLOAT, True, 6, cap, out_u32=True)
    return np.array(stream), np.array(zmax), np.array(starts)


def _both(stream, zmax, starts, mze, h, w, d, nb_cap):
    limbs, bexp = decompose_scalar(2.0 * mze)
    jimg, jidx, jfits = jax_decode.decode_tiles_fast(
        jnp.asarray(stream), jnp.asarray(starts), jnp.float32(mze), jnp.asarray(zmax),
        h, w, d, JDataType.FLOAT, 6, nb_cap=nb_cap, inv_limbs=limbs, inv_bexp=bexp)
    timg, tidx, tfits = device_decode.decode_tiles_fast(
        torch.from_numpy(stream.view(np.int32)), torch.from_numpy(starts), mze,
        torch.from_numpy(zmax), h, w, d, DataType.FLOAT, 6, nb_cap=nb_cap)
    return (np.asarray(jimg), bool(jidx), bool(jfits)), (timg.numpy(), bool(tidx), bool(tfits))


CASES = [
    # (kind, h, w, d, mze, nb_cap)
    ("dem", 64, 64, 1, 0.001, 0),
    ("dem", 64, 64, 1, 0.01, 16),
    ("raw", 64, 64, 1, 0.001, 16),
    ("dem", 72, 72, 1, 0.005, 0),
    ("dem", 32, 32, 3, 0.01, 0),
    ("raw", 64, 64, 1, 0.001, 0),
    ("mixed", 64, 64, 1, 0.003, 0),
]


@pytest.mark.parametrize("kind,h,w,d,mze,nb_cap", CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}x{c[3]}-{c[4]}-cap{c[5]}" for c in CASES])
def test_decode_tiles_fast_matches_jax(kind, h, w, d, mze, nb_cap):
    data = _tile(kind, h, w, d)
    stream, zmax, starts = _jax_encode(data, mze, nb_cap)
    (jimg, jidx, jfits), (timg, tidx, tfits) = _both(stream, zmax, starts, mze, h, w, d, nb_cap)
    assert (tidx, tfits) == (jidx, jfits)
    assert tidx
    if jfits:
        np.testing.assert_array_equal(timg.view(np.uint32), jimg.view(np.uint32))
        assert np.abs(timg.astype(np.float64) - data).max() <= mze * 1.01 + float(
            np.spacing(np.abs(data).max().astype(np.float32))) / 2
    if kind == "raw":
        assert tfits == (nb_cap == 0)


@pytest.mark.parametrize("r,delta", [(3, 2), (0, -1), (40, 7)])
def test_tampered_index_fails_in_both(r, delta):
    h = w = 64
    data = _dem(h, w, 1, seed=11)
    stream, zmax, starts = _jax_encode(data, 0.01, 0)
    bad = starts.copy()
    bad[r] += delta
    (_, jidx, _), (_, tidx, _) = _both(stream, zmax, bad, 0.01, h, w, 1, 0)
    assert not jidx and not tidx


def test_unported_options_name_their_roadmap_item():
    # LUT records, 16x16 blocks, batched tiles and versions < 4 decode now
    # (the mosaic's K4 instances); edge blocks stay refused, naming no
    # ROADMAP item: JAX's decode_tiles_fast has none either
    stream = torch.zeros(1024, dtype=torch.int32)
    args = (stream, torch.arange(8, dtype=torch.int32), 0.01, torch.zeros(2, 1), 16, 16, 1,
            DataType.FLOAT, 6)
    # (their form: the image and the flags per unit, for every unit count)
    img, ok, _fits, _diff = device_decode.decode_tiles_fast(*args, n_tiles=2)
    assert img.shape == (2, 16, 16, 1) and ok.shape == (2,)
    img, ok, _fits, _diff = device_decode.decode_tiles_fast(
        *args[:1], torch.arange(4, dtype=torch.int32), 0.01, torch.zeros(1), 16, 16, 1,
        DataType.FLOAT, 3, enable_lut=True)
    assert img.shape == (1, 16, 16, 1) and ok.shape == (1,)
    img, *_ = device_decode.decode_tiles_fast(stream, torch.zeros(1, dtype=torch.int32), 0.01,
                                              torch.zeros(1), 16, 16, 1, DataType.FLOAT, 6,
                                              mb=16)
    assert img.shape == (1, 16, 16, 1)
    with pytest.raises(NotImplementedError, match="JAX's decode_tiles_fast has none") as err:
        device_decode.decode_tiles_fast(stream, torch.zeros(6, dtype=torch.int32), 0.01,
                                        torch.zeros(1), 24, 16, 1, DataType.FLOAT, 6, mb=16)
    assert "ROADMAP" not in str(err.value)
    with pytest.raises(NotImplementedError, match="float64 has no indexed decode"):
        device_decode.decode_tiles_fast(*args[:4], 16, 16, 1, DataType.DOUBLE, 6)
