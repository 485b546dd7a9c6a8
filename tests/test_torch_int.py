"""Port parity for integer rasters: lerc_tpu_torch encode_tiles (plain
versions of the integer K1 + K2 instances) and decode_tiles_fast (integer
K4) vs the JAX device_encode.encode_tiles / device_decode.decode_tiles_fast
on the same seeded tiles, for all six integer dtypes.

Criteria (all exact): stream bytes up to `total`, total, starts, fits and
the int32 per-depth zmin/zmax equal to JAX's (uint32: the bits of the
unsigned ranges, where JAX's are in signed order); decoded image, index_ok and
fits equal to JAX's wherever JAX's index check passes. Where the encoder
wrote depth-diff records (v >= 5, lossless 8/16-bit, depth > 1) both
decoders report index_ok False: the indexed decode has no previous slice
to add (the index-free decode in tests/test_torch_scan.py takes them).

The tiles carry band-correlated slices (diff records), block minima at the
offset reduction boundaries (-129, -128, 127, 255, 256, 32767, 65535), a
constant block, a raw block, a block of lossy-quantization ties and, for
the 4-byte dtypes, a block spanning the dtype's range (int32 wrap-around).
JAX compiles once per (dtype, depth, version, nb_cap); maxZError is traced,
so the lossless and lossy cases of a shape share a compile.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lerc_tpu.constants import DataType as JDataType
from lerc_tpu.ops import device_decode as jax_decode
from lerc_tpu.ops import device_encode as jax_encode
from lerc_tpu_torch.constants import DT_SIZE, DT_TO_TORCH, NUMPY_TO_DT, DataType
from lerc_tpu_torch.ops import device_decode, device_encode

H = W = 32
DTYPES = (np.uint8, np.int8, np.int16, np.uint16, np.int32, np.uint32)
BOUNDARIES = (-129, -128, 127, 255, 256, 32767, 65535, 0, 7)


def int_tile(npdt, h, w, d, seed=0):
    """A smooth integer raster whose slices differ by small steps, with the
    special blocks listed in the module docstring."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(npdt)
    lo, hi = max(info.min, -40000), min(info.max, 70000)
    x = np.linspace(0, 6, w)[None, :]
    y = np.linspace(0, 4, h)[:, None]
    base = (np.sin(x + y) * 0.5 + 0.5) * (hi - lo) * 0.3 + lo + (hi - lo) * 0.2
    bands = [base + rng.integers(-2, 3, (h, w))]
    for _ in range(1, d):
        bands.append(bands[-1] + rng.integers(-3, 2, (h, w)))
    z = np.stack(bands, -1)
    nbh = w // 8
    for i, v in enumerate(b for b in BOUNDARIES if lo <= b <= hi - 10):
        r, c = divmod(i, nbh)
        z[r * 8:(r + 1) * 8, c * 8:(c + 1) * 8] = v + rng.integers(0, 10, (8, 8, d))
    z[-8:, -8:] = z[-8, -8, 0]                                      # constant block
    z[-8:, :8, 0] = 0                                               # a zero slice
    z[-16:-8, :8] = rng.integers(lo, hi, (8, 8, d))                 # raw (lossless)
    tie = lo + 10 + 2 * np.arange(64).reshape(8, 8)  # every other value a tie at mze 2
    z[-8:, 8:16] = tie[:, :, None]
    if info.bits == 32:
        z[-16:-8, 8:16] = rng.integers(info.min, info.max, (8, 8, d), dtype=np.int64)
        z[-16, 8] = info.min
        z[-9, 15] = info.max
    return np.clip(z, info.min, info.max).astype(npdt)


def cap_of(npdt, h, w, d, nb_cap):
    """The resident codec's stream capacity (resident.py:64-75)."""
    size = np.dtype(npdt).itemsize
    n_rec = (h // 8) * (w // 8) * d
    cap = -(-(h * w * size * d + n_rec * 12 + 4096) // 1024) * 1024
    if nb_cap:
        tight = n_rec * (8 + (64 * min(nb_cap, 8 * size) + 7) // 8) + 4096
        cap = min(cap, -(-tight // 1024) * 1024)
    return cap


_JAX = {}


def jax_encoded(npdt, d, version, mze, nb_cap):
    """JAX encode_tiles of the case's tile (cached for the decode tests)."""
    key = (np.dtype(npdt).name, d, version, mze, nb_cap)
    if key not in _JAX:
        data = int_tile(npdt, H, W, d)
        dt = JDataType(int(NUMPY_TO_DT[np.dtype(npdt)]))
        out = jax_encode.encode_tiles(
            jnp.asarray(data), jnp.ones((H, W), bool), jnp.float32(mze), H, W, d, dt, True,
            version, cap_of(npdt, H, W, d, nb_cap), nb_cap=nb_cap, out_u32=True)
        _JAX[key] = (data, *(np.array(a) for a in out))
    return _JAX[key]


CASES = [(npdt, d, version, mze, nb_cap)
         for npdt in DTYPES
         for d, version, nb_cap in ((3, 6, 0), (3, 4, 0), (1, 6, 0))
         for mze in (0.5, 2.0)]
# the static-pack compile of a capped JAX encode costs seconds: two dtypes
CASES += [(npdt, 1, 5, mze, 16) for npdt in (np.uint8, np.int16) for mze in (0.5, 2.0)]
IDS = [f"{np.dtype(c[0]).name}-d{c[1]}-v{c[2]}-{c[3]}-cap{c[4]}" for c in CASES]


@pytest.mark.parametrize("npdt,d,version,mze,nb_cap", CASES, ids=IDS)
def test_int_encode_tiles_matches_jax(npdt, d, version, mze, nb_cap):
    data, js, jtotal, jzmin, jzmax, jstarts, jfits = jax_encoded(npdt, d, version, mze, nb_cap)
    dt = NUMPY_TO_DT[np.dtype(npdt)]
    cap = cap_of(npdt, H, W, d, nb_cap)
    ts, ttotal, tzmin, tzmax, tstarts, tfits = device_encode.encode_tiles(
        torch.from_numpy(data), None, mze, H, W, d, dt, True, version, cap, nb_cap=nb_cap)
    assert int(ttotal) == int(jtotal)
    assert bool(tfits) == bool(jfits)
    np.testing.assert_array_equal(tstarts.numpy(), jstarts)
    assert tzmin.dtype == tzmax.dtype == torch.int32
    # int32 values, as JAX's xb.astype(int32): uint32 wraps, and JAX orders
    # its bits as int32; the port's uint32 ranges are unsigned (repair P6)
    np.testing.assert_array_equal(jzmin, data.reshape(-1, d).astype(np.int32).min(0))
    if dt == DataType.UINT:
        for t, want in ((tzmin, data.reshape(-1, d).min(0)), (tzmax, data.reshape(-1, d).max(0))):
            np.testing.assert_array_equal(t.numpy().view(np.uint32), want)
    else:
        np.testing.assert_array_equal(tzmin.numpy(), jzmin)
        np.testing.assert_array_equal(tzmax.numpy(), jzmax)
    total = int(jtotal)
    if bool(jfits):
        assert ts.numpy().tobytes()[:total] == js.tobytes()[:total]
        assert not ts.numpy().view(np.uint8)[total:].any(), "stream not zero past total"
    flags = js.view(np.uint8)[jstarts]
    if version >= 5 and d > 1 and mze == 0.5 and DT_SIZE[dt] <= 2:
        assert ((flags & 4) != 0).sum() > 0, "the tile should reach depth-diff records"
    if DT_SIZE[dt] == 4 or version < 5:
        assert version < 5 or not ((flags & 4) != 0).any()  # 32-bit ints never diff


def test_int_input_as_int32_equals_native_dtype():
    """JAX takes int32 or the native dtype (xb.astype(int32)); so does the
    port, with the same bytes."""
    for npdt in (np.uint8, np.int16):
        data = int_tile(npdt, H, W, 3)
        dt = NUMPY_TO_DT[np.dtype(npdt)]
        args = (None, 0.5, H, W, 3, dt, True, 6, cap_of(npdt, H, W, 3, 0))
        a = device_encode.encode_tiles(torch.from_numpy(data), *args)
        b = device_encode.encode_tiles(torch.from_numpy(data.astype(np.int32)), *args)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("npdt,d,version,mze,nb_cap", CASES, ids=IDS)
def test_int_decode_tiles_fast_matches_jax(npdt, d, version, mze, nb_cap):
    data, js, _jtotal, _jzmin, jzmax, jstarts, jfits = jax_encoded(npdt, d, version, mze, nb_cap)
    assert bool(jfits)  # every case fits its cap
    dt = NUMPY_TO_DT[np.dtype(npdt)]
    zmax = jzmax.astype(np.int32)
    jimg, jidx, jfit = jax_decode.decode_tiles_fast(
        jnp.asarray(js), jnp.asarray(jstarts), jnp.float32(mze), jnp.asarray(zmax), H, W, d,
        JDataType(int(dt)), version, nb_cap=nb_cap)
    timg, tidx, tfit = device_decode.decode_tiles_fast(
        torch.from_numpy(js.view(np.int32).copy()), torch.from_numpy(jstarts), mze,
        torch.from_numpy(zmax), H, W, d, dt, version, nb_cap=nb_cap)
    assert timg.dtype == DT_TO_TORCH[dt] and timg.shape == (H, W, d)
    assert bool(tfit) == bool(jfit)
    n_diff = int(((js.view(np.uint8)[jstarts] & 4) != 0).sum()) if version >= 5 else 0
    if n_diff:
        # a diff record: both decoders refuse the index (JAX through the
        # misread record length, the port on purpose)
        assert not bool(jidx) and not bool(tidx)
        return
    assert bool(jidx) and bool(tidx)
    np.testing.assert_array_equal(timg.numpy(), np.asarray(jimg))
    err = np.abs(timg.numpy().astype(np.int64) - data.astype(np.int64)).max()
    assert err <= (0 if mze == 0.5 else int(mze))


def test_v4_integrity_bit_2_is_no_diff():
    """At v4 flag bit 2 is an integrity bit (device_encode.py:575-577): the
    integer K4 must not take it for a diff record."""
    npdt, d = np.int16, 3
    data, js, _t, _zmin, jzmax, jstarts, _f = jax_encoded(npdt, d, 4, 0.5, 0)
    assert ((js.view(np.uint8)[jstarts] & 4) != 0).any()
    img, idx, fits = device_decode.decode_tiles_fast(
        torch.from_numpy(js.view(np.int32).copy()), torch.from_numpy(jstarts), 0.5,
        torch.from_numpy(jzmax.astype(np.int32)), H, W, d, DataType.SHORT, 4)
    assert bool(idx) and bool(fits)
    np.testing.assert_array_equal(img.numpy(), data)


@pytest.mark.parametrize("dt", [DataType.SHORT, DataType.USHORT, DataType.INT, DataType.UINT])
def test_reduce_offset_boundaries(dt):
    """The reduced offset type and width of the integer K1 equal JAX's
    _reduce_offset_int on both sides of every reduction boundary."""
    from lerc_tpu.ops.device_encode import _reduce_offset_int

    z = torch.tensor([-32769, -32768, -129, -128, -1, 0, 127, 128, 255, 256, 32767, 32768,
                      65535, 65536], dtype=torch.int64)
    tc, off_w = device_encode.reduce_offset_int_ref(z, dt)
    jtc, joff_w = _reduce_offset_int(jnp.asarray(z.numpy().astype(np.int32)), JDataType(int(dt)))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jtc))
    np.testing.assert_array_equal(off_w.numpy(), np.asarray(joff_w))
