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
from lerc_tpu_torch import FusedResidentCodec
from lerc_tpu_torch.codec import lerc2_decode
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


def strip_tile(npdt, h, w, d, seed):
    """Band-correlated slices (depth-diff records at v >= 5) with, block by
    block in turn, a const-0, a const-offset and a full-range (raw) block."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(npdt)
    lo, hi = max(info.min, -40000), min(info.max, 70000)
    x = np.linspace(0, 6, w)[None, :]
    y = np.linspace(0, 4, h)[:, None]
    bands = [(np.sin(x + y) * 0.5 + 0.5) * (hi - lo) * 0.3 + lo + (hi - lo) * 0.2
             + rng.integers(-2, 3, (h, w))]
    for _ in range(1, d):
        bands.append(bands[-1] + rng.integers(-3, 2, (h, w)))
    z = np.round(np.stack(bands, -1))
    nbh = w // 8
    for b in range(h // 8 * nbh):
        blk = (slice(8 * (b // nbh), 8 * (b // nbh) + 8), slice(8 * (b % nbh), 8 * (b % nbh) + 8))
        z[blk] = (z[blk], 0, 7, rng.integers(info.min, info.max, (8, 8, d), endpoint=True))[b % 4]
    return np.clip(z, info.min, info.max).astype(npdt)


def strip_mask(h, w):
    """A hole and a sprinkle of invalid pixels (the bench mask's shape)."""
    mask = np.ones((h, w), bool)
    mask[h // 8: max(h // 8 + 1, h // 3), w // 4: 3 * w // 4] = False
    mask[np.random.default_rng(h * w).random((h, w)) > 0.9] = False
    return mask


def strip_cases():
    """(dtype, depth, version, masked, H, W) at the edges of the strips the
    CTAs of the integer K4 and K6 own (device_decode.strip_blocks: S blocks
    a strip): a row of S - 1 blocks (a partial strip, one block row), two
    rows of S + 1 blocks (a strip and one block), and one block column."""
    out = []
    for npdt in (np.uint8, np.int16):
        for d in (1, 2, 3, 5):
            s = device_decode.strip_blocks(8, d, np.dtype(npdt).itemsize)
            shapes = ((8, 8 * (s - 1)), (16, 8 * s + 8), (40, 8))
            for version in (4, 6):
                for masked in (False, True):
                    out.append((npdt, d, version, masked, *shapes[(d + version + masked) % 3]))
    return out


@pytest.mark.parametrize("mb,d,size,s", [(8, 3, 1, 32), (8, 1, 4, 32), (8, 1, 8, 16), (8, 5, 1, 25),
                                         (8, 8, 4, 4), (8, 40, 4, 1), (16, 1, 2, 8), (16, 20, 2, 1)])
def test_strip_blocks(mb, d, size, s):
    """The strip kernels' blocks a CTA: 2,048 pixels and 8 KB of image at
    most, one block (its depths in chunks) past that."""
    assert device_decode.strip_blocks(mb, d, size) == s


STRIP_CASES = strip_cases()
STRIP_IDS = [f"{np.dtype(c[0]).name}-d{c[1]}-v{c[2]}-{'masked' if c[3] else 'valid'}-"
             f"{c[4]}x{c[5]}" for c in STRIP_CASES]


def strip_encoded(npdt, d, version, masked, h, w):
    """The port's resident encode of a strip case (lossless): (data, mask,
    codec, header, stream, meta, starts, blob, host decoder's band)."""
    data = strip_tile(npdt, h, w, d, seed=d + version)
    mask = strip_mask(h, w) if masked else None
    codec = FusedResidentCodec(h, w, d, npdt, 0.5, version, mask=mask, device="cpu")
    header, stream, meta, starts = codec.encode_fast(torch.from_numpy(data))
    blob = codec.blob_to_bytes(header, stream, meta)
    host = lerc2_decode.decode_band(blob)
    want = data if mask is None else np.where(mask[:, :, None], data, 0)
    np.testing.assert_array_equal(np.where(host.mask[:, :, None], host.data, 0), want)
    return data, mask, codec, header, stream, meta, starts, blob, host


@pytest.mark.parametrize("npdt,d,version,masked,h,w", STRIP_CASES, ids=STRIP_IDS)
def test_strip_edges_decode_records_int(npdt, d, version, masked, h, w):
    """decode_records_int_ref (the plain integer K4) at the strip kernel's
    edges against JAX's decode_tiles_fast and the host decoder: where the
    stream holds depth-diff records both refuse the index (the image is the
    index-free decode's, tests/test_torch_scan.py); elsewhere all three
    images are equal and exact (invalid pixels 0)."""
    data, mask, codec, header, stream, _meta, starts, _blob, host = strip_encoded(
        npdt, d, version, masked, h, w)
    dt = NUMPY_TO_DT[np.dtype(npdt)]
    zmax = codec._zmax_vec(header)
    img, idx_ok, fits = device_decode.decode_tiles_fast(stream, starts, 0.5, zmax, h, w, d, dt,
                                                        version, mask=codec.valid)
    jimg, jidx, jfit = jax_decode.decode_tiles_fast(
        jnp.asarray(stream.numpy().view(np.uint8)), jnp.asarray(starts.numpy()), jnp.float32(0.5),
        jnp.asarray(zmax.numpy()), h, w, d, JDataType(int(dt)), version,
        mask=None if mask is None else jnp.asarray(mask))
    assert bool(fits) and bool(jfit)
    flags = stream.numpy().view(np.uint8)[starts.numpy()]
    if version >= 5 and ((flags & 4) != 0).any():
        assert not bool(idx_ok) and not bool(jidx)
        return
    assert bool(idx_ok) and bool(jidx)
    np.testing.assert_array_equal(img.numpy(), np.asarray(jimg))
    np.testing.assert_array_equal(img.numpy(), np.where(host.mask[:, :, None], host.data, 0))


@pytest.mark.parametrize("d,size,s,dc", [(1, 1, 32, 1), (3, 1, 32, 3), (5, 2, 12, 5), (8, 4, 4, 8),
                                         (40, 2, 1, 40), (40, 4, 1, 31), (130, 1, 1, 127)])
def test_k1_strip(d, size, s, dc):
    """The integer K1's strips (record.cuh strip_shape with lead 1): the
    strip kernels' S blocks (device_decode.strip_blocks); a block whose
    pixels at full depth pass the 8 KB stage takes its depths in chunks
    staged with the slice before them, so a chunk is one depth short of the
    stage."""
    assert device_decode.strip_shape(8, d, size, 1) == (s, dc)
    assert s == device_decode.strip_blocks(8, d, size)
    if dc < d:
        assert (dc + 1) * 64 * size <= 8192 < (dc + 2) * 64 * size


# one case of each depth, both dtypes, versions and mask kinds among them
# (JAX's encode compiles for 3-8 s a shape, so not their cross product)
K1_JAX_CASES = [c for c in STRIP_CASES
                if (np.dtype(c[0]).name, c[1], c[2], c[3]) in
                (("uint8", 1, 6, False), ("int16", 2, 4, True), ("uint8", 3, 6, True),
                 ("int16", 5, 4, False))]


@pytest.mark.parametrize("npdt,d,version,masked,h,w", K1_JAX_CASES,
                         ids=[f"{np.dtype(c[0]).name}-d{c[1]}-v{c[2]}-"
                              f"{'masked' if c[3] else 'valid'}-{c[4]}x{c[5]}" for c in K1_JAX_CASES])
def test_strip_edges_encode_blocks_int(npdt, d, version, masked, h, w):
    """encode_blocks_int_ref (the plain integer K1) at the edges of the
    K1 strips (device_decode.strip_shape): its records written by the
    resident codec give a stream, starts and ranges equal to JAX's
    encode_tiles, and the blob decodes on the host to the tile
    (strip_encoded)."""
    data, mask, codec, _header, stream, meta, starts, _blob, _host = strip_encoded(
        npdt, d, version, masked, h, w)
    assert device_decode.strip_shape(8, d, np.dtype(npdt).itemsize, 1)[0] == \
        device_decode.strip_blocks(8, d, np.dtype(npdt).itemsize)
    dt = JDataType(int(NUMPY_TO_DT[np.dtype(npdt)]))
    js, jtotal, jzmin, jzmax, jstarts, jfits = jax_encode.encode_tiles(
        jnp.asarray(data), jnp.asarray(np.ones((h, w), bool) if mask is None else mask),
        jnp.float32(0.5), h, w, d, dt, mask is None, version, codec.cap, out_u32=True)
    assert bool(jfits) and int(meta[2])
    total = int(jtotal)
    assert int(meta[0]) == total
    np.testing.assert_array_equal(starts.numpy(), np.asarray(jstarts))
    assert stream.numpy().tobytes()[:total] == np.asarray(js).tobytes()[:total]
    p = device_encode.encode_params(0.5, version, 0, NUMPY_TO_DT[np.dtype(npdt)])
    rec_info, zrange, fits = device_encode.encode_blocks_ref(torch.from_numpy(data), p,
                                                             codec.valid)
    assert bool(fits)
    np.testing.assert_array_equal(zrange[:d].numpy(), np.asarray(jzmin))
    np.testing.assert_array_equal(zrange[d:].numpy(), np.asarray(jzmax))
    flags = np.asarray(js).view(np.uint8)[np.asarray(jstarts)]
    np.testing.assert_array_equal(rec_info[:, 1].numpy() & 0xFF, flags)
