"""Port parity for the index-free decode: the plain versions of K5
``scan_records`` (record starts and descriptors without the encoder's
index) and K6 ``decode_scanned`` vs the JAX
device_scan.scan_records_device and device_decode.decode_tiles, on the same
record streams (made by the port's encoder, which tests/test_torch_int.py
and tests/test_torch_device_encode.py hold byte-equal to JAX's).

Criteria (exact): all nine scan outputs equal to JAX's on every stream
where JAX's chain is right, the record starts equal to the encoder's index
on every stream, and the chain ending at `total`; K6's image bit-equal to
JAX decode_tiles fed the same descriptors, and exact (lossless) or within
maxZError of the tile.

The JAX scan is wrong on integer depth-diff streams (v >= 5, flag bit 2):
it reads a diff record's offset at the image dtype's width instead of
DataType INT's (lerc2_decode.py:269) and drops the flag from `mode`, so
its chain derails and its index-free decode returns ok with wrong pixels.
There the port is held to the host decoder (orchestrator.decode_blob)
instead, and ``test_jax_depth_diff_scan_fault`` records the JAX fault.
"""
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lerc_tpu.codec.orchestrator import decode_blob
from lerc_tpu.codec.resident import FusedResidentCodec as JaxFused
from lerc_tpu.codec.resident import ResidentCodec as JaxResident
from lerc_tpu.constants import DataType as JDataType
from lerc_tpu.ops import device_decode as jax_decode
from lerc_tpu.ops import device_scan as jax_scan
from lerc_tpu.ops.device_softf64 import decompose_scalar
from lerc_tpu_torch import FusedResidentCodec, ResidentCodec
from lerc_tpu_torch.constants import NUMPY_TO_DT, DataType, dt_is_int
from lerc_tpu_torch.interop import codec_kwargs
from lerc_tpu_torch.ops import device_decode, device_encode, device_scan
from lerc_tpu_torch.ops import tile_scan as ts

from .test_torch_int import STRIP_CASES, STRIP_IDS, cap_of, int_tile, strip_encoded

H = W = 32


def float_tile(d, seed=0):
    """A float32 DEM patch with const-0, const-offset, integer-offset and
    raw blocks."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 8, W)[None, :, None]
    y = np.linspace(0, 5, H)[:, None, None]
    z = 900 * np.exp(-((x - 4) ** 2 + (y - 2) ** 2) / 9) + 40 * np.sin(x + y)
    z = (z + 0.3 * rng.standard_normal((H, W, d))).astype(np.float32)
    z[0:8, 0:8] = 0.0
    z[8:16, 0:8] = -12.0
    z[16:24, 8:16] = np.round(z[16:24, 8:16]) - 500
    z[24:32, 0:16] = np.where(np.arange(16) % 2, 3.0e6, -1.0)[None, :, None]
    return z


def tile_of(npdt, d):
    return float_tile(d) if npdt == np.float32 else int_tile(npdt, H, W, d)


def port_stream(data, mze, version):
    """The port's encode of a tile -> (stream [S/4] int32, total [1] int32,
    starts, zmax [D] int32 or f32)."""
    h, w, d = data.shape
    dt = NUMPY_TO_DT[data.dtype]
    stream, total, _zmin, zmax, starts, fits = device_encode.encode_tiles(
        torch.from_numpy(data), None, mze, h, w, d, dt, True, version,
        cap_of(data.dtype, h, w, d, 0))
    assert bool(fits)
    return stream, total.reshape(1), starts, zmax


def jax_scan_of(stream, n_rec, dt, version):
    s8 = jnp.asarray(stream.numpy().view(np.uint8))
    return [np.asarray(a) for a in jax_scan.scan_records_device(
        s8, n_rec, JDataType(int(dt)), version, 64)]


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


CASES = [  # (dtype, depth, version, maxZError)
    (np.float32, 1, 6, 0.001), (np.float32, 3, 6, 0.01), (np.float32, 3, 4, 0.0),
    (np.uint8, 1, 6, 0.5), (np.int8, 3, 6, 2.0), (np.int16, 1, 6, 0.5),
    (np.uint16, 3, 4, 0.5), (np.int32, 3, 6, 0.5), (np.uint32, 1, 5, 3.0),
    (np.int32, 1, 4, 2.0), (np.uint16, 3, 5, 2.0),
    # integer depth-diff streams: JAX's scan is wrong here
    (np.uint8, 3, 6, 0.5), (np.int8, 3, 5, 0.5), (np.int16, 3, 6, 0.5), (np.uint16, 3, 6, 0.5),
]
IDS = [f"{np.dtype(c[0]).name}-d{c[1]}-v{c[2]}-{c[3]}" for c in CASES]


def _has_diff(npdt, d, version, mze):
    return np.dtype(npdt).itemsize <= 2 and npdt != np.float32 and d > 1 and version >= 5 \
        and mze == 0.5


@pytest.mark.parametrize("npdt,d,version,mze", CASES, ids=IDS)
def test_scan_records_matches_jax(npdt, d, version, mze):
    data = tile_of(npdt, d)
    dt = NUMPY_TO_DT[np.dtype(npdt)]
    stream, total, starts, _zmax = port_stream(data, mze, version)
    n_rec = starts.numel()
    out = device_scan.scan_records(stream, n_rec, dt, version, total)
    assert len(out) == 10 and bool(out[9]), "the chain must end at total"
    np.testing.assert_array_equal(out[0].numpy(), starts.numpy())  # the encoder's index
    assert out[2].dtype == (torch.int32 if dt_is_int(dt) else torch.float32)
    jax_out = jax_scan_of(stream, n_rec, dt, version)
    mode = out[1].numpy()
    if _has_diff(npdt, d, version, mze):
        assert (mode >= 8).any()
        # JAX loses the chain after the first diff record
        assert not np.array_equal(jax_out[0], starts.numpy())
        return
    assert (mode < 8).all()
    for name, a, b in zip(("rp", "mode", "offset", "num_bits", "num_elements", "payload_pos",
                           "lut_pos", "n_lut", "nbits_lut"), out, jax_out):
        np.testing.assert_array_equal(_bits(a).numpy(), b.view(np.int32) if b.dtype == np.float32
                                      else b, err_msg=name)


@pytest.mark.parametrize("npdt,d,version,mze", CASES, ids=IDS)
def test_decode_scanned_matches_jax(npdt, d, version, mze):
    data = tile_of(npdt, d)
    dt = NUMPY_TO_DT[np.dtype(npdt)]
    stream, total, starts, zmax = port_stream(data, mze, version)
    if dt_is_int(dt):
        mze_dec = max(0.5, np.floor(mze))
    else:
        mze_dec = mze
    desc = device_scan.scan_records(stream, starts.numel(), dt, version, total)
    _rp, mode, offset, nb, ne, ppos, lpos, nlut, nbl, _chain = desc
    img, ok = device_decode.decode_scanned(stream, mode, ppos, offset, nb, ne, lpos, nlut, nbl,
                                           None, mze_dec, zmax, H, W, d, dt, True, False)
    assert bool(ok)
    kw = {}
    if not dt_is_int(dt) and mze_dec > 0:  # the exact ScaleBack (resident.py:119-124)
        limbs, bexp = decompose_scalar(2.0 * mze_dec)
        kw = dict(inv_limbs=limbs, inv_bexp=bexp)
    # JAX's decoder clamps uint32 in int32 order: it takes JAX's encoder's
    # signed-order zMax, the port's its unsigned zMax (repair P6)
    jzmax = data.reshape(-1, d).astype(np.int32).max(0) if dt == DataType.UINT else zmax.numpy()
    jimg, jok = jax_decode.decode_tiles(
        jnp.asarray(stream.numpy().view(np.uint8)),
        *(jnp.asarray(t.numpy()) for t in (mode, ppos, offset, nb, ne, lpos, nlut, nbl)),
        jnp.ones((H, W), bool), jnp.float32(mze_dec), jnp.asarray(jzmax), H, W, d,
        JDataType(int(dt)), True, False, **kw)
    assert bool(jok)
    jimg = np.asarray(jimg)
    assert img.numpy().dtype == jimg.dtype
    np.testing.assert_array_equal(_bits(img).numpy(), jimg.view(np.int32) if
                                  jimg.dtype == np.float32 else jimg)
    err = np.abs(img.numpy().astype(np.float64) - data.astype(np.float64)).max()
    if dt_is_int(dt):
        assert err <= (0 if mze_dec == 0.5 else mze_dec)
    else:
        assert err <= mze_dec * 1.01 + float(np.spacing(np.float32(3.0e6))) / 2


def _scanned(stream, total, dt, version, d):
    return device_scan.scan_records(stream, (H // 8) * (W // 8) * d, dt, version, total)


def test_chain_end_and_derailed_streams():
    """chain_ok is True only when the last record ends exactly at `total`."""
    data = int_tile(np.int16, H, W, 3)
    stream, total, starts, _zmax = port_stream(data, 0.5, 6)
    n_rec = starts.numel()
    for t in (total - 1, total + 1, total * 0):
        assert not bool(device_scan.scan_records(stream, n_rec, DataType.SHORT, 6, t)[9])
    # a flag byte whose mode turns a stuffed record into a raw one derails
    # the chain (the next records are read at the wrong places)
    bad = stream.clone().view(torch.uint8)
    r = int(np.nonzero((bad[starts.long()].numpy() & 3) == 1)[0][2])
    bad[int(starts[r])] &= 0xFC
    out = device_scan.scan_records(bad.view(torch.int32), n_rec, DataType.SHORT, 6, total)
    assert not bool(out[9])


def test_plain_doubling_steps_equal_one_gather_chain():
    """The doubling steps resolve the same starts as walking the jump table
    record by record (the plain versions alone)."""
    data = float_tile(3)
    stream, total, starts, _zmax = port_stream(data, 0.01, 6)
    jump = device_scan.scan_records_sizes_ref(stream, DataType.FLOAT, 6).long()
    pos, walk = 0, []
    for _ in range(starts.numel()):
        walk.append(pos)
        pos = int(jump[pos])
    np.testing.assert_array_equal(np.array(walk), starts.numpy())
    assert pos == int(total)


@pytest.mark.parametrize("extra", [None, 1, 2, 3, 100, 0, 5])
def test_plain_chain_equals_a_walk(extra):
    """scan_records_chain_ref, K5's plain doubling stage, gives the first n
    starts of a record-by-record walk of the jump table for n from 1 to past
    the chain's end (the stream cut at `total`: S there, J[S] = S)."""
    data = float_tile(3)
    stream, total, starts, _zmax = port_stream(data, 0.01, 6)
    stream = stream[: -(-int(total) // 4)].clone()
    jump = device_scan.scan_records_sizes_ref(stream, DataType.FLOAT, 6)
    m = starts.numel()
    n = extra if extra in (1, 2, 3, 100) else m + (extra or 0)
    rp = device_scan.scan_records_chain_ref(jump, n)
    assert rp.dtype == torch.int32 and rp.numel() == n
    np.testing.assert_array_equal(rp.numpy(), _walk(stream, n, DataType.FLOAT, 6))
    np.testing.assert_array_equal(rp.numpy()[:m], starts.numpy()[:n])
    if n > m:
        assert rp[m] == int(total) and (rp.numpy()[m + 1:] == 4 * stream.numel()).all()


def _walk(stream, n_rec, dt, version):
    """The record starts by walking the jump table one record at a time
    (J clamped to S, J[S] = S: S past the chain's end)."""
    jump = device_scan.scan_records_sizes_ref(stream, dt, version).long()
    pos, walk = 0, []
    for _ in range(n_rec):
        walk.append(pos)
        pos = int(jump[pos])
    return np.array(walk)


BROKEN = ["truncated", "chain ends before n_rec", "byte flipped mid-chain"]


def _broken(kind, stream, total, starts):
    """(stream, total, n_rec) of a broken variant of an intact stream:
    truncated to a third of `total`; cut at `total` and asked for 7 records
    more than it holds (the chain reaches S); the mode bits of a raw or
    stuffed record halfway along the chain flipped to a constant's (the
    chain derails)."""
    n_rec, tot = starts.numel(), int(total)
    if kind == "truncated":
        return stream[: max(1, tot // 12)].clone(), total, n_rec
    if kind == "chain ends before n_rec":
        return stream[: -(-tot // 4)].clone(), total, n_rec + 7
    bad = stream.clone().view(torch.uint8)
    flags = bad[starts.long()].numpy()
    long = np.nonzero((flags & 3) <= 1)[0]  # raw or stuffed: a constant's size differs
    bad[int(starts[int(long[len(long) // 2])])] ^= 3
    return bad.view(torch.int32), total, n_rec


BROKEN_CASES = [(np.float32, 3, 6, 0.01), (np.float32, 1, 4, 0.0), (np.int16, 1, 4, 0.5),
                (np.uint8, 3, 4, 0.5), (np.int32, 3, 6, 0.5)]


@pytest.mark.parametrize("kind", BROKEN)
@pytest.mark.parametrize("npdt,d,version,mze", BROKEN_CASES,
                         ids=[f"{np.dtype(c[0]).name}-d{c[1]}-v{c[2]}" for c in BROKEN_CASES])
def test_scan_records_on_broken_streams(kind, npdt, d, version, mze):
    """K5 on truncated, short and derailed streams: the starts equal a
    record-by-record walk of the jump table and chain_ok is False where the
    chain cannot end at `total`. Where flag bit 2 means nothing to a record's
    size (float32, or version < 5), all nine outputs equal JAX's
    scan_records_device, the mode without the + 8 that the port reports for
    bit 2 at version >= 5 (JAX drops it); an integer stream at version >= 5
    is held to the walk alone, since a derailed chain meets bytes with bit 2
    set, which JAX reads at the image dtype's width."""
    data = tile_of(npdt, d)
    dt = NUMPY_TO_DT[np.dtype(npdt)]
    stream, total, starts, _zmax = port_stream(data, mze, version)
    s, t, n_rec = _broken(kind, stream, total, starts)
    out = device_scan.scan_records(s, n_rec, dt, version, t)
    rp = out[0].numpy()
    np.testing.assert_array_equal(rp, _walk(s, n_rec, dt, version))
    if kind == "chain ends before n_rec":
        np.testing.assert_array_equal(rp[:-7], starts.numpy())
        assert rp[-7] == int(total) and (rp[-6:] == 4 * s.numel()).all()
    else:
        assert not np.array_equal(rp[:starts.numel()], starts.numpy())
    if kind != "byte flipped mid-chain":
        assert not bool(out[9])
    if dt_is_int(dt) and version >= 5:
        return
    ours = [out[0], out[1] & 7, *out[2:9]]
    for name, a, b in zip(("rp", "mode", "offset", "num_bits", "num_elements", "payload_pos",
                           "lut_pos", "n_lut", "nbits_lut"), ours, jax_scan_of(s, n_rec, dt, version)):
        np.testing.assert_array_equal(_bits(a).numpy(), b.view(np.int32) if b.dtype == np.float32
                                      else b, err_msg=name)


@pytest.mark.parametrize("kind", ["intact"] + BROKEN)
@pytest.mark.parametrize("npdt", [np.uint8, np.int16], ids=["uint8", "int16"])
def test_scan_records_depth_diff_streams(kind, npdt):
    """K5 on integer depth-diff streams (the PR 3 repair of JAX's scan):
    the starts equal a record-by-record walk of the jump table, intact and
    broken; on the intact stream they are the encoder's, chain_ok is True,
    diff records report mode + 8, and the index-free decode equals the host
    decoder's image."""
    dt = NUMPY_TO_DT[np.dtype(npdt)]
    pf = FusedResidentCodec(**codec_kwargs(H, W, 3, npdt, 0.5, 6, 0), device="cpu")
    data = _rgb_like(npdt, -2)
    header, stream, meta, starts = pf.encode_fast(torch.from_numpy(data))
    total = meta[:1].to(torch.int32)
    s, t, n_rec = (stream, total, starts.numel()) if kind == "intact" else \
        _broken(kind, stream, total, starts)
    out = device_scan.scan_records(s, n_rec, dt, 6, t)
    np.testing.assert_array_equal(out[0].numpy(), _walk(s, n_rec, dt, 6))
    if kind != "intact":
        return
    np.testing.assert_array_equal(out[0].numpy(), starts.numpy())
    assert bool(out[9]) and (out[1].numpy() >= 8).any()
    host = decode_blob(pf.blob_to_bytes(header, stream, meta)).data[0].reshape(H, W, 3)
    img, ok = pf.decode_fast(header, stream)
    assert bool(ok)
    np.testing.assert_array_equal(img.numpy(), host)


def test_decode_scanned_refuses_what_it_cannot_decode():
    """A diff record on slice 0, an integer raw diff record and a LUT record
    whose indices pass its LUT clear ok, as the host decoder refuses them; a
    float diff record decodes (the exact f32 chain); micro blocks other than
    8 and 16 name their ROADMAP item; float64 (ported since) decodes a host
    scan of the port's f64 stream bit-equal to JAX's softfloat
    ``decode_tiles_f64``, and a float64 raw diff record clears ok."""
    fdata = float_tile(3)
    stream, total, starts, zmax = port_stream(fdata, 0.01, 6)
    mode, off, nb, ne, pp, lp, nl, nbl = _scanned(stream, total, DataType.FLOAT, 6, 3)[1:9]
    args = (pp, off, nb, ne, lp, nl, nbl, None, 0.01, zmax, H, W, 3, DataType.FLOAT, True, False)
    assert bool(device_decode.decode_scanned(stream, mode, *args)[1])
    m = mode.clone()
    m[1] = int(mode[1]) + 8  # a float diff record on slice 1
    assert bool(device_decode.decode_scanned(stream, m, *args)[1])
    m = mode.clone()
    m[0] = 9  # a diff record on slice 0
    assert not bool(device_decode.decode_scanned(stream, m, *args)[1])
    r = 5  # a stuffed record read as a LUT of no entries: any non-zero index passes it
    assert int(mode[r]) == 1
    m, nl0, nbl8 = mode.clone(), nl.clone(), nbl.clone()
    m[r], nl0[r], nbl8[r] = 4, 0, 8
    first = stream.view(torch.uint8)[int(pp[r]) : int(pp[r]) + int(ne[r])]
    assert first.any()
    largs = (pp, off, nb, ne, lp, nl0, nbl8) + args[7:]
    assert not bool(device_decode.decode_scanned(stream, m, *largs)[1])
    idata = int_tile(np.uint8, H, W, 3)
    istream, itotal, _s, izmax = port_stream(idata, 0.5, 6)
    imode, ioff, inb, ine, ipp, ilp, inl, inbl = _scanned(istream, itotal, DataType.BYTE, 6, 3)[1:9]
    iargs = (ipp, ioff, inb, ine, ilp, inl, inbl, None, 0.5, izmax, H, W, 3, DataType.BYTE, True,
             False)
    assert bool(device_decode.decode_scanned(istream, imode, *iargs)[1])
    raw = int(np.nonzero(imode.numpy() == 0)[0][-1])
    m = imode.clone()
    m[raw if raw % 3 else raw + 1] = 8
    assert not bool(device_decode.decode_scanned(istream, m, *iargs)[1])
    with pytest.raises(NotImplementedError, match="host codec"):
        device_decode.decode_scanned(stream, mode, *args, mb=32)
    ddata = float_tile(3).astype(np.float64) * (1 + 1e-9)
    dstream, dtotal, _dz0, dz1, _ds = device_encode.encode_tiles_f64(
        torch.from_numpy(ddata), None, 0.01, H, W, 3, True, 6, 1 << 20)
    cnts, j0s, n_blocks = ts.block_scan_inputs(np.ones((H, W), bool), 8)
    recs, _used = ts.tile_scan_ref(dstream.view(torch.uint8)[:int(dtotal)].numpy(), cnts, j0s,
                                   n_blocks, 3, int(DataType.DOUBLE), 6)
    head = SimpleNamespace(dt=DataType.DOUBLE, max_z_error=0.01, n_rows=H, n_cols=W, n_depth=3,
                           micro_block_size=8)
    dargs = list(device_decode.scanned_args(dstream, 0, recs, None, head, dz1.numpy()))
    img, ok = device_decode.decode_scanned(*dargs)
    assert bool(ok) and np.abs(img.numpy() - ddata).max() <= 0.01
    limbs, bexp = decompose_scalar(0.02)
    obits, zbits = recs["offset"].view(np.uint64), dz1.numpy().view(np.uint64)
    jh, jl, jok = jax_decode.decode_tiles_f64(
        jnp.asarray(dstream.view(torch.uint8).numpy()), jnp.asarray(recs["mode"]),
        jnp.asarray(recs["payload_pos"].astype(np.int32)),
        jnp.asarray((obits >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((obits & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        jnp.asarray(recs["num_bits"]), jnp.asarray(recs["num_elements"]),
        jnp.asarray(recs["lut_pos"].astype(np.int32)), jnp.asarray(recs["nbits_lut"]),
        jnp.ones((H, W), bool), jnp.asarray((zbits >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((zbits & np.uint64(0xFFFFFFFF)).astype(np.uint32)), limbs, bexp, H, W, 3,
        True, False)
    assert bool(jok)
    jbits = (np.asarray(jh).astype(np.uint64) << np.uint64(32)) | np.asarray(jl)
    np.testing.assert_array_equal(img.numpy().view(np.uint64), jbits)
    dmode = dargs[1].clone()
    raw = int(np.nonzero(dmode.numpy() % 3 == 1)[0][0])  # slice 1 of a block, made raw diff
    dmode[raw] = 8
    dargs[1] = dmode
    assert not bool(device_decode.decode_scanned(*dargs)[1])


DIFF_CASES = [np.uint8, np.int16]


def _rgb_like(npdt, step, seed=0):
    """Three band-correlated 8- or 16-bit slices (the diff encoder's case):
    slice k is slice k-1 plus `step` plus noise in [0, 2]. A negative step
    gives negative diff minima, stored as INT reduced to SHORT (flag 0x85,
    two offset bytes where the image dtype has one); a positive step gives
    byte-wide ones (flag 0xc5, one byte either way)."""
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.integers(-3, 4, (H, W)), axis=1) + 120
    img = np.stack([base, base + step + rng.integers(0, 3, (H, W)),
                    base + 2 * step + rng.integers(0, 3, (H, W))], -1)
    return img.clip(0, 255).astype(npdt)


@pytest.mark.parametrize("npdt", DIFF_CASES, ids=[np.dtype(t).name for t in DIFF_CASES])
def test_jax_depth_diff_scan_fault(npdt):
    """FusedResidentCodec(32, 32, 3, dtype, 0.5), v6, on band-correlated
    images: the encoders write depth-diff records, byte-equal in both
    packages. The port decodes each blob without the index exactly like
    the host decoder, with ok True; with the index it reports ok False and
    its ResidentCodec raises ValueError. JAX's index-free decode returns
    ok True with wrong pixels on both images. With the index JAX reports
    ok False (and raises) where the diff offset's width differs from the
    dtype's (negative step), but ok True with wrong pixels where the widths
    agree (positive step). Both are the JAX faults of ROADMAP queue 3."""
    kw = codec_kwargs(H, W, 3, npdt, 0.5, 6, 0)
    jf = JaxFused(H, W, 3, npdt, 0.5)
    jr = JaxResident(H, W, 3, npdt, 0.5)
    pf = FusedResidentCodec(**kw, device="cpu")
    pr = ResidentCodec(**kw, device="cpu")
    for step, diff_flag, jax_index_ok in ((-2, 0x85, False), (3, 0xC5, True)):
        data = _rgb_like(npdt, step)
        jb = [np.asarray(a) for a in jf.encode_fast(jnp.asarray(data))]
        header, stream, meta, starts = pf.encode_fast(torch.from_numpy(data))
        np.testing.assert_array_equal(header.numpy(), jb[0])
        np.testing.assert_array_equal(meta.numpy(), jb[2])
        np.testing.assert_array_equal(starts.numpy(), jb[3])
        total = int(meta[0])
        assert stream.numpy().tobytes()[:total] == jb[1].tobytes()[:total]
        flags = stream.numpy().view(np.uint8)[starts.numpy()]
        assert (flags == diff_flag).sum() > 0
        blob = pf.blob_to_bytes(header, stream, meta)
        host = decode_blob(blob).data[0].reshape(H, W, 3)
        np.testing.assert_array_equal(host, data)

        img, ok = pf.decode_fast(header, stream)
        assert bool(ok)
        np.testing.assert_array_equal(img.numpy(), host)
        assert not bool(pf.decode_fast(header, stream, starts)[1])
        jimg, jok = jf.decode_fast(jnp.asarray(jb[0]), jnp.asarray(jb[1]))
        assert bool(jok) and not np.array_equal(np.asarray(jimg), host)  # JAX fault
        jimg, jok = jf.decode_fast(*(jnp.asarray(jb[i]) for i in (0, 1, 3)))
        assert bool(jok) == jax_index_ok
        if jax_index_ok:
            assert not np.array_equal(np.asarray(jimg), host)  # JAX fault

        pblob = pr.encode(torch.from_numpy(data))
        jblob = jr.encode(jnp.asarray(data))
        assert pblob.to_bytes() == jblob.to_bytes() == blob
        with pytest.raises(ValueError, match="index"):
            pr.decode(pblob)
        if not jax_index_ok:
            with pytest.raises(ValueError, match="index"):
                jr.decode(jblob)
        pblob.starts = None
        np.testing.assert_array_equal(pr.decode(pblob).numpy(), host)


@pytest.mark.parametrize("npdt,d,version,masked,h,w", STRIP_CASES, ids=STRIP_IDS)
def test_strip_edges_decode_scanned(npdt, d, version, masked, h, w):
    """decode_scanned_ref (the plain K6) at the strip kernel's edges, on the
    descriptors of the port's scan (all-valid: K5's plain version) or of the
    host scanner (masked), against JAX's decode_tiles fed the same
    descriptors and against the host decoder: bit-equal images (invalid
    pixels 0), ok True. On depth-diff streams JAX's own scan is at fault
    (test_jax_depth_diff_scan_fault), not its decode of these descriptors."""
    data, mask, codec, header, stream, meta, _starts, blob, host = strip_encoded(
        npdt, d, version, masked, h, w)
    dt = NUMPY_TO_DT[np.dtype(npdt)]
    zmax = codec._zmax_vec(header)
    if mask is None:
        desc = device_scan.scan_records(stream, codec.n_rec, dt, version, meta[0].reshape(1))
        assert bool(desc[9])
        a = (stream, desc[1], desc[5], desc[2], desc[3], desc[4], desc[6], desc[7], desc[8], None,
             0.5, zmax, h, w, d, dt, True, False)
    else:
        cnts, j0s, n = ts.block_scan_inputs(mask, 8)
        recs, used = ts.tile_scan(stream.numpy().view(np.uint8)[:int(meta[0])], cnts, j0s, n, d,
                                  int(dt), version)
        assert used == int(meta[0])
        head = SimpleNamespace(dt=dt, max_z_error=0.5, n_rows=h, n_cols=w, n_depth=d,
                               micro_block_size=8)
        a = device_decode.scanned_args(stream, 0, recs, codec.valid, head, zmax.numpy())
    img, ok = device_decode.decode_scanned(*a)
    assert bool(ok)
    np.testing.assert_array_equal(img.numpy(), np.where(host.mask[:, :, None], host.data, 0))
    jimg, jok = jax_decode.decode_tiles(
        jnp.asarray(stream.numpy().view(np.uint8)), *(jnp.asarray(t.numpy()) for t in a[1:9]),
        jnp.ones((h, w), bool) if mask is None else jnp.asarray(mask), jnp.float32(0.5),
        jnp.asarray(zmax.numpy()), h, w, d, JDataType(int(dt)), mask is None, False)
    assert bool(jok)
    np.testing.assert_array_equal(img.numpy(), np.asarray(jimg))
