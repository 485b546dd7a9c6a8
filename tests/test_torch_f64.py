"""Port parity for the float64 kernels' plain versions (device="cpu"): K1/K2
f64 (``device_encode.encode_tiles_f64``), K6 f64 (``device_decode
.decode_scanned``) and F1-F3 over u64 words (``device_fpl``), against the
JAX package's ``device_f64.encode_tiles_f64``, ``device_decode
.decode_tiles_f64`` and ``device_fpl.fpl_choose_device_f64`` /
``fpl_finalize_device_f64`` / ``fpl_restore_device_f64``, and the host
decoder ``lerc2_decode.decode_band``, on numpy-seeded float64 bands.

Criteria (exact, but for the maxZError bound of lossy decodes): K1/K2's
stream, total and record starts byte-equal to JAX's where JAX's double-single
quanta are within maxZError (every band here; the tie band where they are
not is ``tests/test_torch_f64_band.py::test_jax_f64_tie_quant_fault``), the
block offsets the exact bits of each block's first minimum, the ranges
numpy's; K6's image bit-equal to JAX's softfloat decode and to the host
decoder, also on LUT records, on depth-diff records and on subnormal offsets
(where JAX's band decoder gives up); F1's histograms equal to counts taken
from JAX's own intermediates, the host choice equal to JAX's, F2's planes
and histograms and F2b's sizes equal to ``fpl_finalize_device_f64``, F3
equal to ``fpl_restore_device_f64`` and to the input bits. Shapes: depth 1
and 3, 48x41, 61x47, 13x11, and tiny bands of 2-4 values (F2/F3 only: JAX
fails there, ROADMAP queue 3).
"""
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lerc_tpu.codec import lerc2_decode
from lerc_tpu.codec.lerc2_encode import BandEncoder
from lerc_tpu.ops import device_decode as jax_decode
from lerc_tpu.ops import device_f64 as JF
from lerc_tpu.ops import device_fpl as J
from lerc_tpu.ops.device_softf64 import decompose_scalar
from lerc_tpu_torch.codec import fletcher32
from lerc_tpu_torch.codec import fpl_impl
from lerc_tpu_torch.codec import header as hdr
from lerc_tpu_torch.codec.device_codec import band_sections
from lerc_tpu_torch.constants import DataType
from lerc_tpu_torch.ops import device_decode
from lerc_tpu_torch.ops import device_encode as E
from lerc_tpu_torch.ops import device_fpl as F
from lerc_tpu_torch.ops import tile_scan as ts


def dem64(h, w, d, seed=0, noise=0.01):
    """float64 [h, w, d]: a smooth hill plus seeded noise, each slice
    shifted."""
    rng = np.random.default_rng(seed)
    x, y = np.meshgrid(np.linspace(0, 4, w), np.linspace(0, 3, h))
    base = (1000 + 200 * np.sin(x) * np.cos(y))[:, :, None] + 3.0 * np.arange(d)
    return base + noise * rng.standard_normal((h, w, d))


def hole_mask(h, w, seed=1):
    return np.random.default_rng(seed).random((h, w)) > 0.2


def jax_tiles(data, mask, mze, version, cap):
    """JAX's encode_tiles_f64 stream bytes and record starts."""
    h, w, d = data.shape
    hi, lo, bits = JF.split_f64_host(data)
    mh = np.float32(mze)
    ml = np.float32(np.float64(mze) - np.float64(mh))
    stream, total, starts = JF.encode_tiles_f64(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(bits), jnp.asarray(mask),
        jnp.float32(mh), jnp.float32(ml), h, w, d, bool(mask.all()), version, cap)
    return np.asarray(stream)[:int(total)].tobytes(), np.asarray(starts)


def port_tiles(data, mask, mze, version, cap):
    h, w, d = data.shape
    all_valid = bool(mask.all())
    valid = None if all_valid else E.block_valid_words(torch.from_numpy(mask))
    return E.encode_tiles_f64(torch.from_numpy(data), valid, mze, h, w, d, all_valid, version,
                              cap)


def cap_of(data):
    return 1 << max(12, (data.size * 8 + data.size // 4 + 4096 - 1).bit_length())


ENC = [  # (shape, maxZError, masked, version, noise)
    ((48, 41, 1), 0.001, False, 6, 0.01), ((48, 41, 1), 0.01, True, 5, 0.01),
    ((61, 47, 3), 0.01, True, 6, 0.01), ((64, 64, 1), 1e-6, False, 4, 0.01),
    ((40, 48, 1), 2e-7, True, 3, 0.01), ((48, 41, 1), 1e-9, False, 6, 1e3),
]


@pytest.mark.parametrize("shape,mze,masked,version,noise", ENC,
                         ids=["x".join(map(str, c[0])) + f"-{c[1]}-{'m' if c[2] else 'v'}-v{c[3]}"
                              for c in ENC])
def test_k1_k2_f64_match_jax(shape, mze, masked, version, noise):
    data = dem64(*shape, noise=noise)
    mask = hole_mask(*shape[:2]) if masked else np.ones(shape[:2], bool)
    cap = cap_of(data)
    stream, total, zmin, zmax, starts = port_tiles(data, mask, mze, version, cap)
    jstream, jstarts = jax_tiles(data, mask, mze, version, cap)
    assert stream.view(torch.uint8)[:int(total)].numpy().tobytes() == jstream
    np.testing.assert_array_equal(starts.numpy(), jstarts)
    sel = data[mask]
    np.testing.assert_array_equal(zmin.numpy(), sel.min(0))
    np.testing.assert_array_equal(zmax.numpy(), sel.max(0))


def test_k1_f64_modes_offsets_and_bound():
    """Every record mode occurs (const-0, stuffed, const-offset and raw,
    forced past 2^30 - 1 quanta); each offset is the exact bits of the
    block's first minimum; every valid value decodes within maxZError."""
    h, w, d = 48, 41, 1
    data = dem64(h, w, d)
    data[0:8, 0:8] = 0.0                                    # const-0
    data[8:16, 8:16] = 7.25                                 # const-offset
    data[16:24, 0:8] = np.linspace(-1e6, 1e6, 64).reshape(8, 8, 1)  # raw: 2^30 quanta passed
    mask = hole_mask(h, w)
    valid = E.block_valid_words(torch.from_numpy(mask))
    p = E.encode_params_f64(1e-4, 6)
    rec_info, zrange = E.encode_blocks_f64(torch.from_numpy(data), p, valid)
    info = rec_info.numpy().astype(np.int64)
    modes = (info[:, 1] >> 8) & 3
    assert set(modes.tolist()) == {0, 1, 2, 3}
    blocks = np.pad(data[:, :, 0], ((0, -h % 8), (0, -w % 8))).reshape(6, 8, 6, 8)
    vb = np.pad(mask, ((0, -h % 8), (0, -w % 8))).reshape(6, 8, 6, 8)
    blocks, vb = blocks.transpose(0, 2, 1, 3).reshape(36, 64), vb.transpose(0, 2, 1, 3).reshape(36, 64)
    for b in range(36):
        if not vb[b].any():
            continue
        vals = np.where(vb[b], blocks[b], np.inf)
        first = int(np.argmax(vb[b] & (vals == vals.min())))
        bits = (int(info[b, 2]) & 0xFFFFFFFF) | ((int(info[b, 3]) & 0xFFFFFFFF) << 32)
        assert bits == int(blocks[b, first:first + 1].view(np.uint64)[0])
    stream, total, *_ = port_tiles(data, mask, 1e-4, 6, cap_of(data))
    blob = _blob(stream.view(torch.uint8)[:int(total)].numpy().tobytes(), data, mask, 1e-4)
    got = lerc2_decode.decode_band(blob).data
    assert np.abs(got - data)[mask].max() <= 1e-4


def _blob(tile_bytes, data, mask, mze, version=6):
    """A Lerc2 blob around a float64 tile stream (header, mask, ranges)."""
    from lerc_tpu_torch.codec import rle
    from lerc_tpu_torch.codec.bitmask import bool_to_bits

    h, w, d = data.shape
    sel = data[mask]
    head = hdr.HeaderInfo(version=version, n_rows=h, n_cols=w, n_depth=d,
                          num_valid_pixel=int(mask.sum()), micro_block_size=8,
                          dt=DataType.DOUBLE, max_z_error=mze, z_min=float(sel.min()),
                          z_max=float(sel.max()))
    msk = rle.compress(bool_to_bits(mask)) if not mask.all() else b""
    body = (struct.pack("<i", len(msk)) + msk + sel.min(0).tobytes() + sel.max(0).tobytes()
            + b"\x00" + tile_bytes)
    head.blob_size = hdr.header_size(version) + len(body)
    blob = bytearray(hdr.write_header(head)) + body
    skip = hdr.checksum_skip(version)
    struct.pack_into("<I", blob, skip - 4, fletcher32.fletcher32(bytes(blob[skip:])))
    return bytes(blob)


# ---------------------------------------------------------------------------
# K6 f64
# ---------------------------------------------------------------------------


def _records(blob):
    sec = band_sections(blob)
    head = sec.head
    stream = np.frombuffer(blob[sec.pos:head.blob_size], np.uint8)
    cnts, j0s, n = ts.block_scan_inputs(sec.mask, head.micro_block_size)
    recs = ts.tile_scan_ref(stream, cnts, j0s, n, head.n_depth, int(head.dt), head.version)[0]
    return sec, stream, recs, cnts


_OFF_W = {0: 8, 1: 4, 2: 4, 3: 2}  # a float64 offset's width by flag bits 6-7


def diff_blob(blob):
    """`blob` (a float64 tiling blob of depth >= 2, version >= 5) with every
    non-raw record of slices >= 1 rewritten as a depth-diff record (flag bit
    2) and its checksum refixed."""
    sec, stream, recs, cnts = _records(blob)
    head, d = sec.head, sec.head.n_depth
    out = bytearray(blob)
    base = sec.pos
    pos, flipped = 0, set()
    for r, rec in enumerate(recs):
        flag, m = int(stream[pos]), int(rec["mode"]) % 8
        if r % d and m != 0:
            out[base + pos] = flag | 4
            flipped.add(m)
        if m == 2:
            pos += 1
        elif m == 3:
            pos += 1 + _OFF_W[flag >> 6]
        elif m == 0:
            pos = int(rec["payload_pos"]) + int(cnts[r // d]) * 8
        else:
            nbits = rec["nbits_lut"] if m == 4 else rec["num_bits"]
            pos = int(rec["payload_pos"]) + (int(rec["num_elements"]) * int(nbits) + 7) // 8
    assert pos == stream.size
    skip = hdr.checksum_skip(head.version)
    struct.pack_into("<I", out, skip - 4, fletcher32.fletcher32(bytes(out[skip:head.blob_size])))
    return bytes(out), flipped


def class64(h, w, d):
    x, y = np.meshgrid(np.linspace(0, 10, w), np.linspace(0, 8, h))
    base = np.floor(x) * 10 + np.floor(y) * 3
    return np.stack([base + 2 * k for k in range(d)], -1).astype(np.float64)


def k6_blobs():
    """(name, blob) of float64 tiling blobs: the port's, the host encoder's
    (reduced offset types, LUT records), their depth-diff rewrites, and
    subnormal offsets."""
    from lerc_tpu_torch import encode_band_device

    tiny = dem64(48, 41, 1)  # blocks of subnormal values: const-offset and stuffed records
    tiny[0:8, 0:8] = 1e-310 * (1 + np.arange(64).reshape(8, 8, 1) / 64)
    tiny[8:16, 0:8] = np.where(np.arange(64).reshape(8, 8, 1) % 3, 0.75, 3e-309)
    return {
        "port-d3-mask": encode_band_device(dem64(61, 47, 3), hole_mask(61, 47), 0.01,
                                           device="cpu"),
        "host-lut-class": BandEncoder(class64(48, 41, 1), None, 0.5).encode(),
        "host-int-valued-d3-mask": BandEncoder(np.round(dem64(48, 41, 3)), hole_mask(48, 41),
                                               0.5, version=5).encode(),
        "port-d3-diff": diff_blob(encode_band_device(dem64(61, 47, 3), hole_mask(61, 47), 0.01,
                                                     device="cpu"))[0],
        "host-lut-d3-diff": diff_blob(BandEncoder(class64(48, 41, 3), hole_mask(48, 41),
                                                  0.5).encode())[0],
        "subnormal": BandEncoder(tiny, None, 0.01).encode(),
    }


K6_NAMES = ["port-d3-mask", "host-lut-class", "host-int-valued-d3-mask", "port-d3-diff",
            "host-lut-d3-diff", "subnormal"]


@pytest.mark.parametrize("name", K6_NAMES)
def test_decode_scanned_f64_matches_host_and_jax(name):
    blob = k6_blobs()[name]
    sec, stream, recs, _cnts = _records(blob)
    head = sec.head
    assert head.dt == DataType.DOUBLE and sec.kind == "tiling"
    words = torch.from_numpy(np.frombuffer(blob + bytes(-len(blob) % 4), np.uint8).copy())
    z_max = sec.z_max_vec if sec.z_max_vec is not None else np.full(head.n_depth, head.z_max)
    valid = None if sec.mask.all() else E.block_valid_words(torch.from_numpy(sec.mask))
    img, ok = device_decode.decode_scanned(*device_decode.scanned_args(
        words.view(torch.int32), sec.pos, recs, valid, head, z_max))
    assert bool(ok)
    host = lerc2_decode.decode_band(blob).data
    np.testing.assert_array_equal(img.numpy().view(np.uint64), host.view(np.uint64))
    m8 = recs["mode"] % 8
    if "lut" in name:
        assert (m8 == 4).any()
    if "diff" in name:
        assert (recs["mode"] >= 8).any()
    offs = recs["offset"][np.isin(m8, (1, 3, 4))]
    subnormal = ((offs != 0) & (np.abs(offs) < 2.2250738585072014e-308)).any()
    assert subnormal == (name == "subnormal")
    if subnormal:  # JAX's softfloat refuses: its band decoder leaves the blob to the host
        from lerc_tpu.codec import device_codec as jax_codec

        assert jax_codec.decode_band_device(blob) is None
        return
    limbs, bexp = decompose_scalar(2.0 * head.max_z_error)
    obits, zbits = recs["offset"].view(np.uint64), np.asarray(z_max, np.float64).view(np.uint64)
    h32 = np.uint64(32)
    lo32 = np.uint64(0xFFFFFFFF)
    jh, jl, jok = jax_decode.decode_tiles_f64(
        jnp.asarray(stream), jnp.asarray(recs["mode"]),
        jnp.asarray(recs["payload_pos"].astype(np.int32)),
        jnp.asarray((obits >> h32).astype(np.uint32)), jnp.asarray((obits & lo32).astype(np.uint32)),
        jnp.asarray(recs["num_bits"]), jnp.asarray(recs["num_elements"]),
        jnp.asarray(recs["lut_pos"].astype(np.int32)), jnp.asarray(recs["nbits_lut"]),
        jnp.asarray(sec.mask), jnp.asarray((zbits >> h32).astype(np.uint32)),
        jnp.asarray((zbits & lo32).astype(np.uint32)), limbs, bexp, head.n_rows, head.n_cols,
        head.n_depth, bool(sec.mask.all()), bool((m8 == 4).any()))
    assert bool(jok)
    jbits = (np.asarray(jh).astype(np.uint64) << h32) | np.asarray(jl)
    np.testing.assert_array_equal(img.numpy().view(np.uint64), jbits)


def test_decode_scanned_f64_refuses_like_the_host():
    """A raw diff record, a diff record on slice 0, a stuffed count past the
    block's area: ok drops, as the host decoder refuses them."""
    blob = k6_blobs()["port-d3-mask"]
    sec, _stream, recs, _cnts = _records(blob)
    words = torch.from_numpy(np.frombuffer(blob + bytes(-len(blob) % 4), np.uint8).copy())
    valid = E.block_valid_words(torch.from_numpy(sec.mask))
    args = list(device_decode.scanned_args(words.view(torch.int32), sec.pos, recs, valid,
                                           sec.head, sec.z_max_vec))
    assert bool(device_decode.decode_scanned(*args)[1])
    mode, ne = args[1], args[5]
    for r, change in ((1, lambda m, n: (8, n)), (0, lambda m, n: (9, n)),
                      (int(np.nonzero(mode.numpy() == 1)[0][0]), lambda m, n: (m, 65))):
        m2, n2 = mode.clone(), ne.clone()
        m2[r], n2[r] = change(int(mode[r]), int(ne[r]))
        bad = list(args)
        bad[1], bad[5] = m2, n2
        assert not bool(device_decode.decode_scanned(*bad)[1]), r


# ---------------------------------------------------------------------------
# F1-F3 over u64 words
# ---------------------------------------------------------------------------


def fband(h, w, d, kind, seed=0):
    """float64 [h, w, d]: "smooth" (a hill, tiny noise), "rows" (each row a
    random walk, rows independent) or "noise"."""
    rng = np.random.default_rng(seed)
    if kind == "smooth":
        return dem64(h, w, d, seed, noise=1e-9)
    if kind == "rows":
        return np.cumsum(rng.standard_normal((h, w, d)), 1) + 50.0
    return rng.normal(0, 1, (h, w, d))


def limbs(data):
    bits = np.ascontiguousarray(data).reshape(-1).view(np.uint64)
    return (jnp.asarray((bits & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((bits >> np.uint64(32)).astype(np.uint32)))


def jax_sample_counts64(data):
    """[3, 8, 6, 256] counts from JAX's own intermediates of
    fpl_choose_device_f64."""
    h, w, d = data.shape
    rows, cols = fpl_impl.slice_shape(h, w, d)
    lo, hi = limbs(data)
    stride = F.sample_stride(rows * cols)
    lo_i, hi_i = lo.reshape(rows, cols)[::stride], hi.reshape(rows, cols)[::stride]
    out = np.zeros((3, 8, 6, 256), np.int64)
    for p in range(3):
        tl, th = J.apply_predictor64_dev(lo_i, hi_i, p)
        tl, th = tl.reshape(-1), th.reshape(-1)
        for b in range(8):
            cur = ((tl if b < 4 else th) >> (8 * (b % 4))) & 0xFF
            for k in range(6):
                if k:
                    cur = J._byte_deriv1(cur, k)
                out[p, b, k] = np.bincount(np.asarray(cur[::7]), minlength=256)
    return out


FSHAPES = [(48, 41, 1), (13, 11, 3), (61, 47, 1)]
FSHAPE_IDS = ["x".join(map(str, s)) for s in FSHAPES]
FLEVELS = [(0, 1, 2, 3, 4, 5, 0, 1), (5, 4, 3, 2, 1, 0, 5, 5)]  # every level on every plane


@pytest.mark.parametrize("kind", ["smooth", "rows", "noise"])
@pytest.mark.parametrize("shape", FSHAPES, ids=FSHAPE_IDS)
def test_f64_sampled_histograms_and_choice_match_jax(shape, kind):
    data = fband(*shape, kind)
    hist = F.fpl_sample_histograms(torch.from_numpy(data)).numpy()
    assert hist.shape == (3, 8, 6, 256)
    np.testing.assert_array_equal(hist, jax_sample_counts64(data))
    pred, levels, ests = F.fpl_choose(hist)
    jpred, jlevels = J.fpl_choose_device_f64(*limbs(data), *shape)
    assert (pred, levels) == (int(jpred), tuple(np.asarray(jlevels).tolist())), ests


def test_f64_choice_reaches_every_predictor():
    preds = {F.fpl_choose(F.fpl_sample_histograms(torch.from_numpy(fband(*s, k))).numpy())[0]
             for s in FSHAPES for k in ("smooth", "rows", "noise")}
    assert preds == {0, 1, 2}


@pytest.mark.parametrize("pred", [0, 1, 2])
@pytest.mark.parametrize("shape", FSHAPES[:2], ids=FSHAPE_IDS[:2])
def test_f64_finalize_packbits_and_restore_match_jax(shape, pred):
    h, w, d = shape
    n = h * w * d
    data = fband(*shape, "smooth", seed=5)
    lo, hi = limbs(data)
    for levels in FLEVELS:
        lv = tuple(min(v, 5 - pred) for v in levels) if pred else levels
        planes, histos = F.fpl_finalize(torch.from_numpy(data), pred, lv)
        assert planes.shape == (8, F.padded(n))
        jh, jp, jpb = J.fpl_finalize_device_f64(lo, hi, jnp.asarray(lv, jnp.int32), h, w, d, pred)
        np.testing.assert_array_equal(planes[:, :n].numpy(), np.asarray(jp))
        assert not planes[:, n:].any()
        np.testing.assert_array_equal(histos.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(F.fpl_packbits_size(planes, n).numpy(), np.asarray(jpb))
        got = F.fpl_restore(planes, h, w, d, pred, lv)
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy().view(np.uint64), data.view(np.uint64))
        jlo, jhi = J.fpl_restore_device_f64(jnp.asarray(planes[:, :n].numpy()), h, w, d, pred, lv)
        jbits = np.asarray(jlo).astype(np.uint64) | (np.asarray(jhi).astype(np.uint64) << np.uint64(32))
        np.testing.assert_array_equal(got.numpy().reshape(-1).view(np.uint64), jbits)


def test_f64_finalize_past_a_tile_odd_n_matches_jax():
    """F2 over u64 words at n = 2,049 in one row (one past the card kernel's
    2,048-position tile; an odd n, a 63-byte zero tail), predictor 1: the
    eight planes, their zero tail and histograms against JAX."""
    h, w, d, pred, lv = 1, 2049, 1, 1, (4, 4, 3, 2, 1, 0, 1, 2)
    data = fband(h, w, d, "rows", seed=12)
    n = h * w * d
    planes, histos = F.fpl_finalize(torch.from_numpy(data), pred, lv)
    assert planes.shape == (8, F.padded(n)) and F.padded(n) - n == 63
    assert not planes[:, n:].any()
    jh, jp, _jpb = J.fpl_finalize_device_f64(*limbs(data), jnp.asarray(lv, jnp.int32), h, w, d,
                                             pred)
    np.testing.assert_array_equal(planes[:, :n].numpy(), np.asarray(jp))
    np.testing.assert_array_equal(histos.numpy(), np.asarray(jh))


F64_TILE_EDGE_SHAPES = [(1, 5000, 1), (3, 4500, 1)]  # n past one 4,096-position tile


@pytest.mark.parametrize("pred", [0, 1, 2])
@pytest.mark.parametrize("shape", F64_TILE_EDGE_SHAPES,
                         ids=["x".join(map(str, s)) for s in F64_TILE_EDGE_SHAPES])
def test_f64_restore_tile_edges_match_jax(shape, pred):
    """F3 over u64 words on random planes where the card's kernel carries
    between its tiles: n no multiple of the tile, a single row and rows
    longer than a tile. Equal to ``fpl_restore_device_f64`` bit for bit; the
    planes unchanged."""
    h, w, d = shape
    n = h * w * d
    rng = np.random.default_rng(n + pred)
    planes = torch.from_numpy(rng.integers(0, 256, (8, n + 5), dtype=np.uint8))
    before = planes.clone()
    lv = FLEVELS[1]
    got = F.fpl_restore(planes, h, w, d, pred, lv).numpy().reshape(-1).view(np.uint64)
    jlo, jhi = J.fpl_restore_device_f64(jnp.asarray(planes[:, :n].numpy()), h, w, d, pred, lv)
    jbits = np.asarray(jlo).astype(np.uint64) | (np.asarray(jhi).astype(np.uint64) << np.uint64(32))
    np.testing.assert_array_equal(got, jbits.reshape(-1))
    assert torch.equal(planes, before)


@pytest.mark.parametrize("shape", [(1, 2, 1), (1, 3, 1), (2, 2, 1), (4, 1, 1)])
def test_f64_tiny_bands_levels_above_their_length(shape):
    """Bands of 2-4 values, where JAX's level derivative fails (ROADMAP
    queue 3): a level past the length leaves the plane as it is; F2 then F3
    give the input back at every level and predictor."""
    data = fband(*shape, "noise", seed=9)
    h, w, d = shape
    for pred in (0, 1, 2):
        for levels in FLEVELS:
            lv = tuple(min(v, 5 - pred) for v in levels)
            planes, _histos = F.fpl_finalize(torch.from_numpy(data), pred, lv)
            got = F.fpl_restore(planes, h, w, d, pred, lv)
            np.testing.assert_array_equal(got.numpy().view(np.uint64), data.view(np.uint64))


def test_f64_split_arithmetic_wraps_like_jax():
    """The u64 split-field subtract and prefix sum (int64 bits) against
    JAX's limb-pair versions, on words whose mantissa borrows and whose
    exponent+sign field wraps."""
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2**63, (7, 9), dtype=np.int64).view(np.uint64) * np.uint64(2)
    words[0, :3] = [np.uint64(0), np.uint64(2**64 - 1), np.uint64(2**52)]
    a = torch.from_numpy(words.view(np.int64))
    got = F.split_sub64(a[:, 1:], a[:, :-1]).numpy().view(np.uint64)
    lo, hi = (words & np.uint64(0xFFFFFFFF)).astype(np.uint32), (words >> np.uint64(32)).astype(np.uint32)
    jl, jh = J.split_sub64_dev(jnp.asarray(lo[:, 1:]), jnp.asarray(hi[:, 1:]), jnp.asarray(lo[:, :-1]),
                               jnp.asarray(hi[:, :-1]))
    want = np.asarray(jl).astype(np.uint64) | (np.asarray(jh).astype(np.uint64) << np.uint64(32))
    np.testing.assert_array_equal(got, want)
    for axis in (0, 1):
        cs = F._split_cumsum64(a, axis).numpy().view(np.uint64)
        jl, jh = J.split_cumsum64_dev(jnp.asarray(lo), jnp.asarray(hi), axis)
        want = np.asarray(jl).astype(np.uint64) | (np.asarray(jh).astype(np.uint64) << np.uint64(32))
        np.testing.assert_array_equal(cs, want)
