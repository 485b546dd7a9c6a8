"""The port's host codec against JAX's: ``lerc2_encode.BandEncoder`` blobs
byte-equal to JAX's ``BandEncoder``, ``lerc2_decode.decode_band`` bit-equal to
JAX's ``decode_band``, on a matrix of the 8 dtypes, depth 1 and 3, with and
without a mask, versions 2-6 and maxZError 0 / lossy / 777; Huffman and fpl
bands; the legacy bit order and LUT blocks of ``bitstuffer``; Lerc1 blobs of
``tests/lerc1_writer.py`` through both ``lerc1`` decoders; the host Huffman
symbol codec and the fpl section codec."""
import numpy as np
import pytest

from lerc_tpu.codec import bitstuffer as jax_bits
from lerc_tpu.codec import fpl_impl as jax_fpl
from lerc_tpu.codec import huffman as jax_huffman
from lerc_tpu.codec import lerc1 as jax_lerc1
from lerc_tpu.codec import lerc2_decode as jax_dec
from lerc_tpu.codec.lerc2_encode import BandEncoder as JaxBandEncoder
from lerc_tpu_torch.codec import bitstuffer, fpl_impl, huffman, lerc1, lerc2_decode
from lerc_tpu_torch.codec.device_codec import band_sections
from lerc_tpu_torch.codec.lerc2_encode import BandEncoder

from .lerc1_writer import encode_lerc1

DTYPES = [np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32, np.float32, np.float64]
H, W = 40, 37  # edge blocks at 8x8 and 16x16


def _bits(a: np.ndarray) -> np.ndarray:
    """Floats as their bit patterns (NaN payloads and -0 compared too)."""
    a = np.asarray(a)
    return a.view({4: np.uint32, 8: np.uint64}[a.itemsize]) if a.dtype.kind == "f" else a


def make_band(npdt, d: int, seed: int = 0) -> np.ndarray:
    """A smooth ramp with noise, a flat patch (constant and LUT blocks) and,
    for depth > 1, slices close to slice 0 (depth-diff candidates)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    base = 20 * np.sin(x / 7.0) + 0.8 * y + rng.normal(0, 2, (H, W))
    base[5:21, 8:24] = 3.0
    base[30:, :10] = np.round(base[30:, :10] / 4) * 4  # few values: LUT blocks
    slices = [base + k * rng.integers(0, 3, (H, W)) for k in range(d)]
    v = np.stack(slices, -1)
    if np.dtype(npdt).kind == "f":
        return v.astype(npdt)
    info = np.iinfo(npdt)
    lo = 0 if info.min == 0 else -40
    return np.clip(np.round(v) + lo, info.min, info.max).astype(npdt)


MASK = np.random.default_rng(5).random((H, W)) > 0.2
MASK[10:18, 3:30] = False


def _lossy(npdt) -> float:
    return {np.float32: 0.01, np.float64: 0.001}.get(npdt, 2.0)


def _both(make_port, make_jax):
    """(port result, JAX result) or the two exceptions' types."""
    try:
        want = make_jax()
    except ValueError as e:
        with pytest.raises(type(e)):
            make_port()
        return None, None
    return make_port(), want


def assert_bands_equal(got, want):
    assert got.hd == got.hd.__class__(**vars(want.hd))
    np.testing.assert_array_equal(got.mask, want.mask)
    np.testing.assert_array_equal(_bits(got.data), _bits(want.data))
    assert got.data.dtype == want.data.dtype and got.consumed == want.consumed
    for a, b in ((got.z_min_vec, want.z_min_vec), (got.z_max_vec, want.z_max_vec)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


MATRIX = [(npdt, v, d, masked) for npdt in DTYPES for v in (2, 3, 4, 5, 6)
          for d, masked in ((1, False), (1, True), (3, False), (3, True))]


@pytest.mark.parametrize("npdt,version,d,masked", MATRIX,
                         ids=[f"{np.dtype(c[0]).name}-v{c[1]}-d{c[2]}{'-mask' if c[3] else ''}"
                              for c in MATRIX])
def test_band_encoder_and_decoder_match_jax(npdt, version, d, masked):
    data = make_band(npdt, d, seed=version)
    mask = MASK if masked else None
    for mze in (0.0, _lossy(npdt), 777):
        blob, jblob = _both(lambda: BandEncoder(data, mask, mze, version=version).encode(),
                            lambda: JaxBandEncoder(data, mask, mze, version=version).encode())
        if jblob is None:  # depth > 1 below v4, 777 on floats: both refuse
            continue
        assert blob == jblob, (mze, len(blob), len(jblob))
        got = lerc2_decode.decode_band(blob)
        assert_bands_equal(got, jax_dec.decode_band(blob))
        sel = np.ones((H, W), bool) if mask is None else mask
        if mze == 0 or (mze == 777 and np.dtype(npdt).kind != "f"):
            bound = 0 if mze == 0 else np.inf  # 777: the bit-plane cut sets its own bound
        else:
            bound = mze if np.dtype(npdt).kind == "f" else np.floor(mze)
        err = np.abs(got.data.astype(np.float64) - data.astype(np.float64))[sel].max()
        # float32: the decoded value's own rounding, one ulp of the largest value
        ulp = float(np.spacing(np.abs(data).max())) if npdt == np.float32 else 0.0
        assert err <= bound + ulp


HUFFMAN = [(npdt, v, masked) for npdt in (np.int8, np.uint8) for v in (2, 4, 6)
           for masked in (False, True)]


@pytest.mark.parametrize("npdt,version,masked", HUFFMAN,
                         ids=[f"{np.dtype(c[0]).name}-v{c[1]}{'-mask' if c[2] else ''}"
                              for c in HUFFMAN])
def test_huffman_bands_match_jax(npdt, version, masked):
    rng = np.random.default_rng(version)
    walk = np.cumsum(rng.integers(-2, 3, (H, W)), axis=1) + (0 if npdt == np.int8 else 120)
    data = np.clip(walk, np.iinfo(npdt).min, np.iinfo(npdt).max).astype(npdt)[:, :, None]
    mask = MASK if masked else None
    blob = BandEncoder(data, mask, 0.5, version=version).encode()
    assert blob == JaxBandEncoder(data, mask, 0.5, version=version).encode()
    got = lerc2_decode.decode_band(blob)
    assert_bands_equal(got, jax_dec.decode_band(blob))
    sel = np.ones((H, W), bool) if mask is None else mask
    np.testing.assert_array_equal(got.data[sel], data[sel])
    if version >= 3:  # the blob really is a whole-image Huffman one (the parse needs v3+)
        assert band_sections(blob).kind == "huffman"


@pytest.mark.parametrize("npdt", [np.float32, np.float64])
@pytest.mark.parametrize("d,masked", [(1, False), (1, True), (3, False)])
def test_fpl_bands_match_jax(npdt, d, masked):
    rng = np.random.default_rng(d)
    y, x = np.mgrid[0:H, 0:W]
    data = np.stack([np.sin(x / 9.0) * 300 + y * 0.37 + k for k in range(d)], -1).astype(npdt)
    data[3, 4, 0] = rng.normal() * 1e6
    mask = MASK if masked else None
    blob = BandEncoder(data, mask, 0.0).encode()
    assert blob == JaxBandEncoder(data, mask, 0.0).encode()
    assert band_sections(blob).kind == "fpl"
    got = lerc2_decode.decode_band(blob)
    assert_bands_equal(got, jax_dec.decode_band(blob))
    sel = np.ones((H, W), bool) if mask is None else mask
    np.testing.assert_array_equal(_bits(got.data[sel]), _bits(data[sel]))


def test_fpl_section_codec_matches_jax():
    rng = np.random.default_rng(3)
    for npdt, d in ((np.float32, 1), (np.float32, 2), (np.float64, 1)):
        data = (rng.normal(0, 1, (13, 11, d)).cumsum(0) * 50).astype(npdt)
        sec = fpl_impl.encode_flt(data, 11, 13, d)
        assert sec == jax_fpl.encode_flt(data, 11, 13, d)
        rows, cols = fpl_impl.slice_shape(13, 11, d)
        words, used = fpl_impl.decode_slice(memoryview(sec), cols, rows, npdt == np.float64)
        jwords, jused = jax_fpl.decode_slice(memoryview(sec), cols, rows, npdt == np.float64)
        np.testing.assert_array_equal(words, jwords)
        assert used == jused == len(sec)
    plane = rng.integers(0, 7, 5000).astype(np.uint8)
    for level in range(4):
        p = fpl_impl.set_derivative(plane, level)
        np.testing.assert_array_equal(p, jax_fpl.set_derivative(plane, level))
        np.testing.assert_array_equal(fpl_impl.restore_sequence(p, level), plane)
    for name in ("huffman", "packbits", "raw", "rle"):
        src = {"huffman": plane, "packbits": np.repeat(plane[:50], 40),
               "raw": rng.integers(0, 256, 300).astype(np.uint8),
               "rle": np.full(77, 9, np.uint8)}[name]
        payload = fpl_impl.compress_plane(src)
        assert payload == jax_fpl.compress_plane(src)
        np.testing.assert_array_equal(fpl_impl.extract_plane(memoryview(payload), src.size), src)
        assert fpl_impl.entropy_size(src) == jax_fpl.entropy_size(src)


@pytest.mark.parametrize("n,top", [(1, 1), (7, 3), (300, 1000), (70000, 2**31 - 1),
                                   (33, 2**20)])
@pytest.mark.parametrize("version", [2, 3])
def test_bitstuffer_both_orders_and_lut_match_jax(n, top, version):
    rng = np.random.default_rng(n)
    vals = rng.integers(0, top, n, endpoint=True).astype(np.uint32)
    blob = bitstuffer.encode_simple(vals, version)
    assert blob == jax_bits.encode_simple(vals, version)
    got, used = bitstuffer.decode(blob, n, version)
    np.testing.assert_array_equal(got, vals)
    assert used == len(blob)
    lut_vals = rng.choice(np.array([0, 3, top], np.uint32), n)
    lut_vals[0] = 0
    if np.unique(lut_vals).size > 1:
        lut = bitstuffer.encode_lut(lut_vals, version)
        assert lut == jax_bits.encode_lut(lut_vals, version)
        got, used = bitstuffer.decode(lut, n, version)
        np.testing.assert_array_equal(got, lut_vals)
        assert used == len(lut) == jax_bits.decode(lut, n, version)[1]
        sorted_q = np.sort(lut_vals)
        assert bitstuffer.compute_bytes_lut(sorted_q, n) == jax_bits.compute_bytes_lut(sorted_q, n)
    with pytest.raises(ValueError):
        bitstuffer.decode(blob[:-1], n, version) if len(blob) > 2 else bitstuffer.decode(b"", n,
                                                                                          version)


@pytest.mark.parametrize("seed", range(4))
def test_host_huffman_symbols_match_jax(seed):
    rng = np.random.default_rng(seed)
    syms = np.minimum(rng.geometric(0.15 + 0.1 * seed, 3001), 255).astype(np.int64)
    histo = np.bincount(syms, minlength=256).astype(np.int64)
    lengths = huffman.compute_code_lengths(histo)
    codes = huffman.canonical_codes(lengths)
    stream = huffman.encode_symbols(syms, lengths, codes)
    assert stream == jax_huffman.encode_symbols(syms, lengths, codes)
    got, used = huffman.decode_symbols(stream, lengths, codes, syms.size)
    np.testing.assert_array_equal(got, syms)
    np.testing.assert_array_equal(huffman._canonical_order(lengths),
                                  jax_huffman._canonical_order(lengths))
    assert used == len(stream)
    with pytest.raises(ValueError):
        huffman.decode_symbols(stream[:8], lengths, codes, syms.size)


LERC1 = [("const", None, 0.0, 1), ("rle", "mask", 0.5, 1), ("tiled", "mask", 0.01, 2),
         ("auto", None, 2.0, 3), ("tiled", None, 0.0, 1), ("auto", "mask", 0.0, 2)]


@pytest.mark.parametrize("style,masked,mze,nb", LERC1,
                         ids=[f"{c[0]}-{c[1] or 'all'}-{c[2]}-{c[3]}b" for c in LERC1])
def test_lerc1_blobs_through_both_decoders(style, masked, mze, nb):
    from lerc_tpu.codec import orchestrator as jax_orch
    from lerc_tpu_torch.codec import orchestrator

    rng = np.random.default_rng(nb)
    h, w = 29, 35
    y, x = np.mgrid[0:h, 0:w]
    bands = [(np.sin(x / (b + 2.0)) * 100 + y + rng.normal(0, 3, (h, w))).astype(np.float32)
             for b in range(nb)]
    mask = (rng.random((h, w)) > 0.3) if masked else None
    blob = encode_lerc1(bands, mask, mze, cnt_style=style if (masked or style != "rle") else "auto",
                        grid=(3, 4), seed=nb)
    got, want = lerc1.decode_all_bands(memoryview(blob)), jax_lerc1.decode_all_bands(memoryview(blob))
    assert got[1:] == want[1:] and len(got[0]) == len(want[0]) == nb
    for (c, z), (jc, jz) in zip(got[0], want[0]):
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(_bits(z), _bits(jz))
    res = orchestrator.decode_blob(blob, device="cpu")
    jres = jax_orch.decode_blob(blob)
    np.testing.assert_array_equal(_bits(res.data), _bits(jres.data))
    np.testing.assert_array_equal(res.masks, jres.masks)
    assert vars(orchestrator.get_lerc_info(blob)) == vars(jax_orch.get_lerc_info(blob))
    m = np.ones((h, w), bool) if mask is None else mask
    for b in range(nb):
        tol = mze * 1.01 if mze else 1e-6
        assert np.abs(res.data[b, :, :, 0] - bands[b])[m].max() <= tol
        for npdt in (np.float64, np.int16, np.uint8):
            np.testing.assert_array_equal(lerc1.convert(res.data[b, :, :, 0], m, npdt),
                                          jax_lerc1.convert(res.data[b, :, :, 0], m, npdt))
    with pytest.raises(ValueError):
        lerc1.decode_all_bands(memoryview(blob[: len(blob) // 2]))
