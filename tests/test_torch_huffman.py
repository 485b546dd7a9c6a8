"""Port parity for the 8-bit Huffman pieces: the port's own copies of the
code-table modules (``codec/huffman.py``, ``codec/bitstuffer.py``), the plain
versions of H1-H4 (``ops/device_huffman.py``) and the host lengths-only scan
(``ops/huffman_scan.py``, compiled and plain) against the JAX package.

Criteria (exact): code lengths, canonical codes, table bytes and table
read-back equal to ``lerc_tpu.codec.huffman``; H1's streams and histograms
equal to ``symbol_streams_device`` / ``symbol_streams_masked_device`` plus
``histogram256`` less the gap zeros; H2's words, total bits and sidecar equal
to ``encode_stream_device``; H3's live symbols, used bits and ok equal to
``decode_stream_device`` (a tampered sidecar: ok False in both); H4 equal to
``symbols_to_image`` / ``expand_compacted_device`` /
``undelta_masked_device``; H3 on codes of 31 and 32 bits (which JAX's
decode refuses) equal to the host ``huffman.decode_symbols``; the scans equal
to ``lerc_tpu.native.huffman_group_offsets``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lerc_tpu import native
from lerc_tpu.codec import bitstuffer as jax_bits
from lerc_tpu.codec import device_codec as jax_codec
from lerc_tpu.codec import huffman as jax_huff
from lerc_tpu.constants import DataType as JaxDT
from lerc_tpu.ops import device_huffman as jdh
from lerc_tpu_torch.codec import bitstuffer, huffman
from lerc_tpu_torch.constants import DataType
from lerc_tpu_torch.ops import device_huffman as dh
from lerc_tpu_torch.ops import huffman_scan as hs

H, W = 48, 41
G = dh.GROUP


def histo(kind: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    h = np.zeros(256, np.int64)
    if kind == "random":
        h[rng.choice(256, 40, replace=False)] = rng.integers(1, 5000, 40)
    elif kind == "single":
        h[77] = 1000
    elif kind == "two":
        h[[3, 250]] = [10, 1]
    elif kind == "all256":
        h[:] = rng.integers(1, 300, 256)
    elif kind == "wrap":  # the used bins straddle 255 -> 0: the range wraps around
        h[[250, 252, 255, 0, 1, 4]] = [500, 20, 7, 900, 3, 60]
    elif kind == "skewed":  # long codes
        h[:24] = np.round(1.6 ** np.arange(24)).astype(np.int64)
    return h


HISTOS = ["random", "single", "two", "all256", "wrap", "skewed"]


@pytest.mark.parametrize("kind", HISTOS)
def test_code_table_matches_jax(kind):
    hst = histo(kind)
    lengths = huffman.compute_code_lengths(hst)
    jl = jax_huff.compute_code_lengths(hst)
    if kind == "single":  # fewer than two symbols: no code, in both
        assert lengths is None and jl is None
        return
    np.testing.assert_array_equal(lengths, jl)
    codes = huffman.canonical_codes(lengths)
    np.testing.assert_array_equal(codes, jax_huff.canonical_codes(jl))
    assert huffman.get_range(lengths) == jax_huff.get_range(jl)
    if kind == "wrap":
        i0, i1, _ = huffman.get_range(lengths)
        assert i1 > 256, "the range does not wrap"
    assert huffman.compute_compressed_size(hst, lengths) == jax_huff.compute_compressed_size(hst, jl)
    for version in (3, 4, 6):
        table = huffman.write_code_table(lengths, codes, version)
        assert table == jax_huff.write_code_table(jl, codes, version)
        for read in (huffman.read_code_table, jax_huff.read_code_table):
            rl, rc, used = read(table + b"\xaa" * 7, version)
            assert used == len(table)
            np.testing.assert_array_equal(rl, lengths)
            np.testing.assert_array_equal(rc, codes)


@pytest.mark.parametrize("n,top", [(1, 0), (7, 1), (200, 31), (300, 12), (70000, 5)])
def test_bitstuffer_simple_matches_jax(n, top):
    vals = np.random.default_rng(n).integers(0, top + 1, n).astype(np.uint32)
    blob = bitstuffer.encode_simple(vals, 6)
    assert blob == jax_bits.encode_simple(vals, 6)
    got, used = bitstuffer.decode(blob + b"\x00", n, 6)
    np.testing.assert_array_equal(got, vals)
    assert used == len(blob) == jax_bits.decode(blob, n, 6)[1]
    with pytest.raises(ValueError):
        bitstuffer.decode(blob[: len(blob) - 1], n, 6) if len(blob) > 2 else \
            bitstuffer.decode(blob[:1], n, 6)


def test_code_table_refusals():
    lengths = huffman.compute_code_lengths(histo("random"))
    table = huffman.write_code_table(lengths, huffman.canonical_codes(lengths), 6)
    for bad in (table[:10], table[:-1]):
        with pytest.raises(ValueError):
            huffman.read_code_table(bad, 6)
    # version 2's legacy bit order reads as JAX's (item 12, the host codec, landed)
    table2 = huffman.write_code_table(lengths, huffman.canonical_codes(lengths), 2)
    assert table2 == jax_huff.write_code_table(lengths, huffman.canonical_codes(lengths), 2)
    got, want = huffman.read_code_table(table2, 2), jax_huff.read_code_table(table2, 2)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    lut = jax_bits.encode_lut(np.array([0, 5, 5, 0, 9], np.uint32), 6)  # a valid LUT block
    np.testing.assert_array_equal(bitstuffer.decode(lut, 5, 6)[0], [0, 5, 5, 0, 9])
    with pytest.raises(ValueError, match="LUT"):
        bitstuffer.decode(lut[:1] + bytes([lut[1]]) + b"\x00" + lut[3:], 5, 6)  # LUT size 0
    codes = huffman.canonical_codes(lengths)
    codes[int(np.argmax(lengths))] ^= 1  # two codes of one length no longer consecutive
    with pytest.raises(ValueError, match="non-canonical"):
        huffman.canonical_decode_consts(lengths, codes)


# ---------------------------------------------------------------------------
# H1-H4 plain versions against the JAX device functions
# ---------------------------------------------------------------------------


def band(npdt, d: int, kind: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "flags":  # few codes, skewed: direct mode
        return rng.choice([0, 1, 2, 4, 8, 16, 64, 200], (H, W, d),
                          p=[.5, .2, .1, .08, .05, .04, .02, .01]).astype(npdt)
    x, y = np.meshgrid(np.linspace(0, 10, W), np.linspace(0, 8, H))
    base = np.stack([np.sin(x + i) * np.cos(y) * 60 + 3 * x * y for i in range(d)], -1)
    info = np.iinfo(npdt)
    return np.clip(np.round(base) + rng.integers(-1, 2, (H, W, d)), info.min, info.max).astype(npdt)


def stripes(h=H, w=W) -> np.ndarray:
    m = np.ones((h, w), bool)
    m[:, ::2] = False
    return m


MASKS = {"none": None, "rand": np.random.default_rng(9).random((H, W)) > 0.3, "stripes": stripes()}
H1_CASES = [  # (dtype, depth, mask)
    (np.uint8, 1, "none"), (np.int8, 3, "none"), (np.uint8, 1, "rand"), (np.int8, 3, "stripes"),
    (np.uint8, 3, "rand"),
]


def _dt(npdt):
    return DataType.CHAR if npdt == np.int8 else DataType.BYTE


def jax_streams(data, mask):
    """JAX's (direct, delta, live-symbol histograms) of a band."""
    h, w, d = data.shape
    jdt = JaxDT(int(_dt(data.dtype)))
    x = jnp.asarray(data.astype(np.int32))
    if mask is None:
        direct, delta = jdh.symbol_streams_device(x, h, w, d, jdt)
        gaps = 0
    else:
        direct, delta, _ = jdh.symbol_streams_masked_device(x, jnp.asarray(mask), h, w, d, jdt)
        gaps = (h * w - int(mask.sum())) * d
    hist = [np.asarray(jdh.histogram256(s)).astype(np.int64) for s in (direct, delta)]
    for hh in hist:
        hh[0] -= gaps
    return np.asarray(direct), np.asarray(delta), np.stack(hist)


@pytest.mark.parametrize("npdt,d,mname", H1_CASES,
                         ids=[f"{np.dtype(c[0]).name}-d{c[1]}-{c[2]}" for c in H1_CASES])
def test_h1_symbol_streams_match_jax(npdt, d, mname):
    data, mask = band(npdt, d, "smooth"), MASKS[mname]
    jd, je, jh = jax_streams(data, mask)
    pd, pe, ph = dh.symbol_streams_device(torch.from_numpy(data.astype(np.int32)),
                                          None if mask is None else torch.from_numpy(mask),
                                          _dt(npdt))
    n = H * W * d
    np.testing.assert_array_equal(pd.numpy()[:n], jd)
    np.testing.assert_array_equal(pe.numpy()[:n], je)
    assert not pd.numpy()[n:].any() and not pe.numpy()[n:].any()
    np.testing.assert_array_equal(ph.numpy(), jh)


def _tables(hst):
    lengths = huffman.compute_code_lengths(hst)
    codes = huffman.canonical_codes(lengths)
    lens_codes = np.zeros((256, 5), np.float32)
    lens_codes[:, 0] = lengths
    for b in range(4):
        lens_codes[:, 1 + b] = (codes >> (8 * b)) & 0xFF
    return lengths, codes, lens_codes


PACK_CASES = [  # (id, depth, mask, delta)
    ("all-valid-direct", 1, "none", False), ("all-valid-delta-d3", 3, "none", True),
    ("masked-direct", 1, "rand", False), ("masked-delta-d2", 2, "rand", True),
    ("stripes-delta", 1, "stripes", True),
]


def pack_inputs(d, mname, delta):
    """(symbols, histogram, live layout, JAX live mask or None) of one
    stream of a uint8 band."""
    data, mask = band(np.uint8, d, "smooth", seed=d), MASKS[mname]
    pd, pe, ph = dh.symbol_streams_device(torch.from_numpy(data.astype(np.int32)),
                                          None if mask is None else torch.from_numpy(mask),
                                          DataType.BYTE)
    nv = None if mask is None else int(mask.sum())
    layout = dh.live_layout(H * W, d, nv, delta)
    n = H * W * d
    live = None if mask is None else dh._live_mask(n, layout, "cpu").numpy()
    return (pe if delta else pd), ph[int(delta)].numpy().astype(np.int64), layout, live, n


@pytest.mark.parametrize("d,mname,delta", [c[1:] for c in PACK_CASES], ids=[c[0] for c in PACK_CASES])
def test_h2_pack_and_h3_decode_match_jax(d, mname, delta):
    sym, hst, layout, live, n = pack_inputs(d, mname, delta)
    lengths, codes, lens_codes = _tables(hst)
    total_bits = int((hst * lengths).sum())
    n_words = -(-total_bits // 32) + 1
    max_len = int(lengths.max())
    pwh = next(p for p in (18, 34, 66) if p >= (G * max_len + 31) // 32 + 1)
    cap = 1 << max(12, (4 * n_words + 511).bit_length())
    js, jtb, jsb = jdh.encode_stream_device(jnp.asarray(sym.numpy()[:n]), jnp.asarray(lens_codes),
                                            cap, pwh, live=None if live is None else jnp.asarray(live))
    words, tb, sbits = dh.encode_stream_device(sym, dh.code_table(lengths, codes, "cpu"), layout,
                                               n_words)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(js)[:n_words])
    assert int(tb) == int(jtb) == total_bits
    np.testing.assert_array_equal(sbits.numpy(), np.asarray(jsb))

    # H3 on the stream: JAX decodes the live prefix with sbits[:g_eff] (one
    # compacted run) or every group with a live mask (depth-major planes)
    consts, sorted_syms = huffman.canonical_decode_consts(lengths, codes)
    stream_u32 = np.zeros(-(-4 * n_words // 512) * 128, np.uint32)
    stream_u32[:n_words] = words.numpy().view(np.uint32)
    lanes = sorted_syms.astype(np.float32).reshape(16, 16, 1)
    multi_plane = live is not None and delta and d > 1
    n_eff = n if (live is None or multi_plane) else int(live.sum())
    g_eff = -(-n_eff // G)
    jlive = None
    if multi_plane:
        jlive = np.zeros(-(-n // G) * G, bool)
        jlive[:n] = live
    jsyms, jused, jok = jdh.decode_stream_device(
        jnp.asarray(stream_u32), jnp.asarray(np.asarray(jsb)[:g_eff]),
        jnp.asarray(consts.astype(np.int32)), jnp.asarray(lanes), n_eff, max_len,
        live=None if jlive is None else jnp.asarray(jlive))
    args = (torch.from_numpy(stream_u32.view(np.int32)), 32 * n_words, sbits,
            torch.from_numpy(consts), torch.from_numpy(sorted_syms), layout)
    syms, used, ok = dh.decode_stream_device(*args)
    assert bool(ok) and bool(jok)
    lv = dh._live_mask(syms.numel(), layout, "cpu").numpy()
    np.testing.assert_array_equal(syms.numpy()[lv], sym.numpy()[lv])
    np.testing.assert_array_equal(syms.numpy()[:n_eff][lv[:n_eff]], np.asarray(jsyms)[lv[:n_eff]])
    np.testing.assert_array_equal(used.numpy()[:g_eff], np.asarray(jused))
    assert not used.numpy()[g_eff:].any()

    # a tampered sidecar: ok False in both
    bad = np.asarray(jsb).copy()
    bad[min(3, bad.size - 1)] += 1
    _s, _u, ok = dh.decode_stream_device(args[0], args[1], torch.from_numpy(bad), *args[3:])
    jok = jdh.decode_stream_device(
        jnp.asarray(stream_u32), jnp.asarray(bad[:g_eff]), jnp.asarray(consts.astype(np.int32)),
        jnp.asarray(lanes), n_eff, max_len, live=None if jlive is None else jnp.asarray(jlive))[2]
    assert not bool(ok) and not bool(jok)
    shifted = np.asarray(jsb) + 32  # every offset shifted: sbits[0] != 0
    assert not bool(dh.decode_stream_device(args[0], args[1], torch.from_numpy(shifted),
                                            *args[3:])[2])


def test_h3_decodes_codes_of_31_and_32_bits():
    """A hand-built canonical code with lengths 1..31, 32, 32 (JAX's decode
    asserts lengths <= 30): H3's plain version equals the host decoder."""
    lengths = np.zeros(256, np.int32)
    order = np.random.default_rng(3).permutation(256)[:33]
    lengths[order[:31]] = np.arange(1, 32)
    lengths[order[31:]] = 32
    codes = huffman.canonical_codes(lengths)
    rng = np.random.default_rng(4)
    syms = np.concatenate([order, rng.choice(order, 300)]).astype(np.int64)
    rng.shuffle(syms)
    stream = jax_huff.encode_symbols(syms, lengths, codes)
    host, _ = jax_huff.decode_symbols(stream, lengths, codes, syms.size)
    np.testing.assert_array_equal(host, syms)
    n = syms.size
    g = -(-n // G)
    layout = (n, n, n)
    sbits = hs.huffman_group_offsets(stream, lengths, codes, dh.live_counts(g, layout))
    words = np.frombuffer(stream + b"\0" * (-len(stream) % 4), np.int32)
    consts, sorted_syms = huffman.canonical_decode_consts(lengths, codes)
    assert consts[32, 1] - consts[32, 0] == 2
    out, used, ok = dh.decode_stream_device(
        torch.from_numpy(words.copy()), len(stream) // 4 * 32, torch.from_numpy(sbits),
        torch.from_numpy(consts), torch.from_numpy(sorted_syms), layout)
    assert bool(ok)
    np.testing.assert_array_equal(out.numpy()[:n], syms)
    # and H2's plain version packs them back to the same words
    sym_t = torch.zeros(g * G, dtype=torch.uint8)
    sym_t[:n] = torch.from_numpy(syms.astype(np.uint8))
    packed, tb, sb = dh.encode_stream_device(sym_t, dh.code_table(lengths, codes, "cpu"), layout,
                                             words.size)
    np.testing.assert_array_equal(packed.numpy(), words)
    np.testing.assert_array_equal(sb.numpy(), sbits)


RESTORE_CASES = [(np.uint8, 1, "none"), (np.int8, 3, "none"), (np.uint8, 1, "rand"),
                 (np.int8, 2, "stripes")]


@pytest.mark.parametrize("npdt,d,mname", RESTORE_CASES,
                         ids=[f"{np.dtype(c[0]).name}-d{c[1]}-{c[2]}" for c in RESTORE_CASES])
def test_h4_restore_matches_jax(npdt, d, mname):
    data, mask = band(npdt, d, "smooth", seed=5), MASKS[mname]
    dt = _dt(npdt)
    jdt = JaxDT(int(dt))
    pd, pe, _ = dh.symbol_streams_device(torch.from_numpy(data.astype(np.int32)),
                                         None if mask is None else torch.from_numpy(mask), dt)
    n, npx = H * W * d, H * W
    if mask is None:
        for delta, sym in ((False, pd), (True, pe)):
            got = dh.symbols_to_image(sym, H, W, d, dt, delta)
            want = np.asarray(jdh.symbols_to_image(jnp.asarray(sym.numpy()[:n]), H, W, d, jdt,
                                                   delta))
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(got.numpy(), data)
        return
    mt = torch.from_numpy(mask)
    nv = int(mask.sum())
    off = 128 if dt == DataType.CHAR else 0
    # direct: JAX expands each depth slice's rank-ordered values
    got = dh.expand_compacted_device(pd, mt, d, dt)
    vals = ((pd.numpy()[:nv * d].reshape(nv, d).astype(np.int32) - off) & 0xFF).astype(np.uint32)
    cap_r = -(-nv // G) * G
    for k in range(d):
        comp = np.zeros(cap_r, np.uint32)
        comp[:nv] = vals[:, k]
        want = np.asarray(jdh.expand_compacted_device(jnp.asarray(comp),
                                                      jnp.asarray(mask.reshape(-1)), npx))
        np.testing.assert_array_equal(got.numpy()[:, :, k].view(np.uint8).reshape(-1),
                                      want.astype(np.uint8))
    # delta: JAX's rank-space un-delta over its host segment table
    got = dh.undelta_masked_device(pe, mt, d, dt)
    deltas = pe.numpy()[:n].reshape(d, npx)[:, :nv].astype(np.int32) - off
    seg_b, seg_t, seg_par = jax_codec._masked_delta_segments(mask)
    m_cap = 1 << max(4, (seg_b.shape[0] - 1).bit_length())
    pad = m_cap - seg_b.shape[0]
    want = np.asarray(jdh.undelta_masked_device(
        jnp.asarray(deltas), jnp.asarray(np.concatenate([seg_b, np.full(pad, nv, np.int32)])),
        jnp.asarray(np.concatenate([seg_t, np.zeros(pad, np.int32)])),
        jnp.asarray(np.concatenate([seg_par, np.zeros(pad, np.int32)])), nv, d, m_cap))
    np.testing.assert_array_equal(got.numpy().view(np.uint8)[mask].T, want.astype(np.uint8))
    assert not got.numpy()[~mask].any()
    np.testing.assert_array_equal(got.numpy()[mask], data[mask])


# ---------------------------------------------------------------------------
# the host lengths-only scan
# ---------------------------------------------------------------------------


SCAN_CASES = [("all-valid", 1, "none", False), ("masked-direct", 3, "rand", False),
              ("masked-delta-d2", 2, "rand", True)]


@pytest.mark.parametrize("d,mname,delta", [c[1:] for c in SCAN_CASES], ids=[c[0] for c in SCAN_CASES])
def test_host_scan_matches_native(d, mname, delta):
    sym, hst, layout, _live, n = pack_inputs(d, mname, delta)
    lengths, codes, _ = _tables(hst)
    total_bits = int((hst * lengths).sum())
    n_words = -(-total_bits // 32) + 1
    words, _tb, sbits = dh.encode_stream_device(sym, dh.code_table(lengths, codes, "cpu"), layout,
                                                n_words)
    stream = words.numpy().view(np.uint8)
    counts = dh.live_counts(sym.numel() // G, layout)
    want = native.huffman_group_offsets(stream, lengths, codes, counts)
    np.testing.assert_array_equal(want, sbits.numpy())
    np.testing.assert_array_equal(hs.huffman_group_offsets(stream, lengths, codes, counts), want)
    np.testing.assert_array_equal(hs.huffman_group_offsets_ref(stream, lengths, codes, counts),
                                  want)
    # a stream cut short: every scan raises
    for scan in (hs.huffman_group_offsets, hs.huffman_group_offsets_ref,
                 native.huffman_group_offsets):
        with pytest.raises(ValueError):
            scan(stream[: len(stream) // 2], lengths, codes, counts)
    with pytest.raises(ValueError):
        hs.huffman_group_offsets(stream, np.zeros(256, np.int32), codes, counts)
