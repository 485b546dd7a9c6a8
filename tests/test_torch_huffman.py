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


def one_pixel(i) -> np.ndarray:
    m = np.zeros((H, W), bool)
    m.flat[i] = True
    return m


def sparse_rows() -> np.ndarray:
    """Valid pixels in rows 0 and 40 alone: a long invalid stretch carries
    the last valid pixel across the masked H1's tiles."""
    m = np.zeros((H, W), bool)
    m[[0, 40]] = np.random.default_rng(10).random((2, W)) > 0.5
    return m


MASKS = {"none": None, "rand": np.random.default_rng(9).random((H, W)) > 0.3, "stripes": stripes(),
         "empty": np.zeros((H, W), bool), "full": np.ones((H, W), bool), "first": one_pixel(0),
         "last": one_pixel(-1), "sparse-rows": sparse_rows()}
H1_CASES = [  # (dtype, depth, mask)
    (np.uint8, 1, "none"), (np.int8, 3, "none"), (np.uint8, 1, "rand"), (np.int8, 3, "stripes"),
    (np.uint8, 3, "rand"),
    # the masked H1's edge masks, depths 1-4 and 8, uint8 and int8
    (np.uint8, 1, "empty"), (np.int8, 3, "empty"), (np.uint8, 2, "full"), (np.int8, 4, "full"),
    (np.uint8, 3, "first"), (np.int8, 1, "last"), (np.uint8, 8, "sparse-rows"),
    (np.int8, 8, "rand"), (np.uint8, 4, "stripes"), (np.int8, 2, "sparse-rows"),
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


def _tables_of(lengths, codes):
    """_tables' JAX lens_codes for a given code."""
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


def h2_edge_codes():
    """{label: code lengths} of the H2 tile-edge cases: a random 40-symbol
    histogram's, two symbols (1-bit codes), lengths 1..31, 32, 32."""
    rng = np.random.default_rng(16)
    hst = np.zeros(256, np.int64)
    hst[rng.choice(256, 40, replace=False)] = rng.integers(1, 5000, 40)
    two = np.zeros(256, np.int32)
    two[[3, 250]] = 1
    deep = np.zeros(256, np.int32)
    order = np.random.default_rng(3).permutation(256)[:33]
    deep[order[:31]] = np.arange(1, 32)
    deep[order[31:]] = 32
    return {"random": huffman.compute_code_lengths(hst), "1-bit": two, "1..32-bit": deep}


def h2_edge_layouts(n, tile):
    """Live layouts of an n-symbol stream at the edges of H2's tiles:
    all-valid, masked direct with 0, 1 and a third live, masked delta with
    planes of 7 and 1,000 (n_total not whole groups) and with zero gaps
    spanning whole tiles."""
    return {"all-valid": (n, n, n), "none live": (n, n, 0), "one live": (n, n, 1),
            "a third live": (n, n, n // 3 + 5), "planes of 7": (n - 3, 7, 3),
            "planes of 1000": (n - 37, 1000, 300), "gaps of whole tiles": (n, 3 * tile + 100, 100)}


@pytest.mark.parametrize("tile", [64, 128, 512])
@pytest.mark.parametrize("cname", ["random", "1-bit", "1..32-bit"])
def test_h2_tiled_ref_matches_plain_at_tile_edges(cname, tile):
    """encode_stream_tiled_ref (H2's tile algebra: tile sums, look-back
    prefixes, edge-word joins) equals the plain version on streams of 64,
    T - 64, T, T + 64 and 3T + 64 symbols in every edge layout, the words
    sized exactly ceil(bits / 32) + 1."""
    lengths = h2_edge_codes()[cname]
    table = dh.code_table(lengths, huffman.canonical_codes(lengths), "cpu")
    rng = np.random.default_rng(tile)
    for n in sorted({64, max(64, tile - 64), tile, tile + 64, 3 * tile + 64}):
        sym = torch.from_numpy(rng.choice(np.flatnonzero(lengths), n).astype(np.uint8))
        for lname, layout in h2_edge_layouts(n, tile).items():
            live = dh._live_mask(n, layout, "cpu")
            n_words = -(-int(table[0].long()[sym.long()][live].sum()) // 32) + 1
            got = dh.encode_stream_tiled_ref(sym, table, layout, n_words, tile)
            want = dh.encode_stream_device_ref(sym, table, layout, n_words)
            assert torch.equal(got[0], want[0]), (n, lname)
            assert int(got[1]) == int(want[1]), (n, lname)
            assert torch.equal(got[2], want[2]), (n, lname)


@pytest.mark.parametrize("cname", ["random", "1-bit"])
def test_h2_tiled_ref_matches_jax(cname):
    """encode_stream_tiled_ref at a 128-symbol tile equals JAX's
    encode_stream_device (words, total bits, sbits) on 448 symbols (3T + 64)
    all-valid, with one live symbol, in planes of 100 and with a zero gap
    spanning whole tiles."""
    lengths = h2_edge_codes()[cname]
    codes = huffman.canonical_codes(lengths)
    table = dh.code_table(lengths, codes, "cpu")
    _l, _c, lens_codes = _tables_of(lengths, codes)
    n = 448
    sym = torch.from_numpy(np.random.default_rng(2).choice(np.flatnonzero(lengths), n)
                           .astype(np.uint8))
    pwh = next(p for p in (18, 34, 66) if p >= (G * int(lengths.max()) + 31) // 32 + 1)
    for layout in ((n, n, n), (n, n, 1), (n - 37, 100, 30), (n, 484, 100)):
        live = dh._live_mask(n, layout, "cpu")
        n_words = -(-int(table[0].long()[sym.long()][live].sum()) // 32) + 1
        cap = 1 << max(12, (4 * n_words + 511).bit_length())
        js, jtb, jsb = jdh.encode_stream_device(
            jnp.asarray(sym.numpy()), jnp.asarray(lens_codes), cap, pwh,
            live=None if layout == (n, n, n) else jnp.asarray(live.numpy()))
        words, tb, sbits = dh.encode_stream_tiled_ref(sym, table, layout, n_words, 128)
        np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(js)[:n_words])
        assert int(tb) == int(jtb)
        np.testing.assert_array_equal(sbits.numpy(), np.asarray(jsb))


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


DEEP_HISTOS = {  # codes past 12 bits: lengths 2..15 and 1..19
    "skewed-28": np.round(1.6 ** np.arange(28)).astype(np.int64),
    "pow2-20": 2 ** np.arange(20, dtype=np.int64),
}


def deep_stream(kind, n=3000, seed=5):
    """(lengths, codes, symbols [g * 64], H3 args) of n symbols drawn evenly
    from a deep code's symbols, packed by H2's plain version."""
    hst = np.zeros(256, np.int64)
    hst[:DEEP_HISTOS[kind].size] = DEEP_HISTOS[kind]
    lengths = huffman.compute_code_lengths(hst)
    codes = huffman.canonical_codes(lengths)
    g = -(-n // G)
    sym = torch.zeros(g * G, dtype=torch.uint8)
    sym[:n] = torch.from_numpy(np.random.default_rng(seed).choice(np.flatnonzero(lengths), n)
                               .astype(np.uint8))
    layout = (n, n, n)
    n_words = -(-int(lengths[sym[:n].numpy()].sum()) // 32) + 1
    words, _tb, sbits = dh.encode_stream_device(sym, dh.code_table(lengths, codes, "cpu"), layout,
                                                n_words)
    consts, sorted_syms = huffman.canonical_decode_consts(lengths, codes)
    args = (torch.cat([words, words.new_zeros(1)]), 32 * n_words, sbits, torch.from_numpy(consts),
            torch.from_numpy(sorted_syms), layout)
    return lengths, codes, sym, args


def jax_h3(args, lengths, sbits=None, consts=None):
    """JAX's decode_stream_device on the plain version's arguments."""
    words, _nb, sb, cst, sorted_syms, (n, _p, _l) = args
    sb = sb if sbits is None else sbits
    cst = cst if consts is None else consts
    w = words.numpy().view(np.uint32)
    stream_u32 = np.zeros(-(-4 * w.size // 512) * 128, np.uint32)
    stream_u32[:w.size] = w
    lanes = sorted_syms.numpy().astype(np.float32).reshape(16, 16, 1)
    out = jdh.decode_stream_device(jnp.asarray(stream_u32), jnp.asarray(np.asarray(sb)),
                                   jnp.asarray(np.asarray(cst).astype(np.int32)),
                                   jnp.asarray(lanes), n, int(lengths.max()))
    return np.asarray(out[0]), np.asarray(out[1]), bool(out[2])


@pytest.mark.parametrize("kind", list(DEEP_HISTOS))
def test_h3_deep_codes_match_jax(kind):
    """Codes past 12 bits (past the CUDA kernel's decode table, into its
    search over the longer lengths): the plain version equals JAX's decode
    and the input."""
    lengths, _codes, sym, args = deep_stream(kind)
    assert lengths.max() > 12
    n = args[5][0]
    syms, used, ok = dh.decode_stream_device(*args)
    jsyms, jused, jok = jax_h3(args, lengths)
    assert bool(ok) and jok
    np.testing.assert_array_equal(syms.numpy()[:n], sym.numpy()[:n])
    np.testing.assert_array_equal(syms.numpy()[:n], jsyms[:n])
    np.testing.assert_array_equal(used.numpy(), jused)


def test_h3_incomplete_code_matches_jax():
    """A table that lacks one code of the stream (its longest length's last
    code): each group decodes up to that symbol's first place, then stops;
    used bits equal to JAX's, ok False in both."""
    lengths, codes, sym, args = deep_stream("skewed-28")
    longest = np.flatnonzero(lengths == lengths.max())
    drop = int(longest[np.argmax(codes[longest])])
    cut = lengths.copy()
    cut[drop] = 0
    consts, sorted_syms = huffman.canonical_decode_consts(cut, codes)
    args = (*args[:3], torch.from_numpy(consts), torch.from_numpy(sorted_syms), args[5])
    syms, used, ok = dh.decode_stream_device(*args)
    jsyms, jused, jok = jax_h3(args, lengths, consts=consts)
    assert not bool(ok) and not jok
    np.testing.assert_array_equal(used.numpy(), jused)
    n = args[5][0]
    inp, got = sym.numpy()[:n], syms.numpy()[:n]
    for g0 in range(0, n, G):
        grp = inp[g0:g0 + G]
        f = int(np.argmax(grp == drop)) if (grp == drop).any() else grp.size
        np.testing.assert_array_equal(got[g0:g0 + f], grp[:f])
        np.testing.assert_array_equal(jsyms[g0:g0 + f], grp[:f])
        assert not got[g0 + f:g0 + grp.size].any()
    assert (inp == drop).any()


@pytest.mark.parametrize("how", ["moved", "negative", "past", "shifted"])
def test_h3_hostile_sidecar_matches_jax(how):
    """A sidecar that lies: one start moved by a bit, one negative, one past
    the stream, every start shifted by a word. ok False in both; the used
    bits equal JAX's in every group whose start the edit left (for the moved
    start, in every group), the symbols too where the group is whole."""
    lengths, _codes, sym, args = deep_stream("skewed-28")
    sb = args[2].numpy().copy()
    g, k = sb.size, sb.size // 2
    if how == "moved":
        sb[k] += 1
    elif how == "negative":
        sb[k] = -5
    elif how == "past":
        sb[k] = 2**31 - 1
    else:
        sb += 32
    hostile = (args[0], args[1], torch.from_numpy(sb), *args[3:])
    syms, used, ok = dh.decode_stream_device(*hostile)
    _jsyms, jused, jok = jax_h3(args, lengths, sbits=sb)
    assert not bool(ok) and not jok
    if how == "shifted":
        return
    keep = np.ones(g, bool)
    if how != "moved":
        keep[k] = False
        assert used.numpy()[k] == 0
    np.testing.assert_array_equal(used.numpy()[keep], jused[keep])
    keep[k] = False
    whole = np.repeat(keep, G)[:args[5][0]]
    np.testing.assert_array_equal(syms.numpy()[:whole.size][whole], sym.numpy()[:whole.size][whole])


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


def checkerboard(h, w, rows=1) -> np.ndarray:
    """Valid where (r // rows + c) is even: no use-above pixel at rows 1, one
    at every valid pixel of an odd row at rows 2."""
    r, c = np.ogrid[:h, :w]
    return (r // rows + c) % 2 == 0


def _first_rows_invalid(h, w, k, seed=11):
    m = np.random.default_rng(seed).random((h, w)) > 0.2
    m[:k] = False
    return m


def _hole(h, w, seed=12):
    m = np.random.default_rng(seed).random((h, w)) > 0.05
    m[h // 4:h // 2, w // 3:2 * w // 3] = False
    return m


SEGMENT_MASKS = {  # the masked un-delta's segment tables, each against JAX's
    "rand": MASKS["rand"], "stripes": stripes(), "checkerboard": checkerboard(H, W),
    "checkerboard-2row": checkerboard(H, W, 2), "first-rows-invalid": _first_rows_invalid(H, W, 9),
    "w1": np.random.default_rng(13).random((200, 1)) > 0.3,
    "h1": np.random.default_rng(14).random((1, 200)) > 0.3,
    "one-valid": np.eye(1, H * W, 777, dtype=bool).reshape(H, W),
    "all-valid": np.ones((H, W), bool), "hole": _hole(H, W),
}


@pytest.mark.parametrize("mname", list(SEGMENT_MASKS))
def test_h4_masked_segment_table_matches_jax(mname):
    """The segment table of the masked un-delta (its kernels' pass 2: each
    use-above pixel's rank, the rank above it, the parent segment) equal to
    JAX's host ``_masked_delta_segments``."""
    mask = SEGMENT_MASKS[mname]
    got = dh.masked_delta_segments_ref(torch.from_numpy(mask))
    for g, w in zip(got, jax_codec._masked_delta_segments(mask)):
        np.testing.assert_array_equal(g.numpy(), w)


MASKED_DELTA_CASES = [  # (id, dtype, depth, [H, W] mask)
    ("checkerboard-u8-d3", np.uint8, 3, checkerboard(H, W)),
    ("checkerboard-2row-i8-d2", np.int8, 2, checkerboard(H, W, 2)),
    ("w1-u8-d2", np.uint8, 2, np.random.default_rng(15).random((300, 1)) > 0.3),
    ("first-rows-invalid-i8-d1", np.int8, 1, _first_rows_invalid(H, W, 9)),
    ("d5-u8-hole", np.uint8, 5, _hole(H, W)),
    ("d5-i8-stripes", np.int8, 5, stripes()),
]


def _jax_undelta(pe, mask, d, dt):
    """JAX's ``undelta_masked_device`` over its host segment table: [D, nv]."""
    npx = mask.size
    nv = int(mask.sum())
    off = 128 if dt == DataType.CHAR else 0
    deltas = pe.numpy()[:npx * d].reshape(d, npx)[:, :nv].astype(np.int32) - off
    seg_b, seg_t, seg_par = jax_codec._masked_delta_segments(mask)
    m_cap = 1 << max(4, (seg_b.shape[0] - 1).bit_length())
    pad = m_cap - seg_b.shape[0]
    return np.asarray(jdh.undelta_masked_device(
        jnp.asarray(deltas), jnp.asarray(np.concatenate([seg_b, np.full(pad, nv, np.int32)])),
        jnp.asarray(np.concatenate([seg_t, np.zeros(pad, np.int32)])),
        jnp.asarray(np.concatenate([seg_par, np.zeros(pad, np.int32)])), nv, d, m_cap))


@pytest.mark.parametrize("npdt,d,mask", [c[1:] for c in MASKED_DELTA_CASES],
                         ids=[c[0] for c in MASKED_DELTA_CASES])
def test_h4_masked_delta_matches_jax(npdt, d, mask):
    """The masked un-delta (plain version) on H1's delta symbols of a band,
    on the masks its kernels treat apart (no use-above pixel, one at every
    other row, W = 1, rows with no valid pixel first, D > 4 in two groups of
    depths): equal to JAX's ``undelta_masked_device`` over
    ``_masked_delta_segments`` and to the band at the valid pixels, 0
    elsewhere."""
    h, w = mask.shape
    rng = np.random.default_rng(h * 7 + w + d)
    info = np.iinfo(npdt)
    data = rng.integers(info.min, info.max + 1, (h, w, d)).astype(npdt)
    dt = _dt(npdt)
    _pd, pe, _ = dh.symbol_streams_device(torch.from_numpy(data.astype(np.int32)),
                                          torch.from_numpy(mask), dt)
    got = dh.undelta_masked_device(pe, torch.from_numpy(mask), d, dt).numpy()
    np.testing.assert_array_equal(got.view(np.uint8)[mask].T,
                                  _jax_undelta(pe, mask, d, dt).astype(np.uint8))
    np.testing.assert_array_equal(got[mask], data[mask])
    assert not got[~mask].any()


def test_h4_masked_delta_past_2_16_segments_matches_the_host_decoder():
    """A 520x512 int8 band of depth 2 under a stripes mask: 133,120
    segments, past the 2^16 at which JAX's decode gives up. The masked
    un-delta (plain version) on H1's delta symbols equals the host decoder's
    (``codec/lerc2_decode``) image of the band's Huffman blob."""
    from lerc_tpu_torch.codec import lerc2_decode
    from lerc_tpu_torch.codec.device_codec import band_sections
    from lerc_tpu_torch.codec.lerc2_encode import BandEncoder

    h, w, d = 520, 512, 2
    mask = stripes(h, w)
    assert jax_codec._masked_delta_segments(mask)[0].shape[0] - 1 > 1 << 16
    x, y = np.meshgrid(np.arange(w), np.arange(h))
    data = np.stack([(x // 3 + y // 5) % 256 - 128, (x // 7 - y // 2) % 256 - 128],
                    -1).astype(np.int8)
    blob = BandEncoder(data, mask, 0.5).encode()
    sec = band_sections(blob)
    assert (sec.kind, sec.mode) == ("huffman", 1)  # delta Huffman
    host = lerc2_decode.decode_band(blob)
    _pd, pe, _ = dh.symbol_streams_device(torch.from_numpy(data.astype(np.int32)),
                                          torch.from_numpy(mask), DataType.CHAR)
    got = dh.undelta_masked_device(pe, torch.from_numpy(mask), d, DataType.CHAR).numpy()
    np.testing.assert_array_equal(got[mask], host.data[mask])
    np.testing.assert_array_equal(got[mask], data[mask])
    assert not got[~mask].any()


EDGE_SHAPES = [  # (H, W, D, dtype, storage offset of the symbols)
    (1, 17, 3, np.uint8, 0), (5, 1, 2, np.uint8, 3), (3, 4099, 5, np.uint8, 0),
    (2, 33, 8, np.uint8, 7), (4, 16, 4, np.int8, 0), (1, 15, 1, np.int8, 15),
    (3, 6149, 3, np.int8, 1),
]


@pytest.mark.parametrize("h,w,d,npdt,off", EDGE_SHAPES,
                         ids=[f"{c[0]}x{c[1]}x{c[2]}-{np.dtype(c[3]).name}-at{c[4]}"
                              for c in EDGE_SHAPES])
def test_h4_restore_edge_shapes_match_jax(h, w, d, npdt, off):
    """The all-valid H4 (``symbols_to_image`` on CPU tensors: its plain
    version), direct and delta, on the shapes the card's kernels treat
    apart: D of one u32 and of several groups of four, W of 1, under and over
    16 and over several 2,048-pixel tiles, H = 1, symbol views at a storage
    offset. Equal to JAX's ``symbols_to_image`` on the same numpy symbols and
    to the image they came from."""
    rng = np.random.default_rng(h * 100_003 + w * 31 + d)
    info = np.iinfo(npdt)
    data = rng.integers(info.min, info.max + 1, (h, w, d)).astype(npdt)
    dt = _dt(npdt)
    jdt = JaxDT(int(dt))
    pd, pe, _ = dh.symbol_streams_device(torch.from_numpy(data.astype(np.int32)), None, dt)
    n = h * w * d
    for delta, sym in ((False, pd), (True, pe)):
        syms = sym.numpy()[:n]
        view = torch.from_numpy(np.concatenate([rng.integers(0, 256, off, dtype=np.uint8), syms,
                                                rng.integers(0, 256, 5, dtype=np.uint8)]))[off:]
        got = dh.symbols_to_image(view, h, w, d, dt, delta)
        want = np.asarray(jdh.symbols_to_image(jnp.asarray(syms), h, w, d, jdt, delta))
        assert got.dtype == (torch.int8 if npdt == np.int8 else torch.uint8)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), data)


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
