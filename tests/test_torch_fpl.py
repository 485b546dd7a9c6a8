"""Port parity for the lossless float32 (fpl) kernels' plain versions:
``lerc_tpu_torch.ops.device_fpl`` (device="cpu") against the jitted
functions of ``lerc_tpu.ops.device_fpl`` on numpy-seeded float32 bands, and
the port's PackBits copy against ``lerc_tpu.codec.fpl_impl``.

Criteria (exact): F1's histograms equal to counts taken from JAX's own
intermediate arrays, and the host choice (predictor and levels) equal to
``fpl_choose_device``; F2's planes and histograms and F2b's PackBits sizes
equal to ``fpl_finalize_device`` (predictors 0, 1 and 2 forced, every level
0..5), and F2b's plain version and ``packbits_size_tiled_ref`` (the
kernel's per-tile algebra at tiles of 1-64 bytes) equal to
``packbits_size_device`` on edge planes and drawn run lists; F3 equal to
``fpl_restore_device`` and to the input bits; the Huffman
planes' streams and group start bits through H2 equal to
``fpl_pack_planes_device``. Shapes: depth 1 and 3, 1x5, 2x3, 1xN, Nx1 and a
1300x1250 band that F1 samples at a row stride of 3. JAX compiles once per
shape and predictor (static levels once per tuple), so the shapes are few.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lerc_tpu.codec import fpl_impl as jax_fpl
from lerc_tpu.codec import huffman as jax_huff
from lerc_tpu.ops import device_fpl as J
from lerc_tpu.ops import device_huffman as jax_dh
from lerc_tpu_torch.codec import fpl_impl
from lerc_tpu_torch.codec import huffman
from lerc_tpu_torch.ops import device_fpl as F


def band(h, w, d, kind, seed=0):
    """float32 [h, w, d]: "smooth" (a hill, little noise), "rows" (each row
    a random walk) or "noise"."""
    rng = np.random.default_rng(seed)
    x, y = np.meshgrid(np.linspace(0, 4, w), np.linspace(0, 3, h))
    if kind == "smooth":
        base = (1000 + 200 * np.sin(x) * np.cos(y))[:, :, None] + 3.0 * np.arange(d)
        return (base + 1e-3 * rng.standard_normal((h, w, d))).astype(np.float32)
    if kind == "rows":
        return np.cumsum(rng.standard_normal((h, w, d)), 1).astype(np.float32)
    return rng.normal(0, 1, (h, w, d)).astype(np.float32)


SHAPES = [(48, 41, 1), (13, 11, 3), (1, 5, 1), (2, 3, 1), (1, 40, 1), (40, 1, 1)]
SHAPE_IDS = ["x".join(map(str, s)) for s in SHAPES]
LEVELS = [(0, 1, 2, 3), (4, 5, 5, 0)]  # every level 0..5 over the two


def jax_sample_counts(data):
    """[3, 4, 6, 256] counts from JAX's own intermediates of fpl_choose_device."""
    h, w, d = data.shape
    rows, cols = fpl_impl.slice_shape(h, w, d)
    words = jnp.asarray(data.reshape(-1).view(np.uint32))
    img = J.float_transform_dev(words).reshape(rows, cols)[::F.sample_stride(rows * cols)]
    out = np.zeros((3, 4, 6, 256), np.int64)
    for p in range(3):
        t = J.apply_predictor_dev(img, p).reshape(-1)
        for b in range(4):
            cur = (t >> (8 * b)) & 0xFF
            for k in range(6):
                if k:
                    cur = J._byte_deriv1(cur, k)
                out[p, b, k] = np.bincount(np.asarray(cur[::7]), minlength=256)
    return out


@pytest.mark.parametrize("kind", ["smooth", "rows", "noise"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_sampled_histograms_and_choice_match_jax(shape, kind):
    data = band(*shape, kind)
    hist = F.fpl_sample_histograms(torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(hist, jax_sample_counts(data))
    pred, levels, ests = F.fpl_choose(hist)
    jpred, jlevels = J.fpl_choose_device(jnp.asarray(data), *shape)
    assert (pred, levels) == (int(jpred), tuple(np.asarray(jlevels).tolist())), ests


def test_sampled_choice_at_row_stride_3():
    data = band(1300, 1250, 1, "smooth", seed=3)
    assert F.sample_stride(1300 * 1250) == 3
    hist = F.fpl_sample_histograms(torch.from_numpy(data)).numpy()
    assert hist[0, 0, 0].sum() == -(-(-(-1300 // 3) * 1250) // 7)
    np.testing.assert_array_equal(hist, jax_sample_counts(data))
    pred, levels, ests = F.fpl_choose(hist)
    jpred, jlevels = J.fpl_choose_device(jnp.asarray(data), 1300, 1250, 1)
    assert (pred, levels) == (int(jpred), tuple(np.asarray(jlevels).tolist())), ests


def test_choice_leaves_out_levels_above_the_predictors_cap():
    """Predictor 2 may go to level 3 only: its levels 4 and 5, fewer
    symbols still, are left out; predictors 0 and 1 spread over 128
    symbols at every level. The estimates equal JAX's _entropy_bits."""
    hist = np.zeros((3, 4, 6, 256), np.int64)
    hist[:2, ..., :128] = 7
    for k in range(6):
        hist[2, :, k, :2 ** (6 - k)] = 3 + k
    pred, levels, ests = F.fpl_choose(hist)
    assert pred == 2 and levels == (3, 3, 3, 3)
    es = F.entropy_estimates(hist)
    for p, b, k in ((0, 0, 0), (1, 3, 5), (2, 1, 3), (2, 2, 5)):
        assert es[p, b, k] == np.float32(J._entropy_bits(jnp.asarray(hist[p, b, k].astype(
            np.uint32))))
    assert ests[2] == np.float32(np.float32(np.float32(es[2, 0, 3] + es[2, 1, 3]) + es[2, 2, 3])
                                 + es[2, 3, 3])


@pytest.mark.parametrize("pred", [0, 1, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_finalize_and_packbits_sizes_match_jax(shape, pred):
    data = band(*shape, "smooth" if pred != 1 else "rows", seed=pred)
    n = int(np.prod(shape))
    for levels in LEVELS:
        planes, histos = F.fpl_finalize(torch.from_numpy(data), pred, levels)
        assert planes.shape == (4, F.padded(n)) and not planes[:, n:].any()
        sizes = F.fpl_packbits_size(planes, n).numpy()
        jh, jp, jpb = J.fpl_finalize_device(jnp.asarray(data), jnp.asarray(np.array(levels)),
                                            *shape, pred)
        np.testing.assert_array_equal(planes[:, :n].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(histos.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(sizes, np.asarray(jpb))


@pytest.mark.parametrize("pred", [0, 1, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_restore_matches_jax_and_the_input(shape, pred):
    data = band(*shape, "smooth" if pred != 1 else "rows", seed=pred + 3)
    for levels in LEVELS:
        planes, _ = F.fpl_finalize(torch.from_numpy(data), pred, levels)
        got = F.fpl_restore(planes, *shape, pred, levels).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), data.view(np.uint32))
        if shape in ((48, 41, 1), (13, 11, 3), (1, 5, 1)):
            want = J.fpl_restore_device(jnp.asarray(planes[:, :int(np.prod(shape))].numpy()),
                                        *shape, pred, levels)
            np.testing.assert_array_equal(np.asarray(want).view(np.uint32), got.view(np.uint32))


def test_finalize_past_a_tile_odd_n_matches_jax():
    """F2 at n = 2,049 with three columns (one past the card kernel's
    2,048-position tile; an odd n, so the planes' zero tail is 63 bytes),
    predictor 2: planes, their zero tail and histograms against JAX."""
    shape, pred, levels = (683, 1, 3), 2, (5, 3, 1, 0)
    data = band(*shape, "rows", seed=11)
    n = int(np.prod(shape))
    planes, histos = F.fpl_finalize(torch.from_numpy(data), pred, levels)
    assert planes.shape == (4, F.padded(n)) and F.padded(n) - n == 63
    assert not planes[:, n:].any()
    jh, jp, _jpb = J.fpl_finalize_device(jnp.asarray(data), jnp.asarray(np.array(levels)),
                                         *shape, pred)
    np.testing.assert_array_equal(planes[:, :n].numpy(), np.asarray(jp))
    np.testing.assert_array_equal(histos.numpy(), np.asarray(jh))


TILE_EDGE_SHAPES = [(1, 5000, 1), (3, 4500, 1), (37, 121, 3)]  # n: 5000, 13500, 13431


@pytest.mark.parametrize("pred", [0, 1, 2])
@pytest.mark.parametrize("shape", TILE_EDGE_SHAPES,
                         ids=["x".join(map(str, s)) for s in TILE_EDGE_SHAPES])
def test_restore_tile_edges_match_jax(shape, pred):
    """F3 on random planes where the card's kernel carries between its
    4,096-position tiles: n no multiple of the tile, a single row and rows
    longer than a tile (the row scan's carry), D > 1 slice geometry. Equal
    to ``fpl_restore_device`` bit for bit; the planes unchanged."""
    n = int(np.prod(shape))
    rng = np.random.default_rng(n + pred)
    planes = torch.from_numpy(rng.integers(0, 256, (4, n + 7), dtype=np.uint8))
    before = planes.clone()
    levels = (4, 5, 0, 2)
    got = F.fpl_restore(planes, *shape, pred, levels).numpy()
    want = J.fpl_restore_device(jnp.asarray(planes[:, :n].numpy()), *shape, pred, levels)
    np.testing.assert_array_equal(np.asarray(want).view(np.uint32), got.view(np.uint32))
    assert torch.equal(planes, before)


def test_tiny_bands_levels_above_their_length():
    """Levels above the value count leave every position as it is: the
    port's F1/F2 run on 2-4 values, where JAX's ``_byte_deriv1`` fails."""
    for shape in ((1, 2, 1), (1, 3, 1), (2, 2, 1), (1, 4, 1)):
        data = band(*shape, "noise")
        hist = F.fpl_sample_histograms(torch.from_numpy(data)).numpy()
        assert (hist.sum(-1) == 1).all()  # position 0 only
        with pytest.raises(TypeError):
            J.fpl_choose_device(jnp.asarray(data), *shape)
        for pred in (0, 1, 2):
            planes, _ = F.fpl_finalize(torch.from_numpy(data), pred, (5, 5, 5, 5))
            got = F.fpl_restore(planes, *shape, pred, (5, 5, 5, 5)).numpy()
            np.testing.assert_array_equal(got.view(np.uint32), data.view(np.uint32))


def _runs(lengths, seed=0):
    """A byte plane of runs of the given lengths, each value unlike its
    neighbours' (a length 1 run is a literal)."""
    vals = np.random.default_rng(seed).permutation(200)
    return np.concatenate([np.full(n, vals[i % 200] if i % 2 else vals[i % 200] + 50)
                           for i, n in enumerate(lengths)]).astype(np.uint8)


PB_PLANES = {
    "runs-1-2-128-129-130-258-259": [1, 2, 128, 129, 130, 258, 259, 1, 1, 2],
    "literals-300": [1] * 300 + [5] + [1] * 129,
    "literals-after-long-runs": [130, 1, 1, 259, 1, 388, 1] + [1] * 200,
    "mixed": [3, 1, 1, 1, 129, 1, 2, 2, 1, 131, 1, 1, 127, 128],
}


@pytest.mark.parametrize("name", sorted(PB_PLANES))
def test_packbits_size_matches_jax_formula(name):
    plane = _runs(PB_PLANES[name])
    n = plane.size
    planes = torch.zeros(4, F.padded(n), dtype=torch.uint8)
    for b in range(4):
        planes[b, :n] = torch.from_numpy(np.roll(plane, 17 * b))
    got = F.fpl_packbits_size(planes, n).numpy()
    for b in range(4):
        assert got[b] == int(J.packbits_size_device(jnp.asarray(np.roll(plane, 17 * b).astype(
            np.uint32))))
    # JAX's formula is an estimate of the true size; they differ on long literal stretches
    true = len(fpl_impl.encode_packbits(plane))
    assert abs(int(got[0]) - true) <= n // 128 + 2


def edge_runs(T, seed=0):
    """[(label, u8 plane)] of F2b's edge cases at a tile of T bytes: a
    constant plane (one run), an alternating one (n runs of 1), runs of 129,
    130, 258 and 259 starting at T - L - 1 .. T + 1, literals chained across
    an edge, runs over several tiles with no start, n 1-5 and T - 1, T,
    T + 1, drawn runs over five tiles, noise. Neighbouring runs differ."""
    rng = np.random.default_rng(seed)

    def runs(lengths):
        steps = rng.integers(1, 256, len(lengths))
        return np.repeat((np.cumsum(steps) % 256).astype(np.uint8), lengths)

    out = [("constant", np.full(3 * T + 5, 7, np.uint8)),
           ("alternating", (np.arange(2 * T + 3) % 2).astype(np.uint8))]
    for L in (129, 130, 258, 259):
        for s in (-L - 1, -L, -L + 1, -1, 0, 1):
            out.append((f"runs of {L} from T{s:+d}",
                        runs([max(1, T + s), L, L, 1, L, 1, 1, 1, max(1, 2 * T - 7), L])))
    out += [("literals across an edge", runs([max(1, T - 5)] + [1] * 20 + [129, 1, 1] + [1] * 300)),
            ("literals after long runs across an edge",
             runs([max(1, T - 150)] + [1] * 300 + [130, 1, 259, 1] + [1] * 200 + [258, 2])),
            ("runs over several tiles", runs([5, 3 * T + 7, 1, 1, 2 * T, 1, 129, T, 1]))]
    for n in sorted({1, 2, 3, 4, 5, max(1, T - 1), T, T + 1}):
        out.append((f"n {n}", runs(rng.choice([1, 1, 2, 129, 130], size=n))[:n]))
        out.append((f"n {n} constant", np.full(n, 3, np.uint8)))
    lengths = rng.choice([1, 1, 1, 2, 3, 128, 129, 130, 131, 258, 259, 260, max(1, T - 1), T,
                          T + 1], size=200)
    out.append(("drawn runs", runs(lengths)[:5 * T + 11]))
    out.append(("noise", rng.integers(0, 256, 5 * T + 77, dtype=np.uint8)))
    return out


F2B_TILE = 16384  # the kernel's tile of bytes a plane (kernels/fpl.cu PB_TILE)
EDGE_PLANES = edge_runs(F2B_TILE)


_jax_packbits_size = jax.jit(J.packbits_size_device)  # one compile per length


def jax_packbits_size(plane):
    return int(_jax_packbits_size(jnp.asarray(plane.astype(np.uint32))))


@pytest.mark.parametrize("n_pl", [4, 8])
@pytest.mark.parametrize("case", range(len(EDGE_PLANES)), ids=[c[0] for c in EDGE_PLANES])
def test_packbits_size_edge_planes_match_jax(case, n_pl):
    """F2b's plain version on the edge planes at the kernel's tile, at 4 and
    8 planes (plane b the case rolled by 17 b), against JAX plane by plane."""
    plane = EDGE_PLANES[case][1]
    n = plane.size
    rolled = [np.roll(plane, 17 * b) for b in range(n_pl)]
    planes = torch.zeros(n_pl, F.padded(n), dtype=torch.uint8)
    planes[:, :n] = torch.from_numpy(np.stack(rolled))
    got = F.fpl_packbits_size(planes, n).numpy()
    assert got.tolist() == [jax_packbits_size(p) for p in rolled]


TILE_SIZES = [1, 2, 3, 16, 64]


@pytest.mark.parametrize("tile", TILE_SIZES)
@pytest.mark.parametrize("name", sorted(PB_PLANES))
def test_packbits_size_tiled_ref_matches_jax(name, tile):
    """The kernel's algebra (per-tile summaries, then the join) at small
    tiles, so that every boundary case of the join runs."""
    plane = _runs(PB_PLANES[name])
    n = plane.size
    planes = torch.from_numpy(np.stack([np.roll(plane, 17 * b) for b in range(4)]))
    got = F.packbits_size_tiled_ref(planes, n, tile).numpy()
    assert got.tolist() == [jax_packbits_size(np.roll(plane, 17 * b)) for b in range(4)]


@pytest.mark.parametrize("tile", TILE_SIZES)
def test_packbits_size_tiled_ref_edge_planes_match_plain(tile):
    """The same on the edge planes generated at this tile and at 64, against
    the plain version (held to JAX above)."""
    for T in sorted({tile, 64}):
        for label, plane in edge_runs(T, seed=T):
            planes = torch.from_numpy(plane[None])
            assert torch.equal(F.packbits_size_tiled_ref(planes, plane.size, tile),
                               F.fpl_packbits_size_ref(planes, plane.size)), (label, T)


RUN_LENGTHS = st.one_of(st.integers(1, 5), st.sampled_from([127, 128, 129, 130, 131, 257, 258,
                                                            259, 260]), st.integers(1, 300))


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 3), RUN_LENGTHS), min_size=1, max_size=24))
def test_packbits_size_tiled_ref_matches_jax_on_drawn_runs(runs):
    """Drawn run lists (values 0-3, so neighbouring runs sometimes merge)
    at every tile size, against JAX and the plain version."""
    plane = np.concatenate([np.full(n, v, np.uint8) for v, n in runs])
    want = jax_packbits_size(plane)
    planes = torch.from_numpy(plane[None])
    assert int(F.fpl_packbits_size_ref(planes, plane.size)[0]) == want
    for tile in TILE_SIZES:
        assert int(F.packbits_size_tiled_ref(planes, plane.size, tile)[0]) == want, tile


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 255), st.integers(1, 300)), min_size=1, max_size=40))
def test_packbits_codec_matches_jax_and_round_trips(runs):
    plane = np.concatenate([np.full(n, v, np.uint8) for v, n in runs])
    enc = fpl_impl.encode_packbits(plane)
    assert enc == jax_fpl.encode_packbits(plane)
    np.testing.assert_array_equal(fpl_impl.decode_packbits(memoryview(enc), plane.size), plane)


def test_packbits_decode_refusals_match_jax():
    enc = fpl_impl.encode_packbits(_runs([5, 1, 1, 200, 3]))
    for buf, n in ((enc[:-1], 210), (enc, 209), (enc, 211), (bytes([200]), 100),
                   (bytes([10, 1, 2]), 11)):
        with pytest.raises(ValueError):
            fpl_impl.decode_packbits(memoryview(buf), n)
        with pytest.raises(ValueError):
            jax_fpl.decode_packbits(memoryview(buf), n)


def test_huffman_planes_through_h2_match_jax():
    data = band(48, 41, 1, "smooth")
    n = data.size
    pred, levels, _ = F.fpl_choose(F.fpl_sample_histograms(torch.from_numpy(data)).numpy())
    planes, histos = F.fpl_finalize(torch.from_numpy(data), pred, levels)
    tables, lens_codes = {}, np.zeros((4, 256, 5), np.float32)
    for b in range(4):
        lengths = huffman.compute_code_lengths(histos[b].numpy().astype(np.int64))
        if lengths is None:
            continue
        codes = huffman.canonical_codes(lengths)
        tables[b] = (lengths, codes, int((histos[b].numpy() * lengths).sum()))
        lens_codes[b, :, 0] = lengths
        for i in range(4):
            lens_codes[b, :, 1 + i] = (codes >> (8 * i)) & 0xFF
    assert len(tables) >= 2
    jl = jax_huff.compute_code_lengths(histos[0].numpy().astype(np.int64))
    np.testing.assert_array_equal(tables[0][0], jl)
    packed = F.fpl_pack_planes(planes, n, tables)
    pwh = next(p for p in (18, 34, 66) if p >= (jax_dh.GROUP * 32 + 31) // 32 + 1)
    streams, tbs, sbits = J.fpl_pack_planes_device(jnp.asarray(planes[:, :n].numpy()),
                                                   jnp.asarray(lens_codes), 1 << 14, pwh)
    for b, (words, sb) in packed.items():
        nbytes = 4 * words.numel()
        assert int(tbs[b]) == tables[b][2]
        assert words.numpy().tobytes() == np.asarray(streams[b]).tobytes()[:nbytes]
        np.testing.assert_array_equal(sb.numpy(), np.asarray(sbits[b]))
