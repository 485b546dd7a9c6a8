"""The float32 K1 (``encode_blocks``, ``encode_blocks_masked``) and the
float64 K1 (``encode_blocks_f64``, ``_masked_f64``, the mosaic's
``encode_tiles_f64``): the strip kernels of kernels/encode.cu and their
plain versions ``encode_blocks_ref`` / ``encode_blocks_f64_ref``.

The kernels own strips of ``strip_shape(8, D, size)`` blocks (S: 32 float32
blocks at depth 1, 10 at depth 3; 16 float64 blocks at depth 1, 5 at depth
3). The first tests hold the plain K1s, through ``encode_tiles`` /
``encode_tiles_f64`` and the plain K2s, byte for byte to JAX's
``encode_tiles`` / ``encode_tiles_f64`` (streams, totals, starts, ranges,
fits) at the strips' edges where JAX's encode takes them: widths 8(S-1),
8S, 8S+8, 8(2S+1), 8S+3 (edge blocks) and one block column, at depths 1 and
3, all-valid and under a crop of the bench mask, on DEM rows with
const-0, const-offset and full-range (raw) blocks; and a tile whose blocks
mix -0.0 and +0.0 minima. JAX's float64 tie fault
(``test_jax_f64_tie_quant_fault``) needs quanta near half-steps, which
these bands do not have: every float64 case is byte-equal. The last two
tests share one run of both kernels' CUDA sources on the CPU
(tools/cuda_standin): against the plain versions on chip_smoke's
strip_k1f32_cases / strip_k1f64_cases at depths 1, 3 and a chunked depth
(float32 33, float64 17), with float64 tile stacks (per-tile ranges),
every image and validity word ending at a page with no access; and, where
no plain version reads alike (NaN, infinities, zeros of both signs),
against the same source with every record's quanta counted (the settled
maximum off).
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lerc_tpu.constants import DataType as JDT
from lerc_tpu.ops import device_encode as jenc
from lerc_tpu.ops import device_f64 as JF
from lerc_tpu_torch.constants import DataType
from lerc_tpu_torch.ops import device_decode as dec
from lerc_tpu_torch.ops import device_encode as enc

MZE = 0.001


def _edge_cases(size, d1_widths, d3_widths):
    """(h, w, d, mask kind): the strips' edge widths (by index: 8(S-1), 8S,
    8S+8, 8(2S+1), 8S+3, one block column) picked for each depth, the mask
    kinds in turn."""
    out = []
    for d, pick in ((1, d1_widths), (3, d3_widths)):
        s = dec.strip_shape(8, d, size)[0]
        shapes = [(8, 8 * (s - 1)), (8, 8 * s), (16, 8 * s + 8), (8, 8 * (2 * s + 1)),
                  (13, 8 * s + 3), (40, 8)]
        for i in pick:
            h, w = shapes[i]
            out.append((h, w, d, ("all-valid", "bench")[(i + d) % 2]))
    return out


def _band(npdt, h, w, d, seed):
    """DEM rows (a hill, a wave, noise; each slice shifted) with strip_tile's
    block kinds in turn: a const-0 block, a const-offset one and a
    full-range one (3e6 / -1: raw)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 6, w)[None, :, None]
    y = np.linspace(0, 4, h)[:, None, None]
    z = 900 * np.exp(-((x - 3) ** 2 + (y - 2) ** 2) / 9) + 40 * np.sin(x + y) + 3.0 * np.arange(d)
    z = z + 0.3 * rng.standard_normal((h, w, d))
    nbh = -(-w // 8)
    for b in range(-(-h // 8) * nbh):
        r, c = divmod(b, nbh)
        blk = (slice(8 * r, 8 * r + 8), slice(8 * c, 8 * c + 8))
        if b % 5 == 1:
            z[blk] = 0
        elif b % 5 == 2:
            z[blk] = 7
        elif b % 5 == 3:
            z[blk] = np.where(rng.random(z[blk].shape) < 0.5, 3.0e6, -1.0)
    return np.ascontiguousarray(z.astype(npdt))


def _mask(kind, h, w):
    m = chip_smoke.bench_masks(kind, h, w)
    return np.ones((h, w), bool) if m is None else m


def _cap(data):
    return -(-(data.size * data.itemsize + data.size // 4 + 4096) // 1024) * 1024


F32_CASES = _edge_cases(4, (0, 1, 2, 3, 4, 5), (1, 3, 5))
F64_CASES = _edge_cases(8, (0, 3, 4, 5), (1, 2))


@pytest.mark.parametrize("h,w,d,kind", F32_CASES, ids=[f"{c[0]}x{c[1]}x{c[2]}-{c[3]}"
                                                        for c in F32_CASES])
def test_plain_float32_k1_matches_jax_at_strip_edges(h, w, d, kind):
    data = _band(np.float32, h, w, d, h * 1000 + w + d)
    _float32_matches_jax(data, _mask(kind, h, w))


def _float32_matches_jax(data, mask):
    h, w, d = data.shape
    cap = _cap(data)
    all_valid = bool(mask.all())
    js, jtotal, jzmin, jzmax, jstarts, jfits = (np.asarray(a) for a in jenc.encode_tiles(
        jnp.asarray(data), jnp.asarray(mask), jnp.float32(MZE), h, w, d, JDT.FLOAT, all_valid,
        6, cap, out_u32=True))
    valid = None if all_valid else enc.block_valid_words(torch.from_numpy(mask))
    ts, ttotal, tzmin, tzmax, tstarts, tfits = enc.encode_tiles(
        torch.from_numpy(data), valid, MZE, h, w, d, DataType.FLOAT, all_valid, 6, cap)
    assert (int(ttotal), bool(tfits)) == (int(jtotal), bool(jfits)) and bool(jfits)
    np.testing.assert_array_equal(tstarts.numpy(), jstarts)
    np.testing.assert_array_equal(tzmin.numpy(), jzmin)
    np.testing.assert_array_equal(tzmax.numpy(), jzmax)
    assert ts.numpy().tobytes()[:int(jtotal)] == js.tobytes()[:int(jtotal)]


@pytest.mark.parametrize("h,w,d,kind", F64_CASES, ids=[f"{c[0]}x{c[1]}x{c[2]}-{c[3]}"
                                                        for c in F64_CASES])
def test_plain_float64_k1_matches_jax_at_strip_edges(h, w, d, kind):
    data = _band(np.float64, h, w, d, h * 1000 + w + d)
    _float64_matches_jax(data, _mask(kind, h, w))


def _float64_matches_jax(data, mask):
    h, w, d = data.shape
    cap = _cap(data)
    all_valid = bool(mask.all())
    hi, lo, bits = JF.split_f64_host(data)
    mh = np.float32(MZE)
    ml = np.float32(np.float64(MZE) - np.float64(mh))
    jstream, jtotal, jstarts = JF.encode_tiles_f64(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(bits), jnp.asarray(mask), jnp.float32(mh),
        jnp.float32(ml), h, w, d, all_valid, 6, cap)
    valid = None if all_valid else enc.block_valid_words(torch.from_numpy(mask))
    stream, total, zmin, zmax, starts = enc.encode_tiles_f64(
        torch.from_numpy(data), valid, MZE, h, w, d, all_valid, 6, cap)
    assert int(total) == int(jtotal)
    assert stream.view(torch.uint8)[:int(total)].numpy().tobytes() == \
        np.asarray(jstream)[:int(jtotal)].tobytes()
    np.testing.assert_array_equal(starts.numpy(), np.asarray(jstarts))
    sel = data[mask]
    np.testing.assert_array_equal(zmin.numpy(), sel.min(0))
    np.testing.assert_array_equal(zmax.numpy(), sel.max(0))


def test_plain_k1_signed_zero_minima_match_jax():
    """Blocks whose minimum is a zero of either sign, and both in one
    block in either order: the plain float32 K1's stream (the offset is a
    byte, 0 for either zero) and the plain float64 K1's (the offset is the
    8-byte value of the block's first minimum, its sign included) equal
    JAX's; the float64 offset is the first zero's bits."""
    z32 = chip_smoke.signed_zero_tile(np.float32)
    _float32_matches_jax(z32, np.ones((16, 80), bool))
    info32 = enc.encode_blocks_ref(torch.from_numpy(z32), enc.encode_params(MZE, 6))[0]
    assert {1, 2} <= set(((info32[:, 1] >> 8) & 3).tolist())  # stuffed over a zero min, const-0
    data = chip_smoke.signed_zero_tile(np.float64)
    _float64_matches_jax(data, np.ones((16, 80), bool))
    rec_info, _z = enc.encode_blocks_f64(torch.from_numpy(data), enc.encode_params_f64(MZE, 6))
    info = rec_info.numpy().astype(np.int64)
    for b, first in ((0, (0, 0)), (1, (0, 3)), (2, (0, 0)), (3, (0, 0))):
        bits = (int(info[b, 2]) & 0xFFFFFFFF) | ((int(info[b, 3]) & 0xFFFFFFFF) << 32)
        r, c = first
        assert bits == int(data[r:r + 1, 8 * b + c, 0].view(np.uint64)[0])
    assert info[0, 2] == 0 and info[1, 3] == -2**31  # +0.0 first, then -0.0 first


STANDIN_RUN = r"""
import ctypes, mmap, sys
from pathlib import Path
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/tools/cuda_standin")
import standin
import chip_smoke
from lerc_tpu_torch.kernels import build
from lerc_tpu_torch.ops import device_encode as enc

# encode.cu, and a copy with every record's quanta counted and every float64
# offset found by its scan (settled_q off), built at once
src, out = Path(sys.argv[2]), Path(sys.argv[3])
text = (standin.KERNELS / "encode.cu").read_text()
counted = text
for old, new in (("const bool settled = settled_q(zmin, zmax, P, q_set);",
                  "const bool settled = false;"),
                 ("const bool scan = LPR > 1 && !(zmin != (T)0 && z_finite(zmin));",
                  "const bool scan = LPR > 1;")):
    assert counted.count(old) == 1, old
    counted = counted.replace(old, new)
src.mkdir(parents=True, exist_ok=True)
for h in standin.KERNELS.glob("*.cuh"):
    (src / h.name).write_text(h.read_text())
(src / "encode.cu").write_text(text)
(src / "encode_counted.cu").write_text(counted)
paths = standin.build(["encode", "encode_counted"], src_dir=src, out=out, opt="-O0")
standin.install({"encode": paths["encode"]}, ["encode_blocks", "encode_blocks_f64"])
libs = {"settled": build._libs["encode"], "counted": ctypes.CDLL(str(paths["encode_counted"]))}

# ---- the kernels against their plain versions, every input at a guard page
page = mmap.PAGESIZE
libc = ctypes.CDLL(None, use_errno=True)
libc.mprotect.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
keep = []


def paged(t):
    # a copy of t whose last byte ends where a page with no access begins
    if t is None:
        return None
    nbytes = t.numel() * t.element_size()
    pages = -(-nbytes // page)
    buf = mmap.mmap(-1, (pages + 1) * page)
    base = ctypes.addressof(ctypes.c_char.from_buffer(buf))
    assert libc.mprotect(base + pages * page, page, 0) == 0
    keep.append(buf)
    arr = np.frombuffer(buf, np.uint8, count=pages * page)[pages * page - nbytes:]
    out = torch.from_numpy(arr).view(t.dtype).reshape(t.shape)
    out.copy_(t)
    return out


check = chip_smoke.k1float_check


def paged_check(x, valid, p, tile_rec, tag):
    fits = check(paged(x), paged(valid), p, tile_rec, tag)
    print("ok", tag, flush=True)
    return fits


chip_smoke.k1float_check = paged_check
n32 = chip_smoke.strip_k1f32_cases(torch.device("cpu"), depths=(1, 3))
n64 = chip_smoke.strip_k1f64_cases(torch.device("cpu"), depths=(1, 3))
print("cases", n32, n64, "launches", *(build.LAUNCHES[k] for k in (
    "encode_blocks", "encode_blocks_masked", "encode_blocks_f64", "encode_blocks_masked_f64",
    "encode_tiles_f64")), flush=True)


# ---- the settled maximum against every record counted
def quirk_tile(npdt):
    # 16 x 96 x 1: DEM values; blocks all NaN, rows 0-3 NaN, +inf and -inf,
    # all +inf, one NaN beside equal values, zero minima of both signs
    # (+0.0 first, -0.0 first, all -0.0), equal values
    z = chip_smoke.dem_patch(16, 96, np.float64, seed=9)[:, :, 0]
    for b in range(24):
        blk = z[8 * (b // 12):8 * (b // 12) + 8, 8 * (b % 12):8 * (b % 12) + 8]
        k = b % 12
        if k == 0:
            blk[:] = np.nan
        elif k == 1:
            blk[:4] = np.nan
        elif k == 2:
            blk[2, 3], blk[6, 6] = np.inf, -np.inf
        elif k == 3:
            blk[:] = np.inf
        elif k == 4:
            blk[:] = 5.5
            blk[3, 3] = np.nan
        elif k == 5:
            blk[:] = np.abs(blk) + 1
            blk[0, 0], blk[4, 5] = 0.0, -0.0
        elif k == 6:
            blk[:] = np.abs(blk) + 1
            blk[1, 2], blk[7, 1] = -0.0, 0.0
        elif k == 7:
            blk[:] = -0.0
        elif k == 8:
            blk[:] = -1234.5
    return np.ascontiguousarray(z[:, :, None].astype(npdt))


rng = np.random.default_rng(214)
n = 0
for npdt in (np.float32, np.float64):
    tiles = [quirk_tile(npdt)] + [chip_smoke.settle_tile(npdt, m, rng) for m in (0.001, 0.5)]
    mzes = (0.001, 0.5, 0.0) if npdt == np.float32 else (0.001, 0.5)
    for data in tiles:
        h, w, _ = data.shape
        x = torch.from_numpy(data)
        for kind in ("all-valid", "bench"):
            m = chip_smoke.bench_masks(kind, h, w)
            valid = None if m is None else enc.block_valid_words(torch.from_numpy(m))
            for mze in mzes:
                got = {}
                for name, lib in libs.items():
                    build._libs["encode"] = lib
                    if npdt == np.float64:
                        got[name] = enc.encode_blocks_f64(x, enc.encode_params_f64(mze, 6), valid)
                    else:
                        got[name] = enc.encode_blocks(x, enc.encode_params(mze, 6), valid)
                same = all(torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                                       b.view(torch.int32) if b.dtype == torch.float32 else b)
                           for a, b in zip(got["settled"], got["counted"]))
                print("settled" if same else "differs", npdt.__name__, h, w, kind, mze,
                      flush=True)
                n += 1
print("settle cases", n)
"""


@pytest.fixture(scope="module")
def standin_run(tmp_path_factory):
    """One stand-in run of STANDIN_RUN for the tests below (a subprocess of
    its own, so a stray read at a guard page fails it)."""
    root = str(Path(__file__).resolve().parents[1])
    tmp = tmp_path_factory.mktemp("k1float")
    r = subprocess.run([sys.executable, "-c", STANDIN_RUN, root, str(tmp / "src"),
                        str(tmp / "out")], capture_output=True, text=True, timeout=600, cwd=root)
    return r


def test_standin_k1float_stays_inside_its_buffers(standin_run):
    """Both float K1s' CUDA source, built for the CPU stand-in, bit-equal to
    their plain versions (rec_info, zrange and float32's fits) on
    chip_smoke.strip_k1f32_cases and strip_k1f64_cases at depths 1, 3 and
    the chunked depth (float32 33, float64 17): the strips' edge widths and
    edge blocks, all-valid, empty, full and bench masks, const, stuffed and
    raw blocks, maxZError 0.001 and 1e-6, float32 also maxZError 0 and
    nb_cap 16 (fits drops), float64 tile stacks (per-tile ranges), DEM
    patches, quantized ranges beside powers of two (settle_tile) and
    float64 zero minima of both signs. Every image and validity word ends at
    a page with no access."""
    r = standin_run
    assert r.returncode == 0, (r.returncode, r.stdout[-2000:], r.stderr[-4000:])
    last = next(x for x in r.stdout.splitlines() if x.startswith("cases ")).split()
    n32, n64 = int(last[1]), int(last[2])
    launches = [int(x) for x in last[4:]]
    assert r.stdout.count("ok ") == n32 + n64 == sum(launches) and all(launches), r.stdout[-2000:]
    for tag in ("x33 all-valid", "x33 bench", "x17 bench", "raw", "maxZError 0", "nb_cap 16",
                "stack 3 x", "DEM patch bench", "float32 settle bench maxZError 0.5",
                "float64 settle all-valid maxZError 0.001", "float64 signed zero minima"):
        assert tag in r.stdout, tag


def test_standin_k1float_settled_max_equals_every_record_counted(standin_run):
    """Both float K1s' CUDA source, built for the CPU stand-in, bit-equal
    (rec_info, zrange, float32's fits) to the same source with every
    record's quanta counted and every float64 offset found by its scan
    (settled_q off), on the cases no plain version reads alike: blocks all
    NaN, part NaN, holding +-inf or all +inf, a NaN beside equal values,
    zero minima of both signs, equal values; and on chip_smoke.settle_tile
    (quantized ranges at, beside and half a step from powers of two); at
    maxZError 0.001, 0.5 and (float32) 0, all-valid and under the bench
    mask."""
    r = standin_run
    assert r.returncode == 0, (r.returncode, r.stdout[-2000:], r.stderr[-4000:])
    lines = r.stdout.strip().splitlines()
    assert lines[-1] == "settle cases 30", r.stdout[-2000:]
    assert sum(x.startswith("settled ") for x in lines) == 30, r.stdout[-2000:]
