"""The float32 K4 (``decode_records``, ``decode_records_masked``: the strip
kernel of kernels/decode.cu) and its plain version ``decode_records_ref``.

The kernel owns strips of ``strip_blocks(8, D, 4)`` blocks (S), stages the
records' bytes of a strip (8 KB at most) and reads past the stage from the
stream. The first test holds the plain K4, as the resident codec calls it
(``decode_tiles_fast``), bit for bit and flags included to JAX's
``decode_tiles_fast`` at the strips' edges: widths 8(S-1), 8S, 8S+8 and
8(2S+1) at depths 1 and 3, all-valid and under a crop of the bench mask,
and an all-raw strip of 32 x 257 B that passes the stage. The next two
hold the port to the host decoder on float32 depth-diff records (flag bit
2 at v6): the plain K4 clears index_ok for them (JAX's decode_tiles_fast
does not, and its image differs from the host decoder's: a JAX fault kept
beside the port's flags), and the resident codecs refuse the blob. The
last runs the kernel's CUDA source on the CPU (tools/cuda_standin)
against the plain version on chip_smoke's float32 strip cases at depths 1,
3 and 33 (a block past the output stage, its depths in chunks), all-valid
and masked, with strip_k4_hostile's indexes; the stream, the starts and the
validity words end at a page with no access.
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
from lerc_tpu.ops import device_decode as jdec
from lerc_tpu.ops.device_softf64 import decompose_scalar
from lerc_tpu_torch import FusedResidentCodec, encode_band_device
from lerc_tpu_torch.codec import lerc2_decode
from lerc_tpu_torch.codec.resident import ResidentBlob
from lerc_tpu_torch.constants import DataType
from lerc_tpu_torch.ops import device_decode as dec

from tests.test_torch_mosaic_decode import _blob_unit, _refix_checksum

MZE = 0.001
CPU = torch.device("cpu")


def _edge_cases():
    """(h, w, d, mask kind, raw): each width of the strips' edges once,
    the mask kinds in turn, and the all-raw strip."""
    out = []
    for d in (1, 3):
        s = dec.strip_blocks(8, d, 4)
        for i, (h, w) in enumerate(((8, 8 * (s - 1)), (8, 8 * s), (16, 8 * s + 8),
                                    (8, 8 * (2 * s + 1)))):
            out.append((h, w, d, ("all-valid", "bench")[(i + d) % 2], False))
    out.append((8, 8 * dec.strip_blocks(8, 1, 4), 1, "all-valid", True))
    return out


def _jax_decode(stream, starts, zmax, h, w, d, mask, mze):
    raw = stream.view(torch.uint8).numpy()
    js = np.zeros(-(-raw.size // 512) * 512, np.uint8)
    js[:raw.size] = raw
    limbs, bexp = decompose_scalar(2.0 * mze)
    img, ok, fits = jdec.decode_tiles_fast(
        jnp.asarray(js), jnp.asarray(starts.numpy()), jnp.float32(mze),
        jnp.asarray(zmax.numpy()), h, w, d, JDT.FLOAT, 6,
        mask=None if mask is None else jnp.asarray(mask), inv_limbs=limbs, inv_bexp=bexp)
    return np.asarray(img), bool(ok), bool(fits)


@pytest.mark.parametrize("h,w,d,kind,raw", _edge_cases(),
                         ids=[f"{c[0]}x{c[1]}x{c[2]}-{c[3]}{'-raw' if c[4] else ''}"
                              for c in _edge_cases()])
def test_plain_k4_matches_jax_at_strip_edges(h, w, d, kind, raw):
    rng = np.random.default_rng(h * 1000 + w + d)
    data = chip_smoke.strip_tile(np.float32, h, w, d, raw, rng)
    mask = chip_smoke.bench_masks(kind, h, w)
    stream, total, zmax, starts, valid = chip_smoke.strip_encode(data, mask, MZE, 6, CPU)
    if raw:  # every record raw, the strip's records past the 8 KB stage
        modes = stream.view(torch.uint8)[starts.long()] & 3
        assert bool((modes == 0).all()) and int(total) == 32 * 257
    img, ok, fits = dec.decode_tiles_fast(stream, starts, MZE, zmax, h, w, d, DataType.FLOAT, 6,
                                          mask=valid)
    jimg, jok, jfits = _jax_decode(stream, starts, zmax, h, w, d, mask, MZE)
    assert (bool(ok), bool(fits)) == (jok, jfits) == (True, True)
    np.testing.assert_array_equal(img.numpy().view(np.uint32), jimg.view(np.uint32))
    if raw:  # raw records carry the tile's bits as they are
        np.testing.assert_array_equal(img.numpy().view(np.uint32), data.view(np.uint32))


def _diff_blob(lut_block):
    """test_torch_mosaic_decode's float32 depth-2 band (its checksum
    refixed) with flag bit 2 set on every slice-1 record that is not raw;
    with `lut_block`, its LUT-sized block too (one LUT record)."""
    rng = np.random.default_rng(6)
    n = 48
    mask = rng.random((n, n)) > 0.3
    s0 = np.cumsum(rng.normal(0, 1, (n, n)), 1).astype(np.float32) * 10
    data = np.stack([s0, s0 + 0.25 * np.sin(np.arange(n))[None, :]], -1).astype(np.float32)
    data[8:16, 8:24, 1] = 5.0
    data[24:32, 0:8, :] = 0.0
    if lut_block:
        data[32:40, 16:24, 1] = np.where(np.arange(8) % 2, 1.0, 9.0)
    blob = bytearray(encode_band_device(data, mask, 0.01, device="cpu"))
    _stream, starts, _zmax, _valid, _head, pos = _blob_unit(bytes(blob))
    flipped = set()
    for r in range(1, len(starts), 2):
        flag = blob[pos + int(starts[r])]
        if flag & 3 != 0:
            blob[pos + int(starts[r])] = flag | 4
            flipped.add(flag & 3)
    assert flipped == {1, 2, 3}
    return _refix_checksum(blob), mask


@pytest.mark.parametrize("lut_block", [True, False], ids=["with-lut-record", "no-lut-record"])
def test_float_diff_record_flags_beside_jax(lut_block):
    """A float32 record with flag bit 2 at v6, through the resident form of
    both decoders. The port is held to the host decoder: the diff record
    needs the previous slice, which the indexed decode does not add, so the
    plain K4 clears index_ok (fits stays) at v6 and keeps it at v4, where
    bit 2 is no diff flag. JAX's decode_tiles_fast checks no diff bit: it
    clears index_ok only for the blob's one LUT record and returns the
    records read as absolute ones, an image the host decoder does not give
    (a JAX fault, recorded beside the port's flags). Both read the same
    records, so the images equal."""
    blob, mask = _diff_blob(lut_block)
    stream, starts, zmax, valid, hd, _pos = _blob_unit(blob)
    assert (hd.micro_block_size, hd.version, hd.n_depth) == (8, 6, 2)
    h, w, d, mze = hd.n_rows, hd.n_cols, hd.n_depth, hd.max_z_error
    img, ok, fits = dec.decode_tiles_fast(stream, starts, mze, zmax.reshape(d), h, w, d,
                                          DataType.FLOAT, 6, mask=valid)
    jimg, jok, jfits = _jax_decode(stream, starts, zmax.reshape(d), h, w, d, mask, mze)
    assert (bool(ok), bool(fits)) == (False, True)
    assert (jok, jfits) == (not lut_block, True)  # JAX's fault: the diff bit is not checked
    np.testing.assert_array_equal(img.numpy().view(np.uint32), jimg.view(np.uint32))
    host = np.asarray(lerc2_decode.decode_band(blob).data)
    sel = np.repeat(mask[:, :, None], d, 2)
    assert not np.array_equal(jimg[sel], host[sel])  # the absolute reading is wrong
    r = dec._parse_records(stream, starts, DataType.FLOAT, d, valid)
    assert int(r.is_lut.sum()) == int(lut_block)
    assert int(((r.flag & 4) != 0).sum()) > 0
    _img4, ok4, fits4 = dec.decode_tiles_fast(stream, starts, mze, zmax.reshape(d), h, w, d,
                                              DataType.FLOAT, 4, mask=valid)
    assert (bool(ok4), bool(fits4)) == (not lut_block, True)


def _fused_header(codec, blob, pos):
    """A standard blob's header as FusedResidentCodec.decode_fast takes it:
    the blob's bytes before the stream without the mask section's static
    even part."""
    h = codec._head_len
    small = blob[:h] + blob[h + len(codec._static_mid):pos]
    return torch.tensor(list(small), dtype=torch.uint8)


@pytest.mark.parametrize("diff", [True, False], ids=["diff-records", "control"])
def test_resident_decode_refuses_float_diff_records(diff):
    """The resident codecs on _diff_blob (float32 depth-diff records at
    v6, read with the record index): FusedResidentCodec.decode_fast returns
    ok False and ResidentCodec.decode raises, where the host decoder applies
    the diff. The control, the same band encoded with no diff bit set, is
    decoded ok and equal to the host decoder."""
    if diff:
        blob, mask = _diff_blob(False)
    else:
        rng = np.random.default_rng(6)
        mask = rng.random((48, 48)) > 0.3
        s0 = np.cumsum(rng.normal(0, 1, (48, 48)), 1).astype(np.float32) * 10
        blob = encode_band_device(np.stack([s0, s0 + 0.25], -1), mask, 0.01, device="cpu")
    stream, starts, _zmax, _valid, hd, pos = _blob_unit(blob)
    codec = FusedResidentCodec(hd.n_rows, hd.n_cols, hd.n_depth, np.float32, hd.max_z_error,
                               hd.version, mask=mask, device="cpu")
    img, ok = codec.decode_fast(_fused_header(codec, blob, pos), stream, starts)
    rblob = ResidentBlob(bytes(blob[:pos]), stream, len(blob) - pos, hd.checksum, hd, starts)
    host = np.asarray(lerc2_decode.decode_band(blob).data)
    sel = np.repeat(mask[:, :, None], hd.n_depth, 2)
    if diff:
        assert not bool(ok)
        with pytest.raises(ValueError, match="index inconsistent"):
            codec.decode(rblob)
    else:
        assert bool(ok)
        np.testing.assert_array_equal(img.numpy()[sel], host[sel])
        np.testing.assert_array_equal(codec.decode(rblob).numpy()[sel], host[sel])


STANDIN_RUN = r"""
import ctypes, mmap, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/tools/cuda_standin")
import standin
import chip_smoke
from lerc_tpu_torch.kernels import build

libs = standin.build(["decode"], out=standin.OUT / "k4f32", opt="-O0")
standin.install(libs, ["decode_records"])
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


case = chip_smoke.strip_k4_case


def paged_case(args, tag):
    a = list(args)
    a[0], a[1], a[10] = paged(a[0]), paged(a[1]), paged(a[10])
    case(tuple(a), tag)
    print("ok", tag, flush=True)


chip_smoke.strip_k4_case = paged_case
n = chip_smoke.strip_k4f32_cases(torch.device("cpu"), depths=(1, 3))
print("cases", n, "launches", build.LAUNCHES["decode_records"], build.LAUNCHES["decode_records_masked"])
"""


def test_standin_k4f32_stays_inside_its_buffers():
    """The float32 K4's CUDA source, built for the CPU stand-in, bit-equal to
    decode_records_ref (image and flags) on chip_smoke.strip_k4f32_cases at
    depths 1, 3 and 33: the strips' edge widths, all-valid, empty, full and
    bench masks, a raw strip past the stage, nb_cap 16 with lut_unfit, LUT
    records, and strip_k4_hostile's indexes (a truncated stream, starts
    shuffled within and across strips and past the end, a stream whose last
    record ends at its last byte). Every stream, starts and validity words
    end at a page with no access; a subprocess of its own, so a stray read
    fails the test."""
    root = str(Path(__file__).resolve().parents[1])
    r = subprocess.run([sys.executable, "-c", STANDIN_RUN, root], capture_output=True, text=True,
                       timeout=600, cwd=root)
    assert r.returncode == 0, (r.returncode, r.stdout[-2000:], r.stderr[-4000:])
    last = r.stdout.strip().splitlines()[-1].split()
    n, n_all, n_masked = int(last[1]), int(last[3]), int(last[4])
    assert r.stdout.count("ok ") == n == n_all + n_masked and n_masked > 0, r.stdout[-2000:]
    for tag in ("x33 all-valid", "x33 bench", "raw", "nb_cap 16, lut_unfit",
                "ending at the last byte", "starts past the end"):
        assert tag in r.stdout, tag
