"""Three faults of the port's CPU path, each held to the reference here:

P1: ``decode_band_device`` of uint16/uint32 constant and one-sweep blobs
    (torch's CPU uint16/uint32 have no index_put or masked_fill), equal to
    the host decoder ``lerc2_decode.decode_band``;
P2: the plain K2's LUT instance on blocks of 30 bits and more (a non-LUT
    record's LUT fields fell past its payload), blobs byte-equal to JAX
    ``encode_band_device``;
P3: a masked constant ``ResidentCodec`` image decodes its invalid pixels to
    0, as the host decoder reads the same wire bytes; JAX writes the
    constant there too (its output is recorded);
P6: ``encode_band_device`` of uint32 bands with values of 2^31 and more
    took the band's zMin/zMax from K1's int32 ranges (signed order), and K1
    took block minima in signed order (a block across 2^31, or holding
    values near 0 and near 2^32, quantized against the wrong offset). K1
    orders uint32 as unsigned now, blocks and ranges alike. JAX's blobs of
    the same bands decode wrong (recorded);
P7: K6's depth-diff chain clamped uint32 to zMax in signed order, so a
    host-encoded uint32 band across 2^31 (zMax of 2^31 or more, diff
    records on values below it) decoded to zMax there; the chain clamps in
    u32 order now, as the non-diff records do, equal to the host decoder;
P8: the device encoder (the integer K1 and its LUT instance, and their
    plain versions) wrote a block whose own range passes maxValToQuantize
    (32767 for 16-bit data) raw and still set its diff bit where the diff
    candidate was shorter: a raw diff record, which the host decoder (and
    the reference) refuses. A block forced raw takes no diff now, as the
    host encoder does; JAX's encode_tiles keeps the bit (recorded);
P9: F2b's kernel read up to a 16 KB tile past its planes where they lay off
    a 16-byte boundary (threads with no byte of the plane still loaded a
    chunk); run on the CPU stand-in of the CUDA runtime against planes that
    end at a page with no access.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lerc_tpu.codec import device_codec as jax_codec
from lerc_tpu.codec import lerc2_decode
from lerc_tpu_torch.codec import lerc2_decode as port_lerc2_decode
from lerc_tpu.codec.lerc2_encode import BandEncoder
from lerc_tpu.constants import DataType as JDT
from lerc_tpu.ops import device_encode as jenc
from lerc_tpu.codec.resident import ResidentCodec as JaxResident
from lerc_tpu_torch import ResidentCodec, decode_band_device, encode_band_device
from lerc_tpu_torch.codec.device_codec import band_sections
from lerc_tpu_torch.interop import codec_kwargs

from .test_torch_band import _bits, assert_decodes_like_the_host

P1_MASK = np.random.default_rng(11).random((24, 19)) > 0.3


def _p1_data(npdt, kind, d):
    if kind == "constant":
        return np.full((24, 19, d), 7, npdt)
    rng = np.random.default_rng(12)
    return rng.integers(0, np.iinfo(npdt).max, (24, 19, d), dtype=np.uint64,
                        endpoint=True).astype(npdt)


P1_CASES = [(npdt, kind, d, masked) for npdt in (np.uint16, np.uint32)
            for kind in ("constant", "one_sweep") for d in (1, 2) for masked in (False, True)]


@pytest.mark.parametrize("npdt,kind,d,masked", P1_CASES,
                         ids=[f"{np.dtype(c[0]).name}-{c[1]}-d{c[2]}{'-mask' if c[3] else ''}"
                              for c in P1_CASES])
def test_p1_unsigned_constant_and_one_sweep_decode(npdt, kind, d, masked):
    data = _p1_data(npdt, kind, d)
    mask = P1_MASK if masked else None
    blob = BandEncoder(data, mask, 0.5).encode()
    assert band_sections(blob).kind == kind
    port = assert_decodes_like_the_host(blob, jax_too=False)
    sel = np.ones((24, 19), bool) if mask is None else mask
    np.testing.assert_array_equal(port.data.numpy()[sel], data[sel])
    # the port's own encoder writes the same blob as JAX where no value passes
    # 2^31, and verify decodes it; past 2^31 JAX's header ranges are signed (P6)
    blob = encode_band_device(data, mask, 0.5, verify=True, device="cpu")
    jblob = jax_codec.encode_band_device(data, mask, 0.5)
    if int(data[sel].max()) < 2**31:
        assert blob == jblob
    else:
        assert blob != jblob and lerc2_decode.decode_band(jblob).hd.z_min < 0
        assert lerc2_decode.decode_band(blob).hd.z_min == float(data[sel].min())


def _p2_band(name):
    if name.startswith("f32"):
        h, w = {"f32-24x24": (24, 24), "f32-24x19": (24, 19), "f32-64x64": (64, 64)}[name]
        return np.random.default_rng(2).normal(0, 40, (h, w, 1)).astype(np.float32), 1e-7
    npdt = np.int32 if name == "i32-24x19" else np.uint32
    data = np.random.default_rng(3).integers(0, 2**30, (24, 19, 1)).astype(npdt)
    return data, 0.5


@pytest.mark.parametrize("name", ["f32-24x24", "f32-24x19", "f32-64x64", "i32-24x19",
                                  "u32-24x19"])
def test_p2_wide_blocks_through_the_plain_lut_k2(name):
    data, mze = _p2_band(name)
    jblob = jax_codec.encode_band_device(data, None, mze)
    assert encode_band_device(data, None, mze, device="cpu") == jblob
    port = assert_decodes_like_the_host(jblob, jax_too=False)
    if data.dtype != np.float32:  # lossless; at 1e-7 the float32 bands sit at their ulp
        np.testing.assert_array_equal(port.data.numpy(), data)


@pytest.mark.parametrize("npdt", [np.float32, np.int16, np.uint16])
def test_p3_masked_constant_resident_image(npdt):
    mask = np.random.default_rng(0).random((16, 16)) > 0.3
    data = np.full((16, 16, 1), 5, npdt)
    codec = ResidentCodec(**codec_kwargs(16, 16, 1, npdt, 0.5, 6, 0, mask), device="cpu")
    blob = codec.encode(torch.from_numpy(data))
    got = codec.decode(blob).numpy()
    host = lerc2_decode.decode_band(blob.to_bytes())
    np.testing.assert_array_equal(_bits(got), _bits(host.data))
    assert (got[mask] == 5).all() and (got[~mask] == 0).all()
    # JAX's ResidentCodec writes the constant at the invalid pixels too
    jcodec = JaxResident(16, 16, 1, npdt, 0.5, mask=mask)
    jgot = np.asarray(jcodec.decode(jcodec.encode(data)))
    assert (jgot[~mask] == 5).all() and (jgot[mask] == 5).all()


def _p6_band(base, rng):
    a = (base + rng.integers(0, 1000, (64, 64, 1))).astype(np.uint32)
    a[:, 20:] += 1000
    return a


def _host_error(blob, a):
    """Largest error of the port's and of JAX's host decoder on the blob (a
    string: the decoder refused it)."""
    errs = []
    for dec in (port_lerc2_decode, lerc2_decode):
        try:
            errs.append(int(np.abs(dec.decode_band(blob).data.astype(np.int64) - a).max()))
        except ValueError as e:
            errs.append(str(e))
    return errs


def _p6_cases():
    """(band, maxZError): the two bases at maxZError 0.5 and 2, each from a
    fresh rng; the same four from one shared rng (its fourth blob JAX's host
    decoder refuses: "corrupt LUT block"); the band across 2^31 at
    maxZError 4; and blocks of values near 0 and near 2^32 (signed -5..5,
    which K1 took as one narrow range) at maxZError 0.5 and 4."""
    grid = [(base, mze) for base in (3_000_000_001, 2**31 - 600) for mze in (0.5, 2.0)]
    cases = [(_p6_band(base, np.random.default_rng(0)), mze) for base, mze in grid]
    shared = np.random.default_rng(0)
    cases += [(_p6_band(base, shared), mze) for base, mze in grid]
    cases.append((_p6_band(2**31 - 600, np.random.default_rng(0)), 4.0))
    wrap = np.zeros((16, 16, 1), np.uint32)
    wrap[::2] = 5
    wrap[1::2, ::3] = 2**32 - 5
    return cases + [(wrap, 0.5), (wrap, 4.0)]


def test_p6_uint32_band_ranges_above_2_31():
    jax_faults = []
    for a, mze in _p6_cases():
        mask = np.ones(a.shape[:2], bool)
        bound = int(np.floor(mze)) if mze > 0.5 else 0
        blob = encode_band_device(a, mask, mze, 6, True, verify=True, device="cpu")
        port = port_lerc2_decode.decode_band(blob)
        assert port.hd.z_min == float(a.min()) and port.hd.z_max == float(a.max())
        np.testing.assert_array_equal(port.z_min_vec, [a.min()])
        # each block's offset and width read back as the same uint32 values
        errs = _host_error(blob, a)
        assert all(isinstance(e, int) and e <= bound for e in errs), errs
        got = decode_band_device(blob, device="cpu").data.numpy().astype(np.int64)
        assert np.abs(got - a).max() <= bound
        jax_faults.append(_host_error(jax_codec.encode_band_device(a, mask, mze, 6, True), a)[1])
    # JAX's blobs: wrong by up to 1,998 (above 2^31) and 1,401 (across), or
    # refused; the blocks near 0 and 2^32 decode wrong by 2^32 - 10
    assert jax_faults[:4] == [1998, 1998, 1401, 1401]
    assert jax_faults[7:9] == ["corrupt LUT block"] * 2
    assert jax_faults[9:] == [2**32 - 10] * 2


def test_p6_int32_wide_blocks_written_raw():
    """P6's twin in int32: a block of values near -2^31 and near 2^31 at
    maxZError 4 has x - zMin past int32; K1 writes such a block raw. JAX
    quantizes it into a LUT record that its host decoder refuses."""
    a = np.zeros((16, 16, 1), np.int32)
    a[::2] = -2**31 + 5
    a[1::2, ::3] = 2**31 - 5
    blob = encode_band_device(a, None, 4.0, verify=True, device="cpu")
    assert _host_error(blob, a) == [0, 0]
    np.testing.assert_array_equal(decode_band_device(blob, device="cpu").data.numpy(), a)
    assert _host_error(jax_codec.encode_band_device(a, None, 4.0), a)[1] == "corrupt LUT block"


@pytest.mark.parametrize("masked", [False, True], ids=["all-valid", "masked"])
def test_p7_uint32_diff_chain_across_2_31(masked):
    rng = np.random.default_rng(17)
    base = 2**31 - 200 + rng.integers(0, 400, (40, 37))
    bands = [base]
    for _ in range(2):
        bands.append(bands[-1] + rng.integers(-2, 3, (40, 37)))
    data = np.stack(bands, -1).astype(np.uint32)
    mask = rng.random((40, 37)) > 0.25 if masked else None
    blob = BandEncoder(data, mask, 0.0).encode()  # lossless v6: depth-diff records
    host = lerc2_decode.decode_band(blob)
    port = decode_band_device(blob, device="cpu")
    np.testing.assert_array_equal(port.data.cpu().numpy(), np.asarray(host.data))
    sel = np.ones((40, 37), bool) if mask is None else mask
    np.testing.assert_array_equal(np.asarray(host.data)[sel], data[sel])


def _cliff_bands(npdt, h=16, w=48):
    """Three close slices of small values but for the first block column,
    whose 8x8 blocks span more than 32767 (a cliff): lossless 16-bit blocks
    forced raw, whose slice-to-slice differences are small."""
    rng = np.random.default_rng(19)
    lo, hi = (-20000, 20000) if npdt == np.int16 else (100, 60000)
    s0 = rng.integers(0, 50, (h, w))
    s0[:, :8] += np.where(np.arange(8)[None, :] < 4, lo, hi)
    s = [s0]
    for _ in range(2):
        s.append(s[-1] + rng.integers(0, 3, (h, w)))
    return np.stack(s, -1).astype(npdt)


@pytest.mark.parametrize("npdt", [np.int16, np.uint16])
def test_p8_wide_16bit_blocks_raw_without_diff(npdt):
    data = _cliff_bands(npdt)
    blob = encode_band_device(data, None, 0.5, device="cpu")
    assert band_sections(memoryview(blob)).kind == "tiling"
    np.testing.assert_array_equal(np.asarray(lerc2_decode.decode_band(blob).data), data)
    np.testing.assert_array_equal(decode_band_device(blob, device="cpu").data.numpy(), data)
    if npdt == np.int16:  # JAX's encoder: raw records with the diff bit
        h, w, d = data.shape
        s, tot, _zmn, _zmx, st, _f = jenc.encode_tiles(
            jnp.asarray(data.astype(np.int32)), jnp.ones((h, w), bool), jnp.float32(0.5), h, w,
            d, JDT.SHORT, True, 6, 1 << 14)
        flags = np.asarray(s).view(np.uint8)[np.asarray(st)]
        assert ((flags & 3 == 0) & (flags & 4 != 0)).sum() > 0


P9_RUN = r"""
import ctypes, mmap, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/tools/cuda_standin")
import standin
from lerc_tpu_torch.ops import device_fpl as F

standin.install(standin.build(["fpl"]), ["fpl_packbits_size"])
page = mmap.PAGESIZE
pages = -(-4 * 16389 // page) + 1
buf = mmap.mmap(-1, (pages + 1) * page)
base = ctypes.addressof(ctypes.c_char.from_buffer(buf))
libc = ctypes.CDLL(None, use_errno=True)
libc.mprotect.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
assert libc.mprotect(base + pages * page, page, 0) == 0  # the page after the planes: no access
end = np.frombuffer(buf, np.uint8, count=pages * page)
rng = np.random.default_rng(9)
for n, stride in ((5000, 5001), (4093, 4095), (16389, 16389)):
    planes = torch.from_numpy(end[pages * page - 4 * stride:]).view(4, stride)
    planes.copy_(torch.from_numpy(rng.integers(0, 3, (4, stride), dtype=np.uint8)))
    got = F.fpl_packbits_size(planes, n)
    assert torch.equal(got, F.fpl_packbits_size_ref(planes, n)), (n, got)
    print("ok", n, planes.data_ptr() % 16, flush=True)
"""


def test_p9_f2b_reads_no_byte_past_its_planes():
    """P9: F2b (``fpl_packbits_size_kernel``) loaded the 16-byte chunk at
    each thread's first byte even where the thread had no byte of the plane
    (a >= n) and the planes lay off a 16-byte boundary: up to a tile, 16 KB,
    past the last plane's end -- an illegal address on the card where the
    allocation ends a mapped range. Run by the CPU stand-in of the CUDA
    runtime (tools/cuda_standin) on planes that end at a page with no
    access, at odd strides and offsets, in a process of its own: a read
    past the planes kills it."""
    import subprocess
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    r = subprocess.run([sys.executable, "-c", P9_RUN, root], capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, (r.returncode, r.stdout[-2000:], r.stderr[-4000:])
    assert r.stdout.count("ok") == 3
