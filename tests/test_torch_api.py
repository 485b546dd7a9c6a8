"""The port's public API and orchestrators against JAX's.

With acceleration off in both packages, ``encode_blob`` / ``decode_blob``
and the lerc-compatible functions return what JAX's return: blobs, tuples,
error codes, noData and NaN bands, per-band and shared masks, mask dedup.
With acceleration on and ``_ACCEL_MIN_PIXELS`` lowered in both, a routed
band (``device="cpu"``: the band codec's plain versions) is byte-equal to
JAX's device route, and its decode bit-equal to JAX's host decoder. A
device failure propagates: no ``except`` wraps a device call."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import lerc_tpu
import lerc_tpu_torch
from lerc_tpu import api as jax_api
from lerc_tpu.codec import encode_orchestrator as jax_enc
from lerc_tpu.codec import orchestrator as jax_orch
from lerc_tpu_torch.codec import device_codec, encode_orchestrator, orchestrator

from .test_torch_host_codec import _bits

REPO = Path(__file__).resolve().parents[1]
CPU = dict(device="cpu")


@pytest.fixture
def host_only(monkeypatch):
    monkeypatch.setattr(jax_enc, "_ACCELERATION", False)
    monkeypatch.setattr(encode_orchestrator, "_ACCELERATION", False)


@pytest.fixture
def routed(monkeypatch):
    """Acceleration on in both packages, every band of 4096 pixels or more routed."""
    monkeypatch.setattr(jax_enc, "_ACCELERATION", True)
    monkeypatch.setattr(jax_enc, "_ACCEL_MIN_PIXELS", 4096)
    monkeypatch.setattr(encode_orchestrator, "_ACCELERATION", None)  # None: on
    monkeypatch.setattr(encode_orchestrator, "_ACCEL_MIN_PIXELS", 4096)


def _raster(npdt, n_bands=1, h=33, w=29, d=1, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = 40 * np.sin(x / 6.0) + y * 1.3
    v = np.stack([np.stack([base + b * 3 + k + rng.normal(0, 1.5, (h, w)) for k in range(d)], -1)
                  for b in range(n_bands)])
    if np.dtype(npdt).kind == "f":
        return v.astype(npdt)
    info = np.iinfo(npdt)
    return np.clip(np.round(v) + (0 if info.min == 0 else -30), info.min, info.max).astype(npdt)


def _mask(h=33, w=29, seed=1):
    m = np.random.default_rng(seed).random((h, w)) > 0.25
    m[4:9, 2:20] = False
    return m


def assert_results_equal(res, jres):
    np.testing.assert_array_equal(_bits(res.data), _bits(jres.data))
    assert res.data.dtype == jres.data.dtype
    np.testing.assert_array_equal(res.masks, jres.masks)
    np.testing.assert_array_equal(res.uses_no_data, jres.uses_no_data)
    np.testing.assert_array_equal(res.no_data_values, jres.no_data_values)
    assert vars(res.info) == vars(jres.info)


BLOBS = [  # (dtype, bands, depth, masks, maxZError, version)
    (np.float32, 1, 1, None, 0.01, -1), (np.float32, 3, 1, "shared", 0.1, 6),
    (np.float64, 2, 2, "per-band", 0.001, 6), (np.uint8, 3, 1, "shared", 0, 6),
    (np.int16, 2, 3, None, 0, 5), (np.uint16, 2, 1, "per-band", 2, 4),
    (np.int32, 1, 1, "shared", 0, 3), (np.uint32, 2, 1, None, 7, 2),
    (np.int8, 2, 1, "per-band", 0, 2), (np.float32, 2, 1, "same", 0, 6),
    (np.float32, 2, 1, "shared", 0.5, 2), (np.uint8, 2, 2, "same", 777, 6),
]


@pytest.mark.parametrize("npdt,n_bands,d,masks,mze,version", BLOBS,
                         ids=[f"{np.dtype(c[0]).name}-{c[1]}b-d{c[2]}-{c[3]}-{c[4]}-v{c[5]}"
                              for c in BLOBS])
def test_encode_and_decode_blob_match_jax(npdt, n_bands, d, masks, mze, version, host_only):
    data = _raster(npdt, n_bands, d=d)
    m = {None: None, "shared": _mask()[None], "same": np.stack([_mask()] * n_bands),
         "per-band": np.stack([_mask(seed=b) for b in range(n_bands)])}[masks]
    blob = encode_orchestrator.encode_blob(data, m, mze, version, verify=True, **CPU)
    assert blob == jax_enc.encode_blob(data, m, mze, version)
    res = orchestrator.decode_blob(blob, **CPU)
    assert_results_equal(res, jax_orch.decode_blob(blob))
    if masks in ("shared", "same"):  # mask dedup: bands 2.. carry no mask section
        info = orchestrator.get_lerc_info(blob)
        assert info.n_masks == 1
        for off in info.band_offsets[1:]:
            hd_len = lerc_tpu_torch.codec.header.header_size(info.version)
            assert blob[off + hd_len : off + hd_len + 4] == b"\0\0\0\0"


NODATA = [  # (dtype, depth, noData per band (None: none), NaN holes, version)
    (np.float32, 1, [-9999.0, None], True, 6), (np.float32, 3, [-1.0, -1.0], True, 6),
    (np.float64, 1, [None, None], True, 6), (np.float32, 1, [None], True, 5),
    (np.int16, 1, [-32768.0, 7.0], False, 6), (np.uint8, 2, [0.0, 255.0], False, 6),
    (np.float32, 2, [None, None], True, 3), (np.int32, 1, [12.0], False, 6),
]


@pytest.mark.parametrize("npdt,d,nodata,nan,version", NODATA,
                         ids=[f"{np.dtype(c[0]).name}-d{c[1]}-{len(c[2])}b-{c[3]}-v{c[4]}"
                              for c in NODATA])
def test_nodata_and_nan_bands_match_jax(npdt, d, nodata, nan, version, host_only):
    n_bands = len(nodata)
    data = _raster(npdt, n_bands, d=d, seed=3)
    rng = np.random.default_rng(4)
    for b, nd in enumerate(nodata):
        if nd is not None:
            hole = rng.random(data.shape[1:]) > 0.85
            data[b][hole] = nd
            data[b, 0, 0, :] = nd  # a pixel of noData in every slice
    if nan:
        data[:, 20:25, 3:9, 0] = np.nan
        if d > 1:
            data[:, 2, 2, :] = np.nan
    uses = np.array([nd is not None for nd in nodata], np.uint8)
    vals = np.array([0.0 if nd is None else nd for nd in nodata])
    uses_arg = uses if uses.any() else None
    for mze in (0.0, 0.5):
        try:
            jblob = jax_enc.encode_blob(data, None, mze, version, uses_no_data=uses_arg,
                                        no_data_values=vals)
        except ValueError as e:  # LercEncodeError, or the band encoder's refusal
            with pytest.raises(ValueError) as got:
                encode_orchestrator.encode_blob(data, None, mze, version, uses_no_data=uses_arg,
                                                no_data_values=vals, **CPU)
            assert str(got.value) == str(e)
            assert getattr(got.value, "code", None) == getattr(e, "code", None)
            continue
        blob = encode_orchestrator.encode_blob(data, None, mze, version, uses_no_data=uses_arg,
                                               no_data_values=vals, **CPU)
        assert blob == jblob
        assert_results_equal(orchestrator.decode_blob(blob, **CPU), jax_orch.decode_blob(blob))


def _api_pairs():
    data = _raster(np.float32, 2)
    return data, _mask()


def test_api_tuples_match_jax(host_only):
    data, mask = _api_pairs()
    for mod_args in [(data[..., 0], 1, True, mask, 0.01, 1), (data[0, ..., 0], 1, False, None, 0.0, 1),
                     (_raster(np.uint8, 1, d=3)[0], 3, False, None, 0, 1),
                     (_raster(np.int16, 2, d=2), 2, True, mask, 0, 1)]:
        got = lerc_tpu_torch.encode(*mod_args, **CPU)
        want = lerc_tpu.encode(*mod_args)
        assert got == want and got[0] == 0
        blob = got[2]
        assert lerc_tpu_torch.computeCompressedSize(*mod_args[:5], **CPU) == \
            lerc_tpu.computeCompressedSize(*mod_args[:5]) == (0, len(blob))
        for fn in ("getLercBlobInfo", "getLercBlobInfo_4D"):
            assert getattr(lerc_tpu_torch, fn)(blob) == getattr(lerc_tpu, fn)(blob)
        info = lerc_tpu.getLercBlobInfo(blob)
        n_depth, n_bands = info[3], info[6]
        rg, jr = lerc_tpu_torch.getLercDataRanges(blob, n_depth, n_bands), \
            lerc_tpu.getLercDataRanges(blob, n_depth, n_bands)
        assert rg[0] == jr[0] and np.array_equal(rg[1], jr[1]) and np.array_equal(rg[2], jr[2])
        for fn in ("decode", "decode_4D", "decodeToDouble", "decodeToDouble_4D"):
            g, w = getattr(lerc_tpu_torch, fn)(blob, **CPU), getattr(lerc_tpu, fn)(blob)
            assert g[0] == w[0] == 0 and len(g) == len(w)
            np.testing.assert_array_equal(_bits(g[1]), _bits(w[1]))
            assert (g[2] is None) == (w[2] is None)
            if g[2] is not None:
                np.testing.assert_array_equal(g[2], w[2])
        g, w = lerc_tpu_torch.decode_ma(blob, **CPU), lerc_tpu.decode_ma(blob)
        np.testing.assert_array_equal(np.ma.getmaskarray(g[1]), np.ma.getmaskarray(w[1]))
        np.testing.assert_array_equal(g[1].data, w[1].data)
        assert g[0] == w[0] and g[2:] == w[2:]
        for dtype in (np.float32, np.int32):
            g, w = lerc_tpu_torch.decode_to_dtype(blob, dtype, **CPU), \
                jax_api.decode_to_dtype(blob, dtype)
            assert (g == w) if not isinstance(g, tuple) else np.array_equal(g[1], w[1])
    data = data[..., 0]
    for v in (2, 3, 4, 5, 6, -1):
        assert lerc_tpu_torch.encodeForVersion(data, v, 1, True, mask, 0.01, 1, **CPU) == \
            lerc_tpu.encodeForVersion(data, v, 1, True, mask, 0.01, 1)
        assert lerc_tpu_torch.computeCompressedSizeForVersion(data, v, 1, True, mask, 0.01,
                                                              **CPU) == \
            lerc_tpu.computeCompressedSizeForVersion(data, v, 1, True, mask, 0.01)
    nd = np.ma.array([-5.0, 0.0], mask=[False, True])
    for args in [(data, 1, mask, 0.01, 1, nd), (data, 1, None, 0.0, 0, None)]:
        assert lerc_tpu_torch.encode_4D(*args, **CPU) == lerc_tpu.encode_4D(*args)
        assert lerc_tpu_torch.computeCompressedSize_4D(*args[:4], args[5], **CPU) == \
            lerc_tpu.computeCompressedSize_4D(*args[:4], args[5])
    ma = np.ma.array(data, mask=np.broadcast_to(~mask, data.shape))
    assert lerc_tpu_torch.encode_ma(ma, 1, 0.01, 1, **CPU) == lerc_tpu.encode_ma(ma, 1, 0.01, 1)
    assert lerc_tpu_torch.encode_4D(data, 1, mask, 0.01, 1, nd, **CPU)[0] == 0
    blob = lerc_tpu_torch.compress(data, 0.01, mask, **CPU)
    assert blob == lerc_tpu.compress(data, 0.01, mask)
    (g, gm), (w, wm) = lerc_tpu_torch.decompress(blob, **CPU), lerc_tpu.decompress(blob)
    np.testing.assert_array_equal(g, w) and np.testing.assert_array_equal(gm, wm)


def test_api_helpers_match_jax():
    a, b = _raster(np.float32, 2), _raster(np.float32, 2, seed=9)
    m = _mask()
    assert lerc_tpu_torch.findMaxZError(a, b) == lerc_tpu.findMaxZError(a, b)
    assert lerc_tpu_torch.findMaxZError_4D(a, b, m, 2) == lerc_tpu.findMaxZError_4D(a, b, m, 2)
    ma, mb = np.ma.array(a, mask=a > 40), np.ma.array(b, mask=a > 40)
    assert lerc_tpu_torch.findMaxZError_ma(ma, mb) == lerc_tpu.findMaxZError_ma(ma, mb)
    assert lerc_tpu_torch.findDataRange(a, True, m, 2) == lerc_tpu.findDataRange(a, True, m, 2)
    assert lerc_tpu_torch.findDataRange_ma(ma) == lerc_tpu.findDataRange_ma(ma)
    for dt in (np.float32, np.uint16, np.complex64):
        assert lerc_tpu_torch.getLercDatatype(dt) == lerc_tpu.getLercDatatype(dt)
    for arr, nv in ((a, 1), (a[0], 1), (a[0, :, :, 0], 1), (a, 3)):
        assert lerc_tpu_torch.getLercShape(arr, nv) == lerc_tpu.getLercShape(arr, nv)
    nd = np.ma.array([1.0, 0.0], mask=[False, True])
    g = lerc_tpu_torch.convert2ma(a[:, :, :, 0], m, 1, 2, nd)
    w = lerc_tpu.convert2ma(a[:, :, :, 0], m, 1, 2, nd)
    np.testing.assert_array_equal(np.ma.getmaskarray(g), np.ma.getmaskarray(w))


def test_api_error_codes_match_jax(host_only):
    data, mask = _api_pairs()
    cases = [
        ("encode", (data[0, :, :, 0], 2, False, None, 0.01, 1)),  # wrong ndim for nValuesPerPixel
        ("encode", (data[0, 0, :, 0], 1, False, None, 0.01, 1)),  # 1-D
        ("encode", (data, 1, True, mask, -1.0, 1)),  # negative maxZError
        ("encode", (data, 1, True, mask[:5], 0.01, 1)),  # mask of another shape
        ("encodeForVersion", (data, 5, 1, True, mask, 0.01, 1)),
        ("encodeForVersion", (data, 9, 1, True, mask, 0.01, 1)),  # bad version
        ("encode_4D", (_raster(np.uint8, 2), 1, None, 0, 1,
                       np.ma.array([300.0, 1.0], mask=[False, False]))),  # noData out of range
        ("encode_4D", (_raster(np.uint8, 2), 1, None, 0, 1,
                       np.ma.array([3.0], mask=[False]))),  # noData array of another size
        ("encode", (data.astype(np.complex64), 1, False, None, 0.0, 1)),
    ]
    for fn, args in cases:
        assert getattr(lerc_tpu_torch, fn)(*args, **CPU) == getattr(lerc_tpu, fn)(*args), (fn, args)
    # noData at v5 (encode_blob), and NaN mixed per pixel with no noData value
    nd_data = _raster(np.float32, 1, d=2)
    nd_data[0, 3, 3, 0] = np.nan
    for args in [(data, None, 0.0, 5, np.array([1], np.uint8), np.array([0.0])),
                 (nd_data, None, 0.0, 6, None, None)]:
        with pytest.raises(jax_enc.LercEncodeError) as want:
            jax_enc.encode_blob(*args)
        with pytest.raises(encode_orchestrator.LercEncodeError) as got:
            encode_orchestrator.encode_blob(*args, **CPU)
        assert got.value.code == want.value.code
    for bad in (b"", b"Lerc2 " + b"\0" * 40, b"garbage" * 10,
                lerc_tpu.compress(data, 0.01)[:-7]):
        for fn in ("decode", "decode_4D", "decode_ma", "getLercBlobInfo"):
            assert getattr(lerc_tpu_torch, fn)(bad, **({} if fn.startswith("get") else CPU)) == \
                getattr(lerc_tpu, fn)(bad)
    with pytest.raises(ValueError):
        lerc_tpu_torch.decompress(b"garbage" * 10, **CPU)


ROUTED = [  # (dtype, depth, masked, maxZError, h, w): JAX compiles one program per case
    (np.float32, 1, False, 0.01, 64, 64), (np.float32, 1, True, 0.01, 130, 77),
    (np.uint8, 1, False, 0, 130, 77), (np.int16, 3, False, 0, 64, 64),
    (np.float32, 1, False, 0, 64, 64), (np.uint16, 1, True, 2, 64, 64),
]


@pytest.mark.parametrize("npdt,d,masked,mze,h,w", ROUTED,
                         ids=[f"{np.dtype(c[0]).name}-d{c[1]}{'-mask' if c[2] else ''}-{c[3]}"
                              f"-{c[4]}x{c[5]}" for c in ROUTED])
def test_routed_bands_match_jax_device_route(npdt, d, masked, mze, h, w, routed, monkeypatch):
    data = _raster(npdt, 2, h, w, d)
    masks = _mask(h, w)[None] if masked else None
    calls = []
    real = device_codec.encode_band_device
    monkeypatch.setattr(device_codec, "encode_band_device",
                        lambda *a, **k: calls.append(k["device"]) or real(*a, **k))
    blob = encode_orchestrator.encode_blob(data, masks, mze, **CPU)
    assert len(calls) == 2 and calls[0] == torch.device("cpu")  # every band routed
    assert blob == jax_enc.encode_blob(data, masks, mze)
    res = orchestrator.decode_blob(blob, **CPU)  # the port's band decoder, to numpy
    jres = jax_orch.decode_blob(blob)  # JAX's device route
    monkeypatch.setattr(jax_enc, "_ACCELERATION", False)
    host = jax_orch.decode_blob(blob)  # JAX's host decoder
    assert_results_equal(res, host)
    assert_results_equal(jres, host)


def test_routed_uint32_past_2_31_jax_fault(routed):
    """ROADMAP queue 3 (P6's twin): JAX's band encoder takes a uint32 band's
    ranges from int32 bits, so its routed blob decodes wrong; the port's
    routed blob decodes exactly, through its decoder and JAX's host one."""
    rng = np.random.default_rng(0)
    data = (3_000_000_001 + rng.integers(0, 1000, (1, 64, 64, 1))).astype(np.uint32)
    blob = encode_orchestrator.encode_blob(data, None, 0, **CPU)
    jblob = jax_enc.encode_blob(data, None, 0)
    assert blob != jblob
    np.testing.assert_array_equal(orchestrator.decode_blob(blob, **CPU).data, data)
    jax_enc.set_acceleration(False)
    try:
        np.testing.assert_array_equal(jax_orch.decode_blob(blob).data, data)
        assert np.abs(jax_orch.decode_blob(jblob).data.astype(np.int64) - data).max() == 999
    finally:
        jax_enc.set_acceleration(True)


def test_small_bands_and_old_versions_stay_on_the_host(routed, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("routed to the band codec")

    monkeypatch.setattr(device_codec, "encode_band_device", refuse)
    monkeypatch.setattr(device_codec, "decode_band_device", refuse)
    small = _raster(np.float32, 1, 60, 60)  # 3600 pixels < 4096
    for data, version in ((small, 6), (_raster(np.float32, 1, 64, 64), 5),
                          (_raster(np.float32, 1, 64, 64), 2)):
        blob = encode_orchestrator.encode_blob(data, None, 0.01, version, **CPU)
        assert blob == jax_enc.encode_blob(data, None, 0.01, version)
        if version != 5:  # the band codec decodes from version 3 on
            orchestrator.decode_blob(blob, **CPU)
    nd = _raster(np.float32, 1, 64, 64, d=2)
    nd[0, :3, :3, 0] = -1.0  # noData in one slice of a pixel: header fields, the host encoder
    blob = encode_orchestrator.encode_blob(nd, None, 0.01, uses_no_data=np.array([1]),
                                           no_data_values=np.array([-1.0]), **CPU)
    assert blob == jax_enc.encode_blob(nd, None, 0.01, uses_no_data=np.array([1]),
                                       no_data_values=np.array([-1.0]))


def test_device_failures_propagate(routed, monkeypatch):
    data = _raster(np.float32, 1, 64, 64)[0, ..., 0]

    def boom(*a, **k):
        raise RuntimeError("device failure")

    blob = lerc_tpu_torch.compress(data, 0.01, **CPU)
    monkeypatch.setattr(device_codec, "encode_band_device", boom)
    with pytest.raises(RuntimeError, match="device failure"):
        encode_orchestrator.encode_blob(data[None, :, :, None], None, 0.01, **CPU)
    with pytest.raises(RuntimeError, match="device failure"):
        lerc_tpu_torch.encode(data, 1, False, None, 0.01, 1, **CPU)
    monkeypatch.setattr(device_codec, "decode_band_device", boom)
    with pytest.raises(RuntimeError, match="device failure"):
        orchestrator.decode_blob(blob, **CPU)
    with pytest.raises(RuntimeError, match="device failure"):
        lerc_tpu_torch.decode(blob, **CPU)


@pytest.mark.parametrize("name", ["encode_orchestrator.py", "orchestrator.py"])
def test_no_except_around_a_device_call(name):
    tree = ast.parse((REPO / "lerc_tpu_torch" / "codec" / name).read_text())
    calls = [n.func.attr for n in ast.walk(tree)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)]
    assert {"encode_band_device", "decode_band_device"} & set(calls)  # the module routes
    for t in (n for n in ast.walk(tree) if isinstance(n, ast.Try)):
        inside = {c.func.attr for s in t.body for c in ast.walk(s)
                  if isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute)}
        assert not {"encode_band_device", "decode_band_device"} & inside


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    data = _raster(np.float32, 1)[0, ..., 0]
    blob = lerc_tpu.compress(data, 0.01)
    for call in (lambda: lerc_tpu_torch.compress(data, 0.01),
                 lambda: lerc_tpu_torch.decompress(blob),
                 lambda: lerc_tpu_torch.encode(data, 1, False, None, 0.01, 1),
                 lambda: lerc_tpu_torch.decode(blob),
                 lambda: encode_orchestrator.encode_blob(data[None, :, :, None]),
                 lambda: orchestrator.decode_blob(blob)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
