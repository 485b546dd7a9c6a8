"""Port parity: lerc_tpu_torch encode_tiles (plain versions of K1 + K2) vs
the JAX device_encode.encode_tiles on the same float32 tiles.

Criterion: equal stream bytes up to `total` (where `fits`: an unfit capped
JAX stream is documented as invalid and is rebuilt uncapped by its
callers), and equal total, starts, per-depth zmin/zmax and fits.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lerc_tpu.constants import DataType as JDataType
from lerc_tpu.ops import device_encode as jax_encode
from lerc_tpu_torch.constants import DataType
from lerc_tpu_torch.ops import device_encode


def _dem(h, w, d, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 8, w)[None, :, None]
    y = np.linspace(0, 5, h)[:, None, None]
    z = 900 * np.exp(-((x - 4) ** 2 + (y - 2) ** 2) / 9) + 40 * np.sin(x + y)
    return (z + 0.3 * rng.standard_normal((h, w, d))).astype(np.float32)


def _unfused_q(x, zmin, p):
    """The fixup with the reconstruction rounded twice (no FMA)."""
    scale, inv = torch.tensor(p.scale), torch.tensor(p.inv)
    q0 = torch.round((x - zmin) * scale)
    resid = x - (zmin + q0 * inv)
    qc = torch.clamp_min(q0 + torch.sign(resid), 0.0)
    errc = (x - (zmin + qc * inv)).abs()
    return torch.where(errc < resid.abs(), qc, q0).to(torch.int64)


def _tie_tile(h, w, mze, seed=0):
    """Values a few ulps around the midpoints of the quantization grid,
    per block, chosen where a fused and an unfused reconstruction pick a
    different quantized value (block minimum at position 0)."""
    rng = np.random.default_rng(seed)
    p = device_encode.encode_params(mze, 6)
    n_blk = (h // 8) * (w // 8)
    zmin = torch.from_numpy(rng.uniform(-500, 900, (n_blk, 1)).astype(np.float32))
    k = torch.from_numpy(rng.integers(1, 4000, (n_blk, 4096)).astype(np.float64))
    cand = (zmin.double() + (k + 0.5) * p.inv).float()
    ulps = torch.from_numpy(rng.integers(-3, 4, cand.shape).astype(np.int32))
    cand = (cand.view(torch.int32) + ulps).view(torch.float32)
    differ = device_encode.quantize_ref(cand, zmin, p) != _unfused_q(cand, zmin, p)
    order = torch.argsort(differ.to(torch.int8), dim=1, descending=True, stable=True)
    blocks = torch.cat([zmin, cand.gather(1, order[:, :63])], 1)
    img = blocks.reshape(h // 8, w // 8, 8, 8).permute(0, 2, 1, 3).reshape(h, w, 1)
    return img.contiguous().numpy()


def _tile(kind, h, w, d, mze):
    if kind == "dem":
        return _dem(h, w, d)
    if kind == "intneg":  # integer block minima: byte and short offsets
        return (np.round(_dem(h, w, d, seed=2)) - 500).astype(np.float32)
    if kind == "const":
        return np.full((h, w, d), -12.0, np.float32)
    if kind == "raw":  # block range / (2 mze) > 2^30 - 1 in some blocks
        z = _dem(h, w, d, seed=4)
        z[0:8, 0:16] = np.where(np.arange(16) % 2, 3.0e6, -1.0)[None, :, None]
        z[40:48, 8:16, :] = np.float32(1.0e9)
        return z
    if kind == "unfit":  # ~19 packed bits at maxZError 0.001, not raw
        return np.random.default_rng(5).normal(0, 150, (h, w, d)).astype(np.float32)
    if kind == "tie":
        return _tie_tile(h, w, mze)
    raise ValueError(kind)


def _cap(h, w, d, nb_cap):
    """The resident codec's stream capacity (resident.py:64-75)."""
    n_rec = (h // 8) * (w // 8) * d
    cap = -(-(h * w * 4 * d + n_rec * 12 + 4096) // 1024) * 1024
    if nb_cap:
        tight = n_rec * (8 + (64 * min(nb_cap, 32) + 7) // 8) + 4096
        cap = min(cap, -(-tight // 1024) * 1024)
    return cap


CASES = [
    # (kind, h, w, d, mze, nb_cap)
    ("dem", 64, 64, 1, 0.001, 0),
    ("dem", 64, 64, 1, 0.005, 16),
    ("dem", 64, 64, 1, 0.01, 16),
    ("dem", 72, 72, 1, 0.005, 0),
    ("dem", 32, 32, 3, 0.01, 0),
    ("dem", 64, 64, 1, 0.0, 0),
    ("intneg", 64, 64, 1, 0.01, 0),
    ("const", 64, 64, 1, 0.001, 0),
    ("const", 64, 64, 1, 0.001, 16),
    ("raw", 64, 64, 1, 0.001, 0),
    ("raw", 64, 64, 1, 0.001, 16),
    ("unfit", 64, 64, 1, 0.001, 16),
    ("tie", 64, 64, 1, 0.001, 0),
    ("tie", 64, 64, 1, 0.01, 0),
    ("tie", 64, 64, 1, 0.001, 16),
    ("dem", 32, 32, 3, 0.005, 16),
    ("dem", 64, 64, 1, 0.001, 16),  # does not fit: flags only
]


@pytest.mark.parametrize("kind,h,w,d,mze,nb_cap", CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}x{c[3]}-{c[4]}-cap{c[5]}" for c in CASES])
def test_encode_tiles_matches_jax(kind, h, w, d, mze, nb_cap):
    data = _tile(kind, h, w, d, mze)
    cap = _cap(h, w, d, nb_cap)
    js, jtotal, jzmin, jzmax, jstarts, jfits = (np.asarray(a) for a in jax_encode.encode_tiles(
        jnp.asarray(data), jnp.ones((h, w), bool), jnp.float32(mze), h, w, d,
        JDataType.FLOAT, True, 6, cap, nb_cap=nb_cap, out_u32=True))
    ts, ttotal, tzmin, tzmax, tstarts, tfits = device_encode.encode_tiles(
        torch.from_numpy(data), None, mze, h, w, d, DataType.FLOAT, True, 6, cap,
        nb_cap=nb_cap)
    assert int(ttotal) == int(jtotal)
    assert bool(tfits) == bool(jfits)
    np.testing.assert_array_equal(tstarts.numpy(), jstarts)
    np.testing.assert_array_equal(tzmin.numpy(), jzmin)
    np.testing.assert_array_equal(tzmax.numpy(), jzmax)
    assert ts.shape == (cap // 4,)
    if bool(jfits):
        total = int(jtotal)
        assert ts.numpy().tobytes()[:total] == js.tobytes()[:total]
        assert not ts.numpy().view(np.uint8)[total:].any(), "stream not zero past total"
    if kind == "raw":
        assert bool(jfits) == (nb_cap == 0)
    if kind == "unfit":
        assert not bool(jfits)


def test_tie_tile_separates_fused_from_unfused():
    """The tie tile decides the FMA question: its quantized values differ
    between a fused and an unfused fixup, so byte equality with the JAX
    encoder above holds only for the fused one."""
    p = device_encode.encode_params(0.01, 6)
    x = device_encode._blocks(torch.from_numpy(_tie_tile(64, 64, 0.01)))
    zmin = x.amin(1, keepdim=True)
    assert (device_encode.quantize_ref(x, zmin, p) != _unfused_q(x, zmin, p)).sum() > 100


@pytest.mark.parametrize("kwargs,item", [
    (dict(version=2), "item 12"),
    (dict(mb=32, enable_lut=True), "item 12"),
    (dict(mb=16), "item 12"),
    (dict(dt=DataType.DOUBLE), "item 9"),
])
def test_unported_options_name_their_roadmap_item(kwargs, item):
    args = dict(mask=None, max_z_error=0.01, h=16, w=16, d=1, dt=DataType.FLOAT,
                all_valid=True, version=6, cap=4096)
    args.update(kwargs)
    if item == "item 9":  # float64, ported since: encode_tiles hands it to encode_tiles_f64
        data = torch.arange(256, dtype=torch.float64).reshape(16, 16, 1) * 0.37
        stream, total, zmin, zmax, starts, fits = device_encode.encode_tiles(data, **args)
        want = device_encode.encode_tiles_f64(data, None, 0.01, 16, 16, 1, True, 6, 4096)
        assert torch.equal(stream, want[0]) and int(total) == int(want[1]) and bool(fits)
        assert torch.equal(zmin, want[2]) and torch.equal(zmax, want[3])
        assert torch.equal(starts, want[4]) and zmin.dtype == torch.float64
        return
    with pytest.raises(NotImplementedError, match=item):
        device_encode.encode_tiles(torch.zeros(16, 16, 1), **args)
