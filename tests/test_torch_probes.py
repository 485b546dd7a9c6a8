"""Q1-Q3, the Pallas probes of ``tools/profile_pallas.py``: each plain
version of ``lerc_tpu_torch/ops/probes.py`` against the probe's own kernel
body run by ``pl.pallas_call(..., interpret=True)`` with the probe's specs
(:47-53, :78-92, :119-133). The module itself runs its probes at full size
when imported, so only its three kernel functions are taken from its source.

Q2's body rolls by a negative shift, which this JAX's ``pltpu.roll`` refuses
("shift must be non-negative"); the test wraps it to ``shift % size``, the
same rotation (``pltpu.roll`` follows ``jnp.roll``'s direction)."""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lerc_tpu_torch.ops import probes

SOURCE = Path(__file__).resolve().parents[1] / "tools" / "profile_pallas.py"


def _bodies(roll) -> dict:
    """_k_write, _k_window and _k_asm from the probe's source, with `roll` as
    their pltpu.roll."""
    tree = ast.parse(SOURCE.read_text())
    fns = [n for n in tree.body if isinstance(n, ast.FunctionDef)
           and n.name in ("_k_write", "_k_window", "_k_asm")]
    shim = type("pltpu", (), {"roll": staticmethod(roll)})
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "pltpu": shim}
    exec(compile(ast.Module(body=fns, type_ignores=[]), str(SOURCE), "exec"), ns)
    return {f.name: ns[f.name] for f in fns}


def _wrapped_roll(x, shift, axis):
    return pltpu.roll(x, shift % x.shape[axis], axis)


def _pallas_write(offs, vals):
    k = _bodies(pltpu.roll)["_k_write"]
    call = pl.pallas_call(
        k, out_shape=jax.ShapeDtypeStruct((256, 128), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)
    return np.asarray(call(jnp.asarray(offs), jnp.asarray(vals)))


def _pallas_window(offs, stream, roll):
    k = _bodies(roll)["_k_window"]
    n, r = offs.size, 512
    call = pl.pallas_call(
        k, grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=0, grid=(n // r,),
            in_specs=[pl.BlockSpec((r,), lambda i: (i,), memory_space=pltpu.SMEM),
                      pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((2 * r, 128), lambda i: (i, 0), memory_space=pltpu.VMEM)),
        out_shape=jax.ShapeDtypeStruct((2 * n, 128), jnp.uint32), interpret=True)
    return np.asarray(call(jnp.asarray(offs), jnp.asarray(stream)))


def _pallas_asm(offs, vals):
    k = _bodies(pltpu.roll)["_k_asm"]
    n, r = offs.size, 512
    call = pl.pallas_call(
        k, grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=0, grid=(n // r,),
            in_specs=[pl.BlockSpec((r,), lambda i: (i,), memory_space=pltpu.SMEM),
                      pl.BlockSpec((2 * r, 128), lambda i: (i, 0), memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((300, 128), lambda i: (0, 0), memory_space=pltpu.VMEM)),
        out_shape=jax.ShapeDtypeStruct((300, 128), jnp.uint32), interpret=True)
    return np.asarray(call(jnp.asarray(offs), jnp.asarray(vals)))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("kind", ["probe", "random"])
def test_q1_write_matches_the_pallas_body(kind):
    rng = np.random.default_rng(3)
    offs = (np.arange(512) % 250 if kind == "probe" else rng.integers(0, 255, 512)).astype(np.int32)
    vals = (np.ones((1024, 128), np.int32) if kind == "probe"
            else rng.integers(-2**31, 2**31, (1024, 128), dtype=np.int64).astype(np.int32))
    got = probes.write_call(torch.from_numpy(offs), torch.from_numpy(vals))
    assert got.dtype == torch.int32 and got.shape == (256, 128)
    np.testing.assert_array_equal(got.numpy(), _pallas_write(offs, vals))
    if kind == "probe":  # the probe's own check (:58) holds
        assert int(got.sum()) == 1024 * 128


def test_q2_window_matches_the_pallas_body():
    rng = np.random.default_rng(0)
    n = 1024  # grid 2
    offs = rng.integers(0, 128 * 1000, n).astype(np.int32)
    stream = np.arange(1024 * 128, dtype=np.uint32).reshape(1024, 128)
    stream[::7] ^= np.uint32(0xA5A5A5A5)
    got = probes.window_call(torch.from_numpy(offs), torch.from_numpy(stream.view(np.int32))
                             .view(torch.uint32))
    assert got.dtype == torch.uint32 and got.shape == (2 * n, 128)
    want = _pallas_window(offs, stream, _wrapped_roll)
    np.testing.assert_array_equal(_u32(got), want)
    o = int(offs[5])  # out[2i + r, l] = stream[(o >> 7) + r, (l + (o & 127)) & 127]
    np.testing.assert_array_equal(want[10:12], np.roll(stream[(o >> 7):(o >> 7) + 2],
                                                       -(o & 127), axis=1))
    with pytest.raises(ValueError, match="non-negative"):  # the probe's FAIL in this JAX
        _pallas_window(offs[:512], stream, pltpu.roll)


def test_q3_asm_matches_the_pallas_body():
    rng = np.random.default_rng(1)
    n = 1024  # grid 2
    offs = rng.integers(0, 290 * 128, n).astype(np.int32)
    vals = rng.integers(0, 2**32, (2 * n, 128), dtype=np.uint64).astype(np.uint32)
    got = probes.asm_call(torch.from_numpy(offs), torch.from_numpy(vals.view(np.int32))
                          .view(torch.uint32))
    assert got.dtype == torch.uint32 and got.shape == (300, 128)
    want = _pallas_asm(offs, vals)
    np.testing.assert_array_equal(_u32(got), want)
    # only the last program's 512 slabs reach the output (ROADMAP queue 3): the
    # probe's check, a sum of 2 * N * 128 over ones, cannot hold
    ones = np.ones((2 * n, 128), np.uint32)
    total = int(_pallas_asm(offs, ones).astype(np.int64).sum())
    assert total == 2 * 512 * 128 != 2 * n * 128
    assert int(probes.asm_call(torch.from_numpy(offs), torch.from_numpy(ones.view(np.int32))
                               .view(torch.uint32)).view(torch.int32).sum()) == total


def test_probe_shapes_and_offsets_are_checked():
    offs = torch.zeros(512, dtype=torch.int32)
    vals = torch.zeros(1024, 128, dtype=torch.int32)
    stream = torch.zeros(16, 128, dtype=torch.int32).view(torch.uint32)
    for bad, call in (
        (255, lambda o: probes.write_call(o, vals)),  # a slab past row 255
        (-1, lambda o: probes.write_call(o, vals)),
        (128 * 15, lambda o: probes.window_call(o, stream)),  # window past the stream
        (128 * 299, lambda o: probes.asm_call(o, vals.view(torch.uint32))),  # past row 299
    ):
        o = offs.clone()
        o[7] = bad
        with pytest.raises(ValueError, match="out of range"):
            call(o)
    with pytest.raises(ValueError, match="multiple of 512"):
        probes.window_call(offs[:500], stream)
    with pytest.raises(ValueError, match="multiple of 512"):
        probes.asm_call(offs[:500], vals[:1000].view(torch.uint32))
    with pytest.raises(ValueError, match="vals"):
        probes.write_call(offs, vals[:100])
    with pytest.raises(ValueError, match="int32"):
        probes.write_call(offs.to(torch.int64), vals)
