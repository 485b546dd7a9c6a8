"""Port parity: the plain version of K3 (fletcher32_parts) vs the JAX
device_scan.fletcher32_device_parts and vs the host Fletcher32 of the
concatenated message bytes, on short and long tails (tens of thousands of
bytes, odd and even, with and without a stream and a static part).
Criterion: equal checksums."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lerc_tpu.codec.fletcher32 import fletcher32 as jax_host_fletcher32
from lerc_tpu.ops import device_scan as jax_scan
from lerc_tpu_torch.codec.fletcher32 import fletcher32, fletcher32_partials
from lerc_tpu_torch.ops import device_scan

CAP_W = 512


def _message(n_pre, n_static, n_tail, total, seed):
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, 256, n_pre, dtype=np.uint8)
    static = rng.integers(0, 256, n_static, dtype=np.uint8).tobytes()
    tail = rng.integers(0, 256, n_tail, dtype=np.uint8)
    sb = np.zeros(4 * CAP_W, np.uint8)
    sb[:total] = rng.integers(0, 256, total, dtype=np.uint8)
    sb[:total][::7] = 255  # keep high bytes in play
    return pre, static, tail, sb


@pytest.mark.parametrize("n_pre,n_static,n_tail,total", [
    (76, 4, 9, 333),    # odd tail, odd total
    (76, 4, 10, 1000),  # even tail, even total
    (76, 0, 9, 2047),   # no static section
    (76, 290, 11, 1),   # a long static section
    (8, 4, 10, 0),      # empty stream
    (76, 4, 9, 0),      # empty stream after an odd tail
    (76, 4, 10, 4 * CAP_W),  # full capacity
    # long tails (the band codec checksums a whole fpl blob as the tail)
    (76, 4, 40001, 333),      # odd, before a stream
    (76, 290, 65536, 2047),   # even, after a static part
    (0, 0, 30001, 0),         # alone: no header part, no static part, an empty stream
    (8, 0, 50000, 4 * CAP_W),  # even, before a full stream
])
@pytest.mark.parametrize("seed", [0, 1])
def test_fletcher32_parts_matches_jax_and_host(n_pre, n_static, n_tail, total, seed):
    pre, static, tail, sb = _message(n_pre, n_static, n_tail, total, seed)
    ab = fletcher32_partials(static, n_pre // 2) + (n_static,)
    words = sb.view(np.uint32)
    want_host = fletcher32(pre.tobytes() + static + tail.tobytes() + sb[:total].tobytes())
    assert want_host == jax_host_fletcher32(
        pre.tobytes() + static + tail.tobytes() + sb[:total].tobytes())
    want_jax = int(jax_scan.fletcher32_device_parts(
        jnp.asarray(pre), ab, jnp.asarray(tail), jnp.asarray(words), jnp.int32(total)))
    got = device_scan.fletcher32_parts(
        torch.from_numpy(pre), ab, torch.from_numpy(tail),
        torch.from_numpy(words.view(np.int32)), torch.tensor([total], dtype=torch.int32))
    assert got.shape == ()
    got = int(got) & 0xFFFFFFFF
    assert got == want_jax == want_host


def test_fletcher32_partials_match_jax():
    static = np.random.default_rng(3).integers(0, 256, 300, dtype=np.uint8).tobytes()
    assert fletcher32_partials(static, 38) == jax_scan.fletcher32_partials(static, 38)
