"""The LUT K1's distinct count and its skip rule (``encode_blocks_lut``;
its plain version ``encode_blocks_ref(..., lut=True)``).

K1 counts a block's distinct non-zero quanta (n_lut) only where the LUT
record can be shorter than the stuffed one: ``device_encode.lut_possible``
holds lut_candidate's inequality at n_lut = 1, where it is weakest. The
first test holds that rule to the length formula itself, exhaustively: it
may skip only where no n_lut makes the LUT shorter.

The second holds the plain version, as the band codec (``encode_tiles``)
and the mosaic (``encode_tiles_batched``) call it, byte for byte to JAX's
``encode_tiles(..., enable_lut=True, mb=...)`` on chip_smoke.py's crafted
blocks (``k1lut_cases``: n_lut at the tie, equal and zero blocks, values
colliding in the count's set, masked blocks, an edge crop, depth-diff
LUTs, lossy int32, a tile stack): streams up to ``total``, totals, starts,
ranges and fits. At 16x16 the blocks stop at 11 bits (JAX's 16x16 records
do: wider ones clear its fits, ROADMAP queue 3); the uint32 case is left
out (JAX orders uint32 as int32, P6 in tests/test_torch_repairs.py), and so
are, to keep JAX's compiles few, the edge crop, the lossy int32 tile and
the 16x16 depth-3 tile (JAX compiles a depth-3 encode for ~25 s): chip_smoke
holds the kernel to the plain version on every case.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lerc_tpu.constants import DataType as JDT
from lerc_tpu.ops import device_encode as jenc
from lerc_tpu_torch.constants import DataType
from lerc_tpu_torch.ops import device_encode as enc


def test_skip_rule_only_where_no_lut_can_win():
    nb = np.arange(33)[:, None, None]
    cnt = np.arange(257)[None, :, None]
    n = np.arange(1, 255)[None, None, :]
    bits_n = np.floor(np.log2(n)).astype(np.int64) + 1
    skip = ~enc.lut_possible(nb[:, :, 0], cnt[:, :, 0])
    for cw in (1, 2):
        for off_w in (1, 2, 4):
            stuff = 1 + off_w + 1 + cw + (cnt * nb + 7) // 8
            lut = 2 + cw + off_w + 1 + (n * nb + 7) // 8 + (cnt * bits_n + 7) // 8
            wins = (lut < stuff).any(2)
            assert not (skip & wins).any(), (cw, off_w)
            # and the rule is tight: where it counts, n_lut = 1 wins
            assert (wins | skip).all(), (cw, off_w)
    # the tensor form agrees with the numpy one
    t = enc.lut_possible(torch.from_numpy(nb[:, :, 0]), torch.from_numpy(cnt[:, :, 0]))
    assert torch.equal(t, torch.from_numpy(~skip))


JDTS = {DataType.INT: JDT.INT, DataType.FLOAT: JDT.FLOAT, DataType.USHORT: JDT.USHORT,
        DataType.SHORT: JDT.SHORT}
CASES = [(mb, i) for mb in (8, 16)
         for i, c in enumerate(chip_smoke.k1lut_cases(mb, nb_max=16 if mb == 8 else 11))
         if not any(k in c[0] for k in ("uint32", "lossy", "crop") + ("depth 3",) * (mb == 16))]


def _jax_tile(data, mask, mze, dt, version, mb):
    h, w, d = data.shape
    cap = -(-(h * w * d * 4 + 4096) // 512) * 512  # JAX packs rows of 128 words
    out, total, zmn, zmx, starts, fits = jenc.encode_tiles(
        jnp.asarray(data), None if mask is None else jnp.asarray(mask), jnp.float32(mze), h, w,
        d, JDTS[dt], mask is None, version, cap, enable_lut=True, mb=mb)
    total = int(total)
    return (np.asarray(out)[:total].tobytes(), total, np.asarray(starts), np.asarray(zmn),
            np.asarray(zmx), bool(fits))


@pytest.mark.parametrize("mb,i", CASES, ids=[
    f"mb{mb}-{chip_smoke.k1lut_cases(mb, nb_max=16 if mb == 8 else 11)[i][0].split(' ', 2)[2]}"
    for mb, i in CASES])
def test_crafted_blocks_match_jax(mb, i):
    tag, data, dt, mze, mask, version, tiles = chip_smoke.k1lut_cases(
        mb, nb_max=16 if mb == 8 else 11)[i]
    h, w, d = data.shape
    x = torch.from_numpy(data)
    if tiles == 1:  # the band codec's call
        valid = None if mask is None else enc.block_valid_words(torch.from_numpy(mask), mb)
        stream, total, zmn, zmx, starts, fits = enc.encode_tiles(
            x, valid, mze, h, w, d, dt, mask is None, version, h * w * d * 4 + 4096,
            enable_lut=True, mb=mb)
        total = int(total)
        got = (stream.numpy().view(np.uint8)[:total].tobytes(), total, starts.numpy(),
               zmn.numpy(), zmx.numpy(), bool(fits))
        want = _jax_tile(data, mask, mze, dt, version, mb)
        assert got[:2] == want[:2], tag
        for a, b in zip(got[2:5], want[2:5]):
            np.testing.assert_array_equal(a, b, err_msg=tag)
        assert got[5] == want[5] and want[5], tag
        return
    # the mosaic's call: a stack of tiles of equal height, each JAX-encoded alone
    th = h // tiles
    tm = mask.reshape(tiles, th, w)
    stream, bases, totals, starts, zmn, zmx, fits = enc.encode_tiles_batched(
        x.reshape(tiles, th, w, d), torch.from_numpy(tm), mze, dt, version, mb)
    raw = stream.numpy().view(np.uint8)
    assert int(fits[0]) == 1
    for t in range(tiles):
        want = _jax_tile(data[t * th:(t + 1) * th], tm[t], mze, dt, version, mb)
        b, n = int(bases[t]), int(totals[t])
        assert (raw[b:b + n].tobytes(), n) == want[:2], (tag, t)
        np.testing.assert_array_equal(starts[t].numpy(), want[2], err_msg=f"{tag} tile {t}")
        if tm[t].any():  # an empty tile's range is the type's (max, min); JAX's reads 0
            np.testing.assert_array_equal(zmn[t].numpy(), want[3], err_msg=f"{tag} tile {t}")
            np.testing.assert_array_equal(zmx[t].numpy(), want[4], err_msg=f"{tag} tile {t}")
