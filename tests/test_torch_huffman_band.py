"""Port parity for 8-bit whole-image Huffman through the band codec:
``encode_band_device`` / ``decode_band_device`` of the port (plain PyTorch
versions, device="cpu") against JAX's and the host decoder, on 48x41 bands.

Criteria (exact): blobs byte-equal to JAX ``encode_band_device`` and the
acceleration index equal (the mode byte asserted, so no case is vacuous);
decodes bit-equal to the host decoder ``lerc2_decode.decode_band`` and to
JAX's ``decode_band_device`` with the port's own index, with JAX's index and
without one (the host lengths-only scan), and JAX's decode with the port's
index; foreign blobs of the host ``BandEncoder``; where JAX's decode returns
None (codes of 31 and 32 bits, more than 2^16 masked-delta segments), equal
to the host decoder; a corrupt stream and a tampered index raise ValueError.

JAX compiles one program per (H, W, D, dtype, version, masked), ~5 s at
depth 1 and ~25 s at depth 3 on a CPU: the cases share one shape, the JAX
blobs are made once per module, and depth 3 meets JAX in one configuration
(masked, both modes; the all-valid depth-3 streams meet JAX's H1/H2 in
tests/test_torch_huffman.py and the host decoder here).
"""
import struct

import numpy as np
import pytest

from lerc_tpu.codec import device_codec as jax_codec
from lerc_tpu.codec import fletcher32 as jax_fletcher32
from lerc_tpu.codec import header as jax_hdr
from lerc_tpu.codec import huffman as jax_huff
from lerc_tpu.codec import lerc2_decode
from lerc_tpu.codec.lerc2_encode import BandEncoder
from lerc_tpu.constants import DataType as JaxDT
from lerc_tpu_torch import decode_band_device, encode_band_device
from lerc_tpu_torch.codec import header as hdr
from lerc_tpu_torch.codec.device_codec import band_sections, huffman_section

from .test_torch_band import _bits, assert_decodes_like_the_host
from .test_torch_huffman import H, W, band, stripes

MASKS = {"none": None, "rand": np.random.default_rng(9).random((H, W)) > 0.3,
         "stripes": stripes()}
DIRECT, DELTA = 2, 1  # the image-encode-mode byte (Lerc2.h:143)
CASES = [  # (id, dtype, depth, data, mask, version, mode)
    ("u8-direct-v6", np.uint8, 1, "flags", "none", 6, DIRECT),
    ("u8-delta-v6", np.uint8, 1, "smooth", "none", 6, DELTA),
    ("u8-direct-v6-rand", np.uint8, 1, "flags", "rand", 6, DIRECT),
    ("u8-delta-v6-rand", np.uint8, 1, "smooth", "rand", 6, DELTA),
    ("u8-direct-v6-stripes", np.uint8, 1, "flags", "stripes", 6, DIRECT),
    ("u8-delta-v6-stripes", np.uint8, 1, "smooth", "stripes", 6, DELTA),
    ("u8-direct-v4", np.uint8, 1, "flags", "none", 4, DIRECT),
    ("u8-delta-v4", np.uint8, 1, "smooth", "none", 4, DELTA),
    ("u8-delta-v3", np.uint8, 1, "smooth", "none", 3, DELTA),
    ("i8-direct-v6", np.int8, 1, "flags", "none", 6, DIRECT),
    ("i8-delta-v6", np.int8, 1, "smooth", "none", 6, DELTA),
    ("i8-delta-v4-stripes", np.int8, 1, "smooth", "stripes", 4, DELTA),
    ("i8-direct-v4-rand", np.int8, 1, "flags", "rand", 4, DIRECT),
    ("i8-d3-delta-v6-rand", np.int8, 3, "smooth", "rand", 6, DELTA),
    ("i8-d3-direct-v6-stripes", np.int8, 3, "flags", "stripes", 6, DIRECT),
]
BY_ID = {c[0]: c[1:] for c in CASES}


def case_data(case_id):
    npdt, d, kind, mname, _v, _m = BY_ID[case_id]
    seed = {"flags": 1, "smooth": 2}[kind]
    data = band(npdt, d, kind, seed=seed)
    if kind == "flags" and npdt == np.int8:
        data = (data.astype(np.int16) - 100).astype(np.int8)  # negative codes too
    return data, MASKS[mname]


@pytest.fixture(scope="module")
def jax_blobs():
    """JAX's (blob, index) of each case, made on first use."""
    cache = {}

    def get(case_id):
        if case_id not in cache:
            data, mask = case_data(case_id)
            version = BY_ID[case_id][4]
            cache[case_id] = jax_codec.encode_band_device(data, mask, 0.5, version=version,
                                                          return_index=True)
        return cache[case_id]
    return get


def mode_byte(blob: bytes) -> int | None:
    """The image-encode-mode byte of a Huffman blob (None for other kinds)."""
    sec = band_sections(blob)
    return sec.mode if sec.kind == "huffman" else None


@pytest.mark.parametrize("case_id", list(BY_ID))
def test_huffman_blob_and_index_match_jax(case_id, jax_blobs):
    data, mask = case_data(case_id)
    version, mode = BY_ID[case_id][4:]
    jblob, jindex = jax_blobs(case_id)
    assert mode_byte(jblob) == mode
    sec = huffman_section(jblob)
    assert sec.n_groups == jindex["huffman_sbits"].size
    assert sec.stream_pos + sec.stream.size == len(jblob)
    blob, index = encode_band_device(data, mask, 0.5, version=version, return_index=True,
                                     device="cpu")
    assert blob == jblob
    assert index.keys() == jindex.keys() == {"huffman_sbits"}
    assert index["huffman_sbits"].dtype == np.int32
    np.testing.assert_array_equal(index["huffman_sbits"], jindex["huffman_sbits"])
    assert encode_band_device(data, mask, 0.5, version=version, device="cpu") == blob


@pytest.mark.parametrize("case_id", list(BY_ID))
def test_huffman_decode_matches_host_and_jax(case_id, jax_blobs):
    data, mask = case_data(case_id)
    jblob, jindex = jax_blobs(case_id)
    _, pindex = encode_band_device(data, mask, 0.5, version=BY_ID[case_id][4],
                                   return_index=True, device="cpu")
    host = lerc2_decode.decode_band(jblob)
    sel = np.ones((H, W), bool) if mask is None else mask
    np.testing.assert_array_equal(host.data[sel], data[sel])
    for index in (pindex, jindex, None):
        got = decode_band_device(jblob, index=index, device="cpu")
        np.testing.assert_array_equal(_bits(got.data.numpy()), _bits(host.data))
    assert_decodes_like_the_host(jblob, jax_too=False)  # header, mask, ranges, consumed
    jd = jax_codec.decode_band_device(jblob, index=pindex)  # the port's index fed to JAX
    assert jd is not None
    np.testing.assert_array_equal(_bits(np.asarray(jd.data)), _bits(host.data))


FOREIGN = [  # (id, dtype, depth, data, mask): depth 3 all-valid here only
    ("u8-delta", np.uint8, 1, "smooth", "none"), ("u8-direct-rand", np.uint8, 1, "flags", "rand"),
    ("i8-delta-d3-stripes", np.int8, 3, "smooth", "stripes"),
    ("u8-direct-d3", np.uint8, 3, "flags", "none"), ("i8-delta-d3", np.int8, 3, "smooth", "none"),
]


@pytest.mark.parametrize("npdt,d,kind,mname", [c[1:] for c in FOREIGN], ids=[c[0] for c in FOREIGN])
def test_host_band_encoder_blobs_decode_like_the_host(npdt, d, kind, mname):
    data = band(npdt, d, kind, seed=7)
    blob = BandEncoder(data, MASKS[mname], 0.5).encode()
    assert mode_byte(blob) in (DIRECT, DELTA)
    port = assert_decodes_like_the_host(blob, jax_too=False)
    sel = np.ones((H, W), bool) if MASKS[mname] is None else MASKS[mname]
    np.testing.assert_array_equal(port.data.numpy()[sel], data[sel])


def test_stripes_512_delta_beyond_jax_segment_cap():
    """A 512^2 band under a vertical-stripes mask: every valid pixel below
    row 0 deltas against the pixel above (130,816 segments). JAX's decode
    gives up above 2^16 segments; the port decodes, equal to the host."""
    n = 512
    mask = stripes(n, n)
    x, y = np.meshgrid(np.arange(n), np.arange(n))
    data = ((x // 3 + y // 5) % 256).astype(np.uint8)[:, :, None]
    blob = BandEncoder(data, mask, 0.5).encode()
    assert mode_byte(blob) == DELTA
    assert jax_codec.decode_band_device(blob) is None
    port = assert_decodes_like_the_host(blob, jax_too=False)
    np.testing.assert_array_equal(port.data.numpy()[mask], data[mask])


def _refix(blob: bytearray, version: int) -> bytes:
    skip = hdr.checksum_skip(version)
    struct.pack_into("<I", blob, skip - 4, jax_fletcher32.fletcher32(bytes(blob[skip:])))
    return bytes(blob)


def test_codes_of_31_and_32_bits_decode_like_the_host():
    """A hand-built direct Huffman blob whose code table has lengths 1..31,
    32, 32 (a valid canonical code no tree of these counts would give):
    JAX's decode returns None (int32 constants), the port equals the host."""
    rng = np.random.default_rng(11)
    lengths = np.zeros(256, np.int32)
    used = rng.permutation(256)[:33]
    lengths[used[:31]] = np.arange(1, 32)
    lengths[used[31:]] = 32
    codes = jax_huff.canonical_codes(lengths)
    data = rng.choice(used, (H, W, 1)).astype(np.uint8)
    data.reshape(-1)[:33] = used  # every code, the 32-bit ones included
    head = jax_hdr.HeaderInfo(version=6, n_rows=H, n_cols=W, n_depth=1, num_valid_pixel=H * W,
                              micro_block_size=8, dt=JaxDT.BYTE, max_z_error=0.5,
                              z_min=float(data.min()), z_max=float(data.max()))
    body = (struct.pack("<i", 0) + np.array([data.min(), data.max()], np.uint8).tobytes()
            + b"\x00" + bytes([DIRECT]) + jax_huff.write_code_table(lengths, codes, 6)
            + jax_huff.encode_symbols(data.reshape(-1).astype(np.int64), lengths, codes))
    head.blob_size = jax_hdr.header_size(6) + len(body)
    blob = _refix(bytearray(jax_hdr.write_header(head) + body), 6)
    assert jax_codec.decode_band_device(blob) is None
    port = assert_decodes_like_the_host(blob, jax_too=False)
    np.testing.assert_array_equal(port.data.numpy(), data)


def test_corrupt_stream_and_tampered_index_raise(jax_blobs):
    blob, index = jax_blobs("u8-delta-v6-rand")
    sb = index["huffman_sbits"]
    for bad in (sb + np.where(np.arange(sb.size) == 5, 1, 0).astype(np.int32), sb[:-1],
                np.full_like(sb, 0)):
        with pytest.raises(ValueError, match="sidecar inconsistent"):
            decode_band_device(blob, index={"huffman_sbits": bad}, device="cpu")
    # the stream cut short, blob size and checksum refixed: the scan runs out
    head, _ = hdr.read_header(blob)
    cut = bytearray(blob[:-64])
    struct.pack_into("<i", cut, 6 + 4 + 4 + 4 * 5, len(cut))
    cut = _refix(cut, head.version)
    with pytest.raises(ValueError):
        lerc2_decode.decode_band(cut)
    with pytest.raises(ValueError):
        decode_band_device(cut, device="cpu")
    with pytest.raises(ValueError):
        decode_band_device(cut, index=index, device="cpu")


def test_verify_and_the_one_sweep_rule():
    """verify decodes the fresh Huffman blob; a noise band takes the
    one-sweep body (no mode byte, no index) where its values are no larger
    than the Huffman stream plus the mode byte, as JAX."""
    data, mask = case_data("u8-delta-v6-rand")
    blob, index = encode_band_device(data, mask, 0.5, verify=True, return_index=True, device="cpu")
    assert index is not None
    noise = np.random.default_rng(2).integers(0, 256, (H, W, 1)).astype(np.uint8)
    blob = encode_band_device(noise, None, 0.5, return_index=True, device="cpu")
    assert blob == jax_codec.encode_band_device(noise, None, 0.5, return_index=True)
    assert band_sections(blob[0]).kind == "one_sweep" and blob[1] is None
