"""BitStuffer2 at versions >= 3: what the Huffman code table needs.

The port's own copy of the parts of ``lerc_tpu/codec/bitstuffer.py`` that
write and read the table's code lengths: ``num_bits_needed`` (:25),
``_count_width`` (:30), ``compute_bytes_simple`` (:34), ``bit_pack`` and
``bit_unpack`` (:64-88), ``encode_simple`` (:148) and ``decode`` (:191) for
simple (non-LUT) blocks, the only kind a code table holds.

Wire format (BitStuffer2.{h,cpp} of the reference):

  header byte: bits 0-4 = numBits, bit 5 = LUT mode,
               bits 6-7 = element-count width code (0 -> 4 bytes, else 3 - n)
  numElements: 1, 2, or 4 bytes little-endian
  simple mode: ceil(numElements * numBits / 8) bytes of packed values

Values pack as a plain LSB-first bitstream (BitStuffer2.cpp:432-472). The
legacy MSB-first order of versions < 3 is not here: versions < 3 are ROADMAP
queue 1 item 12 (the host codec). Unlike the JAX copy, ``decode`` raises
ValueError on a buffer too short for what its header announces.
"""
from __future__ import annotations

import numpy as np


def num_bits_needed(max_elem: int) -> int:
    """ceil(log2(maxElem + 1)); 0 for maxElem == 0."""
    return int(max_elem).bit_length()


def _count_width(num_elements: int) -> int:
    return 1 if num_elements < 256 else (2 if num_elements < 65536 else 4)


def compute_bytes_simple(num_elements: int, max_elem: int) -> int:
    nb = num_bits_needed(max_elem)
    return 1 + _count_width(num_elements) + ((num_elements * nb + 7) >> 3)


def bit_pack(values: np.ndarray, num_bits: int) -> bytes:
    if num_bits == 0 or values.size == 0:
        return b""
    v = values.astype(np.uint32, copy=False)
    shifts = np.arange(num_bits, dtype=np.uint32)
    bits = ((v[:, None] >> shifts[None, :]) & np.uint32(1)).astype(np.uint8)
    return np.packbits(bits.ravel(), bitorder="little").tobytes()


def bit_unpack(buf, num_elements: int, num_bits: int) -> tuple[np.ndarray, int]:
    """Returns (values, bytes_consumed)."""
    if num_bits == 0 or num_elements == 0:
        return np.zeros(num_elements, dtype=np.uint32), 0
    nbytes = (num_elements * num_bits + 7) >> 3
    if len(buf) < nbytes:
        raise ValueError("truncated bit-stuffed values")
    raw = np.frombuffer(memoryview(buf)[:nbytes], dtype=np.uint8)
    bits = np.unpackbits(raw, count=num_elements * num_bits, bitorder="little")
    bits = bits.reshape(num_elements, num_bits).astype(np.uint32)
    powers = (np.uint32(1) << np.arange(num_bits, dtype=np.uint32))[None, :]
    return (bits * powers).sum(axis=1, dtype=np.uint32), nbytes


def encode_simple(values: np.ndarray, lerc2_version: int) -> bytes:
    if lerc2_version < 3:
        raise NotImplementedError("versions < 3 (legacy bit order): ROADMAP queue 1 item 12")
    n = values.size
    if n == 0:
        raise ValueError("empty input")
    num_bits = num_bits_needed(int(values.max()))
    if num_bits >= 32:
        raise ValueError("numBits must be < 32")
    w = _count_width(n)
    out = bytearray([num_bits | ((0 if w == 4 else 3 - w) << 6)])
    out.extend(int(n).to_bytes(w, "little"))
    out.extend(bit_pack(values, num_bits))
    return bytes(out)


def decode(buf, max_element_count: int, lerc2_version: int) -> tuple[np.ndarray, int]:
    """Returns (values, total bytes consumed) of a simple block."""
    if lerc2_version < 3:
        raise NotImplementedError("versions < 3 (legacy bit order): ROADMAP queue 1 item 12")
    src = memoryview(buf)
    if len(src) < 1:
        raise ValueError("truncated bit-stuffed block")
    header = src[0]
    pos = 1
    bits67 = header >> 6
    w = 4 if bits67 == 0 else 3 - bits67
    do_lut = bool(header & (1 << 5))
    num_bits = header & 31
    if len(src) < pos + w:
        raise ValueError("truncated bit-stuffed block")
    n = int.from_bytes(src[pos : pos + w], "little")
    pos += w
    if n > max_element_count:
        raise ValueError("element count exceeds limit")
    if do_lut:  # no LERC encoder writes a code table in LUT mode (Huffman::WriteCodeTable)
        raise ValueError("bit-stuffed block in LUT mode where a simple one belongs")
    vals, used = bit_unpack(src[pos:], n, num_bits)
    return vals, pos + used
