"""BitStuffer2 wire format: lossless bit-packing of uint32 arrays.

The port's own copy of ``lerc_tpu/codec/bitstuffer.py``: bit widths and
sizes (:25-61), the LSB-first packing of versions >= 3 (:64-88), the
MSB-first packing of versions < 3 (:95-129), and the simple and LUT blocks
with their header (:148-222).

Wire format (BitStuffer2.{h,cpp} of the reference):

  header byte: bits 0-4 = numBits, bit 5 = LUT mode,
               bits 6-7 = element-count width code (0 -> 4 bytes, else 3 - n)
  numElements: 1, 2, or 4 bytes little-endian
  simple mode: ceil(numElements * numBits / 8) bytes of packed values
  LUT mode:    1 byte (nLut + 1), packed LUT values (numBits each, without
               the leading 0), then packed indices (bitlen(nLut) bits each)

Two packing orders exist on the wire:
  - lerc2Version >= 3: plain LSB-first bitstream (BitStuffer2.cpp:432-472)
  - legacy (< v3): MSB-first within little-endian uint32 words, with unused
    tail bytes of the final word squeezed out (BitStuffer2.cpp:292-348)

Unlike the JAX copy, the readers raise ValueError on a buffer too short for
what its header announces.
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


def compute_bytes_lut(sorted_vals: np.ndarray, num_elements: int) -> tuple[int, bool]:
    """(min(bytes_lut, bytes_simple), use_lut) of the sorted quantized values
    (ascending, starting at 0), as BitStuffer2::ComputeNumBytesNeededLut
    (BitStuffer2.cpp:262-287)."""
    max_elem = int(sorted_vals[-1])
    nb = num_bits_needed(max_elem)
    n_simple = 1 + _count_width(num_elements) + ((num_elements * nb + 7) >> 3)
    n_lut = int(np.count_nonzero(sorted_vals[1:] != sorted_vals[:-1]))
    nbits_lut = num_bits_needed(n_lut)
    n_lut_bytes = (1 + _count_width(num_elements) + 1 + ((n_lut * nb + 7) >> 3)
                   + ((num_elements * nbits_lut + 7) >> 3))
    return min(n_lut_bytes, n_simple), n_lut_bytes < n_simple


def bit_pack(values: np.ndarray, num_bits: int) -> bytes:
    """LSB-first bitstream (versions >= 3)."""
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


def _tail_bytes_not_needed(num_elements: int, num_bits: int) -> int:
    num_bits_tail = (num_elements * num_bits) & 31
    num_bytes_tail = (num_bits_tail + 7) >> 3
    return 4 - num_bytes_tail if num_bytes_tail > 0 else 0


def bit_pack_legacy(values: np.ndarray, num_bits: int) -> bytes:
    """MSB-first within little-endian uint32 words, the last word's unused
    tail bytes left out (versions < 3)."""
    if num_bits == 0 or values.size == 0:
        return b""
    n = values.size
    v = values.astype(np.uint32, copy=False)
    shifts = np.arange(num_bits - 1, -1, -1, dtype=np.uint32)  # MSB first
    bits = ((v[:, None] >> shifts[None, :]) & np.uint32(1)).astype(np.uint8).ravel()
    num_uints = (n * num_bits + 31) // 32
    padded = np.zeros(num_uints * 32, dtype=np.uint8)
    padded[: bits.size] = bits
    words = np.frombuffer(np.packbits(padded, bitorder="big").tobytes(), dtype=">u4").astype(np.uint32)
    ntbnn = _tail_bytes_not_needed(n, num_bits)
    if ntbnn:
        words[-1] >>= np.uint32(8 * ntbnn)
    return words.astype("<u4").tobytes()[: num_uints * 4 - ntbnn]


def bit_unpack_legacy(buf, num_elements: int, num_bits: int) -> tuple[np.ndarray, int]:
    """Returns (values, bytes_consumed) of the legacy order."""
    if num_bits == 0 or num_elements == 0:
        return np.zeros(num_elements, dtype=np.uint32), 0
    nbytes = (num_elements * num_bits + 7) >> 3
    if len(buf) < nbytes:
        raise ValueError("truncated bit-stuffed values")
    num_uints = (num_elements * num_bits + 31) // 32
    raw = np.zeros(num_uints * 4, dtype=np.uint8)
    raw[:nbytes] = np.frombuffer(memoryview(buf)[:nbytes], dtype=np.uint8)
    words = np.frombuffer(raw.tobytes(), dtype="<u4").astype(np.uint32)
    ntbnn = _tail_bytes_not_needed(num_elements, num_bits)
    if ntbnn:
        words[-1] <<= np.uint32(8 * ntbnn)
    bit_bytes = np.frombuffer(words.astype(">u4").tobytes(), dtype=np.uint8)
    bits = np.unpackbits(bit_bytes, count=num_elements * num_bits, bitorder="big")
    bits = bits.reshape(num_elements, num_bits).astype(np.uint32)
    powers = (np.uint32(1) << np.arange(num_bits - 1, -1, -1, dtype=np.uint32))[None, :]
    return (bits * powers).sum(axis=1, dtype=np.uint32), nbytes


def pack_for_version(values: np.ndarray, num_bits: int, lerc2_version: int) -> bytes:
    if lerc2_version >= 3:
        return bit_pack(values, num_bits)
    return bit_pack_legacy(values, num_bits)


def unpack_for_version(buf, num_elements: int, num_bits: int, lerc2_version: int):
    if lerc2_version >= 3:
        return bit_unpack(buf, num_elements, num_bits)
    return bit_unpack_legacy(buf, num_elements, num_bits)


def _block_header(num_bits: int, n: int, lut: bool) -> bytearray:
    w = _count_width(n)
    out = bytearray([num_bits | (int(lut) << 5) | ((0 if w == 4 else 3 - w) << 6)])
    out.extend(int(n).to_bytes(w, "little"))
    return out


def encode_simple(values: np.ndarray, lerc2_version: int) -> bytes:
    n = values.size
    if n == 0:
        raise ValueError("empty input")
    num_bits = num_bits_needed(int(values.max()))
    if num_bits >= 32:
        raise ValueError("numBits must be < 32")
    return bytes(_block_header(num_bits, n, False) + pack_for_version(values, num_bits,
                                                                       lerc2_version))


def encode_lut(values: np.ndarray, lerc2_version: int) -> bytes:
    """LUT mode: values must contain 0 (the block min maps to 0)."""
    n = values.size
    if np.min(values) != 0:
        raise ValueError("LUT mode requires a 0 value")
    uniq, inverse = np.unique(values, return_inverse=True)
    lut = uniq[1:]  # omit the leading 0
    n_lut = lut.size
    if n_lut < 1 or n_lut >= 255:
        raise ValueError("LUT size out of range")
    num_bits = num_bits_needed(int(lut[-1]))
    if num_bits <= 0 or num_bits >= 32:
        raise ValueError("numBits out of range for LUT mode")
    out = _block_header(num_bits, n, True)
    out.append(n_lut + 1)
    out.extend(pack_for_version(lut.astype(np.uint32), num_bits, lerc2_version))
    out.extend(pack_for_version(inverse.astype(np.uint32), num_bits_needed(n_lut), lerc2_version))
    return bytes(out)


def decode(buf, max_element_count: int, lerc2_version: int) -> tuple[np.ndarray, int]:
    """Returns (values, total bytes consumed) of a simple or LUT block."""
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
    if not do_lut:
        vals, used = unpack_for_version(src[pos:], n, num_bits, lerc2_version)
        return vals, pos + used
    if num_bits == 0 or len(src) < pos + 1:
        raise ValueError("corrupt LUT block")
    n_lut = src[pos] - 1
    pos += 1
    if n_lut < 1:
        raise ValueError("corrupt LUT block")
    lut, used = unpack_for_version(src[pos:], n_lut, num_bits, lerc2_version)
    pos += used
    idx, used = unpack_for_version(src[pos:], n, num_bits_needed(n_lut), lerc2_version)
    pos += used
    full_lut = np.concatenate([np.zeros(1, dtype=np.uint32), lut])
    if idx.size and int(idx.max()) >= full_lut.size:
        raise ValueError("LUT index out of range")
    return full_lut[idx], pos
