"""Canonical Huffman code tables for 8-bit LERC data.

The port's own copy of ``lerc_tpu/codec/huffman.py``: the code-length tree
(:40), canonical codes (:72), the compressed size (:92), the bin range with
its wrap-around (:105), the table size (:132), the MSB-first word packing
(:150, :175) and the table's wire I/O (:185, :196); and
``canonical_decode_consts`` from ``lerc_tpu/ops/device_huffman.py:247``,
without its ``<= 30`` assert: the rows are int64 here, so code lengths 31
and 32 decode too.

Wire format (Huffman.{h,cpp} of the reference):

  code table:
    int32 huffmanVersion (4), int32 size (256), int32 i0, int32 i1
    BitStuffer2-simple packed code lengths for bins [i0, i1) (index mod size)
    codes bit-packed MSB-first into little-endian uint32 words
  symbol stream:
    codes pushed MSB-first into little-endian uint32 words
    (Huffman.h:218-255), padded with one extra uint32 (Lerc2.cpp:2464).

Code lengths come from a min-heap Huffman tree whose ties break by insertion
serial, as in the JAX package: another tie-break gives other lengths, and
then other blob bytes.
"""
from __future__ import annotations

import heapq
import struct

import numpy as np

from . import bitstuffer

HUFFMAN_VERSION = 4


def compute_code_lengths(histo: np.ndarray) -> np.ndarray | None:
    """Huffman code length per symbol; None if < 2 nonempty bins or len > 32."""
    size = histo.size
    heap: list[tuple[int, int, object]] = []
    serial = 0
    for i in range(size):
        if histo[i] > 0:
            heap.append((int(histo[i]), serial, ("leaf", i)))
            serial += 1
    if len(heap) < 2:
        return None
    heapq.heapify(heap)
    while len(heap) > 1:
        w0, _, n0 = heapq.heappop(heap)
        w1, _, n1 = heapq.heappop(heap)
        heapq.heappush(heap, (w0 + w1, serial, ("node", n0, n1)))
        serial += 1
    lengths = np.zeros(size, dtype=np.int32)

    stack = [(heap[0][2], 0)]
    while stack:
        node, depth = stack.pop()
        if node[0] == "leaf":
            lengths[node[1]] = max(depth, 0)
            if depth > 32:
                return None
        else:
            stack.append((node[1], depth + 1))
            stack.append((node[2], depth + 1))
    return lengths


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Assign canonical codes given lengths (Huffman.cpp:541-572)."""
    size = lengths.size
    codes = np.zeros(size, dtype=np.uint32)
    keys = np.where(lengths > 0, lengths.astype(np.int64) * size - np.arange(size), 0)
    order = np.argsort(-keys, kind="stable")
    order = order[keys[order] > 0]
    if order.size == 0:
        return codes
    code_len = int(lengths[order[0]])
    code = 0
    for idx in order:
        delta = code_len - int(lengths[idx])
        code >>= delta
        code_len -= delta
        codes[idx] = code
        code += 1
    return codes


def compute_compressed_size(histo: np.ndarray, lengths: np.ndarray) -> int:
    """Total bytes for code table + coded stream (Huffman.cpp:85-111)."""
    table = compute_code_table_size(lengths)
    if table is None:
        return -1
    num_bits = int((histo * lengths).sum())
    num_elem = int(histo.sum())
    if num_elem == 0:
        return -1
    num_uints = ((((num_bits + 7) >> 3) + 3) >> 2) + 1  # +1 read-ahead pad
    return table + 4 * num_uints


def get_range(lengths: np.ndarray) -> tuple[int, int, int]:
    """(i0, i1, maxLen) with optional wrap-around (Huffman.cpp:383-438)."""
    size = lengths.size
    nz = np.flatnonzero(lengths > 0)
    if nz.size == 0:
        raise ValueError("empty code table")
    i0, i1 = int(nz[0]), int(nz[-1]) + 1
    # largest stretch of zero bins anywhere
    best_k0, best_len = 0, 0
    j = 0
    while j < size:
        while j < size and lengths[j] > 0:
            j += 1
        k0 = j
        while j < size and lengths[j] == 0:
            j += 1
        if j - k0 > best_len:
            best_k0, best_len = k0, j - k0
    if size - best_len < i1 - i0:
        i0 = best_k0 + best_len
        i1 = best_k0 + size  # wrap around
    max_len = int(max(lengths[np.mod(np.arange(i0, i1), size)]))
    if max_len <= 0 or max_len > 32:
        raise ValueError("bad code lengths")
    return i0, i1, max_len


def compute_code_table_size(lengths: np.ndarray) -> int | None:
    try:
        i0, i1, max_len = get_range(lengths)
    except ValueError:
        return None
    size = lengths.size
    idx = np.mod(np.arange(i0, i1), size)
    total_code_bits = int(lengths[idx].sum())
    n = 4 * 4
    n += bitstuffer.compute_bytes_simple(i1 - i0, max_len)
    n += 4 * (((total_code_bits + 7) >> 3) + 3 >> 2)
    return n


def pack_codes_msb(values: np.ndarray, lengths: np.ndarray, pad_uints: int = 0) -> bytes:
    """Concatenate (value, length) pairs MSB-first into LE uint32 words
    (Huffman::PushValue), padded to a whole word and `pad_uints` more."""
    total_bits = int(lengths.sum())
    if total_bits == 0:
        return b"\0" * (4 * pad_uints)
    max_len = int(lengths.max())
    shifts = np.arange(max_len - 1, -1, -1, dtype=np.uint32)
    allbits = ((values[:, None].astype(np.uint32) >> shifts[None, :]) & np.uint32(1)).astype(np.uint8)
    keep = shifts[None, :] < lengths[:, None].astype(np.uint32)
    bits = allbits[keep]  # row-major: per element, its bits MSB-first
    num_uints = (total_bits + 31) // 32
    padded = np.zeros(num_uints * 32, dtype=np.uint8)
    padded[:total_bits] = bits
    words = np.frombuffer(np.packbits(padded, bitorder="big").tobytes(), dtype=">u4")
    return words.astype("<u4").tobytes() + b"\0" * (4 * pad_uints)


def unpack_bits_msb(buf, num_words: int) -> np.ndarray:
    """Expand `num_words` LE uint32 words to an MSB-first bit array (uint8)."""
    words = np.frombuffer(memoryview(buf)[: 4 * num_words], dtype="<u4")
    return np.unpackbits(np.frombuffer(words.astype(">u4").tobytes(), dtype=np.uint8),
                         bitorder="big")


def write_code_table(lengths: np.ndarray, codes: np.ndarray, lerc2_version: int) -> bytes:
    i0, i1, _ = get_range(lengths)
    size = lengths.size
    idx = np.mod(np.arange(i0, i1), size)
    out = bytearray(struct.pack("<4i", HUFFMAN_VERSION, size, i0, i1))
    out += bitstuffer.encode_simple(lengths[idx].astype(np.uint32), lerc2_version)
    sel = idx[lengths[idx] > 0]
    out += pack_codes_msb(codes[sel], lengths[sel])
    return bytes(out)


def read_code_table(buf, lerc2_version: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Returns (lengths, codes, bytes consumed); ValueError on a corrupt or
    truncated table."""
    src = memoryview(buf)
    if len(src) < 16:
        raise ValueError("truncated huffman code table")
    version, size, i0, i1 = struct.unpack_from("<4i", src, 0)
    pos = 16
    if version < 2:
        raise ValueError("unsupported huffman version")
    if i0 >= i1 or i0 < 0 or size <= 0 or size > (1 << 15) or i1 - i0 > size:
        raise ValueError("corrupt huffman code table")
    lens_packed, used = bitstuffer.decode(src[pos:], i1 - i0, lerc2_version)
    if lens_packed.size != i1 - i0:
        raise ValueError("corrupt huffman code table")
    pos += used
    lengths = np.zeros(size, dtype=np.int32)
    idx = np.mod(np.arange(i0, i1), size)
    lengths[idx] = lens_packed.astype(np.int32)
    if int(lengths.max(initial=0)) > 32:
        raise ValueError("corrupt huffman code lengths")
    sel = idx[lengths[idx] > 0]
    total_bits = int(lengths[sel].sum())
    num_words = (total_bits + 31) // 32
    if len(src) - pos < 4 * num_words:
        raise ValueError("truncated huffman code table")
    bits = unpack_bits_msb(src[pos:], num_words)
    codes = np.zeros(size, dtype=np.uint32)
    off = 0
    for k in sel:
        ln = int(lengths[k])
        v = 0
        for b in bits[off : off + ln]:
            v = (v << 1) | int(b)
        codes[k] = v
        off += ln
    pos += 4 * num_words
    return lengths, codes, pos


def canonical_decode_consts(lengths: np.ndarray, codes: np.ndarray):
    """Canonical decode constants of a code table of at most 256 symbols:
    (consts [33, 3] int64 rows (first, first + count, base) per code length,
    sorted_syms [256] uint8). Canonical codes of one length are consecutive
    integers, so a prefix c of length L with first_L <= c < first_L +
    count_L is symbol sorted_syms[base_L + c - first_L] (Huffman.cpp:541-572).
    Raises ValueError when a length's codes are not consecutive (no LERC
    encoder writes such a table) or a code does not fit its length."""
    if lengths.size > 256:
        raise ValueError("Huffman code table of more than 256 symbols on 8-bit data")
    consts = np.zeros((33, 3), np.int64)
    sorted_syms = np.zeros(256, np.uint8)
    base = 0
    for L in range(1, 33):
        sel = np.nonzero(lengths == L)[0]
        if sel.size == 0:
            continue  # first == first + count: the length never matches
        cs = codes[sel].astype(np.int64)
        order = np.argsort(cs, kind="stable")
        first = int(cs[order[0]])
        if not np.array_equal(cs[order], first + np.arange(sel.size)) \
                or first + sel.size > (1 << L):
            raise ValueError("non-canonical huffman code table")
        sorted_syms[base : base + sel.size] = sel[order]
        consts[L] = (first, first + sel.size, base)
        base += sel.size
    return consts, sorted_syms
