"""The host lengths-only Huffman scan (``kernels/huffman_scan.cpp``) and its
plain Python version.

Port of ``lerc_tpu/native/__init__.py::huffman_group_offsets`` (:136-155)
over ``lerc_native.cpp::lerc_huffman_group_offsets`` (:604). A foreign blob
(no encoder sidecar) has no group boundaries to decode in parallel from: a
serial walk over the code lengths finds each 64-symbol group's first bit,
and H3 decodes the groups in parallel from there, checking each offset
against the lengths it decodes. ``huffman_group_offsets`` calls the compiled
scan (built by ``kernels.build`` with the host compiler on first use);
``huffman_group_offsets_ref`` finds the same offsets in numpy by pointer
doubling over the bit positions. The band decoder calls the compiled scan
on every device (it is host code); the plain version is what the tests hold
it to. Both raise ValueError on a corrupt stream or a maximum code length
<= 0 or > 32.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..kernels import build


def _check(buf, lengths, codes, group_counts):
    buf = np.ascontiguousarray(np.frombuffer(buf, np.uint8) if isinstance(buf, (bytes, memoryview))
                               else buf, dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    codes = np.ascontiguousarray(codes, dtype=np.uint32)
    group_counts = np.ascontiguousarray(group_counts, dtype=np.int32)
    if lengths.shape != codes.shape or lengths.ndim != 1:
        raise ValueError("lengths and codes must be 1-D arrays of one size")
    return buf, lengths, codes, group_counts


def huffman_group_offsets(buf, lengths, codes, group_counts) -> np.ndarray:
    """Compiled scan: int32 [n_groups] first bit of each group of
    group_counts[g] wire symbols in the stream `buf` (uint8)."""
    buf, lengths, codes, group_counts = _check(buf, lengths, codes, group_counts)
    fn = build.library("huffman_scan").huffman_group_offsets
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int64
    out = np.zeros(group_counts.size, dtype=np.int32)
    used = fn(buf.ctypes.data, buf.size, lengths.ctypes.data, codes.ctypes.data, lengths.size,
              group_counts.size, group_counts.ctypes.data, out.ctypes.data)
    build.LAUNCHES["huffman_scan"] += 1
    if used < 0:
        raise ValueError("corrupt huffman stream")
    return out


def huffman_group_offsets_ref(buf, lengths, codes, group_counts) -> np.ndarray:
    """Plain numpy version of the scan, by another road: the code length at
    every bit position of the stream's whole words (the 32-bit window there
    against the canonical range of each length), a jump table p -> p + len
    (or a dead end where no code fits), its powers J^(2^k) for k < 7, and
    each group's count of symbols taken from them in binary."""
    buf, lengths, codes, group_counts = _check(buf, lengths, codes, group_counts)
    max_len = int(lengths.max(initial=0))
    if max_len <= 0 or max_len > 32:
        raise ValueError("corrupt huffman stream")
    n_w = buf.size // 4
    total_bits = 32 * n_w
    words = np.concatenate([np.frombuffer(buf[:4 * n_w].tobytes(), "<u4").astype(np.uint64),
                            np.zeros(2, np.uint64)])
    p = np.arange(total_bits, dtype=np.int64)
    sh = (p & 31).astype(np.uint64)
    peek = ((words[p >> 5] << sh) | (words[(p >> 5) + 1] >> (np.uint64(32) - sh))) & 0xFFFFFFFF
    length = np.zeros(total_bits, np.int64)
    for L in range(1, max_len + 1):
        sel = codes[lengths == L].astype(np.uint64)
        if sel.size:
            c = peek >> np.uint64(32 - L)
            length[(length == 0) & (c >= sel.min()) & (c < sel.min() + np.uint64(sel.size))] = L
    dead = total_bits + 1  # positions 0..total_bits, then the dead end
    jump = np.full(total_bits + 2, dead, np.int64)
    ok = (length > 0) & (p + length <= total_bits)
    jump[:total_bits][ok] = (p + length)[ok]
    powers = [jump]
    for _ in range(6):
        powers.append(powers[-1][powers[-1]])
    out = np.zeros(group_counts.size, dtype=np.int32)
    pos = 0
    for g, cnt in enumerate(group_counts.tolist()):
        out[g] = pos
        k = 0
        while cnt:
            if cnt & 1:
                pos = int(powers[k][pos])
            cnt >>= 1
            k += 1
        if pos == dead:
            raise ValueError("corrupt huffman stream")
    return out
