"""Host Fletcher-32 over byte blobs, and the partial sums of a static segment.

Matches the modified Fletcher used by Lerc2 (Lerc2.cpp:1037-1064): bytes pair
big-endian into 16-bit words, both sums start at 0xffff, and an odd trailing
byte counts as (byte << 8). Instead of the serial fold-every-359-words loop
the two sums are taken with 64-bit chunked reductions, reduced mod 65535
between chunks. The true (unfolded) sums are always > 0, so the reference's
double-fold representative of x is 65535 when x % 65535 == 0.

The port's own copies of ``lerc_tpu/codec/fletcher32.py::fletcher32`` (numpy
path) and ``lerc_tpu/ops/device_scan.py::fletcher32_partials``.
"""
from __future__ import annotations

import numpy as np

_CHUNK = 1 << 20  # words per chunk; keeps the weighted sum < 2^52


def _rep(x_mod: int) -> int:
    return 65535 if x_mod == 0 else x_mod


def fletcher32(data: bytes | bytearray | memoryview | np.ndarray) -> int:
    buf = np.frombuffer(memoryview(data), dtype=np.uint8)
    n = buf.size
    nwords = n // 2
    hi = buf[0 : 2 * nwords : 2].astype(np.uint64)
    lo = buf[1 : 2 * nwords : 2].astype(np.uint64)
    words = (hi << np.uint64(8)) | lo
    if n & 1:
        words = np.concatenate([words, np.array([int(buf[-1]) << 8], dtype=np.uint64)])
    m = words.size

    s1 = 0
    s2 = 0
    for start in range(0, m, _CHUNK):
        chunk = words[start : start + _CHUNK]
        b = chunk.size
        w = np.arange(b, 0, -1, dtype=np.uint64)
        csum = int(chunk.sum())
        cwsum = int(np.multiply(w, chunk, dtype=np.uint64).sum())
        s2 = (s2 + b * s1 + cwsum) % 65535
        s1 = (s1 + csum) % 65535
    return (_rep(s2) << 16 | _rep(s1)) & 0xFFFFFFFF


def fletcher32_partials(data: bytes, word_base: int) -> tuple[int, int]:
    """(A, B) = (sum w_j, sum i_j * w_j) mod 65535 over the big-endian
    16-bit words of a static message segment, i_j the global message-word
    index starting at `word_base`. The segment starts at an even message
    byte and has even length. Fletcher32's closed form is linear in these
    sums, so a segment that never changes between calls contributes two
    constants."""
    arr = np.frombuffer(data, np.uint8)
    if arr.size % 2:
        raise ValueError("static Fletcher32 segment must have even length")
    words = (arr[0::2].astype(np.int64) << 8) | arr[1::2]
    idx = word_base + np.arange(words.size, dtype=np.int64)
    return int(words.sum() % 65535), int((idx * words).sum() % 65535)
