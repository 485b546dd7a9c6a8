"""Byte-run RLE codec of the validity-mask section of a Lerc2 blob.

The port's own copy of ``lerc_tpu/codec/rle.py`` (``compress`` :33,
``decompress`` :91, ``decompressed_length`` :119). Wire format (Esri
RLE.{h,cpp}):

  stream := { int16_le count, payload }* , int16_le -32768 (EOF)
  count > 0  -> literal run: `count` verbatim bytes follow
  count < 0  -> repeat run: one byte follows, repeated `-count` times

Counts are capped at +/-32767. The encoder opens a repeat run only after
seeing ``MIN_NUM_EVEN`` (5) equal bytes with enough lookahead room
(RLE.cpp:171-177); byte-exact output reproduces that greedy rule with
vectorized run segmentation instead of the reference's per-byte state
machine.
"""
from __future__ import annotations

import numpy as np

MIN_NUM_EVEN = 5
EOF = -32768
_CAP = 32767


def _segments(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Maximal equal-value run starts and lengths."""
    n = arr.size
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(arr[1:], arr[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    lengths = np.diff(np.append(starts, n))
    return starts, lengths


def compress(arr: np.ndarray | bytes) -> bytes:
    if isinstance(arr, np.ndarray):
        arr = arr.astype(np.uint8, copy=False).ravel()
    else:
        arr = np.frombuffer(memoryview(arr), dtype=np.uint8)
    n = arr.size
    if n == 0:
        raise ValueError("empty input")

    starts, lengths = _segments(arr)
    # a maximal run becomes a repeat run iff it has >= MIN_NUM_EVEN bytes and
    # the switch check has lookahead room: start + MIN_NUM_EVEN < n (RLE.cpp:173)
    is_repeat = (lengths >= MIN_NUM_EVEN) & (starts + MIN_NUM_EVEN < n)

    out = bytearray()

    def emit_count(c: int) -> None:
        out.extend(int(c).to_bytes(2, "little", signed=True))

    i = 0
    nseg = starts.size
    while i < nseg:
        if is_repeat[i]:
            s, ln = int(starts[i]), int(lengths[i])
            b = arr[s]
            # caps fire while equal pairs are scanned; the last increment
            # happens at the run boundary: (ln - 1) // CAP full chunks
            remaining = ln
            while remaining > _CAP:
                emit_count(-_CAP)
                out.append(b)
                remaining -= _CAP
            emit_count(-remaining)
            out.append(b)
            i += 1
        else:
            # consecutive non-repeat segments form one literal stretch
            j = i
            while j < nseg and not is_repeat[j]:
                j += 1
            s = int(starts[i])
            e = int(starts[j]) if j < nseg else n
            remaining = e - s
            pos = s
            while remaining > _CAP:
                emit_count(_CAP)
                out.extend(arr[pos : pos + _CAP].tobytes())
                remaining -= _CAP
                pos += _CAP
            emit_count(remaining)
            out.extend(arr[pos:e].tobytes())
            i = j

    emit_count(EOF)
    return bytes(out)


def decompress(blob: bytes | memoryview, expected_size: int | None = None) -> bytes:
    src = memoryview(blob)
    out = bytearray()
    pos = 0
    while True:
        if pos + 2 > len(src):
            raise ValueError("truncated RLE stream")
        cnt = int.from_bytes(src[pos : pos + 2], "little", signed=True)
        pos += 2
        if cnt == EOF:
            break
        if cnt > 0:
            if pos + cnt > len(src):
                raise ValueError("truncated RLE literal run")
            out.extend(src[pos : pos + cnt])
            pos += cnt
        else:
            if pos + 1 > len(src):
                raise ValueError("truncated RLE repeat run")
            out.extend(bytes([src[pos]]) * (-cnt))
            pos += 1
        if expected_size is not None and len(out) > expected_size:
            raise ValueError("RLE output exceeds expected size")
    if expected_size is not None and len(out) != expected_size:
        raise ValueError(f"RLE output size {len(out)} != expected {expected_size}")
    return bytes(out)


def decompressed_length(blob: bytes | memoryview) -> int:
    """Number of bytes the RLE section takes in the blob (for a cursor)."""
    src = memoryview(blob)
    pos = 0
    while True:
        cnt = int.from_bytes(src[pos : pos + 2], "little", signed=True)
        pos += 2
        if cnt == EOF:
            return pos
        pos += cnt if cnt > 0 else 1
