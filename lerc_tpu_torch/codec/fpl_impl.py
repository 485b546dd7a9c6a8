"""What the lossless float path (fpl, Lerc2 v6 "delta-delta Huffman") needs on
the host: the port's own copy of the parts of ``lerc_tpu/codec/fpl_impl.py``
that the band codec uses.

Wire format of the section (fpl_Lerc2Ext.cpp:405-430): one predictor byte
(0 none, 1 delta along rows, 2 rows then columns), then per byte plane of
the float transform's words: u8 byte index, u8 delta level (<= MAX_DELTA),
u32 payload size, payload. A payload's first byte is its method: Huffman
(a code table written at version 5 and the MSB-first stream), RLE-const
(value + u32 count), raw bytes or PackBits.

The slice geometry (:301): a band of depth 1 is an [H, W] image, a deeper one
an [H * W, D] image (fpl_Lerc2Ext.cpp:432-454). PackBits (:162, :209) runs on
the host, as in the JAX package: a serial byte protocol, on the planes where
runs dominate.
"""
from __future__ import annotations

import numpy as np

MAX_DELTA = 5
PRIME_MULT = 7  # the entropy estimate counts every 7th position

# payload method bytes (fpl_EsriHuffman.cpp:243)
M_HUFFMAN = 0
M_RLE = 1
M_RAW = 2
M_PACKBITS = 3


def slice_shape(h: int, w: int, d: int) -> tuple[int, int]:
    """(rows, cols) of the image the fpl section codes."""
    return (h * w, d) if d > 1 else (h, w)


def encode_packbits(data: np.ndarray) -> bytes:
    """TIFF-style PackBits of a uint8 plane (fpl_EsriHuffman.cpp:83-165):
    equal runs of 2..129 bytes as (127 + len - 1, byte), the single bytes
    left over as literal stretches of at most 128 (len - 1, bytes)."""
    n = data.size
    out = bytearray()
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(data[1:], data[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    lengths = np.diff(np.append(starts, n))
    lit_len = 0  # pending literal bytes, ending just before the current run

    def flush_literals(end):
        nonlocal lit_len
        while lit_len > 0:
            take = min(lit_len, 128)
            s = end - lit_len
            out.append(take - 1)
            out.extend(data[s : s + take].tobytes())
            lit_len -= take

    for s, ln in zip(starts.tolist(), lengths.tolist()):
        pos, rem = s, ln
        while rem >= 2:
            chunk = min(rem, 129)
            if lit_len:
                flush_literals(pos)
            out.append(127 + chunk - 1)
            out.append(int(data[pos]))
            pos += chunk
            rem -= chunk
        if rem == 1:
            lit_len += 1
    if lit_len:
        flush_literals(n)
    return bytes(out)


def decode_packbits(buf, expected: int) -> np.ndarray:
    """The `expected` bytes of a PackBits stream; ValueError when the stream
    is corrupt or its output has another size."""
    out = np.zeros(expected, dtype=np.uint8)
    curr = 0
    i = 0
    size = len(buf)
    while i < size:
        b = buf[i]
        i += 1
        if b <= 127:
            ln = b + 1
            if curr + ln > expected or i + ln > size:
                raise ValueError("corrupt PackBits stream")
            out[curr : curr + ln] = np.frombuffer(buf[i : i + ln], dtype=np.uint8)
            curr += ln
            i += ln
        else:
            ln = b - 126
            if curr + ln > expected or i >= size:
                raise ValueError("corrupt PackBits stream")
            out[curr : curr + ln] = buf[i]
            curr += ln
            i += 1
    if curr != expected:
        raise ValueError("PackBits output size mismatch")
    return out
