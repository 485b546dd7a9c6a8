// Lerc2 record-header fields shared by the decode kernels (K4, K6) and the
// record scan (K5): the byte width and the value of a block offset for each
// dtype and reduced-type code (flag bits 6-7), and raw integer values.
//
// The tables are Lerc2.h:457-499 as the JAX decoders read them
// (lerc_tpu/ops/device_decode.py:189-226, device_scan.py:57-68, :149-179):
// a diff record (flag bit 2 at version >= 5) of an integer dtype reduces
// its offset as DataType INT (lerc2_decode.py:269), which the caller
// selects by passing DT_INT.
#pragma once

#include <algorithm>
#include <cstdint>

namespace lerc2 {

constexpr int DT_INT = 4;
constexpr int DT_UINT = 5;
constexpr int DT_FLOAT = 6;

// stream byte at pos, the index clamped into [0, n) as JAX's gathers do
// (the record scan and the scanned-record decode read this way)
__device__ __forceinline__ uint32_t byte_clamped(const uint8_t* s, long long pos, long long n) {
    return (uint32_t)s[pos < 0 ? 0 : (pos >= n ? n - 1 : pos)];
}

// offset byte width by dtype code (0..5 integers, 6 float) and bits 6-7
__device__ __forceinline__ int offset_width(int dt, int b67) {
    switch (dt) {
        case 0: case 1: return 1;                                // CHAR, BYTE
        case 2: case 3: return b67 > 0 ? 1 : 2;                  // SHORT, USHORT
        case 4: return b67 == 3 ? 1 : (b67 > 0 ? 2 : 4);         // INT
        default: return b67 == 2 ? 1 : (b67 == 1 ? 2 : 4);       // UINT, FLOAT
    }
}

// an integer offset from its off_w little-endian bytes in acc (higher bytes
// zero), sign-extended when its reduced type is signed: CHAR, SHORT as
// SHORT (tc 0) or CHAR (tc 2), INT as SHORT (tc 2); unsigned otherwise
__device__ __forceinline__ int int_offset(uint32_t acc, int off_w, int dt, int b67) {
    const bool s8 = dt == 0 || (dt == 2 && b67 == 2);
    const bool s16 = (dt == 4 && b67 == 2) || (dt == 2 && b67 == 0);
    if (off_w == 1) return s8 ? (int)(int8_t)(acc & 0xFFu) : (int)(acc & 0xFFu);
    if (off_w == 2) return s16 ? (int)(int16_t)(acc & 0xFFFFu) : (int)(acc & 0xFFFFu);
    return (int)acc;
}

// a float offset: byte (tc 2), short (tc 1) or the f32 bits
__device__ __forceinline__ float float_offset(uint32_t acc, int b67) {
    return b67 == 2 ? (float)(acc & 0xFFu)
         : b67 == 1 ? (float)(int16_t)(acc & 0xFFFFu) : __uint_as_float(acc);
}

// a raw integer value of `size` bytes, sign-extended for signed dtypes
__device__ __forceinline__ int raw_int(uint32_t v, int size, bool is_signed) {
    if (size == 1) return is_signed ? (int)(int8_t)(v & 0xFFu) : (int)(v & 0xFFu);
    if (size == 2) return is_signed ? (int)(int16_t)(v & 0xFFFFu) : (int)(v & 0xFFFFu);
    return (int)v;
}

// exact integer dequantization min(offset + q * inv_i, zmax) in int32
__device__ __forceinline__ int int_scale_back(int off, uint32_t q, int inv_i, int zmax) {
    return min((int)((uint32_t)off + q * (uint32_t)inv_i), zmax);
}

}  // namespace lerc2

// The strips of K4 and K6 (decode.cu) and of the integer K1
// (encode.cu): a CTA owns S consecutive mb x mb blocks of one block row with
// all their depths, a strip at most STRIP_PX pixels and STRIP_OUT bytes of
// image; on uint8 x 3 with 8x8 blocks S = 32 (6 KB). Where one block at
// full depth passes STRIP_OUT it is a strip of its own, its depths in
// chunks of dc, each chunk with `lead` slices before its own beside it (K1
// stages the slice before a chunk for its depth-diff candidate: lead 1).
// spr: strips a block row of width w. Mirrored for tests and chip_smoke.py
// by lerc_tpu_torch/ops/device_decode.py strip_shape.
constexpr int STRIP_PX = 2048;
constexpr int STRIP_OUT = 8192;

struct StripShape {
    int S;    // blocks a strip
    int dc;   // depths a chunk
    int spr;  // strips a block row
};

inline StripShape strip_shape(int mb, int w, int d, int size, int lead) {
    const int bp = mb * mb, pb = d * size;
    StripShape g;
    if ((long long)bp * pb <= STRIP_OUT) {
        g.S = std::max(1, std::min(STRIP_PX, STRIP_OUT / pb) / bp);
        g.dc = d;
    } else {
        g.S = 1;
        g.dc = std::max(1, STRIP_OUT / (bp * size) - lead);
    }
    g.spr = ((w + mb - 1) / mb + g.S - 1) / g.S;
    return g;
}
