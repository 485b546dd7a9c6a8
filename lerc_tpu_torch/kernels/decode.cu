// K4 decode_records: index-driven Lerc2 tile decode for float32 rasters
// with 8x8 micro blocks, all-valid or masked, with the exact double
// ScaleBack; its integer instances (decode_records_int) and K6
// decode_scanned follow the float kernels and are described there.
//
// Replaces lerc_tpu/ops/device_decode.py::decode_tiles_fast (:64) and
// _exact_f32_scale_back (:30, softfloat f64 in device_softf64.py), and for
// masks the expansion make_expander (device_encode.py:357). The TPU
// version gathers overlapping stride windows and extracts bits through
// static select chains or one-hot matmuls, routes masked values back
// through a log-shift roll network, and emulates f64 in u32 limbs; here
// one warp owns one record: it reads the record at starts[r] directly and
// dequantizes in native f64. In decode_records_masked_kernel position j
// reads the value at its rank among the block's valid positions (popc of
// the validity words below j, the words being the lane ballots) and
// invalid positions write +0.0.
//
// ScaleBack (Lerc2.h:381-399): z = (float)min(zMin + q * invScale, zMax)
// with one rounding per operation -- __dmul_rn and __dadd_rn, built with
// --fmad=false -- narrowed by __double2float_rn and clamped after
// narrowing with std::min's tie/NaN pick (zMax < z ? zMax : z).
//
// Bound: bytes (the stream's `total` bytes and 4 B of index per record
// read once, 8 B of validity words per record when masked, 4*H*W*D B of
// image written once).
//
// flags[0] (index_ok) drops when a record's parsed length disagrees with
// the next index entry, a stuffed count is not the block's valid count (64
// without a mask), or a LUT bit is set; flags[1] (fits) drops when a
// record is wider than the caller's bit cap.

#include <cstdint>
#include <cuda_runtime.h>

#include "record.cuh"

namespace {

constexpr int WARPS = 8;

__device__ __forceinline__ uint32_t rd(const uint8_t* s, long long pos, long long n) {
    return (pos >= 0 && pos < n) ? (uint32_t)s[pos] : 0u;
}

template <bool MASKED>
__device__ __forceinline__ void decode_records_body(
        const uint8_t* __restrict__ s, long long n_bytes, const int* __restrict__ starts,
        const int2* __restrict__ valid, const float* __restrict__ zmax, double inv, int w,
        int d, int nbh, int n_rec, int cap_nb, int lut_unfit, float* __restrict__ img,
        int* __restrict__ flags) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = blockIdx.x * WARPS + warp;
    if (r >= n_rec) return;  // warp-uniform
    const long long p = starts[r];

    // record header (Lerc2.cpp:1950-2021)
    const uint32_t flag = rd(s, p, n_bytes);
    const int mode = flag & 3, b67 = flag >> 6;
    const int off_w = b67 == 2 ? 1 : (b67 == 1 ? 2 : 4);
    uint32_t acc = rd(s, p + 1, n_bytes) | rd(s, p + 2, n_bytes) << 8
                 | rd(s, p + 3, n_bytes) << 16 | rd(s, p + 4, n_bytes) << 24;
    acc &= off_w == 1 ? 0xFFu : (off_w == 2 ? 0xFFFFu : 0xFFFFFFFFu);
    const float offset = b67 == 2 ? (float)(acc & 0xFF)
                       : b67 == 1 ? (float)(int16_t)(acc & 0xFFFF) : __uint_as_float(acc);
    const uint32_t nbb = rd(s, p + 1 + off_w, n_bytes);
    const int cw_code = nbb >> 6;
    const int cw = cw_code == 0 ? 4 : 3 - cw_code;
    const int nb = nbb & 31;
    const bool is_lut = (nbb & 32) && mode == 1;
    const int width = mode == 0 ? 32 : nb;
    const long long pay = mode == 0 ? p + 1 : p + 2 + off_w + cw;
    const uint64_t vmask = width == 32 ? 0xFFFFFFFFull : ((1ull << width) - 1);

    const int b = r / d, di = r % d;
    // validity words (the lane ballots of the block) and the value count
    uint32_t vw0 = 0xffffffffu, vw1 = 0xffffffffu;
    int cnt = 64;
    if constexpr (MASKED) {
        const int2 v = valid[b];
        vw0 = (uint32_t)v.x;
        vw1 = (uint32_t)v.y;
        cnt = __popc(vw0) + __popc(vw1);
    }
    const float zm = zmax[di];
    const int row0 = (b / nbh) * 8, col = (b % nbh) * 8 + (lane & 7);
    for (int k = 0; k < 2; ++k) {
        const int j = lane + 32 * k;
        int rank = j;  // the value's slot in the record
        if constexpr (MASKED) {
            const uint32_t lt = (1u << lane) - 1u;
            rank = k == 0 ? __popc(vw0 & lt) : __popc(vw0) + __popc(vw1 & lt);
        }
        float z;
        if (MASKED && !(((k ? vw1 : vw0) >> lane) & 1u)) {
            z = 0.f;
        } else if (mode == 2) {
            z = 0.f;
        } else if (mode == 3) {
            z = offset;
        } else {
            const long long bitpos = (long long)rank * width;
            const long long at = pay + (bitpos >> 3);
            uint64_t v = 0;
            for (int t = 0; t < 5; ++t) v |= (uint64_t)rd(s, at + t, n_bytes) << (8 * t);
            const uint32_t q = (uint32_t)((v >> (bitpos & 7)) & vmask);
            if (mode == 0) {
                z = __uint_as_float(q);
            } else {
                z = __double2float_rn(__dadd_rn((double)offset, __dmul_rn((double)q, inv)));
                z = zm < z ? zm : z;
            }
        }
        const int row = row0 + (j >> 3);
        img[((size_t)row * w + col) * d + di] = z;
    }

    if (lane == 0) {
        const uint32_t ne = rd(s, p + 2 + off_w, n_bytes)
                          | (cw == 2 ? rd(s, p + 3 + off_w, n_bytes) << 8 : 0u);
        const long long stuff_bytes = ((long long)ne * nb + 7) >> 3;
        const long long length = mode == 2 ? 1
                               : mode == 3 ? 1 + off_w
                               : mode == 0 ? 1 + 4 * cnt : 1 + off_w + 1 + cw + stuff_bytes;
        bool bad = (mode == 1 && (int)ne != cnt) || is_lut;
        if (r != n_rec - 1) {
            const int delta = (int)((uint32_t)starts[r + 1] - (uint32_t)starts[r]);
            bad |= delta != length;
        }
        if (bad) flags[0] = 0;
        if (((mode == 0 || mode == 1) && width > cap_nb) || (lut_unfit && is_lut)) flags[1] = 0;
    }
}

__global__ void decode_records_kernel(const uint8_t* __restrict__ s, long long n_bytes,
                                      const int* __restrict__ starts,
                                      const float* __restrict__ zmax, double inv,
                                      int w, int d, int nbh, int n_rec, int cap_nb,
                                      int lut_unfit, float* __restrict__ img,
                                      int* __restrict__ flags) {
    decode_records_body<false>(s, n_bytes, starts, nullptr, zmax, inv, w, d, nbh, n_rec,
                               cap_nb, lut_unfit, img, flags);
}

__global__ void decode_records_masked_kernel(const uint8_t* __restrict__ s, long long n_bytes,
                                             const int* __restrict__ starts,
                                             const int2* __restrict__ valid,
                                             const float* __restrict__ zmax, double inv,
                                             int w, int d, int nbh, int n_rec, int cap_nb,
                                             int lut_unfit, float* __restrict__ img,
                                             int* __restrict__ flags) {
    decode_records_body<true>(s, n_bytes, starts, valid, zmax, inv, w, d, nbh, n_rec,
                              cap_nb, lut_unfit, img, flags);
}

// ---------------------------------------------------------------------------
// Integer K4 (decode_tiles_fast :189-198, :390-408): offsets of each
// dtype's width with sign or zero extension (record.cuh), raw values of
// 1, 2 or 4 bytes, exact int32 min(offset + q * round(2 mze), zMax), the
// image in the native dtype. A diff record (flag bit 2 at version >= 5)
// clears index_ok: this decoder has no previous slice to add, and its
// offset is reduced as INT, so its length would be misread.
// ---------------------------------------------------------------------------

template <typename Tout, bool MASKED>
__global__ void decode_records_int_kernel(
        const uint8_t* __restrict__ s, long long n_bytes, const int* __restrict__ starts,
        const int2* __restrict__ valid, const int* __restrict__ zmax, int inv_i, int w, int d,
        int nbh, int n_rec, int dt, int size_t_, int is_signed, int diff_v5, int cap_nb,
        int lut_unfit, Tout* __restrict__ img, int* __restrict__ flags) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = blockIdx.x * WARPS + warp;
    if (r >= n_rec) return;  // warp-uniform
    const long long p = starts[r];

    const uint32_t flag = rd(s, p, n_bytes);
    const int mode = flag & 3, b67 = flag >> 6;
    const int off_w = lerc2::offset_width(dt, b67);
    uint32_t acc = rd(s, p + 1, n_bytes) | rd(s, p + 2, n_bytes) << 8
                 | rd(s, p + 3, n_bytes) << 16 | rd(s, p + 4, n_bytes) << 24;
    acc &= off_w == 1 ? 0xFFu : (off_w == 2 ? 0xFFFFu : 0xFFFFFFFFu);
    const int offset = lerc2::int_offset(acc, off_w, dt, b67);
    const uint32_t nbb = rd(s, p + 1 + off_w, n_bytes);
    const int cw_code = nbb >> 6;
    const int cw = cw_code == 0 ? 4 : 3 - cw_code;
    const int nb = nbb & 31;
    const bool is_lut = (nbb & 32) && mode == 1;
    const int width = mode == 0 ? 8 * size_t_ : nb;
    const long long pay = mode == 0 ? p + 1 : p + 2 + off_w + cw;
    const uint64_t vmask = width == 32 ? 0xFFFFFFFFull : ((1ull << width) - 1);

    const int b = r / d, di = r % d;
    uint32_t vw0 = 0xffffffffu, vw1 = 0xffffffffu;
    int cnt = 64;
    if constexpr (MASKED) {
        const int2 v = valid[b];
        vw0 = (uint32_t)v.x;
        vw1 = (uint32_t)v.y;
        cnt = __popc(vw0) + __popc(vw1);
    }
    const int zm = zmax[di];
    const int row0 = (b / nbh) * 8, col = (b % nbh) * 8 + (lane & 7);
    for (int k = 0; k < 2; ++k) {
        const int j = lane + 32 * k;
        int rank = j;
        if constexpr (MASKED) {
            const uint32_t lt = (1u << lane) - 1u;
            rank = k == 0 ? __popc(vw0 & lt) : __popc(vw0) + __popc(vw1 & lt);
        }
        int z;
        if (MASKED && !(((k ? vw1 : vw0) >> lane) & 1u)) {
            z = 0;
        } else if (mode == 2) {
            z = 0;
        } else if (mode == 3) {
            z = offset;
        } else {
            const long long bitpos = (long long)rank * width;
            const long long at = pay + (bitpos >> 3);
            uint64_t v = 0;
            for (int t = 0; t < 5; ++t) v |= (uint64_t)rd(s, at + t, n_bytes) << (8 * t);
            const uint32_t q = (uint32_t)((v >> (bitpos & 7)) & vmask);
            z = mode == 0 ? lerc2::raw_int(q, size_t_, is_signed)
                          : lerc2::int_scale_back(offset, q, inv_i, zm);
        }
        const int row = row0 + (j >> 3);
        img[((size_t)row * w + col) * d + di] = (Tout)z;
    }

    if (lane == 0) {
        const uint32_t ne = rd(s, p + 2 + off_w, n_bytes)
                          | (cw == 2 ? rd(s, p + 3 + off_w, n_bytes) << 8 : 0u);
        const long long stuff_bytes = ((long long)ne * nb + 7) >> 3;
        const long long length = mode == 2 ? 1
                               : mode == 3 ? 1 + off_w
                               : mode == 0 ? 1 + (long long)cnt * size_t_
                                           : 1 + off_w + 1 + cw + stuff_bytes;
        bool bad = (mode == 1 && (int)ne != cnt) || is_lut || (diff_v5 && (flag & 4));
        if (r != n_rec - 1) {
            const int delta = (int)((uint32_t)starts[r + 1] - (uint32_t)starts[r]);
            bad |= delta != length;
        }
        if (bad) flags[0] = 0;
        if (((mode == 0 || mode == 1) && width > cap_nb) || (lut_unfit && is_lut)) flags[1] = 0;
    }
}

template <typename Tout>
int launch_decode_int(const uint8_t* words, long long n_bytes, const int* starts,
                      const int* valid, const int* zmax, int inv_i, int h, int w, int d, int dt,
                      int size_t_, int is_signed, int diff_v5, int cap_nb, int lut_unfit,
                      void* img, int* flags, cudaStream_t st) {
    const int nbh = w / 8;
    const int n_rec = (h / 8) * nbh * d;
    const int grid = (n_rec + WARPS - 1) / WARPS;
    Tout* out = static_cast<Tout*>(img);
    if (valid)
        decode_records_int_kernel<Tout, true><<<grid, WARPS * 32, 0, st>>>(
            words, n_bytes, starts, reinterpret_cast<const int2*>(valid), zmax, inv_i, w, d,
            nbh, n_rec, dt, size_t_, is_signed, diff_v5, cap_nb, lut_unfit, out, flags);
    else
        decode_records_int_kernel<Tout, false><<<grid, WARPS * 32, 0, st>>>(
            words, n_bytes, starts, nullptr, zmax, inv_i, w, d, nbh, n_rec, dt, size_t_,
            is_signed, diff_v5, cap_nb, lut_unfit, out, flags);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K6 decode_scanned: decode from scanned record descriptors, a port of
// decode_tiles (device_decode.py:493-708) with _unpack_records (:464) for
// 8x8 aligned all-valid records: modes raw, stuff, const-0 and
// const-offset, float32 (the exact f64 ScaleBack, as K4) and every integer
// dtype. Each stream read clamps its index into the stream, as JAX's
// gathers do.
//
// The TPU version gathers five byte planes per value and resolves the
// integer depth-diff chain (:625-648) with a lax.scan over depth; here one
// warp owns one block and walks its D records in order, each lane keeping
// the previous slice of its two positions in registers: a diff record
// (mode >= 8) adds its offset (+ q * invScale) to the previous slice and
// clamps to zMax, a diff const-0 record copies it. ok drops where this
// kernel cannot be right: a float diff record (the exact f32 chain is
// queue 1 item 6), a raw diff record or a diff record on slice 0 (the host
// decoder rejects both), and a LUT record.
//
// Bound: bytes (the stream's `total` bytes and 16 B of descriptors per
// record read once, the image written once).
// ---------------------------------------------------------------------------

using lerc2::byte_clamped;

template <typename Tout, bool IS_INT>
__global__ void decode_scanned_kernel(
        const uint8_t* __restrict__ s, long long n_bytes, const int* __restrict__ mode,
        const int* __restrict__ payload_pos, const int* __restrict__ offset,
        const int* __restrict__ num_bits, const int* __restrict__ zmax, double inv, int inv_i,
        int w, int d, int nbh, int n_blocks, int size_t_, int is_signed,
        Tout* __restrict__ img, int* __restrict__ ok) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS + warp;
    if (b >= n_blocks) return;  // warp-uniform
    const int row0 = (b / nbh) * 8, col = (b % nbh) * 8 + (lane & 7);
    int prev[2] = {0, 0};  // this lane's two positions in the previous slice
    bool bad = false;
    for (int di = 0; di < d; ++di) {
        const int r = b * d + di;
        const int m = mode[r], m8 = m & 7, nb = num_bits[r];
        const bool dif = m >= 8;
        const long long pp = payload_pos[r];
        const int off = offset[r], zm = zmax[di];
        const uint32_t qmask = nb >= 32 ? 0xFFFFFFFFu : (1u << nb) - 1u;
        for (int k = 0; k < 2; ++k) {
            const int j = lane + 32 * k;
            const long long bitpos = (long long)j * nb;
            const long long at = pp + (bitpos >> 3);
            const int sh = (int)(bitpos & 7);
            uint32_t acc = 0;
            for (int t = 0; t < 4; ++t) acc |= byte_clamped(s, at + t, n_bytes) << (8 * t);
            const uint32_t hi = sh ? byte_clamped(s, at + 4, n_bytes) << (32 - sh) : 0u;
            const uint32_t q = ((acc >> sh) | hi) & qmask;
            const long long rb = pp + (long long)j * size_t_;
            uint32_t word = 0;
            for (int t = 0; t < size_t_; ++t) word |= byte_clamped(s, rb + t, n_bytes) << (8 * t);
            const int row = row0 + (j >> 3);
            const size_t at_img = ((size_t)row * w + col) * d + di;
            if constexpr (IS_INT) {
                const int a = (int)((uint32_t)off + q * (uint32_t)inv_i);
                int z = m8 == 0 ? lerc2::raw_int(word, size_t_, is_signed)
                      : m8 == 2 ? 0 : m8 == 3 ? off : min(a, zm);
                if (d > 1 && dif) {  // :621-622, :643-644
                    const int ad = m8 == 3 ? off : a;
                    z = m8 == 2 ? prev[k] : min((int)((uint32_t)ad + (uint32_t)prev[k]), zm);
                }
                prev[k] = z;
                img[at_img] = (Tout)z;
            } else {
                const float offf = __int_as_float(off), zmf = __int_as_float(zm);
                float zs = __double2float_rn(__dadd_rn((double)offf, __dmul_rn((double)q, inv)));
                zs = zmf < zs ? zmf : zs;
                img[at_img] = m8 == 0 ? __uint_as_float(word)
                            : m8 == 2 ? 0.f : m8 == 3 ? offf : zs;
            }
        }
        bad |= (dif && (!IS_INT || m8 == 0 || di == 0)) || m8 == 4;
    }
    if (lane == 0 && bad) ok[0] = 0;
}

template <typename Tout, bool IS_INT>
int launch_scanned(const uint8_t* words, long long n_bytes, const int* mode,
                   const int* payload_pos, const int* offset, const int* num_bits,
                   const int* zmax, double inv, int inv_i, int h, int w, int d, int size_t_,
                   int is_signed, void* img, int* ok, cudaStream_t st) {
    const int nbh = w / 8;
    const int n_blocks = (h / 8) * nbh;
    const int grid = (n_blocks + WARPS - 1) / WARPS;
    decode_scanned_kernel<Tout, IS_INT><<<grid, WARPS * 32, 0, st>>>(
        words, n_bytes, mode, payload_pos, offset, num_bits, zmax, inv, inv_i, w, d, nbh,
        n_blocks, size_t_, is_signed, static_cast<Tout*>(img), ok);
    return (int)cudaGetLastError();
}

}  // namespace

// Integer K4: img in the dtype `dt` (0..5), zmax [D] int32; flags as K4
extern "C" int decode_records_int(const uint8_t* words, long long n_bytes, const int* starts,
                                  const int* valid, const int* zmax, int inv_i, int h, int w,
                                  int d, int dt, int size_t_, int is_signed, int diff_v5,
                                  int cap_nb, int lut_unfit, void* img, int* flags,
                                  void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (dt) {
        case 0: return launch_decode_int<int8_t>(words, n_bytes, starts, valid, zmax, inv_i, h,
                                                 w, d, dt, size_t_, is_signed, diff_v5, cap_nb,
                                                 lut_unfit, img, flags, st);
        case 1: return launch_decode_int<uint8_t>(words, n_bytes, starts, valid, zmax, inv_i, h,
                                                  w, d, dt, size_t_, is_signed, diff_v5, cap_nb,
                                                  lut_unfit, img, flags, st);
        case 2: return launch_decode_int<int16_t>(words, n_bytes, starts, valid, zmax, inv_i, h,
                                                  w, d, dt, size_t_, is_signed, diff_v5, cap_nb,
                                                  lut_unfit, img, flags, st);
        case 3: return launch_decode_int<uint16_t>(words, n_bytes, starts, valid, zmax, inv_i,
                                                   h, w, d, dt, size_t_, is_signed, diff_v5,
                                                   cap_nb, lut_unfit, img, flags, st);
        case 4: return launch_decode_int<int32_t>(words, n_bytes, starts, valid, zmax, inv_i, h,
                                                  w, d, dt, size_t_, is_signed, diff_v5, cap_nb,
                                                  lut_unfit, img, flags, st);
        case 5: return launch_decode_int<uint32_t>(words, n_bytes, starts, valid, zmax, inv_i,
                                                   h, w, d, dt, size_t_, is_signed, diff_v5,
                                                   cap_nb, lut_unfit, img, flags, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// K6: dt 0..5 or 6 (float32: offset and zmax hold f32 bits); ok: 1 int32
// set to 1 by the caller
extern "C" int decode_scanned(const uint8_t* words, long long n_bytes, const int* mode,
                              const int* payload_pos, const int* offset, const int* num_bits,
                              const int* zmax, double inv, int inv_i, int h, int w, int d,
                              int dt, int size_t_, int is_signed, void* img, int* ok,
                              void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
#define K6_ARGS words, n_bytes, mode, payload_pos, offset, num_bits, zmax, inv, inv_i, h, w, d, \
                size_t_, is_signed, img, ok, st
    switch (dt) {
        case 0: return launch_scanned<int8_t, true>(K6_ARGS);
        case 1: return launch_scanned<uint8_t, true>(K6_ARGS);
        case 2: return launch_scanned<int16_t, true>(K6_ARGS);
        case 3: return launch_scanned<uint16_t, true>(K6_ARGS);
        case 4: return launch_scanned<int32_t, true>(K6_ARGS);
        case 5: return launch_scanned<uint32_t, true>(K6_ARGS);
        case 6: return launch_scanned<float, false>(K6_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
#undef K6_ARGS
}

// flags: 2 int32 set to 1 by the caller; valid: [nBlocks, 2] u32 validity
// words, or null for an all-valid image (then the all-valid kernel runs)
extern "C" int decode_records(const uint8_t* words, long long n_bytes, const int* starts,
                              const int* valid, const float* zmax, double inv, int h, int w,
                              int d, int cap_nb, int lut_unfit, float* img, int* flags,
                              void* stream) {
    const int nbh = w / 8;
    const int n_rec = (h / 8) * nbh * d;
    const int grid = (n_rec + WARPS - 1) / WARPS;
    if (valid)
        decode_records_masked_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
            words, n_bytes, starts, reinterpret_cast<const int2*>(valid), zmax, inv, w, d,
            nbh, n_rec, cap_nb, lut_unfit, img, flags);
    else
        decode_records_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
            words, n_bytes, starts, zmax, inv, w, d, nbh, n_rec, cap_nb, lut_unfit, img,
            flags);
    return (int)cudaGetLastError();
}
