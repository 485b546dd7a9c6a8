// K4 decode_records: index-driven Lerc2 tile decode for float32 rasters
// with 8x8 micro blocks, all-valid or masked, with the exact double
// ScaleBack; its integer instances (decode_records_int), K6 decode_scanned
// (the band decoder's, and the index-free resident decode's) and the
// mosaic's K4 (decode_records_lut: LUT records, 16x16 blocks, n units a
// launch) follow the float kernels and are described there.
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
#include <type_traits>

#include "record.cuh"

namespace {

constexpr int WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

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
// K6 decode_scanned: decode from record descriptors (of the device scan K5 or
// the host scanner), a port of decode_tiles (device_decode.py:493-708) with
// _unpack_records (:464): 8x8 and 16x16 blocks, all-valid, masked or with
// edge blocks, modes raw, stuff, const-0, const-offset and LUT (mode 4:
// index i -> [0] + entries at lut_pos), float32 (the exact f64 ScaleBack,
// as K4), float64 and every integer dtype, and the depth-diff chains. Each
// stream read clamps its index into the stream, as JAX's gathers do.
//
// float64 (Tout = double) replaces decode_tiles_f64 (device_decode.py
// :716-879), whose ScaleBack and diff chain are softfloat u32 limb
// arithmetic (device_softf64.py) that JAX's band decoder leaves to the host
// for subnormal or non-finite offsets, an extreme invScale or a sum that
// underflows. Here they are native: z = off + q * invScale (__dmul_rn, then
// __dadd_rn), then (zMax < z) ? zMax : z (std::min's pick, NaN included);
// a diff record adds the pre-clamp sum (or the const offset) to the previous
// slice with __dadd_rn and clamps the same way. Offsets of any reduced type
// arrive from the scanner as f64; raw values are 8 bytes.
//
// One warp owns one block and walks its D records in order; lane `lane`
// holds positions j = 32k + lane (k < VPL = MB*MB/32) and keeps the previous
// slice of its positions in registers. A record writes its values at the
// valid positions, by their rank among them (popc of the validity words
// below j) -- or, for a stuffed or LUT record whose count equals the block's
// in-image area, at every in-image position (decode_tiles:538-548, the host
// decoder's full-block case); raw and const-offset records write the valid
// positions only (:593). A diff record (mode >= 8) adds its offset (+ q *
// invScale) to the previous slice: integers in int32, float32 as
// (float)min(a + (double)prev, zMax) with a the pre-clamp f64 sum
// offset + q * invScale (:650-698), float64 as min(a + prev, zMax); a diff
// const-0 record copies the previous slice.
//
// ok drops where the host decoder (lerc2_decode.py:233-306, bitstuffer.py
// :191-222) refuses the block: a stuffed count over the block's in-image
// area, or under its valid count and not the area; a LUT index past the LUT
// (every stuffed index is checked); a raw diff record; a diff record on
// slice 0.
//
// Bound: bytes (the stream's `total` bytes and 32 B of descriptors per
// record read once (36 B with an f64 offset), 4*VPL B of validity words per
// masked block, the image written once).
// ---------------------------------------------------------------------------

using lerc2::byte_clamped;

// value i of `width` bits (LSB-first) in the bit stream at byte pos
__device__ __forceinline__ uint32_t extract(const uint8_t* s, long long n_bytes, long long pos,
                                            long long i, int width) {
    const long long bitpos = i * width;
    const long long at = pos + (bitpos >> 3);
    const int sh = (int)(bitpos & 7);
    uint32_t acc = 0;
    for (int t = 0; t < 4; ++t) acc |= byte_clamped(s, at + t, n_bytes) << (8 * t);
    const uint32_t hi = sh ? byte_clamped(s, at + 4, n_bytes) << (32 - sh) : 0u;
    const uint32_t qmask = width >= 32 ? 0xFFFFFFFFu : (1u << width) - 1u;
    return ((acc >> sh) | hi) & qmask;
}

template <typename Tout, bool IS_INT, int MB, bool MASKED>
__global__ void decode_scanned_kernel(
        const uint8_t* __restrict__ s, long long n_bytes, const int* __restrict__ mode,
        const int* __restrict__ payload_pos, const int* __restrict__ offset,
        const int* __restrict__ num_bits, const int* __restrict__ num_elements,
        const int* __restrict__ lut_pos, const int* __restrict__ n_lut,
        const int* __restrict__ nbits_lut, const uint32_t* __restrict__ valid,
        const int* __restrict__ zmax, double inv, int inv_i, int h, int w, int d, int nbh,
        int n_blocks, int size_t_, int is_signed, Tout* __restrict__ img, int* __restrict__ ok) {
    constexpr int VPL = MB * MB / 32;
    constexpr bool F64 = std::is_same<Tout, double>::value;
    using V = typename std::conditional<IS_INT, int, Tout>::type;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS + warp;
    if (b >= n_blocks) return;  // warp-uniform
    const int row0 = (b / nbh) * MB, col0 = (b % nbh) * MB;
    const uint32_t lt = (1u << lane) - 1u;
    uint32_t iw[VPL], vw[VPL];  // in-image and valid positions, as ballots
    int cnt = 0, area = 0;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
        const unsigned j = 32 * k + lane;
        iw[k] = __ballot_sync(FULL, row0 + (int)(j / MB) < h && col0 + (int)(j % MB) < w);
        vw[k] = MASKED ? valid[(size_t)b * VPL + k] & iw[k] : iw[k];
        cnt += __popc(vw[k]);
        area += __popc(iw[k]);
    }
    V prev[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k) prev[k] = 0;
    bool bad = false;
    for (int di = 0; di < d; ++di) {
        const int r = b * d + di;
        const int m = mode[r], m8 = m & 7, nb = num_bits[r], ne = num_elements[r];
        const bool dif = m >= 8, stuffed = m8 == 1 || m8 == 4;
        const long long pp = payload_pos[r];
        const int off = F64 ? 0 : offset[r];
        const double off64 = F64 ? reinterpret_cast<const double*>(offset)[r] : 0.0;
        const bool use_all = stuffed && ne == area;
        bad |= (stuffed && (ne > area || (ne != area && ne < cnt))) || (dif && (m8 == 0 || di == 0));
        if (m8 == 4) {  // every stuffed index must lie in the LUT (bitstuffer.py:220)
            const int nl = n_lut[r], nbl = nbits_lut[r];
            for (int i = lane; i < min(ne, MB * MB); i += 32)
                bad |= (int)extract(s, n_bytes, pp, i, nbl) > nl;
        }
        int base = 0;  // the rank of position 32k among the written positions
#pragma unroll
        for (int k = 0; k < VPL; ++k) {
            const uint32_t ew = use_all ? iw[k] : vw[k];
            const bool e = (ew >> lane) & 1u, v = (vw[k] >> lane) & 1u;
            const int rank = base + __popc(ew & lt);
            base += __popc(ew);
            uint32_t q = 0;
            unsigned long long word = 0;
            if (e && stuffed) {
                if (m8 == 4) {
                    const uint32_t idx = extract(s, n_bytes, pp, rank, nbits_lut[r]);
                    q = idx ? extract(s, n_bytes, lut_pos[r], (long long)idx - 1, nb) : 0u;
                } else {
                    q = extract(s, n_bytes, pp, rank, nb);
                }
            }
            if (m8 == 0 && v) {
                const long long rb = pp + (long long)rank * size_t_;
                for (int t = 0; t < size_t_; ++t)
                    word |= (unsigned long long)byte_clamped(s, rb + t, n_bytes) << (8 * t);
            }
            const bool write = (m8 == 3 || m8 == 0) ? v : e;
            V z;
            if constexpr (IS_INT) {
                const int zm = zmax[di];
                const int a = (int)((uint32_t)off + q * (uint32_t)inv_i);
                z = m8 == 0 ? lerc2::raw_int((uint32_t)word, size_t_, is_signed)
                  : m8 == 2 ? 0 : m8 == 3 ? off
                  : std::is_same<Tout, uint32_t>::value  // uint32: the clamp in u32 order
                      ? (int)min((uint32_t)a, (uint32_t)zm) : min(a, zm);
                if (dif) {  // :621-622, :643-644
                    const int ad = m8 == 3 ? off : a;
                    z = m8 == 2 ? prev[k] : min((int)((uint32_t)ad + (uint32_t)prev[k]), zm);
                }
            } else if constexpr (F64) {  // native f64: no narrowing
                const double zm = reinterpret_cast<const double*>(zmax)[di];
                const double a = __dadd_rn(off64, __dmul_rn((double)q, inv));
                z = m8 == 0 ? __longlong_as_double((long long)word)
                  : m8 == 2 ? 0.0 : m8 == 3 ? off64 : (zm < a ? zm : a);
                if (dif) {
                    const double ad = m8 == 3 ? off64 : a;
                    const double t = __dadd_rn(ad, prev[k]);
                    z = m8 == 2 ? prev[k] : (zm < t ? zm : t);
                }
            } else {
                const float offf = __int_as_float(off), zmf = __int_as_float(zmax[di]);
                const double a = __dadd_rn((double)offf, __dmul_rn((double)q, inv));
                float zs = __double2float_rn(a);
                zs = zmf < zs ? zmf : zs;
                z = m8 == 0 ? __uint_as_float((uint32_t)word) : m8 == 2 ? 0.f : m8 == 3 ? offf : zs;
                if (dif) {  // :650-698
                    const double ad = m8 == 3 ? (double)offf : a;
                    float t = __double2float_rn(__dadd_rn(ad, (double)prev[k]));
                    t = zmf < t ? zmf : t;
                    z = m8 == 2 ? prev[k] : t;
                }
            }
            if (!write) z = 0;
            prev[k] = z;
            const unsigned j = 32 * k + lane;
            const int row = row0 + (int)(j / MB), col = col0 + (int)(j % MB);
            if ((iw[k] >> lane) & 1u) img[((size_t)row * w + col) * d + di] = (Tout)z;
        }
    }
    if (__any_sync(FULL, bad) && lane == 0) ok[0] = 0;
}

template <typename Tout, bool IS_INT, int MB, bool MASKED>
int launch_scanned(const uint8_t* words, long long n_bytes, const int* mode,
                   const int* payload_pos, const int* offset, const int* num_bits,
                   const int* num_elements, const int* lut_pos, const int* n_lut,
                   const int* nbits_lut, const int* valid, const int* zmax, double inv, int inv_i,
                   int h, int w, int d, int size_t_, int is_signed, void* img, int* ok,
                   cudaStream_t st) {
    const int nbh = (w + MB - 1) / MB;
    const int n_blocks = ((h + MB - 1) / MB) * nbh;
    const int grid = (n_blocks + WARPS - 1) / WARPS;
    decode_scanned_kernel<Tout, IS_INT, MB, MASKED><<<grid, WARPS * 32, 0, st>>>(
        words, n_bytes, mode, payload_pos, offset, num_bits, num_elements, lut_pos, n_lut,
        nbits_lut, reinterpret_cast<const uint32_t*>(valid), zmax, inv, inv_i, h, w, d, nbh,
        n_blocks, size_t_, is_signed, static_cast<Tout*>(img), ok);
    return (int)cudaGetLastError();
}

// the (block size, mask) instance of one output type
template <typename Tout, bool IS_INT>
int launch_scanned_of(int mb, const uint8_t* words, long long n_bytes, const int* mode,
                      const int* payload_pos, const int* offset, const int* num_bits,
                      const int* num_elements, const int* lut_pos, const int* n_lut,
                      const int* nbits_lut, const int* valid, const int* zmax, double inv,
                      int inv_i, int h, int w, int d, int size_t_, int is_signed, void* img,
                      int* ok, cudaStream_t st) {
#define K6_ARGS words, n_bytes, mode, payload_pos, offset, num_bits, num_elements, lut_pos, n_lut, \
                nbits_lut, valid, zmax, inv, inv_i, h, w, d, size_t_, is_signed, img, ok, st
    if (mb == 8)
        return valid ? launch_scanned<Tout, IS_INT, 8, true>(K6_ARGS)
                     : launch_scanned<Tout, IS_INT, 8, false>(K6_ARGS);
    if (mb == 16)
        return valid ? launch_scanned<Tout, IS_INT, 16, true>(K6_ARGS)
                     : launch_scanned<Tout, IS_INT, 16, false>(K6_ARGS);
#undef K6_ARGS
    return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// K4 for the mosaic (decode_records_lut, decode_records_lut16): the indexed
// decode with LUT records, 8x8 or 16x16 blocks and n units (tiles, or a
// tile's bands) in one record axis -- decode_tiles_fast with enable_lut
// (:233-247, :325-341), mb = 16 (:118-123) and n_tiles (:92-95). Record r
// belongs to unit u = r / unit_rec; starts are absolute byte offsets into
// the one stream, zmax is [n_units, D] and the validity words are the
// units' blocks in order. One warp owns one record; lane `lane` decodes
// positions j = 32k + lane (k < VPL = MB*MB/32).
//
// A LUT record (mode 1, numBits byte bit 5) is [header][count][nLut + 1]
// [nLut entries at numBits][indices at bit_length(nLut) bits]
// (BitStuffer2.cpp:79-153): value j reads its index at its rank, then entry
// index - 1 (index 0 is 0, the block minimum). There is no 128-lane window:
// 16x16 records of any width up to the dtype's decode (JAX caps them at 11
// bits, :118-123); `fits` only means no record is wider than cap_nb.
//
// float32 dequantizes with the exact f64 ScaleBack of K4; integers as the
// integer K4, uint32 with an unsigned zMax clamp. Per unit the kernel
// reports {index_ok, fits, diff}: index_ok drops on a record whose parsed
// length disagrees with the next index entry (each unit's last record is
// exempt), a stuffed count other than the block's valid count, or a LUT
// bit when lut is 0; diff is set by a depth-diff record (flag bit 2 at
// version >= 5), kept apart from index errors -- its offset is reduced as
// INT for integers, so its length is still checked -- and the caller
// decodes such units with the previous slice, through K6.
//
// Bound: bytes (the units' stream bytes and 4 B of index per record read
// once, 4*VPL B of validity words per masked block, the images written once).
// ---------------------------------------------------------------------------

// value i of `width` bits (LSB-first) at byte pos; bytes outside the stream
// read 0, as K4's window
__device__ __forceinline__ uint32_t extract_z(const uint8_t* s, long long n_bytes, long long pos,
                                              long long i, int width) {
    const long long bitpos = i * width;
    const long long at = pos + (bitpos >> 3);
    const int sh = (int)(bitpos & 7);
    uint64_t v = 0;
    for (int t = 0; t < 5; ++t) v |= (uint64_t)rd(s, at + t, n_bytes) << (8 * t);
    const uint64_t qmask = width >= 32 ? 0xFFFFFFFFull : ((1ull << width) - 1);
    return (uint32_t)((v >> sh) & qmask);
}

template <typename Tout, bool IS_INT, int MB, bool MASKED>
__global__ void decode_records_lut_kernel(
        const uint8_t* __restrict__ s, long long n_bytes, const int* __restrict__ starts,
        const uint32_t* __restrict__ valid, const int* __restrict__ zmax, double inv, int inv_i,
        int h, int w, int d, int nbh, int unit_rec, int n_rec, int dt, int size_t_,
        int is_signed, int version5, int lut, int cap_nb, Tout* __restrict__ img,
        int* __restrict__ flags) {
    constexpr int VPL = MB * MB / 32;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = blockIdx.x * WARPS + warp;
    if (r >= n_rec) return;  // warp-uniform
    const int u = r / unit_rec, rr = r - u * unit_rec;
    const int b = rr / d, di = rr - b * d;
    const long long p = starts[r];

    const uint32_t flag = rd(s, p, n_bytes);
    const int mode = flag & 3, b67 = flag >> 6;
    const bool dif = version5 && (flag & 4u);
    const int off_w = lerc2::offset_width(IS_INT && dif ? lerc2::DT_INT : dt, b67);
    uint32_t acc = rd(s, p + 1, n_bytes) | rd(s, p + 2, n_bytes) << 8
                 | rd(s, p + 3, n_bytes) << 16 | rd(s, p + 4, n_bytes) << 24;
    acc &= off_w == 1 ? 0xFFu : (off_w == 2 ? 0xFFFFu : 0xFFFFFFFFu);
    const uint32_t nbb = rd(s, p + 1 + off_w, n_bytes);
    const int cw_code = nbb >> 6;
    const int cw = cw_code == 0 ? 4 : 3 - cw_code;
    const int nb = nbb & 31;
    const bool is_lut = (nbb & 32) && mode == 1;
    const int n_lut = is_lut ? (int)rd(s, p + 2 + off_w + cw, n_bytes) - 1 : 0;
    const int nbits_lut = n_lut > 0 ? 32 - __clz(n_lut) : 0;
    const int lut_bytes = (n_lut * nb + 7) >> 3;
    const long long pay = mode == 0 ? p + 1 : p + 2 + off_w + cw + (is_lut ? 1 : 0);
    const int width = mode == 0 ? 8 * size_t_ : nb;

    const uint32_t lt = (1u << lane) - 1u;
    uint32_t vw[VPL];
    int cnt = MB * MB;
    if constexpr (MASKED) {
        cnt = 0;
        const size_t blk = (size_t)u * (unit_rec / d) + b;
#pragma unroll
        for (int k = 0; k < VPL; ++k) {
            vw[k] = valid[blk * VPL + k];
            cnt += __popc(vw[k]);
        }
    }
    const int zm = zmax[u * d + di];
    const size_t base = (size_t)u * h;
    const int row0 = (b / nbh) * MB, col0 = (b % nbh) * MB;
    int before = 0;  // valid positions before 32k
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
        const unsigned j = 32 * k + lane;
        int rank = (int)j;
        bool v = true;
        if constexpr (MASKED) {
            rank = before + __popc(vw[k] & lt);
            before += __popc(vw[k]);
            v = (vw[k] >> lane) & 1u;
        }
        uint32_t q = 0;
        if (v && (mode == 0 || mode == 1)) {
            if (is_lut) {
                const uint32_t idx = extract_z(s, n_bytes, pay + lut_bytes, rank, nbits_lut);
                q = idx ? extract_z(s, n_bytes, pay, (long long)idx - 1, nb) : 0u;
            } else {
                q = extract_z(s, n_bytes, pay, rank, width);
            }
        }
        Tout z;
        if constexpr (IS_INT) {
            const int off = lerc2::int_offset(acc, off_w, IS_INT && dif ? lerc2::DT_INT : dt, b67);
            int zi;
            if (mode == 0) {
                zi = lerc2::raw_int(q, size_t_, is_signed);
            } else if (mode == 2) {
                zi = 0;
            } else if (mode == 3) {
                zi = off;
            } else {
                const uint32_t a = (uint32_t)off + q * (uint32_t)inv_i;
                zi = dt == 5 ? (int)(a < (uint32_t)zm ? a : (uint32_t)zm) : min((int)a, zm);
            }
            z = (Tout)(v ? zi : 0);
        } else {
            const float offset = lerc2::float_offset(acc, b67);
            float zf;
            if (mode == 0) {
                zf = __uint_as_float(q);
            } else if (mode == 2) {
                zf = 0.f;
            } else if (mode == 3) {
                zf = offset;
            } else {
                zf = __double2float_rn(__dadd_rn((double)offset, __dmul_rn((double)q, inv)));
                const float zmf = __int_as_float(zm);
                zf = zmf < zf ? zmf : zf;
            }
            z = v ? zf : 0.f;
        }
        const int row = row0 + (int)(j / MB), col = col0 + (int)(j % MB);
        img[((base + row) * w + col) * d + di] = z;
    }

    if (lane == 0) {
        const uint32_t ne = rd(s, p + 2 + off_w, n_bytes)
                          | (cw == 2 ? rd(s, p + 3 + off_w, n_bytes) << 8 : 0u);
        const long long length =
            mode == 2 ? 1
            : mode == 3 ? 1 + off_w
            : mode == 0 ? 1 + (long long)cnt * size_t_
            : is_lut ? 1 + off_w + 1 + cw + 1 + lut_bytes + (((long long)ne * nbits_lut + 7) >> 3)
                     : 1 + off_w + 1 + cw + (((long long)ne * nb + 7) >> 3);
        bool bad = (mode == 1 && (int)ne != cnt) || (is_lut && !lut);
        if (rr != unit_rec - 1) {
            const int delta = (int)((uint32_t)starts[r + 1] - (uint32_t)starts[r]);
            bad |= delta != length;
        }
        if (bad) flags[3 * u] = 0;
        if ((mode == 0 || mode == 1) && width > cap_nb) flags[3 * u + 1] = 0;
        if (dif) flags[3 * u + 2] = 1;
    }
}

template <typename Tout, bool IS_INT, int MB>
int launch_lut(const uint8_t* words, long long n_bytes, const int* starts, const int* valid,
               const int* zmax, double inv, int inv_i, int h, int w, int d, int n_units, int dt,
               int size_t_, int is_signed, int version5, int lut, int cap_nb, void* img,
               int* flags, cudaStream_t st) {
    const int nbh = w / MB;
    const int unit_rec = (h / MB) * nbh * d;
    const int n_rec = unit_rec * n_units;
    const int grid = (n_rec + WARPS - 1) / WARPS;
    const uint32_t* v = reinterpret_cast<const uint32_t*>(valid);
    Tout* out = static_cast<Tout*>(img);
    if (valid)
        decode_records_lut_kernel<Tout, IS_INT, MB, true><<<grid, WARPS * 32, 0, st>>>(
            words, n_bytes, starts, v, zmax, inv, inv_i, h, w, d, nbh, unit_rec, n_rec, dt,
            size_t_, is_signed, version5, lut, cap_nb, out, flags);
    else
        decode_records_lut_kernel<Tout, IS_INT, MB, false><<<grid, WARPS * 32, 0, st>>>(
            words, n_bytes, starts, nullptr, zmax, inv, inv_i, h, w, d, nbh, unit_rec, n_rec, dt,
            size_t_, is_signed, version5, lut, cap_nb, out, flags);
    return (int)cudaGetLastError();
}

template <typename Tout, bool IS_INT>
int launch_lut_of(int mb, const uint8_t* words, long long n_bytes, const int* starts,
                  const int* valid, const int* zmax, double inv, int inv_i, int h, int w, int d,
                  int n_units, int dt, int size_t_, int is_signed, int version5, int lut,
                  int cap_nb, void* img, int* flags, cudaStream_t st) {
#define K4L_ARGS words, n_bytes, starts, valid, zmax, inv, inv_i, h, w, d, n_units, dt, size_t_, \
                 is_signed, version5, lut, cap_nb, img, flags, st
    if (mb == 8) return launch_lut<Tout, IS_INT, 8>(K4L_ARGS);
    if (mb == 16) return launch_lut<Tout, IS_INT, 16>(K4L_ARGS);
#undef K4L_ARGS
    return (int)cudaErrorInvalidValue;
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

// K6: dt 0..5, 6 (float32: offset and zmax hold f32 bits) or 7 (float64:
// offset [nRec] and zmax [D] are f64 arrays); mb 8 or 16;
// valid: [nBlocks, mb*mb/32] u32 validity words, or null for an all-valid
// image; ok: 1 int32 set to 1 by the caller
extern "C" int decode_scanned(const uint8_t* words, long long n_bytes, const int* mode,
                              const int* payload_pos, const int* offset, const int* num_bits,
                              const int* num_elements, const int* lut_pos, const int* n_lut,
                              const int* nbits_lut, const int* valid, const int* zmax, double inv,
                              int inv_i, int h, int w, int d, int mb, int dt, int size_t_,
                              int is_signed, void* img, int* ok, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
#define K6_ARGS mb, words, n_bytes, mode, payload_pos, offset, num_bits, num_elements, lut_pos, \
                n_lut, nbits_lut, valid, zmax, inv, inv_i, h, w, d, size_t_, is_signed, img, ok, st
    switch (dt) {
        case 0: return launch_scanned_of<int8_t, true>(K6_ARGS);
        case 1: return launch_scanned_of<uint8_t, true>(K6_ARGS);
        case 2: return launch_scanned_of<int16_t, true>(K6_ARGS);
        case 3: return launch_scanned_of<uint16_t, true>(K6_ARGS);
        case 4: return launch_scanned_of<int32_t, true>(K6_ARGS);
        case 5: return launch_scanned_of<uint32_t, true>(K6_ARGS);
        case 6: return launch_scanned_of<float, false>(K6_ARGS);
        case 7: return launch_scanned_of<double, false>(K6_ARGS);
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

// K4 for the mosaic: n_units units of [H, W, D] (H, W multiples of mb, 8 or
// 16) in one record axis; dt 0..5 or 6 (float32: zmax holds f32 bits);
// zmax [n_units, D]; valid: [n_units * nBlocks, mb*mb/32] u32 validity words
// or null (every pixel valid); flags [n_units, 3] int32 set to {1, 1, 0} by
// the caller; img [n_units, H, W, D] in the dtype
extern "C" int decode_records_lut(const uint8_t* words, long long n_bytes, const int* starts,
                                  const int* valid, const int* zmax, double inv, int inv_i,
                                  int h, int w, int d, int mb, int n_units, int dt, int size_t_,
                                  int is_signed, int version5, int lut, int cap_nb, void* img,
                                  int* flags, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
#define K4L_ARGS mb, words, n_bytes, starts, valid, zmax, inv, inv_i, h, w, d, n_units, dt, \
                 size_t_, is_signed, version5, lut, cap_nb, img, flags, st
    switch (dt) {
        case 0: return launch_lut_of<int8_t, true>(K4L_ARGS);
        case 1: return launch_lut_of<uint8_t, true>(K4L_ARGS);
        case 2: return launch_lut_of<int16_t, true>(K4L_ARGS);
        case 3: return launch_lut_of<uint16_t, true>(K4L_ARGS);
        case 4: return launch_lut_of<int32_t, true>(K4L_ARGS);
        case 5: return launch_lut_of<uint32_t, true>(K4L_ARGS);
        case 6: return launch_lut_of<float, false>(K4L_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
#undef K4L_ARGS
}
