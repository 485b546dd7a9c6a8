// K4 decode_records: index-driven Lerc2 tile decode for float32 rasters
// with 8x8 micro blocks, all-valid or masked, with the exact double
// ScaleBack.
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

}  // namespace

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
