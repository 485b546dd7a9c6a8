// K1 encode_blocks and K2 write_records: the Lerc2 tile encoder for
// float32 and integer rasters, all-valid or masked, any H and W, on 8x8
// blocks, and with the LUT block candidate on 8x8 and 16x16 blocks.
//
// Replaces lerc_tpu/ops/device_encode.py::encode_tiles (:486) with its
// bit packers (_pack_words :124, _pack_words_grouped :167,
// _pack_words_static :254, _shift_words_1b :291), for masks and edge
// blocks its valid-lane compaction make_compactor (:303), and the LUT
// candidate _lut_candidate_pre (:407) / _lut_candidate_post (:440). The TPU
// version routes bits with one-hot matmuls and static roll chains, and sorts
// each block's values with jnp.sort, because XLA gathers and scatters are
// slow there; on Hopper one warp owns one block: shuffles reduce it, and
// shared-memory atomicOr assembles its record.
//
// One warp, one block of MB x MB values, VPL = MB*MB/32 values per lane:
// value j = 32k + lane (k < VPL) is block position j in row-major order.
// The LUT-free K1/K2 (8x8 blocks, the resident codecs') are bodies of their
// own with two values a lane (encode_blocks_body, write_records_body), no
// LUT branch and one count byte: served by the LUT template with a flag
// off, they ran slower per launch on the H100.
//
// Masks and edge blocks: each block's validity is VPL u32 words (bit j of
// word k = position 32k + j), exactly the ballots of the warp's lane rows.
// The masked instantiations read only the valid positions (positions past
// the image's edge are invalid), count the block's values with popc, and
// write value j at its rank among the valid positions: the stable left
// compaction, with no separate pass.
//
// LUT (the band codec's instances, BitStuffer2::EncodeLut): the warp sorts the block's
// quantized values (invalid positions as 0) with a bitonic network --
// shuffles across lanes, register swaps within a lane -- and one more
// shuffle compare marks the first of each run of equal values. n_lut is the
// count of distinct non-zero values, and a value's index is the inclusive
// count of distinct non-zero values up to it in sorted order: a rank, with no
// one-hot matrix. K1 takes the LUT record when max_q > 0, 1 <= n_lut < 255
// and it is shorter than the plain stuffed one (device_encode.py:662-671,
// inside the integer depth-diff candidate too, :691-698); K2 sorts (value,
// position) keys and writes [n_lut + 1][LUT at numBits][indices at
// bitlen(n_lut)].
//
// Bound: bytes. K1 reads the image once (size*H*W*D B) and writes 16 B per
// record; K2 reads the image again and writes the stream (`total` B); the
// masked ones also read 4*VPL B of validity words per record. Both do a
// few dozen operations per value (a few hundred with the LUT sort), under
// the f32 rate's share of the bytes' time.
//
// Record r = b*D + di (block-major, depth inner). rec_info[r] holds
// {length, desc, offset word, zq}, desc = flag | mode << 8 | diff << 10 |
// lut << 11 | numBits << 16 | offset width << 24; zq is the block zmin's
// bits (float) or what K2 subtracts (integers: the block min, or the diff
// min).
//
// float64 (encode_blocks_f64 / write_records_f64, all-valid and masked, 8x8
// blocks) replaces lerc_tpu/ops/device_f64.py::encode_tiles_f64 (:95), which
// quantizes in double-single f32 pairs with a residual refinement, picks the
// block offset's bits by a compound (hi, lo) key and routes records through
// roll chains. Here the arithmetic is native f64, two values a lane: the
// block min and max by shuffles, the offset the exact bits of the first valid
// position holding the min; q = rint((x - zMin) * scale) in f64, clamped to
// [0, 2^30], with the sign-directed +-1 fixup judged under the decoder's own
// reconstruction zMin + q * (2 * maxZError), a candidate kept only when
// strictly closer, so every decoded value lies within maxZError. JAX's wire
// choices stay: the full 8-byte offset (flag bits 6-7 zero), no LUT, modes
// const-0, stuffed (payload at byte 11), const-offset and raw (8 B a valid
// value; forced when (zMax - zMin) * scale passes 2^30 - 1, :209-213), the
// integrity bits. A raw record is 513 B; K2's buffer holds it.
//
// Build with --fmad=false: the float quantize fixup contracts exactly the
// one multiply-add the reference contracts (written as __fmaf_rn); the f64
// quantization rounds each multiply and add apart (__dmul_rn, __dadd_rn).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <type_traits>

#include "record.cuh"

namespace {

constexpr int WARPS = 8;  // warps (records) per CTA
constexpr unsigned FULL = 0xffffffffu;

// the encoder's scalars (device_encode.py:514-554, :606)
struct EncP {
    float mze, scale, inv, maxq_cap;
    int inv_i, lossless, dt, size, integ_mask, cap_nb, raw_ok, try_diff;
};

// one quantized f32 value: rint((x - zmin) * scale) with the sign-directed
// +-1 fixup against the f32 reconstruction (device_encode.py:617-625)
__device__ __forceinline__ uint32_t quantize(float x, float zmin, float scale, float inv) {
    float q0 = rintf(__fmul_rn(__fsub_rn(x, zmin), scale));
    float resid = __fsub_rn(x, __fmaf_rn(q0, inv, zmin));
    float sgn = resid > 0.f ? 1.f : (resid < 0.f ? -1.f : resid);
    float qc = fmaxf(__fadd_rn(q0, sgn), 0.f);
    float errc = fabsf(__fsub_rn(x, __fmaf_rn(qc, inv, zmin)));
    float best = errc < fabsf(resid) ? qc : q0;
    best = fminf(fmaxf(best, 0.f), 2147483648.f);
    return (uint32_t)best;
}

__device__ __forceinline__ int wrap_sub(int a, int b) { return (int)((uint32_t)a - (uint32_t)b); }
__device__ __forceinline__ int wrap_mad(int a, int q, int m) {
    return (int)((uint32_t)a + (uint32_t)q * (uint32_t)m);
}
__device__ __forceinline__ int wrap_abs(int a) { return a < 0 ? (int)(0u - (uint32_t)a) : a; }

// one quantized integer value (device_encode.py:601-613): lossless q = x -
// zmin; lossy q0 = rint(f32(x - zmin) * scale) with the sign-directed fixup
// against the exact integer reconstruction (x - zmin converts as int32, as
// JAX's: a block whose range reaches 2^31 is written raw, see wide_block)
__device__ __forceinline__ uint32_t quantize_int(int x, int zmin, int lossless, float scale,
                                                 int inv_i) {
    const int dx = wrap_sub(x, zmin);
    if (lossless) return (uint32_t)dx;
    const int q0 = __float2int_rn(__fmul_rn(__int2float_rn(dx), scale));
    const int resid = wrap_sub(x, wrap_mad(zmin, q0, inv_i));
    const int sgn = resid > 0 ? 1 : (resid < 0 ? -1 : 0);
    const int qc = max(wrap_mad(q0, sgn, 1), 0);
    const int errc = wrap_abs(wrap_sub(x, wrap_mad(zmin, qc, inv_i)));
    return (uint32_t)(errc < wrap_abs(resid) ? qc : q0);
}

// float atomics through the integer order of IEEE bit patterns
__device__ __forceinline__ void atomic_min_z(float* a, float v) {
    if (__float_as_int(v) >= 0) atomicMin((int*)a, __float_as_int(v));
    else atomicMax((unsigned*)a, __float_as_uint(v));
}
__device__ __forceinline__ void atomic_max_z(float* a, float v) {
    if (__float_as_int(v) >= 0) atomicMax((int*)a, __float_as_int(v));
    else atomicMin((unsigned*)a, __float_as_uint(v));
}
__device__ __forceinline__ void atomic_min_z(double* a, double v) {
    const long long b = __double_as_longlong(v);
    if (b >= 0) atomicMin((long long*)a, b);
    else atomicMax((unsigned long long*)a, (unsigned long long)b);
}
__device__ __forceinline__ void atomic_max_z(double* a, double v) {
    const long long b = __double_as_longlong(v);
    if (b >= 0) atomicMax((long long*)a, b);
    else atomicMin((unsigned long long*)a, (unsigned long long)b);
}
__device__ __forceinline__ void atomic_min_z(int* a, int v) { atomicMin(a, v); }
__device__ __forceinline__ void atomic_max_z(int* a, int v) { atomicMax(a, v); }

// uint32 (dtype UINT; int32 bits in): values order and convert as unsigned.
// flip is INT_MIN for it, else 0: x ^ flip maps unsigned order onto int32
// order, so one signed min/max serves both (JAX orders uint32 as int32)
__device__ __forceinline__ int order_flip(const EncP& P) {
    return P.dt == lerc2::DT_UINT ? INT_MIN : 0;
}
__device__ __forceinline__ float int_to_f32(int x, int flip) {
    return flip ? __uint2float_rn((uint32_t)x) : __int2float_rn(x);
}

// a block of range 2^31 or more (int32, uint32) is written raw: its x - zmin
// passes int32, and JAX's quanta of it decode wrong in a LUT record (where
// JAX's block is right, it is raw too: 32-bit stuffing never beats raw)
__device__ __forceinline__ bool wide_block(int hi, int zmin) {
    return (uint32_t)wrap_sub(hi, zmin) >= 0x80000000u;
}

// reduced offset type code and byte width of an integer block offset
// (_reduce_offset_int, device_encode.py:79; Lerc2.h:457-492)
__device__ __forceinline__ void reduce_offset_int(int z, int dt, int& tc, int& off_w) {
    const bool fb = z >= 0 && z <= 255, fc = z >= -128 && z <= 127;
    const bool fs = z >= -32768 && z <= 32767, fu = z >= 0 && z <= 65535;
    switch (dt) {
        case 0: case 1: tc = 0; off_w = 1; break;                                  // CHAR, BYTE
        case 2: tc = fc ? 2 : (fb ? 1 : 0); off_w = tc > 0 ? 1 : 2; break;         // SHORT
        case 3: tc = fb ? 1 : 0; off_w = tc > 0 ? 1 : 2; break;                    // USHORT
        case 4: tc = fb ? 3 : (fs ? 2 : (fu ? 1 : 0));                             // INT
                off_w = tc == 3 ? 1 : (tc > 0 ? 2 : 4); break;
        default: tc = fb ? 2 : (fu ? 1 : 0);                                       // UINT
                 off_w = tc == 2 ? 1 : (tc == 1 ? 2 : 4); break;
    }
}

// reduced offset of a float block offset (Lerc2.h:493-499): byte, short or float
__device__ __forceinline__ void reduce_offset_float(float zmin, int& tc, int& off_w,
                                                    uint32_t& off_word) {
    const bool is_int = zmin == rintf(zmin) && fabsf(zmin) < 2147483648.f;
    tc = (is_int && zmin >= 0.f && zmin <= 255.f) ? 2
       : (is_int && zmin >= -32768.f && zmin <= 32767.f) ? 1 : 0;
    off_w = tc == 2 ? 1 : (tc == 1 ? 2 : 4);
    off_word = __float_as_uint(zmin);
    if (tc) off_word = (uint32_t)(int)rintf(zmin) & (tc == 2 ? 0xFFu : 0xFFFFu);
}

__device__ __forceinline__ uint32_t low_bytes(uint32_t v, int nbytes) {
    return nbytes >= 4 ? v : (v & ((1u << (8 * nbytes)) - 1u));
}

__device__ __forceinline__ int bit_len(uint32_t v) { return v ? 32 - __clz(v) : 0; }

// ---- the block's values and validity

// block b's VPL validity words and its value count
template <int VPL>
__device__ __forceinline__ int block_valid(const uint32_t* valid, int b, uint32_t (&vw)[VPL]) {
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
        vw[k] = valid[(size_t)b * VPL + k];
        cnt += __popc(vw[k]);
    }
    return cnt;
}

// the rank of valid position j among the block's valid positions
template <int VPL>
__device__ __forceinline__ int valid_rank(const uint32_t (&vw)[VPL], int j) {
    int r = 0;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
        const int kk = j >> 5;
        if (k < kk) r += __popc(vw[k]);
        else if (k == kk) r += __popc(vw[k] & ((1u << (j & 31)) - 1u));
    }
    return r;
}

// the rank of this lane's position 32k + lane (k known at compile time)
template <int VPL>
__device__ __forceinline__ int lane_rank(const uint32_t (&vw)[VPL], int k, uint32_t lt) {
    int r = __popc(vw[k] & lt);
#pragma unroll
    for (int i = 0; i < VPL; ++i)
        if (i < k) r += __popc(vw[i]);
    return r;
}

// value k of this lane (block position 32k + lane), 0 where invalid
template <typename T, int MB>
__device__ __forceinline__ T load_value(const T* data, int w, int d, int nbh, int b, int di,
                                        int lane, int k, bool ok) {
    const unsigned j = 32 * k + lane;  // unsigned: j / MB and j % MB are a shift and a mask
    const int row = (b / nbh) * MB + (int)(j / MB);
    const int col = (b % nbh) * MB + (int)(j % MB);
    return ok ? data[((size_t)row * w + col) * d + di] : (T)0;
}

// the two values of lane `lane` of block b, depth di; a position that a
// mask or the image's edge makes invalid is not read
template <typename T, bool MASKED>
__device__ __forceinline__ void load_pair(const T* data, int w, int d, int nbh, int b, int di,
                                          int lane, bool ok0, bool ok1, T& x0, T& x1) {
    const int row = (b / nbh) * 8 + (lane >> 3);
    const int col = (b % nbh) * 8 + (lane & 7);
    x0 = !MASKED || ok0 ? data[((size_t)row * w + col) * d + di] : (T)0;
    x1 = !MASKED || ok1 ? data[((size_t)(row + 4) * w + col) * d + di] : (T)0;
}

// ---- the warp's bitonic sort (ascending) of the 32*VPL keys v[k] of lane
// `lane` in element order i = 32k + lane: partners within a lane swap
// registers, partners across lanes exchange through shuffles
template <typename K, int VPL>
__device__ __forceinline__ void warp_sort(K (&v)[VPL], int lane) {
    constexpr int N = 32 * VPL;
#pragma unroll
    for (int size = 2; size <= N; size <<= 1) {
#pragma unroll
        for (int j = size >> 1; j > 0; j >>= 1) {
#pragma unroll
            for (int k = 0; k < VPL; ++k) {
                const bool up = ((32 * k + lane) & size) == 0;
                if (j >= 32) {
                    const int kk = k ^ (j >> 5);
                    if (kk > k) {
                        const K a = v[k], c = v[kk];
                        if (up ? a > c : a < c) {
                            v[k] = c;
                            v[kk] = a;
                        }
                    }
                } else {
                    const K o = __shfl_xor_sync(FULL, v[k], j);
                    const bool lower = (lane & j) == 0;
                    v[k] = (lower == up) ? (v[k] < o ? v[k] : o) : (v[k] < o ? o : v[k]);
                }
            }
        }
    }
}

// after warp_sort on values (or keys whose high word is the value): first[k]
// marks element 32k + lane that starts a run of equal non-zero values
template <typename K, int VPL>
__device__ __forceinline__ void first_nonzero(const K (&v)[VPL], int lane, bool (&first)[VPL]) {
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
        const uint32_t cur = (uint32_t)(v[k] >> (8 * (sizeof(K) - 4)));
        const uint32_t up = __shfl_up_sync(FULL, cur, 1);
        uint32_t last = 0;
        if (k > 0) last = __shfl_sync(FULL, (uint32_t)(v[k - 1] >> (8 * (sizeof(K) - 4))), 31);
        const bool has_prev = lane > 0 || k > 0;
        const uint32_t prev = lane > 0 ? up : last;
        first[k] = cur > 0 && (!has_prev || cur != prev);
    }
}

// n_lut: the block's count of distinct non-zero quantized values
template <int VPL>
__device__ __forceinline__ int lut_count(const uint32_t (&q)[VPL], int lane) {
    uint32_t s[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k) s[k] = q[k];
    warp_sort(s, lane);
    bool first[VPL];
    first_nonzero(s, lane, first);
    int n = 0;
#pragma unroll
    for (int k = 0; k < VPL; ++k) n += __popc(__ballot_sync(FULL, first[k]));
    return n;
}

// the LUT record's length, taken when shorter (device_encode.py:662-671)
__device__ __forceinline__ void lut_candidate(int n_lut, int nb, int cnt, int off_w, int cw,
                                              uint32_t max_q, int& stuff_len, bool& use_lut) {
    const int lut_len = 2 + cw + off_w + 1 + ((n_lut * nb + 7) >> 3)
                      + ((cnt * bit_len((uint32_t)n_lut) + 7) >> 3);
    use_lut = max_q > 0 && n_lut >= 1 && n_lut < 255 && lut_len < stuff_len;
    if (use_lut) stuff_len = lut_len;
}

template <typename T> struct ZOf { using type = float; };
template <> struct ZOf<int8_t> { using type = int; };
template <> struct ZOf<uint8_t> { using type = int; };
template <> struct ZOf<int16_t> { using type = int; };
template <> struct ZOf<uint16_t> { using type = int; };
template <> struct ZOf<int32_t> { using type = int; };
template <> struct ZOf<uint32_t> { using type = int; };

// ---------------------------------------------------------------------------
// K1: one warp decides one record. Integer instances (encode_tiles
// :591-614, :651-653, :677-722): int32 block minimum (uint32: unsigned
// minimum, and unsigned image ranges), f32 block maximum for the mode
// heuristics, offsets reduced per dtype, raw records of 1 + cnt * size
// native bytes (forced for a block of range 2^31 or more), and the
// depth-diff candidate of 8/16-bit lossless slices at v >= 5: the warp of
// record (b, di > 0) also loads slice di-1 of block b and takes the diff
// record (flag bit 2, offset reduced as INT) when it is strictly shorter.
// ---------------------------------------------------------------------------

// the per-depth image range over the valid values: merge the CTA's warps,
// one atomic per depth (a block with no valid value takes no part: di < 0).
// di = t * D + depth addresses tile t's ranges at zrange[t * 2D ...] (the
// tile-batched instances; a one-tile launch passes the depth)
template <typename Z>
__device__ __forceinline__ void merge_range(Z (&s_min)[WARPS], Z (&s_max)[WARPS],
                                            int (&s_di)[WARPS], int warp, int lane, Z lo, Z hi,
                                            int di, int d, Z* zrange, int flip = 0) {
    if (lane == 0) {
        s_min[warp] = lo;
        s_max[warp] = hi;
        s_di[warp] = di;
    }
    __syncthreads();
    if (threadIdx.x < WARPS && s_di[threadIdx.x] >= 0) {
        const int me = threadIdx.x, dm = s_di[me];
        bool first = true;
        for (int k = 0; k < me; ++k) first &= s_di[k] != dm;
        if (first) {
            Z l = s_min[me], h = s_max[me];
            for (int k = me + 1; k < WARPS; ++k) {
                if (s_di[k] == dm) {
                    if constexpr (std::is_same<Z, float>::value) {
                        l = fminf(l, s_min[k]);
                        h = fmaxf(h, s_max[k]);
                    } else if constexpr (std::is_same<Z, double>::value) {
                        l = fmin(l, s_min[k]);
                        h = fmax(h, s_max[k]);
                    } else {
                        l = min(l ^ flip, s_min[k] ^ flip) ^ flip;
                        h = max(h ^ flip, s_max[k] ^ flip) ^ flip;
                    }
                }
            }
            Z* zr = zrange + (dm / d) * 2 * d + dm % d;
            if constexpr (std::is_same<Z, int>::value) {
                if (flip) {  // uint32: unsigned atomics
                    atomicMin((unsigned*)zr, (unsigned)l);
                    atomicMax((unsigned*)(zr + d), (unsigned)h);
                    return;
                }
            }
            atomic_min_z(zr, l);
            atomic_max_z(zr + d, h);
        }
    }
}

template <typename T, bool MASKED>
__device__ __forceinline__ void encode_blocks_body(
        const T* __restrict__ data, const int2* __restrict__ valid, int w, int d, int nbh,
        int n_rec, const EncP& P, int* __restrict__ rec_info,
        typename ZOf<T>::type* __restrict__ zrange, int* __restrict__ fits) {
    using Z = typename ZOf<T>::type;
    constexpr bool IS_INT = !std::is_same<T, float>::value;
    __shared__ Z s_min[WARPS], s_max[WARPS];
    __shared__ int s_di[WARPS];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = blockIdx.x * WARPS + warp;
    const bool live = r < n_rec;  // warp-uniform
    Z lo = 0, hi = 0;  // the block's range over its valid values
    int cnt = 0;
    if (live) {
        const int b = r / d, di = r % d;
        uint32_t vw0 = FULL, vw1 = FULL;
        cnt = 64;
        if constexpr (MASKED) {
            const int2 v = valid[b];
            vw0 = (uint32_t)v.x;
            vw1 = (uint32_t)v.y;
            cnt = __popc(vw0) + __popc(vw1);
        }
        const bool ok0 = !MASKED || ((vw0 >> lane) & 1u);
        const bool ok1 = !MASKED || ((vw1 >> lane) & 1u);
        T x0, x1;
        load_pair<T, MASKED>(data, w, d, nbh, b, di, lane, ok0, ok1, x0, x1);
        if constexpr (IS_INT) {
            const int xi0 = (int)x0, xi1 = (int)x1, flip = order_flip(P);
            lo = __reduce_min_sync(FULL, min(ok0 ? xi0 ^ flip : INT_MAX,
                                             ok1 ? xi1 ^ flip : INT_MAX)) ^ flip;
            hi = __reduce_max_sync(FULL, max(ok0 ? xi0 ^ flip : INT_MIN,
                                             ok1 ? xi1 ^ flip : INT_MIN)) ^ flip;
            float fmax = fmaxf(ok0 ? int_to_f32(xi0, flip) : -CUDART_INF_F,
                               ok1 ? int_to_f32(xi1, flip) : -CUDART_INF_F);
            for (int o = 16; o > 0; o >>= 1) fmax = fmaxf(fmax, __shfl_xor_sync(FULL, fmax, o));
            int zmin = lo;
            if (MASKED && cnt == 0) zmin = 0, fmax = 0.f;  // const-0 record
            uint32_t max_q = __reduce_max_sync(
                FULL, max(ok0 ? quantize_int(xi0, zmin, P.lossless, P.scale, P.inv_i) : 0u,
                          ok1 ? quantize_int(xi1, zmin, P.lossless, P.scale, P.inv_i) : 0u));
            // depth-diff candidate against slice di-1 of the same block
            int dmin = 0, dmax = 0;
            uint32_t max_qd = 0;
            const bool cand = P.try_diff && di > 0;  // warp-uniform
            if (cand) {
                T p0, p1;
                load_pair<T, MASKED>(data, w, d, nbh, b, di - 1, lane, ok0, ok1, p0, p1);
                const int dv0 = wrap_sub(xi0, (int)p0), dv1 = wrap_sub(xi1, (int)p1);
                dmin = __reduce_min_sync(FULL, min(ok0 ? dv0 : 1 << 30, ok1 ? dv1 : 1 << 30));
                dmax = __reduce_max_sync(FULL,
                                         max(ok0 ? dv0 : -(1 << 30), ok1 ? dv1 : -(1 << 30)));
                if (MASKED && cnt == 0) dmin = dmax = 0;
                max_qd = __reduce_max_sync(FULL, max(ok0 ? (uint32_t)wrap_sub(dv0, dmin) : 0u,
                                                     ok1 ? (uint32_t)wrap_sub(dv1, dmin) : 0u));
            }
            if (lane == 0) {
                const float zmin_f = int_to_f32(zmin, flip);
                int nb = bit_len(max_q);
                const float max_val = __fmul_rn(__fsub_rn(fmax, zmin_f), P.scale);
                bool const0 = (MASKED && cnt == 0) || (zmin_f == 0.f && fmax == 0.f);
                const bool force_raw = (P.mze == 0.f && fmax > zmin_f)
                                       || (P.mze > 0.f && max_val > P.maxq_cap)
                                       || wide_block(hi, zmin);
                int tc, off_w;
                reduce_offset_int(zmin, P.dt, tc, off_w);
                uint32_t off_word = low_bytes((uint32_t)zmin, off_w);
                // count byte width 1 (cnt < 256)
                int stuff_len = 1 + off_w + (max_q ? 2 + ((cnt * nb + 7) >> 3) : 0);
                const int raw_len = 1 + cnt * P.size;
                int zq = zmin;  // what K2 subtracts: the block min, or the diff min
                bool use_diff = false;
                if (cand) {
                    const int nbd = bit_len(max_qd);
                    int tc_d, off_w_d;
                    reduce_offset_int(dmin, lerc2::DT_INT, tc_d, off_w_d);
                    const int stuff_len_d = 1 + off_w_d
                                            + (max_qd ? 2 + ((cnt * nbd + 7) >> 3) : 0);
                    const bool const0_d = dmin == 0 && dmax == 0;
                    const int diff_len = const0_d ? 1 : stuff_len_d;
                    use_diff = P.lossless && cnt > 0 && !const0 && diff_len < stuff_len
                               && diff_len < raw_len;
                    if (use_diff) {
                        const0 = const0_d;
                        stuff_len = stuff_len_d;
                        nb = nbd;
                        max_q = max_qd;
                        tc = tc_d;
                        off_w = off_w_d;
                        off_word = low_bytes((uint32_t)dmin, off_w_d);
                        zq = dmin;
                    }
                }
                const bool use_stuff = !force_raw && stuff_len < raw_len;
                const int mode = const0 ? 2 : (use_stuff ? (max_q ? 1 : 3) : 0);
                const int length = mode == 2 ? 1 : (mode == 0 ? raw_len : stuff_len);
                const int integ = (((b % nbh) & 15) << 2) & P.integ_mask;
                const int flag = integ | (use_diff ? 4 : 0) | mode
                                 | ((mode == 1 || mode == 3) ? tc << 6 : 0);
                int* info = rec_info + 4 * (size_t)r;
                info[0] = length;
                info[1] = flag | (mode << 8) | ((int)use_diff << 10) | (nb << 16) | (off_w << 24);
                info[2] = (int)off_word;
                info[3] = zq;
                if ((mode == 1 && nb > P.cap_nb) || (mode == 0 && !P.raw_ok)) *fits = 0;
            }
        } else {
            float zmin = fminf(ok0 ? x0 : CUDART_INF_F, ok1 ? x1 : CUDART_INF_F);
            float zmax = fmaxf(ok0 ? x0 : -CUDART_INF_F, ok1 ? x1 : -CUDART_INF_F);
            for (int o = 16; o > 0; o >>= 1) {
                zmin = fminf(zmin, __shfl_xor_sync(FULL, zmin, o));
                zmax = fmaxf(zmax, __shfl_xor_sync(FULL, zmax, o));
            }
            if (MASKED && cnt == 0) zmin = zmax = 0.f;  // const-0 record
            lo = zmin;
            hi = zmax;
            const uint32_t max_q = __reduce_max_sync(
                FULL, max(ok0 ? quantize(x0, zmin, P.scale, P.inv) : 0u,
                          ok1 ? quantize(x1, zmin, P.scale, P.inv) : 0u));
            if (lane == 0) {
                const int nb = bit_len(max_q);
                const float max_val = __fmul_rn(__fsub_rn(zmax, zmin), P.scale);
                const bool const0 = zmin == 0.f && zmax == 0.f;
                const bool force_raw = (P.mze == 0.f && zmax > zmin)
                                       || (P.mze > 0.f && max_val > 1073741823.f);
                int tc, off_w;
                uint32_t off_word;
                reduce_offset_float(zmin, tc, off_w, off_word);
                // count byte width 1 (cnt < 256); raw: 4 B a value
                const int stuff_len = 1 + off_w
                                      + (max_q ? 2 + (MASKED ? (cnt * nb + 7) >> 3 : 8 * nb) : 0);
                const int raw_len = MASKED ? 1 + 4 * cnt : 1 + 64 * 4;
                const bool use_stuff = !force_raw && stuff_len < raw_len;
                const int mode = const0 ? 2 : (use_stuff ? (max_q ? 1 : 3) : 0);
                const int length = mode == 2 ? 1 : (mode == 0 ? raw_len : stuff_len);
                const int integ = (((b % nbh) & 15) << 2) & P.integ_mask;
                const int flag = integ | mode | ((mode == 1 || mode == 3) ? tc << 6 : 0);
                int* info = rec_info + 4 * (size_t)r;
                info[0] = length;
                info[1] = flag | (mode << 8) | (nb << 16) | (off_w << 24);
                info[2] = (int)off_word;
                info[3] = __float_as_int(zmin);
                if ((mode == 1 && nb > P.cap_nb) || (mode == 0 && !P.raw_ok)) *fits = 0;
            }
        }
    }
    merge_range(s_min, s_max, s_di, warp, lane, lo, hi,
                live && (!MASKED || cnt > 0) ? r % d : -1, d, zrange, IS_INT ? order_flip(P) : 0);
}

__global__ void encode_blocks_kernel(const float* __restrict__ data, int w, int d, int nbh,
                                     int n_rec, EncP P, int* __restrict__ rec_info,
                                     float* __restrict__ zrange, int* __restrict__ fits) {
    encode_blocks_body<float, false>(data, nullptr, w, d, nbh, n_rec, P, rec_info, zrange, fits);
}

__global__ void encode_blocks_masked_kernel(const float* __restrict__ data,
                                            const int2* __restrict__ valid, int w, int d,
                                            int nbh, int n_rec, EncP P,
                                            int* __restrict__ rec_info,
                                            float* __restrict__ zrange, int* __restrict__ fits) {
    encode_blocks_body<float, true>(data, valid, w, d, nbh, n_rec, P, rec_info, zrange, fits);
}

template <typename T, bool MASKED>
__global__ void encode_blocks_int_kernel(const T* __restrict__ data,
                                         const int2* __restrict__ valid, int w, int d, int nbh,
                                         int n_rec, EncP P, int* __restrict__ rec_info,
                                         int* __restrict__ zrange, int* __restrict__ fits) {
    encode_blocks_body<T, MASKED>(data, valid, w, d, nbh, n_rec, P, rec_info, zrange, fits);
}

// ---- K1 with the LUT candidate (the band codec's), 8x8 or 16x16 blocks,
// validity words always (all set for an aligned all-valid image)

template <typename T, int MB>
__global__ void encode_blocks_lut_kernel(const T* __restrict__ data,
                                         const uint32_t* __restrict__ valid, int w, int d,
                                         int nbh, int n_rec, int tile_rec, EncP P,
                                         int* __restrict__ rec_info,
                                         typename ZOf<T>::type* __restrict__ zrange,
                                         int* __restrict__ fits) {
    using Z = typename ZOf<T>::type;
    constexpr bool IS_INT = !std::is_same<T, float>::value;
    constexpr int VPL = MB * MB / 32;
    __shared__ Z s_min[WARPS], s_max[WARPS];
    __shared__ int s_di[WARPS];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = blockIdx.x * WARPS + warp;
    const bool live = r < n_rec;  // warp-uniform
    Z lo, hi;  // the block's range over its valid values, for the per-depth range
    if constexpr (IS_INT) {
        lo = INT_MAX;
        hi = INT_MIN;
    } else {
        lo = CUDART_INF_F;
        hi = -CUDART_INF_F;
    }
    int cnt = 0;
    if (live) {
        const int b = r / d, di = r % d;
        uint32_t vw[VPL];
        cnt = block_valid<VPL>(valid, b, vw);
        bool ok[VPL];
        T x[VPL];
#pragma unroll
        for (int k = 0; k < VPL; ++k) {
            ok[k] = (vw[k] >> lane) & 1u;
            x[k] = load_value<T, MB>(data, w, d, nbh, b, di, lane, k, ok[k]);
        }
        uint32_t q[VPL];
        uint32_t max_q = 0;
        float fmax = -CUDART_INF_F, zmin_f = 0.f;
        int zmin_i = 0;
        if constexpr (IS_INT) {
            const int flip = order_flip(P);
            int l = INT_MAX, h = INT_MIN;
#pragma unroll
            for (int k = 0; k < VPL; ++k) {
                if (ok[k]) {
                    l = min(l, (int)x[k] ^ flip);
                    h = max(h, (int)x[k] ^ flip);
                    fmax = fmaxf(fmax, int_to_f32((int)x[k], flip));
                }
            }
            lo = __reduce_min_sync(FULL, l) ^ flip;
            hi = __reduce_max_sync(FULL, h) ^ flip;
            for (int o = 16; o > 0; o >>= 1) fmax = fmaxf(fmax, __shfl_xor_sync(FULL, fmax, o));
            zmin_i = lo;
            if (cnt == 0) zmin_i = 0, fmax = 0.f;  // const-0 record
#pragma unroll
            for (int k = 0; k < VPL; ++k)
                q[k] = ok[k] ? quantize_int((int)x[k], zmin_i, P.lossless, P.scale, P.inv_i) : 0u;
        } else {
            float l = CUDART_INF_F, h = -CUDART_INF_F;
#pragma unroll
            for (int k = 0; k < VPL; ++k) {
                l = fminf(l, ok[k] ? (float)x[k] : CUDART_INF_F);
                h = fmaxf(h, ok[k] ? (float)x[k] : -CUDART_INF_F);
            }
            for (int o = 16; o > 0; o >>= 1) {
                l = fminf(l, __shfl_xor_sync(FULL, l, o));
                h = fmaxf(h, __shfl_xor_sync(FULL, h, o));
            }
            if (cnt == 0) l = h = 0.f;  // const-0 record
            lo = l;
            hi = h;
            zmin_f = l;
            fmax = h;
#pragma unroll
            for (int k = 0; k < VPL; ++k)
                q[k] = ok[k] ? quantize((float)x[k], zmin_f, P.scale, P.inv) : 0u;
        }
#pragma unroll
        for (int k = 0; k < VPL; ++k) max_q = max(max_q, q[k]);
        max_q = __reduce_max_sync(FULL, max_q);
        const int n_lut = lut_count(q, lane);

        // depth-diff candidate against slice di-1 of the same block
        int dmin = 0, dmax = 0, n_lut_d = 0;
        uint32_t max_qd = 0;
        const bool cand = IS_INT && P.try_diff && di > 0;  // warp-uniform
        if (cand) {
            int dv[VPL];
            int l = 1 << 30, h = -(1 << 30);
#pragma unroll
            for (int k = 0; k < VPL; ++k) {
                const T p = load_value<T, MB>(data, w, d, nbh, b, di - 1, lane, k, ok[k]);
                dv[k] = wrap_sub((int)x[k], (int)p);
                if (ok[k]) {
                    l = min(l, dv[k]);
                    h = max(h, dv[k]);
                }
            }
            dmin = __reduce_min_sync(FULL, l);
            dmax = __reduce_max_sync(FULL, h);
            if (cnt == 0) dmin = dmax = 0;
            uint32_t qd[VPL];
            uint32_t m = 0;
#pragma unroll
            for (int k = 0; k < VPL; ++k) {
                qd[k] = ok[k] ? (uint32_t)wrap_sub(dv[k], dmin) : 0u;
                m = max(m, qd[k]);
            }
            max_qd = __reduce_max_sync(FULL, m);
            n_lut_d = lut_count(qd, lane);
        }

        if (lane == 0) {
            // count byte width: 2 only for a full 16x16 block (an 8x8 block holds < 256)
            const int cw = MB == 8 || cnt < 256 ? 1 : 2;
            int nb = bit_len(max_q), tc, off_w;
            uint32_t off_word;
            bool const0, force_raw;
            int zq;  // rec_info[3]: the float zmin's bits, or what integer K2 subtracts
            if constexpr (IS_INT) {
                const float zf = int_to_f32(zmin_i, order_flip(P));
                const float max_val = __fmul_rn(__fsub_rn(fmax, zf), P.scale);
                const0 = cnt == 0 || (zf == 0.f && fmax == 0.f);
                force_raw = (P.mze == 0.f && fmax > zf) || (P.mze > 0.f && max_val > P.maxq_cap)
                            || wide_block(hi, zmin_i);
                reduce_offset_int(zmin_i, P.dt, tc, off_w);
                off_word = low_bytes((uint32_t)zmin_i, off_w);
                zq = zmin_i;
            } else {
                const float max_val = __fmul_rn(__fsub_rn(fmax, zmin_f), P.scale);
                const0 = zmin_f == 0.f && fmax == 0.f;
                force_raw = (P.mze == 0.f && fmax > zmin_f) || (P.mze > 0.f && max_val > P.maxq_cap);
                reduce_offset_float(zmin_f, tc, off_w, off_word);
                zq = __float_as_int(zmin_f);
            }
            int stuff_len = 1 + off_w + (max_q ? 1 + cw + ((cnt * nb + 7) >> 3) : 0);
            const int raw_len = 1 + cnt * P.size;
            bool use_lut = false, use_diff = false;
            lut_candidate(n_lut, nb, cnt, off_w, cw, max_q, stuff_len, use_lut);
            if (cand) {
                const int nbd = bit_len(max_qd);
                int tc_d, off_w_d;
                reduce_offset_int(dmin, lerc2::DT_INT, tc_d, off_w_d);
                int stuff_len_d = 1 + off_w_d + (max_qd ? 1 + cw + ((cnt * nbd + 7) >> 3) : 0);
                bool use_lut_d = false;
                lut_candidate(n_lut_d, nbd, cnt, off_w_d, cw, max_qd, stuff_len_d, use_lut_d);
                const bool const0_d = dmin == 0 && dmax == 0;
                const int diff_len = const0_d ? 1 : stuff_len_d;
                use_diff = P.lossless && cnt > 0 && !const0 && diff_len < stuff_len
                           && diff_len < raw_len;
                if (use_diff) {
                    const0 = const0_d;
                    stuff_len = stuff_len_d;
                    nb = nbd;
                    max_q = max_qd;
                    tc = tc_d;
                    off_w = off_w_d;
                    off_word = low_bytes((uint32_t)dmin, off_w_d);
                    zq = dmin;
                    use_lut = use_lut_d;
                }
            }
            const bool use_stuff = !force_raw && stuff_len < raw_len;
            const int mode = const0 ? 2 : (use_stuff ? (max_q ? 1 : 3) : 0);
            const int length = mode == 2 ? 1 : (mode == 0 ? raw_len : stuff_len);
            const int j0 = (b % nbh) * MB;
            const int integ = (((j0 >> 3) & 15) << 2) & P.integ_mask;
            const int flag = integ | (use_diff ? 4 : 0) | mode
                             | ((mode == 1 || mode == 3) ? tc << 6 : 0);
            int* info = rec_info + 4 * (size_t)r;
            info[0] = length;
            info[1] = flag | (mode << 8) | ((int)use_diff << 10) | ((int)(use_lut && mode == 1) << 11)
                      | (nb << 16) | (off_w << 24);
            info[2] = (int)off_word;
            info[3] = zq;
            if ((mode == 1 && nb > P.cap_nb) || (mode == 0 && !P.raw_ok)) *fits = 0;
        }
    }
    merge_range(s_min, s_max, s_di, warp, lane, lo, hi,
                live && cnt > 0 ? r % d + d * (r / tile_rec) : -1, d, zrange,
                IS_INT ? order_flip(P) : 0);
}

// ---------------------------------------------------------------------------
// K2: one warp writes one record into its shared-memory buffer at the
// record's byte phase, then flushes it to the stream
// ---------------------------------------------------------------------------

__device__ __forceinline__ void put_bits(uint32_t* buf, int bitpos, uint32_t v, int width) {
    const int wi = bitpos >> 5, bit = bitpos & 31;
    atomicOr(&buf[wi], v << bit);
    if (bit && bit + width > 32) atomicOr(&buf[wi + 1], v >> (32 - bit));
}

// the record's words from the warp's buffer to the stream: interior words
// belong to this record alone; the first and last may share bytes with the
// neighbours and merge by atomicOr (the stream is zeroed and every record's
// bytes past its length are zero)
__device__ __forceinline__ void flush_record(const uint32_t* buf, long long s, int length,
                                             int lane, uint32_t* stream, long long cap_w) {
    const int nwords = ((int)(s & 3) + length + 3) >> 2;
    const long long base = s >> 2;
    for (int i = lane; i < nwords; i += 32) {
        const long long gw = base + i;
        if (gw < 0 || gw >= cap_w) continue;  // over-capacity records: fits is already 0
        if (i == 0 || i == nwords - 1) atomicOr(&stream[gw], buf[i]);
        else stream[gw] = buf[i];
    }
}

// ---- K2 without the LUT candidate, 8x8 blocks: lane l holds block
// positions l and l + 32, whose validity bits are bit l of the block's two
// words

template <typename T, bool MASKED>
__device__ __forceinline__ void write_records_body(
        const T* __restrict__ data, const int2* __restrict__ valid, int w, int d, int nbh,
        int n_rec, const EncP& P, const int* __restrict__ rec_info,
        const int* __restrict__ starts, uint32_t* __restrict__ stream, long long cap_w) {
    constexpr bool IS_INT = !std::is_same<T, float>::value;
    constexpr int BUF_W = 72;  // record words: 3 + 257 bytes + spill
    __shared__ uint32_t buf_all[WARPS][BUF_W];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = blockIdx.x * WARPS + warp;
    if (r >= n_rec) return;  // warp-uniform
    uint32_t* buf = buf_all[warp];
    for (int i = lane; i < BUF_W; i += 32) buf[i] = 0;
    __syncwarp();

    const int* info = rec_info + 4 * (size_t)r;
    const int length = info[0], desc = info[1];
    const uint32_t off_word = (uint32_t)info[2];
    const int flag = desc & 0xFF, mode = (desc >> 8) & 3;
    const int nb = (desc >> 16) & 0xFF, off_w = desc >> 24;
    const long long s = starts[r];
    const int sh = (int)(s & 3);
    const int b = r / d, di = r % d;
    uint32_t vw0 = FULL, vw1 = FULL;
    int cnt = 64;
    if constexpr (MASKED) {
        const int2 v = valid[b];
        vw0 = (uint32_t)v.x;
        vw1 = (uint32_t)v.y;
        cnt = __popc(vw0) + __popc(vw1);
    }

    // record header (Lerc2 WriteTile): flag, offset bytes, numBits byte
    // (count-width code 2: one count byte), count
    if (lane == 0) {
        unsigned char* bytes = reinterpret_cast<unsigned char*>(buf) + sh;
        bytes[0] = (unsigned char)flag;
        if (mode == 1 || mode == 3)
            for (int k = 0; k < off_w; ++k) bytes[1 + k] = (unsigned char)(off_word >> (8 * k));
        if (mode == 1) {
            bytes[1 + off_w] = (unsigned char)(nb | 0x80);
            bytes[2 + off_w] = (unsigned char)cnt;
        }
    }
    __syncwarp();

    // payload: LSB-first bit-stuffed quantized values (integers: or the
    // differences to slice di-1 less the diff minimum), or the raw values
    if (mode == 0 || mode == 1) {
        const bool ok0 = !MASKED || ((vw0 >> lane) & 1u);
        const bool ok1 = !MASKED || ((vw1 >> lane) & 1u);
        T x0, x1;
        load_pair<T, MASKED>(data, w, d, nbh, b, di, lane, ok0, ok1, x0, x1);
        const int width = mode == 0 ? (IS_INT ? 8 * P.size : 32) : nb;
        const int pay = 8 * (sh + (mode == 0 ? 1 : 3 + off_w));
        const int zq = info[3];
        uint32_t v[2];
        if constexpr (IS_INT) {
            if (mode == 0) {
                v[0] = low_bytes((uint32_t)(int)x0, P.size);
                v[1] = low_bytes((uint32_t)(int)x1, P.size);
            } else if ((desc >> 10) & 1) {
                T p0, p1;
                load_pair<T, MASKED>(data, w, d, nbh, b, di - 1, lane, ok0, ok1, p0, p1);
                v[0] = (uint32_t)wrap_sub(wrap_sub((int)x0, (int)p0), zq);
                v[1] = (uint32_t)wrap_sub(wrap_sub((int)x1, (int)p1), zq);
            } else {
                v[0] = quantize_int((int)x0, zq, P.lossless, P.scale, P.inv_i);
                v[1] = quantize_int((int)x1, zq, P.lossless, P.scale, P.inv_i);
            }
        } else {
            if (mode == 0) {
                v[0] = __float_as_uint(x0);
                v[1] = __float_as_uint(x1);
            } else {
                v[0] = quantize(x0, __int_as_float(zq), P.scale, P.inv);
                v[1] = quantize(x1, __int_as_float(zq), P.scale, P.inv);
            }
        }
        const uint32_t lt = (1u << lane) - 1u;
        for (int k = 0; k < 2; ++k) {
            if (!(k ? ok1 : ok0)) continue;
            const int rank = !MASKED ? lane + 32 * k
                           : (k == 0 ? __popc(vw0 & lt) : __popc(vw0) + __popc(vw1 & lt));
            put_bits(buf, pay + rank * width, v[k], width);
        }
    }
    __syncwarp();
    flush_record(buf, s, length, lane, stream, cap_w);
}

__global__ void write_records_kernel(const float* __restrict__ data, int w, int d, int nbh,
                                     int n_rec, EncP P, const int* __restrict__ rec_info,
                                     const int* __restrict__ starts,
                                     uint32_t* __restrict__ stream, long long cap_w) {
    write_records_body<float, false>(data, nullptr, w, d, nbh, n_rec, P, rec_info, starts,
                                     stream, cap_w);
}

__global__ void write_records_masked_kernel(const float* __restrict__ data,
                                            const int2* __restrict__ valid, int w, int d,
                                            int nbh, int n_rec, EncP P,
                                            const int* __restrict__ rec_info,
                                            const int* __restrict__ starts,
                                            uint32_t* __restrict__ stream, long long cap_w) {
    write_records_body<float, true>(data, valid, w, d, nbh, n_rec, P, rec_info, starts, stream,
                                    cap_w);
}

template <typename T, bool MASKED>
__global__ void write_records_int_kernel(const T* __restrict__ data,
                                         const int2* __restrict__ valid, int w, int d, int nbh,
                                         int n_rec, EncP P, const int* __restrict__ rec_info,
                                         const int* __restrict__ starts,
                                         uint32_t* __restrict__ stream, long long cap_w) {
    write_records_body<T, MASKED>(data, valid, w, d, nbh, n_rec, P, rec_info, starts, stream,
                                  cap_w);
}

// ---- K2 with the LUT candidate (the band codec's), 8x8 or 16x16 blocks,
// validity words always (all set for an aligned all-valid image)

// the LUT record's payload at bit `pay` of buf: sort (value, position)
// keys; the runs of equal values give the LUT entries (the first of each
// non-zero run, at its rank) and each position's index (the inclusive count
// of non-zero runs up to it): [n_lut + 1][LUT at nb bits][indices at
// bitlen(n_lut) bits, in valid-rank order]
template <int VPL>
__device__ __forceinline__ void write_lut_payload(uint32_t* buf, const uint32_t (&v)[VPL],
                                                  const bool (&ok)[VPL],
                                                  const uint32_t (&vw)[VPL], int lane, int pay,
                                                  int nb) {
    unsigned long long key[VPL];  // invalid positions sort as value 0
#pragma unroll
    for (int k = 0; k < VPL; ++k)
        key[k] = ((unsigned long long)(ok[k] ? v[k] : 0u) << 32) | (unsigned)(32 * k + lane);
    warp_sort(key, lane);
    bool first[VPL];
    first_nonzero(key, lane, first);
    int excl[VPL], n_lut = 0;
    const uint32_t lt = (1u << lane) - 1u;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
        const uint32_t ball = __ballot_sync(FULL, first[k]);
        excl[k] = n_lut + __popc(ball & lt);
        n_lut += __popc(ball);
    }
    const int nbits_lut = bit_len((uint32_t)n_lut);
    const int lut_base = pay + 8;
    const int idx_base = lut_base + 8 * ((n_lut * nb + 7) >> 3);
    if (lane == 0) put_bits(buf, pay, (uint32_t)(n_lut + 1), 8);
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
        const uint32_t val = (uint32_t)(key[k] >> 32);
        if (first[k]) put_bits(buf, lut_base + excl[k] * nb, val, nb);
        if (val) {  // a non-zero value lies at a valid position
            const int j = (int)(key[k] & 0xFFFFFFFFu);
            const int idx = excl[k] + (first[k] ? 1 : 0);
            put_bits(buf, idx_base + valid_rank(vw, j) * nbits_lut, (uint32_t)idx, nbits_lut);
        }
    }
}

template <typename T, int MB>
__global__ void write_records_lut_kernel(const T* __restrict__ data,
                                         const uint32_t* __restrict__ valid, int w, int d,
                                         int nbh, int n_rec, EncP P,
                                         const int* __restrict__ rec_info,
                                         const int* __restrict__ starts,
                                         uint32_t* __restrict__ stream, long long cap_w) {
    constexpr bool IS_INT = !std::is_same<T, float>::value;
    constexpr int VPL = MB * MB / 32;
    constexpr int BUF_W = MB * MB + 8;  // record words: header + 4 B a value + phase + spill
    __shared__ uint32_t buf_all[WARPS][BUF_W];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = blockIdx.x * WARPS + warp;
    if (r >= n_rec) return;  // warp-uniform
    uint32_t* buf = buf_all[warp];
    for (int i = lane; i < BUF_W; i += 32) buf[i] = 0;
    __syncwarp();

    const int* info = rec_info + 4 * (size_t)r;
    const int length = info[0], desc = info[1];
    const uint32_t off_word = (uint32_t)info[2];
    const int flag = desc & 0xFF, mode = (desc >> 8) & 3;
    const bool use_diff = (desc >> 10) & 1, lut_rec = (desc >> 11) & 1;  // warp-uniform
    const int nb = (desc >> 16) & 0xFF, off_w = desc >> 24;
    const long long s = starts[r];
    const int sh = (int)(s & 3);
    const int b = r / d, di = r % d;
    uint32_t vw[VPL];
    const int cnt = block_valid<VPL>(valid, b, vw);
    const int cw = MB == 8 || cnt < 256 ? 1 : 2;

    // record header (Lerc2 WriteTile): flag, offset bytes, numBits byte
    // (LUT bit 5, count-width code 3 - cw in bits 6-7), count
    if (lane == 0) {
        unsigned char* bytes = reinterpret_cast<unsigned char*>(buf) + sh;
        bytes[0] = (unsigned char)flag;
        if (mode == 1 || mode == 3)
            for (int k = 0; k < off_w; ++k) bytes[1 + k] = (unsigned char)(off_word >> (8 * k));
        if (mode == 1) {
            bytes[1 + off_w] = (unsigned char)(nb | (lut_rec ? 0x20 : 0) | ((3 - cw) << 6));
            bytes[2 + off_w] = (unsigned char)cnt;
            if (cw == 2) bytes[3 + off_w] = (unsigned char)(cnt >> 8);
        }
    }
    __syncwarp();

    // payload: LSB-first bit-stuffed quantized values (integers: or the
    // differences to slice di-1 less the diff minimum), the LUT record's
    // parts, or the raw native values
    if (mode == 0 || mode == 1) {
        const int zq = info[3];
        const int width = mode == 0 ? 8 * P.size : nb;
        const int pay = 8 * (sh + (mode == 0 ? 1 : 2 + off_w + cw));
        uint32_t v[VPL];
        bool ok[VPL];
#pragma unroll
        for (int k = 0; k < VPL; ++k) {
            ok[k] = (vw[k] >> lane) & 1u;
            const T x = load_value<T, MB>(data, w, d, nbh, b, di, lane, k, ok[k]);
            if constexpr (IS_INT) {
                if (mode == 0) {
                    v[k] = low_bytes((uint32_t)(int)x, P.size);
                } else if (use_diff) {
                    const T p = load_value<T, MB>(data, w, d, nbh, b, di - 1, lane, k, ok[k]);
                    v[k] = (uint32_t)wrap_sub(wrap_sub((int)x, (int)p), zq);
                } else {
                    v[k] = quantize_int((int)x, zq, P.lossless, P.scale, P.inv_i);
                }
            } else {
                v[k] = mode == 0 ? __float_as_uint((float)x)
                                 : quantize((float)x, __int_as_float(zq), P.scale, P.inv);
            }
        }
        if (lut_rec) {
            write_lut_payload(buf, v, ok, vw, lane, pay, nb);
        } else {
            const uint32_t lt = (1u << lane) - 1u;
#pragma unroll
            for (int k = 0; k < VPL; ++k) {
                if (!ok[k]) continue;
                put_bits(buf, pay + lane_rank(vw, k, lt) * width, v[k], width);
            }
        }
    }
    __syncwarp();
    flush_record(buf, s, length, lane, stream, cap_w);
}

// ---------------------------------------------------------------------------
// float64: K1/K2 on 8x8 blocks, two values a lane (module comment)
// ---------------------------------------------------------------------------

struct EncP64 {
    double scale, inv;  // 1 / (2 * maxZError), 2 * maxZError
    int integ_mask;
};

// one quantized f64 value: q0 = rint((x - zmin) * scale) in [0, 2^30], and
// q0 + sign(resid) when the decoder's reconstruction of it is strictly closer
__device__ __forceinline__ uint32_t quantize_f64(double x, double zmin, double scale,
                                                 double inv) {
    const double q0 = fmin(fmax(rint(__dmul_rn(__dsub_rn(x, zmin), scale)), 0.0), 1073741824.0);
    const double resid = __dsub_rn(x, __dadd_rn(zmin, __dmul_rn(q0, inv)));
    const double sgn = resid > 0.0 ? 1.0 : (resid < 0.0 ? -1.0 : 0.0);
    const double qc = fmin(fmax(__dadd_rn(q0, sgn), 0.0), 1073741824.0);
    const double errc = fabs(__dsub_rn(x, __dadd_rn(zmin, __dmul_rn(qc, inv))));
    return (uint32_t)(errc < fabs(resid) ? qc : q0);
}

// the block offset: the bits of the first valid position (32k + lane order)
// whose value equals the block minimum; 0 without one
__device__ __forceinline__ unsigned long long first_min_bits(double x0, double x1, bool ok0,
                                                             bool ok1, double zmin) {
    const uint32_t m0 = __ballot_sync(FULL, ok0 && x0 == zmin);
    const uint32_t m1 = __ballot_sync(FULL, ok1 && x1 == zmin);
    const int src = m0 ? __ffs(m0) - 1 : (m1 ? __ffs(m1) - 1 : 0);
    const unsigned long long mine = (unsigned long long)__double_as_longlong(m0 ? x0 : x1);
    const unsigned long long bits = __shfl_sync(FULL, mine, src);
    return (m0 | m1) ? bits : 0ull;
}

template <bool MASKED>
__global__ void encode_blocks_f64_kernel(const double* __restrict__ data,
                                         const int2* __restrict__ valid, int w, int d, int nbh,
                                         int n_rec, int tile_rec, EncP64 P,
                                         int* __restrict__ rec_info,
                                         double* __restrict__ zrange) {
    __shared__ double s_min[WARPS], s_max[WARPS];
    __shared__ int s_di[WARPS];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = blockIdx.x * WARPS + warp;
    const bool live = r < n_rec;  // warp-uniform
    double lo = 0.0, hi = 0.0;
    int cnt = 0;
    if (live) {
        const int b = r / d, di = r % d;
        uint32_t vw0 = FULL, vw1 = FULL;
        cnt = 64;
        if constexpr (MASKED) {
            const int2 v = valid[b];
            vw0 = (uint32_t)v.x;
            vw1 = (uint32_t)v.y;
            cnt = __popc(vw0) + __popc(vw1);
        }
        const bool ok0 = !MASKED || ((vw0 >> lane) & 1u);
        const bool ok1 = !MASKED || ((vw1 >> lane) & 1u);
        double x0, x1;
        load_pair<double, MASKED>(data, w, d, nbh, b, di, lane, ok0, ok1, x0, x1);
        double zmin = fmin(ok0 ? x0 : CUDART_INF, ok1 ? x1 : CUDART_INF);
        double zmax = fmax(ok0 ? x0 : -CUDART_INF, ok1 ? x1 : -CUDART_INF);
        for (int o = 16; o > 0; o >>= 1) {
            zmin = fmin(zmin, __shfl_xor_sync(FULL, zmin, o));
            zmax = fmax(zmax, __shfl_xor_sync(FULL, zmax, o));
        }
        if (MASKED && cnt == 0) zmin = zmax = 0.0;  // const-0 record
        lo = zmin;
        hi = zmax;
        const unsigned long long off_bits = first_min_bits(x0, x1, ok0, ok1, zmin);
        const double off = __longlong_as_double((long long)off_bits);
        const uint32_t max_q = __reduce_max_sync(
            FULL, max(ok0 ? quantize_f64(x0, off, P.scale, P.inv) : 0u,
                      ok1 ? quantize_f64(x1, off, P.scale, P.inv) : 0u));
        if (lane == 0) {
            const int nb = bit_len(max_q);
            const bool const0 = (MASKED && cnt == 0) || (zmin == 0.0 && zmax == 0.0);
            const bool force_raw = __dmul_rn(__dsub_rn(zmax, zmin), P.scale) > 1073741823.0;
            // [flag][offset 8 B][numBits | 0x80][count][payload]: count byte width 1
            const int stuff_len = 9 + (max_q ? 2 + ((cnt * nb + 7) >> 3) : 0);
            const int raw_len = 1 + 8 * cnt;
            const bool use_stuff = !force_raw && stuff_len < raw_len;
            const int mode = const0 ? 2 : (use_stuff ? (max_q ? 1 : 3) : 0);
            const int length = mode == 2 ? 1 : (mode == 0 ? raw_len : stuff_len);
            const int integ = (((b % nbh) & 15) << 2) & P.integ_mask;
            int* info = rec_info + 4 * (size_t)r;
            info[0] = length;
            info[1] = (integ | mode) | (mode << 8) | (nb << 16) | (8 << 24);
            info[2] = (int)(uint32_t)off_bits;
            info[3] = (int)(uint32_t)(off_bits >> 32);
        }
    }
    merge_range(s_min, s_max, s_di, warp, lane, lo, hi,
                live && (!MASKED || cnt > 0) ? r % d + d * (r / tile_rec) : -1, d, zrange);
}

template <bool MASKED>
__global__ void write_records_f64_kernel(const double* __restrict__ data,
                                         const int2* __restrict__ valid, int w, int d, int nbh,
                                         int n_rec, EncP64 P, const int* __restrict__ rec_info,
                                         const int* __restrict__ starts,
                                         uint32_t* __restrict__ stream, long long cap_w) {
    constexpr int BUF_W = 132;  // record words: phase + 513 bytes (a raw record) + spill
    __shared__ uint32_t buf_all[WARPS][BUF_W];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = blockIdx.x * WARPS + warp;
    if (r >= n_rec) return;  // warp-uniform
    uint32_t* buf = buf_all[warp];
    for (int i = lane; i < BUF_W; i += 32) buf[i] = 0;
    __syncwarp();

    const int* info = rec_info + 4 * (size_t)r;
    const int length = info[0], desc = info[1];
    const int flag = desc & 0xFF, mode = (desc >> 8) & 3, nb = (desc >> 16) & 0xFF;
    const unsigned long long off_bits =
        (unsigned long long)(uint32_t)info[2] | ((unsigned long long)(uint32_t)info[3] << 32);
    const long long s = starts[r];
    const int sh = (int)(s & 3);
    const int b = r / d, di = r % d;
    uint32_t vw0 = FULL, vw1 = FULL;
    int cnt = 64;
    if constexpr (MASKED) {
        const int2 v = valid[b];
        vw0 = (uint32_t)v.x;
        vw1 = (uint32_t)v.y;
        cnt = __popc(vw0) + __popc(vw1);
    }

    if (lane == 0) {  // header: flag, offset (modes 1, 3), numBits byte and count (mode 1)
        unsigned char* bytes = reinterpret_cast<unsigned char*>(buf) + sh;
        bytes[0] = (unsigned char)flag;
        if (mode == 1 || mode == 3)
            for (int k = 0; k < 8; ++k) bytes[1 + k] = (unsigned char)(off_bits >> (8 * k));
        if (mode == 1) {
            bytes[9] = (unsigned char)(nb | 0x80);
            bytes[10] = (unsigned char)cnt;
        }
    }
    __syncwarp();

    if (mode == 0 || mode == 1) {  // the valid values raw, or bit-stuffed quanta at byte 11
        const bool ok0 = !MASKED || ((vw0 >> lane) & 1u);
        const bool ok1 = !MASKED || ((vw1 >> lane) & 1u);
        double x[2];
        load_pair<double, MASKED>(data, w, d, nbh, b, di, lane, ok0, ok1, x[0], x[1]);
        const double off = __longlong_as_double((long long)off_bits);
        const uint32_t lt = (1u << lane) - 1u;
        for (int k = 0; k < 2; ++k) {
            if (!(k ? ok1 : ok0)) continue;
            const int rank = !MASKED ? lane + 32 * k
                           : (k == 0 ? __popc(vw0 & lt) : __popc(vw0) + __popc(vw1 & lt));
            if (mode == 0) {
                const unsigned long long v = (unsigned long long)__double_as_longlong(x[k]);
                const int at = 8 * (sh + 1) + 64 * rank;
                put_bits(buf, at, (uint32_t)v, 32);
                put_bits(buf, at + 32, (uint32_t)(v >> 32), 32);
            } else {
                put_bits(buf, 8 * (sh + 11) + rank * nb, quantize_f64(x[k], off, P.scale, P.inv),
                         nb);
            }
        }
    }
    __syncwarp();
    flush_record(buf, s, length, lane, stream, cap_w);
}

// ---- launches

// the LUT-free K1, 8x8 blocks; valid null for an aligned all-valid image
template <typename T>
int launch_k1(const void* data, const int* valid, int h, int w, int d, const EncP& P,
              int* rec_info, void* zrange, int* fits, cudaStream_t st) {
    const int nbh = (w + 7) / 8;
    const int n_rec = ((h + 7) / 8) * nbh * d;
    const int grid = (n_rec + WARPS - 1) / WARPS;
    const T* x = static_cast<const T*>(data);
    const int2* v = reinterpret_cast<const int2*>(valid);
    auto* z = static_cast<typename ZOf<T>::type*>(zrange);
    if constexpr (std::is_same<T, float>::value) {
        if (valid)
            encode_blocks_masked_kernel<<<grid, WARPS * 32, 0, st>>>(x, v, w, d, nbh, n_rec, P,
                                                                     rec_info, z, fits);
        else
            encode_blocks_kernel<<<grid, WARPS * 32, 0, st>>>(x, w, d, nbh, n_rec, P, rec_info, z,
                                                              fits);
    } else {
        if (valid)
            encode_blocks_int_kernel<T, true><<<grid, WARPS * 32, 0, st>>>(
                x, v, w, d, nbh, n_rec, P, rec_info, z, fits);
        else
            encode_blocks_int_kernel<T, false><<<grid, WARPS * 32, 0, st>>>(
                x, nullptr, w, d, nbh, n_rec, P, rec_info, z, fits);
    }
    return (int)cudaGetLastError();
}

template <typename T, int MB>
int launch_k1_lut(const void* data, const int* valid, int h, int w, int d, int tile_rec,
                  const EncP& P, int* rec_info, void* zrange, int* fits, cudaStream_t st) {
    const int nbh = (w + MB - 1) / MB;
    const int n_rec = ((h + MB - 1) / MB) * nbh * d;
    const int grid = (n_rec + WARPS - 1) / WARPS;
    encode_blocks_lut_kernel<T, MB><<<grid, WARPS * 32, 0, st>>>(
        static_cast<const T*>(data), reinterpret_cast<const uint32_t*>(valid), w, d, nbh, n_rec,
        tile_rec > 0 ? tile_rec : n_rec, P, rec_info,
        static_cast<typename ZOf<T>::type*>(zrange), fits);
    return (int)cudaGetLastError();
}

// the LUT-free K2, 8x8 blocks; valid null for an aligned all-valid image
template <typename T>
int launch_k2(const void* data, const int* valid, int h, int w, int d, const EncP& P,
              const int* rec_info, const int* starts, uint32_t* out, long long cap_w,
              cudaStream_t st) {
    const int nbh = (w + 7) / 8;
    const int n_rec = ((h + 7) / 8) * nbh * d;
    const int grid = (n_rec + WARPS - 1) / WARPS;
    const T* x = static_cast<const T*>(data);
    const int2* v = reinterpret_cast<const int2*>(valid);
    if constexpr (std::is_same<T, float>::value) {
        if (valid)
            write_records_masked_kernel<<<grid, WARPS * 32, 0, st>>>(x, v, w, d, nbh, n_rec, P,
                                                                     rec_info, starts, out, cap_w);
        else
            write_records_kernel<<<grid, WARPS * 32, 0, st>>>(x, w, d, nbh, n_rec, P, rec_info,
                                                              starts, out, cap_w);
    } else {
        if (valid)
            write_records_int_kernel<T, true><<<grid, WARPS * 32, 0, st>>>(
                x, v, w, d, nbh, n_rec, P, rec_info, starts, out, cap_w);
        else
            write_records_int_kernel<T, false><<<grid, WARPS * 32, 0, st>>>(
                x, nullptr, w, d, nbh, n_rec, P, rec_info, starts, out, cap_w);
    }
    return (int)cudaGetLastError();
}

template <typename T, int MB>
int launch_k2_lut(const void* data, const int* valid, int h, int w, int d, const EncP& P,
                  const int* rec_info, const int* starts, uint32_t* out, long long cap_w,
                  cudaStream_t st) {
    const int nbh = (w + MB - 1) / MB;
    const int n_rec = ((h + MB - 1) / MB) * nbh * d;
    const int grid = (n_rec + WARPS - 1) / WARPS;
    write_records_lut_kernel<T, MB><<<grid, WARPS * 32, 0, st>>>(
        static_cast<const T*>(data), reinterpret_cast<const uint32_t*>(valid), w, d, nbh, n_rec,
        P, rec_info, starts, out, cap_w);
    return (int)cudaGetLastError();
}

EncP float_params(float mze, float scale, float inv, int integ_mask, int cap_nb, int raw_ok) {
    return EncP{mze, scale, inv, 1073741823.f, 0, 0, lerc2::DT_FLOAT, 4, integ_mask, cap_nb,
                raw_ok, 0};
}

// input element type codes of the integer entry points (the DataType codes
// of the element types; int32 input serves every dtype)
#define DISPATCH_INT_INPUT(in_type, FN, ...)                                   \
    switch (in_type) {                                                         \
        case 0: return FN<int8_t>(__VA_ARGS__);                                \
        case 1: return FN<uint8_t>(__VA_ARGS__);                               \
        case 2: return FN<int16_t>(__VA_ARGS__);                               \
        case 3: return FN<uint16_t>(__VA_ARGS__);                              \
        case 4: return FN<int32_t>(__VA_ARGS__);                               \
        case 5: return FN<uint32_t>(__VA_ARGS__);                              \
        default: return (int)cudaErrorInvalidValue;                            \
    }

}  // namespace

// valid: [nBlocks, 2] u32 validity words (masks, edge blocks), or null for
// an aligned all-valid image (then the all-valid kernel runs)
extern "C" int encode_blocks(const float* data, const int* valid, int h, int w, int d,
                             float mze, float scale, float inv, int integ_mask, int cap_nb,
                             int raw_ok, int* rec_info, float* zrange, int* fits,
                             void* stream) {
    const EncP P = float_params(mze, scale, inv, integ_mask, cap_nb, raw_ok);
    return launch_k1<float>(data, valid, h, w, d, P, rec_info, zrange, fits,
                            (cudaStream_t)stream);
}

extern "C" int write_records(const float* data, const int* valid, int h, int w, int d,
                             float scale, float inv, const int* rec_info, const int* starts,
                             uint32_t* out, long long cap_w, void* stream) {
    const EncP P = float_params(0.f, scale, inv, 0, 32, 1);
    return launch_k2<float>(data, valid, h, w, d, P, rec_info, starts, out, cap_w,
                            (cudaStream_t)stream);
}

// Integer K1: in_type is the element type of `data`, dt the codec's dtype
// (offset reduction, raw width); zrange: [2D] int32 set to INT_MAX / INT_MIN
extern "C" int encode_blocks_int(const void* data, int in_type, const int* valid, int h, int w,
                                 int d, int dt, int size_t_, float mze, float scale, int inv_i,
                                 int lossless, float maxq_cap, int integ_mask, int cap_nb,
                                 int raw_ok, int try_diff, int* rec_info, int* zrange,
                                 int* fits, void* stream) {
    const EncP P{mze, scale, 0.f, maxq_cap, inv_i, lossless, dt, size_t_, integ_mask, cap_nb,
                 raw_ok, try_diff};
    DISPATCH_INT_INPUT(in_type, launch_k1, data, valid, h, w, d, P, rec_info, zrange, fits,
                       (cudaStream_t)stream)
}

extern "C" int write_records_int(const void* data, int in_type, const int* valid, int h, int w,
                                 int d, int size_t_, float scale, int inv_i, int lossless,
                                 const int* rec_info, const int* starts, uint32_t* out,
                                 long long cap_w, void* stream) {
    const EncP P{0.f, scale, 0.f, 0.f, inv_i, lossless, 0, size_t_, 0, 32, 1, 0};
    DISPATCH_INT_INPUT(in_type, launch_k2, data, valid, h, w, d, P, rec_info, starts, out, cap_w,
                       (cudaStream_t)stream)
}

// The LUT instances (the band codec's and the mosaic's): mb 8 or 16,
// validity words always (all set for an aligned all-valid image); data
// float32 (is_int 0) or int32 (is_int 1, any integer dtype `dt`); zrange f32
// or int32 to match. tile_rec > 0: the image is a stack of tiles of
// tile_rec records each (tile height a multiple of mb), and zrange holds
// [nTiles, 2D] per-tile ranges; 0: one tile, zrange [2D].
extern "C" int encode_blocks_lut(const void* data, int is_int, const int* valid, int h, int w,
                                 int d, int mb, int dt, int size_t_, float mze, float scale,
                                 float inv, int inv_i, int lossless, float maxq_cap,
                                 int integ_mask, int cap_nb, int raw_ok, int try_diff,
                                 int tile_rec, int* rec_info, void* zrange, int* fits,
                                 void* stream) {
    const EncP P{mze, scale, inv, maxq_cap, inv_i, lossless, dt, size_t_, integ_mask, cap_nb,
                 raw_ok, try_diff};
    cudaStream_t st = (cudaStream_t)stream;
    if (!valid || (mb != 8 && mb != 16)) return (int)cudaErrorInvalidValue;
    if (is_int)
        return mb == 8 ? launch_k1_lut<int32_t, 8>(data, valid, h, w, d, tile_rec, P, rec_info,
                                                   zrange, fits, st)
                       : launch_k1_lut<int32_t, 16>(data, valid, h, w, d, tile_rec, P, rec_info,
                                                    zrange, fits, st);
    return mb == 8 ? launch_k1_lut<float, 8>(data, valid, h, w, d, tile_rec, P, rec_info, zrange,
                                             fits, st)
                   : launch_k1_lut<float, 16>(data, valid, h, w, d, tile_rec, P, rec_info, zrange,
                                              fits, st);
}

extern "C" int write_records_lut(const void* data, int is_int, const int* valid, int h, int w,
                                 int d, int mb, int size_t_, float scale, float inv, int inv_i,
                                 int lossless, const int* rec_info, const int* starts,
                                 uint32_t* out, long long cap_w, void* stream) {
    const EncP P{0.f, scale, inv, 0.f, inv_i, lossless, 0, size_t_, 0, 32, 1, 0};
    cudaStream_t st = (cudaStream_t)stream;
    if (!valid || (mb != 8 && mb != 16)) return (int)cudaErrorInvalidValue;
    if (is_int)
        return mb == 8 ? launch_k2_lut<int32_t, 8>(data, valid, h, w, d, P, rec_info, starts,
                                                   out, cap_w, st)
                       : launch_k2_lut<int32_t, 16>(data, valid, h, w, d, P, rec_info, starts,
                                                    out, cap_w, st);
    return mb == 8 ? launch_k2_lut<float, 8>(data, valid, h, w, d, P, rec_info, starts, out,
                                             cap_w, st)
                   : launch_k2_lut<float, 16>(data, valid, h, w, d, P, rec_info, starts, out,
                                              cap_w, st);
}

// float64, 8x8 blocks: valid [nBlocks, 2] u32 validity words (masks, edge
// blocks) or null for an aligned all-valid image; scale = 1 / (2 * maxZError)
// and inv = 2 * maxZError in f64; rec_info [nRec, 4] int32 = {length, desc,
// offset bits low, high}; zrange [2D] f64 set to (+inf, -inf); tile_rec as
// encode_blocks_lut's (> 0: [nTiles, 2D] per-tile ranges of a tile stack)
extern "C" int encode_blocks_f64(const double* data, const int* valid, int h, int w, int d,
                                 double scale, double inv, int integ_mask, int tile_rec,
                                 int* rec_info, double* zrange, void* stream) {
    const int nbh = (w + 7) / 8;
    const int n_rec = ((h + 7) / 8) * nbh * d;
    const int grid = (n_rec + WARPS - 1) / WARPS;
    const EncP64 P{scale, inv, integ_mask};
    const int2* v = reinterpret_cast<const int2*>(valid);
    const int tr = tile_rec > 0 ? tile_rec : n_rec;
    if (valid)
        encode_blocks_f64_kernel<true><<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
            data, v, w, d, nbh, n_rec, tr, P, rec_info, zrange);
    else
        encode_blocks_f64_kernel<false><<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
            data, nullptr, w, d, nbh, n_rec, tr, P, rec_info, zrange);
    return (int)cudaGetLastError();
}

extern "C" int write_records_f64(const double* data, const int* valid, int h, int w, int d,
                                 double scale, double inv, const int* rec_info, const int* starts,
                                 uint32_t* out, long long cap_w, void* stream) {
    const int nbh = (w + 7) / 8;
    const int n_rec = ((h + 7) / 8) * nbh * d;
    const int grid = (n_rec + WARPS - 1) / WARPS;
    const EncP64 P{scale, inv, 0};
    const int2* v = reinterpret_cast<const int2*>(valid);
    if (valid)
        write_records_f64_kernel<true><<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
            data, v, w, d, nbh, n_rec, P, rec_info, starts, out, cap_w);
    else
        write_records_f64_kernel<false><<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
            data, nullptr, w, d, nbh, n_rec, P, rec_info, starts, out, cap_w);
    return (int)cudaGetLastError();
}
