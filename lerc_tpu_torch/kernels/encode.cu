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
// slow there. On Hopper every K1 but the LUT one, and the integer and LUT
// K2, are strip kernels: a CTA owns a strip of consecutive blocks of one
// block row with all their records (record.cuh's strip_shape), staged in
// shared memory with 16-byte loads; the K1s decide a record a lane (the
// integer K1 a block and its depths a lane at D = 1 and 3; float64 four
// lanes a record), the K2s build the strip's records as one span. The LUT
// K1, the float32 K2 and the float64 K2 give a block a warp (or a group of
// lanes) instead: shuffles reduce it, and shared-memory atomicOr assembles
// its record.
//
// A warp-a-block body, one block of MB x MB values, VPL = MB*MB/32 values
// per lane: value j = 32k + lane (k < VPL) is block position j in row-major
// order. The LUT-free float32 K2 (8x8 blocks, the resident codecs') is a
// body of its own with two values a lane (write_records_body), no LUT branch
// and one count byte: served by the LUT template with a flag off, it ran
// slower per launch on the H100.
//
// Masks and edge blocks: each block's validity is VPL u32 words (bit j of
// word k = position 32k + j), exactly the ballots of the warp's lane rows.
// The masked instantiations read only the valid positions (positions past
// the image's edge are invalid), count the block's values with popc, and
// write value j at its rank among the valid positions: the stable left
// compaction, with no separate pass.
//
// LUT (the band codec's and the mosaic's instances, BitStuffer2::EncodeLut):
// n_lut is the count of the block's distinct non-zero quantized values, and
// a value's index is the inclusive count of distinct non-zero values up to
// it in sorted order. K1 takes the LUT record when max_q > 0, 1 <= n_lut <
// 255 and it is shorter than the plain stuffed one (device_encode.py:662-671,
// inside the integer depth-diff candidate too, :691-698); it counts n_lut in
// a set in shared memory, and only where the LUT can win (below). K2 needs
// no sort either: it writes [n_lut + 1][LUT at numBits][indices at
// bitlen(n_lut)] from the set of each LUT record's distinct values, a
// bitmap where nb is narrow (below), with no one-hot matrix.
//
// Bound: bytes. K1 reads the image once (size*H*W*D B) and writes 16 B per
// record; K2 reads the coded records' values again and writes the stream
// (`total` B); the masked ones also read 4*VPL B of validity words per
// record. Both do a few dozen operations per value, under the f32 rate's
// share of the bytes' time.
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
// roll chains. Here the arithmetic is native f64: K1 on the float32 K1's
// strips, four lanes a record (the block min and max, the offset the exact
// bits of the first valid position holding the min); K2 a warp a record,
// two values a lane. q = rint((x - zMin) * scale) in f64, clamped to
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

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <type_traits>

#include "block_scan.cuh"  // load16
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

// the float64 encoder's scalars
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
// K1, integer instances (encode_tiles :591-614, :651-653, :677-722): strips.
// A CTA of one warp owns a strip of S consecutive 8x8 blocks of one block
// row with all their D records (records r = b*D + di of consecutive blocks
// are consecutive), or, where one block's pixels at full depth pass the
// stage, one block and its depths in chunks of dc, each staged with the
// slice before it (the depth-diff candidate's): record.cuh's strip_shape
// with lead 1, the strips of decode.cu's K4 and K6 (2,048 pixels and 8 KB
// of image a strip; on uint8 x 3 S = 32: 6 KB). The strip's image rows
// are staged in shared memory with 16-byte loads (any W, D and alignment;
// rows and columns past the image are not read: their positions are
// invalid in the validity words, and the all-valid instance takes aligned
// images only). Then each record is decided by one thread, none waiting on
// another: at D = 1 and 3 (DC) a thread takes a block and all its depths,
// each block row read as 8-byte words (the D = 3 interleave costs no bank
// conflict: a block's depths lie in the same words) and the values cut
// from them at offsets known at compile time, the depth-diff candidate
// from the same words; at other depths (DC 0) a thread takes a record and
// reads its values and slice di-1 from the stage one at a time. The values
// give the block min and max in the dtype's order (order_flip), the diff's
// min and max, and, lossy, max_q by quantize_int in a second pass. Three
// quantities need no pass of their own, the same values as the per-value
// form: the f32 maximum is int_to_f32 of the max (the conversion is
// monotone in the order); lossless, max_q is hi - zmin, and max_qd is
// dmax - dmin (each value's distance from the min, as u32, is at most the
// max's). The record (int_record, the decision as before; a block forced
// raw takes no diff) goes to a shared buffer, stored as 16-byte stores over
// the strip; the per-depth ranges meet in shared atomics, one global
// atomicMin/atomicMax per depth and CTA (unsigned for uint32); fits is
// stored once, when it drops.
// ---------------------------------------------------------------------------

constexpr int K1S_PITCH = STRIP_OUT / 8 + 16;  // a staged row's bytes at most
constexpr int K1S_REC = 128;                   // records a strip or chunk at most

// the record of one integer block: lo, hi its min and max in the dtype's
// order (sentinels without a valid value), fmax their f32 maximum, max_q
// the widest quantum; the depth-diff candidate (cand) by dmin, dmax,
// max_qd; bcol the block's column. bad: the record does not fit the cap.
template <bool MASKED>
__device__ __forceinline__ int4 int_record(const EncP& P, int flip, int cnt, int lo, int hi,
                                           float fmax, uint32_t max_q, bool cand, int dmin,
                                           int dmax, uint32_t max_qd, int bcol, bool& bad) {
    int zmin = lo;
    if (MASKED && cnt == 0) zmin = 0, fmax = 0.f;  // const-0 record
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
        const int stuff_len_d = 1 + off_w_d + (max_qd ? 2 + ((cnt * nbd + 7) >> 3) : 0);
        const bool const0_d = dmin == 0 && dmax == 0;
        const int diff_len = const0_d ? 1 : stuff_len_d;
        // a block forced raw stays absolute (the reference tries no diff for it)
        use_diff = P.lossless && cnt > 0 && !const0 && !force_raw && diff_len < stuff_len
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
    const int integ = ((bcol & 15) << 2) & P.integ_mask;
    const int flag = integ | (use_diff ? 4 : 0) | mode | ((mode == 1 || mode == 3) ? tc << 6 : 0);
    bad = (mode == 1 && nb > P.cap_nb) || (mode == 0 && !P.raw_ok);
    const int desc = flag | (mode << 8) | ((int)use_diff << 10) | (nb << 16) | (off_w << 24);
    return make_int4(length, desc, (int)off_word, zq);
}

// a staged value as int32 (the element type's sign)
template <typename T>
__device__ __forceinline__ int staged(const uint8_t* p) {
    return (int)*reinterpret_cast<const T*>(p);
}

// element e (0..8*DC-1, pixel e / DC, depth e % DC) of a block row held in
// u32 words, at an offset known at compile time
template <typename T>
__device__ __forceinline__ int cut(const uint32_t* wd, int e) {
    const int b = e * (int)sizeof(T);
    const uint32_t v = wd[b >> 2] >> (8 * (b & 3));
    if constexpr (sizeof(T) == 4) return (int)v;
    else if constexpr (sizeof(T) == 2) return (int)(T)(v & 0xFFFFu);
    else return (int)(T)(v & 0xFFu);
}

// per-record sums of a thread: the range in the order's keys, the diff range
struct IntAcc {
    int lo, hi, dmin, dmax;
    __device__ void init() { lo = INT_MAX, hi = INT_MIN, dmin = 1 << 30, dmax = -(1 << 30); }
    __device__ void add(int x, int key_flip, bool ok) {
        const int k = x ^ key_flip;
        lo = min(lo, ok ? k : INT_MAX);
        hi = max(hi, ok ? k : INT_MIN);
    }
    __device__ void add_diff(int dv, bool ok) {
        dmin = min(dmin, ok ? dv : 1 << 30);
        dmax = max(dmax, ok ? dv : -(1 << 30));
    }
};

// the decision of one record from its sums (max_q of a lossy record from
// the second pass, passed in; lossless it is hi - zmin): the record into
// the shared buffer, the range into the shared per-depth words
template <bool MASKED>
__device__ __forceinline__ void int_decide(const EncP& P, int flip, int cnt, const IntAcc& a,
                                           uint32_t lossy_q, bool cand, int bcol, int4* srec,
                                           int q, int* s_lo, int* s_hi, int dd, bool& bad) {
    const int lo = a.lo ^ flip, hi = a.hi ^ flip;
    const bool has = !MASKED || cnt > 0;
    const float fmax = has ? int_to_f32(hi, flip) : -CUDART_INF_F;
    const uint32_t max_q = P.lossless ? (has ? (uint32_t)wrap_sub(hi, lo) : 0u) : lossy_q;
    int dmin = a.dmin, dmax = a.dmax;
    if (MASKED && cnt == 0) dmin = dmax = 0;
    const uint32_t max_qd = has ? (uint32_t)wrap_sub(dmax, dmin) : 0u;
    bool b = false;
    srec[q] = int_record<MASKED>(P, flip, cnt, lo, hi, fmax, max_q, cand, dmin, dmax, max_qd,
                                 bcol, b);
    bad |= b;
    if (has) {
        atomicMin(s_lo + dd, a.lo);
        atomicMax(s_hi + dd, a.hi);
    }
}

// the block's validity as 64 bits (bit j: position j) and its count
template <bool MASKED>
__device__ __forceinline__ uint64_t block_bits(const int2* valid, long long b, int& cnt) {
    if constexpr (!MASKED) {
        cnt = 64;
        return ~0ULL;
    } else {
        const int2 v = valid[b];
        const uint64_t m = (uint64_t)(uint32_t)v.x | (uint64_t)(uint32_t)v.y << 32;
        cnt = __popcll(m);
        return m;
    }
}

template <typename T, bool MASKED, int DC>
__global__ void __launch_bounds__(32) encode_blocks_int_kernel(
        const T* __restrict__ data, const int2* __restrict__ valid, int h, int w, int d, int nbh,
        int S, int dc, int spr, EncP P, int* __restrict__ rec_info, int* __restrict__ zrange,
        int* __restrict__ fits) {
    constexpr int SZ = sizeof(T);
    __shared__ __align__(16) uint8_t stage[8 * K1S_PITCH];
    __shared__ int4 srec[K1S_REC];
    __shared__ int s_lo[K1S_REC], s_hi[K1S_REC];
    const int lane = threadIdx.x;
    const int brow = blockIdx.x / spr, c0 = (blockIdx.x - brow * spr) * S;
    const int nb = min(S, nbh - c0);               // blocks of the strip
    const int row0 = 8 * brow, col0 = 8 * c0;
    const int npx = min(8 * nb, w - col0);         // in-image pixels a row
    const int rows = min(8, h - row0);
    const int flip = order_flip(P);
    const long long b0 = (long long)brow * nbh + c0;
    bool bad = false;
    for (int dlo = 0; dlo < d; dlo += dc) {
        const int dn = min(dc, d - dlo);
        const int sd0 = dn == d ? 0 : max(0, dlo - 1);  // the first staged depth
        const int nsl = dn == d ? d : dlo + dn - sd0;   // staged depths a pixel
        const int pitch = dn == d ? (8 * S * d * SZ + 15) / 16 * 16 : 8 * nsl * SZ;
        for (int i = lane; i < dn; i += 32) s_lo[i] = INT_MAX, s_hi[i] = INT_MIN;
        if (dn == d) {  // whole rows: the image's bytes, 16 a load
            const int len = npx * d * SZ, nch = (len + 15) / 16;
            for (int t = lane; t < rows * nch; t += 32) {
                const int r = t / nch, m = t - r * nch;
                const uint8_t* src = reinterpret_cast<const uint8_t*>(data)
                                     + (((long long)(row0 + r) * w + col0) * d) * SZ + 16 * m;
                *reinterpret_cast<uint4*>(stage + r * pitch + 16 * m) =
                    load16(src, min(16, len - 16 * m));
            }
        } else {  // a chunk of depths: element by element
            const int n = rows * npx * nsl;
            for (int t = lane; t < n; t += 32) {
                const int r = t / (npx * nsl), rem = t - r * npx * nsl;
                const int px = rem / nsl, k = rem - px * nsl;
                *reinterpret_cast<T*>(stage + r * pitch + (px * nsl + k) * SZ) =
                    data[((long long)(row0 + r) * w + col0 + px) * d + sd0 + k];
            }
        }
        __syncwarp();
        const bool try_diff = P.try_diff != 0;
        if constexpr (DC > 0) {  // a thread a block, all its depths (dn == d == DC)
            if (lane < nb) {
                int cnt;
                const uint64_t vm = block_bits<MASKED>(valid, b0 + lane, cnt);
                IntAcc a[DC];
#pragma unroll
                for (int k = 0; k < DC; ++k) a[k].init();
                const uint8_t* blk = stage + lane * 8 * DC * SZ;
#pragma unroll
                for (int r = 0; r < 8; ++r) {
                    uint32_t wd[2 * DC * SZ];
#pragma unroll
                    for (int k = 0; k < DC * SZ; ++k) {
                        const uint2 v = reinterpret_cast<const uint2*>(blk + r * pitch)[k];
                        wd[2 * k] = v.x, wd[2 * k + 1] = v.y;
                    }
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        const bool ok = !MASKED || (vm >> (8 * r + j) & 1u);
#pragma unroll
                        for (int k = 0; k < DC; ++k) {
                            const int x = cut<T>(wd, j * DC + k);
                            a[k].add(x, flip, ok);
                            if (k > 0 && try_diff)
                                a[k].add_diff(wrap_sub(x, cut<T>(wd, j * DC + k - 1)), ok);
                        }
                    }
                }
                uint32_t mq[DC];
#pragma unroll
                for (int k = 0; k < DC; ++k) mq[k] = 0;
                if (!P.lossless) {  // lossy: the quanta against each depth's min
                    int zm[DC];
#pragma unroll
                    for (int k = 0; k < DC; ++k) zm[k] = a[k].lo ^ flip;
#pragma unroll 1
                    for (int r = 0; r < 8; ++r) {  // a row at a time: the kernel's code stays small
                        uint32_t wd[2 * DC * SZ];
#pragma unroll
                        for (int k = 0; k < DC * SZ; ++k) {
                            const uint2 v = reinterpret_cast<const uint2*>(blk + r * pitch)[k];
                            wd[2 * k] = v.x, wd[2 * k + 1] = v.y;
                        }
#pragma unroll
                        for (int j = 0; j < 8; ++j) {
                            const bool ok = !MASKED || (vm >> (8 * r + j) & 1u);
#pragma unroll
                            for (int k = 0; k < DC; ++k) {
                                const uint32_t q = quantize_int(cut<T>(wd, j * DC + k), zm[k],
                                                                P.lossless, P.scale, P.inv_i);
                                mq[k] = max(mq[k], ok ? q : 0u);
                            }
                        }
                    }
                }
#pragma unroll
                for (int k = 0; k < DC; ++k)
                    int_decide<MASKED>(P, flip, cnt, a[k], mq[k], try_diff && k > 0, c0 + lane,
                                       srec, lane * DC + k, s_lo, s_hi, k, bad);
            }
        } else {  // a thread a record of the chunk
            for (int q = lane; q < nb * dn; q += 32) {
                const int bl = q / dn, di = dlo + q - bl * dn;
                int cnt;
                const uint64_t vm = block_bits<MASKED>(valid, b0 + bl, cnt);
                const bool cand = try_diff && di > 0;
                const int px_step = nsl * SZ;
                const uint8_t* at = stage + (bl * 8 * nsl + di - sd0) * SZ;
                IntAcc a;
                a.init();
                for (int r = 0; r < 8; ++r) {
                    for (int j = 0; j < 8; ++j) {
                        const bool ok = !MASKED || (vm >> (8 * r + j) & 1u);
                        const uint8_t* v = at + r * pitch + j * px_step;
                        const int x = staged<T>(v);
                        a.add(x, flip, ok);
                        if (cand) a.add_diff(wrap_sub(x, staged<T>(v - SZ)), ok);
                    }
                }
                uint32_t mq = 0;
                if (!P.lossless) {
                    const int zm = a.lo ^ flip;
                    for (int r = 0; r < 8; ++r) {
                        for (int j = 0; j < 8; ++j) {
                            const bool ok = !MASKED || (vm >> (8 * r + j) & 1u);
                            const int x = staged<T>(at + r * pitch + j * px_step);
                            const uint32_t qv = quantize_int(x, zm, P.lossless, P.scale, P.inv_i);
                            mq = max(mq, ok ? qv : 0u);
                        }
                    }
                }
                int_decide<MASKED>(P, flip, cnt, a, mq, cand, c0 + bl, srec, q, s_lo, s_hi,
                                   di - dlo, bad);
            }
        }
        __syncwarp();
        // the chunk's records: one contiguous span of rec_info
        int4* dst = reinterpret_cast<int4*>(rec_info) + b0 * d + dlo;
        for (int q = lane; q < nb * dn; q += 32) dst[q] = srec[q];
        for (int i = lane; i < dn; i += 32) {
            if (s_hi[i] < s_lo[i]) continue;  // no valid value at this depth
            int* zr = zrange + dlo + i;
            if (flip) {  // uint32: unsigned atomics on the values
                atomicMin((unsigned*)zr, (unsigned)(s_lo[i] ^ flip));
                atomicMax((unsigned*)(zr + d), (unsigned)(s_hi[i] ^ flip));
            } else {
                atomicMin(zr, s_lo[i]);
                atomicMax(zr + d, s_hi[i]);
            }
        }
        __syncwarp();  // the stage and buffers are the next chunk's
    }
    if (__any_sync(FULL, bad) && lane == 0) *fits = 0;
}

// ---------------------------------------------------------------------------
// K1, float32 and float64 (encode_tiles :556-597, :617-671, :726-744;
// device_f64.py::encode_tiles_f64 :163-277): strips, on the integer K1's
// machinery above. A strip is record.cuh's strip_shape with lead 0 (no
// depth-diff candidate): S consecutive 8x8 blocks of one block row with all
// their D records, or one block and its depths in chunks of dc (32 float32
// or 16 float64 depths: 8 KB of image); a CTA a strip. The strip is staged
// in shared memory: where a row of the image is 16-aligned by asynchronous
// 16-byte copies (cp.async: no registers held, every copy in flight at
// once), else by load16 (any W, D and alignment) or, for chunks, value by
// value; the validity words are read while the copies fly. Rows and columns
// past the image are not read: their positions are invalid in the validity
// words, and the all-valid instances take aligned images only. Then LPR
// lanes decide a record: float32 one lane a record (a CTA of one warp: S =
// 32 records at D = 1, 30 at D = 3), float64 four (a CTA of two warps, 16
// records at D = 1; a lane holds columns s and s + 4 of the block, and the
// reduction's two cross-lane steps are one shuffle each).
// - The min and max by fminf/fmaxf (fmin/fmax) in the order of a warp's
//   xor-shuffle reduction of the block as lane 0 sees it -- positions j and
//   j + 32 first, then strides 16, 8, 4, 2, 1, the lower position first,
//   the order of the earlier warp-a-block K1 -- so that the picks among
//   -0.0/+0.0 and NaN stay as they were; invalid positions are +-inf.
// - numBits from the max alone where it settles it (settled_q: the
//   quanta's maximum lies within one of zMax's q0, so where q0 - 1 and q0 +
//   1 have one bit length that is numBits; a constant block's quanta are
//   0): on DEM tiles all but ~0.1% of records. The others take a second
//   pass over the stage for the quanta's maximum (quantize, quantize_f64)
//   against the min. The f64 quantize costs a third of the float64 kernel
//   where every record takes the pass (chip_tune_k1float.py).
// - float64's offset: the bits of the first valid position in row-major
//   order holding the min. A non-zero finite min has one bit pattern, its
//   own; for a zero min (-0.0 and +0.0 in one block: the first one's) or
//   none, the pass (or a scan alone) finds the position. Quanta against
//   that offset equal those against the min: the two differ only in the
//   sign of a zero, which no quantum sees.
// D = 1 reads a row's values as 16-byte words (float32) or 8-byte values
// (float64) of the stage, the order of each lane's two turned by its block
// so that no two lanes of a quarter warp (float32) or a half warp (float64)
// read one bank: no bank conflicts by the address arithmetic. Other depths
// read one value at a time (2-way conflicts at D = 3). The record's
// decision (float_record, f64_record): const-0 for a block with no valid
// value, force_raw (float32: maxZError 0 and zMax > zMin, or a quantized
// range past 2^30 - 1; float64: past 2^30 - 1), the count byte of width 1,
// the reduced float32 offset, the full float64 one. Each record leaves as
// one 16-byte store (a strip's records are consecutive: the stores are
// coalesced). The per-depth ranges merge as the warp-a-block K1's did: in
// each group of 8 consecutive records (r / 8) by fminf/fmaxf in record
// order, then the groups through the integer order of atomic_min_z /
// atomic_max_z (IEEE bits, negative ones reversed) -- as keys in shared
// memory, one global pair a depth and strip, at a tile's ranges (tile_rec:
// a strip lies in one block row, hence in one tile of a stack). Where a
// group of 8 is split between two strips (S * D or the block row's records
// not a multiple of 8) each part merges on its own, which differs only
// where one part's records are all NaN. fits (float32) is stored once, when
// it drops.
//
// Bound: bytes (the image once, 16 B a record); the min and max and the
// settled numBits take a few operations a value, the pass (where taken)
// ~25 (float64: ~20 of them at the f64 rate).
// ---------------------------------------------------------------------------

// a 16-byte copy from the device's memory to shared memory that holds no
// registers: cp.async (the first `n` bytes read, the rest of the 16
// zeroed; src 16-aligned), completed by copy_async_wait
__device__ __forceinline__ void copy16_async(uint8_t* dst, const uint8_t* src, int n) {
#ifdef __CUDA_ARCH__
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
#else
    for (int i = 0; i < 16; ++i) dst[i] = i < n ? src[i] : 0;
#endif
}
__device__ __forceinline__ void copy_async_wait() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_all;\n" ::);
#endif
}

template <typename T> struct K1F;  // the float K1's choices per value type
template <> struct K1F<float> {
    using Params = EncP;
    using Key = int;
    static constexpr Key KEY_MAX = INT_MAX;
    static constexpr int LPR = 1;                 // lanes a record
    static constexpr int THREADS = 32 * LPR;      // a strip's 32 records at most
};
template <> struct K1F<double> {
    using Params = EncP64;
    using Key = long long;
    static constexpr Key KEY_MAX = LLONG_MAX;
    static constexpr int LPR = 4;
    static constexpr int THREADS = 16 * LPR;      // a strip's 16 records at most
};

__device__ __forceinline__ float zmin2(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ float zmax2(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double zmin2(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ double zmax2(double a, double b) { return fmax(a, b); }

// the order of atomic_min_z / atomic_max_z as a signed integer key, and back
__device__ __forceinline__ int z_key(float v) {
    const int b = __float_as_int(v);
    return b >= 0 ? b : b ^ INT_MAX;
}
__device__ __forceinline__ long long z_key(double v) {
    const long long b = __double_as_longlong(v);
    return b >= 0 ? b : b ^ LLONG_MAX;
}
__device__ __forceinline__ float z_of(int k) { return __int_as_float(k >= 0 ? k : k ^ INT_MAX); }
__device__ __forceinline__ double z_of(long long k) {
    return __longlong_as_double(k >= 0 ? k : k ^ LLONG_MAX);
}

// the float32 record (device_encode.py:643-671, :726-744); bad: it does not
// fit the cap
__device__ __forceinline__ int4 float_record(const EncP& P, bool masked, int cnt, float zmin,
                                             float zmax, uint32_t max_q, int bcol, bool& bad) {
    const int nb = bit_len(max_q);
    const float max_val = __fmul_rn(__fsub_rn(zmax, zmin), P.scale);
    const bool const0 = zmin == 0.f && zmax == 0.f;
    const bool force_raw = (P.mze == 0.f && zmax > zmin) || (P.mze > 0.f && max_val > 1073741823.f);
    int tc, off_w;
    uint32_t off_word;
    reduce_offset_float(zmin, tc, off_w, off_word);
    // count byte width 1 (cnt < 256); raw: 4 B a value
    const int stuff_len = 1 + off_w + (max_q ? 2 + (masked ? (cnt * nb + 7) >> 3 : 8 * nb) : 0);
    const int raw_len = masked ? 1 + 4 * cnt : 1 + 64 * 4;
    const bool use_stuff = !force_raw && stuff_len < raw_len;
    const int mode = const0 ? 2 : (use_stuff ? (max_q ? 1 : 3) : 0);
    const int length = mode == 2 ? 1 : (mode == 0 ? raw_len : stuff_len);
    const int integ = ((bcol & 15) << 2) & P.integ_mask;
    const int flag = integ | mode | ((mode == 1 || mode == 3) ? tc << 6 : 0);
    bad = (mode == 1 && nb > P.cap_nb) || (mode == 0 && !P.raw_ok);
    return make_int4(length, flag | (mode << 8) | (nb << 16) | (off_w << 24), (int)off_word,
                     __float_as_int(zmin));
}

// the float64 record (device_f64.py:201-277): [flag][offset 8 B][numBits |
// 0x80][count][payload], count byte width 1, raw 8 B a valid value
__device__ __forceinline__ int4 f64_record(const EncP64& P, bool masked, int cnt, double zmin,
                                           double zmax, uint32_t max_q,
                                           unsigned long long off_bits, int bcol) {
    const int nb = bit_len(max_q);
    const bool const0 = (masked && cnt == 0) || (zmin == 0.0 && zmax == 0.0);
    const bool force_raw = __dmul_rn(__dsub_rn(zmax, zmin), P.scale) > 1073741823.0;
    const int stuff_len = 9 + (max_q ? 2 + ((cnt * nb + 7) >> 3) : 0);
    const int raw_len = 1 + 8 * cnt;
    const bool use_stuff = !force_raw && stuff_len < raw_len;
    const int mode = const0 ? 2 : (use_stuff ? (max_q ? 1 : 3) : 0);
    const int length = mode == 2 ? 1 : (mode == 0 ? raw_len : stuff_len);
    const int integ = ((bcol & 15) << 2) & P.integ_mask;
    return make_int4(length, (integ | mode) | (mode << 8) | (nb << 16) | (8 << 24),
                     (int)(uint32_t)off_bits, (int)(uint32_t)(off_bits >> 32));
}

__device__ __forceinline__ uint32_t quantize_z(float x, float z, const EncP& P) {
    return quantize(x, z, P.scale, P.inv);
}
__device__ __forceinline__ uint32_t quantize_z(double x, double z, const EncP64& P) {
    return quantize_f64(x, z, P.scale, P.inv);
}

// bits [0, n) of a word, n <= 32
__device__ __forceinline__ unsigned low_bits(int n) { return n >= 32 ? ~0u : (1u << n) - 1u; }

__device__ __forceinline__ bool z_finite(float v) { return fabsf(v) < CUDART_INF_F; }
__device__ __forceinline__ bool z_finite(double v) { return fabs(v) < CUDART_INF; }

// The quanta's maximum where the block max's own quantum settles its bit
// length, with no pass over the values (false: the pass counts it). q0(x) =
// rint((x - zMin) * scale), each step rounded, is monotone in x, so every
// valid x <= zMax has q0(x) <= t = q0(zMax); its quantum is q0(x) or q0(x)
// +- 1, so the maximum lies in [t - 1, t + 1] (zMax's own is at least t -
// 1). Where t - 1 and t + 1 have one bit length (t >= 2) that is numBits,
// and t stands for the maximum (a record reads only its bit length and
// whether it is 0); where zMax == zMin every quantum is 0. Not settled: a
// range not finite (no valid value but NaN, an infinity), float32 maxZError
// 0, t < 2 or beside a power of two, float32 t past 2^24 (where q0 + 1
// rounds).
__device__ __forceinline__ bool settled_q(float zmin, float zmax, const EncP& P, uint32_t& q) {
    if (!(P.mze > 0.f) || !z_finite(zmin) || !z_finite(zmax)) return false;
    if (zmax == zmin) return q = 0, true;
    const float t = rintf(__fmul_rn(__fsub_rn(zmax, zmin), P.scale));
    if (!(t >= 2.f && t <= 16777214.f)) return false;
    q = (uint32_t)t;
    return bit_len(q - 1) == bit_len(q + 1);
}
__device__ __forceinline__ bool settled_q(double zmin, double zmax, const EncP64& P,
                                          uint32_t& q) {
    if (!z_finite(zmin) || !z_finite(zmax)) return false;
    if (zmax == zmin) return q = 0, true;
    const double t = rint(__dmul_rn(__dsub_rn(zmax, zmin), P.scale));
    if (!(t >= 2.0 && t <= 1073741822.0)) return false;
    q = (uint32_t)t;
    return bit_len(q - 1) == bit_len(q + 1);
}
__device__ __forceinline__ long long z_bits(double v) { return __double_as_longlong(v); }
__device__ __forceinline__ long long z_bits(float v) { return __float_as_int(v); }

// column j (< 8 / LPR) of the lane's share of a block row: all 8 (LPR 1),
// half s of {0, 1, 4, 5} / {2, 3, 6, 7} (LPR 2), or {s, s + 4} (LPR 4)
template <int LPR>
__device__ __forceinline__ int k1f_col(int j, int s) {
    return LPR == 1 ? j : LPR == 2 ? (j & 1) + 2 * s + 4 * (j >> 1) : s + 4 * j;
}

// the values of a 16-byte word of the stage into x[at .. at + 16 / size)
__device__ __forceinline__ void k1f_unpack(const uint4& v, float (&x)[8], int at) {
    x[at] = __uint_as_float(v.x), x[at + 1] = __uint_as_float(v.y);
    x[at + 2] = __uint_as_float(v.z), x[at + 3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void k1f_unpack(const uint4& v, double (&x)[4], int at) {
    x[at] = __hiloint2double((int)v.y, (int)v.x), x[at + 1] = __hiloint2double((int)v.w, (int)v.z);
}

// the lane's values of row r of its record: at D = 1 (ONE) as the row's two
// 16-byte words (float32: words 0, 1; float64: words s and 2 + s), loaded
// in the order rot turns (no two lanes of a quarter warp then read one
// bank), else one value at a time (`step` bytes a pixel)
template <typename T, int LPR, bool ONE>
__device__ __forceinline__ void k1f_row(const uint8_t* at, int step, int s, int rot,
                                        T (&x)[8 / LPR]) {
    if constexpr (ONE && LPR == 4) {  // columns s and s + 4, in the order rot turns
        const T a = *reinterpret_cast<const T*>(at + k1f_col<LPR>(rot, s) * step);
        const T b = *reinterpret_cast<const T*>(at + k1f_col<LPR>(rot ^ 1, s) * step);
        x[0] = rot ? b : a, x[1] = rot ? a : b;
    } else if constexpr (ONE) {
        static_assert(8 / LPR * sizeof(T) == 32, "a lane's share of a row is two 16-byte words");
        const int w0 = LPR == 1 ? rot : 2 * rot + s, w1 = LPR == 1 ? rot ^ 1 : 2 * (rot ^ 1) + s;
        const uint4 a = *reinterpret_cast<const uint4*>(at + 16 * w0);
        const uint4 b = *reinterpret_cast<const uint4*>(at + 16 * w1);
        k1f_unpack(rot ? b : a, x, 0);
        k1f_unpack(rot ? a : b, x, 16 / (int)sizeof(T));
    } else {
#pragma unroll
        for (int j = 0; j < 8 / LPR; ++j)
            x[j] = *reinterpret_cast<const T*>(at + k1f_col<LPR>(j, s) * step);
    }
}

template <typename T, bool MASKED, bool ONE>
__global__ void __launch_bounds__(K1F<T>::THREADS) encode_blocks_float_kernel(
        const T* __restrict__ data, const int2* __restrict__ valid, int h, int w, int d, int nbh,
        int S, int dc, int spr, int tile_rec, typename K1F<T>::Params P, int* __restrict__ rec_info,
        T* __restrict__ zrange, int* __restrict__ fits) {
    using Key = typename K1F<T>::Key;
    constexpr int SZ = sizeof(T), LPR = K1F<T>::LPR, CPL = 8 / LPR;  // columns a lane
    constexpr int NT = K1F<T>::THREADS;
    const T INF = sizeof(T) == 4 ? (T)CUDART_INF_F : (T)CUDART_INF;
    __shared__ __align__(16) uint8_t stage[8 * K1S_PITCH];
    __shared__ Key s_lo[32], s_hi[32];
    __shared__ T s_zl[32], s_zh[32];
    __shared__ unsigned s_has, s_recs;  // depths with a range, records with a valid value
    const int lane = threadIdx.x;  // a record's lane, or a thread of the strip
    const int brow = blockIdx.x / spr, c0 = (blockIdx.x - brow * spr) * S;
    const int nb = min(S, nbh - c0);               // blocks of the strip
    const int row0 = 8 * brow, col0 = 8 * c0;
    const int npx = min(8 * nb, w - col0);         // in-image pixels a row
    const int rows = min(8, h - row0);
    const long long b0 = (long long)brow * nbh + c0;
    T* zr_tile = zrange + (b0 * d / tile_rec) * 2 * d;
    const int q = lane / LPR, s = lane % LPR;      // the lane's record of a chunk, its half
    bool bad = false;
    for (int dlo = 0; dlo < d; dlo += dc) {
        const int dn = min(dc, d - dlo);
        const int pitch = dn == d ? (8 * S * d * SZ + 15) / 16 * 16 : 8 * dn * SZ;
        if (lane < dn) s_lo[lane] = K1F<T>::KEY_MAX, s_hi[lane] = -K1F<T>::KEY_MAX - 1;
        if (lane == 0) s_has = 0, s_recs = 0;
        const bool live = q < nb * dn;
        const int bl = live ? q / dn : 0, dq = live ? q - bl * dn : 0;
        int cnt;  // the validity words read before the image arrives
        const uint64_t vm = block_bits<MASKED>(valid, b0 + bl, cnt);
        if (dn == d) {  // whole rows: the image's bytes, 16 at a time
            const int len = npx * d * SZ, nch = (len + 15) / 16;
            const uint8_t* src = reinterpret_cast<const uint8_t*>(data)
                                 + ((long long)row0 * w + col0) * d * SZ;
            const long long row_b = (long long)w * d * SZ;
            if ((reinterpret_cast<uintptr_t>(src) | (uintptr_t)row_b) % 16 == 0) {
                for (int r = 0; r < rows; ++r)  // aligned rows: asynchronous copies
                    for (int m = lane; m < nch; m += NT)
                        copy16_async(stage + r * pitch + 16 * m, src + r * row_b + 16 * m,
                                     min(16, len - 16 * m));
                copy_async_wait();
            } else {
                for (int r = 0; r < rows; ++r)
                    for (int m = lane; m < nch; m += NT)
                        *reinterpret_cast<uint4*>(stage + r * pitch + 16 * m) =
                            load16(src + r * row_b + 16 * m, min(16, len - 16 * m));
            }
        } else {  // a chunk of depths: element by element
            const int n = rows * npx * dn;
            for (int t = lane; t < n; t += NT) {
                const int r = t / (npx * dn), rem = t - r * npx * dn;
                const int px = rem / dn, k = rem - px * dn;
                reinterpret_cast<T*>(stage + r * pitch)[px * dn + k] =
                    data[((long long)(row0 + r) * w + col0 + px) * d + dlo + k];
            }
        }
        __syncthreads();
        const int step = (dn == d ? d : dn) * SZ;  // bytes a pixel in the stage
        const uint8_t* at = stage + (bl * 8 * (step / SZ) + dq) * SZ;
        // 16-byte reads at D = 1: the order of the lane's words by its block
        const int rot = ONE ? (LPR == 1 ? (bl >> 2) & 1 : (bl >> 1) & 1) : 0;
        auto row_bits = [&](int r) {  // the validity bits of block row r
            return MASKED ? (uint32_t)(vm >> (8 * r)) & 0xFFu : 0xFFu;
        };
        // ---- the min and max in the warp reduction's order: rows r and
        // r + 4 (positions j and j + 32), then rows 0 and 2, 1 and 3, then
        // 0 and 1; then columns c and c + 4, c and c + 2, 0 and 1
        T lo_c[CPL], hi_c[CPL], lo_w[CPL], hi_w[CPL];  // rows 0, 4, 2, 6 and 1, 5, 3, 7
#pragma unroll
        for (int pr = 0; pr < 4; ++pr) {  // rows ra and ra + 4: ra = 0, 2, 1, 3
            const int ra = (pr & 1) * 2 + (pr >> 1);
            T xa[CPL], xb[CPL];
            k1f_row<T, LPR, ONE>(at + ra * pitch, step, s, rot, xa);
            k1f_row<T, LPR, ONE>(at + (ra + 4) * pitch, step, s, rot, xb);
            const uint32_t ba = row_bits(ra), bb = row_bits(ra + 4);
#pragma unroll
            for (int j = 0; j < CPL; ++j) {
                const int c = k1f_col<LPR>(j, s);
                const bool oa = ba >> c & 1u, ob = bb >> c & 1u;
                const T ul = zmin2(oa ? xa[j] : INF, ob ? xb[j] : INF);
                const T uh = zmax2(oa ? xa[j] : -INF, ob ? xb[j] : -INF);
                if (pr == 0) lo_c[j] = ul, hi_c[j] = uh;
                else if (pr == 1) lo_c[j] = zmin2(lo_c[j], ul), hi_c[j] = zmax2(hi_c[j], uh);
                else if (pr == 2) lo_w[j] = ul, hi_w[j] = uh;
                else lo_w[j] = zmin2(lo_w[j], ul), hi_w[j] = zmax2(hi_w[j], uh);
            }
        }
#pragma unroll
        for (int j = 0; j < CPL; ++j) lo_c[j] = zmin2(lo_c[j], lo_w[j]), hi_c[j] = zmax2(hi_c[j], hi_w[j]);
        T zmin, zmax;
        if constexpr (LPR == 1) {
#pragma unroll
            for (int o = 4; o > 0; o >>= 1) {
#pragma unroll
                for (int c = 0; c < o; ++c)
                    lo_c[c] = zmin2(lo_c[c], lo_c[c + o]), hi_c[c] = zmax2(hi_c[c], hi_c[c + o]);
            }
            zmin = lo_c[0], zmax = hi_c[0];
        } else if constexpr (LPR == 4) {  // columns s, s + 4 in the lane; then across lanes
            T l = zmin2(lo_c[0], lo_c[1]), hh = zmax2(hi_c[0], hi_c[1]);
#pragma unroll
            for (int o = 2; o > 0; o >>= 1) {  // columns c, c + 2, then 0 and 1: the lower first
                const T ol = __shfl_xor_sync(FULL, l, o), oh = __shfl_xor_sync(FULL, hh, o);
                l = s & o ? zmin2(ol, l) : zmin2(l, ol);
                hh = s & o ? zmax2(oh, hh) : zmax2(hh, oh);
            }
            zmin = l, zmax = hh;
        } else {  // columns c, c + 4 in the lane; c, c + 2 across the pair (half 0 first)
            const T l0 = zmin2(lo_c[0], lo_c[2]), l1 = zmin2(lo_c[1], lo_c[3]);
            const T h0 = zmax2(hi_c[0], hi_c[2]), h1 = zmax2(hi_c[1], hi_c[3]);
            const T ol0 = __shfl_xor_sync(FULL, l0, 1), ol1 = __shfl_xor_sync(FULL, l1, 1);
            const T oh0 = __shfl_xor_sync(FULL, h0, 1), oh1 = __shfl_xor_sync(FULL, h1, 1);
            zmin = zmin2(s ? zmin2(ol0, l0) : zmin2(l0, ol0), s ? zmin2(ol1, l1) : zmin2(l1, ol1));
            zmax = zmax2(s ? zmax2(oh0, h0) : zmax2(h0, oh0), s ? zmax2(oh1, h1) : zmax2(h1, oh1));
        }
        if (MASKED && cnt == 0) zmin = zmax = (T)0;  // const-0 record
        // ---- the quanta's maximum, where the max's quantum does not settle
        // it (settled_q); float64 also the first position at the min, where
        // the min is a zero or not finite (else the offset is the min's bits)
        uint32_t max_q = 0, q_set = 0;
        const bool settled = settled_q(zmin, zmax, P, q_set);
        const bool scan = LPR > 1 && !(zmin != (T)0 && z_finite(zmin));
        int first = 64;
        if (!settled || scan) {
#pragma unroll 1
            for (int r = 0; r < 8; ++r) {
                T x[CPL];
                k1f_row<T, LPR, ONE>(at + r * pitch, step, s, rot, x);
                const uint32_t br = row_bits(r);
#pragma unroll
                for (int j = 0; j < CPL; ++j) {
                    const bool ok = br >> k1f_col<LPR>(j, s) & 1u;
                    if (!settled) max_q = max(max_q, ok ? quantize_z(x[j], zmin, P) : 0u);
                    if (LPR > 1 && ok && x[j] == zmin)
                        first = min(first, 8 * r + k1f_col<LPR>(j, s));
                }
            }
        }
        if (settled) max_q = q_set;
        int4 rec;
        if constexpr (LPR == 1) {
            bool b = false;
            rec = float_record(P, MASKED, cnt, zmin, zmax, max_q, c0 + bl, b);
            bad |= live && b;
        } else {
#pragma unroll
            for (int o = 1; o < LPR; o <<= 1) {
                max_q = max(max_q, __shfl_xor_sync(FULL, max_q, o));
                first = min(first, __shfl_xor_sync(FULL, first, o));
            }
            const unsigned long long off_bits =
                !scan ? (unsigned long long)z_bits(zmin)
                : first < 64 ? *reinterpret_cast<const unsigned long long*>(
                                   at + (first >> 3) * pitch + (first & 7) * step)
                             : 0ull;
            rec = f64_record(P, MASKED, cnt, zmin, zmax, max_q, off_bits, c0 + bl);
        }
        const long long rb = b0 * d + dlo;  // the chunk's first record
        if (live && s == 0) {
            reinterpret_cast<int4*>(rec_info)[rb + q] = rec;
            s_zl[q] = zmin, s_zh[q] = zmax;
            if (!MASKED || cnt > 0) atomicOr(&s_recs, 1u << q);
        }
        // the ranges: in each group of 8 records (r / 8) a chain per depth in
        // record order, then the groups' keys, one global pair a depth
        __syncthreads();
        const unsigned has = s_recs;
        const int nq = nb * dn;
        if (lane < nq && (has >> lane & 1u)) {
            const int gs = lane - (int)((rb + lane) & 7), g0 = max(0, gs), g1 = min(nq, gs + 8);
            const int dl = ONE ? 0 : lane % dn;
            unsigned at_dl = ~0u;  // the chunk's records at depth dl, as bits
            if (!ONE) {
                at_dl = 0;
                for (int k = dl; k < nq; k += dn) at_dl |= 1u << k;
            }
            const unsigned mine = has & at_dl;
            if (!(mine & ((1u << lane) - (1u << g0)))) {  // the group's first at this depth
                T l = s_zl[lane], hh = s_zh[lane];
                // the group's later records at this depth, in record order
                for (unsigned m = mine & (low_bits(g1) & ~low_bits(lane + 1)); m; m &= m - 1) {
                    const int k = __ffs((int)m) - 1;
                    l = zmin2(l, s_zl[k]), hh = zmax2(hh, s_zh[k]);
                }
                atomicMin(s_lo + dl, z_key(l));
                atomicMax(s_hi + dl, z_key(hh));
                atomicOr(&s_has, 1u << dl);
            }
        }
        __syncthreads();
        if (lane < dn && (s_has >> lane & 1u)) {
            T* zr = zr_tile + dlo + lane;
            atomic_min_z(zr, z_of(s_lo[lane]));
            atomic_max_z(zr + d, z_of(s_hi[lane]));
        }
        __syncthreads();  // the stage and the keys are the next chunk's
    }
    if (__any_sync(FULL, bad) && (lane & 31) == 0) *fits = 0;
}

// ---------------------------------------------------------------------------
// K2, integer instances (encode_tiles :889-958 with the integer values
// :591-614, :677-722): strips. A CTA of K2S_THREADS owns the strip of the
// integer K1 (record.cuh strip_shape with lead 1: S consecutive 8x8 blocks
// of one block row with all their D records, or one block and its depths in
// chunks, each staged with the slice before it), whose image rows it stages
// in shared memory with 16-byte loads as K1 does; the chunk's rec_info and
// starts are one coalesced read each. Its records are consecutive, so their
// bytes are one span [starts[ra], starts[rb]), built in a zeroed buffer in
// shared memory by shared atomicOr: each header by one thread, each block
// row of each record's payload by one thread, which packs the row's values
// -- taken from the stage: quantize_int against the block min, the
// difference to slice di-1 less the diff min, or the raw bytes, as the
// warp-a-record body did -- LSB-first at the bit its rank gives (with a
// mask, the valid positions before the row) and ORs the words it fills.
// The CTA then writes the span with aligned 16-byte stores; only the
// 16-byte chunks it shares with the neighbouring strips merge by atomicOr
// into the zeroed stream (words past cap_w are not written). A stuffed
// record is shorter than its raw form, so a span holds at most the strip's
// image bytes plus a byte a record; where a chunk's starts are not the
// running sum of its lengths, or its span passes the buffer, its records
// go one at a time. At D = 1 and 3 (DC) the record's block is a constant
// division away.
// ---------------------------------------------------------------------------

constexpr int K2S_THREADS = 128;  // 256 ran 8-25% slower (chip_tune_k4k2.py)
constexpr int K2S_SPAN = STRIP_OUT + K1S_REC + 32;  // span bytes, with the head's misalignment

// OR `v` into word wi of the span's buffer, its bits at or past bit `end` dropped
__device__ __forceinline__ void k2_or(uint32_t* buf, int wi, uint32_t v, int end) {
    const int lo = 32 * wi;
    if (end <= lo) return;
    if (end < lo + 32) v &= (1u << (end - lo)) - 1u;
    if (v) atomicOr(buf + wi, v);
}

template <typename T, bool MASKED, int DC>
__global__ void __launch_bounds__(K2S_THREADS) write_records_int_kernel(
        const T* __restrict__ data, const int2* __restrict__ valid, int h, int w, int d, int nbh,
        int S, int dc, int spr, EncP P, const int* __restrict__ rec_info,
        const int* __restrict__ starts, uint32_t* __restrict__ stream, long long cap_w) {
    constexpr int SZ = sizeof(T);
    __shared__ __align__(16) uint8_t stage[8 * K1S_PITCH];
    __shared__ uint4 span4[K2S_SPAN / 16];
    __shared__ int4 srec[K1S_REC];
    __shared__ int sst[K1S_REC];
    __shared__ uint64_t bm[STRIP_PX / 64];  // the blocks' validity
    uint32_t* buf = reinterpret_cast<uint32_t*>(span4);
    const int tid = threadIdx.x;
    const int brow = blockIdx.x / spr, c0 = (blockIdx.x - brow * spr) * S;
    const int nb = min(S, nbh - c0);        // blocks of the strip
    const int row0 = 8 * brow, col0 = 8 * c0;
    const int npx = min(8 * nb, w - col0);  // in-image pixels a row
    const int rows = min(8, h - row0);
    const long long b0 = (long long)brow * nbh + c0;
    if (tid < nb) {
        int cnt;
        bm[tid] = block_bits<MASKED>(valid, b0 + tid, cnt);
    }
    for (int dlo = 0; dlo < d; dlo += dc) {
        const int dn = DC ? DC : min(dc, d - dlo);
        const int sd0 = dn == d ? 0 : max(0, dlo - 1);  // the first staged depth
        const int nsl = dn == d ? d : dlo + dn - sd0;   // staged depths a pixel
        const int pitch = dn == d ? (8 * S * d * SZ + 15) / 16 * 16 : 8 * nsl * SZ;
        const int n_r = nb * dn;
        const long long ra = b0 * d + dlo;  // the chunk's records are consecutive
        if (dn == d) {  // whole rows: the image's bytes, 16 a load
            const int len = npx * d * SZ, nch = (len + 15) / 16;
            for (int t = tid; t < rows * nch; t += K2S_THREADS) {
                const int r = t / nch, m = t - r * nch;
                const uint8_t* src = reinterpret_cast<const uint8_t*>(data)
                                     + (((long long)(row0 + r) * w + col0) * d) * SZ + 16 * m;
                *reinterpret_cast<uint4*>(stage + r * pitch + 16 * m) =
                    load16(src, min(16, len - 16 * m));
            }
        } else {  // a chunk of depths: element by element
            const int n = rows * npx * nsl;
            for (int t = tid; t < n; t += K2S_THREADS) {
                const int r = t / (npx * nsl), rem = t - r * npx * nsl;
                const int px = rem / nsl, k = rem - px * nsl;
                *reinterpret_cast<T*>(stage + r * pitch + (px * nsl + k) * SZ) =
                    data[((long long)(row0 + r) * w + col0 + px) * d + sd0 + k];
            }
        }
        bool contig = true;  // each start the running sum of the lengths before it
        for (int t = tid; t < n_r; t += K2S_THREADS) {
            srec[t] = reinterpret_cast<const int4*>(rec_info)[ra + t];
            sst[t] = starts[ra + t];
            if (t + 1 < n_r) contig &= starts[ra + t + 1] - sst[t] == srec[t].x;
        }
        contig = __syncthreads_and(contig);
        const long long span_len = (long long)sst[n_r - 1] - sst[0] + srec[n_r - 1].x;
        const bool one = contig && span_len > 0 && span_len + 16 <= K2S_SPAN;
        for (int ga = 0; ga < n_r; ga = one ? n_r : ga + 1) {  // groups: the chunk, or a record
            const int gb = one ? n_r : ga + 1;
            const long long g0 = sst[ga];
            const int mis = (int)(g0 & 15);
            const int len = one ? (int)span_len : max(0, min(srec[ga].x, K2S_SPAN - 16));
            for (int c = tid; c < (mis + len + 15) >> 4; c += K2S_THREADS)
                span4[c] = make_uint4(0, 0, 0, 0);
            __syncthreads();
            for (int t = ga + tid; t < gb; t += K2S_THREADS) {  // headers (Lerc2 WriteTile)
                const int4 ri = srec[t];
                const int mode = (ri.y >> 8) & 3, off_w = ri.y >> 24;
                const int at = mis + (sst[t] - (int)g0), bl = t / dn;
                const int hl = min(mode == 1 ? 3 + off_w : mode == 3 ? 1 + off_w : 1, ri.x);
                const int cnt = MASKED ? __popcll(bm[bl]) : 64;
                for (int k = 0; k < hl; ++k) {  // flag, offset bytes, numBits byte, count
                    const uint32_t b = (k == 0 ? (uint32_t)ri.y
                                        : k <= off_w ? (uint32_t)ri.z >> (8 * (k - 1))
                                        : k == 1 + off_w ? (uint32_t)((ri.y >> 16) | 0x80)
                                                         : (uint32_t)cnt) & 0xFFu;
                    if (at + k >= 0) k2_or(buf, (at + k) >> 2, b << (8 * ((at + k) & 3)),
                                           8 * K2S_SPAN);
                }
            }
            for (int it = tid; it < 8 * (gb - ga); it += K2S_THREADS) {  // payload rows
                const int r = it / (gb - ga), t = ga + it - r * (gb - ga);
                const int4 ri = srec[t];
                const int mode = (ri.y >> 8) & 3, off_w = ri.y >> 24;
                if (mode != 0 && mode != 1) continue;
                const int bl = t / dn, di = dlo + t - bl * dn;
                const uint64_t vm = bm[bl];
                const int width = mode == 0 ? 8 * P.size : (ri.y >> 16) & 0xFF;
                const int rank0 = MASKED ? __popcll(vm & ((1ull << (8 * r)) - 1)) : 8 * r;
                const int hl = mode == 1 ? 3 + off_w : 1;
                const int at = mis + (sst[t] - (int)g0);
                if (at < 0) continue;
                const int end = min(at + ri.x, K2S_SPAN) * 8;  // no bit past the record
                const int bit = (at + hl) * 8 + rank0 * width;
                const bool diff = (ri.y >> 10) & 1, prev_staged = di > sd0;
                const uint8_t* rp = stage + r * pitch + ((bl * 8) * nsl + di - sd0) * SZ;
                int wi = bit >> 5, nacc = bit & 31;
                uint64_t acc = 0;
#pragma unroll
                for (int c = 0; c < 8; ++c) {
                    if (MASKED && !((vm >> (8 * r + c)) & 1u)) continue;
                    const uint8_t* v_at = rp + c * nsl * SZ;
                    const int x = staged<T>(v_at);
                    uint32_t v;
                    if (mode == 0) v = low_bytes((uint32_t)x, P.size);
                    else if (diff) v = (uint32_t)wrap_sub(
                        wrap_sub(x, prev_staged ? staged<T>(v_at - SZ) : 0), ri.w);
                    else v = quantize_int(x, ri.w, P.lossless, P.scale, P.inv_i);
                    acc |= (uint64_t)v << nacc;
                    nacc += width;
                    if (nacc >= 32) {
                        k2_or(buf, wi++, (uint32_t)acc, end);
                        acc >>= 32;
                        nacc -= 32;
                    }
                }
                if (nacc > 0) k2_or(buf, wi, (uint32_t)acc, end);
            }
            __syncthreads();
            // the span to the stream: whole chunks stored, the edge chunks' words ORed
            const long long gw0 = (g0 - mis) >> 2;
            for (int c = tid; c < (mis + len + 15) >> 4; c += K2S_THREADS) {
                const long long gw = gw0 + 4 * c;
                if (16 * c >= mis && 16 * c + 16 <= mis + len && gw >= 0 && gw + 4 <= cap_w) {
                    *reinterpret_cast<uint4*>(stream + gw) = span4[c];
                    continue;
                }
                for (int q = 0; q < 4; ++q) {
                    const int a = 16 * c + 4 * q;  // the word's bytes [a, a + 4) meet the span
                    if (gw + q < 0 || gw + q >= cap_w || a + 4 <= mis || a >= mis + len) continue;
                    atomicOr(stream + gw + q, buf[4 * c + q]);
                }
            }
            __syncthreads();  // the buffer is the next group's
        }
    }
}

// ---- K1 with the LUT candidate (the band codec's and the mosaic's), 8x8
// or 16x16 blocks: G lanes a record (K1L_LANES8 / K1L_LANES16), 32 / G
// records a warp, lane gl of a record holding its positions j = G*k + gl
// (k < MB*MB/G: for G = MB, lane gl holds column gl and k is the row). The
// group reduces by xor shuffles within its lanes; every lane of a group
// computes the record's decision (the groups of a warp decide side by side)
// and lane 0 of the group stores it. Validity words are read only by the
// masked instances (masks, edge blocks); an aligned all-valid image passes
// none.
//
// The LUT record needs n_lut, the count of the block's distinct non-zero
// quanta, and needs it only where it can be shorter than the stuffed one:
// its length grows with n_lut, so where lut_possible fails at n_lut = 1
// (and where max_q is 0, or the record is const-0 or forced raw) no count
// is made, and a count stops at the first k (16x16: the first odd k) where
// the values so far make the LUT the longer record (lut_shorter). The group
// counts in a set of its own in shared memory (SLOTS = 2 * MB*MB words,
// cleared by the group before each count): where max_q < 32 * SLOTS a
// bitmap of the quanta over W = 2^w words, quantum v at bit v >> w of word
// v & (W - 1) (neighbouring values in other words and banks), else an
// open-addressing hash set of the values (0 is the empty slot: the value 0
// is never counted); inserts by atomicOr / atomicCAS, n_lut the group's sum
// of the ballots of its fresh inserts. A value equal to the one before it
// in the same lane (k - 1) is not inserted again. The depth-diff candidate
// counts in the same set after a clear.

constexpr int K1L_WARPS = 4;    // warps a CTA (chip_tune_k1lut.py: 8 ran up to 18% slower)
constexpr int K1L_LANES8 = 8;   // lanes a record, 8x8 blocks
constexpr int K1L_LANES16 = 16; // lanes a record, 16x16 blocks

template <int MB>
struct K1L {
    static constexpr int G = MB == 8 ? K1L_LANES8 : K1L_LANES16;  // lanes a record
    static constexpr int VPL = MB * MB / G;                       // values a lane
    static constexpr int RPW = 32 / G;                            // records a warp
    static constexpr int RPC = RPW * K1L_WARPS;                   // records a CTA
    static constexpr int SLOTS = 2 * MB * MB;                     // set words a record
    static constexpr int LOG_SLOTS = MB == 8 ? 7 : 9;
    static constexpr int VW = MB * MB / 32;                       // validity words a block
};

// v reduced over the G lanes of each group (xor shuffles stay in the group)
template <int G, typename V, typename F>
__device__ __forceinline__ V group_reduce(V v, F op) {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

// is a LUT record of n entries of nb bits over cnt values shorter than the
// stuffed one (lut_candidate's lengths less the header bytes both share)?
__device__ __forceinline__ bool lut_shorter(int n, int nb, int cnt) {
    return n < 255 && 1 + ((n * nb + 7) >> 3) + ((cnt * bit_len((uint32_t)n) + 7) >> 3)
                      < ((cnt * nb + 7) >> 3);
}

// can a LUT record of n_lut >= 1 entries be the shorter one? Where it is
// weakest: at n_lut = 1 (both LUT terms grow with n_lut)
__device__ __forceinline__ bool lut_possible(int nb, int cnt) { return lut_shorter(1, nb, cnt); }

// n_lut of the group's record: its distinct non-zero quanta q (0 where
// invalid, nb bits at most), counted where `need` (group-uniform) until the
// LUT is the longer record -- the count so far then stands for every larger
// one -- else 0. Every lane of the warp calls it (warp-wide collectives);
// `set` is the group's SLOTS words.
template <int MB>
__device__ __forceinline__ int distinct_count(uint32_t* set, const uint32_t (&q)[K1L<MB>::VPL],
                                              bool need, uint32_t max_q, int nb, int cnt,
                                              int lane) {
    using C = K1L<MB>;
    const int gl = lane % C::G;
    const unsigned gmask = C::G == 32 ? FULL : ((1u << C::G) - 1u) << (lane - gl);
    const bool bitmap = max_q < 32u * C::SLOTS;
    const int lw = bitmap ? bit_len(max_q >> 5) : 0;  // W = 2^lw words hold the bitmap
    __syncwarp();  // the set's last count is over
    if (need) {
        const int nw = bitmap ? 1 << lw : C::SLOTS;  // 16-byte stores where 4 words or more
        for (int i = gl; i < nw >> 2; i += C::G) reinterpret_cast<uint4*>(set)[i] = uint4{};
        if (nw < 4 && gl < nw) set[gl] = 0;
    }
    __syncwarp();
    int n = 0;
    bool done = !need;
#pragma unroll
    for (int k = 0; k < C::VPL; ++k) {
        const uint32_t v = q[k];
        bool fresh = false;
        if (!done && v != 0 && (k == 0 || v != q[k - 1])) {
            if (bitmap) {
                const uint32_t bit = 1u << (v >> lw);
                fresh = (atomicOr(set + (v & ((1u << lw) - 1u)), bit) & bit) == 0;
            } else {
                uint32_t h = (v * 2654435761u) >> (32 - C::LOG_SLOTS);
                for (;;) {
                    const uint32_t old = atomicCAS(set + h, 0u, v);
                    if (old == 0u || old == v) {
                        fresh = old == 0u;
                        break;
                    }
                    h = (h + 1) & (C::SLOTS - 1);
                }
            }
        }
        n += __popc(__ballot_sync(FULL, fresh) & gmask);
        if (C::VPL <= 8 || k % 2 == 1)  // 16x16: at every 2nd k, which ran faster
            done = done || !lut_shorter(n, nb, cnt);
    }
    return n;
}

template <typename T, int MB, bool MASKED>
__global__ void __launch_bounds__(K1L_WARPS * 32) encode_blocks_lut_kernel(
        const T* __restrict__ data, const uint32_t* __restrict__ valid, int w, int d, int nbh,
        int n_rec, int tile_rec, EncP P, int* __restrict__ rec_info,
        typename ZOf<T>::type* __restrict__ zrange, int* __restrict__ fits) {
    using Z = typename ZOf<T>::type;
    using C = K1L<MB>;
    constexpr bool IS_INT = !std::is_same<T, float>::value;
    constexpr int G = C::G, VPL = C::VPL;
    __shared__ __align__(16) uint32_t s_set[C::RPC * C::SLOTS];
    __shared__ Z s_lo[C::RPC], s_hi[C::RPC];
    __shared__ int s_has[C::RPC];
    const int lane = threadIdx.x & 31, gl = lane % G;
    const int slot = (threadIdx.x >> 5) * C::RPW + lane / G;  // the record's place in the CTA
    const int r0 = blockIdx.x * C::RPC;
    const bool live = r0 + slot < n_rec;              // group-uniform
    const int r = live ? r0 + slot : n_rec - 1;       // a dead group repeats the last record
    const int b = d == 1 ? r : r / d, di = r - b * d;
    const int brow = b / nbh, bcol = b - brow * nbh;
    const int flip = IS_INT ? order_flip(P) : 0;
    uint32_t* set = s_set + slot * C::SLOTS;

    // the block's values and validity: value k at position j = G*k + gl
    uint32_t vw[C::VW];
    int cnt = MB * MB;
    if constexpr (MASKED) {
        cnt = 0;
#pragma unroll
        for (int i = 0; i < C::VW; ++i) {
            vw[i] = valid[(size_t)b * C::VW + i];
            cnt += __popc(vw[i]);
        }
    }
    const T* at = data + ((size_t)brow * MB * w + (size_t)bcol * MB) * d + di;
    bool ok[VPL];
    T x[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
        const int j = G * k + gl;
        ok[k] = !MASKED || ((vw[(G * k) >> 5] >> (((G * k) & 31) + gl)) & 1u);
        x[k] = ok[k] ? at[((size_t)(j / MB) * w + j % MB) * d] : (T)0;
    }

    // the range, the quanta and their widest
    uint32_t q[VPL];
    float fmax = -CUDART_INF_F, zmin_f = 0.f;
    int zmin_i = 0;
    Z lo, hi;  // the block's range over its valid values (flipped order for uint32)
    if constexpr (IS_INT) {
        int l = INT_MAX, h = INT_MIN;
#pragma unroll
        for (int k = 0; k < VPL; ++k) {
            if (ok[k]) {
                l = min(l, (int)x[k] ^ flip);
                h = max(h, (int)x[k] ^ flip);
                fmax = fmaxf(fmax, int_to_f32((int)x[k], flip));
            }
        }
        lo = group_reduce<G>(l, [](int a, int c) { return min(a, c); });
        hi = group_reduce<G>(h, [](int a, int c) { return max(a, c); });
        fmax = group_reduce<G>(fmax, [](float a, float c) { return fmaxf(a, c); });
        zmin_i = lo ^ flip;
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
        l = group_reduce<G>(l, [](float a, float c) { return fminf(a, c); });
        h = group_reduce<G>(h, [](float a, float c) { return fmaxf(a, c); });
        lo = l;
        hi = h;
        if (cnt == 0) l = h = 0.f;  // const-0 record
        zmin_f = l;
        fmax = h;
#pragma unroll
        for (int k = 0; k < VPL; ++k)
            q[k] = ok[k] ? quantize((float)x[k], zmin_f, P.scale, P.inv) : 0u;
    }
    uint32_t max_q = 0;
#pragma unroll
    for (int k = 0; k < VPL; ++k) max_q = max(max_q, q[k]);
    max_q = group_reduce<G>(max_q, [](uint32_t a, uint32_t c) { return max(a, c); });

    // the absolute record (every lane of the group alike)
    const int cw = MB == 8 || cnt < 256 ? 1 : 2;  // count bytes: 2 only for a full 16x16 block
    int nb = bit_len(max_q), tc, off_w;
    uint32_t off_word;
    bool const0, force_raw;
    int zq;  // rec_info[3]: the float zmin's bits, or what integer K2 subtracts
    if constexpr (IS_INT) {
        const float zf = int_to_f32(zmin_i, flip);
        const float max_val = __fmul_rn(__fsub_rn(fmax, zf), P.scale);
        const0 = cnt == 0 || (zf == 0.f && fmax == 0.f);
        force_raw = (P.mze == 0.f && fmax > zf) || (P.mze > 0.f && max_val > P.maxq_cap)
                    || wide_block(hi ^ flip, zmin_i);
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
    const int n_lut = distinct_count<MB>(
        set, q, max_q > 0 && !const0 && !force_raw && lut_possible(nb, cnt), max_q, nb, cnt, lane);
    int stuff_len = 1 + off_w + (max_q ? 1 + cw + ((cnt * nb + 7) >> 3) : 0);
    const int raw_len = 1 + cnt * P.size;
    bool use_lut = false, use_diff = false;
    lut_candidate(n_lut, nb, cnt, off_w, cw, max_q, stuff_len, use_lut);

    // the depth-diff candidate against slice di-1 of the same block (every
    // group of the launch computes it, the loads of slice 0 from itself; it
    // counts for di > 0 only)
    if constexpr (IS_INT) if (P.try_diff && d > 1) {
        const bool cand = di > 0;
        const int dp = cand ? -1 : 0;
        int l = 1 << 30, h = -(1 << 30);
#pragma unroll
        for (int k = 0; k < VPL; ++k) {
            const int j = G * k + gl;
            const T p = ok[k] ? at[((size_t)(j / MB) * w + j % MB) * d + dp] : (T)0;
            const int dv = wrap_sub((int)x[k], (int)p);
            q[k] = (uint32_t)dv;
            if (ok[k]) {
                l = min(l, dv);
                h = max(h, dv);
            }
        }
        int dmin = group_reduce<G>(l, [](int a, int c) { return min(a, c); });
        int dmax = group_reduce<G>(h, [](int a, int c) { return max(a, c); });
        if (cnt == 0) dmin = dmax = 0;
        uint32_t max_qd = 0;
#pragma unroll
        for (int k = 0; k < VPL; ++k) {
            q[k] = ok[k] ? (uint32_t)wrap_sub((int)q[k], dmin) : 0u;
            max_qd = max(max_qd, q[k]);
        }
        max_qd = group_reduce<G>(max_qd, [](uint32_t a, uint32_t c) { return max(a, c); });
        const int nbd = bit_len(max_qd);
        // the diff is taken only over a lossless, valued, absolute record
        // that is neither const-0 nor forced raw
        const bool diff_ok = cand && P.lossless && cnt > 0 && !const0 && !force_raw;
        const int n_lut_d = distinct_count<MB>(
            set, q, diff_ok && max_qd > 0 && lut_possible(nbd, cnt), max_qd, nbd, cnt, lane);
        int tc_d, off_w_d;
        reduce_offset_int(dmin, lerc2::DT_INT, tc_d, off_w_d);
        int stuff_len_d = 1 + off_w_d + (max_qd ? 1 + cw + ((cnt * nbd + 7) >> 3) : 0);
        bool use_lut_d = false;
        lut_candidate(n_lut_d, nbd, cnt, off_w_d, cw, max_qd, stuff_len_d, use_lut_d);
        const bool const0_d = dmin == 0 && dmax == 0;
        const int diff_len = const0_d ? 1 : stuff_len_d;
        use_diff = diff_ok && diff_len < stuff_len && diff_len < raw_len;
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
    if (live && gl == 0) {
        const int length = mode == 2 ? 1 : (mode == 0 ? raw_len : stuff_len);
        const int integ = ((((bcol * MB) >> 3) & 15) << 2) & P.integ_mask;
        const int flag = integ | (use_diff ? 4 : 0) | mode
                         | ((mode == 1 || mode == 3) ? tc << 6 : 0);
        reinterpret_cast<int4*>(rec_info)[r] = make_int4(
            length, flag | (mode << 8) | ((int)use_diff << 10)
                    | ((int)(use_lut && mode == 1) << 11) | (nb << 16) | (off_w << 24),
            (int)off_word, zq);
        if ((mode == 1 && nb > P.cap_nb) || (mode == 0 && !P.raw_ok)) *fits = 0;
        s_lo[slot] = lo;
        s_hi[slot] = hi;
        s_has[slot] = cnt > 0;
    }
    if (!live && gl == 0) s_has[slot] = 0;
    __syncthreads();
    // the per-depth ranges of each tile: the records of one depth and tile
    // are every d-th of the CTA's; the first of each run merges it and takes
    // one global atomic pair (a record with no valid value takes no part)
    const int t = threadIdx.x;
    if (t < C::RPC && r0 + t < n_rec) {
        const int rt = r0 + t, tile = rt / tile_rec;
        const int end = min(r0 + C::RPC, min(n_rec, (tile + 1) * tile_rec)) - r0;
        if (t < d || (rt - d) / tile_rec != tile) {
            bool any = false;
            Z l = lo, h = hi;
            for (int i = t; i < end; i += d) {
                if (!s_has[i]) continue;
                if (!any) {
                    l = s_lo[i];
                    h = s_hi[i];
                    any = true;
                } else if constexpr (IS_INT) {
                    l = min(l, s_lo[i]);
                    h = max(h, s_hi[i]);
                } else {
                    l = fminf(l, s_lo[i]);
                    h = fmaxf(h, s_hi[i]);
                }
            }
            if (any) {
                Z* zr = zrange + (size_t)tile * 2 * d + rt % d;
                if constexpr (IS_INT) {
                    if (flip) {  // uint32: unsigned atomics on the values
                        atomicMin((unsigned*)zr, (unsigned)(l ^ flip));
                        atomicMax((unsigned*)(zr + d), (unsigned)(h ^ flip));
                    } else {
                        atomicMin(zr, l);
                        atomicMax(zr + d, h);
                    }
                } else {
                    atomic_min_z(zr, l);
                    atomic_max_z(zr + d, h);
                }
            }
        }
    }
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

// ---- K2 without the LUT candidate, float32, 8x8 blocks: lane l holds
// block positions l and l + 32, whose validity bits are bit l of the
// block's two words (the integer K2 is the strip kernel above)

template <bool MASKED>
__device__ __forceinline__ void write_records_body(
        const float* __restrict__ data, const int2* __restrict__ valid, int w, int d, int nbh,
        int n_rec, const EncP& P, const int* __restrict__ rec_info,
        const int* __restrict__ starts, uint32_t* __restrict__ stream, long long cap_w) {
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

    // payload: LSB-first bit-stuffed quantized values, or the raw values
    if (mode == 0 || mode == 1) {
        const bool ok0 = !MASKED || ((vw0 >> lane) & 1u);
        const bool ok1 = !MASKED || ((vw1 >> lane) & 1u);
        float x0, x1;
        load_pair<float, MASKED>(data, w, d, nbh, b, di, lane, ok0, ok1, x0, x1);
        const int width = mode == 0 ? 32 : nb;
        const int pay = 8 * (sh + (mode == 0 ? 1 : 3 + off_w));
        const int zq = info[3];
        uint32_t v[2];
        if (mode == 0) {
            v[0] = __float_as_uint(x0);
            v[1] = __float_as_uint(x1);
        } else {
            v[0] = quantize(x0, __int_as_float(zq), P.scale, P.inv);
            v[1] = quantize(x1, __int_as_float(zq), P.scale, P.inv);
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
    write_records_body<false>(data, nullptr, w, d, nbh, n_rec, P, rec_info, starts,
                                     stream, cap_w);
}

__global__ void write_records_masked_kernel(const float* __restrict__ data,
                                            const int2* __restrict__ valid, int w, int d,
                                            int nbh, int n_rec, EncP P,
                                            const int* __restrict__ rec_info,
                                            const int* __restrict__ starts,
                                            uint32_t* __restrict__ stream, long long cap_w) {
    write_records_body<true>(data, valid, w, d, nbh, n_rec, P, rec_info, starts, stream,
                                    cap_w);
}

// ---- K2 with the LUT candidate (the band codec's and the mosaic's), 8x8
// or 16x16 blocks, float32 or int32 input: strips on the integer K2's
// machinery. A CTA of K2L_THREADS owns a strip of record.cuh's
// strip_shape(MB, w, d, 4, 1): S consecutive MB x MB blocks of one block
// row with all their D records, or one block and its depths in chunks,
// each staged with the slice before it (rows an odd number of 16-byte
// chunks apart: a record's rows, read side by side, meet different banks).
// The chunk's rec_info and starts are one coalesced read each. The
// records' bytes are one span [starts[ra], starts[rb]), built in a zeroed
// buffer in shared memory: each header by one thread, each block row of a
// record that is not a LUT record by one thread (at depth 1 its values in
// 16-byte loads; packed LSB-first at the bit its valid rank gives, ORed a
// word at a time), each LUT record by one warp, with no sort. Staging only
// the blocks with a coded record ran slower on three of five path inputs
// (chip_tune_k2lut_f2.py): the test cost more than the loads it saved.
//
// K1 has fixed nb and the LUT bit, so the warp needs only the set of the
// record's distinct non-zero quanta. Where nb <= K2L_BITMAP_NB it is a
// bitmap over [0, 2^nb) in shared memory (value v at bit v & 31 of word v
// >> 5): n_lut is its popcount, the LUT entries are its set bits in order, and a
// value's index is 1 + the set bits below it (a warp scan of the words'
// popcounts gives each word the count below it). Wider, it is a hash set
// of the values and their list: each entry's rank is the count of smaller
// entries, and a value's index comes from a binary search of the ordered
// list. Lane l holds the record's positions l*VPL .. l*VPL + VPL - 1, so a
// lane's indices, like its share of the LUT entries, are consecutive
// fields. The span leaves as the integer K2's does: aligned 16-byte
// stores, only the edge chunks ORed into the zeroed stream. Validity words
// are read only by the masked instances (masks, edge blocks); an aligned
// all-valid image passes none.

constexpr int K2L_THREADS = 128;
constexpr int K2L_WARPS = K2L_THREADS / 32;
constexpr int K2L_BITMAP_NB = 12;  // the widest nb whose LUT set is a bitmap (512 B)

template <int MB>
struct K2L {
    static constexpr int BP = MB * MB;                 // positions a block
    static constexpr int VPL = BP / 32;                // consecutive positions a lane
    static constexpr int VW = BP / 32;                 // validity words a block
    static constexpr int PITCH = STRIP_OUT / MB + 16;  // a staged row's bytes at most
    static constexpr int NBLK = STRIP_PX / BP;         // blocks a strip at most
    static constexpr int SLOTS = 2 * BP;               // the wide set's hash slots
    static constexpr int LOG_SLOTS = MB == 8 ? 7 : 9;
    static constexpr int WS = SLOTS + 512;             // a warp's set words (>= 2 * 128)
};

// LSB-first fields from bit `bit` of the span's words on, ORed a word at a
// time (bits at or past `end` dropped)
struct BitOut {
    uint32_t* buf;
    int wi, nacc, end;
    uint64_t acc;
    __device__ BitOut(uint32_t* b, int bit, int e)
        : buf(b), wi(bit >> 5), nacc(bit & 31), end(e), acc(0) {}
    __device__ void put(uint32_t v, int width) {
        acc |= (uint64_t)v << nacc;
        nacc += width;
        if (nacc >= 32) {
            k2_or(buf, wi++, (uint32_t)acc, end);
            acc >>= 32;
            nacc -= 32;
        }
    }
    __device__ void flush() {
        if (nacc > 0) k2_or(buf, wi, (uint32_t)acc, end);
    }
};

// the valid positions of a block before position j
template <int VW>
__device__ __forceinline__ int rank_below(const uint32_t* vw, int j) {
    int r = __popc(vw[j >> 5] & ((1u << (j & 31)) - 1u));
#pragma unroll
    for (int k = 0; k < VW; ++k)
        if (k < (j >> 5)) r += __popc(vw[k]);
    return r;
}

// the field of a value x (bits of T) of a record: the raw native bits (mode
// 0), or the quantum against zq (integers: or x less the value of slice
// di-1 at its position, prev, less zq: a diff record)
template <typename T>
__device__ __forceinline__ uint32_t k2l_field(uint32_t x, uint32_t prev, int mode, bool diff,
                                              int zq, const EncP& P) {
    if constexpr (std::is_same<T, float>::value) {
        return mode == 0 ? x : quantize(__uint_as_float(x), __int_as_float(zq), P.scale, P.inv);
    } else {
        if (mode == 0) return low_bytes(x, P.size);
        if (diff) return (uint32_t)wrap_sub(wrap_sub((int)x, (int)prev), zq);
        return quantize_int((int)x, zq, P.lossless, P.scale, P.inv_i);
    }
}

// the staged element of position j of record (block bl, depth di), and the
// one of slice di-1 beside it where it is staged
template <int MB>
__device__ __forceinline__ uint32_t k2l_at(const uint8_t* stage, int pitch, int nsl, int sd0,
                                           int bl, int di, int j, uint32_t& prev) {
    const uint8_t* at = stage + (j / MB) * pitch + ((bl * MB + j % MB) * nsl + di - sd0) * 4;
    prev = di > sd0 ? *reinterpret_cast<const uint32_t*>(at - 4) : 0u;
    return *reinterpret_cast<const uint32_t*>(at);
}

// one LUT record by one warp at byte `at` of the span: [n_lut + 1][LUT at
// nb bits][indices at bitlen(n_lut) bits, in valid-rank order]; ws: the
// warp's K2L<MB>::WS set words
template <typename T, int MB>
__device__ void lut_record(uint32_t* buf, uint32_t* ws, const uint8_t* stage, int pitch, int nsl,
                           int sd0, int bl, int di, int4 ri, int at, const uint32_t* vw, int cnt,
                           const EncP& P, int lane) {
    using C = K2L<MB>;
    constexpr int VPL = C::VPL;
    const int nb = (ri.y >> 16) & 0xFF, off_w = ri.y >> 24;
    const bool diff = (ri.y >> 10) & 1;
    const int cw = MB == 8 || cnt < 256 ? 1 : 2;
    const int end = min(at + ri.x, K2S_SPAN) * 8;
    const int pay = 8 * (at + 2 + off_w + cw);
    const int j0 = lane * VPL;  // VPL divides 32: the lane's positions lie in one word
    const uint32_t vb = (vw[j0 >> 5] >> (j0 & 31)) & ((1u << VPL) - 1u);
    uint32_t q[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
        uint32_t prev;
        const uint32_t x = k2l_at<MB>(stage, pitch, nsl, sd0, bl, di, j0 + i, prev);
        q[i] = (vb >> i) & 1u ? k2l_field<T>(x, prev, 1, diff, ri.w, P) : 0u;
    }
    int n_lut;
    const bool bitmap = nb <= K2L_BITMAP_NB;
    __syncwarp();  // the set's last record is written
    uint32_t* bm = ws;                             // bitmap: 2^(nb-5) words (1 at least),
    int* below = reinterpret_cast<int*>(ws + 128); // each word's set bits below it
    uint32_t* srt = ws + C::SLOTS + 256;           // wide: the ordered entries
    if (bitmap) {
        const int nw = nb > 5 ? 1 << (nb - 5) : 1;
        for (int i = lane; i < nw; i += 32) bm[i] = 0;
        __syncwarp();
        uint32_t last = 0;
#pragma unroll
        for (int i = 0; i < VPL; ++i)
            if (q[i] && q[i] != last) {
                atomicOr(bm + (q[i] >> 5), 1u << (q[i] & 31));
                last = q[i];
            }
        __syncwarp();
        const int wpl = nw > 32 ? nw >> 5 : 1;  // words a lane: 1, 2 or 4
        const int w0 = lane * wpl;
        int c = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k)
            if (k < wpl && w0 + k < nw) c += __popc(bm[w0 + k]);
        int incl = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(FULL, incl, o);
            if (lane >= o) incl += v;
        }
        n_lut = __shfl_sync(FULL, incl, 31);
        int run = incl - c;  // this lane's set bits are LUT entries run, run + 1, ...
        BitOut e(buf, pay + 8 + run * nb, end);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            if (k >= wpl || w0 + k >= nw) break;
            uint32_t m = bm[w0 + k];
            below[w0 + k] = run;
            run += __popc(m);
            while (m) {
                e.put((uint32_t)(((w0 + k) << 5) | (__ffs((int)m) - 1)), nb);
                m &= m - 1u;
            }
        }
        e.flush();
    } else {
        uint32_t* hs = ws;                     // open addressing, 0 the empty slot
        uint32_t* list = ws + C::SLOTS;        // the entries in insertion order
        uint32_t* n_in = srt + 255;            // their count
        for (int i = lane; i < C::SLOTS; i += 32) hs[i] = 0;
        if (lane == 0) *n_in = 0;
        __syncwarp();
        uint32_t last = 0;
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
            const uint32_t v = q[i];
            if (!v || v == last) continue;
            last = v;
            uint32_t hh = (v * 2654435761u) >> (32 - C::LOG_SLOTS);
            for (int probe = 0; probe < C::SLOTS; ++probe) {
                const uint32_t old = atomicCAS(hs + hh, 0u, v);
                if (old == 0u) {
                    const uint32_t k = atomicAdd(n_in, 1u);
                    if (k < 255u) list[k] = v;
                    break;
                }
                if (old == v) break;
                hh = (hh + 1) & (C::SLOTS - 1);
            }
        }
        __syncwarp();
        n_lut = (int)min(*n_in, 255u);
        for (int k = lane; k < n_lut; k += 32) {
            const uint32_t v = list[k];
            int r = 0;
            for (int i = 0; i < n_lut; ++i) r += list[i] < v;
            srt[r] = v;
        }
        __syncwarp();
        const int per = (n_lut + 31) >> 5, r0 = lane * per;
        BitOut e(buf, pay + 8 + r0 * nb, end);
        for (int k = r0; k < min(r0 + per, n_lut); ++k) e.put(srt[k], nb);
        e.flush();
    }
    if (lane == 0) {
        BitOut hd(buf, pay, end);
        hd.put((uint32_t)(n_lut + 1), 8);
        hd.flush();
    }
    __syncwarp();  // below / srt complete
    const int nbits = bit_len((uint32_t)n_lut);
    BitOut o(buf, pay + 8 + 8 * ((n_lut * nb + 7) >> 3) + rank_below<C::VW>(vw, j0) * nbits, end);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
        if (!((vb >> i) & 1u)) continue;
        const uint32_t v = q[i];
        uint32_t idx = 0;
        if (v && bitmap) {
            idx = 1 + below[v >> 5] + __popc(bm[v >> 5] & ((1u << (v & 31)) - 1u));
        } else if (v) {  // the first ordered entry not below v
            int lo = 0, hi = n_lut;
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (srt[mid] < v) lo = mid + 1;
                else hi = mid;
            }
            idx = 1 + lo;
        }
        o.put(idx, nbits);
    }
    o.flush();
}

template <typename T, int MB, bool MASKED>
__global__ void __launch_bounds__(K2L_THREADS) write_records_lut_kernel(
        const T* __restrict__ data, const uint32_t* __restrict__ valid, int h, int w, int d,
        int nbh, int S, int dc, int spr, EncP P, const int* __restrict__ rec_info,
        const int* __restrict__ starts, uint32_t* __restrict__ stream, long long cap_w) {
    using C = K2L<MB>;
    constexpr bool IS_INT = !std::is_same<T, float>::value;
    __shared__ __align__(16) uint8_t stage[MB * C::PITCH];
    __shared__ uint4 span4[K2S_SPAN / 16];
    __shared__ int4 srec[K1S_REC];
    __shared__ int sst[K1S_REC], s_lut[K1S_REC];
    __shared__ uint32_t s_vw[C::NBLK * C::VW];  // the strip's validity words
    __shared__ int s_nlut;                      // the chunk's LUT records (s_lut)
    __shared__ uint32_t s_ws[K2L_WARPS][C::WS];
    uint32_t* buf = reinterpret_cast<uint32_t*>(span4);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int brow = blockIdx.x / spr, c0 = (blockIdx.x - brow * spr) * S;
    const int nb = min(S, nbh - c0);        // blocks of the strip
    const int row0 = MB * brow, col0 = MB * c0;
    const int npx = min(MB * nb, w - col0);  // in-image pixels a row
    const int rows = min(MB, h - row0);
    const long long b0 = (long long)brow * nbh + c0;
    for (int i = tid; i < nb * C::VW; i += K2L_THREADS)
        s_vw[i] = MASKED ? valid[b0 * C::VW + i] : FULL;
    for (int dlo = 0; dlo < d; dlo += dc) {
        const int dn = min(dc, d - dlo);
        const int sd0 = dn == d ? 0 : max(0, dlo - 1);  // the first staged depth
        const int nsl = dn == d ? d : dlo + dn - sd0;   // staged depths a pixel
        // a staged row's bytes: an odd number of 16-byte chunks (whole rows) or of
        // words (depth chunks), so that a block's rows, read side by side, meet
        // different banks
        const int pitch = dn == d ? ((MB * S * d * 4 + 15) / 16 | 1) * 16 : MB * nsl * 4 + 4;
        const int n_r = nb * dn;
        const long long ra = b0 * d + dlo;  // the chunk's records are consecutive
        if (tid == 0) s_nlut = 0;
        __syncthreads();
        bool contig = true;  // each start the running sum of the lengths before it
        for (int t = tid; t < n_r; t += K2L_THREADS) {
            const int4 ri = reinterpret_cast<const int4*>(rec_info)[ra + t];
            srec[t] = ri;
            sst[t] = starts[ra + t];
            if (t + 1 < n_r) contig &= starts[ra + t + 1] - sst[t] == ri.x;
            if (((ri.y >> 8) & 3) == 1 && ((ri.y >> 11) & 1)) s_lut[atomicAdd(&s_nlut, 1)] = t;
        }
        contig = __syncthreads_and(contig);
        if (dn == d) {  // whole rows: the image's bytes, 16 a load
            const int len = npx * d * 4, nch = (len + 15) / 16;
            for (int t = tid; t < rows * nch; t += K2L_THREADS) {
                const int r = t / nch, m = t - r * nch;
                const uint8_t* src = reinterpret_cast<const uint8_t*>(data)
                                     + (((long long)(row0 + r) * w + col0) * d) * 4 + 16 * m;
                *reinterpret_cast<uint4*>(stage + r * pitch + 16 * m) =
                    load16(src, min(16, len - 16 * m));
            }
        } else {  // a chunk of depths of one block: element by element
            const int n = rows * npx * nsl;
            for (int t = tid; t < n; t += K2L_THREADS) {
                const int r = t / (npx * nsl), rem = t - r * npx * nsl;
                const int px = rem / nsl, k = rem - px * nsl;
                *reinterpret_cast<T*>(stage + r * pitch + (px * nsl + k) * 4) =
                    data[((long long)(row0 + r) * w + col0 + px) * d + sd0 + k];
            }
        }
        const long long span_len = (long long)sst[n_r - 1] - sst[0] + srec[n_r - 1].x;
        const bool one = contig && span_len > 0 && span_len + 16 <= K2S_SPAN;
        for (int ga = 0; ga < n_r; ga = one ? n_r : ga + 1) {  // groups: the chunk, or a record
            const int gb = one ? n_r : ga + 1;
            const long long g0 = sst[ga];
            const int mis = (int)(g0 & 15);
            const int len = one ? (int)span_len : max(0, min(srec[ga].x, K2S_SPAN - 16));
            for (int c = tid; c < (mis + len + 15) >> 4; c += K2L_THREADS)
                span4[c] = make_uint4(0, 0, 0, 0);
            __syncthreads();  // (also the stage)
            for (int t = ga + tid; t < gb; t += K2L_THREADS) {  // headers (Lerc2 WriteTile)
                const int4 ri = srec[t];
                const int mode = (ri.y >> 8) & 3, off_w = ri.y >> 24;
                const int bl = t / dn;
                int cnt = 0;
#pragma unroll
                for (int k = 0; k < C::VW; ++k) cnt += __popc(s_vw[bl * C::VW + k]);
                const int cw = MB == 8 || cnt < 256 ? 1 : 2;
                const int at = mis + (sst[t] - (int)g0);
                const int hl = min(mode == 1 ? 2 + off_w + cw : mode == 3 ? 1 + off_w : 1, ri.x);
                const uint32_t nbb = ((ri.y >> 16) & 0xFF) | (((ri.y >> 11) & 1) << 5)
                                     | ((3 - cw) << 6);
                for (int k = 0; k < hl; ++k) {  // flag, offset bytes, numBits byte, count
                    const uint32_t b = (k == 0 ? (uint32_t)ri.y
                                        : k <= off_w ? (uint32_t)ri.z >> (8 * (k - 1))
                                        : k == 1 + off_w ? nbb
                                        : k == 2 + off_w ? (uint32_t)cnt
                                                         : (uint32_t)cnt >> 8) & 0xFFu;
                    if (at + k >= 0) k2_or(buf, (at + k) >> 2, b << (8 * ((at + k) & 3)),
                                           8 * K2S_SPAN);
                }
            }
            for (int it = tid; it < MB * (gb - ga); it += K2L_THREADS) {  // plain payload rows
                const int t = ga + it / MB, r = it % MB;  // a record's rows side by side
                const int4 ri = srec[t];
                const int mode = (ri.y >> 8) & 3, off_w = ri.y >> 24;
                if ((mode != 0 && mode != 1) || (mode == 1 && ((ri.y >> 11) & 1))) continue;
                const int bl = t / dn, di = dlo + t - bl * dn;
                const uint32_t* vw = s_vw + bl * C::VW;
                int cnt = 0;
#pragma unroll
                for (int k = 0; k < C::VW; ++k) cnt += __popc(vw[k]);
                const int cw = MB == 8 || cnt < 256 ? 1 : 2;
                const int width = mode == 0 ? (IS_INT ? 8 * P.size : 32) : (ri.y >> 16) & 0xFF;
                const int at = mis + (sst[t] - (int)g0);
                if (at < 0) continue;
                const int j0 = r * MB;
                const uint32_t rb = (vw[j0 >> 5] >> (j0 & 31)) & (MB == 8 ? 0xFFu : 0xFFFFu);
                BitOut o(buf, (at + (mode == 1 ? 2 + off_w + cw : 1)) * 8
                                  + rank_below<C::VW>(vw, j0) * width,
                         min(at + ri.x, K2S_SPAN) * 8);
                const bool diff = (ri.y >> 10) & 1;
                uint32_t x[MB], prev[MB];
                if (dn == d && d == 1) {  // one depth: the row's values, 16 bytes a load
                    const uint4* v =
                        reinterpret_cast<const uint4*>(stage + r * pitch + bl * MB * 4);
#pragma unroll
                    for (int c = 0; c < MB / 4; ++c) {
                        const uint4 q4 = v[c];
                        x[4 * c] = q4.x, x[4 * c + 1] = q4.y;
                        x[4 * c + 2] = q4.z, x[4 * c + 3] = q4.w;
                    }
#pragma unroll
                    for (int c = 0; c < MB; ++c) prev[c] = 0;
                } else {
#pragma unroll
                    for (int c = 0; c < MB; ++c)
                        x[c] = k2l_at<MB>(stage, pitch, nsl, sd0, bl, di, j0 + c, prev[c]);
                }
#pragma unroll
                for (int c = 0; c < MB; ++c)
                    if ((rb >> c) & 1u)
                        o.put(k2l_field<T>(x[c], prev[c], mode, diff, ri.w, P), width);
                o.flush();
            }
            for (int i = warp; i < s_nlut; i += K2L_WARPS) {  // LUT records: a warp each
                const int t = s_lut[i];
                const int at = mis + (sst[t] - (int)g0);
                if (t < ga || t >= gb || at < 0) continue;  // warp-uniform
                const int bl = t / dn;
                const uint32_t* vw = s_vw + bl * C::VW;
                int cnt = 0;
#pragma unroll
                for (int k = 0; k < C::VW; ++k) cnt += __popc(vw[k]);
                lut_record<T, MB>(buf, s_ws[warp], stage, pitch, nsl, sd0, bl, dlo + t - bl * dn,
                                  srec[t], at, vw, cnt, P, lane);
            }
            __syncthreads();
            // the span to the stream: whole chunks stored, the edge chunks' words ORed
            const long long gw0 = (g0 - mis) >> 2;
            for (int c = tid; c < (mis + len + 15) >> 4; c += K2L_THREADS) {
                const long long gw = gw0 + 4 * c;
                if (16 * c >= mis && 16 * c + 16 <= mis + len && gw >= 0 && gw + 4 <= cap_w) {
                    *reinterpret_cast<uint4*>(stream + gw) = span4[c];
                    continue;
                }
                for (int q = 0; q < 4; ++q) {
                    const int a = 16 * c + 4 * q;  // the word's bytes [a, a + 4) meet the span
                    if (gw + q < 0 || gw + q >= cap_w || a + 4 <= mis || a >= mis + len) continue;
                    atomicOr(stream + gw + q, buf[4 * c + q]);
                }
            }
            __syncthreads();  // the buffer is the next group's
        }
    }
}

// ---------------------------------------------------------------------------
// float64 K2 on 8x8 blocks, a warp a record, two values a lane (module
// comment; the float64 K1 is the float strip kernel above)
// ---------------------------------------------------------------------------

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

// the float K1 (strips), 8x8 blocks, float32 or float64; valid null for an
// aligned all-valid image; tile_rec as encode_blocks_f64's (0: one tile)
template <typename T>
int launch_k1_float(const T* x, const int* valid, int h, int w, int d, int tile_rec,
                    const typename K1F<T>::Params& P, int* rec_info, T* z, int* fits,
                    cudaStream_t st) {
    const StripShape g = strip_shape(8, w, d, (int)sizeof(T), 0);
    const int nbh = (w + 7) / 8;
    const long long n_rec = (long long)((h + 7) / 8) * nbh * d;
    const long long grid = (long long)((h + 7) / 8) * g.spr;  // a CTA (a warp) a strip
    if (n_rec > INT_MAX || grid > INT_MAX || (!valid && (h % 8 || w % 8)))
        return (int)cudaErrorInvalidValue;
    if (n_rec == 0) return 0;
    const int tr = tile_rec > 0 ? tile_rec : (int)n_rec;
    const int2* v = reinterpret_cast<const int2*>(valid);
#define K1F_ARGS x, v, h, w, d, nbh, g.S, g.dc, g.spr, tr, P, rec_info, z, fits
    const unsigned n = (unsigned)grid, nt = K1F<T>::THREADS;
    if (valid) {
        if (d == 1) encode_blocks_float_kernel<T, true, true><<<n, nt, 0, st>>>(K1F_ARGS);
        else encode_blocks_float_kernel<T, true, false><<<n, nt, 0, st>>>(K1F_ARGS);
    } else {
        if (d == 1) encode_blocks_float_kernel<T, false, true><<<n, nt, 0, st>>>(K1F_ARGS);
        else encode_blocks_float_kernel<T, false, false><<<n, nt, 0, st>>>(K1F_ARGS);
    }
#undef K1F_ARGS
    return (int)cudaGetLastError();
}

// the integer K1 (strips), 8x8 blocks; valid null for an aligned all-valid image
template <typename T, bool MASKED>
void launch_k1_int_strips(const T* x, const int2* v, int h, int w, int d, const EncP& P,
                          int* rec_info, int* z, int* fits, cudaStream_t st) {
    const StripShape g = strip_shape(8, w, d, (int)sizeof(T), 1);
    const int nbh = (w + 7) / 8;
    const unsigned grid = (unsigned)((h + 7) / 8 * g.spr);  // a CTA (a warp) a strip
    if (g.dc == d && d == 1)
        encode_blocks_int_kernel<T, MASKED, 1><<<grid, 32, 0, st>>>(
            x, v, h, w, d, nbh, g.S, g.dc, g.spr, P, rec_info, z, fits);
    else if (g.dc == d && d == 3)
        encode_blocks_int_kernel<T, MASKED, 3><<<grid, 32, 0, st>>>(
            x, v, h, w, d, nbh, g.S, g.dc, g.spr, P, rec_info, z, fits);
    else
        encode_blocks_int_kernel<T, MASKED, 0><<<grid, 32, 0, st>>>(
            x, v, h, w, d, nbh, g.S, g.dc, g.spr, P, rec_info, z, fits);
}

template <typename T>
int launch_k1_int(const void* data, const int* valid, int h, int w, int d, const EncP& P,
                  int* rec_info, void* zrange, int* fits, cudaStream_t st) {
    if ((long long)(h + 7) / 8 * strip_shape(8, w, d, (int)sizeof(T), 1).spr > INT_MAX)
        return (int)cudaErrorInvalidValue;
    if ((long long)h * w * d == 0) return 0;
    const T* x = static_cast<const T*>(data);
    const int2* v = reinterpret_cast<const int2*>(valid);
    int* z = static_cast<int*>(zrange);
    if (valid)
        launch_k1_int_strips<T, true>(x, v, h, w, d, P, rec_info, z, fits, st);
    else
        launch_k1_int_strips<T, false>(x, v, h, w, d, P, rec_info, z, fits, st);
    return (int)cudaGetLastError();
}

// valid null: an aligned all-valid image (the instance reads no validity words)
template <typename T, int MB>
int launch_k1_lut(const void* data, const int* valid, int h, int w, int d, int tile_rec,
                  const EncP& P, int* rec_info, void* zrange, int* fits, cudaStream_t st) {
    const int nbh = (w + MB - 1) / MB;
    const long long n_rec = (long long)((h + MB - 1) / MB) * nbh * d;
    if (n_rec > INT_MAX || (!valid && (h % MB || w % MB))) return (int)cudaErrorInvalidValue;
    if (n_rec == 0) return 0;
    const int grid = (int)((n_rec + K1L<MB>::RPC - 1) / K1L<MB>::RPC);
    const T* x = static_cast<const T*>(data);
    const uint32_t* v = reinterpret_cast<const uint32_t*>(valid);
    const int tr = tile_rec > 0 ? tile_rec : (int)n_rec;
    auto* z = static_cast<typename ZOf<T>::type*>(zrange);
    if (valid)
        encode_blocks_lut_kernel<T, MB, true><<<grid, K1L_WARPS * 32, 0, st>>>(
            x, v, w, d, nbh, (int)n_rec, tr, P, rec_info, z, fits);
    else
        encode_blocks_lut_kernel<T, MB, false><<<grid, K1L_WARPS * 32, 0, st>>>(
            x, v, w, d, nbh, (int)n_rec, tr, P, rec_info, z, fits);
    return (int)cudaGetLastError();
}

// the integer K2 (strips) of one mask instance: D = 1 and 3 as constants
template <typename T, bool MASKED>
void launch_k2_int_strips(const T* x, const int2* v, int h, int w, int d, int nbh,
                          const StripShape& g, const EncP& P, const int* rec_info,
                          const int* starts, uint32_t* out, long long cap_w, cudaStream_t st) {
    const unsigned grid = (unsigned)((h + 7) / 8 * g.spr);
    if (g.dc == d && d == 1)
        write_records_int_kernel<T, MASKED, 1><<<grid, K2S_THREADS, 0, st>>>(
            x, v, h, w, d, nbh, g.S, g.dc, g.spr, P, rec_info, starts, out, cap_w);
    else if (g.dc == d && d == 3)
        write_records_int_kernel<T, MASKED, 3><<<grid, K2S_THREADS, 0, st>>>(
            x, v, h, w, d, nbh, g.S, g.dc, g.spr, P, rec_info, starts, out, cap_w);
    else
        write_records_int_kernel<T, MASKED, 0><<<grid, K2S_THREADS, 0, st>>>(
            x, v, h, w, d, nbh, g.S, g.dc, g.spr, P, rec_info, starts, out, cap_w);
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
    } else {  // the integer K2 (strips): a CTA a strip of the integer K1
        const StripShape g = strip_shape(8, w, d, (int)sizeof(T), 1);
        if ((long long)(h + 7) / 8 * g.spr > INT_MAX) return (int)cudaErrorInvalidValue;
        if ((long long)h * w * d == 0) return 0;
        if (valid) launch_k2_int_strips<T, true>(x, v, h, w, d, nbh, g, P, rec_info, starts, out,
                                                 cap_w, st);
        else launch_k2_int_strips<T, false>(x, nullptr, h, w, d, nbh, g, P, rec_info, starts, out,
                                            cap_w, st);
    }
    return (int)cudaGetLastError();
}

// valid null: an aligned all-valid image (the instance reads no validity words)
template <typename T, int MB>
int launch_k2_lut(const void* data, const int* valid, int h, int w, int d, const EncP& P,
                  const int* rec_info, const int* starts, uint32_t* out, long long cap_w,
                  cudaStream_t st) {
    if (!valid && (h % MB || w % MB)) return (int)cudaErrorInvalidValue;
    if ((long long)h * w * d == 0) return 0;
    const int nbh = (w + MB - 1) / MB;
    const StripShape g = strip_shape(MB, w, d, 4, 1);
    const long long grid = (long long)((h + MB - 1) / MB) * g.spr;
    if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
    const T* x = static_cast<const T*>(data);
    const uint32_t* v = reinterpret_cast<const uint32_t*>(valid);
    if (valid)
        write_records_lut_kernel<T, MB, true><<<(unsigned)grid, K2L_THREADS, 0, st>>>(
            x, v, h, w, d, nbh, g.S, g.dc, g.spr, P, rec_info, starts, out, cap_w);
    else
        write_records_lut_kernel<T, MB, false><<<(unsigned)grid, K2L_THREADS, 0, st>>>(
            x, nullptr, h, w, d, nbh, g.S, g.dc, g.spr, P, rec_info, starts, out, cap_w);
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
// an aligned all-valid image (then the all-valid instance runs; refused
// where H or W is not a multiple of 8)
extern "C" int encode_blocks(const float* data, const int* valid, int h, int w, int d,
                             float mze, float scale, float inv, int integ_mask, int cap_nb,
                             int raw_ok, int* rec_info, float* zrange, int* fits,
                             void* stream) {
    const EncP P = float_params(mze, scale, inv, integ_mask, cap_nb, raw_ok);
    return launch_k1_float<float>(data, valid, h, w, d, 0, P, rec_info, zrange, fits,
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
    DISPATCH_INT_INPUT(in_type, launch_k1_int, data, valid, h, w, d, P, rec_info, zrange, fits,
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
// validity words, or null for an aligned all-valid image; data
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
    if (mb != 8 && mb != 16) return (int)cudaErrorInvalidValue;
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
    if (mb != 8 && mb != 16) return (int)cudaErrorInvalidValue;
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
    const EncP64 P{scale, inv, integ_mask};
    return launch_k1_float<double>(data, valid, h, w, d, tile_rec, P, rec_info, zrange, nullptr,
                                   (cudaStream_t)stream);
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
