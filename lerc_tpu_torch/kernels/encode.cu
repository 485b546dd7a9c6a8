// K1 encode_blocks and K2 write_records: the Lerc2 tile encoder for
// float32 and integer rasters with 8x8 micro blocks, no LUT mode,
// all-valid or masked. The integer instances (encode_blocks_int,
// write_records_int, after the float kernels) are described there.
//
// Replaces lerc_tpu/ops/device_encode.py::encode_tiles (:486) with its
// bit packers (_pack_words :124, _pack_words_grouped :167,
// _pack_words_static :254, _shift_words_1b :291) and, for masks, its
// valid-lane compaction make_compactor (:303). The TPU version routes
// bits with one-hot matmuls and static roll chains because XLA gathers and
// scatters are slow there; on Hopper one warp owns one block: shuffles
// reduce it, and shared-memory atomicOr assembles its record.
//
// Masks: each block's validity is two u32 words (bit j = position j,
// row-major), which are exactly the ballots of the warp's two lane halves
// (lane l holds positions l and l + 32). The masked instantiations
// (encode_blocks_masked_kernel, write_records_masked_kernel) reduce over
// the valid lanes, count the block's values with popc, and write value j
// at its rank popc(word & lanemask_lt) (+ popc(word0) for j >= 32): the
// stable left compaction, with no separate pass.
//
// Bound: bytes. K1 reads the image once (4*H*W*D B) and writes 16 B per
// record; K2 reads the image again and writes the stream (`total` B); the
// masked ones also read 8 B of validity words per record. Both do a few
// dozen flops per value, far under the f32 rate.
//
// Record r = b*D + di (block-major, depth inner). rec_info[r] holds
// {length, desc, offset word, block zmin bits}, desc =
// flag | mode << 8 | numBits << 16 | offset width << 24.
//
// Build with --fmad=false: the quantize fixup contracts exactly the one
// multiply-add the reference contracts (written as __fmaf_rn), nothing else.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "record.cuh"

namespace {

constexpr int WARPS = 8;            // warps (records) per CTA
constexpr unsigned FULL = 0xffffffffu;
constexpr int BUF_W = 72;           // record words: 3 + 257 bytes + spill
constexpr int RAW_LEN = 1 + 64 * 4; // flag + 64 raw f32 values

// one quantized value: rint((x - zmin) * scale) with the sign-directed
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

// float atomics through the integer order of IEEE bit patterns
__device__ __forceinline__ void atomic_min_f(float* a, float v) {
    if (__float_as_int(v) >= 0) atomicMin((int*)a, __float_as_int(v));
    else atomicMax((unsigned*)a, __float_as_uint(v));
}
__device__ __forceinline__ void atomic_max_f(float* a, float v) {
    if (__float_as_int(v) >= 0) atomicMax((int*)a, __float_as_int(v));
    else atomicMin((unsigned*)a, __float_as_uint(v));
}

// the two values of lane `lane` of block b, depth di: block positions
// j = lane and j = lane + 32 (row-major inside the 8x8 block)
__device__ __forceinline__ void load_pair(const float* data, int w, int d, int nbh,
                                          int b, int di, int lane, float& x0, float& x1) {
    int row = (b / nbh) * 8 + (lane >> 3);
    int col = (b % nbh) * 8 + (lane & 7);
    x0 = data[((size_t)row * w + col) * d + di];
    x1 = data[((size_t)(row + 4) * w + col) * d + di];
}

// block b's validity words (all set without a mask) and its value count
template <bool MASKED>
__device__ __forceinline__ int block_valid(const int2* valid, int b, uint32_t& vw0, uint32_t& vw1) {
    if constexpr (MASKED) {
        const int2 v = valid[b];
        vw0 = (uint32_t)v.x;
        vw1 = (uint32_t)v.y;
        return __popc(vw0) + __popc(vw1);
    } else {
        vw0 = vw1 = FULL;
        return 64;
    }
}

// is block position j = lane + 32*k valid, and its rank among the valid
// positions (j itself without a mask)
template <bool MASKED>
__device__ __forceinline__ bool lane_valid(uint32_t vw0, uint32_t vw1, int lane, int k) {
    return !MASKED || (((k ? vw1 : vw0) >> lane) & 1u);
}
template <bool MASKED>
__device__ __forceinline__ int valid_rank(uint32_t vw0, uint32_t vw1, int lane, int k) {
    if constexpr (!MASKED) return lane + 32 * k;
    const uint32_t lt = (1u << lane) - 1u;
    return k == 0 ? __popc(vw0 & lt) : __popc(vw0) + __popc(vw1 & lt);
}

template <bool MASKED>
__device__ __forceinline__ void encode_blocks_body(
        const float* __restrict__ data, const int2* __restrict__ valid, int w, int d, int nbh,
        int n_rec, float mze, float scale, float inv, int integ_mask, int cap_nb, int raw_ok,
        int* __restrict__ rec_info, float* __restrict__ zrange, int* __restrict__ fits) {
    __shared__ float s_min[WARPS], s_max[WARPS];
    __shared__ int s_di[WARPS];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = blockIdx.x * WARPS + warp;
    const bool live = r < n_rec;  // warp-uniform
    float zmin = 0.f, zmax = 0.f;
    int cnt = 0;
    if (live) {
        const int b = r / d, di = r % d;
        uint32_t vw0, vw1;
        cnt = block_valid<MASKED>(valid, b, vw0, vw1);
        const bool ok0 = lane_valid<MASKED>(vw0, vw1, lane, 0);
        const bool ok1 = lane_valid<MASKED>(vw0, vw1, lane, 1);
        float x0, x1;
        load_pair(data, w, d, nbh, b, di, lane, x0, x1);
        zmin = fminf(ok0 ? x0 : CUDART_INF_F, ok1 ? x1 : CUDART_INF_F);
        zmax = fmaxf(ok0 ? x0 : -CUDART_INF_F, ok1 ? x1 : -CUDART_INF_F);
        for (int o = 16; o > 0; o >>= 1) {
            zmin = fminf(zmin, __shfl_xor_sync(FULL, zmin, o));
            zmax = fmaxf(zmax, __shfl_xor_sync(FULL, zmax, o));
        }
        if (MASKED && cnt == 0) zmin = zmax = 0.f;  // const-0 record
        const uint32_t max_q = __reduce_max_sync(
            FULL, max(ok0 ? quantize(x0, zmin, scale, inv) : 0u,
                      ok1 ? quantize(x1, zmin, scale, inv) : 0u));
        if (lane == 0) {
            const int nb = max_q ? 32 - __clz(max_q) : 0;
            const float max_val = __fmul_rn(__fsub_rn(zmax, zmin), scale);
            const bool const0 = zmin == 0.f && zmax == 0.f;
            const bool force_raw = (mze == 0.f && zmax > zmin)
                                   || (mze > 0.f && max_val > 1073741823.f);
            // reduced offset type (Lerc2.h:493-499): byte, short or float
            const bool is_int = zmin == rintf(zmin) && fabsf(zmin) < 2147483648.f;
            const int tc = (is_int && zmin >= 0.f && zmin <= 255.f) ? 2
                         : (is_int && zmin >= -32768.f && zmin <= 32767.f) ? 1 : 0;
            const int off_w = tc == 2 ? 1 : (tc == 1 ? 2 : 4);
            uint32_t off_word = __float_as_uint(zmin);
            if (tc) off_word = (uint32_t)(int)rintf(zmin) & (tc == 2 ? 0xFFu : 0xFFFFu);
            // count byte width 1 (cnt < 256); raw: 4 B a value
            const int stuff_len = 1 + off_w + (max_q ? 2 + (MASKED ? (cnt * nb + 7) >> 3 : 8 * nb) : 0);
            const int raw_len = MASKED ? 1 + 4 * cnt : RAW_LEN;
            const bool use_stuff = !force_raw && stuff_len < raw_len;
            const int mode = const0 ? 2 : (use_stuff ? (max_q ? 1 : 3) : 0);
            const int length = mode == 2 ? 1 : (mode == 0 ? raw_len : stuff_len);
            const int integ = (((b % nbh) & 15) << 2) & integ_mask;
            const int flag = integ | mode | ((mode == 1 || mode == 3) ? tc << 6 : 0);
            int* info = rec_info + 4 * (size_t)r;
            info[0] = length;
            info[1] = flag | (mode << 8) | (nb << 16) | (off_w << 24);
            info[2] = (int)off_word;
            info[3] = __float_as_int(zmin);
            if ((mode == 1 && nb > cap_nb) || (mode == 0 && !raw_ok)) *fits = 0;
        }
    }
    // per-depth image range over the valid values: merge the CTA's warps,
    // one atomic per depth (a block with no valid value takes no part)
    if (lane == 0) {
        s_min[warp] = zmin;
        s_max[warp] = zmax;
        s_di[warp] = live && (!MASKED || cnt > 0) ? r % d : -1;
    }
    __syncthreads();
    if (threadIdx.x < WARPS && s_di[threadIdx.x] >= 0) {
        const int me = threadIdx.x, di = s_di[me];
        bool first = true;
        for (int k = 0; k < me; ++k) first &= s_di[k] != di;
        if (first) {
            float lo = s_min[me], hi = s_max[me];
            for (int k = me + 1; k < WARPS; ++k) {
                if (s_di[k] == di) {
                    lo = fminf(lo, s_min[k]);
                    hi = fmaxf(hi, s_max[k]);
                }
            }
            atomic_min_f(zrange + di, lo);
            atomic_max_f(zrange + d + di, hi);
        }
    }
}

__global__ void encode_blocks_kernel(const float* __restrict__ data, int w, int d, int nbh,
                                     int n_rec, float mze, float scale, float inv,
                                     int integ_mask, int cap_nb, int raw_ok,
                                     int* __restrict__ rec_info, float* __restrict__ zrange,
                                     int* __restrict__ fits) {
    encode_blocks_body<false>(data, nullptr, w, d, nbh, n_rec, mze, scale, inv, integ_mask,
                              cap_nb, raw_ok, rec_info, zrange, fits);
}

__global__ void encode_blocks_masked_kernel(const float* __restrict__ data,
                                            const int2* __restrict__ valid, int w, int d,
                                            int nbh, int n_rec, float mze, float scale,
                                            float inv, int integ_mask, int cap_nb, int raw_ok,
                                            int* __restrict__ rec_info,
                                            float* __restrict__ zrange, int* __restrict__ fits) {
    encode_blocks_body<true>(data, valid, w, d, nbh, n_rec, mze, scale, inv, integ_mask,
                             cap_nb, raw_ok, rec_info, zrange, fits);
}

template <bool MASKED>
__device__ __forceinline__ void write_records_body(
        const float* __restrict__ data, const int2* __restrict__ valid, int w, int d, int nbh,
        int n_rec, float scale, float inv, const int* __restrict__ rec_info,
        const int* __restrict__ starts, uint32_t* __restrict__ stream, long long cap_w) {
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
    uint32_t vw0, vw1;
    const int cnt = block_valid<MASKED>(valid, b, vw0, vw1);

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

    // payload: LSB-first bit-stuffed quantized values, or the raw f32 bits
    if (mode == 0 || mode == 1) {
        float x0, x1;
        load_pair(data, w, d, nbh, b, di, lane, x0, x1);
        const int width = mode == 0 ? 32 : nb;
        const int pay = 8 * (sh + (mode == 0 ? 1 : 3 + off_w));
        const float zmin = __int_as_float(info[3]);
        uint32_t v[2];
        if (mode == 0) {
            v[0] = __float_as_uint(x0);
            v[1] = __float_as_uint(x1);
        } else {
            v[0] = quantize(x0, zmin, scale, inv);
            v[1] = quantize(x1, zmin, scale, inv);
        }
        for (int k = 0; k < 2; ++k) {
            if (!lane_valid<MASKED>(vw0, vw1, lane, k)) continue;
            const int bitpos = pay + valid_rank<MASKED>(vw0, vw1, lane, k) * width;
            const int wi = bitpos >> 5, bit = bitpos & 31;
            atomicOr(&buf[wi], v[k] << bit);
            if (bit && bit + width > 32) atomicOr(&buf[wi + 1], v[k] >> (32 - bit));
        }
    }
    __syncwarp();

    // interior words belong to this record alone; the first and last may
    // share bytes with the neighbours and merge by atomicOr (the stream is
    // zeroed and every record's bytes past its length are zero)
    const int nwords = (sh + length + 3) >> 2;
    const long long base = s >> 2;
    for (int i = lane; i < nwords; i += 32) {
        const long long gw = base + i;
        if (gw < 0 || gw >= cap_w) continue;  // over-capacity records: fits is already 0
        if (i == 0 || i == nwords - 1) atomicOr(&stream[gw], buf[i]);
        else stream[gw] = buf[i];
    }
}

__global__ void write_records_kernel(const float* __restrict__ data, int w, int d, int nbh,
                                     int n_rec, float scale, float inv,
                                     const int* __restrict__ rec_info,
                                     const int* __restrict__ starts,
                                     uint32_t* __restrict__ stream, long long cap_w) {
    write_records_body<false>(data, nullptr, w, d, nbh, n_rec, scale, inv, rec_info, starts,
                              stream, cap_w);
}

__global__ void write_records_masked_kernel(const float* __restrict__ data,
                                            const int2* __restrict__ valid, int w, int d,
                                            int nbh, int n_rec, float scale, float inv,
                                            const int* __restrict__ rec_info,
                                            const int* __restrict__ starts,
                                            uint32_t* __restrict__ stream, long long cap_w) {
    write_records_body<true>(data, valid, w, d, nbh, n_rec, scale, inv, rec_info, starts,
                             stream, cap_w);
}

// ---------------------------------------------------------------------------
// Integer instances (encode_tiles :591-614, :651-653, :677-722), templated
// over the input element type T (the codec's own dtype, or int32 as JAX's
// xb.astype(int32) takes it) and the mask. Values go through int32 (wrapping
// as astype does) for the block minimum, the quantized values and the raw
// bytes, and through f32 for the block maximum and the mode heuristics,
// exactly as the reference mixes them. Lossless (maxZError 0.5): q = x -
// zmin; lossy: q0 = rint(f32(x - zmin) * scale) with the sign-directed +-1
// fixup against the exact integer reconstruction zmin + q * round(2 mze),
// where no multiply-add can be contracted.
//
// Depth-diff (v >= 5, 8/16-bit lossless, depth > 1): the warp of record
// (b, di > 0) also loads slice di-1 of block b, reduces the differences, and
// takes the diff record when it is strictly shorter (flag bit 2, offset
// reduced as DataType INT). desc bit 10 tells K2 to write differences.
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void load_pair_t(const T* data, int w, int d, int nbh, int b, int di,
                                            int lane, T& x0, T& x1) {
    int row = (b / nbh) * 8 + (lane >> 3);
    int col = (b % nbh) * 8 + (lane & 7);
    x0 = data[((size_t)row * w + col) * d + di];
    x1 = data[((size_t)(row + 4) * w + col) * d + di];
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

__device__ __forceinline__ uint32_t low_bytes(uint32_t v, int nbytes) {
    return nbytes >= 4 ? v : (v & ((1u << (8 * nbytes)) - 1u));
}

__device__ __forceinline__ int wrap_sub(int a, int b) { return (int)((uint32_t)a - (uint32_t)b); }
__device__ __forceinline__ int wrap_mad(int a, int q, int m) {
    return (int)((uint32_t)a + (uint32_t)q * (uint32_t)m);
}
__device__ __forceinline__ int wrap_abs(int a) { return a < 0 ? (int)(0u - (uint32_t)a) : a; }

// one quantized integer value (device_encode.py:601-613)
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

template <typename T, bool MASKED>
__device__ __forceinline__ void encode_blocks_int_body(
        const T* __restrict__ data, const int2* __restrict__ valid, int w, int d, int nbh,
        int n_rec, int dt, int size_t_, float mze, float scale, int inv_i, int lossless,
        float maxq_cap, int integ_mask, int cap_nb, int raw_ok, int try_diff,
        int* __restrict__ rec_info, int* __restrict__ zrange, int* __restrict__ fits) {
    __shared__ int s_min[WARPS], s_max[WARPS], s_di[WARPS];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = blockIdx.x * WARPS + warp;
    const bool live = r < n_rec;  // warp-uniform
    int lo = INT_MAX, hi = INT_MIN, cnt = 0;
    if (live) {
        const int b = r / d, di = r % d;
        uint32_t vw0, vw1;
        cnt = block_valid<MASKED>(valid, b, vw0, vw1);
        const bool ok0 = lane_valid<MASKED>(vw0, vw1, lane, 0);
        const bool ok1 = lane_valid<MASKED>(vw0, vw1, lane, 1);
        T x0, x1;
        load_pair_t(data, w, d, nbh, b, di, lane, x0, x1);
        const int xi0 = (int)x0, xi1 = (int)x1;
        lo = __reduce_min_sync(FULL, min(ok0 ? xi0 : INT_MAX, ok1 ? xi1 : INT_MAX));
        hi = __reduce_max_sync(FULL, max(ok0 ? xi0 : INT_MIN, ok1 ? xi1 : INT_MIN));
        float fmax = fmaxf(ok0 ? (float)x0 : -CUDART_INF_F, ok1 ? (float)x1 : -CUDART_INF_F);
        for (int o = 16; o > 0; o >>= 1) fmax = fmaxf(fmax, __shfl_xor_sync(FULL, fmax, o));
        int zmin = lo;
        if (MASKED && cnt == 0) zmin = 0, fmax = 0.f;  // const-0 record
        uint32_t max_q = __reduce_max_sync(
            FULL, max(ok0 ? quantize_int(xi0, zmin, lossless, scale, inv_i) : 0u,
                      ok1 ? quantize_int(xi1, zmin, lossless, scale, inv_i) : 0u));
        // depth-diff candidate against slice di-1 of the same block
        int dmin = 0, dmax = 0;
        uint32_t max_qd = 0;
        const bool cand = try_diff && di > 0;  // warp-uniform
        if (cand) {
            T p0, p1;
            load_pair_t(data, w, d, nbh, b, di - 1, lane, p0, p1);
            const int dv0 = wrap_sub(xi0, (int)p0), dv1 = wrap_sub(xi1, (int)p1);
            dmin = __reduce_min_sync(FULL, min(ok0 ? dv0 : 1 << 30, ok1 ? dv1 : 1 << 30));
            dmax = __reduce_max_sync(FULL, max(ok0 ? dv0 : -(1 << 30), ok1 ? dv1 : -(1 << 30)));
            if (MASKED && cnt == 0) dmin = dmax = 0;
            max_qd = __reduce_max_sync(FULL, max(ok0 ? (uint32_t)wrap_sub(dv0, dmin) : 0u,
                                                 ok1 ? (uint32_t)wrap_sub(dv1, dmin) : 0u));
        }
        if (lane == 0) {
            const float zmin_f = __int2float_rn(zmin);
            int nb = max_q ? 32 - __clz(max_q) : 0;
            const float max_val = __fmul_rn(__fsub_rn(fmax, zmin_f), scale);
            bool const0 = (MASKED && cnt == 0) || (zmin_f == 0.f && fmax == 0.f);
            const bool force_raw = (mze == 0.f && fmax > zmin_f) || (mze > 0.f && max_val > maxq_cap);
            int tc, off_w;
            reduce_offset_int(zmin, dt, tc, off_w);
            uint32_t off_word = low_bytes((uint32_t)zmin, off_w);
            // count byte width 1 (cnt < 256)
            int stuff_len = 1 + off_w + (max_q ? 2 + ((cnt * nb + 7) >> 3) : 0);
            const int raw_len = 1 + cnt * size_t_;
            int zq = zmin;  // what K2 subtracts: the block min, or the diff min
            bool use_diff = false;
            if (cand) {
                const int nbd = max_qd ? 32 - __clz(max_qd) : 0;
                int tc_d, off_w_d;
                reduce_offset_int(dmin, lerc2::DT_INT, tc_d, off_w_d);
                const int stuff_len_d = 1 + off_w_d + (max_qd ? 2 + ((cnt * nbd + 7) >> 3) : 0);
                const bool const0_d = dmin == 0 && dmax == 0;
                const int diff_len = const0_d ? 1 : stuff_len_d;
                use_diff = lossless && cnt > 0 && !const0 && diff_len < stuff_len
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
            const int integ = (((b % nbh) & 15) << 2) & integ_mask;
            const int flag = integ | (use_diff ? 4 : 0) | mode
                             | ((mode == 1 || mode == 3) ? tc << 6 : 0);
            int* info = rec_info + 4 * (size_t)r;
            info[0] = length;
            info[1] = flag | (mode << 8) | ((int)use_diff << 10) | (nb << 16) | (off_w << 24);
            info[2] = (int)off_word;
            info[3] = zq;
            if ((mode == 1 && nb > cap_nb) || (mode == 0 && !raw_ok)) *fits = 0;
        }
    }
    // per-depth image range over the valid values (int32, as JAX), merged
    // per CTA as in the float kernel
    if (lane == 0) {
        s_min[warp] = lo;
        s_max[warp] = hi;
        s_di[warp] = live && (!MASKED || cnt > 0) ? r % d : -1;
    }
    __syncthreads();
    if (threadIdx.x < WARPS && s_di[threadIdx.x] >= 0) {
        const int me = threadIdx.x, di = s_di[me];
        bool first = true;
        for (int k = 0; k < me; ++k) first &= s_di[k] != di;
        if (first) {
            int l = s_min[me], h = s_max[me];
            for (int k = me + 1; k < WARPS; ++k) {
                if (s_di[k] == di) {
                    l = min(l, s_min[k]);
                    h = max(h, s_max[k]);
                }
            }
            atomicMin(zrange + di, l);
            atomicMax(zrange + d + di, h);
        }
    }
}

template <typename T, bool MASKED>
__global__ void encode_blocks_int_kernel(const T* __restrict__ data,
                                         const int2* __restrict__ valid, int w, int d, int nbh,
                                         int n_rec, int dt, int size_t_, float mze, float scale,
                                         int inv_i, int lossless, float maxq_cap, int integ_mask,
                                         int cap_nb, int raw_ok, int try_diff,
                                         int* __restrict__ rec_info, int* __restrict__ zrange,
                                         int* __restrict__ fits) {
    encode_blocks_int_body<T, MASKED>(data, valid, w, d, nbh, n_rec, dt, size_t_, mze, scale,
                                      inv_i, lossless, maxq_cap, integ_mask, cap_nb, raw_ok,
                                      try_diff, rec_info, zrange, fits);
}

template <typename T, bool MASKED>
__global__ void write_records_int_kernel(const T* __restrict__ data,
                                         const int2* __restrict__ valid, int w, int d, int nbh,
                                         int n_rec, int size_t_, float scale, int inv_i,
                                         int lossless, const int* __restrict__ rec_info,
                                         const int* __restrict__ starts,
                                         uint32_t* __restrict__ stream, long long cap_w) {
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
    const int flag = desc & 0xFF, mode = (desc >> 8) & 3, use_diff = (desc >> 10) & 1;
    const int nb = (desc >> 16) & 0xFF, off_w = desc >> 24;
    const long long s = starts[r];
    const int sh = (int)(s & 3);
    const int b = r / d, di = r % d;
    uint32_t vw0, vw1;
    const int cnt = block_valid<MASKED>(valid, b, vw0, vw1);

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

    // payload: bit-stuffed quantized values (or differences to slice di-1),
    // or the raw native little-endian values at size_t bytes each
    if (mode == 0 || mode == 1) {
        T x0, x1;
        load_pair_t(data, w, d, nbh, b, di, lane, x0, x1);
        const int width = mode == 0 ? 8 * size_t_ : nb;
        const int pay = 8 * (sh + (mode == 0 ? 1 : 3 + off_w));
        const int zq = info[3];
        uint32_t v[2];
        if (mode == 0) {
            v[0] = low_bytes((uint32_t)(int)x0, size_t_);
            v[1] = low_bytes((uint32_t)(int)x1, size_t_);
        } else if (use_diff) {
            T p0, p1;
            load_pair_t(data, w, d, nbh, b, di - 1, lane, p0, p1);
            v[0] = (uint32_t)wrap_sub(wrap_sub((int)x0, (int)p0), zq);
            v[1] = (uint32_t)wrap_sub(wrap_sub((int)x1, (int)p1), zq);
        } else {
            v[0] = quantize_int((int)x0, zq, lossless, scale, inv_i);
            v[1] = quantize_int((int)x1, zq, lossless, scale, inv_i);
        }
        for (int k = 0; k < 2; ++k) {
            if (!lane_valid<MASKED>(vw0, vw1, lane, k)) continue;
            const int bitpos = pay + valid_rank<MASKED>(vw0, vw1, lane, k) * width;
            const int wi = bitpos >> 5, bit = bitpos & 31;
            atomicOr(&buf[wi], v[k] << bit);
            if (bit && bit + width > 32) atomicOr(&buf[wi + 1], v[k] >> (32 - bit));
        }
    }
    __syncwarp();

    const int nwords = (sh + length + 3) >> 2;
    const long long base = s >> 2;
    for (int i = lane; i < nwords; i += 32) {
        const long long gw = base + i;
        if (gw < 0 || gw >= cap_w) continue;
        if (i == 0 || i == nwords - 1) atomicOr(&stream[gw], buf[i]);
        else stream[gw] = buf[i];
    }
}

// the launch of one (input type, mask) instance
template <typename T>
int launch_encode_int(const void* data, const int* valid, int h, int w, int d, int dt,
                      int size_t_, float mze, float scale, int inv_i, int lossless,
                      float maxq_cap, int integ_mask, int cap_nb, int raw_ok, int try_diff,
                      int* rec_info, int* zrange, int* fits, cudaStream_t st) {
    const int nbh = w / 8;
    const int n_rec = (h / 8) * nbh * d;
    const int grid = (n_rec + WARPS - 1) / WARPS;
    const T* x = static_cast<const T*>(data);
    if (valid)
        encode_blocks_int_kernel<T, true><<<grid, WARPS * 32, 0, st>>>(
            x, reinterpret_cast<const int2*>(valid), w, d, nbh, n_rec, dt, size_t_, mze, scale,
            inv_i, lossless, maxq_cap, integ_mask, cap_nb, raw_ok, try_diff, rec_info, zrange,
            fits);
    else
        encode_blocks_int_kernel<T, false><<<grid, WARPS * 32, 0, st>>>(
            x, nullptr, w, d, nbh, n_rec, dt, size_t_, mze, scale, inv_i, lossless, maxq_cap,
            integ_mask, cap_nb, raw_ok, try_diff, rec_info, zrange, fits);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_write_int(const void* data, const int* valid, int h, int w, int d, int size_t_,
                     float scale, int inv_i, int lossless, const int* rec_info,
                     const int* starts, uint32_t* out, long long cap_w, cudaStream_t st) {
    const int nbh = w / 8;
    const int n_rec = (h / 8) * nbh * d;
    const int grid = (n_rec + WARPS - 1) / WARPS;
    const T* x = static_cast<const T*>(data);
    if (valid)
        write_records_int_kernel<T, true><<<grid, WARPS * 32, 0, st>>>(
            x, reinterpret_cast<const int2*>(valid), w, d, nbh, n_rec, size_t_, scale, inv_i,
            lossless, rec_info, starts, out, cap_w);
    else
        write_records_int_kernel<T, false><<<grid, WARPS * 32, 0, st>>>(
            x, nullptr, w, d, nbh, n_rec, size_t_, scale, inv_i, lossless, rec_info, starts,
            out, cap_w);
    return (int)cudaGetLastError();
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

// Integer K1: in_type is the element type of `data`, dt the codec's dtype
// (offset reduction, raw width); zrange: [2D] int32 set to INT_MAX / INT_MIN
extern "C" int encode_blocks_int(const void* data, int in_type, const int* valid, int h, int w,
                                 int d, int dt, int size_t_, float mze, float scale, int inv_i,
                                 int lossless, float maxq_cap, int integ_mask, int cap_nb,
                                 int raw_ok, int try_diff, int* rec_info, int* zrange,
                                 int* fits, void* stream) {
    DISPATCH_INT_INPUT(in_type, launch_encode_int, data, valid, h, w, d, dt, size_t_, mze,
                       scale, inv_i, lossless, maxq_cap, integ_mask, cap_nb, raw_ok, try_diff,
                       rec_info, zrange, fits, (cudaStream_t)stream)
}

extern "C" int write_records_int(const void* data, int in_type, const int* valid, int h, int w,
                                 int d, int size_t_, float scale, int inv_i, int lossless,
                                 const int* rec_info, const int* starts, uint32_t* out,
                                 long long cap_w, void* stream) {
    DISPATCH_INT_INPUT(in_type, launch_write_int, data, valid, h, w, d, size_t_, scale, inv_i,
                       lossless, rec_info, starts, out, cap_w, (cudaStream_t)stream)
}

// valid: [nBlocks, 2] u32 validity words, or null for an all-valid image
// (then the all-valid kernel runs)
extern "C" int encode_blocks(const float* data, const int* valid, int h, int w, int d,
                             float mze, float scale, float inv, int integ_mask, int cap_nb,
                             int raw_ok, int* rec_info, float* zrange, int* fits,
                             void* stream) {
    const int nbh = w / 8;
    const int n_rec = (h / 8) * nbh * d;
    const int grid = (n_rec + WARPS - 1) / WARPS;
    if (valid)
        encode_blocks_masked_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
            data, reinterpret_cast<const int2*>(valid), w, d, nbh, n_rec, mze, scale, inv,
            integ_mask, cap_nb, raw_ok, rec_info, zrange, fits);
    else
        encode_blocks_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
            data, w, d, nbh, n_rec, mze, scale, inv, integ_mask, cap_nb, raw_ok,
            rec_info, zrange, fits);
    return (int)cudaGetLastError();
}

extern "C" int write_records(const float* data, const int* valid, int h, int w, int d,
                             float scale, float inv, const int* rec_info, const int* starts,
                             uint32_t* out, long long cap_w, void* stream) {
    const int nbh = w / 8;
    const int n_rec = (h / 8) * nbh * d;
    const int grid = (n_rec + WARPS - 1) / WARPS;
    if (valid)
        write_records_masked_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
            data, reinterpret_cast<const int2*>(valid), w, d, nbh, n_rec, scale, inv,
            rec_info, starts, out, cap_w);
    else
        write_records_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
            data, w, d, nbh, n_rec, scale, inv, rec_info, starts, out, cap_w);
    return (int)cudaGetLastError();
}
