// K1 encode_blocks and K2 write_records: the Lerc2 tile encoder for
// float32 rasters with 8x8 micro blocks, no LUT mode, all-valid or masked.
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

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

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

}  // namespace

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
