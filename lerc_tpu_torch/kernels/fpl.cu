// F1-F3: lossless float32 and float64 (fpl, Lerc2 v6 "delta-delta Huffman",
// fpl_Lerc2Ext.cpp:405-866).
//
// Replaces lerc_tpu/ops/device_fpl.py: its float32 half, and its float64
// half (fpl_choose_device_f64 :300, fpl_finalize_device_f64 :344,
// fpl_restore_device_f64 :407), which carries each double as two u32 limbs,
// subtracts with a borrow across them and splits its prefix sums into 6-bit
// limbs. The TPU version builds each byte level as a whole shifted array,
// counts bins with nibble matmuls, derives run lengths from cummax/cummin
// scans and splits each prefix sum into 6-bit int32 limbs (exact only up to
// 2^25 elements); here a byte level is one binomial sum per position,
// histograms are shared-memory atomics, runs are compacted by per-chunk
// ranks, and the prefix sums are chunked block scans in native u32 or u64
// words, where the split-field add is associative.
//
// One template per kernel serves both word types (Word32, Word64 below):
// float32 words are float-transformed (exponent above sign above the 23-bit
// mantissa; split fields 23 + 9 bits) and make 4 byte planes; float64 words
// are the raw bits (no transform; split fields 52 + 12 bits) and make 8.
//
//   F1 fpl_sample_histograms   fpl_choose_device :123 / _f64 :300 (float_transform_dev
//                              :43, apply_predictor_dev :58 / apply_predictor64_dev
//                              :285, _byte_deriv1 :70, histogram256): one thread per
//                              counted position q (every 7th of the flattened sample
//                              of every stride-th row) and per predictor and group
//                              of 4 planes (grid y): the predicted words at q-5..q,
//                              then for each plane and level k the byte
//                              Delta^min(q,k) x[q], counted in shared bins (24 KB a
//                              CTA), one global add per bin.
//   F2 fpl_finalize            fpl_finalize_device :168 / _f64 :344: a CTA stages the
//                              predicted words of 1024 positions and the 5 before
//                              them in shared memory; each position writes its
//                              plane bytes at their levels and counts them.
//   F2b fpl_packbits_size      packbits_size_device :88, over 4 or 8 planes: per
//                              plane, run starts counted per 2048-byte chunk, the
//                              counts scanned by one CTA, the starts scattered at
//                              their ranks; each run then reads its start, its
//                              successor's and its predecessor's, and adds its
//                              repeat segments, literal and literal-stretch opening
//                              to three sums; one thread per plane applies JAX's
//                              formula.
//   F3 fpl_restore             fpl_restore_device :235 / _f64 :407 (_cumsum_mod_dev
//                              :202, split_cumsum_dev :218 / split_cumsum64_dev
//                              :398, _cumsum_mod52_pair :366, undo_float_transform_dev
//                              :227): for each level from the highest down, a
//                              chunked scan mod 256 of each plane from index
//                              level - 1 (chunk sums, one CTA scans them per
//                              plane, each chunk rescanned with its carry); the
//                              words; predictor 2: a scan down the columns over
//                              256-row tiles (a warp a 32-row strip, lanes on
//                              columns; tile sums scanned by one CTA a column);
//                              predictors 1 and 2: a segmented flat scan along
//                              the rows; the transform undone on the way out.
//
// Bounds: bytes. F1 reads a sample of about 2^19 words; F2 reads each word
// once (its neighbours from cache) and writes one byte a plane; F2b and F3
// read and write each plane byte a few times. The scans' carry passes are
// serial over chunk counts (n / 4096 per plane, rows / 256 per column), not
// over values.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"  // SegT, Sum, block_excl, block_seg_excl

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DELTA = 5;
constexpr int PRIME_MULT = 7;
constexpr int MAX_PLANES = 8;
constexpr int NB = 256;                   // threads per CTA
constexpr int WARPS = NB / 32;
constexpr int MAX_GRID = 1056;            // 8 CTAs on each of 132 SMs (grid-stride beyond)
constexpr int HIST = 4 * (MAX_DELTA + 1) * 256;  // one CTA's bins: 4 planes x 6 levels
constexpr int FIN_ITEMS = 4, FIN_TILE = NB * FIN_ITEMS;
constexpr int PB_ITEMS = 8, PB_CHUNK = NB * PB_ITEMS;
constexpr int SC_ITEMS = 16, SC_CHUNK = NB * SC_ITEMS;
constexpr int COL_TILE = 256, COL_ROWS = COL_TILE / WARPS;

// (-1)^j C(k, j) mod 2^32: byte level k of x at q is sum_j COEF[k][j] x[q - j]
__constant__ unsigned COEF[MAX_DELTA + 1][MAX_DELTA + 1] = {
    {1u, 0u, 0u, 0u, 0u, 0u},
    {1u, 0u - 1u, 0u, 0u, 0u, 0u},
    {1u, 0u - 2u, 1u, 0u, 0u, 0u},
    {1u, 0u - 3u, 3u, 0u - 1u, 0u, 0u},
    {1u, 0u - 4u, 6u, 0u - 4u, 1u, 0u},
    {1u, 0u - 5u, 10u, 0u - 10u, 5u, 0u - 1u},
};

struct Levels {
    int v[MAX_PLANES];
};

unsigned grid_of(long long n, int per) {
    const long long g = (n + per - 1) / per;
    return (unsigned)(g < 1 ? 1 : g < MAX_GRID ? g : MAX_GRID);
}

// float32: the float transform (fpl_UnitTypes.cpp:39-81), mantissa 23 bits,
// exponent+sign 9 bits, 4 planes
struct Word32 {
    using W = unsigned;
    static constexpr int PLANES = 4, MBITS = 23;
    static constexpr W MANT = 0x7FFFFFu, HI = 0x1FFu;
    __device__ static W load(const W* data, long long i) {
        const W u = data[i];
        return (u & MANT) | (((u >> 23) & 0xFFu) << 24) | ((u >> 31) << 23);
    }
    __device__ static W store(W u) {
        return (u & MANT) | (((u >> 24) & 0xFFu) << 23) | (((u >> 23) & 1u) << 31);
    }
};

// float64: the raw bits (no transform), mantissa 52 bits, exponent+sign 12
// bits, 8 planes
struct Word64 {
    using W = unsigned long long;
    static constexpr int PLANES = 8, MBITS = 52;
    static constexpr W MANT = (1ull << 52) - 1ull, HI = 0xFFFull;
    __device__ static W load(const W* data, long long i) { return data[i]; }
    __device__ static W store(W u) { return u; }
};

// split-field arithmetic: mantissa and exponent+sign wrap apart
template <class P>
__device__ __forceinline__ typename P::W ssub(typename P::W a, typename P::W b) {
    return ((a - b) & P::MANT) | ((((a >> P::MBITS) - (b >> P::MBITS)) & P::HI) << P::MBITS);
}

template <class P>
__device__ __forceinline__ typename P::W sadd(typename P::W a, typename P::W b) {
    return ((a + b) & P::MANT) | ((((a >> P::MBITS) + (b >> P::MBITS)) & P::HI) << P::MBITS);
}

// the predicted word at (row r, column c) of the [rows, cols] word image;
// rup is the row predictor 2 subtracts (-1: none)
template <class P>
__device__ __forceinline__ typename P::W predicted(const typename P::W* __restrict__ data,
                                                   int cols, long long r, long long rup, int c,
                                                   int pred) {
    using W = typename P::W;
    const long long i = r * cols + c;
    const W x = P::load(data, i);
    if (pred == 0) return x;
    const W d1 = c > 0 ? ssub<P>(x, P::load(data, i - 1)) : x;
    if (pred == 1 || rup < 0) return d1;
    const long long j = rup * cols + c;
    const W u = P::load(data, j);
    return ssub<P>(d1, c > 0 ? ssub<P>(u, P::load(data, j - 1)) : u);
}

// byte b of level k from the words w[0] = x[q], w[j] = x[q - j] (j <= kk)
template <class W>
__device__ __forceinline__ unsigned level_byte(const W* w, int b, int kk) {
    unsigned v = 0;
#pragma unroll
    for (int j = 0; j <= MAX_DELTA; ++j)
        if (j <= kk) v += COEF[kk][j] * (unsigned)((w[j] >> (8 * b)) & 0xFFu);
    return v & 0xFFu;
}

// ---------------------------------------------------------------------------
// block scans (block_scan.cuh) under the split-field add
// ---------------------------------------------------------------------------

template <class P>
struct SplitAdd {
    using T = typename P::W;
    __device__ static T f(T a, T b) { return sadd<P>(a, b); }
};

// in place: x[k * step] (k < count) becomes the exclusive prefix of the
// sequence under Op; one CTA walks it in tiles of NB; sm holds 2 * (WARPS + 1) values
template <class Op>
__device__ void block_scan_in_place(typename Op::T* x, long long count, long long step,
                                    typename Op::T* sm) {
    using T = typename Op::T;
    T carry = 0;
    for (long long k0 = 0; k0 < count; k0 += NB) {
        const long long k = k0 + threadIdx.x;
        const T v = k < count ? x[k * step] : T(0);
        T tot;
        const T ex = block_excl<NB, Op>(v, tot, sm);
        if (k < count) x[k * step] = Op::f(carry, ex);
        carry = Op::f(carry, tot);
    }
}

// ---------------------------------------------------------------------------
// F1
// ---------------------------------------------------------------------------

// grid y: predictor * (planes / 4) + plane group; the CTA counts 4 planes
template <class P>
__global__ void __launch_bounds__(NB) fpl_sample_histograms_kernel(
        const typename P::W* __restrict__ data, int cols, int stride, long long m,
        int* __restrict__ hist) {
    using W = typename P::W;
    constexpr int GROUPS = P::PLANES / 4;
    __shared__ unsigned bins[HIST];
    const int pred = blockIdx.y / GROUPS, b0 = 4 * (blockIdx.y % GROUPS);
    for (int i = threadIdx.x; i < HIST; i += NB) bins[i] = 0;
    __syncthreads();
    const long long n_cnt = (m + PRIME_MULT - 1) / PRIME_MULT;
    for (long long t = (long long)blockIdx.x * NB + threadIdx.x; t < n_cnt;
         t += (long long)gridDim.x * NB) {
        const long long q = t * PRIME_MULT;
        const int kmax = q < MAX_DELTA ? (int)q : MAX_DELTA;
        W w[MAX_DELTA + 1];
#pragma unroll
        for (int j = 0; j <= MAX_DELTA; ++j) {
            w[j] = 0;
            if (j <= kmax) {
                const long long s = q - j, sr = s / cols;
                w[j] = predicted<P>(data, cols, sr * stride, sr > 0 ? (sr - 1) * stride : -1,
                                    (int)(s - sr * cols), pred);
            }
        }
#pragma unroll
        for (int bb = 0; bb < 4; ++bb)
#pragma unroll
            for (int k = 0; k <= MAX_DELTA; ++k)
                atomicAdd(&bins[(bb * (MAX_DELTA + 1) + k) * 256
                                + level_byte(w, b0 + bb, k < kmax ? k : kmax)], 1u);
    }
    __syncthreads();
    int* out = hist + ((long long)pred * P::PLANES + b0) * (MAX_DELTA + 1) * 256;
    for (int i = threadIdx.x; i < HIST; i += NB)
        if (bins[i]) atomicAdd(&out[i], (int)bins[i]);
}

// ---------------------------------------------------------------------------
// F2
// ---------------------------------------------------------------------------

template <class P>
__global__ void __launch_bounds__(NB) fpl_finalize_kernel(
        const typename P::W* __restrict__ data, long long n, int cols, int pred, Levels lv,
        uint8_t* __restrict__ planes, long long pstride, int* __restrict__ histos) {
    using W = typename P::W;
    __shared__ W pw[FIN_TILE + MAX_DELTA];
    __shared__ unsigned bins[P::PLANES * 256];
    for (int i = threadIdx.x; i < P::PLANES * 256; i += NB) bins[i] = 0;
    for (long long base = (long long)blockIdx.x * FIN_TILE; base < n;
         base += (long long)gridDim.x * FIN_TILE) {
        __syncthreads();  // the last tile's words are read
        for (int k = threadIdx.x; k < FIN_TILE + MAX_DELTA; k += NB) {
            const long long i = base - MAX_DELTA + k;
            if (i >= 0 && i < n) {
                const long long r = i / cols;
                pw[k] = predicted<P>(data, cols, r, r - 1, (int)(i - r * cols), pred);
            }
        }
        __syncthreads();
        for (int it = 0; it < FIN_ITEMS; ++it) {
            const int k = it * NB + threadIdx.x;
            const long long i = base + k;
            if (i >= n) break;
            W w[MAX_DELTA + 1];
#pragma unroll
            for (int j = 0; j <= MAX_DELTA; ++j) w[j] = j <= i ? pw[k + MAX_DELTA - j] : W(0);
#pragma unroll
            for (int b = 0; b < P::PLANES; ++b) {
                const int kk = (long long)lv.v[b] < i ? lv.v[b] : (int)i;
                const unsigned v = level_byte(w, b, kk);
                planes[b * pstride + i] = (uint8_t)v;
                atomicAdd(&bins[b * 256 + v], 1u);
            }
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < P::PLANES * 256; i += NB)
        if (bins[i]) atomicAdd(&histos[i], (int)bins[i]);
}

// ---------------------------------------------------------------------------
// F2b (grid y or x: one plane each)
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool run_start(const uint8_t* p, long long i, long long n) {
    return i < n && (i == 0 || p[i] != p[i - 1]);
}

// counts[b][c]: run starts in chunk c of plane b
__global__ void __launch_bounds__(NB) fpl_pb_count_kernel(
        const uint8_t* __restrict__ planes, long long pstride, long long n, long long n_chunks,
        int* __restrict__ counts) {
    __shared__ unsigned sm[2 * (WARPS + 1)];
    const int b = blockIdx.y;
    const uint8_t* p = planes + b * pstride;
    const long long i0 = (long long)blockIdx.x * PB_CHUNK + threadIdx.x * PB_ITEMS;
    unsigned cnt = 0;
    for (int j = 0; j < PB_ITEMS; ++j) cnt += run_start(p, i0 + j, n);
    unsigned tot;
    block_excl<NB>(cnt, tot, sm);
    if (threadIdx.x == 0) counts[b * n_chunks + blockIdx.x] = (int)tot;
}

// counts -> exclusive bases in place; n_runs[b]; the sentinel start n
__global__ void __launch_bounds__(NB) fpl_pb_scan_kernel(
        int* __restrict__ counts, long long n_chunks, long long n, int* __restrict__ starts,
        long long sstride, int* __restrict__ n_runs) {
    __shared__ unsigned sm[2 * (WARPS + 1)];
    const int b = blockIdx.x;
    unsigned* c = reinterpret_cast<unsigned*>(counts + b * n_chunks);
    const unsigned last = (unsigned)counts[b * n_chunks + n_chunks - 1];
    __syncthreads();
    block_scan_in_place<Sum>(c, n_chunks, 1, sm);
    if (threadIdx.x == 0) {
        const unsigned total = c[n_chunks - 1] + last;
        n_runs[b] = (int)total;
        starts[b * sstride + total] = (int)n;
    }
}

__global__ void __launch_bounds__(NB) fpl_pb_scatter_kernel(
        const uint8_t* __restrict__ planes, long long pstride, long long n, long long n_chunks,
        const int* __restrict__ bases, int* __restrict__ starts, long long sstride) {
    __shared__ unsigned sm[2 * (WARPS + 1)];
    const int b = blockIdx.y;
    const uint8_t* p = planes + b * pstride;
    const long long i0 = (long long)blockIdx.x * PB_CHUNK + threadIdx.x * PB_ITEMS;
    unsigned flags = 0, cnt = 0;
    for (int j = 0; j < PB_ITEMS; ++j)
        if (run_start(p, i0 + j, n)) {
            flags |= 1u << j;
            ++cnt;
        }
    unsigned tot;
    long long rank = bases[b * n_chunks + blockIdx.x] + block_excl<NB>(cnt, tot, sm);
    for (int j = 0; j < PB_ITEMS; ++j)
        if (flags >> j & 1u) starts[b * sstride + rank++] = (int)(i0 + j);
}

// sums[b] += (repeat segments, literals, literal stretches opened) of its runs
__global__ void __launch_bounds__(NB) fpl_pb_sum_kernel(
        const int* __restrict__ starts, long long sstride, const int* __restrict__ n_runs,
        unsigned long long* __restrict__ sums) {
    __shared__ unsigned long long red[3][WARPS];
    const int b = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int* s = starts + b * sstride;
    const long long runs = n_runs[b];
    unsigned long long acc[3] = {0, 0, 0};
    for (long long r = (long long)blockIdx.x * NB + threadIdx.x; r < runs;
         r += (long long)gridDim.x * NB) {
        const long long len = (long long)s[r + 1] - s[r];
        const long long prev = r > 0 ? (long long)s[r] - s[r - 1] : 0;
        const bool lit = len % 129 == 1;
        acc[0] += len / 129 + (len % 129 >= 2);
        acc[1] += lit;
        acc[2] += lit && (len >= 130 || prev % 129 != 1);
    }
    for (int k = 0; k < 3; ++k) {
        unsigned long long v = acc[k];
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
        if (lane == 0) red[k][warp] = v;
    }
    __syncthreads();
    if (threadIdx.x < 3) {
        unsigned long long v = 0;
        for (int w = 0; w < WARPS; ++w) v += red[threadIdx.x][w];
        if (v) atomicAdd(&sums[b * 3 + threadIdx.x], v);
    }
}

__global__ void fpl_pb_finish_kernel(const unsigned long long* __restrict__ sums, int n_planes,
                                     int* __restrict__ sizes) {
    const int b = threadIdx.x;
    if (b < n_planes) {
        const unsigned long long segs = sums[3 * b], lit = sums[3 * b + 1],
                                 stretch = sums[3 * b + 2];
        sizes[b] = (int)(2 * segs + lit + stretch + lit / 128);
    }
}

// ---------------------------------------------------------------------------
// F3
// ---------------------------------------------------------------------------

// chunk sums of plane b's bytes at positions >= lev - 1 (planes at a lower level: none)
__global__ void __launch_bounds__(NB) fpl_restore_level_sums_kernel(
        const uint8_t* __restrict__ work, long long pstride, long long n, long long n_chunks,
        int lev, Levels lv, unsigned* __restrict__ part) {
    __shared__ unsigned sm[2 * (WARPS + 1)];
    const int b = blockIdx.y;
    if (lv.v[b] < lev) return;
    const uint8_t* p = work + b * pstride;
    const long long i0 = (long long)blockIdx.x * SC_CHUNK + threadIdx.x * SC_ITEMS;
    unsigned s = 0;
    for (int j = 0; j < SC_ITEMS; ++j) {
        const long long i = i0 + j;
        if (i >= lev - 1 && i < n) s += p[i];
    }
    unsigned tot;
    block_excl<NB>(s, tot, sm);
    if (threadIdx.x == 0) part[b * n_chunks + blockIdx.x] = tot;
}

__global__ void __launch_bounds__(NB) fpl_restore_level_carry_kernel(
        unsigned* __restrict__ part, long long n_chunks, int lev, Levels lv) {
    __shared__ unsigned sm[2 * (WARPS + 1)];
    if (lv.v[blockIdx.x] < lev) return;
    block_scan_in_place<Sum>(part + blockIdx.x * n_chunks, n_chunks, 1, sm);
}

// out[i] = sum of x[lev - 1 .. i] mod 256 for i >= lev - 1 (restoreSequence's step)
__global__ void __launch_bounds__(NB) fpl_restore_level_apply_kernel(
        uint8_t* __restrict__ work, long long pstride, long long n, long long n_chunks, int lev,
        Levels lv, const unsigned* __restrict__ carry) {
    __shared__ unsigned sm[2 * (WARPS + 1)];
    const int b = blockIdx.y;
    if (lv.v[b] < lev) return;
    uint8_t* p = work + b * pstride;
    const long long i0 = (long long)blockIdx.x * SC_CHUNK + threadIdx.x * SC_ITEMS;
    unsigned x[SC_ITEMS], s = 0;
#pragma unroll
    for (int j = 0; j < SC_ITEMS; ++j) {
        const long long i = i0 + j;
        x[j] = i >= lev - 1 && i < n ? p[i] : 0u;
        s += x[j];
    }
    unsigned tot;
    unsigned acc = carry[b * n_chunks + blockIdx.x] + block_excl<NB>(s, tot, sm);
#pragma unroll
    for (int j = 0; j < SC_ITEMS; ++j) {
        const long long i = i0 + j;
        acc += x[j];
        if (i >= lev - 1 && i < n) p[i] = (uint8_t)acc;
    }
}

template <class P>
__global__ void fpl_restore_words_kernel(const uint8_t* __restrict__ work, long long pstride,
                                         long long n, typename P::W* __restrict__ words) {
    using W = typename P::W;
    for (long long i = (long long)blockIdx.x * NB + threadIdx.x; i < n;
         i += (long long)gridDim.x * NB) {
        W v = 0;
#pragma unroll
        for (int b = 0; b < P::PLANES; ++b) v |= (W)work[b * pstride + i] << (8 * b);
        words[i] = v;
    }
}

template <class P>
__global__ void fpl_restore_untransform_kernel(const typename P::W* __restrict__ words,
                                               long long n, typename P::W* __restrict__ out) {
    for (long long i = (long long)blockIdx.x * NB + threadIdx.x; i < n;
         i += (long long)gridDim.x * NB)
        out[i] = P::store(words[i]);
}

// predictor 2, down the columns: part[t * cols + c] = the split sum of column
// c over row tile t (COL_TILE rows; a warp per COL_ROWS-row strip, lanes on columns)
template <class P>
__global__ void __launch_bounds__(NB) fpl_restore_col_sums_kernel(
        const typename P::W* __restrict__ words, long long rows, int cols,
        typename P::W* __restrict__ part) {
    using W = typename P::W;
    __shared__ W sm[WARPS][32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long r0 = (long long)blockIdx.x * COL_TILE + warp * COL_ROWS;
    for (long long ct = blockIdx.y; ct * 32 < cols; ct += gridDim.y) {
        const long long c = ct * 32 + lane;
        W s = 0;
        if (c < cols)
            for (long long r = r0; r < r0 + COL_ROWS && r < rows; ++r)
                s = sadd<P>(s, words[r * cols + c]);
        sm[warp][lane] = s;
        __syncthreads();
        if (warp == 0 && c < cols) {
            W t = 0;
            for (int k = 0; k < WARPS; ++k) t = sadd<P>(t, sm[k][lane]);
            part[blockIdx.x * (long long)cols + c] = t;
        }
        __syncthreads();
    }
}

// one CTA per column: its row tiles' sums -> exclusive prefixes in place
template <class P>
__global__ void __launch_bounds__(NB) fpl_restore_col_carry_kernel(
        typename P::W* __restrict__ part, long long n_tiles, int cols) {
    __shared__ typename P::W sm[2 * (WARPS + 1)];
    for (long long c = blockIdx.x; c < cols; c += gridDim.x)
        block_scan_in_place<SplitAdd<P>>(part + c, n_tiles, cols, sm);
}

template <class P>
__global__ void __launch_bounds__(NB) fpl_restore_col_apply_kernel(
        typename P::W* __restrict__ words, long long rows, int cols,
        const typename P::W* __restrict__ carry) {
    using W = typename P::W;
    __shared__ W sm[WARPS][32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long r0 = (long long)blockIdx.x * COL_TILE + warp * COL_ROWS;
    for (long long ct = blockIdx.y; ct * 32 < cols; ct += gridDim.y) {
        const long long c = ct * 32 + lane;
        W s = 0;
        if (c < cols)
            for (long long r = r0; r < r0 + COL_ROWS && r < rows; ++r)
                s = sadd<P>(s, words[r * cols + c]);
        sm[warp][lane] = s;
        __syncthreads();
        if (c < cols) {
            W acc = carry[blockIdx.x * (long long)cols + c];
            for (int k = 0; k < warp; ++k) acc = sadd<P>(acc, sm[k][lane]);
            for (long long r = r0; r < r0 + COL_ROWS && r < rows; ++r) {
                acc = sadd<P>(acc, words[r * cols + c]);
                words[r * cols + c] = acc;
            }
        }
        __syncthreads();
    }
}

// predictors 1 and 2, along the rows: a flat scan of (row start, word) pairs
template <class P>
__device__ __forceinline__ SegT<typename P::W> thread_row_seg(
        const typename P::W* __restrict__ words, long long i0, long long n, int cols) {
    using S = SegT<typename P::W>;
    S s = {0u, 0};
    long long c = i0 % cols;
    for (int j = 0; j < SC_ITEMS && i0 + j < n; ++j) {
        s = seg_combine<SplitAdd<P>>(s, S{c == 0, words[i0 + j]});
        if (++c == cols) c = 0;
    }
    return s;
}

// part[2k], part[2k + 1]: chunk k's (flag, value)
template <class P>
__global__ void __launch_bounds__(NB) fpl_restore_row_sums_kernel(
        const typename P::W* __restrict__ words, long long n, int cols,
        typename P::W* __restrict__ part) {
    __shared__ typename P::W sm[2 * (WARPS + 1)];
    const long long i0 = (long long)blockIdx.x * SC_CHUNK + threadIdx.x * SC_ITEMS;
    SegT<typename P::W> tot;
    block_seg_excl<NB, SplitAdd<P>>(thread_row_seg<P>(words, i0, n, cols), tot, sm);
    if (threadIdx.x == 0) {
        part[2 * (long long)blockIdx.x] = tot.f;
        part[2 * (long long)blockIdx.x + 1] = tot.v;
    }
}

// one CTA: the chunks' pairs -> exclusive prefixes in place
template <class P>
__global__ void __launch_bounds__(NB) fpl_restore_row_carry_kernel(
        typename P::W* __restrict__ part, long long n_chunks) {
    using W = typename P::W;
    using S = SegT<W>;
    __shared__ W sm[2 * (WARPS + 1)];
    S carry = {0u, 0};
    for (long long k0 = 0; k0 < n_chunks; k0 += NB) {
        const long long k = k0 + threadIdx.x;
        const S v = k < n_chunks ? S{(unsigned)part[2 * k], part[2 * k + 1]} : S{0u, 0};
        S tot;
        const S ex = seg_combine<SplitAdd<P>>(carry, block_seg_excl<NB, SplitAdd<P>>(v, tot, sm));
        if (k < n_chunks) {
            part[2 * k] = ex.f;
            part[2 * k + 1] = ex.v;
        }
        carry = seg_combine<SplitAdd<P>>(carry, tot);
    }
}

template <class P>
__global__ void __launch_bounds__(NB) fpl_restore_row_apply_kernel(
        const typename P::W* __restrict__ words, long long n, int cols,
        const typename P::W* __restrict__ carry, typename P::W* __restrict__ out) {
    using W = typename P::W;
    using S = SegT<W>;
    __shared__ W sm[2 * (WARPS + 1)];
    const long long i0 = (long long)blockIdx.x * SC_CHUNK + threadIdx.x * SC_ITEMS;
    S tot;
    const S ex = block_seg_excl<NB, SplitAdd<P>>(thread_row_seg<P>(words, i0, n, cols), tot, sm);
    const long long k = blockIdx.x;
    S acc = seg_combine<SplitAdd<P>>(S{(unsigned)carry[2 * k], carry[2 * k + 1]}, ex);
    long long c = i0 % cols;
    for (int j = 0; j < SC_ITEMS && i0 + j < n; ++j) {
        acc = seg_combine<SplitAdd<P>>(acc, S{c == 0, words[i0 + j]});
        out[i0 + j] = P::store(acc.v);
        if (++c == cols) c = 0;
    }
}

long long chunks(long long n, int per) { return (n + per - 1) / per; }

Levels levels_of(const int* lv, int n_planes) {
    Levels out = {};
    for (int b = 0; b < n_planes; ++b) out.v[b] = lv[b];
    return out;
}

template <class P>
int launch_sample_histograms(const typename P::W* data, long long rows, int cols, int stride,
                             long long m, int* hist, cudaStream_t st) {
    if (rows * cols == 0) return 0;
    const long long n_cnt = (m + PRIME_MULT - 1) / PRIME_MULT;
    fpl_sample_histograms_kernel<P><<<dim3(grid_of(n_cnt, NB), 3 * (P::PLANES / 4)), NB, 0, st>>>(
        data, cols, stride, m, hist);
    return (int)cudaGetLastError();
}

template <class P>
int launch_finalize(const typename P::W* data, long long n, int cols, int pred, const Levels& lv,
                    uint8_t* planes, long long pstride, int* histos, cudaStream_t st) {
    if (n == 0) return 0;
    fpl_finalize_kernel<P><<<grid_of(n, FIN_TILE), NB, 0, st>>>(data, n, cols, pred, lv, planes,
                                                                  pstride, histos);
    return (int)cudaGetLastError();
}

// u32 words (float32) or u64 words (float64) of scratch the restore needs
long long restore_scratch(long long n, long long rows, int cols, int n_planes) {
    const long long nc = chunks(n, SC_CHUNK);
    long long s = n_planes * nc;  // the level undo's chunk sums (u32, in fewer words)
    if (2 * nc > s) s = 2 * nc;
    if (chunks(rows, COL_TILE) * cols > s) s = chunks(rows, COL_TILE) * cols;
    return s < 1 ? 1 : s;
}

template <class P>
int launch_restore(uint8_t* work, long long pstride, long long n, long long rows, int cols,
                   int pred, const Levels& lv, typename P::W* part, typename P::W* words,
                   typename P::W* out, cudaStream_t st) {
    if (n == 0) return 0;
    int top = 0;
    for (int b = 0; b < P::PLANES; ++b) top = lv.v[b] > top ? lv.v[b] : top;
    const long long nc = chunks(n, SC_CHUNK);
    unsigned* lpart = reinterpret_cast<unsigned*>(part);
    for (int lev = top; lev >= 1; --lev) {
        fpl_restore_level_sums_kernel<<<dim3((unsigned)nc, P::PLANES), NB, 0, st>>>(
            work, pstride, n, nc, lev, lv, lpart);
        fpl_restore_level_carry_kernel<<<P::PLANES, NB, 0, st>>>(lpart, nc, lev, lv);
        fpl_restore_level_apply_kernel<<<dim3((unsigned)nc, P::PLANES), NB, 0, st>>>(
            work, pstride, n, nc, lev, lv, lpart);
    }
    fpl_restore_words_kernel<P><<<grid_of(n, NB * 8), NB, 0, st>>>(work, pstride, n, words);
    if (pred == 2) {
        const long long nt = chunks(rows, COL_TILE);
        const long long ct = chunks(cols, 32);
        const dim3 grid((unsigned)nt, (unsigned)(ct < 65535 ? ct : 65535));
        fpl_restore_col_sums_kernel<P><<<grid, NB, 0, st>>>(words, rows, cols, part);
        fpl_restore_col_carry_kernel<P>
            <<<(unsigned)(cols < MAX_GRID ? cols : MAX_GRID), NB, 0, st>>>(part, nt, cols);
        fpl_restore_col_apply_kernel<P><<<grid, NB, 0, st>>>(words, rows, cols, part);
    }
    if (pred >= 1) {
        fpl_restore_row_sums_kernel<P><<<(unsigned)nc, NB, 0, st>>>(words, n, cols, part);
        fpl_restore_row_carry_kernel<P><<<1, NB, 0, st>>>(part, nc);
        fpl_restore_row_apply_kernel<P><<<(unsigned)nc, NB, 0, st>>>(words, n, cols, part, out);
    } else {
        fpl_restore_untransform_kernel<P><<<grid_of(n, NB * 8), NB, 0, st>>>(words, n, out);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// data [rows * cols] float32 bits; hist int32 [3, 4, 6, 256], zeroed
extern "C" int fpl_sample_histograms(const unsigned* data, long long rows, int cols, int stride,
                                     long long m, int* hist, void* stream) {
    return launch_sample_histograms<Word32>(data, rows, cols, stride, m, hist,
                                            (cudaStream_t)stream);
}

// data [rows * cols] float64 bits; hist int32 [3, 8, 6, 256], zeroed
extern "C" int fpl_sample_histograms_f64(const unsigned long long* data, long long rows, int cols,
                                         int stride, long long m, int* hist, void* stream) {
    return launch_sample_histograms<Word64>(data, rows, cols, stride, m, hist,
                                            (cudaStream_t)stream);
}

// levels [4] on the host; planes u8 [4, pstride], zeroed; histos int32 [4, 256], zeroed
extern "C" int fpl_finalize(const unsigned* data, long long n, int cols, int pred,
                            const int* levels, uint8_t* planes, long long pstride, int* histos,
                            void* stream) {
    return launch_finalize<Word32>(data, n, cols, pred, levels_of(levels, 4), planes, pstride,
                                   histos, (cudaStream_t)stream);
}

// float64: levels [8] on the host; planes u8 [8, pstride], zeroed; histos
// int32 [8, 256], zeroed
extern "C" int fpl_finalize_f64(const unsigned long long* data, long long n, int cols, int pred,
                                const int* levels, uint8_t* planes, long long pstride,
                                int* histos, void* stream) {
    return launch_finalize<Word64>(data, n, cols, pred, levels_of(levels, 8), planes, pstride,
                                   histos, (cudaStream_t)stream);
}

extern "C" long long fpl_packbits_chunks(long long n) { return chunks(n, PB_CHUNK); }

// planes u8 [n_planes, pstride] (4 or 8); counts int32 [n_planes,
// fpl_packbits_chunks(n)]; starts int32 [n_planes, n + 1]; n_runs int32
// [n_planes]; sums u64 [n_planes, 3], zeroed; sizes int32 [n_planes]
extern "C" int fpl_packbits_size(const uint8_t* planes, int n_planes, long long pstride,
                                 long long n, int* counts, int* starts, int* n_runs,
                                 unsigned long long* sums, int* sizes, void* stream) {
    if (n == 0) return 0;
    if (n_planes < 1 || n_planes > MAX_PLANES) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const long long nc = chunks(n, PB_CHUNK);
    fpl_pb_count_kernel<<<dim3((unsigned)nc, n_planes), NB, 0, st>>>(planes, pstride, n, nc,
                                                                      counts);
    fpl_pb_scan_kernel<<<n_planes, NB, 0, st>>>(counts, nc, n, starts, n + 1, n_runs);
    fpl_pb_scatter_kernel<<<dim3((unsigned)nc, n_planes), NB, 0, st>>>(planes, pstride, n, nc,
                                                                        counts, starts, n + 1);
    fpl_pb_sum_kernel<<<dim3(grid_of(n, NB), n_planes), NB, 0, st>>>(starts, n + 1, n_runs,
                                                                      sums);
    fpl_pb_finish_kernel<<<1, 32, 0, st>>>(sums, n_planes, sizes);
    return (int)cudaGetLastError();
}

// words of scratch fpl_restore (u32) and fpl_restore_f64 (u64) need
extern "C" long long fpl_restore_scratch(long long n, long long rows, int cols, int n_planes) {
    return restore_scratch(n, rows, cols, n_planes);
}

// work u8 [4, pstride]: the planes, overwritten by the level undo; levels [4]
// on the host; part: fpl_restore_scratch(n, rows, cols, 4) u32; words u32 [n];
// out float32 bits [n]
extern "C" int fpl_restore(uint8_t* work, long long pstride, long long n, long long rows, int cols,
                           int pred, const int* levels, unsigned* part, unsigned* words,
                           unsigned* out, void* stream) {
    return launch_restore<Word32>(work, pstride, n, rows, cols, pred, levels_of(levels, 4), part,
                                  words, out, (cudaStream_t)stream);
}

// float64: work u8 [8, pstride]; levels [8] on the host; part:
// fpl_restore_scratch(n, rows, cols, 8) u64; words u64 [n]; out float64 bits [n]
extern "C" int fpl_restore_f64(uint8_t* work, long long pstride, long long n, long long rows,
                               int cols, int pred, const int* levels, unsigned long long* part,
                               unsigned long long* words, unsigned long long* out, void* stream) {
    return launch_restore<Word64>(work, pstride, n, rows, cols, pred, levels_of(levels, 8), part,
                                  words, out, (cudaStream_t)stream);
}
