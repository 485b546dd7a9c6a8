// F1-F3: lossless float32 (fpl, Lerc2 v6 "delta-delta Huffman",
// fpl_Lerc2Ext.cpp:405-866).
//
// Replaces the float32 half of lerc_tpu/ops/device_fpl.py. The TPU version
// builds each byte level as a whole shifted array, counts bins with nibble
// matmuls, derives run lengths from cummax/cummin scans and splits each
// prefix sum into 6-bit int32 limbs (exact only up to 2^25 elements); here a
// byte level is one binomial sum per position, histograms are shared-memory
// atomics, runs are compacted by per-chunk ranks, and the prefix sums are
// chunked block scans in native u32, where the split-field add is
// associative.
//
//   F1 fpl_sample_histograms   fpl_choose_device :123 (float_transform_dev :43,
//                              apply_predictor_dev :58, _byte_deriv1 :70,
//                              histogram256): one thread per counted position q
//                              (every 7th of the flattened sample of every
//                              stride-th row) and per predictor (grid y): the
//                              predicted words at q-5..q, then for each plane and
//                              level k the byte Delta^min(q,k) x[q], counted in
//                              shared bins (24 KB a CTA), one global add per bin.
//   F2 fpl_finalize            fpl_finalize_device :168: a CTA stages the
//                              predicted words of 1024 positions and the 5 before
//                              them in shared memory; each position writes its
//                              four plane bytes at their levels and counts them.
//   F2b fpl_packbits_size      packbits_size_device :88: per plane, run starts
//                              counted per 2048-byte chunk, the counts scanned
//                              by one CTA, the starts scattered at their ranks;
//                              each run then reads its start, its successor's and
//                              its predecessor's, and adds its repeat segments,
//                              literal and literal-stretch opening to three
//                              sums; one thread per plane applies JAX's formula.
//   F3 fpl_restore             fpl_restore_device :235 (_cumsum_mod_dev :202,
//                              split_cumsum_dev :218, undo_float_transform_dev
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
// once (its neighbours from cache) and writes four bytes; F2b and F3 read and
// write each plane byte a few times. The scans' carry passes are serial over
// chunk counts (n / 4096 per plane, rows / 256 per column), not over values.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"  // Seg, Sum, block_excl, block_seg_excl

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned MANT = 0x7FFFFFu;
constexpr int MAX_DELTA = 5;
constexpr int PRIME_MULT = 7;
constexpr int NB = 256;                   // threads per CTA
constexpr int WARPS = NB / 32;
constexpr int MAX_GRID = 1056;            // 8 CTAs on each of 132 SMs (grid-stride beyond)
constexpr int HIST = 4 * (MAX_DELTA + 1) * 256;
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
    int v[4];
};

unsigned grid_of(long long n, int per) {
    const long long g = (n + per - 1) / per;
    return (unsigned)(g < 1 ? 1 : g < MAX_GRID ? g : MAX_GRID);
}

__device__ __forceinline__ unsigned ftransform(unsigned u) {
    return (u & MANT) | (((u >> 23) & 0xFFu) << 24) | ((u >> 31) << 23);
}

__device__ __forceinline__ unsigned untransform(unsigned u) {
    return (u & MANT) | (((u >> 24) & 0xFFu) << 23) | (((u >> 23) & 1u) << 31);
}

// split-field arithmetic: mantissa mod 2^23 and exponent+sign mod 2^9 apart
__device__ __forceinline__ unsigned ssub(unsigned a, unsigned b) {
    return ((a - b) & MANT) | ((((a >> 23) - (b >> 23)) & 0x1FFu) << 23);
}

__device__ __forceinline__ unsigned sadd(unsigned a, unsigned b) {
    return ((a + b) & MANT) | ((((a >> 23) + (b >> 23)) & 0x1FFu) << 23);
}

// the predicted word at (row r, column c) of the [rows, cols] word image;
// rup is the row predictor 2 subtracts (-1: none)
__device__ __forceinline__ unsigned predicted(const unsigned* __restrict__ data, int cols,
                                              long long r, long long rup, int c, int pred) {
    const long long i = r * cols + c;
    const unsigned x = ftransform(data[i]);
    if (pred == 0) return x;
    const unsigned d1 = c > 0 ? ssub(x, ftransform(data[i - 1])) : x;
    if (pred == 1 || rup < 0) return d1;
    const long long j = rup * cols + c;
    const unsigned u = ftransform(data[j]);
    return ssub(d1, c > 0 ? ssub(u, ftransform(data[j - 1])) : u);
}

// byte b of level k from the words w[0] = x[q], w[j] = x[q - j] (j <= kk)
__device__ __forceinline__ unsigned level_byte(const unsigned* w, int b, int kk) {
    unsigned v = 0;
#pragma unroll
    for (int j = 0; j <= MAX_DELTA; ++j)
        if (j <= kk) v += COEF[kk][j] * ((w[j] >> (8 * b)) & 0xFFu);
    return v & 0xFFu;
}

// ---------------------------------------------------------------------------
// block scans (block_scan.cuh) under the split-field add
// ---------------------------------------------------------------------------

struct SplitAdd {
    __device__ static unsigned f(unsigned a, unsigned b) { return sadd(a, b); }
};

// in place: x[k * step] (k < count) becomes the exclusive prefix of the
// sequence under Op; one CTA walks it in tiles of NB; sm holds 2 * (WARPS + 1) words
template <class Op>
__device__ void block_scan_in_place(unsigned* x, long long count, long long step, unsigned* sm) {
    unsigned carry = 0;
    for (long long k0 = 0; k0 < count; k0 += NB) {
        const long long k = k0 + threadIdx.x;
        const unsigned v = k < count ? x[k * step] : 0u;
        unsigned tot;
        const unsigned ex = block_excl<NB, Op>(v, tot, sm);
        if (k < count) x[k * step] = Op::f(carry, ex);
        carry = Op::f(carry, tot);
    }
}

// ---------------------------------------------------------------------------
// F1
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NB) fpl_sample_histograms_kernel(
        const unsigned* __restrict__ data, int cols, int stride, long long m,
        int* __restrict__ hist) {
    __shared__ unsigned bins[HIST];
    const int pred = blockIdx.y;
    for (int i = threadIdx.x; i < HIST; i += NB) bins[i] = 0;
    __syncthreads();
    const long long n_cnt = (m + PRIME_MULT - 1) / PRIME_MULT;
    for (long long t = (long long)blockIdx.x * NB + threadIdx.x; t < n_cnt;
         t += (long long)gridDim.x * NB) {
        const long long q = t * PRIME_MULT;
        const int kmax = q < MAX_DELTA ? (int)q : MAX_DELTA;
        unsigned w[MAX_DELTA + 1];
#pragma unroll
        for (int j = 0; j <= MAX_DELTA; ++j) {
            w[j] = 0;
            if (j <= kmax) {
                const long long s = q - j, sr = s / cols;
                w[j] = predicted(data, cols, sr * stride, sr > 0 ? (sr - 1) * stride : -1,
                                 (int)(s - sr * cols), pred);
            }
        }
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
            for (int k = 0; k <= MAX_DELTA; ++k)
                atomicAdd(&bins[(b * (MAX_DELTA + 1) + k) * 256
                                + level_byte(w, b, k < kmax ? k : kmax)], 1u);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < HIST; i += NB)
        if (bins[i]) atomicAdd(&hist[pred * HIST + i], (int)bins[i]);
}

// ---------------------------------------------------------------------------
// F2
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NB) fpl_finalize_kernel(
        const unsigned* __restrict__ data, long long n, int cols, int pred, Levels lv,
        uint8_t* __restrict__ planes, long long pstride, int* __restrict__ histos) {
    __shared__ unsigned pw[FIN_TILE + MAX_DELTA];
    __shared__ unsigned bins[4 * 256];
    for (int i = threadIdx.x; i < 4 * 256; i += NB) bins[i] = 0;
    for (long long base = (long long)blockIdx.x * FIN_TILE; base < n;
         base += (long long)gridDim.x * FIN_TILE) {
        __syncthreads();  // the last tile's words are read
        for (int k = threadIdx.x; k < FIN_TILE + MAX_DELTA; k += NB) {
            const long long i = base - MAX_DELTA + k;
            if (i >= 0 && i < n) {
                const long long r = i / cols;
                pw[k] = predicted(data, cols, r, r - 1, (int)(i - r * cols), pred);
            }
        }
        __syncthreads();
        for (int it = 0; it < FIN_ITEMS; ++it) {
            const int k = it * NB + threadIdx.x;
            const long long i = base + k;
            if (i >= n) break;
            unsigned w[MAX_DELTA + 1];
#pragma unroll
            for (int j = 0; j <= MAX_DELTA; ++j) w[j] = j <= i ? pw[k + MAX_DELTA - j] : 0u;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                const int kk = (long long)lv.v[b] < i ? lv.v[b] : (int)i;
                const unsigned v = level_byte(w, b, kk);
                planes[b * pstride + i] = (uint8_t)v;
                atomicAdd(&bins[b * 256 + v], 1u);
            }
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 4 * 256; i += NB)
        if (bins[i]) atomicAdd(&histos[i], (int)bins[i]);
}

// ---------------------------------------------------------------------------
// F2b
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

__global__ void fpl_pb_finish_kernel(const unsigned long long* __restrict__ sums,
                                     int* __restrict__ sizes) {
    const int b = threadIdx.x;
    if (b < 4) {
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

__global__ void fpl_restore_words_kernel(const uint8_t* __restrict__ work, long long pstride,
                                         long long n, unsigned* __restrict__ words) {
    for (long long i = (long long)blockIdx.x * NB + threadIdx.x; i < n;
         i += (long long)gridDim.x * NB)
        words[i] = (unsigned)work[i] | (unsigned)work[pstride + i] << 8
                 | (unsigned)work[2 * pstride + i] << 16 | (unsigned)work[3 * pstride + i] << 24;
}

__global__ void fpl_restore_untransform_kernel(const unsigned* __restrict__ words, long long n,
                                               unsigned* __restrict__ out) {
    for (long long i = (long long)blockIdx.x * NB + threadIdx.x; i < n;
         i += (long long)gridDim.x * NB)
        out[i] = untransform(words[i]);
}

// predictor 2, down the columns: part[t * cols + c] = the split sum of column
// c over row tile t (COL_TILE rows; a warp per COL_ROWS-row strip, lanes on columns)
__global__ void __launch_bounds__(NB) fpl_restore_col_sums_kernel(
        const unsigned* __restrict__ words, long long rows, int cols, unsigned* __restrict__ part) {
    __shared__ unsigned sm[WARPS][32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long r0 = (long long)blockIdx.x * COL_TILE + warp * COL_ROWS;
    for (long long ct = blockIdx.y; ct * 32 < cols; ct += gridDim.y) {
        const long long c = ct * 32 + lane;
        unsigned s = 0;
        if (c < cols)
            for (long long r = r0; r < r0 + COL_ROWS && r < rows; ++r)
                s = sadd(s, words[r * cols + c]);
        sm[warp][lane] = s;
        __syncthreads();
        if (warp == 0 && c < cols) {
            unsigned t = 0;
            for (int k = 0; k < WARPS; ++k) t = sadd(t, sm[k][lane]);
            part[blockIdx.x * (long long)cols + c] = t;
        }
        __syncthreads();
    }
}

// one CTA per column: its row tiles' sums -> exclusive prefixes in place
__global__ void __launch_bounds__(NB) fpl_restore_col_carry_kernel(
        unsigned* __restrict__ part, long long n_tiles, int cols) {
    __shared__ unsigned sm[2 * (WARPS + 1)];
    for (long long c = blockIdx.x; c < cols; c += gridDim.x)
        block_scan_in_place<SplitAdd>(part + c, n_tiles, cols, sm);
}

__global__ void __launch_bounds__(NB) fpl_restore_col_apply_kernel(
        unsigned* __restrict__ words, long long rows, int cols,
        const unsigned* __restrict__ carry) {
    __shared__ unsigned sm[WARPS][32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long r0 = (long long)blockIdx.x * COL_TILE + warp * COL_ROWS;
    for (long long ct = blockIdx.y; ct * 32 < cols; ct += gridDim.y) {
        const long long c = ct * 32 + lane;
        unsigned s = 0;
        if (c < cols)
            for (long long r = r0; r < r0 + COL_ROWS && r < rows; ++r)
                s = sadd(s, words[r * cols + c]);
        sm[warp][lane] = s;
        __syncthreads();
        if (c < cols) {
            unsigned acc = carry[blockIdx.x * (long long)cols + c];
            for (int k = 0; k < warp; ++k) acc = sadd(acc, sm[k][lane]);
            for (long long r = r0; r < r0 + COL_ROWS && r < rows; ++r) {
                acc = sadd(acc, words[r * cols + c]);
                words[r * cols + c] = acc;
            }
        }
        __syncthreads();
    }
}

// predictors 1 and 2, along the rows: a flat scan of (row start, word) pairs
__device__ __forceinline__ Seg thread_row_seg(const unsigned* __restrict__ words, long long i0,
                                              long long n, int cols) {
    Seg s = {0, 0};
    long long c = i0 % cols;
    for (int j = 0; j < SC_ITEMS && i0 + j < n; ++j) {
        s = seg_combine<SplitAdd>(s, {c == 0, words[i0 + j]});
        if (++c == cols) c = 0;
    }
    return s;
}

__global__ void __launch_bounds__(NB) fpl_restore_row_sums_kernel(
        const unsigned* __restrict__ words, long long n, int cols, unsigned* __restrict__ part) {
    __shared__ unsigned sm[2 * (WARPS + 1)];
    const long long i0 = (long long)blockIdx.x * SC_CHUNK + threadIdx.x * SC_ITEMS;
    Seg tot;
    block_seg_excl<NB, SplitAdd>(thread_row_seg(words, i0, n, cols), tot, sm);
    if (threadIdx.x == 0) {
        part[2 * (long long)blockIdx.x] = tot.f;
        part[2 * (long long)blockIdx.x + 1] = tot.v;
    }
}

// one CTA: the chunks' pairs -> exclusive prefixes in place
__global__ void __launch_bounds__(NB) fpl_restore_row_carry_kernel(unsigned* __restrict__ part,
                                                                  long long n_chunks) {
    __shared__ unsigned sm[2 * (WARPS + 1)];
    Seg carry = {0, 0};
    for (long long k0 = 0; k0 < n_chunks; k0 += NB) {
        const long long k = k0 + threadIdx.x;
        const Seg v = k < n_chunks ? Seg{part[2 * k], part[2 * k + 1]} : Seg{0, 0};
        Seg tot;
        const Seg ex = seg_combine<SplitAdd>(carry, block_seg_excl<NB, SplitAdd>(v, tot, sm));
        if (k < n_chunks) {
            part[2 * k] = ex.f;
            part[2 * k + 1] = ex.v;
        }
        carry = seg_combine<SplitAdd>(carry, tot);
    }
}

__global__ void __launch_bounds__(NB) fpl_restore_row_apply_kernel(
        const unsigned* __restrict__ words, long long n, int cols,
        const unsigned* __restrict__ carry,
        unsigned* __restrict__ out) {
    __shared__ unsigned sm[2 * (WARPS + 1)];
    const long long i0 = (long long)blockIdx.x * SC_CHUNK + threadIdx.x * SC_ITEMS;
    Seg tot;
    const Seg ex = block_seg_excl<NB, SplitAdd>(thread_row_seg(words, i0, n, cols), tot, sm);
    const long long k = blockIdx.x;
    Seg acc = seg_combine<SplitAdd>({carry[2 * k], carry[2 * k + 1]}, ex);
    long long c = i0 % cols;
    for (int j = 0; j < SC_ITEMS && i0 + j < n; ++j) {
        acc = seg_combine<SplitAdd>(acc, {c == 0, words[i0 + j]});
        out[i0 + j] = untransform(acc.v);
        if (++c == cols) c = 0;
    }
}

long long chunks(long long n, int per) { return (n + per - 1) / per; }

}  // namespace

// data [rows * cols] float32 bits; hist int32 [3, 4, 6, 256], zeroed
extern "C" int fpl_sample_histograms(const unsigned* data, long long rows, int cols, int stride,
                                     long long m, int* hist, void* stream) {
    if (rows * cols == 0) return 0;
    const long long n_cnt = (m + PRIME_MULT - 1) / PRIME_MULT;
    fpl_sample_histograms_kernel<<<dim3(grid_of(n_cnt, NB), 3), NB, 0, (cudaStream_t)stream>>>(
        data, cols, stride, m, hist);
    return (int)cudaGetLastError();
}

// planes u8 [4, pstride], zeroed; histos int32 [4, 256], zeroed
extern "C" int fpl_finalize(const unsigned* data, long long n, int cols, int pred, int lv0, int lv1,
                            int lv2, int lv3, uint8_t* planes, long long pstride, int* histos,
                            void* stream) {
    if (n == 0) return 0;
    const Levels lv = {{lv0, lv1, lv2, lv3}};
    fpl_finalize_kernel<<<grid_of(n, FIN_TILE), NB, 0, (cudaStream_t)stream>>>(
        data, n, cols, pred, lv, planes, pstride, histos);
    return (int)cudaGetLastError();
}

extern "C" long long fpl_packbits_chunks(long long n) { return chunks(n, PB_CHUNK); }

// counts int32 [4, fpl_packbits_chunks(n)]; starts int32 [4, n + 1]; n_runs
// int32 [4]; sums u64 [4, 3], zeroed; sizes int32 [4]
extern "C" int fpl_packbits_size(const uint8_t* planes, long long pstride, long long n, int* counts,
                                 int* starts, int* n_runs, unsigned long long* sums, int* sizes,
                                 void* stream) {
    if (n == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    const long long nc = chunks(n, PB_CHUNK);
    fpl_pb_count_kernel<<<dim3((unsigned)nc, 4), NB, 0, st>>>(planes, pstride, n, nc, counts);
    fpl_pb_scan_kernel<<<4, NB, 0, st>>>(counts, nc, n, starts, n + 1, n_runs);
    fpl_pb_scatter_kernel<<<dim3((unsigned)nc, 4), NB, 0, st>>>(planes, pstride, n, nc, counts,
                                                                 starts, n + 1);
    fpl_pb_sum_kernel<<<dim3(grid_of(n, NB), 4), NB, 0, st>>>(starts, n + 1, n_runs, sums);
    fpl_pb_finish_kernel<<<1, 32, 0, st>>>(sums, sizes);
    return (int)cudaGetLastError();
}

// u32 words of scratch fpl_restore needs
extern "C" long long fpl_restore_scratch(long long n, long long rows, int cols) {
    const long long nc = chunks(n, SC_CHUNK);
    long long s = 4 * nc;
    if (chunks(rows, COL_TILE) * cols > s) s = chunks(rows, COL_TILE) * cols;
    return s < 1 ? 1 : s;
}

// work u8 [4, pstride]: the planes, overwritten by the level undo; part:
// fpl_restore_scratch(n, rows, cols) u32; words u32 [n]; out float32 bits [n]
extern "C" int fpl_restore(uint8_t* work, long long pstride, long long n, long long rows, int cols,
                           int pred, int lv0, int lv1, int lv2, int lv3, unsigned* part,
                           unsigned* words, unsigned* out, void* stream) {
    if (n == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    const Levels lv = {{lv0, lv1, lv2, lv3}};
    int top = 0;
    for (int b = 0; b < 4; ++b) top = lv.v[b] > top ? lv.v[b] : top;
    const long long nc = chunks(n, SC_CHUNK);
    for (int lev = top; lev >= 1; --lev) {
        fpl_restore_level_sums_kernel<<<dim3((unsigned)nc, 4), NB, 0, st>>>(work, pstride, n, nc,
                                                                           lev, lv, part);
        fpl_restore_level_carry_kernel<<<4, NB, 0, st>>>(part, nc, lev, lv);
        fpl_restore_level_apply_kernel<<<dim3((unsigned)nc, 4), NB, 0, st>>>(work, pstride, n, nc,
                                                                            lev, lv, part);
    }
    fpl_restore_words_kernel<<<grid_of(n, NB * 8), NB, 0, st>>>(work, pstride, n, words);
    if (pred == 2) {
        const long long nt = chunks(rows, COL_TILE);
        const long long ct = chunks(cols, 32);
        const dim3 grid((unsigned)nt, (unsigned)(ct < 65535 ? ct : 65535));
        fpl_restore_col_sums_kernel<<<grid, NB, 0, st>>>(words, rows, cols, part);
        fpl_restore_col_carry_kernel<<<(unsigned)(cols < MAX_GRID ? cols : MAX_GRID), NB, 0, st>>>(
            part, nt, cols);
        fpl_restore_col_apply_kernel<<<grid, NB, 0, st>>>(words, rows, cols, part);
    }
    if (pred >= 1) {
        fpl_restore_row_sums_kernel<<<(unsigned)nc, NB, 0, st>>>(words, n, cols, part);
        fpl_restore_row_carry_kernel<<<1, NB, 0, st>>>(part, nc);
        fpl_restore_row_apply_kernel<<<(unsigned)nc, NB, 0, st>>>(words, n, cols, part, out);
    } else {
        fpl_restore_untransform_kernel<<<grid_of(n, NB * 8), NB, 0, st>>>(words, n, out);
    }
    return (int)cudaGetLastError();
}
