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
//   F2 fpl_finalize            fpl_finalize_device :168 / _f64 :344: a thread 16
//                              positions, their words in 16-byte loads, the byte
//                              levels as whole-word byte differences, each
//                              plane's 16 bytes one store, the zero tail written,
//                              counts merged over runs of equal bytes (below).
//                              One byte a position and a shared atomic a byte
//                              over a staged tile ran at 31% of the float64
//                              bound (0.0638 ms on a 2048^2 tile, H100 SXM).
//   F2b fpl_packbits_size      packbits_size_device :88, over 4 or 8 planes. Bound:
//                              bytes, the planes read once (4n or 8n: 0.0050 and
//                              0.0100 ms for a 2048^2 tile at 3.35 TB/s, H100 SXM).
//                              Five launches a call took 0.12 / 0.39 ms: per-chunk
//                              counts, a one-CTA scan a plane, every run start
//                              scattered into an int32 array of n + 1 entries a
//                              plane, a sum that read it three times, a one-CTA
//                              finish. Now a memset (the tickets) and one kernel,
//                              one CTA per 16 KB tile of a plane: the tile read
//                              once by 16-byte loads, its run starts a 64-bit mask
//                              a thread, the runs inside those 64 bytes counted
//                              by popcounts (each shorter than 129), the two at
//                              its ends by arithmetic; the tile exports its first
//                              and last start, its sums and two flags; the
//                              plane's last tile to finish (an
//                              atomic ticket) joins the summaries with two max
//                              scans (the run that opens at a tile's last start
//                              ends at the next tile's first; whether the run
//                              before it left a literal rides the second scan)
//                              and applies JAX's formula. No array of n entries.
//   F3 fpl_restore             fpl_restore_device :235 / _f64 :407 (_cumsum_mod_dev
//                              :202, split_cumsum_dev :218 / split_cumsum64_dev
//                              :398, _cumsum_mod52_pair :366, undo_float_transform_dev
//                              :227). Bound: bytes, the planes read once and the
//                              words written once (8n float32, 16n float64: 0.0100
//                              and 0.0200 ms for a 2048^2 tile at 3.35 TB/s, H100
//                              SXM). Three kernels a level over the planes in place
//                              (after a clone), one-CTA carries, the words, then the
//                              row scan's three took 0.16 / 0.40 ms. Now one pass,
//                              a CTA per 4,096 positions in ticket order: each
//                              plane's 16 bytes a thread by one 16-byte load,
//                              transposed into one word a position (plane b in
//                              byte b); the level undo (restoreSequence) bytewise
//                              on the words, each level one block scan over the
//                              planes at or above it; the tile's carries of every
//                              level from a decoupled look-back, 32 tiles a step:
//                              a tile's effect on the carries is affine mod 256
//                              with binomial coefficients (advance), so each lane
//                              advances one tile's carries by its distance and the
//                              warp sums them; predictors 1 and 2: the split-field
//                              row scan, its carry from a second look-back where a
//                              tile starts inside a row; the float32 transform
//                              undone; the words staged in shared memory and
//                              stored 512 contiguous bytes a warp store. The
//                              planes are only read (no clone). Predictor 2: a
//                              column pass over the row-scanned words (tile sums,
//                              a scan per column, apply), the two scans commuting.
//
// Bounds: bytes. F1 reads a sample of about 2^19 words; F2 reads each word
// once (its neighbours from cache) and writes one byte a plane; F2b and F3
// read each plane byte once. F3's column carries are serial over chunk
// counts (rows / 256 per column), not over values.

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
constexpr int FIN_NT = 128, FIN_RUN = 16, FIN_TILE = FIN_NT * FIN_RUN;  // F2: positions a tile
constexpr int PB_BYTES = 64, PB_TILE = NB * PB_BYTES;  // F2b: 16 KB a tile
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
    __device__ static W tf(W u) {
        return (u & MANT) | (((u >> 23) & 0xFFu) << 24) | ((u >> 31) << 23);
    }
    __device__ static W load(const W* data, long long i) { return tf(data[i]); }
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
    __device__ static W tf(W u) { return u; }
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

// A CTA of FIN_NT threads owns tiles of FIN_TILE positions (grid-stride,
// as many CTAs as the card holds at once), a thread FIN_RUN = 16
// consecutive positions p .. p + 15. The thread loads its words p - 8 ..
// p + 15 and, under predictor 2, the row above them in 16-byte chunks
// (load16: any alignment; the neighbours' overlap comes from the L1; words
// outside [0, n) are 0) and predicts the 21 positions p - 5 .. p + 15, its
// row and column one division from p. The byte levels are then whole-word
// byte differences (every plane at once, level k from level k - 1 where
// the position is >= k), and each plane's bytes are taken from the level
// it was given. A 4 x 4 byte transpose turns the 16 positions' words into
// each plane's 16 bytes, which leave as one aligned 16-byte store;
// positions from n to the planes' padded length are written 0 (the
// wrapper does not clear them). No shared memory but the bins, and no
// barrier inside the tile loop: warps overlap one another's loads. The
// histograms: a plane whose 16 bytes are one value in every lane of a warp
// (the exponent and top mantissa planes of smooth data) adds 512 to its
// bin from one lane, one whose 16 bytes are one value in a thread adds 16;
// otherwise each byte adds 1, the adds independent of one another (a
// count merged over each run of equal bytes chained them, and ran slower:
// chip_tune_k2lut_f2.py). The CTA's bins meet the global ones once, at its
// end.

// bytes side by side, each subtracted mod 256 (no borrow crosses a byte)
template <class W>
__device__ __forceinline__ W subb(W a, W b) {
    constexpr W LO7 = W(0x7F7F7F7F7F7F7F7Full), HI1 = W(0x8080808080808080ull);
    return ((a | HI1) - (b & LO7)) ^ ((a ^ ~b) & HI1);
}

// the words [i, i + 16 / sizeof(W)) into w (0 outside [0, n)): one 16-byte
// load where they all lie inside (two where off a 16-byte boundary)
template <class W>
__device__ __forceinline__ void fin_chunk(const W* __restrict__ data, long long i, long long n,
                                          W (&w)[16 / sizeof(W)]) {
    constexpr int PER = 16 / sizeof(W);
    if (i >= 0 && i + PER <= n) {
        const uint4 c = load16(reinterpret_cast<const uint8_t*>(data + i), 16);
        if constexpr (sizeof(W) == 4) {
            w[0] = c.x, w[1] = c.y, w[2] = c.z, w[3] = c.w;
        } else {
            w[0] = (W)c.x | (W)c.y << 32, w[1] = (W)c.z | (W)c.w << 32;
        }
    } else {
#pragma unroll
        for (int k = 0; k < PER; ++k) w[k] = i + k >= 0 && i + k < n ? data[i + k] : W(0);
    }
}

// bytes 4j .. 4j + 3 of plane b of 16 position words (W = u32: planes 0-3;
// u64: the low word planes 0-3, the high word 4-7)
template <class W>
__device__ __forceinline__ void to_planes(const W (&o)[FIN_RUN], unsigned (&pl)[8][4]) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
        unsigned x[4];
        transpose4((unsigned)o[4 * g], (unsigned)o[4 * g + 1], (unsigned)o[4 * g + 2],
                   (unsigned)o[4 * g + 3], x);
#pragma unroll
        for (int b = 0; b < 4; ++b) pl[b][g] = x[b];
        if constexpr (sizeof(W) == 8) {
            transpose4((unsigned)(o[4 * g] >> 32), (unsigned)(o[4 * g + 1] >> 32),
                       (unsigned)(o[4 * g + 2] >> 32), (unsigned)(o[4 * g + 3] >> 32), x);
#pragma unroll
            for (int b = 0; b < 4; ++b) pl[4 + b][g] = x[b];
        }
    }
}

template <class P>
__global__ void __launch_bounds__(FIN_NT) fpl_finalize_kernel(
        const typename P::W* __restrict__ data, long long n, int cols, int pred, Levels lv,
        uint8_t* __restrict__ planes, long long pstride, int* __restrict__ histos) {
    using W = typename P::W;
    __shared__ unsigned bins[P::PLANES * 256];
    const int tid = threadIdx.x, lane = tid & 31;
    W mk[MAX_DELTA + 1];  // the planes taken from each level, as byte masks
    int top = 0;
#pragma unroll
    for (int l = 0; l <= MAX_DELTA; ++l) {
        mk[l] = 0;
#pragma unroll
        for (int b = 0; b < P::PLANES; ++b)
            if (lv.v[b] == l) mk[l] |= W(0xFF) << (8 * b);
    }
#pragma unroll
    for (int b = 0; b < P::PLANES; ++b) top = max(top, lv.v[b]);
    for (int i = tid; i < P::PLANES * 256; i += FIN_NT) bins[i] = 0;
    __syncthreads();
    for (long long base = (long long)blockIdx.x * FIN_TILE; base < pstride;
         base += (long long)gridDim.x * FIN_TILE) {
        const long long p = base + FIN_RUN * tid;
        const bool act = p < pstride;
        const int live = (int)max(0LL, min((long long)FIN_RUN, n - p));  // positions below n
        W o[FIN_RUN];
        if (live > 0) {
            // the row and column of position p - 5 (p = 0: row -1 or below)
            const bool head = p < MAX_DELTA;  // (p = 0) positions below 0 and below a level
            const long long q5 = p - 5;
            long long r = q5 >= 0 ? q5 / cols : -((cols - 1 - q5) / cols);
            int c = (int)(q5 - r * cols);
            W d[21];  // positions p - 5 .. p + 15: predicted, then the byte levels
            W px = 0, pu = 0;  // the words before: at k - 1 and above it
            constexpr int PER = 16 / sizeof(W);
#pragma unroll
            for (int j = 0; j < 24 / PER; ++j) {  // the words p - 8 .. p + 15, a chunk at a time
                W xs[PER], us[PER];
                fin_chunk(data, p - 8 + j * PER, n, xs);
                if (pred == 2) fin_chunk(data, p - 8 - cols + j * PER, n, us);
#pragma unroll
                for (int i = 0; i < PER; ++i) {
                    const int k = j * PER + i;
                    const W x = P::tf(xs[i]), u = pred == 2 ? P::tf(us[i]) : W(0);
                    if (k >= 3) {
                        const int m = k - 3;
                        const W d1 = c > 0 ? ssub<P>(x, px) : x;
                        W v = pred == 0 ? x : d1;
                        if (pred == 2 && r > 0) v = ssub<P>(d1, c > 0 ? ssub<P>(u, pu) : u);
                        d[m] = !head || p - 5 + m >= 0 ? v : W(0);
                        if (++c == cols) c = 0, ++r;
                    }
                    px = x, pu = u;
                }
            }
#pragma unroll
            for (int m = 0; m < FIN_RUN; ++m) o[m] = d[m + 5] & mk[0];
#pragma unroll
            for (int l = 1; l <= MAX_DELTA; ++l) {  // a position below level l keeps l - 1
                if (l > top) break;
#pragma unroll
                for (int m = 20; m >= l; --m)
                    if (!head || p - 5 + m >= l) d[m] = subb<W>(d[m], d[m - 1]);
#pragma unroll
                for (int m = 0; m < FIN_RUN; ++m) o[m] |= d[m + 5] & mk[l];
            }
#pragma unroll
            for (int m = 0; m < FIN_RUN; ++m)
                if (m >= live) o[m] = 0;
        } else {
#pragma unroll
            for (int m = 0; m < FIN_RUN; ++m) o[m] = 0;
        }
        unsigned pl[8][4];
        to_planes<W>(o, pl);
#pragma unroll
        for (int b = 0; b < P::PLANES; ++b) {
            if (act)
                *reinterpret_cast<uint4*>(planes + b * pstride + p) =
                    make_uint4(pl[b][0], pl[b][1], pl[b][2], pl[b][3]);
            // the counts of the plane's live bytes: one add where they are one
            // value (in the warp, or in the thread), else one a byte, none
            // waiting on another
            const unsigned v0 = pl[b][0] & 0xFFu, lane0 = __shfl_sync(FULL, v0, 0);
            const bool one = live == FIN_RUN && pl[b][0] == v0 * 0x01010101u
                             && pl[b][1] == pl[b][0] && pl[b][2] == pl[b][0]
                             && pl[b][3] == pl[b][0];
            if (__all_sync(FULL, one && v0 == lane0)) {
                if (lane == 0) atomicAdd(&bins[b * 256 + v0], 32u * FIN_RUN);
            } else if (one) {
                atomicAdd(&bins[b * 256 + v0], (unsigned)FIN_RUN);
            } else {
#pragma unroll
                for (int m = 0; m < FIN_RUN; ++m)
                    if (m < live)
                        atomicAdd(&bins[b * 256 + ((pl[b][m >> 2] >> (8 * (m & 3))) & 0xFFu)], 1u);
            }
        }
    }
    __syncthreads();
    for (int i = tid; i < P::PLANES * 256; i += FIN_NT)
        if (bins[i]) atomicAdd(&histos[i], (int)bins[i]);
}

// ---------------------------------------------------------------------------
// F2b (grid y: one plane each)
// ---------------------------------------------------------------------------

// One tile's summary for the join (32 bytes): its first and last run start
// (-1: none), the terms of the runs that start in it and end before its last
// start, and two flags for the terms that need a neighbour tile.
struct PbTile {
    int f, l;
    unsigned flags;  // PB_NEEDS_F: the run at f leaves a literal of length < 130, so
                     // it opens a stretch unless the run before it left one;
                     // PB_PLIT_L: the run before l (inside the tile) left a literal
    unsigned segs, lit, stretch, pad0, pad1;
};
constexpr unsigned PB_NEEDS_F = 1, PB_PLIT_L = 2;
constexpr int PB_NONE = 0x7FFFFFFF;  // "no start" for a minimum

struct MaxU {
    using T = unsigned;
    __device__ static unsigned f(unsigned a, unsigned b) { return a > b ? a : b; }
};
struct MaxU64 {
    using T = unsigned long long;
    __device__ static unsigned long long f(unsigned long long a, unsigned long long b) {
        return a > b ? a : b;
    }
};

// bit i of the result: byte i of x is not 0
__device__ __forceinline__ unsigned nonzero4(unsigned x) {
    return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24 & 0xFu;
}

// the terms of one run of length L: 2 x (repeat segments), literal, and
// whether that literal opens a stretch given whether the run before left one
struct PbTerms {
    unsigned long long segs = 0, lit = 0, stretch = 0;
    __device__ void add(long long L, bool prev_lit) {
        const long long r = L % 129;
        segs += L / 129 + (r >= 2);
        if (r == 1) {
            ++lit;
            stretch += L >= 130 || !prev_lit;
        }
    }
};

// Pass over one tile of PB_TILE bytes of plane blockIdx.y, then, in the
// plane's last tile to finish (a ticket per plane), the join of the plane's
// tile summaries. Thread t takes the 64 bytes from a = t0 + 64 t by 16-byte
// loads (two aligned ones and a funnel shift at any alignment: the shift is
// the same for every thread of the CTA) and makes M, bit i set where a + i
// starts a run (its byte differs from the one before, or a + i = 0). The
// nearest starts of the threads before and after it in the tile (two block
// scans, max and min) close its first and last start's runs; a start whose
// next start is past the tile is the tile's last start l, one with none
// before it in the tile its first f. Every other run is counted by
// popcounts of M, at most two runs a thread by arithmetic.
// The join walks the summaries in tile order 256 at a time: P_U, the last
// start before tile U (a max scan of l), closes the run at P_U with length
// f_U - P_U; whether the run before P_U left a literal rides a second max
// scan, of 2 l + that flag. The run at the plane's last start ends at n.
__global__ void __launch_bounds__(NB) fpl_packbits_size_kernel(
        const uint8_t* __restrict__ planes, long long pstride, int n, int n_tiles,
        unsigned* __restrict__ tickets, PbTile* __restrict__ tiles, int* __restrict__ sizes) {
    __shared__ int wmax[WARPS], wmin[WARPS];
    __shared__ unsigned red[3][WARPS];
    __shared__ unsigned sh_flags;
    __shared__ bool sh_last;
    __shared__ unsigned long long sm64[2 * (WARPS + 1)];
    __shared__ unsigned sm32[2 * (WARPS + 1)];
    const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const uint8_t* p = planes + b * pstride;
    const int t0 = blockIdx.x * PB_TILE, a = t0 + PB_BYTES * tid;
    const int cnt = max(0, min(PB_BYTES, n - a));
    if (tid == 0) sh_flags = 0;

    // the 64 bytes as 16 words (zero past n), and the byte before a; a
    // 16-byte chunk is loaded only where it holds a byte of [a, a + cnt)
    // (where cnt is 0, no chunk: it could lie past the planes' allocation)
    unsigned wd[16];
    {
        const uintptr_t addr = reinterpret_cast<uintptr_t>(p + a);
        const int s = (int)(addr & 15);
        const uint4* q = reinterpret_cast<const uint4*>(addr - s);
        uint4 v[5];
#pragma unroll
        for (int k = 0; k < 5; ++k)
            v[k] = cnt > 0 && 16 * k - s < cnt ? __ldg(q + k) : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const uint4 x = s ? shift16(v[k], v[k + 1], s) : v[k];
            wd[4 * k] = x.x, wd[4 * k + 1] = x.y, wd[4 * k + 2] = x.z, wd[4 * k + 3] = x.w;
        }
    }
    unsigned prev = __shfl_up_sync(FULL, wd[15], 1) >> 24;
    if (lane == 0 && a > 0 && cnt > 0) prev = p[a - 1];
    unsigned long long M = 0;
    {
        unsigned pw = prev << 24;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            M |= (unsigned long long)nonzero4(wd[j] ^ __funnelshift_l(pw, wd[j], 8)) << (4 * j);
            pw = wd[j];
        }
        if (a == 0) M |= 1ull;
        if (cnt < PB_BYTES) M &= cnt ? (~0ull >> (PB_BYTES - cnt)) : 0ull;
    }

    // the nearest starts of the threads before (Pt) and after (Nt) in the tile
    const int fs = M ? a + __ffsll((long long)M) - 1 : PB_NONE;
    const int ls = M ? a + 63 - __clzll((long long)M) : -1;
    int pm = ls, sn = fs;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(FULL, pm, o), v = __shfl_down_sync(FULL, sn, o);
        if (lane >= o) pm = max(pm, u);
        if (lane + o < 32) sn = min(sn, v);
    }
    int Pt = __shfl_up_sync(FULL, pm, 1), Nt = __shfl_down_sync(FULL, sn, 1);
    if (lane == 0) Pt = -1, wmin[warp] = sn;
    if (lane == 31) Nt = PB_NONE, wmax[warp] = pm;
    __syncthreads();
    int tf = PB_NONE, tl = -1;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
        if (k < warp) Pt = max(Pt, wmax[k]);
        if (k > warp) Nt = min(Nt, wmin[k]);
        tf = min(tf, wmin[k]), tl = max(tl, wmax[k]);
    }
    // The runs whose start lies in the thread's 64 bytes. A run whose next
    // start lies there too is shorter than 129: it adds a repeat segment if
    // longer than 1, else a literal, which opens a stretch unless the run
    // before was a literal too (of length 1 where that run starts here as
    // well): popcounts. The run at the first start takes P from before; the
    // run at the last start N from after (a later tile's: the tile exports it).
    unsigned segs = 0, lit = 0, stretch = 0;
    if (M) {
        const int fi = __ffsll((long long)M) - 1, li = 63 - __clzll((long long)M);
        const unsigned long long A = M & ~(1ull << li), nx = M >> 1;  // nx: s + 1 starts too
        segs = (unsigned)__popcll((long long)(A & ~nx));
        lit = (unsigned)__popcll((long long)(A & nx));
        stretch = (unsigned)__popcll((long long)(A & ~(1ull << fi) & nx & ~(M << 1)));
        if (fi != li && (nx >> fi & 1ull)) {  // the first start's run is a literal of 1
            if (Pt >= 0) stretch += (a + fi - Pt) % 129 != 1;
            else atomicOr(&sh_flags, PB_NEEDS_F);  // it is the tile's first start
        }
        const unsigned long long lo = M & ((1ull << li) - 1ull);
        const int s = a + li, P = lo ? a + 63 - __clzll((long long)lo) : Pt;
        if (Nt == PB_NONE) {  // s is the tile's last start: its run ends in a later tile
            if (P >= 0 && (s - P) % 129 == 1) atomicOr(&sh_flags, PB_PLIT_L);
        } else {
            const int L = Nt - s, r = L % 129;
            segs += L / 129 + (r >= 2);
            if (r == 1) {
                ++lit;
                if (L >= 130) ++stretch;
                else if (P >= 0) stretch += (s - P) % 129 != 1;
                else atomicOr(&sh_flags, PB_NEEDS_F);
            }
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        segs += __shfl_xor_sync(FULL, segs, o);
        lit += __shfl_xor_sync(FULL, lit, o);
        stretch += __shfl_xor_sync(FULL, stretch, o);
    }
    if (lane == 0) red[0][warp] = segs, red[1][warp] = lit, red[2][warp] = stretch;
    __syncthreads();
    if (tid == 0) {
        PbTile e;
        e.f = tf == PB_NONE ? -1 : tf;
        e.l = tl;
        e.flags = sh_flags;
        e.segs = e.lit = e.stretch = e.pad0 = e.pad1 = 0;
        for (int k = 0; k < WARPS; ++k)
            e.segs += red[0][k], e.lit += red[1][k], e.stretch += red[2][k];
        tiles[(long long)b * n_tiles + blockIdx.x] = e;
        __threadfence();
        sh_last = atomicAdd(tickets + b, 1u) == (unsigned)n_tiles - 1u;
    }
    __syncthreads();
    if (!sh_last) return;

    // the join, in the plane's last tile to finish
    __threadfence();
    PbTerms acc;
    unsigned carry_l = 0;             // 1 + the last start so far, 0: none
    unsigned long long carry_k = 0;   // 1 + 2 x that start + (the run before it left a literal)
    const int4* tw = reinterpret_cast<const int4*>(tiles + (long long)b * n_tiles);
    for (int u0 = 0; u0 < n_tiles; u0 += NB) {
        const int u = u0 + tid;
        int f = -1, l = -1;
        unsigned flags = 0;
        if (u < n_tiles) {
            const int4 x = __ldcg(tw + 2 * u), y = __ldcg(tw + 2 * u + 1);
            f = x.x, l = x.y, flags = (unsigned)x.z;
            acc.segs += (unsigned)x.w, acc.lit += (unsigned)y.x, acc.stretch += (unsigned)y.y;
        }
        unsigned tot_l;
        const unsigned el = MaxU::f(carry_l, block_excl<NB, MaxU>(f >= 0 ? (unsigned)l + 1u : 0u,
                                                                  tot_l, sm32));
        const int P = (int)el - 1;  // the last start before tile u
        bool out = false;           // whether the run before l left a literal
        if (f >= 0) out = f != l ? (flags & PB_PLIT_L) != 0 : P >= 0 && (f - P) % 129 == 1;
        unsigned long long tot_k;
        const unsigned long long ek = MaxU64::f(carry_k, block_excl<NB, MaxU64>(
                f >= 0 ? 2ull * (unsigned)l + out + 1ull : 0ull, tot_k, sm64));
        if (f >= 0) {
            bool lt = false;  // whether the run at P left a literal
            if (P >= 0) {
                const long long L = f - P;
                lt = L % 129 == 1;
                acc.add(L, ek > 0 && ((ek - 1) & 1));
            }
            if (f != l && (flags & PB_NEEDS_F) && !lt) ++acc.stretch;
        }
        carry_l = MaxU::f(carry_l, tot_l);
        carry_k = MaxU64::f(carry_k, tot_k);
    }
    if (tid == 0 && carry_k > 0) {  // the run at the plane's last start ends at n
        const long long P = (long long)((carry_k - 1) >> 1);
        acc.add(n - P, (carry_k - 1) & 1);
    }
    unsigned long long v[3] = {acc.segs, acc.lit, acc.stretch};
    __shared__ unsigned long long red64[3][WARPS];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(FULL, v[k], o);
        if (lane == 0) red64[k][warp] = v[k];
    }
    __syncthreads();
    if (tid == 0) {
        unsigned long long s[3] = {0, 0, 0};
        for (int k = 0; k < 3; ++k)
            for (int w = 0; w < WARPS; ++w) s[k] += red64[k][w];
        sizes[b] = (int)(2 * s[0] + s[1] + s[2] + s[1] / 128);
    }
}

// ---------------------------------------------------------------------------
// F3
// ---------------------------------------------------------------------------

// bytes side by side, each added mod 256 (no carry crosses a byte)
template <class W>
__device__ __forceinline__ W addb(W a, W b) {
    constexpr W LO7 = W(0x7F7F7F7F7F7F7F7Full), HI1 = W(0x8080808080808080ull);
    return ((a & LO7) + (b & LO7)) ^ ((a ^ b) & HI1);
}

// each byte times k (< 256) mod 256
template <class W>
__device__ __forceinline__ W mulb(W x, unsigned k) {
    constexpr W EVEN = W(0x00FF00FF00FF00FFull);
    return ((x & EVEN) * W(k) & EVEN) | (((x >> 8) & EVEN) * W(k) & EVEN) << 8;
}

template <class W>
struct ByteAdd {
    using T = W;
    __device__ static W f(W a, W b) { return addb<W>(a, b); }
};

// C(l + a - 1, a) mod 256 for a = 0..4: the product of a consecutive
// integers mod 256 a!, divided by a!; l enters mod 6144 = 256 * 4!, a
// multiple of each 256 a! (constant divisors: multiplies, no division)
__device__ __forceinline__ void binoms256(unsigned long long l, unsigned* coef) {
    const unsigned long long x = l % 6144u;
    coef[0] = 1u;
    coef[1] = (unsigned)(x % 256u);
    coef[2] = (unsigned)((x * (x + 1) % 512u) / 2u);
    coef[3] = (unsigned)((x * (x + 1) % 1536u * (x + 2) % 1536u) / 6u);
    coef[4] = (unsigned)((x * (x + 1) % 6144u * (x + 2) % 6144u * (x + 3) % 6144u) / 24u);
}

// the level undo's carries (slot s: level s + 1's running sum, every plane
// in its byte) after l more zero bytes: slot s gains C(l + a - 1, a) times
// slot s + a (Pascal's triangle, each level a prefix sum of the one above)
template <class W>
__device__ __forceinline__ void advance(const W* u, unsigned long long l, W* out) {
    unsigned coef[MAX_DELTA];
    binoms256(l, coef);
    for (int s = 0; s < MAX_DELTA; ++s) {
        W v = 0;
        for (int a = 0; s + a < MAX_DELTA; ++a) v = addb<W>(v, mulb<W>(u[s + a], coef[a]));
        out[s] = v;
    }
}

// The scratch of one restore (bytes, each part 16-aligned): the ticket and
// the two look-backs' words (zeroed by the entry point on every call: the
// level carries' aggregates and inclusive prefixes, LV_WORDS words a tile
// each; the row scan's, RW_WORDS), then predictor 2's words and column tile
// sums. A look-back word is state << 32 | one 32-bit piece of the value, so
// a reader needs no fence: it waits until every piece of a value is there.
struct RsScratch {
    long long n_tiles, misc, lagg, linc, ragg, rinc, words, col, end;
};

constexpr int RS_ITEMS = 16, RS_TILE = NB * RS_ITEMS;  // positions a CTA

__host__ __device__ long long align16(long long b) { return (b + 15) & ~15LL; }

template <class W>
struct Lb {
    static constexpr int PIECES = sizeof(W) / 4;
    static constexpr int LV_WORDS = MAX_DELTA * PIECES, RW_WORDS = 1 + PIECES;
};

__host__ __device__ RsScratch rs_scratch(long long n, long long rows, int cols, int wbytes) {
    RsScratch s;
    const long long pieces = wbytes / 4;
    s.n_tiles = (n + RS_TILE - 1) / RS_TILE;
    s.misc = 0;
    s.lagg = 16;
    s.linc = s.lagg + align16(8 * MAX_DELTA * pieces * s.n_tiles);
    s.ragg = s.linc + align16(8 * MAX_DELTA * pieces * s.n_tiles);
    s.rinc = s.ragg + align16(8 * (1 + pieces) * s.n_tiles);
    s.words = s.rinc + align16(8 * (1 + pieces) * s.n_tiles);
    s.col = s.words + align16((long long)wbytes * n);
    s.end = s.col + align16((long long)wbytes * ((rows + COL_TILE - 1) / COL_TILE) * cols);
    return s;
}

constexpr unsigned long long RS_AGG = 1, RS_INC = 2;

// publish value v (k pieces of 32 bits) under state st
__device__ __forceinline__ void lb_publish(unsigned long long* dst, const unsigned* v, int k,
                                           unsigned long long st) {
    volatile unsigned long long* d = dst;
    for (int i = 0; i < k; ++i) d[i] = st << 32 | v[i];
}

// wait until one of a tile's two values (its inclusive prefix, or else its
// aggregate) has all its K pieces; returns the state, pieces in v
template <int K>
__device__ __forceinline__ unsigned long long lb_wait(const unsigned long long* agg,
                                                      const unsigned long long* inc,
                                                      unsigned* v) {
    const volatile unsigned long long* a = agg;
    const volatile unsigned long long* b = inc;
    for (;;) {
        unsigned long long x[K], y[K];
        bool inc_all = true, agg_all = true;
#pragma unroll
        for (int i = 0; i < K; ++i) {  // every load issued before any is tested
            x[i] = b[i];
            y[i] = a[i];
        }
#pragma unroll
        for (int i = 0; i < K; ++i) {
            inc_all &= x[i] >> 32 == RS_INC;
            agg_all &= y[i] >> 32 == RS_AGG;
        }
        if (inc_all || agg_all) {
#pragma unroll
            for (int i = 0; i < K; ++i) v[i] = (unsigned)(inc_all ? x[i] : y[i]);
            return inc_all ? RS_INC : RS_AGG;
        }
    }
}

// a level carry vector (or a row state) as 32-bit pieces and back
template <class W>
__device__ __forceinline__ void to_pieces(const W* w, int n, unsigned* v) {
    for (int i = 0; i < n; ++i) {
        v[Lb<W>::PIECES * i] = (unsigned)w[i];
        if constexpr (sizeof(W) == 8) v[2 * i + 1] = (unsigned)(w[i] >> 32);
    }
}

template <class W>
__device__ __forceinline__ void from_pieces(const unsigned* v, int n, W* w) {
    for (int i = 0; i < n; ++i) {
        w[i] = W(v[Lb<W>::PIECES * i]);
        if constexpr (sizeof(W) == 8) w[i] |= W(v[2 * i + 1]) << 32;
    }
}

// warp 0 of tile t: publish the tile's level carries agg (as they leave the
// tile from zero carries in), then look back 32 tiles a step: each lane
// waits for one tile's carries (its inclusive prefix, or its aggregate),
// advances them over the tiles between it and t (the maps compose
// linearly, so a tile's share of t's carries is its carries advanced by its
// distance), the nearest inclusive prefix ends the walk and the warp sums
// the shares up to it. Publishes t's inclusive prefix; c: t's carries in
// every lane.
template <class W>
__device__ void level_lookback(unsigned long long* agg_w, unsigned long long* inc_w, int t,
                               const W* agg, W* c) {
    constexpr int K = Lb<W>::LV_WORDS;
    const int lane = threadIdx.x & 31;
    unsigned pv[K];
#pragma unroll
    for (int s = 0; s < MAX_DELTA; ++s) c[s] = 0;
    to_pieces<W>(agg, MAX_DELTA, pv);
    if (t == 0) {
        if (lane == 0) lb_publish(inc_w, pv, K, RS_INC);
        return;
    }
    if (lane == 0) lb_publish(agg_w + (long long)t * K, pv, K, RS_AGG);
    for (int base = t - 1;; base -= 32) {
        const int j = base - lane;
        unsigned long long st = RS_INC;  // before tile 0: nothing
        W u[MAX_DELTA] = {}, v[MAX_DELTA];
        if (j >= 0) {
            st = lb_wait<K>(agg_w + (long long)j * K, inc_w + (long long)j * K, pv);
            from_pieces<W>(pv, MAX_DELTA, u);
        }
        const unsigned inc = __ballot_sync(FULL, st == RS_INC);
        const int stop = inc ? __ffs(inc) - 1 : 31;  // the nearest inclusive prefix
        advance<W>(u, (unsigned long long)(t - 1 - j) * RS_TILE, v);
#pragma unroll
        for (int s = 0; s < MAX_DELTA; ++s) {
            W x = lane <= stop ? v[s] : W(0);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) x = addb<W>(x, __shfl_xor_sync(FULL, x, o));
            c[s] = addb<W>(c[s], x);
        }
        if (inc) break;
    }
    if (lane == 0) {
        W inc[MAX_DELTA];
        advance<W>(c, RS_TILE, inc);
        for (int s = 0; s < MAX_DELTA; ++s) inc[s] = addb<W>(inc[s], agg[s]);
        to_pieces<W>(inc, MAX_DELTA, pv);
        lb_publish(inc_w + (long long)t * K, pv, K, RS_INC);
    }
}

// One pass over the planes, one CTA per tile of RS_TILE positions in ticket
// order, thread t on positions 16t .. 16t + 15. Each plane's 16 bytes by one
// 16-byte load, transposed into one word a position (plane b in byte b:
// the word's bits). The level undo (restoreSequence: level lev a prefix sum
// mod 256 from index lev - 1, from the highest level down) runs on those
// words bytewise, each level one block scan over the planes at or above it;
// the tile's carries (every level's running sum) come from a decoupled
// look-back over the tiles' affine carry maps (advance). Then predictors 1
// and 2: the split-field scan along the rows, restarting at column 0, its
// carry from a second look-back where the tile does not start a row; the
// float32 transform undone; out (or, predictor 2, the words for the column
// pass) staged in shared memory and stored 512 contiguous bytes a warp.
template <class P>
__global__ void __launch_bounds__(NB) fpl_restore_tile_kernel(
        const uint8_t* __restrict__ planes, long long pstride, long long n, int cols, int pred,
        Levels lv, uint8_t* scratch, typename P::W* __restrict__ out) {
    using W = typename P::W;
    using S = SegT<W>;
    __shared__ W smw[2 * (WARPS + 1)];
    __shared__ __align__(16) uint8_t stage[NB * (RS_ITEMS * sizeof(W) + 16)];  // the words out
    __shared__ W sh_c[MAX_DELTA];
    __shared__ S sh_row;
    __shared__ int sh_t;
    const RsScratch rs = rs_scratch(n, 0, 0, sizeof(W));
    unsigned* ticket = reinterpret_cast<unsigned*>(scratch + rs.misc);
    auto lbw = [&](long long off) { return reinterpret_cast<unsigned long long*>(scratch + off); };
    unsigned long long *lagg = lbw(rs.lagg), *linc = lbw(rs.linc);
    unsigned long long *ragg = lbw(rs.ragg), *rinc = lbw(rs.rinc);
    const int tid = threadIdx.x;
    if (tid == 0) sh_t = (int)atomicAdd(ticket, 1u);
    __syncthreads();
    const int t = sh_t;
    const long long i0 = (long long)t * RS_TILE, pb = i0 + RS_ITEMS * tid;
    const int cnt = (int)max(0LL, min((long long)RS_ITEMS, n - pb));
    W x[RS_ITEMS];
#pragma unroll
    for (int g = 0; g < P::PLANES / 4; ++g) {
        uint4 v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            v[i] = cnt > 0 ? load16(planes + (4 * g + i) * pstride + pb, cnt)
                           : make_uint4(0, 0, 0, 0);
        unsigned y[RS_ITEMS];
        transpose4(v[0].x, v[1].x, v[2].x, v[3].x, y);
        transpose4(v[0].y, v[1].y, v[2].y, v[3].y, y + 4);
        transpose4(v[0].z, v[1].z, v[2].z, v[3].z, y + 8);
        transpose4(v[0].w, v[1].w, v[2].w, v[3].w, y + 12);
#pragma unroll
        for (int k = 0; k < RS_ITEMS; ++k) {
            const W yk = k < cnt ? W(y[k]) : W(0);
            if constexpr (sizeof(W) == 8) {
                x[k] = g == 0 ? yk : x[k] | yk << 32;
            } else {
                x[k] = yk;
            }
        }
    }
    int top = 0;
    for (int b = 0; b < P::PLANES; ++b) top = max(top, lv.v[b]);
    if (top > 0) {
        W agg[MAX_DELTA] = {};
#pragma unroll
        for (int lev = MAX_DELTA; lev >= 1; --lev) {
            if (lev > top) continue;
            W lm = 0;  // the planes this level undoes
            for (int b = 0; b < P::PLANES; ++b)
                if (lv.v[b] >= lev) lm |= W(0xFF) << (8 * b);
            W acc = 0;
#pragma unroll
            for (int k = 0; k < RS_ITEMS; ++k)
                if (pb + k >= lev - 1) acc = addb<W>(acc, x[k]);
            W tot;
            W run = block_excl<NB, ByteAdd<W>>(acc, tot, smw);
#pragma unroll
            for (int k = 0; k < RS_ITEMS; ++k)
                if (pb + k >= lev - 1) {
                    run = addb<W>(run, x[k]);
                    x[k] = (run & lm) | (x[k] & ~lm);
                }
            agg[lev - 1] = tot & lm;
        }
        if (rs.n_tiles > 1) {
            if (tid < 32) {
                W c[MAX_DELTA];
                level_lookback<W>(lagg, linc, t, agg, c);
                if (tid == 0)
                    for (int s = 0; s < MAX_DELTA; ++s) sh_c[s] = c[s];
            }
            __syncthreads();
            W c[MAX_DELTA];
            W any = 0;
#pragma unroll
            for (int s = 0; s < MAX_DELTA; ++s) any |= (c[s] = sh_c[s]);
            if (any) {
                // position m of the tile gains K_m = sum_a C(m + a, a) c[a]. With
                // D_a(m) = sum_{b >= a} C(m + b - a, b - a) c[b] (K = D_0),
                // D_a(m + 1) = D_a(m) + D_{a+1}(m + 1): the binomials once a
                // thread, then four byte adds a position
                unsigned coef[MAX_DELTA];
                binoms256(RS_ITEMS * tid + 1, coef);  // C(m0 + j, j)
                W dv[MAX_DELTA];  // carries of levels above top are 0: D_a = 0 for a >= top
#pragma unroll
                for (int s = 0; s < MAX_DELTA; ++s) {
                    dv[s] = 0;
#pragma unroll
                    for (int j = 0; s + j < MAX_DELTA; ++j)
                        if (s + j < top) dv[s] = addb<W>(dv[s], mulb<W>(c[s + j], coef[j]));
                }
#pragma unroll
                for (int k = 0; k < RS_ITEMS; ++k) {
                    x[k] = addb<W>(x[k], dv[0]);
#pragma unroll
                    for (int s = MAX_DELTA - 2; s >= 0; --s)
                        if (s + 1 < top) dv[s] = addb<W>(dv[s], dv[s + 1]);
                }
            }
        }
    }
    if (pred >= 1) {
        unsigned starts = 0;  // bit k: position k is a row's column 0
        if (cnt > 0) {
            const long long cf = pb % cols;
            for (long long k = cf ? cols - cf : 0; k < cnt; k += cols) starts |= 1u << k;
        }
        S run = {0u, W(0)};
#pragma unroll
        for (int k = 0; k < RS_ITEMS; ++k)
            if (k < cnt) run = seg_combine<SplitAdd<P>>(run, S{(starts >> k) & 1u, x[k]});
        S tot;
        S ex = block_seg_excl<NB, SplitAdd<P>>(run, tot, smw);
        if (tid == 0) {
            constexpr int K = Lb<W>::RW_WORDS;
            S carry = {0u, W(0)};
            unsigned pv[K];
            pv[0] = tot.f;
            to_pieces<W>(&tot.v, 1, pv + 1);
            // nothing before the tile's first row start reaches its end
            const bool alone = t == 0 || i0 % cols == 0 || tot.f;
            lb_publish((alone ? rinc : ragg) + (long long)t * K, pv, K, alone ? RS_INC : RS_AGG);
            if (t > 0 && i0 % cols != 0) {
                for (int j = t - 1;; --j) {
                    const unsigned long long st =
                        lb_wait<K>(ragg + (long long)j * K, rinc + (long long)j * K, pv);
                    W u;
                    from_pieces<W>(pv + 1, 1, &u);
                    carry = seg_combine<SplitAdd<P>>(S{pv[0], u}, carry);
                    if (st == RS_INC || pv[0]) break;
                }
                if (!tot.f) {
                    const S inc = seg_combine<SplitAdd<P>>(carry, tot);
                    pv[0] = inc.f;
                    to_pieces<W>(&inc.v, 1, pv + 1);
                    lb_publish(rinc + (long long)t * K, pv, K, RS_INC);
                }
            }
            sh_row = carry;
        }
        __syncthreads();
        run = seg_combine<SplitAdd<P>>(sh_row, ex);
#pragma unroll
        for (int k = 0; k < RS_ITEMS; ++k)
            if (k < cnt) {
                run = seg_combine<SplitAdd<P>>(run, S{(starts >> k) & 1u, x[k]});
                x[k] = run.v;
            }
    }
    W* dst = pred == 2 ? reinterpret_cast<W*>(scratch + rs.words) : out;
    if (pred != 2) {
#pragma unroll
        for (int k = 0; k < RS_ITEMS; ++k) x[k] = P::store(x[k]);
    }
    // through shared memory (each thread's 16 words, then 16 bytes of padding:
    // no bank conflicts), so that each warp store writes 512 contiguous bytes
    constexpr int CHUNK_B = RS_ITEMS * sizeof(W), ROW_B = CHUNK_B + 16;
    uint8_t* row = stage + tid * ROW_B;
#pragma unroll
    for (int m = 0; m < CHUNK_B / 16; ++m) {
        if constexpr (sizeof(W) == 4) {
            *reinterpret_cast<uint4*>(row + 16 * m) = make_uint4(x[4 * m], x[4 * m + 1],
                                                                 x[4 * m + 2], x[4 * m + 3]);
        } else {
            *reinterpret_cast<uint4*>(row + 16 * m) = make_uint4(
                (unsigned)x[2 * m], (unsigned)(x[2 * m] >> 32), (unsigned)x[2 * m + 1],
                (unsigned)(x[2 * m + 1] >> 32));
        }
    }
    __syncthreads();
    const long long n_tile = min((long long)RS_TILE, n - i0);
    W* dt = dst + i0;
    if (n_tile == RS_TILE) {
#pragma unroll
        for (int m = 0; m < CHUNK_B / 16; ++m) {
            const int q = m * NB + tid;  // the tile's 16-byte piece q
            reinterpret_cast<uint4*>(dt)[q] =
                *reinterpret_cast<const uint4*>(stage + (q / (CHUNK_B / 16)) * ROW_B
                                                + 16 * (q % (CHUNK_B / 16)));
        }
    } else {
        for (int k = tid; k < n_tile; k += NB)
            dt[k] = *reinterpret_cast<const W*>(stage + (k / RS_ITEMS) * ROW_B
                                                + sizeof(W) * (k % RS_ITEMS));
    }
}

// predictor 2, down the columns of the row-scanned words: part[t * cols + c]
// = the split sum of column c over row tile t (COL_TILE rows; a warp per
// COL_ROWS-row strip, lanes on columns)
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

// the column scan from each row tile's carry, the transform undone, to out
template <class P>
__global__ void __launch_bounds__(NB) fpl_restore_col_apply_kernel(
        const typename P::W* __restrict__ words, long long rows, int cols,
        const typename P::W* __restrict__ carry, typename P::W* __restrict__ out) {
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
                out[r * cols + c] = P::store(acc);
            }
        }
        __syncthreads();
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
    if (cols < 1 || pstride < n || pred < 0 || pred > 2) return (int)cudaErrorInvalidValue;
    for (int b = 0; b < P::PLANES; ++b)
        if (lv.v[b] < 0 || lv.v[b] > MAX_DELTA) return (int)cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(planes) | (uintptr_t)pstride) & 15)
        return (int)cudaErrorMisalignedAddress;
    // as many CTAs as the card holds at once (each merges its bins once)
    int per_sm = 0, sms = 0, dev = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fpl_finalize_kernel<P>, FIN_NT, 0);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const long long tiles = chunks(pstride, FIN_TILE), resident = (long long)max(per_sm, 1) * sms;
    fpl_finalize_kernel<P><<<(unsigned)(tiles < resident ? tiles : resident), FIN_NT, 0, st>>>(
        data, n, cols, pred, lv, planes, pstride, histos);
    return (int)cudaGetLastError();
}

template <class P>
int launch_restore(const uint8_t* planes, long long pstride, long long n, long long rows, int cols,
                   int pred, const Levels& lv, uint8_t* scratch, long long n_scratch,
                   typename P::W* out, cudaStream_t st) {
    using W = typename P::W;
    if (n == 0) return 0;
    const RsScratch rs = rs_scratch(n, rows, cols, sizeof(W));
    if (n_scratch < rs.end || rows * cols != n || cols < 1) return (int)cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(scratch) | reinterpret_cast<uintptr_t>(out)) & 15)
        return (int)cudaErrorMisalignedAddress;
    const cudaError_t err = cudaMemsetAsync(scratch, 0, rs.words, st);  // ticket, look-back words
    if (err != cudaSuccess) return (int)err;
    fpl_restore_tile_kernel<P><<<(unsigned)rs.n_tiles, NB, 0, st>>>(planes, pstride, n, cols, pred,
                                                                     lv, scratch, out);
    if (pred == 2) {
        W* words = reinterpret_cast<W*>(scratch + rs.words);
        W* part = reinterpret_cast<W*>(scratch + rs.col);
        const long long nt = chunks(rows, COL_TILE);
        const long long ct = chunks(cols, 32);
        const dim3 grid((unsigned)nt, (unsigned)(ct < 65535 ? ct : 65535));
        fpl_restore_col_sums_kernel<P><<<grid, NB, 0, st>>>(words, rows, cols, part);
        fpl_restore_col_carry_kernel<P>
            <<<(unsigned)(cols < MAX_GRID ? cols : MAX_GRID), NB, 0, st>>>(part, nt, cols);
        fpl_restore_col_apply_kernel<P><<<grid, NB, 0, st>>>(words, rows, cols, part, out);
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

// levels [4] on the host; planes u8 [4, pstride] (16-aligned, pstride >= n
// a multiple of 16: every byte written, 0 from n on); histos int32 [4, 256], zeroed
extern "C" int fpl_finalize(const unsigned* data, long long n, int cols, int pred,
                            const int* levels, uint8_t* planes, long long pstride, int* histos,
                            void* stream) {
    return launch_finalize<Word32>(data, n, cols, pred, levels_of(levels, 4), planes, pstride,
                                   histos, (cudaStream_t)stream);
}

// float64: levels [8] on the host; planes u8 [8, pstride] as fpl_finalize's;
// histos int32 [8, 256], zeroed
extern "C" int fpl_finalize_f64(const unsigned long long* data, long long n, int cols, int pred,
                                const int* levels, uint8_t* planes, long long pstride,
                                int* histos, void* stream) {
    return launch_finalize<Word64>(data, n, cols, pred, levels_of(levels, 8), planes, pstride,
                                   histos, (cudaStream_t)stream);
}

// bytes of scratch fpl_packbits_size needs for n bytes a plane: a ticket a
// plane, then a 32-byte summary a tile and plane
extern "C" long long fpl_packbits_scratch(long long n, int n_planes) {
    return 32 + (long long)sizeof(PbTile) * n_planes * chunks(n, PB_TILE);
}

// planes u8 [n_planes, pstride] (4 or 8; any alignment, read only); scratch:
// fpl_packbits_scratch(n, n_planes) bytes, 16-aligned, its tickets zeroed
// here on the stream; sizes int32 [n_planes]
extern "C" int fpl_packbits_size(const uint8_t* planes, int n_planes, long long pstride,
                                 long long n, uint8_t* scratch, long long n_scratch, int* sizes,
                                 void* stream) {
    if (n == 0) return 0;
    if (n_planes < 1 || n_planes > MAX_PLANES || n > (1LL << 31) - 2 * PB_TILE ||
        n_scratch < fpl_packbits_scratch(n, n_planes))
        return (int)cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(scratch) & 15) return (int)cudaErrorMisalignedAddress;
    const cudaStream_t st = (cudaStream_t)stream;
    const cudaError_t err = cudaMemsetAsync(scratch, 0, 32, st);  // the tickets
    if (err != cudaSuccess) return (int)err;
    const long long nt = chunks(n, PB_TILE);
    fpl_packbits_size_kernel<<<dim3((unsigned)nt, n_planes), NB, 0, st>>>(
        planes, pstride, (int)n, (int)nt, reinterpret_cast<unsigned*>(scratch),
        reinterpret_cast<PbTile*>(scratch + 32), sizes);
    return (int)cudaGetLastError();
}

// bytes of scratch fpl_restore (word_bytes 4) and fpl_restore_f64 (8) need;
// the tiling is this source's alone, callers size their buffer by this query
extern "C" long long fpl_restore_scratch(long long n, long long rows, int cols, int word_bytes) {
    return rs_scratch(n, rows, cols, word_bytes).end;
}

// planes u8 [4, pstride] (any alignment, read only); levels [4] on the host;
// scratch: fpl_restore_scratch(n, rows, cols, 4) bytes, 16-aligned; out
// float32 bits [n], 16-aligned
extern "C" int fpl_restore(const uint8_t* planes, long long pstride, long long n, long long rows,
                           int cols, int pred, const int* levels, uint8_t* scratch,
                           long long n_scratch, unsigned* out, void* stream) {
    return launch_restore<Word32>(planes, pstride, n, rows, cols, pred, levels_of(levels, 4),
                                  scratch, n_scratch, out, (cudaStream_t)stream);
}

// float64: planes u8 [8, pstride]; levels [8]; scratch:
// fpl_restore_scratch(n, rows, cols, 8) bytes; out float64 bits [n]
extern "C" int fpl_restore_f64(const uint8_t* planes, long long pstride, long long n,
                               long long rows, int cols, int pred, const int* levels,
                               uint8_t* scratch, long long n_scratch, unsigned long long* out,
                               void* stream) {
    return launch_restore<Word64>(planes, pstride, n, rows, cols, pred, levels_of(levels, 8),
                                  scratch, n_scratch, out, (cudaStream_t)stream);
}
