// H1-H4: whole-image Huffman of 8-bit bands (Lerc2.cpp:2311-2606).
//
// Replaces lerc_tpu/ops/device_huffman.py. The TPU version routes every
// byte through bf16 matmuls (nibble-factored histograms and table lookups,
// one-hot group packing, static roll chains); here the same functions are
// shared-memory tables, warp scans, ballots and atomics.
//
//   H1 huffman_symbols        symbol_streams_device :50, symbol_streams_masked_device
//                             :72, histogram256 :118. One thread per pixel (all
//                             depths): direct symbols pixel-major at the pixel's
//                             rank, delta symbols depth-major, both 256-bin
//                             histograms of the live symbols (warp-aggregated
//                             shared atomics, one global add per bin and CTA).
//                             With a mask, a rank is the chunk's base (an
//                             exclusive scan of per-chunk counts, torch glue as
//                             K2's record offsets) plus the popc prefix in the
//                             chunk; the previous valid pixel is the pixel of
//                             rank - 1: the highest lower bit of the ballot, of an
//                             earlier warp, or the chunk's carried-in index.
//   H2 huffman_group_bits     encode_stream_device :160 (+ _map256 :141): one warp
//      huffman_pack           per 64-symbol group. Pass 1 sums the group's code
//                             lengths; the exclusive scan over the groups is the
//                             sidecar sbits (torch.cumsum); pass 2 places each
//                             code MSB-first (Huffman.h:218-255) in a per-warp
//                             shared buffer at its warp-scanned offset, stores
//                             the words only this group touches and atomicOr's
//                             the first and last, which neighbours may share.
//   H3 huffman_decode         decode_stream_device :278: one thread per group,
//                             64 serial symbols from a 64-bit window at
//                             sbits[g]; canonical decode against per-length
//                             (first, limit, base) rows in shared memory, in
//                             u32/u64, so code lengths 31 and 32 work; ok drops
//                             on a live prefix matching no code, a code past
//                             the stream, sbits[0] != 0 or a group whose bits
//                             do not end where the next group's begin.
//   H4 huffman_restore        symbols_to_image :477 direct: (sym - offset) & 0xFF;
//      huffman_restore_col0   symbols_to_image delta: a mod-256 scan down column
//      huffman_restore_delta  0 per depth, then one block-wide scan per row;
//      huffman_restore_masked expand_compacted_device :389: valid p <- sym[rank(p)];
//      huffman_restore_delta_masked
//                             undelta_masked_device :432: one CTA per depth walks
//                             the rows in order, a segmented scan along each row
//                             whose segments start at use-above pixels (left
//                             invalid, above valid), based on the row above,
//                             which is done; no limit on the number of segments.
//
// Bounds: bytes throughout (8-bit symbols, a few integer operations each).
// H3's groups and the masked un-delta's rows are serial chains: their time
// is latency, far above the bytes bound.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"  // Seg, seg_combine, block_seg_excl (sums here)

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int GROUP = 64;
constexpr int CHUNK = 256;            // pixels per rank chunk = H1's CTA
constexpr int MAX_GRID = 1056;        // 8 CTAs on each of 132 SMs (grid-stride beyond)
constexpr int PACK_WARPS = 8;         // groups per CTA in H2
constexpr int PACK_WORDS = 66;        // a group's words from its first: <= (31 + 2048 + 31) / 32 + 1
constexpr int DEC_THREADS = 128;
constexpr int ROW_THREADS = 256, ROW_ITEMS = 8;    // the all-valid row scan
constexpr int SEG_THREADS = 512, SEG_ITEMS = 4;    // the masked un-delta

unsigned grid_of(long long n, int per) {
    const long long g = (n + per - 1) / per;
    return (unsigned)(g < MAX_GRID ? g : MAX_GRID);
}

__device__ __forceinline__ bool is_live(long long i, long long n_total, long long plane,
                                        long long n_live) {
    return i < n_total && i % plane < n_live;
}

// ---------------------------------------------------------------------------
// H1
// ---------------------------------------------------------------------------

template <bool MASKED>
__global__ void __launch_bounds__(CHUNK) huffman_symbols_kernel(
        const int* __restrict__ data, const uint8_t* __restrict__ mask,
        const int* __restrict__ chunk_base, const int* __restrict__ chunk_last, int h, int w,
        int d, int offset, long long n_chunks, uint8_t* __restrict__ direct,
        uint8_t* __restrict__ delta, int* __restrict__ histos) {
    __shared__ unsigned hist[2 * 256];
    __shared__ int warp_cnt[CHUNK / 32];
    __shared__ long long warp_last[CHUNK / 32];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    for (int i = tid; i < 512; i += CHUNK) hist[i] = 0;
    __syncthreads();
    const long long npx = (long long)h * w;
    for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
        const long long p = c * CHUNK + tid;
        const bool v = p < npx && (!MASKED || mask[p]);
        long long rank = p, q = p - 1;
        if (MASKED) {
            const unsigned ballot = __ballot_sync(FULL, v);
            if (lane == 0) {
                warp_cnt[warp] = __popc(ballot);
                warp_last[warp] = ballot ? c * CHUNK + warp * 32 + 31 - __clz(ballot) : -1;
            }
            __syncthreads();
            int before = 0;
            long long last = chunk_last[c];
            for (int k = 0; k < warp; ++k) {
                before += warp_cnt[k];
                if (warp_last[k] >= 0) last = warp_last[k];
            }
            const unsigned below = ballot & ((1u << lane) - 1u);
            rank = chunk_base[c] + before + __popc(below);
            q = below ? c * CHUNK + warp * 32 + 31 - __clz(below) : last;
            __syncthreads();  // warp_cnt / warp_last are the next chunk's
        }
        const unsigned act = __ballot_sync(FULL, v);
        if (!v) continue;
        const long long row = p / w, col = p - row * w;
        long long src;  // the pixel the delta is taken against; -1: none (0)
        if (MASKED) {
            const bool left_ok = col > 0 && mask[p - 1];
            const bool above_ok = row > 0 && mask[p - w];
            src = (!left_ok && above_ok) ? p - w : q;
        } else {
            src = col > 0 ? p - 1 : (row > 0 ? p - w : -1);
        }
        for (int k = 0; k < d; ++k) {
            const int x = data[p * d + k];
            const int prev = src >= 0 ? data[src * d + k] : 0;
            const unsigned sd = (unsigned)(x + offset) & 0xFFu;
            const unsigned se = (unsigned)(x - prev + offset) & 0xFFu;
            direct[rank * d + k] = (uint8_t)sd;
            delta[k * npx + rank] = (uint8_t)se;
            unsigned peers = __match_any_sync(act, sd);
            if (lane == __ffs(peers) - 1) atomicAdd(&hist[sd], (unsigned)__popc(peers));
            peers = __match_any_sync(act, se);
            if (lane == __ffs(peers) - 1) atomicAdd(&hist[256 + se], (unsigned)__popc(peers));
        }
    }
    __syncthreads();
    for (int i = tid; i < 512; i += CHUNK)
        if (hist[i]) atomicAdd(&histos[i], (int)hist[i]);
}

// ---------------------------------------------------------------------------
// H2
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(PACK_WARPS * 32) huffman_group_bits_kernel(
        const uint8_t* __restrict__ sym, const int* __restrict__ table, long long n_total,
        long long plane, long long n_live, int n_groups, int* __restrict__ gbits) {
    __shared__ int lens[256];
    for (int i = threadIdx.x; i < 256; i += blockDim.x) lens[i] = table[i];
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const long long g = (long long)blockIdx.x * PACK_WARPS + (threadIdx.x >> 5);
    if (g >= n_groups) return;
    const long long i0 = g * GROUP + 2 * lane;
    int b = (is_live(i0, n_total, plane, n_live) ? lens[sym[i0]] : 0)
          + (is_live(i0 + 1, n_total, plane, n_live) ? lens[sym[i0 + 1]] : 0);
    for (int o = 16; o > 0; o >>= 1) b += __shfl_xor_sync(FULL, b, o);
    if (lane == 0) gbits[g] = b;
}

// OR code's L bits (MSB-first) into buf at bit o of the word sequence
__device__ __forceinline__ void put_code(unsigned* buf, int o, int L, unsigned code) {
    if (L == 0) return;
    const unsigned top = L == 32 ? code : code << (32 - L);
    const int wi = o >> 5, sh = o & 31;
    atomicOr(&buf[wi], top >> sh);
    if (sh && sh + L > 32) atomicOr(&buf[wi + 1], top << (32 - sh));
}

__global__ void __launch_bounds__(PACK_WARPS * 32) huffman_pack_kernel(
        const uint8_t* __restrict__ sym, const int* __restrict__ table, long long n_total,
        long long plane, long long n_live, int n_groups, const int* __restrict__ sbits,
        unsigned* __restrict__ out, long long cap_words) {
    __shared__ int lens[256];
    __shared__ unsigned codes[256];
    __shared__ unsigned buf[PACK_WARPS][PACK_WORDS];
    for (int i = threadIdx.x; i < 256; i += blockDim.x) {
        lens[i] = table[i];
        codes[i] = (unsigned)table[256 + i];
    }
    __syncthreads();
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const long long g = (long long)blockIdx.x * PACK_WARPS + wid;
    if (g >= n_groups) return;
    unsigned* b = buf[wid];
    for (int j = lane; j < PACK_WORDS; j += 32) b[j] = 0;
    __syncwarp();
    const long long i0 = g * GROUP + 2 * lane;
    const unsigned s0 = sym[i0], s1 = sym[i0 + 1];
    const int l0 = is_live(i0, n_total, plane, n_live) ? lens[s0] : 0;
    const int l1 = is_live(i0 + 1, n_total, plane, n_live) ? lens[s1] : 0;
    int incl = l0 + l1;
    for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += t;
    }
    const long long start = sbits[g];
    const int lead = (int)(start & 31);
    const int o0 = lead + incl - l0 - l1;
    put_code(b, o0, l0, codes[s0]);
    put_code(b, o0 + l0, l1, codes[s1]);
    __syncwarp();
    const int total = __shfl_sync(FULL, incl, 31);
    if (total == 0) return;
    const int last = (lead + total - 1) >> 5;
    const long long w0 = start >> 5;
    for (int j = lane; j <= last; j += 32) {
        const long long wi = w0 + j;
        if (wi >= cap_words) break;
        if (j == 0 || j == last) atomicOr(&out[wi], b[j]);
        else out[wi] = b[j];  // words strictly inside the group's bits are its own
    }
}

// ---------------------------------------------------------------------------
// H3
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(DEC_THREADS) huffman_decode_kernel(
        const unsigned* __restrict__ words, long long n_words, long long n_bits,
        const int* __restrict__ sbits, int n_groups, const long long* __restrict__ consts,
        const uint8_t* __restrict__ sorted_syms, long long n_total, long long plane,
        long long n_live, uint8_t* __restrict__ syms, int* __restrict__ used_out,
        int* __restrict__ ok) {
    __shared__ unsigned long long first[32], limit[32];
    __shared__ int base[32], lens[32], n_lens;
    __shared__ uint8_t table[256];
    if (threadIdx.x == 0) {
        int n = 0;
        for (int L = 1; L <= 32; ++L) {
            const long long f = consts[3 * L], lim = consts[3 * L + 1];
            if (lim > f) {
                lens[n] = L;
                first[n] = (unsigned long long)f;
                limit[n] = (unsigned long long)lim;
                base[n] = (int)consts[3 * L + 2];
                ++n;
            }
        }
        n_lens = n;
    }
    for (int i = threadIdx.x; i < 256; i += DEC_THREADS) table[i] = sorted_syms[i];
    __syncthreads();
    const long long g = (long long)blockIdx.x * DEC_THREADS + threadIdx.x;
    if (g >= n_groups) return;
    const int nl = n_lens;
    const long long start = sbits[g];
    long long pos = start;
    bool bad = pos < 0;
    long long wi = bad ? 0 : pos >> 5;
    auto load = [&](long long k) -> unsigned long long {
        return k >= 0 && k < n_words ? (unsigned long long)words[k] : 0ull;
    };
    unsigned long long win = (load(wi) << 32) | load(wi + 1);  // bits from word wi on
    int sh = bad ? 0 : (int)(pos & 31);
    int used = 0;
    for (int s = 0; s < GROUP; ++s) {
        const long long i = g * GROUP + s;
        uint8_t out = 0;
        if (!bad && is_live(i, n_total, plane, n_live)) {
            const unsigned peek = (unsigned)((win << sh) >> 32);
            int j = 0, L = 0;
            unsigned long long c = 0;
            for (; j < nl; ++j) {
                L = lens[j];
                c = peek >> (32 - L);
                if (c >= first[j] && c < limit[j]) break;
            }
            if (j == nl || pos + L > n_bits) {
                bad = true;
            } else {
                out = table[base[j] + (int)(c - first[j])];
                pos += L;
                used += L;
                sh += L;
                if (sh >= 32) {
                    sh -= 32;
                    ++wi;
                    win = (win << 32) | load(wi + 1);
                }
            }
        }
        syms[i] = out;
    }
    used_out[g] = used;
    if (bad || (g == 0 && start != 0)
            || (g + 1 < n_groups && (long long)sbits[g + 1] - start != used))
        *ok = 0;
}

// ---------------------------------------------------------------------------
// H4
// ---------------------------------------------------------------------------

__global__ void huffman_restore_kernel(const uint8_t* __restrict__ sym, long long n, int offset,
                                       uint8_t* __restrict__ img) {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x)
        img[i] = (uint8_t)((int)sym[i] - offset);
}

// col0[k * h + r] = sum_{i <= r} e[k][i][0] (mod 256), one CTA per depth
__global__ void __launch_bounds__(ROW_THREADS) huffman_restore_col0_kernel(
        const uint8_t* __restrict__ sym, int h, int w, int offset, uint8_t* __restrict__ col0) {
    __shared__ unsigned sm[2 * (ROW_THREADS / 32 + 1)];
    const int k = blockIdx.x;
    const long long plane = (long long)h * w;
    unsigned carry = 0;
    for (int r0 = 0; r0 < h; r0 += ROW_THREADS) {
        const int r = r0 + threadIdx.x;
        const unsigned e = r < h ? (unsigned)((int)sym[k * plane + (long long)r * w] - offset) : 0u;
        Seg tot;
        const Seg ex = block_seg_excl<ROW_THREADS>({0, e}, tot, sm);
        if (r < h) col0[(long long)k * h + r] = (uint8_t)(carry + ex.v + e);
        carry += tot.v;
    }
}

// one CTA per (row, depth): the row's mod-256 inclusive scan from col0
__global__ void __launch_bounds__(ROW_THREADS) huffman_restore_delta_kernel(
        const uint8_t* __restrict__ sym, const uint8_t* __restrict__ col0, int h, int w, int d,
        int offset, uint8_t* __restrict__ img) {
    __shared__ unsigned sm[2 * (ROW_THREADS / 32 + 1)];
    const long long r = blockIdx.x;
    const int k = blockIdx.y;
    const uint8_t* src = sym + k * (long long)h * w + r * w;
    unsigned carry = 0;
    for (int c0 = 0; c0 < w; c0 += ROW_THREADS * ROW_ITEMS) {
        unsigned e[ROW_ITEMS], sum = 0;
        for (int j = 0; j < ROW_ITEMS; ++j) {
            const int c = c0 + threadIdx.x * ROW_ITEMS + j;
            e[j] = c >= w ? 0u : c == 0 ? (unsigned)col0[(long long)k * h + r]
                                        : (unsigned)((int)src[c] - offset);
            sum += e[j];
        }
        Seg tot;
        unsigned acc = carry + block_seg_excl<ROW_THREADS>({0, sum}, tot, sm).v;
        for (int j = 0; j < ROW_ITEMS; ++j) {
            const int c = c0 + threadIdx.x * ROW_ITEMS + j;
            acc += e[j];
            if (c < w) img[(r * w + c) * d + k] = (uint8_t)acc;
        }
        carry += tot.v;
    }
}

// valid pixel p <- sym[rank(p) * d + k] - offset, 0 elsewhere
__global__ void __launch_bounds__(CHUNK) huffman_restore_masked_kernel(
        const uint8_t* __restrict__ sym, const uint8_t* __restrict__ mask,
        const int* __restrict__ chunk_base, long long npx, int d, int offset,
        uint8_t* __restrict__ img) {
    __shared__ int warp_cnt[CHUNK / 32];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long n_chunks = (npx + CHUNK - 1) / CHUNK;
    for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
        const long long p = c * CHUNK + tid;
        const bool v = p < npx && mask[p];
        const unsigned ballot = __ballot_sync(FULL, v);
        if (lane == 0) warp_cnt[warp] = __popc(ballot);
        __syncthreads();
        int before = 0;
        for (int k = 0; k < warp; ++k) before += warp_cnt[k];
        const long long rank = chunk_base[c] + before + __popc(ballot & ((1u << lane) - 1u));
        __syncthreads();
        if (p < npx)
            for (int k = 0; k < d; ++k)
                img[p * d + k] = v ? (uint8_t)((int)sym[rank * d + k] - offset) : 0;
    }
}

// one CTA per depth slice, rows in order (Lerc2.cpp:2546-2575): along a row
// the running value goes on from the previous valid pixel in scan order
// (across gaps and rows) and restarts at each use-above pixel from the value
// above it, in the row before, which this CTA wrote already
__global__ void __launch_bounds__(SEG_THREADS) huffman_restore_delta_masked_kernel(
        const uint8_t* __restrict__ sym, const uint8_t* __restrict__ mask, int h, int w, int d,
        int offset, uint8_t* img) {
    __shared__ unsigned sm[2 * (SEG_THREADS / 32 + 1)];
    const int k = blockIdx.x;
    const long long npx = (long long)h * w;
    const uint8_t* planes = sym + k * npx;
    unsigned carry = 0;      // the value of the last valid pixel so far
    long long rank0 = 0;     // valid pixels before the tile
    for (long long r = 0; r < h; ++r) {
        const uint8_t* m = mask + r * w;
        for (int c0 = 0; c0 < w; c0 += SEG_THREADS * SEG_ITEMS) {
            const int cb = c0 + threadIdx.x * SEG_ITEMS;
            bool valid[SEG_ITEMS];
            unsigned cnt = 0;
            for (int j = 0; j < SEG_ITEMS; ++j) {
                valid[j] = cb + j < w && m[cb + j];
                cnt += valid[j];
            }
            Seg ctot;
            long long rank = rank0 + block_seg_excl<SEG_THREADS>({0, cnt}, ctot, sm).v;
            Seg item[SEG_ITEMS], run = {0, 0};
            for (int j = 0; j < SEG_ITEMS; ++j) {
                const int c = cb + j;
                item[j] = {0, 0};
                if (valid[j]) {
                    const unsigned e = (unsigned)((int)planes[rank++] - offset);
                    const bool left_ok = c > 0 && m[c - 1];
                    const bool above_ok = r > 0 && m[c - w];
                    if (!left_ok && above_ok)
                        item[j] = {1u, (unsigned)img[((r - 1) * w + c) * d + k] + e};
                    else
                        item[j] = {0u, e};
                }
                run = seg_combine<Sum>(run, item[j]);
            }
            Seg tot;
            Seg acc = seg_combine<Sum>({0, carry}, block_seg_excl<SEG_THREADS>(run, tot, sm));
            for (int j = 0; j < SEG_ITEMS; ++j) {
                const int c = cb + j;
                acc = seg_combine<Sum>(acc, item[j]);
                if (c < w) img[(r * w + c) * d + k] = valid[j] ? (uint8_t)acc.v : 0;
            }
            carry = seg_combine<Sum>({0, carry}, tot).v;
            rank0 += ctot.v;
            __syncthreads();  // this row's values before the next row reads them
        }
    }
}

}  // namespace

// data [h, w, d] int32; mask [h * w] bool or null; chunk_base, chunk_last
// [ceil(h*w / 256)] (masked only); direct, delta: zeroed u8; histos [2, 256]
// int32, zeroed
extern "C" int huffman_symbols(const int* data, const uint8_t* mask, const int* chunk_base,
                               const int* chunk_last, int h, int w, int d, int offset,
                               uint8_t* direct, uint8_t* delta, int* histos, void* stream) {
    const long long n_chunks = ((long long)h * w + CHUNK - 1) / CHUNK;
    if (n_chunks == 0) return 0;
    const unsigned grid = grid_of(n_chunks, 1);
    if (mask)
        huffman_symbols_kernel<true><<<grid, CHUNK, 0, (cudaStream_t)stream>>>(
            data, mask, chunk_base, chunk_last, h, w, d, offset, n_chunks, direct, delta, histos);
    else
        huffman_symbols_kernel<false><<<grid, CHUNK, 0, (cudaStream_t)stream>>>(
            data, mask, chunk_base, chunk_last, h, w, d, offset, n_chunks, direct, delta, histos);
    return (int)cudaGetLastError();
}

extern "C" int huffman_group_bits(const uint8_t* sym, const int* table, long long n_total,
                                  long long plane, long long n_live, int n_groups, int* gbits,
                                  void* stream) {
    if (n_groups == 0) return 0;
    const unsigned grid = (unsigned)((n_groups + PACK_WARPS - 1) / PACK_WARPS);
    huffman_group_bits_kernel<<<grid, PACK_WARPS * 32, 0, (cudaStream_t)stream>>>(
        sym, table, n_total, plane, n_live, n_groups, gbits);
    return (int)cudaGetLastError();
}

// words: cap_words u32, zeroed
extern "C" int huffman_pack(const uint8_t* sym, const int* table, long long n_total,
                            long long plane, long long n_live, int n_groups, const int* sbits,
                            unsigned* words, long long cap_words, void* stream) {
    if (n_groups == 0) return 0;
    const unsigned grid = (unsigned)((n_groups + PACK_WARPS - 1) / PACK_WARPS);
    huffman_pack_kernel<<<grid, PACK_WARPS * 32, 0, (cudaStream_t)stream>>>(
        sym, table, n_total, plane, n_live, n_groups, sbits, words, cap_words);
    return (int)cudaGetLastError();
}

// consts [33, 3] int64; syms [n_groups * 64]; used [n_groups]; ok: 1 on entry
extern "C" int huffman_decode(const unsigned* words, long long n_words, long long n_bits,
                              const int* sbits, int n_groups, const long long* consts,
                              const uint8_t* sorted_syms, long long n_total, long long plane,
                              long long n_live, uint8_t* syms, int* used, int* ok, void* stream) {
    if (n_groups == 0) return 0;
    const unsigned grid = (unsigned)((n_groups + DEC_THREADS - 1) / DEC_THREADS);
    huffman_decode_kernel<<<grid, DEC_THREADS, 0, (cudaStream_t)stream>>>(
        words, n_words, n_bits, sbits, n_groups, consts, sorted_syms, n_total, plane, n_live,
        syms, used, ok);
    return (int)cudaGetLastError();
}

extern "C" int huffman_restore(const uint8_t* sym, long long n, int offset, uint8_t* img,
                               void* stream) {
    if (n == 0) return 0;
    huffman_restore_kernel<<<grid_of(n, 256 * 4), 256, 0, (cudaStream_t)stream>>>(
        sym, n, offset, img);
    return (int)cudaGetLastError();
}

// col0: [d, h] u8
extern "C" int huffman_restore_col0(const uint8_t* sym, int h, int w, int d, int offset,
                                    uint8_t* col0, void* stream) {
    if ((long long)h * w * d == 0) return 0;
    huffman_restore_col0_kernel<<<d, ROW_THREADS, 0, (cudaStream_t)stream>>>(
        sym, h, w, offset, col0);
    return (int)cudaGetLastError();
}

extern "C" int huffman_restore_delta(const uint8_t* sym, const uint8_t* col0, int h, int w,
                                     int d, int offset, uint8_t* img, void* stream) {
    if ((long long)h * w * d == 0) return 0;
    huffman_restore_delta_kernel<<<dim3(h, d), ROW_THREADS, 0, (cudaStream_t)stream>>>(
        sym, col0, h, w, d, offset, img);
    return (int)cudaGetLastError();
}

extern "C" int huffman_restore_masked(const uint8_t* sym, const uint8_t* mask,
                                      const int* chunk_base, long long npx, int d, int offset,
                                      uint8_t* img, void* stream) {
    if (npx * d == 0) return 0;
    huffman_restore_masked_kernel<<<grid_of((npx + CHUNK - 1) / CHUNK, 1), CHUNK, 0,
                                    (cudaStream_t)stream>>>(sym, mask, chunk_base, npx, d,
                                                            offset, img);
    return (int)cudaGetLastError();
}

extern "C" int huffman_restore_delta_masked(const uint8_t* sym, const uint8_t* mask, int h,
                                            int w, int d, int offset, uint8_t* img,
                                            void* stream) {
    if ((long long)h * w * d == 0) return 0;
    huffman_restore_delta_masked_kernel<<<d, SEG_THREADS, 0, (cudaStream_t)stream>>>(
        sym, mask, h, w, d, offset, img);
    return (int)cudaGetLastError();
}
