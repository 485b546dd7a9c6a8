// H1-H4: whole-image Huffman of 8-bit bands (Lerc2.cpp:2311-2606).
//
// Replaces lerc_tpu/ops/device_huffman.py. The TPU version routes every
// byte through bf16 matmuls (nibble-factored histograms and table lookups,
// one-hot group packing, static roll chains); here the same functions are
// shared-memory tables, warp scans, ballots and atomics.
//
//   H1 huffman_symbols        symbol_streams_device :50, histogram256 :118: one thread
//                             per pixel (all depths): direct symbols pixel-major,
//                             delta symbols depth-major, both 256-bin histograms
//                             (warp-aggregated shared atomics, one global add per
//                             bin and CTA).
//      huffman_symbols_masked symbol_streams_masked_device :72 + histogram256. Bound:
//                             bytes, 4 nv D + H W + 2 nv D (the valid pixels' words
//                             and the mask read, their symbols written): 0.0207 ms
//                             for the bench mask's 2048^2 x 3 tile at 3.35 TB/s (H100
//                             SXM). Torch glue for the chunks' ranks and last valid
//                             pixels (ten ops, 0.11 ms) before a kernel of a serial
//                             loop over warps, __match_any_sync per symbol and
//                             scattered byte stores (0.10 ms) took 0.21 ms. Now a
//                             memset and one kernel: tiles of 2,048 pixels in ticket
//                             order, a thread's 16 pixels by one 16-byte mask load
//                             and 16-byte data loads, one byte a depth; each tile's
//                             rank base and the last valid pixel before it from a
//                             decoupled look-back over (count, last valid) pairs
//                             (sum and max: a long invalid stretch carries "last"
//                             across tiles); the sources' loads issued before any
//                             symbol; the tile's symbols staged in shared memory and
//                             stored contiguously (its valid ranks are consecutive),
//                             the zero tails shared out by invalid pixels; one
//                             shared histogram, flushed once a CTA.
//   H2 huffman_encode         encode_stream_device :160 (+ _map256 :141): a memset and
//                             one kernel. Bound: bytes, n + 2048 + 4 g + 2 bits / 8
//                             (the symbols and the table read, sbits written, the
//                             words zeroed by the memset and written). Tiles of
//                             8,192 symbols in ticket order, the grid filling the
//                             SMs, each CTA fetching its next tile's ticket and
//                             symbols while it codes one: 16 symbols a thread by
//                             one 16-byte load, their live bits
//                             stepped from one i % plane, lengths and codes from a
//                             shared table, a block scan, the codes MSB-first
//                             (Huffman.h:218-255) into a shared word buffer, a
//                             look-back over the tiles' bits (each group's sbits,
//                             the total), the buffer stored shifted into place
//                             (16 bytes where aligned), its two edge words
//                             atomicOr'd into the zeroed output.
//   H3 huffman_decode         decode_stream_device :278: one thread per 64-symbol
//                             group, its symbols a serial chain. Bound: bytes,
//                             total / 8 + 8 g + n (stream, sbits and used, the
//                             symbols). (1) huffman_decode_table_kernel builds
//                             the decode table once a call into scratch: per
//                             12-bit prefix the shortest code length <= 12
//                             matching it and its symbol, as the canonical
//                             search finds it, and the present lengths past
//                             12 (12 bits: 11 left 1.4% of an fpl plane's
//                             symbols to the search and doubled its time; 13
//                             only grew the copies). (2) A CTA of 128
//                             consecutive groups copies the table (9 KB) and
//                             stages its groups' stream span, from sbits[g0]
//                             to a group's reach past the next CTA's first
//                             start (contiguous bits), with 16-byte loads
//                             behind one barrier (clamped to 10 KB and to the
//                             stream; a group whose words lie outside reads
//                             global memory, bounds-checked: the sidecar may be
//                             hostile). (3) A thread decodes its group, four
//                             symbols a u32 into a padded shared buffer: where
//                             every code is <= 12 bits, every position live,
//                             the stream long enough and the words staged, a
//                             fast loop of a funnel shift, one table lookup and
//                             a refill every 32 bits (a miss, only on a corrupt
//                             stream, goes back to the checked loop); else the
//                             checked loop with liveness as 64 bits computed
//                             once (one i % plane), the search over the present
//                             lengths past 12 (u32/int64, so lengths 31 and 32
//                             work; the order of the search unchanged) and the
//                             stream's end. (4) The CTA stores its [groups * 64]
//                             bytes as side-by-side 16-byte stores. ok drops on
//                             a negative start, a live prefix matching no code,
//                             a code past n_bits, sbits[0] != 0 or a group
//                             whose bits do not end where the next group's
//                             begin.
//   H4 huffman_restore        symbols_to_image :476 direct: img = (sym - offset) & 0xFF
//                             on the pixel-major symbols. Bound: bytes, 2n (n
//                             read, n written). One thread per 16 bytes, no
//                             grid-stride cap: a 16-byte load (two aligned ones
//                             and a funnel shift where sym is a view at an
//                             unaligned offset), __vsub4 per word, one aligned
//                             16-byte store; the last partial 16 bytes one at a
//                             time.
//      huffman_restore_col0   symbols_to_image delta, column 0: a mod-256 scan down
//                             column 0 of every depth. Bound: latency (2 D H bytes,
//                             one strided byte a row and depth). A CTA of 128
//                             threads per 128 rows (more rows a thread past 16,384
//                             rows, at most 128 CTAs, all resident), each thread
//                             one row's column-0 bytes of up to four depths in one
//                             u32 (SWAR byte adds; D > 4 in groups of four); a CTA
//                             publishes its total in a slot the entry point
//                             zeroes first (one memset) and adds the totals of
//                             the CTAs before it (one pass, no second kernel;
//                             one CTA for all rows took 0.0061 ms at 2048 x 3,
//                             its loads serialized on one SM).
//      huffman_restore_delta  symbols_to_image delta, the rows: a mod-256 inclusive
//                             scan along each row from col0, written
//                             pixel-interleaved [H, W, D]. Bound: bytes, 2n + D*H.
//                             A CTA owns whole rows with all their depths and walks
//                             them as tiles of up to 2,048 consecutive pixels (a
//                             tile may hold several short rows, a long row several
//                             tiles). Each thread takes 16 pixels: one 16-byte load
//                             per depth slice, the bytes of four depths transposed
//                             into one u32 per pixel, one segmented scan for the
//                             four (SWAR byte adds: each byte mod 256, no carry
//                             between them; segments start at column 0, whose
//                             value is col0's), thread prefix in registers, then
//                             warp shuffles and shared memory across the CTA; the
//                             value of each depth carries from tile to tile. The
//                             scanned pixels go into a shared buffer as the tile's
//                             [pixels, D] bytes, stored with aligned 16-byte stores
//                             (a funnel shift where the tile's first byte is not
//                             16-aligned; the ends one byte at a time). D > 4 goes
//                             in groups of four depths, with byte writes into the
//                             buffer; D > 8 shrinks the tile to keep the buffer
//                             near 16 KB. The grid fills the SMs' resident CTAs and
//                             strides over the row groups beyond.
//      huffman_restore_masked expand_compacted_device :389: valid p <- sym[rank(p)];
//      huffman_restore_delta_masked
//                             undelta_masked_device :432 (and the host segment table
//                             _masked_delta_segments, codec/device_codec.py:750).
//                             Bound: bytes, nv D + H W + H W D (the live symbols and
//                             the mask read, the image written): 0.0083 ms for the
//                             bench mask's 2048^2 x 3 tile at 3.35 TB/s (H100
//                             SXM). Rows in order on D CTAs took 4.52 ms there: a
//                             row a step, latency bound. In rank space, four
//                             kernels and a memset, the grid scaling with the
//                             pixels and no loop over rows: (1) a CTA per 4,096
//                             pixels in ticket order: valid and use-above bits
//                             (left invalid or column 0, above valid) by 16-byte
//                             mask loads, their counts scanned and looked back 32
//                             chunks a step (a warp) into each 16-pixel group's
//                             rank and segment base; the chunk's deltas (ranks
//                             consecutive) by one 16-byte load a depth, four
//                             depths a u32 (SWAR), scanned and looked back: s, the
//                             prefix sum in rank space, written at each valid
//                             pixel with 16-byte stores; (2) a thread per group:
//                             each use-above pixel p records its segment's parent
//                             (the segment of p - w) and c = s(p - w) - s(p) +
//                             e(p); (3) the segment forest by pointer jumping in
//                             place, no rounds (a word is always a true partial
//                             sum, so stale reads only slow it); (4) each valid
//                             pixel gets its segment's base added. No limit on
//                             the number of segments (JAX stops at 2^16).
//
// Bounds: bytes throughout (8-bit symbols, a few integer operations each).
// H3's groups are serial chains: their time is latency, above the bytes
// bound.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"  // Seg, seg_combine, block_seg_excl (sums here)

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int GROUP = 64;
constexpr int CHUNK = 256;            // pixels per rank chunk = H1's (all-valid) CTA
constexpr int H1M_THREADS = 128, H1M_PX = 16 * H1M_THREADS;  // H1 masked: a tile
constexpr int MAX_GRID = 1056;        // 8 CTAs on each of 132 SMs (grid-stride beyond)
constexpr int ENC_THREADS = 512, ENC_T = 16 * ENC_THREADS;  // H2: a tile of symbols
constexpr int ENC_BUF = ENC_T + 4;    // a tile's words (32 bits a symbol) and two zero words
constexpr int DEC_THREADS = 128;        // H3: groups a CTA, one a thread
constexpr int DEC_K = 12;               // H3's table: one entry per 12-bit prefix (8 KB)
constexpr int DEC_SPAN = 67;            // words a group may read: 2,048 bits from bit 31 on
constexpr int DEC_STAGE_WORDS = 20 * DEC_THREADS + 96;  // 10 bits a symbol and a group's reach
constexpr int DEC_OUT_ROW = 17;         // a group's u32 words in the output buffer, padded (1)
constexpr int COL_THREADS = 128, COL_MAX_CTAS = 128;  // column 0's scan
constexpr int RST_THREADS = 128;                   // the all-valid restores: 16 bytes a thread
constexpr int RST_PX = 16 * RST_THREADS;           // pixels a delta tile (D <= 8)
constexpr int RST_BUF = 16384;                     // the delta buffer's bytes for D > 8
constexpr int UD_THREADS = 256, UD_PX = 16 * UD_THREADS;  // the masked un-delta's chunk

unsigned grid_of(long long n, int per) {
    const long long g = (n + per - 1) / per;
    return (unsigned)(g < MAX_GRID ? g : MAX_GRID);
}

// ---------------------------------------------------------------------------
// shared by H1 (masked) and H4 (masked): decoupled look-back, mask bits, tile stores
// ---------------------------------------------------------------------------

constexpr unsigned long long UD_AGG = 1, UD_INC = 2;  // look-back states; 0: not yet published

// lane 0 of chunk c publishes the chunk's total: as its inclusive prefix
// for chunk 0, else as an aggregate for the look-back of the chunks after it
template <class L>
__device__ __forceinline__ void lookback_publish(unsigned long long* lb, int c,
                                                 typename L::T tot) {
    if ((threadIdx.x & 31) == 0) atomicExch(lb + c, L::word(c == 0 ? UD_INC : UD_AGG, tot));
}

// warp 0 of chunk c, after lookback_publish: a decoupled look-back 32
// chunks a step (chunks run in ticket order, so every chunk waited on has
// started): each lane waits for one chunk's word, the nearest inclusive
// prefix ends the walk, and the warp folds the words up to it (the
// combines are commutative); publish the inclusive prefix. Returns the
// exclusive prefix in every lane.
template <class L>
__device__ typename L::T lookback_walk(unsigned long long* lb, int c, typename L::T tot) {
    using T = typename L::T;
    const int lane = threadIdx.x & 31;
    if (c == 0) return T(0);
    T acc = T(0);
    for (int base = c - 1;; base -= 32) {
        const int j = base - lane;
        unsigned long long x = L::word(UD_INC, T(0));  // before chunk 0: nothing
        if (j >= 0) {
            const volatile unsigned long long* q = lb + j;
            do x = *q; while (x == 0);
        }
        const unsigned inc = __ballot_sync(FULL, L::state(x) == UD_INC);
        const int stop = inc ? __ffs(inc) - 1 : 31;  // the nearest inclusive prefix
        T v = lane <= stop ? L::value(x) : T(0);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v = L::f(v, __shfl_xor_sync(FULL, v, o));
        acc = L::f(acc, v);
        if (inc) break;
    }
    if (lane == 0) atomicExch(lb + c, L::word(UD_INC, L::f(acc, tot)));
    return acc;
}

// warp 0 of chunk c (H1's masked tiles, the masked un-delta's chunks):
// publish the chunk's total, then the look-back. Returns the exclusive
// prefix in every lane.
template <class L>
__device__ typename L::T ud_lookback(unsigned long long* lb, int c, typename L::T tot) {
    lookback_publish<L>(lb, c, tot);
    return lookback_walk<L>(lb, c, tot);
}

// bit j: mask[p + j] != 0, for the n (0..16) pixels from p (>= 0)
__device__ __forceinline__ unsigned mask_bits16(const uint8_t* __restrict__ mask, long long p,
                                                int n) {
    if (n <= 0) return 0;
    const uint4 v = load16(mask + p, n);
    const unsigned wd[4] = {v.x, v.y, v.z, v.w};
    unsigned bits = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bytes of 0 or 0xFF -> one bit each
        const unsigned b = __vcmpne4(wd[i], 0u) & 0x01010101u;
        bits |= ((b * 0x01020408u) >> 24 & 0xFu) << (4 * i);
    }
    return n < 16 ? bits & ((1u << n) - 1u) : bits;
}

// buf's n bytes to dst (any alignment): aligned 16-byte stores, each taken
// from two aligned 16-byte reads of buf (which holds 16 bytes past n,
// rounded up to 16), and the two ends one byte at a time; the CTA's
// THREADS threads share the work
template <int THREADS>
__device__ __forceinline__ void store_tile(const uint8_t* buf, uint8_t* dst, long long n) {
    const int sh = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
    uint4* base = reinterpret_cast<uint4*>(dst - sh);  // chunk m: dst bytes [16m - sh, 16m - sh + 16)
    const uint4* b4 = reinterpret_cast<const uint4*>(buf);
    const long long m_hi = (n + sh) / 16;              // the chunks that end inside n
    for (long long m = (sh ? 1 : 0) + threadIdx.x; m < m_hi; m += THREADS)
        base[m] = sh ? shift16(b4[m - 1], b4[m], 16 - sh) : b4[m];
    const long long head = min(n, (long long)((16 - sh) & 15));
    const long long tail = max(head, 16 * m_hi - sh);
    for (long long i = threadIdx.x; i < head; i += THREADS) dst[i] = buf[i];
    for (long long i = tail + threadIdx.x; i < n; i += THREADS) dst[i] = buf[i];
}

// n zero bytes at dst (any alignment): aligned 16-byte stores and the two
// ends one byte at a time, shared by the CTA's THREADS threads
template <int THREADS>
__device__ __forceinline__ void zero_bytes(uint8_t* dst, long long n) {
    if (n <= 0) return;
    const long long head = min(n, (long long)((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15));
    const long long nb = (n - head) / 16;
    uint4* body = reinterpret_cast<uint4*>(dst + head);
    for (long long m = threadIdx.x; m < nb; m += THREADS) body[m] = make_uint4(0, 0, 0, 0);
    for (long long i = threadIdx.x; i < head; i += THREADS) dst[i] = 0;
    for (long long i = head + 16 * nb + threadIdx.x; i < n; i += THREADS) dst[i] = 0;
}

// ---------------------------------------------------------------------------
// H1
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(CHUNK) huffman_symbols_kernel(
        const int* __restrict__ data, int h, int w, int d, int offset, long long n_chunks,
        uint8_t* __restrict__ direct, uint8_t* __restrict__ delta, int* __restrict__ histos) {
    __shared__ unsigned hist[2 * 256];
    const int tid = threadIdx.x, lane = tid & 31;
    for (int i = tid; i < 512; i += CHUNK) hist[i] = 0;
    __syncthreads();
    const long long npx = (long long)h * w;
    for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
        const long long p = c * CHUNK + tid;
        const bool v = p < npx;
        const unsigned act = __ballot_sync(FULL, v);
        if (!v) continue;
        const long long row = p / w, col = p - row * w;
        const long long src = col > 0 ? p - 1 : (row > 0 ? p - w : -1);  // -1: none (0)
        for (int k = 0; k < d; ++k) {
            const int x = data[p * d + k];
            const int prev = src >= 0 ? data[src * d + k] : 0;
            const unsigned sd = (unsigned)(x + offset) & 0xFFu;
            const unsigned se = (unsigned)(x - prev + offset) & 0xFFu;
            direct[p * d + k] = (uint8_t)sd;
            delta[k * npx + p] = (uint8_t)se;
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

// H1 masked: the look-back word of a tile, (1 + its last valid pixel) << 32 |
// its valid pixels; the combine takes the later last (the max) and the sum
// of the counts. Word: state << 62 | (1 + last) << 31 | count (each < 2^31).
struct H1Look {
    using T = unsigned long long;
    __device__ static unsigned long long state(unsigned long long x) { return x >> 62; }
    __device__ static T value(unsigned long long x) {
        return (x >> 31 & 0x7FFFFFFFull) << 32 | (x & 0x7FFFFFFFull);
    }
    __device__ static unsigned long long word(unsigned long long st, T v) {
        return st << 62 | (v >> 32) << 31 | (v & 0xFFFFFFFFull);
    }
    __device__ static T f(T a, T b) {
        const unsigned long long hi = a >> 32 > b >> 32 ? a >> 32 : b >> 32;
        return hi << 32 | (unsigned)((unsigned)a + (unsigned)b);
    }
};

// the low bytes of D int32 words, byte k from word k
template <int D>
__device__ __forceinline__ unsigned pack_bytes(const int* v) {
    unsigned r = 0;
#pragma unroll
    for (int k = 0; k < D; ++k) r |= ((unsigned)v[k] & 0xFFu) << (8 * k);
    return r;
}

// pixel q's D values (int32 words at q * D) packed: one load a depth
template <int D>
__device__ __forceinline__ unsigned pixel_bytes(const int* __restrict__ data, long long q) {
    int v[D];
#pragma unroll
    for (int k = 0; k < D; ++k) v[k] = __ldg(data + q * D + k);
    return pack_bytes<D>(v);
}

// One CTA per tile of H1M_PX pixels at a time, tiles in ticket order (the
// grid strides over them; the histograms stay in shared memory until the
// CTA is done). Thread t takes pixels 16t .. 16t + 15 of the tile: its valid
// bits and those of the row above by 16-byte mask loads, its pixels' D
// words (D = 1..4) by 16-byte loads, packed one byte a depth. The tile's
// valid count and last valid pixel, scanned over the threads and looked
// back over the tiles before it (H1Look), give each pixel its rank and the
// last valid pixel before it. The delta's source is the left pixel if
// valid, else the one above if valid (row > 0), else the last valid pixel
// (none: 0); every source load is issued before any symbol is made. The
// tile's valid pixels have the consecutive ranks R .. R + c - 1, so its
// direct symbols ([R D, (R + c) D)) and each depth's delta symbols
// ([k npx + R, + c)) are staged in shared memory and stored contiguously;
// the zero tails (ranks nv .. npx - 1 of each stream, bytes npx D ..
// n_pad) are shared out by invalid pixels: a tile with inv invalid pixels
// and g before it zeroes ranks [npx - g - inv, npx - g). Histograms: one in
// shared memory, a shared atomic a symbol (lanes on one bin cost less than
// lanes on one bank; copies by lane were slower). D = 0: any depth, four
// depths a group, data and sources read by 4-byte loads, direct symbols
// stored in place.
template <int D>
__global__ void __launch_bounds__(H1M_THREADS) huffman_symbols_masked_kernel(
        const int* __restrict__ data, const uint8_t* __restrict__ mask, int h, int w, int d,
        int offset, int n_tiles, unsigned long long* lb, int* __restrict__ histos,
        uint8_t* __restrict__ direct, uint8_t* __restrict__ delta, long long n_pad) {
    constexpr int WARPS = H1M_THREADS / 32, DS = D ? D : 4;
    __shared__ unsigned hist[512];
    __shared__ __align__(16) uint8_t sdir[D ? H1M_PX * D + 16 : 16];
    __shared__ __align__(16) uint8_t sdel[DS][H1M_PX + 16];
    __shared__ unsigned long long sm64[2 * (WARPS + 1)];
    __shared__ unsigned svb[H1M_THREADS];
    __shared__ unsigned long long sh_pre;
    __shared__ int sh_t;
    const int tid = threadIdx.x, lane = tid & 31;
    for (int i = tid; i < 512; i += H1M_THREADS) hist[i] = 0;
    const long long npx = (long long)h * w;
    for (;;) {
        if (tid == 0) sh_t = (int)atomicAdd(lb + n_tiles, 1ULL);  // the ticket
        __syncthreads();
        const int t = sh_t;
        if (t >= n_tiles) break;
        const long long tp0 = (long long)t * H1M_PX, p0 = tp0 + 16 * tid;
        const int tpx = (int)min((long long)H1M_PX, npx - tp0);
        const int cnt = (int)max(0LL, min(16LL, npx - p0));
        const unsigned vb = mask_bits16(mask, p0, cnt);
        unsigned ab = 0;  // bit j: pixel p0 + j - w is valid (row > 0)
        if (p0 >= w) {
            ab = mask_bits16(mask, p0 - w, cnt);
        } else {
            for (int j = 0; j < cnt; ++j)
                if (p0 + j >= w && mask[p0 + j - w]) ab |= 1u << j;
        }
        const bool pv0 = tid == 0 && p0 > 0 && cnt > 0 && mask[p0 - 1];  // thread 0's left
        unsigned xp[16];  // D > 0: pixel j's D bytes (depth k in byte k)
        unsigned xl = 0;  // the same of the pixel before p0
        if constexpr (D > 0) {
            const uint8_t* src = reinterpret_cast<const uint8_t*>(data + p0 * D);
            const int nbytes = 4 * D * cnt;
            int x[16 * D];  // pixel j's depth k at x[j * D + k]
#pragma unroll
            for (int m = 0; m < D * 4; ++m) {  // 16 bytes: words 4m .. 4m + 3
                const uint4 v = 16 * m < nbytes ? load16(src + 16 * m, min(16, nbytes - 16 * m))
                                                : make_uint4(0, 0, 0, 0);
                x[4 * m] = (int)v.x, x[4 * m + 1] = (int)v.y;
                x[4 * m + 2] = (int)v.z, x[4 * m + 3] = (int)v.w;
            }
#pragma unroll
            for (int j = 0; j < 16; ++j) xp[j] = pack_bytes<D>(x + j * D);
            xl = __shfl_up_sync(FULL, xp[15], 1);
            if (lane == 0) xl = p0 > 0 && cnt > 0 ? pixel_bytes<D>(data, p0 - 1) : 0u;
        }
        const int nvt = __popc(vb);
        unsigned long long tot;
        const unsigned long long ex = block_excl<H1M_THREADS, H1Look>(
                (unsigned long long)(vb ? p0 + 32 - __clz(vb) : 0) << 32 | (unsigned)nvt, tot,
                sm64);
        if (tid < 32) {
            const unsigned long long pre = ud_lookback<H1Look>(lb, t, tot);
            if (tid == 0) sh_pre = pre;
        }
        svb[tid] = vb;
        __syncthreads();
        const unsigned long long pre = sh_pre, thr = H1Look::f(pre, ex);
        const long long R = (unsigned)pre;                  // the tile's first rank
        const int c = (int)(unsigned)tot;                   // its valid pixels
        const int rl0 = (int)(unsigned)ex;                  // the thread's first rank in the tile
        const long long qt = (long long)(thr >> 32) - 1;    // the last valid pixel before p0
        const bool pv = tid > 0 ? (svb[tid - 1] >> 15 & 1u) : pv0;
        unsigned col0 = 0;  // bit j: pixel j is a row's column 0
        if (cnt > 0) {
            const long long cf = p0 % w;
            for (long long j = cf ? w - cf : 0; j < 16; j += w) col0 |= 1u << j;
        }
        const unsigned left = (vb << 1 | (pv ? 1u : 0u)) & ~col0;
        const unsigned up = vb & ~left & ab;  // the delta taken against the pixel above
        auto last_before = [&](int j) -> long long {  // else the last valid pixel before it
            const unsigned below = vb & ((1u << j) - 1u);
            return below ? p0 + 31 - __clz(below) : qt;
        };
        if constexpr (D > 0) {
            const unsigned flip = offset ? 0x80808080u : 0u;
            unsigned pp[16];  // the sources' bytes: every load issued before any is used
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                pp[j] = j ? xp[j - 1] : xl;
                if ((vb & ~left) >> j & 1u) {
                    const long long q = up >> j & 1u ? p0 + j - w : last_before(j);
                    pp[j] = q >= 0 ? pixel_bytes<D>(data, q) : 0u;
                }
            }
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                if (!(vb >> j & 1u)) continue;
                const int rl = rl0 + __popc(vb & ((1u << j) - 1u));
                const unsigned sd = xp[j] ^ flip, se = __vsub4(xp[j], pp[j]) ^ flip;
#pragma unroll
                for (int i = 0; i < D; ++i) {
                    const unsigned a = sd >> (8 * i) & 0xFFu, e = se >> (8 * i) & 0xFFu;
                    sdir[rl * D + i] = (uint8_t)a;
                    sdel[i][rl] = (uint8_t)e;
                    atomicAdd(&hist[a], 1u);
                    atomicAdd(&hist[256 + e], 1u);
                }
            }
        }
        for (int k0 = 0; k0 < (D ? D : d); k0 += DS) {
            const int kn = D ? D : min(4, d - k0);
            if constexpr (D == 0) {  // any depth, four a group: 4-byte loads, direct in place
                for (int j = 0; j < 16; ++j) {
                    if (!(vb >> j & 1u)) continue;
                    const long long p = p0 + j;
                    const int rl = rl0 + __popc(vb & ((1u << j) - 1u));
                    const long long q = left >> j & 1u ? p - 1
                                        : up >> j & 1u ? p - w : last_before(j);
                    for (int i = 0; i < kn; ++i) {
                        const int k = k0 + i, xv = data[p * d + k];
                        const int pw = q >= 0 ? data[q * d + k] : 0;
                        const unsigned a = ((unsigned)xv + offset) & 0xFFu;
                        const unsigned e = ((unsigned)(xv - pw) + offset) & 0xFFu;
                        direct[(R + rl) * d + k] = (uint8_t)a;
                        sdel[i][rl] = (uint8_t)e;
                        atomicAdd(&hist[a], 1u);
                        atomicAdd(&hist[256 + e], 1u);
                    }
                }
            }
            __syncthreads();
            const long long gap = tp0 - R, inv = tpx - c;  // invalid pixels before and in the tile
            const long long z0 = npx - gap - inv;           // its share of the zero tails
            for (int i = 0; i < kn; ++i) {
                store_tile<H1M_THREADS>(sdel[i], delta + (k0 + i) * npx + R, c);
                zero_bytes<H1M_THREADS>(delta + (k0 + i) * npx + z0, inv);
            }
            if (k0 == 0) {
                if constexpr (D > 0)
                    store_tile<H1M_THREADS>(sdir, direct + R * D, (long long)c * D);
                zero_bytes<H1M_THREADS>(direct + z0 * d, inv * d);
                if (t == n_tiles - 1) {  // past the last pixel: to whole groups
                    zero_bytes<H1M_THREADS>(direct + npx * d, n_pad - npx * d);
                    zero_bytes<H1M_THREADS>(delta + npx * d, n_pad - npx * d);
                }
            }
            __syncthreads();  // the buffers and sh_t are the next group's or tile's
        }
    }
    for (int i = tid; i < 512; i += H1M_THREADS)
        if (hist[i]) atomicAdd(&histos[i], (int)hist[i]);
}

// ---------------------------------------------------------------------------
// H2
// ---------------------------------------------------------------------------

// H2's look-back word: state << 62 | the tiles' bits so far (< 2^62)
struct H2Look {
    using T = unsigned long long;
    __device__ static unsigned long long state(unsigned long long x) { return x >> 62; }
    __device__ static T value(unsigned long long x) { return x & ((1ULL << 62) - 1); }
    __device__ static unsigned long long word(unsigned long long st, T v) { return st << 62 | v; }
    __device__ static T f(T a, T b) { return a + b; }
};

// A tile of ENC_T symbols at a time per CTA, tiles in ticket order; the
// grid fills the SMs and each CTA loops, taking the next tile's ticket and
// loading its symbols while it codes the current one (so neither waits on a
// round trip to memory), the code table loaded into shared memory once.
// Thread t takes symbols 16t .. 16t + 15 of a tile by one 16-byte load;
// their live bits from one i % plane (none where the plane holds the
// whole stream) stepped across the 16 (is_live: i < n_total and i % plane <
// n_live); each symbol's length and MSB-aligned code by one 8-byte lookup
// in the shared table. A block scan of the threads' bits gives
// each thread its offset in the tile and the tile's total, published at
// once for the look-back of the tiles after it. The tile then packs its
// codes, MSB-first, into a shared word buffer from the tile's own bit 0 (so
// the pack waits on no other tile): each thread ORs its codes into two
// register words, the current one and the next, and flushes each full word
// with a plain store (the word is its own), its first word, when it starts
// mid-word, and its last, partial one with atomicOr (the neighbours'
// words). Only then does warp 0 walk back
// over the tiles' totals (H2Look) for the tile's first bit P. Every fourth
// thread starts a 64-symbol group and writes its sbits = P + its offset.
// The buffer goes out shifted by P mod 32 (funnel shifts of neighbouring
// words): the words strictly inside the tile's bits with plain stores, 16
// bytes where four lie inside, its first and last words, which tiles
// before and after it may share (several, where tiles with no live symbol
// lie between), with atomicOr into out, zeroed by the entry point's one
// memset, which also zeroes the words past the last code. The last tile
// writes the total bits.
__device__ __forceinline__ uint4 tile_symbols(const uint8_t* __restrict__ sym, long long n_sym,
                                              long long i0) {
    return i0 < n_sym ? load16(sym + i0, (int)min(16LL, n_sym - i0)) : make_uint4(0, 0, 0, 0);
}

__global__ void __launch_bounds__(ENC_THREADS) huffman_encode_kernel(
        const uint8_t* __restrict__ sym, long long n_sym, const int* __restrict__ table,
        long long n_total, long long plane, long long n_live, int n_tiles, long long n_groups,
        unsigned long long* lb, int* __restrict__ sbits, unsigned* __restrict__ out,
        long long cap_words, int* __restrict__ total) {
    __shared__ uint2 lc[256];                       // (length, the code MSB-aligned)
    __shared__ __align__(16) unsigned buf[ENC_BUF]; // word 0 zero, the tile's words from 1
    __shared__ unsigned sm[ENC_THREADS / 32 + 1];
    __shared__ unsigned long long sh_pre;
    __shared__ int sh_t, sh_next;
    const int tid = threadIdx.x;
    if (tid == 0) sh_t = (int)atomicAdd(lb + n_tiles, 1ULL);  // the first ticket
    for (int i = tid; i < 256; i += ENC_THREADS) {
        const int L = table[i];
        const unsigned c = (unsigned)table[256 + i];
        lc[i] = make_uint2((unsigned)L, L <= 0 ? 0u : c << (32 - min(L, 32)));  // L bits kept
    }
    __syncthreads();
    int t = sh_t;
    uint4 v = tile_symbols(sym, n_sym, (long long)t * ENC_T + 16 * tid);
    while (t < n_tiles) {
        int next = 0;
        if (tid == 0) next = (int)atomicAdd(lb + n_tiles, 1ULL);  // used after the scan
        const long long i0 = (long long)t * ENC_T + 16 * tid;
        const unsigned sw[4] = {v.x, v.y, v.z, v.w};  // byte j of word j / 4: symbol i0 + j
        unsigned live = 0;                            // bit j: symbol i0 + j is live
        if (i0 < n_sym) {
            long long r = plane >= n_total ? i0 : i0 % plane;
            if (i0 + 16 <= n_total && r + 16 <= n_live) {
                live = 0xFFFFu;  // inside one plane's live run
            } else {
#pragma unroll
                for (int j = 0; j < 16; ++j) {
                    if (i0 + j < n_total && r < n_live) live |= 1u << j;
                    if (++r == plane) r = 0;
                }
            }
        }
        unsigned len[16], top[16], tb = 0;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const uint2 e = lc[__byte_perm(sw[j >> 2], 0, 0x4440 | (j & 3))];
            len[j] = e.x;
            top[j] = e.y;
        }
        if (live != 0xFFFFu) {  // dead symbols emit nothing
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                const bool on = live >> j & 1u;
                len[j] = on ? len[j] : 0u;
                top[j] = on ? top[j] : 0u;
            }
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) tb += len[j];
        unsigned tot;
        const unsigned ex = block_excl<ENC_THREADS>(tb, tot, sm);
        if (tid < 32) lookback_publish<H2Look>(lb, t, tot);
        if (tid == 0) sh_next = next;
        const int nz = (int)((tot + 31) >> 5) + 2;  // the tile's words, a zero word each side
        for (int i = tid; i < nz; i += ENC_THREADS) buf[i] = 0;
        __syncthreads();
        next = sh_next;
        v = tile_symbols(sym, n_sym, (long long)next * ENC_T + 16 * tid);  // the next tile's
        {
            unsigned* w = buf + 1 + (ex >> 5);
            unsigned fill = ex & 31;  // bits of the current word taken
            bool edge = fill != 0;  // the first word starts mid-word: the thread before shares it
            unsigned hi = 0, lo = 0;  // the current word and the next
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                hi |= top[j] >> fill;
                lo |= __funnelshift_r(0u, top[j], fill);
                fill += len[j];
                if (fill >= 32) {
                    if (edge) atomicOr(w, hi);
                    else *w = hi;
                    edge = false;
                    ++w;
                    hi = lo;
                    lo = 0;
                    fill -= 32;
                }
            }
            if (fill) atomicOr(w, hi);  // partial: the thread after may share it
        }
        if (tid < 32) {  // after the pack: a walk first stalled warp 0's share of it
            const unsigned long long pre = lookback_walk<H2Look>(lb, t, tot);
            if (tid == 0) sh_pre = pre;
        }
        __syncthreads();
        const unsigned long long P = sh_pre;
        if (tid == 0 && t == n_tiles - 1) *total = (int)(P + tot);
        const long long g = (long long)t * (ENC_T / GROUP) + tid / 4;
        if ((tid & 3) == 0 && g < n_groups) sbits[g] = (int)(P + ex);
        if (tot > 0) {
            // out word x (f <= x <= l) holds local bits 32 (x - f) - s .. + 31:
            // the low s bits of buffer word x - f (local word x - f - 1) and
            // the high 32 - s of the next
            const long long f = (long long)(P >> 5), l = (long long)((P + tot - 1) >> 5);
            const unsigned s = (unsigned)(P & 31);
            const long long c0 = f >> 2, nch = (l >> 2) - c0 + 1;
            for (long long c = tid; c < nch; c += ENC_THREADS) {
                const long long x0 = 4 * (c0 + c);
                if (x0 > f && x0 + 3 < l && x0 + 3 < cap_words) {
                    const unsigned* q = buf + (x0 - f);
                    reinterpret_cast<uint4*>(out)[x0 >> 2] = make_uint4(
                        __funnelshift_r(q[1], q[0], s), __funnelshift_r(q[2], q[1], s),
                        __funnelshift_r(q[3], q[2], s), __funnelshift_r(q[4], q[3], s));
                    continue;
                }
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const long long x = x0 + k;
                    if (x < f || x > l || x >= cap_words) continue;
                    const unsigned wv = __funnelshift_r(buf[x - f + 1], buf[x - f], s);
                    if (x == f || x == l) {
                        if (wv) atomicOr(out + x, wv);
                    } else {
                        out[x] = wv;
                    }
                }
            }
        }
        __syncthreads();  // the buffer and sh_pre are the next tile's
        t = next;
    }
}

// ---------------------------------------------------------------------------
// H3
// ---------------------------------------------------------------------------

// H3's decode table, built once a call (huffman_decode_table_kernel) and
// copied into each CTA's shared memory with 16-byte loads.
struct DecTable {
    uint16_t lut[1 << DEC_K];  // (length << 8) | symbol of the shortest code <= K; 0: none
    long long lfirst[32], llimit[32], lbase[32];  // the present lengths past K, ascending
    int llen[32];
    int n_long, pad[3];
    uint8_t syms[256];  // the canonical-order symbols
};
static_assert(sizeof(DecTable) % 16 == 0, "DecTable is copied as uint4");

__global__ void __launch_bounds__(256) huffman_decode_table_kernel(
        const long long* __restrict__ consts, const uint8_t* __restrict__ sorted_syms,
        DecTable* __restrict__ tab) {
    __shared__ long long cf[32], cl[32], cb[32];
    __shared__ uint8_t ss[256];
    const int tid = threadIdx.x;
    if (tid < 32) {  // a lane a length; the lengths past K compacted in order
        const int L = tid + 1;
        const long long f = consts[3 * L], lim = consts[3 * L + 1], bs = consts[3 * L + 2];
        cf[tid] = f;
        cl[tid] = lim;
        cb[tid] = bs;
        const bool is_long = lim > f && L > DEC_K;
        const unsigned longs = __ballot_sync(FULL, is_long);
        if (blockIdx.x == 0) {
            if (is_long) {
                const int j = __popc(longs & ((1u << tid) - 1u));
                tab->lfirst[j] = f;
                tab->llimit[j] = lim;
                tab->lbase[j] = bs;
                tab->llen[j] = L;
            }
            if (tid == 0) tab->n_long = __popc(longs);
        }
    }
    ss[tid] = sorted_syms[tid];
    if (blockIdx.x == 0) tab->syms[tid] = ss[tid];
    __syncthreads();
    const int p = blockIdx.x * 256 + tid;  // a K-bit prefix
    if (p >= (1 << DEC_K)) return;
    unsigned e = 0;
    for (int L = 1; L <= DEC_K; ++L) {  // the shortest matching length, as the search finds it
        const long long c = p >> (DEC_K - L);
        if (c >= cf[L - 1] && c < cl[L - 1]) {
            long long idx = cb[L - 1] + c - cf[L - 1];
            idx = idx < 0 ? 0 : (idx > 255 ? 255 : idx);
            e = ((unsigned)L << 8) | ss[idx];
            break;
        }
    }
    tab->lut[p] = (uint16_t)e;
}

// The canonical search over the present lengths past K of a prefix that no
// code of length <= K matches: (length << 8) | symbol, or 0 for none.
__device__ __forceinline__ unsigned search_long(unsigned peek, const DecTable& t) {
    for (int k = 0; k < t.n_long; ++k) {
        const long long c = (long long)(peek >> (32 - t.llen[k]));
        if (c >= t.lfirst[k] && c < t.llimit[k]) {
            long long idx = t.lbase[k] + c - t.lfirst[k];
            idx = idx < 0 ? 0 : (idx > 255 ? 255 : idx);
            return ((unsigned)t.llen[k] << 8) | t.syms[idx];
        }
    }
    return 0;
}

// The 64 positions of the group at i0 as bits: bit s set when i0 + s is live.
__device__ __forceinline__ unsigned long long live_bits(long long i0, long long n_total,
                                                        long long plane, long long n_live) {
    unsigned long long bits = 0;
    long long r = i0 % plane;  // once a group; the runs between plane boundaries below
    for (int s = 0; s < GROUP;) {
        const long long run = plane - r < GROUP - s ? plane - r : GROUP - s;
        long long nl = n_live - r;
        nl = nl < 0 ? 0 : (nl > run ? run : nl);
        if (nl > 0) bits |= (nl == GROUP ? ~0ull : (1ull << nl) - 1) << s;
        s += (int)run;
        r = 0;
    }
    const long long left = n_total - i0;
    if (left < GROUP) bits &= left > 0 ? (1ull << left) - 1 : 0ull;
    return bits;
}

// the symbol byte of e into byte j & 3 of v
__device__ __forceinline__ unsigned put_sym(unsigned v, unsigned e, int j) {
    const unsigned sel[4] = {0x3214u, 0x3240u, 0x3410u, 0x4210u};
    return __byte_perm(v, e, sel[j & 3]);
}

__global__ void __launch_bounds__(DEC_THREADS) huffman_decode_kernel(
        const unsigned* __restrict__ words, long long n_words, long long n_bits,
        const int* __restrict__ sbits, int n_groups, const DecTable* __restrict__ table,
        long long n_total, long long plane, long long n_live, uint8_t* __restrict__ syms,
        int* __restrict__ used_out, int* __restrict__ ok) {
    __shared__ __align__(16) DecTable tab;
    __shared__ __align__(16) unsigned stage[DEC_STAGE_WORDS];
    __shared__ unsigned obuf[DEC_THREADS * DEC_OUT_ROW];
    const int tid = threadIdx.x;
    const int g0 = blockIdx.x * DEC_THREADS;
    const int n_out = n_groups - g0 < DEC_THREADS ? n_groups - g0 : DEC_THREADS;

    // the table, and the CTA's stream span, words [s_lo, s_lo + n_stage): from the
    // 16-aligned word at or below its first group's start to a group's reach past the
    // next CTA's first start (the sidecar may be hostile: clamped to the buffer and,
    // word by word at the ends, to [0, n_words)); one barrier for both
#pragma unroll 4
    for (int i = tid; i < (int)(sizeof(DecTable) / 16); i += DEC_THREADS)
        reinterpret_cast<uint4*>(&tab)[i] = __ldg(reinterpret_cast<const uint4*>(table) + i);
    const long long b0 = sbits[g0];
    const long long b1 = g0 + DEC_THREADS < n_groups ? sbits[g0 + DEC_THREADS] : n_bits;
    long long w_lo = b0 < 0 ? 0 : b0 >> 5;
    if (w_lo > n_words) w_lo = n_words;
    const long long s_lo = w_lo - (long long)((reinterpret_cast<uintptr_t>(words + w_lo) >> 2) & 3);
    long long w_hi = b1 < 0 ? 0 : (b1 >> 5) + DEC_SPAN;
    if (w_hi > n_words) w_hi = n_words;
    long long span = w_hi - s_lo;
    span = span < 0 ? 0 : (span > DEC_STAGE_WORDS ? DEC_STAGE_WORDS : span);
    const int n_stage = (int)((span + 3) & ~3ll);
#pragma unroll 4
    for (int v = tid; v < n_stage / 4; v += DEC_THREADS) {
        const long long k = s_lo + 4 * v;
        uint4 x;
        if (k >= 0 && k + 4 <= n_words) {
            x = __ldg(reinterpret_cast<const uint4*>(words + k));
        } else {
            unsigned w4[4];
            for (int j = 0; j < 4; ++j) w4[j] = k + j >= 0 && k + j < n_words ? words[k + j] : 0u;
            x = make_uint4(w4[0], w4[1], w4[2], w4[3]);
        }
        reinterpret_cast<uint4*>(stage)[v] = x;
    }
    __syncthreads();

    const long long g = (long long)g0 + tid;
    if (tid < n_out) {
        const long long start = sbits[g];
        const long long w0 = start < 0 ? 0 : start >> 5;  // the group's first word
        // a group reads words w0 .. w0 + DEC_SPAN - 1 at most: staged, or from
        // global memory one at a time (words outside [0, n_words) read as 0)
        const long long r0 = w0 - s_lo;
        const bool staged = r0 >= 0 && r0 + DEC_SPAN <= n_stage;
        auto load = [&](int k) -> unsigned {
            if (staged) return stage[r0 + k];
            const long long w = w0 + k;
            return w >= 0 && w < n_words ? __ldg(words + w) : 0u;
        };
        const int p0 = start < 0 ? 0 : (int)(start & 31);  // the first bit, from word w0's first
        const long long rem = n_bits - start;  // the bits left: a group needs at most 2048
        const int lim = p0 + (int)(rem < 0 ? -1 : (rem > 4096 ? 4096 : rem));
        const unsigned long long live = live_bits(g * GROUP, n_total, plane, n_live);
        bool bad = start < 0;
        int p = p0;
        unsigned* out = obuf + tid * DEC_OUT_ROW;
        if (tab.n_long == 0 && !bad && staged && live == ~0ull
                && lim - p0 >= 2048) {
            // no code longer than K, every position live, the stream long enough, the
            // words staged: no test but the table's miss, which only a corrupt stream
            // meets and which goes back to the checked loop
            unsigned hi = stage[r0], lo = stage[r0 + 1];
            for (int c = 0; c < GROUP / 4; ++c) {  // four symbols a u32
                unsigned v = 0;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const unsigned peek = __funnelshift_l(lo, hi, p);  // the next 32 bits
                    const unsigned e = tab.lut[peek >> (32 - DEC_K)];
                    if (e == 0) goto checked;
                    const int np = p + (int)(e >> 8);
                    v = put_sym(v, e, j);
                    if ((np ^ p) >= 32) {  // into the next word
                        hi = lo;
                        lo = stage[r0 + (np >> 5) + 1];
                    }
                    p = np;
                }
                out[c] = v;
            }
            goto done;
        }
    checked:
        p = p0;
        {
            unsigned hi = load(0), lo = load(1);
            for (int c = 0; c < GROUP / 4; ++c) {
                const unsigned lc = (unsigned)(live >> (4 * c));
                unsigned v = 0;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    if (bad || !(lc & (1u << j))) continue;
                    const unsigned peek = __funnelshift_l(lo, hi, p);
                    unsigned e = tab.lut[peek >> (32 - DEC_K)];
                    if (e == 0) e = search_long(peek, tab);
                    const int np = p + (int)(e >> 8);
                    if (e == 0 || np > lim) {
                        bad = true;
                        continue;
                    }
                    v = put_sym(v, e, j);
                    if ((np ^ p) >= 32) {
                        hi = lo;
                        lo = load((np >> 5) + 1);
                    }
                    p = np;
                }
                out[c] = v;
            }
        }
    done:
        const int used = p - p0;
        used_out[g] = used;
        if (bad || (g == 0 && start != 0)
                || (g + 1 < n_groups && (long long)sbits[g + 1] - start != used))
            *ok = 0;
    }
    __syncthreads();  // the CTA's [n_out * 64] bytes, 16-byte stores side by side
    for (int i = tid; i < n_out * (GROUP / 16); i += DEC_THREADS) {
        const unsigned* r = obuf + (i >> 2) * DEC_OUT_ROW + 4 * (i & 3);
        reinterpret_cast<uint4*>(syms + (long long)g0 * GROUP)[i] =
            make_uint4(r[0], r[1], r[2], r[3]);
    }
}

// ---------------------------------------------------------------------------
// H4
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint4 vsub16(uint4 v, unsigned sub) {
    return make_uint4(__vsub4(v.x, sub), __vsub4(v.y, sub), __vsub4(v.z, sub), __vsub4(v.w, sub));
}

// img (16-aligned) [i] = sym[i] - offset mod 256, 16 bytes a thread
__global__ void __launch_bounds__(RST_THREADS) huffman_restore_kernel(
        const uint8_t* __restrict__ sym, long long n, int offset, uint8_t* __restrict__ img) {
    const long long i = ((long long)blockIdx.x * RST_THREADS + threadIdx.x) * 16;
    if (i + 16 <= n) {
        *reinterpret_cast<uint4*>(img + i) = vsub16(load16(sym + i, 16), offset * 0x01010101u);
    } else {
        for (long long j = i; j < n; ++j) img[j] = (uint8_t)((int)sym[j] - offset);
    }
}

// four bytes side by side, each added mod 256: the low seven bits add in
// place, the top bit as an XOR, so no carry crosses into the next byte
__device__ __forceinline__ unsigned add4(unsigned a, unsigned b) {
    return ((a & 0x7f7f7f7fu) + (b & 0x7f7f7f7fu)) ^ ((a ^ b) & 0x80808080u);
}

struct Add4 {
    using T = unsigned;
    __device__ static unsigned f(unsigned a, unsigned b) { return add4(a, b); }
};

// the column-0 symbols of row r of depths k0 .. k0 + nk - 1 (nk <= 4), minus
// the offset, one byte each in a u32; every load issued before any is used
__device__ __forceinline__ unsigned col0_word(const uint8_t* __restrict__ sym, long long plane,
                                              int w, int k0, int nk, int r, unsigned sub) {
    unsigned b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = i < nk ? sym[(k0 + i) * plane + (long long)r * w] : 0u;
    return __vsub4(b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24, sub);
}

// col0[k * h + r] = sum_{i <= r} e[k][i][0] (mod 256). CTA b scans `per`
// rows a thread from row b * COL_THREADS * per, four depths at once (SWAR
// byte adds), publishes its total in agg (zeroed first, so a slot's nonzero
// top half says published), and adds the totals of the CTAs before it; the
// grid is at most COL_MAX_CTAS CTAs of COL_THREADS threads, all resident at
// once, so no wait is on a CTA that has not started
__global__ void __launch_bounds__(COL_THREADS) huffman_restore_col0_kernel(
        const uint8_t* __restrict__ sym, int h, int w, int d, int offset, int per,
        unsigned long long* agg, uint8_t* __restrict__ col0) {
    __shared__ unsigned sm[2 * (COL_THREADS / 32 + 1)];
    const int b = blockIdx.x;
    const long long plane = (long long)h * w;
    const unsigned sub = (unsigned)offset * 0x01010101u;
    const int r0 = (b * COL_THREADS + threadIdx.x) * per;
    for (int k0 = 0; k0 < d; k0 += 4) {
        const int nk = min(4, d - k0);
        unsigned long long* slot = agg + (long long)(k0 / 4) * gridDim.x;
        unsigned t = 0;
        for (int i = 0; i < per && r0 + i < h; ++i)
            t = add4(t, col0_word(sym, plane, w, k0, nk, r0 + i, sub));
        unsigned tot, before = 0;
        const unsigned ex = block_excl<COL_THREADS, Add4>(t, tot, sm);
        if (threadIdx.x == 0) atomicExch(slot + b, 1ULL << 32 | tot);
        if (threadIdx.x < b) {  // CTA threadIdx.x's total, once published
            const volatile unsigned long long* q = slot + threadIdx.x;
            unsigned long long x;
            do x = *q; while (x >> 32 == 0);
            before = (unsigned)x;
        }
        unsigned base;
        block_excl<COL_THREADS, Add4>(before, base, sm);
        unsigned acc = add4(base, ex);
        for (int i = 0; i < per && r0 + i < h; ++i) {
            acc = add4(acc, col0_word(sym, plane, w, k0, nk, r0 + i, sub));
            for (int q = 0; q < nk; ++q)
                col0[(long long)(k0 + q) * h + r0 + i] = (uint8_t)(acc >> (8 * q));
        }
    }
}

// the 16 pixels' words x (depth k in byte k) interleaved as their 16 * D bytes
template <int D>
__device__ __forceinline__ void interleave(const unsigned* x, unsigned* y) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {  // pixels 4m .. 4m + 3 -> words D*m .. D*m + D - 1
        const unsigned a = x[4 * m], b = x[4 * m + 1], c = x[4 * m + 2], e = x[4 * m + 3];
        if constexpr (D == 4) {
            y[4 * m] = a, y[4 * m + 1] = b, y[4 * m + 2] = c, y[4 * m + 3] = e;
        } else if constexpr (D == 3) {
            y[3 * m] = __byte_perm(a, b, 0x4210);
            y[3 * m + 1] = __byte_perm(b, c, 0x5421);
            y[3 * m + 2] = __byte_perm(c, e, 0x6542);
        } else if constexpr (D == 2) {
            y[2 * m] = __byte_perm(a, b, 0x5410);
            y[2 * m + 1] = __byte_perm(c, e, 0x5410);
        } else {
            y[m] = __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, e, 0x0040), 0x5410);
        }
    }
}

// the same, stored at 16-aligned dst
template <int D>
__device__ __forceinline__ void put_pixels(const unsigned* x, uint8_t* dst) {
    uint4* o = reinterpret_cast<uint4*>(dst);
    unsigned y[4 * D];
    interleave<D>(x, y);
#pragma unroll
    for (int m = 0; m < D; ++m) o[m] = make_uint4(y[4 * m], y[4 * m + 1], y[4 * m + 2], y[4 * m + 3]);
}

// the 16 words' running mod-256 sums from acc, restarting at the words
// whose bit is set in starts; returns the last
template <bool KEEP>
__device__ __forceinline__ unsigned scan16(unsigned* x, unsigned starts, unsigned acc) {
    if (!starts) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            acc = add4(acc, x[j]);
            if (KEEP) x[j] = acc;
        }
    } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            acc = (starts >> j) & 1 ? x[j] : add4(acc, x[j]);
            if (KEEP) x[j] = acc;
        }
    }
    return acc;
}

// D = d (1..4): one group of depths, one u32 a pixel; D = 0: d > 4, in
// groups of four depths, written into the buffer a byte at a time. CTAs own
// `rows` whole rows each (all depths), walked as tiles of up to `px`
// consecutive pixels; thread t takes the tile's pixels 16t .. 16t + 15.
// flip: 0x80808080 for int8 (sym - 128 mod 256 is sym ^ 0x80), else 0.
template <int D>
__global__ void __launch_bounds__(RST_THREADS) huffman_restore_delta_kernel(
        const uint8_t* __restrict__ sym, const uint8_t* __restrict__ col0, int h, int w, int d,
        unsigned flip, int rows, int px, uint8_t* __restrict__ img) {
    __shared__ unsigned sm[2 * (RST_THREADS / 32 + 1)];
    extern __shared__ uint4 rst_smem[];  // the tile buffer, then the carries
    uint8_t* buf = reinterpret_cast<uint8_t*>(rst_smem);                    // [px, d] bytes
    unsigned* carry = reinterpret_cast<unsigned*>(buf + ((px * d + 15) & ~15) + 16);  // per group
    const int j0 = 16 * threadIdx.x;
    const long long plane = (long long)h * w;
    const int n_groups = D ? 1 : (d + 3) >> 2;
    const long long n_units = ((long long)h + rows - 1) / rows;
    for (long long u = blockIdx.x; u < n_units; u += gridDim.x) {
        const long long p_end = min((long long)h, (u + 1) * rows) * w;
        for (long long p0 = u * rows * w; p0 < p_end; p0 += px) {
            const int n_px = (int)min((long long)px, p_end - p0);
            const int cnt = max(0, min(16, n_px - j0));  // this thread's pixels
            const long long pf = p0 + j0;
            const long long r_tile = p0 / w;
            const int c_tile = (int)(p0 - r_tile * w) + j0;  // < w + px
            const long long rf = r_tile + c_tile / w;        // the first pixel's row, column
            const int cf = c_tile % w;
            unsigned starts = 0;  // bit j: pixel j is a row's column 0
            for (int j = cf ? w - cf : 0; j < 16; j += w) starts |= 1u << j;
            if (cnt < 16) starts &= (1u << cnt) - 1;
            for (int g = 0; g < n_groups; ++g) {
                const int k0 = 4 * g, kn = D ? D : min(4, d - k0);
                uint4 v[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    v[i] = make_uint4(0, 0, 0, 0);
                    if ((D ? i < D : i < kn) && cnt > 0) {
                        v[i] = load16(sym + (k0 + i) * plane + pf, cnt);
                        v[i] = make_uint4(v[i].x ^ flip, v[i].y ^ flip, v[i].z ^ flip, v[i].w ^ flip);
                    }
                }
                unsigned x[16];
                transpose4(v[0].x, v[1].x, v[2].x, v[3].x, x);
                transpose4(v[0].y, v[1].y, v[2].y, v[3].y, x + 4);
                transpose4(v[0].z, v[1].z, v[2].z, v[3].z, x + 8);
                transpose4(v[0].w, v[1].w, v[2].w, v[3].w, x + 12);
                if (cnt < 16) {
#pragma unroll
                    for (int j = 0; j < 16; ++j)
                        if (j >= cnt) x[j] = 0;  // past the rows: bytes of other rows or planes
                }
                if (starts) {  // column 0 starts a segment at col0's value
#pragma unroll
                    for (int j = 0; j < 16; ++j) {
                        if ((starts >> j) & 1) {
                            const long long r = rf + (cf + j) / w;
                            unsigned cv = 0;
                            for (int i = 0; i < kn; ++i)
                                cv |= (unsigned)col0[(long long)(k0 + i) * h + r] << (8 * i);
                            x[j] = cv;
                        }
                    }
                }
                const unsigned cin = carry[g];  // the previous tile's last pixel, this group
                Seg tot;
                const Seg ex = block_seg_excl<RST_THREADS, Add4>(
                        {starts != 0, scan16<false>(x, starts, 0u)}, tot, sm);
                scan16<true>(x, starts, seg_combine<Add4>({0u, cin}, ex).v);
                if (threadIdx.x == 0) carry[g] = seg_combine<Add4>({0u, cin}, tot).v;
                if constexpr (D > 0) {
                    put_pixels<D>(x, buf + j0 * D);  // px = RST_PX: inside the buffer
                } else {
#pragma unroll
                    for (int j = 0; j < 16; ++j)
                        if (j < cnt)
                            for (int i = 0; i < kn; ++i)
                                buf[(j0 + j) * d + k0 + i] = (uint8_t)(x[j] >> (8 * i));
                }
            }
            __syncthreads();
            store_tile<RST_THREADS>(buf, img + p0 * d, (long long)n_px * d);
            __syncthreads();  // the buffer is the next tile's
        }
    }
}

// one launch of the delta restore's instance D, its grid filling the
// card's resident CTAs (queried once per buffer size)
template <int D>
int launch_restore_delta(const uint8_t* sym, const uint8_t* col0, int h, int w, int d,
                         unsigned flip, uint8_t* img, cudaStream_t stream) {
    const int px = d <= RST_BUF / RST_PX ? RST_PX : (RST_BUF / d > 0 ? RST_BUF / d : 1);
    const size_t smem = (((size_t)px * d + 15) & ~(size_t)15) + 16 + 4 * (size_t)((d + 3) / 4);
    static long long slots = 0;
    static size_t slots_smem = 0;
    cudaError_t err;
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(huffman_restore_delta_kernel<D>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    if (slots_smem != smem) {
        int dev, sms, per_sm;
        if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
        if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
            return (int)err;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, huffman_restore_delta_kernel<D>,
                                                            RST_THREADS, smem);
        if (err != cudaSuccess) return (int)err;
        slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
        slots_smem = smem;
    }
    const int rows = w >= px ? 1 : px / w;  // a tile's worth of short rows
    const long long units = ((long long)h + rows - 1) / rows;
    huffman_restore_delta_kernel<D><<<(unsigned)(units < slots ? units : slots), RST_THREADS, smem,
                                      stream>>>(sym, col0, h, w, d, flip, rows, px, img);
    return (int)cudaGetLastError();
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

// ---------------------------------------------------------------------------
// H4 masked delta: rank space (undelta_masked_device :432)
// ---------------------------------------------------------------------------

// Look-back words of the masked un-delta's two scans. Counts: state << 62 |
// use-above << 31 | valid (each < 2^31); value b << 32 | a. Sums: state << 32
// | four bytes (SWAR, bytewise mod 256).
struct UdCounts {
    using T = unsigned long long;
    __device__ static unsigned long long state(unsigned long long x) { return x >> 62; }
    __device__ static T value(unsigned long long x) {
        return (x >> 31 & 0x7FFFFFFFull) << 32 | (x & 0x7FFFFFFFull);
    }
    __device__ static unsigned long long word(unsigned long long st, T v) {
        return st << 62 | (v >> 32) << 31 | (v & 0xFFFFFFFFull);
    }
    __device__ static T f(T a, T b) { return a + b; }
};

struct UdSums {
    using T = unsigned;
    __device__ static unsigned long long state(unsigned long long x) { return x >> 32; }
    __device__ static T value(unsigned long long x) { return (unsigned)x; }
    __device__ static unsigned long long word(unsigned long long st, T v) { return st << 32 | v; }
    __device__ static T f(T a, T b) { return add4(a, b); }
};

struct Sum64 {
    using T = unsigned long long;
    __device__ static unsigned long long f(unsigned long long a, unsigned long long b) {
        return a + b;
    }
};

// pass 1, one CTA per chunk of UD_PX pixels in ticket order; thread t takes
// pixels 16t .. 16t + 15 of the chunk. Valid and use-above bits (valid, left
// invalid or column 0, above valid, row > 0) by 16-byte loads of the mask
// at p, p - 1 and p - w; their counts scanned over the chunk and looked back
// over the chunks before it give each group of 16 its rank base and segment
// base (G: rank, segment, valid bits | use-above bits << 16). Then, per group
// of four depths, the chunk's valid deltas (ranks consecutive from the
// chunk's base: one 16-byte load per depth a thread) are transposed to a u32
// per pixel, summed (SWAR bytes), scanned over the chunk and looked back:
// s, the prefix sum of the deltas in rank space, staged in shared memory in
// rank order and written to img at each valid pixel (0 elsewhere),
// pixel-interleaved with 16-byte stores.
template <int D>
__global__ void __launch_bounds__(UD_THREADS) huffman_restore_delta_masked_scan_kernel(
        const uint8_t* __restrict__ sym, const uint8_t* __restrict__ mask, int h, int w, int d,
        unsigned flip, int n_chunks, uint4* __restrict__ G, unsigned long long* lbc,
        unsigned long long* lbs, unsigned long long* misc, uint8_t* __restrict__ img) {
    __shared__ unsigned long long sm64[2 * (UD_THREADS / 32 + 1)];
    __shared__ unsigned sm32[2 * (UD_THREADS / 32 + 1)];
    __shared__ unsigned comp[UD_PX];  // the chunk's s values in rank order
    __shared__ unsigned long long sh_pre;
    __shared__ unsigned sh_sum;
    __shared__ int sh_c;
    const int tid = threadIdx.x;
    if (tid == 0) sh_c = (int)atomicAdd(misc, 1ULL);  // the ticket
    __syncthreads();
    const int c = sh_c;
    const long long npx = (long long)h * w, plane = npx;
    const long long p0 = (long long)c * UD_PX + 16 * tid;
    const int cnt = (int)max(0LL, min(16LL, npx - p0));
    const unsigned vb = mask_bits16(mask, p0, cnt);
    unsigned ua = 0;
    if (cnt > 0) {
        const bool prev = p0 > 0 && mask[p0 - 1];
        unsigned col0 = 0;  // bit j: pixel j is a row's column 0
        const long long cf = p0 % w;
        for (long long j = cf ? w - cf : 0; j < 16; j += w) col0 |= 1u << j;
        const unsigned left = ((vb << 1) | (prev ? 1u : 0u)) & ~col0;
        unsigned above = 0;
        if (p0 >= w) {
            above = mask_bits16(mask, p0 - w, cnt);
        } else {
            for (int j = 0; j < cnt; ++j)
                if (p0 + j >= w && mask[p0 + j - w]) above |= 1u << j;
        }
        ua = vb & ~left & above & 0xFFFFu;
    }
    const int nvt = __popc(vb);
    unsigned long long tot;
    const unsigned long long ex = block_excl<UD_THREADS, Sum64>(
            (unsigned long long)__popc(ua) << 32 | (unsigned)nvt, tot, sm64);
    if (tid < 32) {
        const unsigned long long pre = ud_lookback<UdCounts>(lbc, c, tot);
        if (tid == 0) sh_pre = pre;
    }
    __syncthreads();
    const unsigned long long pre = sh_pre + ex;
    const unsigned rb = (unsigned)pre, sb = (unsigned)(pre >> 32);
    if (cnt > 0) G[p0 / 16] = make_uint4(rb, sb, vb | ua << 16, 0u);
    if (c == n_chunks - 1 && tid == UD_THREADS - 1) {
        misc[1] = rb + nvt;                      // valid pixels
        misc[2] = sb + (unsigned)__popc(ua);     // segments
    }
    const int lr = (int)(rb - (unsigned)sh_pre);  // the first rank in the chunk's order
    const int n_groups = D ? 1 : (d + 3) >> 2;
    for (int g = 0; g < n_groups; ++g) {
        const int k0 = 4 * g, kn = D ? D : min(4, d - k0);
        uint4 v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            v[i] = make_uint4(0, 0, 0, 0);
            if (i < kn && nvt > 0) {
                v[i] = load16(sym + (k0 + i) * plane + rb, nvt);
                v[i] = make_uint4(v[i].x ^ flip, v[i].y ^ flip, v[i].z ^ flip, v[i].w ^ flip);
            }
        }
        unsigned x[16];
        transpose4(v[0].x, v[1].x, v[2].x, v[3].x, x);
        transpose4(v[0].y, v[1].y, v[2].y, v[3].y, x + 4);
        transpose4(v[0].z, v[1].z, v[2].z, v[3].z, x + 8);
        transpose4(v[0].w, v[1].w, v[2].w, v[3].w, x + 12);
        unsigned acc = 0;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            if (j < nvt) acc = add4(acc, x[j]);
            x[j] = acc;
        }
        unsigned btot;
        const unsigned bex = block_excl<UD_THREADS, Add4>(acc, btot, sm32);
        if (tid < 32) {
            const unsigned pre = ud_lookback<UdSums>(lbs + (long long)g * n_chunks, c, btot);
            if (tid == 0) sh_sum = pre;
        }
        __syncthreads();
        const unsigned base = add4(sh_sum, bex);
#pragma unroll
        for (int j = 0; j < 16; ++j)
            if (j < nvt) comp[lr + j] = add4(base, x[j]);
        __syncthreads();
        unsigned y[16];
#pragma unroll
        for (int j = 0; j < 16; ++j)
            y[j] = (vb >> j) & 1u ? comp[lr + __popc(vb & ((1u << j) - 1u))] : 0u;
        if (D > 0 && cnt == 16) {
            put_pixels<D ? D : 1>(y, img + p0 * D);
        } else {  // static indices into y: it stays in registers
#pragma unroll
            for (int j = 0; j < 16; ++j)
                if (j < cnt)
                    for (int i = 0; i < kn; ++i)
                        img[(p0 + j) * d + k0 + i] = (uint8_t)(y[j] >> (8 * i));
        }
        __syncthreads();  // comp and sh_sum are the next group's
    }
}

// the segment (0: before any use-above pixel) of pixel 16 * gi + j from its
// group's entry: the use-above pixels up to it, inclusive
__device__ __forceinline__ unsigned ud_segment(uint4 e, int j) {
    return e.y + (unsigned)__popc((e.z >> 16) & ((2u << j) - 1u));
}

// pass 2, one thread per group of 16 pixels: each use-above pixel p starts
// segment k and records, per group of four depths, A[k] = parent << 32 | c_k,
// where parent is the segment of the pixel above, p - w (an earlier row), and
// c_k = s(p - w) - s(p) + e(p): the value above, less the running sum before
// p (pass 1 wrote s at every valid pixel)
__global__ void __launch_bounds__(UD_THREADS) huffman_restore_delta_masked_segments_kernel(
        const uint8_t* __restrict__ sym, const uint4* __restrict__ G, int h, int w, int d,
        unsigned flip, long long a_stride, unsigned long long* __restrict__ A,
        const uint8_t* __restrict__ img) {
    const long long gi = (long long)blockIdx.x * UD_THREADS + threadIdx.x;
    const long long npx = (long long)h * w;
    if (gi * 16 >= npx) return;
    const uint4 e = G[gi];
    unsigned ua = e.z >> 16;
    const unsigned vb = e.z & 0xFFFFu;
    while (ua) {
        const int j = __ffs(ua) - 1;
        ua &= ua - 1u;
        const long long p = gi * 16 + j, q = p - w;
        const unsigned k = ud_segment(e, j);
        const unsigned par = ud_segment(G[q / 16], (int)(q % 16));
        const long long r = e.x + (unsigned)__popc(vb & ((1u << j) - 1u));
        for (int k0 = 0; k0 < d; k0 += 4) {
            const int kn = min(4, d - k0);
            unsigned sp = 0, sq = 0, ev = 0;
            for (int i = 0; i < kn; ++i) {
                sp |= (unsigned)img[p * d + k0 + i] << (8 * i);
                sq |= (unsigned)img[q * d + k0 + i] << (8 * i);
                ev |= (unsigned)sym[(k0 + i) * npx + r] << (8 * i);
            }
            A[(k0 / 4) * a_stride + k] = (unsigned long long)par << 32
                                         | add4(__vsub4(sq, sp), ev ^ flip);
        }
    }
}

// pass 3, the segment forest: B_k = c_k + B_parent(k), B_0 = 0. Each thread
// follows its segments' parents and rewrites A[k] = (the ancestor reached) <<
// 32 | (the sum up to it) after each hop, so that later readers jump over
// what is done (pointer jumping without rounds: a word is always a true
// partial sum, reads may be stale but never wrong, and the ancestor index
// falls at every hop, so each chain ends whatever the order). Segments past
// the first wave find their ancestors resolved.
__global__ void __launch_bounds__(UD_THREADS) huffman_restore_delta_masked_resolve_kernel(
        int d, long long a_stride, const unsigned long long* __restrict__ misc,
        unsigned long long* A) {
    const long long m = (long long)misc[2];
    for (long long k = 1 + (long long)blockIdx.x * UD_THREADS + threadIdx.x; k <= m;
         k += (long long)gridDim.x * UD_THREADS) {
        for (int g = 0; g < (d + 3) >> 2; ++g) {
            volatile unsigned long long* a = A + g * a_stride;
            const unsigned long long x = a[k];
            unsigned par = (unsigned)(x >> 32), val = (unsigned)x;
            while (par) {
                const unsigned long long y = a[par];
                val = add4(val, (unsigned)y);
                par = (unsigned)(y >> 32);
                a[k] = (unsigned long long)par << 32 | val;
            }
        }
    }
}

// pass 4, one thread per group of 16 pixels: each valid pixel of segment k
// >= 1 gets B_k added (bytewise) to its s, in place
template <int D>
__global__ void __launch_bounds__(UD_THREADS) huffman_restore_delta_masked_apply_kernel(
        const uint4* __restrict__ G, int h, int w, int d, long long a_stride,
        const unsigned long long* __restrict__ A, uint8_t* __restrict__ img) {
    const long long gi = (long long)blockIdx.x * UD_THREADS + threadIdx.x;
    const long long npx = (long long)h * w, p0 = gi * 16;
    if (p0 >= npx) return;
    const uint4 e = G[gi];
    const unsigned vb = e.z & 0xFFFFu;
    if (vb == 0 || (e.y == 0 && (e.z >> 16) == 0)) return;  // nothing valid, or segment 0 alone
    const int cnt = (int)min(16LL, npx - p0);
    for (int k0 = 0; k0 < d; k0 += 4) {
        const int kn = D ? D : min(4, d - k0);
        unsigned y[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const unsigned k = ud_segment(e, j);
            y[j] = (vb >> j) & 1u && k ? (unsigned)A[(k0 / 4) * a_stride + k] : 0u;
        }
        if (D > 0 && cnt == 16) {
            constexpr int DD = D > 0 ? D : 1;
            unsigned o[4 * DD];
            interleave<DD>(y, o);
            uint4* dst = reinterpret_cast<uint4*>(img + p0 * d);
#pragma unroll
            for (int m = 0; m < DD; ++m) {
                const uint4 s = dst[m];
                dst[m] = make_uint4(add4(s.x, o[4 * m]), add4(s.y, o[4 * m + 1]),
                                    add4(s.z, o[4 * m + 2]), add4(s.w, o[4 * m + 3]));
            }
        } else {
#pragma unroll
            for (int j = 0; j < 16; ++j)
                if (j < cnt && (vb >> j) & 1u)
                    for (int i = 0; i < kn; ++i) {
                        uint8_t* o = img + (p0 + j) * d + k0 + i;
                        *o = (uint8_t)(*o + (y[j] >> (8 * i)));
                    }
        }
    }
}

// the scratch of one masked un-delta, carved in this order (u64 words)
struct UdScratch {
    long long n_chunks, n_g16, n_groups, a_stride;
    long long g_words, a_words, lb_words;  // G (uint4), A, then the zeroed look-back words
};

UdScratch ud_scratch(int h, int w, int d) {
    UdScratch s;
    const long long npx = (long long)h * w;
    s.n_chunks = (npx + UD_PX - 1) / UD_PX;
    s.n_g16 = (npx + 15) / 16;
    s.n_groups = (d + 3) / 4;
    s.a_stride = npx + 1;  // segments 1 .. m, m <= npx
    s.g_words = 2 * s.n_g16;
    s.a_words = s.n_groups * s.a_stride;
    s.lb_words = s.n_chunks * (1 + s.n_groups) + 4;  // counts, sums, ticket, nv, m
    return s;
}

template <int D>
int launch_undelta_masked(const uint8_t* sym, const uint8_t* mask, int h, int w, int d,
                          unsigned flip, unsigned long long* scratch, uint8_t* img,
                          cudaStream_t st) {
    const UdScratch s = ud_scratch(h, w, d);
    uint4* G = reinterpret_cast<uint4*>(scratch);
    unsigned long long* A = scratch + s.g_words;
    unsigned long long* lbc = A + s.a_words;
    unsigned long long* lbs = lbc + s.n_chunks;
    unsigned long long* misc = lbs + s.n_groups * s.n_chunks;
    cudaError_t err = cudaMemsetAsync(lbc, 0, sizeof(*lbc) * s.lb_words, st);
    if (err != cudaSuccess) return (int)err;
    huffman_restore_delta_masked_scan_kernel<D><<<(unsigned)s.n_chunks, UD_THREADS, 0, st>>>(
        sym, mask, h, w, d, flip, (int)s.n_chunks, G, lbc, lbs, misc, img);
    const unsigned g16 = (unsigned)((s.n_g16 + UD_THREADS - 1) / UD_THREADS);
    huffman_restore_delta_masked_segments_kernel<<<g16, UD_THREADS, 0, st>>>(
        sym, G, h, w, d, flip, s.a_stride, A, img);
    huffman_restore_delta_masked_resolve_kernel<<<grid_of(s.n_g16, UD_THREADS), UD_THREADS, 0,
                                                  st>>>(d, s.a_stride, misc, A);
    huffman_restore_delta_masked_apply_kernel<D><<<g16, UD_THREADS, 0, st>>>(
        G, h, w, d, s.a_stride, A, img);
    return (int)cudaGetLastError();
}

struct H1mArgs {
    const int* data;
    const uint8_t* mask;
    int h, w, d, offset, n_tiles;
    uint8_t *scratch, *direct, *delta;
    long long n_pad;
};

// scratch: the histograms (2048 bytes), then the look-back words and the ticket
template <int D>
int launch_symbols_masked(const H1mArgs& a, cudaStream_t st) {
    huffman_symbols_masked_kernel<D><<<grid_of(a.n_tiles, 1), H1M_THREADS, 0, st>>>(
        a.data, a.mask, a.h, a.w, a.d, a.offset, a.n_tiles,
        reinterpret_cast<unsigned long long*>(a.scratch + 2048), reinterpret_cast<int*>(a.scratch),
        a.direct, a.delta, a.n_pad);
    return (int)cudaGetLastError();
}

}  // namespace

// data [h, w, d] int32; direct, delta: zeroed u8; histos [2, 256] int32, zeroed
extern "C" int huffman_symbols(const int* data, int h, int w, int d, int offset, uint8_t* direct,
                               uint8_t* delta, int* histos, void* stream) {
    const long long n_chunks = ((long long)h * w + CHUNK - 1) / CHUNK;
    if (n_chunks == 0) return 0;
    huffman_symbols_kernel<<<grid_of(n_chunks, 1), CHUNK, 0, (cudaStream_t)stream>>>(
        data, h, w, d, offset, n_chunks, direct, delta, histos);
    return (int)cudaGetLastError();
}

// bytes of scratch huffman_symbols_masked needs: the histograms (the
// output, int32 [2, 256]) first, then a look-back word a tile and the ticket
extern "C" long long huffman_symbols_masked_scratch(int h, int w) {
    return 2048 + 8 * (((long long)h * w + H1M_PX - 1) / H1M_PX + 1);
}

// data [h, w, d] int32 (4-byte aligned); mask [h * w] bool; scratch:
// huffman_symbols_masked_scratch(h, w) bytes, 16-aligned, zeroed here on the
// stream (one memset), the histograms in its first 2048; direct, delta: u8
// [n_pad >= h * w * d], every byte written (the tails zero)
extern "C" int huffman_symbols_masked(const int* data, const uint8_t* mask, int h, int w, int d,
                                      int offset, uint8_t* scratch, long long n_scratch,
                                      uint8_t* direct, uint8_t* delta, long long n_pad,
                                      void* stream) {
    const long long npx = (long long)h * w;
    if (npx * d == 0) return 0;
    if (npx >= (1LL << 31) - 2 * H1M_PX || n_pad < npx * d ||
        n_scratch < huffman_symbols_masked_scratch(h, w))
        return (int)cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(scratch) & 15) return (int)cudaErrorMisalignedAddress;
    const cudaStream_t st = (cudaStream_t)stream;
    const cudaError_t err = cudaMemsetAsync(scratch, 0, huffman_symbols_masked_scratch(h, w), st);
    if (err != cudaSuccess) return (int)err;
    const H1mArgs a = {data, mask, h, w, d, offset, (int)((npx + H1M_PX - 1) / H1M_PX),
                       scratch, direct, delta, n_pad};
    switch (d) {
        case 1: return launch_symbols_masked<1>(a, st);
        case 2: return launch_symbols_masked<2>(a, st);
        case 3: return launch_symbols_masked<3>(a, st);
        case 4: return launch_symbols_masked<4>(a, st);
        default: return launch_symbols_masked<0>(a, st);
    }
}

// bytes of the one buffer huffman_encode writes: the total bits (int32) in
// its first 16 bytes, the stream's cap_words u32 words from byte 16, then a
// look-back word a tile of ENC_T symbols and the ticket (the tiling is this
// source's alone; callers size their buffer by this query)
extern "C" long long huffman_encode_scratch(long long n_sym, long long cap_words) {
    const long long n_tiles = (n_sym + ENC_T - 1) / ENC_T;
    return 16 + (4 * cap_words + 15) / 16 * 16 + 8 * (n_tiles + 1);
}

// sym: n_sym u8 (whole 64-symbol groups), any alignment; table [2, 256]
// int32 (lengths, codes); buf: huffman_encode_scratch(n_sym, cap_words)
// bytes, 16-aligned, zeroed here on the stream (one memset) before the one
// launch; sbits [n_sym / 64] int32
extern "C" int huffman_encode(const uint8_t* sym, long long n_sym, const int* table,
                              long long n_total, long long plane, long long n_live, void* buf,
                              long long n_buf, int* sbits, long long cap_words, void* stream) {
    const long long need = huffman_encode_scratch(n_sym, cap_words);
    if (n_sym % GROUP || cap_words < 0 || n_buf < need || plane <= 0 || n_sym / ENC_T >= INT_MAX)
        return (int)cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(buf) & 15) return (int)cudaErrorMisalignedAddress;
    const cudaStream_t st = (cudaStream_t)stream;
    const cudaError_t err = cudaMemsetAsync(buf, 0, need, st);
    if (err != cudaSuccess || n_sym == 0) return (int)err;
    static long long slots = 0;  // CTAs resident at once on the device
    if (slots == 0) {
        int dev, sms, per_sm;
        cudaError_t e;
        if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
        if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
            return (int)e;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, huffman_encode_kernel,
                                                          ENC_THREADS, 0);
        if (e != cudaSuccess) return (int)e;
        slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
    }
    uint8_t* b = static_cast<uint8_t*>(buf);
    const int n_tiles = (int)((n_sym + ENC_T - 1) / ENC_T);
    huffman_encode_kernel<<<(unsigned)(n_tiles < slots ? n_tiles : slots), ENC_THREADS, 0, st>>>(
        sym, n_sym, table, n_total, plane, n_live, n_tiles, n_sym / GROUP,
        reinterpret_cast<unsigned long long*>(b + 16 + (4 * cap_words + 15) / 16 * 16), sbits,
        reinterpret_cast<unsigned*>(b + 16), cap_words, reinterpret_cast<int*>(b));
    return (int)cudaGetLastError();
}

// bytes of scratch huffman_decode needs for its decode table (the table's
// layout is this source's alone; callers size their buffer by this query)
extern "C" long long huffman_decode_scratch() { return (long long)sizeof(DecTable); }

// consts [33, 3] int64; sorted_syms [256]; syms [n_groups * 64], 16-aligned (a
// fresh allocation); used [n_groups]; ok: 1 on entry; words: any alignment;
// scratch: huffman_decode_scratch() bytes, 16-aligned. Two launches: the decode
// table, then the groups.
extern "C" int huffman_decode(const unsigned* words, long long n_words, long long n_bits,
                              const int* sbits, int n_groups, const long long* consts,
                              const uint8_t* sorted_syms, long long n_total, long long plane,
                              long long n_live, void* scratch, long long n_scratch,
                              uint8_t* syms, int* used, int* ok, void* stream) {
    if (n_groups == 0) return 0;
    if (n_scratch < huffman_decode_scratch()) return (int)cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(syms) | reinterpret_cast<uintptr_t>(scratch)) & 15)
        return (int)cudaErrorMisalignedAddress;
    const cudaStream_t st = (cudaStream_t)stream;
    DecTable* tab = static_cast<DecTable*>(scratch);
    huffman_decode_table_kernel<<<((1 << DEC_K) + 255) / 256, 256, 0, st>>>(consts, sorted_syms,
                                                                             tab);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = (unsigned)((n_groups + DEC_THREADS - 1) / DEC_THREADS);
    huffman_decode_kernel<<<grid, DEC_THREADS, 0, st>>>(words, n_words, n_bits, sbits, n_groups,
                                                       tab, n_total, plane, n_live, syms, used,
                                                       ok);
    return (int)cudaGetLastError();
}

// img: 16-aligned (a fresh allocation); sym: any alignment
extern "C" int huffman_restore(const uint8_t* sym, long long n, int offset, uint8_t* img,
                               void* stream) {
    if (n == 0) return 0;
    if (reinterpret_cast<uintptr_t>(img) & 15) return (int)cudaErrorMisalignedAddress;
    const long long threads = (n + 15) / 16;
    huffman_restore_kernel<<<(unsigned)((threads + RST_THREADS - 1) / RST_THREADS), RST_THREADS, 0,
                             (cudaStream_t)stream>>>(sym, n, offset, img);
    return (int)cudaGetLastError();
}

// col0: [d, h] u8; agg: n_agg >= ceil(d / 4) * huffman_restore_col0_ctas(h)
// u64 of scratch, zeroed here on the stream before the launch
extern "C" int huffman_restore_col0_ctas(int h) {
    const int per = (h + COL_THREADS * COL_MAX_CTAS - 1) / (COL_THREADS * COL_MAX_CTAS);
    return (h + COL_THREADS * per - 1) / (COL_THREADS * per);
}

extern "C" int huffman_restore_col0(const uint8_t* sym, int h, int w, int d, int offset,
                                    unsigned long long* agg, int n_agg, uint8_t* col0,
                                    void* stream) {
    if ((long long)h * w * d == 0) return 0;
    const int ctas = huffman_restore_col0_ctas(h);
    if (n_agg < (d + 3) / 4 * ctas) return (int)cudaErrorInvalidValue;
    const int per = (h + COL_THREADS * COL_MAX_CTAS - 1) / (COL_THREADS * COL_MAX_CTAS);
    const cudaError_t err =
        cudaMemsetAsync(agg, 0, sizeof(*agg) * n_agg, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    huffman_restore_col0_kernel<<<ctas, COL_THREADS, 0, (cudaStream_t)stream>>>(
        sym, h, w, d, offset, per, agg, col0);
    return (int)cudaGetLastError();
}

// sym, img: any alignment; col0: [d, h] u8 from huffman_restore_col0;
// offset 0 (uint8) or 128 (int8)
extern "C" int huffman_restore_delta(const uint8_t* sym, const uint8_t* col0, int h, int w,
                                     int d, int offset, uint8_t* img, void* stream) {
    if ((long long)h * w * d == 0) return 0;
    if (offset != 0 && offset != 128) return (int)cudaErrorInvalidValue;
    const unsigned flip = offset ? 0x80808080u : 0u;
    const cudaStream_t st = (cudaStream_t)stream;
    switch (d) {
        case 1: return launch_restore_delta<1>(sym, col0, h, w, d, flip, img, st);
        case 2: return launch_restore_delta<2>(sym, col0, h, w, d, flip, img, st);
        case 3: return launch_restore_delta<3>(sym, col0, h, w, d, flip, img, st);
        case 4: return launch_restore_delta<4>(sym, col0, h, w, d, flip, img, st);
        default: return launch_restore_delta<0>(sym, col0, h, w, d, flip, img, st);
    }
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

// u64 words of scratch huffman_restore_delta_masked needs (the chunking is
// this source's alone; callers size their buffer by this query)
extern "C" long long huffman_restore_delta_masked_scratch(int h, int w, int d) {
    const UdScratch s = ud_scratch(h, w, d);
    return s.g_words + s.a_words + s.lb_words;
}

// sym: depth-major delta symbols (plane k's ranks at k * h * w), any
// alignment; mask [h * w] bool; img 16-aligned (a fresh allocation);
// scratch: huffman_restore_delta_masked_scratch(h, w, d) u64, 16-aligned, its
// look-back words zeroed here on the stream; offset 0 (uint8) or 128 (int8)
extern "C" int huffman_restore_delta_masked(const uint8_t* sym, const uint8_t* mask, int h,
                                            int w, int d, int offset,
                                            unsigned long long* scratch, long long n_scratch,
                                            uint8_t* img, void* stream) {
    if ((long long)h * w * d == 0) return 0;
    if (offset != 0 && offset != 128) return (int)cudaErrorInvalidValue;
    if ((long long)h * w >= (1LL << 31) - UD_PX) return (int)cudaErrorInvalidValue;
    if (n_scratch < huffman_restore_delta_masked_scratch(h, w, d))
        return (int)cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(img) | reinterpret_cast<uintptr_t>(scratch)) & 15)
        return (int)cudaErrorMisalignedAddress;
    const unsigned flip = offset ? 0x80808080u : 0u;
    const cudaStream_t st = (cudaStream_t)stream;
    switch (d) {
        case 1: return launch_undelta_masked<1>(sym, mask, h, w, d, flip, scratch, img, st);
        case 2: return launch_undelta_masked<2>(sym, mask, h, w, d, flip, scratch, img, st);
        case 3: return launch_undelta_masked<3>(sym, mask, h, w, d, flip, scratch, img, st);
        case 4: return launch_undelta_masked<4>(sym, mask, h, w, d, flip, scratch, img, st);
        default: return launch_undelta_masked<0>(sym, mask, h, w, d, flip, scratch, img, st);
    }
}
