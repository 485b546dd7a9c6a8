// The indexed and index-free Lerc2 tile decoders: K4 decode_records (the
// resident codecs' indexed decode of 8x8 records: float32, all-valid or
// masked, and its integer instances decode_records_int), K6 decode_scanned
// (the band decoder's, and the index-free resident decode's) and the
// mosaic's K4 (decode_records_lut: LUT records, 16x16 blocks, n units a
// launch, the depth-diff chain). All three are strip kernels on one
// machinery, described below: a CTA owns a strip of consecutive blocks of
// one block row, stages its records' bytes and its image in shared memory,
// and decodes a pixel a thread.
//
// K4 replaces lerc_tpu/ops/device_decode.py::decode_tiles_fast (:64) and
// _exact_f32_scale_back (:30, softfloat f64 in device_softf64.py), and for
// masks the expansion make_expander (device_encode.py:357). The TPU version
// gathers overlapping stride windows and extracts bits through static
// select chains or one-hot matmuls, routes masked values back through a
// log-shift roll network, and emulates f64 in u32 limbs; here each record
// is parsed once from the staged bytes at starts[r], a value comes out of
// two staged words by a funnel shift at its rank among the block's valid
// positions (popc of the validity words below it), and float32 dequantizes
// in native f64.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "record.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// stream byte at pos, 0 outside [0, n) (K4's reads)
__device__ __forceinline__ uint32_t rd(const uint8_t* s, long long pos, long long n) {
    return (pos >= 0 && pos < n) ? (uint32_t)s[pos] : 0u;
}

// ---------------------------------------------------------------------------
// The strip kernels: K4 and K6 (below) decode 8x8 (K6 and the mosaic's K4
// also 16x16) blocks a strip at a time. A CTA of STRIP_THREADS owns a strip of S
// consecutive blocks of one block row and walks their D slices in chunks of
// Dc depths (one chunk, Dc = D, unless a block's pixels at full depth pass
// the output stage; then S = 1 and a chunk's records are again
// consecutive). Records r = b*D + di of consecutive blocks are consecutive,
// so a chunk's index or descriptors are one coalesced read each, and its
// records' bytes -- from the first record to the next chunk's, contiguous
// in a valid stream -- are staged in shared memory with 16-byte loads. A
// read that falls outside the staged bytes (a hostile or non-monotonic
// index, a start past the end, a span longer than the stage) goes to the
// stream with the kernel's own semantics for bytes outside it, in the same
// kernel. One thread a record parses it and gives it a kind: const-0,
// const-offset, staged stuffed or raw (each value from two shared words by
// a funnel shift), or read through the checked path (LUT records, bytes
// past the stage); a warp decodes one record at a time, so the kind is a
// uniform branch. A thread owns pixels (all their depths of the chunk, in
// depth order) and writes them into an output stage laid out as the image's
// interleaved bytes: one segment per strip row (or, for deep chunks, per
// pixel), each starting at its image address mod 16, so that it leaves in
// aligned 16-byte stores with byte stores for the head and tail. Flags are
// reduced in the CTA and stored once.
//
// Sizes: a strip holds at most STRIP_PX pixels and STRIP_OUT image bytes,
// so S = min(STRIP_PX, STRIP_OUT / (D * size)) / (MB * MB), at least 1; on
// uint8 x 3 with 8x8 blocks S = 32: 6 KB of image, 96 records, at most
// about 6.7 KB of stuffed payload (all-raw 6.2 KB) against a STRIP_IN of 8
// KB; on float32 x 1 S = 32 too: 8 KB of image, 32 records, at most 32 x
// 257 B all-raw (the last records past the stage read from the stream). A
// chunk has at most STRIP_REC records, one parsing thread each.
// ---------------------------------------------------------------------------

constexpr int STRIP_THREADS = 256;
constexpr int STRIP_PPT = STRIP_PX / STRIP_THREADS;  // pixels a thread (STRIP_PX, STRIP_OUT: record.cuh)
constexpr int STRIP_STAGE = 12288;  // the output stage: segments at 16-byte pitch
constexpr int STRIP_IN = 8192;
constexpr int STRIP_REC = 128;
constexpr int STRIP_BLK = 32;

// the geometry of a launch (strip_geometry)
struct StripGeom {
    int S;       // blocks a strip
    int dc;      // depths a chunk
    int px_seg;  // pixels a segment of the output stage (S * MB, or 1)
    int pitch;   // bytes a segment of the output stage
    int spr;     // strips a block row
};

inline StripGeom strip_geometry(int mb, int w, int d, int size) {
    const StripShape sh = strip_shape(mb, w, d, size, 0);
    StripGeom g;
    g.S = sh.S;
    g.dc = sh.dc;
    g.px_seg = sh.dc == d ? sh.S * mb : 1;
    g.pitch = (g.px_seg * g.dc * size + 15) / 16 * 16 + 16;
    g.spr = sh.spr;
    return g;
}

// stream byte at pos for a read outside the stage: 0 outside [0, n) (K4's
// rd) or the index clamped into [0, n) (K6's byte_clamped)
template <bool CLAMP>
__device__ __forceinline__ uint32_t stream_byte(const uint8_t* s, long long pos, long long n) {
    return CLAMP ? lerc2::byte_clamped(s, pos, n) : rd(s, pos, n);
}

// The staged span of a chunk: stage[k] is stream byte gb + k; the bytes in
// [vlo, vhi) are the stream's (inside [0, n)), the rest never read.
struct Span {
    long long gb, vlo, vhi;
};

// `need` (<= 8) stream bytes from pos, little-endian in the low bytes (the
// higher bytes undefined): from the stage where they lie in [vlo, vhi),
// else from the stream
template <bool CLAMP>
__device__ __forceinline__ uint64_t bytes_at(const uint8_t* s, long long n, const uint32_t* st,
                                             const Span& sp, long long pos, int need) {
    if (pos >= sp.vlo && pos + need <= sp.vhi) {
        const long long o = pos - sp.gb;
        const int a = (int)(o >> 2), sh = 8 * (int)(o & 3);
        const uint64_t lo = st[a] | (uint64_t)st[a + 1] << 32;
        return sh ? (lo >> sh) | (uint64_t)st[a + 2] << (64 - sh) : lo;
    }
    uint64_t v = 0;
    for (int t = 0; t < need; ++t) v |= (uint64_t)stream_byte<CLAMP>(s, pos + t, n) << (8 * t);
    return v;
}

// Stage stream bytes [lo, end) clamped into [0, n), at most STRIP_IN of them
// from the 16-byte boundary at or below lo, with 16-byte loads (each holds a
// byte of the stream, so none leaves its allocation's granule). Every
// thread of the CTA calls it; a __syncthreads must follow before a read.
__device__ __forceinline__ Span stage_span(const uint8_t* s, long long n, long long lo,
                                           long long end, uint4* st) {
    lo = lo < 0 ? 0 : lo;
    end = end > n ? n : end;
    Span sp;
    sp.gb = lo - (long long)(((uintptr_t)s + (uintptr_t)lo) & 15);
    const long long len = end > lo ? min((long long)STRIP_IN, end - sp.gb) : 0;
    const uint4* src = reinterpret_cast<const uint4*>(s + sp.gb);
    for (int c = threadIdx.x; c < (int)((len + 15) >> 4); c += STRIP_THREADS) st[c] = __ldg(src + c);
    sp.vlo = sp.gb < 0 ? 0 : sp.gb;
    sp.vhi = len ? min(sp.gb + len, n) : sp.vlo;
    return sp;
}

// The output stage: pixel (y, x) of the strip (x < S * MB), slice dd of the
// chunk, sits in segment y * segs_row + x / px_seg at its image address
// mod 16 plus its offset in the segment.
struct OutStage {
    uint8_t* img;  // the image's bytes
    int h, w, d, size, row0, col0, dlo, dn, px_seg, pitch, segs_row;

    __device__ __forceinline__ long long seg_addr(int y, int xs) const {  // image byte offset
        return ((long long)(row0 + y) * w + col0 + xs) * d * size + (long long)dlo * size;
    }
    // the stage offset of pixel (y, x) of the strip at the chunk's first
    // slice (slice dd lies dd * size further); in a strip of one segment a
    // row, pixels dx apart lie dx * dn * size apart
    __device__ __forceinline__ int offset(int y, int x) const {
        const bool deep = px_seg == 1;
        const uint32_t mis = ((uint32_t)(uintptr_t)img
                              + ((uint32_t)(row0 + y) * (uint32_t)w + (uint32_t)(col0 + (deep ? x : 0)))
                                * (uint32_t)(d * size) + (uint32_t)(dlo * size)) & 15u;
        return (deep ? y * segs_row + x : y) * pitch + (int)mis + (deep ? 0 : x * dn * size);
    }
    // copy the in-image part of every segment to the image: aligned 16-byte
    // slots as one store, the head and tail slots byte by byte
    __device__ __forceinline__ void write_out(const uint8_t* ost, int mb) const {
        const int seg_max = px_seg * dn * size;
        const int slots = (seg_max + 30) / 16;
        const int n_seg = mb * segs_row;
        for (int t = threadIdx.x; t < n_seg * slots; t += STRIP_THREADS) {
            const int seg = t / slots, q = t - seg * slots;
            const int y = seg / segs_row, xs = (seg - y * segs_row) * px_seg;
            if (row0 + y >= h || col0 + xs >= w) continue;
            const int len = min(px_seg, w - col0 - xs) * dn * size;
            const long long g = seg_addr(y, xs);
            const int mis = (int)(((uintptr_t)img + (uintptr_t)g) & 15);
            const int a0 = 16 * q - mis;
            if (a0 >= len) continue;
            const uint8_t* src = ost + seg * pitch + mis;
            if (a0 >= 0 && a0 + 16 <= len) {
                *reinterpret_cast<uint4*>(img + g + a0) = *reinterpret_cast<const uint4*>(src + a0);
            } else {
                for (int i = max(a0, 0); i < min(a0 + 16, len); ++i) img[g + i] = src[i];
            }
        }
    }
};

// `width` (<= 32) bits, LSB-first, from bit `bitpos` of the staged bytes at
// stage offset pos: two staged words hold them
__device__ __forceinline__ uint32_t staged_bits(const uint32_t* st, int pos, int bitpos, int width) {
    const int at = pos + (bitpos >> 3);
    const uint32_t* wp = st + (at >> 2);
    const uint32_t v = __funnelshift_r(wp[0], wp[1], ((at & 3) << 3) + (bitpos & 7));
    return width >= 32 ? v : v & ((1u << width) - 1u);
}

// value i of `width` bits (LSB-first) in the bit stream at byte pos, bytes
// read clamped into the stream (K6) or, CLAMP false, 0 outside it (K4)
template <bool CLAMP = true>
__device__ __forceinline__ uint32_t extract(const uint8_t* s, long long n, const uint32_t* st,
                                            const Span& sp, long long pos, long long i, int width) {
    const long long bitpos = i * width;
    const uint64_t v = bytes_at<CLAMP>(s, n, st, sp, pos + (bitpos >> 3), 5);
    const uint32_t qmask = width >= 32 ? 0xFFFFFFFFu : (1u << width) - 1u;
    return (uint32_t)(v >> (bitpos & 7)) & qmask;
}

// ---------------------------------------------------------------------------
// K4 decode_records (decode_tiles_fast :64-470): the resident codecs'
// indexed decode of one tile of 8x8 records, a strip kernel (above). The
// chunk's starts (and the next chunk's first) come in one read, its
// records' bytes are staged from starts[first] to the next chunk's start;
// one thread a record parses its header (one 8-byte read) and its flags;
// then a thread a pixel decodes its depths. Bytes outside [0, n) read as 0
// (rd), staged or not.
//
// float32 (IS_INT false): offsets of 1, 2 or 4 bytes (a byte, a short or
// the f32 bits), raw values copied as their 32 bits (NaN payloads kept),
// stuffed values by the exact ScaleBack (Lerc2.h:381-399,
// _exact_f32_scale_back): z = (float)(zMin + q * invScale) with one
// rounding per operation -- __dmul_rn and __dadd_rn, built with
// --fmad=false -- narrowed by __double2float_rn, then clamped after
// narrowing with std::min's tie/NaN pick (zMax < z ? zMax : z). The image
// leaves as bits (Tout float, stored as uint32).
//
// Integers (decode_tiles_fast :189-198, :390-408): offsets of each dtype's
// width with sign or zero extension (record.cuh), raw values of 1, 2 or 4
// bytes, exact int32 min(offset + q * round(2 mze), zMax), the image in the
// native dtype. A diff record (flag bit 2 at version >= 5, diff_v5) clears
// index_ok, for every dtype: this decoder has no previous slice to add (an
// integer diff record's offset is also reduced as INT, so its length would
// be misread) -- the image is still the records' parse, written in full. The
// host decoder and the reference apply the diff to float32 records too, so a
// float32 diff record read as an absolute one would decode wrong.
//
// flags[0] (index_ok) drops when a record's parsed length disagrees with
// the next index entry, a stuffed count is not the block's valid count (64
// without a mask), or a LUT bit is set; flags[1] (fits) drops when a
// record is wider than the caller's bit cap, or on a LUT bit under
// lut_unfit.
//
// Bound: bytes (the stream's `total` bytes and 4 B of index per record
// read once, 8 B of validity words per block when masked, size*H*W*D B of
// image written once).
// ---------------------------------------------------------------------------

// a stuffed value, its record's offset and zMax as int bits (float32: f32
// bits): exact int32 (integers) or the exact f64 ScaleBack (float32, bits)
template <bool IS_INT>
__device__ __forceinline__ int k4_scaled(int off, uint32_t q, int zm, double inv, int inv_i) {
    if constexpr (IS_INT) {
        return lerc2::int_scale_back(off, q, inv_i, zm);
    } else {
        const float z = __double2float_rn(__dadd_rn((double)__int_as_float(off),
                                                    __dmul_rn((double)q, inv)));
        const float zmf = __int_as_float(zm);
        return __float_as_int(zmf < z ? zmf : z);
    }
}

// a raw value of the dtype's width: sign- or zero-extended (integers), the
// f32 bits as they are (float32)
template <typename Tout, bool IS_INT>
__device__ __forceinline__ int k4_raw(uint32_t v) {
    if constexpr (IS_INT) return lerc2::raw_int(v, sizeof(Tout), std::is_signed<Tout>::value);
    else return (int)v;
}

// the strip kernel's body; its two __global__ entries below differ only in
// their launch bounds
template <typename Tout, bool IS_INT, bool MASKED>
__device__ __forceinline__ void decode_records_strip(
        const uint8_t* __restrict__ s, long long n_bytes, const int* __restrict__ starts,
        const uint32_t* __restrict__ valid, const int* __restrict__ zmax, double inv, int inv_i,
        int h, int w, int d, int n_rec, int dt, int diff_v5, int cap_nb, int lut_unfit,
        StripGeom g, Tout* __restrict__ img, int* __restrict__ flags) {
    constexpr int SIZE = sizeof(Tout);
    // what a pixel's slot of the output stage holds: the dtype, or float32's bits
    using TS = typename std::conditional<IS_INT, Tout, uint32_t>::type;
    // a record's kind: how its values are read (warp-uniform: a warp decodes one record)
    enum { ZERO, CONST, STUFF, RAW, STREAM };
    __shared__ uint4 in_st[STRIP_IN / 16 + 1];
    __shared__ uint4 out_st[STRIP_STAGE / 16];
    __shared__ int sst[STRIP_REC + 1], zms[STRIP_REC];
    __shared__ int4 r4[STRIP_REC];  // width | mode << 8 | kind << 16, staged payload, offset,
                                    // zMax (float32: their bits)
    __shared__ long long r_pay[STRIP_REC];
    __shared__ uint32_t vws[2 * STRIP_BLK];
    __shared__ int bad_s, unfit_s;
    const uint32_t* st = reinterpret_cast<const uint32_t*>(in_st);
    uint8_t* ost = reinterpret_cast<uint8_t*>(out_st);
    const int tid = threadIdx.x;
    const int nbh = w / 8;
    const int sr = blockIdx.x / g.spr, sc = blockIdx.x - sr * g.spr;
    const int b0 = sr * nbh + sc * g.S, n_s = min(g.S, nbh - sc * g.S);
    if (tid == 0) bad_s = unfit_s = 0;
    if constexpr (MASKED) {
        for (int t = tid; t < 2 * n_s; t += STRIP_THREADS) vws[t] = valid[2 * (size_t)b0 + t];
    }
    OutStage os{reinterpret_cast<uint8_t*>(img), h, w, d, SIZE, sr * 8, sc * g.S * 8, 0, 0,
                g.px_seg, g.pitch, g.S * 8 / g.px_seg};
    for (int dlo = 0; dlo < d; dlo += g.dc) {
        const int dn = min(g.dc, d - dlo), n_r = n_s * dn;
        const long long ra = (long long)b0 * d + dlo, rb = ra + n_r;  // consecutive records
        os.dlo = dlo;
        os.dn = dn;
        for (int t = tid; t <= n_r; t += STRIP_THREADS) sst[t] = ra + t < n_rec ? starts[ra + t] : 0;
        for (int t = tid; t < dn; t += STRIP_THREADS) zms[t] = zmax[dlo + t];
        const long long lo = starts[ra];
        const long long end = (rb < n_rec ? (long long)starts[rb] : n_bytes) + 8;
        const Span sp = stage_span(s, n_bytes, lo, end, in_st);
        __syncthreads();

        if (tid < n_r) {  // the record's header (Lerc2.cpp:1950-2021) and flags
            const long long r = ra + tid;
            const long long p = sst[tid];
            const uint64_t hb = bytes_at<false>(s, n_bytes, st, sp, p, 8);
            const uint32_t flag = (uint32_t)hb & 0xFFu;
            const int mode = flag & 3, b67 = flag >> 6;
            const int off_w = lerc2::offset_width(dt, b67);
            uint32_t acc = (uint32_t)(hb >> 8);
            acc &= off_w == 1 ? 0xFFu : (off_w == 2 ? 0xFFFFu : 0xFFFFFFFFu);
            const uint32_t nbb = (uint32_t)(hb >> (8 * (1 + off_w))) & 0xFFu;
            const int cw_code = nbb >> 6;
            const int cw = cw_code == 0 ? 4 : 3 - cw_code;
            const int nb = nbb & 31;
            const bool is_lut = (nbb & 32) && mode == 1;
            const int width = mode == 0 ? 8 * SIZE : nb;
            const long long pay = mode == 0 ? p + 1 : p + 2 + off_w + cw;
            const int bl = tid / dn;
            int cnt = 64;
            if constexpr (MASKED) cnt = __popc(vws[2 * bl]) + __popc(vws[2 * bl + 1]);
            // staged when every value's 5-byte window lies in the staged bytes
            const bool staged = pay >= sp.vlo && pay + ((max(cnt - 1, 0) * width) >> 3) + 5 <= sp.vhi;
            const int kind = mode == 2 ? ZERO : mode == 3 ? CONST : !staged ? STREAM
                           : mode == 1 ? STUFF : RAW;
            int off;
            if constexpr (IS_INT) off = lerc2::int_offset(acc, off_w, dt, b67);
            else off = __float_as_int(lerc2::float_offset(acc, b67));
            r4[tid] = make_int4(width | mode << 8 | kind << 16, staged ? (int)(pay - sp.gb) : 0,
                                off, zms[tid - bl * dn]);
            r_pay[tid] = pay;
            const uint32_t ne = ((uint32_t)(hb >> (8 * (2 + off_w))) & 0xFFu)
                              | (cw == 2 ? ((uint32_t)(hb >> (8 * (3 + off_w))) & 0xFFu) << 8 : 0u);
            const long long stuff_bytes = ((long long)ne * nb + 7) >> 3;
            const long long length = mode == 2 ? 1
                                   : mode == 3 ? 1 + off_w
                                   : mode == 0 ? 1 + (long long)cnt * SIZE
                                               : 1 + off_w + 1 + cw + stuff_bytes;
            bool bad = (mode == 1 && (int)ne != cnt) || is_lut || (diff_v5 && (flag & 4));
            if (r != n_rec - 1) {
                const int delta = (int)((uint32_t)sst[tid + 1] - (uint32_t)sst[tid]);
                bad |= delta != length;
            }
            if (bad) bad_s = 1;
            if (((mode == 0 || mode == 1) && width > cap_nb) || (lut_unfit && is_lut)) unfit_s = 1;
        }
        __syncthreads();

        // a thread's pixels: position j of blocks bl0, bl0 + KB, ...
        constexpr int KB = STRIP_THREADS / 64;
        const int j = tid & 63, bl0 = tid >> 6;
        uint8_t* const o0 = ost + os.offset(j >> 3, bl0 * 8 + (j & 7));
#pragma unroll 1
        for (int k = 0; k < STRIP_PPT; ++k) {
            const int bl = bl0 + k * KB;
            if (bl >= n_s) break;
            int rank = j;
            bool v = true;
            if constexpr (MASKED) {
                const uint32_t w0 = vws[2 * bl], w1 = vws[2 * bl + 1];
                const uint32_t lt = (1u << (j & 31)) - 1u;
                rank = j < 32 ? __popc(w0 & lt) : __popc(w0) + __popc(w1 & lt);
                v = ((j < 32 ? w0 : w1) >> (j & 31)) & 1u;
            }
            TS* o = reinterpret_cast<TS*>(o0 + k * KB * 8 * dn * SIZE);
            for (int dd = 0; dd < dn; ++dd) {
                const int4 ri = r4[bl * dn + dd];
                const int width = ri.x & 63;
                const int kind = v ? ri.x >> 16 : ZERO;  // an invalid position decodes to 0
                int z = 0;
                if (kind == STUFF) {
                    z = k4_scaled<IS_INT>(ri.z, staged_bits(st, ri.y, rank * width, width), ri.w,
                                          inv, inv_i);
                } else if (kind == CONST) {
                    z = ri.z;
                } else if (kind == RAW) {
                    z = k4_raw<Tout, IS_INT>(staged_bits(st, ri.y, rank * 8 * SIZE, 8 * SIZE));
                } else if (kind == STREAM) {  // its 5-byte window from the stream, 0 past the end
                    const uint32_t q = extract<false>(s, n_bytes, st, sp, r_pay[bl * dn + dd], rank,
                                                      width);
                    z = (ri.x >> 8 & 3) == 0 ? k4_raw<Tout, IS_INT>(q)
                                             : k4_scaled<IS_INT>(ri.z, q, ri.w, inv, inv_i);
                }
                o[dd] = (TS)z;
            }
        }
        __syncthreads();
        os.write_out(ost, 8);
        __syncthreads();
    }
    if (tid == 0) {
        if (bad_s) flags[0] = 0;
        if (unfit_s) flags[1] = 0;
    }
}

// the integer instances, at the compiler's choice of registers
template <typename Tout, bool MASKED>
__global__ void __launch_bounds__(STRIP_THREADS) decode_records_strip_kernel(
        const uint8_t* __restrict__ s, long long n_bytes, const int* __restrict__ starts,
        const uint32_t* __restrict__ valid, const int* __restrict__ zmax, double inv, int inv_i,
        int h, int w, int d, int n_rec, int dt, int diff_v5, int cap_nb, int lut_unfit,
        StripGeom g, Tout* __restrict__ img, int* __restrict__ flags) {
    decode_records_strip<Tout, true, MASKED>(s, n_bytes, starts, valid, zmax, inv, inv_i, h, w, d,
                                             n_rec, dt, diff_v5, cap_nb, lut_unfit, g, img, flags);
}

// float32 at 8 CTAs an SM, 32 registers. At the compiler's choice the masked
// instance takes 64 registers (4 CTAs fit) and the all-valid one 40 (6 fit):
// 0.0306 and 0.0231 ms against 0.0266 and 0.0223 on an H100; asking for a
// minimum of 1 CTA gives 105-108 registers and 0.0464 / 0.0409 ms
// (chip_tune_k4f32.py).
template <bool MASKED>
__global__ void __launch_bounds__(STRIP_THREADS, 8) decode_records_strip_f32_kernel(
        const uint8_t* __restrict__ s, long long n_bytes, const int* __restrict__ starts,
        const uint32_t* __restrict__ valid, const int* __restrict__ zmax, double inv, int inv_i,
        int h, int w, int d, int n_rec, int dt, int diff_v5, int cap_nb, int lut_unfit,
        StripGeom g, float* __restrict__ img, int* __restrict__ flags) {
    decode_records_strip<float, false, MASKED>(s, n_bytes, starts, valid, zmax, inv, inv_i, h, w,
                                               d, n_rec, dt, diff_v5, cap_nb, lut_unfit, g, img,
                                               flags);
}

// one launch of the strip kernel: the float32 entry when Tout is float
template <typename Tout, bool MASKED>
void launch_strip(unsigned grid, cudaStream_t st, const uint8_t* words, long long n_bytes,
                  const int* starts, const uint32_t* valid, const int* zmax, double inv,
                  int inv_i, int h, int w, int d, int n_rec, int dt, int diff_v5, int cap_nb,
                  int lut_unfit, StripGeom g, Tout* img, int* flags) {
    if constexpr (std::is_same<Tout, float>::value)
        decode_records_strip_f32_kernel<MASKED><<<grid, STRIP_THREADS, 0, st>>>(
            words, n_bytes, starts, valid, zmax, inv, inv_i, h, w, d, n_rec, dt, diff_v5, cap_nb,
            lut_unfit, g, img, flags);
    else
        decode_records_strip_kernel<Tout, MASKED><<<grid, STRIP_THREADS, 0, st>>>(
            words, n_bytes, starts, valid, zmax, inv, inv_i, h, w, d, n_rec, dt, diff_v5, cap_nb,
            lut_unfit, g, img, flags);
}

template <typename Tout>
int launch_decode(const uint8_t* words, long long n_bytes, const int* starts, const int* valid,
                  const int* zmax, double inv, int inv_i, int h, int w, int d, int dt, int diff_v5,
                  int cap_nb, int lut_unfit, void* img, int* flags, cudaStream_t st) {
    const int n_rec = (h / 8) * (w / 8) * d;
    const StripGeom g = strip_geometry(8, w, d, (int)sizeof(Tout));
    const int grid = (h / 8) * g.spr;
    const uint32_t* v = reinterpret_cast<const uint32_t*>(valid);
    if (valid)
        launch_strip<Tout, true>(grid, st, words, n_bytes, starts, v, zmax, inv, inv_i, h, w, d,
                                 n_rec, dt, diff_v5, cap_nb, lut_unfit, g, static_cast<Tout*>(img),
                                 flags);
    else
        launch_strip<Tout, false>(grid, st, words, n_bytes, starts, nullptr, zmax, inv, inv_i, h,
                                  w, d, n_rec, dt, diff_v5, cap_nb, lut_unfit, g,
                                  static_cast<Tout*>(img), flags);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K6 decode_scanned: decode from record descriptors (of the device scan K5 or
// the host scanner), a port of decode_tiles (device_decode.py:493-708) with
// _unpack_records (:464): 8x8 and 16x16 blocks, all-valid, masked or with
// edge blocks, modes raw, stuff, const-0, const-offset and LUT (mode 4:
// index i -> [0] + entries at lut_pos), float32 (the exact f64 ScaleBack,
// as K4), float64 and every integer dtype, and the depth-diff chains. Each
// stream read clamps its index into the stream, as JAX's gathers do.
//
// float64 (Tout = double) replaces decode_tiles_f64 (device_decode.py
// :716-879), whose ScaleBack and diff chain are softfloat u32 limb
// arithmetic (device_softf64.py) that JAX's band decoder leaves to the host
// for subnormal or non-finite offsets, an extreme invScale or a sum that
// underflows. Here they are native: z = off + q * invScale (__dmul_rn, then
// __dadd_rn), then (zMax < z) ? zMax : z (std::min's pick, NaN included);
// a diff record adds the pre-clamp sum (or the const offset) to the previous
// slice with __dadd_rn and clamps the same way. Offsets of any reduced type
// arrive from the scanner as f64; raw values are 8 bytes.
//
// A strip kernel (above): a chunk's eight descriptor fields are one
// coalesced read each, its records' bytes are staged from the first
// record's payload (or LUT) to the next chunk's payload, one thread a
// record derives its flags; then a thread owns pixels and walks their
// slices in depth order, keeping the previous slice of each in registers
// (across chunks too). A record writes its values at the valid positions,
// by their rank among them -- or, for a stuffed or LUT record whose count
// equals the block's in-image area, at every in-image position
// (decode_tiles:538-548, the host decoder's full-block case); raw and
// const-offset records write the valid positions only (:593). A diff record
// (mode >= 8) adds its offset (+ q * invScale) to the previous slice:
// integers in int32, float32 as (float)min(a + (double)prev, zMax) with a
// the pre-clamp f64 sum offset + q * invScale (:650-698), float64 as
// min(a + prev, zMax); a diff const-0 record copies the previous slice.
//
// ok drops where the host decoder (lerc2_decode.py:233-306, bitstuffer.py
// :191-222) refuses the block: a stuffed count over the block's in-image
// area, or under its valid count and not the area; a LUT index past the LUT
// (every stuffed index is checked); a raw diff record; a diff record on
// slice 0.
//
// Bound: bytes (the stream's `total` bytes and 32 B of descriptors per
// record read once (36 B with an f64 offset), 4*VPL B of validity words per
// masked block, the image written once).
// ---------------------------------------------------------------------------

// One slice's value at one position (decode_tiles :593-698) from its
// record's mode m8 and diff flag, its offset (float32: the bits), quantum q
// (stuffed, LUT) or raw word, the slice's zMax and the previous slice's
// value there; a caller that knows m8 passes it as a constant.
template <typename Tout, bool IS_INT, typename V, typename O>
__device__ __forceinline__ V slice_value(int m8, bool dif, O off, O zm, uint32_t q,
                                         unsigned long long word, V prev, double inv, int inv_i) {
    V z;
    if constexpr (IS_INT) {
        const int a = (int)((uint32_t)off + q * (uint32_t)inv_i);
        z = m8 == 0 ? lerc2::raw_int((uint32_t)word, sizeof(Tout), std::is_signed<Tout>::value)
          : m8 == 2 ? 0 : m8 == 3 ? off
          : std::is_same<Tout, uint32_t>::value  // uint32: the clamp in u32 order
              ? (int)min((uint32_t)a, (uint32_t)zm) : min(a, zm);
        if (dif) {  // :621-622, :643-644; uint32 clamps in u32 order here too
            const int ad = m8 == 3 ? off : a;
            const int t = (int)((uint32_t)ad + (uint32_t)prev);
            z = m8 == 2 ? prev
              : std::is_same<Tout, uint32_t>::value ? (int)min((uint32_t)t, (uint32_t)zm)
                                                    : min(t, zm);
        }
    } else if constexpr (std::is_same<Tout, double>::value) {  // native f64: no narrowing
        const double a = __dadd_rn(off, __dmul_rn((double)q, inv));
        z = m8 == 0 ? __longlong_as_double((long long)word)
          : m8 == 2 ? 0.0 : m8 == 3 ? off : (zm < a ? zm : a);
        if (dif) {
            const double ad = m8 == 3 ? off : a;
            const double t = __dadd_rn(ad, prev);
            z = m8 == 2 ? prev : (zm < t ? zm : t);
        }
    } else {
        const float offf = __int_as_float(off), zmf = __int_as_float(zm);
        const double a = __dadd_rn((double)offf, __dmul_rn((double)q, inv));
        float zs = __double2float_rn(a);
        zs = zmf < zs ? zmf : zs;
        z = m8 == 0 ? __uint_as_float((uint32_t)word) : m8 == 2 ? 0.f : m8 == 3 ? offf : zs;
        if (dif) {  // :650-698
            const double ad = m8 == 3 ? (double)offf : a;
            float t = __double2float_rn(__dadd_rn(ad, (double)prev));
            t = zmf < t ? zmf : t;
            z = m8 == 2 ? prev : t;
        }
    }
    return z;
}

template <typename Tout, bool IS_INT, int MB, bool MASKED>
__global__ void __launch_bounds__(STRIP_THREADS) decode_scanned_kernel(
        const uint8_t* __restrict__ s, long long n_bytes, const int* __restrict__ mode,
        const int* __restrict__ payload_pos, const int* __restrict__ offset,
        const int* __restrict__ num_bits, const int* __restrict__ num_elements,
        const int* __restrict__ lut_pos, const int* __restrict__ n_lut,
        const int* __restrict__ nbits_lut, const uint32_t* __restrict__ valid,
        const int* __restrict__ zmax, double inv, int inv_i, int h, int w, int d, int n_rec,
        StripGeom g, Tout* __restrict__ img, int* __restrict__ ok) {
    constexpr int BP = MB * MB, VPL = BP / 32, SIZE = sizeof(Tout);
    static_assert(STRIP_THREADS >= BP, "a deep tile's chunks carry one pixel a thread");
    constexpr bool F64 = std::is_same<Tout, double>::value;
    using V = typename std::conditional<IS_INT, int, Tout>::type;
    using O = typename std::conditional<F64, double, int>::type;  // offsets, zMax (float32: bits)
    // a record's kind: how its values are read (warp-uniform: a warp decodes one record)
    enum { OTHER, STUFF, RAW, CONST, ZERO };
    __shared__ uint4 in_st[STRIP_IN / 16 + 1];
    __shared__ uint4 out_st[STRIP_STAGE / 16];
    __shared__ int4 r4[STRIP_REC];  // m8 | diff << 3 | all << 4 | nb << 8 (nb < 32: 5 header
                                    // bits) | kind << 16, staged payload, offset bits, zMax bits
    __shared__ int r_pp[STRIP_REC];
    __shared__ double r64[F64 ? 2 * STRIP_REC : 1];  // float64: offsets, zMax
    __shared__ uint32_t vws[STRIP_BLK * VPL];
    __shared__ int pre[STRIP_BLK * VPL], cnts[STRIP_BLK];
    __shared__ int bad_s, span_s[2];
    const uint32_t* st = reinterpret_cast<const uint32_t*>(in_st);
    uint8_t* ost = reinterpret_cast<uint8_t*>(out_st);
    const int tid = threadIdx.x;
    const int nbh = (w + MB - 1) / MB;
    const int sr = blockIdx.x / g.spr, sc = blockIdx.x - sr * g.spr;
    const int b0 = sr * nbh + sc * g.S, n_s = min(g.S, nbh - sc * g.S);
    const int row0 = sr * MB, col0 = sc * g.S * MB;
    const int rows_in = min(MB, h - row0);
    if (tid == 0) {
        bad_s = 0;
        span_s[0] = INT_MAX;
        span_s[1] = INT_MIN;
    }
    if (tid < n_s) {  // the block's valid positions (in the image) and their prefix counts
        const int cols_in = min(MB, w - (col0 + tid * MB));
        const uint32_t row_bits = (1u << cols_in) - 1u;
        int c = 0;
#pragma unroll
        for (int k = 0; k < VPL; ++k) {
            uint32_t iw = 0;
#pragma unroll
            for (int rr = 0; rr < 32 / MB; ++rr)
                if (k * (32 / MB) + rr < rows_in) iw |= row_bits << (rr * MB);
            const uint32_t vw = MASKED ? valid[(size_t)(b0 + tid) * VPL + k] & iw : iw;
            vws[tid * VPL + k] = vw;
            pre[tid * VPL + k] = c;
            c += __popc(vw);
        }
        cnts[tid] = c;
    }
    OutStage os{reinterpret_cast<uint8_t*>(img), h, w, d, (int)sizeof(Tout), row0, col0, 0, 0,
                g.px_seg, g.pitch, g.S * MB / g.px_seg};
    __syncthreads();
    V carry = 0;  // the previous slice across chunks: deep tiles have one pixel a thread
    bool bad = false;
    for (int dlo = 0; dlo < d; dlo += g.dc) {
        const int dn = min(g.dc, d - dlo), n_r = n_s * dn;
        const long long ra = (long long)b0 * d + dlo;  // the chunk's records are consecutive
        os.dlo = dlo;
        os.dn = dn;
        int m8 = 2, nb = 0, pp = 0, n_read = 0;  // this thread's record: bytes its values span
        if (tid < n_r) {  // the record's flags, payload span, and whether it writes every
                          // in-image position
            const long long r = ra + tid;
            const int m = mode[r], ne = num_elements[r];
            nb = num_bits[r];
            pp = payload_pos[r];
            const int bl = tid / dn, di = dlo + tid - bl * dn;
            const int area = rows_in * min(MB, w - (col0 + bl * MB)), cnt = cnts[bl];
            m8 = m & 7;
            const bool dif = m >= 8, stuffed = m8 == 1 || m8 == 4;
            bad |= (stuffed && (ne > area || (ne != area && ne < cnt))) || (dif && (m8 == 0 || di == 0));
            const bool all = stuffed && ne == area;
            n_read = m8 == 1 ? ((max((all ? area : cnt) - 1, 0) * nb) >> 3) + 5 : cnt * SIZE;
            if constexpr (F64) {
                r64[tid] = reinterpret_cast<const double*>(offset)[r];
                r64[STRIP_REC + tid] = reinterpret_cast<const double*>(zmax)[di];
            }
            const int kind = m8 == 3 ? CONST : m8 == 2 ? ZERO : OTHER;
            r4[tid] = make_int4(m8 | (dif ? 8 : 0) | (all ? 16 : 0) | nb << 8 | kind << 16, 0,
                                F64 ? 0 : offset[r], F64 ? 0 : zmax[di]);
            r_pp[tid] = pp;
            if (m8 == 0 || stuffed) {
                const long long bits = m8 == 0 ? 8LL * cnt * SIZE
                                     : (long long)ne * (m8 == 4 ? nbits_lut[r] : nb);
                const long long e = min((long long)pp + ((bits + 7) >> 3), (long long)INT_MAX);
                atomicMin(&span_s[0], m8 == 4 ? min(pp, lut_pos[r]) : pp);
                atomicMax(&span_s[1], (int)e);
            }
        }
        __syncthreads();
        const Span sp = stage_span(s, n_bytes, span_s[0], (long long)span_s[1] + 8, in_st);
        // staged: a stuffed record whose values' 5-byte windows, or a raw one of up to 4-byte
        // values whose values, lie in the staged bytes
        if ((m8 == 1 || (m8 == 0 && SIZE <= 4)) && pp >= sp.vlo
            && (long long)pp + n_read <= sp.vhi) {
            r4[tid].x |= (m8 == 1 ? STUFF : RAW) << 16;
            r4[tid].y = (int)(pp - sp.gb);
        }
        __syncthreads();
        if (tid == 0) {  // every thread has read the span: reset it for the next chunk
            span_s[0] = INT_MAX;
            span_s[1] = INT_MIN;
        }

        // a thread's pixels: position j of blocks bl0, bl0 + KB, ...
        constexpr int KB = STRIP_THREADS / BP;
        const int j = tid % BP, bl0 = tid / BP, y = j / MB, jc = j % MB;
        uint8_t* const o0 = ost + os.offset(y, bl0 * MB + jc);
#pragma unroll 1
        for (int k = 0; k < STRIP_PPT; ++k) {
            const int bl = bl0 + k * KB;
            if (bl >= n_s) break;
            V prev = k == 0 ? carry : V(0);
            const int cols_in = min(MB, w - (col0 + bl * MB));
            const bool in_img = y < rows_in && jc < cols_in;
            const int rank_i = y * cols_in + min(jc, cols_in);  // among the in-image positions
            // valid: without a mask the in-image positions, ranked alike
            bool v = in_img;
            int rank_v = rank_i;
            if constexpr (MASKED) {
                const uint32_t vw = vws[bl * VPL + (j >> 5)];
                v = (vw >> (j & 31)) & 1u;
                rank_v = pre[bl * VPL + (j >> 5)] + __popc(vw & ((1u << (j & 31)) - 1u));
            }
            Tout* o = reinterpret_cast<Tout*>(o0 + k * KB * MB * dn * (int)sizeof(Tout));
            const int4* rrow = r4 + bl * dn;
            for (int dd = 0; dd < dn; ++dd) {
                const int i = bl * dn + dd;
                const int4 ri = rrow[dd];
                const int kind = ri.x >> 16;
                const bool dif = ri.x & 8, use_all = ri.x & 16;
                const int nbi = (ri.x >> 8) & 31;
                O off, zm;
                if constexpr (F64) {
                    off = r64[i];
                    zm = r64[STRIP_REC + i];
                } else {
                    off = ri.z;
                    zm = ri.w;
                }
                const bool e = use_all ? in_img : v;  // the positions the record writes
                const int rank = use_all ? rank_i : rank_v;
                V z = 0;
                if (kind == STUFF) {  // staged stuffed values (rank 0 where none is written)
                    const uint32_t q = staged_bits(st, ri.y, (e ? rank : 0) * nbi, nbi);
                    const V a = dif ? slice_value<Tout, IS_INT, V, O>(1, true, off, zm, q, 0, prev,
                                                                      inv, inv_i)
                                    : slice_value<Tout, IS_INT, V, O>(1, false, off, zm, q, 0, prev,
                                                                      inv, inv_i);
                    z = e ? a : V(0);
                } else if (kind == CONST || kind == ZERO) {
                    const V a = dif ? slice_value<Tout, IS_INT, V, O>(kind == CONST ? 3 : 2, true,
                                                                      off, zm, 0, 0, prev, inv,
                                                                      inv_i)
                                    : slice_value<Tout, IS_INT, V, O>(kind == CONST ? 3 : 2, false,
                                                                      off, zm, 0, 0, prev, inv,
                                                                      inv_i);
                    z = v ? a : V(0);
                } else if (kind == RAW) {  // staged raw values of up to 4 bytes
                    if (v) z = slice_value<Tout, IS_INT, V, O>(
                        0, dif, off, zm, 0, staged_bits(st, ri.y, rank_v * 8 * SIZE, 8 * SIZE), prev,
                        inv, inv_i);
                } else {  // LUT records, reads outside the staged bytes, any other mode
                    const int m8 = ri.x & 7;
                    uint32_t q = 0;
                    unsigned long long word = 0;
                    if (m8 == 4) {  // every stuffed index must lie in the LUT (bitstuffer.py:220)
                        const long long r = ra + i;
                        const int nl = n_lut[r], nbl = nbits_lut[r];
                        if (j < min(num_elements[r], BP))
                            bad |= (int)extract(s, n_bytes, st, sp, r_pp[i], j, nbl) > nl;
                        if (e) {
                            const uint32_t idx = extract(s, n_bytes, st, sp, r_pp[i], rank, nbl);
                            q = idx ? extract(s, n_bytes, st, sp, lut_pos[r], (long long)idx - 1,
                                              nbi) : 0u;
                        }
                    } else if (e && m8 == 1) {
                        q = extract(s, n_bytes, st, sp, r_pp[i], rank, nbi);
                    }
                    if (m8 == 0 && v) {
                        word = bytes_at<true>(s, n_bytes, st, sp,
                                              r_pp[i] + (long long)rank * SIZE, SIZE);
                        if (SIZE < 8) word &= (1ull << (8 * SIZE)) - 1;
                    }
                    const bool write = (m8 == 3 || m8 == 0) ? v : e;
                    if (write) z = slice_value<Tout, IS_INT, V, O>(m8, dif, off, zm, q, word, prev,
                                                                   inv, inv_i);
                }
                prev = z;
                if (in_img) o[dd] = (Tout)z;
            }
            if (k == 0) carry = prev;
        }
        __syncthreads();
        os.write_out(ost, MB);
        __syncthreads();
    }
    if (bad) bad_s = 1;
    __syncthreads();
    if (tid == 0 && bad_s) ok[0] = 0;
}

template <typename Tout, bool IS_INT, int MB, bool MASKED>
int launch_scanned(const uint8_t* words, long long n_bytes, const int* mode,
                   const int* payload_pos, const int* offset, const int* num_bits,
                   const int* num_elements, const int* lut_pos, const int* n_lut,
                   const int* nbits_lut, const int* valid, const int* zmax, double inv, int inv_i,
                   int h, int w, int d, void* img, int* ok, cudaStream_t st) {
    const int nbv = (h + MB - 1) / MB, nbh = (w + MB - 1) / MB;
    const StripGeom g = strip_geometry(MB, w, d, (int)sizeof(Tout));
    decode_scanned_kernel<Tout, IS_INT, MB, MASKED><<<nbv * g.spr, STRIP_THREADS, 0, st>>>(
        words, n_bytes, mode, payload_pos, offset, num_bits, num_elements, lut_pos, n_lut,
        nbits_lut, reinterpret_cast<const uint32_t*>(valid), zmax, inv, inv_i, h, w, d,
        nbv * nbh * d, g, static_cast<Tout*>(img), ok);
    return (int)cudaGetLastError();
}

// the (block size, mask) instance of one output type
template <typename Tout, bool IS_INT>
int launch_scanned_of(int mb, const uint8_t* words, long long n_bytes, const int* mode,
                      const int* payload_pos, const int* offset, const int* num_bits,
                      const int* num_elements, const int* lut_pos, const int* n_lut,
                      const int* nbits_lut, const int* valid, const int* zmax, double inv,
                      int inv_i, int h, int w, int d, void* img, int* ok, cudaStream_t st) {
#define K6_ARGS words, n_bytes, mode, payload_pos, offset, num_bits, num_elements, lut_pos, n_lut, \
                nbits_lut, valid, zmax, inv, inv_i, h, w, d, img, ok, st
    if (mb == 8)
        return valid ? launch_scanned<Tout, IS_INT, 8, true>(K6_ARGS)
                     : launch_scanned<Tout, IS_INT, 8, false>(K6_ARGS);
    if (mb == 16)
        return valid ? launch_scanned<Tout, IS_INT, 16, true>(K6_ARGS)
                     : launch_scanned<Tout, IS_INT, 16, false>(K6_ARGS);
#undef K6_ARGS
    return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// K4 for the mosaic (decode_records_lut, decode_records_lut16): the indexed
// decode with LUT records, 8x8 or 16x16 blocks, n units (tiles, or a tile's
// bands) in one record axis and the depth-diff chain -- decode_tiles_fast
// with enable_lut (:233-247, :325-341), mb = 16 (:118-123) and n_tiles
// (:92-95), with the chain of decode_tiles (:625-698). Record r of unit u is
// at starts[u * unit_rec + r], an absolute byte offset into the one stream;
// zmax is [n_units, D] and the validity words are the units' blocks in order.
//
// A LUT record (mode 1, numBits byte bit 5) is [header][count][nLut + 1]
// [nLut entries at numBits][indices at bit_length(nLut) bits]
// (BitStuffer2.cpp:79-153): value j reads its index at its rank, then entry
// index - 1 (index 0 is 0, the block minimum). There is no 128-lane window:
// 16x16 records of any width up to the dtype's decode (JAX caps them at 11
// bits, :118-123); `fits` only means no record is wider than cap_nb.
//
// float32 dequantizes with the exact f64 ScaleBack of K4; integers as the
// integer K4, uint32 with an unsigned zMax clamp. A depth-diff record (flag
// bit 2 at version >= 5; an integer's offset reduced as INT) adds the
// previous slice as K6 does (slice_value). Per unit the kernel reports
// {index_ok, fits, scanned}: index_ok drops on a record whose parsed length
// disagrees with the next index entry (each unit's last record is exempt), a
// stuffed count other than the block's valid count, or a LUT bit when lut is
// 0; scanned is set by a diff record the chain cannot take -- on slice 0, or
// raw, which the host decoder refuses -- and the caller sends that unit to
// the scanned decode, which raises as the host decoder does.
//
// A strip kernel (above) on a grid of units x block rows x strips; a strip
// never crosses a unit. As the integer K4: a chunk's starts in one read, its
// records' bytes staged, one thread a record parses its header (two 8-byte
// reads) and flags; then a thread owns pixels and walks their depths in
// order, the previous slice in a register (across chunks too, as K6). LUT
// records read their table and indices from the staged bytes; a read outside
// them (a hostile start, an index past the table) goes to the stream, 0
// outside it. Flags are reduced in the CTA and stored once, where one drops.
// The launch bounds ask for 6 CTAs an SM (40 registers; at its own 64, 4 fit:
// 0.1287 ms against 0.1130 on the uint8 x 3 group, chip_tune_k4k2.py).
//
// Bound: bytes (the units' stream bytes and 4 B of index per record read
// once, 4*VPL B of validity words per masked block, the images written once).
// ---------------------------------------------------------------------------

template <typename Tout, bool IS_INT, int MB, bool MASKED>
__global__ void __launch_bounds__(STRIP_THREADS, 6) decode_records_lut_kernel(
        const uint8_t* __restrict__ s, long long n_bytes, const int* __restrict__ starts,
        const uint32_t* __restrict__ valid, const int* __restrict__ zmax, double inv, int inv_i,
        int h, int w, int d, int unit_rec, int strips_unit, int dt, int version5, int lut,
        int cap_nb, StripGeom g, Tout* __restrict__ img, int* __restrict__ flags) {
    constexpr int BP = MB * MB, VPL = BP / 32, SIZE = sizeof(Tout);
    static_assert(STRIP_THREADS >= BP, "a deep unit's chunks carry one pixel a thread");
    using V = typename std::conditional<IS_INT, int, Tout>::type;
    // a record's kind: how its values are read (warp-uniform: a warp decodes one record)
    enum { ZERO, CONST, STUFF, LUT, RAW, STREAM };
    constexpr int DIF = 1 << 10, IS_LUT = 1 << 11;
    __shared__ uint4 in_st[STRIP_IN / 16 + 1];
    __shared__ uint4 out_st[STRIP_STAGE / 16];
    __shared__ int sst[STRIP_REC + 1];
    __shared__ int4 r4[STRIP_REC];  // width | mode << 8 | DIF | IS_LUT | kind << 16, staged
                                    // payload, offset (float32: its bits), zMax (bits)
    __shared__ int4 rl[STRIP_REC];  // LUT: n_lut, bit_length(n_lut), table bytes
    __shared__ long long r_pay[STRIP_REC];
    __shared__ uint32_t vws[STRIP_PX / 32];
    __shared__ int pre[STRIP_PX / 32], cnts[STRIP_BLK];
    __shared__ int bad_s, unfit_s, scan_s;
    const uint32_t* st = reinterpret_cast<const uint32_t*>(in_st);
    uint8_t* ost = reinterpret_cast<uint8_t*>(out_st);
    const int tid = threadIdx.x;
    const int nbh = w / MB;
    const int u = blockIdx.x / strips_unit, su = blockIdx.x - u * strips_unit;
    const int sr = su / g.spr, sc = su - sr * g.spr;
    const int b0 = sr * nbh + sc * g.S, n_s = min(g.S, nbh - sc * g.S);
    const int* ust = starts + (size_t)u * unit_rec;
    if (tid == 0) bad_s = unfit_s = scan_s = 0;
    if (tid < n_s) {  // the block's validity words and their prefix counts
        int c = 0;
#pragma unroll
        for (int k = 0; k < VPL; ++k) {
            const uint32_t vw =
                MASKED ? valid[((size_t)u * (unit_rec / d) + b0 + tid) * VPL + k] : FULL;
            vws[tid * VPL + k] = vw;
            pre[tid * VPL + k] = c;
            c += __popc(vw);
        }
        cnts[tid] = c;
    }
    OutStage os{reinterpret_cast<uint8_t*>(img + (size_t)u * h * w * d), h, w, d, SIZE, sr * MB,
                sc * g.S * MB, 0, 0, g.px_seg, g.pitch, g.S * MB / g.px_seg};
    V carry = 0;  // the previous slice across chunks: deep units have one pixel a thread
    for (int dlo = 0; dlo < d; dlo += g.dc) {
        const int dn = min(g.dc, d - dlo), n_r = n_s * dn;
        const int ra = b0 * d + dlo, rb = ra + n_r;  // consecutive records of the unit
        os.dlo = dlo;
        os.dn = dn;
        for (int t = tid; t <= n_r; t += STRIP_THREADS) sst[t] = ra + t < unit_rec ? ust[ra + t] : 0;
        const long long lo = ust[ra];
        const long long end = (rb < unit_rec ? (long long)ust[rb] : n_bytes) + 8;
        const Span sp = stage_span(s, n_bytes, lo, end, in_st);
        __syncthreads();

        if (tid < n_r) {  // the record's header (Lerc2.cpp:1950-2021) and flags
            const int bl = tid / dn, di = dlo + tid - bl * dn;
            const long long p = sst[tid];
            const uint64_t h0 = bytes_at<false>(s, n_bytes, st, sp, p, 8);
            const uint64_t h1 = bytes_at<false>(s, n_bytes, st, sp, p + 8, 4);
            auto hbyte = [&](int k) -> uint32_t {
                return (uint32_t)((k < 8 ? h0 >> (8 * k) : h1 >> (8 * (k - 8))) & 0xFFu);
            };
            const uint32_t flag = hbyte(0);
            const int mode = flag & 3, b67 = flag >> 6;
            const bool dif = version5 && (flag & 4u);
            const int odt = IS_INT && dif ? lerc2::DT_INT : dt;
            const int off_w = lerc2::offset_width(odt, b67);
            uint32_t acc = (uint32_t)(h0 >> 8);
            acc &= off_w == 1 ? 0xFFu : (off_w == 2 ? 0xFFFFu : 0xFFFFFFFFu);
            const uint32_t nbb = hbyte(1 + off_w);
            const int cw_code = nbb >> 6;
            const int cw = cw_code == 0 ? 4 : 3 - cw_code;
            const int nb = nbb & 31;
            const bool is_lut = (nbb & 32) && mode == 1;
            const int n_lut = is_lut ? (int)hbyte(2 + off_w + cw) - 1 : 0;
            const int nbl = n_lut > 0 ? 32 - __clz(n_lut) : 0;
            const int lut_bytes = (n_lut * nb + 7) >> 3;
            const long long pay = mode == 0 ? p + 1 : p + 2 + off_w + cw + (is_lut ? 1 : 0);
            const int width = mode == 0 ? 8 * SIZE : nb;
            const int cnt = cnts[bl];
            // staged when every value's 5-byte window lies in the staged bytes (a LUT
            // record: its indices; an entry within the table lies before them)
            const long long last = is_lut ? pay + lut_bytes + ((max(cnt - 1, 0) * nbl) >> 3)
                                          : pay + ((max(cnt - 1, 0) * width) >> 3);
            const bool staged = pay >= sp.vlo && (!is_lut || lut_bytes >= 0) && last + 5 <= sp.vhi;
            const int kind = mode == 2 ? ZERO : mode == 3 ? CONST : !staged ? STREAM
                           : is_lut ? LUT : mode == 1 ? STUFF : RAW;
            int off;
            if constexpr (IS_INT) off = lerc2::int_offset(acc, off_w, odt, b67);
            else off = __float_as_int(lerc2::float_offset(acc, b67));
            r4[tid] = make_int4(width | mode << 8 | (dif ? DIF : 0) | (is_lut ? IS_LUT : 0)
                                    | kind << 16,
                                staged ? (int)(pay - sp.gb) : 0, off, zmax[(size_t)u * d + di]);
            rl[tid] = make_int4(n_lut, nbl, lut_bytes, 0);
            r_pay[tid] = pay;
            const uint32_t ne = hbyte(2 + off_w) | (cw == 2 ? hbyte(3 + off_w) << 8 : 0u);
            const long long length =
                mode == 2 ? 1
                : mode == 3 ? 1 + off_w
                : mode == 0 ? 1 + (long long)cnt * SIZE
                : is_lut ? 1 + off_w + 1 + cw + 1 + lut_bytes + (((long long)ne * nbl + 7) >> 3)
                         : 1 + off_w + 1 + cw + (((long long)ne * nb + 7) >> 3);
            bool bad = (mode == 1 && (int)ne != cnt) || (is_lut && !lut);
            if (ra + tid != unit_rec - 1) {
                const int delta = (int)((uint32_t)sst[tid + 1] - (uint32_t)sst[tid]);
                bad |= delta != length;
            }
            if (bad) bad_s = 1;
            if ((mode == 0 || mode == 1) && width > cap_nb) unfit_s = 1;
            if (dif && (di == 0 || mode == 0)) scan_s = 1;
        }
        __syncthreads();

        // a thread's pixels: position j of blocks bl0, bl0 + KB, ...
        constexpr int KB = STRIP_THREADS / BP;
        const int j = tid % BP, bl0 = tid / BP;
        uint8_t* const o0 = ost + os.offset(j / MB, bl0 * MB + j % MB);
#pragma unroll 1
        for (int k = 0; k < STRIP_PPT; ++k) {
            const int bl = bl0 + k * KB;
            if (bl >= n_s) break;
            Tout* o = reinterpret_cast<Tout*>(o0 + k * KB * MB * dn * SIZE);
            int rank = j;
            if constexpr (MASKED) {
                const uint32_t vw = vws[bl * VPL + (j >> 5)];
                if (!((vw >> (j & 31)) & 1u)) {  // an invalid position decodes to 0
                    for (int dd = 0; dd < dn; ++dd) o[dd] = Tout(0);
                    continue;
                }
                rank = pre[bl * VPL + (j >> 5)] + __popc(vw & ((1u << (j & 31)) - 1u));
            }
            V prev = k == 0 ? carry : V(0);
            const int4* rrow = r4 + bl * dn;
            for (int dd = 0; dd < dn; ++dd) {
                const int4 ri = rrow[dd];
                const int kind = ri.x >> 16, width = ri.x & 63;
                const bool dif = ri.x & DIF;
                // slice_value, the record's mode a constant where the kind fixes it
                auto value = [&](int m8, uint32_t q, uint32_t word) -> V {
                    return dif ? slice_value<Tout, IS_INT, V, int>(m8, true, ri.z, ri.w, q, word,
                                                                   prev, inv, inv_i)
                               : slice_value<Tout, IS_INT, V, int>(m8, false, ri.z, ri.w, q, word,
                                                                   prev, inv, inv_i);
                };
                V z;
                if (kind == STUFF) {
                    z = value(1, staged_bits(st, ri.y, rank * width, width), 0u);
                } else if (kind == CONST) {
                    z = value(3, 0u, 0u);
                } else if (kind == ZERO) {
                    z = dif ? prev : V(0);
                } else if (kind == LUT) {
                    const int4 L = rl[bl * dn + dd];
                    const uint32_t idx = L.y ? staged_bits(st, ri.y + L.z, rank * L.y, L.y) : 0u;
                    uint32_t q = 0;
                    if (idx && (int)idx - 1 < L.x) q = staged_bits(st, ri.y, (idx - 1) * width, width);
                    else if (idx)  // an index past the table
                        q = extract<false>(s, n_bytes, st, sp, r_pay[bl * dn + dd], idx - 1, width);
                    z = value(1, q, 0u);
                } else if (kind == RAW) {
                    z = value(0, 0u, staged_bits(st, ri.y, rank * 8 * SIZE, 8 * SIZE));
                } else {  // STREAM: 5-byte windows from the stream, 0 past the end
                    const int i = bl * dn + dd, m8 = (ri.x >> 8) & 3;
                    uint32_t v;
                    if (ri.x & IS_LUT) {
                        const int4 L = rl[i];
                        const uint32_t idx = extract<false>(s, n_bytes, st, sp, r_pay[i] + L.z,
                                                            rank, L.y);
                        v = idx ? extract<false>(s, n_bytes, st, sp, r_pay[i], idx - 1, width) : 0u;
                    } else {
                        v = extract<false>(s, n_bytes, st, sp, r_pay[i], rank, width);
                    }
                    z = value(m8, m8 == 0 ? 0u : v, m8 == 0 ? v : 0u);
                }
                prev = z;
                o[dd] = (Tout)z;
            }
            if (k == 0) carry = prev;
        }
        __syncthreads();
        os.write_out(ost, MB);
        __syncthreads();
    }
    if (tid == 0) {
        if (bad_s) flags[3 * u] = 0;
        if (unfit_s) flags[3 * u + 1] = 0;
        if (scan_s) flags[3 * u + 2] = 1;
    }
}

template <typename Tout, bool IS_INT, int MB>
int launch_lut(const uint8_t* words, long long n_bytes, const int* starts, const int* valid,
               const int* zmax, double inv, int inv_i, int h, int w, int d, int n_units, int dt,
               int version5, int lut, int cap_nb, void* img, int* flags, cudaStream_t st) {
    const int nbv = h / MB;
    const int unit_rec = nbv * (w / MB) * d;
    const StripGeom g = strip_geometry(MB, w, d, (int)sizeof(Tout));
    const long long strips_unit = (long long)nbv * g.spr;
    const long long grid = strips_unit * n_units;
    if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
    if (grid == 0) return 0;
    const uint32_t* v = reinterpret_cast<const uint32_t*>(valid);
    Tout* out = static_cast<Tout*>(img);
    if (valid)
        decode_records_lut_kernel<Tout, IS_INT, MB, true><<<(unsigned)grid, STRIP_THREADS, 0, st>>>(
            words, n_bytes, starts, v, zmax, inv, inv_i, h, w, d, unit_rec, (int)strips_unit, dt,
            version5, lut, cap_nb, g, out, flags);
    else
        decode_records_lut_kernel<Tout, IS_INT, MB, false><<<(unsigned)grid, STRIP_THREADS, 0, st>>>(
            words, n_bytes, starts, nullptr, zmax, inv, inv_i, h, w, d, unit_rec,
            (int)strips_unit, dt, version5, lut, cap_nb, g, out, flags);
    return (int)cudaGetLastError();
}

template <typename Tout, bool IS_INT>
int launch_lut_of(int mb, const uint8_t* words, long long n_bytes, const int* starts,
                  const int* valid, const int* zmax, double inv, int inv_i, int h, int w, int d,
                  int n_units, int dt, int version5, int lut, int cap_nb, void* img, int* flags,
                  cudaStream_t st) {
#define K4L_ARGS words, n_bytes, starts, valid, zmax, inv, inv_i, h, w, d, n_units, dt, version5, \
                 lut, cap_nb, img, flags, st
    if (mb == 8) return launch_lut<Tout, IS_INT, 8>(K4L_ARGS);
    if (mb == 16) return launch_lut<Tout, IS_INT, 16>(K4L_ARGS);
#undef K4L_ARGS
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// Integer K4: img in the dtype `dt` (0..5), zmax [D] int32; flags as K4
extern "C" int decode_records_int(const uint8_t* words, long long n_bytes, const int* starts,
                                  const int* valid, const int* zmax, int inv_i, int h, int w,
                                  int d, int dt, int size_t_, int is_signed, int diff_v5,
                                  int cap_nb, int lut_unfit, void* img, int* flags,
                                  void* stream) {
    (void)size_t_, (void)is_signed;  // the instance's Tout: dt's size and sign
    cudaStream_t st = (cudaStream_t)stream;
#define K4I_ARGS words, n_bytes, starts, valid, zmax, 0.0, inv_i, h, w, d, dt, diff_v5, cap_nb, \
                 lut_unfit, img, flags, st
    switch (dt) {
        case 0: return launch_decode<int8_t>(K4I_ARGS);
        case 1: return launch_decode<uint8_t>(K4I_ARGS);
        case 2: return launch_decode<int16_t>(K4I_ARGS);
        case 3: return launch_decode<uint16_t>(K4I_ARGS);
        case 4: return launch_decode<int32_t>(K4I_ARGS);
        case 5: return launch_decode<uint32_t>(K4I_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
#undef K4I_ARGS
}

// K6: dt 0..5, 6 (float32: offset and zmax hold f32 bits) or 7 (float64:
// offset [nRec] and zmax [D] are f64 arrays); mb 8 or 16;
// valid: [nBlocks, mb*mb/32] u32 validity words, or null for an all-valid
// image; ok: 1 int32 set to 1 by the caller
extern "C" int decode_scanned(const uint8_t* words, long long n_bytes, const int* mode,
                              const int* payload_pos, const int* offset, const int* num_bits,
                              const int* num_elements, const int* lut_pos, const int* n_lut,
                              const int* nbits_lut, const int* valid, const int* zmax, double inv,
                              int inv_i, int h, int w, int d, int mb, int dt, int size_t_,
                              int is_signed, void* img, int* ok, void* stream) {
    (void)size_t_, (void)is_signed;  // the instance's Tout: dt's size and sign
    cudaStream_t st = (cudaStream_t)stream;
#define K6_ARGS mb, words, n_bytes, mode, payload_pos, offset, num_bits, num_elements, lut_pos, \
                n_lut, nbits_lut, valid, zmax, inv, inv_i, h, w, d, img, ok, st
    switch (dt) {
        case 0: return launch_scanned_of<int8_t, true>(K6_ARGS);
        case 1: return launch_scanned_of<uint8_t, true>(K6_ARGS);
        case 2: return launch_scanned_of<int16_t, true>(K6_ARGS);
        case 3: return launch_scanned_of<uint16_t, true>(K6_ARGS);
        case 4: return launch_scanned_of<int32_t, true>(K6_ARGS);
        case 5: return launch_scanned_of<uint32_t, true>(K6_ARGS);
        case 6: return launch_scanned_of<float, false>(K6_ARGS);
        case 7: return launch_scanned_of<double, false>(K6_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
#undef K6_ARGS
}

// K4, float32: flags 2 int32 set to 1 by the caller; valid: [nBlocks, 2]
// u32 validity words, or null for an all-valid image (then the all-valid
// instance runs); zmax [D] f32, inv the f64 invScale; diff_v5: version >= 5
// (a depth-diff record then clears index_ok)
extern "C" int decode_records(const uint8_t* words, long long n_bytes, const int* starts,
                              const int* valid, const float* zmax, double inv, int h, int w,
                              int d, int diff_v5, int cap_nb, int lut_unfit, float* img,
                              int* flags, void* stream) {
    return launch_decode<float>(words, n_bytes, starts, valid, reinterpret_cast<const int*>(zmax),
                                inv, 0, h, w, d, lerc2::DT_FLOAT, diff_v5, cap_nb, lut_unfit, img,
                                flags, (cudaStream_t)stream);
}

// K4 for the mosaic: n_units units of [H, W, D] (H, W multiples of mb, 8 or
// 16) in one record axis; dt 0..5 or 6 (float32: zmax holds f32 bits);
// zmax [n_units, D]; valid: [n_units * nBlocks, mb*mb/32] u32 validity words
// or null (every pixel valid); flags [n_units, 3] int32 set to {1, 1, 0} by
// the caller; img [n_units, H, W, D] in the dtype
extern "C" int decode_records_lut(const uint8_t* words, long long n_bytes, const int* starts,
                                  const int* valid, const int* zmax, double inv, int inv_i,
                                  int h, int w, int d, int mb, int n_units, int dt, int size_t_,
                                  int is_signed, int version5, int lut, int cap_nb, void* img,
                                  int* flags, void* stream) {
    (void)size_t_, (void)is_signed;  // the instance's Tout: dt's size and sign
    cudaStream_t st = (cudaStream_t)stream;
#define K4L_ARGS mb, words, n_bytes, starts, valid, zmax, inv, inv_i, h, w, d, n_units, dt, \
                 version5, lut, cap_nb, img, flags, st
    switch (dt) {
        case 0: return launch_lut_of<int8_t, true>(K4L_ARGS);
        case 1: return launch_lut_of<uint8_t, true>(K4L_ARGS);
        case 2: return launch_lut_of<int16_t, true>(K4L_ARGS);
        case 3: return launch_lut_of<uint16_t, true>(K4L_ARGS);
        case 4: return launch_lut_of<int32_t, true>(K4L_ARGS);
        case 5: return launch_lut_of<uint32_t, true>(K4L_ARGS);
        case 6: return launch_lut_of<float, false>(K4L_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
#undef K4L_ARGS
}
