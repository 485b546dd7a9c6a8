// K5 scan_records: the record starts of a Lerc2 tile stream without the
// encoder's index, and each record's descriptors.
//
// Replaces lerc_tpu/ops/device_scan.py::scan_records_device (:35-181). The
// TPU version computes a speculative record size at every byte of the
// stream, the jump table J[p] = min(p + size(p), S) with a sentinel
// J[S] = S, and resolves the starts rp[i] = J^i(0) by ceil(log2 nRec)
// pointer-doubling steps over the whole table: O(S log nRec) work and
// traffic. Here the chain is followed in one pass over the stream's first
// `total` bytes, in chunks of CHUNK bytes, by three kernels:
//   scan_records_maps   one CTA a chunk: the chunk (and a 16-byte halo) in
//                       shared memory with 16-byte loads, J at every byte
//                       (32-bit chunk positions, stored as u16 for emit),
//                       then pointer jumping in shared memory until every
//                       position's (records, exit) pair leaves the chunk;
//                       the pairs of the chunk's first WIN positions, the
//                       entries a record from an earlier chunk can land
//                       on, are the chunk's map.
//   scan_records_join   one CTA a batch of 32 chunks: its threads compose
//                       the batch's maps from each entry of its first chunk
//                       at once; then, in ticket order, each CTA takes where
//                       the chain enters from the CTA before (a look-back
//                       word in device memory), publishes where it leaves
//                       (one lookup), and gives each chunk it enters its
//                       entry, its first record index and its record count.
//                       An entry outside the maps (a record longer than WIN,
//                       a corrupt stream, a chain past `total`) makes its CTA
//                       walk the rest of the chain alone, record by record
//                       from the stream where no map holds it, exactly, and
//                       write those records; positions past the chain's end
//                       (J reached S before nRec records) are S.
//   scan_records_emit   one CTA a chunk entered: its J from maps, the chunk's
//                       record starts from its entry by rank doubling in
//                       shared memory (J^(2^k) squared in place of the
//                       whole stream's), and the descriptors at each start.
// The last record sets chain_ok: it starts before `total` and ends at it.
// Every output equals the plain version's on any stream (truncated,
// corrupt, or whose chain ends before nRec).
//
// Where this differs from JAX, JAX is wrong: at version >= 5 a record with
// flag bit 2 is a depth-diff record, whose offset an integer dtype reduces
// as DataType INT (lerc2_decode.py:241-269), and its mode is reported + 8
// as the native scanner does. JAX takes the image dtype's width there and
// loses the chain after the first such record.
//
// Bound: bytes, the stream read once and 36 B of descriptors written per
// record. The header decode at every byte and the pointer jumping in
// shared memory are the work above it; J's u16 copy adds 4 B a stream byte
// (written once, read once); the join's chain of batches is serial, one
// look-back word a batch of 32 chunks.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "record.cuh"

namespace {

constexpr int CHUNK = 16384;       // stream bytes a CTA solves (positions fit 16 bits)
static_assert((CHUNK & (CHUNK - 1)) == 0, "the join divides by CHUNK with shifts");
constexpr int HALO = 16;           // a header reads at most 11 bytes from its start
constexpr int WIN = 512;           // a map's entry positions: >= any record of an 8x8
                                   // all-valid stream (raw 257, stuffed 258, LUT 304)
constexpr int THREADS = 512;       // maps and emit
constexpr int JOIN_THREADS = WIN;  // one a map entry
constexpr int JOIN_BATCH = 32;     // chunks a join CTA composes
constexpr int SB_BYTES = CHUNK + HALO;
constexpr int J_BYTES = (2 * (CHUNK + 1) + 15) / 16 * 16;
constexpr int MAPS_SMEM = 4 * CHUNK + SB_BYTES;
constexpr int EMIT_SMEM = SB_BYTES + 2 * J_BYTES + 2 * CHUNK;
constexpr int JOIN_SMEM = 4 * JOIN_BATCH * WIN + 8 * WIN;

using lerc2::byte_clamped;

// offset dtype of a record: an integer diff record reduces as INT
__device__ __forceinline__ int off_dtype(uint32_t flag, int dt, int diff_v5) {
    return (diff_v5 && dt < lerc2::DT_FLOAT && (flag & 4u)) ? lerc2::DT_INT : dt;
}

// stream bytes through byte_clamped, and a chunk's bytes in shared memory
// (filled through byte_clamped, so both read the same values)
struct StreamBytes {
    const uint8_t* u;
    long long s;
    __device__ uint32_t operator()(long long q) const { return byte_clamped(u, q, s); }
};

struct ChunkBytes {
    const uint8_t* sb;
    long long c0;
    __device__ uint32_t operator()(long long q) const { return sb[q - c0]; }
};

// the header fields of a record starting at p (device_scan.py:50-100),
// read the same way at every byte (speculatively) and at the record starts
struct RecordHead {
    uint32_t flag, ne;            // ne: the stuffed count as stored
    int code, b67, odt, off_w, cw, nb, n_lut, nbits_lut;
    bool is_lut;
    long long nbb_pos;            // the numBits byte
};

template <class Bytes>
__device__ __forceinline__ RecordHead read_head(const Bytes& byte, long long p, int dt,
                                                int diff_v5) {
    RecordHead h;
    h.flag = byte(p);
    h.code = h.flag & 3;
    h.b67 = h.flag >> 6;
    h.odt = off_dtype(h.flag, dt, diff_v5);
    h.off_w = lerc2::offset_width(h.odt, h.b67);
    h.nbb_pos = p + 1 + h.off_w;
    const uint32_t nbb = byte(h.nbb_pos);
    const int cw_code = nbb >> 6;
    h.cw = cw_code == 0 ? 4 : 3 - cw_code;
    h.is_lut = nbb & 32u;
    h.nb = nbb & 31;
    h.ne = 0;
    for (int i = 0; i < 4; ++i)
        if (i < h.cw) h.ne |= byte(h.nbb_pos + 1 + i) << (8 * i);
    h.n_lut = (int)byte(h.nbb_pos + 1 + h.cw) - 1;
    h.nbits_lut = 0;
    for (int i = 0; i < 8; ++i) h.nbits_lut += (h.n_lut >> i) > 0;
    return h;
}

// the record's size, clamped to [1, S]
__device__ __forceinline__ int record_size(const RecordHead& h, long long s, int raw_len) {
    const int ne = min(max((int)h.ne, 0), 64 * 64);
    const int head = 1 + h.off_w + 1 + h.cw;
    const int size = h.code == 2 ? 1
                   : h.code == 3 ? 1 + h.off_w
                   : h.code == 0 ? raw_len
                   : h.is_lut ? head + 1 + ((h.n_lut * h.nb + 7) >> 3)
                                + ((ne * h.nbits_lut + 7) >> 3)
                              : head + ((ne * h.nb + 7) >> 3);
    return (int)min(max((long long)size, 1LL), s);
}

// J[p] = min(p + size(p), S) through read_head (the join's walk)
__device__ __forceinline__ long long next_start(const StreamBytes& byte, long long p, int dt,
                                                int diff_v5, int raw_len) {
    return min(p + record_size(read_head(byte, p, dt, diff_v5), byte.s, raw_len), byte.s);
}

// The size of a record at every byte of a chunk in shared memory: the
// arithmetic of read_head + record_size in 32-bit chunk positions, the
// offset width a nibble of a per-dtype table (ow: the image dtype's by
// bits 6-7, ow_int: DataType INT's, for integer diff records)
struct SizeTable {
    unsigned ow, ow_int;
    int diff_int, raw_len;
};

__device__ __forceinline__ SizeTable size_table(int dt, int diff_v5, int raw_len) {
    SizeTable t{0u, 0u, diff_v5 && dt < lerc2::DT_FLOAT, raw_len};
    for (int b = 0; b < 4; ++b) {
        t.ow |= (unsigned)lerc2::offset_width(dt, b) << (4 * b);
        t.ow_int |= (unsigned)lerc2::offset_width(lerc2::DT_INT, b) << (4 * b);
    }
    return t;
}

__device__ __forceinline__ int chunk_size(const uint8_t* sb, int i, const SizeTable& t) {
    const unsigned flag = sb[i];
    const unsigned code = flag & 3u;
    const unsigned ow = t.diff_int && (flag & 4u) ? t.ow_int : t.ow;
    const int off_w = (int)(ow >> (4 * (flag >> 6))) & 15;
    if (code == 2) return 1;
    if (code == 3) return 1 + off_w;
    if (code == 0) return t.raw_len;
    const int q = i + 1 + off_w;
    const unsigned nbb = sb[q];
    const int cw = nbb >> 6 ? 3 - (int)(nbb >> 6) : 4;
    const unsigned ne4 = sb[q + 1] | sb[q + 2] << 8 | sb[q + 3] << 16 | (unsigned)sb[q + 4] << 24;
    const int ne = min(max((int)(cw == 4 ? ne4 : ne4 & ((1u << (8 * cw)) - 1u)), 0), 64 * 64);
    const int nb = nbb & 31;
    const int head = 2 + off_w + cw;
    if (!(nbb & 32u)) return head + ((ne * nb + 7) >> 3);
    const int n_lut = (int)sb[q + 1 + cw] - 1;
    const int nbits_lut = n_lut > 0 ? 32 - __clz(n_lut) : 0;
    return max(head + 1 + ((n_lut * nb + 7) >> 3) + ((ne * nbits_lut + 7) >> 3), 1);
}

struct ScanArgs {
    const uint8_t* u;
    long long s;
    int dt, diff_v5, raw_len;
    const int* total;
    long long n_rec;
    int* rp;
    int* out;       // [8, n_rec]: mode, offset bits, num_bits, num_elements,
                    // payload_pos, lut_pos, n_lut, nbits_lut
    int* chain_ok;
};

// record r starts at p: its start, descriptors and, for the last record,
// chain_ok (describe at device_scan.py:116-181)
template <class Bytes>
__device__ void write_record(const ScanArgs& a, const Bytes& byte, long long p, long long r) {
    const RecordHead h = read_head(byte, p, a.dt, a.diff_v5);
    const int lp = (int)h.nbb_pos + 1 + h.cw + 1;
    uint32_t acc = 0;
    for (int i = 0; i < 4; ++i)
        if (i < h.off_w) acc |= byte(p + 1 + i) << (8 * i);
    const long long n = a.n_rec;
    int* o = a.out + r;
    a.rp[r] = (int)p;
    o[0] = (h.code == 1 ? (h.is_lut ? 4 : 1) : h.code) + (a.diff_v5 && (h.flag & 4u) ? 8 : 0);
    o[n] = a.dt == lerc2::DT_FLOAT ? __float_as_int(lerc2::float_offset(acc, h.b67))
                                   : lerc2::int_offset(acc, h.off_w, h.odt, h.b67);
    o[2 * n] = h.nb;
    o[3 * n] = (int)h.ne;
    o[4 * n] = h.code == 0 ? (int)p + 1
             : h.is_lut ? lp + ((h.n_lut * h.nb + 7) >> 3) : (int)h.nbb_pos + 1 + h.cw;
    o[5 * n] = lp;
    o[6 * n] = h.n_lut;
    o[7 * n] = h.nbits_lut;
    if (r == n - 1) {
        const long long tot = *a.total;
        *a.chain_ok = p < tot && p + record_size(h, a.s, a.raw_len) == tot;
    }
}

// chunks whose first byte lies before min(max(total, 0), S) are solved
__device__ __forceinline__ long long solved_end(const int* total, long long s) {
    return min(max((long long)*total, 0LL), s);
}

// dst[i] = src[i] for i < n, by threads t0, t0 + nt, ...: N loads in
// flight a thread before the first store
template <int N>
__device__ __forceinline__ void copy16(uint4* dst, const uint4* __restrict__ src, int n, int t0,
                                       int nt) {
    for (int b = t0; b < n; b += N * nt) {
        uint4 v[N];
#pragma unroll
        for (int i = 0; i < N; ++i)
            if (b + i * nt < n) v[i] = src[b + i * nt];
#pragma unroll
        for (int i = 0; i < N; ++i)
            if (b + i * nt < n) dst[b + i * nt] = v[i];
    }
}

// sb[i] = the stream byte at c0 + i (clamped), i < CHUNK + HALO: aligned
// 16-byte loads where the granule lies inside the stream
__device__ void load_chunk(const uint8_t* u, long long s, long long c0, uint8_t* sb) {
    const bool vec = (reinterpret_cast<uintptr_t>(u) & 15) == 0;
    if (vec && c0 + SB_BYTES <= s) {
        copy16<4>(reinterpret_cast<uint4*>(sb), reinterpret_cast<const uint4*>(u + c0),
                  SB_BYTES / 16, threadIdx.x, blockDim.x);
        return;
    }
    for (int g = threadIdx.x; g < SB_BYTES / 16; g += blockDim.x) {
        const long long q = c0 + 16 * g;
        if (vec && q + 16 <= s) {
            *reinterpret_cast<uint4*>(sb + 16 * g) = *reinterpret_cast<const uint4*>(u + q);
        } else {
            for (int i = 0; i < 16; ++i) sb[16 * g + i] = (uint8_t)byte_clamped(u, q + i, s);
        }
    }
}

// maps[k * WIN + j] = (records << 16) | (exit - c0) of the chain from byte
// c0 + j of chunk k until its first start at or past the chunk's end;
// jl[c0 + i] = min(J[c0 + i] - c0, len), the chunk's J for the emit kernel;
// every chunk's plan entry -1 and the join's n_lb look-back words 0
__global__ void __launch_bounds__(THREADS) scan_records_maps_kernel(
        ScanArgs a, unsigned* __restrict__ maps, uint16_t* __restrict__ jl,
        int* __restrict__ plan, unsigned long long* __restrict__ lb, int n_lb) {
    extern __shared__ __align__(16) uint8_t smem[];
    unsigned* node = reinterpret_cast<unsigned*>(smem);   // [CHUNK]: (records, local start)
    uint8_t* sb = smem + 4 * CHUNK;
    const long long c0 = (long long)blockIdx.x * CHUNK;
    for (int i = blockIdx.x * THREADS + threadIdx.x; i < n_lb; i += gridDim.x * THREADS) lb[i] = 0;
    if (threadIdx.x == 0) plan[blockIdx.x] = -1;
    if (c0 >= solved_end(a.total, a.s)) return;
    const int len = (int)min((long long)CHUNK, a.s - c0);
    load_chunk(a.u, a.s, c0, sb);
    __syncthreads();
    const SizeTable tab = size_table(a.dt, a.diff_v5, a.raw_len);
    const int rem = (int)min(a.s - c0, 65535LL);  // J <= S; a record is < 16 KB
    for (int i = threadIdx.x; i < len; i += THREADS) {
        const int j = min(i + chunk_size(sb, i, tab), rem);
        node[i] = 1u << 16 | (unsigned)j;
        jl[c0 + i] = (uint16_t)min(j, len);
    }
    __syncthreads();
    // pointer jumping in place: a pair read while its owner updates it is
    // its old or its new value, both true (one 32-bit word), so the rounds
    // need no second buffer; counts stay <= CHUNK, local starts < 2 CHUNK.
    // The positions go from the chunk's end back, so a pair mostly reads
    // pairs this round has already advanced, and few rounds are needed
    for (;;) {
        int live = 0;
        for (int i = len - 1 - threadIdx.x; i >= 0; i -= THREADS) {
            const unsigned x = node[i];
            const unsigned q = x & 0xFFFFu;
            if (q < (unsigned)len) {
                const unsigned y = node[q];
                const unsigned z = ((x >> 16) + (y >> 16)) << 16 | (y & 0xFFFFu);
                node[i] = z;
                live |= (z & 0xFFFFu) < (unsigned)len;
            }
        }
        if (!__syncthreads_or(live)) break;
    }
    unsigned* m = maps + (long long)blockIdx.x * WIN;
    for (int i = threadIdx.x; i < min(len, WIN); i += THREADS) m[i] = node[i];
}

// a batch's look-back word: state << 62 | e << 31 | r (e, r < 2^31)
constexpr unsigned long long LB_READY = 1, LB_DONE = 2, LB_ALONE = 3;  // 0: not yet

__device__ __forceinline__ unsigned long long lb_word(unsigned long long state, int e, int r) {
    return state << 62 | (unsigned long long)e << 31 | (unsigned)r;
}

// thread 0: the chain from start e, record r to its end, record by record
// where it leaves the maps and chunk by chunk through the maps in device
// memory where it lands in one; returns r at the end and sets e
__device__ int walk_rest(const ScanArgs& a, const unsigned* __restrict__ maps, int n_solved,
                         int n_chunks, int* __restrict__ plan, int& e, int r) {
    const StreamBytes gbyte{a.u, a.s};
    const int n_rec = (int)a.n_rec, s = (int)a.s;
    while (r < n_rec && e < s) {
        const int k = (unsigned)e / CHUNK, j = (unsigned)e % CHUNK;
        if (k < n_solved && j < WIN) {
            const unsigned x = maps[(long long)k * WIN + j];
            const int n = min((int)(x >> 16), n_rec - r);
            plan[k] = e;
            plan[n_chunks + k] = r;
            plan[2 * n_chunks + k] = n;
            r += n;
            e = k * CHUNK + (int)(x & 0xFFFFu);
        } else {
            write_record(a, gbyte, e, r++);
            e = (int)next_start(gbyte, e, a.dt, a.diff_v5, a.raw_len);
        }
    }
    return r;
}

// plan[k], plan[n_chunks + k], plan[2 n_chunks + k]: the entry, first record
// and record count of each chunk the chain enters through its map (the
// maps kernel set every entry to -1); the records of walked entries and past
// the chain's end written here. One CTA a batch of JOIN_BATCH chunks, in the
// order of a ticket: each thread composes the batch's maps from one entry of
// its first chunk (the batch's exit and records), then thread 0 waits for
// the batch before to publish where the chain enters, publishes where it
// leaves (one lookup), and writes the batch's chunks. An entry the batch's
// maps cannot follow (a corrupt or foreign record, the chain past `total`)
// makes its CTA walk the rest of the chain alone (walk_rest) and every later
// CTA stop.
__global__ void __launch_bounds__(JOIN_THREADS) scan_records_join_kernel(
        ScanArgs a, const unsigned* __restrict__ maps, int n_chunks, int* __restrict__ plan,
        unsigned long long* lb) {
    extern __shared__ __align__(16) unsigned bm[];       // [JOIN_BATCH][WIN] the batch's maps
    int* bexit = reinterpret_cast<int*>(bm + JOIN_BATCH * WIN);   // [WIN]
    int* bcnt = bexit + WIN;   // [WIN]; -1: the maps leave off inside the batch
    __shared__ int sh_g, sh_e, sh_r;
    __shared__ unsigned long long sh_in;
    const int tid = threadIdx.x;
    const int n_batches = (n_chunks + JOIN_BATCH - 1) / JOIN_BATCH;
    if (tid == 0) sh_g = (int)atomicAdd(lb + n_batches, 1ULL);  // the ticket
    __syncthreads();
    const int g = sh_g, b0 = g * JOIN_BATCH;
    const int n_solved = (int)((solved_end(a.total, a.s) + CHUNK - 1) / CHUNK);
    const int n_rec = (int)a.n_rec, s = (int)a.s;
    if (g > 0 && b0 >= n_solved) return;  // the chain gets here only walked alone
    const int nb = min(JOIN_BATCH, n_solved - b0);
    if (nb > 0) {
        copy16<8>(reinterpret_cast<uint4*>(bm),
                  reinterpret_cast<const uint4*>(maps + (long long)b0 * WIN), nb * WIN / 4, tid,
                  JOIN_THREADS);
        __syncthreads();
        int e = b0 * CHUNK + tid, k = b0, j = tid, cnt = 0;
        bool ok = e < s;
        while (ok) {
            const unsigned x = bm[(k - b0) * WIN + j];
            cnt += x >> 16;
            e = k * CHUNK + (int)(x & 0xFFFFu);
            k = (unsigned)e / CHUNK;
            j = (unsigned)e % CHUNK;
            if (e >= s || k >= b0 + nb) break;
            ok = j < WIN;
        }
        bexit[tid] = e;
        bcnt[tid] = ok ? cnt : -1;
    }
    if (tid == 0) {
        unsigned long long in = lb_word(LB_READY, 0, 0);
        if (g > 0) {
            const volatile unsigned long long* q = lb + g - 1;
            do in = *q; while (in == 0);
        }
        sh_in = in;
    }
    __syncthreads();
    const unsigned long long in = sh_in;
    if (in >> 62 != LB_READY) {  // the chain ended, or a CTA before walks it alone
        if (tid == 0) atomicExch(lb + g, lb_word(LB_DONE, 0, 0));
        return;
    }
    if (tid == 0) {
        int e = (int)(in >> 31 & 0x7FFFFFFFu), r = (int)(in & 0x7FFFFFFFu);
        const int j_in = e - b0 * CHUNK;
        bool alone = !(nb > 0 && j_in < WIN && bcnt[j_in] >= 0);
        if (alone) {
            atomicExch(lb + g, lb_word(LB_ALONE, 0, 0));
        } else {
            const int e_out = bexit[j_in];
            const long long r_out = (long long)r + bcnt[j_in];
            const bool ends = r_out >= n_rec || e_out >= s;
            alone = !ends && ((unsigned)e_out / CHUNK >= (unsigned)n_solved ||
                              (unsigned)e_out % CHUNK >= (unsigned)WIN);
            atomicExch(lb + g, ends    ? lb_word(LB_DONE, 0, 0)
                               : alone ? lb_word(LB_ALONE, 0, 0)
                                       : lb_word(LB_READY, e_out, (int)r_out));
            while (r < n_rec && e < s && (int)((unsigned)e / CHUNK) < b0 + nb) {
                const int k = (unsigned)e / CHUNK, j = (unsigned)e % CHUNK;
                const unsigned x = bm[(k - b0) * WIN + j];
                const int n = min((int)(x >> 16), n_rec - r);
                plan[k] = e;
                plan[n_chunks + k] = r;
                plan[2 * n_chunks + k] = n;
                r += n;
                e = k * CHUNK + (int)(x & 0xFFFFu);
            }
        }
        if (alone) r = walk_rest(a, maps, n_solved, n_chunks, plan, e, r);
        sh_e = e;
        sh_r = r;
    }
    __syncthreads();
    if (sh_e >= s) {  // the chain reached S before n_rec records: the rest start at S
        const StreamBytes gbyte{a.u, a.s};
        for (int r = sh_r + tid; r < n_rec; r += JOIN_THREADS) write_record(a, gbyte, a.s, r);
    }
}

// the records of each chunk the join entered: starts by rank doubling over
// the chunk's J (saturated at the chunk's end), then the descriptors
__global__ void __launch_bounds__(THREADS) scan_records_emit_kernel(
        ScanArgs a, const uint16_t* __restrict__ jl, const int* __restrict__ plan, int n_chunks) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int k = blockIdx.x;
    const int entry = plan[k];
    if (entry < 0) return;
    const long long r0 = plan[n_chunks + k];
    const int n = plan[2 * n_chunks + k];
    uint8_t* sb = smem;
    uint16_t* cur = reinterpret_cast<uint16_t*>(smem + SB_BYTES);
    uint16_t* nxt = reinterpret_cast<uint16_t*>(smem + SB_BYTES + J_BYTES);
    uint16_t* starts = reinterpret_cast<uint16_t*>(smem + SB_BYTES + 2 * J_BYTES);
    const long long c0 = (long long)k * CHUNK;
    const int len = (int)min((long long)CHUNK, a.s - c0);
    const ChunkBytes byte{sb, c0};
    load_chunk(a.u, a.s, c0, sb);
    copy16<4>(reinterpret_cast<uint4*>(cur), reinterpret_cast<const uint4*>(jl + c0), len / 8,
              threadIdx.x, THREADS);  // c0 is 16 KB aligned
    for (int i = len / 8 * 8 + threadIdx.x; i < len; i += THREADS) cur[i] = jl[c0 + i];
    if (threadIdx.x == 0) {
        cur[len] = nxt[len] = (uint16_t)len;
        starts[0] = (uint16_t)(entry - c0);
    }
    __syncthreads();
    // step: starts[filled + t] = J^filled(starts[t]), then J^filled squared
    for (int filled = 1; filled < n;) {
        const int take = min(filled, n - filled);
        for (int t = threadIdx.x; t < take; t += THREADS) starts[filled + t] = cur[starts[t]];
        if (filled + take < n) {
            for (int i = threadIdx.x; i <= len; i += THREADS) nxt[i] = cur[cur[i]];
            uint16_t* t = cur;
            cur = nxt;
            nxt = t;
        }
        __syncthreads();
        filled += take;
    }
    for (int t = threadIdx.x; t < n; t += THREADS) write_record(a, byte, c0 + starts[t], r0 + t);
}

unsigned n_chunks_of(long long s) { return (unsigned)((s + CHUNK - 1) / CHUNK); }

int n_lb_of(long long s) { return (int)((n_chunks_of(s) + JOIN_BATCH - 1) / JOIN_BATCH) + 1; }

bool bad_stream(long long s, long long n_rec) {
    return s <= 0 || s > INT_MAX || n_rec <= 0 || n_rec > INT_MAX;
}

}  // namespace

// The scratch one scan of an s-byte stream needs, in elements: sizes[0]
// u32 map words (WIN a chunk), sizes[1] u16 chunk-local J (CHUNK a chunk),
// sizes[2] int32 plan words (3 a chunk), sizes[3] u64 look-back words (one a
// batch of JOIN_BATCH chunks, and the join's ticket). The chunking is this
// source's alone; callers size their buffers by this query.
extern "C" int scan_records_scratch(long long s, long long* sizes) {
    if (bad_stream(s, 1)) return (int)cudaErrorInvalidValue;
    const long long n_chunks = n_chunks_of(s);
    sizes[0] = n_chunks * WIN;
    sizes[1] = n_chunks * CHUNK;
    sizes[2] = 3 * n_chunks;
    sizes[3] = n_lb_of(s);
    return 0;
}

// The three launches of one scan, in order on one stream. u: [s] stream
// bytes (0 < s < 2^31); total: 1 int32 on the device; rp: [n_rec] int32; out: [8,
// n_rec] int32; chain_ok: 1 int32; maps, jl, plan and lb as
// scan_records_scratch gives them, maps and jl 16-byte aligned.
extern "C" int scan_records_maps(const uint8_t* u, long long s, int dt, int diff_v5,
                                 int raw_len, const int* total, unsigned* maps, uint16_t* jl,
                                 int* plan, unsigned long long* lb, void* stream) {
    if (bad_stream(s, 1)) return (int)cudaErrorInvalidValue;
    cudaFuncSetAttribute(scan_records_maps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         MAPS_SMEM);
    cudaFuncSetAttribute(scan_records_maps_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    const ScanArgs a{u, s, dt, diff_v5, raw_len, total, 0, nullptr, nullptr, nullptr};
    scan_records_maps_kernel<<<n_chunks_of(s), THREADS, MAPS_SMEM, (cudaStream_t)stream>>>(
        a, maps, jl, plan, lb, n_lb_of(s));
    return (int)cudaGetLastError();
}

extern "C" int scan_records_join(const uint8_t* u, long long s, int dt, int diff_v5,
                                 int raw_len, const int* total, long long n_rec,
                                 const unsigned* maps, int* plan, unsigned long long* lb,
                                 int* rp, int* out, int* chain_ok, void* stream) {
    if (bad_stream(s, n_rec)) return (int)cudaErrorInvalidValue;
    cudaFuncSetAttribute(scan_records_join_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         JOIN_SMEM);
    cudaFuncSetAttribute(scan_records_join_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    const ScanArgs a{u, s, dt, diff_v5, raw_len, total, n_rec, rp, out, chain_ok};
    const unsigned n_chunks = n_chunks_of(s);
    scan_records_join_kernel<<<(n_chunks + JOIN_BATCH - 1) / JOIN_BATCH, JOIN_THREADS, JOIN_SMEM,
                               (cudaStream_t)stream>>>(a, maps, (int)n_chunks, plan, lb);
    return (int)cudaGetLastError();
}

extern "C" int scan_records_emit(const uint8_t* u, long long s, int dt, int diff_v5,
                                 int raw_len, const int* total, long long n_rec,
                                 const uint16_t* jl, const int* plan, int* rp, int* out,
                                 int* chain_ok, void* stream) {
    if (bad_stream(s, n_rec)) return (int)cudaErrorInvalidValue;
    cudaFuncSetAttribute(scan_records_emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         EMIT_SMEM);
    cudaFuncSetAttribute(scan_records_emit_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    const ScanArgs a{u, s, dt, diff_v5, raw_len, total, n_rec, rp, out, chain_ok};
    scan_records_emit_kernel<<<n_chunks_of(s), THREADS, EMIT_SMEM, (cudaStream_t)stream>>>(
        a, jl, plan, (int)n_chunks_of(s));
    return (int)cudaGetLastError();
}
