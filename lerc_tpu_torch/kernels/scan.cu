// K5 scan_records: the record starts of a Lerc2 tile stream without the
// encoder's index, and each record's descriptors.
//
// Replaces lerc_tpu/ops/device_scan.py::scan_records_device (:35-181): a
// speculative record size at every stream byte, the jump table
// J[p] = min(p + size(p), S) with a sentinel J[S] = S, ceil(log2 nRec)
// pointer-doubling steps (step k writes positions [2^k, 2^(k+1)) from
// positions [0, 2^k) through J^(2^k) and squares J), and the descriptors
// at the resolved positions. Three kernels, one thread per byte or record:
//   scan_records_sizes     J over the S + 1 byte positions,
//   scan_records_double    one doubling step (launched ceil(log2 nRec) times),
//   scan_records_describe  mode, offset, numBits, count, payload and LUT
//                          positions, and whether the chain ends at `total`.
// Raw records take the uniform count 64 (all-valid 8x8 streams), as JAX.
//
// Where this differs from JAX, JAX is wrong: at version >= 5 a record with
// flag bit 2 is a depth-diff record, whose offset an integer dtype reduces
// as DataType INT (lerc2_decode.py:241-269), and its mode is reported + 8
// as the native scanner does. JAX takes the image dtype's width there and
// loses the chain after the first such record.
//
// Bound: bytes. The least work reads the stream once and writes 36 B of
// descriptors per record; the doubling steps move 12 B per stream byte
// each (J read twice, J^2 written), so they dominate, as on the TPU.

#include <cstdint>
#include <cuda_runtime.h>

#include "record.cuh"

namespace {

constexpr int THREADS = 256;

using lerc2::byte_clamped;

// offset dtype of a record: an integer diff record reduces as INT
__device__ __forceinline__ int off_dtype(uint32_t flag, int dt, int diff_v5) {
    return (diff_v5 && dt < lerc2::DT_FLOAT && (flag & 4u)) ? lerc2::DT_INT : dt;
}

// the header fields of a record starting at p (device_scan.py:50-100),
// read the same way at every byte (speculatively) and at the record starts
struct RecordHead {
    uint32_t flag, ne;            // ne: the stuffed count as stored
    int code, b67, odt, off_w, cw, nb, n_lut, nbits_lut;
    bool is_lut;
    long long nbb_pos;            // the numBits byte
};

__device__ __forceinline__ RecordHead read_head(const uint8_t* u, long long s, long long p,
                                                int dt, int diff_v5) {
    RecordHead h;
    h.flag = byte_clamped(u, p, s);
    h.code = h.flag & 3;
    h.b67 = h.flag >> 6;
    h.odt = off_dtype(h.flag, dt, diff_v5);
    h.off_w = lerc2::offset_width(h.odt, h.b67);
    h.nbb_pos = p + 1 + h.off_w;
    const uint32_t nbb = byte_clamped(u, h.nbb_pos, s);
    const int cw_code = nbb >> 6;
    h.cw = cw_code == 0 ? 4 : 3 - cw_code;
    h.is_lut = nbb & 32u;
    h.nb = nbb & 31;
    h.ne = 0;
    for (int i = 0; i < 4; ++i)
        if (i < h.cw) h.ne |= byte_clamped(u, h.nbb_pos + 1 + i, s) << (8 * i);
    h.n_lut = (int)byte_clamped(u, h.nbb_pos + 1 + h.cw, s) - 1;
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

__global__ void scan_records_sizes_kernel(const uint8_t* __restrict__ u, long long s, int dt,
                                          int diff_v5, int raw_len, int* __restrict__ jump) {
    const long long p = blockIdx.x * (long long)THREADS + threadIdx.x;
    if (p > s) return;
    jump[p] = p == s ? (int)s
                     : (int)min(p + record_size(read_head(u, s, p, dt, diff_v5), s, raw_len), s);
}

// positions[filled + t] = J[positions[t]] for t < take (disjoint from the
// positions read, as take <= filled); J2 = J[J] when `square`
__global__ void scan_records_double_kernel(const int* __restrict__ jump,
                                           int* __restrict__ jump2, long long n_jump,
                                           int* __restrict__ pos, int filled, int take,
                                           int square) {
    const long long t = blockIdx.x * (long long)THREADS + threadIdx.x;
    if (t < take) pos[filled + t] = jump[pos[t]];
    if (square && t < n_jump) jump2[t] = jump[jump[t]];
}

__global__ void scan_records_describe_kernel(
        const uint8_t* __restrict__ u, long long s, const int* __restrict__ pos, int n_rec,
        int dt, int diff_v5, int raw_len, const int* __restrict__ total, int* __restrict__ mode,
        int* __restrict__ offset, int* __restrict__ num_bits, int* __restrict__ num_elements,
        int* __restrict__ payload_pos, int* __restrict__ lut_pos, int* __restrict__ n_lut,
        int* __restrict__ nbits_lut, int* __restrict__ chain_ok) {
    const int r = blockIdx.x * THREADS + threadIdx.x;
    if (r >= n_rec) return;
    const int rp = pos[r];
    const RecordHead h = read_head(u, s, rp, dt, diff_v5);
    const int lp = (int)h.nbb_pos + 1 + h.cw + 1;
    uint32_t acc = 0;
    for (int i = 0; i < 4; ++i)
        if (i < h.off_w) acc |= byte_clamped(u, rp + 1 + i, s) << (8 * i);
    mode[r] = (h.code == 1 ? (h.is_lut ? 4 : 1) : h.code) + (diff_v5 && (h.flag & 4u) ? 8 : 0);
    offset[r] = dt == lerc2::DT_FLOAT ? __float_as_int(lerc2::float_offset(acc, h.b67))
                                      : lerc2::int_offset(acc, h.off_w, h.odt, h.b67);
    num_bits[r] = h.nb;
    num_elements[r] = (int)h.ne;
    payload_pos[r] = h.code == 0 ? rp + 1
                   : h.is_lut ? lp + ((h.n_lut * h.nb + 7) >> 3) : (int)h.nbb_pos + 1 + h.cw;
    lut_pos[r] = lp;
    n_lut[r] = h.n_lut;
    nbits_lut[r] = h.nbits_lut;
    if (r == n_rec - 1) {
        const int tot = *total;
        *chain_ok = rp < tot && (long long)rp + record_size(h, s, raw_len) == tot;
    }
}

unsigned grid_of(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

// jump: [s + 1] int32
extern "C" int scan_records_sizes(const uint8_t* u, long long s, int dt, int diff_v5,
                                  int raw_len, int* jump, void* stream) {
    scan_records_sizes_kernel<<<grid_of(s + 1), THREADS, 0, (cudaStream_t)stream>>>(
        u, s, dt, diff_v5, raw_len, jump);
    return (int)cudaGetLastError();
}

extern "C" int scan_records_double(const int* jump, int* jump2, long long n_jump, int* pos,
                                   int filled, int take, int square, void* stream) {
    const long long n = square ? (n_jump > take ? n_jump : take) : take;
    scan_records_double_kernel<<<grid_of(n), THREADS, 0, (cudaStream_t)stream>>>(
        jump, jump2, n_jump, pos, filled, take, square);
    return (int)cudaGetLastError();
}

// out: 8 int32 arrays of n_rec (mode, offset bits, num_bits, num_elements,
// payload_pos, lut_pos, n_lut, nbits_lut) as one [8, n_rec] block, and
// chain_ok (1 int32)
extern "C" int scan_records_describe(const uint8_t* u, long long s, const int* pos, int n_rec,
                                     int dt, int diff_v5, int raw_len, const int* total,
                                     int* out, int* chain_ok, void* stream) {
    const long long n = n_rec;
    scan_records_describe_kernel<<<grid_of(n), THREADS, 0, (cudaStream_t)stream>>>(
        u, s, pos, n_rec, dt, diff_v5, raw_len, total, out, out + n, out + 2 * n, out + 3 * n,
        out + 4 * n, out + 5 * n, out + 6 * n, out + 7 * n, chain_ok);
    return (int)cudaGetLastError();
}
