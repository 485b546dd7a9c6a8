// K3 fletcher32_parts: the Lerc2 Fletcher32 of pre || STATIC || tail ||
// stream[:total] in closed form, without reading the static middle.
//
// Replaces lerc_tpu/ops/device_scan.py::fletcher32_device_parts (:306) with
// _words_sums (:205), _sum65535 (:191) and _fold65535 (:184). The TPU
// version folds mod 65535 in u32 lanes and funnel-shifts the stream when
// the prefix is odd; here a byte at message position n belongs to word
// n >> 1 with weight 256 (n even) or 1, so no part needs alignment.
//
// With A = Sum(w_i), B = Sum(i*w_i) mod 65535 over the whole message of
// M words: s1 = 0xffff + A, s2 = 0xffff*(M+1) + M*A - B (mod 65535), each
// 0 mapped to 65535 (the reference's double-fold representative).
//
// Bound: bytes, n_pre + n_tail + min(total, 4 cap_w) read once. The band
// codec hands K3 a whole blob as `tail` (10-26 MB for an fpl section) with
// an empty stream, the resident codecs a short header and a long stream,
// so no part may be left to one CTA. The three parts share one position
// space (pre at 0, tail at n_pre + n_static, the stream at p_all) and every
// thread grid-strides over the 16-byte vectors of each part in turn, read
// from the part's first 16-aligned byte; a part's ragged ends (under 16
// bytes each) go one byte a thread. A part's vectors all start at message
// positions of one parity, so a vector's sums relative to its first word
// are four byte dot products a u32 (__dp4a: the weight-256 bytes, the
// weight-1 bytes, each also weighed by its word offset 0..8), folded once
// into the thread's (A, B) with the vector's base word mod 65535, carried
// from vector to vector by one add: no per-byte multiply. The grid is the
// card's resident CTAs, or fewer for short messages, sized from the bytes
// the host knows (n_pre + n_tail + 4 cap_w; `total` stays on the device).
// One launch: one u64 atomic pair per CTA, and the last CTA to finish
// folds the result (no second launch and no host round trip).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned MOD = 65535u;
constexpr int N_PARTS = 3;

struct Part {
    const uint8_t* p;
    long long n;    // bytes
    long long pos;  // message position of p[0]
};

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

__device__ __forceinline__ void add_byte(unsigned long long& a, unsigned long long& b,
                                         unsigned byte, long long pos) {
    const unsigned v = byte << ((pos & 1) ? 0 : 8);
    a += v;
    b += (unsigned long long)((pos >> 1) % MOD) * v;
}

// The 16 bytes of v at message positions of parity q from word m on
// (m_mod = m % 65535). Byte i of the k-th u32 lies in word m + 2k + ((q + i)
// >> 1), with weight 256 when q + i is even, else 1.
__device__ __forceinline__ void add_vec(unsigned long long& a, unsigned long long& b, uint4 v,
                                        unsigned q, unsigned m_mod) {
    const unsigned wh = q ? 0x01000100u : 0x00010001u;  // the weight-256 bytes
    const unsigned wl = q ? 0x00010001u : 0x01000100u;  // the weight-1 bytes
    const unsigned oh = q ? 0x02000100u : 0x00010000u;  // their word offsets in the first u32
    const unsigned ol = q ? 0x00010000u : 0x01000000u;
    const unsigned x[4] = {v.x, v.y, v.z, v.w};
    unsigned sh = 0, sl = 0, ih = 0, il = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        sh = __dp4a(x[k], wh, sh);
        sl = __dp4a(x[k], wl, sl);
        ih = __dp4a(x[k], oh + 2 * k * wh, ih);
        il = __dp4a(x[k], ol + 2 * k * wl, il);
    }
    const unsigned av = (sh << 8) + sl;  // < 2^21
    a += av;
    b += (unsigned long long)m_mod * av + (ih << 8) + il;
}

__global__ void __launch_bounds__(THREADS) fletcher32_parts_kernel(
        const uint8_t* __restrict__ pre, int n_pre, const uint8_t* __restrict__ tail,
        long long n_tail, long long static_a, long long static_b, long long n_static,
        const uint32_t* __restrict__ stream, long long cap_w, const int* __restrict__ total_ptr,
        unsigned long long* __restrict__ acc, int* __restrict__ out) {
    __shared__ unsigned red[2][THREADS / 32];
    __shared__ bool last;
    const long long total = *total_ptr;
    const long long p_all = n_pre + n_static + n_tail;
    long long live = total < cap_w * 4 ? total : cap_w * 4;  // bytes past capacity are absent
    if (live < 0) live = 0;
    const Part parts[N_PARTS] = {{pre, n_pre, 0},
                                 {tail, n_tail, n_pre + n_static},
                                 {reinterpret_cast<const uint8_t*>(stream), live, p_all}};
    const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
    const long long stride = (long long)gridDim.x * THREADS;
    const unsigned step = (unsigned)((8 * stride) % MOD);  // words between a thread's vectors
    unsigned long long a = 0, b = 0;
#pragma unroll
    for (int k = 0; k < N_PARTS; ++k) {
        const Part pt = parts[k];
        const long long lead = (16 - (long long)(reinterpret_cast<uintptr_t>(pt.p) & 15)) & 15;
        const long long head = pt.n < lead ? pt.n : lead;
        const long long nv = (pt.n - head) >> 4;
        const long long rest = pt.n - head - 16 * nv;
        if (tid < 32) {  // the ragged ends: head bytes by threads 0-15, the rest by 16-31
            const long long i = tid < 16 ? tid : head + 16 * nv + (tid - 16);
            if (tid < 16 ? tid < head : tid - 16 < rest) add_byte(a, b, pt.p[i], pt.pos + i);
        }
        const long long pos0 = pt.pos + head;
        const unsigned q = (unsigned)(pos0 & 1);
        const uint4* vp = reinterpret_cast<const uint4*>(pt.p + head);
        unsigned m_mod = (unsigned)(((pos0 >> 1) + 8 * tid) % MOD);
        auto next = [&] {
            m_mod += step;
            if (m_mod >= MOD) m_mod -= MOD;
        };
        long long t = tid;
        for (; t + stride < nv; t += 2 * stride) {  // two loads in flight a thread
            const uint4 x0 = __ldg(vp + t), x1 = __ldg(vp + t + stride);
            add_vec(a, b, x0, q, m_mod);
            next();
            add_vec(a, b, x1, q, m_mod);
            next();
        }
        if (t < nv) add_vec(a, b, __ldg(vp + t), q, m_mod);
    }
    const unsigned s1 = warp_sum((unsigned)(a % MOD)), s2 = warp_sum((unsigned)(b % MOD));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
        red[0][warp] = s1;
        red[1][warp] = s2;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned long long b1 = 0, b2 = 0;
        for (int w = 0; w < THREADS / 32; ++w) {
            b1 += red[0][w];
            b2 += red[1][w];
        }
        atomicAdd(&acc[0], b1);
        atomicAdd(&acc[1], b2);
        __threadfence();
        const unsigned long long ticket = atomicAdd(&acc[2], 1ull);
        last = ticket == gridDim.x - 1;
    }
    __syncthreads();
    if (last && threadIdx.x == 0) {
        __threadfence();
        const long long M = MOD;
        auto mod = [M](long long x) { return ((x % M) + M) % M; };  // as Python's %
        const long long sa = mod((long long)(atomicAdd(&acc[0], 0ull) % MOD) + mod(static_a));
        const long long sb = mod((long long)(atomicAdd(&acc[1], 0ull) % MOD) + mod(static_b));
        const long long m = (p_all + total + 1) >> 1;  // floor, as the plain version's //
        const long long wsum = (mod(m) * sa + M - sb) % M;  // Sum (M - i) w
        long long r1 = (0xFFFF + sa) % M;
        long long r2 = (0xFFFF * mod(m + 1) + wsum) % M;
        if (r1 == 0) r1 = M;
        if (r2 == 0) r2 = M;
        out[0] = (int)(uint32_t)((r2 << 16) | r1);
    }
}

int resident_ctas() {
    static const int n = [] {
        int dev = 0, sms = 0, per = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, fletcher32_parts_kernel, THREADS, 0);
        return sms * per > 0 ? sms * per : 1;
    }();
    return n;
}

}  // namespace

// acc: 3 zeroed u64 (two partial sums and the CTA ticket); pre, tail: any
// alignment; words: the stream's cap_w u32 words
extern "C" int fletcher32_parts(const uint8_t* pre, int n_pre, const uint8_t* tail,
                                long long n_tail, long long static_a, long long static_b,
                                long long n_static, const uint32_t* words, long long cap_w,
                                const int* total, unsigned long long* acc, int* out,
                                void* stream) {
    const long long vectors = ((long long)n_pre + n_tail + 4 * cap_w) / 16;
    long long grid = (vectors + THREADS - 1) / THREADS;
    const int cap = resident_ctas();
    if (grid > cap) grid = cap;
    if (grid < 1) grid = 1;
    fletcher32_parts_kernel<<<(int)grid, THREADS, 0, (cudaStream_t)stream>>>(
        pre, n_pre, tail, n_tail, static_a, static_b, n_static, words, cap_w, total, acc, out);
    return (int)cudaGetLastError();
}
