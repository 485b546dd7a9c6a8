// K3 fletcher32_parts: the Lerc2 Fletcher32 of pre || STATIC || tail ||
// stream[:total] in closed form, without reading the static middle.
//
// Replaces lerc_tpu/ops/device_scan.py::fletcher32_device_parts (:306) with
// _words_sums (:205), _sum65535 (:191) and _fold65535 (:184). The TPU
// version folds mod 65535 in u32 lanes and funnel-shifts the stream when
// the prefix is odd; here every byte is weighed by itself: a byte at
// message position n belongs to word n >> 1 with weight 256 (n even) or 1,
// so Sum(w) and Sum(i*w) add up per byte in u64 and need no alignment.
// A thread's u64 sums cannot wrap (word index < 2^31, weighted byte < 2^16,
// at most a few thousand bytes a thread), so they fold mod 65535 once.
//
// With A = Sum(w_i), B = Sum(i*w_i) mod 65535 over the whole message of
// M words: s1 = 0xffff + A, s2 = 0xffff*(M+1) + M*A - B (mod 65535), each
// 0 mapped to 65535 (the reference's double-fold representative).
//
// Bound: bytes (`total` B of stream read once). One launch: a grid-stride
// reduction, one u64 atomic per CTA, and the last CTA to finish folds the
// result (no second launch and no host round trip).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned long long MOD = 65535ull;

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ void add_byte(unsigned long long& s1, unsigned long long& s2,
                                         unsigned byte, long long pos) {
    const unsigned long long v = (unsigned long long)byte << ((pos & 1) ? 0 : 8);
    s1 += v;
    s2 += (unsigned long long)(pos >> 1) * v;
}

__global__ void fletcher32_parts_kernel(const uint8_t* __restrict__ pre, int n_pre,
                                        const uint8_t* __restrict__ tail, int n_tail,
                                        long long static_a, long long static_b,
                                        long long n_static,
                                        const uint32_t* __restrict__ stream, long long cap_w,
                                        const int* __restrict__ total_ptr,
                                        unsigned long long* __restrict__ acc,
                                        int* __restrict__ out) {
    __shared__ unsigned long long red1[THREADS / 32], red2[THREADS / 32];
    __shared__ bool last;
    const long long total = *total_ptr;
    const long long p_all = n_pre + n_static + n_tail;
    long long live = total < cap_w * 4 ? total : cap_w * 4;  // bytes past capacity are absent
    if (live < 0) live = 0;
    unsigned long long s1 = 0, s2 = 0;

    const long long n_words = (live + 3) >> 2;
    for (long long t = (long long)blockIdx.x * THREADS + threadIdx.x; t < n_words;
         t += (long long)gridDim.x * THREADS) {
        const uint32_t word = stream[t];
        for (int k = 0; k < 4; ++k) {
            const long long kb = 4 * t + k;
            if (kb < live) add_byte(s1, s2, (word >> (8 * k)) & 0xFFu, p_all + kb);
        }
    }
    if (blockIdx.x == 0) {
        for (int i = threadIdx.x; i < n_pre; i += THREADS) add_byte(s1, s2, pre[i], i);
        for (int i = threadIdx.x; i < n_tail; i += THREADS)
            add_byte(s1, s2, tail[i], n_pre + n_static + i);
    }
    s1 = warp_sum(s1 % MOD);
    s2 = warp_sum(s2 % MOD);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
        red1[warp] = s1;
        red2[warp] = s2;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned long long b1 = 0, b2 = 0;
        for (int k = 0; k < THREADS / 32; ++k) {
            b1 += red1[k];
            b2 += red2[k];
        }
        atomicAdd(&acc[0], b1 % MOD);
        atomicAdd(&acc[1], b2 % MOD);
        __threadfence();
        const unsigned long long ticket = atomicAdd(&acc[2], 1ull);
        last = ticket == gridDim.x - 1;
    }
    __syncthreads();
    if (last && threadIdx.x == 0) {
        __threadfence();
        const unsigned long long a = (atomicAdd(&acc[0], 0ull) + (unsigned long long)static_a) % MOD;
        const unsigned long long b = (atomicAdd(&acc[1], 0ull) + (unsigned long long)static_b) % MOD;
        const unsigned long long m = (unsigned long long)((p_all + total + 1) / 2);
        const unsigned long long wsum = ((m % MOD) * a + MOD - b) % MOD;  // Sum (M - i) w
        unsigned long long r1 = (0xFFFFull + a) % MOD;
        unsigned long long r2 = (0xFFFFull * ((m + 1) % MOD) + wsum) % MOD;
        if (r1 == 0) r1 = MOD;
        if (r2 == 0) r2 = MOD;
        out[0] = (int)(uint32_t)((r2 << 16) | r1);
    }
}

}  // namespace

// acc: 3 zeroed u64 (two partial sums and the CTA ticket)
extern "C" int fletcher32_parts(const uint8_t* pre, int n_pre, const uint8_t* tail, int n_tail,
                                long long static_a, long long static_b, long long n_static,
                                const uint32_t* words, long long cap_w, const int* total,
                                unsigned long long* acc, int* out, void* stream) {
    long long grid = (cap_w + THREADS - 1) / THREADS;
    if (grid > 132 * 8) grid = 132 * 8;
    if (grid < 1) grid = 1;
    fletcher32_parts_kernel<<<(int)grid, THREADS, 0, (cudaStream_t)stream>>>(
        pre, n_pre, tail, n_tail, static_a, static_b, n_static, words, cap_w, total, acc, out);
    return (int)cudaGetLastError();
}
