// CPU stand-in of the CUDA runtime (tools/cuda_standin/standin.py): one
// std::thread per CUDA thread, STANDIN_SLOTS CTAs at once, each
// __shared__ declaration rewritten into a per-CTA box filled with 0xA5.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <tuple>
#include <type_traits>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3_ { unsigned x, y, z; };
#define __constant__
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorMisalignedAddress = 716 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {  // one SM
    *v = 1;
    return cudaSuccess;
}
template <class K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
    *n = 1;  // one CTA: a persistent grid then walks every tile
    return cudaSuccess;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t = nullptr) {
    std::memset(p, v, n);
    return cudaSuccess;
}

struct alignas(8) int2 { int x, y; };
struct alignas(16) int4 { int x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline int2 make_int2(int a, int b) { return {a, b}; }
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }

constexpr int STANDIN_SLOTS = 4;
inline thread_local uint3_ threadIdx, blockIdx;
inline thread_local dim3 blockDim, gridDim;
inline thread_local int standin_slot = 0;

struct StandinWarp {
    std::barrier<>* bar = nullptr;
    uint64_t v[32];
};
inline std::barrier<>* standin_cta[STANDIN_SLOTS];
inline StandinWarp standin_warps[STANDIN_SLOTS][32];

inline int standin_lane() { return (int)(threadIdx.x & 31); }
inline StandinWarp& standin_w() { return standin_warps[standin_slot][threadIdx.x >> 5]; }

inline void __syncthreads() { standin_cta[standin_slot]->arrive_and_wait(); }
inline std::atomic<int> standin_votes[STANDIN_SLOTS];
inline int __syncthreads_count(int pred) {  // the barrier before reading lets the reset wait
    __syncthreads();
    if (threadIdx.x == 0 && threadIdx.y == 0 && threadIdx.z == 0) standin_votes[standin_slot] = 0;
    __syncthreads();
    if (pred) standin_votes[standin_slot].fetch_add(1);
    __syncthreads();
    return standin_votes[standin_slot].load();
}
inline int __syncthreads_or(int pred) { return __syncthreads_count(pred) != 0; }
inline int __syncthreads_and(int pred) {
    return __syncthreads_count(!pred) == 0;
}
inline void __syncwarp(unsigned = 0xffffffffu) { standin_w().bar->arrive_and_wait(); }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }

// warp exchange: every lane posts v, then reads lane `src(lane)`
template <class T, class F>
inline T standin_xchg(T v, F src) {
    StandinWarp& w = standin_w();
    const int l = standin_lane();
    uint64_t bits = 0;
    std::memcpy(&bits, &v, sizeof(T));
    w.v[l] = bits;
    w.bar->arrive_and_wait();
    const int s = src(l);
    T r = v;
    if (s >= 0) std::memcpy(&r, &w.v[s], sizeof(T));
    w.bar->arrive_and_wait();
    return r;
}
template <class T> inline T __shfl_sync(unsigned, T v, int src, int width = 32) {
    return standin_xchg(v, [&](int l) { return (l & ~(width - 1)) + (src & (width - 1)); });
}
template <class T> inline T __shfl_up_sync(unsigned, T v, unsigned delta, int width = 32) {
    return standin_xchg(v, [&](int l) {
        return (l & (width - 1)) >= (int)delta ? l - (int)delta : -1; });
}
template <class T> inline T __shfl_down_sync(unsigned, T v, unsigned delta, int width = 32) {
    return standin_xchg(v, [&](int l) {
        return (l & (width - 1)) + (int)delta < width ? l + (int)delta : -1; });
}
template <class T> inline T __shfl_xor_sync(unsigned, T v, int m, int width = 32) {
    return standin_xchg(v, [&](int l) { return l ^ m; });
}
// all 32 lanes' values of v
template <class T> inline void standin_gather(T v, T* out) {
    StandinWarp& w = standin_w();
    const int l = standin_lane();
    uint64_t bits = 0;
    std::memcpy(&bits, &v, sizeof(T));
    w.v[l] = bits;
    w.bar->arrive_and_wait();
    for (int i = 0; i < 32; ++i) std::memcpy(&out[i], &w.v[i], sizeof(T));
    w.bar->arrive_and_wait();
}
inline unsigned __ballot_sync(unsigned, int pred) {
    int p[32];
    standin_gather(pred ? 1 : 0, p);
    unsigned m = 0;
    for (int i = 0; i < 32; ++i) m |= (unsigned)(p[i] != 0) << i;
    return m;
}
inline int __any_sync(unsigned m, int pred) { return __ballot_sync(m, pred) != 0; }
inline int __all_sync(unsigned m, int pred) { return __ballot_sync(m, pred) == 0xffffffffu; }
#define STANDIN_REDUCE(NAME, T, OP)                                   \
    inline T NAME(unsigned, T v) {                                    \
        T p[32];                                                      \
        standin_gather(v, p);                                         \
        T r = p[0];                                                   \
        for (int i = 1; i < 32; ++i) r = OP;                          \
        return r;                                                     \
    }
STANDIN_REDUCE(__reduce_min_sync, int, std::min(r, p[i]))
STANDIN_REDUCE(__reduce_min_sync, unsigned, std::min(r, p[i]))
STANDIN_REDUCE(__reduce_max_sync, int, std::max(r, p[i]))
STANDIN_REDUCE(__reduce_max_sync, unsigned, std::max(r, p[i]))
STANDIN_REDUCE(__reduce_add_sync, int, r + p[i])
STANDIN_REDUCE(__reduce_add_sync, unsigned, r + p[i])
STANDIN_REDUCE(__reduce_or_sync, unsigned, r | p[i])

// atomics
template <class T> inline T atomicOr(T* a, T v) { return __atomic_fetch_or(a, v, __ATOMIC_SEQ_CST); }
template <class T> inline T atomicAnd(T* a, T v) { return __atomic_fetch_and(a, v, __ATOMIC_SEQ_CST); }
template <class T> inline T atomicAdd(T* a, T v) { return __atomic_fetch_add(a, v, __ATOMIC_SEQ_CST); }
inline float atomicAdd(float* a, float v) {
    float old = *a, nv;
    do { nv = old + v; } while (!__atomic_compare_exchange(a, &old, &nv, false, __ATOMIC_SEQ_CST,
                                                           __ATOMIC_SEQ_CST));
    return old;
}
template <class T> inline T atomicExch(T* a, T v) { return __atomic_exchange_n(a, v, __ATOMIC_SEQ_CST); }
template <class T> inline T atomicCAS(T* a, T c, T v) {
    __atomic_compare_exchange_n(a, &c, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST);
    return c;
}
template <class T> inline T atomicMin(T* a, T v) {
    T old = __atomic_load_n(a, __ATOMIC_SEQ_CST);
    while (v < old && !__atomic_compare_exchange_n(a, &old, v, false, __ATOMIC_SEQ_CST,
                                                   __ATOMIC_SEQ_CST)) {}
    return old;
}
template <class T> inline T atomicMax(T* a, T v) {
    T old = __atomic_load_n(a, __ATOMIC_SEQ_CST);
    while (v > old && !__atomic_compare_exchange_n(a, &old, v, false, __ATOMIC_SEQ_CST,
                                                   __ATOMIC_SEQ_CST)) {}
    return old;
}

// integer and bit intrinsics
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcg(const T* p) { return __atomic_load_n(p, __ATOMIC_SEQ_CST); }
inline int4 __ldcg(const int4* p) {  // a 16-byte load another CTA may have just stored
    std::atomic_thread_fence(std::memory_order_seq_cst);
    return *p;
}
inline unsigned __vcmpne4(unsigned a, unsigned b) {  // 0xFF in each byte where a's and b's differ
    unsigned r = 0;
    for (int i = 0; i < 4; ++i) r |= ((a >> (8 * i)) & 0xFFu) != ((b >> (8 * i)) & 0xFFu) ? 0xFFu << (8 * i) : 0u;
    return r;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline int __clzll(long long x) { return x ? __builtin_clzll((unsigned long long)x) : 64; }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
inline unsigned __brev(unsigned x) {
    unsigned r = 0;
    for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
    return r;
}
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned sh) {
    return (unsigned)((((uint64_t)hi << 32) | lo) >> (sh & 31));
}
inline unsigned __funnelshift_l(unsigned lo, unsigned hi, unsigned sh) {
    return (unsigned)(((((uint64_t)hi << 32) | lo) << (sh & 31)) >> 32);
}
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
    const uint64_t v = ((uint64_t)y << 32) | x;
    unsigned r = 0;
    for (int i = 0; i < 4; ++i) r |= (unsigned)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
    return r;
}

// float intrinsics (built with -ffp-contract=off: each operation rounds)
template <class A, class B> inline A standin_bits(B b) { A a; std::memcpy(&a, &b, sizeof(A)); return a; }
inline int __float_as_int(float f) { return standin_bits<int>(f); }
inline unsigned __float_as_uint(float f) { return standin_bits<unsigned>(f); }
inline float __int_as_float(int i) { return standin_bits<float>(i); }
inline float __uint_as_float(unsigned i) { return standin_bits<float>(i); }
inline long long __double_as_longlong(double d) { return standin_bits<long long>(d); }
inline double __longlong_as_double(long long i) { return standin_bits<double>(i); }
inline double __hiloint2double(int hi, int lo) {
    return standin_bits<double>(((uint64_t)(uint32_t)hi << 32) | (uint32_t)lo);
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }
inline float __double2float_rn(double d) { return (float)d; }
inline float __int2float_rn(int i) { return (float)i; }
inline float __uint2float_rn(unsigned i) { return (float)i; }
inline double __int2double_rn(int i) { return (double)i; }
inline int __float2int_rn(float f) {
    if (std::isnan(f)) return 0;
    if (f >= 2147483648.f) return INT_MAX;
    if (f < -2147483648.f) return INT_MIN;
    return (int)std::nearbyint(f);
}
inline unsigned __float2uint_rn(float f) {
    if (std::isnan(f) || f <= 0.f) return 0;
    if (f >= 4294967296.f) return UINT_MAX;
    return (unsigned)std::nearbyint(f);
}
inline float rintf(float f) { return std::nearbyint(f); }
inline float fmaxf(float a, float b) { return std::fmax(a, b); }
inline float fminf(float a, float b) { return std::fmin(a, b); }
inline float fabsf(float a) { return std::fabs(a); }

template <class A, class B> inline auto min(A a, B b) -> std::common_type_t<A, B> {
    using C = std::common_type_t<A, B>;
    return (C)a < (C)b ? (C)a : (C)b;
}
template <class A, class B> inline auto max(A a, B b) -> std::common_type_t<A, B> {
    using C = std::common_type_t<A, B>;
    return (C)a > (C)b ? (C)a : (C)b;
}

// __shared__ boxes: one per slot, filled with 0xA5 before each batch of CTAs
struct StandinBox { void* p; size_t n; };
inline std::vector<StandinBox>& standin_boxes() { static std::vector<StandinBox> v; return v; }
inline std::mutex standin_mu;
template <class T, int ID> inline T& standin_shared() {
    struct alignas(16) Slot { T v; };
    static Slot* box = [] {
        Slot* b = new Slot[STANDIN_SLOTS];
        std::memset((void*)b, 0xA5, sizeof(Slot) * STANDIN_SLOTS);
        std::lock_guard<std::mutex> g(standin_mu);
        standin_boxes().push_back({(void*)b, sizeof(Slot) * STANDIN_SLOTS});
        return b;
    }();
    return box[standin_slot].v;
}

struct StandinCfg { dim3 g, b; };
inline StandinCfg standin_cfg(dim3 g, dim3 b, size_t = 0, cudaStream_t = nullptr) { return {g, b}; }

template <class... P, class... A>
void standin_launch(StandinCfg c, void (*k)(P...), A... a) {
    std::tuple<std::decay_t<P>...> args(static_cast<std::decay_t<P>>(a)...);
    const long long n_cta = (long long)c.g.x * c.g.y * c.g.z;
    const int nt = (int)(c.b.x * c.b.y * c.b.z);
    for (long long c0 = 0; c0 < n_cta; c0 += STANDIN_SLOTS) {
        const int nb = (int)std::min<long long>(STANDIN_SLOTS, n_cta - c0);
        {
            std::lock_guard<std::mutex> g(standin_mu);
            for (auto& b : standin_boxes()) std::memset(b.p, 0xA5, b.n);
        }
        for (int s = 0; s < nb; ++s) {
            standin_cta[s] = new std::barrier<>(nt);
            for (int wi = 0; wi < (nt + 31) / 32; ++wi)
                standin_warps[s][wi].bar = new std::barrier<>(std::min(32, nt - 32 * wi));
        }
        std::vector<std::thread> ts;
        ts.reserve((size_t)nb * nt);
        for (int s = 0; s < nb; ++s) {
            const long long cta = c0 + s;
            for (int t = 0; t < nt; ++t) {
                ts.emplace_back([&, s, cta, t] {
                    standin_slot = s;
                    threadIdx = {(unsigned)(t % c.b.x), (unsigned)(t / c.b.x % c.b.y),
                                 (unsigned)(t / (c.b.x * c.b.y))};
                    blockIdx = {(unsigned)(cta % c.g.x), (unsigned)(cta / c.g.x % c.g.y),
                                (unsigned)(cta / ((long long)c.g.x * c.g.y))};
                    blockDim = c.b;
                    gridDim = c.g;
                    std::apply(k, args);
                    standin_w().bar->arrive_and_drop();
                    standin_cta[s]->arrive_and_drop();
                });
            }
        }
        for (auto& t : ts) t.join();
        for (int s = 0; s < nb; ++s) {
            delete standin_cta[s];
            for (int wi = 0; wi < (nt + 31) / 32; ++wi) delete standin_warps[s][wi].bar;
        }
    }
}
