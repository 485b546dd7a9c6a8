// Block-wide scans and byte loads shared by the Huffman (H1-H4) and fpl
// (F1-F3) kernels. Scans: warp shuffles within a warp, one entry per warp in
// shared memory across warps. Op is the associative combine of values of type Op::T (Sum over
// u32, or fpl's split-field adds over u32 and u64 words); SegT pairs a value
// with a segment-start flag, and the value restarts wherever a flag is set.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;

struct Sum {
    using T = unsigned;
    __device__ static unsigned f(unsigned a, unsigned b) { return a + b; }
};

// (segment flag, value): B after A = (fa | fb, fb ? vb : op(va, vb))
template <class V>
struct SegT {
    unsigned f;
    V v;
};
using Seg = SegT<unsigned>;

template <class Op>
__device__ __forceinline__ SegT<typename Op::T> seg_combine(SegT<typename Op::T> a,
                                                            SegT<typename Op::T> b) {
    return {a.f | b.f, b.f ? b.v : Op::f(a.v, b.v)};
}

template <class Op>
__device__ __forceinline__ SegT<typename Op::T> warp_seg_incl(SegT<typename Op::T> x, int lane) {
    using T = typename Op::T;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned f = __shfl_up_sync(FULL_MASK, x.f, o);
        const T v = __shfl_up_sync(FULL_MASK, x.v, o);
        if (lane >= o) x = seg_combine<Op>({f, v}, x);
    }
    return x;
}

// exclusive prefix of x over the block's THREADS threads, and the block's
// total; every thread of the block calls it; sm holds 2 * (THREADS / 32 + 1)
// values of Op::T and is free again on return
template <int THREADS, class Op = Sum>
__device__ __forceinline__ SegT<typename Op::T> block_seg_excl(SegT<typename Op::T> x,
                                                               SegT<typename Op::T>& total,
                                                               typename Op::T* sm) {
    using T = typename Op::T;
    using S = SegT<T>;
    constexpr int WARPS = THREADS / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const S incl = warp_seg_incl<Op>(x, lane);
    S excl = {__shfl_up_sync(FULL_MASK, incl.f, 1), __shfl_up_sync(FULL_MASK, incl.v, 1)};
    if (lane == 0) excl = {0u, T(0)};
    if (lane == 31) { sm[2 * warp] = T(incl.f); sm[2 * warp + 1] = incl.v; }
    __syncthreads();
    if (warp == 0) {
        S t = lane < WARPS ? S{(unsigned)sm[2 * lane], sm[2 * lane + 1]} : S{0u, T(0)};
        const S ti = warp_seg_incl<Op>(t, lane);
        S te = {__shfl_up_sync(FULL_MASK, ti.f, 1), __shfl_up_sync(FULL_MASK, ti.v, 1)};
        if (lane == 0) te = {0u, T(0)};
        if (lane < WARPS) { sm[2 * lane] = T(te.f); sm[2 * lane + 1] = te.v; }
        if (lane == WARPS - 1) { sm[2 * WARPS] = T(ti.f); sm[2 * WARPS + 1] = ti.v; }
    }
    __syncthreads();
    const S wp = {(unsigned)sm[2 * warp], sm[2 * warp + 1]};
    total = {(unsigned)sm[2 * WARPS], sm[2 * WARPS + 1]};
    __syncthreads();  // sm is free again for the next scan
    return seg_combine<Op>(wp, excl);
}

// the same without segments (the case of no flags, with half the shuffles)
template <int THREADS, class Op = Sum>
__device__ __forceinline__ typename Op::T block_excl(typename Op::T x, typename Op::T& total,
                                                     typename Op::T* sm) {
    using T = typename Op::T;
    constexpr int WARPS = THREADS / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    T incl = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const T v = __shfl_up_sync(FULL_MASK, incl, o);
        if (lane >= o) incl = Op::f(v, incl);
    }
    T excl = __shfl_up_sync(FULL_MASK, incl, 1);
    if (lane == 0) excl = T(0);
    if (lane == 31) sm[warp] = incl;
    __syncthreads();
    if (warp == 0) {  // the warps' totals: exclusive prefixes in sm[0 .. WARPS), total at WARPS
        const T t = lane < WARPS ? sm[lane] : T(0);
        T ti = t;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const T v = __shfl_up_sync(FULL_MASK, ti, o);
            if (lane >= o) ti = Op::f(v, ti);
        }
        T te = __shfl_up_sync(FULL_MASK, ti, 1);
        if (lane == 0) te = T(0);
        if (lane < WARPS) sm[lane] = te;
        if (lane == WARPS - 1) sm[WARPS] = ti;
    }
    __syncthreads();
    const T wp = sm[warp];
    total = sm[WARPS];
    __syncthreads();  // sm is free again for the next scan
    return Op::f(wp, excl);
}

// bytes s .. s + 15 of the 32 bytes lo, hi (s in [0, 16); the selects do
// not diverge where s is uniform across a warp)
__device__ __forceinline__ uint4 shift16(uint4 lo, uint4 hi, int s) {
    const unsigned w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const int q = s >> 2;
    const unsigned r = 8u * (s & 3);
    unsigned o[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) o[i] = q == 0 ? w[i] : q == 1 ? w[i + 1] : q == 2 ? w[i + 2] : w[i + 3];
    return make_uint4(__funnelshift_r(o[0], o[1], r), __funnelshift_r(o[1], o[2], r),
                      __funnelshift_r(o[2], o[3], r), __funnelshift_r(o[3], o[4], r));
}

// the 16 bytes at p, of which the first `need` (1..16) lie in the buffer:
// the aligned 16 bytes holding p, and the next 16 only where needed bytes
// lie there (an aligned load never crosses an allocation's granule)
__device__ __forceinline__ uint4 load16(const uint8_t* p, int need) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    const int s = (int)(a & 15);
    const uint4* q = reinterpret_cast<const uint4*>(a - s);
    const uint4 lo = __ldg(q);
    return s ? shift16(lo, s + need > 16 ? __ldg(q + 1) : make_uint4(0, 0, 0, 0), s) : lo;
}

// bytes 0..3 of a, b, c, z (four depths' or planes' words of four
// positions) -> one word per position holding its four bytes
__device__ __forceinline__ void transpose4(unsigned a, unsigned b, unsigned c, unsigned z,
                                           unsigned* x) {
    const unsigned lo0 = __byte_perm(a, b, 0x5140), lo1 = __byte_perm(c, z, 0x5140);
    const unsigned hi0 = __byte_perm(a, b, 0x7362), hi1 = __byte_perm(c, z, 0x7362);
    x[0] = __byte_perm(lo0, lo1, 0x5410);
    x[1] = __byte_perm(lo0, lo1, 0x7632);
    x[2] = __byte_perm(hi0, hi1, 0x5410);
    x[3] = __byte_perm(hi0, hi1, 0x7632);
}

}  // namespace
