// Block-wide scans shared by the Huffman (H1-H4) and fpl (F1-F3) kernels:
// warp shuffles within a warp, one entry per warp in shared memory across
// warps. Op is the associative combine of values of type Op::T (Sum over
// u32, or fpl's split-field adds over u32 and u64 words); SegT pairs a value
// with a segment-start flag, and the value restarts wherever a flag is set.
#pragma once

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

// the same without segments: a plain scan is the case of no flags
template <int THREADS, class Op = Sum>
__device__ __forceinline__ typename Op::T block_excl(typename Op::T x, typename Op::T& total,
                                                     typename Op::T* sm) {
    SegT<typename Op::T> tot;
    const typename Op::T ex = block_seg_excl<THREADS, Op>({0u, x}, tot, sm).v;
    total = tot.v;
    return ex;
}

}  // namespace
