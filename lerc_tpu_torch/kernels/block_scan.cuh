// Block-wide scans shared by the Huffman (H1-H4) and fpl (F1-F3) kernels:
// warp shuffles within a warp, one word per warp in shared memory across
// warps. Op is the associative combine of u32 values (Sum, or fpl's
// split-field add); Seg pairs a value with a segment-start flag, and the
// value restarts wherever a flag is set.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;

struct Sum {
    __device__ static unsigned f(unsigned a, unsigned b) { return a + b; }
};

// (segment flag, value): B after A = (fa | fb, fb ? vb : op(va, vb))
struct Seg {
    unsigned f, v;
};

template <class Op>
__device__ __forceinline__ Seg seg_combine(Seg a, Seg b) {
    return {a.f | b.f, b.f ? b.v : Op::f(a.v, b.v)};
}

template <class Op>
__device__ __forceinline__ Seg warp_seg_incl(Seg x, int lane) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned f = __shfl_up_sync(FULL_MASK, x.f, o), v = __shfl_up_sync(FULL_MASK, x.v, o);
        if (lane >= o) x = seg_combine<Op>({f, v}, x);
    }
    return x;
}

// exclusive prefix of x over the block's THREADS threads, and the block's
// total; every thread of the block calls it; sm holds 2 * (THREADS / 32 + 1)
// words and is free again on return
template <int THREADS, class Op = Sum>
__device__ __forceinline__ Seg block_seg_excl(Seg x, Seg& total, unsigned* sm) {
    constexpr int WARPS = THREADS / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const Seg incl = warp_seg_incl<Op>(x, lane);
    Seg excl = {__shfl_up_sync(FULL_MASK, incl.f, 1), __shfl_up_sync(FULL_MASK, incl.v, 1)};
    if (lane == 0) excl = {0, 0};
    if (lane == 31) { sm[2 * warp] = incl.f; sm[2 * warp + 1] = incl.v; }
    __syncthreads();
    if (warp == 0) {
        Seg t = lane < WARPS ? Seg{sm[2 * lane], sm[2 * lane + 1]} : Seg{0, 0};
        const Seg ti = warp_seg_incl<Op>(t, lane);
        Seg te = {__shfl_up_sync(FULL_MASK, ti.f, 1), __shfl_up_sync(FULL_MASK, ti.v, 1)};
        if (lane == 0) te = {0, 0};
        if (lane < WARPS) { sm[2 * lane] = te.f; sm[2 * lane + 1] = te.v; }
        if (lane == WARPS - 1) { sm[2 * WARPS] = ti.f; sm[2 * WARPS + 1] = ti.v; }
    }
    __syncthreads();
    const Seg wp = {sm[2 * warp], sm[2 * warp + 1]};
    total = {sm[2 * WARPS], sm[2 * WARPS + 1]};
    __syncthreads();  // sm is free again for the next scan
    return seg_combine<Op>(wp, excl);
}

// the same without segments: a plain scan is the case of no flags
template <int THREADS, class Op = Sum>
__device__ __forceinline__ unsigned block_excl(unsigned x, unsigned& total, unsigned* sm) {
    Seg tot;
    const unsigned ex = block_seg_excl<THREADS, Op>({0u, x}, tot, sm).v;
    total = tot.v;
    return ex;
}

}  // namespace
