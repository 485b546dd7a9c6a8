// The Pallas probes of tools/profile_pallas.py on Hopper: Q1 probe_write,
// Q2 probe_window, Q3 probe_asm.
//
// Replaces _k_write (:36, pallas_call :47), _k_window (:63, :78) and _k_asm
// (:103, :119), the repo's only pl.pallas_call kernels. They probe what the
// TPU does with dynamic sublane offsets (a row offset only known at run
// time) and lane rolls, on 128-lane rows. Here a row is 128 consecutive u32
// words and a roll is an index rotation, so each kernel is a gather or a
// scatter-add over rows.
//
// Q1 and Q3 add 2-row slabs into an output of at most MAX_ROWS rows at
// dynamic row offsets; slabs may overlap. The TPU runs its grid in order on
// one core; here the output's columns are split among CTAs of one warp, a
// lane owns one column and adds the slabs in order into shared memory, so
// no two threads ever touch one word (no atomics) and the sums wrap as u32
// (int32 for Q1: the same bits). Q3's TPU kernel zeroes its output block in
// every one of its 128 programs, all of which map to block (0, 0): only the
// last program's 512 slabs reach the output, and that is what is computed
// here (a fault of the probe, ROADMAP queue 3). Bound: bytes (the slabs
// read, the output written once); the serial chain of 2 x 512 adds per lane
// is the latency here, at these sizes.
//
// Q2 gathers a rotated 2-row window of a small stream for each of N offsets:
// one thread per output word, coalesced stores of the 2N x 128 words (the
// stream, 512 KB at the probe's shape, is read from L2). Bound: bytes (the
// output written once dominates).
//
// The wrappers (lerc_tpu_torch/ops/probes.py) check every offset against
// the shapes before a launch: Pallas does not, and a kernel here must not
// write out of bounds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 128;       // words in a row
constexpr int COLS = 32;         // output columns of a CTA: one warp
constexpr int MAX_ROWS = 384;    // 384 x 32 x 4 B = 48 KB of static shared memory

// Adds slabs [first, n) of vals into out [rows, 128]: slab i (rows 2i, 2i+1
// of vals) lands at out row (ROLL ? offs[i] >> 7 : offs[i]), rotated right
// by offs[i] & 127 lanes when ROLL (jnp.roll direction).
template <bool ROLL>
__global__ void slab_accumulate(const int* __restrict__ offs, int first, int n,
                                const uint32_t* __restrict__ vals, int rows,
                                uint32_t* __restrict__ out) {
    __shared__ uint32_t acc[MAX_ROWS][COLS];
    const int c = threadIdx.x;
    const int col = blockIdx.x * COLS + c;
    for (int r = 0; r < rows; ++r) acc[r][c] = 0u;
    for (int i = first; i < n; ++i) {
        const int o = offs[i];
        const int row = ROLL ? (o >> 7) : o;
        const int src = ROLL ? ((col - (o & (LANES - 1))) & (LANES - 1)) : col;
        const uint32_t* v = vals + (long long)2 * i * LANES;
        acc[row][c] += v[src];
        acc[row + 1][c] += v[LANES + src];
    }
    for (int r = 0; r < rows; ++r) out[(long long)r * LANES + col] = acc[r][c];
}

__global__ void window_kernel(const int* __restrict__ offs, long long n_words,
                              const uint32_t* __restrict__ stream,
                              uint32_t* __restrict__ out) {
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n_words;
         t += (long long)gridDim.x * blockDim.x) {
        const long long i = t >> 8;              // offset index: 2 rows x 128 words each
        const int r = (int)(t >> 7) & 1;
        const int l = (int)t & (LANES - 1);
        const int o = __ldg(offs + i);
        const int w = (o >> 7) + r;
        out[t] = __ldg(stream + (long long)w * LANES + ((l + (o & (LANES - 1))) & (LANES - 1)));
    }
}

}  // namespace

extern "C" {

// Q1: out [rows, 128] (int32 bits) = sum over the n slabs, slab i at row offs[i].
int probe_write(const int* offs, int n, const uint32_t* vals, int rows, uint32_t* out,
                void* stream) {
    if (rows > MAX_ROWS) return (int)cudaErrorInvalidValue;
    slab_accumulate<false><<<LANES / COLS, COLS, 0, (cudaStream_t)stream>>>(offs, 0, n, vals,
                                                                           rows, out);
    return (int)cudaGetLastError();
}

// Q2: out [2n, 128] = each offset's rotated 2-row window of stream [*, 128].
int probe_window(const int* offs, int n, const uint32_t* stream_rows, uint32_t* out,
                 void* stream) {
    const long long n_words = (long long)n * 2 * LANES;
    const int threads = 256;
    long long blocks = (n_words + threads - 1) / threads;
    if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond 32 CTAs an SM
    window_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(offs, n_words, stream_rows,
                                                                      out);
    return (int)cudaGetLastError();
}

// Q3: out [rows, 128] = the slabs of offsets [first, n) (the last program's),
// each rotated by its lane and added at row offs[i] >> 7.
int probe_asm(const int* offs, int first, int n, const uint32_t* vals, int rows, uint32_t* out,
              void* stream) {
    if (rows > MAX_ROWS) return (int)cudaErrorInvalidValue;
    slab_accumulate<true><<<LANES / COLS, COLS, 0, (cudaStream_t)stream>>>(offs, first, n, vals,
                                                                          rows, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
