// K6: the bit-field placement probes, three ways to put disjoint fields
// into 32-bit words.
//
// Replaces the Pallas TPU kernel of tools/mosaic_repro.py (_run, the
// pl.pallas_call at :102) with its three bodies:
//
//   _dot_kernel  (:61)  out = (vals << shift) @ onehot(word), M = 1
//   _rmw_kernel  (:74)  a sequential loop ORing each codeword into
//                       out[word]
//   _mask_kernel (:89)  out[w] = sum_c where(word[c] == w, vals << shift, 0)
//
// Each row r of R rows places its C codewords vals[r, c] << shift[r, c]
// into W words at word[r, c]; the tool's case is R = 1, C = 256, W = 128.
// Fields of one row are disjoint, so the sum of the dot and the mask equals
// the OR of the read-modify-write. All arithmetic is uint32_t: 255 << 24
// does not fit a signed int32 (the JAX words are negative there), and
// unsigned sums wrap as XLA's int32 sums do. A shift outside 0..31 gives 0,
// as XLA's shift does; a word outside 0..W-1 places nothing (no column of
// the one-hot, no lane of the mask matches it).
//
// What bounds it on an H100: each codeword is read once (12 bytes) and each
// word written once; the work is a shift and an add per codeword. At R = 1
// one launch is the whole cost; at R = 4096 the 14.7 MB of traffic take
// about 4.4 us at 3.35 TB/s. Designs, one per TPU body:
//   dot:  one thread per output word; a block stages a tile of its row's
//         shifted codewords and words in shared memory, and each thread
//         multiply-accumulates the tile against its one-hot column.
//   rmw:  one thread per codeword; atomicOr into a shared-memory row of W
//         words, then one coalesced store of the row (K5's way).
//   mask: one warp per output word; the lanes stride over the row's
//         codewords, sum the matching fields and reduce with
//         __reduce_add_sync.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kDotThreads = 128;
constexpr int kDotTile = 1024;
constexpr int kRmwThreads = 256;
constexpr int kMaskWarps = 4;

__device__ __forceinline__ uint32_t field(const int32_t* vals,
                                          const int32_t* shift, long long i) {
    const int s = shift[i];
    return (s < 0 || s >= 32) ? 0u : (uint32_t)vals[i] << s;
}

// grid (R, ceil(W / kDotThreads)); thread w of the row's words.
__global__ void dot_kernel(const int32_t* __restrict__ vals,
                           const int32_t* __restrict__ word,
                           const int32_t* __restrict__ shift,
                           uint32_t* __restrict__ out, int C, int W) {
    __shared__ uint32_t s_val[kDotTile];
    __shared__ int32_t s_word[kDotTile];
    const long long row = blockIdx.x;
    const int w = blockIdx.y * kDotThreads + threadIdx.x;
    const long long base = row * C;
    uint32_t acc = 0;
    for (int t0 = 0; t0 < C; t0 += kDotTile) {
        const int len = min(kDotTile, C - t0);
        for (int j = threadIdx.x; j < len; j += kDotThreads) {
            s_val[j] = field(vals, shift, base + t0 + j);
            s_word[j] = word[base + t0 + j];
        }
        __syncthreads();
        for (int j = 0; j < len; ++j) {
            acc += s_val[j] * (uint32_t)(s_word[j] == w);
        }
        __syncthreads();
    }
    if (w < W) out[row * W + w] = acc;
}

// grid R; dynamic shared memory W words.
__global__ void rmw_kernel(const int32_t* __restrict__ vals,
                           const int32_t* __restrict__ word,
                           const int32_t* __restrict__ shift,
                           uint32_t* __restrict__ out, int C, int W) {
    extern __shared__ uint32_t s_row[];
    const long long row = blockIdx.x;
    const long long base = row * C;
    for (int w = threadIdx.x; w < W; w += kRmwThreads) s_row[w] = 0u;
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kRmwThreads) {
        const int w = word[base + c];
        if (w >= 0 && w < W) {
            atomicOr(&s_row[w], field(vals, shift, base + c));
        }
    }
    __syncthreads();
    for (int w = threadIdx.x; w < W; w += kRmwThreads) {
        out[row * W + w] = s_row[w];
    }
}

// grid (R, ceil(W / kMaskWarps)); warp k of a block owns one word.
__global__ void mask_kernel(const int32_t* __restrict__ vals,
                            const int32_t* __restrict__ word,
                            const int32_t* __restrict__ shift,
                            uint32_t* __restrict__ out, int C, int W) {
    const long long row = blockIdx.x;
    const int w = blockIdx.y * kMaskWarps + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (w >= W) return;                   // the whole warp leaves together
    const long long base = row * C;
    uint32_t acc = 0;
    for (int c = lane; c < C; c += 32) {
        if (word[base + c] == w) acc += field(vals, shift, base + c);
    }
    acc = __reduce_add_sync(0xffffffffu, acc);
    if (lane == 0) out[row * W + w] = acc;
}

}  // namespace

// vals, word, shift: (R, C) int32; out: (R, W) 32-bit words. Each entry
// returns cudaGetLastError() after its launch.
extern "C" int srla_place_dot(const void* vals, const void* word,
                              const void* shift, void* out, int R, int C,
                              int W, void* stream) {
    const dim3 grid(R, (W + kDotThreads - 1) / kDotThreads);
    dot_kernel<<<grid, kDotThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)vals, (const int32_t*)word, (const int32_t*)shift,
        (uint32_t*)out, C, W);
    return (int)cudaGetLastError();
}

extern "C" int srla_place_rmw(const void* vals, const void* word,
                              const void* shift, void* out, int R, int C,
                              int W, void* stream) {
    const size_t smem = (size_t)W * sizeof(uint32_t);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            rmw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    rmw_kernel<<<R, kRmwThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)vals, (const int32_t*)word, (const int32_t*)shift,
        (uint32_t*)out, C, W);
    return (int)cudaGetLastError();
}

extern "C" int srla_place_mask(const void* vals, const void* word,
                               const void* shift, void* out, int R, int C,
                               int W, void* stream) {
    const dim3 grid(R, (W + kMaskWarps - 1) / kMaskWarps);
    mask_kernel<<<grid, kMaskWarps * 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)vals, (const int32_t*)word, (const int32_t*)shift,
        (uint32_t*)out, C, W);
    return (int)cudaGetLastError();
}
