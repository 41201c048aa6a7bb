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
// the OR of the read-modify-write.
//
// Edge rules: all arithmetic is uint32_t (255 << 24 does not fit a signed
// int32, the JAX words are negative there, and unsigned sums wrap as XLA's
// int32 sums do). A shift outside 0..31 gives 0, as XLA's shift does; a
// word outside 0..W-1 places nothing (no column of the one-hot, no lane of
// the mask matches it). Any R, any C >= 1, W up to a CTA's shared memory.
//
// What bounds it on an H100: each codeword is read once (12 bytes) and each
// word written once: 14.7 MB, about 4.4 us at 3.35 TB/s, at R = 4096; at
// R = 1 one launch is the whole cost. The dot and the mask are all-pairs by
// definition, W x C pairs a row (134 M at R = 4096), so for them the
// warp schedulers' rate is the limit: the design spends one accumulate a
// pair and a quarter of a compare. Designs, one per TPU body:
//   dot, mask: one kernel body (place_kernel), which differs only in how a
//         pair is combined: the dot multiplies the field by its one-hot
//         entry and accumulates, the mask adds the field under the
//         compare. One warp serves one row and a tile of 128 words; a
//         CTA's four warps serve four different rows, so a CTA reads each
//         of its rows' codewords from global memory once (128-bit loads
//         where the row is aligned), and no barrier spans the CTA. Each
//         lane keeps four neighbouring output words in registers, so the
//         compare factors: word == 4 * lane + j is word >> 2 == lane and
//         word & 3 == j. The second factor is paid once a codeword, at
//         staging: the warp writes to its slice of shared memory the lane
//         (word - tile >> 2; 32 or more for a word of another tile) and
//         the field in slot j of four, zeros in the others (the shift and
//         its guard are paid there too). Each lane then walks the staged
//         codewords: one compare of the lane, broadcast from a 128-bit
//         shared load of four, and four accumulates under it; then one
//         128-bit store of its words. Rows longer than the slice (256
//         codewords) go through it in pieces.
//   rmw:  one thread per codeword; atomicOr into a shared-memory row of W
//         words, then one coalesced store of the row (K5's way).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPlaceWarps = 4;          // dot and mask: four warps a CTA
constexpr int kLaneWords = 4;           // output words a lane
constexpr int kWarpWords = 32 * kLaneWords;
constexpr int kRoom = 256;              // staged codewords a warp (5 KB)
constexpr int kRmwThreads = 256;

__device__ __forceinline__ uint32_t shifted(int32_t v, int32_t s) {
    return (s < 0 || s >= 32) ? 0u : (uint32_t)v << s;
}

__device__ __forceinline__ uint32_t field(const int32_t* vals,
                                          const int32_t* shift, long long i) {
    return shifted(vals[i], shift[i]);
}

// One codeword against the tile of 128 words that starts at base: which
// lane's four words hold its word (32 or more: none of this tile), and its
// field in the slot of that word among the four, 0 in the other three.
__device__ __forceinline__ void stage_one(int32_t v, int32_t w, int32_t s,
                                          uint32_t base, uint32_t* hi,
                                          uint4* f) {
    const uint32_t d = (uint32_t)w - base;
    const uint32_t x = shifted(v, s), lo = d & 3u;
    *hi = d >> 2;
    *f = make_uint4(lo == 0u ? x : 0u, lo == 1u ? x : 0u,
                    lo == 2u ? x : 0u, lo == 3u ? x : 0u);
}

__device__ __forceinline__ void stage_warp(const int32_t* __restrict__ vals,
                                           const int32_t* __restrict__ word,
                                           const int32_t* __restrict__ shift,
                                           long long at, int len,
                                           uint32_t base, uint32_t* hi,
                                           uint4* f, int lane, bool vec) {
    const int quads = vec ? len >> 2 : 0;
    const int4* v4 = reinterpret_cast<const int4*>(vals + at);
    const int4* w4 = reinterpret_cast<const int4*>(word + at);
    const int4* s4 = reinterpret_cast<const int4*>(shift + at);
    for (int i = lane; i < quads; i += 32) {
        const int4 v = __ldg(v4 + i), w = __ldg(w4 + i), s = __ldg(s4 + i);
        stage_one(v.x, w.x, s.x, base, hi + 4 * i, f + 4 * i);
        stage_one(v.y, w.y, s.y, base, hi + 4 * i + 1, f + 4 * i + 1);
        stage_one(v.z, w.z, s.z, base, hi + 4 * i + 2, f + 4 * i + 2);
        stage_one(v.w, w.w, s.w, base, hi + 4 * i + 3, f + 4 * i + 3);
    }
    for (int i = 4 * quads + lane; i < len; i += 32) {
        stage_one(vals[at + i], word[at + i], shift[at + i], base, hi + i,
                  f + i);
    }
    // Fill the last group of four with codewords of no lane.
    const int pad = len + lane;
    if (pad < ((len + 3) & ~3)) {
        hi[pad] = 0xffffffffu;
        f[pad] = make_uint4(0u, 0u, 0u, 0u);
    }
}

template <bool DOT>
__device__ __forceinline__ void combine(uint32_t (&acc)[kLaneWords],
                                        uint32_t hi, const uint4 f,
                                        uint32_t lane) {
    if (DOT) {
        const uint32_t one = (uint32_t)(hi == lane);
        acc[0] += f.x * one; acc[1] += f.y * one;
        acc[2] += f.z * one; acc[3] += f.w * one;
    } else if (hi == lane) {
        acc[0] += f.x; acc[1] += f.y; acc[2] += f.z; acc[3] += f.w;
    }
}

// One warp per (tile of 128 words, row); tile-major, so the warps of a CTA
// serve different rows. DOT: the one-hot product, else the masked sum.
template <bool DOT>
__global__ void __launch_bounds__(kPlaceWarps * 32)
place_kernel(const int32_t* __restrict__ vals,
             const int32_t* __restrict__ word,
             const int32_t* __restrict__ shift, uint32_t* __restrict__ out,
             int R, int C, int W, bool aligned, bool wide_store) {
    __shared__ __align__(16) uint32_t s_hi[kPlaceWarps][kRoom];
    __shared__ __align__(16) uint4 s_f[kPlaceWarps][kRoom];
    const int warp = threadIdx.x >> 5;
    const uint32_t lane = threadIdx.x & 31;
    const long long item = (long long)blockIdx.x * kPlaceWarps + warp;
    const long long tiles = (W + kWarpWords - 1) / kWarpWords;
    if (item >= tiles * R) return;          // the whole warp; no CTA barrier
    const long long row = item % R;
    const uint32_t base = (uint32_t)(item / R) * kWarpWords;
    uint32_t* hi = s_hi[warp];
    uint4* f = s_f[warp];
    uint32_t acc[kLaneWords] = {};
    for (int c0 = 0; c0 < C; c0 += kRoom) {
        const int len = min(kRoom, C - c0);
        const long long at = row * C + c0;
        stage_warp(vals, word, shift, at, len, base, hi, f, lane,
                   aligned && (at & 3) == 0);
        __syncwarp();
#pragma unroll 2
        for (int i = 0; i < len; i += 4) {
            const uint4 h = *reinterpret_cast<const uint4*>(hi + i);
            combine<DOT>(acc, h.x, f[i], lane);
            combine<DOT>(acc, h.y, f[i + 1], lane);
            combine<DOT>(acc, h.z, f[i + 2], lane);
            combine<DOT>(acc, h.w, f[i + 3], lane);
        }
        __syncwarp();
    }
    const uint32_t w = base + kLaneWords * lane;
    uint32_t* dst = out + row * W + w;
    if (wide_store && w + kLaneWords <= (uint32_t)W) {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
        for (int j = 0; j < kLaneWords; ++j) {
            if (w + j < (uint32_t)W) dst[j] = acc[j];
        }
    }
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

template <bool DOT>
int launch_place(const void* vals, const void* word, const void* shift,
                 void* out, int R, int C, int W, void* stream) {
    const long long items = (long long)((W + kWarpWords - 1) / kWarpWords) * R;
    const bool aligned =
        (((uintptr_t)vals | (uintptr_t)word | (uintptr_t)shift) & 15) == 0;
    const bool wide_store = ((uintptr_t)out & 15) == 0 && (W & 3) == 0;
    place_kernel<DOT><<<(unsigned)((items + kPlaceWarps - 1) / kPlaceWarps),
                        kPlaceWarps * 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)vals, (const int32_t*)word, (const int32_t*)shift,
        (uint32_t*)out, R, C, W, aligned, wide_store);
    return (int)cudaGetLastError();
}

}  // namespace

// vals, word, shift: (R, C) int32; out: (R, W) 32-bit words. Each entry
// returns cudaGetLastError() after its launch.
extern "C" int srla_place_dot(const void* vals, const void* word,
                              const void* shift, void* out, int R, int C,
                              int W, void* stream) {
    return launch_place<true>(vals, word, shift, out, R, C, W, stream);
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
    return launch_place<false>(vals, word, shift, out, R, C, W, stream);
}
