// K16: the variant stack and the exact pre-emphasis of the encode, one
// launch from the samples to the pre-emphasised variant rows.
//
// Replaces the XLA program of srla_tpu/kernels/exact.py:1208-1219 (the
// stack in _variant_analysis) and :83 _preemphasis_exact. Sample s of
// channel c of block b is src[off[b] + c * cstride + s] (int16 or int32):
// the resident (C, N) file at its span offsets (cstride N), or a (B, C, n)
// block tensor at its strides (off[b] = b * bstride; a contiguous one has
// bstride C * n and cstride n), with no copy of the spans first. After
// the offset shift w_c = x_c >> lshift, the variant rows are
// [M, S, w_0, ..., w_(C-1)] for C >= 2 (S = w_1 - w_0, M = w_0 + (S >> 1),
// wrapping int32 as torch's int32 ops wrap) and [w_0] for C = 1; row
// v * B + b is variant v of block b. For each row:
//
//   r0 = sum x[s]^2, r1 = sum x[s] x[s+1]          (64-bit integers)
//   dc16 = (double(r1) / double(r0)) * 16           (r0 = 0: coef 0)
//   coef = clamp(round_half_away(dc16), -16, 15)
//   risky = |frac(|dc16|) - 0.5| < eps and r0 != 0
//   work[s] = x[s] - ((x[s-1] * coef) >> 4)         (x[-1] = x[0])
//
// with pre_prev = x[0]. The sums are exact 64-bit integer sums, wrapping
// as torch's int64 sums wrap, so any order of the adds gives the plain
// version's value; each is converted once with __ll2double_rn, and every
// f64 operation after it is an _rn intrinsic, so no contraction changes a
// rounding. The residual is wrapping int32: the product in uint32_t, then
// an arithmetic shift of its int32 pattern.
//
// What bounds it on an H100: bytes. At the main group (B 1291, C 2, n
// 4096, int16) it reads 21 MB of samples and writes 85 MB of int32 rows:
// 0.032 ms at 3.35 TB/s; a sample takes a dozen integer instructions.
//
// Design (a simple first kernel): a CTA of 256 threads a variant row. Pass
// one forms each sample of the row from its one or two channels (the
// neighbour for r1 through L1) and sums r0 and r1 in 64-bit registers;
// the two sums meet in warp shuffles and one shared pass; thread 0 takes
// the coefficient and the flag. Pass two forms the samples again (the
// row's source is in L1 or L2 by then) and writes the residual, coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Sample s of variant kind (-2: M, -1: S, c >= 0: channel c) of the block
// whose channel 0 starts at base.
template <typename T>
__device__ __forceinline__ int32_t variant_sample(const T* __restrict__ base,
                                                  long long cstride, int kind,
                                                  int lshift, int s) {
    if (kind >= 0) return (int32_t)base[kind * cstride + s] >> lshift;
    const int32_t w0 = (int32_t)base[s] >> lshift;
    const int32_t w1 = (int32_t)base[cstride + s] >> lshift;
    const int32_t d = (int32_t)((uint32_t)w1 - (uint32_t)w0);
    if (kind == -1) return d;
    return (int32_t)((uint32_t)w0 + (uint32_t)(d >> 1));
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
preemphasis_kernel(const T* __restrict__ src,
                   const long long* __restrict__ off, long long bstride,
                   long long cstride, int B, int C, int n, int lshift,
                   int shift, double eps, int32_t* __restrict__ work,
                   int32_t* __restrict__ coef_out,
                   uint8_t* __restrict__ risky_out,
                   int32_t* __restrict__ prev_out) {
    __shared__ unsigned long long part[2][kWarps];
    __shared__ int32_t coef_sh;
    const int row = blockIdx.x;                    // v * B + b
    const int v = row / B;
    const int b = row - v * B;
    const int kind = C >= 2 ? v - 2 : v;
    const T* base = src + (off != nullptr ? off[b] : (long long)b * bstride);
    unsigned long long r0 = 0, r1 = 0;
    for (int s = threadIdx.x; s < n; s += kThreads) {
        const long long x = variant_sample(base, cstride, kind, lshift, s);
        r0 += (unsigned long long)(x * x);
        if (s + 1 < n) {
            const long long y = variant_sample(base, cstride, kind, lshift,
                                               s + 1);
            r1 += (unsigned long long)(x * y);
        }
    }
    r0 = warp_sum(r0);
    r1 = warp_sum(r1);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
        part[0][warp] = r0;
        part[1][warp] = r1;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned long long s0 = 0, s1 = 0;
        for (int w = 0; w < kWarps; ++w) {
            s0 += part[0][w];
            s1 += part[1][w];
        }
        const long long r0i = (long long)s0, r1i = (long long)s1;
        const bool zero = r0i == 0;
        const double d0 = zero ? 1.0 : __ll2double_rn(r0i);
        const double dc16 = __dmul_rn(__ddiv_rn(__ll2double_rn(r1i), d0),
                                      (double)(1 << shift));
        const double ax = fabs(dc16);
        const double r = floor(__dadd_rn(ax, 0.5));
        double q = dc16 < 0.0 ? -r : r;
        const double lim = (double)(1 << shift);
        q = q < -lim ? -lim : (q > lim - 1.0 ? lim - 1.0 : q);
        const int32_t coef = zero ? 0 : (int32_t)q;
        const double dist = fabs(__dsub_rn(__dsub_rn(ax, floor(ax)), 0.5));
        coef_out[row] = coef;
        risky_out[row] = (uint8_t)(dist < eps && !zero);
        prev_out[row] = variant_sample(base, cstride, kind, lshift, 0);
        coef_sh = coef;
    }
    __syncthreads();
    const uint32_t coef = (uint32_t)coef_sh;
    int32_t* out = work + (long long)row * n;
    for (int s = threadIdx.x; s < n; s += kThreads) {
        const int32_t x = variant_sample(base, cstride, kind, lshift, s);
        const int32_t p = s > 0
            ? variant_sample(base, cstride, kind, lshift, s - 1) : x;
        const int32_t pred = (int32_t)((uint32_t)p * coef) >> shift;
        out[s] = (int32_t)((uint32_t)x - (uint32_t)pred);
    }
}

}  // namespace

// src: int16 (src32 0) or int32 (src32 non-zero) samples; off: (B,) int64
// offsets of each block's channel 0, or null for off[b] = b * bstride;
// cstride: the distance between a block's channels. Outputs for the V =
// (C >= 2 ? C + 2 : 1) * B rows: work (V, n) int32, coef (V,) int32, risky
// (V,) bool, prev (V,) int32.
extern "C" int srla_preemphasis(const void* src, const void* off,
                                long long bstride, long long cstride, int B,
                                int C, int n, int lshift, int shift,
                                double eps, int src32, void* work, void* coef,
                                void* risky, void* prev, void* stream) {
    if (B <= 0 || C <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
    const long long rows = (long long)(C >= 2 ? C + 2 : 1) * B;
    if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (src32) {
        preemphasis_kernel<int32_t><<<(unsigned)rows, kThreads, 0, s>>>(
            (const int32_t*)src, (const long long*)off, bstride, cstride, B,
            C, n, lshift, shift, eps, (int32_t*)work, (int32_t*)coef,
            (uint8_t*)risky, (int32_t*)prev);
    } else {
        preemphasis_kernel<int16_t><<<(unsigned)rows, kThreads, 0, s>>>(
            (const int16_t*)src, (const long long*)off, bstride, cstride, B,
            C, n, lshift, shift, eps, (int32_t*)work, (int32_t*)coef,
            (uint8_t*)risky, (int32_t*)prev);
    }
    return (int)cudaGetLastError();
}
