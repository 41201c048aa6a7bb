// K8's first design, kept as a measurement aid for
// chip_smoke.py, which times it beside the current autocorr.cu. Nothing in
// the port calls it; its entry is srla_autocorr_v1. The text below is the
// first design's own.
//
// K8: the encode's windowed circular autocorrelation.
//
// Replaces the XLA program srla_tpu/kernels/exact.py:_autocorr_dd (lag loop
// :143, body :130), which the encode runs for the LPC lags of every analysis
// row (max order + 1 <= 256) and, with -P, for the 263 pitch lags before
// them. Per row of n samples x (int32) and lag k < L:
//
//   ac[k] = F / n * sum_{i < n} d[i] * d[(i + k) mod F],   d[i] = x[i] * w[i]
//
// with F the FFT size (a power of two >= n), d zero from n to F, and w the
// Welch window times 2^-(bps-1) (its middle sample 0 for odd n), exact in
// f64 as the plain version's. The lags are circular: when n = F every lag
// wraps, so the kernel reads an extended row ext[j] = d[j mod F] (0 where
// j mod F >= n), never the linear autocorrelation. Its plain version is
// kernels/autocorr.py:autocorr_plain.
//
// The sum order is part of the contract, because the lags feed the
// Levinson and LTP margins (kernels/exact.py, above _EPS_PREEMPH): each
// thread sums one strip of 64 consecutive products in order, every product
// and every add rounded once (__dmul_rn, __dadd_rn: no multiply-add
// contraction, so tests/test_torch_autocorr.py emulates the order exactly
// in torch); the 32 strips of a warp are combined by an xor-butterfly tree,
// the warps' groups of 2048 samples by a pairwise tree, stages of 16384
// samples in order, then one multiply by F / n. The error is at most
// (64 + log2(strips) + stages) u of r0, u = 2^-53: 73 u = 2^-46.8 r0 at
// n = 16384.
//
// What bounds it on an H100: L * n multiply-adds a row in f64, at the
// encode's main path 5164 rows x 4096 x 65 lags (1.4 G) or x 263 (5.6 G),
// against 85 MB of int32 samples read once: the f64 pipe (34 TFLOP/s, 0.33
// ms for the 263 lags, counting the multiply and the add as the two flops
// of a fused multiply-add), not the bytes (0.025 ms). Without contraction
// the multiply and the add take a slot each, so this design's floor is
// twice that bound.
//
// Design: a CTA per row stages the windowed row once in shared memory as
// f64 (one device read a sample) in a padded layout (a spare word after
// every 64, so 32 lanes on 32 strips hit 32 banks), with a halo of the
// padded lag count past the stage, taken circularly. A warp item is 8
// consecutive lags x one group of 32 strips: each lane keeps its strip's 8
// lags' products as a sliding window of 8 samples in registers, so a step
// of 8 multiply-adds costs two shared loads and the f64 pipe sets the
// pace. Rows longer than a stage (16384 samples, 154 KB of dynamic shared
// memory) are staged in turns, each stage with its own halo.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStrip = 64;                 // products one thread sums in order
constexpr int kGroup = 32 * kStrip;        // samples of one warp's 32 strips
constexpr int kLags = 8;                   // consecutive lags of one thread
constexpr int kStageGroups = 8;            // groups staged at once
constexpr int kThreads = 256;
constexpr int kMaxLags = 1024;

// Shared-memory index of extended-row sample j of a stage: a spare word
// after every 64.
__host__ __device__ __forceinline__ int padded(int j) { return j + (j >> 6); }

__host__ __device__ __forceinline__ int pad_lags(int L) {
    return (L + kLags - 1) / kLags * kLags;
}

// Doubles of dynamic shared memory: the staged samples with their halo, a
// partial sum per group and padded lag, and the row's running sums.
__host__ __device__ __forceinline__ int smem_doubles(int stage_groups,
                                                     int L) {
    const int Lp = pad_lags(L);
    return padded(stage_groups * kGroup + Lp) + 1 + stage_groups * Lp + Lp;
}

__global__ void __launch_bounds__(kThreads)
autocorr_kernel(const int32_t* __restrict__ work,
                const double* __restrict__ win, double* __restrict__ out,
                int n, int L, int F, double norm) {
    extern __shared__ double smem[];
    const int Lp = pad_lags(L);
    const int LT = Lp / kLags;
    const int groups = (n + kGroup - 1) / kGroup;
    const int stage_groups = min(groups, kStageGroups);
    double* buf = smem;
    double* part = buf + padded(stage_groups * kGroup + Lp) + 1;
    double* total = part + stage_groups * Lp;
    const int32_t* x = work + (size_t)blockIdx.x * n;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;

    for (int g0 = 0; g0 < groups; g0 += kStageGroups) {
        const int ng = min(kStageGroups, groups - g0);
        const int start = g0 * kGroup;
        const int span = ng * kGroup + Lp;
        __syncthreads();                   // the last stage's reads are done
        for (int j = threadIdx.x; j < span; j += blockDim.x) {
            const int m = (start + j) % F;
            buf[padded(j)] = m < n ? __dmul_rn((double)x[m], win[m]) : 0.0;
        }
        __syncthreads();
        for (int item = warp; item < LT * ng; item += nwarps) {
            const int c = (item % LT) * kLags;       // the item's first lag
            const int g = item / LT;
            const int i0 = (g * 32 + lane) * kStrip;  // the lane's strip
            const int live = n - (start + i0);        // its samples below n
            const double* xs = buf + padded(i0);
            double w[kLags], acc[kLags];
#pragma unroll
            for (int r = 0; r < kLags; ++r) {
                w[r] = buf[padded(i0 + c + r)];
                acc[r] = 0.0;
            }
#pragma unroll
            for (int t = 0; t < kStrip; ++t) {
                const double xv = t < live ? xs[t] : 0.0;
#pragma unroll
                for (int r = 0; r < kLags; ++r)
                    acc[r] = __dadd_rn(acc[r], __dmul_rn(xv, w[r]));
                if (t + 1 < kStrip) {
#pragma unroll
                    for (int r = 0; r + 1 < kLags; ++r) w[r] = w[r + 1];
                    w[kLags - 1] = buf[padded(i0 + c + t + kLags)];
                }
            }
            // The group's 32 strips: a pairwise tree over the lanes; every
            // lane ends with the same sums (addition commutes bit for bit).
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
                for (int r = 0; r < kLags; ++r)
                    acc[r] = __dadd_rn(acc[r],
                                       __shfl_xor_sync(0xffffffffu, acc[r],
                                                       off));
            }
            if (lane < kLags) {
                double v = acc[0];
#pragma unroll
                for (int r = 1; r < kLags; ++r)
                    if (lane == r) v = acc[r];
                part[g * Lp + c + lane] = v;
            }
        }
        __syncthreads();
        // The stage's groups: a pairwise tree; stages add up in order.
        for (int k = threadIdx.x; k < Lp; k += blockDim.x) {
            for (int s = 1; s < ng; s <<= 1)
                for (int g = 0; g + s < ng; g += 2 * s)
                    part[g * Lp + k] = __dadd_rn(part[g * Lp + k],
                                                 part[(g + s) * Lp + k]);
            total[k] = g0 == 0 ? part[k] : __dadd_rn(total[k], part[k]);
        }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < L; k += blockDim.x)
        out[(size_t)blockIdx.x * L + k] = __dmul_rn(total[k], norm);
}

}  // namespace

// work (V, n) int32, win (n,) f64, out (V, L) f64; 1 <= L <= 1024, F a
// power of two >= n.
extern "C" int srla_autocorr_v1(const void* work, const void* win, void* out,
                             int V, int n, int L, int F, void* stream) {
    if (L < 1 || L > kMaxLags || n < 1 || F < n)
        return (int)cudaErrorInvalidValue;
    const int groups = (n + kGroup - 1) / kGroup;
    const size_t bytes = sizeof(double)
        * (size_t)smem_doubles(groups < kStageGroups ? groups : kStageGroups,
                               L);
    cudaError_t e = cudaFuncSetAttribute(
        autocorr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(double) * (size_t)smem_doubles(kStageGroups, kMaxLags)));
    if (e != cudaSuccess) return (int)e;
    autocorr_kernel<<<V, kThreads, bytes, (cudaStream_t)stream>>>(
        (const int32_t*)work, (const double*)win, (double*)out, n, L, F,
        (double)F / (double)n);
    return (int)cudaGetLastError();
}
