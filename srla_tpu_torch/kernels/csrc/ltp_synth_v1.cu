// K9's first design, kept as a measurement aid for
// chip_smoke.py, which times it beside the current ltp_synth.cu. Nothing in
// the port calls it; its entry is srla_ltp_synth_v1. The text below is the
// first design's own.
//
// K9: the decode's long-term-prediction (pitch) synthesis.
//
// Replaces the XLA scan srla_tpu/kernels/decode2.py:_ltp_pass (step :641)
// and computes, per row r, what kernels/ltp.py:ltp_synth_plain computes:
//
//   y[s] = v[s] + ((16 + sum_{i < taps} c[i] * y[s - delay + i]) >> 5)
//                                                     for s >= delay + 1
//   y[s] = v[s]                                       otherwise
//
// delay = period + order / 2, taps = min(order, L); rows with period or
// order 0 are copied through. The sum wraps mod 2^32: it is done in
// uint32_t and only the shift reinterprets it as int32_t (PERF.md,
// "Wrapping int32 in C++"). y reads its own earlier outputs, never v.
//
// What bounds it on an H100: the recurrence. y[s] waits on y[s - delay +
// taps - 1], so w = delay - taps + 1 consecutive samples depend only on
// outputs before them; the JAX scan resolves a fixed 7 (the smallest w a
// valid stream has) per step. The bytes (v in, y out) are small beside the
// n / w dependent steps.
//
// Design: one warp per row, four rows a CTA. Each row resolves its own w =
// min(32, delay - taps + 1) samples per step, one a lane (32 at the main
// path's periods of ~225: 128 steps for 4096 samples instead of 586); the
// final outputs go into a 512-slot ring in shared memory (2 KB a warp),
// which holds the largest delay (263) plus a step, and the next step's v
// is loaded a step ahead. The format's periods are 0 or at least 8, so w
// >= 6; a period below that would make w < 1, which is raised to 1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                 // rows (warps) per CTA
constexpr int kRing = 512;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
ltp_synth_kernel(const int32_t* __restrict__ v,
                 const int32_t* __restrict__ orders,
                 const int32_t* __restrict__ periods,
                 const int32_t* __restrict__ coefs,
                 int32_t* __restrict__ out, int R, int n, int L) {
    __shared__ uint32_t ring_all[kWarps][kRing];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long row = (long long)blockIdx.x * kWarps + warp;
    if (row >= R) return;                       // the whole warp leaves
    const int32_t* x = v + row * n;
    int32_t* y = out + row * n;
    const int order = orders[row];
    const int period = periods[row];
    if (period <= 0 || order <= 0) {
        for (int s = lane; s < n; s += 32) y[s] = x[s];
        return;
    }
    uint32_t* ring = ring_all[warp];
    const int taps = order < L ? order : L;
    const int delay = period + (order >> 1);
    int w = delay - taps + 1;
    w = w > 32 ? 32 : (w < 1 ? 1 : w);
    uint32_t c[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
        c[i] = i < taps ? (uint32_t)coefs[row * L + i] : 0u;
    const bool act = lane < w;
    uint32_t xnext = act && lane < n ? (uint32_t)x[lane] : 0u;
    for (int s0 = 0; s0 < n; s0 += w) {
        const int s = s0 + lane;
        const uint32_t xv = xnext;
        xnext = act && s + w < n ? (uint32_t)x[s + w] : 0u;
        if (act && s < n) {
            uint32_t val = xv;
            if (s >= delay + 1) {
                const int base = s - delay;
                uint32_t acc = 16u;             // 1 << (5 - 1)
                for (int i = 0; i < taps; ++i)
                    acc += c[i] * ring[(base + i) & (kRing - 1)];
                val = xv + (uint32_t)((int32_t)acc >> 5);
            }
            ring[s & (kRing - 1)] = val;
            y[s] = (int32_t)val;
        }
        __syncwarp(kFull);                      // this step's outputs land
    }
}

}  // namespace

// v, out: (R, n) int32; orders, periods: (R,) int32; coefs: (R, L) int32,
// 1 <= L <= 3.
extern "C" int srla_ltp_synth_v1(const void* v, const void* orders,
                              const void* periods, const void* coefs,
                              void* out, int R, int n, int L, void* stream) {
    if (L < 1 || L > 3) return (int)cudaErrorInvalidValue;
    const int blocks = (R + kWarps - 1) / kWarps;
    ltp_synth_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)v, (const int32_t*)orders, (const int32_t*)periods,
        (const int32_t*)coefs, (int32_t*)out, R, n, L);
    return (int)cudaGetLastError();
}
