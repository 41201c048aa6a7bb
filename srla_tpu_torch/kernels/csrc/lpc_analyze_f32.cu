// K14: the f32 LPC analysis of the approximate encode, in one launch.
//
// Replaces srla_tpu/kernels/encode.py:67 _levinson (both of its calls,
// :358 for the error variances and :360 to collect the coefficients at the
// chosen orders), :122 _select_order and :140 _quantize, which the TPU runs
// as XLA fori_loops inside the approximate analysis (analyze_blocks_ex).
// For each row of the (V, M+1) f32 lags (the ridge already on lag 0) it
// computes what those three return:
//
//   1. the Levinson-Durbin recursion in f32: a[1] = -ac[1] / r0 (r0 taken
//      as 1 below 1e-30), ev[1] = r0 + ac[1] a[1], then for k = 0..M-2
//        gamma  = sum_{i=0..k+1} a[i] ac[k+2-i]       (in that order)
//        gamma /= -ev[k+1]                    (ev taken as 1 below 1e-30)
//        ev[k+2] = ev[k+1] (1 - gamma^2)
//        a[i] += gamma a[k+2-i]                for i <= k+2;
//      JAX sums gamma over all M+2 columns, whose terms past k+1 are exact
//      zero products: they are left out here and in the plain version, so
//      the two sum the same terms in the same order;
//   2. the order: argmin over o = 1..M of ent(ev[o]) n + 8 o (the first
//      minimum; a NaN length counts as -inf, as the plain version's argmin
//      sees it), ent the Laplace entropy of the error variance with the
//      Welch window's correction; every ev taken as r0 on a silent row
//      (|r0| < 2^-23); the order is M at max_fixed;
//   3. the coefficients a[1..order] at that order (zero on a silent row;
//      JAX runs the recursion again to collect them, the plain version
//      too), quantized to 8 bits: the shift
//      from frexp of the largest magnitude (15 past the 16-bit field, 8 for
//      a magnitude <= 2^-7, whose coefficients are all 0), then from the
//      last coefficient to the first qe = qerr + c scale, q = rint(qe)
//      (half to even, as jnp.round) clipped to -128..127, qerr = qe - q.
//
// Outputs: orders (V,) int32, coefficients (V, M) int32 left-aligned (zero
// past the order), shifts (V,) int32.
//
// Bit equality with the plain version (lpc_f32.py lpc_analyze_f32_plain) on
// the card: every multiply and add is an _rn intrinsic (never contracted
// into a fused multiply-add; the library is built with -fmad=false too),
// division and square root are the IEEE-rounded ones of the default flags,
// logf/frexpf/rintf are the CUDA math library's, as torch's CUDA ops call
// them, and no literal is a double.
//
// What bounds it on an H100: one read of the lags and one write of the
// coefficients (1.3 MB and 1.3 MB at the main path's V 5164, M 64), under a
// microsecond at 3.35 TB/s; the arithmetic is about 2 M^2 f32 multiplies
// and adds a row for the recursion (about 8k at M 64, 43 M in all) and
// M lengths of two logarithms each, a few microseconds at the f32 rate.
// Each row is a serial chain, though: gamma's sum is a dependent chain of
// k+1 adds at step k, so a row takes about M^2 / 2 dependent f32 adds
// (about 2k at M 64), each behind a shared-memory load.
//
// Design (simple first): one thread a row, 32 rows a CTA (a warp), the
// row's a[], its lags and its best coefficients so far in shared memory at
// a stride of 32 words, so the 32 threads' accesses to the same index fall
// on 32 banks. One pass: the running error variance and the running argmin
// (no ev array), each new best order's a[1..order] copied aside (the
// second recursion's result, bit for bit, without running it again). Rows
// share nothing. A row is a serial chain, so the kernel's time is one
// row's chain however many rows run beside it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr float kSilent = 1.1920928955078125e-07f;   // 2^-23
constexpr float kInvLogE2 = 1.4426950408889634f;

__device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
}

// max(x, lo) that keeps a NaN x, as jnp.maximum and torch.clamp_min do.
__device__ __forceinline__ float max_keep_nan(float x, float lo) {
    return x < lo ? lo : x;
}

struct Row {
    float* a;       // a[i] at a[i * kThreads]
    const float* ac;
    __device__ float& A(int i) const { return a[i * kThreads]; }
    __device__ float L(int i) const { return ac[i * kThreads]; }
};

// a[0..1] and ev[1] of the recursion.
__device__ __forceinline__ float start(const Row& w, float safe_r0) {
    w.A(0) = 1.0f;
    w.A(1) = __fdiv_rn(-w.L(1), safe_r0);
    return add(w.L(0), mul(w.L(1), w.A(1)));
}

// Step k of the recursion: a[0..k+2] updated in place, ev[k+2] returned.
__device__ __forceinline__ float step(const Row& w, int k, float ev) {
    float g = mul(w.A(0), w.L(k + 2));
    for (int i = 1; i <= k + 1; ++i) g = add(g, mul(w.A(i), w.L(k + 2 - i)));
    const float den = fabsf(ev) < 1e-30f ? 1.0f : ev;
    g = __fdiv_rn(g, -den);
    const float ev_next = mul(ev, sub(1.0f, mul(g, g)));
    w.A(k + 2) = 0.0f;
    for (int i = 0, j = k + 2; i <= j; ++i, --j) {
        const float x = w.A(i), y = w.A(j);
        w.A(i) = add(x, mul(g, y));
        if (i != j) w.A(j) = add(y, mul(g, x));
    }
    return ev_next;
}

// The estimated code length of order o with error variance e
// (_select_order: ent * n + 8 * o), NaN mapped to -inf.
__device__ __forceinline__ float length(float e, int o, float n_f, float winv,
                                        float intscale, float coef_bits) {
    const float mabse = mul(2.0f, __fsqrt_rn(
        __fdiv_rn(max_keep_nan(mul(e, winv), 0.0f), 2.0f)));
    const float intmean = mul(mabse, intscale);
    const float rho = __fdiv_rn(1.0f, add(1.0f, intmean));
    const float invrho = max_keep_nan(sub(1.0f, rho), 1e-30f);
    float ent = __fdiv_rn(
        mul(-add(mul(invrho, logf(invrho)), mul(rho, logf(rho))), kInvLogE2),
        rho);
    if (mabse < 1e-16f) ent = 0.0f;
    const float len = add(mul(ent, n_f), mul(coef_bits, (float)o));
    return len != len ? -INFINITY : len;
}

__global__ void __launch_bounds__(kThreads)
lpc_f32_kernel(const float* __restrict__ ac, int32_t* __restrict__ orders_out,
               int32_t* __restrict__ coefs_out,
               int32_t* __restrict__ shifts_out, int V, int M, float n_f,
               float winv, float intscale, float coef_bits, int nbits,
               int max_bits, int max_fixed) {
    extern __shared__ float sm[];
    const int t = threadIdx.x;
    const int r = blockIdx.x * kThreads + t;
    if (r >= V) return;              // no barrier below: rows share nothing
    Row w{sm + t, sm + (M + 2) * kThreads + t};
    float* lag = sm + (M + 2) * kThreads + t;
    float* best_a = sm + (2 * M + 3) * kThreads + t;   // a[1..order]
    const float* src = ac + (size_t)r * (M + 1);
    for (int i = 0; i <= M; ++i) lag[i * kThreads] = src[i];

    const float r0 = w.L(0);
    const bool silent = fabsf(r0) < kSilent;
    const float safe_r0 = fabsf(r0) < 1e-30f ? 1.0f : r0;

    int order = M;
    float ev = start(w, safe_r0);
    if (max_fixed) {
        for (int k = 0; k < M - 1; ++k) ev = step(w, k, ev);
        for (int i = 0; i < M; ++i) best_a[i * kThreads] = w.A(i + 1);
    } else {
        float best = length(silent ? r0 : ev, 1, n_f, winv, intscale,
                            coef_bits);
        order = 1;
        best_a[0] = w.A(1);
        for (int k = 0; k < M - 1; ++k) {
            ev = step(w, k, ev);
            const float len = length(silent ? r0 : ev, k + 2, n_f, winv,
                                     intscale, coef_bits);
            if (len < best) {
                best = len;
                order = k + 2;
                for (int i = 0; i < order; ++i)
                    best_a[i * kThreads] = w.A(i + 1);
            }
        }
    }

    int32_t* crow = coefs_out + (size_t)r * M;
    for (int i = order; i < M; ++i) crow[i] = 0;
    orders_out[r] = order;
    if (silent) {
        // Coefficients 0: the largest magnitude is tiny, the shift nbits.
        for (int i = 0; i < order; ++i) crow[i] = 0;
        shifts_out[r] = nbits;
        return;
    }
    float maxabs = 0.0f;             // a NaN, once met, stays (as jnp.max)
    for (int i = 0; i < order; ++i) {
        const float m = fabsf(best_a[i * kThreads]);
        if (maxabs == maxabs && !(m <= maxabs)) maxabs = m;
    }
    const bool tiny = maxabs <= ldexpf(1.0f, -(nbits - 1));
    int e = 0;
    frexpf(max_keep_nan(maxabs, 1e-38f), &e);
    int rshift = (nbits - 1) - e;
    if (rshift >= max_bits || rshift < 0) rshift = max_bits - 1;
    if (tiny) rshift = nbits;
    const float scale = ldexpf(1.0f, rshift);
    const float qmax = (float)(1 << (nbits - 1));
    float qerr = 0.0f;
    for (int i = order - 1; i >= 0; --i) {
        const float qe = add(qerr, mul(best_a[i * kThreads], scale));
        float qt = rintf(qe);
        qt = qt < -qmax ? -qmax : qt;
        qt = qt > qmax - 1.0f ? qmax - 1.0f : qt;
        qerr = sub(qe, qt);
        crow[i] = tiny || qt != qt ? 0 : (int32_t)qt;
    }
    shifts_out[r] = rshift;
}

}  // namespace

extern "C" int srla_lpc_f32(const void* ac, void* orders, void* coefs,
                            void* shifts, int V, int M, float n_f, float winv,
                            float intscale, float coef_bits, int nbits,
                            int max_bits, int max_fixed, void* stream) {
    if (V <= 0) return 0;
    const size_t smem = (size_t)(3 * M + 3) * kThreads * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            lpc_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int grid = (V + kThreads - 1) / kThreads;
    lpc_f32_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)ac, (int32_t*)orders, (int32_t*)coefs,
        (int32_t*)shifts, V, M, n_f, winv, intscale, coef_bits, nbits,
        max_bits, max_fixed);
    return (int)cudaGetLastError();
}
