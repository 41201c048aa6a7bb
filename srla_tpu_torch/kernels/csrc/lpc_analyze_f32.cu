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
//        gamma  = sum_{m=1..k+2} a[k+2-m] ac[m]   (the order below)
//        gamma /= -ev[k+1]                    (ev taken as 1 below 1e-30)
//        ev[k+2] = ev[k+1] (1 - gamma^2)
//        a[i] += gamma a[k+2-i]                for i <= k+2;
//      JAX sums gamma over all M+2 columns in XLA's order, whose terms past
//      k+1 are exact zero products;
//   2. the order: argmin over o = 1..M of ent(ev[o]) n + 8 o (the first
//      minimum; a NaN length counts as -inf, as the plain version's argmin
//      sees it), ent the Laplace entropy of the error variance with the
//      Welch window's correction; every ev taken as r0 on a silent row
//      (|r0| < 2^-23); the order is M at max_fixed;
//   3. the coefficients a[1..order] at that order (zero on a silent row;
//      JAX runs the recursion again to collect them, this kernel keeps
//      them from its one recursion: Design below), quantized to 8 bits: the shift from frexp of the largest
//      magnitude (15 past the 16-bit field, 8 for a magnitude <= 2^-7,
//      whose coefficients are all 0), then from the last coefficient to
//      the first qe = qerr + c scale, q = rint(qe) (half to even, as
//      jnp.round) clipped to -128..127, qerr = qe - q.
//
// gamma's sum order (the contract with lpc_f32.py levinson_f32): a row's L
// lanes (L = 8, 16 or 32, lanes_for(M) in lpc_f32.py) hold index m at lane
// m mod L, register m / L. Lane l adds its terms m = l, l + L, l + 2L, ...
// in ascending m, those in 1..k+2 only, to a sum that starts at +0; then an
// xor butterfly over the row's lanes, the partner L/2 lanes away first,
// then L/4, ..., 1 (s += partner's s: IEEE addition is commutative, so
// every lane ends with the same value).
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
// Each row is a serial chain, though: M - 1 steps, each a sum that needs
// the step before's coefficients, then a division whose result the next
// step's update needs.
//
// Design. L lanes a row, 32 / L rows a warp, four warps a CTA. The row's
// lags, its a[] and its reversal b[m] = a[k+2-m] live in registers, R =
// ceil((M+1) / L) <= 9 of each a lane: a step is R products and predicated
// adds in the lane, log2(L) shuffles and adds of the butterfly, the
// division, then a[] += g b[] and c[] = b[] + g a[] in the lane, and b[]
// for the next step is c[] moved up one index (one shuffle a register from
// the lane below; lane 0 takes lane L-1's register below). No shared
// memory and no length on the chain, and one recursion (JAX runs a second
// one to collect the coefficients):
//   - the orders go by in batches of 8: each order's a[] and ev stay in a
//     ring of registers (the loop unrolled by 8, so every index is
//     static), then 8 of the row's lanes compute the batch's lengths, one
//     each, a butterfly on (length, order) takes the batch's first
//     minimum, and where it beats the best so far a select copies its a[]
//     out of the ring; at max_fixed the recursion runs to M alone;
//   - the largest magnitude by a butterfly, then the quantization's error
//     chain over the coefficients staged in shared memory, run by the
//     row's lanes alike; one lane writes each value, the row's
//     coefficients then stored coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRing = 8;             // orders a batch of lengths
constexpr unsigned kFull = 0xffffffffu;
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

// One row's recursion state in its lanes: index m = l + L j at lane l,
// register j.
template <int L, int R>
struct Chain {
    float lag[R];
    float a[R];
    float b[R];          // b[m] = a[k+2-m] at the start of step k
    float ev;

    // a[0..1], b for step 0 and ev[1].
    __device__ __forceinline__ void start(int l, float a1, float r0,
                                          float ac1) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
            const int m = l + L * j;
            a[j] = m == 0 ? 1.0f : (m == 1 ? a1 : 0.0f);
            b[j] = m == 1 ? a1 : (m == 2 ? 1.0f : 0.0f);
        }
        ev = add(r0, mul(ac1, a1));
    }

    // Step k: a[] and ev from order k+1 to order k+2.
    __device__ __forceinline__ void step(int l, int k) {
        const int kp2 = k + 2;
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < R; ++j) {
            const int m = l + L * j;
            if (m >= 1 && m <= kp2) s = add(s, mul(b[j], lag[j]));
        }
#pragma unroll
        for (int o = L / 2; o >= 1; o >>= 1)
            s = add(s, __shfl_xor_sync(kFull, s, o, L));
        const float den = fabsf(ev) < 1e-30f ? 1.0f : ev;
        const float g = __fdiv_rn(s, -den);
        ev = mul(ev, sub(1.0f, mul(g, g)));
        float c[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
            const float aj = a[j], bj = b[j];
            a[j] = add(aj, mul(g, bj));
            c[j] = add(bj, mul(g, aj));
        }
        const int below = (l + L - 1) & (L - 1);
        float up[R];
#pragma unroll
        for (int j = 0; j < R; ++j) up[j] = __shfl_sync(kFull, c[j], below, L);
#pragma unroll
        for (int j = 0; j < R; ++j)
            b[j] = l == 0 ? (j == 0 ? 0.0f : up[j - 1]) : up[j];
    }
};

// The first least (length, order) over the row's lanes.
template <int L>
__device__ __forceinline__ void argmin_lanes(float& len, int& o) {
#pragma unroll
    for (int w = L / 2; w >= 1; w >>= 1) {
        const float ol = __shfl_xor_sync(kFull, len, w, L);
        const int oo = __shfl_xor_sync(kFull, o, w, L);
        if (ol < len || (ol == len && oo < o)) {
            len = ol;
            o = oo;
        }
    }
}

template <int L, int R>
__global__ void __launch_bounds__(kThreads)
lpc_f32_kernel(const float* __restrict__ ac, int32_t* __restrict__ orders_out,
               int32_t* __restrict__ coefs_out,
               int32_t* __restrict__ shifts_out, int V, int M, float n_f,
               float winv, float intscale, float coef_bits, int nbits,
               int max_bits, int max_fixed) {
    constexpr int kRowsWarp = 32 / L;
    constexpr int kRowsCta = kRowsWarp * kWarps;
    extern __shared__ float sm[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int l = lane & (L - 1);
    const int slot = warp * kRowsWarp + lane / L;       // the CTA's row
    const int warp_row = blockIdx.x * kRowsCta + warp * kRowsWarp;
    if (warp_row >= V) return;       // warp-uniform: no CTA barrier below
    const int r = blockIdx.x * kRowsCta + slot;
    const bool real = r < V;
    float* cq = sm + slot * (2 * M);            // a[1..order], staged
    int32_t* qs = reinterpret_cast<int32_t*>(cq + M);   // their values

    Chain<L, R> w;
    const float* src = ac + (size_t)(real ? r : 0) * (M + 1);
#pragma unroll
    for (int j = 0; j < R; ++j) {
        const int m = l + L * j;
        w.lag[j] = real && m <= M ? src[m] : 0.0f;
    }
    const float r0 = __shfl_sync(kFull, w.lag[0], 0, L);
    const float ac1 = __shfl_sync(kFull, w.lag[0], 1, L);
    const bool silent = fabsf(r0) < kSilent;
    const float safe_r0 = fabsf(r0) < 1e-30f ? 1.0f : r0;
    w.start(l, __fdiv_rn(-ac1, safe_r0), r0, ac1);

    int order = M;
    float best_a[R];
    if (max_fixed) {
        for (int k = 0; k < M - 1; ++k) w.step(l, k);
#pragma unroll
        for (int j = 0; j < R; ++j) best_a[j] = w.a[j];
    } else {
        // Orders in batches of kRing: each order's a[] and ev kept in
        // registers (slot i: order base + i), then the batch's lengths a
        // lane each and their first minimum against the best so far, whose
        // a[] a select copies out of the ring.
        float best = INFINITY;
#pragma unroll
        for (int j = 0; j < R; ++j) best_a[j] = 0.0f;
        for (int base = 1; base <= M; base += kRing) {
            float ring[kRing][R];
            float rev[kRing];
#pragma unroll
            for (int i = 0; i < kRing; ++i) {
                const int o = base + i;
#pragma unroll
                for (int j = 0; j < R; ++j) ring[i][j] = w.a[j];
                rev[i] = w.ev;
                if (o < M) w.step(l, o - 1);    // M is the warp's: uniform
            }
            float e = rev[0];
#pragma unroll
            for (int i = 1; i < kRing; ++i) e = l == i ? rev[i] : e;
            const int o = base + l;
            float len = INFINITY;
            int bo = 0x7fffffff;
            if (l < kRing && o <= M) {
                len = length(silent ? r0 : e, o, n_f, winv, intscale,
                             coef_bits);
                bo = o;
            }
            argmin_lanes<L>(len, bo);
            if (base == 1 || len < best) {
                best = len;
                order = bo;
#pragma unroll
                for (int i = 0; i < kRing; ++i) {
#pragma unroll
                    for (int j = 0; j < R; ++j) {
                        if (bo == base + i) best_a[j] = ring[i][j];
                    }
                }
            }
        }
    }

    // The coefficients a[1..order] (zero on a silent row), staged.
    float maxabs = 0.0f;             // a NaN, once met, stays (as amax)
#pragma unroll
    for (int j = 0; j < R; ++j) {
        const int m = l + L * j;
        if (m >= 1 && m <= order) {
            const float c = silent ? 0.0f : best_a[j];
            cq[m - 1] = c;
            const float x = fabsf(c);
            if (maxabs == maxabs && !(x <= maxabs)) maxabs = x;
        }
    }
#pragma unroll
    for (int o = L / 2; o >= 1; o >>= 1) {
        const float x = __shfl_xor_sync(kFull, maxabs, o, L);
        if (maxabs == maxabs && !(x <= maxabs)) maxabs = x;
    }
    __syncwarp();
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
        const float qe = add(qerr, mul(cq[i], scale));
        float qt = rintf(qe);
        qt = qt < -qmax ? -qmax : qt;
        qt = qt > qmax - 1.0f ? qmax - 1.0f : qt;
        qerr = sub(qe, qt);
        if (l == 0) qs[i] = tiny || qt != qt ? 0 : (int32_t)qt;
    }
    __syncwarp();
    if (real) {
        int32_t* crow = coefs_out + (size_t)r * M;
        for (int i = l; i < M; i += L) crow[i] = i < order ? qs[i] : 0;
        if (l == 0) {
            orders_out[r] = order;
            shifts_out[r] = rshift;
        }
    }
}

template <int L, int R>
int launch(const float* ac, int32_t* orders, int32_t* coefs, int32_t* shifts,
           int V, int M, float n_f, float winv, float intscale,
           float coef_bits, int nbits, int max_bits, int max_fixed,
           cudaStream_t stream) {
    constexpr int kRowsCta = 32 / L * kWarps;
    const size_t smem = (size_t)kRowsCta * 2 * M * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            lpc_f32_kernel<L, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int grid = (V + kRowsCta - 1) / kRowsCta;
    lpc_f32_kernel<L, R><<<grid, kThreads, smem, stream>>>(
        ac, orders, coefs, shifts, V, M, n_f, winv, intscale, coef_bits,
        nbits, max_bits, max_fixed);
    return (int)cudaGetLastError();
}

}  // namespace

// The row's lanes L, the fewest of 8, 16 and 32 that hold its M+1
// coefficients in at most 9 registers a lane (lpc_f32.py lanes_for, whose
// gamma_sum follows the same L), and R = ceil((M+1) / L): only the (L, R)
// pairs that rule reaches are built, M + 1 <= 288.
extern "C" int srla_lpc_f32(const void* ac, void* orders, void* coefs,
                            void* shifts, int V, int M, float n_f,
                            float winv, float intscale, float coef_bits,
                            int nbits, int max_bits, int max_fixed,
                            void* stream) {
    if (V <= 0) return 0;
    if (M < 1 || M + 1 > 9 * 32) return (int)cudaErrorInvalidValue;
    const int L = M + 1 <= 9 * 8 ? 8 : M + 1 <= 9 * 16 ? 16 : 32;
    const int R = (M + L) / L;
    const float* a = (const float*)ac;
    int32_t* o = (int32_t*)orders;
    int32_t* c = (int32_t*)coefs;
    int32_t* s = (int32_t*)shifts;
    cudaStream_t st = (cudaStream_t)stream;
#define SRLA_K14(LL, RR)                                                    \
    if (L == LL && R == RR)                                                 \
        return launch<LL, RR>(a, o, c, s, V, M, n_f, winv, intscale,        \
                              coef_bits, nbits, max_bits, max_fixed, st);
    SRLA_K14(8, 1) SRLA_K14(8, 2) SRLA_K14(8, 3) SRLA_K14(8, 4)
    SRLA_K14(8, 5) SRLA_K14(8, 6) SRLA_K14(8, 7) SRLA_K14(8, 8)
    SRLA_K14(8, 9)
    SRLA_K14(16, 5) SRLA_K14(16, 6) SRLA_K14(16, 7) SRLA_K14(16, 8)
    SRLA_K14(16, 9)
    SRLA_K14(32, 5) SRLA_K14(32, 6) SRLA_K14(32, 7) SRLA_K14(32, 8)
    SRLA_K14(32, 9)
#undef SRLA_K14
    return (int)cudaErrorInvalidValue;
}
