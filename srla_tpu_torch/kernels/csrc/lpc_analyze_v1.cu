// K7's first design, kept as a measurement aid for
// chip_smoke.py, which times it beside the current lpc_analyze.cu. Nothing in
// the port calls it; its entry is srla_lpc_analyze_v1. The text below is the
// first design's own.
//
// K7: the encode's LPC analysis of each row, from its lags to its integer
// coefficients, in one launch.
//
// Replaces the XLA programs srla_tpu/kernels/exact.py:_levinson_dd (fori
// :229, body :195), _select_order_exact (:260, fori :317), the second
// _levinson_dd at the chosen orders and _quantize_exact (:330, fori :394),
// each decision with its margin flag. Its plain version, the arithmetic it
// must equal, is kernels/levinson.py:lpc_analyze_plain. Per row:
//
//   1. the Levinson-Durbin recursion to order M (<= 255) on the lags (the
//      ridge already on lag 0): the error variances, the silent test, kappa
//      = r0 / min |ev| and the non-finite flag;
//   2. the code-length argmin over orders 1..M of the window-corrected
//      error variances (the first strict minimum wins, as argmin) with its
//      tie flag;
//   3. a second recursion that stops at the chosen order, replaying the
//      first one's reflection coefficients, and keeps its coefficients;
//   4. the backward error-feedback quantization with its frexp, tiny and
//      rounding flags.
//
// f64 throughout, every operation written as the plain version writes it
// and rounded as a torch op rounds it: __dmul_rn, __dadd_rn, __dsub_rn,
// __ddiv_rn and __dsqrt_rn, so no multiply-add is contracted and the build
// keeps nvcc's default flags (log() is then the same libdevice function as
// torch's). The one intended difference is the order of gamma's sum: each
// lane sums the terms j = lane, lane + 32, ... in order, then an
// xor-butterfly tree combines the 32 lanes; kernels/levinson.py (above
// _EPS_SILENT) shows that the margins cover any order.
//
// What bounds it on an H100: nothing the card is rated by. The bytes are
// the (V, M + 1) lags in and (V, M) coefficients out, 4 MB at the main
// path's 5164 rows x 65 lags (0.001 ms), the f64 operations ~V (2 M^2 +
// 30 M) (0.002 ms). Each row is a chain of M - 1 dependent steps (a sum
// over the row's coefficients, a division, the update), so the kernel is
// latency-bound: its floor is the first recursion's M - 1 steps of a
// warp's f64 reduction plus a division (csrc/chain_probe.cu times that
// step: 0.010 ms at M 64 on an H100 80GB HBM3 at 700 W).
//
// Design: a warp per row, four rows a CTA. The lags, the coefficients, the
// error variances, the reflection coefficients and the code lengths sit in
// shared memory (5 M + 4 doubles a row, 10 KB at M 255); gamma is a
// warp-shuffle reduction in a fixed order; the update gives each lane the
// pairs (j, m - j), so it needs no second buffer; every lane computes the
// row's scalars, so nothing diverges; the quantization is a serial loop
// that every lane runs, and lane o mod 32 stores coefficient o.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;
// The plain version's constants (kernels/levinson.py, rice.py).
constexpr double kFltEpsilon = 1.1920928955078125e-07;
constexpr double kEpsSilent = 1e-6 * kFltEpsilon;    // _EPS_SILENT * FLT_EPS
constexpr double kEpsOrderBase = 1e-6;               // _EPS_ORDER_BASE
constexpr double kEpsQuantBase = 1e-7;               // _EPS_QUANT_BASE
constexpr double kKappaScale = 1.0 / 1099511627776.0;  // 2^-40
constexpr double kInvLoge2 = 1.4426950408889634;     // _INV_LOGE2
constexpr double kFrexpTop = 1.0 - 1e-7;

__device__ __forceinline__ double warp_sum(double s) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
        s = __dadd_rn(s, __shfl_xor_sync(kFull, s, off));
    return s;
}

__device__ __forceinline__ double warp_min(double v) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
        v = fmin(v, __shfl_xor_sync(kFull, v, off));
    return v;
}

// torch.max: a NaN wins.
__device__ __forceinline__ double nan_max(double a, double b) {
    return a != a ? a : (b != b ? b : (b > a ? b : a));
}

// a <- a + g * flip(a[0..m]): lane-owned pairs (j, m - j), j <= m / 2.
__device__ __forceinline__ void update(double* a, int m, double g,
                                       int lane) {
    for (int j = lane; 2 * j <= m; j += 32) {
        const double aj = a[j];
        const double am = a[m - j];
        a[j] = __dadd_rn(aj, __dmul_rn(g, am));
        if (m - j != j) a[m - j] = __dadd_rn(am, __dmul_rn(g, aj));
    }
}

__device__ __forceinline__ void reset(double* a, double a1, int M,
                                      int lane) {
    for (int j = lane; j < M + 2; j += 32)
        a[j] = j == 0 ? 1.0 : (j == 1 ? a1 : 0.0);
    __syncwarp();
}

__global__ void __launch_bounds__(kWarps * 32)
lpc_analyze_kernel(const double* __restrict__ lags,
                   int32_t* __restrict__ orders_out,
                   int32_t* __restrict__ rshifts_out,
                   int32_t* __restrict__ intc_out,
                   uint8_t* __restrict__ risky_out, int V, int n, int bps,
                   int M, int max_fixed, int nbits, int max_bits,
                   double wiss) {
    extern __shared__ double smem[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarps + warp;
    if (row >= V) return;                 // whole warps leave together
    double* ac = smem + warp * (5 * M + 4);
    double* a = ac + (M + 1);
    double* ev = a + (M + 2);
    double* gam = ev + (M + 1);
    double* len = gam + M;
    const double* src = lags + (size_t)row * (M + 1);
    for (int j = lane; j <= M; j += 32) ac[j] = src[j];
    __syncwarp();

    // 1. Levinson to M (levinson.py:levinson).
    const double r0 = ac[0];
    const double a1 = __ddiv_rn(-ac[1], r0 == 0.0 ? 1.0 : r0);
    double evk = __dadd_rn(r0, __dmul_rn(ac[1], a1));
    reset(a, a1, M, lane);
    if (lane == 0) {
        ev[0] = r0;
        ev[1] = evk;
    }
    __syncwarp();
    for (int k = 0; k + 1 < M; ++k) {
        const int m = k + 2;
        double s = 0.0;
        for (int j = lane; j < m; j += 32)
            s = __dadd_rn(s, __dmul_rn(a[j], ac[m - j]));
        const double g = __ddiv_rn(warp_sum(s), -(evk == 0.0 ? 1.0 : evk));
        evk = __dmul_rn(evk, __dsub_rn(1.0, __dmul_rn(g, g)));
        __syncwarp();                      // every lane has read a
        update(a, m, g, lane);
        if (lane == 0) {
            ev[m] = evk;
            gam[k] = g;
        }
        __syncwarp();
    }
    const double absr0 = fabs(r0);
    const bool silent = absr0 < kFltEpsilon;
    bool risky = fabs(__dsub_rn(absr0, kFltEpsilon)) < kEpsSilent;
    double min_ev = CUDART_INF;
    bool nonfinite = false;
    for (int j = lane; j <= M; j += 32) {
        const double e = silent ? r0 : ev[j];
        const double ea = fabs(e);
        min_ev = fmin(min_ev, ea > 0.0 ? ea : CUDART_INF);
        nonfinite |= !isfinite(e);
    }
    min_ev = warp_min(min_ev);
    nonfinite = __any_sync(kFull, nonfinite);
    const bool ok = isfinite(min_ev) && min_ev > 0.0;
    double kappa = silent ? 1.0 : __ddiv_rn(absr0, ok ? min_ev : 1.0);
    if (!(isfinite(kappa) && kappa >= 1.0)) kappa = CUDART_INF;
    risky |= nonfinite && !silent;

    // 2. The order (levinson.py:select_order_exact).
    int order = M;
    if (!max_fixed) {
        const double intscale = (double)(1 << (bps - 1));
        double best = CUDART_INF;
        int bi = 0x7fffffff;
        bool near = false;
        for (int o = lane; o < M; o += 32) {
            const double e = __dmul_rn(silent ? r0 : ev[o + 1], wiss);
            const bool neg = e < 0.0;
            const double mabse = __dmul_rn(
                2.0, __dsqrt_rn(__dmul_rn(neg ? 0.0 : e, 0.5)));
            const double rho = __ddiv_rn(
                1.0, __dadd_rn(1.0, __dmul_rn(mabse, intscale)));
            const double invrho = __dsub_rn(1.0, rho);
            const double t1 = __dmul_rn(
                invrho, __dmul_rn(log(invrho <= 0.0 ? 0.5 : invrho),
                                  kInvLoge2));
            const double t2 = __dmul_rn(
                rho, __dmul_rn(log(rho <= 0.0 ? 0.5 : rho), kInvLoge2));
            const double ent = mabse < 1e-16
                ? 0.0 : __ddiv_rn(-__dadd_rn(t1, t2), rho);
            double length = __dadd_rn(__dmul_rn(ent, (double)n),
                                      (double)(nbits * (o + 1)));
            near |= !neg && fabs(__dsub_rn(mabse, 1e-16)) < 1e-17;
            if (neg || !isfinite(length)) length = CUDART_INF;
            len[o] = length;
            if (bi == 0x7fffffff || length < best) {
                best = length;
                bi = o;
            }
        }
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const double ob = __shfl_xor_sync(kFull, best, off);
            const int oi = __shfl_xor_sync(kFull, bi, off);
            if (ob < best || (ob == best && oi < bi)) {
                best = ob;
                bi = oi;
            }
        }
        __syncwarp();                      // len is written
        double second = CUDART_INF;
        for (int o = lane; o < M; o += 32)
            if (o != bi) second = fmin(second, len[o]);
        const double gap = __dsub_rn(warp_min(second), best);
        const double eps = fmax(
            __dmul_rn(__dmul_rn((double)n, kappa), kKappaScale),
            kEpsOrderBase);
        risky |= __any_sync(kFull, near) || !isfinite(best)
            || (isfinite(gap) && gap < eps);
        order = bi + 1;
    }

    // 3. The coefficients at the chosen order: the first recursion's
    //    updates replayed (levinson(ac, M, orders)).
    reset(a, a1, M, lane);
    for (int k = 0; k + 2 <= order; ++k) {
        update(a, k + 2, gam[k], lane);
        __syncwarp();
    }

    // 4. Quantization (levinson.py:quantize_exact).
    double maxabs = 0.0;
    for (int j = lane; j < order; j += 32)
        maxabs = nan_max(maxabs, silent ? 0.0 : fabs(a[j + 1]));
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
        maxabs = nan_max(maxabs, __shfl_xor_sync(kFull, maxabs, off));
    const double qmax = (double)(1 << (nbits - 1));
    const double eps_k = fmax(
        __dmul_rn(__dmul_rn(2.0 * qmax, kappa), kKappaScale), kEpsQuantBase);
    const double tiny_thresh = ldexp(1.0, -(nbits - 1));
    const bool tiny = maxabs <= tiny_thresh;
    risky |= fabs(__dsub_rn(maxabs, tiny_thresh))
        < __dmul_rn(tiny_thresh, 1e-6);
    int e2 = 0;
    const double mant = frexp(maxabs, &e2);
    risky |= !tiny && (fabs(__dsub_rn(mant, 0.5)) < 1e-7
                       || mant > kFrexpTop);
    int rshift = (nbits - 1) - (maxabs == 0.0 ? 0 : e2);
    if (rshift >= max_bits || rshift < 0) rshift = max_bits - 1;
    if (tiny) rshift = nbits;
    const double scale = ldexp(1.0, rshift);
    int32_t* intc = intc_out + (size_t)row * M;
    double qerr = 0.0;
    for (int o = order - 1; o >= 0; --o) {
        const double qe = __dadd_rn(qerr, __dmul_rn(silent ? 0.0 : a[o + 1],
                                                    scale));
        const double ax = fabs(qe);
        const double r = floor(__dadd_rn(ax, 0.5));
        double qt = qe < 0.0 ? -r : r;
        qt = qt < -qmax ? -qmax : (qt > qmax - 1.0 ? qmax - 1.0 : qt);
        risky |= fabs(__dsub_rn(__dsub_rn(ax, floor(ax)), 0.5)) < eps_k;
        qerr = __dsub_rn(qe, qt);
        if (lane == (o & 31)) intc[o] = tiny ? 0 : (int32_t)qt;
    }
    for (int o = order + lane; o < M; o += 32) intc[o] = 0;
    risky |= !isfinite(maxabs);
    if (lane == 0) {
        orders_out[row] = order;
        rshifts_out[row] = rshift;
        risky_out[row] = risky ? 1 : 0;
    }
}

}  // namespace

// lags (V, M + 1) f64 with the ridge on lag 0, 1 <= M <= 255; orders,
// rshifts (V,) int32, intc (V, M) int32, risky (V,) bool; wiss the Welch
// window's inverse squared sum for n.
extern "C" int srla_lpc_analyze_v1(const void* lags, void* orders,
                                void* rshifts, void* intc, void* risky,
                                int V, int n, int bps, int M, int max_fixed,
                                int nbits, int max_bits, double wiss,
                                void* stream) {
    if (M < 1 || M > 255 || bps < 1 || bps > 31 || nbits < 1 || nbits > 31)
        return (int)cudaErrorInvalidValue;
    const size_t bytes = sizeof(double) * (size_t)kWarps * (5 * M + 4);
    const int blocks = (V + kWarps - 1) / kWarps;
    lpc_analyze_kernel<<<blocks, kWarps * 32, bytes, (cudaStream_t)stream>>>(
        (const double*)lags, (int32_t*)orders, (int32_t*)rshifts,
        (int32_t*)intc, (uint8_t*)risky, V, n, bps, M, max_fixed, nbits,
        max_bits, wiss);
    return (int)cudaGetLastError();
}
