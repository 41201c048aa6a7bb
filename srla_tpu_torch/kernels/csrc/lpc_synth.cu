// K1: batched LPC synthesis recurrence with optional fused de-emphasis.
//
// Replaces the Pallas TPU kernel srla_tpu/kernels/pallas_lpc.py
// (lpc_scan_pallas -> _lpc_scan_pallas_T -> _make_kernel) and computes what
// srla_tpu/kernels/decode2.py:_lpc_scan computes, per row r:
//
//   y[s] = x[s]                                 s == 0 or order == 0
//          x[s] + y[s-1]                        0 < s < order (warm-up)
//          x[s] - ((sum_j win[j]*al[j] + half) >> rshift)   otherwise
//   fused: out[s] = y[s] + ((out[s-1] * dcoef) >> 4), out[-1] = dprev
//
// win[j] = y[s-M+j] (zero before the row starts); al is the row's
// coefficient vector right-aligned in M columns; half = 1 << (rshift-1), or
// INT_MIN when rshift == 0 (the reference's x86 shift-count masking).
// All sums wrap mod 2^32: they are done in uint32_t (signed overflow is
// undefined in C++) and only the two shifts reinterpret as int32 so that
// they stay arithmetic.
//
// What bounds it on an H100: the recurrence is serial in s. y[s] waits on
// y[s-1] through a multiply-add, the sum over the taps, a shift and a
// subtraction; the bytes (x in, y out) and the multiply-adds are small
// beside that chain. chip_smoke.py reports the serial floor: n times the
// shortest such step, measured alone (csrc/chain_probe.cu). The first port
// ran one thread per row: 2.6k rows filled 81 warps on 132 SMs, and each
// sample walked an order-long loop of shared-memory loads.
//
// Design: one warp per row, a CTA each (2,584 warps at the main path, ~20
// per SM, all resident; one warp a CTA measured faster than four). Lane l holds the taps of lags l+1,
// l+33, ... (T per lane; T = 1, 2, 4 or 8 by M <= 256) and the matching
// window values y[s-1-l-32t], in registers. A sample step is T multiply-
// adds per lane, one __reduce_add_sync (a single REDUX, which wraps mod
// 2^32 like the uint32_t sum), and the add, shift and subtract that every
// lane computes alike. The window moves one lag with a rotating __shfl_sync
// per tap group; those shuffles read the previous window, so only lane 0's
// insert of y[s] waits on the step. All T groups are summed and moved, also
// those past the row's order (their taps are 0): a branch on the order
// wrapped every shuffle and reduction in convergence code and cost more
// than the work it skipped. Residuals arrive 32 at a time in one coalesced
// load, a chunk ahead, and are read back four at a time from a per-warp
// shared-memory stage (one 16-byte broadcast load per four steps); outputs
// are gathered one per lane over 32 steps and leave in one coalesced
// 128-byte store. Chunks past the warm-up (s >= order) skip its test;
// order-0 rows (the LTP path's de-emphasis calls K1 with M = 1) run only
// the residual broadcast and the de-emphasis chain.
//
// No tensor cores: the dot product is wrapping int32 x int32 fed back one
// sample at a time, and wgmma has no int32 x int32 path (its integer forms
// take 8-bit inputs).
//
// Two entries, one kernel. srla_lpc_synth takes the coefficients right-
// aligned in M columns (srla_tpu's _align_coefs done first, as JAX's
// _lpc_scan takes them). srla_lpc_synth_coefs aligns them as it loads
// its taps, from the parsed coefficients where they lie (the decode's
// packed parameters, srla_tpu/kernels/decode2.py:513): row r = b * C + c
// reads coefs[b * bstride + c * cstride + k], left-aligned (k = 0 the
// first coefficient), and lane l's tap of lag L is
//   L <= min(order, M) ? coefs[.. + min(order - L, M - 1)] : 0,
// which is _align_coefs' column M - L (its gather clips at M - 1). The
// taps are loaded once a row, before the recurrence, which is the same
// code for both entries.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 1;                 // rows (warps) per CTA
constexpr int kMaxTaps = 256;             // 8 taps per lane
constexpr unsigned kFull = 0xffffffffu;

// Order 0; the chunk may hold s < order; every s >= order.
enum Mode { kPass, kWarmup, kSteady };

// Where a row's coefficients lie: right-aligned in M columns (aligned),
// or left-aligned at coefs + b * bstride + c * cstride for row b * C + c
// (aligned null).
struct Taps {
    const int32_t* aligned;
    const int32_t* coefs;
    long long bstride, cstride;
    int C;
};

template <int T, bool FUSE>
__global__ void __launch_bounds__(kWarps * 32)
lpc_synth_kernel(const int32_t* __restrict__ res, const Taps taps,
                 const int32_t* __restrict__ orders,
                 const int32_t* __restrict__ rshifts,
                 const int32_t* __restrict__ dcoef,
                 const int32_t* __restrict__ dprev,
                 int32_t* __restrict__ out, int R, int n, int M) {
    __shared__ uint4 xstage[kWarps][8];         // one 32-sample chunk a warp
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long row = (long long)blockIdx.x * kWarps + warp;
    if (row >= R) return;                       // the whole warp leaves
    const int order = orders[row];
    const int rsh = rshifts[row];
    const uint32_t half = rsh > 0 ? (1u << (rsh - 1)) : 0x80000000u;
    uint32_t c[T], w[T];
    if (taps.aligned != nullptr) {
#pragma unroll
        for (int t = 0; t < T; ++t) {
            const int lag = lane + 1 + 32 * t;
            c[t] = lag <= M ? (uint32_t)taps.aligned[row * M + (M - lag)]
                            : 0u;
        }
    } else {
        const int r = (int)row;
        const int32_t* cr = taps.coefs + (long long)(r / taps.C)
            * taps.bstride + (long long)(r % taps.C) * taps.cstride;
#pragma unroll
        for (int t = 0; t < T; ++t) {
            const int lag = lane + 1 + 32 * t;
            const int k = order - lag < M - 1 ? order - lag : M - 1;
            c[t] = lag <= M && lag <= order ? (uint32_t)cr[k] : 0u;
        }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) w[t] = 0u;
    const uint32_t lane_half = lane == 0 ? half : 0u;   // added once
    const uint32_t dc = FUSE ? (uint32_t)dcoef[row] : 0u;
    uint32_t z = FUSE ? (uint32_t)dprev[row] : 0u;
    uint32_t last = 0u;                 // y[s-1], the same in every lane
    const int32_t* x = res + row * n;
    int32_t* y = out + row * n;
    uint32_t* stage = reinterpret_cast<uint32_t*>(xstage[warp]);

    // One sample: every lane ends with the same y[s] (and z).
    auto step = [&](auto mode, uint32_t xs, int s) -> uint32_t {
        constexpr int kMode = decltype(mode)::value;
        uint32_t nv;
        if (kMode == kPass) {
            nv = xs;
        } else if (kMode == kSteady || s >= order) {
            uint32_t part = lane_half;
#pragma unroll
            for (int t = T - 1; t >= 1; --t)
                part += c[t] * w[t];
            part += c[0] * w[0];                 // lane 0: y[s-1], last in
            const uint32_t acc = __reduce_add_sync(kFull, part);
            nv = xs - (uint32_t)((int32_t)acc >> rsh);
        } else {
            nv = s == 0 ? xs : xs + last;
        }
        if (kMode != kPass) {
            // Move the window one lag: lane l takes lane l-1's value, lane 0
            // takes lane 31's value of the group before (group 0: y[s]).
            uint32_t rot[T];
#pragma unroll
            for (int t = 0; t < T; ++t)
                rot[t] = __shfl_sync(kFull, w[t], (lane + 31) & 31);
#pragma unroll
            for (int t = T - 1; t >= 1; --t)
                w[t] = lane == 0 ? rot[t - 1] : rot[t];
            w[0] = lane == 0 ? nv : rot[0];
            last = nv;
        }
        if (FUSE) {
            z = nv + (uint32_t)((int32_t)(z * dc) >> 4);
            return z;
        }
        return nv;
    };
    // 32 samples from s0: residuals broadcast from the warp's stage four at
    // a time, outputs gathered one per lane and stored together.
    auto chunk = [&](auto mode, int s0) {
        uint32_t ov = 0u;
#pragma unroll
        for (int j4 = 0; j4 < 32; j4 += 4) {
            const uint4 q = xstage[warp][j4 >> 2];
            const uint32_t xs[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const uint32_t v = step(mode, xs[j], s0 + j4 + j);
                if (lane == j4 + j) ov = v;
            }
        }
        y[s0 + lane] = (int32_t)ov;
    };
    using Pass = std::integral_constant<int, kPass>;
    using Warm = std::integral_constant<int, kWarmup>;
    using Steady = std::integral_constant<int, kSteady>;

    uint32_t xnext = lane < n ? (uint32_t)x[lane] : 0u;
    for (int s0 = 0; s0 < n; s0 += 32) {
        __syncwarp();                            // the last chunk was read
        stage[lane] = xnext;
        __syncwarp();
        if (s0 + 32 + lane < n) xnext = (uint32_t)x[s0 + 32 + lane];
        if (s0 + 32 <= n) {
            if (order <= 0) chunk(Pass{}, s0);
            else if (s0 >= order) chunk(Steady{}, s0);
            else chunk(Warm{}, s0);
        } else {                                 // the row's ragged end
            const int cnt = n - s0;
            uint32_t ov = 0u;
            for (int j = 0; j < cnt; ++j) {
                const uint32_t v = order <= 0 ? step(Pass{}, stage[j], s0 + j)
                                              : step(Warm{}, stage[j], s0 + j);
                if (lane == j) ov = v;
            }
            if (lane < cnt) y[s0 + lane] = (int32_t)ov;
        }
    }
}

template <int T, bool FUSE>
cudaError_t launch(const void* res, const Taps& taps, const void* orders,
                   const void* rshifts, const void* dcoef, const void* dprev,
                   void* out, int R, int n, int M, cudaStream_t stream) {
    const int blocks = (R + kWarps - 1) / kWarps;
    lpc_synth_kernel<T, FUSE><<<blocks, kWarps * 32, 0, stream>>>(
        (const int32_t*)res, taps, (const int32_t*)orders,
        (const int32_t*)rshifts, (const int32_t*)dcoef,
        (const int32_t*)dprev, (int32_t*)out, R, n, M);
    return cudaGetLastError();
}

template <bool FUSE>
cudaError_t dispatch(const void* res, const Taps& taps, const void* orders,
                     const void* rshifts, const void* dcoef,
                     const void* dprev, void* out, int R, int n, int M,
                     cudaStream_t st) {
    if (M <= 32)
        return launch<1, FUSE>(res, taps, orders, rshifts, dcoef, dprev,
                               out, R, n, M, st);
    if (M <= 64)
        return launch<2, FUSE>(res, taps, orders, rshifts, dcoef, dprev,
                               out, R, n, M, st);
    if (M <= 128)
        return launch<4, FUSE>(res, taps, orders, rshifts, dcoef, dprev,
                               out, R, n, M, st);
    return launch<8, FUSE>(res, taps, orders, rshifts, dcoef, dprev, out,
                           R, n, M, st);
}

int run(const void* res, const Taps& taps, const void* orders,
        const void* rshifts, const void* dcoef, const void* dprev, void* out,
        int R, int n, int M, int fuse, void* stream) {
    if (M < 1 || M > kMaxTaps) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    return (int)(fuse ? dispatch<true>(res, taps, orders, rshifts, dcoef,
                                       dprev, out, R, n, M, st)
                      : dispatch<false>(res, taps, orders, rshifts, dcoef,
                                        dprev, out, R, n, M, st));
}

}  // namespace

// res, out: (R, n) int32; aligned: (R, M) int32, 1 <= M <= 256; orders,
// rshifts, dcoef, dprev: (R,) int32 (dcoef/dprev are read only when
// fuse != 0).
extern "C" int srla_lpc_synth(const void* res, const void* aligned,
                              const void* orders, const void* rshifts,
                              const void* dcoef, const void* dprev, void* out,
                              int R, int n, int M, int fuse, void* stream) {
    if (aligned == nullptr) return (int)cudaErrorInvalidValue;
    const Taps taps{(const int32_t*)aligned, nullptr, 0, 0, 1};
    return run(res, taps, orders, rshifts, dcoef, dprev, out, R, n, M, fuse,
               stream);
}

// As srla_lpc_synth, with row r = b * C + c's coefficients left-aligned at
// coefs + b * bstride + c * cstride (int32 elements; at least M of them,
// or the row's order where that is less, are read).
extern "C" int srla_lpc_synth_coefs(const void* res, const void* coefs,
                                    long long bstride, long long cstride,
                                    int C, const void* orders,
                                    const void* rshifts, const void* dcoef,
                                    const void* dprev, void* out, int R,
                                    int n, int M, int fuse, void* stream) {
    if (coefs == nullptr || C < 1 || R % C != 0)
        return (int)cudaErrorInvalidValue;
    const Taps taps{nullptr, (const int32_t*)coefs, bstride, cstride, C};
    return run(res, taps, orders, rshifts, dcoef, dprev, out, R, n, M, fuse,
               stream);
}
