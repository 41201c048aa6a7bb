// Serial-chain probe: a measurement aid for chip_smoke.py, not a kernel of
// the codec (no TPU kernel behind it, nothing in the port calls it).
//
// K1 and K2 are recurrences: each sample (K1) or codeword (K2) needs the
// one before it, so neither can take less than n times the latency of the
// shortest dependent chain one step needs, however the work is spread.
// This probe runs that chain alone in one warp, on values in registers,
// with no memory access:
//
//   kind 0, a K1 sample: y = x - ((c * y + p) >> r)
//           (multiply-add on the newest sample, shift, subtract)
//   kind 1, a K2 codeword: p += clz(funnel(w1, w0, p)) + k + 1
//           (the 32 bits at the bit position, their leading zeros, the
//           next position)
//   kind 2, K7's first design's Levinson step: a warp's f64 sum of one
//           term a lane (an xor-butterfly of five shuffles and adds), then
//           the division by the error variance that gives the next step's
//           term
//   kind 3, K7's Levinson step at M <= 64: the same over a row's group of
//           8 lanes (three shuffles and adds), then the division
//   kind 4, a K9 step: a lane's sample reads three ring slots in shared
//           memory that the step before wrote (delay 34, three taps: w =
//           32), three wrapping multiply-adds, the shift, the add to its own
//           staged slot, the store, __syncwarp
//   kind 5, K10's solve chain: the order-3 ridge Cholesky (three
//           __dsqrt_rn and the divisions), the solves, the trace, the
//           rounding margin and one coefficient's quantization, each step's
//           input the last step's output
//   kind 6, a K12 chain step: one f64 add on the running sum, its other
//           operand read from shared memory independently of the sum (the
//           mean-abs sum and each r-vector entry of SVR's refinement are
//           such chains over the samples)
//   kind 7, a step of K7's quantization chain (lpc_analyze.cu
//           quantize_row): the coefficient read from shared memory and
//           scaled, added to the fed-back error, rounded half away from
//           zero, clamped, its margin test, and the new error, with the
//           same intrinsics
//   kinds 8-13, a step of K14's recursion (lpc_analyze_f32.cu Chain::step)
//           with L lanes a row and R registers a lane: R products and
//           predicated adds, the xor butterfly over the row's lanes
//           (log2 L shuffles and adds), the IEEE division, the update of
//           a[] and c[] and the shuffle that moves c[] up one index; kind
//           8: L 8, R 9 (M 64), 9: L 16, R 5 (M 64), 10: L 32, R 3 (M 64),
//           11: L 16, R 9 (M 128), 12: L 32, R 5 (M 128), 13: L 32, R 8
//           (M 255); ev starts at 2^20, so gamma stays tiny and the values
//           bounded over any number of steps
//
// chip_smoke.py times two chain lengths with CUDA events and takes the
// difference per step, then multiplies by a row's samples or a block's
// codewords (K7: the recursion's steps, and for its quantization entry the
// largest order; K9: the steps of its row with the most; K10: one solve a
// row, to which its scans add): the kernel's serial floor on this card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// A Levinson step's chain over a group of W lanes: the butterfly, then
// the division.
template <int W>
__device__ uint32_t f64_chain(uint32_t y, int steps) {
    double v = 1.0 / (double)(y | 1u);
    for (int i = 0; i < steps; ++i) {
        double s = v;
#pragma unroll
        for (int off = 1; off < W; off <<= 1)
            s = __dadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off, W));
        v = __ddiv_rn(s, -__dadd_rn(fabs(s), 1.0));   // |v| < 1
    }
    return (uint32_t)__double2hiint(v);
}

// K12's chain: dependent f64 adds of values from shared memory.
__device__ uint32_t add_chain(uint32_t y, int steps) {
    __shared__ double vals[256];
    const int lane = threadIdx.x & 31;
    for (int k = lane; k < 256; k += 32) vals[k] = 1.0 / (double)(k + 3);
    __syncwarp();
    double acc = (double)(y & 255u);
#pragma unroll 16
    for (int i = 0; i < steps; ++i) acc = __dadd_rn(acc, vals[i & 255]);
    return (uint32_t)__double2hiint(acc);
}

// K7's quantization step (quantize_row) on coefficients in shared memory,
// at 8-bit values (qmax 128) and a shift of 7; the stored value is summed
// instead, off the chain as the kernel's store is.
__device__ uint32_t quant_chain(uint32_t y, int steps) {
    __shared__ double coef[256];
    const int lane = threadIdx.x & 31;
    for (int k = lane; k < 256; k += 32)
        coef[k] = ((double)((k * 37 + 11) % 255) - 127.0) / 128.0;
    __syncwarp();
    const double scale = 128.0, qmax = 128.0, eps_k = 1e-7;
    double qerr = (double)(y & 3u) * 0.125;
    bool risky = false;
    int32_t sum = 0;
#pragma unroll 4
    for (int i = 0; i < steps; ++i) {
        const double qe = __dadd_rn(qerr, __dmul_rn(coef[i & 255], scale));
        const double ax = fabs(qe);
        const double r = floor(__dadd_rn(ax, 0.5));
        double qt = qe < 0.0 ? -r : r;
        qt = qt < -qmax ? -qmax : (qt > qmax - 1.0 ? qmax - 1.0 : qt);
        risky |= fabs(__dsub_rn(__dsub_rn(ax, floor(ax)), 0.5)) < eps_k;
        qerr = __dsub_rn(qe, qt);
        sum += (int32_t)qt;
    }
    return (uint32_t)sum ^ (risky ? 1u : 0u)
        ^ (uint32_t)__double2hiint(qerr);
}

// K9's step (ltp_synth.cu) on a ring of 2048 samples.
__device__ uint32_t k9_chain(uint32_t y, int steps, uint32_t a, uint32_t b) {
    __shared__ uint32_t ring[2048];
    const int lane = threadIdx.x & 31;
    for (int k = lane; k < 2048; k += 32) ring[k] = y + (uint32_t)k;
    __syncwarp();
    const uint32_t c[3] = {a, b, a ^ b};
    const int delay = 34;
    int s = 64 + lane;
    for (int i = 0; i < steps; ++i) {
        const int base = s - delay;
        uint32_t acc = 16u;
#pragma unroll
        for (int t = 0; t < 3; ++t) acc += c[t] * ring[(base + t) & 2047];
        ring[s & 2047] += (uint32_t)((int32_t)acc >> 5);
        __syncwarp();
        s += 32;
    }
    return ring[(s - 32) & 2047];
}

// K10's solve (ltp_analyze.cu after the scans) at order 3.
__device__ uint32_t k10_chain(uint32_t y, int steps) {
    double r = 1.0 + (double)(y & 7u) * 1e-3;
    for (int i = 0; i < steps; ++i) {
        const double a0r = __dmul_rn(r, 1.0 + 1e-5);
        const double r1 = __dmul_rn(r, 0.5), r2 = __dmul_rn(r, 0.25);
        const double b0 = __dmul_rn(r, 0.4), b1 = __dmul_rn(r, 0.3);
        const double b2 = __dmul_rn(r, 0.2);
        const double d0 = __ddiv_rn(1.0, __dsqrt_rn(a0r));
        const double l10 = __dmul_rn(r1, d0), l20 = __dmul_rn(r2, d0);
        const double s1 = __dsub_rn(a0r, __dmul_rn(l10, l10));
        const double d1 = __ddiv_rn(1.0, __dsqrt_rn(s1));
        const double l21 = __dmul_rn(__dsub_rn(r1, __dmul_rn(l10, l20)), d1);
        const double s2 = __dsub_rn(__dsub_rn(a0r, __dmul_rn(l21, l21)),
                                    __dmul_rn(l20, l20));
        const double d2 = __ddiv_rn(1.0, __dsqrt_rn(s2));
        const double y0 = __dmul_rn(b0, d0);
        const double y1 = __dmul_rn(__dsub_rn(b1, __dmul_rn(l10, y0)), d1);
        const double y2 = __dmul_rn(__dsub_rn(__dsub_rn(b2, __dmul_rn(l21, y1)),
                                              __dmul_rn(l20, y0)), d2);
        const double x2 = __dmul_rn(y2, d2);
        const double x1 = __dmul_rn(__dsub_rn(y1, __dmul_rn(l21, x2)), d1);
        const double x0 = __dmul_rn(__dsub_rn(__dsub_rn(y0, __dmul_rn(l10, x1)),
                                              __dmul_rn(l20, x2)), d0);
        const double m10 = __dmul_rn(__dmul_rn(l10, d0), d1);
        const double m21 = __dmul_rn(__dmul_rn(l21, d1), d2);
        const double tr = __dadd_rn(__dadd_rn(__dadd_rn(__dmul_rn(d0, d0),
                                                        __dmul_rn(m10, m10)),
                                              __dmul_rn(d1, d1)),
                                    __dmul_rn(m21, m21));
        const double sx = __dadd_rn(__dadd_rn(fabs(x0), fabs(x1)), fabs(x2));
        const double eps_q = __dmul_rn(__dmul_rn(__dmul_rn(32.0, tr), r),
                                       __dadd_rn(2.0, __dmul_rn(3.0, sx)));
        const double ax = fabs(__dmul_rn(x0, 32.0));
        const double q = floor(__dadd_rn(ax, 0.5));
        const bool near = fabs(__dsub_rn(__dsub_rn(ax, floor(ax)), 0.5))
            < eps_q;
        r = __dadd_rn(1.0, __dmul_rn(__dadd_rn(q, near ? 1.0 : 0.0), 1e-9));
    }
    return (uint32_t)__double2hiint(r);
}

// K14's step (lpc_analyze_f32.cu Chain::step) over a row's L lanes.
template <int L, int R>
__device__ uint32_t k14_chain(uint32_t y, int steps) {
    const int l = threadIdx.x & (L - 1);
    float lag[R], a[R], b[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
        const int m = l + L * j;
        lag[j] = 1.0f / (float)(m + 2);
        a[j] = m == 0 ? 1.0f : 0.25f;
        b[j] = 0.5f + (float)(y & 3u) * 0.125f;
    }
    float ev = 1048576.0f;
    const int below = (l + L - 1) & (L - 1);
    for (int i = 0; i < steps; ++i) {
        const int kp2 = (i & 63) + 2;
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < R; ++j) {
            const int m = l + L * j;
            if (m >= 1 && m <= kp2) s = __fadd_rn(s, __fmul_rn(b[j], lag[j]));
        }
#pragma unroll
        for (int o = L / 2; o >= 1; o >>= 1)
            s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o, L));
        const float den = fabsf(ev) < 1e-30f ? 1.0f : ev;
        const float g = __fdiv_rn(s, -den);
        ev = __fmul_rn(ev, __fsub_rn(1.0f, __fmul_rn(g, g)));
        float c[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
            const float aj = a[j], bj = b[j];
            a[j] = __fadd_rn(aj, __fmul_rn(g, bj));
            c[j] = __fadd_rn(bj, __fmul_rn(g, aj));
        }
        float up[R];
#pragma unroll
        for (int j = 0; j < R; ++j)
            up[j] = __shfl_sync(0xffffffffu, c[j], below, L);
#pragma unroll
        for (int j = 0; j < R; ++j)
            b[j] = l == 0 ? (j == 0 ? 0.0f : up[j - 1]) : up[j];
    }
    float sum = ev;
#pragma unroll
    for (int j = 0; j < R; ++j) sum = __fadd_rn(sum, a[j]);
    return __float_as_uint(sum);
}

__global__ void chain_probe_kernel(int kind, int steps, uint32_t a,
                                   uint32_t b, uint32_t* out) {
    uint32_t y = a ^ threadIdx.x;
    if (kind == 0) {
        const int r = (int)(b & 15u);
#pragma unroll 16
        for (int i = 0; i < steps; ++i)
            y = b - (uint32_t)((int32_t)(y * a + b) >> r);
    } else if (kind == 1) {
        const uint32_t k1 = (b & 15u) + 1u;
#pragma unroll 16
        for (int i = 0; i < steps; ++i)
            y += (uint32_t)__clz(__funnelshift_l(b, a, y)) + k1;
    } else if (kind == 4) {
        y = k9_chain(y, steps, a, b);
    } else if (kind == 5) {
        y = k10_chain(y, steps);
    } else if (kind == 6) {
        y = add_chain(y, steps);
    } else if (kind == 7) {
        y = quant_chain(y, steps);
    } else if (kind == 8) {
        y = k14_chain<8, 9>(y, steps);
    } else if (kind == 9) {
        y = k14_chain<16, 5>(y, steps);
    } else if (kind == 10) {
        y = k14_chain<32, 3>(y, steps);
    } else if (kind == 11) {
        y = k14_chain<16, 9>(y, steps);
    } else if (kind == 12) {
        y = k14_chain<32, 5>(y, steps);
    } else if (kind == 13) {
        y = k14_chain<32, 8>(y, steps);
    } else {
        y = kind == 2 ? f64_chain<32>(y, steps) : f64_chain<8>(y, steps);
    }
    out[threadIdx.x] = y;
}

}  // namespace

// One warp runs `steps` steps of chain `kind`; out: (32,) int32.
extern "C" int srla_chain_probe(int kind, int steps, unsigned a, unsigned b,
                                void* out, void* stream) {
    chain_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
        kind, steps, a, b, (uint32_t*)out);
    return (int)cudaGetLastError();
}
