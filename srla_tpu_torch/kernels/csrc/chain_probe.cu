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
//
// chip_smoke.py times two chain lengths with CUDA events and takes the
// difference per step, then multiplies by a row's samples or a block's
// codewords (K7: the recursion's steps): the kernel's serial floor on this
// card.

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
