// K3: wrapping-int32 FIR residual of the encode analysis.
//
// Replaces srla_tpu/kernels/encode.py:_predict (with _reverse_coefs' layout),
// which srla_tpu/kernels/exact.py:_analyze_core_exact runs on the TPU as an
// XLA fori_loop over taps. Per row r and sample s:
//
//   out[s] = x[s]                                     order == 0 or s == 0
//            x[s] - x[s-1]                            0 < s < order (warm-up)
//            x[s] + ((half + sum_i c[i] * x[s-order+i]) >> rshift)  otherwise
//
// c is the row's coefficient vector reversed and left-aligned (c[i] =
// coef[order-1-i]); half = 1 << (rshift-1), or INT_MIN when rshift == 0 (the
// reference's x86 shift-count masking). Every sum wraps mod 2^32: it is done
// in uint32_t (signed overflow is undefined in C++), and only the final shift
// reinterprets as int32 so that it stays arithmetic. Shift counts >= 32 give
// what XLA gives: 0 for the left shift of `half`, the sign fill for `>>`.
//
// What bounds it on an H100: unlike the decoder's synthesis (K1) every output
// sample is independent, so the cost is order multiply-adds per sample
// (5164 rows x 4096 samples x 64 taps at the main path, ~1.4 G int32 MACs)
// and the bytes are one read and one write of the (R, n) int32 planes.
// Design: one thread per (row, sample), 256 samples of one row per block.
// The block stages the row's coefficients and its tile of x with the
// M-sample halo in shared memory, so each x is read from device memory about
// once and the taps are shared-memory broadcasts. Rows must have order <= M;
// a larger order is treated as M so that no read leaves the staged tile.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;

__global__ void fir_predict_kernel(const int32_t* __restrict__ work,
                                   const int32_t* __restrict__ coefs_rev,
                                   const int32_t* __restrict__ orders,
                                   const int32_t* __restrict__ rshifts,
                                   int32_t* __restrict__ out, int n, int M) {
    extern __shared__ uint32_t smem[];
    uint32_t* c = smem;              // c[i] = coefs_rev[row, i]
    uint32_t* x = smem + M;          // x[i] = work[row, s0 - M + i]
    const long long row = blockIdx.x;
    const int s0 = blockIdx.y * kTile;
    const int t = threadIdx.x;
    const int32_t* w = work + row * n;
    for (int i = t; i < M; i += kTile) {
        c[i] = (uint32_t)coefs_rev[row * M + i];
    }
    for (int i = t; i < M + kTile; i += kTile) {
        const int s = s0 - M + i;
        x[i] = (s >= 0 && s < n) ? (uint32_t)w[s] : 0u;
    }
    __syncthreads();
    const int s = s0 + t;
    if (s >= n) return;
    int order = orders[row];
    if (order > M) order = M;
    const uint32_t xs = x[M + t];
    uint32_t r;
    if (order <= 0 || s == 0) {
        r = xs;
    } else if (s < order) {
        r = xs - x[M + t - 1];
    } else {
        const int rsh = rshifts[row];
        uint32_t acc = rsh <= 0 ? 0x80000000u
                     : rsh <= 32 ? (1u << (rsh - 1)) : 0u;
        const uint32_t* xw = x + M + t - order;
        for (int i = 0; i < order; ++i) {
            acc += c[i] * xw[i];
        }
        const int sh = rsh < 0 ? 31 : (rsh > 31 ? 31 : rsh);
        r = xs + (uint32_t)((int32_t)acc >> sh);
    }
    out[row * n + s] = (int32_t)r;
}

}  // namespace

// work, out: (R, n) int32; coefs_rev: (R, M) int32; orders, rshifts: (R,)
// int32.
extern "C" int srla_fir_predict(const void* work, const void* coefs_rev,
                                const void* orders, const void* rshifts,
                                void* out, int R, int n, int M,
                                void* stream) {
    const size_t smem = (2ull * M + kTile) * sizeof(uint32_t);
    cudaError_t err = cudaFuncSetAttribute(
        fir_predict_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(R, (n + kTile - 1) / kTile);   // rows on x: no 64k cap
    fir_predict_kernel<<<grid, kTile, smem, (cudaStream_t)stream>>>(
        (const int32_t*)work, (const int32_t*)coefs_rev,
        (const int32_t*)orders, (const int32_t*)rshifts, (int32_t*)out, n, M);
    return (int)cudaGetLastError();
}
