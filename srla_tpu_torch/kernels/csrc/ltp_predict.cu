// K18: the integer LTP residual of the encode.
//
// Replaces the XLA program srla_tpu/kernels/exact.py:1128 _ltp_predict_dev.
// For each row of x (V, n) int32 with period p > 0 (delay d = p + order /
// 2, order 1 or 3, reversed coefficients c):
//
//   out[s] = x[s] - ((16 + sum_{i<order} c[i] x[clamp(s - d + i, 0, n-1)])
//                    >> 5)                                   for s >= d + 1
//   out[s] = x[s]                                            otherwise
//
// with x the unfiltered input throughout; rows with p <= 0 pass through.
// The arithmetic is wrapping int32: the products and the sum in uint32_t
// (the low 32 bits of the plain version's int64 sum), then an arithmetic
// shift of the sum's int32 pattern and a wrapping subtraction.
//
// What bounds it on an H100: bytes. At the main group (5164 rows x 4096)
// it reads 85 MB and writes 85 MB: 0.05 ms at 3.35 TB/s; a sample takes
// about a dozen integer instructions at order 3.
//
// Design (a simple first kernel): a CTA of 256 threads a row. The taps of
// s lie d - 2 .. d samples behind it in the same row, which the CTA (or
// its neighbour in the row) has just read, so they come through L1: no
// staging. Each thread takes samples 256 apart, coalesced; a row without a
// period is copied.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int kOrder>
__device__ __forceinline__ void filter_row(const int32_t* __restrict__ x,
                                           int32_t* __restrict__ out,
                                           const int32_t* c, long long d,
                                           int n) {
    uint32_t cu[kOrder];
#pragma unroll
    for (int i = 0; i < kOrder; ++i) cu[i] = (uint32_t)c[i];
    for (int s = threadIdx.x; s < n; s += kThreads) {
        const int32_t xs = x[s];
        if (s >= d + 1) {
            uint32_t acc = 16u;
#pragma unroll
            for (int i = 0; i < kOrder; ++i) {
                long long j = s - d + i;
                j = j < 0 ? 0 : (j > n - 1 ? n - 1 : j);
                acc += cu[i] * (uint32_t)x[j];
            }
            const int32_t pred = (int32_t)acc >> 5;
            out[s] = (int32_t)((uint32_t)xs - (uint32_t)pred);
        } else {
            out[s] = xs;
        }
    }
}

__global__ void __launch_bounds__(kThreads)
ltp_predict_kernel(const int32_t* __restrict__ x,
                   const int32_t* __restrict__ coefs,
                   const int32_t* __restrict__ periods,
                   int32_t* __restrict__ out, int n, int order,
                   int stride) {
    const long long r = blockIdx.x;
    const int32_t* xr = x + r * n;
    int32_t* o = out + r * n;
    const int p = periods[r];
    if (p <= 0) {
        for (int s = threadIdx.x; s < n; s += kThreads) o[s] = xr[s];
        return;
    }
    const long long d = (long long)p + (order >> 1);
    const int32_t* c = coefs + r * stride;
    if (order == 1) {
        filter_row<1>(xr, o, c, d, n);
    } else {
        filter_row<3>(xr, o, c, d, n);
    }
}

}  // namespace

// x, out: (V, n) int32; coefs: (V, stride) int32, the first order columns
// the reversed coefficients; periods: (V,) int32; order 1 or 3.
extern "C" int srla_ltp_predict(const void* x, const void* coefs,
                                const void* periods, void* out, int V, int n,
                                int order, int stride, void* stream) {
    if (V <= 0 || n <= 0 || (order != 1 && order != 3) || stride < order)
        return (int)cudaErrorInvalidValue;
    ltp_predict_kernel<<<V, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)x, (const int32_t*)coefs, (const int32_t*)periods,
        (int32_t*)out, n, order, stride);
    return (int)cudaGetLastError();
}
