// DMMA probe: a measurement aid for K8 (csrc/autocorr.cu), not a kernel of
// the codec (nothing in the port calls it; tools/dmma_probe.py runs it).
//
// K8 sums its lag products on the f64 tensor cores with mma.sync ... f64
// (DMMA). Two facts about the card decide its design and its tests:
//
//   order: which order a DMMA keeps inside, D = C + sum_k A[m][k] B[k][j]
//          (the tests emulate K8 exactly, so the emulation needs it): one
//          warp per trial loads A, B and C through the PTX ISA's fragment
//          map and writes D, for m8n8k4 and m16n8k4;
//   rate:  the f64 tensor rate each shape issues at, from warps that run
//          8 independent accumulators each for `iters` steps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void m8n8k4(double (&c)[4], const double* a,
                                       double b) {
    asm volatile(
        "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1}, {%2}, {%3}, {%0, %1};"
        : "+d"(c[0]), "+d"(c[1])
        : "d"(a[0]), "d"(b));
}

__device__ __forceinline__ void m16n8k4(double (&c)[4], const double* a,
                                        double b) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(b));
}

// rows = 8 (m8n8k4) or 16 (m16n8k4); A (rows x 4), B (4 x 8), C and D
// (rows x 8) row-major per trial. Lane l, g = l >> 2, t = l & 3, holds
// A[g][t] (and A[g + 8][t]), B[t][g], C[g][2t + i] (and C[g + 8][2t + i]).
__global__ void order_kernel(int rows, const double* A, const double* B,
                             const double* C, double* D) {
    const int l = threadIdx.x;
    const int g = l >> 2;
    const int t = l & 3;
    const double* a0 = A + (size_t)blockIdx.x * rows * 4;
    const double* b0 = B + (size_t)blockIdx.x * 32;
    const double* c0 = C + (size_t)blockIdx.x * rows * 8;
    double* d0 = D + (size_t)blockIdx.x * rows * 8;
    const double a[2] = {a0[g * 4 + t], rows == 16 ? a0[(g + 8) * 4 + t]
                                                   : 0.0};
    double c[4] = {c0[g * 8 + 2 * t], c0[g * 8 + 2 * t + 1], 0.0, 0.0};
    if (rows == 16) {
        c[2] = c0[(g + 8) * 8 + 2 * t];
        c[3] = c0[(g + 8) * 8 + 2 * t + 1];
        m16n8k4(c, a, b0[t * 8 + g]);
        d0[(g + 8) * 8 + 2 * t] = c[2];
        d0[(g + 8) * 8 + 2 * t + 1] = c[3];
    } else {
        m8n8k4(c, a, b0[t * 8 + g]);
    }
    d0[g * 8 + 2 * t] = c[0];
    d0[g * 8 + 2 * t + 1] = c[1];
}

template <int ROWS>
__global__ void rate_kernel(int iters, double seed, double* out) {
    double acc[8][4];
    double a[2] = {seed * threadIdx.x, seed * (threadIdx.x + 1)};
    const double b = seed + 1.0;
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[q][0] = acc[q][1] = acc[q][2] =
        acc[q][3] = 0.0;
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
            if (ROWS == 16) m16n8k4(acc[q], a, b);
            else m8n8k4(acc[q], a, b);
        }
    }
    double s = 0.0;
#pragma unroll
    for (int q = 0; q < 8; ++q) s += acc[q][0] + acc[q][1] + acc[q][2]
        + acc[q][3];
    if (s == 1.2345) out[0] = s;            // keeps the loop alive
}

}  // namespace

// trials warps, each one DMMA of `rows` (8 or 16) rows.
extern "C" int srla_dmma_order(int rows, const void* A, const void* B,
                               const void* C, void* D, int trials,
                               void* stream) {
    if (rows != 8 && rows != 16) return (int)cudaErrorInvalidValue;
    order_kernel<<<trials, 32, 0, (cudaStream_t)stream>>>(
        rows, (const double*)A, (const double*)B, (const double*)C,
        (double*)D);
    return (int)cudaGetLastError();
}

// blocks x threads, each warp iters x 8 DMMAs of `rows` rows.
extern "C" int srla_dmma_rate(int rows, int blocks, int threads, int iters,
                              void* out, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (rows == 16)
        rate_kernel<16><<<blocks, threads, 0, s>>>(iters, 1e-3,
                                                    (double*)out);
    else
        rate_kernel<8><<<blocks, threads, 0, s>>>(iters, 1e-3, (double*)out);
    return (int)cudaGetLastError();
}
