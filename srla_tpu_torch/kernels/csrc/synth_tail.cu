// K19: the decode's synthesis tail, the stereo inverse and the offset shift
// of a decoded block group, in place.
//
// Replaces the XLA program at the end of srla_tpu/kernels/decode2.py:503
// _synthesize (:529-538). For each block b of the group, with y (B, C, n)
// int32 the output of the LPC (and LTP) synthesis and m = methods[b]:
//
//   C >= 2, rows o0 = y[b, 0], o1 = y[b, 1]:
//     m 1: c0 = o0 - (o1 >> 1), c1 = o1 + c0      (mid/side)
//     m 2: c1 = o1 + o0                           (left/side)
//     m 3: c0 = o1 - o0                           (right/side)
//     any other m: both rows as they are
//   then every row of every channel: out = x << lshift
//
// in wrapping int32, as JAX computes it: the sums in uint32_t, ">> 1" an
// arithmetic shift of the int32 pattern, the left shift in uint32_t (a
// left shift of a negative int32 is undefined in C++17). Each output
// sample depends only on the same sample of rows 0 and 1 of its block, so
// a thread reads a sample's rows and writes them back where they lay.
//
// What bounds it on an H100: bytes. At the main decode group (B 1291, C 2,
// n 4096) a pass over the rows reads and writes 42.3 MB each way, 0.0253
// ms at 3.35 TB/s; a sample takes a handful of integer instructions.
//
// Design: a thread per (block, four consecutive samples) and channel
// pair, blocks along the grid's y (strided beyond 65535). Rows load and
// store as one 16-byte vector where the row is 16-byte aligned (n a
// multiple of 4: 4096, 4064), element by element otherwise (n 333). In
// place, a row the data leaves as it is is neither read nor written: at
// lshift 0 a block of method 0 costs nothing, a block of method 2 (3)
// writes back only row 1 (0), and channels 2.. (and a mono group) are
// touched only when lshift is not 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ bool aligned16(const int32_t* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Samples s..s+3 of a row (those at or past n read as 0).
__device__ __forceinline__ void load4(const int32_t* row, int s, int n,
                                      uint32_t (&x)[4]) {
    if (s + 4 <= n && aligned16(row)) {
        const uint4 v = *reinterpret_cast<const uint4*>(row + s);
        x[0] = v.x;
        x[1] = v.y;
        x[2] = v.z;
        x[3] = v.w;
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
            x[k] = s + k < n ? (uint32_t)row[s + k] : 0u;
    }
}

// Samples s..s+3 of a row, those before n.
__device__ __forceinline__ void store4(int32_t* row, int s, int n,
                                       const uint32_t (&x)[4]) {
    if (s + 4 <= n && aligned16(row)) {
        *reinterpret_cast<uint4*>(row + s) = make_uint4(x[0], x[1], x[2],
                                                        x[3]);
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
            if (s + k < n) row[s + k] = (int32_t)x[k];
    }
}

// in and out may be the same buffer: no __restrict__ on them.
__global__ void __launch_bounds__(kThreads)
synth_tail_kernel(const int32_t* in, int32_t* out,
                  const int32_t* __restrict__ methods, long long mstride,
                  int B, int C, int n, int lshift) {
    const int s = (blockIdx.x * kThreads + threadIdx.x) * 4;
    if (s >= n) return;
    const bool inplace = in == out;
    const bool shifted = lshift != 0 || !inplace;
    for (int b = blockIdx.y; b < B; b += gridDim.y) {
        const long long base = (long long)b * C * n;
        int c = 0;
        if (C >= 2) {
            const int m = methods[(long long)b * mstride];
            const bool w0 = shifted || m == 1 || m == 3;
            const bool w1 = shifted || m == 1 || m == 2;
            if (w0 || w1) {
                uint32_t o0[4], o1[4];
                load4(in + base, s, n, o0);
                load4(in + base + n, s, n, o1);
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const uint32_t a = o0[k], d = o1[k];
                    uint32_t r0 = a, r1 = d;
                    if (m == 1) {
                        r0 = a - (uint32_t)((int32_t)d >> 1);
                        r1 = d + r0;
                    } else if (m == 2) {
                        r1 = d + a;
                    } else if (m == 3) {
                        r0 = d - a;
                    }
                    o0[k] = r0 << lshift;
                    o1[k] = r1 << lshift;
                }
                if (w0) store4(out + base, s, n, o0);
                if (w1) store4(out + base + n, s, n, o1);
            }
            c = 2;
        }
        if (shifted) {
            for (; c < C; ++c) {
                uint32_t x[4];
                load4(in + base + (long long)c * n, s, n, x);
#pragma unroll
                for (int k = 0; k < 4; ++k) x[k] <<= lshift;
                store4(out + base + (long long)c * n, s, n, x);
            }
        }
    }
}

}  // namespace

// in, out: (B, C, n) int32, contiguous, the same buffer for the in-place
// pass; methods: block b's method at methods[b * mstride] (int32; read
// only when C >= 2); 0 <= lshift < 32.
extern "C" int srla_synth_tail(const void* in, void* out, const void* methods,
                               long long mstride, int B, int C, int n,
                               int lshift, void* stream) {
    if (B <= 0 || C <= 0 || n <= 0 || lshift < 0 || lshift >= 32)
        return (int)cudaErrorInvalidValue;
    const int quads = (n + 3) / 4;
    dim3 grid((quads + kThreads - 1) / kThreads,
              B < kMaxGridY ? B : kMaxGridY);
    synth_tail_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)in, (int32_t*)out, (const int32_t*)methods, mstride,
        B, C, n, lshift);
    return (int)cudaGetLastError();
}
