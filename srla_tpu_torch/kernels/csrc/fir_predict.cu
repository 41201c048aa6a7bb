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
// Rows must have order <= M; a larger order is treated as M so that no read
// leaves the staged tile.
//
// What bounds it on an H100: unlike the decoder's synthesis (K1) every output
// sample is independent, so the cost is order multiply-adds per sample
// (5164 rows x 4096 samples x up to 64 taps at the main path, ~0.8 G int32
// multiply-adds) beside one read and one write of the (R, n) int32 planes.
// The products are full wrapping 32 x 32 -> low 32 bits (24-bit samples are in
// scope, and the sums must wrap exactly), which no tensor-core type offers:
// the integer pipe's rate (one IMAD a lane and clock) is the bound the
// arithmetic leaves, and it comes to about the bytes' time.
//
// Design: a register tile. Each thread computes kOut = 8 consecutive outputs
// from a sliding window of x kept in registers: a group of 8 taps costs two
// 128-bit shared loads of x, two of the taps (broadcasts) and 64 IMADs, so
// the integer pipe and not the load pipe sets the pace. The taps sit
// right-aligned in shared memory behind zero padding up to Mr, M rounded up
// to the group of 8, and the loop starts at the row's first group that holds
// a tap: the trip count depends on the row, the group is unrolled and
// branch-free, and the zero taps add 0 mod 2^32. With Mr and a thread's first
// output both multiples of 8 every window load is 16-byte aligned. A CTA
// covers kTile = 512 samples of one row, so the Mr-sample halo is a 12 % extra
// read at M 64 (64 threads were faster than 128 and 256 at the main shape:
// more, smaller CTAs overlap their loads and stores with the others'
// arithmetic; padding the tile against the window loads' two-way bank
// conflicts cost more in address arithmetic than it saved); it stages the
// tile with 128-bit loads where the row is 16-byte aligned and sample by
// sample where it is not (odd n). Four groups are unrolled so that the
// window moves by renaming and not by copies. Outputs of the warm-up are
// computed like the others and replaced by a select after the loop (their
// window reads the zero-filled halo before the row).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kOut = 8;                    // outputs a thread, taps a group
constexpr int kTile = kThreads * kOut;     // samples of one row a CTA

__global__ void __launch_bounds__(kThreads)
fir_predict_kernel(const int32_t* __restrict__ work,
                   const int32_t* __restrict__ coefs_rev,
                   const int32_t* __restrict__ orders,
                   const int32_t* __restrict__ rshifts,
                   int32_t* __restrict__ out, int n, int M, int Mr) {
    extern __shared__ uint4 smem4[];
    uint32_t* c = reinterpret_cast<uint32_t*>(smem4);   // Mr taps
    uint32_t* x = c + Mr;            // x[i] = work[row, s0 - Mr + i]
    const long long row = blockIdx.x;
    const int s0 = blockIdx.y * kTile;
    const int t = threadIdx.x;
    const int32_t* w = work + row * n;
    int32_t* o = out + row * n;
    int order = orders[row];
    if (order > M) order = M;
    if (order < 0) order = 0;
    const int pad = Mr - order;      // zero taps in front
    for (int i = t; i < Mr; i += kThreads) {
        c[i] = i >= pad ? (uint32_t)coefs_rev[row * M + i - pad] : 0u;
    }
    const bool in_aligned = (reinterpret_cast<uintptr_t>(w) & 15) == 0;
    if (in_aligned) {
        for (int i = 4 * t; i < Mr + kTile; i += 4 * kThreads) {
            const int s = s0 - Mr + i;
            uint4 v;
            if (s >= 0 && s + 3 < n) {
                v = *reinterpret_cast<const uint4*>(w + s);
            } else {
                v.x = (s >= 0 && s < n) ? (uint32_t)w[s] : 0u;
                v.y = (s + 1 >= 0 && s + 1 < n) ? (uint32_t)w[s + 1] : 0u;
                v.z = (s + 2 >= 0 && s + 2 < n) ? (uint32_t)w[s + 2] : 0u;
                v.w = (s + 3 >= 0 && s + 3 < n) ? (uint32_t)w[s + 3] : 0u;
            }
            *reinterpret_cast<uint4*>(x + i) = v;
        }
    } else {
        for (int i = t; i < Mr + kTile; i += kThreads) {
            const int s = s0 - Mr + i;
            x[i] = (s >= 0 && s < n) ? (uint32_t)w[s] : 0u;
        }
    }
    __syncthreads();
    const int s = s0 + kOut * t;     // this thread's first output
    if (s >= n) return;
    const int rsh = rshifts[row];
    const uint32_t half = rsh <= 0 ? 0x80000000u
                        : rsh <= 32 ? (1u << (rsh - 1)) : 0u;
    uint32_t acc[kOut];
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[j] = half;
    // win[0..7] = xb[i..i+7] at the top of each group; xb[i] is the sample
    // that tap c[i] meets in the thread's first output.
    const uint32_t* xb = x + kOut * t;
    int i = pad & ~(kOut - 1);
    uint32_t win[2 * kOut];
    {
        const uint4 a = *reinterpret_cast<const uint4*>(xb + i);
        const uint4 b = *reinterpret_cast<const uint4*>(xb + i + 4);
        win[0] = a.x; win[1] = a.y; win[2] = a.z; win[3] = a.w;
        win[4] = b.x; win[5] = b.y; win[6] = b.z; win[7] = b.w;
    }
#pragma unroll 4
    for (; i < Mr; i += kOut) {
        const uint4 a = *reinterpret_cast<const uint4*>(xb + i + 8);
        const uint4 b = *reinterpret_cast<const uint4*>(xb + i + 12);
        const uint4 ca = *reinterpret_cast<const uint4*>(c + i);
        const uint4 cb = *reinterpret_cast<const uint4*>(c + i + 4);
        win[8] = a.x; win[9] = a.y; win[10] = a.z; win[11] = a.w;
        win[12] = b.x; win[13] = b.y; win[14] = b.z; win[15] = b.w;
        const uint32_t tap[kOut] = {ca.x, ca.y, ca.z, ca.w,
                                    cb.x, cb.y, cb.z, cb.w};
#pragma unroll
        for (int k = 0; k < kOut; ++k) {
#pragma unroll
            for (int j = 0; j < kOut; ++j) acc[j] += tap[k] * win[k + j];
        }
#pragma unroll
        for (int j = 0; j < kOut; ++j) win[j] = win[j + kOut];
    }
    // Now win[j] = x[s + j]; the sample before the first one is xb[Mr - 1].
    const int sh = rsh < 0 ? 31 : (rsh > 31 ? 31 : rsh);
    uint32_t prev = xb[Mr - 1];
    uint32_t r[kOut];
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
        const uint32_t xs = win[j];
        const uint32_t full = xs + (uint32_t)((int32_t)acc[j] >> sh);
        const int sj = s + j;
        r[j] = (order == 0 || sj == 0) ? xs : sj < order ? xs - prev : full;
        prev = xs;
    }
    if ((reinterpret_cast<uintptr_t>(o) & 15) == 0 && s + kOut <= n) {
        *reinterpret_cast<uint4*>(o + s) = make_uint4(r[0], r[1], r[2], r[3]);
        *reinterpret_cast<uint4*>(o + s + 4) =
            make_uint4(r[4], r[5], r[6], r[7]);
    } else {
#pragma unroll
        for (int j = 0; j < kOut; ++j) {
            if (s + j < n) o[s + j] = (int32_t)r[j];
        }
    }
}

}  // namespace

// work, out: (R, n) int32; coefs_rev: (R, M) int32; orders, rshifts: (R,)
// int32.
extern "C" int srla_fir_predict(const void* work, const void* coefs_rev,
                                const void* orders, const void* rshifts,
                                void* out, int R, int n, int M,
                                void* stream) {
    const int Mr = (M + kOut - 1) / kOut * kOut;
    const size_t smem = (2ull * Mr + kTile) * sizeof(uint32_t);
    cudaError_t err = cudaFuncSetAttribute(
        fir_predict_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(R, (n + kTile - 1) / kTile);   // rows on x: no 64k cap
    fir_predict_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)work, (const int32_t*)coefs_rev,
        (const int32_t*)orders, (const int32_t*)rshifts, (int32_t*)out, n, M,
        Mr);
    return (int)cudaGetLastError();
}
