// K5: bit pack of a codeword stream into MSB-first 32-bit words.
//
// Replaces the Pallas TPU kernel srla_tpu/kernels/pallas_pack.py
// (pallas_pack_rows -> _pack_rows_kernel) and the XLA packers the JAX
// encoder runs instead, srla_tpu/kernels/bitpack.py pack_flat_stream (the
// grouped-window prefix pack) and pack_monotone_stream (scatter). Every entry
// e with tbits[e] > 0 puts the low tbits bits of tails[e] at absolute bit
// offset offs[e] of the output, most significant bit first:
//
//   w0 = off >> 5, sh = off & 31, over = max(tbits - (32 - sh), 0),
//   keep = tbits - over
//   word w0     |= (tail >> over) << (32 - sh - keep)      (if keep > 0)
//   word w0 + 1 |= tail << (32 - over)                      (if over > 0)
//
// Words at or beyond cap_w are dropped, as both JAX packers drop them; an
// entry at a negative offset is dropped too. Shift counts >= 32 give 0, as
// XLA's shifts do. Bit ranges of distinct entries are disjoint in a valid
// stream, so the OR equals the JAX packers' sum and the result does not
// depend on the order of the atomics.
//
// What bounds it on an H100: the stream (2582 rows x 5122 slots at the main
// path, 13.2 M entries of 16 bytes) is read once and the packed words
// (~15 MB) are written through L2 atomics; it is bound by memory traffic.
// Design: one thread per entry, at most two atomicOr into a buffer the
// wrapper zeroes. The TPU's grouped windows, frame overflow and prefix sums
// were workarounds for missing scatter; the atomics have no frame limit, so
// nothing overflows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t shl(uint32_t x, int k) {
    return (k < 0 || k >= 32) ? 0u : x << k;
}

__device__ __forceinline__ uint32_t shr(uint32_t x, int k) {
    return (k < 0 || k >= 32) ? 0u : x >> k;
}

__global__ void bitpack_kernel(const int64_t* __restrict__ offs,
                               const int32_t* __restrict__ tails,
                               const int32_t* __restrict__ tbits,
                               uint32_t* __restrict__ out, long long count,
                               long long cap_w) {
    const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (e >= count) return;
    const int tb = tbits[e];
    const long long off = offs[e];
    if (tb <= 0 || off < 0 || off >= cap_w * 32) return;
    const long long w0 = off >> 5;
    const int sh = (int)(off & 31);
    int over = tb - (32 - sh);
    if (over < 0) over = 0;
    const int keep = tb - over;
    const uint32_t tail = (uint32_t)tails[e];
    if (keep > 0) {
        atomicOr(&out[w0], shl(shr(tail, over), 32 - sh - keep));
    }
    if (over > 0 && w0 + 1 < cap_w) {
        atomicOr(&out[w0 + 1], shl(tail, 32 - over));
    }
}

}  // namespace

// offs: (count,) int64 absolute bit offsets; tails, tbits: (count,) int32;
// out: (cap_w,) zeroed 32-bit words.
extern "C" int srla_bitpack(const void* offs, const void* tails,
                            const void* tbits, void* out, long long count,
                            long long cap_w, void* stream) {
    const long long blocks = (count + kThreads - 1) / kThreads;
    bitpack_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)offs, (const int32_t*)tails, (const int32_t*)tbits,
        (uint32_t*)out, count, cap_w);
    return (int)cudaGetLastError();
}
