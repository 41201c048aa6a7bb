// K13: verify a decoded block group against a device-resident expected PCM.
//
// Replaces the XLA program srla_tpu/kernels/decode2.py:660
// verify_blocks_device. Given out (B, C, n) int32, expected (C, N) int32,
// starts (B,) int32 and okrows (B,) bool, it clears *flag (one byte, set
// to 1 by the caller) when some row b with okrows[b] has
//
//   out[b, c, i] != expected[c, s_b + i]   for some c < C, i < n,
//   s_b = clamp(starts[b], 0, N - n)
//
// The clamp is the one of the XLA gather the JAX program uses: a start
// past N - n reads the last n samples, a negative one the first n. The
// caller guarantees n <= N. Nothing is fetched to the host; the flag stays
// on the device, and a group's flags are read once after every group.
//
// What bounds it on an H100: bytes. Each ok row reads its n samples of
// out and of expected once (the main path's group: 84.6 MB, 0.025 ms at
// 3.35 TB/s); the compare is one instruction a sample.
//
// Design: a CTA of 256 threads a (block, channel) row and tile of 4096
// samples (grid.x the B * C rows, grid.y the tiles of n). A row that is
// not ok returns at once, uniformly for the CTA. Where both the row of
// out and its span of expected start on 16 bytes (n a multiple of 4; a
// start that is a multiple of 4 and N a multiple of 4 for channels past
// the first), a thread reads four samples of each with one 128-bit load;
// otherwise (after an odd-length block, or at an odd N) each thread reads
// single samples, consecutive across the warp, so the loads coalesce all
// the same. The CTA's mismatches meet in __syncthreads_or and one thread
// writes the 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;       // samples a CTA, a multiple of 4

__global__ void __launch_bounds__(kThreads)
verify_kernel(const int32_t* __restrict__ out,
              const int32_t* __restrict__ expected,
              const int32_t* __restrict__ starts,
              const uint8_t* __restrict__ okrows, uint8_t* flag, int C,
              int n, long long N) {
    const long long r = blockIdx.x;          // row b * C + c
    const int b = (int)(r / C);
    const int c = (int)(r % C);
    if (!okrows[b]) return;
    long long s = starts[b];
    s = s < 0 ? 0 : (s > N - n ? N - n : s);
    const int lo = blockIdx.y * kTile;
    const int hi = min(n, lo + kTile);
    const int32_t* o = out + r * n + lo;
    const int32_t* e = expected + c * N + s + lo;
    const int len = hi - lo;
    bool bad = false;
    if ((((uintptr_t)o | (uintptr_t)e) & 15) == 0) {
        const int nv = len >> 2;
        const int4* o4 = reinterpret_cast<const int4*>(o);
        const int4* e4 = reinterpret_cast<const int4*>(e);
        for (int j = threadIdx.x; j < nv; j += kThreads) {
            const int4 a = __ldg(o4 + j);
            const int4 x = __ldg(e4 + j);
            bad |= (a.x != x.x) | (a.y != x.y) | (a.z != x.z) | (a.w != x.w);
        }
        for (int i = (nv << 2) + threadIdx.x; i < len; i += kThreads)
            bad |= __ldg(o + i) != __ldg(e + i);
    } else {
        int i = threadIdx.x;
        for (; i + 3 * kThreads < len; i += 4 * kThreads) {
            const int32_t a0 = __ldg(o + i), a1 = __ldg(o + i + kThreads);
            const int32_t a2 = __ldg(o + i + 2 * kThreads);
            const int32_t a3 = __ldg(o + i + 3 * kThreads);
            const int32_t x0 = __ldg(e + i), x1 = __ldg(e + i + kThreads);
            const int32_t x2 = __ldg(e + i + 2 * kThreads);
            const int32_t x3 = __ldg(e + i + 3 * kThreads);
            bad |= (a0 != x0) | (a1 != x1) | (a2 != x2) | (a3 != x3);
        }
        for (; i < len; i += kThreads) bad |= __ldg(o + i) != __ldg(e + i);
    }
    if (__syncthreads_or(bad) && threadIdx.x == 0) *flag = 0;
}

}  // namespace

extern "C" int srla_verify_blocks(const void* out, const void* expected,
                                  const void* starts, const void* okrows,
                                  void* flag, int B, int C, int n,
                                  long long N, void* stream) {
    const dim3 grid((unsigned)((long long)B * C),
                    (unsigned)((n + kTile - 1) / kTile));
    verify_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)out, (const int32_t*)expected, (const int32_t*)starts,
        (const uint8_t*)okrows, (uint8_t*)flag, C, n, N);
    return (int)cudaGetLastError();
}
