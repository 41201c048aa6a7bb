// K9: the decode's long-term-prediction (pitch) synthesis.
//
// Replaces the XLA scan srla_tpu/kernels/decode2.py:_ltp_pass (step :641)
// and computes, per row r, what kernels/ltp.py:ltp_synth_plain computes:
//
//   y[s] = v[s] + ((16 + sum_{i < taps} c[i] * y[s - delay + i]) >> 5)
//                                                     for s >= delay + 1
//   y[s] = v[s]                                       otherwise
//
// delay = period + order / 2, taps = min(order, L); rows with period or
// order 0 are copied through. The sum wraps mod 2^32: it is done in
// uint32_t and only the shift reinterprets it as int32_t (PERF.md,
// "Wrapping int32 in C++"). y reads its own earlier outputs, never v.
//
// What bounds it on an H100: the recurrence. y[s] waits on y[s - delay +
// taps - 1], so w = delay - taps + 1 consecutive samples depend only on
// outputs before them and a row takes about n / w dependent steps (w >= 7
// in a valid stream: 585 steps for 4096 samples at the shortest period,
// 128 at the main path's ~225). The bytes (v in, y out) are small beside
// that chain; its floor is a step's latency (csrc/chain_probe.cu, kind 4)
// times the steps of the row that has the most.
//
// Design: one warp per row and per CTA, and the chain touches only shared
// memory and registers. Each warp owns a ring of 2048 samples in
// shared memory (8 KB), four chunks of 512. The row's v is staged chunk by
// chunk with cp.async; when the steps reach chunk t, chunks t and t + 1
// have landed and t + 2 is in flight. The steps overwrite each staged v[s]
// with y[s] in place (y[s] reads y[s - delay + i], all earlier, and v[s]
// itself), resolving w = min(32, delay - taps + 1) samples a step, one a
// lane, continuously across chunks (a step that starts in chunk t may reach
// into t + 1). Once no step starts in chunk t any more, it goes back to
// device memory in 16-byte stores, and its slots stay as history for t + 1
// and then take chunk t + 3. A chunk holds more than the largest delay
// (263), so the history a step reads is in its chunk or the one before.
//
// Rows with period or order 0 run the pipeline with no steps: a copy.
// Rows overlap across the warps of an SM (up to 28 CTAs of 8 KB), so one
// row's staging hides behind others' steps. A step's shared-memory accesses
// go through the ring's 32-bit shared address (lds, sts). Rows whose length
// is no multiple of 4 (or unaligned tensors) take 4-byte copies and stores
// instead of 16-byte ones.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 1;                 // rows (warps) per CTA
constexpr int kChunk = 512;
constexpr int kChunks = 4;                // ring slots, in chunks
constexpr int kRing = kChunk * kChunks;
constexpr int kAhead = kChunks - 1;       // chunks staged before the first
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(uint32_t* dst, const int32_t* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const int32_t* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kAhead - 2 of this thread's groups are in flight: the
// two oldest, the chunk about to be stepped and the next (into which its
// last step may reach), have landed.
__device__ __forceinline__ void cp_async_wait_landed() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kAhead - 2) : "memory");
}

// Ring slot i (mod kRing) at the ring's 32-bit shared address rs. Through a
// 32-bit shared address the step's loads are plain LDS off one base; as
// C++ array accesses on the ring the compiler re-derived the shared window
// in the loop and the step took twice as long.
__device__ __forceinline__ uint32_t lds(unsigned rs, int i) {
    uint32_t v;
    asm volatile("ld.shared.u32 %0, [%1];"
                 : "=r"(v) : "r"(rs + 4u * (unsigned)(i & (kRing - 1))));
    return v;
}

__device__ __forceinline__ void sts(unsigned rs, int i, uint32_t v) {
    asm volatile("st.shared.u32 [%0], %1;"
                 :: "r"(rs + 4u * (unsigned)(i & (kRing - 1))), "r"(v)
                 : "memory");
}

// Stage chunk t of x into its ring slots (nothing past n; an empty group
// past the end keeps the group count uniform).
template <bool kVec>
__device__ __forceinline__ void stage(uint32_t* ring, const int32_t* x,
                                      int t, int n, int lane) {
    const int lo = t * kChunk;
    const int len = n - lo < kChunk ? n - lo : kChunk;
    uint32_t* dst = ring + (t % kChunks) * kChunk;
    if (kVec) {
        for (int k = 4 * lane; k < len; k += 128)
            cp_async16(dst + k, x + lo + k);
    } else {
        for (int k = lane; k < len; k += 32) cp_async4(dst + k, x + lo + k);
    }
    cp_async_commit();
}

template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
ltp_synth_kernel(const int32_t* __restrict__ v,
                 const int32_t* __restrict__ orders,
                 const int32_t* __restrict__ periods,
                 const int32_t* __restrict__ coefs,
                 int32_t* __restrict__ out, int R, int n, int L) {
    __shared__ __align__(16) uint32_t ring_all[kWarps][kRing];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long row = (long long)blockIdx.x * kWarps + warp;
    if (row >= R) return;                       // the whole warp leaves
    const int32_t* x = v + row * n;
    int32_t* y = out + row * n;
    uint32_t* ring = ring_all[warp];
    const int order = orders[row];
    const int period = periods[row];
    const bool on = period > 0 && order > 0;
    const int taps = order < L ? order : L;
    const int delay = period + (order >> 1);
    int w = delay - taps + 1;
    w = w > 32 ? 32 : (w < 1 ? 1 : w);
    // Three taps on every row, without a branch: a tap past the row's
    // order re-reads tap 0's slot with a zero coefficient (the sum wraps,
    // so adding 0 changes nothing).
    uint32_t c[3];
    int tap[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        c[i] = on && i < taps ? (uint32_t)coefs[row * L + i] : 0u;
        tap[i] = i < taps ? i : 0;
    }
    const int nchunks = (n + kChunk - 1) / kChunk;
    const unsigned rs = (unsigned)__cvta_generic_to_shared(ring);
    int s0 = delay + 1;                        // the first step
#pragma unroll
    for (int t = 0; t < kAhead; ++t) stage<kVec>(ring, x, t, n, lane);

    for (int t = 0; t < nchunks; ++t) {
        cp_async_wait_landed();                 // chunks t and t + 1
        __syncwarp(kFull);
        const int lo = t * kChunk;
        const int hi = n - lo < kChunk ? n : lo + kChunk;
        if (on) {
            // The steps that start in this chunk; the last may reach into
            // the next, which has landed too. Every lane computes; only the
            // step's w lanes (and none past n) store.
            // Unrolled, the next step's addressing overlaps this one's
            // chain.
#pragma unroll 4
            for (; s0 < hi; s0 += w) {
                const int s = s0 + lane;
                const int base = s - delay;
                const uint32_t t0 = lds(rs, base + tap[0]);
                const uint32_t t1 = lds(rs, base + tap[1]);
                const uint32_t t2 = lds(rs, base + tap[2]);
                const uint32_t own = lds(rs, s);
                const uint32_t acc = 16u + c[0] * t0 + c[1] * t1 + c[2] * t2;
                if (lane < w && s < n)          // 16 = 1 << (5 - 1)
                    sts(rs, s, own + (uint32_t)((int32_t)acc >> 5));
                __syncwarp(kFull);              // this step's outputs land
            }
        }
        // Chunk t out, then its slots stay as history for chunk t + 1; the
        // slots of chunk t - 1 take chunk t + kAhead.
        const uint32_t* src = ring + (t % kChunks) * kChunk;
        if (kVec) {
            for (int k = 4 * lane; k < hi - lo; k += 128)
                *reinterpret_cast<uint4*>(y + lo + k) =
                    *reinterpret_cast<const uint4*>(src + k);
        } else {
            for (int k = lane; k < hi - lo; k += 32)
                y[lo + k] = (int32_t)src[k];
        }
        __syncwarp(kFull);
        stage<kVec>(ring, x, t + kAhead, n, lane);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace

// v, out: (R, n) int32; orders, periods: (R,) int32; coefs: (R, L) int32,
// 1 <= L <= 3.
extern "C" int srla_ltp_synth(const void* v, const void* orders,
                              const void* periods, const void* coefs,
                              void* out, int R, int n, int L, void* stream) {
    if (L < 1 || L > 3) return (int)cudaErrorInvalidValue;
    const int blocks = (R + kWarps - 1) / kWarps;
    const bool vec = n % 4 == 0 && (uintptr_t)v % 16 == 0
        && (uintptr_t)out % 16 == 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (vec)
        ltp_synth_kernel<true><<<blocks, kWarps * 32, 0, s>>>(
            (const int32_t*)v, (const int32_t*)orders,
            (const int32_t*)periods, (const int32_t*)coefs, (int32_t*)out, R,
            n, L);
    else
        ltp_synth_kernel<false><<<blocks, kWarps * 32, 0, s>>>(
            (const int32_t*)v, (const int32_t*)orders,
            (const int32_t*)periods, (const int32_t*)coefs, (int32_t*)out, R,
            n, L);
    return (int)cudaGetLastError();
}
