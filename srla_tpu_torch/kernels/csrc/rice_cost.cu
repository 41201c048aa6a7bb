// K15: the f32 Rice cost of the approximate encode, in one launch.
//
// Replaces srla_tpu/kernels/encode.py:288 _rice_cost, which the TPU runs as
// an XLA program with a static loop over partition orders. For each row of
// the (V, n) int32 residual and partition orders p = 0..max_porder
// (partition j of order p: n >> p samples from j * (n >> p)) it computes:
//
//   1. u = zigzag(residual) as uint32; the row's code type: ALLZERO (2)
//      when every u is 0, else recursive Rice (1) when the row mean
//      f32(sum u) / n is at least 2, else plain Rice (0);
//   2. each partition's mean m = f32(sum u) / f32(n >> p), the sum exact
//      (64-bit) and rounded once to f32. JAX sums the f32 codes in XLA's
//      order (encode.py:295, :307): the means here differ from JAX's by a
//      few ulps, which the approximate encode's contract allows, and the
//      kernel and the plain version agree bit for bit whatever order each
//      adds in;
//   3. each partition's parameter in f32 (encode.py:309-321): recursive k =
//      clip(floor(log2(max(1, MLNOPTX (1 + m)))), 0, 30); plain k =
//      clip(rint(log2(max(-MLNOPTX / log(max(1 - 1/(1+m), 1e-30)),
//      1e-30))), 0, 30), rint half to even as jnp.round, 0 where not
//      finite;
//   4. each order's bits: 15 (the order field and the first parameter) +
//      sum over partitions of the section's exact packed length with its k,
//        plain Rice:      (u >> k) + k + 1                 a sample
//        recursive Rice:  k + 2 + (u >= 2^(k+1) ? (u - 2^(k+1)) >> k : 0)
//      + sum_{j>0} (zigzag(k_j - k_{j-1}) + 1), the unary parameter deltas;
//      the first order whose bits are strictly below the best so far (from
//      2^30) wins; an ALLZERO row takes order 0 and bits 0.
//   JAX reads the codes as int32 (encode.py:306), so a code of 2^31 or more
//   is negative there and its rice_bits/rec_bits are not the packed
//   length. The port counts the packed length, so that the section the
//   encoder frames from these bits is the one K5 packs and the stream
//   stays lossless; below 2^31 (every residual of a 24-bit file that the
//   FIR does not wrap) the two are equal.
//
// Outputs: code_type, porder (V,) int64, bits (V,) int32 (the section's
// bits + 2 for the code type), ks (V, 2^max_porder) int64, the chosen
// order's parameters zero-padded: the types K5 and the stereo selection
// read.
//
// Bit equality with the plain version (rice_cost.py rice_cost_plain) on the
// card: the f32 steps are the _rn intrinsics, IEEE division and the CUDA
// math library's logf/log2f/rintf/floorf that torch's CUDA ops call
// (built with -fmad=false, no fast math); the sums are exact integers.
//
// What bounds it on an H100: one read of the residual (85 MB at the main
// path's group, V 5164 x n 4096) and the ks' write (42 MB int64 at 1024
// columns): 0.038 ms at 3.35 TB/s; beside (max_porder + 1) terms a sample
// (a shift, for recursive rows also a compare and a subtract, and a 64-bit
// add): 0.23 G sample-orders at the main shape.
//
// Design (simple first): one CTA of 256 threads a row. Each thread takes a
// contiguous run of ceil(n / 256) samples, read twice from global memory
// (the second pass hits L1/L2):
//   - pass 1: the leaf sums (leaves of n >> max_porder samples), each
//     thread adding its run leaf by leaf and flushing a leaf's sum with one
//     shared 64-bit atomic, so a row takes at most 256 + 2^max_porder;
//   - the partition sums of coarser orders pairwise from the leaves (a heap
//     in shared memory, order p's partition j at 2^p - 1 + j), then every
//     partition's parameter, a thread a partition;
//   - each order's parameter bits by a warp an order (lanes over its
//     partitions, a shuffle reduction);
//   - pass 2: every order's sample terms at once, a 64-bit register sum an
//     order, with the thread's current partition's parameters re-read at
//     each leaf it crosses; a warp reduction and one shared atomic a warp
//     and order;
//   - thread 0 picks the order; the CTA writes the ks row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOrder = 10;
constexpr int kHeap = (2 << kMaxOrder) - 1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t zigzag(int32_t x) {
    return ((uint32_t)x << 1) ^ (uint32_t)(x >> 31);
}

__device__ __forceinline__ float clamp30(float k) {
    k = k < 0.0f ? 0.0f : k;
    return k > 30.0f ? 30.0f : k;
}

// encode.py:309-310.
__device__ __forceinline__ int k_recursive(float m, float mlnoptx) {
    float g = __fmul_rn(mlnoptx, __fadd_rn(1.0f, m));
    g = g < 1.0f ? 1.0f : g;
    return (int)clamp30(floorf(log2f(g)));
}

// encode.py:316-321 (neg_mlnoptx = -MLNOPTX in f32).
__device__ __forceinline__ int k_plain(float m, float neg_mlnoptx) {
    const float rho = __fdiv_rn(1.0f, __fadd_rn(1.0f, m));
    float om = __fsub_rn(1.0f, rho);
    om = om < 1e-30f ? 1e-30f : om;
    float lv = __fdiv_rn(neg_mlnoptx, logf(om));
    lv = lv < 1e-30f ? 1e-30f : lv;
    float kf = rintf(log2f(lv));
    kf = isfinite(kf) ? kf : 0.0f;
    return (int)clamp30(kf);
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    return v;
}

template <bool REC>
__device__ __forceinline__ uint32_t term(uint32_t u, int k) {
    if (REC) {
        const uint32_t k1pow = 2u << k;       // k <= 30: at most 2^31
        return u >= k1pow ? (u - k1pow) >> k : 0u;
    }
    return u >> k;
}

// Pass 2: every order's sample terms of this thread's run, added to
// obits[p] (a warp reduction and one atomic a warp and order).
template <bool REC>
__device__ __forceinline__ void sample_terms(
        const int32_t* __restrict__ row, int s0, int s1, int nsl, int P,
        const int* kheap, unsigned long long* obits) {
    unsigned long long acc[kMaxOrder + 1];
    int kcur[kMaxOrder + 1];
#pragma unroll
    for (int p = 0; p <= kMaxOrder; ++p) acc[p] = 0ull;
    if (s0 < s1) {
        int leaf = s0 / nsl;
        int left = nsl * (leaf + 1) - s0;
#pragma unroll
        for (int p = 0; p <= kMaxOrder; ++p)
            if (p <= P) kcur[p] = kheap[(1 << p) - 1 + (leaf >> (P - p))];
        for (int s = s0; s < s1; ++s) {
            const uint32_t u = zigzag(row[s]);
#pragma unroll
            for (int p = 0; p <= kMaxOrder; ++p)
                if (p <= P) acc[p] += term<REC>(u, kcur[p]);
            if (--left == 0 && s + 1 < s1) {
                ++leaf;
                left = nsl;
#pragma unroll
                for (int p = 0; p <= kMaxOrder; ++p)
                    if (p <= P)
                        kcur[p] = kheap[(1 << p) - 1 + (leaf >> (P - p))];
            }
        }
    }
#pragma unroll
    for (int p = 0; p <= kMaxOrder; ++p) {
        if (p <= P) {
            const unsigned long long v = warp_sum(acc[p]);
            if ((threadIdx.x & 31) == 0 && v) atomicAdd(&obits[p], v);
        }
    }
}

__global__ void __launch_bounds__(kThreads)
rice_cost_kernel(const int32_t* __restrict__ residual,
                 int64_t* __restrict__ code_type, int64_t* __restrict__ porder,
                 int32_t* __restrict__ bits, int64_t* __restrict__ ks, int n,
                 int P, float mlnoptx, float neg_mlnoptx, int head_bits) {
    __shared__ unsigned long long psum[kHeap];
    __shared__ int kheap[kHeap];
    __shared__ unsigned long long obits[kMaxOrder + 1];
    __shared__ int best_p;
    const int t = threadIdx.x;
    const int lane = t & 31, warp = t >> 5;
    const int32_t* row = residual + (size_t)blockIdx.x * n;
    const int nleaf = 1 << P;
    const int nsl = n >> P;
    for (int j = t; j < nleaf; j += kThreads) psum[nleaf - 1 + j] = 0ull;
    if (t <= kMaxOrder) obits[t] = 0ull;
    __syncthreads();

    // Pass 1: leaf sums.
    const int run = (n + kThreads - 1) / kThreads;
    const int s0 = min(n, t * run), s1 = min(n, s0 + run);
    if (s0 < s1) {
        int leaf = s0 / nsl;
        int left = nsl * (leaf + 1) - s0;
        unsigned long long acc = 0ull;
        for (int s = s0; s < s1; ++s) {
            acc += zigzag(row[s]);
            if (--left == 0) {
                if (acc) atomicAdd(&psum[nleaf - 1 + leaf], acc);
                acc = 0ull;
                ++leaf;
                left = nsl;
            }
        }
        if (acc) atomicAdd(&psum[nleaf - 1 + leaf], acc);
    }
    __syncthreads();
    for (int p = P - 1; p >= 0; --p) {
        const int first = (1 << p) - 1, child = (2 << p) - 1;
        for (int j = t; j < (1 << p); j += kThreads)
            psum[first + j] = psum[child + 2 * j] + psum[child + 2 * j + 1];
        __syncthreads();
    }
    const unsigned long long total = psum[0];
    const bool allzero = total == 0ull;
    const bool rec = __fdiv_rn(__ull2float_rn(total), (float)n) >= 2.0f;

    // Every partition's parameter.
    const int heap = (2 << P) - 1;
    for (int e = t; e < heap; e += kThreads) {
        const int p = 31 - __clz(e + 1);
        const float m = __fdiv_rn(__ull2float_rn(psum[e]), (float)(n >> p));
        kheap[e] = rec ? k_recursive(m, mlnoptx) : k_plain(m, neg_mlnoptx);
    }
    __syncthreads();

    // Each order's parameter bits: (k + 2 or + 1) a sample of a partition,
    // then the deltas' unary codes.
    for (int p = warp; p <= P; p += kWarps) {
        const int first = (1 << p) - 1;
        const long long len = n >> p;
        unsigned long long v = 0ull;
        for (int j = lane; j < (1 << p); j += 32) {
            const int k = kheap[first + j];
            v += (unsigned long long)((k + (rec ? 2 : 1)) * len);
            if (j > 0) {
                const int d = k - kheap[first + j - 1];
                v += (unsigned long long)(((uint32_t)d << 1)
                                          ^ (uint32_t)(d >> 31)) + 1ull;
            }
        }
        v = warp_sum(v);
        if (lane == 0) atomicAdd(&obits[p], v);
    }

    if (!allzero) {
        if (rec) sample_terms<true>(row, s0, s1, nsl, P, kheap, obits);
        else sample_terms<false>(row, s0, s1, nsl, P, kheap, obits);
    }
    __syncthreads();

    if (t == 0) {
        long long best = 1ll << 30;
        int bp = 0;
        for (int p = 0; p <= P; ++p) {
            const long long b = head_bits + (long long)obits[p];
            if (b < best) {
                best = b;
                bp = p;
            }
        }
        best_p = bp;
        const int r = blockIdx.x;
        code_type[r] = allzero ? 2 : (rec ? 1 : 0);
        porder[r] = allzero ? 0 : bp;
        bits[r] = (int32_t)((allzero ? 0 : best) + 2);
    }
    __syncthreads();
    const int bp = best_p;
    const int maxp = 1 << P;
    int64_t* krow = ks + (size_t)blockIdx.x * maxp;
    for (int j = t; j < maxp; j += kThreads)
        krow[j] = j < (1 << bp) ? kheap[(1 << bp) - 1 + j] : 0;
}

}  // namespace

extern "C" int srla_rice_cost(const void* residual, void* code_type,
                              void* porder, void* bits, void* ks, int V,
                              int n, int max_porder, float mlnoptx,
                              float neg_mlnoptx, int head_bits, void* stream) {
    if (V <= 0) return 0;
    rice_cost_kernel<<<V, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)residual, (int64_t*)code_type, (int64_t*)porder,
        (int32_t*)bits, (int64_t*)ks, n, max_porder, mlnoptx, neg_mlnoptx,
        head_bits);
    return (int)cudaGetLastError();
}
