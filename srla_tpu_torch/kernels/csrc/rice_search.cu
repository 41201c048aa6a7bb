// K4: per-partition Rice bit sums for every partition order of a row.
//
// Replaces the hot loop of srla_tpu/kernels/exact.py:_rice_exact (:521-550),
// which the TPU runs as XLA reductions, one per partition order. For each
// row r, each partition order p = 0..max_porder and each partition j of it
// (n >> p samples), with k = ks[r, 2^p - 1 + j]:
//
//   plain Rice:      sum_s  u[s] >> k
//   recursive Rice:  sum_s  max((int32)(u[s] - 2^(k+1)), 0) >> k
//
// (recursive when rec[r] != 0). u are the zigzagged residuals as uint32 bit
// patterns. The per-partition k, the choice of code type, the porder argmin
// and the k deltas stay PyTorch ops.
//
// Edge rules, all XLA's values: 2^(k+1) is computed in uint32 and is 0 at
// k = 31; a shift by 32 or more gives 0 (a funnel shift that clamps its
// count, so no select); a negative k counts as a shift >= 32. Sums wrap mod
// 2^32 as the JAX package's int32 sums do (they cannot overflow for the k
// the analysis picks: each term is about u / 2^k <= 2 * mean / mean).
//
// What bounds it on an H100: one read of the (V, n) int32 plane (169 MB at
// the main path's V = 5164, n = 4096: 0.05 ms at 3.35 TB/s) beside
// (max_porder + 1) passes of a shift and an add (a subtract and a max more
// on recursive rows) over each sample: 0.23 G sample-orders, 2 to 4 integer
// operations each, about as long at the INT32 rate. Every term depends on
// its partition's k, so no order's sums can be formed from a finer order's:
// the passes are the work, and the design spends nothing else per sample.
//
// Layout, rows whose n is a power of two in 128..16384 (rice_rows_pow2):
// one CTA a row, n / S threads (S = 4, 8, 16 or 32 samples a thread; 256
// threads from n = 1024 to 8192, 512 at 16384). A thread loads its S
// consecutive samples once with 128-bit loads and keeps them in registers;
// the row's ks are staged into shared memory with coalesced loads, as a
// heap (order p's partition j at 2^p + j), so that a thread's run of ks or
// sums is aligned for one vector access. Then, per order, by the
// partition's length against the run:
//   - at most S samples: the thread's S / length partitions are summed in
//     registers and stored straight to the shared sums, no exchange;
//   - 2..32 threads: each thread sums its S terms, an xor-shuffle butterfly
//     over exactly the partition's lanes adds them, its first lane stores;
//   - several warps (orders with fewer partitions than the CTA has warps):
//     a warp reduction and one shared atomicAdd a warp.
// No division, no index arithmetic per sample; the row kind picks one of
// two bodies outside every loop.
//
// Any other shape (rice_rows_generic: the tail group's n = 4064 with
// leaves of 127, n < 128, n > 16384): one CTA of eight warps a row, and the
// same idea with a warp in the thread's place. A warp owns an eighth of the
// row, a whole number of leaves (where the row has fewer than eight leaves,
// a slice of one). For orders 0..3 its samples lie in one partition each:
// one pass sums their terms for these orders side by side in registers,
// then a warp reduction and one shared atomicAdd an order. For finer orders
// the warp owns whole partitions: it sums each with its lanes striding over
// the samples and one reduction, or, where a partition is shorter than a
// warp, a lane sums a partition alone; either way a plain store. No
// division and no index arithmetic per sample, no atomic per lane. Samples
// are read once per finer order, from L1 after the first pass.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGenericThreads = 256;
constexpr int kGenericWarps = kGenericThreads / 32;
// Orders 0 .. kCoarse - 1 have at most one partition a warp of the generic
// kernel: log2(kGenericWarps) + 1.
constexpr int kCoarse = 4;

// x >> k for k in 0..32; 32 gives 0.
__device__ __forceinline__ uint32_t shr(uint32_t x, int k) {
    return __funnelshift_rc(x, 0u, (uint32_t)k);
}

// A parameter as the kernels use it: negative or above 32 is a shift by 32.
__device__ __forceinline__ int staged_k(int k) {
    return (k < 0 || k > 32) ? 32 : k;
}

// 2^(k+1) in uint32: 0 from k = 31 up.
__device__ __forceinline__ uint32_t pow_k1(int k) {
    return k >= 31 ? 0u : (2u << k);
}

template <bool REC>
__device__ __forceinline__ uint32_t term(uint32_t v, int k, uint32_t k1pow) {
    if (REC) {
        const int32_t d = (int32_t)(v - k1pow);
        return shr((uint32_t)max(d, 0), k);
    }
    return shr(v, k);
}

// CNT consecutive 32-bit values of shared memory, aligned to CNT words.
template <int CNT>
__device__ __forceinline__ void load_run(const int32_t* p, int32_t (&x)[CNT]) {
    if constexpr (CNT >= 4) {
#pragma unroll
        for (int i = 0; i < CNT / 4; ++i) {
            const int4 q = reinterpret_cast<const int4*>(p)[i];
            x[4 * i] = q.x; x[4 * i + 1] = q.y;
            x[4 * i + 2] = q.z; x[4 * i + 3] = q.w;
        }
    } else if constexpr (CNT == 2) {
        const int2 q = *reinterpret_cast<const int2*>(p);
        x[0] = q.x; x[1] = q.y;
    } else {
        x[0] = *p;
    }
}

template <int CNT>
__device__ __forceinline__ void store_run(uint32_t* p,
                                          const uint32_t (&x)[CNT]) {
    if constexpr (CNT >= 4) {
#pragma unroll
        for (int i = 0; i < CNT / 4; ++i) {
            reinterpret_cast<uint4*>(p)[i] = make_uint4(
                x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
        }
    } else if constexpr (CNT == 2) {
        *reinterpret_cast<uint2*>(p) = make_uint2(x[0], x[1]);
    } else {
        *p = x[0];
    }
}

// Order p, partitions of 2^D <= S samples: thread t owns S >> D of them.
template <int S, int D, bool REC>
__device__ __forceinline__ void own_partitions(const uint32_t (&v)[S],
                                               const int32_t* sk,
                                               uint32_t* ssum, int t, int p) {
    constexpr int CNT = S >> D, LEN = 1 << D;
    const int at = (1 << p) + t * CNT;
    int32_t k[CNT];
    uint32_t sum[CNT];
    load_run<CNT>(sk + at, k);
#pragma unroll
    for (int j = 0; j < CNT; ++j) {
        const uint32_t k1pow = pow_k1(k[j]);
        uint32_t a = 0u;
#pragma unroll
        for (int e = 0; e < LEN; ++e) {
            a += term<REC>(v[j * LEN + e], k[j], k1pow);
        }
        sum[j] = a;
    }
    store_run<CNT>(ssum + at, sum);
}

// The orders whose partitions lie inside one thread's run, finest first;
// dmin is log2 of the finest partition's length.
template <int S, int D, bool REC>
__device__ __forceinline__ void own_orders(const uint32_t (&v)[S],
                                           const int32_t* sk, uint32_t* ssum,
                                           int t, int L, int dmin) {
    if (D >= dmin) own_partitions<S, D, REC>(v, sk, ssum, t, L - D);
    if constexpr ((2 << D) <= S) {
        own_orders<S, D + 1, REC>(v, sk, ssum, t, L, dmin);
    }
}

// The thread's S terms of one partition that spans 2^i threads.
template <int S, bool REC>
__device__ __forceinline__ uint32_t run_sum(const uint32_t (&v)[S],
                                            const int32_t* sk, int idx) {
    const int k = sk[idx];
    const uint32_t k1pow = pow_k1(k);
    uint32_t a = 0u;
#pragma unroll
    for (int e = 0; e < S; ++e) a += term<REC>(v[e], k, k1pow);
    return a;
}

template <int S, bool REC>
__device__ __forceinline__ void row_sums(const uint32_t (&v)[S],
                                         const int32_t* sk, uint32_t* ssum,
                                         int t, int L, int max_porder) {
    constexpr int LS = S == 4 ? 2 : S == 8 ? 3 : S == 16 ? 4 : 5;
    const int lane = t & 31;
    const int dmin = L - max_porder;
    own_orders<S, 0, REC>(v, sk, ssum, t, L, dmin);
    // Partitions of 2..32 threads: a butterfly over the partition's lanes.
#pragma unroll
    for (int i = 1; i <= 5; ++i) {
        const int d = LS + i;
        if (d >= dmin) {                        // uniform over the launch
            const int idx = (1 << (L - d)) + (t >> i);
            uint32_t a = run_sum<S, REC>(v, sk, idx);
            if (i == 5) {
                a = __reduce_add_sync(kFull, a);
            } else {
#pragma unroll
                for (int o = 1; o < (1 << i); o <<= 1) {
                    a += __shfl_xor_sync(kFull, a, o);
                }
            }
            if ((lane & ((1 << i) - 1)) == 0) ssum[idx] = a;
        }
    }
    // Partitions of several warps: their sums were zeroed at staging.
    for (int d = LS + 6; d <= L; ++d) {
        if (d >= dmin) {
            const int idx = (1 << (L - d)) + (t >> (d - LS));
            const uint32_t a = __reduce_add_sync(
                kFull, run_sum<S, REC>(v, sk, idx));
            if (lane == 0) atomicAdd(&ssum[idx], a);
        }
    }
}

// n = 2^L = blockDim.x * S; u 16-byte aligned. Shared: the ks, then the
// sums, each a heap of max(4, 2^(max_porder+1)) slots (slot 0 unused).
// At S = 16 (n = 4096) six CTAs a SM (at most 40 registers a thread) read
// 5 % faster than the five that 48 registers leave (0.0854 against 0.0897
// ms at the main shape); at S = 32 the same bound reads a fifth slower.
template <int S>
__global__ void __launch_bounds__(S == 32 ? 512 : 256, S == 16 ? 6 : 1)
rice_rows_pow2(const int32_t* __restrict__ u, const int32_t* __restrict__ ks,
               const int32_t* __restrict__ rec, int32_t* __restrict__ out,
               int L, int max_porder) {
    extern __shared__ __align__(16) uint32_t smem[];
    const int P = (2 << max_porder) - 1;
    const int H = max(4, P + 1);
    int32_t* sk = reinterpret_cast<int32_t*>(smem);
    uint32_t* ssum = smem + H;
    const long long row = blockIdx.x;
    const int t = threadIdx.x, T = blockDim.x;
    uint32_t v[S];
    const int4* src = reinterpret_cast<const int4*>(u + (row << L)) +
                      t * (S / 4);
#pragma unroll
    for (int j = 0; j < S / 4; ++j) {
        const int4 q = __ldg(src + j);
        v[4 * j] = (uint32_t)q.x; v[4 * j + 1] = (uint32_t)q.y;
        v[4 * j + 2] = (uint32_t)q.z; v[4 * j + 3] = (uint32_t)q.w;
    }
    for (int i = t; i < P; i += T) sk[i + 1] = staged_k(ks[row * P + i]);
    // Orders with fewer partitions than warps sit in the slots below T / 32.
    if (t < (T >> 5) && t < H) ssum[t] = 0u;
    __syncthreads();
    if (rec[row] != 0) {
        row_sums<S, true>(v, sk, ssum, t, L, max_porder);
    } else {
        row_sums<S, false>(v, sk, ssum, t, L, max_porder);
    }
    __syncthreads();
    for (int i = t; i < P; i += T) out[row * P + i] = (int32_t)ssum[i + 1];
}

// The sums of one row of any length. Warp w of the CTA's eight owns the
// samples lo .. hi - 1: an eighth of the row (2^max_porder >= 8: a whole
// number of leaves), else a slice of the one leaf it shares with other
// warps.
template <bool REC>
__device__ __forceinline__ void generic_sums(const int32_t* __restrict__ ur,
                                             const int32_t* sk,
                                             uint32_t* ssum, int n,
                                             int max_porder, int t) {
    const int lane = t & 31, warp = t >> 5;
    int lo, hi;
    if ((1 << max_porder) >= kGenericWarps) {
        lo = warp * (n / kGenericWarps);
        hi = lo + n / kGenericWarps;
    } else {
        const int per = kGenericWarps >> max_porder;    // warps a leaf
        const int leaf = n >> max_porder;
        const int at = (warp / per) * leaf, i = warp % per;
        lo = at + (int)((long long)i * leaf / per);
        hi = at + (int)((long long)(i + 1) * leaf / per);
    }
    // Orders 0..3 (as far as max_porder goes): the warp's samples are all in
    // partition w >> (3 - p), so one pass sums their terms for these orders
    // side by side; a warp reduction and one atomicAdd an order follow.
    const int top = min(max_porder, kCoarse - 1);
    int k[kCoarse];
    uint32_t acc[kCoarse];
#pragma unroll
    for (int p = 0; p < kCoarse; ++p) {
        const int pp = min(p, top);             // past top: unused copies
        k[p] = sk[(1 << pp) - 1 + (warp >> (kCoarse - 1 - pp))];
        acc[p] = 0u;
    }
#pragma unroll 4
    for (int s = lo + lane; s < hi; s += 32) {
        const uint32_t v = (uint32_t)ur[s];
#pragma unroll
        for (int p = 0; p < kCoarse; ++p) {
            acc[p] += term<REC>(v, k[p], pow_k1(k[p]));
        }
    }
#pragma unroll
    for (int p = 0; p < kCoarse; ++p) {
        const uint32_t c = __reduce_add_sync(kFull, acc[p]);
        if (p <= top && lane == 0) {
            atomicAdd(&ssum[(1 << p) - 1 + (warp >> (kCoarse - 1 - p))], c);
        }
    }
    // Finer orders: the warp owns 2^(p-3) whole partitions and stores their
    // sums itself. A partition of 32 samples or more takes the warp (lanes
    // stride over it, one reduction); shorter ones take a lane each.
    for (int p = kCoarse; p <= max_porder; ++p) {
        const int size = n >> p;
        const int count = 1 << (p - (kCoarse - 1));
        const int first = (1 << p) - 1 + warp * count;
        if (size >= 32) {
            for (int j = 0; j < count; ++j) {
                const int kj = sk[first + j];
                const uint32_t k1pow = pow_k1(kj);
                const int from = lo + j * size;
                uint32_t a = 0u;
#pragma unroll 4
                for (int s = from + lane; s < from + size; s += 32) {
                    a += term<REC>((uint32_t)ur[s], kj, k1pow);
                }
                a = __reduce_add_sync(kFull, a);
                if (lane == 0) ssum[first + j] = a;
            }
        } else {
            for (int j = lane; j < count; j += 32) {
                const int kj = sk[first + j];
                const uint32_t k1pow = pow_k1(kj);
                const int from = lo + j * size;
                uint32_t a = 0u;
                for (int e = 0; e < size; ++e) {
                    a += term<REC>((uint32_t)ur[from + e], kj, k1pow);
                }
                ssum[first + j] = a;
            }
        }
    }
}

// Any n that 2^max_porder divides. Shared: P ks, then P sums, flat layout.
__global__ void __launch_bounds__(kGenericThreads)
rice_rows_generic(const int32_t* __restrict__ u,
                  const int32_t* __restrict__ ks,
                  const int32_t* __restrict__ rec, int32_t* __restrict__ out,
                  int n, int max_porder) {
    extern __shared__ __align__(16) uint32_t smem[];
    const int P = (2 << max_porder) - 1;
    int32_t* sk = reinterpret_cast<int32_t*>(smem);
    uint32_t* ssum = smem + P;
    const long long row = blockIdx.x;
    const int t = threadIdx.x;
    for (int i = t; i < P; i += kGenericThreads) {
        sk[i] = staged_k(ks[row * P + i]);
        ssum[i] = 0u;
    }
    __syncthreads();
    if (rec[row] != 0) {
        generic_sums<true>(u + row * n, sk, ssum, n, max_porder, t);
    } else {
        generic_sums<false>(u + row * n, sk, ssum, n, max_porder, t);
    }
    __syncthreads();
    for (int i = t; i < P; i += kGenericThreads) {
        out[row * P + i] = (int32_t)ssum[i];
    }
}

template <int S>
void launch_pow2(const int32_t* u, const int32_t* ks, const int32_t* rec,
                 int32_t* out, int V, int n, int L, int max_porder,
                 cudaStream_t stream) {
    const int H = (2 << max_porder) < 4 ? 4 : (2 << max_porder);
    rice_rows_pow2<S><<<V, n / S, 2ull * H * sizeof(uint32_t), stream>>>(
        u, ks, rec, out, L, max_porder);
}

}  // namespace

// u: (V, n) int32; ks, out: (V, 2^(max_porder+1) - 1) int32; rec: (V,) int32.
// n must be a multiple of 2^max_porder, max_porder in 0..10.
extern "C" int srla_rice_search(const void* u, const void* ks,
                                const void* rec, void* out, int V, int n,
                                int max_porder, void* stream) {
    const int32_t* pu = (const int32_t*)u;
    const int32_t* pk = (const int32_t*)ks;
    const int32_t* pr = (const int32_t*)rec;
    int32_t* po = (int32_t*)out;
    cudaStream_t st = (cudaStream_t)stream;
    const bool pow2 = (n & (n - 1)) == 0 && n >= 128 && n <= 16384 &&
                      ((uintptr_t)u & 15) == 0;
    if (pow2) {
        int L = 0;
        while ((1 << L) < n) ++L;
        switch (n >> 8) {                       // samples a thread
        case 64:
        case 32: launch_pow2<32>(pu, pk, pr, po, V, n, L, max_porder, st);
            break;
        case 16: launch_pow2<16>(pu, pk, pr, po, V, n, L, max_porder, st);
            break;
        case 8: launch_pow2<8>(pu, pk, pr, po, V, n, L, max_porder, st);
            break;
        default: launch_pow2<4>(pu, pk, pr, po, V, n, L, max_porder, st);
        }
    } else {
        const int P = (2 << max_porder) - 1;
        rice_rows_generic<<<V, kGenericThreads, 2ull * P * sizeof(uint32_t),
                            st>>>(pu, pk, pr, po, n, max_porder);
    }
    return (int)cudaGetLastError();
}
