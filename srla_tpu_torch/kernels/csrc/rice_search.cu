// K4: per-partition Rice bit sums for every partition order of a row.
//
// Replaces the hot loop of srla_tpu/kernels/exact.py:_rice_exact (:521-550),
// which the TPU runs as XLA reductions, one per partition order. For each
// row r, each partition order p = 0..max_porder and each partition j of it
// (nsmpl = n >> p samples), with k = ks[r, 2^p - 1 + j]:
//
//   plain Rice:      sum_s  u[s] >> k
//   recursive Rice:  sum_s  max((int32)(u[s] - 2^(k+1)), 0) >> k
//
// (recursive when rec[r] != 0). u are the zigzagged residuals as uint32 bit
// patterns; 2^(k+1) is computed in uint32 and is 0 at k = 31, as the XLA
// shift gives; shifts by >= 32 give 0. The per-partition k, the choice of
// code type, the porder argmin and the k deltas stay PyTorch ops. Sums wrap
// mod 2^32 as the JAX package's int32 sums do (they cannot overflow for the
// k the analysis picks: each term is about u / 2^k <= 2 * mean / mean).
//
// What bounds it on an H100: (max_porder + 1) shift-and-add passes over
// each sample (11 x 4096 per row at the main path) and one read of the
// (V, n) int32 plane: about 0.23 G operations for 5164 rows. Design: one
// block of 256 threads per row; threads stride over samples, so a warp
// reads 32 consecutive samples (coalesced). The 2^(max_porder+1) - 1
// partition ks and sums (at most 2047 each) live in shared memory. Where a
// partition spans whole warps (nsmpl a multiple of 32) a warp first reduces
// its 32 terms with __reduce_add_sync and one lane adds the result with a
// shared atomic; for finer partitions every lane adds its own term.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t shr(uint32_t x, int k) {
    return k >= 32 ? 0u : x >> k;
}

__global__ void rice_search_kernel(const int32_t* __restrict__ u,
                                   const int32_t* __restrict__ ks,
                                   const int32_t* __restrict__ rec,
                                   int32_t* __restrict__ out, int n,
                                   int max_porder) {
    extern __shared__ uint32_t smem[];
    const int P = (2 << max_porder) - 1;
    uint32_t* sums = smem;
    int32_t* k = (int32_t*)(smem + P);
    const long long row = blockIdx.x;
    const int t = threadIdx.x;
    const int lane = t & 31;
    for (int i = t; i < P; i += kThreads) {
        sums[i] = 0u;
        const int kk = ks[row * P + i];
        k[i] = kk < 0 ? 32 : kk;           // negative: treat as a shift >= 32
    }
    __syncthreads();
    const bool recursive = rec[row] != 0;
    const int32_t* ur = u + row * n;
    // Every lane of a warp runs the same iterations (lanes past n add 0),
    // so the full-mask warp reductions below are well defined.
    for (int base = t - lane; base < n; base += kThreads) {
        const int s = base + lane;
        const bool live = s < n;
        const uint32_t v = live ? (uint32_t)ur[s] : 0u;
        for (int p = 0; p <= max_porder; ++p) {
            const int nsmpl = n >> p;
            const int first = (1 << p) - 1;
            const int idx = first + (live ? s : base) / nsmpl;
            const int kk = k[idx];
            uint32_t c;
            if (recursive) {
                const uint32_t k1pow = kk + 1 >= 32 ? 0u : (1u << (kk + 1));
                const int32_t d = (int32_t)(v - k1pow);
                c = d > 0 ? shr((uint32_t)d, kk) : 0u;
            } else {
                c = shr(v, kk);
            }
            if (!live) c = 0u;
            if ((nsmpl & 31) == 0) {
                const uint32_t w = __reduce_add_sync(0xffffffffu, c);
                if (lane == 0) atomicAdd(&sums[idx], w);
            } else if (live) {
                atomicAdd(&sums[idx], c);
            }
        }
    }
    __syncthreads();
    for (int i = t; i < P; i += kThreads) {
        out[row * P + i] = (int32_t)sums[i];
    }
}

}  // namespace

// u: (V, n) int32; ks, out: (V, 2^(max_porder+1) - 1) int32; rec: (V,) int32.
// n must be a multiple of 2^max_porder.
extern "C" int srla_rice_search(const void* u, const void* ks,
                                const void* rec, void* out, int V, int n,
                                int max_porder, void* stream) {
    const int P = (2 << max_porder) - 1;
    const size_t smem = 2ull * P * sizeof(uint32_t);
    rice_search_kernel<<<V, kThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)u, (const int32_t*)ks, (const int32_t*)rec,
        (int32_t*)out, n, max_porder);
    return (int)cudaGetLastError();
}
