// K4: the Rice parameter search of a row, in one launch.
//
// Replaces srla_tpu/kernels/exact.py:454 _rice_exact (:454-562), which the
// TPU runs as one XLA program. For each row of the (V, n) int32 residual and
// partition orders p = 0..max_porder (partition j of order p: n >> p
// samples from j * (n >> p)) it computes what _rice_exact returns:
//
//   1. u = zigzag(residual), in registers (no u plane in memory);
//   2. the exact leaf sums (leaves of n >> max_porder samples, 64-bit), each
//      leaf mean = sum / leaf length (one f64 rounding), then each coarser
//      order's means by pairwise halving, (a + b) / 2, as the host does;
//   3. the row mean picks recursive Rice at >= 2.0 (risky within 1e-9 of
//      2); each partition's parameter k is the count of the row's chain's
//      decision boundaries 1..31 at or below its mean (a binary search of
//      the ascending 33-entry table, the count searchsorted(right=True)
//      gives), flagged where the mean lies within the margin of either
//      neighbouring boundary or k reaches the chain's top (24 plain, 31
//      recursive), unless the mean is 0;
//   4. each partition's Rice sum with its k:
//        plain Rice:      sum_s  u[s] >> k
//        recursive Rice:  sum_s  max((int32)(u[s] - 2^(k+1)), 0) >> k
//      2^(k+1) in uint32 (0 from k = 31 on), a shift by 32 or more gives 0,
//      sums wrap mod 2^32 as the JAX package's int32 sums do;
//   5. per order the bits: header + sum_j ((int64)(int32)sum_j + (k_j + 2
//      or + 1) * (n >> p)) + sum_{j>0} (zigzag(k_j - k_{j-1}) + 1); the
//      first strict minimum from 1 << 30 wins (a row no order beats keeps
//      order 0 and zero ks); risky ORs the flags of every partition of
//      every order; an all-zero row is code type 2 with bits 2 and order 0
//      and keeps the ks the search chose.
//
// Outputs, the plain version's dtypes: code_type, porder, bits (+2) int64
// (V,), ks int64 (V, 2^max_porder) (the chosen order's, zero-padded),
// risky bool (V,). Only the chosen ks leave the CTA.
//
// f64: every operation on the means is an _rn intrinsic (no contraction:
// the means feed margins), and equals torch's f64 on the same values.
//
// What bounds it on an H100: one read of the int32 residual and one write
// of the ks (int64) and four values a row: 127 MB at the main path's group
// (V 5164, n 4096, porders 0..10), 0.038 ms at 3.35 TB/s; beside (max_porder
// + 1) passes of step 4 over each sample: 0.23 G sample-orders, 2 integer
// instructions each on plain rows (shift, add) and 3 on recursive ones
// (sm_90's DPX add-max __viaddmax_s32, shift, add), plus 5 a sample once
// (the zigzag's shift, shift and xor, the 64-bit leaf-sum add and its
// carry): 0.048 ms at the INT32 rate when every row is recursive (chip_smoke
// k4_bound). Every term depends on its partition's k, so no order's sums
// come from a finer order's: the passes are the work. Steps 2, 3 and 5 touch
// each of the 2^(max_porder+1) - 1 partitions a few times (about 20 f64 and
// integer operations each), under a tenth of step 4.
//
// Layout. One CTA a row. The row is read once into registers as a virtual
// row of n' = max(128, next power of two >= n) samples: each leaf of nsl =
// n >> max_porder samples is padded with zeros to nsl' = n' >> max_porder (a
// power of two), which add nothing to a leaf sum or a Rice sum (a zero's
// plain and recursive term is 0 at every k). Rows whose n is a power of two
// of at least 128, 16-byte aligned, have nsl' = nsl and take 128-bit loads;
// every other row takes one coalesced-across-lanes scalar load a slot (the
// generic entry). n' / S threads, S = 4, 8, 16, 32 or 64 consecutive virtual
// samples a thread, so a thread owns whole (padded) leaves or a run inside
// one, and every partition of every order is a run of 2^D samples inside a
// thread or a run of 2^i whole threads:
//   - leaf sums: inside a thread, a butterfly of 64-bit shuffles over a
//     leaf's lanes, or (leaves of several warps) a warp reduction and a
//     shared 64-bit atomic; a leaf of 2^i samples is scaled, not divided;
//   - the means heap (f64, order p's partition j at 2^p + j) in shared
//     memory: a level's entries are owned so that their children were
//     written by the same thread (levels of at least a CTA's width) or by
//     lanes of one warp (__syncwarp), the coarsest by warp 0: three CTA
//     barriers for all eleven levels;
//   - the ks heap beside it, a thread a partition: k from a guess on the
//     mean's exponent (both chains' boundaries about double a step), walked
//     to the table's count, so a few compares and no search;
//   - the Rice sums from the registers (step 4), by the partition's length
//     against the run: at most S samples: summed in registers and stored;
//     2..32 threads: an xor-shuffle butterfly over the partition's lanes;
//     several warps: a warp reduction and one shared atomicAdd a warp;
//   - the bits: a warp takes 32 heap slots at a time: slots 1..31 (orders
//     0..4) by a segmented butterfly, every later chunk of 32 (one order's)
//     by three 32-bit warp reductions (the sums' 16-bit halves, and the
//     parameter terms packed in one word) joined in 64 bits; warp 0 then
//     adds each order's chunks (a segmented butterfly over them) and
//     thread 0 takes the argmin over at most 11 orders.
// The row kind picks one of two step-4 bodies outside every loop.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTable = 33;          // boundaries 0..32 (0, 32: sentinels)
// Shared f64 table: plain boundaries, plain margins, recursive boundaries,
// recursive margins.
constexpr int kTables = 4 * kTable;
constexpr int kBitsSlots = 16;      // per-order bits, orders 0..10
constexpr int kChunks = 64;         // step 5's chunks of 32 heap slots

// x >> k for k in 0..32; 32 gives 0.
__device__ __forceinline__ uint32_t shr(uint32_t x, int k) {
    return __funnelshift_rc(x, 0u, (uint32_t)k);
}

// 2^(k+1) in uint32: 0 from k = 31 up.
__device__ __forceinline__ uint32_t pow_k1(int k) {
    return k >= 31 ? 0u : (2u << k);
}

__device__ __forceinline__ uint32_t zigzag(int32_t x) {
    return ((uint32_t)x << 1) ^ (uint32_t)(x >> 31);
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

template <int S>
__host__ __device__ constexpr int log2_of() {
    return S == 4 ? 2 : S == 8 ? 3 : S == 16 ? 4 : S == 32 ? 5 : 6;
}

// ---------------------------------------------------------------------------
// Step 2: leaf sums (leaves of 2^dleaf virtual samples), 64-bit
// ---------------------------------------------------------------------------

// Leaves of 2^D <= S samples: thread t owns S >> D of them.
template <int S, int D>
__device__ __forceinline__ void own_leaves(const uint32_t (&v)[S],
                                           unsigned long long* lsum, int t,
                                           int dleaf) {
    if (D == dleaf) {
        constexpr int CNT = S >> D, LEN = 1 << D;
#pragma unroll
        for (int j = 0; j < CNT; ++j) {
            unsigned long long a = 0ull;
#pragma unroll
            for (int e = 0; e < LEN; ++e) a += v[j * LEN + e];
            lsum[t * CNT + j] = a;
        }
    }
    if constexpr ((2 << D) <= S) own_leaves<S, D + 1>(v, lsum, t, dleaf);
}

// lsum: one slot a leaf, zeroed beforehand where a leaf spans several
// warps (those slots take atomics).
template <int S>
__device__ __forceinline__ void leaf_sums(const uint32_t (&v)[S],
                                          unsigned long long* lsum, int t,
                                          int dleaf) {
    constexpr int LS = log2_of<S>();
    if (dleaf <= LS) {
        own_leaves<S, 0>(v, lsum, t, dleaf);
        return;
    }
    unsigned long long a = 0ull;
#pragma unroll
    for (int e = 0; e < S; ++e) a += v[e];
    const int i = dleaf - LS;                   // a leaf spans 2^i threads
    const int lane = t & 31;
    if (i <= 5) {
        for (int o = 1; o < (1 << i); o <<= 1) {
            a += __shfl_xor_sync(kFull, a, o);
        }
        if ((lane & ((1 << i) - 1)) == 0) lsum[t >> i] = a;
    } else {
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) a += __shfl_xor_sync(kFull, a, o);
        if (lane == 0) atomicAdd(&lsum[t >> i], a);
    }
}

// ---------------------------------------------------------------------------
// Step 4: the Rice sums of every order from the registers
// ---------------------------------------------------------------------------

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

// ssum's slots below T / 32 (orders with fewer partitions than warps) must
// be zero on entry: they take atomics.
template <int S, bool REC>
__device__ __forceinline__ void row_sums(const uint32_t (&v)[S],
                                         const int32_t* sk, uint32_t* ssum,
                                         int t, int L, int max_porder) {
    constexpr int LS = log2_of<S>();
    const int lane = t & 31;
    const int dmin = L - max_porder;
    own_orders<S, 0, REC>(v, sk, ssum, t, L, dmin);
    // Partitions of 2..32 threads: a butterfly over the partition's lanes.
#pragma unroll
    for (int i = 1; i <= 5; ++i) {
        const int d = LS + i;
        if (d >= dmin && d <= L) {              // uniform over the launch
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
    // Partitions of several warps.
    for (int d = LS + 6; d <= L; ++d) {
        if (d >= dmin) {
            const int idx = (1 << (L - d)) + (t >> (d - LS));
            const uint32_t a = __reduce_add_sync(
                kFull, run_sum<S, REC>(v, sk, idx));
            if (lane == 0) atomicAdd(&ssum[idx], a);
        }
    }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

struct RowOut {
    long long* code_type;
    long long* porder;
    long long* bits;
    long long* ks;
    bool* risky;
};

// Threads: n' / S, at most MAXT. Shared memory (bytes): the tables
// (8 * 132), the means heap (8 H), the ks heap (4 H), the sums heap (4 H),
// the per-order bits (8 * 16) and the bits' chunks (8 * 64), with H =
// max(4, 2^(max_porder+1)); the leaf sums (8 * 2^max_porder) live in the
// upper half of the means heap, where the leaf means go.
template <int S, int MAXT>
__global__ void __launch_bounds__(MAXT, S == 16 ? 4 : 1)
rice_search_rows(const int32_t* __restrict__ res,
                 const double* __restrict__ tables, RowOut out, int n,
                 int L, int max_porder, int aligned, int head_bits,
                 int plain_top) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int H = max(4, 2 << max_porder);
    const int NL = 1 << max_porder;
    double* tb = reinterpret_cast<double*>(smem);
    double* smean = tb + kTables;
    int32_t* sk = reinterpret_cast<int32_t*>(smean + H);
    uint32_t* ssum = reinterpret_cast<uint32_t*>(sk + H);
    long long* sbits = reinterpret_cast<long long*>(ssum + H);
    long long* schunk = sbits + kBitsSlots;
    unsigned long long* lsum =
        reinterpret_cast<unsigned long long*>(smean + NL);
    __shared__ int s_choice;

    const long long row = blockIdx.x;
    const int t = threadIdx.x, T = blockDim.x;
    const int lane = t & 31, warp = t >> 5;
    const int dleaf = L - max_porder;           // log2 of a virtual leaf
    const int nsl = n >> max_porder;            // a real leaf
    constexpr int LS = log2_of<S>();

    // Step 1: the row into registers, zigzagged, leaves padded with zeros.
    uint32_t v[S];
    const int32_t* ur = res + row * n;
    if (aligned) {
        const int4* src = reinterpret_cast<const int4*>(ur) + t * (S / 4);
#pragma unroll
        for (int j = 0; j < S / 4; ++j) {
            const int4 q = __ldg(src + j);
            v[4 * j] = zigzag(q.x); v[4 * j + 1] = zigzag(q.y);
            v[4 * j + 2] = zigzag(q.z); v[4 * j + 3] = zigzag(q.w);
        }
    } else {
        const int lmask = (1 << dleaf) - 1;
#pragma unroll
        for (int i = 0; i < S; ++i) {
            const int vi = t * S + i;
            const int e = vi & lmask;
            v[i] = e < nsl ? zigzag(__ldg(ur + (vi >> dleaf) * nsl + e)) : 0u;
        }
    }
    for (int i = t; i < kTables; i += T) tb[i] = tables[i];
    // Zero what takes atomics: leaf sums of leaves that span several warps,
    // Rice sums of orders with fewer partitions than warps.
    if (dleaf > LS + 5) {
        for (int i = t; i < NL; i += T) lsum[i] = 0ull;
    }
    if (t < (T >> 5) && t < H) ssum[t] = 0u;
    __syncthreads();

    // Step 2: leaf sums, then the means heap, the leaf means in the leaf
    // sums' place. An entry's children were written by its own thread or a
    // lane of its warp: at levels of at least T entries thread t owns a run
    // of 2^p / T, below that entry j is thread j * T / 2^p's while that is
    // inside a warp (2^p >= T / 32); warp 0 takes the coarsest levels.
    leaf_sums<S>(v, lsum, t, dleaf);
    __syncthreads();
    // A leaf of 2^i samples: the quotient is the sum scaled, exactly.
    const bool nsl_pow2 = (nsl & (nsl - 1)) == 0;
    const double inv_nsl = 1.0 / (double)nsl;
    auto entry = [&](int p, int j) {
        double m;
        if (p == max_porder) {
            m = nsl_pow2 ? __dmul_rn((double)lsum[j], inv_nsl)
                         : __ddiv_rn((double)lsum[j], (double)nsl);
        } else {
            const double* c = smean + (2 << p) + 2 * j;
            m = __dmul_rn(__dadd_rn(c[0], c[1]), 0.5);
        }
        smean[(1 << p) + j] = m;
    };
    const int LT = 31 - __clz(T);
    const int pw = max(LT - 5, 0);
    for (int p = max_porder; p >= pw; --p) {
        if (p >= LT) {
            const int c = 1 << (p - LT);
            for (int e = 0; e < c; ++e) entry(p, t * c + e);
        } else if ((t & ((1 << (LT - p)) - 1)) == 0) {
            entry(p, t >> (LT - p));
        }
        __syncwarp();
    }
    __syncthreads();
    if (warp == 0) {
        for (int p = min(max_porder, pw - 1); p >= 0; --p) {
            if (lane < (1 << p)) entry(p, lane);
            __syncwarp();
        }
    }
    __syncthreads();

    // Step 3: the code type, then each partition's k and flag.
    const double mall = smean[1];
    const bool rec = mall >= 2.0;
    const double* bnd = tb + (rec ? 2 * kTable : 0);
    const double* eps = bnd + kTable;
    const int top = rec ? 31 : plain_top;
    // Both chains' boundaries grow about twofold a step: boundary j near
    // 2^j / c - 1 (recursive: c = MLNOPTX; plain: c = MLNOPTX sqrt 2). k
    // starts from that guess and walks to the count of boundaries 1..31
    // at or below the mean, which the ascending table fixes whatever the
    // guess.
    const double guess = rec ? 0.66794162356 : 0.94461595315;
    bool flag = false;
    for (int i = t + 1; i < (2 << max_porder); i += T) {
        const double m = smean[i];
        const double x = __dmul_rn(__dadd_rn(m, 1.0), guess);
        int k = min(max((__double2hiint(x) >> 20) - 1023, 0), 31);
        while (k < 31 && bnd[k + 1] <= m) ++k;
        while (k > 0 && bnd[k] > m) --k;
        const double d1 = fabs(__dsub_rn(m, bnd[k]));
        const double d2 = fabs(__dsub_rn(bnd[k + 1], m));
        flag |= ((d1 < eps[k]) | (d2 < eps[k + 1]) | (k >= top))
                & (m != 0.0);
        sk[i] = k;
    }
    const int flagged = __syncthreads_or(flag);

    // Step 4: the Rice sums.
    if (rec) {
        row_sums<S, true>(v, sk, ssum, t, L, max_porder);
    } else {
        row_sums<S, false>(v, sk, ssum, t, L, max_porder);
    }
    __syncthreads();

    // Step 5: each order's bits, then the argmin.
    const int P1 = 2 << max_porder;             // heap slots 1 .. P1 - 1
    for (int c = warp; c * 32 < P1; c += T >> 5) {
        const int i = c * 32 + lane;
        if (c == 0) {
            // Slots 1..31: order p's 2^p slots are the aligned lanes
            // 2^p .. 2^(p+1) - 1; a butterfly inside each.
            long long b = 0;
            if (i >= 1 && i < P1) {
                const int p = 31 - __clz(i);
                const int k = sk[i];
                b = (long long)(int32_t)ssum[i]
                    + (long long)(k + (rec ? 2 : 1)) * (long long)(n >> p);
                if (i > (1 << p)) {
                    const int d = k - sk[i - 1];
                    b += (d >= 0 ? 2 * d : -2 * d - 1) + 1;
                }
            }
            const int seg = lane == 0 ? 1 : 1 << (31 - __clz(lane));
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const long long other = __shfl_xor_sync(kFull, b, o);
                if (o < seg) b += other;
            }
            if (lane != 0 && lane == seg && lane < P1) {
                sbits[31 - __clz(lane)] = b;
            }
        } else {
            // One order's 32 slots: the sums' 16-bit halves and the
            // parameter terms in three 32-bit reductions, joined in 64
            // bits by lane 0.
            const int p = 31 - __clz(c * 32);
            const int32_t a = (int32_t)ssum[i];
            const int k = sk[i];
            const int d = k - sk[i - 1];
            const int dz = i > (1 << p) ? (d >= 0 ? 2 * d : -2 * d - 1) + 1
                                        : 0;
            const unsigned lo =
                __reduce_add_sync(kFull, (unsigned)a & 0xffffu);
            const int hi = __reduce_add_sync(kFull, a >> 16);
            const unsigned kz = __reduce_add_sync(
                kFull, (unsigned)(k + (rec ? 2 : 1)) | ((unsigned)dz << 16));
            if (lane == 0) {
                schunk[c] = (long long)hi * 65536 + lo
                            + (long long)(kz & 0xffffu) * (n >> p)
                            + (kz >> 16);
            }
        }
    }
    __syncthreads();
    if (warp == 0 && P1 > 32) {
        // Orders 5.. from the chunks: chunk c (1..63) is order 5 +
        // log2(c). Lane 0 takes chunk 1 (order 5), lane l >= 1 chunks 2l
        // and 2l + 1 (order 6 + log2(l)); a butterfly inside each order's
        // aligned lanes.
        const int c0 = lane == 0 ? 1 : 2 * lane;
        long long b = c0 * 32 < P1 ? schunk[c0] : 0;
        if (lane > 0 && (c0 + 1) * 32 < P1) b += schunk[c0 + 1];
        const int seg = lane == 0 ? 1 : 1 << (31 - __clz(lane));
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const long long other = __shfl_xor_sync(kFull, b, o);
            if (o < seg) b += other;
        }
        const int p = lane == 0 ? 5 : 6 + 31 - __clz(lane);
        if (lane == seg && p <= max_porder) sbits[p] = b;
        if (lane == 0) sbits[5] = b;
    }
    __syncthreads();
    if (t == 0) {
        long long best = 1ll << 30;
        int choice = -1;
        for (int p = 0; p <= max_porder; ++p) {
            const long long b = head_bits + sbits[p];
            if (b < best) {
                best = b;
                choice = p;
            }
        }
        const bool zero = mall == 0.0;
        const bool near2 = fabs(__dsub_rn(mall, 2.0)) < 1e-9;
        out.code_type[row] = zero ? 2 : (rec ? 1 : 0);
        out.porder[row] = (zero || choice < 0) ? 0 : choice;
        out.bits[row] = (zero ? 0 : best) + 2;
        out.risky[row] = (near2 || flagged) && !zero;
        s_choice = choice;
    }
    __syncthreads();
    const int choice = s_choice;
    const int live = choice < 0 ? 0 : 1 << choice;
    long long* ko = out.ks + row * NL;
    for (int j = t; j < NL; j += T) {
        ko[j] = j < live ? (long long)sk[live + j] : 0ll;
    }
}

template <int S, int MAXT>
int launch(const int32_t* res, const double* tables, RowOut out, int V,
           int n, int L, int max_porder, bool aligned, int head_bits,
           int plain_top, cudaStream_t stream) {
    const int H = (2 << max_porder) < 4 ? 4 : (2 << max_porder);
    const size_t shared = sizeof(double) * (kTables + H)
                          + 2 * sizeof(int32_t) * H
                          + sizeof(long long) * (kBitsSlots + kChunks);
    rice_search_rows<S, MAXT><<<V, (1 << L) / S, shared, stream>>>(
        res, tables, out, n, L, max_porder, aligned ? 1 : 0, head_bits,
        plain_top);
    return (int)cudaGetLastError();
}

}  // namespace

// res: (V, n) int32 residual; tables: (4, 33) f64 (plain boundaries,
// margins, recursive boundaries, margins); outputs code_type, porder, bits
// (V,) int64, ks (V, 2^max_porder) int64, risky (V,) bool. n must be a
// multiple of 2^max_porder, max_porder in 0..10, n <= 65536. head_bits: the
// order's fixed bits (partition-order and parameter fields); plain_top: the
// plain chain's first parameter that is always flagged.
extern "C" int srla_rice_search(const void* res, const void* tables,
                                void* code_type, void* porder, void* bits,
                                void* ks, void* risky, int V, int n,
                                int max_porder, int head_bits, int plain_top,
                                void* stream) {
    if (max_porder < 0 || max_porder > 10 || n < 1 || n > 65536 ||
        n % (1 << max_porder)) {
        return (int)cudaErrorInvalidValue;
    }
    RowOut out{(long long*)code_type, (long long*)porder, (long long*)bits,
               (long long*)ks, (bool*)risky};
    const int32_t* r = (const int32_t*)res;
    const double* tb = (const double*)tables;
    cudaStream_t st = (cudaStream_t)stream;
    int L = 7;                                  // n' >= 128
    while ((1 << L) < n) ++L;
    const bool aligned = (1 << L) == n && ((uintptr_t)res & 15) == 0;
    // n' = 128 .. 65536: 32 .. 1024 threads.
    switch (L) {
    case 7: case 8: case 9: case 10:
        return launch<4, 256>(r, tb, out, V, n, L, max_porder, aligned,
                              head_bits, plain_top, st);
    case 11:
        return launch<8, 256>(r, tb, out, V, n, L, max_porder, aligned,
                              head_bits, plain_top, st);
    case 12:
        return launch<16, 256>(r, tb, out, V, n, L, max_porder, aligned,
                               head_bits, plain_top, st);
    case 13: case 14:
        return launch<32, 512>(r, tb, out, V, n, L, max_porder, aligned,
                               head_bits, plain_top, st);
    case 15:
        return launch<64, 512>(r, tb, out, V, n, L, max_porder, aligned,
                               head_bits, plain_top, st);
    default:
        return launch<64, 1024>(r, tb, out, V, n, L, max_porder, aligned,
                                head_bits, plain_top, st);
    }
}
