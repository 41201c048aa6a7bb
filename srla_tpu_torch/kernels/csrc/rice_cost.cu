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
//      2^30) wins (none: order 0, zero parameters); an ALLZERO row takes
//      order 0 and bits 0.
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
// columns): 0.038 ms at 3.35 TB/s; beside the terms (a shift and an add,
// on recursive rows also a subtract-and-clamp): a term depends on the
// sample and its parameter alone, so a sample needs one for each distinct
// parameter its orders give it, at most max_porder + 1 (0.23 G at the main
// shape, 0.048 ms at the INT32 rate) and far fewer on real rows, whose
// orders' parameters lie a few apart (chip_smoke.py k15_bound counts them).
//
// Layout (K4's, rice_search.cu). One CTA a row. The row is read once into
// registers as a virtual row of n' = max(128, next power of two >= n)
// samples: each leaf of nsl = n >> max_porder samples is padded with zeros
// to nsl' = n' >> max_porder (a power of two), which add nothing to a sum
// or a term. Rows whose n is a power of two of at least 128, 16-byte
// aligned, take 128-bit loads; the others one coalesced scalar load a
// slot. n' / S threads, S = 4..64 consecutive virtual samples a thread, so
// every partition of every order is a run inside a thread or a run of
// whole threads:
//   - leaf sums (64-bit) by in-thread adds and shuffles, the exact
//     partition sums pairwise into a heap in shared memory (order p's
//     partition j at 2^p + j) by the thread or warp that wrote the
//     children, then every partition's f32 parameter, a thread a
//     partition;
//   - each order's parameter bits ((k + 2 or + 1) (n >> p) and the
//     deltas') by a warp a chunk of 32 heap slots;
//   - the sample terms: each thread loads its few parameters once (one an
//     order, or one a partition where an order's partitions are shorter
//     than S) and adds each order's S terms from the registers, in 32 bits
//     when the row's largest code times S fits (every 16- and 24-bit row:
//     the CTA decides once, outside every loop), else in 64 bits. The
//     orders whose partitions hold the whole run (9 of 11 at n 4096) have
//     parameters a few apart: the run's terms are summed once at each of
//     the 4 parameters from the least of them, and an order takes its
//     own (an order further off sums its own). A warp reduction (32-bit:
//     two of the 16-bit halves) into the warp's slot of the order, no
//     64-bit atomics;
//   - warp 0 adds each order's slots, thread 0 picks the order; the CTA
//     writes the ks row.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxOrder = 10;
constexpr int kOrders = 16;          // per-order slots, orders 0..10
// The parameters a thread's whole-run orders share: their terms are
// summed once for each of kWin consecutive k from the least.
constexpr int kWin = 4;

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

template <int S>
__host__ __device__ constexpr int log2_of() {
    return S == 4 ? 2 : S == 8 ? 3 : S == 16 ? 4 : S == 32 ? 5 : 6;
}

// CNT consecutive ints of shared memory, aligned to CNT words.
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

// ---------------------------------------------------------------------------
// Leaf sums (leaves of 2^dleaf virtual samples), 64-bit
// ---------------------------------------------------------------------------

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
// The sample terms of every order from the registers
// ---------------------------------------------------------------------------

// A sample's term with parameter k (k1pow = 2^(k+1), k <= 30). WIDE: any
// code; else codes below 2^30, where (int32)(u - k1pow) has the sign of
// u - k1pow, so a clamp at 0 (one add-max) replaces the compare.
template <bool REC, bool WIDE>
__device__ __forceinline__ uint32_t term(uint32_t u, int k, uint32_t k1pow) {
    if (REC) {
        if (WIDE) return u >= k1pow ? (u - k1pow) >> k : 0u;
        return (uint32_t)max((int32_t)(u - k1pow), 0) >> k;
    }
    return u >> k;
}

template <bool WIDE>
using Acc = typename std::conditional<WIDE, unsigned long long,
                                      uint32_t>::type;

// The warp's sum of a, stored to *dst (the warp's slot) by lane 0.
__device__ __forceinline__ void order_add(uint32_t a, unsigned long long* dst,
                                          int lane) {
    // A thread's 32-bit sum splits into 16-bit halves whose warp sums fit.
    const unsigned lo = __reduce_add_sync(kFull, a & 0xffffu);
    const unsigned hi = __reduce_add_sync(kFull, a >> 16);
    if (lane == 0) *dst = ((unsigned long long)hi << 16) + lo;
}

__device__ __forceinline__ void order_add(unsigned long long a,
                                          unsigned long long* dst, int lane) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(kFull, a, o);
    if (lane == 0) *dst = a;
}

// The orders whose partitions (2^D < S samples) lie inside one thread's
// run: thread t holds S >> D of them, their parameters loaded at once.
template <int S, int D, bool REC, bool WIDE>
__device__ __forceinline__ void fine_orders(const uint32_t (&v)[S],
                                            const int32_t* sk,
                                            unsigned long long* obits, int t,
                                            int L, int dmin) {
    if constexpr ((1 << D) < S) {
        if (D >= dmin) {                        // order L - D exists
            constexpr int CNT = S >> D, LEN = 1 << D;
            const int p = L - D;
            int32_t k[CNT];
            load_run<CNT>(sk + (1 << p) + t * CNT, k);
            Acc<WIDE> a = 0;
#pragma unroll
            for (int j = 0; j < CNT; ++j) {
                const uint32_t k1pow = 2u << k[j];
#pragma unroll
                for (int e = 0; e < LEN; ++e)
                    a += term<REC, WIDE>(v[j * LEN + e], k[j], k1pow);
            }
            order_add(a, obits + p, t & 31);
        }
        fine_orders<S, D + 1, REC, WIDE>(v, sk, obits, t, L, dmin);
    }
}

template <int S, bool REC, bool WIDE>
__device__ __forceinline__ Acc<WIDE> run_terms(const uint32_t (&v)[S],
                                               int k) {
    const uint32_t k1pow = 2u << k;
    Acc<WIDE> a = 0;
#pragma unroll
    for (int e = 0; e < S; ++e) a += term<REC, WIDE>(v[e], k, k1pow);
    return a;
}

// Every order's terms of the thread's run, order p's warp sum to
// obits[p] (the warp's slots).
template <int S, bool REC, bool WIDE>
__device__ __forceinline__ void sample_terms(const uint32_t (&v)[S],
                                             const int32_t* sk,
                                             unsigned long long* obits, int t,
                                             int L, int max_porder) {
    constexpr int LS = log2_of<S>();
    // Orders whose partitions hold a whole run or more: one parameter
    // each, mostly a few apart; the run's terms at kWin parameters from
    // the least serve every order whose k is among them.
    const int coarse = min(max_porder, L - LS);
    int kc[kMaxOrder + 1];
    int kmin = 30;
#pragma unroll
    for (int p = 0; p <= kMaxOrder; ++p) {
        kc[p] = 0;
        if (p <= coarse) {
            kc[p] = sk[(1 << p) + (t >> (L - p - LS))];
            kmin = min(kmin, kc[p]);
        }
    }
    Acc<WIDE> tw[kWin];
#pragma unroll
    for (int w = 0; w < kWin; ++w) {
        tw[w] = run_terms<S, REC, WIDE>(v, min(kmin + w, 30));
    }
#pragma unroll
    for (int p = 0; p <= kMaxOrder; ++p) {
        if (p <= coarse) {                      // uniform over the CTA
            const int d = kc[p] - kmin;
            Acc<WIDE> a = tw[0];
#pragma unroll
            for (int w = 1; w < kWin; ++w) a = d == w ? tw[w] : a;
            if (d >= kWin) a = run_terms<S, REC, WIDE>(v, kc[p]);
            order_add(a, obits + p, t & 31);
        }
    }
    fine_orders<S, 0, REC, WIDE>(v, sk, obits, t, L, L - max_porder);
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

struct RowOut {
    long long* code_type;
    long long* porder;
    int32_t* bits;
    long long* ks;
};

// Threads: n' / S, at most MAXT. Shared memory (bytes): the sums heap
// (8 H), the ks heap (4 H), with H = max(4, 2^(max_porder+1)), each warp's
// order sums (8 * 16 a warp), the parameter bits and the orders' bits
// (4 * 16 and 8 * 16); the leaf sums are the heap's last level.
template <int S, int MAXT>
__global__ void __launch_bounds__(MAXT, S == 16 ? 4 : 1)
rice_cost_rows(const int32_t* __restrict__ res, RowOut out, int n, int L,
               int max_porder, int aligned, float mlnoptx, float neg_mlnoptx,
               int head_bits) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int H = max(4, 2 << max_porder);
    const int NL = 1 << max_porder;
    const int W = blockDim.x >> 5;
    unsigned long long* psum = reinterpret_cast<unsigned long long*>(smem);
    int32_t* sk = reinterpret_cast<int32_t*>(psum + H);
    unsigned long long* wbits = reinterpret_cast<unsigned long long*>(sk + H);
    unsigned long long* obits = wbits + W * kOrders;     // a row's orders
    unsigned* pbits = reinterpret_cast<unsigned*>(obits + kOrders);
    unsigned long long* lsum = psum + NL;
    __shared__ int s_choice;

    const long long row = blockIdx.x;
    const int t = threadIdx.x, T = blockDim.x;
    const int lane = t & 31, warp = t >> 5;
    const int dleaf = L - max_porder;           // log2 of a virtual leaf
    const int nsl = n >> max_porder;            // a real leaf
    constexpr int LS = log2_of<S>();

    // The row into registers, zigzagged, leaves padded with zeros.
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
    uint32_t vmax = 0u;
#pragma unroll
    for (int e = 0; e < S; ++e) vmax = max(vmax, v[e]);
    if (dleaf > LS + 5) {
        for (int i = t; i < NL; i += T) lsum[i] = 0ull;
    }
    for (int i = t; i < W * kOrders; i += T) wbits[i] = 0ull;
    if (t < kOrders) pbits[t] = 0u;
    // 32-bit thread sums hold S terms of at most vmax each; below 2^30
    // every recursive term's subtraction keeps its sign in int32 too.
    const bool wide = __syncthreads_or(vmax > 0xffffffffu / S);

    // Leaf sums, then the sums heap: an entry's children were written by
    // its own thread or a lane of its warp: at levels of at least T
    // entries thread t owns a run of 2^p / T, below that entry j is thread
    // j * T / 2^p's while that is inside a warp (2^p >= T / 32); warp 0
    // takes the coarsest levels.
    leaf_sums<S>(v, lsum, t, dleaf);
    __syncthreads();
    auto entry = [&](int p, int j) {
        const unsigned long long* c = psum + (2 << p) + 2 * j;
        psum[(1 << p) + j] = c[0] + c[1];
    };
    const int LT = 31 - __clz(T);
    const int pw = max(LT - 5, 0);
    for (int p = max_porder - 1; p >= pw; --p) {
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
        for (int p = min(max_porder - 1, pw - 1); p >= 0; --p) {
            if (lane < (1 << p)) entry(p, lane);
            __syncwarp();
        }
    }
    __syncthreads();

    // The code type, then every partition's parameter.
    const unsigned long long total = psum[1];
    const bool allzero = total == 0ull;
    const bool rec = __fdiv_rn(__ull2float_rn(total), (float)n) >= 2.0f;
    for (int e = t + 1; e < (2 << max_porder); e += T) {
        const int p = 31 - __clz(e);
        const float m = __fdiv_rn(__ull2float_rn(psum[e]), (float)(n >> p));
        sk[e] = rec ? k_recursive(m, mlnoptx) : k_plain(m, neg_mlnoptx);
    }
    __syncthreads();

    // Each order's parameter bits (under 2^23 an order), a warp a chunk of
    // 32 heap slots: slots 1..31 (orders 0..4) one 32-bit atomic a slot,
    // every later chunk inside one order, a warp reduction and one atomic.
    const int P1 = 2 << max_porder;
    for (int c = warp; c * 32 < P1; c += T >> 5) {
        const int i = c * 32 + lane;
        unsigned b = 0u;
        int p = 0;
        if (i >= 1 && i < P1) {
            p = 31 - __clz(i);
            const int k = sk[i];
            b = (unsigned)(k + (rec ? 2 : 1)) * (unsigned)(n >> p);
            if (i > (1 << p)) {
                const int d = k - sk[i - 1];
                b += (((uint32_t)d << 1) ^ (uint32_t)(d >> 31)) + 1u;
            }
        }
        if (c == 0) {
            if (b) atomicAdd(&pbits[p], b);
        } else {
            const unsigned s = __reduce_add_sync(kFull, b);
            if (lane == 0) atomicAdd(&pbits[p], s);
        }
    }

    // The sample terms (none on an ALLZERO row), into the warp's slots.
    unsigned long long* mine = wbits + warp * kOrders;
    if (!allzero) {
        if (rec) {
            if (wide) sample_terms<S, true, true>(v, sk, mine, t, L,
                                                  max_porder);
            else sample_terms<S, true, false>(v, sk, mine, t, L,
                                              max_porder);
        } else {
            if (wide) sample_terms<S, false, true>(v, sk, mine, t, L,
                                                   max_porder);
            else sample_terms<S, false, false>(v, sk, mine, t, L,
                                               max_porder);
        }
    }
    __syncthreads();
    if (t <= max_porder) {
        unsigned long long b = pbits[t];
        for (int w = 0; w < W; ++w) b += wbits[w * kOrders + t];
        obits[t] = b;
    }
    __syncwarp();

    if (t == 0) {
        long long best = 1ll << 30;
        int choice = -1;
        for (int p = 0; p <= max_porder; ++p) {
            const long long b = head_bits + (long long)obits[p];
            if (b < best) {
                best = b;
                choice = p;
            }
        }
        out.code_type[row] = allzero ? 2 : (rec ? 1 : 0);
        out.porder[row] = (allzero || choice < 0) ? 0 : choice;
        out.bits[row] = (int32_t)((allzero ? 0 : best) + 2);
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
int launch(const int32_t* res, RowOut out, int V, int n, int L,
           int max_porder, bool aligned, float mlnoptx, float neg_mlnoptx,
           int head_bits, cudaStream_t stream) {
    const int H = (2 << max_porder) < 4 ? 4 : (2 << max_porder);
    const int warps = (1 << L) / S / 32;
    const size_t shared = sizeof(unsigned long long)
                          * (H + (warps + 1) * kOrders)
                          + sizeof(int32_t) * (H + kOrders);
    rice_cost_rows<S, MAXT><<<V, (1 << L) / S, shared, stream>>>(
        res, out, n, L, max_porder, aligned ? 1 : 0, mlnoptx, neg_mlnoptx,
        head_bits);
    return (int)cudaGetLastError();
}

}  // namespace

// residual: (V, n) int32; outputs code_type, porder (V,) int64, bits (V,)
// int32, ks (V, 2^max_porder) int64. n must be a multiple of 2^max_porder,
// max_porder in 0..10, n <= 65536. head_bits: the order's fixed bits.
extern "C" int srla_rice_cost(const void* residual, void* code_type,
                              void* porder, void* bits, void* ks, int V,
                              int n, int max_porder, float mlnoptx,
                              float neg_mlnoptx, int head_bits, void* stream) {
    if (V <= 0) return 0;
    if (max_porder < 0 || max_porder > 10 || n < 1 || n > 65536 ||
        n % (1 << max_porder)) {
        return (int)cudaErrorInvalidValue;
    }
    RowOut out{(long long*)code_type, (long long*)porder, (int32_t*)bits,
               (long long*)ks};
    const int32_t* r = (const int32_t*)residual;
    cudaStream_t st = (cudaStream_t)stream;
    int L = 7;                                  // n' >= 128
    while ((1 << L) < n) ++L;
    const bool aligned = (1 << L) == n && ((uintptr_t)r & 15) == 0;
    // n' = 128 .. 65536: 32 .. 1024 threads.
    switch (L) {
    case 7: case 8: case 9: case 10:
        return launch<4, 256>(r, out, V, n, L, max_porder, aligned, mlnoptx,
                              neg_mlnoptx, head_bits, st);
    case 11:
        return launch<8, 256>(r, out, V, n, L, max_porder, aligned, mlnoptx,
                              neg_mlnoptx, head_bits, st);
    case 12:
        return launch<16, 256>(r, out, V, n, L, max_porder, aligned,
                               mlnoptx, neg_mlnoptx, head_bits, st);
    case 13: case 14:
        return launch<32, 512>(r, out, V, n, L, max_porder, aligned,
                               mlnoptx, neg_mlnoptx, head_bits, st);
    case 15:
        return launch<64, 512>(r, out, V, n, L, max_porder, aligned,
                               mlnoptx, neg_mlnoptx, head_bits, st);
    default:
        return launch<64, 1024>(r, out, V, n, L, max_porder, aligned,
                                mlnoptx, neg_mlnoptx, head_bits, st);
    }
}
