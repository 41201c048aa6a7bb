// K8: the encode's windowed circular autocorrelation, on the f64 tensor
// cores.
//
// Replaces the XLA program srla_tpu/kernels/exact.py:_autocorr_dd (lag loop
// :143, body :130), which the encode runs for the LPC lags of every analysis
// row (max order + 1 <= 256) and, with -P, for the 263 pitch lags before
// them. Per row of n samples x (int32) and lag k < L:
//
//   ac[k] = F / n * sum_{i < n} d[i] * d[(i + k) mod F],   d[i] = x[i] * w[i]
//
// with F the FFT size (a power of two >= n), d zero from n to F, and w the
// Welch window times 2^-(bps-1) (its middle sample 0 for odd n), exact in
// f64 as the plain version's. The lags are circular: when n = F every lag
// wraps, so the kernel reads an extended row ext[j] = d[j mod F] (0 where
// j mod F >= n), never the linear autocorrelation. Its plain version is
// kernels/autocorr.py:autocorr_plain.
//
// A Gram product. Read the row as X[p][q] = d[16p + q] (rows of 16
// samples). For a lag tile c = 0, 8, 16, ... the 16 x 8 product with entry
// (m, j) = sum_p X[p][m] * ext[16p + c + j] (depth: the rows p) is the sum
// over i = m (mod 16), i < n, of d[i] * ext[i + c + j - m]. Lag l takes one
// entry a residue m, from tile c = 8 floor((l + m) / 8), column j = (l + m)
// mod 8, and the sum of those 16 entries is the lag: (L + 14) / 8 + 1
// tiles give L lags (10 for 65 lags, 35 for 263).
//
// On the tensor cores: mma.sync.aligned.m16n8k4.row.col.f64 (DMMA)
// computes D = A B + C with A 16 x 4, B 4 x 8; with A[m][k] = X[p + k][m]
// and B[k][j] = ext[16 (p + k) + c + j] it adds 4 depth rows of tile c. (On
// an H100 it runs at the f64 tensor rate, 67 TFLOP/s; m8n8k4 runs at half
// that.) Lane l (g = l >> 2, t = l & 3) holds A's (g, t) and (g + 8, t),
// B's (t, g) and C's (g, 2t + {0, 1}) and (g + 8, 2t + {0, 1}), so its A
// values are samples 16 (p + t) + g (+ 8) and its B value of tile c is
// sample 16 (p + t) + g + c: the B value of the tile 8 tiles on is the
// same tile's one step (4 rows) later. A warp item owns a run of TW <= 10
// consecutive tiles and one chunk of 64 depth rows: it keeps a window of
// TW B values in registers, slides it a step with at most 8 shared loads
// plus 2 for A (padded: no bank conflict), and issues TW DMMAs a step into
// TW independent accumulators.
//
// The sum order is part of the contract, because the lags feed the
// Levinson and LTP margins (kernels/exact.py, above _EPS_PREEMPH). An
// accumulator takes one chunk's 16 DMMAs (64 products) in order, whatever
// order a DMMA keeps inside; a stage's (up to) 4 chunks are combined by a
// pairwise tree, per entry; then a lag's 16 residue entries by a pairwise
// tree; stages of 4096 samples in order; then one multiply by F / n. A
// product passes at most 5 roundings in its own DMMA and 4 in each of the
// 15 after it, so at most 65 + 2 + 4 + (stages - 1) + 1 roundings: 75 u of
// r0 at n = 16384 (u = 2^-53; 2^-46.8), the bound exact.py states and
// tests/test_torch_autocorr.py pins with an exact emulation of this order
// (on an H100 the DMMA is a chain of fused multiply-adds in depth order,
// and the kernel equals the emulation bit for bit).
//
// What bounds it on an H100: L * n multiply-adds a row in f64 on the
// tensor cores (67 TFLOP/s, twice the vector pipe's 34), at the encode's
// main path 5164 rows x 4096 x 65 lags (0.041 ms of useful work; this
// design computes 80 lags' worth, 0.051 ms) or x 263 (0.165 ms; 320
// computed) against 85 MB of int32 samples read once (0.025 ms). Rows of
// up to 4096 samples fill one stage (16-byte loads, the Welch window
// computed in place); longer rows are staged in turns. A CTA has a warp
// for each chunk of a stage and each run; lags past what one CTA's two
// runs hold go to further CTAs of the row (grid y), each over its own
// tiles: a pass of 20 tiles owns 144 lags and shares two tiles with the
// next pass.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStage = 4096;                    // samples staged at once
constexpr int kStageRows = kStage / 16;         // rows of X in a stage
constexpr int kChunkRows = 64;                  // depth rows an accumulator
constexpr int kChunkSteps = kChunkRows / 4;     // DMMAs an accumulator
constexpr int kChunks = kStageRows / kChunkRows;
constexpr int kMaxRun = 10;                     // tiles a warp holds
constexpr int kMaxLags = 1024;

// How a launch cuts L lags: runs of TW tiles, `runs` of them a CTA (the
// CTA's TP = TW * runs tiles, a warp for each run and chunk), passes (CTAs
// a row), each pass starting Q = TP - 2 tiles after the last.
struct Plan {
    int TW, runs, TP, Q, passes;
};

__host__ __device__ inline Plan make_plan(int L) {
    Plan p;
    const int tiles = (L + 14) / 8 + 1;
    p.TW = tiles <= kMaxRun ? tiles : kMaxRun;
    p.runs = tiles <= kMaxRun ? 1 : 2;
    p.TP = p.TW * p.runs;
    p.Q = p.TP - 2;
    p.passes = tiles <= kMaxRun ? 1 : (L - 1 + 8 * p.Q - 1) / (8 * p.Q);
    return p;
}

// Shared-memory index of staged sample j: 4 spare words after every 16, so
// a load (lane l at 16 (l & 3) + (l >> 2) + const) meets no bank twice in
// a half-warp.
__host__ __device__ __forceinline__ int padded(int j) {
    return j + 4 * (j >> 4);
}

// Samples a stage of `rows` rows stages for a pass from tile T0: its rows
// rounded to a step and the B halo of the pass's tiles.
__host__ __device__ __forceinline__ int stage_span(int rows, int T0,
                                                  const Plan& p) {
    return 16 * ((rows + 3) & ~3) + 8 * (T0 + p.TP) + 48;
}

// Doubles of dynamic shared memory: the stage (its space reused for the
// chunks' tile sums once the products are done), the pass's running lags.
__host__ __device__ inline int smem_doubles(const Plan& p) {
    const int stage = padded(stage_span(kStageRows, p.Q * (p.passes - 1),
                                        p)) + 1;
    const int part = kChunks * p.TP * 128;
    return (stage > part ? stage : part) + 8 * p.Q + 1;
}

// The scaled window's sample i (kernels/autocorr.py:scaled_window, from
// dsp/window.py:welch_window): (divisor * k) * (n - 1 - k) with k the
// sample's distance from the nearer end, 0 in the middle of an odd row,
// times scale = 2^-(bps-1); every product rounded as numpy rounds it.
__device__ __forceinline__ double window(int i, int n, double divisor,
                                         double scale) {
    const int half = n >> 1;
    if ((n & 1) && i == half) return 0.0;
    const int k = i < half ? i : n - 1 - i;
    return __dmul_rn(__dmul_rn(__dmul_rn(divisor, (double)k),
                               (double)(n - 1 - k)), scale);
}

__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[2],
                                     double b) {
    asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(b));
}

// One warp item: tiles tile0 .. tile0 + TW - 1 over the stage's depth rows
// row0 .. row0 + 4 * steps - 1, A masked to the live samples, into acc.
template <int TW>
__device__ __forceinline__ void item(const double* __restrict__ buf,
                                     double (&acc)[TW][4], int tile0,
                                     int row0, int steps, int live,
                                     int lane) {
    const int g = lane >> 2;
    const int t = lane & 3;
    double w[TW];
#pragma unroll
    for (int u = 0; u < TW; ++u)
        w[u] = buf[padded(16 * (row0 + t) + 8 * (tile0 + u) + g)];
#pragma unroll 2
    for (int s = 0; s < steps; ++s) {
        const int r = row0 + 4 * s;
        const int i0 = 16 * (r + t) + g;
        const double a[2] = {i0 < live ? buf[padded(i0)] : 0.0,
                             i0 + 8 < live ? buf[padded(i0 + 8)] : 0.0};
#pragma unroll
        for (int u = 0; u < TW; ++u) dmma(acc[u], a, w[u]);
#pragma unroll
        for (int u = 0; u < TW; ++u)
            w[u] = u + 8 < TW
                ? w[u + 8]
                : buf[padded(16 * (r + 4 + t) + 8 * (tile0 + u) + g)];
    }
}

template <int TW>
__global__ void __launch_bounds__(32 * kChunks * 2, 2)
autocorr_kernel(const int32_t* __restrict__ work, double* __restrict__ out,
                int n, int L, int F, double norm, double divisor,
                double scale) {
    extern __shared__ double smem[];
    const Plan p = make_plan(L);
    const int T0 = p.Q * blockIdx.y;               // the pass's first tile
    const int lo = blockIdx.y == 0 ? 0 : 8 * T0 + 1;
    const int hi = min(L - 1, 8 * (T0 + p.Q));     // its lags lo .. hi
    double* buf = smem;
    double* part = smem;                           // after the products
    double* total = smem + smem_doubles(p) - (8 * p.Q + 1);
    const int32_t* x = work + (size_t)blockIdx.x * n;
    const bool aligned = (n & 3) == 0
        && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int run = warp / kChunks;
    const int k = warp % kChunks;                  // the warp's chunk

    for (int s0 = 0; s0 < n; s0 += kStage) {
        const int live = n - s0;
        const int rows = min(kStageRows, (live + 15) / 16);
        const int chunks = (rows + kChunkRows - 1) / kChunkRows;
        const int span = stage_span(rows, T0, p);
        __syncthreads();                   // the last stage's lags are read
        // The live samples (below n: no wrap) four at a time where the row
        // allows 16-byte loads, then the rest and the circular halo.
        int body = 0;
        if (aligned) {
            body = min(span, live) & ~3;
            const int4* x4 = reinterpret_cast<const int4*>(x + s0);
#pragma unroll 8
            for (int q = threadIdx.x; q < body / 4; q += blockDim.x) {
                const int4 v = x4[q];
                const int i = s0 + 4 * q;
                double* d = buf + padded(4 * q);
                d[0] = __dmul_rn((double)v.x, window(i, n, divisor, scale));
                d[1] = __dmul_rn((double)v.y,
                                 window(i + 1, n, divisor, scale));
                d[2] = __dmul_rn((double)v.z,
                                 window(i + 2, n, divisor, scale));
                d[3] = __dmul_rn((double)v.w,
                                 window(i + 3, n, divisor, scale));
            }
        }
        for (int j = body + threadIdx.x; j < span; j += blockDim.x) {
            int m = s0 + j;
            if (m >= F) m %= F;
            buf[padded(j)] = m < n
                ? __dmul_rn((double)x[m], window(m, n, divisor, scale))
                : 0.0;
        }
        __syncthreads();
        double acc[TW][4];
#pragma unroll
        for (int u = 0; u < TW; ++u)
            acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.0;
        if (k < chunks)
            item<TW>(buf, acc, T0 + run * TW, k * kChunkRows,
                     min(kChunkSteps, (rows - k * kChunkRows + 3) / 4),
                     live, lane);
        __syncthreads();                   // the stage is read: reuse it
        if (k < chunks) {
            double* dst = part + (k * p.TP + run * TW) * 128
                + 8 * (lane >> 2) + 2 * (lane & 3);
#pragma unroll
            for (int u = 0; u < TW; ++u) {
                *reinterpret_cast<double2*>(dst + u * 128) =
                    make_double2(acc[u][0], acc[u][1]);
                *reinterpret_cast<double2*>(dst + u * 128 + 64) =
                    make_double2(acc[u][2], acc[u][3]);
            }
        }
        __syncthreads();
        // A lag's 16 residue entries, each the pairwise tree of its
        // chunks; then the pairwise tree of the residues; stages add up in
        // order.
        for (int l = lo + threadIdx.x; l <= hi; l += blockDim.x) {
            double v[16];
#pragma unroll
            for (int m = 0; m < 16; ++m) {
                const int e = (((l + m) >> 3) - T0) * 128 + m * 8
                    + ((l + m) & 7);
                double c4[kChunks];
#pragma unroll
                for (int c = 0; c < kChunks; ++c)
                    c4[c] = c < chunks ? part[c * p.TP * 128 + e] : 0.0;
#pragma unroll
                for (int s = 1; s < kChunks; s <<= 1)
#pragma unroll
                    for (int c = 0; c + s < kChunks; c += 2 * s)
                        if (c + s < chunks)
                            c4[c] = __dadd_rn(c4[c], c4[c + s]);
                v[m] = c4[0];
            }
#pragma unroll
            for (int s = 1; s < 16; s <<= 1)
#pragma unroll
                for (int m = 0; m < 16; m += 2 * s)
                    v[m] = __dadd_rn(v[m], v[m + s]);
            total[l - lo] = s0 == 0 ? v[0] : __dadd_rn(total[l - lo], v[0]);
        }
    }
    for (int l = lo + threadIdx.x; l <= hi; l += blockDim.x)
        out[(size_t)blockIdx.x * L + l] = __dmul_rn(total[l - lo], norm);
}

template <int TW>
int launch(const void* work, void* out, int V, int n, int L, int F,
           double divisor, double scale, cudaStream_t stream) {
    const Plan p = make_plan(L);
    const int bytes = (int)sizeof(double) * smem_doubles(p);
    cudaError_t e = cudaFuncSetAttribute(
        autocorr_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
    autocorr_kernel<TW><<<dim3(V, p.passes), 32 * kChunks * p.runs, bytes,
                          stream>>>(
        (const int32_t*)work, (double*)out, n, L, F, (double)F / (double)n,
        divisor, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// work (V, n) int32, out (V, L) f64; 1 <= L <= 1024, F a power of two
// >= n; divisor and scale make the window (window() above).
extern "C" int srla_autocorr(const void* work, void* out, int V, int n,
                             int L, int F, double divisor, double scale,
                             void* stream) {
    if (L < 1 || L > kMaxLags || n < 1 || F < n)
        return (int)cudaErrorInvalidValue;
    using Launch = int (*)(const void*, void*, int, int, int, int, double,
                           double, cudaStream_t);
    static const Launch kLaunch[kMaxRun + 1] = {
        nullptr, nullptr, launch<2>, launch<3>, launch<4>, launch<5>,
        launch<6>, launch<7>, launch<8>, launch<9>, launch<10>};
    return kLaunch[make_plan(L).TW](work, out, V, n, L, F, divisor, scale,
                                    (cudaStream_t)stream);
}
