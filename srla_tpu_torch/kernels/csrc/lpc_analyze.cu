// K7: the encode's LPC analysis of each row, from its lags to its integer
// coefficients, in one launch.
//
// Replaces the XLA programs srla_tpu/kernels/exact.py:_levinson_dd (fori
// :229, body :195), _select_order_exact (:260, fori :317), the second
// _levinson_dd at the chosen orders and _quantize_exact (:330, fori :394),
// each decision with its margin flag. Its plain version, the arithmetic it
// must equal, is kernels/levinson.py:lpc_analyze_plain. Per row:
//
//   1. the Levinson-Durbin recursion to order M (<= 255) on the lags (the
//      ridge already on lag 0): the error variances, the silent test, the
//      conditioning estimate kappa' = r0 / min |ev| times the square of
//      the largest sum_j |a[j]| of the recursion's vectors (levinson.py,
//      above _EPS_SILENT) and the non-finite flag;
//   2. the code-length argmin over orders 1..M of the window-corrected
//      error variances (the first strict minimum wins, as argmin) with its
//      tie flag, kept as a running minimum and runner-up;
//   3. the coefficients at the chosen order: a copy of the recursion's own
//      vector at that order, so the same reflection coefficients and the
//      same updates as the plain version's second recursion, with no
//      replay;
//   4. the backward error-feedback quantization with its frexp, tiny and
//      rounding flags.
//
// With SVR (--svr-filter-learning-iteration) the encode needs the f64
// coefficients between steps 3 and 4: the entry srla_lpc_coefs runs steps
// 1-3 and writes the coefficients at the chosen order, kappa' and the flags
// of steps 1-2 (kernels/levinson.py:lpc_coefs_plain), and srla_lpc_quantize
// runs step 4 alone, eight lanes a row (last paragraph), on the refined
// coefficients with its rounding margin widened by SVR's error bound
// (levinson.py:lpc_quantize_plain, kernels/svr.py for the bound).
//
// f64 throughout, every operation written as the plain version writes it
// and rounded as a torch op rounds it: __dmul_rn, __dadd_rn, __dsub_rn,
// __ddiv_rn and __dsqrt_rn, so no multiply-add is contracted and the build
// keeps nvcc's default flags (log() is then the same libdevice function as
// torch's). The one intended difference is the order of gamma's sum: each
// of a row's G lanes sums the terms j = lane, lane + G, ... in order, then
// an xor-butterfly of log2 G levels combines the G lanes;
// kernels/levinson.py (above _EPS_SILENT) shows that the margins cover any
// order.
//
// What bounds it on an H100: nothing the card is rated by. The bytes are
// the (V, M + 1) lags in and (V, M) coefficients out, 4 MB at the main
// path's 5164 rows x 65 lags (0.001 ms), the f64 operations ~V (2 M^2 +
// 30 M) (0.002 ms). Each row is a chain of M - 1 dependent steps (a sum
// over the row's coefficients, a G-lane butterfly, a division, the
// update), so the kernel is latency-bound: its floor is M - 1 such steps
// (csrc/chain_probe.cu, kind 3, times the step of M <= 64 on the card).
//
// Design: a group of G lanes per row (G = 8 at M <= 64, 16 at M <= 128, 32
// above), so a warp serves 32 / G rows and each scalar instruction of a
// step (the division, the error variance, the flags, the quantization
// chain) serves them all. The recursion writes each order's coefficients
// out of place into a ring of 8 vectors in shared memory, so the last 8
// orders' vectors are all there: after every 8th order the group's first 8
// lanes compute those 8 orders' code lengths at once (two logarithms, a
// square root and two divisions a lane, in parallel instead of once a
// step on the recursion's chain), merge them into the running argmin and
// runner-up, and copy the vector of a new best order out of the ring. The
// lags, the best vector and the ring sit in shared memory (10 M + 19
// doubles a row, 41-42 KB a CTA at any M); every lane of a group computes the
// row's scalars, so nothing diverges inside a group; rows past V are
// computed on the last row and not stored, so every mask is the full
// warp.
//
// srla_lpc_quantize, step 4 alone. Its bytes are the (V, M) f64
// coefficients and each row's order, kappa' and cerr in, the (V, M) int32
// values, shift and flag out: 4 MB at 5164 rows x 64 (0.0012 ms). Its
// floor is a row's chain: `order` dependent steps of quantize_row's loop
// (the fed-back error, the rounding half away from zero, the clamp, the new
// error: about ten dependent f64 operations a step), which
// csrc/chain_probe.cu kind 7 times alone. Design: a CTA is one warp, a row
// a group of kQuantLanes = 8 lanes, 4 rows a warp, as in the fused kernel.
// The warp stages its rows, which lie end to end in coefs, into shared
// memory with every copy in flight at once (cp.async, 256 contiguous bytes
// a warp instruction), each row at an odd stride of doubles so that the
// groups' reads fall in distinct banks; each lane takes the largest |c| of
// its part of the row in four chains, a butterfly gives the row's, each
// lane runs quantize_row on the row (the group alike, so nothing diverges
// in a group) into an int32 tile of the same stride, and the warp writes
// the rows' values back end to end, 32 consecutive words an instruction, 0
// past each order. 5164 rows make 1291 CTAs, ten warps an SM, so the
// staging, the stores and the chains of different warps overlap. A row a
// lane (kQuantLanes = 1, 32 rows a warp, 162 CTAs) runs no chain twice but
// leaves an SM one warp, whose staging and stores then run alone: it
// measured slower (PERF.md). A tile takes 12 (M | 1) bytes a row.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 2;
constexpr int kBatch = 8;                  // orders a batch of code lengths
// A lane's terms of gamma's sum (j = lane + G i < m) and pairs of the
// update (j <= m / 2): G * kTerms >= M and G * kPairs > M / 2 for every G
// (and G * (kTerms + 1) > M: a vector's M + 1 entries).
constexpr int kTerms = 8;
constexpr int kPairs = 5;
constexpr unsigned kFull = 0xffffffffu;
// The plain version's constants (kernels/levinson.py, rice.py).
constexpr double kFltEpsilon = 1.1920928955078125e-07;
constexpr double kEpsSilent = 1e-6 * kFltEpsilon;    // _EPS_SILENT * FLT_EPS
constexpr double kEpsOrderBase = 1e-6;               // _EPS_ORDER_BASE
constexpr double kEpsQuantBase = 1e-7;               // _EPS_QUANT_BASE
constexpr double kKappaScale = 1.0 / 1099511627776.0;  // 2^-40
constexpr double kInvLoge2 = 1.4426950408889634;     // _INV_LOGE2
constexpr double kFrexpTop = 1.0 - 1e-7;
constexpr double kSvrQuantScale = 4.0;               // SVR_QUANT_SCALE
// srla_lpc_quantize's lanes a row: 8, 4 rows a warp (the header's last
// paragraph).
constexpr int kQuantLanes = 8;
constexpr int kStoreRuns = 4;              // its stores a lane in flight

// Doubles a row: the lags, the best order's vector, the ring.
__host__ __device__ constexpr int row_doubles(int M) {
    return (M + 1) + (kBatch + 1) * (M + 2);
}

// torch.max: a NaN wins.
__device__ __forceinline__ double nan_max(double a, double b) {
    return a != a ? a : (b != b ? b : (b > a ? b : a));
}

// |e| where it is positive, else inf: an entry of min |ev|.
__device__ __forceinline__ double pos_abs(double e) {
    const double ea = fabs(e);
    return ea > 0.0 ? ea : CUDART_INF;
}

// The estimated code length of an order from its window-corrected error
// variance e (levinson.py:select_order_exact); `near` is its mabse flag.
__device__ __forceinline__ double code_length(double e, int order, int n,
                                              int nbits, double intscale,
                                              bool& near) {
    const bool neg = e < 0.0;
    const double mabse = __dmul_rn(
        2.0, __dsqrt_rn(__dmul_rn(neg ? 0.0 : e, 0.5)));
    const double rho = __ddiv_rn(
        1.0, __dadd_rn(1.0, __dmul_rn(mabse, intscale)));
    const double invrho = __dsub_rn(1.0, rho);
    const double t1 = __dmul_rn(
        invrho, __dmul_rn(log(invrho <= 0.0 ? 0.5 : invrho), kInvLoge2));
    const double t2 = __dmul_rn(
        rho, __dmul_rn(log(rho <= 0.0 ? 0.5 : rho), kInvLoge2));
    const double ent = mabse < 1e-16
        ? 0.0 : __ddiv_rn(-__dadd_rn(t1, t2), rho);
    const double length = __dadd_rn(__dmul_rn(ent, (double)n),
                                    (double)(nbits * order));
    near |= !neg && fabs(__dsub_rn(mabse, 1e-16)) < 1e-17;
    return neg || !isfinite(length) ? CUDART_INF : length;
}

// The rounding margin of the quantization, in quantized units
// (levinson.py:quantize_exact): K7's own, widened by SVR's coefficient
// error bound cerr where one is given.
__device__ __forceinline__ double quant_eps(double qmax, double kappa,
                                            double scale, double cerr) {
    const double eps = fmax(
        __dmul_rn(__dmul_rn(2.0 * qmax, kappa), kKappaScale), kEpsQuantBase);
    return cerr < 0.0 ? eps
                      : fmax(eps, __dmul_rn(__dmul_rn(kSvrQuantScale, scale),
                                            cerr));
}

// A quantized value as the plain version stores it: as a double, or as
// int32 through int64 (torch's .long(), then int32), so that a NaN gives 0
// there as in the plain version.
__device__ __forceinline__ void put_q(double& q, double v) { q = v; }
__device__ __forceinline__ void put_q(int32_t& q, double v) {
    q = (int32_t)(long long)v;
}

// Step 4 on the coefficients coef[1 .. order] (coef[0] unused) of largest
// magnitude maxabs, cerr < 0 for K7's own margin: writes the quantized
// values to q[0 .. order - 1] and the shift to rshift, returns the flags.
template <typename T>
__device__ __forceinline__ bool quantize_row(const double* __restrict__ coef,
                                             int order,
                                             bool silent, double maxabs,
                                             double kappa, double cerr,
                                             int nbits, int max_bits,
                                             int& rshift,
                                             T* __restrict__ q) {
    const double qmax = (double)(1 << (nbits - 1));
    const double tiny_thresh = ldexp(1.0, -(nbits - 1));
    const bool tiny = maxabs <= tiny_thresh;
    bool risky = fabs(__dsub_rn(maxabs, tiny_thresh))
        < __dmul_rn(tiny_thresh, 1e-6);
    int e2 = 0;
    const double mant = frexp(maxabs, &e2);
    risky |= !tiny && (fabs(__dsub_rn(mant, 0.5)) < 1e-7
                       || mant > kFrexpTop);
    rshift = (nbits - 1) - (maxabs == 0.0 ? 0 : e2);
    if (rshift >= max_bits || rshift < 0) rshift = max_bits - 1;
    if (tiny) rshift = nbits;
    const double scale = ldexp(1.0, rshift);
    const double eps_k = quant_eps(qmax, kappa, scale, cerr);
    double qerr = 0.0;
    // Each step's coefficient is read a step ahead: a read issued behind
    // the last step's store would wait on the chain.
    double next = order > 0 ? coef[order] : 0.0;
#pragma unroll 4
    for (int o = order - 1; o >= 0; --o) {
        const double c = next;
        next = o > 0 ? coef[o] : 0.0;
        const double qe = __dadd_rn(qerr, __dmul_rn(
            silent ? 0.0 : c, scale));
        const double ax = fabs(qe);
        const double r = floor(__dadd_rn(ax, 0.5));
        double qt = qe < 0.0 ? -r : r;
        qt = qt < -qmax ? -qmax : (qt > qmax - 1.0 ? qmax - 1.0 : qt);
        risky |= fabs(__dsub_rn(__dsub_rn(ax, floor(ax)), 0.5)) < eps_k;
        qerr = __dsub_rn(qe, qt);
        put_q(q[o], tiny ? 0.0 : qt);
    }
    return risky || !isfinite(maxabs);
}

template <int G, bool kCoefsOnly>
__global__ void __launch_bounds__(kWarps * 32)
lpc_analyze_kernel(const double* __restrict__ lags,
                   int32_t* __restrict__ orders_out,
                   int32_t* __restrict__ rshifts_out,
                   int32_t* __restrict__ intc_out,
                   uint8_t* __restrict__ risky_out,
                   double* __restrict__ coefs_out,
                   double* __restrict__ kappa_out, int V, int n, int bps,
                   int M, int max_fixed, int nbits, int max_bits,
                   double wiss) {
    constexpr int R = 32 / G;              // rows a warp
    extern __shared__ double smem[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int gl = lane & (G - 1);         // the lane within its row's group
    const int slot = lane / G;
    const int first = (blockIdx.x * kWarps + warp) * R;
    if (first >= V) return;                // whole warps leave together
    const bool stored = first + slot < V;
    const int row = stored ? first + slot : V - 1;
    double* ac = smem + (warp * R + slot) * row_doubles(M);
    double* best = ac + (M + 1);           // the best order's coefficients
    double* ring = best + (M + 2);         // order o's in slot o % kBatch
    const int stride = M + 2;
    const double* src = lags + (size_t)row * (M + 1);
    for (int j = gl; j <= M; j += G) ac[j] = src[j];
    for (int j = gl; j < kBatch * stride; j += G) ring[j] = 0.0;
    __syncwarp();

    // 1. Levinson to M (levinson.py:levinson), with 2. the order choice
    //    (levinson.py:select_order_exact) a batch of orders at a time.
    const double r0 = ac[0];
    const double a1 = __ddiv_rn(-ac[1], r0 == 0.0 ? 1.0 : r0);
    double evk = __dadd_rn(r0, __dmul_rn(ac[1], a1));
    if (gl == 0) {
        ring[stride] = 1.0;
        ring[stride + 1] = a1;
    }
    const double absr0 = fabs(r0);
    const bool silent = absr0 < kFltEpsilon;
    double min_ev = fmin(pos_abs(r0), pos_abs(evk));
    bool nonfinite = !isfinite(r0) || !isfinite(evk);
    const double intscale = (double)(1 << (bps - 1));
    double growth = 1.0;     // the largest sum_j |a[j]| of a vector so far
    double my_ev = evk;      // lane l: order o's, o = l + 1 (mod kBatch)
    double best_len = CUDART_INF;
    double second = CUDART_INF;            // the least length of the others
    int bi = -1;
    bool near = false;
    __syncwarp();
    for (int m = 1; m <= M; ++m) {
        if (m >= 2) {
            const double* prev = ring + ((m - 1) % kBatch) * stride;
            double* cur = ring + (m % kBatch) * stride;
            // The step's loads first: the lane's terms j = gl + G i < m
            // and its pairs' far ends m - j, j <= m / 2.
            double aj[kTerms], am[kPairs];
#pragma unroll
            for (int i = 0; i < kTerms; ++i) {
                const int j = gl + G * i;
                aj[i] = j < m ? prev[j] : 0.0;
                if (i < kPairs) am[i] = 2 * j <= m ? prev[m - j] : 0.0;
            }
            double s = 0.0;
#pragma unroll
            for (int i = 0; i < kTerms; ++i) {
                const int j = gl + G * i;
                if (j < m) s = __dadd_rn(s, __dmul_rn(aj[i], ac[m - j]));
            }
            // The growth of the order m - 1 vector: its |a[j]| summed in
            // the order levinson.py:group_abs_sum emulates.
            double sa = 0.0;
#pragma unroll
            for (int i = 0; i < kTerms; ++i) sa = __dadd_rn(sa, fabs(aj[i]));
#pragma unroll
            for (int off = 1; off < G; off <<= 1) {
                s = __dadd_rn(s, __shfl_xor_sync(kFull, s, off, G));
                sa = __dadd_rn(sa, __shfl_xor_sync(kFull, sa, off, G));
            }
            growth = fmax(growth, sa);
            const double g = __ddiv_rn(s, -(evk == 0.0 ? 1.0 : evk));
            evk = __dmul_rn(evk, __dsub_rn(1.0, __dmul_rn(g, g)));
            // cur = prev + g * flip(prev[0..m]) over the pairs (j, m - j),
            // without a branch: a store with nothing to store goes to slot
            // M + 1, which nothing reads.
#pragma unroll
            for (int i = 0; i < kPairs; ++i) {
                const int j = gl + G * i;
                const bool pair = 2 * j <= m;
                cur[pair ? j : M + 1] = __dadd_rn(aj[i], __dmul_rn(g, am[i]));
                cur[pair && m - j != j ? m - j : M + 1] =
                    __dadd_rn(am[i], __dmul_rn(g, aj[i]));
            }
            min_ev = fmin(min_ev, pos_abs(evk));
            nonfinite |= !isfinite(evk);
            if (gl == (m - 1) % kBatch) my_ev = evk;
            __syncwarp();
        }
        if (m % kBatch != 0 && m != M) continue;
        // The batch of orders o0 .. m, order o0 + l on lane l.
        const int o0 = m - (m - 1) % kBatch;
        const int o = o0 + gl;
        const double len = o <= m
            ? code_length(__dmul_rn(silent ? r0 : my_ev, wiss), o, n, nbits,
                          intscale, near)
            : CUDART_INF;
        double bmin = len;                 // the batch's first minimum
        int bo = o;
#pragma unroll
        for (int off = 1; off < G; off <<= 1) {
            const double ol = __shfl_xor_sync(kFull, bmin, off, G);
            const int oo = __shfl_xor_sync(kFull, bo, off, G);
            if (ol < bmin || (ol == bmin && oo < bo)) {
                bmin = ol;
                bo = oo;
            }
        }
        double bsec = o == bo ? CUDART_INF : len;
#pragma unroll
        for (int off = 1; off < G; off <<= 1)
            bsec = fmin(bsec, __shfl_xor_sync(kFull, bsec, off, G));
        if (bi < 0 || bmin < best_len) {
            second = fmin(fmin(second, best_len), bsec);
            best_len = bmin;
            bi = bo - 1;
            const double* v = ring + (bo % kBatch) * stride;
#pragma unroll
            for (int i = 0; i <= kTerms; ++i)
                if (gl + G * i <= bo) best[gl + G * i] = v[gl + G * i];
        } else {
            second = fmin(second, bmin);
        }
        __syncwarp();
    }
#pragma unroll
    for (int off = 1; off < G; off <<= 1)
        near |= __shfl_xor_sync(kFull, (int)near, off, G) != 0;
    if (silent) min_ev = pos_abs(r0);
    const bool ok = isfinite(min_ev) && min_ev > 0.0;
    double kappa = silent ? 1.0 : __ddiv_rn(absr0, ok ? min_ev : 1.0);
    if (!(isfinite(kappa) && kappa >= 1.0)) kappa = CUDART_INF;
    if (!silent) kappa = __dmul_rn(__dmul_rn(kappa, growth), growth);
    bool risky = fabs(__dsub_rn(absr0, kFltEpsilon)) < kEpsSilent;
    risky |= nonfinite && !silent;
    int order = M;
    if (!max_fixed) {
        const double gap = __dsub_rn(second, best_len);
        const double eps = fmax(
            __dmul_rn(__dmul_rn((double)n, kappa), kKappaScale),
            kEpsOrderBase);
        risky |= near || !isfinite(best_len)
            || (isfinite(gap) && gap < eps);
        order = bi + 1;
    }
    // 3. The chosen order's coefficients.
    const double* coef = max_fixed ? ring + (M % kBatch) * stride : best;
    if (kCoefsOnly) {                      // srla_lpc_coefs stops here
        if (!stored) return;
        double* out = coefs_out + (size_t)row * M;
        for (int j = gl; j < M; j += G)
            out[j] = j < order && !silent ? coef[j + 1] : 0.0;
        if (gl == 0) {
            orders_out[row] = order;
            kappa_out[row] = kappa;
            risky_out[row] = risky ? 1 : 0;
        }
        return;
    }

    // 4. Quantization (levinson.py:quantize_exact).
    double maxabs = 0.0;
    for (int j = gl; j < order; j += G)
        maxabs = nan_max(maxabs, silent ? 0.0 : fabs(coef[j + 1]));
#pragma unroll
    for (int off = 1; off < G; off <<= 1)
        maxabs = nan_max(maxabs, __shfl_xor_sync(kFull, maxabs, off, G));
    int rshift = 0;
    // The quantized values overwrite the lags, no longer needed.
    risky |= quantize_row(coef, order, silent, maxabs, kappa, -1.0, nbits,
                          max_bits, rshift, ac);
    __syncwarp();
    if (!stored) return;
    int32_t* intc = intc_out + (size_t)row * M;
    for (int o = gl; o < M; o += G) intc[o] = o < order ? (int32_t)ac[o] : 0;
    if (gl == 0) {
        orders_out[row] = order;
        rshifts_out[row] = rshift;
        risky_out[row] = risky ? 1 : 0;
    }
}

// srla_lpc_quantize: step 4 alone on given coefficients, kQuantLanes lanes
// a row (the header's last paragraph has the design).
template <int G>
__global__ void __launch_bounds__(32)
lpc_quantize_kernel(const double* __restrict__ coefs,
                    const int32_t* __restrict__ orders,
                    const double* __restrict__ kappa,
                    const double* __restrict__ cerr,
                    int32_t* __restrict__ rshifts_out,
                    int32_t* __restrict__ intc_out,
                    uint8_t* __restrict__ risky_out, int V, int M, int nbits,
                    int max_bits) {
    constexpr int R = 32 / G;              // rows a warp (and a CTA)
    extern __shared__ double qsmem[];
    __shared__ int ord_s[R];
    const int S = M | 1;                   // an odd stride: no bank conflict
    double* tile = qsmem;                  // R rows of S coefficients
    int32_t* qtile = reinterpret_cast<int32_t*>(qsmem + R * S);
    const int lane = threadIdx.x;
    const int slot = lane / G, gl = lane % G;
    const int first = blockIdx.x * R;
    const int rows = min(R, V - first);
    const int count = rows * M;            // the tile's rows lie end to end
    // Stage: the tile's rows lie end to end in coefs; every copy in
    // flight at once (cp.async, 8 bytes a lane, 256 contiguous bytes a
    // warp instruction: a padded row is no 16-byte aligned destination).
    const double* src = coefs + (size_t)first * M;
    {
        int r = 0, c = lane;               // element k = r M + c
        while (c >= M) { c -= M; ++r; }
        for (int k = lane; k < count; k += 32) {
            __pipeline_memcpy_async(tile + r * S + c, src + k,
                                    sizeof(double));
            c += 32;
            while (c >= M) { c -= M; ++r; }
        }
        __pipeline_commit();
    }
    const bool live = slot < rows;
    const int row = first + (live ? slot : 0);
    // The plain version reads no coefficient at or past M.
    const int order = live ? min(max(orders[row], 0), M) : 0;
    if (gl == 0) ord_s[slot] = order;
    __pipeline_wait_prior(0);
    __syncwarp();
    // The largest |c[j]|, j < order (a NaN wins, as torch.max), in four
    // chains a lane, then over the row's G lanes.
    const double* c = tile + slot * S;
    double m0 = 0.0, m1 = 0.0, m2 = 0.0, m3 = 0.0;
    int j = gl;
    for (; j + 3 * G < order; j += 4 * G) {
        m0 = nan_max(m0, fabs(c[j]));
        m1 = nan_max(m1, fabs(c[j + G]));
        m2 = nan_max(m2, fabs(c[j + 2 * G]));
        m3 = nan_max(m3, fabs(c[j + 3 * G]));
    }
    for (; j < order; j += G) m0 = nan_max(m0, fabs(c[j]));
    double maxabs = nan_max(nan_max(m0, m1), nan_max(m2, m3));
#pragma unroll
    for (int off = 1; off < G; off <<= 1)
        maxabs = nan_max(maxabs, __shfl_xor_sync(kFull, maxabs, off, G));
    int rshift = 0;
    bool risky = false;
    if (live) {
        risky = quantize_row(c - 1, order, false, maxabs, kappa[row],
                             cerr[row], nbits, max_bits, rshift,
                             qtile + slot * S);
        if (gl == 0) {
            rshifts_out[row] = rshift;
            risky_out[row] = risky ? 1 : 0;
        }
    }
    __syncwarp();
    // The tile's rows back, end to end, 0 past each order: kStoreRuns
    // shared reads in flight, then their stores.
    int32_t* dst = intc_out + (size_t)first * M;
    int r = 0, cc = lane;
    while (cc >= M) { cc -= M; ++r; }
    for (int k0 = lane; k0 < count; k0 += 32 * kStoreRuns) {
        int32_t v[kStoreRuns];
#pragma unroll
        for (int u = 0; u < kStoreRuns; ++u) {
            v[u] = k0 + 32 * u < count && cc < ord_s[r]
                ? qtile[r * S + cc] : 0;
            cc += 32;
            while (cc >= M) { cc -= M; ++r; }
        }
#pragma unroll
        for (int u = 0; u < kStoreRuns; ++u)
            if (k0 + 32 * u < count) dst[k0 + 32 * u] = v[u];
    }
}

template <int G, bool kCoefsOnly>
int launch(const void* lags, void* orders, void* rshifts, void* intc,
           void* risky, void* coefs, void* kappa, int V, int n, int bps,
           int M, int max_fixed, int nbits, int max_bits, double wiss,
           cudaStream_t stream) {
    constexpr int rows = kWarps * (32 / G);
    const size_t bytes = sizeof(double) * (size_t)rows * row_doubles(M);
    const int blocks = (V + rows - 1) / rows;
    lpc_analyze_kernel<G, kCoefsOnly><<<blocks, kWarps * 32, bytes, stream>>>(
        (const double*)lags, (int32_t*)orders, (int32_t*)rshifts,
        (int32_t*)intc, (uint8_t*)risky, (double*)coefs, (double*)kappa, V, n,
        bps, M, max_fixed, nbits, max_bits, wiss);
    return (int)cudaGetLastError();
}

template <bool kCoefsOnly>
int dispatch(const void* lags, void* orders, void* rshifts, void* intc,
             void* risky, void* coefs, void* kappa, int V, int n, int bps,
             int M, int max_fixed, int nbits, int max_bits, double wiss,
             void* stream) {
    if (M < 1 || M > 255 || bps < 1 || bps > 31 || nbits < 1 || nbits > 31)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (M <= 64)
        return launch<8, kCoefsOnly>(lags, orders, rshifts, intc, risky,
                                     coefs, kappa, V, n, bps, M, max_fixed,
                                     nbits, max_bits, wiss, s);
    if (M <= 128)
        return launch<16, kCoefsOnly>(lags, orders, rshifts, intc, risky,
                                      coefs, kappa, V, n, bps, M, max_fixed,
                                      nbits, max_bits, wiss, s);
    return launch<32, kCoefsOnly>(lags, orders, rshifts, intc, risky, coefs,
                                  kappa, V, n, bps, M, max_fixed, nbits,
                                  max_bits, wiss, s);
}

}  // namespace

// lags (V, M + 1) f64 with the ridge on lag 0, 1 <= M <= 255; orders,
// rshifts (V,) int32, intc (V, M) int32, risky (V,) bool; wiss the Welch
// window's inverse squared sum for n.
extern "C" int srla_lpc_analyze(const void* lags, void* orders,
                                void* rshifts, void* intc, void* risky,
                                int V, int n, int bps, int M, int max_fixed,
                                int nbits, int max_bits, double wiss,
                                void* stream) {
    return dispatch<false>(lags, orders, rshifts, intc, risky, nullptr,
                           nullptr, V, n, bps, M, max_fixed, nbits, max_bits,
                           wiss, stream);
}

// Steps 1-3 (srla_lpc_coefs): orders (V,) int32, coefs (V, M) f64
// left-aligned (0 past the order and on silent rows), kappa (V,) f64, risky
// (V,) bool with the flags of steps 1 and 2.
extern "C" int srla_lpc_coefs(const void* lags, void* orders, void* coefs,
                              void* kappa, void* risky, int V, int n,
                              int bps, int M, int max_fixed, double wiss,
                              void* stream) {
    return dispatch<true>(lags, orders, nullptr, nullptr, risky, coefs,
                          kappa, V, n, bps, M, max_fixed, 8, 16, wiss,
                          stream);
}

// Step 4 (srla_lpc_quantize): coefs (V, M) f64 left-aligned, orders (V,)
// int32, kappa and cerr (V,) f64; rshifts (V,) int32, intc (V, M) int32,
// risky (V,) bool.
extern "C" int srla_lpc_quantize(const void* coefs, const void* orders,
                                 const void* kappa, const void* cerr,
                                 void* rshifts, void* intc, void* risky,
                                 int V, int M, int nbits, int max_bits,
                                 void* stream) {
    if (M < 1 || M > 255 || nbits < 1 || nbits > 31)
        return (int)cudaErrorInvalidValue;
    constexpr int R = 32 / kQuantLanes;
    const size_t bytes = (size_t)R * (M | 1) * (sizeof(double)
                                                + sizeof(int32_t));
    if (bytes > 48 * 1024) {               // a lane a row at M > 130
        const cudaError_t err = cudaFuncSetAttribute(
            lpc_quantize_kernel<kQuantLanes>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return (int)err;
    }
    lpc_quantize_kernel<kQuantLanes><<<(V + R - 1) / R, 32, bytes,
                                       (cudaStream_t)stream>>>(
        (const double*)coefs, (const int32_t*)orders, (const double*)kappa,
        (const double*)cerr, (int32_t*)rshifts, (int32_t*)intc,
        (uint8_t*)risky, V, M, nbits, max_bits);
    return (int)cudaGetLastError();
}
