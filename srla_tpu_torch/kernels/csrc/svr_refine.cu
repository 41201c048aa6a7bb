// K12: SVR refinement of each row's LPC coefficients
// (--svr-filter-learning-iteration), after K11's covariance.
//
// Replaces the XLA programs srla_tpu/kernels/exact.py:_svr_exact (:775, its
// margin x iteration loop :834), _cholesky_dd (:629), _cholesky_solve_dd
// (:687) and _rgr_code_length_dd (:733). Its plain version, the arithmetic
// it must equal bit for bit, is kernels/svr.py:svr_refine_plain, which
// follows the host's dsp/svr.py:svr_refine_one and dsp/pitch.py's Cholesky.
// Per row:
//
//   1. the Cholesky factor of the ridged covariance's o x o block, each
//      pivot and entry a chain over k = i - 1 .. 0 as the host's, 1/sqrt
//      for its pow(s, -0.5), with the singular and pivot flags;
//   2. the bounds of svr.py's margins (trace, lam, max|d|, e_0, the
//      largest diagonal entry of C^-1 from the factor);
//   3. for each margin and each iteration, from cur = the initial vector:
//      the residual (taps in order), the mean-abs chain and, except at the
//      last iteration, the r-vector chains over s in order, the estimate
//      and its k2 flag, the forward and backward solves in the host's
//      order, the stop decision with its flag, the step and the error
//      bound's update; then the adopt decisions with their flags;
//   4. the adopted vector (zero on singular rows), its error bound, the
//      flag and the iterations run (for the bound of chip_smoke.py).
//
// f64 throughout, every operation as the plain version writes it; the
// build passes -fmad=false (kernels/build.py), so no multiply-add is
// contracted, and log, pow and sqrt are libdevice's, as torch's on the
// card. There is no iterative-refinement step: the host has none.
//
// What bounds it on an H100: the f64 vector pipe (~17 T instructions/s)
// and, about as close behind, shared memory (128 B a clock an SM). A row
// of order o runs one residual of the initial vector (all margins score it
// first), one residual a margin for each later iteration, and the r-vector
// chains of every iteration but the last: 2 o (n - o) f64 instructions
// each, ~7 M a row at o 64, n 4096 and 2 iterations. Its serial floor is
// an iteration's chains (n dependent adds) for each iteration and a solve
// (~o^2 dependent steps) between two. As built it reaches neither: its
// chain loops wait on shared loads, under the register cap of 3 CTAs an
// SM (PERF.md, PR 13), so the slots' state lives in shared memory and the
// residual loop loads a step ahead.
//
// Design: a CTA per row, all margins of the row in flight at once (the
// margins' trajectories are independent; only the adopt bookkeeping joins
// them, and it is replayed in (margin, iteration) order at the end from a
// few stored scalars an iteration). The row is staged once in shared
// memory as f64 (the samples times 2^-(bps - 1) are exact), as int32
// scaled on read where f64 does not fit; the factor, packed, beside it
// where it fits (the main path's rows of 4096 at M 64: 71 KB, 3 CTAs an
// SM), else in the row's slice of a global scratch. An iteration streams
// the residuals through two tiles of 64 samples: warps 4-7 make the next
// tile (16 samples x 2 groups of 3 margins a warp, three residual chains a
// thread) while warps 0-3 (and 4-7 past order 64) run the r-vector chains
// over the current one (16 taps x 2 margin groups a warp: a sample's
// shared load feeds three chains) and warp 8 the mean-abs and |th| chains,
// a lane a margin. That lane then decides, solves and steps for its
// margin. The last iteration makes only residuals and mean-abs chains.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 9;
constexpr int kThreads = 32 * kWarps;
constexpr int kChainWarps = 8;            // warps 0-7: r-vector chains
constexpr int kTapsAPass = kChainWarps * 16;
constexpr int kProdWarp = 4;              // warps 4-7: residual producers
constexpr int kScalarWarp = 8;            // a lane a margin
constexpr int kSlots = 6;                 // margins in flight
constexpr int kT = 64;                    // samples a tile
// A tile's sample: th of the six margins, then |r|, each in the slot order
// A0 A1 B0 B1 A2 B2 (group A: margins 0-2 of the batch, B: 3-5), so that a
// group reads its first two as one 16-byte load.
constexpr int kTS = 12;
constexpr int kTileDoubles = kT * kTS;
// Dynamic shared memory a CTA may take: an H100's 227 KB less a KB for
// the static variables (svr.py's _SMEM_BYTES).
constexpr size_t kSmemBytes = 227 * 1024 - 1024;
constexpr double kU = 1.1102230246251565e-16;     // 2^-53
constexpr double kLn2 = 0.6931471805599453;       // math.log(2.0)
constexpr double kInvLoge2 = 1.4426950408889634;  // svr.py INV_LOGE2

__device__ __forceinline__ double gamma_of(double m) {
    return m * kU / (1.0 - m * kU);
}

// The tile slot of the batch's margin m.
__device__ __forceinline__ int tslot(int m) {
    return m == 2 ? 4 : (m == 5 ? 5 : (m < 2 ? m : m - 1));
}

// Row i of the factor's strict lower triangle, packed: L(i, k) at
// tri(i) + k, k < i.
__device__ __forceinline__ size_t tri(int i) {
    return (size_t)i * (size_t)(i - 1) / 2;
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The staged row: f64 samples, or int32 samples scaled on read.
template <typename T>
struct Row {
    const T* v;
    double scale;
    __device__ __forceinline__ double operator[](int k) const {
        if constexpr (sizeof(T) == sizeof(double)) return v[k];
        else return (double)v[k] * scale;
    }
};

struct Consts {
    int n, M, max_iter, n_margins, stride;
    double scale;       // 2^-(bps - 1)
    double lam_ratio;   // ridge / (1 + ridge)
    double log_optx;    // the host's log(0.5127629514)
    double g_sum;       // gamma_n
    double sqrt_n;
    double eps_libm, eps_pivot, init_rel, obj_eps, flt_max;
};

// svr.py:rgr_mean_code_length for one row.
__device__ double code_length(double mean, double eps, double log_optx,
                              bool& risky) {
    const double intmean = mean * 65536.0;
    const double rho = 1.0 / (1.0 + intmean);
    const double om = 1.0 - rho;
    const double lv = log_optx / log(om);
    const double log2v = log(lv) * kInvLoge2;
    const double k2 = floor(log2v < 0.0 ? 0.0 : log2v);
    const double k1 = k2 + 1.0;
    const double k1f = pow(om, (double)(1ll << (long long)k1));
    const double k2f = pow(om, (double)(1ll << (long long)k2));
    const double obj = (1.0 + k1) * (1.0 - k1f)
        + ((1.0 + k2) + (1.0 / (1.0 - k2f))) * k1f;
    const double near = rint(log2v);
    risky |= near >= 1.0 && fabs(log2v - near) < eps;
    return obj;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
svr_refine_kernel(const int32_t* __restrict__ work,
                  const double* __restrict__ cov,
                  const double* __restrict__ coefs,
                  const int32_t* __restrict__ orders,
                  const double* __restrict__ kappa,
                  const double* __restrict__ margins,
                  double* __restrict__ a_scratch,
                  double* __restrict__ hist,
                  double* __restrict__ best_out,
                  double* __restrict__ cerr_out,
                  uint8_t* __restrict__ risky_out,
                  int32_t* __restrict__ iters_out, Consts c) {
    extern __shared__ __align__(16) double smem[];
    const int n = c.n, M = c.M, S = c.stride;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int row = blockIdx.x;
    // [the row (n samples of T, to 16 bytes)] [two tiles] [the factor,
    // packed, where it fits] [vectors of S: init, inv, the diagonal, the
    // row sums of |C|, best; cur, mbest and rv of each slot]. Before the
    // row is staged, the row's place and the tiles hold the columns of
    // L^-1 (Y).
    const size_t row_dbl = ((size_t)n * sizeof(T) + 15) / 16 * 2;
    T* staged = (T*)smem;
    double* tiles = smem + row_dbl;
    double* L = a_scratch ? a_scratch + (size_t)row * tri(M)
                          : tiles + 2 * kTileDoubles;
    double* vec = a_scratch ? tiles + 2 * kTileDoubles
                            : L + ((tri(M) + 1) & ~(size_t)1);
    double* init = vec;
    double* inv = init + S;
    double* cdg = inv + S;
    double* rsum = cdg + S;
    double* best = rsum + S;
    double* cur = best + S;
    double* mbest = cur + kSlots * S;
    double* rv = mbest + kSlots * S;
    // The row's scalars, and each slot's state: kept in shared memory, not
    // in registers, so that the hot loops of every role have the
    // registers (a CTA's 288 threads, 3 CTAs an SM: 72 each).
    __shared__ int s_flag, s_risky, s_src, s_iters;
    __shared__ int s_alive[kSlots], s_nit[kSlots];
    __shared__ double s_maxd, s_cinv, s_e0, s_tr, s_lam;
    __shared__ double s_gres, s_grvec, s_gsolve, s_sqcinv;
    __shared__ double s_minobj, s_epsmin, s_cerr;
    __shared__ double s_marg[kSlots], s_e[kSlots], s_prev[kSlots],
        s_epsp[kSlots], s_mmin[kSlots];

    const double* C = cov + (size_t)row * M * M;
    int o = orders[row];
    o = o < 0 ? 0 : (o > M ? M : o);
    for (int i = tid; i < M; i += kThreads) {
        init[i] = i < o ? coefs[(size_t)row * M + i] : 0.0;
        best[i] = init[i];
        inv[i] = 0.0;
        cdg[i] = C[i * M + i];
    }
    // L(j, i) = C[i][j] above the diagonal (the host factors from the
    // upper triangle), row i of C read along j.
    for (int i = warp; i < o; i += kWarps)
        for (int j = i + 1 + lane; j < o; j += 32) {
            if (a_scratch) L[tri(j) + i] = C[i * M + j];
            else cp_async8(L + tri(j) + i, C + i * M + j);
        }
    cp_async_wait_all();
    if (tid == 0) {
        s_flag = 0;
        s_risky = 0;
        s_maxd = 0.0;
        s_cinv = 0.0;
    }
    __syncthreads();

    // 1. Cholesky (dsp/pitch.py:cholesky_decompose, svr.py:cholesky_plain).
    bool risky0 = false;                      // thread 0's
    for (int i = 0; i < o; ++i) {
        const double* Li = L + tri(i);
        if (tid == 0) {
            double s = cdg[i];
            for (int k = i - 1; k >= 0; --k) s = s - Li[k] * Li[k];
            risky0 |= fabs(s) < cdg[i] * c.eps_pivot;
            if (s <= 0.0) s_flag = 1;
            else inv[i] = 1.0 / sqrt(s);
        }
        __syncthreads();
        if (s_flag) break;
        const double vi = inv[i];
        for (int j = i + 1 + tid; j < o; j += kThreads) {
            double* Lj = L + tri(j);
            double s = Lj[i];
            for (int k = i - 1; k >= 0; --k) s = s - Li[k] * Lj[k];
            Lj[i] = s * vi;
        }
        __syncthreads();
    }
    if (o == 0 || s_flag) {
        for (int i = tid; i < M; i += kThreads)
            best_out[(size_t)row * M + i] = 0.0;
        if (tid == 0) {
            cerr_out[row] = 0.0;
            risky_out[row] = risky0 ? 1 : 0;
            iters_out[row] = 0;
        }
        return;
    }
    if (tid == 0 && risky0) s_risky = 1;

    // 2. The bounds' constants (svr.py, the margins' comment). Row sums of
    // |C| in j order, a thread a row.
    for (int i = tid; i < o; i += kThreads) {
        double inner = 0.0;
        for (int j = 0; j < o; ++j) inner = inner + fabs(C[i * M + j]);
        rsum[i] = inner;
    }
    // max_j (C^-1)_jj: column j of L^-1 by forward substitution on thread
    // j - j0 (y_k = (delta_kj - sum_{m < k} L_km y_m) inv_k, m in order),
    // then (C^-1)_jj = sum_k y_k^2, k in order (svr.py:
    // inverse_diag_max_plain). Columns in batches from j0 that fit the Y
    // place: rows k < j of column j are exact zeros, so a chain started at
    // m = j0 <= j adds the same values as one started at m = 0.
    {
        double* Y = smem;
        const size_t cap = row_dbl + 2 * kTileDoubles;
        double cinv = 0.0;
        for (int j0 = 0; j0 < o;) {
            const int h = o - j0;
            const int B = min(min(kThreads, h), (int)(cap / h));
            if (tid < B) {
                const int j = j0 + tid;
                double dsum = 0.0;
                for (int k = j0; k < o; ++k) {
                    const double* Lk = L + tri(k);
                    double s = k == j ? 1.0 : 0.0;
                    for (int m = j0; m < k; ++m)
                        s = s - Lk[m] * Y[(size_t)(m - j0) * B + tid];
                    const double y = s * inv[k];
                    Y[(size_t)(k - j0) * B + tid] = y;
                    dsum = dsum + y * y;
                }
                cinv = fmax(cinv, dsum);
            }
            j0 += B;
            __syncthreads();                   // Y is reused
        }
        // Non-negative doubles order as their bit patterns do.
        atomicMax((unsigned long long*)&s_cinv,
                  (unsigned long long)__double_as_longlong(cinv));
    }
    // The row, and max|d| on the way.
    {
        const int32_t* src = work + (size_t)row * n;
        double m = 0.0;
        for (int s = tid; s < n; s += kThreads) {
            const int32_t v = src[s];
            if constexpr (sizeof(T) == sizeof(double))
                staged[s] = (double)v * c.scale;
            else
                staged[s] = v;
            m = fmax(m, fabs((double)v * c.scale));
        }
        for (int off = 16; off > 0; off >>= 1)
            m = fmax(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (lane == 0)
            atomicMax((unsigned long long*)&s_maxd,
                      (unsigned long long)__double_as_longlong(m));
    }
    if (tid == 0) {
        double tr = 0.0, mn = CUDART_INF;
        for (int i = 0; i < o; ++i) {
            tr = tr + cdg[i];
            mn = fmin(mn, cdg[i]);
        }
        // e0 = rho max|c| sqrt(1^T |C| 1), each row sum in j order, the
        // rows in i order.
        double total = 0.0, cmax = 0.0;
        for (int i = 0; i < o; ++i) {
            total = total + rsum[i];
            cmax = fmax(cmax, fabs(init[i]));
        }
        s_tr = tr;
        s_lam = mn * c.lam_ratio;
        s_e0 = ((c.init_rel * kappa[row]) * cmax) * sqrt(total);
    }
    __syncthreads();
    const Row<T> d{staged, c.scale};
    if (tid == 0) {
        const double of = (double)o;
        const double sq_lam = sqrt(s_lam);
        s_sqcinv = sqrt(s_cinv);
        s_gres = gamma_of(of + 1.0) * s_maxd * c.sqrt_n;
        s_grvec = c.g_sum * sqrt(of) * s_maxd / sq_lam;
        s_gsolve = 2.0 * gamma_of(3.0 * of + 3.0) * s_tr / sq_lam;
        s_minobj = c.flt_max;
        s_epsmin = 0.0;
        s_cerr = 0.0;
        s_iters = 0;
    }

    // 3. The margins, kSlots at a time; a slot's lane of warp 8 decides
    // for it, lane 0 also replays.
    const bool mthread = warp == kScalarWarp && lane < kSlots;
    const int g = lane >> 4;                   // chain and producer group
    const int ntiles = n > o ? (n - o + kT - 1) / kT : 0;
    for (int b0 = 0; b0 < c.n_margins; b0 += kSlots) {
        const int kb = min(kSlots, c.n_margins - b0);
        for (int k = tid; k < kSlots * S; k += kThreads) cur[k] = init[k % S];
        if (mthread) {
            s_alive[lane] = lane < kb;
            s_marg[lane] = lane < kb ? margins[b0 + lane] : 0.0;
            s_e[lane] = s_e0;
            s_prev[lane] = c.flt_max;
            s_epsp[lane] = 0.0;
            s_mmin[lane] = c.flt_max;
            s_nit[lane] = 0;
        }
        __syncthreads();
        for (int it = 0; it < c.max_iter; ++it) {
            const bool last = it + 1 == c.max_iter;
            const bool ga0 = s_alive[0] | s_alive[1] | s_alive[2];
            const bool ga1 = s_alive[3] | s_alive[4] | s_alive[5];
            if (!ga0 && !ga1) break;
            // The residuals of tile t: at iteration 0 the initial vector's,
            // once, its th for each margin; later each slot's.
            auto produce = [&](int t) {
                if (warp < kProdWarp || warp >= kProdWarp + 4) return;
                const int p = tid - 32 * kProdWarp;
                const int j = (p >> 5) * 16 + (p & 15);
                const int s = o + t * kT + j;
                if (s >= n) return;
                double* out = tiles + (t & 1) * kTileDoubles + j * kTS;
                if (it == 0) {
                    if (g) return;
                    double r = d[s];
                    for (int i = 0; i < o; ++i) r = r + init[i] * d[s - 1 - i];
                    const double a = fabs(r);
                    for (int m = 0; m < kSlots; ++m) {
                        const double v = fmax(a - s_marg[m], 0.0);
                        out[tslot(m)] = r > 0.0 ? v : (r < 0.0 ? -v : 0.0);
                        out[6 + tslot(m)] = a;
                    }
                    return;
                }
                if (!(g ? ga1 : ga0)) return;
                const double* c0 = cur + 3 * g * S;
                const double* c1 = c0 + S;
                const double* c2 = c1 + S;
                const double d0 = d[s];
                double r0 = d0, r1 = d0, r2 = d0;
                // Taps in pairs, the next pair's operands loaded before this
                // pair's adds: the loads' latency overlaps the chains.
                int i = 0;
                if (o >= 2) {
                    double2 a = *(const double2*)c0;
                    double2 b = *(const double2*)c1;
                    double2 q = *(const double2*)c2;
                    double x0 = d[s - 1], x1 = d[s - 2];
                    for (; i + 3 < o; i += 2) {
                        const double2 an = *(const double2*)(c0 + i + 2);
                        const double2 bn = *(const double2*)(c1 + i + 2);
                        const double2 qn = *(const double2*)(c2 + i + 2);
                        const double y0 = d[s - 3 - i], y1 = d[s - 4 - i];
                        r0 = r0 + a.x * x0;
                        r1 = r1 + b.x * x0;
                        r2 = r2 + q.x * x0;
                        r0 = r0 + a.y * x1;
                        r1 = r1 + b.y * x1;
                        r2 = r2 + q.y * x1;
                        a = an; b = bn; q = qn; x0 = y0; x1 = y1;
                    }
                    r0 = r0 + a.x * x0;
                    r1 = r1 + b.x * x0;
                    r2 = r2 + q.x * x0;
                    r0 = r0 + a.y * x1;
                    r1 = r1 + b.y * x1;
                    r2 = r2 + q.y * x1;
                    i += 2;
                }
                if (i < o) {
                    const double x0 = d[s - 1 - i];
                    r0 = r0 + c0[i] * x0;
                    r1 = r1 + c1[i] * x0;
                    r2 = r2 + c2[i] * x0;
                }
                const double rs[3] = {r0, r1, r2};
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    const int m = 3 * g + k;
                    const double a = fabs(rs[k]);
                    const double v = fmax(a - s_marg[m], 0.0);
                    out[tslot(m)] = rs[k] > 0.0 ? v : (rs[k] < 0.0 ? -v : 0.0);
                    out[6 + tslot(m)] = a;
                }
            };
            // Chains: the r-vector's (taps tap0 and tap0 + 128, the
            // group's three margins) and the slot lane's mean-abs and |th|.
            const bool chains = !last && warp < kChainWarps && (g ? ga1 : ga0);
            const int tap0 = warp * 16 + (lane & 15);
            double acc[2][3] = {{0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}};
            double mab = 0.0, sth = 0.0;
            if (ntiles > 0) produce(0);
            __syncthreads();
            for (int t = 0; t < ntiles; ++t) {
                if (t + 1 < ntiles) produce(t + 1);
                const double* tb = tiles + (t & 1) * kTileDoubles;
                const int base = o + t * kT;
                const int len = min(kT, n - base);
                if (chains) {
#pragma unroll
                    for (int pass = 0; pass < 2; ++pass) {
                        const int tap = tap0 + kTapsAPass * pass;
                        if (tap < o) {
#pragma unroll 4
                            for (int j = 0; j < len; ++j) {
                                const double* ts = tb + j * kTS;
                                const double2 tp =
                                    *(const double2*)(ts + 2 * g);
                                const double t2 = ts[4 + g];
                                const double x = d[base + j - 1 - tap];
                                acc[pass][0] = acc[pass][0] + tp.x * x;
                                acc[pass][1] = acc[pass][1] + tp.y * x;
                                acc[pass][2] = acc[pass][2] + t2 * x;
                            }
                        }
                    }
                }
                if (mthread && s_alive[lane]) {
                    const double* ts = tb + tslot(lane);
                    if (last) {
#pragma unroll 4
                        for (int j = 0; j < len; ++j)
                            mab = mab + ts[j * kTS + 6];
                    } else {
#pragma unroll 4
                        for (int j = 0; j < len; ++j) {
                            mab = mab + ts[j * kTS + 6];
                            sth = sth + fabs(ts[j * kTS]);
                        }
                    }
                }
                __syncthreads();
            }
            if (chains) {
#pragma unroll
                for (int pass = 0; pass < 2; ++pass) {
                    const int tap = tap0 + kTapsAPass * pass;
                    if (tap < o) {
#pragma unroll
                        for (int k = 0; k < 3; ++k)
                            rv[(3 * g + k) * S + tap] = acc[pass][k];
                    }
                }
            }
            __syncthreads();
            if (mthread && s_alive[lane]) {
                double* cm = cur + lane * S;
                const double e = s_e[lane];
                const bool moved = e > 0.0;
                double l1 = 0.0;
                for (int i = 0; i < o; ++i) l1 = l1 + fabs(cm[i]);
                const double g_r = moved ? s_gres * (1.0 + l1) : 0.0;
                double mab_err = c.sqrt_n * (e + g_r);
                if (moved) mab_err = mab_err + c.g_sum * mab;
                const double eps = c.eps_libm
                    + (mab_err > 0.0 ? 2.0 * mab_err / (mab * kLn2) : 0.0);
                bool risky = false;
                const double obj = code_length(mab / (double)n, eps,
                                               c.log_optx, risky);
                double* h = hist + (((size_t)row * kSlots + lane) * c.max_iter
                                    + it) * 3;
                h[0] = obj;
                h[1] = eps;
                // The initial vector's own error is K7's quantization
                // margin's.
                h[2] = it == 0 ? 0.0 : e * s_sqcinv;
                ++s_nit[lane];
                // The slot's first least objective: the only iteration of
                // this margin that the replay can adopt last.
                if (obj < s_mmin[lane]) {
                    s_mmin[lane] = obj;
                    double* mb = mbest + lane * S;
                    for (int i = 0; i < o; ++i) mb[i] = cm[i];
                }
                if (!last) {
                    // prev < obj or |prev - obj| < 1e-8: stop.
                    const double prev = s_prev[lane];
                    const double dp = prev - obj;
                    const double adp = fabs(dp);
                    const double e2 = eps + s_epsp[lane];
                    const bool b_unc = fabs(adp - c.obj_eps) < e2;
                    const bool a_unc = dp != 0.0 && adp < e2;
                    const bool b_true = adp < c.obj_eps - e2;
                    risky |= b_unc || (a_unc && !b_true);
                    const bool stop = prev < obj || adp < c.obj_eps;
                    if (!stop) {
                        // The solve (dsp/pitch.py:cholesky_solve), in place.
                        double* x = rv + lane * S;
                        for (int i = 0; i < o; ++i) {
                            const double* Li = L + tri(i);
                            double s = x[i];
                            for (int j = i - 1; j >= 0; --j)
                                s = s - Li[j] * x[j];
                            x[i] = s * inv[i];
                        }
                        for (int i = o - 1; i >= 0; --i) {
                            double s = x[i];
                            for (int j = i + 1; j < o; ++j)
                                s = s - L[tri(j) + i] * x[j];
                            x[i] = s * inv[i];
                        }
                        double dn = 0.0;
                        for (int i = 0; i < o; ++i) dn = dn + x[i] * x[i];
                        for (int i = 0; i < o; ++i) cm[i] = cm[i] + x[i];
                        s_e[lane] = 2.0 * e + g_r
                            + (moved ? s_grvec * sth : 0.0)
                            + s_gsolve * sqrt(dn);
                    }
                    s_prev[lane] = obj;
                    s_epsp[lane] = eps;
                    s_alive[lane] = !stop;
                }
                if (risky) s_risky = 1;
            }
            __syncthreads();
        }
        // 4. The adopt decisions, replayed in (margin, iteration) order.
        if (warp == kScalarWarp && lane == 0) {
            double min_obj = s_minobj, eps_min = s_epsmin;
            bool risky = false;
            int src = -1;
            for (int m = 0; m < kb; ++m) {
                const double* h = hist + ((size_t)row * kSlots + m)
                    * c.max_iter * 3;
                for (int it = 0; it < s_nit[m]; ++it, h += 3) {
                    // obj < min_obj: adopt. An exact tie is not flagged.
                    const double gap = h[0] - min_obj;
                    risky |= gap != 0.0 && fabs(gap) < h[1] + eps_min;
                    if (h[0] < min_obj) {
                        min_obj = h[0];
                        eps_min = h[1];
                        s_cerr = h[2];
                        src = m;
                    }
                }
                s_iters += s_nit[m];
            }
            s_minobj = min_obj;
            s_epsmin = eps_min;
            if (risky) s_risky = 1;
            s_src = src;
        }
        __syncthreads();
        if (s_src >= 0)
            for (int i = tid; i < o; i += kThreads)
                best[i] = mbest[s_src * S + i];
        __syncthreads();
    }

    // 5. The adopted vector.
    for (int i = tid; i < M; i += kThreads)
        best_out[(size_t)row * M + i] = i < o ? best[i] : 0.0;
    if (tid == 0) {
        cerr_out[row] = s_cerr;
        risky_out[row] = s_risky ? 1 : 0;
        iters_out[row] = s_iters;
    }
}

// Doubles between two slot vectors: M rounded up to 16 bytes and padded so
// that slots 3 apart (a thread's group A and B) fall in different banks.
int slot_stride(int M) {
    int S = ((M + 1) & ~1) + 2;
    if ((3 * S / 2) % 8 == 0) S += 2;
    return S;
}

}  // namespace

// work (V, n) int32; cov (V, M, M) f64 (K11's); coefs (V, M) f64 the
// initial vectors, left-aligned; orders (V,) int32; kappa (V,) f64;
// margins (n_margins,) f64; a_scratch (V, M (M - 1) / 2) f64 the packed
// factors' place where shared memory does not hold them, or null; hist
// (V, 6, max_iter, 3) f64, each slot's objective, margin and error bound an
// iteration; row_i32: stage the row as int32 (svr.py's _layout decides
// both); best (V, M) f64, cerr (V,) f64, risky (V,) bool, iters (V,)
// int32. The constants are svr.py's (svr_refine passes them).
extern "C" int srla_svr_refine(const void* work, const void* cov,
                               const void* coefs, const void* orders,
                               const void* kappa, const void* margins,
                               void* a_scratch, void* hist, void* best,
                               void* cerr, void* risky, void* iters, int V,
                               int n, int M, int max_iter, int n_margins,
                               int row_i32, double scale, double lam_ratio,
                               double log_optx, double g_sum, double sqrt_n,
                               double eps_libm, double eps_pivot,
                               double init_rel, double obj_eps,
                               double flt_max, void* stream) {
    if (V <= 0) return 0;
    if (n < 2 || M < 1 || M > 255 || max_iter < 1 || n_margins < 1)
        return (int)cudaErrorInvalidValue;
    const int S = slot_stride(M);
    const size_t tri_m = (size_t)M * (M - 1) / 2;
    const size_t bytes = ((size_t)n * (row_i32 ? 4 : 8) + 15) / 16 * 16
        + sizeof(double) * (2 * (size_t)kTileDoubles
                            + (a_scratch ? 0 : (tri_m + 1) & ~(size_t)1)
                            + (5 + 3 * kSlots) * (size_t)S);
    if (bytes > kSmemBytes) return (int)cudaErrorInvalidValue;
    Consts c{n, M, max_iter, n_margins, S, scale, lam_ratio, log_optx,
             g_sum, sqrt_n, eps_libm, eps_pivot, init_rel, obj_eps, flt_max};
    auto run = [&](auto kernel) -> int {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                (int)cudaSharedmemCarveoutMaxShared);
        if (e != cudaSuccess) return (int)e;
        kernel<<<V, kThreads, bytes, (cudaStream_t)stream>>>(
            (const int32_t*)work, (const double*)cov, (const double*)coefs,
            (const int32_t*)orders, (const double*)kappa,
            (const double*)margins, (double*)a_scratch, (double*)hist,
            (double*)best, (double*)cerr, (uint8_t*)risky, (int32_t*)iters,
            c);
        return (int)cudaGetLastError();
    };
    return row_i32 ? run(svr_refine_kernel<int32_t>)
                   : run(svr_refine_kernel<double>);
}
