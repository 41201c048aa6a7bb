// K12's first design, kept as a measurement aid for
// chip_smoke.py, which times it beside the current svr_refine.cu. Nothing in
// the port calls it; its entry is srla_svr_refine_v1. The text below is the
// first design's own.
//
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
//      the residual (taps in order), the mean-abs chain and the r-vector
//      chains over s in order, the estimate and its k2 flag, the forward and
//      backward solves in the host's order, the adopt and stop decisions
//      with their flags, the step and the error bound's update;
//   4. the adopted vector (zero on singular rows), its error bound, the
//      flag and the iterations run (for the bound of chip_smoke.py).
//
// f64 throughout, every operation as the plain version writes it; the
// build passes -fmad=false (kernels/build.py), so no multiply-add is
// contracted, and log, pow and sqrt are libdevice's, as torch's on the
// card. There is no iterative-refinement step: the host has none.
//
// What bounds it on an H100: the residual and the r-vector, 2 n o
// multiply-adds a row and iteration (unfused: 4 n o f64 instructions),
// ~32 G at the main path's group at 2 iterations (12 iterations: 6 margins
// x 2), >= ~3.8 ms on the ~17 T/s vector pipe. Its serial floor is an
// iteration's chains, n dependent adds (the mean-abs sum and each r-vector
// entry are one chain each), and the solve's ~o^2 dependent steps.
//
// Design: a CTA per row. The row is staged once in shared memory as int32
// (the samples times 2^-(bps - 1) are exact, so it is scaled on read), the
// residual as f64 beside it and the factor beside them where they fit (the
// main path's rows of 4096 at M 64: 85 KB, 2 CTAs an SM); where they do
// not, the factor (520 KB a row at M 255), then the residual, go to the
// row's slice of a global scratch. The residual is parallel over samples;
// then the o r-vector chains run on threads 0 .. o - 1 while two threads
// of the last warp run the mean-abs chain and the |th| sum; thread 0 then
// solves, decides and steps.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 288;            // 9 warps: o <= 255 chains + 2
constexpr int kMabseThread = 256;
constexpr int kThThread = 257;
// Dynamic shared memory a CTA may take: an H100's 227 KB less a KB for
// the static variables (svr.py's _SMEM_BYTES).
constexpr size_t kSmemBytes = 227 * 1024 - 1024;
constexpr double kU = 1.1102230246251565e-16;     // 2^-53
constexpr double kLn2 = 0.6931471805599453;       // math.log(2.0)
constexpr double kInvLoge2 = 1.4426950408889634;  // svr.py INV_LOGE2

__device__ __forceinline__ double gamma_of(double m) {
    return m * kU / (1.0 - m * kU);
}

struct Consts {
    int n, M, max_iter, n_margins;
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

__global__ void __launch_bounds__(kThreads)
svr_refine_kernel(const int32_t* __restrict__ work,
                  const double* __restrict__ cov,
                  const double* __restrict__ coefs,
                  const int32_t* __restrict__ orders,
                  const double* __restrict__ kappa,
                  const double* __restrict__ margins,
                  double* __restrict__ a_scratch,
                  double* __restrict__ r_scratch,
                  double* __restrict__ best_out,
                  double* __restrict__ cerr_out,
                  uint8_t* __restrict__ risky_out,
                  int32_t* __restrict__ iters_out, Consts c) {
    extern __shared__ double smem[];
    const int n = c.n, M = c.M;
    const int tid = threadIdx.x;
    const int row = blockIdx.x;
    // [the residual (n)] [6 vectors of M] [the factor (M * M)] [the row as
    // int32 (n)], the bracketed parts in global scratch where they do not
    // fit.
    double* R = r_scratch ? r_scratch + (size_t)row * n : smem;
    double* cur = r_scratch ? smem : smem + n;
    double* init = cur + M;
    double* best = init + M;
    double* rvec = best + M;
    double* delta = rvec + M;
    double* inv = delta + M;
    double* A = a_scratch ? a_scratch + (size_t)row * M * M : inv + M;
    int32_t* w = (int32_t*)(a_scratch ? inv + M : inv + M + M * M);
    __shared__ int s_flag;                     // singular / alive
    __shared__ double s_margin, s_mabse, s_sum_th, s_maxd, s_cinv;

    const double* C = cov + (size_t)row * M * M;
    const int32_t* src = work + (size_t)row * n;
    int o = orders[row];
    o = o < 0 ? 0 : (o > M ? M : o);
    for (int s = tid; s < n; s += kThreads) w[s] = src[s];
    for (int i = tid; i < M; i += kThreads) {
        init[i] = i < o ? coefs[(size_t)row * M + i] : 0.0;
        best[i] = init[i];
        inv[i] = 0.0;
    }
    for (int k = tid; k < M * M; k += kThreads) A[k] = C[k];
    if (tid == 0) s_flag = 0;
    __syncthreads();

    // 1. Cholesky (dsp/pitch.py:cholesky_decompose, svr.py:cholesky_plain).
    bool risky = false;                        // thread 0's
    for (int i = 0; i < o; ++i) {
        if (tid == 0) {
            double s = A[i * M + i];
            for (int k = i - 1; k >= 0; --k)
                s = s - A[i * M + k] * A[i * M + k];
            risky |= fabs(s) < C[i * M + i] * c.eps_pivot;
            if (s <= 0.0) s_flag = 1;
            else inv[i] = 1.0 / sqrt(s);
        }
        __syncthreads();
        if (s_flag) break;
        for (int j = i + 1 + tid; j < o; j += kThreads) {
            double s = A[i * M + j];
            for (int k = i - 1; k >= 0; --k)
                s = s - A[i * M + k] * A[j * M + k];
            A[j * M + i] = s * inv[i];
        }
        __syncthreads();
    }
    const bool live = o > 0 && !s_flag;
    if (!live) {
        for (int i = tid; i < M; i += kThreads)
            best_out[(size_t)row * M + i] = 0.0;
        if (tid == 0) {
            cerr_out[row] = 0.0;
            risky_out[row] = risky ? 1 : 0;
            iters_out[row] = 0;
        }
        return;
    }

    // 2. The bounds' constants (svr.py, the margins' comment).
    if (tid == 0) {
        s_maxd = 0.0;
        s_cinv = 0.0;
    }
    __syncthreads();
    if (tid < o) {
        // max_j (C^-1)_jj: column j = tid of L^-1 by forward substitution,
        // its squares summed in order (svr.py:inverse_diag_max_plain).
        double y[256];
        double dsum = 0.0;
        for (int k = tid; k < o; ++k) {
            double s = k == tid ? 1.0 : 0.0;
            for (int m = tid; m < k; ++m) s = s - A[k * M + m] * y[m];
            y[k] = s * inv[k];
            dsum = dsum + y[k] * y[k];
        }
        // Non-negative doubles order as their bit patterns do.
        atomicMax((unsigned long long*)&s_cinv,
                  (unsigned long long)__double_as_longlong(dsum));
    }
    {
        double m = 0.0;
        for (int s = tid; s < n; s += kThreads)
            m = fmax(m, fabs((double)w[s] * c.scale));
        for (int off = 16; off > 0; off >>= 1)
            m = fmax(m, __shfl_xor_sync(0xffffffffu, m, off));
        if ((tid & 31) == 0) {
            // fmax of non-negative doubles: their bit patterns order alike.
            atomicMax((unsigned long long*)&s_maxd,
                      (unsigned long long)__double_as_longlong(m));
        }
    }
    __syncthreads();
    const double maxd = s_maxd;
    double tr = 0.0, lam = 1.0, e0 = 0.0;     // thread 0's
    if (tid == 0) {
        double mn = CUDART_INF;
        for (int i = 0; i < o; ++i) {
            tr = tr + C[i * M + i];
            mn = fmin(mn, C[i * M + i]);
        }
        lam = mn * c.lam_ratio;
        // e0 = rho max|c| sqrt(1^T |C| 1), each row sum in j order, the
        // rows in i order.
        double total = 0.0, cmax = 0.0;
        for (int i = 0; i < o; ++i) {
            double inner = 0.0;
            for (int j = 0; j < o; ++j) inner = inner + fabs(C[i * M + j]);
            total = total + inner;
            cmax = fmax(cmax, fabs(init[i]));
        }
        e0 = ((c.init_rel * kappa[row]) * cmax) * sqrt(total);
    }
    const double of = (double)o;
    const double sq_lam = sqrt(lam);
    const double sq_cinv = sqrt(s_cinv);
    const double g_res = gamma_of(of + 1.0) * maxd * c.sqrt_n;
    const double g_rvec = c.g_sum * sqrt(of) * maxd / sq_lam;
    const double g_solve = 2.0 * gamma_of(3.0 * of + 3.0) * tr / sq_lam;

    // 3. The margin x iteration loop; thread 0 keeps the row's state.
    double min_obj = c.flt_max, eps_min = 0.0, cerr = 0.0;
    int iters = 0;
    for (int mi = 0; mi < c.n_margins; ++mi) {
        double e = e0, prev = c.flt_max, eps_prev = 0.0;
        __syncthreads();                       // s_flag read by all
        for (int i = tid; i < M; i += kThreads) cur[i] = init[i];
        if (tid == 0) {
            s_flag = 1;                        // alive
            s_margin = margins[mi];
        }
        __syncthreads();
        for (int it = 0; it < c.max_iter; ++it) {
            if (!s_flag) break;
            // The residual, taps in order (parallel over samples).
            for (int s = tid; s < n; s += kThreads) {
                double r = (double)w[s] * c.scale;
                if (s >= o)
                    for (int i = 0; i < o; ++i)
                        r = r + cur[i] * ((double)w[s - i - 1] * c.scale);
                R[s] = r;
            }
            __syncthreads();
            const double margin = s_margin;
            if (tid < o) {                     // rvec[i], s in order
                double acc = 0.0;
                for (int s = o; s < n; ++s) {
                    const double r = R[s];
                    const double v = fmax(fabs(r) - margin, 0.0);
                    const double th = r > 0.0 ? v : (r < 0.0 ? -v : 0.0);
                    acc = acc + th * ((double)w[s - 1 - tid] * c.scale);
                }
                rvec[tid] = acc;
            } else if (tid == kMabseThread) {  // the mean-abs chain
                double acc = 0.0;
                for (int s = o; s < n; ++s) acc = acc + fabs(R[s]);
                s_mabse = acc;
            } else if (tid == kThThread) {     // sum |th|, for the bounds
                double acc = 0.0;
                for (int s = o; s < n; ++s)
                    acc = acc + fmax(fabs(R[s]) - margin, 0.0);
                s_sum_th = acc;
            }
            __syncthreads();
            if (tid == 0) {
                const double mabse = s_mabse, sum_th = s_sum_th;
                const bool moved = e > 0.0;
                double l1 = 0.0;
                for (int i = 0; i < o; ++i) l1 = l1 + fabs(cur[i]);
                const double g_r = moved ? g_res * (1.0 + l1) : 0.0;
                double mab_err = c.sqrt_n * (e + g_r);
                if (moved) mab_err = mab_err + c.g_sum * mabse;
                const double eps = c.eps_libm
                    + (mab_err > 0.0 ? 2.0 * mab_err / (mabse * kLn2) : 0.0);
                const double obj = code_length(mabse / (double)n, eps,
                                               c.log_optx, risky);
                ++iters;
                // The solve (dsp/pitch.py:cholesky_solve).
                for (int i = 0; i < o; ++i) {
                    double s = rvec[i];
                    for (int j = i - 1; j >= 0; --j)
                        s = s - A[i * M + j] * delta[j];
                    delta[i] = s * inv[i];
                }
                for (int i = o - 1; i >= 0; --i) {
                    double s = delta[i];
                    for (int j = i + 1; j < o; ++j)
                        s = s - A[j * M + i] * delta[j];
                    delta[i] = s * inv[i];
                }
                // obj < min_obj: adopt.
                const double gap = obj - min_obj;
                risky |= gap != 0.0 && fabs(gap) < eps + eps_min;
                if (obj < min_obj) {
                    for (int i = 0; i < o; ++i) best[i] = cur[i];
                    min_obj = obj;
                    eps_min = eps;
                    cerr = it == 0 ? 0.0 : e * sq_cinv;
                }
                // prev < obj or |prev - obj| < 1e-8: stop.
                const double dp = prev - obj;
                const double adp = fabs(dp);
                const double e2 = eps + eps_prev;
                const bool b_unc = fabs(adp - c.obj_eps) < e2;
                const bool a_unc = dp != 0.0 && adp < e2;
                const bool b_true = adp < c.obj_eps - e2;
                if (it + 1 < c.max_iter)
                    risky |= b_unc || (a_unc && !b_true);
                const bool stop = prev < obj || adp < c.obj_eps;
                double dn = 0.0;
                for (int i = 0; i < o; ++i) dn = dn + delta[i] * delta[i];
                if (!stop) {
                    for (int i = 0; i < o; ++i) cur[i] = cur[i] + delta[i];
                    e = 2.0 * e + g_r + (moved ? g_rvec * sum_th : 0.0)
                        + g_solve * sqrt(dn);
                }
                prev = obj;
                eps_prev = eps;
                s_flag = stop ? 0 : 1;
            }
            __syncthreads();
        }
    }

    // 4. The adopted vector.
    for (int i = tid; i < M; i += kThreads)
        best_out[(size_t)row * M + i] = i < o ? best[i] : 0.0;
    if (tid == 0) {
        cerr_out[row] = cerr;
        risky_out[row] = risky ? 1 : 0;
        iters_out[row] = iters;
    }
}

}  // namespace

// work (V, n) int32; cov (V, M, M) f64 (K11's); coefs (V, M) f64 the
// initial vectors, left-aligned; orders (V,) int32; kappa (V,) f64;
// margins (n_margins,) f64; a_scratch (V, M, M) and r_scratch (V, n) f64
// or null, the factor's and the residual's places where shared memory
// does not hold them (svr.py's _layout decides); best (V, M) f64, cerr
// (V,) f64, risky (V,) bool, iters (V,) int32. The constants are
// svr.py's (svr_refine passes them).
extern "C" int srla_svr_refine_v1(const void* work, const void* cov,
                               const void* coefs, const void* orders,
                               const void* kappa, const void* margins,
                               void* a_scratch, void* r_scratch, void* best,
                               void* cerr, void* risky, void* iters, int V,
                               int n, int M,
                               int max_iter, int n_margins, double scale,
                               double lam_ratio, double log_optx,
                               double g_sum, double sqrt_n, double eps_libm,
                               double eps_pivot, double init_rel,
                               double obj_eps, double flt_max,
                               void* stream) {
    if (V <= 0) return 0;
    if (n < 2 || M < 1 || M > 255 || max_iter < 1 || n_margins < 1)
        return (int)cudaErrorInvalidValue;
    const size_t bytes = sizeof(double)
        * ((r_scratch ? 0 : (size_t)n) + 6 * (size_t)M
           + (a_scratch ? 0 : (size_t)M * M))
        + sizeof(int32_t) * (size_t)n;
    if (bytes > kSmemBytes) return (int)cudaErrorInvalidValue;
    if (bytes > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            svr_refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)bytes);
        if (e != cudaSuccess) return (int)e;
    }
    Consts c{n, M, max_iter, n_margins, scale, lam_ratio, log_optx, g_sum,
             sqrt_n, eps_libm, eps_pivot, init_rel, obj_eps, flt_max};
    svr_refine_kernel<<<V, kThreads, bytes, (cudaStream_t)stream>>>(
        (const int32_t*)work, (const double*)cov, (const double*)coefs,
        (const int32_t*)orders, (const double*)kappa, (const double*)margins,
        (double*)a_scratch, (double*)r_scratch, (double*)best,
        (double*)cerr, (uint8_t*)risky, (int32_t*)iters, c);
    return (int)cudaGetLastError();
}
