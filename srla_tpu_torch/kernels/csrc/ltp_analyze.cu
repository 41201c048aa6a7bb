// K10: the encode's pitch search, LTP solve and coefficient quantization.
//
// Replaces the XLA program srla_tpu/kernels/exact.py:_ltp_exact after its
// autocorrelation: the zero-crossing peak scan over lags 8..261 (:983-1036),
// the 0.1 * r0 threshold and the first candidate at 0.9 of the largest peak
// (:1039-1062), a ridge Cholesky of order 1 or 3 (:1064-1111) and the
// quantization round-half-away(c * 32) clipped to [-32, 31] (:1113-1125),
// each decision with its margin flag. Its plain version, the arithmetic it
// must equal bit for bit in period, coefficients and flag, is
// kernels/ltp.py:ltp_analyze_plain (pitch_scan_plain, then
// ltp_solve_plain); like it, the scan also looks at lag 262 where the
// host's detect loop does (a segment that starts at 261, or none open after
// the scan), and the rounding margin is widened by the solve's conditioning
// (ltp.py, above _LTP_EPS_REL).
//
// f64 throughout. This file is built with -fmad=false: a multiply followed
// by an add must round twice, as the plain version's separate torch ops do,
// or a margin flag could differ from it. sqrt and the divisions are the
// correctly rounded __dsqrt_rn and __ddiv_rn.
//
// What bounds it on an H100: latency. The bytes are the (V, 266) lags, 11
// MB at the main path's 5164 rows (0.003 ms), the f64 operations fewer
// still; the serial scan of the plain version is 255 dependent steps a
// row, and the solve a chain of three square roots and seven divisions.
//
// Design: a warp per row, four rows a CTA. The warp copies the row's 266
// lags into shared memory coalesced (9 loads a lane) and each lane takes 8
// consecutive lags of the scan, j = 8 + 8 lane .. (lane 31: 256..261), into
// registers. What the serial scan carries from lag to lag becomes three
// warp scans (five shuffle steps each), each lane first running its 8 lags
// from its incoming state:
//
//   1. the segment state. A lag maps "in a segment" to "in a segment after
//      it": out of one, an up-crossing (a[j-1] < 0 < a[j]) opens one; in
//      one, a down-crossing (a[j] > 0 > a[j+1], j < 261, not at the lag that
//      opened it) closes it. A chunk's map is a pair of bits, and the maps
//      compose (an exclusive scan of map composition);
//   2. each segment's running peak: the strict-greater maximum of a[j] over
//      its local peaks (a[j-1] < a[j] > a[j+1]) from 0 at its opening lag,
//      with its first index, so equal peaks keep the first, as the serial
//      test a0 > sp does (a segmented scan of (opened, peak, index));
//   3. the candidates' count: a segment that closes with a peak appends it.
//      The cap of 20 gates the opening of a segment, so segment k is live
//      iff fewer than 20 peaked segments closed before it (an exclusive
//      scan of each chunk's peaked closes); a live segment's candidate goes
//      to shared memory at its rank.
//
// A fourth pass over the lane's lags raises the flags of live lags (a peak
// test's neighbours and running peak within the margin, an open segment's
// lag or its next at 0), lane 31 runs the look at lag 262, lanes 0..19 hold
// one candidate each for the running maximum of the appended peaks (a max
// scan), the ratio test and the first qualifying candidate (a ballot), and
// then every lane runs the solve and the quantization, straight-line, in the
// plain version's operation order. tests/test_torch_ltp_model.py runs the
// same decomposition lane by lane in numpy against the plain version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMinPeriod = 8;
constexpr int kMaxPeriod = 262;
constexpr int kCols = kMaxPeriod + 4;
constexpr int kMaxCand = 20;
constexpr int kPer = 8;                                // scan lags a lane
constexpr int kWarps = 4;                              // rows a CTA
constexpr unsigned kFull = 0xffffffffu;
constexpr double kEpsRel = 1.0 / 68719476736.0;        // 2^-36
constexpr double kEpsQuant = 1e-6;
constexpr double kKappaScale = 1.0 / 1099511627776.0;  // 2^-40
constexpr double kThresh = 0.1;
constexpr double kRatio = 0.9;
constexpr double kFltMin = 1.1754943508222875e-38;
constexpr double kRidge = 1.0 + 1e-5;                  // 1 + LPC ridge

__device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
}
__device__ __forceinline__ double rsqrt_rn(double s) {
    return __ddiv_rn(1.0, __dsqrt_rn(s));
}

// The segment-state map of a run of lags as two bits: bit x is the state
// after the run from state x. first then second.
__device__ __forceinline__ int compose(int first, int second) {
    return ((second >> (first & 1)) & 1) | (((second >> (first >> 1)) & 1) << 1);
}

// A run's effect on the running peak: if it opens a segment, the peak from
// its last opening on; else its best local peak above 0 (its first index).
struct Peak {
    int opened;
    int idx;
    double sp;
};

// first then second.
__device__ __forceinline__ Peak combine(Peak first, Peak second) {
    if (second.opened) return second;
    return second.sp > first.sp ? Peak{first.opened, second.idx, second.sp}
                                : first;
}

__global__ void __launch_bounds__(kWarps * 32)
ltp_analyze_kernel(const double* __restrict__ ac,
                   int32_t* __restrict__ period_out,
                   int32_t* __restrict__ coefs_out,
                   uint8_t* __restrict__ risky_out, int V, int order) {
    __shared__ double lag_all[kWarps][kCols];
    __shared__ double csp_all[kWarps][kMaxCand];
    __shared__ int cidx_all[kWarps][kMaxCand];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long r = (long long)blockIdx.x * kWarps + warp;
    if (r >= V) return;                        // whole warps leave together
    double* lag = lag_all[warp];
    double* csp = csp_all[warp];
    int* cidx = cidx_all[warp];
    const double* a = ac + r * kCols;
    for (int k = lane; k < kCols; k += 32) lag[k] = a[k];
    __syncwarp();
    const double ac0 = lag[0];
    const double eps = mul(fabs(ac0), kEpsRel);
    auto near = [&](double x, double y) { return fabs(sub(x, y)) < eps; };

    const int j0 = kMinPeriod + kPer * lane;
    const int nl = kMaxPeriod - j0 < kPer ? kMaxPeriod - j0 : kPer;
    double x[kPer + 2];                        // a[j0 - 1 .. j0 + kPer]
#pragma unroll
    for (int t = 0; t < kPer + 2; ++t) x[t] = lag[j0 - 1 + t];

    // 1. Lag-local tests; the segment map of the lane's lags, scanned.
    bool rk = false;
    unsigned up = 0, down = 0;
    int map = 2;                               // identity
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
        if (t < nl) {
            const double am1 = x[t], a0 = x[t + 1], ap1 = x[t + 2];
            rk |= fabs(am1) < eps || fabs(a0) < eps;
            const bool u = am1 < 0.0 && a0 > 0.0;
            const bool d = a0 > 0.0 && ap1 < 0.0 && j0 + t < kMaxPeriod - 1;
            up |= (unsigned)u << t;
            down |= (unsigned)d << t;
            map = compose(map, (int)u | ((int)!d << 1));
        }
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int e = __shfl_up_sync(kFull, map, off);
        if (lane >= off) map = compose(e, map);
    }
    int s_in = __shfl_up_sync(kFull, map, 1) & 1;
    if (lane == 0) s_in = 0;

    // 2. The running peak of each segment, scanned.
    Peak agg{0, 0, 0.0};
    {
        bool s = s_in;
#pragma unroll
        for (int t = 0; t < kPer; ++t) {
            if (t < nl) {
                const bool enter = !s && ((up >> t) & 1);
                const bool in = s || enter;
                if (enter) agg = Peak{1, 0, 0.0};
                const double a0 = x[t + 1];
                if (in && a0 > x[t] && a0 > x[t + 2] && a0 > agg.sp)
                    agg = Peak{agg.opened, j0 + t, a0};
                const bool close = in && !enter && ((down >> t) & 1);
                s = in && !close;
            }
        }
    }
    Peak inc = agg;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const Peak e{__shfl_up_sync(kFull, inc.opened, off),
                     __shfl_up_sync(kFull, inc.idx, off),
                     __shfl_up_sync(kFull, inc.sp, off)};
        if (lane >= off) inc = combine(e, inc);
    }
    Peak before{__shfl_up_sync(kFull, inc.opened, 1),
                __shfl_up_sync(kFull, inc.idx, 1),
                __shfl_up_sync(kFull, inc.sp, 1)};
    if (lane == 0) before = Peak{0, 0, 0.0};

    // 3. Peaked closes, counted and scanned: the cap's count.
    int count = 0;
    {
        bool s = s_in;
        double sp = before.sp;
        int si = before.idx;
#pragma unroll
        for (int t = 0; t < kPer; ++t) {
            if (t < nl) {
                const bool enter = !s && ((up >> t) & 1);
                const bool in = s || enter;
                if (enter) {
                    sp = 0.0;
                    si = 0;
                }
                const double a0 = x[t + 1];
                if (in && a0 > x[t] && a0 > x[t + 2] && a0 > sp) {
                    sp = a0;
                    si = j0 + t;
                }
                const bool close = in && !enter && ((down >> t) & 1);
                count += close && si != 0;
                s = in && !close;
            }
        }
    }
    int total = count;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int e = __shfl_up_sync(kFull, total, off);
        if (lane >= off) total += e;
    }

    // 4. The live lags' flags; each live segment's candidate at its rank.
    bool s = s_in, last_enter = false, last_live = false;
    double sp = before.sp;
    int si = before.idx;
    int c = total - count;
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
        if (t < nl) {
            const double am1 = x[t], a0 = x[t + 1], ap1 = x[t + 2];
            const bool enter = !s && ((up >> t) & 1);
            const bool in = s || enter;
            const bool live = in && c < kMaxCand;
            if (enter) {
                sp = 0.0;
                si = 0;
            }
            const bool pk = in && a0 > am1 && a0 > ap1;
            if (live) {
                rk |= near(a0, am1) || near(a0, ap1);
                rk |= pk && near(a0, sp);
                rk |= !enter && (fabs(a0) < eps || fabs(ap1) < eps);
            }
            if (pk && a0 > sp) {
                sp = a0;
                si = j0 + t;
            }
            const bool close = in && !enter && ((down >> t) & 1);
            if (close && si != 0) {
                if (live) {
                    csp[c] = sp;
                    cidx[c] = si;
                }
                ++c;
            }
            s = in && !close;
            last_enter = enter;
            last_live = live;
        }
    }

    // Lag 262 (lane 31, whose last lag is 261): a segment that starts at
    // 261, or a fresh one (start = 262); then the trailing segment's peak.
    int ncand = c < kMaxCand ? c : kMaxCand;
    if (lane == 31) {
        const bool inseg = s && last_live;
        const bool tail = (inseg && last_enter && last_live)
            || (!inseg && ncand < kMaxCand);
        if (tail && !inseg) {
            sp = 0.0;
            si = 0;
        }
        if (tail) {
            const double am1 = lag[kMaxPeriod - 1], a0 = lag[kMaxPeriod];
            const double ap1 = lag[kMaxPeriod + 1];
            rk |= near(a0, am1) || near(a0, ap1);
            const bool pk = a0 > am1 && a0 > ap1;
            rk |= pk && near(a0, sp);
            if (pk && a0 > sp) {
                sp = a0;
                si = kMaxPeriod;
            }
        }
        if ((inseg || tail) && si != 0) {
            csp[ncand] = sp;
            cidx[ncand] = si;
            ++ncand;
        }
    }
    ncand = __shfl_sync(kFull, ncand, 31);
    __syncwarp();

    // Candidate k on lane k: the running maximum of the appended peaks
    // before it, then the threshold and the first candidate at 0.9 of the
    // largest. A candidate's lag value is its peak.
    const bool cand = lane < ncand;
    const double cv = cand ? csp[lane] : 0.0;
    const int cid = cand ? cidx[lane] : 0;
    double run = cv;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const double e = __shfl_up_sync(kFull, run, off);
        if (lane >= off && e > run) run = e;
    }
    double mp_before = __shfl_up_sync(kFull, run, 1);
    if (lane == 0) mp_before = 0.0;
    const double mp = __shfl_sync(kFull, run, 31);
    rk |= cand && near(cv, mp_before);
    const double thresh = mul(ac0, kThresh);
    const bool ok = ncand > 0 && !(mp < thresh);
    rk |= near(mp, thresh);
    const double ratio = mul(mp, kRatio);
    rk |= cand && fabs(sub(cv, ratio)) < eps;
    const unsigned qual = __ballot_sync(kFull, cand && !(cv < ratio));
    const int first = __shfl_sync(kFull, cid, qual ? __ffs(qual) - 1 : 0);
    int period = ok && qual ? first : 0;
    bool risky = __any_sync(kFull, rk);

    // The guards, then the ridge Cholesky in the host's operation order,
    // straight-line on every lane: a non-positive pivot gives NaN or inf
    // downstream exactly as the plain version's torch ops do, and zeroes
    // the period.
    risky |= fabs(sub(fabs(ac0), kFltMin)) < 1e-38;
    if (fabs(ac0) <= kFltMin) period = 0;
    if (period < order / 2 + 1) period = 0;
    const double a0r = mul(ac0, kRidge);
    const double eps_pos = mul(fabs(a0r), kEpsRel);
    auto rhs = [&](int i) {
        int idx = period - order / 2 + i;
        idx = idx < 0 ? 0 : (idx > kCols - 1 ? kCols - 1 : idx);
        return lag[idx];
    };
    bool singular = a0r <= 0.0;
    risky |= fabs(a0r) < eps_pos;
    const double d0 = rsqrt_rn(a0r);
    double xs[3] = {0.0, 0.0, 0.0};
    double tr;
    if (order == 1) {
        xs[0] = mul(mul(rhs(0), d0), d0);
        tr = mul(d0, d0);
    } else {
        const double r1 = lag[1], r2 = lag[2];
        const double l10 = mul(r1, d0);
        const double l20 = mul(r2, d0);
        const double s1 = sub(a0r, mul(l10, l10));
        singular |= s1 <= 0.0;
        risky |= fabs(s1) < eps_pos;
        const double d1 = rsqrt_rn(s1);
        const double l21 = mul(sub(r1, mul(l10, l20)), d1);
        const double s2 = sub(sub(a0r, mul(l21, l21)), mul(l20, l20));
        singular |= s2 <= 0.0;
        risky |= fabs(s2) < eps_pos;
        const double d2 = rsqrt_rn(s2);
        const double y0 = mul(rhs(0), d0);
        const double y1 = mul(sub(rhs(1), mul(l10, y0)), d1);
        const double y2 = mul(sub(sub(rhs(2), mul(l21, y1)), mul(l20, y0)),
                              d2);
        xs[2] = mul(y2, d2);
        xs[1] = mul(sub(y1, mul(l21, xs[2])), d1);
        xs[0] = mul(sub(sub(y0, mul(l10, xs[1])), mul(l20, xs[2])), d0);
        const double m10 = mul(mul(l10, d0), d1);
        const double m20 = mul(sub(mul(mul(l10, l21), d1), l20), mul(d0, d2));
        const double m21 = mul(mul(l21, d1), d2);
        tr = add(add(add(add(add(mul(d0, d0), mul(m10, m10)), mul(d1, d1)),
                         mul(m20, m20)), mul(m21, m21)), mul(d2, d2));
    }
    if (singular) period = 0;
    double sx = fabs(xs[0]);
    for (int i = 1; i < order; ++i) sx = add(sx, fabs(xs[i]));
    double eps_q = mul(mul(mul(mul(32.0, tr), fabs(ac0)),
                           add(2.0, mul(3.0, sx))), kKappaScale);
    // torch.clamp(min=) keeps a NaN; only rows with period 0 can have one.
    if (eps_q < kEpsQuant) eps_q = kEpsQuant;

    const bool on = period > 0;
    int32_t q[3] = {0, 0, 0};
    for (int i = 0; i < order; ++i) {
        const double scaled = mul(xs[i], 32.0);
        const double ax = fabs(scaled);
        risky |= on && fabs(sub(sub(ax, floor(ax)), 0.5)) < eps_q;
        if (on) {
            double rq = floor(add(ax, 0.5));
            if (scaled < 0.0) rq = -rq;
            rq = rq < -32.0 ? -32.0 : (rq > 31.0 ? 31.0 : rq);
            q[i] = (int32_t)rq;
        }
    }
    if (lane < order)                          // emission order, reversed
        coefs_out[r * order + order - 1 - lane] =
            lane == 0 ? q[0] : (lane == 1 ? q[1] : q[2]);
    if (lane == 0) {
        period_out[r] = period;
        risky_out[r] = risky ? 1 : 0;
    }
}

}  // namespace

// ac: (V, 266) f64 pitch lags (0..262, then zeros); period, risky: (V,)
// int32 and bool (one byte); coefs: (V, order) int32; order 1 or 3.
extern "C" int srla_ltp_analyze(const void* ac, void* period, void* coefs,
                                void* risky, int V, int order, void* stream) {
    if (order != 1 && order != 3) return (int)cudaErrorInvalidValue;
    const int blocks = (V + kWarps - 1) / kWarps;
    ltp_analyze_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
        (const double*)ac, (int32_t*)period, (int32_t*)coefs,
        (uint8_t*)risky, V, order);
    return (int)cudaGetLastError();
}
