// K10's first design, kept as a measurement aid for
// chip_smoke.py, which times it beside the current ltp_analyze.cu. Nothing in
// the port calls it; its entry is srla_ltp_analyze_v1. The text below is the
// first design's own.
//
// K10: the encode's pitch search, LTP solve and coefficient quantization.
//
// Replaces the XLA program srla_tpu/kernels/exact.py:_ltp_exact after its
// autocorrelation: the zero-crossing peak scan over lags 8..261 (:983-1036),
// the 0.1 * r0 threshold and the first candidate at 0.9 of the largest peak
// (:1039-1062), a ridge Cholesky of order 1 or 3 (:1064-1111) and the
// quantization round-half-away(c * 32) clipped to [-32, 31] (:1113-1125),
// each decision with its margin flag. Its plain version, the arithmetic it
// must equal bit for bit, is kernels/ltp.py:ltp_analyze_plain; like it, the
// scan also looks at lag 262 where the host's detect loop does (a segment
// that starts at 261, or none open after the scan), and the rounding margin
// is widened by the solve's conditioning (ltp.py, above _LTP_EPS_REL).
//
// f64 throughout. This file is built with -fmad=false: a multiply followed
// by an add must round twice, as the plain version's separate torch ops do,
// or a margin flag could differ from it. sqrt and the divisions are the
// correctly rounded __dsqrt_rn and __ddiv_rn.
//
// What bounds it on an H100: per row a serial scan of 255 steps over the
// lags (a few compares and selects each) and about 60 f64 operations of
// solve and quantization; the bytes are the (V, 266) lags, 11 MB at the
// main path's 5164 rows. Design: one thread per row, one warp per CTA so
// the 5164 rows spread over all SMs; the scan keeps its three-lag window,
// running peaks and the 20 candidates in registers and local memory, and
// reads each lag once. Every read stays inside the row's 266 columns: the
// right-hand side's index is clamped as _ltp_exact clamps it (:1070).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMinPeriod = 8;
constexpr int kMaxPeriod = 262;
constexpr int kCols = kMaxPeriod + 4;
constexpr int kMaxCand = 20;
constexpr double kEpsRel = 1.0 / 68719476736.0;        // 2^-36
constexpr double kEpsQuant = 1e-6;
constexpr double kKappaScale = 1.0 / 1099511627776.0;  // 2^-40
constexpr double kThresh = 0.1;
constexpr double kRatio = 0.9;
constexpr double kFltMin = 1.1754943508222875e-38;
constexpr double kRidge = 1.0 + 1e-5;                  // 1 + LPC ridge
constexpr int kThreads = 32;

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

struct Scan {
    double eps, sp, mp;
    int sidx, ncand;
    bool risky;
    int cands[kMaxCand];

    __device__ bool near(double a, double b) const {
        return fabs(sub(a, b)) < eps;
    }
    // The peak test at lag j of a live segment (_ltp_exact:996-1003).
    __device__ void peak(bool live, int j, double am1, double a0,
                         double ap1) {
        const bool pk = live && a0 > am1 && a0 > ap1;
        risky |= live && (near(a0, am1) || near(a0, ap1));
        risky |= pk && near(a0, sp);
        if (pk && a0 > sp) {
            sp = a0;
            sidx = j;
        }
    }
    // A finished segment's peak joins the candidates (:1008-1016).
    __device__ void append(bool fin) {
        if (!fin) return;
        for (int k = 0; k < kMaxCand; ++k)
            if (k == ncand) cands[k] = sidx;
        risky |= near(sp, mp);
        if (sp > mp) mp = sp;
        ++ncand;
    }
};

__global__ void __launch_bounds__(kThreads)
ltp_analyze_kernel(const double* __restrict__ ac, int32_t* __restrict__ period_out,
                   int32_t* __restrict__ coefs_out,
                   uint8_t* __restrict__ risky_out, int V, int order) {
    const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (r >= V) return;
    const double* a = ac + r * kCols;
    const double ac0 = a[0];
    Scan st;
    st.eps = mul(fabs(ac0), kEpsRel);
    st.sp = st.mp = 0.0;
    st.sidx = st.ncand = 0;
    st.risky = false;
    for (int k = 0; k < kMaxCand; ++k) st.cands[k] = 0;
    bool inseg = false, enter = false;
    double am1 = a[kMinPeriod - 1], a0 = a[kMinPeriod];
    for (int j = kMinPeriod; j < kMaxPeriod; ++j) {
        const double ap1 = a[j + 1];
        st.risky |= fabs(am1) < st.eps || fabs(a0) < st.eps;
        enter = !inseg && st.ncand < kMaxCand && am1 < 0.0 && a0 > 0.0;
        if (enter) {
            st.sp = 0.0;
            st.sidx = 0;
            inseg = true;
        }
        st.peak(inseg, j, am1, a0, ap1);
        const bool open = inseg && !enter;
        const bool close = open && j < kMaxPeriod - 1 && a0 > 0.0 &&
                           ap1 < 0.0;
        st.risky |= open && (fabs(a0) < st.eps || fabs(ap1) < st.eps);
        st.append(close && st.sidx != 0);
        inseg = inseg && !close;
        am1 = a0;
        a0 = ap1;
    }
    // Lag 262: a segment that starts at 261, or a fresh one (start = 262).
    const bool tail = (inseg && enter) || (!inseg && st.ncand < kMaxCand);
    if (tail && !inseg) {
        st.sp = 0.0;
        st.sidx = 0;
    }
    st.peak(tail, kMaxPeriod, am1, a0, a[kMaxPeriod + 1]);
    st.append((inseg || tail) && st.sidx != 0);

    // Threshold, then the first candidate at 0.9 of the largest peak.
    const double thresh = mul(ac0, kThresh);
    const bool ok = st.ncand > 0 && !(st.mp < thresh);
    bool risky = st.risky || st.near(st.mp, thresh);
    const double ratio = mul(st.mp, kRatio);
    int period = 0;
    bool found = false;
    for (int k = 0; k < kMaxCand; ++k) {
        if (k >= st.ncand) break;
        const double cv = a[st.cands[k]];
        risky |= fabs(sub(cv, ratio)) < st.eps;
        if (!found && !(cv < ratio)) {
            found = true;
            period = st.cands[k];
        }
    }
    if (!(ok && found)) period = 0;
    risky |= fabs(sub(fabs(ac0), kFltMin)) < 1e-38;
    if (fabs(ac0) <= kFltMin) period = 0;
    if (period < order / 2 + 1) period = 0;

    // Ridge Cholesky in the host's operation order, straight-line: a
    // non-positive pivot gives NaN or inf downstream exactly as the plain
    // version's torch ops do, and zeroes the period.
    const double a0r = mul(ac0, kRidge);
    const double eps_pos = mul(fabs(a0r), kEpsRel);
    auto rhs = [&](int i) {
        int idx = period - order / 2 + i;
        idx = idx < 0 ? 0 : (idx > kCols - 1 ? kCols - 1 : idx);
        return a[idx];
    };
    bool singular = a0r <= 0.0;
    risky |= fabs(a0r) < eps_pos;
    const double d0 = rsqrt_rn(a0r);
    double x[3] = {0.0, 0.0, 0.0};
    double tr;
    if (order == 1) {
        x[0] = mul(mul(rhs(0), d0), d0);
        tr = mul(d0, d0);
    } else {
        const double r1 = a[1], r2 = a[2];
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
        x[2] = mul(y2, d2);
        x[1] = mul(sub(y1, mul(l21, x[2])), d1);
        x[0] = mul(sub(sub(y0, mul(l10, x[1])), mul(l20, x[2])), d0);
        const double m10 = mul(mul(l10, d0), d1);
        const double m20 = mul(sub(mul(mul(l10, l21), d1), l20), mul(d0, d2));
        const double m21 = mul(mul(l21, d1), d2);
        tr = add(add(add(add(add(mul(d0, d0), mul(m10, m10)), mul(d1, d1)),
                         mul(m20, m20)), mul(m21, m21)), mul(d2, d2));
    }
    if (singular) period = 0;
    double sx = fabs(x[0]);
    for (int i = 1; i < order; ++i) sx = add(sx, fabs(x[i]));
    double eps_q = mul(mul(mul(mul(32.0, tr), fabs(ac0)),
                           add(2.0, mul(3.0, sx))), kKappaScale);
    // torch.clamp(min=) keeps a NaN; only rows with period 0 can have one.
    if (eps_q < kEpsQuant) eps_q = kEpsQuant;

    const bool on = period > 0;
    int32_t* co = coefs_out + r * order;
    for (int i = 0; i < order; ++i) {
        const double scaled = mul(x[i], 32.0);
        const double ax = fabs(scaled);
        risky |= on && fabs(sub(sub(ax, floor(ax)), 0.5)) < eps_q;
        int32_t q = 0;
        if (on) {
            double rq = floor(add(ax, 0.5));
            if (scaled < 0.0) rq = -rq;
            rq = rq < -32.0 ? -32.0 : (rq > 31.0 ? 31.0 : rq);
            q = (int32_t)rq;
        }
        co[order - 1 - i] = q;                 // emission order, reversed
    }
    period_out[r] = period;
    risky_out[r] = risky ? 1 : 0;
}

}  // namespace

// ac: (V, 266) f64 pitch lags (0..262, then zeros); period, risky: (V,)
// int32 and bool (one byte); coefs: (V, order) int32; order 1 or 3.
extern "C" int srla_ltp_analyze_v1(const void* ac, void* period, void* coefs,
                                void* risky, int V, int order, void* stream) {
    if (order != 1 && order != 3) return (int)cudaErrorInvalidValue;
    const int blocks = (V + kThreads - 1) / kThreads;
    ltp_analyze_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const double*)ac, (int32_t*)period, (int32_t*)coefs,
        (uint8_t*)risky, V, order);
    return (int)cudaGetLastError();
}
