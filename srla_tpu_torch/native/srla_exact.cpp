// Native exact-path analysis kernels: batched f64 Stockham FFT
// autocorrelation and the Rice partition search.
//
// Exactness contract: identical IEEE-754 double rounding to the Python host
// path (and the reference codec). Twiddle/rotor tables are computed by the
// CALLER (Python `math`, platform libm) and passed in; all arithmetic here is
// plain +,-,*,/ with no FMA contraction (build with -ffp-contract=off) and
// matching op order. The plain-Rice parameter uses libm log directly — the
// same call chain as the reference.

#include <cmath>
#include <cstdint>
#include <cstring>

// SIMD only for INTEGER kernels (exact regardless of lanes). The f64 FFT
// code in this file must compile WITHOUT -mfma/-mavx2: g++ does not honor
// -ffp-contract=off reliably in C++ when FMA is enabled globally, and a
// contracted butterfly breaks bit-parity with the reference (visible under
// the catastrophic cancellation of impulse autocorrelations). Integer AVX2
// paths use per-function target attributes + runtime dispatch instead.
#if defined(__x86_64__) && defined(__GNUC__)
#define SRLA_X86_SIMD 1
#include <immintrin.h>
#endif

namespace {

struct Cplx { double re, im; };

inline Cplx cmul(Cplx a, Cplx b) {
    // PLAIN complex multiply — every product rounds separately (parity:
    // FFTComplex_Mul, libs/fft/src/fft.c:56-63, built without contraction).
    // Do NOT use numpy's fused (fmaddsub) form: it agrees after quantization
    // on normal signals but diverges under the catastrophic cancellation of
    // impulse-dominated autocorrelations (stale-buffer pitch detection).
    return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

// Radix-4 Stockham complex FFT over interleaved re/im pairs, using
// caller-provided per-stage twiddles (w1,w2,w3 concatenated per stage).
void complex_fft(int n, int flag, Cplx *x, Cplx *y, const double *tw) {
    int s = 1;
    Cplx *src = x;
    const double ji = -(double)flag;
    while (n > 2) {
        const int n1 = n >> 2;
        const int n2 = n >> 1;
        const int n3 = n1 + n2;
        for (int p = 0; p < n1; p++) {
            const Cplx w1 = {tw[6 * p + 0], tw[6 * p + 1]};
            const Cplx w2 = {tw[6 * p + 2], tw[6 * p + 3]};
            const Cplx w3 = {tw[6 * p + 4], tw[6 * p + 5]};
            for (int q = 0; q < s; q++) {
                const Cplx a = x[q + s * (p + 0)];
                const Cplx b = x[q + s * (p + n1)];
                const Cplx c = x[q + s * (p + n2)];
                const Cplx d = x[q + s * (p + n3)];
                const Cplx apc = {a.re + c.re, a.im + c.im};
                const Cplx amc = {a.re - c.re, a.im - c.im};
                const Cplx bpd = {b.re + d.re, b.im + d.im};
                const Cplx bmd = {b.re - d.re, b.im - d.im};
                const Cplx jbmd = {0.0 * bmd.re - ji * bmd.im,
                                   0.0 * bmd.im + ji * bmd.re};
                y[q + s * ((p << 2) + 0)] = {apc.re + bpd.re, apc.im + bpd.im};
                y[q + s * ((p << 2) + 1)] =
                    cmul(w1, {amc.re - jbmd.re, amc.im - jbmd.im});
                y[q + s * ((p << 2) + 2)] =
                    cmul(w2, {apc.re - bpd.re, apc.im - bpd.im});
                y[q + s * ((p << 2) + 3)] =
                    cmul(w3, {amc.re + jbmd.re, amc.im + jbmd.im});
            }
        }
        tw += 6 * n1;
        n >>= 2;
        s <<= 2;
        Cplx *t = x; x = y; y = t;
    }
    if (n == 2) {
        for (int q = 0; q < s; q++) {
            const Cplx a = x[q];
            const Cplx b = x[q + s];
            y[q] = {a.re + b.re, a.im + b.im};
            y[q + s] = {a.re - b.re, a.im - b.im};
        }
        s <<= 1;
        Cplx *t = x; x = y; y = t;
    }
    if (src != x) memcpy(y, x, sizeof(Cplx) * (size_t)s);
}

// Real FFT (packed format), caller-provided rotors (wr,wi pairs) and stage
// twiddles for the half-size complex FFT.
void real_fft(int n, int flag, double *x, double *work, const double *tw,
              const double *rotors) {
    const double c2 = flag * 0.5;
    if (flag == -1) complex_fft(n >> 1, -1, (Cplx *)x, (Cplx *)work, tw);
    const int count = n >> 2;
    for (int i = 1; i <= count; i++) {
        const int i1 = i << 1;
        const int i2 = i1 + 1;
        const int i3 = n - i1;
        const int i4 = i3 + 1;
        const double wr = rotors[2 * (i - 1)];
        const double wi = rotors[2 * (i - 1) + 1];
        const double h1r = 0.5 * (x[i1] + x[i3]);
        const double h1i = 0.5 * (x[i2] - x[i4]);
        const double h2r = -c2 * (x[i2] + x[i4]);
        const double h2i = c2 * (x[i1] - x[i3]);
        x[i1] = h1r + (wr * h2r) - (wi * h2i);
        x[i2] = h1i + (wr * h2i) + (wi * h2r);
        x[i3] = h1r - (wr * h2r) + (wi * h2i);
        x[i4] = -h1i + (wr * h2i) + (wi * h2r);
    }
    const double h1r = x[0];
    if (flag == -1) {
        x[0] = h1r + x[1];
        x[1] = h1r - x[1];
    } else {
        x[0] = 0.5 * (h1r + x[1]);
        x[1] = 0.5 * (h1r - x[1]);
        complex_fft(n >> 1, 1, (Cplx *)x, (Cplx *)work, tw);
    }
}

inline uint32_t zigzag32(int32_t v) {
    return ((uint32_t)(v >> 31)) ^ ((uint32_t)v << 1);
}

#if defined(SRLA_X86_SIMD)
static inline bool srla_force_scalar_env() {
    // Defined-but-empty must read as unset: CI's matrix interpolation
    // exports SRLA_FORCE_SCALAR="" on the native leg, and Python's
    // SRLA_NATIVE_DISABLE gate already treats empty as unset.
    const char *e = getenv("SRLA_FORCE_SCALAR");
    return e && e[0];
}
static inline bool srla_has_avx2_f() {
    // SRLA_FORCE_SCALAR=1 pins the scalar rows on an AVX2 host — the CI
    // ISA-matrix leg (the reference re-runs its suite per SIMD build).
    static const bool ok = __builtin_cpu_supports("avx2")
        && !srla_force_scalar_env();
    return ok;
}

// Four-variant SoA twin of complex_fft/real_fft: lane l of every __m256d
// carries variant l's value, so each lane executes EXACTLY the scalar op
// sequence (only _mm256_{add,sub,mul}_pd — explicit intrinsics are never
// FMA-contracted, preserving the reference's per-op rounding). Layout:
// element i of the packed buffer lives at base[8*i + l] (re) / [8*i+4+l]
// (im) — i.e. Cplx4 = {re[4], im[4]}.
struct Cplx4 { __m256d re, im; };

__attribute__((target("avx2")))
static inline Cplx4 cmul4(Cplx4 a, Cplx4 b) {
    return {_mm256_sub_pd(_mm256_mul_pd(a.re, b.re),
                          _mm256_mul_pd(a.im, b.im)),
            _mm256_add_pd(_mm256_mul_pd(a.re, b.im),
                          _mm256_mul_pd(a.im, b.re))};
}

__attribute__((target("avx2")))
static inline Cplx4 ld4(const double *p) {
    return {_mm256_loadu_pd(p), _mm256_loadu_pd(p + 4)};
}

__attribute__((target("avx2")))
static inline void st4(double *p, Cplx4 v) {
    _mm256_storeu_pd(p, v.re);
    _mm256_storeu_pd(p + 4, v.im);
}

__attribute__((target("avx2")))
static void complex_fft_x4(int n, int flag, double *x, double *y,
                           const double *tw) {
    int s = 1;
    double *src = x;
    const __m256d ji = _mm256_set1_pd(-(double)flag);
    const __m256d zero = _mm256_setzero_pd();
    const auto ld = ld4;
    const auto st = st4;
    while (n > 2) {
        const int n1 = n >> 2;
        const int n2 = n >> 1;
        const int n3 = n1 + n2;
        for (int p = 0; p < n1; p++) {
            const Cplx4 w1 = {_mm256_set1_pd(tw[6 * p + 0]),
                              _mm256_set1_pd(tw[6 * p + 1])};
            const Cplx4 w2 = {_mm256_set1_pd(tw[6 * p + 2]),
                              _mm256_set1_pd(tw[6 * p + 3])};
            const Cplx4 w3 = {_mm256_set1_pd(tw[6 * p + 4]),
                              _mm256_set1_pd(tw[6 * p + 5])};
            for (int q = 0; q < s; q++) {
                const Cplx4 a = ld(x + 8 * (q + s * (p + 0)));
                const Cplx4 b = ld(x + 8 * (q + s * (p + n1)));
                const Cplx4 c = ld(x + 8 * (q + s * (p + n2)));
                const Cplx4 d = ld(x + 8 * (q + s * (p + n3)));
                const Cplx4 apc = {_mm256_add_pd(a.re, c.re),
                                   _mm256_add_pd(a.im, c.im)};
                const Cplx4 amc = {_mm256_sub_pd(a.re, c.re),
                                   _mm256_sub_pd(a.im, c.im)};
                const Cplx4 bpd = {_mm256_add_pd(b.re, d.re),
                                   _mm256_add_pd(b.im, d.im)};
                const Cplx4 bmd = {_mm256_sub_pd(b.re, d.re),
                                   _mm256_sub_pd(b.im, d.im)};
                // (0*re - ji*im, 0*im + ji*re): keep the 0.0* terms — they
                // set signed zeros exactly like the scalar path.
                const Cplx4 jbmd = {
                    _mm256_sub_pd(_mm256_mul_pd(zero, bmd.re),
                                  _mm256_mul_pd(ji, bmd.im)),
                    _mm256_add_pd(_mm256_mul_pd(zero, bmd.im),
                                  _mm256_mul_pd(ji, bmd.re))};
                st(y + 8 * (q + s * ((p << 2) + 0)),
                   {_mm256_add_pd(apc.re, bpd.re),
                    _mm256_add_pd(apc.im, bpd.im)});
                st(y + 8 * (q + s * ((p << 2) + 1)),
                   cmul4(w1, {_mm256_sub_pd(amc.re, jbmd.re),
                              _mm256_sub_pd(amc.im, jbmd.im)}));
                st(y + 8 * (q + s * ((p << 2) + 2)),
                   cmul4(w2, {_mm256_sub_pd(apc.re, bpd.re),
                              _mm256_sub_pd(apc.im, bpd.im)}));
                st(y + 8 * (q + s * ((p << 2) + 3)),
                   cmul4(w3, {_mm256_add_pd(amc.re, jbmd.re),
                              _mm256_add_pd(amc.im, jbmd.im)}));
            }
        }
        tw += 6 * n1;
        n >>= 2;
        s <<= 2;
        double *t = x; x = y; y = t;
    }
    if (n == 2) {
        for (int q = 0; q < s; q++) {
            const Cplx4 a = ld(x + 8 * q);
            const Cplx4 b = ld(x + 8 * (q + s));
            st(y + 8 * q, {_mm256_add_pd(a.re, b.re),
                           _mm256_add_pd(a.im, b.im)});
            st(y + 8 * (q + s), {_mm256_sub_pd(a.re, b.re),
                                 _mm256_sub_pd(a.im, b.im)});
        }
        s <<= 1;
        double *t = x; x = y; y = t;
    }
    if (src != x) memcpy(y, x, sizeof(double) * 8 * (size_t)s);
}

// Packed real FFT over the x4 layout: real element i lives at
// buf[8*(i/2) + (i&1)*4 + l] (even i = "re" slot, odd i = "im" slot of the
// half-size complex view) — identical aliasing to the scalar code's
// (Cplx *)x cast.
__attribute__((target("avx2")))
static void real_fft_x4(int n, int flag, double *x, double *work,
                        const double *tw, const double *rotors) {
    auto at = [&](int i) -> double * { return x + 8 * (i >> 1) + 4 * (i & 1); };
    const __m256d c2 = _mm256_set1_pd(flag * 0.5);
    const __m256d half = _mm256_set1_pd(0.5);
    const __m256d mzero = _mm256_set1_pd(-0.0);
    if (flag == -1) complex_fft_x4(n >> 1, -1, x, work, tw);
    const int count = n >> 2;
    for (int i = 1; i <= count; i++) {
        const int i1 = i << 1;
        const int i2 = i1 + 1;
        const int i3 = n - i1;
        const int i4 = i3 + 1;
        const __m256d wr = _mm256_set1_pd(rotors[2 * (i - 1)]);
        const __m256d wi = _mm256_set1_pd(rotors[2 * (i - 1) + 1]);
        const __m256d x1 = _mm256_loadu_pd(at(i1));
        const __m256d x2 = _mm256_loadu_pd(at(i2));
        const __m256d x3 = _mm256_loadu_pd(at(i3));
        const __m256d x4 = _mm256_loadu_pd(at(i4));
        const __m256d h1r = _mm256_mul_pd(half, _mm256_add_pd(x1, x3));
        const __m256d h1i = _mm256_mul_pd(half, _mm256_sub_pd(x2, x4));
        const __m256d h2r = _mm256_mul_pd(
            _mm256_xor_pd(c2, mzero), _mm256_add_pd(x2, x4));
        const __m256d h2i = _mm256_mul_pd(c2, _mm256_sub_pd(x1, x3));
        const __m256d wh2r = _mm256_mul_pd(wr, h2r);
        const __m256d wh2i_r = _mm256_mul_pd(wi, h2i);
        const __m256d wh2i = _mm256_mul_pd(wr, h2i);
        const __m256d wh2r_i = _mm256_mul_pd(wi, h2r);
        _mm256_storeu_pd(at(i1), _mm256_sub_pd(_mm256_add_pd(h1r, wh2r),
                                               wh2i_r));
        _mm256_storeu_pd(at(i2), _mm256_add_pd(_mm256_add_pd(h1i, wh2i),
                                               wh2r_i));
        _mm256_storeu_pd(at(i3), _mm256_add_pd(_mm256_sub_pd(h1r, wh2r),
                                               wh2i_r));
        _mm256_storeu_pd(at(i4), _mm256_add_pd(
            _mm256_add_pd(_mm256_xor_pd(h1i, mzero), wh2i), wh2r_i));
    }
    const __m256d h1r = _mm256_loadu_pd(at(0));
    const __m256d x1v = _mm256_loadu_pd(at(1));
    if (flag == -1) {
        _mm256_storeu_pd(at(0), _mm256_add_pd(h1r, x1v));
        _mm256_storeu_pd(at(1), _mm256_sub_pd(h1r, x1v));
    } else {
        _mm256_storeu_pd(at(0), _mm256_mul_pd(half, _mm256_add_pd(h1r, x1v)));
        _mm256_storeu_pd(at(1), _mm256_mul_pd(half, _mm256_sub_pd(h1r, x1v)));
        complex_fft_x4(n >> 1, 1, x, work, tw);
    }
}
#endif  // SRLA_X86_SIMD

}  // namespace

extern "C" {

// Batched FFT autocorrelation. windowed: (V, fft_size) f64 (already windowed
// and zero-padded). Outputs auto_corr (V, order) f64 and optionally the raw
// IFFT buffers (V, fft_size). Twiddles: fwd/inv stage tables + rotors from
// the Python side (same libm).
void srla_autocorr_batch(
    double *windowed, long V, int fft_size, int num_samples, int order,
    const double *tw_fwd, const double *rot_fwd,
    const double *tw_inv, const double *rot_inv,
    double *auto_corr, double *raw_out) {
    double *work = new double[fft_size];
    const double norm = 2.0 / num_samples;
    const int take = order < fft_size ? order : fft_size;
    for (long v = 0; v < V; v++) {
        double *buf = windowed + (long)v * fft_size;
        real_fft(fft_size, -1, buf, work, tw_fwd, rot_fwd);
        buf[0] *= buf[0];
        buf[1] *= buf[1];
        for (int i = 2; i < fft_size; i += 2) {
            const double re = buf[i];
            const double im = buf[i + 1];
            buf[i] = re * re + im * im;
            buf[i + 1] = 0.0;
        }
        real_fft(fft_size, 1, buf, work, tw_inv, rot_inv);
        double *ac = auto_corr + (long)v * order;
        for (int i = 0; i < take; i++) ac[i] = buf[i] * norm;
        for (int i = take; i < order; i++) ac[i] = 0.0;
        if (raw_out)
            memcpy(raw_out + (long)v * fft_size, buf,
                   sizeof(double) * fft_size);
    }
    delete[] work;
}

// Fused batched window + FFT autocorrelation: int32 signal -> normalize by
// `norm` -> multiply by the Welch window -> (optional odd-length middle
// sample patch from the stale work buffer) -> zero-pad -> real FFT ->
// |X|^2 -> inverse real FFT -> scale by 2/n. Identical rounding to the
// Python chain in srla_tpu/encoder.py _analyze_channel.
void srla_window_autocorr_batch(
    const int32_t *sig, long V, int n, double norm, const double *win,
    int has_mid, double mid_value,
    int fft_size, int order,
    const double *tw_fwd, const double *rot_fwd,
    const double *tw_inv, const double *rot_inv,
    double *auto_corr, double *raw_out) {
    double *work = new double[fft_size];
    double *buf = new double[fft_size];
    const double scale = 2.0 / n;
    const int take = order < fft_size ? order : fft_size;
    long v0 = 0;
#if defined(SRLA_X86_SIMD)
    // Four variants per pass in SoA lanes: every lane executes the exact
    // scalar op sequence (explicit non-FMA intrinsics), so results are
    // bit-identical to the scalar path. raw_out callers (B=1 state
    // threading) use the scalar loop below.
    if (srla_has_avx2_f() && !raw_out && V >= 4) {
        double *buf4 = new double[(size_t)fft_size * 4];
        double *work4 = new double[(size_t)fft_size * 4];
        for (; v0 + 4 <= V; v0 += 4) {
            for (int l = 0; l < 4; l++) {
                const int32_t *x = sig + (v0 + l) * (long)n;
                for (int i = 0; i < n; i++)
                    buf4[8 * (i >> 1) + 4 * (i & 1) + l] =
                        ((double)x[i] * norm) * win[i];
                if (has_mid)
                    buf4[8 * ((n / 2) >> 1) + 4 * ((n / 2) & 1) + l] =
                        mid_value;
                for (int i = n; i < fft_size; i++)
                    buf4[8 * (i >> 1) + 4 * (i & 1) + l] = 0.0;
            }
            real_fft_x4(fft_size, -1, buf4, work4, tw_fwd, rot_fwd);
            for (int l = 0; l < 4; l++) {
                buf4[l] *= buf4[l];
                buf4[4 + l] *= buf4[4 + l];
            }
            for (int i = 2; i < fft_size; i += 2) {
                double *re = buf4 + 8 * (i >> 1);
                double *im = re + 4;
                for (int l = 0; l < 4; l++) {
                    re[l] = re[l] * re[l] + im[l] * im[l];
                    im[l] = 0.0;
                }
            }
            real_fft_x4(fft_size, 1, buf4, work4, tw_inv, rot_inv);
            for (int l = 0; l < 4; l++) {
                double *ac = auto_corr + (v0 + l) * (long)order;
                for (int i = 0; i < take; i++)
                    ac[i] = buf4[8 * (i >> 1) + 4 * (i & 1) + l] * scale;
                for (int i = take; i < order; i++) ac[i] = 0.0;
            }
        }
        delete[] buf4;
        delete[] work4;
    }
#endif
    for (long v = v0; v < V; v++) {
        const int32_t *x = sig + (long)v * n;
        for (int i = 0; i < n; i++) buf[i] = ((double)x[i] * norm) * win[i];
        if (has_mid) buf[n / 2] = mid_value;
        for (int i = n; i < fft_size; i++) buf[i] = 0.0;
        real_fft(fft_size, -1, buf, work, tw_fwd, rot_fwd);
        buf[0] *= buf[0];
        buf[1] *= buf[1];
        for (int i = 2; i < fft_size; i += 2) {
            const double re = buf[i];
            const double im = buf[i + 1];
            buf[i] = re * re + im * im;
            buf[i + 1] = 0.0;
        }
        real_fft(fft_size, 1, buf, work, tw_inv, rot_inv);
        double *ac = auto_corr + (long)v * order;
        for (int i = 0; i < take; i++) ac[i] = buf[i] * scale;
        for (int i = take; i < order; i++) ac[i] = 0.0;
        if (raw_out)
            memcpy(raw_out + (long)v * fft_size, buf,
                   sizeof(double) * fft_size);
    }
    delete[] work;
    delete[] buf;
}

#if defined(SRLA_X86_SIMD)
static inline bool srla_has_avx2() {
    static const bool ok = __builtin_cpu_supports("avx2")
        && !srla_force_scalar_env();
    return ok;
}

// AVX2 integer code-length sums for the Rice search (exact: logical-shift
// and wrapping-subtract lanes match the scalar semantics bit-for-bit; the
// two loops were the largest host-encode term at 0.27 s / 2 min of audio).
__attribute__((target("avx2")))
static int64_t rice_sum_shift_avx2(const uint32_t *u, int n, int k) {
    const __m128i kc = _mm_cvtsi32_si128(k);
    const __m256i zero = _mm256_setzero_si256();
    __m256i acc = _mm256_setzero_si256();
    int i = 0;
    for (; i + 8 <= n; i += 8) {
        __m256i v = _mm256_loadu_si256((const __m256i *)(u + i));
        v = _mm256_srl_epi32(v, kc);
        acc = _mm256_add_epi64(acc, _mm256_add_epi64(
            _mm256_unpacklo_epi32(v, zero), _mm256_unpackhi_epi32(v, zero)));
    }
    alignas(32) int64_t lanes[4];
    _mm256_store_si256((__m256i *)lanes, acc);
    int64_t s = lanes[0] + lanes[1] + lanes[2] + lanes[3];
    for (; i < n; i++) s += u[i] >> k;
    return s;
}

// Recursive-Rice overflow sum: d = (int32)(u[i] - (uint32)k1pow);
// if (d > 0) s += d >> k.  d > 0 implies the arithmetic and logical shifts
// agree; negative lanes are masked out.
__attribute__((target("avx2")))
static int64_t rice_sum_rec_avx2(const uint32_t *u, int n, uint32_t k1pow32,
                                 int k) {
    const __m128i kc = _mm_cvtsi32_si128(k);
    const __m256i zero = _mm256_setzero_si256();
    const __m256i kp = _mm256_set1_epi32((int32_t)k1pow32);
    __m256i acc = _mm256_setzero_si256();
    int i = 0;
    for (; i + 8 <= n; i += 8) {
        __m256i v = _mm256_loadu_si256((const __m256i *)(u + i));
        __m256i d = _mm256_sub_epi32(v, kp);
        __m256i pos = _mm256_cmpgt_epi32(d, zero);
        d = _mm256_and_si256(pos, _mm256_srl_epi32(d, kc));
        acc = _mm256_add_epi64(acc, _mm256_add_epi64(
            _mm256_unpacklo_epi32(d, zero), _mm256_unpackhi_epi32(d, zero)));
    }
    alignas(32) int64_t lanes[4];
    _mm256_store_si256((__m256i *)lanes, acc);
    int64_t s = lanes[0] + lanes[1] + lanes[2] + lanes[3];
    for (; i < n; i++) {
        int32_t d = (int32_t)(u[i] - k1pow32);
        if (d > 0) s += d >> k;
    }
    return s;
}
#endif

// Per-partition Rice code-length sum: the element function the reference
// applies at every partition of every level (srla_coder.c). `recursive`
// selects the overflow form d = (int32)(u - 2^(k+1)); d > 0 ? d >> k : 0
// (int32 wrap semantics preserved), else the plain logical-shift sum.
static int64_t rice_part_sum(const uint32_t *up, int nsmpl, int k,
                             bool recursive) {
    if (recursive) {
        const uint32_t k1pow = (uint32_t)((int64_t)1 << (k + 1));
#if defined(SRLA_X86_SIMD)
        if (srla_has_avx2() && nsmpl >= 8)
            return rice_sum_rec_avx2(up, nsmpl, k1pow, k);
#endif
        int64_t rb = 0;
        for (int i = 0; i < nsmpl; i++) {
            // reference computes this difference in int32
            int32_t d = (int32_t)(up[i] - k1pow);
            if (d > 0) rb += d >> k;
        }
        return rb;
    }
#if defined(SRLA_X86_SIMD)
    if (srla_has_avx2() && nsmpl >= 8)
        return rice_sum_shift_avx2(up, nsmpl, k);
#endif
    int64_t rb = 0;
    for (int i = 0; i < nsmpl; i++) rb += up[i] >> k;
    return rb;
}

// Plain-Rice parameter via the reference's transcendental chain
// (srla_coder.c:262-287): k = max(0, round(log2(ln OPTX / ln(1-1/(1+m))))).
// Kept verbatim as the exact fallback of the boundary fast path below.
static int32_t plain_rice_k_libm(double mean) {
    const double rho = 1.0 / (1.0 + mean);
    const double om = 1.0 - rho;
    const double denom = (om == 0.0) ? -HUGE_VAL : log(om);
    const double lv2 =
        log(0.5127629514437670454896078808815218508243560791015625)
        / denom;
    const double log2v =
        ((lv2 == 0.0) ? -HUGE_VAL : log(lv2)) * 1.4426950408889634;
    double r = (log2v >= 0.0) ? floor(log2v + 0.5) : -floor(-log2v + 0.5);
    if (r < 0.0) r = 0.0;
    return (int32_t)r;
}

// The chain above is a monotone step function of the partition MEAN; its
// step j sits where log2v crosses j - 0.5. Precompute each step's mean
// once with a guard band: means outside every band resolve by comparison,
// means inside one fall back to the exact chain. Replaces 3 libm logs per
// partition — the dominant -V measurement cost on quiet/tonal content (up
// to 2047 partitions/block).
//
// Band width: the libm chain's own flip point is fuzzy in MEAN space at
// ~2^(j-53) relative near boundary j (om = 1 - 1/(1+m) quantization makes
// the chain's decision grain grow with the boundary mean), so a flat
// relative-1e-9 band is too narrow for j >= 25 (means ~3.5e7+). Scale the
// band with the boundary's actual fuzz — m * max(1e-9, 2^(j-51)) — so the
// fast path stays conservative at every j. (With the codec's bounds —
// plain Rice gated on block mean < 2.0, max_porder <= 10 ⇒ partition
// means < 2048, boundaries j <= 11 — only the 1e-9 term is ever active;
// the fuzz term future-proofs the helper for larger means.)
// Same mean-space-boundary idea as the device table in kernels/exact.py
// (_rice_k_boundaries), but with a fallback instead of a repair flag.
static double plain_k_bound_lo[33];
static double plain_k_bound_hi[33];

static int plain_k_bounds_init(void) {
    for (int j = 1; j < 32; j++) {
        // Solve log2v == j - 0.5 for the mean: om = exp(ln OPTX / 2^(j-.5))
        const double v = pow(2.0, j - 0.5);
        const double om = exp(
            log(0.5127629514437670454896078808815218508243560791015625)
            / v);
        const double m = om / (1.0 - om);
        const double rel = 1e-9 > ldexp(4.0, j - 53) ? 1e-9
                                                     : ldexp(4.0, j - 53);
        const double band = m * rel + 1e-12;
        plain_k_bound_lo[j] = m - band;
        plain_k_bound_hi[j] = m + band;
    }
    plain_k_bound_lo[0] = plain_k_bound_hi[0] = -HUGE_VAL;
    plain_k_bound_lo[32] = plain_k_bound_hi[32] = HUGE_VAL;
    return 1;
}

static inline int32_t plain_rice_k(double mean) {
    static const int inited = plain_k_bounds_init();
    (void)inited;
    int k = 0;
    while (k < 31 && mean >= plain_k_bound_hi[k + 1]) k++;
    if (mean > plain_k_bound_lo[k + 1])  /* inside boundary k+1's band */
        return plain_rice_k_libm(mean);
    return k;
}

// Batched Rice partition search (exact; same decisions as the reference).
// residuals: (V, n) int32. Outputs per variant: code_type, best_porder,
// min_bits, ks (V, 1024) int16.
//
// Levels are evaluated coarse-to-fine in the reference's porder order with
// its running early exit (a partition loop breaks as soon as the running
// bits reach the best level so far), plus a sum-based prune the reference
// doesn't have: each partition's quotient sum is bounded below from the
// EXACT partition sum (sum(u >> k) >= (S - nsmpl*(2^k-1)) >> k, and the
// recursive-Rice analogue with offset 3*2^k-1), so a level whose bound
// already exceeds the running best is skipped in O(nparts) without
// touching the samples. Bounds only ever skip levels that cannot win, so
// the selected (code_type, porder, ks, bits) are identical to the
// reference's exhaustive scan. The prune is disabled for blocks containing
// values >= 2^31, where the reference's int32-wrapping recursive quotient
// can undershoot the no-wrap bound.
void srla_rice_search_batch(
    const int32_t *residuals, long V, int n, int max_porder,
    int32_t *code_type_out, int32_t *porder_out, int64_t *bits_out,
    int16_t *ks_out) {
    const int MAXP = 1 << max_porder;
    uint32_t *u = new uint32_t[n];
    double *mean_lvls = new double[(max_porder + 1) * MAXP];
    int32_t *k_pyr = new int32_t[(max_porder + 1) * MAXP];
    int64_t *sum_pyr = new int64_t[(max_porder + 1) * MAXP];
    for (long v = 0; v < V; v++) {
        const int32_t *res = residuals + (long)v * n;
        uint32_t max_uval = 0;
        for (int i = 0; i < n; i++) {
            u[i] = zigzag32(res[i]);
            if (u[i] > max_uval) max_uval = u[i];
        }
        // Leaf means (exact: integer sums fit f64), then pairwise merges.
        const int nleaf = MAXP;
        const int leafn = n / nleaf;
        double *lv = mean_lvls + max_porder * MAXP;
        int64_t *ls = sum_pyr + max_porder * MAXP;
        for (int p = 0; p < nleaf; p++) {
            int64_t s = 0;
            for (int i = 0; i < leafn; i++) s += u[p * leafn + i];
            lv[p] = (double)s / leafn;
            ls[p] = s;
        }
        for (int lvl = max_porder - 1; lvl >= 0; lvl--) {
            double *cur = mean_lvls + lvl * MAXP;
            double *fine = mean_lvls + (lvl + 1) * MAXP;
            int64_t *cs = sum_pyr + lvl * MAXP;
            const int64_t *fs = sum_pyr + (lvl + 1) * MAXP;
            for (int p = 0; p < (1 << lvl); p++) {
                cur[p] = (fine[2 * p] + fine[2 * p + 1]) / 2.0;
                cs[p] = fs[2 * p] + fs[2 * p + 1];
            }
        }
        if (max_uval == 0) {
            code_type_out[v] = 2;
            porder_out[v] = 0;
            bits_out[v] = 2;
            memset(ks_out + (long)v * 1024, 0, 1024 * sizeof(int16_t));
            continue;
        }
        const bool recursive = mean_lvls[0] >= 2.0;
        // 1) Rice parameter for every (level, partition) from its mean
        //    (identical arithmetic to the reference's per-partition chain).
        for (int lvl = 0; lvl <= max_porder; lvl++) {
            const double *m = mean_lvls + lvl * MAXP;
            int32_t *kk = k_pyr + lvl * MAXP;
            const int nparts = 1 << lvl;
            if (recursive) {
                for (int p = 0; p < nparts; p++) {
                    double g = 0.66794162356 * (1.0 + m[p]);
                    if (g < 1.0) g = 1.0;
                    kk[p] = 31 - __builtin_clz((uint32_t)g);
                }
            } else {
                for (int p = 0; p < nparts; p++)
                    kk[p] = plain_rice_k(m[p]);
            }
        }
        // 2) Coarse-to-fine level scoring with the sum bound and the
        //    reference's running early exit. Quotient sums are computed
        //    on demand only for levels the bound cannot dismiss.
        const int khdr = recursive ? 2 : 1;
        const bool bound_ok = !recursive || max_uval < 0x80000000u;
        int64_t best_bits = INT64_MAX;
        int best_porder = 0;
        for (int porder = 0; porder <= max_porder; porder++) {
            const int nparts = 1 << porder;
            const int nsmpl = n >> porder;
            const int32_t *kk = k_pyr + porder * MAXP;
            const int64_t *ss = sum_pyr + porder * MAXP;
            if (best_bits != INT64_MAX) {
                int64_t lb = 10 + 5;
                int32_t prevk = 0;
                for (int part = 0; part < nparts && lb < best_bits; part++) {
                    const int32_t k = kk[part];
                    lb += (int64_t)(k + khdr) * nsmpl;
                    if (bound_ok) {
                        const int64_t off = recursive ? (3LL << k) - 1
                                                      : (1LL << k) - 1;
                        const int64_t num = ss[part] - (int64_t)nsmpl * off;
                        if (num > 0) lb += num >> k;
                    }
                    if (part != 0) lb += zigzag32(k - prevk) + 1;
                    prevk = k;
                }
                if (lb >= best_bits) continue;
            }
            int64_t bits = 10 + 5;
            int32_t prevk = 0;
            int part = 0;
            for (; part < nparts; part++) {
                const int32_t k = kk[part];
                bits += (int64_t)(k + khdr) * nsmpl
                        + rice_part_sum(u + (long)part * nsmpl, nsmpl, k,
                                        recursive);
                if (part != 0) bits += zigzag32(k - prevk) + 1;
                prevk = k;
                if (bits >= best_bits) break;
            }
            if (part == nparts && bits < best_bits) {
                best_bits = bits;
                best_porder = porder;
            }
        }
        int16_t *ks_row = ks_out + (long)v * 1024;
        {
            const int nparts = 1 << best_porder;
            const int32_t *kk = k_pyr + best_porder * MAXP;
            for (int p = 0; p < nparts; p++) ks_row[p] = (int16_t)kk[p];
            for (int p = nparts; p < 1024; p++) ks_row[p] = 0;
        }
        code_type_out[v] = recursive ? 1 : 0;
        porder_out[v] = best_porder;
        bits_out[v] = best_bits + 2;
    }
    delete[] u;
    delete[] mean_lvls;
    delete[] k_pyr;
    delete[] sum_pyr;
}

#if defined(SRLA_X86_SIMD)
// 4 samples per iteration: vpmuldq multiplies the signed low-32 lanes of
// each 64-bit element, giving exact int32*int32->int64 products; wrapping
// truncation to int32 at the end, identical to the scalar path. Returns the
// first unprocessed sample index.
__attribute__((target("avx2")))
static int fir_rows_avx2(const int32_t *x, int32_t *r, const int32_t *c,
                         int o, int rs, int64_t half, int n) {
    // The reference truncates the int64 accumulator to int32 BEFORE the
    // arithmetic shift ((int32_t)(uint32_t)acc >> rs, lpc.c LPC_Predict),
    // and 2^32-wrapping addition commutes with per-product truncation — so
    // the whole dot runs exactly in wrapping int32 lanes: one vpmulld +
    // vpaddd per tap for 8 outputs (the previous int64-lane form managed 4
    // outputs with twice the work per tap).
    const __m256i hv = _mm256_set1_epi32((int32_t)(uint32_t)half);
    const __m128i rsv = _mm_cvtsi32_si128(rs);
    int s = o;
    // 16 outputs per iteration: two accumulators share each tap's
    // broadcast coefficient, halving broadcasts and L1 loads per output
    // and splitting the accumulate dependency chain.
    for (; s + 16 <= n; s += 16) {
        __m256i acc0 = hv, acc1 = hv;
        const int32_t *base = x + s - o;
        for (int i = 0; i < o; i++) {
            const __m256i cv = _mm256_set1_epi32(c[i]);
            __m256i x0 = _mm256_loadu_si256((const __m256i *)(base + i));
            __m256i x1 = _mm256_loadu_si256((const __m256i *)(base + i + 8));
            acc0 = _mm256_add_epi32(acc0, _mm256_mullo_epi32(x0, cv));
            acc1 = _mm256_add_epi32(acc1, _mm256_mullo_epi32(x1, cv));
        }
        const __m256i xs0 = _mm256_loadu_si256((const __m256i *)(x + s));
        const __m256i xs1 = _mm256_loadu_si256((const __m256i *)(x + s + 8));
        _mm256_storeu_si256((__m256i *)(r + s),
                            _mm256_add_epi32(xs0, _mm256_sra_epi32(acc0, rsv)));
        _mm256_storeu_si256((__m256i *)(r + s + 8),
                            _mm256_add_epi32(xs1, _mm256_sra_epi32(acc1, rsv)));
    }
    for (; s + 8 <= n; s += 8) {
        __m256i acc = hv;
        const int32_t *base = x + s - o;
        for (int i = 0; i < o; i++) {
            __m256i xv = _mm256_loadu_si256((const __m256i *)(base + i));
            acc = _mm256_add_epi32(
                acc, _mm256_mullo_epi32(xv, _mm256_set1_epi32(c[i])));
        }
        const __m256i pred = _mm256_sra_epi32(acc, rsv);
        const __m256i xs = _mm256_loadu_si256((const __m256i *)(x + s));
        _mm256_storeu_si256((__m256i *)(r + s),
                            _mm256_add_epi32(xs, pred));
    }
    return s;
}
#endif

// Batched forward LPC prediction (wrapping int32, x86 shift semantics).
// data (B, n) int32; coefs (B, maxorder) int32 left-aligned order-reversed
// (coef[i] multiplies data[s - order + i]); residual out (B, n) int32.
// Parity: srla_encoder/src/srla_lpc_predict.c:235-294 (via the host path in
// srla_tpu/dsp/predict.py — bit-identical decisions).
void srla_lpc_predict_batch(const int32_t *data, long B, int n,
                            const int32_t *coefs, int maxorder,
                            const int32_t *orders, const int32_t *rshifts,
                            int32_t *out) {
    for (long b = 0; b < B; b++) {
        const int32_t *x = data + (long)b * n;
        int32_t *r = out + (long)b * n;
        const int o = orders[b];
        if (o <= 0) {
            memcpy(r, x, sizeof(int32_t) * (size_t)n);
            continue;
        }
        const int rs = rshifts[b];
        // C's 1 << (rshift - 1): rshift==0 hits x86 shift-count masking.
        const int64_t half = (rs > 0) ? ((int64_t)1 << (rs - 1))
                                      : (int64_t)0x80000000LL;
        const int32_t *c = coefs + (long)b * maxorder;
        r[0] = x[0];
        const int lead = o < n ? o : n;
        for (int s = 1; s < lead; s++)
            r[s] = (int32_t)((uint32_t)x[s] - (uint32_t)x[s - 1]);
        int s = o;
#if defined(SRLA_X86_SIMD)
        if (srla_has_avx2())
            s = fir_rows_avx2(x, r, c, o, rs, half, n);
#endif
        for (; s < n; s++) {
            int64_t acc = half;
            for (int i = 0; i < o; i++)
                acc += (int64_t)c[i] * x[s - o + i];
            const int32_t pred = (int32_t)(uint32_t)acc >> rs;
            r[s] = (int32_t)((uint32_t)x[s] + (uint32_t)pred);
        }
    }
}

// Batched long-term (pitch) prediction. data (B, n) int32 (the pre-emphasized
// working signal); coefs (B, order) int32 REVERSED (coef[i] multiplies
// data[s - period - order/2 + i]); periods (B,) int32 (0 = LTP disabled for
// that row). The prediction source is the ORIGINAL data (no recurrence), so
// rows are independent and samples vectorize freely.
// Parity: SRLALTP_Predict, srla_encoder/src/srla_lpc_predict.c:267-294.
void srla_ltp_predict_batch(const int32_t *data, long B, int n,
                            const int32_t *coefs, int order,
                            const int32_t *periods, int rshift,
                            int32_t *out) {
    const int64_t half = (int64_t)1 << (rshift - 1);
    const int half_order = order >> 1;
    for (long b = 0; b < B; b++) {
        const int32_t *x = data + (long)b * n;
        int32_t *r = out + (long)b * n;
        memcpy(r, x, sizeof(int32_t) * (size_t)n);
        const int per = periods[b];
        if (per == 0)
            continue;
        const int delay = per + half_order;
        const int32_t *c = coefs + (long)b * order;
        for (int s = delay + 1; s < n; s++) {
            int64_t acc = half;
            for (int i = 0; i < order; i++)
                acc += (int64_t)c[i] * x[s - delay + i];
            const int32_t pred = (int32_t)(uint32_t)acc >> rshift;
            r[s] = (int32_t)((uint32_t)x[s] - (uint32_t)pred);
        }
    }
}

// ---- Long-term prediction analysis (batched) --------------------------- //
// Pitch detection (zero-crossing-bracketed peak scan) + Toeplitz/Cholesky
// LTP solve + 6-bit coefficient quantization, per row. Exact f64 port of
// srla_tpu/dsp/pitch.py (itself the parity twin of libs/lpc/src/lpc.c:
// 1473-1649); pow() goes through platform libm exactly like Python math.pow.
static int srla_detect_pitch(const double *ac, int min_period,
                             int max_period) {
    const int MAX_CAND = 20;
    int candidates[20];
    int ncand = 0;
    double max_peak = 0.0;
    int i = min_period;
    while (i < max_period && ncand < MAX_CAND) {
        int start = i;
        while (start < max_period) {
            if (ac[start - 1] < 0.0 && ac[start] > 0.0)
                break;
            start++;
        }
        int end = start + 1;
        while (end < max_period - 1) {
            if (ac[end] > 0.0 && ac[end + 1] < 0.0)
                break;
            end++;
        }
        int local_peak_index = 0;
        double local_peak = 0.0;
        for (int j = start; j <= end; j++) {
            if (ac[j] > ac[j - 1] && ac[j] > ac[j + 1]) {
                if (ac[j] > local_peak) {
                    local_peak_index = j;
                    local_peak = ac[j];
                }
            }
        }
        if (local_peak_index != 0) {
            candidates[ncand++] = local_peak_index;
            if (local_peak > max_peak)
                max_peak = local_peak;
        }
        i = end + 1;
    }
    if (ncand == 0)
        return 0;
    if (max_peak < 0.1 * ac[0])
        return 0;
    for (int c = 0; c < ncand; c++) {
        if (ac[candidates[c]] >= 0.9 * max_peak)
            return candidates[c];
    }
    return 0;
}

// acbuf (B, stride) f64 with lags 0..max_period (+2 zero pad, like the
// Python caller's acbuf); out_period (B,) int32 (0 = no usable pitch);
// out_qcoefs (B, order) int32, 6-bit quantized, REVERSED (ready for the
// forward-indexed LTP filter). Rows are mutated locally only.
void srla_ltp_analyze_batch(const double *acbuf, long B, int stride,
                            int coef_order, int min_period, int max_period,
                            double ridge, int32_t *out_period,
                            int32_t *out_qcoefs) {
    const double FLT_MIN_ = 1.1754943508222875e-38;
    double ac[1024];
    double A[8][8];
    double inv_diag[8], x[8];
    for (long b = 0; b < B; b++) {
        out_period[b] = 0;
        for (int j = 0; j < coef_order; j++)
            out_qcoefs[b * coef_order + j] = 0;
        const double *row = acbuf + (long)b * stride;
        for (int j = 0; j < stride && j < 1024; j++)
            ac[j] = row[j];
        if (fabs(ac[0]) <= FLT_MIN_)
            continue;
        const int period = srla_detect_pitch(ac, min_period, max_period);
        if (period == 0 || period < (coef_order / 2) + 1)
            continue;
        ac[0] *= (1.0 + ridge);
        for (int j = 0; j < coef_order; j++)
            for (int k = j; k < coef_order; k++)
                A[j][k] = A[k][j] = ac[k - j];
        // Cholesky (in-place lower form, pow(s, -0.5) via libm).
        int singular = 0;
        for (int j = 0; j < coef_order; j++) {
            double s = A[j][j];
            for (int k = j - 1; k >= 0; k--)
                s -= A[j][k] * A[j][k];
            if (s <= 0.0) {
                singular = 1;
                break;
            }
            inv_diag[j] = pow(s, -0.5);
            for (int m = j + 1; m < coef_order; m++) {
                double t = A[j][m];
                for (int k = j - 1; k >= 0; k--)
                    t -= A[j][k] * A[m][k];
                A[m][j] = t * inv_diag[j];
            }
        }
        if (singular)
            continue;
        const double *rhs = ac + (period - coef_order / 2);
        for (int j = 0; j < coef_order; j++) {
            double s = rhs[j];
            for (int k = j - 1; k >= 0; k--)
                s -= A[j][k] * x[k];
            x[j] = s * inv_diag[j];
        }
        for (int j = coef_order - 1; j >= 0; j--) {
            double s = x[j];
            for (int k = j + 1; k < coef_order; k++)
                s -= A[k][j] * x[k];
            x[j] = s * inv_diag[j];
        }
        out_period[b] = period;
        for (int j = 0; j < coef_order; j++) {
            const double c = x[j];
            double q = (c >= 0.0) ? floor(c * 32.0 + 0.5)
                                  : -floor(-c * 32.0 + 0.5);
            if (q < -32.0) q = -32.0;
            if (q > 31.0) q = 31.0;
            out_qcoefs[b * coef_order + (coef_order - 1 - j)] = (int32_t)q;
        }
    }
}

// One block of the Levinson-Durbin recursion, run to `k_end` recursion
// steps (k_end == max_order reproduces the full pass). a_prev/a_cur are
// caller scratch of max_order+2 doubles each.
static void srla_levinson_one(const double *ac, int max_order, int k_end,
                              int collect_order, double *ev, double *pc,
                              double *col, double *a_prev, double *a_cur) {
    if (col) memset(col, 0, sizeof(double) * max_order);
    for (int i = 0; i <= max_order + 1; i++) a_prev[i] = a_cur[i] = 0.0;
    const double r0 = ac[0];
    a_prev[0] = 1.0;
    ev[0] = r0;
    a_prev[1] = -ac[1] / r0;
    pc[0] = ac[1] / r0;
    ev[1] = r0 + ac[1] * a_prev[1];
    if (col && collect_order == 1) col[0] = a_prev[1];
    for (int k = 1; k < k_end; k++) {
        double gamma = 0.0;
        for (int i = 0; i <= k; i++) gamma += a_prev[i] * ac[k + 1 - i];
        gamma /= -ev[k];
        ev[k + 1] = ev[k] * (1.0 - gamma * gamma);
        for (int i = 0; i <= k + 1; i++)
            a_cur[i] = a_prev[i] + gamma * a_prev[k + 1 - i];
        if (k + 2 <= max_order + 1) a_cur[k + 2] = 0.0;  // next iter reads it
        pc[k] = -gamma;
        if (col && collect_order == k + 1)
            for (int i = 0; i <= k; i++) col[i] = a_cur[1 + i];
        double *t = a_prev; a_prev = a_cur; a_cur = t;
    }
}

#if defined(SRLA_X86_SIMD)
// Four-block SoA twin of the all-orders Levinson pass: lane l of every
// __m256d carries block l's value, so each lane executes EXACTLY the
// scalar op sequence. Only explicit _mm256_{add,sub,mul,div}_pd — never
// FMA-contracted, preserving the reference's per-op f64 rounding
// (libs/lpc/src/lpc.c:379-441). Negation is a sign-bit xor (the exact
// IEEE negation the scalar `-x` performs). SoA scratch layout: recursion
// coefficient i, lane l at buf[4*i + l].
__attribute__((target("avx2")))
static void srla_levinson_x4(const double *ac_rows[4], int max_order,
                             double *ev_rows[4], double *pc_rows[4],
                             double *soa_scratch) {
    double *ap = soa_scratch;                        // (max_order+2) x 4
    double *acu = ap + 4 * (max_order + 2);          // (max_order+2) x 4
    double *acs = acu + 4 * (max_order + 2);         // (max_order+1) x 4
    for (int i = 0; i <= max_order; i++)
        for (int l = 0; l < 4; l++) acs[4 * i + l] = ac_rows[l][i];
    memset(ap, 0, sizeof(double) * 8 * (max_order + 2));
    const __m256d one = _mm256_set1_pd(1.0);
    const __m256d sgn = _mm256_set1_pd(-0.0);
    const __m256d zero = _mm256_setzero_pd();
    const __m256d r0 = _mm256_loadu_pd(acs);
    const __m256d ac1 = _mm256_loadu_pd(acs + 4);
    _mm256_storeu_pd(ap, one);                            // a_prev[0] = 1
    const __m256d ap1 = _mm256_div_pd(_mm256_xor_pd(ac1, sgn), r0);
    _mm256_storeu_pd(ap + 4, ap1);
    const __m256d pc0 = _mm256_div_pd(ac1, r0);
    __m256d evk = _mm256_add_pd(r0, _mm256_mul_pd(ac1, ap1));  // ev[1]
    double lane4[4];
    for (int l = 0; l < 4; l++) ev_rows[l][0] = acs[l];
    _mm256_storeu_pd(lane4, evk);
    for (int l = 0; l < 4; l++) ev_rows[l][1] = lane4[l];
    _mm256_storeu_pd(lane4, pc0);
    for (int l = 0; l < 4; l++) pc_rows[l][0] = lane4[l];
    for (int k = 1; k < max_order; k++) {
        // gamma starts from scalar 0.0 + p0 (an exact no-op except for the
        // sign of a -0.0 product, which must match the scalar chain).
        __m256d g = _mm256_add_pd(zero,
            _mm256_mul_pd(_mm256_loadu_pd(ap),
                          _mm256_loadu_pd(acs + 4 * (k + 1))));
        for (int i = 1; i <= k; i++)
            g = _mm256_add_pd(g,
                _mm256_mul_pd(_mm256_loadu_pd(ap + 4 * i),
                              _mm256_loadu_pd(acs + 4 * (k + 1 - i))));
        g = _mm256_div_pd(g, _mm256_xor_pd(evk, sgn));
        const __m256d evn = _mm256_mul_pd(
            evk, _mm256_sub_pd(one, _mm256_mul_pd(g, g)));
        for (int i = 0; i <= k + 1; i++)
            _mm256_storeu_pd(acu + 4 * i,
                _mm256_add_pd(_mm256_loadu_pd(ap + 4 * i),
                    _mm256_mul_pd(g, _mm256_loadu_pd(ap + 4 * (k + 1 - i)))));
        if (k + 2 <= max_order + 1)
            _mm256_storeu_pd(acu + 4 * (k + 2), zero);
        _mm256_storeu_pd(lane4, _mm256_xor_pd(g, sgn));
        for (int l = 0; l < 4; l++) pc_rows[l][k] = lane4[l];
        _mm256_storeu_pd(lane4, evn);
        for (int l = 0; l < 4; l++) ev_rows[l][k + 1] = lane4[l];
        evk = evn;
        double *t = ap; ap = acu; acu = t;
    }
}
#endif

// Batched Levinson-Durbin recursion (f64, identical rounding order to the
// host path / reference; parity: libs/lpc/src/lpc.c:379-441). Emits error
// variances at every order, PARCOR coefficients, and optionally the LPC
// coefficient vector at a per-block selected order.
//
// Fast paths (bit-identical outputs, covered by the scalar-vs-SIMD parity
// tests): (a) the all-orders pass (collect_orders == NULL) runs 4 blocks
// per AVX2 f64 lane group; (b) the collect pass stops each block's
// recursion at its own collect order — ev/pc beyond that order are left
// unwritten, which the only caller (levinson_coefs_at) discards.
void srla_levinson_batch(const double *auto_corr, long B, int max_order,
                         const int32_t *collect_orders,
                         double *error_vars, double *parcor,
                         double *collected) {
    const double FLT_EPS = 1.1920928955078125e-07;
    double *a_prev = new double[max_order + 2];
    double *a_cur = new double[max_order + 2];
    long b0 = 0;
#if defined(SRLA_X86_SIMD)
    if (!collected && srla_has_avx2_f() && B >= 4) {
        double *soa = new double[(size_t)12 * (max_order + 2)];
        for (; b0 + 4 <= B; b0 += 4) {
            const double *ac_rows[4];
            double *ev_rows[4], *pc_rows[4];
            for (int l = 0; l < 4; l++) {
                ac_rows[l] = auto_corr + (b0 + l) * (long)(max_order + 1);
                ev_rows[l] = error_vars + (b0 + l) * (long)(max_order + 1);
                pc_rows[l] = parcor + (b0 + l) * (long)max_order;
            }
            srla_levinson_x4(ac_rows, max_order, ev_rows, pc_rows, soa);
        }
        delete[] soa;
    }
#endif
    for (long b = b0; b < B; b++) {
        const double *ac = auto_corr + (long)b * (max_order + 1);
        double *ev = error_vars + (long)b * (max_order + 1);
        double *pc = parcor + (long)b * max_order;
        double *col = collected ? collected + (long)b * max_order : nullptr;
        int k_end = max_order;
        if (col) {
            // Coefficients are captured when k+1 == collect_orders[b]; no
            // later step can change them, so stop there (orders <= 1 need
            // no recursion steps at all).
            k_end = collect_orders[b];
            if (k_end > max_order) k_end = max_order;
        }
        srla_levinson_one(ac, max_order, k_end,
                          col ? collect_orders[b] : -1,
                          ev, pc, col, a_prev, a_cur);
    }
    // Silent special case (applies to every path above).
    for (long b = 0; b < B; b++) {
        const double r0 = auto_corr[(long)b * (max_order + 1)];
        if (fabs(r0) < FLT_EPS) {
            double *ev = error_vars + (long)b * (max_order + 1);
            double *pc = parcor + (long)b * max_order;
            for (int i = 0; i <= max_order; i++) ev[i] = r0;
            for (int i = 0; i < max_order; i++) pc[i] = 0.0;
            if (collected)
                memset(collected + (long)b * max_order, 0,
                       sizeof(double) * max_order);
        }
    }
}

// Batched pre-emphasis coefficient estimation (order-1 normalized
// autocorrelation; parity: libs/srla_internal/src/srla_utility.c:206-378 via
// srla_tpu/dsp/preemphasis.py). Integer sums below 2^53 are exact in f64 in
// any order; larger sums replay the reference's sequential f64 accumulation.
void srla_preemph_coef_batch(const int32_t *data, long B, int n,
                             int32_t *coef) {
    const double EXACT_LIMIT = 9007199254740992.0;  // 2^53
    for (long b = 0; b < B; b++) {
        const int32_t *x = data + (long)b * n;
        int64_t ir0 = 0, ir1 = 0;
        for (int i = 0; i < n; i++) ir0 += (int64_t)x[i] * x[i];
        for (int i = 0; i + 1 < n; i++) ir1 += (int64_t)x[i] * x[i + 1];
        double r0 = (double)ir0, r1 = (double)ir1;
        if (!(fabs(r0) < EXACT_LIMIT && fabs(r1) < EXACT_LIMIT)) {
            double acc0 = 0.0, acc1 = 0.0;
            for (int i = 0; i + 1 < n; i++) {
                acc0 += (double)x[i] * (double)x[i];
                acc1 += (double)x[i] * (double)x[i + 1];
            }
            acc0 += (double)x[n - 1] * (double)x[n - 1];
            r0 = acc0;
            r1 = acc1;
        }
        int32_t c = 0;
        if (r0 >= 1e-6) {
            const double dc = r1 / r0;
            const double scaled = dc * 16.0;  // 1 << PREEMPHASIS_COEF_SHIFT
            double q = (scaled >= 0.0) ? floor(scaled + 0.5)
                                       : -floor(-scaled + 0.5);
            if (q < -16.0) q = -16.0;
            if (q > 15.0) q = 15.0;
            c = (int32_t)q;
        }
        coef[b] = c;
    }
}

#if defined(SRLA_X86_SIMD)
// Vector body of the pre-emphasis filter: the "previous sample" is just
// x[i-1] (not the filter's own output), so the whole row is elementwise:
// y[i] = x[i] - (int32_wrap(x[i-1] * c) >> 4). mullo_epi32 IS the int32
// wrap multiply; srai matches C's arithmetic >> on the wrapped product.
//
// NOT in-place safe (x != y required): this path re-reads x[i-1] from
// memory after y[i-1] may already be written, unlike the scalar loop it
// replaced which carried the previous INPUT sample in a register. The
// only caller (native_decoder.preemphasis_batch) always allocates a
// fresh output; keep it that way or add an x==y scalar guard.
__attribute__((target("avx2")))
static void preemphasis_row_avx2(const int32_t *x, int32_t *y, int n,
                                 int32_t c, int32_t p0) {
    const __m256i cv = _mm256_set1_epi32(c);
    int i = 0;
    if (n > 0) {
        const int32_t pr = (int32_t)(uint32_t)((int64_t)p0 * c) >> 4;
        y[0] = (int32_t)((uint32_t)x[0] - (uint32_t)pr);
        i = 1;
    }
    for (; i + 8 <= n; i += 8) {
        __m256i xv = _mm256_loadu_si256((const __m256i *)(x + i));
        __m256i pv = _mm256_loadu_si256((const __m256i *)(x + i - 1));
        __m256i pr = _mm256_srai_epi32(_mm256_mullo_epi32(pv, cv), 4);
        _mm256_storeu_si256((__m256i *)(y + i), _mm256_sub_epi32(xv, pr));
    }
    for (; i < n; i++) {
        const int32_t pr = (int32_t)(uint32_t)((int64_t)x[i - 1] * c) >> 4;
        y[i] = (int32_t)((uint32_t)x[i] - (uint32_t)pr);
    }
}
#endif

// Batched pre-emphasis filter: y[i] = x[i] - ((x[i-1]*coef) >> 4).
void srla_preemphasis_batch(const int32_t *data, long B, int n,
                            const int32_t *coef, const int32_t *prev,
                            int32_t *out) {
    for (long b = 0; b < B; b++) {
        const int32_t *x = data + (long)b * n;
        int32_t *y = out + (long)b * n;
        const int64_t c = coef[b];
#if defined(SRLA_X86_SIMD)
        if (srla_has_avx2() && n >= 9) {
            preemphasis_row_avx2(x, y, n, (int32_t)c, prev[b]);
            continue;
        }
#endif
        int64_t p = prev[b];
        for (int i = 0; i < n; i++) {
            const int32_t pr = (int32_t)(uint32_t)(p * c) >> 4;
            const int32_t xi = x[i];
            y[i] = (int32_t)((uint32_t)xi - (uint32_t)pr);
            p = xi;
        }
    }
}

namespace {

// Minimal MSB-first bit writer with capacity checking (overflow -> sticky).
// Invariant: nstage <= 7 after every put, so `stage << take` (take <= 56)
// never sheds live bits; byte extraction masks garbage above nstage.
struct ExactWriter {
    uint8_t *buf;
    long cap;       // bytes
    long pos8 = 0;  // full bytes written
    long total_bits = 0;
    uint64_t stage = 0;
    int nstage = 0;
    bool overflow = false;

    void put(uint64_t v, int nbits) {
        if (nbits <= 0 || overflow) return;
        total_bits += nbits;
        while (nbits > 0) {
            const int take = nbits > 56 ? 56 : nbits;
            const uint64_t chunk =
                (v >> (nbits - take)) & (((uint64_t)1 << take) - 1);
            stage = (stage << take) | chunk;
            nstage += take;
            while (nstage >= 8) {
                if (pos8 >= cap) { overflow = true; return; }
                buf[pos8++] = (uint8_t)(stage >> (nstage - 8));
                nstage -= 8;
            }
            nbits -= take;
        }
    }
    void zero_run(int64_t run) {  // run zeros then a terminating 1
        while (run >= 56 && !overflow) { put(0, 56); run -= 56; }
        put(1, (int)run + 1);
    }
    long finish() {  // byte-pad; returns total bits before padding
        if (nstage > 0 && !overflow) {
            if (pos8 >= cap) {
                overflow = true;
            } else {
                const uint8_t pend =
                    (uint8_t)(stage & (((uint64_t)1 << nstage) - 1));
                buf[pos8++] = (uint8_t)(pend << (8 - nstage));
                nstage = 0;
            }
        }
        return overflow ? -1 : total_bits;
    }
};

}  // namespace

namespace {

// Residual section body: code_type + porder + partition parameters +
// plain/recursive Rice codewords (bit-identical to rice.py emit_channel).
void emit_rice_section(ExactWriter &w, const uint32_t *uvals, int n,
                       int code_type, int porder, const int32_t *ks) {
    w.put((uint64_t)code_type, 2);
    if (code_type == 2) return;  // ALLZERO
    w.put((uint64_t)porder, 10);
    const int nparts = 1 << porder;
    const int nsmpl = n >> porder;
    int32_t prevk = 0;
    for (int part = 0; part < nparts && !w.overflow; part++) {
        const int32_t k = ks[part];
        if (part == 0) {
            w.put((uint64_t)k, 5);
        } else {
            w.zero_run((int64_t)zigzag32(k - prevk));
        }
        prevk = k;
        const uint32_t *u = uvals + (long)part * nsmpl;
        if (code_type == 0) {  // plain Rice
            for (int i = 0; i < nsmpl; i++) {
                const uint32_t q = u[i] >> k;
                if (q >= 32) {
                    w.zero_run((int64_t)q);
                    w.put(u[i], k);
                } else {
                    w.put(((uint64_t)1 << k) | (u[i] & (((uint64_t)1 << k) - 1)),
                          (int)q + 1 + k);
                }
            }
        } else {  // recursive Rice
            const int k1 = k + 1;
            const uint64_t k1pow = (uint64_t)1 << k1;
            for (int i = 0; i < nsmpl; i++) {
                if (u[i] < k1pow) {
                    w.put(k1pow | u[i], k1 + 1);
                } else {
                    const uint32_t tmp = u[i] - (uint32_t)k1pow;
                    const uint32_t q = 1 + (tmp >> k);
                    if (q >= 32) {
                        w.zero_run((int64_t)q);
                        w.put(tmp, k);
                    } else {
                        w.put(((uint64_t)1 << k)
                                  | (tmp & (((uint64_t)1 << k) - 1)),
                              (int)q + 1 + k);
                    }
                }
            }
        }
    }
}

}  // namespace

// Emit one channel-block residual section into packed bytes. Returns the bit
// count, or -1 on capacity overflow (caller falls back to the Python path).
long srla_rice_emit(const uint32_t *uvals, int n, int code_type, int porder,
                    const int32_t *ks, uint8_t *out, long cap) {
    ExactWriter w{out, cap};
    emit_rice_section(w, uvals, n, code_type, porder, ks);
    return w.finish();
}

// Emit one whole COMPRESS block payload (bit-identical to the host
// _compress_payload in srla_tpu/encoder.py): stereo method, per-channel
// pre-emphasis fields, LPC params with Huffman-coded coefficients, LTP
// fields, then each channel's residual section. residuals are the raw int32
// values (zigzag happens here). Returns bit count, -1 on capacity overflow
// (raw block is cheaper), -2 if a coefficient falls outside the 256-entry
// Huffman tables (caller uses the Python path).
long srla_emit_payload(
    int C, int bps, int n, int method,
    const int32_t *pre_prev, const int32_t *pre_coef,
    const int32_t *orders, const int32_t *rshifts, const int32_t *use_sum,
    const int32_t *coefs, int maxorder,
    const uint32_t *pcodes, const uint8_t *plens,
    const uint32_t *scodes, const uint8_t *slens,
    int ltp_order, const int32_t *ltp_periods, const int32_t *ltp_coefs,
    const int32_t *residuals, const int32_t *rice_ct, const int32_t *rice_po,
    const int16_t *rice_ks, uint8_t *out, long cap) {
    ExactWriter w{out, cap};
    w.put((uint64_t)method, 2);
    for (int c = 0; c < C; c++) {
        w.put(zigzag32(pre_prev[c]), bps + 1);
        w.put(zigzag32(pre_coef[c]), 5);  // PREEMPHASIS_COEF_SHIFT + 1
    }
    for (int c = 0; c < C; c++) {
        const int o = orders[c];
        w.put((uint64_t)o, 8);            // LPC_COEFFICIENT_ORDER_BITWIDTH
        w.put((uint64_t)rshifts[c], 4);   // RSHIFT_LPC_COEFFICIENT_BITWIDTH
        w.put((uint64_t)(use_sum[c] ? 1 : 0), 1);
        if (o <= 0) continue;
        const int32_t *cf = coefs + (long)c * maxorder;
        const uint32_t uv0 = zigzag32(cf[0]);
        if (uv0 >= 256) return -2;
        if (!use_sum[c]) {
            for (int i = 0; i < o; i++) {
                const uint32_t uv = zigzag32(cf[i]);
                if (uv >= 256) return -2;
                w.put(pcodes[uv], plens[uv]);
            }
        } else {
            w.put(pcodes[uv0], plens[uv0]);
            for (int i = 1; i < o; i++) {
                const int32_t summed =
                    (int32_t)((uint32_t)cf[i] + (uint32_t)cf[i - 1]);
                const uint32_t suv = zigzag32(summed);
                if (suv >= 256) return -2;
                w.put(scodes[suv], slens[suv]);
            }
        }
    }
    for (int c = 0; c < C; c++) {
        const int per = ltp_periods ? ltp_periods[c] : 0;
        w.put(per ? 1 : 0, 1);
        if (per) {
            w.put((uint64_t)((ltp_order - 1) / 2), 1);  // LTP_ORDER_BITWIDTH
            w.put((uint64_t)(per - 8), 8);  // LTP_MIN_PERIOD/PERIOD_BITWIDTH
            const int32_t *lc = ltp_coefs + (long)c * ltp_order;
            for (int i = 0; i < ltp_order; i++)
                w.put(zigzag32(lc[i]), 6);  // LTP_COEFFICIENT_BITWIDTH
        }
    }
    uint32_t *u = new uint32_t[n];
    int32_t ks32[1024];
    for (int c = 0; c < C && !w.overflow; c++) {
        const int32_t *res = residuals + (long)c * n;
        for (int i = 0; i < n; i++) u[i] = zigzag32(res[i]);
        const int16_t *kr = rice_ks + (long)c * 1024;
        const int nparts = 1 << rice_po[c];
        for (int p = 0; p < nparts; p++) ks32[p] = kr[p];
        emit_rice_section(w, u, n, rice_ct[c], rice_po[c], ks32);
    }
    delete[] u;
    return w.finish();
}

uint16_t srla_fletcher16(const uint8_t *data, long size);  // srla_assemble.cpp

// Emit + frame a whole batch of COMPRESS blocks in one call (the per-block
// ctypes marshalling of srla_emit_payload measured ~0.15 s per 1292-block
// host encode — a real slice of the 1.2 s total on this single-core host).
// Layouts: method (B,); per-channel params (B, C); coefs (B, C, maxorder);
// residuals via C per-channel pointers res_ch[c] -> (B, n) int32 (zigzag
// happens here); rice_ks via C pointers ks_ch[c] -> (B, 1024) int16.
// out_sizes[b]: framed bytes at the running offset, 0 = compressed payload
// reached raw size (caller emits a RAW block), -2 = coefficient outside the
// 256-entry Huffman tables (caller uses its Python path). Returns total
// bytes written or -1 if out_cap is too small.
long srla_emit_blocks_batch(
    long B, int C, int bps, int n, int maxorder,
    const int32_t *method,
    const int32_t *pre_prev, const int32_t *pre_coef,
    const int32_t *orders, const int32_t *rshifts, const int32_t *use_sum,
    const int32_t *coefs,
    const uint32_t *pcodes, const uint8_t *plens,
    const uint32_t *scodes, const uint8_t *slens,
    int ltp_order, const int32_t *ltp_periods, const int32_t *ltp_coefs,
    const int32_t *const *res_ch, const int16_t *const *ks_ch,
    const int32_t *rice_ct, const int32_t *rice_po,
    uint8_t *out, long out_cap, long *out_sizes) {
    const long raw_bits = (long)bps * n * C;
    const long blk_cap = raw_bits / 8 + 64;
    uint32_t *u = new uint32_t[n];
    int32_t ks32[1024];
    uint8_t *w8 = out;
    for (long b = 0; b < B; b++) {
        out_sizes[b] = 0;
        if ((w8 - out) + 11 + blk_cap > out_cap) { delete[] u; return -1; }
        uint8_t *blk = w8;
        ExactWriter w{blk + 11, blk_cap};
        w.put((uint64_t)method[b], 2);
        for (int c = 0; c < C; c++) {
            w.put(zigzag32(pre_prev[b * C + c]), bps + 1);
            w.put(zigzag32(pre_coef[b * C + c]), 5);
        }
        bool bad_coef = false;
        for (int c = 0; c < C && !bad_coef; c++) {
            const int o = orders[b * C + c];
            w.put((uint64_t)o, 8);
            w.put((uint64_t)rshifts[b * C + c], 4);
            const int us = o > 0 ? use_sum[b * C + c] : 0;
            w.put((uint64_t)(us ? 1 : 0), 1);
            if (o <= 0) continue;
            const int32_t *cf = coefs + ((long)b * C + c) * maxorder;
            const uint32_t uv0 = zigzag32(cf[0]);
            if (uv0 >= 256) { bad_coef = true; break; }
            if (!us) {
                for (int i = 0; i < o; i++) {
                    const uint32_t uv = zigzag32(cf[i]);
                    if (uv >= 256) { bad_coef = true; break; }
                    w.put(pcodes[uv], plens[uv]);
                }
            } else {
                w.put(pcodes[uv0], plens[uv0]);
                for (int i = 1; i < o; i++) {
                    const int32_t summed =
                        (int32_t)((uint32_t)cf[i] + (uint32_t)cf[i - 1]);
                    const uint32_t suv = zigzag32(summed);
                    if (suv >= 256) { bad_coef = true; break; }
                    w.put(scodes[suv], slens[suv]);
                }
            }
        }
        if (bad_coef) { out_sizes[b] = -2; continue; }
        for (int c = 0; c < C; c++) {
            const int per = ltp_periods ? ltp_periods[b * C + c] : 0;
            w.put(per ? 1 : 0, 1);
            if (per) {
                w.put((uint64_t)((ltp_order - 1) / 2), 1);
                w.put((uint64_t)(per - 8), 8);
                const int32_t *lc =
                    ltp_coefs + ((long)b * C + c) * ltp_order;
                for (int i = 0; i < ltp_order; i++)
                    w.put(zigzag32(lc[i]), 6);
            }
        }
        for (int c = 0; c < C && !w.overflow; c++) {
            const int32_t *res = res_ch[c] + (long)b * n;
            for (int i = 0; i < n; i++) u[i] = zigzag32(res[i]);
            const int16_t *kr = ks_ch[c] + (long)b * 1024;
            const int nparts = 1 << rice_po[b * C + c];
            for (int p = 0; p < nparts; p++) ks32[p] = kr[p];
            emit_rice_section(w, u, n, rice_ct[b * C + c],
                              rice_po[b * C + c], ks32);
        }
        const long bits = w.finish();
        if (bits < 0) continue;                 // overflow: raw is cheaper
        const long payload = (bits + 7) / 8;
        if (8 * payload >= raw_bits) continue;  // raw fallback
        blk[0] = 0xFF; blk[1] = 0xFF;
        const uint32_t size32 = (uint32_t)(payload + 5);
        blk[2] = (uint8_t)(size32 >> 24); blk[3] = (uint8_t)(size32 >> 16);
        blk[4] = (uint8_t)(size32 >> 8); blk[5] = (uint8_t)size32;
        blk[8] = 0;  // COMPRESS
        blk[9] = (uint8_t)(n >> 8); blk[10] = (uint8_t)n;
        const uint16_t ck = srla_fletcher16(blk + 8, payload + 3);
        blk[6] = (uint8_t)(ck >> 8); blk[7] = (uint8_t)ck;
        out_sizes[b] = 11 + payload;
        w8 = blk + 11 + payload;
    }
    delete[] u;
    return (long)(w8 - out);
}

// Batched LPC order selection (BRUTEFORCE_ESTIMATION): the encoder's
// geometric-entropy code-length estimate over orders 1..max_params, exact
// libm chain (parity: encoder.py _geometric_entropy_scalar /_select_order,
// reference srla_encoder.c SRLAEncoder_ComputeCoefficientsPerChannel order
// scan). Plain C log/sqrt IS the scalar repair chain, so no two-phase
// coarse+repair is needed here. error_vars: (B, max_params+1) row-major;
// orders out (B,). Blocks where no order is valid (all NaN/negative) get
// order 1 — matching the Python argmin-over-all-inf fallback.
void srla_select_orders_batch(const double *error_vars, long B,
                              int max_params, int n, int bps,
                              int coef_bitwidth, int32_t *orders) {
    const double INV_LOGE2 = 1.4426950408889634;
    const double half_amp = (double)(1u << (bps - 1));
    const double nd = (double)n;
    for (long b = 0; b < B; b++) {
        const double *ev = error_vars + b * (long)(max_params + 1);
        double minlen = 3.402823466e38;
        int best = 0;
        for (int k = 1; k <= max_params; k++) {
            const double e = ev[k];
            if (!(e >= 0.0)) continue;  // NaN/negative: never selected
            const double mab = 2.0 * sqrt(e / 2.0);
            double ent;
            if (mab < 1e-16) {
                ent = 0.0;
            } else {
                const double intmean = mab * half_amp;
                const double rho = 1.0 / (1.0 + intmean);
                const double invrho = 1.0 - rho;
                ent = -(invrho * (log(invrho) * INV_LOGE2)
                        + rho * (log(rho) * INV_LOGE2)) / rho;
            }
            const double ln = ent * nd + (double)(coef_bitwidth * k);
            if (minlen > ln) {
                minlen = ln;
                best = k;
            }
        }
        orders[b] = best > 0 ? best : 1;
    }
}

// Batched exact bit accounting for one channel variant (parity:
// encoder.py _account_bits, srla_encoder.c:1121-1187). Integer-only: the
// zigzag fold plus the two 256-entry Huffman length LUTs. ltp_bits is the
// LTP side-info cost added when ltp_period > 0; fixed_bits is the
// per-channel constant header cost (computed by the caller from the format
// constants). use_sum out: 1 where the summed-parameter codebook is chosen.
void srla_account_bits_batch(const int64_t *rice_bits, const int32_t *ords,
                             const int32_t *coefs, long B, int M,
                             const int32_t *ltp_period, int64_t ltp_bits,
                             const int64_t *plens, const int64_t *slens,
                             int64_t fixed_bits, int64_t *code_length,
                             uint8_t *use_sum) {
    for (long b = 0; b < B; b++) {
        const int o = ords[b];
        const int32_t *c = coefs + b * (long)M;
        int64_t coef_cost = 0;
        for (int j = 0; j < o; j++) {
            const uint32_t u = (uint32_t)(-(int32_t)(c[j] < 0))
                               ^ ((uint32_t)c[j] << 1);
            coef_cost += plens[u];
        }
        int sum_ok = 1;
        int64_t sum_cost = 0;
        if (o > 0) {
            const uint32_t u0 = (uint32_t)(-(int32_t)(c[0] < 0))
                                ^ ((uint32_t)c[0] << 1);
            sum_cost = plens[u0];
            for (int j = 1; j < o; j++) {
                const int32_t s =
                    (int32_t)((uint32_t)c[j] + (uint32_t)c[j - 1]);
                const uint32_t su = (uint32_t)(-(int32_t)(s < 0))
                                    ^ ((uint32_t)s << 1);
                if (su >= 256) { sum_ok = 0; break; }
                sum_cost += slens[su];
            }
        }
        const int us = (o > 0) && sum_ok
                       && ((o == 1) || (sum_cost < coef_cost));
        const int64_t coef_bits = (o > 0) ? (us ? sum_cost : coef_cost) : 0;
        use_sum[b] = (uint8_t)us;
        code_length[b] = rice_bits[b] + fixed_bits + coef_bits
                         + (ltp_period[b] > 0 ? ltp_bits : 0);
    }
}

}  // extern "C"

extern "C" {
void srla_debug_realfft(double *x, int n, int flag, const double *tw,
                        const double *rot) {
    double *work = new double[n];
    real_fft(n, flag, x, work, tw, rot);
    delete[] work;
}
}

extern "C" {
void srla_debug_cfft(double *x, int n, int flag, const double *tw) {
    double *work = new double[2 * n];
    complex_fft(n, flag, (Cplx *)x, (Cplx *)work, tw);
    delete[] work;
}
}
