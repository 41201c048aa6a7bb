// K16: the variant stack and the exact pre-emphasis of the encode, one
// launch from the samples to the pre-emphasised variant rows.
//
// Replaces the XLA program of srla_tpu/kernels/exact.py:1208-1219 (the
// stack in _variant_analysis) and :83 _preemphasis_exact. Sample s of
// channel c of block b is src[off[b] + c * cstride + s] (int16 or int32):
// the resident (C, N) file at its span offsets (cstride N), or a (B, C, n)
// block tensor at its strides (off[b] = b * bstride; a contiguous one has
// bstride C * n and cstride n), with no copy of the spans first. After
// the offset shift w_c = x_c >> lshift, the variant rows are
// [M, S, w_0, ..., w_(C-1)] for C >= 2 (S = w_1 - w_0, M = w_0 + (S >> 1),
// wrapping int32 as torch's int32 ops wrap) and [w_0] for C = 1; row
// v * B + b is variant v of block b. For each row:
//
//   r0 = sum x[s]^2, r1 = sum x[s] x[s+1]          (64-bit integers)
//   dc16 = (double(r1) / double(r0)) * 16           (r0 = 0: coef 0)
//   coef = clamp(round_half_away(dc16), -16, 15)
//   risky = |frac(|dc16|) - 0.5| < eps and r0 != 0
//   work[s] = x[s] - ((x[s-1] * coef) >> 4)         (x[-1] = x[0])
//
// with pre_prev = x[0]. The sums are exact 64-bit integer sums, wrapping
// as torch's int64 sums wrap, so any order of the adds gives the plain
// version's value; each is converted once with __ll2double_rn, and every
// f64 operation after it is an _rn intrinsic, so no contraction changes a
// rounding. The residual is wrapping int32: the product in uint32_t, then
// an arithmetic shift of its int32 pattern.
//
// What bounds it on an H100: bytes. At the main group (B 1291, C 2, n
// 4096, int16) it reads 21 MB of samples and writes 85 MB of int32 rows:
// 0.032 ms at 3.35 TB/s; a row sample takes a dozen integer instructions
// (0.016 ms at the INT32 rate).
//
// Design: a CTA a block, each sample read from device memory once. The
// block's channels are taken a unit at a time: channels 0 and 1 together
// (their four rows M, S, w_0, w_1 formed in registers from the same two
// loads), then each further channel alone (C = 1: channel 0 alone). A
// thread holds kChunks chunks of four consecutive samples of each of the
// unit's channels, chunk k of a tile at sample 4 (k T + t) for thread t of
// T: a warp reads 8 (int16) or 16 (int32) contiguous bytes a lane with one
// vector load where the channel's row is aligned to them (a scalar path
// where it is not: spans at odd offsets), and writes each row's 16 bytes
// a lane with one vector store where the row is 16-byte aligned. A
// chunk's left neighbour is the previous lane's last sample, by a warp
// shuffle; lane 0 reads it from the cache (the previous warp loaded its
// line). The 2 x (rows) 64-bit sums meet in one transposing warp
// butterfly (the values split across lanes as they halve, nine 64-bit
// shuffles for eight sums) and one shared-memory pass; a thread a row
// takes its coefficient and flag. A tile is T x 4 x kChunks samples (4096
// at T 512): a row that fits one tile stays in registers across the
// reduction and its residual pass reads no device memory; a longer one
// (n 16384, say) sums tile by tile and re-reads the tiles for the
// residual from L2, the last tile first (still in registers). T follows n
// (at most 512, a multiple of 32), so short rows do not idle a CTA.
//
// The f32 entry (srla_preemphasis_f32) is the same kernel for the f32
// approximate encode: it replaces srla_tpu/kernels/encode.py:41
// _preemphasis with analyze_blocks_ex's stack (:429-435). Only the
// coefficient step differs (the F32 template flag):
//
//   r0f = float(r0), r1f = float(r1)               (__ll2float_rn, once)
//   coef = r0f < 1e-6 ? 0
//        : clamp(rint(16 r1f / max(r0f, 1e-30)), -16, 15)   (f32, _rn)
//
// rint rounding half to even as jnp.round does, and no margin flag. JAX
// sums the rows in f32 in XLA's order; here the sums are the exact 64-bit
// ones rounded once to f32 (as K15 takes its partition sums), so any
// order of the adds gives the plain version's value, and an int64 sum
// above 2^53 (24-bit rows of 16384 samples) is not rounded twice through
// f64.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kChunks = 2;               // chunks of 4 samples a thread a tile
constexpr unsigned kFull = 0xffffffffu;

struct Args {
    const void* src;
    const long long* off;                // (B,) or null: off[b] = b * bstride
    long long bstride, cstride;
    int B, C, n, lshift, shift;
    double eps;
    int32_t* work;                       // (V, n)
    int32_t* coef;                       // (V,)
    uint8_t* risky;                      // (V,)
    int32_t* prev;                       // (V,)
};

template <typename T>
__device__ __forceinline__ int32_t load_one(const T* __restrict__ row, int s,
                                            int lshift) {
    return (int32_t)__ldg(row + s) >> lshift;
}

// Samples s..s+3 of a channel row after the offset shift; those at or
// past n are 0 (they then add nothing to the sums and are not stored).
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ row,
                                           bool vec, int s, int n,
                                           int lshift, int32_t (&x)[4]) {
    if (vec && s + 4 <= n) {
        if constexpr (sizeof(T) == 2) {
            const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + s));
            x[0] = (int32_t)(int16_t)(v.x & 0xffffu);
            x[1] = (int32_t)(int16_t)(v.x >> 16);
            x[2] = (int32_t)(int16_t)(v.y & 0xffffu);
            x[3] = (int32_t)(int16_t)(v.y >> 16);
        } else {
            const int4 v = __ldg(reinterpret_cast<const int4*>(row + s));
            x[0] = v.x;
            x[1] = v.y;
            x[2] = v.z;
            x[3] = v.w;
        }
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            x[k] = s + k < n ? (int32_t)__ldg(row + s + k) : 0;
        }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] >>= lshift;
}

// The unit's rows from its channels' samples: [M, S, w_0, w_1] for a pair,
// [w_c] for one channel.
template <int NCH>
struct Rows {
    static constexpr int kRows = NCH == 2 ? 4 : 1;
    __device__ __forceinline__ static void form(const int32_t (&w)[NCH],
                                                int32_t (&x)[kRows]) {
        if constexpr (NCH == 2) {
            const int32_t d = (int32_t)((uint32_t)w[1] - (uint32_t)w[0]);
            x[0] = (int32_t)((uint32_t)w[0] + (uint32_t)(d >> 1));
            x[1] = d;
            x[2] = w[0];
            x[3] = w[1];
        } else {
            x[0] = w[0];
        }
    }
};

// Each lane's N 64-bit values summed over the warp, transposed: lane l
// returns the warp's sum of value l / (32 / N) (N a power of two <= 32).
// The values halve at each of the first log2 N steps (a lane keeps one
// half and sends the other), then the last sum is finished alone.
template <int N>
__device__ __forceinline__ unsigned long long warp_transpose_sum(
        unsigned long long (&v)[N], int lane) {
#pragma unroll
    for (int h = N / 2; h >= 1; h >>= 1) {
        const int d = 32 * h / N;        // 16 at the first step
        const bool up = (lane & d) != 0;
#pragma unroll
        for (int i = 0; i < h; ++i) {
            const unsigned long long send = up ? v[i] : v[i + h];
            const unsigned long long keep = up ? v[i + h] : v[i];
            v[i] = keep + __shfl_xor_sync(kFull, send, d);
        }
    }
    unsigned long long s = v[0];
#pragma unroll
    for (int d = 16 / N; d > 0; d >>= 1) s += __shfl_xor_sync(kFull, s, d);
    return s;
}

// The f32 entry's coefficient of one row from its exact sums (the plain
// version's f32 arithmetic, every operation an _rn intrinsic).
__device__ __forceinline__ int32_t coefficient_f32(long long r0i,
                                                   long long r1i, int shift) {
    const float r0 = __ll2float_rn(r0i);
    if (r0 < 1e-6f) return 0;
    const float lim = (float)(1 << shift);
    const float q = rintf(__fdiv_rn(__fmul_rn(lim, __ll2float_rn(r1i)),
                                    fmaxf(r0, 1e-30f)));
    return (int32_t)fminf(fmaxf(q, -lim), lim - 1.0f);
}

// The coefficient and flag of one row from its exact sums (the plain
// version's f64 arithmetic, every operation an _rn intrinsic).
__device__ __forceinline__ int32_t coefficient(long long r0i, long long r1i,
                                               int shift, double eps,
                                               bool* risky) {
    const bool zero = r0i == 0;
    const double d0 = zero ? 1.0 : __ll2double_rn(r0i);
    const double dc16 = __dmul_rn(__ddiv_rn(__ll2double_rn(r1i), d0),
                                  (double)(1 << shift));
    const double ax = fabs(dc16);
    const double r = floor(__dadd_rn(ax, 0.5));
    double q = dc16 < 0.0 ? -r : r;
    const double lim = (double)(1 << shift);
    q = q < -lim ? -lim : (q > lim - 1.0 ? lim - 1.0 : q);
    const double dist = fabs(__dsub_rn(__dsub_rn(ax, floor(ax)), 0.5));
    *risky = dist < eps && !zero;
    return zero ? 0 : (int32_t)q;
}

// One tile of the unit's channels: the chunks of this thread and each
// chunk's left neighbour (0 before sample 0).
template <typename T, int NCH>
__device__ __forceinline__ void load_tile(const T* const (&row)[NCH],
                                          const bool (&vec)[NCH], int t0,
                                          int n, int lshift, int lane,
                                          int32_t (&w)[NCH][kChunks][4],
                                          int32_t (&p)[NCH][kChunks]) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
        const int s = t0 + (j * (int)blockDim.x + (int)threadIdx.x) * 4;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
            load_chunk(row[c], vec[c], s, n, lshift, w[c][j]);
            int32_t q = __shfl_up_sync(kFull, w[c][j][3], 1);
            if (lane == 0) q = s > 0 && s < n ? load_one(row[c], s - 1, lshift)
                                              : 0;
            p[c][j] = q;
        }
    }
}

// One unit (a pair of channels, or one) of block b: sums, coefficients,
// residual rows. row0: the row of the unit's first variant (its next
// variants' rows are B apart). F32: the f32 entry's coefficient, no flag.
template <typename T, int NCH, bool F32>
__device__ __forceinline__ void unit(const Args& a, const T* const (&row)[NCH],
                                     long long row0,
                                     unsigned long long (*part)[8],
                                     int32_t* coef_sh) {
    using R = Rows<NCH>;
    constexpr int NV = R::kRows;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n = a.n;
    const int tile = (int)blockDim.x * 4 * kChunks;
    const int tiles = (n + tile - 1) / tile;
    bool vec[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
        vec[c] = (reinterpret_cast<uintptr_t>(row[c]) & (4 * sizeof(T) - 1))
            == 0;
    }
    int32_t w[NCH][kChunks][4], p[NCH][kChunks];
    unsigned long long acc[2 * NV];
#pragma unroll
    for (int i = 0; i < 2 * NV; ++i) acc[i] = 0;
    for (int t = 0; t < tiles; ++t) {
        load_tile(row, vec, t * tile, n, a.lshift, lane, w, p);
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                int32_t cw[NCH], pw[NCH];
#pragma unroll
                for (int c = 0; c < NCH; ++c) {
                    cw[c] = w[c][j][k];
                    pw[c] = k ? w[c][j][k - 1] : p[c][j];
                }
                int32_t x[NV], y[NV];
                R::form(cw, x);
                R::form(pw, y);
#pragma unroll
                for (int v = 0; v < NV; ++v) {
                    acc[2 * v] += (unsigned long long)((long long)x[v] * x[v]);
                    acc[2 * v + 1] +=
                        (unsigned long long)((long long)y[v] * x[v]);
                }
            }
        }
        if (t == 0 && threadIdx.x == 0) {
            int32_t cw[NCH], x[NV];
#pragma unroll
            for (int c = 0; c < NCH; ++c) cw[c] = w[c][0][0];
            R::form(cw, x);
#pragma unroll
            for (int v = 0; v < NV; ++v) a.prev[row0 + (long long)v * a.B] = x[v];
        }
    }
    const unsigned long long s = warp_transpose_sum<2 * NV>(acc, lane);
    if (lane % (32 / (2 * NV)) == 0) part[warp][lane / (32 / (2 * NV))] = s;
    __syncthreads();
    if (threadIdx.x < NV) {
        const int v = threadIdx.x;
        unsigned long long r0 = 0, r1 = 0;
        const int nw = blockDim.x >> 5;
        for (int i = 0; i < nw; ++i) {
            r0 += part[i][2 * v];
            r1 += part[i][2 * v + 1];
        }
        const long long r = row0 + (long long)v * a.B;
        int32_t cf;
        if constexpr (F32) {
            cf = coefficient_f32((long long)r0, (long long)r1, a.shift);
        } else {
            bool rk;
            cf = coefficient((long long)r0, (long long)r1, a.shift, a.eps,
                             &rk);
            a.risky[r] = (uint8_t)rk;
        }
        a.coef[r] = cf;
        coef_sh[v] = cf;
    }
    __syncthreads();
    uint32_t cf[NV];
    int32_t* out[NV];
    bool vout[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
        cf[v] = (uint32_t)coef_sh[v];
        const long long r = row0 + (long long)v * a.B;
        out[v] = a.work + r * n;
        vout[v] = ((r * n) & 3) == 0;
    }
    // The last tile first: it is still in registers.
    for (int t = tiles - 1; t >= 0; --t) {
        if (t != tiles - 1) load_tile(row, vec, t * tile, n, a.lshift, lane, w,
                                      p);
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
            const int s = t * tile + (j * (int)blockDim.x + (int)threadIdx.x)
                * 4;
            if (s >= n) continue;
            int32_t res[NV][4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                int32_t cw[NCH], pw[NCH];
#pragma unroll
                for (int c = 0; c < NCH; ++c) {
                    cw[c] = w[c][j][k];
                    pw[c] = k ? w[c][j][k - 1] : (s == 0 ? cw[c] : p[c][j]);
                }
                int32_t x[NV], y[NV];
                R::form(cw, x);
                R::form(pw, y);
#pragma unroll
                for (int v = 0; v < NV; ++v) {
                    const int32_t pred = (int32_t)((uint32_t)y[v] * cf[v])
                        >> a.shift;
                    res[v][k] = (int32_t)((uint32_t)x[v] - (uint32_t)pred);
                }
            }
#pragma unroll
            for (int v = 0; v < NV; ++v) {
                if (vout[v] && s + 4 <= n) {
                    *reinterpret_cast<int4*>(out[v] + s) =
                        make_int4(res[v][0], res[v][1], res[v][2], res[v][3]);
                } else {
#pragma unroll
                    for (int k = 0; k < 4; ++k) {
                        if (s + k < n) out[v][s + k] = res[v][k];
                    }
                }
            }
        }
    }
}

template <typename T, bool F32>
__global__ void __launch_bounds__(kMaxThreads, 2)
preemphasis_kernel(Args a) {
    __shared__ unsigned long long part[kMaxWarps][8];
    __shared__ int32_t coef_sh[4];
    const int b = blockIdx.x;
    const T* base = static_cast<const T*>(a.src)
        + (a.off != nullptr ? a.off[b] : (long long)b * a.bstride);
    if (a.C == 1) {
        const T* const row[1] = {base};
        unit<T, 1, F32>(a, row, b, part, coef_sh);
        return;
    }
    {
        const T* const row[2] = {base, base + a.cstride};
        unit<T, 2, F32>(a, row, b, part, coef_sh);
    }
    for (int c = 2; c < a.C; ++c) {
        __syncthreads();                 // part and coef_sh are reused
        const T* const row[1] = {base + c * a.cstride};
        unit<T, 1, F32>(a, row, (long long)(c + 2) * a.B + b, part,
                        coef_sh);
    }
}

template <bool F32>
int launch(const void* src, const void* off, long long bstride,
           long long cstride, int B, int C, int n, int lshift, int shift,
           double eps, int src32, void* work, void* coef, void* risky,
           void* prev, void* stream) {
    if (B <= 0 || C <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
    const long long rows = (long long)(C >= 2 ? C + 2 : 1) * B;
    if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    Args a;
    a.src = src;
    a.off = (const long long*)off;
    a.bstride = bstride;
    a.cstride = cstride;
    a.B = B;
    a.C = C;
    a.n = n;
    a.lshift = lshift;
    a.shift = shift;
    a.eps = eps;
    a.work = (int32_t*)work;
    a.coef = (int32_t*)coef;
    a.risky = (uint8_t*)risky;
    a.prev = (int32_t*)prev;
    // Threads: enough for one tile of n samples, a multiple of 32, at
    // most kMaxThreads.
    const int per = 4 * kChunks;
    int threads = (int)(((long long)n + per - 1) / per);
    threads = ((threads + 31) / 32) * 32;
    threads = threads > kMaxThreads ? kMaxThreads : threads;
    cudaStream_t s = (cudaStream_t)stream;
    if (src32) {
        preemphasis_kernel<int32_t, F32><<<B, threads, 0, s>>>(a);
    } else {
        preemphasis_kernel<int16_t, F32><<<B, threads, 0, s>>>(a);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// src: int16 (src32 0) or int32 (src32 non-zero) samples; off: (B,) int64
// offsets of each block's channel 0, or null for off[b] = b * bstride;
// cstride: the distance between a block's channels. Outputs for the V =
// (C >= 2 ? C + 2 : 1) * B rows: work (V, n) int32, coef (V,) int32, risky
// (V,) bool, prev (V,) int32.
extern "C" int srla_preemphasis(const void* src, const void* off,
                                long long bstride, long long cstride, int B,
                                int C, int n, int lshift, int shift,
                                double eps, int src32, void* work, void* coef,
                                void* risky, void* prev, void* stream) {
    return launch<false>(src, off, bstride, cstride, B, C, n, lshift, shift,
                         eps, src32, work, coef, risky, prev, stream);
}

// The f32 entry: the same layout and outputs, the coefficient by the f32
// rule and no flag.
extern "C" int srla_preemphasis_f32(const void* src, const void* off,
                                    long long bstride, long long cstride,
                                    int B, int C, int n, int lshift,
                                    int shift, int src32, void* work,
                                    void* coef, void* prev, void* stream) {
    return launch<true>(src, off, bstride, cstride, B, C, n, lshift, shift,
                        0.0, src32, work, coef, nullptr, prev, stream);
}
