// K11: the ridged covariance of each row at its own LPC order, for SVR
// refinement (--svr-filter-learning-iteration).
//
// Replaces the XLA program srla_tpu/kernels/exact.py:_svr_cov (:589, its
// lag-diagonal loop :611 and the prefix sums of _dd_cumsum :585). Its plain
// version, the arithmetic it must equal bit for bit, is
// kernels/svr.py:svr_cov_plain, itself the host's dsp/svr.py:_covariance:
//
//   cov[i][j] = sum_{s < n - o} d[s + i] * d[s + j],  i, j < o,
//
// each element one chain over s in order, the product rounded before its
// add, d = work * 2^-(bps - 1) (exact), then the diagonal multiplied by
// 1 + ridge; zero outside the o x o block. The build passes -fmad=false
// (kernels/build.py), so no multiply-add is contracted.
//
// What bounds it on an H100: the f64 operations. At the main path's group
// (5164 rows x 4096 samples, orders up to 64) a row of order o has o (o +
// 1) / 2 elements of n - o steps, a multiply and an add each: at most ~87
// G f64 instructions (32.8 G at make_music's orders) against the ~17 T/s
// the vector pipe issues (34 TFLOP/s counting a multiply-add as two). The
// bytes (the rows in, the (V, M, M) matrices out) are ~0.2 GB, ~0.06 ms.
//
// Design: a CTA per row stages d in shared memory, as f64 up to 28,000
// samples (224 KB) and as the int32 samples, scaled on read (exact), up to
// 56,000; then each thread takes a 4 x 4 tile of the upper triangle (tile
// rows i0..i0+3, columns j0..j0+3, j0 >= i0) and runs its 16 chains in
// step: per step it reads the two new samples d[s + i0 + 3] and
// d[s + j0 + 3] and shifts the rest along in registers, so a step is 2
// shared loads for 16 products and 16 adds. Each chain is still one
// element's sum in s order; a tile writes its elements and their mirror
// images (a product is the same either way round).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 4;
constexpr int kMaxThreads = 256;
constexpr size_t kSmemMax = 227 * 1024;     // an H100 CTA's shared memory

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

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
svr_cov_kernel(const int32_t* __restrict__ work,
               const int32_t* __restrict__ orders, double* __restrict__ cov,
               int n, int M, double scale, double ridge1) {
    extern __shared__ double smem[];       // n + kTile samples, zero tail
    T* staged = (T*)smem;
    const int row = blockIdx.x;
    const int32_t* src = work + (size_t)row * n;
    for (int s = threadIdx.x; s < n + kTile; s += blockDim.x) {
        if constexpr (sizeof(T) == sizeof(double))
            staged[s] = s < n ? (double)src[s] * scale : 0.0;
        else
            staged[s] = s < n ? src[s] : 0;
    }
    const Row<T> d{staged, scale};
    int o = orders[row];
    o = o < 0 ? 0 : (o > M ? M : o);
    double* out = cov + (size_t)row * M * M;
    // Zero the matrix first: the tiles write only inside the o x o block.
    for (int k = threadIdx.x; k < M * M; k += blockDim.x) out[k] = 0.0;
    __syncthreads();
    const int nt = (o + kTile - 1) / kTile;
    const int tiles = nt * (nt + 1) / 2;
    const int steps = n - o;
    for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
        // Tile t of the upper triangle, row by row: (ti, tj), tj >= ti.
        int ti = 0, rem = t;
        while (rem >= nt - ti) {
            rem -= nt - ti;
            ++ti;
        }
        const int i0 = ti * kTile, j0 = (ti + rem) * kTile;
        double a[kTile], b[kTile], acc[kTile][kTile];
#pragma unroll
        for (int k = 0; k < kTile; ++k) {
            a[k] = d[i0 + k];
            b[k] = d[j0 + k];
#pragma unroll
            for (int l = 0; l < kTile; ++l) acc[k][l] = 0.0;
        }
        for (int s = 0; s < steps; ++s) {
#pragma unroll
            for (int k = 0; k < kTile; ++k)
#pragma unroll
                for (int l = 0; l < kTile; ++l)
                    acc[k][l] = acc[k][l] + a[k] * b[l];
#pragma unroll
            for (int k = 0; k < kTile - 1; ++k) {
                a[k] = a[k + 1];
                b[k] = b[k + 1];
            }
            a[kTile - 1] = d[s + 1 + i0 + kTile - 1];
            b[kTile - 1] = d[s + 1 + j0 + kTile - 1];
        }
#pragma unroll
        for (int k = 0; k < kTile; ++k)
#pragma unroll
            for (int l = 0; l < kTile; ++l) {
                const int i = i0 + k, j = j0 + l;
                if (i >= o || j >= o) continue;
                const double v = i == j ? acc[k][l] * ridge1 : acc[k][l];
                out[i * M + j] = v;
                out[j * M + i] = v;
            }
    }
}

template <typename T>
int launch(const void* work, const void* orders, void* cov, int V, int n,
           int M, double scale, double ridge1, cudaStream_t stream) {
    const size_t bytes = sizeof(T) * (size_t)(n + kTile);
    if (bytes > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            svr_cov_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)bytes);
        if (e != cudaSuccess) return (int)e;
    }
    const int T4 = (M + kTile - 1) / kTile;
    int threads = ((T4 * (T4 + 1) / 2 + 31) / 32) * 32;
    threads = threads > kMaxThreads ? kMaxThreads : threads;
    svr_cov_kernel<T><<<V, threads, bytes, stream>>>(
        (const int32_t*)work, (const int32_t*)orders, (double*)cov, n, M,
        scale, ridge1);
    return (int)cudaGetLastError();
}

}  // namespace

// work (V, n) int32, orders (V,) int32 (clamped to 0..M), cov (V, M, M)
// f64; scale = 2^-(bps - 1), ridge1 = 1 + ridge. n + 4 samples of shared
// memory a CTA: n <= 56,000 (f64 up to 28,000).
extern "C" int srla_svr_cov(const void* work, const void* orders, void* cov,
                            int V, int n, int M, double scale, double ridge1,
                            void* stream) {
    if (V <= 0) return 0;
    if (n < 1 || M < 1 || M > 255
        || sizeof(int32_t) * (size_t)(n + kTile) > kSmemMax)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (sizeof(double) * (size_t)(n + kTile) <= kSmemMax)
        return launch<double>(work, orders, cov, V, n, M, scale, ridge1, s);
    return launch<int32_t>(work, orders, cov, V, n, M, scale, ridge1, s);
}
