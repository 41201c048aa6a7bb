// K17: the bit accounting and the stereo selection of the encode.
//
// Replaces the XLA program of srla_tpu/kernels/exact.py:1317
// _account_bits_dev and encode_blocks_exact:1373-1411 (and the measurement's
// accounting, srla_tpu/encoder.py:2020-2032). Two entries over one body.
//
// For each variant row r (V = nvar * B rows, row v * B + b variant v of
// block b; nvar = C + 2 for C >= 2, else 1), with m = min(order, M) of its
// reversed coefficients c (the row's first M columns):
//
//   coef_cost = sum_{j<m} plen[min(zz(c_j), 255)]
//   sum_cost  = plen[min(zz(c_0), 255)]
//               + sum_{j+1<m} slen[min(zz(c_j + c_(j+1)), 255)]   (int32 wrap)
//   svalid    = every zz(c_j + c_(j+1)) with j + 1 < m below 256
//   use_sum   = order > 0 and svalid and (order == 1 or sum_cost < coef_cost)
//   len       = sec_bits + fixed + (order > 0 ? chosen cost : 0)
//               + (ltp_period > 0 ? ltp_bits : 0)
//   risky     = risky | rice_risky
//
// and for each block b the stereo method (NONE, MS, LS, SR on the lengths
// l2 + l3, l0 + l1, l2 + l1, l3 + l1 for C >= 2; one method for C = 1),
// the first minimum as argmin takes it, bits = ((min + 2 + 7) / 8) * 8,
// raw_blk = bits >= bps * n * C, risky_blk = any risky of its variants,
// and for each of its channels c the chosen variant row, skip = raw_blk or
// risky_blk or its section above W words, lens_w = skip ? 0 : ceil(sec /
// 32). The encode entry also writes starts, the exclusive running sum of
// lens_w over the B * C (block, channel) rows: the CTA that takes the last
// ticket of an atomic counter (zeroed by the entry before the launch) scans
// them once every CTA has written its own. The measurement entry writes
// only bits, risky_blk and the merged row flags.
//
// The Huffman length tables (plen, slen: 256 entries each) are a device
// tensor the wrapper makes once a device; nothing is uploaded per call.
//
// What bounds it on an H100: latency. At the main group (B 1291, V 5164,
// M 64) it reads ~1.4 MB (the coefficients, the rows' fields) and writes
// ~0.1 MB: 0.0004 ms at 3.35 TB/s, under the launch itself.
//
// Design (a simple first kernel): a CTA of four warps a block, a warp a
// variant row: its lanes take the coefficients j = lane, lane + 32, ...,
// look both lengths up (the tables through L1), and meet in shuffles;
// lane 0 writes the row's length and flag to shared memory. Thread 0 then
// takes the block's method and bits, the first C threads the channels'
// rows. The last CTA's scan walks the rows in tiles of the CTA's threads,
// a warp scan and a shared pass a tile.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVariants = 34;        // C <= 32

struct Args {
    const void* sec_bits;               // (V,) int32 or int64
    const int32_t* orders;              // (V,)
    const int32_t* coefs;               // (V, stride), M columns used
    const uint8_t* risky;               // (V,) or null
    const uint8_t* rice_risky;          // (V,) or null
    const int32_t* ltp_period;          // (V,) or null
    const int32_t* tables;              // plen[256], slen[256]
    int stride, M, B, C, n, bps;
    long long W;                        // section words bound
    long long fixed, ltp_bits;
    // outputs
    long long* method;                  // (B,)
    long long* bits;                    // (B,)
    uint8_t* raw_blk;                   // (B,)
    uint8_t* risky_blk;                 // (B,)
    uint8_t* use_sum;                   // (V,)
    uint8_t* risky_out;                 // (V,)
    long long* rows;                    // (B * C,)
    uint8_t* skip;                      // (B * C,)
    long long* lens_w;                  // (B * C,)
    long long* starts;                  // (B * C,)
    unsigned int* ticket;
};

__device__ __forceinline__ uint32_t zz(int32_t x) {
    return ((uint32_t)x << 1) ^ (uint32_t)(x >> 31);
}

template <typename SB>
__device__ __forceinline__ long long sec_at(const Args& a, long long r) {
    return (long long)static_cast<const SB*>(a.sec_bits)[r];
}

template <typename SB, bool kMeasure>
__global__ void __launch_bounds__(kThreads)
select_kernel(Args a) {
    __shared__ long long len_sh[kMaxVariants];
    __shared__ uint8_t risky_sh[kMaxVariants];
    __shared__ long long scan_sh[kWarps];
    __shared__ bool last_sh;
    const int b = blockIdx.x;
    const int B = a.B, C = a.C;
    const int nvar = C >= 2 ? C + 2 : 1;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int32_t* plen = a.tables;
    const int32_t* slen = a.tables + 256;
    for (int v = warp; v < nvar; v += kWarps) {
        const long long r = (long long)v * B + b;
        const int order = a.orders[r];
        const int m = order < 0 ? 0 : (order < a.M ? order : a.M);
        const int32_t* c = a.coefs + r * a.stride;
        int ccost = 0, scost = 0;
        bool svalid = true;
        for (int j = lane; j < m; j += 32) {
            const int32_t cj = c[j];
            const uint32_t z = zz(cj);
            ccost += __ldg(plen + (z < 255u ? z : 255u));
            if (j + 1 < m) {
                const uint32_t zs = zz((int32_t)((uint32_t)c[j + 1]
                                                 + (uint32_t)cj));
                svalid &= zs < 256u;
                scost += __ldg(slen + (zs < 255u ? zs : 255u));
            }
        }
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
            ccost += __shfl_xor_sync(0xffffffffu, ccost, d);
            scost += __shfl_xor_sync(0xffffffffu, scost, d);
        }
        svalid = __all_sync(0xffffffffu, svalid);
        if (lane == 0) {
            bool use = false;
            int coef_bits = 0;
            if (order > 0) {
                const uint32_t z0 = zz(c[0]);
                const int sum_cost = __ldg(plen + (z0 < 255u ? z0 : 255u))
                    + scost;
                use = svalid && (order == 1 || sum_cost < ccost);
                coef_bits = use ? sum_cost : ccost;
            }
            const bool ltp = a.ltp_period != nullptr && a.ltp_period[r] > 0;
            len_sh[v] = sec_at<SB>(a, r) + a.fixed + coef_bits
                + (ltp ? a.ltp_bits : 0);
            const bool rk = (a.risky != nullptr && a.risky[r])
                || (a.rice_risky != nullptr && a.rice_risky[r]);
            risky_sh[v] = (uint8_t)rk;
            a.risky_out[r] = (uint8_t)rk;
            if (!kMeasure) a.use_sum[r] = (uint8_t)use;
        }
    }
    __syncthreads();
    // Every thread takes the block's method (a few registers): the
    // channels' threads need it below.
    int method = 0;
    long long best = len_sh[0];
    if (C >= 2) {
        const long long l[4] = {len_sh[2] + len_sh[3], len_sh[0] + len_sh[1],
                                len_sh[2] + len_sh[1], len_sh[3] + len_sh[1]};
        best = l[0];
#pragma unroll
        for (int k = 1; k < 4; ++k) {
            if (l[k] < best) {
                best = l[k];
                method = k;
            }
        }
    }
    const long long rounded = ((best + 2 + 7) / 8) * 8;
    bool rk = false;
    for (int v = 0; v < nvar; ++v) rk |= risky_sh[v] != 0;
    if (kMeasure) {
        if (threadIdx.x == 0) {
            a.bits[b] = rounded;
            a.risky_blk[b] = (uint8_t)rk;
        }
        return;
    }
    const bool raw = rounded >= (long long)a.bps * a.n * C;
    if (threadIdx.x == 0) {
        a.method[b] = method;
        a.bits[b] = rounded;
        a.raw_blk[b] = (uint8_t)raw;
        a.risky_blk[b] = (uint8_t)rk;
    }
    for (int ch = threadIdx.x; ch < C; ch += kThreads) {
        int vix = 0;
        if (C >= 2) {
            vix = (method == 1 && ch < 2) ? ch
                : (((method == 2 && ch == 1) || (method == 3 && ch == 0))
                   ? 1 : 2 + ch);
        }
        const long long row = (long long)vix * B + b;
        const long long sec = sec_at<SB>(a, row);
        const bool sk = raw || rk || sec > a.W * 32;
        const long long o = (long long)b * C + ch;
        a.rows[o] = row;
        a.skip[o] = (uint8_t)sk;
        a.lens_w[o] = sk ? 0 : (sec + 31) / 32;
    }
    // The running sum of lens_w: the last CTA to finish scans every row.
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        last_sh = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last_sh) return;
    __threadfence();
    const long long K = (long long)B * C;
    long long carry = 0;
    for (long long base = 0; base < K; base += kThreads) {
        const long long i = base + threadIdx.x;
        const long long x = i < K ? __ldcg(a.lens_w + i) : 0;
        long long inc = x;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const long long up = __shfl_up_sync(0xffffffffu, inc, d);
            if (lane >= d) inc += up;
        }
        if (lane == 31) scan_sh[warp] = inc;
        __syncthreads();
        long long before = carry, total = carry;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            if (w < warp) before += scan_sh[w];
            total += scan_sh[w];
        }
        if (i < K) a.starts[i] = before + inc - x;
        carry = total;
        __syncthreads();
    }
}

template <typename SB>
cudaError_t launch(const Args& a, bool measure, cudaStream_t s) {
    if (measure) {
        select_kernel<SB, true><<<a.B, kThreads, 0, s>>>(a);
    } else {
        select_kernel<SB, false><<<a.B, kThreads, 0, s>>>(a);
    }
    return cudaGetLastError();
}

}  // namespace

// sec_bits: (V,) int32 (sec64 0) or int64; orders, ltp_period: (V,)
// int32 (ltp_period may be null: no LTP fields); coefs: (V, stride) int32,
// its first M columns read; risky, rice_risky: (V,) bool or null; tables:
// 512 int32 on the device. Outputs as Args lists them; the measurement
// entry (measure non-zero) writes bits, risky_blk and risky_out only and
// takes null for the others. ticket: one uint32 of device memory, zeroed
// here before the launch.
extern "C" int srla_select(const void* sec_bits, int sec64,
                           const void* orders, const void* coefs, int stride,
                           int M, const void* risky, const void* rice_risky,
                           const void* ltp_period, const void* tables, int B,
                           int C, int n, int bps, long long W,
                           long long fixed, long long ltp_bits, int measure,
                           void* method, void* bits, void* raw_blk,
                           void* risky_blk, void* use_sum, void* risky_out,
                           void* rows, void* skip, void* lens_w, void* starts,
                           void* ticket, void* stream) {
    if (B <= 0 || C <= 0 || C + 2 > kMaxVariants || M < 1 || stride < M)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (!measure) {
        const cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned),
                                                s);
        if (err != cudaSuccess) return (int)err;
    }
    Args a;
    a.sec_bits = sec_bits;
    a.orders = (const int32_t*)orders;
    a.coefs = (const int32_t*)coefs;
    a.risky = (const uint8_t*)risky;
    a.rice_risky = (const uint8_t*)rice_risky;
    a.ltp_period = (const int32_t*)ltp_period;
    a.tables = (const int32_t*)tables;
    a.stride = stride;
    a.M = M;
    a.B = B;
    a.C = C;
    a.n = n;
    a.bps = bps;
    a.W = W;
    a.fixed = fixed;
    a.ltp_bits = ltp_bits;
    a.method = (long long*)method;
    a.bits = (long long*)bits;
    a.raw_blk = (uint8_t*)raw_blk;
    a.risky_blk = (uint8_t*)risky_blk;
    a.use_sum = (uint8_t*)use_sum;
    a.risky_out = (uint8_t*)risky_out;
    a.rows = (long long*)rows;
    a.skip = (uint8_t*)skip;
    a.lens_w = (long long*)lens_w;
    a.starts = (long long*)starts;
    a.ticket = (unsigned int*)ticket;
    return (int)(sec64 ? launch<int64_t>(a, measure != 0, s)
                       : launch<int32_t>(a, measure != 0, s));
}
