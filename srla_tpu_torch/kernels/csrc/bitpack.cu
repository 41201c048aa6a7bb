// K5: the bit pack of the encode, two kernels.
//
// pack_sections_kernel takes the chosen residual sections from zigzag
// residuals to packed words in one step: the job of
// srla_tpu/kernels/bitpack.py pack_residual_sections (residual_codewords,
// then a row-wise pack: what the Pallas TPU kernel
// srla_tpu/kernels/pallas_pack.py pallas_pack_rows was written for). It is
// the kernel on the encode's path, where it takes the chosen rows by index
// (K17's rows) from the (V, n) int32 residual of every variant row and
// zigzags them as it loads: no zigzag pass over the V rows and no gather
// of the chosen ones before it. bitpack_kernel is the generic pack of a
// ready codeword stream, the twin of pallas_pack_rows and of the XLA packers
// pack_flat_stream and pack_monotone_stream; it is off the encode's path and
// kept for callers that hold a stream.
//
// The stream, most significant bit first: every entry e with tbits[e] > 0
// puts the low tbits bits of tails[e] at absolute bit offset offs[e]:
//
//   w0 = off >> 5, sh = off & 31, over = max(tbits - (32 - sh), 0),
//   keep = tbits - over
//   word w0     |= (tail >> over) << (32 - sh - keep)      (if keep > 0)
//   word w0 + 1 |= tail << (32 - over)                      (if over > 0)
//
// A section (libs/srla_coder/src/srla_coder.c:486-595): 2 bits of code type
// and, unless the type is ALLZERO (2, nothing more follows), 10 bits of
// partition order; then per partition its parameter (5 bits of k for
// partition 0, after that the zigzag of the difference to the previous k in
// unary) followed by its n >> porder samples. A sample u at parameter k is
// plain Rice (u >> k zeros, a one, the low k bits) or, in a recursive row
// (type 1), k + 2 bits of 2^(k+1) | u when u < 2^(k+1), else 1 +
// ((u - 2^(k+1)) >> k) zeros, a one, k bits. 2^(k+1) is 0 at k = 31 and all
// arithmetic is unsigned, as in the plain version.
//
// What bounds pack_sections_kernel on an H100: it reads the chosen rows'
// residuals once (2582 x 4096 x 4 bytes at the main path) and writes ~15 MB
// of words: memory traffic, ~0.02 ms, against about two dozen integer
// instructions a sample over two walks. Design: a CTA owns a row. Rows start
// word-aligned, so no two CTAs share an output word: no global atomic, and
// no zeroed output for the words a row owns. A thread takes kRun consecutive
// samples in registers (128-bit loads), walks them once to count its bits,
// gets its bit offset from one block-wide exclusive scan (warp shuffles and
// one shared pass), and walks them again to place each codeword: shifted
// into a 64-bit pair of words and ORed into the row's shared-memory image
// by one shared atomicOr, and a second where it straddles a word (the image
// is zeroed first, so words inside a long unary lead are never touched).
// The walk is branch-free where a thread's run lies inside one partition
// (n >> porder a multiple of kRun: every order up to 8 at n = 4096), with
// the parameter's masks hoisted; finer partitions take a walk that tracks
// the partition per sample. Assembling whole words in registers and storing
// only a thread's first and last word atomically was measured first and
// dropped: the "does this codeword leave the word" branches diverge in
// every warp and cost more than the atomics they save. The CTA then copies
// lens_w[row] words to out[starts[row]:], coalesced. A row longer than
// kRowThreads * kRun samples takes several rounds with the bit offset
// carried over. Positions at or beyond the image are dropped, so a row
// whose lens_w is too small for its bits loses its end but writes nowhere
// else.
//
// bitpack_kernel, the generic pack. Words at or beyond cap_w are dropped,
// as both JAX packers drop them; an entry at a negative offset is dropped
// too. Shift counts >= 32 give 0, as XLA's shifts do (a width above 65
// acts as 65). Bit ranges of distinct entries are disjoint in a valid
// stream, so the OR equals the JAX packers' sum and the result does not
// depend on the order of the atomics. The TPU's grouped windows, frame
// overflow and prefix sums were workarounds for missing scatter; neither
// kernel has a frame limit, so nothing overflows.
//
// What bounds the generic pack on an H100: its bytes, each entry's offset
// (int64), tail and width (int32 or int64, as the caller holds them) read
// once and the cap_w words written once: 2582 x 5122 slots of int64 and 6.7
// M words, 344 MB, ~0.10 ms. Design: the kernel reads the caller's tensors
// as they are (a template over int32 and int64 tails and widths; the tail
// is the low 32 bits of either), so the wrapper runs no conversion pass on
// contiguous int32 or int64 inputs, and zeroes the words (one memset) for
// the ORs. A thread takes kPackRuns entries, 32 apart, so that each load
// instruction of a warp reads 32 consecutive entries (256 contiguous bytes
// of int64) and a step of the warp holds 32 consecutive entries, one a
// lane. Each entry gives at most two contributions, A to its first word
// and B to the next. Contributions to the same word are merged in the warp
// before any atomic: an entry's B joins the next lane's A when that is the
// same word, then a segmented inclusive OR-scan over the lanes (five
// shuffle steps, each taking the value of the lane d below only where its
// word is the same) leaves on the last lane of every run of equal words
// the OR of the run, and that lane alone issues the atomicOr. A sorted
// stream, such as a row's codewords, has its words in runs: one atomic a
// word that the warp's entries touch (about five codewords a word at the
// encode's sizes, against up to two atomics an entry before). In any other
// order every contribution still reaches an atomic to its own word (a run
// is then short, and OR is idempotent), so the result does not depend on
// the order: no fast path or sortedness test is needed. A contribution of
// value 0 issues nothing. Words are 32-bit keys, so cap_w < 2^32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPackThreads = 256;
constexpr int kPackRuns = 4;               // entries a thread, 32 apart
constexpr uint32_t kAllLanes = 0xffffffffu;
constexpr uint32_t kNoWord = 0xffffffffu;  // no contribution

__device__ __forceinline__ uint32_t shl(uint32_t x, int k) {
    return (k < 0 || k >= 32) ? 0u : x << k;
}

__device__ __forceinline__ uint32_t shr(uint32_t x, int k) {
    return (k < 0 || k >= 32) ? 0u : x >> k;
}

template <typename TT, typename TB>
__global__ void __launch_bounds__(kPackThreads)
bitpack_kernel(const int64_t* __restrict__ offs,
               const TT* __restrict__ tails, const TB* __restrict__ tbits,
               uint32_t* __restrict__ out, long long count, long long cap_w) {
    const int lane = threadIdx.x & 31;
    // The warp's entries: kPackRuns steps of 32 consecutive ones.
    const long long base = ((long long)blockIdx.x * kPackThreads
                            + (threadIdx.x & ~31)) * kPackRuns;
    long long off[kPackRuns], tb[kPackRuns];
    uint32_t tail[kPackRuns];
#pragma unroll
    for (int j = 0; j < kPackRuns; ++j) {
        const long long e = base + 32 * j + lane;
        const bool in = e < count;
        off[j] = in ? offs[e] : -1;
        tail[j] = in ? (uint32_t)tails[e] : 0u;
        tb[j] = in ? (long long)tbits[e] : 0;
    }
    const long long limit = cap_w * 32;
#pragma unroll
    for (int j = 0; j < kPackRuns; ++j) {
        uint32_t ka = kNoWord, kb = kNoWord, va = 0u, vb = 0u;
        if (tb[j] > 0 && off[j] >= 0 && off[j] < limit) {
            const int width = (int)min(tb[j], 65LL);
            const uint32_t w0 = (uint32_t)(off[j] >> 5);
            const int sh = (int)(off[j] & 31);
            int over = width - (32 - sh);
            if (over < 0) over = 0;
            const int keep = width - over;
            va = keep > 0 ? shl(shr(tail[j], over), 32 - sh - keep) : 0u;
            vb = over > 0 && (long long)w0 + 1 < cap_w
                ? shl(tail[j], 32 - over) : 0u;
            ka = va != 0u ? w0 : kNoWord;
            kb = vb != 0u ? w0 + 1 : kNoWord;
        }
        // B to the next lane's A where both are the same word.
        const uint32_t ka_next = __shfl_down_sync(kAllLanes, ka, 1);
        const uint32_t kb_prev = __shfl_up_sync(kAllLanes, kb, 1);
        const uint32_t vb_prev = __shfl_up_sync(kAllLanes, vb, 1);
        const bool b_given = lane < 31 && kb != kNoWord && kb == ka_next;
        if (lane > 0 && ka != kNoWord && kb_prev == ka) va |= vb_prev;
        // The segmented OR-scan over runs of equal words.
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const uint32_t k_up = __shfl_up_sync(kAllLanes, ka, d);
            const uint32_t v_up = __shfl_up_sync(kAllLanes, va, d);
            if (lane >= d && k_up == ka) va |= v_up;
        }
        if (ka != kNoWord && (lane == 31 || ka_next != ka))
            atomicOr(&out[ka], va);
        if (kb != kNoWord && !b_given) atomicOr(&out[kb], vb);
    }
}

template <typename TT, typename TB>
int launch_pack(const void* offs, const void* tails, const void* tbits,
                void* out, long long count, long long cap_w,
                cudaStream_t stream) {
    const long long per_block = (long long)kPackThreads * kPackRuns;
    const long long blocks = (count + per_block - 1) / per_block;
    bitpack_kernel<TT, TB><<<(unsigned)blocks, kPackThreads, 0, stream>>>(
        (const int64_t*)offs, (const TT*)tails, (const TB*)tbits,
        (uint32_t*)out, count, cap_w);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Residual sections: codewords and pack fused, a CTA per row
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRun = 16;                   // samples a thread and round
constexpr uint32_t kMaxLead = 1u << 24;    // beyond any image: see below

// Counts the bits of a thread's codewords.
struct BitCounter {
    uint32_t bits = 0;
    __device__ __forceinline__ void put(uint32_t lead, uint32_t, uint32_t nb) {
        bits += lead + nb;
    }
};

// Places a thread's codewords, which are contiguous in the bit stream from
// bit `pos` on, into the row image.
struct BitWriter {
    uint32_t* img;
    uint32_t limit;        // words of the image this row may write
    uint32_t pos;

    __device__ __forceinline__ BitWriter(uint32_t* image, uint32_t words,
                                         uint32_t start)
        : img(image), limit(words), pos(start) {}

    // nb in 1..32 bits of tail behind `lead` zeros: the codeword's bits as
    // the two words they fall into, most significant bit first.
    __device__ __forceinline__ void put(uint32_t lead, uint32_t tail,
                                        uint32_t nb) {
        pos += lead;
        const uint32_t w0 = pos >> 5;
        const uint64_t v = (uint64_t)tail << (64 - (pos & 31) - nb);
        const uint32_t hi = (uint32_t)(v >> 32), lo = (uint32_t)v;
        if (w0 < limit) atomicOr(&img[w0], hi);
        if (lo != 0 && w0 + 1 < limit) atomicOr(&img[w0 + 1], lo);
        pos += nb;
    }
};

// The codewords of `live` samples u[0..live) that start at sample `rem` of
// partition `part`, in stream order: a partition's parameter before its
// first sample. nb is never 0 and a tail has no bit above its nb.
template <bool kFull, typename Sink>
__device__ __forceinline__ void walk_run(const uint32_t (&u)[kRun], int live,
                                         uint32_t part, uint32_t rem,
                                         uint32_t nsmpl, const uint32_t* ks,
                                         bool recursive, Sink& sink) {
    uint32_t k = ks[part];
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
        if (kFull || j < live) {
            if (rem == 0) {
                k = ks[part];
                if (part == 0) {
                    sink.put(0, k, 5);
                } else {
                    const int32_t d = (int32_t)k - (int32_t)ks[part - 1];
                    sink.put(((uint32_t)d << 1) ^ (uint32_t)(d >> 31), 1, 1);
                }
            }
            const uint32_t x = u[j];
            const uint32_t one_k = 1u << k;
            uint32_t lead = x >> k;
            uint32_t tail = one_k | (x & (one_k - 1));
            uint32_t nb = k + 1;
            if (recursive) {
                const uint32_t k1pow = k < 31 ? one_k << 1 : 0u;
                const uint32_t tmp = x - k1pow;
                const bool small = x < k1pow;
                lead = small ? 0u : 1u + (tmp >> k);
                tail = small ? (k1pow | x) : (one_k | (tmp & (one_k - 1)));
                nb = small ? k + 2 : k + 1;
            }
            // A lead this long lies beyond every image (at most 2^21 bits);
            // the cap keeps the 32-bit positions from wrapping.
            sink.put(min(lead, kMaxLead), tail, nb);
            if (++rem == nsmpl) {
                rem = 0;
                ++part;
            }
        }
    }
}

// The same for a full run that lies inside partition `part` (`starts`: at
// its first sample): one parameter, its masks hoisted, no tracking.
template <typename Sink>
__device__ __forceinline__ void walk_one(const uint32_t (&u)[kRun],
                                         uint32_t part, bool starts,
                                         const uint32_t* ks, bool recursive,
                                         Sink& sink) {
    const uint32_t k = ks[part];
    if (starts) {
        if (part == 0) {
            sink.put(0, k, 5);
        } else {
            const int32_t d = (int32_t)k - (int32_t)ks[part - 1];
            sink.put(((uint32_t)d << 1) ^ (uint32_t)(d >> 31), 1, 1);
        }
    }
    const uint32_t one_k = 1u << k, mask = one_k - 1;
    const uint32_t k1pow = k < 31 ? one_k << 1 : 0u;
    if (recursive) {
#pragma unroll
        for (int j = 0; j < kRun; ++j) {
            const uint32_t x = u[j];
            const uint32_t tmp = x - k1pow;
            const bool small = x < k1pow;
            const uint32_t lead = small ? 0u : 1u + (tmp >> k);
            const uint32_t tail = small ? (k1pow | x)
                                        : (one_k | (tmp & mask));
            sink.put(min(lead, kMaxLead), tail, small ? k + 2 : k + 1);
        }
    } else {
#pragma unroll
        for (int j = 0; j < kRun; ++j) {
            const uint32_t x = u[j];
            sink.put(min(x >> k, kMaxLead), one_k | (x & mask), k + 1);
        }
    }
}

// Exclusive sum of v over the CTA's threads in thread order, and the total.
__device__ __forceinline__ uint32_t block_exclusive_sum(uint32_t v,
                                                        uint32_t* warp_sums,
                                                        uint32_t* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    uint32_t inc = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const uint32_t up = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += up;
    }
    if (lane == 31) warp_sums[warp] = inc;
    __syncthreads();
    uint32_t before = 0, all = 0;
#pragma unroll
    for (int i = 0; i < kRowWarps; ++i) {
        const uint32_t s = warp_sums[i];
        if (i < warp) before += s;
        all += s;
    }
    __syncthreads();               // warp_sums is free for the next round
    *total = all;
    return before + inc - v;
}

// The zigzag code of a residual's 32-bit pattern.
__device__ __forceinline__ uint32_t zigzag32(uint32_t v) {
    return (v << 1) ^ (uint32_t)((int32_t)v >> 31);
}

// kRows: output row r takes residual row rows[r] of the (V, n) residual
// (and its code type, order and parameters) and zigzags as it loads;
// otherwise row r of u holds the zigzag codes of output row r.
template <bool kRows>
__global__ void __launch_bounds__(kRowThreads, 8)
pack_sections_kernel(const uint32_t* __restrict__ u,
                     const long long* __restrict__ code_type,
                     const long long* __restrict__ porder,
                     const long long* __restrict__ ks,
                     const long long* __restrict__ rows,
                     const long long* __restrict__ starts,
                     const long long* __restrict__ lens_w,
                     uint32_t* __restrict__ out, int n, int maxp,
                     int image_words, long long cap_w, long long V) {
    extern __shared__ uint32_t smem[];
    __shared__ uint32_t warp_sums[kRowWarps];
    uint32_t* img = smem;                      // image_words
    uint32_t* ksh = smem + image_words;        // maxp parameters, 0..31
    const long long orow = blockIdx.x;
    const long long lw64 = lens_w[orow];
    if (lw64 <= 0) return;                     // a row that is not packed
    const long long row = kRows ? rows[orow] : orow;
    if (row < 0 || row >= V) return;           // no such residual row
    const uint32_t lw = (uint32_t)(lw64 < image_words ? lw64 : image_words);
    const int t = threadIdx.x;
    const uint32_t ct = (uint32_t)code_type[row] & 3u;
    const long long po64 = porder[row];
    const int po = po64 < 0 ? 0 : (po64 > 30 ? 30 : (int)po64);
    const uint32_t nsmpl = (uint32_t)n >> po;
    uint32_t nparts = nsmpl == 0 ? 0u : 1u << po;
    if (nparts > (uint32_t)maxp) nparts = (uint32_t)maxp;
    const uint32_t n_emit = nsmpl * nparts;    // == n in a valid row
    for (uint32_t i = t; i < lw; i += kRowThreads) img[i] = 0;
    for (uint32_t i = t; i < nparts; i += kRowThreads) {
        ksh[i] = (uint32_t)ks[row * maxp + i] & 31u;
    }
    __syncthreads();
    if (ct == 2u) {
        if (t == 0) img[0] = ct << 30;         // ALLZERO: the type alone
    } else {
        const uint32_t cap_bits = lw * 32u;
        const bool recursive = ct == 1u;
        const uint32_t* urow = u + row * n;
        const bool aligned = (reinterpret_cast<uintptr_t>(urow) & 15) == 0;
        uint32_t base = 0;
        for (uint32_t r0 = 0; r0 < n_emit || r0 == 0;
             r0 += kRowThreads * kRun) {
            const uint32_t s0 = r0 + kRun * t;
            const int live = s0 >= n_emit ? 0
                : (n_emit - s0 < (uint32_t)kRun ? (int)(n_emit - s0) : kRun);
            uint32_t x[kRun];
            if (live == kRun && aligned) {
#pragma unroll
                for (int j = 0; j < kRun; j += 4) {
                    const uint4 v =
                        *reinterpret_cast<const uint4*>(urow + s0 + j);
                    x[j] = v.x; x[j + 1] = v.y; x[j + 2] = v.z;
                    x[j + 3] = v.w;
                }
            } else {
#pragma unroll
                for (int j = 0; j < kRun; ++j) {
                    x[j] = j < live ? urow[s0 + j] : 0u;
                }
            }
            if (kRows) {
#pragma unroll
                for (int j = 0; j < kRun; ++j) x[j] = zigzag32(x[j]);
            }
            uint32_t part = 0, rem = 0;
            if (live > 0) {
                part = s0 / nsmpl;
                rem = s0 - part * nsmpl;
            }
            const bool header = r0 == 0 && t == 0;
            BitCounter count;
            if (header) count.bits = 12;
            // Partitions of whole runs: a live run is full and lies in one.
            const bool one_part = nsmpl % kRun == 0;
            if (one_part && live == kRun) {
                walk_one(x, part, rem == 0, ksh, recursive, count);
            } else if (live == kRun) {
                walk_run<true>(x, live, part, rem, nsmpl, ksh, recursive,
                               count);
            } else if (live > 0) {
                walk_run<false>(x, live, part, rem, nsmpl, ksh, recursive,
                                count);
            }
            uint32_t total;
            const uint32_t mine = min(count.bits, cap_bits);
            const uint32_t before = block_exclusive_sum(mine, warp_sums,
                                                        &total);
            BitWriter wr(img, lw, base + before);
            if (header) {
                wr.put(0, ct, 2);
                wr.put(0, (uint32_t)po & 1023u, 10);
            }
            if (one_part && live == kRun) {
                walk_one(x, part, rem == 0, ksh, recursive, wr);
            } else if (live == kRun) {
                walk_run<true>(x, live, part, rem, nsmpl, ksh, recursive, wr);
            } else if (live > 0) {
                walk_run<false>(x, live, part, rem, nsmpl, ksh, recursive,
                                wr);
            }
            base = min(base + total, cap_bits);
        }
    }
    __syncthreads();
    const long long start = starts[orow];
    for (uint32_t i = t; i < lw; i += kRowThreads) {
        const long long w = start + i;
        if (w >= 0 && w < cap_w) out[w] = img[i];
    }
}

}  // namespace

// offs: (count,) int64 absolute bit offsets; tails, tbits: (count,) int32
// or int64 (tails64, tbits64 non-zero: int64); out: (cap_w,) zeroed 32-bit
// words, cap_w < 2^32.
extern "C" int srla_bitpack(const void* offs, const void* tails,
                            const void* tbits, void* out, long long count,
                            long long cap_w, int tails64, int tbits64,
                            void* stream) {
    if (count < 0 || cap_w < 0 || cap_w > 0xfffffffeLL)
        return (int)cudaErrorInvalidValue;
    if (count == 0 || cap_w == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (tails64 && tbits64)
        return launch_pack<int64_t, int64_t>(offs, tails, tbits, out, count,
                                             cap_w, s);
    if (tails64)
        return launch_pack<int64_t, int32_t>(offs, tails, tbits, out, count,
                                             cap_w, s);
    if (tbits64)
        return launch_pack<int32_t, int64_t>(offs, tails, tbits, out, count,
                                             cap_w, s);
    return launch_pack<int32_t, int32_t>(offs, tails, tbits, out, count,
                                         cap_w, s);
}

// u: (V, n) 32-bit patterns: with rows null, V = count and row r holds
// the zigzag codes of output row r; with rows (count,) int64, output row r
// takes the residual row rows[r] and zigzags it as it loads (a row index
// outside 0..V-1 packs nothing). code_type, porder (V,) and ks (V, maxp)
// in 0..31 are int64, as the analysis leaves them, indexed as u; starts,
// lens_w (count,) int64 in words, lens_w at most image_words (a longer
// section loses its end); out: (cap_w,) 32-bit words, written only at
// [starts[r], starts[r] + lens_w[r]). Returns cudaErrorInvalidValue when
// the image and the parameters do not fit in a CTA's shared memory.
extern "C" int srla_pack_sections(const void* u, const void* code_type,
                                  const void* porder, const void* ks,
                                  const void* rows, const void* starts,
                                  const void* lens_w, void* out, int count,
                                  long long V, int n, int maxp,
                                  int image_words, long long cap_w,
                                  void* stream) {
    const size_t smem = ((size_t)image_words + maxp) * sizeof(uint32_t);
    if (smem > 232448 - 64) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        rows != nullptr ? pack_sections_kernel<true>
                        : pack_sections_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)count);
    cudaStream_t s = (cudaStream_t)stream;
    if (rows != nullptr) {
        pack_sections_kernel<true><<<grid, kRowThreads, smem, s>>>(
            (const uint32_t*)u, (const long long*)code_type,
            (const long long*)porder, (const long long*)ks,
            (const long long*)rows, (const long long*)starts,
            (const long long*)lens_w, (uint32_t*)out, n, maxp, image_words,
            cap_w, V);
    } else {
        pack_sections_kernel<false><<<grid, kRowThreads, smem, s>>>(
            (const uint32_t*)u, (const long long*)code_type,
            (const long long*)porder, (const long long*)ks, nullptr,
            (const long long*)starts, (const long long*)lens_w,
            (uint32_t*)out, n, maxp, image_words, cap_w, V);
    }
    return (int)cudaGetLastError();
}
