// K2: partitioned-Rice entropy decode of a block group, straight out of the
// device-resident stream.
//
// Replaces the XLA word machine of srla_tpu/kernels/decode2.py
// (_stage_from_flat -> _entropy_scan/_machine_bit/_window_update/
// _butterfly_concentrate -> _assemble) and decodes what srla_tpu/rice.py
// decode reads, per block b and channel c (channel c+1's section starts
// where channel c's ends):
//
//   2-bit code type (0 Rice, 1 recursive Rice, 2 ALLZERO -> a zero row)
//   10-bit partition order p (clipped to 31), 5-bit first Rice parameter k;
//   partitions of max(n >> p, 1) samples; before each partition after the
//   first, a unary zigzag delta moves k (clipped to 0..31);
//   each codeword: unary quotient q, then a tail of k bits (recursive Rice:
//   k+1 bits when q == 0); value u = (q << k) + tail, or for recursive Rice
//   tail | ((q + (q > 0)) << k), both mod 2^32; residual = unzigzag(u),
//   with a logical shift.
//
// The stream is the raw .srl bytes as little-endian 32-bit words (the view
// the host uploads); bytes are MSB-first, so each word is byte-reversed on
// read. Block b starts at absolute bit word_start[b] * 32 + bit_rem[b].
//
// Bounds: every word read past the buffer reads 0, and a unary run is only
// looked for inside the block's window of W words from its start (the same
// window the XLA program scans). If no terminating 1 lies in the window the
// block stops and its undecoded samples stay 0, so a corrupt payload whose
// checksum collides can neither loop without bound nor read out of bounds.
//
// What bounds it on an H100: the codewords are self-delimiting, so one
// block's decode is a serial chain, C * (n + partitions) codewords long:
// each codeword's start is known only once the one before it is read
// (take the 32 bits there, count their leading zeros, add the tail width).
// The bytes are few. chip_smoke.py reports the serial floor, C * n times
// that shortest step measured alone (csrc/chain_probe.cu). The first port
// ran one thread per block (11 of 132 SMs busy at the main path) and each
// codeword waited on dependent pairs of global loads.
//
// Design: one warp per block, a CTA each (1,291 warps at the main path, on
// every SM; one warp a CTA measured faster than four, at both groups).
//  - The warp streams its payload through a ring of 2 x 512 words of
//    shared memory: cp.async copies of 32 consecutive words (zero-filled
//    past the buffer), byte-swapped once when they land, the next half in
//    flight while the walk reads the other. A payload longer than the ring
//    (W reaches tens of thousands of words for 24-bit 8192-sample blocks)
//    streams through it. The ring's first words are mirrored after its
//    end, so two neighbouring words come from one masked index.
//  - The walk finds the codeword boundaries only. It keeps five words of
//    the stream in registers, with the next two loaded a step ahead, so a
//    codeword is a funnel shift, a bfind, an add and a select of the next
//    window, with no memory access on the chain. It runs four codewords at
//    a time with no branch among them; a group that meets a unary run not
//    ending in the next 32 bits (or a window end near enough to matter) is
//    walked again one codeword at a time, and such runs take a slow path.
//  - For codeword j of 32 the walk stores where its tail starts, its
//    quotient and its tail width in a shared record (every lane stores the
//    same record, so each reads its own back without a barrier); then lane
//    j extracts its tail from the ring, rebuilds and unzigzags the value,
//    and the warp writes 32 consecutive samples in one 128-byte store.
// All lanes run the walk in lockstep on the same values, which costs what
// one lane would and keeps every branch uniform. The TPU design's per-word
// scan steps, 32-bit unrolled transducer and butterfly concentrator worked
// around gather cost and are not needed.
//
// No tensor cores: the work is bit-serial; there is no product to give them.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 1;                 // blocks (warps) per CTA
constexpr int kHalf = 512;                // words per ring half
constexpr int kRing = 2 * kHalf;
constexpr int kMirror = 8;                // ring[kRing + i] = ring[i]
// Words that 32 samples may span outside a long unary run: 32 x (a k
// delta, a unary run and a tail of at most 32 bits each), plus the header
// and the word after the last peek.
constexpr int kSlack = 128;

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src,
                                          int bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

// The block's payload, streamed through this warp's shared-memory ring as
// big-endian words. Relative word i lives in ring[i % kRing] once landed;
// the ring's first kMirror words are repeated after its end, so words
// i .. i+kMirror are read from one masked index without wrapping.
struct Ring {
    const uint32_t* words;
    long long nwords;
    long long base;          // global index of relative word 0
    uint32_t* ring;
    int lane;
    int ready;               // relative words below ready have landed
    int staged;              // ... below staged are landed or in flight

    // Copy relative words [from, from + kHalf) into their ring half.
    __device__ __forceinline__ void stage(int from) {
        uint32_t* dst = ring + (from & (kRing - 1));
#pragma unroll 4
        for (int i = lane; i < kHalf; i += 32) {
            const long long g = base + from + i;
            const bool in = g < nwords;
            cp_async4(dst + i, words + (in ? g : 0), in ? 4 : 0);
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        staged = from + kHalf;
    }

    // Wait for the staged words and byte-swap them once.
    __device__ __forceinline__ void land() {
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncwarp();
        for (int i = ready + lane; i < staged; i += 32) {
            const int at = i & (kRing - 1);
            const uint32_t w = __byte_perm(ring[at], 0u, 0x0123);
            ring[at] = w;
            if (at < kMirror) ring[kRing + at] = w;
        }
        __syncwarp();
        ready = staged;
    }

    // Words below lo are no longer needed; have [lo, lo + kSlack) landed.
    // Once lo is in the newer half the older one takes the next kHalf
    // words, which are waited for only when lo comes within kSlack.
    __device__ __forceinline__ void manage(int lo) {
        if (staged == ready && lo >= ready - kHalf) stage(ready);
        if (staged != ready && lo + kSlack >= ready) land();
    }

    // Words i .. i+kMirror.
    __device__ __forceinline__ const uint32_t* at(int i) const {
        return ring + (i & (kRing - 1));
    }

    // The 32 stream bits from relative bit p, MSB first.
    __device__ __forceinline__ uint32_t peek32(int p) const {
        const uint32_t* w = at(p >> 5);
        return __funnelshift_l(w[1], w[0], p & 31);
    }
};

// The walk's view of the stream: big-endian words r .. r+4 in registers
// (w0, w1 the 64 bits the next codeword starts in), words r+5 and r+6
// loaded a step ahead, and the bit offset into w0. Relative bit position
// 32 r + off.
struct Window {
    int r, off;
    uint32_t w0, w1, w2, w3, w4, l5, l6;

    __device__ __forceinline__ void load(const Ring& rg, int p) {
        r = p >> 5;
        off = p & 31;
        const uint32_t* w = rg.at(r);
        w0 = w[0];
        w1 = w[1];
        w2 = w[2];
        w3 = w[3];
        w4 = w[4];
        l5 = w[5];
        l6 = w[6];
    }
    __device__ __forceinline__ int pos() const { return 32 * r + off; }
    __device__ __forceinline__ uint32_t top() const {
        return __funnelshift_l(w1, w0, off);
    }
    // Move to offset o = off + m, o < 96: at most two words. The loads
    // issued here are used one step later, off the chain.
    __device__ __forceinline__ void advance(const Ring& rg, int o) {
        const bool s0 = o < 32, s1 = o < 64;
        off = o & 31;
        r += o >> 5;
        const uint32_t n0 = s0 ? w0 : (s1 ? w1 : w2);
        const uint32_t n1 = s0 ? w1 : (s1 ? w2 : w3);
        const uint32_t n2 = s0 ? w2 : (s1 ? w3 : w4);
        const uint32_t n3 = s0 ? w3 : (s1 ? w4 : l5);
        const uint32_t n4 = s0 ? w4 : (s1 ? l5 : l6);
        w0 = n0;
        w1 = n1;
        w2 = n2;
        w3 = n3;
        w4 = n4;
        const uint32_t* w = rg.at(r + 5);
        l5 = w[0];
        l6 = w[1];
    }
    __device__ __forceinline__ void skip(const Ring& rg, int m) {
        advance(rg, off + m);                    // m <= 64
    }
};

// Index of the most significant 1 of x (31 - leading zeros; -1 for 0).
// Volatile so that it is issued before the test of x that may leave the
// loop, and its latency runs alongside that branch.
__device__ __forceinline__ int msb(uint32_t x) {
    int i;
    asm volatile("bfind.u32 %0, %1;" : "=r"(i) : "r"(x));
    return i;
}

__global__ void __launch_bounds__(kWarps * 32)
rice_decode_kernel(const uint32_t* __restrict__ words, long long nwords,
                   const int32_t* __restrict__ word_start,
                   const int32_t* __restrict__ bit_rem,
                   int32_t* __restrict__ out, int B, int C, int n, int W) {
    __shared__ uint32_t rings[kWarps][kRing + kMirror];
    __shared__ uint4 recs[kWarps][32];          // the walk's codewords
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * kWarps + warp;
    if (b >= B) return;                          // the whole warp leaves
    Ring rg{words, nwords, word_start[b], rings[warp], lane, 0, 0};
    rg.stage(0);
    rg.stage(kHalf);
    rg.land();
    int p = bit_rem[b];                          // relative bit position
    const long long room0 = 32LL * W;
    int room = room0 < 0x7fffffffLL ? (int)room0 : 0x7fffffff;

    auto read = [&](int nbits) -> uint32_t {     // nbits in 1..32
        const uint32_t v = rg.peek32(p) >> (32 - nbits);
        p += nbits;
        room -= nbits;
        return v;
    };

    int32_t* o = out + (long long)b * C * n;
    Window wd;
    for (int c = 0; c < C; ++c, o += n) {
        rg.manage(p >> 5);
        const uint32_t ctype = read(2);
        if (ctype == 2u) continue;               // ALLZERO: the row stays 0
        const bool recursive = ctype == 1u;
        uint32_t porder = read(10);
        if (porder > 31u) porder = 31u;
        int nsmpl = n >> porder;
        if (nsmpl < 1) nsmpl = 1;
        int k = (int)read(5);
        int left = nsmpl;
        wd.load(rg, p);
        for (int i0 = 0; i0 < n; i0 += 32) {
            rg.manage(wd.r);
            const int cnt = n - i0 < 32 ? n - i0 : 32;
            // The walk below only finds the codeword boundaries: for
            // sample i0 + j it records where the tail starts, the quotient
            // and the tail width in cw[j] (every lane stores the same
            // record, so each lane reads its own back without a barrier).
            // Then lane j decodes sample i0 + j.
            uint4* cw = recs[warp];
            uint32_t v = 0u;
            int lo = 0;                          // lanes below lo are done
            auto finish = [&](int hi) {
                const uint4 mine = cw[lane];
                const int my_pt = (int)mine.x, my_tw = (int)mine.z;
                const uint32_t my_q = mine.y;
                const uint32_t t = my_tw ? rg.peek32(my_pt) >> (32 - my_tw)
                                         : 0u;
                const int kk = recursive && my_q == 0u ? my_tw - 1 : my_tw;
                const uint32_t u = recursive
                    ? t | ((my_q + (my_q > 0u ? 1u : 0u)) << kk)
                    : (my_q << kk) + t;
                const uint32_t r = (u >> 1) ^ (0u - (u & 1u));
                if (lane >= lo && lane < hi) v = r;
                lo = hi;
            };
            // A unary run that does not end in the window's next 32 bits:
            // zeros before the next 1 (consumed with it), or false if that
            // 1 is not before the block's end. It first decodes the lanes
            // walked so far, as it may move the ring past their tails.
            auto unary_long = [&](int j, uint32_t top, uint32_t& q) -> bool {
                if (top != 0u) return false;     // the 1 is past the end
                finish(j);
                int pp = wd.pos();
                uint32_t acc = 0u;
                for (;;) {
                    acc += 32u;
                    pp += 32;
                    room -= 32;
                    if (room <= 0) return false;
                    rg.manage(pp >> 5);
                    const uint32_t t = rg.peek32(pp);
                    if (t != 0u) {
                        const int zz = __clz(t);
                        if (zz >= room) return false;
                        q = acc + (uint32_t)zz;
                        room -= zz + 1;
                        wd.load(rg, pp + zz + 1);
                        return true;
                    }
                }
            };
            // Codewords in runs that stay inside one partition; the k
            // delta comes between runs.
            for (int j = 0; j < cnt;) {
                uint32_t q;
                if (left == 0) {                 // next partition: k delta
                    const uint32_t top = wd.top();
                    const int z = __clz(top);
                    bool ok = true;
                    if (top != 0u && z < room) {
                        q = (uint32_t)z;
                        room -= z + 1;
                        wd.skip(rg, z + 1);
                    } else {
                        ok = unary_long(j, top, q);
                    }
                    if (!ok) {                   // keep what was decoded
                        finish(j);
                        if (lane < j) o[i0 + lane] = (int32_t)v;
                        return;
                    }
                    const int dz = (q & 1u) ? -(int)(q >> 1) - 1
                                            : (int)(q >> 1);
                    const int kk = k + dz;       // unzigzag(q), no overflow
                    k = kk < 0 ? 0 : (kk > 31 ? 31 : kk);
                    left = nsmpl;
                }
                const int j0 = j;
                const int jend = j + (left < cnt - j ? left : cnt - j);
                // The codewords whose unary run ends in the window's next
                // 32 bits, straight through; anything else leaves the loop.
                // A codeword so found takes at most 64 bits, so while the
                // window has room for all of the run, no 1 can lie past its
                // end and the loop need not look.
                const int c0 = 32 + k, c1 = 32 + k + 1;
                auto walk = [&](auto check_room, auto recur) {
                    const int p0 = wd.pos();
                    // Four codewords at a time with no branch among them
                    // (a conditional branch stalls the walk even when not
                    // taken); a group that meets a long run is walked again
                    // one codeword at a time below.
                    if (!decltype(check_room)::value) {
                        for (; jend - j >= 4; j += 4) {
                            const Window saved = wd;
                            bool bad = false;
#pragma unroll
                            for (int u = 0; u < 4; ++u) {
                                const uint32_t top = wd.top();
                                const int m = msb(top);
                                bad |= top == 0u;
                                const int tw32 = decltype(recur)::value &&
                                                 (int32_t)top < 0 ? c1 : c0;
                                const int pos = wd.pos();
                                cw[j + u] = make_uint4(
                                    (uint32_t)(pos + 32 - m),
                                    (uint32_t)(31 - m),
                                    (uint32_t)(tw32 - 32), 0u);
                                // (after a bad one, harmless garbage: the
                                // ring index is masked, the group redone)
                                wd.advance(rg, wd.off + tw32 - m);
                            }
                            if (bad) {
                                wd = saved;
                                break;
                            }
                        }
                    }
                    for (; j < jend; ++j) {
                        const uint32_t top = wd.top();
                        const int m = msb(top);  // the 1 is bit 31 - m
                        if (top == 0u) break;
                        if (decltype(check_room)::value &&
                            31 - m >= room - (wd.pos() - p0))
                            break;
                        // 32 + the tail width (k + 1 after q == 0 in
                        // recursive Rice: the top bit is the 1)
                        const int tw32 = decltype(recur)::value &&
                                         (int32_t)top < 0 ? c1 : c0;
                        const int pos = wd.pos();
                        cw[j] = make_uint4((uint32_t)(pos + 32 - m),
                                            (uint32_t)(31 - m),
                                            (uint32_t)(tw32 - 32), 0u);
                        wd.advance(rg, wd.off + tw32 - m);
                    }
                    room -= wd.pos() - p0;
                };
                const bool roomy = room > 64 * (jend - j) + 31;
                if (roomy && recursive)
                    walk(std::false_type{}, std::true_type{});
                else if (roomy)
                    walk(std::false_type{}, std::false_type{});
                else if (recursive)
                    walk(std::true_type{}, std::true_type{});
                else
                    walk(std::true_type{}, std::false_type{});
                const int k1 = recursive ? k + 1 : k;
                if (j < jend) {                  // a long run, or the end
                    if (!unary_long(j, wd.top(), q)) {
                        finish(j);
                        if (lane < j) o[i0 + lane] = (int32_t)v;
                        return;
                    }
                    const int tw = q == 0u ? k1 : k;
                    cw[j] = make_uint4((uint32_t)wd.pos(), q, (uint32_t)tw,
                                        0u);
                    room -= tw;
                    wd.skip(rg, tw);
                    ++j;
                }
                left -= j - j0;
            }
            finish(cnt);
            if (lane < cnt) o[i0 + lane] = (int32_t)v;
        }
        p = wd.pos();
    }
}

}  // namespace

// words: (nwords,) int32 raw stream view; word_start, bit_rem: (B,) int32;
// out: (B, C, n) int32, zero-filled by the caller.
extern "C" int srla_rice_decode(const void* words, long long nwords,
                                const void* word_start, const void* bit_rem,
                                void* out, int B, int C, int n, int W,
                                void* stream) {
    const int blocks = (B + kWarps - 1) / kWarps;
    rice_decode_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, nwords, (const int32_t*)word_start,
        (const int32_t*)bit_rem, (int32_t*)out, B, C, n, W);
    return (int)cudaGetLastError();
}
