// Native SRLA block decoder.
//
// Original implementation for the srla_tpu framework: a 64-bit staging
// bitreader feeds LUT-driven Huffman decode, partitioned (recursive) Rice
// residual decode, and the integer synthesis chain (LPC recurrence, long-term
// prediction, de-emphasis, stereo inverse). Stream semantics follow the .srl
// format spec (see srla_tpu/format.py and SURVEY.md §2.1-2.2).
//
// Exposed via a C ABI for ctypes; one call decodes one block payload.

#include <cstdint>
#include <cstring>

#if defined(__x86_64__) && defined(__GNUC__)
#define SRLA_X86_SIMD 1
#include <immintrin.h>
#endif

namespace {

struct BitReader {
    const uint8_t *p;
    const uint8_t *end;
    uint64_t stage;   // MSB-justified pending bits
    int count;        // number of valid bits in stage (from MSB)

    void init(const uint8_t *data, long size) {
        p = data;
        end = data + size;
        stage = 0;
        count = 0;
    }
    inline void refill() {
        while (count <= 56 && p < end) {
            stage |= (uint64_t)(*p++) << (56 - count);
            count += 8;
        }
    }
    inline uint32_t get(int nbits) {
        if (nbits == 0) return 0;
        if (count < nbits) refill();
        uint32_t v = (uint32_t)(stage >> (64 - nbits));
        stage <<= nbits;
        count -= nbits;
        return v;
    }
    inline uint32_t peek(int nbits) {
        if (count < nbits) refill();
        return (uint32_t)(stage >> (64 - nbits));
    }
    inline void drop(int nbits) {
        stage <<= nbits;
        count -= nbits;
    }
    // Count zeros up to the next 1 bit (consuming it).
    inline uint32_t zero_run() {
        uint32_t run = 0;
        for (;;) {
            if (count <= 0) {
                refill();
                if (count <= 0) return run;  // corrupt stream guard
            }
            if (stage == 0) {
                run += count;
                stage = 0;
                count = 0;
                continue;
            }
            int lead = __builtin_clzll(stage);
            if (lead >= count) {
                run += count;
                stage = 0;
                count = 0;
                continue;
            }
            run += lead;
            // lead+1 can be 64 (the terminating 1 is the last staged bit);
            // a plain 64-bit shift would be UB (x86 shifts count mod 64).
            count -= lead + 1;
            stage = (lead >= 63) ? 0 : (stage << (lead + 1));
            return run;
        }
    }
    long bits_consumed(const uint8_t *base) const {
        return (long)(p - base) * 8 - count;
    }
};

inline int32_t unzigzag(uint32_t u) {
    return (int32_t)(u >> 1) ^ -(int32_t)(u & 1);
}

inline int32_t sra(int32_t v, int s) { return v >> s; }

uint16_t fletcher16(const uint8_t *data, long size) {
    uint32_t c0 = 0, c1 = 0;
    while (size > 0) {
        long blk = size < 5802 ? size : 5802;
        size -= blk;
        while (blk--) {
            c0 += *data++;
            c1 += c0;
        }
        c0 = (c0 + (c0 / 255)) & 0xFF;
        c1 = (c1 + (c1 / 255)) & 0xFF;
    }
    return (uint16_t)((c1 << 8) | c0);
}

#if defined(SRLA_X86_SIMD)
static inline bool srla_has_avx2() {
    // Defined-but-empty reads as unset (CI exports "" on non-scalar legs).
    const char *e = getenv("SRLA_FORCE_SCALAR");
    static const bool ok = __builtin_cpu_supports("avx2")
        && !(e && e[0]);
    return ok;
}

// Wrapping-int32 inner product (vpmulld is exactly int32 wrap multiply;
// lane order does not matter because int32 addition is commutative mod 2^32).
// Per-function target attribute + runtime dispatch: the file is built
// without -mavx2 so the f64-sensitive TUs share plain compile flags.
__attribute__((target("avx2")))
static int32_t dot_wrap32(const int32_t *c, const int32_t *x, int o,
                          int32_t acc0) {
    __m256i acc = _mm256_setzero_si256();
    int i = 0;
    for (; i + 8 <= o; i += 8) {
        __m256i cv = _mm256_loadu_si256((const __m256i *)(c + i));
        __m256i xv = _mm256_loadu_si256((const __m256i *)(x + i));
        acc = _mm256_add_epi32(acc, _mm256_mullo_epi32(cv, xv));
    }
    __m128i s4 = _mm_add_epi32(_mm256_castsi256_si128(acc),
                               _mm256_extracti128_si256(acc, 1));
    __m128i s2 = _mm_add_epi32(s4, _mm_shuffle_epi32(s4,
                                                     _MM_SHUFFLE(1, 0, 3, 2)));
    __m128i s1 = _mm_add_epi32(s2, _mm_shuffle_epi32(s2,
                                                     _MM_SHUFFLE(2, 3, 0, 1)));
    int32_t r = (int32_t)((uint32_t)_mm_cvtsi128_si32(s1) + (uint32_t)acc0);
    for (; i < o; i++)
        r = (int32_t)((uint32_t)r + (uint32_t)c[i] * (uint32_t)x[i]);
    return r;
}
#endif

void lpc_synthesize(int32_t *data, int n, const int32_t *coef, int order,
                    int rshift) {
    if (order == 0) return;
    const int32_t half = (rshift > 0) ? (int32_t)(1u << (rshift - 1))
                                      : (int32_t)0x80000000u;
    for (int s = 1; s < order && s < n; s++) data[s] += data[s - 1];
#if defined(SRLA_X86_SIMD)
    if (order >= 8 && srla_has_avx2()) {
        for (int s = 0; s + order < n; s++)
            data[s + order] -= sra(dot_wrap32(coef, data + s, order, half),
                                   rshift);
        return;
    }
#endif
    for (int s = 0; s + order < n; s++) {
        int32_t acc = half;
        for (int i = 0; i < order; i++)
            acc += (int32_t)((uint32_t)coef[i] * (uint32_t)data[s + i]);
        data[s + order] -= sra(acc, rshift);
    }
}

void ltp_synthesize(int32_t *data, int n, const int32_t *coef, int order,
                    int period, int rshift) {
    if (order == 0 || period == 0) return;
    const int32_t half = 1 << (rshift - 1);
    const int delay = period + (order >> 1);
    for (int s = delay + 1; s < n; s++) {
        int32_t acc = half;
        for (int i = 0; i < order; i++)
            acc += (int32_t)((uint32_t)coef[i] * (uint32_t)data[s - delay + i]);
        data[s] += sra(acc, rshift);
    }
}

void deemphasis(int32_t *data, int n, int32_t coef, int32_t prev) {
    int32_t y = prev;
    for (int s = 0; s < n; s++) {
        y = data[s] + sra((int32_t)((uint32_t)y * (uint32_t)coef), 4);
        data[s] = y;
    }
}

int rice_decode_channel(BitReader &br, int32_t *out, int n) {  // rc codes
    uint32_t code_type = br.get(2);
    if (code_type == 2) {  // ALLZERO
        memset(out, 0, sizeof(int32_t) * n);
        return 0;
    }
    if (code_type > 2) return -30;
    uint32_t porder = br.get(10);
    // Valid streams use porder <= 10 (SRLACODER_LOG2_MAX_NUM_PARTITIONS);
    // anything larger is corrupt, and shifting by >= 31 below would be UB.
    if (porder > 10) return -40 - (int)porder;
    int nparts = 1 << porder;
    if (nparts > n || n % nparts) return -40 - (int)porder;
    int nsmpl = n / nparts;
    int32_t k = 0;
    for (int part = 0; part < nparts; part++) {
        if (part == 0) {
            k = (int32_t)br.get(5);
        } else {
            k += unzigzag(br.zero_run());
        }
        if (k < 0 || k > 31) return -100 - part;
        int32_t *dst = out + (long)part * nsmpl;
        if (code_type == 1) {  // recursive Rice: k1 = k+1, k2 = k
            for (int i = 0; i < nsmpl; i++) {
                // Fast path: the whole codeword sits in the staged word.
                if (br.count < 40 + k) br.refill();
                const uint64_t st = br.stage;
                const int lead = st ? __builtin_clzll(st) : 64;
                uint32_t uval;
                if (lead == 0 && k + 2 <= br.count) {
                    uval = (uint32_t)((st << 1) >> (63 - k));
                    br.stage = st << (k + 2);
                    br.count -= k + 2;
                } else if (lead > 0 && lead + 1 + k <= br.count
                           && lead + 1 + k < 64) {
                    uval = (((uint32_t)lead + 1) << k)
                        | (k ? (uint32_t)((st << (lead + 1)) >> (64 - k))
                             : 0u);
                    br.stage = st << (lead + 1 + k);
                    br.count -= lead + 1 + k;
                } else {  // long runs / stage boundary: general path
                    uint32_t quot = br.zero_run();
                    uval = quot == 0 ? br.get(k + 1)
                                     : (br.get(k) | ((quot + 1) << k));
                }
                dst[i] = unzigzag(uval);
            }
        } else {  // plain Rice
            for (int i = 0; i < nsmpl; i++) {
                if (br.count < 40 + k) br.refill();
                const uint64_t st = br.stage;
                const int lead = st ? __builtin_clzll(st) : 64;
                uint32_t uval;
                if (lead + 1 + k <= br.count && lead + 1 + k < 64) {
                    uval = ((uint32_t)lead << k)
                        | (k ? (uint32_t)((st << (lead + 1)) >> (64 - k))
                             : 0u);
                    br.stage = st << (lead + 1 + k);
                    br.count -= lead + 1 + k;
                } else {
                    uint32_t quot = br.zero_run();
                    uval = (quot << k) + br.get(k);
                }
                dst[i] = unzigzag(uval);
            }
        }
    }
    return 0;
}

}  // namespace

extern "C" {

// Decode one COMPRESS block payload into out (num_channels x num_samples,
// row-major). Returns consumed payload bytes, or -1 on malformed data.
long srla_decode_block(
    const uint8_t *payload, long payload_size,
    int num_channels, int bits_per_sample, int num_samples, int offset_lshift,
    const int16_t *plut_sym, const uint8_t *plut_len, int plut_bits,
    const int16_t *slut_sym, const uint8_t *slut_len, int slut_bits,
    int32_t *out) {
    BitReader br;
    br.init(payload, payload_size);

    const int C = num_channels;
    const int n = num_samples;
    uint32_t method = br.get(2);
    if (method > 3) return -1;

    int32_t pre_prev[16], pre_coef[16];
    int32_t orders[16], rshifts[16];
    int32_t coefs[16][256];
    int32_t ltp_orders[16], ltp_periods[16], ltp_coefs[16][8];
    if (C > 16) return -1;

    for (int c = 0; c < C; c++) {
        pre_prev[c] = unzigzag(br.get(bits_per_sample + 1));
        pre_coef[c] = unzigzag(br.get(5));
    }
    for (int c = 0; c < C; c++) {
        orders[c] = (int32_t)br.get(8);
        rshifts[c] = (int32_t)br.get(4);
        uint32_t use_sum = br.get(1);
        int o = orders[c];
        for (int i = 0; i < o; i++) {
            const int16_t *sym = (i == 0 || !use_sum) ? plut_sym : slut_sym;
            const uint8_t *len = (i == 0 || !use_sum) ? plut_len : slut_len;
            int kbits = (i == 0 || !use_sum) ? plut_bits : slut_bits;
            uint32_t peeked = br.peek(kbits);
            int16_t s = sym[peeked];
            uint8_t l = len[peeked];
            if (l == 0) return -1;
            br.drop(l);
            int32_t v = unzigzag((uint32_t)s);
            coefs[c][i] = (i == 0 || !use_sum) ? v : v - coefs[c][i - 1];
        }
    }
    for (int c = 0; c < C; c++) {
        ltp_periods[c] = 0;
        ltp_orders[c] = 0;
        if (br.get(1)) {
            ltp_orders[c] = 2 * (int32_t)br.get(1) + 1;
            ltp_periods[c] = (int32_t)br.get(8) + 8;
            for (int i = 0; i < ltp_orders[c]; i++)
                ltp_coefs[c][i] = unzigzag(br.get(6));
        }
    }
    for (int c = 0; c < C; c++) {
        int rc = rice_decode_channel(br, out + (long)c * n, n);
        if (rc != 0) return rc;
    }
    long consumed = (br.bits_consumed(payload) + 7) / 8;

    for (int c = 0; c < C; c++) {
        int32_t *buf = out + (long)c * n;
        lpc_synthesize(buf, n, coefs[c], orders[c], rshifts[c]);
        ltp_synthesize(buf, n, ltp_coefs[c], ltp_orders[c], ltp_periods[c], 5);
        deemphasis(buf, n, pre_coef[c], pre_prev[c]);
    }
    if (method == 1 && C >= 2) {        // MS -> LR
        int32_t *l = out, *r = out + n;
        for (int s = 0; s < n; s++) {
            l[s] -= sra(r[s], 1);
            r[s] += l[s];
        }
    } else if (method == 2 && C >= 2) { // LS -> LR
        int32_t *l = out, *r = out + n;
        for (int s = 0; s < n; s++) r[s] += l[s];
    } else if (method == 3 && C >= 2) { // SR -> LR
        int32_t *l = out, *r = out + n;
        for (int s = 0; s < n; s++) l[s] = r[s] - l[s];
    }
    if (offset_lshift > 0) {
        for (long i = 0; i < (long)C * n; i++)
            out[i] = (int32_t)((uint32_t)out[i] << offset_lshift);
    }
    return consumed;
}

// Batched parameter-header parse for the device decode driver: per block,
// decode everything BEFORE the residual sections (method, pre-emphasis,
// LPC orders/shifts/Huffman coefs, LTP fields) and report the bit offset of
// channel 0's residual section. The entropy-heavy residual decode stays on
// the accelerator (kernels/decode.py); this keeps the host's share of the
// work at C speed. Parity: srla_decoder.c:510-596 field order.
long srla_parse_params_batch(
    const uint8_t *data, const int64_t *payload_off,
    const int64_t *payload_size, long nblocks,
    int num_channels, int bits_per_sample,
    const int16_t *plut_sym, const uint8_t *plut_len, int plut_bits,
    const int16_t *slut_sym, const uint8_t *slut_len, int slut_bits,
    int max_coef, int32_t *method, int32_t *pre_prev, int32_t *pre_coef,
    int32_t *orders, int32_t *rshifts, int32_t *coefs, int32_t *ltp_orders,
    int32_t *ltp_periods, int32_t *ltp_coefs, int64_t *start_bits) {
    const int C = num_channels;
    if (C > 16) return -1;
    for (long b = 0; b < nblocks; b++) {
        BitReader br;
        br.init(data + payload_off[b], payload_size[b]);
        method[b] = (int32_t)br.get(2);
        if (method[b] > 3) return -(b + 2);
        for (int c = 0; c < C; c++) {
            pre_prev[b * C + c] = unzigzag(br.get(bits_per_sample + 1));
            pre_coef[b * C + c] = unzigzag(br.get(5));
        }
        for (int c = 0; c < C; c++) {
            int o = (int)br.get(8);
            orders[b * C + c] = o;
            rshifts[b * C + c] = (int32_t)br.get(4);
            uint32_t use_sum = br.get(1);
            if (o > max_coef) return -(b + 2);
            int32_t *cf = coefs + ((long)b * C + c) * max_coef;
            for (int i = 0; i < o; i++) {
                const int16_t *sym = (i == 0 || !use_sum) ? plut_sym
                                                          : slut_sym;
                const uint8_t *len = (i == 0 || !use_sum) ? plut_len
                                                          : slut_len;
                int kbits = (i == 0 || !use_sum) ? plut_bits : slut_bits;
                uint32_t peeked = br.peek(kbits);
                int16_t s = sym[peeked];
                uint8_t l = len[peeked];
                if (l == 0) return -(b + 2);
                br.drop(l);
                int32_t v = unzigzag((uint32_t)s);
                cf[i] = (i == 0 || !use_sum) ? v : v - cf[i - 1];
            }
        }
        for (int c = 0; c < C; c++) {
            int32_t lo = 0, lp = 0;
            int32_t *lc = ltp_coefs + ((long)b * C + c) * 8;
            if (br.get(1)) {
                lo = 2 * (int32_t)br.get(1) + 1;
                lp = (int32_t)br.get(8) + 8;
                for (int i = 0; i < lo; i++)
                    lc[i] = unzigzag(br.get(6));
            }
            ltp_orders[b * C + c] = lo;
            ltp_periods[b * C + c] = lp;
        }
        if (br.count < 0) return -(b + 2);  // read past the payload end
        start_bits[b] = br.bits_consumed(data + payload_off[b]);
    }
    return 0;
}

// Standalone residual decoder (one channel) for partial/streaming use.
long srla_rice_decode(const uint8_t *payload, long payload_size,
                      long start_bit, int num_samples, int32_t *out) {
    BitReader br;
    br.init(payload + start_bit / 8, payload_size - start_bit / 8);
    int skew = (int)(start_bit % 8);
    if (skew) br.get(skew);
    if (rice_decode_channel(br, out, num_samples) != 0) return -1;
    return start_bit - skew + br.bits_consumed(payload + start_bit / 8);
}

}  // extern "C"

extern "C" {
// Debug helper: parse the parameter section, return bit position (or -code).
long srla_debug_params(const uint8_t *payload, long payload_size,
                       int num_channels, int bits_per_sample,
                       const int16_t *plut_sym, const uint8_t *plut_len,
                       int plut_bits,
                       const int16_t *slut_sym, const uint8_t *slut_len,
                       int slut_bits) {
    BitReader br;
    br.init(payload, payload_size);
    const int C = num_channels;
    uint32_t method = br.get(2);
    if (method > 3) return -2;
    int32_t coefs[16][256];
    for (int c = 0; c < C; c++) { br.get(bits_per_sample + 1); br.get(5); }
    for (int c = 0; c < C; c++) {
        int o = (int)br.get(8);
        br.get(4);
        uint32_t use_sum = br.get(1);
        for (int i = 0; i < o; i++) {
            const int16_t *sym = (i == 0 || !use_sum) ? plut_sym : slut_sym;
            const uint8_t *len = (i == 0 || !use_sum) ? plut_len : slut_len;
            int kbits = (i == 0 || !use_sum) ? plut_bits : slut_bits;
            uint32_t peeked = br.peek(kbits);
            uint8_t l = len[peeked];
            if (l == 0) return -3;
            br.drop(l);
            (void)sym;
        }
    }
    for (int c = 0; c < C; c++) {
        if (br.get(1)) { br.get(1); br.get(8); for (int i = 0; i < 3; i++) br.get(6); }
    }
    return br.bits_consumed(payload);
}
}

extern "C" {

// Decode an entire .srl stream body (after the 30-byte file header) into
// out (num_channels x num_samples). Returns decoded samples, or -1.
long srla_decode_stream(
    const uint8_t *data, long data_size,
    int num_channels, int bits_per_sample, long num_samples,
    int offset_lshift, int check_checksum,
    const int16_t *plut_sym, const uint8_t *plut_len, int plut_bits,
    const int16_t *slut_sym, const uint8_t *slut_len, int slut_bits,
    int32_t *out) {
    const int C = num_channels;
    long progress = 0;
    long off = 0;
    int32_t *chbuf[16];
    if (C > 16) return -1;
    while (progress < num_samples && off + 11 <= data_size) {
        const uint8_t *blk = data + off;
        if (blk[0] != 0xFF || blk[1] != 0xFF) return -1;
        uint32_t size32 = ((uint32_t)blk[2] << 24) | ((uint32_t)blk[3] << 16)
                          | ((uint32_t)blk[4] << 8) | blk[5];
        if (off + 6 + (long)size32 > data_size) return -1;
        uint16_t want = (uint16_t)(((uint16_t)blk[6] << 8) | blk[7]);
        if (check_checksum) {
            uint16_t got = fletcher16(blk + 8, (long)size32 - 2);
            if (got != want) return -2;
        }
        int btype = blk[8];
        int ns = (blk[9] << 8) | blk[10];
        const uint8_t *payload = blk + 11;
        long psize = (long)size32 - 5;
        if (progress + ns > num_samples) return -1;
        if (btype == 1) {  // SILENT
            for (int c = 0; c < C; c++)
                memset(out + (long)c * num_samples + progress, 0,
                       sizeof(int32_t) * ns);
        } else if (btype == 2) {  // RAW: interleaved zigzag BE PCM
            const uint8_t *rp = payload;
            int nbytes = bits_per_sample / 8;
            // A crafted block can claim more samples than its payload holds;
            // reading them would run past the buffer (reference guards this
            // at srla_decoder.c:389, INSUFFICIENT_DATA).
            if (psize < (long)ns * C * nbytes) return -1;
            for (int s = 0; s < ns; s++) {
                for (int c = 0; c < C; c++) {
                    uint32_t uv = 0;
                    for (int bb = 0; bb < nbytes; bb++) uv = (uv << 8) | *rp++;
                    out[(long)c * num_samples + progress + s] = unzigzag(uv);
                }
            }
        } else if (btype == 0) {  // COMPRESS
            // Decode into per-channel strided views via a temp contiguous
            // region: decode directly into out rows (they are contiguous
            // per channel), using a row-major (C, ns) scratch semantics.
            // srla_decode_block writes (C, ns) contiguous; build pointers.
            // Simplest: decode into a stack buffer when ns small enough is
            // not viable (ns up to 32768); decode per channel directly:
            // reuse srla_decode_block with a contiguous temp.
            static thread_local int32_t *tmp = nullptr;
            static thread_local long tmp_cap = 0;
            if ((long)C * ns > tmp_cap) {
                delete[] tmp;
                tmp_cap = (long)C * ns * 2;
                tmp = new int32_t[tmp_cap];
            }
            long r = srla_decode_block(payload, psize, C, bits_per_sample,
                                       ns, offset_lshift,
                                       plut_sym, plut_len, plut_bits,
                                       slut_sym, slut_len, slut_bits, tmp);
            if (r < 0) return r;
            for (int c = 0; c < C; c++)
                memcpy(out + (long)c * num_samples + progress,
                       tmp + (long)c * ns, sizeof(int32_t) * ns);
        } else {
            return -1;
        }
        off += 6 + size32;
        progress += ns;
    }
    return progress;
}

}  // extern "C"
