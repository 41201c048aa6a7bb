#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's device decode and encode once on one
NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Builds the nineteen CUDA libraries of csrc/ (twenty-two kernels, K1's and
K16's second entries among their entries) and six
measurement aids (the serial-chain probe csrc/chain_probe.cu and the first
designs of K8, K7, K9, K10 and K12, csrc/autocorr_v1.cu, lpc_analyze_v1.cu,
ltp_synth_v1.cu, ltp_analyze_v1.cu and svr_refine_v1.cu, which nothing in
the port calls) with concurrent nvcc,
then:

  1. K1 (LPC synthesis, csrc/lpc_synth.cu) against its plain PyTorch version
     on the card at the main-path shape (2584 rows x 4096 samples, 64 taps),
     at the tail group's shape (2 rows x 4064 samples, 64 taps) and at 256
     taps (264 rows, orders 200..256), with edge rows, with and without
     fused de-emphasis: bit-equal. Times the main shape (ms) and the tail
     shape (tail_ms).
  2. K2 (Rice entropy decode, csrc/rice_decode.cu) against its plain version
     on every block group of the phase-3 stream: bit-equal. Times the
     1291-block group (ms) and the 1-block tail group (tail_ms).
 17. (Run after phase 2.) The decode's synthesis tail on the card, on every
     group of phase 3's stream as the decode hands it over: K1's
     coefficient entry (lpc_scan_coefs: the parsed coefficients read where
     the packed parameters hold them, aligned as its taps load; phase 1
     holds it at phase 1's shapes too) equal to K1's aligned entry, and
     K19 (csrc/synth_tail.cu: the stereo inverse and offset shift, in
     place on K1's output, the methods read from the packed parameters'
     column) bit-equal to its plain version in place and out of place,
     also at 37 odd cases (k19_inputs: n 333 and 4096, each method alone
     and mixed, lshift 0, 1 and 8, C 1, 3 and 8, int32 extremes, strided
     and contiguous methods); K19 timed at the main and tail groups (CUDA
     events, graph replay) beside its plain version (the torch ops
     synthesize ran before), its bound on this data, a copy of its bytes
     and, with --parent, the parent's torch-op tail in turns; K1's entry
     beside the aligned entry with align_coefs' gather before it; and
     torch.profiler's list of synthesize's device work on the main group
     and on an LTP group: K1, K9 and K19 only.
  3. 120 s of stereo 16-bit 44.1 kHz music-like audio, encoded on the host
     at -m 4 -B 4096 -V 0 (the port's exact host encoder,
     srla_tpu_torch.host_encoder, which the CPU tests hold byte-equal to
     srla_tpu.encode(backend="exact")), decoded with
     srla_tpu_torch.decode(..., device="cuda"): lossless, every COMPRESS
     block on the device, K2, K1's coefficient entry and K19 once a group
     and K1's aligned entry never (decode_launches_ok: phases 4, 8, 13 and
     14 count the same on their decodes, K1's entry once more and K9 once
     an LTP group, K19 not on a mono group at lshift 0); then one
     warm decode under torch.profiler (device time by kernel).
  4. A 120 s -m 6 -P 3 stream from the same host encoder (long-term
     prediction; LPC orders up to 93 on this signal) decoded on the card,
     counted: lossless, K9 (LTP synthesis, csrc/ltp_synth.cu) launched once
     per LTP group, K1's coefficient entry twice there (the LPC, the
     de-emphasis at order 0); then K9 against its plain version on every
     LTP group, at edge shapes (delay 9 at order 3, order 1, period and order 0,
     period 262, wrapping values, n 300 and 4064) and on 37 hard rows
     (k9_hard_args: periods 8, 31, 32, 33 and 262, off rows between) at n
     16384, 4064 and 333: bit-equal; warm speed.
  5. K3 (FIR residual, csrc/fir_predict.cu), K4 (the Rice parameter
     search, csrc/rice_search.cu: from the residual to each row's code
     type, order, parameters, bits and flag) and K5 (csrc/bitpack.cu:
     pack_residual_sections,
     residuals to packed sections in one kernel, the entry the encode runs,
     and pack, the generic pack of a ready codeword stream, which is off
     the encode's path) against their plain versions on the card, on the
     inputs the main path's 1291-block group of 4096 samples gives them:
     bit-equal, CUDA-event times. All four also on the inputs of the
     1-block tail group (4 variant rows, 2 chosen rows of 4064 samples,
     partition orders 0..5; tail_ms) and with a device time (CUDA graph
     replay) at both shapes, and each at one small odd shape: K3 at 11 rows
     of 333 samples, M 12 (orders 0, 1, M and M + 1, which reads as M;
     shifts 0 and 31; rows that are not 16-byte aligned); K4 at 12 rows of
     512 samples at partition orders 0..9 (leaves of one sample; both row
     kinds, a full-range row, an all-zero row, a row of mean 2 exactly)
     and both K5 entries at 12 rows of 512 samples at partition orders
     0..9 (partitions of one sample, shorter than a thread's run; both row
     kinds, a full-range, a zero, an ALLZERO and a skipped row, parameters
     0, 30 and 31): bit-equal, every output. Also times the codeword stream
     (torch ops) that the generic pack needs first: with pack's time, what
     the fused entry's work cost before. The generic pack also on the main
     stream shuffled (a seeded permutation on the card), on the same in
     int32, and on an out-of-range stream (k5_edge_stream: negative
     offsets, offsets past cap_w, an entry straddling the last word, widths
     0, 32 and up to 2^33, shuffled): bit-equal; its device time (the whole
     call, int64 and int32, and shuffled), its torch.profiler split by
     kernel (the zero fill and the kernel) and its bound at the caller's
     dtypes (every slot's offset, tail and width as given, the words once).
  6. The same 120 s encoded by srla_tpu_torch.SRLAEncoder(device="cuda")
     at -m 4 -B 4096 -V 0: byte-identical to phase 3's host exact stream,
     every COMPRESS block emitted from the device or a counted host repair
     or overflow, K8 (autocorrelation, csrc/autocorr.cu), K7 (Levinson,
     order choice and quantization, csrc/lpc_analyze.cu), K3, K4 and K5's
     pack_residual_sections launched by that encode (twice each, once a
     group; the generic pack not at all) and no plain version of K7, K8 or
     K4 reached, and the stream decoded losslessly by the port. Prints the
     warm best-of-3 encode speed and a per-step breakdown, and three of
     the main group's encodes under torch.profiler: the device's kernels
     in launch order, none between any K3 and its K4 (the Rice search is
     one launch).
  7. K6 (bit-field placement probes, csrc/bitfield_probe.cu: one-hot
     product, read-modify-write OR, masked lane reduction): the port's tool
     ``python -m srla_tpu_torch.tools.bitfield_probes`` run once as the
     path's entry point (counted), then each kernel against its plain
     version and against ``scatter_add_`` at R = 1 (the tool's shape) and
     R = 4096 rows: bit-equal, CUDA-event times (R = 4096 cycles through
     inputs larger than L2); then each against its plain version at R = 37,
     C = 300, W = 200 (no multiple of a warp or of a CTA's words) with
     full-range values and a tenth of the words and of the shifts out of
     range: bit-equal.
  8. The -V path (variable block sizes: every candidate span of every
     lookahead window measured on the card by kernels.exact.measure_spans,
     K3 and K4, one call per span length; the reference's Dijkstra on the
     host; the chosen blocks encoded as in phase 6): 120 s of make_music at
     the CLI's defaults (-m 4 -B 4096 -V 1 -L 4), 30 s of the segmented
     signal (srla_tpu_torch.signals.make_segmented) at -V 1 and -V 3 and
     its first 10 s at -V 2 -L 2 and -V 2 -L 4, each
     encoded by SRLAEncoder(device="cuda"): byte-identical to the port's
     host exact encoder at the same flags, every span enumerated here
     measured on the card or a counted host re-measure, every COMPRESS
     block from the device or a counted repair or overflow, K8, K7, K3 and
     K4 launched once per measurement call plus once per encode group and
     K5's pack_residual_sections once per encode group (the counts derived
     here from the spans and the stream), a block length that is no power
     of two in the -V 3 stream, and each stream decoded losslessly on the card
     (K1 and K2 launched). Then, for each of the three, K3 and K4 against
     their plain versions on the inputs of every measurement call and
     every encode group (each call's spans cut and analysed as the encoder
     does; 2048-10,332 rows of 512-4096 samples, the clipped tails
     included) and K5's pack_residual_sections on those of every encode
     group: bit-equal; K8 and K7 on the same calls: K8 within 2^-45 r0 of
     its plain version, K7 equal to its plain version on every row neither
     flags, no row flagged by one and not the other. Prints the 120 s -V 1
     encode's and decode's warm
     best of 3 beside the host exact encoder's time, its step breakdown,
     its measurement's call count and the largest call's time and peak
     memory, and K4's generic entry against its plain version on the -V 3
     measurement's 3072-sample group (CUDA events, device time, bound).
  9. Long-term prediction on the encode: the 120 s of phase 3 at -m 4 -B
     4096 -V 0 -P 3 and at the CLI's defaults with -P 3 (-V 1 -L 4), and
     its first 20 s at -V 2 -L 4 -P 3 and first 10 s at -V 2 -B 1024 -L 4
     -P 3, each
     encoded by SRLAEncoder(device="cuda"), counted: byte-identical to the
     host exact encoder, span and block accounting (the spans and blocks
     under 512 samples on the host, as many as the span plan and the
     stream give: device_route), K10 (pitch search and LTP solve,
     csrc/ltp_analyze.cu), K7, K3 and K4 once per device analysis call (K4
     held to its plain version on every output on the inputs of each of
     its calls: held_encode), K8 twice (the pitch lags, then the LPC lags)
     and K5 once per encode group, analysis rows with LTP on above 0, and
     the stream decoded
     losslessly on the card with K9 launched. Then K10 against its plain
     version on the inputs of every analysis call (the pitch lags of every
     measurement call and encode group) and K9 on every LTP decode group:
     bit-equal; K10 also on constructed and seeded rows at orders 1 and 3
     (k10_edge_lags, k10_random_lags); K8 (both lag sets) and K7 as in
     phase 8, no row flagged by one and not the other. Prints each encode's
     and decode's warm best of 3 and the encode's step split, and K10's (at
     the -V 0 encode's 5164 rows) and K9's (at its stream's 2582 rows x
     4096) times beside their plain versions', bounds and serial floors
     (chain_probe.cu kinds 5 and 4), and the device times of each and of
     its first design (csrc/*_v1.cu, equal outputs) in turns, at those
     shapes and at the tail (K10's 4-row call, K9's 1-block group).
 10. K8 and K7 (the encode's f64 analysis): on phase 6's two analysis calls
     as in phase 8; K8 within 2^-46 r0 of the exact rational sum on rows
     of 16384 samples at 24 bits, 4064, 333 (odd) and 20000 (five
     shared-memory stages) at lags 0, 1, 7, 64 and 262; K7 at M 255 on the
     main group's lags and on rows built on its decision boundaries (an
     order tie, a quantization half, the shift's frexp and tiny edges, the
     silent threshold), the port's lags moved by 2^-42: every row whose
     decisions differ from the host's is flagged. Times K8 at the main
     group's 5164 rows x 4096 with 65 lags (the LPC lags) and 263 (the
     pitch lags) beside its plain version and the cuFFT route (rfft, |X|^2,
     irfft: the library yardstick, which the port never calls) and K7 at M
     64 beside its plain version and its serial floor, both also at the
     tail group's 4 rows, and both beside their first designs
     (csrc/*_v1.cu) on the same inputs and card. K7 also on the +-5/32
     coefficient-growth rows at M 64, 128 and 255 (k7_growth_case), lags
     moved by 2^-42: flagged where the order moves (M 128, 255), as its
     plain version flags them.
 11. (Run before phase 10, whose tally it joins.) -P at shapes the card
     had not run: 20 s of make_music shifted to 24 bits at -m 4 -B 8192 -V
     0 -P 3 and 16-bit at -m 6 -B 16384 -V 0 -P 1, encoded on the card:
     byte-identical to the host exact encoder, repaired blocks counted, K10,
     K7, K3, K4 (held to its plain version on each call's inputs) and K5
     once per encode group and K8 twice, the decode
     lossless with K9 once per LTP group; K9 and K10 against their plain
     versions on every group, K8 and K7 as in phase 8.
 12. SVR refinement (--svr-filter-learning-iteration 2): make_music at -m 4
     -B 4096 -V 0 (5 s), the same with -P 3 (5 s), the CLI's -V 1 -L 4 (1.5
     s) and -m 6 -B 16384 -V 0 (1 s: M 255, K12's factor in its global
     scratch), each encoded by SRLAEncoder(device="cuda"), counted:
     byte-identical to the host exact encoder (its time printed), span and
     block accounting, K7's coefficient and quantization entries, K11
     (csrc/svr_cov.cu) and K12 (csrc/svr_refine.cu) once per analysis call
     and K7's fused entry never, no plain version reached, K4 and K7's
     quantization entry held to their plain versions on each call's inputs
     (every output, flags too), the decode on the card lossless;
     K11, K12 and K7's quantization entry bit-equal to
     their plain versions (flags and iterations too) on the M 255 path's
     tail group, and K7's coefficient entry held to its plain version there
     (flags equal, orders equal where unflagged, coefficients within 4
     kappa' 2^-42 max|c| and kappa' within (2M + 1) kappa' 2^-42 relative:
     the two sum in different orders, k7_coefs_check). K7's quantization
     entry also on the rows of k7_quantize_case (the coefficients its
     coefficient entry gives on their lags) with cerr 0 and widened, and
     on k7_quantize_batch at M 32, 64, 128 and 255 (1197 rows: orders 0
     to M, tiny, all-zero, NaN and inf rows): equal to its plain version
     on every output. Then phase 3's 120 s
     at -m 4 -B 4096 -V 0 --svr 2: counted (K4 held as above), decoded
     losslessly, the repair
     rate (a warning above 5 %), warm best of 3 with its step split, K11,
     K12 and K7's two SVR entries against their plain versions on every row
     of both analysis calls, and K11, K12 and K7's two SVR entries
     (srla_lpc_coefs, srla_lpc_quantize) timed at the main call (CUDA
     events, device time) beside their plain versions, bounds (f64
     instructions over 17 T/s; K7's f64 operations over 34 T/s), serial
     floors (chain_probe.cu kind 6, a dependent f64 add; for K7's
     quantization entry kind 7, a step of its chain, times the largest
     order) and library
     yardsticks (a batched DGEMM Gram for K11; cholesky_ex and
     cholesky_solve for K12, the median of five runs), which the port
     never calls; K12 also beside its first design (csrc/svr_refine_v1.cu,
     equal outputs) in turns, device time.
 13. The corpus and block paths (phase_corpus): eight 24-bit 96 kHz stereo
     files of make_music << 8 (60, 45, 30, 20, 10, 5 and 1 s and 3001
     samples) at -m 4 -B 8192 -V 0, and 64 16-bit 44.1 kHz files of 1-8 s
     (make_music and make_segmented, distinct seeds; 8 mono, 4 << 1) at -m
     4 -B 4096 -V 0, each corpus encoded by encode_files(device="cuda"),
     counted: every stream byte-identical to host_encoder.encode of its
     file, K8, K7, K3, K4 and K5's pack_residual_sections once per batched
     group and call as derived here from the file list, fewer than the
     per-file encodes would make, and the block accounting over the
     corpus; decoded by decode_corpus_sharded([cuda]), counted: lossless,
     K2 once and K1 once per fused group (and K1 and K9 once more per
     group with LTP). Both again with devices=[cuda:0, cuda:0] (and with
     make_devices() where more than one card is visible): streams and PCM
     identical, shard_rows printed. The encode's host synchronisations are
     listed by source line (torch.cuda.set_sync_debug_mode). Then the block
     API: encode_block on 16 blocks of phase 3's audio (silent, RAW-sized,
     odd-length and raw-fallback noise among them) equal to the host's
     one-span encode; decode_block over every block of phase 3's and phase
     4's streams and StreamingDecoder over phase 4's (seek and resume):
     lossless, K2 and K1 once per COMPRESS block and K9 (with K1 once more)
     once per LTP block; the player (srla_tpu_torch.tools.srla_player
     --sink null --device cuda) once, counted. Prints the warm best of 3
     of both corpus encodes and decodes beside a loop of per-file
     encode_whole and decode, and the block paths' blocks per second.
 14. The decode to device-resident PCM (decode_whole_device_resident, K13:
     csrc/verify.cu) on phase 3's stream, phase 4's, phase 8's -V 3 stream,
     the hi-res corpus of phase 13 fused into one virtual stream (16.4 M
     samples a channel, expected 131 MB on the card) and 10 s of make_music
     with a silent and a full-scale noise second, counted: True, every
     COMPRESS block on the device, K2 and K13 once a group; K13 equal to
     its plain version on every group of each (as decoded, one sample of a
     row flipped, that row not ok); False for one flipped sample in a
     COMPRESS, a RAW and a SILENT block; phase 3's stream over two shards
     (K13 once a shard); its host synchronisations by line: uploads and
     one flag fetch a device, no PCM fetch. Prints the warm best of 3 of
     the resident decode beside decode_whole's on phase 3's stream, a
     profile of one resident decode, and K13 at the 1291-block group
     beside its plain version, its bound and one torch.equal of the same
     spans, and at the stream's 1-block tail group.
 15. The f32 approximate encode (SRLAEncoder(..., approx=True), the
     port's SRLA_TPU_APPROX=1): K14 (the f32 Levinson recursion, order
     choice and quantization, csrc/lpc_analyze_f32.cu) and K15 (the f32
     Rice cost, csrc/rice_cost.cu) against their plain versions, bit for
     bit on every output, on the inputs the approximate analysis of the
     main group (V 5164, n 4096, M 64, partition orders 0..10) and of the
     tail group (V 4, n 4064, orders 0..5) gives them, and on odd shapes
     (k14_odd_lags at M 1, 7, 64 and 255, searched and fixed orders, with
     silent rows and a half-even tie; k15_odd_rows at n 6, 512, 4064 and
     4096 with 24-bit full-range, int32-extreme, ALLZERO and mean-2 rows),
     each timed (CUDA events, device time by graph replay) beside its
     bound on these inputs and its plain version. Then phase 3's 120 s at
     -m 4 -B 4096 -V 0, at the CLI's -V 1 -L 4 and at -V 0 -P 3, each
     encoded approximately on the card, counted (K16's f32 entry, K14, K15,
     K3 and K5 once a group, -V 1's measurement calls adding K16's f32
     entry, K14, K15 and K3, K18 once a group at -P 3; K8, K7, K4, K10 and
     K16's exact entry never; a tripwire on the plain versions of K14,
     K15, K16's f32 entry and K18, the torch variant stack and span cut):
     lossless through decode(..., "cuda"), at most 1.02 times the exact
     stream's size, every COMPRESS block from the device, none on the host
     or repaired, every -V span measured on the device; each encode's warm
     best of 3 beside the exact encode's, and the step split at -V 0, -V 1
     -L 4 and -V 0 -P 3. Last, parallel.full_step_sharded over [cuda:0,
     cuda:0] on the main group's rows: residual and bits equal to one
     analyze_variants call. Each approximate stream's length is the one APPROX_BYTES
     records; K17 and K5's row entry launched once a group (K17's
     measurement entry once a -V call), no plain version of K17 or K5
     reached.
 16. (Run after phase 5.) The exact encode's last stages: K16 (the variant
     stack and exact pre-emphasis, csrc/preemphasis.cu), K17 (the bit
     accounting and stereo selection, csrc/select.cu, and its measurement
     entry), K18 (the LTP residual, csrc/ltp_predict.cu) and K5's row
     entry (the chosen rows read by index and zigzagged as they load)
     against their plain versions, bit for bit on every output, at the
     main group's and the tail group's inputs as the encode hands them
     over (K16 on the resident file's spans and on the block tensor, K18
     at -P 3) and at odd shapes (k16_cases: n 333 at C 1 and 3, unaligned
     spans, int32 extremes, half boundaries flagged; k17_small at M 8 to
     255: ties, clamped codes, wrapping sums, raw blocks, sections above
     W; k18_cases: periods 8 and 262, the delay past n, order 1; K5's
     rows at 12 x 334, not 16-byte aligned, and 40 x 512 at porders
     0..9); each timed (CUDA events, graph replay) beside its plain
     version and its bound, K5's row entry beside the work it replaced
     (zigzag32 of every row, the gather, the gathered entry); K16 also at
     k16_layout_cases (n 1 to 16384, C 1 to 8, odd offsets, a strided
     view) beside a copy of its bytes, K17 also at K17_EDGES, 100
     launches back to back and 6 replays of a captured launch on new
     inputs, beside an empty kernel on its grid (the card's floor). K16's
     f32 entry (variant_preemphasis_f32, the approximate analysis'
     pre-emphasis) against its plain version on the same groups and
     cases, the rows' (V, 1, n) view and 24-bit rows of 16384 (r0 above
     2^53), timed beside its plain version, its bound and the torch stack
     and f32 pre-emphasis it replaced (and, with --parent, the parent's
     in turns). Phases 6,
     8, 9, 11, 12, 13 and 15 count K16, K17's two entries and K18 as they
     count K3, and run their encodes with every plain version of K16,
     K17, K18 and K5's section entry replaced by a tripwire.
 18. The work-stealing hybrid encode (SRLAEncoder(..., hybrid=True,
     host_workers=k)) and the host decode: the 120 s file at -V 0 and at
     the CLI's defaults (-V 1) with no hybrid and with 1, 4 and
     (cores - 1) host threads, each stream equal to the device-only one,
     the routing invariant with stolen_blocks, blocks stolen at k >= 1
     (the host's first chunk, taken before a rate is known), K16, K8, K7,
     K3, K4, K17 and K5 launched once an encode call (counted, and seen by
     torch.profiler), no plain version reached; warm best of 3 on fresh
     encoders and on one warm encoder (its rates kept) beside
     host_encoder.encode with k threads alone. The approximate hybrid at
     -V 0: lossless, within 1.02 of the exact size. host_decoder.decode
     (the native whole-stream decode) of phase 3's and phase 4's streams:
     the card's PCM and the source, warm best of 3 beside decode_whole.

Prints the card's name and power limit, the build time, the warm decode and
encode speeds (x realtime) and each kernel's time beside its plain
version's, its bound and, where one PyTorch call computes the same function,
that call's time; then one JSON line describing the kernels (``launches``
counted on phases 3, 6 and 7, K9's on phase 4 and K10's on phase 9's
-V 0 encode, K8's and K7's on phase 6's, K11's, K12's and K7's two SVR
entries' (records lpc_coefs and lpc_quantize) on phase 12's full-width
encode, 0 for K12's first design (svr_refine_v1, a measurement aid),
K13's
on phase 14's resident decode of phase 3's stream, K16's and K17's on
phase 6's, K17's measurement entry's on phase 8's -V 1 encode of the
music, K18's on phase 9's -V 0 -P 3 encode; K5's fused entry's times are
its row entry's (phase 16), its gathered entry's beside them;
``launches_variable`` on each of phase 8's three paths, ``launches_ltp`` on
phase 4's, 9's and 11's, ``launches_svr`` on phase 12's five,
``launches_corpus`` on phase 13's paths, encode and decode apart,
``launches_resident`` on phase 14's, ``launches_approx`` on phase 15's
three encodes, ``launches_hybrid`` on phase 18's, by host thread count;
K14's, K15's and K16's f32 entry's ``launches`` on phase 15's -V 0
encode; K19's and K1's coefficient entry's on phase 3's decode,
K1's record counting the kernel's launches by both entries
(``launches_by_entry``); K7's
record also carries its SVR entries' launches on phase 12's full-width
encode and the coefficient entry's agreement with its plain version)
and, last, the device JSON line. A kernel's bound is the larger of the
bytes it must move over 3.35 TB/s and the 32-bit integer
instructions its inputs need (a multiply-add is one) over the H100's INT32
issue rate: 132 SMs x 64 INT32 lanes x 1.98 GHz = 16.7 T/s, a quarter of
the 67 T/s non-tensor float32 rate, which counts a fused multiply-add as
two. K1 and K2 are recurrences, so each also gets a serial floor: its
samples (K1, per row) or codewords
(K2, per block; C * n, one per sample) times the time one warp takes for
the shortest dependent step alone, measured in the same run.
K7's and K10's operations are f64, over the H100's 34 TFLOP/s outside the
tensor cores; K8's run on the f64 tensor cores, 67 TFLOP/s; K11's and
K12's are counted as f64 instructions (unfused multiplies and adds, one
issue slot each) over 17 T/s, K14's as f32 instructions over 33.5 T/s
(half the 67 TFLOP/s f32 rate, which counts a fused multiply-add as two),
K15's as 32-bit integer instructions as K4's are. K7 also gets a
serial floor: the recursion's M - 1 steps of the shortest dependent chain
of one step (chain_probe.cu's kind 3: an 8-lane butterfly and the
division, K7's step at M <= 64).
K9 gets a serial floor too: the steps of its row with the most (ceil((n -
delay - 1) / w)) times one K9 step alone (chain_probe.cu's kind 4), and
K10 one solve's chain (kind 5).
K3, K4, K5, K6, K9, K10 and K13 also get a device time (device_ms): at
their smaller shapes the host needs longer to enqueue a call than the card
to run it, so the calls are captured into one CUDA graph and the replay is
timed. K3 and
K5's fused entry also get copy_ms, the device time of one copy that moves
as many bytes as their bound counts.
With --parent DIR (a checkout of another commit, such as the parent's
``git archive``) it first runs srla_tpu_torch/tools/kernel_ab.py in DIR
and here in turns (DIR, here, here, DIR, each its own process), by default
and with --stages, and prints the device times of K7's quantization entry
and the generic pack of each beside phase 12's and phase 5's own, K16's
and K17's and K16's f32 entry's (the parent: its torch f32 pre-emphasis)
beside phase 16's, and K19's (the parent: its torch-op tail) beside phase
17's; without it they read "not measured".
Any failed check raises and the exit code is non-zero; without a CUDA device
it exits non-zero before printing any result. Imports nothing of JAX and
nothing of srla_tpu.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SAMPLE_RATE = 44100
MAIN_SECONDS = 120.0
LTP_SECONDS = 120.0              # phase 4's -m 6 -P 3 stream
VAR_SECONDS = 30.0               # the segmented signal of phase 8
VAR2_SECONDS = 10.0              # its part that phase 8 encodes at -V 2
LTP2_SECONDS = 20.0              # phase 3's part that phase 9 takes at -V 2
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
# H100 SXM: 132 SMs, 64 INT32 results per clock per SM for add, shift,
# logic and multiply-add (compute capability 9.0), 1.98 GHz boost clock.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# H100 SXM f64 outside the tensor cores: 34 TFLOP/s (data sheet), a fused
# multiply-add counted as two; on the f64 tensor cores (DMMA), 67 TFLOP/s.
F64_OPS_PER_S = 34e12
F64_TENSOR_OPS_PER_S = 67e12
K6_ROWS = 4096


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call of fn over reps calls (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call of fn with reps calls captured into one
    CUDA graph and the graph replayed: the device's time for the calls back
    to back. Unlike cuda_ms it leaves out the host's time to enqueue a
    call, which at small sizes exceeds the kernel's."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return cuda_ms(torch, graph.replay, 5) / reps


# Filled by main() from --parent DIR: the device times of K7's
# quantization entry and the generic pack in the parent checkout and in
# this one, in turns (tools/kernel_ab.py).
PARENT_AB: dict = {}


def parent_runs(key: str, mode: str = "runs") -> list:
    """[(checkout, device ms)] of one kernel in turns (``mode``: "runs",
    tools/kernel_ab.py's default, or "stages", its --stages), or []
    without --parent."""
    return [(r["root"], r[f"{key}_device_ms"]) for r in PARENT_AB.get(
        mode, [])]


def parent_text(key: str, mode: str = "runs") -> str:
    runs = parent_runs(key, mode)
    if not runs:
        return ("the parent in turns: not measured (chip_smoke.py --parent "
                "DIR)")
    return ("in turns, each checkout its own process (device time, ms): "
            + ", ".join(f"{root} {ms:.4f}" for root, ms in runs))


def max_abs_err(torch, got, want) -> int:
    """Largest difference of two integer tensors (or tuples of them, each
    pair of the same shape)."""
    if isinstance(got, tuple):
        return max(max_abs_err(torch, g, w) for g, w in zip(got, want))
    return int((got.long() - want.long()).abs().max().item())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved_bytes: float, ops: float,
          ops_per_s: float = INT32_OPS_PER_S) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their peak rate (32-bit integer
    instructions over the INT32 rate unless ``ops_per_s`` says another)."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                ops_ms=t_ops)


def copy_ms(torch, dev, moved_bytes: float) -> float:
    """Device time of one device-to-device copy that moves ``moved_bytes``
    (half read, half written), by CUDA graph replay: what this card's
    memory takes for a kernel's bytes, beside the bound at its peak rate."""
    src = torch.zeros(int(moved_bytes) // 8, dtype=torch.int32, device=dev)
    dst = torch.empty_like(src)
    return device_ms(torch, lambda: dst.copy_(src), 20)


def stream_blocks(stream: bytes) -> list[tuple[int, int]]:
    """(block type, samples) of each block of a stream, from its block
    headers."""
    from srla_tpu_torch.constants import HEADER_SIZE
    from srla_tpu_torch.format import decode_header, parse_block_header
    header = decode_header(stream)
    offset, progress, blocks = HEADER_SIZE, 0, []
    while progress < header.num_samples and offset < len(stream):
        btype, nsamples, poff, psize = parse_block_header(stream, offset)
        blocks.append((btype, nsamples))
        offset = poff + psize
        progress += nsamples
    return blocks


def compress_blocks(stream: bytes) -> int:
    """COMPRESS blocks in a stream, counted from its block headers."""
    from srla_tpu_torch.constants import BlockDataType
    return sum(t == BlockDataType.COMPRESS for t, _ in stream_blocks(stream))


def lpc_inputs(torch, np, dev, R: int, n: int, M: int, min_order: int,
               seed: int):
    """K1 arguments on the card: rows of order min_order..M plus, when
    R >= 5, edge rows (order 0, rshift 0, order M, int32-wrapping residuals
    and taps). Returns (lpc_scan's args, the fused de-emphasis' kwargs, the
    coefficients left-aligned as the decode's packed parameters hold them:
    an (R, M) view of an (R, M + 5) array, for K1's coefficient entry)."""
    from srla_tpu_torch.kernels.lpc import align_coefs

    rng = np.random.RandomState(seed)
    res = rng.randint(-30000, 30000, (R, n))
    orders = rng.randint(min_order, M + 1, R)
    coefs = rng.randint(-(1 << 15), 1 << 15, (R, M))
    rshifts = rng.randint(1, 16, R)
    if R >= 5:
        orders[0] = 0                     # order 0 passes residuals through
        rshifts[1] = 0                    # rshift 0: half = INT_MIN
        orders[2] = M                     # full-order row
        res[3:5] = rng.randint(-(1 << 30), 1 << 30, (2, n))  # int32 wrapping
        coefs[3:5] = rng.randint(-(1 << 30), 1 << 30, (2, M))
    dcoef = rng.randint(0, 16, R)
    dprev = rng.randint(-30000, 30000, R)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    ord_t = t(orders)
    packed = np.zeros((R, M + 5), np.int64)
    packed[:, 2:2 + M] = coefs
    left = t(packed)[:, 2:2 + M]
    args = (t(res), align_coefs(left, ord_t, M), ord_t, t(rshifts), n, M)
    return args, dict(dcoef=t(dcoef), dprev=t(dprev)), left


INT32_EDGES = (-(1 << 31), (1 << 31) - 1, -(1 << 31) + 1, -1, 0, 1,
               1 << 30, -(1 << 30))


def synth_inputs(np, B: int, C: int, n: int, M: int, seed: int,
                 ltp: bool = False, width: int = 0):
    """numpy inputs of decode2.synthesize for a group of B blocks of C
    channels, n samples, max order M: (res, orders, rshifts, meta, cols,
    methods) with the coefficients and methods inside one (B, K) int32
    array as the decode packs them (``meta``, K at least C * M + width
    past them; ``cols`` its column offsets), so that their views are
    strided. Orders 0..M (0 and M in every group), rshifts 0..15; methods
    0-3, each in a group of 4 or more; LTP rows (ltp) of order 0, 1 and 3
    at periods 0, 8 and up to 262. Block 0's rows are order 0 with
    de-emphasis 0, so K1 hands its residuals, int32 extremes among them,
    to the stereo inverse as they are."""
    rng = np.random.RandomState(seed)
    res = rng.randint(-30000, 30000, (B, C, n)).astype(np.int32)
    res[0] = rng.choice(INT32_EDGES, (C, n))
    if B > 1:
        res[1] = rng.randint(-(1 << 31), 1 << 31, (C, n), dtype=np.int64)
    orders = rng.randint(0, M + 1, (B, C)).astype(np.int32)
    orders.flat[1 % orders.size] = M
    orders[0] = 0
    rshifts = rng.randint(0, 16, (B, C)).astype(np.int32)
    cols = {"method": 0, "coefs": 2, "ltp_orders": 2 + C * M + width}
    K = cols["ltp_orders"] + 3 * C + 2
    meta = np.zeros((B, K), np.int32)
    meta[:, 1] = rng.randint(-5, 5, B)          # a neighbour column
    meta[:, 0] = rng.permutation(np.arange(B) % 4)
    meta[:, 2:2 + C * M] = rng.randint(-(1 << 13), 1 << 13, (B, C * M))
    if B > 2:
        meta[2, 2:2 + C * M] = rng.randint(-(1 << 30), 1 << 30, C * M)
    pre_coef = rng.randint(-16, 16, (B, C)).astype(np.int32)
    pre_coef[0] = 0
    pre_prev = rng.randint(-30000, 30000, (B, C)).astype(np.int32)
    lo = np.zeros((B, C), np.int32)
    lp = np.zeros((B, C), np.int32)
    lc = np.zeros((B, C, 3), np.int32)
    if ltp:
        lo = rng.choice([0, 1, 3, 3], (B, C)).astype(np.int32)
        lp = rng.choice([0, 8, 9, 31, 100, 262], (B, C)).astype(np.int32)
        lc = rng.randint(-32, 32, (B, C, 3)).astype(np.int32)
    return dict(res=res, orders=orders, rshifts=rshifts, meta=meta,
                cols=cols, ltp_orders=lo, ltp_periods=lp, ltp_coefs=lc,
                pre_coef=pre_coef, pre_prev=pre_prev)


def synth_args(torch, np, inp: dict, dev, C: int, M: int):
    """decode2.synthesize's arguments from synth_inputs on ``dev``: the
    coefficients (B, C, M) and the methods (B,) as strided views of the
    packed array, the rest contiguous."""
    meta = torch.from_numpy(inp["meta"]).to(dev)
    B = meta.shape[0]
    o = inp["cols"]["coefs"]
    t = {k: torch.from_numpy(np.ascontiguousarray(inp[k])).to(dev)
         for k in ("res", "orders", "rshifts", "ltp_orders", "ltp_periods",
                   "ltp_coefs", "pre_coef", "pre_prev")}
    coefs = meta[:, o:o + C * M].view(B, C, M)
    methods = meta[:, inp["cols"]["method"]]
    return (t["res"], t["orders"], t["rshifts"], coefs, t["ltp_orders"],
            t["ltp_periods"], t["ltp_coefs"], t["pre_coef"], t["pre_prev"],
            methods)


def k19_inputs(torch, np, dev, B: int, C: int, n: int, method, seed: int,
               strided: bool = True):
    """K19's inputs on ``dev``: y (B, C, n) int32 of full-range values with
    int32 extremes in block 0, methods (B,) int32 (``method``: one for
    every block, or None for 0-3 mixed) as a strided column of a (B, 3)
    array or contiguous."""
    rng = np.random.RandomState(seed)
    y = rng.randint(-(1 << 31), 1 << 31, (B, C, n), dtype=np.int64)
    y[0] = rng.choice(INT32_EDGES, (C, n))
    m = (rng.randint(0, 4, B) if method is None
         else np.full(B, method)).astype(np.int32)
    packed = np.zeros((B, 3), np.int32)
    packed[:, 1] = m
    packed[:, 0] = rng.randint(-9, 9, B)
    packed[:, 2] = rng.randint(-9, 9, B)
    mt = torch.from_numpy(packed).to(dev)[:, 1]
    if not strided:
        mt = mt.contiguous()
    return torch.from_numpy(y.astype(np.int32)).to(dev), mt


def chain_step_ms(torch, kind: int) -> float:
    """Milliseconds one warp needs for one step of a serial chain alone
    (csrc/chain_probe.cu: kind 0 a K1 sample, kind 1 a K2 codeword, kind 2
    the Levinson step of K7's first design, kind 3 K7's step at M <= 64,
    kind 4 a K9 step, kind 5 K10's solve, kind 6 a K12 chain's f64 add,
    kind 7 a step of K7's quantization, kinds 8-13 a K14 recursion step
    at K14_STEP_KINDS' lanes and registers):
    the difference of two chain lengths over their difference, CUDA
    events."""
    import ctypes

    from srla_tpu_torch.kernels import build
    fn = build.load("chain_probe").srla_chain_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
                   ctypes.c_void_p, ctypes.c_void_p]
    out = torch.empty(32, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(steps):
        err = fn(kind, steps, 0x9E3779B1, 0x2545F491, out.data_ptr(), stream)
        require(err == 0, f"chain probe launch failed ({err})")

    short, long_ = 1 << 14, 1 << 16
    run(short)
    t_short = cuda_ms(torch, lambda: run(short), 5)
    t_long = cuda_ms(torch, lambda: run(long_), 5)
    return (t_long - t_short) / (long_ - short)


def phase_lpc(torch, np, dev):
    """K1 against its plain version at 256 taps (orders 200..256), at the
    tail group's shape (2 rows of 4064 samples) and at the main-path shape,
    with and without fused de-emphasis; K1's coefficient entry on the same
    inputs read as a strided view of left-aligned coefficients, equal to
    the aligned entry; times the main and the tail shape. Returns the
    kernel's JSON record without its launch count, and the coefficient
    entry's main and tail arguments."""
    from srla_tpu_torch.kernels.lpc import (lpc_scan, lpc_scan_coefs,
                                            lpc_scan_plain)

    err, shapes = 0, {}
    for R, n, M, min_order in ((264, 4096, 256, 200), (2, 4064, 64, 1),
                               (2584, 4096, 64, 1)):
        args, fused, left = lpc_inputs(torch, np, dev, R, n, M, min_order,
                                       seed=M)
        for kw in ({}, fused):
            got = lpc_scan(*args, **kw)
            want = lpc_scan_plain(*args, **kw)
            coefs_got = lpc_scan_coefs(args[0], left, *args[2:], **kw)
            torch.cuda.synchronize()
            e = max(max_abs_err(torch, got, want),
                    max_abs_err(torch, coefs_got, want))
            require(e == 0, f"K1 (or its coefficient entry) differs from "
                            f"its plain version at R={R} M={M} "
                            f"(fused={bool(kw)}, max abs err {e})")
            err = max(err, e)
        shapes[R] = (args, fused, left)
        print(f"phase 1 K1 lpc_synth and its coefficient entry: bit-equal "
              f"to plain at R={R} n={n} M={M}, orders {min_order}..{M}, "
              f"with and without fused de-emphasis")
    args, fused, _ = shapes[2584]
    tail_args, tail_fused, _ = shapes[2]
    ms = cuda_ms(torch, lambda: lpc_scan(*args, **fused), 20)
    tail_ms = cuda_ms(torch, lambda: lpc_scan(*tail_args, **tail_fused), 20)
    plain_ms = cuda_ms(torch, lambda: lpc_scan_plain(*args, **fused), 1)
    res, aligned, orders = args[0], args[1], args[2]
    R, n = res.shape
    # Read residuals, taps, order, shift and the two de-emphasis scalars
    # once, write the samples once; a multiply-add per tap and sample, and
    # the rounding, shift, subtraction and de-emphasis per sample.
    b = bound(nbytes(*args[:4], *fused.values()) + nbytes(res),
              n * (int(orders.long().sum()) + 6 * R))
    # Each row's samples wait on each other: n steps of the shortest chain.
    step = chain_step_ms(torch, 0)
    floor_ms, tail_floor_ms = n * step, tail_args[0].shape[1] * step
    print(f"phase 1 K1 lpc_synth at R={R} n={n} M={aligned.shape[1]} "
          f"(+fused de-emphasis): kernel {ms:.4f} ms, plain {plain_ms:.2f} "
          f"ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}; operations "
          f"{b['ops_ms']:.4f} ms), serial floor {floor_ms:.4f} ms "
          f"({step * 1e6:.3f} ns a sample); tail R=2 n=4064: kernel "
          f"{tail_ms:.4f} ms, serial floor {tail_floor_ms:.4f} ms")
    return dict(name="lpc_synth", route="cuda",
                source="srla_tpu_torch/kernels/csrc/lpc_synth.cu",
                replaces="srla_tpu/kernels/pallas_lpc.py:102",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, **b,
                library_ms=None, tail_ms=tail_ms, serial_floor_ms=floor_ms,
                tail_serial_floor_ms=tail_floor_ms), err


def phase_rice(torch, dev, stream: bytes):
    """K2 against its plain version on every block group of ``stream``;
    times the kernel on the largest group (ms) and on the smallest (the
    tail group, tail_ms), the plain version on the largest."""
    from srla_tpu_torch.decoder import SRLADecoder, upload_stream
    from srla_tpu_torch.kernels.decode2 import meta_cols
    from srla_tpu_torch.kernels.rice_decode import (rice_decode,
                                                    rice_decode_plain)

    header, _, groups = SRLADecoder(dev).plan(stream)
    C = header.num_channels
    words = upload_stream(stream, dev)
    err, cases = 0, []
    for g in groups:
        cols, _ = meta_cols(C, g.M, 3)
        meta = torch.from_numpy(g.meta).to(dev)
        ws = meta[:, cols["word_start"][0]].contiguous()
        br = meta[:, cols["bit_rem"][0]].contiguous()
        args = (words, ws, br, g.n, C, g.W)
        got = rice_decode(*args)
        want = rice_decode_plain(*args)
        torch.cuda.synchronize()
        e = max_abs_err(torch, got, want)
        require(e == 0, f"K2 differs from its plain version on the "
                        f"{len(g.starts)}-block group of n={g.n}")
        err = max(err, e)
        cases.append((len(g.starts), g, args))
    cases.sort(key=lambda c: c[0])
    _, g, args = cases[-1]
    _, tail_g, tail_args = cases[0]
    ms = cuda_ms(torch, lambda: rice_decode(*args), 20)
    tail_ms = cuda_ms(torch, lambda: rice_decode(*tail_args), 20)
    plain_ms = cuda_ms(torch, lambda: rice_decode_plain(*args), 1)
    # Read the stream words and each block's start once, write the samples
    # once; at least a peek, a count of leading zeros, a shift and the
    # unzigzag per decoded sample.
    B = len(g.starts)
    b = bound(nbytes(*args[:3]) + 4 * B * C * g.n, 4 * B * C * g.n)
    # A block's codewords wait on each other: at least C * n of them (one
    # per sample; the partitions' k deltas come on top) times the shortest
    # chain of one codeword.
    step = chain_step_ms(torch, 1)
    floor_ms, tail_floor_ms = C * g.n * step, C * tail_g.n * step
    print(f"phase 2 K2 rice_decode: bit-equal to plain on {len(groups)} "
          f"groups; at B={B} C={C} n={g.n}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.2f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}; operations {b['ops_ms']:.4f} ms), serial floor "
          f"{floor_ms:.4f} ms ({step * 1e6:.3f} ns a codeword); tail "
          f"B={len(tail_g.starts)} n={tail_g.n}: kernel {tail_ms:.4f} ms, "
          f"serial floor {tail_floor_ms:.4f} ms")
    return dict(name="rice_decode", route="cuda",
                source="srla_tpu_torch/kernels/csrc/rice_decode.cu",
                replaces="srla_tpu/kernels/decode2.py:218",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, **b,
                library_ms=None, tail_ms=tail_ms, serial_floor_ms=floor_ms,
                tail_serial_floor_ms=tail_floor_ms)


def k19_bound(y, methods, lshift: int) -> dict:
    """K19's bound on this run's data: the bytes the in-place pass must
    move (a block's rows 0 and 1 read where its method changes them, each
    changed row written; every row of every channel read and written when
    lshift is not 0) and about four integer instructions a sample of each
    pair it changes. ``full`` adds the bound of a pass over every row read
    and written once."""
    B, C, n = y.shape
    m = methods.long().cpu()
    if lshift != 0:
        rows_read = rows_written = B * C
        pairs = B if C >= 2 else 0
    elif C >= 2:
        changed = int(((m >= 1) & (m <= 3)).sum())
        rows_read = 2 * changed
        rows_written = 2 * int((m == 1).sum()) + int(((m == 2) | (m == 3))
                                                     .sum())
        pairs = changed
    else:
        rows_read = rows_written = pairs = 0
    b = bound(4 * n * (rows_read + rows_written), 4 * n * pairs)
    b["full_bound_ms"] = bound(2 * nbytes(y), 4 * n * B)["bound_ms"]
    return b


def phase_synth_tail(torch, np, dev, stream: bytes, card: str):
    """Phase 17 (run after phase 2): the decode's synthesis on the card on
    phase 3's stream, each group's own inputs. K1's coefficient entry
    (lpc_scan_coefs: the coefficients read where the packed parameters
    hold them) equal to K1's aligned entry on align_coefs' taps; K19
    (synth_tail: the stereo inverse and offset shift) on K1's output and
    the methods column of the packed parameters (a strided view), in place
    and out of place, bit-equal to synth_tail_plain; then K19 at odd cases
    (k19_inputs: n 333, C 1, 3 and 8, each method alone and mixed, lshift
    0, 1 and 8, int32 extremes, a strided and a contiguous methods view).
    Times K19 and K1's coefficient entry at the main (1291 blocks of 4096)
    and tail (1 block of 4064) groups beside their plain versions and
    bounds (K19's parent in turns from kernel_ab --stages where given),
    and lists by torch.profiler the device work of synthesize on the main
    group and on a synthetic LTP group: only K1, K9 and K19. Returns the
    records of K19 and of K1's coefficient entry (without launches)."""
    from srla_tpu_torch.decoder import SRLADecoder, upload_stream
    from srla_tpu_torch.kernels.decode2 import (meta_cols, synth_tail,
                                                synth_tail_plain, synthesize)
    from srla_tpu_torch.kernels.lpc import (align_coefs, lpc_scan,
                                            lpc_scan_coefs, lpc_scan_plain)
    from srla_tpu_torch.kernels.rice_decode import rice_decode

    t_phase = time.perf_counter()
    header, _, groups = SRLADecoder(dev).plan(stream)
    C, lshift = header.num_channels, header.offset_lshift
    words = upload_stream(stream, dev)
    err1 = err19 = 0
    cases = []
    for g in groups:
        cols, _ = meta_cols(C, g.M, 3)
        meta = torch.from_numpy(g.meta).to(dev)
        B, R, n = meta.shape[0], meta.shape[0] * C, g.n

        def col(name, shape=()):
            o, w = cols[name]
            v = meta[:, o:o + w]
            return (v.reshape((B,) + shape) if shape else v[:, 0])

        res = rice_decode(words, col("word_start").contiguous(),
                          col("bit_rem").contiguous(), n, C, g.W)
        coefs = col("coefs", (C, g.M))
        orders = col("orders", (C,)).reshape(R).contiguous()
        k1 = (res.reshape(R, n), coefs, orders,
              col("rshifts", (C,)).reshape(R).contiguous(), n, g.M)
        kw = dict(dcoef=col("pre_coef", (C,)).reshape(R).contiguous(),
                  dprev=col("pre_prev", (C,)).reshape(R).contiguous())
        y = lpc_scan_coefs(*k1, **kw)
        aligned = (k1[0], align_coefs(coefs.reshape(R, -1), orders, g.M),
                   *k1[2:])
        e = max_abs_err(torch, y, lpc_scan(*aligned, **kw))
        require(e == 0, f"K1's coefficient entry differs from the aligned "
                        f"entry on the {B}-block group (max abs err {e})")
        err1 = max(err1, e)
        y = y.reshape(B, C, n)
        methods = col("method")
        require(methods.stride(0) == meta.shape[1], "methods not strided")
        want = synth_tail_plain(y, methods, lshift)
        out = torch.empty_like(y)
        e = max(max_abs_err(torch, synth_tail(y, methods, lshift, out=out),
                            want),
                max_abs_err(torch, synth_tail(y.clone(), methods, lshift),
                            want))
        require(e == 0, f"K19 differs from its plain version on the "
                        f"{B}-block group (max abs err {e})")
        err19 = max(err19, e)
        cases.append((B, y, methods, k1, kw, aligned, g, meta, cols))
    cases.sort(key=lambda c: c[0])
    odd = []
    for n in (333, 4096):
        for method in (0, 1, 2, 3, None):
            for sh in (0, 1, 8):
                odd.append((9, 2, n, method, sh, True))
    odd += [(5, 1, 333, None, 0, True), (5, 1, 4096, None, 8, False),
            (5, 3, 333, None, 1, True), (5, 3, 4096, None, 0, False),
            (5, 8, 333, None, 8, True), (5, 8, 4064, None, 0, True),
            (1, 2, 4064, None, 0, False)]
    odd_dev = {}
    for i, (B, Cc, n, method, sh, strided) in enumerate(odd):
        y, m = k19_inputs(torch, np, dev, B, Cc, n, method, i, strided)
        want = synth_tail_plain(y, m, sh)
        out = torch.empty_like(y)
        e = max(max_abs_err(torch, synth_tail(y, m, sh, out=out), want),
                max_abs_err(torch, synth_tail(y.clone(), m, sh), want))
        require(e == 0, f"K19 differs from its plain version at B {B} C "
                        f"{Cc} n {n} method {method} lshift {sh}")
        err19 = max(err19, e)
        if method is None and sh == 8 and n in (333, 4096) and Cc in (2, 8):
            odd_dev[f"B{B}_C{Cc}_n{n}_lshift8"] = device_ms(
                torch, lambda: synth_tail(y, m, sh, out=out), 20)

    def timed_tail(case):
        B, y, m = case[:3]
        buf = y.clone()
        return dict(ms=cuda_ms(torch, lambda: synth_tail(buf, m, lshift), 20),
                    device_ms=device_ms(torch, lambda: synth_tail(
                        buf, m, lshift), 20))

    main, tail = cases[-1], cases[0]
    B, y, m = main[:3]
    t19, t19_tail = timed_tail(main), timed_tail(tail)
    plain_ms = cuda_ms(torch, lambda: synth_tail_plain(y, m, lshift), 5)
    plain_dev = device_ms(torch, lambda: synth_tail_plain(y, m, lshift), 5)
    b19 = k19_bound(y, m, lshift)
    mh = {int(k): int(v) for k, v in zip(*np.unique(m.cpu().numpy(),
                                                     return_counts=True))}
    copy = copy_ms(torch, dev, 2 * nbytes(y))
    print(f"phase 17 K19 synth_tail: bit-equal to plain (in place and out "
          f"of place) on the {len(cases)} groups of phase 3's stream and at "
          f"{len(odd)} odd cases; main group B={B} C={C} n={y.shape[2]} "
          f"(methods {mh}, lshift {lshift}): kernel {t19['ms']:.4f} ms, "
          f"device time {t19['device_ms']:.4f} ms, plain (the torch ops "
          f"synthesize ran before) {plain_ms:.4f} ms, device time "
          f"{plain_dev:.4f} ms, bound {b19['bound_ms']:.4f} ms "
          f"({b19['bound_by']}; every row read and written "
          f"{b19['full_bound_ms']:.4f} ms; a copy of those bytes "
          f"{copy:.4f} ms); tail B={tail[0]} n={tail[1].shape[2]}: kernel "
          f"{t19_tail['ms']:.4f} ms, device time "
          f"{t19_tail['device_ms']:.4f} ms; odd shapes (device ms) "
          f"{ {k: round(v, 4) for k, v in odd_dev.items()} }; "
          + parent_text("k19_main", "stages") + f" [{card}]")

    # K1's coefficient entry at the main and tail groups.
    k1, kw, aligned = main[3:6]
    ms1 = cuda_ms(torch, lambda: lpc_scan_coefs(*k1, **kw), 20)
    dev1 = device_ms(torch, lambda: lpc_scan_coefs(*k1, **kw), 5)
    ms_al = cuda_ms(torch, lambda: lpc_scan(*aligned, **kw), 20)
    dev_al = device_ms(torch, lambda: (lpc_scan(
        k1[0], align_coefs(k1[1].reshape(k1[0].shape[0], -1), k1[2], k1[5]),
        *k1[2:], **kw)), 5)
    tk1, tkw = tail[3:5]
    tail1 = cuda_ms(torch, lambda: lpc_scan_coefs(*tk1, **tkw), 20)
    plain1 = cuda_ms(torch, lambda: lpc_scan_plain(
        *aligned, **kw), 1)
    R, n = k1[0].shape
    b1 = bound(nbytes(k1[0], k1[2], k1[3], *kw.values()) + nbytes(k1[0])
               + 4 * int(k1[2].long().clamp(max=k1[5]).sum()),
               n * (int(k1[2].long().sum()) + 6 * R))
    print(f"phase 17 K1's coefficient entry lpc_scan_coefs at the main "
          f"group (R={R}, n={n}, M={k1[5]}, fused de-emphasis): kernel "
          f"{ms1:.4f} ms, device time {dev1:.4f} ms; the aligned entry on "
          f"the aligned taps {ms_al:.4f} ms, with align_coefs' gather "
          f"before it (the decode's two steps before) device time "
          f"{dev_al:.4f} ms; plain (align_coefs + lpc_scan_plain) "
          f"{plain1:.2f} ms; bound {b1['bound_ms']:.4f} ms "
          f"({b1['bound_by']}); tail R={tk1[0].shape[0]}: kernel "
          f"{tail1:.4f} ms [{card}]")

    # synthesize's device work: only K1 (K9) and K19, on its arguments as
    # decode_blocks hands them over (made before the profiled call).
    Bm, _, mm, _, _, _, g, meta, cols = main

    def c(name, shape, strided=False):
        o, w = cols[name]
        v = meta[:, o:o + w].view((Bm,) + shape)
        return v if strided else v.contiguous()

    margs = (main[3][0].reshape(Bm, C, g.n), c("orders", (C,)),
             c("rshifts", (C,)), c("coefs", (C, g.M), True),
             c("ltp_orders", (C,)), c("ltp_periods", (C,)),
             c("ltp_coefs", (C, 3)), c("pre_coef", (C,)),
             c("pre_prev", (C,)), mm)
    inp = synth_inputs(np, 64, 2, 4096, 32, seed=17, ltp=True)
    largs = synth_args(torch, np, inp, dev, 2, 32)
    ours = ("lpc_synth_kernel", "ltp_synth_kernel", "synth_tail_kernel")
    lists = {}
    for what, fn in (("main group", lambda: synthesize(
            *margs, lshift, n=g.n, C=C, M=g.M, has_ltp=False)),
                     ("LTP group (B 64)", lambda: synthesize(
                         *largs, 1, n=4096, C=2, M=32, has_ltp=True))):
        split = profile_kernels(torch, fn, runs=1)
        other = [name for name, *_ in split
                 if not any(k in name for k in ours)]
        require(not other, f"synthesize on the {what} ran device work "
                           f"besides K1, K9 and K19: {other}")
        lists[what] = split
    print("phase 17 synthesize's device work by torch.profiler, one call: "
          + "; ".join(f"{what}: {split_text(split)}"
                      for what, split in lists.items())
          + f" (phase {time.perf_counter() - t_phase:.1f} s) [{card}]")
    rec19 = dict(name="synth_tail", route="cuda",
                 source="srla_tpu_torch/kernels/csrc/synth_tail.cu",
                 replaces="srla_tpu/kernels/decode2.py:503",
                 max_abs_err=err19, ms=t19["ms"],
                 device_ms=t19["device_ms"], plain_ms=plain_ms,
                 plain_device_ms=plain_dev, **b19, library_ms=None,
                 copy_ms=copy, tail_ms=t19_tail["ms"],
                 tail_device_ms=t19_tail["device_ms"], methods=mh,
                 odd=odd_dev,
                 parent_in_turns=parent_runs("k19_main", "stages"))
    rec1 = dict(name="lpc_synth_coefs", route="cuda",
                source="srla_tpu_torch/kernels/csrc/lpc_synth.cu",
                replaces="srla_tpu/kernels/decode2.py:513",
                also_replaces=["srla_tpu/kernels/pallas_lpc.py:102"],
                max_abs_err=err1, ms=ms1, device_ms=dev1, plain_ms=plain1,
                **b1, library_ms=None, tail_ms=tail1, aligned_entry_ms=ms_al,
                aligned_with_gather_device_ms=dev_al)
    return rec19, rec1


def profile_decode(torch, fn, what: str) -> None:
    """One warm call of fn (a decode) under torch.profiler, after one call
    in the profiler's warm-up step (a second profiler session in a process
    was seen to miss the first copies and kernels of its window): wall
    time, device time, the device time of the kernels that take the most,
    and of the codec's kernels and copies whatever their rank."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # The device's own events (kernels, copies); the CPU operators that
    # launched them carry the same time again, and so does the step's
    # marker.
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.key.startswith(("Activity Buffer",
                                               "ProfilerStep"))),
                    key=dev_us, reverse=True)
    total = sum(dev_us(e) for e in events)
    ours = ("Memcpy", "rice_decode_kernel", "lpc_synth_kernel",
            "ltp_synth", "verify_kernel", "synth_tail_kernel")
    shown = [e for i, e in enumerate(events) if dev_us(e) > 0 and (
        i < 8 or any(k in e.key for k in ours))]
    top = ", ".join(f"{e.key[:72]} {dev_us(e) / 1e3:.3f} ms x{e.count}"
                    for e in shown)
    print(f"{what} (torch.profiler, one warm decode): wall "
          f"{wall * 1e3:.1f} ms, device {total / 1e3:.3f} ms; {top}")


LIBRARIES = ("lpc_synth", "rice_decode", "fir_predict", "rice_search",
             "bitpack", "bitfield_probe", "ltp_synth", "ltp_analyze",
             "autocorr", "lpc_analyze", "svr_cov", "svr_refine", "verify",
             "lpc_analyze_f32", "rice_cost", "preemphasis", "select",
             "ltp_predict", "synth_tail")
# Measurement only: the serial floors, and the first designs of K8, K7, K9,
# K10 and K12.
PROBES = ("chain_probe", "autocorr_v1", "lpc_analyze_v1", "ltp_synth_v1",
          "ltp_analyze_v1", "svr_refine_v1")


def main_param():
    """-m 4 -B 4096 -V 0 for 16-bit stereo at 44.1 kHz."""
    from srla_tpu_torch.host_encoder import EncodeParameter
    return EncodeParameter(num_channels=2, bits_per_sample=16,
                           sampling_rate=SAMPLE_RATE, preset=4,
                           min_num_samples_per_block=4096)


def main_group(torch, np, dev, pcm, tail: bool = False):
    """The main path's 1291-block group of 4096 samples on the card (tail:
    its 1-block group of the samples left over), with the encoder's device
    arguments and section bound W for it."""
    from srla_tpu_torch import SRLAEncoder
    n = 4096
    B = pcm.shape[1] // n
    part = pcm[:, :B * n]
    if tail:
        part, B = pcm[:, B * n:], 1
        n = part.shape[1]
    blocks = np.ascontiguousarray(
        part.reshape(2, B, n).transpose(1, 0, 2), np.int16)
    enc = SRLAEncoder(main_param(), dev)
    return (torch.from_numpy(blocks).to(dev), B, enc._host._device_args(n),
            enc._section_words(n))


def check(torch, name, kernel, plain, args) -> int:
    """Kernel against its plain version on the same inputs: bit-equal.
    Returns max_abs_err."""
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    e = max_abs_err(torch, got, want)
    require(e == 0, f"{name} differs from its plain version "
                    f"(max abs err {e})")
    return e


def compare(torch, name, kernel, plain, args, reps: int = 20):
    """Kernel against its plain version on the same inputs: bit-equal, and
    both timed with CUDA events. Returns (max_abs_err, ms, plain_ms)."""
    e = check(torch, name, kernel, plain, args)
    ms = cuda_ms(torch, lambda: kernel(*args), reps)
    plain_ms = cuda_ms(torch, lambda: plain(*args), 2)
    return e, ms, plain_ms


def rice_search_args(core, args):
    """K4's arguments as the analysis of a group hands them over."""
    return core["residual"], args["n"], args["max_porder"]


def k4_odd_args(torch, np, dev):
    """K4 arguments whose finest partitions are one sample, shorter than a
    thread's run: 12 rows of 512 samples at partition orders 0..9, plain
    and recursive rows (Laplace scales 0.3 to 3e4), a full-range row
    (zigzag codes up to 2^32), an all-zero row and a row whose mean is 2
    exactly (flagged)."""
    n = 512
    rng = np.random.RandomState(0)
    scales = np.array([0.3, 0.9, 3.0, 40.0, 900.0, 3.0e4] * 2)
    res = rng.laplace(0, 1, (12, n)) * scales[:, None]
    res = res.astype(np.int64)
    res[1] = rng.randint(-(1 << 31), 1 << 31, n, dtype=np.int64)
    res[2] = 0
    res[3] = 1                                  # zigzag 2: mean 2
    return torch.from_numpy(res.astype(np.int32)).to(dev), n, 9


def k4_bound(args, out) -> dict:
    """K4's bound on this run's inputs: the residual read once and the
    outputs written once (the ks as int64); the integer instructions of the
    cheapest sequence sm_90 has for each term: a sample's zigzag (shift,
    shift, xor) and its 64-bit leaf-sum add (add, add with carry) once, then
    a sample and order 3 on the rows this data made recursive (one DPX
    add-max, shift, add) and 2 on the others (shift, add)."""
    res, n, max_porder = args
    V = res.shape[0]
    rec = int((out[0] == 1).sum())
    ops = (5 * V + (3 * rec + 2 * (V - rec)) * (max_porder + 1)) * n
    return bound(nbytes(res) + nbytes(*out), ops)


def k4_timed(torch, what: str, args) -> dict:
    """K4 against its plain version on ``args`` (every output), timed by
    CUDA events and by graph replay, beside its bound and its plain
    version."""
    from srla_tpu_torch.kernels.rice_search import (rice_search,
                                                    rice_search_plain)
    e, ms, pms = compare(torch, what, rice_search, rice_search_plain, args)
    b = k4_bound(args, rice_search(*args))
    return dict(rows=args[0].shape[0], n=args[1], max_porder=args[2],
                max_abs_err=e, ms=ms, plain_ms=pms,
                device_ms=device_ms(torch, lambda: rice_search(*args), 20),
                **b)


def k4_text(r: dict) -> str:
    return (f"V={r['rows']} n={r['n']} porders 0..{r['max_porder']}: "
            f"bit-equal to plain on every output, kernel {r['ms']:.4f} ms, "
            f"device time {r['device_ms']:.4f} ms (CUDA graph), plain "
            f"{r['plain_ms']:.2f} ms, bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']}; operations {r['ops_ms']:.6f} ms; device time "
            f"at {r['bound_ms'] / r['device_ms'] * 100:.0f} % of it)")


def fir_odd_args(torch, np, dev):
    """K3 arguments at a shape no tile fits: 11 rows of 333 samples (odd:
    three rows of four are not 16-byte aligned), M 12 (no multiple of the tap
    group), orders 0, 1, M and M + 1 (which reads as M), shifts 0 and 31,
    int32-sized samples and taps. Returns (kernel args, plain args): the
    plain version takes the clamped order."""
    from srla_tpu_torch.kernels.predict import reverse_coefs
    V, n, M = 11, 333, 12
    rng = np.random.RandomState(3)
    work = rng.randint(-(1 << 30), 1 << 30, (V, n))
    intc = rng.randint(-(1 << 30), 1 << 30, (V, M))
    orders = rng.randint(0, M + 1, V)
    rshifts = rng.randint(1, 16, V)
    orders[:5] = (0, 1, M, M, M)
    rshifts[2], rshifts[3] = 0, 31
    intc[np.arange(M)[None, :] >= orders[:, None]] = 0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    o = t(orders)
    above = o.clone()
    above[4] = M + 1
    rev = reverse_coefs(t(intc), o)
    return (t(work), rev, above, t(rshifts)), (t(work), rev, o, t(rshifts))


def section_odd_args(torch, np, dev):
    """pack_residual_sections arguments whose finest partitions are one
    sample (several parameter codewords inside a thread's run): 12 rows of
    512 samples at partition orders 0..9, both code types, a full-range
    row, a zero row, an ALLZERO row, parameters 0 (long unary leads), 30
    and 31, parameter deltas of up to 31, a skipped row; rows laid out with
    gaps between them. Returns (args, owned): ``owned`` marks the words of
    the buffer that a row owns."""
    from srla_tpu_torch.kernels.bitpack import residual_codewords
    V, n, maxp = 12, 512, 1024
    rng = np.random.RandomState(12)
    u = rng.randint(0, 1 << 12, (V, n)).astype(np.int64)
    ct = np.arange(V) % 2
    po = np.arange(V) % 10
    ks = rng.randint(5, 14, (V, maxp))
    u[1] = rng.randint(0, 1 << 32, n)
    ks[1] = rng.randint(27, 32, maxp)
    u[2] = 0
    u[3], ct[3] = 0, 2
    ks[4] = 0
    u[4] = rng.randint(0, 40, n)
    for row, k in ((5, 30), (6, 31), (7, 31)):
        u[row] = rng.randint(0, 1 << 32, n)
        ks[row] = k
    po[8] = po[9] = 9
    ks[9] = rng.randint(0, 32, maxp)
    u[9] = rng.randint(0, 1 << 8, n)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)

    _, total = residual_codewords(t(u), t(ct), t(po), t(ks), n)
    lens_w = (total + 31) // 32
    lens_w[10] = 0
    starts = torch.cumsum(lens_w + 3, 0) - lens_w
    cap = int(starts[-1] + lens_w[-1]) + 3
    owned = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    owned.index_add_(0, starts, torch.ones_like(starts))
    owned.index_add_(0, starts + lens_w, -torch.ones_like(starts))
    owned = torch.cumsum(owned, 0)[:cap] > 0
    return (t(u), t(ct), t(po), t(ks), n, starts, lens_w, cap), owned


def k5_edge_stream(np, count: int, seed: int):
    """A stream for the generic pack (offsets, tails, tbits, cap_w) as
    numpy int64 arrays, in random order: widths 0, 1..32 (32 often), 33,
    63, 64, 65, 100 and 2^33, random tails with no bit set above a width
    under 32, bit ranges disjoint (an entry of width w spans min(w, 64)
    bits, what the pack writes of it), entries at negative offsets (-1,
    -32, -2^40), at and past cap_w words, and straddling the last word."""
    rng = np.random.RandomState(seed)
    widths = rng.randint(1, 33, count)
    widths[rng.uniform(size=count) < 0.1] = 32
    widths[rng.uniform(size=count) < 0.05] = 0
    special = rng.choice(count, 12, replace=False)
    widths[special] = (33, 63, 64, 65, 100, 2 ** 33, 0, 32, 33, 64, 65, 100)
    span = np.minimum(widths, 64)
    offs = np.cumsum(span + rng.randint(0, 5, count)) - span
    tails = rng.randint(0, 1 << 32, count, dtype=np.int64)
    tails = np.where(widths < 32, tails & ((1 << np.minimum(widths, 32)) - 1),
                     tails)
    cap_w = int(offs[count * 9 // 10] >> 5) + 1   # the last tenth dropped
    # The last entry that starts in the last word straddles it: width 40.
    last = int(np.flatnonzero(offs >> 5 == cap_w - 1)[-1])
    widths[last] = 40
    offs[last + 1:] = np.maximum(offs[last + 1:], cap_w * 32 + 64)
    neg = rng.choice(count, 6, replace=False)
    offs[neg] = (-1, -32, -(1 << 40), -1, -5, -64)
    offs[rng.choice(count, 6, replace=False)] = cap_w * 32 + rng.randint(
        0, 1 << 20, 6)
    perm = rng.permutation(count)
    return offs[perm], tails[perm], widths[perm], cap_w


def profile_kernels(torch, fn, runs: int = 3) -> list:
    """RUNS calls of fn under torch.profiler (CUDA activity only), after a
    warm-up step: [(device kernel or copy, microseconds a call, its
    launches a call)] in the order of the first launch of each."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                 ) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        prof.step()
    split: dict = {}
    for e in sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start):
        name = (e.name.replace("(anonymous namespace)::", "")
                .replace("void ", "").split("(")[0])
        us, n = split.get(name, (0.0, 0))
        split[name] = (us + e.time_range.elapsed_us(), n + 1)
    return [(name, us / runs, n / runs) for name, (us, n) in split.items()]


def split_text(split: list) -> str:
    return ", ".join(f"{name[:60]} {us:.1f} us x{n:g}"
                     for name, us, n in split)


def check_sections(torch, what, args, image, owned=None) -> int:
    """K5's fused entry against its plain version on the words the rows
    own (the first sum(lens_w) of a compacted buffer, or ``owned``).
    Returns max_abs_err."""
    from srla_tpu_torch.kernels.bitpack import (pack_residual_sections,
                                                pack_residual_sections_plain)
    got = pack_residual_sections(*args, section_words=image)
    want = pack_residual_sections_plain(*args)
    torch.cuda.synchronize()
    if owned is None:
        total = int(args[6].sum())
        got, want = got[:total], want[:total]
    else:
        got, want = got[owned], want[owned]
    err = max_abs_err(torch, got, want)
    require(err == 0, f"K5 pack_residual_sections differs from its plain "
                      f"version {what} (max abs err {err})")
    return err


def section_args(torch, small, big, core, B, n, W, args):
    """K5's fused-entry arguments as the encode of a group of B blocks of
    n samples hands them over: the chosen rows of its analysis."""
    from srla_tpu_torch.kernels import exact
    from srla_tpu_torch.kernels.bitpack import zigzag32
    sel = exact.select_rows(small, B=B, C=2, n=n, bps=16, W=W,
                            max_params=args["max_params"])
    big32 = dict(big, u=zigzag32(core["residual"]))
    return sel, exact.chosen_sections(big32, sel, n, B * 2 * W)


def phase_encode_kernels(torch, np, dev, pcm):
    """K3, K4 and both K5 entries against their plain versions at the main
    path's shapes, at the tail group's and at a small odd shape each: the
    analysis of a group gives K3 and K4 their inputs, its selection gives
    K5 the chosen rows."""
    from srla_tpu_torch.kernels import exact
    from srla_tpu_torch.kernels.bitpack import (pack, pack_plain,
                                                pack_residual_sections,
                                                pack_residual_sections_plain)
    from srla_tpu_torch.kernels.predict import predict, predict_plain
    from srla_tpu_torch.kernels.rice_search import (rice_search,
                                                    rice_search_plain)

    blocks, B, args, W = main_group(torch, np, dev, pcm)
    n = args["n"]
    small, big, core = exact.variant_analysis(blocks, 0, **args)
    tail_blocks, _, tail_args, tail_W = main_group(torch, np, dev, pcm,
                                                   tail=True)
    tail_small, tail_big, tail_core = exact.variant_analysis(
        tail_blocks, 0, **tail_args)
    tail_n = tail_args["n"]
    V = core["work"].shape[0]
    recs = []

    def fir_args(c):
        return (c["work"], c["coefs"], c["orders"], c["rshifts"])

    k3, k3_tail = fir_args(core), fir_args(tail_core)
    e, ms, pms = compare(torch, "K3", predict, predict_plain, k3)
    tail_e, tail_ms, _ = compare(torch, "K3 (tail group)", predict,
                                 predict_plain, k3_tail)
    k3_odd, k3_odd_plain = fir_odd_args(torch, np, dev)
    got = predict(*k3_odd)
    torch.cuda.synchronize()
    odd_e = max_abs_err(torch, got, predict_plain(*k3_odd_plain))
    require(odd_e == 0, f"K3 differs from its plain version at the odd "
                        f"shape (max abs err {odd_e})")
    e = max(e, tail_e, odd_e)
    dev_ms = device_ms(torch, lambda: predict(*k3), 20)
    tail_dev_ms = device_ms(torch, lambda: predict(*k3_tail), 20)
    # Read the samples and each row's taps, order and shift once, write the
    # residual once; a multiply-add per tap and sample, rounding, shift and
    # subtraction per sample.
    moved = nbytes(*k3) + nbytes(k3[0])
    b = bound(moved, n * (int(k3[2].long().sum()) + 3 * V))
    cp_ms = copy_ms(torch, dev, moved)
    print(f"phase 5 K3 fir_predict at V={V} n={n} M={k3[1].shape[1]}: "
          f"bit-equal, kernel {ms:.4f} ms, plain {pms:.2f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}; operations "
          f"{b['ops_ms']:.4f} ms), device time {dev_ms:.4f} ms (CUDA graph; "
          f"a copy of the same bytes {cp_ms:.4f} ms); "
          f"tail V={k3_tail[0].shape[0]} n={tail_n}: bit-equal, kernel "
          f"{tail_ms:.4f} ms, device time {tail_dev_ms:.4f} ms; "
          f"V={k3_odd[0].shape[0]} n={k3_odd[0].shape[1]} "
          f"M={k3_odd[1].shape[1]}: bit-equal")
    recs.append(dict(name="fir_predict", route="cuda",
                     source="srla_tpu_torch/kernels/csrc/fir_predict.cu",
                     replaces="srla_tpu/kernels/encode.py:180",
                     max_abs_err=e, ms=ms, plain_ms=pms, **b,
                     library_ms=None, tail_ms=tail_ms, device_ms=dev_ms,
                     tail_device_ms=tail_dev_ms, copy_ms=cp_ms))
    # K4 at the main group, the tail group (the generic entry: leaves of
    # 127 padded to 128) and the odd shape.
    main4 = k4_timed(torch, "K4", rice_search_args(core, args))
    tail4 = k4_timed(torch, "K4 (tail group)",
                     rice_search_args(tail_core, tail_args))
    small_e, _, _ = compare(torch, "K4 (leaves of one sample)", rice_search,
                            rice_search_plain, k4_odd_args(torch, np, dev),
                            reps=1)
    print(f"phase 5 K4 rice_search: {k4_text(main4)}; tail "
          f"{k4_text(tail4)}; V=12 n=512 porders 0..9: bit-equal")
    recs.append(dict(name="rice_search", route="cuda",
                     source="srla_tpu_torch/kernels/csrc/rice_search.cu",
                     replaces="srla_tpu/kernels/exact.py:454",
                     max_abs_err=max(main4["max_abs_err"],
                                     tail4["max_abs_err"], small_e),
                     ms=main4["ms"], plain_ms=main4["plain_ms"],
                     bound_ms=main4["bound_ms"], bound_by=main4["bound_by"],
                     ops_ms=main4["ops_ms"], library_ms=None,
                     tail_ms=tail4["ms"], device_ms=main4["device_ms"],
                     tail_device_ms=tail4["device_ms"],
                     tail_bound_ms=tail4["bound_ms"]))

    # K5. The chosen rows of a group as the encode hands them over, and
    # the same rows' codeword stream for the generic pack.
    sel, sec = section_args(torch, small, big, core, B, n, W, args)
    tail_sel, tail_sec = section_args(torch, tail_small, tail_big, tail_core,
                                      1, tail_n, tail_W, tail_args)
    odd_sec, odd_owned = section_odd_args(torch, np, dev)

    def fused(a, image):
        return lambda: pack_residual_sections(*a, section_words=image)

    e = max(check_sections(torch, "at the main shape", sec, W),
            check_sections(torch, "at the tail shape", tail_sec, tail_W),
            check_sections(torch, "at the odd shape", odd_sec, None,
                           odd_owned))
    ms = cuda_ms(torch, fused(sec, W), 20)
    tail_ms = cuda_ms(torch, fused(tail_sec, tail_W), 20)
    dev_ms = device_ms(torch, fused(sec, W), 20)
    tail_dev_ms = device_ms(torch, fused(tail_sec, tail_W), 20)
    pms = cuda_ms(torch, lambda: pack_residual_sections_plain(*sec), 2)
    # Read the residuals of the rows that are packed and the parameters of
    # their partitions once, each row's type, order, start and length
    # once, write the sections' words once; about a dozen operations per
    # sample (parameter lookup, quotient, tail, width, offset, two shifts,
    # an OR).
    lens_w = sec[6]
    live_rows = lens_w > 0
    K = lens_w.numel()
    words = int(lens_w.sum())
    n_live = int(live_rows.sum())
    nparts = int((1 << sec[2][live_rows]).sum())
    moved = 4 * n_live * n + 8 * nparts + 32 * K + 4 * words
    b = bound(moved, 12 * n_live * n)
    cp_ms = copy_ms(torch, dev, moved)
    # What the same work cost before: the stream in torch ops, then pack.
    stream_ms = cuda_ms(torch, lambda: exact.chosen_stream(big, sel, n), 3)
    offs, tails, tbits = exact.chosen_stream(big, sel, n)
    k5 = (offs, tails, tbits, B * 2 * W)
    ge, gms, gpms = compare(torch, "K5 pack", pack, pack_plain, k5)
    k5_tail = (*exact.chosen_stream(tail_big, tail_sel, tail_n), 2 * tail_W)
    tail_ge, tail_gms, _ = compare(torch, "K5 pack (tail group)", pack,
                                   pack_plain, k5_tail)
    from srla_tpu_torch.kernels.bitpack import section_stream
    k5_odd = (*section_stream(*odd_sec[:7]), odd_sec[7])
    odd_ge, _, _ = compare(torch, "K5 pack (odd shape)", pack, pack_plain,
                           k5_odd, reps=1)
    gdev_ms = device_ms(torch, lambda: pack(*k5), 10)
    tail_gdev_ms = device_ms(torch, lambda: pack(*k5_tail), 20)
    print(f"phase 5 K5 pack_residual_sections of {K} rows x {n} samples "
          f"({n_live} packed) into {words} words: bit-equal, kernel "
          f"{ms:.4f} ms, device time {dev_ms:.4f} ms (CUDA graph; a copy "
          f"of the same bytes {cp_ms:.4f} ms), plain "
          f"{pms:.2f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}; "
          f"operations {b['ops_ms']:.4f} ms); before: codeword stream "
          f"(torch) {stream_ms:.4f} ms + pack {gms:.4f} ms; tail "
          f"{tail_sec[0].shape[0]} rows x {tail_n}: bit-equal, kernel "
          f"{tail_ms:.4f} ms, device time {tail_dev_ms:.4f} ms; "
          f"{odd_sec[0].shape[0]} rows x {odd_sec[4]} at porders 0..9: "
          f"bit-equal")
    recs.append(dict(name="pack_residual_sections", route="cuda",
                     source="srla_tpu_torch/kernels/csrc/bitpack.cu",
                     replaces="srla_tpu/kernels/bitpack.py:385",
                     max_abs_err=e, ms=ms, plain_ms=pms, **b,
                     library_ms=None, tail_ms=tail_ms, device_ms=dev_ms,
                     tail_device_ms=tail_dev_ms, copy_ms=cp_ms,
                     stream_ms=stream_ms, before_ms=stream_ms + gms))
    # The generic pack on the same stream shuffled, in int32, and on a
    # stream out of range (k5_edge_stream): bit-equal to plain.
    cap = B * 2 * W
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    perm = torch.randperm(offs.numel(), device=dev, generator=gen)
    k5_shuffled = (offs.reshape(-1)[perm], tails.reshape(-1)[perm],
                   tbits.reshape(-1)[perm], cap)
    k5_i32 = (*(t.to(torch.int32) for t in (offs, tails, tbits)), cap)
    edge = k5_edge_stream(np, 100_000, 23)
    k5_edge = (*(torch.from_numpy(a).to(dev) for a in edge[:3]), edge[3])
    more = {}
    for what, a in (("shuffled", k5_shuffled), ("int32", k5_i32),
                     ("out of range", k5_edge)):
        more[what] = check(torch, f"K5 pack ({what})", pack, pack_plain, a)
    shuffled_dev_ms = device_ms(torch, lambda: pack(*k5_shuffled), 10)
    i32_dev_ms = device_ms(torch, lambda: pack(*k5_i32), 10)
    split = profile_kernels(torch, lambda: pack(*k5))
    # Read each slot's offset, tail and width once at the caller's dtypes
    # (int64 here), write the words once; about eight operations per live
    # codeword (split, two shifts, two ORs).
    live = int((tbits > 0).sum())
    b = bound(nbytes(offs, tails, tbits) + 4 * cap, 8 * live)
    b32 = bound(nbytes(*k5_i32[:3]) + 4 * cap, 8 * live)
    print(f"phase 5 K5 pack (generic, off the encode's path) of "
          f"{offs.shape[0]} rows x {offs.shape[1]} "
          f"slots ({live} live, int64) into {cap} words: bit-equal, kernel "
          f"{gms:.4f} ms, device time {gdev_ms:.4f} ms (CUDA graph, the "
          f"whole call), plain {gpms:.2f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}: {nbytes(offs, tails, tbits) + 4 * cap} bytes; "
          f"operations {b['ops_ms']:.4f} ms); torch.profiler, one call: "
          f"{split_text(split)}; {parent_text('pack')}; the same stream "
          f"shuffled: bit-equal, device time {shuffled_dev_ms:.4f} ms; in "
          f"int32: bit-equal, device time {i32_dev_ms:.4f} ms (bound "
          f"{b32['bound_ms']:.4f} ms); {edge[0].size} entries out of range "
          f"(negative offsets, past cap_w, widths 0 to 2^33, shuffled): "
          f"bit-equal; tail {k5_tail[0].shape[0]} rows x "
          f"{k5_tail[0].shape[1]} slots: bit-equal, kernel {tail_gms:.4f} "
          f"ms, device time {tail_gdev_ms:.4f} ms; {k5_odd[0].shape[0]} "
          f"rows x {k5_odd[0].shape[1]} slots: bit-equal")
    recs.append(dict(name="bitpack", route="cuda",
                     source="srla_tpu_torch/kernels/csrc/bitpack.cu",
                     replaces="srla_tpu/kernels/pallas_pack.py:79",
                     max_abs_err=max(ge, tail_ge, odd_ge, *more.values()),
                     ms=gms, plain_ms=gpms, **b, library_ms=None,
                     tail_ms=tail_gms, device_ms=gdev_ms,
                     tail_device_ms=tail_gdev_ms,
                     shuffled_device_ms=shuffled_dev_ms,
                     int32_device_ms=i32_dev_ms,
                     int32_bound_ms=b32["bound_ms"],
                     profile_us={name: us for name, us, _ in split},
                     parent_in_turns=parent_runs("pack"),
                     on_encode_path=False))
    return recs


def k6_rows(torch, np, dev, R: int, seed: int):
    """R rows of the tool's inputs (row r from seed + r) on the card."""
    from srla_tpu_torch.tools.bitfield_probes import make_inputs
    parts = [make_inputs(seed + r) for r in range(R)]
    return [torch.from_numpy(np.concatenate([p[k] for p in parts])).to(dev)
            for k in range(3)]


def k6_odd_rows(torch, np, dev, R: int, C: int, W: int):
    """R rows of C full-range values on the card; a tenth of the words lie
    outside 0..W-1 and a tenth of the shifts outside 0..31."""
    rng = np.random.RandomState(R + C + W)
    vals = rng.randint(-(1 << 31), 1 << 31, (R, C))
    word = np.where(rng.rand(R, C) < 0.1,
                    rng.choice([-1, -W, W, W + 3, 1 << 30], (R, C)),
                    rng.randint(0, W, (R, C)))
    shift = np.where(rng.rand(R, C) < 0.1,
                     rng.choice([-1, 32, 33, 40, 1 << 20], (R, C)),
                     rng.randint(0, 32, (R, C)))
    return [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
            for a in (vals, word, shift)]


def phase_bitfield(torch, np, dev):
    """K6: the tool's entry point once (the path, counted), then each of
    the three kernels against its plain version and against scatter_add_
    at R = 1 and R = K6_ROWS, and against its plain version at a shape
    that is no multiple of a warp or of a CTA's words. Returns (records,
    launches)."""
    import itertools

    from srla_tpu_torch.kernels import bitfield as bf
    from srla_tpu_torch.tools import bitfield_probes

    bf.place_dot.launches = bf.place_rmw.launches = 0
    bf.place_mask.launches = 0
    require(bitfield_probes.main(["--device", "cuda"]) == 0,
            "bitfield_probes reported a mismatch")
    launches = {"bitfield_dot": bf.place_dot.launches,
                "bitfield_rmw": bf.place_rmw.launches,
                "bitfield_mask": bf.place_mask.launches}
    W = bitfield_probes.W
    kernels = (("bitfield_dot", bf.place_dot, bf.place_dot_plain, ":61"),
               ("bitfield_rmw", bf.place_rmw, bf.place_rmw_plain, ":74"),
               ("bitfield_mask", bf.place_mask, bf.place_mask_plain, ":89"))
    recs = {name: dict(name=name, route="cuda",
                       source="srla_tpu_torch/kernels/csrc/"
                              "bitfield_probe.cu",
                       replaces="tools/mosaic_repro.py" + line,
                       max_abs_err=0)
            for name, _, _, line in kernels}
    for R in (1, K6_ROWS):
        # Enough input sets to exceed the 50 MB L2 at R = K6_ROWS, so each
        # timed launch reads its inputs from device memory.
        sets = [k6_rows(torch, np, dev, R, seed=1000 * i)
                for i in range(6 if R > 1 else 1)]
        idx = [s[1].long() for s in sets]
        vals, word, shift = sets[0]
        lib = bf.place_scatter_add(vals, idx[0], shift, W)
        turns = itertools.cycle(range(len(sets)))

        def library():
            i = next(turns)
            return bf.place_scatter_add(sets[i][0], idx[i], sets[i][2], W)

        lib_ms = cuda_ms(torch, library, 200)
        lib_dev_ms = device_ms(torch, library, 48)
        # Read vals, word and shift once, write the words once; a shift
        # and an add per codeword.
        b = bound(nbytes(vals, word, shift) + 4 * R * W,
                  2 * vals.numel())
        for name, kernel, plain, _ in kernels:
            got = kernel(vals, word, shift, W)
            want = plain(vals, word, shift, W)
            torch.cuda.synchronize()
            e = max(max_abs_err(torch, got, want),
                    max_abs_err(torch, got, lib))
            require(e == 0, f"{name} differs from its plain version or "
                            f"scatter_add_ at R={R} (max abs err {e})")
            recs[name]["max_abs_err"] = max(recs[name]["max_abs_err"], e)
            cyc = itertools.cycle(sets)
            ms = cuda_ms(torch, lambda: kernel(*next(cyc), W), 200)
            dev_ms = device_ms(torch, lambda: kernel(*next(cyc), W), 48)
            plain_ms = cuda_ms(torch, lambda: plain(vals, word, shift, W),
                               3)
            print(f"phase 7 K6 {name} at R={R} C={vals.shape[1]} W={W}: "
                  f"bit-equal to plain and scatter_add_, kernel {ms:.4f} "
                  f"ms, plain {plain_ms:.3f} ms, scatter_add_ "
                  f"{lib_ms:.4f} ms, bound {b['bound_ms']:.6f} ms "
                  f"({b['bound_by']}; operations {b['ops_ms']:.6f} ms); "
                  f"device time (CUDA graph) kernel {dev_ms:.4f} ms, "
                  f"scatter_add_ {lib_dev_ms:.4f} ms")
            times = dict(ms=ms, plain_ms=plain_ms, **b, library_ms=lib_ms,
                         device_ms=dev_ms, library_device_ms=lib_dev_ms)
            if R == 1:
                recs[name].update(times)        # the tool's shape
            else:
                recs[name][f"rows_{R}"] = times
    odd = (37, 300, 200)
    odd_args = (*k6_odd_rows(torch, np, dev, *odd), odd[2])
    for name, kernel, plain, _ in kernels:
        e, _, _ = compare(torch, f"{name} at R, C, W = {odd}", kernel, plain,
                          odd_args, reps=1)
        recs[name]["max_abs_err"] = max(recs[name]["max_abs_err"], e)
    print(f"phase 7 K6 dot, rmw and mask at R, C, W = {odd}, words and "
          f"shifts out of range among them: bit-equal to plain")
    for name, count in launches.items():
        require(count > 0, f"{name} was not launched by bitfield_probes")
    return list(recs.values()), launches


def phase_encode(torch, np, dev, pcm, stream: bytes, card: str):
    """The port's encode of the main path: bytes, block accounting, kernel
    launches, the port's own decode, then speed and a step breakdown.
    Returns the launch counts of K3, K4, both K5 entries, K8 and K7 in
    that encode, which never reaches K7's or K8's plain version."""
    from srla_tpu_torch import SRLAEncoder, decode
    from srla_tpu_torch.encoder import StepTimer

    param = main_param()
    names = ("fir_predict", "rice_search", "pack_residual_sections",
             "bitpack", "autocorr", "lpc_analyze", "preemphasis",
             "select_blocks", "measure_blocks", "ltp_predict")
    wrappers = {k: w for k, w in all_wrappers().items() if k in names}
    torch.cuda.reset_peak_memory_stats()
    enc = SRLAEncoder(param, dev)
    data, launches = counted(torch, wrappers, lambda: without_plain(
        lambda: enc.encode_whole(pcm)))
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    require(data == stream, "port encode differs from the host exact "
                            "stream")
    ncomp = compress_blocks(stream)
    s = enc.stats
    handled = (s["device_blocks"] + s["repaired_blocks"]
               + s["w_overflow_blocks"])
    require(handled == ncomp, f"block accounting {s}: {handled} of "
                              f"{ncomp} COMPRESS blocks")
    # Two groups (1291 blocks of 4096, 1 block of 4064): one launch each,
    # K8 and K7 too (the LPC lags, then their analysis), K16 and K17's
    # encode entry too. The generic pack is off the encode's path; without
    # -V and -P nothing measures and nothing runs K18.
    for name, count in launches.items():
        want = 0 if name in ("bitpack", "measure_blocks",
                             "ltp_predict") else 2
        require(count == want, f"{name} was launched {count} times by the "
                               f"encode, expected {want}")
    _, out = decode(data, device=dev)
    require(np.array_equal(out, pcm), "port decode of the port's stream "
                                      "is not lossless")
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        SRLAEncoder(param, dev).encode_whole(pcm)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    print(f"phase 6 encode {MAIN_SECONDS:.0f} s stereo -m 4 -B 4096 -V 0 on "
          f"the card: byte-identical to the host exact stream, "
          f"{s['device_blocks']} device / {s['repaired_blocks']} repaired / "
          f"{s['w_overflow_blocks']} overflow of {ncomp} COMPRESS blocks "
          f"(repaired_blocks {s['repaired_blocks']}), launches {launches}, "
          f"port decode lossless; peak device memory {peak_gb:.2f} GiB; "
          f"warm best of 3 {best * 1e3:.1f} ms = "
          f"{MAIN_SECONDS / best:.1f}x realtime [{card}]")
    enc = SRLAEncoder(param, dev)
    enc.timer = StepTimer(dev)
    enc.encode_whole(pcm)
    steps = enc.timer.seconds
    print("phase 6 encode breakdown (host clock, synchronised per step, ms): "
          + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in steps.items())
          + f"; total {sum(steps.values()) * 1e3:.2f}")
    profile_encode_group(torch, np, dev, pcm, card)
    return launches


def profile_encode_group(torch, np, dev, pcm, card) -> None:
    """The main group's encode (kernels.exact.encode_blocks, 1291 blocks of
    4096) under torch.profiler, after a warm-up step: the device's kernels
    in launch order. The window holds RUNS encodes, since a later profiler
    session in a process may miss the first kernels of its window: every
    K3 kernel recorded must be followed at once by K4's, with exactly one
    K4 kernel before the next K3 (the Rice search is one launch)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from srla_tpu_torch.kernels import exact
    blocks, B, args, W = main_group(torch, np, dev, pcm)
    runs = 3

    def run():
        exact.encode_blocks(blocks, 0, C=2, W=W, **args)

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                 ) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(runs):
            run()
        torch.cuda.synchronize()
        prof.step()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.name.startswith("Memcpy")
                      and not e.name.startswith("Memset")),
                     key=lambda e: e.time_range.start)
    names = [e.name for e in kernels]
    k3 = [i for i, nm in enumerate(names) if "fir_predict" in nm]
    require(k3, f"phase 6 profile: no K3 kernel among the {len(names)} "
                f"kernels of {runs} encode groups")
    for a, b in zip(k3, k3[1:] + [len(names)]):
        require(a + 1 < b and "rice_search_rows" in names[a + 1],
                f"phase 6 profile: the kernels after K3 are "
                f"{names[a:a + 6]}")
        require(sum("rice_search" in nm for nm in names[a:b]) == 1,
                "phase 6 profile: K4 launched more than once in a group")
    last = k3[-1]
    after = names[last:last + 6]
    short = [nm.replace("(anonymous namespace)::", "").replace("void ", "")
             .split("(")[0]
             .split("<")[0].split("::")[-1] for nm in after]
    dev_us = [e.time_range.elapsed_us() for e in kernels[last:last + 2]]
    print(f"phase 6 profile of {runs} encode groups ({B} blocks x "
          f"{args['n']}, torch.profiler): {len(names)} kernels recorded, "
          f"{len(k3)} K3; from the last K3 on {short}; K3 {dev_us[0]:.1f} "
          f"us, K4 {dev_us[1]:.1f} us; nothing between K3 and K4 in any "
          f"group [{card}]")


def variable_param(V: int, L: int = 4):
    """-m 4 -B 4096 -V V -L L for 16-bit stereo at 44.1 kHz (at V 1, L 4
    the CLI's defaults)."""
    from srla_tpu_torch.host_encoder import make_parameter
    return make_parameter(2, 16, SAMPLE_RATE, 4, 4096, V, L)


def span_groups(pcm, param) -> dict:
    """The spans the -V search measures by analysis (typed COMPRESS: above
    the order limit and not all zero), as {length: [offsets]}, enumerated
    here from the parameter alone (srla_encoder.c:310-424). Requires every
    lookahead window to be of even length (none measured serially on the
    host)."""
    from srla_tpu_torch.constants import PARAMETER_PRESETS
    C, N = pcm.shape
    dmin = param.min_num_samples_per_block
    dmax = param.max_num_samples_per_block
    limit = PARAMETER_PRESETS[param.preset].max_num_parameters
    groups: dict = {}
    for wo in range(0, N, param.num_lookahead_samples):
        span = min(param.num_lookahead_samples, N - wo)
        require(span % 2 == 0, "phase 8 needs even lookahead windows")
        nodes = (span + dmin - 1) // dmin + 1
        for i in range(nodes):
            for j in range(i + 1, min(nodes, i + dmax // dmin + 1)):
                size = min((j - i) * dmin, span - i * dmin)
                off = wo + i * dmin
                if size > limit and pcm[:, off:off + size].any():
                    groups.setdefault(size, []).append(off)
    return groups


def encode_groups(pcm, param, stream: bytes) -> dict:
    """The blocks of the stream that the device encode analyses (typed
    COMPRESS: above the order limit and not all zero), as {length:
    [offsets]}, from the stream's block headers. Requires every such block
    to be of even length (none encoded serially on the host)."""
    from srla_tpu_torch.constants import PARAMETER_PRESETS
    limit = PARAMETER_PRESETS[param.preset].max_num_parameters
    groups: dict = {}
    off = 0
    for _, n in stream_blocks(stream):
        if n > limit and pcm[:, off:off + n].any():
            require(n % 2 == 0, "phase 8 needs even block lengths")
            groups.setdefault(n, []).append(off)
        off += n
    return groups


def calls_of(offsets, per_call: int) -> list:
    """The offsets cut into the encoder's calls of at most per_call."""
    return [offsets[lo:lo + per_call]
            for lo in range(0, len(offsets), per_call)]


def expected_calls(spans: dict, blocks: dict) -> tuple[int, int]:
    """(measurement calls, encode groups) of the device -V encode: a call
    per span length of at most MAX_MEASURE_SAMPLES span samples, and a
    group per block length of at most MAX_CALL_BLOCKS blocks."""
    from srla_tpu_torch import SRLAEncoder
    measure = sum(len(calls_of(offs, max(1, SRLAEncoder.MAX_MEASURE_SAMPLES
                                         // n)))
                  for n, offs in spans.items())
    encode = sum(len(calls_of(offs, SRLAEncoder.MAX_CALL_BLOCKS))
                 for offs in blocks.values())
    return measure, encode


def best_of(torch, fn, reps: int = 3) -> float:
    """Least wall seconds of reps calls of fn, synchronised around each."""
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def timed(fn) -> float:
    """Wall seconds of one call of fn (host work only)."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def counted(torch, wrappers: dict, fn):
    """fn()'s result and the launches it made, each wrapper's count set to
    0 just before and read just after."""
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: w.launches for k, w in wrappers.items()}


def all_wrappers() -> dict:
    """Every kernel wrapper of the codec's paths, by record name, and the
    runner of K12's first design, which no path may launch."""
    from srla_tpu_torch.kernels.autocorr import autocorr
    from srla_tpu_torch.kernels.bitpack import pack, pack_residual_sections
    from srla_tpu_torch.kernels.levinson import (lpc_analyze, lpc_coefs,
                                                 lpc_quantize)
    from srla_tpu_torch.kernels.decode2 import synth_tail
    from srla_tpu_torch.kernels.lpc import lpc_scan, lpc_scan_coefs
    from srla_tpu_torch.kernels.lpc_f32 import lpc_analyze_f32
    from srla_tpu_torch.kernels.ltp import (ltp_analyze, ltp_predict,
                                            ltp_synth)
    from srla_tpu_torch.kernels.predict import predict
    from srla_tpu_torch.kernels.preemphasis import (variant_preemphasis,
                                                    variant_preemphasis_f32)
    from srla_tpu_torch.kernels.rice_cost import rice_cost
    from srla_tpu_torch.kernels.rice_decode import rice_decode
    from srla_tpu_torch.kernels.rice_search import rice_search
    from srla_tpu_torch.kernels.select import measure_blocks, select_blocks
    from srla_tpu_torch.kernels.svr import svr_cov, svr_refine
    from srla_tpu_torch.kernels.verify import verify_blocks
    return {"lpc_synth": lpc_scan, "lpc_synth_coefs": lpc_scan_coefs,
            "synth_tail": synth_tail, "rice_decode": rice_decode,
            "fir_predict": predict, "rice_search": rice_search,
            "pack_residual_sections": pack_residual_sections,
            "bitpack": pack, "ltp_synth": ltp_synth,
            "ltp_analyze": ltp_analyze, "autocorr": autocorr,
            "lpc_analyze": lpc_analyze, "lpc_coefs": lpc_coefs,
            "lpc_quantize": lpc_quantize, "svr_cov": svr_cov,
            "svr_refine": svr_refine, "svr_refine_v1": k12_first_design,
            "verify": verify_blocks, "lpc_analyze_f32": lpc_analyze_f32,
            "rice_cost": rice_cost, "preemphasis": variant_preemphasis,
            "select_blocks": select_blocks, "measure_blocks": measure_blocks,
            "ltp_predict": ltp_predict,
            "preemphasis_f32": variant_preemphasis_f32}


def stage_plains():
    """The plain versions of K17 and of K5's section entry (and the torch
    code they compose), as (module, name)."""
    from srla_tpu_torch.kernels import bitpack as k5
    from srla_tpu_torch.kernels import select as k17
    return ((k17, "select_blocks_plain"), (k17, "measure_blocks_plain"),
            (k17, "select_rows"), (k17, "account_bits"),
            (k17, "method_lengths"), (k17, "section_starts"),
            (k17, "chosen_sections"), (k5, "pack_residual_sections_plain"),
            (k5, "section_stream"))


def without_plain(fn):
    """fn() with the plain versions of K7, K8, K11, K12, K4, K16, K17, K18
    and K5's section entry (and the torch code they compose) replaced by
    tripwires: an encode on the card that reached one of them raises."""
    from srla_tpu_torch.kernels import autocorr as k8
    from srla_tpu_torch.kernels import exact
    from srla_tpu_torch.kernels import levinson as k7
    from srla_tpu_torch.kernels import ltp as k18
    from srla_tpu_torch.kernels import preemphasis as k16
    from srla_tpu_torch.kernels import rice_search as k4
    from srla_tpu_torch.kernels import svr as k12
    names = stage_plains() + (
             (k16, "variant_preemphasis_plain"), (k16, "preemphasis_rows"),
             (k16, "variant_stack"), (k16, "cut_spans"),
             (exact, "preemphasis_exact"), (k18, "ltp_predict_plain"),
             (k8, "autocorr_plain"), (k7, "lpc_analyze_plain"),
             (k7, "levinson"), (k7, "select_order_exact"),
             (k7, "quantize_exact"), (k7, "lpc_coefs_plain"),
             (k7, "lpc_quantize_plain"), (k12, "svr_cov_plain"),
             (k12, "svr_refine_plain"), (k12, "cholesky_plain"),
             (k12, "cholesky_solve_plain"), (k12, "inverse_diag_max_plain"),
             (k12, "rgr_mean_code_length"), (k4, "rice_search_plain"),
             (k4, "rice_params"), (k4, "rice_sums_plain"),
             (k4, "porder_search"))
    saved = [getattr(m, name) for m, name in names]

    def tripwire(*_a, **_k):
        raise RuntimeError("a plain version of K4, K5, K7, K8, K11, K12, "
                           "K16, K17 or K18 ran on the encode's path")

    for m, name in names:
        setattr(m, name, tripwire)
    try:
        return fn()
    finally:
        for (m, name), f in zip(names, saved):
            setattr(m, name, f)


def kernels_held(torch, fn, tally: dict):
    """fn() with the analysis's K4 call (kernels/exact.py's rice_search)
    and, under SVR, its K7 quantization call (exact.lpc_quantize) recording
    each call's inputs and outputs; after fn, outside without_plain's
    tripwires, each call's outputs are held to the plain version's on the
    same inputs: bit-equal on every output (K4: code type, order, bits, ks,
    risky; K7: shifts, values, risky). Adds the calls and rows to
    ``tally`` (K7's under "k7q_calls" and "k7q_rows")."""
    from srla_tpu_torch.kernels import exact
    from srla_tpu_torch.kernels.levinson import lpc_quantize_plain
    from srla_tpu_torch.kernels.rice_search import rice_search_plain
    kernels = {"rice_search": exact.rice_search,
               "lpc_quantize": exact.lpc_quantize}
    calls = {name: [] for name in kernels}

    def recorder(name):
        def recorded(*args):
            out = kernels[name](*args)
            calls[name].append((
                tuple(a.clone() if hasattr(a, "clone") else a for a in args),
                tuple(t.clone() for t in out)))
            return out
        return recorded

    for name in kernels:
        setattr(exact, name, recorder(name))
    try:
        result = fn()
    finally:
        for name, kernel in kernels.items():
            setattr(exact, name, kernel)
    for args, got in calls["rice_search"]:
        e = max_abs_err(torch, got, rice_search_plain(*args))
        require(e == 0, f"K4 differs from its plain version on the inputs "
                        f"of an analysis call ({args[0].shape[0]} rows x "
                        f"{args[1]}, max abs err {e})")
        tally["calls"] += 1
        tally["rows"] += args[0].shape[0]
    for args, got in calls["lpc_quantize"]:
        e = max_abs_err(torch, got, lpc_quantize_plain(*args))
        require(e == 0, f"K7's quantization entry differs from its plain "
                        f"version on the inputs of an analysis call "
                        f"({args[0].shape[0]} rows, max abs err {e})")
        tally["k7q_calls"] += 1
        tally["k7q_rows"] += args[0].shape[0]
    return result


def held_encode(torch, wrappers: dict, fn):
    """counted(torch, wrappers, fn) with fn under without_plain and every
    K4 call, and every call of K7's quantization entry, of it held to the
    plain version on its inputs (kernels_held), one held call a launch.
    Returns (fn's result, launches, the tally)."""
    k4 = {"calls": 0, "rows": 0, "k7q_calls": 0, "k7q_rows": 0}
    out, got = counted(torch, wrappers, lambda: kernels_held(
        torch, lambda: without_plain(fn), k4))
    require(k4["calls"] == got["rice_search"],
            f"K4 held on {k4['calls']} calls, launched {got['rice_search']} "
            f"times")
    require(k4["k7q_calls"] == got["lpc_quantize"],
            f"K7's quantization entry held on {k4['k7q_calls']} calls, "
            f"launched {got['lpc_quantize']} times")
    return out, got, k4


def held_text(k4: dict) -> str:
    text = (f"K4 bit-equal to plain on every output on the inputs of each "
            f"of its {k4['calls']} analysis calls ({k4['rows']} rows)")
    if k4["k7q_calls"]:
        text += (f", K7's quantization entry on each of its "
                 f"{k4['k7q_calls']} ({k4['k7q_rows']} rows)")
    return text


def new_tally() -> dict:
    """Counters of analysis_checks over one path's analysis calls."""
    return dict(calls=0, rows=0, k8_err=0.0, k8_err_r0=0.0,
                k7_flag_diff=0, k8_flag_diff=0)


def analysis_checks(torch, what: str, pre, work, args, tally: dict) -> None:
    """K8 and K7 against their plain versions on one analysis call's rows:
    K8 on the LPC lags of ``work`` (the rows K3 filters) and, with -P, on
    the pitch lags of the pre-emphasised rows ``pre``, every lag within
    2^-45 r0; K7 on the call's ridged K8 lags, its orders, shifts and
    coefficients equal to the plain version's on every row that neither
    flags, and the plain K7 on K8's lags equal to it on the plain lags on
    every row that neither flags. Adds to ``tally`` the call's rows, K8's
    largest error (absolute and in r0), the rows whose flag K7 changes and
    the rows whose flag K8's lags change."""
    from srla_tpu_torch.constants import LPC_RIDGE_REGULARIZATION_PARAMETER
    from srla_tpu_torch.kernels.autocorr import autocorr, autocorr_plain
    from srla_tpu_torch.kernels.levinson import lpc_analyze, lpc_analyze_plain
    from srla_tpu_torch.kernels.ltp import LTP_LAGS
    n, bps, F, M = (args[k] for k in ("n", "bps", "fft_size", "max_params"))
    inputs = [(work, M + 1)] + ([(pre, LTP_LAGS)] if args["ltp_order"]
                                else [])
    lags = []
    for rows, L in inputs:
        got = autocorr(rows, n, bps, L, F)
        want = autocorr_plain(rows, n, bps, L, F)
        torch.cuda.synchronize()
        err = (got - want).abs()
        r0 = want[:, :1].abs()
        require(bool((err <= r0 * 2.0 ** -45).all()),
                f"K8 ({what}, {L} lags) is more than 2^-45 r0 from its "
                f"plain version")
        tally["k8_err"] = max(tally["k8_err"], float(err.max()))
        tally["k8_err_r0"] = max(tally["k8_err_r0"], float(
            (err / torch.where(r0 > 0, r0, 1.0)).max()))
        lags.append((got, want))
    ac, ac_plain = (t.clone() for t in lags[0])
    for t in (ac, ac_plain):
        t[:, 0] = t[:, 0] * (1.0 + LPC_RIDGE_REGULARIZATION_PARAMETER)
    kw = (n, bps, M, args["max_fixed"])
    k7 = lpc_analyze(ac, *kw)
    p7 = lpc_analyze_plain(ac, *kw)
    p8 = lpc_analyze_plain(ac_plain, *kw)
    torch.cuda.synchronize()
    for (got, want), who in (((k7, p7), "K7"), ((p7, p8), "K8's lags")):
        ok = ~got[3] & ~want[3]
        for g, w in zip(got[:3], want[:3]):
            require(torch.equal(g[ok], w[ok]), f"{who} ({what}) change an "
                                               f"unflagged LPC decision")
    tally["calls"] += 1
    tally["rows"] += work.shape[0]
    tally["k7_flag_diff"] += int((k7[3] != p7[3]).sum())
    tally["k8_flag_diff"] += int((p7[3] != p8[3]).sum())


def tally_text(t: dict) -> str:
    return (f"K8 within {t['k8_err_r0']:.3g} r0 of plain (max abs "
            f"{t['k8_err']:.3g}) and K7 equal to plain where neither flags, "
            f"on {t['rows']} rows of {t['calls']} analysis calls; rows whose "
            f"flag K7 changes: {t['k7_flag_diff']}, whose flag K8's lags "
            f"change: {t['k8_flag_diff']}")


def variable_kernels(torch, dev, pcm, param, spans: dict, blocks: dict,
                     tally: dict, time_n: int = 0):
    """K3 and K4 against their plain versions on the inputs of every
    measurement call of one -V encode (its spans of each length, cut into
    calls as the encoder cuts them) and of every encode group (the
    stream's blocks of each length), K5's pack_residual_sections on those
    of every encode group: bit-equal (K4 on every output); K8 and K7 on the
    same calls (analysis_checks, counted into ``tally``). At the first
    measurement call of length time_n it also times K4 (k4_timed).
    Returns (max_abs_err by kernel, [(what, rows, n)] checked, K4's timed
    record or None)."""
    from srla_tpu_torch import SRLAEncoder
    from srla_tpu_torch.host_encoder import _compute_offset_lshift
    from srla_tpu_torch.kernels import exact
    from srla_tpu_torch.kernels.predict import predict, predict_plain
    from srla_tpu_torch.kernels.rice_search import (rice_search,
                                                    rice_search_plain)
    enc = SRLAEncoder(param, dev)
    file = enc._upload(pcm)[enc.device]
    lshift = _compute_offset_lshift(pcm)
    err = dict(fir_predict=0, rice_search=0, pack_residual_sections=0)
    checked, timed_k4 = [], None

    def analysed(offs, n, what):
        args = enc._host._device_args(n)
        small, big, core = exact.variant_analysis(
            exact.Spans(file, offs, n), lshift, **args)
        at = f"{what}, {len(offs)} of {n}"
        k3 = (core["work"], core["coefs"], core["orders"], core["rshifts"])
        err["fir_predict"] = max(err["fir_predict"], check(
            torch, f"K3 ({at})", predict, predict_plain, k3))
        k4 = rice_search_args(core, args)
        err["rice_search"] = max(err["rice_search"], check(
            torch, f"K4 ({at})", rice_search, rice_search_plain, k4))
        analysis_checks(torch, at, None, core["work"], args, tally)
        checked.append((what, k3[0].shape[0], n))
        return args, small, big, core, k4

    for n, offs in sorted(spans.items()):
        per_call = max(1, SRLAEncoder.MAX_MEASURE_SAMPLES // n)
        for k, part in enumerate(calls_of(offs, per_call)):
            args, _, _, _, k4 = analysed(part, n, "measurement call")
            if n == time_n and k == 0:
                timed_k4 = k4_timed(torch, f"K4 (generic, n={n})", k4)
    for n, offs in sorted(blocks.items()):
        W = enc._section_words(n)
        for part in calls_of(offs, SRLAEncoder.MAX_CALL_BLOCKS):
            args, small, big, core, _ = analysed(part, n, "encode group")
            _, sec = section_args(torch, small, big, core, len(part), n, W,
                                  args)
            err["pack_residual_sections"] = max(
                err["pack_residual_sections"],
                check_sections(torch, f"(encode group, {len(part)} of {n})",
                               sec, W))
    return err, checked, timed_k4


# (path, -V, -L): the segmented paths take the first VAR_SECONDS or
# VAR2_SECONDS of one segmented signal.
VARIABLE_PATHS = (("music120_V1", 1, 4), ("segmented30_V1", 1, 4),
                  ("segmented30_V3", 3, 4), ("segmented10_V2_L2", 2, 2),
                  ("segmented10_V2_L4", 2, 4))


def phase_variable(torch, np, dev, music, card):
    """Phase 8, the -V path on the card: 120 s of make_music at the CLI's
    defaults (-m 4 -B 4096 -V 1 -L 4), 30 s of the segmented signal at -V
    1 and -V 3 and its first 10 s at -V 2 -L 2 and -V 2 -L 4, each
    encoded by SRLAEncoder(device="cuda") and decoded by
    decode(..., device="cuda"). Checks bytes against the host exact encoder,
    span and block accounting, launch counts and lossless decode; then K3,
    K4 and K5's fused entry against their plain versions on the inputs of
    each path's measurement calls and encode groups. Times the 120 s -V 1
    case, its measurement's largest call and K4's generic kernel at the -V
    3 measurement's 3072-sample group. Returns (each path's kernel launches,
    encode and decode apart; the checks' max_abs_err by kernel; K4's
    generic record; each path's K7 and K8 tally; the -V 3 path's PCM and
    stream)."""
    from srla_tpu_torch import SRLADecoder, SRLAEncoder, decode
    from srla_tpu_torch.encoder import StepTimer
    from srla_tpu_torch.host_encoder import encode as host_encode
    from srla_tpu_torch.kernels import exact
    from srla_tpu_torch.signals import make_segmented

    wrappers = all_wrappers()

    seg = make_segmented(VAR_SECONDS)
    tallies: dict = {}
    launches: dict = {}
    errs = dict(fir_predict=0, rice_search=0, pack_residual_sections=0)
    main_case = generic = v3_case = None
    seg2 = np.ascontiguousarray(seg[:, :int(VAR2_SECONDS * SAMPLE_RATE)])
    for path, V, L in VARIABLE_PATHS:
        pcm = (music if path.startswith("music") else
               seg2 if path.startswith("segmented10") else seg)
        what = (f"make_music {MAIN_SECONDS:.0f} s" if pcm is music
                else f"segmented {pcm.shape[1] / SAMPLE_RATE:.0f} s -L {L}")
        param = variable_param(V, L)
        t0 = time.perf_counter()
        stream = host_encode(pcm, 16, SAMPLE_RATE, variable_divisions=V,
                             lookahead_factor=L)
        host_s = time.perf_counter() - t0
        spans = span_groups(pcm, param)
        blocks = encode_groups(pcm, param, stream)
        n_measure, n_encode = expected_calls(spans, blocks)
        enc = SRLAEncoder(param, dev)
        torch.cuda.reset_peak_memory_stats()
        data, got = counted(torch, wrappers, lambda: without_plain(
            lambda: enc.encode_whole(pcm)))
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        require(data == stream, f"-V {V} encode of {what} differs from the "
                                f"host exact stream")
        s = enc.stats
        nspans = sum(len(o) for o in spans.values())
        require(s["device_spans"] + s["remeasured_spans"] == nspans
                and s["host_spans"] == 0,
                f"-V {V} span accounting {s}: {nspans} spans measured by "
                f"analysis, none on the host")
        ncomp = compress_blocks(stream)
        handled = (s["device_blocks"] + s["repaired_blocks"]
                   + s["w_overflow_blocks"])
        require(handled == ncomp, f"-V {V} block accounting {s}: {handled} "
                                  f"of {ncomp} COMPRESS blocks")
        calls = n_measure + n_encode
        want = {"fir_predict": calls, "rice_search": calls,
                "autocorr": calls, "lpc_analyze": calls,
                "preemphasis": calls, "select_blocks": n_encode,
                "measure_blocks": n_measure, "ltp_predict": 0,
                "pack_residual_sections": n_encode, "bitpack": 0,
                "svr_refine_v1": 0}
        for name, count in want.items():
            require(got[name] == count, f"-V {V}: {name} launched "
                                        f"{got[name]} times, expected {count}")
        (_, out), dec_got = counted(torch, wrappers,
                                    lambda: decode(data, device=dev))
        require(np.array_equal(out, pcm), f"-V {V} decode of {what} is not "
                                          f"lossless")
        ngroups = len(SRLADecoder(dev).plan(data)[2])
        require(dec_got["rice_decode"] == ngroups, f"-V {V} decode: K2 "
                                                   f"launches {dec_got}")
        decode_launches_ok(dec_got, ngroups, 0, ngroups, f"-V {V} decode")
        launches[path] = {"encode": got, "decode": dec_got}
        sizes: dict = {}
        for _, n in stream_blocks(stream):
            sizes[n] = sizes.get(n, 0) + 1
        if V == 3:       # leaving out the last window's clipped block
            require(any(n & (n - 1) for _, n in stream_blocks(stream)[:-1]),
                    "the -V 3 stream holds no block length that is no "
                    "power of two")
        print(f"phase 8 encode {what} -V {V} on the card: byte-identical to "
              f"the host exact stream ({host_s:.2f} s on the host), blocks "
              f"by length {dict(sorted(sizes.items()))}, "
              f"{s['device_blocks']} device / {s['repaired_blocks']} "
              f"repaired / {s['w_overflow_blocks']} overflow of {ncomp} "
              f"COMPRESS blocks; spans {s['device_spans']} device / "
              f"{s['remeasured_spans']} re-measured / {s['host_spans']} host "
              f"of {nspans}, {len(spans)} lengths in {n_measure} "
              f"measurement calls; {n_encode} encode groups; launches "
              f"{got}; decode on the card lossless, launches "
              f"{ {k: dec_got[k] for k in DECODE_SHOWN} }; "
              f"peak device memory {peak_gb:.2f} GiB")
        tally = new_tally()
        err, checked, timed_k4 = variable_kernels(
            torch, dev, pcm, param, spans, blocks, tally,
            3072 if V == 3 else 0)
        require(tally["k7_flag_diff"] == 0, f"-V {V} {what}: K7 and its "
                f"plain version flag {tally['k7_flag_diff']} rows apart")
        tallies[path] = tally
        for k, e in err.items():
            errs[k] = max(errs[k], e)
        generic = timed_k4 or generic
        print(f"phase 8 -V {V} {what}: K3 and K4 bit-equal to their plain "
              f"versions on the inputs of its {n_measure} measurement calls "
              f"and {n_encode} encode groups, K5's pack_residual_sections on "
              f"those of its encode groups; rows x n checked: "
              + "; ".join(kind + " " + ", ".join(f"{r}x{n}"
                                                 for w, r, n in checked
                                                 if w == kind)
                          for kind in ("measurement call", "encode group"))
              + "; " + tally_text(tally))
        if main_case is None:
            main_case = (pcm, param, stream, spans, n_measure)
        if V == 3:
            v3_case = (pcm, stream)
    require(generic is not None, "the -V 3 measurement has no 3072 group")

    pcm, param, stream, spans, n_measure = main_case
    host_best = min(timed(lambda: host_encode(pcm, 16, SAMPLE_RATE,
                                              variable_divisions=1))
                    for _ in range(3))
    enc_best = best_of(torch, lambda: SRLAEncoder(param, dev).encode_whole(
        pcm))
    dec_best = best_of(torch, lambda: decode(stream, device=dev))
    print(f"phase 8 -V 1 {MAIN_SECONDS:.0f} s stereo (CLI defaults), warm "
          f"best of 3: encode {enc_best * 1e3:.1f} ms = "
          f"{MAIN_SECONDS / enc_best:.1f}x realtime (before: the host exact "
          f"encoder {host_best * 1e3:.1f} ms), decode {dec_best * 1e3:.1f} "
          f"ms = {MAIN_SECONDS / dec_best:.1f}x realtime [{card}]")
    enc = SRLAEncoder(param, dev)
    enc.timer = StepTimer(dev)
    enc.encode_whole(pcm)
    steps = enc.timer.seconds
    print("phase 8 -V 1 encode breakdown (host clock, synchronised per "
          "step, ms): " + ", ".join(f"{k} {v * 1e3:.2f}"
                                    for k, v in steps.items())
          + f"; total {sum(steps.values()) * 1e3:.2f}")
    # The measurement's largest call alone, for its peak memory.
    n = max(spans, key=lambda k: k * len(spans[k]))
    offs = spans[n]
    file = torch.from_numpy(np.ascontiguousarray(pcm, np.int16)).to(dev)
    args = enc._host._device_args(n)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    exact.measure_spans(file, offs, 0, C=2, **args)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    call_ms = cuda_ms(torch, lambda: exact.measure_spans(file, offs, 0, C=2,
                                                         **args), 3)
    print(f"phase 8 -V 1 measurement: {n_measure} calls (span lengths "
          f"{sorted(spans)}); the largest, {len(offs)} spans of {n}, "
          f"{call_ms:.1f} ms, peak device memory {peak_gb:.2f} GiB above "
          f"the resident file [{card}]")
    print(f"phase 8 K4 generic entry at the -V 3 measurement's group: "
          f"{k4_text(generic)} [{card}]")
    return launches, errs, generic, tallies, v3_case


# ---------------------------------------------------------------------------
# Long-term prediction (-P): K9 in the decode, K10 in the encode
# ---------------------------------------------------------------------------

# (path, -V, -B, samples of phase 3's audio): at -V 2 the last lookahead
# window's clipped spans, and at -B 1024 every span of 256, are under the
# 512 samples that -P analyses on the device, so the host measures them.
LTP_PATHS = (("music120_V0_P3", 0, 4096, int(MAIN_SECONDS * SAMPLE_RATE)),
             ("music120_V1_P3", 1, 4096, int(MAIN_SECONDS * SAMPLE_RATE)),
             ("music20_V2_P3", 2, 4096, int(LTP2_SECONDS * SAMPLE_RATE)),
             ("music10_V2_B1024_P3", 2, 1024,
              int(VAR2_SECONDS * SAMPLE_RATE)))


def ltp_synth_groups(torch, dev, stream: bytes) -> list:
    """K9's arguments for every decode group of ``stream`` that uses LTP,
    as ``decode2.synthesize`` hands them over: K2 and K1 on the card give
    the LPC output, the group's parameters its LTP orders, periods and
    coefficients. Returns [(blocks, n, args)]."""
    from srla_tpu_torch.decoder import SRLADecoder, upload_stream
    from srla_tpu_torch.kernels.decode2 import meta_cols
    from srla_tpu_torch.kernels.lpc import align_coefs, lpc_scan
    from srla_tpu_torch.kernels.rice_decode import rice_decode

    header, _, groups = SRLADecoder(dev).plan(stream)
    C = header.num_channels
    words = upload_stream(stream, dev)
    out = []
    for g in groups:
        if not g.has_ltp:
            continue
        cols, _ = meta_cols(C, g.M, 3)
        meta = torch.from_numpy(g.meta).to(dev)

        def col(name, width=0):
            o, w = cols[name]
            v = meta[:, o:o + w]
            return (v.reshape(-1, width) if width
                    else v.reshape(-1)).contiguous()

        res = rice_decode(words, col("word_start"), col("bit_rem"), g.n, C,
                          g.W)
        orders = col("orders")
        v = lpc_scan(res.reshape(-1, g.n).contiguous(),
                     align_coefs(col("coefs", g.M), orders, g.M), orders,
                     col("rshifts"), g.n, g.M)
        out.append((len(g.starts), g.n,
                    (v, col("ltp_orders"), col("ltp_periods"),
                     col("ltp_coefs", 3), g.n)))
    return out


def ltp_edge_args(torch, np, dev, R: int, n: int, seed: int):
    """K9 arguments at the edges: delay 9 at order 3 (period 8), order 1
    at period 8, a period-0 and an order-0 row, the largest period,
    int32-wrapping samples and the extreme coefficients; the other rows
    orders 1 and 3 at periods 8..262."""
    rng = np.random.RandomState(seed)
    v = rng.randint(-(1 << 20), 1 << 20, (R, n))
    v[:3] = rng.randint(-(1 << 31), 1 << 31, (3, n))
    lorders = rng.choice([1, 3], R)
    lperiods = rng.randint(8, 263, R)
    lcoefs = rng.randint(-32, 32, (R, 3))
    lorders[:6] = (3, 1, 3, 3, 0, 1)
    lperiods[:6] = (8, 8, 0, 262, 100, 262)
    lcoefs[:3] = (31, -32, 31)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    return (t(v), t(lorders), t(lperiods), t(lcoefs), n)


def k9_hard_args(torch, np, dev, R: int, n: int, seed: int):
    """K9 arguments that stress the new design: the shortest valid step (w =
    delay - taps + 1 = 7: order 3 at period 8), periods 8, 31, 32, 33 and
    262 at orders 1 and 3 (w at, below and above a warp), off rows (period
    0, order 0) between on rows, wrapping samples and extreme
    coefficients, R rows."""
    rng = np.random.RandomState(seed)
    v = rng.randint(-(1 << 20), 1 << 20, (R, n))
    v[::5] = rng.randint(-(1 << 31), 1 << 31, (len(v[::5]), n))
    pattern = [(3, 8), (1, 8), (0, 100), (3, 31), (1, 31), (3, 0), (3, 32),
               (1, 32), (1, 0), (3, 33), (1, 33), (0, 0), (3, 262),
               (1, 262), (3, 200)]
    lorders = np.array([pattern[r % len(pattern)][0] for r in range(R)])
    lperiods = np.array([pattern[r % len(pattern)][1] for r in range(R)])
    lcoefs = rng.randint(-32, 32, (R, 3))
    lcoefs[::4] = (31, -32, 31)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    return (t(v), t(lorders), t(lperiods), t(lcoefs), n)


def k10_random_lags(np, V: int, seed: int):
    """(V, 266) pitch lag rows, r0 = 1, of six kinds in turns: uniform in
    [-1, 1] (many short segments: the cap of 20 binds), values from a small
    set with zeros (equal peaks and lags at 0, flagged), a noisy cosine of
    period 5..300, thirds (equal peaks), +-0.1 / 0.45 / 0.5 steps, and a
    fast cosine (up to ~65 segments); zeros past lag 262."""
    rng = np.random.RandomState(seed)
    k = np.arange(263)
    rows = np.zeros((V, 266))
    for i in range(V):
        kind = i % 6
        if kind == 0:
            r = rng.uniform(-1, 1, 263)
        elif kind == 1:
            r = rng.choice([-0.3, -0.1, 0.0, 0.2, 0.5, 0.5], 263)
        elif kind == 2:
            r = (np.cos(2 * np.pi * k / rng.uniform(5, 300))
                 * rng.uniform(0.2, 1) + rng.normal(0, 0.05, 263))
        elif kind == 3:
            r = np.round(rng.uniform(-1, 1, 263) * 3) / 3
        elif kind == 4:
            r = (np.sign(rng.uniform(-1, 1, 263))
                 * rng.choice([0.1, 0.09, 0.45, 0.5], 263))
        else:
            r = 0.5 * np.cos(2 * np.pi * k / rng.uniform(2, 8))
        rows[i, :263] = r
        rows[i, 0] = 1.0
    return rows


def k10_edge_lags(np):
    """(26, 266) constructed pitch lag rows: more than 20 segments (the cap
    binds; equal neighbours in the 21st segment, which the cap keeps shut,
    flag nothing), a segment that opens at 261 and one that opens at 262
    (no segment open after the scan), two equal peaks in one segment and
    the same peak in two segments, a singular second pivot (r1 = r2 = r0
    (1 + ridge)), cosines, and 24-bit magnitudes (r0 ~ 2^47) of 11; 26
    rows, no multiple of 4, the rows a CTA."""
    from srla_tpu_torch.constants import LPC_RIDGE_REGULARIZATION_PARAMETER
    k = np.arange(266)
    head = [1.0, 0.5, 0.2, 0.1, 0.0, -0.1, -0.2, -0.3]

    def base():
        r = np.full(266, -0.3)
        r[:8] = head
        return r

    rows = []
    r = base()                              # 42 segments of 3: the cap
    r[8:262] = np.where((k[8:262] // 3) % 2 == 0, -0.3,
                        0.2 + 0.001 * k[8:262])
    rows.append(r)
    r = r.copy()                            # a tie in the 21st, kept shut
    r[130] = r[129]
    rows.append(r)
    r = base()                              # a segment opens at 261
    r[100:110], r[105] = 0.2, 0.6
    r[261], r[262] = 0.3, 0.5
    rows.append(r)
    r = base()                              # one opens at 262
    r[100:110], r[105] = 0.2, 0.6
    r[261], r[262] = -0.2, 0.58
    rows.append(r)
    r = base()                              # a segment closes at 260
    r[250:261], r[255] = 0.2, 0.61
    r[262] = 0.4
    rows.append(r)
    r = base()                              # equal peaks in one segment
    r[60:80], r[64], r[72] = 0.2, 0.5, 0.5
    rows.append(r)
    r = base()                              # the same peak in two segments
    r[60:70], r[150:160], r[64], r[154] = 0.2, 0.2, 0.5, 0.5
    rows.append(r)
    r = base()                              # 0.9 of the largest: equal
    r[60:70], r[150:160], r[64], r[154] = 0.2, 0.2, 0.45, 0.5
    rows.append(r)
    r = base()                              # a singular second pivot
    r[100:110], r[105] = 0.2, 0.6
    r[1] = r[2] = 1.0 + LPC_RIDGE_REGULARIZATION_PARAMETER
    rows.append(r)
    r = base()                              # a peak right at the cap's edge
    r[8:200] = np.where((k[8:200] // 4) % 2 == 0, -0.3, 0.25)
    r[8 + 4 * 2 * 19 + 5] = 0.7
    rows.append(r)
    rows += [0.9 * np.cos(2 * np.pi * k / p) for p in (9.0, 40.5, 262.0)]
    rows += [np.where(k % 2 == 0, 1.0, -0.5), np.zeros(266)]
    scaled = [r * 2.0 ** 47 for r in rows[:11]]   # 24-bit magnitudes
    lags = np.stack(rows + scaled)
    lags[:, 263:] = 0.0
    return lags


def check_ltp_synth(torch, what: str, groups: list) -> int:
    """K9 against its plain version on each (blocks, n, args) group."""
    from srla_tpu_torch.kernels.ltp import ltp_synth, ltp_synth_plain
    return max([0] + [check(torch, f"K9 ({what}, {B} blocks of {n})",
                            ltp_synth, ltp_synth_plain, args)
                      for B, n, args in groups])


def k9_first_design(torch, args):
    """fn() -> (R, n) outputs of K9's first design (csrc/ltp_synth_v1.cu, a
    measurement aid nothing in the port calls) on ltp_synth's arguments;
    fn takes the current stream at each call, so a CUDA graph can capture
    it."""
    import ctypes

    from srla_tpu_torch.kernels import build
    fn = build.load("ltp_synth_v1").srla_ltp_synth_v1
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    v, lo, lp, lc, n = args
    out = torch.empty_like(v)

    def run():
        err = fn(v.data_ptr(), lo.data_ptr(), lp.data_ptr(), lc.data_ptr(),
                 out.data_ptr(), v.shape[0], n, lc.shape[1],
                 torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"K9's first design failed to launch ({err})")
        return out
    return run


def k10_first_design(torch, ac, order: int):
    """fn() -> (period, coefs, risky) of K10's first design (csrc/
    ltp_analyze_v1.cu, a measurement aid nothing in the port calls) on
    ltp_analyze's arguments."""
    import ctypes

    from srla_tpu_torch.kernels import build
    fn = build.load("ltp_analyze_v1").srla_ltp_analyze_v1
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    V, dev = ac.shape[0], ac.device
    outs = (torch.empty(V, dtype=torch.int32, device=dev),
            torch.empty((V, order), dtype=torch.int32, device=dev),
            torch.empty(V, dtype=torch.bool, device=dev))

    def run():
        err = fn(ac.data_ptr(), *(t.data_ptr() for t in outs), V, order,
                 torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"K10's first design failed to launch ({err})")
        return outs
    return run


def phase_ltp_decode(torch, np, dev, card):
    """Phase 4: LTP_SECONDS of make_music at -m 6 -P 3 (the host exact
    stream) decoded on the card, counted: lossless, K9 launched once per
    LTP group; then K9 against its plain version on every LTP group of the
    stream and at the edge shapes (n 300 and the 4064-sample tail).
    Returns (the decode's launches, K9's max_abs_err)."""
    from srla_tpu_torch import SRLADecoder, decode
    from srla_tpu_torch.host_encoder import encode
    from srla_tpu_torch.kernels.ltp import ltp_synth, ltp_synth_plain
    from srla_tpu_torch.signals import make_music

    pcm4 = make_music(LTP_SECONDS)
    stream4 = encode(pcm4, 16, SAMPLE_RATE, preset=6, ltp_order=3)
    (_, out4), got = counted(torch, all_wrappers(),
                             lambda: decode(stream4, device=dev))
    require(np.array_equal(out4, pcm4), "-m 6 -P 3 decode is not lossless")
    groups = ltp_synth_groups(torch, dev, stream4)
    require(groups, "-P 3 stream uses no LTP")
    require(got["ltp_synth"] == len(groups),
            f"K9 launched {got['ltp_synth']} times by the -m 6 -P 3 decode, "
            f"expected one per LTP group ({len(groups)})")
    ngroups = len(SRLADecoder(dev).plan(stream4)[2])
    decode_launches_ok(got, ngroups, len(groups), ngroups, "-m 6 -P 3 decode")
    err = check_ltp_synth(torch, "-m 6 -P 3", groups)
    for n in (300, 4064):
        err = max(err, check(torch, f"K9 at the edges (n={n})", ltp_synth,
                             ltp_synth_plain,
                             ltp_edge_args(torch, np, dev, 70, n, n)))
    for n in (16384, 4064, 333):
        err = max(err, check(torch, f"K9 on the hard rows (n={n})",
                             ltp_synth, ltp_synth_plain,
                             k9_hard_args(torch, np, dev, 37, n, n + 7)))
    t = best_of(torch, lambda: decode(stream4, device=dev))
    print(f"phase 4 decode -m 6 -P 3 {LTP_SECONDS:.0f} s stereo: lossless, "
          f"{len(groups)} LTP groups, launches "
          f"{ {k: got[k] for k in DECODE_SHOWN} }"
          f"; K9 bit-equal to plain on every LTP group (blocks x n "
          f"{[(B, n) for B, n, _ in groups]}), at the edges (70 rows of "
          f"300 and 4064: delay 9 at order 3, order 1, period 0, order 0, "
          f"period 262, wrapping values) and on the hard rows (37 rows of "
          f"16384, 4064 and 333: periods 8, 31, 32, 33, 262, off rows "
          f"between); warm best of 3 {t * 1e3:.1f} ms = "
          f"{LTP_SECONDS / t:.1f}x realtime [{card}]")
    return got, err, pcm4, stream4


def ltp_param(V: int, B: int = 4096):
    """-m 4 -B B -V V -L 4 -P 3 for 16-bit stereo at 44.1 kHz."""
    from srla_tpu_torch.host_encoder import make_parameter
    return make_parameter(2, 16, SAMPLE_RATE, 4, B, V, 4, 3)


def device_route(groups: dict, param) -> tuple[dict, int]:
    """``groups`` ({length: [offsets]} of COMPRESS spans or blocks, all of
    even length) split as the encoder routes them: the lengths the device
    analyses (with -P, those of at least LTP_MIN_DEVICE_SIZE samples), and
    the count of the others, which the host measures or encodes in a
    counted batch (srla_tpu's rule)."""
    from srla_tpu_torch.encoder import LTP_MIN_DEVICE_SIZE
    least = LTP_MIN_DEVICE_SIZE if param.ltp_order else 0
    return ({n: o for n, o in groups.items() if n >= least},
            sum(len(o) for n, o in groups.items() if n < least))


def ltp_analysis_calls(torch, dev, pcm, param, spans: dict,
                       blocks: dict) -> list:
    """The rows of every analysis call of one -P encode: each measurement
    call's spans and each encode group's blocks, cut, stacked into variants
    and pre-emphasised as the encoder does, their pitch lags (K10's input)
    and the LTP-filtered rows the analysis gives K8's LPC lags and K3.
    Returns [(what, args, pre-emphasised rows, filtered rows, lags)]."""
    from srla_tpu_torch import SRLAEncoder
    from srla_tpu_torch.host_encoder import _compute_offset_lshift
    from srla_tpu_torch.kernels import exact
    enc = SRLAEncoder(param, dev)
    file = enc._upload(pcm)[enc.device]
    lshift = _compute_offset_lshift(pcm)
    calls = []
    for kind, groups in (("measurement call", spans),
                         ("encode group", blocks)):
        for n, offs in sorted(groups.items()):
            per_call = (max(1, SRLAEncoder.MAX_MEASURE_SAMPLES // n)
                        if kind == "measurement call"
                        else SRLAEncoder.MAX_CALL_BLOCKS)
            args = enc._host._device_args(n)
            for part in calls_of(offs, per_call):
                rows = exact.variant_stack(exact.cut_spans(file, part, n),
                                           lshift)
                pre, _, _ = exact.preemphasis_exact(rows)
                core = exact.analyze_core(exact.Spans(file, part, n),
                                          lshift, **args)
                calls.append((f"{kind}, {len(part)} of {n}", args, pre,
                              core["work"],
                              exact.ltp_lags(pre, n, args["bps"],
                                             args["fft_size"])))
    return calls


def phase_ltp_encode(torch, np, dev, music, card):
    """Phase 9, -P 3 on the card: 120 s of make_music at -m 4 -B 4096 -V 0
    -P 3 and at the CLI's defaults with -P 3 (-V 1 -L 4), and its first
    20 s at -V 2 -L 4 -P 3 and its first 10 s at -V 2 -B 1024 -L 4 -P 3,
    each encoded by
    SRLAEncoder(device="cuda"), counted: byte-identical to the host exact
    encoder, block and span accounting (the spans and blocks under 512
    samples on the host, as many as the span plan and the stream give),
    K10, K3, K4 once per device analysis call (K4 held to its plain version
    on each call's inputs) and K5 once per encode group, and the stream
    decoded losslessly on the card with K9 launched. Then K10 against its
    plain version on the
    inputs of every analysis call and K9 on every decode group; the rows
    with LTP on; each encode's warm best of 3 and step split; K10's and
    K9's times at the main shapes. Returns (each path's launches, the two
    kernels' records, each path's K7 and K8 tally)."""
    from srla_tpu_torch import SRLAEncoder, decode
    from srla_tpu_torch.encoder import StepTimer
    from srla_tpu_torch.host_encoder import encode as host_encode
    from srla_tpu_torch.kernels.ltp import (ltp_analyze, ltp_analyze_plain,
                                            ltp_synth, ltp_synth_plain)

    launches: dict = {}
    tallies: dict = {}
    err10 = err9 = 0
    k10_main = k10_tail = k9_main = k9_tail = None
    whole = music
    for path, V, B, N in LTP_PATHS:
        music = np.ascontiguousarray(whole[:, :N])
        seconds = N / SAMPLE_RATE
        param = ltp_param(V, B)
        t0 = time.perf_counter()
        stream = host_encode(music, 16, SAMPLE_RATE, max_block=B,
                             variable_divisions=V, ltp_order=3)
        host_s = time.perf_counter() - t0
        spans, host_spans = device_route(
            span_groups(music, param) if V else {}, param)
        blocks, host_blocks = device_route(
            encode_groups(music, param, stream), param)
        n_measure, n_encode = expected_calls(spans, blocks)
        enc = SRLAEncoder(param, dev)
        data, got, k4 = held_encode(torch, all_wrappers(),
                                    lambda: enc.encode_whole(music))
        require(data == stream, f"{path} encode differs from the host "
                                f"exact stream")
        s = enc.stats
        nspans = sum(len(o) for o in spans.values())
        require(s["device_spans"] + s["remeasured_spans"] == nspans
                and s["host_spans"] == host_spans,
                f"{path} span accounting {s}: {nspans} spans on the "
                f"device, {host_spans} on the host")
        ncomp = compress_blocks(stream)
        handled = (s["device_blocks"] + s["repaired_blocks"]
                   + s["w_overflow_blocks"])
        require(handled == ncomp - host_blocks
                and s["host_blocks"] == host_blocks,
                f"{path} block accounting {s}: {handled} of {ncomp} "
                f"COMPRESS blocks on the device, {host_blocks} on the host")
        calls = n_measure + n_encode
        want = {"ltp_analyze": calls, "fir_predict": calls,
                "rice_search": calls, "lpc_analyze": calls,
                "autocorr": 2 * calls,        # the pitch lags, the LPC lags
                "preemphasis": calls, "ltp_predict": calls,
                "select_blocks": n_encode, "measure_blocks": n_measure,
                "pack_residual_sections": n_encode, "bitpack": 0,
                "svr_refine_v1": 0}
        for name, count in want.items():
            require(got[name] == count, f"{path}: {name} launched "
                                        f"{got[name]} times, expected {count}")
        (_, out), dec_got = counted(torch, all_wrappers(),
                                    lambda: decode(data, device=dev))
        require(np.array_equal(out, music), f"{path} decode is not "
                                            f"lossless")
        dec_names = ("rice_decode", "lpc_synth_coefs", "ltp_synth",
                     "synth_tail")
        for name in dec_names:
            require(dec_got[name] > 0, f"{name} was not launched by the -V "
                                       f"{V} -P 3 decode")
        require(dec_got["lpc_synth"] == 0, f"{path} decode: K1's aligned "
                                           f"entry launched")
        launches[path] = {"encode": got, "decode": dec_got}
        on, checked, tally = 0, [], new_tally()
        for what, args, pre, work, lags in ltp_analysis_calls(
                torch, dev, music, param, spans, blocks):
            got10 = ltp_analyze(lags, 3)
            want10 = ltp_analyze_plain(lags, 3)
            torch.cuda.synchronize()
            e = max(max_abs_err(torch, g, w) for g, w in zip(got10, want10))
            require(e == 0, f"K10 differs from its plain version ({what}, "
                            f"max abs err {e})")
            err10 = max(err10, e)
            on += int((got10[0] > 0).sum())
            analysis_checks(torch, what, pre, work, args, tally)
            checked.append(f"{lags.shape[0]}x{what.split()[-1]}")
            if V == 0 and (k10_main is None
                           or lags.shape[0] > k10_main.shape[0]):
                k10_main = lags
            if V == 0 and (k10_tail is None
                           or lags.shape[0] < k10_tail.shape[0]):
                k10_tail = lags
        require(on > 0, f"{path}: no analysis row has LTP on")
        require(tally["k7_flag_diff"] == 0, f"{path}: K7 and its plain "
                f"version flag {tally['k7_flag_diff']} rows apart")
        tallies[path] = tally
        groups = ltp_synth_groups(torch, dev, data)
        err9 = max(err9, check_ltp_synth(torch, f"{path}", groups))
        if V == 0:
            k9_main = max(groups, key=lambda g: g[0])[2]
            k9_tail = min(groups, key=lambda g: g[0])[2]
        enc_best = best_of(torch, lambda: SRLAEncoder(param, dev).encode_whole(
            music))
        dec_best = best_of(torch, lambda: decode(data, device=dev))
        timed_enc = SRLAEncoder(param, dev)
        timed_enc.timer = StepTimer(dev)
        timed_enc.encode_whole(music)
        steps = timed_enc.timer.seconds
        print(f"phase 9 encode {seconds:.0f} s stereo -m 4 -B {B} -V {V}"
              f" -P 3 on the card: byte-identical to the host exact stream "
              f"({host_s:.2f} s on the host), {s['device_blocks']} device / "
              f"{s['repaired_blocks']} repaired / {s['w_overflow_blocks']} "
              f"overflow / {s['host_blocks']} host of {ncomp} COMPRESS "
              f"blocks; spans {s['device_spans']} device / "
              f"{s['remeasured_spans']} re-measured / {s['host_spans']} host "
              f"of {nspans + host_spans}; {n_measure} measurement calls, "
              f"{n_encode} encode groups; launches {got}; analysis rows with "
              f"LTP on: {on}; K10 bit-equal to plain on every call (rows x n "
              f"{checked}); decode on the card lossless, launches "
              f"{ {k: dec_got[k] for k in dec_names} }, K9 bit-equal to "
              f"plain on its {len(groups)} LTP groups; {held_text(k4)}; "
              f"{tally_text(tally)}; "
              f"warm "
              f"best of 3: encode {enc_best * 1e3:.1f} ms = "
              f"{seconds / enc_best:.1f}x realtime, decode "
              f"{dec_best * 1e3:.1f} ms = {seconds / dec_best:.1f}x "
              f"realtime [{card}]")
        print(f"phase 9 -B {B} -V {V} -P 3 encode breakdown (host clock, "
              f"synchronised per step, ms): "
              + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in steps.items())
              + f"; total {sum(steps.values()) * 1e3:.2f}")

    # K10 on the constructed and seeded rows (the cap, lag 262, equal
    # peaks, a singular pivot, 24-bit magnitudes; V no multiple of 4).
    hard = torch.from_numpy(np.concatenate(
        [k10_edge_lags(np), k10_random_lags(np, 61, 11)])).to(dev)
    for order in (1, 3):
        got10, want10 = ltp_analyze(hard, order), ltp_analyze_plain(hard,
                                                                    order)
        torch.cuda.synchronize()
        e = max(max_abs_err(torch, g, w) for g, w in zip(got10, want10))
        require(e == 0, f"K10 differs from its plain version on the hard "
                        f"rows (order {order}, max abs err {e})")

    # K10 at the -V 0 encode's largest call (the 1291-block group) and its
    # smallest, the first design (csrc/ltp_analyze_v1.cu) beside it in turns.
    V10 = k10_main.shape[0]
    for lags in (k10_main, k10_tail):
        old = k10_first_design(torch, lags, 3)()
        new = ltp_analyze(lags, 3)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(old, new)),
                "K10's first design and K10 differ")
    ms = cuda_ms(torch, lambda: ltp_analyze(k10_main, 3), 20)
    (v1_a, v1_b), (dev_a, dev_b) = in_turns(
        torch, k10_first_design(torch, k10_main, 3),
        lambda: ltp_analyze(k10_main, 3), 20)
    (tv1_a, tv1_b), (t_a, t_b) = in_turns(
        torch, k10_first_design(torch, k10_tail, 3),
        lambda: ltp_analyze(k10_tail, 3), 20)
    dev_ms, tail10 = min(dev_a, dev_b), min(t_a, t_b)
    plain_ms = cuda_ms(torch, lambda: ltp_analyze_plain(k10_main, 3), 1)
    step10 = chain_step_ms(torch, 5)
    # Read the lags once, write period, three coefficients and the flag
    # once; at least the two zero tests and the crossing's two compares at
    # each of the 255 lags, and some 60 operations of solve and rounding,
    # in f64. The serial floor: one solve's chain (the scans add to it).
    b10 = bound(nbytes(k10_main) + V10 * (4 + 12 + 1), V10 * (255 * 4 + 60),
                F64_OPS_PER_S)
    print(f"phase 9 K10 ltp_analyze at V={V10} x {k10_main.shape[1]} lags, "
          f"order 3: kernel {ms:.4f} ms, device time {dev_ms:.4f} ms (CUDA "
          f"graph), plain {plain_ms:.2f} ms, bound {b10['bound_ms']:.4f} ms "
          f"({b10['bound_by']}; operations {b10['ops_ms']:.6f} ms), serial "
          f"floor {step10:.4f} ms (one solve's chain); tail "
          f"V={k10_tail.shape[0]}: device time {tail10:.4f} ms; first design "
          f"(csrc/ltp_analyze_v1.cu, equal outputs) in turns old, new, new, "
          f"old: main {[v1_a, dev_a, dev_b, v1_b]}, tail "
          f"{[tv1_a, t_a, t_b, tv1_b]} ms; equal to plain on the "
          f"{hard.shape[0]} hard rows at orders 1 and 3 [{card}]")
    # K9 at the -V 0 -P 3 stream's 1291-block group and its 1-block group,
    # the first design (csrc/ltp_synth_v1.cu) beside it in turns.
    v, lo, lp, lc, n = k9_main
    for args in (k9_main, k9_tail):
        old = k9_first_design(torch, args)()
        new = ltp_synth(*args)
        torch.cuda.synchronize()
        require(torch.equal(old, new), "K9's first design and K9 differ")
    ms9 = cuda_ms(torch, lambda: ltp_synth(*k9_main), 20)
    (o9_a, o9_b), (d9_a, d9_b) = in_turns(
        torch, k9_first_design(torch, k9_main), lambda: ltp_synth(*k9_main),
        20)
    (to9_a, to9_b), (t9_a, t9_b) = in_turns(
        torch, k9_first_design(torch, k9_tail), lambda: ltp_synth(*k9_tail),
        20)
    dev9, tail9 = min(d9_a, d9_b), min(t9_a, t9_b)
    plain9 = cuda_ms(torch, lambda: ltp_synth_plain(*k9_main), 1)
    on_rows = (lp > 0) & (lo > 0)
    delay = lp.long() + (lo.long() >> 1)
    taps = lo.long().clamp(max=3)
    samples = (n - delay - 1).clamp(min=0)
    # Read v and the parameters once, write y once; per LTP sample the taps'
    # multiply-adds, the rounding add, the shift and the add of v.
    ops9 = int(torch.where(on_rows, samples * (taps + 3), 0).sum())
    b9 = bound(2 * nbytes(v) + nbytes(lo, lp, lc), ops9)
    w = (delay - taps + 1).clamp(1, 32)
    steps9 = int(torch.where(on_rows, -(-samples // w), 0).max())
    step9 = chain_step_ms(torch, 4)
    floor9 = steps9 * step9
    print(f"phase 9 K9 ltp_synth at R={v.shape[0]} n={n} "
          f"({int(on_rows.sum())} rows with LTP on, at most {steps9} steps a "
          f"row): kernel {ms9:.4f} ms, device time {dev9:.4f} ms (CUDA "
          f"graph), plain (the torch loop of ceil(n / 7) steps) "
          f"{plain9:.2f} ms, bound {b9['bound_ms']:.4f} ms "
          f"({b9['bound_by']}; operations {b9['ops_ms']:.4f} ms), serial "
          f"floor {floor9:.4f} ms ({steps9} steps of {step9 * 1e6:.1f} ns); "
          f"tail R={k9_tail[0].shape[0]} n={k9_tail[4]}: device time "
          f"{tail9:.4f} ms; first design (csrc/ltp_synth_v1.cu, equal "
          f"outputs) in turns old, new, new, old: main "
          f"{[o9_a, d9_a, d9_b, o9_b]}, tail {[to9_a, t9_a, t9_b, to9_b]} ms "
          f"[{card}]")
    recs = [dict(name="ltp_synth", route="cuda",
                 source="srla_tpu_torch/kernels/csrc/ltp_synth.cu",
                 replaces="srla_tpu/kernels/decode2.py:613",
                 max_abs_err=err9, ms=ms9, plain_ms=plain9, **b9,
                 library_ms=None, device_ms=dev9, tail_device_ms=tail9,
                 max_steps=steps9, serial_floor_ms=floor9,
                 v1_device_ms=min(o9_a, o9_b),
                 v1_tail_device_ms=min(to9_a, to9_b)),
            dict(name="ltp_analyze", route="cuda",
                 source="srla_tpu_torch/kernels/csrc/ltp_analyze.cu",
                 replaces="srla_tpu/kernels/exact.py:950",
                 max_abs_err=err10, ms=ms, plain_ms=plain_ms, **b10,
                 library_ms=None, device_ms=dev_ms, tail_device_ms=tail10,
                 serial_floor_ms=step10, v1_device_ms=min(v1_a, v1_b),
                 v1_tail_device_ms=min(tv1_a, tv1_b))]
    return launches, recs, tallies


# -P at shapes the card had not run before: 24 bits with -B 8192, and -m 6
# (max order 255) with -B 16384 (K8's rows of four 4096-sample stages).
SHAPE_SECONDS = 20.0
LTP_SHAPES = (("music20_24bit_m4_B8192_P3", 24, 4, 8192, 3),
              ("music20_m6_B16384_P1", 16, 6, 16384, 1))


def phase_ltp_shapes(torch, np, dev, card, tallies: dict):
    """Phase 11 (run before phase 10, whose tally it joins): SHAPE_SECONDS
    of make_music shifted to 24 bits at -m 4 -B 8192 -V 0 -P 3, and 16-bit
    at -m 6 -B 16384 -V 0 -P 1, each encoded by SRLAEncoder(device="cuda"),
    counted: byte-identical to the host exact encoder, block accounting
    (repaired blocks counted), K10, K7, K3, K4 and K5 once per encode group
    and K8 twice, the stream decoded losslessly on the card with K9 launched
    once per LTP group; K9 against its plain version on every LTP group,
    K10 on every encode group's pitch lags, K8 and K7 as in phase 8.
    Returns (each path's launches, K9's and K10's max_abs_err)."""
    from srla_tpu_torch import SRLAEncoder, decode
    from srla_tpu_torch.host_encoder import encode as host_encode
    from srla_tpu_torch.host_encoder import make_parameter
    from srla_tpu_torch.kernels.ltp import ltp_analyze, ltp_analyze_plain
    from srla_tpu_torch.signals import make_music

    music = make_music(SHAPE_SECONDS)
    launches: dict = {}
    err9 = err10 = 0
    for path, bps, preset, B, P in LTP_SHAPES:
        pcm = music.astype(np.int32) << (bps - 16)
        param = make_parameter(2, bps, SAMPLE_RATE, preset, B, 0, 4, P)
        t0 = time.perf_counter()
        stream = host_encode(pcm, bps, SAMPLE_RATE, preset=preset,
                             max_block=B, ltp_order=P)
        host_s = time.perf_counter() - t0
        blocks = encode_groups(pcm, param, stream)
        _, calls = expected_calls({}, blocks)
        enc = SRLAEncoder(param, dev)
        data, got, k4 = held_encode(torch, all_wrappers(),
                                    lambda: enc.encode_whole(pcm))
        require(data == stream, f"{path}: the encode differs from the host "
                                f"exact stream")
        st = enc.stats
        ncomp = compress_blocks(stream)
        handled = (st["device_blocks"] + st["repaired_blocks"]
                   + st["w_overflow_blocks"])
        require(handled == ncomp, f"{path}: block accounting {st}: "
                                  f"{handled} of {ncomp} COMPRESS blocks")
        want = {"ltp_analyze": calls, "fir_predict": calls,
                "rice_search": calls, "lpc_analyze": calls,
                "autocorr": 2 * calls, "pack_residual_sections": calls,
                "preemphasis": calls, "ltp_predict": calls,
                "select_blocks": calls, "measure_blocks": 0, "bitpack": 0}
        for name, count in want.items():
            require(got[name] == count, f"{path}: {name} launched "
                                        f"{got[name]} times, expected {count}")
        (_, out), dec_got = counted(torch, all_wrappers(),
                                    lambda: decode(data, device=dev))
        require(np.array_equal(out, pcm), f"{path}: decode is not lossless")
        groups = ltp_synth_groups(torch, dev, data)
        require(groups and dec_got["ltp_synth"] == len(groups),
                f"{path}: K9 launched {dec_got['ltp_synth']} times by the "
                f"decode, expected one per LTP group ({len(groups)})")
        err9 = max(err9, check_ltp_synth(torch, path, groups))
        launches[path] = {"encode": got, "decode": dec_got}
        on, checked, tally = 0, [], new_tally()
        for what, args, pre, work, lags in ltp_analysis_calls(
                torch, dev, pcm, param, {}, blocks):
            got10 = ltp_analyze(lags, P)
            want10 = ltp_analyze_plain(lags, P)
            torch.cuda.synchronize()
            e = max(max_abs_err(torch, g, w) for g, w in zip(got10, want10))
            require(e == 0, f"K10 differs from its plain version ({path}, "
                            f"{what}, max abs err {e})")
            err10 = max(err10, e)
            on += int((got10[0] > 0).sum())
            analysis_checks(torch, what, pre, work, args, tally)
            checked.append(f"{lags.shape[0]}x{what.split()[-1]}")
        require(on > 0, f"{path}: no analysis row has LTP on")
        require(tally["k7_flag_diff"] == 0, f"{path}: K7 and its plain "
                f"version flag {tally['k7_flag_diff']} rows apart")
        tallies[path] = tally
        print(f"phase 11 encode {SHAPE_SECONDS:.0f} s stereo {bps}-bit -m "
              f"{preset} -B {B} -V 0 -P {P} on the card: byte-identical to "
              f"the host exact stream ({host_s:.2f} s on the host), "
              f"{st['device_blocks']} device / {st['repaired_blocks']} "
              f"repaired / {st['w_overflow_blocks']} overflow of {ncomp} "
              f"COMPRESS blocks; {calls} encode groups; launches {got}; "
              f"analysis rows with LTP on: {on}; K10 bit-equal to plain on "
              f"every call (rows x n {checked}); decode on the card lossless, "
              f"K9 launched once per LTP group ({len(groups)}) and bit-equal "
              f"to plain on each (blocks x n "
              f"{[(b, n) for b, n, _ in groups]}); {held_text(k4)}; "
              f"{tally_text(tally)} "
              f"[{card}]")
    return launches, err9, err10


# ---------------------------------------------------------------------------
# K7 and K8: the encode's f64 analysis
# ---------------------------------------------------------------------------

K7_MOVE = 2.0 ** -42             # the lag error the K7 margins allow for


def moved(np, lags):
    """lags with every entry moved by K7_MOVE, up and down in turns: the
    lag error the order choice's and the quantization's margins are sized
    for (kernels/levinson.py, above _EPS_SILENT)."""
    signs = np.where(np.arange(lags.size) % 2 == 0, 1.0, -1.0)
    return lags * (1.0 + K7_MOVE * signs.reshape(lags.shape))


def host_lpc(np, lags, n: int, bps: int, M: int, max_fixed: bool):
    """The host's decisions on lags (V, M + 1) f64 with the ridge on lag 0:
    its Levinson recursion, order choice on the window-corrected error
    variances and quantization (host_encoder.SRLAEncoder._analyze_channel's
    chain). Returns (orders, rshifts, intc (V, M) left-aligned)."""
    from srla_tpu_torch.constants import (LPC_COEFFICIENT_BITWIDTH,
                                          RSHIFT_LPC_COEFFICIENT_BITWIDTH)
    from srla_tpu_torch.dsp.levinson import (levinson_coefs_at,
                                             levinson_error_vars)
    from srla_tpu_torch.dsp.quantize import quantize_coefficients
    from srla_tpu_torch.dsp.window import welch_inverse_squared_sum
    from srla_tpu_torch.host_encoder import EncodeParameter, SRLAEncoder
    ev, _ = levinson_error_vars(lags, M)
    if max_fixed:
        orders = np.full(lags.shape[0], M, np.int32)
    else:
        param = EncodeParameter(num_channels=1, bits_per_sample=bps,
                                sampling_rate=SAMPLE_RATE, preset=4,
                                min_num_samples_per_block=n,
                                max_num_samples_per_block=n,
                                num_lookahead_samples=n)
        orders = SRLAEncoder(param)._select_order(
            ev * welch_inverse_squared_sum(n), n, M)
    coefs = levinson_coefs_at(lags, M, orders)
    intc, rshifts = quantize_coefficients(
        coefs, orders, LPC_COEFFICIENT_BITWIDTH,
        1 << RSHIFT_LPC_COEFFICIENT_BITWIDTH)
    return np.asarray(orders), np.asarray(rshifts), np.asarray(intc)


def lags_from_reflections(np, r0, refl):
    """Lags (V, M + 1) on which the Levinson recursion of
    kernels/levinson.py (a1 = -r1 / r0, then gamma = sum_j a[j] r[m - j] /
    -ev) meets the reflection coefficients refl (V, M): the step-up
    recursion, in f64."""
    V, M = refl.shape
    r = np.zeros((V, M + 1))
    a = np.zeros((V, M + 1))
    r[:, 0] = r0
    r[:, 1] = -refl[:, 0] * r0
    a[:, 0], a[:, 1] = 1.0, refl[:, 0]
    ev = r0 * (1.0 - refl[:, 0] ** 2)
    for m in range(2, M + 1):
        g = refl[:, m - 1]
        r[:, m] = -g * ev - (a[:, 1:m] * r[:, m - 1:0:-1]).sum(axis=1)
        ev = ev * (1.0 - g * g)
        a[:, :m + 1] = a[:, :m + 1] + g[:, None] * a[:, m::-1]
    return r


def reflections_from_coefs(np, coefs):
    """The reflection coefficients (V, p) of the order-p coefficient
    vectors coefs (V, p) (levinson.py's a[1..p]): the step-down
    recursion."""
    V, p = coefs.shape
    a = np.concatenate([np.ones((V, 1)), coefs], axis=1)
    refl = np.zeros((V, p))
    for m in range(p, 1, -1):
        g = a[:, m].copy()
        refl[:, m - 1] = g
        a = (a[:, :m + 1] - g[:, None] * a[:, m::-1]) / (1.0 - g * g)[:, None]
        a = a[:, :m]
    refl[:, 0] = a[:, 1]
    return refl


def k7_order_tie_case(np):
    """Lags (n 4096, 16 bits, M 32) whose best order is 9 and whose
    runner-up, 17, is longer on the host by each of the gaps below (bisection
    on the reflection coefficient that makes order 17, the host's lengths
    computed by the host's own Levinson on the lags)."""
    from srla_tpu_torch.dsp.levinson import levinson_error_vars
    from srla_tpu_torch.dsp.window import welch_inverse_squared_sum
    n, bps, M = 4096, 16, 32
    gaps = np.array([0.0, 1e-9, -1e-9, 1e-7, -1e-7, 5e-7, -5e-7, 1e-3,
                     -1e-3, 0.5, -0.5])
    rng = np.random.RandomState(5)
    g2 = np.tile(rng.uniform(0.0, 0.002, M), (gaps.size, 1))
    g2[:, 8] = 0.3                              # a real gain at order 9

    def lengths(g2):
        lags = lags_from_reflections(np, 0.02, np.sqrt(g2))
        ev = levinson_error_vars(lags, M)[0] * welch_inverse_squared_sum(n)
        mabse = 2.0 * np.sqrt(ev[:, 1:] / 2.0)
        rho = 1.0 / (1.0 + mabse * float(1 << (bps - 1)))
        ent = -((1.0 - rho) * np.log2(1.0 - rho) + rho * np.log2(rho)) / rho
        return lags, ent * n + 8.0 * np.arange(1, M + 1)

    lo, hi = np.zeros(gaps.size), np.full(gaps.size, 0.2)
    for _ in range(80):
        g2[:, 16] = 0.5 * (lo + hi)
        _, ln = lengths(g2)
        longer = ln[:, 16] - ln[:, 8] > gaps
        lo = np.where(longer, g2[:, 16], lo)
        hi = np.where(longer, hi, g2[:, 16])
    g2[:, 16] = hi
    lags, _ = lengths(g2)
    gap = np.abs(gaps)
    return "order tie", lags, n, bps, M, False, gap <= 5e-7, gap >= 1e-3


def k7_quantize_case(np):
    """Lags (M 4, the order fixed) whose order-4 coefficients are the
    quantization rows of tests/test_torch_encode_margins.py: max |coef|
    0.88, one coefficient on a rounding half, a few ulps, 1e-9, 1e-5 and
    0.17 steps beside it; max |coef| at the frexp edge 0.5 and below it;
    the smallest representable step and its neighbours; and rows away
    from every edge."""
    step = 2.0 ** -7
    rows, flag, clear = [], [], []
    for off in (0.0, 2.0 ** -45, -2.0 ** -45, 1e-9, -1e-9, 1e-5, -1e-5,
                0.17, -0.17):
        for half in (20.5, -37.5):
            rows.append([0.88, 0.25, (half + off) * step, 12 * step])
            flag.append(abs(off) <= 1e-9)
            clear.append(abs(off) >= 1e-5)
    for top in (0.5, np.nextafter(0.5, 0.0), 0.5 * (1 - 1e-8), step,
                np.nextafter(step, 1.0), np.nextafter(step, 0.0)):
        rows.append([top, 0.3 * top, -0.2 * top, 0.1 * top])
        flag.append(True)
        clear.append(False)
    for top in (0.7, 0.3, 100 * step):
        rows.append([top, 0.3 * top, -0.21 * top, 0.13 * top])
        flag.append(False)
        clear.append(False)
    refl = reflections_from_coefs(np, np.asarray(rows))
    return ("quantization half and shift edges",
            lags_from_reflections(np, 1.0, refl), 4096, 16, 4, True,
            np.asarray(flag), np.asarray(clear))


def k7_silent_case(np):
    """Lags (M 8) of an order-1 process whose r0 sits on the silent
    threshold FLT_EPSILON, 1e-9, 5e-7, 1e-3 and 0.5 (relative) beside it."""
    from srla_tpu_torch.kernels.levinson import FLT_EPSILON
    rel = np.array([0.0, 1e-9, -1e-9, 5e-7, -5e-7, 1e-3, -1e-3, 0.5, -0.5])
    lags = (FLT_EPSILON * (1.0 + rel))[:, None] * 0.9 ** np.arange(9)
    return ("silent threshold", lags, 4096, 16, 8, False,
            np.abs(rel) <= 5e-7, np.abs(rel) >= 1e-3)


def k7_growth_case(np, M: int):
    """Lags (1, M + 1) on which the recursion meets the reflection
    coefficient +-5/32 at every order (the step-up recursion in exact
    rationals): each order saves more than its 8 bits at n 1024, so the
    argmin is at M, and the coefficients grow to sum |a| ~ 1.6e3, 1.2e7 and
    3.3e9 at M 64, 128 and 255. The widened conditioning estimate
    (kernels/levinson.py, above _EPS_SILENT) must flag the row at M >= 128,
    where lags moved by 2^-42 change the order by tens, and leave it alone at
    M 64, where they change nothing."""
    from fractions import Fraction
    r, a, ev = [Fraction(1)], [Fraction(1)], Fraction(1)
    for m in range(1, M + 1):
        g = Fraction(5 * (-1) ** (m - 1), 32)
        r.append(-g * ev - sum(a[j] * r[m - j] for j in range(1, m)))
        a = [x + g * y for x, y in zip(a + [Fraction(0)],
                                       [Fraction(0)] + a[::-1])]
        ev *= 1 - g * g
    lags = np.asarray([[float(v) for v in r]])
    return (f"coefficient growth at M {M}", lags, 1024, 16, M, False,
            np.asarray([M >= 128]), np.asarray([M <= 64]))


def k7_boundary_cases(np) -> list:
    """[(name, lags, n, bps, M, max_fixed, must_flag, must_not_flag)]: lag
    rows that drive K7's decisions to their boundaries."""
    return [k7_order_tie_case(np), k7_quantize_case(np), k7_silent_case(np)]


K7Q_BATCH_ROWS = 32 * 37 + 13          # no multiple of a warp's 4 rows
K7Q_WIDENINGS = (0.0, 1e-9, 1e-6)      # cerr of the boundary rows


def k7_quantize_batch(np, V: int, M: int, seed: int):
    """Arguments of K7's quantization entry, (coefs (V, M) f64, orders (V,)
    int32, kappa (V,) f64, cerr (V,) f64) as numpy arrays: rows of largest
    |c| from 3e-4 to 2, orders 0..M (0, 1, M and M among the first four),
    values past each order that must not count (a NaN and an inf among
    them), kappa' from 1 to 1e8, cerr 0 on a third of the rows and up to
    1e-6 relative on the others; and rows at the edges: tiny (largest |c|
    2^-9 and exactly the tiny threshold 2^-7), all zero, a NaN and an inf
    inside the order, largest |c| exactly 0.5 and just below 1."""
    rng = np.random.RandomState(seed)
    orders = rng.randint(0, M + 1, V)
    orders[:4] = (0, 1, M, M)
    mag = 10.0 ** rng.uniform(-3.5, 0.3, V)
    coefs = rng.uniform(-1.0, 1.0, (V, M)) * mag[:, None]
    kappa = 10.0 ** rng.uniform(0.0, 8.0, V)
    cerr = np.where(rng.uniform(size=V) < 1 / 3, 0.0,
                    mag * 10.0 ** rng.uniform(-16.0, -6.0, V))
    edge = 4 + np.arange(9)
    orders[edge] = max(M // 2, 2)
    for row, top in ((4, 2.0 ** -9), (5, 2.0 ** -7), (9, 0.5),
                     (10, np.nextafter(1.0, 0.0))):
        j = int(np.abs(coefs[row, :orders[row]]).argmax())
        coefs[row] *= top / abs(coefs[row, j])
        coefs[row, j] = np.copysign(top, coefs[row, j])
    coefs[6, :orders[6]] = 0.0
    coefs[7, 1] = np.nan
    coefs[8, 0] = np.inf
    coefs[11, orders[11]:] = np.nan
    coefs[12, orders[12]:] = np.inf
    return coefs, orders.astype(np.int32), kappa, cerr


def check_flag_contract(np, what: str, port, host, risky, must_flag=None,
                        must_not_flag=None) -> None:
    """port == host on every row the port does not flag; the rows on a
    boundary are flagged, the rows well away from one are not. port and
    host are (orders, rshifts, intc) triples."""
    differs = np.zeros(len(risky), bool)
    for p, h in zip(port, host):
        d = np.asarray(p) != np.asarray(h)
        differs |= d.reshape(len(risky), -1).any(axis=1)
    require(not (differs & ~risky).any(), f"{what}: rows "
            f"{np.flatnonzero(differs & ~risky)[:8]} differ from the host "
            f"unflagged")
    if must_flag is not None:
        require(risky[must_flag].all(), f"{what}: boundary rows "
                f"{np.flatnonzero(must_flag & ~risky)} are not flagged")
    if must_not_flag is not None:
        require(not risky[must_not_flag].any(), f"{what}: rows "
                f"{np.flatnonzero(must_not_flag & risky)} far from a "
                f"boundary are flagged")


def exact_lag_errors(np, work, got, n: int, bps: int, F: int, lags):
    """The largest distance, in r0, of the lags ``got`` (R, L) of the rows
    work (R, n) from the exact rational circular autocorrelation."""
    from fractions import Fraction

    from srla_tpu_torch.kernels.autocorr import scaled_window
    worst = 0.0
    win = scaled_window(n, bps)
    for r in range(work.shape[0]):
        d = [Fraction(float(v)) for v in work[r].astype(np.float64) * win]
        r0 = sum(v * v for v in d) * Fraction(F, n)
        for k in lags:
            want = sum(d[i] * d[(i + k) % F] for i in range(n)
                       if (i + k) % F < n) * Fraction(F, n)
            worst = max(worst, float(abs(Fraction(float(got[r, k])) - want)
                                     / r0))
    return worst


def exact_rows(np, n: int, bps: int):
    """Two rows of n samples: full-scale noise and a loud sine."""
    rng = np.random.RandomState(n)
    hi = 1 << (bps - 1)
    return np.stack([rng.randint(-hi, hi, n),
                     np.round(np.sin(np.arange(n) * 0.031) * (hi - 1))]
                    ).astype(np.int32)


def k8_first_design(torch, work, n: int, bps: int, L: int, F: int):
    """fn() -> (V, L) lags of work by K8's first design (csrc/
    autocorr_v1.cu, a measurement aid nothing in the port calls), on the
    same inputs as autocorr. fn takes the current stream at each call, so a
    CUDA graph can capture it."""
    import ctypes

    from srla_tpu_torch.kernels import build
    from srla_tpu_torch.kernels.autocorr import scaled_window
    fn = build.load("autocorr_v1").srla_autocorr_v1
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    win = torch.from_numpy(scaled_window(n, bps).copy()).to(work.device)
    out = torch.empty((work.shape[0], L), dtype=torch.float64,
                      device=work.device)

    def run():
        err = fn(work.data_ptr(), win.data_ptr(), out.data_ptr(),
                 work.shape[0], n, L, F,
                 torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"K8's first design failed to launch ({err})")
        return out
    return run


def k7_first_design(torch, ac, n: int, bps: int, M: int, fixed: bool):
    """fn() -> (orders, rshifts, intc, risky) of K7's first design (csrc/
    lpc_analyze_v1.cu, a measurement aid nothing in the port
    calls), on the same inputs as lpc_analyze."""
    import ctypes

    from srla_tpu_torch.constants import (LPC_COEFFICIENT_BITWIDTH,
                                          RSHIFT_LPC_COEFFICIENT_BITWIDTH)
    from srla_tpu_torch.dsp.window import welch_inverse_squared_sum
    from srla_tpu_torch.kernels import build
    fn = build.load("lpc_analyze_v1").srla_lpc_analyze_v1
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
        + [ctypes.c_double, ctypes.c_void_p]
    V, dev = ac.shape[0], ac.device
    outs = (torch.empty(V, dtype=torch.int32, device=dev),
            torch.empty(V, dtype=torch.int32, device=dev),
            torch.empty((V, M), dtype=torch.int32, device=dev),
            torch.empty(V, dtype=torch.bool, device=dev))

    def run():
        err = fn(ac.data_ptr(), *(t.data_ptr() for t in outs), V, n, bps, M,
                 int(fixed), LPC_COEFFICIENT_BITWIDTH,
                 1 << RSHIFT_LPC_COEFFICIENT_BITWIDTH,
                 welch_inverse_squared_sum(n),
                 torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"K7's first design failed to launch ({err})")
        return outs
    return run


def in_turns(torch, old, new, reps: int, timer=None) -> tuple:
    """Device times (CUDA graph replay; or ``timer``, such as cuda_ms) of
    two versions of a kernel in turns, old, new, new, old: ((old, old),
    (new, new)) ms."""
    timer = timer or device_ms
    a = timer(torch, old, reps)
    b = timer(torch, new, reps)
    c = timer(torch, new, reps)
    d = timer(torch, old, reps)
    return (a, d), (b, c)


def phase_analysis(torch, np, dev, pcm, card, tallies: dict):
    """Phase 10, K8 and K7 on the card. On phase 6's two analysis calls
    (the main path's 1291-block group and 1-block tail group) K8 and K7
    against their plain versions (analysis_checks), no flag changed by K7;
    K8 within 2^-46 r0 of the exact rational sum on rows of 16384 samples at
    24 bits, 4064, 333 and 20000 (five stages) at lags 0, 1, 7, 64 and 262;
    K7 at M 255 on the main group's lags against the host and its plain
    version, and on the boundary rows (k7_boundary_cases, lags moved by
    2^-42) against the host: every row whose decisions differ is flagged.
    Times K8 at 65 lags (the LPC lags) and 263 (the pitch lags) beside its
    plain version and the cuFFT route (rfft, |X|^2, irfft), K7 at M 64
    beside its plain version and its serial floor, both at the tail
    group's shape too, and both beside their first designs (csrc/*_v1.cu)
    in turns on the same inputs. Returns the two kernels' records."""
    from srla_tpu_torch.constants import LPC_RIDGE_REGULARIZATION_PARAMETER
    from srla_tpu_torch.dsp.fft import round_up_pow2
    from srla_tpu_torch.kernels import exact
    from srla_tpu_torch.kernels.autocorr import (autocorr, autocorr_plain,
                                                 scaled_window)
    from srla_tpu_torch.kernels.levinson import lpc_analyze, lpc_analyze_plain
    from srla_tpu_torch.kernels.ltp import LTP_LAGS

    tally = new_tally()
    groups = []
    for tail in (False, True):
        blocks, B, args, _ = main_group(torch, np, dev, pcm, tail=tail)
        _, _, core = exact.variant_analysis(blocks, 0, **args)
        analysis_checks(torch, f"encode group, {B} of {args['n']}", None,
                        core["work"], args, tally)
        groups.append((core["work"], args))
    require(tally["k7_flag_diff"] == 0, f"phase 6's calls: K7 and its plain "
            f"version flag {tally['k7_flag_diff']} rows apart")
    tallies["music120_V0"] = tally
    (work, args), (tail_work, tail_args) = groups
    V, n = work.shape
    bps, F, M = args["bps"], args["fft_size"], args["max_params"]

    # K8: the LPC lags and the pitch lags of the main group, the tail's.
    k8 = {}
    for L in (M + 1, LTP_LAGS):
        def run(L=L):
            return autocorr(work, n, bps, L, F)

        win = torch.from_numpy(scaled_window(n, bps).copy()).to(dev)

        def cufft(L=L):
            spec = torch.fft.rfft(work.double() * win, n=F)
            return torch.fft.irfft(spec.real ** 2 + spec.imag ** 2,
                                   n=F)[:, :L] * (float(F) / float(n))

        want = autocorr_plain(work, n, bps, L, F)
        fft_err = float(((cufft() - want).abs()
                         / want[:, :1].abs().clamp(min=1e-300)).max())
        # Read the samples and the window once, write the lags once; per
        # row and lag the products whose two samples are both inside the
        # row (n - k linear, k - (F - n) wrapped), a multiply and an add
        # each, in f64.
        pairs = sum((n - k) + max(0, k - (F - n)) for k in range(L))
        b = bound(nbytes(work) + n * 8 + V * L * 8, 2 * V * pairs,
                  F64_TENSOR_OPS_PER_S)
        v1 = k8_first_design(torch, work, n, bps, L, F)
        require(bool(((v1() - want).abs() <= want[:, :1].abs()
                      * 2.0 ** -45).all()),
                f"K8's first design is off its plain version at {L} lags")
        (v1_a, v1_b), (dev_a, dev_b) = in_turns(torch, v1, run, 10)
        k8[L] = dict(lags=L, ms=cuda_ms(torch, run, 10),
                     device_ms=min(dev_a, dev_b), device_ms_turns=[
                         v1_a, dev_a, dev_b, v1_b],
                     v1_device_ms=min(v1_a, v1_b),
                     plain_ms=cuda_ms(torch, lambda L=L: autocorr_plain(
                         work, n, bps, L, F), 1),
                     library_ms=cuda_ms(torch, cufft, 10),
                     library_err_r0=fft_err,
                     vector_bound_ms=2 * V * pairs / F64_OPS_PER_S * 1e3, **b)
    tail_n, tail_F = tail_args["n"], tail_args["fft_size"]
    (v1_t, v1_t2), (k8_t, k8_t2) = in_turns(
        torch, k8_first_design(torch, tail_work, tail_n, bps, M + 1, tail_F),
        lambda: autocorr(tail_work, tail_n, bps, M + 1, tail_F), 20)
    k8_tail, k8_tail_v1 = min(k8_t, k8_t2), min(v1_t, v1_t2)
    exact_err, exact_checked = 0.0, []
    for en, ebps in ((16384, 24), (4064, 16), (333, 16), (20000, 24)):
        rows = exact_rows(np, en, ebps)
        eF = round_up_pow2(en)
        t = torch.from_numpy(rows).to(dev)
        got = autocorr(t, en, ebps, LTP_LAGS, eF)
        want = autocorr_plain(t, en, ebps, LTP_LAGS, eF)
        torch.cuda.synchronize()
        require(bool(((got - want).abs() <= want[:, :1].abs()
                      * 2.0 ** -45).all()),
                f"K8 is more than 2^-45 r0 from its plain version at n {en}")
        e = exact_lag_errors(np, rows, got.cpu().numpy(), en, ebps, eF,
                             (0, 1, 7, 64, 262))
        require(e <= 2.0 ** -46, f"K8 is {e:.3g} r0 from the exact sum at "
                                 f"n {en} (limit 2^-46)")
        exact_err = max(exact_err, e)
        exact_checked.append(en)
    m = k8[M + 1]
    p = k8[LTP_LAGS]
    print(f"phase 10 K8 autocorr at V={V} n={n}: {M + 1} lags kernel "
          f"{m['ms']:.4f} ms, device time {m['device_ms']:.4f} ms, plain "
          f"{m['plain_ms']:.2f} ms, cuFFT route {m['library_ms']:.4f} ms "
          f"(within {m['library_err_r0']:.3g} r0), bound {m['bound_ms']:.4f} "
          f"ms ({m['bound_by']}); {LTP_LAGS} lags kernel {p['ms']:.4f} ms, "
          f"device time {p['device_ms']:.4f} ms, plain {p['plain_ms']:.2f} "
          f"ms, cuFFT route {p['library_ms']:.4f} ms (within "
          f"{p['library_err_r0']:.3g} r0), bound {p['bound_ms']:.4f} ms "
          f"({p['bound_by']}); tail V={tail_work.shape[0]} n={tail_n}: "
          f"device time {k8_tail:.4f} ms; within {exact_err:.3g} r0 of the "
          f"exact sum at n {exact_checked} [{card}]")
    print(f"phase 10 K8 first design (csrc/autocorr_v1.cu) against "
          f"now, device time in turns old, new, new, old: {M + 1} lags "
          f"{m['device_ms_turns']}, {LTP_LAGS} lags "
          f"{p['device_ms_turns']}, tail {[v1_t, k8_t, k8_t2, v1_t2]} ms; "
          f"bounds on the f64 tensor cores {m['bound_ms']:.4f} and "
          f"{p['bound_ms']:.4f} ms, on the f64 vector pipe "
          f"{m['vector_bound_ms']:.4f} and {p['vector_bound_ms']:.4f} ms "
          f"[{card}]")

    # K7: the main group's ridged K8 lags, at M 64 and 255.
    def ridged(L, rows=work, rn=n, rF=F):
        ac = autocorr(rows, rn, bps, L, rF)
        ac[:, 0] = ac[:, 0] * (1.0 + LPC_RIDGE_REGULARIZATION_PARAMETER)
        return ac

    ac, tail_ac = ridged(M + 1), ridged(M + 1, tail_work, tail_n, tail_F)
    fixed = args["max_fixed"]

    def run7():
        return lpc_analyze(ac, n, bps, M, fixed)

    orders = run7()[0].long()
    v1_7 = k7_first_design(torch, ac, n, bps, M, fixed)
    old7, new7 = v1_7(), run7()
    same = ~old7[3] & ~new7[3]
    require(torch.equal(old7[3], new7[3])
            and all(torch.equal(a[same], b[same])
                    for a, b in zip(old7[:3], new7[:3])),
            "K7's first design and K7 differ on the main group")
    ms7 = cuda_ms(torch, run7, 20)
    (v1_a, v1_b), (dev_a, dev_b) = in_turns(torch, v1_7, run7, 20)
    dev7, dev7_v1 = min(dev_a, dev_b), min(v1_a, v1_b)
    plain7 = cuda_ms(torch, lambda: lpc_analyze_plain(ac, n, bps, M, fixed),
                     1)
    (tv1_a, tv1_b), (t_a, t_b) = in_turns(
        torch, k7_first_design(torch, tail_ac, tail_n, bps, M, fixed),
        lambda: lpc_analyze(tail_ac, tail_n, bps, M, fixed), 20)
    tail7, tail7_v1 = min(t_a, t_b), min(tv1_a, tv1_b)
    step = chain_step_ms(torch, 3)
    step_v1 = chain_step_ms(torch, 2)
    # Read the lags once, write orders, shifts, coefficients and the flag
    # once; per row the first recursion (a sum of m products and the
    # update of m + 1 coefficients, each a multiply and an add, and some
    # five operations, m = 2..M), the order choice (~30 operations an
    # order, the logarithms counted as 20) and the quantization (~8 an
    # order), in f64.
    mm = torch.arange(2, M + 1, dtype=torch.float64)
    first = float((4 * mm + 7).sum())
    ops7 = V * (first + 30 * M) + float((8 * orders).sum())
    b7 = bound(nbytes(ac) + V * (4 + 4 + 4 * M + 1), ops7, F64_OPS_PER_S)
    floor7 = (M - 1) * step
    ac255 = ridged(256)
    got = [t.cpu().numpy() for t in lpc_analyze(ac255, n, bps, 255, False)]
    plain = [t.cpu().numpy()
             for t in lpc_analyze_plain(ac255, n, bps, 255, False)]
    host = host_lpc(np, ac255.cpu().numpy(), n, bps, 255, False)
    check_flag_contract(np, "K7 at M 255", got[:3], host, got[3])
    both = ~got[3] & ~plain[3]
    require(all((g[both] == w[both]).all() for g, w in zip(got, plain)),
            "K7 at M 255 differs from its plain version on a row neither "
            "flags")
    diff255 = int((got[3] != plain[3]).sum())
    bnames = []
    for name, lags, bn, bb, bM, bfixed, must, must_not in \
            k7_boundary_cases(np):
        port = [t.cpu().numpy() for t in lpc_analyze(
            torch.from_numpy(moved(np, lags)).to(dev), bn, bb, bM, bfixed)]
        check_flag_contract(np, f"K7 on the {name} rows", port[:3],
                            host_lpc(np, lags, bn, bb, bM, bfixed), port[3],
                            must, must_not)
        bnames.append(f"{name} ({int(port[3].sum())} of {len(lags)} "
                      f"flagged)")
    for gM in (64, 128, 255):
        name, lags, bn, bb, bM, bfixed, must, must_not = \
            k7_growth_case(np, gM)
        ac_g = torch.from_numpy(moved(np, lags))
        port = [t.cpu().numpy() for t in lpc_analyze(ac_g.to(dev), bn, bb,
                                                     bM, bfixed)]
        plain_g = lpc_analyze_plain(ac_g, bn, bb, bM, bfixed)
        require(bool((plain_g[3].numpy() == port[3]).all()),
                f"K7 and its plain version flag the {name} row apart")
        check_flag_contract(np, f"K7 on the {name} row", port[:3],
                            host_lpc(np, lags, bn, bb, bM, bfixed), port[3],
                            must, must_not)
        bnames.append(f"{name} (order {int(port[0][0])}, host "
                      f"{int(host_lpc(np, lags, bn, bb, bM, bfixed)[0][0])}"
                      f", flagged {bool(port[3][0])})")
    print(f"phase 10 K7 lpc_analyze at V={V} M={M} (orders up to "
          f"{int(orders.max())}): kernel {ms7:.4f} ms, device time "
          f"{dev7:.4f} ms, plain {plain7:.2f} ms, bound {b7['bound_ms']:.4f} "
          f"ms ({b7['bound_by']}), serial floor {floor7:.4f} ms ({M - 1} "
          f"steps of {step * 1e3:.3f} us); tail V={tail_ac.shape[0]}: device "
          f"time {tail7:.4f} ms; first design (csrc/lpc_analyze_v1.cu"
          f", equal outputs) in turns old, new, new, old: main "
          f"{[v1_a, dev_a, dev_b, v1_b]}, tail {[tv1_a, t_a, t_b, tv1_b]} "
          f"ms, its serial floor {(M - 1) * step_v1:.4f} ms "
          f"({step_v1 * 1e3:.3f} us a step); at M 255 on the same rows "
          f"every decision "
          f"that differs from the host's flagged ({int(got[3].sum())} "
          f"flagged), equal to plain where neither flags, flags apart from "
          f"plain on {diff255} rows; boundary rows against the host: "
          f"{'; '.join(bnames)} [{card}]")

    err8 = max(t["k8_err"] for t in tallies.values())
    err8_r0 = max(t["k8_err_r0"] for t in tallies.values())
    flags7 = sum(t["k7_flag_diff"] for t in tallies.values())
    flags8 = sum(t["k8_flag_diff"] for t in tallies.values())
    print(f"phase 10 K8 and K7 against their plain versions on every "
          f"analysis call of phases 6, 8 and 9: K8 within {err8_r0:.3g} r0 "
          f"(max abs {err8:.3g}); rows whose flag K7 changes "
          f"{flags7}, whose flag K8's lags change {flags8}; by path "
          + json.dumps({k: {f: t[f] for f in ("calls", "rows",
                                              "k7_flag_diff",
                                              "k8_flag_diff")}
                        for k, t in tallies.items()}))
    lpc, pitch = k8[M + 1], k8[LTP_LAGS]
    return [dict(name="autocorr", route="cuda",
                 source="srla_tpu_torch/kernels/csrc/autocorr.cu",
                 replaces="srla_tpu/kernels/exact.py:108",
                 max_abs_err=err8, max_err_r0=err8_r0,
                 exact_err_r0=exact_err, ms=lpc["ms"],
                 plain_ms=lpc["plain_ms"], bound_ms=lpc["bound_ms"],
                 bound_by=lpc["bound_by"], ops_ms=lpc["ops_ms"],
                 library_ms=lpc["library_ms"], device_ms=lpc["device_ms"],
                 tail_device_ms=k8_tail, v1_device_ms=lpc["v1_device_ms"],
                 v1_tail_device_ms=k8_tail_v1, flag_changes=flags8,
                 pitch_lags=pitch),
            dict(name="lpc_analyze", route="cuda",
                 source="srla_tpu_torch/kernels/csrc/lpc_analyze.cu",
                 replaces="srla_tpu/kernels/exact.py:150",
                 max_abs_err=0, flag_changes=flags7, ms=ms7,
                 plain_ms=plain7, **b7, library_ms=None, device_ms=dev7,
                 tail_device_ms=tail7, serial_floor_ms=floor7,
                 v1_device_ms=dev7_v1, v1_tail_device_ms=tail7_v1,
                 v1_serial_floor_ms=(M - 1) * step_v1,
                 flag_changes_m255=diff255)]


# ---------------------------------------------------------------------------
# K11 and K12: SVR refinement (--svr-filter-learning-iteration)
# ---------------------------------------------------------------------------

SVR_ITER = 2                     # the step runs from 2 iterations on
# (path, seconds, preset, max block, -V, -P): byte identity against the
# host exact encoder, whose SVR takes seconds per second of audio.
SVR_CASES = (("music5_m4_svr2", 5.0, 4, 4096, 0, 0),
             ("music5_m4_P3_svr2", 5.0, 4, 4096, 0, 3),
             ("music1.5_V1_svr2", 1.5, 4, 4096, 1, 0),
             ("music1_m6_B16384_svr2", 1.0, 6, 16384, 0, 0))
SVR_REPAIR_WARN = 0.05           # repair rate above which phase 12 warns
# The H100's f64 instructions a second outside the tensor cores: a
# multiply, an add or a fused multiply-add each take one issue slot of the
# 34 TFLOP/s (counted as two operations a multiply-add).
F64_INSTR_PER_S = F64_OPS_PER_S / 2


def svr_param(preset: int, B: int, V: int, P: int):
    from srla_tpu_torch.host_encoder import make_parameter
    return make_parameter(2, 16, SAMPLE_RATE, preset, B, V, 4, P, SVR_ITER)


def svr_want(calls: int, n_encode: int, ltp: bool) -> dict:
    """The launches of an SVR encode of ``calls`` analysis calls, of which
    ``n_encode`` encode groups: K7's coefficient and quantization entries,
    K11, K12, K3 and K4 once a call, K8 once (twice with -P), K5's fused
    entry once a group; K16 once a call, K18 too with -P; K17's encode
    entry once a group and its measurement entry once a measurement call;
    K7's fused entry, the generic pack and K12's first design never."""
    return {"lpc_coefs": calls, "svr_cov": calls, "svr_refine": calls,
            "lpc_quantize": calls, "lpc_analyze": 0, "fir_predict": calls,
            "rice_search": calls, "autocorr": calls * (2 if ltp else 1),
            "ltp_analyze": calls if ltp else 0,
            "preemphasis": calls, "ltp_predict": calls if ltp else 0,
            "select_blocks": n_encode, "measure_blocks": calls - n_encode,
            "pack_residual_sections": n_encode, "bitpack": 0,
            "svr_refine_v1": 0}


def new_k7_coefs_tally() -> dict:
    return {"calls": 0, "rows": 0, "flagged": 0, "bit_equal_rows": 0,
            "max_abs_err": 0.0, "err_over_allowance": 0.0,
            "kappa_rel_err": 0.0, "kappa_over_allowance": 0.0}


def k7_coefs_check(torch, what: str, got, want, M: int, tally: dict) -> None:
    """K7's coefficient entry (``lpc_coefs``) against its plain version on
    the same lags. The two sum gamma in different orders (levinson.py, the
    margins' comment), each the exact gamma of lags moved by less than
    2^-45, so to first order they differ as lags moved by d = 2^-44 would
    make them differ:
    - the flags are equal, and so are the orders on the rows neither flags;
    - each coefficient lies within 2 kappa' 2^-45 max|c| of the other's
      (the quantization margin's normwise reading); the check allows rho
      max|c|, rho = 4 kappa' 2^-42 (svr.py's premise (a)), 16 times that;
    - kappa' = kappa A^2 moves with min |ev| (kappa' d relative) and with
      A^2 (each recursion vector within kappa' d max|a| a coefficient, so
      A within M kappa' d A): (2M + 1) kappa' d relative in all; the check
      allows four times that, (2M + 1) kappa' 2^-42.
    got, want: (orders, coefs, kappa', flags). Adds to ``tally``."""
    go, gc, gk, gr = got
    wo, wc, wk, wr = want
    require(torch.equal(gr, wr), f"K7's coefficient entry flags other rows "
                                 f"than its plain version ({what})")
    ok = ~wr
    require(torch.equal(go[ok], wo[ok]), f"K7's coefficient entry changes "
                                         f"an unflagged order ({what})")
    allow = 4.0 * 2.0 ** -42 * wk * wc.abs().max(dim=1).values
    err = (gc - wc).abs().max(dim=1).values
    require(bool((err[ok] <= allow[ok]).all()),
            f"K7's coefficients are more than 4 kappa' 2^-42 max|c| from "
            f"its plain version's on an unflagged row ({what})")
    krel = (gk - wk).abs() / wk
    kallow = (2 * M + 1) * wk * 2.0 ** -42
    require(bool((krel[ok] <= kallow[ok]).all()),
            f"K7's kappa' is more than (2M + 1) kappa' 2^-42 from its plain "
            f"version's on an unflagged row ({what})")
    tally["calls"] += 1
    tally["rows"] += int(wr.numel())
    tally["flagged"] += int(wr.sum())
    tally["bit_equal_rows"] += int((torch.eq(gc, wc).all(dim=1) & ok).sum())
    if bool(ok.any()):
        tally["max_abs_err"] = max(tally["max_abs_err"], float(err[ok].max()))
        tally["err_over_allowance"] = max(tally["err_over_allowance"], float(
            (err[ok] / torch.where(allow[ok] > 0, allow[ok], 1.0)).max()))
        tally["kappa_rel_err"] = max(tally["kappa_rel_err"],
                                     float(krel[ok].max()))
        tally["kappa_over_allowance"] = max(tally["kappa_over_allowance"],
                                            float((krel[ok] / kallow[ok]).max()))


def svr_inputs(torch, enc, file, lshift: int, offs, n: int, what: str,
               k7: dict):
    """What one analysis call of the SVR encode hands K11 and K12 (no -P):
    the pre-emphasised rows of the blocks at ``offs`` and K7's orders,
    coefficients and kappa' on their K8 lags, K7's coefficient entry held
    to its plain version on those lags (``k7_coefs_check``, into ``k7``)."""
    from srla_tpu_torch.constants import LPC_RIDGE_REGULARIZATION_PARAMETER
    from srla_tpu_torch.kernels import exact
    from srla_tpu_torch.kernels.autocorr import autocorr
    from srla_tpu_torch.kernels.levinson import lpc_coefs, lpc_coefs_plain
    a = enc._host._device_args(n)
    rows = exact.variant_stack(exact.cut_spans(file, offs, n), lshift)
    work, _, _ = exact.preemphasis_exact(rows)
    ac = autocorr(work, n, a["bps"], a["max_params"] + 1, a["fft_size"])
    ac[:, 0] = ac[:, 0] * (1.0 + LPC_RIDGE_REGULARIZATION_PARAMETER)
    kw = (n, a["bps"], a["max_params"], a["max_fixed"])
    got = lpc_coefs(ac, *kw)
    k7_coefs_check(torch, what, got, lpc_coefs_plain(ac, *kw),
                   a["max_params"], k7)
    orders, coefs, kappa, _ = got
    return work, orders, coefs, kappa, a


def svr_check(torch, what: str, work, orders, coefs, kappa, a) -> tuple:
    """K11, K12 and K7's quantization entry against their plain versions
    on one call's inputs: bit-equal, flags too. Returns (K11's output,
    K12's outputs, the plain versions' wall ms: K11's, K12's)."""
    from srla_tpu_torch.constants import LPC_RIDGE_REGULARIZATION_PARAMETER
    from srla_tpu_torch.kernels.levinson import (lpc_quantize,
                                                 lpc_quantize_plain)
    from srla_tpu_torch.kernels.svr import (svr_cov, svr_cov_plain,
                                            svr_refine, svr_refine_plain)
    ridge = LPC_RIDGE_REGULARIZATION_PARAMETER
    n, bps, M = a["n"], a["bps"], a["max_params"]
    cov = svr_cov(work, orders, n, bps, M, ridge)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = svr_cov_plain(work, orders, n, bps, M, ridge)
    torch.cuda.synchronize()
    plain11 = (time.perf_counter() - t0) * 1e3
    require(torch.equal(cov, want), f"K11 differs from its plain version "
                                    f"({what})")
    kw = (n, bps, a["svr_iter"], a["margins"], ridge, kappa)
    got = svr_refine(work, cov, coefs, orders, *kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = svr_refine_plain(work, cov, coefs, orders, *kw)
    torch.cuda.synchronize()
    plain12 = (time.perf_counter() - t0) * 1e3
    for name, g, w in zip(("coefficients", "cerr", "flags", "iterations"),
                          got, want):
        require(torch.equal(g, w), f"K12 differs from its plain version in "
                                   f"its {name} ({what})")
    q = lpc_quantize(got[0], orders, kappa, got[1])
    qp = lpc_quantize_plain(got[0], orders, kappa, got[1])
    torch.cuda.synchronize()
    require(all(torch.equal(g, w) for g, w in zip(q, qp)),
            f"K7's quantization entry differs from its plain version "
            f"({what})")
    return cov, got, (plain11, plain12)


def k12_first_design(torch, work, cov, coefs, orders, kappa, a):
    """fn() -> (best, cerr, risky, iters) of K12's first design (csrc/
    svr_refine_v1.cu, a measurement aid nothing in the port calls) on
    svr_refine's arguments; its shared-memory layout is the one it was
    written for (the row as int32, the residual and six vectors of M, the
    factor whole: each to global scratch, the factor first, where it does
    not fit)."""
    import ctypes
    import math

    from srla_tpu_torch.constants import LPC_RIDGE_REGULARIZATION_PARAMETER
    from srla_tpu_torch.kernels import build, svr
    fn = build.load("svr_refine_v1").srla_svr_refine_v1
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 \
        + [ctypes.c_double] * 10 + [ctypes.c_void_p]
    ridge = LPC_RIDGE_REGULARIZATION_PARAMETER
    n, bps, M = a["n"], a["bps"], a["max_params"]
    V, dev = work.shape[0], work.device
    base = 4 * n + 48 * M
    a_global = base + 8 * n + 8 * M * M > svr._SMEM_BYTES
    r_global = base + 8 * n > svr._SMEM_BYTES
    a_scratch = torch.empty_like(cov) if a_global else None
    r_scratch = (torch.empty((V, n), dtype=torch.float64, device=dev)
                 if r_global else None)
    marg = torch.tensor(a["margins"], dtype=torch.float64, device=dev)
    outs = (torch.empty((V, M), dtype=torch.float64, device=dev),
            torch.empty(V, dtype=torch.float64, device=dev),
            torch.empty(V, dtype=torch.bool, device=dev),
            torch.empty(V, dtype=torch.int32, device=dev))

    def run():
        err = fn(work.data_ptr(), cov.data_ptr(), coefs.data_ptr(),
                 orders.data_ptr(), kappa.data_ptr(), marg.data_ptr(),
                 None if a_scratch is None else a_scratch.data_ptr(),
                 None if r_scratch is None else r_scratch.data_ptr(),
                 *(t.data_ptr() for t in outs), V, n, M, a["svr_iter"],
                 len(a["margins"]), 2.0 ** -(bps - 1), ridge / (1.0 + ridge),
                 svr.LOG_OPTX, svr._gamma(n), math.sqrt(n),
                 svr._EPS_SVR_LIBM, svr._EPS_SVR_PIVOT, svr._SVR_INIT_REL,
                 svr.SVR_OBJ_EPSILON, svr.SVR_FLT_MAX,
                 torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"K12's first design failed to launch ({err})")
        k12_first_design.launches += 1
        return outs
    return run


k12_first_design.launches = 0


def svr_encode_case(torch, np, dev, case, card) -> dict:
    """One byte-identity case of phase 12: the host exact stream (timed),
    the card's counted encode, block and span accounting, the launches,
    the lossless decode on the card. Returns the path's launches."""
    from srla_tpu_torch import SRLAEncoder, decode
    from srla_tpu_torch.host_encoder import encode as host_encode
    from srla_tpu_torch.signals import make_music
    path, secs, preset, B, V, P = case
    pcm = make_music(secs)
    param = svr_param(preset, B, V, P)
    t0 = time.perf_counter()
    stream = host_encode(pcm, 16, SAMPLE_RATE, preset=preset, max_block=B,
                         variable_divisions=V, ltp_order=P,
                         svr_iterations=SVR_ITER)
    host_s = time.perf_counter() - t0
    spans = span_groups(pcm, param) if V else {}
    blocks = encode_groups(pcm, param, stream)
    n_measure, n_encode = expected_calls(spans, blocks)
    enc = SRLAEncoder(param, dev)
    t0 = time.perf_counter()
    data, got, k4 = held_encode(torch, all_wrappers(),
                                lambda: enc.encode_whole(pcm))
    card_s = time.perf_counter() - t0
    require(data == stream, f"{path}: the encode differs from the host "
                            f"exact stream")
    st = enc.stats
    nspans = sum(len(o) for o in spans.values())
    require(st["device_spans"] + st["remeasured_spans"] == nspans
            and st["host_spans"] == 0,
            f"{path}: span accounting {st}: {nspans} spans measured by "
            f"analysis, none on the host")
    ncomp = compress_blocks(stream)
    handled = (st["device_blocks"] + st["repaired_blocks"]
               + st["w_overflow_blocks"])
    require(handled == ncomp, f"{path}: block accounting {st}: {handled} "
                              f"of {ncomp} COMPRESS blocks")
    for name, count in svr_want(n_measure + n_encode, n_encode,
                                P > 0).items():
        require(got[name] == count, f"{path}: {name} launched {got[name]} "
                                    f"times, expected {count}")
    (_, out), dec_got = counted(torch, all_wrappers(),
                                lambda: decode(data, device=dev))
    require(np.array_equal(out, pcm), f"{path}: decode is not lossless")
    print(f"phase 12 encode {secs:g} s stereo -m {preset} -B {B} -V {V}"
          f"{f' -P {P}' if P else ''} --svr {SVR_ITER} on the card: "
          f"byte-identical to the host exact stream (host {host_s:.2f} s, "
          f"card {card_s:.2f} s cold), {st['device_blocks']} device / "
          f"{st['repaired_blocks']} repaired / {st['w_overflow_blocks']} "
          f"overflow of {ncomp} COMPRESS blocks, {st['device_spans']} device "
          f"/ {st['remeasured_spans']} re-measured of {nspans} spans; "
          f"{n_measure} measurement calls + {n_encode} encode groups; "
          f"launches {got}; {held_text(k4)}; decode on the card lossless "
          f"[{card}]")
    return {"encode": got, "decode": dec_got, "host_s": host_s}


def phase_svr(torch, np, dev, music, card):
    """Phase 12, SVR refinement on the card (K11 svr_cov.cu, K12
    svr_refine.cu, K7's coefficient and quantization entries). Returns
    (each path's launches, the records of K11, K12, K12's first design and
    K7's two SVR entries, the tallies of K7's coefficient entry against its
    plain version)."""
    from srla_tpu_torch import SRLAEncoder, decode
    from srla_tpu_torch.encoder import StepTimer
    from srla_tpu_torch.host_encoder import _compute_offset_lshift
    from srla_tpu_torch.kernels.svr import svr_cov_plain, svr_refine_plain

    launches: dict = {}
    for case in SVR_CASES:
        launches[case[0]] = svr_encode_case(torch, np, dev, case, card)
    # K11 and K12 against plain on the M 255 path's tail group (its rows
    # keep the factor in the global scratch).
    path, secs, preset, B, V, P = SVR_CASES[-1]
    from srla_tpu_torch.signals import make_music
    pcm = make_music(secs)
    enc = SRLAEncoder(svr_param(preset, B, V, P), dev)
    file = enc._upload(pcm)[enc.device]
    tail = pcm.shape[1] - (pcm.shape[1] // B) * B
    t0 = time.perf_counter()
    k7 = new_k7_coefs_tally()
    inp = svr_inputs(torch, enc, file, _compute_offset_lshift(pcm),
                     [pcm.shape[1] - tail], tail, f"{path} tail group", k7)
    svr_check(torch, f"{path} tail group", *inp)
    print(f"phase 12 K11 and K12 at M 255 ({path}'s tail group, "
          f"{inp[0].shape[0]} rows x {tail}, orders up to "
          f"{int(inp[1].max())}): bit-equal to their plain versions, flags "
          f"and K7's quantization entry too; K7's coefficient entry: "
          f"{k7_coefs_text(k7)} ({time.perf_counter() - t0:.1f} s) [{card}]")
    print(f"phase 12 K7's quantization entry: "
          f"{k7_quantize_cases(torch, np, dev)} [{card}]")

    # Full width: phase 3's 120 s at -m 4 -B 4096 -V 0 --svr 2.
    param = svr_param(4, 4096, 0, 0)
    enc = SRLAEncoder(param, dev)
    data, got, k4 = held_encode(torch, all_wrappers(),
                                lambda: enc.encode_whole(music))
    st = dict(enc.stats)
    ncomp = st["device_blocks"] + st["repaired_blocks"] \
        + st["w_overflow_blocks"]
    require(ncomp == compress_blocks(data), f"full width: block accounting "
                                            f"{st}")
    (_, out), dec_got = counted(torch, all_wrappers(),
                                lambda: decode(data, device=dev))
    require(np.array_equal(out, music), "full width: decode is not "
                                        "lossless")
    launches["music120_m4_svr2"] = {"encode": got, "decode": dec_got}
    groups = encode_groups(music, param, data)
    n_measure, n_encode = expected_calls({}, groups)
    for name, count in svr_want(n_measure + n_encode, n_encode,
                                False).items():
        require(got[name] == count, f"full width: {name} launched "
                                    f"{got[name]} times, expected {count}")
    rate = st["repaired_blocks"] / max(ncomp, 1)
    best = best_of(torch, lambda: SRLAEncoder(param, dev).encode_whole(
        music))
    enc = SRLAEncoder(param, dev)
    enc.timer = StepTimer(dev)
    enc.encode_whole(music)
    steps = enc.timer.seconds
    print(f"phase 12 encode {MAIN_SECONDS:.0f} s stereo -m 4 -B 4096 -V 0 "
          f"--svr {SVR_ITER} on the card: {st['device_blocks']} device / "
          f"{st['repaired_blocks']} repaired / {st['w_overflow_blocks']} "
          f"overflow of {ncomp} COMPRESS blocks (repair rate "
          f"{100 * rate:.2f} %{', ABOVE 5 %' if rate > SVR_REPAIR_WARN else ''}"
          f"), launches {got}, {held_text(k4)}, decode on the card "
          f"lossless; warm best of 3 "
          f"{best * 1e3:.1f} ms = {MAIN_SECONDS / best:.1f}x realtime "
          f"[{card}]")
    if rate > SVR_REPAIR_WARN:
        print(f"phase 12 WARNING: {100 * rate:.2f} % of the blocks were "
              f"repaired on the host", file=sys.stderr)
    print("phase 12 encode breakdown (host clock, synchronised per step, "
          "ms): " + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in steps.items())
          + f"; total {sum(steps.values()) * 1e3:.2f}")

    # K11 and K12 against plain on every row of both analysis calls.
    lshift = _compute_offset_lshift(music)
    file = enc._upload(music)[enc.device]
    main_inp = None
    rows = 0
    k7_full = new_k7_coefs_tally()
    for n, offs in sorted(groups.items(), key=lambda g: -len(g[1])):
        what = f"full width, {len(offs)} of {n}"
        inp = svr_inputs(torch, enc, file, lshift, offs, n, what, k7_full)
        cov, out12, plain = svr_check(torch, what, *inp)
        rows += inp[0].shape[0]
        if main_inp is None:
            main_inp, main_cov, main_out, main_plain = inp, cov, out12, plain
    work, orders, coefs, kappa, a = main_inp
    flagged = int(main_out[2].sum())
    print(f"phase 12 K11 and K12 on both analysis calls of the full-width "
          f"encode ({rows} rows): bit-equal to their plain versions, flags "
          f"and iterations too; main call: {flagged} of {work.shape[0]} rows "
          f"flagged by K12, iterations a row "
          f"{int(main_out[3].min())}..{int(main_out[3].max())}; K7's "
          f"coefficient entry: {k7_coefs_text(k7_full)} [{card}]")
    k7_tallies = {"m255_tail": k7, "full_width": k7_full}
    return launches, svr_records(torch, dev, main_inp, main_cov, main_out,
                                 main_plain, card), k7_tallies


def k7_quantize_check(torch, what: str, args) -> int:
    """K7's quantization entry against its plain version on args (coefs,
    orders, kappa, cerr) on the card: equal on every output, the flags
    too. Returns the rows the plain version flags."""
    from srla_tpu_torch.kernels.levinson import (lpc_quantize,
                                                 lpc_quantize_plain)
    got = lpc_quantize(*args)
    want = lpc_quantize_plain(*args)
    torch.cuda.synchronize()
    for name, g, w in zip(("shifts", "values", "flags"), got, want):
        require(torch.equal(g, w), f"K7's quantization entry differs from "
                                   f"its plain version in its {name} "
                                   f"({what})")
    return int(want[2].sum())


def k7_quantize_cases(torch, np, dev) -> str:
    """K7's quantization entry on the rows of k7_quantize_case (the
    coefficients K7's coefficient entry gives on their lags) with cerr 0
    and widened (K7Q_WIDENINGS relative to each row's largest |c|), and on
    k7_quantize_batch at M 32, 64, 128 and 255: equal to its plain version
    on every output. Returns what it checked."""
    from srla_tpu_torch.kernels.levinson import lpc_coefs
    _, lags, n, bps, M, fixed, _, _ = k7_quantize_case(np)
    orders, coefs, kappa, _ = lpc_coefs(torch.from_numpy(lags).to(dev), n,
                                        bps, M, fixed)
    top = coefs.abs().max(dim=1).values
    flagged = [k7_quantize_check(torch, f"boundary rows, cerr {w:g} max|c|",
                                 (coefs, orders, kappa, top * w))
               for w in K7Q_WIDENINGS]
    text = (f"{lags.shape[0]} boundary rows (k7_quantize_case) with cerr "
            f"{', '.join(f'{w:g}' for w in K7Q_WIDENINGS)} x max|c|: equal "
            f"to plain on every output, {flagged} flagged")
    for M in (32, 64, 128, 255):
        batch = k7_quantize_batch(np, K7Q_BATCH_ROWS, M, M)
        args = tuple(torch.from_numpy(a).to(dev) for a in batch)
        f = k7_quantize_check(torch, f"random batch at M {M}", args)
        text += f"; {K7Q_BATCH_ROWS} random rows at M {M}: equal, {f} flagged"
    return text


def k7_coefs_text(t: dict) -> str:
    return (f"{t['rows']} rows of {t['calls']} calls, {t['flagged']} flagged "
            f"alike by both, orders equal where unflagged, "
            f"{t['bit_equal_rows']} unflagged rows bit-equal to plain, the "
            f"largest coefficient difference {t['max_abs_err']:.3g} "
            f"({t['err_over_allowance']:.3g} of its allowance 4 kappa' 2^-42 "
            f"max|c|), kappa' within {t['kappa_rel_err']:.3g} relative "
            f"({t['kappa_over_allowance']:.3g} of (2M + 1) kappa' 2^-42)")


def svr_records(torch, dev, inp, cov, out12, plain, card):
    """Times of K11, K12 and K7's two SVR entries on the main call's inputs
    (5164 rows x 4096), each beside its plain version, its bound, its
    library yardstick and its serial floor, K12 also beside its first
    design (csrc/svr_refine_v1.cu) in turns; their records for the kernels
    line, the first design's among them."""
    import statistics

    from srla_tpu_torch.constants import LPC_RIDGE_REGULARIZATION_PARAMETER
    from srla_tpu_torch.kernels.autocorr import autocorr
    from srla_tpu_torch.kernels.levinson import (lpc_coefs, lpc_coefs_plain,
                                                 lpc_quantize,
                                                 lpc_quantize_plain)
    from srla_tpu_torch.kernels.svr import svr_cov, svr_refine
    ridge = LPC_RIDGE_REGULARIZATION_PARAMETER
    work, orders, coefs, kappa, a = inp
    V = work.shape[0]
    n, bps, M, it_max = a["n"], a["bps"], a["max_params"], a["svr_iter"]
    K = len(a["margins"])
    o = orders.long()
    of = o.to(torch.float64)

    def k11():
        return svr_cov(work, orders, n, bps, M, ridge)

    kw = (n, bps, it_max, a["margins"], ridge, kappa)

    def k12():
        return svr_refine(work, cov, coefs, orders, *kw)

    ms11 = cuda_ms(torch, k11, 5)
    dev11 = device_ms(torch, k11, 3)
    ms12 = cuda_ms(torch, k12, 5)
    # K12 and its first design in turns (old, new, new, old), device time;
    # the first design's outputs equal K12's.
    v1 = k12_first_design(torch, work, cov, coefs, orders, kappa, a)
    require(all(torch.equal(g, w) for g, w in zip(v1(), out12)),
            "K12's first design and K12 differ on the main call")
    ms12_v1 = cuda_ms(torch, v1, 3)
    (v1_a, v1_b), (dev_a, dev_b) = in_turns(torch, v1, k12, 3)
    dev12, dev12_v1 = min(dev_a, dev_b), min(v1_a, v1_b)
    plain11, plain12 = plain           # svr_check's runs of the same call
    # K11's work: each element of the o x o triangle a chain of n - o
    # products and adds; bytes: the rows in, the matrices out.
    ops11 = float((of * (of + 1) / 2 * (n - of) * 2).sum())
    b11 = bound(nbytes(work, orders) + V * M * M * 8, ops11,
                F64_INSTR_PER_S)
    # K12's work for the iterations this data ran, as the host's order
    # needs it (f64 instructions, a multiply and an add apiece): the
    # initial vector's residual once (2 o (n - o)), every later
    # iteration's residual, the mean-abs chain of every iteration (n - o;
    # the first once), and on every iteration but the last the r-vector
    # chains and the |th| sum (2 o (n - o) + (n - o)) and the two solves
    # (2 o^2); once the factor and max_j (C^-1)_jj (~o^3 / 3 each: o^3 / 6
    # multiplies and as many adds). A row's iterations are its margins'
    # (iters); at max_iter 2 every margin's first iteration is the one that
    # is not last, so the rows' non-last iterations are min(iters, K).
    it = out12[3].to(torch.float64)
    live = it > 0
    first = torch.clamp(it, max=float(K)) if it_max > 1 \
        else torch.zeros_like(it)
    later = torch.where(live, it - K, 0.0)          # margins' it >= 1
    scored = torch.where(live, 1.0 + later, 0.0)    # residuals, mean-abs
    ops12 = float((scored * (2 * of * (n - of) + (n - of))
                   + first * (2 * of * (n - of) + (n - of) + 2 * of * of)
                   + torch.where(live, 2 * of ** 3 / 3, 0.0)).sum())
    bytes12 = nbytes(work, cov, coefs, orders, kappa) \
        + V * (M * 8 + 8 + 8 + 1 + 4)
    b12 = bound(bytes12, ops12, F64_INSTR_PER_S)
    # Library yardsticks, timed and never on the path: the Gram matrix of
    # each row's lag windows by batched DGEMM (the f64 tensor cores), in
    # chunks of rows; and torch.linalg.cholesky_ex and cholesky_solve for
    # K12's factor and a solve per iteration run, five runs.
    d = work.to(torch.float64) * 2.0 ** -(bps - 1)
    chunk = 256

    def gram():
        for lo in range(0, V, chunk):
            x = d[lo:lo + chunk].unfold(1, M, 1)       # (c, n - M + 1, M)
            torch.bmm(x.transpose(1, 2), x)

    lib11 = cuda_ms(torch, gram, 2)
    eye = torch.eye(M, dtype=torch.float64, device=dev)
    act = torch.arange(M, device=dev)[None, :] < o[:, None]
    spd = cov + eye * (~act)[:, :, None]
    rhs = torch.ones((V, M, 1), dtype=torch.float64, device=dev)
    solves = max(1, round(float(it.mean())))

    def chol():
        L, _ = torch.linalg.cholesky_ex(spd)
        for _ in range(solves):
            torch.cholesky_solve(rhs, L)

    chol()
    lib12_runs = [cuda_ms(torch, chol, 1) for _ in range(5)]
    lib12 = statistics.median(lib12_runs)
    step = chain_step_ms(torch, 6)
    floor11 = float((n - of).max()) * step
    # What the host's order forces on one margin: each iteration's chains
    # (n adds), and a solve (M^2 steps) between two; the margins run at
    # once.
    floor12 = (it_max * n + (it_max - 1) * M * M) * step
    # K7's SVR entries on the same call: its coefficient entry on the
    # call's ridged lags, its quantization entry on K12's output.
    ac = autocorr(work, n, bps, M + 1, a["fft_size"])
    ac[:, 0] = ac[:, 0] * (1.0 + ridge)
    fixed = a["max_fixed"]

    def k7c():
        return lpc_coefs(ac, n, bps, M, fixed)

    def k7q():
        return lpc_quantize(out12[0], orders, kappa, out12[1])

    ms7c, dev7c = cuda_ms(torch, k7c, 20), device_ms(torch, k7c, 20)
    ms7q, dev7q = cuda_ms(torch, k7q, 20), device_ms(torch, k7q, 20)
    # The quantization's floor: its longest row's chain, steps of
    # chain_probe.cu kind 7.
    floor7q = int(o.max()) * chain_step_ms(torch, 7)
    plain7c = cuda_ms(torch, lambda: lpc_coefs_plain(ac, n, bps, M, fixed),
                      1)
    plain7q = cuda_ms(torch, lambda: lpc_quantize_plain(
        out12[0], orders, kappa, out12[1]), 1)
    # K7's operations, as phase 10 counts them: the first recursion and
    # the order choice for the coefficient entry (its second recursion at
    # the chosen order is no more than the first), ~8 an order for the
    # quantization.
    mm = torch.arange(2, M + 1, dtype=torch.float64)
    ops7c = V * (2 * float((4 * mm + 7).sum()) + 30 * M)
    ops7q = float((8 * o).sum())
    b7c = bound(nbytes(ac) + V * (4 + 8 * M + 8 + 1), ops7c, F64_OPS_PER_S)
    b7q = bound(V * (8 * M + 4 + 8 + 8) + V * (4 + 4 * M + 1), ops7q,
                F64_OPS_PER_S)
    print(f"phase 12 K11 svr_cov at V={V} n={n} M={M} (orders up to "
          f"{int(o.max())}): kernel {ms11:.4f} ms, device time {dev11:.4f} "
          f"ms, plain {plain11:.1f} ms, bound {b11['bound_ms']:.4f} ms "
          f"({b11['bound_by']}: {ops11 / 1e9:.1f} G f64 instructions), "
          f"DGEMM Gram (unfold + bmm, {chunk}-row chunks) {lib11:.4f} ms, "
          f"serial floor {floor11:.4f} ms ({int((n - of).max())} adds of "
          f"{step * 1e6:.2f} ns) [{card}]")
    print(f"phase 12 K12 svr_refine at V={V} n={n} M={M}, {it_max} "
          f"iterations, {K} margins, {float(it.mean()):.2f} margin-"
          f"iterations a row (orders {float(of.mean()):.1f} on average): "
          f"kernel {ms12:.4f} ms, device time {dev12:.4f} ms; first design "
          f"(csrc/svr_refine_v1.cu, equal outputs) kernel {ms12_v1:.4f} ms, "
          f"in turns old, new, new, old {[v1_a, dev_a, dev_b, v1_b]} ms; "
          f"plain {plain12:.1f} ms; bound {b12['bound_ms']:.4f} ms "
          f"({b12['bound_by']}: {ops12 / 1e9:.2f} G f64 instructions); "
          f"cholesky_ex + {solves} "
          f"cholesky_solve median of 5 {lib12:.4f} ms (runs "
          f"{[round(x, 4) for x in lib12_runs]}); serial floor "
          f"{floor12:.4f} ms ({it_max} x n + {it_max - 1} x M^2 adds) "
          f"[{card}]")
    print(f"phase 12 K7's SVR entries at V={V} M={M}: srla_lpc_coefs kernel "
          f"{ms7c:.4f} ms, device time {dev7c:.4f} ms, plain {plain7c:.2f} "
          f"ms, bound {b7c['bound_ms']:.4f} ms ({b7c['bound_by']}); "
          f"srla_lpc_quantize kernel {ms7q:.4f} ms, device time "
          f"{dev7q:.4f} ms, plain {plain7q:.2f} ms, bound "
          f"{b7q['bound_ms']:.4f} ms ({b7q['bound_by']}), serial floor "
          f"{floor7q:.4f} ms ({int(o.max())} steps of chain_probe.cu kind "
          f"7); {parent_text('lpc_quantize')} [{card}]")
    common = dict(route="cuda", max_abs_err=0)
    k12_src = "srla_tpu_torch/kernels/csrc/svr_refine"
    k7_src = "srla_tpu_torch/kernels/csrc/lpc_analyze.cu"
    return [dict(name="svr_cov",
                 source="srla_tpu_torch/kernels/csrc/svr_cov.cu",
                 replaces="srla_tpu/kernels/exact.py:589", ms=ms11,
                 plain_ms=plain11, **b11, library_ms=lib11,
                 device_ms=dev11, serial_floor_ms=floor11, **common),
            dict(name="svr_refine", source=f"{k12_src}.cu",
                 replaces="srla_tpu/kernels/exact.py:775", ms=ms12,
                 plain_ms=plain12, **b12, library_ms=lib12,
                 library_runs_ms=lib12_runs, device_ms=dev12,
                 serial_floor_ms=floor12, v1_device_ms=dev12_v1, **common),
            dict(name="svr_refine_v1", source=f"{k12_src}_v1.cu",
                 replaces="srla_tpu/kernels/exact.py:775", ms=ms12_v1,
                 plain_ms=plain12, **b12, library_ms=lib12,
                 device_ms=dev12_v1, serial_floor_ms=floor12,
                 measurement_aid=True, **common),
            dict(name="lpc_coefs", source=k7_src,
                 replaces="srla_tpu/kernels/exact.py:150", ms=ms7c,
                 plain_ms=plain7c, **b7c, library_ms=None, device_ms=dev7c,
                 **common),
            dict(name="lpc_quantize", source=k7_src,
                 replaces="srla_tpu/kernels/exact.py:330", ms=ms7q,
                 plain_ms=plain7q, **b7q, library_ms=None, device_ms=dev7q,
                 serial_floor_ms=floor7q,
                 parent_in_turns=parent_runs("lpc_quantize"), **common)]


HIRES_SECONDS = (60.0, 45.0, 30.0, 20.0, 10.0, 5.0, 1.0)
HIRES_TAIL = 3001                # the last hi-res file: one odd block
HIRES_RATE = 96000
SHORT_FILES = 64


def hires_corpus(np) -> list:
    """BASELINE.json's fifth config at the repo's own signal: 24-bit 96 kHz
    stereo files of make_music << 8, one a length and seed."""
    from srla_tpu_torch.signals import make_music
    files = [make_music(sec, HIRES_RATE, 100 + k) << 8
             for k, sec in enumerate(HIRES_SECONDS)]
    tail = make_music(1.0, HIRES_RATE, 199)[:, :HIRES_TAIL] << 8
    return files + [np.ascontiguousarray(tail)]


def short_corpus(np) -> list:
    """SHORT_FILES 16-bit 44.1 kHz files of 1-8 s (lengths drawn from a
    seed), make_music and make_segmented in turns, distinct seeds: 8 mono,
    4 with every sample's lowest bit clear (offset_lshift 1)."""
    from srla_tpu_torch.signals import make_music, make_segmented
    rng = np.random.RandomState(13)
    files = []
    for k in range(SHORT_FILES):
        n = int(rng.randint(SAMPLE_RATE, 8 * SAMPLE_RATE + 1))
        make = make_music if k % 2 == 0 else make_segmented
        x = make(n / SAMPLE_RATE + 0.01, SAMPLE_RATE, 200 + k)[:, :n]
        if k % 8 == 1:
            x = x[:1]
        elif k % 16 == 2:
            x = (x >> 1) << 1
        files.append(np.ascontiguousarray(x))
    return files


def corpus_calls(files, max_block: int, limit: int) -> dict:
    """The device calls of encode_files at -V 0 over files, derived from
    the file list: a call per block length of each (channels,
    offset_lshift) group (MAX_CALL_BLOCKS blocks at most), even-length
    COMPRESS-typed blocks only (odd ones are encoded on the host);
    "batched" one launch a call, "split" a launch a shard of two,
    "per_file" the calls of each file's own encode."""
    from srla_tpu_torch import SRLAEncoder
    from srla_tpu_torch.host_encoder import _compute_offset_lshift

    def sizes(x) -> dict:
        out: dict = {}
        for o in range(0, x.shape[1], max_block):
            n = min(max_block, x.shape[1] - o)
            if n > limit and n % 2 == 0 and x[:, o:o + n].any():
                out[n] = out.get(n, 0) + 1
        return out

    def calls(counts: dict) -> list:
        per = SRLAEncoder.MAX_CALL_BLOCKS
        return [min(per, c - lo) for c in counts.values()
                for lo in range(0, c, per)]

    groups: dict = {}
    for x in files:
        merged = groups.setdefault((x.shape[0], _compute_offset_lshift(x)),
                                   {})
        for n, c in sizes(x).items():
            merged[n] = merged.get(n, 0) + c
    batched = [b for merged in groups.values() for b in calls(merged)]
    return dict(batched=len(batched),
                split=sum(min(2, b) for b in batched),
                per_file=sum(len(calls(sizes(x))) for x in files))


def fused_tail_groups(streams) -> int:
    """K19's launches on the fused decode of ``streams``: the fused groups
    (``fused_groups``) of the header-compatible sets that are stereo or
    shifted."""
    from srla_tpu_torch.format import decode_header
    sets: dict = {}
    for st in streams:
        h = decode_header(st)
        key = (h.num_channels, h.bits_per_sample, h.offset_lshift,
               h.max_num_samples_per_block, h.preset, h.sampling_rate)
        sets.setdefault(key, []).append(st)
    return sum(fused_groups(group)[0] for key, group in sets.items()
               if key[0] >= 2 or key[2] != 0)


def tail_groups(stream: bytes, groups: int) -> int:
    """K19's launches on a decode of ``groups`` groups of ``stream``: one a
    group, none where the stream is mono at offset shift 0 (nothing to
    change)."""
    from srla_tpu_torch.format import decode_header
    h = decode_header(stream)
    return groups if h.num_channels >= 2 or h.offset_lshift != 0 else 0


DECODE_SHOWN = ("rice_decode", "lpc_synth_coefs", "ltp_synth", "synth_tail")


def decode_launches_ok(got: dict, groups: int, ltp_groups: int,
                       tail: int, what: str) -> None:
    """A decode's K1, K9 and K19 launches: K1's coefficient entry once a
    group and once more an LTP group (the de-emphasis), its aligned entry
    never, K9 once an LTP group, K19 ``tail`` times."""
    want = {"lpc_synth_coefs": groups + ltp_groups, "lpc_synth": 0,
            "ltp_synth": ltp_groups, "synth_tail": tail}
    for name, count in want.items():
        require(got[name] == count, f"{what}: {name} launched {got[name]} "
                                    f"times, expected {count}")


def fused_groups(streams) -> tuple[int, int]:
    """(groups, groups of two or more blocks) of the fused decode: one
    group per COMPRESS block length of each header-compatible set of
    streams."""
    from srla_tpu_torch.constants import BlockDataType
    from srla_tpu_torch.format import decode_header
    sets: dict = {}
    for s in streams:
        h = decode_header(s)
        key = (h.num_channels, h.bits_per_sample, h.offset_lshift,
               h.max_num_samples_per_block, h.preset, h.sampling_rate)
        sizes = sets.setdefault(key, {})
        for t, n in stream_blocks(s):
            if t == BlockDataType.COMPRESS:
                sizes[n] = sizes.get(n, 0) + 1
    counts = [c for sizes in sets.values() for c in sizes.values()]
    return len(counts), sum(c > 1 for c in counts)


ENCODE_KERNELS = ("autocorr", "lpc_analyze", "fir_predict", "rice_search",
                  "pack_residual_sections", "preemphasis", "select_blocks")


def sync_sites(torch, fn) -> dict:
    """The host synchronisations fn() makes with the card, as {"file:line":
    count} (torch.cuda.set_sync_debug_mode), the repo's own lines."""
    import collections
    import warnings
    sites: collections.Counter = collections.Counter()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in seen:
        if "synchroniz" in str(w.message):
            path = w.filename.replace("\\", "/")
            cut = path.rfind("srla_tpu_torch/")
            sites[f"{path[cut:] if cut >= 0 else path}:{w.lineno}"] += 1
    return dict(sites.most_common())


def corpus_case(torch, np, dev, what: str, files, bps: int, rate: int,
                block: int, card: str, timing: bool) -> dict:
    """One corpus: encode_files on the card against host_encoder.encode per
    file, counted; the fused decode, counted; both again split over two
    shards on this card (and over every card where more than one is
    visible). Returns ({run: launches}, the streams)."""
    from srla_tpu_torch import SRLAEncoder, decode, encode_files
    from srla_tpu_torch.constants import PARAMETER_PRESETS, BlockDataType
    from srla_tpu_torch.host_encoder import encode, make_parameter
    from srla_tpu_torch.parallel import decode_corpus_sharded, make_devices

    t0 = time.perf_counter()
    want = [encode(x, bps, rate, preset=4, max_block=block) for x in files]
    t_host = time.perf_counter() - t0
    limit = PARAMETER_PRESETS[4].max_num_parameters
    plan = corpus_calls(files, block, limit)
    wrappers = all_wrappers()
    stats: dict = {}
    got, enc_l = counted(torch, wrappers, lambda: without_plain(
        lambda: encode_files(files, bps, rate, dev, preset=4,
                             max_block=block, stats_out=stats)))
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    require(not bad, f"{what}: encode_files differs from host_encoder.encode "
                     f"on files {bad[:8]}")
    for name in ENCODE_KERNELS:
        require(enc_l[name] == plan["batched"],
                f"{what}: {name} launched {enc_l[name]} times by "
                f"encode_files, expected {plan['batched']} (one a batched "
                f"call)")
    for name in ("measure_blocks", "ltp_predict"):
        require(enc_l[name] == 0, f"{what}: {name} launched {enc_l[name]} "
                                  f"times by a -V 0 encode without -P")
    require(plan["batched"] < plan["per_file"],
            f"{what}: {plan['batched']} batched calls, not fewer than the "
            f"per-file {plan['per_file']}")
    # Every even-length COMPRESS block from the device or a counted repair
    # or overflow (odd-length ones are encoded on the host).
    even = sum(1 for w in want for t, n in stream_blocks(w)
               if n % 2 == 0 and t == BlockDataType.COMPRESS)
    handled = (stats["device_blocks"] + stats["repaired_blocks"]
               + stats["w_overflow_blocks"])
    require(handled == even, f"{what}: block accounting {stats}, {even} "
                             f"even-length COMPRESS blocks")
    groups, multi = fused_groups(want)
    (pcms, dec_l) = counted(torch, wrappers, lambda: decode_corpus_sharded(
        [dev], want))
    require(all(np.array_equal(p, x) for p, x in zip(pcms, files)),
            f"{what}: the fused decode is not lossless")
    require(dec_l["rice_decode"] == groups,
            f"{what}: rice_decode launched {dec_l['rice_decode']} times by "
            f"the fused decode, expected {groups} (one a fused group)")
    decode_launches_ok(dec_l, groups, 0, fused_tail_groups(want),
                       f"{what}: the fused decode")
    runs = {"encode": enc_l, "decode": dec_l}
    splits = [("split", [dev, dev])]
    if torch.cuda.device_count() > 1:
        splits.append(("cards", make_devices()))
    for tag, devices in splits:
        st: dict = {}
        split, runs[f"encode_{tag}"] = counted(
            torch, wrappers, lambda: encode_files(
                files, bps, rate, dev, preset=4, max_block=block,
                devices=devices, stats_out=st))
        require(split == got, f"{what}: the {tag} encode differs from the "
                              f"unsplit one")
        ds: dict = {}
        back, runs[f"decode_{tag}"] = counted(
            torch, wrappers, lambda: decode_corpus_sharded(
                devices, want, stats_out=ds))
        require(all(np.array_equal(p, q) for p, q in zip(back, pcms)),
                f"{what}: the {tag} decode differs from the unsplit one")
        if tag == "split":
            require(runs["encode_split"]["fir_predict"] == plan["split"],
                    f"{what}: K3 launched "
                    f"{runs['encode_split']['fir_predict']} times split, "
                    f"expected {plan['split']}")
            require(runs["decode_split"]["rice_decode"] == groups + multi,
                    f"{what}: K2 launched "
                    f"{runs['decode_split']['rice_decode']} times split, "
                    f"expected {groups + multi}")
        print(f"phase 13 {what} over {len(devices)} shards ({tag}): "
              f"streams and PCM identical to the unsplit run; shard_rows "
              f"{st['shard_rows']} (encode) and {ds['shard_rows']} "
              f"(decode), the last group's; the largest groups' "
              f"shard_cuts: encode {sorted(st['shard_cuts'], key=sum)[-3:]}"
              f", decode {sorted(ds['shard_cuts'], key=sum)[-3:]}")
    seconds = sum(x.shape[1] for x in files) / rate
    print(f"phase 13 {what}: {len(files)} files, {seconds:.2f} s of audio; "
          f"encode_files byte-identical to host_encoder.encode on every file "
          f"(host {t_host:.2f} s), {plan['batched']} device calls batched "
          f"against {plan['per_file']} per file, launches "
          f"{ {k: enc_l[k] for k in ENCODE_KERNELS} }, stats {stats}; "
          f"the fused decode lossless, {groups} groups, launches "
          f"{ {k: dec_l[k] for k in DECODE_SHOWN} } [{card}]")
    if timing:
        params = {C: make_parameter(C, bps, rate, 4, block) for C in (1, 2)}
        t_files = best_of(torch, lambda: encode_files(
            files, bps, rate, dev, preset=4, max_block=block))
        t_loop = best_of(torch, lambda: [
            SRLAEncoder(params[x.shape[0]], dev).encode_whole(x)
            for x in files])
        t_fused = best_of(torch, lambda: decode_corpus_sharded([dev], want))
        t_dec = best_of(torch, lambda: [decode(w, device=dev) for w in want])
        print(f"phase 13 {what} warm best of 3: encode_files "
              f"{t_files * 1e3:.1f} ms ({seconds / t_files:.1f}x realtime), "
              f"a loop of encode_whole {t_loop * 1e3:.1f} ms "
              f"({seconds / t_loop:.1f}x); fused decode {t_fused * 1e3:.1f} "
              f"ms ({seconds / t_fused:.1f}x), a loop of decode "
              f"{t_dec * 1e3:.1f} ms ({seconds / t_dec:.1f}x) [{card}]")
        enc_sync = sync_sites(torch, lambda: encode_files(
            files, bps, rate, dev, preset=4, max_block=block))
        dec_sync = sync_sites(torch, lambda: decode_corpus_sharded(
            [dev], want))
        print(f"phase 13 {what} host synchronisations by line: encode_files "
              f"{enc_sync}; fused decode {dec_sync}")
    return runs, want


def ltp_blocks(np, dev, stream: bytes) -> int:
    """Blocks of a stream with LTP on in some channel, from the decode's
    packed parameters."""
    from srla_tpu_torch import SRLADecoder
    from srla_tpu_torch.constants import MAX_LTP_ORDER
    from srla_tpu_torch.kernels.decode2 import meta_cols
    header, _, groups = SRLADecoder(dev).plan(stream)
    count = 0
    for g in groups:
        o, w = meta_cols(header.num_channels, g.M, MAX_LTP_ORDER)[0][
            "ltp_periods"]
        count += int((g.meta[:, o:o + w] > 0).any(axis=1).sum())
    return count


def walk_blocks(np, dec, stream: bytes):
    """Every block of a stream through dec.decode_block, in order; the PCM
    joined and the blocks decoded."""
    from srla_tpu_torch.constants import HEADER_SIZE
    from srla_tpu_torch.format import decode_header
    header = decode_header(stream)
    off, out = HEADER_SIZE, []
    while off < len(stream) and sum(b.shape[1] for b in out) \
            < header.num_samples:
        pcm, used = dec.decode_block(stream, header, off)
        out.append(pcm)
        off += used
    return np.concatenate(out, axis=1), len(out)


def phase_block_api(torch, np, dev, pcm, stream, pcm4, stream4, hires,
                    card) -> dict:
    """encode_block against the host's one-span encode; decode_block over
    every block of phase 3's and 4's streams, the hi-res corpus's odd file
    and a -B 16384 stream; StreamingDecoder with seek and resume; the
    player once. Counted. Returns {run: launches}."""
    import os
    import tempfile

    from srla_tpu_torch import SRLADecoder, SRLAEncoder
    from srla_tpu_torch import host_encoder
    from srla_tpu_torch.streaming import StreamingDecoder
    from srla_tpu_torch.tools import srla_player

    wrappers = all_wrappers()
    runs: dict = {}
    param = main_param()
    rng = np.random.RandomState(17)
    blocks = [pcm[:, o:o + 4096]
              for o in np.linspace(0, pcm.shape[1] - 4096, 12).astype(int)]
    blocks += [np.zeros((2, 4096), np.int32), pcm[:, 7000:7020],
               pcm[:, 9000:12001],
               rng.randint(-2 ** 15, 2 ** 15, (2, 4096)).astype(np.int32)]
    host = host_encoder.SRLAEncoder(param)
    want = [host._encode_spans(b, [(0, b.shape[1])], 0)[0] for b in blocks]
    enc = SRLAEncoder(param, dev)
    got, runs["encode_block"] = counted(
        torch, wrappers, lambda: without_plain(
            lambda: [enc.encode_block(b) for b in blocks]))
    require(got == want, "encode_block on the card differs from the host's "
                         "one-span encode")
    # 12 music blocks and the noise block are analysed on the card; the
    # silent, RAW-sized and odd-length ones are not.
    for name in ("fir_predict", "preemphasis", "select_blocks"):
        require(runs["encode_block"][name] == 13,
                f"encode_block launched {name} "
                f"{runs['encode_block'][name]} times, expected 13")
    # K2, K1's coefficient entry and K19 once a COMPRESS block, K9 and K1
    # again once an LTP block.
    per_block = {}
    for src in (stream, stream4):
        ncomp, nltp = compress_blocks(src), ltp_blocks(np, dev, src)
        per_block[src] = {"rice_decode": ncomp,
                          "lpc_synth_coefs": ncomp + nltp, "lpc_synth": 0,
                          "ltp_synth": nltp,
                          "synth_tail": tail_groups(src, ncomp)}

    def block_launches(tag: str, src: bytes) -> dict:
        got_l = {k: runs[tag][k] for k in per_block[src]}
        require(got_l == per_block[src], f"{tag}: launches {got_l}, "
                                         f"expected {per_block[src]}")
        return got_l

    lines = []
    for tag, src, ref in (("decode_block_m4", stream, pcm),
                          ("decode_block_m6_P3", stream4, pcm4)):
        dec = SRLADecoder(dev)
        t0 = time.perf_counter()
        (out, nblk), runs[tag] = counted(
            torch, wrappers, lambda: walk_blocks(np, dec, src))
        dt = time.perf_counter() - t0
        require(np.array_equal(out, ref), f"{tag}: not lossless")
        got_l = block_launches(tag, src)
        require(dec.stats["device_blocks"] == got_l["rice_decode"],
                f"{tag}: block routing {dec.stats}")
        lines.append(f"{tag} {nblk} blocks lossless, launches {got_l}, "
                     f"{nblk / dt:.0f} blocks/s")
    # Blocks of B = 1 at an odd length and at 16384.
    from srla_tpu_torch.signals import make_music
    one = make_music(1.0)
    b16 = host_encoder.encode(one, 16, SAMPLE_RATE, preset=4,
                              max_block=16384)
    for tag, src, ref in (("odd_3001", host_encoder.encode(
            hires[-1], 24, HIRES_RATE, preset=4, max_block=8192),
            hires[-1]), ("B16384", b16, one)):
        out, _ = walk_blocks(np, SRLADecoder(dev), src)
        require(np.array_equal(out, ref), f"decode_block {tag}: not "
                                          f"lossless")
    lines.append("decode_block at n 3001 and 16384 lossless")
    sdec = StreamingDecoder(stream4, dev)
    marks, parts = [], []
    t0 = time.perf_counter()

    def stream_all():
        while not sdec.exhausted:
            marks.append(sdec.tell())
            parts.append(sdec.decode_block())

    _, runs["streaming_m6_P3"] = counted(torch, wrappers, stream_all)
    dt = time.perf_counter() - t0
    require(np.array_equal(np.concatenate(parts, axis=1), pcm4),
            "StreamingDecoder: not lossless")
    block_launches("streaming_m6_P3", stream4)
    half = len(marks) // 2
    again = StreamingDecoder(stream4, dev)
    again.seek_to_block(*marks[half])
    rest = list(again.blocks())
    require(len(rest) == len(parts) - half and all(
        np.array_equal(a, b) for a, b in zip(rest, parts[half:])),
        "StreamingDecoder: the resumed PCM differs")
    lines.append(f"StreamingDecoder {len(parts)} blocks lossless, resumed at "
                 f"block {half} equal, {len(parts) / dt:.0f} blocks/s")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "m6_P3.srl")
        with open(path, "wb") as f:
            f.write(stream4)
        t0 = time.perf_counter()
        rc, runs["player_m6_P3"] = counted(torch, wrappers, lambda: (
            srla_player.main([path, "--sink", "null", "--device", str(dev)])))
        dt = time.perf_counter() - t0
    require(rc == 0, "the player failed")
    block_launches("player_m6_P3", stream4)
    lines.append(f"player --sink null {len(parts) / dt:.0f} blocks/s")
    print(f"phase 13 block API: encode_block on {len(blocks)} blocks equal "
          f"to the host's one-span encode, launches "
          f"{ {k: runs['encode_block'][k] for k in ENCODE_KERNELS} }; "
          + "; ".join(lines) + f" [{card}]")
    return runs


def phase_corpus(torch, np, dev, pcm, stream, pcm4, stream4, card):
    """Phase 13: the corpus encode and decode, the split, the block API.
    Returns ({path: {run: launches}}, the hi-res files, their streams)."""
    hires = hires_corpus(np)
    paths = {}
    paths["hires96k_24bit_B8192"], hires_streams = corpus_case(
        torch, np, dev, "hi-res corpus -m 4 -B 8192", hires, 24, HIRES_RATE,
        8192, card, False)
    paths["short64_B4096"], _ = corpus_case(
        torch, np, dev, "64 short files -m 4 -B 4096", short_corpus(np), 16,
        SAMPLE_RATE, 4096, card, True)
    paths["block_api"] = phase_block_api(torch, np, dev, pcm, stream, pcm4,
                                         stream4, hires, card)
    return paths, hires, hires_streams


# ---------------------------------------------------------------------------
# Phase 14: the decode to device-resident PCM, K13
# ---------------------------------------------------------------------------

RESIDENT_SECONDS = 10.0          # the corruption stream's length


def silent_raw_case(np):
    """RESIDENT_SECONDS of make_music with a second of silence and a second
    of full-scale noise (SILENT and RAW blocks), at -m 4 -B 4096 -V 0."""
    from srla_tpu_torch.host_encoder import encode
    from srla_tpu_torch.signals import make_music
    pcm = make_music(RESIDENT_SECONDS)
    pcm[:, SAMPLE_RATE:2 * SAMPLE_RATE] = 0
    pcm[:, 3 * SAMPLE_RATE:4 * SAMPLE_RATE] = np.random.RandomState(
        23).randint(-2 ** 15, 2 ** 15, (2, SAMPLE_RATE))
    return pcm, encode(pcm, 16, SAMPLE_RATE, preset=4)


def k13_groups(torch, np, dev, stream: bytes, want_dev):
    """K13 against verify_blocks_plain on every group of ``stream``, each
    decoded on the card: as decoded (true), with one sample of its middle
    row flipped (false), and with that row not ok (true). Returns (checks,
    the largest group's K13 arguments, its n, B and starts, and the
    smallest group's)."""
    from srla_tpu_torch.decoder import SRLADecoder, upload_stream
    from srla_tpu_torch.kernels.decode2 import decode_blocks
    from srla_tpu_torch.kernels.verify import (verify_blocks,
                                               verify_blocks_plain)

    header, _, groups = SRLADecoder(dev).plan(stream)
    C = header.num_channels
    words = upload_stream(stream, dev)
    checks, largest, smallest = 0, None, None
    for g in groups:
        B = len(g.starts)
        out = decode_blocks(words, torch.from_numpy(g.meta).to(dev),
                            header.offset_lshift, n=g.n, C=C, M=g.M, W=g.W,
                            has_ltp=g.has_ltp)
        starts = torch.from_numpy(g.starts.astype(np.int32)).to(dev)
        ok = torch.ones(B, dtype=torch.bool, device=dev)
        k = B // 2
        bad = out.clone()
        bad[k, C - 1, g.n // 2] ^= 1
        skip = ok.clone()
        skip[k] = False
        for args, want in (((out, want_dev, starts, ok), True),
                           ((bad, want_dev, starts, ok), False),
                           ((bad, want_dev, starts, skip), True)):
            got = bool(verify_blocks(*args, n=g.n, B=B))
            plain = bool(verify_blocks_plain(*args, n=g.n, B=B))
            require(got == plain == want,
                    f"K13 gives {got}, its plain version {plain}, expected "
                    f"{want} on the {B}-block group of n={g.n}")
            checks += 1
        group = ((out, want_dev, starts, ok), g.n, B, g.starts)
        if largest is None or B > largest[2]:
            largest = group
        if smallest is None or B < smallest[2]:
            smallest = group
    return checks, largest, smallest


def resident_sync_lines() -> tuple[set, set]:
    """Lines of srla_tpu_torch/decoder.py where the resident decode may
    wait for the card: its uploads (the stream, each shard's parameters and
    starts, expected to another device), and its flag fetch."""
    import inspect

    from srla_tpu_torch import decoder
    src, first = inspect.getsourcelines(
        decoder.SRLADecoder.decode_whole_device_resident)
    uploads = {first + i for i, line in enumerate(src) if ".to(d)" in line}
    flags = {first + i for i, line in enumerate(src) if ".item()" in line}
    src, first = inspect.getsourcelines(decoder.upload_stream)
    uploads |= {first + i for i, line in enumerate(src)
                if ".to(device)" in line}
    require(len(flags) == 1 and len(uploads) == 3,
            f"resident decode: uploads at {uploads}, flag fetch at {flags}")
    return uploads, flags


def check_resident_syncs(sites: dict, devices: int, what: str) -> None:
    """No host synchronisation of the port but the uploads and one flag
    fetch a device: no PCM crosses to the host."""
    uploads, flags = resident_sync_lines()
    fetches = 0
    for site, count in sites.items():
        if not site.startswith("srla_tpu_torch/"):
            continue
        path, line = site.rsplit(":", 1)
        require(path == "srla_tpu_torch/decoder.py"
                and int(line) in uploads | flags,
                f"{what}: a host synchronisation at {site} ({count}x), not "
                f"an upload or the flag fetch")
        if int(line) in flags:
            fetches += count
    require(fetches == devices, f"{what}: {fetches} flag fetches, expected "
                                f"one a device ({devices})")


def resident_case(torch, np, dev, what: str, pcm, stream: bytes):
    """One stream's decode to device-resident PCM on the card, counted:
    lossless, every COMPRESS block on the device, K2 and K13 once a group
    and K1 at least once; then K13 against its plain version on every
    group. Returns (launches, K13's checks, the largest group's K13
    arguments, expected on the card, the smallest group's K13
    arguments)."""
    from srla_tpu_torch import SRLADecoder

    _, _, groups = SRLADecoder(dev).plan(stream)
    want_dev = torch.from_numpy(np.ascontiguousarray(pcm, np.int32)).to(dev)
    dec = SRLADecoder(dev)
    (ok, stats), got = counted(
        torch, all_wrappers(),
        lambda: dec.decode_whole_device_resident(stream, (want_dev, pcm)))
    require(ok is True, f"phase 14 {what}: the resident decode is {ok}")
    ncomp = compress_blocks(stream)
    require(stats == {"device_blocks": ncomp, "host_blocks": 0},
            f"phase 14 {what}: block routing {stats}, expected {ncomp} on "
            f"the device")
    for name in ("verify", "rice_decode"):
        require(got[name] == len(groups),
                f"phase 14 {what}: {name} launched {got[name]} times, "
                f"expected {len(groups)} (one a group)")
    decode_launches_ok(got, len(groups), got["ltp_synth"],
                       tail_groups(stream, len(groups)), f"phase 14 {what}")
    checks, largest, smallest = k13_groups(torch, np, dev, stream, want_dev)
    shown = {k: got[k] for k in DECODE_SHOWN + ("verify",)}
    print(f"phase 14 {what}: resident decode True, {ncomp} COMPRESS blocks "
          f"on the device in {len(groups)} groups, launches {shown}; K13 "
          f"equal to its plain version on {checks} checks")
    return got, checks, largest, want_dev, smallest


def phase_resident(torch, np, dev, cases, card):
    """Phase 14: the decode to device-resident PCM. Each of ``cases``
    (path, PCM, stream) decoded by decode_whole_device_resident and K13
    held to its plain version (resident_case); the three corruptions on a
    stream with SILENT and RAW blocks; the first case split over two
    shards; the host synchronisations by line; the warm speed beside
    decode_whole's and a profile; K13 timed on the first case's largest
    group. Returns (K13's record, {path: {run: launches}})."""
    from srla_tpu_torch import SRLADecoder, decode
    from srla_tpu_torch.constants import BlockDataType
    from srla_tpu_torch.kernels.verify import (verify_blocks,
                                               verify_blocks_plain)

    runs, checks, main = {}, 0, None
    for path, pcm, stream in cases:
        got, c, largest, want_dev, smallest = resident_case(
            torch, np, dev, path, pcm, stream)
        runs[path] = {"resident": got}
        checks += c
        if main is None:
            main = (path, pcm, stream, largest, want_dev, smallest)

    # One flipped sample in a COMPRESS, a RAW and a SILENT block.
    pcm, stream = silent_raw_case(np)
    blocks, at = [], 0
    for t, n in stream_blocks(stream):
        blocks.append((t, at, n))
        at += n
    got, c, _, _, _ = resident_case(torch, np, dev, "music10_silent_raw",
                                    pcm, stream)
    runs["music10_silent_raw"] = {"resident": got}
    checks += c
    for btype in (BlockDataType.COMPRESS, BlockDataType.RAW,
                  BlockDataType.SILENT):
        found = [b for b in blocks if b[0] == btype]
        require(bool(found), f"phase 14: no {btype.name} block to corrupt")
        _, s, n = found[len(found) // 2]
        bad = pcm.copy()
        bad[1, s + n // 2] ^= 1
        ok, _ = SRLADecoder(dev).decode_whole_device_resident(
            stream, (torch.from_numpy(bad).to(dev), bad))
        require(ok is False, f"phase 14: a flipped sample in a "
                             f"{btype.name} block gives {ok}")

    path, pcm, stream, (args, n, B, starts), want_dev, tail = main
    _, _, groups = SRLADecoder(dev).plan(stream)
    split = SRLADecoder(dev, devices=[dev, dev])
    (ok, st), got = counted(
        torch, all_wrappers(), lambda: split.decode_whole_device_resident(
            stream, (want_dev, pcm)))
    shards = sum(min(2, len(g.starts)) for g in groups)
    require(ok is True and got["verify"] == shards,
            f"phase 14 {path} over two shards: {ok}, K13 launched "
            f"{got['verify']} times, expected {shards}")
    runs[path]["resident_split"] = got

    one = sync_sites(torch, lambda: SRLADecoder(
        dev).decode_whole_device_resident(stream, (want_dev, pcm)))
    check_resident_syncs(one, 1, f"phase 14 {path}")
    two = sync_sites(torch, lambda: SRLADecoder(
        dev, devices=[dev, dev]).decode_whole_device_resident(
        stream, (want_dev, pcm)))
    check_resident_syncs(two, 1, f"phase 14 {path} over two shards")
    print(f"phase 14 {path} host synchronisations by line: resident decode "
          f"{one}; over two shards of one card {two}; shard_cuts "
          f"{st['shard_cuts']}; the resident decode corrupted in a "
          f"COMPRESS, a RAW and a SILENT block: False each")

    seconds = pcm.shape[1] / SAMPLE_RATE
    t_res = best_of(torch, lambda: SRLADecoder(
        dev).decode_whole_device_resident(stream, (want_dev, pcm)))
    t_dec = best_of(torch, lambda: decode(stream, device=dev))
    t_plan = min(timed(lambda: SRLADecoder(dev).plan(stream))
                 for _ in range(3))
    print(f"phase 14 {path} warm best of 3: resident decode "
          f"{t_res * 1e3:.1f} ms = {seconds / t_res:.1f}x realtime, "
          f"decode_whole {t_dec * 1e3:.1f} ms = {seconds / t_dec:.1f}x "
          f"realtime; the host plan alone {t_plan * 1e3:.1f} ms [{card}]")
    profile_decode(torch, lambda: SRLADecoder(
        dev).decode_whole_device_resident(stream, (want_dev, pcm)),
        "phase 14 resident decode profile")

    # K13 at the largest group; the yardstick compares the same spans in
    # one torch.equal where the group's blocks are consecutive.
    out = args[0]
    C = out.shape[1]
    ms = cuda_ms(torch, lambda: verify_blocks(*args, n=n, B=B), 20)
    dev_ms = device_ms(torch, lambda: verify_blocks(*args, n=n, B=B), 20)
    plain_ms = cuda_ms(torch, lambda: verify_blocks_plain(*args, n=n, B=B),
                       2)
    require(bool((np.diff(starts) == n).all()),
            f"phase 14: the {B}-block group is not consecutive")
    s0 = int(starts[0])
    span = want_dev[:, s0:s0 + B * n].view(C, B, n)
    require(torch.equal(out.permute(1, 0, 2), span),
            "phase 14: torch.equal disagrees with K13")
    library_ms = cuda_ms(torch, lambda: torch.equal(out.permute(1, 0, 2),
                                                    span), 20)
    # Each ok row's n samples of out and of expected read once, the starts
    # and okrows read, the flag written; a compare and an or a sample.
    moved = 2 * nbytes(out[:B]) + nbytes(args[2]) + B + 1
    b = bound(moved, 2 * B * C * n)
    # The stream's tail group (its last block, of the samples left over).
    targs, tn, tB, _ = tail
    tail_ms = cuda_ms(torch, lambda: verify_blocks(*targs, n=tn, B=tB), 20)
    tail_dev_ms = device_ms(torch, lambda: verify_blocks(*targs, n=tn,
                                                         B=tB), 20)
    print(f"phase 14 K13 verify at B={B} C={C} n={n}: equal to plain on "
          f"{checks} checks over {len(cases) + 1} streams; kernel "
          f"{ms:.4f} ms, device time {dev_ms:.4f} ms (CUDA graph), plain "
          f"{plain_ms:.2f} ms, torch.equal {library_ms:.4f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}; operations "
          f"{b['ops_ms']:.4f} ms); tail group B={tB} n={tn}: kernel "
          f"{tail_ms:.4f} ms, device time {tail_dev_ms:.4f} ms [{card}]")
    rec = dict(name="verify", route="cuda",
               source="srla_tpu_torch/kernels/csrc/verify.cu",
               replaces="srla_tpu/kernels/decode2.py:660", max_abs_err=0,
               ms=ms, device_ms=dev_ms, plain_ms=plain_ms, **b,
               library_ms=library_ms, checks=checks, tail_ms=tail_ms,
               tail_device_ms=tail_dev_ms)
    return rec, runs



# ---------------------------------------------------------------------------
# Phase 15: the f32 approximate encode (K14, K15, with K3 and K5)
# ---------------------------------------------------------------------------

# H100 SXM f32 outside the tensor cores: 67 TFLOP/s (data sheet) counts a
# fused multiply-add as two; K14's multiplies and adds are unfused (each
# its own instruction, one issue slot), so its operations are counted as
# f32 instructions over half that rate.
F32_INSTR_PER_S = 67e12 / 2
# (path, -V, -P, -m): -m 5 is max order 128, K14 at 16 lanes a row.
APPROX_PATHS = (("music120_V0_approx", 0, 0, 4),
                ("music120_V1_approx", 1, 0, 4),
                ("music120_V0_P3_approx", 0, 3, 4),
                ("music120_V0_m5_approx", 0, 0, 5))
# The approximate streams' lengths on these paths since K14's sum order was
# fixed: K17 and K5's row entry take the same decisions and words as the
# torch selection and the gathered pack before them.
APPROX_BYTES = {"music120_V0_approx": 15491570,
                "music120_V1_approx": 15491570,
                "music120_V0_P3_approx": 15482330,
                "music120_V0_m5_approx": 15482443}
# chain_probe.cu's K14 step kinds: kind -> (lanes a row, registers a lane).
K14_STEP_KINDS = {8: (8, 9), 9: (16, 5), 10: (32, 3), 11: (16, 9),
                  12: (32, 5), 13: (32, 8)}


def approx_param(V: int, P: int, preset: int = 4):
    """-m preset -B 4096 -V V -L 4 -P P for 16-bit stereo at 44.1 kHz."""
    from srla_tpu_torch.host_encoder import make_parameter
    return make_parameter(2, 16, SAMPLE_RATE, preset, 4096, V, 4, P, 0)


def k14_odd_lags(torch, np, V: int, n: int, bps: int, M: int, seed: int,
                 dev=None):
    """(V, M+1) f32 lags with the ridge (on ``dev``, the lags computed
    there; by default the CPU): rows of segmented
    music, full-range noise and sines through the f32 autocorrelation,
    then edge rows: lag 0 zero (0), lag 0 under 2^-23 (1: silent), an
    AR(1) row of coefficient 129/256, whose 8-bit quantization is a
    half-even tie at -64.5 (2), and a row of one nonzero lag (3). At
    max_fixed every row has order M; otherwise the edge rows have order 1
    and the others range up to M."""
    from srla_tpu_torch.kernels.encode import autocorr
    from srla_tpu_torch.signals import make_segmented

    rng = np.random.RandomState(seed)
    src = make_segmented(1.0)
    rows = []
    for r in range(V):
        if r % 3 == 0:
            o = rng.randint(0, src.shape[1] - n)
            rows.append(src[r % 2, o:o + n].astype(np.int64) << (bps - 16))
        elif r % 3 == 1:
            rows.append(rng.randint(-(1 << (bps - 1)), 1 << (bps - 1), n))
        else:
            rows.append(np.round(np.sin(np.arange(n) / (3.0 + r))
                                 * (1 << (bps - 2)) + rng.randn(n) * 50))
    work = torch.from_numpy(np.stack(rows).astype(np.int32))
    if dev is not None:
        work = work.to(dev)
    ac = autocorr(work, n, bps, M + 1, 1 << (n - 1).bit_length())
    ac[:, 0] = ac[:, 0] * float(np.float32(1.0 + 1e-5))
    ac[0] = 0.0
    ac[1] = 0.0
    ac[1, 0] = 1e-8
    rho = np.float32(129.0 / 256.0)
    ac[2] = torch.from_numpy(rho ** np.arange(M + 1, dtype=np.float32)).to(
        ac.device)
    ac[3] = 0.0
    ac[3, 0] = 1.0
    return ac.contiguous()


def k15_odd_rows(torch, np, V: int, n: int, seed: int):
    """(V, n) int32 residual rows on the CPU, seven kinds in turn:
    music-like, 24-bit full-range, int32-extreme (zigzag codes of 2^31 and
    above), all zero (ALLZERO), codes of 2 (row mean 2 exactly: recursive),
    alternating 0/1 (mean 1: plain), one sample of -2^31."""
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    rows = []
    for r in range(V):
        kind = r % 7
        if kind == 0:
            x = np.round(np.sin(t / (2.0 + r)) * 3000 + rng.randn(n) * 40)
        elif kind == 1:
            x = rng.randint(-(1 << 23), 1 << 23, n)
        elif kind == 2:
            x = rng.randint(-(1 << 31), 1 << 31, n, dtype=np.int64)
        elif kind == 3:
            x = np.zeros(n)
        elif kind == 4:
            x = np.ones(n)
        elif kind == 5:
            x = t % 2
        else:
            x = np.zeros(n)
            x[n // 3] = -(1 << 31)
        rows.append(x)
    return torch.from_numpy(np.stack(rows).astype(np.int32))


def levinson_ops(m: int) -> int:
    """f32 multiplies and adds of one Levinson recursion up to order m:
    step k (0..m-2) sums k+2 products (k+2 multiplies, k+1 adds) and
    updates a[0..k+2] (k+3 multiplies and adds), plus the start's three."""
    return 3 + sum(4 * k + 9 for k in range(max(m - 1, 0)))


def k14_bound(args, out) -> dict:
    """K14's bound on this run's inputs: the lags read once, the outputs
    written once; the f32 instructions this data needs: the recursion to M
    with each order's length (about 20 operations and two logarithms,
    counted as 30; no lengths at max_fixed) and the quantization of each
    row's chosen order (4 a coefficient)."""
    ac, n, bps, M, fixed = args
    V = ac.shape[0]
    ops = V * (levinson_ops(M) + (0 if fixed else 30 * M)) \
        + 4 * int(out[0].long().sum())
    return bound(nbytes(ac) + nbytes(*out), ops, F32_INSTR_PER_S)


def k15_bound(args, out) -> dict:
    """K15's bound on this run's inputs: the residual read once and the
    outputs written once (code type, order and ks int64, bits int32); the
    integer instructions of the cheapest sequence for the terms this data
    needs, priced as K4's bound prices them: a sample's zigzag and 64-bit
    leaf-sum add (5) once, then 3 a term on recursive rows and 2 on plain
    ones (none on all-zero rows). A term depends on the sample and its
    parameter alone, so a sample needs one for each distinct parameter
    among its partitions of orders 0..max_porder (the parameters of each
    order from the exact partition sums, as the plain version computes
    them), not one an order."""
    import torch
    from srla_tpu_torch.kernels.bitpack import zigzag
    from srla_tpu_torch.kernels.rice_cost import plain_k, recursive_k

    res, n, max_porder = args
    V = res.shape[0]
    code_type = out[0]
    leaves, leaf = 1 << max_porder, n >> max_porder
    sums = zigzag(res).view(V, leaves, leaf).sum(dim=2)
    rec = (code_type == 1)[:, None]
    ks = []
    for p in range(max_porder + 1):
        part = sums.view(V, 1 << p, leaves >> p).sum(dim=2)
        m = part.to(torch.float32) / torch.full(
            part.shape, float(n >> p), device=part.device)
        k = torch.where(rec, recursive_k(m), plain_k(m))
        ks.append(k.repeat_interleave(leaves >> p, dim=1))
    ks = torch.stack(ks, dim=1).sort(dim=1).values     # (V, orders, leaves)
    distinct = 1 + (ks[:, 1:] != ks[:, :-1]).sum(dim=1)
    per_term = torch.where(code_type == 1, 3,
                           torch.where(code_type == 0, 2, 0))
    terms = int((per_term * distinct.sum(dim=1)).sum()) * leaf
    return bound(nbytes(res) + nbytes(*out), 5 * V * n + terms)


def approx_timed(torch, what: str, kernel, plain, args, bound_fn,
                 reps: int = 20) -> dict:
    """A kernel against its plain version on ``args`` (every output,
    bit-equal), timed by CUDA events and by graph replay, beside its bound
    on these inputs and its plain version's time."""
    e, ms, pms = compare(torch, what, kernel, plain, args, reps)
    return dict(max_abs_err=e, ms=ms, plain_ms=pms,
                device_ms=device_ms(torch, lambda: kernel(*args), reps),
                **bound_fn(args, kernel(*args)))


def approx_kernel_inputs(torch, np, dev, pcm, tail: bool = False):
    """K14's and K15's inputs as the approximate analysis of the main
    group (1291 blocks of 4096: V 5164, M 64, partition orders 0..10) or
    of its tail group (1 block of 4064: V 4, orders 0..5) hands them over:
    (K14's args, K15's args, the variant rows)."""
    from srla_tpu_torch.kernels import encode as approx
    from srla_tpu_torch.kernels.exact import variant_stack
    from srla_tpu_torch.kernels.predict import predict, reverse_coefs

    blocks, _, args, _ = main_group(torch, np, dev, pcm, tail)
    n, M = args["n"], args["max_params"]
    sig = variant_stack(blocks, 0)
    work, _ = approx.preemphasis(sig)
    ac = approx.autocorr(work, n, args["bps"], M + 1, args["fft_size"])
    ac[:, 0] = ac[:, 0] * float(np.float32(1.0 + 1e-5))
    k14 = (ac.contiguous(), n, args["bps"], M, args["max_fixed"])
    from srla_tpu_torch.kernels.lpc_f32 import lpc_analyze_f32
    orders, intc, rshifts = lpc_analyze_f32(*k14)
    res = predict(work, reverse_coefs(intc, orders), orders, rshifts)
    return k14, (res, n, args["max_porder"]), sig


def approx_no_plain(fn):
    """fn() with the plain versions of K14, K15, K16's f32 entry, K18, K17
    and K5's section entry (and the torch variant stack and span cut that
    K16's plain version composes) replaced by tripwires: an approximate
    encode on the card that reached one of them raises."""
    from srla_tpu_torch.kernels import lpc_f32, rice_cost
    from srla_tpu_torch.kernels import ltp as k18
    from srla_tpu_torch.kernels import preemphasis as k16
    names = ((lpc_f32, "lpc_analyze_f32_plain"),
             (rice_cost, "rice_cost_plain"),
             (k16, "variant_preemphasis_f32_plain"),
             (k16, "preemphasis_f32_rows"), (k16, "variant_stack"),
             (k16, "cut_spans"), (k18, "ltp_predict_plain")) \
        + stage_plains()
    saved = [getattr(m, name) for m, name in names]

    def tripwire(*_a, **_k):
        raise RuntimeError("a plain version of K14, K15, K16, K17, K18 or "
                           "K5 ran on the approximate encode's path")

    for m, name in names:
        setattr(m, name, tripwire)
    try:
        return fn()
    finally:
        for (m, name), f in zip(names, saved):
            setattr(m, name, f)


def k14_floor(torch, M: int, card: str) -> dict:
    """K14's serial floor at largest order M: a recursion step of
    chain_probe.cu kinds 8-13 (each lane count and register count the
    lane choice weighed) times the M - 1 steps of a row, at the kind of
    ``lanes_for(M)``'s layout."""
    from srla_tpu_torch.kernels.lpc_f32 import lanes_for

    steps = {kind: chain_step_ms(torch, kind) for kind in K14_STEP_KINDS}
    chain = M - 1
    lanes = lanes_for(M)
    kind = next(k for k, (L, R) in K14_STEP_KINDS.items()
                if L == lanes and R == (M + lanes) // lanes)
    floor = steps[kind] * chain
    print("phase 15 K14 one recursion step (chain_probe.cu kinds 8-13, L "
          "lanes, R registers): " + ", ".join(
              f"L{L} R{R} {steps[k] * 1e6:.1f} ns"
              for k, (L, R) in K14_STEP_KINDS.items())
          + f"; serial floor at the main group {floor:.4f} ms ({chain} "
          f"steps of kind {kind}, L {lanes}) [{card}]")
    return dict(serial_floor_ms=floor, serial_floor_steps=chain,
                step_ns={f"L{L}_R{R}": steps[k] * 1e6
                         for k, (L, R) in K14_STEP_KINDS.items()})


def phase_approx(torch, np, dev, pcm, stream: bytes, card: str):
    """Phase 15: the f32 approximate encode. K14 and K15 against their
    plain versions at the main group's, the tail group's and odd shapes;
    the approximate encode of the 120 s file at -m 4 -B 4096 -V 0, counted
    (K16's f32 entry, K14, K15, K3 and K5 once a group, K18 once a group
    with -P, the exact analysis' K8, K7, K4 and K16's exact entry never, no
    plain version reached), lossless on the card, within 2 % of the exact
    stream, timed beside the exact encode; the same at -V 1 and at -V 0 -P
    3; the StepTimer split at -V 0, -V 1 -L 4 and -V 0 -P 3;
    full_step_sharded over [cuda:0, cuda:0] against one call. The same at
    -m 5 (max order 128). K14's recursion's serial floor (``k14_floor``).
    Returns (K14's and K15's records, {path: {run: launches}})."""
    from srla_tpu_torch import SRLAEncoder, decode, parallel
    from srla_tpu_torch.encoder import StepTimer
    from srla_tpu_torch.kernels import encode as approx
    from srla_tpu_torch.kernels.lpc_f32 import (lpc_analyze_f32,
                                                lpc_analyze_f32_plain)
    from srla_tpu_torch.kernels.rice_cost import rice_cost, rice_cost_plain

    t_phase = time.perf_counter()
    k14_main, k15_main, sig = approx_kernel_inputs(torch, np, dev, pcm)
    k14_tail, k15_tail, _ = approx_kernel_inputs(torch, np, dev, pcm, True)
    r14 = approx_timed(torch, "K14 (main group)", lpc_analyze_f32,
                       lpc_analyze_f32_plain, k14_main, k14_bound)
    t14 = approx_timed(torch, "K14 (tail group)", lpc_analyze_f32,
                       lpc_analyze_f32_plain, k14_tail, k14_bound)
    r15 = approx_timed(torch, "K15 (main group)", rice_cost,
                       rice_cost_plain, k15_main, k15_bound)
    t15 = approx_timed(torch, "K15 (tail group)", rice_cost,
                       rice_cost_plain, k15_tail, k15_bound)
    odd14, odd15 = [], []
    for M, n, bps in ((1, 64, 16), (7, 333, 16), (64, 4096, 24),
                      (128, 4096, 16), (255, 4096, 24)):
        for fixed in (False, True):
            args = (k14_odd_lags(torch, np, 37, n, bps, M, M).to(dev), n,
                    bps, M, fixed)
            odd14.append((M, n, fixed, approx_timed(
                torch, f"K14 (odd: M {M}, n {n})", lpc_analyze_f32,
                lpc_analyze_f32_plain, args, k14_bound, 5)))
            o, c, s = (t.cpu() for t in lpc_analyze_f32(*args))
            require(int(s[0]) == 8 and int(s[1]) == 8
                    and not c[:2].any(), "K14: silent rows not all zero "
                                         "with shift 8")
            if not fixed and M > 1:
                require(int(o[2]) == 1 and int(c[2, 0]) == -64,
                        "K14: the half-even tie row is not order 1 at -64")
    for n, P in ((6, 1), (512, 9), (3072, 10), (4064, 5), (4096, 10)):
        args = (k15_odd_rows(torch, np, 29, n, n).to(dev), n, P)
        odd15.append((n, P, approx_timed(torch, f"K15 (odd: n {n})",
                                         rice_cost, rice_cost_plain, args,
                                         k15_bound, 5)))
    for name, main_r, tail_r, odd in (("K14", r14, t14, [r for *_, r in
                                                         odd14]),
                                      ("K15", r15, t15, [r for *_, r in
                                                         odd15])):
        print(f"phase 15 {name} bit-equal to plain on every output: main "
              f"group kernel {main_r['ms']:.4f} ms, device time "
              f"{main_r['device_ms']:.4f} ms, plain {main_r['plain_ms']:.2f}"
              f" ms, bound {main_r['bound_ms']:.4f} ms ({main_r['bound_by']}"
              f"; operations {main_r['ops_ms']:.4f} ms); tail kernel "
              f"{tail_r['ms']:.4f} ms, device time "
              f"{tail_r['device_ms']:.4f} ms, plain {tail_r['plain_ms']:.2f}"
              f" ms, bound {tail_r['bound_ms']:.6f} ms; odd shapes: "
              + ", ".join(f"device {r['device_ms']:.4f} ms (bound "
                          f"{r['bound_ms']:.5f})" for r in odd)
              + f" [{card}]")
    floor = k14_floor(torch, k14_main[3], card)

    runs: dict = {}
    wrappers = {k: w for k, w in all_wrappers().items()
                if k in ("lpc_analyze_f32", "rice_cost", "fir_predict",
                         "pack_residual_sections", "bitpack", "autocorr",
                         "lpc_analyze", "rice_search", "ltp_analyze",
                         "select_blocks", "measure_blocks", "preemphasis",
                         "ltp_predict", "preemphasis_f32")}
    exact_sizes, times = {}, {}
    for path, V, P, preset in APPROX_PATHS:
        param = approx_param(V, P, preset)
        exact_enc = SRLAEncoder(param, dev)
        if V == 0 and P == 0 and preset == 4:
            exact_data = stream
        else:
            exact_data = exact_enc.encode_whole(pcm)
        enc = SRLAEncoder(param, dev, approx=True)
        require(enc.approx, f"{path}: approx was not taken")
        data, got = counted(torch, wrappers, lambda: approx_no_plain(
            lambda: enc.encode_whole(pcm)))
        _, out = decode(data, device=dev)
        require(np.array_equal(out, pcm), f"{path}: the approximate stream "
                                          f"is not lossless")
        ratio = len(data) / len(exact_data)
        require(ratio <= 1.02, f"{path}: approximate size {len(data)} is "
                               f"{ratio:.4f} of the exact {len(exact_data)}")
        require(len(data) == APPROX_BYTES[path],
                f"{path}: {len(data)} bytes, not {APPROX_BYTES[path]}")
        s = enc.stats
        ncomp = compress_blocks(data)
        require(s["device_blocks"] == ncomp and s["host_blocks"] == 0
                and s["repaired_blocks"] == 0,
                f"{path}: block routing {s}, {ncomp} COMPRESS blocks")
        # K16's f32 entry once an analysis call (a group, or a -V
        # measurement call), K18 once a group with -P; the exact analysis'
        # kernels and K16's exact entry never.
        for name in ("autocorr", "lpc_analyze", "rice_search",
                     "ltp_analyze", "bitpack", "preemphasis"):
            require(got[name] == 0, f"{path}: {name} launched {got[name]} "
                                    f"times by the approximate encode")
        require(got["preemphasis_f32"] == got["fir_predict"],
                f"{path}: K16's f32 entry launched {got['preemphasis_f32']} "
                f"times, K3 {got['fir_predict']}")
        want18 = got["pack_residual_sections"] if P else 0
        require(got["ltp_predict"] == want18,
                f"{path}: K18 launched {got['ltp_predict']} times, expected "
                f"{want18}")
        if V == 0:
            # Two groups (1291 blocks of 4096, 1 of 4064): once each.
            for name in ("lpc_analyze_f32", "rice_cost", "fir_predict",
                         "pack_residual_sections", "select_blocks"):
                require(got[name] == 2, f"{path}: {name} launched "
                                        f"{got[name]} times, expected 2")
            require(got["measure_blocks"] == 0, f"{path}: launches {got}")
        else:
            require(s["device_spans"] > 0 and s["remeasured_spans"] == 0
                    and s["host_spans"] == 0,
                    f"{path}: span accounting {s}")
            require(got["lpc_analyze_f32"] == got["rice_cost"]
                    == got["fir_predict"] > got["pack_residual_sections"]
                    > 0, f"{path}: launches {got}")
            # K17's encode entry once a group, its measurement entry once
            # a measurement call.
            require(got["select_blocks"] == got["pack_residual_sections"]
                    and got["measure_blocks"] == got["fir_predict"]
                    - got["pack_residual_sections"],
                    f"{path}: launches {got}")
        runs[path] = {"encode": got}
        exact_sizes[path] = (len(data), len(exact_data))
        best = best_of(torch, lambda: SRLAEncoder(
            param, dev, approx=True).encode_whole(pcm))
        best_exact = best_of(torch, lambda: SRLAEncoder(
            param, dev).encode_whole(pcm))
        times[path] = (best, best_exact)
        print(f"phase 15 {path}: approximate stream lossless on the card, "
              f"{len(data)} bytes = {ratio:.5f} of the exact "
              f"{len(exact_data)}, {s['device_blocks']} device / "
              f"{s['host_blocks']} host / {s['repaired_blocks']} repaired "
              f"of {ncomp} COMPRESS blocks, device_spans "
              f"{s['device_spans']}, launches {got}; warm best of 3 "
              f"{best * 1e3:.1f} ms = {MAIN_SECONDS / best:.1f}x realtime "
              f"(the exact encode {best_exact * 1e3:.1f} ms = "
              f"{MAIN_SECONDS / best_exact:.1f}x) [{card}]")
    splits = {}
    for what, V, P in (("-V 0", 0, 0), ("-V 1 -L 4", 1, 0),
                       ("-V 0 -P 3", 0, 3)):
        enc = SRLAEncoder(approx_param(V, P), dev, approx=True)
        enc.timer = StepTimer(dev)
        enc.encode_whole(pcm)
        steps = enc.timer.seconds
        splits[what] = {k: v * 1e3 for k, v in steps.items()}
        print(f"phase 15 approximate encode breakdown {what} (host clock, "
              f"synchronised per step, ms): "
              + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in steps.items())
              + f"; total {sum(steps.values()) * 1e3:.2f} [{card}]")

    # The sharded step over two shards of one card against one call.
    args = dict(n=4096, bps=16, max_params=64, max_fixed=False,
                fft_size=4096, max_porder=10)
    sig_np = sig.cpu().numpy()
    out, total = parallel.full_step_sharded([dev, dev], sig_np, **args)
    single = approx.analyze_variants(sig, **args)
    require(torch.equal(out["residual"], single["residual"])
            and torch.equal(out["rice_bits"], single["rice_bits"]),
            "full_step_sharded differs from one analyze_variants call")
    # The total is an f32 sum (as JAX's f32 all-reduce): above 2^24 bits it
    # rounds, by far less than 1e-6 of the exact total.
    exact_total = int(single["rice_bits"].sum())
    require(abs(total - exact_total) <= 1e-6 * exact_total,
            f"full_step_sharded total {total} is not the rows' "
            f"{exact_total} bits")
    print(f"phase 15 full_step_sharded over [cuda:0, cuda:0] on the main "
          f"group's {sig.shape[0]} rows: residual and bits equal to one "
          f"call, total {total:.0f} bits (f32; exact {exact_total}); phase "
          f"{time.perf_counter() - t_phase:.1f} s")

    base = dict(route="cuda", library_ms=None, approx_sizes=exact_sizes,
                approx_times_s=times, approx_steps_ms=splits)
    recs = [
        dict(name="lpc_analyze_f32", **base,
             source="srla_tpu_torch/kernels/csrc/lpc_analyze_f32.cu",
             replaces="srla_tpu/kernels/encode.py:67",
             also_replaces=["srla_tpu/kernels/encode.py:122",
                            "srla_tpu/kernels/encode.py:140"],
             max_abs_err=max([r14["max_abs_err"], t14["max_abs_err"]]
                             + [r["max_abs_err"] for *_, r in odd14]),
             **{k: r14[k] for k in ("ms", "plain_ms", "device_ms",
                                    "bound_ms", "bound_by", "ops_ms")},
             tail_ms=t14["ms"], tail_device_ms=t14["device_ms"],
             tail_bound_ms=t14["bound_ms"], tail_plain_ms=t14["plain_ms"],
             odd={f"M{M}_n{n}_{'fixed' if f else 'search'}":
                  r["device_ms"] for M, n, f, r in odd14},
             **floor),
        dict(name="rice_cost", **base,
             source="srla_tpu_torch/kernels/csrc/rice_cost.cu",
             replaces="srla_tpu/kernels/encode.py:288",
             max_abs_err=max([r15["max_abs_err"], t15["max_abs_err"]]
                             + [r["max_abs_err"] for *_, r in odd15]),
             **{k: r15[k] for k in ("ms", "plain_ms", "device_ms",
                                    "bound_ms", "bound_by", "ops_ms")},
             tail_ms=t15["ms"], tail_device_ms=t15["device_ms"],
             tail_bound_ms=t15["bound_ms"], tail_plain_ms=t15["plain_ms"],
             odd={f"n{n}_P{P}": r["device_ms"] for n, P, r in odd15})]
    return recs, runs


# ---------------------------------------------------------------------------
# Phase 16: the exact encode's last stages (K16, K17, K18, K5's row entry)
# ---------------------------------------------------------------------------

K16_EPS = 1e-8                   # kernels/exact.py _EPS_PREEMPH


def k16_half_row(np, n: int, sign: int = 1):
    """A row whose 16 r1 / r0 is 0.5 exactly (r0 32, r1 1; -0.5 with sign
    -1): a rounding half, which both routes must flag."""
    row = np.zeros(n, np.int64)
    row[:8] = (1, sign, 0, 5, 0, 2, 0, 1)
    return row


def k16_cases(np) -> list:
    """K16's odd cases, (what, samples, offsets or None, n, lshift):
    blocks (B, C, n) where offsets is None, else a (C, N) file and the
    offsets of its spans. n 333 at C 1 (int16, a half-boundary row, an
    all-zero block); n 333 at C 3 (int32 24-bit samples at lshift 2,
    spans at odd offsets, so no row starts on 16 bytes, and one span of
    int32 extremes, where M and S wrap); n 64 at C 2 with two equal
    half-boundary channels (S all zero, M and both channels on the half),
    their negative twin and an all-zero block."""
    rng = np.random.RandomState(16)
    n = 333
    b = rng.laplace(0, 2000, (9, 1, n)).clip(-32768, 32767).astype(np.int16)
    b[0, 0] = k16_half_row(np, n)
    b[1] = 0
    N = 9000
    f = (rng.laplace(0, 1 << 18, (3, N)).clip(-(1 << 23), (1 << 23) - 1)
         .astype(np.int32) >> 2) << 2
    offs = [1, 335, 1001, 2047, 4093, 6001, 8665]
    f[:, 6001:6001 + n] = rng.randint(-(1 << 31), 1 << 31, (3, n),
                                      dtype=np.int64)
    s = rng.laplace(0, 3000, (6, 2, 64)).clip(-32768, 32767).astype(np.int16)
    s[0, :] = k16_half_row(np, 64)
    s[1, :] = k16_half_row(np, 64, -1)
    s[2] = 0
    return [("n 333 C 1 int16 blocks", b, None, n, 0),
            ("n 333 C 3 int32 lshift 2 spans at odd offsets", f, offs, n, 2),
            ("n 64 C 2 half-boundary blocks", s, None, 64, 0)]


def k16_layout_cases(np) -> list:
    """K16's cases of its CTA-a-block layout, as k16_cases: n 1, 31, 333,
    4064 and 4096 (chunks of four cut short, one tile, a row shorter than
    a warp's samples); int16 spans at odd offsets (the scalar loads, rows
    not 16-byte aligned); a strided view of a block tensor (a (B, C, w)
    tensor wider than n, read through its columns 1..n); C 1, 2, 3 and 8
    (the units after the pair); int32 extremes at n 4096 (M and S wrap,
    the sums wrap); n 16384 (four tiles: the residual re-read by tile) at
    int32 lshift 8, as -B 16384 gives 24-bit samples of a 16-bit source,
    and at C 1."""
    rng = np.random.RandomState(21)

    def lap(shape, scale, dtype=np.int16, lim=1 << 15):
        return rng.laplace(0, scale, shape).clip(-lim, lim - 1).astype(dtype)

    pair = lap((2, 20000), 3000)
    octo = lap((8, 9000), 3000)
    wide = lap((2, 70000), 3000, np.int32) << 8
    return [
        ("n 1 C 2 int16 blocks", lap((5, 2, 1), 3000), None, 1, 0),
        ("n 31 C 1 int16 blocks", lap((7, 1, 31), 3000), None, 31, 0),
        ("n 333 C 2 int16 spans at odd offsets", pair,
         [1, 3, 335, 1001, 4093, 19001], 333, 0),
        ("n 4064 C 2 int16 spans at odd offsets", pair,
         [1, 4097, 8191, 15935], 4064, 0),
        ("n 4096 C 2 int16 strided view", lap((6, 2, 4099), 3000), None,
         4096, 0),
        ("n 4096 C 3 int32 lshift 2 blocks",
         lap((5, 3, 4096), 1 << 18, np.int32, 1 << 23) >> 2 << 2, None,
         4096, 2),
        ("n 4096 C 2 int32 extremes blocks", rng.randint(
            -(1 << 31), 1 << 31, (3, 2, 4096), dtype=np.int64).astype(
            np.int32), None, 4096, 0),
        ("n 333 C 8 int16 blocks", lap((4, 8, 333), 3000), None, 333, 0),
        ("n 4096 C 8 int16 spans", octo, [0, 4096, 4904], 4096, 0),
        ("n 16384 C 2 int32 lshift 8 spans (four tiles)", wide,
         [0, 16384, 33001, 50000], 16384, 8),
        ("n 16384 C 1 int16 blocks (four tiles)", lap((3, 1, 16384), 3000),
         None, 16384, 0)]


def k16_source(torch, dev, case):
    """The case's samples on ``dev``, as K16 takes them: ``Spans`` where
    the case has offsets, else the blocks (a block tensor wider than n
    through the strided view of its columns 1..n)."""
    from srla_tpu_torch.kernels.preemphasis import Spans
    _, data, offs, n, _ = case
    t = torch.from_numpy(data).to(dev)
    if offs is not None:
        return Spans(t, offs, n)
    return t if t.shape[2] == n else t[..., 1:1 + n]


def k16_entries():
    """K16 and its plain version as (src, lshift) -> outputs."""
    from srla_tpu_torch.kernels.preemphasis import (variant_preemphasis,
                                                    variant_preemphasis_plain)
    return (lambda src, lshift: variant_preemphasis(src, lshift,
                                                    eps=K16_EPS),
            lambda src, lshift: variant_preemphasis_plain(src, lshift,
                                                          eps=K16_EPS))


def k17_small(torch, np, dev, B: int, C: int, M: int, seed: int,
              sec64: bool = True, ltp_order: int = 3):
    """K17's inputs for B blocks of C channels at max order M: (small,
    rice_risky, the entry's keywords). Orders 0, 1, M and M + 3 (read as
    M) among random ones; coefficients small, or up to +-300 on every
    seventh row (codes past 255: the clamp and the summed form refused),
    int32 extremes on one row (the sums wrap); coefficient rows wider than
    M; sections above W words and block sums at the raw limit; LTP
    periods on a third of the rows; a few flags of each kind; block 0's
    variants all equal, so every stereo method ties."""
    rng = np.random.RandomState(seed)
    nvar = C + 2 if C >= 2 else 1
    V = nvar * B
    n, bps, W = 512, 16, 200
    orders = rng.randint(0, M + 1, V)
    orders[1:4] = (1, M, M + 3)[:len(orders[1:4])]
    coefs = rng.randint(-20, 21, (V, M + 2)).astype(np.int64)
    coefs[::7] = rng.randint(-300, 301, coefs[::7].shape)
    coefs[5 % V] = rng.choice([-(1 << 31), (1 << 31) - 1], M + 2)
    sec = rng.randint(0, 12000, V)
    sec[::13] = W * 32 + 1
    period = np.where(rng.rand(V) < 0.3, rng.randint(8, 263, V), 0)
    risky = rng.rand(V) < 0.02
    rice_risky = rng.rand(V) < 0.02
    same = np.arange(nvar) * B
    for a in (orders, coefs, sec, period, risky, rice_risky):
        a[same] = a[same[0]]
    risky[same] = rice_risky[same] = False
    risky[V - 1] = rice_risky[V - 2] = True    # at least one of each
    sec[np.arange(nvar) * B + B - 2] = 13000     # a raw block

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a).astype(dtype)).to(dev)

    small = dict(section_bits=t(sec, np.int64 if sec64 else np.int32),
                 orders=t(orders, np.int32), coefs=t(coefs, np.int32),
                 ltp_period=t(period, np.int32),
                 ltp_coefs=torch.zeros((V, ltp_order), dtype=torch.int32,
                                       device=dev),
                 risky=t(risky, bool))
    return small, t(rice_risky, bool), dict(B=B, C=C, n=n, bps=bps, W=W,
                                            max_params=M)


def dict_err(torch, what: str, got: dict, want: dict) -> int:
    """Two dicts of tensors: the same keys and dtypes, bit-equal. Returns
    max_abs_err."""
    require(set(got) == set(want), f"{what}: keys {sorted(got)} against "
                                   f"{sorted(want)}")
    for k in want:
        require(got[k].dtype == want[k].dtype
                and got[k].shape == want[k].shape,
                f"{what}: {k} is {got[k].dtype} {tuple(got[k].shape)}, the "
                f"plain version's {want[k].dtype} {tuple(want[k].shape)}")
    e = max(max_abs_err(torch, got[k], want[k]) for k in want)
    require(e == 0, f"{what} differs from its plain version (max abs err "
                    f"{e})")
    return e


def k17_check(torch, what: str, small, rice_risky, kw) -> int:
    """K17's encode and measurement entries against their plain versions
    on the same inputs, every output. Returns max_abs_err."""
    from srla_tpu_torch.kernels import select
    mkw = {k: kw[k] for k in ("B", "C", "bps", "max_params")}
    e = dict_err(torch, f"K17 ({what})", select.select_blocks(
        small, rice_risky=rice_risky, **kw), select.select_blocks_plain(
        small, rice_risky=rice_risky, **kw))
    return max(e, dict_err(torch, f"K17's measurement entry ({what})",
                           select.measure_blocks(small, rice_risky=rice_risky,
                                                 **mkw),
                           select.measure_blocks_plain(
                               small, rice_risky=rice_risky, **mkw)))


# K17's edge shapes, (B, C, M, sec64): one row; a CTA's blocks (kBlocks in
# csrc/select.cu) less one, exactly, and one more; the encoder's largest
# call (MAX_CALL_BLOCKS); 32 channels (34 rows a block: the four warps of
# a block take eight or nine rows each); M 255 at C 3.
K17_EDGES = ((1, 1, 8, True), (3, 2, 64, False), (4, 2, 64, True),
             (5, 2, 64, False), (2048, 2, 64, True), (9, 32, 16, True),
             (13, 3, 255, False))


def k17_repeat_check(torch, np, dev, launches: int = 50) -> int:
    """K17's encode entry launched back to back with no synchronisation:
    ``launches`` launches at B 2048 C 2, each followed by one at B 9
    (three CTAs, so the larger grid's other status words stay from an
    earlier launch), each kind on the same inputs every time. Every launch's
    starts equal np.cumsum(lens_w) - lens_w, its outputs the first
    launch's of its kind, and those the plain version's. Returns the
    launches checked."""
    from srla_tpu_torch.kernels import select
    cases = [k17_small(torch, np, dev, 2048, 2, 64, 2048),
             k17_small(torch, np, dev, 9, 2, 64, 9)]
    outs = [select.select_blocks(s, rice_risky=r, **kw)
            for _ in range(launches) for s, r, kw in cases]
    torch.cuda.synchronize()
    for k, (s, r, kw) in enumerate(cases):
        dict_err(torch, f"K17 (launch {k} of {len(outs)} back to back)",
                 outs[k], select.select_blocks_plain(s, rice_risky=r, **kw))
    for k, got in enumerate(outs):
        lens = got["lens_w"].cpu().numpy()
        require(np.array_equal(got["starts"].cpu().numpy(),
                               np.cumsum(lens) - lens),
                f"K17's starts of launch {k} of {len(outs)} back to back "
                f"are not the running sum of its lens_w")
        first = outs[k % len(cases)]
        require(all(torch.equal(got[key], first[key]) for key in first),
                f"K17's launch {k} of {len(outs)} back to back differs "
                f"from the first on the same inputs")
    return len(outs)


def k17_graph_check(torch, np, dev, replays: int = 6) -> int:
    """K17's encode entry captured once in a CUDA graph and replayed on
    new inputs (copied into the captured ones) each time: each replay's
    outputs equal the plain version's on its inputs (the starts'
    generation is the device's, not the capture's). Returns the replays
    checked."""
    from srla_tpu_torch.kernels import select
    small, rice_risky, kw = k17_small(torch, np, dev, 1291, 2, 64, 1)
    select.select_blocks(small, rice_risky=rice_risky, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = select.select_blocks(small, rice_risky=rice_risky, **kw)
    for k in range(replays):
        new, new_risky, _ = k17_small(torch, np, dev, 1291, 2, 64, 100 + k)
        for key, t in new.items():
            small[key].copy_(t)
        rice_risky.copy_(new_risky)
        graph.replay()
        torch.cuda.synchronize()
        dict_err(torch, f"K17 (graph replay {k})", dict(out),
                 select.select_blocks_plain(small, rice_risky=rice_risky,
                                            **kw))
    return replays


def k18_cases(np) -> list:
    """K18's odd cases, (what, work, coefs, periods, order): 40 rows of 333
    and of 4096 samples at orders 1 and 3, periods 8..262 with period 0,
    8, 262, 9, n and n + 5 (the delay past the row) among them, four rows
    of int32 extremes (the sums and the subtraction wrap)."""
    rng = np.random.RandomState(18)
    cases = []
    for n in (333, 4096):
        V = 40
        work = rng.randint(-(1 << 20), 1 << 20, (V, n)).astype(np.int32)
        work[:4] = rng.randint(-(1 << 31), 1 << 31, (4, n), dtype=np.int64)
        periods = rng.randint(8, 263, V).astype(np.int32)
        periods[4:10] = (0, 8, 262, 9, n, n + 5)
        for order in (1, 3):
            coefs = rng.randint(-32, 32, (V, order)).astype(np.int32)
            cases.append((f"n {n} order {order}", work, coefs, periods,
                          order))
    return cases


def k5_rows_case(torch, np, dev, V: int, n: int, max_porder: int,
                 seed: int):
    """K5's row entry on V residual rows of n samples (Laplace scales 0.3
    to 3e4, a full-range row, an all-zero row): K4 (or its plain version
    on the CPU) chooses each row's Rice coding; half the rows, shuffled,
    are packed by index, the first of them skipped (lens_w 0). Returns
    (the entry's positional arguments, section_words)."""
    from srla_tpu_torch.kernels.rice_search import rice_search
    rng = np.random.RandomState(seed)
    scales = np.array([0.3, 0.9, 3.0, 40.0, 900.0, 3.0e4])
    res = rng.laplace(0, 1, (V, n)) * scales[np.arange(V) % 6][:, None]
    res = res.astype(np.int64)
    res[1] = rng.randint(-(1 << 31), 1 << 31, n, dtype=np.int64)
    res[2] = 0
    residual = torch.from_numpy(res.astype(np.int32)).to(dev)
    ct, po, bits, ks, _ = rice_search(residual, n, max_porder)
    rows = torch.from_numpy(rng.permutation(V)[:V // 2].astype(
        np.int64)).to(dev)
    lens_w = (bits[rows] + 31) // 32
    lens_w[0] = 0
    starts = torch.cumsum(lens_w, 0) - lens_w
    cap = int(lens_w.sum()) + 3
    return ((residual, ct, po, ks, n, starts, lens_w, cap, rows),
            max(int(lens_w.max()), 1))


def k5_rows_check(torch, what: str, args, image: int) -> int:
    """K5's row entry against its plain version and against the gathered
    entry on the same rows (zigzag32 and a gather first): equal words
    wherever a row owns them. Returns max_abs_err."""
    from srla_tpu_torch.kernels.bitpack import (pack_residual_sections,
                                                pack_residual_sections_plain,
                                                zigzag32)
    res, ct, po, ks, n, starts, lens_w, cap, rows = args
    got = pack_residual_sections(*args[:8], section_words=image, rows=rows)
    want = pack_residual_sections_plain(*args[:8], rows=rows)
    gathered = pack_residual_sections(zigzag32(res)[rows], ct[rows], po[rows],
                                      ks[rows], n, starts, lens_w, cap,
                                      section_words=image)
    torch.cuda.synchronize()
    total = int(lens_w.sum())
    e = max(max_abs_err(torch, got[:total], want[:total]),
            max_abs_err(torch, gathered[:total], want[:total]))
    require(e == 0, f"K5's row entry differs from its plain version or "
                    f"the gathered entry {what} (max abs err {e})")
    return e


def stage_timed(torch, kernel, plain, dev_fn=None, reps: int = 20) -> dict:
    """A kernel's CUDA-event time (the call as the encode makes it), its
    device time (graph replay of dev_fn, the kernel itself by default) and
    its plain version's time."""
    return dict(ms=cuda_ms(torch, kernel, reps),
                device_ms=device_ms(torch, dev_fn or kernel, reps),
                plain_ms=cuda_ms(torch, plain, 2))


def k16_bound(B: int, C: int, n: int, elem: int, V: int,
              spans: bool, flags: bool = True) -> dict:
    """K16's bound: each sample of the group read once (and the span
    offsets), the (V, n) int32 rows and their three fields (two without
    the flag: the f32 entry) written once; about 13 integer instructions a
    row sample (form it, two widening products and 64-bit adds, the
    residual's product, shift and subtraction)."""
    moved = (B * C * n * elem + (8 * B if spans else 0) + V * n * 4
             + (9 if flags else 8) * V)
    return bound(moved, 13 * V * n)


def torch_f32_preemphasis(torch, sig):
    """The approximate analysis' pre-emphasis before K16's f32 entry (torch
    ops on the variant rows, the sums in f32): a yardstick of the work the
    entry replaced, which the port no longer calls."""
    from srla_tpu_torch.kernels.lpc import wrap32
    x = sig.to(torch.float32)
    r0 = (x * x).sum(dim=1)
    r1 = (x[:, :-1] * x[:, 1:]).sum(dim=1)
    q = torch.clamp(torch.round(16.0 * r1 / torch.clamp_min(r0, 1e-30)),
                    -16, 15)
    coef = torch.where(r0 < 1e-6, 0.0, q).to(torch.int32)
    s = sig.long()
    prev = torch.cat([s[:, :1], s[:, :-1]], dim=1)
    pred = wrap32(prev * coef.long()[:, None]) >> 4
    return wrap32(s - pred).to(torch.int32), coef


def k17_bound(small, out: dict, M: int) -> dict:
    """K17's bound on this run's inputs: each row's section bits, order,
    period and flags and the coefficients its order reads once, the
    outputs once; about 12 integer instructions a coefficient read (two
    zigzags, two clamps, two lookups, the pair sum, the adds) and 30 a
    row and a block."""
    orders = small["orders"].long().clamp(0, max(M, 1))
    read = int(orders.sum())
    V = orders.numel()
    moved = (nbytes(small["section_bits"], small["orders"],
                    small["ltp_period"]) + 2 * V + 4 * read
             + nbytes(*out.values()))
    return bound(moved, 12 * read + 30 * V)


def k18_bound(args) -> dict:
    """K18's bound: the rows read once, coefficients and periods once, the
    rows written once; 2 * order + 4 instructions a filtered sample (the
    taps' products and sum, shift, subtraction, index) and 2 a sample
    copied."""
    work, coefs, periods, order = args
    V, n = work.shape
    delay = periods.long() + order // 2
    on = int((n - delay - 1).clamp(min=0)[periods > 0].sum())
    return bound(2 * nbytes(work) + nbytes(coefs, periods),
                 (2 * order + 4) * on + 2 * (V * n - on))


def k5_rows_bound(args) -> dict:
    """K5's row entry's bound: the packed rows' residuals read once, the
    parameters of their partitions, their fields and indices once, the
    words once; about a dozen operations a sample (phase 5's count) and
    the zigzag's three."""
    res, ct, po, ks, n, starts, lens_w, cap, rows = args
    live = lens_w > 0
    n_live = int(live.sum())
    nparts = int((1 << po[rows][live]).sum())
    moved = (4 * n_live * n + 8 * nparts + 40 * rows.numel()
             + 4 * int(lens_w.sum()))
    return bound(moved, 15 * n_live * n)


def phase_encode_stages(torch, np, dev, pcm, card):
    """Phase 16: K16, K17 (both entries), K18 and K5's row entry against
    their plain versions on the card at the main group's and the tail
    group's inputs (as the encode hands them over: K16 on the resident
    file's spans; K18 at -P 3) and at odd shapes: bit-equal, every output;
    each timed by CUDA events, by graph replay and beside its plain
    version and its bound. Returns (the records, K5's row entry's times)."""
    from srla_tpu_torch.kernels import build, exact, select
    from srla_tpu_torch.kernels.bitpack import (pack_residual_sections,
                                                pack_residual_sections_plain,
                                                zigzag32)
    from srla_tpu_torch.kernels.ltp import ltp_predict, ltp_predict_plain
    from srla_tpu_torch.kernels.preemphasis import Spans

    k16, k16_plain = k16_entries()
    file = torch.from_numpy(np.ascontiguousarray(pcm, np.int16)).to(dev)
    blocks, B, args, W = main_group(torch, np, dev, pcm)
    tail_blocks, _, tail_args, tail_W = main_group(torch, np, dev, pcm,
                                                   tail=True)
    n, tail_n = args["n"], tail_args["n"]
    main_src = Spans(file, np.arange(B) * n, n)
    tail_src = Spans(file, [B * n], tail_n)
    recs = []

    # K16.
    e = 0
    for what, src in (("main group", main_src), ("main group blocks",
                                                   blocks),
                      ("tail group", tail_src)):
        e = max(e, dict_err(torch, f"K16 ({what})", dict(enumerate(k16(
            src, 0))), dict(enumerate(k16_plain(src, 0)))))
    for case in k16_cases(np):
        src = k16_source(torch, dev, case)
        e = max(e, dict_err(torch, f"K16 ({case[0]})", dict(enumerate(k16(
            src, case[4]))), dict(enumerate(k16_plain(src, case[4])))))
        risky = k16(src, case[4])[2].cpu()
        if case[0].startswith("n 333 C 1"):
            flagged = bool(risky[0])           # block 0's only row
        elif case[0].startswith("n 64"):
            # M, ch0 and ch1 of blocks 0 and 1 (S is all zero there).
            flagged = bool(risky.reshape(4, -1)[[0, 2, 3]][:, :2].all())
        else:
            flagged = True
        require(flagged, f"K16 ({case[0]}): a half-boundary row is not "
                         f"flagged")
    for case in k16_layout_cases(np):
        src = k16_source(torch, dev, case)
        e = max(e, dict_err(torch, f"K16 ({case[0]})", dict(enumerate(k16(
            src, case[4]))), dict(enumerate(k16_plain(src, case[4])))))
    main_t = stage_timed(torch, lambda: k16(main_src, 0),
                         lambda: k16_plain(main_src, 0),
                         lambda: k16(blocks, 0))
    tail_t = stage_timed(torch, lambda: k16(tail_src, 0),
                         lambda: k16_plain(tail_src, 0),
                         lambda: k16(tail_blocks, 0))
    V = 4 * B
    b = k16_bound(B, 2, n, 2, V, True)
    tail_b = k16_bound(1, 2, tail_n, 2, 4, True)
    cp_ms = copy_ms(torch, dev, b["bound_ms"] * HBM_BYTES_PER_S / 1e3)
    print(f"phase 16 K16 preemphasis at B={B} C=2 n={n} (V={V}, int16 "
          f"spans of the resident file): bit-equal (also on the blocks "
          f"tensor, the tail group, {len(k16_cases(np))} odd cases: n "
          f"333 at C 1 and 3, unaligned spans, int32 extremes, half "
          f"boundaries flagged, and {len(k16_layout_cases(np))} layout "
          f"cases: n 1, 31, 333, 4064, 4096 and 16384 (four tiles), C 1, "
          f"2, 3 and 8, spans at odd offsets, a strided view, int32 at "
          f"lshift 8), kernel {main_t['ms']:.4f} ms (the call, the "
          f"offsets' upload included), device time "
          f"{main_t['device_ms']:.4f} ms (CUDA graph, blocks entry), plain "
          f"{main_t['plain_ms']:.2f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}; operations {b['ops_ms']:.4f} ms; a copy of "
          f"its bytes {cp_ms:.4f} ms); tail V=4 "
          f"n={tail_n}: kernel {tail_t['ms']:.4f} ms, device time "
          f"{tail_t['device_ms']:.4f} ms; the parent "
          f"{parent_text('k16_blocks', 'stages')} [{card}]")
    recs.append(dict(name="preemphasis", route="cuda",
                     source="srla_tpu_torch/kernels/csrc/preemphasis.cu",
                     replaces="srla_tpu/kernels/exact.py:83",
                     max_abs_err=e, ms=main_t["ms"],
                     plain_ms=main_t["plain_ms"], **b, library_ms=None,
                     tail_ms=tail_t["ms"], device_ms=main_t["device_ms"],
                     tail_device_ms=tail_t["device_ms"],
                     tail_bound_ms=tail_b["bound_ms"], copy_ms=cp_ms,
                     parent_in_turns=parent_runs("k16_blocks", "stages"),
                     spans_parent_in_turns=parent_runs("k16_spans",
                                                       "stages")))

    # K16's f32 entry (the approximate analysis' pre-emphasis).
    from srla_tpu_torch.kernels.preemphasis import (
        preemphasis_f32_sums, variant_preemphasis_f32,
        variant_preemphasis_f32_plain, variant_stack)
    e = 0
    rows = variant_stack(blocks, 0)
    for what, src, sh in (
            [("main group", main_src, 0), ("main group blocks", blocks, 0),
             ("main group rows", rows[:, None, :], 0),
             ("tail group", tail_src, 0)]
            + [(c[0], k16_source(torch, dev, c), c[4])
               for c in k16_cases(np) + k16_layout_cases(np)]):
        e = max(e, dict_err(torch, f"K16's f32 entry ({what})", dict(
            enumerate(variant_preemphasis_f32(src, sh))), dict(enumerate(
                variant_preemphasis_f32_plain(src, sh)))))
    # 24-bit rows of 16384 samples: r0 above 2^53.
    x24 = torch.from_numpy(np.random.RandomState(24).laplace(
        0, 1 << 21, (6, 2, 16384)).clip(-(1 << 23), (1 << 23) - 1)
        .astype(np.int32)).to(dev)
    e = max(e, dict_err(torch, "K16's f32 entry (24-bit n 16384)", dict(
        enumerate(variant_preemphasis_f32(x24, 0))), dict(enumerate(
            variant_preemphasis_f32_plain(x24, 0)))))
    require(bool((preemphasis_f32_sums(variant_stack(x24, 0))[0].double()
                  > 2.0 ** 53).any()), "no 24-bit row has r0 above 2^53")
    f32_t = stage_timed(torch, lambda: variant_preemphasis_f32(main_src, 0),
                        lambda: variant_preemphasis_f32_plain(main_src, 0),
                        lambda: variant_preemphasis_f32(blocks, 0))
    f32_tail = stage_timed(torch,
                           lambda: variant_preemphasis_f32(tail_src, 0),
                           lambda: variant_preemphasis_f32_plain(tail_src,
                                                                 0),
                           lambda: variant_preemphasis_f32(tail_blocks, 0))
    # The torch ops the approximate analysis ran before: the spans cut,
    # the variant stack and the f32 pre-emphasis (sums in f32).
    before = device_ms(torch, lambda: torch_f32_preemphasis(
        torch, variant_stack(blocks, 0)), 5)
    fb = k16_bound(B, 2, n, 2, V, True, flags=False)
    print(f"phase 16 K16's f32 entry (variant_preemphasis_f32) at B={B} "
          f"C=2 n={n} (V={V}, int16 spans): bit-equal to its plain version "
          f"there, on the blocks tensor, the rows' (V, 1, n) view, the tail "
          f"group, K16's {len(k16_cases(np))} odd and "
          f"{len(k16_layout_cases(np))} layout cases and 24-bit rows of "
          f"16384 (r0 above 2^53); kernel {f32_t['ms']:.4f} ms, device time "
          f"{f32_t['device_ms']:.4f} ms (blocks), plain "
          f"{f32_t['plain_ms']:.2f} ms, the torch stack and f32 "
          f"pre-emphasis it replaced: device time {before:.4f} ms; bound "
          f"{fb['bound_ms']:.4f} ms ({fb['bound_by']}); tail: kernel "
          f"{f32_tail['ms']:.4f} ms, device time "
          f"{f32_tail['device_ms']:.4f} ms; the parent "
          f"{parent_text('k16f32_blocks', 'stages')} [{card}]")
    recs.append(dict(name="preemphasis_f32", route="cuda",
                     source="srla_tpu_torch/kernels/csrc/preemphasis.cu",
                     replaces="srla_tpu/kernels/encode.py:41",
                     max_abs_err=e, ms=f32_t["ms"],
                     plain_ms=f32_t["plain_ms"], **fb, library_ms=None,
                     tail_ms=f32_tail["ms"], device_ms=f32_t["device_ms"],
                     tail_device_ms=f32_tail["device_ms"],
                     torch_ops_device_ms=before,
                     parent_in_turns=parent_runs("k16f32_blocks", "stages")))

    # K17 on the analysis of both groups, and at odd inputs.
    def analysed(src, a):
        core = exact.analyze_core(src, 0, **a)
        return core, exact.core_small(core)

    core, small = analysed(main_src, args)
    tail_core, tail_small = analysed(tail_src, tail_args)
    kw = dict(B=B, C=2, n=n, bps=16, W=W, max_params=args["max_params"])
    tail_kw = dict(B=1, C=2, n=tail_n, bps=16, W=tail_W,
                   max_params=tail_args["max_params"])
    e = max(k17_check(torch, "main group", small, core["rice_risky"], kw),
            k17_check(torch, "tail group", tail_small,
                      tail_core["rice_risky"], tail_kw))
    odd = []
    for B17, C17, M17, sec64 in ((37, 2, 8, True), (29, 1, 32, False),
                                 (23, 3, 64, True), (41, 2, 128, False),
                                 (7, 2, 255, True)):
        e = max(e, k17_check(torch, f"B {B17} C {C17} M {M17}", *k17_small(
            torch, np, dev, B17, C17, M17, B17 + M17, sec64)))
        odd.append(f"B {B17} C {C17} M {M17}")
    for B17, C17, M17, sec64 in K17_EDGES:
        e = max(e, k17_check(torch, f"B {B17} C {C17} M {M17}", *k17_small(
            torch, np, dev, B17, C17, M17, B17 + M17, sec64)))
        odd.append(f"B {B17} C {C17} M {M17}")
    repeated = k17_repeat_check(torch, np, dev)
    replays = k17_graph_check(torch, np, dev)

    def sel(s, c, k):
        return lambda: select.select_blocks(s, rice_risky=c["rice_risky"],
                                            **k)

    def sel_plain(s, c, k):
        return lambda: select.select_blocks_plain(
            s, rice_risky=c["rice_risky"], **k)

    mkw = {k: kw[k] for k in ("B", "C", "bps", "max_params")}
    main_t = stage_timed(torch, sel(small, core, kw),
                         sel_plain(small, core, kw))
    tail_t = stage_timed(torch, sel(tail_small, tail_core, tail_kw),
                         sel_plain(tail_small, tail_core, tail_kw))
    meas_t = stage_timed(torch, lambda: select.measure_blocks(
        small, rice_risky=core["rice_risky"], **mkw), lambda:
        select.measure_blocks_plain(small, rice_risky=core["rice_risky"],
                                    **mkw))
    out = select.select_blocks(small, rice_risky=core["rice_risky"], **kw)
    b = k17_bound(small, out, args["max_params"])
    mb = k17_bound(small, select.measure_blocks(
        small, rice_risky=core["rice_risky"], **mkw), args["max_params"])
    # The card's floor under the encode entry: an empty kernel on its grid.
    floor_ms = device_ms(torch, lambda: build.check(
        select._lib().srla_select_empty(
            B, torch.cuda.current_stream().cuda_stream), "select_empty"), 20)
    print(f"phase 16 K17 select_blocks at B={B} C=2 (V={V}, M "
          f"{args['max_params']}): bit-equal on every output (also the "
          f"tail group and {', '.join(odd)}: ties, clamps, int32 sums, raw "
          f"and W limits; {repeated} launches back to back and {replays} "
          f"replays of a captured launch on new inputs, each its own "
          f"starts), kernel {main_t['ms']:.4f} ms, device time "
          f"{main_t['device_ms']:.4f} ms (one kernel, no memset), plain "
          f"{main_t['plain_ms']:.2f} ms, bound {b['bound_ms']:.5f} ms "
          f"({b['bound_by']}), an empty kernel on its grid (the card's "
          f"floor) {floor_ms:.4f} ms; tail: kernel {tail_t['ms']:.4f} ms, "
          f"device time {tail_t['device_ms']:.4f} ms; measurement entry: "
          f"kernel {meas_t['ms']:.4f} ms, device time "
          f"{meas_t['device_ms']:.4f} ms, plain {meas_t['plain_ms']:.2f} "
          f"ms, bound {mb['bound_ms']:.5f} ms; the parent "
          f"{parent_text('k17_select', 'stages')}, measurement entry "
          f"{parent_text('k17_measure', 'stages')} [{card}]")
    recs.append(dict(name="select_blocks", route="cuda",
                     source="srla_tpu_torch/kernels/csrc/select.cu",
                     replaces="srla_tpu/kernels/exact.py:1317",
                     max_abs_err=e, ms=main_t["ms"],
                     plain_ms=main_t["plain_ms"], **b, library_ms=None,
                     tail_ms=tail_t["ms"], device_ms=main_t["device_ms"],
                     tail_device_ms=tail_t["device_ms"],
                     empty_launch_device_ms=floor_ms,
                     parent_in_turns=parent_runs("k17_select", "stages")))
    recs.append(dict(name="measure_blocks", route="cuda",
                     source="srla_tpu_torch/kernels/csrc/select.cu",
                     replaces="srla_tpu/kernels/exact.py:1317",
                     max_abs_err=e, ms=meas_t["ms"],
                     plain_ms=meas_t["plain_ms"], **mb, library_ms=None,
                     device_ms=meas_t["device_ms"],
                     parent_in_turns=parent_runs("k17_measure", "stages")))

    # K18 at -P 3 on both groups' pre-emphasised rows, and odd cases.
    def k18_args(src, a):
        work = k16(src, 0)[0]
        lags = exact.ltp_lags(work, a["n"], a["bps"], a["fft_size"])
        period, coefs, _ = exact.ltp_analyze(lags, 3)
        return (work, coefs, period, 3)

    main18, tail18 = k18_args(main_src, args), k18_args(tail_src, tail_args)
    e = max(check(torch, "K18 (main group)", ltp_predict, ltp_predict_plain,
                  main18),
            check(torch, "K18 (tail group)", ltp_predict, ltp_predict_plain,
                  tail18))
    for what, *a in k18_cases(np):
        ta = tuple(torch.from_numpy(x).to(dev) for x in a[:3]) + (a[3],)
        e = max(e, check(torch, f"K18 ({what})", ltp_predict,
                         ltp_predict_plain, ta))
    main_t = stage_timed(torch, lambda: ltp_predict(*main18),
                         lambda: ltp_predict_plain(*main18))
    tail_t = stage_timed(torch, lambda: ltp_predict(*tail18),
                         lambda: ltp_predict_plain(*tail18))
    b = k18_bound(main18)
    on = int((main18[2] > 0).sum())
    print(f"phase 16 K18 ltp_predict at V={V} n={n} order 3 ({on} rows "
          f"with a period): bit-equal (also the tail group and 4 odd "
          f"cases: n 333 and 4096, orders 1 and 3, periods 8 and 262, "
          f"the delay past n, int32 extremes), kernel {main_t['ms']:.4f} "
          f"ms, device time {main_t['device_ms']:.4f} ms, plain "
          f"{main_t['plain_ms']:.2f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}; operations {b['ops_ms']:.4f} ms); tail: "
          f"kernel {tail_t['ms']:.4f} ms, device time "
          f"{tail_t['device_ms']:.4f} ms [{card}]")
    recs.append(dict(name="ltp_predict", route="cuda",
                     source="srla_tpu_torch/kernels/csrc/ltp_predict.cu",
                     replaces="srla_tpu/kernels/exact.py:1128",
                     max_abs_err=e, ms=main_t["ms"],
                     plain_ms=main_t["plain_ms"], **b, library_ms=None,
                     tail_ms=tail_t["ms"], device_ms=main_t["device_ms"],
                     tail_device_ms=tail_t["device_ms"]))

    # K5's row entry on the chosen rows of both groups, and odd rows.
    def rows_args(c, s, k):
        return (c["residual"], c["code_type"], c["porder"], c["ks"], k["n"],
                s["starts"], s["lens_w"], k["B"] * 2 * k["W"], s["rows"])

    tail_sel = select.select_blocks(tail_small,
                                    rice_risky=tail_core["rice_risky"],
                                    **tail_kw)
    main5, tail5 = rows_args(core, out, kw), rows_args(tail_core, tail_sel,
                                                       tail_kw)
    e = max(k5_rows_check(torch, "at the main group", main5, W),
            k5_rows_check(torch, "at the tail group", tail5, tail_W))
    for V5, n5, p5 in ((12, 334, 1), (40, 512, 9)):
        a5, image = k5_rows_case(torch, np, dev, V5, n5, p5, V5 + n5)
        e = max(e, k5_rows_check(torch, f"at {V5} rows x {n5}", a5, image))

    def packed(a, image):
        return lambda: pack_residual_sections(*a[:8], section_words=image,
                                              rows=a[8])

    def gathered(a, image):
        res, ct, po, ks, nn, st, lw, cap, rows = a
        return lambda: pack_residual_sections(
            zigzag32(res)[rows], ct[rows], po[rows], ks[rows], nn, st, lw,
            cap, section_words=image)

    main_t = stage_timed(torch, packed(main5, W),
                         lambda: pack_residual_sections_plain(
                             *main5[:8], rows=main5[8]), reps=10)
    tail_t = stage_timed(torch, packed(tail5, tail_W),
                         lambda: pack_residual_sections_plain(
                             *tail5[:8], rows=tail5[8]))
    before = cuda_ms(torch, gathered(main5, W), 10)
    b = k5_rows_bound(main5)
    print(f"phase 16 K5's row entry on the main group's {main5[8].numel()} "
          f"chosen rows of {main5[0].shape[0]} x {n}: bit-equal to its "
          f"plain version and to the gathered entry (also the tail group, "
          f"12 rows x 334 (rows not 16-byte aligned) and 40 x 512 at "
          f"porders 0..9), kernel {main_t['ms']:.4f} ms, device time "
          f"{main_t['device_ms']:.4f} ms, plain {main_t['plain_ms']:.2f} "
          f"ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}); before "
          f"(zigzag32 of every row, the gather, the gathered entry) "
          f"{before:.4f} ms; tail: kernel {tail_t['ms']:.4f} ms, device "
          f"time {tail_t['device_ms']:.4f} ms [{card}]")
    rows_entry = dict(max_abs_err=e, ms=main_t["ms"],
                      device_ms=main_t["device_ms"],
                      plain_ms=main_t["plain_ms"], tail_ms=tail_t["ms"],
                      tail_device_ms=tail_t["device_ms"],
                      bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                      gathered_before_ms=before)
    return recs, rows_entry


# Phase 18: the hybrid encode's paths (path, -V) and the card kernels each
# card chunk launches, by wrapper name and by CUDA function name.
HYBRID_PATHS = (("music120_V0", 0), ("music120_V1", 1))
HYBRID_KERNELS = (("preemphasis", "preemphasis_kernel"),
                  ("autocorr", "autocorr_kernel"),
                  ("lpc_analyze", "lpc_analyze_kernel"),
                  ("fir_predict", "fir_predict_kernel"),
                  ("rice_search", "rice_search_rows"),
                  ("select_blocks", "select_kernel"),
                  ("pack_residual_sections", "pack_sections_kernel"))


def hybrid_workers() -> list:
    """The host thread counts phase 18 runs: 0 (no hybrid: every group on
    the card), 1, 4 and one a core but the caller's."""
    import os
    return sorted({0, 1, 4, max(1, len(os.sched_getaffinity(0)) - 1)})


def hybrid_encoder(param, dev, workers: int, approx: bool = False):
    """A hybrid encoder whose encode calls are recorded: ``chunks`` (each
    call's blocks) and host-clock seconds in the launch and the finish
    half (``seconds``)."""
    from srla_tpu_torch import SRLAEncoder
    enc = SRLAEncoder(param, dev, approx=approx,
                      host_workers=max(1, workers), hybrid=workers > 0)
    enc.chunks, enc.seconds = [], {"launch": 0.0, "finish": 0.0}
    launch, finish = enc._launch_group, enc._finish_group

    def launched(pcm, files, spans, idxs, size, *a):
        t0 = time.perf_counter()
        enc.chunks.append(len(idxs))
        out = launch(pcm, files, spans, idxs, size, *a)
        enc.seconds["launch"] += time.perf_counter() - t0
        return out

    def finished(*a):
        t0 = time.perf_counter()
        out = finish(*a)
        enc.seconds["finish"] += time.perf_counter() - t0
        return out

    enc._launch_group, enc._finish_group = launched, finished
    return enc


def hybrid_run(torch, np, dev, pcm, param, workers: int, approx: bool = False
               ) -> tuple:
    """One counted hybrid encode under torch.profiler (a warm-up step
    first), each step from unknown rates, as a fresh encoder: (stream,
    launches, stats, the encode calls' blocks, the CUDA kernels by
    name)."""
    enc = hybrid_encoder(param, dev, workers, approx)
    out = {}

    def run():
        for k, v in enc.stats.items():
            if isinstance(v, int):
                enc.stats[k] = 0
        enc._rates.update(dev=None, host=None)
        enc.chunks.clear()
        out["data"], out["launches"] = counted(
            torch, all_wrappers(), lambda: without_plain(
                lambda: enc.encode_whole(pcm)))

    split = profile_kernels(torch, run, runs=1)
    return (out["data"], out["launches"], dict(enc.stats), list(enc.chunks),
            {name: n for name, _us, n in split})


def hybrid_best(torch, dev, pcm, param, workers: int,
                kept: bool = False) -> tuple:
    """Warm best of 3 of a hybrid encode, on a fresh encoder each run or
    (kept) on one encoder warmed once, whose rates carry over: (seconds,
    that run's seconds in the launch and finish halves, its stats, its
    encode calls' blocks)."""
    best = None
    warm = hybrid_encoder(param, dev, workers)
    if kept:
        warm.encode_whole(pcm)
    for _ in range(3):
        enc = warm if kept else hybrid_encoder(param, dev, workers)
        for k, v in enc.stats.items():
            if isinstance(v, int):
                enc.stats[k] = 0
        enc.chunks.clear()
        enc.seconds.update(launch=0.0, finish=0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc.encode_whole(pcm)
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        if best is None or took < best[0]:
            best = (took, dict(enc.seconds), dict(enc.stats),
                    list(enc.chunks))
    return best


def phase_hybrid(torch, np, dev, pcm, stream: bytes, pcm4, stream4,
                 card: str) -> dict:
    """Phase 18: the work-stealing hybrid encode and the host decode. The
    120 s file at -V 0 and at the CLI's defaults (-V 1) with no hybrid
    ("threads 0") and with 1, 4 and a thread a core but one host threads
    (hybrid_workers): each stream equal to the device-only one (phases 6
    and 8 hold that one to the host exact stream); device_blocks +
    repaired_blocks + w_overflow_blocks + stolen_blocks == the device-size
    COMPRESS blocks (the device-only count); the host stole blocks on the
    counted run, which starts from unknown rates; the card
    launched K16, K8, K7, K3, K4, K17 and K5 on its share (counted, and by
    name under torch.profiler), each once an encode call (a card chunk, or
    a group the hybrid does not split) and, but K17's encode entry and K5,
    once a -V measurement call; no plain version reached. Prints the card
    and host blocks, the card chunks and the warm best of 3 on fresh
    encoders (with that run's host-clock seconds in the launch and the
    finish halves); at k >= 1 also the warm best of 3 on one encoder whose
    rates carry over, the StepTimer steps of one run and
    host_encoder.encode with k
    threads alone (best of 3 at -V 0, one warm run at -V 1). The
    approximate hybrid once at -V 0: lossless, within 1.02 of the exact
    stream. The host decode (host_decoder.decode, the native whole-stream
    decode) of phase 3's and phase 4's streams: the card's decode's PCM and
    the source, timed beside decode_whole. Returns {path: {run:
    launches}}."""
    from srla_tpu_torch import SRLADecoder, decode
    from srla_tpu_torch import host_decoder, host_encoder
    from srla_tpu_torch.encoder import StepTimer

    t_phase = time.perf_counter()
    got: dict = {}
    counts = hybrid_workers()
    for path, V in HYBRID_PATHS:
        param = main_param() if V == 0 else variable_param(V)
        got[path] = {}
        base = None
        for w in counts:
            data, launches, s, chunks, names = hybrid_run(
                torch, np, dev, pcm, param, w)
            got[path][f"w{w}"] = launches
            card_blocks = (s["device_blocks"] + s["repaired_blocks"]
                           + s["w_overflow_blocks"])
            if base is None:
                base = data, card_blocks, s["host_blocks"]
                if V == 0:
                    require(data == stream, "phase 18: the -V 0 stream "
                                            "differs from the host exact "
                                            "stream")
                    require(card_blocks == compress_blocks(stream),
                            f"phase 18 block accounting {s}")
            require(data == base[0], f"phase 18 {path} threads {w}: "
                                     f"the stream differs from the "
                                     f"device-only one")
            require(card_blocks + s["stolen_blocks"] == base[1],
                    f"phase 18 {path} threads {w}: routing {s}, "
                    f"{base[1]} device-size COMPRESS blocks")
            require(s["host_blocks"] == base[2] + s["stolen_blocks"],
                    f"phase 18 {path} threads {w}: host_blocks {s}")
            require((s["stolen_blocks"] > 0) == (w > 0),
                    f"phase 18 {path} threads {w}: stolen "
                    f"{s['stolen_blocks']}")
            # Each encode call launches each kernel once (one device): K17's
            # encode entry and K5 once a call, the others once more a -V
            # measurement call (counted by K17's measurement entry).
            per_kernel = {k: launches[k] for k, _ in HYBRID_KERNELS}
            want = {k: len(chunks) + (0 if k in ("select_blocks",
                                                 "pack_residual_sections")
                                      else launches["measure_blocks"])
                    for k in per_kernel}
            require(per_kernel == want and len(chunks) > 0,
                    f"phase 18 {path} threads {w}: card launches "
                    f"{per_kernel}, {len(chunks)} encode calls {chunks}")
            missing = [fn for _, fn in HYBRID_KERNELS
                       if not any(fn in nm for nm in names)]
            require(not missing, f"phase 18 {path} threads {w}: "
                                 f"torch.profiler saw none of {missing}")
            best, halves, bs, bchunks = hybrid_best(torch, dev, pcm, param,
                                                    w)
            text = (f"phase 18 hybrid {path} threads {w}: "
                    f"byte-identical to the device-only stream, card "
                    f"{s['device_blocks']} (repaired "
                    f"{s['repaired_blocks']}, overflow "
                    f"{s['w_overflow_blocks']}) / stolen "
                    f"{s['stolen_blocks']} of {base[1]} device-size COMPRESS "
                    f"blocks, card launches {per_kernel} (encode calls of "
                    f"{chunks} blocks); warm best of 3 {best * 1e3:.1f} ms = "
                    f"{MAIN_SECONDS / best:.1f}x realtime (that run: card "
                    f"{bs['device_blocks'] + bs['repaired_blocks']} / stolen "
                    f"{bs['stolen_blocks']} blocks, encode calls of "
                    f"{bchunks} blocks, launch halves "
                    f"{halves['launch'] * 1e3:.1f} ms, finish halves "
                    f"{halves['finish'] * 1e3:.1f} ms)")
            if w:
                kbest, khalves, ks, kchunks = hybrid_best(
                    torch, dev, pcm, param, w, kept=True)
                text += (f"; rates kept, warm best of 3 {kbest * 1e3:.1f} ms "
                         f"= {MAIN_SECONDS / kbest:.1f}x realtime (that run: "
                         f"stolen {ks['stolen_blocks']} blocks, encode calls "
                         f"of {kchunks} blocks, launch halves "
                         f"{khalves['launch'] * 1e3:.1f} ms, finish halves "
                         f"{khalves['finish'] * 1e3:.1f} ms)")
                # The hybrid's steps (StepTimer: synchronised at each step;
                # "hybrid: host threads" is the wait for the host threads
                # once the card has taken its last chunk).
                enc = hybrid_encoder(param, dev, w)
                enc.timer = StepTimer(dev)
                enc.encode_whole(pcm)
                steps = enc.timer.seconds
                text += ("; steps (host clock, synchronised per step, ms): "
                         + ", ".join(f"{k} {v * 1e3:.2f}"
                                     for k, v in steps.items())
                         + f", total {sum(steps.values()) * 1e3:.2f}")
                # host_encoder alone: best of 3 at -V 0, one warm run at
                # -V 1 (seconds a run; its span measurement is serial).
                host_best = best_of(torch, lambda: host_encoder.SRLAEncoder(
                    param, workers=w).encode_whole(pcm), 3 if V == 0 else 1)
                text += (f"; host_encoder alone, threads {w}, "
                         f"{'best of 3' if V == 0 else 'one warm run'}: "
                         f"{host_best * 1e3:.1f} ms = "
                         f"{MAIN_SECONDS / host_best:.1f}x realtime")
            print(text + f" [{card}]")

    # The approximate hybrid: the card's blocks f32, the stolen ones exact.
    w = counts[-1]
    data, launches, s, chunks, _ = hybrid_run(torch, np, dev, pcm,
                                              main_param(), w, approx=True)
    got["music120_V0_approx"] = {f"w{w}": launches}
    _, out = host_decoder.decode(data)
    require(np.array_equal(out, pcm), "phase 18: the approximate hybrid "
                                      "stream is not lossless")
    require(s["stolen_blocks"] > 0, f"phase 18 approximate: stolen {s}")
    ratio = len(data) / len(stream)
    require(ratio <= 1.02, f"phase 18 approximate hybrid: {ratio:.5f} of "
                           f"the exact size")
    print(f"phase 18 approximate hybrid music120_V0 threads {w}: "
          f"lossless, {len(data)} bytes = {ratio:.5f} of the exact stream, "
          f"card {s['device_blocks']} / stolen {s['stolen_blocks']} blocks "
          f"(card calls {chunks}) [{card}]")

    # The host decode of phase 3's and phase 4's streams.
    for what, src, data in (("music120_m4", pcm, stream),
                            ("music120_m6_P3", pcm4, stream4)):
        _, host_pcm = host_decoder.decode(data)
        _, card_pcm = decode(data, device=dev)
        require(np.array_equal(host_pcm, card_pcm)
                and np.array_equal(host_pcm, src),
                f"phase 18 host decode of {what}: not the card's PCM")
        host_best = best_of(torch, lambda: host_decoder.decode(data))
        dec = SRLADecoder(dev)
        card_best = best_of(torch, lambda: dec.decode_whole(data))
        seconds = src.shape[1] / SAMPLE_RATE
        print(f"phase 18 host decode {what} ({seconds:.0f} s): equal to the "
              f"card's decode and the source; warm best of 3 host_decoder."
              f"decode {host_best * 1e3:.1f} ms = "
              f"{seconds / host_best:.1f}x realtime, decode_whole on the "
              f"card {card_best * 1e3:.1f} ms = {seconds / card_best:.1f}x "
              f"realtime (phase {time.perf_counter() - t_phase:.1f} s) "
              f"[{card}]")
    return got


def main(argv) -> int:
    parent = None
    if argv:
        if len(argv) != 2 or argv[0] != "--parent":
            print("usage: python3 chip_smoke.py [--parent DIR]",
                  file=sys.stderr)
            return 2
        parent = argv[1]
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 1
    try:
        import numpy as np

        from srla_tpu_torch import SRLADecoder, decode, parallel
        from srla_tpu_torch.host_encoder import encode
        from srla_tpu_torch.kernels import build
        from srla_tpu_torch.signals import make_music
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 1

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    build.load_all(LIBRARIES + PROBES)
    print("kernel build (concurrent nvcc, s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in build.build_seconds.items()))

    if parent is not None:
        # K7's quantization entry and the generic pack in the parent and
        # here, each checkout its own process, in turns; phases 5 and 12
        # print them beside their own times.
        from srla_tpu_torch.tools import kernel_ab
        runs = kernel_ab.run([parent, ".", ".", parent])
        for r in runs:
            require("error" not in r, f"kernel_ab in {r['root']}: "
                                      f"{r.get('error')}")
        for key in ("lpc_quantize_sha256", "pack_sha256"):
            require(len({r[key] for r in runs}) == 1,
                    f"the parent's and this checkout's outputs differ "
                    f"({key})")
        for r, label in zip(runs, ("parent", "change", "change", "parent")):
            r["root"] = label
        PARENT_AB["runs"] = runs
        print("in turns: " + json.dumps(runs))
        # K16 and K17 (both entries) on phase 16's main group, in turns;
        # phase 16 prints them beside its own times.
        stages = kernel_ab.run([parent, ".", ".", parent], kernel_ab.STAGES)
        for r in stages:
            require("error" not in r, f"kernel_ab --stages in {r['root']}: "
                                      f"{r.get('error')}")
        for key in [k for k in stages[0] if k.endswith("_sha256")]:
            require(len({r[key] for r in stages}) == 1,
                    f"the parent's and this checkout's outputs differ "
                    f"({key})")
        for r, label in zip(stages, ("parent", "change", "change",
                                     "parent")):
            r["root"] = label
        PARENT_AB["stages"] = stages
        print("in turns (--stages): " + json.dumps(stages))

    k1_record, k1_err = phase_lpc(torch, np, dev)
    records = [k1_record]

    pcm = make_music(MAIN_SECONDS)
    t0 = time.perf_counter()
    stream = encode(pcm, 16, SAMPLE_RATE, preset=4)
    print(f"phase 3 host exact encode -m 4 -B 4096 -V 0: {len(stream)} "
          f"bytes in {time.perf_counter() - t0:.2f} s (the port's native "
          f"library built on first use)")
    records.append(phase_rice(torch, dev, stream))
    # Phase 17: K19 and K1's coefficient entry on the stream's groups.
    k19_record, k1c_record = phase_synth_tail(torch, np, dev, stream, card)
    k1c_record["max_abs_err"] = max(k1c_record["max_abs_err"], k1_err)
    records += [k19_record, k1c_record]

    # Phase 3: the main path, counted.
    dec = SRLADecoder(dev)
    (_, out), main_dec = counted(torch, all_wrappers(),
                            lambda: dec.decode_whole(stream))
    # K1's record counts the kernel's launches by both entries.
    launches = {"lpc_synth": (main_dec["lpc_synth"]
                              + main_dec["lpc_synth_coefs"]),
                "lpc_synth_coefs": main_dec["lpc_synth_coefs"],
                "synth_tail": main_dec["synth_tail"],
                "rice_decode": main_dec["rice_decode"]}
    require(np.array_equal(out, pcm), "120 s decode is not lossless")
    ncomp = compress_blocks(stream)
    require(dec.stats == {"device_blocks": ncomp, "host_blocks": 0},
            f"block routing {dec.stats}, expected {ncomp} on the device")
    ngroups = len(dec.plan(stream)[2])
    require(main_dec["rice_decode"] == ngroups,
            f"decode launches {main_dec}")
    decode_launches_ok(main_dec, ngroups, 0, tail_groups(stream, ngroups),
                       "phase 3 decode")
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode(stream, device=dev)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    print(f"phase 3 decode {MAIN_SECONDS:.0f} s stereo: lossless, "
          f"{ncomp} COMPRESS blocks on the device, launches {launches}; "
          f"warm best of 3 {best * 1e3:.1f} ms = "
          f"{MAIN_SECONDS / best:.1f}x realtime [{card}]")
    profile_decode(torch, lambda: decode(stream, device=dev),
                   "phase 3 decode profile")

    # Phase 4: high orders and long-term prediction, decode (K9).
    ltp_dec_got, k9_err, pcm4, stream4 = phase_ltp_decode(torch, np, dev,
                                                          card)

    records += phase_encode_kernels(torch, np, dev, pcm)
    # Phase 16 (K16, K17, K18, K5's row entry) runs here, before the
    # encodes that launch them.
    stage_recs, k5_rows = phase_encode_stages(torch, np, dev, pcm, card)
    records += stage_recs
    launches.update(phase_encode(torch, np, dev, pcm, stream, card))
    k6_records, k6_launches = phase_bitfield(torch, np, dev)
    records += k6_records
    launches.update(k6_launches)
    var_launches, var_errs, generic, tallies, v3_case = phase_variable(
        torch, np, dev, pcm, card)
    ltp_launches, ltp_records, ltp_tallies = phase_ltp_encode(
        torch, np, dev, pcm, card)
    records += ltp_records
    tallies.update(ltp_tallies)
    shape_launches, k9_shape_err, k10_shape_err = phase_ltp_shapes(
        torch, np, dev, card, tallies)
    ltp_launches.update(shape_launches)
    records += phase_analysis(torch, np, dev, pcm, card, tallies)
    svr_launches, svr_recs, k7_svr = phase_svr(torch, np, dev, pcm, card)
    records += svr_recs
    # K11's, K12's and K7's SVR entries' path is phase 12's full-width
    # encode; K12's first design is a measurement aid, counted there too.
    for name in ("svr_cov", "svr_refine", "lpc_coefs", "lpc_quantize",
                 "svr_refine_v1"):
        launches[name] = svr_launches["music120_m4_svr2"]["encode"][name]
    corpus_launches, hires, hires_streams = phase_corpus(
        torch, np, dev, pcm, stream, pcm4, stream4, card)
    # Phase 14: the decode to device-resident PCM (K13); its main path is
    # phase 3's stream.
    k13_record, resident_launches = phase_resident(torch, np, dev, [
        ("music120_m4", pcm, stream), ("music120_m6_P3", pcm4, stream4),
        ("segmented30_V3", *v3_case),
        ("hires96k_24bit_B8192_fused", np.concatenate(hires, axis=1),
         parallel.fused_stream(hires_streams))], card)
    records.append(k13_record)
    launches["verify"] = resident_launches["music120_m4"]["resident"][
        "verify"]
    ltp_launches["music120_m6_P3"] = {"decode": ltp_dec_got}
    # K9's path is phase 4's decode, K10's the -V 0 -P 3 encode.
    launches["ltp_synth"] = ltp_dec_got["ltp_synth"]
    launches["ltp_analyze"] = ltp_launches["music120_V0_P3"]["encode"][
        "ltp_analyze"]
    # K16's and K17's encode entry's path is phase 6's encode (counted
    # there); K17's measurement entry's the CLI's -V 1 encode of phase 8,
    # K18's the -V 0 -P 3 encode of phase 9.
    launches["measure_blocks"] = var_launches["music120_V1"]["encode"][
        "measure_blocks"]
    launches["ltp_predict"] = ltp_launches["music120_V0_P3"]["encode"][
        "ltp_predict"]
    var_errs["ltp_synth"] = max(k9_err, k9_shape_err)
    var_errs["ltp_analyze"] = k10_shape_err
    # Phase 15: the f32 approximate encode; K14's and K15's path is its
    # -V 0 encode of phase 3's file.
    approx_recs, approx_launches = phase_approx(torch, np, dev, pcm, stream,
                                                card)
    records += approx_recs
    # K16's f32 entry's path is the same -V 0 encode.
    for name in ("lpc_analyze_f32", "rice_cost", "preemphasis_f32"):
        launches[name] = approx_launches["music120_V0_approx"]["encode"][
            name]

    # Phase 18: the hybrid encode and the host decode.
    hybrid_launches = phase_hybrid(torch, np, dev, pcm, stream, pcm4,
                                   stream4, card)

    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "srla_tpu", "bench"))
    require(not foreign, f"imported outside the port: {foreign[:5]}")
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        # Phase 8: each -V path's launches, its encode and its decode apart.
        rec["launches_variable"] = {
            path: {run: got.get(rec["name"], 0) for run, got in runs.items()}
            for path, runs in var_launches.items()}
        # Phases 4 and 9: each -P path's launches.
        rec["launches_ltp"] = {
            path: {run: got.get(rec["name"], 0) for run, got in runs.items()}
            for path, runs in ltp_launches.items()}
        # Phase 12: each SVR path's launches.
        rec["launches_svr"] = {
            path: {run: runs[run].get(rec["name"], 0)
                   for run in ("encode", "decode")}
            for path, runs in svr_launches.items()}
        # Phase 13: each corpus and block path's launches, by run.
        rec["launches_corpus"] = {
            path: {run: got.get(rec["name"], 0) for run, got in runs.items()}
            for path, runs in corpus_launches.items()}
        # Phase 14: each resident decode's launches, by run.
        rec["launches_resident"] = {
            path: {run: got.get(rec["name"], 0) for run, got in runs.items()}
            for path, runs in resident_launches.items()}
        # Phase 15: each approximate encode's launches.
        rec["launches_approx"] = {
            path: {run: got.get(rec["name"], 0) for run, got in runs.items()}
            for path, runs in approx_launches.items()}
        # Phase 18: each hybrid encode's launches, by host thread count.
        rec["launches_hybrid"] = {
            path: {run: got.get(rec["name"], 0) for run, got in runs.items()}
            for path, runs in hybrid_launches.items()}
        rec["max_abs_err"] = max(rec["max_abs_err"],
                                 var_errs.get(rec["name"], 0))
        if rec["name"] == "rice_search":
            rec["generic_3072"] = generic
        if rec["name"] == "lpc_synth":
            # The decode launches K1 through its coefficient entry.
            rec["launches_by_entry"] = {
                "lpc_scan": main_dec["lpc_synth"],
                "lpc_scan_coefs": main_dec["lpc_synth_coefs"]}
        if rec["name"] == "pack_residual_sections":
            # The encode runs the row entry (phase 16); phase 5's figures
            # are the entry on gathered rows, kept beside them.
            keys = ("ms", "device_ms", "plain_ms", "tail_ms",
                    "tail_device_ms", "bound_ms", "bound_by")
            rec["gathered"] = {k: rec[k] for k in keys}
            rec.update({k: k5_rows[k] for k in keys})
            rec["gathered_before_ms"] = k5_rows["gathered_before_ms"]
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     k5_rows["max_abs_err"])
        if rec["name"] == "lpc_analyze":
            # K7's SVR entries: their launches on phase 12's full-width
            # encode and the coefficient entry against its plain version.
            full = svr_launches["music120_m4_svr2"]["encode"]
            rec["launches_lpc_coefs"] = full["lpc_coefs"]
            rec["launches_lpc_quantize"] = full["lpc_quantize"]
            rec["lpc_coefs_vs_plain"] = k7_svr
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
