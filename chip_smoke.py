#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's device decode and encode once on one
NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Builds the five CUDA kernels from csrc/ (concurrent nvcc), then:

  1. K1 (LPC synthesis, csrc/lpc_synth.cu) against its plain PyTorch version
     on the card at the main-path shape (2584 rows x 4096 samples, 64 taps)
     and at 256 taps (264 rows, orders 200..256: the kernel's shared memory
     goes past the 48 KiB default), with edge rows, with and without fused
     de-emphasis: bit-equal.
  2. K2 (Rice entropy decode, csrc/rice_decode.cu) against its plain version
     on every block group of the phase-3 stream: bit-equal.
  3. 120 s of stereo 16-bit 44.1 kHz music-like audio, encoded on the host
     at -m 4 -B 4096 -V 0 (srla_tpu exact encoder), decoded with
     srla_tpu_torch.decode(..., device="cuda"): lossless, every COMPRESS
     block on the device, both kernels launched by that decode.
  4. A 10 s -m 6 -P 3 stream (long-term prediction; the encoder picks LPC
     orders up to 93 on this signal) decoded on the card: lossless.
  5. K3 (FIR residual, csrc/fir_predict.cu), K4 (Rice partition sums,
     csrc/rice_search.cu) and K5 (bit pack, csrc/bitpack.cu) against their
     plain versions on the card, on the inputs the main path's 1291-block
     group of 4096 samples gives them: bit-equal, CUDA-event times.
  6. The same 120 s encoded by srla_tpu_torch.SRLAEncoder(device="cuda")
     at -m 4 -B 4096 -V 0: byte-identical to phase 3's host exact stream,
     every COMPRESS block emitted from the device or a counted host repair
     or overflow, K3, K4 and K5 launched by that encode, and the stream
     decoded losslessly by the port. Prints the warm best-of-3 encode speed
     and a per-step breakdown.

Prints the card's name and power limit, the build time, the warm decode and
encode speeds (x realtime) and each kernel's time beside its plain
version's, then one JSON line describing the kernels and, last, the device
JSON line. Any failed check raises and the exit code is non-zero; without a
CUDA device it exits non-zero before printing any result. Imports nothing
of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SAMPLE_RATE = 44100
MAIN_SECONDS = 120.0
LTP_SECONDS = 10.0


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


def max_abs_err(torch, got, want) -> int:
    return int((got.long() - want.long()).abs().max().item())


def compress_blocks(stream: bytes) -> int:
    """COMPRESS blocks in a stream, counted from its block headers."""
    from srla_tpu.constants import HEADER_SIZE, BlockDataType
    from srla_tpu.format import decode_header, parse_block_header
    header = decode_header(stream)
    offset, progress, count = HEADER_SIZE, 0, 0
    while progress < header.num_samples and offset < len(stream):
        btype, nsamples, poff, psize = parse_block_header(stream, offset)
        count += btype == BlockDataType.COMPRESS
        offset = poff + psize
        progress += nsamples
    return count


def lpc_inputs(torch, np, dev, R: int, n: int, M: int, min_order: int,
               seed: int):
    """K1 arguments on the card: rows of order min_order..M plus edge rows
    (order 0, rshift 0, order M, int32-wrapping residuals and taps)."""
    from srla_tpu_torch.kernels.decode2 import align_coefs

    rng = np.random.RandomState(seed)
    res = rng.randint(-30000, 30000, (R, n))
    orders = rng.randint(min_order, M + 1, R)
    coefs = rng.randint(-(1 << 15), 1 << 15, (R, M))
    rshifts = rng.randint(1, 16, R)
    orders[0] = 0                         # order 0 passes residuals through
    rshifts[1] = 0                        # rshift 0: half = INT_MIN
    orders[2] = M                         # full-order row
    res[3:5] = rng.randint(-(1 << 30), 1 << 30, (2, n))   # int32 wrapping
    coefs[3:5] = rng.randint(-(1 << 30), 1 << 30, (2, M))
    dcoef = rng.randint(0, 16, R)
    dprev = rng.randint(-30000, 30000, R)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    ord_t = t(orders)
    args = (t(res), align_coefs(t(coefs), ord_t, M), ord_t, t(rshifts), n, M)
    return args, dict(dcoef=t(dcoef), dprev=t(dprev))


def phase_lpc(torch, np, dev):
    """K1 against its plain version at 256 taps (orders 200..256, more than
    48 KiB of shared memory) and at the main-path shape, with and without
    fused de-emphasis; times the main-path shape. Returns the kernel's JSON
    record without its launch count."""
    from srla_tpu_torch.kernels.lpc import lpc_scan, lpc_scan_plain

    err = 0
    for R, n, M, min_order in ((264, 4096, 256, 200), (2584, 4096, 64, 1)):
        args, fused = lpc_inputs(torch, np, dev, R, n, M, min_order, seed=M)
        for kw in ({}, fused):
            got = lpc_scan(*args, **kw)
            want = lpc_scan_plain(*args, **kw)
            torch.cuda.synchronize()
            e = max_abs_err(torch, got, want)
            require(e == 0, f"K1 differs from its plain version at M={M} "
                            f"(fused={bool(kw)}, max abs err {e})")
            err = max(err, e)
        print(f"phase 1 K1 lpc_synth: bit-equal to plain at R={R} n={n} "
              f"M={M}, orders {min_order}..{M}, with and without fused "
              f"de-emphasis")
    # The last shape is the main path's: time it.
    ms = cuda_ms(torch, lambda: lpc_scan(*args, **fused), 20)
    plain_ms = cuda_ms(torch, lambda: lpc_scan_plain(*args, **fused), 1)
    print(f"phase 1 K1 lpc_synth at R={R} n={n} M={M} (+fused de-emphasis): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms")
    return dict(name="lpc_synth", route="cuda",
                source="srla_tpu_torch/kernels/csrc/lpc_synth.cu",
                replaces="srla_tpu/kernels/pallas_lpc.py:102",
                max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_rice(torch, dev, stream: bytes):
    """K2 against its plain version on every block group of ``stream``;
    times both on the largest group."""
    from srla_tpu_torch.decoder import SRLADecoder, upload_stream
    from srla_tpu_torch.kernels.decode2 import meta_cols
    from srla_tpu_torch.kernels.rice_decode import (rice_decode,
                                                    rice_decode_plain)

    header, _, groups = SRLADecoder(dev).plan(stream)
    C = header.num_channels
    words = upload_stream(stream, dev)
    err, timed = 0, None
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
        if timed is None or len(g.starts) > len(timed[0].starts):
            timed = (g, args)
    g, args = timed
    ms = cuda_ms(torch, lambda: rice_decode(*args), 20)
    plain_ms = cuda_ms(torch, lambda: rice_decode_plain(*args), 1)
    print(f"phase 2 K2 rice_decode: bit-equal to plain on {len(groups)} "
          f"groups; at B={len(g.starts)} C={C} n={g.n}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.2f} ms")
    return dict(name="rice_decode", route="cuda",
                source="srla_tpu_torch/kernels/csrc/rice_decode.cu",
                replaces="srla_tpu/kernels/decode2.py:218",
                max_abs_err=err, ms=ms, plain_ms=plain_ms)


KERNELS = ("lpc_synth", "rice_decode", "fir_predict", "rice_search",
           "bitpack")


def main_param():
    """-m 4 -B 4096 -V 0 for 16-bit stereo at 44.1 kHz."""
    from srla_tpu.encoder import EncodeParameter
    return EncodeParameter(num_channels=2, bits_per_sample=16,
                           sampling_rate=SAMPLE_RATE, preset=4,
                           min_num_samples_per_block=4096)


def main_group(torch, np, dev, pcm):
    """The main path's 1291-block group of 4096 samples on the card, with
    the encoder's device arguments and section bound W for it."""
    from srla_tpu_torch import SRLAEncoder
    n = 4096
    B = pcm.shape[1] // n
    blocks = np.ascontiguousarray(
        pcm[:, :B * n].reshape(2, B, n).transpose(1, 0, 2), np.int16)
    enc = SRLAEncoder(main_param(), dev)
    return (torch.from_numpy(blocks).to(dev), B, enc._host._device_args(n),
            enc._section_words(n))


def compare(torch, name, kernel, plain, args, reps: int = 20):
    """Kernel against its plain version on the same inputs: bit-equal, and
    both timed with CUDA events. Returns (max_abs_err, ms, plain_ms)."""
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    e = max_abs_err(torch, got, want)
    require(e == 0, f"{name} differs from its plain version "
                    f"(max abs err {e})")
    ms = cuda_ms(torch, lambda: kernel(*args), reps)
    plain_ms = cuda_ms(torch, lambda: plain(*args), 2)
    return e, ms, plain_ms


def phase_encode_kernels(torch, np, dev, pcm):
    """K3, K4 and K5 against their plain versions at the main path's
    shapes: the analysis of the 1291-block group gives K3 and K4 their
    inputs, its selection gives K5 the chosen rows' codeword stream."""
    from srla_tpu_torch.kernels import exact
    from srla_tpu_torch.kernels.bitpack import pack, pack_plain
    from srla_tpu_torch.kernels.lpc import wrap32
    from srla_tpu_torch.kernels.predict import predict, predict_plain
    from srla_tpu_torch.kernels.rice_search import (rice_sums,
                                                    rice_sums_plain)

    blocks, B, args, W = main_group(torch, np, dev, pcm)
    n = args["n"]
    small, big, core = exact.variant_analysis(blocks, 0, **args)
    V = core["work"].shape[0]
    recs = []
    k3 = (core["work"], core["coefs"], core["orders"], core["rshifts"])
    e, ms, pms = compare(torch, "K3", predict, predict_plain, k3)
    print(f"phase 5 K3 fir_predict at V={V} n={n} M={k3[1].shape[1]}: "
          f"bit-equal, kernel {ms:.4f} ms, plain {pms:.2f} ms")
    recs.append(dict(name="fir_predict", route="cuda",
                     source="srla_tpu_torch/kernels/csrc/fir_predict.cu",
                     replaces="srla_tpu/kernels/encode.py:180",
                     max_abs_err=e, ms=ms, plain_ms=pms))
    u, ks, rec, _, _ = exact.rice_params(core["residual"], n,
                                         args["max_porder"])
    k4 = (wrap32(u).to(torch.int32), ks.to(torch.int32).contiguous(),
          rec.to(torch.int32), n, args["max_porder"])
    e, ms, pms = compare(torch, "K4", rice_sums, rice_sums_plain, k4)
    print(f"phase 5 K4 rice_search at V={V} n={n} porders "
          f"0..{args['max_porder']}: bit-equal, kernel {ms:.4f} ms, "
          f"plain {pms:.2f} ms")
    recs.append(dict(name="rice_search", route="cuda",
                     source="srla_tpu_torch/kernels/csrc/rice_search.cu",
                     replaces="srla_tpu/kernels/exact.py:454",
                     max_abs_err=e, ms=ms, plain_ms=pms))
    sel = exact.select_rows(small, B=B, C=2, n=n, bps=16, W=W,
                            max_params=args["max_params"])
    offs, tails, tbits = exact.chosen_stream(big, sel, n)
    k5 = (offs, tails, tbits, B * 2 * W)
    e, ms, pms = compare(torch, "K5", pack, pack_plain, k5)
    print(f"phase 5 K5 bitpack of {offs.shape[0]} rows x {offs.shape[1]} "
          f"slots into {B * 2 * W} words: bit-equal, kernel {ms:.4f} ms, "
          f"plain {pms:.2f} ms")
    recs.append(dict(name="bitpack", route="cuda",
                     source="srla_tpu_torch/kernels/csrc/bitpack.cu",
                     replaces="srla_tpu/kernels/pallas_pack.py:79",
                     max_abs_err=e, ms=ms, plain_ms=pms))
    return recs


def phase_encode(torch, np, dev, pcm, stream: bytes, card: str):
    """The port's encode of the main path: bytes, block accounting, kernel
    launches, the port's own decode, then speed and a step breakdown.
    Returns the launch counts of K3, K4 and K5 in that encode."""
    from srla_tpu_torch import SRLAEncoder, decode
    from srla_tpu_torch.encoder import StepTimer
    from srla_tpu_torch.kernels.bitpack import pack
    from srla_tpu_torch.kernels.predict import predict
    from srla_tpu_torch.kernels.rice_search import rice_sums

    param = main_param()
    predict.launches = rice_sums.launches = pack.launches = 0
    torch.cuda.reset_peak_memory_stats()
    enc = SRLAEncoder(param, dev)
    data = enc.encode_whole(pcm)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {"fir_predict": predict.launches,
                "rice_search": rice_sums.launches,
                "bitpack": pack.launches}
    require(data == stream, "port encode differs from the host exact "
                            "stream")
    ncomp = compress_blocks(stream)
    s = enc.stats
    handled = (s["device_blocks"] + s["repaired_blocks"]
               + s["w_overflow_blocks"])
    require(handled == ncomp, f"block accounting {s}: {handled} of "
                              f"{ncomp} COMPRESS blocks")
    for name, count in launches.items():
        require(count > 0, f"{name} was not launched by the encode")
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
    return launches


def main() -> int:
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

        from bench import make_music
        from srla_tpu import encode
        from srla_tpu_torch import SRLADecoder, decode
        from srla_tpu_torch.kernels import build
        from srla_tpu_torch.kernels.lpc import lpc_scan
        from srla_tpu_torch.kernels.rice_decode import rice_decode
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

    build.load_all(KERNELS)
    print("kernel build (concurrent nvcc, s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in build.build_seconds.items()))

    records = [phase_lpc(torch, np, dev)]

    pcm = make_music(MAIN_SECONDS)
    t0 = time.perf_counter()
    stream = encode(pcm, 16, SAMPLE_RATE, preset=4, backend="exact")
    print(f"phase 3 host encode -m 4 -B 4096 -V 0: {len(stream)} bytes in "
          f"{time.perf_counter() - t0:.2f} s")
    records.append(phase_rice(torch, dev, stream))

    # Phase 3: the main path, counted.
    lpc_scan.launches = 0
    rice_decode.launches = 0
    dec = SRLADecoder(dev)
    _, out = dec.decode_whole(stream)
    torch.cuda.synchronize()
    launches = {"lpc_synth": lpc_scan.launches,
                "rice_decode": rice_decode.launches}
    require(np.array_equal(out, pcm), "120 s decode is not lossless")
    ncomp = compress_blocks(stream)
    require(dec.stats == {"device_blocks": ncomp, "host_blocks": 0},
            f"block routing {dec.stats}, expected {ncomp} on the device")
    for name, count in launches.items():
        require(count > 0, f"{name} was not launched by the decode")
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

    # Phase 4: high orders and long-term prediction.
    pcm4 = make_music(LTP_SECONDS)
    stream4 = encode(pcm4, 16, SAMPLE_RATE, preset=6, ltp_order=3,
                     backend="exact")
    _, _, groups4 = SRLADecoder(dev).plan(stream4)
    require(any(g.has_ltp for g in groups4), "-P 3 stream uses no LTP")
    _, out4 = decode(stream4, device=dev)
    require(np.array_equal(out4, pcm4), "-m 6 -P 3 decode is not lossless")
    print(f"phase 4 decode -m 6 -P 3 {LTP_SECONDS:.0f} s: lossless, max "
          f"order {max(g.M for g in groups4)}, LTP on")

    records += phase_encode_kernels(torch, np, dev, pcm)
    launches.update(phase_encode(torch, np, dev, pcm, stream, card))

    require("jax" not in sys.modules, "jax was imported")
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
