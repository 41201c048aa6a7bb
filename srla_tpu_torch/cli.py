"""srla-compatible command line tool for the PyTorch/CUDA port.

    python -m srla_tpu_torch.cli -e in.wav out.srl --device cuda
    python -m srla_tpu_torch.cli -d in.srl out.wav --device cuda

Both directions run on --device through the port's kernels (default cuda;
cpu runs the kernels' plain versions). The flags and their defaults are
``srla_tpu.cli``'s (``build_parser`` is the port's copy of
``srla_tpu/cli.py:18``), with --device in place of --backend: at the
defaults (-m 4 -B 4096 -V 1 -L 4) -e writes the bytes of
``python -m srla_tpu.cli -e``, and so it does with -P 1 or -P 3 (long-term
prediction) and --svr-filter-learning-iteration N (SVR refinement of the
LPC coefficients), both on --device too. SRLA_TPU_APPROX=1 in the
environment takes srla_tpu's f32 approximate encode (as
``srla_tpu/encoder.py:169``): lossless, within about 2 % of the exact size,
not byte-identical. SRLA_HOST_THREADS=k splits the encode's host batches
(its repairs) over k threads, as srla_tpu's; the bytes are the same. The
work-stealing hybrid is not on the command line: ``SRLAEncoder(...,
hybrid=True)`` in the API.
"""

from __future__ import annotations

import argparse
import os
import struct
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="srla-tpu-torch",
        description="SRLA lossless audio codec (PyTorch/CUDA port): -e and "
                    "-d run on --device.")
    p.add_argument("-e", "--encode", action="store_true", help="Encode mode")
    p.add_argument("-d", "--decode", action="store_true", help="Decode mode")
    p.add_argument("-m", "--mode", type=int, default=4,
                   help="Compress mode: 0(fast), ..., 6(high compression) "
                        "(default: 4)")
    p.add_argument("-B", "--max-block-size", type=int, default=4096,
                   help="Max number of block samples (default: 4096)")
    p.add_argument("-V", "--variable-block-divisions", type=int, default=1,
                   help="Number of variable block-size divisions (default: 1)")
    p.add_argument("-L", "--lookahead-sample-factor", type=int, default=4,
                   help="Lookahead multiplier for variable block division "
                        "(default: 4)")
    p.add_argument("-P", "--long-term-prediction", type=int, default=0,
                   help="Long term (pitch) prediction order (odd, default: 0)")
    p.add_argument("--svr-filter-learning-iteration", type=int, default=0,
                   help="SVR filter learning iterations (default: 0)")
    p.add_argument("--no-checksum-check", action="store_true",
                   help="Skip checksum verification at decode")
    p.add_argument("--device", default="cuda",
                   help="torch device that encodes or decodes (default: "
                        "cuda; cpu runs the kernels' plain versions)")
    p.add_argument("-v", "--version", action="version",
                   version="srla-tpu-torch 0.1")
    p.add_argument("input", help="Input file")
    p.add_argument("output", help="Output file")
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if any(a == "--backend" or a.startswith("--backend=") for a in argv):
        print("--backend does not apply: the port runs on --device.",
              file=sys.stderr)
        return 1
    args = build_parser().parse_args(argv)
    if args.encode == args.decode:
        print("Please specify exactly one of -e (encode) or -d (decode).",
              file=sys.stderr)
        return 1

    from .wavio import WavData, read_audio, write_wav

    t0 = time.time()
    if args.encode:
        from .encoder import SRLAEncoder
        from .host_encoder import EncodeParameter

        if not 0 <= args.mode <= 6:
            print(f"invalid compress mode: {args.mode}", file=sys.stderr)
            return 1
        threads = os.environ.get("SRLA_HOST_THREADS", "1")
        if not threads.strip().isdigit():
            print(f"SRLA_HOST_THREADS must be a whole number of threads, "
                  f"not {threads!r}", file=sys.stderr)
            return 2
        wav = read_audio(args.input)
        total = wav.pcm.shape[1]

        def progress(done, _total=total):
            # Per-block progress meter (parity: the reference CLI's
            # EncodeBlockCallback display, tools/srla_codec/srla_codec.c:66).
            if sys.stderr.isatty():
                pct = min(100.0, 100.0 * done / max(_total, 1))
                print(f"\rprogress: {pct:5.1f} %", end="", file=sys.stderr)
                if done >= _total:
                    print(file=sys.stderr)

        param = EncodeParameter(
            num_channels=wav.pcm.shape[0],
            bits_per_sample=wav.bits_per_sample,
            sampling_rate=wav.sampling_rate, preset=args.mode,
            max_num_samples_per_block=args.max_block_size,
            min_num_samples_per_block=(args.max_block_size
                                       >> args.variable_block_divisions),
            num_lookahead_samples=(args.lookahead_sample_factor
                                   * args.max_block_size),
            ltp_order=args.long_term_prediction,
            num_svr_filter_learning_iteration=(
                args.svr_filter_learning_iteration))
        approx = os.environ.get("SRLA_TPU_APPROX", "") == "1"
        try:
            data = SRLAEncoder(param, args.device, approx=approx,
                               host_workers=int(threads)).encode_whole(
                np.asarray(wav.pcm, dtype=np.int32),
                progress_callback=progress)
        except ValueError as e:
            print(f"encoding error: {e}", file=sys.stderr)
            return 1
        with open(args.output, "wb") as f:
            f.write(data)
        insize = wav.pcm.nbytes // 4 * (wav.bits_per_sample // 8) + 44
        print(f"finished: {insize} -> {len(data)} "
              f"({100.0 * len(data) / insize:6.2f} %) "
              f"[{time.time() - t0:.2f}s]")
        return 0

    from .decoder import SRLADecoder

    with open(args.input, "rb") as f:
        data = f.read()
    try:
        dec = SRLADecoder(args.device,
                          check_checksum=not args.no_checksum_check)
        header, pcm = dec.decode_whole(data)
    except (ValueError, struct.error, IndexError) as e:
        print(f"decoding error: {e}", file=sys.stderr)
        return 1
    write_wav(args.output,
              WavData(pcm, header.sampling_rate, header.bits_per_sample))
    print(f"decoded {pcm.shape[1]} samples x {pcm.shape[0]} ch "
          f"[{time.time() - t0:.2f}s]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
