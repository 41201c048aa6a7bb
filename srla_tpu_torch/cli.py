"""srla-compatible command line tool for the PyTorch/CUDA port.

    python -m srla_tpu_torch.cli -e -m 4 -V 0 in.wav out.srl --device cuda
    python -m srla_tpu_torch.cli -d in.srl out.wav --device cuda

Both directions run on --device through the port's kernels (default cuda;
cpu runs the kernels' plain versions). The flags and their defaults are
``srla_tpu.cli``'s, plus --device. The port encodes fixed-size blocks
only, so -e needs -V 0 (srla_tpu's default is -V 1), and it has no -P or SVR
yet: those raise instead of running on the host.
"""

from __future__ import annotations

import argparse
import struct
import sys
import time

import numpy as np

from srla_tpu import cli as host_cli


def build_parser() -> argparse.ArgumentParser:
    p = host_cli.build_parser()
    p.prog = "srla-tpu-torch"
    p.description = ("SRLA lossless audio codec (PyTorch/CUDA port): -e and "
                     "-d run on --device. --backend does not apply.")
    p.add_argument("--device", default="cuda",
                   help="torch device that encodes or decodes (default: "
                        "cuda; cpu runs the kernels' plain versions)")
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

    from srla_tpu.wavio import WavData, read_audio, write_wav

    t0 = time.time()
    if args.encode:
        from srla_tpu.encoder import EncodeParameter

        from .encoder import SRLAEncoder

        if not 0 <= args.mode <= 6:
            print(f"invalid compress mode: {args.mode}", file=sys.stderr)
            return 1
        wav = read_audio(args.input)
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
        try:
            data = SRLAEncoder(param, args.device).encode_whole(
                np.asarray(wav.pcm, dtype=np.int32))
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
