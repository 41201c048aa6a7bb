#!/usr/bin/env python3
"""Pull-model streaming SRLA player on a PyTorch device.

    python -m srla_tpu_torch.tools.srla_player in.srl --sink null --device cuda

The port's twin of ``tools/srla_player.py``, the counterpart of the
reference player (parity: tools/srla_player/srla_player.c:31-150): the
decoder is pulled block by block from a callback-style loop, holding only
one decoded block of PCM at a time, so playback starts immediately and
memory stays O(block). Each COMPRESS block is decoded on ``--device``
(default cuda; cpu runs the kernels' plain versions).

The reference ships three OS audio backends (PulseAudio/CoreAudio/WASAPI);
here the sink is pluggable and headless-friendly:

  --sink auto   sounddevice/pyaudio if importable, else raw stdout
  --sink raw    interleaved little-endian PCM on stdout (pipe to aplay etc.)
  --sink wav    write a WAV file via --out (streaming, no full-file buffer)
  --sink null   decode at full speed and report throughput (benchmark)
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..streaming import StreamingDecoder


def _interleave(block: np.ndarray, bps: int) -> bytes:
    """(C, n) int32 -> interleaved little-endian bytes at the stream depth."""
    inter = block.T.astype(np.int32)
    if bps == 8:
        return ((inter + 128) & 0xFF).astype(np.uint8).tobytes()
    if bps == 16:
        return inter.astype("<i2").tobytes()
    # 24-bit: pack the low three bytes of each sample.
    b = inter.astype("<i4").view(np.uint8).reshape(-1, 4)
    return np.ascontiguousarray(b[:, :3]).tobytes()


def _open_audio(rate: int, channels: int):
    """Best-effort audio device (absent in headless environments)."""
    try:
        import sounddevice  # type: ignore

        stream = sounddevice.RawOutputStream(
            samplerate=rate, channels=channels, dtype="int16")
        stream.start()
        return stream
    except Exception:
        return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="srla-player", description="Streaming SRLA (.srl) player")
    p.add_argument("input", help=".srl file")
    p.add_argument("--sink", choices=["auto", "raw", "wav", "null"],
                   default="auto")
    p.add_argument("--out", help="Output path (sink=wav)")
    p.add_argument("--realtime", action="store_true",
                   help="Pace decoding at 1x playback speed")
    p.add_argument("--no-checksum-check", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device that decodes (default: cuda; cpu runs "
                        "the kernels' plain versions)")
    args = p.parse_args(argv)

    with open(args.input, "rb") as f:
        data = f.read()
    dec = StreamingDecoder(data, args.device,
                           check_checksum=not args.no_checksum_check)
    hdr = dec.header

    audio = None
    out = None
    if args.sink == "auto":
        audio = _open_audio(hdr.sampling_rate, hdr.num_channels)
        if audio is None:
            args.sink = "raw"
    if args.sink == "wav":
        if not args.out:
            p.error("--sink wav requires --out")
        out = open(args.out, "wb")
        data_bytes = (hdr.num_samples * hdr.num_channels
                      * (hdr.bits_per_sample // 8))
        out.write(_wav_header(hdr, data_bytes))
    elif args.sink == "raw":
        out = sys.stdout.buffer

    t0 = time.time()
    played = 0
    for block in dec.blocks():
        pcm = _interleave(block, hdr.bits_per_sample)
        if audio is not None:
            audio.write(pcm)
        elif args.sink != "null":
            out.write(pcm)
        played += block.shape[1]
        if args.realtime:
            ahead = played / hdr.sampling_rate - (time.time() - t0)
            if ahead > 0.05:
                time.sleep(ahead - 0.02)
    dt = time.time() - t0
    dur = played / hdr.sampling_rate
    print(f"played {played} samples ({dur:.2f}s) in {dt:.2f}s "
          f"({dur / max(dt, 1e-9):.1f}x realtime)", file=sys.stderr)
    if args.sink == "wav":
        out.close()
    if audio is not None:
        audio.stop()
        audio.close()
    return 0


def _wav_header(hdr, data_bytes: int) -> bytes:
    import struct
    ba = hdr.bits_per_sample // 8
    return (b"RIFF" + struct.pack("<I", 36 + data_bytes) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, hdr.num_channels,
                          hdr.sampling_rate,
                          hdr.sampling_rate * hdr.num_channels * ba,
                          hdr.num_channels * ba, hdr.bits_per_sample)
            + b"data" + struct.pack("<I", data_bytes))


if __name__ == "__main__":
    sys.exit(main())
