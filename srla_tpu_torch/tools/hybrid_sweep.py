"""The hybrid encode's split threshold and host chunk, measured on the card.

    python -m srla_tpu_torch.tools.hybrid_sweep [--out FILE]

Needs one CUDA card. Builds the encode's kernels, then encodes
``make_music`` (16-bit stereo, 44.1 kHz, -m 4 -B 4096 -V 0) of 20, 40, 80
and 120 s, whose COMPRESS groups hold 215, 430, 861 and 1291 blocks of 4096
(a shorter one's group fits in the card's first chunk of 128). For each
length: the device-only encode (``hybrid=False``), and
``SRLAEncoder(..., hybrid=True, host_workers=k)`` for k = 1, 4 and a thread
a core but one, with ``HYBRID_HOST_CHUNK`` 32, 64 and 128 (and
``HYBRID_MIN_BLOCKS`` lowered to the chunk, so that every length's group
is split). Each hybrid runs two ways: "fresh", a new encoder each encode,
whose host takes its first chunk before a rate is known; and "kept", one
encoder warmed once, whose rates carry over. Each time is the warm best of
3 (host clock, the card synchronised before and after). Then the 120 s file
at the CLI's defaults (-V 1) the same way at the chunk of 64, and the 120 s
file at -V 0 with ``sys.setswitchinterval(0.0005)`` around the encodes (the
interpreter's default is 0.005 s): how long a thread waits for the GIL.
Every stream is checked equal to the device-only one.

Prints one JSON object a line: the card's name and power limit, then each
case's length, -V, route, threads, chunk, way, best seconds, x realtime,
the device-only best beside it, stolen blocks and the card's encode calls
(blocks each) of the best run. ``--out FILE`` also writes the lines there.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SECONDS = (20.0, 40.0, 80.0, 120.0)
CHUNKS = (32, 64, 128)
RATE = 44100
LIBRARIES = ("fir_predict", "rice_search", "bitpack", "autocorr",
             "lpc_analyze", "preemphasis", "select")


def thread_counts() -> list:
    return sorted({1, 4, max(1, len(os.sched_getaffinity(0)) - 1)})


def main(argv) -> int:
    out_path = None
    if argv:
        if len(argv) != 2 or argv[0] != "--out":
            print(__doc__, file=sys.stderr)
            return 2
        out_path = argv[1]
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("hybrid_sweep: no CUDA device", file=sys.stderr)
        return 1
    from srla_tpu_torch import SRLAEncoder
    from srla_tpu_torch.host_encoder import make_parameter
    from srla_tpu_torch.kernels import build
    from srla_tpu_torch.signals import make_music

    build.load_all(LIBRARIES)
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    lines = []

    def emit(rec: dict) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        lines.append(line)

    emit({"card": card, "threads": thread_counts()})
    music = make_music(max(SECONDS))

    def encoder(param, k: int, chunk: int):
        if not k:
            return SRLAEncoder(param, dev)
        enc = SRLAEncoder(param, dev, host_workers=k, hybrid=True)
        enc.HYBRID_HOST_CHUNK = chunk
        enc.HYBRID_MIN_BLOCKS = chunk
        enc.calls = []
        launch = enc._launch_group

        def counted(pcm, files, spans, idxs, *a):
            enc.calls.append(len(idxs))
            return launch(pcm, files, spans, idxs, *a)

        enc._launch_group = counted
        return enc

    def best(make, pcm, want) -> tuple:
        """Warm best of 3 of make().encode_whole(pcm): (seconds, that
        encoder's stats and calls)."""
        top = None
        for _ in range(3):
            enc = make()
            if hasattr(enc, "calls"):
                enc.calls.clear()
            for key in ("stolen_blocks", "device_blocks", "host_blocks"):
                enc.stats[key] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            data = enc.encode_whole(pcm)
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
            if data != want:
                raise SystemExit("hybrid_sweep: a stream differs from the "
                                 "device-only encode's")
            if top is None or took < top[0]:
                top = (took, dict(enc.stats), list(getattr(enc, "calls",
                                                           [])))
        return top

    def cases(seconds: float, V: int, chunks, label: str = "") -> None:
        pcm = np.ascontiguousarray(music[:, :int(seconds * RATE)])
        param = make_parameter(2, 16, RATE, 4, 4096, V, 4, 0, 0)
        want = SRLAEncoder(param, dev).encode_whole(pcm)
        alone = best(lambda: SRLAEncoder(param, dev), pcm, want)[0]
        base = {"seconds": seconds, "V": V}
        if label:
            base["switch_interval"] = sys.getswitchinterval()
        emit({**base, "route": "device", "best_s": alone,
              "x_realtime": seconds / alone})
        for k in thread_counts():
            for chunk in chunks:
                kept = encoder(param, k, chunk)
                kept.encode_whole(pcm)
                for way, make in (("fresh", lambda: encoder(param, k, chunk)),
                                  ("kept", lambda: kept)):
                    took, stats, calls = best(make, pcm, want)
                    emit({**base, "route": "hybrid", "threads": k,
                          "chunk": chunk, "way": way, "best_s": took,
                          "x_realtime": seconds / took,
                          "device_best_s": alone,
                          "stolen": stats["stolen_blocks"],
                          "card_calls": calls})

    for seconds in SECONDS:
        cases(seconds, 0, CHUNKS)
    cases(max(SECONDS), 1, (64,))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(0.0005)
    try:
        cases(max(SECONDS), 0, (64,), label="switch")
    finally:
        sys.setswitchinterval(interval)
    if out_path:
        with open(out_path, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
