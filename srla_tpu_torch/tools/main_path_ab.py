"""The main path's encode and decode in several checkouts side by side.

    python -m srla_tpu_torch.tools.main_path_ab ROOT [ROOT ...]

Needs one CUDA card. For each checkout ROOT, in the order given, a fresh
Python process in that directory builds the main path's kernels with that
checkout's ``srla_tpu_torch``, encodes 120 s of ``make_music`` (16-bit
stereo, 44.1 kHz) at ``-m 4 -B 4096 -V 0`` once cold and three times warm,
then decodes the stream once cold, checks it lossless, and decodes it three
times warm, then encodes it at the CLI's defaults (``-V 1 -L 4``) once
cold and three times warm: ``chip_smoke.py`` phases 6, 3 and 8 without
their checks; last, one encode under the encoder's ``StepTimer`` (a device
synchronise at each step) at each of ``-V 0``, ``-V 1``, ``-V 0 -P 3`` and
``-V 1 -P 3``. It prints five lines a ROOT: the streams' lengths and
SHA-256 prefixes, the warm times and the best of each as x realtime, with
the card's name and power limit; then each timed encode's steps. Give a
parent and a change in turns (parent, change, change, parent): host times
swing between processes. Each checkout builds the kernels of its own
``csrc/`` that ``LIBRARIES`` names.
"""

from __future__ import annotations

import subprocess
import sys

SECONDS = 120.0
# The kernels that the encodes and the decode launch (those a checkout
# has: an older one lacks the later stages' sources).
LIBRARIES = ("lpc_synth", "rice_decode", "fir_predict", "rice_search",
             "bitpack", "autocorr", "lpc_analyze", "ltp_analyze",
             "preemphasis", "select", "ltp_predict", "synth_tail")

_CHILD = r'''
import hashlib, os, subprocess, sys, time
sys.path.insert(0, os.getcwd())
import numpy as np, torch
from srla_tpu_torch import SRLAEncoder, decode
from srla_tpu_torch.encoder import StepTimer
from srla_tpu_torch.host_encoder import make_parameter
from srla_tpu_torch.kernels import build
from srla_tpu_torch.signals import make_music
build.load_all([k for k in %r if os.path.exists(
    os.path.join(build.SRC_DIR, k + ".cu"))])
seconds = %r
music = make_music(seconds)
dev = torch.device("cuda")
param = make_parameter(2, 16, 44100, 4, 4096, 0, 4, 0, 0)
param1 = make_parameter(2, 16, 44100, 4, 4096, 1, 4, 0, 0)


def warm(fn):
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    return runs


data = SRLAEncoder(param, dev).encode_whole(music)
enc = warm(lambda: SRLAEncoder(param, dev).encode_whole(music))
assert np.array_equal(decode(data, device=dev)[1], music), "not lossless"
dec = warm(lambda: decode(data, device=dev))
data1 = SRLAEncoder(param1, dev).encode_whole(music)
enc1 = warm(lambda: SRLAEncoder(param1, dev).encode_whole(music))
steps = {}
for what, V, P in (("-V 0", 0, 0), ("-V 1", 1, 0), ("-V 0 -P 3", 0, 3),
                   ("-V 1 -P 3", 1, 3)):
    timed = SRLAEncoder(make_parameter(2, 16, 44100, 4, 4096, V, 4, P, 0),
                        dev)
    timed.timer = StepTimer(dev)
    timed.encode_whole(music)
    steps[what] = timed.timer.seconds
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip()
print("bytes", len(data), "sha256", hashlib.sha256(data).hexdigest()[:16],
      "encode warm ms", [round(t * 1e3, 1) for t in enc], "best",
      round(seconds / min(enc), 1), "x realtime; decode warm ms",
      [round(t * 1e3, 1) for t in dec], "best",
      round(seconds / min(dec), 1), "x realtime; -V 1 bytes", len(data1),
      "sha256", hashlib.sha256(data1).hexdigest()[:16], "encode warm ms",
      [round(t * 1e3, 1) for t in enc1], "best",
      round(seconds / min(enc1), 1), "x realtime [" + card + "]")
for what, secs in steps.items():
    print(what, "encode steps (ms):", ", ".join(
        f"{k} {v * 1e3:.2f}" for k, v in secs.items()))
'''


def main(roots) -> int:
    rc = 0
    for root in roots:
        p = subprocess.run([sys.executable, "-c",
                            _CHILD % (LIBRARIES, SECONDS)],
                           cwd=root, capture_output=True, text=True)
        lines = p.stdout.strip().splitlines()[-5:] or [p.stderr[-500:]]
        for line in lines:
            print(f"main_path_ab {root}: {line}")
        rc |= p.returncode
    return 1 if rc else 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
