"""Probe the f64 tensor cores that K8 (``kernels/csrc/autocorr.cu``) sums on.

    python -m srla_tpu_torch.tools.dmma_probe        # one CUDA card

Runs ``kernels/csrc/dmma_probe.cu`` and prints, for ``mma.sync`` ``f64`` at
the shapes m8n8k4 and m16n8k4:

- which order a DMMA keeps inside: on random A, B and C of wide range,
  how many entries of D equal each model, computed exactly with
  fractions: ``chain`` (fused multiply-adds in depth order from C, the
  model ``tests/test_torch_autocorr.py:k8_order`` emulates) and ``once``
  (the exact sum rounded once);
- the rate each shape issues at (TFLOP/s, a multiply-add counted as two,
  CUDA events);

then the number of ``DMMA`` instructions in K8's library
(``cuobjdump -sass``). Exits 1 when no CUDA card is present.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
from fractions import Fraction

import numpy as np
import torch

from ..kernels import build

TRIALS = 500


def _lib():
    lib = build.load("dmma_probe")
    lib.srla_dmma_order.restype = ctypes.c_int
    lib.srla_dmma_order.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 \
        + [ctypes.c_int, ctypes.c_void_p]
    lib.srla_dmma_rate.restype = ctypes.c_int
    lib.srla_dmma_rate.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    return lib


def _wide(rng, shape):
    """Doubles of both signs over 2^-30 .. 2^3, so roundings show."""
    n = int(np.prod(shape))
    v = rng.uniform(0.5, 1.0, n) * np.where(rng.rand(n) < 0.5, -1.0, 1.0)
    return (v * 2.0 ** rng.randint(-30, 3, n)).reshape(shape)


def order_counts(lib, rows: int, seed: int = 1) -> dict:
    """Entries of D (of TRIALS DMMAs) equal to each order model."""
    rng = np.random.RandomState(seed)
    A = _wide(rng, (TRIALS, rows, 4))
    B = _wide(rng, (TRIALS, 4, 8))
    C = _wide(rng, (TRIALS, rows, 8))
    dA, dB, dC = (torch.from_numpy(x).cuda() for x in (A, B, C))
    dD = torch.empty_like(dC)
    err = lib.srla_dmma_order(rows, dA.data_ptr(), dB.data_ptr(),
                              dC.data_ptr(), dD.data_ptr(), TRIALS,
                              torch.cuda.current_stream().cuda_stream)
    build.check(err, "dmma_probe order")
    D = dD.cpu().numpy()
    counts = {"chain": 0, "once": 0, "entries": 0}
    for t in range(TRIALS):
        for m in range(rows):
            for j in range(8):
                p = [Fraction(A[t, m, k]) * Fraction(B[t, k, j])
                     for k in range(4)]
                got = Fraction(float(D[t, m, j]))
                c = Fraction(C[t, m, j])
                counts["once"] += Fraction(float(c + sum(p))) == got
                acc = c
                for q in p:
                    acc = Fraction(float(acc + q))
                counts["chain"] += acc == got
                counts["entries"] += 1
    return counts


def rate_tflops(lib, rows: int, blocks: int, threads: int = 256,
                iters: int = 2000) -> float:
    out = torch.zeros(1, dtype=torch.float64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    build.check(lib.srla_dmma_rate(rows, blocks, threads, 10,
                                   out.data_ptr(), stream), "dmma_probe")
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    build.check(lib.srla_dmma_rate(rows, blocks, threads, iters,
                                   out.data_ptr(), stream), "dmma_probe")
    stop.record()
    torch.cuda.synchronize()
    flops = blocks * threads // 32 * iters * 8 * rows * 8 * 4 * 2
    return flops / (start.elapsed_time(stop) * 1e-3) / 1e12


def dmma_count() -> int:
    """DMMA instructions in K8's built library (cuobjdump -sass)."""
    build.load("autocorr")
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run(
        [tool, "-sass", os.path.join(build.BUILD_DIR, "libautocorr.so")],
        capture_output=True, text=True, check=True, timeout=300).stdout
    return sum("DMMA" in line for line in sass.splitlines())


def main() -> int:
    if not torch.cuda.is_available():
        print("dmma_probe: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card)
    lib = _lib()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for rows, name in ((8, "m8n8k4"), (16, "m16n8k4")):
        c = order_counts(lib, rows)
        rates = [rate_tflops(lib, rows, sms * k) for k in (4, 8)]
        print(f"{name}.f64: of {c['entries']} entries, {c['chain']} equal "
              f"a chain of fused multiply-adds in depth order, {c['once']} "
              f"the exact sum rounded once; "
              f"{rates[0]:.1f} / {rates[1]:.1f} TFLOP/s at {4 * sms} / "
              f"{8 * sms} CTAs of 8 warps [{card}]")
    print(f"K8 (libautocorr.so): {dmma_count()} DMMA instructions in its "
          f"SASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
