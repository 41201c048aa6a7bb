"""Two measurements of K12 (``kernels/csrc/svr_refine.cu``) that
``chip_smoke.py`` does not make: where a row's time goes, and what the SVR
encode does end to end in two checkouts side by side.

    python -m srla_tpu_torch.tools.k12_probe phases
    python -m srla_tpu_torch.tools.k12_probe encode ROOT [ROOT ...]

Both need one CUDA card and run on the 120 s ``make_music`` encode at
``-m 4 -B 4096 -V 0 --svr 2``.

``phases`` builds a copy of ``csrc/svr_refine.cu`` with ``clock64`` stamps
at its phase boundaries (thread 0's clock, just after each barrier that
ends a phase, summed over the rows), runs it on the encode's main analysis
call (its 5164 rows of 4096), holds its outputs equal to K12's, and prints
the SM clocks a row spends in each phase beside the device time of the
stamped and the plain build in turns (old, new, new, old: what the stamps
cost). The stamps are inserted at fixed lines of the source: when the
kernel changes, the tool stops with the line it could not find.

``encode`` runs, for each checkout ROOT in the order given, a fresh Python
process in that directory that encodes the file once cold and three times
warm with that checkout's ``srla_tpu_torch``, then once more with its
``StepTimer``. It prints a line a ROOT: the stream's length and SHA-256
prefix, the repaired blocks, the three warm times, the host repair's, K12's
and the whole encode's ``StepTimer`` ms. Give a parent and a change in
turns (parent, change, change, parent): host times swing between processes.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

SECONDS = 120.0
STAMPS = ("stage the factor", "cholesky",
          "bounds, C^-1 diagonal, stage the row", "tiles it 0",
          "decide it 0", "tiles it 1", "decide it 1", "tiles it 2+",
          "decide it 2+", "replay", "write out")
_HEAD = '''
__device__ unsigned long long g_k12_clk[16];
extern "C" int k12_clk_read(void* out) {
    return (int)cudaMemcpyFromSymbol(out, g_k12_clk, sizeof(g_k12_clk));
}
extern "C" int k12_clk_zero() {
    unsigned long long z[16] = {0};
    return (int)cudaMemcpyToSymbol(g_k12_clk, z, sizeof(z));
}
#define STAMP(k) if (tid == 0) { const long long t_ = clock64(); \\
    atomicAdd(&g_k12_clk[(k)], (unsigned long long)(t_ - t_last)); \\
    t_last = t_; }
'''
# (line of the source, the same with its stamp), each found exactly once.
_EDITS = (
    ("#include <math_constants.h>\n",
     "#include <math_constants.h>\n" + _HEAD),
    ("    const int row = blockIdx.x;\n",
     "    const int row = blockIdx.x;\n    long long t_last = clock64();\n"),
    ("    __syncthreads();\n\n    // 1. Cholesky",
     "    __syncthreads();\n    STAMP(0)\n\n    // 1. Cholesky"),
    ("    if (o == 0 || s_flag) {\n",
     "    STAMP(1)\n    if (o == 0 || s_flag) {\n"),
    ("    __syncthreads();\n    const Row<T> d{",
     "    __syncthreads();\n    STAMP(2)\n    const Row<T> d{"),
    ("            __syncthreads();\n"
     "            if (mthread && s_alive[lane]) {\n"
     "                double* cm",
     "            __syncthreads();\n"
     "            STAMP(3 + 2 * (it < 2 ? it : 2))\n"
     "            if (mthread && s_alive[lane]) {\n"
     "                double* cm"),
    ("            __syncthreads();\n        }\n        // 4. The adopt",
     "            __syncthreads();\n"
     "            STAMP(4 + 2 * (it < 2 ? it : 2))\n"
     "        }\n        // 4. The adopt"),
    ("    // 5. The adopted vector.\n",
     "    STAMP(9)\n    // 5. The adopted vector.\n"),
    ("        iters_out[row] = s_iters;\n    }\n}\n",
     "        iters_out[row] = s_iters;\n    }\n    STAMP(10)\n"
     "    if (tid == 0) atomicAdd(&g_k12_clk[15], 1ull);\n}\n"),
)


def stamped_source(src: str) -> str:
    """``csrc/svr_refine.cu`` with the phase stamps."""
    for old, new in _EDITS:
        if src.count(old) != 1:
            raise SystemExit(f"k12_probe: the kernel source no longer has "
                             f"this line once: {old.splitlines()[0]!r}")
        src = src.replace(old, new)
    return src


def _build_stamped():
    """Compile the stamped copy into the build directory and load it."""
    import ctypes

    from srla_tpu_torch.kernels import build
    with open(os.path.join(build.SRC_DIR, "svr_refine.cu")) as f:
        src = stamped_source(f.read())
    out = os.path.join(build.BUILD_DIR, "k12_probe")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "svr_refine.cu"), os.path.join(out, "lib.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS,
                    *build.EXTRA_FLAGS["svr_refine"], "-o", so, cu],
                   check=True)
    return ctypes.CDLL(so)


def _device_ms(torch, fn, reps: int = 3) -> float:
    """ms a call, reps calls captured into one CUDA graph, replayed 5
    times (as chip_smoke.device_ms)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 5 / reps


def main_call_inputs(torch, dev, seconds: float = SECONDS):
    """K12's arguments at the encode's main call: the pre-emphasised rows
    of the whole blocks of 4096 (1291 at 120 s), four variants each, K7's
    orders, coefficients and kappa' on their K8 lags, K11's covariance."""
    from srla_tpu_torch import SRLAEncoder
    from srla_tpu_torch.constants import LPC_RIDGE_REGULARIZATION_PARAMETER
    from srla_tpu_torch.host_encoder import (_compute_offset_lshift,
                                             make_parameter)
    from srla_tpu_torch.kernels import exact
    from srla_tpu_torch.kernels.autocorr import autocorr
    from srla_tpu_torch.kernels.levinson import lpc_coefs
    from srla_tpu_torch.kernels.svr import svr_cov
    from srla_tpu_torch.signals import make_music
    ridge = LPC_RIDGE_REGULARIZATION_PARAMETER
    pcm = make_music(seconds)
    enc = SRLAEncoder(make_parameter(2, 16, 44100, 4, 4096, 0, 4, 0, 2),
                      dev)
    n = 4096
    a = enc._host._device_args(n)
    offs = list(range(0, pcm.shape[1] - n + 1, n))
    file = enc._upload(pcm)[enc.device]
    rows = exact.variant_stack(exact.cut_spans(file, offs, n),
                               _compute_offset_lshift(pcm))
    work, _, _ = exact.preemphasis_exact(rows)
    M = a["max_params"]
    ac = autocorr(work, n, a["bps"], M + 1, a["fft_size"])
    ac[:, 0] = ac[:, 0] * (1.0 + ridge)
    orders, coefs, kappa, _ = lpc_coefs(ac, n, a["bps"], M, a["max_fixed"])
    cov = svr_cov(work, orders, n, a["bps"], M, ridge)
    return (work, cov, coefs, orders, n, a["bps"], a["svr_iter"],
            a["margins"], ridge, kappa)


def phases() -> int:
    import ctypes

    import torch

    from srla_tpu_torch.kernels import build
    from srla_tpu_torch.kernels.svr import svr_refine
    if not torch.cuda.is_available():
        print("k12_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    args = main_call_inputs(torch, dev)
    want = svr_refine(*args)
    plain_lib = build.load("svr_refine")
    stamped = _build_stamped()

    def with_lib(lib):
        def run():
            build._LIBS["svr_refine"] = lib
            try:
                return svr_refine(*args)
            finally:
                build._LIBS["svr_refine"] = plain_lib
        return run

    old, new = with_lib(plain_lib), with_lib(stamped)
    got = new()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        print("k12_probe: the stamped build's outputs differ from K12's",
              file=sys.stderr)
        return 1
    turns = [_device_ms(torch, f) for f in (old, new, new, old)]
    build.check(stamped.k12_clk_zero(), "k12_probe")
    new()
    torch.cuda.synchronize()
    clk = (ctypes.c_ulonglong * 16)()
    build.check(stamped.k12_clk_read(ctypes.byref(clk)), "k12_probe")
    V = args[0].shape[0]
    split = {name: round(clk[i] / V) for i, name in enumerate(STAMPS)}
    total = sum(clk[i] for i in range(len(STAMPS)))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    props = torch.cuda.get_device_properties(0)
    print(f"k12_probe phases: {V} rows x {args[4]}, orders "
          f"{float(args[3].double().mean()):.1f} on average, "
          f"{clk[15]} rows ran to the end; the stamped build's outputs equal "
          f"K12's; device ms in turns (plain, stamped, stamped, plain) "
          f"{[round(t, 4) for t in turns]}; {props.multi_processor_count} "
          f"SMs [{card}]")
    print(f"k12_probe phases: SM clocks a row (thread 0, barrier to "
          f"barrier, averaged over all rows) {split}, total "
          f"{round(total / V)}")
    return 0


_CHILD = r'''
import hashlib, os, sys, time
sys.path.insert(0, os.getcwd())
import torch
from srla_tpu_torch import SRLAEncoder
from srla_tpu_torch.encoder import StepTimer
from srla_tpu_torch.host_encoder import make_parameter
from srla_tpu_torch.signals import make_music
music = make_music(%r)
dev = torch.device("cuda")
param = make_parameter(2, 16, 44100, 4, 4096, 0, 4, 0, 2)
data = SRLAEncoder(param, dev).encode_whole(music)
runs = []
for _ in range(3):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    SRLAEncoder(param, dev).encode_whole(music)
    torch.cuda.synchronize()
    runs.append((time.perf_counter() - t0) * 1e3)
enc = SRLAEncoder(param, dev)
enc.timer = StepTimer(dev)
enc.encode_whole(music)
st = enc.timer.seconds
print("bytes", len(data), "sha256", hashlib.sha256(data).hexdigest()[:16],
      "repaired", enc.stats["repaired_blocks"], "warm ms",
      [round(x, 1) for x in runs], "best", round(min(runs), 1),
      "repair ms", round(st["repair (host)"] * 1e3, 1), "K12 ms",
      round(st["K12 svr_refine"] * 1e3, 2), "total ms",
      round(sum(st.values()) * 1e3, 1))
'''


def encode(roots) -> int:
    rc = 0
    for root in roots:
        p = subprocess.run([sys.executable, "-c", _CHILD % SECONDS],
                           cwd=root, capture_output=True, text=True)
        line = p.stdout.strip().splitlines()[-1:] or [p.stderr[-500:]]
        print(f"k12_probe encode {root}: {line[0]}")
        rc |= p.returncode
    return 1 if rc else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("phases")
    e = sub.add_parser("encode")
    e.add_argument("roots", nargs="+")
    args = ap.parse_args()
    return phases() if args.cmd == "phases" else encode(args.roots)


if __name__ == "__main__":
    sys.exit(main())
