"""K7's quantization entry and K5's generic pack in several checkouts side
by side, and the quantization entry's two layouts.

    python -m srla_tpu_torch.tools.kernel_ab ROOT [ROOT ...]
    python -m srla_tpu_torch.tools.kernel_ab --layouts

Needs one CUDA card. For each checkout ROOT, in the order given, a fresh
Python process in that directory builds the kernels with that checkout's
``srla_tpu_torch`` and makes, with its ``chip_smoke.py``, the inputs that
``chip_smoke.py`` times each kernel on: the generic pack (``pack``) on the
codeword stream of 120 s of ``make_music``'s main group (2582 chosen rows
x 5122 slots, int64; phase 5), and the quantization entry
(``lpc_quantize``) on the 5164 rows x 64 that K12 refines in the main
call of the ``-m 4 -B 4096 -V 0 --svr 2`` encode (phase 12). It prints one
JSON line a ROOT: the device time of each call (a CUDA graph of 20 calls,
replayed), its CUDA-event time, the generic pack's ``torch.profiler``
split by kernel, SHA-256 prefixes of both outputs, and the card's name and
power limit. Give a parent and a change in turns (parent, change, change,
parent). ``chip_smoke.py --parent DIR`` prints these beside its own.

``--layouts`` times the quantization entry of this checkout (eight lanes
a row, ``kQuantLanes = 8``, K7's fused layout) beside a copy of
``csrc/lpc_analyze.cu`` built with a lane a row (``kQuantLanes = 1``), in
turns on the same inputs in one process, after checking that both give the
same outputs there and on ``chip_smoke.k7_quantize_batch`` at M 64 and
255.
"""

from __future__ import annotations

import json
import subprocess
import sys

_INPUTS = r'''
import hashlib, json, os, subprocess, sys
sys.path.insert(0, os.getcwd())
import numpy as np, torch
import chip_smoke as cs
from srla_tpu_torch import SRLAEncoder
from srla_tpu_torch.constants import LPC_RIDGE_REGULARIZATION_PARAMETER
from srla_tpu_torch.host_encoder import _compute_offset_lshift
from srla_tpu_torch.kernels import build, exact
from srla_tpu_torch.kernels.bitpack import pack
from srla_tpu_torch.kernels.levinson import lpc_quantize
from srla_tpu_torch.kernels.svr import svr_cov, svr_refine
from srla_tpu_torch.signals import make_music
build.load_all(("autocorr", "lpc_analyze", "fir_predict", "rice_search",
                "bitpack", "svr_cov", "svr_refine"))
dev = torch.device("cuda")
music = make_music(cs.MAIN_SECONDS)
blocks, B, args, W = cs.main_group(torch, np, dev, music)
small, big, core = exact.variant_analysis(blocks, 0, **args)
sel, _ = cs.section_args(torch, small, big, core, B, args["n"], W, args)
k5 = (*exact.chosen_stream(big, sel, args["n"]), B * 2 * W)
enc = SRLAEncoder(cs.svr_param(4, 4096, 0, 0), dev)
file = enc._upload(music)[enc.device]
offs = list(range(0, B * 4096, 4096))
work, orders, coefs, kappa, a = cs.svr_inputs(
    torch, enc, file, _compute_offset_lshift(music), offs, 4096, "kernel_ab",
    cs.new_k7_coefs_tally())
ridge = LPC_RIDGE_REGULARIZATION_PARAMETER
cov = svr_cov(work, orders, 4096, a["bps"], a["max_params"], ridge)
ref = svr_refine(work, cov, coefs, orders, 4096, a["bps"], a["svr_iter"],
                 a["margins"], ridge, kappa)
k7 = (ref[0], orders, kappa, ref[1])
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip()


def digest(out):
    if isinstance(out, torch.Tensor):
        out = (out,)
    h = hashlib.sha256()
    for t in out:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]
'''

_CHILD = _INPUTS + r'''
from torch.profiler import ProfilerActivity, profile, schedule
with profile(activities=[ProfilerActivity.CUDA],
             schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
    pack(*k5)
    torch.cuda.synchronize()
    prof.step()
    for _ in range(3):
        pack(*k5)
    torch.cuda.synchronize()
    prof.step()
split = {}
for e in prof.events():
    if e.device_type == torch.autograd.DeviceType.CUDA:
        name = e.name.replace("(anonymous namespace)::", "").replace(
            "void ", "").split("(")[0][:60]
        split[name] = split.get(name, 0.0) + e.time_range.elapsed_us() / 3
print(json.dumps({
    "root": os.getcwd(), "rows": [k7[0].shape[0], k5[0].shape[0]],
    "slots": k5[0].numel(), "words": k5[3],
    "lpc_quantize_device_ms": cs.device_ms(torch, lambda: lpc_quantize(*k7),
                                           20),
    "lpc_quantize_ms": cs.cuda_ms(torch, lambda: lpc_quantize(*k7), 20),
    "pack_device_ms": cs.device_ms(torch, lambda: pack(*k5), 10),
    "pack_ms": cs.cuda_ms(torch, lambda: pack(*k5), 10),
    "pack_profile_us": split,
    "lpc_quantize_sha256": digest(lpc_quantize(*k7)),
    "pack_sha256": digest(pack(*k5)), "card": card}))
'''

_LAYOUTS = _INPUTS + r'''
import ctypes, re
src = os.path.join(build.SRC_DIR, "lpc_analyze.cu")
text = open(src).read()
text, n = re.subn(r"constexpr int kQuantLanes = 8;",
                  "constexpr int kQuantLanes = 1;", text)
assert n == 1, "lpc_analyze.cu: kQuantLanes = 8 not found"
os.makedirs(build.BUILD_DIR, exist_ok=True)
copy = os.path.join(build.BUILD_DIR, "lpc_analyze_lane_a_row.cu")
lib = os.path.join(build.BUILD_DIR, "liblpc_analyze_lane_a_row.so")
open(copy, "w").write(text)
subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib, copy],
               check=True)
fn = ctypes.CDLL(lib).srla_lpc_quantize
fn.restype = ctypes.c_int
fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def lane_a_row(c, o, k, e):
    V, M = c.shape
    out = (torch.empty(V, dtype=torch.int32, device=dev),
           torch.empty((V, M), dtype=torch.int32, device=dev),
           torch.empty(V, dtype=torch.bool, device=dev))
    err = fn(c.data_ptr(), o.data_ptr(), k.data_ptr(), e.data_ptr(),
             *(t.data_ptr() for t in out), V, M, 8, 16,
             torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"a lane a row: launch failed ({err})"
    return out


cases = [k7] + [tuple(torch.from_numpy(x).to(dev) for x in
                      cs.k7_quantize_batch(np, cs.K7Q_BATCH_ROWS, M, M))
                for M in (64, 255)]
for case in cases:
    for g, w in zip(lane_a_row(*case), lpc_quantize(*case)):
        assert torch.equal(g, w), "the two layouts differ"
(one_a, one_b), (eight_a, eight_b) = cs.in_turns(
    torch, lambda: lane_a_row(*k7), lambda: lpc_quantize(*k7), 20)
print(json.dumps({"rows": k7[0].shape[0], "M": k7[0].shape[1],
                  "lane_a_row_ms": [one_a, one_b],
                  "eight_lanes_a_row_ms": [eight_a, eight_b],
                  "order": "lane, eight, eight, lane (device time)",
                  "card": card}))
'''


def run(roots) -> list:
    """One child process a checkout, in the order given: its JSON record
    (or {"root": ROOT, "error": ...})."""
    out = []
    for root in roots:
        p = subprocess.run([sys.executable, "-c", _CHILD], cwd=root,
                           capture_output=True, text=True)
        lines = p.stdout.strip().splitlines()
        if p.returncode != 0 or not lines:
            out.append({"root": root, "error": p.stderr[-2000:]})
            continue
        rec = json.loads(lines[-1])
        rec["root"] = root
        out.append(rec)
    return out


def main(argv) -> int:
    if argv == ["--layouts"]:
        p = subprocess.run([sys.executable, "-c", _LAYOUTS],
                           capture_output=True, text=True)
        print(p.stdout.strip().splitlines()[-1] if p.returncode == 0
              else p.stderr[-2000:])
        return p.returncode
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    recs = run(argv)
    for rec in recs:
        print(json.dumps(rec))
    return 1 if any("error" in r for r in recs) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
