"""K7's quantization entry and K5's generic pack in several checkouts side
by side, the quantization entry's two layouts, K14 and K15 (the f32
approximate encode's kernels) in several checkouts side by side, and K16
and K17 (the exact encode's pre-emphasis and selection) likewise.

    python -m srla_tpu_torch.tools.kernel_ab ROOT [ROOT ...]
    python -m srla_tpu_torch.tools.kernel_ab --layouts
    python -m srla_tpu_torch.tools.kernel_ab --approx ROOT [ROOT ...]
    python -m srla_tpu_torch.tools.kernel_ab --k15-parts
    python -m srla_tpu_torch.tools.kernel_ab --stages ROOT [ROOT ...]

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

``--approx`` runs, for each ROOT in turn and in a fresh process there,
K14 (``lpc_analyze_f32``) and K15 (``rice_cost``) on the inputs phase 15
of that checkout's ``chip_smoke.py`` times them on (the main group of 120
s of ``make_music`` at ``-m 4``: V 5164, M 64, n 4096, partition orders
0..10; ``approx_kernel_inputs``) and the approximate encodes of that file
at ``-V 0``, ``-V 1 -L 4``, ``-V 0 -P 3`` and ``-m 5``: one JSON line a
ROOT with each kernel's device time (a CUDA graph of 20 calls, replayed)
and CUDA-event time, SHA-256 prefixes of the kernels' outputs and of each
stream, and the card's name and power limit. Then one more line,
``k14_moved``: the rows whose K14 outputs differ between the first two
ROOTs (give the parent first), each with the decision that moved and its
margin, from each ROOT's own plain version (``levinson_f32``: its error
variances and its coefficients at its orders, saved by its process) on
the same lags.

``--stages`` runs, for each ROOT in turn and in a fresh process there,
K16 (``variant_preemphasis``) on the ``Spans`` of the resident file and on
the block tensor, and K17's encode entry (``select_blocks``) and
measurement entry (``measure_blocks``) on the analysis of those spans:
phase 16's main group of that checkout's ``chip_smoke.py`` (120 s of
``make_music``, 1291 blocks of 4096 int16 stereo samples, M 64). Also the
decode's synthesis tail on that stream's main decode group (1291 blocks of
4096, its own methods, seeded full-range int32 rows, lshift 0): K19
(``synth_tail``, in place) where the checkout has it, else the torch ops
its ``synthesize`` ran (``k19_main``); and the approximate analysis'
pre-emphasis on the block tensor: K16's f32 entry
(``variant_preemphasis_f32``) where the checkout has it, else the torch
variant stack and f32 pre-emphasis (``k16f32_blocks``; its outputs'
digest is named ``_digest``, not ``_sha256``: the f32 sums' order moved,
so a coefficient at a rounding boundary may differ). One JSON line a
ROOT: each call's device time (a CUDA graph of 20 calls, replayed) and
CUDA-event time, SHA-256 prefixes of its outputs, and the card's name and
power limit. The ``Spans`` entry uploads the offsets each call, so its
device time is taken only where that upload can be captured (null where it
cannot; its event time always). ``chip_smoke.py --parent DIR`` prints
these in phases 16 and 17.

``--k15-parts`` times where K15's time goes on the same main group: this
checkout's ``csrc/rice_cost.cu`` beside copies built with one part taken
out (the sample terms; the parameters' f32 formulas, replaced by the
mean's integer log2, within about one of the true parameter so that the
shared-parameter terms still apply; the parameter bits; all three), in
turns in one process; the copies' outputs are wrong by design and only
timed. It is a measurement aid tied to the exact source lines it edits
(``TERMS``, ``PARAMS``, ``PBITS`` in ``_K15_PARTS``): it stops with an
error, and times nothing, once one of them is no longer in
``rice_cost.cu``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

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


_APPROX = r'''
import hashlib, json, os, subprocess, sys
sys.path.insert(0, os.getcwd())
import numpy as np, torch
import chip_smoke as cs
from srla_tpu_torch import SRLAEncoder
from srla_tpu_torch.host_encoder import make_parameter
from srla_tpu_torch.kernels import build
from srla_tpu_torch.kernels.lpc_f32 import lpc_analyze_f32
from srla_tpu_torch.kernels.rice_cost import rice_cost
from srla_tpu_torch.signals import make_music
build.load_all(cs.LIBRARIES)
dev = torch.device("cuda")
music = make_music(cs.MAIN_SECONDS)
k14, k15, _ = cs.approx_kernel_inputs(torch, np, dev, music)
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip()


def digest(out):
    h = hashlib.sha256()
    for t in out:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


streams = {}
for path, V, P, preset in (("V0", 0, 0, 4), ("V1_L4", 1, 0, 4),
                           ("V0_P3", 0, 3, 4), ("V0_m5", 0, 0, 5)):
    param = make_parameter(2, 16, cs.SAMPLE_RATE, preset, 4096, V, 4, P, 0)
    data = SRLAEncoder(param, dev, approx=True).encode_whole(music)
    streams[path] = [len(data), hashlib.sha256(data).hexdigest()[:16]]
print(json.dumps({
    "root": os.getcwd(), "k14_rows": k14[0].shape[0], "M": k14[3],
    "k15_rows": k15[0].shape[0], "n": k15[1], "max_porder": k15[2],
    "k14_device_ms": cs.device_ms(torch, lambda: lpc_analyze_f32(*k14), 20),
    "k14_ms": cs.cuda_ms(torch, lambda: lpc_analyze_f32(*k14), 20),
    "k15_device_ms": cs.device_ms(torch, lambda: rice_cost(*k15), 20),
    "k15_ms": cs.cuda_ms(torch, lambda: rice_cost(*k15), 20),
    "k14_sha256": digest(lpc_analyze_f32(*k14)),
    "k15_input_sha256": digest((k15[0],)),
    "k15_sha256": digest(rice_cost(*k15)), "streams": streams,
    "card": card}))
if os.environ.get("KERNEL_AB_SAVE"):
    from srla_tpu_torch.kernels.lpc_f32 import levinson_f32
    o, c, s = lpc_analyze_f32(*k14)
    ev, cf = levinson_f32(k14[0], k14[3], o)
    np.savez(os.environ["KERNEL_AB_SAVE"], ac=k14[0].cpu().numpy(),
             orders=o.cpu().numpy(), coefs=c.cpu().numpy(),
             shifts=s.cpu().numpy(), ev=ev.cpu().numpy(),
             coefs_f=cf.cpu().numpy(), args=np.array(k14[1:4]))
'''


_K15_PARTS = r'''
import ctypes, json, os, subprocess, sys
sys.path.insert(0, os.getcwd())
import numpy as np, torch
import chip_smoke as cs
from srla_tpu_torch.kernels import build
from srla_tpu_torch.kernels import rice_cost as RC
from srla_tpu_torch.signals import make_music
build.load_all(cs.LIBRARIES)
dev = torch.device("cuda")
_, (res, n, P), _ = cs.approx_kernel_inputs(torch, np, dev,
                                            make_music(cs.MAIN_SECONDS))
V = res.shape[0]
src = open(os.path.join(build.SRC_DIR, "rice_cost.cu")).read()
TERMS = ("    if (!allzero) {\n        if (rec) {",
         "    if (false) {\n        if (rec) {")
PARAMS = ("        sk[e] = rec ? k_recursive(m, mlnoptx) : k_plain(m, "
          "neg_mlnoptx);",
          "        sk[e] = min(30, 31 - __clz((unsigned)m | 1u));")
PBITS = ("    for (int c = warp; c * 32 < P1; c += T >> 5) {",
         "    for (int c = warp; c * 32 < 0; c += T >> 5) {")
parts = {"whole": [], "no_sample_terms": [TERMS], "cheap_parameters":
         [PARAMS], "no_parameter_bits": [PBITS],
         "load_sums_heap_ks_only": [TERMS, PARAMS, PBITS]}
procs = {}
os.makedirs(build.BUILD_DIR, exist_ok=True)
for name, edits in parts.items():
    text = src
    for old, new in edits:
        assert old in text, f"rice_cost.cu: {old!r} not found"
        text = text.replace(old, new)
    cu = os.path.join(build.BUILD_DIR, f"rice_cost_{name}.cu")
    so = os.path.join(build.BUILD_DIR, f"librice_cost_{name}.so")
    open(cu, "w").write(text)
    procs[name] = (so, subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS,
         *build.EXTRA_FLAGS["rice_cost"], "-o", so, cu],
        stderr=subprocess.DEVNULL))
fns = {}
for name, (so, p) in procs.items():
    assert p.wait() == 0, f"nvcc failed on the {name} copy"
    fn = ctypes.CDLL(so).srla_rice_cost
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
    fns[name] = fn


def call(fn):
    out = (torch.empty(V, dtype=torch.int64, device=dev),
           torch.empty(V, dtype=torch.int64, device=dev),
           torch.empty(V, dtype=torch.int32, device=dev),
           torch.empty((V, 1 << P), dtype=torch.int64, device=dev))
    err = fn(res.data_ptr(), *(t.data_ptr() for t in out), V, n, P,
             RC.MLNOPTX_F32, RC.NEG_MLNOPTX_F32, RC.HEAD_BITS,
             torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"launch failed ({err})"
    return out


for g, w in zip(call(fns["whole"]), RC.rice_cost_plain(res, n, P)):
    assert torch.equal(g, w), "the whole copy differs from the plain version"
times = {name: [] for name in fns}
for turn in range(2):
    for name in (fns if turn == 0 else list(fns)[::-1]):
        times[name].append(cs.device_ms(torch, lambda: call(fns[name]), 20))
ct = RC.rice_cost(res, n, P)[0]
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip()
print(json.dumps({"rows": V, "n": n, "max_porder": P,
                  "recursive_rows": int((ct == 1).sum()),
                  "device_ms": times, "card": card}))
'''


STAGES = r'''
import hashlib, json, os, subprocess, sys
sys.path.insert(0, os.getcwd())
import numpy as np, torch
import chip_smoke as cs
from srla_tpu_torch.kernels import build, exact, select
from srla_tpu_torch.kernels.preemphasis import Spans, variant_preemphasis
from srla_tpu_torch.signals import make_music
build.load_all(cs.LIBRARIES)
dev = torch.device("cuda")
music = make_music(cs.MAIN_SECONDS)
file = torch.from_numpy(np.ascontiguousarray(music, np.int16)).to(dev)
blocks, B, args, W = cs.main_group(torch, np, dev, music)
n = args["n"]
spans = Spans(file, np.arange(B) * n, n)
core = exact.analyze_core(spans, 0, **args)
small = exact.core_small(core)
kw = dict(B=B, C=2, n=n, bps=16, W=W, max_params=args["max_params"])
mkw = {k: kw[k] for k in ("B", "C", "bps", "max_params")}
from srla_tpu_torch import SRLADecoder, SRLAEncoder
from srla_tpu_torch.kernels import encode as approx
from srla_tpu_torch.kernels.decode2 import meta_cols
stream = SRLAEncoder(cs.main_param(), dev).encode_whole(music)
g = max(SRLADecoder(dev).plan(stream)[2], key=lambda g: len(g.starts))
meta = torch.from_numpy(g.meta).to(dev)
methods = meta[:, meta_cols(2, g.M, 3)[0]["method"][0]]
y = torch.from_numpy(np.random.RandomState(19).randint(
    -(1 << 31), 1 << 31, (meta.shape[0], 2, g.n), dtype=np.int64).astype(
    np.int32)).to(dev)
try:
    from srla_tpu_torch.kernels.decode2 import synth_tail
    ybuf = y.clone()
    tail = lambda: synth_tail(ybuf, methods, 0)
    tail_once = lambda: (synth_tail(y.clone(), methods, 0),)
except ImportError:      # a checkout before K19: synthesize's torch ops
    from srla_tpu_torch.kernels.lpc import wrap32

    def tail():
        out = y.long()
        m = methods.long()[:, None]
        o0, o1 = out[:, 0], out[:, 1]
        c0_ms = wrap32(o0 - (o1 >> 1))
        c0 = torch.where(m == 1, c0_ms, o0)
        c1 = torch.where(m == 1, wrap32(o1 + c0_ms), o1)
        c1 = torch.where(m == 2, wrap32(o1 + o0), c1)
        c0 = torch.where(m == 3, wrap32(o1 - o0), c0)
        out = torch.cat([c0[:, None], c1[:, None], out[:, 2:]], dim=1)
        return wrap32(out << 0).to(torch.int32)
    tail_once = lambda: (tail(),)
try:
    from srla_tpu_torch.kernels.preemphasis import variant_preemphasis_f32
    pre = lambda: variant_preemphasis_f32(blocks, 0)[:2]
except ImportError:      # before K16's f32 entry: the torch stack and ops
    pre = lambda: approx.preemphasis(exact.variant_stack(blocks, 0))
calls = {
    "k16_blocks": lambda: variant_preemphasis(blocks, 0, eps=cs.K16_EPS),
    "k17_select": lambda: select.select_blocks(
        small, rice_risky=core["rice_risky"], **kw),
    "k17_measure": lambda: select.measure_blocks(
        small, rice_risky=core["rice_risky"], **mkw),
    "k16_spans": lambda: variant_preemphasis(spans, 0, eps=cs.K16_EPS),
    "k19_main": tail, "k16f32_blocks": pre}
once = {"k19_main": tail_once}
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip()


def digest(out):
    if isinstance(out, dict):
        out = [out[k] for k in sorted(out)]
    h = hashlib.sha256()
    for t in out:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


rec = {"B": B, "n": n, "V": 4 * B, "M": args["max_params"],
       "k19_methods": np.bincount(methods.cpu().numpy(),
                                  minlength=4).tolist()}
for name, fn in calls.items():
    key = "digest" if name == "k16f32_blocks" else "sha256"
    rec[f"{name}_{key}"] = digest(once.get(name, fn)())
    rec[f"{name}_ms"] = cs.cuda_ms(torch, fn, 20)
    try:
        rec[f"{name}_device_ms"] = cs.device_ms(torch, fn, 20)
    except RuntimeError as e:            # an upload that cannot be captured
        rec[f"{name}_device_ms"] = None
        rec[f"{name}_device_error"] = str(e).splitlines()[0][:200]
rec["card"] = card
print(json.dumps(rec))
'''


def run(roots, child: str = _CHILD, save_dir=None) -> list:
    """One child process a checkout, in the order given: its JSON record
    (or {"root": ROOT, "error": ...}). With save_dir, the approximate
    child saves its K14 inputs and outputs to save_dir/<i>.npz."""
    out = []
    for i, root in enumerate(roots):
        env = dict(os.environ)
        if save_dir is not None:
            env["KERNEL_AB_SAVE"] = os.path.join(save_dir, f"{i}.npz")
        p = subprocess.run([sys.executable, "-c", child], cwd=root,
                           capture_output=True, text=True, env=env)
        lines = p.stdout.strip().splitlines()
        if p.returncode != 0 or not lines:
            out.append({"root": root, "error": p.stderr[-2000:]})
            continue
        rec = json.loads(lines[-1])
        rec["root"] = root
        out.append(rec)
    return out


def _qe_chain(c, order: int, rshift: int):
    """The quantization's qe values of one row, from the last coefficient
    to the first, in f32 (as quantize_f32)."""
    import numpy as np
    f32 = np.float32
    scale, qerr, out = f32(2.0 ** rshift), f32(0), {}
    for i in range(order - 1, -1, -1):
        qe = f32(qerr + f32(c[i] * scale))
        qt = np.clip(np.round(qe), -128, 127)
        qerr = f32(qe - qt)
        out[i] = float(qe)
    return out


def k14_moved(parent_npz: str, change_npz: str, limit: int = 20) -> dict:
    """The rows whose K14 outputs differ between two saved runs on the
    same lags, with the decision that moved: an order (the two orders'
    estimated lengths on each side's error variances: a near tie), or a
    quantized coefficient (the first one, from the last, whose rounding
    moved, with each side's qe: a value near a half-integer). Each side's
    error variances and coefficients are its own checkout's."""
    import numpy as np
    import torch

    from srla_tpu_torch.kernels import lpc_f32

    p, c = np.load(parent_npz), np.load(change_npz)
    if not np.array_equal(p["ac"], c["ac"]):
        return {"error": "the two runs' lags differ"}
    n, bps, M = (int(x) for x in c["args"])
    rows = np.flatnonzero((p["orders"] != c["orders"])
                          | (p["coefs"] != c["coefs"]).any(1)
                          | (p["shifts"] != c["shifts"]))
    out = {"rows": len(p["ac"]), "differ": int(len(rows)), "moved": []}
    for r in rows[:limit]:
        op, oc = int(p["orders"][r]), int(c["orders"][r])
        if op != oc:
            lo, ln = (lpc_f32.order_lengths(
                torch.from_numpy(side["ev"][r:r + 1]), n, bps)[0]
                for side in (p, c))
            out["moved"].append({
                "row": int(r), "decision": "order", "parent": op,
                "change": oc,
                "parent_lengths": [float(lo[op - 1]), float(lo[oc - 1])],
                "change_lengths": [float(ln[op - 1]), float(ln[oc - 1])]})
            continue
        cold, cnew = p["coefs_f"][r], c["coefs_f"][r]
        qo = _qe_chain(cold, op, int(p["shifts"][r]))
        qn = _qe_chain(cnew, oc, int(c["shifts"][r]))
        i = max(j for j in range(oc)
                if p["coefs"][r, j] != c["coefs"][r, j])
        out["moved"].append({
            "row": int(r), "decision": "coefficient", "index": i,
            "parent": int(p["coefs"][r, i]), "change": int(c["coefs"][r, i]),
            "parent_qe": qo[i], "change_qe": qn[i],
            "coef_rel_diff": float(np.abs(cold[:op] - cnew[:oc]).max()
                                   / np.abs(cnew[:oc]).max())})
    return out


def main(argv) -> int:
    if argv in (["--layouts"], ["--k15-parts"]):
        code = _LAYOUTS if argv == ["--layouts"] else _K15_PARTS
        p = subprocess.run([sys.executable, "-c", code],
                           capture_output=True, text=True)
        print(p.stdout.strip().splitlines()[-1] if p.returncode == 0
              else p.stderr[-2000:])
        return p.returncode
    child = _CHILD
    approx = bool(argv) and argv[0] == "--approx"
    if approx:
        child, argv = _APPROX, argv[1:]
    elif argv and argv[0] == "--stages":
        child, argv = STAGES, argv[1:]
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as save:
        recs = run(argv, child, save if approx else None)
        for rec in recs:
            print(json.dumps(rec))
        if any("error" in r for r in recs):
            return 1
        if approx and len(argv) > 1:
            print(json.dumps({"k14_moved": k14_moved(
                os.path.join(save, "0.npz"), os.path.join(save, "1.npz"))}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
