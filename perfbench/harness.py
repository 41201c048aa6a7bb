"""One run of one cell: set-up, the measured window, the traced layers and
the check that decides ``correct``.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration's file, its traffic mix's file
``traffic/<mix>.json``, the adaptor of the port's entry that the mix names
(``entries.py``) and one reader a per-layer metric, ``metrics/<name>.py``.
"""

from __future__ import annotations

import functools
import gc
import importlib.util
import json
import math
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from . import corpus, entries, roofline
from . import window as win

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# Top-level module names that no run may load: JAX and the JAX package,
# and the repo's JAX-side benchmark and evaluation.
BANNED = ("jax", "jaxlib", "flax", "srla_tpu", "bench", "evaluation")
# The share of a decode cell's requests whose PCM is kept and compared
# with its sources after the window (each batch's first is always kept).
DECODE_SAMPLE = 0.1
# SRLA's parameter presets: the largest LPC order of each -m.
MAX_ORDER = (0, 8, 16, 32, 64, 128, 255)
# The limit of ``stream_size_gap_pct``: the widest gap, in % of the
# reference's size, between an encode's stream and the plain reference's
# size for the same source (readings and reasons in PERF.md).
SIZE_GAP_LIMIT_PCT = 0.05


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(spec: dict, workload: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_of(spec: dict, name: str, root: Path = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


# The keys a traffic mix may hold: the harness runs one client in a closed
# loop, and refuses a mix that asks for anything it does not implement.
TRAFFIC_KEYS = {"why", "entry", "repeat", "batches", "content"}
# How a mix's files are made from the seed (``content``): "seeded", each
# file's music drawn from the seed (``corpus.track``), or "rotated", one
# fixed piece a file, its lookahead windows (blocks at -V 0) in an order
# rotated from a seeded window (``corpus.rotated``), so that every seed
# carries the same work.
CONTENT = ("seeded", "rotated")


def traffic_of(name: str, here: Path = HERE) -> dict:
    with open(here / "traffic" / f"{name}.json") as f:
        traffic = json.load(f)
    unknown = sorted(set(traffic) - TRAFFIC_KEYS)
    if unknown:
        raise ValueError(f"traffic {name!r} has keys the harness does not "
                         f"implement: {', '.join(unknown)}")
    if traffic.get("content", "seeded") not in CONTENT:
        raise ValueError(f"traffic {name!r} asks for content "
                         f"{traffic['content']!r}; the harness makes "
                         f"{', '.join(sorted(CONTENT))}")
    return traffic


def metrics_of(spec: dict, workload: str) -> tuple[list, list]:
    """The cell's end-to-end metrics and the per-layer metrics it reports
    (those that list it, or list no cells and move one of its end-to-end
    metrics)."""
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def reader_of(name: str, here: Path = HERE):
    """The module ``metrics/<name>.py``; its ``read(trace)`` gives the
    metric's value or None."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def make_pool(cfg: dict, traffic: dict, seed: int) -> list:
    """The traffic's batches of sources, made from the seed: each file of
    the mix's list at its stated category and length, its content from
    the seed as the mix's ``content`` says, each batch's files in a seeded
    order."""
    f, e = cfg["format"], cfg["encoder"]
    make = corpus.track
    if traffic.get("content", "seeded") == "rotated":
        unit = e["max_block"] * (e["lookahead_factor"]
                                 if e["variable_divisions"] else 1)
        make = functools.partial(corpus.rotated, unit=unit)
    jobs = []
    for b, files in enumerate(traffic["batches"]):
        perm = corpus.order(seed, len(files), 1 + b)
        for j in perm:
            cat, secs = files[j]
            jobs.append((b, cat, secs, len(jobs)))
    with ThreadPoolExecutor(max_workers=min(8, len(jobs))) as ex:
        made = list(ex.map(lambda j: make(
            j[1], seed, f["sampling_rate"], j[2], f["bits_per_sample"],
            take=j[3]), jobs))
    pool = [[] for _ in traffic["batches"]]
    for (b, *_), pcm in zip(jobs, made):
        pool[b].append(pcm)
    return pool


def request_order(traffic: dict, seed: int):
    """The batches in the order the client sends them: a seeded order of
    all batches, each sent ``repeat`` times in a row, cycled."""
    nb = len(traffic["batches"])
    perm = [int(x) for x in corpus.order(seed, nb, 0)]
    rep = int(traffic.get("repeat", 1))
    i = 0
    while True:
        yield perm[(i // rep) % nb]
        i += 1


def cycle_of(traffic: dict) -> int:
    """Requests in one whole cycle of the order: every batch ``repeat``
    times. The window ends on a whole cycle, so that every seed's window
    holds each batch equally often."""
    return len(traffic["batches"]) * int(traffic.get("repeat", 1))


def _groups(table: list, C: int) -> list:
    """(roofline.Group, offset shift) of one request from its streams'
    (block table, offset shift) pairs: a group a length and shift."""
    by_key = {}
    for blocks, lshift in table:
        for n, size, orders, method in blocks:
            g = by_key.setdefault((n, lshift),
                                  roofline.Group(n, 0, C, 0, 0, []))
            g.blocks += 1
            g.payload_bytes += size
            g.order_sum += sum(orders)
            g.methods.append(method)
    return [(g, lshift) for (_, lshift), g in by_key.items()]


def least_ms(kind: str, cfg: dict, tables: dict, counts: dict) -> dict:
    """The summed least ms by kernel of the window's requests: each
    batch's groups (from ``tables``, its streams' block tables) times the
    requests of that batch (``counts``)."""
    f, e = cfg["format"], cfg["encoder"]
    elem = 2 if f["bits_per_sample"] <= 16 else 4
    M = MAX_ORDER[e["preset"]]
    tot = {}
    for b, count in counts.items():
        for g, lshift in _groups(tables[b], f["channels"]):
            one = (roofline.encode_group(g, elem, M) if kind == "encode"
                   else roofline.decode_group(g, lshift))
            for k, v in one.items():
                tot[k] = tot.get(k, 0.0) + count * v
    return tot


def conform(stream_header, blocks, cfg: dict, shape) -> str | None:
    """Why a stream breaks the configuration, or None."""
    f, e = cfg["format"], cfg["encoder"]
    h = stream_header
    want = (shape[0], shape[1], f["sampling_rate"], f["bits_per_sample"],
            e["max_block"], e["preset"])
    got = (h.num_channels, h.num_samples, h.sampling_rate,
           h.bits_per_sample, h.max_block, h.preset)
    if got != want:
        return f"header {got} is not {want}"
    B = e["max_block"]
    if any(b.num_samples > B for b in blocks):
        return "a block longer than the largest block size"
    if e["variable_divisions"] == 0 and any(
            b.num_samples != B for b in blocks[:-1]):
        return "a block of another size than -B at -V 0"
    return None


class Cell:
    """One run of one cell (see ``run``)."""

    def __init__(self, workload: str, seed: int, seconds: float,
                 trace: bool, device: str = "cuda", root: Path = ROOT,
                 traffic: dict | None = None, control: bool = False):
        self.spec = load_spec(root)
        self.cell = cell_of(self.spec, workload)
        self.cfg = config_of(self.spec, self.cell["config"], root)
        self.here = Path(root) / "perfbench"
        self.traffic = traffic or traffic_of(self.cell["traffic"],
                                             self.here)
        self.workload, self.seed = workload, int(seed)
        self.seconds, self.trace, self.device = seconds, trace, device
        self.control = control

    def say(self, *parts) -> None:
        print(" ".join(str(p) for p in parts), file=sys.stderr, flush=True)

    def _sync(self) -> None:
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()

    def run(self, t0: float) -> dict:
        """Set-up, window, trace, check; the result's line as a dict."""
        import torch
        split = {"import": time.perf_counter() - t0}
        if self.device != "cpu":
            t = time.perf_counter()
            torch.zeros(1, device=self.device)
            self._sync()
            split["cuda_context"] = time.perf_counter() - t
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        from srla_tpu_torch import native_decoder
        native_decoder.available()
        split["native_library"] = time.perf_counter() - t
        t = time.perf_counter()
        pool = make_pool(self.cfg, self.traffic, self.seed)
        audio = [sum(x.shape[1] for x in batch)
                 / self.cfg["format"]["sampling_rate"] for batch in pool]
        split["corpus"] = time.perf_counter() - t
        t = time.perf_counter()
        make = entries.ENTRIES[self.traffic["entry"]]
        if self.control:
            entry = control_entry(make, self.cfg, pool, self.device)
        else:
            entry = make(self.cfg, pool, self.device)
        split["entry_setup"] = time.perf_counter() - t
        # Warm-up: every batch once, which also builds every kernel the
        # cell uses; the encode cells keep these outputs as each file's
        # first answer.
        t = time.perf_counter()
        answers = {}                       # (batch, file) -> [bytes]
        for b in range(len(pool)):
            outs = entry.call(b)
            if entry.kind == "encode":
                for j, s in enumerate(outs):
                    answers[(b, j)] = [s]
        self._sync()
        split["warm_up"] = time.perf_counter() - t
        from srla_tpu_torch.kernels import build
        # Libraries built in this run, and the longest nvcc batch (the
        # builds of one batch run in parallel).
        split["nvcc_libraries"] = sum(
            1 for v in build.build_seconds.values() if v > 0)
        split["nvcc_s"] = max(build.build_seconds.values(), default=0.0)
        setup_s = time.perf_counter() - t0
        self.say("setup_s", f"{setup_s:.4f}", " ".join(
            f"{k}={v:.4f}" for k, v in split.items()))

        prof = None
        if self.trace:
            prof = self._profiler()
        reqs = self._window(entry, pool, audio, answers, prof)
        window_s = reqs[-1].end - reqs[0].start
        mem_peak = (torch.cuda.max_memory_allocated()
                    if self.device != "cpu" else 0)
        tr = None
        if prof is not None:
            from .trace import Trace
            prof.__exit__(None, None, None)
            self._spans.__exit__(None, None, None)
            tr = Trace.from_profile(prof, entry.kind)
            del prof
        if tr is not None and entry.kind == "encode":
            tr.steps = self._step_seconds(pool)
        streams = entry.streams
        del entry
        self._judge_decodes(pool, reqs)
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        checks, bad_batches = self._check(pool, answers, streams, reqs)
        self.say("reference_check_s", f"{time.perf_counter() - t:.4f}")
        failed = sum(1 for r in reqs if not r.ok or r.batch in bad_batches)
        correct = all(v <= lim for v, lim in checks.values())
        result = {"correct": correct, "attempted": len(reqs),
                  "failed": failed}
        e2e, layer = metrics_of(self.spec, self.workload)
        if tr is None:
            result["metrics"] = self._e2e(e2e, reqs, window_s, setup_s)
        else:
            tables = self._tables(streams or answers, pool)
            counts = {}
            for r in reqs:
                counts[r.batch] = counts.get(r.batch, 0) + 1
            tr.least_ms = least_ms(tr.kind, self.cfg, tables, counts)
            result["metrics"] = self._layers(layer, tr)
            result["breakdown"] = {"device_ops": tr.device_ops(),
                                   "idle_gaps": tr.idle_gaps()}
        result["device"] = self._device(mem_peak, tr)
        result["checks"] = {k: {"value": v, "limit": lim}
                            for k, (v, lim) in checks.items()}
        self.say("window", f"requests={len(reqs)}", f"failed={failed}",
                 f"window_s={window_s:.4f}")
        found = banned_modules()
        if found:
            raise SystemExit(f"modules that no run may load are loaded: "
                             f"{', '.join(found)}")
        for k, (v, lim) in checks.items():
            self.say("check", k, v, "limit", lim)
        return result

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile

        from .spans import installed
        acts = [ProfilerActivity.CPU]
        if self.device != "cpu":
            acts.append(ProfilerActivity.CUDA)
        self._spans = installed()
        self._spans.__enter__()
        prof = profile(activities=acts)
        prof.__enter__()
        return prof

    def _window(self, entry, pool, audio, answers, prof):
        """The measured window: the closed loop of one client until
        ``seconds`` have passed and the order's cycle is whole, each request
        checked as it returns. The collector is frozen and off for the
        window: what set-up made is never scanned again, and no collection
        of a cycle of garbage falls into one request's time."""
        from torch.profiler import record_function
        order = request_order(self.traffic, self.seed)
        cycle = cycle_of(self.traffic)
        reqs, seen = [], set()
        self.mismatched = 0
        # A decode's PCM is compared with its sources after the window, for
        # a seeded sample of the requests (each batch's first among them):
        # the comparison reads as many bytes as the decode writes, and in
        # the window it would take a share of the host's time.
        rng = np.random.default_rng([self.seed, 7])
        self.kept = []
        ctx = record_function("bench.window") if prof else None
        gc.collect()
        gc.freeze()
        gc.disable()
        if ctx:
            ctx.__enter__()
        start = time.perf_counter()
        while True:
            b = next(order)
            s = time.perf_counter()
            ok = True
            try:
                if prof is not None:
                    with record_function("bench.request"):
                        outs = entry.call(b)
                else:
                    outs = entry.call(b)
            except Exception as e:          # a failed request is counted
                self.say("request failed:", repr(e))
                outs, ok = None, False
            e = time.perf_counter()
            if ok and entry.kind == "encode":
                ok = self._judge(pool[b], b, outs, answers)
            elif ok and (b not in seen or rng.random() < DECODE_SAMPLE):
                self.kept.append((len(reqs), outs))
            seen.add(b)
            reqs.append(win.Request(b, s, e, audio[b], ok))
            if (len(reqs) % cycle == 0
                    and time.perf_counter() - start >= self.seconds):
                break
        if ctx:
            ctx.__exit__(None, None, None)
        gc.enable()
        gc.unfreeze()
        lat = [1e3 * (r.end - r.start) for r in reqs]
        self.say("request_ms", " ".join(
            f"p{q}={win.percentile(lat, q):.4f}" for q in (1, 10, 50, 90, 100)))
        # Each batch's fastest and median request: a run slower in every
        # batch alike is slowed as a whole, one slower in its tails stalls.
        self.say("batch_ms", " ".join(
            f"b{b}=" + "/".join(f"{win.percentile(v, q):.4f}" for q in (1, 50))
            for b in sorted({r.batch for r in reqs})
            for v in [[1e3 * (r.end - r.start) for r in reqs
                       if r.batch == b]]))
        return reqs

    def _judge_decodes(self, pool, reqs) -> None:
        """The kept decodes' PCM against their sources."""
        for i, outs in self.kept:
            r = reqs[i]
            sources = pool[r.batch]
            ok = len(outs) == len(sources)
            for got, src in zip(outs, sources):
                got = np.asarray(got)
                if got.shape != src.shape or not np.array_equal(got, src):
                    ok = False
                    self.mismatched += (int(np.count_nonzero(got != src))
                                        if got.shape == src.shape
                                        else src.size)
            r.ok = r.ok and ok
        self.kept = []

    def _judge(self, sources, b, outs, answers) -> bool:
        """An encode's streams against each file's answers so far (a new
        answer is kept for the check)."""
        if len(outs) != len(sources):
            return False
        for j, s in enumerate(outs):
            seen = answers.setdefault((b, j), [])
            if not isinstance(s, (bytes, bytearray)):
                return False
            if not any(s == a for a in seen):
                seen.append(bytes(s))
        return True

    def _check(self, pool, answers, streams, reqs):
        """The numbers compared, each (value, limit), and the batches whose
        answers failed. An encode cell's distinct answers are decoded by
        the plain reference, and their lengths held against the plain
        reference's stream size for the same source; a decode cell's PCM
        was compared with its sources in the window, and its input
        streams' framing, checksums and sizes are checked against the
        configuration here."""
        from .reference import srla
        if answers:          # encode: every distinct answer of every file
            keys = [(k, a) for k, v in answers.items() for a in v]
            decoded = srla.decode_streams([a for _, a in keys], self.device)
        else:                # decode: the streams the requests decoded
            keys = [((b, j), s) for b, batch in enumerate(streams)
                    for j, s in enumerate(batch)]
            decoded = [None] * len(keys)
        mismatched, invalid, bad_batches = 0, 0, set()
        for ((b, j), stream), d in zip(keys, decoded):
            src = pool[b][j]
            f = srla.read_stream(stream)
            why = f.error or (None if all(x.checksum_ok for x in f.blocks)
                              else "checksum mismatch")
            if why is None and d is not None:
                why = d.error
            if why is None:
                why = conform(f.header, f.blocks, self.cfg, src.shape)
            if why is not None:
                invalid += 1
                bad_batches.add(b)
                self.say("invalid stream", (b, j), why)
                continue
            if d is not None:
                wrong = int(np.count_nonzero(d.pcm.cpu().numpy() != src))
                if wrong:
                    mismatched += wrong
                    bad_batches.add(b)
        checks = {"failed_requests": (sum(1 for r in reqs if not r.ok), 0),
                  "invalid_streams": (invalid, 0),
                  "mismatched_samples": (mismatched + self.mismatched, 0)}
        if answers:
            checks["nondeterministic_files"] = (
                sum(1 for v in answers.values() if len(v) > 1), 0)
            gap = self._size_gaps(pool, answers, bad_batches)
            checks["stream_size_gap_pct"] = (gap, SIZE_GAP_LIMIT_PCT)
        return checks, bad_batches

    def _size_gaps(self, pool, answers, bad_batches) -> float:
        """The widest gap, in % of the reference's size, between the
        length of an encode's answer and the plain reference's stream size
        for its source (``reference/sizes.py``); a batch with an answer
        over the limit is counted failed."""
        from .reference import sizes
        e, f = self.cfg["encoder"], self.cfg["format"]
        if e["ltp_order"] or e["svr_iterations"]:
            raise ValueError("the plain size reference covers neither "
                             "long-term prediction nor SVR")
        widest = 0.0
        for (b, j), streams in answers.items():
            ref = sizes.stream_size(
                pool[b][j], f["bits_per_sample"], e["preset"],
                e["max_block"], e["variable_divisions"],
                e["lookahead_factor"], self.device)
            for s in streams:
                gap = 100.0 * abs(len(s) - ref) / ref
                widest = max(widest, gap)
                if gap > SIZE_GAP_LIMIT_PCT:
                    bad_batches.add(b)
                    self.say("stream size", (b, j), len(s), "reference",
                             ref, f"gap_pct={gap:.6f}")
        return widest

    def _tables(self, streams_or_answers, pool) -> dict:
        """Each batch's (block table, offset shift) a stream, for the
        roofline: the decode's input streams, or the encode's first
        answers."""
        from .reference import srla
        tables = {}
        for b in range(len(pool)):
            if isinstance(streams_or_answers, dict):
                ss = [streams_or_answers[(b, j)][0]
                      for j in range(len(pool[b]))]
            else:
                ss = streams_or_answers[b]
            tables[b] = list(zip(srla.block_table(ss, self.device),
                                 [srla.read_header(s).offset_lshift
                                  for s in ss]))
        return tables

    def _step_seconds(self, pool) -> dict:
        """The encoder's StepTimer over one request of each batch, run
        after the window (the timer synchronises at every step)."""
        from .spans import step_timers
        seconds = {}
        with step_timers(self.device, seconds):
            entry = entries.ENTRIES[self.traffic["entry"]](
                self.cfg, pool, self.device)
            for b in range(len(pool)):
                entry.call(b)
        return seconds

    def _e2e(self, e2e, reqs, window_s, setup_s) -> dict:
        out = {}
        for m in e2e:
            name = m["name"]
            if name == "setup_s":
                v = setup_s
            elif name in ("encode_xrt", "decode_xrt"):
                v = win.rate(reqs, window_s)
            else:
                raise KeyError(f"no measurement for end-to-end metric "
                               f"{name!r}")
            out[name] = {"value": v, "unit": m["unit"]}
        return out

    def _layers(self, layer, tr) -> dict:
        out = {}
        for m in layer:
            v = reader_of(m["name"], self.here).read(tr)
            if v is not None and math.isfinite(v):
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out

    def _device(self, mem_peak: int, tr) -> dict:
        if self.device == "cpu":
            d = {"platform": "cpu", "kind": "cpu", "count": 0,
                 "memory_peak_bytes": 0}
        else:
            import torch
            d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                 "count": int(self.cell.get("chips", 1)),
                 "memory_peak_bytes": int(mem_peak)}
        if tr is not None:
            d["busy_s"] = tr.busy_s()
            d["window_s"] = tr.window_s
        return d


def control_entry(make, cfg, pool, device):
    """The control: the entry at the nearest lower precision of the stated
    format (15 of 16 bits, 23 of 24), its lowest sample bit dropped, which
    breaks the configuration's lossless guarantee: an encode of the
    sources so truncated, or a decode whose PCM is."""
    import dataclasses
    if make in (entries.encode_whole, entries.encode_files):
        return make(cfg, [[x & ~1 for x in batch] for batch in pool],
                    device)
    entry = make(cfg, pool, device)
    call = entry.call
    return dataclasses.replace(
        entry, call=lambda b: [np.asarray(x) & ~1 for x in call(b)])
