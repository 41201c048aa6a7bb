"""What a traced window holds, read from ``torch.profiler``'s events.

``Trace.from_profile`` keeps the device's activity (kernels, copies and
fills, by name, in µs on the profiler's clock), the benchmark's own host
spans (``bench.*`` ranges, see ``spans.py``) and the window's own range;
the per-layer readers in ``metrics/`` and the breakdown read it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

from . import window as win


@dataclass
class Trace:
    window: tuple                     # (start, end) µs of "bench.window"
    device: list                      # (name, start, end) µs
    spans: list                       # (name, start, end) µs, bench.* only
    steps: dict = field(default_factory=dict)   # StepTimer s a step
    least_ms: dict = field(default_factory=dict)   # kernel -> least ms
    kind: str = ""                    # "encode" or "decode"

    @classmethod
    def from_profile(cls, prof, kind: str) -> "Trace":
        from torch.autograd import DeviceType
        device, spans, window = [], [], None
        for ev in prof.events():
            tr = ev.time_range
            if ev.device_type == DeviceType.CUDA:
                # The benchmark's own ranges also show on the device's
                # timeline, as annotations: they are not device work.
                if not ev.name.startswith("bench."):
                    device.append((ev.name, tr.start, tr.end))
            elif ev.name == "bench.window":
                window = (tr.start, tr.end)
            elif ev.name.startswith("bench."):
                spans.append((ev.name[len("bench."):], tr.start, tr.end))
        if window is None:
            raise RuntimeError("the trace holds no bench.window range")
        return cls(window, device, spans, kind=kind)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_s(self) -> float:
        return win.covered([(s, e) for _, s, e in self.device],
                           *self.window) * 1e-6

    def span_s(self, name: str) -> float:
        """Seconds of the named spans in the window (nested ones once)."""
        return win.covered([(s, e) for n, s, e in self.spans if n == name],
                           *self.window) * 1e-6

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        tot = defaultdict(float)
        for name, s, e in self.device:
            lo, hi = max(s, self.window[0]), min(e, self.window[1])
            if hi > lo:
                tot[name] += (hi - lo) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[label, seconds] of the device's idle time in the window, summed
        by the innermost benchmark span open at each gap's middle
        ("client" where only the request's loop was)."""
        gaps = win.gaps([(s, e) for _, s, e in self.device], *self.window)
        tot = defaultdict(float)
        for s, e in gaps:
            mid = (s + e) / 2
            inner = None
            for name, a, b in self.spans:
                if a <= mid <= b and (inner is None or a >= inner[1]):
                    inner = (name, a)
            tot[inner[0] if inner else "client"] += (e - s) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def kernel_ms(self, outside: tuple = ()) -> dict:
        """Device ms of the port's kernels in the window, by kernel; with
        ``outside``, leaving out each kernel that starts inside a benchmark
        span of those names (the host waits on the work it launches there,
        so the work runs inside the span)."""
        from .roofline import kernel_of
        skip = win.union([(s, e) for n, s, e in self.spans if n in outside])
        starts = [s for s, _ in skip]
        tot = defaultdict(float)
        for name, s, e in self.device:
            k = kernel_of(name)
            lo, hi = max(s, self.window[0]), min(e, self.window[1])
            if k is None or hi <= lo:
                continue
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s <= skip[i][1]:
                continue
            tot[k] += (hi - lo) * 1e-3
        return dict(tot)
