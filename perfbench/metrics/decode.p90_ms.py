"""The 90th percentile (nearest rank) of the decode requests' wall time in
the traced window, ms, from the benchmark's span around each request. A
tail of one client's closed loop. Untraced, the same tail spreads by 11-14 %
(IQR/median, two sets of 6) and read 13-24 % before the window ended on
whole cycles: too near half of the largest bound allowed to stand as an
end-to-end metric (PERF.md). The profiler does not inflate it: the traced
runs read within the untraced runs' range."""

from perfbench import window as win


def read(trace):
    if trace.kind != "decode":
        return None
    lat = [(e - s) * 1e-3 for name, s, e in trace.spans if name == "request"]
    if not lat:
        return None
    return win.percentile(lat, 90)
