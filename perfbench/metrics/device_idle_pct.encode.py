"""The device's idle share of an encode cell's traced window, %: 1 - the
union of the device's activity in the profiler's trace / the window."""


def read(trace):
    if trace.kind != "encode" or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
