"""The decode kernels' share of their roofline in the traced window, %:
the summed least time of each request's groups (``roofline.py``: K2, K1,
K19, from the stream) over the summed device time of those kernels."""

KERNELS = ("K2", "K1", "K19")


def read(trace):
    if trace.kind != "decode":
        return None
    spent = sum(v for k, v in trace.kernel_ms().items() if k in KERNELS)
    least = sum(v for k, v in trace.least_ms.items() if k in KERNELS)
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent
