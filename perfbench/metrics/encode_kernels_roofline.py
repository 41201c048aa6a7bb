"""The encode kernels' share of their roofline in the traced window, %:
the summed least time of the encode groups' work (``roofline.py``, from
each request's stream) over the summed device time of the encode kernels
(K16, K8, K7, K3, K4, K17, K5) that the encode groups launch. The -V
measurement's launches run inside the benchmark's ``vsearch`` span, whose
result the host waits for, and are left out of the time as their work is
of the count: the share moves with the kernels' speed, not with how much
of the -V measurement runs on the card."""

KERNELS = ("K16", "K8", "K7", "K3", "K4", "K17", "K5")


def read(trace):
    if trace.kind != "encode":
        return None
    spent = sum(v for k, v in trace.kernel_ms(outside=("vsearch",)).items()
                if k in KERNELS)
    least = sum(v for k, v in trace.least_ms.items() if k in KERNELS)
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent
