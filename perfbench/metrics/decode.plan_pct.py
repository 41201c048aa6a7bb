"""The decode plan's share of the decode requests' wall time, %: the
benchmark's span around ``SRLADecoder.plan`` (header walk, checksums,
RAW/SILENT blocks, the native parameter parse, grouping) over the
requests' spans, in the traced window."""


def read(trace):
    if trace.kind != "decode":
        return None
    req = trace.span_s("request")
    plan = trace.span_s("plan")
    if req <= 0 or plan <= 0:
        return None
    return 100.0 * plan / req
