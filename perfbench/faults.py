"""Faults planted under the timed path, for the check that decides
``correct``: each makes a run that must come out not correct. The CPU
tests (``tests/test_perfbench_faults.py``) and the readings on the card
(``control.py --fault``) plant them through ``broken``; the benchmark's
own runs never do.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import entries
from .reference import srla


def alter_stream(s: bytes) -> bytes:
    """One bit of a COMPRESS payload changed where the stream is made,
    its block's checksum made anew: a valid-looking wrong answer."""
    f = srla.read_stream(s)
    comp = [b for b in f.blocks if b.kind == srla.COMPRESS]
    blk = comp[len(comp) // 2]
    at = blk.payload_offset + blk.payload_size // 2
    b = bytearray(s)
    b[at] ^= 0x04
    head = blk.payload_offset - 11
    c = srla._fletcher16(np.frombuffer(bytes(b), np.uint8),
                         np.array([head + 8]),
                         np.array([blk.payload_offset + blk.payload_size]))
    b[head + 6:head + 8] = int(c[0]).to_bytes(2, "big")
    return bytes(b)


def alter_pcm(x):
    x = np.array(x, copy=True)
    x[-1, x.shape[1] // 2] += 1
    return x


def half_left_out(outs):
    """Half of the batch left out: its second half's results are the
    first half's."""
    h = len(outs) // 2
    return list(outs[:h]) + list(outs[:len(outs) - h])


def raw_stream(x, cfg) -> bytes:
    """The stream of source ``x`` with every block RAW: valid and
    lossless, with none of the compression's work done."""
    from srla_tpu_torch.format import StreamHeader, encode_header, frame_block
    from srla_tpu_torch.host_encoder import _compute_offset_lshift
    f, e = cfg["format"], cfg["encoder"]
    C, N = x.shape
    bps, B = f["bits_per_sample"], e["max_block"]
    out = [encode_header(StreamHeader(C, N, f["sampling_rate"], bps,
                                      _compute_offset_lshift(x), B,
                                      e["preset"]))]
    for off in range(0, N, B):
        blk = x[:, off:off + B].astype(np.int64)
        u = np.ascontiguousarray(
            np.where(blk < 0, -2 * blk - 1, 2 * blk).T.astype(">u4"))
        payload = u.view(np.uint8).reshape(u.shape + (4,))[
            ..., 4 - bps // 8:].tobytes()
        out.append(frame_block(srla.RAW, blk.shape[1], payload))
    return b"".join(out)


def vsearch_skipped(cfg, pool, device):
    """The encode at fixed blocks: the -V search left out."""
    fixed = {**cfg, "encoder": {**cfg["encoder"], "variable_divisions": 0}}
    return entries.encode_whole(fixed, pool, device).call


FAULTS = {
    "answer_altered": lambda kind: (
        (lambda outs: [alter_stream(s) for s in outs]) if kind == "encode"
        else (lambda outs: [alter_pcm(x) for x in outs])),
    "half_batch_left_out": lambda kind: half_left_out,
}
# Faults of the encoder's work, each a whole request made another way:
# (cfg, pool, device) -> call(batch).
WORK_FAULTS = {
    "every_block_raw": lambda cfg, pool, device: (
        lambda b: [raw_stream(x, cfg) for x in pool[b]]),
    "vsearch_skipped": vsearch_skipped,
}


def broken(make, fault: str):
    """The entry factory ``make`` with ``fault`` planted: the warm-up's
    answers stay sound (one call a batch), every later call is broken, as
    a change to the timed path would break it."""
    def factory(cfg, pool, device):
        e = make(cfg, pool, device)
        if fault in WORK_FAULTS:
            other = WORK_FAULTS[fault](cfg, pool, device)
            bad = lambda b, outs: other(b)  # noqa: E731
        else:
            f = FAULTS[fault](e.kind)
            bad = lambda b, outs: f(outs)  # noqa: E731
        calls = {"n": 0}

        def call(b):
            outs = e.call(b)
            calls["n"] += 1
            return outs if calls["n"] <= len(pool) else bad(b, outs)
        return dataclasses.replace(e, call=call)
    return factory
