"""The system under test: one adaptor a traffic mix's ``entry`` names.

Each adaptor takes the configuration, the pool of batches (each a list of
(C, N) int32 sources) and the device, does the entry's own set-up, and
returns an ``Entry``: ``call(batch_index)`` runs one request through the
port's public entry and returns its outputs, one a file; ``kind`` says
whether the outputs are streams ("encode") or PCM ("decode"). The
program is imported inside functions only: here, in ``spans.py`` and in
the harness's set-up (the native library, the nvcc build times).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable


@dataclass
class Entry:
    kind: str                                  # "encode" or "decode"
    call: Callable[[int], list]
    # Decode entries: the streams each batch's files are decoded from.
    streams: list = field(default_factory=list)


def _param(cfg: dict, C: int):
    from srla_tpu_torch.host_encoder import make_parameter
    e, f = cfg["encoder"], cfg["format"]
    return make_parameter(C, f["bits_per_sample"], f["sampling_rate"],
                          e["preset"], e["max_block"],
                          e["variable_divisions"], e["lookahead_factor"],
                          e["ltp_order"], e["svr_iterations"])


def _encode_args(cfg: dict) -> dict:
    e, f = cfg["encoder"], cfg["format"]
    return dict(bits_per_sample=f["bits_per_sample"],
                sampling_rate=f["sampling_rate"], preset=e["preset"],
                max_block=e["max_block"],
                variable_divisions=e["variable_divisions"],
                lookahead_factor=e["lookahead_factor"],
                ltp_order=e["ltp_order"], svr_iterations=e["svr_iterations"])


def encode_whole(cfg: dict, pool: list, device) -> Entry:
    """``SRLAEncoder(param, device).encode_whole(pcm)`` on one encoder
    reused for the run, one file a request."""
    from srla_tpu_torch.encoder import SRLAEncoder
    enc = SRLAEncoder(_param(cfg, cfg["format"]["channels"]), device)
    return Entry("encode", lambda b: [enc.encode_whole(x) for x in pool[b]])


def decode(cfg: dict, pool: list, device) -> Entry:
    """``decoder.decode(stream, device)`` of one stream a request, the
    streams made at set-up by the port's ``encode_whole``, PCM to the
    host."""
    from srla_tpu_torch.decoder import decode as dec
    from srla_tpu_torch.encoder import SRLAEncoder
    enc = SRLAEncoder(_param(cfg, cfg["format"]["channels"]), device)
    streams = [[enc.encode_whole(x) for x in batch] for batch in pool]
    del enc
    return Entry("decode",
                 lambda b: [dec(s, device)[1] for s in streams[b]], streams)


def encode_files(cfg: dict, pool: list, device) -> Entry:
    """``encoder.encode_files`` of one batch a request."""
    from srla_tpu_torch.encoder import encode_files as enc
    args = _encode_args(cfg)
    return Entry("encode", lambda b: enc(pool[b], device=device, **args))


def decode_corpus(cfg: dict, pool: list, device) -> Entry:
    """``parallel.decode_corpus_sharded([device], streams)`` of one batch
    a request, the streams made at set-up by ``encoder.encode_files``."""
    import torch
    from srla_tpu_torch.encoder import encode_files as enc
    from srla_tpu_torch.parallel import decode_corpus_sharded
    args = _encode_args(cfg)
    streams = [enc(batch, device=device, **args) for batch in pool]
    devices = [torch.device(device)]
    return Entry("decode",
                 lambda b: decode_corpus_sharded(devices, streams[b]),
                 streams)


ENTRIES = {"encode_whole": encode_whole, "decode": decode,
           "encode_files": encode_files, "decode_corpus": decode_corpus}
