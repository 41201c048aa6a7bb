"""The block-axis split over devices, and the corpus entry points.

The twin of ``srla_tpu/parallel.py`` (``make_mesh`` :21,
``encode_corpus_sharded`` :78, ``decode_corpus_sharded`` :99) and of the
mesh placement in ``srla_tpu/encoder.py:1266-1285`` and
``srla_tpu/decoder.py:689-705``. Blocks are independent in the stream
format, so the codec's parallel axis is the block axis: an encoder or
decoder given ``devices`` cuts each group of equal-size blocks into
``len(devices)`` contiguous shards of near-equal size and runs shard k on
``devices[k]`` (``shards``). The samples (or the stream's words) go to each
distinct device once; every shard of a group is launched before any is
fetched, so separate cards work at once. Bytes and PCM do not depend on the
split. The list may name one card more than once: two shards then queue on
that card.

Not ported: ``analyze_variants_sharded`` (:28), ``_train_style_step`` (:50)
and ``full_step_sharded`` (:61) run ``srla_tpu``'s f32 approximate
analysis, which is not byte-exact.
"""

from __future__ import annotations

import numpy as np
import torch


def make_devices(n: int | None = None) -> list[torch.device]:
    """The visible CUDA devices, the first ``n`` of them (all by default):
    the port's ``make_mesh``."""
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return devs if n is None else devs[:n]


def resolve(devices) -> list[torch.device]:
    """``devices`` as torch devices, "cuda" with its index made explicit (so
    "cuda" and "cuda:0" name one card), repeats kept."""
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("devices: name at least one device")
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]


def distinct(devices) -> list[torch.device]:
    """The devices of ``resolve(devices)`` in first-seen order, each once."""
    out: list[torch.device] = []
    for d in resolve(devices):
        if d not in out:
            out.append(d)
    return out


def shards(rows: int, devices) -> list[tuple[torch.device, int, int]]:
    """(device, lo, hi) for each shard of ``rows`` rows cut along the block
    axis over ``devices``: contiguous, near-equal (the first ``rows %
    len(devices)`` shards one row longer), no empty shard."""
    devices = list(devices)
    parts = max(1, min(len(devices), rows))
    q, r = divmod(rows, parts)
    out, lo = [], 0
    for k in range(parts):
        hi = lo + q + (1 if k < r else 0)
        out.append((torch.device(devices[k]), lo, hi))
        lo = hi
    return out


def record_cut(stats: dict, cuts) -> None:
    """Record one group's cut in ``stats``: its sorted shard rows appended
    to ``shard_cuts`` and kept as ``shard_rows`` (srla_tpu's key, the last
    group's)."""
    rows = sorted(hi - lo for _, lo, hi in cuts)
    stats.setdefault("shard_cuts", []).append(rows)
    stats["shard_rows"] = rows


def encode_corpus_sharded(devices, pcm_list, bits_per_sample: int,
                          sampling_rate: int, preset: int = 4,
                          max_block: int = 4096, stats_out=None) -> list:
    """Encode a corpus with one block axis split over ``devices``: files
    sharing (channels, offset_lshift) are batched across files
    (``encoder.encode_files``) and each group's blocks are cut into one
    shard a device. Returns the .srl streams in input order, byte-identical
    to ``host_encoder.encode`` of each file."""
    from .encoder import encode_files

    devices = list(devices)
    return encode_files(pcm_list, bits_per_sample, sampling_rate, devices[0],
                        preset=preset, max_block=max_block, devices=devices,
                        stats_out=stats_out)


def fused_stream(streams) -> bytes:
    """Header-compatible .srl streams as one virtual stream: their block
    sections concatenated behind the first one's header, its sample count
    the sum of theirs."""
    import dataclasses

    from .constants import HEADER_SIZE
    from .format import decode_header, encode_header

    head = decode_header(streams[0])
    total = sum(decode_header(s).num_samples for s in streams)
    return encode_header(dataclasses.replace(head, num_samples=total)) \
        + b"".join(s[HEADER_SIZE:] for s in streams)


def decode_corpus_sharded(devices, streams, check_checksum: bool = True,
                          stats_out=None) -> list:
    """Decode a corpus of .srl streams with one block axis split over
    ``devices`` (with one device, the plain batched corpus decode).

    Streams whose headers share (channels, bits, offset_lshift, max block,
    preset, rate) are fused into one virtual stream, their block sections
    concatenated behind one header, and decoded as one file: equal-size
    blocks of the whole corpus join one device group. The PCM is split back
    per file. Returns (C, N) int32 arrays in input order. ``stats_out``
    receives the summed block counts, every group's ``shard_cuts`` and the
    last group's ``shard_rows``.
    """
    from .decoder import SRLADecoder
    from .format import decode_header

    devices = list(devices)
    out: dict[int, np.ndarray] = {}
    groups: dict[tuple, list[int]] = {}
    headers = [decode_header(s) for s in streams]
    for i, h in enumerate(headers):
        groups.setdefault((h.num_channels, h.bits_per_sample,
                           h.offset_lshift, h.max_num_samples_per_block,
                           h.preset, h.sampling_rate), []).append(i)
    dec = SRLADecoder(devices[0], check_checksum=check_checksum,
                      devices=devices)
    for idxs in groups.values():
        if len(idxs) == 1:
            _, out[idxs[0]] = dec.decode_whole(streams[idxs[0]])
            continue
        _, pcm = dec.decode_whole(fused_stream([streams[i] for i in idxs]))
        off = 0
        for i in idxs:
            n_i = headers[i].num_samples
            out[i] = pcm[:, off:off + n_i]
            off += n_i
    if stats_out is not None:
        stats_out.update(dec.stats)
    return [out[i] for i in range(len(streams))]
