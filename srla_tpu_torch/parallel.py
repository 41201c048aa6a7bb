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

``analyze_variants_sharded`` (:28), ``_train_style_step`` (:50) and
``full_step_sharded`` (:61) run the f32 approximate analysis
(``kernels.encode.analyze_variants``) over the same cut of the variant
rows: one call a shard, every shard uploaded and launched before any is
fetched, and the total bits summed on the first device, the twin of the
mesh's all-reduce.
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


def _launch_shards(devices, sig, step):
    """sig (V, n) int32 numpy rows cut by ``shards`` over ``devices``: every
    shard uploaded, then ``step(rows on its device)`` launched on each.
    Returns the steps' results in shard order."""
    sig = np.ascontiguousarray(sig, np.int32)
    cuts = shards(sig.shape[0], resolve(devices))
    parts = [torch.from_numpy(sig[lo:hi]).to(d) for d, lo, hi in cuts]
    return [step(part) for part in parts]


def _gather(outs: list, device) -> dict:
    """The shards' per-row output dicts joined in row order on
    ``device``."""
    return {k: torch.cat([o[k].to(device) for o in outs]) for k in outs[0]}


def analyze_variants_sharded(devices, sig, *, n: int, bps: int,
                             max_params: int, max_fixed: bool, fft_size: int,
                             max_porder: int) -> dict:
    """Block-sharded ``kernels.encode.analyze_variants``: sig (V, n) int32
    rows cut into one shard a device. Every stage is row by row, so the
    shards share nothing; the outputs are joined on the first device (the
    twin of fetching the sharded arrays)."""
    from .kernels.encode import analyze_variants

    devices = resolve(devices)
    outs = _launch_shards(devices, sig, lambda part: analyze_variants(
        part, n=n, bps=bps, max_params=max_params, max_fixed=max_fixed,
        fft_size=fft_size, max_porder=max_porder))
    return _gather(outs, devices[0])


def _train_style_step(sig: torch.Tensor, *, n: int, bps: int,
                      max_params: int, max_fixed: bool, fft_size: int,
                      max_porder: int):
    """One step on one shard: the full analysis and its total bits (f32 on
    the shard's device)."""
    from .kernels.encode import analyze_variants

    out = analyze_variants(sig, n=n, bps=bps, max_params=max_params,
                           max_fixed=max_fixed, fft_size=fft_size,
                           max_porder=max_porder)
    return out, out["rice_bits"].to(torch.float32).sum()


def full_step_sharded(devices, sig, *, n: int, bps: int = 16,
                      max_params: int = 32, max_fixed: bool = False,
                      fft_size: int | None = None, max_porder: int = 6):
    """The full analysis step over ``devices``, run once: one
    ``_train_style_step`` a shard, the shards' totals summed on the first
    device (the all-reduce). Returns (outputs joined on the first device,
    total bits as a float)."""
    if fft_size is None:
        fft_size = 1 << (n - 1).bit_length()
    devices = resolve(devices)
    steps = _launch_shards(devices, sig, lambda part: _train_style_step(
        part, n=n, bps=bps, max_params=max_params, max_fixed=max_fixed,
        fft_size=fft_size, max_porder=max_porder))
    total = sum(t.to(devices[0]) for _, t in steps)
    return _gather([o for o, _ in steps], devices[0]), float(total)


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
