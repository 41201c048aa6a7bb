"""SRLA encoder on a PyTorch device (twin of ``srla_tpu.encoder``'s exact
device path: ``_encode_spans`` -> ``_device_dispatch`` ->
``_device_finish_fused``, and at -V > 0 ``_encode_variable`` with
``_measure_spans_device``).

The file's samples go to the device once per encode (int16, int32 above 16
bits); every group of blocks or spans is read from that resident copy on
the device, where it lies (``Spans``). The host types the blocks (RAW below
the order limit, SILENT when all zero, else COMPRESS) and groups the
COMPRESS blocks by size. Each even-size group is encoded in one
``kernels.exact.encode_blocks`` call: the variant stack and pre-emphasis
(kernel K16), f64 analysis with decision-boundary flags, FIR residual
(K3), Rice parameter search (K4), bit accounting and stereo selection
(K17) and the residual pack (K5). The host then fetches the parameters and
exactly the packed words it needs, re-derives flagged blocks on the exact
host path (``stats["repaired_blocks"]``) and assembles the framed blocks.

Variable block sizes (-V > 0) first choose the blocks: every candidate span
of every even-length lookahead window is measured, one
``kernels.exact.measure_spans`` call per span size (K16, K3, K4 and
K17's measurement entry, no pack),
flagged spans are re-measured on the host (``stats["remeasured_spans"]``,
beside ``stats["device_spans"]``), and the reference's Dijkstra picks each
window's partition on the host. The chosen spans are then encoded as above.

Long-term prediction (-P 1 or 3) runs inside the same calls: the pitch
autocorrelation (K8), the pitch search and LTP solve (kernel K10) and
the LTP residual (K18) come before the LPC analysis of every row, and the
assembly writes the periods and coefficients. So does SVR refinement
(``--svr-filter-learning-iteration``): K7 stops at the f64 coefficients,
K11 forms each row's covariance, K12 refines the coefficients and K7
quantizes them; rows whose refinement decisions come near a boundary are
flagged and repaired on the host like any other. At -m 0 there is no LPC
analysis and nothing to refine.

Odd-size blocks and the odd-length last lookahead window need the
reference's stale work-buffer emulation and stay on the host, as in
``srla_tpu`` (spans measured there count in ``stats["host_spans"]``); so do
LTP groups and spans under 512 samples (``srla_tpu``'s
``_device_size_ok``), encoded in a counted host batch (``host_blocks``) or
measured on the host (``host_spans``). The output is byte-identical to the
port's exact host encoder (``host_encoder.encode``) and so to
``srla_tpu.encode(..., backend="exact")``.

Given ``devices``, each encode group is cut along its block axis into one
contiguous shard a device (``parallel.shards``): the file goes up once to
each distinct device, and every shard of a group is launched before any is
fetched. The -V measurement is not split. ``encode_files`` batches a corpus
across files: at -V 0, files that share (channels, offset_lshift) become one
virtual file whose blocks join the same equal-size groups, each file's
blocks starting from fresh work-buffer state (the reference encodes each
file from fresh memory; ``srla_tpu.encode_files`` lets an odd-length block
take its state from the previous file's last COMPRESS block). Each stream
equals ``host_encoder.encode`` of its file.

``host_workers=k`` (the port's CLI: ``SRLA_HOST_THREADS=k``, as
``srla_tpu``) splits each host batch of 2k blocks or more over k threads:
the repairs, and the LTP groups under the device's smallest size.
``hybrid=True`` takes ``srla_tpu``'s work-stealing hybrid: each device-size
group of at least HYBRID_MIN_BLOCKS blocks is split between the device,
which takes chunks from the front of the group's queue in the calling
thread, and a host thread, which takes HYBRID_HOST_CHUNK blocks at a time
from its back while the host would finish them first, and encodes them on
the exact host path over those k threads (``_encode_group_hybrid``). The
default, False, encodes every device-size group on the device.

``approx=True`` (the port's CLI: ``SRLA_TPU_APPROX=1``, as
``srla_tpu/encoder.py:169``) takes ``srla_tpu``'s f32 approximate encode
instead: each equal-size group is one ``kernels.encode.encode_blocks_approx``
call a shard (f32 analysis, K14, K3, K15, selection and K5), the -V spans
are measured by ``kernels.encode.measure_spans_approx``, and nothing is
flagged or repaired. The stream decodes losslessly but is not
byte-identical to the reference's; its size is within about 2 % of the
exact encode's. With LTP and variable block sizes the encode takes the
exact path (``srla_tpu/encoder.py:170-175``), whose bytes equal
``host_encoder.encode``'s. The f32 path has no SVR refinement, as in
``srla_tpu``.
"""

from __future__ import annotations

import bisect
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import host_encoder, native_decoder
from .bitsplice import PayloadBuilder
from .constants import BlockDataType
from .format import StreamHeader, encode_header, frame_block
from .host_encoder import (EncodeParameter, _compute_offset_lshift,
                           make_parameter)
from .kernels.encode import encode_blocks_approx, measure_spans_approx
from .kernels.exact import Spans, encode_blocks, measure_spans, no_timer
from .parallel import distinct, record_cut, resolve, shards

# The smallest LTP group the device analyses (srla_tpu/encoder.py:1209).
LTP_MIN_DEVICE_SIZE = 512

class StepTimer:
    """Host-clock seconds per named step, with a device synchronise at each
    step boundary (so each step's device work lands in its own step). Only
    for measuring: it serialises host and device."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: dict[str, float] = {}
        self._last = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self._sync()
        self._last = time.perf_counter()

    def __call__(self, name: str):
        self._sync()
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self._last
        self._last = now


class SRLAEncoder:
    # Blocks per device call. Device memory grows with the call (peak 2.78
    # GiB for 1291 blocks of 16-bit stereo at -B 4096 -m 4, 4.41 GiB for
    # 2048, on an H100 80GB), so a long file's group is cut into calls of
    # at most this many blocks.
    MAX_CALL_BLOCKS = 2048
    # Span samples (spans x span length) per measurement call, which packs
    # nothing: 8192 spans of 4096. Its peak device memory grows with the
    # call (1.90 GiB for the 2260 spans of 4096 of 120 s of 16-bit stereo at
    # -V 1, on an H100 80GB), so a size's spans go in calls of at most this
    # many samples: one call a size up to about 7 minutes of audio.
    MAX_MEASURE_SAMPLES = 1 << 25
    # The hybrid's chunks (srla_tpu/encoder.py:913-914, :1003-1010): the
    # device's first chunk, and its chunks while a rate is unknown; its
    # largest while the host steals; the host's chunk, also the device's
    # smallest. A group is split when it holds at least HYBRID_MIN_BLOCKS.
    # Set from tools/hybrid_sweep.py on an H100 80GB with 8 host cores
    # (blocks of 4096, 16-bit stereo): no host chunk of 32, 64 and 128 was
    # best at every length and thread count, so JAX's 64 stays; a group of
    # 215 blocks was slower than on the device alone at every thread count
    # and chunk (the device finished it before the host's first chunk),
    # one of 430 not always.
    HYBRID_FIRST_CHUNK = 128
    HYBRID_DEV_CHUNK = 512
    HYBRID_HOST_CHUNK = 64
    HYBRID_MIN_BLOCKS = 3 * HYBRID_FIRST_CHUNK

    def __init__(self, parameter: EncodeParameter, device, devices=None,
                 approx: bool = False, host_workers: int = 1,
                 hybrid: bool = False):
        """device: the torch device that encodes the COMPRESS blocks and
        measures the -V spans ("cuda" runs the CUDA kernels, "cpu" their
        plain versions). devices: optional list of devices; each encode
        group is then cut along its block axis into len(devices) shards,
        shard k encoded on devices[k] (a device may be named more than
        once); ``stats["shard_cuts"]`` lists every group's sorted shard
        rows in the order cut, and ``stats["shard_rows"]`` the last
        group's, as srla_tpu. Flagged blocks, odd-size blocks, the odd
        last lookahead window, RAW and SILENT blocks are encoded on the
        host by a held ``host_encoder.SRLAEncoder``, whose ``stats`` dict
        this encoder shares. approx: the f32 approximate encode (lossless,
        not byte-exact; see the module's notes), except with LTP at
        variable block sizes, which stays exact (``self.approx`` says
        which). host_workers: the held host encoder's ``workers``, the
        threads a host batch is split over. hybrid: split each device-size
        group of at least HYBRID_MIN_BLOCKS blocks between the device and
        the host, which steals chunks from its back
        (``_encode_group_hybrid``; the bytes do not depend on the split in
        exact mode; stolen blocks count in ``stats["host_blocks"]`` and
        ``stats["stolen_blocks"]``)."""
        parameter.validate()
        self.p = parameter
        variable = (parameter.min_num_samples_per_block
                    != parameter.max_num_samples_per_block)
        # srla_tpu/encoder.py:170-175: the approximate path covers LTP for
        # fixed-size blocks only.
        self.approx = bool(approx) and not (parameter.ltp_order > 0
                                            and variable)
        self.device = resolve([device])[0]
        self.devices = None if devices is None else resolve(devices)
        self._host = host_encoder.SRLAEncoder(parameter, host_workers)
        self.hybrid = bool(hybrid)
        # The hybrid's rates, samples a second: the device's and the host's
        # (its whole pool), kept across groups and encodes.
        self._rates = {"dev": None, "host": None}
        # srla_tpu's keys and meaning: COMPRESS blocks emitted from the
        # device, blocks encoded on the host (repairs included), flagged
        # blocks re-derived on the host, blocks whose section exceeded W.
        # Then the spans measured for the -V search and the block API: on
        # the device, flagged and re-measured on the host, measured on the
        # host (odd sizes, the odd last window).
        self.stats = self._host.stats
        # Blocks of hybrid groups that host threads took from the device's
        # queue (also in host_blocks).
        self.stats["stolen_blocks"] = 0
        # Set to a StepTimer to collect a per-step breakdown of encode_whole.
        self.timer = None
        self._progress_cb = None
        self._progress_done = 0

    def encode_whole(self, pcm: np.ndarray, progress_callback=None) -> bytes:
        """pcm: (C, N) int32. Returns the complete .srl stream.
        ``progress_callback(samples_done)`` is called once per block as its
        group finishes."""
        pcm = np.asarray(pcm, dtype=np.int32)
        C, N = pcm.shape
        p = self.p
        host = self._host
        tick = self.timer or no_timer
        if self.timer is not None:
            self.timer.start()
        # The meter is this encoder's: once per block (parity: the
        # reference's EncodeBlockCallback, srla_encoder.c:1780). The held
        # host encoder, which reports per batch, stays silent.
        host._progress_cb = None
        self._progress_cb = progress_callback
        self._progress_done = 0
        lshift = _compute_offset_lshift(pcm)
        header = StreamHeader(C, N, p.sampling_rate, p.bits_per_sample,
                              lshift, p.max_num_samples_per_block, p.preset)
        variable = p.min_num_samples_per_block != p.max_num_samples_per_block
        files = self._upload(pcm, measure=variable)
        tick("upload")
        if variable:
            spans = host._variable_spans(
                pcm, lshift, self._measure_route(files[self.device], tick),
                tick)
        else:
            n = p.max_num_samples_per_block
            spans = [(off, min(n, N - off)) for off in range(0, N, n)]
        out = [encode_header(header)]
        out.extend(self._encode_spans(pcm, files, spans, lshift, tick))
        if variable:
            for size, framed in host._encode_odd_window(pcm, spans, lshift):
                out.append(framed)
                self._blocks_done(1, size)
            tick("odd last window (host)")
        host._check_repair_rate()
        return b"".join(out)

    def compute_block_size(self, pcm_block: np.ndarray,
                           offset_lshift: int = 0) -> int:
        """Byte size this block would encode to
        (SRLAEncoder_ComputeBlockSize), measured on the device."""
        pcm_block = np.asarray(pcm_block, dtype=np.int32)
        file = self._upload(pcm_block, measure=True)[self.device]
        route = self._measure_route(file, no_timer)
        return self._host._measure_blocks(pcm_block, [0], pcm_block.shape[1],
                                          offset_lshift, route)[0]

    def encode_optimal_partitioned_block(self, pcm_window: np.ndarray,
                                         offset_lshift: int = 0) -> bytes:
        """Optimal-partition encode of one lookahead window
        (SRLAEncoder_EncodeOptimalPartitionedBlock), its spans measured and
        its blocks encoded on the device."""
        pcm_window = np.asarray(pcm_window, dtype=np.int32)
        files = self._upload(pcm_window, measure=True)
        spans = self._host._variable_spans(
            pcm_window, offset_lshift,
            self._measure_route(files[self.device], no_timer),
            windows=[(0, pcm_window.shape[1])])
        return b"".join(self._encode_spans(pcm_window, files, spans,
                                           offset_lshift, no_timer))

    def encode_block(self, pcm_block: np.ndarray, offset_lshift: int = 0
                     ) -> bytes:
        """Encode one block (C, n) -> framed block bytes
        (SRLAEncoder_EncodeBlock: type decision, compress, raw or silent,
        raw fallback, checksum framing): one span, a COMPRESS block of even
        size analysed on the device."""
        pcm_block = np.asarray(pcm_block, dtype=np.int32)
        self._progress_cb = None
        return self._encode_spans(pcm_block, self._upload(pcm_block),
                                  [(0, pcm_block.shape[1])], offset_lshift,
                                  no_timer)[0]

    def _encode_batch(self, pcms: list, offset_lshift: int) -> list[bytes]:
        """Streams of files that share this encoder's channel count and
        ``offset_lshift`` (``_compute_offset_lshift`` of each), encoded as
        one virtual file at fixed block size: their blocks join the same
        equal-size groups, so a group's device calls span files. Blocks
        never cross a file's end, and each file's first COMPRESS block
        starts from fresh work-buffer state, so each stream equals the
        file's own encode."""
        p = self.p
        n = p.max_num_samples_per_block
        self._host._progress_cb = None
        self._progress_cb = None
        tick = self.timer or no_timer
        if self.timer is not None:
            self.timer.start()
        cat = np.concatenate([np.asarray(x, np.int32) for x in pcms], axis=1)
        spans, firsts = [], []
        off = 0
        for x in pcms:
            firsts.append(len(spans))
            N = x.shape[1]
            spans += [(off + o, min(n, N - o)) for o in range(0, N, n)]
            off += N
        files = self._upload(cat)
        tick("upload")
        framed = self._encode_spans(cat, files, spans, offset_lshift, tick,
                                    firsts)
        self._host._check_repair_rate()
        ends = firsts[1:] + [len(spans)]
        return [b"".join([encode_header(StreamHeader(
            x.shape[0], x.shape[1], p.sampling_rate, p.bits_per_sample,
            offset_lshift, n, p.preset))] + framed[lo:hi])
            for x, lo, hi in zip(pcms, firsts, ends)]

    def _targets(self) -> list:
        """The devices of the encode groups' shards, in shard order."""
        return self.devices or [self.device]

    def _upload(self, pcm: np.ndarray, measure: bool = False) -> dict:
        """The (C, N) samples, int16 up to 16 bits, once on each distinct
        device of the groups' shards (and on ``device`` for a
        measurement): {device: tensor}."""
        dtype = np.int16 if self.p.bits_per_sample <= 16 else np.int32
        host = torch.from_numpy(np.ascontiguousarray(pcm, dtype))
        want = self._targets() + ([self.device] if measure else [])
        return {d: host.to(d) for d in distinct(want)}

    def _measure_route(self, file: torch.Tensor, tick):
        """The device route of the host's ``_measure_blocks`` for the
        COMPRESS spans of ``file``'s host copy: rounded block bits per span,
        even sizes measured on the device in calls of at most
        MAX_MEASURE_SAMPLES span samples (one call per size as a rule),
        flagged spans re-measured on the host; odd sizes measured on the
        host, as in ``srla_tpu``."""
        host = self._host

        def step(name):
            tick("measure: " + name)

        def measure_bits(window, offsets, size, lshift):
            if not self._device_size_ok(size):
                bits = host._measure_bits_host(window, offsets, size, lshift)
                step("odd size or short LTP span (host)")
                return bits
            per_call = max(1, self.MAX_MEASURE_SAMPLES // size)
            if self.approx:
                # No LTP in the approximate measurement (encoder.py:1937).
                args = self._approx_args(size)
                del args["ltp_order"]
                bits = np.concatenate([measure_spans_approx(
                    file, offsets[lo:lo + per_call], lshift,
                    C=window.shape[0], timer=step, **args).cpu().numpy()
                    for lo in range(0, len(offsets), per_call)])
                step("fetch")
                self.stats["device_spans"] += len(offsets)
                return bits
            parts = []
            for lo in range(0, len(offsets), per_call):
                small = measure_spans(file, offsets[lo:lo + per_call], lshift,
                                      C=window.shape[0], timer=step,
                                      **host._device_args(size))
                parts.append((small["bits"].cpu().numpy(),
                              small["risky_blk"].cpu().numpy()))
            bits = np.concatenate([b for b, _ in parts])
            risky = np.flatnonzero(np.concatenate([r for _, r in parts]))
            step("fetch")
            if len(risky):
                blocks = np.stack([window[:, offsets[k]:offsets[k] + size]
                                   for k in risky])
                _m, _p, bits[risky] = host._compute_coefficients(
                    blocks.astype(np.int32), size, lshift, measure_only=True)
                step("re-measure (host)")
            self.stats["device_spans"] += len(offsets) - len(risky)
            self.stats["remeasured_spans"] += len(risky)
            return bits

        return measure_bits

    def _device_size_ok(self, size: int) -> bool:
        """Whether the device analyses blocks or spans of ``size``: even
        sizes, and with LTP at least LTP_MIN_DEVICE_SIZE samples (the host
        keeps the others, as srla_tpu does). Under approx every even size:
        its analysis runs without LTP below 263 lags
        (``srla_tpu/encoder.py:1207-1211``)."""
        return size % 2 == 0 and (self.approx or self.p.ltp_order == 0
                                  or size >= LTP_MIN_DEVICE_SIZE)

    def _approx_args(self, size: int) -> dict:
        """The arguments of the approximate analysis of n-sample blocks:
        the exact path's without SVR."""
        args = self._host._device_args(size)
        del args["svr_iter"], args["margins"]
        return args

    def _blocks_done(self, count: int, size: int) -> None:
        """Advance the progress meter: one call for each of ``count``
        finished blocks of ``size`` samples."""
        for _ in range(count):
            if self._progress_cb is None:
                return
            self._progress_done += size
            try:
                self._progress_cb(self._progress_done)
            except Exception:
                self._progress_cb = None   # a broken meter never kills encode

    def _encode_spans(self, pcm, files, spans, lshift, tick,
                      firsts=(0,)) -> list[bytes]:
        """Type the blocks, encode each even-size COMPRESS group on the
        device (cut from ``files``, the resident copies of ``pcm``; with
        ``hybrid``, a large one split with the host), odd-size
        ones serially on the host (``srla_tpu``'s ``_encode_spans`` with the
        device route always taken). ``firsts``: the sorted indices of the
        spans that begin a file; an odd-size block takes its work-buffer
        state from no span before its file's first."""
        host = self._host
        C = pcm.shape[0]
        types = {}
        for i, (off, size) in enumerate(spans):
            if size <= host.preset.max_num_parameters:
                types[i] = BlockDataType.RAW
            elif not pcm[:, off:off + size].any():
                types[i] = BlockDataType.SILENT
            else:
                types[i] = BlockDataType.COMPRESS
        by_size: dict[int, list[int]] = {}
        for i, (_, size) in enumerate(spans):
            if types[i] == BlockDataType.COMPRESS:
                by_size.setdefault(size, []).append(i)
        tick("host typing")
        results: dict[int, bytes] = {}
        for size, idxs in by_size.items():
            if self._device_size_ok(size):
                if self.hybrid and len(idxs) >= self.HYBRID_MIN_BLOCKS:
                    results.update(self._encode_group_hybrid(
                        pcm, files, spans, idxs, size, lshift, tick))
                    continue
                for lo in range(0, len(idxs), self.MAX_CALL_BLOCKS):
                    call = idxs[lo:lo + self.MAX_CALL_BLOCKS]
                    results.update(self._encode_group(
                        pcm, files, spans, call, size, lshift, tick))
                    self._blocks_done(len(call), size)
                continue
            if size % 2 == 0:
                # LTP groups under the device's smallest size: a counted
                # host batch.
                results.update(host._encode_host_batch(pcm, spans, idxs,
                                                       size, lshift))
                self._blocks_done(len(idxs), size)
                tick("short LTP blocks (host)")
                continue
            # Odd-length blocks: the reference's Welch window leaves the
            # middle sample holding stale work-buffer content.
            for i in idxs:
                first = firsts[bisect.bisect_right(firsts, i) - 1]
                state = host._incoming_state(pcm, spans, types, i, lshift,
                                             first)
                off = spans[i][0]
                method, params, _ = host._compute_coefficients(
                    pcm[:, off:off + size][None], size, lshift,
                    stale_state=state)
                results[i] = host._finish_block(pcm, spans, i, size, params,
                                                int(method[0]), 0, C)
                self._blocks_done(1, size)
            tick("odd-size blocks (host)")
        for i, (off, size) in enumerate(spans):
            if types[i] == BlockDataType.SILENT:
                results[i] = frame_block(BlockDataType.SILENT, size, b"")
            elif types[i] == BlockDataType.RAW:
                results[i] = self._raw_block(pcm, off, size)
            else:
                continue
            self._blocks_done(1, size)
        tick("assembly")
        return [results[i] for i in range(len(spans))]

    def _section_words(self, size: int) -> int:
        """W, the packed words a residual section may take before its
        block goes to the host (``srla_tpu``'s bound)."""
        return (size * (self.p.bits_per_sample + 4)) // 32 + 64

    def _raw_block(self, pcm, off: int, size: int) -> bytes:
        return frame_block(BlockDataType.RAW, size, self._host._raw_payload(
            pcm[:, off:off + size], size))

    def _encode_group(self, pcm, files, spans, idxs, size: int, lshift: int,
                      tick) -> dict[int, bytes]:
        """Equal-size blocks on the device: ``_launch_group`` then
        ``_finish_group``."""
        return self._finish_group(pcm, spans, size, lshift, self._launch_group(
            pcm, files, spans, idxs, size, lshift, tick), tick)

    def _launch_group(self, pcm, files, spans, idxs, size: int, lshift: int,
                      tick) -> list:
        """The launch half of a group: one ``encode_blocks`` call
        (``encode_blocks_approx`` under approx) a shard on its blocks'
        ``Spans`` of its device's copy in ``files`` (read in place by K16;
        cut first under approx), every shard launched before any is
        fetched. Returns [(the shard's block indices, its device
        outputs)]."""
        C = pcm.shape[0]
        W = self._section_words(size)
        cuts = shards(len(idxs), self._targets())
        if self.devices is not None:
            record_cut(self.stats, cuts)
        if self.approx:
            encode, args = encode_blocks_approx, self._approx_args(size)
        else:
            encode, args = encode_blocks, self._host._device_args(size)
        parts = [(idxs[lo:hi], Spans(files[d], [spans[i][0]
                                                for i in idxs[lo:hi]], size))
                 for d, lo, hi in cuts]
        # The group's host set-up is a step of its own, so that the first
        # kernel's step times that kernel's call.
        tick("group set-up")
        return [(part, encode(src, lshift, C=C, W=W, timer=tick, **args))
                for part, src in parts]

    def _finish_group(self, pcm, spans, size: int, lshift: int, launched,
                      tick) -> dict[int, bytes]:
        """The finish half of a group: each shard's fetch, repair and
        assembly (``_finish_shard``)."""
        results: dict[int, bytes] = {}
        for part, (small_t, flat_t) in launched:
            results.update(self._finish_shard(pcm, spans, part, size, lshift,
                                              small_t, flat_t, tick))
        return results

    def _encode_group_hybrid(self, pcm, files, spans, idxs, size: int,
                             lshift: int, tick) -> dict[int, bytes]:
        """Work-stealing split of one equal-size group between the device
        and the host (``srla_tpu/encoder.py:916 _encode_group_hybrid``,
        without its tunnel gates). The device side runs in this thread
        and takes chunks from the front of the queue: HYBRID_FIRST_CHUNK
        blocks, launched before the host starts; then, while the host
        steals, ``rem * dev / (dev + host) / 2`` blocks, clamped to
        [HYBRID_HOST_CHUNK, HYBRID_DEV_CHUNK] (HYBRID_FIRST_CHUNK while a
        rate is unknown), and once it has stopped, the rest. It is one
        deep: chunk k+1 is launched before chunk k is fetched, repaired and
        assembled. One stealing thread takes HYBRID_HOST_CHUNK blocks from
        the back while the host, at its measured rate, would finish them
        before the device, at its, finishes the rest and the blocks it
        holds, and encodes them on the exact host path, split over the
        held host encoder's ``workers`` threads (``host_blocks``, and here
        ``stolen_blocks``); with no rate of both sides yet it steals. The
        rates (samples a second, halved towards each new reading) are this
        encoder's, kept across groups and encodes. Both sides emit the
        same bytes in exact mode, so the stream does not depend on the
        split; under approx the device's blocks are approximate and the
        stolen ones exact. Blocks are counted and reported to the meter in
        this thread only. A device error raises once the stealing thread
        has stopped; no block of a failed device chunk is encoded again on
        the host."""
        host = self._host
        rates = self._rates
        pending = list(idxs)
        lock = threading.Lock()
        done: queue.SimpleQueue = queue.SimpleQueue()
        # Blocks the device has taken and not finished; whether the
        # stealing thread has stopped; whether the device side failed.
        state = {"held": 0, "stopped": False, "failed": False}

        def take_front(want: int) -> list:
            with lock:
                chunk = pending[:want]
                del pending[:want]
                state["held"] += len(chunk)
                return chunk

        def take_back() -> list:
            with lock:
                k = min(self.HYBRID_HOST_CHUNK, len(pending))
                dev, hst = rates["dev"], rates["host"]
                late = (dev is not None and hst is not None and k / hst
                        > (len(pending) - k + state["held"]) / dev)
                if state["failed"] or not k or late:
                    state["stopped"] = True
                    return []
                chunk = pending[-k:]
                del pending[-k:]
                return chunk

        def measured(key: str, samples: int, seconds: float) -> None:
            rate = samples / max(seconds, 1e-6)
            with lock:
                old = rates[key]
                rates[key] = rate if old is None else 0.5 * (old + rate)

        def steal() -> None:
            while chunk := take_back():
                t0 = time.perf_counter()
                out = host._encode_host_batch(pcm, spans, chunk, size,
                                              lshift)
                measured("host", len(chunk) * size,
                         time.perf_counter() - t0)
                done.put((chunk, out))

        results: dict[int, bytes] = {}

        def collect() -> None:
            while True:
                try:
                    chunk, out = done.get_nowait()
                except queue.Empty:
                    return
                results.update(out)
                self.stats["stolen_blocks"] += len(chunk)
                self._blocks_done(len(chunk), size)

        def want() -> int:
            with lock:
                dev, hst, rem = rates["dev"], rates["host"], len(pending)
                stopped = state["stopped"]
            if stopped:
                return self.MAX_CALL_BLOCKS
            if dev is None or hst is None:
                return self.HYBRID_FIRST_CHUNK
            return int(min(self.HYBRID_DEV_CHUNK,
                           max(self.HYBRID_HOST_CHUNK,
                               rem * dev / (dev + hst) * 0.5)))

        chunk = take_front(self.HYBRID_FIRST_CHUNK)
        launched = self._launch_group(pcm, files, spans, chunk, size, lshift,
                                      tick)
        stealer = ThreadPoolExecutor(1)
        try:
            stolen = stealer.submit(steal)
            last = time.perf_counter()
            while launched is not None:
                nxt_chunk = take_front(want())
                nxt = (self._launch_group(pcm, files, spans, nxt_chunk, size,
                                          lshift, tick)
                       if nxt_chunk else None)
                results.update(self._finish_group(pcm, spans, size, lshift,
                                                  launched, tick))
                with lock:
                    state["held"] -= len(chunk)
                self._blocks_done(len(chunk), size)
                now = time.perf_counter()
                measured("dev", len(chunk) * size, now - last)
                last = now
                collect()
                launched, chunk = nxt, nxt_chunk
            stolen.result()
        except BaseException:
            with lock:
                state["failed"] = True
            raise
        finally:
            stealer.shutdown(wait=True)
        collect()
        tick("hybrid: host threads")
        if set(results) != set(idxs):
            raise RuntimeError(f"hybrid encode emitted {len(results)} of "
                               f"{len(idxs)} blocks")
        return results

    def _finish_shard(self, pcm, spans, idxs, size: int, lshift: int,
                      small_t, flat_t, tick) -> dict[int, bytes]:
        """One shard's fetch of the parameters, fetch of exactly sum(lens_w)
        packed words, host repair of flagged blocks and native assembly."""
        host = self._host
        C = pcm.shape[0]
        B = len(idxs)
        keys = ("pre_prev", "pre_coef", "orders", "rshifts", "coefs",
                "section_bits", "method", "bits", "raw_blk", "risky_blk",
                "lens_w", "ltp_period", "ltp_coefs")
        small = {k: small_t[k].cpu().numpy() for k in keys}
        lens_w = small["lens_w"].astype(np.int64)
        starts = np.cumsum(lens_w) - lens_w
        total = int(lens_w.sum())
        flat = flat_t[:total].cpu().numpy()
        flat_bytes = flat.view(np.uint32).astype(">u4").tobytes()
        tick("fetch + big-endian bytes")

        raw_blk = small["raw_blk"]
        # Host repair: flagged blocks (decisions unproven) and blocks with a
        # section above W words (lens_w forced to 0 while not raw).
        repair = set(np.flatnonzero(small["risky_blk"]).tolist())
        self.stats["repaired_blocks"] += len(repair)
        zero_row = (lens_w.reshape(B, C) == 0).any(axis=1)
        for bi in np.flatnonzero(zero_row & ~raw_blk).tolist():
            if bi not in repair:
                repair.add(bi)
                self.stats["w_overflow_blocks"] += 1
        results: dict[int, bytes] = {}
        if repair:
            results.update(host._encode_host_batch(
                pcm, spans, [idxs[bi] for bi in sorted(repair)], size,
                lshift))
        tick("repair (host)")
        compress_idx = [bi for bi in range(B)
                        if not raw_blk[bi] and bi not in repair]
        self.stats["device_blocks"] += len(compress_idx)
        if compress_idx:
            results.update(self._assemble(pcm, spans, idxs, size, small,
                                          compress_idx, flat_bytes, starts,
                                          lens_w))
        for bi in range(B):
            if raw_blk[bi] and bi not in repair:
                results[idxs[bi]] = self._raw_block(pcm, spans[idxs[bi]][0],
                                                    size)
        tick("assembly")
        return results

    def _assemble(self, pcm, spans, idxs, size, small, compress_idx,
                  flat_bytes, starts, lens_w) -> dict[int, bytes]:
        """Frame the device-encoded blocks: parameter headers from the
        fetched arrays, residual sections spliced from the packed words."""
        host = self._host
        C = pcm.shape[0]
        B = len(idxs)
        bps = self.p.bits_per_sample
        method = small["method"]
        ci = np.arange(C)[None, :]
        bsel = np.asarray(compress_idx)
        m = method[bsel][:, None]
        if C >= 2:
            vix = np.where((m == 1) & (ci < 2), ci,
                           np.where(((m == 2) & (ci == 1))
                                    | ((m == 3) & (ci == 0)), 1, 2 + ci))
        else:
            vix = np.zeros((len(bsel), 1), np.int64)
        rows2 = vix * B + bsel[:, None]                # chosen variant rows
        flatrows = bsel[:, None] * C + ci              # packed rows
        sec_bits = small["section_bits"].astype(np.int64)
        out: dict[int, bytes] = {}
        if native_decoder.available():
            maxp = max(host.preset.max_num_parameters, 1)
            ltp_o = self.p.ltp_order
            framed, sizes = native_decoder.assemble_blocks(
                method[bsel], small["pre_prev"][rows2],
                small["pre_coef"][rows2], small["orders"][rows2],
                small["rshifts"][rows2], small["coefs"][rows2][:, :, :maxp],
                flat_bytes, starts[flatrows.ravel()] * 4,
                sec_bits[rows2.ravel()], C, bps, size, ltp_order=ltp_o,
                ltp_periods=small["ltp_period"][rows2] if ltp_o else None,
                ltp_coefs=small["ltp_coefs"][rows2] if ltp_o else None)
            ends = np.cumsum(sizes)
            for k, bi in enumerate(compress_idx):
                i = idxs[bi]
                sz = int(sizes[k])
                out[i] = (framed[ends[k] - sz:ends[k]] if sz
                          else self._raw_block(pcm, spans[i][0], size))
            return out
        # No native library: the Python bit writer builds each payload.
        pos = {bi: k for k, bi in enumerate(compress_idx)}

        def row_of(bi, c):
            return int(rows2[pos[bi], c])

        for bi in compress_idx:
            i = idxs[bi]
            pb = PayloadBuilder(int(small["bits"][bi]) // 8 + 8)
            head = host._params_header_bits(small, method, B, bi, row_of, C)
            pb.append_bytes(head.getvalue(), head.tell_bits())
            for c in range(C):
                r = bi * C + c
                lo = int(starts[r]) * 4
                hi = lo + int(lens_w[r]) * 4
                pb.append_array(np.frombuffer(flat_bytes[lo:hi], np.uint8),
                                int(sec_bits[row_of(bi, c)]))
            payload = pb.getvalue()
            out[i] = (self._raw_block(pcm, spans[i][0], size)
                      if 8 * len(payload) >= bps * size * C
                      else frame_block(BlockDataType.COMPRESS, size, payload))
        return out


def encode(pcm: np.ndarray, bits_per_sample: int, sampling_rate: int,
           device, preset: int = 4, max_block: int = 4096,
           variable_divisions: int = 0, lookahead_factor: int = 4,
           ltp_order: int = 0, svr_iterations: int = 0,
           approx: bool = False, host_workers: int = 1,
           hybrid: bool = False) -> bytes:
    """One-shot file encode on ``device``: ``host_encoder.encode``'s (and
    ``srla_tpu.encode``'s) result for the same arguments; with approx, the
    f32 approximate encode (lossless, not byte-exact); host_workers and
    hybrid as ``SRLAEncoder``'s."""
    pcm = np.asarray(pcm, dtype=np.int32)
    param = make_parameter(pcm.shape[0], bits_per_sample, sampling_rate,
                           preset, max_block, variable_divisions,
                           lookahead_factor, ltp_order, svr_iterations)
    return SRLAEncoder(param, device, approx=approx,
                       host_workers=host_workers,
                       hybrid=hybrid).encode_whole(pcm)


def encode_files(pcm_list, bits_per_sample: int, sampling_rate: int,
                 device, preset: int = 4, max_block: int = 4096,
                 variable_divisions: int = 0, lookahead_factor: int = 4,
                 ltp_order: int = 0, svr_iterations: int = 0, devices=None,
                 stats_out=None, approx: bool = False) -> list[bytes]:
    """Batched multi-file encode on ``device`` (the twin of
    ``srla_tpu.encoder.encode_files``). At -V 0 with more than one file,
    files that share (channels, offset_lshift) are encoded as one virtual
    file (``SRLAEncoder._encode_batch``): one device call per (group, block
    size, MAX_CALL_BLOCKS slice) across the files, not one per file. -V > 0
    and a group of one file encode each file on its own. ``devices`` splits
    each group's blocks over several devices. Returns the streams in input
    order, each ``host_encoder.encode`` of its file at the same flags;
    ``stats_out`` receives the encoders' counters summed over the corpus,
    every group's ``shard_cuts`` and the last group's ``shard_rows``. With
    approx, each file's f32 approximate encode (lossless, not
    byte-exact)."""
    pcms = [np.asarray(p, dtype=np.int32) for p in pcm_list]
    encoders: dict[int, SRLAEncoder] = {}

    def encoder(C: int) -> SRLAEncoder:
        if C not in encoders:
            encoders[C] = SRLAEncoder(make_parameter(
                C, bits_per_sample, sampling_rate, preset, max_block,
                variable_divisions, lookahead_factor, ltp_order,
                svr_iterations), device, devices, approx)
        return encoders[C]

    out: dict[int, bytes] = {}
    if variable_divisions == 0 and len(pcms) > 1:
        groups: dict[tuple, list[int]] = {}
        for i, x in enumerate(pcms):
            groups.setdefault((x.shape[0], _compute_offset_lshift(x)),
                              []).append(i)
        for (C, lshift), idxs in groups.items():
            if len(idxs) == 1:
                out[idxs[0]] = encoder(C).encode_whole(pcms[idxs[0]])
            else:
                out.update(zip(idxs, encoder(C)._encode_batch(
                    [pcms[i] for i in idxs], lshift)))
    else:
        for i, x in enumerate(pcms):
            out[i] = encoder(x.shape[0]).encode_whole(x)
    if stats_out is not None:
        for enc in encoders.values():
            for k, v in enc.stats.items():
                if k == "shard_rows":
                    stats_out[k] = v
                elif k == "shard_cuts":
                    stats_out[k] = stats_out.get(k, []) + v
                elif isinstance(v, int):
                    stats_out[k] = stats_out.get(k, 0) + v
    return [out[i] for i in range(len(pcms))]
