"""SRLA decoder on a PyTorch device (twin of ``srla_tpu.decoder``'s
``backend="tpu"`` path).

The host walks the block headers (with their Fletcher checksums), decodes
RAW and SILENT blocks, and parses every COMPRESS block's parameter header in
one batched native call. The stream then crosses to the device once, as one
zero-padded word tensor, and each group of equal-size COMPRESS blocks is
decoded there in one ``kernels.decode2.decode_blocks`` call: entropy decode
(kernel K2), LPC synthesis and de-emphasis (kernel K1), LTP, stereo inverse
and offset shift. Every COMPRESS block is decoded on the device, whatever
its group's size; ``stats`` counts them as ``srla_tpu`` does.

Given ``devices``, each group is cut along its block axis into one
contiguous shard a device (``parallel.shards``); the stream goes up once to
each distinct device and every shard is launched before any is fetched.
``decode_whole_device_resident`` decodes the same way but keeps the PCM on
the device: each group is compared there with an expected PCM (kernel K13)
and only one flag a device crosses back.
``decode_block`` decodes one framed block, a COMPRESS block on the device
as a group of one; ``decode_block_params``, ``synthesize_block`` and
``decode_raw_block`` are the host one-block reference
(``host_decoder.SRLADecoder``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import host_decoder
from .constants import (HEADER_SIZE, MAX_COEFFICIENT_ORDER, MAX_LTP_ORDER,
                        BlockDataType)
from .format import StreamHeader, decode_header, parse_block_header
from .kernels.decode2 import decode_blocks, pack_meta
from .kernels.verify import verify_blocks
from .parallel import distinct, record_cut, resolve, shards


def upload_stream(data: bytes, device) -> torch.Tensor:
    """The stream bytes as a little-endian int32 word view on ``device``,
    zero-padded to whole words (the kernels read 0 past the end)."""
    raw = np.frombuffer(data, np.uint8)
    buf = np.zeros((len(raw) + 3) // 4, np.int32)
    buf.view(np.uint8)[:len(raw)] = raw
    return torch.from_numpy(buf).to(device)


def _place(pcm: np.ndarray, starts: np.ndarray, out: np.ndarray) -> None:
    """Write the decoded blocks out (B, C, n) at their first samples
    ``starts`` into pcm (C, N): one copy when they are consecutive."""
    B, C, n = out.shape
    if B > 1 and (np.diff(starts) == n).all():
        s0 = int(starts[0])
        pcm[:, s0:s0 + B * n] = out.transpose(1, 0, 2).reshape(C, B * n)
    else:
        for bi, s in enumerate(starts):
            pcm[:, s:s + n] = out[bi]


class DecodeGroup(NamedTuple):
    """One group of equal-size COMPRESS blocks, ready for the device."""
    starts: np.ndarray   # (B,) first sample of each block in the stream
    n: int               # samples per block
    M: int               # largest LPC order in the group (at least 1)
    W: int               # largest payload in the group, in 32-bit words
    has_ltp: bool        # some block uses long-term prediction
    meta: np.ndarray     # (B, K) int32 parameters, pack_meta layout


class SRLADecoder:
    def __init__(self, device, check_checksum: bool = True, devices=None):
        """device: the torch device that decodes the COMPRESS blocks
        ("cuda" runs the CUDA kernels, "cpu" their plain versions).
        devices: optional list of devices; each group is then cut along
        its block axis into len(devices) shards, shard k decoded on
        devices[k] (a device may be named more than once);
        ``stats["shard_cuts"]`` lists every group's sorted shard rows in
        the order cut, and ``stats["shard_rows"]`` the last group's.
        Parameter headers are parsed by the port's native library
        (``native_decoder``), or in Python where it does not build."""
        self.device = resolve([device])[0]
        self.devices = None if devices is None else resolve(devices)
        self.check_checksum = check_checksum
        # COMPRESS blocks decoded on the device / on the host, accumulated
        # over decode_whole and decode_block calls as in srla_tpu. The host
        # count stays 0: nothing is routed to the host.
        self.stats = {"device_blocks": 0, "host_blocks": 0}
        self._host = host_decoder.SRLADecoder()

    def decode_whole(self, data: bytes) -> tuple[StreamHeader, np.ndarray]:
        """Decode a whole .srl stream -> (header, PCM (C, N) int32)."""
        header, pcm, groups = self.plan(data)
        if not groups:
            return header, pcm
        targets = self.devices or [self.device]
        words = {d: upload_stream(data, d) for d in distinct(targets)}
        # Every shard's parameters go up before any launch (a copy from
        # pageable memory waits for the device's queue), then every shard
        # is launched before any is fetched, so the devices work on later
        # shards while the host places earlier ones.
        work = []
        for g in groups:
            cuts = shards(len(g.starts), targets)
            work += [(g, lo, hi, d, torch.from_numpy(g.meta[lo:hi]).to(d))
                     for d, lo, hi in cuts]
            if self.devices is not None:
                record_cut(self.stats, cuts)
        outs = [decode_blocks(words[d], meta, header.offset_lshift, n=g.n,
                              C=header.num_channels, M=g.M, W=g.W,
                              has_ltp=g.has_ltp)
                for g, _, _, d, meta in work]
        for (g, lo, hi, _, _), out in zip(work, outs):
            _place(pcm, g.starts[lo:hi], out.cpu().numpy())
            self.stats["device_blocks"] += hi - lo
        return header, pcm

    def decode_whole_device_resident(self, data: bytes,
                                     expected) -> tuple[bool, dict]:
        """Decode a whole .srl stream, keep its PCM on the device and
        verify it there (``srla_tpu``'s decode to device-resident PCM).

        expected: (expected_dev, expected_np), the same (C, N) int32 PCM as
        a tensor (sent once to each decoding device other than its own) and
        as a host array. Each COMPRESS group (each shard, given
        ``devices``) is decoded as in ``decode_whole`` and compared with
        its spans of expected_dev by kernel K13 (``kernels.verify``); its
        PCM is neither fetched nor kept. RAW and SILENT blocks are compared
        on the host with expected_np. Every shard is launched before the
        flags are read, in one copy a device. Returns (lossless, stats).
        """
        header = decode_header(data)
        C, N = header.num_channels, header.num_samples
        expected_dev, expected_np = expected
        if not isinstance(expected_dev, torch.Tensor) \
                or expected_dev.dtype != torch.int32 \
                or tuple(expected_dev.shape) != (C, N):
            raise ValueError(f"expected_dev must be a ({C}, {N}) int32 "
                             f"tensor, got {type(expected_dev).__name__} "
                             f"{getattr(expected_dev, 'dtype', None)} "
                             f"{tuple(getattr(expected_dev, 'shape', ()))}")
        expected_np = np.asarray(expected_np)
        if expected_np.dtype != np.int32 or expected_np.shape != (C, N):
            raise ValueError(f"expected_np must be a ({C}, {N}) int32 array, "
                             f"got {expected_np.dtype} {expected_np.shape}")
        if N >= 2 ** 31:
            raise ValueError(f"{N} samples: the verify's starts are int32")
        host_spans: list = []
        header, pcm, groups = self.plan(data, host_spans)
        targets = self.devices or [self.device]
        words = {d: upload_stream(data, d) for d in distinct(targets)}
        want = {d: expected_dev.to(d).contiguous() for d in words}
        # Each shard's parameters and block starts go up in one copy, all
        # before any launch (a copy from pageable memory waits for the
        # device's queue).
        work = []
        for g in groups:
            cuts = shards(len(g.starts), targets)
            for d, lo, hi in cuts:
                meta = g.meta[lo:hi]
                host = np.concatenate([meta.ravel(),
                                       g.starts[lo:hi].astype(np.int32)])
                up = torch.from_numpy(host).to(d)
                work.append((g, hi - lo, d, up[:meta.size].view(meta.shape),
                             up[meta.size:]))
            if self.devices is not None:
                record_cut(self.stats, cuts)
        flags: dict = {d: [] for d in words}
        covered = 0
        # A shard's PCM is dropped once its K13 is queued behind it, so the
        # allocator reuses it for the next shard on that stream.
        for g, B, d, meta, starts in work:
            out = decode_blocks(words[d], meta, header.offset_lshift, n=g.n,
                                C=C, M=g.M, W=g.W, has_ltp=g.has_ltp)
            okrows = torch.ones(B, dtype=torch.bool, device=d)
            flags[d].append(verify_blocks(out, want[d], starts, okrows,
                                          n=g.n, B=B))
            covered += B * g.n
            self.stats["device_blocks"] += B
        host_ok = all(np.array_equal(pcm[:, s:s + ln],
                                     expected_np[:, s:s + ln])
                      for s, ln in host_spans)
        covered += sum(ln for _, ln in host_spans)
        # One copy a device: its groups' flags folded there, then fetched.
        device_ok = True
        for f in flags.values():
            if f and device_ok:
                device_ok = bool(torch.stack(f).all().item())
        return device_ok and host_ok and covered >= N, dict(self.stats)

    def decode_block(self, data: bytes, header: StreamHeader, offset: int = 0
                     ) -> tuple[np.ndarray, int]:
        """Decode the framed block at ``offset`` -> (PCM (C, n) int32,
        consumed bytes). Sync, size and checksum are verified
        (SRLADecoder_DecodeBlock); a SILENT block gives zeros, a RAW block
        is read on the host, and a COMPRESS block is decoded on the device
        as a group of one (K2, K1, and K9 when it carries LTP), counted in
        ``stats["device_blocks"]``."""
        btype, nsamples, poff, psize = parse_block_header(
            data, offset, self.check_checksum)
        consumed = (poff - offset) + psize
        if btype == BlockDataType.SILENT:
            return np.zeros((header.num_channels, nsamples), np.int32), \
                consumed
        if btype == BlockDataType.RAW:
            return self._host.decode_raw_block(data[poff:poff + psize],
                                               header, nsamples), consumed
        # Only the payload's words go up: from the word that holds its first
        # byte, so its bit offsets are those of the whole stream's decode.
        base = poff - poff % 4
        window = data[base:poff + psize]
        g = self._groups(window, header, np.zeros(1, np.int64), [nsamples],
                         np.asarray([poff - base], np.int64),
                         np.asarray([psize], np.int64))[0]
        out = decode_blocks(upload_stream(window, self.device),
                            torch.from_numpy(g.meta).to(self.device),
                            header.offset_lshift, n=nsamples,
                            C=header.num_channels, M=g.M, W=g.W,
                            has_ltp=g.has_ltp)
        self.stats["device_blocks"] += 1
        return out[0].cpu().numpy(), consumed

    def decode_block_params(self, payload: bytes, header: StreamHeader,
                            num_samples: int):
        """The host one-block reference's entropy decode
        (``host_decoder.SRLADecoder.decode_block_params``)."""
        return self._host.decode_block_params(payload, header, num_samples)

    def synthesize_block(self, bp, header: StreamHeader,
                         num_samples: int) -> np.ndarray:
        """The host one-block reference's synthesis chain
        (``host_decoder.SRLADecoder.synthesize_block``)."""
        return self._host.synthesize_block(bp, header, num_samples)

    def decode_raw_block(self, payload: bytes, header: StreamHeader,
                         num_samples: int) -> np.ndarray:
        return self._host.decode_raw_block(payload, header, num_samples)

    def plan(self, data: bytes, host_spans: list | None = None
             ) -> tuple[StreamHeader, np.ndarray, list[DecodeGroup]]:
        """Host part of the decode: walk and checksum the block headers,
        decode RAW/SILENT blocks into a fresh PCM array, batch-parse the
        COMPRESS parameter headers and group those blocks by size.
        Returns (header, pcm, groups); ``host_spans``, where given, receives
        (first sample, length) of every RAW and SILENT block."""
        header = decode_header(data)
        C, N = header.num_channels, header.num_samples
        pcm = np.zeros((C, N), dtype=np.int32)
        offset = HEADER_SIZE
        progress = 0
        progs, sizes, poffs, psizes = [], [], [], []
        while progress < N and offset < len(data):
            btype, nsamples, poff, psize = parse_block_header(
                data, offset, self.check_checksum)
            if btype == BlockDataType.RAW:
                pcm[:, progress:progress + nsamples] = \
                    self._host.decode_raw_block(data[poff:poff + psize],
                                                header, nsamples)
            elif btype == BlockDataType.COMPRESS:
                progs.append(progress)
                sizes.append(nsamples)
                poffs.append(poff)
                psizes.append(psize)
            if btype != BlockDataType.COMPRESS and host_spans is not None:
                host_spans.append((progress, nsamples))
            offset = poff + psize
            progress += nsamples
        if not progs:
            return header, pcm, []
        return header, pcm, self._groups(
            data, header, np.asarray(progs, np.int64), sizes,
            np.asarray(poffs, np.int64), np.asarray(psizes, np.int64))

    def _groups(self, data: bytes, header: StreamHeader, progs, sizes,
                poffs, psizes) -> list[DecodeGroup]:
        """Batch-parse the COMPRESS parameter headers of the payloads at
        poffs in data and group those blocks by size (first samples
        progs, lengths sizes)."""
        C = header.num_channels
        pp = self._parse_params_batch(data, poffs, psizes, header)
        by_size: dict[int, list] = {}
        for b, n in enumerate(sizes):
            by_size.setdefault(n, []).append(b)
        groups = []
        for n, idxs in by_size.items():
            sel = np.asarray(idxs)
            abs_bits = poffs[sel] * 8 + pp["start_bits"][sel].astype(np.int64)
            M = max(int(pp["orders"][sel].max()), 1)
            meta = pack_meta(pp, sel, (abs_bits >> 5).astype(np.int32),
                             (abs_bits & 31).astype(np.int32), len(sel), C,
                             M, MAX_LTP_ORDER)
            groups.append(DecodeGroup(
                starts=progs[sel], n=n, M=M,
                W=max(int(-(-psizes[sel].max() // 4)), 1),
                has_ltp=bool((pp["ltp_periods"][sel] > 0).any()), meta=meta))
        return groups

    def _parse_params_batch(self, data: bytes, poffs: np.ndarray,
                            psizes: np.ndarray, header: StreamHeader) -> dict:
        """Parameter headers of the COMPRESS payloads at poffs -> dict of
        (B[, C][, .]) arrays plus 'start_bits', the bit offset of channel
        0's residual section in each payload (as in srla_tpu)."""
        C = header.num_channels
        native = self._host._native
        if native is not None:
            return native.parse_params_batch(
                data, poffs, psizes, C, header.bits_per_sample,
                max_coef=MAX_COEFFICIENT_ORDER)
        B = len(poffs)
        pp = {k: np.zeros((B, C), np.int32) for k in
              ("pre_prev", "pre_coef", "orders", "rshifts", "ltp_orders",
               "ltp_periods")}
        pp["method"] = np.zeros(B, np.int32)
        pp["coefs"] = np.zeros((B, C, MAX_COEFFICIENT_ORDER), np.int32)
        pp["ltp_coefs"] = np.zeros((B, C, 8), np.int32)
        pp["start_bits"] = np.zeros(B, np.int64)
        for b, (po, ps) in enumerate(zip(poffs, psizes)):
            bp, r = self._host._parse_params(data[po:po + ps], header)
            pp["method"][b] = bp.method
            for k in ("pre_prev", "pre_coef", "orders", "rshifts",
                      "ltp_orders", "ltp_periods", "ltp_coefs"):
                pp[k][b] = getattr(bp, k)
            pp["coefs"][b] = bp.coefs[:, :MAX_COEFFICIENT_ORDER]
            pp["start_bits"][b] = r.pos
        return pp


def decode(data: bytes, device, check_checksum: bool = True
           ) -> tuple[StreamHeader, np.ndarray]:
    """Decode a .srl stream on ``device`` -> (header, PCM (C, N) int32)."""
    return SRLADecoder(device, check_checksum).decode_whole(data)
