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


def upload_stream(data: bytes, device) -> torch.Tensor:
    """The stream bytes as a little-endian int32 word view on ``device``,
    zero-padded to whole words (the kernels read 0 past the end)."""
    raw = np.frombuffer(data, np.uint8)
    buf = np.zeros((len(raw) + 3) // 4, np.int32)
    buf.view(np.uint8)[:len(raw)] = raw
    return torch.from_numpy(buf).to(device)


class DecodeGroup(NamedTuple):
    """One group of equal-size COMPRESS blocks, ready for the device."""
    starts: np.ndarray   # (B,) first sample of each block in the stream
    n: int               # samples per block
    M: int               # largest LPC order in the group (at least 1)
    W: int               # largest payload in the group, in 32-bit words
    has_ltp: bool        # some block uses long-term prediction
    meta: np.ndarray     # (B, K) int32 parameters, pack_meta layout


class SRLADecoder:
    def __init__(self, device, check_checksum: bool = True):
        """device: the torch device that decodes the COMPRESS blocks
        ("cuda" runs the CUDA kernels, "cpu" their plain versions).
        Parameter headers are parsed by the port's native library
        (``native_decoder``), or in Python where it does not build."""
        self.device = torch.device(device)
        self.check_checksum = check_checksum
        # COMPRESS blocks decoded on the device / on the host, accumulated
        # over decode_whole calls as in srla_tpu. The host count stays 0:
        # nothing is routed to the host.
        self.stats = {"device_blocks": 0, "host_blocks": 0}
        self._host = host_decoder.SRLADecoder()

    def decode_whole(self, data: bytes) -> tuple[StreamHeader, np.ndarray]:
        """Decode a whole .srl stream -> (header, PCM (C, N) int32)."""
        header, pcm, groups = self.plan(data)
        if not groups:
            return header, pcm
        words = upload_stream(data, self.device)
        # Launch every group before fetching any, so the device works on
        # later groups while the host places earlier ones.
        outs = [decode_blocks(words, torch.from_numpy(g.meta).to(self.device),
                              header.offset_lshift, n=g.n,
                              C=header.num_channels, M=g.M, W=g.W,
                              has_ltp=g.has_ltp)
                for g in groups]
        for g, out in zip(groups, outs):
            out = out.cpu().numpy()
            B, C, n = out.shape
            if B > 1 and (np.diff(g.starts) == n).all():
                s0 = int(g.starts[0])
                pcm[:, s0:s0 + B * n] = \
                    out.transpose(1, 0, 2).reshape(C, B * n)
            else:
                for bi, s in enumerate(g.starts):
                    pcm[:, s:s + n] = out[bi]
            self.stats["device_blocks"] += B
        return header, pcm

    def plan(self, data: bytes
             ) -> tuple[StreamHeader, np.ndarray, list[DecodeGroup]]:
        """Host part of the decode: walk and checksum the block headers,
        decode RAW/SILENT blocks into a fresh PCM array, batch-parse the
        COMPRESS parameter headers and group those blocks by size.
        Returns (header, pcm, groups)."""
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
            offset = poff + psize
            progress += nsamples
        if not progs:
            return header, pcm, []
        progs = np.asarray(progs, np.int64)
        poffs = np.asarray(poffs, np.int64)
        psizes = np.asarray(psizes, np.int64)
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
        return header, pcm, groups

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
