"""The host side of the port's decoder: RAW payloads, parameter headers and
the host one-block reference.

The port's own copy of ``srla_tpu/decoder.py``'s host decoder (:91-240):
``decode_raw_block`` and ``_parse_params`` (the Python parameter-header
parser, for hosts where the native library does not build), which the
device decoder uses, and the handle of the native library, whose
``parse_params_batch`` parses every header of a stream in one call. Then
the host one-block reference, ``decode_block_params`` (:130, the entropy
decode) and ``synthesize_block`` (:187, the integer synthesis chain):
sequential numpy, what the device decode of a block is held to in the
tests, never on a device path.

``decode`` is the port's host decode of a whole stream, the counterpart of
``srla_tpu.decode`` (``srla_tpu/decoder.py:282-306``): the native library's
``decode_stream`` where it builds, else a walk over the blocks with the
one-block reference. ``decode_block`` decodes one COMPRESS payload on the
host the same way. Neither touches a device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import native_decoder, rice
from .bitio import BitReader, uint32_to_sint32
from .constants import (HEADER_SIZE, LPC_COEFFICIENT_ORDER_BITWIDTH,
                        LTP_COEFFICIENT_BITWIDTH, LTP_MIN_PERIOD,
                        LTP_ORDER_BITWIDTH, LTP_PERIOD_BITWIDTH,
                        MAX_COEFFICIENT_ORDER, PREEMPHASIS_COEF_SHIFT,
                        RSHIFT_LPC_COEFFICIENT_BITWIDTH, BlockDataType,
                        ChProcessMethod)
from .dsp.predict import lpc_synthesize, ltp_synthesize
from .dsp.preemphasis import deemphasis
from .format import StreamHeader, decode_header, parse_block_header
from .huffman import parameter_codebook, sum_parameter_codebook


@dataclass
class _BlockParams:
    method: int
    pre_prev: np.ndarray
    pre_coef: np.ndarray
    orders: np.ndarray
    rshifts: np.ndarray
    coefs: np.ndarray
    ltp_orders: np.ndarray
    ltp_periods: np.ndarray
    ltp_coefs: np.ndarray
    residual: np.ndarray | None = None   # (C, n) int32, decode_block_params'


class SRLADecoder:
    def __init__(self):
        self._param_cb = parameter_codebook()
        self._sum_cb = sum_parameter_codebook()
        # The native library's module where it builds, else None (callers
        # then parse each header with _parse_params).
        self._native = native_decoder if native_decoder.available() else None

    def _parse_params(self, payload: bytes, header: StreamHeader
                      ) -> tuple[_BlockParams, BitReader]:
        """Parse the parameter header of a compress payload; the returned
        reader is positioned at the first channel's residual section."""
        C = header.num_channels
        r = BitReader(payload)
        method = r.get(2)
        pre_prev = np.zeros(C, dtype=np.int32)
        pre_coef = np.zeros(C, dtype=np.int32)
        for c in range(C):
            pre_prev[c] = uint32_to_sint32(
                np.uint32(r.get(header.bits_per_sample + 1)))
            pre_coef[c] = uint32_to_sint32(
                np.uint32(r.get(PREEMPHASIS_COEF_SHIFT + 1)))
        orders = np.zeros(C, dtype=np.int32)
        rshifts = np.zeros(C, dtype=np.int32)
        coefs = np.zeros((C, MAX_COEFFICIENT_ORDER), dtype=np.int32)
        for c in range(C):
            o = r.get(LPC_COEFFICIENT_ORDER_BITWIDTH)
            orders[c] = o
            rshifts[c] = r.get(RSHIFT_LPC_COEFFICIENT_BITWIDTH)
            use_sum = r.get(1)
            if not use_sum:
                for i in range(o):
                    coefs[c, i] = uint32_to_sint32(
                        np.uint32(self._param_cb.decode_one(r)))
            elif o > 0:
                coefs[c, 0] = uint32_to_sint32(
                    np.uint32(self._param_cb.decode_one(r)))
                for i in range(1, o):
                    v = uint32_to_sint32(np.uint32(self._sum_cb.decode_one(r)))
                    coefs[c, i] = np.int32(int(v) - int(coefs[c, i - 1]))
        ltp_orders = np.zeros(C, dtype=np.int32)
        ltp_periods = np.zeros(C, dtype=np.int32)
        ltp_coefs = np.zeros((C, 8), dtype=np.int32)
        for c in range(C):
            if r.get(1):
                ltp_orders[c] = 2 * r.get(LTP_ORDER_BITWIDTH) + 1
                ltp_periods[c] = r.get(LTP_PERIOD_BITWIDTH) + LTP_MIN_PERIOD
                for i in range(ltp_orders[c]):
                    ltp_coefs[c, i] = uint32_to_sint32(
                        np.uint32(r.get(LTP_COEFFICIENT_BITWIDTH)))
        return _BlockParams(method, pre_prev, pre_coef, orders, rshifts,
                            coefs, ltp_orders, ltp_periods, ltp_coefs), r

    def decode_raw_block(self, payload: bytes, header: StreamHeader,
                         num_samples: int) -> np.ndarray:
        C = header.num_channels
        bps = header.bits_per_sample
        nbytes = bps // 8
        buf = np.frombuffer(payload[:num_samples * C * nbytes], dtype=np.uint8)
        buf = buf.reshape(num_samples, C, nbytes)
        uv = np.zeros((num_samples, C), dtype=np.uint32)
        for i in range(nbytes):
            uv = (uv << 8) | buf[:, :, i].astype(np.uint32)
        return uint32_to_sint32(uv).T.astype(np.int32).copy()

    def decode_block_params(self, payload: bytes, header: StreamHeader,
                            num_samples: int) -> _BlockParams:
        """Entropy-decode one compress-block payload into parameters and
        residuals."""
        C = header.num_channels
        bp, r = self._parse_params(payload, header)
        residual = np.zeros((C, num_samples), dtype=np.int32)
        for c in range(C):
            residual[c] = rice.decode(r, num_samples)
        bp.residual = residual
        return bp

    def synthesize_block(self, bp: _BlockParams, header: StreamHeader,
                         num_samples: int) -> np.ndarray:
        """Run the integer reconstruction chain for one decoded block."""
        buf = lpc_synthesize(bp.residual, bp.coefs, bp.orders, bp.rshifts,
                             num_samples)
        buf = ltp_synthesize(buf, bp.ltp_coefs, bp.ltp_orders, bp.ltp_periods,
                             LTP_COEFFICIENT_BITWIDTH - 1)
        buf = deemphasis(buf, bp.pre_coef, bp.pre_prev)
        with np.errstate(over="ignore"):
            if bp.method == ChProcessMethod.MS:
                buf[0] = (buf[0] - (buf[1] >> 1)).astype(np.int32)
                buf[1] = (buf[1] + buf[0]).astype(np.int32)
            elif bp.method == ChProcessMethod.LS:
                buf[1] = (buf[1] + buf[0]).astype(np.int32)
            elif bp.method == ChProcessMethod.SR:
                buf[0] = (buf[1] - buf[0]).astype(np.int32)
            if header.offset_lshift:
                buf = (buf << header.offset_lshift).astype(np.int32)
        return buf


def decode_block(payload: bytes, header: StreamHeader,
                 num_samples: int) -> np.ndarray:
    """One COMPRESS payload decoded on the host -> (C, n) int32 PCM: the
    native ``decode_block`` where the library builds, else
    ``decode_block_params`` and ``synthesize_block``."""
    if native_decoder.available():
        return native_decoder.decode_block(
            payload, header.num_channels, header.bits_per_sample,
            num_samples, header.offset_lshift)
    dec = SRLADecoder()
    return dec.synthesize_block(
        dec.decode_block_params(payload, header, num_samples), header,
        num_samples)


def decode(data: bytes, check_checksum: bool = True
           ) -> tuple[StreamHeader, np.ndarray]:
    """Decode a whole .srl stream on the host -> (header, (C, N) int32
    PCM), ``srla_tpu.decode(data)``'s result: the native whole-stream
    decode where the library builds, else the block walk of
    ``srla_tpu/decoder.py:289-306``. A checksum mismatch (with
    ``check_checksum``) or a stream cut inside a block raises ValueError; a
    stream cut at a block boundary leaves the missing tail silent."""
    header = decode_header(data)
    C, N = header.num_channels, header.num_samples
    if native_decoder.available():
        return header, native_decoder.decode_stream(
            data[HEADER_SIZE:], C, header.bits_per_sample, N,
            header.offset_lshift, check_checksum)
    dec = SRLADecoder()
    pcm = np.zeros((C, N), dtype=np.int32)
    offset = HEADER_SIZE
    progress = 0
    while progress < N and offset < len(data):
        btype, nsamples, poff, psize = parse_block_header(data, offset,
                                                          check_checksum)
        payload = data[poff:poff + psize]
        if btype == BlockDataType.RAW:
            pcm[:, progress:progress + nsamples] = dec.decode_raw_block(
                payload, header, nsamples)
        elif btype == BlockDataType.COMPRESS:
            pcm[:, progress:progress + nsamples] = decode_block(
                payload, header, nsamples)
        offset = poff + psize
        progress += nsamples
    return header, pcm
