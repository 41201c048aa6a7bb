"""SRLA container: file header and block framing.

Layout (big-endian; parity: srla_encoder/src/srla_encoder.c:85-165 and
srla_decoder/src/srla_decoder.c:63-151):

  File header (30 B): '1249', format_version u32, codec_version u32,
  num_channels u16, num_samples u32, sampling_rate u32, bits_per_sample u16,
  offset_lshift u8, max_num_samples_per_block u32, preset u8.

  Block: sync 0xFFFF u16, block_size u32 (= payload + 5), fletcher16 u16
  (over type..payload), type u8, num_samples u16, payload.

The port's own copy of ``srla_tpu/format.py``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from .constants import (BLOCK_SYNC_CODE, CODEC_VERSION, FORMAT_VERSION,
                        HEADER_SIZE, NUM_PARAMETER_PRESETS, BlockDataType)
from .fletcher import fletcher16

_HEADER_STRUCT = struct.Struct(">4sIIHIIHBIB")


@dataclass
class StreamHeader:
    num_channels: int
    num_samples: int
    sampling_rate: int
    bits_per_sample: int
    offset_lshift: int
    max_num_samples_per_block: int
    preset: int
    format_version: int = FORMAT_VERSION
    codec_version: int = CODEC_VERSION


def encode_header(h: StreamHeader) -> bytes:
    if h.num_channels == 0 or h.num_samples == 0 or h.sampling_rate == 0:
        raise ValueError("invalid header field")
    if h.bits_per_sample == 0 or h.offset_lshift >= 32:
        raise ValueError("invalid header field")
    if h.max_num_samples_per_block == 0 or h.preset >= NUM_PARAMETER_PRESETS:
        raise ValueError("invalid header field")
    return _HEADER_STRUCT.pack(
        b"1249", FORMAT_VERSION, CODEC_VERSION, h.num_channels, h.num_samples,
        h.sampling_rate, h.bits_per_sample, h.offset_lshift,
        h.max_num_samples_per_block, h.preset)


def decode_header(data: bytes) -> StreamHeader:
    if len(data) < HEADER_SIZE:
        raise ValueError("insufficient data")
    sig, fmt_ver, codec_ver, nch, nsmpl, rate, bps, lshift, maxblk, preset = \
        _HEADER_STRUCT.unpack_from(data)
    if sig != b"1249":
        raise ValueError("bad signature")
    if fmt_ver != FORMAT_VERSION or codec_ver != CODEC_VERSION:
        raise ValueError("unsupported version")
    if nch == 0 or nsmpl == 0 or rate == 0 or preset >= NUM_PARAMETER_PRESETS:
        raise ValueError("invalid header field")
    # Mirror SRLADecoder_CheckHeaderFormat (srla_decoder.c:165-178): these
    # fields flow into shift counts and buffer-size math downstream, so an
    # unvalidated header is not just wrong but unsafe (native br.get(bps+1),
    # out[i] << offset_lshift, RAW read size).
    if bps not in (8, 16, 24):
        raise ValueError("invalid header field")
    if lshift >= 32 or maxblk == 0:
        raise ValueError("invalid header field")
    return StreamHeader(nch, nsmpl, rate, bps, lshift, maxblk, preset,
                        fmt_ver, codec_ver)


def frame_block(block_type: BlockDataType, num_samples: int, payload: bytes) -> bytes:
    """Wrap a payload with the 11-byte block header (checksum included)."""
    body = struct.pack(">BH", int(block_type), num_samples) + payload
    checksum = fletcher16(body)
    return (struct.pack(">HIH", BLOCK_SYNC_CODE, len(payload) + 5, checksum)
            + body)


def parse_block_header(data: bytes, offset: int, check_checksum: bool = True):
    """Returns (block_type, num_samples, payload_offset, payload_size)."""
    sync, size, checksum = struct.unpack_from(">HIH", data, offset)
    if sync != BLOCK_SYNC_CODE:
        raise ValueError("sync code mismatch")
    if offset + size + 6 > len(data):
        raise ValueError("insufficient data")
    if check_checksum:
        actual = fletcher16(data[offset + 8: offset + 6 + size])
        if actual != checksum:
            raise ValueError("data corruption detected (checksum mismatch)")
    btype, nsamples = struct.unpack_from(">BH", data, offset + 8)
    return BlockDataType(btype), nsamples, offset + 11, size - 5
