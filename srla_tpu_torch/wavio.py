"""Minimal WAV read/write <-> int32 channel planes.

Samples are held at their natural bit depth (16-bit -> [-32768, 32767]); 8-bit
WAV is offset-binary (stored value - 128). Matches the reference tool's PCM
conventions (libs/wav/src/wav.c:841-866) so golden comparisons are byte-true.

The port's own copy of ``srla_tpu/wavio.py``: WAV and AIFF in and out.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class WavData:
    pcm: np.ndarray          # (channels, num_samples) int32
    sampling_rate: int
    bits_per_sample: int


def read_audio(path: str) -> WavData:
    """Read WAV or AIFF into int32 channel planes."""
    with open(path, "rb") as f:
        head = f.read(12)
    if head[:4] == b"FORM" and head[8:12] in (b"AIFF", b"AIFC"):
        return read_aiff(path)
    return read_wav(path)


def read_aiff(path: str) -> WavData:
    """AIFF (big-endian PCM) -> int32 channel planes."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"FORM" or raw[8:12] not in (b"AIFF", b"AIFC"):
        raise ValueError("not an AIFF file")
    pos = 12
    comm = None
    ssnd = None
    while pos + 8 <= len(raw):
        cid = raw[pos:pos + 4]
        size = struct.unpack_from(">I", raw, pos + 4)[0]
        body = raw[pos + 8: pos + 8 + size]
        if cid == b"COMM":
            comm = body
        elif cid == b"SSND":
            off = struct.unpack_from(">I", body, 0)[0]
            ssnd = body[8 + off:]
        pos += 8 + size + (size & 1)
    if comm is None or ssnd is None:
        raise ValueError("missing COMM/SSND chunk")
    nch, nframes, bps = struct.unpack_from(">hIh", comm)
    # 80-bit IEEE extended sampling rate.
    exp = struct.unpack_from(">H", comm, 8)[0]
    mant = struct.unpack_from(">Q", comm, 10)[0]
    rate = int(round(mant * 2.0 ** (int(exp & 0x7FFF) - 16383 - 63)))
    nbytes = (bps + 7) // 8
    buf = np.frombuffer(ssnd[:nframes * nch * nbytes], dtype=np.uint8)
    buf = buf.reshape(nframes, nch, nbytes)
    val = np.zeros((nframes, nch), dtype=np.int64)
    for b in range(nbytes):
        val = (val << 8) | buf[:, :, b].astype(np.int64)
    sign = np.int64(1) << (8 * nbytes - 1)
    pcm = ((val ^ sign) - sign) >> (8 * nbytes - bps)
    return WavData(pcm.T.astype(np.int32).copy(), rate, bps)


def read_wav(path: str) -> WavData:
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        cid = raw[pos:pos + 4]
        size = struct.unpack_from("<I", raw, pos + 4)[0]
        body = raw[pos + 8: pos + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise ValueError("missing fmt/data chunk")
    # Format-tag handling mirrors WAVParser_ParseWAVFormat (wav.c:136-215):
    # fmt size 16 = PCMWAVEFORMAT (tag must be 1), 40 = WAVEFORMATEXTENSIBLE
    # (tag must be 0xFFFE, cbSize 22); we additionally accept the common
    # 18-byte WAVEFORMATEX with tag 1 / cbSize 0, and verify the extensible
    # subformat GUID is integer PCM so float WAVs are rejected, not misread.
    if len(fmt) not in (16, 18, 40):
        raise ValueError(f"unsupported fmt chunk size {len(fmt)}")
    (tag, nch, rate, _brate, _balign, bps) = struct.unpack_from("<HHIIHH", fmt)
    if len(fmt) == 40:
        if tag != 0xFFFE:
            raise ValueError("extensible fmt chunk with non-extensible tag")
        cb_size, _valid_bits, _chan_mask = struct.unpack_from("<HHI", fmt, 16)
        if cb_size != 22:
            raise ValueError("malformed WAVEFORMATEXTENSIBLE fmt chunk")
        guid = fmt[24:40]
        pcm_guid = (b"\x01\x00\x00\x00\x00\x00\x10\x00"
                    b"\x80\x00\x00\xaa\x00\x38\x9b\x71")
        if guid != pcm_guid:
            raise ValueError("unsupported WAV subformat (not integer PCM)")
    elif tag != 1:
        raise ValueError(f"unsupported WAV format tag {tag} (PCM only)")
    if bps not in (8, 16, 24, 32) or nch == 0:
        raise ValueError(f"unsupported WAV layout ({bps}-bit, {nch} ch)")
    nbytes = bps // 8
    n = len(data) // (nbytes * nch)
    buf = np.frombuffer(data[:n * nbytes * nch], dtype=np.uint8)
    buf = buf.reshape(n, nch, nbytes)
    val = np.zeros((n, nch), dtype=np.int64)
    for b in range(nbytes):
        val |= buf[:, :, b].astype(np.int64) << (8 * b)
    if bps == 8:
        pcm = val - 128
    else:
        sign = np.int64(1) << (bps - 1)
        pcm = (val ^ sign) - sign
    return WavData(pcm.T.astype(np.int32).copy(), rate, bps)


def write_aiff(path: str, wav: WavData) -> None:
    """Write AIFF (big-endian PCM, 80-bit extended sample rate)."""
    pcm = wav.pcm
    nch, n = pcm.shape
    nbytes = wav.bits_per_sample // 8
    inter = pcm.T.astype(np.int64) & ((np.int64(1) << (8 * nbytes)) - 1)
    out = np.zeros((n, nch, nbytes), dtype=np.uint8)
    for b in range(nbytes):
        out[:, :, b] = (inter >> (8 * (nbytes - 1 - b))) & 0xFF
    payload = out.tobytes()
    # 80-bit extended float for the sample rate.
    rate = wav.sampling_rate
    exp = 16383 + 63
    mant = rate
    while mant < (1 << 63):
        mant <<= 1
        exp -= 1
    comm = struct.pack(">hIhHQ", nch, n, wav.bits_per_sample, exp, mant)
    ssnd = struct.pack(">II", 0, 0) + payload
    size = 4 + (8 + len(comm)) + (8 + len(ssnd))
    with open(path, "wb") as f:
        f.write(b"FORM" + struct.pack(">I", size) + b"AIFF")
        f.write(b"COMM" + struct.pack(">I", len(comm)) + comm)
        f.write(b"SSND" + struct.pack(">I", len(ssnd)) + ssnd)
        if len(ssnd) & 1:
            f.write(b"\x00")


def write_wav(path: str, wav: WavData) -> None:
    pcm = wav.pcm
    nch, n = pcm.shape
    nbytes = wav.bits_per_sample // 8
    inter = pcm.T.astype(np.int64)
    if wav.bits_per_sample == 8:
        inter = (inter + 128) & 0xFF
    else:
        inter = inter & ((np.int64(1) << wav.bits_per_sample) - 1)
    out = np.zeros((n, nch, nbytes), dtype=np.uint8)
    for b in range(nbytes):
        out[:, :, b] = (inter >> (8 * b)) & 0xFF
    payload = out.tobytes()
    with open(path, "wb") as f:
        byte_rate = wav.sampling_rate * nch * nbytes
        f.write(b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, nch, wav.sampling_rate,
                                      byte_rate, nch * nbytes,
                                      wav.bits_per_sample))
        f.write(b"data" + struct.pack("<I", len(payload)))
        f.write(payload)
