"""Incremental block-by-block decoding (the reference player's API contract).

The port's twin of ``srla_tpu/streaming.py``. Blocks are self-delimiting
and carry all inter-block state in-band, so a stream is decodable from any
retained block offset. Each COMPRESS block is decoded on the device as a
group of one (``decoder.SRLADecoder.decode_block``: K2, K1, and K9 when the
block carries LTP); SILENT and RAW blocks on the host.
(Parity: tools/srla_player/srla_player.c:31-150.)
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from .constants import HEADER_SIZE
from .decoder import SRLADecoder
from .format import StreamHeader, decode_header


class StreamingDecoder:
    """Pull-model decoder: feed a .srl byte buffer, pull PCM block by block."""

    def __init__(self, data: bytes, device, check_checksum: bool = True):
        """device: the torch device that decodes the COMPRESS blocks
        ("cuda" runs the CUDA kernels, "cpu" their plain versions)."""
        self.data = data
        self.header: StreamHeader = decode_header(data)
        self.offset = HEADER_SIZE
        self.progress = 0
        self._dec = SRLADecoder(device, check_checksum=check_checksum)

    @property
    def exhausted(self) -> bool:
        return (self.progress >= self.header.num_samples
                or self.offset >= len(self.data))

    def seek_to_block(self, byte_offset: int, sample_progress: int) -> None:
        """Resume decoding at a previously retained block boundary."""
        self.offset = byte_offset
        self.progress = sample_progress

    def tell(self) -> tuple[int, int]:
        return self.offset, self.progress

    def decode_block(self) -> Optional[np.ndarray]:
        """Decode the next block; returns (C, block_samples) int32 or None."""
        if self.exhausted:
            return None
        out, consumed = self._dec.decode_block(self.data, self.header,
                                               self.offset)
        self.offset += consumed
        self.progress += out.shape[1]
        return out

    def blocks(self) -> Iterator[np.ndarray]:
        while True:
            blk = self.decode_block()
            if blk is None:
                return
            yield blk


def play(path: str, device="cuda") -> None:  # pragma: no cover
    """Minimal player: stream-decode a .srl file to the default audio device
    (requires the optional `sounddevice` package; decode is the demo here)."""
    with open(path, "rb") as f:
        data = f.read()
    dec = StreamingDecoder(data, device)
    try:
        import sounddevice as sd
    except ImportError as e:
        raise RuntimeError("playback requires the 'sounddevice' package; "
                           "use StreamingDecoder for pull-model decode") from e
    scale = 2.0 ** -(dec.header.bits_per_sample - 1)
    with sd.OutputStream(samplerate=dec.header.sampling_rate,
                         channels=dec.header.num_channels) as stream:
        for blk in dec.blocks():
            stream.write((blk.T * scale).astype(np.float32))
