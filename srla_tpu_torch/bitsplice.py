"""Fast host-side splicing of device-packed bit sections into payloads.

A packed section is a byte array whose bit 0 is the section start (zero-padded
tail). Splicing shifts it to an arbitrary bit offset and ORs it into the
destination — three vectorized ops per section.

The port's own copy of ``srla_tpu/bitsplice.py``.
"""

from __future__ import annotations

import numpy as np


class PayloadBuilder:
    def __init__(self, capacity_bytes: int):
        self.buf = np.zeros(capacity_bytes, dtype=np.uint8)
        self.bit_pos = 0

    def append_bytes(self, data: bytes, nbits: int) -> None:
        """Append `nbits` from a byte string (its bit 0 = first appended bit)."""
        self.append_array(np.frombuffer(data, dtype=np.uint8), nbits)

    def append_array(self, src: np.ndarray, nbits: int) -> None:
        if nbits == 0:
            return
        s = self.bit_pos & 7
        byte0 = self.bit_pos >> 3
        nsrc = (nbits + 7) >> 3
        src = src[:nsrc]
        out_len = (s + nbits + 7) >> 3
        if s == 0:
            shifted = src
            if shifted.shape[0] < out_len:
                shifted = np.pad(shifted, (0, out_len - shifted.shape[0]))
        else:
            wide = src.astype(np.uint16)
            lo = (wide >> s).astype(np.uint8)
            hi = ((wide << (8 - s)) & 0xFF).astype(np.uint8)
            shifted = np.zeros(out_len, dtype=np.uint8)
            shifted[:lo.shape[0]] |= lo
            shifted[1:hi.shape[0] + 1] |= hi[:out_len - 1]
        # Mask bits beyond nbits in the source tail (callers guarantee the
        # source is zero-padded past nbits, so only the first byte needs OR).
        self.buf[byte0:byte0 + out_len] |= shifted[:out_len]
        self.bit_pos += nbits

    def getvalue(self) -> bytes:
        nbytes = (self.bit_pos + 7) >> 3
        return self.buf[:nbytes].tobytes()
