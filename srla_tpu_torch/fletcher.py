"""Fletcher-16 checksum, vectorized.

Stream-format parity with reference libs/srla_internal/src/srla_utility.c:36-60:
the sums are folded with ``MOD255(x) = (x + x//255) & 0xFF`` every 5802 bytes
(the largest block for which the running sums fit 32 bits).

The port's own copy of ``srla_tpu/fletcher.py``.
"""

from __future__ import annotations

import numpy as np

_BLOCK = 5802

_native = None
_native_tried = False


def _mod255(x: int) -> int:
    return (x + x // 255) & 0xFF


def fletcher16(data: bytes | np.ndarray) -> int:
    global _native, _native_tried
    if not _native_tried:
        _native_tried = True
        try:
            from . import native_decoder
            _native = native_decoder._load()
        except Exception:
            _native = None
    if _native is not None:
        b = bytes(data)
        return int(_native.srla_fletcher16(b, len(b)))
    return _fletcher16_np(data)


def _fletcher16_np(data: bytes | np.ndarray) -> int:
    buf = np.frombuffer(bytes(data), dtype=np.uint8).astype(np.uint64)
    c0, c1 = 0, 0
    for start in range(0, len(buf), _BLOCK):
        chunk = buf[start:start + _BLOCK]
        n = len(chunk)
        s = int(chunk.sum())
        # c1 gains c0 after every byte: sum of prefix sums.
        w = np.arange(n, 0, -1, dtype=np.uint64)
        c1 = _mod255(c1 + n * c0 + int((chunk * w).sum()))
        c0 = _mod255(c0 + s)
    return ((c1 << 8) | c0) & 0xFFFF
