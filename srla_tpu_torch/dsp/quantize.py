"""LPC coefficient quantization with backward error feedback (batched).

Dynamic right shift chosen from frexp of the max |coef| so values fit signed
8-bit; quantization runs from the last coefficient backwards, feeding the
rounding error into the next (earlier) coefficient.
(Parity: libs/lpc/src/lpc.c:1341-1405.)

The port's own copy of ``srla_tpu/dsp/quantize.py``.
"""

from __future__ import annotations

import numpy as np


def _round_c(x: np.ndarray) -> np.ndarray:
    return np.where(x >= 0.0, np.floor(x + 0.5), -np.floor(-x + 0.5))


def quantize_coefficients(coefs: np.ndarray, orders: np.ndarray,
                          nbits_precision: int, max_bits: int):
    """coefs: (B, maxorder) f64 left-aligned; orders: (B,) int.

    Returns (int_coefs (B, maxorder) int32 left-aligned, rshift (B,) int32).
    Blocks with order 0 get rshift 0 (callers skip them anyway).
    """
    B, maxorder = coefs.shape
    qmax = 1 << (nbits_precision - 1)
    mask = np.arange(maxorder)[None, :] < orders[:, None]
    absc = np.where(mask, np.abs(coefs), 0.0)
    maxabs = absc.max(axis=1)

    # Degenerate: too small to represent -> all zero, rshift = nbits_precision.
    tiny = maxabs <= 2.0 ** (-(nbits_precision - 1))

    _, ndigit = np.frexp(maxabs)
    rshift = (nbits_precision - 1) - ndigit
    # Negative raw shift wraps to a huge unsigned value upstream -> clamp too.
    rshift = np.where((rshift >= max_bits) | (rshift < 0), max_bits - 1, rshift)
    rshift = np.where(tiny, nbits_precision, rshift).astype(np.int64)

    scale = np.ldexp(1.0, rshift)  # 2**rshift, exact
    int_coefs = np.zeros((B, maxorder), dtype=np.int32)
    qerror = np.zeros(B)
    # Backward pass over coefficient index; per-block active when ord < order.
    for ordi in range(maxorder - 1, -1, -1):
        active = orders > ordi
        if not active.any():
            continue
        qe = qerror + coefs[:, ordi] * scale
        qtmp = _round_c(qe)
        qtmp = np.clip(qtmp, -qmax, qmax - 1)
        new_err = qe - qtmp
        qerror = np.where(active, new_err, qerror)
        int_coefs[:, ordi] = np.where(active, qtmp, 0).astype(np.int32)
    int_coefs[tiny] = 0
    return int_coefs, rshift.astype(np.int32)
