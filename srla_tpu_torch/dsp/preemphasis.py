"""Pre-emphasis filter, batched over blocks.

Coefficient estimation is an order-1 normalized autocorrelation in f64; the
running sums are order-sensitive in general, but all inputs are int32, so when
the exact integer sums stay below 2^53 every partial sum is exactly
representable and any summation order gives the bit-identical double. We take
that fast path and fall back to a sequential scan otherwise (24-bit content).
(Parity: libs/srla_internal/src/srla_utility.c:206-378.)

The port's own copy of ``srla_tpu/dsp/preemphasis.py``. Its de-emphasis
serves only the host one-block reference (``host_decoder``): the port's
decode runs it on the device.
"""

from __future__ import annotations

import numpy as np

from ..constants import PREEMPHASIS_COEF_SHIFT

_EXACT_LIMIT = float(1 << 53)


def _round_c(x: np.ndarray) -> np.ndarray:
    """C round semantics: half away from zero."""
    return np.where(x >= 0.0, np.floor(x + 0.5), -np.floor(-x + 0.5))


def calculate_coefficient(data: np.ndarray, num_samples: int) -> np.ndarray:
    """data: (B, n) int32. Returns (B,) int coefficient in [-16, 15].

    Replicates the reference accumulation pattern: r0 spans all n samples,
    r1 spans lags (0..n-2)x(1..n-1).
    """
    from .. import native_decoder
    if native_decoder.available():
        return native_decoder.preemph_coef_batch(data, num_samples)
    d = data[:, :num_samples].astype(np.float64)
    x = data[:, :num_samples].astype(np.int64)
    ir0 = (x * x).sum(axis=1)
    ir1 = (x[:, :-1] * x[:, 1:]).sum(axis=1)
    exact = (np.abs(ir0) < _EXACT_LIMIT) & (np.abs(ir1) < _EXACT_LIMIT)
    r0 = ir0.astype(np.float64)
    r1 = ir1.astype(np.float64)
    if not exact.all():
        # Sequential f64 accumulation for blocks whose sums exceed 2^53.
        for b in np.flatnonzero(~exact):
            acc0 = 0.0
            acc1 = 0.0
            row = d[b]
            for i in range(num_samples - 1):
                acc0 += row[i] * row[i]
                acc1 += row[i] * row[i + 1]
            acc0 += row[-1] * row[-1]
            r0[b] = acc0
            r1[b] = acc1
    coef = np.zeros(data.shape[0], dtype=np.int32)
    ok = r0 >= 1e-6
    with np.errstate(divide="ignore", invalid="ignore"):
        dc = r1 / r0
    q = _round_c(dc * float(1 << PREEMPHASIS_COEF_SHIFT))
    q = np.clip(q, -(1 << PREEMPHASIS_COEF_SHIFT), (1 << PREEMPHASIS_COEF_SHIFT) - 1)
    coef[ok] = q[ok].astype(np.int32)
    return coef


def preemphasis(data: np.ndarray, coef: np.ndarray, prev: np.ndarray) -> np.ndarray:
    """y[i] = x[i] - ((x[i-1]*coef) >> 4), x[-1] = prev.  (B, n) int32 -> int32."""
    from .. import native_decoder
    if native_decoder.available():
        return native_decoder.preemphasis_batch(data, coef, prev)
    x = data.astype(np.int64)
    shifted = np.empty_like(x)
    shifted[:, 0] = prev.astype(np.int64)
    shifted[:, 1:] = x[:, :-1]
    pred = (shifted * coef[:, None].astype(np.int64))
    pred = (pred.astype(np.int32) >> PREEMPHASIS_COEF_SHIFT)
    with np.errstate(over="ignore"):
        return (data.astype(np.int32) - pred).astype(np.int32)


def deemphasis(data: np.ndarray, coef: np.ndarray, prev: np.ndarray) -> np.ndarray:
    """Inverse filter: y[i] = x[i] + ((y[i-1]*coef) >> 4), y[-1] = prev (sequential)."""
    B, n = data.shape
    out = data.astype(np.int32).copy()
    c = coef.astype(np.int32)
    y_prev = prev.astype(np.int32)
    with np.errstate(over="ignore"):
        for i in range(n):
            out[:, i] = out[:, i] + ((y_prev * c) >> PREEMPHASIS_COEF_SHIFT)
            y_prev = out[:, i]
    return out
