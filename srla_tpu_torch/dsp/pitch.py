"""Pitch detection and long-term-prediction coefficient solve.

Scalar (per block-channel) implementations preserving exact f64 op order.
(Parity: libs/lpc/src/lpc.c:1473-1649.)

The port's own copy of ``srla_tpu/dsp/pitch.py``.
"""

from __future__ import annotations

import math

import numpy as np

MAX_NUM_PITCH_CANDIDATES = 20
PITCH_AUTOCORR_THRESHOLD = 0.1
PITCH_RATIO_VS_MAX_THRESHOLD = 0.9
FLT_MIN = 1.1754943508222875e-38


def cholesky_decompose(A: np.ndarray, dim: int):
    """In-place lower-triangular factorization; returns inv_diag or None if
    singular. inv_diag[i] = pow(sum, -0.5) (libm pow, matching the reference).
    """
    inv_diag = np.zeros(dim)
    for i in range(dim):
        s = A[i, i]
        for k in range(i - 1, -1, -1):
            s -= A[i, k] * A[i, k]
        if s <= 0.0:
            return None
        inv_diag[i] = math.pow(s, -0.5)
        for j in range(i + 1, dim):
            s = A[i, j]
            for k in range(i - 1, -1, -1):
                s -= A[i, k] * A[j, k]
            A[j, i] = s * inv_diag[i]
    return inv_diag


def cholesky_solve(A: np.ndarray, dim: int, b: np.ndarray,
                   inv_diag: np.ndarray) -> np.ndarray:
    x = np.zeros(dim)
    for i in range(dim):
        s = b[i]
        for j in range(i - 1, -1, -1):
            s -= A[i, j] * x[j]
        x[i] = s * inv_diag[i]
    for i in range(dim - 1, -1, -1):
        s = x[i]
        for j in range(i + 1, dim):
            s -= A[j, i] * x[j]
        x[i] = s * inv_diag[i]
    return x


def detect_pitch(auto_corr: np.ndarray, min_period: int, max_period: int):
    """Zero-crossing-bracketed peak scan. Returns period or None."""
    ac = auto_corr
    max_peak = 0.0
    candidates = []
    i = min_period
    while i < max_period and len(candidates) < MAX_NUM_PITCH_CANDIDATES:
        start = i
        while start < max_period:
            if ac[start - 1] < 0.0 and ac[start] > 0.0:
                break
            start += 1
        end = start + 1
        while end < max_period - 1:
            if ac[end] > 0.0 and ac[end + 1] < 0.0:
                break
            end += 1
        local_peak_index = 0
        local_peak = 0.0
        for j in range(start, end + 1):
            if ac[j] > ac[j - 1] and ac[j] > ac[j + 1]:
                if ac[j] > local_peak:
                    local_peak_index = j
                    local_peak = ac[j]
        if local_peak_index != 0:
            candidates.append(local_peak_index)
            if local_peak > max_peak:
                max_peak = local_peak
        i = end + 1
    if not candidates:
        return None
    if max_peak < PITCH_AUTOCORR_THRESHOLD * ac[0]:
        return None
    for cand in candidates:
        if ac[cand] >= PITCH_RATIO_VS_MAX_THRESHOLD * max_peak:
            return cand
    return None


def calculate_ltp_coefficients(auto_corr: np.ndarray, coef_order: int,
                               min_period: int, max_period: int,
                               ridge: float):
    """Returns (coef (order,), period) or (None, 0) when no usable pitch.

    auto_corr must hold lags 0..max_period (window/FFT already applied by the
    caller). The lag-0 value is ridge-regularized in place, as upstream does.
    """
    if abs(auto_corr[0]) <= FLT_MIN:
        return None, 0
    period = detect_pitch(auto_corr, min_period, max_period)
    if period is None:
        return None, 0
    if period < (coef_order // 2) + 1:
        return None, 0
    auto_corr[0] *= (1.0 + ridge)
    A = np.empty((coef_order, coef_order))
    for j in range(coef_order):
        for k in range(j, coef_order):
            A[j, k] = A[k, j] = auto_corr[abs(j - k)]
    inv_diag = cholesky_decompose(A, coef_order)
    if inv_diag is None:
        return None, 0
    rhs = auto_corr[period - coef_order // 2: period - coef_order // 2 + coef_order]
    coef = cholesky_solve(A, coef_order, rhs, inv_diag)
    return coef, period
