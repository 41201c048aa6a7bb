"""SVR-style LPC coefficient refinement (soft-threshold iterations).

Per margin in the preset list: iterate residual -> soft threshold -> solve for
a coefficient delta via a cached Cholesky factorization of the (ridged) signal
covariance; keep the coefficients minimizing the estimated recursive-Rice code
length. (Parity: libs/lpc/src/lpc.c:988-1163.)

The port's own copy of ``srla_tpu/dsp/svr.py``; the Cholesky factor and
solve are the port's ``dsp/pitch.py`` copies.

Exactness strategy: per-sample residuals are independent given the
coefficients, so the residual filter vectorizes over samples with the same
per-element op order as the reference; the order-sensitive f64 accumulations
(covariance, r-vector, mean-abs) stay sample-sequential.
"""

from __future__ import annotations

import math

import numpy as np

from .pitch import cholesky_decompose, cholesky_solve

_FLT_MAX = 3.402823466e38
_OBJ_EPSILON = 1e-8
_SVR_BPS = 16  # the reference estimator hardcodes 16-bit (lpc.c:1041)
_INV_LOGE2 = 1.4426950408889634


def _rgr_mean_code_length(mean_abs_error: float, bps: int) -> float:
    intmean = mean_abs_error * (1 << bps)
    rho = 1.0 / (1.0 + intmean)
    om = 1.0 - rho
    denom = -math.inf if om == 0.0 else math.log(om)
    lv = math.log(0.5127629514) / denom
    log2v = (-math.inf if lv == 0.0 else math.log(lv)) * _INV_LOGE2
    k2 = int(max(0.0, log2v))
    k1 = k2 + 1
    k1f = math.pow(1.0 - rho, float(1 << k1))
    k2f = math.pow(1.0 - rho, float(1 << k2))
    return (1.0 + k1) * (1.0 - k1f) + (1.0 + k2 + (1.0 / (1.0 - k2f))) * k1f


def _covariance(data: np.ndarray, n: int, dim: int) -> np.ndarray:
    """cov[i][j] = sum_{s < n-dim} data[s+i]*data[s+j], sample-sequential."""
    cov = np.zeros((dim, dim))
    iu = np.triu_indices(dim)
    acc = np.zeros(len(iu[0]))
    for s in range(n - dim):
        win = data[s:s + dim]
        acc += win[iu[0]] * win[iu[1]]
    cov[iu] = acc
    cov.T[iu] = acc
    return cov


def svr_refine_one(data: np.ndarray, coef: np.ndarray, order: int, n: int,
                   max_iter: int, ridge: float, margins):
    """Returns (refined coef, work-buffer contents or None).

    The reference stores each iteration's soft-thresholded residual in the
    persistent LPC work buffer (`residual = lpcc->buffer`, lpc.c:1050) — the
    LAST executed iteration's values are what later stale-buffer reads see
    (odd-length blocks / tiny LTP tails), so they are returned for the
    encoder's state threading."""
    if max_iter == 0 or order == 0:
        return coef, None
    cov = _covariance(data[:n], n, order)
    for i in range(order):
        cov[i, i] *= (1.0 + ridge)
    low = cholesky_decompose(cov, order)
    if low is None:
        return np.zeros_like(coef), None
    init = coef.copy()
    best = init.copy()
    cur = coef.copy()
    min_obj = _FLT_MAX
    d = data[:n]
    last_buffer = None
    for margin in margins:
        prev_obj = _FLT_MAX
        cur[:] = init
        for _ in range(max_iter):
            # residual[s] = d[s] + sum_i cur[i]*d[s-i-1]; per-sample
            # independent, so vectorize over s with the C per-element order.
            resid = d.copy()
            for i in range(order):
                resid[order:] = resid[order:] + cur[i] * d[order - i - 1:
                                                           n - i - 1]
            mabse = 0.0
            for s in range(order, n):
                mabse += abs(resid[s])
            th = resid[order:]
            sgn = np.sign(th)
            th = sgn * np.maximum(np.abs(th) - margin, 0.0)
            resid[order:] = th   # in-place threshold, as the reference does
            last_buffer = resid
            # r_vec[i] accumulates sample-sequentially in the reference.
            rvec = np.zeros(order)
            rev = d[::-1]
            for s in range(order, n):
                rvec += th[s - order] * rev[n - s:n - s + order]
            obj = _rgr_mean_code_length(mabse / n, _SVR_BPS)
            delta = cholesky_solve(cov, order, rvec, low)
            if obj < min_obj:
                best[:] = cur
                min_obj = obj
            if prev_obj < obj or abs(prev_obj - obj) < _OBJ_EPSILON:
                break
            cur[:order] = cur[:order] + delta
            prev_obj = obj
    return best, last_buffer


def svr_refine_batch(dbl: np.ndarray, coefs_f: np.ndarray, orders: np.ndarray,
                     n: int, max_iter: int, bps: int, ridge: float,
                     margins):
    """Returns (refined coefs, per-block work-buffer writes or None)."""
    out = coefs_f.copy()
    bufs = [None] * dbl.shape[0]
    for b in range(dbl.shape[0]):
        o = int(orders[b])
        if o > 0:
            out[b, :o], bufs[b] = svr_refine_one(dbl[b],
                                                 coefs_f[b, :o].copy(), o, n,
                                                 max_iter, ridge, margins)
    return out, bufs
