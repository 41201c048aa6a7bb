"""Optional LPC analysis methods exposed for library parity.

The reference exposes auxiliary-function (AF) iteration, Burg recursion, and
PARCOR quantization in its public lpc.h even though no codec preset reaches
them (SURVEY §2, 'dead code' note). They are provided here as standalone
library functions with the same math. (Parity: libs/lpc/src/lpc.c:573-985,
1263-1338.)

The port's own copy of ``srla_tpu/dsp/lpc_extra.py``: host numpy code, no
kernel.
"""

from __future__ import annotations

import math

import numpy as np

from .pitch import cholesky_decompose, cholesky_solve

_RESIDUAL_EPSILON = 1e-6
_FLT_EPSILON = 1.1920928955078125e-07
_FLT_MAX = 3.402823466e38


def autocorrelation_direct(data: np.ndarray, order: int) -> np.ndarray:
    """Direct (time-domain) sample autocorrelation, lags 0..order-1."""
    n = len(data)
    ac = np.zeros(order)
    for i in range(n - order + 1):
        ac += data[i] * data[i:i + order]
    for i in range(n - order + 1, n):
        m = n - i
        ac[:m] += data[i] * data[i:i + m]
    return ac


def lpc_auxiliary_function(data: np.ndarray, order: int,
                           max_iterations: int = 10,
                           obj_epsilon: float = 1e-8,
                           initial_coef: np.ndarray | None = None
                           ) -> np.ndarray:
    """Auxiliary-function (iteratively reweighted L1) LPC estimation."""
    n = len(data)
    if initial_coef is None:
        coef = np.zeros(order)
    else:
        coef = initial_coef.astype(np.float64).copy()
    prev_obj = _FLT_MAX
    for _ in range(max_iterations):
        r_mat = np.zeros((order, order))
        r_vec = np.zeros(order)
        obj = 0.0
        for s in range(order, n):
            window = data[s - order:s][::-1]
            residual = data[s] + float(coef @ window)
            residual = abs(residual)
            obj += residual
            residual = max(residual, _RESIDUAL_EPSILON)
            inv = 1.0 / residual
            r_vec -= data[s] * window * inv
            r_mat += np.outer(window, window) * inv
        inv_diag = cholesky_decompose(r_mat, order)  # factors in place
        if inv_diag is None:
            return np.zeros(order)
        coef = cholesky_solve(r_mat, order, r_vec, inv_diag)
        obj /= (n - order)
        if abs(prev_obj - obj) < obj_epsilon:
            break
        prev_obj = obj
    return coef


def lpc_burg(data: np.ndarray, order: int) -> np.ndarray:
    """Burg-method LPC via the autocovariance formulation."""
    cov = np.zeros((order + 1, order + 1))
    for i in range(order + 1):
        cov[i, i:] = autocorrelation_direct(data[:len(data) - i],
                                            order + 1 - i)
        cov[i:, i] = cov[i, i:]
    a = np.zeros(order + 1)
    a[0] = 1.0
    for k in range(order):
        fkpbk = 0.0
        cross = 0.0
        ck = 0.0
        for i in range(k + 1):
            fkpbk += a[i] * a[i] * (cov[i, i] + cov[k + 1 - i, k + 1 - i])
            for jj in range(i + 1, k + 1):
                cross += a[i] * a[jj] * (cov[i, jj]
                                         + cov[k + 1 - i, k + 1 - jj])
        fkpbk += 2.0 * cross
        for i in range(k + 1):
            for jj in range(k + 1):
                ck += a[i] * a[jj] * cov[i, k + 1 - jj]
        mu = -2.0 * ck / fkpbk
        for i in range((k + 1) // 2 + 1):
            t1, t2 = a[i], a[k + 1 - i]
            a[i] = t1 + mu * t2
            a[k + 1 - i] = mu * t1 + t2
    return a[1:order + 1]


def lpc_to_parcor(lpc_coef: np.ndarray) -> np.ndarray:
    """Step-down recursion: LPC coefficients -> PARCOR (reflection) coeffs."""
    order = len(lpc_coef)
    tmp = lpc_coef.astype(np.float64).copy()
    parcor = np.zeros(order)
    for i in range(order - 1, -1, -1):
        gamma = tmp[i]
        parcor[i] = -gamma
        prev = tmp[:i].copy()
        for k in range(i):
            tmp[k] = (prev[k] - gamma * prev[i - k - 1]) / (1.0 - gamma * gamma)
    return parcor


def quantize_parcor(lpc_coef: np.ndarray, nbits_precision: int) -> np.ndarray:
    """Quantize via PARCOR domain (round half away, clip to signed range)."""
    parcor = lpc_to_parcor(lpc_coef)
    qmax = 1 << (nbits_precision - 1)
    scaled = parcor * float(1 << (nbits_precision - 1))
    q = np.where(scaled >= 0, np.floor(scaled + 0.5), -np.floor(-scaled + 0.5))
    return np.clip(q, -qmax, qmax - 1).astype(np.int32)


def calculate_mdl(parcor: np.ndarray, num_samples: int) -> float:
    """Minimum description length from PARCOR coefficients.

    MDL = n * sum_{k>=1} ln(1 - parcor_k^2) + order * ln(n).
    """
    order = len(parcor)
    tmp = 0.0
    for k in range(1, order):
        tmp += math.log(1.0 - parcor[k] * parcor[k])
    tmp *= num_samples
    tmp += order * math.log(num_samples)
    return tmp


def estimate_code_length(error_var_ratio: float, power: float,
                         num_samples: int, bits_per_sample: int) -> float:
    """Laplace-assumption entropy estimate (bits/sample) from LPC stats."""
    beta = 1.9426950408889634  # sqrt(2 e^2)
    if abs(power) <= 1.1754943508222875e-38:
        return 0.0
    log2_power = math.log2(power * 2.0 ** (2.0 * (bits_per_sample - 1))) \
        - math.log2(num_samples)
    est = beta + 0.5 * (log2_power + error_var_ratio)
    return est if est > 0 else 1.0
