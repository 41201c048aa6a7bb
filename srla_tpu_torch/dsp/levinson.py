"""Batched Levinson-Durbin recursion (float64, exact).

Vectorized over a batch of blocks; sequential over recursion order and over
the reflection-coefficient inner sum, preserving the reference's f64 rounding
order exactly (parity: libs/lpc/src/lpc.c:379-441). Two entry points:

  - ``levinson_error_vars``: error variance at every order 1..max (used by the
    order-selection tactic) plus PARCOR coefficients.
  - ``levinson_coefs_at``: the LPC coefficient vector of a per-block *selected*
    order, gathered during a second recursion pass (avoids materializing all
    O(order^2) coefficient vectors per block).

The silent-block special case (|r0| < FLT_EPSILON -> all-zero coefficients,
error variance pinned to r0) is applied as a final mask.

The port's own copy of ``srla_tpu/dsp/levinson.py``.
"""

from __future__ import annotations

import numpy as np

FLT_EPSILON = 1.1920928955078125e-07  # 2**-23


def _recursion(auto_corr: np.ndarray, max_order: int, collect_orders=None):
    """Core recursion. auto_corr: (B, max_order+1).

    Returns (error_vars (B, max_order+1), parcor (B, max_order),
             collected coefs (B, max_order) if collect_orders given else None).
    collect_orders: (B,) int — per-block order whose coefficient vector to keep.
    """
    from .. import native_decoder
    if native_decoder.available():
        return native_decoder.levinson_batch(auto_corr, max_order,
                                             collect_orders)
    B = auto_corr.shape[0]
    error_vars = np.zeros((B, max_order + 1))
    parcor = np.zeros((B, max_order))
    a_prev = np.zeros((B, max_order + 2))
    a_cur = np.zeros((B, max_order + 2))
    collected = None if collect_orders is None else np.zeros((B, max_order))

    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        r0 = auto_corr[:, 0]
        a_prev[:, 0] = 1.0
        error_vars[:, 0] = r0
        a_prev[:, 1] = -auto_corr[:, 1] / r0
        parcor[:, 0] = auto_corr[:, 1] / r0
        error_vars[:, 1] = r0 + auto_corr[:, 1] * a_prev[:, 1]
        if collected is not None:
            sel = collect_orders == 1
            collected[sel, 0] = a_prev[sel, 1]

        for k in range(1, max_order):
            gamma = np.zeros(B)
            for i in range(k + 1):
                gamma += a_prev[:, i] * auto_corr[:, k + 1 - i]
            gamma /= -error_vars[:, k]
            error_vars[:, k + 1] = error_vars[:, k] * (1.0 - gamma * gamma)
            idx = np.arange(k + 2)
            a_cur[:, :k + 2] = a_prev[:, idx] + gamma[:, None] * a_prev[:, k + 1 - idx]
            a_cur[:, k + 2:] = 0.0
            parcor[:, k] = -gamma
            if collected is not None:
                sel = collect_orders == (k + 1)
                if sel.any():
                    collected[sel, :k + 1] = a_cur[sel, 1:k + 2]
            a_prev, a_cur = a_cur, a_prev

    # Silent special case.
    silent = np.abs(auto_corr[:, 0]) < FLT_EPSILON
    if silent.any():
        error_vars[silent] = auto_corr[silent, 0:1]
        parcor[silent] = 0.0
        if collected is not None:
            collected[silent] = 0.0
    return error_vars, parcor, collected


def levinson_error_vars(auto_corr: np.ndarray, max_order: int):
    ev, parcor, _ = _recursion(auto_corr, max_order)
    return ev, parcor


def levinson_coefs_at(auto_corr: np.ndarray, max_order: int, orders: np.ndarray):
    """Coefficient vectors (B, max_order; left-aligned, zero-padded) at per-block orders."""
    _, _, coefs = _recursion(auto_corr, max_order, collect_orders=np.asarray(orders))
    return coefs
