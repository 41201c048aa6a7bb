"""Analysis windows (float64, exact).

Window tables are generated once per length with Python-float arithmetic (the
platform libm), reproducing the per-sample op order of the reference
(parity: libs/lpc/src/lpc.c:236-290). For odd lengths the Welch loop leaves the
middle sample *unwritten* — callers must reproduce that carry-over semantic
(see encoder 'stale buffer' emulation); the table here marks it with NaN.

The port's own copy of ``srla_tpu/dsp/window.py``.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np


def welch_divisor(num_samples: int) -> float:
    """The Welch window's scale 4 / (n - 1)^2 as the reference computes it:
    sample k < n / 2 (and its mirror n - 1 - k) is (divisor * k) * (n - 1 -
    k). C pow(0.0, -2.0) is +inf (n == 1: no sample uses it, the lone sample
    is the "unwritten middle"); Python's math.pow raises."""
    n = num_samples
    return math.inf if n == 1 else 4.0 * math.pow(n - 1, -2.0)


@lru_cache(maxsize=None)
def welch_window(num_samples: int) -> np.ndarray:
    n = num_samples
    w = np.full(n, np.nan)
    divisor = welch_divisor(n)
    for smpl in range(n >> 1):
        weight = (divisor * smpl) * (n - 1 - smpl)
        w[smpl] = weight
        w[n - smpl - 1] = weight
    return w


def welch_inverse_squared_sum(num_samples: int) -> float:
    """1 / (window energy) correction applied to error variances."""
    n = float(num_samples - 1)
    return (15 * (n - 1) * (n - 1) * (n - 1)) / (8 * n * (n - 2) * (n * n - 2 * n + 2))
