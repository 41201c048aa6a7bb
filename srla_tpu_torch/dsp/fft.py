"""Batched radix-4 Stockham FFT and real-FFT wrapper (float64, bit-exact).

This reproduces, in vectorized form over a batch of blocks, the exact IEEE-754
double arithmetic of the reference transform (parity target:
libs/fft/src/fft.c:71-198). Determinism notes:

  - Twiddle factors are generated by the same complex-multiply *recurrence*
    starting from one ``cos/sin`` libm call per stage. We run that recurrence
    in Python floats (same libm, same op order) and cache the tables.
  - Butterflies are elementwise over (batch, p, q) — identical rounding per
    element regardless of vectorization.
  - Complex multiplies are expanded literally as (ar*br - ai*bi, ar*bi + ai*br)
    to avoid any FMA contraction.

On TPU the same structure runs in f32 as a sequence of fused elementwise stages
(fast path); the f64 path here is the bit-exact analysis reference.

The port's own copy of ``srla_tpu/dsp/fft.py``.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


@lru_cache(maxsize=None)
def _stage_twiddles(n: int, flag: int):
    """Per-stage (w1, w2, w3) twiddle arrays for the radix-4 stages of size n."""
    stages = []
    while n > 2:
        n1 = n >> 2
        theta0 = 2.0 * math.pi / n
        wdr, wdi = math.cos(theta0), flag * math.sin(theta0)
        w1r = np.empty(n1)
        w1i = np.empty(n1)
        w2r = np.empty(n1)
        w2i = np.empty(n1)
        w3r = np.empty(n1)
        w3i = np.empty(n1)
        ar, ai = 1.0, 0.0
        for p in range(n1):
            br, bi = _cmul(ar, ai, ar, ai)      # w2 = w1*w1
            cr, ci = _cmul(ar, ai, br, bi)      # w3 = w1*w2
            w1r[p], w1i[p] = ar, ai
            w2r[p], w2i[p] = br, bi
            w3r[p], w3i[p] = cr, ci
            ar, ai = _cmul(ar, ai, wdr, wdi)    # advance by recurrence
        stages.append((w1r[:, None], w1i[:, None], w2r[:, None], w2i[:, None],
                       w3r[:, None], w3i[:, None]))
        n >>= 2
    return stages


def complex_fft_c(x: np.ndarray, flag: int) -> np.ndarray:
    """Unnormalized complex FFT (flag=-1) / IFFT (+1) over the last axis.

    Arithmetic runs on separate real/imag float64 planes with every complex
    multiply expanded LITERALLY as (ar*br - ai*bi, ar*bi + ai*br) — the
    reference's FFTComplex_Mul rounding (fft.c:56-63). numpy's complex128
    multiply must NOT be used here: it lowers to a fused multiply-add form
    whose last-ulp differences get amplified ~1e8x by the catastrophic
    cancellation in impulse-dominated autocorrelations.
    """
    n = x.shape[-1]
    batch = x.shape[:-1]
    x = x.reshape(-1, n)
    xr = np.ascontiguousarray(x.real, dtype=np.float64)
    xi = np.ascontiguousarray(x.imag, dtype=np.float64)
    yr = np.empty_like(xr)
    yi = np.empty_like(xi)
    s = 1
    ji = -float(flag)
    cur = n
    for (w1r, w1i, w2r, w2i, w3r, w3i) in _stage_twiddles(n, flag):
        n1 = cur >> 2
        XR = xr.reshape(-1, cur, s)
        XI = xi.reshape(-1, cur, s)
        YR = yr.reshape(-1, n1, 4, s)
        YI = yi.reshape(-1, n1, 4, s)
        ar, ai = XR[:, 0 * n1:1 * n1], XI[:, 0 * n1:1 * n1]
        br, bi = XR[:, 1 * n1:2 * n1], XI[:, 1 * n1:2 * n1]
        cr, ci = XR[:, 2 * n1:3 * n1], XI[:, 2 * n1:3 * n1]
        dr, di = XR[:, 3 * n1:4 * n1], XI[:, 3 * n1:4 * n1]
        apcr, apci = ar + cr, ai + ci
        amcr, amci = ar - cr, ai - ci
        bpdr, bpdi = br + dr, bi + di
        bmdr, bmdi = br - dr, bi - di
        jbmdr = 0.0 * bmdr - ji * bmdi
        jbmdi = 0.0 * bmdi + ji * bmdr
        YR[:, :, 0] = apcr + bpdr
        YI[:, :, 0] = apci + bpdi
        t1r, t1i = amcr - jbmdr, amci - jbmdi
        YR[:, :, 1] = w1r * t1r - w1i * t1i
        YI[:, :, 1] = w1r * t1i + w1i * t1r
        t2r, t2i = apcr - bpdr, apci - bpdi
        YR[:, :, 2] = w2r * t2r - w2i * t2i
        YI[:, :, 2] = w2r * t2i + w2i * t2r
        t3r, t3i = amcr + jbmdr, amci + jbmdi
        YR[:, :, 3] = w3r * t3r - w3i * t3i
        YI[:, :, 3] = w3r * t3i + w3i * t3r
        xr, yr = yr, xr
        xi, yi = yi, xi
        cur >>= 2
        s <<= 2
    if cur == 2:
        XR = xr.reshape(-1, 2, s)
        XI = xi.reshape(-1, 2, s)
        YR = yr.reshape(-1, 2, s)
        YI = yi.reshape(-1, 2, s)
        YR[:, 0] = XR[:, 0] + XR[:, 1]
        YI[:, 0] = XI[:, 0] + XI[:, 1]
        YR[:, 1] = XR[:, 0] - XR[:, 1]
        YI[:, 1] = XI[:, 0] - XI[:, 1]
        xr, yr = yr, xr
        xi, yi = yi, xi
    out = np.empty((xr.shape[0], n), dtype=np.complex128)
    out.real = xr
    out.imag = xi
    return out.reshape(*batch, n)


@lru_cache(maxsize=None)
def _real_fft_rotors(n: int, flag: int):
    """Rotation factors for the real-FFT pack/unpack loop, i = 1..n/4."""
    theta = flag * 2.0 * math.pi / n
    wpi = math.sin(theta)
    wpr = math.cos(theta) - 1.0
    count = n >> 2
    wr_arr = np.empty(count)
    wi_arr = np.empty(count)
    wr = 1.0 + wpr
    wi = wpi
    for i in range(count):
        wr_arr[i] = wr
        wi_arr[i] = wi
        wtmp = wr
        wr += wtmp * wpr - wi * wpi
        wi += wi * wpr + wtmp * wpi
    return wr_arr, wi_arr


def real_fft(x: np.ndarray, flag: int) -> np.ndarray:
    """Real FFT (flag=-1) / inverse (flag=+1) over the last axis, n even pow2.

    Packed format: x[0]=DC real, x[1]=Nyquist real, then interleaved re/im.
    Unnormalized; a full round trip scales by n/2 (norm constant 2/n).
    """
    n = x.shape[-1]
    batch = x.shape[:-1]
    x = x.reshape(-1, n).astype(np.float64)  # private contiguous copy
    c2 = flag * 0.5
    if flag == -1:
        v = x.view(np.complex128)
        v[:] = complex_fft_c(v, -1)

    wr, wi = _real_fft_rotors(n, flag)
    i = np.arange(1, (n >> 2) + 1)
    i1 = i << 1
    i2 = i1 + 1
    i3 = n - i1
    i4 = i3 + 1
    h1r = 0.5 * (x[:, i1] + x[:, i3])
    h1i = 0.5 * (x[:, i2] - x[:, i4])
    h2r = -c2 * (x[:, i2] + x[:, i4])
    h2i = c2 * (x[:, i1] - x[:, i3])
    x[:, i1] = h1r + (wr * h2r) - (wi * h2i)
    x[:, i2] = h1i + (wr * h2i) + (wi * h2r)
    x[:, i3] = h1r - (wr * h2r) + (wi * h2i)
    x[:, i4] = -h1i + (wr * h2i) + (wi * h2r)

    h1r = x[:, 0].copy()
    if flag == -1:
        x[:, 0] = h1r + x[:, 1]
        x[:, 1] = h1r - x[:, 1]
    else:
        x[:, 0] = 0.5 * (h1r + x[:, 1])
        x[:, 1] = 0.5 * (h1r - x[:, 1])
        v = x.view(np.complex128)
        v[:] = complex_fft_c(v, 1)
    return x.reshape(*batch, n)


def round_up_pow2(v: int) -> int:
    return 1 << (v - 1).bit_length() if v > 1 else 1
