"""K8: the encode's windowed circular autocorrelation.

``autocorr`` is the twin of ``srla_tpu.kernels.exact._autocorr_dd``: on a
CUDA tensor it launches ``csrc/autocorr.cu`` (K8), on a CPU tensor it runs
``autocorr_plain``. The encode takes from it the LPC lags (max order + 1,
up to 256) of every analysis row and, with ``-P``, the 263 pitch lags
(``exact.ltp_lags``) before them.

The lags are circular over the FFT size, as the host computes them with a
real FFT of ``round_up_pow2(n)`` points: ``ac[k] = fft_size / n * sum_i
d[i] * d[(i + k) mod fft_size]`` with ``d`` the windowed row zero-padded to
the FFT size. Both versions sum the products in their own order; the error
each order allows and the margins it must stay under are written in
``exact.py`` above ``_EPS_PREEMPH``.

Parity target: libs/lpc/src/lpc.c:330-378 (window, FFT autocorrelation).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..dsp.window import welch_divisor, welch_window
from . import build

_F64 = torch.float64
MAX_LAGS = 1024                  # K8's shared-memory budget (csrc/autocorr.cu)


@lru_cache(maxsize=None)
def scaled_window(n: int, bps: int) -> np.ndarray:
    """The Welch window times 2^-(bps-1), read-only. The product is exact,
    so the windowed samples equal the host's. Odd n: the window's unwritten
    middle sample is taken as 0."""
    win = welch_window(n).copy()
    if n & 1:
        win[n // 2] = 0.0
    win *= 2.0 ** (-(bps - 1))
    win.setflags(write=False)
    return win


def autocorr_plain(work: torch.Tensor, n: int, bps: int, order: int,
                   fft_size: int) -> torch.Tensor:
    """Plain PyTorch version of K8. work (V, n) int32 -> (V, order) f64
    windowed autocorrelation, direct lag by lag and circular over the
    zero-padded fft_size buffer, scaled by fft_size / n: the value the
    host's FFT path computes."""
    w = torch.from_numpy(scaled_window(n, bps).copy()).to(work.device)
    d = F.pad(work.to(_F64) * w, (0, fft_size - n))
    d2 = torch.cat([d, d[:, :order]], dim=1)
    norm = float(fft_size) / float(n)
    ac = torch.empty((work.shape[0], order), dtype=_F64, device=work.device)
    for k in range(order):
        ac[:, k] = (d * d2[:, k:k + fft_size]).sum(dim=1) * norm
    return ac


def autocorr(work: torch.Tensor, n: int, bps: int, order: int,
             fft_size: int) -> torch.Tensor:
    """work (V, n) int32 -> (V, order) f64 lags 0..order-1 (``order`` lags,
    at most MAX_LAGS), fft_size a power of two >= n.

    CUDA tensors go through the kernel (``autocorr.launches`` counts its
    launches); CPU tensors go through ``autocorr_plain``."""
    if work.device.type == "cpu":
        return autocorr_plain(work, n, bps, order, fft_size)
    if work.device.type != "cuda":
        raise ValueError(f"autocorr: no kernel for device {work.device}")
    if not 1 <= order <= MAX_LAGS:
        raise ValueError(f"autocorr: 1..{MAX_LAGS} lags, got {order}")
    if n < 1 or fft_size < n or fft_size & (fft_size - 1):
        raise ValueError(f"autocorr: fft_size must be a power of two >= n, "
                         f"got n {n}, fft_size {fft_size}")
    V = work.shape[0]
    build.check_arg("autocorr", "work", work, (V, n), work.device)
    out = torch.empty((V, order), dtype=_F64, device=work.device)
    if V == 0:
        return out
    lib = build.load("autocorr")
    fn = lib.srla_autocorr
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 \
            + [ctypes.c_double] * 2 + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(work.device).cuda_stream
    # The kernel makes scaled_window's samples itself from the same two
    # numbers: welch_window's divisor and the exact 2^-(bps-1).
    err = fn(work.data_ptr(), out.data_ptr(), V, n, order, fft_size,
             welch_divisor(n), 2.0 ** -(bps - 1), stream)
    build.check(err, "autocorr")
    autocorr.launches += 1
    return out


autocorr.launches = 0
