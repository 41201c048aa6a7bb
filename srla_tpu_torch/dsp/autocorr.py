"""FFT-based (circular) sample autocorrelation, batched over blocks.

Pipeline per block (float64, exact): window -> zero-pad to pow2 -> real FFT ->
per-bin |X|^2 -> inverse real FFT -> scale by 2/n. Note the pad goes to the
*next* power of two (not 2n), so for full blocks the autocorrelation is the
circular one — that is the stream-normative behavior.
(Parity: libs/lpc/src/lpc.c:330-376.)

The port's own copy of ``srla_tpu/dsp/autocorr.py``.
"""

from __future__ import annotations

import numpy as np

from .fft import real_fft, round_up_pow2


def autocorr_fft(windowed: np.ndarray, num_samples: int, order: int,
                 want_raw: bool = False):
    """windowed: (B, num_samples) float64. Returns (B, order) autocorrelation,
    plus the raw (unscaled) IFFT buffer when want_raw — callers that emulate
    the reference's persistent work buffer need it (odd-length blocks leave
    one window sample unwritten; see encoder stale-state emulation)."""
    fft_size = round_up_pow2(num_samples)
    B = windowed.shape[0]
    from .. import native_decoder
    if native_decoder.available() and fft_size >= 4:
        return native_decoder.autocorr_batch(windowed[:, :num_samples],
                                             fft_size, num_samples, order,
                                             want_raw)
    buf = np.zeros((B, fft_size))
    buf[:, :num_samples] = windowed
    buf = real_fft(buf, -1)
    # Squared magnitudes in packed layout (DC and Nyquist are pure real).
    out = np.empty_like(buf)
    out[:, 0] = buf[:, 0] * buf[:, 0]
    out[:, 1] = buf[:, 1] * buf[:, 1]
    re = buf[:, 2::2]
    im = buf[:, 3::2]
    out[:, 2::2] = re * re + im * im
    out[:, 3::2] = 0.0
    out = real_fft(out, 1)
    norm = 2.0 / num_samples
    ac = out[:, :order] * norm if order <= fft_size else None
    if ac is None:
        # order exceeds the FFT buffer: the reference reads stale buffer
        # content beyond fft_size; callers patch those lags from their state.
        ac = np.zeros((B, order))
        ac[:, :fft_size] = out * norm
    if want_raw:
        return ac, out
    return ac
