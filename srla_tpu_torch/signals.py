"""Deterministic test signals for the port's checks.

``make_music`` is the port's own copy of ``bench.make_music`` (``bench.py``),
the 16-bit stereo signal of ``chip_smoke.py``'s main path, so that the port's
scripts import nothing from outside the package.
"""

from __future__ import annotations

import numpy as np


def make_music(seconds: float, rate: int = 44100, seed: int = 7) -> np.ndarray:
    """Deterministic music-like stereo signal: harmonics + AM + noise floor."""
    n = int(seconds * rate)
    t = np.arange(n) / rate
    rng = np.random.RandomState(seed)
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 0.25 * t + 0.7)
    sig = env * (np.sin(2 * np.pi * 196.0 * t) * 0.32
                 + np.sin(2 * np.pi * 392.0 * t + 0.3) * 0.17
                 + np.sin(2 * np.pi * 587.3 * t + 1.1) * 0.09
                 + np.sin(2 * np.pi * 1174.7 * t + 0.2) * 0.04)
    sig = sig + rng.randn(n) * 0.035
    left = np.round(np.clip(sig, -1, 1) * 23000).astype(np.int32)
    right = np.round(np.clip(np.roll(sig, 11) * 0.93, -1, 1)
                     * 23000).astype(np.int32)
    return np.stack([left, right])


def make_segmented(seconds: float, rate: int = 44100,
                   seed: int = 11) -> np.ndarray:
    """Deterministic stereo signal in segments of 500-6000 samples, each,
    drawn from ``seed``, one of: ``make_music``, ``make_music`` / 16, or
    white noise. Unlike the stationary ``make_music``, it makes the -V
    search pick mixed block sizes (at -V >= 2 also sizes that are no power
    of two)."""
    music = make_music(seconds, rate, seed)
    n = music.shape[1]
    rng = np.random.RandomState(seed)
    out = np.empty_like(music)
    pos = 0
    while pos < n:
        end = min(n, pos + rng.randint(500, 6001))
        kind = rng.randint(3)
        if kind == 0:
            out[:, pos:end] = music[:, pos:end]
        elif kind == 1:
            out[:, pos:end] = music[:, pos:end] // 16
        else:
            out[:, pos:end] = np.round(rng.randn(2, end - pos) * 4000)
        pos = end
    return out
