"""Seeded synthetic music in NumPy: the benchmark's audio.

The five categories of the upstream SRLA evaluation's RWC corpus
(classic, jazz, popular, vocal, rhythm), built from what drives a lossless
codec: harmonic stacks with vibrato (long predictors), note transients
(block boundaries, -V partitions), formants with pitch drift, percussive
noise bursts (large Rice parameters, RAW blocks), hard silence (SILENT
blocks) and correlated channels (the stereo methods).

A frozen rewrite of ``evaluation/evaluate_codecs.py``'s
``synthetic_corpus`` (its categories and constants), with the seed, the
sampling rate, the length and the bit depth as arguments: durations are
kept in seconds, so a 96 kHz track holds the same music as a 44.1 kHz one.
24-bit material is the 16-bit music scaled by 256 plus a seeded dither of
the low byte, as the original's ``deep24`` file.
"""

from __future__ import annotations

import numpy as np

CATEGORIES = ("classic", "jazz", "popular", "vocal", "rhythm")


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, *keys])


def _stereo(mid, side_gain, rng, amp=22000.0):
    delay = int(rng.integers(5, 40))
    side = np.roll(mid, delay) * side_gain
    left = np.clip(mid + side, -1, 1)
    right = np.clip(mid - side, -1, 1)
    return np.stack([np.round(left * amp), np.round(right * amp)]).astype(
        np.int32)


def _partials(ph, amps):
    """sum(a_i * sin((i + 1) * ph)) by the recurrence sin((k+1)x) =
    2 cos(x) sin(kx) - sin((k-1)x): two transcendental passes in all."""
    two_cos = 2.0 * np.cos(ph)
    prev, cur = np.zeros_like(ph), np.sin(ph)
    out = amps[0] * cur
    for a in amps[1:]:
        prev, cur = cur, two_cos * cur - prev
        out += a * cur
    return out


class _Music:
    """The generators of one track: n samples at ``rate``."""

    def __init__(self, rate: int, seconds: float):
        self.rate = rate
        self.seconds = seconds
        self.n = int(round(seconds * rate))
        self.t = np.arange(self.n) / rate
        # Sample counts of the original are at 44.1 kHz.
        self.k = rate / 44100.0

    def samples(self, at_44k: float) -> int:
        return max(1, int(round(at_44k * self.k)))

    def notes_env(self, seg, attack, decay):
        n, rate = self.n, self.rate
        env = np.zeros(n)
        for s0 in np.arange(0, self.seconds, seg):
            i0 = int(s0 * rate)
            i1 = min(n, int((s0 + seg) * rate))
            tt = np.arange(i1 - i0) / rate
            env[i0:i1] = np.minimum(tt / attack, 1.0) * np.exp(-tt * decay)
        return env

    def harmonics(self, f0, amps, vib_hz=5.0, vib_cents=8.0):
        vib = 2 ** (vib_cents / 1200 * np.sin(2 * np.pi * vib_hz * self.t))
        ph = 2 * np.pi * np.cumsum(f0 * vib) / self.rate
        return _partials(ph, amps)

    def classic(self, rng):
        n, rate = self.n, self.rate
        scale = [261.6, 293.7, 329.6, 392.0, 440.0]
        f0 = np.repeat(rng.choice(scale, int(self.seconds / 2) + 1),
                       2 * rate)[:n]
        sig = self.harmonics(f0, [.4, .2, .1, .05]) * self.notes_env(
            2.0, .05, .8)
        tail = min(rate, n)
        sig[-tail:] *= np.linspace(1, 0, tail)   # decays to near-silence
        return _stereo(sig * 0.8, 0.1, rng)

    def jazz(self, rng):
        n, rate = self.n, self.rate
        walk = [110, 146.8, 164.8, 220]
        f0 = np.repeat(rng.choice(walk, int(self.seconds * 2) + 1),
                       rate // 2)[:n]
        bass = self.harmonics(f0, [.5, .15]) * self.notes_env(0.5, .005, 4.0)
        brush = rng.standard_normal(n) * 0.02 * (
            1 + np.sin(2 * np.pi * 2 * self.t))
        return _stereo((bass + brush) * 0.7, 0.2, rng)

    def popular(self, rng):
        n, rate = self.n, self.rate
        kick = np.zeros(n)
        span, fall, decay = (self.samples(4000), self.samples(2000),
                             self.samples(1500))
        for b in np.arange(0, self.seconds, 0.5):
            i0 = int(b * rate)
            ln = min(n - i0, span)
            idx = np.arange(ln)
            kick[i0:i0 + ln] += np.sin(
                2 * np.pi * 55 * np.exp(-idx / fall) * idx / rate) * np.exp(
                    -idx / decay)
        synth = self.harmonics(np.full(n, 196.0), [.25, .2, .15, .1, .05])
        sig = kick * 0.6 + synth * 0.3 * self.notes_env(1.0, .01, 1.0)
        return _stereo(sig, 0.3, rng)

    def vocal(self, rng):
        n, rate, t = self.n, self.rate, self.t
        f0 = 220 * 2 ** (np.cumsum(rng.standard_normal(n) * 1e-5 / self.k)
                         + 0.3 * np.sin(2 * np.pi * 0.4 * t))
        ph = 2 * np.pi * np.cumsum(f0) / rate
        glottal = _partials(ph, [1.0 / k for k in range(1, 12)])
        formant = np.sin(2 * np.pi * 800 * t) * 0.2 + 1.0
        breath = rng.standard_normal(n) * 0.01
        sig = (glottal * 0.25 * formant + breath) * self.notes_env(
            4.0, 0.3, 0.3)
        return _stereo(sig, 0.05, rng)

    def rhythm(self, rng):
        n, rate = self.n, self.rate
        sig = np.zeros(n)
        span = self.samples(2500)
        for b in np.arange(0, self.seconds, 0.25):
            i0 = int(b * rate)
            ln = min(n - i0, span)
            tone = 1 if int(b * 4) % 4 else 0
            burst = rng.standard_normal(ln) * (0.5 if tone else 0.9)
            burst *= np.exp(-np.arange(ln) / self.samples(300 if tone
                                                          else 900))
            sig[i0:i0 + ln] += burst
        sig[n // 2:n // 2 + rate // 2] = 0   # hard silence gap
        return _stereo(sig * 0.6, 0.4, rng)


def track(category: str, seed: int, rate: int, seconds: float,
          bits: int = 16, take: int = 0) -> np.ndarray:
    """One (2, N) int32 stereo track of ``category`` at ``rate`` Hz and
    ``bits`` (16 or 24), N = round(seconds * rate), from ``seed``; ``take``
    tells apart tracks of one category under one seed."""
    if category not in CATEGORIES:
        raise ValueError(f"unknown category {category!r}")
    if bits not in (16, 24):
        raise ValueError(f"bits must be 16 or 24, got {bits}")
    cat = CATEGORIES.index(category)
    music = _Music(rate, seconds)
    pcm = getattr(music, category)(_rng(seed, cat, take, 0))
    if bits == 24:
        dither = _rng(seed, cat, take, 1).integers(-127, 128, pcm.shape)
        pcm = np.clip(pcm.astype(np.int64) * 256 + dither,
                      -(1 << 23), (1 << 23) - 1).astype(np.int32)
    return pcm


# The seed of the fixed material that ``rotated`` starts at seeded units.
MATERIAL_SEED = 0


def rotated(category: str, seed: int, rate: int, seconds: float,
            bits: int = 16, take: int = 0, unit: int = 1) -> np.ndarray:
    """One fixed piece of ``category`` (``track`` of ``MATERIAL_SEED``),
    made a whole number of ``unit`` samples long, started at a unit drawn
    from ``seed``, wrapped round and cut to ``seconds``. With the unit the
    encoder's lookahead window, every seed gets the same windows of music,
    and so the same work, in another order."""
    n = int(round(seconds * rate))
    units = -(-n // unit)
    piece = track(category, MATERIAL_SEED, rate, units * unit / rate, bits,
                  take)
    start = int(_rng(seed, CATEGORIES.index(category), take, 2).integers(
        0, units))
    return np.roll(piece, -start * unit, axis=1)[:, :n]


def order(seed: int, count: int, salt: int) -> np.ndarray:
    """A seeded permutation of range(count)."""
    return _rng(seed, 1000 + salt).permutation(count)
