"""K8, the encode's windowed circular autocorrelation
(srla_tpu_torch.kernels.autocorr), against the JAX package and the exact sum.

- autocorr on CPU tensors (its plain version) against JAX's df64
  _autocorr_dd at n 256, 333 (odd), 1024 and 4064, 16 and 24 bits, 9, 65
  and 263 lags: within 2^-43 of r0 (JAX's lags are good to ~2^-44).
- The kernel's summation order (strips of 64 products in order, a pairwise
  tree over strips, stages of 16384 samples in order), emulated in torch on
  rows of 16384 samples at 24 bits, against the exact rational sum: within
  2^-46 of r0, the bound exact.py states for K8.
- The routing: a CPU tensor takes the plain version and leaves
  autocorr.launches at 0; a meta tensor raises.
- On the card (marked gpu): the kernel bit-equal to the emulation of its
  order and within 2^-45 r0 of the plain version, with one and with two
  stages; a CUDA tensor of the wrong dtype raises."""

import functools
from fractions import Fraction

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from srla_tpu.kernels import df64 as dd  # noqa: E402
from srla_tpu.kernels.exact import _autocorr_dd  # noqa: E402
from srla_tpu_torch.dsp.fft import round_up_pow2  # noqa: E402
from srla_tpu_torch.kernels.autocorr import (autocorr,  # noqa: E402
                                             autocorr_plain, scaled_window)



@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _jax_autocorr(tok, work, n, bps, L, F):
    """_autocorr_dd traced as the JAX package's entry points trace it, with
    a runtime zero pinning its products against XLA:CPU's contraction."""
    with dd.pinned(tok):
        return _autocorr_dd(work, n, bps, L, F)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rows(n: int, bps: int, seed: int) -> np.ndarray:
    """Full-scale noise, a loud sine, a quiet chirp, a row of one sample,
    zeros and a constant, int32."""
    rng = np.random.RandomState(seed)
    hi = 1 << (bps - 1)
    t = np.arange(n)
    rows = [rng.randint(-hi, hi, n),
            np.sin(t * 0.031) * (hi - 1),
            np.sin(t * t * 1e-5) * 37.0,
            np.where(t == n // 3, hi - 1, 0),
            np.zeros(n),
            np.full(n, -hi)]
    return np.round(np.stack(rows)).astype(np.int32)


# (n, bps, lags): every n, both depths and every lag count appear; 263 lags
# need an FFT size of at least 263.
CASES = [(256, 16, 9), (256, 24, 65), (333, 24, 65), (333, 16, 263),
         (1024, 16, 263), (1024, 24, 9), (4064, 24, 65), (4064, 16, 263)]


@pytest.mark.parametrize("n,bps,L", CASES)
def test_autocorr_matches_jax(n, bps, L):
    work = _rows(n, bps, seed=n + bps)
    F = round_up_pow2(n)
    port = autocorr(torch.from_numpy(work), n, bps, L, F).numpy()
    hi, lo = _jax_autocorr(np.int32(0), work, n, bps, L, F)
    want = dd.to_f64((np.asarray(hi), np.asarray(lo)))
    r0 = np.abs(want[:, :1])
    assert (np.abs(port - want) <= r0 * 2.0 ** -43).all(), np.max(
        np.abs(port - want) / np.where(r0 > 0, r0, 1.0))


# ---------------------------------------------------------------------------
# The kernel's summation order, emulated
# ---------------------------------------------------------------------------

STRIP, GROUP_STRIPS, STAGE_GROUPS, LAG_TILE = 64, 32, 8, 8


def k8_order(work: torch.Tensor, n: int, bps: int, lags, F: int):
    """The lags ``lags`` of work (V, n) int32 summed in K8's order
    (csrc/autocorr.cu), each product and add a torch op rounded once:
    strips of 64 products in order, an xor-butterfly over a group's 32
    strips, a pairwise tree over a stage's 8 groups, stages in order, then
    the multiply by F / n. Returns (V, len(lags)) f64."""
    V = work.shape[0]
    d = work.double() * torch.from_numpy(scaled_window(n, bps).copy())
    G = -(-n // (STRIP * GROUP_STRIPS))
    span = G * STRIP * GROUP_STRIPS
    Lp = -(-(max(lags) + 1) // LAG_TILE) * LAG_TILE
    pos = torch.arange(span + Lp) % F
    ext = torch.where(pos < n, d[:, pos.clamp(max=n - 1)], 0.0)
    x = torch.where(torch.arange(span) < n, ext[:, :span], 0.0)
    x = x.reshape(V, G * GROUP_STRIPS, STRIP)
    lane = torch.arange(GROUP_STRIPS)
    out = torch.empty((V, len(lags)), dtype=torch.float64)
    for col, k in enumerate(lags):
        y = ext[:, k:k + span].reshape(V, G * GROUP_STRIPS, STRIP)
        acc = torch.zeros((V, G * GROUP_STRIPS), dtype=torch.float64)
        for t in range(STRIP):
            acc = acc + x[:, :, t] * y[:, :, t]
        acc = acc.reshape(V, G, GROUP_STRIPS)
        for off in (1, 2, 4, 8, 16):
            acc = acc + acc[:, :, lane ^ off]
        groups = acc[:, :, 0]
        total = None
        for g0 in range(0, G, STAGE_GROUPS):
            part = [groups[:, g]
                    for g in range(g0, min(G, g0 + STAGE_GROUPS))]
            s = 1
            while s < len(part):
                for g in range(0, len(part) - s, 2 * s):
                    part[g] = part[g] + part[g + s]
                s *= 2
            total = part[0] if total is None else total + part[0]
        out[:, col] = total * (float(F) / float(n))
    return out


def test_k8_order_error_within_the_stated_bound():
    """At n = 16384 and 24 bits, K8's order is within 2^-46 of r0 of the
    exact rational autocorrelation (exact.py states 73 u = 2^-46.8), and
    within 2^-45 r0 of the plain version."""
    n, bps, lags = 16384, 24, (0, 1, 7, 64, 262)
    work = _rows(n, bps, seed=3)[:2]
    F = round_up_pow2(n)
    emu = k8_order(torch.from_numpy(work), n, bps, lags, F).numpy()
    plain = autocorr_plain(torch.from_numpy(work), n, bps, max(lags) + 1,
                           F).numpy()[:, list(lags)]
    win = scaled_window(n, bps)
    for r in range(work.shape[0]):
        d = [Fraction(float(v)) for v in work[r].astype(np.float64) * win]
        d += [Fraction(0)] * (F - n)
        r0 = sum(v * v for v in d) * Fraction(F, n)
        for col, k in enumerate(lags):
            want = sum(d[i] * d[(i + k) % F]
                       for i in range(F)) * Fraction(F, n)
            err = abs(Fraction(float(emu[r, col])) - want) / r0
            assert err <= Fraction(1, 2 ** 46), (r, k, float(err))
        assert (np.abs(emu[r] - plain[r]) <= float(r0) * 2.0 ** -45).all()


def test_routing_cpu_plain_meta_raises():
    work = torch.from_numpy(_rows(256, 16, seed=1))
    before = autocorr.launches
    got = autocorr(work, 256, 16, 9, 256)
    assert autocorr.launches == before
    assert torch.equal(got, autocorr_plain(work, 256, 16, 9, 256))
    with pytest.raises(ValueError):
        autocorr(torch.empty((2, 256), dtype=torch.int32, device="meta"),
                 256, 16, 9, 256)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("n,bps,L", [(333, 16, 65), (4064, 16, 65),
                                     (4096, 16, 263), (16384, 24, 65),
                                     (20000, 24, 263)])
def test_autocorr_kernel_on_card(cuda, n, bps, L):
    """Bit-equal to the emulation of its order, within 2^-45 r0 of the
    plain version; 20000 samples take two stages."""
    work = torch.from_numpy(_rows(n, bps, seed=n)).to(cuda)
    F = round_up_pow2(n)
    before = autocorr.launches
    got = autocorr(work, n, bps, L, F)
    want = autocorr_plain(work, n, bps, L, F)
    torch.cuda.synchronize()
    assert autocorr.launches == before + 1
    lags = (0, 1, 7, L - 1)
    emu = k8_order(work.cpu(), n, bps, lags, F)
    assert torch.equal(got[:, list(lags)].cpu(), emu)
    r0 = want[:, :1].abs()
    assert ((got - want).abs() <= r0 * 2.0 ** -45).all()


@pytest.mark.gpu
def test_autocorr_wrong_dtype_raises_on_card(cuda):
    with pytest.raises(ValueError):
        autocorr(torch.zeros((2, 256), dtype=torch.int64, device=cuda), 256,
                 16, 9, 256)
