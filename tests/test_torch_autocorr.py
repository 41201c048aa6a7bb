"""K8, the encode's windowed circular autocorrelation
(srla_tpu_torch.kernels.autocorr), against the JAX package and the exact sum.

- autocorr on CPU tensors (its plain version) against JAX's df64
  _autocorr_dd at n 256, 333 (odd), 1024 and 4064, 16 and 24 bits, 9, 65
  and 263 lags: within 2^-43 of r0 (JAX's lags are good to ~2^-44).
- The kernel's summation order (a chain of 16 DMMAs of 4 products an
  accumulator, a pairwise tree over a stage's chunks, a pairwise tree over
  a lag's 16 residues, stages of 4096 samples in order), emulated exactly
  in integers with either order inside a DMMA, at n 16384 (24 bits), 333
  and 50, against the exact rational sum: within its written bound (75 u
  of r0 at n 16384, under 2^-46), the bound exact.py states for K8.
- The DMMA fragment map (mma.m16n8k4.f64, lane -> row, column) rebuilt
  in numpy: every lag is each product (i, i + lag) once, over every
  stage, step and pass of K8's plan.
- The routing: a CPU tensor takes the plain version and leaves
  autocorr.launches at 0; a meta tensor raises.
- On the card (marked gpu): the kernel within its bound of the exact sum,
  bit-equal to the emulation of its order with the DMMA as a chain of
  fused multiply-adds, and within 2^-45 r0 of the plain version, at n 50
  to 20000 (five stages) and 1 to 1024 lags; a CUDA tensor of the wrong
  dtype raises."""

import functools
import math
from fractions import Fraction

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from srla_tpu.kernels import df64 as dd  # noqa: E402
from srla_tpu.kernels.exact import _autocorr_dd  # noqa: E402
from srla_tpu_torch.dsp.fft import round_up_pow2  # noqa: E402
from srla_tpu_torch.dsp.window import welch_divisor  # noqa: E402
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

STAGE, CHUNK_ROWS, MAX_RUN, RES = 4096, 64, 10, 16
# The order a DMMA keeps inside (k8_order): the model the card's
# mma.m16n8k4.f64 matches bit for bit (a chain of fused multiply-adds in
# depth order).
DMMA_MODEL = "chain"


def k8_plan(L: int):
    """csrc/autocorr.cu make_plan: (TW, runs, TP, Q, passes)."""
    tiles = (L + 14) // 8 + 1
    TW = min(tiles, MAX_RUN)
    runs = 1 if tiles <= MAX_RUN else 2
    TP = TW * runs
    Q = TP - 2
    passes = 1 if tiles <= MAX_RUN else -(-(L - 1) // (8 * Q))
    return TW, runs, TP, Q, passes


def k8_pass_lags(L: int, p: int):
    """The first tile and the lags lo..hi that pass p of K8 owns."""
    _, _, _, Q, _ = k8_plan(L)
    T0 = Q * p
    return T0, (0 if p == 0 else 8 * T0 + 1), min(L - 1, 8 * (T0 + Q))


def k8_roundings(n: int) -> int:
    """The most roundings a product passes in K8's order (csrc/autocorr.cu,
    exact.py above _EPS_PREEMPH): 5 in its DMMA and 4 in each of the 15
    after it, 2 in the chunk tree, 4 in the residue tree, one a stage after
    the first, and the multiply by F / n."""
    return 65 + 2 + 4 + (-(-n // STAGE) - 1) + 1


def _rnd(v: int) -> int:
    """v rounded to 53 significant bits, ties to even (float(int) rounds
    so), kept as an int at the same scale."""
    return int(float(v))


def k8_order(work: np.ndarray, n: int, bps: int, lags, F: int,
             dmma: str = "chain"):
    """The lags ``lags`` of work (V, n) int32 summed in K8's order
    (csrc/autocorr.cu), exactly: every sample d = x * w is an integer at a
    common power-of-two scale, so products and sums are exact ints and
    every rounding is one explicit _rnd. A DMMA adds its 4 depth rows'
    products to the accumulator either as a chain of fused multiply-adds in
    depth order (dmma="chain") or as one exact sum rounded once
    (dmma="once"); an accumulator takes a chunk's 16 DMMAs in order, a
    stage's chunks a pairwise tree, a lag's 16 residues a pairwise tree,
    stages in order, then the multiply by F / n. Returns (V, len(lags))
    f64."""
    d = work.astype(np.float64) * scaled_window(n, bps)
    out = np.empty((work.shape[0], len(lags)))
    for r in range(work.shape[0]):
        S = max((53 - math.frexp(float(v))[1] for v in d[r] if v != 0),
                default=0)
        di = [int(math.ldexp(float(v), S)) for v in d[r]]
        ext = [di[j % F] if j % F < n else 0
               for j in range(n + max(lags) + 16)]
        for col, lag in enumerate(lags):
            total = None
            for s0 in range(0, n, STAGE):
                live = n - s0
                rows = min(STAGE // RES, -(-live // RES))
                chunks = -(-rows // CHUNK_ROWS)
                res = []
                for m in range(RES):
                    part = []
                    for k in range(chunks):
                        acc = 0
                        for q0 in range(k * CHUNK_ROWS, (k + 1) * CHUNK_ROWS,
                                        4):
                            prods = [di[s0 + i] * ext[s0 + i + lag]
                                     if i < live else 0
                                     for i in (RES * q + m
                                               for q in range(q0, q0 + 4))]
                            if dmma == "chain":
                                for p in prods:
                                    acc = _rnd(acc + p)
                            else:
                                acc = _rnd(acc + sum(prods))
                        part.append(acc)
                    s = 1
                    while s < chunks:
                        for g in range(0, chunks - s, 2 * s):
                            part[g] = _rnd(part[g] + part[g + s])
                        s *= 2
                    res.append(part[0])
                s = 1
                while s < RES:
                    for m in range(0, RES, 2 * s):
                        res[m] = _rnd(res[m] + res[m + s])
                    s *= 2
                total = res[0] if total is None else _rnd(total + res[0])
            out[r, col] = math.ldexp(float(total), -2 * S) * (float(F)
                                                               / float(n))
    return out


def exact_lags(work: np.ndarray, n: int, bps: int, lags, F: int):
    """[(r0, [lag, ...])] per row: the exact rational circular lags and
    r0, scaled by F / n."""
    win = scaled_window(n, bps)
    rows = []
    for r in range(work.shape[0]):
        d = [Fraction(float(v)) for v in work[r].astype(np.float64) * win]
        d += [Fraction(0)] * (F - n)
        r0 = sum(v * v for v in d) * Fraction(F, n)
        rows.append((r0, [sum(d[i] * d[(i + k) % F] for i in range(n))
                          * Fraction(F, n) for k in lags]))
    return rows


def _within_bound(emu, exact, n: int) -> None:
    h = k8_roundings(n)
    gamma = Fraction(h, 2 ** 53 - h)          # h u / (1 - h u)
    for r, (r0, want) in enumerate(exact):
        for col, w in enumerate(want):
            err = abs(Fraction(float(emu[r, col])) - w)
            assert err <= gamma * r0, (r, col, float(err / r0))


def test_k8_order_error_within_the_stated_bound():
    """At n = 16384 and 24 bits, K8's order (both DMMA models) is within
    its written bound, 75 u of r0 (exact.py: 2^-46.8), of the exact
    rational autocorrelation, so within 2^-46; and within 2^-45 r0 of the
    plain version."""
    n, bps, lags = 16384, 24, (0, 1, 7, 64, 262)
    assert k8_roundings(n) == 75
    work = _rows(n, bps, seed=3)[:2]
    F = round_up_pow2(n)
    exact = exact_lags(work, n, bps, lags, F)
    plain = autocorr_plain(torch.from_numpy(work), n, bps, max(lags) + 1,
                           F).numpy()[:, list(lags)]
    for model in ("chain", "once"):
        emu = k8_order(work, n, bps, lags, F, model)
        _within_bound(emu, exact, n)
        for r, (r0, _) in enumerate(exact):
            assert (np.abs(emu[r] - plain[r])
                    <= float(r0) * 2.0 ** -45).all()


@pytest.mark.parametrize("n,bps,lags", [(333, 16, (0, 1, 7, 64, 262)),
                                        (50, 24, (0, 1, 7, 8, 49, 63))])
def test_k8_order_short_rows_within_bound(n, bps, lags):
    """n not a multiple of 8, and n < 64 (one partial chunk, lags up to
    and past n, circular): both DMMA models within the written bound of
    the exact sum."""
    work = _rows(n, bps, seed=n)
    F = round_up_pow2(n)
    exact = exact_lags(work, n, bps, lags, F)
    for model in ("chain", "once"):
        _within_bound(k8_order(work, n, bps, lags, F, model), exact, n)


# ---------------------------------------------------------------------------
# The DMMA fragment map and the lag plan
# ---------------------------------------------------------------------------

def _fragments():
    """PTX ISA, mma.m16n8k4 with .f64 (g = l >> 2, t = l & 3): lane l holds
    A[g][t] and A[g + 8][t], B[t][g], and C[g][2t + i], C[g + 8][2t + i]
    for i = 0, 1, in that order."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    a = [np.stack([g, t], 1), np.stack([g + 8, t], 1)]
    b = np.stack([t, g], 1)
    c = [((l >> 2) + 8 * (r >> 1), 2 * (l & 3) + (r & 1))
         for l in range(32) for r in range(4)]
    return a, b, c


@pytest.mark.parametrize("n,L", [(333, 65), (4096, 263), (50, 9),
                                 (1024, 1024), (20000, 1)])
def test_k8_fragment_map_covers_each_product_once(n, L):
    """Rebuild, in numpy, which sample pairs each DMMA of K8 multiplies:
    place lane l's sample offsets (csrc/autocorr.cu item: 16 t + g and 16 t
    + g + 8 for A, 16 t + g + 8 u for tile u's B) into A and B by the
    fragment map, check that C's lane map is where the kernel stores each
    entry, then take each lag's 16 residue entries as the kernel does, over
    every stage, step and pass, with A masked past n. Every lag must be the
    sum of the pairs (i, i + lag), i < n, each exactly once, and owned by
    exactly one pass."""
    a_maps, b_map, c_map = _fragments()
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    A = np.full((16, 4), -1)
    for a_map, extra in zip(a_maps, (0, 8)):
        A[a_map[:, 0], a_map[:, 1]] = 16 * t + g + extra
    B = np.full((4, 8), -1)               # tile 0; tile u adds 8 u
    B[b_map[:, 0], b_map[:, 1]] = 16 * t + g
    assert (A == 16 * np.arange(4)[None, :] + np.arange(16)[:, None]).all()
    assert (B == 16 * np.arange(4)[:, None] + np.arange(8)[None, :]).all()
    stored = [8 * (l >> 2) + 2 * (l & 3) + (r & 1) + 64 * (r >> 1)
              for l in range(32) for r in range(4)]
    assert [m * 8 + j for m, j in c_map] == stored
    assert sorted(stored) == list(range(128))
    _, _, TP, _, passes = k8_plan(L)
    owner = np.zeros(L, int)
    i = np.arange(n)
    for p in range(passes):
        T0, lo, hi = k8_pass_lags(L, p)
        owner[lo:hi + 1] += 1
        for lag in range(lo, hi + 1):
            got = []
            for m in range(RES):
                u = ((lag + m) >> 3) - T0
                j = (lag + m) & 7
                assert 0 <= u < TP
                for s0 in range(0, n, STAGE):
                    rows = min(STAGE // RES, -(-(n - s0) // RES))
                    r = np.arange(0, rows, 4)[:, None]
                    ia = s0 + RES * r + A[m][None, :]
                    ib = s0 + RES * r + B[:, j][None, :] + 8 * (T0 + u)
                    keep = ia < n
                    got.append(np.stack([ia[keep], ib[keep]], 1))
            got = np.concatenate(got)
            got = got[np.argsort(got[:, 0], kind="stable")]
            assert np.array_equal(got, np.stack([i, i + lag], 1)), (p, lag)
    assert (owner == 1).all()


@pytest.mark.parametrize("bps", [16, 24])
def test_k8_window_formula_is_scaled_window(bps):
    """csrc/autocorr.cu window() makes each windowed sample's window from
    welch_divisor(n) and 2^-(bps-1): (divisor * k) * (n - 1 - k) * scale, k
    the distance to the nearer end, 0 in the middle of an odd row. In
    numpy, with the same roundings, it is scaled_window bit for bit."""
    for n in (1, 2, 5, 50, 333, 4064, 4096, 16384, 20000):
        i = np.arange(n)
        k = np.minimum(i, n - 1 - i).astype(np.float64)
        with np.errstate(invalid="ignore"):     # n 1: inf * 0, the middle
            w = (welch_divisor(n) * k) * (n - 1 - k) * 2.0 ** -(bps - 1)
        if n & 1:
            w[n // 2] = 0.0
        assert np.array_equal(w, scaled_window(n, bps)), n


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

def _on_card(cuda, n: int, bps: int, L: int, lags) -> None:
    """K8 on the card, launched once: within its written bound of the exact
    sum and bit-equal to the exact emulation of its order at ``lags``, and
    within 2^-45 r0 of the plain version at every lag."""
    work_np = _rows(n, bps, seed=n + L)
    work = torch.from_numpy(work_np).to(cuda)
    F = round_up_pow2(n)
    before = autocorr.launches
    got = autocorr(work, n, bps, L, F)
    want = autocorr_plain(work, n, bps, L, F)
    torch.cuda.synchronize()
    assert autocorr.launches == before + 1
    r0 = want[:, :1].abs()
    assert ((got - want).abs() <= r0 * 2.0 ** -45).all()
    g = got[:, list(lags)].cpu().numpy()
    _within_bound(g, exact_lags(work_np, n, bps, lags, F), n)
    emu = k8_order(work_np, n, bps, lags, F, DMMA_MODEL)
    assert np.array_equal(g, emu), np.abs(g - emu).max()


@pytest.mark.gpu
@pytest.mark.parametrize("n,bps,L", [(333, 16, 65), (4064, 16, 65),
                                     (4096, 16, 263), (16384, 24, 65),
                                     (20000, 24, 263), (50, 24, 9)])
def test_autocorr_kernel_on_card(cuda, n, bps, L):
    """Shapes: n not a multiple of 8, the tail group's, the pitch lags,
    four stages, five stages with two passes, n < 64."""
    _on_card(cuda, n, bps, L, (0, 1, 7, L - 1))


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 65, 263, 1024])
def test_autocorr_lag_counts_on_card(cuda, L):
    """1, 65, 263 and 1024 lags at n 4096: two tiles, one pass of 10, two
    passes of 20 tiles, eight passes."""
    _on_card(cuda, 4096, 16, L, sorted({0, L // 2, L - 1}))


@pytest.mark.gpu
def test_autocorr_wrong_dtype_raises_on_card(cuda):
    with pytest.raises(ValueError):
        autocorr(torch.zeros((2, 256), dtype=torch.int64, device=cuda), 256,
                 16, 9, 256)
