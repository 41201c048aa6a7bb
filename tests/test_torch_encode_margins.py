"""The decision-boundary flags of the port's f64 encode analysis
(srla_tpu_torch.kernels.exact) at the boundaries themselves.

Each test drives one decision to its boundary (the pre-emphasis
coefficient's rounding half, a tie of two LPC orders, a coefficient's
quantization half and the shift's frexp edge, the Rice parameter boundaries
of rice_k_boundaries, and the long-term prediction's crossing signs, peak
tests, threshold, ratio, Cholesky pivots and coefficient rounding) and to
points a few float roundings and a few margins away from it, hands the
port's stage inputs moved by the error the margins are sized for (2^-42
relative, see the comments above the margins in exact.py, rice_search.py
and ltp.py) and the host's stage (srla_tpu_torch.host_encoder and its dsp/
and rice modules) the unmoved ones, and checks the contract of the flags:
every row whose decision differs from the host's is flagged risky. Rows on
the boundary must be flagged and rows several margins away must not, so the
tests are not vacuous. One test pins the summation error bound that the
margins rest on. CPU only: a kernel that changes the order of these sums
has to keep this file passing.
"""

import math
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from srla_tpu_torch import rice  # noqa: E402
from srla_tpu_torch.constants import (LPC_COEFFICIENT_BITWIDTH,  # noqa: E402
                                      RSHIFT_LPC_COEFFICIENT_BITWIDTH)
from srla_tpu_torch.dsp import preemphasis as host_preemphasis  # noqa: E402
from srla_tpu_torch.dsp.autocorr import autocorr_fft  # noqa: E402
from srla_tpu_torch.dsp.fft import round_up_pow2  # noqa: E402
from srla_tpu_torch.dsp.quantize import quantize_coefficients  # noqa: E402
from srla_tpu_torch.dsp.window import welch_window  # noqa: E402
from srla_tpu_torch.host_encoder import (EncodeParameter,  # noqa: E402
                                         SRLAEncoder)
from srla_tpu_torch import native_decoder  # noqa: E402
from srla_tpu_torch.constants import (  # noqa: E402
    LPC_RIDGE_REGULARIZATION_PARAMETER, LTP_MAX_PERIOD, LTP_MIN_PERIOD)
from srla_tpu_torch.kernels import exact, ltp, rice_search  # noqa: E402

# The relative error of the analysis inputs that the margins allow for.
MOVE = 2.0 ** -42


def _moved(values: np.ndarray) -> np.ndarray:
    """values with every entry moved by MOVE, up and down in turns."""
    signs = np.where(np.arange(values.size) % 2 == 0, 1.0, -1.0)
    return values * (1.0 + MOVE * signs.reshape(values.shape))


def _assert_flag_contract(port, host, risky, must_flag, must_not_flag):
    """port == host wherever the port does not flag; the rows on a boundary
    are flagged, the rows well away from one are not."""
    port, host, risky = (np.asarray(a) for a in (port, host, risky))
    differs = port != host
    if differs.ndim > 1:
        differs = differs.any(axis=tuple(range(1, differs.ndim)))
    assert not (differs & ~risky).any(), np.flatnonzero(differs & ~risky)
    assert risky[must_flag].all(), np.flatnonzero(~risky & must_flag)
    assert not risky[must_not_flag].any(), np.flatnonzero(
        risky & must_not_flag)


# ---------------------------------------------------------------------------
# The summation error the margins rest on
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,bps", [(16384, 24), (4096, 16), (4064, 16)])
def test_autocorrelation_error_within_the_stated_bound(n, bps):
    """Port (tree sums of the lag products) and host (real FFT) against the
    exact rational autocorrelation: under 2^-50 and 2^-42 of r0."""
    rng = np.random.RandomState(n)
    hi = 1 << (bps - 1)
    work = np.stack([
        rng.randint(-hi, hi, n),
        (np.sin(np.arange(n) * 0.01) * hi * 0.9).astype(np.int64),
    ]).astype(np.int32)
    fft_size = round_up_pow2(n)
    lags = (0, 1, 7)
    port = exact.autocorr(torch.from_numpy(work), n, bps, lags[-1] + 1,
                          fft_size).numpy()
    windowed = work.astype(np.float64) * 2.0 ** -(bps - 1) * welch_window(n)
    host = autocorr_fft(windowed.copy(), n, lags[-1] + 1)
    scale = Fraction(fft_size, n)
    for r in range(work.shape[0]):
        d = [Fraction(float(v)) for v in windowed[r]]
        d += [Fraction(0)] * (fft_size - n)
        r0 = sum(v * v for v in d) * scale
        for k in lags:
            want = sum(d[i] * d[(i + k) % fft_size]
                       for i in range(fft_size)) * scale
            port_err = abs(Fraction(float(port[r, k])) - want) / r0
            host_err = abs(Fraction(float(host[r, k])) - want) / r0
            assert port_err <= Fraction(1, 2 ** 50), (r, k, float(port_err))
            assert host_err <= Fraction(1, 2 ** 42), (r, k, float(host_err))


# ---------------------------------------------------------------------------
# Pre-emphasis: 16 * r1 / r0 at a rounding half
# ---------------------------------------------------------------------------

def _preemphasis_rows(n=256, scale=1 << 15):
    """Integer rows with 16 * r1 / r0 = +-7.5 exactly (a pair (15, +-15)
    and singles 5, 2, 1 between zeros: r1 = +-225, r0 = 480), then the same
    with one more single of e = 1 (inside the margin), 40 and 4000 (outside),
    all times ``scale``."""
    rows, kinds = [], []
    for sign in (1, -1):
        for extra in (0, 1, 40, 4000):
            x = np.zeros(n, np.int64)
            x[3], x[4] = 15 * scale, sign * 15 * scale
            x[10], x[20], x[30] = 5 * scale, 2 * scale, scale
            x[40] = extra
            rows.append(x)
            kinds.append(extra)
    return np.stack(rows).astype(np.int32), np.asarray(kinds)


def test_preemphasis_half_boundary_is_flagged():
    sig, extra = _preemphasis_rows()
    _, coef, risky = exact.preemphasis_exact(torch.from_numpy(sig))
    host = host_preemphasis.calculate_coefficient(sig, sig.shape[1])
    _assert_flag_contract(coef.numpy(), host, risky.numpy(),
                          must_flag=extra <= 1, must_not_flag=extra >= 40)
    # Away from the boundary both round 7.5 - d to 7 (and -7.5 + d to -7).
    np.testing.assert_array_equal(coef.numpy()[extra >= 40],
                                  [7, 7, -7, -7])


# ---------------------------------------------------------------------------
# LPC order: two orders whose estimated lengths tie
# ---------------------------------------------------------------------------

N_ORDER, BPS, MAX_PARAMS = 4096, 16, 32
GAPS = (0.0, 1e-9, -1e-9, 1e-7, -1e-7, 5e-7, -5e-7, 1e-3, -1e-3, 0.5, -0.5)


def _length(ev, order):
    mabse = 2.0 * np.sqrt(ev / 2.0)
    rho = 1.0 / (1.0 + mabse * float(1 << (BPS - 1)))
    ent = -((1.0 - rho) * np.log2(1.0 - rho) + rho * np.log2(rho)) / rho
    return ent * N_ORDER + LPC_COEFFICIENT_BITWIDTH * order


def _order_tie_rows():
    """Error variances whose best order is 9 and whose runner-up, order
    17, is longer by each of GAPS bits (bisection on ev[17])."""
    rng = np.random.RandomState(5)
    base = np.empty(MAX_PARAMS + 1)
    base[0] = 0.02
    for j in range(1, MAX_PARAMS + 1):
        base[j] = base[j - 1] * (1.0 - rng.uniform(0.0, 0.002))
    base[9:] *= 0.7                       # a real gain at order 9
    lengths = _length(base[1:], np.arange(1, MAX_PARAMS + 1))
    assert lengths.argmin() + 1 == 9
    rows = []
    for gap in GAPS:
        lo, hi = base[17] * 0.5, base[17]
        target = lengths[8] + gap
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if _length(mid, 17) < target:
                lo = mid
            else:
                hi = mid
        ev = base.copy()
        ev[17] = hi
        rows.append(ev)
    return np.stack(rows), np.abs(np.asarray(GAPS))


def test_order_tie_is_flagged():
    ev, gap = _order_tie_rows()
    param = EncodeParameter(num_channels=1, bits_per_sample=BPS,
                            sampling_rate=44100, preset=4,
                            min_num_samples_per_block=N_ORDER,
                            max_num_samples_per_block=N_ORDER)
    host = SRLAEncoder(param)._select_order(ev, N_ORDER, MAX_PARAMS)
    orders, risky = exact.select_order_exact(
        torch.from_numpy(_moved(ev)), N_ORDER, BPS, MAX_PARAMS, False,
        torch.ones(ev.shape[0], dtype=torch.float64))
    assert set(np.asarray(host).tolist()) <= {9, 17}
    _assert_flag_contract(orders.numpy(), host, risky.numpy(),
                          must_flag=gap <= 5e-7, must_not_flag=gap >= 1e-3)


# ---------------------------------------------------------------------------
# Quantization: coef * 2^rshift at a rounding half, max |coef| at the edges
# ---------------------------------------------------------------------------

NBITS = LPC_COEFFICIENT_BITWIDTH
MAX_BITS = 1 << RSHIFT_LPC_COEFFICIENT_BITWIDTH


def _quantize_rows():
    """Orders of 4 with max |coef| = 0.88 (shift NBITS - 1). The last
    coefficient is a whole number of steps; the one before sits on a half,
    a few ulps and 1e-9, 1e-5 and 0.17 steps beside it. Then rows whose
    max |coef| is 0.5 (the frexp edge), just below it, and the smallest
    representable step 2^-(NBITS - 1) and its neighbours."""
    step = 2.0 ** -(NBITS - 1)
    rows, flag, clear = [], [], []
    for off in (0.0, 2.0 ** -45, -2.0 ** -45, 1e-9, -1e-9, 1e-5, -1e-5,
                0.17, -0.17):
        for half in (20.5, -37.5):
            rows.append([0.88, 0.25, (half + off) * step, 12 * step])
            flag.append(abs(off) <= 1e-9)
            clear.append(abs(off) >= 1e-5)
    for top in (0.5, np.nextafter(0.5, 0.0), 0.5 * (1 - 1e-8),
                step, np.nextafter(step, 1.0), np.nextafter(step, 0.0)):
        rows.append([top, 0.3 * top, -0.2 * top, 0.1 * top])
        flag.append(True)
        clear.append(False)
    for top in (0.7, 0.3, 100 * step):
        rows.append([top, 0.3 * top, -0.21 * top, 0.13 * top])
        flag.append(False)
        clear.append(False)
    return np.asarray(rows), np.asarray(flag), np.asarray(clear)


def test_quantization_half_and_shift_edges_are_flagged():
    coefs, must_flag, must_not_flag = _quantize_rows()
    V, M = coefs.shape
    orders = np.full(V, M, np.int64)
    host_c, host_r = quantize_coefficients(coefs, orders, NBITS, MAX_BITS)
    intc, rshift, risky = exact.quantize_exact(
        torch.from_numpy(_moved(coefs)), torch.from_numpy(orders), NBITS,
        MAX_BITS, torch.ones(V, dtype=torch.float64))
    port = np.concatenate([intc.numpy(), rshift.numpy()[:, None]], axis=1)
    host = np.concatenate([host_c, host_r[:, None]], axis=1)
    _assert_flag_contract(port, host, risky.numpy(), must_flag,
                          must_not_flag)


@pytest.mark.parametrize("M", [64, 128, 255])
def test_coefficient_growth_is_flagged(M):
    """Lags built from the reflection coefficient +-5/32 at every order
    (chip_smoke.k7_growth_case): the port's lags moved by 2^-42 change the
    chosen order by tens at M 128 and 255 (the coefficients grow to sum |a|
    ~ 1.2e7 and 3.3e9 while r0 / min |ev| stays 23 and 503), so the widened
    conditioning estimate must flag the row there; at M 64 (sum |a| ~ 1.6e3)
    nothing moves and nothing is flagged."""
    import chip_smoke
    name, lags, n, bps, M, fixed, must, must_not = \
        chip_smoke.k7_growth_case(np, M)
    from srla_tpu_torch.kernels.levinson import lpc_analyze_plain
    port = lpc_analyze_plain(torch.from_numpy(_moved(lags)), n, bps, M,
                             fixed)
    host = chip_smoke.host_lpc(np, lags, n, bps, M, fixed)
    _assert_flag_contract(
        np.concatenate([port[0].numpy()[:, None], port[1].numpy()[:, None],
                        port[2].numpy()], axis=1),
        np.concatenate([np.asarray(host[0])[:, None],
                        np.asarray(host[1])[:, None], np.asarray(host[2])],
                       axis=1),
        port[3].numpy(), must, must_not)
    # Not vacuous: at M >= 128 the moved lags do change the decisions.
    assert (int(port[0][0]) != int(host[0][0])) == (M >= 128)


# ---------------------------------------------------------------------------
# Rice parameters: partition means at the boundaries of both chains
# ---------------------------------------------------------------------------

def _boundary_means(bounds):
    """Each boundary 1..31, its float neighbours (1 and 16 ulps), and
    points 1e-12, 1e-6 and 1e-3 (relative) to both sides. Returns (means,
    near, far): ``near`` marks the points within a few ulps or 1e-12, ``far``
    those at 1e-3."""
    means, near, far = [], [], []
    for b in bounds[1:32]:
        pts = [b]
        for ulps in (1, 16):
            up = down = b
            for _ in range(ulps):
                up, down = np.nextafter(up, np.inf), np.nextafter(down, 0.0)
            pts += [up, down]
        pts += [b * (1 + 1e-12), b * (1 - 1e-12)]
        means += pts
        near += [True] * len(pts)
        far += [False] * len(pts)
        means += [b * (1 + 1e-6), b * (1 - 1e-6), b * (1 + 1e-3),
                  b * (1 - 1e-3)]
        near += [False] * 4
        far += [False, False, True, True]
    return np.asarray(means), np.asarray(near), np.asarray(far)


@pytest.mark.parametrize("chain", ["plain", "recursive"])
def test_rice_parameter_boundaries_are_flagged(chain):
    (kb, kb_eps), (tb, tb_eps) = rice_search.rice_k_boundaries()
    bounds, eps, host_k = ((kb, kb_eps, rice.rice_k_array)
                           if chain == "plain" else
                           (tb, tb_eps, rice.recursive_rice_k2_array))
    means, near, far = _boundary_means(bounds)
    moved = torch.from_numpy(_moved(means))
    # The plain chain is trusted below _PLAIN_K_TRUSTED only (the host's
    # own chain cancels at larger means); the table ends at 31.
    top = rice_search._PLAIN_K_TRUSTED if chain == "plain" else 31
    k, flagged = rice_search._count_and_flag(
        moved, bounds, eps, torch.zeros(means.size, dtype=torch.bool),
        top=top)
    host = host_k(means)
    assert flagged.numpy()[k.numpy() >= top].all()
    _assert_flag_contract(k.numpy(), host, flagged.numpy(),
                          must_flag=near,
                          must_not_flag=far & (means < bounds[top] * 0.99))


def test_rice_rows_at_the_type_boundary_are_flagged():
    """A row whose mean zigzag code is exactly 2 sits on the plain /
    recursive choice; one whose mean is 2 + 1 / n does not."""
    n, max_porder = 512, 5
    res = np.ones((2, n), np.int32)           # zigzag 2 everywhere
    res[1, 0] = -2                            # zigzag 3: mean 2 + 1 / n
    u, ks, recursive, _, risky = rice_search.rice_params(
        torch.from_numpy(res), n, max_porder)
    assert risky.tolist() == [True, False]
    ct, _, _, host_ks = rice.analyze_batch(res, n)
    assert recursive.tolist() == [True, True] and list(ct) == [1, 1]
    # Order 0's parameter of the unflagged row is the host's.
    assert int(ks[1, 0]) == int(host_ks[1, 0])


# ---------------------------------------------------------------------------
# Long-term prediction: the lag scan, the solve and the rounding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [512, 4096])
def test_ltp_lag_error_within_the_stated_bound(n):
    """The pitch lags up to 262, port and host, against the exact rational
    autocorrelation: under 2^-50 and 2^-42 of r0 (ltp.py's margins rest on
    the host's bound)."""
    rng = np.random.RandomState(n + 1)
    work = np.stack([
        rng.randint(-(1 << 15), 1 << 15, n),
        (np.sin(np.arange(n) * 2 * np.pi / 225) * 30000).astype(np.int64),
    ]).astype(np.int32)
    lags = (0, 1, 130, 261, 262)
    port = exact.ltp_lags(torch.from_numpy(work), n, 16, n).numpy()
    windowed = work.astype(np.float64) * 2.0 ** -15 * welch_window(n)
    host = autocorr_fft(windowed.copy(), n, LTP_MAX_PERIOD + 1)
    for r in range(work.shape[0]):
        d = [Fraction(float(v)) for v in windowed[r]]
        r0 = sum(v * v for v in d)
        for k in lags:
            want = sum(d[i] * d[(i + k) % n] for i in range(n))
            port_err = abs(Fraction(float(port[r, k])) - want) / r0
            host_err = abs(Fraction(float(host[r, k])) - want) / r0
            assert port_err <= Fraction(1, 2 ** 50), (r, k, float(port_err))
            assert host_err <= Fraction(1, 2 ** 42), (r, k, float(host_err))


_HEAD = [1.0, 0.5, 0.2, 0.1, 0.0, -0.1, -0.2, -0.3]


_SLOPE = [0.02, 0.03, 0.04, 0.05, 0.06, 0.0, 0.055, 0.045, 0.035, 0.025]


def _pitch_row(peak=0.5, first=None):
    """Lags with r0 = 1: a segment at 150..159 whose peak is ``peak`` at
    155 (period 155), and, if ``first``, one before it at 50..59 whose peak
    is ``first`` at 55; every lag in a segment differs from its neighbours
    by far more than the margin; -0.3 elsewhere (-0.31 at 261, so that the
    host's last look at lag 262 meets no tie), zeros past lag 262."""
    r = np.full(ltp.LTP_COLS, -0.3)
    r[:8] = _HEAD
    r[LTP_MAX_PERIOD - 1] = -0.31
    r[150:160], r[155] = _SLOPE, peak
    if first is not None:
        r[50:60], r[55] = _SLOPE, first
    r[LTP_MAX_PERIOD + 1:] = 0.0
    return r


def _ltp_boundary_rows():
    """(lags, must_flag, must_not_flag, order) of rows that put one LTP
    decision on its boundary and a few ulps, 1e-13 and 1e-6 (relative to
    r0) beside it: a crossing lag at 0, a peak's neighbour equal to it, the
    peak at 0.1 r0, a first peak at 0.9 of the largest, a Cholesky pivot at
    0 (r1 = r2 = r0 * (1 + ridge)), and an order-1 coefficient * 32 at 20.5
    (1e-9 and 1e-5 units beside it)."""
    rows, flag, clear, orders = [], [], [], []

    def add(r, d, near, far, order=1):
        rows.append(r)
        flag.append(abs(d) <= near)
        clear.append(abs(d) >= far)
        orders.append(order)

    for d in (0.0, 2.0 ** -45, -2.0 ** -45, 1e-13, -1e-13, 1e-6, -1e-6):
        r = _pitch_row()
        r[149] = d                           # the crossing into the segment
        add(r, d, 1e-13, 1e-6)
        r = _pitch_row(peak=0.06)
        r[154] = 0.06 + d                    # the peak's left neighbour
        add(r, d, 1e-13, 1e-6)
        add(_pitch_row(peak=0.1 + d), d, 1e-13, 1e-6)   # the threshold
        add(_pitch_row(first=0.9 * 0.5 + d), d, 1e-13, 1e-6)   # the ratio
        r = _pitch_row()
        r[1] = r[2] = (1.0 + LPC_RIDGE_REGULARIZATION_PARAMETER) * (1.0 + d)
        add(r, d, 1e-13, np.inf, order=3)    # the second pivot
    a0r = 1.0 + LPC_RIDGE_REGULARIZATION_PARAMETER
    for d in (0.0, 2.0 ** -40, -2.0 ** -40, 1e-9, -1e-9, 1e-5, -1e-5, 0.17):
        add(_pitch_row(peak=(20.5 + d) / 32.0 * a0r), d, 1e-9, 1e-5)
    return (np.stack(rows), np.asarray(flag), np.asarray(clear),
            np.asarray(orders))


def _moved_lags(lags: np.ndarray) -> np.ndarray:
    """Every lag moved by MOVE of r0, up and down in turns."""
    signs = np.where(np.arange(lags.shape[1]) % 2 == 0, 1.0, -1.0)
    return lags + MOVE * np.abs(lags[:, :1]) * signs[None, :]


def test_ltp_decision_boundaries_are_flagged():
    lags, must_flag, must_not_flag, orders = _ltp_boundary_rows()
    for order in (1, 3):
        sel = orders == order
        host_p, host_c = native_decoder.ltp_analyze_batch(
            lags[sel][:, :LTP_MAX_PERIOD + 3].copy(), order, LTP_MIN_PERIOD,
            LTP_MAX_PERIOD, LPC_RIDGE_REGULARIZATION_PARAMETER)
        period, coefs, risky = ltp.ltp_analyze_plain(
            torch.from_numpy(_moved_lags(lags[sel])), order)
        port = np.concatenate([period.numpy()[:, None], coefs.numpy()], 1)
        host = np.concatenate([host_p[:, None], host_c], 1)
        _assert_flag_contract(port, host, risky.numpy(), must_flag[sel],
                              must_not_flag[sel])
        # Not vacuous: the rows beside a boundary take both outcomes.
        assert len(set(host_p.tolist())) > 1


# ---------------------------------------------------------------------------
# SVR refinement: pivots, objectives, the estimate's k2 and the widened
# quantization (kernels/svr.py, the margins' comment)
# ---------------------------------------------------------------------------

def _svr_problem(covs, n=64, seed=5):
    """Rows of order 2 with the given 2 x 2 ridged covariances (the rows'
    samples only feed the loop, which the pivot tests stop before)."""
    from srla_tpu_torch.kernels import svr
    V = len(covs)
    cov = torch.zeros((V, 4, 4), dtype=torch.float64)
    for b, c in enumerate(covs):
        cov[b, :2, :2] = torch.tensor(c, dtype=torch.float64)
    work = torch.from_numpy(np.random.RandomState(seed).randint(
        -1000, 1000, (V, n)).astype(np.int32))
    coefs = torch.full((V, 4), 0.25, dtype=torch.float64)
    orders = torch.full((V,), 2, dtype=torch.int32)
    return svr.svr_refine_plain(work, cov, coefs, orders, n, 16, 2,
                                (0.0,), LPC_RIDGE_REGULARIZATION_PARAMETER,
                                torch.zeros(V, dtype=torch.float64))


def test_svr_pivot_near_zero_is_flagged():
    """A second pivot of 1e-12 C_00 (under 2^-36), one of -1e-12 (the
    host's singular case, which zeroes the row), a well-conditioned block
    and an all-zero one (exactly singular on both sides: not flagged)."""
    best, _, risky, _ = _svr_problem([
        [[1.0, 1.0], [1.0, 1.0 + 1e-12]],
        [[1.0, 1.0], [1.0, 1.0 - 1e-12]],
        [[1.0, 0.5], [0.5, 1.0]],
        [[0.0, 0.0], [0.0, 0.0]]])
    assert risky.tolist() == [True, True, False, False]
    assert (best[1] == 0).all() and (best[3] == 0).all()
    assert (best[2, :2] != 0).all()


def _scripted_objectives(monkeypatch, values):
    """Make the estimate return ``values`` (one list a row) call by call,
    its k2 flag down: the comparisons after it then see those objectives."""
    from srla_tpu_torch.kernels import svr
    calls = iter(zip(*values))

    def scripted(mean, eps):
        return (torch.tensor(next(calls), dtype=torch.float64),
                torch.zeros_like(mean, dtype=torch.bool))

    monkeypatch.setattr(svr, "rgr_mean_code_length", scripted)


def test_svr_objective_comparisons_on_their_edges_are_flagged(monkeypatch):
    """Rows of three iterations at one margin, objectives scripted: a
    change on the 1e-8 convergence edge (and 2e-14 beside it) is flagged,
    one of 3e-8 or 1e-3 is not (the stop is certain either way), nor is
    an exact tie (NOTES trap 3); the adopt comparison within the margin of
    the best so far is flagged (a rise of 1e-15 over it, a fall of 1e-13).
    The last iteration's stop decides nothing and is never flagged."""
    from srla_tpu_torch.kernels import svr
    E = svr.SVR_OBJ_EPSILON
    rows = [
        [5.0, 5.0 - E, 4.0],               # |prev - obj| = 1e-8: edge
        [5.0, 5.0 - E * (1 + 2e-6), 4.0],  # 2e-14 beside it
        [5.0, 5.0 - 3 * E, 4.0],           # certain: no stop
        [5.0, 5.0 + 1e-15, 4.0],           # stop, a hair over the best
        [5.0, 5.0 + 1e-3, 4.0],            # certain: stop
        [5.0, 5.0, 4.0],                   # exact tie: stop
        [5.0, 4.0, 4.0 + 1e-13],           # adopt near-tie at iteration 2
        [5.0, 4.0, 3.0 + E],               # last stop on its edge: moot
    ]
    _scripted_objectives(monkeypatch, rows)
    V = len(rows)
    n = 64
    work = torch.from_numpy(np.random.RandomState(6).randint(
        -1000, 1000, (V, n)).astype(np.int32))
    cov = torch.zeros((V, 2, 2), dtype=torch.float64)
    cov[:, 0, 0] = cov[:, 1, 1] = 1.0
    _, _, risky, iters = svr.svr_refine_plain(
        work, cov, torch.full((V, 2), 0.1, dtype=torch.float64),
        torch.full((V,), 2, dtype=torch.int32), n, 16, 3, (0.0,),
        LPC_RIDGE_REGULARIZATION_PARAMETER,
        torch.zeros(V, dtype=torch.float64))
    assert risky.tolist() == [True, True, False, True, False, False, True,
                              False]
    assert iters.tolist() == [2, 3, 3, 2, 2, 2, 3, 3]


def test_svr_estimate_on_a_k2_integer_is_flagged():
    """A mean whose log2v is an integer to the last bits is flagged at any
    margin; one 1e-6 away is not."""
    from srla_tpu_torch.kernels import svr
    om = math.exp(svr.LOG_OPTX / 2.0 ** 5)
    m0 = (1.0 / (1.0 - om) - 1.0) / 65536.0
    means = torch.tensor([m0, m0 * (1 + 1e-6)], dtype=torch.float64)
    _, risky = svr.rgr_mean_code_length(
        means, torch.full((2,), svr._EPS_SVR_LIBM, dtype=torch.float64))
    assert risky.tolist() == [True, False]


def test_svr_widened_quantization_margin():
    """Refined coefficients within cerr of the host's: a coefficient whose
    scaled value is 2 * 2^rshift * cerr from a rounding half (inside the
    widened margin, 4 * 2^rshift * cerr) is flagged, one 8 * 2^rshift *
    cerr away is not, and with cerr 0 K7's own margin rules."""
    from srla_tpu_torch.kernels.levinson import lpc_quantize_plain
    step = 2.0 ** -(NBITS - 1)
    cerr = 1e-9
    rows = [[0.88, 0.25, (20.5 + k * cerr / step) * step, 12 * step]
            for k in (2.0, -2.0, 8.0, -8.0, 2.0)]
    coefs = torch.tensor(rows, dtype=torch.float64)
    V = len(rows)
    _, _, risky = lpc_quantize_plain(
        coefs, torch.full((V,), 4, dtype=torch.int32),
        torch.ones(V, dtype=torch.float64),
        torch.tensor([cerr] * 4 + [0.0], dtype=torch.float64))
    assert risky.tolist() == [True, True, False, False, False]


def _svr_rows_and_host(n, M, preset, iters):
    import test_torch_svr as tsvr
    work = tsvr.svr_rows(n)
    dbl, coefs, orders = tsvr.host_init(work, n, M, preset)
    refined, _ = host_svr_refine(dbl, coefs, orders, n, iters)
    host_c, host_r = quantize_coefficients(refined, orders, NBITS, MAX_BITS)
    return work, dbl, coefs, orders, host_c, host_r


def host_svr_refine(dbl, coefs, orders, n, iters):
    from srla_tpu_torch.constants import SVR_MARGIN_LIST
    from srla_tpu_torch.dsp.svr import svr_refine_batch
    return svr_refine_batch(dbl, coefs, orders, n, iters, 16,
                            LPC_RIDGE_REGULARIZATION_PARAMETER,
                            SVR_MARGIN_LIST)


@pytest.mark.parametrize("n,M,preset", [(1024, 16, 2), (2048, 32, 3)])
def test_svr_from_initial_coefficients_moved_by_k7_error(n, M, preset):
    """The refinement from the host's initial coefficients moved by K7's
    allowance (rho max|c| each, rho = 4 kappa' 2^-42 and kappa' K7's
    estimate of the row, in alternating directions: a normwise move, so the
    small tail coefficients move by as much as the largest) against the
    host's from the unmoved ones, through the widened quantization: every
    row whose quantized coefficients or shift differ from the host's is
    flagged. The rows are make_music's variants, a pure sine
    (ill-conditioned), a near-silent row, white noise and zeros."""
    from srla_tpu_torch.constants import SVR_MARGIN_LIST
    from srla_tpu_torch.kernels import svr
    from srla_tpu_torch.kernels.levinson import (levinson,
                                                 lpc_quantize_plain)
    work, dbl, coefs, orders, host_c, host_r = _svr_rows_and_host(
        n, M, preset, 2)
    ac = autocorr_fft(dbl * welch_window(n), n, M + 1)
    ac[:, 0] *= 1.0 + LPC_RIDGE_REGULARIZATION_PARAMETER
    _, _, _, _, kappa = levinson(torch.from_numpy(ac), M)
    rho = 4.0 * 2.0 ** -42 * kappa.numpy()
    signs = np.where(np.arange(M) % 2 == 0, 1.0, -1.0)
    cmax = np.abs(np.where(np.arange(M)[None, :] < orders[:, None],
                           coefs[:, :M], 0.0)).max(axis=1)
    moved = coefs[:, :M] + (rho * cmax)[:, None] * signs[None, :]
    w = torch.from_numpy(work)
    o = torch.from_numpy(orders.astype(np.int32))
    cov = svr.svr_cov_plain(w, o, n, 16, M,
                            LPC_RIDGE_REGULARIZATION_PARAMETER)
    best, cerr, r_svr, _ = svr.svr_refine_plain(
        w, cov, torch.from_numpy(moved), o, n, 16, 2, SVR_MARGIN_LIST,
        LPC_RIDGE_REGULARIZATION_PARAMETER, kappa)
    rshift, intc, r_q = lpc_quantize_plain(best, o, kappa, cerr)
    port = np.concatenate([intc.numpy(), rshift.numpy()[:, None]], axis=1)
    host = np.concatenate([np.where(np.arange(M)[None, :] < orders[:, None],
                                    host_c[:, :M], 0),
                           np.where(orders > 0, host_r, 0)[:, None]], axis=1)
    port[:, -1] = np.where(orders > 0, port[:, -1], 0)
    risky = (r_svr | r_q).numpy()
    none = np.zeros(len(orders), bool)
    _assert_flag_contract(port, host, risky, none, none)
    # Not vacuous: the moved vectors are refined (most rows unflagged).
    assert (~risky).sum() >= len(orders) - 3
