"""A CPU model of K10's warp decomposition (csrc/ltp_analyze.cu), held
against the serial scan of its plain version (kernels/ltp.py
pitch_scan_plain) before the card runs the kernel.

The model runs the kernel's algorithm lane by lane in numpy: 32 lanes of 8
consecutive scan lags each (lane 31: 256..261); the lag-local tests; the
segment-state map of each lane's lags and its exclusive scan by map
composition; the segmented scan of each segment's running peak (strict
greater, first index); the exclusive scan of each lane's peaked closes,
which decides the cap of 20 candidates; the flags of the live lags and the
candidates written at their ranks; lane 31's look at lag 262; the running
maximum of the appended peaks as a max scan over the candidate lanes, the
threshold, the ratio test and the first qualifying candidate. Every scan is
the Kogge-Stone shuffle-up scan of the kernel (five steps over 32 lanes).
Periods and flags must equal pitch_scan_plain's, and with ltp_solve_plain
after it the whole of ltp_analyze_plain's, on the edge rows of
tests/test_torch_ltp.py, chip_smoke.k10_edge_lags and seeded random rows
(chip_smoke.k10_random_lags: the cap binding, equal peaks, lags at 0).
Everything is exact: the model does the plain version's f64 operations
(comparisons, |a - b| < eps, a product) in another order of lags only."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from srla_tpu_torch.kernels import ltp  # noqa: E402
from test_torch_ltp import _edge_lags  # noqa: E402

LANES, PER = 32, 8
MIN_PERIOD, MAX_PERIOD, MAX_CAND = 8, 262, 20


def _scan(vals, combine):
    """Inclusive Kogge-Stone scan over the lanes, as __shfl_up_sync does
    it: at step off, lane l >= off combines lane l - off's value (earlier)
    with its own."""
    v = list(vals)
    off = 1
    while off < LANES:
        v = [combine(v[l - off], v[l]) if l >= off else v[l]
             for l in range(LANES)]
        off <<= 1
    return v


def _exclusive(inclusive, ident):
    """What lane l gets from __shfl_up_sync(x, 1), lane 0 the identity."""
    return [ident] + inclusive[:-1]


def _compose(first, second):
    """Segment-state maps as (state after from 0, state after from 1)."""
    return (second[first[0]], second[first[1]])


def _combine(first, second):
    """(opened, peak, index) of two runs of lags, first then second."""
    if second[0]:
        return second
    return (first[0],) + (second[1:] if second[1] > first[1] else first[1:])


def k10_scan_model(a: np.ndarray):
    """One row of lags (266,) through K10's warp decomposition. Returns
    (period before the guards, risky) as pitch_scan_plain's."""
    eps = abs(a[0]) * ltp._LTP_EPS_REL
    near = lambda x, y: abs(x - y) < eps  # noqa: E731
    lags = [[j for j in range(MIN_PERIOD + PER * l, MIN_PERIOD + PER * l + PER)
             if j < MAX_PERIOD] for l in range(LANES)]
    up = {j: bool(a[j - 1] < 0 and a[j] > 0) for js in lags for j in js}
    down = {j: bool(a[j] > 0 and a[j + 1] < 0 and j < MAX_PERIOD - 1)
            for js in lags for j in js}
    rk = [False] * LANES

    # 1. Lag-local tests; each lane's segment map, scanned.
    maps = []
    for l, js in enumerate(lags):
        m = (0, 1)
        for j in js:
            rk[l] |= bool(abs(a[j - 1]) < eps or abs(a[j]) < eps)
            m = _compose(m, (int(up[j]), int(not down[j])))
        maps.append(m)
    s_in = [m[0] for m in _exclusive(_scan(maps, _compose), (0, 1))]

    def walk(l, sp, si):
        """The lane's lags from its incoming state: per lag (j, enter, in,
        the peak before its update, close, the peak after)."""
        s, out = bool(s_in[l]), []
        for j in lags[l]:
            enter = not s and up[j]
            inn = s or enter
            if enter:
                sp, si = 0.0, 0
            before = sp
            if inn and a[j] > a[j - 1] and a[j] > a[j + 1] and a[j] > sp:
                sp, si = a[j], j
            close = inn and not enter and down[j]
            out.append((j, enter, inn, before, close, sp, si))
            s = inn and not close
        return out, s

    # 2. Each segment's running peak, scanned.
    # A lane's run from (0, 0): whether it opens a segment, and the peak
    # after its last lag (from its last opening, if any).
    aggs = []
    for l in range(LANES):
        steps = walk(l, 0.0, 0)[0]
        aggs.append((any(st[1] for st in steps),) + steps[-1][5:])
    before = _exclusive(_scan(aggs, _combine), (False, 0.0, 0))

    # 3. Peaked closes, counted and scanned: the cap's count.
    counts = [sum(1 for *_, close, _, si in walk(l, *before[l][1:])[0]
                  if close and si != 0) for l in range(LANES)]
    base = _exclusive(_scan(counts, lambda x, y: x + y), 0)

    # 4. The live lags' flags and the candidates at their ranks.
    cands = {}
    for l in range(LANES):
        steps, s = walk(l, *before[l][1:])
        c = base[l]
        for j, enter, inn, sp_before, close, sp, si in steps:
            live = inn and c < MAX_CAND
            if live:
                pk = a[j] > a[j - 1] and a[j] > a[j + 1]
                rk[l] |= bool(near(a[j], a[j - 1]) or near(a[j], a[j + 1]))
                rk[l] |= bool(pk and near(a[j], sp_before))
                rk[l] |= bool(not enter and (abs(a[j]) < eps
                                             or abs(a[j + 1]) < eps))
            if close and si != 0:
                if live:
                    cands[c] = (sp, si)
                c += 1
        if l == LANES - 1:
            last = (s, enter, live, sp, si, c)

    # Lane 31: lag 262.
    s, enter, live, sp, si, c = last
    ncand = min(c, MAX_CAND)
    inseg = s and live
    tail = (inseg and enter and live) or (not inseg and ncand < MAX_CAND)
    if tail and not inseg:
        sp, si = 0.0, 0
    if tail:
        am1, a0, ap1 = a[MAX_PERIOD - 1], a[MAX_PERIOD], a[MAX_PERIOD + 1]
        rk[31] |= bool(near(a0, am1) or near(a0, ap1))
        pk = a0 > am1 and a0 > ap1
        rk[31] |= bool(pk and near(a0, sp))
        if pk and a0 > sp:
            sp, si = a0, MAX_PERIOD
    if (inseg or tail) and si != 0:
        cands[ncand] = (sp, si)
        ncand += 1

    # Candidate k on lane k: the max scan, the threshold, the ratio, the
    # first qualifying candidate (a ballot).
    cv = [cands[l][0] if l < ncand else 0.0 for l in range(LANES)]
    run = _scan(cv, max)
    mp_before = _exclusive(run, 0.0)
    mp = run[-1]
    for l in range(ncand):
        rk[l] |= bool(near(cv[l], mp_before[l]))
    thresh = a[0] * ltp._PITCH_THRESH
    ok = ncand > 0 and not (mp < thresh)
    risky = any(rk) or bool(near(mp, thresh))
    ratio = mp * ltp._PITCH_RATIO
    qual = []
    for l in range(ncand):
        risky |= bool(abs(cv[l] - ratio) < eps)
        if not (cv[l] < ratio):
            qual.append(l)
    period = cands[qual[0]][1] if ok and qual else 0
    return period, risky


def _model_rows(lags: np.ndarray):
    got = [k10_scan_model(r) for r in lags]
    return (np.asarray([p for p, _ in got], np.int64),
            np.asarray([r for _, r in got]))


def _check(lags: np.ndarray):
    period, risky = _model_rows(lags)
    ac = torch.from_numpy(lags)
    want_p, want_r = ltp.pitch_scan_plain(ac)
    np.testing.assert_array_equal(period, want_p.numpy())
    np.testing.assert_array_equal(risky, want_r.numpy())
    for order in (1, 3):
        got = ltp.ltp_solve_plain(ac, torch.from_numpy(period), order,
                                  torch.from_numpy(risky))
        for g, w in zip(got, ltp.ltp_analyze_plain(ac, order)):
            assert torch.equal(g, w)
    return period, risky


def test_model_matches_plain_on_edge_rows():
    period, risky = _check(np.concatenate([_edge_lags()[0],
                                           chip_smoke.k10_edge_lags(np)]))
    assert (period == MAX_PERIOD).any()          # lag 262 reached
    assert (~risky).any() and risky.any()


@pytest.mark.parametrize("seed", range(4))
def test_model_matches_plain_on_random_rows(seed):
    lags = chip_smoke.k10_random_lags(np, 60, seed)
    period, risky = _check(lags)
    assert (~risky).sum() >= 20 and risky.sum() >= 20
    # The cap binds on some rows: more than 20 segments.
    opens = ((lags[:, 7:261] < 0) & (lags[:, 8:262] > 0)).sum(axis=1)
    assert (opens > 2 * MAX_CAND).any()
