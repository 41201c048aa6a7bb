"""K12's schedule (csrc/svr_refine.cu), modelled in plain torch on the CPU
and held bit for bit to ``svr_refine_plain``, before the kernel runs it on
the card. The kernel runs the row's margins at once, six slots at a time
(each its own trajectory from the initial vector), scores the initial
vector once for all of them, runs only the residual and the mean-abs chain
at the last iteration, keeps each slot's first least objective (``mbest``)
and a few scalars an iteration, and replays the adopt decisions in
(margin, iteration) order afterwards; it finds max_j (C^-1)_jj by columns
in batches that start at j0, dropping the exact zeros above each column's
diagonal. The model does the same in the same order, so every output must
equal the plain version's exactly: the coefficients, cerr, the flag and the
iterations run.

Rows (make_music's variants and four edge rows, n 512, M 16): a row of
order 0, a singular one (silence at order 4), a pure sine and white noise;
each case at max_iter 1, 2 and 3 (margins stop early at 3), kappa' 100 on
half the rows (e_0 > 0) and 0 on the rest, and a margin list with exact
duplicates (ties across margins at every iteration) that fills two batches.
Change the kernel's schedule and this model together.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from srla_tpu_torch.constants import SVR_MARGIN_LIST  # noqa: E402
from srla_tpu_torch.kernels import svr  # noqa: E402

from test_torch_svr import BPS, RIDGE, host_init, svr_rows  # noqa: E402

N, M = 512, 16
F64 = torch.float64
SLOTS = 6
# Duplicates tie exactly at every iteration; seven margins fill two
# batches of six slots.
TIED_MARGINS = (0.0, 1.0 / 1024, 1.0 / 1024, 1.0 / 64, 0.0, 1.0 / 16,
                1.0 / 4096)


def inverse_diag_max_batched(A, inv, o, B: int):
    """max_j (C^-1)_jj with the columns in batches of B from j0: y_k of
    column j for k >= j0 only, its chain over m started at j0."""
    V = A.shape[0]
    out = torch.zeros(V, dtype=F64)
    for j0 in range(0, M, B):
        cols = torch.arange(j0, min(M, j0 + B))
        Y = torch.zeros((V, M, len(cols)), dtype=F64)
        dsum = torch.zeros((V, len(cols)), dtype=F64)
        for k in range(j0, M):
            s = (cols == k).to(F64).expand(V, -1)
            for m in range(j0, k):
                s = s - A[:, k, m:m + 1] * Y[:, m, :]
            y = torch.where((k < o)[:, None], s * inv[:, k:k + 1], 0.0)
            Y[:, k, :] = y
            dsum = dsum + y * y
        out = torch.maximum(out, dsum.max(dim=1).values)
    return out


def _residual(d, dpad, vec, o, n):
    """d[s] + sum_i vec[..., i] d[s - i - 1], taps in order, for s >= o.
    vec (V, K, M) -> (V, K, n)."""
    res_on = (torch.arange(n)[None, :] >= o[:, None])[:, None, :]
    r = d[:, None, :].expand(-1, vec.shape[1], -1)
    for i in range(int(o.max())):
        tap = dpad[:, None, M - i - 1:M - i - 1 + n]
        r = torch.where(res_on & (i < o)[:, None, None],
                        r + vec[:, :, i:i + 1] * tap, r)
    return r


def keep_first_least(mbest, mmin, obj, cur, alive):
    """Each slot's kept vector: cur where obj is below every objective the
    slot scored before (its first least objective), as K12's lanes keep
    it. mbest, cur (V, K, M); mmin, obj, alive (V, K)."""
    take = alive & (obj < mmin)
    return (torch.where(take[:, :, None], cur, mbest),
            torch.where(take, obj, mmin))


def replay(hist, kb, state):
    """The adopt decisions of one batch of kb slots in (margin, iteration)
    order, as K12's replay lane makes them: hist a list over iterations of
    (obj, eps, cerr's candidate, ran), each (V, kb); state (min_obj,
    eps_min, cerr, risky), each (V,). Returns the new state, the slot each
    row adopted last in this batch (-1: none) and the exact ties between
    two objectives after iteration 0 it met."""
    min_obj, eps_min, cerr, risky = state
    src = torch.full(min_obj.shape, -1)
    ties = 0
    for m in range(kb):
        for it, (obj, eps, ce, ran) in enumerate(hist):
            on = ran[:, m]
            gap = obj[:, m] - min_obj
            if it > 0:
                ties += int((on & (gap == 0)).sum())
            # An exact tie is not flagged.
            risky = risky | (on & (gap != 0)
                             & (gap.abs() < eps[:, m] + eps_min))
            adopt = on & (obj[:, m] < min_obj)
            min_obj = torch.where(adopt, obj[:, m], min_obj)
            eps_min = torch.where(adopt, eps[:, m], eps_min)
            cerr = torch.where(adopt, ce[:, m], cerr)
            src = torch.where(adopt, m, src)
    return (min_obj, eps_min, cerr, risky), src, ties


def schedule_model(work, cov, coefs, orders, n, max_iter, margins, kappa):
    """svr_refine_plain's outputs computed in K12's schedule. Returns
    (best, cerr, risky, iters) and the number of exact ties between two
    margins' objectives after iteration 0 that the replay met."""
    V = coefs.shape[0]
    o = orders.long()
    d = work.to(F64) * 2.0 ** -(BPS - 1)
    act = torch.arange(M)[None, :] < o[:, None]
    init = torch.where(act, coefs, 0.0)
    A, inv, singular, risky = svr.cholesky_plain(cov, o)
    live = (o > 0) & ~singular
    diag = torch.diagonal(cov, dim1=1, dim2=2)
    tr = svr._seq_sum(torch.where(act, diag, 0.0))
    lam = torch.where(act, diag, math.inf).min(dim=1).values \
        * (RIDGE / (1.0 + RIDGE))
    sq_lam = torch.sqrt(torch.where(live, lam, 1.0))
    sq_cinv = torch.sqrt(inverse_diag_max_batched(A, inv, o, 5))
    maxd = d.abs().max(dim=1).values
    of = o.to(F64)
    g_sum = svr._gamma(n)
    g_res = svr._gamma(of + 1.0) * maxd * math.sqrt(n)
    g_rvec = g_sum * torch.sqrt(of) * maxd / sq_lam
    g_solve = 2.0 * svr._gamma(3.0 * of + 3.0) * tr / sq_lam
    # e_0: each row sum of |C| in j order, a thread a row; then the rows.
    rsum = torch.zeros((V, M), dtype=F64)
    for j in range(M):
        rsum = rsum + cov[:, :, j].abs()
    e0 = ((svr._SVR_INIT_REL * kappa) * init.abs().max(dim=1).values) \
        * torch.sqrt(svr._seq_sum(torch.where(act, rsum, 0.0)))
    dpad = torch.nn.functional.pad(d, (M, 0))
    lo = int(o.clamp(min=1).min())

    best = init.clone()
    min_obj = torch.full((V,), svr.SVR_FLT_MAX, dtype=F64)
    eps_min = torch.zeros(V, dtype=F64)
    cerr = torch.zeros(V, dtype=F64)
    iters = torch.zeros(V, dtype=torch.int32)
    ties = 0
    for b0 in range(0, len(margins), SLOTS):
        marg = torch.tensor(margins[b0:b0 + SLOTS], dtype=F64)
        kb = len(marg)
        cur = init[:, None, :].repeat(1, kb, 1)
        mbest = cur.clone()
        mmin = torch.full((V, kb), svr.SVR_FLT_MAX, dtype=F64)
        e = e0[:, None].repeat(1, kb)
        prev = torch.full((V, kb), svr.SVR_FLT_MAX, dtype=F64)
        eps_prev = torch.zeros((V, kb), dtype=F64)
        alive = live[:, None].repeat(1, kb)
        hist = []                      # (obj, eps, cerr's candidate, ran)
        for it in range(max_iter):
            last = it + 1 == max_iter
            if not bool(alive.any()):
                break
            if it == 0:                # every slot scores init: once
                r = _residual(d, dpad, init[:, None, :], o, n)
                r = r.expand(-1, kb, -1)
            else:
                r = _residual(d, dpad, cur, o, n)
            mag = r.abs()
            mabse = torch.zeros((V, kb), dtype=F64)
            rvec = torch.zeros((V, kb, M), dtype=F64)
            sum_th = torch.zeros((V, kb), dtype=F64)
            if not last:
                th = torch.where(r > 0, 1.0, torch.where(r < 0, -1.0, 0.0)) \
                    * torch.clamp(mag - marg[None, :, None], min=0.0)
            for s in range(lo, n):     # the tiles, consumed in order
                on = (s >= o)[:, None]
                mabse = torch.where(on, mabse + mag[:, :, s], mabse)
                if last:
                    continue
                win = dpad[:, s:s + M].flip(1)[:, None, :]
                rvec = torch.where(on[:, :, None] & act[:, None, :],
                                   rvec + th[:, :, s:s + 1] * win, rvec)
                sum_th = torch.where(on, sum_th + th[:, :, s].abs(), sum_th)
            moved = e > 0
            g_r = torch.where(moved, g_res[:, None] * (1.0 + svr._seq_sum(
                cur.abs().reshape(V * kb, M)).reshape(V, kb)), 0.0)
            mab_err = math.sqrt(n) * (e + g_r) + torch.where(
                moved, g_sum * mabse, 0.0)
            eps = svr._EPS_SVR_LIBM + torch.where(
                mab_err > 0, 2.0 * mab_err / (mabse * math.log(2.0)), 0.0)
            obj, r_k2 = svr.rgr_mean_code_length(
                (mabse / n).reshape(-1), eps.reshape(-1))
            obj, r_k2 = obj.reshape(V, kb), r_k2.reshape(V, kb)
            risky = risky | (alive & r_k2).any(dim=1)
            hist.append((obj, eps, torch.zeros_like(e) if it == 0
                         else e * sq_cinv[:, None], alive))
            mbest, mmin = keep_first_least(mbest, mmin, obj, cur, alive)
            if last:
                break
            dp = prev - obj
            adp = dp.abs()
            e2 = eps + eps_prev
            b_unc = (adp - svr.SVR_OBJ_EPSILON).abs() < e2
            a_unc = (dp != 0) & (adp < e2)
            b_true = adp < svr.SVR_OBJ_EPSILON - e2
            risky = risky | (alive & (b_unc | (a_unc & ~b_true))).any(dim=1)
            stop = (prev < obj) | (adp < svr.SVR_OBJ_EPSILON)
            step = alive & ~stop
            delta = svr.cholesky_solve_plain(
                A.repeat_interleave(kb, 0), inv.repeat_interleave(kb, 0),
                rvec.reshape(V * kb, M), o.repeat_interleave(kb)
            ).reshape(V, kb, M)
            cur = torch.where(step[:, :, None] & act[:, None, :],
                              cur + delta, cur)
            dn = svr._seq_sum((delta * delta).reshape(V * kb, M))
            e_next = 2.0 * e + g_r + torch.where(
                moved, g_rvec[:, None] * sum_th, 0.0) \
                + g_solve[:, None] * torch.sqrt(dn.reshape(V, kb))
            e = torch.where(step, e_next, e)
            prev = torch.where(alive, obj, prev)
            eps_prev = torch.where(alive, eps, eps_prev)
            alive = step
        state, src, t = replay(hist, kb, (min_obj, eps_min, cerr, risky))
        min_obj, eps_min, cerr, risky = state
        ties += t
        for *_, ran in hist:
            iters = iters + ran.sum(dim=1).to(torch.int32)
        pick = mbest[torch.arange(V), src.clamp(min=0)]
        best = torch.where((src >= 0)[:, None], pick, best)
    best = torch.where(live[:, None] & act, best, 0.0)
    return (best, cerr, risky, iters), ties


def _inputs():
    """The rows, their covariance, the host's initial coefficients, orders
    with a row of order 0 (white noise) and a singular one (silence at
    order 4), and kappa' 100 on every other row."""
    work = svr_rows(N)
    _, coefs, orders = host_init(work, N, M, 2)
    orders = orders.astype(np.int32)
    orders[-2] = 0
    orders[-1] = 4
    w = torch.from_numpy(work)
    o = torch.from_numpy(orders)
    cov = svr.svr_cov_plain(w, o, N, BPS, M, RIDGE)
    kappa = torch.tensor([100.0 * (b % 2) for b in range(len(orders))],
                         dtype=F64)
    return w, cov, torch.from_numpy(coefs[:, :M]).contiguous(), o, kappa


def test_replay_equals_the_adopts_in_margin_order():
    """Random scalar trajectories (objectives from a set of four, so that
    slots and iterations tie; margins wide enough to flag; slots that stop
    early): the kept first least vectors and the replay adopt the same
    entry, with the same flags and cerr, as the plain version's loop, which
    adopts as each margin's iterations run."""
    rng = np.random.RandomState(5)
    V, kb, iters = 400, 4, 3
    obj = torch.from_numpy(rng.choice([1.0, 1.5, 2.0, 2.5],
                                      (iters, V, kb)))
    eps = torch.from_numpy(rng.choice([0.0, 0.3, 0.6], (iters, V, kb)))
    ce = torch.from_numpy(rng.rand(iters, V, kb))
    nit = rng.randint(1, iters + 1, (V, kb))
    ran = torch.from_numpy(np.arange(iters)[:, None, None] < nit[None])
    entry = torch.arange(iters * kb, dtype=F64).reshape(iters, 1, kb, 1)
    # The plain version's order: margin by margin, adopting as it goes.
    want_min = torch.full((V,), svr.SVR_FLT_MAX, dtype=F64)
    want_eps = torch.zeros(V, dtype=F64)
    want_cerr = torch.zeros(V, dtype=F64)
    want_risky = torch.zeros(V, dtype=torch.bool)
    want_best = torch.full((V,), -1.0, dtype=F64)
    for m in range(kb):
        for it in range(iters):
            on = ran[it, :, m]
            gap = obj[it, :, m] - want_min
            want_risky |= on & (gap != 0) \
                & (gap.abs() < eps[it, :, m] + want_eps)
            adopt = on & (obj[it, :, m] < want_min)
            want_min = torch.where(adopt, obj[it, :, m], want_min)
            want_eps = torch.where(adopt, eps[it, :, m], want_eps)
            want_cerr = torch.where(adopt, ce[it, :, m], want_cerr)
            want_best = torch.where(adopt, entry[it, 0, m, 0], want_best)
    # K12's: the slots run their iterations at once, then the replay.
    mbest = torch.full((V, kb, 1), -1.0, dtype=F64)
    mmin = torch.full((V, kb), svr.SVR_FLT_MAX, dtype=F64)
    for it in range(iters):
        mbest, mmin = keep_first_least(mbest, mmin, obj[it],
                                       entry[it].expand(V, kb, 1), ran[it])
    state, src, _ = replay([(obj[i], eps[i], ce[i], ran[i])
                            for i in range(iters)], kb,
                           (torch.full((V,), svr.SVR_FLT_MAX, dtype=F64),
                            torch.zeros(V, dtype=F64),
                            torch.zeros(V, dtype=F64),
                            torch.zeros(V, dtype=torch.bool)))
    best = torch.where(src >= 0, mbest[torch.arange(V), src.clamp(min=0), 0],
                       -1.0)
    assert torch.equal(best, want_best)
    for g, w in zip(state, (want_min, want_eps, want_cerr, want_risky)):
        assert torch.equal(g, w)
    assert want_risky.any() and not want_risky.all()


def test_inverse_diag_in_column_batches_equals_plain():
    """Columns batched from j0 (B 1, 5, 7 and all): the rows above each
    column's diagonal are exact zeros, so the result is the plain one."""
    w, cov, _, o, _ = _inputs()
    A, inv, _, _ = svr.cholesky_plain(cov, o.long())
    want = svr.inverse_diag_max_plain(A, inv, o.long())
    for B in (1, 5, 7, M):
        assert torch.equal(inverse_diag_max_batched(A, inv, o.long(), B),
                           want), B


@pytest.mark.parametrize("max_iter,margins", [
    (1, SVR_MARGIN_LIST), (2, SVR_MARGIN_LIST), (3, SVR_MARGIN_LIST),
    (2, TIED_MARGINS), (3, TIED_MARGINS)])
def test_schedule_equals_plain(max_iter, margins):
    w, cov, coefs, o, kappa = _inputs()
    want = svr.svr_refine_plain(w, cov, coefs, o, N, BPS, max_iter,
                                margins, RIDGE, kappa)
    got, ties = schedule_model(w, cov, coefs, o, N, max_iter, margins,
                               kappa)
    for name, g, x in zip(("coefficients", "cerr", "flags", "iterations"),
                          got, want):
        assert torch.equal(g, x), name
    iters = want[3].numpy()
    live = iters > 0
    # The order-0 and singular rows run nothing; the rest every margin.
    assert not live[-2:].any() and live[:-2].all()
    assert (want[0][-2:] == 0).all()
    if max_iter == 3:                  # some margin stops early
        assert (iters[live] < 3 * len(margins)).any()
    if margins is TIED_MARGINS and max_iter > 1:
        assert ties > 0
