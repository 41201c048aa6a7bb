"""SVR refinement of the encode's LPC coefficients
(``--svr-filter-learning-iteration``): K11, the ridged covariance of each
row, and K12, the refinement loop, with the estimator they share.

- ``svr_cov`` is the twin of ``srla_tpu.kernels.exact._svr_cov`` (and
  ``_dd_cumsum``) and the host's ``dsp.svr._covariance``: on a CUDA tensor it
  launches ``csrc/svr_cov.cu`` (K11), on a CPU tensor it runs
  ``svr_cov_plain``.
- ``svr_refine`` is the twin of ``srla_tpu.kernels.exact._svr_exact`` after
  its covariance (``_cholesky_dd``, ``_cholesky_solve_dd``,
  ``_rgr_code_length_dd`` and the margin x iteration loop) and of the host's
  ``dsp.svr.svr_refine_one`` after ``_covariance``: on a CUDA tensor it
  launches ``csrc/svr_refine.cu`` (K12), on a CPU tensor it runs
  ``svr_refine_plain``.
- ``rgr_mean_code_length`` is the tensor twin of ``dsp.svr.
  _rgr_mean_code_length`` with a flag on its k2 truncation.

The JAX package works in df64, sums pairwise and by prefix sums, and adds a
step of iterative refinement to its solve. The port follows the host
instead: every sum the host makes sample by sample (each covariance
element, the mean-abs sum, each r-vector entry) and every dot product of
the Cholesky factor and its solves (descending k, as ``dsp/pitch.py``) is
one f64 chain in the host's order, each product rounded before its add, and
there is no refinement step. Given the host's covariance and initial
coefficients the port then repeats the host's arithmetic exactly, apart
from libm: the inverse pivots are 1/sqrt(s) where the host calls
pow(s, -0.5) (they differ by at most an ulp or two), and the estimate's log
and pow are the platform's. The kernels and their plain versions use the
same operations in the same order, so they agree bit for bit (on the card
torch's log and pow are the libdevice functions the kernels call).

Parity targets: libs/lpc/src/lpc.c:988-1163 (SVR), the host's
``dsp/svr.py`` and ``dsp/pitch.py`` Cholesky.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

_F64 = torch.float64
SVR_BPS = 16                      # the estimator's depth (lpc.c:1041)
SVR_FLT_MAX = 3.402823466e38
SVR_OBJ_EPSILON = 1e-8            # the host's convergence epsilon
LOG_OPTX = math.log(0.5127629514)  # the host's log(OPTX), by libm
INV_LOGE2 = 1.4426950408889634
_U = 2.0 ** -53                   # the unit roundoff of f64

# Margins of SVR's decisions, and the difference they must cover between
# the port's values and the host's. Three sources make the two differ:
#
#   (a) the initial coefficients: each coefficient of K7's Levinson vector
#       at the chosen order lies within rho * max_j |c_j| of the host's, rho
#       = 4 * kappa' * 2^-42 (levinson.py, the margins' comment: kappa' is
#       K7's conditioning estimate, 2^-42 the lag error and 4 its factor).
#       The bound is normwise, relative to the largest coefficient, as K7's
#       quantization margin is (2 qmax kappa' 2^-40 in quantized units):
#       Levinson gives no bound relative to each coefficient, and a small
#       tail coefficient can move by as much as the largest one;
#   (b) libm: the inverse pivots (1/sqrt against pow(s, -0.5), at most 2
#       ulps apart) and the estimate's log and pow (each within an ulp);
#   (c) the roundings of the sums once (a) and (b) have moved their inputs:
#       a sequential sum of m terms is within gamma_m = m u of sum |terms|
#       of the exact one, on either side.
#
# The covariance has no share: its inputs are exact integers scaled by a
# power of two and it is summed in the host's order, so it is the host's,
# bit for bit. Write C for it (ridged), C0 for it before the ridge, X for
# the row's lag matrix (X[s, i] = d[s - i - 1], s >= o, so C0 = X^T X),
# ||v||_C = sqrt(v^T C v), and lam = ridge / (1 + ridge) * min_i C_ii <=
# ridge * min_i C0_ii <= lambda_min(C) (C0 is a Gram matrix, so the ridge
# lifts every eigenvalue by at least ridge * min_i C0_ii). The loop moves
# e, a bound on ||cur_port - cur_host||_C, within each margin:
#
# - e_0 = rho * max_j |c_j| * sqrt(1^T |C| 1) for |d c_j| <= rho max|c|
#   (from (a): ||dc||_C^2 <= |dc|^T |C| |dc|); 0 where the host's initial
#   coefficients are given.
# - The residual moves by X dc, ||X dc||_2 <= ||dc||_C0 <= e, and, once e
#   > 0 has moved the inputs of its sums, by their roundings (c): at most
#   gamma_{o+1} (1 + ||cur||_1) max|d| a sample, g_r = that * sqrt(n) in
#   the 2-norm. The mean-abs sum moves by at most sqrt(n) (e + g_r) plus
#   its own rounding, gamma_n mabse: mab_err.
# - The soft threshold is 1-Lipschitz in each sample (d th = D d resid, D
#   diagonal in [0, 1]), and X^T D X <= C0 <= C, so the step's share
#   C^-1 X^T d th moves by at most e + g_r in the C-norm. The r-vector's
#   roundings add gamma_n max|d| sum|th| an entry, sqrt(o) gamma_n max|d|
#   sum|th| / sqrt(lam) in the C-norm after C^-1. Each side's solve is the
#   exact solution of (C + dC) x = rvec with ||dC||_2 <= gamma_{3o+3}
#   trace(C) (Higham, Thm 10.4, |dC| <= gamma_{3o+1} |L| |L^T|, two more
#   roundings for the inverse pivots, 1/sqrt against pow), so the two steps
#   differ by at most 2 gamma_{3o+3} trace(C) ||delta||_2 / sqrt(lam) more.
# - So e_{k+1} = 2 e_k + g_r + sqrt(o) gamma_n max|d| sum|th| / sqrt(lam)
#   + 2 gamma_{3o+3} trace(C) ||delta||_2 / sqrt(lam) where a step is taken
#   (the terms of (c) only once e > 0: before that both sides add the same
#   values).
#
# The decisions' margins follow:
#
# - The objective of a mean m moves by at most 2 |dm| / (m ln 2) (it grows
#   by one bit a doubling of the mean; twice that for its curvature) plus
#   libm's share, under _EPS_SVR_LIBM = 1e-12 bits (each libm call is
#   within an ulp, the objective is under 40 bits). eps_obj = _EPS_SVR_LIBM
#   + 2 mab_err / (mabse ln 2). A comparison of two objectives (obj <
#   min_obj; prev < obj; |prev - obj| < 1e-8) is flagged where their
#   difference is within the sum of their eps_obj of its threshold. An
#   exact tie is not flagged: both sides compute the same value twice (the
#   first iteration of every margin scores the initial coefficients).
# - The estimate's k2 = int(log2v) moves with log2v by the same amount:
#   flagged where log2v >= 0.5 lies within eps_obj of an integer.
# - A Cholesky pivot s is flagged where |s| < 2^-36 C_ii (exactly zero
#   rows, whose pivots are exactly 0 on both sides, are not): with the
#   ridge every pivot is at least lam, so the flag marks rows near the
#   singular case only.
# - The quantization of the refined coefficients: the adopted vector is
#   within e of the host's in the C-norm, so each coefficient within
#   |<u_j, d c>| <= sqrt((C^-1)_jj) e (u_j the unit vector; C^-1 from the
#   factor, column by column, ``inverse_diag_max_plain``): cerr = e
#   sqrt(max_j (C^-1)_jj), and the rounding margin in quantized units is 4
#   * 2^rshift * cerr (levinson.SVR_QUANT_SCALE = 4, the factor of four of
#   K7's margins) where that is larger than K7's own
#   (``levinson.quantize_exact``'s ``cerr``). On make_music's rows
#   sqrt(max_j (C^-1)_jj) is ~100 times under 1 / sqrt(lam), the
#   worst-case conversion. An adopted initial vector keeps K7's own
#   margin: its error is the one K7's margin is sized for.
#
# tests/test_torch_encode_margins.py moves every initial coefficient by (a),
# rho * max|c|, and holds every row whose decisions then differ from the
# host's to its flag.
_EPS_SVR_LIBM = 1e-12
_EPS_SVR_PIVOT = 2.0 ** -36
_SVR_INIT_REL = 4.0 * 2.0 ** -42   # rho / kappa'


def rgr_mean_code_length(mean: torch.Tensor, eps: torch.Tensor):
    """The host's ``_rgr_mean_code_length(mean, 16)`` of each row, with the
    same operations in the same order. mean, eps (V,) f64: eps the margin
    of log2v. Returns (obj (V,) f64, risky (V,)): risky where log2v >= 0.5
    lies within eps of an integer (k2 = int(log2v) could truncate the other
    way on the host)."""
    intmean = mean * float(1 << SVR_BPS)
    rho = 1.0 / (1.0 + intmean)
    om = 1.0 - rho
    lv = LOG_OPTX / torch.log(om)           # log(0) = -inf: lv = +0
    log2v = torch.log(lv) * INV_LOGE2       # log(+0) = -inf: k2 = 0
    k2 = torch.floor(torch.clamp(log2v, min=0.0))
    k1 = k2 + 1.0
    one = torch.ones_like(k2, dtype=torch.int64)
    k1f = torch.pow(om, (one << k1.long()).to(_F64))   # exact 2^k
    k2f = torch.pow(om, (one << k2.long()).to(_F64))
    obj = (1.0 + k1) * (1.0 - k1f) + ((1.0 + k2) + (1.0 / (1.0 - k2f))) * k1f
    near = torch.round(log2v)
    risky = (near >= 1.0) & ((log2v - near).abs() < eps)
    return obj, risky


def svr_cov_plain(work: torch.Tensor, orders: torch.Tensor, n: int,
                  bps: int, M: int, ridge: float) -> torch.Tensor:
    """Plain PyTorch version of K11: the ridged covariance of each row at
    its own order o, cov[i][j] = sum_{s < n - o} d[s + i] d[s + j] summed in
    s order (``dsp.svr._covariance``) with d = work * 2^-(bps - 1), the
    diagonal then multiplied by 1 + ridge; zero outside the o x o block.
    work (V, n) int32, orders (V,). Returns (V, M, M) f64."""
    V = work.shape[0]
    dev = work.device
    d = work.to(_F64) * 2.0 ** -(bps - 1)
    o = orders.long()
    idx = torch.arange(M, device=dev)
    act = (idx[None, :] < o[:, None])
    act2 = act[:, :, None] & act[:, None, :]
    acc = torch.zeros((V, M, M), dtype=_F64, device=dev)
    dp = torch.nn.functional.pad(d, (0, M))
    lo = int(o.clamp(min=1).min()) if V else 1
    for s in range(n - lo):
        win = dp[:, s:s + M]
        on = (act2 & (s < n - o)[:, None, None])
        acc = torch.where(on, acc + win[:, :, None] * win[:, None, :], acc)
    diag = torch.eye(M, dtype=torch.bool, device=dev)[None]
    return torch.where(diag, acc * (1.0 + ridge), acc)


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """sum over dim 1 of x (V, K), one chain in column order (K12's order;
    torch's own sums are trees whose order differs between devices)."""
    s = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for k in range(x.shape[1]):
        s = s + x[:, k]
    return s


def _gamma(m) -> float:
    """gamma_m = m u / (1 - m u): the relative bound of an m-term sum."""
    return m * _U / (1.0 - m * _U)


def cholesky_plain(cov: torch.Tensor, orders: torch.Tensor):
    """The host's ``cholesky_decompose`` of each row's o x o block, in its
    order (each pivot and entry a chain over k = i - 1 .. 0), 1/sqrt for
    pow(s, -0.5). cov (V, M, M) f64. Returns (A (V, M, M): L below the
    diagonal, cov on and above it; inv (V, M) the inverse pivots; singular
    (V,): a pivot s <= 0; risky (V,): a pivot within 2^-36 C_ii of 0 before
    the first singular one)."""
    V, M, _ = cov.shape
    A = cov.clone()
    o = orders.long()
    inv = torch.zeros((V, M), dtype=_F64, device=cov.device)
    singular = torch.zeros(V, dtype=torch.bool, device=cov.device)
    risky = torch.zeros_like(singular)
    jdx = torch.arange(M, device=cov.device)
    for i in range(M):
        act = (i < o) & ~singular
        s = A[:, i, i]
        for k in range(i - 1, -1, -1):
            s = s - A[:, i, k] * A[:, i, k]
        risky = risky | (act & (s.abs() < cov[:, i, i] * _EPS_SVR_PIVOT))
        singular = singular | (act & (s <= 0.0))
        act = act & (s > 0.0)
        inv[:, i] = torch.where(act, 1.0 / torch.sqrt(torch.where(
            act, s, 1.0)), 0.0)
        if i + 1 == M:
            break
        sj = A[:, i, i + 1:]
        for k in range(i - 1, -1, -1):
            sj = sj - A[:, i, k:k + 1] * A[:, i + 1:, k]
        on = act[:, None] & (jdx[None, i + 1:] < o[:, None])
        A[:, i + 1:, i] = torch.where(on, sj * inv[:, i:i + 1],
                                      A[:, i + 1:, i])
    return A, inv, singular, risky


def cholesky_solve_plain(A: torch.Tensor, inv: torch.Tensor,
                         b: torch.Tensor, orders: torch.Tensor):
    """The host's ``cholesky_solve`` of each row at its order: the forward
    pass (j = i - 1 .. 0), then the backward pass (i = o - 1 .. 0, j = i +
    1 .. o - 1). Returns x (V, M), 0 past the order."""
    o = orders.long()
    x = torch.zeros_like(b)
    if not o.numel():
        return x
    # Columns past every row's order stay 0; below every row's order no
    # term needs a mask.
    omax, omin = int(o.max()), int(o.min())
    for i in range(omax):
        s = b[:, i]
        for j in range(i - 1, -1, -1):
            s = s - A[:, i, j] * x[:, j]
        x[:, i] = torch.where(i < o, s * inv[:, i], 0.0)
    for i in range(omax - 1, -1, -1):
        s = x[:, i]
        for j in range(i + 1, omax):
            t = s - A[:, j, i] * x[:, j]
            s = t if j < omin else torch.where(j < o, t, s)
        x[:, i] = torch.where(i < o, s * inv[:, i], 0.0)
    return x


def inverse_diag_max_plain(A: torch.Tensor, inv: torch.Tensor,
                           orders: torch.Tensor) -> torch.Tensor:
    """max_j (C^-1)_jj of each row from its factor (A, inv as
    ``cholesky_plain`` returns them): column j of L^-1 by forward
    substitution (y_k = (delta_kj - sum_{m < k} L_km y_m) inv_k, m in
    order), then (C^-1)_jj = sum_k y_k^2, k in order. Returns (V,) f64."""
    V, M, _ = A.shape
    o = orders.long()
    omax = int(o.max()) if V else 0
    eye = torch.eye(M, dtype=_F64, device=A.device)
    Y = torch.zeros((V, M, M), dtype=_F64, device=A.device)
    d = torch.zeros((V, M), dtype=_F64, device=A.device)
    for k in range(omax):
        s = eye[k].expand(V, M)
        for m in range(k):
            s = s - A[:, k, m:m + 1] * Y[:, m, :]
        y = torch.where((k < o)[:, None], s * inv[:, k:k + 1], 0.0)
        Y[:, k, :] = y
        d = d + y * y
    return d.max(dim=1).values


def svr_refine_plain(work: torch.Tensor, cov: torch.Tensor,
                     coefs: torch.Tensor, orders: torch.Tensor, n: int,
                     bps: int, max_iter: int, margins, ridge: float,
                     kappa: torch.Tensor):
    """Plain PyTorch version of K12: ``dsp.svr.svr_refine_one`` after its
    covariance, every row in the host's order, each decision with its flag
    (the margins' comment above). work (V, n) int32; cov (V, M, M) f64 from
    ``svr_cov``; coefs (V, M) f64 the initial coefficients, left-aligned;
    orders (V,); kappa (V,) f64 the initial coefficients' conditioning
    estimate (K7's kappa'; 0 where they are the host's own). Returns (best
    (V, M) f64, 0 past the order and on singular rows; cerr (V,) the bound
    of each adopted
    coefficient's distance to the host's (the margins' comment); risky
    (V,); iters (V,) int32 the iterations run, over all margins)."""
    V, M = coefs.shape
    dev = coefs.device
    o = orders.long()
    d = work.to(_F64) * 2.0 ** -(bps - 1)
    idx = torch.arange(M, device=dev)
    act = idx[None, :] < o[:, None]
    init = torch.where(act, coefs, 0.0)
    A, inv, singular, risky = cholesky_plain(cov, o)
    live_row = (o > 0) & ~singular
    # The bounds' constants (the margins' comment).
    diag = torch.diagonal(cov, dim1=1, dim2=2)
    tr = _seq_sum(torch.where(act, diag, 0.0))
    lam = torch.where(act, diag, math.inf).min(dim=1).values \
        * (ridge / (1.0 + ridge))
    lam = torch.where(live_row, lam, 1.0)
    sq_lam = torch.sqrt(lam)
    sq_cinv = torch.sqrt(inverse_diag_max_plain(A, inv, o))
    maxd = d.abs().max(dim=1).values
    of = o.to(_F64)
    g_sum = _gamma(n)
    g_res = _gamma(of + 1.0) * maxd * math.sqrt(n)
    g_rvec = g_sum * torch.sqrt(of) * maxd / sq_lam
    g_solve = 2.0 * _gamma(3.0 * of + 3.0) * tr / sq_lam
    inner = torch.zeros((V, M), dtype=_F64, device=dev)
    for j in range(M):                       # sum_j |C_ij|, j in order
        inner = inner + cov[:, :, j].abs()
    cmax = init.abs().max(dim=1).values
    e0 = ((_SVR_INIT_REL * kappa) * cmax) * torch.sqrt(
        _seq_sum(torch.where(act, inner, 0.0)))
    dpad = torch.nn.functional.pad(d, (M, 0))
    s_idx = torch.arange(n, device=dev)
    res_on = s_idx[None, :] >= o[:, None]
    lo = int(o.clamp(min=1).min()) if V else 1
    omax = int(o.max()) if V else 0

    best = init.clone()
    min_obj = torch.full((V,), SVR_FLT_MAX, dtype=_F64, device=dev)
    eps_min = torch.zeros(V, dtype=_F64, device=dev)
    cerr = torch.zeros(V, dtype=_F64, device=dev)
    iters = torch.zeros(V, dtype=torch.int32, device=dev)
    for margin in margins:
        cur = init.clone()
        e = e0.clone()
        prev = torch.full((V,), SVR_FLT_MAX, dtype=_F64, device=dev)
        eps_prev = torch.zeros(V, dtype=_F64, device=dev)
        alive = live_row.clone()
        for it in range(max_iter):
            # The last iteration only scores cur: its r-vector, |th| sum,
            # solve and step would decide nothing.
            last = it + 1 == max_iter
            # resid[s] = d[s] + sum_i cur[i] d[s - i - 1], taps in order.
            r = d
            for i in range(omax):
                tap = dpad[:, M - i - 1:M - i - 1 + n]
                r = torch.where(res_on & (i < o)[:, None],
                                r + cur[:, i:i + 1] * tap, r)
            mag = r.abs()
            if not last:
                th = torch.where(r > 0, 1.0, torch.where(r < 0, -1.0, 0.0)) \
                    * torch.clamp(mag - margin, min=0.0)
            mabse = torch.zeros(V, dtype=_F64, device=dev)
            rvec = torch.zeros((V, M), dtype=_F64, device=dev)
            sum_th = torch.zeros(V, dtype=_F64, device=dev)
            for s in range(lo, n):
                on = s >= o
                mabse = torch.where(on, mabse + mag[:, s], mabse)
                if last:
                    continue
                win = dpad[:, s:s + M].flip(1)          # d[s - 1 - i]
                rvec = torch.where(on[:, None] & act,
                                   rvec + th[:, s:s + 1] * win, rvec)
                sum_th = torch.where(on, sum_th + th[:, s].abs(), sum_th)
            # The bounds of this iteration (the noise terms only once e has
            # moved the inputs of the sums).
            moved = e > 0
            g_r = torch.where(moved, g_res * (1.0 + _seq_sum(cur.abs())),
                              0.0)
            mab_err = math.sqrt(n) * (e + g_r) + torch.where(
                moved, g_sum * mabse, 0.0)
            eps = _EPS_SVR_LIBM + torch.where(
                mab_err > 0, 2.0 * mab_err / (mabse * math.log(2.0)), 0.0)
            obj, r_k2 = rgr_mean_code_length(mabse / n, eps)
            iters = iters + alive.to(torch.int32)
            risky = risky | (alive & r_k2)
            # obj < min_obj: adopt.
            gap = obj - min_obj
            risky = risky | (alive & (gap != 0)
                             & (gap.abs() < eps + eps_min))
            adopt = alive & (obj < min_obj)
            best = torch.where(adopt[:, None], cur, best)
            min_obj = torch.where(adopt, obj, min_obj)
            eps_min = torch.where(adopt, eps, eps_min)
            # The initial vector's own error is K7's quantization margin's.
            cerr = torch.where(adopt, 0.0 if it == 0 else e * sq_cinv, cerr)
            if last:                   # the last stop decides nothing
                break
            # prev < obj or |prev - obj| < 1e-8: stop.
            dp = prev - obj
            adp = dp.abs()
            e2 = eps + eps_prev
            b_unc = (adp - SVR_OBJ_EPSILON).abs() < e2
            a_unc = (dp != 0) & (adp < e2)
            b_true = adp < SVR_OBJ_EPSILON - e2
            risky = risky | (alive & (b_unc | (a_unc & ~b_true)))
            stop = (prev < obj) | (adp < SVR_OBJ_EPSILON)
            step = alive & ~stop
            delta = cholesky_solve_plain(A, inv, rvec, o)
            cur = torch.where(step[:, None] & act, cur + delta, cur)
            dnorm = torch.sqrt(_seq_sum(delta * delta))
            e_next = 2.0 * e + g_r + torch.where(moved, g_rvec * sum_th, 0.0) \
                + g_solve * dnorm
            e = torch.where(step, e_next, e)
            prev = torch.where(alive, obj, prev)
            eps_prev = torch.where(alive, eps, eps_prev)
            alive = step
    best = torch.where(live_row[:, None] & act, best, 0.0)
    return best, cerr, risky, iters


def _check_f64(what: str, name: str, t, shape: tuple, device) -> None:
    if t.dtype != _F64 or tuple(t.shape) != shape \
            or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{what}: {name} must be a contiguous float64 "
                         f"tensor of shape {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def svr_cov(work: torch.Tensor, orders: torch.Tensor, n: int, bps: int,
            M: int, ridge: float) -> torch.Tensor:
    """The ridged covariance of each row at its order (``svr_cov_plain``'s
    result). work (V, n) int32, orders (V,) int32, 1 <= M <= 255. Returns
    (V, M, M) f64.

    CUDA tensors go through K11 (``svr_cov.launches`` counts its launches);
    CPU tensors through ``svr_cov_plain``."""
    if not 1 <= M <= 255:
        raise ValueError(f"svr_cov: M must be 1..255, got {M}")
    if work.device.type == "cpu":
        return svr_cov_plain(work, orders, n, bps, M, ridge)
    if work.device.type != "cuda":
        raise ValueError(f"svr_cov: no kernel for device {work.device}")
    V = work.shape[0]
    dev = work.device
    build.check_arg("svr_cov", "work", work, (V, n), dev)
    build.check_arg("svr_cov", "orders", orders, (V,), dev)
    if 4 * (n + 4) > 227 * 1024:
        raise ValueError(f"svr_cov: a row of {n} samples does not fit the "
                         f"kernel's shared memory")
    cov = torch.empty((V, M, M), dtype=_F64, device=dev)
    if V == 0:
        return cov
    fn = build.load("svr_cov").srla_svr_cov
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
            + [ctypes.c_double] * 2 + [ctypes.c_void_p]
    err = fn(work.data_ptr(), orders.data_ptr(), cov.data_ptr(), V, n, M,
             2.0 ** -(bps - 1), 1.0 + ridge,
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "svr_cov")
    svr_cov.launches += 1
    return cov


svr_cov.launches = 0
_SMEM_BYTES = 227 * 1024 - 1024  # a CTA's, less K12's static variables
_MARGINS: dict = {}
_K12_SLOTS = 6                    # margins K12 keeps in flight
_K12_TILES = 2 * 64 * 12          # doubles: two tiles of 64 samples


def _slot_stride(M: int) -> int:
    """Doubles between two of K12's slot vectors (csrc/svr_refine.cu
    slot_stride): M rounded up to 16 bytes, padded so that slots 3 apart
    fall in different shared-memory banks."""
    S = ((M + 1) & ~1) + 2
    return S + 2 if (3 * S // 2) % 8 == 0 else S


def _layout(n: int, M: int) -> tuple[bool, bool]:
    """Where K12 keeps a row's factor and samples: (factor in global
    scratch, row staged as int32). Shared memory holds two tiles and 23
    vectors of ``_slot_stride(M)`` always, the row as f64 (8 n bytes) and
    the factor's strict lower triangle (8 M (M - 1) / 2) while they fit;
    the factor leaves first, then the row shrinks to its int32 samples
    (scaled on read)."""
    base = 8 * (_K12_TILES + (5 + 3 * _K12_SLOTS) * _slot_stride(M))
    factor = 8 * ((M * (M - 1) // 2 + 1) & ~1)

    def row(width):
        return (width * n + 15) // 16 * 16

    if base + row(8) + factor <= _SMEM_BYTES:
        return False, False
    if base + row(8) <= _SMEM_BYTES:
        return True, False
    if base + row(4) <= _SMEM_BYTES:
        return True, True
    raise ValueError(f"svr_refine: a row of {n} samples does not fit the "
                     f"kernel's shared memory")


def _margins_on(margins: tuple, device) -> torch.Tensor:
    """The margin list as an f64 tensor on ``device``, made once (so a
    launch inside a CUDA graph capture copies nothing from the host)."""
    key = (margins, str(device))
    if key not in _MARGINS:
        _MARGINS[key] = torch.tensor(margins, dtype=_F64, device=device)
    return _MARGINS[key]


def svr_refine(work: torch.Tensor, cov: torch.Tensor, coefs: torch.Tensor,
               orders: torch.Tensor, n: int, bps: int, max_iter: int,
               margins, ridge: float, kappa: torch.Tensor):
    """SVR refinement of each row (``svr_refine_plain``'s arguments and
    result). work (V, n) int32, cov (V, M, M) f64 from ``svr_cov``, coefs
    (V, M) f64, orders (V,) int32, kappa (V,) f64.

    CUDA tensors go through K12 (``svr_refine.launches`` counts its
    launches); CPU tensors through ``svr_refine_plain``."""
    V, M = coefs.shape
    if not 1 <= M <= 255 or max_iter < 1 or not margins:
        raise ValueError(f"svr_refine: M must be 1..255 and max_iter and "
                         f"the margins non-empty, got M {M}, max_iter "
                         f"{max_iter}, {len(margins)} margins")
    if coefs.device.type == "cpu":
        return svr_refine_plain(work, cov, coefs, orders, n, bps, max_iter,
                                margins, ridge, kappa)
    if coefs.device.type != "cuda":
        raise ValueError(f"svr_refine: no kernel for device {coefs.device}")
    dev = coefs.device
    build.check_arg("svr_refine", "work", work, (V, n), dev)
    build.check_arg("svr_refine", "orders", orders, (V,), dev)
    _check_f64("svr_refine", "cov", cov, (V, M, M), dev)
    _check_f64("svr_refine", "coefs", coefs, (V, M), dev)
    _check_f64("svr_refine", "kappa", kappa, (V,), dev)
    a_global, row_i32 = _layout(n, M)
    best = torch.empty((V, M), dtype=_F64, device=dev)
    cerr = torch.empty(V, dtype=_F64, device=dev)
    risky = torch.empty(V, dtype=torch.bool, device=dev)
    iters = torch.empty(V, dtype=torch.int32, device=dev)
    if V == 0:
        return best, cerr, risky, iters
    a_scratch = (torch.empty((V, M * (M - 1) // 2), dtype=_F64, device=dev)
                 if a_global else None)
    hist = torch.empty((V, _K12_SLOTS, max_iter, 3), dtype=_F64, device=dev)
    marg = _margins_on(tuple(margins), dev)
    fn = build.load("svr_refine").srla_svr_refine
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 \
            + [ctypes.c_double] * 10 + [ctypes.c_void_p]
    err = fn(work.data_ptr(), cov.data_ptr(), coefs.data_ptr(),
             orders.data_ptr(), kappa.data_ptr(), marg.data_ptr(),
             None if a_scratch is None else a_scratch.data_ptr(),
             hist.data_ptr(), best.data_ptr(), cerr.data_ptr(),
             risky.data_ptr(), iters.data_ptr(), V, n, M, max_iter,
             len(margins), int(row_i32),
             2.0 ** -(bps - 1), ridge / (1.0 + ridge), LOG_OPTX, _gamma(n),
             math.sqrt(n), _EPS_SVR_LIBM, _EPS_SVR_PIVOT, _SVR_INIT_REL,
             SVR_OBJ_EPSILON, SVR_FLT_MAX,
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "svr_refine")
    svr_refine.launches += 1
    return best, cerr, risky, iters


svr_refine.launches = 0
