"""K7: the encode's LPC analysis of each row, from its lags to its integer
coefficients.

``lpc_analyze`` is the twin of ``srla_tpu.kernels.exact._levinson_dd``,
``_select_order_exact``, a second ``_levinson_dd`` at the chosen orders and
``_quantize_exact``, in f64 with the JAX package's flags and margins: on a
CUDA tensor it launches ``csrc/lpc_analyze.cu`` (K7), one launch for the
whole analysis, on a CPU tensor it runs ``lpc_analyze_plain``, which
composes the four functions below (``levinson``, ``select_order_exact``,
``levinson`` at the chosen orders, ``quantize_exact``).

With SVR the analysis stops after the coefficients (``lpc_coefs``, the same
kernel's ``srla_lpc_coefs`` entry: orders, f64 coefficients, kappa' and the
flags), SVR refines them (``svr.py``) and ``lpc_quantize`` (entry
``srla_lpc_quantize``) quantizes the result with the margin widened by
SVR's error bound.

Parity targets: libs/lpc/src/lpc.c:379-441 (Levinson), :535-570 (order
choice), :1341-1405 (quantize); the host's ``dsp.levinson``,
``host_encoder.SRLAEncoder._select_order`` and ``dsp.quantize``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..constants import (LPC_COEFFICIENT_BITWIDTH,
                         RSHIFT_LPC_COEFFICIENT_BITWIDTH)
from ..dsp.window import welch_inverse_squared_sum
from ..rice import _INV_LOGE2
from . import build

FLT_EPSILON = 1.1920928955078125e-07
MAX_ORDER = 255                  # the largest preset's (-m 6)

# Margins of the order choice and the quantization, as in
# srla_tpu.kernels.exact (sized there for df64; f64 errors are smaller, so
# they hold a fortiori), and the f64 error they must cover, u = 2^-53:
#
# - Levinson carries a relative error d of the lags into the error
#   variances: ev[m] is the least a^T T_m a over monic vectors a (T_m the
#   lags' Toeplitz matrix), so to first order a change dT of T_m changes it
#   by a^T dT a at the recursion's own a, and |a^T dT a| <= (sum_j |a[j]|)^2
#   d r0: |d ev[m]| / ev[m] <= A^2 kappa d, kappa = r0 / min |ev| and A the
#   largest sum_j |a[j]| of the recursion's vectors (a[0] = 1, so A >= 1).
#   The margins below scale with that widened estimate, kappa' = kappa A^2
#   (kappa for a silent row, whose decisions do not use the recursion); the
#   coefficients, which the quantization rounds, are taken to move by the
#   same relative amount. kappa alone (before the repair) assumed A ~ 1: on
#   lags built from the reflection coefficient +-5/32 at every order, A
#   reaches 1.6e3, 1.2e7 and 3.3e9 at orders 64, 128 and 255 while kappa
#   stays 4.9, 23 and 503, and at M 128 and 255 lags moved by 2^-42 change
#   the chosen order by tens, which kappa alone left unflagged.
#   tests/test_torch_encode_margins.py holds those rows to the contract.
#   On make_music's rows they flag nothing (chip_smoke.py's encodes repair
#   no block and re-measure no span). A is summed in K7's order (each of
#   the G lanes of a row, G = _group_width(M), sums |a[j]| for j = lane,
#   lane + G, ... in order, then an xor-butterfly over the G lanes;
#   group_abs_sum), so K7 and this version take A from their vectors with
#   the same operations.
#   The lags are within d <= 2^-42 of the host's (exact.py, above
#   _EPS_PREEMPH). The order choice compares lengths of n * entropy(ev)
#   bits, which move by at most n * kappa' * d / ln 2; its margin is n *
#   kappa' * 2^-40 bits (_KAPPA_SCALE), four times n * kappa' * 2^-42, and
#   never below the host's own tie-repair trigger of 1e-6 bits.
#   Quantization rounds coef * 2^rshift with |coef * 2^rshift| <= 2 * qmax;
#   its margin is 2 * qmax * kappa' * 2^-40, the same factor of four, never
#   below 1e-7.
# - The order of gamma's sum. Step k sums m = k + 2 <= M <= 255 products
#   a[j] * r[m - j]: the host in order, the plain version in torch's tree,
#   K7 in its own (each of the row's G lanes, G = 8 at M <= 64, 16 at M <=
#   128 and 32 above, the terms j = lane, lane + G, ... in order, then an
#   xor-butterfly over the G lanes: at most 8 + log2 G <= 13 roundings
#   after the product's). Any order is within gamma_m = m u / (1 - m u) of
#   sum |a[j] r[m - j]| of the exact sum, so the computed gamma is the exact
#   gamma of lags moved by at most 255 u < 2^-45 relative (a backward
#   error, step by step). That adds d' < 2^-45 to the lag error d: d + d' <
#   1.125 * 2^-42, which the factor of four above (n * kappa' * 2^-40 and 2 *
#   qmax * kappa' * 2^-40 allow d up to 2^-40) still covers.
#   tests/test_torch_encode_margins.py drives both decisions to their
#   boundaries at d = 2^-42.
_EPS_SILENT = 1e-6           # relative |r0| distance to FLT_EPSILON
_EPS_ORDER_BASE = 1e-6       # bits; matches the host tie-repair trigger
_EPS_QUANT_BASE = 1e-7       # quantized-units distance to rounding boundary
_KAPPA_SCALE = 2.0 ** -40    # conditioning amplification allowance
# The factor of the quantization margin of SVR's refined coefficients over
# their error bound (svr.py, the margins' comment).
SVR_QUANT_SCALE = 4.0

_F64 = torch.float64


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """C round(): floor(|x| + 0.5) with x's sign, in f64 as the host does."""
    r = torch.floor(x.abs() + 0.5)
    return torch.where(x < 0, -r, r)


def _dist_to_half(x: torch.Tensor) -> torch.Tensor:
    """Distance of x to the nearest k + 0.5 (round-half boundaries)."""
    ax = x.abs()
    return ((ax - torch.floor(ax)) - 0.5).abs()


def _group_width(M: int) -> int:
    """K7's lanes a row at max order M (lpc_analyze.cu's dispatch)."""
    return 8 if M <= 64 else (16 if M <= 128 else 32)


def group_abs_sum(a: torch.Tensor, m: int, G: int) -> torch.Tensor:
    """sum_{j < m} |a[:, j]| in K7's order: lane l of G sums j = l, l + G,
    ... (8 terms, the missing ones 0) in order, then an xor-butterfly over
    the G lanes. a (V, >= m) f64; returns (V,)."""
    V = a.shape[0]
    x = torch.zeros((V, 8 * G), dtype=_F64, device=a.device)
    x[:, :m] = a[:, :m].abs()
    x = x.view(V, 8, G)
    s = x[:, 0]
    for i in range(1, 8):
        s = s + x[:, i]
    lane = torch.arange(G, device=a.device)
    off = 1
    while off < G:
        s = s + s[:, lane ^ off]
        off <<= 1
    return s[:, 0]


def levinson(ac: torch.Tensor, max_order: int, orders=None):
    """Levinson-Durbin recursion. ac (V, M+1) f64 with the ridge on lag 0.
    Returns (error_vars (V, M+1), coefs (V, M) at per-row ``orders`` or None,
    silent (V,), risky (V,), kappa (V,)). risky: r0 near the silent
    threshold, or a non-finite error variance on a non-silent row. kappa is
    the widened conditioning estimate kappa' of the margins' comment."""
    V = ac.shape[0]
    M = max_order
    r0 = ac[:, 0]
    sr0 = torch.where(r0 == 0, 1.0, r0)
    a = torch.zeros((V, M + 2), dtype=_F64, device=ac.device)
    a[:, 0] = 1.0
    a1 = -ac[:, 1] / sr0
    a[:, 1] = a1
    ev = torch.zeros((V, M + 1), dtype=_F64, device=ac.device)
    ev[:, 0] = r0
    ev[:, 1] = r0 + ac[:, 1] * a1
    collected = None
    if orders is not None:
        collected = torch.zeros((V, M), dtype=_F64, device=ac.device)
        collected[:, 0] = torch.where(orders == 1, a1, 0.0)
    G = _group_width(M)
    growth = torch.ones(V, dtype=_F64, device=ac.device)   # |a| at order 0
    for k in range(M - 1):
        # The growth of the order k + 1 vector, the one this step uses.
        growth = torch.fmax(growth, group_abs_sum(a, k + 2, G))
        # gamma = sum_{j <= k+1} a[j] * ac[k+2-j]
        gamma = (a[:, :k + 2] * ac[:, 1:k + 3].flip(1)).sum(dim=1)
        evk = ev[:, k + 1]
        gamma = gamma / -torch.where(evk == 0, 1.0, evk)
        ev[:, k + 2] = evk * (1.0 - gamma * gamma)
        a_new = a[:, :k + 3] + gamma[:, None] * a[:, :k + 3].flip(1)
        a[:, :k + 3] = a_new
        if collected is not None:
            sel = (orders == k + 2)[:, None]
            collected[:, :k + 2] = torch.where(sel, a_new[:, 1:],
                                               collected[:, :k + 2])
    absr0 = r0.abs()
    silent = absr0 < FLT_EPSILON
    risky = (absr0 - FLT_EPSILON).abs() < _EPS_SILENT * FLT_EPSILON
    evs = torch.where(silent[:, None], r0[:, None], ev)
    if collected is not None:
        collected = torch.where(silent[:, None], 0.0, collected)
    # Conditioning estimate: r0 / min |ev| over the recursion, times the
    # coefficients' growth.
    ev_abs = evs.abs()
    min_ev = torch.where(ev_abs > 0, ev_abs, math.inf).min(dim=1).values
    ok = torch.isfinite(min_ev) & (min_ev > 0)
    kappa = torch.where(silent, 1.0,
                        absr0 / torch.where(ok, min_ev, 1.0))
    kappa = torch.where(torch.isfinite(kappa) & (kappa >= 1.0), kappa,
                        math.inf)
    kappa = torch.where(silent, kappa, (kappa * growth) * growth)
    nonfinite = ~torch.isfinite(evs).all(dim=1)
    risky = risky | (nonfinite & ~silent)
    return evs, collected, silent, risky, kappa


def select_order_exact(ev: torch.Tensor, n: int, bps: int, max_params: int,
                       max_fixed: bool, kappa: torch.Tensor):
    """BRUTEFORCE_ESTIMATION order choice from the window-corrected error
    variances ev (V, M+1). Returns (orders (V,) int64, risky (V,)); the first
    strict minimum of the estimated code length wins, as np.argmin."""
    V = ev.shape[0]
    if max_fixed:
        return (torch.full((V,), max_params, dtype=torch.int64,
                           device=ev.device),
                torch.zeros(V, dtype=torch.bool, device=ev.device))
    M = max_params
    evo = ev[:, 1:M + 1]
    neg_ev = evo < 0
    mabse = 2.0 * torch.sqrt(torch.where(neg_ev, 0.0, evo) * 0.5)
    intmean = mabse * float(1 << (bps - 1))
    rho = 1.0 / (1.0 + intmean)
    invrho = 1.0 - rho
    z = mabse < 1e-16
    t1 = invrho * (torch.log(torch.where(invrho <= 0, 0.5, invrho))
                   * _INV_LOGE2)
    t2 = rho * (torch.log(torch.where(rho <= 0, 0.5, rho)) * _INV_LOGE2)
    ent = torch.where(z, 0.0, -(t1 + t2) / rho)
    coef_bits = LPC_COEFFICIENT_BITWIDTH * torch.arange(
        1, M + 1, dtype=_F64, device=ev.device)[None, :]
    length = ent * float(n) + coef_bits
    risky = (~neg_ev & ((mabse - 1e-16).abs() < 1e-17)).any(dim=1)
    bad = neg_ev | ~torch.isfinite(length)
    length = torch.where(bad, math.inf, length)
    idx = length.argmin(dim=1)          # the first minimal index
    best = length.gather(1, idx[:, None])[:, 0]
    orders = idx + 1
    others = length.scatter(1, idx[:, None], math.inf)
    gap = others.min(dim=1).values - best
    eps = torch.clamp(float(n) * kappa * _KAPPA_SCALE, min=_EPS_ORDER_BASE)
    risky = risky | ~torch.isfinite(best) | (torch.isfinite(gap)
                                             & (gap < eps))
    return orders, risky


def quantize_exact(coefs: torch.Tensor, orders: torch.Tensor, nbits: int,
                   max_bits: int, kappa: torch.Tensor, cerr=None):
    """coefs (V, M) f64 left-aligned. Backward error-feedback quantization.
    cerr (V,) f64, where given: a bound on the coefficients' distance to
    the host's beyond K7's (SVR's refined vectors, svr.py's margins), which
    widens the rounding margin to SVR_QUANT_SCALE * 2^rshift * cerr
    quantized units where that is larger. Returns (int coefs (V, M) int64,
    rshift (V,) int64, risky (V,))."""
    V, M = coefs.shape
    dev = coefs.device
    qmax = 1 << (nbits - 1)
    mask = torch.arange(M, device=dev)[None, :] < orders[:, None]
    maxabs = torch.where(mask, coefs.abs(), 0.0).max(dim=1).values
    eps_k = torch.clamp(float(2 * qmax) * kappa * _KAPPA_SCALE,
                        min=_EPS_QUANT_BASE)
    tiny_thresh = 2.0 ** (-(nbits - 1))
    tiny = maxabs <= tiny_thresh
    risky = (maxabs - tiny_thresh).abs() < tiny_thresh * 1e-6
    # frexp boundary: maxabs close to a power of two flips ndigit.
    m, e = torch.frexp(maxabs)
    risky = risky | (~tiny & (((m - 0.5).abs() < 1e-7) | (m > 1.0 - 1e-7)))
    ndigit = torch.where(maxabs == 0, 0, e.long())
    rshift = (nbits - 1) - ndigit
    rshift = torch.where((rshift >= max_bits) | (rshift < 0), max_bits - 1,
                         rshift)
    rshift = torch.where(tiny, nbits, rshift)
    scale = (torch.ones_like(rshift) << rshift).to(_F64)   # exact 2^rshift
    if cerr is not None:
        eps_k = torch.fmax(eps_k, (SVR_QUANT_SCALE * scale) * cerr)
    qerr = torch.zeros(V, dtype=_F64, device=dev)
    intc = torch.zeros((V, M), dtype=torch.int64, device=dev)
    for ordi in range(M - 1, -1, -1):
        active = orders > ordi
        qe = qerr + coefs[:, ordi] * scale
        qt = _round_half_away(qe).clamp(-qmax, qmax - 1)
        risky = risky | (active & (_dist_to_half(qe) < eps_k))
        qerr = torch.where(active, qe - qt, qerr)
        intc[:, ordi] = torch.where(active, qt, 0.0).long()
    intc = torch.where(tiny[:, None], 0, intc)
    risky = risky | ~torch.isfinite(maxabs)
    return intc, rshift, risky


def lpc_analyze_plain(ac: torch.Tensor, n: int, bps: int, max_params: int,
                      max_fixed: bool):
    """Plain PyTorch version of K7: Levinson to max_params, the order
    choice on the window-corrected error variances, Levinson again at the
    chosen orders and the quantization. ac (V, max_params + 1) f64 lags
    with the ridge on lag 0. Returns (orders (V,) int32, rshifts (V,) int32,
    intc (V, max_params) int32 left-aligned, risky (V,) bool)."""
    ev, _, _, r_lev, kappa = levinson(ac, max_params)
    orders, r_ord = select_order_exact(
        ev * welch_inverse_squared_sum(n), n, bps, max_params, max_fixed,
        kappa)
    _, coefs, _, _, _ = levinson(ac, max_params, orders)
    intc, rshifts, r_q = quantize_exact(
        coefs, orders, LPC_COEFFICIENT_BITWIDTH,
        1 << RSHIFT_LPC_COEFFICIENT_BITWIDTH, kappa)
    return (orders.to(torch.int32), rshifts.to(torch.int32),
            intc.to(torch.int32), r_lev | r_ord | r_q)


def lpc_coefs_plain(ac: torch.Tensor, n: int, bps: int, max_params: int,
                    max_fixed: bool):
    """Plain PyTorch version of K7's first half (``lpc_coefs``): Levinson,
    the order choice and the f64 coefficients at the chosen orders, as
    lpc_analyze_plain computes them before it quantizes. Returns (orders
    (V,) int32, coefs (V, max_params) f64 left-aligned, 0 past the order,
    kappa (V,) f64 the conditioning estimate kappa', risky (V,) bool)."""
    ev, _, _, r_lev, kappa = levinson(ac, max_params)
    orders, r_ord = select_order_exact(
        ev * welch_inverse_squared_sum(n), n, bps, max_params, max_fixed,
        kappa)
    _, coefs, _, _, _ = levinson(ac, max_params, orders)
    return orders.to(torch.int32), coefs, kappa, r_lev | r_ord


def lpc_quantize_plain(coefs: torch.Tensor, orders: torch.Tensor,
                       kappa: torch.Tensor, cerr: torch.Tensor):
    """Plain PyTorch version of K7's quantization entry (``lpc_quantize``):
    ``quantize_exact`` of given f64 coefficients with its margin widened by
    cerr. Returns (rshifts (V,) int32, intc (V, M) int32 left-aligned, risky
    (V,) bool)."""
    intc, rshifts, risky = quantize_exact(
        coefs, orders.long(), LPC_COEFFICIENT_BITWIDTH,
        1 << RSHIFT_LPC_COEFFICIENT_BITWIDTH, kappa, cerr)
    return rshifts.to(torch.int32), intc.to(torch.int32), risky


def _k7_entry(name: str, argtypes):
    """K7's C entry ``name``, its ctypes signature set at first use."""
    fn = getattr(build.load("lpc_analyze"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def lpc_coefs(ac: torch.Tensor, n: int, bps: int, max_params: int,
              max_fixed: bool):
    """K7 up to the coefficients: Levinson, the order choice and the f64
    coefficients at the chosen orders, with the flags of those steps, for
    SVR to refine before ``lpc_quantize``. Arguments as ``lpc_analyze``'s.
    Returns (orders (V,) int32, coefs (V, max_params) f64 left-aligned,
    kappa (V,) f64, risky (V,) bool).

    CUDA tensors go through the kernel's ``srla_lpc_coefs`` entry
    (``lpc_coefs.launches``); CPU tensors through ``lpc_coefs_plain``."""
    _check_lags("lpc_coefs", ac, max_params)
    if ac.device.type == "cpu":
        return lpc_coefs_plain(ac, n, bps, max_params, max_fixed)
    V = ac.shape[0]
    dev = ac.device
    orders = torch.empty(V, dtype=torch.int32, device=dev)
    coefs = torch.empty((V, max_params), dtype=_F64, device=dev)
    kappa = torch.empty(V, dtype=_F64, device=dev)
    risky = torch.empty(V, dtype=torch.bool, device=dev)
    if V == 0:
        return orders, coefs, kappa, risky
    fn = _k7_entry("srla_lpc_coefs", [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 5 + [ctypes.c_double, ctypes.c_void_p])
    err = fn(ac.data_ptr(), orders.data_ptr(), coefs.data_ptr(),
             kappa.data_ptr(), risky.data_ptr(), V, n, bps, max_params,
             int(max_fixed), welch_inverse_squared_sum(n),
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "lpc_coefs")
    lpc_coefs.launches += 1
    return orders, coefs, kappa, risky


def lpc_quantize(coefs: torch.Tensor, orders: torch.Tensor,
                 kappa: torch.Tensor, cerr: torch.Tensor):
    """K7's quantization of given coefficients (V, M) f64 left-aligned at
    orders (V,) int32, its margin scaled by kappa (V,) and widened by cerr
    (V,) (``quantize_exact``). Returns (rshifts (V,) int32, intc (V, M)
    int32, risky (V,) bool).

    CUDA tensors go through the kernel's ``srla_lpc_quantize`` entry
    (``lpc_quantize.launches``); CPU tensors through
    ``lpc_quantize_plain``."""
    V, M = coefs.shape
    if coefs.device.type == "cpu":
        return lpc_quantize_plain(coefs, orders, kappa, cerr)
    if coefs.device.type != "cuda":
        raise ValueError(f"lpc_quantize: no kernel for device {coefs.device}")
    dev = coefs.device
    build.check_arg("lpc_quantize", "orders", orders, (V,), dev)
    for name, t, shape in (("coefs", coefs, (V, M)), ("kappa", kappa, (V,)),
                           ("cerr", cerr, (V,))):
        if t.dtype != _F64 or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"lpc_quantize: {name} must be a contiguous "
                             f"float64 tensor of shape {shape} on {dev}")
    rshifts = torch.empty(V, dtype=torch.int32, device=dev)
    intc = torch.empty((V, M), dtype=torch.int32, device=dev)
    risky = torch.empty(V, dtype=torch.bool, device=dev)
    if V == 0:
        return rshifts, intc, risky
    fn = _k7_entry("srla_lpc_quantize", [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(coefs.data_ptr(), orders.data_ptr(), kappa.data_ptr(),
             cerr.data_ptr(), rshifts.data_ptr(), intc.data_ptr(),
             risky.data_ptr(), V, M, LPC_COEFFICIENT_BITWIDTH,
             1 << RSHIFT_LPC_COEFFICIENT_BITWIDTH,
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "lpc_quantize")
    lpc_quantize.launches += 1
    return rshifts, intc, risky


def _check_lags(what: str, ac: torch.Tensor, max_params: int) -> None:
    """Raise unless ac is (V, max_params + 1) lags, 1 <= max_params <= 255,
    on the CPU or as a contiguous f64 CUDA tensor."""
    if not 1 <= max_params <= MAX_ORDER:
        raise ValueError(f"{what}: max_params must be 1..{MAX_ORDER}, "
                         f"got {max_params}")
    if ac.dim() != 2 or ac.shape[1] != max_params + 1:
        raise ValueError(f"{what}: ac must be (V, {max_params + 1}), "
                         f"got {tuple(ac.shape)}")
    if ac.device.type == "cpu":
        return
    if ac.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {ac.device}")
    if ac.dtype != _F64 or not ac.is_contiguous():
        raise ValueError(f"{what}: ac must be a contiguous float64 tensor")


def lpc_analyze(ac: torch.Tensor, n: int, bps: int, max_params: int,
                max_fixed: bool):
    """ac (V, max_params + 1) f64 lags with the ridge on lag 0, 1 <=
    max_params <= 255. Returns (orders (V,) int32, rshifts (V,) int32, intc
    (V, max_params) int32 left-aligned, risky (V,) bool).

    CUDA tensors go through the kernel (``lpc_analyze.launches`` counts its
    launches); CPU tensors go through ``lpc_analyze_plain``."""
    _check_lags("lpc_analyze", ac, max_params)
    if ac.device.type == "cpu":
        return lpc_analyze_plain(ac, n, bps, max_params, max_fixed)
    V = ac.shape[0]
    dev = ac.device
    orders = torch.empty(V, dtype=torch.int32, device=dev)
    rshifts = torch.empty(V, dtype=torch.int32, device=dev)
    intc = torch.empty((V, max_params), dtype=torch.int32, device=dev)
    risky = torch.empty(V, dtype=torch.bool, device=dev)
    if V == 0:
        return orders, rshifts, intc, risky
    fn = _k7_entry("srla_lpc_analyze", [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 7 + [ctypes.c_double, ctypes.c_void_p])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(ac.data_ptr(), orders.data_ptr(), rshifts.data_ptr(),
             intc.data_ptr(), risky.data_ptr(), V, n, bps, max_params,
             int(max_fixed), LPC_COEFFICIENT_BITWIDTH,
             1 << RSHIFT_LPC_COEFFICIENT_BITWIDTH,
             welch_inverse_squared_sum(n), stream)
    build.check(err, "lpc_analyze")
    lpc_analyze.launches += 1
    return orders, rshifts, intc, risky


lpc_analyze.launches = 0
lpc_coefs.launches = 0
lpc_quantize.launches = 0
