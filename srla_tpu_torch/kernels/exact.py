"""Exact device encode analysis in f64 with decision-boundary flags, and the
fused encode of one equal-size block group.

Twin of ``srla_tpu.kernels.exact`` at every flag (LTP and SVR among
them). The JAX package computes its analysis in df64 (two-f32) arithmetic
because the TPU has no fast f64; the H100 has, so every float here is a
torch f64. For every discrete decision the floats feed (pre-emphasis
coefficient rounding, LPC order argmin, coefficient quantization and its
frexp shift, Rice parameter boundaries, recursive/plain choice, silent
threshold) the distance to the nearest decision boundary is computed; a
variant closer than the margin is flagged ``risky`` and its block is
re-derived on the exact host path. The margins are the JAX package's,
unchanged (``exact.py:46-57``): f64 rounding error sits below df64's, so an
unflagged decision equals the host's f64 decision. The lags come from kernel
K8 (``autocorr.autocorr``), the Levinson recursion, order choice and
quantization from K7 (``levinson.lpc_analyze``, its margins beside it in
``levinson.py``). Long-term prediction (``-P``) runs its pitch search and
solve in kernel K10 (``ltp.ltp_analyze``, its margins beside it in
``ltp.py``). SVR refinement (``--svr-filter-learning-iteration``) runs
between K7's coefficients and their quantization: the covariance in kernel
K11 (``svr.svr_cov``), the refinement loop in K12 (``svr.svr_refine``),
their margins beside them in ``svr.py``. The residual and all bit math
are exact integer code in kernels: the variant stack and pre-emphasis K16
(``preemphasis.variant_preemphasis``), the LTP residual K18
(``ltp.ltp_predict``), the FIR residual K3 (``predict``), the Rice search
K4 (``rice_search``), the bit accounting and stereo selection K17
(``select.select_blocks``, ``select.measure_blocks``) and the pack K5
(``bitpack.pack_residual_sections``, on the chosen rows by index).

Decision parity targets (reference): libs/lpc/src/lpc.c:330-441
(autocorr + Levinson), :535-570, :1341-1405 (quantize),
libs/srla_coder/src/srla_coder.c:262-324 (Rice parameters),
libs/srla_internal/src/srla_utility.c:206-257 (pre-emphasis),
srla_encoder.c:1121-1187 (accounting), :1323-1367 (selection).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import LPC_RIDGE_REGULARIZATION_PARAMETER
from .autocorr import autocorr, autocorr_plain  # noqa: F401 (re-exported)
from .bitpack import pack_residual_sections, zigzag
from .levinson import (_dist_to_half, _round_half_away,  # noqa: F401
                       levinson, lpc_analyze, lpc_coefs, lpc_quantize,
                       quantize_exact, select_order_exact)
from .ltp import LTP_COLS, LTP_LAGS, ltp_analyze, ltp_predict
from .predict import predict, reverse_coefs
from .preemphasis import (Spans, cut_spans,  # noqa: F401 (re-exported)
                          preemphasis_rows, variant_preemphasis,
                          variant_stack)
from .rice_search import rice_search
from .select import (account_bits, chosen_sections,  # noqa: F401
                     chosen_stream, measure_blocks, method_lengths,
                     section_starts, select_blocks, select_rows)
from .svr import svr_cov, svr_refine

# Safety margins, as in srla_tpu.kernels.exact (sized there for df64; f64
# errors are smaller, so they hold a fortiori). The f64 error they rest on,
# with u = 2^-53 and n <= 16384 terms a sum (the order choice's and the
# quantization's margins stand beside K7 in levinson.py, the LTP margins
# beside K10 in ltp.py):
#
# - Pre-emphasis: r0 and r1 are exact integer sums on both sides while they
#   stay below 2^53, and then 16 * r1 / r0 is the same two roundings: the
#   distance is 0. Above 2^53 (24-bit blocks can reach 2^60) the host sums
#   sequentially in f64, off by at most n * u = 2^-39 of r0 in each sum:
#   |16 * r1 / r0| moves by under 16 * 2^-38 = 6e-11 < _EPS_PREEMPH. K16
#   (csrc/preemphasis.cu) and its plain version (preemphasis.py) both sum
#   in 64-bit integers, exact in any order, and round once with the same
#   f64 operations: they take the same decisions, and this holds for both.
# - Autocorrelation: the plain version (autocorr_plain) sums the n lag
#   products in torch's tree (strips of a few terms, then pairwise), off by
#   at most (log2 n + strip) * u of r0; measured <= 2^-52 * r0. K8
#   (csrc/autocorr.cu) sums on the f64 tensor cores: an accumulator takes
#   16 DMMAs of 4 depth rows (64 products), then a pairwise tree over a
#   stage's up to 4 chunks, a pairwise tree over a lag's 16 residues,
#   stages of 4096 samples in order and one multiply by fft_size / n.
#   Whatever order a DMMA keeps inside, a product passes at most 5
#   roundings in its own DMMA and 4 in each of the 15 after it: at most
#   (65 + 2 + 4 + (stages - 1) + 1) * u of r0, 75 u = 2^-46.8 r0 at n =
#   16384 (tests/test_torch_autocorr.py emulates that order exactly, with
#   either order inside a DMMA, and pins the bound; on an H100 the DMMA is
#   a chain of fused multiply-adds and the kernel equals the emulation). The
#   host takes the same lags from a real FFT of round_up_pow2(n) points,
#   off by a few log2(n) * u of r0 in every lag; measured <= 2^-43 * r0 at
#   n = 16384. Either side together with the host stays under 2^-42 * r0
#   (2^-43 + 2^-46.8 < 2^-42), which tests/test_torch_encode_margins.py
#   pins and on which the Levinson and LTP margins rest. A strictly
#   sequential sum (n * u = 2^-39) would not.
# - Levinson, order choice and quantization (K7): levinson.py, above
#   _EPS_SILENT, carries the lag error d <= 2^-42 into the kappa-scaled
#   margins and bounds K7's order of gamma's sum.
# - Rice (K4): rice_search.py, beside the Rice margins.
_EPS_PREEMPH = 1e-8          # |16*r1/r0| distance to rounding half-boundary


# ---------------------------------------------------------------------------
# Analysis stages (``_analyze_core_exact``)
# ---------------------------------------------------------------------------

def preemphasis_exact(sig: torch.Tensor):
    """sig (V, n) int32. Returns (work int32, coef int32, risky bool): the
    pre-emphasis of K16's plain version (``preemphasis.preemphasis_rows``)
    at this module's margin."""
    return preemphasis_rows(sig, _EPS_PREEMPH)


def ltp_lags(work: torch.Tensor, n: int, bps: int,
             fft_size: int) -> torch.Tensor:
    """The pitch autocorrelation of work (V, n) int32: lags 0..262 by
    ``autocorr``, zero-padded to LTP_COLS columns as ``_ltp_exact:968-970``
    pads (the host's zero tail and a guard). The lags must fit the FFT size
    (n >= 512 on the device, as in srla_tpu)."""
    if fft_size < LTP_LAGS:
        raise ValueError(f"ltp_lags: {LTP_LAGS} lags need an FFT size of at "
                         f"least {LTP_LAGS}, got {fft_size}")
    return F.pad(autocorr(work, n, bps, LTP_LAGS, fft_size),
                 (0, LTP_COLS - LTP_LAGS))


def no_timer(_name):
    pass


def rice_exact(residual: torch.Tensor, n: int, max_porder: int,
               timer=no_timer):
    """residual (V, n) int32. Returns (code_type, porder, bits (+2), ks
    (V, 2^max_porder) int64, risky): the whole Rice parameter search, one
    K4 launch on the card."""
    out = rice_search(residual, n, max_porder)
    timer("K4 rice_search")
    return out


def analyze_core(src, lshift: int, *, n: int, bps: int, max_params: int,
                 max_fixed: bool, fft_size: int, max_porder: int,
                 ltp_order: int = 0, svr_iter: int = 0, margins=(),
                 timer=no_timer) -> dict:
    """The exact analysis of each variant row of a group of B blocks: the
    twin of ``_variant_analysis``'s stack and ``_analyze_core_exact``. src:
    the (B, C, n) int16/int32 blocks, or ``Spans`` of the resident file
    (read in place). Returns a dict of per-row tensors, ``work`` (the
    pre-emphasised rows, LTP-filtered at ltp_order > 0: the input of K3)
    among them. K16 stacks the variants and pre-emphasises them; with
    svr_iter > 0 the LPC coefficients are refined by SVR over ``margins``
    before they are quantized: K8, K7's coefficient entry, K11, K12, K7's
    quantization entry, then K3. ``timer`` is called with a step name
    after each step."""
    work, pre_coef, risky, pre_prev = variant_preemphasis(
        src, lshift, eps=_EPS_PREEMPH)
    timer("K16 preemphasis")
    V = work.shape[0]
    dev = work.device
    ltp_period = torch.zeros(V, dtype=torch.int32, device=dev)
    ltp_coefs = torch.zeros((V, max(ltp_order, 1)), dtype=torch.int32,
                            device=dev)
    if ltp_order > 0:
        lags = ltp_lags(work, n, bps, fft_size)
        timer("K8 autocorr (pitch lags)")
        ltp_period, ltp_coefs, r_ltp = ltp_analyze(lags, ltp_order)
        timer("K10 ltp_analyze")
        work = ltp_predict(work, ltp_coefs, ltp_period, ltp_order)
        timer("K18 ltp_predict")
        risky = risky | r_ltp
    if max_params > 0:
        ac = autocorr(work, n, bps, max_params + 1, fft_size)
        timer("K8 autocorr (LPC lags)")
        ac[:, 0] = ac[:, 0] * (1.0 + LPC_RIDGE_REGULARIZATION_PARAMETER)
        if svr_iter > 0:
            orders, coefs, kappa, r_lpc = lpc_coefs(ac, n, bps, max_params,
                                                    max_fixed)
            timer("K7 lpc_coefs")
            cov = svr_cov(work, orders, n, bps, max_params,
                          LPC_RIDGE_REGULARIZATION_PARAMETER)
            timer("K11 svr_cov")
            coefs, cerr, r_svr, _ = svr_refine(
                work, cov, coefs, orders, n, bps, svr_iter, margins,
                LPC_RIDGE_REGULARIZATION_PARAMETER, kappa)
            timer("K12 svr_refine")
            rshifts, intc, r_q = lpc_quantize(coefs, orders, kappa, cerr)
            r_lpc = r_lpc | r_svr | r_q
            step = "K7 lpc_quantize + reverse"
        else:
            orders, rshifts, intc, r_lpc = lpc_analyze(ac, n, bps,
                                                       max_params, max_fixed)
            step = "K7 lpc_analyze + reverse"
        rshifts = torch.where(orders > 0, rshifts, 0)
        coefs_rev = reverse_coefs(intc, orders)
        risky = risky | r_lpc
        timer(step)
        # K3, then K4 on its output: no other kernel between them.
        residual = predict(work, coefs_rev, orders, rshifts)
        timer("K3 fir_predict")
    else:
        orders = torch.zeros(V, dtype=torch.int32, device=dev)
        rshifts = torch.zeros(V, dtype=torch.int32, device=dev)
        coefs_rev = torch.zeros((V, 1), dtype=torch.int32, device=dev)
        residual = work
    code_type, porder, rice_bits, ks, r_rice = rice_exact(residual, n,
                                                          max_porder, timer)
    return dict(pre_prev=pre_prev, pre_coef=pre_coef, orders=orders,
                rshifts=rshifts, coefs=coefs_rev, work=work,
                residual=residual, code_type=code_type, porder=porder,
                rice_bits=rice_bits, ks=ks, risky=risky, rice_risky=r_rice,
                ltp_period=ltp_period, ltp_coefs=ltp_coefs)


def core_small(core: dict) -> dict:
    """``analyze_core``'s per-row parameters and flags under the names of
    ``srla_tpu.kernels.exact.analyze_blocks_exact``'s ``small``, ``risky``
    not yet merged with the Rice flags (K17 merges them)."""
    small = {k: core[k] for k in ("pre_prev", "pre_coef", "orders",
                                  "rshifts", "coefs", "code_type", "porder",
                                  "ltp_period", "ltp_coefs", "risky")}
    small["section_bits"] = core["rice_bits"]
    return small


def variant_analysis(blocks, lshift: int, *, n: int, bps: int,
                     max_params: int, max_fixed: bool, fft_size: int,
                     max_porder: int, ltp_order: int = 0, svr_iter: int = 0,
                     margins=(), timer=no_timer):
    """Stack the stereo variants of blocks (a (B, C, n) tensor or
    ``Spans``) and analyse them. Returns (small, big, core): ``small`` and
    ``big`` hold what ``srla_tpu.kernels.exact.analyze_blocks_exact``
    returns (per-row parameters and risky flags; the zigzag residuals and
    the Rice choices), ``core`` is ``analyze_core``'s dict."""
    core = analyze_core(blocks, lshift, n=n, bps=bps, max_params=max_params,
                        max_fixed=max_fixed, fft_size=fft_size,
                        max_porder=max_porder, ltp_order=ltp_order,
                        svr_iter=svr_iter, margins=margins, timer=timer)
    big = dict(u=zigzag(core["residual"]), code_type=core["code_type"],
               porder=core["porder"], ks=core["ks"])
    # The accounting's first step: every flag of a row together.
    small = core_small(core)
    small["risky"] = core["risky"] | core["rice_risky"]
    return small, big, core


def from_jax_analysis(small: dict, big: dict, device) -> tuple[dict, dict]:
    """The numpy outputs of ``srla_tpu.kernels.exact.analyze_blocks_exact``
    or of the approximate ``srla_tpu.kernels.encode.analyze_blocks_ex``
    (``small``, ``big``) as the port's tensors on ``device``, so that the
    port's selection, codewords and pack can run on JAX's decisions (``big``
    gains the int32 residual the zigzag codes stand for, what K5's row
    entry reads). The approximate ``small`` has no ``risky``: every row is
    unflagged."""
    keys = ("pre_prev", "pre_coef", "orders", "rshifts", "coefs",
            "code_type", "porder", "section_bits", "ltp_period", "ltp_coefs")
    s = {k: torch.from_numpy(np.asarray(small[k]).astype(np.int32)).to(device)
         for k in keys}
    risky = small.get("risky")
    s["risky"] = torch.from_numpy(
        np.zeros(len(s["orders"]), bool) if risky is None
        else np.array(risky, bool)).to(device)
    u = np.asarray(big["u"]).astype(np.uint32).astype(np.int64)
    b = {"u": torch.from_numpy(u).to(device),
         "residual": torch.from_numpy(
             ((u >> 1) ^ -(u & 1)).astype(np.int32)).to(device)}
    for k in ("code_type", "porder", "ks"):
        b[k] = torch.from_numpy(np.asarray(big[k]).astype(np.int64)).to(
            device)
    return s, b


# ---------------------------------------------------------------------------
# Fused encode: bit accounting, stereo selection and the residual pack
# ---------------------------------------------------------------------------

def encode_blocks(blocks, lshift: int, *, n: int, bps: int,
                  max_params: int, max_fixed: bool, fft_size: int,
                  max_porder: int, C: int, W: int, ltp_order: int = 0,
                  svr_iter: int = 0, margins=(), timer=no_timer):
    """Fused exact encode of one equal-size block group (the twin of
    ``srla_tpu.kernels.exact.encode_blocks_exact``).

    blocks: the (B, C, n) int16/int32 samples on the device, or ``Spans``
    of the resident file (read in place by K16). Returns (small, flat):
    ``small`` holds the per-variant parameters and merged flags plus the
    per-block selection (method, bits, raw_blk, risky_blk, use_sum) and
    lens_w, the packed section length of each (block, channel) row in
    words; ``flat`` is a (B*C*W,) int32 word buffer whose first sum(lens_w)
    words are the chosen residual sections, bit-packed MSB-first and
    compacted in row order; the words after them are unspecified. The
    stages: K16, the analysis (K8, K7, K3, K4; K10 and K18 with LTP; K11
    and K12 with SVR), K17's selection and K5 on the chosen rows by index.
    ``timer`` is called with a step name after each step.
    """
    B = blocks.shape[0]
    core = analyze_core(blocks, lshift, n=n, bps=bps, max_params=max_params,
                        max_fixed=max_fixed, fft_size=fft_size,
                        max_porder=max_porder, ltp_order=ltp_order,
                        svr_iter=svr_iter, margins=margins, timer=timer)
    small = core_small(core)
    sel = select_blocks(small, B=B, C=C, n=n, bps=bps, W=W,
                        max_params=max_params, rice_risky=core["rice_risky"])
    timer("K17 select")
    flat = pack_residual_sections(
        core["residual"], core["code_type"], core["porder"], core["ks"], n,
        sel["starts"], sel["lens_w"], B * C * W, section_words=W,
        rows=sel["rows"])
    timer("K5 bitpack")
    for k in ("method", "bits", "raw_blk", "risky_blk", "use_sum",
              "lens_w", "risky"):
        small[k] = sel[k]
    return small, flat


# ---------------------------------------------------------------------------
# Span measurement for the -V partition search
# ---------------------------------------------------------------------------

def measure_spans(file: torch.Tensor, offsets, lshift: int, *, n: int,
                  bps: int, max_params: int, max_fixed: bool, fft_size: int,
                  max_porder: int, C: int, ltp_order: int = 0,
                  svr_iter: int = 0, margins=(), timer=no_timer) -> dict:
    """Span measurement of the -V partition search: the twin of
    ``srla_tpu.kernels.exact.measure_spans_exact``.

    file: the (C, N) int16 (int32 above 16 bits) samples, resident on the
    device; offsets: (B,) host offsets with offset + n <= N. K16 reads the
    spans in place and the group is analysed as ``encode_blocks`` analyses
    one (K3 and K4 run once each, K10 and K18 too at ltp_order > 0); K17's
    measurement entry takes each span's best stereo method; nothing is
    packed. Returns ``small``: the per-variant ``section_bits``,
    ``orders``, ``coefs``, ``risky`` and ``ltp_period`` of
    ``measure_spans_exact`` and ``ltp_coefs``, plus per span ``bits``, the
    rounded block bits of the best stereo method
    (``srla_tpu/encoder.py:2020-2032``), and ``risky_blk``."""
    spans = Spans(file, offsets, n)
    timer("set-up")
    core = analyze_core(spans, lshift, n=n, bps=bps, max_params=max_params,
                        max_fixed=max_fixed, fft_size=fft_size,
                        max_porder=max_porder, ltp_order=ltp_order,
                        svr_iter=svr_iter, margins=margins, timer=timer)
    small = {k: v for k, v in core_small(core).items()
             if k in ("section_bits", "orders", "coefs", "risky",
                      "ltp_period", "ltp_coefs")}
    got = measure_blocks(small, B=spans.shape[0], C=C, bps=bps,
                         max_params=max_params,
                         rice_risky=core["rice_risky"])
    small.update(got)
    timer("K17 measure")
    return small
