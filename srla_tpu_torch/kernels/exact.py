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
are exact integer code, partly in the kernels K3 (``predict``), K4
(``rice_search``) and K5 (``bitpack.pack_residual_sections``).

Decision parity targets (reference): libs/lpc/src/lpc.c:330-441
(autocorr + Levinson), :535-570, :1341-1405 (quantize),
libs/srla_coder/src/srla_coder.c:262-324 (Rice parameters),
libs/srla_internal/src/srla_utility.c:206-257 (pre-emphasis),
srla_encoder.c:1121-1187 (accounting), :1323-1367 (selection).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import (LPC_COEFFICIENT_ORDER_BITWIDTH,
                         LPC_RIDGE_REGULARIZATION_PARAMETER,
                         LTP_COEFFICIENT_BITWIDTH, LTP_ORDER_BITWIDTH,
                         LTP_PERIOD_BITWIDTH, PREEMPHASIS_COEF_SHIFT,
                         RSHIFT_LPC_COEFFICIENT_BITWIDTH)
from ..huffman import parameter_codebook, sum_parameter_codebook
from .autocorr import autocorr, autocorr_plain  # noqa: F401 (re-exported)
from .bitpack import (pack_residual_sections, section_stream, zigzag,
                      zigzag32)
from .levinson import (_dist_to_half, _round_half_away,  # noqa: F401
                       levinson, lpc_analyze, lpc_coefs, lpc_quantize,
                       quantize_exact, select_order_exact)
from .lpc import wrap32
from .ltp import LTP_COLS, LTP_LAGS, ltp_analyze, ltp_predict
from .predict import predict, reverse_coefs
from .rice_search import rice_search
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
#   |16 * r1 / r0| moves by under 16 * 2^-38 = 6e-11 < _EPS_PREEMPH.
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

_F64 = torch.float64


# ---------------------------------------------------------------------------
# Analysis stages (``_analyze_core_exact``)
# ---------------------------------------------------------------------------

def preemphasis_exact(sig: torch.Tensor):
    """sig (V, n) int32. Returns (work int32, coef int32, risky bool).
    r0 and r1 are exact int64 sums rounded once to f64, as the host's are
    whenever they stay below 2^53."""
    x = sig.long()
    r0i = (x * x).sum(dim=1)
    r1i = (x[:, :-1] * x[:, 1:]).sum(dim=1)
    zero = r0i == 0
    r0 = torch.where(zero, 1, r0i).to(_F64)
    dc16 = (r1i.to(_F64) / r0) * float(1 << PREEMPHASIS_COEF_SHIFT)
    q = _round_half_away(dc16).clamp(-(1 << PREEMPHASIS_COEF_SHIFT),
                                     (1 << PREEMPHASIS_COEF_SHIFT) - 1)
    coef = torch.where(zero, 0, q.long())
    risky = (_dist_to_half(dc16) < _EPS_PREEMPH) & ~zero
    prev = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    pred = wrap32(prev * coef[:, None]) >> PREEMPHASIS_COEF_SHIFT
    work = wrap32(x - pred).to(torch.int32)
    return work, coef.to(torch.int32), risky


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


def analyze_core(sig: torch.Tensor, *, n: int, bps: int, max_params: int,
                 max_fixed: bool, fft_size: int, max_porder: int,
                 ltp_order: int = 0, svr_iter: int = 0, margins=(),
                 timer=no_timer) -> dict:
    """The exact analysis of each variant row of sig (V, n) int32: the twin
    of ``_analyze_core_exact``. Returns a dict of per-row tensors, ``work``
    (the pre-emphasised rows, LTP-filtered at ltp_order > 0: the input of
    K3) among them. With svr_iter > 0 the LPC coefficients are refined by
    SVR over ``margins`` before they are quantized: K8, K7's coefficient
    entry, K11, K12, K7's quantization entry, then K3. ``timer`` is called
    with a step name after each step."""
    V = sig.shape[0]
    dev = sig.device
    work, pre_coef, risky = preemphasis_exact(sig)
    ltp_period = torch.zeros(V, dtype=torch.int32, device=dev)
    ltp_coefs = torch.zeros((V, max(ltp_order, 1)), dtype=torch.int32,
                            device=dev)
    if ltp_order > 0:
        timer("variants + pre-emphasis (torch)")
        lags = ltp_lags(work, n, bps, fft_size)
        timer("K8 autocorr (pitch lags)")
        ltp_period, ltp_coefs, r_ltp = ltp_analyze(lags, ltp_order)
        timer("K10 ltp_analyze")
        work = ltp_predict(work, ltp_coefs, ltp_period, ltp_order)
        timer("LTP residual (torch)")
        risky = risky | r_ltp
    if max_params > 0:
        if ltp_order == 0:
            timer("variants + pre-emphasis (torch)")
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
    return dict(pre_prev=sig[:, 0], pre_coef=pre_coef, orders=orders,
                rshifts=rshifts, coefs=coefs_rev, work=work,
                residual=residual, code_type=code_type, porder=porder,
                rice_bits=rice_bits, ks=ks, risky=risky, rice_risky=r_rice,
                ltp_period=ltp_period, ltp_coefs=ltp_coefs)


def variant_stack(blocks: torch.Tensor, lshift: int) -> torch.Tensor:
    """blocks (B, C, n) int -> the (V, n) int32 analysis rows: [M, S] (for
    C >= 2) then each channel, each a (B, n) slab, after the offset shift."""
    work = blocks.to(torch.int32) >> lshift
    C = work.shape[1]
    parts = []
    if C >= 2:
        s = work[:, 1] - work[:, 0]
        parts += [work[:, 0] + (s >> 1), s]
    parts += [work[:, c] for c in range(C)]
    return torch.cat(parts, dim=0).contiguous()


def cut_spans(file: torch.Tensor, offsets, n: int) -> torch.Tensor:
    """The (B, C, n) spans of the resident (C, N) ``file`` that start at
    the host ``offsets`` (B,), cut on the file's device. Every span must lie
    inside the file: a CUDA gather past its end would read other memory."""
    offs = np.asarray(offsets, dtype=np.int64)
    N = file.shape[1]
    if offs.ndim != 1 or (offs < 0).any() or (offs + n > N).any():
        raise ValueError(f"cut_spans: a span of {n} samples leaves the "
                         f"{N}-sample file")
    idx = (torch.from_numpy(offs).to(file.device)[:, None]
           + torch.arange(n, device=file.device))
    return file[:, idx].permute(1, 0, 2)


def _small(core: dict) -> dict:
    """``analyze_core``'s per-row parameters and flags under the names of
    ``srla_tpu.kernels.exact.analyze_blocks_exact``'s ``small``."""
    small = {k: core[k] for k in ("pre_prev", "pre_coef", "orders",
                                  "rshifts", "coefs", "code_type", "porder",
                                  "ltp_period", "ltp_coefs")}
    small["section_bits"] = core["rice_bits"]
    # The accounting's first step: every flag of a row together.
    small["risky"] = core["risky"] | core["rice_risky"]
    return small


def variant_analysis(blocks: torch.Tensor, lshift: int, *, n: int, bps: int,
                     max_params: int, max_fixed: bool, fft_size: int,
                     max_porder: int, ltp_order: int = 0, svr_iter: int = 0,
                     margins=(), timer=no_timer):
    """Stack the stereo variants and analyse them. Returns (small, big,
    core): ``small`` and ``big`` hold what ``srla_tpu.kernels.exact.
    analyze_blocks_exact`` returns (per-row parameters and risky flags; the
    zigzag residuals and the Rice choices), ``core`` is ``analyze_core``'s
    dict."""
    core = analyze_core(variant_stack(blocks, lshift), n=n, bps=bps,
                        max_params=max_params, max_fixed=max_fixed,
                        fft_size=fft_size, max_porder=max_porder,
                        ltp_order=ltp_order, svr_iter=svr_iter,
                        margins=margins, timer=timer)
    big = dict(u=zigzag(core["residual"]), code_type=core["code_type"],
               porder=core["porder"], ks=core["ks"])
    return _small(core), big, core


def from_jax_analysis(small: dict, big: dict, device) -> tuple[dict, dict]:
    """The numpy outputs of ``srla_tpu.kernels.exact.analyze_blocks_exact``
    or of the approximate ``srla_tpu.kernels.encode.analyze_blocks_ex``
    (``small``, ``big``) as the port's tensors on ``device``, so that the
    port's selection, codewords and pack can run on JAX's decisions. The
    approximate ``small`` has no ``risky``: every row is unflagged."""
    keys = ("pre_prev", "pre_coef", "orders", "rshifts", "coefs",
            "code_type", "porder", "section_bits", "ltp_period", "ltp_coefs")
    s = {k: torch.from_numpy(np.asarray(small[k]).astype(np.int32)).to(device)
         for k in keys}
    risky = small.get("risky")
    s["risky"] = torch.from_numpy(
        np.zeros(len(s["orders"]), bool) if risky is None
        else np.array(risky, bool)).to(device)
    b = {"u": torch.from_numpy(
             np.asarray(big["u"]).astype(np.uint32).astype(np.int64)
         ).to(device)}
    for k in ("code_type", "porder", "ks"):
        b[k] = torch.from_numpy(np.asarray(big[k]).astype(np.int64)).to(
            device)
    return s, b


# ---------------------------------------------------------------------------
# Fused encode: bit accounting, stereo selection and the residual pack
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _huffman_len_tables():
    return (np.asarray(parameter_codebook().lengths, np.int64),
            np.asarray(sum_parameter_codebook().lengths, np.int64))


def account_bits(sec_bits, orders, coefs, bps: int, ltp_period,
                 ltp_order: int):
    """Exact per-variant code length (everything but the stereo method
    field) and the direct-vs-summed coefficient choice: the twin of
    ``exact._account_bits_dev`` plus the LTP fields of the rows with a
    period (``encode_blocks_exact:1376-1380``). coefs (V, M) reversed,
    left-aligned; ltp_period (V,) (0: no LTP fields). Returns (code_len
    (V,) int64, use_sum (V,) bool)."""
    dev = coefs.device
    pl, sl = _huffman_len_tables()
    plens = torch.from_numpy(pl).to(dev)
    slens = torch.from_numpy(sl).to(dev)
    M = coefs.shape[1]
    orders = orders.long()
    mask = torch.arange(M, device=dev)[None, :] < orders[:, None]
    uvc = zigzag(coefs).clamp(max=255)
    coef_cost = torch.where(mask, plens[uvc], 0).sum(dim=1)
    suv = zigzag(wrap32(coefs[:, 1:].long() + coefs[:, :-1].long()))
    smask = mask[:, 1:]
    svalid = (~smask | (suv < 256)).all(dim=1)
    sum_cost = plens[uvc[:, 0]] + torch.where(
        smask, slens[suv.clamp(max=255)], 0).sum(dim=1)
    use_sum = (orders > 0) & svalid & ((orders == 1)
                                       | (sum_cost < coef_cost))
    coef_bits = torch.where(orders > 0,
                            torch.where(use_sum, sum_cost, coef_cost), 0)
    fixed = (bps + 1 + (PREEMPHASIS_COEF_SHIFT + 1)
             + LPC_COEFFICIENT_ORDER_BITWIDTH
             + RSHIFT_LPC_COEFFICIENT_BITWIDTH + 1 + 1)
    ltp_bits = torch.where(ltp_period > 0, LTP_ORDER_BITWIDTH
                           + LTP_PERIOD_BITWIDTH
                           + ltp_order * LTP_COEFFICIENT_BITWIDTH, 0)
    return sec_bits.long() + fixed + coef_bits + ltp_bits, use_sum


def _method_lengths(small: dict, *, B: int, C: int, max_params: int,
                    bps: int):
    """Each block's code length under each stereo method (NONE, MS, LS, SR
    for C >= 2; one row for C = 1), everything but the method field and the
    byte rounding, and the variants' coefficient choice. The LTP order is
    the width of small["ltp_coefs"] (its periods are all 0 without -P).
    Returns ((4 or 1, B) int64, use_sum (V,) bool)."""
    nvar = C + 2 if C >= 2 else 1
    code_len, use_sum = account_bits(
        small["section_bits"], small["orders"],
        small["coefs"][:, :max(max_params, 1)], bps, small["ltp_period"],
        small["ltp_coefs"].shape[1])
    cl = code_len.reshape(nvar, B)
    if C >= 2:
        cl = torch.stack([cl[2] + cl[3], cl[0] + cl[1], cl[2] + cl[1],
                          cl[3] + cl[1]])
    return cl, use_sum


def select_rows(small: dict, *, B: int, C: int, n: int, bps: int, W: int,
                max_params: int) -> dict:
    """Stereo method (first minimum wins, as jnp.argmin), rounded block
    bits, raw-fallback and risky block masks, the chosen variant row of
    each (block, channel), and the packed section lengths in words:
    ``encode_blocks_exact``'s selection (:1373-1411). Rows r = block*C +
    channel; a zero ``lens_w`` row is not packed (raw fallback, risky
    block, or a section above W words)."""
    dev = small["orders"].device
    nvar = C + 2 if C >= 2 else 1
    lens, use_sum = _method_lengths(small, B=B, C=C, max_params=max_params,
                                    bps=bps)
    bi = torch.arange(B, device=dev)[:, None]
    ci = torch.arange(C, device=dev)[None, :]
    method = lens.argmin(dim=0)
    bits = lens.gather(0, method[None, :])[0]
    if C >= 2:
        m = method[:, None]
        vix = torch.where((m == 1) & (ci < 2), ci,
                          torch.where(((m == 2) & (ci == 1))
                                      | ((m == 3) & (ci == 0)), 1, 2 + ci))
    else:
        vix = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    bits = ((bits + 2 + 7) // 8) * 8
    raw_blk = bits >= bps * n * C
    risky_blk = small["risky"].reshape(nvar, B).any(dim=0)
    rows = (vix * B + bi).reshape(-1)
    sec = small["section_bits"].long()[rows]
    skip = ((raw_blk | risky_blk)[:, None]
            | (sec.reshape(B, C) > W * 32)).reshape(-1)
    lens_w = torch.where(skip, 0, (sec + 31) // 32)
    return dict(method=method, bits=bits, raw_blk=raw_blk,
                risky_blk=risky_blk, use_sum=use_sum, rows=rows, skip=skip,
                lens_w=lens_w)


def section_starts(lens_w: torch.Tensor) -> torch.Tensor:
    """The first word of each row's section in the compacted buffer: the
    running sum of the previous rows' lens_w."""
    return torch.cumsum(lens_w, dim=0) - lens_w


def chosen_sections(big: dict, sel: dict, n: int, cap_w: int) -> tuple:
    """``bitpack.pack_residual_sections``' arguments for the chosen rows:
    their zigzag residuals (big["u"]: int64 codes or int32 bit patterns) and
    Rice choices, compacted in row order into a buffer of cap_w words;
    skipped rows have lens_w 0 and contribute nothing."""
    rows, lens_w = sel["rows"], sel["lens_w"]
    return (big["u"][rows], big["code_type"][rows], big["porder"][rows],
            big["ks"][rows], n, section_starts(lens_w), lens_w, cap_w)


def chosen_stream(big: dict, sel: dict, n: int):
    """The chosen rows' codeword stream at absolute bit offsets in the
    compacted buffer. Returns (offsets, tails, tbits) (K, 2 + MAXP + n)
    int64: what the generic ``bitpack.pack`` takes."""
    return section_stream(*chosen_sections(big, sel, n, 0)[:7])


def encode_blocks(blocks: torch.Tensor, lshift: int, *, n: int, bps: int,
                  max_params: int, max_fixed: bool, fft_size: int,
                  max_porder: int, C: int, W: int, ltp_order: int = 0,
                  svr_iter: int = 0, margins=(), timer=no_timer):
    """Fused exact encode of one equal-size block group (the twin of
    ``srla_tpu.kernels.exact.encode_blocks_exact``).

    blocks (B, C, n) int16/int32 samples on the device. Returns (small,
    flat): ``small`` holds the per-variant parameters plus the per-block
    selection (method, bits, raw_blk, risky_blk, use_sum) and lens_w, the
    packed section length of each (block, channel) row in words; ``flat`` is
    a (B*C*W,) int32 word buffer whose first sum(lens_w) words are the
    chosen residual sections, bit-packed MSB-first and compacted in row
    order; the words after them are unspecified. ``timer`` is called with a
    step name after each step.
    """
    B = blocks.shape[0]
    core = analyze_core(variant_stack(blocks, lshift), n=n, bps=bps,
                        max_params=max_params, max_fixed=max_fixed,
                        fft_size=fft_size, max_porder=max_porder,
                        ltp_order=ltp_order, svr_iter=svr_iter,
                        margins=margins, timer=timer)
    small = _small(core)
    sel = select_rows(small, B=B, C=C, n=n, bps=bps, W=W,
                      max_params=max_params)
    # K5's arguments, the zigzag codes as the 32-bit patterns it reads.
    sections = chosen_sections(
        dict(u=zigzag32(core["residual"]), code_type=core["code_type"],
             porder=core["porder"], ks=core["ks"]), sel, n, B * C * W)
    timer("accounting + selection + codewords (torch)")
    flat = pack_residual_sections(*sections, section_words=W)
    timer("K5 bitpack")
    for k in ("method", "bits", "raw_blk", "risky_blk", "use_sum",
              "lens_w"):
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
    device; offsets: (B,) host offsets with offset + n <= N. The spans are
    cut on the device and analysed as ``encode_blocks`` analyses a group
    (K3 and K4 run once each, K10 too at ltp_order > 0); nothing is packed.
    Returns ``small``: the per-variant ``section_bits``, ``orders``,
    ``coefs``, ``risky`` and ``ltp_period`` of ``measure_spans_exact`` and
    ``ltp_coefs``, plus per span ``bits``, the rounded block bits of the
    best stereo method (``srla_tpu/encoder.py:2020-2032``), and
    ``risky_blk``."""
    blocks = cut_spans(file, offsets, n)
    core = analyze_core(variant_stack(blocks, lshift), n=n, bps=bps,
                        max_params=max_params, max_fixed=max_fixed,
                        fft_size=fft_size, max_porder=max_porder,
                        ltp_order=ltp_order, svr_iter=svr_iter,
                        margins=margins, timer=timer)
    small = {k: v for k, v in _small(core).items()
             if k in ("section_bits", "orders", "coefs", "risky",
                      "ltp_period", "ltp_coefs")}
    B = blocks.shape[0]
    lens, _ = _method_lengths(small, B=B, C=C, max_params=max_params,
                              bps=bps)
    small["bits"] = ((lens.min(dim=0).values + 2 + 7) // 8) * 8
    small["risky_blk"] = small["risky"].reshape(-1, B).any(dim=0)
    timer("accounting + selection (torch)")
    return small
