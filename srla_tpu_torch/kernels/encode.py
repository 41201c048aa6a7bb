"""The f32 approximate encode analysis (``SRLA_TPU_APPROX=1``): the twin of
``srla_tpu.kernels.encode``.

Every stage runs batched over the variant rows of a group, in f32: the
variant stack and the f32 pre-emphasis in K16's f32 entry
(``preemphasis.variant_preemphasis_f32``, reading the blocks or the
resident file's spans where they lie), the FFT autocorrelation in torch
ops (JAX computes it with ``jnp.fft``, outside any Pallas kernel, so
``torch.fft``, cuFFT on the card, is its twin), the pitch search and LTP
solve in torch ops (``torch.linalg.solve_ex`` where JAX calls
``jnp.linalg.solve``), the LTP residual in K18 (``ltp.ltp_predict``, the
exact path's kernel: ``_ltp``'s delay FIR is its arithmetic), the Levinson
recursion, order choice and quantization in kernel K14
(``lpc_f32.lpc_analyze_f32``), the exact wrapping-int32 FIR residual in K3
(``predict.predict``) and the Rice parameter search in K15
(``rice_cost.rice_cost``). The pre-emphasis sums are the exact 64-bit sums
rounded once to f32 where JAX sums in f32 (``ROADMAP.md``, the differences
by design). The parameter choices
may differ from the exact analysis', so the stream is not byte-identical
to the reference's; the residual is the exact FIR of the quantized
coefficients and K15's bits are the exact packed section lengths, so every
stream decodes losslessly. There are no decision-boundary flags and no
host repair.

``encode_blocks_approx`` encodes one equal-size group as
``kernels.exact.encode_blocks`` does, with this analysis in place of the
exact one: ``analyze_blocks_ex``, K17's selection (``select.select_blocks``)
with every row unflagged (the argmin ``srla_tpu``'s
``_device_finish_approx`` runs on the host) and K5's
``pack_residual_sections`` on the chosen rows by index.
``measure_spans_approx`` measures the -V spans (``srla_tpu``'s
``_measure_group_device`` under approx: the analysis without LTP on the
spans read in place, then K17's measurement entry).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (LPC_RIDGE_REGULARIZATION_PARAMETER,
                         LTP_MAX_PERIOD, LTP_MIN_PERIOD)
from .bitpack import pack_residual_sections, zigzag32
from .exact import no_timer
from .lpc_f32 import lpc_analyze_f32
from .ltp import ltp_predict
from .predict import predict, reverse_coefs
from .preemphasis import Spans, variant_preemphasis_f32
from .rice_cost import rice_cost
from .select import measure_blocks, select_blocks

_F32 = torch.float32
_RIDGE = float(np.float32(1.0 + LPC_RIDGE_REGULARIZATION_PARAMETER))
_WINDOWS: dict = {}


def welch_f32(n: int, device) -> torch.Tensor:
    """``_welch_f32`` (:35): the Welch window in f64, rounded to f32, made
    on ``device`` (no upload from host memory on the encode's path), once
    a device."""
    key = (n, str(device))
    if key not in _WINDOWS:
        s = torch.arange(n, dtype=torch.float64, device=device)
        _WINDOWS[key] = ((4.0 / (n - 1) ** 2) * s * ((n - 1) - s)).to(_F32)
    return _WINDOWS[key]


def preemphasis(sig: torch.Tensor):
    """``_preemphasis`` (:41): sig (V, n) int32. Returns (work int32, coef
    int32): K16's f32 entry on the rows (its plain version,
    ``preemphasis_f32_rows``, on the CPU): r0 and r1 the exact sums rounded
    once to f32, the coefficient rounded half to even and clipped to
    -16..15. The rows go to K16 as the (V, 1, n) view of V one-channel
    blocks, whose rows at lshift 0 are sig's."""
    work, coef, _ = variant_preemphasis_f32(sig[:, None, :], 0)
    return work, coef


def autocorr(work: torch.Tensor, n: int, bps: int, order: int,
             fft_size: int) -> torch.Tensor:
    """``_autocorr`` (:55): lags 0..order-1 (V, order) f32 of the
    Welch-windowed, 2^-(bps-1)-scaled rows, by a real FFT of fft_size
    points, the power spectrum and its inverse FFT."""
    scale = float(2.0 ** (-(bps - 1)))
    d = work.to(_F32) * scale * welch_f32(n, work.device)
    spec = torch.fft.rfft(d, n=fft_size)
    power = spec.real * spec.real + spec.imag * spec.imag
    return torch.fft.irfft(power, n=fft_size)[:, :order].contiguous()


def ltp_solve(acl: torch.Tensor, period: torch.Tensor, order: int):
    """``_ltp``'s solve (:247-264): the order 1 or 3 LTP coefficients of
    each row at its period (>= order // 2 + 1) from the pitch lags acl,
    the ridge on the Toeplitz diagonal. Returns (csol (V, order) f32, ok
    (V,) bool: False where the system is singular, which solve_ex reports
    instead of raising)."""
    V = acl.shape[0]
    dev = acl.device
    half = order // 2
    r0r = acl[:, 0] * _RIDGE
    if order == 1:
        rhs0 = acl.gather(1, period[:, None])[:, 0]
        csol = (rhs0 / torch.where(r0r.abs() < 1e-35, 1.0, r0r))[:, None]
        return csol, torch.ones(V, dtype=torch.bool, device=dev)
    # Symmetric Toeplitz A[j, k] = ac[|j - k|].
    idx = (torch.arange(order, device=dev)[:, None]
           - torch.arange(order, device=dev)[None, :]).abs()
    A = acl[:, idx]
    A.diagonal(dim1=1, dim2=2).copy_(r0r[:, None].expand(V, order))
    ridx = period[:, None] - half + torch.arange(order, device=dev)
    csol, info = torch.linalg.solve_ex(A, acl.gather(1, ridx)[..., None])
    return csol[..., 0], info == 0


def ltp_params(acl: torch.Tensor, order: int):
    """``_ltp``'s pitch choice and solve (:227-271) on the pitch lags acl
    (V, 263) f32: the period (the first positive local maximum of the lags
    in [8, 262) within 0.9 of the largest, that largest at least 0.1 of lag
    0), the order 1 or 3 coefficients from the ridge Toeplitz system,
    quantized to 6 bits rounding half away from zero. Returns (period (V,)
    int64, 0 where no period is valid; qrev (V, order) int64, the
    coefficients reversed, zero without a period)."""
    V = acl.shape[0]
    dev = acl.device
    half = order // 2
    r0 = acl[:, 0]
    j = torch.arange(acl.shape[1], device=dev)
    inrange = ((j >= LTP_MIN_PERIOD) & (j < LTP_MAX_PERIOD))[None, :]
    prev = torch.cat([acl[:, :1], acl[:, :-1]], dim=1)
    nxt = torch.cat([acl[:, 1:], acl[:, -1:]], dim=1)
    peak = (acl > prev) & (acl > nxt) & (acl > 0) & inrange
    max_peak = torch.where(peak, acl, 0.0).amax(dim=1)
    cand = peak & (acl >= 0.9 * max_peak[:, None])
    period = cand.to(torch.int32).argmax(dim=1)            # first candidate
    valid = (peak.any(dim=1) & (max_peak >= 0.1 * r0)
             & (r0.abs() > 1e-35) & (period >= half + 1))
    csol, solved = ltp_solve(acl, torch.clamp_min(period, half + 1), order)
    valid = valid & solved & torch.isfinite(csol).all(dim=1)
    csol = torch.where(torch.isfinite(csol), csol, 0.0)
    q = torch.where(csol >= 0, torch.floor(csol * 32.0 + 0.5),
                    -torch.floor(-csol * 32.0 + 0.5))
    qrev = torch.clamp(q, -32, 31).to(torch.int64).flip(1)
    return (torch.where(valid, period, 0),
            torch.where(valid[:, None], qrev, 0))


def ltp(work: torch.Tensor, n: int, bps: int, fft_size: int, order: int,
        timer=no_timer):
    """``_ltp`` (:216): the pitch lags (``autocorr``, 263 of them),
    ``ltp_params``, then ``_ltp``'s delay FIR (:274-285), which is K18's
    arithmetic (``ltp.ltp_predict``: the same delay, tap clamp, rounding
    and gate; rows of period 0 pass through). Returns (work int32, period
    (V,) int32, coefficients (V, order) int32 reversed, as JAX's qrev);
    rows without a valid period keep their samples and get period 0."""
    acl = autocorr(work, n, bps, LTP_MAX_PERIOD + 1, fft_size)
    period, qrev = ltp_params(acl, order)
    period = period.to(torch.int32)
    qrev = qrev.to(torch.int32).contiguous()
    timer("LTP lags + solve (torch, cuFFT)")
    out = ltp_predict(work, qrev, period, order)
    timer("K18 ltp_predict")
    return out, period, qrev


def analyze_core(src, lshift: int, *, n: int, bps: int, max_params: int,
                 max_fixed: bool, fft_size: int, max_porder: int,
                 ltp_order: int = 0, timer=no_timer) -> dict:
    """``_analyze_core`` (:344) on the variant rows of ``src``, a (B, C, n)
    block tensor or ``Spans`` (K16's f32 entry stacks and pre-emphasises
    them; variant rows (V, n) go as their (V, 1, n) view at lshift 0).
    Returns JAX's dict (pre_prev, pre_coef, orders, rshifts, coefs
    (reversed, left-aligned), residual, code_type, porder, rice_bits, ks,
    ltp_period, ltp_coefs). LTP runs only with fft_size >= 263 lags, as in
    JAX. ``timer`` is called with a step name after each step."""
    work, pre_coef, pre_prev = variant_preemphasis_f32(src, lshift)
    V = work.shape[0]
    dev = work.device
    ltp_period = torch.zeros(V, dtype=torch.int32, device=dev)
    ltp_coefs = torch.zeros((V, max(ltp_order, 1)), dtype=torch.int32,
                            device=dev)
    timer("K16 preemphasis (f32)")
    if ltp_order > 0 and fft_size >= LTP_MAX_PERIOD + 1:
        work, ltp_period, ltp_coefs = ltp(work, n, bps, fft_size, ltp_order,
                                          timer)
    if max_params > 0:
        ac = autocorr(work, n, bps, max_params + 1, fft_size)
        ac[:, 0] = ac[:, 0] * _RIDGE
        timer("autocorr (cuFFT)")
        orders, intc, rshifts = lpc_analyze_f32(ac, n, bps, max_params,
                                                max_fixed)
        timer("K14 lpc_analyze_f32")
        coefs_rev = reverse_coefs(intc, orders)
        residual = predict(work, coefs_rev, orders, rshifts)
        timer("K3 fir_predict")
    else:
        orders = torch.zeros(V, dtype=torch.int32, device=dev)
        rshifts = torch.zeros(V, dtype=torch.int32, device=dev)
        coefs_rev = torch.zeros((V, 1), dtype=torch.int32, device=dev)
        residual = work
    code_type, porder, rice_bits, ks = rice_cost(residual, n, max_porder)
    timer("K15 rice_cost")
    return dict(pre_prev=pre_prev, pre_coef=pre_coef, orders=orders,
                rshifts=rshifts, coefs=coefs_rev, residual=residual,
                code_type=code_type, porder=porder, rice_bits=rice_bits,
                ks=ks, ltp_period=ltp_period, ltp_coefs=ltp_coefs)


def analyze_variants(sig: torch.Tensor, *, n: int, bps: int,
                     max_params: int, max_fixed: bool, fft_size: int,
                     max_porder: int, timer=no_timer) -> dict:
    """``analyze_variants`` (:378): the analysis of a batch of variant rows
    (V, n) int32 on their device, without LTP, residuals returned."""
    return analyze_core(sig[:, None, :], 0, n=n, bps=bps,
                        max_params=max_params, max_fixed=max_fixed,
                        fft_size=fft_size, max_porder=max_porder,
                        timer=timer)


def pack_rows(u, code_type, porder, ks, bits, n: int, W: int):
    """Each row's section packed into its own W words: (V, W) int32 bit
    patterns, zero past the section. A row whose section exceeds W words
    is left all zero (JAX's packers keep its first W words, which no
    caller can use)."""
    V = u.shape[0]
    lens_w = (bits.long() + 31) // 32
    lens_w = torch.where(lens_w > W, 0, lens_w)
    starts = torch.arange(V, device=u.device) * W
    flat = pack_residual_sections(u, code_type, porder, ks, n, starts, lens_w,
                                  V * W, section_words=W)
    words = flat.view(V, W)
    col = torch.arange(W, device=u.device)[None, :]
    return torch.where(col < lens_w[:, None], words, 0)


def analyze_pack_variants(sig: torch.Tensor, *, n: int, bps: int,
                          max_params: int, max_fixed: bool, fft_size: int,
                          max_porder: int, W: int):
    """``analyze_pack_variants`` (:388): the analysis and every row's
    section packed on the device. Returns (small, words): ``small`` the
    per-row parameters and ``section_bits`` (the exact packed lengths, K15's
    bits), ``words`` (V, W) int32 (``pack_rows``), meant to stay on the
    device until ``gather_sections``."""
    out = analyze_variants(sig, n=n, bps=bps, max_params=max_params,
                           max_fixed=max_fixed, fft_size=fft_size,
                           max_porder=max_porder)
    words = pack_rows(zigzag32(out["residual"]), out["code_type"],
                      out["porder"], out["ks"], out["rice_bits"], n, W)
    small = {k: out[k] for k in ("pre_prev", "pre_coef", "orders", "rshifts",
                                 "coefs", "code_type", "porder", "rice_bits")}
    small["section_bits"] = out["rice_bits"]
    return small, words


def analyze_blocks_ex(blocks, lshift: int, *, n: int, bps: int,
                      max_params: int, max_fixed: bool, fft_size: int,
                      max_porder: int, C: int, ltp_order: int = 0,
                      timer=no_timer):
    """``analyze_blocks_ex`` (:413): blocks (B, C, n) int16/int32 samples
    on the device, or ``Spans`` of the resident file. K16's f32 entry
    stacks the variants ([M, S] for C >= 2, then each channel) where the
    samples lie; the rows are analysed. Returns (small, big): ``small``
    the per-row parameters with ``section_bits`` (K15's exact packed
    lengths), no ``risky`` (nothing is flagged); ``big`` the int32
    residual (what K5's row entry reads; JAX's twin hands over its zigzag
    codes) and the Rice choices."""
    if blocks.shape[1] != C:
        raise ValueError(f"analyze_blocks_ex: blocks have {blocks.shape[1]} "
                         f"channels, C = {C}")
    out = analyze_core(blocks, lshift, n=n, bps=bps, max_params=max_params,
                       max_fixed=max_fixed, fft_size=fft_size,
                       max_porder=max_porder, ltp_order=ltp_order,
                       timer=timer)
    small = {k: out[k] for k in ("pre_prev", "pre_coef", "orders", "rshifts",
                                 "coefs", "code_type", "porder",
                                 "ltp_period", "ltp_coefs")}
    small["section_bits"] = out["rice_bits"]
    big = dict(residual=out["residual"], code_type=out["code_type"],
               porder=out["porder"], ks=out["ks"])
    return small, big


def encode_blocks_approx(blocks, lshift: int, *, n: int, bps: int,
                         max_params: int, max_fixed: bool, fft_size: int,
                         max_porder: int, C: int, W: int, ltp_order: int = 0,
                         timer=no_timer):
    """The approximate encode of one equal-size block group: the twin of
    ``srla_tpu``'s ``_device_dispatch`` + ``_device_finish_approx`` under
    approx, with the same results as ``kernels.exact.encode_blocks``.

    blocks: a (B, C, n) tensor or ``Spans`` of the resident file (read in
    place). ``analyze_blocks_ex``, then K17's selection with every row
    unflagged (so ``risky_blk`` is all False; a section above W words still
    gets lens_w 0, and its block goes to the host), then K5 on the chosen
    rows by index. Returns (small, flat) as ``encode_blocks`` does:
    ``flat`` holds the chosen sections compacted in row order in its first
    sum(lens_w) words."""
    B = blocks.shape[0]
    small, big = analyze_blocks_ex(blocks, lshift, n=n, bps=bps,
                                   max_params=max_params,
                                   max_fixed=max_fixed, fft_size=fft_size,
                                   max_porder=max_porder, C=C,
                                   ltp_order=ltp_order, timer=timer)
    small = dict(small)
    sel = select_blocks(small, B=B, C=C, n=n, bps=bps, W=W,
                        max_params=max_params)
    timer("K17 select")
    flat = pack_residual_sections(
        big["residual"], big["code_type"], big["porder"], big["ks"], n,
        sel["starts"], sel["lens_w"], B * C * W, section_words=W,
        rows=sel["rows"])
    timer("K5 bitpack")
    for k in ("method", "bits", "raw_blk", "risky_blk", "use_sum",
              "lens_w", "risky"):
        small[k] = sel[k]
    return small, flat


def measure_spans_approx(file: torch.Tensor, offsets, lshift: int, *, n: int,
                         bps: int, max_params: int, max_fixed: bool,
                         fft_size: int, max_porder: int, C: int,
                         timer=no_timer) -> torch.Tensor:
    """The -V span measurement under approx (``srla_tpu``'s
    ``_measure_group_device`` :1933-1942): the spans of the resident (C, N)
    ``file`` at host ``offsets`` read in place by K16's f32 entry, their
    variants analysed as ``analyze_variants`` analyses rows (no LTP), the
    accounting and the best stereo method. Returns each span's rounded
    block bits (B,) int64; nothing is flagged."""
    spans = Spans(file, offsets, n)
    out = analyze_core(spans, lshift, n=n, bps=bps, max_params=max_params,
                       max_fixed=max_fixed, fft_size=fft_size,
                       max_porder=max_porder, timer=timer)
    V = out["orders"].shape[0]
    zeros = torch.zeros(V, dtype=torch.int32, device=file.device)
    small = dict(section_bits=out["rice_bits"], orders=out["orders"],
                 coefs=out["coefs"], ltp_period=zeros,
                 ltp_coefs=zeros[:, None])
    bits = measure_blocks(small, B=spans.shape[0], C=C, bps=bps,
                          max_params=max_params)["bits"]
    timer("K17 measure")
    return bits


def pack_chosen(u, code_type, porder, ks, chosen, starts, lens, *, n: int,
                W: int, cap: int):
    """``pack_chosen`` (:450): pack only the ``chosen`` rows, compacted into
    one flat buffer. starts, lens (K,) the word offset (the running sum of
    lens) and length of each chosen row's section. Returns (flat (cap,)
    int32, zero past the last section; overflow (K,) bool: rows whose
    section exceeds W words, left out and to be host-encoded)."""
    ovf = lens > W
    lens = torch.where(ovf, 0, lens)
    flat = pack_residual_sections(u[chosen], code_type[chosen],
                                  porder[chosen], ks[chosen], n, starts,
                                  lens, cap, section_words=W)
    end = (starts.long() + lens.long()).amax() if lens.numel() else 0
    return torch.where(torch.arange(cap, device=flat.device) < end, flat,
                       0), ovf


def gather_sections(words: torch.Tensor, chosen: torch.Tensor,
                    starts: torch.Tensor, lens: torch.Tensor, cap: int):
    """``gather_sections`` (:472): compact the chosen rows' packed sections
    of words (V, W) into one flat buffer. chosen (K,) rows in output order,
    starts (K,) sorted word offsets, lens (K,) word counts. Returns (cap,)
    of words' dtype, zero where no section lies."""
    dev = words.device
    j = torch.arange(cap, device=dev)
    seg = torch.clamp(torch.searchsorted(starts.long(), j, right=True) - 1,
                      0, chosen.shape[0] - 1)
    col = j - starts.long()[seg]
    ok = (col >= 0) & (col < lens.long()[seg])
    col = torch.clamp(col, 0, words.shape[1] - 1)
    return torch.where(ok, words[chosen.long()[seg], col], 0)
