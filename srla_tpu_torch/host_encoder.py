"""SRLA exact host encoder.

The port's own copy of the exact host path of ``srla_tpu/encoder.py``: the
batched per-channel analysis (pre-emphasis, long-term prediction, windowed
autocorrelation, Levinson-Durbin, order selection, quantization, FIR
residual, Rice search, bit accounting), stereo selection, payload emission,
the stale work-buffer chain of odd-length blocks, RAW and SILENT blocks,
progress, the repair-rate warning, and the variable block-size search
(-V > 0: every candidate span of a lookahead window measured, then the
reference's Dijkstra over their byte sizes, ``srla_encoder.c:249-424``).

``SRLAEncoder`` here is what the port's device ``encoder.SRLAEncoder`` holds
for what it encodes or measures on the host (odd sizes, the odd last
lookahead window, RAW and SILENT blocks, flagged repairs), and ``encode`` is
the byte reference of the port's tests and ``chip_smoke.py``: the tests hold
it byte-equal to ``srla_tpu.encode(..., backend="exact")``, which is
byte-exact with the C reference, SVR refinement
(``--svr-filter-learning-iteration``, ``dsp/svr.py``) included. Its host
batches split over ``workers`` threads, as ``SRLA_HOST_THREADS`` splits
``srla_tpu``'s. Not copied: the device backends and the host worker
process (``srla_tpu/hostproc.py``).

API parity targets: SRLAEncoder_* in libs/srla_encoder/src/srla_encoder.c.
"""

from __future__ import annotations

import math
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from . import native_decoder, rice
from .bitio import BitWriter, sint32_to_uint32
from .constants import (LPC_COEFFICIENT_BITWIDTH,
                        LPC_COEFFICIENT_ORDER_BITWIDTH,
                        LPC_RIDGE_REGULARIZATION_PARAMETER,
                        LTP_COEFFICIENT_BITWIDTH, LTP_MAX_PERIOD,
                        LTP_MIN_PERIOD, LTP_ORDER_BITWIDTH,
                        LTP_PERIOD_BITWIDTH, PARAMETER_PRESETS,
                        PREEMPHASIS_COEF_SHIFT,
                        RSHIFT_LPC_COEFFICIENT_BITWIDTH, BlockDataType,
                        ChProcessMethod, OrderTactics)
from .dsp import preemphasis as preemph
from .dsp.autocorr import autocorr_fft
from .dsp.fft import round_up_pow2
from .dsp.levinson import levinson_coefs_at, levinson_error_vars
from .dsp.pitch import calculate_ltp_coefficients
from .dsp.predict import lpc_predict, ltp_predict
from .dsp.quantize import quantize_coefficients
from .dsp.svr import svr_refine_batch
from .dsp.window import welch_inverse_squared_sum, welch_window
from .format import StreamHeader, encode_header, frame_block
from .huffman import parameter_codebook, sum_parameter_codebook

_INV_LOGE2 = 1.4426950408889634
_FLT_MAX = 3.402823466e38
_BIG = float(1 << 24)      # the -V search's cost of a missing edge


@dataclass
class EncodeParameter:
    num_channels: int
    bits_per_sample: int
    sampling_rate: int
    preset: int = 4
    max_num_samples_per_block: int = 4096
    min_num_samples_per_block: int = 4096
    num_lookahead_samples: int = 16384
    ltp_order: int = 0
    num_svr_filter_learning_iteration: int = 0

    def validate(self):
        if self.bits_per_sample not in (8, 16, 24):
            raise ValueError("bits_per_sample must be 8, 16, or 24")
        if self.min_num_samples_per_block > self.max_num_samples_per_block:
            raise ValueError("min block > max block")
        if self.num_lookahead_samples < self.max_num_samples_per_block:
            raise ValueError("lookahead < max block")
        if self.num_lookahead_samples % self.min_num_samples_per_block != 0:
            raise ValueError("lookahead not divisible by min block")
        if self.ltp_order > 0 and self.ltp_order % 2 == 0:
            raise ValueError("ltp order must be odd")
        if self.ltp_order > 3:
            raise ValueError("ltp order too large")


@dataclass
class _ChannelParams:
    """Per-(block, channel-variant) analysis results, batched over blocks."""
    pre_prev: np.ndarray      # (B,) int32 — transmitted pre-emphasis prev
    pre_coef: np.ndarray      # (B,) int32
    lpc_order: np.ndarray     # (B,) int32
    lpc_rshift: np.ndarray    # (B,) int32
    lpc_coefs: np.ndarray     # (B, maxorder) int32, reversed, left-aligned
    use_sum_coef: np.ndarray  # (B,) bool
    ltp_period: np.ndarray    # (B,) int32 (0 = off)
    ltp_coefs: np.ndarray     # (B, ltp_order) int32, reversed
    residual: np.ndarray      # (B, n) int32
    code_length: np.ndarray   # (B,) int64 bits (everything but stereo flag)
    rice_type: np.ndarray     # (B,) int32 CodeType
    rice_porder: np.ndarray   # (B,) int32
    rice_ks: np.ndarray       # (B, 1024) int16 per-partition parameters

    def rows(self):
        return [getattr(self, f) for f in self.__dataclass_fields__]


def _geometric_entropy_scalar(mabse: float, bps: int) -> float:
    if mabse < 1e-16:
        return 0.0
    intmean = mabse * (1 << (bps - 1))
    rho = 1.0 / (1.0 + intmean)
    invrho = 1.0 - rho
    return -(invrho * (math.log(invrho) * _INV_LOGE2)
             + rho * (math.log(rho) * _INV_LOGE2)) / rho


def _slice_params(p: _ChannelParams, lo: int, hi: int) -> _ChannelParams:
    return _ChannelParams(*[f[lo:hi] for f in p.rows()])


class SRLAEncoder:
    def __init__(self, parameter: EncodeParameter, workers: int = 1):
        """workers: threads a host batch of even-size blocks is split over
        (``srla_tpu``'s ``SRLA_HOST_THREADS``): with more than one and at
        least two blocks a thread, the batch is sharded ``idxs[j::workers]``
        over a thread pool (the hot loops are native or numpy and release
        the GIL). The bytes do not depend on it."""
        parameter.validate()
        self.p = parameter
        self.workers = max(1, int(workers))
        # Guards ``stats`` and the progress meter: host batches may run on
        # two threads at once (a device encoder's repairs and its hybrid's
        # stealing thread).
        self._lock = threading.Lock()
        self._progress_cb = None
        self._progress_done = 0
        # Per-encode accounting, with srla_tpu's keys: COMPRESS blocks
        # emitted from the device, blocks encoded on the host, flagged
        # blocks re-derived on the host, blocks whose packed section
        # exceeded its bound. The device counts are the device encoder's.
        # Then the spans whose bits the -V search (or the block API)
        # measured by analysis: on the device, flagged there and re-measured
        # on the host, or measured on the host (odd sizes, the odd last
        # window).
        self.stats = {"device_blocks": 0, "host_blocks": 0,
                      "repaired_blocks": 0, "w_overflow_blocks": 0,
                      "device_spans": 0, "remeasured_spans": 0,
                      "host_spans": 0}
        self.preset = PARAMETER_PRESETS[parameter.preset]
        self._param_cb = parameter_codebook()
        self._sum_cb = sum_parameter_codebook()
        self._param_lens = self._param_cb.lengths
        self._sum_lens = self._sum_cb.lengths

    # ------------------------------------------------------------------ #
    # Per-channel analysis pipeline (batched over blocks of equal length) #
    # ------------------------------------------------------------------ #

    def _analyze_channel(self, sig: np.ndarray, n: int, stale_state=None,
                         want_state: bool = False):
        """Batched per-channel analysis. `stale_state` emulates the
        reference's persistent LPC work buffer (needed for bit-exactness of
        odd-length blocks, whose Welch window leaves the middle sample
        unwritten); serial callers (B=1) thread it between variants and get
        the new state back when `want_state` is set."""
        B = sig.shape[0]
        bps = self.p.bits_per_sample
        max_params = self.preset.max_num_parameters
        state = stale_state

        # 1. Pre-emphasis: coefficient, then in-place filter with prev = head.
        pre_coef = preemph.calculate_coefficient(sig, n)
        head = sig[:, 0].copy()
        work = preemph.preemphasis(sig[:, :n], pre_coef, head)

        # 2. Long-term (pitch) prediction.
        ltp_order = self.p.ltp_order
        ltp_period = np.zeros(B, dtype=np.int32)
        ltp_coefs = np.zeros((B, max(ltp_order, 1)), dtype=np.int32)
        if ltp_order > 0:
            norm = 2.0 ** (-(bps - 1))
            max_lag = LTP_MAX_PERIOD + 1
            if state is not None and len(state) < max_lag:
                # Lags past the work buffer (blocks under 263 samples at a
                # max block under 263) read the arena beyond it: fresh
                # memory, zeros, as _fresh_state takes it.
                state = np.concatenate([state,
                                        np.zeros(max_lag - len(state))])
            if n == 1:
                # Degenerate 1-sample tail: the whole signal is the Welch
                # window's unwritten middle, and the size-1 real FFT mixes
                # it with stale buffer[1] (fft.c:147-198 with n=1).
                s0 = 0.0 if state is None else float(state[0])
                s1 = 0.0 if state is None else float(state[1])
                b0, b1 = s0 + s1, s0 - s1
                c0, c1 = b0 * b0, b1 * b1
                y0, y1 = 0.5 * (c0 + c1), 0.5 * (c0 - c1)
                base = (np.zeros(max_lag) if state is None
                        else state[:max_lag].astype(np.float64).copy())
                base[0] = y0
                if max_lag > 1:
                    base[1] = y1
                ac = np.broadcast_to(base * 2.0, (B, max_lag)).copy()
                if want_state:
                    ns = (state.copy() if state is not None
                          else np.zeros(2))
                    ns[0] = y0
                    ns[1] = y1
                    state = ns
            else:
                win = welch_window(n)
                fft_size = round_up_pow2(n)
                if native_decoder.available() and not want_state:
                    # Fused native normalize+window+FFT (AVX2 4-lane SoA
                    # when batched) — same rounding chain as the numpy
                    # path below, already golden-validated for the LPC
                    # autocorrelation.
                    mid = 0.0 if state is None else float(state[n // 2])
                    ac = native_decoder.window_autocorr_batch(
                        work, n, norm, win, bool(n & 1), mid, fft_size,
                        max_lag)
                else:
                    dbl = work.astype(np.float64) * norm
                    windowed = dbl * win
                    if n & 1:
                        windowed[:, n // 2] = (0.0 if state is None
                                               else state[n // 2])
                    ac, raw = autocorr_fft(windowed, n, max_lag,
                                           want_raw=True)
                if max_lag > fft_size and state is not None:
                    # The reference reads stale buffer content for lags
                    # beyond the FFT size (tiny tail blocks with LTP).
                    ac[:, fft_size:] = state[fft_size:max_lag] * (2.0 / n)
                if want_state:
                    ns = state.copy() if state is not None else np.zeros(
                        max(len(raw[0]), n))
                    ns[:raw.shape[1]] = raw[0]
                    state = ns
            acbuf = np.zeros((B, LTP_MAX_PERIOD + 3))
            acbuf[:, :max_lag] = ac
            if native_decoder.available():
                ltp_period, ltp_coefs = native_decoder.ltp_analyze_batch(
                    acbuf, ltp_order, LTP_MIN_PERIOD, LTP_MAX_PERIOD,
                    LPC_RIDGE_REGULARIZATION_PARAMETER)
            else:
                for b in range(B):
                    coef, period = calculate_ltp_coefficients(
                        acbuf[b], ltp_order, LTP_MIN_PERIOD, LTP_MAX_PERIOD,
                        LPC_RIDGE_REGULARIZATION_PARAMETER)
                    if period > 0:
                        q = np.where(coef >= 0, np.floor(coef * 32.0 + 0.5),
                                     -np.floor(-coef * 32.0 + 0.5))
                        q = np.clip(q, -32, 31).astype(np.int32)
                        ltp_coefs[b] = q[::-1]
                        ltp_period[b] = period
            if (ltp_period > 0).any():
                filtered = ltp_predict(work, ltp_coefs, ltp_order, ltp_period,
                                       LTP_COEFFICIENT_BITWIDTH - 1)
                work = np.where((ltp_period > 0)[:, None], filtered, work)

        # 3..9. LPC analysis chain.
        orders = np.zeros(B, dtype=np.int32)
        rshifts = np.zeros(B, dtype=np.int32)
        int_coefs = np.zeros((B, max(max_params, 1)), dtype=np.int32)
        if max_params > 0:
            norm = 2.0 ** (-(bps - 1))
            win = welch_window(n)
            dbl = None
            if native_decoder.available():
                # Fused native path: normalize+window+pad+FFT in one pass.
                mid = 0.0 if state is None else float(state[n // 2])
                if want_state:
                    ac, raw = native_decoder.window_autocorr_batch(
                        work, n, norm, win, bool(n & 1), mid,
                        round_up_pow2(n), max_params + 1, want_raw=True)
                    # Preserve the work buffer's stale TAIL beyond this
                    # FFT's length — tiny spans' LTP lag patches read it.
                    ns = (state.copy() if state is not None
                          else np.zeros(max(raw.shape[1], n)))
                    ns[:raw.shape[1]] = raw[0]
                    state = ns
                else:
                    ac = native_decoder.window_autocorr_batch(
                        work, n, norm, win, bool(n & 1), mid,
                        round_up_pow2(n), max_params + 1)
            else:
                dbl = work.astype(np.float64) * norm
                windowed = dbl * win
                if n & 1:
                    windowed[:, n // 2] = (0.0 if state is None
                                           else state[n // 2])
                if want_state:
                    ac, raw = autocorr_fft(windowed, n, max_params + 1,
                                           want_raw=True)
                    ns = (state.copy() if state is not None
                          else np.zeros(max(raw.shape[1], n)))
                    ns[:raw.shape[1]] = raw[0]
                    state = ns
                else:
                    ac = autocorr_fft(windowed, n, max_params + 1)
            ac[:, 0] = ac[:, 0] * (1.0 + LPC_RIDGE_REGULARIZATION_PARAMETER)
            error_vars, _ = levinson_error_vars(ac, max_params)
            # Window energy correction (applied before order selection).
            error_vars = error_vars * welch_inverse_squared_sum(n)
            orders = self._select_order(error_vars, n, max_params)
            coefs_f = levinson_coefs_at(ac, max_params, orders)
            if self.p.num_svr_filter_learning_iteration > 0:
                if dbl is None:
                    dbl = work.astype(np.float64) * norm
                coefs_f, svr_bufs = self._svr_refine(dbl, coefs_f, orders, n)
                if want_state and svr_bufs[0] is not None:
                    # The reference's SVR writes its soft-thresholded
                    # residuals into the persistent work buffer; thread it.
                    ns = (state.copy() if state is not None
                          else np.zeros(max(n, 2)))
                    ns[:n] = svr_bufs[0]
                    state = ns
            int_coefs, rshifts = quantize_coefficients(
                coefs_f, orders, LPC_COEFFICIENT_BITWIDTH,
                1 << RSHIFT_LPC_COEFFICIENT_BITWIDTH)
            rshifts = np.where(orders > 0, rshifts, 0).astype(np.int32)
            # Reverse for forward-indexed convolution.
            rev = np.zeros_like(int_coefs)
            for b in range(B):
                o = int(orders[b])
                if o:
                    rev[b, :o] = int_coefs[b, :o][::-1]
            int_coefs = rev
            residual = lpc_predict(work, int_coefs, orders, rshifts)
        else:
            # Order 0: the pre-emphasis (or LTP) output IS the residual.
            # Both producers return fresh buffers, so aliasing is safe.
            residual = work

        # 13. Exact bit accounting (vectorized over the batch).
        rice_type, rice_porder, rice_bits, rice_ks = rice.analyze_batch(
            residual[:, :n], n)
        code_length, use_sum = self._account_bits(
            rice_bits, orders, int_coefs, ltp_period, ltp_order)
        params = _ChannelParams(head.astype(np.int32), pre_coef, orders,
                                rshifts, int_coefs, use_sum, ltp_period,
                                ltp_coefs, residual, code_length, rice_type,
                                rice_porder, rice_ks)
        if want_state:
            return params, state
        return params

    def _account_bits(self, rice_bits, orders, int_coefs, ltp_period,
                      ltp_order):
        """Exact per-channel bit accounting, vectorized (everything except
        the stereo method field). Parity: srla_encoder.c:1121-1187."""
        bps = self.p.bits_per_sample
        plens = self._param_lens
        slens = self._sum_lens
        B, M = int_coefs.shape
        if native_decoder.available():
            fixed = (bps + 1 + (PREEMPHASIS_COEF_SHIFT + 1)
                     + LPC_COEFFICIENT_ORDER_BITWIDTH
                     + RSHIFT_LPC_COEFFICIENT_BITWIDTH + 1 + 1)
            ltp_bits = (LTP_ORDER_BITWIDTH + LTP_PERIOD_BITWIDTH
                        + ltp_order * LTP_COEFFICIENT_BITWIDTH)
            return native_decoder.account_bits_batch(
                rice_bits, orders, int_coefs, ltp_period, ltp_bits, plens,
                slens, fixed)
        mask = np.arange(M)[None, :] < orders[:, None]
        uv = sint32_to_uint32(int_coefs)
        coef_cost = np.where(mask, plens[uv], 0).sum(axis=1)
        summed = (int_coefs[:, 1:].astype(np.int64)
                  + int_coefs[:, :-1].astype(np.int64)).astype(np.int32)
        suv = sint32_to_uint32(summed)
        smask = mask[:, 1:]
        svalid = (~smask | (suv < 256)).all(axis=1)
        sum_cost = (plens[uv[:, 0]]
                    + np.where(smask, slens[np.minimum(suv, 255)], 0).sum(axis=1))
        # use_sum starts set and is only cleared while scanning; order-1
        # blocks therefore keep it (identical cost either way).
        use_sum = (orders > 0) & svalid & ((orders == 1)
                                           | (sum_cost < coef_cost))
        coef_bits = np.where(orders > 0,
                             np.where(use_sum, sum_cost, coef_cost), 0)
        code_length = (rice_bits.astype(np.int64)
                       + bps + 1 + (PREEMPHASIS_COEF_SHIFT + 1)
                       + LPC_COEFFICIENT_ORDER_BITWIDTH
                       + RSHIFT_LPC_COEFFICIENT_BITWIDTH + 1
                       + coef_bits + 1
                       + np.where(ltp_period > 0,
                                  LTP_ORDER_BITWIDTH + LTP_PERIOD_BITWIDTH
                                  + ltp_order * LTP_COEFFICIENT_BITWIDTH, 0))
        return code_length.astype(np.int64), use_sum

    # ------------------------------------------------------------------ #
    # Block-level encoding                                                #
    # ------------------------------------------------------------------ #

    def _select_order(self, error_vars: np.ndarray, n: int,
                      max_params: int) -> np.ndarray:
        """Order selection per block (BRUTEFORCE_ESTIMATION or MAX_FIXED).

        Vectorized entropy estimate with scalar-libm re-evaluation whenever
        the top two candidates are too close to trust np.log's last ulp.
        """
        B = error_vars.shape[0]
        if self.preset.lpc_order_tactics == OrderTactics.MAX_FIXED:
            return np.full(B, max_params, dtype=np.int32)
        bps = self.p.bits_per_sample
        if native_decoder.available():
            # Single-pass native twin: plain libm log/sqrt IS the scalar
            # repair chain below, so coarse+repair collapses to one loop.
            return native_decoder.select_orders_batch(
                error_vars, n, bps, max_params, LPC_COEFFICIENT_BITWIDTH)
        with np.errstate(invalid="ignore", divide="ignore"):
            mabse = 2.0 * np.sqrt(error_vars[:, 1:] / 2.0)
            intmean = mabse * float(1 << (bps - 1))
            rho = 1.0 / (1.0 + intmean)
            invrho = 1.0 - rho
            ent = -(invrho * (np.log(invrho) * _INV_LOGE2)
                    + rho * (np.log(rho) * _INV_LOGE2)) / rho
            ent = np.where(mabse < 1e-16, 0.0, ent)
            length = (ent * n + LPC_COEFFICIENT_BITWIDTH
                      * np.arange(1, max_params + 1)[None, :])
        safe = np.where(np.isnan(length), np.inf, length)
        orders = (np.argmin(safe, axis=1) + 1).astype(np.int32)
        # Tie repair: re-evaluate blocks whose best two lengths are within
        # 1e-6 bits using the exact libm chain.
        part = np.partition(safe, 1, axis=1) if safe.shape[1] > 1 else None
        if part is not None:
            risky = np.flatnonzero(np.abs(part[:, 1] - part[:, 0]) < 1e-6)
            for b in risky:
                minlen = _FLT_MAX
                best = 0
                for order in range(1, max_params + 1):
                    ev = error_vars[b, order]
                    if not ev >= 0.0:  # NaN/negative: never selected (C NaN)
                        continue
                    mab = 2.0 * math.sqrt(ev / 2.0)
                    ln = (_geometric_entropy_scalar(mab, bps) * n
                          + LPC_COEFFICIENT_BITWIDTH * order)
                    if minlen > ln:
                        minlen = ln
                        best = order
                if best > 0:
                    orders[b] = best
        return orders

    def _svr_refine(self, dbl, coefs_f, orders, n):
        """SVR refinement of each row's Levinson coefficients
        (``srla_tpu/encoder.py:486``). Returns (coefs, per-row work-buffer
        contents or None)."""
        return svr_refine_batch(dbl, coefs_f, orders, n,
                                self.p.num_svr_filter_learning_iteration,
                                self.p.bits_per_sample,
                                LPC_RIDGE_REGULARIZATION_PARAMETER,
                                self.preset.margin_list)

    def _compute_coefficients(self, blocks: np.ndarray, n: int,
                              offset_lshift: int, stale_state=None,
                              measure_only: bool = False):
        """blocks: (B, C, n) int32 raw samples. Returns (method (B,),
        params per output channel list[C] of _ChannelParams, bits (B,)).
        With `measure_only`, params is None: the per-channel merge (which
        copies residual-sized arrays) is skipped and only the
        decision-exact bit counts are produced (the -V span measurement)."""
        B, C, _ = blocks.shape
        work = _apply_lshift(blocks, offset_lshift)

        # Stack all channel variants ([M, S] + plain channels) into ONE
        # batched analysis call.
        variants = []
        if C >= 2:
            s = (work[:, 1] - work[:, 0]).astype(np.int32)
            m = (work[:, 0] + (s >> 1)).astype(np.int32)
            variants.extend([m, s])
        variants.extend(work[:, c] for c in range(C))
        if stale_state is not None:
            # Serial (B=1) flow threading the reference's persistent LPC
            # work-buffer state between channel variants (odd-length blocks).
            assert B == 1
            split = []
            state = stale_state
            for v in variants:
                params, raw = self._analyze_channel(v, n, stale_state=state,
                                                    want_state=True)
                if raw is not None:
                    # raw may run past the state (LTP's lags past a short
                    # work buffer, zero-extended in _analyze_channel).
                    ns = np.zeros(max(len(state), len(raw)))
                    ns[:len(state)] = state
                    ns[:len(raw)] = raw
                    state = ns
                split.append(params)
            self._last_state = state
        else:
            stack = np.ascontiguousarray(np.concatenate(variants, axis=0))
            all_params = self._analyze_channel(stack, n)
            split = [_slice_params(all_params, i * B, (i + 1) * B)
                     for i in range(len(variants))]
        if C >= 2:
            ms_params = split[:2]
            ch_params = split[2:]
        else:
            ms_params = None
            ch_params = split

        if C == 1:
            method = np.zeros(B, dtype=np.int32)
            bits = ch_params[0].code_length.copy()
            out_params = ch_params
        else:
            l0 = ch_params[0].code_length
            l1 = ch_params[1].code_length
            m0 = ms_params[0].code_length
            m1 = ms_params[1].code_length
            lens = np.stack([l0 + l1, m0 + m1, l0 + m1, l1 + m1])  # NONE,MS,LS,SR
            method = np.argmin(lens, axis=0).astype(np.int32)  # first min wins
            bits = lens[method, np.arange(B)]
            out_params = (None if measure_only else
                          [self._merge_params(ch_params, ms_params, method,
                                              c, B) for c in range(C)])
        bits = bits + 2
        bits = ((bits + 7) // 8) * 8
        return method, out_params, bits

    @staticmethod
    def _merge_params(ch_params, ms_params, method, c, B):
        """Select per-block between plain and MS variants for channel c."""
        if c >= 2:
            return ch_params[c]
        base = ch_params[c]
        # Per-block source table (vectorized): channel 0 takes the mid
        # variant under MS and the side variant under SR; channel 1 takes
        # the side variant under MS and LS; everything else stays plain.
        if c == 0:
            picks = [(method == int(ChProcessMethod.MS), ms_params[0]),
                     (method == int(ChProcessMethod.SR), ms_params[1])]
        else:
            picks = [((method == int(ChProcessMethod.MS))
                      | (method == int(ChProcessMethod.LS)), ms_params[1])]
        picks = [(m, src) for m, src in picks if m.any()]
        if not picks:
            return base
        fields = []
        for f in base.__dataclass_fields__:
            arr = np.copy(getattr(base, f))
            for mask, src in picks:
                arr[mask] = getattr(src, f)[mask]
            fields.append(arr)
        return _ChannelParams(*fields)

    def _compress_payload(self, params, method_b: int, n: int, b: int,
                          C: int) -> bytes:
        """Assemble one block's compress payload from batched params."""
        bps = self.p.bits_per_sample
        if native_decoder.available():
            ltp_o = self.p.ltp_order
            has_ltp = ltp_o > 0
            payload, bits = native_decoder.emit_payload(
                C, bps, n, method_b,
                [int(p.pre_prev[b]) for p in params],
                [int(p.pre_coef[b]) for p in params],
                [int(p.lpc_order[b]) for p in params],
                [int(p.lpc_rshift[b]) for p in params],
                [1 if p.use_sum_coef[b] else 0 for p in params],
                np.stack([p.lpc_coefs[b] for p in params]),
                ltp_o if has_ltp else 1,
                [int(p.ltp_period[b]) for p in params] if has_ltp else None,
                np.stack([p.ltp_coefs[b] for p in params]) if has_ltp
                else None,
                np.stack([p.residual[b, :n] for p in params]),
                [int(p.rice_type[b]) for p in params],
                [int(p.rice_porder[b]) for p in params],
                [p.rice_ks[b] for p in params])
            if payload is not None:
                return payload
        w = BitWriter()
        w.put(method_b, 2)
        for c in range(C):
            pp = params[c]
            w.put(int(sint32_to_uint32(np.int32(pp.pre_prev[b]))), bps + 1)
            w.put(int(sint32_to_uint32(np.int32(pp.pre_coef[b]))),
                  PREEMPHASIS_COEF_SHIFT + 1)
        for c in range(C):
            pp = params[c]
            o = int(pp.lpc_order[b])
            w.put(o, LPC_COEFFICIENT_ORDER_BITWIDTH)
            w.put(int(pp.lpc_rshift[b]), RSHIFT_LPC_COEFFICIENT_BITWIDTH)
            w.put(1 if pp.use_sum_coef[b] else 0, 1)
            if o > 0:
                coefs = pp.lpc_coefs[b, :o]
                uv = sint32_to_uint32(coefs)
                if not pp.use_sum_coef[b]:
                    w.put(self._param_cb.codes[uv], self._param_lens[uv])
                else:
                    w.put(int(self._param_cb.codes[uv[0]]),
                          int(self._param_lens[uv[0]]))
                    summed = (coefs[1:].astype(np.int64)
                              + coefs[:-1].astype(np.int64)).astype(np.int32)
                    suv = sint32_to_uint32(summed)
                    w.put(self._sum_cb.codes[suv], self._sum_lens[suv])
        for c in range(C):
            pp = params[c]
            per = int(pp.ltp_period[b])
            w.put(1 if per else 0, 1)
            if per:
                w.put((self.p.ltp_order - 1) // 2, LTP_ORDER_BITWIDTH)
                w.put(per - LTP_MIN_PERIOD, LTP_PERIOD_BITWIDTH)
                uv = sint32_to_uint32(pp.ltp_coefs[b])
                w.put(uv.astype(np.uint64),
                      np.full(self.p.ltp_order, LTP_COEFFICIENT_BITWIDTH))
        for c in range(C):
            pp = params[c]
            uvals = sint32_to_uint32(pp.residual[b, :n]).astype(np.int64)
            rice.emit_channel(w, uvals, n, int(pp.rice_type[b]),
                              int(pp.rice_porder[b]), pp.rice_ks[b])
        return w.getvalue()

    def _raw_payload(self, block: np.ndarray, n: int) -> bytes:
        """Channel-interleaved zigzag PCM at 8/16/24 bits BE."""
        bps = self.p.bits_per_sample
        uv = sint32_to_uint32(block[:, :n]).T  # (n, C)
        nbytes = bps // 8
        out = np.zeros((uv.shape[0], uv.shape[1], nbytes), dtype=np.uint8)
        for i in range(nbytes):
            out[:, :, i] = (uv >> (8 * (nbytes - 1 - i))).astype(np.uint8)
        return out.tobytes()

    def _report_progress(self, nsamples: int) -> None:
        """Advance the per-encode progress meter (parity: the reference's
        EncodeBlockCallback, srla_encoder.c:1780). Fired per encoded chunk —
        the batched pipeline has no per-block serial point."""
        cb = self._progress_cb
        if cb is None:
            return
        with self._lock:
            self._progress_done += nsamples
            done = self._progress_done
        try:
            cb(done)
        except Exception:
            self._progress_cb = None  # a broken callback never kills encode

    def encode_whole(self, pcm: np.ndarray, progress_callback=None) -> bytes:
        """pcm: (C, N) int32. Returns the complete .srl stream."""
        C, N = pcm.shape
        self._progress_cb = progress_callback
        self._progress_done = 0
        p = self.p
        offset_lshift = _compute_offset_lshift(pcm)
        header = StreamHeader(C, N, p.sampling_rate, p.bits_per_sample,
                              offset_lshift, p.max_num_samples_per_block,
                              p.preset)
        n = p.max_num_samples_per_block
        spans = [(off, min(n, N - off)) for off in range(0, N, n)]
        out = [encode_header(header)]
        if p.min_num_samples_per_block == p.max_num_samples_per_block:
            out.extend(self._encode_spans(pcm, spans, offset_lshift))
        else:
            out.extend(self._encode_variable(pcm, offset_lshift))
        self._check_repair_rate()
        return b"".join(out)

    def compute_block_size(self, pcm_block: np.ndarray,
                           offset_lshift: int = 0) -> int:
        """Byte size this block would encode to
        (SRLAEncoder_ComputeBlockSize)."""
        pcm_block = np.asarray(pcm_block, dtype=np.int32)
        n = pcm_block.shape[1]
        return self._measure_blocks(pcm_block, [0], n, offset_lshift)[0]

    def encode_optimal_partitioned_block(self, pcm_window: np.ndarray,
                                         offset_lshift: int = 0) -> bytes:
        """Optimal-partition encode of one lookahead window
        (SRLAEncoder_EncodeOptimalPartitionedBlock)."""
        pcm_window = np.asarray(pcm_window, dtype=np.int32)
        spans = self._variable_spans(pcm_window, offset_lshift,
                                     windows=[(0, pcm_window.shape[1])])
        return b"".join(self._encode_spans(pcm_window, spans,
                                           offset_lshift))

    # Boundary-flag (host repair) rate above which the encode is still
    # byte-exact but silently degrades toward host speed; make that mode
    # visible to operators instead of silent.
    _REPAIR_WARN_RATIO = 0.05

    def _check_repair_rate(self) -> None:
        dev = self.stats["device_blocks"] + self.stats["repaired_blocks"]
        rep = self.stats["repaired_blocks"]
        if dev == 0:
            return
        ratio = rep / dev
        self.stats["repair_ratio"] = round(ratio, 4)
        if ratio > self._REPAIR_WARN_RATIO:
            warnings.warn(
                f"srla_tpu_torch: {rep}/{dev} device-analyzed blocks "
                f"({100 * ratio:.1f}%) hit decision boundaries and were "
                "re-derived on the host; output is still byte-exact but "
                "encode throughput degrades toward host speed on this input.",
                RuntimeWarning, stacklevel=3)

    def _encode_spans(self, pcm: np.ndarray, spans, offset_lshift: int):
        """Encode a list of (offset, size) blocks on the host, batching by
        equal size."""
        C = pcm.shape[0]
        results: dict[int, bytes] = {}
        # Classify block types.
        types = {}
        for i, (off, size) in enumerate(spans):
            blk = pcm[:, off:off + size]
            if size <= self.preset.max_num_parameters:
                types[i] = BlockDataType.RAW
            elif not blk.any():
                types[i] = BlockDataType.SILENT
            else:
                types[i] = BlockDataType.COMPRESS

        # Batch compress blocks by size.
        by_size: dict[int, list[int]] = {}
        for i, (off, size) in enumerate(spans):
            if types[i] == BlockDataType.COMPRESS:
                by_size.setdefault(size, []).append(i)
        for size, idxs in by_size.items():
            if size % 2 == 1:
                # Odd-length blocks: the reference's Welch window leaves the
                # middle sample holding stale work-buffer content — emulate
                # the buffer state chain serially per block.
                for i in idxs:
                    state = self._incoming_state(pcm, spans, types, i,
                                                 offset_lshift)
                    blocks = pcm[:, spans[i][0]:spans[i][0] + size][None]
                    method, params, _bits = self._compute_coefficients(
                        blocks.astype(np.int32), size, offset_lshift,
                        stale_state=state)
                    results[i] = self._finish_block(pcm, spans, i, size,
                                                    params, int(method[0]),
                                                    0, C)
                continue
            results.update(self._encode_host_batch(pcm, spans, idxs, size,
                                                   offset_lshift))
        for i, (off, size) in enumerate(spans):
            if types[i] == BlockDataType.SILENT:
                results[i] = frame_block(BlockDataType.SILENT, size, b"")
            elif types[i] == BlockDataType.RAW:
                blk = pcm[:, off:off + size]
                results[i] = frame_block(
                    BlockDataType.RAW, size,
                    self._raw_payload(blk.astype(np.int32), size))
        return [results[i] for i in range(len(spans))]

    def _encode_host_batch(self, pcm, spans, idxs, size, offset_lshift):
        """Host-native batched encode of even-size blocks: one thread, or
        ``workers`` threads each taking every workers-th block
        (``srla_tpu/encoder.py:826-847``). Each shard is counted in
        ``stats["host_blocks"]`` and reported to the meter as the calling
        thread collects it."""
        n = self.workers
        if n > 1 and len(idxs) >= 2 * n:
            shards = [list(idxs[j::n]) for j in range(n)]
            results: dict[int, bytes] = {}
            with ThreadPoolExecutor(n) as ex:
                futs = [ex.submit(self._encode_host_shard, pcm, spans, sh,
                                  size, offset_lshift) for sh in shards]
                for sh, f in zip(shards, futs):
                    results.update(f.result())
                    self._count_host(len(sh), size)
            return results
        out = self._encode_host_shard(pcm, spans, idxs, size, offset_lshift)
        self._count_host(len(idxs), size)
        return out

    def _encode_host_shard(self, pcm, spans, idxs, size, offset_lshift):
        C = pcm.shape[0]
        blocks = np.stack([pcm[:, spans[i][0]:spans[i][0] + size]
                           for i in idxs])
        method, params, _bits = self._compute_coefficients(
            blocks.astype(np.int32), size, offset_lshift)
        return self._emit_host_batch(pcm, spans, idxs, size, method, params,
                                     C)

    def _count_host(self, count: int, size: int) -> None:
        """Count ``count`` host-encoded blocks of ``size`` samples."""
        with self._lock:
            self.stats["host_blocks"] += count
        self._report_progress(count * size)

    def _emit_host_batch(self, pcm, spans, idxs, size, method, params,
                         C) -> dict[int, bytes]:
        """Frame a host-analyzed batch. One native emit call covers every
        block (per-block emit_payload spent ~0.15 s in ctypes marshalling
        per 2 min of audio); rows it cannot represent (raw cheaper,
        coefficient outside the Huffman tables) fall back per block."""
        B = len(idxs)
        if not native_decoder.available():
            return {i: self._finish_block(pcm, spans, i, size, params,
                                          int(method[bi]), bi, C)
                    for bi, i in enumerate(idxs)}
        ltp_o = self.p.ltp_order
        stack = lambda f: np.stack([f(p) for p in params], axis=1)  # noqa
        framed, sizes = native_decoder.emit_blocks_batch(
            C, self.p.bits_per_sample, size, np.asarray(method)[:B],
            stack(lambda p: p.pre_prev), stack(lambda p: p.pre_coef),
            stack(lambda p: p.lpc_order), stack(lambda p: p.lpc_rshift),
            stack(lambda p: p.use_sum_coef.astype(np.int32)),
            np.stack([p.lpc_coefs for p in params], axis=1),
            ltp_o if ltp_o > 0 else 1,
            stack(lambda p: p.ltp_period) if ltp_o > 0 else None,
            np.stack([p.ltp_coefs for p in params], axis=1)
            if ltp_o > 0 else None,
            [p.residual[:, :size] for p in params],
            [p.rice_ks for p in params],
            stack(lambda p: p.rice_type), stack(lambda p: p.rice_porder))
        if framed is None:
            return {i: self._finish_block(pcm, spans, i, size, params,
                                          int(method[bi]), bi, C)
                    for bi, i in enumerate(idxs)}
        out: dict[int, bytes] = {}
        off = 0
        for bi, i in enumerate(idxs):
            sz = int(sizes[bi])
            if sz > 0:
                out[i] = framed[off:off + sz]
                off += sz
            elif sz == 0:
                blk = pcm[:, spans[i][0]:spans[i][0] + size]
                out[i] = frame_block(
                    BlockDataType.RAW, size,
                    self._raw_payload(blk.astype(np.int32), size))
            else:
                out[i] = self._finish_block(pcm, spans, i, size, params,
                                            int(method[bi]), bi, C)
        return out

    def _finish_block(self, pcm, spans, i, size, params, method_b, bi, C):
        """Assemble a compress payload, applying the raw-size fallback."""
        payload = self._compress_payload(params, method_b, size, bi, C)
        raw_bits = self.p.bits_per_sample * size * C
        if 8 * len(payload) >= raw_bits:
            blk = pcm[:, spans[i][0]:spans[i][0] + size]
            return frame_block(BlockDataType.RAW, size,
                               self._raw_payload(blk.astype(np.int32), size))
        return frame_block(BlockDataType.COMPRESS, size, payload)

    def _incoming_state(self, pcm, spans, types, i, offset_lshift,
                        first: int = 0):
        """LPC work-buffer contents entering span i: the raw IFFT buffer left
        by the previous compress-analyzed span's last channel variant (fresh
        arena memory — zeros — when there is none). Spans before ``first``
        (another file's, in a batched encode) are not looked at."""
        prev = None
        for j in range(i - 1, first - 1, -1):
            if types[j] == BlockDataType.COMPRESS:
                prev = j
                break
        if prev is None:
            return self._fresh_state()
        off, size = spans[prev]
        return self._state_from_block(pcm, off, size, offset_lshift)

    def _fresh_state(self) -> np.ndarray:
        # Fresh arena memory in the reference comes from mmap'd pages: zeros.
        return np.zeros(round_up_pow2(self.p.max_num_samples_per_block))

    def _state_from_block(self, pcm, off, size, offset_lshift) -> np.ndarray:
        """Work-buffer contents after analyzing the (even-length) block at
        (off, size): the raw IFFT buffer of its last channel variant."""
        state = self._fresh_state()
        work = pcm[:, off:off + size].astype(np.int32)
        if offset_lshift:
            work = (work >> offset_lshift).astype(np.int32)
        last = work[pcm.shape[0] - 1]
        _, raw = self._analyze_channel(last[None, :size], size,
                                       want_state=True)
        if raw is not None:
            state[:len(raw)] = raw
        return state

    # ------------------------------------------------------------------ #
    # Variable block sizes (-V): optimal partition per lookahead window   #
    # ------------------------------------------------------------------ #

    def _windows(self, N: int) -> list[tuple[int, int]]:
        """The lookahead windows (offset, length) of an N-sample stream."""
        la = self.p.num_lookahead_samples
        return [(off, min(la, N - off)) for off in range(0, N, la)]

    def _encode_variable(self, pcm: np.ndarray, offset_lshift: int):
        """Variable-block encode: the even windows' partition search
        (``_variable_spans``), one batched encode of the chosen spans, then
        the odd last window in the reference's serial order."""
        spans = self._variable_spans(pcm, offset_lshift)
        out = self._encode_spans(pcm, spans, offset_lshift)
        out += [framed for _, framed in self._encode_odd_window(
            pcm, spans, offset_lshift)]
        return out

    def _variable_spans(self, pcm: np.ndarray, offset_lshift: int,
                        measure_bits=None, tick=lambda name: None,
                        windows=None):
        """The chosen (offset, size) spans of the lookahead ``windows``
        ((offset, length) pairs; by default every even-length window of the
        stream), in stream order. Every candidate span of every window is
        measured, batched by size over all the windows into one
        ``_measure_blocks`` call per size (``measure_bits`` is its route for
        COMPRESS spans, the host's by default); then a Dijkstra per window
        over the measured byte sizes. ``tick`` is called with a step name
        after each host step."""
        if windows is None:
            windows = [w for w in self._windows(pcm.shape[1])
                       if w[1] % 2 == 0]
        adj_of: dict[int, np.ndarray] = {}
        jobs_by_size: dict[int, list] = {}
        for wo, span in windows:
            adj_of[wo], jobs = self._candidates(span)
            for key, (off, size) in jobs.items():
                jobs_by_size.setdefault(size, []).append((wo, key, wo + off))
        tick("partition search (host)")
        for size, entries in jobs_by_size.items():
            sizes = self._measure_blocks(pcm, [g for *_, g in entries],
                                         size, offset_lshift, measure_bits,
                                         tick)
            for (wo, key, _), sz in zip(entries, sizes):
                adj_of[wo][key] = float(sz)
        all_spans = []
        for wo, span in windows:
            parts = self._shortest_partition(adj_of[wo], span)
            all_spans += [(wo + off, size) for off, size in _spans_of(parts)]
        tick("partition search (host)")
        return all_spans

    def _candidates(self, span: int):
        """A window's edge matrix, all BIG (no edge), and its candidate
        spans {(i, j): (offset, size)} in the reference's (i, j) order:
        boundaries every min block, spans up to the max block, the last one
        clipped to the window."""
        dmin = self.p.min_num_samples_per_block
        dmax = self.p.max_num_samples_per_block
        num_nodes = (span + dmin - 1) // dmin + 1
        jobs = {}
        for i in range(num_nodes):
            off = i * dmin
            for j in range(i + 1, num_nodes):
                size = (j - i) * dmin
                if size <= dmax:
                    jobs[(i, j)] = (off, min(size, span - off))
        return np.full((num_nodes, num_nodes), _BIG), jobs

    def _shortest_partition(self, adj: np.ndarray, span: int) -> list[int]:
        """Block sizes of a window's cheapest partition, in order: the
        reference's Dijkstra from the first boundary to the last, the last
        block clipped to the window's ``span`` samples."""
        dmin = self.p.min_num_samples_per_block
        num_nodes = adj.shape[0]
        path = _dijkstra(adj, num_nodes, 0, num_nodes - 1, _BIG)
        parts_rev = []
        node = num_nodes - 1
        while node != 0:
            prev = path[node]
            off = prev * dmin
            parts_rev.append(min((node - prev) * dmin, span - off))
            node = prev
        return parts_rev[::-1]

    def _encode_odd_window(self, pcm: np.ndarray, spans, offset_lshift: int):
        """The odd-length last lookahead window, if the stream has one, in
        the reference's serial order: the work-buffer state left by the last
        COMPRESS span before it threads through the measurement of every
        candidate span in (i, j) order, then through the encode of the
        chosen ones. ``spans`` are the even windows' chosen spans. Returns
        [(size, framed block)] in stream order."""
        C, N = pcm.shape
        windows = self._windows(N)
        if not windows or windows[-1][1] % 2 == 0:
            return []
        wo, span = windows[-1]
        last_compress = None
        for o, s in reversed(spans):
            if s > self.preset.max_num_parameters and pcm[:, o:o + s].any():
                last_compress = (o, s)
                break
        state = (self._state_from_block(pcm, *last_compress, offset_lshift)
                 if last_compress else self._fresh_state())
        parts, state = self._search_partitions(
            pcm[:, wo:wo + span], span, offset_lshift, state)
        out = []
        for off, size in _spans_of(parts):
            blk = pcm[:, wo + off:wo + off + size]
            if size <= self.preset.max_num_parameters:
                framed = frame_block(
                    BlockDataType.RAW, size,
                    self._raw_payload(blk.astype(np.int32), size))
            elif not blk.any():
                framed = frame_block(BlockDataType.SILENT, size, b"")
            else:
                method, params, _bits = self._compute_coefficients(
                    blk[None].astype(np.int32), size, offset_lshift,
                    stale_state=state)
                state = self._last_state
                framed = self._finish_block(pcm, [(wo + off, size)], 0, size,
                                            params, int(method[0]), 0, C)
            out.append((size, framed))
        return out

    def _search_partitions(self, window: np.ndarray, span: int,
                           offset_lshift: int, state):
        """Shortest-path search over an odd-length window's candidate block
        boundaries; edge (i, j) costs the measured byte size of that span.
        The spans are measured serially in the reference's (i, j) order,
        threading the work-buffer ``state``; returns (the partition, the
        evolved state). Windows measured without a state chain go through
        ``_variable_spans``."""
        adj, jobs = self._candidates(span)
        C = window.shape[0]
        bps = self.p.bits_per_sample
        for key, (off, size) in jobs.items():  # reference (i, j) order
            blk = window[:, off:off + size]
            raw11 = 11 + (bps * size * C) // 8
            if size <= self.preset.max_num_parameters:
                adj[key] = float(raw11)
            elif not blk.any():
                adj[key] = 11.0
            else:
                _m, _p, bits = self._compute_coefficients(
                    blk[None].astype(np.int32), size, offset_lshift,
                    stale_state=state, measure_only=True)
                state = self._last_state
                self.stats["host_spans"] += 1
                nbits = int(bits[0])
                adj[key] = float(raw11 if nbits >= bps * size * C
                                 else 11 + nbits // 8)
        return self._shortest_partition(adj, span), state

    def _measure_blocks(self, window: np.ndarray, offsets, size: int,
                        offset_lshift: int, measure_bits=None,
                        tick=lambda name: None) -> list[int]:
        """Byte sizes of the equal-size spans of ``window`` at ``offsets``:
        RAW and SILENT spans by rule, COMPRESS spans from their measured
        bits (``measure_bits(window, offsets, size, lshift)``, the host's
        batched analysis by default), with the raw fallback."""
        C = window.shape[0]
        bps = self.p.bits_per_sample
        idxs_compress = []
        sizes = [0] * len(offsets)
        raw_size = 11 + (bps * size * C) // 8
        for k, off in enumerate(offsets):
            if size <= self.preset.max_num_parameters:
                sizes[k] = raw_size
            elif not window[:, off:off + size].any():
                sizes[k] = 11
            else:
                idxs_compress.append(k)
        tick("span typing (host)")
        if idxs_compress:
            bits = (measure_bits or self._measure_bits_host)(
                window, [offsets[k] for k in idxs_compress], size,
                offset_lshift)
            for bi, k in enumerate(idxs_compress):
                nbits = int(bits[bi])
                sizes[k] = (raw_size if nbits >= bps * size * C
                            else 11 + nbits // 8)
        return sizes

    def _measure_bits_host(self, window: np.ndarray, offsets, size: int,
                           offset_lshift: int) -> np.ndarray:
        """Rounded block bits of COMPRESS spans, by the batched host
        analysis (counted in ``stats["host_spans"]``)."""
        blocks = np.stack([window[:, o:o + size] for o in offsets])
        _m, _p, bits = self._compute_coefficients(
            blocks.astype(np.int32), size, offset_lshift, measure_only=True)
        self.stats["host_spans"] += len(offsets)
        return bits

    def _device_args(self, n: int):
        """The arguments of the device analysis of a group of n-sample
        blocks (``kernels.exact.encode_blocks``): the shapes, the LTP order,
        and SVR's iterations and the preset's margin list."""
        max_porder = 0
        while n % (1 << (max_porder + 1)) == 0 and max_porder < 10:
            max_porder += 1
        return dict(
            n=n, bps=self.p.bits_per_sample,
            max_params=self.preset.max_num_parameters,
            max_fixed=self.preset.lpc_order_tactics == OrderTactics.MAX_FIXED,
            fft_size=round_up_pow2(n), max_porder=max_porder,
            ltp_order=self.p.ltp_order,
            svr_iter=self.p.num_svr_filter_learning_iteration,
            margins=tuple(self.preset.margin_list))

    def _params_header_bits(self, small, method, B, bi, row_of, C):
        """Method + per-channel parameter fields (everything except the
        residual sections) for one block, from the fetched device arrays."""
        w = BitWriter()
        w.put(int(method[bi]), 2)
        bps = self.p.bits_per_sample
        rows = [row_of(bi, c) for c in range(C)]
        for r in rows:
            w.put(int(sint32_to_uint32(np.int32(small["pre_prev"][r]))),
                  bps + 1)
            w.put(int(sint32_to_uint32(np.int32(small["pre_coef"][r]))),
                  PREEMPHASIS_COEF_SHIFT + 1)
        plens = self._param_lens
        slens = self._sum_lens
        for r in rows:
            o = int(small["orders"][r])
            w.put(o, LPC_COEFFICIENT_ORDER_BITWIDTH)
            w.put(int(small["rshifts"][r]), RSHIFT_LPC_COEFFICIENT_BITWIDTH)
            if o == 0:
                w.put(0, 1)
                continue
            cfs = small["coefs"][r, :o].astype(np.int32)
            uv = sint32_to_uint32(cfs)
            coef_cost = int(plens[uv].sum())
            summed = (cfs[1:].astype(np.int64)
                      + cfs[:-1].astype(np.int64)).astype(np.int32)
            suv = sint32_to_uint32(summed)
            use_sum = False
            if (suv < 256).all():
                sum_cost = int(plens[int(uv[0])]) + int(slens[suv].sum())
                use_sum = (o == 1) or (sum_cost < coef_cost)
            w.put(1 if use_sum else 0, 1)
            if use_sum:
                w.put(int(self._param_cb.codes[uv[0]]),
                      int(self._param_lens[uv[0]]))
                w.put(self._sum_cb.codes[suv], self._sum_lens[suv])
            else:
                w.put(self._param_cb.codes[uv], self._param_lens[uv])
        ltp_o = self.p.ltp_order
        for r in rows:
            per = int(small["ltp_period"][r]) if ltp_o > 0 else 0
            w.put(1 if per else 0, 1)
            if per:
                w.put((ltp_o - 1) // 2, LTP_ORDER_BITWIDTH)
                w.put(per - LTP_MIN_PERIOD, LTP_PERIOD_BITWIDTH)
                uv_l = sint32_to_uint32(
                    np.asarray(small["ltp_coefs"][r], np.int32))
                w.put(uv_l.astype(np.uint64),
                      np.full(ltp_o, LTP_COEFFICIENT_BITWIDTH))
        return w


def _dijkstra(adj: np.ndarray, num_nodes: int, start: int, goal: int,
              big: float) -> list[int]:
    """Reference-faithful O(V^2) Dijkstra, with the reference's
    tie-breaking: the first unused node of least cost is taken, and a node's
    predecessor changes only on a strictly lower cost. Returns each node's
    predecessor (~0 where none).

    Parity: SRLAOptimalBlockPartitionCalculator_ApplyDijkstraMethod
    (srla_encoder.c:249-307); copied from ``srla_tpu/encoder.py:2044``.
    """
    used = [False] * num_nodes
    path = [~0] * num_nodes
    cost = [big] * num_nodes
    cost[start] = 0.0
    while True:
        mincost = big
        target = start
        for i in range(num_nodes):
            if not used[i] and mincost > cost[i]:
                mincost = cost[i]
                target = i
        if target == goal:
            break
        for i in range(num_nodes):
            via = adj[target, i] + cost[target]
            if cost[i] > via:
                cost[i] = via
                path[i] = target
        used[target] = True
    return path


def _spans_of(parts) -> list[tuple[int, int]]:
    """(offset, size) of consecutive blocks of the given sizes from 0."""
    offs = np.concatenate([[0], np.cumsum(parts, dtype=np.int64)])
    return [(int(o), int(s)) for o, s in zip(offs, parts)]


def _apply_lshift(blocks: np.ndarray, offset_lshift: int) -> np.ndarray:
    """Strip the stream's common trailing-zero bits."""
    if not offset_lshift:
        return blocks.astype(np.int32)
    return (blocks >> offset_lshift).astype(np.int32)


def _compute_offset_lshift(pcm: np.ndarray) -> int:
    orred = np.bitwise_or.reduce(
        np.bitwise_or.reduce(
            np.ascontiguousarray(pcm, np.int32).view(np.uint32), axis=1))
    mask = int(orred)
    if mask == 0:
        return 0
    return (mask & -mask).bit_length() - 1


def make_parameter(num_channels: int, bits_per_sample: int,
                   sampling_rate: int, preset: int = 4,
                   max_block: int = 4096, variable_divisions: int = 0,
                   lookahead_factor: int = 4, ltp_order: int = 0,
                   svr_iterations: int = 0) -> EncodeParameter:
    """The EncodeParameter of ``srla_tpu.encode`` for these arguments (its
    defaults: fixed blocks, -V 0)."""
    return EncodeParameter(
        num_channels=num_channels, bits_per_sample=bits_per_sample,
        sampling_rate=sampling_rate, preset=preset,
        max_num_samples_per_block=max_block,
        min_num_samples_per_block=max_block >> variable_divisions,
        num_lookahead_samples=lookahead_factor * max_block,
        ltp_order=ltp_order,
        num_svr_filter_learning_iteration=svr_iterations)


def encode(pcm: np.ndarray, bits_per_sample: int, sampling_rate: int,
           preset: int = 4, max_block: int = 4096, variable_divisions: int = 0,
           lookahead_factor: int = 4, ltp_order: int = 0,
           svr_iterations: int = 0, workers: int = 1) -> bytes:
    """One-shot exact host encode: the bytes of ``srla_tpu.encode(...,
    backend="exact")`` for the same arguments, its host batches split over
    ``workers`` threads."""
    pcm = np.asarray(pcm, dtype=np.int32)
    param = make_parameter(pcm.shape[0], bits_per_sample, sampling_rate,
                           preset, max_block, variable_divisions,
                           lookahead_factor, ltp_order, svr_iterations)
    return SRLAEncoder(param, workers).encode_whole(pcm)
