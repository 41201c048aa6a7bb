"""ctypes bridge to the port's native host library (builds on first use).

The port's own counterpart of ``srla_tpu/native_decoder.py``, with the
entries the port's host paths reach: the exact host analysis (pre-emphasis,
windowed autocorrelation, Levinson, order choice, LPC and LTP prediction,
Rice search, bit accounting), payload emission and block assembly, the
batched parameter-header parse, the Fletcher checksum, and the host decode
of a whole stream and of one block (``decode_stream``, ``decode_block``).
The C++ sources in ``native/`` are verbatim copies of ``srla_tpu/native/``.

The library is built with g++ into ``native/build/libsrla_torch_native.so``
under a name of its own and loaded ``RTLD_LOCAL``, so a process that loads
both this library and ``srla_tpu``'s reaches each through its own handle.
Where no compiler exists ``available()`` is False and callers take their
NumPy paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from functools import lru_cache

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
_SRCS = [os.path.join(_NATIVE_DIR, "srla_decoder.cpp"),
         os.path.join(_NATIVE_DIR, "srla_assemble.cpp"),
         os.path.join(_NATIVE_DIR, "srla_exact.cpp")]
SO_PATH = os.path.join(_NATIVE_DIR, "build", "libsrla_torch_native.so")
_LOCK = threading.Lock()


@lru_cache(maxsize=None)
def _load():
    os.makedirs(os.path.dirname(SO_PATH), exist_ok=True)
    with _LOCK:
        if (not os.path.exists(SO_PATH)
                or any(os.path.getmtime(SO_PATH) < os.path.getmtime(s)
                       for s in _SRCS)):
            cxx = os.environ.get("CXX", "g++")
            # -ffp-contract=off and NO global -mavx2/-mfma: the exact-path
            # f64 kernels must round every multiply/add separately (bit
            # parity with the host/reference), and g++ does not reliably
            # honor -ffp-contract=off in C++ once FMA is enabled globally.
            # Integer SIMD kernels opt in via per-function target("avx2")
            # attributes with runtime dispatch instead. The library is
            # written under a temporary name and renamed, so a concurrent
            # process never loads a half-written file.
            tmp = f"{SO_PATH}.{os.getpid()}.tmp"
            cmd = [cxx, "-O3", "-fwrapv", "-ffp-contract=off", "-fPIC",
                   "-shared", "-std=c++17", *_SRCS, "-o", tmp]
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, SO_PATH)
    lib = ctypes.CDLL(SO_PATH, mode=os.RTLD_LOCAL)
    lib.srla_decode_block.restype = ctypes.c_long
    lib.srla_decode_block.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p]
    lib.srla_decode_stream.restype = ctypes.c_long
    lib.srla_decode_stream.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p]
    lib.srla_parse_params_batch.restype = ctypes.c_long
    lib.srla_parse_params_batch.argtypes = (
        [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
         ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] * 2
        + [ctypes.c_int] + [ctypes.c_void_p] * 10)
    lib.srla_assemble_blocks.restype = ctypes.c_long
    lib.srla_assemble_blocks.argtypes = (
        [ctypes.c_long] + [ctypes.c_int] * 4
        + [ctypes.c_void_p] * 13
        + [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p]
        + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    lib.srla_autocorr_batch.restype = None
    lib.srla_autocorr_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int] + [ctypes.c_void_p] * 6
    lib.srla_rice_search_batch.restype = None
    lib.srla_rice_search_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.srla_lpc_predict_batch.restype = None
    lib.srla_lpc_predict_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.srla_ltp_analyze_batch.restype = None
    lib.srla_ltp_analyze_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.srla_ltp_predict_batch.restype = None
    lib.srla_ltp_predict_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.srla_rice_emit.restype = ctypes.c_long
    lib.srla_rice_emit.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
    lib.srla_window_autocorr_batch.restype = None
    lib.srla_window_autocorr_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
    lib.srla_levinson_batch.restype = None
    lib.srla_levinson_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.srla_preemph_coef_batch.restype = None
    lib.srla_preemph_coef_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_void_p]
    lib.srla_preemphasis_batch.restype = None
    lib.srla_preemphasis_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.srla_emit_payload.restype = ctypes.c_long
    lib.srla_emit_payload.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6 + [ctypes.c_int]
        + [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 6
        + [ctypes.c_void_p, ctypes.c_long])
    lib.srla_fletcher16.restype = ctypes.c_uint16
    lib.srla_fletcher16.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.srla_emit_blocks_batch.restype = ctypes.c_long
    lib.srla_emit_blocks_batch.argtypes = (
        [ctypes.c_long] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 7
        + [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 6
        + [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p])
    lib.srla_select_orders_batch.restype = None
    lib.srla_select_orders_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.srla_account_bits_batch.restype = None
    lib.srla_account_bits_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, OSError):
        return False


@lru_cache(maxsize=None)
def _luts():
    """Full-depth Huffman decode LUTs: (sym int16, len uint8) per codebook."""
    from .huffman import parameter_codebook, sum_parameter_codebook
    out = []
    for cb in (parameter_codebook(), sum_parameter_codebook()):
        K = cb.max_length
        sym = np.zeros(1 << K, dtype=np.int16)
        length = np.zeros(1 << K, dtype=np.uint8)
        for s in range(cb.num_symbols):
            L = int(cb.lengths[s])
            c = int(cb.codes[s])
            base = c << (K - L)
            sym[base:base + (1 << (K - L))] = s
            length[base:base + (1 << (K - L))] = L
        out.append((sym, length, K))
    return out


@lru_cache(maxsize=None)
def _fft_tables(fft_size: int):
    """Flattened twiddle/rotor tables (from Python math — platform libm)."""
    from .dsp.fft import _real_fft_rotors, _stage_twiddles
    out = {}
    for flag in (-1, 1):
        chunks = []
        for (w1r, w1i, w2r, w2i, w3r, w3i) in _stage_twiddles(fft_size // 2,
                                                              flag):
            chunks.append(np.stack(
                [w1r[:, 0], w1i[:, 0], w2r[:, 0], w2i[:, 0],
                 w3r[:, 0], w3i[:, 0]], axis=1).ravel())
        tw = (np.concatenate(chunks) if chunks else np.zeros(0))
        wr, wi = _real_fft_rotors(fft_size, flag)
        rot = np.stack([wr, wi], axis=1).ravel()
        out[flag] = (np.ascontiguousarray(tw), np.ascontiguousarray(rot))
    return out


def autocorr_batch(windowed: np.ndarray, fft_size: int, num_samples: int,
                   order: int, want_raw: bool = False):
    """Native exact FFT autocorrelation. windowed: (V, num_samples) f64."""
    lib = _load()
    V = windowed.shape[0]
    buf = np.zeros((V, fft_size))
    buf[:, :num_samples] = windowed
    tabs = _fft_tables(fft_size)
    tw_f, rot_f = tabs[-1]
    tw_i, rot_i = tabs[1]
    ac = np.empty((V, order))
    raw = np.empty((V, fft_size)) if want_raw else None

    def vp(a):
        return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None

    lib.srla_autocorr_batch(vp(buf), V, fft_size, num_samples, order,
                            vp(tw_f), vp(rot_f), vp(tw_i), vp(rot_i),
                            vp(ac), vp(raw))
    if want_raw:
        return ac, raw
    return ac


def lpc_predict_batch(data: np.ndarray, coefs: np.ndarray, orders: np.ndarray,
                      rshifts: np.ndarray) -> np.ndarray:
    """Native batched int32 LPC forward prediction (exact path)."""
    lib = _load()
    data = np.ascontiguousarray(data, np.int32)
    coefs = np.ascontiguousarray(coefs, np.int32)
    orders = np.ascontiguousarray(orders, np.int32)
    rshifts = np.ascontiguousarray(rshifts, np.int32)
    B, n = data.shape
    out = np.empty((B, n), np.int32)

    def vp(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    lib.srla_lpc_predict_batch(vp(data), B, n, vp(coefs), coefs.shape[1],
                               vp(orders), vp(rshifts), vp(out))
    return out


def ltp_analyze_batch(acbuf: np.ndarray, coef_order: int, min_period: int,
                      max_period: int, ridge: float):
    """Native batched pitch detect + LTP solve + 6-bit quantize.

    acbuf: (B, stride) f64 autocorrelation rows (lags 0.. plus zero pad).
    Returns (periods (B,) int32 with 0 = disabled, qcoefs (B, order) int32
    reversed)."""
    lib = _load()
    acbuf = np.ascontiguousarray(acbuf, np.float64)
    B, stride = acbuf.shape
    periods = np.zeros(B, np.int32)
    qcoefs = np.zeros((B, coef_order), np.int32)

    def vp(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    lib.srla_ltp_analyze_batch(vp(acbuf), B, stride, coef_order, min_period,
                               max_period, ridge, vp(periods), vp(qcoefs))
    return periods, qcoefs


def ltp_predict_batch(data: np.ndarray, coefs: np.ndarray, order: int,
                      periods: np.ndarray, rshift: int) -> np.ndarray:
    """Native batched long-term prediction (exact integer path)."""
    lib = _load()
    data = np.ascontiguousarray(data, np.int32)
    coefs = np.ascontiguousarray(coefs, np.int32)
    periods = np.ascontiguousarray(periods, np.int32)
    B, n = data.shape
    out = np.empty((B, n), np.int32)

    def vp(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    lib.srla_ltp_predict_batch(vp(data), B, n, vp(coefs), order,
                               vp(periods), rshift, vp(out))
    return out


def rice_emit(uvals: np.ndarray, n: int, code_type: int, porder: int,
              ks: np.ndarray):
    """Native residual-section emission -> (packed uint8 array, bit count).

    Returns (None, -1) on capacity overflow (caller falls back to Python)."""
    lib = _load()
    u = np.ascontiguousarray(uvals[:n], np.uint32)
    k = np.ascontiguousarray(ks, np.int32)
    if code_type != 2 and (k.size < (1 << porder) or u.size < n):
        return None, -1
    cap = 64 + n * 16
    out = np.empty(cap, np.uint8)
    bits = lib.srla_rice_emit(
        u.ctypes.data_as(ctypes.c_void_p), n, int(code_type), int(porder),
        k.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p), cap)
    if bits < 0:
        return None, -1
    return out[:(bits + 7) // 8], int(bits)


def window_autocorr_batch(sig: np.ndarray, n: int, norm: float,
                          win: np.ndarray, has_mid: bool, mid_value: float,
                          fft_size: int, order: int, want_raw: bool = False):
    """Fused normalize+window+FFT autocorrelation over int32 (V, n) signal."""
    lib = _load()
    sig = np.ascontiguousarray(sig[:, :n], np.int32)
    win = np.ascontiguousarray(win, np.float64)
    V = sig.shape[0]
    tabs = _fft_tables(fft_size)
    tw_f, rot_f = tabs[-1]
    tw_i, rot_i = tabs[1]
    ac = np.empty((V, order))
    raw = np.empty((V, fft_size)) if want_raw else None

    def vp(a):
        return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None

    lib.srla_window_autocorr_batch(vp(sig), V, n, float(norm), vp(win),
                                   1 if has_mid else 0, float(mid_value),
                                   fft_size, order, vp(tw_f), vp(rot_f),
                                   vp(tw_i), vp(rot_i), vp(ac), vp(raw))
    if want_raw:
        return ac, raw
    return ac


def levinson_batch(auto_corr: np.ndarray, max_order: int,
                   collect_orders: np.ndarray | None):
    """Native Levinson-Durbin -> (error_vars, parcor, collected|None)."""
    lib = _load()
    ac = np.ascontiguousarray(auto_corr, np.float64)
    B = ac.shape[0]
    # The collect path early-stops each block's recursion at its collect
    # order, leaving later ev/pc rows unwritten — zero them so the returned
    # arrays never expose uninitialized memory to a future consumer.
    alloc = np.zeros if collect_orders is not None else np.empty
    ev = alloc((B, max_order + 1))
    pc = alloc((B, max_order))
    col = np.empty((B, max_order)) if collect_orders is not None else None
    co = (np.ascontiguousarray(collect_orders, np.int32)
          if collect_orders is not None else None)

    def vp(a):
        return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None

    lib.srla_levinson_batch(vp(ac), B, max_order, vp(co), vp(ev), vp(pc),
                            vp(col))
    return ev, pc, col


def preemph_coef_batch(data: np.ndarray, n: int) -> np.ndarray:
    lib = _load()
    data = np.ascontiguousarray(data[:, :n], np.int32)
    B = data.shape[0]
    coef = np.empty(B, np.int32)
    lib.srla_preemph_coef_batch(data.ctypes.data_as(ctypes.c_void_p), B, n,
                                coef.ctypes.data_as(ctypes.c_void_p))
    return coef


def preemphasis_batch(data: np.ndarray, coef: np.ndarray,
                      prev: np.ndarray) -> np.ndarray:
    lib = _load()
    data = np.ascontiguousarray(data, np.int32)
    coef = np.ascontiguousarray(coef, np.int32)
    prev = np.ascontiguousarray(prev, np.int32)
    B, n = data.shape
    out = np.empty((B, n), np.int32)
    lib.srla_preemphasis_batch(data.ctypes.data_as(ctypes.c_void_p), B, n,
                               coef.ctypes.data_as(ctypes.c_void_p),
                               prev.ctypes.data_as(ctypes.c_void_p),
                               out.ctypes.data_as(ctypes.c_void_p))
    return out


def emit_payload(C, bps, n, method, pre_prev, pre_coef, orders, rshifts,
                 use_sum, coefs, ltp_order, ltp_periods, ltp_coefs,
                 residuals, rice_ct, rice_po, rice_ks):
    """Native whole-block COMPRESS payload emission -> (bytes, nbits).

    Returns (None, code<0) on overflow (-1: raw is cheaper) or out-of-table
    coefficients (-2: caller uses the Python path)."""
    lib = _load()
    (pcodes, plens), (scodes, slens) = _code_tables()

    def ci(a):
        return np.ascontiguousarray(a, np.int32)

    def vp(a):
        return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None

    coefs = ci(coefs)
    residuals = ci(residuals)
    ks = np.zeros((C, 1024), np.int16)
    for c in range(C):
        row = np.asarray(rice_ks[c]).ravel()
        ks[c, :min(1024, row.size)] = row[:1024]
    cap = (bps * n * C) // 8 + 64
    out = np.empty(cap, np.uint8)
    args = [C, bps, n, int(method), vp(ci(pre_prev)), vp(ci(pre_coef)),
            vp(ci(orders)), vp(ci(rshifts)), vp(ci(use_sum)), vp(coefs),
            coefs.shape[1], vp(pcodes), vp(plens), vp(scodes), vp(slens),
            int(ltp_order),
            vp(ci(ltp_periods)) if ltp_periods is not None else None,
            vp(ci(ltp_coefs)) if ltp_coefs is not None else None,
            vp(residuals), vp(ci(rice_ct)), vp(ci(rice_po)), vp(ks),
            vp(out), cap]
    bits = lib.srla_emit_payload(*args)
    if bits < 0:
        return None, int(bits)
    return out[:(bits + 7) // 8].tobytes(), int(bits)


def emit_blocks_batch(C, bps, n, method, pre_prev, pre_coef, orders,
                      rshifts, use_sum, coefs, ltp_order, ltp_periods,
                      ltp_coefs, res_ch, ks_ch, rice_ct, rice_po):
    """Native batched COMPRESS block emission + framing -> (bytes, sizes).

    One call for a whole equal-size block batch (the per-block ctypes
    marshalling of emit_payload measured ~0.15 s per 1292-block encode).
    method (B,); per-channel params (B, C) int32; coefs (B, C, maxorder);
    res_ch / ks_ch: C per-channel arrays (B, n) int32 / (B, >=nparts) ks.
    sizes[b]: framed bytes at the running offset, 0 = raw is cheaper
    (caller emits a RAW block), -2 = coefficient outside the Huffman
    tables (caller uses its Python path)."""
    lib = _load()
    (pcodes, plens), (scodes, slens) = _code_tables()
    B = len(method)

    def ci(a):
        return np.ascontiguousarray(a, np.int32)

    def vp(a):
        return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None

    coefs = ci(coefs)
    res_ch = [ci(r) for r in res_ch]
    ks16 = []
    for c in range(C):
        k = np.zeros((B, 1024), np.int16)
        src = np.asarray(ks_ch[c])
        k[:, :min(1024, src.shape[1])] = src[:, :1024]
        ks16.append(k)
    res_ptrs = (ctypes.c_void_p * C)(*[vp(r).value for r in res_ch])
    ks_ptrs = (ctypes.c_void_p * C)(*[vp(k).value for k in ks16])
    cap = B * ((bps * n * C) // 8 + 80)
    out = np.empty(cap, np.uint8)
    sizes = np.empty(B, np.int64)
    total = lib.srla_emit_blocks_batch(
        B, C, bps, n, coefs.shape[2], vp(ci(method)), vp(ci(pre_prev)),
        vp(ci(pre_coef)), vp(ci(orders)), vp(ci(rshifts)), vp(ci(use_sum)),
        vp(coefs), vp(pcodes), vp(plens), vp(scodes), vp(slens),
        int(ltp_order),
        vp(ci(ltp_periods)) if ltp_periods is not None else None,
        vp(ci(ltp_coefs)) if ltp_coefs is not None else None,
        res_ptrs, ks_ptrs, vp(ci(rice_ct)), vp(ci(rice_po)),
        vp(out), cap, vp(sizes))
    if total < 0:
        return None, None
    return out[:total].tobytes(), sizes


def rice_search_batch(residuals: np.ndarray, n: int, max_porder: int):
    """Native exact Rice partition search over (V, n) int32 residuals."""
    lib = _load()
    residuals = np.ascontiguousarray(residuals, dtype=np.int32)
    V = residuals.shape[0]
    ct = np.empty(V, np.int32)
    po = np.empty(V, np.int32)
    bits = np.empty(V, np.int64)
    ks = np.empty((V, 1024), np.int16)

    def vp(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    lib.srla_rice_search_batch(vp(residuals), V, n, max_porder,
                               vp(ct), vp(po), vp(bits), vp(ks))
    return ct, po, bits, ks


@lru_cache(maxsize=None)
def _code_tables():
    from .huffman import parameter_codebook, sum_parameter_codebook
    out = []
    for cb in (parameter_codebook(), sum_parameter_codebook()):
        out.append((cb.codes.astype(np.uint32),
                    cb.lengths.astype(np.uint8)))
    return out


def assemble_blocks(method, pre_prev, pre_coef, orders, rshifts, coefs,
                    sections: bytes, sec_off_bytes, sec_bits,
                    num_channels: int, bits_per_sample: int,
                    num_samples: int, ltp_order: int = 0,
                    ltp_periods=None, ltp_coefs=None):
    """Assemble framed COMPRESS blocks natively.

    method (B,); per-channel params shaped (B, C); coefs (B, C, maxorder);
    sections: concatenated packed residual-section bytes with per-(b,c) byte
    offsets and exact bit counts. Returns (buffer bytes, sizes (B,)) where
    size 0 marks a block that must be re-emitted as RAW by the caller.
    """
    lib = _load()
    (pcodes, plens), (scodes, slens) = _code_tables()
    B = len(method)
    C = num_channels
    maxorder = coefs.shape[2]
    method = np.ascontiguousarray(method, np.int32)
    pre_prev = np.ascontiguousarray(pre_prev, np.int32)
    pre_coef = np.ascontiguousarray(pre_coef, np.int32)
    orders = np.ascontiguousarray(orders, np.int32)
    rshifts = np.ascontiguousarray(rshifts, np.int32)
    coefs = np.ascontiguousarray(coefs, np.int32)
    sec_off = np.ascontiguousarray(sec_off_bytes, np.int64)
    sec_bits = np.ascontiguousarray(sec_bits, np.int64)
    cap = int(B * (11 + 64 * C)
              + (bits_per_sample + 2) * num_samples * C * B // 8)
    out = np.empty(cap, np.uint8)
    sizes = np.zeros(B, np.int64)

    def vp(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    if ltp_periods is not None:
        ltp_periods = np.ascontiguousarray(ltp_periods, np.int32)
        ltp_coefs = np.ascontiguousarray(ltp_coefs, np.int32)
    total = lib.srla_assemble_blocks(
        B, C, bits_per_sample, num_samples, maxorder,
        vp(method), vp(pre_prev), vp(pre_coef), vp(orders), vp(rshifts),
        vp(coefs), vp(pcodes), vp(plens), vp(scodes), vp(slens),
        ctypes.cast(ctypes.c_char_p(sections), ctypes.c_void_p),
        vp(sec_off), vp(sec_bits),
        vp(out), cap, vp(sizes),
        max(ltp_order, 1),
        vp(ltp_periods) if ltp_periods is not None else None,
        vp(ltp_coefs) if ltp_coefs is not None else None)
    if total < 0:
        raise ValueError("native assembler: output capacity exceeded")
    return out[:total].tobytes(), sizes


def _lut_args() -> list:
    """The two Huffman decode LUTs as the C entries take them."""
    (psym, plen, pk), (ssym, slen, sk) = _luts()
    vp = ctypes.c_void_p
    return [psym.ctypes.data_as(vp), plen.ctypes.data_as(vp), pk,
            ssym.ctypes.data_as(vp), slen.ctypes.data_as(vp), sk]


def decode_stream(body: bytes, num_channels: int, bits_per_sample: int,
                  num_samples: int, offset_lshift: int,
                  check_checksum: bool = True) -> np.ndarray:
    """Decode a whole .srl stream body (after the 30-byte header) on the
    host -> (C, N) int32 PCM (``srla_tpu/native_decoder.py:538``). A
    checksum mismatch or insufficient data raises ValueError; a stream cut
    cleanly at a block boundary leaves the missing tail silent."""
    out = np.empty((num_channels, num_samples), dtype=np.int32)
    r = _load().srla_decode_stream(
        body, len(body), num_channels, bits_per_sample, num_samples,
        offset_lshift, 1 if check_checksum else 0, *_lut_args(),
        out.ctypes.data_as(ctypes.c_void_p))
    if r == -2:
        raise ValueError("data corruption detected (checksum mismatch)")
    if r < 0:
        raise ValueError("insufficient data")
    out[:, r:] = 0
    return out


def decode_block(payload: bytes, num_channels: int, bits_per_sample: int,
                 num_samples: int, offset_lshift: int) -> np.ndarray:
    """Decode one COMPRESS payload on the host -> (C, n) int32 PCM
    (``srla_tpu/native_decoder.py:603``); a malformed payload raises
    ValueError."""
    out = np.empty((num_channels, num_samples), dtype=np.int32)
    r = _load().srla_decode_block(
        payload, len(payload), num_channels, bits_per_sample, num_samples,
        offset_lshift, *_lut_args(), out.ctypes.data_as(ctypes.c_void_p))
    if r < 0:
        raise ValueError("native decoder: malformed block payload")
    return out


def parse_params_batch(data: bytes, payload_off: np.ndarray,
                       payload_size: np.ndarray, num_channels: int,
                       bits_per_sample: int, max_coef: int = 256):
    """Parse the parameter headers of many COMPRESS payloads in one native
    call. Returns a dict of arrays (B[, C][, .]) plus 'start_bits' (B,), the
    bit offset of channel 0's residual section within each payload."""
    lib = _load()
    B = len(payload_off)
    C = num_channels
    off = np.ascontiguousarray(payload_off, np.int64)
    psz = np.ascontiguousarray(payload_size, np.int64)
    out = dict(
        method=np.zeros(B, np.int32),
        pre_prev=np.zeros((B, C), np.int32),
        pre_coef=np.zeros((B, C), np.int32),
        orders=np.zeros((B, C), np.int32),
        rshifts=np.zeros((B, C), np.int32),
        coefs=np.zeros((B, C, max_coef), np.int32),
        ltp_orders=np.zeros((B, C), np.int32),
        ltp_periods=np.zeros((B, C), np.int32),
        ltp_coefs=np.zeros((B, C, 8), np.int32),
        start_bits=np.zeros(B, np.int64),
    )
    r = lib.srla_parse_params_batch(
        data, off.ctypes.data_as(ctypes.c_void_p),
        psz.ctypes.data_as(ctypes.c_void_p), B, C, bits_per_sample,
        *_lut_args(), max_coef,
        *(out[k].ctypes.data_as(ctypes.c_void_p) for k in
          ("method", "pre_prev", "pre_coef", "orders", "rshifts", "coefs",
           "ltp_orders", "ltp_periods", "ltp_coefs", "start_bits")))
    if r < 0:
        raise ValueError(f"native parse: malformed payload (block {-r - 2})")
    return out


def select_orders_batch(error_vars: np.ndarray, n: int, bps: int,
                        max_params: int, coef_bitwidth: int) -> np.ndarray:
    """Native exact LPC order selection (host_encoder._select_order twin).

    Plain libm log/sqrt IS the scalar tie-repair chain, so this single pass
    equals the Python coarse-argmin-plus-repair result on every input."""
    lib = _load()
    ev = np.ascontiguousarray(error_vars, np.float64)
    B = ev.shape[0]
    assert ev.shape[1] == max_params + 1
    orders = np.empty(B, np.int32)

    def vp(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    lib.srla_select_orders_batch(vp(ev), B, max_params, n, bps,
                                 coef_bitwidth, vp(orders))
    return orders


def account_bits_batch(rice_bits: np.ndarray, orders: np.ndarray,
                       int_coefs: np.ndarray, ltp_period: np.ndarray,
                       ltp_bits: int, plens: np.ndarray, slens: np.ndarray,
                       fixed_bits: int):
    """Native exact per-channel bit accounting (host_encoder._account_bits
    twin). Returns (code_length int64 (B,), use_sum bool (B,))."""
    lib = _load()
    rb = np.ascontiguousarray(rice_bits, np.int64)
    orders = np.ascontiguousarray(orders, np.int32)
    coefs = np.ascontiguousarray(int_coefs, np.int32)
    lp = np.ascontiguousarray(ltp_period, np.int32)
    pl = np.ascontiguousarray(plens, np.int64)
    sl = np.ascontiguousarray(slens, np.int64)
    B, M = coefs.shape
    code_length = np.empty(B, np.int64)
    use_sum = np.empty(B, np.uint8)

    def vp(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    lib.srla_account_bits_batch(vp(rb), vp(orders), vp(coefs), B, M,
                                vp(lp), int(ltp_bits), vp(pl), vp(sl),
                                int(fixed_bits), vp(code_length),
                                vp(use_sum))
    return code_length, use_sum.astype(bool)
