"""Device decode of one equal-size block group: stream -> residuals -> PCM.

Twin of ``srla_tpu.kernels.decode2`` (``decode_blocks_paged`` and the
synthesis around the LPC kernel). The entropy decode is kernel K2
(``rice_decode``), the LPC recurrence and the de-emphasis are kernel K1
(``lpc.lpc_scan_coefs``, which aligns the parsed coefficients as it loads
them), the long-term-prediction synthesis is kernel K9 (``ltp.ltp_synth``),
the stereo inverse and the offset shift are kernel K19 (``synth_tail``,
``csrc/synth_tail.cu``), in place on K1's output. Integer semantics are
those of the JAX package: every sum wraps mod 2^32 (the plain versions
compute in int64 and wrap explicitly, ``wrap32``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import MAX_LTP_ORDER
from . import build
from .lpc import (align_coefs, lpc_scan_coefs,  # noqa: F401 (re-exported)
                  wrap32)
from .ltp import ltp_synth
from .rice_decode import rice_decode


_ZEROS: dict = {}


def _zeros(R: int, device) -> torch.Tensor:
    """R int32 zeros on ``device``, sliced from one buffer a device that
    grows as needed (zeroed once, not at every decode group)."""
    z = _ZEROS.get(str(device))
    if z is None or z.numel() < R:
        z = torch.zeros(max(R, 4096), dtype=torch.int32, device=device)
        _ZEROS[str(device)] = z
    return z[:R]


def deemph_scan(x: torch.Tensor, dcoef: torch.Tensor,
                dprev: torch.Tensor) -> torch.Tensor:
    """De-emphasis ``y[s] = x[s] + ((y[s-1] * dcoef) >> 4)`` from
    ``y[-1] = dprev`` (``decode2._deemph_scan``): kernel K1 with every row
    at order 0, which passes x through to the fused de-emphasis."""
    R, n = x.shape
    z = _zeros(R, x.device)
    return lpc_scan_coefs(x.contiguous(), z[:, None], z, z, n, 1,
                          dcoef=dcoef.contiguous(), dprev=dprev.contiguous())


def synth_tail_plain(y: torch.Tensor, methods: torch.Tensor,
                     lshift: int) -> torch.Tensor:
    """Plain PyTorch version of K19 (``decode2._synthesize`` :529-538): the
    stereo inverse of channels 0 and 1 of each block by its method, then
    every channel shifted left by lshift, in int64 wrapped to int32. y
    (B, C, n) int32, methods (B,). Returns a new (B, C, n) int32."""
    out = y.long()
    if y.shape[1] >= 2:
        m = methods.long()[:, None]
        o0, o1 = out[:, 0], out[:, 1]
        c0_ms = wrap32(o0 - (o1 >> 1))
        c0 = torch.where(m == 1, c0_ms, o0)
        c1 = torch.where(m == 1, wrap32(o1 + c0_ms), o1)
        c1 = torch.where(m == 2, wrap32(o1 + o0), c1)
        c0 = torch.where(m == 3, wrap32(o1 - o0), c0)
        out = torch.cat([c0[:, None], c1[:, None], out[:, 2:]], dim=1)
    return wrap32(out << lshift).to(torch.int32)


def synth_tail(y: torch.Tensor, methods: torch.Tensor, lshift: int,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """K19: the stereo inverse and offset shift of a decoded group. y
    (B, C, n) int32, contiguous; methods (B,) int32 at any stride (a
    column of the packed parameters); 0 <= lshift < 32. Writes into out
    (B, C, n) int32 contiguous, or into y itself when out is None, and
    returns it.

    CUDA tensors go through the kernel (``synth_tail.launches`` counts its
    launches; a mono group at lshift 0 has nothing to change and launches
    nothing); CPU tensors go through ``synth_tail_plain``."""
    if not 0 <= lshift < 32:
        raise ValueError(f"synth_tail: lshift must be in 0..31, got {lshift}")
    dst = y if out is None else out
    if y.dim() != 3 or methods.dim() != 1 or methods.shape[0] != y.shape[0]:
        raise ValueError(f"synth_tail: y must be (B, C, n) and methods (B,), "
                         f"got {tuple(y.shape)} and {tuple(methods.shape)}")
    if y.device.type == "cpu":
        return dst.copy_(synth_tail_plain(y, methods, lshift))
    if y.device.type != "cuda":
        raise ValueError(f"synth_tail: no kernel for device {y.device}")
    B, C, n = y.shape
    build.check_arg("synth_tail", "y", y, (B, C, n), y.device)
    build.check_arg("synth_tail", "out", dst, (B, C, n), y.device)
    if methods.dtype != torch.int32 or methods.device != y.device:
        raise ValueError(f"synth_tail: methods must be int32 on {y.device}, "
                         f"got {methods.dtype} on {methods.device}")
    if B == 0 or n == 0 or (C == 1 and lshift == 0 and out is None):
        return dst
    lib = build.load("synth_tail")
    fn = lib.srla_synth_tail
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(y.device).cuda_stream
    err = fn(y.data_ptr(), dst.data_ptr(), methods.data_ptr(),
             methods.stride(0), B, C, n, lshift, stream)
    build.check(err, "synth_tail")
    synth_tail.launches += 1
    return dst


synth_tail.launches = 0


def synthesize(res, orders, rshifts, coefs, ltp_orders, ltp_periods,
               ltp_coefs, pre_coef, pre_prev, methods, lshift: int, *,
               n: int, C: int, M: int, has_ltp: bool) -> torch.Tensor:
    """LPC recurrence (+ de-emphasis) by K1 on the parsed coefficients,
    optional LTP synthesis (K9, then K1's order-0 de-emphasis), the stereo
    inverse and offset shift by K19 in place (``decode2._synthesize``).
    res (B, C, n) int32; per-block parameters (B, C[, .]) int32, coefs
    (B, C, >= M) at any block and channel stride; methods (B,) at any
    stride. Returns (B, C, n) int32."""
    B = res.shape[0]
    R = B * C
    resR = res.reshape(R, n).contiguous()
    ordR = orders.reshape(R).contiguous()
    rshR = rshifts.reshape(R).contiguous()
    dcoef = pre_coef.reshape(R).contiguous()
    dprev = pre_prev.reshape(R).contiguous()
    if has_ltp:
        v = lpc_scan_coefs(resR, coefs, ordR, rshR, n, M)
        y = ltp_synth(v, ltp_orders.reshape(R).contiguous(),
                      ltp_periods.reshape(R).contiguous(),
                      ltp_coefs.reshape(R, -1).contiguous(), n)
        y = deemph_scan(y, dcoef, dprev)
    else:
        y = lpc_scan_coefs(resR, coefs, ordR, rshR, n, M, dcoef=dcoef,
                           dprev=dprev)
    return synth_tail(y.reshape(B, C, n), methods, lshift)


def meta_cols(C: int, M: int, L: int):
    """Column layout of the packed per-block parameters
    (``decode2._meta_cols``): name -> (offset, width), and the width."""
    cols = {}
    o = 0
    for name, width in (("word_start", 1), ("bit_rem", 1), ("method", 1),
                        ("orders", C), ("rshifts", C), ("coefs", C * M),
                        ("ltp_orders", C), ("ltp_periods", C),
                        ("ltp_coefs", C * L), ("pre_coef", C),
                        ("pre_prev", C)):
        cols[name] = (o, width)
        o += width
    return cols, o


def pack_meta(pp: dict, sel, word_start, bit_rem, Bp: int, C: int, M: int,
              L: int) -> np.ndarray:
    """Pack the parsed parameters of blocks ``sel`` into one (Bp, K) int32
    host array (``decode2.pack_meta``), so they cross to the device in one
    copy."""
    cols, K = meta_cols(C, M, L)
    meta = np.zeros((Bp, K), np.int32)
    B = len(sel)

    def put(name, arr):
        o, w = cols[name]
        meta[:B, o:o + w] = arr.reshape(B, w)
    put("word_start", word_start)
    put("bit_rem", bit_rem)
    put("method", pp["method"][sel])
    put("orders", pp["orders"][sel])
    put("rshifts", pp["rshifts"][sel])
    put("coefs", pp["coefs"][sel][:, :, :M])
    put("ltp_orders", pp["ltp_orders"][sel])
    put("ltp_periods", pp["ltp_periods"][sel])
    put("ltp_coefs", pp["ltp_coefs"][sel][:, :, :L])
    put("pre_coef", pp["pre_coef"][sel])
    put("pre_prev", pp["pre_prev"][sel])
    return meta


def decode_blocks(words: torch.Tensor, meta: torch.Tensor, lshift: int, *,
                  n: int, C: int, M: int, W: int,
                  has_ltp: bool) -> torch.Tensor:
    """Decode one equal-size block group from the resident stream
    (``decode2.decode_blocks_paged``).

    words: (NW,) int32, the .srl bytes as a little-endian word view on the
    device; meta: (B, K) int32 from ``pack_meta`` on the same device; W: the
    group's largest payload in words. Returns PCM (B, C, n) int32 with the
    stereo inverse and offset shift applied.
    """
    B = meta.shape[0]
    cols, _ = meta_cols(C, M, MAX_LTP_ORDER)

    def col(name, shape=(), strided=False):
        o, w = cols[name]
        v = meta[:, o:o + w]
        v = v.view((B,) + shape) if shape else v[:, 0]
        return v if strided else v.contiguous()

    res = rice_decode(words, col("word_start"), col("bit_rem"), n, C, W)
    # K1 reads the coefficients and K19 the methods where they lie in meta.
    return synthesize(res, col("orders", (C,)), col("rshifts", (C,)),
                      col("coefs", (C, M), strided=True),
                      col("ltp_orders", (C,)), col("ltp_periods", (C,)),
                      col("ltp_coefs", (C, MAX_LTP_ORDER)),
                      col("pre_coef", (C,)), col("pre_prev", (C,)),
                      col("method", strided=True), lshift, n=n, C=C, M=M,
                      has_ltp=has_ltp)
