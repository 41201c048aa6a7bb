"""Device decode of one equal-size block group: stream -> residuals -> PCM.

Twin of ``srla_tpu.kernels.decode2`` (``decode_blocks_paged`` and the
synthesis around the LPC kernel). The entropy decode is kernel K2
(``rice_decode``), the LPC recurrence and the de-emphasis are kernel K1
(``lpc_scan``), the long-term-prediction synthesis is kernel K9
(``ltp.ltp_synth``); coefficient alignment, the stereo inverse and the
offset shift are PyTorch ops. Integer semantics are
those of the JAX package: every sum wraps mod 2^32, computed here in int64
and wrapped explicitly (``wrap32``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import MAX_LTP_ORDER
from .lpc import lpc_scan, wrap32
from .ltp import ltp_synth
from .rice_decode import rice_decode


def align_coefs(coefs: torch.Tensor, orders: torch.Tensor,
                M: int) -> torch.Tensor:
    """Right-align per-row coefficients (R, >= M) for the window dot: column
    j multiplies the output M - j steps back (``decode2._align_coefs``)."""
    j = torch.arange(M, device=coefs.device)[None, :]
    cols = j - (M - orders.long())[:, None]
    picked = torch.gather(coefs[:, :M], 1, cols.clamp(0, M - 1))
    return torch.where(cols >= 0, picked, 0).to(torch.int32).contiguous()


def deemph_scan(x: torch.Tensor, dcoef: torch.Tensor,
                dprev: torch.Tensor) -> torch.Tensor:
    """De-emphasis ``y[s] = x[s] + ((y[s-1] * dcoef) >> 4)`` from
    ``y[-1] = dprev`` (``decode2._deemph_scan``): kernel K1 with every row
    at order 0, which passes x through to the fused de-emphasis."""
    R, n = x.shape
    z = torch.zeros(R, dtype=torch.int32, device=x.device)
    return lpc_scan(x.contiguous(), z[:, None].contiguous(), z, z, n, 1,
                    dcoef=dcoef.contiguous(), dprev=dprev.contiguous())


def synthesize(res, orders, rshifts, coefs, ltp_orders, ltp_periods,
               ltp_coefs, pre_coef, pre_prev, methods, lshift: int, *,
               n: int, C: int, M: int, has_ltp: bool) -> torch.Tensor:
    """LPC recurrence (+ de-emphasis), optional LTP synthesis (K9), stereo
    inverse and offset shift (``decode2._synthesize``). res (B, C, n)
    int32; per-block parameters (B, C[, .]) int32; methods (B,). Returns
    (B, C, n) int32."""
    B = res.shape[0]
    R = B * C
    resR = res.reshape(R, n).contiguous()
    ordR = orders.reshape(R).contiguous()
    rshR = rshifts.reshape(R).contiguous()
    aligned = align_coefs(coefs.reshape(R, -1), ordR, M)
    dcoef = pre_coef.reshape(R).contiguous()
    dprev = pre_prev.reshape(R).contiguous()
    if has_ltp:
        v = lpc_scan(resR, aligned, ordR, rshR, n, M)
        y = ltp_synth(v, ltp_orders.reshape(R).contiguous(),
                      ltp_periods.reshape(R).contiguous(),
                      ltp_coefs.reshape(R, -1).contiguous(), n)
        y = deemph_scan(y, dcoef, dprev)
    else:
        y = lpc_scan(resR, aligned, ordR, rshR, n, M, dcoef=dcoef,
                     dprev=dprev)
    out = y.reshape(B, C, n).long()
    if C >= 2:
        m = methods.long()[:, None]
        o0, o1 = out[:, 0], out[:, 1]
        c0_ms = wrap32(o0 - (o1 >> 1))
        c0 = torch.where(m == 1, c0_ms, o0)
        c1 = torch.where(m == 1, wrap32(o1 + c0_ms), o1)
        c1 = torch.where(m == 2, wrap32(o1 + o0), c1)
        c0 = torch.where(m == 3, wrap32(o1 - o0), c0)
        out = torch.cat([c0[:, None], c1[:, None], out[:, 2:]], dim=1)
    return wrap32(out << lshift).to(torch.int32)


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

    def col(name, shape=()):
        o, w = cols[name]
        v = meta[:, o:o + w]
        return (v.reshape((B,) + shape) if shape else v[:, 0]).contiguous()

    res = rice_decode(words, col("word_start"), col("bit_rem"), n, C, W)
    return synthesize(res, col("orders", (C,)), col("rshifts", (C,)),
                      col("coefs", (C, M)), col("ltp_orders", (C,)),
                      col("ltp_periods", (C,)),
                      col("ltp_coefs", (C, MAX_LTP_ORDER)),
                      col("pre_coef", (C,)), col("pre_prev", (C,)),
                      col("method"), lshift, n=n, C=C, M=M, has_ltp=has_ltp)
