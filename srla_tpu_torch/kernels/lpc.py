"""K1: batched LPC synthesis recurrence (+ fused de-emphasis).

``lpc_scan`` is the twin of ``srla_tpu.kernels.decode2._lpc_scan`` and of
the Pallas kernel ``srla_tpu.kernels.pallas_lpc.lpc_scan_pallas``: same
arguments, same wrapping-int32 semantics. On a CUDA tensor it launches the
hand-written kernel ``csrc/lpc_synth.cu``; on a CPU tensor it runs
``lpc_scan_plain``, the PyTorch version the kernel is checked against.
The kernel runs one warp per row with up to eight taps a lane, so the
wrapper takes at most ``MAX_TAPS`` taps on every device (the format's
orders stop at 255).

``lpc_scan_coefs`` is K1's second entry, the one the decode runs: it takes
the parsed, left-aligned coefficients where they lie (a strided view of the
decode's packed parameters) and aligns them as the kernel loads its taps,
where ``lpc_scan`` takes them right-aligned by ``align_coefs`` (the twin of
``srla_tpu.kernels.decode2._align_coefs``) first. Its plain version is
``align_coefs`` then ``lpc_scan_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_MASK32 = 0xFFFFFFFF
MAX_TAPS = 256           # 8 taps per lane of the kernel's warp


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """Reduce an int64 tensor mod 2^32 into the int32 range (two's
    complement), still as int64."""
    return ((x + (1 << 31)) & _MASK32) - (1 << 31)


def half_const(rshifts: torch.Tensor) -> torch.Tensor:
    """C's ``1 << (rshift - 1)`` as int64; rshift 0 gives INT_MIN (x86
    shift-count masking, as the reference encoder computes it)."""
    rs = rshifts.long()
    return torch.where(rs > 0, torch.ones_like(rs) << (rs - 1).clamp(min=0),
                       torch.full_like(rs, -(1 << 31)))


def align_coefs(coefs: torch.Tensor, orders: torch.Tensor,
                M: int) -> torch.Tensor:
    """Right-align per-row coefficients (R, >= M) for the window dot: column
    j multiplies the output M - j steps back (``decode2._align_coefs``)."""
    j = torch.arange(M, device=coefs.device)[None, :]
    cols = j - (M - orders.long())[:, None]
    picked = torch.gather(coefs[:, :M], 1, cols.clamp(0, M - 1))
    return torch.where(cols >= 0, picked, 0).to(torch.int32).contiguous()


def lpc_scan_plain(res, aligned, orders, rshifts, n: int, M: int,
                   dcoef=None, dprev=None) -> torch.Tensor:
    """Plain PyTorch version of K1: a loop over samples, vectorised over rows.

    Arithmetic is int64 with an explicit wrap to int32 after every step: the
    window dot is summed from products already reduced mod 2^32 (each term
    < 2^32, at most 256 terms, so the int64 sum is exact) and then wrapped.
    """
    R = res.shape[0]
    x = res.long()
    al = aligned.long()
    ordr = orders.long()
    rsh = rshifts.long()
    half = half_const(rshifts)
    fuse = dcoef is not None
    win = torch.zeros((R, M), dtype=torch.int64, device=res.device)
    yprev = dprev.long() if fuse else None
    dc = dcoef.long() if fuse else None
    out = torch.empty((R, n), dtype=torch.int32, device=res.device)
    for s in range(n):
        xs = x[:, s]
        if s == 0:
            nv = xs
        else:
            acc = wrap32(((win * al) & _MASK32).sum(dim=1) + half)
            pred = acc >> rsh
            nv = torch.where(s < ordr, wrap32(xs + win[:, -1]),
                             wrap32(xs - pred))
            nv = torch.where(ordr > 0, nv, xs)
        win = torch.cat([win[:, 1:], nv[:, None]], dim=1)
        if fuse:
            yprev = wrap32(nv + (wrap32(yprev * dc) >> 4))
            out[:, s] = yprev.to(torch.int32)
        else:
            out[:, s] = nv.to(torch.int32)
    return out


def lpc_scan(res, aligned, orders, rshifts, n: int, M: int,
             dcoef=None, dprev=None) -> torch.Tensor:
    """res (R, n) int32 residuals; aligned (R, M) int32 right-aligned
    coefficients; orders, rshifts (R,) int32; dcoef/dprev (R,) int32 fuse
    the de-emphasis. Returns (R, n) int32.

    CUDA tensors go through the kernel (``lpc_scan.launches`` counts its
    launches); CPU tensors go through ``lpc_scan_plain``.
    """
    if not 1 <= M <= MAX_TAPS:
        raise ValueError(f"lpc_scan: M must be in 1..{MAX_TAPS}, got {M}")
    if res.device.type == "cpu":
        return lpc_scan_plain(res, aligned, orders, rshifts, n, M,
                              dcoef=dcoef, dprev=dprev)
    if res.device.type != "cuda":
        raise ValueError(f"lpc_scan: no kernel for device {res.device}")
    R = res.shape[0]
    fuse = dcoef is not None
    build.check_arg("lpc_scan", "res", res, (R, n), res.device)
    build.check_arg("lpc_scan", "aligned", aligned, (R, M), res.device)
    for name, t in (("orders", orders), ("rshifts", rshifts)) + (
            (("dcoef", dcoef), ("dprev", dprev)) if fuse else ()):
        build.check_arg("lpc_scan", name, t, (R,), res.device)
    out = torch.empty((R, n), dtype=torch.int32, device=res.device)
    if R == 0 or n == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(res.device).cuda_stream
    err = lib.srla_lpc_synth(
        res.data_ptr(), aligned.data_ptr(), orders.data_ptr(),
        rshifts.data_ptr(), dcoef.data_ptr() if fuse else None,
        dprev.data_ptr() if fuse else None, out.data_ptr(), R, n, M,
        int(fuse), stream)
    build.check(err, "lpc_synth")
    lpc_scan.launches += 1
    return out


lpc_scan.launches = 0


def _coef_rows(coefs: torch.Tensor, R: int, M: int):
    """A coefficient view as (C, block stride, channel stride): (B, C, >= M)
    with B * C = R, or (R, >= M) as C = 1; the coefficients of a row must
    be consecutive."""
    if coefs.dim() == 2:
        coefs = coefs[:, None, :]
    if coefs.dim() != 3 or coefs.shape[0] * coefs.shape[1] != R \
            or coefs.shape[2] < M or coefs.stride(2) != 1:
        raise ValueError(f"lpc_scan_coefs: coefs must be (B, C, >= {M}) "
                         f"with B * C = {R} rows and consecutive "
                         f"coefficients, got {tuple(coefs.shape)} strides "
                         f"{coefs.stride()}")
    return coefs.shape[1], coefs.stride(0), coefs.stride(1)


def lpc_scan_coefs(res, coefs, orders, rshifts, n: int, M: int,
                   dcoef=None, dprev=None) -> torch.Tensor:
    """K1 on the parsed coefficients: res (R, n) int32 residuals; coefs
    (B, C, >= M) int32 (B * C = R; row b * C + c's coefficients, first
    first, at any block and channel stride) or (R, >= M); orders, rshifts
    (R,) int32; dcoef/dprev (R,) int32 fuse the de-emphasis. Returns
    (R, n) int32, ``lpc_scan`` of ``align_coefs`` of the coefficients.

    CUDA tensors go through the kernel (``lpc_scan_coefs.launches`` counts
    its launches); CPU tensors go through ``align_coefs`` and
    ``lpc_scan_plain``.
    """
    if not 1 <= M <= MAX_TAPS:
        raise ValueError(f"lpc_scan_coefs: M must be in 1..{MAX_TAPS}, "
                         f"got {M}")
    R = res.shape[0]
    C, bstride, cstride = _coef_rows(coefs, R, M)
    if res.device.type == "cpu":
        return lpc_scan_plain(res, align_coefs(coefs.reshape(R, -1), orders,
                                               M), orders, rshifts, n, M,
                              dcoef=dcoef, dprev=dprev)
    if res.device.type != "cuda":
        raise ValueError(f"lpc_scan_coefs: no kernel for device {res.device}")
    fuse = dcoef is not None
    build.check_arg("lpc_scan_coefs", "res", res, (R, n), res.device)
    if coefs.dtype != torch.int32 or coefs.device != res.device:
        raise ValueError(f"lpc_scan_coefs: coefs must be int32 on "
                         f"{res.device}, got {coefs.dtype} on {coefs.device}")
    for name, t in (("orders", orders), ("rshifts", rshifts)) + (
            (("dcoef", dcoef), ("dprev", dprev)) if fuse else ()):
        build.check_arg("lpc_scan_coefs", name, t, (R,), res.device)
    out = torch.empty((R, n), dtype=torch.int32, device=res.device)
    if R == 0 or n == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(res.device).cuda_stream
    err = lib.srla_lpc_synth_coefs(
        res.data_ptr(), coefs.data_ptr(), bstride, cstride, C,
        orders.data_ptr(), rshifts.data_ptr(),
        dcoef.data_ptr() if fuse else None,
        dprev.data_ptr() if fuse else None, out.data_ptr(), R, n, M,
        int(fuse), stream)
    build.check(err, "lpc_synth_coefs")
    lpc_scan_coefs.launches += 1
    return out


lpc_scan_coefs.launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("lpc_synth")
    fn = lib.srla_lpc_synth
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fc = lib.srla_lpc_synth_coefs
        fc.restype = ctypes.c_int
        fc.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int] \
            + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib
