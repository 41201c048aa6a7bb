"""K1: batched LPC synthesis recurrence (+ fused de-emphasis).

``lpc_scan`` is the twin of ``srla_tpu.kernels.decode2._lpc_scan`` and of
the Pallas kernel ``srla_tpu.kernels.pallas_lpc.lpc_scan_pallas``: same
arguments, same wrapping-int32 semantics. On a CUDA tensor it launches the
hand-written kernel ``csrc/lpc_synth.cu``; on a CPU tensor it runs
``lpc_scan_plain``, the PyTorch version the kernel is checked against.
The kernel runs one warp per row with up to eight taps a lane, so the
wrapper takes at most ``MAX_TAPS`` taps on every device (the format's
orders stop at 255).
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


def _lib() -> ctypes.CDLL:
    lib = build.load("lpc_synth")
    fn = lib.srla_lpc_synth
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
    return lib
