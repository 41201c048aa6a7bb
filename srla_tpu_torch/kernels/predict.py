"""K3: the encode analysis' wrapping-int32 FIR residual.

``predict`` is the twin of ``srla_tpu.kernels.encode._predict`` (fed by
``_reverse_coefs``): same arguments, same wrapping-int32 semantics. On a
CUDA tensor it launches the hand-written kernel ``csrc/fir_predict.cu``; on
a CPU tensor it runs ``predict_plain``, the PyTorch version the kernel is
checked against.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build
from .lpc import _MASK32, half_const, wrap32


def reverse_coefs(intc: torch.Tensor, orders: torch.Tensor) -> torch.Tensor:
    """rev[i] = c[order-1-i] for i < order, left-aligned, zero beyond
    (``encode._reverse_coefs``). Returns int32."""
    M = intc.shape[1]
    idx = orders.long()[:, None] - 1 - torch.arange(M, device=intc.device)
    picked = torch.gather(intc, 1, idx.clamp(0, M - 1))
    return torch.where(idx >= 0, picked, 0).to(torch.int32).contiguous()


def predict_plain(work, coefs_rev, orders, rshifts) -> torch.Tensor:
    """Plain PyTorch version of K3: a loop over the M taps, vectorised over
    rows and samples, in int64 with every product reduced mod 2^32 (each
    term < 2^32, at most 256 terms, so the int64 sum is exact) and the sum
    wrapped explicitly."""
    V, n = work.shape
    M = coefs_rev.shape[1]
    x = work.long()
    o = orders.long()[:, None]
    cols = torch.arange(M, device=work.device)[None, :] - (M - o)
    aligned = torch.where(
        cols >= 0, torch.gather(coefs_rev.long(), 1, cols.clamp(0, M - 1)), 0)
    padded = F.pad(x, (M, 0))
    acc = half_const(rshifts)[:, None].expand(V, n).clone()
    for j in range(M):
        acc += (aligned[:, j:j + 1] * padded[:, j:j + n]) & _MASK32
    full = wrap32(x + (wrap32(acc) >> rshifts.long()[:, None]))
    first_diff = torch.cat([x[:, :1], wrap32(x[:, 1:] - x[:, :-1])], dim=1)
    s = torch.arange(n, device=work.device)[None, :]
    out = torch.where(o == 0, x,
                      torch.where(s < o, torch.where(s == 0, x, first_diff),
                                  full))
    return out.to(torch.int32)


def predict(work, coefs_rev, orders, rshifts) -> torch.Tensor:
    """work (V, n) int32 pre-emphasised samples; coefs_rev (V, M) int32
    reversed, left-aligned coefficients (``reverse_coefs``); orders,
    rshifts (V,) int32 with orders <= M. Returns the (V, n) int32 residual.

    CUDA tensors go through the kernel (``predict.launches`` counts its
    launches); CPU tensors go through ``predict_plain``.
    """
    if work.device.type == "cpu":
        return predict_plain(work, coefs_rev, orders, rshifts)
    if work.device.type != "cuda":
        raise ValueError(f"predict: no kernel for device {work.device}")
    V, n = work.shape
    M = coefs_rev.shape[1]
    if M < 1:
        raise ValueError("predict: coefs_rev needs at least one column")
    build.check_arg("predict", "work", work, (V, n), work.device)
    build.check_arg("predict", "coefs_rev", coefs_rev, (V, M), work.device)
    for name, t in (("orders", orders), ("rshifts", rshifts)):
        build.check_arg("predict", name, t, (V,), work.device)
    out = torch.empty((V, n), dtype=torch.int32, device=work.device)
    if V == 0 or n == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(work.device).cuda_stream
    err = lib.srla_fir_predict(work.data_ptr(), coefs_rev.data_ptr(),
                               orders.data_ptr(), rshifts.data_ptr(),
                               out.data_ptr(), V, n, M, stream)
    build.check(err, "fir_predict")
    predict.launches += 1
    return out


predict.launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("fir_predict")
    fn = lib.srla_fir_predict
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
    return lib
