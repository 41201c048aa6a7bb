"""K15: the f32 Rice cost of the approximate encode.

``rice_cost`` computes what ``srla_tpu.kernels.encode._rice_cost`` (:288)
computes: each row's code type, the partition order of least bits, those
bits (+2 for the code type) and the order's Rice parameters. On a CUDA
tensor it launches the hand-written kernel ``csrc/rice_cost.cu``; on a CPU
tensor it runs ``rice_cost_plain``, the PyTorch version the kernel is
checked against.

Two choices differ from JAX, both beside the code in the kernel's source:
the partition means are exact integer sums rounded once to f32 (JAX adds
the f32 codes in XLA's order: a few ulps apart, within the approximate
encode's contract, and kernel and plain version agree bit for bit), and
the bits are the exact packed length of the section (JAX reads codes of
2^31 and above as negative int32, where its count is not the packed
length). So the bits always equal the length of the section K5 packs from
the same parameters, which keeps the approximate stream lossless.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import CODER_LOG2_MAX_NUM_PARTITIONS
from ..rice import MLNOPTX
from . import build
from .bitpack import zigzag

_F32 = torch.float32
MLNOPTX_F32 = float(np.float32(MLNOPTX))
NEG_MLNOPTX_F32 = float(np.float32(-0.66794162356))
# The bits of a partition order before its partitions: the order field and
# the first parameter's 5 bits (encode.py:327).
HEAD_BITS = CODER_LOG2_MAX_NUM_PARTITIONS + 5
# The largest row: a CTA holds the row in registers, at most 64 samples a
# thread over 1024 threads.
MAX_N = 65536


def _true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b rounded once: torch's CUDA division by a Python number
    multiplies by its reciprocal."""
    return a / torch.full_like(a, b)


def plain_k(m: torch.Tensor) -> torch.Tensor:
    """The plain-Rice parameter of f32 partition means (encode.py:316-321),
    int64."""
    rho = torch.ones_like(m) / (1.0 + m)
    om = torch.clamp_min(1.0 - rho, 1e-30)
    lv = torch.full_like(om, NEG_MLNOPTX_F32) / torch.log(om)
    kf = torch.round(torch.log2(torch.clamp_min(lv, 1e-30)))
    kf = torch.where(torch.isfinite(kf), kf, 0.0)
    return torch.clamp(kf, 0, 30).long()


def recursive_k(m: torch.Tensor) -> torch.Tensor:
    """The recursive-Rice parameter of f32 partition means
    (encode.py:309-310), int64."""
    g = torch.clamp_min(MLNOPTX_F32 * (1.0 + m), 1.0)
    return torch.clamp(torch.floor(torch.log2(g)), 0, 30).long()


def rice_cost_plain(residual: torch.Tensor, n: int, max_porder: int):
    """Plain PyTorch version of K15: a loop over partition orders,
    vectorised over rows and partitions, the sums in int64. Same arguments
    and results as ``rice_cost``."""
    V = residual.shape[0]
    dev = residual.device
    u = zigzag(residual)                         # int64 in [0, 2^32)
    total = u.sum(dim=1)
    recursive = _true_div(total.to(_F32), float(n)) >= 2.0
    allzero = total == 0
    MAXP = 1 << max_porder
    best_bits = torch.full((V,), 1 << 30, dtype=torch.int64, device=dev)
    best_porder = torch.zeros(V, dtype=torch.int64, device=dev)
    best_ks = torch.zeros((V, MAXP), dtype=torch.int64, device=dev)
    for p in range(max_porder + 1):
        nparts, nsmpl = 1 << p, n >> p
        up = u.view(V, nparts, nsmpl)
        m = _true_div(up.sum(dim=2).to(_F32), float(nsmpl))
        k = torch.where(recursive[:, None], recursive_k(m), plain_k(m))
        kx = k[:, :, None]
        k1pow = 2 << kx
        rec = torch.where(up >= k1pow, (up - k1pow) >> kx, 0).sum(dim=2) \
            + (k + 2) * nsmpl
        plain = (up >> kx).sum(dim=2) + (k + 1) * nsmpl
        part = torch.where(recursive[:, None], rec, plain)
        deltas = zigzag(k[:, 1:] - k[:, :-1])
        bits = HEAD_BITS + part.sum(dim=1) + (deltas + 1).sum(dim=1)
        better = bits < best_bits
        best_bits = torch.where(better, bits, best_bits)
        best_porder = torch.where(better, p, best_porder)
        best_ks = torch.where(better[:, None], F.pad(k, (0, MAXP - nparts)),
                              best_ks)
    code_type = torch.where(allzero, 2, torch.where(recursive, 1, 0))
    bits = (torch.where(allzero, 0, best_bits) + 2).to(torch.int32)
    return code_type, torch.where(allzero, 0, best_porder), bits, best_ks


def rice_cost(residual: torch.Tensor, n: int, max_porder: int):
    """residual (V, n) int32; n a multiple of 2^max_porder, max_porder in
    0..10. Returns (code_type (V,) int64: 0 plain, 1 recursive, 2 all zero;
    porder (V,) int64; bits (V,) int32, the section's exact bits + 2; ks
    (V, 2^max_porder) int64, the chosen order's parameters, zero-padded).

    CUDA tensors go through the kernel (``rice_cost.launches`` counts its
    launches), one launch a call; CPU tensors go through
    ``rice_cost_plain``."""
    if residual.device.type == "cpu":
        return rice_cost_plain(residual, n, max_porder)
    dev = residual.device
    if dev.type != "cuda":
        raise ValueError(f"rice_cost: no kernel for device {dev}")
    V = residual.shape[0]
    if not 0 <= max_porder <= 10 or n % (1 << max_porder) \
            or not 1 <= n <= MAX_N:
        raise ValueError(f"rice_cost: n={n} is not split by max_porder "
                         f"{max_porder} (0..10) or exceeds {MAX_N}")
    build.check_arg("rice_cost", "residual", residual, (V, n), dev)
    code_type = torch.empty(V, dtype=torch.int64, device=dev)
    porder = torch.empty(V, dtype=torch.int64, device=dev)
    bits = torch.empty(V, dtype=torch.int32, device=dev)
    ks = torch.empty((V, 1 << max_porder), dtype=torch.int64, device=dev)
    if V == 0:
        return code_type, porder, bits, ks
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.srla_rice_cost(
        residual.data_ptr(), code_type.data_ptr(), porder.data_ptr(),
        bits.data_ptr(), ks.data_ptr(), V, n, max_porder, MLNOPTX_F32,
        NEG_MLNOPTX_F32, HEAD_BITS, stream)
    build.check(err, "rice_cost")
    rice_cost.launches += 1
    return code_type, porder, bits, ks


rice_cost.launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("rice_cost")
    fn = lib.srla_rice_cost
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
    return lib
