"""K4: per-partition Rice bit sums, the hot loop of the Rice parameter
search.

``rice_sums`` computes, for every partition of every partition order of a
row, the sum the JAX package's ``srla_tpu.kernels.exact._rice_exact``
reduces (:521-550): ``u >> k`` for plain Rice rows and
``max(u - 2^(k+1), 0) >> k`` (int32 difference) for recursive rows. On a
CUDA tensor it launches the hand-written kernel ``csrc/rice_search.cu``; on a
CPU tensor it runs ``rice_sums_plain``, the PyTorch version the kernel is
checked against. Partition j of order p sits in column ``2^p - 1 + j``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .bitpack import _shl, _shr
from .lpc import _MASK32, wrap32


def num_partition_cols(max_porder: int) -> int:
    """Columns of the flat per-partition layout: 2^(max_porder+1) - 1."""
    return (2 << max_porder) - 1


def rice_sums_plain(u, ks, rec, n: int, max_porder: int) -> torch.Tensor:
    """Plain PyTorch version of K4, in int64 with the sums wrapped to int32.
    u (V, n) int32 zigzag bit patterns; ks (V, P) int32 in [0, 31];
    rec (V,) int32 (non-zero: recursive Rice). Returns (V, P) int32."""
    V = u.shape[0]
    uu = u.long() & _MASK32
    recursive = (rec != 0)[:, None, None]
    out = []
    for p in range(max_porder + 1):
        nparts = 1 << p
        up = uu.reshape(V, nparts, n >> p)
        k = ks[:, nparts - 1:2 * nparts - 1].long()[:, :, None]
        d = wrap32(up - _shl(torch.ones_like(k), k + 1))
        rec_terms = torch.where(d > 0, _shr(d, k), 0)
        out.append(torch.where(recursive, rec_terms, _shr(up, k)).sum(dim=2))
    return wrap32(torch.cat(out, dim=1)).to(torch.int32)


def rice_sums(u, ks, rec, n: int, max_porder: int) -> torch.Tensor:
    """u (V, n) int32 zigzagged residuals (uint32 bit patterns); ks (V, P)
    int32 per-partition parameters in the flat layout, P =
    ``num_partition_cols(max_porder)``; rec (V,) int32. n must be a multiple
    of 2^max_porder. Returns (V, P) int32 per-partition sums.

    CUDA tensors go through the kernel (``rice_sums.launches`` counts its
    launches); CPU tensors go through ``rice_sums_plain``.
    """
    if u.device.type == "cpu":
        return rice_sums_plain(u, ks, rec, n, max_porder)
    if u.device.type != "cuda":
        raise ValueError(f"rice_sums: no kernel for device {u.device}")
    V = u.shape[0]
    P = num_partition_cols(max_porder)
    if not 0 <= max_porder <= 10 or n % (1 << max_porder):
        raise ValueError(f"rice_sums: n={n} is not split by max_porder "
                         f"{max_porder} (0..10)")
    build.check_arg("rice_sums", "u", u, (V, n), u.device)
    build.check_arg("rice_sums", "ks", ks, (V, P), u.device)
    build.check_arg("rice_sums", "rec", rec, (V,), u.device)
    out = torch.empty((V, P), dtype=torch.int32, device=u.device)
    if V == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = lib.srla_rice_search(u.data_ptr(), ks.data_ptr(), rec.data_ptr(),
                               out.data_ptr(), V, n, max_porder, stream)
    build.check(err, "rice_search")
    rice_sums.launches += 1
    return out


rice_sums.launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("rice_search")
    fn = lib.srla_rice_search
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
    return lib
