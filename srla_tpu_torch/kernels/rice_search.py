"""K4: the Rice parameter search, from the residual to each row's code type,
partition order, parameters and flags in one launch.

``rice_search`` computes what the JAX package's
``srla_tpu.kernels.exact._rice_exact`` (:454-562) computes: zigzag, the
partition means (exact leaf sums, then pairwise halving as the host does),
the recursive/plain choice, each partition's Rice parameter from the
decision boundaries of ``rice_k_boundaries`` with its margin flag, the
per-partition bit sums, the bits of every partition order and the first
minimum over orders. On a CUDA tensor it launches the hand-written kernel
``csrc/rice_search.cu``; on a CPU tensor it runs ``rice_search_plain``, the
PyTorch version the kernel is checked against: ``rice_params`` (the float
half), ``rice_sums_plain`` (the sums) and ``porder_search`` (the order
loop). Partition j of order p sits in column ``2^p - 1 + j`` of the flat
per-partition layout.

The margins (as in srla_tpu.kernels.exact, sized there for df64; f64 errors
are smaller, so they hold a fortiori): the partition means are exact leaf
sums divided once and halved pairwise, the same operations in the same
order as the host's, so the distance is 0. The host's plain k comes from a
chain of libm calls, each within an ulp, behind 1 - 1/(1+mean), which
cancels: its log2v is off by up to 8e-17 * (1 + mean), under 1e-9 for
means below 1.2e7, against _EPS_RICE_LOG = 1e-8 (beyond that see
_PLAIN_K_TRUSTED); the recursive k2 truncates MLNOPTX * (1 + mean), one
rounding, against a relative _EPS_RICE_TRUNC = 1e-9.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import CODER_LOG2_MAX_NUM_PARTITIONS, CODER_RICE_PARAMETER_BITS
from ..rice import _LOG_OPTX, MLNOPTX
from . import build
from .bitpack import _shl, _shr, zigzag
from .lpc import _MASK32, wrap32

_EPS_RICE_LOG = 1e-8         # |log2v| distance to round-half boundary
_EPS_RICE_TRUNC = 1e-9       # relative distance to k2 truncation boundary
_EPS_RICE_MEAN2 = 1e-9       # |mean - 2| recursive/plain selection

# From this plain-Rice parameter on a partition is always flagged: the
# host's 1 - 1/(1+mean) cancels, so its log2v is off by 8e-17 * mean (over
# _EPS_RICE_LOG from mean 1.2e8 on), and the table's own margins, taken
# through exp() of a number within 1e-8 of 0, lose their digits from
# boundary 25 on. No encode comes near: the plain chain serves rows whose
# mean is under 2, so a partition's mean stays under 2 * 1024.
_PLAIN_K_TRUSTED = 24

# The bits of a partition order before its partitions: the order field and
# the first parameter's width.
_HEAD_BITS = CODER_LOG2_MAX_NUM_PARTITIONS + CODER_RICE_PARAMETER_BITS

# The largest row the kernel takes: a thread holds at most 64 samples of a
# CTA of 1024.
MAX_N = 65536

_F64 = torch.float64


def num_partition_cols(max_porder: int) -> int:
    """Columns of the flat per-partition layout: 2^(max_porder+1) - 1."""
    return (2 << max_porder) - 1


@lru_cache(maxsize=None)
def rice_k_boundaries():
    """Decision boundaries of the two Rice-parameter chains in
    partition-mean space, as plain f64 tables of 33 entries (index j holds
    boundary j for j = 1..31; 0 and 32 are sentinels) with their margins
    (``exact._rice_k_boundaries``).

    Plain Rice (srla_coder.c:262-287): k = max(0, round(log2v)) with
    log2v = log2(ln OPTX / ln(1 - 1/(1+m))): boundary j at log2v = j - 0.5.
    Recursive (c:298-324): k2 = log2floor(trunc(MLNOPTX*(1+m))): boundary j
    at MLNOPTX*(1+m) = 2^j. Both are strictly increasing in m.
    Returns ((kb, kb_eps), (tb, tb_eps)) as numpy f64 arrays."""
    def m_of_log2v(l2v):
        om = math.exp(_LOG_OPTX / 2.0 ** l2v)
        return om / (1.0 - om)

    big = 3.0e38
    kb, kb_eps, tb, tb_eps = [-big], [0.0], [-big], [0.0]
    for j in range(1, 32):
        m = m_of_log2v(j - 0.5)
        kb.append(m)
        kb_eps.append(abs(m_of_log2v(j - 0.5 + _EPS_RICE_LOG) - m)
                      + m * 2.0 ** -40 + 1e-12)
        t = 2.0 ** j / MLNOPTX - 1.0
        tb.append(t)
        tb_eps.append(max(_EPS_RICE_TRUNC, t * 2.0 ** -38))
    kb.append(big)
    kb_eps.append(0.0)
    tb.append(big)
    tb_eps.append(0.0)
    # The JAX package compares margins in f32: keep their f32 values.
    return ((np.asarray(kb), np.asarray(kb_eps, np.float32).astype(float)),
            (np.asarray(tb), np.asarray(tb_eps, np.float32).astype(float)))


def _count_and_flag(flat, bounds, eps, zero_mean, top: int = 31):
    """k = number of boundaries 1..31 at or below each mean, and whether the
    mean lies within the margin of either neighbouring boundary (or k is at
    least ``top``)."""
    b = torch.from_numpy(bounds).to(flat.device)
    be = torch.from_numpy(eps).to(flat.device)
    k = torch.searchsorted(b[1:32].contiguous(), flat.contiguous(),
                           right=True)
    d1 = (flat - b[k]).abs()
    d2 = (b[k + 1] - flat).abs()
    flagged = ((d1 < be[k]) | (d2 < be[k + 1]) | (k >= top)) & ~zero_mean
    return k, flagged


def rice_params(residual: torch.Tensor, n: int, max_porder: int):
    """The float half of the Rice parameter search: zigzag, partition means
    (exact leaf sums, then pairwise halving as the host does), the
    recursive/plain choice and each partition's k. Returns (u (V, n) int64,
    ks (V, P) int64 in the flat layout, recursive (V,), flagged (V, P)
    per-partition boundary flags, risky (V,))."""
    V = residual.shape[0]
    u = zigzag(residual)
    nleaf = 1 << max_porder
    nsl = n >> max_porder
    means = [None] * (max_porder + 1)
    means[max_porder] = u.reshape(V, nleaf, nsl).sum(dim=2).to(_F64) / nsl
    for p in range(max_porder - 1, -1, -1):
        m = means[p + 1]
        means[p] = (m[:, 0::2] + m[:, 1::2]) / 2.0
    mean_all = means[0][:, 0]
    recursive = mean_all >= 2.0
    risky = (mean_all - 2.0).abs() < _EPS_RICE_MEAN2
    flat = torch.cat(means, dim=1)
    zero_mean = flat == 0
    (kb, kb_eps), (tb, tb_eps) = rice_k_boundaries()
    kr, r_log = _count_and_flag(flat, kb, kb_eps, zero_mean,
                                top=_PLAIN_K_TRUSTED)
    k2, r_trunc = _count_and_flag(flat, tb, tb_eps, zero_mean)
    rec = recursive[:, None]
    return (u, torch.where(rec, k2, kr), recursive,
            torch.where(rec, r_trunc, r_log), risky)


def rice_sums_plain(u, ks, rec, n: int, max_porder: int) -> torch.Tensor:
    """The per-partition Rice bit sums of every order, in int64 with the
    sums wrapped to int32: ``u >> k`` for plain Rice rows and
    ``max(u - 2^(k+1), 0) >> k`` (int32 difference) for recursive rows
    (``_rice_exact``'s loop, :521-550). u (V, n) int32 zigzag bit patterns;
    ks (V, P) int32 in [0, 31]; rec (V,) int32 (non-zero: recursive Rice).
    Returns (V, P) int32."""
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


def porder_search(u, sums, ks, recursive, pflag, risky, n: int,
                  max_porder: int):
    """The order loop of ``_rice_exact`` (:516-558) on the sums: each
    order's bits, the first strict minimum from 1 << 30 (a row no order
    beats keeps order 0 and zero ks), risky ORed over every order's flags,
    and the all-zero rows. Returns (code_type, porder, bits (+2), ks (V,
    2^max_porder), risky)."""
    V = u.shape[0]
    sums = sums.long()
    nsmpl = torch.cat([torch.full((1 << p,), n >> p, dtype=torch.int64,
                                  device=u.device)
                       for p in range(max_porder + 1)])
    part_bits = sums + torch.where(recursive[:, None], ks + 2, ks + 1) * nsmpl
    MAXP = 1 << max_porder
    best_bits = torch.full((V,), 1 << 30, dtype=torch.int64,
                           device=u.device)
    best_porder = torch.zeros(V, dtype=torch.int64, device=u.device)
    best_ks = torch.zeros((V, MAXP), dtype=torch.int64, device=u.device)
    for porder in range(max_porder + 1):
        nparts = 1 << porder
        cols = slice(nparts - 1, 2 * nparts - 1)
        k = ks[:, cols]
        risky = risky | pflag[:, cols].any(dim=1)
        deltas = zigzag(k[:, 1:] - k[:, :-1])
        bits = (_HEAD_BITS + part_bits[:, cols].sum(dim=1)
                + (deltas + 1).sum(dim=1))
        better = bits < best_bits
        best_bits = torch.where(better, bits, best_bits)
        best_porder = torch.where(better, porder, best_porder)
        best_ks = torch.where(better[:, None], F.pad(k, (0, MAXP - nparts)),
                              best_ks)
    allzero = u.max(dim=1).values == 0
    code_type = torch.where(allzero, 2, torch.where(recursive, 1, 0))
    bits = torch.where(allzero, 0, best_bits) + 2
    best_porder = torch.where(allzero, 0, best_porder)
    return code_type, best_porder, bits, best_ks, risky & ~allzero


def rice_search_plain(residual: torch.Tensor, n: int, max_porder: int):
    """Plain PyTorch version of K4: ``rice_params``, ``rice_sums_plain``,
    then ``porder_search``. Same arguments and results as
    ``rice_search``."""
    u, ks, recursive, pflag, risky = rice_params(residual, n, max_porder)
    sums = rice_sums_plain(wrap32(u).to(torch.int32),
                           ks.to(torch.int32).contiguous(),
                           recursive.to(torch.int32), n, max_porder)
    return porder_search(u, sums, ks, recursive, pflag, risky, n,
                         max_porder)


def rice_search(residual: torch.Tensor, n: int, max_porder: int):
    """residual (V, n) int32; n a multiple of 2^max_porder, max_porder in
    0..10. Returns (code_type (V,) int64: 0 plain, 1 recursive, 2 all
    zero; porder (V,) int64; bits (V,) int64, the section's bits + 2; ks (V,
    2^max_porder) int64, the chosen order's parameters, zero-padded; risky
    (V,) bool: a mean within the margin of a decision boundary).

    CUDA tensors go through the kernel (``rice_search.launches`` counts its
    launches), one launch a call; CPU tensors go through
    ``rice_search_plain``."""
    if residual.device.type == "cpu":
        return rice_search_plain(residual, n, max_porder)
    dev = residual.device
    if dev.type != "cuda":
        raise ValueError(f"rice_search: no kernel for device {dev}")
    V = residual.shape[0]
    if not 0 <= max_porder <= 10 or n % (1 << max_porder) \
            or not 1 <= n <= MAX_N:
        raise ValueError(f"rice_search: n={n} is not split by max_porder "
                         f"{max_porder} (0..10) or exceeds {MAX_N}")
    build.check_arg("rice_search", "residual", residual, (V, n), dev)

    def out(*shape, dtype=torch.int64):
        return torch.empty(shape, dtype=dtype, device=dev)

    code_type, porder, bits = out(V), out(V), out(V)
    ks, risky = out(V, 1 << max_porder), out(V, dtype=torch.bool)
    if V == 0:
        return code_type, porder, bits, ks, risky
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.srla_rice_search(
        residual.data_ptr(), _tables(dev).data_ptr(), code_type.data_ptr(),
        porder.data_ptr(), bits.data_ptr(), ks.data_ptr(), risky.data_ptr(),
        V, n, max_porder, _HEAD_BITS, _PLAIN_K_TRUSTED, stream)
    build.check(err, "rice_search")
    rice_search.launches += 1
    return code_type, porder, bits, ks, risky


rice_search.launches = 0

_TABLES: dict = {}


def _tables(dev) -> torch.Tensor:
    """The (4, 33) f64 boundary tables (plain boundaries, margins,
    recursive boundaries, margins) on ``dev``, uploaded once per device."""
    key = str(dev)
    if key not in _TABLES:
        (kb, kb_eps), (tb, tb_eps) = rice_k_boundaries()
        _TABLES[key] = torch.from_numpy(
            np.stack([kb, kb_eps, tb, tb_eps])).to(dev)
    return _TABLES[key]


def _lib() -> ctypes.CDLL:
    lib = build.load("rice_search")
    fn = lib.srla_rice_search
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
    return lib
