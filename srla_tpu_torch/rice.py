"""Partitioned (recursive) Golomb-Rice residual coding.

Per block-channel the coder picks ALLZERO / plain Rice / recursive Rice and an
optimal power-of-2 partition order; Rice parameters are derived in closed form
from per-partition means (geometric-distribution MLE). Partition means are
computed at the finest split and merged pairwise — with int32 inputs the leaf
sums are exact in f64, so vectorized summation is bit-identical to any order.
(Stream parity: libs/srla_coder/src/srla_coder.c.)

The parameter-selection chain for the plain-Rice path goes through libm ``log``;
we use a vectorized ``np.log`` and re-evaluate with scalar libm (Python math,
same shared libm as the reference binary) whenever the rounded quantity is
within 1e-9 of a rounding boundary — the only region where a sub-ulp
discrepancy could change the emitted stream.

The port's own copy of ``srla_tpu/rice.py``: the constants, the batched
parameter search and the section emitter that the port's host paths and
``kernels/exact.py`` use, and the one-channel decoder (``decode``, from
``srla_tpu/rice.py:300``) of the host one-block reference
(``host_decoder.SRLADecoder.decode_block_params``).
"""

from __future__ import annotations

import math

import numpy as np

from .bitio import BitReader, BitWriter, sint32_to_uint32, uint32_to_sint32
from .constants import (CODER_LOG2_MAX_NUM_PARTITIONS, CODER_RICE_PARAMETER_BITS,
                        CodeType)

OPTX = 0.5127629514437670454896078808815218508243560791015625
_LOG_OPTX = math.log(OPTX)
MLNOPTX = 0.66794162356
_INV_LOGE2 = 1.4426950408889634


def _rice_k_scalar(mean: float) -> int:
    """k = max(0, round(log2(ln(OPTX)/ln(1-rho)))), rho = 1/(1+mean)."""
    rho = 1.0 / (1.0 + mean)
    om = 1.0 - rho
    denom = -math.inf if om == 0.0 else math.log(om)
    v = _LOG_OPTX / denom
    log2v = (-math.inf if v == 0.0 else math.log(v)) * _INV_LOGE2
    r = math.floor(log2v + 0.5) if log2v >= 0.0 else -math.floor(-log2v + 0.5)
    return int(max(0.0, r))


def rice_k_array(means: np.ndarray) -> np.ndarray:
    """Vectorized plain-Rice parameter with scalar-libm tie repair."""
    rho = 1.0 / (1.0 + means)
    om = 1.0 - rho
    with np.errstate(divide="ignore", invalid="ignore"):
        v = _LOG_OPTX / np.log(om)
        log2v = np.log(v) * _INV_LOGE2
    with np.errstate(invalid="ignore"):
        r = np.where(log2v >= 0.0, np.floor(log2v + 0.5), -np.floor(-log2v + 0.5))
        k = np.maximum(0.0, r)
        k = np.where(np.isfinite(k), k, 0.0).astype(np.int64)
        frac = np.abs(log2v - np.floor(log2v) - 0.5)
        risky = np.isfinite(log2v) & (frac < 1e-9)
    for i in np.flatnonzero(risky):
        k[i] = _rice_k_scalar(float(means[i]))
    return k


def recursive_rice_k2_array(means: np.ndarray) -> np.ndarray:
    """k2 = log2floor(max(1, trunc(MLNOPTX * (1 + mean)))). Integer-exact."""
    x = MLNOPTX * (1.0 + means)
    g = np.maximum(1.0, x)
    gi = g.astype(np.uint64)
    gi = np.maximum(gi, 1)
    _, ndig = np.frexp(gi.astype(np.float64))
    return (ndig - 1).astype(np.int64)


def analyze_batch(residuals: np.ndarray, num_samples: int):
    """Exact, fully vectorized partition search over a batch (V, n).

    Returns (code_type (V,), best_porder (V,), min_bits (V,) int64,
    ks (V, 1024) int16). Bit-identical decisions to ``srla_tpu.rice.analyze``
    (f64 means are exact; the plain-Rice libm chain uses rice_k_array's
    tie repair).
    """
    V, n = residuals.shape
    assert n == num_samples
    max_porder = 1
    while num_samples % (1 << max_porder) == 0:
        max_porder += 1
    max_porder = min(max_porder - 1, CODER_LOG2_MAX_NUM_PARTITIONS)

    from . import native_decoder
    if native_decoder.available():
        return native_decoder.rice_search_batch(
            residuals, num_samples, max_porder)

    uvals = sint32_to_uint32(residuals.astype(np.int32)).astype(np.int64)
    max_uval = uvals.max(axis=1)
    # Leaf sums are exact in f64; coarser means by pairwise merging.
    nleaf = 1 << max_porder
    leaf_mean = (uvals.reshape(V, nleaf, -1).sum(axis=2).astype(np.float64)
                 / (num_samples // nleaf))
    means = [None] * (max_porder + 1)
    means[max_porder] = leaf_mean
    for p in range(max_porder - 1, -1, -1):
        m = means[p + 1]
        means[p] = (m[:, 0::2] + m[:, 1::2]) / 2.0

    recursive = means[0][:, 0] >= 2.0
    best_bits = np.full(V, np.iinfo(np.int64).max, dtype=np.int64)
    best_porder = np.zeros(V, dtype=np.int32)
    best_ks = np.zeros((V, 1024), dtype=np.int16)

    rec_idx = np.flatnonzero(recursive)
    rice_idx = np.flatnonzero(~recursive)
    for porder in range(max_porder + 1):
        nparts = 1 << porder
        nsmpl = num_samples >> porder
        up = uvals.reshape(V, nparts, nsmpl)
        m = means[porder]
        ks = np.zeros((V, nparts), dtype=np.int64)
        part_bits = np.zeros((V, nparts), dtype=np.int64)
        if rec_idx.size:
            k2 = recursive_rice_k2_array(m[rec_idx].ravel()).reshape(-1, nparts)
            k1pow = np.int64(1) << (k2 + 1)
            d = (up[rec_idx] - k1pow[:, :, None]) & 0xFFFFFFFF
            d = np.where(d >= (1 << 31), d - (1 << 32), d)
            rbits = (np.maximum(d, 0) >> k2[:, :, None]).sum(axis=2)
            part_bits[rec_idx] = (k2 + 2) * nsmpl + rbits
            ks[rec_idx] = k2
        if rice_idx.size:
            k = rice_k_array(m[rice_idx].ravel()).reshape(-1, nparts)
            rbits = (up[rice_idx] >> k[:, :, None]).sum(axis=2)
            part_bits[rice_idx] = (k + 1) * nsmpl + rbits
            ks[rice_idx] = k
        deltas = sint32_to_uint32(
            (ks[:, 1:] - ks[:, :-1]).astype(np.int32)).astype(np.int64)
        bits = (CODER_LOG2_MAX_NUM_PARTITIONS + CODER_RICE_PARAMETER_BITS
                + part_bits.sum(axis=1) + deltas.sum(axis=1) + deltas.shape[1])
        better = bits < best_bits
        best_bits = np.where(better, bits, best_bits)
        best_porder = np.where(better, porder, best_porder)
        if better.any():
            best_ks[better, :nparts] = ks[better]
            best_ks[better, nparts:] = 0

    allzero = max_uval == 0
    code_type = np.where(allzero, int(CodeType.ALLZERO),
                         np.where(recursive, int(CodeType.RECURSIVE_RICE),
                                  int(CodeType.RICE))).astype(np.int32)
    min_bits = np.where(allzero, 0, best_bits) + 2
    best_porder = np.where(allzero, 0, best_porder)
    return code_type, best_porder, min_bits.astype(np.int64), best_ks


def emit_channel(writer: BitWriter, uvals: np.ndarray, num_samples: int,
                 code_type: int, porder: int, ks: np.ndarray) -> None:
    """Emit one channel-block with precomputed partition parameters, fully
    vectorized: one interleaved (vals, nbits) array covers the partition
    parameters and every sample codeword."""
    from . import native_decoder
    if native_decoder.available():
        nparts_n = 1 << porder
        buf, nbits = native_decoder.rice_emit(
            np.asarray(uvals[:num_samples]), num_samples, int(code_type),
            int(porder), np.asarray(ks[:nparts_n], dtype=np.int64))
        if nbits >= 0:
            writer.put_packed(buf, nbits)
            return
    writer.put(int(code_type), 2)
    if code_type == CodeType.ALLZERO:
        return
    writer.put(int(porder), CODER_LOG2_MAX_NUM_PARTITIONS)
    nparts = 1 << porder
    nsmpl = num_samples >> porder
    ks = np.asarray(ks[:nparts], dtype=np.int64)
    u = np.asarray(uvals[:num_samples], dtype=np.int64)
    ksmp = np.repeat(ks, nsmpl)
    if code_type == CodeType.RICE:
        q = u >> ksmp
        total = q + 1 + ksmp
        vals = (np.int64(1) << ksmp) | (u & ((np.int64(1) << ksmp) - 1))
    else:
        k1 = ksmp + 1
        k1pow = np.int64(1) << k1
        small = u < k1pow
        tmp = np.where(small, 0, u - k1pow)
        q = np.where(small, 0, 1 + (tmp >> ksmp))
        total = np.where(small, k1 + 1, q + 1 + ksmp)
        vals = np.where(small, k1pow | u,
                        (np.int64(1) << ksmp) | (tmp & ((np.int64(1) << ksmp) - 1)))
    # Partition parameter codewords: 5-bit first k, then unary zigzag deltas.
    deltas = sint32_to_uint32((ks[1:] - ks[:-1]).astype(np.int32)).astype(np.int64)
    pvals = np.concatenate([[int(ks[0])], np.ones(nparts - 1, dtype=np.int64)])
    pbits = np.concatenate([[CODER_RICE_PARAMETER_BITS], deltas + 1])
    # Interleave: param codeword before each partition's samples.
    ins = np.arange(nparts) * nsmpl
    all_vals = np.insert(vals, ins, pvals)
    all_bits = np.insert(total, ins, pbits)
    if (all_bits <= 32).all():
        writer.put(all_vals.astype(np.uint64), all_bits)
        return
    # Rare long codewords: chunked emission.
    for v, nb in zip(all_vals, all_bits):
        nb = int(nb)
        if nb <= 32:
            writer.put(int(v), nb)
        else:
            # v = (1 << k) | low_k_bits with nb-1-k leading zeros.
            k = int(v).bit_length() - 1
            writer.put_zero_run(nb - 1 - k)
            writer.put(int(v) & ((1 << k) - 1), k)


def decode(reader: BitReader, num_samples: int) -> np.ndarray:
    """Decode one channel-block of residuals."""
    code_type = reader.get(2)
    out = np.zeros(num_samples, dtype=np.int32)
    if code_type == CodeType.ALLZERO:
        return out
    porder = reader.get(CODER_LOG2_MAX_NUM_PARTITIONS)
    # Valid streams keep porder <= 10 and the partition count dividing the
    # sample count (srla_coder.c:357-363); anything else is corruption, and
    # an unchecked 1 << porder would allocate/loop unboundedly.
    if porder > CODER_LOG2_MAX_NUM_PARTITIONS or (1 << porder) > num_samples \
            or num_samples % (1 << porder):
        raise ValueError("corrupt stream (partition order)")
    nparts = 1 << porder
    nsmpl = num_samples >> porder
    bits = reader._bits
    ones = reader._ones
    pos = reader.pos
    oidx = int(np.searchsorted(ones, pos))
    uvals = np.empty(num_samples, dtype=np.int64)
    k = 0
    recursive = code_type == CodeType.RECURSIVE_RICE

    def read_bits(p, n):
        v = 0
        for b in bits[p:p + n]:
            v = (v << 1) | int(b)
        return v

    # Truncated/corrupt payloads exhaust the ones index mid-codeword; surface
    # that as the same "insufficient data" error the byte layer raises.
    try:
        for part in range(nparts):
            if part == 0:
                k = read_bits(pos, CODER_RICE_PARAMETER_BITS)
                pos += CODER_RICE_PARAMETER_BITS
            else:
                while ones[oidx] < pos:
                    oidx += 1
                run = int(ones[oidx]) - pos
                pos = int(ones[oidx]) + 1
                oidx += 1
                k += int(uint32_to_sint32(np.uint32(run)))
            if k < 0 or k > 31:
                raise ValueError("corrupt stream (rice parameter)")
            base = part * nsmpl
            if recursive:
                k2 = k
                for i in range(nsmpl):
                    while ones[oidx] < pos:
                        oidx += 1
                    quot = int(ones[oidx]) - pos
                    pos = int(ones[oidx]) + 1
                    oidx += 1
                    nread = k2 + (1 if quot == 0 else 0)
                    val = read_bits(pos, nread)
                    pos += nread
                    uvals[base + i] = val | ((quot + (1 if quot else 0)) << k2)
            else:
                for i in range(nsmpl):
                    while ones[oidx] < pos:
                        oidx += 1
                    quot = int(ones[oidx]) - pos
                    pos = int(ones[oidx]) + 1
                    oidx += 1
                    val = read_bits(pos, k)
                    pos += k
                    uvals[base + i] = (quot << k) + val
    except IndexError:
        raise ValueError("insufficient data") from None
    if pos > len(bits):
        raise ValueError("insufficient data")
    reader.pos = pos
    return uint32_to_sint32(uvals.astype(np.uint32))
