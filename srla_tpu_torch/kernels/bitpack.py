"""Residual-section codewords and K5, the bit pack of the encode.

``residual_codewords`` is the twin of ``srla_tpu.kernels.bitpack.
residual_codewords`` and ``word_splits`` of its ``_word_splits``: PyTorch
ops on int64.

``pack_residual_sections`` is the twin of ``srla_tpu.kernels.bitpack.
pack_residual_sections``: from the chosen rows' zigzag residuals and Rice
choices to their packed sections in one step, each row at its own word
offset of one flat buffer; with ``rows`` it picks the chosen rows of the
whole (V, n) int32 residual by index and zigzags them as it reads them. On
a CUDA tensor it launches the hand-written kernel ``pack_sections_kernel``
of ``csrc/bitpack.cu`` (a CTA per row, no codeword stream in device
memory); on a CPU tensor it runs
``pack_residual_sections_plain``: the codeword stream, then ``pack_plain``.
This is the entry the encode runs.

``pack`` writes a ready stream of (offset, tail, tbits) codewords into one
flat buffer of MSB-first 32-bit words, the job of the Pallas kernel
``srla_tpu.kernels.pallas_pack.pallas_pack_rows`` and of the XLA packers
``bitpack.pack_flat_stream`` / ``pack_monotone_stream``. On a CUDA tensor it
launches ``bitpack_kernel`` of the same source on the caller's tensors as
they are (contributions to one word merged in the warp before its atomic);
on a CPU tensor it runs ``pack_plain``. It is off the encode's path since
the fused entry took its place there, and stays for callers that hold a
stream.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import (CODER_LOG2_MAX_NUM_PARTITIONS,
                         CODER_RICE_PARAMETER_BITS)
from . import build
from .lpc import _MASK32, wrap32


def zigzag(x: torch.Tensor) -> torch.Tensor:
    """int32-range values -> their zigzag codes in [0, 2^32) as int64."""
    x = x.long()
    return ((x << 1) ^ (x >> 31)) & _MASK32


def zigzag32(x: torch.Tensor) -> torch.Tensor:
    """int32 values -> the int32 bit patterns of their zigzag codes."""
    return (x << 1) ^ (x >> 31)


def _shl(x, k):
    """(x << k) mod 2^32 with XLA's rule: a count outside 0..31 gives 0."""
    ok = (k >= 0) & (k < 32)
    return torch.where(ok, (x << k.clamp(0, 31)) & _MASK32, 0)


def _shr(x, k):
    """x >> k for x in [0, 2^32); a count outside 0..31 gives 0."""
    ok = (k >= 0) & (k < 32)
    return torch.where(ok, x >> k.clamp(0, 31), 0)


def residual_codewords(u, code_type, porder, ks, n: int):
    """Codewords of each row's residual section as one monotone stream in
    natural bit order: the 2 header slots (code type, partition order), then
    per partition its parameter codeword followed by its samples.

    u (V, n) zigzag residuals; code_type, porder (V,); ks (V, MAXP)
    per-partition parameters. Returns ((offsets, tails, tbits), total_bits),
    the stream arrays (V, 2 + MAXP + n) int64 with tails in [0, 2^32) and
    masked slots at tbits 0. Section layout parity:
    libs/srla_coder/src/srla_coder.c:486-595.
    """
    dev = u.device
    V = u.shape[0]
    uu = u.long() & _MASK32
    ct = code_type.long()
    po = porder.long()
    ks = ks.long()
    allzero = ct == 2
    recursive = (ct == 1)[:, None]

    nsmpl = (torch.full_like(po, n) >> po)[:, None]          # (V, 1)
    s_idx = torch.arange(n, device=dev)[None, :]
    k = torch.gather(ks, 1, s_idx // nsmpl)
    one_k = _shl(torch.ones_like(k), k)
    mask = (one_k - 1) & _MASK32
    # Plain Rice: q zeros, 1, k low bits.
    q_r = _shr(uu, k)
    tail_r = one_k | (uu & mask)
    # Recursive Rice: small -> 1 + k1 bits; big -> q' zeros, 1, k2 bits.
    k1pow = _shl(torch.ones_like(k), k + 1)
    small = uu < k1pow
    tmp = torch.where(small, 0, (uu - k1pow) & _MASK32)
    q_rr = torch.where(small, 0, 1 + _shr(tmp, k))
    tail_rr = torch.where(small, k1pow | uu, one_k | (tmp & mask))
    s_lead = torch.where(recursive, q_rr, q_r)
    s_tails = torch.where(recursive, tail_rr, tail_r)
    s_tbits = torch.where(recursive, torch.where(small, k + 2, k + 1), k + 1)
    s_tbits = torch.where(allzero[:, None], 0, s_tbits)

    # Partition parameter codewords: 5-bit k, then unary zigzag deltas.
    MAXP = ks.shape[1]
    nparts = (torch.ones_like(po) << po)[:, None]
    pidx = torch.arange(MAXP, device=dev)[None, :]
    pactive = (pidx < nparts) & ~allzero[:, None]
    diff = ks - torch.cat([ks[:, :1], ks[:, :-1]], dim=1)
    p_lead = torch.where(pactive & (pidx > 0), zigzag(diff), 0)
    p_tails = torch.where(pidx == 0, ks & _MASK32, 1)
    p_tbits = torch.where(pactive, torch.where(
        pidx == 0, CODER_RICE_PARAMETER_BITS, 1), 0)

    # Merge into natural bit order: per row a period of nsmpl + 1 slots.
    T = 2 + MAXP + n
    e = torch.arange(T - 2, device=dev)[None, :]
    period = nsmpl + 1
    part = e // period
    within = e - part * period
    is_param = within == 0
    live = part < nparts
    partc = part.clamp(max=MAXP - 1)
    sidxc = (part * nsmpl + within - 1).clamp(0, n - 1)

    def pick(pv, sv):
        return torch.where(live & is_param, torch.gather(pv, 1, partc),
                           torch.where(live, torch.gather(sv, 1, sidxc), 0))

    lead = pick(p_lead, s_lead)
    tails = pick(p_tails, s_tails)
    tbits = pick(p_tbits, s_tbits)

    # Header slots: type (2 bits) + porder (10); ALLZERO emits only the type.
    h_tails = torch.stack([ct & _MASK32, po & _MASK32], dim=1)
    h_tbits = torch.stack([torch.full_like(ct, 2), torch.where(
        allzero, 0, CODER_LOG2_MAX_NUM_PARTITIONS)], dim=1)
    lead = torch.cat([torch.zeros_like(h_tails), lead], dim=1)
    tails = torch.cat([h_tails, tails], dim=1)
    tbits = torch.cat([h_tbits, tbits], dim=1)

    bits = lead + tbits
    csum = torch.cumsum(bits, dim=1)
    offsets = csum - bits + lead                             # tail starts
    return (offsets, tails, tbits), csum[:, -1]


def word_splits(offsets, tails, tbits, cap_w: int):
    """Per entry: its first word and its two word-aligned contributions
    (``bitpack._word_splits``). Invalid entries (tbits <= 0) and entries at
    or beyond cap_w * 32 point at word cap_w; all int64."""
    off = offsets.long()
    tb = tbits.long()
    t = tails.long() & _MASK32
    valid = tb > 0
    limit = cap_w * 32
    off = torch.where(valid, off.clamp(max=limit), limit)
    sh = off & 31
    over = (tb - (32 - sh)).clamp(min=0)
    keep = tb - over
    vA = torch.where(valid & (keep > 0),
                     _shl(_shr(t, over), 32 - sh - keep), 0)
    vB = torch.where(valid & (over > 0), _shl(t, 32 - over), 0)
    return off >> 5, vA, vB


def pack_plain(offsets, tails, tbits, cap_w: int) -> torch.Tensor:
    """Plain PyTorch version of K5: an index_add of both contributions into
    cap_w + 2 int64 bins (bit-disjoint, so sum == or), then the first cap_w
    as int32 bit patterns."""
    w0, vA, vB = word_splits(offsets.reshape(-1), tails.reshape(-1),
                             tbits.reshape(-1), cap_w)
    w0 = torch.where(w0 < 0, cap_w, w0)
    buf = torch.zeros(cap_w + 2, dtype=torch.int64, device=offsets.device)
    buf.index_add_(0, w0, vA)
    buf.index_add_(0, w0 + 1, vB)
    return wrap32(buf[:cap_w] & _MASK32).to(torch.int32)


def _flat(t: torch.Tensor, dtypes: tuple) -> torch.Tensor:
    """t as a contiguous 1-D tensor, int64 unless its dtype is in dtypes: a
    view of a contiguous input of such a dtype, with no pass over it."""
    t = t.reshape(-1)
    if t.dtype not in dtypes:
        t = t.to(torch.int64)
    return t.contiguous()


def pack(offsets, tails, tbits, cap_w: int) -> torch.Tensor:
    """offsets (..., T) absolute bit positions; tails (..., T) with the low
    tbits bits significant; tbits (..., T), 0 for a masked slot. Entries
    may come in any order; words at or beyond cap_w are dropped. Returns
    (cap_w,) int32: the MSB-first words as bit patterns.

    CUDA tensors go through the kernel (``pack.launches`` counts its
    launches), which reads int64 offsets and int32 or int64 tails and
    tbits as they are (other dtypes are converted to int64 first); CPU
    tensors go through ``pack_plain``. The encode does not call it:
    ``pack_residual_sections`` packs its sections.
    """
    if offsets.device.type == "cpu":
        return pack_plain(offsets, tails, tbits, cap_w)
    if offsets.device.type != "cuda":
        raise ValueError(f"pack: no kernel for device {offsets.device}")
    dev = offsets.device
    if tails.device != dev or tbits.device != dev:
        raise ValueError(f"pack: offsets, tails and tbits must all be on "
                         f"{dev}")
    if not 0 <= cap_w < 1 << 32:
        raise ValueError(f"pack: cap_w must be in 0..2^32 - 1, got {cap_w}")
    offs = _flat(offsets, (torch.int64,))
    tl = _flat(tails, (torch.int32, torch.int64))
    tb = _flat(tbits, (torch.int32, torch.int64))
    count = offs.numel()
    if tl.numel() != count or tb.numel() != count:
        raise ValueError("pack: offsets, tails and tbits differ in size")
    out = torch.zeros(cap_w, dtype=torch.int32, device=dev)
    if count == 0 or cap_w == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.srla_bitpack(offs.data_ptr(), tl.data_ptr(), tb.data_ptr(),
                           out.data_ptr(), count, cap_w,
                           int(tl.dtype == torch.int64),
                           int(tb.dtype == torch.int64), stream)
    build.check(err, "bitpack")
    pack.launches += 1
    return out


pack.launches = 0


# Shared memory a CTA can have on sm_90 (227 KB), less the kernel's static
# scratch.
_MAX_SHARED_BYTES = 232448 - 64


def section_stream(u, code_type, porder, ks, n: int, starts, lens_w):
    """The rows' codeword streams (``residual_codewords``) at absolute bit
    offsets of one flat buffer: row r starts at word starts[r]; a row with
    lens_w[r] == 0 contributes nothing. Returns (offsets, tails, tbits),
    each (K, 2 + MAXP + n) int64."""
    (offs, tails, tbits), _ = residual_codewords(u, code_type, porder, ks, n)
    skip = (lens_w == 0)[:, None]
    offs = torch.where(skip, 0, offs) + starts.long()[:, None] * 32
    return offs, tails, torch.where(skip, 0, tbits)


def pack_residual_sections_plain(u, code_type, porder, ks, n: int, starts,
                                 lens_w, cap_w: int,
                                 rows=None) -> torch.Tensor:
    """Plain PyTorch version of ``pack_residual_sections``: the chosen rows
    zigzagged and gathered (with ``rows``), the codeword stream of every
    row, then ``pack_plain``. Words no row owns are 0."""
    if rows is not None:
        u, code_type, porder, ks = (zigzag32(u)[rows], code_type[rows],
                                    porder[rows], ks[rows])
    return pack_plain(*section_stream(u, code_type, porder, ks, n, starts,
                                      lens_w), cap_w)


def pack_residual_sections(u, code_type, porder, ks, n: int, starts, lens_w,
                           cap_w: int, section_words=None,
                           rows=None) -> torch.Tensor:
    """Pack the residual section of each row into one flat word buffer.

    u (K, n) zigzag residuals (int64 in [0, 2^32) or their int32 bit
    patterns); code_type, porder (K,); ks (K, MAXP) per-partition parameters
    in 0..31, 2^porder of them live with n divisible by 2^porder; starts,
    lens_w (K,) the first word and the length in words of each row's section
    in the buffer (lens_w = ceil(section bits / 32), or 0 for a row that is
    not packed); the rows' word ranges are disjoint. Returns (cap_w,) int32:
    MSB-first words as bit patterns. Words that no row owns are unspecified
    on a CUDA tensor (the buffer is not zeroed) and 0 on a CPU tensor.

    ``rows`` (K,) int64, when given, picks the packed rows by index: u is
    then the (V, n) int32 residual of every variant row (not yet
    zigzagged), code_type, porder (V,) and ks (V, MAXP) are every row's,
    and output row r packs row rows[r] of them, zigzagged as it is read.
    The encode packs this way (K17's rows).

    ``section_words`` is an upper bound of lens_w, the size of the kernel's
    row image in shared memory; left out, it is max(lens_w), which costs a
    device synchronisation.

    CUDA tensors go through the kernel (``pack_residual_sections.launches``
    counts its launches); CPU tensors go through
    ``pack_residual_sections_plain``.
    """
    if u.device.type == "cpu":
        return pack_residual_sections_plain(u, code_type, porder, ks, n,
                                            starts, lens_w, cap_w, rows)
    if u.device.type != "cuda":
        raise ValueError(f"pack_residual_sections: no kernel for device "
                         f"{u.device}")
    dev = u.device
    V = u.shape[0]
    K = V if rows is None else rows.shape[0]
    if tuple(u.shape) != (V, n) or ks.dim() != 2 or ks.shape[0] != V:
        raise ValueError("pack_residual_sections: u must be (V, n) and ks "
                         f"(V, MAXP), got {tuple(u.shape)} and "
                         f"{tuple(ks.shape)} at n = {n}")
    for name, t, k in (("code_type", code_type, V), ("porder", porder, V),
                       ("starts", starts, K), ("lens_w", lens_w, K)):
        if tuple(t.shape) != (k,) or t.device != dev:
            raise ValueError(f"pack_residual_sections: {name} must have "
                             f"shape ({k},) on {dev}")
    if rows is not None:
        if rows.dtype != torch.int64 or rows.dim() != 1 \
                or rows.device != dev or not rows.is_contiguous():
            raise ValueError(f"pack_residual_sections: rows must be a "
                             f"contiguous 1-D int64 tensor on {dev}")
        if u.dtype != torch.int32 or not u.is_contiguous():
            raise ValueError("pack_residual_sections: with rows, u must be "
                             "the contiguous int32 residual")
        u32 = u
    else:
        u32 = u if u.dtype == torch.int32 else wrap32(u.long()).to(
            torch.int32)
        u32 = u32.contiguous()
    # The kernel reads the rest as int64, the type the analysis leaves them
    # in: no conversion pass on the encode's path.
    ct, po, k64, st, lw = (t.to(torch.int64).contiguous()
                           for t in (code_type, porder, ks, starts, lens_w))
    out = torch.empty(cap_w, dtype=torch.int32, device=dev)
    if K == 0 or cap_w == 0:
        return out
    if section_words is None:
        section_words = int(lw.max())
    section_words = max(int(section_words), 1)
    maxp = k64.shape[1]
    if 4 * (section_words + maxp) > _MAX_SHARED_BYTES:
        raise ValueError(
            f"pack_residual_sections: a row image of {section_words} words "
            f"and {maxp} parameters does not fit in a CTA's shared memory")
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.srla_pack_sections(
        u32.data_ptr(), ct.data_ptr(), po.data_ptr(), k64.data_ptr(),
        None if rows is None else rows.data_ptr(), st.data_ptr(),
        lw.data_ptr(), out.data_ptr(), K, V, n, maxp, section_words, cap_w,
        stream)
    build.check(err, "pack_sections")
    pack_residual_sections.launches += 1
    return out


pack_residual_sections.launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("bitpack")
    fn = lib.srla_bitpack
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 \
            + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fused = lib.srla_pack_sections
        fused.restype = ctypes.c_int
        fused.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int,
                                                  ctypes.c_longlong] \
            + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
    return lib
