"""K16: the variant stack and the exact pre-emphasis of the encode.

``variant_preemphasis`` is the twin of the stack in ``srla_tpu.kernels.
exact._variant_analysis`` (:1208-1219) followed by ``_preemphasis_exact``
(:83): from the samples of a group of B blocks to the pre-emphasised
variant rows ([M, S, ch0, ch1, ...] for C >= 2, [ch0] for C = 1, each a
slab of B rows), their coefficients, margin flags and first samples. It
reads the samples where they lie: the resident (C, N) file at the host's
span offsets (``Spans``), or a (B, C, n) block tensor. On a CUDA tensor it
launches the hand-written kernel ``csrc/preemphasis.cu``; on a CPU tensor
it runs ``variant_preemphasis_plain``: ``cut_spans`` (for ``Spans``), then
``variant_stack`` and ``preemphasis_rows``, the PyTorch code the encode ran
before the kernel.

The margin ``eps`` is the caller's (``exact._EPS_PREEMPH``, whose comment
gives the error it covers): r0 and r1 are exact 64-bit integer sums on both
routes, rounded once to f64, so kernel and plain version take the same
decisions bit for bit.

``variant_preemphasis_f32`` is K16's f32 entry, the twin of the stack in
``srla_tpu.kernels.encode.analyze_blocks_ex`` (:429-435) followed by
``encode._preemphasis`` (:41), for the f32 approximate encode: the same
kernel and layouts, the coefficient ``clip(round_half_even(16 r1 / max(r0,
1e-30)), -16, 15)`` in f32 (0 where r0 < 1e-6) and no flag. JAX sums in
f32 in XLA's order; both routes here take the exact 64-bit sums rounded
once to f32, so they agree bit for bit whatever the order of the adds.
Its plain version is ``variant_stack`` (after ``cut_spans``) and
``preemphasis_f32_rows``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import PREEMPHASIS_COEF_SHIFT
from . import build
from .levinson import _dist_to_half, _round_half_away
from .lpc import wrap32

_F64 = torch.float64


def variant_stack(blocks: torch.Tensor, lshift: int) -> torch.Tensor:
    """blocks (B, C, n) int -> the (V, n) int32 analysis rows: [M, S] (for
    C >= 2) then each channel, each a (B, n) slab, after the offset shift."""
    work = blocks.to(torch.int32) >> lshift
    C = work.shape[1]
    parts = []
    if C >= 2:
        s = work[:, 1] - work[:, 0]
        parts += [work[:, 0] + (s >> 1), s]
    parts += [work[:, c] for c in range(C)]
    return torch.cat(parts, dim=0).contiguous()


def _host_offsets(offsets, n: int, N: int) -> np.ndarray:
    """The span offsets as int64, each span inside the N-sample file."""
    offs = np.asarray(offsets, dtype=np.int64)
    if offs.ndim != 1 or (offs < 0).any() or (offs + n > N).any():
        raise ValueError(f"cut_spans: a span of {n} samples leaves the "
                         f"{N}-sample file")
    return offs


def cut_spans(file: torch.Tensor, offsets, n: int) -> torch.Tensor:
    """The (B, C, n) spans of the resident (C, N) ``file`` that start at
    the host ``offsets`` (B,), cut on the file's device. Every span must lie
    inside the file: a CUDA gather past its end would read other memory."""
    offs = _host_offsets(offsets, n, file.shape[1])
    idx = (torch.from_numpy(offs).to(file.device)[:, None]
           + torch.arange(n, device=file.device))
    return file[:, idx].permute(1, 0, 2)


class Spans:
    """B spans of n samples of a resident (C, N) ``file``, at the host
    ``offsets`` (each inside the file): a group of blocks that K16 reads
    where they lie, without cutting them out first. ``shape`` and
    ``device`` are those of the (B, C, n) blocks they stand for."""

    def __init__(self, file: torch.Tensor, offsets, n: int):
        if file.dim() != 2:
            raise ValueError(f"Spans: the file must be (C, N), got "
                             f"{tuple(file.shape)}")
        self.file = file
        self.offsets = _host_offsets(offsets, n, file.shape[1])
        self.n = n

    @property
    def shape(self) -> tuple:
        return (len(self.offsets), self.file.shape[0], self.n)

    @property
    def device(self):
        return self.file.device

    def cut(self) -> torch.Tensor:
        """The (B, C, n) blocks, cut on the file's device."""
        return cut_spans(self.file, self.offsets, self.n)


def as_blocks(src) -> torch.Tensor:
    """A (B, C, n) block tensor, or the blocks of ``Spans`` cut out."""
    return src.cut() if isinstance(src, Spans) else src


def preemphasis_rows(sig: torch.Tensor, eps: float):
    """sig (V, n) int32. Returns (work int32, coef int32, risky bool), a
    row risky when 16 r1 / r0 lies within eps of a rounding half-boundary.
    r0 and r1 are exact int64 sums rounded once to f64, as the host's are
    whenever they stay below 2^53."""
    x = sig.long()
    r0i = (x * x).sum(dim=1)
    r1i = (x[:, :-1] * x[:, 1:]).sum(dim=1)
    zero = r0i == 0
    r0 = torch.where(zero, 1, r0i).to(_F64)
    dc16 = (r1i.to(_F64) / r0) * float(1 << PREEMPHASIS_COEF_SHIFT)
    q = _round_half_away(dc16).clamp(-(1 << PREEMPHASIS_COEF_SHIFT),
                                     (1 << PREEMPHASIS_COEF_SHIFT) - 1)
    coef = torch.where(zero, 0, q.long())
    risky = (_dist_to_half(dc16) < eps) & ~zero
    prev = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    pred = wrap32(prev * coef[:, None]) >> PREEMPHASIS_COEF_SHIFT
    work = wrap32(x - pred).to(torch.int32)
    return work, coef.to(torch.int32), risky


def preemphasis_f32_sums(sig: torch.Tensor):
    """sig (V, n) int32. Returns the f32 entry's (r0, r1), (V,) f32 each:
    the exact int64 sums of x[s]^2 and x[s] x[s+1], each converted once to
    f32 (never through f64: above 2^53 that would round twice)."""
    x = sig.long()
    return ((x * x).sum(dim=1).to(torch.float32),
            (x[:, :-1] * x[:, 1:]).sum(dim=1).to(torch.float32))


def preemphasis_f32_rows(sig: torch.Tensor):
    """sig (V, n) int32. Returns (work int32, coef int32) by the f32 rule
    of ``encode._preemphasis`` on ``preemphasis_f32_sums``: the
    coefficient ``clip(round(16 r1 / max(r0, 1e-30)), -16, 15)`` in f32,
    rounding half to even, 0 where r0 < 1e-6."""
    x = sig.long()
    r0, r1 = preemphasis_f32_sums(sig)
    lim = 1 << PREEMPHASIS_COEF_SHIFT
    q = torch.clamp(torch.round(float(lim) * r1 / torch.clamp_min(r0, 1e-30)),
                    -lim, lim - 1)
    coef = torch.where(r0 < 1e-6, 0.0, q).long()
    prev = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    pred = wrap32(prev * coef[:, None]) >> PREEMPHASIS_COEF_SHIFT
    return wrap32(x - pred).to(torch.int32), coef.to(torch.int32)


def variant_preemphasis_plain(src, lshift: int, *, eps: float):
    """Plain PyTorch version of K16: the spans cut (for ``Spans``), the
    variant rows stacked and pre-emphasised. Returns (work (V, n) int32,
    coef (V,) int32, risky (V,) bool, prev (V,) int32: each row's first
    sample)."""
    sig = variant_stack(as_blocks(src), lshift)
    work, coef, risky = preemphasis_rows(sig, eps)
    return work, coef, risky, sig[:, 0].contiguous()


def variant_preemphasis_f32_plain(src, lshift: int):
    """Plain PyTorch version of K16's f32 entry: the spans cut (for
    ``Spans``), the variant rows stacked and pre-emphasised by the f32
    rule. Returns (work (V, n) int32, coef (V,) int32, prev (V,) int32)."""
    sig = variant_stack(as_blocks(src), lshift)
    work, coef = preemphasis_f32_rows(sig)
    return work, coef, sig[:, 0].contiguous()


def _layout(src, what: str):
    """Where the samples of ``src`` lie on the card: (tensor, first element,
    offsets on the card or None, block stride, channel stride, B, C, n)."""
    data = src.file if isinstance(src, Spans) else src
    if data.dtype not in (torch.int16, torch.int32):
        raise ValueError(f"{what}: the samples must be int16 or int32, got "
                         f"{data.dtype}")
    first = 0
    if isinstance(src, Spans):
        data = data.contiguous()
        B, C, n = src.shape
        offs, cstride = src.offsets, data.shape[1]
        step = int(offs[1] - offs[0]) if B > 1 else 0
        if (np.diff(offs) == step).all():
            # Evenly spaced spans (a group of fixed-size blocks): read at
            # a block stride from the first, no offsets uploaded.
            off, bstride, first = None, step, int(offs[0]) if B else 0
        else:
            # From pinned memory the copy is queued on the current stream
            # without waiting for the card (a pageable one waits).
            off = torch.from_numpy(offs).pin_memory().to(data.device,
                                                         non_blocking=True)
            bstride = 0
    else:
        if data.dim() != 3:
            raise ValueError(f"{what}: blocks must be (B, C, n), got "
                             f"{tuple(data.shape)}")
        # Any block and channel strides (a view of cut spans, say); the
        # samples of a row must be consecutive.
        if data.stride(2) != 1:
            data = data.contiguous()
        B, C, n = data.shape
        off, bstride, cstride = None, data.stride(0), data.stride(1)
    return data, first, off, bstride, cstride, B, C, n


def variant_preemphasis(src, lshift: int, *, eps: float):
    """The pre-emphasised variant rows of a group of B blocks of n samples.

    src: a (B, C, n) int16/int32 block tensor (any block and channel
    strides), or ``Spans`` of a resident (C, N) int16/int32 file. Returns
    (work (V, n) int32, coef (V,) int32, risky (V,) bool, prev (V,) int32),
    V = (C + 2) * B for C >= 2 and B for C = 1, row v * B + b variant v of
    block b.

    CUDA tensors go through the kernel (``variant_preemphasis.launches``
    counts its launches); CPU tensors go through
    ``variant_preemphasis_plain``. Evenly spaced ``Spans`` (a group of
    fixed-size blocks) are read at a block stride from the first; other
    offsets go up from pinned memory, queued on the current stream.
    """
    dev = src.device
    if dev.type == "cpu":
        return variant_preemphasis_plain(src, lshift, eps=eps)
    if dev.type != "cuda":
        raise ValueError(f"variant_preemphasis: no kernel for device {dev}")
    data, first, off, bstride, cstride, B, C, n = _layout(
        src, "variant_preemphasis")
    V = (C + 2 if C >= 2 else 1) * B
    work = torch.empty((V, n), dtype=torch.int32, device=dev)
    # coef and prev from one allocation (apart from the rows, which the
    # encode frees before it fetches them).
    coef, prev = torch.empty((2, V), dtype=torch.int32, device=dev)
    risky = torch.empty(V, dtype=torch.bool, device=dev)
    if V == 0 or n == 0:
        return work, coef, risky, prev
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.srla_preemphasis(
        data.data_ptr() + first * data.element_size(),
        None if off is None else off.data_ptr(), bstride,
        cstride, B, C, n, lshift, PREEMPHASIS_COEF_SHIFT, float(eps),
        int(data.dtype == torch.int32), work.data_ptr(), coef.data_ptr(),
        risky.data_ptr(), prev.data_ptr(), stream)
    build.check(err, "preemphasis")
    variant_preemphasis.launches += 1
    return work, coef, risky, prev


variant_preemphasis.launches = 0


def variant_preemphasis_f32(src, lshift: int):
    """K16's f32 entry: the variant rows of a group of B blocks of n
    samples, pre-emphasised by the f32 rule of the approximate encode.

    src as for ``variant_preemphasis`` (a (V, n) row tensor goes as the
    (V, 1, n) view of V one-channel blocks at lshift 0). Returns (work
    (V, n) int32, coef (V,) int32, prev (V,) int32: each row's first
    sample), rows ordered as ``variant_preemphasis`` orders them.

    CUDA tensors go through the kernel (``variant_preemphasis_f32.launches``
    counts its launches); CPU tensors go through
    ``variant_preemphasis_f32_plain``.
    """
    dev = src.device
    if dev.type == "cpu":
        return variant_preemphasis_f32_plain(src, lshift)
    if dev.type != "cuda":
        raise ValueError(f"variant_preemphasis_f32: no kernel for device "
                         f"{dev}")
    data, first, off, bstride, cstride, B, C, n = _layout(
        src, "variant_preemphasis_f32")
    V = (C + 2 if C >= 2 else 1) * B
    work = torch.empty((V, n), dtype=torch.int32, device=dev)
    coef, prev = torch.empty((2, V), dtype=torch.int32, device=dev)
    if V == 0 or n == 0:
        return work, coef, prev
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.srla_preemphasis_f32(
        data.data_ptr() + first * data.element_size(),
        None if off is None else off.data_ptr(), bstride, cstride, B, C, n,
        lshift, PREEMPHASIS_COEF_SHIFT, int(data.dtype == torch.int32),
        work.data_ptr(), coef.data_ptr(), prev.data_ptr(), stream)
    build.check(err, "preemphasis_f32")
    variant_preemphasis_f32.launches += 1
    return work, coef, prev


variant_preemphasis_f32.launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("preemphasis")
    fn = lib.srla_preemphasis
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong] + [ctypes.c_int] * 5 \
            + [ctypes.c_double, ctypes.c_int] + [ctypes.c_void_p] * 5
        f32 = lib.srla_preemphasis_f32
        f32.restype = ctypes.c_int
        f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_longlong] + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p] * 4
    return lib
