"""K2: partitioned-Rice entropy decode of a block group from the resident
stream.

``rice_decode`` is the twin of the XLA word machine in
``srla_tpu.kernels.decode2`` (``_assemble(*_entropy_scan(
_stage_from_flat(...)))``) and decodes what ``srla_tpu.rice.decode`` reads.
On a CUDA tensor it launches the hand-written kernel ``csrc/rice_decode.cu``
(one warp per block); on a CPU tensor it runs ``rice_decode_plain``, the
PyTorch version the kernel is checked against. The stream format and the
bounds on corrupt payloads are described in the kernel's source.

Residuals are unzigzagged with a logical shift, as ``rice.decode`` and the
reference do; the XLA program shifts arithmetically, which differs only for
codeword values >= 2^31 (|residual| >= 2^30), never met in a valid stream.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_MASK32 = 0xFFFFFFFF


def be_words(words: torch.Tensor) -> torch.Tensor:
    """Raw little-endian int32 view of the stream -> the big-endian word
    values in [0, 2^32) as int64 (``decode2._byteswap32``)."""
    w = words.long() & _MASK32
    return (((w & 0xFF) << 24) | ((w & 0xFF00) << 8)
            | ((w >> 8) & 0xFF00) | (w >> 24))


class _Bits:
    """Vectorised MSB-first reads at per-block absolute bit positions; words
    past the end of the buffer read as 0."""

    def __init__(self, words: torch.Tensor):
        wb = be_words(words)
        self.nw = wb.numel()
        self.wb = torch.cat([wb, wb.new_zeros(1)])   # index nw reads 0

    def peek32(self, p: torch.Tensor) -> torch.Tensor:
        i = (p >> 5).clamp(max=self.nw)
        hi = self.wb[i]
        lo = self.wb[(i + 1).clamp(max=self.nw)]
        b = p & 31
        return ((hi << b) | (lo >> (32 - b))) & _MASK32

    def read(self, p: torch.Tensor, nbits: torch.Tensor) -> torch.Tensor:
        """nbits in 0..32 (a shift by 32 of a value < 2^32 gives 0)."""
        return self.peek32(p) >> (32 - nbits)

    def unary(self, p, end, rows):
        """For each row in ``rows``: the zeros before the next 1 bit, the
        position after that 1, and whether the 1 lies before ``end``."""
        q = torch.zeros_like(p)
        newp = p.clone()
        found = torch.zeros_like(rows)
        cur = p.clone()
        pending = rows & (cur < end)
        while bool(pending.any()):
            v = self.peek32(cur)
            # Leading zeros of a 32-bit value: frexp is exact below 2^53,
            # and v == 0 gives exponent 0, i.e. 32 zeros.
            z = 32 - torch.frexp(v.double())[1].long()
            one = cur + z
            hit = pending & (z < 32) & (one < end)
            q = torch.where(hit, one - p, q)
            newp = torch.where(hit, one + 1, newp)
            found |= hit
            pending &= ~hit & (z == 32) & (cur + 32 < end)
            cur = cur + 32
        return q, newp, found


def rice_decode_plain(words, word_start, bit_rem, n: int, C: int,
                      W: int) -> torch.Tensor:
    """Plain PyTorch version of K2: vectorised over blocks, one step per
    codeword. Returns residuals (B, C, n) int32."""
    bits = _Bits(words)
    B = word_start.numel()
    dev = words.device
    pos = word_start.long() * 32 + bit_rem.long()
    end = pos + 32 * W
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    out = torch.zeros((B, C, n), dtype=torch.int32, device=dev)

    def const(v):
        return torch.full_like(pos, v)

    for c in range(C):
        ctype = bits.read(pos, const(2))
        pos = torch.where(alive, pos + 2, pos)
        rec = ctype == 1
        live = alive & (ctype != 2)
        porder = bits.read(pos, const(10)).clamp(max=31)
        pos = torch.where(live, pos + 10, pos)
        k = bits.read(pos, const(5))
        pos = torch.where(live, pos + 5, pos)
        nsmpl = (const(n) >> porder).clamp(min=1)
        sizes = sorted(set(nsmpl[live].tolist()))
        for i in range(n):
            if i and any(i % s == 0 for s in sizes):
                at = live & (i % nsmpl == 0)
                q, newp, ok = bits.unary(pos, end, at)
                alive &= ~(at & ~ok)
                live &= ~(at & ~ok)
                at &= ok
                pos = torch.where(at, newp, pos)
                dz = (q >> 1) ^ -(q & 1)
                k = torch.where(at, (k + dz).clamp(0, 31), k)
            q, newp, ok = bits.unary(pos, end, live)
            alive &= ~(live & ~ok)
            live &= ok
            pos = torch.where(live, newp, pos)
            tw = torch.where(rec & (q == 0), k + 1, k)
            tail = bits.read(pos, tw)
            pos = torch.where(live, pos + tw, pos)
            u = torch.where(rec, tail | ((q + (q > 0).long()) << k),
                            (q << k) + tail) & _MASK32
            r = (u >> 1) ^ -(u & 1)
            out[:, c, i] = torch.where(live, r, 0).to(torch.int32)
    return out


def rice_decode(words, word_start, bit_rem, n: int, C: int,
                W: int) -> torch.Tensor:
    """words (NW,) int32: the raw stream bytes as a little-endian word view;
    word_start, bit_rem (B,) int32: each block's first residual bit is bit
    bit_rem of word word_start; W: the window, in words, that bounds a
    block's unary runs. Returns residuals (B, C, n) int32.

    CUDA tensors go through the kernel (``rice_decode.launches`` counts its
    launches); CPU tensors go through ``rice_decode_plain``.
    """
    if words.device.type == "cpu":
        return rice_decode_plain(words, word_start, bit_rem, n, C, W)
    if words.device.type != "cuda":
        raise ValueError(f"rice_decode: no kernel for device {words.device}")
    B = word_start.shape[0]
    for name, t, shape in (("words", words, (words.shape[0],)),
                           ("word_start", word_start, (B,)),
                           ("bit_rem", bit_rem, (B,))):
        build.check_arg("rice_decode", name, t, shape, words.device)
    out = torch.zeros((B, C, n), dtype=torch.int32, device=words.device)
    if B == 0 or n == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(words.device).cuda_stream
    err = lib.srla_rice_decode(words.data_ptr(), words.shape[0],
                               word_start.data_ptr(), bit_rem.data_ptr(),
                               out.data_ptr(), B, C, n, W, stream)
    build.check(err, "rice_decode")
    rice_decode.launches += 1
    return out


rice_decode.launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("rice_decode")
    fn = lib.srla_rice_decode
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
    return lib
