"""K6, the bit-field placement probes: three ways to put disjoint fields
into 32-bit words.

Twin of the Pallas kernel of ``tools/mosaic_repro.py`` (``_run``, with its
bodies ``_dot_kernel``, ``_rmw_kernel`` and ``_mask_kernel``), with a
leading row count R written out as a batch dimension: row r places its C
codewords ``vals[r, c] << shift[r, c]`` into W words at ``word[r, c]``.

``place_dot``, ``place_rmw`` and ``place_mask`` launch the hand-written
kernels of ``csrc/bitfield_probe.cu`` on CUDA tensors (each counts its
launches in ``.launches``) and run their plain PyTorch versions,
``place_dot_plain``, ``place_rmw_plain`` and ``place_mask_plain``, on CPU
tensors. The result is (R, W) int32: the words' bit patterns, negative
where bit 31 is set, as in JAX. A shift outside 0..31 places 0 (XLA's
shift); a word outside 0..W-1 places nothing.

``place_scatter_add`` is the one-call PyTorch yardstick of the same
function (the fields are disjoint, so a sum equals an OR). It is timed by
``chip_smoke.py`` and called nowhere in the port.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .lpc import _MASK32, wrap32

# Shared memory of one block on an H100 (bytes): rmw's row of W words
# must fit it.
_MAX_SMEM = 232448


def _fields(vals, shift) -> torch.Tensor:
    """vals << shift as int64 in [0, 2^32), 0 where the shift is outside
    0..31."""
    s = shift.long()
    ok = (s >= 0) & (s < 32)
    return torch.where(ok, ((vals.long() & _MASK32) << s.clamp(0, 31))
                       & _MASK32, 0)


def place_dot_plain(vals, word, shift, W: int) -> torch.Tensor:
    """The one-hot product: (R, 1, C) fields times an (R, C, W) one-hot of
    the words. f64 is exact here (a column sums at most C fields < 2^32)."""
    onehot = word.long()[:, :, None] == torch.arange(W, device=word.device)
    prod = torch.bmm(_fields(vals, shift).double()[:, None, :],
                     onehot.double())[:, 0]
    return wrap32(prod.long() & _MASK32).to(torch.int32)


def place_rmw_plain(vals, word, shift, W: int) -> torch.Tensor:
    """The sequential read-modify-write: codeword by codeword, OR the field
    into its word (all rows at once)."""
    R, C = vals.shape
    f = _fields(vals, shift)
    w = word.long()
    out = torch.zeros((R, W + 1), dtype=torch.int64, device=vals.device)
    rows = torch.arange(R, device=vals.device)
    for c in range(C):
        wc = torch.where((w[:, c] >= 0) & (w[:, c] < W), w[:, c], W)
        out[rows, wc] |= f[:, c]
    return wrap32(out[:, :W]).to(torch.int32)


def place_mask_plain(vals, word, shift, W: int) -> torch.Tensor:
    """The masked lane reduction: for each word, the sum of the fields
    whose word it is."""
    lanes = torch.arange(W, device=word.device)[None, :, None]
    hit = lanes == word.long()[:, None, :]                     # (R, W, C)
    out = torch.where(hit, _fields(vals, shift)[:, None, :], 0).sum(dim=2)
    return wrap32(out & _MASK32).to(torch.int32)


def place_scatter_add(vals, word, shift, W: int) -> torch.Tensor:
    """One PyTorch call for the same words: scatter_add_ of the fields.
    ``word`` must already be int64 (scatter's index type), and every word
    must lie in 0..W-1 and every shift in 0..31."""
    return torch.zeros((vals.shape[0], W), dtype=torch.int32,
                       device=vals.device).scatter_add_(1, word,
                                                        vals << shift)


def _check(what: str, vals, word, shift, W: int) -> None:
    """Raise unless vals, word and shift are contiguous int32 (R, C)
    tensors on one device and W fits the kernels."""
    if vals.dim() != 2:
        raise ValueError(f"{what}: vals must be 2-D (R, C), got shape "
                         f"{tuple(vals.shape)}")
    for name, t in (("vals", vals), ("word", word), ("shift", shift)):
        build.check_arg(what, name, t, tuple(vals.shape), vals.device)
    if not 1 <= W <= _MAX_SMEM // 4:
        raise ValueError(f"{what}: W={W} outside 1..{_MAX_SMEM // 4}")


def _place(what: str, entry: str, plain, vals, word, shift, W: int):
    """Check the arguments, then run ``plain`` on CPU tensors or launch the
    C entry ``entry`` on CUDA tensors. Returns (words, launched)."""
    _check(what, vals, word, shift, W)
    if vals.device.type == "cpu":
        return plain(vals, word, shift, W), False
    if vals.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {vals.device}")
    R, C = vals.shape
    out = torch.empty((R, W), dtype=torch.int32, device=vals.device)
    if R == 0:
        return out, False
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    err = getattr(_lib(), entry)(vals.data_ptr(), word.data_ptr(),
                                 shift.data_ptr(), out.data_ptr(), R, C, W,
                                 stream)
    build.check(err, what)
    return out, True


def place_dot(vals, word, shift, W: int) -> torch.Tensor:
    """vals, word, shift (R, C) int32 -> (R, W) int32, the one-hot product
    (``_dot_kernel``). CUDA tensors launch the kernel, CPU tensors run
    ``place_dot_plain``."""
    out, launched = _place("place_dot", "srla_place_dot", place_dot_plain,
                           vals, word, shift, W)
    place_dot.launches += launched
    return out


def place_rmw(vals, word, shift, W: int) -> torch.Tensor:
    """As ``place_dot``, by read-modify-write OR (``_rmw_kernel``)."""
    out, launched = _place("place_rmw", "srla_place_rmw", place_rmw_plain,
                           vals, word, shift, W)
    place_rmw.launches += launched
    return out


def place_mask(vals, word, shift, W: int) -> torch.Tensor:
    """As ``place_dot``, by masked lane reduction (``_mask_kernel``)."""
    out, launched = _place("place_mask", "srla_place_mask",
                           place_mask_plain, vals, word, shift, W)
    place_mask.launches += launched
    return out


place_dot.launches = 0
place_rmw.launches = 0
place_mask.launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("bitfield_probe")
    for entry in ("srla_place_dot", "srla_place_rmw", "srla_place_mask"):
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
                + [ctypes.c_void_p]
    return lib
