"""K13: verify a decoded block group against a device-resident expected PCM.

``verify_blocks`` is the twin of ``srla_tpu.kernels.decode2.
verify_blocks_device``: the decode to device-resident PCM
(``SRLADecoder.decode_whole_device_resident``) checks each group's output
where it lies and fetches one flag. On a CUDA tensor it launches the
hand-written kernel ``csrc/verify.cu``; on a CPU tensor it runs
``verify_blocks_plain``, the PyTorch version the kernel is checked against.

A block's span of ``expected`` starts at ``clamp(starts[b], 0, N - n)``:
the XLA gather of the JAX program clamps its start, where indexing in torch
would raise and a CUDA load would read past the buffer.
"""

from __future__ import annotations

import ctypes

import torch

from . import build


def _check(out, expected, starts, okrows, n: int, B: int) -> None:
    """Raise ValueError unless the shapes and types are those of a group of
    B blocks of n samples and an expected (C, N) with n <= N."""
    if expected.dim() != 2 or expected.dtype != torch.int32:
        raise ValueError(f"verify_blocks: expected must be (C, N) int32, got "
                         f"{expected.dtype} {tuple(expected.shape)}")
    C, N = expected.shape
    if not 0 < n <= N:
        raise ValueError(f"verify_blocks: block length {n} outside 1..{N}")
    if out.dtype != torch.int32 or out.dim() != 3 \
            or tuple(out.shape[1:]) != (C, n) or out.shape[0] < B:
        raise ValueError(f"verify_blocks: out must be (>= {B}, {C}, {n}) "
                         f"int32, got {out.dtype} {tuple(out.shape)}")
    if starts.dtype != torch.int32 or starts.dim() != 1 \
            or starts.shape[0] < B:
        raise ValueError(f"verify_blocks: starts must be (>= {B},) int32, "
                         f"got {starts.dtype} {tuple(starts.shape)}")
    if okrows.dtype != torch.bool or okrows.dim() != 1 \
            or okrows.shape[0] < B:
        raise ValueError(f"verify_blocks: okrows must be (>= {B},) bool, "
                         f"got {okrows.dtype} {tuple(okrows.shape)}")


def verify_blocks_plain(out, expected, starts, okrows, *, n: int,
                        B: int) -> torch.Tensor:
    """Plain PyTorch version of K13: gather the clamped spans and compare.
    Returns a 0-d bool tensor on the inputs' device."""
    _check(out, expected, starts, okrows, n, B)
    N = expected.shape[1]
    s = starts[:B].long().clamp(0, N - n)
    idx = s[:, None] + torch.arange(n, device=expected.device)[None, :]
    spans = expected[:, idx].permute(1, 0, 2)            # (B, C, n)
    eq = out[:B] == spans
    return torch.where(okrows[:B, None, None], eq, True).all()


def verify_blocks(out, expected, starts, okrows, *, n: int,
                  B: int) -> torch.Tensor:
    """out (>= B, C, n) int32: a decoded group; expected (C, N) int32;
    starts (>= B,) int32: each block's first sample; okrows (>= B,) bool:
    the rows to check. Only the first B rows count. Returns a 0-d bool
    tensor on the inputs' device: true when every ok row equals its span of
    expected.

    CUDA tensors go through the kernel (``verify_blocks.launches`` counts
    its launches); CPU tensors go through ``verify_blocks_plain``.
    """
    dev = out.device
    if dev.type == "cpu":
        return verify_blocks_plain(out, expected, starts, okrows, n=n, B=B)
    if dev.type != "cuda":
        raise ValueError(f"verify_blocks: no kernel for device {dev}")
    _check(out, expected, starts, okrows, n, B)
    for name, t in (("out", out), ("expected", expected), ("starts", starts),
                    ("okrows", okrows)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"verify_blocks: {name} must be contiguous on "
                             f"{dev}, got {t.device}")
    flag = torch.ones((), dtype=torch.bool, device=dev)
    if B == 0:
        return flag
    C, N = expected.shape
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.srla_verify_blocks(out.data_ptr(), expected.data_ptr(),
                                 starts.data_ptr(), okrows.data_ptr(),
                                 flag.data_ptr(), B, C, n, N, stream)
    build.check(err, "verify_blocks")
    verify_blocks.launches += 1
    return flag


verify_blocks.launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("verify")
    fn = lib.srla_verify_blocks
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p]
    return lib
