"""K14: the f32 LPC analysis of the approximate encode.

``lpc_analyze_f32`` computes what ``srla_tpu.kernels.encode``'s
``_levinson`` (:67, both calls of ``_analyze_core`` :358 and :360),
``_select_order`` (:122) and ``_quantize`` (:140) compute: the f32
Levinson-Durbin recursion on each row's lags, the order of least estimated
code length, and the 8-bit quantization of the coefficients at that order.
On a CUDA tensor it launches the hand-written kernel
``csrc/lpc_analyze_f32.cu``; on a CPU tensor it runs
``lpc_analyze_f32_plain``, the PyTorch version the kernel is checked
against: ``levinson_f32``, ``select_order_f32`` and ``quantize_f32``, the
stages the tests hold to their JAX twins one by one.

The stages repeat JAX's f32 operations one for one, with two fixed choices
the kernel keeps too: gamma's sum has its own order (``gamma_sum``: the
terms a[k+2-m] ac[m], m = 1..k+2, spread over the row's ``lanes_for(M)``
lanes by m mod L, each lane adding its own in ascending m, then an xor
butterfly over the lanes; JAX sums all M+2 columns in XLA's order, the
columns past k+1 exact zero products), and every division is a true
division of two tensors (torch's CUDA division by a Python number
multiplies by its reciprocal, another rounding). On the card the kernel
equals the plain version bit for bit; against JAX the floats agree to a
few ulps times the recursion's growth and the integer decisions wherever
their float lies clear of its boundary.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import LPC_COEFFICIENT_BITWIDTH
from ..dsp.window import welch_inverse_squared_sum
from . import build

_F32 = torch.float32
SILENT = 1.1920928955078125e-07            # 2^-23 (encode.py:116)
INV_LOGE2 = float(np.float32(1.4426950408889634))
# _quantize's max_bits (encode.py:361): the shift field's range.
MAX_SHIFT_BITS = 16


def welch_inv_f32(n: int) -> float:
    """The Welch window's energy correction as the f32 _select_order uses."""
    return float(np.float32(welch_inverse_squared_sum(n)))


def lanes_for(M: int) -> int:
    """The lanes K14 gives a row of largest order M: the fewest of 8, 16
    and 32 that hold the row's M+1 coefficients in at most 9 registers a
    lane (``srla_lpc_f32``'s dispatch makes the same choice). The sum
    order of gamma depends on it (``gamma_sum``)."""
    for lanes in (8, 16, 32):
        if M + 1 <= 9 * lanes:
            return lanes
    return 32


def gamma_sum(terms: torch.Tensor, lanes: int) -> torch.Tensor:
    """gamma's f32 sum in K14's order. terms (V, T): column m holds the
    term of index m (the columns outside 1..k+2 hold +0). Lane l of the
    row's ``lanes`` adds columns l, l + lanes, ... in ascending order to a
    sum that starts at +0; then lane l adds lane l ^ s's sum for s =
    lanes/2, ..., 2, 1 (each lane's value, as IEEE addition commutes, is
    the same: lane l < s's is sums[l] + sums[l + s]). Returns (V,)."""
    V, T = terms.shape
    R = -(-T // lanes)
    terms = torch.nn.functional.pad(terms, (0, R * lanes - T))
    s = torch.zeros((V, lanes), dtype=terms.dtype, device=terms.device)
    for j in range(R):
        s = s + terms[:, j * lanes:(j + 1) * lanes]
    w = lanes // 2
    while w >= 1:
        s = s[:, :w] + s[:, w:2 * w]
        w //= 2
    return s[:, 0]


def levinson_f32(ac: torch.Tensor, M: int, orders=None):
    """``_levinson``: ac (V, M+1) f32, the ridge on lag 0. Returns (ev (V,
    M+1), the coefficients a[1..M] of each row at its ``orders`` (V, M),
    or None without orders). Silent rows (|r0| < 2^-23) get ev = r0 and
    zero coefficients. gamma is summed in K14's order over the
    ``lanes_for(M)`` lanes."""
    lanes = lanes_for(M)
    V = ac.shape[0]
    dev = ac.device
    r0 = ac[:, 0]
    safe_r0 = torch.where(r0.abs() < 1e-30, 1.0, r0)
    a = torch.zeros((V, M + 2), dtype=_F32, device=dev)
    a[:, 0] = 1.0
    a[:, 1] = -ac[:, 1] / safe_r0
    ev = torch.zeros((V, M + 1), dtype=_F32, device=dev)
    ev[:, 0] = r0
    ev[:, 1] = r0 + ac[:, 1] * a[:, 1]
    collect = orders is not None
    coefs = torch.zeros((V, M), dtype=_F32, device=dev)
    if collect:
        orders = orders.long()
        coefs[:, 0] = torch.where(orders == 1, a[:, 1], 0.0)
    terms = torch.zeros((V, M + 1), dtype=_F32, device=dev)
    for k in range(M - 1):
        # The term of index m = 1..k+2: a[k+2-m] ac[m].
        terms[:, 1:k + 3] = a[:, :k + 2].flip(1) * ac[:, 1:k + 3]
        g = gamma_sum(terms[:, :k + 3], lanes)
        evk = ev[:, k + 1]
        g = g / -torch.where(evk.abs() < 1e-30, 1.0, evk)
        ev[:, k + 2] = evk * (1.0 - g * g)
        a[:, :k + 3] = a[:, :k + 3] + g[:, None] * a[:, :k + 3].flip(1)
        if collect:
            coefs = torch.where((orders == k + 2)[:, None], a[:, 1:M + 1],
                                coefs)
    silent = (r0.abs() < SILENT)[:, None]
    ev = torch.where(silent, r0[:, None], ev)
    return ev, (torch.where(silent, 0.0, coefs) if collect else None)


def order_lengths(ev: torch.Tensor, n: int, bps: int) -> torch.Tensor:
    """_select_order's estimated code length of orders 1..M (V, M) f32: the
    Laplace entropy of each error variance times n, plus 8 bits an order."""
    M = ev.shape[1] - 1
    e = ev[:, 1:] * welch_inv_f32(n)
    mabse = 2.0 * torch.sqrt(torch.clamp_min(e, 0.0) / 2.0)
    intmean = mabse * float(1 << (bps - 1))
    rho = torch.ones_like(intmean) / (1.0 + intmean)
    invrho = torch.clamp_min(1.0 - rho, 1e-30)
    ent = -(invrho * torch.log(invrho) + rho * torch.log(rho)) \
        * INV_LOGE2 / rho
    ent = torch.where(mabse < 1e-16, 0.0, ent)
    orders_ax = torch.arange(1, M + 1, dtype=_F32, device=ev.device)
    return ent * float(n) + float(LPC_COEFFICIENT_BITWIDTH) * orders_ax


def select_order_f32(ev: torch.Tensor, n: int, bps: int, max_params: int,
                     max_fixed: bool) -> torch.Tensor:
    """``_select_order``: the first order of least estimated length (a NaN
    length counts as least, as jnp.argmin takes it); max_params at
    max_fixed. Returns (V,) int32."""
    if max_fixed:
        return torch.full((ev.shape[0],), max_params, dtype=torch.int32,
                          device=ev.device)
    length = order_lengths(ev, n, bps)
    length = torch.where(torch.isnan(length), -torch.inf, length)
    return (length.argmin(dim=1) + 1).to(torch.int32)


def quantize_f32(coefs: torch.Tensor, orders: torch.Tensor,
                 nbits: int = LPC_COEFFICIENT_BITWIDTH,
                 max_bits: int = MAX_SHIFT_BITS):
    """``_quantize``: coefs (V, M) f32 at orders (V,). Returns (intc (V, M)
    int32, rshift (V,) int32): the shift from frexp of the largest
    magnitude, then from the last coefficient to the first the rounded
    (half to even) value carrying its error forward; all 0 and the shift
    nbits for a largest magnitude <= 2^-(nbits-1)."""
    V, M = coefs.shape
    dev = coefs.device
    qmax = 1 << (nbits - 1)
    orders = orders.long()
    mask = torch.arange(M, device=dev)[None, :] < orders[:, None]
    maxabs = torch.where(mask, coefs.abs(), 0.0).amax(dim=1)
    tiny = maxabs <= 2.0 ** -(nbits - 1)
    _, ndigit = torch.frexp(torch.clamp_min(maxabs, 1e-38))
    rshift = (nbits - 1) - ndigit.long()
    rshift = torch.where((rshift >= max_bits) | (rshift < 0), max_bits - 1,
                         rshift)
    rshift = torch.where(tiny, nbits, rshift)
    # 2^rshift exactly, from its bits (rshift in 0..max_bits).
    scale = ((rshift + 127) << 23).to(torch.int32).view(_F32)
    qerr = torch.zeros(V, dtype=_F32, device=dev)
    intc = torch.zeros((V, M), dtype=torch.int32, device=dev)
    for ordi in range(M - 1, -1, -1):
        active = orders > ordi
        qe = qerr + coefs[:, ordi] * scale
        qt = torch.clamp(torch.round(qe), -qmax, qmax - 1)
        qerr = torch.where(active, qe - qt, qerr)
        ok = active & ~torch.isnan(qt) & ~tiny
        intc[:, ordi] = torch.where(ok, qt, 0.0).to(torch.int32)
    rshift = torch.where(orders > 0, rshift, 0)
    return intc, rshift.to(torch.int32)


def lpc_analyze_f32_plain(ac: torch.Tensor, n: int, bps: int, M: int,
                          max_fixed: bool):
    """Plain PyTorch version of K14: ``levinson_f32`` for the error
    variances, ``select_order_f32``, ``levinson_f32`` again to collect the
    coefficients, ``quantize_f32``. Same arguments and results as
    ``lpc_analyze_f32``."""
    ev, _ = levinson_f32(ac, M)
    orders = select_order_f32(ev, n, bps, M, max_fixed)
    _, coefs = levinson_f32(ac, M, orders)
    intc, rshifts = quantize_f32(coefs, orders)
    return orders, intc, rshifts


def lpc_analyze_f32(ac: torch.Tensor, n: int, bps: int, M: int,
                    max_fixed: bool):
    """ac (V, M+1) f32 lags with the ridge on lag 0; n the block length,
    bps the sample bits, M the largest order (1..287: the kernel holds a
    row in at most 32 lanes of 9 registers). Returns (orders (V,) int32
    in 1..M, intc (V, M) int32 quantized coefficients left-aligned, zero
    past the order, rshifts (V,) int32).

    CUDA tensors go through the kernel (``lpc_analyze_f32.launches`` counts
    its launches); CPU tensors go through ``lpc_analyze_f32_plain``."""
    if ac.device.type == "cpu":
        return lpc_analyze_f32_plain(ac, n, bps, M, max_fixed)
    dev = ac.device
    if dev.type != "cuda":
        raise ValueError(f"lpc_analyze_f32: no kernel for device {dev}")
    V = ac.shape[0]
    if M < 1 or ac.dtype != _F32 or tuple(ac.shape) != (V, M + 1) \
            or not ac.is_contiguous() or M + 1 > 9 * 32:
        raise ValueError(f"lpc_analyze_f32: ac must be a contiguous f32 "
                         f"tensor of shape (V, {M + 1}) with 1 <= M <= "
                         f"287; got {ac.dtype} {tuple(ac.shape)}")
    orders = torch.empty(V, dtype=torch.int32, device=dev)
    intc = torch.empty((V, M), dtype=torch.int32, device=dev)
    rshifts = torch.empty(V, dtype=torch.int32, device=dev)
    if V == 0:
        return orders, intc, rshifts
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.srla_lpc_f32(
        ac.data_ptr(), orders.data_ptr(), intc.data_ptr(),
        rshifts.data_ptr(), V, M, float(n), welch_inv_f32(n),
        float(1 << (bps - 1)), float(LPC_COEFFICIENT_BITWIDTH),
        LPC_COEFFICIENT_BITWIDTH, MAX_SHIFT_BITS, int(bool(max_fixed)),
        stream)
    build.check(err, "lpc_analyze_f32")
    lpc_analyze_f32.launches += 1
    return orders, intc, rshifts


lpc_analyze_f32.launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("lpc_analyze_f32")
    fn = lib.srla_lpc_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
            + [ctypes.c_float] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib
