"""K17: the bit accounting and the stereo selection of the encode.

``select_blocks`` is the twin of ``srla_tpu.kernels.exact._account_bits_dev``
(:1317) and the selection of ``encode_blocks_exact`` (:1373-1411): from the
analysis' per-variant section bits, orders, coefficients, flags and LTP
periods to each block's stereo method, rounded bits, raw-fallback and risky
masks, each (block, channel)'s chosen variant row, its packed section
length in words and the running sum of those lengths (the words where K5
puts each section). ``measure_blocks`` is the measurement's half (the -V
search's rounded block bits of the best method and the risky mask,
``srla_tpu/encoder.py:2020-2032``). On CUDA tensors both launch the
hand-written kernel ``csrc/select.cu``; on CPU tensors they run
``select_blocks_plain`` and ``measure_blocks_plain``: ``account_bits``,
``method_lengths``, ``select_rows`` and ``section_starts``, the PyTorch
code the encode ran before the kernel.

``small`` is a dict of the analysis' per-variant tensors: ``section_bits``
(V,) int32 or int64, ``orders`` (V,) int32, ``coefs`` (V, >= M) int32
reversed and left-aligned, ``ltp_period`` (V,) int32 and ``ltp_coefs``
(V, L) (its width is the LTP order), and optionally ``risky`` (V,) bool;
``rice_risky`` (V,) bool, when given, is ORed into it (the accounting's
first step). Rows are variant-major: row v * B + b is variant v of block b.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..constants import (LPC_COEFFICIENT_ORDER_BITWIDTH,
                         LTP_COEFFICIENT_BITWIDTH, LTP_ORDER_BITWIDTH,
                         LTP_PERIOD_BITWIDTH, PREEMPHASIS_COEF_SHIFT,
                         RSHIFT_LPC_COEFFICIENT_BITWIDTH)
from ..huffman import parameter_codebook, sum_parameter_codebook
from . import build
from .bitpack import section_stream, zigzag
from .lpc import wrap32


@lru_cache(maxsize=None)
def _huffman_len_tables():
    return (np.asarray(parameter_codebook().lengths, np.int64),
            np.asarray(sum_parameter_codebook().lengths, np.int64))


def fixed_bits(bps: int) -> int:
    """A variant's header bits that do not depend on its analysis."""
    return (bps + 1 + (PREEMPHASIS_COEF_SHIFT + 1)
            + LPC_COEFFICIENT_ORDER_BITWIDTH
            + RSHIFT_LPC_COEFFICIENT_BITWIDTH + 1 + 1)


def ltp_field_bits(ltp_order: int) -> int:
    """The LTP fields of a row with a period."""
    return (LTP_ORDER_BITWIDTH + LTP_PERIOD_BITWIDTH
            + ltp_order * LTP_COEFFICIENT_BITWIDTH)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def account_bits(sec_bits, orders, coefs, bps: int, ltp_period,
                 ltp_order: int):
    """Exact per-variant code length (everything but the stereo method
    field) and the direct-vs-summed coefficient choice: the twin of
    ``exact._account_bits_dev`` plus the LTP fields of the rows with a
    period (``encode_blocks_exact:1376-1380``). coefs (V, M) reversed,
    left-aligned; ltp_period (V,) (0: no LTP fields). Returns (code_len
    (V,) int64, use_sum (V,) bool)."""
    dev = coefs.device
    pl, sl = _huffman_len_tables()
    plens = torch.from_numpy(pl).to(dev)
    slens = torch.from_numpy(sl).to(dev)
    M = coefs.shape[1]
    orders = orders.long()
    mask = torch.arange(M, device=dev)[None, :] < orders[:, None]
    uvc = zigzag(coefs).clamp(max=255)
    coef_cost = torch.where(mask, plens[uvc], 0).sum(dim=1)
    suv = zigzag(wrap32(coefs[:, 1:].long() + coefs[:, :-1].long()))
    smask = mask[:, 1:]
    svalid = (~smask | (suv < 256)).all(dim=1)
    sum_cost = plens[uvc[:, 0]] + torch.where(
        smask, slens[suv.clamp(max=255)], 0).sum(dim=1)
    use_sum = (orders > 0) & svalid & ((orders == 1)
                                       | (sum_cost < coef_cost))
    coef_bits = torch.where(orders > 0,
                            torch.where(use_sum, sum_cost, coef_cost), 0)
    ltp_bits = torch.where(ltp_period > 0, ltp_field_bits(ltp_order), 0)
    return sec_bits.long() + fixed_bits(bps) + coef_bits + ltp_bits, use_sum


def method_lengths(small: dict, *, B: int, C: int, max_params: int,
                   bps: int):
    """Each block's code length under each stereo method (NONE, MS, LS, SR
    for C >= 2; one row for C = 1), everything but the method field and the
    byte rounding, and the variants' coefficient choice. The LTP order is
    the width of small["ltp_coefs"] (its periods are all 0 without -P).
    Returns ((4 or 1, B) int64, use_sum (V,) bool)."""
    nvar = C + 2 if C >= 2 else 1
    code_len, use_sum = account_bits(
        small["section_bits"], small["orders"],
        small["coefs"][:, :max(max_params, 1)], bps, small["ltp_period"],
        small["ltp_coefs"].shape[1])
    cl = code_len.reshape(nvar, B)
    if C >= 2:
        cl = torch.stack([cl[2] + cl[3], cl[0] + cl[1], cl[2] + cl[1],
                          cl[3] + cl[1]])
    return cl, use_sum


def select_rows(small: dict, *, B: int, C: int, n: int, bps: int, W: int,
                max_params: int) -> dict:
    """Stereo method (first minimum wins, as jnp.argmin), rounded block
    bits, raw-fallback and risky block masks, the chosen variant row of
    each (block, channel), and the packed section lengths in words:
    ``encode_blocks_exact``'s selection (:1373-1411). Rows r = block*C +
    channel; a zero ``lens_w`` row is not packed (raw fallback, risky
    block, or a section above W words)."""
    dev = small["orders"].device
    nvar = C + 2 if C >= 2 else 1
    lens, use_sum = method_lengths(small, B=B, C=C, max_params=max_params,
                                   bps=bps)
    bi = torch.arange(B, device=dev)[:, None]
    ci = torch.arange(C, device=dev)[None, :]
    method = lens.argmin(dim=0)
    bits = lens.gather(0, method[None, :])[0]
    if C >= 2:
        m = method[:, None]
        vix = torch.where((m == 1) & (ci < 2), ci,
                          torch.where(((m == 2) & (ci == 1))
                                      | ((m == 3) & (ci == 0)), 1, 2 + ci))
    else:
        vix = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    bits = ((bits + 2 + 7) // 8) * 8
    raw_blk = bits >= bps * n * C
    risky_blk = small["risky"].reshape(nvar, B).any(dim=0)
    rows = (vix * B + bi).reshape(-1)
    sec = small["section_bits"].long()[rows]
    skip = ((raw_blk | risky_blk)[:, None]
            | (sec.reshape(B, C) > W * 32)).reshape(-1)
    lens_w = torch.where(skip, 0, (sec + 31) // 32)
    return dict(method=method, bits=bits, raw_blk=raw_blk,
                risky_blk=risky_blk, use_sum=use_sum, rows=rows, skip=skip,
                lens_w=lens_w)


def section_starts(lens_w: torch.Tensor) -> torch.Tensor:
    """The first word of each row's section in the compacted buffer: the
    running sum of the previous rows' lens_w."""
    return torch.cumsum(lens_w, dim=0) - lens_w


def chosen_sections(big: dict, sel: dict, n: int, cap_w: int) -> tuple:
    """``bitpack.pack_residual_sections``' arguments for the chosen rows
    gathered: their zigzag residuals (big["u"]: int64 codes or int32 bit
    patterns) and Rice choices, compacted in row order into a buffer of
    cap_w words; skipped rows have lens_w 0 and contribute nothing. The
    encode hands K5 the rows' indices instead (``pack_residual_sections``'
    ``rows``)."""
    rows, lens_w = sel["rows"], sel["lens_w"]
    return (big["u"][rows], big["code_type"][rows], big["porder"][rows],
            big["ks"][rows], n, section_starts(lens_w), lens_w, cap_w)


def chosen_stream(big: dict, sel: dict, n: int):
    """The chosen rows' codeword stream at absolute bit offsets in the
    compacted buffer. Returns (offsets, tails, tbits) (K, 2 + MAXP + n)
    int64: what the generic ``bitpack.pack`` takes."""
    return section_stream(*chosen_sections(big, sel, n, 0)[:7])


def _merged_risky(small: dict, rice_risky):
    risky = small.get("risky")
    if risky is None:
        risky = torch.zeros(small["orders"].shape[0], dtype=torch.bool,
                            device=small["orders"].device)
    return risky if rice_risky is None else risky | rice_risky


def select_blocks_plain(small: dict, *, B: int, C: int, n: int, bps: int,
                        W: int, max_params: int, rice_risky=None) -> dict:
    """Plain PyTorch version of K17's encode entry: ``select_rows`` on the
    merged flags, ``section_starts``, and the merged flags as ``risky``."""
    risky = _merged_risky(small, rice_risky)
    sel = select_rows(dict(small, risky=risky), B=B, C=C, n=n, bps=bps, W=W,
                      max_params=max_params)
    sel["starts"] = section_starts(sel["lens_w"])
    sel["risky"] = risky
    return sel


def measure_blocks_plain(small: dict, *, B: int, C: int, bps: int,
                         max_params: int, rice_risky=None) -> dict:
    """Plain PyTorch version of K17's measurement entry: each block's
    rounded bits under its best stereo method, its risky mask and the
    merged row flags."""
    risky = _merged_risky(small, rice_risky)
    lens, _ = method_lengths(small, B=B, C=C, max_params=max_params, bps=bps)
    return dict(bits=((lens.min(dim=0).values + 2 + 7) // 8) * 8,
                risky_blk=risky.reshape(-1, B).any(dim=0), risky=risky)


# ---------------------------------------------------------------------------
# The kernel's entries
# ---------------------------------------------------------------------------

_TABLES: dict = {}
_SCAN: dict = {}
# The starts buffer is made for at least this many blocks (the encoder's
# MAX_CALL_BLOCKS), so the encode's calls never grow it.
_SCAN_BLOCKS = 2048


def _tables(dev) -> torch.Tensor:
    """The two Huffman length tables, 512 int32 on ``dev``, made once a
    device."""
    key = str(dev)
    if key not in _TABLES:
        pl, sl = _huffman_len_tables()
        _TABLES[key] = torch.from_numpy(
            np.concatenate([pl, sl]).astype(np.int32)).to(dev)
    return _TABLES[key]


def _scan(dev, B: int) -> torch.Tensor:
    """The encode entry's starts buffer on ``dev`` (each CTA's status word
    and aggregate, tagged by a generation the kernel keeps in the buffer's
    first word): zeroed once when made, and made again, larger, only for a
    call of more blocks than it holds. The launches on a device share it,
    so they must be ordered: the port launches them on the current stream
    of the encoding thread."""
    need = _lib().srla_select_scan_words(max(B, _SCAN_BLOCKS))
    key = str(dev)
    buf = _SCAN.get(key)
    if buf is None or buf.numel() < need:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("select_blocks: make the starts buffer "
                               "(one call outside the CUDA graph) before "
                               "capturing a call of this size")
        buf = torch.zeros(need, dtype=torch.int64, device=dev)
        _SCAN[key] = buf
    return buf


def _outputs(dev, B: int, C: int, V: int, measure: bool) -> dict:
    """The entry's outputs, carved from one allocation: the int64 ones
    first, then the bool ones."""
    wide = [("bits", B)]
    flags = [("risky_blk", B), ("risky", V)]
    if not measure:
        wide += [("method", B), ("rows", B * C), ("lens_w", B * C),
                 ("starts", B * C)]
        flags += [("raw_blk", B), ("use_sum", V), ("skip", B * C)]
    n64 = sum(k for _, k in wide)
    buf = torch.empty(8 * n64 + sum(k for _, k in flags), dtype=torch.uint8,
                      device=dev)
    res = {}
    for parts, data in ((wide, buf[:8 * n64].view(torch.int64)),
                        (flags, buf[8 * n64:].view(torch.bool))):
        for (name, _), t in zip(parts, data.split([k for _, k in parts])):
            res[name] = t
    return res


def _launch(small: dict, rice_risky, *, B: int, C: int, n: int, bps: int,
            W: int, max_params: int, measure: bool) -> dict:
    what = "measure_blocks" if measure else "select_blocks"
    dev = small["orders"].device
    nvar = C + 2 if C >= 2 else 1
    V = nvar * B
    if not 1 <= C <= 32:
        raise ValueError(f"{what}: C = {C} outside 1..32")
    sec = small["section_bits"]
    if sec.dtype not in (torch.int32, torch.int64) \
            or tuple(sec.shape) != (V,):
        raise ValueError(f"{what}: section_bits must be ({V},) int32 or "
                         f"int64, got {sec.dtype} {tuple(sec.shape)}")
    coefs = small["coefs"]
    M = max(max_params, 1)
    if coefs.dim() != 2 or coefs.shape[1] < M:
        raise ValueError(f"{what}: coefs must be ({V}, >= {M}), got "
                         f"{tuple(coefs.shape)}")
    build.check_arg(what, "coefs", coefs, (V, coefs.shape[1]), dev)
    build.check_arg(what, "orders", small["orders"], (V,), dev)
    build.check_arg(what, "ltp_period", small["ltp_period"], (V,), dev)
    flags = []
    for name, t in (("risky", small.get("risky")),
                    ("rice_risky", rice_risky)):
        if t is not None and (t.dtype != torch.bool or tuple(t.shape) != (V,)
                              or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous ({V},) "
                             f"bool tensor on {dev}")
        flags.append(None if t is None else t.data_ptr())
    if sec.device != dev or not sec.is_contiguous():
        raise ValueError(f"{what}: section_bits must be contiguous on {dev}")
    res = _outputs(dev, B, C, V, measure)
    if B == 0:
        return res
    scan = None if measure else _scan(dev, B)

    def ptr(key):
        return res[key].data_ptr() if key in res else None

    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.srla_select(
        sec.data_ptr(), int(sec.dtype == torch.int64),
        small["orders"].data_ptr(), coefs.data_ptr(), coefs.shape[1], M,
        flags[0], flags[1], small["ltp_period"].data_ptr(),
        _tables(dev).data_ptr(), B, C, n, bps, W, fixed_bits(bps),
        ltp_field_bits(small["ltp_coefs"].shape[1]), int(measure),
        ptr("method"), ptr("bits"), ptr("raw_blk"), ptr("risky_blk"),
        ptr("use_sum"), ptr("risky"), ptr("rows"), ptr("skip"),
        ptr("lens_w"), ptr("starts"), None if scan is None else
        scan.data_ptr(), 0 if scan is None else scan.numel(), stream)
    build.check(err, what)
    return res


def select_blocks(small: dict, *, B: int, C: int, n: int, bps: int, W: int,
                  max_params: int, rice_risky=None) -> dict:
    """K17's encode entry for a group of B blocks of C channels and n
    samples, sections of at most W words. Returns a dict of method, bits
    (B,) int64; raw_blk, risky_blk (B,) bool; use_sum, risky (V,) bool (the
    merged flags); rows, lens_w, starts (B * C,) int64 and skip (B * C,)
    bool: row r = block * C + channel takes variant row rows[r], packed at
    word starts[r] in lens_w[r] words (0: not packed).

    CUDA tensors go through the kernel (``select_blocks.launches`` counts
    its launches); CPU tensors go through ``select_blocks_plain``."""
    dev = small["orders"].device
    if dev.type == "cpu":
        return select_blocks_plain(small, B=B, C=C, n=n, bps=bps, W=W,
                                   max_params=max_params,
                                   rice_risky=rice_risky)
    if dev.type != "cuda":
        raise ValueError(f"select_blocks: no kernel for device {dev}")
    res = _launch(small, rice_risky, B=B, C=C, n=n, bps=bps, W=W,
                  max_params=max_params, measure=False)
    select_blocks.launches += 1
    return res


select_blocks.launches = 0


def measure_blocks(small: dict, *, B: int, C: int, bps: int,
                   max_params: int, rice_risky=None) -> dict:
    """K17's measurement entry for B spans of C channels. Returns a dict
    of bits (B,) int64 (the rounded bits of the best stereo method),
    risky_blk (B,) bool and risky (V,) bool (the merged flags).

    CUDA tensors go through the kernel (``measure_blocks.launches`` counts
    its launches); CPU tensors go through ``measure_blocks_plain``."""
    dev = small["orders"].device
    if dev.type == "cpu":
        return measure_blocks_plain(small, B=B, C=C, bps=bps,
                                    max_params=max_params,
                                    rice_risky=rice_risky)
    if dev.type != "cuda":
        raise ValueError(f"measure_blocks: no kernel for device {dev}")
    res = _launch(small, rice_risky, B=B, C=C, n=0, bps=bps, W=0,
                  max_params=max_params, measure=True)
    measure_blocks.launches += 1
    return res


measure_blocks.launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("select")
    fn = lib.srla_select
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 11
                       + [ctypes.c_longlong, ctypes.c_void_p])
        words = lib.srla_select_scan_words
        words.restype = ctypes.c_longlong
        words.argtypes = [ctypes.c_int]
        empty = lib.srla_select_empty
        empty.restype = ctypes.c_int
        empty.argtypes = [ctypes.c_int, ctypes.c_void_p]
    return lib
