"""A plain reference of the size an SRLA encoder's stream has: the
benchmark's check of what the encode cells' streams hold beyond their
lossless decode.

Written from the encoder's semantics (upstream aikiriao/SRLA
``srla_encoder.c``: block typing, the stereo variants and their choice, the
pre-emphasis, the Welch-windowed circular autocorrelation, Levinson-Durbin,
the order estimate, the quantization with error feedback, the FIR residual,
the partitioned Golomb-Rice parameter search and the bit accounting of the
parameter header and its static Huffman codes; the -V search's lookahead
windows, candidate spans and shortest path over their byte sizes). It
imports nothing of the program under test, and works in float64 and int64
tensor operations on any torch device.

It is not byte-exact: its sums run in another order than the format's
reference implementation (an FFT of torch's, libm's logarithms in torch),
and an odd-length block's unwritten window sample reads 0 here. So a
coefficient or a parameter at a rounding boundary may come out one step
apart, and a stream's size a few bytes apart. An encoder that leaves out
part of the work (the -V search, the order search, the compression of
blocks) differs by far more: ``stream_size`` gives the number the check
holds each stream's length against.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .srla import Huffman
from .tables import PARAMETER_FREQUENCY_TABLE, SUM_PARAMETER_FREQUENCY_TABLE

HEADER_SIZE = 30
BLOCK_HEADER = 11
PREEMPHASIS_SHIFT = 4
COEF_BITS = 8                  # an LPC coefficient's precision
ORDER_BITS = 8
RSHIFT_BITS = 4
RIDGE = 1e-5
LOG2_MAX_PARTITIONS = 10
RICE_PARAMETER_BITS = 5
FLT_EPSILON = 2.0 ** -23
OPTX = 0.5127629514437670454896078808815218508243560791015625
MLNOPTX = 0.66794162356
# The largest LPC order of each preset; preset 0 codes no coefficients.
MAX_ORDER = (0, 8, 16, 32, 64, 128, 255)
# Samples of one chunk of spans worked on at once.
CHUNK_SAMPLES = 1 << 24

@functools.lru_cache(maxsize=None)
def _huffman_lengths() -> tuple:
    return tuple(Huffman(t).lengths for t in (PARAMETER_FREQUENCY_TABLE,
                                              SUM_PARAMETER_FREQUENCY_TABLE))


def _code_lengths(device):
    """The static Huffman codes' lengths of a coefficient and of the sum of
    two neighbours, by zigzag value, as int64 tensors."""
    return tuple(torch.tensor(x, dtype=torch.int64, device=device)
                 for x in _huffman_lengths())


def _wrap32(x):
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _zigzag(x):
    """Signed 32-bit values folded to unsigned: 0, -1, 1, -2, ... ->
    0, 1, 2, 3, ..."""
    return torch.where(x < 0, -2 * x - 1, 2 * x)


def _pow2(k):
    return torch.bitwise_left_shift(torch.ones_like(k), k)


def _round_half_away(x):
    return torch.where(x >= 0, torch.floor(x + 0.5), -torch.floor(-x + 0.5))


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _welch(n: int, device) -> torch.Tensor:
    """The Welch window; an odd length's middle sample, which the format's
    encoder leaves unwritten (it holds what its work buffer held), is 0."""
    w = np.zeros(n)
    if n > 1:
        d = 4.0 * math.pow(n - 1, -2.0)
        k = np.arange(n >> 1, dtype=np.float64)
        w[:n >> 1] = (d * k) * (n - 1 - k)
        w[n - 1 - np.arange(n >> 1)] = w[:n >> 1]
    return torch.tensor(w, dtype=torch.float64, device=device)


def _inverse_squared_sum(n: int) -> float:
    m = float(n - 1)
    return (15 * (m - 1) ** 3) / (8 * m * (m - 2) * (m * m - 2 * m + 2))


def _preemphasis(x):
    """The first-order pre-emphasis of each row (int64 in, int64 out):
    its coefficient from the lag-1 correlation, x[-1] taken as x[0]."""
    r0 = (x * x).sum(1).double()
    r1 = (x[:, :-1] * x[:, 1:]).sum(1).double()
    q = _round_half_away(r1 / torch.where(r0 > 0, r0, 1.0)
                         * (1 << PREEMPHASIS_SHIFT))
    coef = torch.where(r0 >= 1e-6, q.clamp(-16, 15),
                       torch.zeros_like(q)).long()
    prev = torch.cat([x[:, :1], x[:, :-1]], 1)
    pred = _wrap32(prev * coef[:, None]) >> PREEMPHASIS_SHIFT
    return _wrap32(x - pred)


def _levinson(ac, M: int, orders=None):
    """Levinson-Durbin over rows of ``ac`` (R, M + 1): the error variance at
    every order 0..M, and with ``orders`` each row's coefficients at its
    order (R, M)."""
    R = ac.shape[0]
    ev = torch.zeros(R, M + 1, dtype=torch.float64, device=ac.device)
    a = torch.zeros(R, M + 2, dtype=torch.float64, device=ac.device)
    out = None if orders is None else torch.zeros(
        R, M, dtype=torch.float64, device=ac.device)
    r0 = ac[:, 0]
    a[:, 0] = 1.0
    a[:, 1] = -ac[:, 1] / r0
    ev[:, 0] = r0
    ev[:, 1] = r0 + ac[:, 1] * a[:, 1]
    if out is not None:
        out[:, 0] = torch.where(orders == 1, a[:, 1], out[:, 0])
    for k in range(1, M):
        gamma = -(a[:, :k + 1] * ac[:, 1:k + 2].flip(1)).sum(1) / ev[:, k]
        ev[:, k + 1] = ev[:, k] * (1.0 - gamma * gamma)
        i = torch.arange(k + 2, device=ac.device)
        a[:, :k + 2] = a[:, :k + 2] + gamma[:, None] * a[:, k + 1 - i]
        if out is not None:
            sel = orders == k + 1
            out[:, :k + 1] = torch.where(sel[:, None], a[:, 1:k + 2],
                                         out[:, :k + 1])
    silent = ac[:, 0].abs() < FLT_EPSILON
    ev = torch.where(silent[:, None], ac[:, :1], ev)
    if out is not None:
        out = torch.where(silent[:, None], torch.zeros_like(out), out)
    return ev, out


def _select_orders(ev, n: int, bps: int, M: int):
    """The order of least estimated length: the geometric entropy of the
    residual at each order's error variance, plus its coefficients."""
    mabse = 2.0 * torch.sqrt(ev[:, 1:] / 2.0)
    rho = 1.0 / (1.0 + mabse * float(1 << (bps - 1)))
    inv = 1.0 - rho
    ent = -(inv * torch.log2(inv) + rho * torch.log2(rho)) / rho
    ent = torch.where(mabse < 1e-16, torch.zeros_like(ent), ent)
    length = ent * n + COEF_BITS * torch.arange(
        1, M + 1, dtype=torch.float64, device=ev.device)
    length = torch.where(torch.isnan(length), math.inf, length)
    return length.argmin(1) + 1


def _quantize(coefs, orders, M: int):
    """Coefficients to COEF_BITS signed integers under a common right
    shift, from the last to the first, each carrying the rounding error of
    the one after it."""
    qmax = 1 << (COEF_BITS - 1)
    mask = torch.arange(M, device=coefs.device)[None, :] < orders[:, None]
    maxabs = torch.where(mask, coefs.abs(), 0.0).max(1).values
    tiny = maxabs <= 2.0 ** (-(COEF_BITS - 1))
    _, ndigit = torch.frexp(maxabs)
    rshift = (COEF_BITS - 1) - ndigit.long()
    limit = 1 << RSHIFT_BITS
    rshift = torch.where((rshift >= limit) | (rshift < 0), limit - 1, rshift)
    rshift = torch.where(tiny, COEF_BITS, rshift)
    scale = torch.ldexp(torch.ones_like(maxabs), rshift)
    q = torch.zeros(coefs.shape, dtype=torch.int64, device=coefs.device)
    err = torch.zeros_like(maxabs)
    for i in range(M - 1, -1, -1):
        on = orders > i
        qe = err + coefs[:, i] * scale
        qi = _round_half_away(qe).clamp(-qmax, qmax - 1)
        err = torch.where(on, qe - qi, err)
        q[:, i] = torch.where(on, qi, 0.0).long()
    q = torch.where(tiny[:, None], torch.zeros_like(q), q)
    return q, rshift


def _residual(y, q, orders, rshift, M: int):
    """The FIR residual: y[s] + ((sum_m q[m] y[s-1-m] + half) >> rshift)
    from the order on, the first sample as it is and first differences
    before the order; int32 arithmetic, wrapping."""
    R, n = y.shape
    yf = torch.nn.functional.pad(y.double(), (M, 0))
    acc = torch.zeros(R, n, dtype=torch.float64, device=y.device)
    for m in range(M):
        acc += q[:, m:m + 1].double() * yf[:, M - 1 - m:M - 1 - m + n]
    half = torch.where(rshift > 0, _pow2((rshift - 1).clamp(min=0)),
                       torch.full_like(rshift, 1 << 31))
    pred = _wrap32(acc.long() + half[:, None]) >> rshift[:, None]
    full = _wrap32(y + pred)
    diff = torch.cat([y[:, :1], _wrap32(y[:, 1:] - y[:, :-1])], 1)
    s = torch.arange(n, device=y.device)[None, :]
    return torch.where(s < orders[:, None], diff, full)


def _rice_bits(res, n: int):
    """Bits of each row's residual section: the code type (2 bits), then the
    least over partition orders of the parameters' and the codes' bits;
    an all-zero row takes 2 bits."""
    u = _zigzag(res)
    top = 0
    while n % (1 << (top + 1)) == 0 and top < LOG2_MAX_PARTITIONS:
        top += 1
    R = u.shape[0]
    means = [None] * (top + 1)
    means[top] = (u.view(R, 1 << top, -1).sum(2).double()
                  / (n >> top))
    for p in range(top - 1, -1, -1):
        m = means[p + 1]
        means[p] = (m[:, 0::2] + m[:, 1::2]) / 2.0
    recursive = means[0][:, 0] >= 2.0
    best = torch.full((R,), 1 << 62, dtype=torch.int64, device=u.device)
    log_optx = math.log(OPTX)
    for p in range(top + 1):
        parts, size = 1 << p, n >> p
        m = means[p]
        up = u.view(R, parts, size)
        # Plain Rice: k = round(log2(ln(OPTX) / ln(1 - rho))).
        rho = 1.0 / (1.0 + m)
        v = log_optx / torch.log(1.0 - rho)
        k = _round_half_away(torch.log2(v)).clamp(min=0)
        k = torch.where(torch.isfinite(k), k, 0.0).long()
        plain = (k + 1) * size + (up >> k[:, :, None]).sum(2)
        # Recursive Rice: k2 = floor(log2(max(1, trunc(MLNOPTX (1 + mean))))).
        g = torch.clamp(torch.trunc(MLNOPTX * (1.0 + m)), min=1.0)
        k2 = torch.frexp(g)[1].long() - 1
        d = _wrap32(up - _pow2(k2 + 1)[:, :, None])
        rec = (k2 + 2) * size + (d.clamp(min=0) >> k2[:, :, None]).sum(2)
        ks = torch.where(recursive[:, None], k2, k)
        bits = torch.where(recursive[:, None], rec, plain).sum(1)
        delta = _zigzag(ks[:, 1:] - ks[:, :-1])
        bits = (bits + delta.sum(1) + (parts - 1)
                + LOG2_MAX_PARTITIONS + RICE_PARAMETER_BITS)
        best = torch.minimum(best, bits)
    return torch.where(u.amax(1) == 0, 0, best) + 2


def _coef_bits(q, orders, M: int):
    """Bits of each row's coefficients: the Huffman code of each, or of the
    first and then of each neighbours' sum where that is shorter (and every
    sum fits the sum code's table); in the order the stream holds them."""
    plen, slen = _code_lengths(q.device)
    R = q.shape[0]
    idx = (orders[:, None] - 1 - torch.arange(M, device=q.device)[None, :])
    on = idx >= 0
    rev = torch.where(on, q.gather(1, idx.clamp(min=0)), 0)
    uv = _zigzag(rev)
    each = torch.where(on, plen[uv.clamp(max=255)], 0).sum(1)
    suv = _zigzag(rev[:, 1:] + rev[:, :-1])
    son = on[:, 1:]
    fits = (~son | (suv < 256)).all(1)
    summed = plen[uv[:, 0].clamp(max=255)] + torch.where(
        son, slen[suv.clamp(max=255)], 0).sum(1)
    use = fits & ((orders == 1) | (summed < each))
    bits = torch.where(use, summed, each)
    return torch.where(orders > 0, bits, torch.zeros(R, dtype=torch.int64,
                                                     device=q.device))


def channel_bits(x, n: int, bps: int, preset: int):
    """Code length in bits of each row of ``x`` (R, n) int64 as one channel
    of a COMPRESS block: its parameter header and its residual section."""
    M = MAX_ORDER[preset]
    y = _preemphasis(x)
    fixed = bps + 1 + (PREEMPHASIS_SHIFT + 1) + ORDER_BITS + RSHIFT_BITS \
        + 1 + 1
    if M == 0:
        return _rice_bits(y, n) + fixed
    N = _pow2_at_least(n)
    d = y.double() * 2.0 ** -(bps - 1) * _welch(n, y.device)
    spec = torch.fft.rfft(d, n=N)
    circ = torch.fft.irfft(spec.real ** 2 + spec.imag ** 2, n=N)
    ac = torch.zeros(x.shape[0], M + 1, dtype=torch.float64, device=y.device)
    L = min(M + 1, N)
    ac[:, :L] = circ[:, :L] * (float(N) / n)
    ac[:, 0] *= 1.0 + RIDGE
    ev, _ = _levinson(ac, M)
    orders = _select_orders(ev * _inverse_squared_sum(n), n, bps, M)
    _, coefs = _levinson(ac, M, orders)
    q, rshift = _quantize(coefs, orders, M)
    res = _residual(y, q, orders, rshift, M)
    return _rice_bits(res, n) + _coef_bits(q, orders, M) + fixed


def block_bytes(blocks, bps: int, preset: int) -> torch.Tensor:
    """Framed bytes of each block of ``blocks`` (B, C, n) int64, the stream's
    offset shift applied: RAW at or under the largest order or where the
    code is not shorter, SILENT where every sample is 0, else COMPRESS with
    the stereo method of fewest bits."""
    B, C, n = blocks.shape
    raw = BLOCK_HEADER + (bps * n * C) // 8
    if n <= MAX_ORDER[preset]:
        return torch.full((B,), raw, dtype=torch.int64, device=blocks.device)
    silent = (blocks == 0).flatten(1).all(1)
    if C == 2:
        left, right = blocks[:, 0], blocks[:, 1]
        side = _wrap32(right - left)
        mid = _wrap32(left + (side >> 1))
        rows = torch.cat([mid, side, left, right])
    else:
        rows = blocks.transpose(0, 1).reshape(C * B, n)
    per = max(1, CHUNK_SAMPLES // n)
    bits = torch.cat([channel_bits(rows[i:i + per], n, bps, preset)
                      for i in range(0, rows.shape[0], per)]).view(-1, B)
    if C == 2:
        m, s, l, r = bits
        total = torch.stack([l + r, m + s, l + s, r + s]).min(0).values
    else:
        total = bits.sum(0)
    total = ((total + 2 + 7) // 8) * 8
    sizes = torch.where(total >= bps * n * C, raw,
                        BLOCK_HEADER + total // 8)
    return torch.where(silent, BLOCK_HEADER, sizes)


def _offset_lshift(pcm: np.ndarray) -> int:
    bits = int(np.bitwise_or.reduce(pcm.astype(np.int64).ravel() & 0xFFFFFFFF))
    return 0 if bits == 0 else (bits & -bits).bit_length() - 1


def _span_bytes(pcm, spans, bps, preset, device) -> dict:
    """{(offset, size): framed bytes} of every span, batched by size."""
    lshift = _offset_lshift(pcm)
    x = torch.from_numpy(pcm.astype(np.int64)).to(device) >> lshift
    by_size = {}
    for off, size in spans:
        by_size.setdefault(size, []).append(off)
    out = {}
    for size, offs in by_size.items():
        per = max(1, CHUNK_SAMPLES // (4 * size))
        for i in range(0, len(offs), per):
            part = offs[i:i + per]
            idx = (torch.tensor(part, device=device)[:, None]
                   + torch.arange(size, device=device)[None, :])
            blocks = x[:, idx].transpose(0, 1)
            got = block_bytes(blocks, bps, preset).tolist()
            out.update({(o, size): g for o, g in zip(part, got)})
    return out


def stream_size(pcm: np.ndarray, bits_per_sample: int, preset: int,
                max_block: int, variable_divisions: int,
                lookahead_factor: int, device="cpu") -> int:
    """The reference's size in bytes of the stream of ``pcm`` (C, N): the
    header and every block; at -V > 0 each lookahead window's blocks are
    the partition of least bytes among spans of whole minimum blocks up to
    the largest block (the last clipped to the window)."""
    C, N = pcm.shape
    if variable_divisions == 0:
        spans = [(o, min(max_block, N - o)) for o in range(0, N, max_block)]
        got = _span_bytes(pcm, spans, bits_per_sample, preset, device)
        return HEADER_SIZE + sum(got.values())
    dmin = max_block >> variable_divisions
    la = lookahead_factor * max_block
    windows = [(o, min(la, N - o)) for o in range(0, N, la)]
    edges = []
    for wo, span in windows:
        nodes = (span + dmin - 1) // dmin + 1
        for i in range(nodes):
            for j in range(i + 1, nodes):
                if (j - i) * dmin <= max_block:
                    off = i * dmin
                    edges.append((wo, i, j, wo + off,
                                  min((j - i) * dmin, span - off)))
    got = _span_bytes(pcm, [(g, s) for *_, g, s in edges], bits_per_sample,
                      preset, device)
    total = HEADER_SIZE
    by_window = {}
    for wo, i, j, g, s in edges:
        by_window.setdefault(wo, []).append((i, j, got[(g, s)]))
    for wo, span in windows:
        nodes = (span + dmin - 1) // dmin + 1
        cost = [0] + [math.inf] * (nodes - 1)
        for i, j, c in sorted(by_window[wo]):
            cost[j] = min(cost[j], cost[i] + c)
        total += cost[-1]
    return int(total)
