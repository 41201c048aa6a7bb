"""A plain SRLA stream reader and decoder in PyTorch: the benchmark's
reference.

Written from the stream format alone (upstream aikiriao/SRLA: the file
header and block framing of ``srla_encoder.c``/``srla_decoder.c``, the
parameter header, the partitioned recursive Golomb-Rice residual of
``srla_coder.c``, the static Huffman codes of ``static_huffman.c``, and the
integer synthesis: LPC, de-emphasis, the stereo inverse and the offset
shift). It imports nothing of the program under test.

Every block of every stream given is decoded in one pass: the blocks are
lanes of plain tensor operations that step through their bits in
lockstep, one field or one sample a step, so the work is a few thousand
small operations whatever the number of blocks. It runs on any torch
device. Long-term prediction (``-P``) is outside the configurations this
benchmark states, so a block that carries it is reported, not decoded.

``decode_streams(streams, device)`` returns, for each stream, its header
and its (C, N) int32 PCM, or the reason it is not a valid stream.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

from .tables import PARAMETER_FREQUENCY_TABLE, SUM_PARAMETER_FREQUENCY_TABLE

HEADER = struct.Struct(">4sIIHIIHBIB")
HEADER_SIZE = 30
FORMAT_VERSION = 10
CODEC_VERSION = 18
SYNC = 0xFFFF
COMPRESS, SILENT, RAW = 0, 1, 2
ALLZERO, RICE, RECURSIVE = 2, 0, 1
MAX_ORDER = 255
FLETCHER_CHUNK = 5802


@dataclass
class Header:
    num_channels: int
    num_samples: int
    sampling_rate: int
    bits_per_sample: int
    offset_lshift: int
    max_block: int
    preset: int


@dataclass
class Block:
    kind: int
    num_samples: int
    payload_offset: int
    payload_size: int
    checksum_ok: bool


@dataclass
class Stream:
    """A stream's framing: its header and blocks, or ``error``."""
    header: Header | None
    blocks: list
    error: str | None = None


def read_header(data: bytes) -> Header:
    if len(data) < HEADER_SIZE:
        raise ValueError("shorter than the file header")
    sig, fmt, codec, C, N, rate, bps, lshift, maxblk, preset = \
        HEADER.unpack_from(data)
    if sig != b"1249" or fmt != FORMAT_VERSION or codec != CODEC_VERSION:
        raise ValueError("not an SRLA stream of this format version")
    if C == 0 or N == 0 or rate == 0 or bps not in (8, 16, 24) \
            or lshift >= 32 or maxblk == 0 or preset >= 7:
        raise ValueError("invalid header field")
    return Header(C, N, rate, bps, lshift, maxblk, preset)


def _fletcher16(buf: np.ndarray, starts: np.ndarray,
                ends: np.ndarray) -> np.ndarray:
    """Fletcher-16 of buf[starts[i]:ends[i]] for every i, as the format
    defines it: both sums folded by (x + x // 255) & 0xFF after every
    FLETCHER_CHUNK bytes and at the end."""
    out = np.zeros(len(starts), np.int64)
    c0 = np.zeros(len(starts), np.int64)
    c1 = np.zeros(len(starts), np.int64)
    b = buf.astype(np.int64)
    g = np.arange(len(b), dtype=np.int64)
    csum = np.concatenate([[0], np.cumsum(b)])
    wsum = np.concatenate([[0], np.cumsum(b * g)])
    lo = starts.astype(np.int64).copy()
    ends = ends.astype(np.int64)
    fold = lambda x: (x + x // 255) & 0xFF  # noqa: E731
    while True:
        live = lo < ends
        if not live.any():
            break
        hi = np.minimum(lo + FLETCHER_CHUNK, ends)
        n = hi - lo
        s = csum[hi] - csum[lo]
        # sum of b[j] * (hi - j) over the chunk: each byte is added to c1
        # once for itself and once for every later byte of the chunk.
        w = hi * s - (wsum[hi] - wsum[lo])
        c1 = np.where(live, fold(c1 + n * c0 + w), c1)
        c0 = np.where(live, fold(c0 + s), c0)
        lo = np.where(live, hi, lo)
    out[:] = ((c1 << 8) | c0) & 0xFFFF
    return out


def read_stream(data: bytes) -> Stream:
    """The header and the block framing of one stream, every block's
    checksum verified. A stream whose framing is broken has ``error``."""
    try:
        header = read_header(data)
    except (ValueError, struct.error) as e:
        return Stream(None, [], str(e))
    blocks, offs, sums = [], [], []
    offset, progress = HEADER_SIZE, 0
    while progress < header.num_samples:
        if offset + 11 > len(data):
            return Stream(header, blocks, "stream ends inside the blocks")
        sync, size, checksum, kind, n = struct.unpack_from(">HIHBH", data,
                                                           offset)
        if sync != SYNC or size < 5 or offset + 6 + size > len(data):
            return Stream(header, blocks, f"bad block framing at {offset}")
        if kind not in (COMPRESS, SILENT, RAW) or n == 0:
            return Stream(header, blocks, f"bad block type at {offset}")
        blocks.append(Block(kind, n, offset + 11, size - 5, True))
        offs.append(offset)
        sums.append(checksum)
        offset += 6 + size
        progress += n
    if progress != header.num_samples:
        return Stream(header, blocks, "blocks overrun the sample count")
    if offset != len(data):
        return Stream(header, blocks, "bytes after the last block")
    if blocks:
        starts = np.asarray(offs, np.int64) + 8
        ends = np.asarray([b.payload_offset + b.payload_size
                           for b in blocks], np.int64)
        got = _fletcher16(np.frombuffer(data, np.uint8), starts, ends)
        for blk, want, have in zip(blocks, sums, got):
            blk.checksum_ok = int(want) == int(have)
    return Stream(header, blocks)


class Huffman:
    """A static Huffman code built as the format builds it: the two
    smallest counts merged first (strict <, the lower index winning),
    parents after the leaves, the first minimum on the 0 branch; zero
    counts count as 1. Decoded by one table over the longest code."""

    def __init__(self, counts):
        ns = len(counts)
        work = [max(1, int(c)) for c in counts] + [0] * ns
        kids = {}
        free = ns
        while True:
            m1 = m2 = None
            for node in range(free):
                c = work[node]
                if c <= 0:
                    continue
                if m1 is None or c < work[m1]:
                    m2, m1 = m1, node
                elif m2 is None or c < work[m2]:
                    m2 = node
            if m2 is None:
                break
            work[free] = work[m1] + work[m2]
            work[m1] = work[m2] = 0
            kids[free] = (m1, m2)
            free += 1
        codes, lengths = [0] * ns, [0] * ns
        stack = [(free - 1, 0, 0)]
        while stack:
            node, code, depth = stack.pop()
            if node < ns:
                codes[node], lengths[node] = code, depth
                continue
            stack.append((kids[node][1], (code << 1) | 1, depth + 1))
            stack.append((kids[node][0], code << 1, depth + 1))
        self.lengths = lengths
        self.bits = max(lengths)
        sym = np.full(1 << self.bits, -1, np.int64)
        ln = np.zeros(1 << self.bits, np.int64)
        for s in range(ns):
            lo = codes[s] << (self.bits - lengths[s])
            hi = (codes[s] + 1) << (self.bits - lengths[s])
            sym[lo:hi] = s
            ln[lo:hi] = lengths[s]
        self.sym = torch.from_numpy(sym)
        self.len = torch.from_numpy(ln)

    def to(self, device) -> "Huffman":
        self.sym = self.sym.to(device)
        self.len = self.len.to(device)
        return self


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to signed 32 bits (C's int32 arithmetic)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _unzigzag(u: torch.Tensor) -> torch.Tensor:
    return (u >> 1) ^ -(u & 1)


class _Bits:
    """Peeks into one byte buffer at per-lane absolute bit positions."""

    def __init__(self, buf: bytes, device):
        raw = np.frombuffer(buf + bytes(8), np.uint8).astype(np.int64)
        b = torch.from_numpy(raw).to(device)
        # The 40 bits from every byte on: any 32 bits from a bit of it.
        self.w40 = ((b[:-4] << 32) | (b[1:-3] << 24) | (b[2:-2] << 16)
                    | (b[3:-1] << 8) | b[4:])
        self.end = 8 * len(buf)
        # Leading zeros of every 16-bit value (16 for 0): exact integers.
        v = np.arange(1 << 16)
        clz = np.full(1 << 16, 16, np.int64)
        clz[1:] = 15 - np.floor(np.log2(v[1:])).astype(np.int64)
        self.clz16 = torch.from_numpy(clz).to(device)

    def peek32(self, pos: torch.Tensor) -> torch.Tensor:
        """The 32 bits from each ``pos`` on, as int64."""
        return (self.w40[pos >> 3] >> (8 - (pos & 7))) & 0xFFFFFFFF

    def read(self, pos: torch.Tensor, nbits) -> torch.Tensor:
        """``nbits`` (0..32, a tensor or an int) bits from each ``pos``."""
        return self.peek32(pos) >> (32 - nbits)

    def unary(self, pos: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
        """The zeros before the next 1 bit from each live ``pos``."""
        w = self.peek32(pos)
        empty = live & (w == 0)
        run = torch.zeros_like(pos)
        while bool(empty.any()):         # runs of 32 zeros or more
            run = run + 32 * empty
            if bool(((pos + run)[empty] > self.end).any()):
                raise ValueError("a unary code runs past the data")
            w = torch.where(empty, self.peek32(pos + run), w)
            empty = live & (w == 0)
        hi = w >> 16
        lead = torch.where(hi > 0, self.clz16[hi], 16 + self.clz16[w & 0xFFFF])
        return torch.where(live, run + lead, 0)


@dataclass
class _Lanes:
    """The COMPRESS blocks of all streams, one lane each."""
    stream: torch.Tensor      # (L,) index of the stream
    start: torch.Tensor       # (L,) first sample within its stream
    n: torch.Tensor           # (L,) samples
    bit: torch.Tensor         # (L,) absolute bit of the payload
    end_bit: torch.Tensor     # (L,) absolute bit after the payload
    lshift: torch.Tensor      # (L,) its stream's offset shift


def _parse_params(bits: _Bits, lanes: _Lanes, C: int, bps: int,
                  cb: Huffman, sum_cb: Huffman) -> dict:
    """Every lane's parameter header; ``pos`` ends at channel 0's
    residual section."""
    L = lanes.n.numel()
    dev = lanes.n.device
    pos = lanes.bit.clone()

    def take(nbits):
        nonlocal pos
        v = bits.read(pos, nbits)
        pos = pos + nbits
        return v

    method = take(2)
    pre_prev = torch.zeros(L, C, dtype=torch.long, device=dev)
    pre_coef = torch.zeros_like(pre_prev)
    for c in range(C):
        pre_prev[:, c] = _unzigzag(take(bps + 1))
        pre_coef[:, c] = _unzigzag(take(5))
    orders = torch.zeros_like(pre_prev)
    rshifts = torch.zeros_like(pre_prev)
    coefs = torch.zeros(L, C, MAX_ORDER, dtype=torch.long, device=dev)
    for c in range(C):
        orders[:, c] = take(8)
        rshifts[:, c] = take(4)
        use_sum = take(1).bool()
        o = orders[:, c]
        for i in range(int(o.max())):
            live = i < o
            table = sum_cb if i > 0 else cb
            pick = use_sum & (i > 0)
            w = bits.peek32(pos)
            s1 = cb.sym[w >> (32 - cb.bits)]
            l1 = cb.len[w >> (32 - cb.bits)]
            s2 = table.sym[w >> (32 - table.bits)]
            l2 = table.len[w >> (32 - table.bits)]
            sym = torch.where(pick, s2, s1)
            ln = torch.where(pick, l2, l1)
            v = _unzigzag(sym)
            if i > 0:
                v = torch.where(pick, _wrap32(v - coefs[:, c, i - 1]), v)
            coefs[:, c, i] = torch.where(live, v, 0)
            pos = pos + torch.where(live, ln, 0)
    ltp = torch.zeros(L, dtype=torch.bool, device=dev)
    for c in range(C):
        flag = take(1).bool()
        ltp |= flag
        # A flagged channel's fields (skipped: such a block is refused).
        order = 2 * bits.read(pos, 1) + 1
        pos = pos + torch.where(flag, 1 + 8 + 6 * order, 0)
    return dict(method=method, pre_prev=pre_prev, pre_coef=pre_coef,
                orders=orders, rshifts=rshifts, coefs=coefs, ltp=ltp,
                pos=pos)


def _residuals(bits: _Bits, pos: torch.Tensor, n: torch.Tensor,
               steps: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One channel's residual section in every lane, from ``pos``:
    (residual (L, steps) int64, the position after it, a bad-lane mask)."""
    L = n.numel()
    dev = n.device
    code = bits.read(pos, 2)
    pos = pos + 2
    coded = code != ALLZERO
    porder = torch.where(coded, bits.read(pos, 10), 0)
    pos = pos + torch.where(coded, 10, 0)
    bad = (code == 3) | (porder > 10) | ((n % (1 << porder.clamp(max=10)))
                                         != 0)
    coded &= ~bad
    porder = torch.where(bad, 0, porder)
    part = (n >> porder).clamp(min=1)
    rec = code == RECURSIVE
    # The steps at which some lane starts a partition (host-side, once).
    lens = sorted(set(part[coded].tolist()))
    last = int(n[coded].max()) if lens else 0
    k = torch.zeros(L, dtype=torch.long, device=dev)
    out = torch.zeros(L, steps, dtype=torch.long, device=dev)
    zero = torch.zeros_like(pos)
    for i in range(min(steps, last)):
        live = coded & (i < n)
        if i == 0:
            k = torch.where(live, bits.read(pos, 5), k)
            pos = pos + torch.where(live, 5, 0)
        elif any(i % m == 0 for m in lens):
            first = live & ((i % part) == 0)
            run = bits.unary(pos, first)
            pos = pos + torch.where(first, run + 1, 0)
            k = torch.where(first, k + _unzigzag(run), k)
            bad |= first & ((k < 0) | (k > 31))
        kk = k.clamp(0, 31)
        q = bits.unary(pos, live)
        pos = pos + torch.where(live, q + 1, zero)
        nread = kk + (rec & (q == 0))
        val = bits.read(pos, nread)
        pos = pos + torch.where(live, nread, zero)
        u = torch.where(rec, val | ((q + (q > 0)) << kk), (q << kk) + val)
        out[:, i] = torch.where(live, _unzigzag(u), zero)
    return out, pos, bad


def _lpc_synth(res: torch.Tensor, coefs: torch.Tensor, orders: torch.Tensor,
               rshifts: torch.Tensor) -> torch.Tensor:
    """Rows (R, steps) of residuals through each row's integer LPC
    synthesis: x[0] = e[0]; x[s] = e[s] + x[s-1] while s < order; then
    x[s] = e[s] - ((half + sum_j coef[j] * x[s - order + j]) >> rshift),
    every sum wrapped to 32 bits."""
    R, n = res.shape
    M = max(int(orders.max()), 1)
    # Column j of the window x[s-M .. s-1] takes coef[j - (M - order)].
    j = torch.arange(M, device=res.device)[None, :]
    col = j - (M - orders)[:, None]
    taps = torch.where(col >= 0, torch.gather(coefs[:, :M], 1,
                                              col.clamp(min=0)), 0)
    half = torch.where(rshifts > 0, 1 << (rshifts - 1).clamp(min=0),
                       1 << 31)
    x = torch.zeros(R, M + n, dtype=torch.long, device=res.device)
    x[:, M:] = res
    active = orders > 0
    for s in range(1, n):
        acc = (x[:, s:s + M] * taps).sum(dim=1)
        pred = _wrap32(acc + half) >> rshifts
        cur, prev = x[:, M + s], x[:, M + s - 1]
        new = torch.where(s < orders, cur + prev, cur - pred)
        x[:, M + s] = torch.where(active, _wrap32(new), cur)
    return x[:, M:]


def _deemphasis(x: torch.Tensor, coef: torch.Tensor,
                prev: torch.Tensor) -> torch.Tensor:
    """y[i] = x[i] + ((y[i-1] * coef) >> 4), y[-1] = prev, in int32."""
    y = x.clone()
    last = prev
    for i in range(x.shape[1]):
        last = _wrap32(x[:, i] + (_wrap32(last * coef) >> 4))
        y[:, i] = last
    return y


def block_table(streams: list[bytes], device) -> list[list[tuple]]:
    """For each stream, (samples, payload bytes, channel orders, stereo
    method) of each COMPRESS block, from the parameter headers alone."""
    out = [[] for _ in streams]
    framed = [read_stream(s) for s in streams]
    rows, bases, base = [], [], 0
    for i, (s, f) in enumerate(zip(streams, framed)):
        bases.append(base)
        base += len(s)
        if f.error is not None:
            continue
        for blk in f.blocks:
            if blk.kind == COMPRESS:
                rows.append((i, blk.num_samples, blk.payload_size,
                             8 * (bases[i] + blk.payload_offset)))
    if not rows:
        return out
    C = framed[rows[0][0]].header.num_channels
    bps = framed[rows[0][0]].header.bits_per_sample
    bits = _Bits(b"".join(streams), device)
    t = torch.tensor([r[3] for r in rows], dtype=torch.long, device=device)
    lanes = _Lanes(t, t, t, t, t, t)
    p = _parse_params(bits, lanes, C, bps,
                      Huffman(PARAMETER_FREQUENCY_TABLE).to(device),
                      Huffman(SUM_PARAMETER_FREQUENCY_TABLE).to(device))
    orders = p["orders"].cpu().numpy()
    method = p["method"].cpu().numpy()
    for (i, n, size, _), o, m in zip(rows, orders, method):
        out[i].append((n, size, tuple(int(x) for x in o), int(m)))
    return out


@dataclass
class Decoded:
    header: Header | None
    pcm: torch.Tensor | None     # (C, N) int32 on the device
    error: str | None = None


def decode_streams(streams: list[bytes], device) -> list[Decoded]:
    """Decode every stream (each its own header; all of one channel count
    and sample width in one call) -> a Decoded for each, in order."""
    framed = [read_stream(s) for s in streams]
    out: list[Decoded] = [Decoded(f.header, None, f.error) for f in framed]
    for f, d in zip(framed, out):
        if d.error is None and not all(b.checksum_ok for b in f.blocks):
            d.error = "checksum mismatch"
    good = [i for i, d in enumerate(out) if d.error is None]
    if not good:
        return out
    C = framed[good[0]].header.num_channels
    bps = framed[good[0]].header.bits_per_sample
    if any(framed[i].header.num_channels != C
           or framed[i].header.bits_per_sample != bps for i in good):
        raise ValueError("decode_streams: streams of one shape per call")
    # One buffer holds every stream; lanes address it by absolute bits.
    bases, buf, base = {}, [], 0
    for i in good:
        bases[i] = base
        buf.append(streams[i])
        base += len(streams[i])
    bits = _Bits(b"".join(buf), device)
    pcm = {i: torch.zeros(C, framed[i].header.num_samples, dtype=torch.long,
                          device=device) for i in good}
    lane_rows = []
    for i in good:
        h, at = framed[i].header, 0
        for blk in framed[i].blocks:
            if blk.kind == RAW:
                nb = bps // 8
                raw = np.frombuffer(streams[i], np.uint8,
                                    count=blk.num_samples * C * nb,
                                    offset=blk.payload_offset)
                if raw.size != blk.num_samples * C * nb \
                        or blk.payload_size < raw.size:
                    out[i].error = "short RAW block"
                    break
                u = np.zeros((blk.num_samples, C), np.int64)
                for k in range(nb):
                    u = (u << 8) | raw.reshape(-1, C, nb)[:, :, k]
                pcm[i][:, at:at + blk.num_samples] = _unzigzag(
                    torch.from_numpy(u.T.copy())).to(device)
            elif blk.kind == COMPRESS:
                lane_rows.append((i, at, blk.num_samples,
                                  8 * (bases[i] + blk.payload_offset),
                                  8 * (bases[i] + blk.payload_offset
                                       + blk.payload_size),
                                  h.offset_lshift))
            at += blk.num_samples
    lane_rows = [r for r in lane_rows if out[r[0]].error is None]
    if lane_rows:
        t = torch.tensor(lane_rows, dtype=torch.long, device=device)
        lanes = _Lanes(*t.unbind(dim=1))
        _decode_lanes(bits, lanes, framed, good, C, bps, pcm, out)
    for i in good:
        if out[i].error is None:
            out[i].pcm = pcm[i].to(torch.int32)
    return out


def _decode_lanes(bits, lanes, framed, good, C, bps, pcm, out) -> None:
    """Decode every COMPRESS lane and place it in ``pcm``; a stream with a
    bad lane gets its ``error``."""
    dev = lanes.n.device
    cb = Huffman(PARAMETER_FREQUENCY_TABLE).to(dev)
    sum_cb = Huffman(SUM_PARAMETER_FREQUENCY_TABLE).to(dev)
    p = _parse_params(bits, lanes, C, bps, cb, sum_cb)
    steps = int(lanes.n.max())
    pos = p["pos"]
    bad = p["ltp"].clone()
    rows = []
    for c in range(C):
        res, pos, b = _residuals(bits, pos, lanes.n, steps)
        bad |= b
        rows.append(res)
    bad |= pos > lanes.end_bit
    res = torch.stack(rows, dim=1).reshape(-1, steps)      # (L*C, steps)
    x = _lpc_synth(res, p["coefs"].reshape(-1, MAX_ORDER),
                   p["orders"].reshape(-1), p["rshifts"].reshape(-1))
    x = _deemphasis(x, p["pre_coef"].reshape(-1), p["pre_prev"].reshape(-1))
    x = x.reshape(-1, C, steps)
    if C >= 2:
        m = p["method"][:, None]
        a, b2 = x[:, 0], x[:, 1]
        a_ms = _wrap32(a - (b2 >> 1))
        a_new = torch.where(m == 1, a_ms, torch.where(m == 3,
                                                      _wrap32(b2 - a), a))
        b_new = torch.where(m == 1, _wrap32(b2 + a_ms),
                            torch.where(m == 2, _wrap32(b2 + a), b2))
        x = torch.stack([a_new, b_new] + [x[:, c] for c in range(2, C)],
                        dim=1)
    # The offset shift applies to COMPRESS blocks (RAW ones hold the
    # samples as they are).
    x = _wrap32(x << lanes.lshift[:, None, None])
    bad_host = bad.cpu().numpy()
    stream = lanes.stream.cpu().numpy()
    for i in np.unique(stream[bad_host]):
        out[int(i)].error = "a COMPRESS block does not decode"
    # Place each lane's first n samples at its start.
    n = lanes.n
    keep = torch.arange(steps, device=dev)[None, :] < n[:, None]
    for i in good:
        sel = (lanes.stream == i) & ~bad
        if not bool(sel.any()):
            continue
        idx = (lanes.start[sel][:, None]
               + torch.arange(steps, device=dev)[None, :])
        k = keep[sel]
        for c in range(C):
            pcm[i][c, idx[k]] = x[sel, c][k]
