"""K5 (srla_tpu_torch.kernels.bitpack: pack_residual_sections, the fused
entry of the encode, and pack, the generic one) and the codeword stream
around them against their JAX twins on JAX-CPU: pack_residual_sections
(scatter pack) and the flat buffer of encode_blocks_exact, the Pallas kernel
pallas_pack_rows in interpret mode (as tests/test_bitpack.py runs it), the
flat grouped-window pack pack_flat_stream, the scatter pack
pack_monotone_stream(impl="scatter"), _word_splits and
residual_codewords; and one section's bytes against rice.emit_channel.

The generic pack's kernel (csrc/bitpack.cu bitpack_kernel) merges the
contributions of 32 consecutive entries to one word before its atomics:
_warp_pack_model is that merge in numpy, window by window as a warp runs it,
held to pallas_pack_rows in interpret mode on shuffled rows with drops and
to pack_plain on a stream out of range (chip_smoke.k5_edge_stream); change
the kernel and the model together. On the card (marked gpu) the kernel is
held to pack_plain on the shuffled, int32 and out-of-range streams.

Every output is an integer, so every comparison is exact (tolerance 0)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from srla_tpu import rice  # noqa: E402
from srla_tpu.bitio import BitWriter, sint32_to_uint32  # noqa: E402
from srla_tpu.kernels import bitpack as jbitpack  # noqa: E402
from srla_tpu.kernels.pallas_pack import pallas_pack_rows  # noqa: E402
import chip_smoke  # noqa: E402
from srla_tpu_torch.kernels import bitpack  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _random_rows(seed=1, V=8, T=512, W=700):
    """tests/test_bitpack.py's Pallas case: per-row monotone offsets with
    random gaps, tails of exactly tbits significant bits, masked tail."""
    rng = np.random.RandomState(seed)
    tbits = rng.randint(1, 33, size=(V, T)).astype(np.int32)
    tbits[:, 500:] = 0
    lead = rng.randint(0, 5, size=(V, T))
    offs = (np.cumsum(np.where(tbits > 0, tbits + lead, 0), axis=1)
            - tbits).astype(np.int32)
    offs = np.maximum(offs, 0)
    tails = ((rng.randint(0, 2 ** 31, size=(V, T)).astype(np.uint64)
              & ((1 << np.maximum(tbits, 1).astype(np.uint64)) - 1))
             | (1 << np.maximum(tbits - 1, 0).astype(np.uint64))
             ).astype(np.uint32)
    return offs, tails, tbits, W


def _t(a, device="cpu"):
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)


def _u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


def _rice_rows(n=256, seed=7):
    """Zigzag residual rows covering plain, recursive and ALLZERO
    sections, with their host Rice choices."""
    rng = np.random.RandomState(seed)
    res = rng.laplace(0, 18, size=(6, n)).astype(np.int32)
    res[2] = 0                                       # ALLZERO
    res[3] = rng.laplace(0, 40000, size=n).astype(np.int32)   # recursive
    res[4] = rng.randint(-2, 2, size=n)
    res[5, ::16] = 1 << 22                           # long unary runs
    ct, po, _, ks = rice.analyze_batch(res, n)
    u = sint32_to_uint32(res).astype(np.uint32)
    MAXP = 1 << 8                                    # n = 256: max porder 8
    return u, ct, po, ks[:, :MAXP].astype(np.int32), n


def test_pack_plain_matches_pallas_interpret():
    offs, tails, tbits, W = _random_rows()
    want = np.asarray(pallas_pack_rows(offs, tails, tbits, W))
    for v in range(offs.shape[0]):
        got = bitpack.pack_plain(_t(offs[v]), _t(tails[v]), _t(tbits[v]), W)
        np.testing.assert_array_equal(_u32(got.numpy()), _u32(want[v]))


def test_pack_plain_matches_scatter_pack_with_drops():
    """Rows packed into a W too small for them: the words past W are
    dropped by both, including a tail that straddles word W."""
    offs, tails, tbits, _ = _random_rows(seed=3, V=4)
    W = 200
    want = np.asarray(jbitpack.pack_monotone_stream(
        jnp.asarray(offs), jnp.asarray(tails), jnp.asarray(tbits), W,
        impl="scatter"))
    assert (offs >= W * 32).any()
    for v in range(offs.shape[0]):
        got = bitpack.pack(_t(offs[v]), _t(tails[v]), _t(tbits[v]), W)
        np.testing.assert_array_equal(_u32(got.numpy()), _u32(want[v]))


def test_word_splits_match_jax():
    offs, tails, tbits, W = _random_rows(seed=5, V=2)
    tbits[0, :40] = 32                               # full-width tails
    w0, vA, vB = jbitpack._word_splits(jnp.asarray(offs), jnp.asarray(tails),
                                       jnp.asarray(tbits), W)
    pw0, pA, pB = bitpack.word_splits(_t(offs), _t(tails), _t(tbits), W)
    np.testing.assert_array_equal(pw0.numpy(), np.asarray(w0))
    np.testing.assert_array_equal(pA.numpy(), _u32(vA))
    np.testing.assert_array_equal(pB.numpy(), _u32(vB))


def test_residual_codewords_match_jax():
    u, ct, po, ks, n = _rice_rows()
    (jo, jt, jb), jtot = jbitpack.residual_codewords(
        jnp.asarray(u), jnp.asarray(ct), jnp.asarray(po), jnp.asarray(ks), n)
    (po_, pt, pb), ptot = bitpack.residual_codewords(
        _t(u), _t(ct), _t(po), _t(ks), n)
    np.testing.assert_array_equal(po_.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(pt.numpy(), _u32(jt))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ptot.numpy(), np.asarray(jtot))


def test_flat_pack_matches_pack_flat_stream():
    """Every row's section at its compacted position (one row skipped, as a
    host-repair row is): the port's one-pass pack equals JAX's flat
    grouped-window pack word for word."""
    u, ct, po, ks, n = _rice_rows()
    (offs, tails, tbits), tot = bitpack.residual_codewords(
        _t(u), _t(ct), _t(po), _t(ks), n)
    K = offs.shape[0]
    skip = torch.zeros(K, dtype=torch.bool)
    skip[1] = True
    lens_w = torch.where(skip, 0, (tot + 31) // 32)
    starts = torch.cumsum(lens_w, 0) - lens_w
    offs = torch.where(skip[:, None], 0, offs) + starts[:, None] * 32
    tbits = torch.where(skip[:, None], 0, tbits)
    cap = int(lens_w.sum()) + 8
    G = 64
    pad = (-offs.shape[1]) % G
    end = offs[:, -1:] + tbits[:, -1:]
    jo = torch.cat([offs, end.expand(K, pad)], 1).numpy().astype(np.int32)
    jt = np.pad(tails.numpy(), ((0, 0), (0, pad))).astype(np.uint32)
    jb = np.pad(tbits.numpy(), ((0, 0), (0, pad))).astype(np.int32)
    want, ovf = jbitpack.pack_flat_stream(jnp.asarray(jo), jnp.asarray(jt),
                                          jnp.asarray(jb), cap, G=G)
    assert not np.asarray(ovf).any()
    got = bitpack.pack(offs, tails, tbits, cap)
    np.testing.assert_array_equal(_u32(got.numpy()), _u32(want))


def test_section_bytes_match_emit_channel():
    u, ct, po, ks, n = _rice_rows()
    (offs, tails, tbits), tot = bitpack.residual_codewords(
        _t(u), _t(ct), _t(po), _t(ks), n)
    for v in range(u.shape[0]):
        words = bitpack.pack(offs[v], tails[v], tbits[v],
                             int(tot[v]) // 32 + 1)
        w = BitWriter()
        rice.emit_channel(w, u[v].astype(np.int64), n, int(ct[v]),
                          int(po[v]), ks[v])
        ref = w.getvalue()
        assert int(tot[v]) == w.tell_bits()
        got = words.numpy().view(np.uint32).astype(">u4").tobytes()
        assert got[:len(ref)] == ref


def test_shift_edges_pinned():
    """A 32-bit tail at bit 0 (left shift by 0), a tail spilling 31 bits into
    the next word (shift by 1), an entry at the last bit of the buffer (its
    spill dropped) and entries at or past the end (dropped)."""
    W = 3
    offs = torch.tensor([0, 33, 95, 96, 200])
    tails = torch.tensor([0xFFFFFFFF, 0xFFFFFFFF, 0b11, 0xFF, 1])
    tbits = torch.tensor([32, 32, 2, 8, 1])
    got = _u32(bitpack.pack_plain(offs, tails, tbits, W).numpy())
    np.testing.assert_array_equal(got, [0xFFFFFFFF, 0x7FFFFFFF,
                                        0x80000001])


def _shift(x, k, left):
    """uint32 x shifted by k (int64), 0 where k is outside 0..31."""
    ok = (k >= 0) & (k < 32)
    kk = np.where(ok, k, 0).astype(np.uint64)
    x = x.astype(np.uint64)
    y = ((x << kk) & 0xFFFFFFFF) if left else (x >> kk)
    return np.where(ok, y, 0).astype(np.uint64)


def _warp_pack_model(offs, tails, tbits, cap_w):
    """The generic pack as bitpack_kernel runs it: entries in windows of 32
    consecutive ones (a warp's step, a lane an entry); each entry's A (its
    first word) and B (the next word) contributions, 0-valued ones dropped;
    a B handed to the next lane's A of the same word; a segmented inclusive
    OR-scan over the lanes, taking lane i - d's value only where its word
    is lane i's; an atomicOr from the last lane of each run of equal words
    and from every B not handed on. Returns (words (cap_w,) uint32, the
    atomics issued)."""
    offs = np.asarray(offs, np.int64).reshape(-1)
    tb = np.asarray(tbits, np.int64).reshape(-1)
    tail = np.asarray(tails, np.int64).reshape(-1) & 0xFFFFFFFF
    pad = -offs.size % 32
    offs, tb, tail = (np.pad(a, (0, pad)) for a in (offs, tb, tail))
    valid = (tb > 0) & (offs >= 0) & (offs < cap_w * 32)
    width = np.minimum(tb, 65)
    w0 = offs >> 5
    sh = offs & 31
    over = np.maximum(width - (32 - sh), 0)
    keep = width - over
    va = np.where(valid & (keep > 0),
                  _shift(_shift(tail, over, False), 32 - sh - keep, True), 0)
    vb = np.where(valid & (over > 0) & (w0 + 1 < cap_w),
                  _shift(tail, 32 - over, True), 0)
    none = -1
    ka = np.where(va != 0, w0, none).reshape(-1, 32)
    kb = np.where(vb != 0, w0 + 1, none).reshape(-1, 32)
    va, vb = va.reshape(-1, 32), vb.reshape(-1, 32)
    lane = np.arange(32)

    def up(x, d):              # __shfl_up_sync: lanes below d keep theirs
        return np.concatenate([x[:, :d], x[:, :-d]], axis=1)

    ka_next = np.concatenate([ka[:, 1:], ka[:, 31:]], axis=1)
    given = (lane < 31) & (kb != none) & (kb == ka_next)
    recv = (lane > 0) & (ka != none) & (up(kb, 1) == ka)
    va = np.where(recv, va | up(vb, 1), va)
    for d in (1, 2, 4, 8, 16):
        va = np.where((lane >= d) & (up(ka, d) == ka), va | up(va, d), va)
    emit_a = (ka != none) & ((lane == 31) | (ka_next != ka))
    emit_b = (kb != none) & ~given
    out = np.zeros(cap_w, np.uint64)
    np.bitwise_or.at(out, ka[emit_a], va[emit_a])
    np.bitwise_or.at(out, kb[emit_b], vb[emit_b])
    return out.astype(np.uint32), int(emit_a.sum() + emit_b.sum())


def test_warp_model_matches_pallas_on_shuffled_rows_with_drops():
    """Rows whose tails run past W (dropped, one straddling word W) with
    their entries shuffled: the warp model equals pallas_pack_rows on the
    same rows; on the rows in order it issues one atomic for each word a
    window of 32 entries touches, and more on the shuffled rows."""
    offs, tails, tbits, _ = _random_rows(seed=13, V=8, T=512)
    W = 280
    assert (offs >= W * 32).any() and (offs < W * 32).any()
    rng = np.random.RandomState(4)
    perm = np.stack([rng.permutation(offs.shape[1]) for _ in offs])
    sh = [np.take_along_axis(a, perm, axis=1) for a in (offs, tails, tbits)]
    want = np.asarray(pallas_pack_rows(*sh, W))
    in_order = shuffled = 0
    for v in range(offs.shape[0]):
        got, atomics = _warp_pack_model(sh[0][v], sh[1][v], sh[2][v], W)
        np.testing.assert_array_equal(got, want[v])
        shuffled += atomics
        got, atomics = _warp_pack_model(offs[v], tails[v], tbits[v], W)
        np.testing.assert_array_equal(got, want[v])
        w0, va, vb = (t.numpy() for t in bitpack.word_splits(
            _t(offs[v]), _t(tails[v]), _t(tbits[v]), W))
        win = np.arange(w0.size) // 32
        touched = {(i, w) for i, w, a in zip(win, w0, va) if a and w < W}
        touched |= {(i, w + 1) for i, w, b in zip(win, w0, vb)
                    if b and w + 1 < W}
        assert atomics == len(touched)
        in_order += atomics
    assert in_order < shuffled


def test_warp_model_matches_plain_on_edge_stream():
    """The out-of-range stream of chip_smoke.py's phase 5 (negative
    offsets, offsets past cap_w, widths 0 to 2^33, shuffled) and the same
    in order: the warp model equals pack_plain word for word."""
    offs, tails, tbits, cap = chip_smoke.k5_edge_stream(np, 4000, 23)
    want = _u32(bitpack.pack_plain(_t(offs), _t(tails), _t(tbits),
                                   cap).numpy())
    got, _ = _warp_pack_model(offs, tails, tbits, cap)
    np.testing.assert_array_equal(got, want)
    order = np.argsort(offs, kind="stable")
    got, _ = _warp_pack_model(offs[order], tails[order], tbits[order], cap)
    np.testing.assert_array_equal(got, want)


def _generic_streams(device):
    """(name, (offsets, tails, tbits, cap_w)) of the generic pack on the
    card's cases: rows in order, the same shuffled, in int32, int64
    offsets with int32 tails and int64 widths, and the out-of-range
    stream."""
    offs, tails, tbits, W = _random_rows(seed=11, V=16, T=1024)
    flat = (offs + (np.arange(16) * W * 32)[:, None]).astype(np.int64)
    rows = [_t(a, device) for a in (flat, tails, tbits)]
    perm = torch.from_numpy(np.random.RandomState(9).permutation(
        flat.size)).to(device)
    edge = chip_smoke.k5_edge_stream(np, 20_000, 31)
    cap = 16 * W - 5
    return {
        "in-order": (*rows, cap),
        "shuffled": (*(t.reshape(-1)[perm] for t in rows), cap),
        "int32": (*(t.to(torch.int32) for t in rows), cap),
        "mixed-dtypes": (rows[0], rows[1].to(torch.int32), rows[2], cap),
        "out-of-range": (*(_t(a, device) for a in edge[:3]), edge[3])}


GENERIC_STREAMS = ("in-order", "shuffled", "int32", "mixed-dtypes",
                   "out-of-range")


@pytest.mark.gpu
@pytest.mark.parametrize("stream", GENERIC_STREAMS)
def test_generic_pack_streams_on_card(cuda, stream):
    args = _generic_streams(cuda)[stream]
    before = bitpack.pack.launches
    got = bitpack.pack(*args)
    torch.cuda.synchronize()
    assert bitpack.pack.launches == before + 1
    want = bitpack.pack_plain(*args)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(cuda):
    offs, tails, tbits, W = _random_rows(seed=11, V=16, T=1024)
    flat = (offs + (np.arange(16) * W * 32)[:, None]).astype(np.int64)
    args = [_t(a, cuda) for a in (flat, tails, tbits)]
    before = bitpack.pack.launches
    got = bitpack.pack(*args, 16 * W - 5)           # drops the last words
    torch.cuda.synchronize()
    assert bitpack.pack.launches == before + 1
    want = bitpack.pack_plain(*args, 16 * W - 5)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    edge = [torch.tensor(a, device=cuda) for a in
            ([0, 33, 95, 96, 200], [0xFFFFFFFF, 0xFFFFFFFF, 3, 255, 1],
             [32, 32, 2, 8, 1])]
    np.testing.assert_array_equal(
        bitpack.pack(*edge, 3).cpu().numpy(),
        bitpack.pack_plain(*edge, 3).cpu().numpy())


# ---------------------------------------------------------------------------
# pack_residual_sections: residuals to packed sections in one step
# ---------------------------------------------------------------------------

SECTION_MAXP = 1024


def _section_rows(kind, porder, n, seed=0, V=5):
    """V rows of one kind (plain Rice, recursive Rice or ALLZERO) at one
    partition order with random per-partition parameters around the rows'
    scale; row 1 is skipped (lens_w 0), and the rows lie at starts with a
    gap of three words between them."""
    rng = np.random.RandomState(seed + n + 7 * porder)
    if kind == "allzero":
        res = np.zeros((V, n), np.int64)
        ct, base = 2, 0
    elif kind == "recursive":
        res = rng.laplace(0, 4000, size=(V, n)).astype(np.int64)
        ct, base = 1, 9
    else:
        res = rng.laplace(0, 18, size=(V, n)).astype(np.int64)
        ct, base = 0, 2
    res[0, ::37] *= 50                               # long unary runs
    u = sint32_to_uint32(res.astype(np.int32)).astype(np.uint32)
    ks = np.zeros((V, SECTION_MAXP), np.int32)
    ks[:, :1 << porder] = base + rng.randint(0, 5, (V, 1 << porder))
    return (u, np.full(V, ct, np.int32), np.full(V, porder, np.int32), ks, n)


def _layout(total_bits, skip_row=1, gap=3):
    lens_w = (np.asarray(total_bits).astype(np.int64) + 31) // 32
    lens_w[skip_row] = 0
    starts = np.cumsum(lens_w + gap) - lens_w
    return starts, lens_w, int(starts[-1] + lens_w[-1] + gap)


def _max_porder(n):
    p = 0
    while n % (2 << p) == 0 and p < 10:
        p += 1
    return p


SECTION_CASES = [(kind, n, po) for kind in ("plain", "recursive", "allzero")
                 for n in (512, 480) for po in (0, _max_porder(n))]


def _owned(starts, lens_w, cap):
    mask = np.zeros(cap, bool)
    for s, l in zip(starts, lens_w):
        mask[s:s + l] = True
    return mask


@pytest.mark.parametrize("kind,n,porder", SECTION_CASES,
                         ids=[f"{k}-n{n}-p{p}" for k, n, p in SECTION_CASES])
def test_sections_plain_match_jax_pack_residual_sections(kind, n, porder):
    """Each row's words at starts[row] equal the row of JAX's (V, W) pack;
    the skipped row and the gaps between rows stay 0."""
    u, ct, po, ks, n = _section_rows(kind, porder, n)
    W = 2 * n                                        # ample: 64 bits a sample
    want, total, ovf = jbitpack.pack_residual_sections(
        jnp.asarray(u), jnp.asarray(ct), jnp.asarray(po), jnp.asarray(ks), n,
        W, impl="scatter")
    assert not np.asarray(ovf).any()
    want = _u32(want)
    starts, lens_w, cap = _layout(total)
    assert lens_w.max() <= W
    args = (_t(u), _t(ct), _t(po), _t(ks), n, _t(starts), _t(lens_w), cap)
    got = _u32(bitpack.pack_residual_sections_plain(*args).numpy())
    for r in range(u.shape[0]):
        np.testing.assert_array_equal(
            got[starts[r]:starts[r] + lens_w[r]], want[r, :lens_w[r]],
            err_msg=f"row {r}")
    assert not got[~_owned(starts, lens_w, cap)].any()
    # The wrapper takes the plain version for CPU tensors, and int32 bit
    # patterns of u give the same words.
    u32 = torch.from_numpy(u.view(np.int32))
    for uu in (args[0], u32):
        np.testing.assert_array_equal(
            _u32(bitpack.pack_residual_sections(uu, *args[1:]).numpy()), got)


def test_sections_plain_match_encode_blocks_exact_flat():
    """On JAX's own analysis of one small group, the port's fused entry
    gives the first sum(lens_w) words of encode_blocks_exact's flat buffer
    (scatter pack): the same rows at the same compacted starts."""
    import signals
    from srla_tpu.kernels.exact import (analyze_blocks_exact,
                                        encode_blocks_exact)
    from srla_tpu_torch.kernels import exact as texact
    from test_exact_device import _signals

    B, C, N, bps = 4, 2, 512, 16
    sig = _signals(2 * B, N, bps)
    blocks = np.stack([sig[:B], sig[B:]], axis=1)
    blocks[2] = signals.white_noise(N, 2, 16, seed=9)    # raw fallback
    W = (N * (bps + 4)) // 32 + 64
    kw = dict(n=N, bps=bps, max_params=32, max_fixed=False, fft_size=N,
              max_porder=_max_porder(N))
    js, jb = analyze_blocks_exact(blocks, np.int32(0), C=C, **kw)
    want, flat = encode_blocks_exact(blocks, np.int32(0), C=C, W=W,
                                     impl="scatter", **kw)
    small, big = texact.from_jax_analysis(jax.device_get(js),
                                          jax.device_get(jb), "cpu")
    sel = texact.select_rows(small, B=B, C=C, n=N, bps=bps, W=W,
                             max_params=32)
    lens_w = np.asarray(want["lens_w"])
    np.testing.assert_array_equal(sel["lens_w"].numpy(), lens_w)
    assert (lens_w == 0).any() and (lens_w > 0).any()
    got = bitpack.pack_residual_sections(
        *texact.chosen_sections(big, sel, N, B * C * W),
        section_words=W).numpy()
    total = int(lens_w.sum())
    np.testing.assert_array_equal(got[:total],
                                  np.asarray(flat).view(np.int32)[:total])
    # The generic pack of the same rows' stream gives the same words.
    np.testing.assert_array_equal(
        bitpack.pack(*texact.chosen_stream(big, sel, N), B * C * W).numpy(),
        got)


def _odd_section_rows():
    """12 rows of 512 samples at partition orders 0..9 (partitions down to
    one sample: several parameters inside a thread's run) with a full-range
    row, a zero row under a Rice type, an ALLZERO row, both code types,
    parameters 0, 30 and 31, and a skipped row."""
    V, n = 12, 512
    rng = np.random.RandomState(12)
    u = rng.randint(0, 1 << 12, (V, n)).astype(np.int64)
    ct = (np.arange(V) % 2).astype(np.int32)
    po = (np.arange(V) % 10).astype(np.int32)
    ks = rng.randint(5, 14, (V, SECTION_MAXP)).astype(np.int32)
    u[1] = rng.randint(0, 1 << 32, n)                # full range
    ks[1] = rng.randint(27, 32, SECTION_MAXP)
    u[2] = 0                                         # zeros, recursive type
    u[3], ct[3] = 0, 2                               # ALLZERO
    ks[4] = 0                                        # long unary leads
    u[4] = rng.randint(0, 40, n)
    u[5] = rng.randint(0, 1 << 32, n)
    ks[5] = 30
    u[6] = rng.randint(0, 1 << 32, n)
    ks[6] = 31
    u[7] = rng.randint(0, 1 << 32, n)
    ks[7] = 31                                       # recursive at k = 31
    po[8], po[9] = 9, 9                              # one sample a partition
    ks[9] = rng.randint(0, 32, SECTION_MAXP)         # deltas of up to 31
    u[9] = rng.randint(0, 1 << 8, n)
    return u, ct, po, ks, n


def _plain_layout(u, ct, po, ks, n, skip_row):
    (_, _, _), tot = bitpack.residual_codewords(_t(u), _t(ct), _t(po),
                                                _t(ks), n)
    return _layout(tot.numpy(), skip_row=skip_row)


def test_sections_plain_odd_rows_match_emit_channel():
    """The odd rows' sections against the host bit writer, row by row
    (but for recursive rows at k = 31, where the device's 2^(k+1) wraps to
    0 and the host's does not: no encode chooses them)."""
    u, ct, po, ks, n = _odd_section_rows()
    starts, lens_w, cap = _plain_layout(u, ct, po, ks, n, skip_row=10)
    got = bitpack.pack_residual_sections_plain(
        _t(u), _t(ct), _t(po), _t(ks), n, _t(starts), _t(lens_w), cap)
    data = got.numpy().view(np.uint32).astype(">u4").tobytes()
    for v in range(u.shape[0]):
        if not lens_w[v] or (ct[v] == 1
                             and (ks[v, :1 << po[v]] == 31).any()):
            continue
        w = BitWriter()
        rice.emit_channel(w, u[v], n, int(ct[v]), int(po[v]), ks[v])
        ref = w.getvalue()
        assert (w.tell_bits() + 31) // 32 == lens_w[v]
        sec = data[4 * starts[v]:4 * (starts[v] + lens_w[v])]
        assert sec[:len(ref)] == ref, v
        assert not any(sec[len(ref):]), v


def _assert_kernel_matches_plain(cuda, u, ct, po, ks, n, starts, lens_w, cap,
                                 **kw):
    args = [_t(a, cuda) for a in (u, ct, po, ks)]
    lay = [_t(starts, cuda), _t(lens_w, cuda)]
    before = bitpack.pack_residual_sections.launches
    got = bitpack.pack_residual_sections(*args, n, *lay, cap, **kw)
    torch.cuda.synchronize()
    assert bitpack.pack_residual_sections.launches == before + 1
    want = bitpack.pack_residual_sections_plain(*args, n, *lay, cap)
    own = _owned(starts, lens_w, cap)
    np.testing.assert_array_equal(got.cpu().numpy()[own],
                                  want.cpu().numpy()[own])


@pytest.mark.gpu
@pytest.mark.parametrize("kind,n,porder", SECTION_CASES,
                         ids=[f"{k}-n{n}-p{p}" for k, n, p in SECTION_CASES])
def test_sections_kernel_matches_plain_on_card(cuda, kind, n, porder):
    u, ct, po, ks, n = _section_rows(kind, porder, n)
    starts, lens_w, cap = _plain_layout(u, ct, po, ks, n, skip_row=1)
    _assert_kernel_matches_plain(cuda, u, ct, po, ks, n, starts, lens_w, cap)


@pytest.mark.gpu
def test_sections_kernel_odd_rows_on_card(cuda):
    u, ct, po, ks, n = _odd_section_rows()
    starts, lens_w, cap = _plain_layout(u, ct, po, ks, n, skip_row=10)
    _assert_kernel_matches_plain(cuda, u, ct, po, ks, n, starts, lens_w, cap,
                                 section_words=int(lens_w.max()) + 5)


@pytest.mark.gpu
@pytest.mark.parametrize("n,W", [(4064, 2604), (16384, 14400)],
                         ids=["tail-n4064", "rounds-n16384"])
def test_sections_kernel_long_rows_on_card(cuda, n, W):
    """A row with fewer samples than a round holds, and rows of several
    rounds (24-bit scale) with the widest image the encoder asks for."""
    rng = np.random.RandomState(n)
    V = 6
    res = rng.laplace(0, 300 if n == 4064 else 60000, (V, n)).astype(np.int32)
    u = sint32_to_uint32(res).astype(np.uint32)
    porder = _max_porder(n)
    ks = np.zeros((V, SECTION_MAXP), np.int32)
    ks[:, :1 << porder] = (6 if n == 4064 else 13) + rng.randint(
        0, 4, (V, 1 << porder))
    ct = (np.arange(V) % 2).astype(np.int32)
    po = np.full(V, porder, np.int32)
    po[0] = 0
    starts, lens_w, cap = _plain_layout(u, ct, po, ks, n, skip_row=3)
    assert lens_w.max() <= W
    _assert_kernel_matches_plain(cuda, u, ct, po, ks, n, starts, lens_w, cap,
                                 section_words=W)


@pytest.mark.gpu
def test_sections_kernel_refuses_an_image_beyond_shared_memory(cuda):
    u, ct, po, ks, n = _section_rows("plain", 0, 512)
    starts, lens_w, cap = _plain_layout(u, ct, po, ks, n, skip_row=1)
    args = [_t(a, cuda) for a in (u, ct, po, ks)]
    with pytest.raises(ValueError, match="shared memory"):
        bitpack.pack_residual_sections(*args, n, _t(starts, cuda),
                                       _t(lens_w, cuda), cap,
                                       section_words=60000)
