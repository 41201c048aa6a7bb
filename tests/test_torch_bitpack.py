"""K5 (srla_tpu_torch.kernels.bitpack.pack) and the codeword stream around
it against their JAX twins on JAX-CPU: the Pallas kernel pallas_pack_rows
in interpret mode (as tests/test_bitpack.py runs it), the flat
grouped-window pack pack_flat_stream, the scatter pack
pack_monotone_stream(impl="scatter"), _word_splits and
residual_codewords; and one section's bytes against rice.emit_channel.

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
