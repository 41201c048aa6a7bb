"""K4 (srla_tpu_torch.kernels.rice_search: the whole Rice parameter search)
and its plain version against their JAX twin on JAX-CPU: the per-partition
sums of srla_tpu.kernels.exact._rice_exact's hot loop (:521-550, written
out below with the same jnp expressions) and _rice_exact itself.

Every output is an integer or a flag, so every comparison is exact
(tolerance 0): the plain version against JAX on the rows neither side
flags, the kernel against the plain version on every output of every row,
``risky`` included. Edge parameters pin the shift traps: k = 30 (2^(k+1) is
INT_MIN in int32), k = 31 (2^(k+1) is 0 in XLA), k = 0."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from srla_tpu.kernels.exact import _rice_exact  # noqa: E402
from srla_tpu_torch.kernels import exact as texact  # noqa: E402
from srla_tpu_torch.kernels import rice_search as rs  # noqa: E402
from srla_tpu_torch.kernels.bitpack import zigzag  # noqa: E402
from srla_tpu_torch.kernels.rice_search import (  # noqa: E402
    num_partition_cols, rice_search, rice_search_plain, rice_sums_plain)

V, N, MAXP = 12, 512, 9         # n = 512: partition orders 0..9


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    P = num_partition_cols(MAXP)
    u = rng.randint(0, 1 << 12, (V, N)).astype(np.int32)
    u[1] = rng.randint(0, 1 << 31, N)              # full-range values
    u[2] = 0
    ks = rng.randint(0, 14, (V, P)).astype(np.int32)
    ks[3] = 30
    ks[4] = 31
    ks[5] = 0
    rec = (np.arange(V) % 2).astype(np.int32)
    return u, ks, rec


# (rows, n, max_porder): the main path's group and its tail group (leaves of
# 127), leaves shorter than a thread's run (1 and 3 samples), every run
# length of the kernel (n = 128 .. 16384), one partition, one row of either
# kind, and rows that are no power of two (leaves of 12 and of one sample,
# fewer leaves than warps, n under 128, odd n).
SHAPES = [(6, 4096, 10), (7, 4064, 5), (12, 512, 9), (5, 96, 5),
          (3, 4096, 0), (1, 2048, 0), (1, 4096, 10), (2, 1024, 10),
          (4, 8192, 10), (3, 2048, 7), (5, 128, 7), (3, 256, 3),
          (2, 16384, 10), (3, 64, 6), (1, 4064, 5), (2, 12288, 10),
          (3, 1000, 2), (2, 999, 0)]


def _shape_id(shape):
    return "V{}-n{}-p{}".format(*shape)


def _shape_inputs(rows, n, max_porder):
    """Small codes with a full-range row and a zero row where there is room,
    a tenth of the parameters at 0, 30 or 31, both row kinds (a lone row is
    recursive when n is a power of two)."""
    rng = np.random.RandomState(rows * 100003 + n * 11 + max_porder)
    P = num_partition_cols(max_porder)
    u = rng.randint(0, 1 << 12, (rows, n)).astype(np.int64)
    u[rows // 2] = rng.randint(0, 1 << 31, n, dtype=np.int64)
    if rows > 2:
        u[2] = 0
    ks = rng.randint(0, 14, (rows, P))
    edge = rng.rand(rows, P) < 0.1
    ks = np.where(edge, rng.choice([0, 30, 31], (rows, P)), ks)
    rec = (np.arange(rows) + (n & (n - 1) == 0)) % 2
    return (u.astype(np.uint32).view(np.int32), ks.astype(np.int32),
            rec.astype(np.int32))


def _jax_sums(u, ks, rec, n=N, max_porder=MAXP):
    """The per-partition sums exactly as _rice_exact forms them."""
    ui = jnp.asarray(u)
    rows = u.shape[0]
    out = []
    for porder in range(max_porder + 1):
        nparts = 1 << porder
        up = ui.reshape(rows, nparts, n >> porder)
        k = jnp.asarray(ks[:, nparts - 1:2 * nparts - 1])
        k1pow = jnp.int32(1) << (k + 1)
        rec_s = jnp.sum(jnp.maximum(up - k1pow[:, :, None], 0)
                        >> k[:, :, None], axis=2)
        plain = jnp.sum(up >> k[:, :, None], axis=2)
        out.append(jnp.where(jnp.asarray(rec)[:, None] != 0, rec_s, plain))
    return np.asarray(jnp.concatenate(out, axis=1))


def _residual_rows(rows, n, seed, full_range=False):
    """Laplace residuals at scales from under 1 (plain Rice rows) to 3e4
    (recursive), a quiet first third (uneven partitions), an all-zero row
    where there is room; full_range: one row of int32-wide values, whose
    zigzag codes reach 2^32 (the card's comparison only: JAX's codes are
    int32)."""
    rng = np.random.RandomState(seed)
    scales = np.array([0.3, 0.9, 3.0, 40.0, 900.0, 3.0e4])[
        np.arange(rows) % 6]
    res = rng.laplace(0, 1, (rows, n)) * scales[:, None]
    res *= np.where(np.arange(n) < n // 3, 0.05, 1.0)
    res = res.astype(np.int32)
    if rows > 2:
        res[2] = 0
    if full_range:
        res[rows // 2] = rng.randint(-(1 << 31), 1 << 31, n,
                                     dtype=np.int64)
    return res


def _jax_search(res, n, max_porder):
    return [np.asarray(a) for a in _rice_exact(jnp.asarray(res), n,
                                               max_porder)]


def _assert_unflagged_equal(got, want):
    """(code_type, porder, bits, ks, risky) equal on every row neither side
    flags; returns those rows."""
    ok = ~np.asarray(got[4]) & ~np.asarray(want[4])
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(np.asarray(g)[ok], np.asarray(w)[ok])
    return ok


def _order_bits(res, n, max_porder):
    """Each partition order's bits, (rows, max_porder + 1), from the plain
    version's parameters and sums."""
    u, ks, rec, _, _ = rs.rice_params(torch.from_numpy(res), n, max_porder)
    sums = rice_sums_plain(rs.wrap32(u).to(torch.int32),
                           ks.to(torch.int32), rec.to(torch.int32), n,
                           max_porder).long()
    out = []
    for p in range(max_porder + 1):
        cols = slice((1 << p) - 1, (2 << p) - 1)
        k = ks[:, cols]
        part = sums[:, cols] + torch.where(rec[:, None], k + 2, k + 1) * (
            n >> p)
        out.append(rs._HEAD_BITS + part.sum(dim=1)
                   + (zigzag(k[:, 1:] - k[:, :-1]) + 1).sum(dim=1))
    return torch.stack(out, dim=1).numpy()


# ---------------------------------------------------------------------------
# The sums (step 4) against the JAX loop
# ---------------------------------------------------------------------------

def test_plain_sums_match_jax_hot_loop():
    u, ks, rec = _inputs()
    want = _jax_sums(u, ks, rec)
    args = [torch.from_numpy(a) for a in (u, ks, rec)]
    got = rice_sums_plain(*args, N, MAXP)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_plain_sums_match_jax_at_shape(shape):
    rows, n, max_porder = shape
    u, ks, rec = _shape_inputs(*shape)
    want = _jax_sums(u, ks, rec, n, max_porder)
    assert want.shape == (rows, num_partition_cols(max_porder))
    args = [torch.from_numpy(a) for a in (u, ks, rec)]
    got = rice_sums_plain(*args, n, max_porder)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# The whole search against _rice_exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [3.0, 400.0, 90000.0],
                         ids=["plain", "mixed", "recursive"])
def test_rice_exact_matches_jax(scale):
    """The whole search through the analysis' entry (on a CPU tensor, the
    plain version): code type, best partition order, section bits and
    per-partition parameters equal _rice_exact's on rows neither side
    flags; the flags themselves agree here."""
    rng = np.random.RandomState(int(scale))
    res = rng.laplace(0, scale, (V, N))
    res *= np.where(np.arange(N) < N // 3, 0.05, 1.0)   # uneven partitions
    res = res.astype(np.int32)
    res[0] = 0                                          # ALLZERO
    want = _jax_search(res, N, MAXP)
    got = [a.numpy() for a in texact.rice_exact(torch.from_numpy(res), N,
                                                MAXP)]
    np.testing.assert_array_equal(got[4], want[4])
    _assert_unflagged_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_plain_search_matches_jax_at_shape(shape):
    """rice_search_plain at every shape the kernel's layouts take, rows
    that are no power of two among them."""
    rows, n, max_porder = shape
    res = _residual_rows(max(rows, 6), n, n * 7 + max_porder)
    got = [a.numpy() for a in rice_search_plain(torch.from_numpy(res), n,
                                                max_porder)]
    want = _jax_search(res, n, max_porder)
    assert got[3].shape == want[3].shape == (res.shape[0], 1 << max_porder)
    for g, dtype in zip(got, (np.int64,) * 4 + (np.bool_,)):
        assert g.dtype == dtype
    ok = _assert_unflagged_equal(got, want)
    assert ok.sum() >= res.shape[0] - 1


@pytest.mark.parametrize("max_porder", range(11))
def test_plain_search_matches_jax_at_3072(max_porder):
    """n 3072 (the -V 3 measurement's generic group, leaves of 3 at order
    10) at every partition order bound."""
    res = _residual_rows(6, 3072, 3072 + max_porder)
    got = [a.numpy() for a in rice_search_plain(torch.from_numpy(res), 3072,
                                                max_porder)]
    _assert_unflagged_equal(got, _jax_search(res, 3072, max_porder))


def _edge_rows(n):
    """All-zero rows; rows whose mean is 2 exactly (every code 2; codes 1
    and 3 alternating), and 2 + 1/n, which is not flagged; a row of one
    nonzero code."""
    res = np.zeros((6, n), np.int32)
    res[2] = 1                                      # zigzag 2
    res[3, 0::2], res[3, 1::2] = -1, -2             # zigzag 1 and 3
    res[4] = 1
    res[4, 0] = -2                                  # mean 2 + 1 / n
    res[5, n // 2] = 7
    return res


@pytest.mark.parametrize("n,max_porder", [(512, 9), (3072, 10), (96, 5)])
def test_plain_search_edge_rows_match_jax(n, max_porder):
    res = _edge_rows(n)
    got = [a.numpy() for a in rice_search_plain(torch.from_numpy(res), n,
                                                max_porder)]
    want = _jax_search(res, n, max_porder)
    np.testing.assert_array_equal(got[4], want[4])
    assert got[4].tolist() == [False, False, True, True, False, False]
    assert got[0][:2].tolist() == [2, 2] and got[2][:2].tolist() == [2, 2]
    assert got[1][:2].tolist() == [0, 0]
    ok = _assert_unflagged_equal(got, want)
    assert ok.tolist() == [True, True, False, False, True, True]


def test_plain_search_ties_take_the_first_order():
    """Rows on which two partition orders give the same least bits: both
    sides take the first, the plain version as its own per-order bits
    say."""
    rng = np.random.RandomState(5)
    n, max_porder = 32, 4
    res = rng.laplace(0, 20, (600, n)) * np.where(np.arange(n) < n // 2,
                                                  0.2, 1.0)
    res = res.astype(np.int32)
    bits = _order_bits(res, n, max_porder)
    least = bits.min(axis=1)
    tied = (bits == least[:, None]).sum(axis=1) >= 2
    assert tied.sum() >= 20
    res = res[tied]
    got = [a.numpy() for a in rice_search_plain(torch.from_numpy(res), n,
                                                max_porder)]
    np.testing.assert_array_equal(got[1], np.argmax(
        bits[tied] == least[tied][:, None], axis=1))
    np.testing.assert_array_equal(got[2], least[tied] + 2)
    ok = _assert_unflagged_equal(got, _jax_search(res, n, max_porder))
    assert ok.sum() >= tied.sum() - 2


def test_order_search_keeps_order_0_past_1_30():
    """The order loop on sums no residual reaches (each order's bits stay
    under (k + 5) n, far below 2^30): a row that no order takes below 2^30
    keeps order 0, zero ks and bits 2^30 + 2; an order at 2^30 exactly is
    not taken, one just below is. _rice_exact has the same loop (best_bits
    from 2^30, bits < best_bits)."""
    n, max_porder = 16, 2
    P = num_partition_cols(max_porder)
    u = torch.ones((3, n), dtype=torch.int64)
    ks = torch.full((3, P), 3, dtype=torch.int64)
    recursive = torch.tensor([False, True, True])
    pflag = torch.zeros((3, P), dtype=torch.bool)
    risky = torch.zeros(3, dtype=torch.bool)
    sums = torch.full((3, P), 1 << 30, dtype=torch.int64)

    def fixed(p):                   # all bits of order p but the sums
        return rs._HEAD_BITS + (1 << p) * (3 + 2) * (n >> p) + (1 << p) - 1

    # Row 1: order 1 lands on 2^30 exactly, order 2 one below it.
    t1, t2 = (1 << 30) - fixed(1), (1 << 30) - 1 - fixed(2)
    sums[1, 1:3] = torch.tensor([t1 // 2, t1 - t1 // 2])
    sums[1, 3:7] = torch.tensor([t2 // 4] * 3 + [t2 - 3 * (t2 // 4)])
    ct, po, bits, bks, r = rs.porder_search(u, sums, ks, recursive, pflag,
                                            risky, n, max_porder)
    assert po.tolist() == [0, 2, 0]
    assert bits.tolist() == [(1 << 30) + 2, (1 << 30) + 1, (1 << 30) + 2]
    assert bks[0].tolist() == [0, 0, 0, 0] == bks[2].tolist()
    assert bks[1].tolist() == [3, 3, 3, 3]
    assert ct.tolist() == [0, 1, 1] and not r.any()


# ---------------------------------------------------------------------------
# On the card: the kernel against its plain version, every output
# ---------------------------------------------------------------------------

def _check_kernel(res_cpu, n, max_porder, dev, res_dev=None):
    if res_dev is None:
        res_dev = torch.from_numpy(res_cpu).to(dev)
    before = rice_search.launches
    got = rice_search(res_dev, n, max_porder)
    torch.cuda.synchronize()
    assert rice_search.launches == before + 1
    want = rice_search_plain(torch.from_numpy(res_cpu), n, max_porder)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    return got


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(cuda):
    """The edge rows and the tied rows, at the main group's shape and at
    the generic group's."""
    for n, max_porder in ((512, 9), (4096, 10), (3072, 10), (4064, 5)):
        _check_kernel(_edge_rows(n), n, max_porder, cuda)
    rng = np.random.RandomState(5)
    res = (rng.laplace(0, 20, (600, 32))
           * np.where(np.arange(32) < 16, 0.2, 1.0)).astype(np.int32)
    _check_kernel(res, 32, 4, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_kernel_matches_plain_at_shape(cuda, shape):
    """Every layout of K4 (every run length, leaves inside a thread's run,
    across 2..32 lanes and across warps, padded leaves of rows that are no
    power of two), plain and recursive rows, a full-range row."""
    rows, n, max_porder = shape
    for full_range in (False, True):
        res = _residual_rows(max(rows, 6), n, n * 7 + max_porder,
                             full_range)
        _check_kernel(res, n, max_porder, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("n,max_porder", [(4096, 10), (3072, 10),
                                          (4064, 5)])
def test_kernel_takes_an_unaligned_plane(cuda, n, max_porder):
    """A (V, n) plane that starts 4 bytes into its buffer cannot take
    128-bit loads; the result is the same."""
    res = _residual_rows(6, n, 17)
    buf = torch.zeros(res.size + 1, dtype=torch.int32, device=cuda)
    plane = buf[1:].view(res.shape)
    plane.copy_(torch.from_numpy(res))
    assert plane.data_ptr() % 16 != 0 and plane.is_contiguous()
    _check_kernel(res, n, max_porder, cuda, plane)


def _boundary_rows(n, max_porder):
    """Rows whose partition means sit as near both Rice chains' decision
    boundaries as integer sums allow: a partition of order max_porder a
    boundary, its sum the largest below and the smallest above
    boundary * length, the other codes 0 (plain chain) or the row lifted
    to a mean of 2 and more (recursive chain); and rows whose row mean is
    2 exactly."""
    (kb, _), (tb, _) = rs.rice_k_boundaries()
    leaf = n >> max_porder
    NL = 1 << max_porder
    rows = []
    for bounds, base in ((kb, 0), (tb, 2)):
        for side in (np.floor, np.ceil):
            r = np.full(n, base, np.int64)
            for j in range(NL):
                b = bounds[1 + j % 31]
                total = int(side(b * leaf))
                if total >= (1 << 31) * leaf:
                    continue
                r[j * leaf:(j + 1) * leaf] = total // leaf
                r[j * leaf] += total - (total // leaf) * leaf
            rows.append(r)
    rows.append(np.full(n, 2, np.int64))
    codes = np.stack(rows)
    # The residual whose zigzag codes these are.
    res = np.where(codes % 2 == 0, codes // 2, -(codes + 1) // 2)
    return res.astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("n,max_porder", [(4096, 10), (4096, 3), (3072, 10),
                                          (16384, 10), (128, 0)])
def test_kernel_on_boundary_rows(cuda, n, max_porder):
    """The margin tests' boundaries (tests/test_torch_encode_margins.py:
    each Rice boundary approached from both sides, the type boundary at a
    mean of 2) reached through residual rows: the kernel's k, flags and
    all equal the plain version's."""
    res = _boundary_rows(n, max_porder)
    got = _check_kernel(res, n, max_porder, cuda)
    assert bool(got[4][-1])                         # mean 2: risky
