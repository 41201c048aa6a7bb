"""K4 (srla_tpu_torch.kernels.rice_search) and the Rice parameter search
around it against their JAX twins on JAX-CPU: the per-partition sums of
srla_tpu.kernels.exact._rice_exact's hot loop (:521-550, written out
below with the same jnp expressions) and _rice_exact itself.

Every output is an integer, so every comparison is exact (tolerance 0).
Edge parameters pin the shift traps: k = 30 (2^(k+1) is INT_MIN in int32),
k = 31 (2^(k+1) is 0 in XLA), k = 0."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from srla_tpu.kernels.exact import _rice_exact  # noqa: E402
from srla_tpu_torch.kernels import exact as texact  # noqa: E402
from srla_tpu_torch.kernels.rice_search import (  # noqa: E402
    num_partition_cols, rice_sums, rice_sums_plain)

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
# length of the power-of-two kernel (n = 128 .. 16384), one partition, one
# row of either kind, and sizes only the generic kernel takes (leaves of
# 12 and of one sample, fewer leaves than warps).
SHAPES = [(6, 4096, 10), (7, 4064, 5), (12, 512, 9), (5, 96, 5),
          (3, 4096, 0), (1, 2048, 0), (1, 4096, 10), (2, 1024, 10),
          (4, 8192, 10), (3, 2048, 7), (5, 128, 7), (3, 256, 3),
          (2, 16384, 10), (3, 64, 6), (1, 4064, 5), (2, 12288, 10),
          (3, 1000, 2), (2, 999, 0)]


def _shape_id(shape):
    return "V{}-n{}-p{}".format(*shape)


def _shape_inputs(rows, n, max_porder, top_bit=False):
    """Small codes with a full-range row and a zero row where there is room,
    a tenth of the parameters at 0, 30 or 31, both row kinds (a lone row is
    recursive when n is a power of two). top_bit: the full-range row also
    sets bit 31, where the JAX loop shifts arithmetically and the port
    logically, so only the card's comparison takes it."""
    rng = np.random.RandomState(rows * 100003 + n * 11 + max_porder)
    P = num_partition_cols(max_porder)
    u = rng.randint(0, 1 << 12, (rows, n)).astype(np.int64)
    u[rows // 2] = rng.randint(0, 1 << 32 if top_bit else 1 << 31, n,
                               dtype=np.int64)
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


def test_plain_sums_match_jax_hot_loop():
    u, ks, rec = _inputs()
    want = _jax_sums(u, ks, rec)
    args = [torch.from_numpy(a) for a in (u, ks, rec)]
    got = rice_sums_plain(*args, N, MAXP)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(rice_sums(*args, N, MAXP).numpy(), want)


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_plain_sums_match_jax_at_shape(shape):
    rows, n, max_porder = shape
    u, ks, rec = _shape_inputs(*shape)
    want = _jax_sums(u, ks, rec, n, max_porder)
    assert want.shape == (rows, num_partition_cols(max_porder))
    args = [torch.from_numpy(a) for a in (u, ks, rec)]
    got = rice_sums_plain(*args, n, max_porder)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        rice_sums(*args, n, max_porder).numpy(), want)


@pytest.mark.parametrize("scale", [3.0, 400.0, 90000.0],
                         ids=["plain", "mixed", "recursive"])
def test_rice_exact_matches_jax(scale):
    """The whole search: code type, best partition order, section bits and
    per-partition parameters equal _rice_exact's on rows neither side
    flags; the flags themselves agree here."""
    rng = np.random.RandomState(int(scale))
    res = rng.laplace(0, scale, (V, N))
    res *= np.where(np.arange(N) < N // 3, 0.05, 1.0)   # uneven partitions
    res = res.astype(np.int32)
    res[0] = 0                                          # ALLZERO
    jct, jpo, jbits, jks, jr = [np.asarray(a) for a in
                                _rice_exact(jnp.asarray(res), N, MAXP)]
    ct, po, bits, ks, risky = [a.numpy() for a in texact.rice_exact(
        torch.from_numpy(res), N, MAXP)]
    np.testing.assert_array_equal(risky, jr)
    ok = ~risky
    np.testing.assert_array_equal(ct[ok], jct[ok])
    np.testing.assert_array_equal(po[ok], jpo[ok])
    np.testing.assert_array_equal(bits[ok], jbits[ok])
    np.testing.assert_array_equal(ks[ok], jks[ok])


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(cuda):
    u, ks, rec = _inputs(seed=3)
    args = [torch.from_numpy(a).to(cuda) for a in (u, ks, rec)]
    before = rice_sums.launches
    got = rice_sums(*args, N, MAXP)
    torch.cuda.synchronize()
    assert rice_sums.launches == before + 1
    want = rice_sums_plain(*args, N, MAXP)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), _jax_sums(u, ks, rec))
    # Partitions of 127 samples at order 5 (n = 4064 = 127 * 32): the
    # per-lane path, where a warp spans two partitions.
    n, mp = 4064, 5
    rng = np.random.RandomState(5)
    u2 = torch.from_numpy(rng.randint(0, 1 << 16, (7, n)).astype(np.int32))
    ks2 = torch.from_numpy(rng.randint(0, 20, (7, num_partition_cols(mp)))
                           .astype(np.int32))
    rec2 = torch.from_numpy((np.arange(7) % 2).astype(np.int32))
    got2 = rice_sums(u2.to(cuda), ks2.to(cuda), rec2.to(cuda), n, mp)
    want2 = rice_sums_plain(u2, ks2, rec2, n, mp)
    np.testing.assert_array_equal(got2.cpu().numpy(), want2.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_kernel_matches_plain_at_shape(cuda, shape):
    """Both kernels of K4 (rows of a power-of-two length, and the rest) at
    every way a partition can lie against a thread's run and a warp; the
    full-range row sets bit 31 too."""
    rows, n, max_porder = shape
    for top_bit in (False, True):
        u, ks, rec = _shape_inputs(*shape, top_bit=top_bit)
        args = [torch.from_numpy(a).to(cuda) for a in (u, ks, rec)]
        before = rice_sums.launches
        got = rice_sums(*args, n, max_porder)
        torch.cuda.synchronize()
        assert rice_sums.launches == before + 1
        want = rice_sums_plain(*args, n, max_porder)
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
        if not top_bit:
            np.testing.assert_array_equal(
                got.cpu().numpy(), _jax_sums(u, ks, rec, n, max_porder))


@pytest.mark.gpu
def test_kernel_takes_an_unaligned_plane(cuda):
    """A (V, n) plane that starts 4 bytes into its buffer cannot take
    128-bit loads; the result is the same."""
    rows, n, max_porder = 3, 4096, 10
    u, ks, rec = _shape_inputs(rows, n, max_porder)
    buf = torch.zeros(rows * n + 1, dtype=torch.int32, device=cuda)
    plane = buf[1:].view(rows, n)
    plane.copy_(torch.from_numpy(u))
    assert plane.data_ptr() % 16 != 0 and plane.is_contiguous()
    k, r = torch.from_numpy(ks).to(cuda), torch.from_numpy(rec).to(cuda)
    got = rice_sums(plane, k, r, n, max_porder)
    want = rice_sums_plain(plane, k, r, n, max_porder)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
