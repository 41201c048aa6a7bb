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


def _jax_sums(u, ks, rec):
    """The per-partition sums exactly as _rice_exact forms them."""
    ui = jnp.asarray(u)
    out = []
    for porder in range(MAXP + 1):
        nparts = 1 << porder
        up = ui.reshape(V, nparts, N >> porder)
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
