"""K3 (srla_tpu_torch.kernels.predict) against its JAX twins,
srla_tpu.kernels.encode._predict and _reverse_coefs, on JAX-CPU.

Every output is an integer, so every comparison is exact (tolerance 0).
Inputs are made with numpy from a seed and handed to both sides; edge rows
pin the wrapping-int32 traps: order 0, rshift 0 (half = INT_MIN), order =
M = 255, warm-up longer than half the row, and int32-wrapping sums. The
tiling cases walk the kernel's register tile (8 outputs a thread, 512
samples a CTA, taps in groups of 8): rows just below, at and one above a
tile, odd lengths (rows that are not 16-byte aligned), a row shorter than a
thread's run, and M that is no multiple of the group."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from srla_tpu.kernels.encode import _predict, _reverse_coefs  # noqa: E402
from srla_tpu_torch.kernels.predict import (predict,  # noqa: E402
                                            predict_plain, reverse_coefs)

V, N, M = 24, 300, 255


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed=0, wrap=False):
    """Left-aligned integer coefficients (V, M), orders, rshifts and
    samples; ``wrap`` makes samples and coefficients int32-sized."""
    rng = np.random.RandomState(seed)
    hi = (1 << 30) if wrap else 30000
    work = rng.randint(-hi, hi, (V, N)).astype(np.int32)
    chi = (1 << 30) if wrap else 128
    intc = rng.randint(-chi, chi, (V, M)).astype(np.int32)
    orders = rng.randint(1, 65, V).astype(np.int32)
    rshifts = rng.randint(1, 16, V).astype(np.int32)
    orders[0] = 0                          # residual = work
    rshifts[1] = 0                         # half = INT_MIN
    orders[2] = M                          # every tap, warm-up of 255 > N/2
    orders[3], rshifts[3] = 200, 0
    intc[np.arange(M)[None, :] >= orders[:, None]] = 0
    return work, intc, orders, rshifts


def _jax(work, intc, orders, rshifts):
    rev = _reverse_coefs(jnp.asarray(intc), jnp.asarray(orders))
    return np.asarray(rev), np.asarray(_predict(
        jnp.asarray(work), rev, jnp.asarray(orders), jnp.asarray(rshifts),
        N))


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


@pytest.mark.parametrize("wrap", [False, True], ids=["audio", "wrapping"])
def test_plain_matches_jax_predict(wrap):
    work, intc, orders, rshifts = _inputs(seed=int(wrap), wrap=wrap)
    want_rev, want = _jax(work, intc, orders, rshifts)
    w, c, o, r = _t(work, intc, orders, rshifts)
    rev = reverse_coefs(c, o)
    np.testing.assert_array_equal(rev.numpy(), want_rev)
    got = predict_plain(w, rev, o, r)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # The wrapper takes the plain version for CPU tensors.
    np.testing.assert_array_equal(predict(w, rev, o, r).numpy(), want)


def test_edge_rows_pinned():
    """Order 0 passes samples through; below the order the residual is the
    first difference; rshift 0 adds INT_MIN before the shift."""
    work, intc, orders, rshifts = _inputs(seed=4)
    w, c, o, r = _t(work, intc, orders, rshifts)
    got = predict_plain(w, reverse_coefs(c, o), o, r).numpy()
    np.testing.assert_array_equal(got[0], work[0])
    x = work[2, :M].astype(np.int64)             # row 2: order M
    np.testing.assert_array_equal(got[2, 1:M], (x[1:] - x[:-1]).astype(
        np.int32))
    s = 250                                     # row 3: order 200, rshift 0
    acc = sum(int(intc[3, i]) * int(work[3, s - 1 - i]) for i in range(200))
    acc = (acc - (1 << 31)) % (1 << 32)
    acc = acc - (1 << 32) if acc >= 1 << 31 else acc
    want = (int(work[3, s]) + acc + (1 << 31)) % (1 << 32) - (1 << 31)
    assert got[3, s] == want


def test_wrapper_rejects_other_devices():
    work, intc, orders, rshifts = _inputs()
    w, c, o, r = _t(work, intc, orders, rshifts)
    with pytest.raises(ValueError, match="no kernel"):
        predict(w.to("meta"), c.to("meta"), o.to("meta"), r.to("meta"))


@pytest.mark.gpu
@pytest.mark.parametrize("wrap", [False, True], ids=["audio", "wrapping"])
def test_kernel_matches_plain_on_card(cuda, wrap):
    work, intc, orders, rshifts = _inputs(seed=7, wrap=wrap)
    w, c, o, r = _t(work, intc, orders, rshifts, device=cuda)
    rev = reverse_coefs(c, o)
    before = predict.launches
    got = predict(w, rev, o, r)
    torch.cuda.synchronize()
    assert predict.launches == before + 1
    want = predict_plain(w, rev, o, r)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _jax(work, intc, orders, rshifts)[1])


# n below, at and one above a CTA's tile of 512 and two tiles; odd n; n
# below a thread's run of 8; M a multiple of the tap group, not one, below
# one, and 1; M above n.
TILING_CASES = [(511, 64), (512, 64), (513, 64), (1023, 64), (1024, 64),
                (1025, 64), (2049, 12), (7, 5), (333, 1), (96, 100)]


def _tiling_inputs(n, M, seed=0):
    """6 + rows with orders 0, 1, M (twice, one at rshift 0 and one at 31)
    and random ones, int32-sized samples and taps (wrapping sums)."""
    rng = np.random.RandomState(seed + n + M)
    V = 9
    work = rng.randint(-(1 << 30), 1 << 30, (V, n)).astype(np.int32)
    work[4] = rng.randint(-30000, 30000, n)
    intc = rng.randint(-(1 << 30), 1 << 30, (V, M)).astype(np.int32)
    intc[4] = rng.randint(-128, 128, M)
    orders = rng.randint(0, M + 1, V).astype(np.int32)
    rshifts = rng.randint(1, 16, V).astype(np.int32)
    orders[0], orders[1], orders[2], orders[3] = 0, 1, M, M
    rshifts[2], rshifts[3] = 0, 31
    intc[np.arange(M)[None, :] >= orders[:, None]] = 0
    return work, intc, orders, rshifts


def _jax_n(work, intc, orders, rshifts):
    rev = _reverse_coefs(jnp.asarray(intc), jnp.asarray(orders))
    return np.asarray(_predict(jnp.asarray(work), rev, jnp.asarray(orders),
                               jnp.asarray(rshifts), work.shape[1]))


@pytest.mark.parametrize("n,M", TILING_CASES,
                         ids=[f"n{n}-M{M}" for n, M in TILING_CASES])
def test_plain_matches_jax_predict_at_tile_edges(n, M):
    work, intc, orders, rshifts = _tiling_inputs(n, M)
    w, c, o, r = _t(work, intc, orders, rshifts)
    got = predict(w, reverse_coefs(c, o), o, r)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_n(work, intc, orders, rshifts))
    np.testing.assert_array_equal(got.numpy()[0], work[0])       # order 0
    if n > 1:                                                    # order 1
        assert got[1, 0] == work[1, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("n,M", TILING_CASES,
                         ids=[f"n{n}-M{M}" for n, M in TILING_CASES])
def test_kernel_matches_plain_at_tile_edges_on_card(cuda, n, M):
    work, intc, orders, rshifts = _tiling_inputs(n, M)
    w, c, o, r = _t(work, intc, orders, rshifts, device=cuda)
    rev = reverse_coefs(c, o)
    before = predict.launches
    got = predict(w, rev, o, r)
    torch.cuda.synchronize()
    assert predict.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  predict_plain(w, rev, o, r).cpu().numpy())


@pytest.mark.gpu
def test_kernel_clamps_an_order_above_m_on_card(cuda):
    """An order above M reads as M: no read leaves the staged tile. The
    plain version has no such row, so the row is compared at order M."""
    n, M = 300, 16
    work, intc, orders, rshifts = _tiling_inputs(n, M, seed=3)
    orders[5] = M
    intc[5] = np.random.RandomState(1).randint(-128, 128, M)
    w, c, o, r = _t(work, intc, orders, rshifts, device=cuda)
    rev = reverse_coefs(c, o)
    want = predict_plain(w, rev, o, r)
    o_above = o.clone()
    o_above[5] = M + 1
    got = predict(w, rev, o_above, r)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
