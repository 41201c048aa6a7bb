"""K1 (srla_tpu_torch.kernels.lpc) and the synthesis ops around it against
their JAX twins: decode2._lpc_scan, the Pallas kernel lpc_scan_pallas in
interpret mode, _align_coefs, _deemph_scan and _ltp_pass (K9's plain
version, srla_tpu_torch.kernels.ltp, which tests/test_torch_ltp.py holds at
more edges).

Every output is an integer, so every comparison is exact (tolerance 0).
Inputs are made with numpy from a seed and handed to both sides."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from srla_tpu.kernels.decode2 import (_align_coefs, _deemph_scan,  # noqa: E402
                                      _lpc_scan, _ltp_pass)
from srla_tpu.kernels.pallas_lpc import lpc_scan_pallas  # noqa: E402
from srla_tpu_torch.kernels.decode2 import (align_coefs,  # noqa: E402
                                            deemph_scan)
from srla_tpu_torch.kernels.lpc import lpc_scan, lpc_scan_plain  # noqa: E402
from srla_tpu_torch.kernels.ltp import ltp_synth  # noqa: E402

# One shape for every JAX compile of this file: R is not a multiple of 128.
R, N, M = 130, 40, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed=0):
    """Residuals, right-aligned coefficients, orders, rshifts, dcoef, dprev
    with edge rows: order 0, rshift 0, order M, warm-up longer than n/2,
    and int32-wrapping residuals and coefficients."""
    rng = np.random.RandomState(seed)
    res = rng.randint(-4000, 4000, (R, N)).astype(np.int32)
    orders = rng.randint(0, M + 1, R).astype(np.int32)
    coefs = rng.randint(-(1 << 15), 1 << 15, (R, M)).astype(np.int32)
    rshifts = rng.randint(0, 15, R).astype(np.int32)
    orders[0] = 0
    rshifts[1] = 0
    orders[2] = M
    res[3:6] = rng.randint(-(1 << 30), 1 << 30, (3, N))
    coefs[3:6] = rng.randint(-(1 << 30), 1 << 30, (3, M))
    aligned = np.asarray(_align_coefs(jnp.asarray(coefs), jnp.asarray(orders),
                                      M))
    dcoef = rng.randint(0, 16, R).astype(np.int32)
    dprev = rng.randint(-30000, 30000, R).astype(np.int32)
    return res, aligned, orders, rshifts, dcoef, dprev


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.array(a)).to(device) for a in arrays]


@pytest.mark.parametrize("fuse", [False, True], ids=["plain", "deemph"])
def test_plain_matches_xla_scan(fuse):
    res, al, orders, rsh, dcoef, dprev = _inputs(seed=1)
    kw = dict(dcoef=jnp.asarray(dcoef), dprev=jnp.asarray(dprev)) if fuse \
        else {}
    want = np.asarray(_lpc_scan(jnp.asarray(res), jnp.asarray(al),
                                jnp.asarray(orders), jnp.asarray(rsh), N, M,
                                **kw))
    tkw = dict(zip(("dcoef", "dprev"), _t(dcoef, dprev))) if fuse else {}
    got = lpc_scan_plain(*_t(res, al, orders, rsh), N, M, **tkw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fuse", [False, True], ids=["plain", "deemph"])
def test_plain_matches_pallas_interpret(fuse):
    res, al, orders, rsh, dcoef, dprev = _inputs(seed=2)
    kw = dict(dcoef=dcoef, dprev=dprev) if fuse else {}
    want = np.asarray(lpc_scan_pallas(res, al, orders, rsh, N, M,
                                      interpret=True, **kw))
    tkw = dict(zip(("dcoef", "dprev"), _t(dcoef, dprev))) if fuse else {}
    got = lpc_scan_plain(*_t(res, al, orders, rsh), N, M, **tkw)
    np.testing.assert_array_equal(got.numpy(), want)


# Orders on both sides of the kernel's 32-lane tap groups (one warp per row
# holds the taps of lags l+1, l+33, ... in lane l), n not a multiple of the
# 32-sample chunk, and an odd R.
GROUP_ORDERS = (0, 1, 31, 32, 33, 63, 64, 65, 72)
GR, GN, GM = 45, 70, 72


def _group_inputs(seed, R=GR, n=GN, M=GM, orders=GROUP_ORDERS):
    rng = np.random.RandomState(seed)
    ords = np.resize(np.asarray(orders, np.int32), R)
    res = rng.randint(-30000, 30000, (R, n)).astype(np.int32)
    coefs = rng.randint(-(1 << 15), 1 << 15, (R, M)).astype(np.int32)
    rshifts = rng.randint(0, 16, R).astype(np.int32)
    res[1] = rng.randint(-(1 << 30), 1 << 30, n)     # int32 wrapping
    coefs[1] = rng.randint(-(1 << 30), 1 << 30, M)
    aligned = np.asarray(_align_coefs(jnp.asarray(coefs), jnp.asarray(ords),
                                      M))
    dcoef = rng.randint(0, 16, R).astype(np.int32)
    dprev = rng.randint(-30000, 30000, R).astype(np.int32)
    return res, aligned, ords, rshifts, dcoef, dprev


@pytest.mark.parametrize("fuse", [False, True], ids=["plain", "deemph"])
def test_plain_matches_xla_scan_across_lane_groups(fuse):
    res, al, orders, rsh, dcoef, dprev = _group_inputs(seed=9)
    kw = dict(dcoef=jnp.asarray(dcoef), dprev=jnp.asarray(dprev)) if fuse \
        else {}
    want = np.asarray(_lpc_scan(jnp.asarray(res), jnp.asarray(al),
                                jnp.asarray(orders), jnp.asarray(rsh), GN, GM,
                                **kw))
    tkw = dict(zip(("dcoef", "dprev"), _t(dcoef, dprev))) if fuse else {}
    got = lpc_scan_plain(*_t(res, al, orders, rsh), GN, GM, **tkw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_refuses_more_taps_than_the_kernel_holds():
    args = _t(np.zeros((2, 4), np.int32), np.zeros((2, 257), np.int32),
              np.zeros(2, np.int32), np.zeros(2, np.int32))
    with pytest.raises(ValueError, match="M must be in 1..256"):
        lpc_scan(*args, 4, 257)


def test_wrapper_runs_plain_on_cpu_tensors():
    res, al, orders, rsh, dcoef, dprev = _inputs(seed=3)
    before = lpc_scan.launches
    args = _t(res, al, orders, rsh)
    got = lpc_scan(*args, N, M, *_t(dcoef, dprev))
    want = lpc_scan_plain(*args, N, M, *_t(dcoef, dprev))
    assert torch.equal(got, want)
    assert lpc_scan.launches == before      # no kernel launched


def test_align_coefs_matches_jax():
    rng = np.random.RandomState(4)
    coefs = rng.randint(-500, 500, (R, M + 5)).astype(np.int32)
    orders = rng.randint(0, M + 1, R).astype(np.int32)
    want = np.asarray(_align_coefs(jnp.asarray(coefs[:, :M]),
                                   jnp.asarray(orders), M))
    got = align_coefs(*_t(coefs, orders), M)
    np.testing.assert_array_equal(got.numpy(), want)


def test_deemph_scan_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randint(-(1 << 30), 1 << 30, (R, N)).astype(np.int32)
    dcoef = rng.randint(-16, 16, R).astype(np.int32)
    dprev = rng.randint(-30000, 30000, R).astype(np.int32)
    want = np.asarray(_deemph_scan(jnp.asarray(x), jnp.asarray(dcoef),
                                   jnp.asarray(dprev)))
    got = deemph_scan(*_t(x, dcoef, dprev))
    np.testing.assert_array_equal(got.numpy(), want)


def test_ltp_pass_matches_jax():
    rng = np.random.RandomState(6)
    n = 300                                # longer than the largest delay
    v = rng.randint(-(1 << 30), 1 << 30, (R, n)).astype(np.int32)
    lorders = rng.choice([0, 1, 3], R).astype(np.int32)
    lperiods = rng.randint(8, 263, R).astype(np.int32)
    lperiods[:4] = 0                       # rows that pass through
    lcoefs = rng.randint(-32, 32, (R, 3)).astype(np.int32)
    want = np.asarray(_ltp_pass(jnp.asarray(v), jnp.asarray(lorders),
                                jnp.asarray(lperiods), jnp.asarray(lcoefs),
                                n))
    got = ltp_synth(*_t(v, lorders, lperiods, lcoefs), n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("fuse", [False, True], ids=["plain", "deemph"])
def test_kernel_matches_plain_on_card(cuda, fuse):
    res, al, orders, rsh, dcoef, dprev = _inputs(seed=7)
    tkw = dict(zip(("dcoef", "dprev"), _t(dcoef, dprev, device=cuda))) \
        if fuse else {}
    args = _t(res, al, orders, rsh, device=cuda)
    before = lpc_scan.launches
    got = lpc_scan(*args, N, M, **tkw)
    want = lpc_scan_plain(*args, N, M, **tkw)
    torch.cuda.synchronize()
    assert lpc_scan.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernel_matches_plain_at_order_255_on_card(cuda):
    """M = 256 taps: the kernel's shared memory (64 KiB) goes past the
    48 KiB default, and orders reach the format's maximum of 255."""
    rng = np.random.RandomState(8)
    R, n, M = 70, 600, 256
    res = rng.randint(-4000, 4000, (R, n)).astype(np.int32)
    orders = rng.randint(200, 256, R).astype(np.int32)
    coefs = rng.randint(-(1 << 12), 1 << 12, (R, M)).astype(np.int32)
    rsh = rng.randint(0, 16, R).astype(np.int32)
    res_t, ord_t, rsh_t, coef_t = _t(res, orders, rsh, coefs, device=cuda)
    al = align_coefs(coef_t, ord_t, M)
    dcoef, dprev = _t(rng.randint(-16, 16, R).astype(np.int32),
                      rng.randint(-30000, 30000, R).astype(np.int32),
                      device=cuda)
    got = lpc_scan(res_t, al, ord_t, rsh_t, n, M, dcoef, dprev)
    want = lpc_scan_plain(res_t, al, ord_t, rsh_t, n, M, dcoef, dprev)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 31, 33, 4064])
def test_kernel_matches_plain_across_lane_groups_on_card(cuda, n):
    """Orders 0..72 around the lane groups at M = 72 (four taps a lane),
    rows that end inside a 32-sample chunk."""
    res, al, orders, rsh, dcoef, dprev = _group_inputs(seed=10 + n, n=n)
    args = _t(res, al, orders, rsh, device=cuda)
    for kw in ({}, dict(zip(("dcoef", "dprev"),
                            _t(dcoef, dprev, device=cuda)))):
        got = lpc_scan(*args, n, GM, **kw)
        want = lpc_scan_plain(*args, n, GM, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernel_matches_plain_at_256_taps_on_card(cuda):
    """M = 256, eight taps a lane, orders 200..256."""
    rng = np.random.RandomState(11)
    R, n, M = 37, 600, 256
    orders = rng.randint(200, 257, R).astype(np.int32)
    orders[:2] = (256, 200)
    res, al, orders, rsh, dcoef, dprev = _group_inputs(
        seed=12, R=R, n=n, M=M, orders=orders)
    args = _t(res, al, orders, rsh, device=cuda)
    for kw in ({}, dict(zip(("dcoef", "dprev"),
                            _t(dcoef, dprev, device=cuda)))):
        got = lpc_scan(*args, n, M, **kw)
        want = lpc_scan_plain(*args, n, M, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
