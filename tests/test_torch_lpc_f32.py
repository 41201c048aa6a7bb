"""K14's sum order (srla_tpu_torch/kernels/csrc/lpc_analyze_f32.cu) pinned
on the CPU: a numpy float32 model of the kernel's lanes, stepped by hand,
against ``lpc_f32.levinson_f32`` (the plain version), bit for bit.

The model holds a row as the kernel does: index m at lane m mod L,
register m // L, for the lags, a[] and the reversal b[m] = a[k+2-m]. A
step is each lane's partial sum of b[m] ac[m] over its m in 1..k+2 in
ascending m, from +0; the xor butterfly (partner L/2 lanes away first);
the division; a[] += g b[], c[] = b[] + g a[]; and b[] for the next step
is c[] moved up one index (each lane takes the lane below's register,
lane 0 lane L-1's register below). Change the kernel and the model
together. The rows are chip_smoke.k14_odd_lags' (music, full-range noise,
sines, a zero, a silent, a half-even tie and a one-lag row)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from srla_tpu_torch.kernels import lpc_f32  # noqa: E402

F32 = np.float32


def _model_row(ac: np.ndarray, M: int, L: int, order=None):
    """One row through the kernel's lanes: (ev[0..M] as the recursion
    leaves them before the silent override, a[1..M] at ``order`` or None).
    Without an order the model runs M - 1 steps; with one it stops after
    order - 1, where the kernel's ring holds that order's a[] from its
    one recursion (the plain version runs ``levinson_f32`` again to
    collect them, as JAX does)."""
    R = (M + L) // L
    m = np.arange(L)[:, None] + L * np.arange(R)[None, :]     # (L, R)
    lag = np.where(m <= M, ac[np.minimum(m, M)], F32(0)).astype(F32)
    r0, ac1 = F32(ac[0]), F32(ac[1])
    safe_r0 = F32(1) if abs(r0) < 1e-30 else r0
    a1 = F32(-ac1 / safe_r0)
    a = np.where(m == 0, F32(1), np.where(m == 1, a1, F32(0))).astype(F32)
    b = np.where(m == 1, a1, np.where(m == 2, F32(1), F32(0))).astype(F32)
    ev = np.zeros(M + 1, F32)
    ev[0] = r0
    ev[1] = F32(r0 + F32(ac1 * a1))
    lanes = np.arange(L)
    steps = M - 1 if order is None else order - 1
    for k in range(steps):
        live = (m >= 1) & (m <= k + 2)
        s = np.zeros(L, F32)
        for j in range(R):
            s = np.where(live[:, j], (s + b[:, j] * lag[:, j]).astype(F32),
                         s).astype(F32)
        w = L // 2
        while w >= 1:
            s = (s + s[lanes ^ w]).astype(F32)
            w //= 2
        assert (s == s[0]).all() or np.isnan(s).all()
        den = F32(1) if abs(ev[k + 1]) < 1e-30 else ev[k + 1]
        g = F32(s[0] / -den)
        ev[k + 2] = F32(ev[k + 1] * F32(F32(1) - F32(g * g)))
        c = (b + (g * a).astype(F32)).astype(F32)
        a = (a + (g * b).astype(F32)).astype(F32)
        up = c[(lanes - 1) % L]
        b = up.copy()
        b[0, 1:] = up[0, :-1]
        b[0, 0] = 0
    coefs = None
    if order is not None:
        flat = np.zeros(R * L, F32)
        flat[m.ravel()] = a.ravel()
        coefs = np.zeros(M, F32)
        coefs[:order] = flat[1:order + 1]
    return ev, coefs


def _lags(M: int, n: int, V: int = 12) -> np.ndarray:
    return chip_smoke.k14_odd_lags(torch, np, V, n, 16, M, seed=M).numpy()


@pytest.mark.parametrize("M,n", [(8, 256), (64, 512), (255, 512)])
def test_lane_model_equals_levinson_f32(M, n):
    """The error variances of the whole recursion and the coefficients at
    each row's orders (the rows' own choices, order M and random orders)
    equal the plain version's bit for bit."""
    ac = _lags(M, n)
    L = lpc_f32.lanes_for(M)
    ev_p, _ = lpc_f32.levinson_f32(torch.from_numpy(ac), M)
    orders = lpc_f32.select_order_f32(ev_p, n, 16, M, False)
    rng = np.random.RandomState(M)
    for orders_used in (orders.numpy(), np.full(len(ac), M),
                        rng.randint(1, M + 1, len(ac))):
        _, c_p = lpc_f32.levinson_f32(torch.from_numpy(ac), M,
                                      torch.from_numpy(orders_used))
        for r in range(len(ac)):
            ev_m, c_m = _model_row(ac[r], M, L, int(orders_used[r]))
            silent = abs(ac[r, 0]) < lpc_f32.SILENT
            want = np.zeros(M, F32) if silent else c_m
            np.testing.assert_array_equal(c_p[r].numpy().view(np.uint32),
                                          want.view(np.uint32))
    for r in range(len(ac)):
        ev_m, _ = _model_row(ac[r], M, L)
        if abs(ac[r, 0]) < lpc_f32.SILENT:
            ev_m[:] = ac[r, 0]
        np.testing.assert_array_equal(ev_p[r].numpy().view(np.uint32),
                                      ev_m.view(np.uint32))


@pytest.mark.parametrize("L", [8, 16, 32])
def test_lane_model_other_lane_counts(L):
    """The plain version follows the model at the edges of every lane
    count the kernel builds: the least and the largest M that
    ``lanes_for`` gives L lanes."""
    n = 512
    for M in {8: (1, 71), 16: (72, 143), 32: (144, 287)}[L]:
        assert lpc_f32.lanes_for(M) == L
        ac = _lags(M, n, V=6)
        ev_p, _ = lpc_f32.levinson_f32(torch.from_numpy(ac), M)
        for r in range(len(ac)):
            if abs(ac[r, 0]) < lpc_f32.SILENT:
                continue
            ev_m, _ = _model_row(ac[r], M, L)
            np.testing.assert_array_equal(ev_p[r].numpy().view(np.uint32),
                                          ev_m.view(np.uint32))


def test_gamma_sum_order_by_hand():
    """gamma_sum on one row of 19 terms over 8 lanes: the lane partials
    and the butterfly written out."""
    rng = np.random.RandomState(5)
    t = (rng.randn(1, 19) * 10.0 ** rng.randint(-6, 6, 19)).astype(F32)
    t[0, 0] = 0
    p = [F32(0)] * 8
    for m in range(19):
        p[m % 8] = F32(p[m % 8] + t[0, m])
    p = [F32(p[i] + p[i + 4]) for i in range(4)]
    p = [F32(p[i] + p[i + 2]) for i in range(2)]
    want = F32(p[0] + p[1])
    got = lpc_f32.gamma_sum(torch.from_numpy(t), 8).numpy()[0]
    assert got.view(np.uint32) == want.view(np.uint32)


def test_lanes_for():
    """At most 9 registers a lane, the fewest lanes that allow it."""
    assert [lpc_f32.lanes_for(M) for M in (1, 8, 32, 64, 71, 72, 128, 143,
                                           144, 255)] == \
        [8, 8, 8, 8, 8, 16, 16, 16, 32, 32]
