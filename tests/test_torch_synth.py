"""The decode's synthesis (srla_tpu_torch.kernels.decode2.synthesize) on
the CPU, through its kernels' plain versions (K1's coefficient-aligning
entry: align_coefs and lpc_scan_plain; K9's ltp_synth_plain; K19's
synth_tail_plain), against srla_tpu.kernels.decode2._synthesize on JAX-CPU
(its XLA _lpc_scan: _use_pallas_lpc is false off a TPU): C 1, 2 and 3,
methods 0-3 mixed in a group, lshift 0, 1 and 8, int32 extremes, LTP on
and off, n 256 and 333, the coefficients and methods read as strided views
of the packed parameters. Then K1's coefficient-aligning entry against
_align_coefs and _lpc_scan at order 0, order M, orders past M, M 256 and
a strided view, and K19's wrapper on CPU tensors (in place and out of
place, no launch counted).

Every output is an integer, so every comparison is exact (tolerance 0).
Inputs are made with numpy from a seed (chip_smoke.synth_inputs,
k19_inputs) and handed to both sides."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from srla_tpu.kernels.decode2 import (_align_coefs, _lpc_scan,  # noqa: E402
                                      _synthesize)
from srla_tpu_torch.kernels.decode2 import (synth_tail,  # noqa: E402
                                            synth_tail_plain, synthesize)
from srla_tpu_torch.kernels.lpc import (lpc_scan_coefs,  # noqa: E402
                                        lpc_scan_plain)

# (C, n, M, lshift, has_ltp): every C, n, lshift and LTP setting at least
# once, and one JAX compile a case.
CASES = [(1, 256, 8, 0, False), (2, 256, 16, 1, False),
         (2, 333, 16, 8, True), (3, 333, 12, 0, True),
         (3, 256, 8, 8, False), (2, 256, 8, 0, True), (1, 333, 16, 1, True)]


def _jax_synthesize(inp, lshift, *, n, C, M, has_ltp):
    meta = inp["meta"]
    B = meta.shape[0]
    o = inp["cols"]["coefs"]
    out = _synthesize(
        jnp.asarray(inp["res"]), jnp.asarray(inp["orders"]),
        jnp.asarray(inp["rshifts"]),
        jnp.asarray(meta[:, o:o + C * M].reshape(B, C, M)),
        jnp.asarray(inp["ltp_orders"]), jnp.asarray(inp["ltp_periods"]),
        jnp.asarray(inp["ltp_coefs"]), jnp.asarray(inp["pre_coef"]),
        jnp.asarray(inp["pre_prev"]),
        jnp.asarray(meta[:, inp["cols"]["method"]]), jnp.int32(lshift),
        n=n, C=C, M=M, has_ltp=has_ltp)
    return np.asarray(out)


@pytest.mark.parametrize("C,n,M,lshift,has_ltp", CASES)
def test_synthesize_matches_jax(C, n, M, lshift, has_ltp):
    B = 9
    inp = chip_smoke.synth_inputs(np, B, C, n, M, seed=C * n + M + lshift,
                                  ltp=has_ltp, width=5)
    args = chip_smoke.synth_args(torch, np, inp, "cpu", C, M)
    assert not args[3].is_contiguous()          # the coefficients' view
    assert args[9].stride(0) == inp["meta"].shape[1]
    if C >= 2:
        assert set(inp["meta"][:, 0]) == {0, 1, 2, 3}
    got = synthesize(*args, lshift, n=n, C=C, M=M, has_ltp=has_ltp)
    want = _jax_synthesize(inp, lshift, n=n, C=C, M=M, has_ltp=has_ltp)
    assert got.dtype == torch.int32 and got.shape == (B, C, n)
    np.testing.assert_array_equal(got.numpy(), want)


def _coefs_case(R, n, M, seed, orders=None):
    rng = np.random.RandomState(seed)
    res = rng.randint(-30000, 30000, (R, n)).astype(np.int32)
    res[1] = rng.randint(-(1 << 31), 1 << 31, n, dtype=np.int64)
    if orders is None:
        orders = rng.randint(0, M + 1, R)
    orders = np.asarray(orders, np.int32)
    rshifts = rng.randint(0, 16, R).astype(np.int32)
    # Left-aligned coefficients inside a wider packed array (a strided
    # view: 3 columns before, 4 after).
    packed = np.zeros((R, M + 7), np.int32)
    packed[:, 3:3 + M] = rng.randint(-(1 << 13), 1 << 13, (R, M))
    packed[2, 3:3 + M] = rng.randint(-(1 << 30), 1 << 30, M)
    dcoef = rng.randint(-16, 16, R).astype(np.int32)
    dprev = rng.randint(-30000, 30000, R).astype(np.int32)
    return res, packed, orders, rshifts, dcoef, dprev


@pytest.mark.parametrize("M,orders", [
    (16, (0, 0, 16, 16, 1, 15, 0, 16)),           # order 0 and order M
    (16, (17, 19, 3, 16, 0, 5, 16, 2)),           # orders past M: clipped
    (256, (256, 255, 0, 1, 200, 31, 33, 256))])   # 8 taps a lane
@pytest.mark.parametrize("fuse", [False, True], ids=["plain", "deemph"])
def test_lpc_scan_coefs_matches_jax(M, orders, fuse):
    R, n = len(orders), 40
    res, packed, ords, rsh, dcoef, dprev = _coefs_case(R, n, M, seed=M,
                                                       orders=orders)
    coefs = packed[:, 3:3 + M]
    aligned = _align_coefs(jnp.asarray(coefs), jnp.asarray(ords), M)
    kw = dict(dcoef=jnp.asarray(dcoef), dprev=jnp.asarray(dprev)) if fuse \
        else {}
    want = np.asarray(_lpc_scan(jnp.asarray(res), aligned, jnp.asarray(ords),
                                jnp.asarray(rsh), n, M, **kw))
    tkw = dict(dcoef=torch.from_numpy(dcoef),
               dprev=torch.from_numpy(dprev)) if fuse else {}
    view = torch.from_numpy(packed)[:, 3:3 + M]
    assert not view.is_contiguous()
    before = lpc_scan_coefs.launches
    got = lpc_scan_coefs(torch.from_numpy(res), view, torch.from_numpy(ords),
                         torch.from_numpy(rsh), n, M, **tkw)
    assert lpc_scan_coefs.launches == before         # no kernel launched
    np.testing.assert_array_equal(got.numpy(), want)
    # The same rows as (B, C, M) blocks of two channels.
    blocks = torch.from_numpy(packed)[:, 3:3 + M].reshape(R // 2, 2, M)
    again = lpc_scan_coefs(torch.from_numpy(res), blocks,
                           torch.from_numpy(ords), torch.from_numpy(rsh), n,
                           M, **tkw)
    assert torch.equal(again, got)


def test_lpc_scan_coefs_equals_aligned_entry_plain():
    """The coefficient-aligning entry's plain version is lpc_scan_plain of
    the aligned coefficients (K1's first entry) on test_torch_lpc's
    group shapes: orders around the kernel's 32-lane tap groups."""
    from srla_tpu_torch.kernels.lpc import align_coefs
    orders = np.resize(np.array((0, 1, 31, 32, 33, 63, 64, 65, 72)), 45)
    res, packed, ords, rsh, dcoef, dprev = _coefs_case(45, 70, 72, seed=9,
                                                       orders=orders)
    t = {k: torch.from_numpy(v) for k, v in dict(
        res=res, ords=ords, rsh=rsh, dcoef=dcoef, dprev=dprev).items()}
    view = torch.from_numpy(packed)[:, 3:75]
    al = align_coefs(view, t["ords"], 72)
    for kw in ({}, dict(dcoef=t["dcoef"], dprev=t["dprev"])):
        got = lpc_scan_coefs(t["res"], view, t["ords"], t["rsh"], 70, 72,
                             **kw)
        want = lpc_scan_plain(t["res"], al, t["ords"], t["rsh"], 70, 72,
                              **kw)
        assert torch.equal(got, want)


def test_lpc_scan_coefs_refuses_scattered_coefficients():
    res = torch.zeros((4, 8), dtype=torch.int32)
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="consecutive"):
        lpc_scan_coefs(res, torch.zeros((8, 4), dtype=torch.int32).t(), z,
                       z, 8, 8)
    with pytest.raises(ValueError, match="M must be in 1..256"):
        lpc_scan_coefs(res, torch.zeros((4, 300), dtype=torch.int32), z, z,
                       8, 257)


def _jax_tail(y, methods, lshift):
    """_synthesize's tail (:529-538) on its own: the LPC stage with every
    row at order 0 and no de-emphasis passes y through."""
    B, C, n = y.shape
    z = jnp.zeros((B, C), jnp.int32)
    out = _synthesize(jnp.asarray(y), z, z, jnp.zeros((B, C, 1), jnp.int32),
                      z, z, jnp.zeros((B, C, 3), jnp.int32), z, z,
                      jnp.asarray(methods), jnp.int32(lshift), n=n, C=C, M=1,
                      has_ltp=False)
    return np.asarray(out)


@pytest.mark.parametrize("C,n,method,lshift", [
    (2, 64, None, 0), (2, 64, 1, 1), (2, 64, 2, 8), (2, 64, 3, 0),
    (2, 64, 0, 8), (3, 37, None, 8), (1, 37, None, 1), (8, 37, None, 0)])
def test_synth_tail_plain_matches_jax(C, n, method, lshift):
    y, m = chip_smoke.k19_inputs(torch, np, "cpu", 7, C, n, method,
                                 seed=C + n + lshift)
    want = _jax_tail(y.numpy(), m.numpy(), lshift)
    np.testing.assert_array_equal(synth_tail_plain(y, m, lshift).numpy(),
                                  want)


def test_synth_tail_runs_plain_in_place_on_cpu_tensors():
    y, m = chip_smoke.k19_inputs(torch, np, "cpu", 5, 2, 333, None, seed=3)
    want = synth_tail_plain(y, m, 8)
    before = synth_tail.launches
    out = torch.empty_like(y)
    assert synth_tail(y, m, 8, out=out) is out
    assert torch.equal(out, want)
    assert not torch.equal(y, want)
    assert synth_tail(y, m, 8) is y                   # in place
    assert torch.equal(y, want)
    assert synth_tail.launches == before              # no kernel launched
    with pytest.raises(ValueError, match="lshift"):
        synth_tail(y, m, 32)
