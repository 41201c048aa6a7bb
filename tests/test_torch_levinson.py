"""K7, the encode's LPC analysis of each row (srla_tpu_torch.kernels.
levinson), against the JAX package and the host.

- lpc_analyze on CPU tensors (its plain version) against JAX's
  _levinson_dd, _select_order_exact, _levinson_dd at the chosen orders and
  _quantize_exact on JAX-CPU (traced with the JAX package's pin, as its
  entry points trace them), and against the host's Levinson, order choice
  and quantization, on the lags of make_music, noise, a sine, silence and a
  near-silent row, at M 8, 32 and 255: equal orders, shifts and
  coefficients on every row that neither side flags.
- Lag rows driven to the boundaries of K7's decisions (an order tie, a
  quantization half, the frexp and tiny edges of the shift, the silent
  threshold; chip_smoke.k7_boundary_cases) with the port's lags moved by
  2^-42: every row whose decisions differ from the host's is flagged, the
  rows on a boundary are flagged and the rows far from one are not.
- The routing: a CPU tensor takes the plain version and leaves
  lpc_analyze.launches at 0; a meta tensor raises.
- The SVR path's two plain entries (lpc_coefs_plain, then
  lpc_quantize_plain with no widening) equal lpc_analyze_plain bit for
  bit; chip_smoke.k7_coefs_check, which holds K7's coefficient entry to its
  plain version, refuses a coefficient moved past its allowance.
- The quantization entry's plain version (lpc_quantize_plain, cerr 0)
  against the host's quantize_coefficients and JAX's _quantize_exact on
  chip_smoke.k7_quantize_batch (rows at M 32, 64, 128 and 255 with orders
  0..M, tiny and all-zero rows, garbage past each order), coefficients
  exact in f32 so that all read the same values: equal shifts and values
  on every row the port does not flag (the host) and neither flags (JAX,
  at M <= 128; at M 255 JAX rounds one row other than the host).
- On the card (marked gpu): the kernel against its plain version on the
  same rows, equal where neither flags and flagged alike; the coefficient
  entry within k7_coefs_check's allowance of its plain version and the
  quantization entry equal to its plain version, flags too, also on the
  boundary rows of k7_quantize_case with cerr 0 and widened and on
  k7_quantize_batch at M 32, 64, 128 and 255 (NaN and inf rows among
  them); the boundary contract for the kernel; a CUDA tensor of the wrong
  dtype raises."""

import functools
from fractions import Fraction

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from srla_tpu.kernels import df64 as dd  # noqa: E402
from srla_tpu.kernels.exact import (_levinson_dd,  # noqa: E402
                                    _quantize_exact, _select_order_exact)
from srla_tpu_torch.constants import (  # noqa: E402
    LPC_COEFFICIENT_BITWIDTH, LPC_RIDGE_REGULARIZATION_PARAMETER,
    RSHIFT_LPC_COEFFICIENT_BITWIDTH)
from srla_tpu_torch.dsp.window import welch_inverse_squared_sum  # noqa: E402
from srla_tpu_torch.kernels import exact  # noqa: E402
from srla_tpu_torch.kernels.autocorr import autocorr_plain  # noqa: E402
from srla_tpu_torch.kernels.levinson import (  # noqa: E402
    lpc_analyze, lpc_analyze_plain, lpc_coefs, lpc_coefs_plain, lpc_quantize,
    lpc_quantize_plain)
from srla_tpu_torch.signals import make_music  # noqa: E402

N, BPS = 1024, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6))
def _jax_lpc(tok, hi, lo, n, bps, M, max_fixed):
    """JAX's LPC stages as _analyze_core_exact composes them (:1169-1188)."""
    with dd.pinned(tok):
        ac = (hi, lo)
        ev, _, _, r_lev, kappa = _levinson_dd(ac, M)
        winv = dd.const(welch_inverse_squared_sum(n))
        evc = dd.mul(ev, (jnp.broadcast_to(winv[0], ev[0].shape),
                          jnp.broadcast_to(winv[1], ev[1].shape)))
        orders, r_ord = _select_order_exact(evc, n, bps, M, max_fixed,
                                            kappa)
        _, coefs, _, _, _ = _levinson_dd(ac, M, orders)
        intc, rshifts, r_q = _quantize_exact(
            coefs, orders, LPC_COEFFICIENT_BITWIDTH,
            1 << RSHIFT_LPC_COEFFICIENT_BITWIDTH, kappa)
        return orders, rshifts, intc, r_lev | r_ord | r_q


def _lags(M: int) -> np.ndarray:
    """Ridged lags (V, M + 1) of pre-emphasised rows of N samples: 12 blocks
    of make_music's two channels, white noise, a sine, silence and a row
    whose r0 is near the silent threshold."""
    music = make_music(6 * N / 44100 + 0.01)
    rows = [music[c, k * N:(k + 1) * N] for c in range(2) for k in range(6)]
    rng = np.random.RandomState(M)
    t = np.arange(N)
    rows += [rng.randint(-30000, 30000, N), np.sin(t * 0.05) * 20000,
             np.zeros(N), np.where(t % 97 == 0, 1, 0)]
    work, _, _ = exact.preemphasis_exact(
        torch.from_numpy(np.stack(rows).astype(np.int32)))
    ac = autocorr_plain(work, N, BPS, M + 1, N)
    ac[:, 0] = ac[:, 0] * (1.0 + LPC_RIDGE_REGULARIZATION_PARAMETER)
    return ac.numpy()


@pytest.mark.parametrize("M", [8, 32, 255])
def test_lpc_analyze_matches_jax_and_host(M):
    lags = _lags(M)
    orders, rshifts, intc, risky = (
        t.numpy() for t in lpc_analyze(torch.from_numpy(lags), N, BPS, M,
                                       False))
    hi, lo = dd.split_f64(lags)
    jo, jr, jc, jrisky = (np.asarray(a) for a in jax.device_get(
        _jax_lpc(np.int32(0), hi, lo, N, BPS, M, False)))
    ho, hr, hc = chip_smoke.host_lpc(np, lags, N, BPS, M, False)
    ok = ~risky & ~jrisky
    assert ok.mean() > 0.75, ok.mean()
    for port, jax_, host, what in ((orders, jo, ho, "orders"),
                                   (rshifts, jr, hr, "rshifts"),
                                   (intc, jc, hc, "coefficients")):
        np.testing.assert_array_equal(port[ok], jax_[ok], err_msg=what)
        np.testing.assert_array_equal(port[~risky], host[~risky],
                                      err_msg=what)


def _edge_lags(M: int) -> np.ndarray:
    """Lag rows (2, M + 1) on which the recursion meets given reflection
    coefficients (chip_smoke.lags_from_reflections' step-up recursion, in
    exact rationals): one gain of 0.45 at order 1 and none after (the
    argmin at order 1), and +-5/32 in turns at every order (each order saves
    more than its 8 bits at N samples: the argmin at M; the coefficients
    grow to sum |a| ~ 1.2e7 at M 128, so the widened conditioning estimate
    flags that row from M 127 on)."""
    rows = []
    for refl in ([Fraction(0.45)] + [Fraction(0)] * (M - 1),
                 [Fraction(5 * (-1) ** m, 32) for m in range(M)]):
        r, a, ev = [Fraction(1)], [Fraction(1)], Fraction(1)
        for m in range(1, M + 1):
            g = refl[m - 1]
            r.append(-g * ev - sum(a[j] * r[m - j] for j in range(1, m)))
            a = [x + g * y for x, y in zip(a + [Fraction(0)],
                                           [Fraction(0)] + a[::-1])]
            ev *= 1 - g * g
        rows.append([float(v) for v in r])
    return np.asarray(rows)


def _check_against_jax_and_host(lags, M: int, max_fixed: bool,
                                jax_rows: int):
    """lpc_analyze on CPU tensors equal to the host on every row it does
    not flag, and to JAX on the first jax_rows rows where neither flags."""
    orders, rshifts, intc, risky = (
        t.numpy() for t in lpc_analyze(torch.from_numpy(lags), N, BPS, M,
                                       max_fixed))
    hi, lo = dd.split_f64(lags)
    jo, jr, jc, jrisky = (np.asarray(a) for a in jax.device_get(
        _jax_lpc(np.int32(0), hi, lo, N, BPS, M, max_fixed)))
    ho, hr, hc = chip_smoke.host_lpc(np, lags, N, BPS, M, max_fixed)
    ok = ~risky & ~jrisky
    ok[jax_rows:] = False
    assert ok.mean() > 0.6, ok.mean()
    for port, jax_, host, what in ((orders, jo, ho, "orders"),
                                   (rshifts, jr, hr, "rshifts"),
                                   (intc, jc, hc, "coefficients")):
        np.testing.assert_array_equal(port[ok], jax_[ok], err_msg=what)
        np.testing.assert_array_equal(port[~risky], host[~risky],
                                      err_msg=what)
    return orders, risky


@pytest.mark.parametrize("M", [7, 31, 63, 64, 127, 128])
def test_lpc_analyze_at_group_widths_matches_jax_and_host(M):
    """M on both sides of each change of K7's group width G (8 up to M 64,
    16 up to 128, 32 above; 8, 32 and 255 above): the plain version equal
    to JAX and the host on every row neither flags, on the rows of _lags
    (silence and a near-silent row among them), and to the host on two rows
    whose argmin is order 1 and order M. Those two are not held against
    JAX: its df64 recursion drifts on the second (at M 127 its error
    variance at order 100 is ~1e-3 relative from the f64 one, unflagged,
    and it picks order 123 where the host and the port pick 127). The
    second is flagged from M 127 on, where its coefficients' growth widens
    the margins (kernels/levinson.py, above _EPS_SILENT), and not below."""
    base = _lags(M)
    lags = np.concatenate([base, _edge_lags(M)])
    orders, risky = _check_against_jax_and_host(lags, M, False, len(base))
    assert orders[-2] == 1 and orders[-1] == M and not risky[-2]
    assert risky[-1] == (M > 64)


def test_lpc_analyze_max_fixed_matches_jax_and_host():
    """The order fixed at M (no order choice): equal to JAX and the host
    on every row neither flags."""
    lags = np.concatenate([_lags(32), _edge_lags(32)])
    orders, _ = _check_against_jax_and_host(lags, 32, True, len(lags))
    assert (orders == 32).all()


@pytest.mark.parametrize("case", range(3))
def test_boundary_rows_are_flagged(case):
    name, lags, n, bps, M, fixed, must, must_not = \
        chip_smoke.k7_boundary_cases(np)[case]
    port = lpc_analyze(torch.from_numpy(chip_smoke.moved(np, lags)), n, bps,
                       M, fixed)
    chip_smoke.check_flag_contract(
        np, name, [t.numpy() for t in port[:3]],
        chip_smoke.host_lpc(np, lags, n, bps, M, fixed), port[3].numpy(),
        must, must_not)


def test_routing_cpu_plain_meta_raises():
    ac = torch.from_numpy(_lags(8))
    before = lpc_analyze.launches
    got = lpc_analyze(ac, N, BPS, 8, False)
    assert lpc_analyze.launches == before
    for g, w in zip(got, lpc_analyze_plain(ac, N, BPS, 8, False)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        lpc_analyze(torch.empty((2, 9), dtype=torch.float64, device="meta"),
                    N, BPS, 8, False)


@pytest.mark.parametrize("M", [8, 64, 255])
def test_svr_entries_compose_to_the_fused_analysis(M):
    """lpc_coefs_plain then lpc_quantize_plain with cerr 0 (an SVR that
    adopts the initial vector) give lpc_analyze_plain's orders, shifts,
    coefficients and flags, bit for bit."""
    ac = torch.from_numpy(_lags(M))
    orders, coefs, kappa, r_c = lpc_coefs_plain(ac, N, BPS, M, False)
    rshifts, intc, r_q = lpc_quantize_plain(
        coefs, orders, kappa, torch.zeros_like(kappa))
    want = lpc_analyze_plain(ac, N, BPS, M, False)
    for g, w in zip((orders, rshifts, intc, r_c | r_q), want):
        assert torch.equal(g, w)


def test_k7_coefs_check_refuses_a_move_past_its_allowance():
    """k7_coefs_check passes the plain version against itself and moved by
    half its allowance (4 kappa' 2^-42 max|c|, on the smallest coefficient
    of a row), and refuses a move of twice it, or a changed flag."""
    ac = torch.from_numpy(_lags(32))
    want = lpc_coefs_plain(ac, N, BPS, 32, False)
    orders, coefs, kappa, risky = want
    row = int(np.flatnonzero((~risky & (orders > 4)).numpy())[0])
    j = int(coefs[row, :int(orders[row])].abs().argmin())
    allow = 4.0 * 2.0 ** -42 * float(kappa[row]) \
        * float(coefs[row].abs().max())

    def check(got):
        chip_smoke.k7_coefs_check(torch, "test", got, want, 32,
                                  chip_smoke.new_k7_coefs_tally())

    check(want)
    for step, ok in ((0.5, True), (2.0, False)):
        moved = coefs.clone()
        moved[row, j] += step * allow
        if ok:
            check((orders, moved, kappa, risky))
        else:
            with pytest.raises(RuntimeError, match="chip_smoke check"):
                check((orders, moved, kappa, risky))
    flipped = risky.clone()
    flipped[row] = True
    with pytest.raises(RuntimeError, match="chip_smoke check"):
        check((orders, coefs, kappa, flipped))


@functools.partial(jax.jit, static_argnums=(4,))
def _jax_quantize(tok, hi, orders, kappa, M):
    """JAX's quantization (_quantize_exact) of coefficients exact in f32."""
    with dd.pinned(tok):
        return _quantize_exact((hi, jnp.zeros_like(hi)), orders,
                               LPC_COEFFICIENT_BITWIDTH,
                               1 << RSHIFT_LPC_COEFFICIENT_BITWIDTH, kappa)


@pytest.mark.parametrize("M", [32, 64, 128, 255])
def test_quantize_plain_matches_jax_and_host(M):
    """lpc_quantize_plain with no widening on the finite rows of
    chip_smoke.k7_quantize_batch, their coefficients rounded to f32 (JAX
    reads them as (hi, 0) exactly): equal shifts and values to the host's
    quantize_coefficients on every row it does not flag, and to JAX's
    _quantize_exact on every row neither flags at M <= 128. At M 255 JAX
    rounds one unflagged row (order 244) differently from the host and the
    port from its 13th coefficient on, where the f64 chain's value lies
    8e-5 from a half: the host alone holds it there."""
    from srla_tpu_torch.dsp.quantize import quantize_coefficients
    coefs, orders, kappa, _ = chip_smoke.k7_quantize_batch(np, 200, M, M)
    mask = np.arange(M)[None, :] < orders[:, None]
    rows = np.isfinite(np.where(mask, coefs, 0.0)).all(axis=1)
    coefs = np.where(mask, coefs, 0.0)[rows].astype(np.float32)
    orders, kappa = orders[rows], kappa[rows]
    rshifts, intc, risky = (t.numpy() for t in lpc_quantize_plain(
        torch.from_numpy(coefs.astype(np.float64)), torch.from_numpy(orders),
        torch.from_numpy(kappa), torch.zeros(len(kappa), dtype=torch.float64)))
    hintc, hrshifts = quantize_coefficients(
        coefs.astype(np.float64), orders, LPC_COEFFICIENT_BITWIDTH,
        1 << RSHIFT_LPC_COEFFICIENT_BITWIDTH)
    ok = ~risky
    assert ok.mean() > 0.75, ok.mean()
    np.testing.assert_array_equal(rshifts[ok], hrshifts[ok])
    np.testing.assert_array_equal(intc[ok], hintc[ok])
    if M > 128:
        return
    jintc, jrshifts, jrisky = (np.asarray(x) for x in _jax_quantize(
        np.int32(0), coefs, orders, kappa, M))
    ok &= ~jrisky
    assert ok.mean() > 0.75, ok.mean()
    np.testing.assert_array_equal(rshifts[ok], jrshifts[ok])
    np.testing.assert_array_equal(intc[ok], jintc[ok])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("M", [32, 64, 128, 255])
def test_quantize_entry_random_batch_on_card(cuda, M):
    """K7's quantization entry on chip_smoke.k7_quantize_batch (1197 rows,
    no multiple of a tile): equal to its plain version on every output,
    the flags and the NaN and inf rows too; one launch."""
    args = tuple(torch.from_numpy(a).to(cuda) for a in
                 chip_smoke.k7_quantize_batch(np, chip_smoke.K7Q_BATCH_ROWS,
                                              M, M))
    before = lpc_quantize.launches
    assert chip_smoke.k7_quantize_check(torch, f"M {M}", args) > 0
    assert lpc_quantize.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("widening", chip_smoke.K7Q_WIDENINGS)
def test_quantize_entry_boundary_rows_on_card(cuda, widening):
    """K7's quantization entry on the coefficients of k7_quantize_case's
    lags (a rounding half, the frexp and tiny edges), cerr widening x
    max|c|: equal to its plain version on every output."""
    _, lags, n, bps, M, fixed, must, _ = chip_smoke.k7_quantize_case(np)
    orders, coefs, kappa, _ = lpc_coefs(torch.from_numpy(lags).to(cuda), n,
                                        bps, M, fixed)
    cerr = coefs.abs().max(dim=1).values * widening
    flagged = chip_smoke.k7_quantize_check(torch, f"cerr {widening:g}",
                                           (coefs, orders, kappa, cerr))
    assert flagged >= int(must.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("M", [8, 64, 255])
def test_svr_entries_match_plain_on_card(cuda, M):
    """K7's coefficient entry within k7_coefs_check's allowance of its plain
    version (flags equal, orders equal where unflagged), and its
    quantization entry, given the same coefficients and a widening,
    bit-equal to its plain version; one launch each."""
    ac = torch.from_numpy(_lags(M)).to(cuda)
    before = (lpc_coefs.launches, lpc_quantize.launches)
    got = lpc_coefs(ac, N, BPS, M, False)
    want = lpc_coefs_plain(ac, N, BPS, M, False)
    torch.cuda.synchronize()
    chip_smoke.k7_coefs_check(torch, f"M {M}", got, want, M,
                              chip_smoke.new_k7_coefs_tally())
    orders, coefs, kappa, _ = got
    cerr = coefs.abs().max(dim=1).values * 1e-9
    q = lpc_quantize(coefs, orders, kappa, cerr)
    for g, w in zip(q, lpc_quantize_plain(coefs, orders, kappa, cerr)):
        assert torch.equal(g, w)
    assert (lpc_coefs.launches, lpc_quantize.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [8, 32, 255])
def test_lpc_analyze_kernel_matches_plain_on_card(cuda, M):
    ac = torch.from_numpy(_lags(M)).to(cuda)
    before = lpc_analyze.launches
    got = lpc_analyze(ac, N, BPS, M, False)
    want = lpc_analyze_plain(ac, N, BPS, M, False)
    torch.cuda.synchronize()
    assert lpc_analyze.launches == before + 1
    assert torch.equal(got[3], want[3])
    ok = ~got[3]
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g[ok], w[ok])


@pytest.mark.gpu
@pytest.mark.parametrize("M", [8, 64, 100, 128, 255])
def test_lpc_analyze_partial_warps_on_card(cuda, M):
    """13 rows, not a multiple of K7's rows a warp (32 / G: 4 at M <= 64,
    2 at M <= 128): every row equal to the plain version where neither
    flags and flagged alike, the rows past V in the last warp not stored."""
    lags = np.concatenate([_lags(M)[:11], _edge_lags(M)])
    ac = torch.from_numpy(lags).to(cuda)
    got = lpc_analyze(ac, N, BPS, M, False)
    want = lpc_analyze_plain(ac, N, BPS, M, False)
    torch.cuda.synchronize()
    assert torch.equal(got[3], want[3])
    ok = ~got[3]
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g[ok], w[ok])


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(3))
def test_boundary_rows_are_flagged_on_card(cuda, case):
    name, lags, n, bps, M, fixed, must, must_not = \
        chip_smoke.k7_boundary_cases(np)[case]
    port = lpc_analyze(torch.from_numpy(chip_smoke.moved(np, lags)).to(cuda),
                       n, bps, M, fixed)
    chip_smoke.check_flag_contract(
        np, name, [t.cpu().numpy() for t in port[:3]],
        chip_smoke.host_lpc(np, lags, n, bps, M, fixed),
        port[3].cpu().numpy(), must, must_not)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [64, 128, 255])
def test_coefficient_growth_rows_on_card(cuda, M):
    """K7 on the +-5/32 growth row (chip_smoke.k7_growth_case), its lags
    moved by 2^-42: flagged at M 128 and 255, where the moved lags change
    the order, as the plain version flags it; not at M 64."""
    name, lags, n, bps, M, fixed, must, must_not = \
        chip_smoke.k7_growth_case(np, M)
    ac = torch.from_numpy(chip_smoke.moved(np, lags))
    port = lpc_analyze(ac.to(cuda), n, bps, M, fixed)
    plain = lpc_analyze_plain(ac, n, bps, M, fixed)
    assert torch.equal(port[3].cpu(), plain[3])
    chip_smoke.check_flag_contract(
        np, name, [t.cpu().numpy() for t in port[:3]],
        chip_smoke.host_lpc(np, lags, n, bps, M, fixed),
        port[3].cpu().numpy(), must, must_not)


@pytest.mark.gpu
def test_lpc_analyze_wrong_dtype_raises_on_card(cuda):
    with pytest.raises(ValueError):
        lpc_analyze(torch.zeros((2, 9), dtype=torch.float32, device=cuda),
                    N, BPS, 8, False)
