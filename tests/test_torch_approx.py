"""The port's f32 approximate encode (``SRLA_TPU_APPROX=1``:
srla_tpu_torch.kernels.encode, K14 lpc_f32, K15 rice_cost) against its JAX
twin, srla_tpu.kernels.encode, on JAX-CPU, and end to end on the CPU (the
kernels' plain versions).

Stage by stage, on the same inputs (rows cut from make_segmented and
make_music by a seeded numpy generator, 16 and 24 bits, with a silent and a
white-noise row): floats within a stated tolerance (lags within 1e-5 of lag
0; error variances within 1e-4 of lag 0 and coefficients within 1e-4 of the
row's largest), and every integer decision (pre-emphasis coefficient,
order, quantized coefficient and shift, pitch period and LTP coefficients,
code type, partition order, Rice parameters) equal on every row whose
deciding float lies farther than that tolerance from its decision
boundary; the rows that lie nearer are counted, printed and held under 1 %
of the rows. K15's bits are the exact length of the section K5 packs, on
every row (full-range, all-zero and int32-extreme rows too). The port's
selection, pack and assembly on JAX's own analysis give srla_tpu's
approximate stream byte for byte. The port's approximate encode decodes
losslessly, within 2 % of the exact size."""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import srla_tpu  # noqa: E402
from srla_tpu.kernels import encode as J  # noqa: E402
from srla_tpu_torch import SRLAEncoder, cli, decode, parallel  # noqa: E402
from srla_tpu_torch import host_encoder  # noqa: E402
from srla_tpu_torch.constants import (HEADER_SIZE,  # noqa: E402
                                      BlockDataType)
from srla_tpu_torch.format import parse_block_header  # noqa: E402
from srla_tpu_torch.host_encoder import make_parameter  # noqa: E402
from srla_tpu_torch.kernels import encode as P  # noqa: E402
from srla_tpu_torch.kernels import exact as texact  # noqa: E402
from srla_tpu_torch.kernels import lpc_f32  # noqa: E402
from srla_tpu_torch.kernels import rice_cost as K15  # noqa: E402
from srla_tpu_torch.kernels.preemphasis import (  # noqa: E402
    Spans, as_blocks, preemphasis_f32_rows, preemphasis_f32_sums,
    variant_preemphasis_f32)
from srla_tpu_torch.kernels.bitpack import (  # noqa: E402
    residual_codewords, zigzag32)
from srla_tpu_torch.rice import MLNOPTX  # noqa: E402
from srla_tpu_torch.signals import make_music, make_segmented  # noqa: E402
from srla_tpu_torch.wavio import WavData, read_audio, write_wav  # noqa: E402

RATE = 44100
AC_TOL = 1e-5          # lags: relative to lag 0
LEV_TOL = 1e-4         # error variances (of lag 0) and coefficients
NEAR_SHARE = 0.01      # rows near a boundary: under 1 % of the rows
EVAL_REL = 2.0 ** -21  # f32 evaluation (log, sqrt, division): 8 ulps

_pre = jax.jit(J._preemphasis)
_autocorr = jax.jit(J._autocorr, static_argnums=(1, 2, 3, 4))
_levinson = jax.jit(J._levinson, static_argnums=(1,))
_select = jax.jit(J._select_order, static_argnums=(1, 2, 3, 4))
_quantize = jax.jit(J._quantize, static_argnums=(2, 3))
_predict = jax.jit(J._predict, static_argnums=(4,))
_ltp = jax.jit(J._ltp, static_argnums=(1, 2, 3, 4))
_rice = jax.jit(J._rice_cost, static_argnums=(1, 2))


def _rows(V: int, n: int, bps: int, seed: int) -> np.ndarray:
    """V rows of n samples cut at seeded offsets from 3 s of segmented
    music (odd rows from make_music), scaled to bps bits (24: shifted up 8
    with seeded low bits); row 0 silent, row 1 full-range white noise."""
    rng = np.random.RandomState(seed)
    seg, mus = make_segmented(3.0), make_music(3.0)
    offs = rng.randint(0, seg.shape[1] - n, V)
    rows = np.stack([(seg if i % 2 == 0 else mus)[(i // 2) % 2, o:o + n]
                     for i, o in enumerate(offs)]).astype(np.int64)
    if bps > 16:
        rows = (rows << (bps - 16)) + rng.randint(0, 1 << (bps - 16),
                                                  rows.shape)
    rows[0] = 0
    rows[1] = rng.randint(-(1 << (bps - 1)), 1 << (bps - 1), n)
    return rows.astype(np.int32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _near_report(what: str, near: np.ndarray, V: int) -> None:
    """Print the rows near a boundary and hold them under 1 %."""
    rows = np.flatnonzero(near)
    print(f"{what}: {len(rows)} of {V} rows near a boundary: {rows}")
    assert len(rows) <= NEAR_SHARE * V, (what, rows)


def _band(a, b, rel: float = EVAL_REL):
    """The band around a deciding float that its two values, a (JAX's) and
    b (the port's), leave open: four times their difference, and the f32
    evaluation's own allowance."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return 4.0 * np.abs(a - b) + rel * np.maximum(np.abs(a), np.abs(b))


def _half_in(lo, hi) -> np.ndarray:
    """Whether [lo, hi] holds a half-integer (a round-half boundary)."""
    return np.floor(lo - 0.5) != np.floor(hi - 0.5)


def _jax_lags(work: np.ndarray, n: int, bps: int, M: int) -> np.ndarray:
    ac = np.array(_autocorr(jnp.asarray(work), n, bps, M + 1,
                            1 << (n - 1).bit_length()))
    ac[:, 0] *= np.float32(1.0 + 1e-5)
    return ac


def _f64_lengths(ev: np.ndarray, n: int, bps: int) -> np.ndarray:
    """_select_order's lengths in f64 from the f32 error variances."""
    from srla_tpu_torch.dsp.window import welch_inverse_squared_sum
    e = np.maximum(ev[:, 1:].astype(np.float64)
                   * welch_inverse_squared_sum(n), 0.0)
    mabse = 2.0 * np.sqrt(e / 2.0)
    rho = 1.0 / (1.0 + mabse * (1 << (bps - 1)))
    inv = np.maximum(1.0 - rho, 1e-30)
    ent = -(inv * np.log(inv) + rho * np.log(rho)) / np.log(2.0) / rho
    ent = np.where(mabse < 1e-16, 0.0, ent)
    return ent * n + 8.0 * np.arange(1, ev.shape[1])[None, :]


def _order_near(ev_jax: np.ndarray, ev_port: np.ndarray, n: int,
                bps: int) -> np.ndarray:
    """Rows whose two least lengths (from JAX's error variances) lie within
    the band the two sides' lengths leave of each other."""
    lj = _f64_lengths(ev_jax, n, bps)
    band = _band(lj, _f64_lengths(ev_port, n, bps)).max(axis=1)
    part = np.sort(lj, axis=1)
    return part[:, 1] - part[:, 0] <= 2 * band


def _quant_chain(coefs: np.ndarray, order: int) -> np.ndarray:
    """_quantize's values qe of one row, the f32 chain replayed in numpy
    (empty for a row whose coefficients are all 0 after it)."""
    c = coefs[:order].astype(np.float32)
    m = np.abs(c).max() if order else 0.0
    if m <= 2.0 ** -7:
        return np.zeros(0)
    shift = 7 - int(np.frexp(np.float32(m))[1])
    scale = np.float32(2.0 ** (15 if (shift >= 16 or shift < 0) else shift))
    out, qerr = [], np.float32(0)
    for i in range(order - 1, -1, -1):
        qe = np.float32(qerr + np.float32(c[i] * scale))
        out.append(qe)
        qerr = np.float32(qe - np.float32(np.clip(np.round(qe), -128, 127)))
    return np.array(out, np.float64)


def _quant_near(cj: np.ndarray, cp: np.ndarray, orders) -> np.ndarray:
    """Rows where a step of the quantization lies within the band JAX's and
    the port's coefficients leave of a half, or whose shifts' frexp
    exponent could differ."""
    near = np.zeros(len(orders), bool)
    for r, o in enumerate(orders):
        qj, qp = _quant_chain(cj[r], int(o)), _quant_chain(cp[r], int(o))
        if len(qj) != len(qp):
            near[r] = True
            continue
        b = _band(qj, qp)
        near[r] = _half_in(np.minimum(qj, qp) - b,
                           np.maximum(qj, qp) + b).any()
    return near


# ---------------------------------------------------------------------------
# Stage by stage against JAX
# ---------------------------------------------------------------------------

_pre_sums = jax.jit(lambda s: (
    jnp.sum(s.astype(jnp.float32) ** 2, axis=1),
    jnp.sum(s[:, :-1].astype(jnp.float32) * s[:, 1:].astype(jnp.float32),
            axis=1)))


@pytest.mark.parametrize("bps", [16, 24])
def test_preemphasis_matches_jax(bps):
    V, n = 48, 4096
    sig = _rows(V, n, bps, seed=bps)
    wj, cj = (np.asarray(a) for a in _pre(jnp.asarray(sig)))
    wp, cp = (a.numpy() for a in P.preemphasis(_t(sig)))
    r0j, r1j = (np.asarray(a, np.float64) for a in _pre_sums(
        jnp.asarray(sig)))
    r0p, r1p = (a.double().numpy() for a in preemphasis_f32_sums(_t(sig)))
    assert (np.abs(r0p - r0j) <= LEV_TOL * r0j).all()
    fj = 16.0 * r1j / np.maximum(r0j, 1e-30)
    fp = 16.0 * r1p / np.maximum(r0p, 1e-30)
    b = _band(fj, fp)
    near = _half_in(np.minimum(fj, fp) - b, np.maximum(fj, fp) + b)
    _near_report(f"pre-emphasis {bps} bit", near, V)
    np.testing.assert_array_equal(cp[~near], cj[~near])
    np.testing.assert_array_equal(wp[~near], wj[~near])


def test_preemphasis_f32_rows_matches_jax_at_24_bits_16384():
    """K16's f32 entry's plain version against JAX's _preemphasis on
    24-bit rows of 16384 samples, where r0 passes 2^53: decisions equal
    off the band, as test_preemphasis_matches_jax holds them."""
    V, n = 24, 16384
    sig = _rows(V, n, 24, seed=53)
    wj, cj = (np.asarray(a) for a in _pre(jnp.asarray(sig)))
    wp, cp = (a.numpy() for a in preemphasis_f32_rows(_t(sig)))
    r0j, r1j = (np.asarray(a, np.float64) for a in _pre_sums(
        jnp.asarray(sig)))
    r0p, r1p = (a.double().numpy() for a in preemphasis_f32_sums(_t(sig)))
    assert (r0p > 2.0 ** 53).sum() >= V // 2
    assert (np.abs(r0p - r0j) <= LEV_TOL * r0j).all()
    fj = 16.0 * r1j / np.maximum(r0j, 1e-30)
    fp = 16.0 * r1p / np.maximum(r0p, 1e-30)
    b = _band(fj, fp)
    near = _half_in(np.minimum(fj, fp) - b, np.maximum(fj, fp) + b)
    _near_report("pre-emphasis 24 bit n 16384", near, V)
    np.testing.assert_array_equal(cp[~near], cj[~near])
    np.testing.assert_array_equal(wp[~near], wj[~near])


def test_preemphasis_f32_sums_round_once():
    """r0 = 2^60 + 2^36 + 1 rounds to 2^60 + 2^37 in f32 directly; through
    f64 it would round to 2^60 + 2^36, then to 2^60 (a tie, to even)."""
    sig = np.zeros((2, 8), np.int32)
    sig[0, :3] = (1 << 30, 1 << 18, 1)
    sig[1, 0] = 3
    r0, r1 = preemphasis_f32_sums(_t(sig))
    assert float(r0[0]) == float(np.float32(2.0 ** 60 + 2.0 ** 37))
    assert float(np.float32(np.float64((1 << 60) + (1 << 36) + 1))) \
        == 2.0 ** 60
    assert float(r1[0]) == 2.0 ** 48          # 2^48 + 2^18, rounded
    assert float(r0[1]) == 9.0 and float(r1[1]) == 0.0


@pytest.mark.parametrize("C,lshift,dtype", [(2, 0, np.int16),
                                            (3, 2, np.int32),
                                            (1, 0, np.int16)])
def test_variant_preemphasis_f32_matches_jax_stack(C, lshift, dtype):
    """K16's f32 entry (its plain version) on the resident file's spans
    equals it on the cut blocks and equals JAX's stack (analyze_blocks_ex
    :429-435) and _preemphasis on every row not near a boundary, pre_prev
    the stacked rows' first samples."""
    n, B = 1024, 9
    pcm = make_segmented(2.0)
    file = np.concatenate([pcm, pcm[:1] - pcm[1:]])[:C]
    if dtype == np.int32:
        file = (file.astype(np.int32) << 8) + 77
    file = np.ascontiguousarray(file.astype(dtype))
    offs = np.random.RandomState(C).randint(0, file.shape[1] - n, B)
    spans = Spans(_t(file), offs, n)
    got = variant_preemphasis_f32(spans, lshift)
    cut = variant_preemphasis_f32(spans.cut(), lshift)
    for g, c in zip(got, cut):
        assert torch.equal(g, c)
    blocks = np.stack([file[:, o:o + n] for o in offs]).astype(np.int32)
    w = blocks >> lshift
    parts = []
    if C >= 2:
        d = w[:, 1] - w[:, 0]
        parts += [w[:, 0] + (d >> 1), d]
    sig = np.concatenate(parts + [w[:, c] for c in range(C)])
    wj, cj = (np.asarray(a) for a in _pre(jnp.asarray(sig)))
    np.testing.assert_array_equal(got[2].numpy(), sig[:, 0])
    r0j, r1j = (np.asarray(a, np.float64) for a in _pre_sums(
        jnp.asarray(sig)))
    r0p, r1p = (a.double().numpy() for a in preemphasis_f32_sums(_t(sig)))
    fj = 16.0 * r1j / np.maximum(r0j, 1e-30)
    fp = 16.0 * r1p / np.maximum(r0p, 1e-30)
    b = _band(fj, fp)
    near = _half_in(np.minimum(fj, fp) - b, np.maximum(fj, fp) + b)
    _near_report(f"f32 entry C {C}", near, len(sig))
    np.testing.assert_array_equal(got[1].numpy()[~near], cj[~near])
    np.testing.assert_array_equal(got[0].numpy()[~near], wj[~near])


def test_measure_spans_approx_reads_spans_in_place():
    """measure_spans_approx on the resident file's spans (read in place by
    K16's f32 entry) gives the bits of the cut path: the spans cut, the
    variant rows stacked and analysed by analyze_variants, K17's
    measurement entry."""
    from srla_tpu_torch.kernels.exact import variant_stack
    from srla_tpu_torch.kernels.select import measure_blocks
    pcm = make_segmented(2.0)
    file = _t(np.ascontiguousarray(pcm.astype(np.int16)))
    n = 2048
    offs = [5, 777, 4096, 20001, 40000]
    args = dict(n=n, bps=16, max_params=32, max_fixed=False, fft_size=n,
                max_porder=8)
    got = P.measure_spans_approx(file, offs, 0, C=2, **args)
    out = P.analyze_variants(variant_stack(Spans(file, offs, n).cut(), 0),
                             **args)
    V = out["orders"].shape[0]
    z = torch.zeros(V, dtype=torch.int32)
    want = measure_blocks(dict(section_bits=out["rice_bits"],
                               orders=out["orders"], coefs=out["coefs"],
                               ltp_period=z, ltp_coefs=z[:, None]),
                          B=len(offs), C=2, bps=16, max_params=32)["bits"]
    assert torch.equal(got, want)


@pytest.mark.parametrize("order", [1, 3])
def test_ltp_delay_fir_is_k18_plain(order):
    """_ltp's delay FIR (:274-285) is K18's arithmetic: ltp.ltp_predict
    (its plain version here) on JAX's own periods and reversed
    coefficients gives JAX's filtered rows, every row."""
    from srla_tpu_torch.kernels.ltp import ltp_predict
    n = 1024
    work = np.asarray(_pre(jnp.asarray(_rows(48, n, 16, seed=order)))[0])
    wj, pj, qj = (np.asarray(a) for a in _ltp(jnp.asarray(work), n, 16, n,
                                               order))
    assert (pj > 0).sum() > 8
    got = ltp_predict(_t(work), _t(qj.astype(np.int32)),
                      _t(pj.astype(np.int32)), order)
    np.testing.assert_array_equal(got.numpy(), wj)


@pytest.mark.parametrize("n,M", [(256, 8), (1024, 32), (4096, 64),
                                 (4096, 262)])
def test_autocorr_matches_jax(n, M):
    sig = _rows(24, n, 16, seed=n + M)
    work = np.asarray(_pre(jnp.asarray(sig))[0])
    fft = 1 << (n - 1).bit_length()
    aj = np.asarray(_autocorr(jnp.asarray(work), n, 16, M + 1, fft))
    ap = P.autocorr(_t(work), n, 16, M + 1, fft).numpy()
    assert ap.shape == aj.shape
    assert (np.abs(ap - aj) <= AC_TOL * np.abs(aj[:, :1])).all()
    np.testing.assert_array_equal(P.welch_f32(n, "cpu").numpy(),
                                  J._welch_f32(n))


@pytest.mark.parametrize("M,n,bps", [(8, 256, 16), (32, 1024, 16),
                                     (64, 4096, 16), (64, 4096, 24)])
def test_levinson_matches_jax(M, n, bps):
    V = 48
    work = np.asarray(_pre(jnp.asarray(_rows(V, n, bps, seed=M)))[0])
    ac = _jax_lags(work, n, bps, M)
    evj = np.asarray(_levinson(jnp.asarray(ac), M, None)[0])
    evp = lpc_f32.levinson_f32(_t(ac), M)[0].numpy()
    assert (np.abs(evp - evj) <= LEV_TOL * np.abs(evj[:, :1])).all()
    orders = np.asarray(_select(jnp.asarray(evj), n, bps, M, False))
    cj = np.asarray(_levinson(jnp.asarray(ac), M, jnp.asarray(orders))[1])
    cp = lpc_f32.levinson_f32(_t(ac), M, _t(orders))[1].numpy()
    scale = np.maximum(1.0, np.abs(cj).max(axis=1, keepdims=True))
    assert (np.abs(cp - cj) <= LEV_TOL * scale).all()


@pytest.mark.parametrize("M,n,bps", [(8, 256, 16), (32, 1024, 24),
                                     (64, 4096, 16)])
def test_select_order_matches_jax(M, n, bps):
    """The same error variances on both sides: the lengths differ only by
    the f32 evaluation (EVAL_REL)."""
    V = 48
    work = np.asarray(_pre(jnp.asarray(_rows(V, n, bps, seed=3 * M)))[0])
    ev = np.asarray(_levinson(jnp.asarray(_jax_lags(work, n, bps, M)), M,
                              None)[0])
    oj = np.asarray(_select(jnp.asarray(ev), n, bps, M, False))
    op = lpc_f32.select_order_f32(_t(ev), n, bps, M, False).numpy()
    near = _order_near(ev, ev, n, bps)
    _near_report(f"order M {M}", near, V)
    np.testing.assert_array_equal(op[~near], oj[~near])
    fixed = lpc_f32.select_order_f32(_t(ev), n, bps, M, True).numpy()
    np.testing.assert_array_equal(
        fixed, np.asarray(_select(jnp.asarray(ev), n, bps, M, True)))


@pytest.mark.parametrize("M", [8, 32, 64])
def test_quantize_matches_jax(M):
    """Every step is the same f32 operation on both sides: equal on every
    row, silent, tiny and order-M rows and half-even ties included."""
    V, n = 48, 2048
    work = np.asarray(_pre(jnp.asarray(_rows(V, n, 16, seed=M)))[0])
    ac = _jax_lags(work, n, 16, M)
    orders = np.array(_select(jnp.asarray(np.asarray(
        _levinson(jnp.asarray(ac), M, None)[0])), n, 16, M, False))
    orders[2] = M
    coefs = np.array(_levinson(jnp.asarray(ac), M, jnp.asarray(orders))[1])
    coefs[3] *= np.float32(2.0 ** -14)                     # a tiny row
    coefs[4, :orders[4]] = np.float32(0.50390625)          # half-even ties
    ij, sj = (np.asarray(a) for a in _quantize(jnp.asarray(coefs),
                                               jnp.asarray(orders), 8, 16))
    ip, sp = (a.numpy() for a in lpc_f32.quantize_f32(_t(coefs),
                                                      _t(orders)))
    np.testing.assert_array_equal(ip, ij)
    np.testing.assert_array_equal(sp, sj)
    assert (sj[3] == 8) and not ij[3].any()
    assert sj[4] == 7 and ij[4, 0] == 64


@pytest.mark.parametrize("M,n,bps", [(8, 256, 16), (32, 1024, 24),
                                     (64, 4096, 16)])
def test_lpc_analyze_f32_matches_jax_chain(M, n, bps):
    """K14's plain version against JAX's _levinson, _select_order,
    _levinson, _quantize on the same lags."""
    V = 48
    work = np.asarray(_pre(jnp.asarray(_rows(V, n, bps, seed=5 * M)))[0])
    ac = _jax_lags(work, n, bps, M)
    evj = np.asarray(_levinson(jnp.asarray(ac), M, None)[0])
    oj = np.asarray(_select(jnp.asarray(evj), n, bps, M, False))
    cj = np.asarray(_levinson(jnp.asarray(ac), M, jnp.asarray(oj))[1])
    ij, sj = (np.asarray(a) for a in _quantize(jnp.asarray(cj),
                                               jnp.asarray(oj), 8, 16))
    op, ip, sp = (a.numpy() for a in lpc_f32.lpc_analyze_f32(
        _t(ac), n, bps, M, False))
    evp = lpc_f32.levinson_f32(_t(ac), M)[0].numpy()
    cp = lpc_f32.levinson_f32(_t(ac), M, _t(oj))[1].numpy()
    near = _order_near(evj, evp, n, bps) | _quant_near(cj, cp, oj)
    _near_report(f"K14 M {M}", near, V)
    np.testing.assert_array_equal(op[~near], oj[~near])
    np.testing.assert_array_equal(ip[~near], ij[~near])
    np.testing.assert_array_equal(sp[~near], sj[~near])


def _pitch_near(aj: np.ndarray, ap: np.ndarray) -> np.ndarray:
    """Rows whose pitch choice lies within the band JAX's and the port's
    lags leave of a boundary: a lag in [8, 262) that is or may become a
    candidate (within the band of 0.9 of the largest peak or above)
    against a neighbour or against 0.9 of the largest peak, or the largest
    peak against 0.1 of lag 0 (or near 0)."""
    a = aj.astype(np.float64)
    band = _band(aj, ap).max(axis=1, keepdims=True) \
        + EVAL_REL * np.abs(a[:, :1])
    j = np.arange(a.shape[1])
    inr = (j >= 8) & (j < 262)
    peak = np.zeros_like(a, bool)
    peak[:, 1:-1] = ((a[:, 1:-1] > a[:, :-2]) & (a[:, 1:-1] > a[:, 2:])
                     & (a[:, 1:-1] > 0))
    mp = np.where(peak & inr, a, 0).max(axis=1, keepdims=True)
    # Each comparison's two floats move by at most 1.9 times the largest
    # difference of a lag: the band (four times it) covers them.
    live = inr & (a >= 0.9 * mp - band)
    d = np.zeros_like(a, bool)
    d[:, 1:-1] = ((np.abs(a[:, 1:-1] - a[:, :-2]) < band)
                  | (np.abs(a[:, 1:-1] - a[:, 2:]) < band))
    close = d | (np.abs(a - 0.9 * mp) < band)
    return ((close & live).any(axis=1)
            | (np.abs(mp - 0.1 * a[:, :1]) < band)[:, 0]
            | ((mp < band) & (mp > 0))[:, 0])


def _jax_csol(acl: np.ndarray, period: np.ndarray, order: int):
    """_ltp's f32 solve (encode.py:247-264) on JAX's side, at each row's
    period (its safe_p)."""
    a = jnp.asarray(acl)
    h = order // 2
    p = jnp.asarray(np.maximum(period, h + 1))
    r0r = a[:, 0] * np.float32(1.0 + 1e-5)
    if order == 1:
        rhs0 = jnp.take_along_axis(a, p[:, None], axis=1)[:, 0]
        return np.asarray((rhs0 / jnp.where(jnp.abs(r0r) < 1e-35, 1.0,
                                            r0r))[:, None])
    rows = [jnp.stack([r0r if i == k else a[:, abs(i - k)]
                       for k in range(order)], axis=1)
            for i in range(order)]
    rhs = jnp.take_along_axis(a, p[:, None] - h + jnp.arange(order)[None, :],
                              axis=1)
    return np.asarray(jnp.linalg.solve(jnp.stack(rows, axis=1),
                                       rhs[..., None])[..., 0])


def _ltp_quant_near(cj: np.ndarray, cp: np.ndarray,
                    period: np.ndarray) -> np.ndarray:
    """Rows with a period (JAX's) and an LTP coefficient whose 32 c + 0.5
    lies within the band JAX's and the port's f32 solves leave of an
    integer."""
    qj = cj.astype(np.float64) * 32.0 + 0.5
    qp = cp.astype(np.float64) * 32.0 + 0.5
    b = _band(qj, qp)
    with np.errstate(invalid="ignore"):
        near = _half_in(np.minimum(qj, qp) - b + 0.5,
                        np.maximum(qj, qp) + b + 0.5).any(axis=1)
    return near & (period > 0)


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("n,bps", [(1024, 16), (4096, 24)])
def test_ltp_matches_jax(order, n, bps):
    V = 48
    work = np.asarray(_pre(jnp.asarray(_rows(V, n, bps, seed=order + n)))[0])
    wj, pj, qj = (np.asarray(a) for a in _ltp(jnp.asarray(work), n, bps, n,
                                               order))
    wp, pp, qp = (a.numpy() for a in P.ltp(_t(work), n, bps, n, order))
    aj = np.asarray(_autocorr(jnp.asarray(work), n, bps, 263, n))
    ap = P.autocorr(_t(work), n, bps, 263, n).numpy()
    safe = _t(np.maximum(pj, order // 2 + 1).astype(np.int64))
    qnear = _ltp_quant_near(_jax_csol(aj, pj, order),
                            P.ltp_solve(_t(ap), safe, order)[0].numpy(), pj)
    near = _pitch_near(aj, ap) | qnear
    _near_report(f"LTP order {order}", near, V)
    assert pj[~near].any()
    np.testing.assert_array_equal(pp[~near], pj[~near])
    np.testing.assert_array_equal(qp[~near], qj[~near])
    np.testing.assert_array_equal(wp[~near], wj[~near])
    # On JAX's own lags the pitch choice is equal on every row, and the
    # coefficients wherever the two f32 solves are clear of a quantization
    # boundary.
    pl, ql = (a.numpy() for a in P.ltp_params(_t(aj), order))
    np.testing.assert_array_equal(pl, pj)
    qn = _ltp_quant_near(_jax_csol(aj, pj, order),
                         P.ltp_solve(_t(aj), safe, order)[0].numpy(), pj)
    np.testing.assert_array_equal(ql[~qn], qj[~qn])


_part_means = jax.jit(lambda u, n, p: jnp.sum(
    u.astype(jnp.float32).reshape(u.shape[0], 1 << p, n >> p), axis=2)
    / (n >> p), static_argnums=(1, 2))


def _k_of(m: np.ndarray, rec) -> np.ndarray:
    """The f64 Rice parameter of partition means (before the clip)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        k2 = np.floor(np.log2(np.maximum(1.0, MLNOPTX * (1.0 + m))))
        om = np.maximum(1.0 - 1.0 / (1.0 + m), 1e-30)
        kr = np.round(np.log2(np.maximum(-MLNOPTX / np.log(om), 1e-30)))
    return np.clip(np.where(rec, k2, kr), 0, 30)


def _rice_near(residual: np.ndarray, n: int, max_porder: int) -> np.ndarray:
    """Rows whose code type, or some partition's parameter (of any order),
    lies within the band JAX's f32 means (the codes summed in f32 in XLA's
    order) and the port's (exact sums rounded once) leave of a
    boundary."""
    u = ((residual.astype(np.int64) << 1) ^ (residual.astype(np.int64) >> 31)
         ) & 0xFFFFFFFF
    uj = jnp.asarray(u.astype(np.uint32))
    V = len(u)
    mj = np.asarray(_part_means(uj, n, 0), np.float64)[:, 0]
    mp = np.float32(u.sum(1)) / np.float32(n)
    b = _band(mj, mp)
    near = (np.minimum(mj, mp) - b <= 2.0) & (np.maximum(mj, mp) + b >= 2.0)
    rec = (mp >= 2.0)[:, None]
    for p in range(max_porder + 1):
        mj = np.asarray(_part_means(uj, n, p), np.float64)
        mp = (np.float32(u.reshape(V, 1 << p, n >> p).sum(2))
              / np.float32(n >> p)).astype(np.float64)
        b = _band(mj, mp)
        lo, hi = np.minimum(mj, mp) - b, np.maximum(mj, mp) + b
        near |= (_k_of(np.maximum(lo, 0), rec) != _k_of(hi, rec)).any(axis=1)
    return near


@pytest.mark.parametrize("n,M,max_porder,bps", [(256, 8, 8, 16),
                                                (1024, 32, 10, 24),
                                                (4096, 64, 10, 16),
                                                (4064, 64, 5, 16)])
def test_rice_cost_matches_jax(n, M, max_porder, bps):
    V = 48
    work = np.asarray(_pre(jnp.asarray(_rows(V, n, bps, seed=n)))[0])
    o, i, s = (a.numpy() for a in lpc_f32.lpc_analyze_f32(
        _t(_jax_lags(work, n, bps, M)), n, bps, M, False))
    rev = J._reverse_coefs(jnp.asarray(i), jnp.asarray(o))
    res = np.array(_predict(jnp.asarray(work), rev, jnp.asarray(o),
                            jnp.asarray(s), n))
    res[2] = 0                                  # ALLZERO
    res[3] = np.where(np.arange(n) % 2, 1, 0)   # mean of codes exactly 1
    res[4] = 1                                  # codes 2: row mean 2
    a = [np.asarray(x) for x in _rice(jnp.asarray(res), n, max_porder)]
    b = [x.numpy() for x in K15.rice_cost_plain(_t(res), n, max_porder)]
    # Rows 2-4 are built on boundaries, their sums exact on both sides.
    near = _rice_near(res, n, max_porder)
    near[2:5] = False
    _near_report(f"K15 n {n}", near, V)
    for x, y in zip(b, a):
        np.testing.assert_array_equal(x[~near], y[~near])
    assert b[0][2] == 2 and b[2][2] == 2 and b[0][4] == 1


def _packed_bits(residual: np.ndarray, ct, po, ks, n: int) -> np.ndarray:
    """The length of the section K5's plain version packs from these
    parameters: the total of residual_codewords' stream."""
    return residual_codewords(texact.zigzag(_t(residual)), ct, po, ks,
                              n)[1].numpy()


@pytest.mark.parametrize("bps", [16, 24])
def test_rice_bits_are_packed_lengths(bps):
    """Exact, on every row: K15's bits equal the packed section's length
    (what keeps the approximate stream lossless) on analysed rows,
    full-range rows, all-zero (ALLZERO) rows, rows of one code and rows
    whose codes reach 2^31 and above."""
    n, max_porder = 1024, 10
    rng = np.random.RandomState(bps)
    work = np.asarray(_pre(jnp.asarray(_rows(24, n, bps, seed=9)))[0])
    o, i, s = (a.numpy() for a in lpc_f32.lpc_analyze_f32(
        _t(_jax_lags(work, n, bps, 32)), n, bps, 32, False))
    rev = J._reverse_coefs(jnp.asarray(i), jnp.asarray(o))
    res = np.array(_predict(jnp.asarray(work), rev, jnp.asarray(o),
                            jnp.asarray(s), n))
    full = rng.randint(-(1 << (bps - 1)), 1 << (bps - 1), (4, n))
    ext = rng.randint(-(1 << 31), 1 << 31, (4, n), dtype=np.int64)
    ext[1, ::7] = -(1 << 31)
    ext[2] = np.where(rng.rand(n) < 0.5, (1 << 30) + 5, -(1 << 30) - 5)
    ext[3, :] = 0
    ext[3, 100] = (1 << 31) - 1
    res = np.concatenate([res, full, np.zeros((2, n)), np.ones((1, n)),
                          ext]).astype(np.int32)
    ct, po, bits, ks = K15.rice_cost_plain(_t(res), n, max_porder)
    np.testing.assert_array_equal(bits.numpy(),
                                  _packed_bits(res, ct, po, ks, n))
    assert (ct.numpy()[28:30] == 2).all()
    # Below 2^31 (every row but the extreme ones) JAX's count is the
    # packed length too; its int32 view of larger codes is not.
    a = [np.asarray(x) for x in _rice(jnp.asarray(res), n, max_porder)]
    codes = (res.astype(np.int64) << 1) ^ (res.astype(np.int64) >> 31)
    small = (codes & 0xFFFFFFFF).max(axis=1) < (1 << 31)
    same = small & (a[0] == ct.numpy()) & (a[1] == po.numpy()) \
        & (a[3] == ks.numpy()).all(axis=1)
    np.testing.assert_array_equal(a[2][same], bits.numpy()[same])
    assert (a[2][~small] != bits.numpy()[~small]).any()


# ---------------------------------------------------------------------------
# The port's selection, pack and assembly on JAX's own analysis
# ---------------------------------------------------------------------------

def _jax_approx_env(monkeypatch):
    monkeypatch.setenv("SRLA_TPU_APPROX", "1")
    monkeypatch.setenv("SRLA_TPU_HOST_SHARE", "0")
    monkeypatch.setenv("SRLA_PACK_IMPL", "scatter")
    monkeypatch.setenv("SRLA_TPU_MIN_GROUP_ROWS", "1")


def _jax_analysis(blocks, lshift, *, n, bps, max_params, max_fixed,
                  fft_size, max_porder, C, ltp_order=0, timer=None):
    """srla_tpu's analyze_blocks_ex on the port's blocks (the spans cut
    where the encode hands over ``Spans``), padded to its 128-block bucket
    as srla_tpu pads them, its rows for the real blocks handed to the port
    through from_jax_analysis."""
    blocks = as_blocks(blocks)
    B = blocks.shape[0]
    Bp = (B + 127) // 128 * 128
    padded = np.zeros((Bp, C, n), np.int32)
    padded[:B] = blocks.numpy()
    small, big = jax.device_get(J.analyze_blocks_ex(
        padded, np.int32(lshift), n=n, bps=bps, max_params=max_params,
        max_fixed=max_fixed, fft_size=fft_size, max_porder=max_porder, C=C,
        ltp_order=ltp_order))
    nvar = C + 2 if C >= 2 else 1
    rows = (np.arange(nvar)[:, None] * Bp + np.arange(B)[None, :]).ravel()
    return texact.from_jax_analysis({k: np.asarray(v)[rows]
                                     for k, v in small.items()},
                                    {k: np.asarray(v)[rows]
                                     for k, v in big.items()}, "cpu")


@pytest.mark.parametrize("C,preset,ltp", [(2, 4, 0), (2, 2, 0), (1, 4, 0),
                                          (1, 2, 0), (2, 4, 3)])
def test_carried_across_equals_jax_approx(monkeypatch, C, preset, ltp):
    """srla_tpu's approximate encode, byte for byte, from the port's
    selection, K5's plain version and assembly run on srla_tpu's own
    analysis (two groups: 21 blocks of 1024 and a tail of 546)."""
    _jax_approx_env(monkeypatch)
    pcm = make_music(0.5)[:C]
    want = srla_tpu.encode(pcm, 16, RATE, preset=preset, max_block=1024,
                           ltp_order=ltp, backend="tpu")
    monkeypatch.setattr(P, "analyze_blocks_ex", _jax_analysis)
    enc = SRLAEncoder(make_parameter(C, 16, RATE, preset, 1024, 0, 4, ltp,
                                     0), "cpu", approx=True)
    got = enc.encode_whole(pcm)
    assert got == want
    assert enc.stats["device_blocks"] == 22
    assert enc.stats["repaired_blocks"] == 0


def test_from_jax_analysis_takes_approx_small():
    """srla_tpu's approximate small has no risky: every row unflagged."""
    blocks = np.stack([make_music(0.2)[:, k * 512:(k + 1) * 512]
                       for k in range(3)]).astype(np.int32)
    small, big = jax.device_get(J.analyze_blocks_ex(
        blocks, np.int32(0), n=512, bps=16, max_params=16, max_fixed=False,
        fft_size=512, max_porder=9, C=2))
    assert "risky" not in small
    s, b = texact.from_jax_analysis(small, big, "cpu")
    assert s["risky"].dtype == torch.bool and s["risky"].shape == (12,)
    assert not s["risky"].any()
    np.testing.assert_array_equal(s["section_bits"].numpy(),
                                  small["section_bits"])
    np.testing.assert_array_equal(b["u"].numpy(),
                                  np.asarray(big["u"]).astype(np.int64))


def test_port_analysis_matches_jax_analyze_blocks_ex():
    """The port's analyze_blocks_ex on a whole group equals srla_tpu's on
    every row not near a boundary (here: all)."""
    pcm = make_music(0.4)
    blocks = np.stack([pcm[:, k * 1024:(k + 1) * 1024]
                       for k in range(17)]).astype(np.int32)
    args = dict(n=1024, bps=16, max_params=32, max_fixed=False,
                fft_size=1024, max_porder=10, C=2)
    js, jb = jax.device_get(J.analyze_blocks_ex(blocks, np.int32(0),
                                                **args))
    ps, pb = P.analyze_blocks_ex(_t(blocks), 0, **args)
    for k in ("pre_coef", "orders", "rshifts", "coefs", "code_type",
              "porder", "section_bits"):
        np.testing.assert_array_equal(ps[k].numpy(), np.asarray(js[k]), k)
    np.testing.assert_array_equal(
        zigzag32(pb["residual"]).numpy().view(np.uint32), np.asarray(jb["u"]))
    np.testing.assert_array_equal(pb["ks"].numpy(), np.asarray(jb["ks"]))


# ---------------------------------------------------------------------------
# End to end on the CPU
# ---------------------------------------------------------------------------

def _compress_blocks(stream: bytes) -> int:
    from srla_tpu_torch.format import decode_header
    h = decode_header(stream)
    off, done, count = HEADER_SIZE, 0, 0
    while done < h.num_samples:
        t, ns, poff, psize = parse_block_header(stream, off)
        count += t == BlockDataType.COMPRESS
        off, done = poff + psize, done + ns
    return count


@pytest.mark.parametrize("kind,C,preset", [("music", 2, 4),
                                           ("segmented", 2, 4),
                                           ("music", 1, 2),
                                           ("segmented", 2, 6),
                                           ("music", 1, 1),
                                           ("segmented", 1, 3),
                                           ("music", 1, 5)])
def test_approx_encode_lossless_within_two_percent(kind, C, preset):
    pcm = (make_music if kind == "music" else make_segmented)(1.5)[:C]
    enc = SRLAEncoder(make_parameter(C, 16, RATE, preset, 4096, 0, 4, 0, 0),
                      "cpu", approx=True)
    got = enc.encode_whole(pcm)
    exact = host_encoder.encode(pcm, 16, RATE, preset=preset)
    assert len(got) <= 1.02 * len(exact), (len(got), len(exact))
    np.testing.assert_array_equal(decode(got, "cpu")[1], pcm)
    np.testing.assert_array_equal(srla_tpu.decode(got)[1], pcm)
    assert enc.stats["device_blocks"] == _compress_blocks(got)
    assert enc.stats["repaired_blocks"] == 0
    assert enc.stats["host_blocks"] == 0


def test_approx_encode_24_bit_ltp_fixed_blocks():
    """-P 3 at fixed block sizes runs the approximate LTP on the device
    (the 546-sample tail below 512 lags' FFT size too, without LTP)."""
    pcm = make_music(0.5) << 8
    enc = SRLAEncoder(make_parameter(2, 24, RATE, 4, 1024, 0, 4, 3, 0),
                      "cpu", approx=True)
    got = enc.encode_whole(pcm)
    assert enc.approx
    np.testing.assert_array_equal(decode(got, "cpu")[1], pcm)
    assert len(got) <= 1.02 * len(host_encoder.encode(
        pcm, 24, RATE, preset=4, max_block=1024, ltp_order=3))
    assert enc.stats["device_blocks"] == _compress_blocks(got)
    assert enc.stats["host_blocks"] == 0


def test_approx_short_ltp_blocks_and_odd_tail():
    """Under approx every even size goes to the device, LTP groups under
    512 samples too (analysed without LTP: 256 lags' FFT is under 263);
    the odd last block stays on the host, as in srla_tpu."""
    pcm = make_music(0.3)[:, :12901] << 8        # a 101-sample odd tail
    enc = SRLAEncoder(make_parameter(2, 24, RATE, 4, 256, 0, 4, 3, 0),
                      "cpu", approx=True)
    got = enc.encode_whole(pcm)
    np.testing.assert_array_equal(decode(got, "cpu")[1], pcm)
    np.testing.assert_array_equal(srla_tpu.decode(got)[1], pcm)
    assert enc.stats["host_blocks"] == 0
    assert enc.stats["device_blocks"] == _compress_blocks(got) - 1
    assert len(got) <= 1.02 * len(host_encoder.encode(
        pcm, 24, RATE, preset=4, max_block=256, ltp_order=3))


@pytest.mark.parametrize("tail,preset,block", [(101, 4, 256), (131, 2, 256),
                                               (1, 0, 256), (77, 2, 128)])
def test_odd_short_ltp_block_encodes(tail, preset, block):
    """A fault of the exact host encoder, srla_tpu's and the port's copy
    alike: with -P, an odd COMPRESS block under 263 samples at a max block
    under 263 read its pitch lags past the work-buffer state and raised.
    The port's copy now reads fresh arena memory (zeros) there: the stream
    decodes losslessly and the port's device encode equals it."""
    pcm = make_music(0.3)[:, :12800 + tail]
    args = dict(preset=preset, max_block=block, ltp_order=3)
    want = host_encoder.encode(pcm, 16, RATE, **args)
    np.testing.assert_array_equal(decode(want, "cpu")[1], pcm)
    np.testing.assert_array_equal(srla_tpu.decode(want)[1], pcm)
    assert SRLAEncoder(make_parameter(2, 16, RATE, preset, block, 0, 4, 3,
                                      0), "cpu").encode_whole(pcm) == want
    with pytest.raises(ValueError):
        srla_tpu.encode(pcm, 16, RATE, backend="exact", **args)


def test_approx_encode_files_equals_each_file():
    """encode_files batches the files' blocks into shared groups; the
    analysis is row by row, so each stream is its file's own approximate
    encode."""
    from srla_tpu_torch import encode_files
    files = [make_music(0.4, seed=3), make_segmented(0.3, seed=5),
             make_music(0.2, seed=8)]
    got = encode_files(files, 16, RATE, "cpu", max_block=1024, approx=True)
    for x, g in zip(files, got):
        assert g == SRLAEncoder(make_parameter(2, 16, RATE, 4, 1024, 0, 4,
                                               0, 0), "cpu",
                                approx=True).encode_whole(x)
        np.testing.assert_array_equal(decode(g, "cpu")[1], x)


def test_approx_variable_blocks_measure_on_device():
    pcm = make_segmented(2.0)
    enc = SRLAEncoder(make_parameter(2, 16, RATE, 4, 4096, 1, 4, 0, 0),
                      "cpu", approx=True)
    got = enc.encode_whole(pcm)
    np.testing.assert_array_equal(decode(got, "cpu")[1], pcm)
    exact = host_encoder.encode(pcm, 16, RATE, preset=4,
                                variable_divisions=1)
    assert len(got) <= 1.02 * len(exact)
    host = host_encoder.SRLAEncoder(make_parameter(2, 16, RATE, 4, 4096, 1,
                                                   4, 0, 0))
    host.encode_whole(pcm)
    spans = host.stats["host_spans"]
    assert spans > 0
    assert enc.stats["device_spans"] == spans
    assert enc.stats["remeasured_spans"] == 0
    assert enc.stats["host_spans"] == 0


def test_approx_ltp_variable_takes_exact_path():
    """srla_tpu/encoder.py:170-175: approx with LTP at -V > 0 is exact."""
    pcm = make_music(1.0)
    enc = SRLAEncoder(make_parameter(2, 16, RATE, 4, 4096, 1, 4, 3, 0),
                      "cpu", approx=True)
    assert not enc.approx
    assert enc.encode_whole(pcm) == host_encoder.encode(
        pcm, 16, RATE, preset=4, variable_divisions=1, ltp_order=3)


def test_cli_reads_srla_tpu_approx(monkeypatch, tmp_path):
    pcm = make_music(1.0)
    wav = tmp_path / "in.wav"
    write_wav(str(wav), WavData(pcm, RATE, 16))
    monkeypatch.setenv("SRLA_TPU_APPROX", "1")
    assert cli.main(["-e", "-V", "0", "--device", "cpu", str(wav),
                     str(tmp_path / "a.srl")]) == 0
    got = (tmp_path / "a.srl").read_bytes()
    want = SRLAEncoder(make_parameter(2, 16, RATE, 4, 4096, 0, 4, 0, 0),
                       "cpu", approx=True).encode_whole(pcm)
    assert got == want
    monkeypatch.delenv("SRLA_TPU_APPROX")
    assert cli.main(["-e", "-V", "0", "--device", "cpu", str(wav),
                     str(tmp_path / "x.srl")]) == 0
    assert (tmp_path / "x.srl").read_bytes() == host_encoder.encode(
        pcm, 16, RATE, preset=4)
    assert cli.main(["-d", "--device", "cpu", str(tmp_path / "a.srl"),
                     str(tmp_path / "o.wav")]) == 0
    np.testing.assert_array_equal(read_audio(str(tmp_path / "o.wav")).pcm,
                                  pcm)


# ---------------------------------------------------------------------------
# parallel: the sharded analysis step, the pack and gather entry points
# ---------------------------------------------------------------------------

def test_full_step_sharded_matches_single_and_jax():
    rng = np.random.RandomState(0)
    V, n = 32, 256
    sig = (rng.randn(V, n) * 2000).astype(np.int32)
    args = dict(n=n, bps=16, max_params=8, max_fixed=False, fft_size=256,
                max_porder=6)
    out, total = parallel.full_step_sharded(["cpu", "cpu"], sig, **args)
    single = P.analyze_variants(_t(sig), **args)
    np.testing.assert_array_equal(out["residual"].numpy(),
                                  single["residual"].numpy())
    assert total == float(single["rice_bits"].sum())
    jx = J.analyze_variants(sig, **args)
    np.testing.assert_array_equal(out["residual"].numpy(),
                                  np.asarray(jx["residual"]))
    np.testing.assert_array_equal(out["rice_bits"].numpy(),
                                  np.asarray(jx["rice_bits"]))
    sharded = parallel.analyze_variants_sharded(["cpu"] * 3, sig, **args)
    for k, v in single.items():
        np.testing.assert_array_equal(sharded[k].numpy(), v.numpy(), k)


def test_pack_chosen_and_gather_sections_match_jax():
    rng = np.random.RandomState(4)
    V, n, W = 12, 512, 400
    sig = (rng.randn(V, n) * 3000).astype(np.int32)
    args = dict(n=n, bps=16, max_params=16, max_fixed=False, fft_size=n,
                max_porder=9)
    js, jw = J.analyze_pack_variants(jnp.asarray(sig), W=W, **args)
    ps, pw = P.analyze_pack_variants(_t(sig), W=W, **args)
    np.testing.assert_array_equal(pw.numpy().view(np.uint32),
                                  np.asarray(jw))
    np.testing.assert_array_equal(ps["section_bits"].numpy(),
                                  np.asarray(js["section_bits"]))
    chosen = np.array([3, 0, 7, 11, 5], np.int32)
    lens = (np.asarray(js["section_bits"])[chosen] + 31) // 32
    starts = (np.cumsum(lens) - lens).astype(np.int32)
    cap = int(lens.sum()) + 37
    want = np.asarray(J.gather_sections(jw, jnp.asarray(chosen),
                                        jnp.asarray(starts),
                                        jnp.asarray(lens), cap=cap))
    got = P.gather_sections(pw, _t(chosen), _t(starts), _t(lens), cap)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    core = P.analyze_variants(_t(sig), **args)
    u = texact.zigzag(core["residual"])
    jcore = J.analyze_variants(sig, **args)
    flat_j, ovf_j = J.pack_chosen(J._zigzag(jcore["residual"]),
                                  jcore["code_type"], jcore["porder"],
                                  jcore["ks"], jnp.asarray(chosen),
                                  jnp.asarray(starts), jnp.asarray(lens),
                                  n=n, W=W, cap=cap)
    flat_p, ovf_p = P.pack_chosen(u, core["code_type"], core["porder"],
                                  core["ks"], _t(chosen).long(),
                                  _t(starts), _t(lens), n=n, W=W, cap=cap)
    np.testing.assert_array_equal(flat_p.numpy().view(np.uint32),
                                  np.asarray(flat_j))
    assert not ovf_p.any() and not np.asarray(ovf_j).any()


def test_approx_encode_split_equals_unsplit():
    pcm = make_music(1.0)
    param = make_parameter(2, 16, RATE, 4, 1024, 0, 4, 0, 0)
    one = SRLAEncoder(param, "cpu", approx=True).encode_whole(pcm)
    enc = SRLAEncoder(param, "cpu", devices=["cpu", "cpu"], approx=True)
    assert enc.encode_whole(pcm) == one
    assert enc.stats["shard_cuts"] == [[21, 22], [1]]


def test_approx_env_is_not_read_by_the_library(monkeypatch):
    """Only the CLI reads SRLA_TPU_APPROX: the library takes approx=."""
    monkeypatch.setenv("SRLA_TPU_APPROX", "1")
    pcm = make_music(0.3)
    assert SRLAEncoder(make_parameter(2, 16, RATE, 4, 4096, 0, 4, 0, 0),
                       "cpu").encode_whole(pcm) == host_encoder.encode(
        pcm, 16, RATE, preset=4)
    assert os.environ["SRLA_TPU_APPROX"] == "1"
