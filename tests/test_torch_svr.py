"""SVR refinement (--svr-filter-learning-iteration) in the port, on the
CPU at small shapes (M <= 16, n <= 1024): the estimator, K11's plain
version (``svr_cov_plain``) and K12's (``svr_refine_plain``) against the
host's ``dsp/svr.py`` and JAX's ``_svr_exact``, and the -m 0 encode.

Tolerances:

- estimator: where the k2 flag is down, the objective is within
  _EPS_SVR_LIBM = 1e-12 bits of the host's (the two sides' log and pow
  differ by at most an ulp each); rows within 1e-13 of a k2 boundary are
  flagged;
- covariance: bit-equal to the host's (no libm, the host's sum order);
- refinement from the host's initial coefficients: bit-equal where the
  inverse pivots (1/sqrt against libm's pow(s, -0.5)) agree, else within
  the row's own bound ``cerr`` (svr.py's margins), which is far below any
  step, so the adopted iteration and every stop are the host's;
- against JAX's df64 refinement: equal decisions on rows neither flags,
  coefficients within 2^-24 of the largest, df64's (~2^-44 a rounding)
  error through the solve and its refinement step.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import srla_tpu  # noqa: E402
from srla_tpu.kernels import df64 as dd  # noqa: E402
from srla_tpu.kernels.exact import _svr_exact  # noqa: E402
from srla_tpu_torch import SRLAEncoder, host_encoder  # noqa: E402
from srla_tpu_torch.constants import (  # noqa: E402
    LPC_RIDGE_REGULARIZATION_PARAMETER as RIDGE, SVR_MARGIN_LIST)
from srla_tpu_torch.dsp import svr as host_svr  # noqa: E402
from srla_tpu_torch.dsp.autocorr import autocorr_fft  # noqa: E402
from srla_tpu_torch.dsp.levinson import (levinson_coefs_at,  # noqa: E402
                                         levinson_error_vars)
from srla_tpu_torch.dsp.pitch import cholesky_decompose  # noqa: E402
from srla_tpu_torch.dsp.window import (welch_inverse_squared_sum,  # noqa: E402
                                       welch_window)
from srla_tpu_torch.kernels import exact, svr  # noqa: E402
from srla_tpu_torch.signals import make_music  # noqa: E402

N, M, BPS = 1024, 16, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def svr_rows(n: int = N, seed: int = 0) -> np.ndarray:
    """Pre-emphasised rows (V, n) int32: make_music's variants of 4 blocks,
    a pure sine (an ill-conditioned covariance), a near-silent row, white
    noise and a row of zeros."""
    music = make_music(4 * n / 44100 + 0.01)
    blocks = np.ascontiguousarray(
        music[:, :4 * n].reshape(2, 4, n).transpose(1, 0, 2))
    sig = exact.variant_stack(torch.from_numpy(blocks), 0)
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    extra = np.stack([
        np.round(np.sin(t * 0.05) * 12000),
        rng.randint(-2, 3, n) * (rng.rand(n) < 0.02),
        rng.randint(-3000, 3000, n),
        np.zeros(n)]).astype(np.int32)
    sig = torch.cat([sig, torch.from_numpy(extra)])
    work, _, _ = exact.preemphasis_exact(sig)
    return work.numpy()


def host_init(work: np.ndarray, n: int, max_params: int, preset: int):
    """The host's Levinson coefficients at its chosen orders, as
    host_encoder._analyze_channel hands them to SVR: (dbl, coefs, orders)."""
    dbl = work.astype(np.float64) * 2.0 ** -(BPS - 1)
    ac = autocorr_fft(dbl * welch_window(n), n, max_params + 1)
    ac[:, 0] *= 1.0 + RIDGE
    enc = host_encoder.SRLAEncoder(host_encoder.make_parameter(
        2, BPS, 44100, preset=preset, max_block=n))
    ev, _ = levinson_error_vars(ac, max_params)
    orders = enc._select_order(ev * welch_inverse_squared_sum(n), n,
                               max_params)
    return dbl, levinson_coefs_at(ac, max_params, orders), orders


def host_cov(dbl_row: np.ndarray, n: int, o: int) -> np.ndarray:
    cov = host_svr._covariance(dbl_row[:n], n, o)
    cov[np.diag_indices(o)] *= 1.0 + RIDGE
    return cov


# ---------------------------------------------------------------------------
# The estimator (NOTES trap 4: its unit test first)
# ---------------------------------------------------------------------------

def _host_log2v(mean: float) -> float:
    """The host estimator's log2v (dsp/svr.py:_rgr_mean_code_length)."""
    rho = 1.0 / (1.0 + mean * 65536.0)
    om = 1.0 - rho
    lv = math.log(0.5127629514) / (-math.inf if om == 0 else math.log(om))
    return (-math.inf if lv == 0 else math.log(lv)) * svr.INV_LOGE2


def _host_k2(mean: float) -> int:
    return int(max(0.0, _host_log2v(mean)))


def _boundary_mean(j: int) -> float:
    """A mean at which the estimate's log2v is j, near enough."""
    om = math.exp(svr.LOG_OPTX / 2.0 ** j)
    return (1.0 / (1.0 - om) - 1.0) / 65536.0


def test_code_length_against_host_across_every_k2_boundary():
    """Means swept across each k2 boundary 1..26 (and at random): the
    objective within _EPS_SVR_LIBM of the host's where the flag is down;
    flagged where the host's log2v is within 1e-13 of an integer >= 1, not
    flagged where it is more than 1e-11 away; k2 steps at each boundary."""
    means = []
    for j in range(1, 27):
        m0 = _boundary_mean(j)
        # Walk to the float means closest to the boundary on either side.
        lo, hi = m0 * (1 - 1e-6), m0 * (1 + 1e-6)
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if _host_log2v(mid) < j:
                lo = mid
            else:
                hi = mid
        means += [lo, hi, lo * (1 - 1e-9), hi * (1 + 1e-9),
                  lo * (1 - 1e-6), hi * (1 + 1e-6)]
    rng = np.random.RandomState(1)
    means += list(10.0 ** rng.uniform(-7, 2, 200)) + [0.0, 1e-30]
    m = torch.tensor(means, dtype=torch.float64)
    eps = torch.full_like(m, svr._EPS_SVR_LIBM)
    obj, risky = svr.rgr_mean_code_length(m, eps)
    risky = risky.numpy()
    host = np.array([host_svr._rgr_mean_code_length(x, 16) for x in means])
    log2v = np.array([_host_log2v(x) for x in means])
    near = np.round(log2v)
    with np.errstate(invalid="ignore"):      # log2v = -inf at mean 0
        dist = np.abs(log2v - near)
    assert np.all(np.abs(obj.numpy() - host)[~risky] <= svr._EPS_SVR_LIBM)
    assert risky[(near >= 1) & (dist < 1e-13)].all()
    assert not risky[dist > 1e-11].any()
    assert ((near >= 1) & (dist < 1e-13)).sum() >= 20
    k2 = np.array([_host_k2(x) for x in means[:26 * 6]]).reshape(26, 6)
    assert (k2[:, 0] == np.arange(0, 26)).all()
    assert (k2[:, 1] == np.arange(1, 27)).all()


def test_code_length_sensitivity_within_the_stated_factor():
    """Between k2 boundaries the objective moves by at most 2 h / ln 2 bits
    for a relative change h of the mean (svr.py's eps_obj rests on it)."""
    rng = np.random.RandomState(2)
    m = torch.tensor(10.0 ** rng.uniform(-7, 2, 2000), dtype=torch.float64)
    h = 1e-6
    zero = torch.zeros_like(m)
    a, _ = svr.rgr_mean_code_length(m, zero)
    b, _ = svr.rgr_mean_code_length(m * (1 + h), zero)
    k_a = np.array([_host_k2(x) for x in m.tolist()])
    k_b = np.array([_host_k2(x) for x in (m * (1 + h)).tolist()])
    same = k_a == k_b
    assert same.sum() > 1900
    assert ((a - b).abs().numpy()[same] <= 2 * h / math.log(2.0)).all()


# ---------------------------------------------------------------------------
# K11's plain version
# ---------------------------------------------------------------------------

def test_svr_cov_plain_equals_host_covariance():
    work = svr_rows()
    dbl, _, orders = host_init(work, N, M, 2)
    orders = orders.copy()
    orders[-1] = 0                         # a row of order 0: all zero
    orders[0] = M                          # and one at the full order
    cov = svr.svr_cov_plain(torch.from_numpy(work),
                            torch.from_numpy(orders), N, BPS, M,
                            RIDGE).numpy()
    for b, o in enumerate(orders):
        want = np.zeros((M, M))
        if o:
            want[:o, :o] = host_cov(dbl[b], N, o)
        assert np.array_equal(cov[b], want), b


# ---------------------------------------------------------------------------
# K12's plain version against the host and JAX
# ---------------------------------------------------------------------------

def _plain_from_host(work, dbl, coefs, orders, n, max_params, iters):
    w = torch.from_numpy(work)
    o = torch.from_numpy(orders.astype(np.int32))
    cov = svr.svr_cov_plain(w, o, n, BPS, max_params, RIDGE)
    got = svr.svr_refine_plain(
        w, cov, torch.from_numpy(coefs[:, :max_params]), o, n, BPS, iters,
        SVR_MARGIN_LIST, RIDGE, torch.zeros(len(orders), dtype=torch.float64))
    return cov, [t.numpy() for t in got]


def _pivots_agree(dbl_row, n: int, o: int) -> bool:
    """Whether 1/sqrt(s) equals libm's pow(s, -0.5) at every pivot s of the
    host's factor of this row (dsp/pitch.py's loop, replayed)."""
    A = host_cov(dbl_row, n, o)
    for i in range(o):
        s = A[i, i]
        for k in range(i - 1, -1, -1):
            s -= A[i, k] * A[i, k]
        if s <= 0.0:
            return True
        inv = math.pow(s, -0.5)
        if inv != 1.0 / math.sqrt(s):
            return False
        for j in range(i + 1, o):
            t = A[i, j]
            for k in range(i - 1, -1, -1):
                t -= A[i, k] * A[j, k]
            A[j, i] = t * inv
    return True


@pytest.mark.parametrize("iters", [1, 2, 3])
def test_svr_refine_plain_takes_the_host_decisions(iters):
    work = svr_rows()
    dbl, coefs, orders = host_init(work, N, M, 2)
    want, _ = host_svr.svr_refine_batch(dbl, coefs, orders, N, iters, BPS,
                                        RIDGE, SVR_MARGIN_LIST)
    _, (best, cerr, risky, n_it) = _plain_from_host(
        work, dbl, coefs, orders, N, M, iters)
    assert not risky.any()
    equal = 0
    for b, o in enumerate(orders):
        diff = np.abs(best[b, :o] - want[b, :o]).max() if o else 0.0
        if _pivots_agree(dbl[b], N, o):
            assert diff == 0.0, b
            equal += 1
        else:
            assert diff <= cerr[b], (b, diff, cerr[b])
        assert (best[b, o:] == 0).all()
    assert equal >= 1                      # (1/sqrt and pow often differ)
    if iters == 1:
        # One iteration scores the initial vector only.
        assert np.array_equal(best, np.where(
            np.arange(M)[None, :] < orders[:, None], coefs[:, :M], 0.0))
    # A step is taken after the first score (the host's cur += delta before
    # its loop ends), so every refined row runs a second iteration at each
    # margin.
    runs = min(iters, 2) * len(SVR_MARGIN_LIST)
    assert (n_it[orders > 1] >= runs).all()


@jax.jit
def _jax_svr(tok, work, hi, lo, orders):
    """JAX's refinement as _analyze_core_exact traces it (pinned)."""
    with dd.pinned(tok):
        return _svr_exact(work, (hi, lo), orders, N, BPS, M, 2,
                          SVR_MARGIN_LIST, RIDGE)


def test_svr_refine_plain_against_jax():
    """JAX's df64 refinement (_svr_exact, JAX-CPU) from the same host
    initial coefficients: the same decisions on rows neither flags."""
    work = svr_rows()
    dbl, coefs, orders = host_init(work, N, M, 2)
    _, (best, _, risky, _) = _plain_from_host(work, dbl, coefs, orders, N,
                                           M, 2)
    hi = coefs[:, :M].astype(np.float32)
    lo = (coefs[:, :M] - hi.astype(np.float64)).astype(np.float32)
    jout, jrisky, _ = _jax_svr(jnp.int32(0), jnp.asarray(work),
                               jnp.asarray(hi), jnp.asarray(lo),
                               jnp.asarray(orders.astype(np.int32)))
    jcoef = np.asarray(jout[0], np.float64) + np.asarray(jout[1], np.float64)
    ok = ~risky & ~np.asarray(jrisky)
    assert ok.sum() >= len(orders) - 2
    scale = np.maximum(np.abs(best).max(axis=1), 1.0)
    err = np.abs(jcoef - best).max(axis=1) / scale
    assert (err[ok] <= 2.0 ** -24).all(), err[ok].max()


def test_preset_0_with_svr_encodes_without_refinement():
    """-m 0 has no LPC analysis, so nothing to refine (the reference binary
    crashes there): the port's device encode on the CPU, the port's host
    encoder and srla_tpu's give the same bytes."""
    pcm = make_music(0.1)
    want = srla_tpu.encode(pcm, 16, 44100, preset=0, max_block=1024,
                           svr_iterations=2)
    param = host_encoder.make_parameter(2, 16, 44100, preset=0,
                                        max_block=1024, svr_iterations=2)
    assert SRLAEncoder(param, "cpu").encode_whole(pcm) == want
    assert host_encoder.encode(pcm, 16, 44100, preset=0, max_block=1024,
                               svr_iterations=2) == want


@pytest.mark.parametrize("flags", [["-V", "0"], ["-V", "1"],
                                   ["-V", "1", "-P", "1"]])
def test_cli_svr_equals_srla_tpu_cli(tmp_path, flags):
    """``python -m srla_tpu_torch.cli -e --svr-filter-learning-iteration 2
    --device cpu`` writes the bytes of ``python -m srla_tpu.cli -e`` with
    the same flags (an odd-length file: its odd last window at -V 1 reads
    the work buffer SVR left)."""
    from srla_tpu import cli as jax_cli
    from srla_tpu.wavio import WavData, write_wav
    from srla_tpu_torch.cli import main
    pcm = make_music(0.12)[:, :5001]
    wav = tmp_path / "in.wav"
    write_wav(str(wav), WavData(pcm, 44100, 16))
    ref, out = tmp_path / "ref.srl", tmp_path / "out.srl"
    args = ["-e", "-m", "2", "-B", "1024", *flags,
            "--svr-filter-learning-iteration", "2"]
    assert jax_cli.main([*args, str(wav), str(ref)]) == 0
    assert main([*args, "--device", "cpu", str(wav), str(out)]) == 0
    assert out.read_bytes() == ref.read_bytes()


# ---------------------------------------------------------------------------
# On the card: K11 and K12 against their plain versions
# ---------------------------------------------------------------------------

def test_k12_shared_memory_layout():
    """K12 keeps the row as f64 and its packed factor in shared memory
    where they fit (the main path's 4096 x M 64, and n 16384 at M 64, n
    8192 at M 128, n 20000 at M 16), moves the factor to global scratch
    first (M 255 at n 16384 and 20000; n 16384 at M 128), then stages the
    row as int32 (n 28000), and refuses a row whose int32 samples alone do
    not fit."""
    assert svr._layout(4096, 64) == (False, False)
    assert svr._layout(16384, 64) == (False, False)
    assert svr._layout(16384, 255) == (True, False)
    assert svr._layout(20000, 255) == (True, False)
    assert svr._layout(8192, 128) == (False, False)
    assert svr._layout(16384, 128) == (True, False)
    assert svr._layout(20000, 16) == (False, False)
    assert svr._layout(28000, 16) == (True, True)
    with pytest.raises(ValueError, match="shared memory"):
        svr._layout(60000, 16)


@pytest.mark.gpu
@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("n,max_params", [(1024, 16), (4096, 64),
                                          (2048, 128), (8192, 128),
                                          (20000, 16), (4096, 255),
                                          (28000, 16)])
def test_kernels_bit_equal_to_plain(cuda, n, max_params, iters):
    from srla_tpu_torch.kernels.levinson import (lpc_quantize,
                                                 lpc_quantize_plain)
    work = torch.from_numpy(svr_rows(n)).to(cuda)
    preset = {16: 2, 64: 4, 128: 5, 255: 6}[max_params]
    _, coefs, orders = host_init(work.cpu().numpy(), n, max_params, preset)
    o = torch.from_numpy(orders.astype(np.int32)).to(cuda)
    c = torch.from_numpy(coefs[:, :max_params]).to(cuda).contiguous()
    kappa = torch.full((len(orders),), 100.0, dtype=torch.float64,
                       device=cuda)
    cov = svr.svr_cov(work, o, n, BPS, max_params, RIDGE)
    assert torch.equal(cov, svr.svr_cov_plain(work, o, n, BPS, max_params,
                                              RIDGE))
    got = svr.svr_refine(work, cov, c, o, n, BPS, iters, SVR_MARGIN_LIST,
                         RIDGE, kappa)
    want = svr.svr_refine_plain(work, cov, c, o, n, BPS, iters,
                                SVR_MARGIN_LIST, RIDGE, kappa)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    q = lpc_quantize(got[0], o, kappa, got[1])
    for g, w in zip(q, lpc_quantize_plain(got[0], o, kappa, got[1])):
        assert torch.equal(g, w)
