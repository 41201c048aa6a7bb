"""Long-term prediction (-P) in the port (srla_tpu_torch.kernels.ltp and the
encode around it) against the JAX package and the host.

- The pitch analysis (exact.ltp_lags, then ltp_analyze_plain, K10's plain
  version) against JAX's _ltp_exact on the CPU and against the host's
  native ltp_analyze_batch, on make_music, a pitched saw, white noise,
  silence and low tones whose pitch lag is 262, at n 512, 2048, 4096 and
  4064 and orders 1 and 3: equal periods and coefficients on every row
  that neither side flags. JAX's scan stops at lag 261 where the host's
  detect loop looks at 262 once more (ltp.py's docstring); the port follows
  the host there, so it differs from JAX exactly on the rows where JAX
  differs from the host.
- The same at the lag level on constructed rows: lag 262 reached three
  ways, |r0| at and around FLT_MIN, and the zero row.
- ltp_predict against _ltp_predict_dev, ltp_synth_plain (K9's plain
  version) against _ltp_pass at the edges: bit-equal.
- The port's encode on the CPU at -P 1 and -P 3 against
  srla_tpu.encode(backend="exact"): the same bytes at -V 0, 1 and 2, mono
  and stereo, 16 and 24 bits, -m 4 and 6, spans under 512 samples measured
  on the host and counted; the CLI's -e -P 3 at its defaults against
  srla_tpu.cli.
- On the card (marked gpu): K9 and K10 against their plain versions, on
  these rows and on chip_smoke's hard rows (K9: the shortest step, periods
  around a warp, off rows between, n 16384, 4064 and 333; K10: the cap,
  lag 262, equal peaks, a singular pivot, 24-bit magnitudes).

Integers compare exactly; periods and coefficients are integers too."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import signals  # noqa: E402
from srla_tpu import encode as jax_encode  # noqa: E402
from srla_tpu.kernels.decode2 import _ltp_pass  # noqa: E402
from srla_tpu.kernels.exact import _ltp_exact, _ltp_predict_dev  # noqa: E402
from srla_tpu_torch import (SRLADecoder, SRLAEncoder, decode,  # noqa: E402
                            native_decoder)
from srla_tpu_torch.constants import (  # noqa: E402
    LPC_RIDGE_REGULARIZATION_PARAMETER, LTP_MAX_PERIOD, LTP_MIN_PERIOD)
from srla_tpu_torch.dsp.fft import round_up_pow2  # noqa: E402
from srla_tpu_torch.dsp.window import welch_window  # noqa: E402
from srla_tpu_torch.encoder import LTP_MIN_DEVICE_SIZE  # noqa: E402
from srla_tpu_torch.host_encoder import make_parameter  # noqa: E402
from srla_tpu_torch.kernels import exact, ltp  # noqa: E402
from srla_tpu_torch.signals import make_music  # noqa: E402

_ltp_exact_jit = jax.jit(_ltp_exact, static_argnums=(1, 2, 3, 4, 5, 6))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rows(n: int) -> np.ndarray:
    """Analysis rows of n samples: make_music's two channels cut into
    blocks, a pitched saw (~200 Hz), white noise, silence, and low tones
    (periods 270-290 over a bass) whose pitch lag is 262."""
    music = make_music(12 * n / 44100 + 0.01)
    rows = [music[c, k * n:(k + 1) * n] for c in range(2) for k in range(6)]
    rows.append(signals.pitchy(n, 1, 16)[0])
    rows.append(signals.white_noise(n, 1, 16, seed=n)[0])
    rows.append(np.zeros(n, np.int32))
    t = np.arange(n)
    for p1, a in ((270, 0.7), (280, 0.9), (290, 0.9)):
        x = a * np.sin(2 * np.pi * t / p1) + 1.3 * np.sin(2 * np.pi * t / 3000)
        rows.append(np.round(x * 8000))
    return np.stack(rows).astype(np.int32)


def _port_analysis(n: int, order: int):
    """The port's pre-emphasised rows, its lags and its LTP analysis."""
    work, _, _ = exact.preemphasis_exact(torch.from_numpy(_rows(n)))
    lags = exact.ltp_lags(work, n, 16, round_up_pow2(n))
    period, coefs, risky = ltp.ltp_analyze_plain(lags, order)
    return work.numpy(), lags.numpy(), period.numpy(), coefs.numpy(), \
        risky.numpy()


def _host_analysis(work: np.ndarray, n: int, order: int):
    """The host's LTP analysis of the same rows: its FFT lags (the native
    path of host_encoder._analyze_channel) and ltp_analyze_batch."""
    ac = native_decoder.window_autocorr_batch(
        work, n, 2.0 ** -15, welch_window(n), bool(n & 1), 0.0,
        round_up_pow2(n), LTP_MAX_PERIOD + 1)
    acbuf = np.zeros((work.shape[0], LTP_MAX_PERIOD + 3))
    acbuf[:, :LTP_MAX_PERIOD + 1] = ac
    return native_decoder.ltp_analyze_batch(
        acbuf, order, LTP_MIN_PERIOD, LTP_MAX_PERIOD,
        LPC_RIDGE_REGULARIZATION_PARAMETER)


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("n", [512, 2048, 4096, 4064])
def test_analysis_matches_jax_and_host(n, order):
    work, _, period, coefs, risky = _port_analysis(n, order)
    jp, jc, jr = jax.device_get(_ltp_exact_jit(
        jnp.asarray(work), n, 16, round_up_pow2(n), order, LTP_MIN_PERIOD,
        LTP_MAX_PERIOD))
    jp, jc, jr = np.asarray(jp), np.asarray(jc), np.asarray(jr)
    hp, hc = _host_analysis(work, n, order)
    port_ok = ~risky
    assert port_ok.mean() > 0.6
    # Against the host: equal wherever the port does not flag.
    np.testing.assert_array_equal(period[port_ok], hp[port_ok])
    np.testing.assert_array_equal(coefs[port_ok], hc[port_ok])
    # Against JAX: equal wherever neither flags, except where JAX differs
    # from the host (its scan ends at lag 261).
    both = port_ok & ~jr
    jax_host = (jp == hp) & (jc == hc).all(axis=1)
    np.testing.assert_array_equal(period[both & jax_host],
                                  jp[both & jax_host])
    np.testing.assert_array_equal(coefs[both & jax_host],
                                  jc[both & jax_host])
    assert (jp[both & ~jax_host] == 0).all()
    assert (period[both & ~jax_host] == LTP_MAX_PERIOD).all()
    if n >= 2048 and order == 1:        # the low tones reach lag 262
        assert (both & ~jax_host).any()
    # Every flag of _ltp_exact on these rows is the port's too.
    assert not (jr & ~risky).any()
    assert (period > 0).sum() >= 6          # LTP on the pitched rows


def _edge_lags() -> tuple[np.ndarray, np.ndarray]:
    """Constructed (V, LTP_COLS) lag rows: lag 262 reached with no crossing
    at all, from a segment that starts at 261, and from a crossing between
    261 and 262 after a closed segment; |r0| at FLT_MIN, a hair above, a
    hundred times above, and 0; a tie of two peaks (flagged). Returns
    (lags, must_flag)."""
    k = np.arange(ltp.LTP_COLS, dtype=float)
    head = [1.0, 0.5, 0.2, 0.1, 0.0, -0.1, -0.2, -0.3]
    rows, flag = [], []
    rows.append(np.where(k < 200, 1 - k / 300, 1 / 3 + (k - 200) / 300))
    for at_261 in (0.2, -0.2):
        r = np.full(ltp.LTP_COLS, -0.3)
        r[:8], r[261], r[262] = head, at_261, 0.4
        rows.append(r)
    flag += [False, False, False]
    flt_min = ltp._FLT_MIN
    for r0 in (flt_min, flt_min * (1 + 1e-6), flt_min * 100, 0.0):
        r = 0.5 * np.cos(2 * np.pi * k / 150) * r0
        r[0] = r0
        rows.append(r)
        flag.append(abs(r0 - flt_min) < 1e-38)
    r = np.full(ltp.LTP_COLS, -0.3)
    r[:8] = head
    r[50:60], r[150:160], r[55], r[155] = 0.2, 0.2, 0.6, 0.6
    rows.append(r)
    flag.append(True)
    lags = np.stack(rows)
    lags[:, LTP_MAX_PERIOD + 1:] = 0.0
    return lags, np.asarray(flag)


@pytest.mark.parametrize("order", [1, 3])
def test_analysis_edges_match_host(order):
    lags, must_flag = _edge_lags()
    period, coefs, risky = (a.numpy() for a in ltp.ltp_analyze_plain(
        torch.from_numpy(lags), order))
    hp, hc = native_decoder.ltp_analyze_batch(
        lags[:, :LTP_MAX_PERIOD + 3].copy(), order, LTP_MIN_PERIOD,
        LTP_MAX_PERIOD, LPC_RIDGE_REGULARIZATION_PARAMETER)
    ok = ~risky
    np.testing.assert_array_equal(period[ok], hp[ok])
    np.testing.assert_array_equal(coefs[ok], hc[ok])
    assert risky[must_flag].all()
    assert list(hp[:3]) == [262, 262, 262]
    assert period[5] > 0 and period[3] == period[6] == 0


def test_ltp_predict_matches_jax():
    rng = np.random.RandomState(3)
    V, n = 40, 700
    work = rng.randint(-(1 << 20), 1 << 20, (V, n)).astype(np.int32)
    work[:4] = rng.randint(-(1 << 31), 1 << 31, (4, n))   # int32 wrapping
    periods = rng.randint(8, 263, V).astype(np.int32)
    periods[4:8] = (0, 8, 262, 9)
    periods[8:10] = (n, n + 5)          # the delay past the row
    for order in (1, 3):
        coefs = rng.randint(-32, 32, (V, order)).astype(np.int32)
        want = np.asarray(_ltp_predict_dev(jnp.asarray(work),
                                           jnp.asarray(coefs),
                                           jnp.asarray(periods), order))
        got = ltp.ltp_predict(torch.from_numpy(work), torch.from_numpy(coefs),
                              torch.from_numpy(periods), order)
        np.testing.assert_array_equal(got.numpy(), want)


def _synth_inputs(R: int, n: int, seed: int):
    """K9 arguments with the edges: delay 9 at order 3 (period 8), order 1
    at period 8, period-0 and order-0 rows, the largest period, wrapping
    values; the rest random orders 1 and 3, periods 8..262."""
    rng = np.random.RandomState(seed)
    v = rng.randint(-(1 << 20), 1 << 20, (R, n)).astype(np.int32)
    v[:3] = rng.randint(-(1 << 31), 1 << 31, (3, n))
    lorders = rng.choice([1, 3], R).astype(np.int32)
    lperiods = rng.randint(8, 263, R).astype(np.int32)
    lcoefs = rng.randint(-32, 32, (R, 3)).astype(np.int32)
    lorders[:6] = (3, 1, 3, 3, 0, 1)
    lperiods[:6] = (8, 8, 0, 262, 100, 262)
    lcoefs[:3] = (31, -32, 31)
    return v, lorders, lperiods, lcoefs


@pytest.mark.parametrize("n", [300, 4064])
def test_ltp_synth_plain_matches_jax_at_edges(n):
    args = _synth_inputs(40, n, seed=n)
    want = np.asarray(_ltp_pass(*(jnp.asarray(a) for a in args), n))
    got = ltp.ltp_synth_plain(*(torch.from_numpy(a) for a in args), n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want[3], args[0][3])     # LTP acted


# ---------------------------------------------------------------------------
# The encode on the CPU (the kernels' plain versions)
# ---------------------------------------------------------------------------

def _signal(kind: str, C: int, bps: int, N: int) -> np.ndarray:
    pcm = (make_music(N / 44100 + 0.01)[:C, :N] if kind == "music"
           else signals.pitchy(N, C, 16)).astype(np.int32)
    return pcm << (bps - 16)


@pytest.mark.parametrize("kind,C,bps,preset,V,B,P", [
    ("music", 2, 16, 4, 0, 4096, 3), ("pitchy", 1, 16, 6, 0, 2048, 1),
    ("music", 1, 24, 6, 1, 4096, 3), ("pitchy", 2, 24, 4, 1, 2048, 1),
    ("music", 2, 16, 4, 2, 1024, 3),
])
def test_encode_bytes_equal_srla_tpu(kind, C, bps, preset, V, B, P):
    N = 4 * B * 2 + (B // 2 if V == 0 else 0)
    pcm = _signal(kind, C, bps, N)
    want = jax_encode(pcm, bps, 44100, preset=preset, max_block=B,
                      variable_divisions=V, ltp_order=P, backend="exact")
    enc = SRLAEncoder(make_parameter(C, bps, 44100, preset, B, V, 4, P),
                      "cpu")
    got = enc.encode_whole(pcm)
    assert got == want
    s = enc.stats
    assert s["device_blocks"] > 0
    if V:
        assert s["device_spans"] > 0
        # Spans of B >> V samples: under 512 at -B 1024 -V 2, so measured
        # (and counted) on the host, as srla_tpu routes them.
        assert (s["host_spans"] > 0) == (B >> V < LTP_MIN_DEVICE_SIZE)
    _, out = decode(got, device="cpu")
    np.testing.assert_array_equal(out, pcm)


def test_python_assembly_writes_ltp_fields(monkeypatch):
    """Where the port's native library does not build, the Python bit
    writer frames the device-encoded blocks, LTP fields included: the same
    bytes."""
    pcm = _signal("pitchy", 2, 16, 4096 * 2 + 2048)
    want = jax_encode(pcm, 16, 44100, preset=4, max_block=4096, ltp_order=3,
                      backend="exact")
    monkeypatch.setattr(native_decoder, "available", lambda: False)
    enc = SRLAEncoder(make_parameter(2, 16, 44100, 4, 4096, 0, 4, 3), "cpu")
    assert enc.encode_whole(pcm) == want
    assert enc.stats["device_blocks"] == 3
    assert any(g.has_ltp for g in SRLADecoder("cpu").plan(want)[2])


def test_short_ltp_groups_are_host_batches():
    """-B 256 -P 3: every COMPRESS group is under 512 samples, so it is a
    counted host batch; the bytes are srla_tpu's."""
    pcm = _signal("pitchy", 2, 16, 256 * 6)
    want = jax_encode(pcm, 16, 44100, preset=4, max_block=256, ltp_order=3,
                      backend="exact")
    enc = SRLAEncoder(make_parameter(2, 16, 44100, 4, 256, 0, 4, 3), "cpu")
    assert enc.encode_whole(pcm) == want
    assert enc.stats["device_blocks"] == 0
    assert enc.stats["host_blocks"] == 6


def test_cli_ltp_at_defaults_equals_srla_tpu_cli(tmp_path):
    """``python -m srla_tpu_torch.cli -e -P 3`` at the other defaults (-m 4
    -B 4096 -V 1 -L 4) writes the bytes of ``python -m srla_tpu.cli -e -P
    3``, and the port decodes them."""
    from srla_tpu import cli as jax_cli
    from srla_tpu.wavio import WavData, write_wav
    from srla_tpu_torch.cli import main
    pcm = _signal("music", 2, 16, 20000)
    wav = tmp_path / "in.wav"
    write_wav(str(wav), WavData(pcm, 44100, 16))
    ref, out, back = (tmp_path / f for f in ("ref.srl", "out.srl", "o.wav"))
    assert jax_cli.main(["-e", "-P", "3", str(wav), str(ref)]) == 0
    assert main(["-e", "-P", "3", "--device", "cpu", str(wav),
                 str(out)]) == 0
    assert out.read_bytes() == ref.read_bytes()
    assert main(["-d", "--device", "cpu", str(out), str(back)]) == 0
    assert back.read_bytes() == wav.read_bytes()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("order", [1, 3])
def test_ltp_analyze_kernel_matches_plain_on_card(cuda, order):
    lags = np.concatenate([_port_analysis(4096, order)[1], _edge_lags()[0]])
    ac = torch.from_numpy(lags).to(cuda)
    before = ltp.ltp_analyze.launches
    got = ltp.ltp_analyze(ac, order)
    want = ltp.ltp_analyze_plain(ac, order)
    torch.cuda.synchronize()
    assert ltp.ltp_analyze.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 31, 300, 4064])
def test_ltp_synth_kernel_matches_plain_on_card(cuda, n):
    args = [torch.from_numpy(a).to(cuda)
            for a in _synth_inputs(70, n, seed=n + 1)]
    before = ltp.ltp_synth.launches
    got = ltp.ltp_synth(*args, n)
    want = ltp.ltp_synth_plain(*args, n)
    torch.cuda.synchronize()
    assert ltp.ltp_synth.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [16384, 4064, 333])
def test_ltp_synth_kernel_hard_rows_on_card(cuda, n):
    """37 rows: the shortest valid step (w = 7), periods 8, 31, 32, 33 and
    262 at orders 1 and 3 (w below, at and above a warp), off rows between
    on rows (chip_smoke.k9_hard_args), at n 16384, 4064 and 333."""
    args = chip_smoke.k9_hard_args(torch, np, cuda, 37, n, seed=n)
    got = ltp.ltp_synth(*args)
    want = ltp.ltp_synth_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("order", [1, 3])
def test_ltp_analyze_kernel_hard_rows_on_card(cuda, order):
    """_edge_lags, chip_smoke.k10_edge_lags (the cap of 20 binding, a
    segment opening at 261 and at 262, equal peaks, a singular pivot,
    24-bit magnitudes) and 61 seeded rows of k10_random_lags: period,
    coefficients and flag equal to the plain version's."""
    lags = np.concatenate([_edge_lags()[0], chip_smoke.k10_edge_lags(np),
                           chip_smoke.k10_random_lags(np, 61, order)])
    assert lags.shape[0] % 4 != 0
    ac = torch.from_numpy(lags).to(cuda)
    got = ltp.ltp_analyze(ac, order)
    want = ltp.ltp_analyze_plain(ac, order)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("P", [1, 3])
def test_ltp_encode_on_card(cuda, P):
    pcm = _signal("music", 2, 16, 4 * 4096 + 2000)
    want = jax_encode(pcm, 16, 44100, preset=4, max_block=4096,
                      variable_divisions=1, ltp_order=P, backend="exact")
    ltp.ltp_analyze.launches = ltp.ltp_synth.launches = 0
    enc = SRLAEncoder(make_parameter(2, 16, 44100, 4, 4096, 1, 4, P), cuda)
    assert enc.encode_whole(pcm) == want
    assert ltp.ltp_analyze.launches > 0
    _, out = decode(want, device=cuda)
    np.testing.assert_array_equal(out, pcm)
    assert ltp.ltp_synth.launches > 0
