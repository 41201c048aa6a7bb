"""The port's f64 encode analysis (srla_tpu_torch.kernels.exact) against
srla_tpu.kernels.exact.analyze_blocks_exact (df64 on JAX-CPU) and the host
f64 oracle (SRLAEncoder._analyze_channel), and the port's selection,
codewords and pack run on JAX's own decisions against encode_blocks_exact.

Only decisions are compared, never float intermediates, and every
comparison is exact: on the variants that neither side flags, pre-emphasis
coefficient, LPC order, shift and coefficients, Rice code type, partition
order and parameters, section bits and zigzag residual are equal. JAX
compiles one analysis shape per bit depth here (B 8, C 2, n 1024, -m 4)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import signals  # noqa: E402
from srla_tpu import rice  # noqa: E402
from srla_tpu.bitio import sint32_to_uint32  # noqa: E402
from srla_tpu.constants import PARAMETER_PRESETS  # noqa: E402
from srla_tpu.encoder import EncodeParameter, SRLAEncoder  # noqa: E402
from srla_tpu.kernels.exact import (analyze_blocks_exact,  # noqa: E402
                                    encode_blocks_exact)
from srla_tpu_torch.kernels import exact as texact  # noqa: E402
from srla_tpu_torch.kernels import rice_search  # noqa: E402
from test_exact_device import _max_porder, _signals  # noqa: E402

B, C, N, PRESET = 8, 2, 1024, 4


def _kw(bps):
    pre = PARAMETER_PRESETS[PRESET]
    return dict(n=N, bps=bps, max_params=pre.max_num_parameters,
                max_fixed=False, fft_size=N, max_porder=_max_porder(N))


def _jax(blocks, bps):
    small, big = analyze_blocks_exact(blocks, np.int32(0), C=C, **_kw(bps))
    return jax.device_get(small), jax.device_get(big)


def _port(blocks, bps):
    small, big, _ = texact.variant_analysis(torch.from_numpy(blocks), 0,
                                            **_kw(bps))
    return ({k: v.numpy() for k, v in small.items()},
            {k: v.numpy() for k, v in big.items()})


def _blocks(bps, seed):
    rng = np.random.RandomState(seed)
    sig = _signals(2 * B, N, bps)[rng.permutation(2 * B)]
    return np.stack([sig[:B], sig[B:]], axis=1)          # (B, C, n)


def _host(blocks, bps):
    param = EncodeParameter(
        num_channels=C, bits_per_sample=bps, sampling_rate=44100,
        min_num_samples_per_block=N, max_num_samples_per_block=N,
        num_lookahead_samples=N, preset=PRESET)
    s = (blocks[:, 1] - blocks[:, 0]).astype(np.int32)
    m = (blocks[:, 0] + (s >> 1)).astype(np.int32)
    stack = np.concatenate([m, s, blocks[:, 0], blocks[:, 1]], axis=0)
    return SRLAEncoder(param, backend="exact")._analyze_channel(stack, N)


@pytest.mark.parametrize("bps", [16, 24])
def test_unflagged_decisions_equal_jax_and_host(bps):
    blocks = _blocks(bps, seed=bps)
    js, jb = _jax(blocks, bps)
    ps, pb = _port(blocks, bps)
    host = _host(blocks, bps)
    ok = ~ps["risky"] & ~np.asarray(js["risky"])
    assert ok.mean() > 0.75, ok.mean()
    maxp = PARAMETER_PRESETS[PRESET].max_num_parameters
    for key, want in (("pre_coef", host.pre_coef),
                      ("orders", host.lpc_order),
                      ("rshifts", host.lpc_rshift),
                      ("code_type", host.rice_type),
                      ("porder", host.rice_porder)):
        np.testing.assert_array_equal(ps[key][ok], np.asarray(js[key])[ok],
                                      err_msg=key)
        np.testing.assert_array_equal(ps[key][ok], want[ok], err_msg=key)
    np.testing.assert_array_equal(ps["coefs"][ok],
                                  np.asarray(js["coefs"])[ok])
    np.testing.assert_array_equal(ps["coefs"][ok],
                                  host.lpc_coefs[ok][:, :maxp])
    np.testing.assert_array_equal(pb["ks"][ok], np.asarray(jb["ks"])[ok])
    nk = pb["ks"].shape[1]
    np.testing.assert_array_equal(pb["ks"][ok], host.rice_ks[ok][:, :nk])
    _, _, host_bits, _ = rice.analyze_batch(host.residual[:, :N], N)
    np.testing.assert_array_equal(ps["section_bits"][ok],
                                  np.asarray(js["section_bits"])[ok])
    np.testing.assert_array_equal(ps["section_bits"][ok], host_bits[ok])
    np.testing.assert_array_equal(pb["u"][ok],
                                  np.asarray(jb["u"]).astype(np.int64)[ok])
    np.testing.assert_array_equal(
        pb["u"][ok], sint32_to_uint32(host.residual[ok, :N]))


def test_flag_rate_on_signal_corpus():
    """On every tests/signals.py waveform (stereo pairs of the corpus, in
    blocks of the compiled shape) the port flags at most one block more
    than the JAX path, and agrees with it on every block neither flags."""
    names = sorted(signals.ALL)
    wave = [signals.ALL[k](N, 2, 16) for k in names]
    wave.append(signals.white_noise(N, 2, 16, seed=5))
    while len(wave) % B:
        wave.append(signals.chirp(N, 2, 16))
    port_blocks = jax_blocks = 0
    for lo in range(0, len(wave), B):
        blocks = np.stack(wave[lo:lo + B])                   # (B, C, n)
        js, _ = _jax(blocks, 16)
        ps, _ = _port(blocks, 16)
        jr = np.asarray(js["risky"]).reshape(C + 2, B).any(axis=0)
        pr = ps["risky"].reshape(C + 2, B).any(axis=0)
        port_blocks += int(pr.sum())
        jax_blocks += int(jr.sum())
        ok = ~ps["risky"] & ~np.asarray(js["risky"])
        for key in ("orders", "coefs", "section_bits", "porder"):
            np.testing.assert_array_equal(ps[key][ok],
                                          np.asarray(js[key])[ok],
                                          err_msg=key)
    assert port_blocks <= jax_blocks + 1, (port_blocks, jax_blocks)


def test_selection_and_pack_on_jax_decisions():
    """from_jax_analysis feeds JAX's analysis to the port's bit accounting,
    stereo selection, codewords and pack: every selection output and the
    packed words equal encode_blocks_exact's (scatter pack) on a group with
    a raw-fallback block and a block flagged on the port's side."""
    bps = 16
    blocks = _blocks(bps, seed=3)
    blocks[1] = signals.white_noise(N, 2, 16, seed=9)    # raw fallback
    W = (N * (bps + 4)) // 32 + 64
    js, jb = _jax(blocks, bps)
    want, flat = encode_blocks_exact(blocks, np.int32(0), C=C, W=W,
                                     impl="scatter", **_kw(bps))
    want = jax.device_get(want)
    small, big = texact.from_jax_analysis(js, jb, "cpu")
    small["risky"][2 * B + 5] = True                     # a flagged block
    sel = texact.select_rows(small, B=B, C=C, n=N, bps=bps, W=W,
                             max_params=64)
    assert sel["raw_blk"][1] and sel["risky_blk"][5]
    jrisky = np.asarray(want["risky_blk"]).copy()
    jrisky[5] = True
    np.testing.assert_array_equal(sel["risky_blk"].numpy(), jrisky)
    for key in ("method", "bits", "raw_blk", "use_sum"):
        np.testing.assert_array_equal(sel[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    lens_w = np.asarray(want["lens_w"]).copy()
    lens_w[5 * C:6 * C] = 0                              # the flagged block
    np.testing.assert_array_equal(sel["lens_w"].numpy(), lens_w)
    got = texact.pack_residual_sections(
        *texact.chosen_sections(big, sel, N, B * C * W), section_words=W)
    # The flagged block only removes its rows: compare the others' words.
    jstarts = np.cumsum(np.asarray(want["lens_w"])) - np.asarray(
        want["lens_w"])
    pstarts = np.cumsum(lens_w) - lens_w
    jflat = np.asarray(flat).view(np.int32)
    pflat = got.numpy()
    for r in range(B * C):
        if lens_w[r]:
            np.testing.assert_array_equal(
                pflat[pstarts[r]:pstarts[r] + lens_w[r]],
                jflat[jstarts[r]:jstarts[r] + lens_w[r]], err_msg=str(r))
    assert not pflat[pstarts[-1] + lens_w[-1]:].any()


def test_rice_boundary_tables_match_jax():
    """The port's plain f64 Rice boundary tables are the JAX (hi, lo)
    tables' values, margins included."""
    from srla_tpu.kernels.exact import _rice_k_boundaries
    for (hi, lo, eps), (b, beps) in zip(_rice_k_boundaries(),
                                        rice_search.rice_k_boundaries()):
        np.testing.assert_array_equal(eps.astype(np.float64), beps)
        inner = slice(1, 32)
        np.testing.assert_allclose(b[inner], hi[inner].astype(np.float64)
                                   + lo[inner].astype(np.float64),
                                   rtol=2.0 ** -46, atol=0)
