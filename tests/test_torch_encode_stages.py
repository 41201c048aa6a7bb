"""The exact encode's last stages in the port against the JAX package, on
the CPU (the kernels' plain versions):

- K16's plain version (``preemphasis.variant_preemphasis_plain``: the
  variant stack and the exact pre-emphasis) against JAX's stack in
  ``_variant_analysis`` (:1208-1215) followed by ``_preemphasis_exact``,
  traced as the JAX package traces it (pinned), on blocks and on spans of
  a file: C 1, 2 and 3, int16 and int32 samples, lshift 0 and 2, 24-bit
  rows, all-zero rows and rows whose 16 r1 / r0 lies on a half (flagged by
  both).
- K17's plain versions (``select.select_blocks_plain`` and
  ``measure_blocks_plain``) against ``encode_blocks_exact``'s selection on
  the same per-variant rows (chip_smoke.k17_small: ties, clamped codes,
  wrapping sums, raw blocks, sections above W words, LTP fields) at M 8,
  32, 64 and 128: the JAX function runs unjitted with its analysis
  replaced by those rows, so its own accounting, argmin and lens_w are
  what the port is held to (the measurement's bits are the same rounded
  minimum: ``srla_tpu/encoder.py:2020-2032``).
- K5's row entry's plain version against the gathered entry on the same
  rows: equal words.
- The encoder's ``StepTimer`` split: a group's host set-up is a step of
  its own ("group set-up", and "measure: set-up" for a -V measurement
  call), apart from "K16 preemphasis", and the bytes are the host's.

Every comparison is exact. The card's cases are in
``test_torch_encode_stages_card.py``."""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from srla_tpu.kernels import df64 as dd  # noqa: E402
from srla_tpu.kernels import exact as jexact  # noqa: E402
from srla_tpu_torch.kernels import select  # noqa: E402
from srla_tpu_torch.kernels.bitpack import (  # noqa: E402
    pack_residual_sections_plain, zigzag32)
from srla_tpu_torch.kernels.preemphasis import (  # noqa: E402
    Spans, variant_preemphasis, variant_preemphasis_plain)

EPS = chip_smoke.K16_EPS


@functools.partial(jax.jit, static_argnums=(3,))
def _jax_k16(tok, blocks, lshift, C):
    """_variant_analysis's stack, then _preemphasis_exact, traced pinned
    as the JAX package's entry points trace them."""
    work = blocks.astype(jnp.int32) >> lshift
    parts = []
    if C >= 2:
        s = work[:, 1] - work[:, 0]
        parts.extend([work[:, 0] + (s >> 1), s])
    parts.extend(work[:, c] for c in range(C))
    sig = jnp.concatenate(parts, axis=0)
    with dd.pinned(tok):
        w, coef, risky = jexact._preemphasis_exact(sig)
    return w, coef, risky, sig[:, 0]


def _k16_blocks(C: int, bits: int, n: int, seed: int) -> np.ndarray:
    """(7, C, n) samples of ``bits`` bits (int16 up to 16 bits, else
    int32): Laplace rows, block 1 all zero, block 2's channels on a
    rounding half (chip_smoke.k16_half_row), block 3's the negative
    half."""
    rng = np.random.RandomState(seed)
    amp = (1 << (bits - 1)) - 1
    b = rng.laplace(0, amp / 8, (7, C, n)).clip(-amp - 1, amp)
    b[1] = 0
    b[2, :] = chip_smoke.k16_half_row(np, n)
    b[3, :] = chip_smoke.k16_half_row(np, n, -1)
    return b.astype(np.int16 if bits <= 16 else np.int32)


def _assert_k16(got, blocks, lshift, C):
    want = jax.device_get(_jax_k16(jnp.int32(0), blocks, lshift, C))
    for g, w, name in zip(got, want, ("work", "coef", "risky", "prev")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    return got[2].numpy()


@pytest.mark.parametrize("C,bits,lshift", [(1, 16, 0), (2, 16, 0),
                                           (2, 24, 2), (3, 24, 0),
                                           (3, 16, 2)])
def test_k16_plain_matches_jax_on_blocks(C, bits, lshift):
    n = 333
    blocks = _k16_blocks(C, bits, n, seed=C * 10 + bits + lshift)
    if lshift:
        blocks = (blocks >> lshift << lshift).astype(blocks.dtype)
    risky = _assert_k16(variant_preemphasis(torch.from_numpy(blocks), lshift,
                                            eps=EPS), blocks, lshift, C)
    # The half-boundary channels are flagged (block 2 and 3 of each channel
    # row; for C >= 2 of M too, S being all zero there).
    nvar = C + 2 if C >= 2 else 1
    r = risky.reshape(nvar, -1)
    flagged = [0] + list(range(2, nvar)) if C >= 2 else [0]
    if lshift == 0:
        assert r[flagged][:, 2:4].all()
    assert not r[:, 1].any()


@pytest.mark.parametrize("C,bits", [(2, 16), (3, 24)])
def test_k16_plain_matches_jax_on_spans(C, bits):
    """The resident-file entry (Spans at odd offsets) equals the blocks
    cut on the host and stacked by JAX."""
    n, N = 333, 4000
    rng = np.random.RandomState(C + bits)
    amp = (1 << (bits - 1)) - 1
    file = rng.laplace(0, amp / 8, (C, N)).clip(-amp - 1, amp).astype(
        np.int16 if bits <= 16 else np.int32)
    file[:, 1001:1001 + n] = 0
    offs = [1, 335, 1001, 2047, 3667]
    blocks = np.stack([file[:, o:o + n] for o in offs])
    got = variant_preemphasis_plain(Spans(torch.from_numpy(file), offs, n), 0,
                                    eps=EPS)
    _assert_k16(got, blocks, 0, C)


def test_k16_odd_cases_plain_matches_jax():
    """chip_smoke.k16_cases (the card's odd cases) against JAX; the int32
    extremes' span is left to the card (JAX's df64 sums of 2^62 squares
    are not exact)."""
    for what, data, offs, n, lshift in chip_smoke.k16_cases(np):
        if offs is not None:
            offs = [o for o in offs if o != 6001]
            blocks = np.stack([data[:, o:o + n] for o in offs])
            src = Spans(torch.from_numpy(data), offs, n)
        else:
            blocks, src = data, torch.from_numpy(data)
        _assert_k16(variant_preemphasis_plain(src, lshift, eps=EPS),
                    blocks, lshift, blocks.shape[1])


def _jax_selection(monkeypatch, small, rice_risky, kw, ltp_order):
    """encode_blocks_exact unjitted, its analysis replaced by the rows of
    ``small`` (every row ALLZERO for the pack): its small."""
    B, C, n, W, M = kw["B"], kw["C"], kw["n"], kw["W"], kw["max_params"]
    V = small["orders"].shape[0]
    js = {k: jnp.asarray(small[k].numpy()) for k in (
        "section_bits", "orders", "coefs", "ltp_period")}
    js["section_bits"] = js["section_bits"].astype(jnp.int32)
    js["risky"] = jnp.asarray((small["risky"] | rice_risky).numpy())
    out = dict(code_type=jnp.full(V, 2, jnp.int32),
               porder=jnp.zeros(V, jnp.int32),
               ks=jnp.zeros((V, 1), jnp.int32))

    def analysis(*_a, **_k):
        return dict(js), jnp.zeros((V, n), jnp.uint32), out

    monkeypatch.setattr(jexact, "_variant_analysis", analysis)
    # A jit of its own (not encode_blocks_exact's cache, which must never
    # hold this stand-in analysis), traced with the stand-in in place.
    fn = jax.jit(jexact.encode_blocks_exact.__wrapped__, static_argnames=(
        "n", "bps", "max_params", "max_fixed", "fft_size", "max_porder", "C",
        "W", "ltp_order"))
    want, _ = fn(jnp.zeros((B, C, n), jnp.int32), jnp.int32(0), n=n,
                 bps=kw["bps"], max_params=M, max_fixed=False, fft_size=n,
                 max_porder=0, C=C, W=W, ltp_order=ltp_order)
    return jax.device_get(want)


@pytest.mark.parametrize("B,C,M,sec64", [(37, 2, 8, True), (29, 1, 32, False),
                                         (23, 3, 64, True),
                                         (41, 2, 128, False)])
def test_k17_plain_matches_encode_blocks_exact(monkeypatch, B, C, M, sec64):
    small, rice_risky, kw = chip_smoke.k17_small(torch, np, "cpu", B, C, M,
                                                 seed=B + M, sec64=sec64)
    want = _jax_selection(monkeypatch, small, rice_risky, kw, 3)
    got = select.select_blocks(small, rice_risky=rice_risky, **kw)
    for key in ("method", "bits", "raw_blk", "risky_blk", "use_sum",
                "lens_w"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    # Every kind of row occurs: a raw block, a flagged block, a section
    # above W words in a block that is neither, a summed coefficient form.
    sec = small["section_bits"].long()[got["rows"]].reshape(B, C)
    clean = ~(got["raw_blk"] | got["risky_blk"])
    assert got["raw_blk"].any() and got["risky_blk"].any()
    assert (clean[:, None] & (sec > kw["W"] * 32)).any()
    assert got["use_sum"].any() and not got["use_sum"].all()
    np.testing.assert_array_equal(
        got["starts"].numpy(), np.cumsum(want["lens_w"]) - want["lens_w"])
    meas = select.measure_blocks(small, rice_risky=rice_risky, **{
        k: kw[k] for k in ("B", "C", "bps", "max_params")})
    np.testing.assert_array_equal(meas["bits"].numpy(),
                                  np.asarray(want["bits"]))
    np.testing.assert_array_equal(meas["risky_blk"].numpy(),
                                  np.asarray(want["risky_blk"]))


@pytest.mark.parametrize("V,n,porder", [(12, 334, 1), (40, 512, 9)])
def test_k5_row_entry_equals_gathered(V, n, porder):
    """K5's row entry's plain version (zigzag as it reads, rows by index)
    packs the words the gathered entry packs from zigzag32 and a gather."""
    args, _ = chip_smoke.k5_rows_case(torch, np, "cpu", V, n, porder, V + n)
    res, ct, po, ks, nn, starts, lens_w, cap, rows = args
    got = pack_residual_sections_plain(*args[:8], rows=rows)
    want = pack_residual_sections_plain(zigzag32(res)[rows], ct[rows],
                                        po[rows], ks[rows], nn, starts,
                                        lens_w, cap)
    assert torch.equal(got, want)
    assert int(lens_w[0]) == 0 and int(lens_w.sum()) > 0


@pytest.mark.parametrize("V", [0, 1])
def test_step_timer_separates_group_set_up(V):
    """A small exact encode on the CPU under a StepTimer: the group's
    set-up and K16's call are separate steps (the measurement's too at
    -V 1), and the stream is host_encoder.encode's."""
    from srla_tpu_torch import SRLAEncoder, host_encoder
    from srla_tpu_torch.encoder import StepTimer
    from srla_tpu_torch.host_encoder import make_parameter
    from srla_tpu_torch.signals import make_music
    pcm = make_music(0.1)
    enc = SRLAEncoder(make_parameter(2, 16, 44100, 2, 1024, V), "cpu")
    enc.timer = StepTimer("cpu")
    assert enc.encode_whole(pcm) == host_encoder.encode(
        pcm, 16, 44100, preset=2, max_block=1024, variable_divisions=V)
    steps = enc.timer.seconds
    names = ["group set-up", "K16 preemphasis"]
    if V:
        names += ["measure: set-up", "measure: K16 preemphasis"]
    for name in names:
        assert steps[name] >= 0.0, name
