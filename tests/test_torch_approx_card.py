"""The f32 approximate encode on the card (``-m gpu``; the cases skip
without one): K14 (csrc/lpc_analyze_f32.cu) and K15 (csrc/rice_cost.cu)
against their plain PyTorch versions on the same CUDA tensors at small odd
shapes (chip_smoke.k14_odd_lags and k15_odd_rows: silent rows, a half-even
tie, full-range 24-bit and int32-extreme rows), bit for bit on every
output: K14 at every lane count and at M 1-255, K15 on rows of each of its
two bodies and at lengths of no power of two; and a short approximate
encode on the
card: lossless, within 2 % of the exact size, every COMPRESS block from
the device, K14, K15, K3 and K5 launched. No JAX here: the CPU twin,
``test_torch_approx.py``, holds the port to ``srla_tpu``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from srla_tpu_torch import SRLAEncoder, decode, host_encoder  # noqa: E402
from srla_tpu_torch import parallel  # noqa: E402
from srla_tpu_torch.host_encoder import make_parameter  # noqa: E402
from srla_tpu_torch.kernels import encode as P  # noqa: E402
from srla_tpu_torch.kernels.bitpack import (  # noqa: E402
    pack_residual_sections, residual_codewords)
from srla_tpu_torch.kernels.lpc_f32 import (  # noqa: E402
    lpc_analyze_f32, lpc_analyze_f32_plain)
from srla_tpu_torch.kernels.ltp import ltp_predict  # noqa: E402
from srla_tpu_torch.kernels.predict import predict  # noqa: E402
from srla_tpu_torch.kernels.preemphasis import (  # noqa: E402
    preemphasis_f32_sums, variant_preemphasis, variant_preemphasis_f32,
    variant_preemphasis_f32_plain, variant_stack)
from srla_tpu_torch.kernels.rice_cost import (  # noqa: E402
    rice_cost, rice_cost_plain)
from srla_tpu_torch.signals import make_music, make_segmented  # noqa: E402

RATE = 44100


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def k14_lags(V: int, n: int, bps: int, M: int, seed: int) -> torch.Tensor:
    return chip_smoke.k14_odd_lags(torch, np, V, n, bps, M, seed)


@pytest.mark.gpu
@pytest.mark.parametrize("M,n,bps", [(1, 64, 16), (7, 333, 16),
                                     (32, 1024, 24), (64, 4096, 16),
                                     (255, 4096, 24)])
@pytest.mark.parametrize("max_fixed", [False, True])
def test_k14_equals_plain(cuda, M, n, bps, max_fixed):
    ac = k14_lags(37, n, bps, M, seed=M).to(cuda)
    lpc_analyze_f32.launches = 0
    got = lpc_analyze_f32(ac, n, bps, M, max_fixed)
    want = lpc_analyze_f32_plain(ac, n, bps, M, max_fixed)
    torch.cuda.synchronize()
    assert lpc_analyze_f32.launches == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    orders, intc, rshifts = (t.cpu().numpy() for t in got)
    assert (orders >= 1).all() and (orders <= M).all()
    assert rshifts[0] == 8 and not intc[0].any()        # silent rows
    if not max_fixed and M > 1:
        assert orders[2] == 1 and intc[2, 0] == -64      # the tie
    if max_fixed:
        assert (orders == M).all()


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 8, 32, 64, 128, 255])
@pytest.mark.parametrize("max_fixed", [False, True])
def test_k14_lanes_order_equals_plain(cuda, M, max_fixed):
    """The lane layout at every M the presets reach (8 lanes a row up to M
    71, 16 up to 143, 32 above): orders, coefficients and shifts equal to
    the plain version summing gamma in the same order."""
    n = 4096 if M > 32 else 1024
    ac = k14_lags(45, n, 16, M, seed=3 * M + 1).to(cuda)
    got = lpc_analyze_f32(ac, n, 16, M, max_fixed)
    want = lpc_analyze_f32_plain(ac, n, 16, M, max_fixed)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [8, 16, 32])
def test_k14_every_lane_count_equals_plain(cuda, lanes):
    """The kernel at each lane count against the plain version summing
    in that count's order: at 8 lanes M 64 and 71, at 16 and 32 the
    least and the largest M that ``lanes_for`` gives them (5 and 9
    registers a lane)."""
    from srla_tpu_torch.kernels.lpc_f32 import lanes_for
    for M in {8: (64, 71), 16: (72, 143), 32: (144, 287)}[lanes]:
        assert lanes_for(M) == lanes
        ac = k14_lags(37, 4096, 24, M, seed=lanes + M).to(cuda)
        got = lpc_analyze_f32(ac, 4096, 24, M, False)
        want = lpc_analyze_f32_plain(ac, 4096, 24, M, False)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def k15_rows(V: int, n: int, seed: int) -> torch.Tensor:
    return chip_smoke.k15_odd_rows(torch, np, V, n, seed)


@pytest.mark.gpu
@pytest.mark.parametrize("n,max_porder", [(6, 1), (512, 9), (1024, 10),
                                          (4064, 5), (4096, 10)])
def test_k15_equals_plain_and_packed_length(cuda, n, max_porder):
    res = k15_rows(29, n, seed=n).to(cuda)
    rice_cost.launches = 0
    got = rice_cost(res, n, max_porder)
    want = rice_cost_plain(res, n, max_porder)
    torch.cuda.synchronize()
    assert rice_cost.launches == 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    ct, po, bits, ks = got
    u = ((res.long() << 1) ^ (res.long() >> 31)) & 0xFFFFFFFF
    _, total = residual_codewords(u, ct, po, ks, n)
    assert torch.equal(bits.long(), total)
    assert (ct.cpu()[3::7] == 2).all()


def k15_kind_rows(kind: str, V: int, n: int, seed: int) -> torch.Tensor:
    """Rows of one kind: 16-bit (music-like and full-range 16-bit noise),
    24-bit full range (codes under 2^25: the 32-bit body), int32-extreme
    (codes of 2^31 and above: the 64-bit body; one row of small values
    with a single -2^31)."""
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    rows = []
    for r in range(V):
        if kind == "16bit":
            x = (np.round(np.sin(t / (3.0 + r)) * 3000 + rng.randn(n) * 40)
                 if r % 2 else rng.randint(-(1 << 15), 1 << 15, n))
        elif kind == "24bit":
            x = rng.randint(-(1 << 23), 1 << 23, n)
        elif r % 3 == 2:
            x = rng.randint(-50, 50, n)
            x[rng.randint(n)] = -(1 << 31)
        else:
            x = rng.randint(-(1 << 31), 1 << 31, n, dtype=np.int64)
        rows.append(x)
    return torch.from_numpy(np.stack(rows).astype(np.int32))


def _k15_check(res, n, max_porder):
    rice_cost.launches = 0
    got = rice_cost(res, n, max_porder)
    want = rice_cost_plain(res, n, max_porder)
    torch.cuda.synchronize()
    assert rice_cost.launches == 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    ct, po, bits, ks = got
    u = ((res.long() << 1) ^ (res.long() >> 31)) & 0xFFFFFFFF
    _, total = residual_codewords(u, ct, po, ks, n)
    assert torch.equal(bits.long(), total)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["16bit", "24bit", "int32"])
@pytest.mark.parametrize("n,max_porder", [(1024, 7), (4096, 10)])
def test_k15_each_body_equals_plain(cuda, kind, n, max_porder):
    """Rows that take the 32-bit body (16- and 24-bit) and the 64-bit one
    (int32-extreme), bit for bit on every output, the bits the packed
    length."""
    _k15_check(k15_kind_rows(kind, 24, n, seed=n + len(kind)).to(cuda), n,
               max_porder)


@pytest.mark.gpu
@pytest.mark.parametrize("n,max_porder", [(12, 2), (1000, 3), (3072, 10),
                                          (4064, 5), (6144, 10),
                                          (20000, 5)])
def test_k15_non_power_of_two_equals_plain(cuda, n, max_porder):
    """Lengths that are no power of two (each leaf padded with zeros to
    one), every row kind."""
    _k15_check(k15_rows(21, n, seed=n).to(cuda), n, max_porder)


@pytest.mark.gpu
def test_k15_bits_pack_in_k5(cuda):
    """K5 packs each row into ceil(bits / 32) words from K15's bits: the
    last word's bits past the section stay zero."""
    n, P_ = 1024, 10
    res = k15_rows(14, n, seed=3).to(cuda)
    ct, po, bits, ks = rice_cost(res, n, P_)
    lens = (bits.long() + 31) // 32
    starts = torch.cumsum(lens, 0) - lens
    cap = int(lens.sum()) + 8
    u = ((res << 1) ^ (res >> 31))
    flat = pack_residual_sections(u, ct, po, ks, n, starts, lens, cap)
    torch.cuda.synchronize()
    words = flat.cpu().numpy().view(np.uint32)
    for r in range(res.shape[0]):
        b, s, L = int(bits[r]), int(starts[r]), int(lens[r])
        pad = 32 * L - b
        if pad:
            assert words[s + L - 1] & ((1 << pad) - 1) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("C,preset,block,ltp", [(2, 4, 4096, 0),
                                                (1, 2, 1024, 0),
                                                (2, 4, 1024, 3)])
def test_short_approx_encode_on_card(cuda, C, preset, block, ltp):
    pcm = make_music(3.0)[:C]
    enc = SRLAEncoder(make_parameter(C, 16, RATE, preset, block, 0, 4, ltp,
                                     0), cuda, approx=True)
    counts = {}
    for f in (lpc_analyze_f32, rice_cost, predict,
              pack_residual_sections):
        f.launches = 0
    got = enc.encode_whole(pcm)
    torch.cuda.synchronize()
    for f in (lpc_analyze_f32, rice_cost, predict,
              pack_residual_sections):
        counts[f.__name__] = f.launches
    groups = 2                         # the full blocks and the tail
    assert all(v == groups for v in counts.values()), counts
    np.testing.assert_array_equal(decode(got, cuda)[1], pcm)
    exact = host_encoder.encode(pcm, 16, RATE, preset=preset,
                                max_block=block, ltp_order=ltp)
    assert len(got) <= 1.02 * len(exact)
    assert enc.stats["repaired_blocks"] == 0
    assert enc.stats["host_blocks"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(chip_smoke.k16_layout_cases(np))))
def test_k16_f32_entry_layout_cases_equal_plain(cuda, case):
    """K16's f32 entry at K16's layout cases (n 1 to 16384, C 1 to 8, odd
    offsets, a strided view, int32 extremes, int32 at lshift 8): every
    output equal to its plain version."""
    c = chip_smoke.k16_layout_cases(np)[case]
    src = chip_smoke.k16_source(torch, cuda, c)
    variant_preemphasis_f32.launches = 0
    got = variant_preemphasis_f32(src, c[4])
    torch.cuda.synchronize()
    assert variant_preemphasis_f32.launches == 1
    for g, w in zip(got, variant_preemphasis_f32_plain(src, c[4])):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(chip_smoke.k16_cases(np))))
def test_k16_f32_entry_odd_cases_equal_plain(cuda, case):
    c = chip_smoke.k16_cases(np)[case]
    src = chip_smoke.k16_source(torch, cuda, c)
    got = variant_preemphasis_f32(src, c[4])
    for g, w in zip(got, variant_preemphasis_f32_plain(src, c[4])):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_k16_f32_entry_rows_of_16384_24_bit(cuda):
    """24-bit rows of 16384 samples, r0 above 2^53, as (V, 1, n) rows
    (the analysis of variant rows) and as stereo blocks."""
    rng = np.random.RandomState(24)
    x = rng.laplace(0, 1 << 21, (6, 2, 16384)).clip(
        -(1 << 23), (1 << 23) - 1).astype(np.int32)
    blocks = torch.from_numpy(x).to(cuda)
    got = variant_preemphasis_f32(blocks, 0)
    want = variant_preemphasis_f32_plain(blocks, 0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    rows = variant_stack(blocks, 0)
    r0, _ = preemphasis_f32_sums(rows)
    assert (r0.double() > 2.0 ** 53).any()
    assert torch.equal(P.preemphasis(rows)[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("V,ltp", [(0, 3), (1, 0)], ids=["V0_P3", "V1"])
def test_approx_encode_launches_k16_f32_and_k18(cuda, V, ltp):
    """The approximate analysis's pre-emphasis and LTP residual on the card
    are K16's f32 entry and K18: launched once a group (and K16 once a -V
    measurement call), the exact entry never, no plain version reached;
    lossless, within 2 % of the exact size."""
    pcm = make_music(3.0)
    enc = SRLAEncoder(make_parameter(2, 16, RATE, 4, 4096, V, 4, ltp, 0),
                      cuda, approx=True)
    assert enc.approx
    wrappers = (variant_preemphasis_f32, variant_preemphasis, ltp_predict,
                pack_residual_sections, predict)
    for w in wrappers:
        w.launches = 0
    got = chip_smoke.approx_no_plain(lambda: enc.encode_whole(pcm))
    torch.cuda.synchronize()
    k16, k16_exact, k18, groups, k3 = (w.launches for w in wrappers)
    assert groups >= 2 and k16_exact == 0
    assert k16 == k3                   # one analysis a group or call
    assert k18 == (groups if ltp else 0)
    if V == 0:
        assert k16 == groups
    else:
        assert k16 > groups and enc.stats["device_spans"] > 0
    np.testing.assert_array_equal(decode(got, cuda)[1], pcm)
    exact = host_encoder.encode(pcm, 16, RATE, preset=4,
                                variable_divisions=V, ltp_order=ltp)
    assert len(got) <= 1.02 * len(exact)


@pytest.mark.gpu
def test_approx_variable_on_card(cuda):
    pcm = make_segmented(3.0)
    enc = SRLAEncoder(make_parameter(2, 16, RATE, 4, 4096, 1, 4, 0, 0),
                      cuda, approx=True)
    got = enc.encode_whole(pcm)
    np.testing.assert_array_equal(decode(got, cuda)[1], pcm)
    assert enc.stats["device_spans"] > 0
    assert enc.stats["host_spans"] == 0
    assert enc.stats["remeasured_spans"] == 0


@pytest.mark.gpu
def test_full_step_sharded_on_card(cuda):
    rng = np.random.RandomState(0)
    sig = (rng.randn(37, 1024) * 2000).astype(np.int32)
    args = dict(n=1024, bps=16, max_params=32, max_fixed=False,
                fft_size=1024, max_porder=10)
    out, total = parallel.full_step_sharded([cuda, cuda], sig, **args)
    single = P.analyze_variants(torch.from_numpy(sig).to(cuda), **args)
    assert torch.equal(out["residual"], single["residual"])
    assert total == float(single["rice_bits"].sum())
