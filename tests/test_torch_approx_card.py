"""The f32 approximate encode on the card (``-m gpu``; the cases skip
without one): K14 (csrc/lpc_analyze_f32.cu) and K15 (csrc/rice_cost.cu)
against their plain PyTorch versions on the same CUDA tensors at small odd
shapes (chip_smoke.k14_odd_lags and k15_odd_rows: silent rows, a half-even
tie, full-range 24-bit and int32-extreme rows), bit for bit on every
output, and a short approximate encode on the
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
from srla_tpu_torch.kernels.predict import predict  # noqa: E402
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
