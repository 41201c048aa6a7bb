"""The exact encode's last stages on the card (``-m gpu``; the cases skip
without one): K16 (csrc/preemphasis.cu), K17 (csrc/select.cu, both
entries), K18 (csrc/ltp_predict.cu) and K5's row entry (csrc/bitpack.cu)
against their plain PyTorch versions on the same CUDA tensors, bit for
bit on every output, at chip_smoke's odd shapes (n 333 at C 1 and 3,
unaligned spans, int32 extremes, half boundaries; ties, clamped codes,
raw blocks and sections above W at M 8-255; periods 8 and 262, the delay
past n, order 1; rows not 16-byte aligned) and at a group of the main
path's width; and short encodes on the card (-V 0, -V 1, -P 3): the host
exact stream's bytes, each stage's kernel launched and no plain version
reached. K16's CTA-a-block layout at chip_smoke.k16_layout_cases (n 1 to
16384, C 1 to 8, odd offsets, a strided view, int32 at lshift 8); K17's
look-back at chip_smoke.K17_EDGES (one row, a CTA's blocks less one,
exactly, one more, B 2048, C 32, M 255), back-to-back launches and replays
of a captured launch on new inputs. No JAX here: the CPU twin,
``test_torch_encode_stages.py``, holds the plain versions to
``srla_tpu``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from srla_tpu_torch import SRLAEncoder, host_encoder  # noqa: E402
from srla_tpu_torch.host_encoder import make_parameter  # noqa: E402
from srla_tpu_torch.kernels import select  # noqa: E402
from srla_tpu_torch.kernels.ltp import (ltp_predict,  # noqa: E402
                                        ltp_predict_plain)
from srla_tpu_torch.kernels.preemphasis import (  # noqa: E402
    Spans, variant_preemphasis)
from srla_tpu_torch.signals import make_music  # noqa: E402

RATE = 44100


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(chip_smoke.k16_cases(np))))
def test_k16_odd_cases_equal_plain(cuda, case):
    c = chip_smoke.k16_cases(np)[case]
    src = chip_smoke.k16_source(torch, cuda, c)
    k16, plain = chip_smoke.k16_entries()
    variant_preemphasis.launches = 0
    got = k16(src, c[4])
    torch.cuda.synchronize()
    assert variant_preemphasis.launches == 1
    _equal(got, plain(src, c[4]))


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(chip_smoke.k16_layout_cases(np))))
def test_k16_layout_cases_equal_plain(cuda, case):
    c = chip_smoke.k16_layout_cases(np)[case]
    src = chip_smoke.k16_source(torch, cuda, c)
    k16, plain = chip_smoke.k16_entries()
    variant_preemphasis.launches = 0
    got = k16(src, c[4])
    torch.cuda.synchronize()
    assert variant_preemphasis.launches == 1
    _equal(got, plain(src, c[4]))


@pytest.mark.gpu
def test_k16_main_width_spans_and_blocks_equal_plain(cuda):
    """A group of the main path's width (4096-sample stereo int16 blocks)
    read as spans of the resident file, as a block tensor and as the
    strided view that cutting the spans gives: the same rows, equal to
    the plain version."""
    pcm = make_music(1.0)
    n, B = 4096, pcm.shape[1] // 4096
    file = torch.from_numpy(np.ascontiguousarray(pcm, np.int16)).to(cuda)
    spans = Spans(file, np.arange(B) * n, n)
    k16, plain = chip_smoke.k16_entries()
    got = k16(spans, 0)
    _equal(got, plain(spans, 0))
    view = spans.cut()
    assert not view.is_contiguous()
    _equal(k16(view, 0), got)
    _equal(k16(view.contiguous(), 0), got)


@pytest.mark.gpu
@pytest.mark.parametrize("B,C,M,sec64", [(37, 2, 8, True), (29, 1, 32, False),
                                         (23, 3, 64, True),
                                         (41, 2, 128, False),
                                         (7, 2, 255, True)])
def test_k17_equals_plain(cuda, B, C, M, sec64):
    small, rice_risky, kw = chip_smoke.k17_small(torch, np, cuda, B, C, M,
                                                 B + M, sec64)
    select.select_blocks.launches = select.measure_blocks.launches = 0
    assert chip_smoke.k17_check(torch, f"B {B} C {C} M {M}", small,
                                rice_risky, kw) == 0
    assert select.select_blocks.launches == 1
    assert select.measure_blocks.launches == 1


@pytest.mark.gpu
@pytest.mark.parametrize("B,C,M,sec64", chip_smoke.K17_EDGES)
def test_k17_edges_equal_plain(cuda, B, C, M, sec64):
    small, rice_risky, kw = chip_smoke.k17_small(torch, np, cuda, B, C, M,
                                                 B + M, sec64)
    select.select_blocks.launches = 0
    assert chip_smoke.k17_check(torch, f"B {B} C {C} M {M}", small,
                                rice_risky, kw) == 0
    assert select.select_blocks.launches == 1


@pytest.mark.gpu
def test_k17_back_to_back_launches(cuda):
    """50 launches at B 2048, each followed by one at B 9, with no
    synchronisation: every starts the running sum of its lens_w."""
    assert chip_smoke.k17_repeat_check(torch, np, cuda, 50) == 100


@pytest.mark.gpu
def test_k17_graph_replays_on_new_inputs(cuda):
    """A launch captured once and replayed on new inputs: each replay's
    outputs are the plain version's on its inputs."""
    assert chip_smoke.k17_graph_check(torch, np, cuda) == 6


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(chip_smoke.k18_cases(np))))
def test_k18_equals_plain(cuda, case):
    _, *a = chip_smoke.k18_cases(np)[case]
    args = tuple(torch.from_numpy(x).to(cuda) for x in a[:3]) + (a[3],)
    ltp_predict.launches = 0
    got = ltp_predict(*args)
    torch.cuda.synchronize()
    assert ltp_predict.launches == 1
    assert torch.equal(got, ltp_predict_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("V,n,porder", [(12, 334, 1), (40, 512, 9)])
def test_k5_row_entry_equals_plain(cuda, V, n, porder):
    args, image = chip_smoke.k5_rows_case(torch, np, cuda, V, n, porder,
                                          V + n)
    assert chip_smoke.k5_rows_check(torch, f"at {V} rows x {n}", args,
                                    image) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("V,P", [(0, 0), (1, 0), (0, 3), (1, 3)])
def test_encode_runs_the_stages_on_card(cuda, V, P):
    """A short encode on the card: the host exact stream's bytes, K16 once
    an analysis call, K17's encode entry once a group and its measurement
    entry once a measurement call, K18 once a call with -P, K5's row entry
    once a group, and no plain version of them reached."""
    pcm = make_music(3.0)
    param = make_parameter(2, 16, RATE, 4, 4096, V, 4, P, 0)
    want = host_encoder.encode(pcm, 16, RATE, preset=4, max_block=4096,
                               variable_divisions=V, ltp_order=P)
    wrappers = {k: w for k, w in chip_smoke.all_wrappers().items()
                if k in ("preemphasis", "select_blocks", "measure_blocks",
                         "ltp_predict", "pack_residual_sections",
                         "fir_predict")}
    enc = SRLAEncoder(param, cuda)
    got, n = chip_smoke.counted(torch, wrappers, lambda: chip_smoke
                                .without_plain(lambda: enc.encode_whole(pcm)))
    assert got == want
    calls = n["fir_predict"]
    assert calls > 0 and n["preemphasis"] == calls
    assert n["select_blocks"] == n["pack_residual_sections"] > 0
    assert n["measure_blocks"] == calls - n["select_blocks"]
    assert (n["measure_blocks"] > 0) == (V > 0)
    assert n["ltp_predict"] == (calls if P else 0)
