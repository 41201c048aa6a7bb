"""The decode's synthesis tail on the card (``-m gpu``; the cases skip
without one): K19 (csrc/synth_tail.cu: the stereo inverse and offset
shift) and K1's coefficient-aligning entry (csrc/lpc_synth.cu,
``lpc_scan_coefs``) against their plain PyTorch versions on the same CUDA
tensors, bit for bit: K19 at the main decode group (B 1291, C 2, n 4096),
the tail (B 1, n 4064), n 333 (rows not 16-byte aligned), C 1, 3 and 8,
each method alone and mixed, lshift 0, 1 and 8, int32 extremes, a strided
and a contiguous methods view, in place and out of place; K1's entry on
test_torch_lpc.py's cases through both entries; ``synthesize`` and a
decode on the card launching K1's entry and K19. No JAX here: the CPU
twin, ``test_torch_synth.py``, holds the port to ``srla_tpu``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from srla_tpu_torch import SRLADecoder, host_encoder  # noqa: E402
from srla_tpu_torch.kernels.decode2 import (synth_tail,  # noqa: E402
                                            synth_tail_plain, synthesize)
from srla_tpu_torch.kernels.lpc import (align_coefs, lpc_scan,  # noqa: E402
                                        lpc_scan_coefs, lpc_scan_plain)
from srla_tpu_torch.kernels.ltp import ltp_synth  # noqa: E402
from srla_tpu_torch.signals import make_music  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _k19_check(cuda, B, C, n, method, lshift, seed, strided=True):
    y, m = chip_smoke.k19_inputs(torch, np, cuda, B, C, n, method, seed,
                                 strided)
    want = synth_tail_plain(y, m, lshift)
    out = torch.full_like(y, 12345)
    synth_tail.launches = 0
    assert synth_tail(y, m, lshift, out=out) is out       # out of place
    torch.cuda.synchronize()
    assert synth_tail.launches == 1
    assert torch.equal(out, want)
    before = y.clone()
    assert synth_tail(y, m, lshift) is y                  # in place
    torch.cuda.synchronize()
    assert torch.equal(y, want)
    launched = C >= 2 or lshift != 0
    assert synth_tail.launches == 1 + launched
    if not launched:
        assert torch.equal(before, want)


@pytest.mark.gpu
@pytest.mark.parametrize("method", [0, 1, 2, 3, None],
                         ids=["m0", "m1", "m2", "m3", "mixed"])
@pytest.mark.parametrize("lshift", [0, 1, 8])
@pytest.mark.parametrize("n", [333, 4096])
def test_k19_methods_and_shifts_equal_plain(cuda, method, lshift, n):
    _k19_check(cuda, 9, 2, n, method, lshift, seed=n + lshift)


@pytest.mark.gpu
@pytest.mark.parametrize("C,n,lshift", [(1, 333, 0), (1, 4096, 8),
                                        (3, 333, 1), (3, 4096, 0),
                                        (8, 333, 8), (8, 4064, 0)])
def test_k19_channels_equal_plain(cuda, C, n, lshift):
    _k19_check(cuda, 5, C, n, None, lshift, seed=C * n)


@pytest.mark.gpu
@pytest.mark.parametrize("B,n", [(1291, 4096), (1, 4064)],
                         ids=["main", "tail"])
@pytest.mark.parametrize("strided", [True, False])
def test_k19_decode_groups_equal_plain(cuda, B, n, strided):
    _k19_check(cuda, B, 2, n, None, 0, seed=B, strided=strided)


@pytest.mark.gpu
def test_k19_refuses_a_strided_output(cuda):
    y, m = chip_smoke.k19_inputs(torch, np, cuda, 3, 2, 64, None, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        synth_tail(y, m, 0, out=torch.empty((3, 2, 128), dtype=torch.int32,
                                            device=cuda)[..., ::2])


def _lpc_case(seed, R, n, M, orders=None, wide=False):
    """test_torch_lpc.py's inputs (edge rows: order 0, rshift 0, order M,
    int32-wrapping residuals and taps), coefficients left-aligned in a
    wider packed array."""
    rng = np.random.RandomState(seed)
    res = rng.randint(-4000, 4000, (R, n)).astype(np.int32)
    if orders is None:
        orders = rng.randint(0, M + 1, R)
        orders[0], orders[2] = 0, M
    orders = np.resize(np.asarray(orders, np.int32), R)
    packed = np.zeros((R, M + 5), np.int32)
    packed[:, 2:2 + M] = rng.randint(-(1 << 15), 1 << 15, (R, M))
    rsh = rng.randint(0, 15, R).astype(np.int32)
    rsh[1] = 0
    res[3:6] = rng.randint(-(1 << 30), 1 << 30, (3, n))
    packed[3:6, 2:2 + M] = rng.randint(-(1 << 30), 1 << 30, (3, M))
    dcoef = rng.randint(-16, 16, R).astype(np.int32)
    dprev = rng.randint(-30000, 30000, R).astype(np.int32)
    return res, packed, orders, rsh, dcoef, dprev


@pytest.mark.gpu
@pytest.mark.parametrize("R,n,M,orders", [
    (130, 40, 16, None),                                   # _inputs
    (45, 70, 72, (0, 1, 31, 32, 33, 63, 64, 65, 72)),       # lane groups
    (45, 4064, 72, (0, 1, 31, 32, 33, 63, 64, 65, 72)),
    (37, 600, 256, (256, 200, 255, 0, 233)),               # 8 taps a lane
    (70, 600, 256, None),
    (8, 333, 16, (17, 20, 0, 16, 3, 16, 1, 2))],           # orders past M
    ids=["inputs", "groups70", "groups4064", "taps256", "taps256b",
         "past_M"])
@pytest.mark.parametrize("fuse", [False, True], ids=["plain", "deemph"])
def test_k1_coefs_entry_equals_aligned_entry_and_plain(cuda, R, n, M,
                                                       orders, fuse):
    res, packed, ords, rsh, dcoef, dprev = _lpc_case(R + n + M, R, n, M,
                                                     orders)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in dict(
        res=res, ords=ords, rsh=rsh, dcoef=dcoef, dprev=dprev).items()}
    view = torch.from_numpy(packed).to(cuda)[:, 2:2 + M]
    kw = dict(dcoef=t["dcoef"], dprev=t["dprev"]) if fuse else {}
    al = align_coefs(view, t["ords"], M)
    lpc_scan_coefs.launches = lpc_scan.launches = 0
    got = lpc_scan_coefs(t["res"], view, t["ords"], t["rsh"], n, M, **kw)
    aligned = lpc_scan(t["res"], al, t["ords"], t["rsh"], n, M, **kw)
    want = lpc_scan_plain(t["res"], al, t["ords"], t["rsh"], n, M, **kw)
    torch.cuda.synchronize()
    assert lpc_scan_coefs.launches == 1 and lpc_scan.launches == 1
    assert torch.equal(got, aligned)
    assert torch.equal(got, want)
    if R % 2 == 0:                  # as (B, 2, M) blocks of the packed rows
        blocks = view.reshape(R // 2, 2, M)
        assert torch.equal(lpc_scan_coefs(t["res"], blocks, t["ords"],
                                          t["rsh"], n, M, **kw), got)


@pytest.mark.gpu
@pytest.mark.parametrize("C,n,M,lshift,has_ltp", [
    (2, 4096, 32, 0, False), (2, 333, 16, 8, True), (3, 4064, 12, 1, True),
    (1, 333, 8, 0, False), (1, 256, 8, 1, True)])
def test_synthesize_on_card_equals_cpu(cuda, C, n, M, lshift, has_ltp):
    """synthesize on the card launches K1's coefficient entry (twice with
    LTP: the LPC, then the de-emphasis at order 0), K9 with LTP and K19
    (not for a mono group at lshift 0), and equals its plain run on the
    CPU."""
    inp = chip_smoke.synth_inputs(np, 11, C, n, M, seed=n + M, ltp=has_ltp,
                                  width=3)
    kw = dict(n=n, C=C, M=M, has_ltp=has_ltp)
    want = synthesize(*chip_smoke.synth_args(torch, np, inp, "cpu", C, M),
                      lshift, **kw)
    wrappers = (lpc_scan, lpc_scan_coefs, ltp_synth, synth_tail)
    for w in wrappers:
        w.launches = 0
    got = synthesize(*chip_smoke.synth_args(torch, np, inp, cuda, C, M),
                     lshift, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert [w.launches for w in wrappers] == [
        0, 1 + has_ltp, int(has_ltp), int(C >= 2 or lshift != 0)]


@pytest.mark.gpu
def test_decode_on_card_launches_k1_entry_and_k19(cuda):
    pcm = make_music(2.0)
    stream = host_encoder.encode(pcm, 16, 44100, preset=4)
    wrappers = (lpc_scan, lpc_scan_coefs, synth_tail)
    for w in wrappers:
        w.launches = 0
    dec = SRLADecoder(cuda)
    _, out = dec.decode_whole(stream)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(out, pcm)
    groups = lpc_scan_coefs.launches
    assert groups >= 1 and lpc_scan.launches == 0
    assert synth_tail.launches == groups
