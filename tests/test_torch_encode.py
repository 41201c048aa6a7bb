"""The port's whole encode slice, srla_tpu_torch.SRLAEncoder, on the CPU
(kernels' plain versions) against srla_tpu.encode(backend="exact"), the
host encoder that is byte-exact with the reference: the same bytes over
mono/stereo, 8/16/24 bit and -m 0/2/4, with SILENT, RAW and odd-size tail
blocks; the stats invariants; host repair of flagged blocks and of
over-long sections; the port's own decode of the port's streams; the CLI;
and SVR refinement (--svr-filter-learning-iteration), the last flag
ported, byte-equal too.

Every comparison is exact (bytes or integers)."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import signals  # noqa: E402
from srla_tpu import encode as host_encode  # noqa: E402
from srla_tpu.constants import HEADER_SIZE, BlockDataType  # noqa: E402
from srla_tpu.format import decode_header, parse_block_header  # noqa: E402
from srla_tpu_torch import SRLAEncoder, decode, encode  # noqa: E402
from srla_tpu_torch import native_decoder  # noqa: E402
from srla_tpu_torch.host_encoder import EncodeParameter  # noqa: E402
from srla_tpu_torch.kernels import exact as texact  # noqa: E402

BLOCK = 512


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _pcm(kind: str, C: int, bps: int, n: int = BLOCK * 5 + 77,
         gaps: bool = True):
    """A stream with (if ``gaps``) a SILENT block and a white-noise block
    (RAW fallback), and by default an odd-size COMPRESS tail (77 samples:
    the serial host path at -m <= 4)."""
    if kind == "music":
        rng = np.random.RandomState(C * 100 + bps)
        t = np.arange(n)
        amp = (1 << (bps - 1)) - 1
        x = (np.sin(t / 13.0) * 0.3 + np.sin(t / 5.1) * 0.2) * amp
        pcm = np.stack([x * (0.9 + 0.1 * c) + rng.randn(n) * amp * 1e-3
                        for c in range(C)])
        pcm = np.clip(np.round(pcm), -amp - 1, amp).astype(np.int32)
    else:
        pcm = signals.ALL[kind](n, C, bps)
    if gaps:
        pcm[:, BLOCK:2 * BLOCK] = 0
        pcm[:, 3 * BLOCK:4 * BLOCK] = signals.white_noise(BLOCK, C, bps,
                                                          seed=3)
    return pcm


def _param(C, bps, preset, block=BLOCK, **kw):
    return EncodeParameter(num_channels=C, bits_per_sample=bps,
                           sampling_rate=44100, preset=preset,
                           max_num_samples_per_block=block,
                           min_num_samples_per_block=block,
                           num_lookahead_samples=4 * block, **kw)


def _blocks(data: bytes, even_only: bool = False) -> dict:
    """Count of each block type in a stream (of even size only, if asked)."""
    header = decode_header(data)
    counts = {t: 0 for t in BlockDataType}
    offset, progress = HEADER_SIZE, 0
    while progress < header.num_samples and offset < len(data):
        btype, nsamples, poff, psize = parse_block_header(data, offset)
        counts[btype] += not (even_only and nsamples % 2)
        offset, progress = poff + psize, progress + nsamples
    return counts


def _device_typed(pcm, preset) -> int:
    """Even-size blocks typed COMPRESS (not silent, above the order
    limit): the blocks the device path takes."""
    from srla_tpu.constants import PARAMETER_PRESETS
    limit = PARAMETER_PRESETS[preset].max_num_parameters
    return sum(1 for off in range(0, pcm.shape[1], BLOCK)
               if (n := min(BLOCK, pcm.shape[1] - off)) % 2 == 0
               and n > limit and pcm[:, off:off + n].any())


def _accounted(enc, data, pcm, preset):
    """Every device-typed block is emitted from the device, repaired or a
    counted overflow, or was a device RAW fallback (not a stats key in
    srla_tpu either): the COMPRESS blocks of even size in the stream are
    among the first three, the RAW ones bound the last."""
    s = enc.stats
    handled = (s["device_blocks"] + s["repaired_blocks"]
               + s["w_overflow_blocks"])
    even = _blocks(data, even_only=True)
    typed = _device_typed(pcm, preset)
    assert even[BlockDataType.COMPRESS] <= handled <= typed
    assert handled >= typed - even[BlockDataType.RAW]
    return handled


def _check(pcm, bps, preset, device="cpu"):
    C = pcm.shape[0]
    want = host_encode(pcm, bps, 44100, preset=preset, max_block=BLOCK,
                       variable_divisions=0)
    enc = SRLAEncoder(_param(C, bps, preset), device)
    got = enc.encode_whole(pcm)
    assert got == want
    counts = _blocks(got)
    s = enc.stats
    # Nothing is flagged and no section overflows here; the odd tail is
    # encoded serially on the host, as in srla_tpu (not a host batch).
    assert s["repaired_blocks"] == s["w_overflow_blocks"] == 0
    assert s["host_blocks"] == 0
    assert _accounted(enc, got, pcm, preset) == s["device_blocks"] > 0
    assert counts[BlockDataType.SILENT] == 1 and counts[BlockDataType.RAW]
    _, out = decode(got, device=device)
    np.testing.assert_array_equal(out, pcm)
    return enc


@pytest.mark.parametrize("kind,C,bps,preset", [
    ("music", 2, 16, 4), ("music", 1, 16, 4), ("music", 2, 24, 4),
    ("chirp", 2, 16, 2), ("chirp", 1, 24, 0), ("music", 2, 8, 2),
    ("lshifted_sine", 2, 16, 4), ("pitchy", 3, 16, 2),
    ("gaussian_noise", 2, 16, 0),
    # Max orders 8, 32 and 128: the accounting's coefficient loops at
    # widths the other cases do not reach.
    ("music", 2, 16, 1), ("pitchy", 3, 16, 3), ("music", 2, 24, 5),
])
def test_bytes_equal_host_exact(kind, C, bps, preset):
    _check(_pcm(kind, C, bps), bps, preset)


def test_module_encode_and_stats_keys():
    pcm = _pcm("music", 2, 16)
    got = encode(pcm, 16, 44100, device="cpu", max_block=BLOCK)
    assert got == host_encode(pcm, 16, 44100, max_block=BLOCK)
    enc = _check(pcm, 16, 4)
    assert set(enc.stats) >= {"device_blocks", "host_blocks",
                              "repaired_blocks", "w_overflow_blocks",
                              "repair_ratio"}
    assert enc.stats["repair_ratio"] == 0.0


def test_flagged_blocks_are_repaired_on_host(monkeypatch):
    """With the pre-emphasis margin widened past every decision, every
    variant is flagged: every block is re-derived on the host, counted, and
    the bytes are unchanged."""
    monkeypatch.setattr(texact, "_EPS_PREEMPH", 1.0)
    pcm = _pcm("music", 2, 16)
    want = host_encode(pcm, 16, 44100, max_block=BLOCK)
    enc = SRLAEncoder(_param(2, 16, 4), "cpu")
    with pytest.warns(RuntimeWarning, match="decision boundaries"):
        assert enc.encode_whole(pcm) == want
    s = enc.stats
    # Every device-typed block, the RAW fallback among them, is flagged.
    assert s["device_blocks"] == 0
    assert s["repaired_blocks"] == s["host_blocks"] == _device_typed(pcm, 4)
    assert _accounted(enc, want, pcm, 4) == s["repaired_blocks"]
    assert s["repair_ratio"] == 1.0


def test_overlong_sections_go_to_host(monkeypatch):
    """A section bound W below every section: each non-raw block is a
    counted overflow, encoded on the host, and the bytes are unchanged."""
    monkeypatch.setattr(SRLAEncoder, "_section_words", lambda self, n: 1)
    pcm = _pcm("music", 1, 16)
    want = host_encode(pcm, 16, 44100, max_block=BLOCK)
    enc = SRLAEncoder(_param(1, 16, 4), "cpu")
    assert enc.encode_whole(pcm) == want
    s = enc.stats
    assert s["device_blocks"] == 0 and s["repaired_blocks"] == 0
    assert s["w_overflow_blocks"] == s["host_blocks"] == 3
    assert _accounted(enc, want, pcm, 4) == 3


def test_python_assembly_without_native_library(monkeypatch):
    """Where the port's native library does not build, the payloads are
    built with the Python bit writer: the same bytes."""
    pcm = _pcm("chirp", 2, 16)
    want = host_encode(pcm, 16, 44100, max_block=BLOCK)
    monkeypatch.setattr(native_decoder, "available", lambda: False)
    enc = SRLAEncoder(_param(2, 16, 4), "cpu")
    assert enc.encode_whole(pcm) == want
    assert enc.stats["device_blocks"] == 3


def test_main_path_block_size():
    """Two full -B 4096 blocks and a short even tail group at -m 4: the
    main path's group shapes (4096, and a one-block tail) at small scale."""
    pcm = _pcm("music", 2, 16, n=2 * 4096 + 1000, gaps=False)
    want = host_encode(pcm, 16, 44100, preset=4, max_block=4096)
    enc = SRLAEncoder(_param(2, 16, 4, block=4096), "cpu")
    assert enc.encode_whole(pcm) == want
    assert enc.stats["device_blocks"] == 3


def test_long_group_split_into_calls(monkeypatch):
    """A group above MAX_CALL_BLOCKS goes to the device in several calls:
    the same bytes, every block counted once."""
    monkeypatch.setattr(SRLAEncoder, "MAX_CALL_BLOCKS", 2)
    pcm = _pcm("music", 2, 16, n=BLOCK * 5, gaps=False)
    enc = SRLAEncoder(_param(2, 16, 4), "cpu")
    assert enc.encode_whole(pcm) == host_encode(pcm, 16, 44100,
                                                max_block=BLOCK)
    assert enc.stats["device_blocks"] == 5


def test_step_timer_breakdown():
    """The per-step breakdown chip_smoke.py prints: every step of the
    encode, each kernel on its own, and the bytes unchanged."""
    from srla_tpu_torch.encoder import StepTimer
    pcm = _pcm("music", 2, 16)
    enc = SRLAEncoder(_param(2, 16, 4), "cpu")
    enc.timer = StepTimer("cpu")
    assert enc.encode_whole(pcm) == host_encode(pcm, 16, 44100,
                                                max_block=BLOCK)
    steps = enc.timer.seconds
    for name in ("host typing", "upload", "K16 preemphasis",
                 "K3 fir_predict", "K4 rice_search", "K17 select",
                 "K5 bitpack", "fetch + big-endian bytes", "repair (host)",
                 "assembly"):
        assert steps[name] >= 0.0, name
    # No stage of the group encode runs as torch ops.
    assert not [k for k in steps if "(torch)" in k]
    # The Rice search is one step, K4's.
    assert not [k for k in steps if "Rice" in k]


@pytest.mark.parametrize("kw,what", [
    (dict(ltp_order=1, num_svr_filter_learning_iteration=1), "SVR"),
    (dict(num_svr_filter_learning_iteration=2), "SVR"),
])
def test_unported_flags_raise(kw, what):
    """The flags the port once refused (SVR, the last of them) now encode:
    the same bytes as srla_tpu at -V 0 (the odd tail block reads the SVR
    work buffer the block before left) and at -V 1. One iteration only
    scores the initial coefficients (and leaves its soft-thresholded
    buffer); two take a step."""
    assert what == "SVR"
    iters = kw["num_svr_filter_learning_iteration"]
    ltp = kw.get("ltp_order", 0)
    pcm = _pcm("music", 2, 16)
    enc = SRLAEncoder(_param(2, 16, 4, **kw), "cpu")
    assert enc.encode_whole(pcm) == host_encode(
        pcm, 16, 44100, max_block=BLOCK, ltp_order=ltp,
        svr_iterations=iters)
    assert enc.stats["device_blocks"] > 0
    param = _param(2, 16, 4, **kw)
    param.min_num_samples_per_block = BLOCK // 2
    assert SRLAEncoder(param, "cpu").encode_whole(pcm) == host_encode(
        pcm, 16, 44100, max_block=BLOCK, variable_divisions=1,
        ltp_order=ltp, svr_iterations=iters)


def test_cli_encode_roundtrip(tmp_path):
    from srla_tpu.wavio import WavData, write_wav
    from srla_tpu_torch.cli import main
    pcm = _pcm("music", 2, 16)
    wav = tmp_path / "in.wav"
    write_wav(str(wav), WavData(pcm, 44100, 16))
    srl, out = tmp_path / "x.srl", tmp_path / "out.wav"
    assert main(["-e", "-m", "2", "-B", str(BLOCK), "-V", "0", "--device",
                 "cpu", str(wav), str(srl)]) == 0
    assert srl.read_bytes() == host_encode(pcm, 16, 44100, preset=2,
                                           max_block=BLOCK)
    assert main(["-d", "--device", "cpu", str(srl), str(out)]) == 0
    assert out.read_bytes() == wav.read_bytes()
    # -P and SVR run on --device.
    assert main(["-e", "-m", "2", "-B", str(BLOCK), "-V", "0", "-P", "1",
                 "--device", "cpu", str(wav), str(srl)]) == 0
    assert srl.read_bytes() == host_encode(pcm, 16, 44100, preset=2,
                                           max_block=BLOCK, ltp_order=1)
    for ltp, svr in ((1, 1), (0, 2)):
        flags = ["-P", str(ltp), "--svr-filter-learning-iteration", str(svr)]
        assert main(["-e", "-m", "2", "-B", str(BLOCK), "-V", "0", *flags,
                     "--device", "cpu", str(wav), str(srl)]) == 0
        assert srl.read_bytes() == host_encode(
            pcm, 16, 44100, preset=2, max_block=BLOCK, ltp_order=ltp,
            svr_iterations=svr)


@pytest.mark.parametrize("flagged", [False, True],
                         ids=["device", "all-repaired"])
def test_progress_callback_fires_once_per_block(monkeypatch, flagged):
    """One call a block, whatever encoded it (device group, host repair,
    SILENT, RAW fallback, the odd-size tail), with the samples done so far:
    strictly rising, ending at the stream's length; a broken callback does
    not break the encode."""
    if flagged:
        monkeypatch.setattr(texact, "_EPS_PREEMPH", 1.0)
    pcm = _pcm("music", 2, 16)
    nblocks = -(-pcm.shape[1] // BLOCK)
    seen = []
    enc = SRLAEncoder(_param(2, 16, 4), "cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        data = enc.encode_whole(pcm, progress_callback=seen.append)
    assert data == host_encode(pcm, 16, 44100, max_block=BLOCK)
    assert len(seen) == nblocks == sum(_blocks(data).values())
    assert all(b > a for a, b in zip(seen, seen[1:]))
    assert seen[-1] == pcm.shape[1]

    def broken(done):
        raise RuntimeError("meter")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert SRLAEncoder(_param(2, 16, 4), "cpu").encode_whole(
            pcm, progress_callback=broken) == data


def test_cli_progress_meter(tmp_path, monkeypatch, capsys):
    """On a terminal the CLI prints the per-block meter to stderr, one
    update a block, ending at 100 %; piped, it prints none."""
    import sys

    from srla_tpu.wavio import WavData, write_wav
    from srla_tpu_torch.cli import main
    pcm = _pcm("music", 2, 16)
    wav, srl = tmp_path / "in.wav", tmp_path / "x.srl"
    write_wav(str(wav), WavData(pcm, 44100, 16))
    argv = ["-e", "-B", str(BLOCK), "-V", "0", "--device", "cpu", str(wav),
            str(srl)]
    assert main(argv) == 0
    assert "progress" not in capsys.readouterr().err
    monkeypatch.setattr(sys.stderr, "isatty", lambda: True, raising=False)
    assert main(argv) == 0
    err = capsys.readouterr().err
    assert err.count("progress:") == -(-pcm.shape[1] // BLOCK)
    assert err.rstrip().endswith("100.0 %")


@pytest.mark.gpu
@pytest.mark.parametrize("kind,C,bps,preset", [
    ("music", 2, 16, 4), ("chirp", 1, 24, 2), ("pitchy", 3, 16, 0),
    ("music", 2, 24, 5),
])
def test_encode_on_card(cuda, kind, C, bps, preset):
    _check(_pcm(kind, C, bps), bps, preset, device=cuda)
