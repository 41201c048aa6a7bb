"""The port's own host layer against srla_tpu's: the exact host encoder
(``srla_tpu_torch.host_encoder.encode``) byte-equal to
``srla_tpu.encode(..., backend="exact")`` over channel counts, bit depths,
presets and LTP orders, with SILENT, RAW and odd-size tail blocks, with
and without the native library; the WAV/AIFF reader and WAV writer; the
native parameter parse; the Huffman codebooks; the two native libraries
kept apart in one process; and an AST walk that finds no import of
srla_tpu, jax or bench anywhere in the port or in chip_smoke.py.

Every comparison is exact (bytes or integers, tolerance 0)."""

import ast
import ctypes
import os

import numpy as np
import pytest

import signals
import srla_tpu
from srla_tpu import huffman as jax_huffman
from srla_tpu import native_decoder as jax_native
from srla_tpu import wavio as jax_wavio
from srla_tpu.constants import HEADER_SIZE, BlockDataType
from srla_tpu.format import decode_header, parse_block_header
from srla_tpu_torch import host_encoder, huffman, native_decoder, wavio

BLOCK = 512
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pcm(kind: str, C: int, bps: int, tail: int = 77):
    """A stream of 5 blocks and an odd tail of ``tail`` samples, with a
    SILENT block (the second) and a white-noise block (the fourth, a RAW
    fallback)."""
    n = BLOCK * 5 + tail
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
    pcm[:, BLOCK:2 * BLOCK] = 0
    pcm[:, 3 * BLOCK:4 * BLOCK] = signals.white_noise(BLOCK, C, bps, seed=3)
    return pcm


def _blocks(data: bytes) -> dict:
    """Count of each block type, from the block headers."""
    header = decode_header(data)
    counts = {t: 0 for t in BlockDataType}
    offset, progress = HEADER_SIZE, 0
    while progress < header.num_samples and offset < len(data):
        btype, nsamples, poff, psize = parse_block_header(data, offset)
        counts[btype] += 1
        offset, progress = poff + psize, progress + nsamples
    return counts


def _both(pcm, bps, preset, ltp):
    kw = dict(preset=preset, max_block=BLOCK, ltp_order=ltp)
    want = srla_tpu.encode(pcm, bps, 44100, variable_divisions=0,
                           backend="exact", **kw)
    return host_encoder.encode(pcm, bps, 44100, **kw), want


# (signal, channels, bits, preset, LTP order, tail samples). Every case has
# SILENT, RAW and COMPRESS blocks and an odd tail; the tail of 1 sample at
# -m 0 is a COMPRESS block of one sample (LTP's degenerate n == 1 branch).
HOST_CASES = [
    ("music", 1, 16, 4, 0, 77), ("music", 2, 16, 4, 0, 77),
    ("music", 3, 16, 2, 0, 77), ("chirp", 2, 8, 0, 0, 77),
    ("music", 2, 24, 6, 0, 77), ("pitchy", 2, 16, 6, 3, 77),
    ("pitchy", 1, 24, 4, 1, 301), ("pitchy", 3, 8, 2, 3, 77),
    ("music", 2, 16, 0, 1, 77), ("chirp", 1, 16, 6, 3, 77),
    ("lshifted_sine", 2, 16, 4, 0, 77), ("gaussian_noise", 2, 24, 2, 1, 77),
    ("pitchy", 2, 16, 0, 3, 1),
]


@pytest.mark.parametrize("kind,C,bps,preset,ltp,tail", HOST_CASES)
def test_host_encode_bytes_equal_srla_tpu(kind, C, bps, preset, ltp, tail):
    pcm = _pcm(kind, C, bps, tail)
    got, want = _both(pcm, bps, preset, ltp)
    assert got == want
    counts = _blocks(got)
    assert counts[BlockDataType.SILENT] == 1 and counts[BlockDataType.RAW]
    assert counts[BlockDataType.COMPRESS]


@pytest.mark.parametrize("kind,C,bps,preset,ltp", [
    ("pitchy", 2, 16, 2, 3), ("music", 1, 24, 1, 0),
])
def test_host_encode_without_native_library(monkeypatch, kind, C, bps,
                                            preset, ltp):
    """The NumPy paths of the port's host encoder (hosts where the native
    library does not build) emit srla_tpu's bytes (srla_tpu's native)."""
    pcm = _pcm(kind, C, bps)
    want = srla_tpu.encode(pcm, bps, 44100, preset=preset, max_block=BLOCK,
                           ltp_order=ltp)
    monkeypatch.setattr(native_decoder, "available", lambda: False)
    assert host_encoder.encode(pcm, bps, 44100, preset=preset,
                               max_block=BLOCK, ltp_order=ltp) == want


def test_host_encoder_stats_and_progress():
    """Host blocks are counted with srla_tpu's keys; progress reaches the
    whole file; SVR encodes as srla_tpu does."""
    pcm = _pcm("music", 2, 16)
    param = host_encoder.make_parameter(2, 16, 44100, max_block=BLOCK)
    enc = host_encoder.SRLAEncoder(param)
    seen = []
    enc.encode_whole(pcm, progress_callback=seen.append)
    # 4 even blocks typed COMPRESS (the noise block among them, emitted RAW)
    # in one host batch; the odd tail is serial and not a host batch.
    assert enc.stats == {"device_blocks": 0, "host_blocks": 4,
                         "repaired_blocks": 0, "w_overflow_blocks": 0,
                         "device_spans": 0, "remeasured_spans": 0,
                         "host_spans": 0}
    assert seen == [4 * BLOCK]
    # SVR is in the copy: one iteration (the work buffer only) on this
    # stream, and on an odd-length 24-bit file at -V 1, whose odd last
    # window reads the buffer SVR left (the shape of
    # test_golden_exact.py::test_svr_buffer_state_odd_window, smaller).
    assert host_encoder.encode(pcm, 16, 44100, max_block=BLOCK,
                               svr_iterations=1) == srla_tpu.encode(
        pcm, 16, 44100, max_block=BLOCK, svr_iterations=1)
    odd = signals.chirp(2 * BLOCK + 333, 3, 24)
    assert host_encoder.encode(odd, 24, 44100, preset=2, max_block=BLOCK,
                               variable_divisions=1,
                               svr_iterations=1) == srla_tpu.encode(
        odd, 24, 44100, preset=2, max_block=BLOCK, variable_divisions=1,
        svr_iterations=1)
    # -V is ported: the variable-block search runs on the host.
    param = host_encoder.make_parameter(2, 16, 44100, max_block=BLOCK,
                                        variable_divisions=1)
    assert param.min_num_samples_per_block == BLOCK // 2
    host_encoder.SRLAEncoder(param)


@pytest.mark.parametrize("C,bps", [(1, 8), (2, 16), (3, 24)])
def test_wavio_matches_srla_tpu(tmp_path, C, bps):
    pcm = signals.chirp(3001, C, bps)
    mine, theirs = tmp_path / "mine.wav", tmp_path / "theirs.wav"
    wavio.write_wav(str(mine), wavio.WavData(pcm, 48000, bps))
    jax_wavio.write_wav(str(theirs), jax_wavio.WavData(pcm, 48000, bps))
    assert mine.read_bytes() == theirs.read_bytes()
    back = wavio.read_audio(str(theirs))
    want = jax_wavio.read_audio(str(theirs))
    np.testing.assert_array_equal(back.pcm, pcm)
    np.testing.assert_array_equal(back.pcm, want.pcm)
    assert (back.sampling_rate, back.bits_per_sample) == (48000, bps)


def test_aiff_read_matches_srla_tpu(tmp_path):
    pcm = signals.chirp(2000, 2, 16)
    path = tmp_path / "x.aiff"
    jax_wavio.write_aiff(str(path), jax_wavio.WavData(pcm, 44100, 16))
    got = wavio.read_audio(str(path))
    np.testing.assert_array_equal(got.pcm, pcm)
    np.testing.assert_array_equal(got.pcm, jax_wavio.read_audio(
        str(path)).pcm)


def test_native_parse_matches_srla_tpu():
    """The port's native parameter parse equals srla_tpu's on every
    COMPRESS payload of a stereo -m 6 -P 3 stream."""
    pcm = _pcm("pitchy", 2, 16)
    data = srla_tpu.encode(pcm, 16, 44100, preset=6, ltp_order=3,
                           max_block=BLOCK)
    header = decode_header(data)
    offs, sizes, offset, progress = [], [], HEADER_SIZE, 0
    while progress < header.num_samples:
        btype, nsamples, poff, psize = parse_block_header(data, offset)
        if btype == BlockDataType.COMPRESS:
            offs.append(poff)
            sizes.append(psize)
        offset, progress = poff + psize, progress + nsamples
    args = (data, np.asarray(offs, np.int64), np.asarray(sizes, np.int64),
            2, 16)
    got = native_decoder.parse_params_batch(*args)
    want = jax_native.parse_params_batch(*args)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["ltp_periods"] > 0).any()


def test_huffman_codebooks_match_srla_tpu():
    for mine, theirs in ((huffman.parameter_codebook(),
                          jax_huffman.parameter_codebook()),
                         (huffman.sum_parameter_codebook(),
                          jax_huffman.sum_parameter_codebook())):
        np.testing.assert_array_equal(mine.codes, theirs.codes)
        np.testing.assert_array_equal(mine.lengths, theirs.lengths)
        assert mine.max_length == theirs.max_length


def test_make_music_matches_bench():
    """chip_smoke.py's signal is bench.make_music's, sample for sample."""
    from bench import make_music as bench_music
    from srla_tpu_torch.signals import make_music
    for seconds, seed in ((0.5, 7), (0.25, 3)):
        np.testing.assert_array_equal(make_music(seconds, seed=seed),
                                      bench_music(seconds, seed=seed))


def test_native_libraries_stay_apart():
    """Both native libraries load in one process; each entry resolves to
    its own library's code (RTLD_LOCAL, own file name)."""
    mine, theirs = native_decoder._load(), jax_native._load()
    assert os.path.basename(native_decoder.SO_PATH) \
        == "libsrla_torch_native.so"
    assert mine._name != theirs._name
    for name in ("srla_parse_params_batch", "srla_assemble_blocks",
                 "srla_fletcher16"):
        a = ctypes.cast(getattr(mine, name), ctypes.c_void_p).value
        b = ctypes.cast(getattr(theirs, name), ctypes.c_void_p).value
        assert a != b, name
    assert mine.srla_fletcher16(b"srla", 4) == theirs.srla_fletcher16(
        b"srla", 4)


def _port_files():
    root = os.path.join(REPO, "srla_tpu_torch")
    for dirpath, _, names in os.walk(root):
        for name in names:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("srla_tpu", "jax", "bench")


def test_port_imports_nothing_of_srla_tpu():
    """No file of the port, and not chip_smoke.py, imports srla_tpu or a
    module of it, jax or bench (srla_tpu_torch itself is allowed)."""
    bad = []
    files = list(_port_files())
    assert len(files) > 30
    assert os.path.join(REPO, "srla_tpu_torch", "kernels",
                        "verify.py") in files
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {m}"
                    for m in mods if _forbidden(m)]
    assert not bad, bad
