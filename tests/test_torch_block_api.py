"""The port's block and streaming API on the CPU (the kernels' plain
versions): ``SRLAEncoder.encode_block``, ``SRLADecoder.decode_block``, the
host one-block reference (``decode_block_params``, ``synthesize_block``,
``decode_raw_block``), ``streaming.StreamingDecoder`` with seek and resume,
the player and ``wavio.write_aiff``, against their ``srla_tpu`` twins,
block by block.

Every output is bytes or int32 PCM, so every comparison is exact."""

import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import signals  # noqa: E402
from srla_tpu import decoder as jax_decoder  # noqa: E402
from srla_tpu import encoder as jax_encoder  # noqa: E402
from srla_tpu import streaming as jax_streaming  # noqa: E402
from srla_tpu import wavio as jax_wavio  # noqa: E402
from srla_tpu.constants import HEADER_SIZE, BlockDataType  # noqa: E402
from srla_tpu.format import decode_header, parse_block_header  # noqa: E402
from srla_tpu_torch import SRLADecoder, SRLAEncoder  # noqa: E402
from srla_tpu_torch import host_decoder, host_encoder, wavio  # noqa: E402
from srla_tpu_torch.streaming import StreamingDecoder  # noqa: E402
from srla_tpu_torch.tools import srla_player  # noqa: E402

BLOCK = 512
RATE = 44100
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the plain versions are many small torch ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _blocks() -> dict:
    """(C, n) blocks by kind: every branch of the block type decision."""
    rng = np.random.RandomState(5)
    return {"chirp": signals.chirp(BLOCK, 2, 16),
            "silent": np.zeros((2, BLOCK), np.int32),
            "raw_sized": signals.chirp(20, 2, 16),
            "odd": signals.chirp(2 * BLOCK + 311, 2, 16)[:, -311:],
            "noise": rng.randint(-2 ** 15, 2 ** 15, (2, BLOCK)).astype(
                np.int32),
            "mono": signals.chirp(BLOCK, 1, 16),
            "lshift": signals.lshifted_sine(BLOCK, 2, 16)}


def _param(C: int, preset: int = 4, ltp: int = 0):
    return host_encoder.make_parameter(C, 16, RATE, preset, BLOCK, 0, 4, ltp)


def _jax_param(C: int, preset: int = 4, ltp: int = 0):
    return jax_encoder.EncodeParameter(
        num_channels=C, bits_per_sample=16, sampling_rate=RATE,
        preset=preset, max_num_samples_per_block=BLOCK,
        min_num_samples_per_block=BLOCK, num_lookahead_samples=4 * BLOCK,
        ltp_order=ltp)


@pytest.mark.parametrize("kind", sorted(_blocks()))
def test_encode_block_equals_jax(kind):
    pcm = _blocks()[kind]
    lshift = 3 if kind == "lshift" else 0
    C = pcm.shape[0]
    enc = SRLAEncoder(_param(C), "cpu")
    got = enc.encode_block(pcm, offset_lshift=lshift)
    want = jax_encoder.SRLAEncoder(_jax_param(C), backend="exact"
                                   ).encode_block(pcm, offset_lshift=lshift)
    assert got == want
    kind_of = {"silent": BlockDataType.SILENT, "raw_sized": BlockDataType.RAW,
               "noise": BlockDataType.RAW}
    assert parse_block_header(got, 0, True)[0] == kind_of.get(
        kind, BlockDataType.COMPRESS)


def test_encode_block_with_ltp_equals_jax():
    pcm = signals.pitchy(BLOCK, 2, 16)
    got = SRLAEncoder(_param(2, 6, 3), "cpu").encode_block(pcm)
    assert got == jax_encoder.SRLAEncoder(
        _jax_param(2, 6, 3), backend="exact").encode_block(pcm)


def _stream(kind: str):
    """(pcm, stream) from the host exact encoder."""
    n = 4 * BLOCK + 311
    if kind == "ltp":
        pcm = signals.pitchy(n, 2, 16)
        return pcm, host_encoder.encode(pcm, 16, RATE, preset=6,
                                        max_block=BLOCK, ltp_order=3)
    if kind == "lshift":
        pcm = signals.lshifted_sine(n, 2, 16)
    else:
        pcm = signals.chirp(n, 2, 16)
        pcm[:, :BLOCK] = 0                               # SILENT
        pcm[:, 2 * BLOCK:3 * BLOCK] = signals.white_noise(BLOCK, 2, 16)
    return pcm, host_encoder.encode(pcm, 16, RATE, preset=4, max_block=BLOCK)


def _offsets(data: bytes):
    """(offset, block type, samples, payload offset, payload size) of every
    framed block."""
    header = decode_header(data)
    off, done, out = HEADER_SIZE, 0, []
    while done < header.num_samples:
        btype, n, poff, psize = parse_block_header(data, off, True)
        out.append((off, btype, n, poff, psize))
        off, done = poff + psize, done + n
    return out


@pytest.mark.parametrize("kind", ["mixed", "ltp", "lshift"])
def test_decode_block_equals_jax_block_by_block(kind):
    pcm, data = _stream(kind)
    header = decode_header(data)
    dec = SRLADecoder("cpu")
    ref = jax_decoder.SRLADecoder()
    host = host_decoder.SRLADecoder()
    blocks = _offsets(data)
    out = []
    for off, btype, n, poff, psize in blocks:
        got, used = dec.decode_block(data, header, off)
        want, want_used = ref.decode_block(data, header, off)
        assert used == want_used == poff + psize - off
        assert got.dtype == np.int32 and np.array_equal(got, want)
        if btype == BlockDataType.COMPRESS:
            payload = data[poff:poff + psize]
            assert np.array_equal(host.synthesize_block(
                host.decode_block_params(payload, header, n), header, n),
                want)
        out.append(got)
    assert np.array_equal(np.concatenate(out, axis=1), pcm)
    compress = sum(b[1] == BlockDataType.COMPRESS for b in blocks)
    assert dec.stats == {"device_blocks": compress, "host_blocks": 0}
    if kind == "mixed":
        assert {b[1] for b in blocks} == {BlockDataType.SILENT,
                                          BlockDataType.RAW,
                                          BlockDataType.COMPRESS}


@pytest.mark.parametrize("kind", ["mixed", "ltp"])
def test_host_block_reference_equals_jax(kind):
    _, data = _stream(kind)
    header = decode_header(data)
    dec = SRLADecoder("cpu")
    ref = jax_decoder.SRLADecoder()
    for _, btype, n, poff, psize in _offsets(data):
        payload = data[poff:poff + psize]
        if btype == BlockDataType.RAW:
            assert np.array_equal(dec.decode_raw_block(payload, header, n),
                                  ref.decode_raw_block(payload, header, n))
        if btype != BlockDataType.COMPRESS:
            continue
        got = dec.decode_block_params(payload, header, n)
        want = ref.decode_block_params(payload, header, n)
        assert got.method == want.method
        for k in ("pre_prev", "pre_coef", "orders", "rshifts", "coefs",
                  "ltp_orders", "ltp_periods", "ltp_coefs", "residual"):
            assert np.array_equal(getattr(got, k), getattr(want, k)), k
        assert np.array_equal(dec.synthesize_block(got, header, n),
                              ref.synthesize_block(want, header, n))


def test_streaming_decoder_equals_jax_with_seek():
    pcm, data = _stream("mixed")
    dec = StreamingDecoder(data, "cpu")
    ref = jax_streaming.StreamingDecoder(data)
    marks = []
    got = []
    while not dec.exhausted:
        marks.append(dec.tell())
        got.append(dec.decode_block())
        assert np.array_equal(got[-1], ref.decode_block())
    assert dec.decode_block() is None and ref.exhausted
    assert np.array_equal(np.concatenate(got, axis=1), pcm)
    # Resume at a retained block boundary: the same PCM from there on.
    for k in (1, 3):
        again = StreamingDecoder(data, "cpu")
        again.seek_to_block(*marks[k])
        rest = list(again.blocks())
        assert len(rest) == len(got) - k
        assert all(np.array_equal(a, b) for a, b in zip(rest, got[k:]))


@pytest.mark.parametrize("bps", [8, 16, 24])
def test_write_aiff_read_back_by_jax(tmp_path, bps):
    pcm = signals.chirp(1001, 2, bps)
    path = str(tmp_path / "a.aiff")
    wavio.write_aiff(path, wavio.WavData(pcm, 96000, bps))
    back = jax_wavio.read_aiff(path)
    assert (back.sampling_rate, back.bits_per_sample) == (96000, bps)
    assert np.array_equal(back.pcm, pcm)
    ref = str(tmp_path / "b.aiff")
    jax_wavio.write_aiff(ref, jax_wavio.WavData(pcm, 96000, bps))
    assert open(path, "rb").read() == open(ref, "rb").read()


def test_player_wav_sink_is_lossless(tmp_path, capsys):
    pcm, data = _stream("ltp")
    src = tmp_path / "in.srl"
    src.write_bytes(data)
    out = str(tmp_path / "out.wav")
    assert srla_player.main([str(src), "--sink", "wav", "--out", out,
                             "--device", "cpu"]) == 0
    back = wavio.read_wav(out)
    assert back.sampling_rate == RATE and np.array_equal(back.pcm, pcm)
    assert "played" in capsys.readouterr().err


def test_player_module_entry_point(tmp_path):
    _, data = _stream("lshift")
    src = tmp_path / "in.srl"
    src.write_bytes(data)
    run = subprocess.run(
        [sys.executable, "-m", "srla_tpu_torch.tools.srla_player", str(src),
         "--sink", "null", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "played" in run.stderr
