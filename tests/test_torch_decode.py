"""The port's whole decode slice, srla_tpu_torch.SRLADecoder, on the CPU
(kernels' plain versions) against the source PCM, the native decoder and
srla_tpu's device decoder on JAX-CPU; plus the port's parameter packing,
its CLI, and its freedom from jax and srla_tpu.

Every output is an integer, so every comparison is exact (tolerance 0)."""

import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import signals  # noqa: E402
from srla_tpu import encode  # noqa: E402
from srla_tpu import decoder as host_decoder  # noqa: E402
from srla_tpu.constants import HEADER_SIZE, BlockDataType  # noqa: E402
from srla_tpu.format import decode_header, parse_block_header  # noqa: E402
from srla_tpu.kernels import decode2 as jax_decode2  # noqa: E402
from srla_tpu_torch import SRLADecoder, decode  # noqa: E402
from srla_tpu_torch.kernels import decode2 as torch_decode2  # noqa: E402

BLOCK = 512
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the CPU decodes and encodes here are many small
    torch ops, which run faster on one thread than on a pool that the test
    workers' pools contend with."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(kind: str):
    """(pcm, bits per sample, encode keyword arguments) per stream kind."""
    rng = np.random.RandomState(sum(map(ord, kind)))
    n = BLOCK * 6
    t = np.arange(n)
    tone = np.sin(t / 13.0) * 8000 + rng.randn(n) * 300
    if kind == "stereo_sr":
        return np.stack([tone, tone * 0.97 + rng.randn(n) * 5]).astype(
            np.int32), 16, {}
    if kind == "stereo_ls":
        return np.stack([rng.randn(n) * 50, tone]).astype(np.int32), 16, {}
    if kind == "stereo_ms":
        gain = np.where((t // 32) % 2, 5, 5000)
        return (rng.randn(2, n) * gain).astype(np.int32), 16, {}
    if kind == "silent_raw":
        pcm = signals.chirp(n, 2, 16)
        pcm[:, :BLOCK] = 0                               # a SILENT block
        pcm[:, 2 * BLOCK:3 * BLOCK] = signals.white_noise(BLOCK, 2, 16)
        return pcm, 16, {}                               # and a RAW one
    if kind == "odd_tail":
        return signals.chirp(n + 77, 2, 16), 16, {}
    if kind == "lshift":
        return signals.lshifted_sine(n, 2, 16), 16, {}
    if kind == "8bit":
        return signals.chirp(n, 2, 8), 8, {}
    if kind == "24bit":
        return signals.gaussian_noise(n, 2, 24), 24, {}
    if kind == "ltp":
        return signals.pitchy(n, 2, 16), 16, dict(preset=6, ltp_order=3)
    if kind == "variable":                 # -V 2 splits around the step
        n = 5 * 1024
        t = np.arange(n)
        step = np.sin(t / 7.0) * np.where(t < n // 2 + 300, 100, 20000)
        return step.astype(np.int32)[None].repeat(2, 0), 16, dict(
            max_block=1024, variable_divisions=2)
    if kind == "mono":
        return tone[None].astype(np.int32), 16, {}
    raise ValueError(kind)


def _encode(kind: str):
    pcm, bps, kw = _case(kind)
    return pcm, encode(pcm, bps, 44100, **{"max_block": BLOCK, **kw})


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


KINDS = ["stereo_sr", "stereo_ls", "stereo_ms", "silent_raw", "odd_tail",
         "lshift", "8bit", "24bit", "ltp", "variable", "mono"]


@pytest.mark.parametrize("kind", KINDS)
def test_decode_matches_source_and_native(kind):
    pcm, data = _encode(kind)
    dec = SRLADecoder("cpu")
    _, got = dec.decode_whole(data)
    _, native = host_decoder.SRLADecoder(backend="native").decode_whole(data)
    np.testing.assert_array_equal(got, pcm)
    np.testing.assert_array_equal(got, native)
    ncomp = _blocks(data)[BlockDataType.COMPRESS]
    assert dec.stats == {"device_blocks": ncomp, "host_blocks": 0}


def test_cases_reach_every_path():
    """The streams above hold every stereo method, SILENT and RAW blocks,
    LTP blocks, an offset shift, and groups of several block sizes."""
    methods, sizes, ltp = set(), set(), False
    for kind in ("stereo_sr", "stereo_ls", "stereo_ms", "odd_tail", "ltp",
                 "variable"):
        _, data = _encode(kind)
        _, _, groups = SRLADecoder("cpu").plan(data)
        for g in groups:
            cols, _ = torch_decode2.meta_cols(2, g.M, 3)
            methods |= set(g.meta[:, cols["method"][0]].tolist())
            sizes.add(g.n)
            ltp |= g.has_ltp
    assert methods == {0, 1, 2, 3}
    assert len(sizes) >= 3 and ltp
    counts = _blocks(_encode("silent_raw")[1])
    assert counts[BlockDataType.SILENT] and counts[BlockDataType.RAW]
    assert decode_header(_encode("lshift")[1]).offset_lshift > 0


def test_decode_matches_jax_device_decoder():
    """srla_tpu's device decode (decode_blocks_paged) on JAX-CPU and the
    port give the same PCM on a stereo LTP stream with an odd tail."""
    pcm = signals.pitchy(BLOCK * 5 + 100, 2, 16)
    data = encode(pcm, 16, 44100, preset=4, ltp_order=3, max_block=BLOCK)
    _, want = host_decoder.SRLADecoder(backend="tpu").decode_whole(data)
    _, got = decode(data, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pcm)


def test_pack_meta_matches_jax():
    _, data = _encode("ltp")
    dec = SRLADecoder("cpu")
    header = decode_header(data)
    offs, sizes, offset, progress = [], [], HEADER_SIZE, 0
    while progress < header.num_samples:
        btype, nsamples, poff, psize = parse_block_header(data, offset)
        if btype == BlockDataType.COMPRESS:
            offs.append(poff)
            sizes.append(psize)
        offset, progress = poff + psize, progress + nsamples
    pp = dec._parse_params_batch(data, np.asarray(offs, np.int64),
                                 np.asarray(sizes, np.int64), header)
    sel = np.arange(0, len(offs), 2)
    rng = np.random.RandomState(0)
    ws = rng.randint(0, 1 << 20, len(sel)).astype(np.int32)
    br = rng.randint(0, 32, len(sel)).astype(np.int32)
    M = int(pp["orders"].max())
    args = (pp, sel, ws, br, len(sel) + 3, 2, M, 3)
    np.testing.assert_array_equal(torch_decode2.pack_meta(*args),
                                  jax_decode2.pack_meta(*args))
    assert torch_decode2.meta_cols(2, M, 3) == jax_decode2._meta_cols(2, M, 3)


def test_cli_roundtrip(tmp_path):
    from srla_tpu.wavio import WavData, write_wav
    from srla_tpu_torch.cli import main
    wav = tmp_path / "in.wav"
    write_wav(str(wav), WavData(signals.chirp(20000, 2, 16), 44100, 16))
    srl, out = tmp_path / "x.srl", tmp_path / "out.wav"
    # The defaults (-V 1) encode, with srla_tpu's bytes; --backend is
    # refused.
    pcm = signals.chirp(20000, 2, 16)
    assert main(["-e", "--device", "cpu", str(wav), str(srl)]) == 0
    assert srl.read_bytes() == encode(pcm, 16, 44100, variable_divisions=1)
    assert main(["-e", "--backend", "exact", "-V", "0", str(wav),
                 str(srl)]) == 1
    assert main(["-e", "-B", "1024", "-V", "0", "--device", "cpu", str(wav),
                 str(srl)]) == 0
    assert srl.read_bytes() == encode(pcm, 16, 44100, max_block=1024,
                                      variable_divisions=0)
    assert main(["-d", "--device", "cpu", str(srl), str(out)]) == 0
    assert out.read_bytes() == wav.read_bytes()


def test_port_never_imports_jax(tmp_path):
    """Importing the port, encoding, decoding and running its CLI leave jax
    and every srla_tpu module unimported (a subprocess: this one has both
    loaded). The reference bytes come from this process, through a file."""
    pcm = (np.arange(3000).reshape(1, -1) % 97 - 48).astype(np.int32)
    ref = tmp_path / "ref.srl"
    ref.write_bytes(encode(pcm, 16, 44100, max_block=512))
    (tmp_path / "ref.srl.v").write_bytes(
        encode(pcm, 16, 44100, variable_divisions=1))
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import srla_tpu_torch, srla_tpu_torch.cli\n"
        "pcm = (np.arange(3000).reshape(1, -1) % 97 - 48).astype(np.int32)\n"
        "data = srla_tpu_torch.encode(pcm, 16, 44100, device='cpu', "
        "max_block=512)\n"
        f"ref = {str(ref)!r}\n"
        "assert data == open(ref, 'rb').read()\n"
        "_, out = srla_tpu_torch.decode(data, device='cpu')\n"
        "assert (out == pcm).all()\n"
        "wav = ref + '.wav'\n"
        "assert srla_tpu_torch.cli.main(['-d', '--device', 'cpu', ref, "
        "wav]) == 0\n"
        "assert srla_tpu_torch.cli.main(['-e', '-V', '0', '-B', '512', "
        "'--device', 'cpu', wav, ref + '.2']) == 0\n"
        "assert open(ref + '.2', 'rb').read() == data\n"
        "assert srla_tpu_torch.cli.main(['-e', '--device', 'cpu', wav, "
        "ref + '.3']) == 0\n"
        "assert open(ref + '.3', 'rb').read() == open(ref + '.v', "
        "'rb').read()\n"
        "bad = [m for m in sys.modules if m in ('jax', 'srla_tpu', 'bench')"
        " or m.startswith(('jax.', 'srla_tpu.'))]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_decode_without_native_parser(monkeypatch):
    """The Python parameter parser (hosts where the port's native library
    does not build) gives the same PCM."""
    from srla_tpu_torch import native_decoder
    pcm, data = _encode("ltp")
    monkeypatch.setattr(native_decoder, "available", lambda: False)
    dec = SRLADecoder("cpu")
    assert dec._host._native is None
    _, got = dec.decode_whole(data)
    np.testing.assert_array_equal(got, pcm)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["stereo_ms", "silent_raw", "ltp",
                                  "variable", "mono"])
def test_decode_on_card(cuda, kind):
    pcm, data = _encode(kind)
    dec = SRLADecoder(cuda)
    _, got = dec.decode_whole(data)
    np.testing.assert_array_equal(got, pcm)
    assert dec.stats["host_blocks"] == 0
