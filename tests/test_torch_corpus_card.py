"""The corpus and block paths on the card (``-m gpu``; they skip without
one): ``encode_files``, the fused corpus decode and the block-axis split
over two shards of one card, ``decode_block`` (K2 and K1 at B = 1, K9 on
LTP blocks), ``StreamingDecoder`` and ``encode_block``, each held to the
port's host encoder, the source PCM or the same call on the CPU (the
kernels' plain versions). No JAX here: the CPU twins of these tests, in
``test_torch_corpus.py`` and ``test_torch_block_api.py``, hold the port to
``srla_tpu``.

Every output is bytes or int32 PCM, so every comparison is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import signals  # noqa: E402
from srla_tpu_torch import SRLADecoder, SRLAEncoder, encode_files  # noqa: E402
from srla_tpu_torch import host_encoder, parallel  # noqa: E402
from srla_tpu_torch.constants import HEADER_SIZE  # noqa: E402
from srla_tpu_torch.format import decode_header, parse_block_header  # noqa: E402
from srla_tpu_torch.streaming import StreamingDecoder  # noqa: E402

BLOCK = 512
RATE = 44100


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _tone(n: int, C: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    x = np.sin(t / (5.0 + seed)) * 7000 + rng.randn(n) * 150
    return np.stack([x, 0.8 * x + rng.randn(n) * 40][:C]).astype(np.int32)


def _corpus() -> list:
    """An odd last block, one sample, silence, a RAW file, mono files,
    offset_lshift 1, and a file of one odd block after another file."""
    return [_tone(3 * BLOCK + 193, 2, 1), _tone(1, 2, 3),
            np.zeros((2, 900), np.int32), _tone(20, 2, 4),
            _tone(BLOCK + 300, 1, 5), _tone(BLOCK + 77, 1, 6),
            _tone(700, 2, 7) << 1, _tone(2 * BLOCK + 1, 2, 8) << 1,
            _tone(2 * BLOCK + 311, 2, 11), _tone(311, 2, 12),
            signals.chirp(16 * BLOCK + 199, 2, 16)]


def _host(files) -> list:
    return [host_encoder.encode(f, 16, RATE, preset=4, max_block=BLOCK)
            for f in files]


@pytest.mark.gpu
def test_encode_files_on_card(cuda):
    files = _corpus()
    got = encode_files(files, 16, RATE, cuda, preset=4, max_block=BLOCK)
    assert got == _host(files)
    stats = {}
    split = encode_files(files, 16, RATE, cuda, preset=4, max_block=BLOCK,
                         devices=[cuda, cuda], stats_out=stats)
    assert split == got
    assert len(stats["shard_rows"]) <= 2
    assert all(len(r) <= 2 for r in stats["shard_cuts"])


@pytest.mark.gpu
def test_decode_corpus_on_card(cuda):
    files = _corpus()
    streams = _host(files)
    for devices in ([cuda], [cuda, cuda]):
        got = parallel.decode_corpus_sharded(devices, streams)
        assert all(np.array_equal(p, f) for p, f in zip(got, files))


def _walk(dec, data: bytes) -> np.ndarray:
    header = decode_header(data)
    off, done, out = HEADER_SIZE, 0, []
    while done < header.num_samples:
        _, n, _, _ = parse_block_header(data, off, True)
        pcm, used = dec.decode_block(data, header, off)
        assert pcm.shape[1] == n
        out.append(pcm)
        off, done = off + used, done + n
    return np.concatenate(out, axis=1)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [BLOCK, 3001, 16384])
def test_decode_block_on_card(cuda, n):
    """K2 and K1 at B = 1, an odd n and 16384 among them, and K9 on the
    LTP blocks; the same PCM as the plain versions and the source."""
    pcm = signals.pitchy(2 * n + 311, 2, 16)
    for kw in (dict(preset=4), dict(preset=6, ltp_order=3)):
        data = host_encoder.encode(pcm, 16, RATE, max_block=n, **kw)
        got = _walk(SRLADecoder(cuda), data)
        assert np.array_equal(got, pcm)
        streamed = list(StreamingDecoder(data, cuda).blocks())
        assert np.array_equal(np.concatenate(streamed, axis=1), pcm)


@pytest.mark.gpu
def test_encode_block_on_card(cuda):
    param = host_encoder.make_parameter(2, 16, RATE, 4, BLOCK)
    rng = np.random.RandomState(5)
    blocks = [signals.chirp(BLOCK, 2, 16), np.zeros((2, BLOCK), np.int32),
              signals.chirp(20, 2, 16), signals.chirp(311, 2, 16),
              rng.randint(-2 ** 15, 2 ** 15, (2, BLOCK)).astype(np.int32)]
    for blk in blocks:
        assert SRLAEncoder(param, cuda).encode_block(blk) == SRLAEncoder(
            param, "cpu").encode_block(blk)
