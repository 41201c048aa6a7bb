"""The port's corpus paths on the CPU (the kernels' plain versions):
``encoder.encode_files`` (files batched across one virtual file),
``parallel.decode_corpus_sharded`` (streams fused into one virtual stream)
and the block-axis split over devices, against ``srla_tpu``'s
``encode_files(..., backend="exact")`` and ``decode`` and against the
port's exact host encoder, file by file.

Every output is bytes or int32 PCM, so every comparison is exact."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import signals  # noqa: E402
import srla_tpu  # noqa: E402
from srla_tpu import encoder as jax_encoder  # noqa: E402
from srla_tpu_torch import encoder as port_encoder  # noqa: E402
from srla_tpu_torch import host_encoder, parallel  # noqa: E402

BLOCK = 512
RATE = 44100


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the plain versions are many small torch ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tone(n: int, C: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    x = np.sin(t / (5.0 + seed)) * 7000 + rng.randn(n) * 150
    return np.stack([x, 0.8 * x + rng.randn(n) * 40][:C]).astype(np.int32)


def _corpus() -> list:
    """Files without a file whose first COMPRESS block is odd-length: an
    odd last block after even ones, one sample, all silent, fewer samples
    than any preset's parameter count (RAW), a mono file, two files with
    samples << 1 (a group of their own) and a lone file of samples << 2."""
    return [_tone(3 * BLOCK + 193, 2, 1),        # odd last block
            _tone(2 * BLOCK, 2, 2),
            _tone(1, 2, 3),                      # one sample
            np.zeros((2, 900), np.int32),        # all silent
            _tone(20, 2, 4),                     # RAW
            _tone(BLOCK + 300, 1, 5),            # mono
            _tone(BLOCK + 77, 1, 6),             # mono, odd last block
            _tone(700, 2, 7) << 1,               # offset_lshift 1
            _tone(2 * BLOCK + 1, 2, 8) << 1,
            _tone(600, 2, 9) << 2]               # a group of one


def _trap() -> list:
    """A file whose last block is odd, then a file of one odd COMPRESS
    block: batched, that block's work-buffer state would come from the
    previous file's last COMPRESS block."""
    return [_tone(2 * BLOCK + 311, 2, 11), _tone(311, 2, 12),
            signals.chirp(BLOCK + 199, 2, 16)]


def _host(files, preset: int, **kw) -> list:
    return [host_encoder.encode(f, 16, RATE, preset=preset, max_block=BLOCK,
                                **kw) for f in files]


@pytest.mark.parametrize("preset", [2, 4])
def test_encode_files_equals_jax_and_host(preset):
    files = _corpus()
    got = port_encoder.encode_files(files, 16, RATE, "cpu", preset=preset,
                                    max_block=BLOCK)
    assert got == _host(files, preset)
    assert got == jax_encoder.encode_files(files, 16, RATE, preset=preset,
                                           max_block=BLOCK, backend="exact")


@pytest.mark.parametrize("preset", [2, 4])
def test_encode_files_odd_first_block_is_per_file(preset):
    """The port gives each file fresh work-buffer state, as the reference
    encodes each file from fresh memory; srla_tpu's batched bytes take the
    previous file's state there and differ (the divergence by design)."""
    files = _trap()
    want = _host(files, preset)
    got = port_encoder.encode_files(files, 16, RATE, "cpu", preset=preset,
                                    max_block=BLOCK)
    assert got == want
    jax_got = jax_encoder.encode_files(files, 16, RATE, preset=preset,
                                       max_block=BLOCK, backend="exact")
    assert jax_got[0] == want[0]
    assert jax_got[1] != want[1]


def test_encode_files_batches_device_calls(monkeypatch):
    """One encode_blocks call per (group, block size), across files: fewer
    than the per-file encodes make; the stats sum over the corpus."""
    calls = []
    real = port_encoder.encode_blocks

    def counting(blocks, *a, **k):
        calls.append(blocks.shape[0])
        return real(blocks, *a, **k)

    monkeypatch.setattr(port_encoder, "encode_blocks", counting)
    files = [_tone(2 * BLOCK + 64, 2, s) for s in range(4)] + [
        _tone(BLOCK + 64, 1, 9)]
    stats = {}
    got = port_encoder.encode_files(files, 16, RATE, "cpu", preset=2,
                                    max_block=BLOCK, stats_out=stats)
    batched = list(calls)
    calls.clear()
    for f in files:
        port_encoder.encode(f, 16, RATE, "cpu", preset=2, max_block=BLOCK)
    # Stereo: one group of 8 blocks of 512 and one of 4 blocks of 64; mono:
    # one file, 2 calls.
    assert sorted(batched) == [1, 1, 4, 8]
    assert len(batched) < len(calls) == 10
    assert got == _host(files, 2)
    assert stats["device_blocks"] + stats["repaired_blocks"] \
        + stats["w_overflow_blocks"] == 14


def test_encode_files_variable_is_per_file():
    """-V > 0 encodes each file on its own, as srla_tpu does."""
    files = [_tone(4 * BLOCK, 2, 21), _tone(4 * BLOCK + 2, 2, 22)]
    got = port_encoder.encode_files(files, 16, RATE, "cpu", preset=2,
                                    max_block=BLOCK, variable_divisions=1,
                                    lookahead_factor=2)
    assert got == _host(files, 2, variable_divisions=1, lookahead_factor=2)


@pytest.mark.parametrize("parts", [1, 2, 3, 5])
def test_shards_are_contiguous_and_near_equal(parts):
    for rows in (1, 2, 7, 12):
        cut = parallel.shards(rows, ["cpu"] * parts)
        sizes = [hi - lo for _, lo, hi in cut]
        assert len(cut) == min(parts, rows)
        assert [lo for _, lo, _ in cut] == [0] + list(np.cumsum(sizes)[:-1])
        assert sum(sizes) == rows and max(sizes) - min(sizes) <= 1
        assert sizes == sorted(sizes, reverse=True)


def test_encode_split_equals_unsplit():
    files = _corpus() + _trap()
    want = port_encoder.encode_files(files, 16, RATE, "cpu", preset=4,
                                     max_block=BLOCK)
    stats = {}
    got = parallel.encode_corpus_sharded(["cpu", "cpu", "cpu"], files, 16,
                                         RATE, preset=4, max_block=BLOCK,
                                         stats_out=stats)
    assert got == want
    # Every group's rows, in at most 3 shards of near-equal size; the last
    # group's also under srla_tpu's key.
    cuts = stats["shard_cuts"]
    assert cuts and stats["shard_rows"] == cuts[-1]
    assert all(len(r) <= 3 and max(r) - min(r) <= 1 for r in cuts)


def test_encoder_split_stats_and_single_file():
    pcm = _tone(7 * BLOCK, 2, 31)
    param = host_encoder.make_parameter(2, 16, RATE, 2, BLOCK)
    enc = port_encoder.SRLAEncoder(param, "cpu", devices=["cpu"] * 3)
    assert enc.encode_whole(pcm) == _host([pcm], 2)[0]
    assert enc.stats["shard_rows"] == [2, 2, 3]
    assert enc.stats["shard_cuts"] == [[2, 2, 3]]


@pytest.mark.parametrize("parts", [1, 2])
def test_flagged_blocks_are_repaired_in_every_shard(monkeypatch, parts):
    """Blocks the analysis flags are re-derived on the host, shard by
    shard: the same bytes, every flag counted once."""
    real = port_encoder.encode_blocks

    def flag_every_third(blocks, *a, **k):
        small, flat = real(blocks, *a, **k)
        small["risky_blk"] = small["risky_blk"].clone()
        small["risky_blk"][::3] = True
        return small, flat

    monkeypatch.setattr(port_encoder, "encode_blocks", flag_every_third)
    files = [_tone(5 * BLOCK + 64, 2, 51), _tone(4 * BLOCK, 2, 52) << 1,
             _tone(3 * BLOCK, 2, 53) << 1]
    stats = {}
    got = port_encoder.encode_files(files, 16, RATE, "cpu", preset=2,
                                    max_block=BLOCK, devices=["cpu"] * parts,
                                    stats_out=stats)
    assert got == _host(files, 2)
    # Groups of 5 and 1 (file 0) and 7 (files 1, 2) blocks, cut in parts.
    flagged = sum(len(range(0, hi - lo, 3)) for rows in (5, 1, 7)
                  for _, lo, hi in parallel.shards(rows, ["cpu"] * parts))
    assert stats["repaired_blocks"] == flagged
    assert stats["device_blocks"] + flagged == 13
    assert sorted(stats["shard_cuts"]) == sorted(
        sorted(hi - lo for _, lo, hi in parallel.shards(rows, ["cpu"] * parts))
        for rows in (5, 1, 7))


@pytest.mark.parametrize("parts", [1, 3])
def test_decode_corpus_sharded(parts):
    files = _corpus() + _trap()
    streams = _host(files, 4)
    stats = {}
    got = parallel.decode_corpus_sharded(["cpu"] * parts, streams,
                                         stats_out=stats)
    for f, s, pcm in zip(files, streams, got):
        assert pcm.dtype == np.int32
        assert np.array_equal(pcm, f)
        assert np.array_equal(pcm, srla_tpu.decode(s)[1])
    assert stats["host_blocks"] == 0
    if parts == 3:
        cuts = stats["shard_cuts"]
        assert cuts and stats["shard_rows"] == cuts[-1]
        assert all(len(r) <= 3 and max(r) - min(r) <= 1 for r in cuts)
        # Every COMPRESS block went through one shard of one group.
        assert sum(map(sum, cuts)) == stats["device_blocks"]


def test_decoder_split_stats():
    from srla_tpu_torch import SRLADecoder
    pcm = _tone(7 * BLOCK, 2, 41)
    stream = _host([pcm], 2)[0]
    dec = SRLADecoder("cpu", devices=["cpu", "cpu", "cpu"])
    _, got = dec.decode_whole(stream)
    assert np.array_equal(got, pcm)
    assert dec.stats == {"device_blocks": 7, "host_blocks": 0,
                         "shard_cuts": [[2, 2, 3]], "shard_rows": [2, 2, 3]}


def test_make_devices_names_cuda_devices_only():
    devs = parallel.make_devices()
    assert len(devs) == torch.cuda.device_count()
    assert all(d.type == "cuda" for d in devs)
    assert parallel.make_devices(0) == []
    with pytest.raises(ValueError):
        port_encoder.SRLAEncoder(host_encoder.make_parameter(2, 16, RATE),
                                 "cpu", devices=[])
