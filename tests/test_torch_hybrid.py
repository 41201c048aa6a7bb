"""The port's work-stealing hybrid encode (``SRLAEncoder(...,
hybrid=True, host_workers=k)``) and the host encoder's thread pool
(``host_encoder``'s ``workers``, the device encoder's ``host_workers``), on
the CPU (the device side runs the kernels' plain versions) against
``srla_tpu.encode(..., backend="exact")`` in the same process:

- the hybrid's bytes at 1 and 3 host threads, at -V 0, -V 1 and -P 1,
  equal to the device-only encode's, to ``host_encoder.encode`` and to
  ``srla_tpu``'s, with the routing invariant
  ``device_blocks + repaired_blocks + w_overflow_blocks + stolen_blocks``
  == the device-size COMPRESS blocks, and stolen blocks counted in
  ``host_blocks`` too;
- forced splits: the device side held back until the host has taken the
  rest of the group, and the host side held back until the device has
  taken the rest: the same bytes and the same invariant;
- the host's gate: at rates by which its chunk would finish after the
  device's rest it steals nothing, and the device takes the rest in one
  call;
- a device chunk that raises makes the encode raise, its threads stopped;
- ``host_encoder`` with 4 threads against 1 thread and against
  ``srla_tpu`` with ``SRLA_HOST_THREADS=4``;
- the progress meter (once per block, summing to N) and the CLI's
  ``SRLA_HOST_THREADS`` (the host batches' threads, not the hybrid; a
  value that is no whole number refused).

The signal is 4 s of ``signals.make_music`` at -B 1024 (172 blocks of 1024
and a 272-sample tail). The hybrid's chunks are lowered on each instance so
that such a group is split (first chunks 16, largest 32, host chunks 8, a
group split from 24 blocks).
Every comparison is exact (bytes or integers)."""

import threading
import time
from functools import lru_cache

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import srla_tpu  # noqa: E402
from srla_tpu_torch import cli, encoder, host_encoder  # noqa: E402
from srla_tpu_torch.host_encoder import make_parameter  # noqa: E402
from srla_tpu_torch.signals import make_music  # noqa: E402

SECONDS = 4.0
BLOCK = 1024
GROUP = int(SECONDS * 44100) // BLOCK        # the COMPRESS group of 1024
WAIT_S = 120.0                               # a forced split's longest wait


@lru_cache(maxsize=None)
def _music() -> np.ndarray:
    return make_music(SECONDS)


@lru_cache(maxsize=None)
def _reference(V: int, P: int) -> bytes:
    """srla_tpu's exact stream, held equal to the port's host encode."""
    want = srla_tpu.encode(_music(), 16, 44100, max_block=BLOCK,
                           variable_divisions=V, ltp_order=P,
                           backend="exact")
    assert host_encoder.encode(_music(), 16, 44100, max_block=BLOCK,
                               variable_divisions=V, ltp_order=P) == want
    return want


@lru_cache(maxsize=None)
def _device_route(V: int, P: int) -> tuple[int, int]:
    """(the device-size COMPRESS blocks, host_blocks) of the encode with
    every device-size group on the device (no hybrid)."""
    enc = encoder.SRLAEncoder(_param(V, P), "cpu")
    assert enc.encode_whole(_music()) == _reference(V, P)
    s = enc.stats
    assert s["stolen_blocks"] == 0
    return (s["device_blocks"] + s["repaired_blocks"]
            + s["w_overflow_blocks"], s["host_blocks"])


def _param(V: int = 0, P: int = 0):
    return make_parameter(2, 16, 44100, max_block=BLOCK,
                          variable_divisions=V, ltp_order=P)


def _hybrid(workers: int, V: int = 0, P: int = 0, approx: bool = False):
    enc = encoder.SRLAEncoder(_param(V, P), "cpu", approx=approx,
                              host_workers=workers, hybrid=True)
    enc.HYBRID_FIRST_CHUNK = 16
    enc.HYBRID_DEV_CHUNK = 32
    enc.HYBRID_HOST_CHUNK = 8
    enc.HYBRID_MIN_BLOCKS = 24
    return enc


def _routed(enc, V: int, P: int) -> None:
    """The routing invariant, against the device-only encode's."""
    compress, host0 = _device_route(V, P)
    s = enc.stats
    assert (s["device_blocks"] + s["repaired_blocks"] + s["w_overflow_blocks"]
            + s["stolen_blocks"]) == compress
    assert s["host_blocks"] == host0 + s["stolen_blocks"]


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("V,P", [(0, 0), (1, 0), (0, 1)],
                         ids=["V0", "V1", "P1"])
def test_hybrid_bytes_equal_exact(V, P, workers):
    """Any split gives srla_tpu's exact stream; host threads steal."""
    enc = _hybrid(workers, V, P)
    assert enc.encode_whole(_music()) == _reference(V, P)
    _routed(enc, V, P)
    assert enc.stats["stolen_blocks"] > 0
    assert enc.stats["device_blocks"] >= enc.HYBRID_FIRST_CHUNK


def test_hybrid_default_is_device_only():
    """hybrid=False (the default) splits nothing, however large the group
    and however many host threads."""
    enc = encoder.SRLAEncoder(_param(), "cpu", host_workers=3)
    enc.HYBRID_HOST_CHUNK = 1
    enc.HYBRID_MIN_BLOCKS = 1
    assert enc.hybrid is False and enc._host.workers == 3
    assert enc.encode_whole(_music()) == _reference(0, 0)
    assert enc.stats["stolen_blocks"] == 0
    assert enc.stats["host_blocks"] == _device_route(0, 0)[1]


def _wait(cond, what: str) -> None:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > WAIT_S:
            raise AssertionError(f"forced split: {what} never happened")
        time.sleep(0.002)


def test_forced_split_device_held_back():
    """The device's first finish waits until the host has taken every
    block the device has not: the host encodes most of the group."""
    enc = _hybrid(2)
    launched = [0]
    launch, finish = enc._launch_group, enc._finish_group

    def counted_launch(pcm, files, spans, idxs, size, *a):
        if size == BLOCK:
            launched[0] += len(idxs)
        return launch(pcm, files, spans, idxs, size, *a)

    def held_finish(pcm, spans, size, *a):
        if size == BLOCK:
            _wait(lambda: enc.stats["host_blocks"] + launched[0] >= GROUP,
                  "the host taking the rest")
        return finish(pcm, spans, size, *a)

    enc._launch_group, enc._finish_group = counted_launch, held_finish
    assert enc.encode_whole(_music()) == _reference(0, 0)
    _routed(enc, 0, 0)
    assert launched[0] <= 2 * enc.HYBRID_FIRST_CHUNK
    assert enc.stats["stolen_blocks"] == GROUP - launched[0]


def test_forced_split_host_held_back():
    """The host's first chunk waits until the device has taken every
    block the host does not hold: the device encodes most of the group."""
    enc = _hybrid(2)
    host = enc._host
    caller = threading.get_ident()
    launched, held = [0], [0]
    lock = threading.Lock()
    launch, batch = enc._launch_group, host._encode_host_batch

    def counted_launch(pcm, files, spans, idxs, size, *a):
        if size == BLOCK:
            launched[0] += len(idxs)
        return launch(pcm, files, spans, idxs, size, *a)

    def held_batch(pcm, spans, idxs, size, *a):
        if threading.get_ident() != caller:
            with lock:
                held[0] += len(idxs)
            _wait(lambda: launched[0] + held[0] >= GROUP,
                  "the device taking the rest")
        return batch(pcm, spans, idxs, size, *a)

    enc._launch_group, host._encode_host_batch = counted_launch, held_batch
    assert enc.encode_whole(_music()) == _reference(0, 0)
    _routed(enc, 0, 0)
    assert enc.stats["stolen_blocks"] == held[0]
    assert 0 < held[0] <= enc.HYBRID_HOST_CHUNK
    assert launched[0] == GROUP - held[0]


@pytest.mark.parametrize("late", [True, False], ids=["late", "in_time"])
def test_host_gate(late):
    """With rates known (kept from earlier encodes), the host takes a chunk
    only while it would finish it before the device finishes the rest. At
    a device rate 1000 times the host's, it takes none and the device's
    second call takes the whole rest; at a host rate 1000 times the
    device's, it steals."""
    enc = _hybrid(2)
    fast, slow = 1e9, 1e6
    enc._rates.update(dev=fast if late else slow, host=slow if late else fast)
    chunks = []
    launch = enc._launch_group

    def counted_launch(pcm, files, spans, idxs, size, *a):
        if size == BLOCK:
            chunks.append(len(idxs))
        return launch(pcm, files, spans, idxs, size, *a)

    enc._launch_group = counted_launch
    assert enc.encode_whole(_music()) == _reference(0, 0)
    _routed(enc, 0, 0)
    if late:
        assert enc.stats["stolen_blocks"] == 0
        assert chunks == [enc.HYBRID_FIRST_CHUNK,
                          GROUP - enc.HYBRID_FIRST_CHUNK]
    else:
        assert enc.stats["stolen_blocks"] > 0


@pytest.mark.parametrize("call", [1, 2])
def test_failed_device_chunk_raises(call):
    """A device chunk that raises (the first, before any host thread
    starts, or a later one) makes the encode raise; no stream is returned
    and no thread is left running."""
    enc = _hybrid(3)
    launch = enc._launch_group
    calls = [0]

    def failing(pcm, files, spans, idxs, size, *a):
        calls[0] += 1
        if calls[0] == call:
            raise RuntimeError("device chunk failed")
        return launch(pcm, files, spans, idxs, size, *a)

    enc._launch_group = failing
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="device chunk failed"):
        enc.encode_whole(_music())
    assert threading.active_count() == before


def test_approx_hybrid_lossless():
    """Under approx the device's blocks are approximate and the stolen ones
    exact: lossless, within 1.02 of the exact size."""
    from srla_tpu_torch import host_decoder
    enc = _hybrid(2, approx=True)
    data = enc.encode_whole(_music())
    assert enc.stats["stolen_blocks"] > 0
    assert np.array_equal(host_decoder.decode(data)[1], _music())
    assert len(data) <= 1.02 * len(_reference(0, 0))


def test_hybrid_progress_once_per_block():
    """The meter is called in the caller's thread, once per block, and
    reaches N."""
    enc = _hybrid(3)
    seen, threads = [], set()

    def meter(done):
        seen.append(done)
        threads.add(threading.get_ident())

    enc.encode_whole(_music(), progress_callback=meter)
    assert threads == {threading.get_ident()}
    assert len(seen) == GROUP + 1
    assert seen == sorted(seen) and seen[-1] == _music().shape[1]


@pytest.mark.parametrize("V,P", [(0, 0), (1, 0), (0, 1)],
                         ids=["V0", "V1", "P1"])
def test_host_encoder_threads(monkeypatch, V, P):
    """host_encoder at 4 threads: the bytes of 1 thread and of srla_tpu at
    SRLA_HOST_THREADS=4; the same host_blocks; the meter reaches N."""
    pcm = _music()
    one = host_encoder.SRLAEncoder(_param(V, P))
    seen_one, seen = [], []
    want = one.encode_whole(pcm, progress_callback=seen_one.append)
    four = host_encoder.SRLAEncoder(_param(V, P), workers=4)
    assert four.encode_whole(pcm, progress_callback=seen.append) == want
    assert four.stats == one.stats and four.stats["host_blocks"] > 8
    assert seen == sorted(seen) and seen[-1] == seen_one[-1]
    assert host_encoder.encode(pcm, 16, 44100, max_block=BLOCK,
                               variable_divisions=V, ltp_order=P,
                               workers=4) == want
    monkeypatch.setenv("SRLA_HOST_THREADS", "4")
    assert srla_tpu.encode(pcm, 16, 44100, max_block=BLOCK,
                           variable_divisions=V, ltp_order=P,
                           backend="exact") == want


def _wav(tmp_path) -> str:
    from srla_tpu_torch.wavio import WavData, write_wav
    wav = tmp_path / "in.wav"
    write_wav(str(wav), WavData(_music(), 44100, 16))
    return str(wav)


def test_cli_reads_host_threads(tmp_path, monkeypatch):
    """The port's CLI takes SRLA_HOST_THREADS as the host batches' threads,
    as srla_tpu's does, and does not take the hybrid: the same bytes as
    srla_tpu's CLI under the same setting."""
    from srla_tpu import cli as jax_cli
    wav = _wav(tmp_path)
    ref, out = tmp_path / "ref.srl", tmp_path / "out.srl"
    flags = ["-e", "-B", str(BLOCK), "-V", "0"]
    monkeypatch.setenv("SRLA_HOST_THREADS", "2")
    assert jax_cli.main(flags + [wav, str(ref)]) == 0
    workers, hybrids = [], []
    init = host_encoder.SRLAEncoder.__init__

    def spy_init(self, parameter, workers_=1):
        workers.append(workers_)
        init(self, parameter, workers_)

    def spy_hybrid(self, *a):
        hybrids.append(a)
        raise AssertionError("the CLI took the hybrid")

    monkeypatch.setattr(host_encoder.SRLAEncoder, "__init__", spy_init)
    monkeypatch.setattr(encoder.SRLAEncoder, "_encode_group_hybrid",
                        spy_hybrid)
    monkeypatch.setattr(encoder.SRLAEncoder, "HYBRID_MIN_BLOCKS", 1)
    assert cli.main(flags + [wav, str(out), "--device", "cpu"]) == 0
    assert out.read_bytes() == ref.read_bytes()
    assert workers == [2] and hybrids == []


@pytest.mark.parametrize("value", ["four", "-1", "2.5", ""])
def test_cli_refuses_bad_host_threads(tmp_path, monkeypatch, capsys, value):
    """A SRLA_HOST_THREADS that is no whole number is refused with exit code
    2 and a message, before any encode; no output is written."""
    out = tmp_path / "out.srl"
    monkeypatch.setenv("SRLA_HOST_THREADS", value)
    assert cli.main(["-e", _wav(tmp_path), str(out), "--device", "cpu"]) == 2
    assert "SRLA_HOST_THREADS" in capsys.readouterr().err
    assert not out.exists()
