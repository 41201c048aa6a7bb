"""The plain reference decoder against the sources of streams that the
port's exact host encoder wrote (the test may use the port; the reference
may not), and against broken streams."""

import struct

import numpy as np
import pytest

from perfbench import corpus
from perfbench.reference import srla

SEED = 2**31 + 99


def encode(pcm, bps, rate, **kw):
    from srla_tpu_torch import host_encoder
    return host_encoder.encode(pcm, bps, rate, **kw)


def cases():
    cd = dict(preset=4, max_block=4096, variable_divisions=1,
              lookahead_factor=4)
    out = [(corpus.track(c, SEED, 44100, 1.2), 16, 44100, cd)
           for c in corpus.CATEGORIES]
    out.append((corpus.track("jazz", SEED, 96000, 0.5, 24), 24, 96000,
                dict(preset=4, max_block=8192)))
    out.append((corpus.track("classic", SEED, 44100, 0.6) << 3, 16, 44100,
                dict(preset=2, max_block=1024, variable_divisions=2)))
    rng = np.random.default_rng(SEED)
    noise = rng.integers(-32768, 32768, (2, 9000)).astype(np.int32)
    noise[:, 4096:6000] = 0                       # a SILENT stretch
    out.append((noise, 16, 44100, dict(preset=4, max_block=2048)))
    out.append((corpus.track("vocal", SEED, 44100, 0.4)[:1], 16, 44100,
                dict(preset=4, max_block=4096)))
    return out


@pytest.fixture(scope="module")
def streams():
    return [(pcm, encode(pcm, bps, rate, **kw)) for pcm, bps, rate, kw
            in cases()]


def test_every_stream_decodes_to_its_source(streams):
    kinds = set()
    by_shape = {}
    for pcm, s in streams:
        f = srla.read_stream(s)
        assert f.error is None and all(b.checksum_ok for b in f.blocks)
        kinds |= {b.kind for b in f.blocks}
        key = (pcm.shape[0], f.header.bits_per_sample)
        by_shape.setdefault(key, []).append((pcm, s))
    assert kinds == {srla.COMPRESS, srla.SILENT, srla.RAW}
    for group in by_shape.values():
        got = srla.decode_streams([s for _, s in group], "cpu")
        for (pcm, _), d in zip(group, got):
            assert d.error is None
            assert np.array_equal(d.pcm.numpy(), pcm)


def refix(stream: bytes, at: int) -> bytes:
    """The stream with its block around byte ``at`` given a fresh
    checksum."""
    f = srla.read_stream(bytes(stream[:srla.HEADER_SIZE])
                         + bytes(stream[srla.HEADER_SIZE:]))
    b = bytearray(stream)
    off = srla.HEADER_SIZE
    for blk in f.blocks:
        end = blk.payload_offset + blk.payload_size
        if blk.payload_offset <= at < end:
            c = srla._fletcher16(np.frombuffer(bytes(b), np.uint8),
                                 np.array([off + 8]), np.array([end]))[0]
            struct.pack_into(">H", b, off + 6, int(c))
        off = end
    return bytes(b)


def middle_of_compress(stream: bytes) -> int:
    f = srla.read_stream(stream)
    blk = [b for b in f.blocks if b.kind == srla.COMPRESS][1]
    return blk.payload_offset + blk.payload_size // 2


@pytest.mark.parametrize("fault", ["flip", "flip_refixed", "cut", "tail",
                                   "header"])
def test_a_broken_stream_fails(streams, fault):
    pcm, s = streams[0]
    at = middle_of_compress(s)
    b = bytearray(s)
    if fault.startswith("flip"):
        b[at] ^= 0x10
        if fault == "flip_refixed":
            b = bytearray(refix(bytes(b), at))
    elif fault == "cut":
        b = b[:len(b) - 100]
    elif fault == "tail":
        b += b"\0"
    else:
        struct.pack_into(">I", b, 14, pcm.shape[1] - 1)
    d = srla.decode_streams([bytes(b)], "cpu")[0]
    bad = d.error is not None or not np.array_equal(d.pcm.numpy(), pcm)
    assert bad


def test_block_table(streams):
    pcm, s = streams[0]
    f = srla.read_stream(s)
    table = srla.block_table([s], "cpu")[0]
    comp = [b for b in f.blocks if b.kind == srla.COMPRESS]
    assert [(t[0], t[1]) for t in table] == [(b.num_samples, b.payload_size)
                                             for b in comp]
    assert all(0 <= o <= 64 for t in table for o in t[2])
    assert {t[3] for t in table} <= {0, 1, 2, 3}


@pytest.mark.parametrize("case", range(9))
def test_size_reference_gives_each_stream_its_length(streams, case):
    """The plain size reference against the port's exact host encoder: -V
    1 and 2, presets 2 and 4, blocks of 1024-8192, stereo and mono, an
    offset shift, RAW and SILENT blocks, odd-length tails."""
    from perfbench.harness import SIZE_GAP_LIMIT_PCT
    from perfbench.reference import sizes
    (pcm, bps, rate, kw), (_, s) = cases()[case], streams[case]
    kw = {"variable_divisions": 0, "lookahead_factor": 4, **kw}
    ref = sizes.stream_size(pcm, bps, kw["preset"], kw["max_block"],
                            kw["variable_divisions"], kw["lookahead_factor"])
    assert 100.0 * abs(len(s) - ref) / ref <= SIZE_GAP_LIMIT_PCT / 10
