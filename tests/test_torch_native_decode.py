"""The port's host decode, ``host_decoder.decode`` (the native library's
whole-stream decode, else a walk over the blocks with the one-block
reference) and ``host_decoder.decode_block``, against ``srla_tpu.decode``
(its native decode) and the source PCM, on the CPU in one process with
JAX:

- streams at -V 0, -V 1 and -P 3, -m 0 mono, 24-bit, and one with RAW and
  SILENT blocks: the same PCM as ``srla_tpu.decode`` and the source, each
  COMPRESS block by ``decode_block`` as by ``srla_tpu``'s native one;
- corruptions, each against ``srla_tpu``: a flipped payload byte raises
  (a checksum mismatch), a flipped checksum does not with
  ``check_checksum=False``; a stream cut at a block boundary decodes with a
  silent tail; a stream cut inside a block raises;
- the same without the native library (``native_decoder.available``
  patched to False): the block walk gives the same PCM and the same
  errors.

Every comparison is exact."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("torch")

import signals  # noqa: E402
import srla_tpu  # noqa: E402
from srla_tpu import native_decoder as jax_native  # noqa: E402
from srla_tpu_torch import host_decoder, host_encoder  # noqa: E402
from srla_tpu_torch import native_decoder  # noqa: E402
from srla_tpu_torch.constants import HEADER_SIZE, BlockDataType  # noqa: E402
from srla_tpu_torch.format import (decode_header,  # noqa: E402
                                   parse_block_header)
from srla_tpu_torch.signals import make_music  # noqa: E402

SAMPLES = 22050                  # 0.5 s at 44.1 kHz: 21 blocks of 1024
BLOCK = 1024


def _mono24() -> np.ndarray:
    return make_music(SAMPLES / 44100)[:1] << 8


def _gaps() -> np.ndarray:
    """A SILENT block and a white-noise block (emitted RAW)."""
    pcm = make_music(SAMPLES / 44100)
    pcm[:, BLOCK:2 * BLOCK] = 0
    pcm[:, 3 * BLOCK:4 * BLOCK] = signals.white_noise(BLOCK, 2, 16, seed=3)
    return pcm


# (name, pcm maker, bits, encode flags)
CASES = {
    "V0": (lambda: make_music(SAMPLES / 44100), 16, {}),
    "V1": (lambda: make_music(SAMPLES / 44100), 16,
           {"variable_divisions": 1}),
    "P3": (lambda: make_music(SAMPLES / 44100), 16, {"ltp_order": 3}),
    "m0_mono_24bit": (_mono24, 24, {"preset": 0}),
    "raw_silent": (_gaps, 16, {}),
}


def _stream(name: str):
    make, bps, flags = CASES[name]
    pcm = make()
    return pcm, host_encoder.encode(pcm, bps, 44100, max_block=BLOCK,
                                    **flags)


def _blocks(data: bytes) -> list:
    """(offset, type, samples, payload offset, payload size) of each
    block."""
    out, off = [], HEADER_SIZE
    while off < len(data):
        btype, n, poff, psize = parse_block_header(data, off)
        out.append((off, btype, n, poff, psize))
        off = poff + psize
    return out


@pytest.fixture(params=[True, False], ids=["native", "walk"])
def native(request, monkeypatch):
    """Whether the port's native library is used; without it the decode
    walks the blocks with the Python reference."""
    if not request.param:
        monkeypatch.setattr(native_decoder, "available", lambda: False)
    else:
        assert native_decoder.available()
    return request.param


@pytest.mark.parametrize("name", list(CASES))
def test_decode_equals_srla_tpu(name, native):
    pcm, data = _stream(name)
    header, got = host_decoder.decode(data)
    jax_header, want = srla_tpu.decode(data)
    assert got.dtype == np.int32 and got.shape == pcm.shape
    assert np.array_equal(got, want) and np.array_equal(got, pcm)
    assert header == decode_header(data)
    assert header.num_samples == jax_header.num_samples
    kinds = {b[1] for b in _blocks(data)}
    if name == "raw_silent":
        assert {BlockDataType.RAW, BlockDataType.SILENT} <= kinds


@pytest.mark.parametrize("name", ["V1", "P3", "m0_mono_24bit"])
def test_decode_block_equals_srla_tpu(name, native):
    """Each COMPRESS block alone: srla_tpu's native decode_block."""
    pcm, data = _stream(name)
    header = decode_header(data)
    start = 0
    for _off, btype, n, poff, psize in _blocks(data):
        if btype == BlockDataType.COMPRESS:
            payload = data[poff:poff + psize]
            got = host_decoder.decode_block(payload, header, n)
            want = jax_native.decode_block(
                payload, header.num_channels, header.bits_per_sample, n,
                header.offset_lshift)
            assert np.array_equal(got, want)
            assert np.array_equal(got, pcm[:, start:start + n])
        start += n


def _flip(data: bytes, at: int) -> bytes:
    out = bytearray(data)
    out[at] ^= 0x5A
    return bytes(out)


def _raises(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_flipped_byte(native):
    """A flipped payload byte is a checksum mismatch; a flipped checksum
    decodes cleanly when the checksum is not checked."""
    pcm, data = _stream("V0")
    blocks = _blocks(data)
    off, _t, _n, poff, psize = blocks[len(blocks) // 2]
    bad = _flip(data, poff + psize // 2)
    msg = _raises(lambda: host_decoder.decode(bad))
    assert "checksum" in msg
    assert "checksum" in _raises(lambda: srla_tpu.decode(bad))
    bad_sum = _flip(data, off + 6)
    assert "checksum" in _raises(lambda: host_decoder.decode(bad_sum))
    _, got = host_decoder.decode(bad_sum, check_checksum=False)
    _, want = srla_tpu.decode(bad_sum, check_checksum=False)
    assert np.array_equal(got, want) and np.array_equal(got, pcm)


def test_cut_at_block_boundary(native):
    """A stream cut cleanly after a block decodes what it holds and leaves
    the rest silent."""
    pcm, data = _stream("raw_silent")
    blocks = _blocks(data)
    k = len(blocks) // 2
    cut = data[:blocks[k][0]]
    done = sum(b[2] for b in blocks[:k])
    _, got = host_decoder.decode(cut)
    _, want = srla_tpu.decode(cut)
    assert np.array_equal(got, want)
    assert np.array_equal(got[:, :done], pcm[:, :done])
    assert not got[:, done:].any()


def test_cut_inside_block(native):
    """A stream cut inside a block raises."""
    _pcm, data = _stream("P3")
    blocks = _blocks(data)
    off, _t, _n, poff, psize = blocks[len(blocks) // 2]
    cut = data[:poff + psize // 2]
    _raises(lambda: host_decoder.decode(cut))
    _raises(lambda: srla_tpu.decode(cut))
