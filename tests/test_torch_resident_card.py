"""The decode to device-resident PCM on the card (``-m gpu``; they skip
without one): K13 (``kernels.verify``) against its plain version, and
``SRLADecoder.decode_whole_device_resident`` on streams with COMPRESS, RAW
and SILENT blocks, whole and over two shards, clean and corrupted. No JAX
here: ``test_torch_resident.py`` holds the same cases on the CPU to
``srla_tpu`` and imports its inputs from this file.

Every compared value is a flag: tolerance 0."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import signals  # noqa: E402
from srla_tpu_torch import SRLADecoder  # noqa: E402
from srla_tpu_torch.constants import HEADER_SIZE, BlockDataType  # noqa: E402
from srla_tpu_torch.format import decode_header, parse_block_header  # noqa: E402
from srla_tpu_torch.host_encoder import encode  # noqa: E402
from srla_tpu_torch.kernels import verify  # noqa: E402
from srla_tpu_torch.signals import make_music, make_segmented  # noqa: E402

BLOCK = 512
RATE = 44100
STARTS = ["consecutive", "shuffled", "unaligned", "clamped"]
BLOCK_TYPES = (BlockDataType.COMPRESS, BlockDataType.RAW,
               BlockDataType.SILENT)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def verify_case(C: int, kind: str, seed: int):
    """(out, expected, starts, okrows, n, B): out holds each block's span of
    expected (clamped as the JAX gather clamps), two rows past B are
    padding, and rows 1 and B - 2 are not ok."""
    rng = np.random.RandomState(seed)
    n, B = 96, 7
    N = n * B + (37 if kind == "unaligned" else 0)
    expected = rng.randint(-2 ** 31, 2 ** 31, (C, N), dtype=np.int64).astype(
        np.int32)
    if kind == "consecutive":
        starts = np.arange(B) * n
    elif kind == "shuffled":
        starts = rng.permutation(B) * n
    elif kind == "unaligned":              # after odd-length blocks
        starts = np.sort(rng.choice(N - n, B, replace=False)) | 1
    else:                                  # past N - n, and negative
        starts = np.arange(B) * n
        starts[2], starts[4] = N - n // 3, -5
    starts = np.concatenate([starts, [0, N]]).astype(np.int32)
    s = np.clip(starts, 0, N - n)
    out = np.stack([expected[:, k:k + n] for k in s]).astype(np.int32)
    out[B:] = 12345                        # padding rows never count
    okrows = np.ones(B + 2, bool)
    okrows[[1, B - 2]] = False
    return out, expected, starts, okrows, n, B


def flipped(out, row, C, n):
    """out with one sample of ``row`` flipped (row None: unchanged)."""
    bad = out.copy()
    if row is not None:
        bad[row, C - 1, n // 2] ^= 1
    return bad


def _with_silent_and_raw(pcm: np.ndarray, bps: int, at: int) -> np.ndarray:
    """pcm with a silent stretch and a full-scale noise stretch (a RAW
    block), 2 * BLOCK samples each, from sample ``at``."""
    pcm = pcm.copy()
    C = pcm.shape[0]
    pcm[:, at:at + 2 * BLOCK] = 0
    noise = np.random.RandomState(at).randint(
        -2 ** (bps - 1), 2 ** (bps - 1), (C, 2 * BLOCK))
    pcm[:, at + 4 * BLOCK:at + 6 * BLOCK] = noise
    return pcm.astype(np.int32)


def stream(kind: str):
    """(pcm, stream) per kind, from the port's host encoder (the bytes of
    srla_tpu.encode): each holds COMPRESS, RAW and SILENT blocks."""
    # An odd length: channels past the first start off 16 bytes.
    n = BLOCK * 12 + 101
    music = make_music(n / RATE + 0.01)[:, :n].astype(np.int32)
    kw, bps = dict(max_block=BLOCK), 16
    if kind == "m4":
        pcm = music
    elif kind == "P3":
        pcm = signals.pitchy(n, 2, 16)
        kw["ltp_order"] = 3
    elif kind == "m6":
        pcm = music
        kw["preset"] = 6
    elif kind == "V3":
        n = 6000
        pcm = make_segmented(n / RATE + 0.01)[:, :n].astype(np.int32)
        kw.update(max_block=1024, variable_divisions=3)
    elif kind == "24bit":
        pcm, bps = music << 8, 24
    elif kind == "mono":
        pcm = music[:1]
    elif kind == "C3":
        pcm = np.concatenate([music, (music[:1] + music[1:]) // 3])
    else:
        raise ValueError(kind)
    pcm = _with_silent_and_raw(pcm, bps, 2 * BLOCK)
    return pcm, encode(pcm, bps, RATE, **kw)


def blocks(data: bytes) -> list[tuple[int, int, int]]:
    """(block type, first sample, samples) of each block."""
    header = decode_header(data)
    out, offset, progress = [], HEADER_SIZE, 0
    while progress < header.num_samples:
        btype, nsamples, poff, psize = parse_block_header(data, offset)
        out.append((btype, progress, nsamples))
        offset, progress = poff + psize, progress + nsamples
    return out


def corrupt(pcm, blks, btype):
    """pcm with one sample flipped in the middle of the first block of
    ``btype`` (its last channel)."""
    _, s, ln = next(b for b in blks if b[0] == btype)
    bad = pcm.copy()
    bad[-1, s + ln // 2] ^= 1
    return bad


def port(data, pcm, device="cpu", devices=None):
    """The port's (lossless, stats), expected on ``device``."""
    dec = SRLADecoder(device, devices=devices)
    return dec.decode_whole_device_resident(
        data, (torch.from_numpy(pcm).to(device), pcm))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", STARTS)
@pytest.mark.parametrize("C", [1, 2, 3])
def test_verify_on_card(cuda, C, kind):
    out, expected, starts, okrows, n, B = verify_case(C, kind, 3 * C)
    for row in (None, 0, 1, B - 1, B):
        args = [torch.from_numpy(a) for a in
                (flipped(out, row, C, n), expected, starts, okrows)]
        want = verify.verify_blocks_plain(*args, n=n, B=B)
        before = verify.verify_blocks.launches
        got = verify.verify_blocks(*[a.to(cuda) for a in args], n=n, B=B)
        assert verify.verify_blocks.launches == before + 1
        assert got.device.type == "cuda" and bool(got) == bool(want), row


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["m4", "P3", "V3", "C3"])
def test_resident_decode_on_card(cuda, kind):
    pcm, data = stream(kind)
    blks = blocks(data)
    for devices in (None, [cuda, cuda]):
        before = verify.verify_blocks.launches
        ok, stats = port(data, pcm, cuda, devices)
        assert ok is True and stats["host_blocks"] == 0
        assert verify.verify_blocks.launches > before
        for btype in BLOCK_TYPES:
            assert port(data, corrupt(pcm, blks, btype), cuda,
                        devices)[0] is False
