"""K2 (srla_tpu_torch.kernels.rice_decode) against its JAX twin, the
decode2 word machine (_assemble(*_entropy_scan(_stage_from_flat(...)))),
and against the host oracle rice.decode, on block groups of real encoded
streams.

Every output is an integer, so every comparison is exact (tolerance 0). The
JAX side runs at one fixed shape per channel count (stream, window and row
count padded), so this file compiles it twice."""

from functools import partial

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from srla_tpu import encode, rice  # noqa: E402
from srla_tpu.bitio import BitReader  # noqa: E402
from srla_tpu.kernels.decode2 import (_assemble, _entropy_scan,  # noqa: E402
                                      _stage_from_flat)
from srla_tpu_torch.decoder import SRLADecoder, upload_stream  # noqa: E402
from srla_tpu_torch.kernels.rice_decode import (  # noqa: E402
    rice_decode, rice_decode_plain)

N = 512              # block size of every stream here
ROWS = 8             # blocks decoded per case (JAX rows)
JAX_W = 1024         # JAX window in words (>= every payload here)
JAX_FLAT = 16384     # JAX stream length in words (>= every stream here)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _signal(kind: str) -> tuple[np.ndarray, int]:
    """(pcm, preset) for each stream shape the cases cover (16-bit unless
    ``_BITS`` says otherwise)."""
    rng = np.random.RandomState(sum(map(ord, kind)))
    n = N * ROWS
    t = np.arange(n)
    tone = np.sin(t / 13.0) * 8000 + rng.randn(n) * 300
    if kind == "recursive":                # loud content: recursive Rice
        return (rng.randn(2, n) * 3000).astype(np.int32), 4
    if kind == "plain":                    # residual means < 2: plain Rice
        return (rng.randn(2, n) * 0.7).astype(np.int32), 4
    if kind == "allzero_right":            # channel 1 is ALLZERO
        return np.stack([tone, np.zeros(n)]).astype(np.int32), 4
    if kind == "allzero_left":             # channel 0 ALLZERO, 1 coded
        return np.stack([np.zeros(n), rng.randn(n) * 2000]).astype(
            np.int32), 4
    if kind == "partitions":               # bursts: partition order >= 6
        gain = np.where((t // 32) % 2, 5, 5000)
        return (rng.randn(2, n) * gain).astype(np.int32), 4
    if kind == "outliers":                 # multi-thousand-bit unary runs
        sig = (rng.randn(2, n) * 2).round().astype(np.int32)
        sig[0, 1000] = 30000
        sig[1, 3000] = -30000
        return sig, 0
    if kind == "mono":
        return (tone[None] * 0.5).astype(np.int32), 4
    if kind == "wide":                     # 24-bit noise: Rice k >= 20
        return (rng.randn(2, n) * 2e6).astype(np.int32), 4
    raise ValueError(kind)


_BITS = {"wide": 24}


CASES = ["recursive", "plain", "allzero_right", "allzero_left",
         "partitions", "outliers", "mono", "wide"]


def _group(kind: str):
    """Encoded stream and its first group of ROWS blocks of N samples."""
    pcm, preset = _signal(kind)
    data = encode(pcm, _BITS.get(kind, 16), 44100, preset=preset,
                  max_block=N)
    _, _, groups = SRLADecoder("cpu").plan(data)
    g = groups[0]
    assert g.n == N and len(g.starts) == ROWS
    return data, pcm.shape[0], g


def _sections(data: bytes, g, C: int) -> list:
    """(code type, partition order, first Rice parameter) of every channel
    section in the group, read with the host reader (-1 where ALLZERO has
    no such field)."""
    out = []
    for row in g.meta:
        r = BitReader(data)
        r.pos = int(row[0]) * 32 + int(row[1])
        for _ in range(C):
            p0 = r.pos
            ctype = r.get(2)
            porder = r.get(10) if ctype != 2 else -1
            out.append((ctype, porder, r.get(5) if ctype != 2 else -1))
            r.pos = p0
            rice.decode(r, N)
    return out


def _code_types(data: bytes, g, C: int) -> set:
    """(code type, partition order) of every channel section in the group."""
    return {(ct, po) for ct, po, _ in _sections(data, g, C)}


@partial(jax.jit, static_argnames=("n", "C", "W"))
def _jax_residuals(flat, word_start, bit_rem, *, n, C, W):
    sw = _stage_from_flat(flat, word_start, bit_rem, W)
    return _assemble(*_entropy_scan(sw.T, n, C), n, C)


def _plain(data, g, C, device="cpu"):
    ws = torch.from_numpy(g.meta[:, 0].copy()).to(device)
    br = torch.from_numpy(g.meta[:, 1].copy()).to(device)
    return (upload_stream(data, device), ws, br, N, C, g.W)


@pytest.mark.parametrize("kind", CASES)
def test_plain_matches_word_machine_and_host(kind):
    data, C, g = _group(kind)
    got = rice_decode_plain(*_plain(data, g, C)).numpy()

    flat = np.zeros(JAX_FLAT, np.uint32)
    flat.view(np.uint8)[:len(data)] = np.frombuffer(data, np.uint8)
    want = np.asarray(_jax_residuals(
        jnp.asarray(flat), jnp.asarray(g.meta[:, 0]),
        jnp.asarray(g.meta[:, 1]), n=N, C=C, W=JAX_W))
    np.testing.assert_array_equal(got, want)

    for b, row in enumerate(g.meta):
        r = BitReader(data)
        r.pos = int(row[0]) * 32 + int(row[1])
        host = np.stack([rice.decode(r, N) for _ in range(C)])
        np.testing.assert_array_equal(got[b], host)


def test_cases_cover_every_code_path():
    """The streams above reach plain and recursive Rice, ALLZERO channels
    in both positions, and partition orders of 6 and more."""
    seen = {}
    for kind in ("recursive", "plain", "allzero_left", "partitions"):
        data, C, g = _group(kind)
        seen[kind] = _code_types(data, g, C)
    assert any(ct == 1 for ct, _ in seen["recursive"])
    assert any(ct == 0 for ct, _ in seen["plain"])
    assert any(ct == 2 for ct, _ in seen["allzero_left"])
    assert max(po for _, po in seen["partitions"]) >= 6


def test_wide_case_reaches_rice_parameter_20():
    """The 24-bit case codes with Rice parameters of 20 and more, so tails
    of 20+ bits straddle words."""
    data, C, g = _group("wide")
    assert max(k for _, _, k in _sections(data, g, C)) >= 20


def _k31_stream(B: int, C: int, n: int, seed: int):
    """Hand-built recursive-Rice sections at the format's edges: partition
    order field 1023 (clipped to 31, so every sample is its own partition
    and a k delta precedes each after the first), first k 31, deltas that
    push k past 31 and back, quotients 0..3 (tails of 32 bits at q == 0).
    Returns (words, word_start, bit_rem, W, residuals (B, C, n) int32)."""
    rng = np.random.RandomState(seed)
    bits, starts = [], []
    want = np.zeros((B, C, n), np.int64)

    def put(v, width):
        bits.extend((v >> (width - 1 - i)) & 1 for i in range(width))

    for b in range(B):
        put(0, int(rng.randint(0, 9)))           # the block's bit offset
        starts.append(len(bits))
        for c in range(C):
            put(1, 2)                            # recursive Rice
            put(1023, 10)
            k = 31
            put(k, 5)
            for i in range(n):
                if i:                            # zigzag delta before it
                    dq = int(rng.choice([0, 0, 1, 2]))
                    put(1, dq + 1)
                    dz = (dq >> 1) ^ -(dq & 1)
                    k = min(max(k + dz, 0), 31)
                q = int(rng.randint(0, 4))
                put(1, q + 1)
                tw = k + 1 if q == 0 else k
                tail = int(rng.randint(0, 1 << tw, dtype=np.uint64))
                put(tail, tw)
                u = (tail | ((q + (q > 0)) << k)) & 0xFFFFFFFF
                want[b, c, i] = (u >> 1) ^ -(u & 1)
    put(0, (-len(bits)) % 32 + 64)
    raw = np.packbits(np.asarray(bits, np.uint8)).tobytes()
    words = np.frombuffer(raw, "<i4").copy()
    ws = np.asarray([p >> 5 for p in starts], np.int32)
    br = np.asarray([p & 31 for p in starts], np.int32)
    return words, ws, br, len(words), want.astype(np.int32)


def test_plain_decodes_k31_recursive_porder31():
    words, ws, br, W, want = _k31_stream(B=3, C=2, n=40, seed=13)
    got = rice_decode_plain(*(torch.from_numpy(a) for a in (words, ws, br)),
                            40, 2, W)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_runs_plain_on_cpu_tensors():
    data, C, g = _group("recursive")
    before = rice_decode.launches
    args = _plain(data, g, C)
    assert torch.equal(rice_decode(*args), rice_decode_plain(*args))
    assert rice_decode.launches == before


def test_truncated_window_stops_the_block():
    """A window too short for the payload stops each block where its unary
    run leaves the window: the samples decoded before stay exact, the rest
    are 0, and the loop ends."""
    data, C, g = _group("recursive")
    words, ws, br, n, C, W = _plain(data, g, C)
    full = rice_decode_plain(words, ws, br, n, C, W).reshape(ROWS, -1)
    cut = rice_decode_plain(words, ws, br, n, C, W // 2).reshape(ROWS, -1)
    for b in range(ROWS):
        decoded = int((cut[b] != 0).nonzero().max()) + 1
        assert decoded < C * n
        assert torch.equal(cut[b, :decoded], full[b, :decoded])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", CASES)
def test_kernel_matches_plain_on_card(cuda, kind):
    data, C, g = _group(kind)
    args = _plain(data, g, C, device=cuda)
    before = rice_decode.launches
    got = rice_decode(*args)
    want = rice_decode_plain(*args)
    torch.cuda.synchronize()
    assert rice_decode.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernel_truncated_window_matches_plain_on_card(cuda):
    data, C, g = _group("outliers")
    words, ws, br, n, C, W = _plain(data, g, C, device=cuda)
    for w in (1, W // 3, W // 2):
        assert torch.equal(rice_decode(words, ws, br, n, C, w),
                           rice_decode_plain(words, ws, br, n, C, w))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(4))
def test_kernel_matches_plain_on_corrupt_payloads_on_card(cuda, seed):
    """Bit flips in the payloads (as a checksum collision would let through)
    decode to the same garbage on both sides, within the window bound."""
    kind = ("recursive", "partitions", "outliers", "mono")[seed]
    data, C, g = _group(kind)
    rng = np.random.RandomState(seed)
    raw = bytearray(data)
    for pos in rng.randint(100, len(raw), 40):
        raw[pos] ^= 1 << rng.randint(8)
    args = _plain(bytes(raw), g, C, device=cuda)
    assert torch.equal(rice_decode(*args), rice_decode_plain(*args))


@pytest.mark.gpu
def test_kernel_matches_plain_k31_recursive_porder31_on_card(cuda):
    words, ws, br, W, want = _k31_stream(B=9, C=2, n=100, seed=14)
    args = [torch.from_numpy(a).to(cuda) for a in (words, ws, br)]
    got = rice_decode(*args, 100, 2, W)
    torch.cuda.synchronize()
    assert torch.equal(got, rice_decode_plain(*args, 100, 2, W))
    assert torch.equal(got.cpu(), torch.from_numpy(want))


@pytest.mark.gpu
def test_kernel_matches_plain_past_the_ring_on_card(cuda):
    """24-bit noise in 8192-sample blocks: each payload (about 11.8k words)
    streams through the kernel's 1024-word shared-memory ring."""
    rng = np.random.RandomState(15)
    pcm = (rng.randn(2, 8192 * 2) * 2e6).astype(np.int32)
    data = encode(pcm, 24, 44100, preset=4, max_block=8192)
    _, _, groups = SRLADecoder("cpu").plan(data)
    g = groups[0]
    assert g.W > 1024
    ws = torch.from_numpy(g.meta[:, 0].copy()).to(cuda)
    br = torch.from_numpy(g.meta[:, 1].copy()).to(cuda)
    args = (upload_stream(data, cuda), ws, br, g.n, 2, g.W)
    got = rice_decode(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, rice_decode_plain(*args))
