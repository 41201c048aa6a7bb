"""The port's variable block-size encode (-V > 0) against srla_tpu's, on the
CPU (kernels' plain versions) in one process with JAX:

- ``_dijkstra`` against ``srla_tpu.encoder._dijkstra`` on seeded cost
  matrices full of ties, and on the known paths of test_units.py;
- ``host_encoder.encode`` and ``SRLAEncoder(device="cpu")`` byte-equal to
  ``srla_tpu.encode(..., variable_divisions=V, backend="exact")`` over -V
  1..3, -B 1024/4096, -L 2/4, mono and stereo, 8/16/24 bit, an odd-length
  last window, the segmented signal and a silent stretch;
- ``kernels.exact.measure_spans`` against ``measure_spans_exact`` on JAX-CPU
  (two shapes: n 1024 and 1536) and against the host's measure-only bits;
- the block-level API, the CLI at its default flags, the span accounting,
  the measurement's call cap, the step breakdown and the progress meter.

The ``gpu`` cases run the same encodes on the card, and K3, K4 and K5
against their plain versions at the lengths -V gives them. Every comparison
is exact (bytes or integers)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import srla_tpu  # noqa: E402
from srla_tpu import encoder as jax_encoder  # noqa: E402
from srla_tpu.kernels.exact import measure_spans_exact  # noqa: E402
from srla_tpu_torch import decode, encoder, host_encoder  # noqa: E402
from srla_tpu_torch.constants import (HEADER_SIZE,  # noqa: E402
                                      PARAMETER_PRESETS, BlockDataType)
from srla_tpu_torch.format import (decode_header,  # noqa: E402
                                   parse_block_header)
from srla_tpu_torch.kernels import exact as texact  # noqa: E402
from srla_tpu_torch.signals import make_music, make_segmented  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these encodes are many small CPU torch ops,
    which run faster on one thread than on a pool that the test workers'
    pools contend with."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _signal(kind: str, C: int, bps: int, N: int) -> np.ndarray:
    """``kind``: music, segmented, or silent (music with a zero stretch
    across a window boundary); scaled from 16 bits to ``bps``."""
    seconds = N / 44100 + 0.01
    pcm = (make_segmented(seconds) if kind == "segmented"
           else make_music(seconds))[:C, :N].astype(np.int32)
    if kind == "silent":
        pcm[:, N // 3:N // 3 + 5000] = 0
    shift = bps - 16
    return pcm << shift if shift >= 0 else pcm >> -shift


def _param(C, bps, V, B, L, preset=4):
    return host_encoder.make_parameter(C, bps, 44100, preset, B, V, L)


def _sizes(data: bytes) -> list[tuple[int, int]]:
    """(block type, samples) of each block of a stream."""
    header = decode_header(data)
    out, offset, progress = [], HEADER_SIZE, 0
    while progress < header.num_samples:
        btype, nsamples, poff, psize = parse_block_header(data, offset)
        out.append((btype, nsamples))
        offset, progress = poff + psize, progress + nsamples
    return out


def _candidates(pcm, param):
    """Every candidate span of every lookahead window that the search
    measures by analysis (typed COMPRESS): (even-window spans, odd-window
    spans), counted independently of the encoders."""
    C, N = pcm.shape
    dmin = param.min_num_samples_per_block
    dmax = param.max_num_samples_per_block
    limit = PARAMETER_PRESETS[param.preset].max_num_parameters
    even = odd = 0
    for wo in range(0, N, param.num_lookahead_samples):
        span = min(param.num_lookahead_samples, N - wo)
        nodes = (span + dmin - 1) // dmin + 1
        for i in range(nodes):
            for j in range(i + 1, nodes):
                if (j - i) * dmin > dmax:
                    continue
                size = min((j - i) * dmin, span - i * dmin)
                off = wo + i * dmin
                if size > limit and pcm[:, off:off + size].any():
                    even += span % 2 == 0
                    odd += span % 2 == 1
    return even, odd


# ---------------------------------------------------------------------------
# Dijkstra
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_dijkstra_matches_srla_tpu(seed):
    """Upper-triangular costs like the search's (edges up to a span, BIG
    elsewhere) drawn from a few values, so that equal-cost paths abound;
    odd seeds also give backward and self edges."""
    rng = np.random.RandomState(seed)
    big = float(1 << 24)
    nodes = rng.randint(2, 34)
    adj = np.full((nodes, nodes), big)
    reach = rng.randint(1, 9)
    for i in range(nodes):
        for j in range(i + 1, min(nodes, i + reach + 1)):
            adj[i, j] = float(11 + rng.randint(0, 4) * (j - i))
    if seed % 2:
        mask = rng.rand(nodes, nodes) < 0.2
        adj[mask] = rng.randint(0, 5, mask.sum()).astype(float)
    want = jax_encoder._dijkstra(adj, nodes, 0, nodes - 1, big)
    assert host_encoder._dijkstra(adj, nodes, 0, nodes - 1, big) == want


def test_dijkstra_known_paths():
    """test_units.py's hand-built cases, on the port's copy."""
    big = 1e30
    adj = np.full((4, 4), big)
    adj[0, 1], adj[0, 2], adj[1, 2], adj[1, 3], adj[2, 3] = 1, 4, 2, 6, 3
    path = host_encoder._dijkstra(adj, 4, 0, 3, big)
    assert path[3] == 2 and path[2] == 1 and path[1] == 0
    adj = np.full((3, 3), big)
    adj[0, 1] = adj[1, 2] = 5.0
    path = host_encoder._dijkstra(adj, 3, 0, 2, big)
    assert path[2] == 1 and path[1] == 0


# ---------------------------------------------------------------------------
# Whole encodes
# ---------------------------------------------------------------------------

CASES = {
    # id: (kind, C, bps, V, B, L, N)
    "v1-b4096-l4-stereo16": ("music", 2, 16, 1, 4096, 4, 16384 + 9192),
    "v2-b1024-l2-mono16": ("music", 1, 16, 2, 1024, 2, 9000),
    "v3-b1024-l4-segmented": ("segmented", 2, 16, 3, 1024, 4, 12000),
    "v1-b1024-l4-stereo8": ("segmented", 2, 8, 1, 1024, 4, 10000),
    "v2-b1024-l4-stereo24": ("music", 2, 24, 2, 1024, 4, 9000),
    "v1-b1024-l2-odd-n": ("music", 2, 16, 1, 1024, 2, 10001),
    "v3-b1024-l2-odd-n-mono": ("segmented", 1, 16, 3, 1024, 2, 6001),
    "v2-b1024-l2-silent": ("silent", 2, 16, 2, 1024, 2, 12000),
    "v3-b4096-l2-mono16": ("segmented", 1, 16, 3, 4096, 2, 8192 + 3000),
}


@pytest.mark.parametrize("case", list(CASES))
def test_variable_encode_bytes_equal_srla_tpu(case):
    kind, C, bps, V, B, L, N = CASES[case]
    pcm = _signal(kind, C, bps, N)
    want = srla_tpu.encode(pcm, bps, 44100, max_block=B, variable_divisions=V,
                           lookahead_factor=L, backend="exact")
    assert host_encoder.encode(pcm, bps, 44100, max_block=B,
                               variable_divisions=V,
                               lookahead_factor=L) == want
    enc = encoder.SRLAEncoder(_param(C, bps, V, B, L), "cpu")
    assert enc.encode_whole(pcm) == want
    s = enc.stats
    even, odd = _candidates(pcm, enc.p)
    assert s["device_spans"] + s["remeasured_spans"] == even
    assert s["host_spans"] == odd
    assert (odd > 0) == (N % (L * B) % 2 == 1)
    assert s["repaired_blocks"] == s["w_overflow_blocks"] == 0
    assert s["host_blocks"] == 0
    if kind == "silent":
        assert any(t == BlockDataType.SILENT for t, _ in _sizes(want))
    _, out = decode(want, device="cpu")
    np.testing.assert_array_equal(out, pcm)


def test_module_encode_and_segmented_partitions():
    """The port's ``encode`` at -V 3 on the segmented signal: the bytes of
    srla_tpu, with mixed block sizes, some no power of two."""
    pcm = _signal("segmented", 2, 16, 30000)
    want = srla_tpu.encode(pcm, 16, 44100, variable_divisions=3,
                           backend="exact")
    assert encoder.encode(pcm, 16, 44100, "cpu", variable_divisions=3) == want
    sizes = {n for _, n in _sizes(want)[:-1]}     # all but the clipped tail
    assert len(sizes) >= 3
    assert any(n & (n - 1) for n in sizes)


# ---------------------------------------------------------------------------
# Span measurement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1024, 1536])
def test_measure_spans_matches_jax_and_host(n):
    """measure_spans (the port) and measure_spans_exact (JAX-CPU) on the
    same resident file and offsets: equal per-variant section bits, orders,
    coefficients and flags; the rounded block bits equal the host's
    measure-only bits on every unflagged span."""
    C, bps, B = 2, 16, 8
    pcm = _signal("segmented", C, bps, 24000)
    offs = (np.arange(B) * 2560 + 512 * (np.arange(B) % 3)).astype(np.int32)
    param = _param(C, bps, 3, 4096, 4)
    host = host_encoder.SRLAEncoder(param)
    args = host._device_args(n)
    js = jax.device_get(measure_spans_exact(
        pcm.astype(np.int16), offs, np.int32(0), C=C, **args))
    ps = texact.measure_spans(torch.from_numpy(pcm.astype(np.int16)), offs,
                              0, C=C, **args)
    ps = {k: v.numpy() for k, v in ps.items()}
    np.testing.assert_array_equal(ps["risky"], np.asarray(js["risky"]))
    ok = ~ps["risky"]
    assert ok.mean() > 0.9
    maxp = host.preset.max_num_parameters
    for key, cols in (("section_bits", None), ("orders", None),
                      ("coefs", slice(0, maxp))):
        want = np.asarray(js[key])
        got = ps[key]
        if cols is not None:
            want, got = want[:, cols], got[:, cols]
        np.testing.assert_array_equal(got[ok], want[ok], err_msg=key)
    blocks = np.stack([pcm[:, o:o + n] for o in offs])
    _m, params, bits = host._compute_coefficients(blocks, n, 0,
                                                  measure_only=True)
    assert params is None
    blk_ok = ~ps["risky_blk"]
    assert blk_ok.any()
    np.testing.assert_array_equal(ps["bits"][blk_ok], bits[blk_ok])


def test_cut_spans_rejects_spans_outside_the_file():
    file = torch.zeros((2, 100), dtype=torch.int16)
    assert texact.cut_spans(file, [0, 36], 64).shape == (2, 2, 64)
    for offs in ([37], [-1], [0, 100]):
        with pytest.raises(ValueError, match="leaves"):
            texact.cut_spans(file, offs, 64)


def test_flagged_spans_are_remeasured_on_host(monkeypatch):
    """With the pre-emphasis margin past every decision, every span is
    flagged: each is re-measured on the host and counted as a span, the
    encoded blocks are counted as repaired blocks, and the bytes hold."""
    monkeypatch.setattr(texact, "_EPS_PREEMPH", 1.0)
    pcm = _signal("segmented", 2, 16, 8192)
    want = srla_tpu.encode(pcm, 16, 44100, max_block=1024,
                           variable_divisions=2, backend="exact")
    enc = encoder.SRLAEncoder(_param(2, 16, 2, 1024, 4), "cpu")
    with pytest.warns(RuntimeWarning, match="decision boundaries"):
        assert enc.encode_whole(pcm) == want
    s = enc.stats
    even, _ = _candidates(pcm, enc.p)
    assert s["device_spans"] == 0 and s["remeasured_spans"] == even
    compress = sum(t == BlockDataType.COMPRESS for t, _ in _sizes(want))
    assert s["device_blocks"] == 0
    assert compress <= s["repaired_blocks"] < even


def test_measurement_call_cap(monkeypatch):
    """A cap below a size's spans splits its measurement into several
    calls: the same bytes, every span counted once."""
    calls = []
    real = encoder.measure_spans

    def counting(file, offsets, *a, **kw):
        calls.append((kw["n"], len(offsets)))
        return real(file, offsets, *a, **kw)

    monkeypatch.setattr(encoder, "measure_spans", counting)
    pcm = _signal("music", 2, 16, 8192)
    want = host_encoder.encode(pcm, 16, 44100, max_block=1024,
                               variable_divisions=1, lookahead_factor=4)
    enc = encoder.SRLAEncoder(_param(2, 16, 1, 1024, 4), "cpu")
    assert enc.encode_whole(pcm) == want
    one_call = len(calls)
    sizes = {n for n, _ in calls}
    assert one_call == len(sizes)       # one call per span size
    calls.clear()
    monkeypatch.setattr(encoder.SRLAEncoder, "MAX_MEASURE_SAMPLES", 4 * 1024)
    enc = encoder.SRLAEncoder(_param(2, 16, 1, 1024, 4), "cpu")
    assert enc.encode_whole(pcm) == want
    assert len(calls) > one_call
    assert all(n * k <= 4 * 1024 for n, k in calls)
    assert enc.stats["device_spans"] == sum(k for _, k in calls)


def test_step_timer_breakdown_at_v():
    """The -V breakdown: upload, the search's host steps and the
    measurement's own steps beside the encode's."""
    pcm = _signal("segmented", 2, 16, 8192)
    enc = encoder.SRLAEncoder(_param(2, 16, 2, 1024, 4), "cpu")
    enc.timer = encoder.StepTimer("cpu")
    assert enc.encode_whole(pcm) == host_encoder.encode(
        pcm, 16, 44100, max_block=1024, variable_divisions=2)
    steps = enc.timer.seconds
    for name in ("upload", "partition search (host)", "span typing (host)",
                 "measure: K3 fir_predict", "measure: K4 rice_search",
                 "measure: fetch", "K4 rice_search", "K5 bitpack",
                 "assembly"):
        assert steps[name] >= 0.0, name
    assert not [k for k in steps if "Rice" in k]


def test_progress_fires_once_per_block_at_v():
    """One meter call a block at -V, the odd last window's blocks too."""
    pcm = _signal("music", 2, 16, 10001)
    seen = []
    enc = encoder.SRLAEncoder(_param(2, 16, 1, 1024, 2), "cpu")
    data = enc.encode_whole(pcm, progress_callback=seen.append)
    assert len(seen) == len(_sizes(data))
    assert all(b > a for a, b in zip(seen, seen[1:]))
    assert seen[-1] == pcm.shape[1]


# ---------------------------------------------------------------------------
# Block-level API and CLI
# ---------------------------------------------------------------------------

def test_block_api_matches_srla_tpu():
    """compute_block_size (COMPRESS, SILENT, RAW, odd length, raw fallback)
    and encode_optimal_partitioned_block (an even and an odd window) of the
    port's host and device encoders against srla_tpu's."""
    pcm = _signal("segmented", 2, 16, 9000)
    noise = np.random.RandomState(1).randint(-32768, 32768, (2, 2048))
    param = _param(2, 16, 2, 2048, 4)
    ref = jax_encoder.SRLAEncoder(jax_encoder.EncodeParameter(
        num_channels=2, bits_per_sample=16, sampling_rate=44100, preset=4,
        max_num_samples_per_block=2048, min_num_samples_per_block=512,
        num_lookahead_samples=8192), backend="exact")
    mine = (host_encoder.SRLAEncoder(param),
            encoder.SRLAEncoder(param, "cpu"))
    blocks = (pcm[:, :2048], np.zeros((2, 1024), np.int32), pcm[:, :40],
              pcm[:, 100:1101], noise)
    for blk in blocks:
        want = ref.compute_block_size(blk)
        for enc in mine:
            assert enc.compute_block_size(blk) == want
    for window in (pcm[:, :8192], pcm[:, 500:7501]):
        want = ref.encode_optimal_partitioned_block(window)
        for enc in mine:
            assert enc.encode_optimal_partitioned_block(window) == want


def test_cli_default_flags_equal_srla_tpu_cli(tmp_path):
    """``python -m srla_tpu_torch.cli -e`` at its defaults (-m 4 -B 4096
    -V 1 -L 4) writes the bytes of ``python -m srla_tpu.cli -e``."""
    from srla_tpu import cli as jax_cli
    from srla_tpu.wavio import WavData, write_wav
    from srla_tpu_torch.cli import main
    pcm = _signal("segmented", 2, 16, 20000)
    wav = tmp_path / "in.wav"
    write_wav(str(wav), WavData(pcm, 44100, 16))
    ref, out = tmp_path / "ref.srl", tmp_path / "out.srl"
    assert jax_cli.main(["-e", str(wav), str(ref)]) == 0
    assert main(["-e", "--device", "cpu", str(wav), str(out)]) == 0
    assert out.read_bytes() == ref.read_bytes()
    assert {n for _, n in _sizes(ref.read_bytes())} >= {2048, 4096}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("V", [1, 2, 3])
def test_variable_encode_on_card(cuda, V):
    """The -V encode on the card: the host's bytes, every span accounted,
    K3 and K4 once per measurement call plus once per encode group, K5's
    fused entry once per encode group."""
    from srla_tpu_torch.kernels.bitpack import pack_residual_sections
    from srla_tpu_torch.kernels.predict import predict
    from srla_tpu_torch.kernels.rice_search import rice_search
    pcm = _signal("segmented", 2, 16, 40000)      # even windows only
    want = host_encoder.encode(pcm, 16, 44100, variable_divisions=V)
    calls = []
    real = encoder.measure_spans

    def counting(file, offsets, *a, **kw):
        calls.append(kw["n"])
        return real(file, offsets, *a, **kw)

    k3, k4, k5 = (predict.launches, rice_search.launches,
                  pack_residual_sections.launches)
    enc = encoder.SRLAEncoder(_param(2, 16, V, 4096, 4), cuda)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(encoder, "measure_spans", counting)
        assert enc.encode_whole(pcm) == want
    limit = PARAMETER_PRESETS[4].max_num_parameters
    groups = {n for t, n in _sizes(want) if n > limit}
    even, odd = _candidates(pcm, enc.p)
    s = enc.stats
    assert s["device_spans"] + s["remeasured_spans"] == even
    assert s["host_spans"] == odd == 0
    assert pack_residual_sections.launches - k5 == len(groups)
    assert len(calls) == len(set(calls))           # one call per length
    assert (predict.launches - k3 == rice_search.launches - k4
            == len(calls) + len(groups))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1536, 2048, 2560, 3072, 3584, 2016])
def test_kernels_match_plain_at_variable_sizes(cuda, n):
    """K3, K4 (the aligned power-of-two entry at 2048, the generic one at
    the rest; every output) and K5's fused entry against their plain
    versions on the spans of one -V measurement group of length n."""
    from srla_tpu_torch.kernels.bitpack import (pack_residual_sections,
                                                pack_residual_sections_plain,
                                                zigzag32)
    from srla_tpu_torch.kernels.predict import predict, predict_plain
    from srla_tpu_torch.kernels.rice_search import (rice_search,
                                                    rice_search_plain)
    pcm = _signal("segmented", 2, 16, 60000)
    offs = np.arange(0, 60000 - n, 512)
    host = host_encoder.SRLAEncoder(_param(2, 16, 3, 4096, 4))
    args = host._device_args(n)
    blocks = texact.cut_spans(torch.from_numpy(pcm).to(cuda), offs, n)
    small, big, core = texact.variant_analysis(blocks, 0, **args)
    k3 = (core["work"], core["coefs"], core["orders"], core["rshifts"])
    np.testing.assert_array_equal(predict(*k3).cpu().numpy(),
                                  predict_plain(*k3).cpu().numpy())
    k4 = (core["residual"], n, args["max_porder"])
    for got, want in zip(rice_search(*k4), rice_search_plain(*k4)):
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    B = len(offs)
    W = encoder.SRLAEncoder(host.p, "cpu")._section_words(n)
    sel = texact.select_rows(small, B=B, C=2, n=n, bps=16, W=W,
                             max_params=args["max_params"])
    sec = texact.chosen_sections(dict(big, u=zigzag32(core["residual"])),
                                 sel, n, B * 2 * W)
    total = int(sec[6].sum())
    assert total > 0
    got = pack_residual_sections(*sec, section_words=W)[:total]
    want = pack_residual_sections_plain(*sec)[:total]
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())

