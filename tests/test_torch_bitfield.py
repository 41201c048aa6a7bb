"""K6, the bit-field placement probes: the port's plain versions
(``place_{dot,rmw,mask}_plain``) against the TPU kernel bodies of
``tools/mosaic_repro.py`` run by ``pallas_call(..., interpret=True)`` on
JAX-CPU, on the tool's own inputs; against the ``scatter_add_`` yardstick
at R > 1; the wrappers' argument checks; the port's tool; and, on a CUDA
card, each kernel against its plain version.

Every output is an int32 word, so every comparison is exact (tolerance 0).
"""

import importlib.util
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from srla_tpu_torch.kernels import bitfield  # noqa: E402
from srla_tpu_torch.tools import bitfield_probes  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = bitfield_probes.W


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        "mosaic_repro", os.path.join(REPO, "tools", "mosaic_repro.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _load_tool()
BODIES = {"dot": (TOOL._dot_kernel, bitfield.place_dot_plain),
          "rmw": (TOOL._rmw_kernel, bitfield.place_rmw_plain),
          "mask": (TOOL._mask_kernel, bitfield.place_mask_plain)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rows(R: int, seed: int = 0):
    """R rows of the tool's inputs (row r from seed + r), as int32
    tensors on the CPU."""
    parts = [bitfield_probes.make_inputs(seed + r) for r in range(R)]
    return [torch.from_numpy(np.concatenate([p[k] for p in parts]))
            for k in range(3)]


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("body", sorted(BODIES))
def test_plain_matches_jax_body(monkeypatch, body, seed):
    kernel, plain = BODIES[body]
    inputs = TOOL._inputs(seed)
    monkeypatch.setattr(TOOL, "_inputs", lambda: inputs)
    want = TOOL._run(kernel, interpret=True)
    vals, word, shift = (torch.from_numpy(np.array(a)) for a in inputs)
    got = plain(vals, word, shift, W).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (want < 0).any()          # a field at bit 24 sets the sign bit


# (R, C, W): the tool's shape at one row and at many, C and W that are no
# multiple of a warp or of a CTA's words, one codeword into one word, and a
# row longer than the kernels' staging buffer with W over several CTAs.
SHAPES = [(1, 256, 128), (4096, 256, 128), (37, 300, 200), (3, 1, 1),
          (2, 5000, 3000)]


def _shape_id(shape):
    return "R{}-C{}-W{}".format(*shape)


def _shape_inputs(R, C, W, bad_words):
    """Full-range values (sums wrap, fields overlap), a tenth of the shifts
    outside 0..31 and, with bad_words, a tenth of the words outside
    0..W-1."""
    rng = np.random.RandomState(R * 7919 + C * 31 + W)
    vals = rng.randint(-(1 << 31), 1 << 31, (R, C)).astype(np.int32)
    word = rng.randint(0, W, (R, C))
    shift = rng.randint(0, 32, (R, C))
    shift = np.where(rng.rand(R, C) < 0.1,
                     rng.choice([-1, 32, 33, 40, 1 << 20], (R, C)), shift)
    if bad_words:
        word = np.where(rng.rand(R, C) < 0.1,
                        rng.choice([-1, -W, W, W + 3, 1 << 30], (R, C)),
                        word)
    return [torch.from_numpy(a.astype(np.int32))
            for a in (vals, word, shift)]


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
@pytest.mark.parametrize("body", sorted(BODIES))
def test_plain_matches_jax_body_at_shape(monkeypatch, body, shape):
    """The first, a middle and the last row of each shape through the TPU
    body (one row a call, as the tool runs it). The read-modify-write
    body's dynamic slice cannot take a word outside 0..W-1; the other two
    get such words too."""
    kernel, plain = BODIES[body]
    R, C, Wn = shape
    vals, word, shift = _shape_inputs(R, C, Wn, bad_words=body != "rmw")
    monkeypatch.setattr(TOOL, "C", C)
    monkeypatch.setattr(TOOL, "W", Wn)
    rows = sorted({0, R // 2, R - 1})
    got = plain(vals[rows], word[rows], shift[rows], Wn).numpy()
    for i, r in enumerate(rows):
        inputs = tuple(jax.numpy.asarray(t[r:r + 1].numpy())
                       for t in (vals, word, shift))
        monkeypatch.setattr(TOOL, "_inputs", lambda: inputs)
        want = TOOL._run(kernel, interpret=True)
        np.testing.assert_array_equal(got[i:i + 1], want)


@pytest.mark.parametrize("seed", [0, 3])
def test_make_inputs_is_the_tools(seed):
    for mine, theirs in zip(bitfield_probes.make_inputs(seed),
                            TOOL._inputs(seed)):
        np.testing.assert_array_equal(mine, np.asarray(theirs))


def test_plain_versions_match_scatter_add():
    """At R > 1, with shifts of 31 and 32 (0) and words outside 0..W-1
    mixed in for the three formulations; the yardstick sees the valid
    inputs only."""
    vals, word, shift = _rows(24)
    want = bitfield.place_scatter_add(vals, word.long(), shift, W)
    for plain in (bitfield.place_dot_plain, bitfield.place_rmw_plain,
                  bitfield.place_mask_plain):
        np.testing.assert_array_equal(plain(vals, word, shift, W), want)
    for wrapper in (bitfield.place_dot, bitfield.place_rmw,
                    bitfield.place_mask):
        np.testing.assert_array_equal(wrapper(vals, word, shift, W), want)
    rng = np.random.RandomState(9)
    odd = rng.rand(*vals.shape) < 0.1
    bad_word = torch.from_numpy(np.where(odd, W + 3, word.numpy()))
    bad_shift = torch.from_numpy(np.where(rng.rand(*vals.shape) < 0.1, 32,
                                          shift.numpy()).astype(np.int32))
    keep = torch.from_numpy(~odd) & (bad_shift < 32)
    ref = bitfield.place_scatter_add(vals * keep, word.long(), shift, W)
    for plain in (bitfield.place_dot_plain, bitfield.place_rmw_plain,
                  bitfield.place_mask_plain):
        np.testing.assert_array_equal(
            plain(vals, bad_word, bad_shift, W), ref)
    top = torch.full_like(vals, 1)
    got = bitfield.place_mask_plain(top, word, torch.full_like(vals, 31), W)
    assert (got.numpy() <= 0).all() and (got.numpy() < 0).any()


def test_wrappers_raise_on_bad_arguments():
    vals, word, shift = _rows(2)
    with pytest.raises(ValueError, match="int32"):
        bitfield.place_dot(vals.long(), word, shift, W)
    with pytest.raises(ValueError, match="shape"):
        bitfield.place_rmw(vals, word[:, :10].contiguous(), shift, W)
    with pytest.raises(ValueError, match="2-D"):
        bitfield.place_mask(vals[0], word[0], shift[0], W)
    with pytest.raises(ValueError, match="W="):
        bitfield.place_rmw(vals, word, shift, 0)
    with pytest.raises(ValueError, match="contiguous"):
        bitfield.place_dot(vals.t().contiguous().t(), word, shift, W)
    meta = [t.to("meta") for t in (vals, word, shift)]
    for wrapper in (bitfield.place_dot, bitfield.place_rmw,
                    bitfield.place_mask):
        with pytest.raises(ValueError, match="meta"):
            wrapper(*meta, W)
        with pytest.raises(ValueError, match="on cpu, got .* on meta"):
            wrapper(vals, meta[1], shift, W)
    assert bitfield.place_dot.launches == bitfield.place_rmw.launches \
        == bitfield.place_mask.launches == 0


def test_tool_on_cpu(capsys):
    assert bitfield_probes.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.count("PASS") == 3


@pytest.mark.gpu
@pytest.mark.parametrize("R", [1, 4096])
def test_kernels_match_plain_on_card(cuda, R):
    vals, word, shift = (t.to(cuda) for t in _rows(R, seed=R))
    want = bitfield.place_scatter_add(vals, word.long(), shift, W)
    for kernel, plain in ((bitfield.place_dot, bitfield.place_dot_plain),
                          (bitfield.place_rmw, bitfield.place_rmw_plain),
                          (bitfield.place_mask, bitfield.place_mask_plain)):
        before = kernel.launches
        got = kernel(vals, word, shift, W)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert torch.equal(got, plain(vals, word, shift, W))
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_tool_on_card(cuda):
    assert bitfield_probes.main(["--device", "cuda"]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_kernels_match_plain_at_shape(cuda, shape):
    """Each kernel against its plain version with words and shifts out of
    range mixed in; rows of the plain versions in slices, so that their
    (R, C, W) intermediates stay small."""
    R, C, Wn = shape
    vals, word, shift = (t.to(cuda) for t in _shape_inputs(R, C, Wn, True))
    step = max(1, (1 << 24) // (C * Wn))
    for kernel, plain in ((bitfield.place_dot, bitfield.place_dot_plain),
                          (bitfield.place_rmw, bitfield.place_rmw_plain),
                          (bitfield.place_mask, bitfield.place_mask_plain)):
        before = kernel.launches
        got = kernel(vals, word, shift, Wn)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        for r0 in range(0, R, step):
            rows = slice(r0, r0 + step)
            want = plain(vals[rows].contiguous(), word[rows].contiguous(),
                         shift[rows].contiguous(), Wn)
            assert torch.equal(got[rows], want)


@pytest.mark.gpu
def test_kernels_take_unaligned_rows(cuda):
    """Rows that start 4 bytes into their buffers cannot take 128-bit
    loads; the result is the same."""
    R, C, Wn = 5, 256, 128
    cpu = _shape_inputs(R, C, Wn, True)
    off = []
    for t in cpu:
        buf = torch.zeros(R * C + 1, dtype=torch.int32, device=cuda)
        view = buf[1:].view(R, C)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0 and view.is_contiguous()
        off.append(view)
    for kernel, plain in ((bitfield.place_dot, bitfield.place_dot_plain),
                          (bitfield.place_mask, bitfield.place_mask_plain)):
        assert torch.equal(kernel(*off, Wn), plain(*off, Wn))
