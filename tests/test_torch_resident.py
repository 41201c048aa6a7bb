"""The decode to device-resident PCM on the CPU: K13's plain version
(``kernels.verify.verify_blocks_plain``) against
``srla_tpu.kernels.decode2.verify_blocks_device``, and
``SRLADecoder("cpu").decode_whole_device_resident`` (the kernels' plain
versions) against ``srla_tpu``'s ``decode_whole_device_resident`` on
JAX-CPU, on the same inputs made from a seed
(``test_torch_resident_card.py``, which holds them on the card).

Every compared value is a flag: tolerance 0."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from srla_tpu.decoder import SRLADecoder as JaxDecoder  # noqa: E402
from srla_tpu.kernels.decode2 import verify_blocks_device  # noqa: E402
from srla_tpu_torch import SRLADecoder  # noqa: E402
from srla_tpu_torch.constants import BlockDataType  # noqa: E402
from srla_tpu_torch.kernels import verify  # noqa: E402
from test_torch_resident_card import (BLOCK_TYPES, STARTS, blocks,  # noqa: E402
                                      corrupt, flipped, port, stream,
                                      verify_case)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the CPU decodes here are many small torch ops
    (see test_torch_decode.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(out, expected, starts, okrows, n, B) -> tuple[bool, bool]:
    want = verify_blocks_device(jnp.asarray(out), jnp.asarray(expected),
                                jnp.asarray(starts), jnp.asarray(okrows),
                                n=n, B=B)
    got = verify.verify_blocks(torch.from_numpy(out),
                               torch.from_numpy(expected),
                               torch.from_numpy(starts),
                               torch.from_numpy(okrows), n=n, B=B)
    assert got.dtype == torch.bool and got.dim() == 0
    return bool(got), bool(want)


@pytest.mark.parametrize("kind", STARTS)
@pytest.mark.parametrize("C", [1, 2, 3])
def test_verify_plain_matches_jax(C, kind):
    out, expected, starts, okrows, n, B = verify_case(C, kind, 3 * C)
    assert _both(out, expected, starts, okrows, n, B) == (True, True)
    # One flipped sample in an ok row fails; in a row that is not ok, or in
    # a padding row, it does not.
    for row, ok in ((0, False), (B - 1, False), (1, True), (B - 2, True),
                    (B, True)):
        bad = flipped(out, row, C, n)
        assert _both(bad, expected, starts, okrows, n, B) == (ok, ok), row
    if kind == "clamped":
        # The clamped rows read the last and the first n samples.
        for row, i in ((2, -1), (4, 0)):
            bad = out.copy()
            bad[row, 0, i] ^= 4
            assert _both(bad, expected, starts, okrows, n, B) == (False,
                                                                 False)


def test_verify_refuses_bad_shapes():
    out, expected, starts, okrows, n, B = verify_case(2, "consecutive", 1)
    t = {k: torch.from_numpy(v) for k, v in
         dict(out=out, expected=expected, starts=starts,
              okrows=okrows).items()}
    for change in (dict(expected=t["expected"].long()),
                   dict(out=t["out"][:, :1]),
                   dict(out=t["out"][:B - 1]),
                   dict(starts=t["starts"].long()),
                   dict(okrows=t["okrows"].int())):
        args = {**t, **change}
        with pytest.raises(ValueError):
            verify.verify_blocks(args["out"], args["expected"],
                                 args["starts"], args["okrows"], n=n, B=B)
    with pytest.raises(ValueError):        # a block longer than expected
        verify.verify_blocks_plain(t["out"], t["expected"][:, :n - 1],
                                   t["starts"], t["okrows"], n=n, B=B)


def _jax(data, pcm, monkeypatch):
    """srla_tpu's answer, every COMPRESS group on its device path."""
    monkeypatch.setenv("SRLA_DEV_MIN_GROUP", "1")
    dec = JaxDecoder(backend="tpu")
    return dec.decode_whole_device_resident(data, (jnp.asarray(pcm), pcm))


def _compress(blks) -> int:
    return sum(t == BlockDataType.COMPRESS for t, _, _ in blks)


@pytest.mark.parametrize("kind", ["m4", "P3", "m6", "V3", "24bit", "mono",
                                  "C3"])
def test_resident_decode_matches_jax(kind, monkeypatch):
    pcm, data = stream(kind)
    blks = blocks(data)
    assert {t for t, _, _ in blks} == set(BLOCK_TYPES)
    ok, stats = port(data, pcm)
    want, jstats = _jax(data, pcm, monkeypatch)
    assert (ok, want) == (True, True)
    assert stats == {"device_blocks": _compress(blks), "host_blocks": 0}
    assert jstats["device_blocks"] == _compress(blks)
    for btype in BLOCK_TYPES:
        bad = corrupt(pcm, blks, btype)
        assert port(data, bad)[0] is False, btype
        assert _jax(data, bad, monkeypatch)[0] is False, btype


@pytest.mark.parametrize("kind", ["m4", "V3", "C3"])
def test_resident_decode_split(kind):
    """devices=["cpu", "cpu"]: each group cut in two shards, the same
    answers."""
    pcm, data = stream(kind)
    blks = blocks(data)
    ok, stats = port(data, pcm, devices=["cpu", "cpu"])
    assert ok is True
    assert stats["device_blocks"] == _compress(blks)
    assert max(len(c) for c in stats["shard_cuts"]) == 2
    for btype in BLOCK_TYPES:
        bad = corrupt(pcm, blks, btype)
        assert port(data, bad, devices=["cpu", "cpu"])[0] is False


def test_plan_reports_host_spans_and_decode_unchanged():
    pcm, data = stream("m4")
    spans: list = []
    dec = SRLADecoder("cpu")
    dec.plan(data, spans)
    assert spans == [(s, ln) for t, s, ln in blocks(data)
                     if t != BlockDataType.COMPRESS]
    _, got = dec.decode_whole(data)
    np.testing.assert_array_equal(got, pcm)


def test_resident_decode_refuses_bad_expected():
    pcm, data = stream("mono")
    dec = SRLADecoder("cpu")
    for exp in ((torch.from_numpy(pcm).long(), pcm),
                (torch.from_numpy(pcm[:, 1:]), pcm),
                (torch.from_numpy(np.concatenate([pcm, pcm])), pcm),
                (torch.from_numpy(pcm), pcm.astype(np.int64)),
                (pcm, pcm)):
        with pytest.raises(ValueError):
            dec.decode_whole_device_resident(data, exp)
