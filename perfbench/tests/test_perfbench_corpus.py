import numpy as np
import pytest

from perfbench import corpus

SEED = 2**31 + 12345       # above 32 signed bits, as a run's seeds may be


@pytest.mark.parametrize("rate", [44100, 96000])
@pytest.mark.parametrize("category", corpus.CATEGORIES)
def test_same_seed_same_audio(category, rate):
    a = corpus.track(category, SEED, rate, 0.7)
    b = corpus.track(category, SEED, rate, 0.7)
    c = corpus.track(category, SEED + 1, rate, 0.7)
    assert a.shape == (2, round(0.7 * rate)) and a.dtype == np.int32
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert np.abs(a).max() <= 32767


def test_rate_keeps_the_music_and_24_bits_scale_it():
    lo = corpus.track("classic", SEED, 44100, 1.0)
    hi = corpus.track("classic", SEED, 96000, 1.0)
    assert hi.shape[1] == 96000 and lo.shape[1] == 44100
    d = corpus.track("vocal", SEED, 96000, 0.5, bits=24)
    s = corpus.track("vocal", SEED, 96000, 0.5, bits=16)
    assert np.abs(d).max() < (1 << 23)
    assert np.abs(d.astype(np.int64) - 256 * s.astype(np.int64)).max() <= 127
    assert not np.array_equal(corpus.track("vocal", SEED, 96000, 0.5, 24, 1),
                              d)


def test_rhythm_has_hard_silence_and_takes_differ():
    r = corpus.track("rhythm", SEED, 44100, 2.0)
    assert (~r.any(axis=0)).sum() > 10000
    with pytest.raises(ValueError):
        corpus.track("polka", SEED, 44100, 1.0)


def test_order_is_a_seeded_permutation():
    a = corpus.order(SEED, 8, 3)
    assert sorted(a) == list(range(8))
    assert np.array_equal(a, corpus.order(SEED, 8, 3))
    assert any(not np.array_equal(a, corpus.order(SEED + k, 8, 3))
               for k in range(1, 5))


@pytest.mark.parametrize("bits", [16, 24])
def test_rotated_is_the_same_piece_in_another_order(bits):
    unit, n = 1024, 22050                  # 22 units, the last one cut
    a = corpus.rotated("vocal", SEED, 44100, 0.5, bits, unit=unit)
    b = corpus.rotated("vocal", SEED, 44100, 0.5, bits, unit=unit)
    assert a.shape == (2, n) and np.array_equal(a, b)
    piece = corpus.track("vocal", corpus.MATERIAL_SEED, 44100, 22 * unit
                         / 44100, bits)
    starts = set()
    for seed in range(SEED, SEED + 6):
        x = corpus.rotated("vocal", seed, 44100, 0.5, bits, unit=unit)
        # every seed's file is the piece's units from a seeded one on,
        # wrapped round: the same units, the last one cut short
        start = next(s for s in range(22) if np.array_equal(
            np.roll(piece, -s * unit, axis=1)[:, :n], x))
        starts.add(start)
    assert len(starts) > 1
