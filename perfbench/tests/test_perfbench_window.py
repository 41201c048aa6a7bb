import pytest

from perfbench import window as win


def test_rate_is_all_audio_over_the_whole_window():
    reqs = [win.Request(0, 0.0, 1.0, 240.0), win.Request(1, 1.0, 1.5, 240.0),
            win.Request(2, 1.5, 4.0, 120.0, ok=False)]
    # every request counts, the failed one too: 600 s of audio in 5 s
    assert win.rate(reqs, 5.0) == pytest.approx(120.0)
    with pytest.raises(ValueError):
        win.rate(reqs, 0.0)


@pytest.mark.parametrize("n,want", [(10, 9), (100, 90), (101, 91), (1, 1)])
def test_p90_is_the_nearest_rank_over_every_request(n, want):
    values = list(range(n, 0, -1))          # n .. 1, unsorted
    assert win.percentile(values, 90) == want


def test_union_gaps_and_cover():
    iv = [(5, 7), (0, 2), (1, 3), (6, 9), (12, 13)]
    assert win.union(iv) == [(0, 3), (5, 9), (12, 13)]
    assert win.covered(iv) == 8
    assert win.covered(iv, 1, 6) == 3            # [1,3] and [5,6]
    assert win.gaps(iv, 0, 14) == [(3, 5), (9, 12), (13, 14)]
    assert win.gaps([], 2, 4) == [(2, 4)]
    assert win.covered(iv, 0, 14) + sum(e - s for s, e in win.gaps(
        iv, 0, 14)) == 14


def test_kernel_time_outside_a_span():
    """The encode roofline's time leaves out the kernels that start inside
    the -V measurement's span."""
    from perfbench.trace import Trace
    tr = Trace(window=(0, 100),
               device=[("autocorr_kernel<2>", 5, 7),
                       ("autocorr_kernel<2>", 30, 34),
                       ("autocorr_kernel<2>", 60, 61)],
               spans=[("vsearch", 20, 40), ("vsearch", 25, 35),
                      ("finish", 50, 70)])
    k = "K8"
    assert tr.kernel_ms()[k] == pytest.approx(7e-3)
    assert tr.kernel_ms(outside=("vsearch",))[k] == pytest.approx(3e-3)
