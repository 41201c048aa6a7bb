"""The frozen least-time counts against hand counts at the main path's
shape (1291 blocks of 4096 stereo samples, -m 4)."""

import pytest

from perfbench import roofline as rf

B, C, n = 1291, 2, 4096
V = B * 4                       # mid, side, left, right


def g(**kw):
    base = dict(n=n, blocks=B, channels=C, payload_bytes=15_000_000,
                order_sum=B * C * 32, methods=[1] * B)
    base.update(kw)
    return rf.Group(**base)


def ms(nbytes=0.0, ops=0.0, rate=rf.INT32_OPS_PER_S):
    return max(nbytes / 3.35e12, ops / rate) * 1e3


def test_bound_takes_the_larger_side():
    b = rf.bound(3.35e9, 1.0)
    assert b["bound_ms"] == pytest.approx(1.0) and b["bound_by"] == "bytes"
    b = rf.bound(1.0, rf.INT32_OPS_PER_S)
    assert b["bound_ms"] == pytest.approx(1e3)
    assert b["bound_by"] == "operations"
    assert rf.INT32_OPS_PER_S == 132 * 64 * 1.98e9


def test_encode_counts():
    assert rf.variants(B, 2) == V and rf.variants(B, 1) == B
    # K16: 21 MB of int16 samples in, the rows and fields out
    want = ms(B * C * n * 2 + 8 * B + V * n * 4 + 9 * V, 13 * V * n)
    assert rf.k16(g(), 2)["bound_ms"] == pytest.approx(want)
    assert rf.k16(g(), 2)["bound_ms"] == pytest.approx(0.0316, abs=5e-5)
    # K8: 65 lags on the f64 tensor cores
    pairs = sum(n - k for k in range(65))
    want = ms(V * n * 4 + n * 8 + V * 65 * 8, 2 * V * pairs,
              rf.F64_TENSOR_OPS_PER_S)
    assert rf.k8(g(), 65)["bound_ms"] == pytest.approx(want)
    assert rf.k8(g(), 65)["bound_by"] == "operations"
    # K7: the recursion to 64, the order choice, the kept orders' rounding
    first = sum(4 * m + 7 for m in range(2, 65))
    want = ms(V * 65 * 8 + V * (9 + 4 * 64),
              V * (first + 30 * 64) + 8 * B * C * 32, rf.F64_OPS_PER_S)
    assert rf.k7(g(), 64)["bound_ms"] == pytest.approx(want)
    # K3: rows in and out once
    assert rf.k3(g())["bound_ms"] == pytest.approx(
        ms(2 * V * n * 4 + 4 * B * C * 32, n * (B * C * 32 + 3 * V)))
    # K4: porders 0..10 at 4096 samples
    assert rf.max_porder(4096) == 10 and rf.max_porder(4064) == 5
    assert rf.k4(g())["bound_ms"] == pytest.approx(
        ms(V * n * 4 + V * (16 + 8192), (5 * V + 2 * V * 11) * n))
    assert rf.k5(g())["bound_ms"] == pytest.approx(
        ms(4 * B * C * n + 40 * B * C + 15_000_000, 15 * B * C * n))
    assert set(rf.encode_group(g(), 2, 64)) == {
        "K16", "K8", "K7", "K3", "K4", "K17", "K5"}


def test_decode_counts():
    S = B * C * n
    assert rf.k2(g())["bound_ms"] == pytest.approx(
        ms(15_000_000 + 8 * B + 4 * S, 4 * S))
    assert rf.k1(g())["bound_ms"] == pytest.approx(
        ms(8 * S + 16 * B * C + 4 * B * C * 32,
           n * (B * C * 32 + 6 * B * C)))
    # K19: every block at method 1 reads and writes both rows
    assert rf.k19(g(), 0)["bound_ms"] == pytest.approx(ms(4 * n * 4 * B,
                                                          4 * n * B))
    # method 0 changes nothing; any lshift touches every row
    assert rf.k19(g(methods=[0] * B), 0)["bound_ms"] == 0
    assert rf.k19(g(methods=[0] * B), 3)["bound_ms"] == pytest.approx(
        ms(4 * n * 4 * B, 4 * n * B))


def test_kernel_names():
    assert rf.kernel_of("void (anonymous namespace)::rice_decode_kernel"
                        "<4>(int const*, ...)") == "K2"
    assert rf.kernel_of("void at::native::vectorized_elementwise_kernel"
                        "<4, ...>") is None
    assert rf.kernel_of("Memcpy DtoH (Device -> Pageable)") is None


def test_least_ms_sums_each_batch_times_its_requests():
    from perfbench import harness
    cfg = {"format": {"channels": 2, "bits_per_sample": 16},
           "encoder": {"preset": 4}}
    # one batch: two streams, one block of 4096 each (orders 8, 8, method
    # 1), the second stream at offset shift 2
    table = [([(4096, 1000, (8, 8), 1)], 0), ([(4096, 500, (8, 8), 1)], 2)]
    groups = harness._groups(table, 2)
    assert sorted((g.blocks, sh) for g, sh in groups) == [(1, 0), (1, 2)]
    one = harness.least_ms("decode", cfg, {0: table}, {0: 1})
    three = harness.least_ms("decode", cfg, {0: table}, {0: 3})
    assert set(one) == {"K2", "K1", "K19"}
    for k in one:
        assert three[k] == pytest.approx(3 * one[k])
    g0 = rf.Group(4096, 1, 2, 1000, 16, [1])
    g1 = rf.Group(4096, 1, 2, 500, 16, [1])
    assert one["K19"] == pytest.approx(rf.k19(g0, 0)["bound_ms"]
                                       + rf.k19(g1, 2)["bound_ms"])
    enc = harness.least_ms("encode", cfg, {0: table}, {0: 2})
    assert enc["K16"] == pytest.approx(2 * (rf.k16(g0, 2)["bound_ms"]
                                            + rf.k16(g1, 2)["bound_ms"]))
