"""The port's copy of the reference's library-only LPC routines,
srla_tpu_torch.dsp.lpc_extra (AF iteration, Burg recursion, PARCOR
conversion and quantization, MDL, the code-length estimate), against
srla_tpu.dsp.lpc_extra on the inputs of tests/test_lpc_extra.py and a few
more. Both are the same host numpy code: every result equal."""

import numpy as np
import pytest

from srla_tpu.dsp import lpc_extra as J
from srla_tpu_torch.dsp import lpc_extra as P


def _ar2_signal(n=4000, a1=-1.2, a2=0.7, seed=0):
    rng = np.random.RandomState(seed)
    x = np.zeros(n)
    e = rng.randn(n) * 0.1
    for i in range(2, n):
        x[i] = -a1 * x[i - 1] - a2 * x[i - 2] + e[i]
    return x / np.abs(x).max()


@pytest.mark.parametrize("order", [1, 8, 32])
def test_autocorrelation_direct_equals_jax(order):
    x = np.random.RandomState(1).randn(500)
    np.testing.assert_array_equal(P.autocorrelation_direct(x, order),
                                  J.autocorrelation_direct(x, order))


@pytest.mark.parametrize("order", [2, 4, 8])
def test_burg_equals_jax(order):
    x = _ar2_signal()
    np.testing.assert_array_equal(P.lpc_burg(x, order), J.lpc_burg(x, order))


@pytest.mark.parametrize("iters", [1, 20])
def test_auxiliary_function_equals_jax(iters):
    x = _ar2_signal()
    init = J.lpc_burg(x, 2)
    np.testing.assert_array_equal(
        P.lpc_auxiliary_function(x, 2, max_iterations=iters,
                                 initial_coef=init),
        J.lpc_auxiliary_function(x, 2, max_iterations=iters,
                                 initial_coef=init))
    np.testing.assert_array_equal(
        P.lpc_auxiliary_function(x[:600], 3, max_iterations=iters),
        J.lpc_auxiliary_function(x[:600], 3, max_iterations=iters))


def test_auxiliary_function_singular_is_zero():
    x = np.zeros(200)
    np.testing.assert_array_equal(P.lpc_auxiliary_function(x, 3),
                                  J.lpc_auxiliary_function(x, 3))


@pytest.mark.parametrize("bits", [4, 8, 12])
def test_parcor_equals_jax(bits):
    coef = J.lpc_burg(_ar2_signal(seed=2), 4)
    np.testing.assert_array_equal(P.lpc_to_parcor(coef),
                                  J.lpc_to_parcor(coef))
    np.testing.assert_array_equal(P.quantize_parcor(coef, bits),
                                  J.quantize_parcor(coef, bits))


def test_mdl_and_code_length_equal_jax():
    parcor = J.lpc_to_parcor(J.lpc_burg(_ar2_signal(seed=3), 6))
    assert P.calculate_mdl(parcor, 4096) == J.calculate_mdl(parcor, 4096)
    for args in ((-3.5, 0.02, 4096, 16), (0.0, 0.0, 4096, 16),
                 (-40.0, 1e-9, 256, 24)):
        assert P.estimate_code_length(*args) == J.estimate_code_length(*args)
