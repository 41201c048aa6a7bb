"""The K12 probe tool (``srla_tpu_torch/tools/k12_probe.py``) on the CPU:
its stamped copy of ``csrc/svr_refine.cu`` is the kernel plus the stamps
and nothing else, it refuses a kernel whose phase lines moved, and its
main-call inputs have K12's shapes (at 0.1 s of the encode's audio)."""

import os

import pytest
import torch

from srla_tpu_torch.kernels import build
from srla_tpu_torch.tools import k12_probe

SRC = os.path.join(build.SRC_DIR, "svr_refine.cu")


def _source() -> str:
    with open(SRC) as f:
        return f.read()


def test_stamped_source_is_the_kernel_plus_its_stamps():
    src = _source()
    out = k12_probe.stamped_source(src)
    assert out.count("    STAMP(") == 7       # 0, 1, 2, tiles, decide, 9, 10
    assert "g_k12_clk[15]" in out
    kept = out.replace(k12_probe._HEAD, "")
    kept = "".join(line for line in kept.splitlines(keepends=True)
                   if "STAMP(" not in line and "t_last = clock64" not in line
                   and "g_k12_clk[15]" not in line)
    assert kept == src


@pytest.mark.parametrize("old,new", [
    ("    // 1. Cholesky", "    // 1. The factor"),
    ("    // 5. The adopted vector.\n", ""),
])
def test_stamped_source_refuses_a_moved_phase_line(old, new):
    src = _source()
    assert old in src
    with pytest.raises(SystemExit, match="no longer has this line"):
        k12_probe.stamped_source(src.replace(old, new))


def test_main_call_inputs_have_k12_shapes():
    (work, cov, coefs, orders, n, bps, max_iter, margins, ridge,
     kappa) = k12_probe.main_call_inputs(torch, torch.device("cpu"), 0.1)
    blocks = int(0.1 * 44100) // 4096
    V, M = coefs.shape
    assert (n, bps, max_iter, len(margins)) == (4096, 16, 2, 6)
    assert work.shape == (4 * blocks, n) and work.dtype == torch.int32
    assert cov.shape == (V, M, M) and M == 64 and V == 4 * blocks
    assert orders.shape == kappa.shape == (V,)
    assert int(orders.min()) >= 0 and int(orders.max()) <= M
    assert 0.0 < ridge < 1.0
