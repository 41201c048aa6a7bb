"""The bit-field placement probes on a torch device: the counterpart of
``tools/mosaic_repro.py``.

    python -m srla_tpu_torch.tools.bitfield_probes [--device cuda]

Places C = 256 disjoint 8-bit fields into W = 128 int32 words three ways,
with the three CUDA kernels of K6 (``kernels/bitfield.py``: the one-hot
product, the read-modify-write OR and the masked lane reduction), and holds
each against its plain PyTorch version on the same inputs, made with numpy
exactly as the tool's ``_inputs`` makes them. Prints PASS or MISMATCH (with
the first differing words) per probe and exits 1 on any mismatch.

The tool's canary (a probe "known broken" under Mosaic that would report
"fixed upstream" once it passes) is about the TPU compiler and is not
carried over: on CUDA all three probes are expected to pass. With
``--device cpu`` the wrappers run their plain versions, so the comparison
says nothing about a kernel.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..kernels.bitfield import (place_dot, place_dot_plain, place_mask,
                                place_mask_plain, place_rmw, place_rmw_plain)

C = 256        # codewords per row
W = 128        # output words per row


def make_inputs(seed: int = 0):
    """Codeword placements: disjoint 8-bit fields, one per codeword slot,
    so integer sums equal ORs and every formulation must agree exactly.
    Returns (vals, word, shift), each (1, C) int32 numpy."""
    rng = np.random.RandomState(seed)
    vals = rng.randint(0, 256, size=(1, C)).astype(np.int32)
    word = rng.randint(0, W, size=(1, C)).astype(np.int32)
    shift = (rng.randint(0, 4, size=(1, C)) * 8).astype(np.int32)
    # Keep (word, shift) pairs unique -> disjoint fields.
    key = word * 4 + shift // 8
    _, first = np.unique(key, return_index=True)
    mask = np.zeros((1, C), bool)
    mask[0, first] = True
    vals = np.where(mask, vals, 0)
    return vals, word, shift


def probe(name: str, kernel, plain, args) -> bool:
    got = kernel(*args).cpu().numpy()
    want = plain(*args).cpu().numpy()
    if np.array_equal(got, want):
        print(f"{name}: PASS (kernel == plain)")
        return True
    diff = np.flatnonzero(got[0] != want[0])
    bad = diff[:8]
    print(f"{name}: MISMATCH — {len(diff)}/{W} words differ; first at "
          f"{bad.tolist()}; plain={want[0][bad].tolist()} "
          f"kernel={got[0][bad].tolist()}")
    return False


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bitfield_probes",
                                description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; cpu compares the "
                        "plain versions with themselves)")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("bitfield_probes: no CUDA device (pass --device cpu for the "
              "plain versions)", file=sys.stderr)
        return 1
    if dev.type == "cpu":
        print("NOTE: --device cpu runs the plain versions on both sides; "
              "run this on a CUDA card.")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"torch {torch.__version__}, device {dev} ({name})")
    t = [torch.from_numpy(a).to(dev) for a in make_inputs(0)]
    call = (*t, W)
    ok = True
    ok &= probe("A one-hot product        ", place_dot, place_dot_plain, call)
    ok &= probe("B read-modify-write OR   ", place_rmw, place_rmw_plain, call)
    ok &= probe("C masked lane reduction  ", place_mask, place_mask_plain,
                call)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
