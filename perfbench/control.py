"""The readings the limits of ``correct`` are set from, at a cell's own
traffic on the card, in one process: the program's sound runs on some
seeds, the control (``harness.control_entry``: the entry at the nearest
lower precision of the stated format) on others, and each fault of
``faults.py`` named by ``--faults`` on the fault seeds. Each run's numbers
compared go to standard output as one JSON line.

    python3 perfbench/control.py --workload <name> --seconds 2 \\
        --program-seeds 1 2 3 ... --control-seeds 7 8 9 \\
        --faults vsearch_skipped --fault-seeds 4 5 6
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import entries, faults, harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--program-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[],
                   choices=sorted(faults.FAULTS) + sorted(faults.WORK_FAULTS))
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    runs = [(s, False, None) for s in args.program_seeds] + [
        (s, True, None) for s in args.control_seeds] + [
        (s, False, f) for f in args.faults for s in args.fault_seeds]
    name = harness.traffic_of(harness.cell_of(
        harness.load_spec(), args.workload)["traffic"])["entry"]
    sound = entries.ENTRIES[name]
    for seed, control, fault in runs:
        entries.ENTRIES[name] = (sound if fault is None
                                 else faults.broken(sound, fault))
        t0 = time.perf_counter()
        r = harness.Cell(args.workload, seed, args.seconds, False,
                         control=control).run(t0)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": control, "fault": fault,
                          "correct": r["correct"],
                          "attempted": r["attempted"],
                          "checks": r["checks"]}), flush=True)
    entries.ENTRIES[name] = sound
    return 0


if __name__ == "__main__":
    sys.exit(main())
