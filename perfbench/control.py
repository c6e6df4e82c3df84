"""The readings the correctness limit is set from, for one cell, in one
process: for each seed, a short window of the program (the sound reading)
and a short window with the control in the program's place (the system
kind's ``control``; for ``int8_cnn`` the plain reference derived and run
at int4), each compared with the reference on every output row of the
window, as a run compares them.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 [--seconds 2]

Prints one JSON line a seed and side: ``{"seed", "side", "correct",
"checks"}``.  The benchmark's own runs never run it.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seeds, seconds: float, devices, sides=("program", "control")):
    """Yield ``{"seed", "side", "correct", "checks"}`` for each seed and side."""
    from perfbench import harness

    for seed in seeds:
        for side in sides:
            timed = cell.system.control if side == "control" else None
            r = harness.run_cell(cell, seed, seconds, False, devices, time.perf_counter(),
                                 timed=timed)
            yield {"seed": seed, "side": side, "correct": r.correct, "checks": r.checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--sides", default="program,control")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import harness

    cell = harness.resolve(harness.load_bench(ROOT), args.workload, ROOT)
    sides = tuple(args.sides.split(","))
    # The control takes the place of the whole timed path, mesh included, and
    # runs on the first card alone.
    cards = 1 if sides == ("control",) else cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < cards:
        print(f"{args.workload} needs {cards} CUDA card(s)", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, torch.get_num_threads()))
    devices = [torch.device("cuda", i) for i in range(cards)]
    for line in readings(cell, [int(s) for s in args.seeds.split(",")], args.seconds, devices,
                         sides):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
