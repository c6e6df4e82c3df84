"""Run one cell of BENCHMARK.json once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and ``checks`` last); the numbers
compared with the plain reference are also the last lines of standard
error.  Exits non-zero, printing no result, without the cards the cell
asks for, without the port, or if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Every build and kernel cache at a fixed place inside the checkout.
    cache = ROOT / "build" / "perfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from perfbench import harness

    cell = harness.resolve(harness.load_bench(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found {found}",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the port (src/repro_torch) is not in this checkout", file=sys.stderr)
        return 3
    torch.set_num_threads(min(4, torch.get_num_threads()))
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), devices, T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: nothing on this path may import JAX "
              "or the JAX package", file=sys.stderr)
        return 4
    from repro_torch.kernels import launch_counts

    print(f"kernel launches and nvcc runs of this process: {launch_counts()}", flush=True)
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
