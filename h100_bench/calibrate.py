"""The readings the correctness limits are set from, on the card.

    python3 h100_bench/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 7 8 9] [--faults] [--out readings.jsonl]

For each seed, in one process: the program's numbers (sound runs: one
pass over the pool), and for each control seed the control's (the
reference one precision step down, in the program's place).
``--faults`` also reads the faults of the cell's driver planted in the
reference put in the program's place.  Prints one JSON line per reading (and appends it to
``--out``).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] == os.path.dirname(os.path.abspath(__file__)):
    sys.path.pop(0)
sys.path.insert(0, ROOT)

from h100_bench import harness  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", action="store_true")
    p.add_argument("--out")
    args = p.parse_args(argv)
    bench = harness._load_json(ROOT, "BENCHMARK.json")
    cell = harness.load_cell(bench, args.workload)
    harness.set_cache_dirs()
    problem = harness.check_cards(cell.chips)
    if problem:
        raise SystemExit(problem)
    import importlib
    driver = importlib.import_module("h100_bench.drivers." +
                                     cell.traffic["driver"])
    for reading in driver.calibrate(cell, args.seeds, args.control_seeds,
                                    args.faults):
        reading["cell"] = cell.name
        reading["time"] = time.time()
        line = json.dumps(reading)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
