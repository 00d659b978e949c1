"""Readings that set a cell's limits: over several seeds in one process, a
run of the cell whose check judges the control (the reference one
precision below the configuration's, in the program's place: the tracker
in float8, the backend's Gauss-Newton steps in TF32) and, from the same
run, the program's readings, at the cell's own size and load over a short
window.

    python benchmark/control.py --workload <name> --seeds 11,12,13 --seconds 8

Prints one JSON line per seed: `correct` (the control's, at the committed
limits: false is what the limits are for), the control's readings and the
program's. The benchmark's own runs never run the control."""

from __future__ import annotations

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=8.0)
    args = parser.parse_args(argv)
    sys.path.insert(0, BENCH_DIR)
    sys.path.insert(1, os.path.dirname(BENCH_DIR))
    from harness import runner, spec

    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = runner.run_cell(cell, seed, args.seconds, False, control=True,
                              log=lambda d: print(json.dumps(d), file=sys.stderr, flush=True))
        print(json.dumps({"seed": seed, "correct": out["correct"], "control": out["_readings"],
                          "program": out["_program_readings"], "metrics": out["metrics"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
