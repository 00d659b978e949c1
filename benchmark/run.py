"""The benchmark of batrack_tpu_torch: one cell of BENCHMARK.json, run once.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's cards. It
builds the port's kernels into build/kernels/ (the first run in a checkout
compiles them), makes the weights and frames from the seed, warms the
cell's stream up, measures for --seconds, then checks what the timed path
produced against the plain reference in benchmark/reference/. The last
line of standard output is one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
ones), device, with --trace 1 breakdown, and last `check`: each number
compared with its limit. Standard error ends with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # one process with few threads: the host's BLAS pools stay at one thread
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, BENCH_DIR)
    sys.path.insert(1, os.path.dirname(BENCH_DIR))
    from harness import runner, spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          log=lambda d: print(json.dumps(d), file=sys.stderr, flush=True))
    readings, found = out.pop("_readings"), out.pop("_found")
    out.pop("_run")
    out.pop("_program_readings")
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}", file=sys.stderr)
        return 3
    print("readings: " + json.dumps(readings), file=sys.stderr)
    for name, c in out["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
