"""Finds a cell's pieces by the names BENCHMARK.json gives them: the
configuration file, the traffic mix under benchmark/traffic/<name>.json and
one reader per metric under benchmark/metrics/<name>.py. Adding a cell, a
mix or a metric adds files and entries; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List, NamedTuple

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]   # the metrics a --trace 0 run reports here
    per_layer: List[dict]    # the metrics a --trace 1 run reports here


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench_file: Path = ROOT / "BENCHMARK.json") -> Cell:
    spec = json.loads(bench_file.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(workload, w["chips"], config, traffic,
                [m for m in spec["end_to_end"] if _applies(m, workload)],
                [m for m in spec["per_layer"] if _applies(m, workload)])


def metric_reader(name: str):
    """benchmark/metrics/<name>.py, loaded by path: its read(run) gives the
    metric's value, or None where the run holds nothing to read."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def read_metrics(metrics: List[dict], run) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
