"""The harness finds a cell's configuration, traffic and metrics by the
names BENCHMARK.json gives them."""

import json
from types import SimpleNamespace

import bench_paths  # noqa: F401
import pytest

from harness import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_pieces_found_by_name(workload):
    cell = spec.load_cell(workload)
    w = {x["name"]: x for x in BENCH["workloads"]}[workload]
    assert cell.config["name"] == w["config"]
    assert cell.traffic["lengths"] and cell.traffic["entry_min"] <= cell.traffic["entry_max"]
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


@pytest.mark.parametrize("name", METRICS)
def test_every_metric_has_a_reader_that_reads_nothing_from_an_empty_run(name):
    empty = SimpleNamespace(seconds=10.0, completions=[], host_ms=[], frame_encoded=[], pairs={},
                            trace=None, launches={}, peak_bytes=0, setup_s=None,
                            config=spec.load_cell(CELLS[0]).config)
    assert spec.metric_reader(name)(empty) is None


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        spec.load_cell("no.such.cell")


def test_a_new_metric_file_is_found(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "new_metric.py").write_text("def read(run):\n    return 7.0\n")
    monkeypatch.setattr(spec, "BENCH_DIR", tmp_path)
    assert spec.read_metrics([{"name": "new_metric", "unit": "s"}], None) == {
        "new_metric": {"value": 7.0, "unit": "s"}}
