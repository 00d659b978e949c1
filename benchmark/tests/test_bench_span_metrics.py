"""The readers of the program's spans on synthetic runs: a traced
sub-window with device operations, and the port's tracer holding spans
inside and outside it. A program without the tracer (an older checkout)
reads nothing."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import bench_paths  # noqa: F401
import pytest

from batrack_tpu_torch.utils import profiling
from batrack_tpu_torch.utils.profiling import Span
from harness import spec, trace

MS = 1_000_000   # ns
_SPEC = importlib.util.spec_from_file_location(
    "torch_span_report", Path(__file__).resolve().parents[2] / "scripts/torch_span_report.py")
span_report = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(span_report)


def synthetic_run():
    """A 100 ms sub-window [1000, 1100] ms: two frames, one with an append
    (encode 10 ms, corr 5, former 20 of a 50 ms tracker span) and one with
    an update (30 ms); the device busy in four operations."""
    tr = trace.DeviceTrace(0.0, 1.0)
    tr.t0, tr.t1 = 1000 * MS, 1100 * MS
    tr.ops = [("k", 1000 * MS, 1010 * MS), ("k", 1020 * MS, 1030 * MS),
              ("k", 1060 * MS, 1070 * MS), ("k", 1075 * MS, 1080 * MS)]
    spans = [
        Span("frame", 990 * MS, 999 * MS, -1, (0, 1)),          # before the sub-window
        Span("frame", 1000 * MS, 1055 * MS, -1, (0, 2)),
        Span("tracker", 1002 * MS, 1052 * MS, 1, (0, 2)),
        Span("tracker.window", 1002 * MS, 1014 * MS, 2, (0, 2)),
        Span("tracker.encode", 1003 * MS, 1013 * MS, 3, (0, 2)),
        Span("tracker.corr", 1015 * MS, 1020 * MS, 2, (0, 2)),
        Span("tracker.former", 1025 * MS, 1045 * MS, 2, (0, 2)),
        Span("frame", 1056 * MS, 1099 * MS, -1, (0, 3)),
        Span("ba_update", 1060 * MS, 1090 * MS, 7, (0, 3)),
        Span("ba_update", 1200 * MS, 1300 * MS, -1, (0, 4)),     # after it
    ]
    return SimpleNamespace(trace=tr), spans


@pytest.fixture
def run(monkeypatch):
    r, spans = synthetic_run()
    monkeypatch.setattr(profiling.tracer(), "spans", spans)
    return r


def test_tracker_glue_and_former():
    """The span report's host times over a window (no registered reader:
    inside the traced sub-window CUPTI inflates them)."""
    _, spans = synthetic_run()
    got = span_report.host_ms(spans, (1000 * MS, 1100 * MS))
    # 50 ms of tracker less 10 + 5 + 20 ms in the heavy spans
    assert got["tracker_glue_ms_per_append"] == pytest.approx(15.0)
    assert got["tracker_former_ms_per_append"] == pytest.approx(20.0)


def test_ba_host_is_the_window_updates():
    _, spans = synthetic_run()
    assert span_report.host_ms(spans, (1000 * MS, 1100 * MS))["ba_host_ms_per_update"] == \
        pytest.approx(30.0)
    assert span_report.host_ms(spans, (0, 1300 * MS))["ba_host_ms_per_update"] == \
        pytest.approx(65.0)
    assert set(span_report.host_ms(spans, (0, 1)).values()) == {None}


def test_idle_unnamed_counts_every_gap_by_overlap(run):
    # idle: 1010-1020, 1030-1060, 1070-1075, 1080-1100 = 65 ms; the spans
    # below `frame` cover 1010-1020, 1030-1052, 1070-1075, 1080-1090 = 47
    assert run.trace.gaps() == [(1010 * MS, 1020 * MS), (1030 * MS, 1060 * MS),
                                (1070 * MS, 1075 * MS), (1080 * MS, 1100 * MS)]
    assert spec.metric_reader("idle_unnamed_pct")(run) == pytest.approx(100.0 * 18 / 65)


def test_device_ops_per_frame_inside_the_window(run):
    assert spec.metric_reader("device_ops_per_frame")(run) == pytest.approx(4 / 2)


NAMES = ("idle_unnamed_pct", "device_ops_per_frame")


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read(name, monkeypatch):
    r, spans = synthetic_run()
    read = spec.metric_reader(name)
    assert read(SimpleNamespace(trace=None)) is None              # untraced
    monkeypatch.setattr(profiling.tracer(), "spans", [])
    assert read(r) is None                                          # tracer off
    monkeypatch.delattr(profiling, "tracer")
    assert read(r) is None                                          # no tracer
