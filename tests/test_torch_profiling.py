"""The port's tracer (batrack_tpu_torch/utils/profiling.py) on the CPU.

- Off, a span is one shared no-op and nothing is recorded; the process
  tracer records while a torch.profiler session runs.
- Nesting: each span's parent index and frame id, the self time as the
  duration minus the union of the children, the tree report and the
  Chrome-trace events.
- The benchmark's overlap attribution of idle gaps to spans
  (benchmark/harness/spans.py::covered_ns), and the self intervals, each
  against a brute-force sweep over integer instants.
- A tiny BATrack run with the real tracker network (plain kernels) and the
  tracer on: the tracker's and the backend's spans and counters, the
  stage spans' self time, and the trajectory bit for bit against a run
  with the tracer off.
- The kernel loader's span and counter, with the build and the library
  load stubbed.
- run_slam's spans.json on the profiler trace's timeline.

No JAX here: the file runs in a few seconds.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from batrack_tpu_torch.ops import cuda_build
from batrack_tpu_torch.slam import BATrack
from batrack_tpu_torch.tracker import MDTrackerAdapter
from batrack_tpu_torch.utils import profiling
from batrack_tpu_torch.utils.config import load_config
from batrack_tpu_torch.utils.profiling import Span, StageTimer, self_intervals, self_ns, tracer
from batrack_tpu_torch.utils.synth import make_scene

_SPEC = importlib.util.spec_from_file_location(
    "bench_harness_spans", Path(__file__).resolve().parents[1] / "benchmark/harness/spans.py")
bench_spans = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(bench_spans)

HT, WD = 48, 64
INTR = np.array([60.0, 60.0, WD / 2, HT / 2], np.float32)
FRAMES = 12
# test_cli_e2e's SMALL_OVERRIDES: the smallest SLAM config of the CPU tests
TINY = [
    "slam.BUFFER_SIZE=32", "slam.PATCHES_PER_FRAME=16",
    "slam.PATCH_GEN=grid_grad_4", "slam.S_slam=4", "slam.num_init=4",
    "slam.kf_stride=2", "slam.REMOVAL_WINDOW=6", "slam.OPTIMIZATION_WINDOW=5",
    "slam.MIN_TRACK_LEN=2", "slam.ITER=2", "slam.BA_EP=0.1",
    "slam.backward_tracking=false",
    "model.S=4", "model.sliding_window_len=4", "model.I=1",
    "model.static_iters=1", "model.interp_shape=[48, 64]",
    "model.space_depth=2", "model.time_depth=2", "model.space_depth_dyn=1",
    "model.time_depth_dyn=1", "model.init_dir=",
    "model.compute_dtype=float32",
]


@pytest.fixture
def process_tracer():
    """The process's tracer, on and empty for the test, off and empty after."""
    tr = tracer()
    tr.reset()
    tr.enabled = True
    yield tr
    tr.enabled = False
    tr.reset()


def test_off_records_nothing():
    for tm in (StageTimer(), tracer()):
        assert not tm.enabled
        a, b = tm.span("a"), tm.span("b", device=True)
        assert a is b is profiling._NO_SPAN
        with a, b:
            tm.count("c", 3)
            tm.add("d", 1.0)
        assert tm.spans == [] and not tm.counters and not tm.totals and not tm.counts


def test_the_process_tracer_follows_the_profiler():
    """Off, it records while a torch.profiler session runs, and only then:
    a profiled stretch of a run carries the program's spans."""
    tr, own = tracer(), StageTimer()
    tr.reset()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with tr.span("profiled"), own.span("own"):
                tr.count("n")
        with tr.span("after"):
            pass
        assert [s.name for s in tr.spans] == ["profiled"] and tr.counters == {"n": 1}
        assert own.spans == []                    # a timer of its own does not follow
        # a new session starts from an empty tracer: sessions do not pile up
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with tr.span("second"):
                pass
        assert [s.name for s in tr.spans] == ["second"] and not tr.counters
        assert dict(tr.counts) == {"second": 1}
        with tr.span("between"):                   # the loop's work between sessions
            pass
        # ... unless a span of the last one is still open: its index stays valid
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
        prof.start()
        with tr.span("outer"):
            prof.stop()
            with tr.span("off"):
                pass
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
            prof.start()
            with tr.span("inner"):
                pass
        prof.stop()
        assert [(s.name, s.parent) for s in tr.spans] == [("outer", -1), ("inner", 0)]
    finally:
        tr.reset()


def test_nesting_parent_frame_and_self_time():
    tm = StageTimer(enabled=True)
    tm.frame = (7, 3)
    with tm.span("frame"):
        with tm.span("stage"):
            with tm.span("leaf"):
                pass
            with tm.span("leaf"):
                pass
        tm.count("steps", 2)
    tm.frame = None
    with tm.span("other"):
        pass
    names = [s.name for s in tm.spans]
    assert names == ["frame", "stage", "leaf", "leaf", "other"]
    assert [s.parent for s in tm.spans] == [-1, 0, 1, 1, -1]
    assert [s.frame for s in tm.spans] == [(7, 3)] * 4 + [None]
    assert tm.counters["steps"] == 2 and tm.counts["leaf"] == 2
    for s in tm.spans:
        assert s.start_ns <= s.end_ns
    assert tm.spans[1].start_ns <= tm.spans[2].start_ns <= tm.spans[3].end_ns <= \
        tm.spans[1].end_ns

    # self time: the duration minus the union of the children (overlapping
    # children count once, a child's part outside its parent not at all)
    spans = [Span("p", 0, 100, -1, None), Span("c", 10, 40, 0, None),
             Span("c", 30, 50, 0, None), Span("d", 90, 120, 0, None),
             Span("g", 12, 20, 1, None)]
    assert self_ns(spans) == [100 - 40 - 10, 30 - 8, 20, 30, 8]

    report = tm.report(tree=True)
    lines = report.splitlines()
    assert lines[0].split()[0] == "stage"          # the table as before
    tree = lines[lines.index("") + 1:]
    assert [ln.split()[0] for ln in tree[1:]] == ["frame", "stage", "leaf", "other"]
    assert tree[3].startswith("    leaf") and tree[3].split()[1] == "2"
    events = profiling.chrome_events(tm.spans, base_ns=tm.spans[0].start_ns)
    assert events[0]["ts"] == 0.0 and events[0]["args"]["frame"] == [7, 3]
    assert [e["args"]["parent"] for e in events] == [-1, 0, 1, 1, -1]


@pytest.mark.parametrize("seed", range(4))
def test_covered_matches_a_sweep(seed):
    rng = np.random.default_rng(seed)
    edges = np.sort(rng.choice(1000, size=40, replace=False))
    gaps = [(int(a), int(b)) for a, b in zip(edges[::2], edges[1::2])]
    starts = rng.integers(0, 1000, size=25)
    intervals = [(int(a), int(a + rng.integers(0, 120))) for a in starts]
    intervals += [(5, 5), (400, 380)]            # empty ones cover nothing
    instants = set()
    for a, b in gaps:
        for t in range(a, b):
            if any(s <= t < e for s, e in intervals):
                instants.add(t)
    covered_ns = bench_spans.covered_ns
    assert covered_ns(gaps, intervals) == len(instants)
    assert covered_ns(gaps, []) == 0
    assert covered_ns(gaps, [(0, 1000)]) == sum(b - a for a, b in gaps)


@pytest.mark.parametrize("seed", range(4))
def test_self_intervals_match_a_sweep(seed):
    """A parent's self intervals are the instants of it that no child
    covers, children overlapping one another or reaching outside it."""
    rng = np.random.default_rng(100 + seed)
    spans = [Span("p", 100, 900, -1, None)]
    for _ in range(12):
        a = int(rng.integers(50, 950))
        spans.append(Span("c", a, a + int(rng.integers(0, 150)), 0, None))
    own = self_intervals(spans)
    instants = [t for t in range(100, 900)
                if not any(s.start_ns <= t < s.end_ns for s in spans[1:])]
    assert sum(b - a for a, b in own[0]) == len(instants) == self_ns(spans)[0]
    assert all(a < b for a, b in own[0])
    assert sorted(own[0]) == own[0] and all(
        b0 < a1 for (_, b0), (a1, _) in zip(own[0], own[0][1:]))
    assert [t for a, b in own[0] for t in range(a, b)] == instants
    assert own[1:] == [[(s.start_ns, s.end_ns)] if s.end_ns > s.start_ns else []
                       for s in spans[1:]]


def _run(scene, on: bool):
    """A tiny BATrack run; returns (trajectory, the tracer's spans and
    counters when on)."""
    images, depths, _ = scene
    cfg = load_config(None, TINY)
    tr = tracer()
    tr.reset()
    tr.enabled = on
    try:
        slam = BATrack(cfg, HT, WD, seed=0, device="cpu")
        slam.tracker = MDTrackerAdapter(cfg.model, seed=0, device="cpu")
        for t in range(FRAMES):
            slam(t, images[t], depths[t], INTR)
        traj = slam.terminate()
        return traj, list(tr.spans), dict(tr.counters)
    finally:
        tr.enabled = False
        tr.reset()


@pytest.fixture(scope="module")
def scene():
    return make_scene(FRAMES, HT, WD, INTR)


def test_tiny_run_spans_and_counters(scene):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        (poses_on, ts_on), spans, counters = _run(scene, True)
        (poses_off, ts_off), none, _ = _run(scene, False)
    finally:
        torch.set_num_threads(n)
    assert none == []
    np.testing.assert_array_equal(poses_on, poses_off)
    np.testing.assert_array_equal(ts_on, ts_off)

    def under(i):
        """Names of every span below span i."""
        out, stack = set(), [i]
        while stack:
            k = stack.pop()
            for j, s in enumerate(spans):
                if s.parent == k:
                    out.add(s.name)
                    stack.append(j)
        return out

    cfg = load_config(None, TINY)
    frames = [i for i, s in enumerate(spans) if s.name == "frame"]
    assert len(frames) == FRAMES
    assert [spans[i].frame[1] for i in frames] == list(range(FRAMES))
    appends = [i for i, s in enumerate(spans) if s.name == "tracker"]
    assert len(appends) == len(range(0, FRAMES, cfg.slam.kf_stride))
    for i in appends:
        assert {"tracker.encode", "tracker.corr", "tracker.former"} <= under(i)
        assert spans[spans[i].parent].name == "frame"
    for s in spans:
        if s.name == "tracker.pos_table":
            assert spans[s.parent].name == "tracker.pos_embed"
    assert [s.name for s in spans].count("tracker.pos_table") == len(appends)
    assert counters["tracker.windows"] == len(appends)
    # the reuse hint: once the window is full an append encodes its new frames only
    assert len(appends) < counters["tracker.encoded_frames"] < cfg.model.S * len(appends)

    updates = [i for i, s in enumerate(spans) if s.name == "ba_update"]
    steps = [s for s in spans if s.name == "ba.step"]
    assert updates and len(steps) == cfg.slam.ITER * 2 * len(updates) == counters["ba.steps"]
    for i in updates:
        assert {"ba.step", "ba.linearize", "ba.assemble", "ba.solve",
                "ba.point_cloud"} <= under(i)
    assert [s.name for s in spans].count("sequence.init") == 1
    assert [s.name for s in spans].count("sequence.terminate") == 1
    assert [s.name for s in spans].count("tracker.init") == 1

    own = self_ns(spans)
    for name in ("tracker", "ba_update"):
        idx = [i for i, s in enumerate(spans) if s.name == name]
        total = sum(spans[i].end_ns - spans[i].start_ns for i in idx)
        assert sum(own[i] for i in idx) <= 0.05 * total, name


def test_kernel_load_span_and_counter(process_tracer, monkeypatch):
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "_build", lambda items: {})
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: object())
    cuda_build.load("corr_sample", RADIUS=2)
    cuda_build.load("corr_sample", RADIUS=2)      # loaded: no span, no count
    assert [s.name for s in process_tracer.spans] == ["setup.kernels"]
    assert process_tracer.counters["cuda_build.loads"] == 1


def test_cli_writes_spans_on_the_profilers_timeline(process_tracer, tmp_path):
    """run_slam's profile_dir: spans.json beside trace.json, on its time
    base: a profiler mark recorded inside a span falls inside it."""
    import json
    import time

    from batrack_tpu_torch.cli import run_slam

    prof, since = run_slam._start_profile(), time.time_ns()
    with process_tracer.span("frame"):
        time.sleep(0.002)
        with torch.profiler.record_function("mark"):
            torch.ones(8).sum()
        time.sleep(0.002)
    run_slam._stop_profile(prof, str(tmp_path), True, process_tracer, since)
    mark = next(e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
                if e.get("name") == "mark")
    (span,) = json.loads((tmp_path / "spans.json").read_text())["traceEvents"]
    assert span["name"] == "frame"
    assert span["ts"] <= float(mark["ts"]) <= span["ts"] + span["dur"]
