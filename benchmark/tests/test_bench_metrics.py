"""The readers: loop_frame_p95_ms over every frame of the window, moved by one
stall; loop_frames_per_s counting only frames complete in the window; the
launch counts per append."""

from types import SimpleNamespace

import bench_paths  # noqa: F401
import numpy as np
import pytest

from harness import spec


def run_of(completions, seconds=10.0):
    return SimpleNamespace(seconds=seconds, completions=completions)


def test_p95_is_over_all_frames():
    # 100 frames of 100 ms, then 20 of 500 ms
    c = list(np.cumsum([100.0] * 100 + [500.0] * 20))
    p95 = spec.metric_reader("loop_frame_p95_ms")(run_of(c, seconds=30.0))
    assert p95 == pytest.approx(np.percentile([100.0] * 100 + [500.0] * 20, 95))


def test_one_stall_moves_p95():
    steady = list(np.arange(1, 321) * 100.0)
    # 20 of 320 frames wait 900 ms longer: over the 5 % tail
    stalled = list(np.cumsum([100.0] * 150 + [1000.0] * 20 + [100.0] * 150))
    read = spec.metric_reader("loop_frame_p95_ms")
    assert read(run_of(steady, seconds=32.0)) == pytest.approx(100.0)
    assert read(run_of(stalled, seconds=60.0)) == pytest.approx(1000.0)


def test_frames_after_the_window_do_not_count():
    c = [100.0, 900.0, 1000.0, 1000.5, 1500.0]
    assert spec.metric_reader("loop_frames_per_s")(run_of(c, seconds=1.0)) == 3.0
    assert spec.metric_reader("loop_frame_p95_ms")(run_of(c, seconds=1.0)) == pytest.approx(
        np.percentile([100.0, 800.0, 100.0], 95))


@pytest.mark.parametrize("name,counter", [("k1_launches_per_append", "corr_sample"),
                                          ("k2_launches_per_append", "fused_qkv_attention")])
def test_launches_are_per_append(name, counter):
    run = SimpleNamespace(frame_encoded=[12, 0, 2, 0, 2], launches={counter: 72})
    assert spec.metric_reader(name)(run) == 24.0
    run.launches = {}
    assert spec.metric_reader(name)(run) is None
