"""The program's spans in a traced run. The port's process tracer
(batrack_tpu_torch/utils/profiling.py::tracer) records while torch.profiler
runs, so in a traced run it holds the spans of the traced sub-window, on
the host's realtime clock that the device trace is read on. A program
without that tracer gives None, and the readers then read nothing. Host
times of these spans are not read: CUPTI's cost per launch inflates them
inside the sub-window, which holds a few frames.

The sums over spans are the benchmark's own, not the program's helpers:
what a metric is computed from stays with the benchmark."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


def window_spans(run) -> Optional[list]:
    """The tracer's spans by index, None for each outside the traced
    sub-window [t0, t1] (or still open); None when the run has no trace
    or the program no tracer or no span in the sub-window."""
    trace = getattr(run, "trace", None)
    if trace is None or not trace.t1:
        return None
    try:
        from batrack_tpu_torch.utils import profiling
    except ImportError:
        return None
    tracer = getattr(profiling, "tracer", None)
    if tracer is None:
        return None
    spans = [s if s is not None and trace.t0 <= s.start_ns and s.end_ns <= trace.t1 else None
             for s in tracer().spans]
    return spans if any(s is not None for s in spans) else None


def named(spans: Sequence, name: str) -> List[int]:
    return [i for i, s in enumerate(spans) if s is not None and s.name == name]


def covered_ns(gaps: Sequence[Tuple[int, int]], intervals: Sequence[Tuple[int, int]]) -> int:
    """How much of the disjoint `gaps` the union of `intervals` covers, by
    overlap: every gap counts, however short."""
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total, k = 0, 0
    for a, b in sorted(gaps):
        while k < len(merged) and merged[k][1] <= a:
            k += 1
        j = k
        while j < len(merged) and merged[j][0] < b:
            total += min(b, merged[j][1]) - max(a, merged[j][0])
            j += 1
    return total
