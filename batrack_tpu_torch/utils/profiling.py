"""The port's tracer: named spans and counters inside the SLAM loop, the
tracker and the backend, and the device time of a repeated call.

A span records its name, its start and end on the host's realtime clock
(`time.time_ns()`, the clock torch.profiler's device intervals are read on,
so the spans and a device trace share one timeline), the index of the span
that encloses it and the frame it belongs to (`frame`, the (sequence,
counter) id BATrack sets on entering a frame). No span synchronizes:
PyTorch returns before the GPU finishes, so a span's host time measures the
enqueue. A stage span can also record a CUDA event pair on the current
stream (`device=True`), read by `resolve()` once the caller has
synchronized. `sync=True` synchronizes the device at the end of each span,
which serialises the pipeline: bring-up stage breakdowns use it, never a
measurement of frames/s. `device_ms` times many back-to-back calls between
two CUDA events instead, which leaves the pipeline full.

One tracer serves the process (`tracer()`): BATrack's default timer, and
the tracker, the backend and the kernel builds record into it. It records
while it is enabled, and while a torch.profiler session runs, so that a
profiled stretch of a run carries the program's spans; the first span of
each such session forgets what the tracer held, so that it holds one
session's spans at most (sessions with no span between them count as
one). Off, `span` returns one shared no-op context manager and `count`
does nothing.
"""

from __future__ import annotations

import subprocess
import time
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int                # index of the enclosing span in `spans`; -1 at the top
    frame: Optional[tuple]     # (sequence, counter) of the frame it ran in, else None


class _NoSpan:
    """The span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _NoProfiler:
    _is_profiler_enabled = False


# torch's own flag for a running profiler session (set by its start and
# stop); a torch without it never follows the profiler
_PROFILER = (_autograd_profiler if hasattr(_autograd_profiler, "_is_profiler_enabled")
             else _NoProfiler)


class _OpenSpan:
    __slots__ = ("timer", "name", "device", "index", "frame", "start", "event")

    def __init__(self, timer: "StageTimer", name: str, device: bool):
        self.timer, self.name, self.device = timer, name, device

    def __enter__(self):
        tm = self.timer
        self.index = len(tm.spans)
        tm.spans.append(None)            # filled at the exit, children point here
        tm._stack.append(self.index)
        self.frame = tm.frame
        if self.device:
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        tm = self.timer
        if tm.sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        if self.device:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            tm._pending.append((self.index, self.event, end))
        end_ns = time.time_ns()
        stack = tm._stack
        stack.pop()
        tm.spans[self.index] = Span(self.name, self.start, end_ns, stack[-1] if stack else -1,
                                    self.frame)
        tm.totals[self.name] += (end_ns - self.start) / 1e9
        tm.counts[self.name] += 1
        return False


class StageTimer:
    """Spans, counters and host seconds per span name (module note).

    `totals` and `counts` hold host seconds and calls per name; `spans`
    each span as a `Span`, in the order they opened; `device_ms` the
    device milliseconds of each `device=True` span by its index, once
    `resolve()` has read them; `counters` the counts of `count()`.
    follow_profiler: record also while a torch.profiler session runs,
    from an empty tracer at each session's first span (module note)."""

    def __init__(self, enabled: bool = False, sync: bool = False,
                 follow_profiler: bool = False):
        self.enabled = enabled
        self.sync = sync
        self.follow_profiler = follow_profiler
        self.frame: Optional[tuple] = None
        self._following = False          # recording for a profiler session now
        self.reset()

    def reset(self) -> None:
        """Forget every span, total and counter."""
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, int] = defaultdict(int)
        self.spans: List[Optional[Span]] = []
        self.device_ms: Dict[int, float] = {}
        self._pending: List[tuple] = []
        self._stack: List[int] = []

    @property
    def active(self) -> bool:
        """Whether spans and counters are recorded now."""
        return self.enabled or (self.follow_profiler and self._follow())

    def _follow(self) -> bool:
        """Whether a profiler session runs; at a session's first call the
        tracer forgets the spans, totals and counters it held (unless a
        span is still open: its index must stay valid)."""
        if not _PROFILER._is_profiler_enabled:
            if self._following:
                self._following = False
            return False
        if not self._following:
            self._following = True
            if not self._stack:
                self.reset()
        return True

    def span(self, name: str, device: bool = False):
        """A context manager that records one span of `name`; with `device`
        also a CUDA event pair on the current stream (only where the work
        runs on a CUDA device)."""
        if self.enabled or (self.follow_profiler and self._follow()):
            return _OpenSpan(self, name, device)
        return _NO_SPAN

    def count(self, name: str, n: int = 1) -> None:
        if self.active:
            self.counters[name] += n

    def add(self, name: str, seconds: float) -> None:
        """Count one call of `name` timed by the caller."""
        if self.active:
            self.totals[name] += seconds
            self.counts[name] += 1

    def resolve(self) -> Dict[int, float]:
        """Reads the event pairs of the device spans whose end has been
        reached on the device (after the caller's synchronize) into
        `device_ms`; pairs still running stay pending."""
        pending = []
        for index, start, end in self._pending:
            if end.query():
                self.device_ms[index] = start.elapsed_time(end)
            else:
                pending.append((index, start, end))
        self._pending = pending
        return self.device_ms

    def ms_per_call(self) -> Dict[str, float]:
        return {k: self.totals[k] / self.counts[k] * 1000.0 for k in self.totals}

    def report(self, tree: bool = False) -> str:
        """Host seconds, calls and ms per call by name; with `tree` also the
        span tree (span_tree)."""
        lines = [f"{'stage':>20} | {'total s':>9} | {'calls':>6} | {'ms/call':>8}"]
        for name in sorted(self.totals, key=lambda k: -self.totals[k]):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:>20} | {t:9.3f} | {c:6d} | {t / c * 1000:8.1f}")
        if tree and any(s is not None for s in self.spans):
            lines += ["", span_tree(self.spans, self.device_ms)]
        return "\n".join(lines)


_TRACER = StageTimer(follow_profiler=True)


def tracer() -> StageTimer:
    """The process's tracer (module note)."""
    return _TRACER


# ---------------------------------------------------------------------------
# reading spans

def self_intervals(spans: Sequence[Optional[Span]]) -> List[List[Tuple[int, int]]]:
    """Each span's self intervals (ns pairs, in order): its interval less
    the union of its children's. Spans still open (None) have none."""
    children: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for s in spans:
        if s is not None and s.parent >= 0:
            children[s.parent].append((s.start_ns, s.end_ns))
    out = []
    for i, s in enumerate(spans):
        own: List[Tuple[int, int]] = []
        if s is not None:
            a = s.start_ns
            for c0, c1 in sorted(children[i]):
                if c0 > a:
                    own.append((a, min(c0, s.end_ns)))
                a = max(a, c1)
            if a < s.end_ns:
                own.append((a, s.end_ns))
        out.append(own)
    return out


def self_ns(spans: Sequence[Optional[Span]]) -> List[int]:
    """Each span's self time, ns: its duration less the part its children
    cover (0 for spans still open)."""
    return [sum(b - a for a, b in own) for own in self_intervals(spans)]


def span_tree(spans: Sequence[Optional[Span]], device_ms: Optional[Dict[int, float]] = None,
              ) -> str:
    """The spans summed by their path of names from the top, one line per
    path, indented by depth: calls, host ms, self ms and, for spans with
    an event pair, device ms."""
    device_ms = device_ms or {}
    selfs = self_ns(spans)
    paths: Dict[int, tuple] = {}
    first: Dict[tuple, int] = {}       # each path's first span: the rows keep that order
    rows: Dict[tuple, List[float]] = {}
    for i, s in enumerate(spans):
        if s is None:
            continue
        path = paths[s.parent] + (s.name,) if s.parent in paths else (s.name,)
        paths[i] = path
        first.setdefault(path, i)
        row = rows.setdefault(path, [0, 0.0, 0.0, 0.0, 0])
        row[0] += 1
        row[1] += (s.end_ns - s.start_ns) / 1e6
        row[2] += selfs[i] / 1e6
        if i in device_ms:
            row[3] += device_ms[i]
            row[4] += 1
    lines = [f"{'span':<40} {'calls':>7} {'host ms':>11} {'self ms':>11} {'device ms':>11}"]
    for path in sorted(rows, key=lambda p: [first[p[:d]] for d in range(1, len(p) + 1)]):
        calls, host, own, dev, ndev = rows[path]
        label = "  " * (len(path) - 1) + path[-1]
        lines.append(f"{label:<40} {calls:7d} {host:11.1f} {own:11.1f} "
                     f"{(f'{dev:11.1f}' if ndev else ''):>11}")
    return "\n".join(lines)


def chrome_events(spans: Sequence[Optional[Span]], base_ns: int = 0, start_ns: int = 0,
                  end_ns: Optional[int] = None) -> List[dict]:
    """The spans that overlap [start_ns, end_ns] as Chrome-trace complete
    events, microseconds from `base_ns` (a torch.profiler trace's
    baseTimeNanoseconds, so that both open on one timeline)."""
    out = []
    for i, s in enumerate(spans):
        if s is None or s.end_ns < start_ns or (end_ns is not None and s.start_ns > end_ns):
            continue
        out.append({"name": s.name, "ph": "X", "ts": (s.start_ns - base_ns) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3, "pid": "program spans", "tid": 0,
                    "args": {"index": i, "parent": s.parent,
                             "frame": list(s.frame) if s.frame is not None else None}})
    return out


# ---------------------------------------------------------------------------

def device_ms(fn: Callable[[], object], reps: int, warmup: int = 2, device="cuda") -> float:
    """ms per call of `fn` over `reps` back-to-back calls after `warmup`
    calls. On a CUDA device the time is the device's, between two CUDA
    events around the reps; on the CPU it is perf_counter's."""
    for _ in range(warmup):
        fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1000.0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_record(device) -> Dict[str, Optional[str]]:
    """What a measurement ran on, for its output line: the device's type
    and name and, on CUDA, nvidia-smi's name and power limit for it (a
    card set below its full power limit runs slower under load)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"type": dev.type, "name": dev.type, "smi": None}
    index = torch.cuda.current_device() if dev.index is None else dev.index
    lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip().splitlines()
    return {"type": "cuda", "name": torch.cuda.get_device_name(index),
            "smi": lines[index] if index < len(lines) else lines[0]}
