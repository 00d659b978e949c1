"""The device trace of a traced run: torch.profiler (CUPTI) over a steady
sub-window of the measured window, never the whole of it (the loop
launches thousands of kernels a frame). What it keeps is each device
operation's name and interval; nothing is written to disk."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

Interval = Tuple[str, int, int]  # name, start ns, end ns (the host's realtime clock)


class DeviceTrace:
    """Profiles whole frames of one stream, from the first frame that starts
    `start_s` into the window to the first that starts `length_s` later.
    The stream's own thread starts and stops the profiler between frames."""

    def __init__(self, start_s: float, length_s: float):
        self.start_s, self.length_s = start_s, length_s
        self.ops: List[Interval] = []
        self.t0 = self.t1 = 0
        self._prof = None
        self.done = False

    @staticmethod
    def _profiler():
        return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])

    def warm(self):
        """Set-up: the profiler's first start initialises CUPTI, which takes
        seconds; done here, the start inside the window is short."""
        prof = self._profiler()
        prof.start()
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.stop()

    def between_frames(self, window_start: float):
        """Called by the stream before each window frame."""
        if self.done:
            return
        now = time.perf_counter() - window_start
        if self._prof is None and now >= self.start_s:
            self._prof = self._profiler()
            self._prof.start()
            self.t0 = time.time_ns()
        elif self._prof is not None and now >= self.start_s + self.length_s:
            self.finish()

    def finish(self):
        """Stops the profiler (after the last frame it covers has been
        enqueued) and keeps the device operations."""
        if self._prof is None or self.done:
            return
        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self._prof.stop()
        self.done = True
        cuda = torch.autograd.DeviceType.CUDA
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == cuda and e.duration_ns() > 0:
                a = max(e.start_ns(), self.t0)
                b = min(e.start_ns() + e.duration_ns(), self.t1)
                if b > a:
                    self.ops.append((e.name(), a, b))
        self._prof = None

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_s(self) -> float:
        """Seconds in which any operation ran on the device: the union of
        the operations' intervals, so that overlapping streams count once."""
        total, end = 0, None
        for _, s, t in sorted(self.ops, key=lambda o: o[1]):
            if end is None or s > end:
                total += t - s
                end = t
            elif t > end:
                total += t - end
                end = t
        return total / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        """The device's idle intervals inside the sub-window."""
        out, end = [], self.t0
        for _, s, t in sorted(self.ops, key=lambda o: o[1]):
            if s > end:
                out.append((end, s))
            end = max(end, t)
        if self.t1 > end:
            out.append((end, self.t1))
        return out

    def by_name(self, key: str) -> List[float]:
        """Durations (s) of the operations whose name holds `key`."""
        return [(t - s) / 1e9 for n, s, t in self.ops if key in n]

    def top_ops(self, k: int = 10) -> List[list]:
        tot: Dict[str, float] = defaultdict(float)
        for n, s, t in self.ops:
            tot[n] += (t - s) / 1e9
        return [[n, v] for n, v in sorted(tot.items(), key=lambda x: -x[1])[:k]]


def idle_by_host(gaps, spans: List[tuple], k: int = 10, longest: int = 20000) -> List[list]:
    """The idle gaps summed by what the host threads were doing at each
    gap's middle: the names of the benchmark's spans open there (tracker,
    ba_update, or only `frame`: the rest of the loop's host work), joined.
    The `longest` gaps are named one by one, the rest summed as `short`."""
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])     # longest first
    if gaps:
        first, last = min(g[0] for g in gaps), max(g[1] for g in gaps)
        spans = [sp for sp in spans if sp[2] >= first and sp[1] <= last]
    tot: Dict[str, float] = defaultdict(float)
    for s, t in gaps[longest:]:
        tot["short"] += (t - s) / 1e9
    for s, t in gaps[:longest]:
        mid = (s + t) // 2
        open_ = sorted({name for name, a, b in spans if a <= mid <= b and name != "frame"})
        if not open_:
            open_ = ["loop"] if any(a <= mid <= b for _, a, b in spans) else ["between_frames"]
        tot["+".join(open_)] += (t - s) / 1e9
    return [[n, v] for n, v in sorted(tot.items(), key=lambda x: -x[1])[:k]]
