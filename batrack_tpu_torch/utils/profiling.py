"""Per-stage wall-clock timer for the SLAM loop.

PyTorch returns before the GPU finishes, so a stage's host time measures
its enqueue unless the timer synchronizes the device at the end of each
stage (`sync=True`), which serialises the pipeline: turn it on for stage
breakdowns only, never when measuring frames/s.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch


class StageTimer:
    """Accumulates wall time per named stage."""

    def __init__(self, enabled: bool = False, sync: bool = False):
        self.enabled = enabled
        self.sync = sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def timed(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and torch.cuda.is_available():
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def add(self, name: str, seconds: float) -> None:
        """Count one call of `name` timed by the caller."""
        if self.enabled:
            self.totals[name] += seconds
            self.counts[name] += 1

    def ms_per_call(self) -> Dict[str, float]:
        return {k: self.totals[k] / self.counts[k] * 1000.0 for k in self.totals}

    def report(self) -> str:
        lines = [f"{'stage':>20} | {'total s':>9} | {'calls':>6} | {'ms/call':>8}"]
        for name in sorted(self.totals, key=lambda k: -self.totals[k]):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:>20} | {t:9.3f} | {c:6d} | {t / c * 1000:8.1f}")
        return "\n".join(lines)
