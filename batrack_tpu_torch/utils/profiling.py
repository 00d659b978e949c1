"""Per-stage wall-clock timer for the SLAM loop, and the device time of a
repeated call.

PyTorch returns before the GPU finishes, so a stage's host time measures
its enqueue unless the timer synchronizes the device at the end of each
stage (`sync=True`), which serialises the pipeline: turn it on for stage
breakdowns only, never when measuring frames/s. `device_ms` times many
back-to-back calls between two CUDA events instead, which leaves the
pipeline full.
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from collections import defaultdict
from typing import Callable, Dict, Optional

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
