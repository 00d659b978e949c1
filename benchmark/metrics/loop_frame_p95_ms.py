"""loop_frame_p95_ms: the 95th percentile, over every frame that completed in
the window, of the time from the previous frame's completion (the window's
start for the first) to this frame's."""

import numpy as np


def read(run):
    end_ms = run.seconds * 1e3
    times, prev = [], 0.0
    for ms in run.completions:
        if ms > end_ms:
            break
        times.append(ms - prev)
        prev = ms
    return float(np.percentile(times, 95)) if times else None
