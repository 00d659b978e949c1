"""device_ops_per_frame: the device operations in the traced sub-window
(kernels, copies and sets the profiler saw run there) per program `frame`
span that starts and ends inside it."""

from harness import spans as sp


def read(run):
    spans = sp.window_spans(run)
    frames = sp.named(spans, "frame") if spans else []
    if not frames:
        return None
    return len(run.trace.ops) / len(frames)
