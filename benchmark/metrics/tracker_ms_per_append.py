"""tracker_ms_per_append: a CUDA event pair around the injected tracker
callable (MDTrackerAdapter), mean over the window's appends."""


def read(run):
    ms = run.pairs.get("tracker")
    return sum(ms) / len(ms) if ms else None
