"""host_ms_per_frame: the host's time in one frame call (BATrack.__call__
and a sequence's turnover), perf_counter around the call with no sync, mean
over every window frame."""


def read(run):
    ms = run.host_ms
    return sum(ms) / len(ms) if ms else None
