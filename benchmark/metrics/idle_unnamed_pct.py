"""idle_unnamed_pct: the share of the device's idle time in the traced
sub-window that no program span other than `frame` covers: idle while the
host runs the loop's own code between the named stages, or the harness's.
Every gap counts, by its overlap with the spans' union."""

from harness import spans as sp


def read(run):
    spans = sp.window_spans(run)
    if spans is None:
        return None
    gaps = run.trace.gaps()
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    named = [(s.start_ns, s.end_ns) for s in spans if s is not None and s.name != "frame"]
    return 100.0 * (idle - sp.covered_ns(gaps, named)) / idle
