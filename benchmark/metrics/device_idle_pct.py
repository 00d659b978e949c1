"""device_idle_pct: 100 minus the card's busy share over the traced
sub-window: the union of every device operation's interval, all streams
together, over the sub-window's length."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
