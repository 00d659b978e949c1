"""k1_launches_per_append: launches of K1 (`corr_sample` in the port's
ops.launch_counts()) over the window, per append the window called. The
port launches 4 an append today (one per tracker iteration); a route off
the kernel reads 0 here while k1_roofline_pct goes silent."""


def read(run):
    appends = sum(1 for e in run.frame_encoded if e)
    launches = getattr(run, "launches", None)
    if not appends or launches is None or "corr_sample" not in launches:
        return None
    return launches["corr_sample"] / appends
