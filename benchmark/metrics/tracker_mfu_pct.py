"""tracker_mfu_pct: the tracker's analytic FLOPs (harness/costs.py, static
branch out, each append's own encoded frames) summed over the appends of
the frames completed in the window, per second of the window, as a share
of the H100's bf16 dense peak."""

from harness import costs


def read(run):
    end_ms = run.seconds * 1e3
    model, slam = run.config["model"], run.config["slam"]
    per = {}
    flops = 0.0
    for ms, enc in zip(run.completions, run.frame_encoded):
        if ms <= end_ms and enc:
            if enc not in per:
                per[enc] = costs.append_flops(model, slam, enc)
            flops += per[enc]
    if not flops:
        return None
    return 100.0 * flops / run.seconds / costs.H100_BF16_FLOPS
