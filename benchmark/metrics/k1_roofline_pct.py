"""k1_roofline_pct: K1's least time at its call's shape (harness/costs.py)
over the mean device time of `corr_sample_kernel` in the traced
sub-window."""

from harness import costs


def read(run):
    if run.trace is None:
        return None
    durs = run.trace.by_name("corr_sample_kernel")
    if not durs:
        return None
    m, s = run.config["model"], run.config["slam"]
    N = s["S_slam"] // s["kf_stride"] * s["PATCHES_PER_FRAME"]
    least = costs.k1_cost(m["S"], N, m["latent_dim"], costs.pyramid_shapes(m),
                          m["corr_radius"])["least_s"]
    return 100.0 * least / (sum(durs) / len(durs))
