"""k2_roofline_pct: K2's least time for the tracker's packed (S, N, 3C)
space-attention call (harness/costs.py) over the mean device time of
`attention_bf16_wgmma_kernel` in the traced sub-window."""

from harness import costs


def read(run):
    if run.trace is None:
        return None
    durs = run.trace.by_name("attention_bf16_wgmma_kernel")
    if not durs:
        return None
    m, s = run.config["model"], run.config["slam"]
    N = s["S_slam"] // s["kf_stride"] * s["PATCHES_PER_FRAME"]
    least = costs.k2_cost(m["S"], N, m["num_heads"], m["hidden_size"] // m["num_heads"])["least_s"]
    return 100.0 * least / (sum(durs) / len(durs))
