"""k2_launches_per_append: launches of K2 (`fused_qkv_attention` in the
port's ops.launch_counts()) over the window, per append the window called.
The port launches 24 an append today; a route off the kernel reads 0 here
while k2_roofline_pct goes silent."""


def read(run):
    appends = sum(1 for e in run.frame_encoded if e)
    launches = getattr(run, "launches", None)
    if not appends or launches is None or "fused_qkv_attention" not in launches:
        return None
    return launches["fused_qkv_attention"] / appends
