"""A tiny cell for the harness's CPU tests: the davis_demo configuration's
structure (S_slam 12, kf_stride 2, the slot BA, 4 pyramid levels at radius
3) at toy widths and frame sizes, so that a whole run fits in seconds."""

from __future__ import annotations

import copy
import json

from harness import spec


def tiny_cell(dtype: str = "float32", limits=None) -> spec.Cell:
    conf = json.loads((spec.BENCH_DIR / "configs" / "davis_demo.json").read_text())
    conf["slam"].update(BUFFER_SIZE=64, PATCHES_PER_FRAME=16, PATCH_GEN="grid_grad_4",
                        BOUNDARY_PADDING=8)
    conf["model"].update(interp_shape=[32, 48], hidden_size=32, num_heads=2, time_depth=1,
                         space_depth=1, time_depth_dyn=1, space_depth_dyn=1, I=2,
                         compute_dtype=dtype)
    conf["frame"] = {"height": 64, "width": 96, "intrinsics": [80.0, 80.0, 48.0, 32.0]}
    conf["limits"] = dict(limits or {"track_px": 1e-3, "vis": 1e-3, "ba": 1e-3})
    mix = {"lengths": [14, 16], "entry_min": 11, "entry_max": 12, "check_ordinals": [0, 4]}
    return spec.Cell("tiny", 1, conf, copy.deepcopy(mix), [], [])
