"""Stage 1: the depth-prior networks (DepthAnythingV2 for relative
disparity in dpt.py, UniDepthV2 for metric depth and intrinsics in
unidepth.py) and the alignment of the one onto the other (align.py)."""

from batrack_tpu_torch.depth.align import (
    align_depth_dirs,
    align_depth_sequence,
    fit_frame_scale_shift,
    intrinsics_to_fov,
)

__all__ = [
    "align_depth_dirs",
    "align_depth_sequence",
    "fit_frame_scale_shift",
    "intrinsics_to_fov",
]
