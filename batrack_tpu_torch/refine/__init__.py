"""Stage-3 dense global alignment (depth scale grids and pose polish) on
PyTorch, the counterpart of batrack_tpu/refine/."""

from batrack_tpu_torch.refine.refine_net import (
    RefineData,
    RefineParams,
    align_depth_maps,
    build_refine_data,
    get_results,
    init_params,
    scaled_dmaps,
    total_loss,
)
from batrack_tpu_torch.refine.trainer import global_alignment_loop

__all__ = [
    "RefineData",
    "RefineParams",
    "align_depth_maps",
    "build_refine_data",
    "init_params",
    "total_loss",
    "scaled_dmaps",
    "get_results",
    "global_alignment_loop",
]
