"""Patch-sharded slot BA: the backend of the multi-device path
(counterpart of batrack_tpu/parallel/sharded_slot_ba.py).

The dense slot graph has axes (slot, source, M, S); rank r owns patches
[r*M/D, (r+1)*M/D) of every frame, M = PATCHES_PER_FRAME and D the world
size (which must divide M, as the JAX package's shard_map requires):

* residuals, Jacobians and the per-patch C, w and E pieces are complete
  locally (every slot group is replicated, only the patches are split);
* one all_reduce of the pose blocks, the Schur terms and the right-hand
  side per Gauss-Newton pose step (ba/slot_solver.py);
* the tiny pose solve is replicated, the depth updates stay local until
  the end of the update, when one all-gather restores the full patches.

The map filter then runs patch-sharded too (each rank reprojects its own
patches) and one all-gather of the keep mask updates the replicated edge
weights, before the replicated point-cloud refresh.

`shard_slots` cuts the other layout, the JAX package's shard_mode="slots",
which no caller of either package selects: each rank takes a contiguous
block of ring slots with every patch, and the solver sums the pose blocks
and the per-patch pieces over the ranks (ba/slot_solver.py).
"""

from __future__ import annotations

import torch

from batrack_tpu_torch.ba.slot_solver import SlotGraph
from batrack_tpu_torch.geometry import projective
from batrack_tpu_torch.parallel.mesh import Mesh, gather_rows, shard_rows
from batrack_tpu_torch.slam.state import SLAMState, StaticDims
from batrack_tpu_torch.slam.update import cloud_window_frames, dual_ba, update_point_cloud
from batrack_tpu_torch.utils.config import SlamConfig


def shard_slots(graph: SlotGraph, mesh: Mesh) -> SlotGraph:
    """This rank's contiguous block of ring slots, for shard_mode="slots":
    the slot axis is padded to a multiple of the world size with empty
    slots (slot_start -1, no valid edge), which add nothing to any sum."""
    targets, weights, valid = (shard_rows(x, mesh) for x in graph[:3])
    return SlotGraph(targets=targets, weights=weights, valid=valid,
                     slot_start=shard_rows(graph.slot_start + 1, mesh) - 1)


def _map_filter_keep(poses, patches_fm, intrinsics, slot_start, targets, dims: StaticDims,
                     threshold: float) -> torch.Tensor:
    """1 where an edge's reprojection error is under `threshold`, over the
    (R, NS, M', S) edges of the M' patches in patches_fm (N, M', 3)."""
    R, NS, Mb, S = targets.shape[:4]
    Nf, dev = dims.N, poses.device
    i_cl = (slot_start[:, None].long() + torch.arange(NS, device=dev) * dims.kf_stride)
    j_cl = (slot_start[:, None].long() + torch.arange(S, device=dev))
    shape = (R, NS, Mb, S)
    ii = i_cl.clamp(0, Nf - 1)[:, :, None, None].expand(shape).reshape(-1)
    jj = j_cl.clamp(0, Nf - 1)[:, None, None, :].expand(shape).reshape(-1)
    mm = torch.arange(Mb, device=dev)[None, None, :, None].expand(shape).reshape(-1)
    coords, _, _ = projective.transform(poses, patches_fm.reshape(-1, 3), intrinsics,
                                        ii, jj, ii * Mb + mm)
    ate = torch.linalg.vector_norm(coords - targets.reshape(-1, 2), dim=-1)
    return (ate < threshold).to(torch.float32).reshape(shape)


def sharded_slot_slam_update(state: SLAMState, n: int, initialized: bool, dims: StaticDims,
                             cfg: SlamConfig, mesh: Mesh) -> None:
    """Full backend update (ITER x dual BA + culling + point cloud),
    patch-sharded over the mesh; in place on every rank's replicated state,
    like slam/update.py::slam_update."""
    M, Nf = dims.M, dims.N
    if M % mesh.size:
        raise ValueError(f"PATCHES_PER_FRAME={M} does not divide over {mesh.size} ranks")
    R, NS, S = dims.ring_slots, dims.n_src, dims.S_slam
    mid = (dims.S_local + 1) // 2 - 1

    def edges(x):  # (E, ...) -> this rank's (R, NS, M/D, S, ...)
        return shard_rows(x.reshape((R, NS, M, S) + x.shape[1:]), mesh, dim=2)

    def frames(x):  # (N*M, ...) -> this rank's (N, M/D, ...)
        return shard_rows(x.reshape((Nf, M) + x.shape[1:]), mesh, dim=1)

    targets = edges(state.e_target)[..., :2]
    poses, patches_fm = dual_ba(
        state.poses, frames(state.patches), frames(state.local_targets[:, mid, 2]),
        state.intrinsics, targets, edges(state.e_valid), edges(state.e_weight_pose),
        edges(state.e_weight), state.slot_start, n, initialized, dims, cfg, mesh)
    state.poses = poses
    state.patches = gather_rows(patches_fm, mesh, M, dim=1).reshape(Nf * M, 3)

    if cfg.USE_MAP_FILTERING:
        keep = _map_filter_keep(poses, patches_fm, state.intrinsics, state.slot_start,
                                targets, dims, cfg.MAP_FILTERING_TH)
        keep = gather_rows(keep, mesh, M, dim=2).reshape(-1, 1)
        state.e_weight = state.e_weight * keep
        state.e_weight_pose = state.e_weight_pose * keep

    update_point_cloud(state, n, dims, window_frames=cloud_window_frames(cfg, dims),
                       write_world=False)
