"""SLAM backend update: dual BA on the slot solver, map-point culling and
the windowed point-cloud refresh (counterpart of batrack_tpu/slam/update.py,
slot backend only; the flat backend is still to port).

The JAX package fuses this into one jitted program; here it runs eagerly,
as a Python loop over the ITER dual-BA passes, updating the state in place.
"""

from __future__ import annotations

from typing import Optional

import torch

from batrack_tpu_torch.ba.slot_solver import SlotGraph, slot_ba_iteration
from batrack_tpu_torch.geometry import projective, se3
from batrack_tpu_torch.slam.state import SLAMState, StaticDims
from batrack_tpu_torch.utils.config import SlamConfig


def slam_update(state: SLAMState, n: int, initialized: bool, dims: StaticDims,
                cfg: SlamConfig) -> None:
    """One full backend update (ITER x dual BA + culling + point cloud)."""
    if cfg.BA_BACKEND != "slot":
        raise NotImplementedError(f"BA_BACKEND={cfg.BA_BACKEND!r} is not ported")
    M = dims.M
    mid = (dims.S_local + 1) // 2 - 1
    t0 = max(n - cfg.OPTIMIZATION_WINDOW, 1) if initialized else 1
    base_k = max(n - dims.patch_window, 0) * M
    bounds = (0.0, 0.0, float(dims.wd), float(dims.ht))
    R, NS, S = dims.ring_slots, dims.n_src, dims.S_slam

    def reshape_edges(x):
        return x.reshape((R, NS, M, S) + x.shape[1:])

    # the mono prior reads the local-trajectory mid slot, as the reference
    # does (batrack.py:866); after the first update it holds the BA's own
    # reprojected disparity for weighted tracks
    monodisp = state.local_targets[:, mid, 2]
    targets = reshape_edges(state.e_target)[..., :2]
    valid = reshape_edges(state.e_valid)

    def ba_pass(poses, patches, weights, structure_only):
        graph = SlotGraph(targets=targets, weights=reshape_edges(weights),
                          valid=valid, slot_start=state.slot_start)
        return slot_ba_iteration(
            poses, patches, monodisp, state.intrinsics, graph, t0, n, base_k,
            window=dims.window, patch_window=dims.patch_window,
            patches_per_frame=M, kf_stride=dims.kf_stride, bounds=bounds,
            ep=cfg.BA_EP, lmbda=cfg.BA_LMBDA, alpha=cfg.BA_ALPHA,
            loss=cfg.LOSS, structure_only=structure_only,
        )

    poses, patches = state.poses, state.patches
    for _ in range(cfg.ITER):
        # pose pass with static-only weights, then a structure-only pass
        # with all weights (batrack.py:869-875)
        poses, patches = ba_pass(poses, patches, state.e_weight_pose, False)
        poses, patches = ba_pass(poses, patches, state.e_weight, True)
    state.poses, state.patches = poses, patches

    if cfg.USE_MAP_FILTERING:
        ii = (state.e_kk // M).long()
        coords, _, _ = projective.transform(
            poses, patches, state.intrinsics, ii, state.e_jj.long(), state.e_kk.long())
        ate = torch.linalg.vector_norm(coords - state.e_target[:, :2], dim=-1)
        keep = (ate < cfg.MAP_FILTERING_TH)[:, None].to(torch.float32)
        state.e_weight = state.e_weight * keep
        state.e_weight_pose = state.e_weight_pose * keep

    update_point_cloud(state, n, dims, window_frames=cloud_window_frames(cfg, dims),
                       write_world=False)


def cloud_window_frames(cfg, dims: StaticDims) -> int:
    """Frames whose point-cloud rows can still change: the BA optimization
    window plus the S_local/2 reprojection margin (which covers the S_slam
    append window, since S_local = 2*S_slam - 1)."""
    return min(dims.N, max(cfg.OPTIMIZATION_WINDOW + (dims.S_local + 1) // 2,
                           dims.S_slam) + 1)


def update_point_cloud(state: SLAMState, n: int, dims: StaticDims,
                       window_frames: Optional[int] = None,
                       write_world: bool = True) -> None:
    """Static + dynamic world-point maintenance (batrack.py:821-854), in
    place. Tracks with any positive local weight are static: their world
    trajectory collapses to the BA point and their local 2D+disp trajectory
    is overwritten by reprojecting that point into the neighbouring frames.

    window_frames: recompute only the rows of the last `window_frames`
    frames (rows outside it already hold their final values). write_world:
    also refresh trajs_world (only the terminal full pass needs it).
    """
    M, S_local, N = dims.M, dims.S_local, dims.N
    mid = (S_local + 1) // 2 - 1
    dev = state.poses.device
    if window_frames is None or window_frames >= N:
        row0, K = 0, N * M
    else:
        row0 = min(max(n - window_frames, 0), N - window_frames) * M
        K = window_frames * M
    rows = slice(row0, row0 + K)
    patches = state.patches[rows]
    local_targets = state.local_targets[rows]
    local_weights = state.local_weights[rows]

    ridx = row0 + torch.arange(K, device=dev)
    live = ridx < n * M
    ix = ridx // M
    P = projective.point_cloud(state.poses, patches, state.intrinsics, ix)

    def dehom(Ph):
        w = Ph[:, 3:]
        return Ph[:, :3] / torch.where(w.abs() > 1e-8, w, torch.full_like(w, 1e-8))

    jj_w = (ix[:, None] + torch.arange(S_local, device=dev)[None, :] - mid).clamp(0, N - 1)
    flat_jj = jj_w.reshape(-1)
    is_static = (local_weights.sum(1) > 0)[:, None, None]
    if write_world:
        dyn_P = projective.point_cloud(state.poses, local_targets.reshape(-1, 3),
                                       state.intrinsics, flat_jj)
        trajs = torch.where(is_static, dehom(P)[:, None, :],
                            dehom(dyn_P).reshape(K, S_local, 3))
        state.trajs_world[rows] = torch.where(live[:, None, None], trajs,
                                              state.trajs_world[rows])

    X1 = se3.act4(state.poses[flat_jj], P.repeat_interleave(S_local, 0))
    trg = projective.proj(X1, state.intrinsics[flat_jj], depth=True).reshape(K, S_local, 3)
    state.local_targets[rows] = torch.where(is_static & live[:, None, None], trg,
                                            local_targets)
