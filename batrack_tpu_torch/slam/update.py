"""SLAM backend update: dual BA on the slot solver (BA_BACKEND="slot") or
the flat edge solver ("flat", forced by use_keyframe), map-point culling
and the windowed point-cloud refresh (counterpart of
batrack_tpu/slam/update.py). The sharded updates of the multi-device path
share `dual_ba` / `flat_dual_ba` and the point-cloud refresh
(parallel/sharded_slot_ba.py, parallel/sharded_ba.py).

The JAX package fuses this into one jitted program; here it runs eagerly,
as a Python loop over the ITER dual-BA passes, updating the state in place.
"""

from __future__ import annotations

from typing import Optional

import torch

from batrack_tpu_torch.ba.slot_solver import SlotGraph, slot_ba_iteration_fm
from batrack_tpu_torch.ba.solver import BAProblem, ba_iteration
from batrack_tpu_torch.geometry import projective, se3
from batrack_tpu_torch.slam.state import SLAMState, StaticDims
from batrack_tpu_torch.utils.config import SlamConfig


def dual_ba(poses: torch.Tensor, patches_fm: torch.Tensor, monodisp_fm: torch.Tensor,
            intrinsics: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor,
            weights_pose: torch.Tensor, weights: torch.Tensor, slot_start: torch.Tensor,
            n: int, initialized: bool, dims: StaticDims, cfg: SlamConfig, mesh=None):
    """ITER x dual BA over the slot graph: a pose pass with static-only
    weights, then a structure-only pass with all weights (batrack.py:869-875).

    patches_fm (N, M', 3), monodisp_fm (N, M') and the edge arrays
    (R, NS, M', S, ...) hold M' patches of every frame: all of them, or this
    rank's shard when `mesh` is set (parallel/sharded_slot_ba.py)."""
    t0 = max(n - cfg.OPTIMIZATION_WINDOW, 1) if initialized else 1
    base_f = max(n - dims.patch_window, 0)
    kw = dict(window=dims.window, patch_window=dims.patch_window, patches_per_frame=dims.M,
              kf_stride=dims.kf_stride, bounds=(0.0, 0.0, float(dims.wd), float(dims.ht)),
              ep=cfg.BA_EP, lmbda=cfg.BA_LMBDA, alpha=cfg.BA_ALPHA, loss=cfg.LOSS, mesh=mesh,
              shard_mode="patches")
    for _ in range(cfg.ITER):
        for w, structure_only in ((weights_pose, False), (weights, True)):
            graph = SlotGraph(targets=targets, weights=w, valid=valid, slot_start=slot_start)
            poses, patches_fm = slot_ba_iteration_fm(
                poses, patches_fm, monodisp_fm, intrinsics, graph, t0, n, base_f,
                structure_only=structure_only, **kw)
    return poses, patches_fm


def flat_dual_ba(poses: torch.Tensor, patches: torch.Tensor, monodisp: torch.Tensor,
                 intrinsics: torch.Tensor, targets: torch.Tensor, kk: torch.Tensor,
                 jj: torch.Tensor, valid: torch.Tensor, weights_pose: torch.Tensor,
                 weights: torch.Tensor, n: int, initialized: bool, dims: StaticDims,
                 cfg: SlamConfig, mesh=None):
    """ITER x dual BA over the flat edge list (the BA_BACKEND="flat" branch
    of the JAX slam_update). The edge arrays (E', ...) are all edges, or
    this rank's shard when `mesh` is set (parallel/sharded_ba.py)."""
    M = dims.M
    t0 = max(n - cfg.OPTIMIZATION_WINDOW, 1) if initialized else 1
    base_k = max(n - dims.patch_window, 0) * M
    kw = dict(window=dims.window, patch_window=dims.patch_window, patches_per_frame=M,
              bounds=(0.0, 0.0, float(dims.wd), float(dims.ht)), ep=cfg.BA_EP,
              lmbda=cfg.BA_LMBDA, alpha=cfg.BA_ALPHA, loss=cfg.LOSS, mesh=mesh)
    ii = kk // M
    for _ in range(cfg.ITER):
        for w, structure_only in ((weights_pose, False), (weights, True)):
            prob = BAProblem(poses, patches, monodisp, intrinsics, targets, w, ii, jj, kk,
                             valid, t0, n, base_k)
            poses, patches = ba_iteration(prob, structure_only=structure_only, **kw)
    return poses, patches


def map_filter(state: SLAMState, kk: torch.Tensor, jj: torch.Tensor, targets: torch.Tensor,
               dims: StaticDims, cfg: SlamConfig, gather=None) -> None:
    """Map-point culling (batrack.py:327-332, 887-889): edges whose
    reprojection error reaches MAP_FILTERING_TH lose their weights. kk, jj
    and targets are the edges' patch ids, target frames and 2D targets;
    on an edge shard (parallel/sharded_ba.py) `gather` brings the shard's
    keep mask back to every edge."""
    coords, _, _ = projective.transform(state.poses, state.patches, state.intrinsics,
                                        kk // dims.M, jj, kk)
    ate = torch.linalg.vector_norm(coords - targets, dim=-1)
    keep = (ate < cfg.MAP_FILTERING_TH).to(torch.float32)
    if gather is not None:
        keep = gather(keep)
    state.e_weight = state.e_weight * keep[:, None]
    state.e_weight_pose = state.e_weight_pose * keep[:, None]


def slam_update(state: SLAMState, n: int, initialized: bool, dims: StaticDims,
                cfg: SlamConfig) -> None:
    """One full backend update (ITER x dual BA + culling + point cloud)."""
    M, Nf = dims.M, dims.N
    mid = (dims.S_local + 1) // 2 - 1
    # the mono prior reads the local-trajectory mid slot, as the reference
    # does (batrack.py:866); after the first update it holds the BA's own
    # reprojected disparity for weighted tracks
    monodisp = state.local_targets[:, mid, 2]
    if cfg.BA_BACKEND == "slot":
        R, NS, S = dims.ring_slots, dims.n_src, dims.S_slam

        def edges(x):
            return x.reshape((R, NS, M, S) + x.shape[1:])

        poses, patches_fm = dual_ba(
            state.poses, state.patches.reshape(Nf, M, 3), monodisp.reshape(Nf, M),
            state.intrinsics, edges(state.e_target)[..., :2], edges(state.e_valid),
            edges(state.e_weight_pose), edges(state.e_weight), state.slot_start, n,
            initialized, dims, cfg)
        state.poses, state.patches = poses, patches_fm.reshape(Nf * M, 3)
    else:  # any other value is the flat solver, as in the JAX package
        state.poses, state.patches = flat_dual_ba(
            state.poses, state.patches, monodisp, state.intrinsics, state.e_target[:, :2],
            state.e_kk.long(), state.e_jj.long(), state.e_valid, state.e_weight_pose,
            state.e_weight, n, initialized, dims, cfg)

    if cfg.USE_MAP_FILTERING:
        map_filter(state, state.e_kk.long(), state.e_jj.long(), state.e_target[:, :2], dims, cfg)
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
