"""SLAM state buffers (counterpart of batrack_tpu/slam/state.py).

The JAX package threads an immutable NamedTuple through jitted steps; here
the same buffers live in one mutable object that the stages update in
place (ring writes, window roll), as the reference does with its CUDA
buffers. Field names, shapes and dtypes match the JAX state one for one.

The factor graph is a ring of `ring_slots` fixed-size edge blocks, one per
tracker append; the ring overwrite plus the BA patch-window predicate
implement the reference's edge removal, so no compaction ever runs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from batrack_tpu_torch.utils.config import Config


@dataclass
class SLAMState:
    # per-frame buffers (N = BUFFER_SIZE)
    tstamps: torch.Tensor         # (N,) int32 global frame counter per slot
    poses: torch.Tensor           # (N, 7) SE3 world-to-camera
    intrinsics: torch.Tensor      # (N, 4)
    # per-patch buffers (N*M rows)
    patches: torch.Tensor         # (N*M, 3) [x, y, disp]
    patches_valid: torch.Tensor   # (N*M,)
    colors: torch.Tensor          # (N*M, 3) uint8
    # per-patch local-trajectory buffers (S_local = 2*S_slam - 1)
    local_targets: torch.Tensor   # (N*M, S_local, 3)
    local_vis: torch.Tensor       # (N*M, S_local)
    local_static: torch.Tensor    # (N*M, S_local) init ones
    local_weights: torch.Tensor   # (N*M, S_local)
    trajs_world: torch.Tensor     # (N*M, S_local, 3)
    # factor-graph edge ring (E_CAP = ring_slots * edges_per_slot)
    e_kk: torch.Tensor            # (E_CAP,) patch id
    e_jj: torch.Tensor            # (E_CAP,) target frame
    e_target: torch.Tensor        # (E_CAP, 3) tracked [x, y, disp]
    e_weight: torch.Tensor        # (E_CAP, 2) structure weights
    e_weight_pose: torch.Tensor   # (E_CAP, 2) pose (static-only) weights
    e_valid: torch.Tensor         # (E_CAP,)
    e_static: torch.Tensor        # (E_CAP,) static label per edge
    slot_start: torch.Tensor      # (ring_slots,) window start frame; -1 empty
    # rolling window of raw frames (S_slam newest)
    win_images: torch.Tensor      # (S_slam, H, W, 3) float32 (0..255)
    win_depths: torch.Tensor      # (S_slam, H, W) float32


def ring_slots_for(slam) -> int:
    """Edge-ring capacity in append blocks: a block's sources leave the
    REMOVAL_WINDOW after REMOVAL_WINDOW / kf_stride appends."""
    base = slam.REMOVAL_WINDOW // slam.kf_stride
    if slam.use_keyframe:
        return base + slam.KEYFRAME_RING_EXTRA
    return base


def init_state(cfg: Config, ht: int, wd: int, device) -> SLAMState:
    slam = cfg.slam
    N, M = slam.BUFFER_SIZE, slam.PATCHES_PER_FRAME
    S_local = slam.S_local
    ring = ring_slots_for(slam)
    E = ring * (slam.S_slam // slam.kf_stride) * M * slam.S_slam
    f32, i32 = torch.float32, torch.int32

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    poses = z(N, 7)
    poses[:, 6] = 1.0
    return SLAMState(
        tstamps=z(N, dtype=i32), poses=poses, intrinsics=z(N, 4),
        patches=z(N * M, 3), patches_valid=z(N * M),
        colors=z(N * M, 3, dtype=torch.uint8),
        local_targets=z(N * M, S_local, 3), local_vis=z(N * M, S_local),
        local_static=torch.ones((N * M, S_local), dtype=f32, device=device),
        local_weights=z(N * M, S_local), trajs_world=z(N * M, S_local, 3),
        e_kk=z(E, dtype=i32), e_jj=z(E, dtype=i32), e_target=z(E, 3),
        e_weight=z(E, 2), e_weight_pose=z(E, 2), e_valid=z(E), e_static=z(E),
        slot_start=torch.full((ring,), -1, dtype=i32, device=device),
        win_images=z(slam.S_slam, ht, wd, 3), win_depths=z(slam.S_slam, ht, wd),
    )


class StaticDims(NamedTuple):
    """Sizes derived from the config."""

    N: int
    M: int
    S_slam: int
    S_local: int
    kf_stride: int
    ring_slots: int
    edges_per_slot: int
    n_src: int          # query source slots per append = S_slam // kf_stride
    window: int         # BA pose window
    patch_window: int   # BA patch window (frames)
    ht: int
    wd: int

    @classmethod
    def from_config(cls, cfg: Config, ht: int, wd: int) -> "StaticDims":
        slam = cfg.slam
        n_src = slam.S_slam // slam.kf_stride
        return cls(
            N=slam.BUFFER_SIZE,
            M=slam.PATCHES_PER_FRAME,
            S_slam=slam.S_slam,
            S_local=slam.S_local,
            kf_stride=slam.kf_stride,
            ring_slots=ring_slots_for(slam),
            edges_per_slot=n_src * slam.PATCHES_PER_FRAME * slam.S_slam,
            n_src=n_src,
            window=max(slam.OPTIMIZATION_WINDOW, slam.num_init) + 1,
            patch_window=slam.REMOVAL_WINDOW,
            ht=ht,
            wd=wd,
        )
