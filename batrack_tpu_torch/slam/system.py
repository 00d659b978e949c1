"""BATrack SLAM system on PyTorch: the host-side orchestrator (counterpart
of batrack_tpu/slam/system.py).

Each frame runs ingest (window roll, patch generation, motion model); every
kf_stride frames the tracker append runs (build input, tracker, gate and
ring write); once initialised, every frame runs the dual-BA backend update.
The stages run eagerly on `device` and update one mutable SLAMState in
place.

Options outside this slice (use_keyframe, the flat BA backend, sift
patches, multi-device execution) raise NotImplementedError.
"""

from __future__ import annotations

import logging
import pickle
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from batrack_tpu_torch.geometry import se3
from batrack_tpu_torch.slam.frontend import (
    TrackerInput,
    TrackerOutput,
    build_tracker_input,
    gate_and_append,
)
from batrack_tpu_torch.slam.ingest import ingest_frame, make_draws
from batrack_tpu_torch.slam.state import StaticDims, init_state
from batrack_tpu_torch.slam.update import update_point_cloud, slam_update
from batrack_tpu_torch.utils.config import Config, full_fp32, resolve_device
from batrack_tpu_torch.utils.profiling import StageTimer

TrackerFn = Callable[[TrackerInput], TrackerOutput]
# (frame counter) -> the (x, y) random arrays the patch generator consumes
DrawHook = Callable[[int], Tuple[torch.Tensor, torch.Tensor]]


def _check_supported(cfg: Config) -> None:
    s = cfg.slam
    if s.use_keyframe:
        raise NotImplementedError("slam.use_keyframe is not ported yet")
    if s.BA_BACKEND != "slot":
        raise NotImplementedError(f"slam.BA_BACKEND={s.BA_BACKEND!r} is not ported yet")
    if s.PATCH_GEN == "sift":
        raise NotImplementedError("slam.PATCH_GEN='sift' is not ported yet")
    if s.mesh_devices or s.distributed:
        raise NotImplementedError("multi-device execution is not ported yet")
    if s.MOTION_MODEL != "DAMPED_LINEAR":
        raise NotImplementedError(f"slam.MOTION_MODEL={s.MOTION_MODEL!r}")


class BATrack:
    """Online dynamic-scene visual odometry (reference BATRACK equivalent)."""

    def __init__(self, cfg: Config, ht: int, wd: int,
                 tracker: Optional[TrackerFn] = None, seed: int = 0,
                 device="cuda"):
        """device: where the state lives and every stage runs (default
        CUDA; raises when CUDA is asked for and absent). seed: the
        torch.Generator behind the patch generator's random draws, unless
        `draw_hook` is set (tests set it to inject JAX's draws)."""
        _check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dims = StaticDims.from_config(cfg, ht, wd)
        self.state = init_state(cfg, ht, wd, self.device)
        self.tracker = tracker
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.draw_hook: Optional[DrawHook] = None

        self.n = 0               # frames in buffer
        self.counter = 0         # total frames seen
        self.append_count = 0    # ring appends so far
        # per-ring-slot bookkeeping (append seq, live source frames): a slot
        # is reused only when all its sources left the REMOVAL_WINDOW, FIFO
        # among reusable slots (round-robin without keyframe removal)
        self._slot_info: List[Optional[dict]] = [None] * self.dims.ring_slots
        self.is_initialized = False
        self.tlist: List = []
        self.ring_overflow_count = 0
        self._last_append_n: Optional[int] = None  # cross-append fmap reuse
        self.timer = StageTimer(enabled=False)

    # ------------------------------------------------------------------
    def _to_device(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(x).to(device=self.device, dtype=dtype)

    def __call__(self, tstamp, image, depth, intrinsics) -> None:
        """Track one frame. image: (H, W, 3) uint8 (other types are clipped
        to 0..255 and truncated to uint8, as the JAX package does); depth:
        (H, W) or (H, W, 1) metric; intrinsics: (4,) [fx, fy, cx, cy]."""
        if (self.n + 1) >= self.dims.N:
            raise RuntimeError(
                f"Buffer size {self.dims.N} exhausted; increase slam.BUFFER_SIZE")
        image = torch.as_tensor(image)
        if image.dtype != torch.uint8:
            image = image.clamp(0, 255).to(torch.uint8)
        image = image.to(self.device)
        depth = self._to_device(depth, torch.float32)
        if depth.ndim == 3:
            depth = depth[..., 0]
        intrinsics = self._to_device(intrinsics, torch.float32)

        slam = self.cfg.slam
        if self.draw_hook is not None:
            draws = self.draw_hook(self.counter)
        else:
            draws = make_draws(slam.PATCH_GEN, self.dims.M, self.dims.ht,
                               self.dims.wd, self.generator)
        mark_valid = (self.n % slam.kf_stride == 0) and not self.is_initialized
        with full_fp32():
            with self.timer.timed("ingest"):
                ingest_frame(
                    self.state, image, depth, intrinsics, self.n, self.counter,
                    self.dims, patch_gen=slam.PATCH_GEN,
                    motion_damping=slam.MOTION_DAMPING, mark_valid=mark_valid,
                    draws=draws,
                )
            self.tlist.append(tstamp)
            self.counter += 1
            self.n += 1

            if (self.n - 1) % slam.kf_stride == 0:
                self._track_append()

            if self.n == slam.num_init + 1 and not self.is_initialized:
                self.is_initialized = True
                for _ in range(12):
                    self.update()
            elif self.is_initialized:
                self.update()

    # ------------------------------------------------------------------
    def _alloc_slot(self) -> int:
        """Ring slot for this append: the oldest empty or dead slot (all
        sources outside REMOVAL_WINDOW); over capacity, the oldest slot."""
        dims, slam = self.dims, self.cfg.slam
        dead_n = self.n - slam.REMOVAL_WINDOW
        best, best_seq = None, None
        for idx, info in enumerate(self._slot_info):
            if info is None:
                seq = -1
            elif all(s < dead_n for s in info["sources"]):
                seq = info["seq"]
            else:
                continue
            if best is None or seq < best_seq:
                best, best_seq = idx, seq
        if best is None:
            best = min(range(len(self._slot_info)),
                       key=lambda i: self._slot_info[i]["seq"])
            self.ring_overflow_count += 1
            if self.ring_overflow_count == 1 or self.ring_overflow_count % 100 == 0:
                logging.getLogger(__name__).warning(
                    "edge ring over capacity (%d slots, all live; occurrence "
                    "#%d); overwriting the oldest", dims.ring_slots,
                    self.ring_overflow_count)
        S = min(self.n, dims.S_slam)
        sources = [self.n - S + qs * dims.kf_stride
                   for qs in range(dims.n_src) if qs * dims.kf_stride < S]
        self._slot_info[best] = {"seq": self.append_count, "sources": sources}
        return best

    def _track_append(self) -> None:
        if self.tracker is None:
            raise RuntimeError("no tracker configured")
        # cross-append feature reuse: consecutive appends on a full window
        # share all but `shift` frames (the tracker encodes only new ones)
        shift = None
        if (self._last_append_n is not None
                and self._last_append_n >= self.dims.S_slam
                and 0 < self.n - self._last_append_n < self.dims.S_slam):
            shift = self.n - self._last_append_n
        if hasattr(self.tracker, "reuse_hint"):
            self.tracker.reuse_hint = shift
        slot = self._alloc_slot()
        slam = self.cfg.slam
        with self.timer.timed("build_input"):
            tin = build_tracker_input(self.state, self.n, self.dims)
        with self.timer.timed("tracker"):
            tout = self.tracker(tin)
        with self.timer.timed("gate_append"):
            gate_and_append(
                self.state, tin, tout, self.n, slot, self.dims,
                vis_threshold=slam.VIS_THRESHOLD,
                static_threshold=slam.STATIC_THRESHOLD,
                static_quantile=slam.STATIC_QUANTILE,
                min_track_len=slam.MIN_TRACK_LEN,
                boundary_padding=slam.BOUNDARY_PADDING,
            )
        self.append_count += 1
        self._last_append_n = self.n

    def update(self) -> None:
        with full_fp32(), self.timer.timed("ba_update"):
            slam_update(self.state, self.n, self.is_initialized, self.dims, self.cfg.slam)

    # ------------------------------------------------------------------
    def world_trajectories(self) -> torch.Tensor:
        """Static+dynamic world-point trajectories (the reference's
        trajs_3d_world_ buffer), from one full write_world pass: rows freeze
        once outside the window, so this equals incremental maintenance."""
        with full_fp32():
            update_point_cloud(self.state, self.n, self.dims, window_frames=None,
                               write_world=True)
        return self.state.trajs_world

    def _full_traj(self) -> np.ndarray:
        tstamps = self.state.tstamps[: self.n].cpu().numpy()
        poses = self.state.poses[: self.n].cpu().numpy()
        traj = {int(t): poses[i] for i, t in enumerate(tstamps)}
        return np.stack([traj[t] for t in range(self.counter)])

    def terminate(self) -> Tuple[np.ndarray, np.ndarray]:
        """Final camera-to-world TUM trajectory: (poses (C, 7)
        [tx ty tz qw qx qy qz], tstamps (C,))."""
        poses = se3.inv(torch.from_numpy(self._full_traj())).numpy()  # w2c -> c2w
        poses = poses[:, [0, 1, 2, 6, 3, 4, 5]]
        return poses, np.asarray(self.tlist, dtype=float)

    def get_results(self, rgbs=None, dmaps=None, dmaps_gt=None,
                    save_path: Optional[str] = None) -> dict:
        """Results dict with the reference pickle schema (batrack.py:1080-1135),
        all numpy, so the dense-refinement stage and visualizers read it."""
        C = self.counter
        M, S_local = self.dims.M, self.dims.S_local
        Cr = min(C, self.dims.N)
        poses = torch.from_numpy(self._full_traj())
        cams_T_world = se3.matrix(se3.inv(poses)).numpy()
        st = self.state

        def rows(x, *shape):
            return x[: Cr * M].cpu().numpy().reshape((Cr, M) + shape)

        pts_valid = rows(st.patches_valid)
        trajs_weights = rows(st.local_weights, S_local)
        results: Dict[str, object] = {
            "cams_T_world": cams_T_world,
            "intrinsics": st.intrinsics[:Cr].cpu().numpy(),
            "tstamps": np.asarray(self.tlist, dtype=float),
            "trajs_2d_disp": rows(st.local_targets, S_local, 3),
            "trajs_valid": trajs_weights.sum(axis=2) > 0,
            "trajs_static": rows(st.local_static, S_local),
            "trajs_vis": rows(st.local_vis, S_local),
            "grid_query_frames": np.arange(Cr)[pts_valid.sum(axis=1) > 0],
            "dmaps": None if dmaps is None else np.asarray(dmaps, dtype=float),
            "rgbs": None if rgbs is None else np.asarray(rgbs, dtype=float),
            "dmaps_gt": None if dmaps_gt is None else np.asarray(dmaps_gt, dtype=float),
        }
        if self.ring_overflow_count:
            results["ring_overflow_count"] = int(self.ring_overflow_count)
        if save_path is not None:
            with open(save_path, "wb") as f:
                pickle.dump(results, f)
        return results
