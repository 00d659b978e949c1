"""BATrack SLAM system on PyTorch: the host-side orchestrator (counterpart
of batrack_tpu/slam/system.py).

Each frame runs ingest (window roll, patch generation, motion model); every
kf_stride frames the tracker append runs (build input, tracker, gate and
ring write); once initialised, every frame runs the dual-BA backend update.
The stages run eagerly on `device` and update one mutable SLAMState in
place.

With use_keyframe, frames whose motion is small are deleted after each
append (slam/keyframe.py) and the backend runs the flat edge solver
(ba/solver.py), as the JAX package forces; `delta` records each removed
frame's pose relative to its predecessor, and the trajectory follows it.

With `mesh` (parallel/mesh.py::get_mesh) the loop runs on every rank of a
process group, each with the full state; the backend update runs
patch-sharded (parallel/sharded_slot_ba.py), or edge-sharded with the flat
solver (parallel/sharded_ba.py), and a tracker adapter built with the same
mesh shards the tracks.

PATCH_GEN="sift" runs cv2's detector on the host frame with a numpy
Generator seeded as the JAX package seeds its own, so both packages draw
the same patches. With a `visualizer` (utils/visualizer.py::TrackVisualizer)
every frame and each append's tracks are handed to it on the host.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
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
from batrack_tpu_torch.slam.ingest import generate_patches_sift, ingest_frame, make_draws
from batrack_tpu_torch.slam.keyframe import (
    motion_magnitude_pair,
    remove_keyframe,
    remove_window_frame,
)
from batrack_tpu_torch.slam.state import StaticDims, init_state
from batrack_tpu_torch.slam.update import update_point_cloud, slam_update
from batrack_tpu_torch.utils.config import Config, full_fp32, resolve_device
from batrack_tpu_torch.utils.profiling import tracer

TrackerFn = Callable[[TrackerInput], TrackerOutput]
# (frame counter) -> the (x, y) random arrays the patch generator consumes
DrawHook = Callable[[int], Tuple[torch.Tensor, torch.Tensor]]


logger = logging.getLogger(__name__)

# the sequence half of each frame's id in the tracer: one per BATrack
_SEQUENCE_IDS = itertools.count()


class BATrack:
    """Online dynamic-scene visual odometry (reference BATRACK equivalent)."""

    def __init__(self, cfg: Config, ht: int, wd: int,
                 tracker: Optional[TrackerFn] = None, seed: int = 0,
                 device="cuda", mesh=None):
        """device: where the state lives and every stage runs (default
        CUDA; raises when CUDA is asked for and absent). seed: the
        torch.Generator behind the patch generator's random draws, unless
        `draw_hook` is set (tests set it to inject JAX's draws), and of the
        numpy Generator behind `sift` patches; every rank of a mesh must
        use the same. mesh: a parallel.mesh.Mesh on `device`
        (slam.mesh_devices, when set, must equal its size); None runs on
        one device."""
        with tracer().span("sequence.init"):
            self._init(cfg, ht, wd, tracker, seed, device, mesh)

    def _init(self, cfg: Config, ht: int, wd: int, tracker: Optional[TrackerFn], seed: int,
              device, mesh) -> None:
        self.device = resolve_device(device)
        self.mesh = mesh
        slam = cfg.slam
        if (slam.use_keyframe and slam.kf_stride > 1
                and slam.KEYFRAME_INDEX % slam.kf_stride != 1):
            # removal candidates k = n - KEYFRAME_INDEX are evaluated only on
            # append frames (n == 1 mod kf_stride) and _keyframe requires
            # k == 0 mod kf_stride: both hold only when KEYFRAME_INDEX == 1
            # mod kf_stride. The reference has the same parity trap
            # (batrack.py:1002-1031); warn, as the JAX package does
            logger.warning(
                "use_keyframe with KEYFRAME_INDEX=%d, kf_stride=%d: keyframe removal can "
                "never trigger (needs KEYFRAME_INDEX == 1 mod kf_stride; "
                "reference-identical parity constraint)", slam.KEYFRAME_INDEX, slam.kf_stride)
        if slam.use_keyframe and slam.BA_BACKEND == "slot":
            # frame deletion breaks dense slot addressing; the caller's
            # config is changed, as in the JAX package
            logger.warning(
                "BA_BACKEND='slot' is incompatible with use_keyframe (frame deletion breaks "
                "dense slot addressing); falling back to the flat edge solver — expect "
                "lower BA throughput")
            cfg.slam = dataclasses.replace(slam, BA_BACKEND="flat")
        self._update_fn = slam_update
        if mesh is not None:
            # imported here: parallel/ imports the slam modules
            from batrack_tpu_torch.parallel.mesh import mesh_device
            from batrack_tpu_torch.parallel.sharded_ba import sharded_slam_update
            from batrack_tpu_torch.parallel.sharded_slot_ba import sharded_slot_slam_update

            self.device = mesh_device(mesh, self.device)
            if cfg.slam.mesh_devices not in (0, mesh.size):
                raise ValueError(f"slam.mesh_devices={cfg.slam.mesh_devices} but the mesh "
                                 f"has {mesh.size} ranks")
            sharded = (sharded_slot_slam_update if cfg.slam.BA_BACKEND == "slot"
                       else sharded_slam_update)
            self._update_fn = functools.partial(sharded, mesh=mesh)
        elif cfg.slam.mesh_devices or cfg.slam.distributed:
            raise ValueError("slam.mesh_devices / slam.distributed need mesh=get_mesh(...)")
        self.cfg = cfg
        self.dims = StaticDims.from_config(cfg, ht, wd)
        self.state = init_state(cfg, ht, wd, self.device)
        self.tracker = tracker
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.draw_hook: Optional[DrawHook] = None
        self._np_rng = np.random.default_rng(seed)  # host-side (sift patches)
        self.visualizer = None                      # optional TrackVisualizer

        self.n = 0               # frames in buffer
        self.counter = 0         # total frames seen
        self.append_count = 0    # ring appends so far
        # per-ring-slot bookkeeping (append seq, live source frames): a slot
        # is reused only when all its sources left the REMOVAL_WINDOW, FIFO
        # among reusable slots (round-robin without keyframe removal)
        self._slot_info: List[Optional[dict]] = [None] * self.dims.ring_slots
        self.is_initialized = False
        self.tlist: List = []
        # keyframe removals: counter of the removed frame -> (counter of
        # its predecessor, relative pose (7,) numpy)
        self.delta: Dict[int, Tuple[int, np.ndarray]] = {}
        self.ring_overflow_count = 0
        self._last_append_n: Optional[int] = None  # cross-append fmap reuse
        # stage spans: the process's tracer unless a caller assigns its own
        # StageTimer; the stage spans record CUDA event pairs on the card
        self.timer = tracer()
        self.sequence = next(_SEQUENCE_IDS)
        self._device_spans = self.device.type == "cuda"

    # ------------------------------------------------------------------
    def _to_device(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(x).to(device=self.device, dtype=dtype)

    def upload_frame(self, image, depth) -> Tuple[torch.Tensor, torch.Tensor]:
        """Start the host-to-device copy of one frame: a pinned host copy,
        then a non-blocking copy to this system's device. Call it one frame
        ahead of __call__, so that the copy overlaps the current frame's
        work, and pass the tensors it returns to __call__ in place of the
        numpy arrays (the JAX package's BATrack.upload_frame)."""
        with tracer().span("upload"):
            image = np.asarray(image)
            if image.dtype != np.uint8:
                image = np.clip(image, 0, 255).astype(np.uint8)
            img = torch.from_numpy(np.ascontiguousarray(image))
            dep = torch.from_numpy(np.ascontiguousarray(depth, dtype=np.float32))
            if self.device.type == "cuda":
                img, dep = img.pin_memory(), dep.pin_memory()
            return (img.to(self.device, non_blocking=True),
                    dep.to(self.device, non_blocking=True))

    def __call__(self, tstamp, image, depth, intrinsics, host_image=None) -> None:
        """Track one frame. image: (H, W, 3) uint8 (other types are clipped
        to 0..255 and truncated to uint8, as the JAX package does); depth:
        (H, W) or (H, W, 1) metric; intrinsics: (4,) [fx, fy, cx, cy].
        image and depth may be numpy arrays or the tensors upload_frame
        returns. host_image: the same frame as a numpy array, for the host
        work (sift patches, the track video) when `image` is already on the
        device; without it that work copies the device frame back."""
        timer, process = self.timer, tracer()
        timer.frame = process.frame = (self.sequence, self.counter)
        try:
            with timer.span("frame"):
                self._frame(tstamp, image, depth, intrinsics, host_image)
        finally:
            timer.frame = process.frame = None

    def _frame(self, tstamp, image, depth, intrinsics, host_image) -> None:
        if (self.n + 1) >= self.dims.N:
            raise RuntimeError(
                f"Buffer size {self.dims.N} exhausted; increase slam.BUFFER_SIZE")
        if host_image is None and isinstance(image, np.ndarray):
            host_image = image
        image = torch.as_tensor(image)
        if image.dtype != torch.uint8:
            image = image.clamp(0, 255).to(torch.uint8)
        image = image.to(self.device)
        depth = self._to_device(depth, torch.float32)
        if depth.ndim == 3:
            depth = depth[..., 0]
        intrinsics = self._to_device(intrinsics, torch.float32)

        slam = self.cfg.slam
        image_np = None
        if self.visualizer is not None or slam.PATCH_GEN == "sift":
            image_np = self._host_frame(image, host_image)
        if self.visualizer is not None:
            self.visualizer.add_frame(image_np)
        if self.draw_hook is not None:
            draws = self.draw_hook(self.counter)
        else:
            draws = make_draws(slam.PATCH_GEN, self.dims.M, self.dims.ht,
                               self.dims.wd, self.generator)
        coords_override = None
        if slam.PATCH_GEN == "sift":
            with self.timer.span("sift"):
                coords_override = torch.from_numpy(generate_patches_sift(
                    image_np, M=self.dims.M, ht=self.dims.ht, wd=self.dims.wd,
                    rng=self._np_rng)).to(self.device)
        mark_valid = (self.n % slam.kf_stride == 0) and not self.is_initialized
        with full_fp32():
            with self.timer.span("ingest", device=self._device_spans):
                ingest_frame(
                    self.state, image, depth, intrinsics, self.n, self.counter,
                    self.dims, patch_gen=slam.PATCH_GEN,
                    motion_damping=slam.MOTION_DAMPING, mark_valid=mark_valid,
                    draws=draws, coords_override=coords_override,
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
                if slam.use_keyframe and (self.n - 1) % slam.kf_stride == 0:
                    with self.timer.span("keyframe"):
                        self._keyframe()

    @staticmethod
    def _host_frame(image: torch.Tensor, host_image) -> np.ndarray:
        """The frame as uint8 numpy on the host, as the JAX package hands it
        to the host work: the caller's array (clipped and truncated to
        uint8 like the device frame), else a copy of the device frame."""
        if host_image is None:
            return image.cpu().numpy()
        host_image = np.asarray(host_image)
        if host_image.dtype != np.uint8:
            host_image = np.clip(host_image, 0, 255).astype(np.uint8)
        return host_image

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
                logger.warning(
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
        device = self._device_spans
        with self.timer.span("build_input", device=device):
            tin = build_tracker_input(self.state, self.n, self.dims)
        with self.timer.span("tracker", device=device):
            tout = self.tracker(tin)
        with self.timer.span("gate_append", device=device):
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
        if self.visualizer is not None:
            with self.timer.span("track_video"):
                self.visualizer.add_track(self._track_payload(slot))

    def _track_payload(self, slot: int) -> dict:
        """One append's tracks for the video, in the JAX package's layout:
        {fid, targets (S, NS*M, 2), weights (S, NS*M), static (S, NS*M)},
        copied from the slot's edge rows to the host once."""
        dims, st = self.dims, self.state
        S, NS, M = dims.S_slam, dims.n_src, dims.M
        rows = slice(slot * dims.edges_per_slot, (slot + 1) * dims.edges_per_slot)
        packed = torch.cat([st.e_target[rows, :2], st.e_weight[rows, :1],
                            st.e_static[rows, None]], 1).cpu().numpy()
        packed = np.moveaxis(packed.reshape(NS, M, S, 4), 2, 0).reshape(S, NS * M, 4)
        return {"fid": self.n, "targets": packed[..., :2], "weights": packed[..., 2],
                "static": packed[..., 3]}

    def update(self) -> None:
        with full_fp32(), self.timer.span("ba_update", device=self._device_spans):
            self._update_fn(self.state, self.n, self.is_initialized, self.dims, self.cfg.slam)

    def _keyframe(self) -> None:
        """Motion-magnitude keyframe removal (batrack.py:1026-1073): one
        scalar comes to the host per decision."""
        slam = self.cfg.slam
        k = self.n - slam.KEYFRAME_INDEX
        if k % slam.kf_stride != 0 or k < 1:
            return
        mag = float(motion_magnitude_pair(self.state, k - 1, k + 1, k, self.dims))
        if mag >= slam.KEYFRAME_THRESH:
            return
        st = self.state
        t0, t1 = (int(x) for x in st.tstamps[k - 1:k + 1].cpu())
        self.delta[t1] = (t0, se3.mul(st.poses[k], se3.inv(st.poses[k - 1])).cpu().numpy())
        remove_keyframe(st, k, self.dims)
        win_idx = k - self.n + self.dims.S_slam
        if 0 <= win_idx < self.dims.S_slam:
            remove_window_frame(st, win_idx, self.dims)
        self.n -= 1
        self._last_append_n = None  # the window changed: no fmap reuse
        # frame k is gone (its edges are invalid) and the frames above it
        # slide down: the slot allocator's sources follow
        for info in self._slot_info:
            if info is not None:
                info["sources"] = [s - (s > k) for s in info["sources"] if s != k]

    # ------------------------------------------------------------------
    def save_state(self, path: str) -> None:
        """Checkpoint the whole SLAM state for a mid-sequence resume, in the
        JAX package's .npz layout (slam/checkpoint.py)."""
        from batrack_tpu_torch.slam.checkpoint import save_slam_state

        save_slam_state(self, path)

    def load_state(self, path: str) -> None:
        from batrack_tpu_torch.slam.checkpoint import load_slam_state

        load_slam_state(self, path)
        self._last_append_n = None

    # ------------------------------------------------------------------
    def world_trajectories(self) -> torch.Tensor:
        """Static+dynamic world-point trajectories (the reference's
        trajs_3d_world_ buffer), from one full write_world pass: rows freeze
        once outside the window, so this equals incremental maintenance."""
        with full_fp32():
            update_point_cloud(self.state, self.n, self.dims, window_frames=None,
                               write_world=True)
        return self.state.trajs_world

    def get_pose(self, t: int, traj: Dict[int, np.ndarray]) -> np.ndarray:
        """Pose of counter t, following the removal deltas (batrack.py:223-228)."""
        if t in traj:
            return traj[t]
        t0, dP = self.delta[t]
        return se3.mul(torch.from_numpy(np.asarray(dP, np.float32)),
                       torch.from_numpy(self.get_pose(t0, traj))).numpy()

    def _full_traj(self) -> np.ndarray:
        tstamps = self.state.tstamps[: self.n].cpu().numpy()
        poses = self.state.poses[: self.n].cpu().numpy()
        traj = {int(t): poses[i] for i, t in enumerate(tstamps)}
        return np.stack([self.get_pose(t, traj) for t in range(self.counter)])

    def terminate(self) -> Tuple[np.ndarray, np.ndarray]:
        """Final camera-to-world TUM trajectory: (poses (C, 7)
        [tx ty tz qw qx qy qz], tstamps (C,))."""
        with self.timer.span("sequence.terminate"):
            poses = se3.inv(torch.from_numpy(self._full_traj())).numpy()  # w2c -> c2w
            poses = poses[:, [0, 1, 2, 6, 3, 4, 5]]
            return poses, np.asarray(self.tlist, dtype=float)

    def get_results(self, rgbs=None, dmaps=None, dmaps_gt=None,
                    save_path: Optional[str] = None) -> dict:
        """Results dict with the reference pickle schema (batrack.py:1080-1135),
        all numpy, so the dense-refinement stage and visualizers read it.

        After keyframe removals the per-frame rows are indexed by buffer
        row while cams_T_world is indexed by counter, as in the reference
        (batrack.py:1091-1103); like the JAX package, this warns and adds
        `stale_rows` (rows whose content is another frame's, or beyond the
        live buffer) and `buffer_tstamps` (the frame each live row holds)."""
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
        if self.delta:
            buffer_tstamps = st.tstamps[: self.n].cpu().numpy()
            # against np.arange(n), as the JAX package does: this assumes
            # 0-based contiguous frame counters (ROADMAP C)
            misaligned = np.nonzero(buffer_tstamps != np.arange(self.n))[0]
            stale = np.concatenate([misaligned, np.arange(self.n, Cr)])
            results["stale_rows"] = stale.astype(np.int64)
            results["buffer_tstamps"] = buffer_tstamps.astype(np.int64)
            logger.warning(
                "get_results after %d keyframe removal(s): %d of %d per-frame rows in "
                "trajs_*/dmaps-aligned buffers are stale or misaligned with cams_T_world "
                "(reference-identical layout, batrack.py:1091-1103)%s. Consumers must remap "
                "via the 'stale_rows'/'buffer_tstamps' fields or disable slam.use_keyframe.",
                len(self.delta), len(stale), Cr,
                "" if Cr == C else f"; counters {Cr}..{C - 1} exceed the buffer capacity and "
                "have no per-frame rows (truncated export)")
        if save_path is not None and (self.mesh is None or self.mesh.rank == 0):
            with open(save_path, "wb") as f:
                pickle.dump(results, f)
        return results
