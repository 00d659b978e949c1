"""SLAM adapter: wraps MDTracker as the tracker callable of BATrack
(counterpart of batrack_tpu/tracker/adapter.py).

Around the network it does what the reference _compute_sparse_tracks does
(batrack.py:529-587): resize the RGB-D window to the model resolution,
scale query coordinates in and track outputs back out, and merge the static
branch when configured. With a mesh, every rank passes all queries in and
gets all tracks back: the network shards its refinement steps over the
tracks itself (tracker/mdtracker.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from batrack_tpu_torch.ops.sampling import interpolate_bilinear
from batrack_tpu_torch.parallel.mesh import mesh_device
from batrack_tpu_torch.slam.frontend import TrackerInput, TrackerOutput
from batrack_tpu_torch.tracker.mdtracker import MDTracker, TrackerParams
from batrack_tpu_torch.utils.config import ModelConfig, resolve_device


class MDTrackerAdapter:
    """Tracker callable for the SLAM system."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        state_dict: Optional[dict] = None,
        seed: int = 0,
        backward_tracking: bool = False,
        static_threshold: float = 0.1,
        device="cuda",
        mesh=None,
    ):
        """state_dict: weights by reference name (md_tracker.pth, or
        tracker.convert.state_dict_from_flax); random from `seed` when None,
        so every rank of a mesh builds the same weights. Activations run in
        model_cfg.compute_dtype. device: default CUDA; raises when CUDA is
        asked for and absent. mesh: a parallel.mesh.Mesh on `device`; the
        tracks are sharded over it. None runs on one device."""
        if backward_tracking:
            raise NotImplementedError("backward tracking is not ported yet")
        self.device = resolve_device(device)
        if mesh is not None:
            self.device = mesh_device(mesh, self.device)
        self.p = TrackerParams.from_config(model_cfg)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = MDTracker(self.p, mesh=mesh)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(device=self.device,
                              dtype=getattr(torch, model_cfg.compute_dtype)).eval()
        # static-branch merge (batrack.py:556-566); when both flags are off
        # the branch's output is discarded, so it is not computed at all
        self.use_static_mask = model_cfg.use_static_mask
        self.use_static = model_cfg.use_static
        self.static_threshold = static_threshold
        # cross-append feature cache: BATrack sets reuse_hint to the window
        # shift when consecutive appends share frames
        self.reuse_hint: Optional[int] = None
        self._fmap_cache: Optional[torch.Tensor] = None

    def _prepare(self, window_rgbd, queries):
        ih, iw = self.p.interp_shape
        H, W = window_rgbd.shape[-2:]
        window = interpolate_bilinear(window_rgbd, (ih, iw))
        q = queries.clone()
        q[:, 1] *= iw / W
        q[:, 2] *= ih / H
        return window, q

    def _static_merge(self, traj, depth, static3d, dyn):
        """Static-branch merge in model-resolution coordinates."""
        if self.use_static_mask:
            dyn_mask = dyn > (1.0 - self.static_threshold)
            traj = torch.where(dyn_mask[..., None], static3d[..., :2], traj)
            depth = torch.where(dyn_mask, static3d[..., 2], depth)
        if self.use_static:
            traj = static3d[..., :2]
            depth = static3d[..., 2]
        return traj, depth

    @torch.no_grad()
    def forward(self, window_rgbd, queries, prev_fmaps=None, reuse: int = 0):
        """(TrackerOutput, fmaps) for one window; window_rgbd (S, 4, H, W)."""
        ih, iw = self.p.interp_shape
        H, W = window_rgbd.shape[-2:]
        window, q = self._prepare(window_rgbd, queries)
        static_iters = None if (self.use_static_mask or self.use_static) else 0
        traj, depth, static3d, vis, dyn, fmaps = self.model(
            window, q, prev_fmaps, reuse, static_iters=static_iters)
        traj, depth = self._static_merge(traj, depth, static3d, dyn)
        scale = torch.tensor([W / iw, H / ih], dtype=torch.float32, device=traj.device)
        return TrackerOutput(tracks=traj * scale, depths=depth, vis=vis, dynamic=dyn), fmaps

    def __call__(self, tin: TrackerInput) -> TrackerOutput:
        reuse = self.reuse_hint or 0
        prev = self._fmap_cache if reuse else None
        if prev is None:
            reuse = 0
        out, self._fmap_cache = self.forward(tin.window_rgbd, tin.queries, prev, reuse)
        return out
