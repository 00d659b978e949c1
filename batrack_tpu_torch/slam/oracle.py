"""Oracle tracker: ground-truth reprojection tracks for testing the SLAM
system (counterpart of batrack_tpu/slam/oracle.py).

It fills the tracker slot with perfect static tracks from known poses and
the window's depth maps, so patches, the factor graph, the BA, keyframe
removal and the export run end to end on tracks whose answer is known. No
kernel runs in it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from batrack_tpu_torch.geometry import se3
from batrack_tpu_torch.ops.sampling import bilinear_sample2d
from batrack_tpu_torch.slam.frontend import TrackerInput, TrackerOutput
from batrack_tpu_torch.slam.state import StaticDims
from batrack_tpu_torch.utils.config import resolve_device

# (shape) -> standard-normal draws of that shape
NoiseHook = Callable[[tuple], torch.Tensor]


class OracleTracker:
    """Reprojects each query into every window frame with the true geometry.

    gt_poses: (T, 7) world-to-camera SE3 of every global frame.
    intrinsics: (4,) shared pinhole.
    noise: pixel-noise scale; its standard-normal draws come from a
        torch.Generator seeded with `seed`, or from `noise_hook` when set
        (tests set it to inject the JAX package's draws, which torch cannot
        reproduce).
    dynamic_velocity: optional (3,) world velocity (units per frame) of the
        points that `dynamic_region` selects, a rigidly moving object; those
        tracks are labelled dynamic=1, which exercises the motion-decoupled
        gating as the learned motion head does.
    dynamic_region: predicate (NQ, 3) world points -> (NQ,) bool tensor.
    device: where the outputs are made (default CUDA; raises when CUDA is
        asked for and absent).
    """

    def __init__(self, gt_poses, intrinsics, dims: StaticDims, noise: float = 0.0,
                 seed: int = 0, dynamic_velocity=None, dynamic_region=None, device="cuda"):
        self.device = resolve_device(device)
        self.gt_poses = torch.as_tensor(gt_poses, dtype=torch.float32).to(self.device)
        self.intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32).to(self.device)
        self.dims = dims
        self.noise = noise
        self.dynamic_velocity = (None if dynamic_velocity is None else torch.as_tensor(
            dynamic_velocity, dtype=torch.float32).to(self.device))
        self.dynamic_region = dynamic_region
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.noise_hook: Optional[NoiseHook] = None

    def __call__(self, tin: TrackerInput) -> TrackerOutput:
        S, H, W = self.dims.S_slam, self.dims.ht, self.dims.wd
        T = self.gt_poses.shape[0]
        sid = tin.queries[:, 0].long()
        # global frame counters, so that removed keyframes do not shift the map
        q_frame = tin.win_tstamps.long()[sid].clamp(0, T - 1)

        # depth at the query from its own window frame: every frame sampled
        # at the query coords, then selected by source id
        NQ = tin.queries.shape[0]
        xq, yq = tin.queries[:, 1], tin.queries[:, 2]
        d_all = bilinear_sample2d(tin.window_rgbd[:, 3:4], xq[None].expand(S, NQ),
                                  yq[None].expand(S, NQ))[:, 0]  # (S, NQ)
        d = d_all.gather(0, sid[None])[0].clamp(min=1e-2)

        fx, fy, cx, cy = self.intrinsics.unbind(-1)
        X0 = torch.stack([(xq - cx) / fx * d, (yq - cy) / fy * d, d, torch.ones_like(d)], -1)
        Pw = se3.act4(se3.inv(self.gt_poses[q_frame]), X0)

        w_frames = tin.win_tstamps.long().clamp(0, T - 1)
        G = self.gt_poses[w_frames]  # (S, 7)
        if self.dynamic_velocity is not None:
            dyn_mask = self.dynamic_region(Pw[:, :3])  # (NQ,)
            dt = (w_frames[:, None] - q_frame[None, :]).to(torch.float32)
            disp = dt[..., None] * self.dynamic_velocity  # (S, NQ, 3)
            Pw_t = Pw[None, :, :3] + torch.where(dyn_mask[None, :, None], disp,
                                                 torch.zeros_like(disp))
            Pw_t = torch.cat([Pw_t, torch.ones_like(Pw_t[..., :1])], -1)
            Xc = se3.act4(G[:, None, :], Pw_t)  # (S, NQ, 4)
        else:
            dyn_mask = torch.zeros(NQ, dtype=torch.bool, device=Pw.device)
            Xc = se3.act4(G[:, None, :], Pw[None, :, :])
        z = Xc[..., 2].clamp(min=1e-2)
        x = fx * Xc[..., 0] / z + cx
        y = fy * Xc[..., 1] / z + cy

        if self.noise > 0:
            shape = tuple(x.shape) + (2,)
            draw = (self.noise_hook(shape) if self.noise_hook is not None
                    else torch.randn(shape, generator=self.generator, device=self.device))
            xy_noise = self.noise * draw.to(x.device, x.dtype)
            x = x + xy_noise[..., 0]
            y = y + xy_noise[..., 1]

        vis = ((x >= 0) & (x < W) & (y >= 0) & (y < H) & (Xc[..., 2] > 0.05)).to(torch.float32)
        return TrackerOutput(tracks=torch.stack([x, y], -1), depths=z, vis=vis,
                             dynamic=dyn_mask.to(torch.float32)[None, :].expand(z.shape))
