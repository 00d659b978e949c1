"""Synthetic scene for smoke runs: a textured plane under a smooth camera
trajectory (the bench world of batrack_tpu/utils/synth.py::make_scene,
written against this package's se3)."""

from __future__ import annotations

import numpy as np
import torch

from batrack_tpu_torch.geometry import se3

_BENCH_COEFFS = (0.05, 0.02, 0.01, 0.004, 0.006, 0.0)


def make_scene(T: int, HT: int, WD: int, INTR, plane_z: float = 6.0,
               xi_scale: float = 1.0, img_seed: int = 0):
    """Returns (images (T, H, W, 3) float32 0..255, depths (T, H, W),
    poses_gt (T, 7) world-to-camera), all numpy, made on the CPU."""
    ts = np.arange(T, dtype=np.float32) * xi_scale
    c = _BENCH_COEFFS
    xi = np.stack(
        [c[0] * ts, c[1] * np.sin(ts * 0.3), c[2] * ts,
         c[3] * np.sin(ts * 0.2), c[4] * np.cos(ts * 0.25) - c[4],
         c[5] * ts], -1).astype(np.float32)
    poses_gt = se3.exp(torch.from_numpy(xi)).numpy()
    fx, fy, cx, cy = INTR
    u, v = np.meshgrid(np.arange(WD), np.arange(HT))
    dirc = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u, np.float32)], -1)

    def plane_depth(p):
        c2w = se3.inv(torch.from_numpy(p))
        R = se3.matrix(c2w)[:3, :3].numpy()
        return ((plane_z - c2w[2].item()) / (dirc @ R.T)[..., 2]).astype(np.float32)

    depths = np.stack([plane_depth(p) for p in poses_gt])
    rng = np.random.default_rng(img_seed)
    images = rng.uniform(0, 255, (T, HT, WD, 3)).astype(np.float32)
    return images, depths, poses_gt
