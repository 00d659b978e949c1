"""The synthetic RGB-D scene a stream's sequences are cut from: the port's
smoke scene (a plane at depth 6 under a smooth camera path, its texture
uint8 noise), made on the device from the seed and handed to the host as
the frames a user's loader would give."""

from __future__ import annotations

import torch

from reference import geometry as g

PLANE_Z = 6.0
# translation x, y (sin), z, then rotation x (sin), y (cos), z per frame
COEFFS = (0.05, 0.02, 0.01, 0.004, 0.006, 0.0)


def camera_path(T: int, device, motion: float = 1.0) -> torch.Tensor:
    """(T, 7) world-to-camera poses; `motion` scales the path (0: still)."""
    ts = torch.arange(T, dtype=torch.float32, device=device)
    c = [motion * x for x in COEFFS]
    xi = torch.stack([c[0] * ts, c[1] * torch.sin(ts * 0.3), c[2] * ts, c[3] * torch.sin(ts * 0.2),
                      c[4] * torch.cos(ts * 0.25) - c[4], c[5] * ts], -1)
    return g.se3_exp(xi)


def make_scene(T: int, ht: int, wd: int, intr, seed: int, device, motion: float = 1.0):
    """(images (T, H, W, 3) uint8, depths (T, H, W) float32), numpy on the
    host, the same for the same seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    images = torch.randint(0, 256, (T, ht, wd, 3), generator=gen, device=device, dtype=torch.uint8)
    fx, fy, cx, cy = intr
    v, u = torch.meshgrid(torch.arange(ht, device=device, dtype=torch.float32),
                          torch.arange(wd, device=device, dtype=torch.float32), indexing="ij")
    rays = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1)   # (H, W, 3)
    c2w = g.se3_inv(camera_path(T, device, motion))
    R = g.quat_to_matrix(c2w[:, 3:7])                                            # (T, 3, 3)
    depths = (PLANE_Z - c2w[:, 2, None, None]) / torch.einsum("hwc,tc->thw", rays, R[:, 2, :])
    return images.cpu().numpy(), depths.float().cpu().numpy()
