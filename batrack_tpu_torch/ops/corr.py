"""Correlation pyramid ops for the point tracker (plain PyTorch).

Counterpart of batrack_tpu/ops/corr.py. Bilinearly sampling the all-pairs
correlation volume at float coords equals the dot product of the track
feature with the bilinearly sampled feature window, so only the (2r+2)^2
feature window per track is gathered (`patchify`, zero padding) and
contracted with the track feature. This module is the plain version of the
correlation kernel K1 (ops/corr_kernel.py).
"""

from __future__ import annotations

import math

import torch

from batrack_tpu_torch.ops.sampling import avg_pool2d, patchify


def build_pyramid(fmaps: torch.Tensor, num_levels: int) -> list:
    """Average-pooled feature maps; level i has H/2^i. fmaps: (S, C, H, W)."""
    pyramid = [fmaps]
    for _ in range(num_levels - 1):
        fmaps = avg_pool2d(fmaps, 2, 2)
        pyramid.append(fmaps)
    return pyramid


def corr_sample_level(
    fmaps: torch.Tensor,   # (S, C, H, W) one pyramid level
    targets: torch.Tensor, # (S, N, C) per-track features
    coords: torch.Tensor,  # (S, N, 2) coords at this level's resolution
    radius: int,
) -> torch.Tensor:
    """Fused correlation sampling for one level -> (S, N, (2r+1)^2)."""
    C = fmaps.shape[1]
    d = 2 * radius + 1
    windows = patchify(fmaps, coords, radius, padding_mode="zeros")  # (S, N, C, d, d)
    corr = torch.einsum("snchw,snc->snhw", windows, targets)
    corr = corr / math.sqrt(C)
    # the reference flattens the window TRANSPOSED (its delta grid is
    # meshgrid(dy, dx) but the centroid add is (x, y)): out[i, j] reads the
    # volume at (x + off_i, y + off_j). The weights are trained with it.
    corr = corr.transpose(-1, -2)
    return corr.reshape(corr.shape[0], corr.shape[1], d * d)


def corr_sample_pyramid(
    pyramid: list,          # [(S, C, H_l, W_l)]
    targets: torch.Tensor,  # (S, N, C)
    coords: torch.Tensor,   # (S, N, 2) at level-0 resolution
    radius: int,
) -> torch.Tensor:
    """All levels concatenated: (S, N, L*(2r+1)^2); level l samples at
    coords / 2^l."""
    outs = [
        corr_sample_level(fm, targets, coords / (2.0 ** lvl), radius)
        for lvl, fm in enumerate(pyramid)
    ]
    return torch.cat(outs, dim=-1)
