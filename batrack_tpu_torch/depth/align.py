"""Stage-1 depth-prior alignment: relative disparity -> normalised metric
depth. A numpy copy of batrack_tpu/depth/align.py (get_mono_depth.py:21-150):
per-frame median scale/shift fits of DepthAnythingV2's disparity against
UniDepthV2's metric depth, a global (scale, shift) at the median
scale*shift product, 98th-percentile normalisation and a shared pinhole K
from the median metric FOV.

Two differences of means, not of results: the disparity resize is the
numpy replica of cv2.INTER_NEAREST_EXACT (depth/cvresize.py), and the image
size comes from the first frame's header (data/image.py::image_size),
not from decoding it.
"""

from __future__ import annotations

import glob
import os
from typing import List, Sequence, Tuple

import numpy as np

from batrack_tpu_torch.data.image import image_size
from batrack_tpu_torch.depth.cvresize import resize_nearest_exact as resize_nearest


def intrinsics_to_fov(K: np.ndarray, depth: np.ndarray) -> float:
    """Horizontal FOV in degrees."""
    return float(np.rad2deg(2 * np.arctan(depth.shape[-1] / (2 * K[0, 0]))))


def fit_frame_scale_shift(mono_disp: np.ndarray,
                          metric_depth: np.ndarray) -> Tuple[float, float, float]:
    """Median-based scale/shift of mono disparity onto metric disparity:
    (scale, shift, sky_ratio), with UniDepth's near-field guard and the
    unmasked final fit that the reference keeps."""
    gt_disp = 1.0 / (metric_depth + 1e-8)
    invalid = (metric_depth < 2.0) & (mono_disp < 0.02)
    gt_disp = gt_disp.copy()
    gt_disp[invalid] = 1e-2
    sky_ratio = float(np.mean(mono_disp < 0.01))
    gt_ms = gt_disp - np.median(gt_disp) + 1e-8
    da_ms = mono_disp - np.median(mono_disp) + 1e-8
    scale = float(np.median(gt_ms / da_ms))
    shift = float(np.median(gt_disp - scale * mono_disp))
    return scale, shift, sky_ratio


def align_depth_sequence(mono_disps: Sequence[np.ndarray], metric_depths: Sequence[np.ndarray],
                         metric_Ks: Sequence[np.ndarray],
                         image_wh: Tuple[int, int]) -> Tuple[List[np.ndarray], np.ndarray]:
    """Align a whole sequence; returns (aligned depth maps, shared K)."""
    scales, shifts, fovs, disps = [], [], [], []
    for disp, depth, K in zip(mono_disps, metric_depths, metric_Ks):
        fovs.append(intrinsics_to_fov(np.asarray(K), np.asarray(depth)))
        disp = resize_nearest(np.float32(disp), depth.shape[:2])
        disps.append(disp)
        s, t, _ = fit_frame_scale_shift(disp, np.asarray(depth))
        scales.append(s)
        shifts.append(t)

    W, H = image_wh
    ff = W / (2 * np.tan(np.radians(np.median(fovs) / 2.0)))
    K = np.eye(3)
    K[0, 0] = K[1, 1] = ff
    K[0, 2] = W / 2.0
    K[1, 2] = H / 2.0

    ss = np.asarray(scales) * np.asarray(shifts)
    med_idx = int(np.argmin(np.abs(ss - np.median(ss))))
    a_scale, a_shift = scales[med_idx], shifts[med_idx]
    norm = float(np.percentile(a_scale * np.asarray(disps) + a_shift, 98) / 2.0)

    out = []
    for disp in disps:
        depth = np.clip(1.0 / ((1.0 / norm) * (a_scale * disp + a_shift)), 1e-4, 1e4)
        depth[depth < 1e-2] = 0.0
        out.append(depth.astype(np.float32))
    return out, K


def align_depth_dirs(mono_depth_dir: str, metric_depth_dir: str, image_dir: str,
                     save_depth_dir: str, save_K_dir: str) -> None:
    """Files in, files out: *.npy relative disparities and *.npz {depth,
    intrinsics} in; aligned *.npy depths and *_intrinsics.npy out."""
    os.makedirs(save_depth_dir, exist_ok=True)
    os.makedirs(save_K_dir, exist_ok=True)
    mono_paths = sorted(glob.glob(os.path.join(mono_depth_dir, "*.npy")))
    metric_paths = sorted(glob.glob(os.path.join(metric_depth_dir, "*.npz")))
    images = sorted(glob.glob(os.path.join(image_dir, "*.jpg"))
                    + glob.glob(os.path.join(image_dir, "*.png")))
    H, W = image_size(images[0])

    mono = [np.load(p) for p in mono_paths]
    metric = [np.load(p) for p in metric_paths]
    aligned, K = align_depth_sequence(mono, [m["depth"] for m in metric],
                                      [m["intrinsics"] for m in metric], (W, H))
    for p_metric, depth in zip(metric_paths, aligned):
        base = os.path.basename(p_metric).replace(".npz", "")
        np.save(os.path.join(save_depth_dir, base + ".npy"), depth)
        np.save(os.path.join(save_K_dir, base + "_intrinsics.npy"), K)
