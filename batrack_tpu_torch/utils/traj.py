"""Trajectory loading and saving in the formats the JAX package supports.

A copy of batrack_tpu/utils/traj.py for this package: Sintel .cam
extrinsics, TartanAir/TUM axis shuffles, kitti/replica matrix rows, and the
TUM writer. All loaders return (traj (N, 7) [tx ty tz qw qx qy qz]
camera-to-world, timestamps). Rotation -> quaternion goes through this
package's geometry.quaternion.matrix_to_quat (scipy's branch choice, so the
signs, and the files written from them, match the JAX package's).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from batrack_tpu_torch.data.streams import cam_read_sintel as sintel_cam_read
from batrack_tpu_torch.geometry.quaternion import matrix_to_quat

logger = logging.getLogger(__name__)


def _rows_tum(xyz: np.ndarray, R: np.ndarray) -> np.ndarray:
    """(N, 3) positions and (N, 3, 3) rotations -> (N, 7) [xyz, qw qx qy qz]."""
    q_xyzw = matrix_to_quat(torch.from_numpy(np.asarray(R, np.float64))).numpy()
    return np.concatenate([xyz, q_xyzw[:, [3, 0, 1, 2]]], axis=1)


def load_sintel_traj(gt_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """Per-frame .cam files -> TUM c2w, mean-centred."""
    files = [os.path.join(gt_dir, x) for x in sorted(os.listdir(gt_dir))]
    tstamps = [float(Path(x).stem.split("_")[-1]) for x in files]
    c2w = []
    for f in files:
        _, ext = sintel_cam_read(f)
        w2c = np.concatenate([ext, np.array([[0.0, 0.0, 0.0, 1.0]])], 0)
        c2w.append(np.linalg.inv(w2c))
    c2w = np.stack(c2w)
    traj = _rows_tum(c2w[:, :3, 3], c2w[:, :3, :3])
    traj[:, :3] -= traj[:, :3].mean(axis=0, keepdims=True)
    return traj, np.asarray(tstamps)[:, None]


def read_tum_file(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """TUM text file: t tx ty tz qx qy qz qw -> ((N,7) wxyz, tstamps)."""
    rows = []
    ts = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            ts.append(vals[0])
            xyz = vals[1:4]
            qx, qy, qz, qw = vals[4:8]
            rows.append(xyz + [qw, qx, qy, qz])
    return np.asarray(rows), np.asarray(ts)


def load_tartanair_traj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """TartanAir NED axis shuffle."""
    traj, ts = read_tum_file(path)
    xyz = traj[:, :3][:, [1, 2, 0]]
    quat = traj[:, 3:7][:, [0, 2, 3, 1]]  # wxyz reorder (w, y, z, x)
    return np.column_stack([xyz, quat]), ts


def load_matrix_rows_traj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """kitti/replica 12- or 16-value row-major pose matrices per line."""
    raw = np.atleast_2d(np.loadtxt(path))
    m = raw[:, :12].reshape(-1, 3, 4)
    return _rows_tum(m[:, :, 3], m[:, :, :3]), np.arange(len(m), dtype=float)


def load_traj(
    gt_traj_file: str,
    traj_format: str = "replica",
    skip: int = 0,
    end: int = -1,
    stride: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    if traj_format == "sintel":
        traj, ts = load_sintel_traj(gt_traj_file)
    elif traj_format == "tartanair":
        traj, ts = load_tartanair_traj(gt_traj_file)
    elif traj_format == "tum":
        traj, ts = read_tum_file(gt_traj_file)
    elif traj_format in ("kitti", "replica"):
        traj, ts = load_matrix_rows_traj(gt_traj_file)
    else:
        raise NotImplementedError(traj_format)
    if end == -1:
        end = traj.shape[0]
    return traj[skip:end:stride], np.asarray(ts)[skip:end:stride]


def save_trajectory_tum_format(traj, filename: str) -> None:
    """(poses (N,7) [tx ty tz qw qx qy qz], tstamps) -> TUM text file."""
    poses, tstamps = traj
    with open(filename, "w") as f:
        for i in range(len(poses)):
            p = poses[i]
            # xyzw quaternion order on disk
            f.write(f"{tstamps[i]} {p[0]} {p[1]} {p[2]} {p[4]} {p[5]} {p[6]} {p[3]}\n")


def plot_trajectory(pred_traj, gt_traj=None, title: str = "", filename: str = "") -> bool:
    """Top-down trajectory plot. matplotlib is optional: without it, logs
    one warning, writes nothing and returns False."""
    try:
        import matplotlib
    except ImportError:
        logger.warning("matplotlib is not installed: no trajectory plot written to %s",
                       filename or "(no file)")
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from batrack_tpu_torch.utils.evaluation import align_trajectory, tum_to_matrices

    pred, _ = pred_traj
    P = tum_to_matrices(np.asarray(pred))
    fig, ax = plt.subplots(figsize=(8, 8))
    if gt_traj is not None:
        G = tum_to_matrices(np.asarray(gt_traj[0]))
        P = align_trajectory(P, G)
        var = np.var(G[:, :3, 3], axis=0)
        i2, i1 = np.argsort(var)[-1], np.argsort(var)[-2]
        ax.plot(G[:, i2, 3], G[:, i1, 3], "--", color="gray", label="Ground Truth")
    else:
        var = np.var(P[:, :3, 3], axis=0)
        i2, i1 = np.argsort(var)[-1], np.argsort(var)[-2]
    ax.plot(P[:, i2, 3], P[:, i1, 3], "-", color="blue", label="Predicted")
    ax.set_title(title)
    ax.legend()
    ax.set_aspect("equal", adjustable="datalim")
    if filename:
        fig.savefig(filename)
    plt.close(fig)
    return True
