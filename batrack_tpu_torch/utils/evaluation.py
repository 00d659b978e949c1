"""Trajectory and depth evaluation: ATE / RPE with Sim3 alignment (evo's
conventions), and the depth-error table.

A copy of batrack_tpu/utils/evaluation.py for this package. It runs on the
host in numpy, as the JAX package's does; the quaternion <-> matrix
conversions, which the JAX package takes from scipy's Rotation, come from
this package's geometry (float64 on the CPU), which follows scipy's
formulas.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from batrack_tpu_torch.geometry.quaternion import quat_normalize, quat_to_matrix


def tum_to_matrices(traj: np.ndarray) -> np.ndarray:
    """(N, 7) TUM [tx ty tz qw qx qy qz] -> (N, 4, 4) c2w matrices."""
    traj = np.asarray(traj, np.float64)
    q_xyzw = torch.from_numpy(np.ascontiguousarray(traj[:, [4, 5, 6, 3]]))
    R = quat_to_matrix(quat_normalize(q_xyzw)).numpy()
    out = np.tile(np.eye(4), (len(traj), 1, 1))
    out[:, :3, :3] = R
    out[:, :3, 3] = traj[:, :3]
    return out


def umeyama_alignment(
    x: np.ndarray, y: np.ndarray, with_scale: bool = True
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity aligning x -> y (both (N, 3)).

    Returns (R, t, s) with y ~= s R x + t (Umeyama 1991, the algorithm evo
    uses for align=True/correct_scale=True).
    """
    mu_x = x.mean(axis=0)
    mu_y = y.mean(axis=0)
    var_x = np.mean(np.sum((x - mu_x) ** 2, axis=1))
    cov = (y - mu_y).T @ (x - mu_x) / len(x)
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(d) @ S) / max(var_x, 1e-12)) if with_scale else 1.0
    t = mu_y - s * R @ mu_x
    return R, t, s


def align_trajectory(
    est: np.ndarray, ref: np.ndarray, correct_scale: bool = True
) -> np.ndarray:
    """Align est (N, 4, 4) onto ref (N, 4, 4): P' = [sR, t] * P (evo align)."""
    R, t, s = umeyama_alignment(est[:, :3, 3], ref[:, :3, 3], correct_scale)
    out = est.copy()
    out[:, :3, :3] = np.einsum("ij,njk->nik", R, est[:, :3, :3])
    out[:, :3, 3] = s * np.einsum("ij,nj->ni", R, est[:, :3, 3]) + t
    return out


def ate_rmse(pred: np.ndarray, gt: np.ndarray, correct_scale: bool = True) -> float:
    """Absolute trajectory error RMSE after similarity alignment.

    pred, gt: (N, 7) TUM arrays (evo ape translation_part equivalent).
    """
    P = tum_to_matrices(pred)
    G = tum_to_matrices(gt)
    P = align_trajectory(P, G, correct_scale)
    err = P[:, :3, 3] - G[:, :3, 3]
    return float(np.sqrt(np.mean(np.sum(err**2, axis=1))))


def rpe(
    pred: np.ndarray, gt: np.ndarray, delta: int = 1, correct_scale: bool = True
) -> Tuple[float, float]:
    """Relative pose error at a fixed frame delta, all pairs.

    Returns (trans_rmse, rot_rmse_deg), as evo main_rpe with
    delta_unit=frames, all_pairs=True, align=True, correct_scale=True.
    """
    P = align_trajectory(tum_to_matrices(pred), tum_to_matrices(gt), correct_scale)
    G = tum_to_matrices(gt)

    t_errs, r_errs = [], []
    for i in range(len(P) - delta):
        dP = np.linalg.inv(P[i]) @ P[i + delta]
        dG = np.linalg.inv(G[i]) @ G[i + delta]
        E = np.linalg.inv(dG) @ dP
        t_errs.append(np.linalg.norm(E[:3, 3]))
        cos = np.clip((np.trace(E[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        r_errs.append(np.degrees(np.arccos(cos)))
    return (
        float(np.sqrt(np.mean(np.square(t_errs)))),
        float(np.sqrt(np.mean(np.square(r_errs)))),
    )


def eval_metrics(
    pred_traj, gt_traj=None, seq: str = "", filename: str = ""
) -> Tuple[float, float, float]:
    """pred_traj / gt_traj: (poses (N, 7) TUM, timestamps (N,)) tuples.
    Returns (ate, rpe_trans, rpe_rot) and optionally writes a report file.
    """
    pred, pred_t = pred_traj
    if gt_traj is None:
        return float("nan"), float("nan"), float("nan")
    gt, gt_t = gt_traj

    # associate by index if equal length, else by the NEAREST timestamp (the
    # evo convention)
    pred = np.asarray(pred)
    gt = np.asarray(gt)
    if len(pred) != len(gt):
        gt_t = np.asarray(gt_t).reshape(-1)
        pred_t = np.asarray(pred_t).reshape(-1)
        hi = np.clip(np.searchsorted(gt_t, pred_t), 0, len(gt) - 1)
        lo = np.maximum(hi - 1, 0)
        idx = np.where(np.abs(gt_t[hi] - pred_t) < np.abs(gt_t[lo] - pred_t), hi, lo)
        gt = gt[idx]

    ate = ate_rmse(pred, gt)
    rpe_trans, rpe_rot = rpe(pred, gt, delta=1)

    if filename:
        with open(filename, "w") as f:
            f.write(f"Seq: {seq}\n\n")
            f.write(f"ATE rmse: {ate:.6f}\n")
            f.write(f"RPE trans rmse: {rpe_trans:.6f}\n")
            f.write(f"RPE rot rmse (deg): {rpe_rot:.6f}\n")
    return ate, rpe_trans, rpe_rot


# ---------------------------------------------------------------------------
# depth metrics
# ---------------------------------------------------------------------------

def compute_depth_errors(
    gt: np.ndarray,
    pred: np.ndarray,
    min_depth: float = 1e-2,
    max_depth: float = 1e2,
    scaling: str = "median",
) -> np.ndarray:
    """abs_rel, sq_rel, log10, rmse, rmse_log, a1, a2, a3 (median-scaled)."""
    gt = np.asarray(gt, np.float64).reshape(-1)
    pred = np.asarray(pred, np.float64).reshape(-1)
    if scaling == "median":
        pred = pred * (np.median(gt) / np.median(pred))
    elif scaling == "lstsq":
        A = np.stack([pred, np.ones_like(pred)], axis=1)
        s, t = np.linalg.lstsq(A, gt, rcond=None)[0]
        pred = s * pred + t
    elif scaling == "none":
        pass
    else:
        raise NotImplementedError(scaling)
    pred = np.clip(pred, min_depth, max_depth)

    thresh = np.maximum(gt / pred, pred / gt)
    a1 = float((thresh < 1.25).mean())
    a2 = float((thresh < 1.25**2).mean())
    a3 = float((thresh < 1.25**3).mean())
    rmse = float(np.sqrt(np.mean((gt - pred) ** 2)))
    rmse_log = float(np.sqrt(np.mean((np.log(gt) - np.log(pred)) ** 2)))
    abs_rel = float(np.mean(np.abs(gt - pred) / gt))
    sq_rel = float(np.mean((gt - pred) ** 2 / gt))
    log10 = float(np.mean(np.abs(np.log10(pred) - np.log10(gt))))
    return np.array([abs_rel, sq_rel, log10, rmse, rmse_log, a1, a2, a3])


def eval_depth_maps(
    gt_depths: np.ndarray,
    pred_depths: np.ndarray,
    min_depth: float = 1e-2,
    max_depth: float = 1e2,
    scaling: str = "median",
) -> np.ndarray:
    """Masked depth evaluation over map stacks."""
    mask = (gt_depths > min_depth) & (gt_depths < max_depth)
    return compute_depth_errors(gt_depths[mask], pred_depths[mask], min_depth, max_depth,
                                scaling)
