"""Projective geometry: pinhole (un)projection and SE3 patch transforms with
analytic Jacobians (counterpart of batrack_tpu/geometry/projective.py).

Patches are (..., 3) centre points [x, y, inverse_depth] (patch size 1, as
in the executed reference pipeline).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from batrack_tpu_torch.geometry import se3
from batrack_tpu_torch.geometry.quaternion import quat_conj, quat_rotate, _cross

MIN_DEPTH = 0.2


def iproj(patches: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """[x, y, d] pixel + inverse depth -> homogeneous ray [xn, yn, 1, d]."""
    x, y, d = patches.unbind(-1)
    fx, fy, cx, cy = intrinsics.unbind(-1)
    xn = (x - cx) / fx
    yn = (y - cy) / fy
    return torch.stack([xn, yn, torch.ones_like(d), d], dim=-1)


def proj(X: torch.Tensor, intrinsics: torch.Tensor, depth: bool = False) -> torch.Tensor:
    """Pinhole projection of homogeneous [X, Y, Z, W]."""
    Xs, Ys, Zs, Ws = X.unbind(-1)
    fx, fy, cx, cy = intrinsics.unbind(-1)
    d = 1.0 / torch.clamp(Zs, min=1e-2)
    x = fx * (d * Xs) + cx
    y = fy * (d * Ys) + cy
    if depth:
        return torch.stack([x, y, d * Ws], dim=-1)
    return torch.stack([x, y], dim=-1)


class TransformJacobians(NamedTuple):
    Ji: torch.Tensor  # (E, 2, 6) d(residual)/d(pose_i tangent)
    Jj: torch.Tensor  # (E, 2, 6) d(residual)/d(pose_j tangent)
    Jz: torch.Tensor  # (E, 2, 1) d(residual)/d(inverse depth)


def _adjT(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Transposed adjoint applied rowwise: [R^T a_t, R^T (a_w - t x a_t)]."""
    a_t, a_w = a[..., :3], a[..., 3:6]
    t, q = g[..., :3], g[..., 3:7]
    qinv = quat_conj(q)
    top = quat_rotate(qinv, a_t)
    bot = quat_rotate(qinv, a_w - _cross(t, a_t))
    return torch.cat([top, bot], dim=-1)


def transform(
    poses: torch.Tensor,       # (N, 7) SE3 world-to-camera
    patches: torch.Tensor,     # (K, 3) [x, y, inv_depth]
    intrinsics: torch.Tensor,  # (N, 4) [fx, fy, cx, cy]
    ii: torch.Tensor,          # (E,) source frame of each edge
    jj: torch.Tensor,          # (E,) target frame of each edge
    kk: torch.Tensor,          # (E,) patch index of each edge
    jacobian: bool = False,
    depth: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[TransformJacobians]]:
    """Reproject patch kk from frame ii into frame jj.

    Jj is the derivative of the projected pixel with respect to a left
    perturbation Exp(xi) G_j, Ji = -AdjT(G_ij) Jj, and Jz is with respect to
    the patch inverse depth. Returns (coords, valid, jacobians or None);
    valid is the Z > MIN_DEPTH gate.
    """
    X0 = iproj(patches[kk], intrinsics[ii])
    Gij = se3.mul(poses[jj], se3.inv(poses[ii]))
    X1 = se3.act4(Gij, X0)
    intr_j = intrinsics[jj]
    x1 = proj(X1, intr_j, depth=depth)
    valid = (X1[..., 2] > MIN_DEPTH).to(X1.dtype)
    if not jacobian:
        return x1, valid, None

    X, Y, Z, H = X1.unbind(-1)
    o = torch.zeros_like(H)
    fx, fy = intr_j[..., 0], intr_j[..., 1]
    big = Z.abs() > MIN_DEPTH
    d = torch.where(big, 1.0 / torch.where(big, Z, torch.ones_like(Z)), o)

    Ja = torch.stack(
        [
            torch.stack([H, o, o, o, Z, -Y], dim=-1),
            torch.stack([o, H, o, -Z, o, X], dim=-1),
            torch.stack([o, o, H, Y, -X, o], dim=-1),
        ],
        dim=-2,
    )  # (E, 3, 6)
    Jp = torch.stack(
        [
            torch.stack([fx * d, o, -fx * X * d * d], dim=-1),
            torch.stack([o, fy * d, -fy * Y * d * d], dim=-1),
        ],
        dim=-2,
    )  # (E, 2, 3)
    Jj = Jp @ Ja
    Ji = -_adjT(Gij[..., None, :], Jj)
    Jz = (Jp @ Gij[..., :3, None])  # (E, 2, 1): translation column of Gij
    return x1, valid, TransformJacobians(Ji, Jj, Jz)


def point_cloud(
    poses: torch.Tensor, patches: torch.Tensor, intrinsics: torch.Tensor,
    ix: torch.Tensor,
) -> torch.Tensor:
    """Back-project patches into world space; homogeneous (K, 4)."""
    G_inv = se3.inv(poses[ix])
    return se3.act4(G_inv, iproj(patches, intrinsics[ix]))
