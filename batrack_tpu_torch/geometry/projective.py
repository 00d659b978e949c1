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
    tonly: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[TransformJacobians]]:
    """Reproject patch kk from frame ii into frame jj.

    Jj is the derivative of the projected pixel with respect to a left
    perturbation Exp(xi) G_j, Ji = -AdjT(G_ij) Jj, and Jz is with respect to
    the patch inverse depth. Returns (coords, valid, jacobians or None);
    valid is the Z > MIN_DEPTH gate. tonly zeroes the relative rotation
    (projective_ops.py:63-64).
    """
    X0 = iproj(patches[kk], intrinsics[ii])
    Gij = se3.mul(poses[jj], se3.inv(poses[ii]))
    if tonly:
        Gij = torch.cat([Gij[..., :3], torch.zeros_like(Gij[..., 3:6]),
                         torch.ones_like(Gij[..., 6:7])], dim=-1)
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


def flow_mag(poses: torch.Tensor, patches: torch.Tensor, intrinsics: torch.Tensor,
             ii: torch.Tensor, jj: torch.Tensor, kk: torch.Tensor,
             beta: float = 0.3) -> torch.Tensor:
    """Blended full/translation-only flow magnitude (projective_ops.py:112-122)."""
    coords0, _, _ = transform(poses, patches, intrinsics, ii, ii, kk)
    coords1, _, _ = transform(poses, patches, intrinsics, ii, jj, kk)
    coords2, _, _ = transform(poses, patches, intrinsics, ii, jj, kk, tonly=True)
    flow1 = torch.linalg.vector_norm(coords1 - coords0, dim=-1)
    flow2 = torch.linalg.vector_norm(coords2 - coords0, dim=-1)
    return beta * flow1 + (1.0 - beta) * flow2


def back_proj(xy: torch.Tensor, xy_depth: torch.Tensor, intrinsics: torch.Tensor,
              cams_c2w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pixels (..., N, 2) + depth (..., N, 1) -> homogeneous (..., N, 4)
    camera points, or world points through cams_c2w (..., 4, 4)
    (projective_ops.py:129-149)."""
    fx, fy, cx, cy = intrinsics.movedim(-1, 0)
    X = (xy[..., 0] - cx[..., None]) / fx[..., None]
    Y = (xy[..., 1] - cy[..., None]) / fy[..., None]
    D = xy_depth[..., 0]
    P = torch.stack([X * D, Y * D, D, torch.ones_like(X)], dim=-1)
    if cams_c2w is not None:
        P = torch.einsum("...ij,...nj->...ni", cams_c2w, P)
    return P


def proj_to_frames(P: torch.Tensor, intrinsics: torch.Tensor,
                   cams_w2c: torch.Tensor) -> torch.Tensor:
    """Project world points P (..., N, 4) into frames cams_w2c (..., S, 4, 4)
    -> (..., S, N, 2) (projective_ops.py:151-175)."""
    P_c = torch.einsum("...sij,...nj->...sni", cams_w2c, P)
    fx, fy, cx, cy = intrinsics.movedim(-1, 0)
    d = 1.0 / P_c[..., 2]
    x = fx[..., None] * (P_c[..., 0] * d) + cx[..., None]
    y = fy[..., None] * (P_c[..., 1] * d) + cy[..., None]
    return torch.stack([x, y], dim=-1)
