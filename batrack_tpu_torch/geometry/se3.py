"""SE(3) on quaternion+translation vectors, torch tensors.

Layout (..., 7) = [tx, ty, tz, qx, qy, qz, qw], the lietorch convention the
JAX package uses (batrack_tpu/geometry/se3.py). Only the operations the
sparse-SLAM path calls are here: exp, log, mul, inv, act4, matrix and the
left retraction.
"""

from __future__ import annotations

import torch

from batrack_tpu_torch.geometry.quaternion import (
    quat_conj,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_matrix,
    so3_exp,
    so3_left_jacobian,
    so3_left_jacobian_inverse,
    so3_log,
)


def inv(g: torch.Tensor) -> torch.Tensor:
    t, q = g[..., :3], g[..., 3:7]
    qinv = quat_conj(q)
    return torch.cat([-quat_rotate(qinv, t), qinv], dim=-1)


def mul(g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    t1, q1 = g1[..., :3], g1[..., 3:7]
    t2, q2 = g2[..., :3], g2[..., 3:7]
    q = quat_normalize(quat_mul(q1, q2))
    t = t1 + quat_rotate(q1, t2)
    return torch.cat([t, q], dim=-1)


def act4(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply to homogeneous [x, y, z, w] -> [R v + w t, w] (lietorch act4)."""
    v, w = p[..., :3], p[..., 3:4]
    xyz = quat_rotate(g[..., 3:7], v) + w * g[..., :3]
    return torch.cat([xyz, w.expand(xyz.shape[:-1] + (1,))], dim=-1)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """Exponential map: xi = [tau(3), phi(3)] -> SE3 vector."""
    tau, phi = xi[..., :3], xi[..., 3:6]
    q = so3_exp(phi)
    V = so3_left_jacobian(phi)
    t = (V @ tau[..., None])[..., 0]
    return torch.cat([t, q], dim=-1)


def log(g: torch.Tensor) -> torch.Tensor:
    """Logarithm map: SE3 vector -> [tau(3), phi(3)]."""
    t, q = g[..., :3], g[..., 3:7]
    phi = so3_log(q)
    Vinv = so3_left_jacobian_inverse(phi)
    tau = (Vinv @ t[..., None])[..., 0]
    return torch.cat([tau, phi], dim=-1)


def retr(g: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Retraction Exp(xi) * g (left-multiplicative, lietorch groups.py:153)."""
    return mul(exp(xi), g)


def matrix(g: torch.Tensor) -> torch.Tensor:
    """SE3 vector -> homogeneous (..., 4, 4) matrix."""
    t, q = g[..., :3], g[..., 3:7]
    R = quat_to_matrix(q)
    top = torch.cat([R, t[..., None]], dim=-1)
    bot = torch.zeros_like(top[..., :1, :])
    bot[..., 0, 3] = 1.0
    return torch.cat([top, bot], dim=-2)
