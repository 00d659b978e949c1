"""Plain SE(3) and pinhole geometry for the benchmark's reference.

Poses are (..., 7) = [tx, ty, tz, qx, qy, qz, qw] (the lietorch layout),
world-to-camera. A frozen copy of the formulas the SLAM loop is defined by;
it imports nothing of the measured program.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-6


def quat_mul(q1, q2):
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """v + w t + qv x t with t = 2 qv x v."""
    qv, w = q[..., :3], q[..., 3:4]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def quat_to_matrix(q):
    x, y, z, w = q.unbind(-1)
    m = torch.stack([
        1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z), 2.0 * (x * z + w * y),
        2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - w * x),
        2.0 * (x * z - w * y), 2.0 * (y * z + w * x), 1.0 - 2.0 * (x * x + y * y),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def so3_exp(phi):
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    small = theta_sq < _EPS
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    k = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(0.5 * theta) / theta)
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(0.5 * theta))
    return torch.cat([k * phi, w], dim=-1)


def so3_log(q):
    """Unit quaternion -> axis-angle (the short rotation)."""
    qv, w = q[..., :3], q[..., 3:4]
    n_sq = (qv * qv).sum(-1, keepdim=True)
    small = n_sq < _EPS
    n = torch.sqrt(torch.where(small, torch.ones_like(n_sq), n_sq))
    tiny_w = w.abs() < 1e-12
    w_safe = torch.where(tiny_w, torch.full_like(w, 1e-12), w)
    k_big = torch.where(tiny_w, torch.where(w >= 0, math.pi, -math.pi) / n,
                        2.0 * torch.atan(n / w_safe) / n)
    k = torch.where(small, 2.0 / w_safe - 2.0 * n_sq / (3.0 * w_safe ** 3), k_big)
    return k * qv


def hat(v):
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    m = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def _jacobian_terms(phi):
    theta_sq = (phi * phi).sum(-1)[..., None, None]
    small = theta_sq < _EPS
    tsq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    return theta_sq, small, tsq, torch.sqrt(tsq)


def so3_left_jacobian(phi):
    theta_sq, small, tsq, theta = _jacobian_terms(phi)
    a = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / tsq)
    b = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0, (theta - torch.sin(theta)) / (tsq * theta))
    P = hat(phi)
    eye = torch.eye(3, dtype=P.dtype, device=P.device).expand(P.shape)
    return eye + a * P + b * (P @ P)


def so3_left_jacobian_inverse(phi):
    theta_sq, small, tsq, theta = _jacobian_terms(phi)
    half = 0.5 * theta
    cot = torch.cos(half) / torch.where(small, torch.ones_like(half), torch.sin(half))
    c = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0, 1.0 / tsq - cot / (2.0 * theta))
    P = hat(phi)
    eye = torch.eye(3, dtype=P.dtype, device=P.device).expand(P.shape)
    return eye - 0.5 * P + c * (P @ P)


def se3_inv(g):
    qinv = quat_conj(g[..., 3:7])
    return torch.cat([-quat_rotate(qinv, g[..., :3]), qinv], dim=-1)


def se3_mul(g1, g2):
    q1 = g1[..., 3:7]
    q = quat_mul(q1, g2[..., 3:7])
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.cat([g1[..., :3] + quat_rotate(q1, g2[..., :3]), q], dim=-1)


def se3_act4(g, p):
    """[x, y, z, w] -> [R v + w t, w]."""
    v, w = p[..., :3], p[..., 3:4]
    xyz = quat_rotate(g[..., 3:7], v) + w * g[..., :3]
    return torch.cat([xyz, w.expand(xyz.shape[:-1] + (1,))], dim=-1)


def se3_exp(xi):
    phi = xi[..., 3:6]
    t = (so3_left_jacobian(phi) @ xi[..., :3, None])[..., 0]
    return torch.cat([t, so3_exp(phi)], dim=-1)


def se3_log(g):
    phi = so3_log(g[..., 3:7])
    tau = (so3_left_jacobian_inverse(phi) @ g[..., :3, None])[..., 0]
    return torch.cat([tau, phi], dim=-1)


def se3_retr(g, xi):
    """Left retraction Exp(xi) * g."""
    return se3_mul(se3_exp(xi), g)


def iproj(patches, intrinsics):
    """[x, y, d] -> homogeneous ray [xn, yn, 1, d]."""
    x, y, d = patches.unbind(-1)
    fx, fy, cx, cy = intrinsics.unbind(-1)
    return torch.stack([(x - cx) / fx, (y - cy) / fy, torch.ones_like(d), d], dim=-1)


def proj(X, intrinsics, depth=False):
    Xs, Ys, Zs, Ws = X.unbind(-1)
    fx, fy, cx, cy = intrinsics.unbind(-1)
    d = 1.0 / torch.clamp(Zs, min=1e-2)
    x = fx * (d * Xs) + cx
    y = fy * (d * Ys) + cy
    if depth:
        return torch.stack([x, y, d * Ws], dim=-1)
    return torch.stack([x, y], dim=-1)


def reproject(poses, patches, intrinsics, ii, jj, kk):
    """Pixel coordinates of patch kk of frame ii seen from frame jj."""
    X0 = iproj(patches[kk], intrinsics[ii])
    Gij = se3_mul(poses[jj], se3_inv(poses[ii]))
    return proj(se3_act4(Gij, X0), intrinsics[jj])


def point_cloud(poses, patches, intrinsics, ix):
    """Patches back-projected into the world, homogeneous (K, 4)."""
    return se3_act4(se3_inv(poses[ix]), iproj(patches, intrinsics[ix]))
