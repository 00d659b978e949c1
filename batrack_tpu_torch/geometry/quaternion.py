"""Quaternion primitives (scalar-last, [x, y, z, w]) on torch tensors.

Elementwise math that broadcasts over arbitrary leading dimensions; the same
formulas as batrack_tpu/geometry/quaternion.py, so both packages agree to
float rounding. Small matrix products run in full float32 (callers wrap
CUDA work in utils.config.full_fp32, the counterpart of the JAX package's
Precision.HIGHEST).
"""

from __future__ import annotations

import math

import torch

# Threshold below which Taylor expansions replace trig ratios.
_EPS = 1e-6


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2, scalar-last convention."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (== inverse for unit quaternions)."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate 3-vector(s) v by unit quaternion(s) q: v + w t + qv x t with
    t = 2 qv x v."""
    qv = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * _cross(qv, v)
    return v + w * t + _cross(qv, t)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> (..., 3, 3) rotation matrix."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> unit quaternion [x, y, z, w].

    Shepperd's method with scipy's branch choice (Rotation.from_matrix): the
    largest of the trace and the three diagonal entries picks the component
    computed from a square, so the quaternion's sign matches scipy's, and
    with it every TUM file the JAX package writes. Branch-free (all four
    candidates, then a gather), so it runs batched on any device."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    cands = torch.stack([
        torch.stack([1.0 - tr + 2.0 * m00, m10 + m01, m20 + m02, m21 - m12], -1),
        torch.stack([m01 + m10, 1.0 - tr + 2.0 * m11, m21 + m12, m02 - m20], -1),
        torch.stack([m02 + m20, m12 + m21, 1.0 - tr + 2.0 * m22, m10 - m01], -1),
        torch.stack([m21 - m12, m02 - m20, m10 - m01, 1.0 + tr], -1),
    ], -2)  # (..., 4, 4): one candidate per branch
    choice = torch.stack([m00, m11, m22, tr], -1).argmax(-1)
    q = torch.gather(cands, -2, choice[..., None, None].expand(choice.shape + (1, 4)))[..., 0, :]
    return quat_normalize(q)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Axis-angle 3-vector -> unit quaternion, stable near zero."""
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    small = theta_sq < _EPS
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    half = 0.5 * theta
    k = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([k * phi, w], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> axis-angle 3-vector (atan form, hemisphere
    invariant: always the short rotation, |angle| <= pi)."""
    qv = q[..., :3]
    w = q[..., 3:4]
    n_sq = (qv * qv).sum(-1, keepdim=True)
    small = n_sq < _EPS
    n = torch.sqrt(torch.where(small, torch.ones_like(n_sq), n_sq))
    tiny_w = w.abs() < 1e-12
    w_safe = torch.where(tiny_w, torch.full_like(w, 1e-12), w)
    k_big = torch.where(
        tiny_w,
        torch.where(w >= 0, math.pi, -math.pi) / n,
        2.0 * torch.atan(n / w_safe) / n,
    )
    k = torch.where(small, 2.0 / w_safe - 2.0 * n_sq / (3.0 * w_safe ** 3), k_big)
    return k * qv


def hat(v: torch.Tensor) -> torch.Tensor:
    """3-vector -> skew-symmetric matrix (..., 3, 3)."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    m = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def _eye_like(P: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=P.dtype, device=P.device).expand(P.shape)


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian V(phi): (..., 3, 3)."""
    theta_sq = (phi * phi).sum(-1)[..., None, None]
    small = theta_sq < _EPS
    tsq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(tsq)
    a = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / tsq)
    b = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / (tsq * theta))
    P = hat(phi)
    return _eye_like(P) + a * P + b * (P @ P)


def so3_left_jacobian_inverse(phi: torch.Tensor) -> torch.Tensor:
    """Inverse SO(3) left Jacobian V^-1(phi): (..., 3, 3)."""
    theta_sq = (phi * phi).sum(-1)[..., None, None]
    small = theta_sq < _EPS
    tsq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(tsq)
    half = 0.5 * theta
    cot = torch.cos(half) / torch.where(small, torch.ones_like(half), torch.sin(half))
    c = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                    1.0 / tsq - cot / (2.0 * theta))
    P = hat(phi)
    return _eye_like(P) - 0.5 * P + c * (P @ P)
