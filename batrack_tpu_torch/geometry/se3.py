"""SE(3) on quaternion+translation vectors, torch tensors.

Layout (..., 7) = [tx, ty, tz, qx, qy, qz, qw], the lietorch convention the
JAX package uses (batrack_tpu/geometry/se3.py): identity, exp, log, mul,
inv, act, act4, matrix, from_matrix, the left retraction, the adjoints,
the left Jacobians and the thin `SE3` wrapper.
"""

from __future__ import annotations

import torch

from batrack_tpu_torch.geometry.quaternion import (
    _EPS,
    _cross,
    hat,
    matrix_to_quat,
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


def identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    out = torch.zeros(tuple(shape) + (7,), dtype=dtype, device=device)
    out[..., 6] = 1.0
    return out


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


def act(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply to 3D point(s): R p + t."""
    return quat_rotate(g[..., 3:7], p) + g[..., :3]


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


def from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Homogeneous (..., 4, 4) matrix -> SE3 vector."""
    return torch.cat([m[..., :3, 3], matrix_to_quat(m[..., :3, :3])], dim=-1)


def adjoint_matrix(g: torch.Tensor) -> torch.Tensor:
    """Adjoint as a (..., 6, 6) matrix, ordering [tau, phi]:
    [[R, hat(t) R], [0, R]], so that g * Exp(a) = Exp(Adj a) * g."""
    R = quat_to_matrix(g[..., 3:7])
    top = torch.cat([R, hat(g[..., :3]) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def adj(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Adjoint action Adj_g a on tangent vector(s) a (..., 6)."""
    q, t = g[..., 3:7], g[..., :3]
    Rphi = quat_rotate(q, a[..., 3:6])
    return torch.cat([quat_rotate(q, a[..., :3]) + _cross(t, Rphi), Rphi], dim=-1)


def adjT(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Transposed adjoint, rowwise on covectors: [R^T a_t, R^T (a_w - t x a_t)]."""
    a_t, a_w = a[..., :3], a[..., 3:6]
    qinv = quat_conj(g[..., 3:7])
    return torch.cat([quat_rotate(qinv, a_t), quat_rotate(qinv, a_w - _cross(g[..., :3], a_t))],
                     dim=-1)


def _se3_Q(tau: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Barfoot's Q(tau, phi) block of the SE(3) left Jacobian (State
    Estimation eq. 7.86, the signs the JAX package verified)."""
    theta_sq = (phi * phi).sum(-1)[..., None, None]
    small = theta_sq < _EPS
    tsq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(tsq)
    s, c = torch.sin(theta), torch.cos(theta)
    c1 = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0, (theta - s) / (tsq * theta))
    c2 = torch.where(small, 1.0 / 24.0 - theta_sq / 720.0,
                     (theta_sq / 2.0 + c - 1.0) / (tsq * tsq))
    c3 = torch.where(small, 1.0 / 120.0 - theta_sq / 2520.0,
                     (theta - s - theta * theta_sq / 6.0) / (tsq ** 2 * theta))
    T, P = hat(tau), hat(phi)
    PT, TP = P @ T, T @ P
    PTP = PT @ P
    return (0.5 * T + c1 * (PT + TP + PTP) + c2 * (P @ PT + TP @ P - 3.0 * PTP)
            + 0.5 * (c2 + 3.0 * c3) * (PTP @ P + P @ PTP))


def left_jacobian(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) left Jacobian J_l(xi): (..., 6, 6)."""
    J = so3_left_jacobian(xi[..., 3:6])
    Q = _se3_Q(xi[..., :3], xi[..., 3:6])
    return torch.cat([torch.cat([J, Q], -1), torch.cat([torch.zeros_like(J), J], -1)], -2)


def left_jacobian_inverse(xi: torch.Tensor) -> torch.Tensor:
    """Inverse SE(3) left Jacobian (lietorch's Jinv)."""
    Ji = so3_left_jacobian_inverse(xi[..., 3:6])
    JiQJi = Ji @ _se3_Q(xi[..., :3], xi[..., 3:6]) @ Ji
    return torch.cat([torch.cat([Ji, -JiQJi], -1), torch.cat([torch.zeros_like(Ji), Ji], -1)],
                     -2)


class SE3:
    """Thin lietorch-style wrapper over the functions (groups.py:238)."""

    __slots__ = ("data",)

    def __init__(self, data: torch.Tensor):
        self.data = data

    @property
    def shape(self):
        return self.data.shape[:-1]

    def __getitem__(self, idx):
        return SE3(self.data[idx])

    @classmethod
    def Identity(cls, *shape, dtype=torch.float32, device=None):
        return cls(identity(shape, dtype, device))

    @classmethod
    def exp(cls, xi):
        return cls(exp(xi))

    def log(self):
        return log(self.data)

    def inv(self):
        return SE3(inv(self.data))

    def __mul__(self, other):
        if isinstance(other, SE3):
            return SE3(mul(self.data, other.data))
        return self.act(other)

    def act(self, p):
        if p.shape[-1] == 4:
            return act4(self.data, p)
        return act(self.data, p)

    def retr(self, xi):
        return SE3(retr(self.data, xi))

    def adj(self, a):
        return adj(self.data, a)

    def adjT(self, a):
        return adjT(self.data, a)

    def matrix(self):
        return matrix(self.data)

    @classmethod
    def from_matrix(cls, m):
        return cls(from_matrix(m))

    def vec(self):
        return self.data

    def translation(self):
        return self.data[..., :3]
