"""RxSO(3) and Sim(3) on torch tensors (counterpart of
batrack_tpu/geometry/sim3.py). Layouts follow lietorch (groups.py:249-311):

  RxSO3: (..., 5) = [qx, qy, qz, qw, s]
  Sim3:  (..., 8) = [tx, ty, tz, qx, qy, qz, qw, s]

Tangent ordering: RxSO3 [phi(3), sigma(1)]; Sim3 [tau(3), phi(3), sigma(1)].
Plain tensor functions; `RxSO3` and `Sim3` are thin wrappers.
"""

from __future__ import annotations

import torch

from batrack_tpu_torch.geometry.quaternion import (
    hat,
    quat_conj,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_matrix,
    so3_exp,
    so3_log,
)

_EPS = 1e-6


# ---------------------------------------------------------------- RxSO3
def rxso3_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    data = torch.zeros(tuple(shape) + (5,), dtype=dtype, device=device)
    data[..., 3] = 1.0
    data[..., 4] = 1.0
    return data


def rxso3_exp(xi: torch.Tensor) -> torch.Tensor:
    return torch.cat([so3_exp(xi[..., :3]), torch.exp(xi[..., 3:4])], dim=-1)


def rxso3_log(g: torch.Tensor) -> torch.Tensor:
    return torch.cat([so3_log(g[..., :4]), torch.log(g[..., 4:5])], dim=-1)


def rxso3_inv(g: torch.Tensor) -> torch.Tensor:
    return torch.cat([quat_conj(g[..., :4]), 1.0 / g[..., 4:5]], dim=-1)


def rxso3_mul(g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    q = quat_normalize(quat_mul(g1[..., :4], g2[..., :4]))
    return torch.cat([q, g1[..., 4:5] * g2[..., 4:5]], dim=-1)


def rxso3_act(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return g[..., 4:5] * quat_rotate(g[..., :4], p)


def rxso3_matrix(g: torch.Tensor) -> torch.Tensor:
    return g[..., 4:5, None] * quat_to_matrix(g[..., :4])


# ---------------------------------------------------------------- Sim3
def sim3_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    data = torch.zeros(tuple(shape) + (8,), dtype=dtype, device=device)
    data[..., 6] = 1.0
    data[..., 7] = 1.0
    return data


def _sim3_W(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The Sim(3) W matrix, t = W(phi, sigma) tau in exp (Strasdat), with
    the same series at theta -> 0 and sigma -> 0 as the JAX package."""
    theta_sq = (phi * phi).sum(-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta_sq, min=1e-24))
    sig = sigma[..., None]
    s = torch.exp(sig)
    small_t = theta_sq < _EPS
    small_s = sig.abs() < _EPS
    one = torch.ones_like(sig)

    C = torch.where(small_s, 1.0 + sig / 2.0 + sig * sig / 6.0,
                    (s - 1.0) / torch.where(small_s, one, sig))

    denom = sig * sig + theta_sq
    denom = torch.where(denom < 1e-24, torch.ones_like(denom), denom)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    tsq = torch.clamp(theta_sq, min=1e-24)

    a_gen = ((s * sin_t * sig + (1.0 - s * cos_t) * theta)
             / (denom * torch.where(small_t, torch.ones_like(theta), theta)))
    b_gen = (C - ((s * cos_t - 1.0) * sig + s * sin_t * theta) / denom) / tsq
    a_sig0 = torch.where(small_t, 0.5 - theta_sq / 24.0, (1.0 - cos_t) / tsq)
    b_sig0 = torch.where(small_t, 1.0 / 6.0 - theta_sq / 120.0,
                         (theta - sin_t) / torch.clamp(theta_sq * theta, min=1e-24))
    sig_safe = torch.where(small_s, one, sig)
    a_th0 = torch.where(small_s, 0.5 + sig / 3.0,
                        ((sig - 1.0) * s + 1.0) / (sig_safe * sig_safe))
    b_th0 = torch.where(small_s, 1.0 / 6.0 + sig / 8.0,
                        (s * (0.5 * sig * sig - sig + 1.0) - 1.0) / sig_safe ** 3)

    A = torch.where(small_s, a_sig0, torch.where(small_t, a_th0, a_gen))
    B = torch.where(small_s, b_sig0, torch.where(small_t, b_th0, b_gen))

    P = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(P.shape)
    return A * P + B * (P @ P) + C * eye


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    tau, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    t = (_sim3_W(phi, sigma) @ tau[..., None])[..., 0]
    return torch.cat([t, so3_exp(phi), torch.exp(sigma)], dim=-1)


def sim3_log(g: torch.Tensor) -> torch.Tensor:
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    phi = so3_log(q)
    sigma = torch.log(s)
    tau = torch.linalg.solve(_sim3_W(phi, sigma), t[..., None])[..., 0]
    return torch.cat([tau, phi, sigma], dim=-1)


def sim3_inv(g: torch.Tensor) -> torch.Tensor:
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    qinv = quat_conj(q)
    return torch.cat([-quat_rotate(qinv, t) / s, qinv, 1.0 / s], dim=-1)


def sim3_mul(g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    t1, q1, s1 = g1[..., :3], g1[..., 3:7], g1[..., 7:8]
    t2, q2, s2 = g2[..., :3], g2[..., 3:7], g2[..., 7:8]
    q = quat_normalize(quat_mul(q1, q2))
    return torch.cat([t1 + s1 * quat_rotate(q1, t2), q, s1 * s2], dim=-1)


def sim3_act(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return g[..., 7:8] * quat_rotate(g[..., 3:7], p) + g[..., :3]


def sim3_act4(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    v, w = p[..., :3], p[..., 3:4]
    xyz = g[..., 7:8] * quat_rotate(g[..., 3:7], v) + w * g[..., :3]
    return torch.cat([xyz, w.expand(xyz.shape[:-1] + (1,))], dim=-1)


def sim3_matrix(g: torch.Tensor) -> torch.Tensor:
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    R = s[..., None] * quat_to_matrix(q)
    top = torch.cat([R, t[..., None]], dim=-1)
    bot = torch.zeros_like(top[..., :1, :])
    bot[..., 0, 3] = 1.0
    return torch.cat([top, bot], dim=-2)


class Sim3:
    __slots__ = ("data",)

    def __init__(self, data: torch.Tensor):
        self.data = data

    @classmethod
    def Identity(cls, *shape, dtype=torch.float32, device=None):
        return cls(sim3_identity(shape, dtype, device))

    @classmethod
    def exp(cls, xi):
        return cls(sim3_exp(xi))

    def log(self):
        return sim3_log(self.data)

    def inv(self):
        return Sim3(sim3_inv(self.data))

    def __mul__(self, other):
        if isinstance(other, Sim3):
            return Sim3(sim3_mul(self.data, other.data))
        return self.act(other)

    def act(self, p):
        if p.shape[-1] == 4:
            return sim3_act4(self.data, p)
        return sim3_act(self.data, p)

    def retr(self, xi):
        return Sim3(sim3_mul(sim3_exp(xi), self.data))

    def matrix(self):
        return sim3_matrix(self.data)

    def vec(self):
        return self.data


class RxSO3:
    __slots__ = ("data",)

    def __init__(self, data: torch.Tensor):
        self.data = data

    @classmethod
    def Identity(cls, *shape, dtype=torch.float32, device=None):
        return cls(rxso3_identity(shape, dtype, device))

    @classmethod
    def exp(cls, xi):
        return cls(rxso3_exp(xi))

    def log(self):
        return rxso3_log(self.data)

    def inv(self):
        return RxSO3(rxso3_inv(self.data))

    def __mul__(self, other):
        if isinstance(other, RxSO3):
            return RxSO3(rxso3_mul(self.data, other.data))
        return rxso3_act(self.data, other)

    def act(self, p):
        return rxso3_act(self.data, p)

    def matrix(self):
        return rxso3_matrix(self.data)

    def vec(self):
        return self.data
