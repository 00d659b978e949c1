"""SO(3) on quaternion vectors (..., 4) = [qx, qy, qz, qw] (counterpart of
batrack_tpu/geometry/so3.py, the lietorch SO3 API of groups.py:168-208).

Plain tensor functions; `SO3` is a thin wrapper around one data tensor.
"""

from __future__ import annotations

import torch

from batrack_tpu_torch.geometry.quaternion import (
    matrix_to_quat,
    quat_conj,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_matrix,
    so3_exp,
    so3_log,
)


def identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    data = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    data[..., 3] = 1.0
    return data


exp = so3_exp
log = so3_log
inv = quat_conj
act = quat_rotate
matrix = quat_to_matrix
from_matrix = matrix_to_quat


def mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    return quat_normalize(quat_mul(q1, q2))


def adj(q: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return quat_rotate(q, a)


def adjT(q: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conj(q), a)


def retr(q: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    return mul(so3_exp(phi), q)


class SO3:
    __slots__ = ("data",)

    def __init__(self, data: torch.Tensor):
        self.data = data

    @classmethod
    def Identity(cls, *shape, dtype=torch.float32, device=None):
        return cls(identity(shape, dtype, device))

    @classmethod
    def exp(cls, phi):
        return cls(exp(phi))

    def log(self):
        return log(self.data)

    def inv(self):
        return SO3(inv(self.data))

    def __mul__(self, other):
        if isinstance(other, SO3):
            return SO3(mul(self.data, other.data))
        return act(self.data, other)

    def act(self, p):
        return act(self.data, p)

    def retr(self, phi):
        return SO3(retr(self.data, phi))

    def adj(self, a):
        return adj(self.data, a)

    def adjT(self, a):
        return adjT(self.data, a)

    def matrix(self):
        return matrix(self.data)

    def vec(self):
        return self.data
