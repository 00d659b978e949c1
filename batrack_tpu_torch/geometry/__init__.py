"""Lie-group and projective geometry on torch tensors."""

import torch as _torch

from batrack_tpu_torch.geometry import projective, quaternion, se3, sim3, so3
from batrack_tpu_torch.geometry.se3 import SE3
from batrack_tpu_torch.geometry.sim3 import RxSO3, Sim3
from batrack_tpu_torch.geometry.so3 import SO3


def cat(group_list, dim=0):
    """Concatenate wrapped Lie-group elements (lietorch groups.py:314-317)."""
    return type(group_list[0])(_torch.cat([g.data for g in group_list], dim=dim))


def stack(group_list, dim=0):
    """Stack wrapped Lie-group elements (lietorch groups.py:319-322)."""
    return type(group_list[0])(_torch.stack([g.data for g in group_list], dim=dim))


__all__ = ["cat", "stack", "SE3", "SO3", "Sim3", "RxSO3", "se3", "so3", "sim3", "quaternion",
           "projective"]
