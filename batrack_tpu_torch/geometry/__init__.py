"""Lie-group and projective geometry on torch tensors."""

from batrack_tpu_torch.geometry import projective, quaternion, se3

__all__ = ["projective", "quaternion", "se3"]
