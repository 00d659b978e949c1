"""Robust reweighting shared by the bundle-adjustment solvers.

Only `robust_weight` is ported so far; the flat edge solver of
batrack_tpu/ba/solver.py (needed by use_keyframe) is still to come.
"""

from __future__ import annotations

import torch


def robust_weight(r: torch.Tensor, loss: str) -> torch.Tensor:
    """Component-wise robust kernel weight (reference ba.py:81-100)."""
    if loss == "trivial":
        return torch.ones_like(r)
    if loss == "huber":
        s = r * r
        return torch.where(s > 1.0, 1.0 / torch.sqrt(torch.clamp(s, min=1e-24)),
                           torch.ones_like(r))
    if loss == "cauchy":
        return 1.0 / (1.0 + r * r)
    raise NotImplementedError(loss)
