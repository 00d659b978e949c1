"""Robust RGB-D bundle adjustment: the slot-structured solver."""

from batrack_tpu_torch.ba.slot_solver import SlotGraph, slot_ba_iteration
from batrack_tpu_torch.ba.solver import robust_weight

__all__ = ["SlotGraph", "slot_ba_iteration", "robust_weight"]
