"""Robust RGB-D bundle adjustment: the flat edge solver and the
slot-structured solver."""

from batrack_tpu_torch.ba.slot_solver import SlotGraph, slot_ba_iteration
from batrack_tpu_torch.ba.solver import BAProblem, ba_iteration, robust_weight

__all__ = ["BAProblem", "SlotGraph", "ba_iteration", "robust_weight", "slot_ba_iteration"]
