"""Motion-decoupled point tracker (MDTracker) on PyTorch."""

from batrack_tpu_torch.tracker.adapter import MDTrackerAdapter
from batrack_tpu_torch.tracker.convert import load_checkpoint, state_dict_from_flax
from batrack_tpu_torch.tracker.mdtracker import MDTracker, TrackerParams

__all__ = ["MDTracker", "TrackerParams", "MDTrackerAdapter", "load_checkpoint",
           "state_dict_from_flax"]
