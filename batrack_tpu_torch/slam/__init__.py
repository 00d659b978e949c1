"""Online sparse SLAM: state buffers, frontend, backend and the BATrack loop."""

from batrack_tpu_torch.slam.frontend import TrackerInput, TrackerOutput
from batrack_tpu_torch.slam.state import SLAMState, StaticDims, init_state
from batrack_tpu_torch.slam.system import BATrack

__all__ = ["BATrack", "SLAMState", "StaticDims", "init_state", "TrackerInput",
           "TrackerOutput"]
