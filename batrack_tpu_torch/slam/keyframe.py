"""Motion-magnitude keyframe removal (counterpart of
batrack_tpu/slam/keyframe.py; reference batrack.py:1011-1073, with
use_keyframe on).

When the blended flow magnitude around frame k = n - KEYFRAME_INDEX is
below KEYFRAME_THRESH, frame k is deleted: its edges are invalidated, the
edge indices above it are decremented, and every per-frame and per-patch
buffer shifts down by one. The shift is a gather with indices
i + (i >= k); the tail rows keep their (now unused) values, as in the JAX
package. Frame deletion breaks the dense ring-slot addressing, so the SLAM
system runs the flat BA whenever use_keyframe is on, and slot_start is set
to -1 here.
"""

from __future__ import annotations

import torch

from batrack_tpu_torch.geometry import projective
from batrack_tpu_torch.slam.state import SLAMState, StaticDims

# per-frame and per-patch buffers that shift with a removed frame
_FRAME_FIELDS = ("tstamps", "poses", "intrinsics")
_PATCH_FIELDS = ("patches", "patches_valid", "colors", "local_targets", "local_vis",
                 "local_static", "local_weights", "trajs_world")


def _edge_flow(state: SLAMState, dims: StaticDims, beta: float):
    """(source frame ii, flow_mag) of every edge."""
    kk = state.e_kk.long()
    ii = kk // dims.M
    flow = projective.flow_mag(state.poses, state.patches, state.intrinsics, ii,
                               state.e_jj.long(), kk, beta=beta)
    return ii, flow


def _mean_sel(sel: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=flow.dtype, device=flow.device)
    return torch.where(sel, flow, zero).sum() / sel.sum().clamp(min=1)


def motion_magnitude(state: SLAMState, i: int, j: int, dims: StaticDims,
                     beta: float = 0.5) -> torch.Tensor:
    """Mean blended flow magnitude over the live edges (i -> j)
    (batrack.py:1011-1018); a 0-dim tensor."""
    ii, flow = _edge_flow(state, dims, beta)
    return _mean_sel((ii == i) & (state.e_jj == j) & (state.e_valid > 0), flow)


def motion_magnitude_pair(state: SLAMState, i: int, j: int, k: int, dims: StaticDims,
                          beta: float = 0.5) -> torch.Tensor:
    """0.5 * (mag(i->k) + mag(j->k)) (batrack.py:1026-1031): one flow_mag
    and two selections; the caller brings the one scalar to the host."""
    ii, flow = _edge_flow(state, dims, beta)
    live = (state.e_valid > 0) & (state.e_jj == k)
    return 0.5 * (_mean_sel((ii == i) & live, flow) + _mean_sel((ii == j) & live, flow))


def remove_keyframe(state: SLAMState, k: int, dims: StaticDims) -> None:
    """Delete frame k from every buffer and from the factor graph, in place
    (batrack.py:1042-1066): edges touching k are invalidated, kk and jj
    above k shift down, per-frame and per-patch rows shift down by one."""
    M, N = dims.M, dims.N
    dev = state.poses.device
    ii = state.e_kk // M
    keep = ~((ii == k) | (state.e_jj == k))
    state.e_valid = state.e_valid * keep
    state.e_kk = torch.where(ii > k, state.e_kk - M, state.e_kk)
    state.e_jj = torch.where(state.e_jj > k, state.e_jj - 1, state.e_jj)

    fidx = torch.arange(N, device=dev)
    fsrc = (fidx + (fidx >= k).long()).clamp(max=N - 1)
    pidx = torch.arange(N * M, device=dev)
    psrc = (pidx + (pidx // M >= k).long() * M).clamp(max=N * M - 1)
    for name in _FRAME_FIELDS:
        setattr(state, name, getattr(state, name)[fsrc])
    for name in _PATCH_FIELDS:
        setattr(state, name, getattr(state, name)[psrc])
    state.slot_start = torch.full_like(state.slot_start, -1)  # slot addressing broken


def remove_window_frame(state: SLAMState, win_idx: int, dims: StaticDims) -> None:
    """Drop one frame from the rolling raw-frame window (local_window.pop),
    in place. The window keeps its newest frame at slot S-1, so the frames
    before the removed slot shift toward the end and the (stale) front slot
    is duplicated; it sits in the padding until new frames arrive."""
    S = dims.S_slam
    sidx = torch.arange(S, device=state.win_images.device)
    src = (sidx - (sidx <= win_idx).long()).clamp(0, S - 1)
    state.win_images = state.win_images[src]
    state.win_depths = state.win_depths[src]
