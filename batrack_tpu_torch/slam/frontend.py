"""Tracker frontend: query construction, gating and factor-graph append
(counterpart of batrack_tpu/slam/frontend.py).

Quantities live on fixed (n_src, M, S_slam) grids with validity masks. Edges
flatten source-slot-major, then patch, then target frame: the reference's
'b (s1 m s) c' order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from batrack_tpu_torch.ops.sampling import bilinear_sample2d
from batrack_tpu_torch.slam.state import SLAMState, StaticDims


class TrackerInput(NamedTuple):
    window_rgbd: torch.Tensor   # (S_slam, 4, H, W) images 0..255 + depth
    queries: torch.Tensor       # (NQ, 4) [sid, x, y, depth]; sid in window time
    query_valid: torch.Tensor   # (NQ,) bool
    win_start: int              # buffer frame id of window slot 0
    win_tstamps: torch.Tensor   # (S_slam,) global frame counter per window slot


class TrackerOutput(NamedTuple):
    tracks: torch.Tensor   # (S_slam, NQ, 2) pixel coords
    depths: torch.Tensor   # (S_slam, NQ) metric depth
    vis: torch.Tensor      # (S_slam, NQ) visibility in [0, 1]
    dynamic: torch.Tensor  # (S_slam, NQ) dynamic probability in [0, 1]


def build_tracker_input(state: SLAMState, n: int, dims: StaticDims) -> TrackerInput:
    """Padded tracker window + queries for frame count n.

    The window holds frames [n - S, n) (S = min(n, S_slam)) followed by the
    last frame repeated. Queries are the patch centres of frames n-S,
    n-S+kf, ... with bilinear depth from their own frame.
    """
    S_slam, M, kf, n_src = dims.S_slam, dims.M, dims.kf_stride, dims.n_src
    dev = state.poses.device
    S = min(n, S_slam)

    s_idx = torch.arange(S_slam, device=dev)
    src_slot = torch.where(s_idx < S, S_slam - S + s_idx, torch.full_like(s_idx, S_slam - 1))
    images = state.win_images[src_slot]                     # (S, H, W, 3)
    depths = state.win_depths[src_slot]                     # (S, H, W)
    window_rgbd = torch.cat([images.permute(0, 3, 1, 2), depths[:, None]], dim=1)

    qs = torch.arange(n_src, device=dev)
    sid = qs * kf
    q_frame = n - S + sid
    nq_valid = (S + kf - 1) // kf
    q_valid = qs < nq_valid

    patch_rows = (q_frame[:, None] * M + torch.arange(M, device=dev)[None, :])
    patch_rows = patch_rows.clamp(0, state.patches.shape[0] - 1)
    xy = state.patches[patch_rows.reshape(-1), :2]

    q_slot = (S_slam - S + sid).clamp(0, S_slam - 1)
    d_src = state.win_depths[q_slot]                        # (n_src, H, W)
    xy_g = xy.reshape(n_src, M, 2)
    d = bilinear_sample2d(d_src[:, None], xy_g[..., 0], xy_g[..., 1])[:, 0]

    queries = torch.cat(
        [sid[:, None, None].expand(n_src, M, 1).to(torch.float32), xy_g, d[..., None]],
        dim=-1,
    ).reshape(n_src * M, 4)
    query_valid = q_valid[:, None].expand(n_src, M).reshape(-1)

    w_frames = (n - S + s_idx).clamp(0, state.tstamps.shape[0] - 1)
    return TrackerInput(window_rgbd, queries, query_valid, n - S, state.tstamps[w_frames])


def masked_quantile(x: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """Quantile over the masked elements (jnp.nanquantile, linear)."""
    vals = torch.where(mask, x, torch.full_like(x, float("nan")))
    return torch.nanquantile(vals.reshape(-1), q)


def gate_and_append(
    state: SLAMState,
    tin: TrackerInput,
    tout: TrackerOutput,
    n: int,
    slot: int,
    dims: StaticDims,
    *,
    vis_threshold: float,
    static_threshold: float,
    static_quantile: float,
    min_track_len: int,
    boundary_padding: int = 20,
) -> None:
    """Gate tracker outputs into weights and write one ring slot of edges
    plus the local trajectory buffers, in place (reference predict_target +
    update_local)."""
    S_slam, M, kf, n_src, S_local = (
        dims.S_slam, dims.M, dims.kf_stride, dims.n_src, dims.S_local)
    dev = state.poses.device
    S = min(n, S_slam)
    wd, ht = dims.wd, dims.ht

    # the prediction at a query's own time is the query itself
    sid = tin.queries[:, 0].to(torch.int64)                 # (NQ,)
    own = (torch.arange(S_slam, device=dev)[:, None] == sid[None, :])  # (S, NQ)
    # non-finite tracker outputs are treated as invisible
    finite = (torch.isfinite(tout.tracks).all(-1) & torch.isfinite(tout.depths)
              & torch.isfinite(tout.vis))
    tracks = torch.where(own[..., None], tin.queries[None, :, 1:3],
                         torch.nan_to_num(tout.tracks, nan=-1e4, posinf=1e4, neginf=-1e4))
    vis = torch.where(own, torch.ones_like(tout.vis),
                      torch.where(finite, torch.nan_to_num(tout.vis), torch.zeros_like(tout.vis)))
    depths = torch.nan_to_num(tout.depths, nan=1e-2, posinf=1e2, neginf=1e-2)

    frame_live = (torch.arange(S_slam, device=dev) < S)[:, None]
    live = frame_live & tin.query_valid[None, :]

    vis_label = vis > vis_threshold
    boundary = (
        (tracks[..., 0] >= boundary_padding) & (tracks[..., 0] < wd - boundary_padding)
        & (tracks[..., 1] >= boundary_padding) & (tracks[..., 1] < ht - boundary_padding)
    )
    vis_raw = vis_label & boundary & live

    static_e = 1.0 - torch.nan_to_num(tout.dynamic, nan=1.0)
    static_th = torch.minimum(masked_quantile(static_e, live, 1.0 - static_quantile),
                              torch.tensor(static_threshold, dtype=static_e.dtype, device=dev))
    static_label = (static_e >= static_th) & live

    disp = 1.0 / torch.clamp(depths, min=1e-2)
    target_3d = torch.cat([tracks, disp[..., None]], dim=-1)  # (S, NQ, 3)
    weight = vis_raw.to(torch.float32)

    # track-length gate; also rewrites patches_valid of the query frames
    track_len = (weight > 0).sum(0)
    long_enough = track_len >= min_track_len
    apply_len = n >= min_track_len
    if apply_len:
        weight = weight * long_enough[None, :]
    weight_pose = weight * static_label.to(torch.float32)

    if apply_len:
        q_rows = (tin.win_start + sid) * M + torch.arange(M, device=dev).repeat(n_src)
        keep = tin.query_valid   # rows of invalid queries are dropped (mode="drop")
        state.patches_valid[q_rows[keep]] = long_enough[keep].to(torch.float32)

    # ---- factor-graph append ---------------------------------------------
    ar_src = torch.arange(n_src, device=dev)
    ar_m = torch.arange(M, device=dev)
    ar_s = torch.arange(S_slam, device=dev)
    ii = (tin.win_start + ar_src * kf)[:, None, None].expand(n_src, M, S_slam)
    jj = (tin.win_start + ar_s)[None, None, :].expand(n_src, M, S_slam)
    kk = ii * M + ar_m[None, :, None]

    def to_edge(x):  # (S, NQ, ...) -> (n_src, M, S_slam, ...)
        x = x.movedim(0, 1)
        return x.reshape((n_src, M, S_slam) + x.shape[2:])

    e_target = to_edge(target_3d).reshape(-1, 3)
    e_w = to_edge(weight).reshape(-1)
    e_wp = to_edge(weight_pose).reshape(-1)
    e_st = to_edge(static_label.to(torch.float32)).reshape(-1)
    e_valid = to_edge(live.to(torch.float32)).reshape(-1)

    eps = dims.edges_per_slot
    rows = slice(slot * eps, (slot + 1) * eps)
    state.e_kk[rows] = kk.reshape(-1).to(torch.int32)
    state.e_jj[rows] = jj.reshape(-1).to(torch.int32)
    state.e_target[rows] = e_target
    state.e_weight[rows] = e_w[:, None].expand(eps, 2)
    state.e_weight_pose[rows] = e_wp[:, None].expand(eps, 2)
    state.e_valid[rows] = e_valid
    state.e_static[rows] = e_st
    state.slot_start[slot] = tin.win_start

    # ---- local trajectory buffers ------------------------------------------
    mid = (S_local + 1) // 2 - 1
    local_id = jj - ii + mid
    ok = ((local_id >= 0) & (local_id < S_local)
          & (e_valid.reshape(n_src, M, S_slam) > 0)).reshape(-1)
    kk_f = kk.reshape(-1)[ok]  # out-of-range rows are dropped (mode="drop")
    lid_f = local_id.reshape(-1)[ok]
    state.local_targets[kk_f, lid_f] = e_target[ok]
    state.local_vis[kk_f, lid_f] = to_edge(vis_raw.to(torch.float32)).reshape(-1)[ok]
    state.local_static[kk_f, lid_f] = e_st[ok]
    state.local_weights[kk_f, lid_f] = e_w[ok]
