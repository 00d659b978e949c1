"""Stage-3 dense global alignment on PyTorch: losses and state (counterpart
of batrack_tpu/refine/refine_net.py).

Per-frame depth scale grids, per-track scales and a pose update are fitted
to the sparse SLAM results (results.pkl) by five weighted losses. The
formulas, masks and the zero-subgradient conventions (`_abs0`,
`_safe_norm`) are the JAX package's; its per-frame `jax.lax.map` loops run
here as one batch over all frames. Everything takes the dtype of the data
and parameters: float32 in production, float64 in the parity tests.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from batrack_tpu_torch.geometry import se3
from batrack_tpu_torch.ops.sampling import bilinear_sample2d, interpolate_bilinear
from batrack_tpu_torch.utils.config import RefineConfig, full_fp32, resolve_device

PW_BREAK = 20.0         # per-track scales: exp(s / 20)
FRAME_SCALE_DIV = 10.0  # frame scale grids: exp(x / 10)
K_SCALE = 20.0          # intrinsics are optimised divided by 20


def _abs0(x: torch.Tensor) -> torch.Tensor:
    """|x| with a ZERO subgradient at 0. The losses sit exactly on 0 at
    init (equal scales, zero self-distances), where Adam's first step is
    about sign(g) * lr, so the convention decides whole first updates."""
    return x * torch.sign(x)


def _safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm with a finite gradient at 0: sqrt(sum x^2 + 1e-12), so a
    zero distance reads 1e-6 (the JAX package's formula, kept exactly)."""
    return torch.sqrt((x * x).sum(dim) + 1e-12)


class RefineData(NamedTuple):
    """Static observation tensors loaded from the SLAM results pickle."""

    trajs_2d: torch.Tensor         # (T, N, S, 2)
    trajs_disp: torch.Tensor       # (T, N, S) tracked disparity
    trajs_disp_mono: torch.Tensor  # (T, N, S) mono disparity sampled along tracks
    trajs_vis: torch.Tensor        # (T, N, S)
    trajs_static: torch.Tensor     # (T, N, S)
    query_frame_mask: torch.Tensor  # (T,) 1.0 for frames in grid_query_frames
    jj: torch.Tensor               # (T, S) neighbour frame ids (unclamped), int64
    pose_init: torch.Tensor        # (T, 7) SE3 (from cams_T_world)
    intrinsics: torch.Tensor       # (T, 4)
    dmaps: torch.Tensor            # (T, H, W) depth maps (possibly pre-aligned)


class RefineParams(NamedTuple):
    trajs_scales: torch.Tensor     # (T, N, S)
    frame_scales: torch.Tensor     # (T, gh, gw) raw (exp applied)
    pose_delta: torch.Tensor       # (T, 6) tangent update
    K: torch.Tensor                # (4,) scaled by 1/K_SCALE


def _torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, np.dtype(dtype).name)


def align_depth_maps(depth_maps: np.ndarray) -> np.ndarray:
    """Sequential median-chain depth alignment (host, numpy)."""
    S = depth_maps.shape[0]
    out = np.array(depth_maps, dtype=np.float64, copy=True)
    min_overlap = 100
    for i in range(1, S):
        D_prev = out[i - 1]
        D_curr = depth_maps[i]
        mask = (D_prev > 0) & (D_curr > 0)
        if mask.sum() < min_overlap:
            out[i] = D_curr
            continue
        if i == 1:
            median_prev = np.median(D_prev[mask])
        else:
            mask_past = (out[i - 2] > 0) & (D_prev > 0)
            median_prev = np.median(np.concatenate([out[i - 2][mask_past], D_prev[mask]]))
        scale = median_prev / np.median(D_curr[mask])
        out[i] = scale * D_curr
    return out.astype(depth_maps.dtype)


def build_refine_data(results: dict, align_depth: bool = True, dtype=np.float32,
                      device="cuda") -> RefineData:
    """From a results.pkl dict (BATrack.get_results schema). The host-side
    preparation (depth alignment, mono disparity along the tracks) runs in
    numpy as in the JAX package; the pose conversion runs on `device`.
    dtype: float32 in production, float64 for the parity tests. device:
    default CUDA; raises when CUDA is asked for and absent."""
    dev = resolve_device(device)
    tdt = _torch_dtype(dtype)
    trajs = np.asarray(results["trajs_2d_disp"], dtype)  # (T, N, S, 3)
    T, N, S, _ = trajs.shape
    dmaps = np.asarray(results["dmaps"], dtype)
    if dmaps.ndim == 4:
        dmaps = dmaps[..., 0]
    if align_depth:
        dmaps = align_depth_maps(dmaps)

    mid = S // 2
    jj = np.arange(T)[:, None] + np.arange(S)[None, :] - mid  # (T, S)

    # mono disparity along the 2D tracks: bilinear taps of each track's
    # neighbour frame, one vectorised gather on the host
    jj_c = np.clip(jj, 0, T - 1)
    Himg, Wimg = dmaps.shape[-2:]
    x = trajs[..., 0]
    y = trajs[..., 1]
    x0 = np.floor(x)
    y0 = np.floor(y)
    wx = x - x0
    wy = y - y0
    x0c = np.clip(x0, 0, Wimg - 1).astype(np.int64)
    x1c = np.clip(x0 + 1, 0, Wimg - 1).astype(np.int64)
    y0c = np.clip(y0, 0, Himg - 1).astype(np.int64)
    y1c = np.clip(y0 + 1, 0, Himg - 1).astype(np.int64)
    fsel = jj_c[:, None, :]
    d = ((1 - wy) * (1 - wx) * dmaps[fsel, y0c, x0c]
         + (1 - wy) * wx * dmaps[fsel, y0c, x1c]
         + wy * (1 - wx) * dmaps[fsel, y1c, x0c]
         + wy * wx * dmaps[fsel, y1c, x1c])
    mono = (1.0 / np.maximum(d, 1e-2)).astype(dtype)

    qmask = np.zeros((T,), dtype)
    qmask[np.asarray(results["grid_query_frames"], int)] = 1.0

    def on(a, dt=tdt):
        return torch.from_numpy(np.array(a)).to(device=dev, dtype=dt)

    cams = on(np.asarray(results["cams_T_world"], dtype))
    return RefineData(
        trajs_2d=on(trajs[..., :2]),
        trajs_disp=on(trajs[..., 2]),
        trajs_disp_mono=on(mono),
        trajs_vis=on(np.asarray(results["trajs_vis"], dtype)),
        trajs_static=on(np.asarray(results["trajs_static"], dtype)),
        query_frame_mask=on(qmask),
        jj=on(jj, torch.int64),
        pose_init=se3.from_matrix(cams),
        intrinsics=on(np.asarray(results["intrinsics"], dtype)),
        dmaps=on(dmaps),
    )


def init_params(data: RefineData, grid_size: int, dtype=torch.float32) -> RefineParams:
    """Leaf tensors on the data's device. Frame scales start at ones, so
    their effect is exp(1/10) ~ 1.105, not the identity (the per-track
    scales are the identity: mean-centring zeroes them); the optimiser
    removes the 10% bias, as in the JAX package."""
    T, N, S = data.trajs_disp.shape
    dt, dev = _torch_dtype(dtype), data.trajs_disp.device
    return RefineParams(
        trajs_scales=torch.ones((T, N, S), dtype=dt, device=dev),
        frame_scales=torch.ones((T, grid_size, grid_size), dtype=dt, device=dev),
        pose_delta=torch.zeros((T, 6), dtype=dt, device=dev),
        K=(_median0(data.intrinsics).to(dt) / K_SCALE),
    )


def _median0(x: torch.Tensor) -> torch.Tensor:
    """numpy's median over axis 0 (the mean of the two middle values for an
    even count; torch.median takes the lower one)."""
    s = torch.sort(x, dim=0).values
    n = s.shape[0]
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


# ---------------------------------------------------------------------------
# derived quantities
# ---------------------------------------------------------------------------

def effective_trajs_scales(p: RefineParams) -> torch.Tensor:
    s = p.trajs_scales - p.trajs_scales.mean(dim=1, keepdim=True)
    return torch.exp(s / PW_BREAK)


def effective_frame_scales(p: RefineParams) -> torch.Tensor:
    return torch.exp(p.frame_scales / FRAME_SCALE_DIV)


def poses(p: RefineParams, data: RefineData) -> torch.Tensor:
    return se3.mul(se3.exp(p.pose_delta), data.pose_init)


def intrinsics(p: RefineParams, data: RefineData, refine_K: bool) -> torch.Tensor:
    if refine_K:
        return (p.K * K_SCALE).expand(data.intrinsics.shape)
    return data.intrinsics


def frame_scaled_disp(p: RefineParams, data: RefineData,
                      image_hw: Tuple[int, int]) -> torch.Tensor:
    """Mono disparity x the neighbour frame's grid scale at each track
    point (grid_sample with align_corners=True). Returns (T, N, S)."""
    fs = effective_frame_scales(p)  # (T, gh, gw)
    T, gh, gw = fs.shape
    H, W = image_hw
    N, S = data.trajs_disp.shape[1:]
    jj_c = data.jj.clamp(0, T - 1)  # (T, S)
    gx = data.trajs_2d[..., 0] * (gw - 1) / (W - 1)  # (T, N, S)
    gy = data.trajs_2d[..., 1] * (gh - 1) / (H - 1)
    maps = fs[jj_c].reshape(T * S, 1, gh, gw)
    out = bilinear_sample2d(maps, gx.transpose(1, 2).reshape(T * S, N),
                            gy.transpose(1, 2).reshape(T * S, N))  # (T*S, 1, N)
    return data.trajs_disp_mono * out.reshape(T, S, N).transpose(1, 2)


def scaled_dmaps(p: RefineParams, data: RefineData) -> torch.Tensor:
    """Refined dense depth D / scale_map. Returns (T, H, W)."""
    fs = effective_frame_scales(p)[:, None]  # (T, 1, gh, gw)
    H, W = data.dmaps.shape[-2:]
    maps = interpolate_bilinear(fs, (H, W), align_corners=True)[:, 0]
    return data.dmaps / maps


def _iproj3(xy: torch.Tensor, disp: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """2D + disparity -> 3D."""
    fx, fy, cx, cy = intr.unbind(-1)
    depth = 1.0 / disp.clamp_min(1e-2)
    xn = (xy[..., 0] - cx) / fx * depth
    yn = (xy[..., 1] - cy) / fy * depth
    return torch.stack([xn, yn, depth], dim=-1)


def _in_range(jj: torch.Tensor, T: int) -> torch.Tensor:
    return (jj >= 0) & (jj < T)


def _query_mean(per_frame: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return (per_frame * q).sum() / q.sum().clamp_min(1.0)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def spatial_loss(p, data, image_hw) -> torch.Tensor:
    """Huber between frame-scaled mono disparity and track-scaled tracked
    disparity, averaged over query frames."""
    T = data.trajs_disp.shape[0]
    aligned = effective_trajs_scales(p) * data.trajs_disp
    mono_scaled = frame_scaled_disp(p, data, image_hw)

    vis = data.trajs_vis > 0.9
    in_range = _in_range(data.jj[:, None, :], T)
    # as in the reference: the "flow" gate is the norm of the ABSOLUTE pixel
    # coordinates, so it only drops points within 5 px of the image origin
    flow = torch.linalg.vector_norm(data.trajs_2d, dim=-1) > 5.0
    disp_ok = data.trajs_disp > 1e-2
    mask = (vis & in_range & flow & disp_ok).to(mono_scaled.dtype)

    diff = mono_scaled - aligned
    a = diff.abs()
    huber = torch.where(a < 1.0, 0.5 * diff * diff, a - 0.5)
    return _query_mean((huber * mask).mean(dim=(1, 2)), data.query_frame_mask)


def inter_frame_loss(p, data, image_hw) -> torch.Tensor:
    """Pairwise-distance rigidity on static tracks: every frame's (S, N, N)
    distance matrix against its middle frame's, all frames in one batch."""
    T, N, S = data.trajs_disp.shape
    mid = S // 2
    mono_scaled = frame_scaled_disp(p, data, image_hw)
    dt = mono_scaled.dtype
    jj_c = data.jj.clamp(0, T - 1)
    intr_t = data.intrinsics[jj_c]                      # (T, S, 4)
    pts = _iproj3(data.trajs_2d.transpose(1, 2), mono_scaled.transpose(1, 2),
                  intr_t[:, :, None])                   # (T, S, N, 3)
    pd = _safe_norm(pts[:, :, :, None] - pts[:, :, None, :])  # (T, S, N, N)
    diff = _abs0(pd - pd[:, mid:mid + 1])
    t_ok = _in_range(data.jj, T).to(dt)[:, :, None, None]
    vis_m = data.trajs_vis.transpose(1, 2)              # (T, S, N)
    st_m = data.trajs_static.transpose(1, 2)
    # the disparity mask comes from the RAW mono disparity, fixed at init;
    # the frame-scaled value's mask would move with the optimised scales
    disp_m = (data.trajs_disp_mono.transpose(1, 2) > 1e-2).to(dt)
    pair = ((vis_m[..., :, None] * vis_m[..., None, :] > 0.5)
            & (st_m[..., :, None] * st_m[..., None, :] > 0.5)
            & (disp_m[..., :, None] * disp_m[..., None, :] > 0.5)).to(dt)
    vals = (diff * t_ok * pair).mean(dim=(1, 2, 3))
    return _query_mean(vals, data.query_frame_mask)


def inter_frame_loss_local(p, data, image_hw) -> torch.Tensor:
    """Rigidity on the track-scaled tracked disparity. Not part of
    total_loss: the reference defines it but never calls it."""
    scaled = effective_trajs_scales(p) * data.trajs_disp
    data_local = data._replace(trajs_disp_mono=scaled)
    identity = RefineParams(
        trajs_scales=torch.zeros_like(p.trajs_scales),
        frame_scales=torch.zeros_like(p.frame_scales),
        pose_delta=p.pose_delta,
        K=p.K,
    )
    return inter_frame_loss(identity, data_local, image_hw)


def pts_3d_loss(p, data, image_hw, refine_K) -> torch.Tensor:
    """Cross-frame 3D consistency through the poses."""
    T, N, S = data.trajs_disp.shape
    mid = S // 2
    mono_scaled = frame_scaled_disp(p, data, image_hw)
    pose = poses(p, data)
    intr = intrinsics(p, data, refine_K)

    pts_src = _iproj3(data.trajs_2d[:, :, mid], mono_scaled[:, :, mid], intr[:, None])  # (T, N, 3)
    jj_c = data.jj.clamp(0, T - 1)
    src2trg = se3.mul(se3.inv(pose[jj_c]), pose[:, None])                 # (T, S, 7)
    pts_from_src = se3.act(src2trg[:, :, None], pts_src[:, None])        # (T, S, N, 3)
    pts_trg = _iproj3(data.trajs_2d.transpose(1, 2), mono_scaled.transpose(1, 2),
                      intr[jj_c][:, :, None])
    dist = _safe_norm(pts_from_src - pts_trg)                            # (T, S, N)

    vis = data.trajs_vis.transpose(1, 2) > 0.9
    in_range = _in_range(data.jj, T)[:, :, None]
    disp_ok = data.trajs_disp.transpose(1, 2) > 1e-2
    static = data.trajs_static.transpose(1, 2) > 0.3
    mask = (vis & in_range & disp_ok & static).to(dist.dtype)
    return (dist * mask).mean()


def cam_smooth_loss(p, data) -> torch.Tensor:
    """Adjacent-pose smoothness on the 7-vector."""
    pose = poses(p, data)
    dt = _safe_norm(pose[:-1, :3] - pose[1:, :3])
    dq = _safe_norm(pose[:-1, 3:] - pose[1:, 3:])
    return dt.mean() + 0.3 * dq.mean()


def scale_smoothness_loss(p) -> torch.Tensor:
    """L1 neighbour smoothness of the scale grid."""
    s = effective_frame_scales(p)
    return (_abs0(s[:, :, :-1] - s[:, :, 1:]).mean()
            + _abs0(s[:, :-1] - s[:, 1:]).mean())


def total_loss(
    p: RefineParams,
    data: RefineData,
    image_hw: Tuple[int, int],
    cfg: RefineConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted sum of the enabled losses, and each weighted part."""
    parts = {}
    if cfg.spatial_loss:
        parts["spatial_loss"] = cfg.spatial_loss * spatial_loss(p, data, image_hw)
    if cfg.inter_frame_loss:
        parts["inter_frame_loss"] = cfg.inter_frame_loss * inter_frame_loss(p, data, image_hw)
    if cfg.pts_3d_loss:
        parts["pts_3d_loss"] = cfg.pts_3d_loss * pts_3d_loss(p, data, image_hw,
                                                             not cfg.fixed_K)
    if cfg.cam_smooth_vec_loss:
        parts["cam_smooth_vec_loss"] = cfg.cam_smooth_vec_loss * cam_smooth_loss(p, data)
    if cfg.scale_smoothness_loss:
        parts["scale_smoothness_loss"] = cfg.scale_smoothness_loss * scale_smoothness_loss(p)
    total = sum(parts.values())
    return total, parts


@torch.no_grad()
def get_results(p: RefineParams, data: RefineData, results: dict, refine_K: bool) -> dict:
    """Refined results dict (the input's keys, with the refined depth maps
    `dmaps_scaled`, poses and intrinsics), all numpy."""
    out = dict(results)
    out["final_trajs_2d"] = data.trajs_2d.cpu().numpy()
    out["dmaps"] = data.dmaps.cpu().numpy()[..., None]
    out["dmaps_scaled"] = scaled_dmaps(p, data).cpu().numpy()[..., None]
    with full_fp32():
        out["cams_T_world"] = se3.matrix(poses(p, data)).cpu().numpy()
    out["intrinsics"] = intrinsics(p, data, refine_K).cpu().numpy()
    return out
