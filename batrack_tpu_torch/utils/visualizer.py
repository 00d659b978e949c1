"""The Rerun 4D viewer of refined results, the counterpart of
batrack_tpu/utils/visualizer.py's generate_point_cloud and vis_rerun
(main/rerun_visualizer.py). The track-overlay video (TrackVisualizer, cv2
drawing and an mp4 writer) is not ported.
"""

from __future__ import annotations

import numpy as np


def generate_point_cloud(img, depth, intrinsics, cam_T_world, stride: int = 4):
    """Lift an RGB-D frame to a world point cloud: (points (N, 3), colours
    (N, 3)). `cam_T_world` rows of the results are camera-to-world
    matrices already (the SLAM results store inv(w2c)), applied as they
    are."""
    H, W = depth.shape[:2]
    fx, fy, cx, cy = intrinsics
    u, v = np.meshgrid(np.arange(0, W, stride), np.arange(0, H, stride))
    d = depth[::stride, ::stride].reshape(-1)
    ok = d > 1e-3
    x = (u.reshape(-1) - cx) / fx * d
    y = (v.reshape(-1) - cy) / fy * d
    pts_cam = np.stack([x, y, d, np.ones_like(d)], -1)[ok]
    pts = (cam_T_world @ pts_cam.T).T[:, :3]
    colors = img[::stride, ::stride].reshape(-1, 3)[ok]
    return pts, colors


def vis_rerun(results: dict, stride: int = 4, app_name: str = "batrack_tpu_torch") -> bool:
    """Log results to a Rerun viewer: pinhole cameras, RGB images, point
    clouds and static (green) / dynamic (red) 2D tracks. Returns False, after
    a message, when rerun-sdk is not installed."""
    try:
        import rerun as rr
    except ImportError:
        print("rerun-sdk not installed; skipping 4D visualization")
        return False

    rr.init(app_name, spawn=True)
    rgbs = np.asarray(results["rgbs"])
    dmaps = np.asarray(results.get("dmaps_scaled", results["dmaps"]))
    cams = np.asarray(results["cams_T_world"])
    intr = np.asarray(results["intrinsics"])
    trajs = results.get("trajs_2d_disp")
    static = results.get("trajs_static")

    for t in range(len(rgbs)):
        rr.set_time_sequence("frame", t)
        fx, fy, cx, cy = intr[t]
        c2w = cams[t]
        rr.log("world/camera", rr.Transform3D(translation=c2w[:3, 3], mat3x3=c2w[:3, :3]))
        rr.log("world/camera/image",
               rr.Pinhole(focal_length=[fx, fy], principal_point=[cx, cy],
                          width=rgbs.shape[2], height=rgbs.shape[1]))
        rr.log("world/camera/image/rgb", rr.Image(rgbs[t].astype(np.uint8)))
        pts, colors = generate_point_cloud(rgbs[t], dmaps[t].squeeze(), intr[t], cams[t], stride)
        rr.log("world/points", rr.Points3D(pts, colors=colors.astype(np.uint8)))
        if trajs is not None:
            xy = np.asarray(trajs)[t, :, :, :2].reshape(-1, 2)
            cols = None
            if static is not None:
                st = np.asarray(static)[t].reshape(-1) > 0.5
                cols = np.where(st[:, None], [[0, 255, 0]], [[255, 0, 0]])
            rr.log("world/camera/image/tracks", rr.Points2D(xy, colors=cols))
    return True
