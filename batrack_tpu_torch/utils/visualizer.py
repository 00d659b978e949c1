"""Visualisation of SLAM results, the counterpart of
batrack_tpu/utils/visualizer.py: the track-overlay video (TrackVisualizer:
cv2 circles and lines over each frame, written as an mp4v mp4) and the
Rerun 4D viewer of refined results (generate_point_cloud, vis_rerun;
main/rerun_visualizer.py). cv2 is imported inside the functions that draw
and write, and its absence raises a RuntimeError there.
"""

from __future__ import annotations

import colorsys
import os
from typing import Dict, List, Optional

import numpy as np


def _cv2(feature: str):
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(f"{feature} needs OpenCV (cv2)") from e
    return cv2


def _colormap_rainbow(n: int) -> np.ndarray:
    """n RGB colours around the hue wheel (the reference's 'rainbow' mode)."""
    return np.array([colorsys.hsv_to_rgb(i / max(n, 1), 0.9, 1.0) for i in range(n)]) * 255.0


class TrackVisualizer:
    """Collects frames and each append's tracks; renders the overlay video.

    add_track takes the payload BATrack builds per append: {fid, targets
    (S, Q, 2), weights (S, Q), static (S, Q)}, numpy, in the JAX package's
    (S, NS*M, ...) layout."""

    def __init__(self, save_dir: str = "./results", fps: int = 10, linewidth: int = 2,
                 tracks_leave_trace: int = 8, mode: str = "rainbow"):
        self.save_dir = save_dir
        self.fps = fps
        self.linewidth = linewidth
        self.trace = tracks_leave_trace
        self.mode = mode
        self.frames: List[np.ndarray] = []
        self.tracks: List[Dict] = []

    def add_frame(self, frame) -> None:
        self.frames.append(frame)

    def add_track(self, track: Dict) -> None:
        self.tracks.append(track)

    def draw_tracks_on_frames(self) -> List[np.ndarray]:
        """Overlay each append's tracks onto copies of its window frames: a
        dot per live track (green static, red dynamic, else its rainbow
        colour) and a trace over up to `tracks_leave_trace` earlier frames.
        (The JAX package draws on the frames it was given when they are
        contiguous uint8, which are the caller's arrays.)"""
        cv2 = _cv2("drawing the track video")
        out = [np.array(f, np.uint8) for f in self.frames]
        for track in self.tracks:
            fid = int(track["fid"])
            targets = np.asarray(track["targets"], np.float32)   # (S, Q, 2)
            weights = np.asarray(track.get("weights", np.ones(targets.shape[:2])))
            static = track.get("static")
            static = None if static is None else np.asarray(static)
            S, Q = targets.shape[:2]
            colors = _colormap_rainbow(Q)
            first = fid - S
            for s in range(S):
                f_idx = first + s
                if not (0 <= f_idx < len(out)):
                    continue
                img = out[f_idx]
                for q in range(Q):
                    if weights[s, q] <= 0:
                        continue
                    x, y = targets[s, q]
                    if not (0 <= x < img.shape[1] and 0 <= y < img.shape[0]):
                        continue
                    if static is not None:
                        color = (0, 200, 0) if static[s, q] > 0.5 else (0, 0, 220)
                    else:
                        color = tuple(int(c) for c in colors[q])
                    cv2.circle(img, (int(x), int(y)), self.linewidth, color, -1)
                    for dt in range(1, min(self.trace, s) + 1):
                        x0, y0 = targets[s - dt, q]
                        x1, y1 = targets[s - dt + 1, q]
                        if weights[s - dt, q] <= 0:
                            break
                        cv2.line(img, (int(x0), int(y0)), (int(x1), int(y1)), color,
                                 max(1, self.linewidth // 2))
        return out

    def save_video(self, filename: str = "tracks") -> Optional[str]:
        """Render and write `save_dir/filename.mp4` (mp4v); returns its path,
        None when no frame was added. Raises when cv2 cannot open the
        writer (the JAX package would return the path of a file it never
        wrote)."""
        if not self.frames:
            return None
        cv2 = _cv2("writing the track video")
        os.makedirs(self.save_dir, exist_ok=True)
        frames = self.draw_tracks_on_frames()
        h, w = frames[0].shape[:2]
        path = os.path.join(self.save_dir, f"{filename}.mp4")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), self.fps, (w, h))
        if not writer.isOpened():
            raise RuntimeError(f"{path}: cv2.VideoWriter cannot open an mp4v writer here "
                               "(no codec in this OpenCV build)")
        for f in frames:
            writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        writer.release()
        return path


def video_frame_count(path) -> int:
    """The frames a video file holds, read back one by one with
    cv2.VideoCapture (0 for a file it cannot open)."""
    cv2 = _cv2("reading a video")
    cap = cv2.VideoCapture(str(path))
    count = 0
    while cap.read()[0]:
        count += 1
    cap.release()
    return count


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
