"""The oracle run's trajectory error on the keyframe config of chip_smoke.py
phase 9 (davis_demo with use_keyframe, KEYFRAME_INDEX 5, S_slam 24,
num_init 23), through batrack_tpu_torch alone.

It prints the raw ATE against the synthetic scene's poses (as
tests/test_slam_e2e.py::ate_rmse takes it), the ATE after Sim(3)
alignment, the alignment's scale and each frame's error, so that the two
things an unaligned ATE mixes, a trajectory of the wrong shape and one of
the wrong scale, can be told apart. Options change the settings that
decide them: the optimisation window (davis_demo's 15 leaves frames 1-8 of
a 24-frame init unoptimised), the pose damping BA_EP, the patches per frame
and the image size (the focal length scales with the width).

    python scripts/torch_oracle_ate.py --device cpu --size 120x160 \\
        --patches 100 --opt-window 15

At 120x160 with 100 patches the CPU takes about two minutes per run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from batrack_tpu_torch.geometry import se3  # noqa: E402
from batrack_tpu_torch.slam import BATrack, OracleTracker  # noqa: E402
from batrack_tpu_torch.utils.config import Config  # noqa: E402
from batrack_tpu_torch.utils.evaluation import umeyama_alignment  # noqa: E402
from batrack_tpu_torch.utils.synth import make_scene  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default="480x640", help="HxW; the focal is 500 * W / 640")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--patches", type=int, default=400,
                    help="PATCHES_PER_FRAME, a square; PATCH_GEN is grid_grad_<sqrt>")
    ap.add_argument("--opt-window", type=int, default=24, help="OPTIMIZATION_WINDOW")
    ap.add_argument("--ba-ep", type=float, default=None, help="BA_EP (davis_demo: 10)")
    ap.add_argument("--no-keyframe", action="store_true", help="use_keyframe off (flat BA)")
    args = ap.parse_args()

    ht, wd = (int(x) for x in args.size.split("x"))
    f = 500.0 * wd / 640
    intr = np.array([f, f, wd / 2, ht / 2], np.float32)
    images, depths, poses_gt = make_scene(args.frames, ht, wd, intr)
    cfg = Config()
    s = cfg.slam
    s.use_keyframe = not args.no_keyframe
    s.BA_BACKEND = "flat"
    s.KEYFRAME_INDEX, s.S_slam, s.num_init = 5, 24, 23
    s.PATCHES_PER_FRAME = args.patches
    s.PATCH_GEN = f"grid_grad_{int(round(args.patches ** 0.5))}"
    s.OPTIMIZATION_WINDOW = args.opt_window
    if args.ba_ep is not None:
        s.BA_EP = args.ba_ep
    slam = BATrack(cfg, ht, wd, seed=0, device=args.device)
    slam.tracker = OracleTracker(poses_gt, intr, slam.dims, device=args.device)
    t0 = time.perf_counter()
    for t in range(args.frames):
        slam(t, images[t], depths[t], intr)
    poses, _ = slam.terminate()
    seconds = time.perf_counter() - t0

    gt = se3.inv(torch.from_numpy(poses_gt)).numpy()[:, :3].astype(np.float64)
    est = poses[:, :3].astype(np.float64)
    R, t, scale = umeyama_alignment(est, gt)
    raw = np.linalg.norm(est - gt, axis=1)
    aligned = np.linalg.norm(scale * est @ R.T + t - gt, axis=1)
    print(json.dumps({
        "size": args.size, "patches": args.patches, "opt_window": args.opt_window,
        "ba_ep": s.BA_EP, "use_keyframe": s.use_keyframe, "seconds": seconds,
        "ate_raw": float(np.sqrt(np.mean(raw ** 2))),
        "ate_sim3": float(np.sqrt(np.mean(aligned ** 2))),
        "run_scale": 1.0 / scale, "removed": sorted(slam.delta),
        "raw_per_frame": np.round(raw, 4).tolist(),
        "sim3_per_frame": np.round(aligned, 6).tolist()}))


if __name__ == "__main__":
    main()
