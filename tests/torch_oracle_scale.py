"""The oracle run's scale in both packages, on the CPU: the keyframe config
of scripts/torch_oracle_ate.py (davis_demo with use_keyframe,
KEYFRAME_INDEX 5, S_slam 24, num_init 23, OPTIMIZATION_WINDOW 24, flat BA),
through batrack_tpu's BATrack and OracleTracker, and through the port's
twice: with JAX's patch draws injected (tests/torch_parity.py::JaxDraws), so
both packages track the same patches, and with its own torch.Generator, as
scripts/torch_oracle_ate.py runs it. One JSON line per run: raw ATE, ATE
after Sim(3), the run's scale against the scene's, the removed frames.

    python tests/torch_oracle_scale.py [--size 120x160] [--patches 100]

At 120x160 with 100 patches: about 2.5 minutes for the JAX run and 1-1.5
for each port run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import JaxDraws  # noqa: E402

from batrack_tpu.slam import BATrack as JBATrack  # noqa: E402
from batrack_tpu.slam import OracleTracker as JOracle  # noqa: E402
from batrack_tpu.slam import StaticDims as JDims  # noqa: E402
from batrack_tpu.utils.config import Config as JConfig  # noqa: E402
from batrack_tpu_torch.geometry import se3  # noqa: E402
from batrack_tpu_torch.slam import BATrack, OracleTracker  # noqa: E402
from batrack_tpu_torch.slam.ingest import draw_shapes  # noqa: E402
from batrack_tpu_torch.utils.config import Config  # noqa: E402
from batrack_tpu_torch.utils.evaluation import umeyama_alignment  # noqa: E402
from batrack_tpu_torch.utils.synth import make_scene  # noqa: E402


def keyframe_config(cfg, patches: int):
    s = cfg.slam
    s.use_keyframe, s.BA_BACKEND = True, "flat"
    s.KEYFRAME_INDEX, s.S_slam, s.num_init, s.OPTIMIZATION_WINDOW = 5, 24, 23, 24
    s.PATCHES_PER_FRAME = patches
    s.PATCH_GEN = f"grid_grad_{int(round(patches ** 0.5))}"
    return cfg


def report(run, poses, poses_gt, seconds, removed):
    gt = se3.inv(torch.from_numpy(poses_gt)).numpy()[:, :3].astype(np.float64)
    est = np.asarray(poses)[:, :3].astype(np.float64)
    R, t, scale = umeyama_alignment(est, gt)
    raw = np.linalg.norm(est - gt, axis=1)
    aligned = np.linalg.norm(scale * est @ R.T + t - gt, axis=1)
    print(json.dumps({"run": run, "seconds": seconds,
                      "ate_raw": float(np.sqrt(np.mean(raw ** 2))),
                      "ate_sim3": float(np.sqrt(np.mean(aligned ** 2))),
                      "run_scale": 1.0 / scale, "removed": sorted(int(k) for k in removed)}),
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", default="120x160", help="HxW; the focal is 500 * W / 640")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--patches", type=int, default=100)
    ap.add_argument("--runs", default="jax,port_jax_draws,port",
                    help="comma-separated subset of jax, port_jax_draws, port")
    args = ap.parse_args()
    ht, wd = (int(x) for x in args.size.split("x"))
    f = 500.0 * wd / 640
    intr = np.array([f, f, wd / 2, ht / 2], np.float32)
    images, depths, poses_gt = make_scene(args.frames, ht, wd, intr)
    for run in args.runs.split(","):
        if run == "jax":
            cfg = keyframe_config(JConfig(), args.patches)
            slam = JBATrack(cfg, ht, wd, seed=0)
            slam.tracker = JOracle(poses_gt, intr, JDims.from_config(cfg, ht, wd))
        else:
            cfg = keyframe_config(Config(), args.patches)
            slam = BATrack(cfg, ht, wd, seed=0, device="cpu")
            slam.tracker = OracleTracker(poses_gt, intr, slam.dims, device="cpu")
            if run == "port_jax_draws":
                slam.draw_hook = JaxDraws(0, draw_shapes(cfg.slam.PATCH_GEN,
                                                         args.patches)[1])
        t0 = time.perf_counter()
        for i in range(args.frames):
            slam(i, images[i], depths[i], intr)
        poses, _ = slam.terminate()
        report(run, poses, poses_gt, time.perf_counter() - t0, slam.delta)


if __name__ == "__main__":
    main()
