"""Depth evaluation CLI on the host (numpy), the counterpart of
batrack_tpu/cli/eval_depth.py: evaluates each scene's depth maps against
ground truth, prints the table and appends it to RESULT_DIR/eval_depth.txt.

Usage:
    python -m batrack_tpu_torch.cli.eval_depth --result_dir RESULTS [--scenes a b]
        [--scaling median|lstsq|none] [--refined]
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

METRIC_NAMES = ["abs_rel", "sq_rel", "log10", "rmse", "rmse_log", "a1", "a2", "a3"]


def eval_scene(result_path: str, scaling: str = "median") -> np.ndarray:
    from batrack_tpu_torch.utils.evaluation import eval_depth_maps

    with open(result_path, "rb") as f:
        results = pickle.load(f)
    gt = np.asarray(results["dmaps_gt"], float)
    if gt.ndim == 4:
        gt = gt[..., 0]
    key = "dmaps_scaled" if "dmaps_scaled" in results else "dmaps"
    pred = np.asarray(results[key], float)
    if pred.ndim == 4:
        pred = pred[..., 0]
    return eval_depth_maps(gt, pred, scaling=scaling)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--result_dir", type=str, required=True)
    parser.add_argument("--scenes", nargs="*", default=None)
    parser.add_argument("--scaling", default="median", choices=["median", "lstsq", "none"])
    parser.add_argument("--refined", action="store_true",
                        help="evaluate results_refined.pkl instead of results.pkl")
    args = parser.parse_args(argv)

    fname = "results_refined.pkl" if args.refined else "results.pkl"
    scenes = args.scenes or sorted(os.listdir(args.result_dir))
    rows = {}
    for scene in scenes:
        path = os.path.join(args.result_dir, scene, fname)
        if not os.path.exists(path):
            continue
        rows[scene] = eval_scene(path, args.scaling)

    if not rows:
        print("no scenes evaluated")
        return 1

    header = f"{'scene':>16} | " + " | ".join(f"{m:>8}" for m in METRIC_NAMES)
    lines = [header]
    for scene, vals in rows.items():
        lines.append(f"{scene:>16} | " + " | ".join(f"{v:8.3f}" for v in vals))
    mean = np.mean(np.stack(list(rows.values())), axis=0)
    lines.append(f"{'mean':>16} | " + " | ".join(f"{v:8.3f}" for v in mean))
    table = "\n".join(lines)
    print(table)
    with open(os.path.join(args.result_dir, "eval_depth.txt"), "a+") as f:
        f.write(table + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
