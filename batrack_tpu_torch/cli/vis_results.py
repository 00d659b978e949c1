"""4D visualization CLI (stage 4), the counterpart of
batrack_tpu/cli/vis_results.py.

Usage:
    python -m batrack_tpu_torch.cli.vis_results --result_path OUT/SCENE/results_refined.pkl
        [--stride 4]

Prints the shapes of the results' main arrays, then logs cameras, images,
point clouds and tracks to a Rerun viewer. Returns 1, after a message, when
rerun-sdk is not installed.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--result_path", required=True)
    parser.add_argument("--stride", type=int, default=4)
    args = parser.parse_args(argv)

    with open(args.result_path, "rb") as f:
        results = pickle.load(f)
    for key in ("rgbs", "dmaps_scaled", "dmaps", "cams_T_world", "intrinsics"):
        if results.get(key) is not None:
            print(f"  {key}: {np.asarray(results[key]).shape}")

    from batrack_tpu_torch.utils.visualizer import vis_rerun

    return 0 if vis_rerun(results, stride=args.stride) else 1


if __name__ == "__main__":
    raise SystemExit(main())
