"""Stage-1 depth-prior alignment CLI, the counterpart of
batrack_tpu/cli/align_depth.py.

Usage:
    python -m batrack_tpu_torch.cli.align_depth --depth_dir DEPTH --data_dir DATA
        [--mono_name depthAny_disp] [--metric_name unidepthv2] [--save_name unidepth_da]

For each scene directory of DEPTH/<mono_name>, aligns its relative
disparities (.npy) to DEPTH/<metric_name>/<scene>/*.npz and writes
normalised metric depth to DEPTH/<save_name>/<scene>/<frame>.npy and the
shared K to DEPTH/<save_name>_intrinsics/<scene>/<frame>_intrinsics.npy.
Runs on the CPU (numpy).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--depth_dir", type=str, required=True,
                        help="root containing <mono_name>/ and <metric_name>/ scene dirs")
    parser.add_argument("--data_dir", type=str, required=True,
                        help="root containing the per-scene image dirs")
    parser.add_argument("--mono_name", default="depthAny_disp")
    parser.add_argument("--metric_name", default="unidepthv2")
    parser.add_argument("--save_name", default="unidepth_da")
    args = parser.parse_args(argv)

    from batrack_tpu_torch.depth import align_depth_dirs

    mono_root = os.path.join(args.depth_dir, args.mono_name)
    metric_root = os.path.join(args.depth_dir, args.metric_name)
    for scene in sorted(os.listdir(mono_root)):
        print(scene)
        align_depth_dirs(
            mono_depth_dir=os.path.join(mono_root, scene),
            metric_depth_dir=os.path.join(metric_root, scene),
            image_dir=os.path.join(args.data_dir, scene),
            save_depth_dir=os.path.join(args.depth_dir, args.save_name, scene),
            save_K_dir=os.path.join(args.depth_dir, f"{args.save_name}_intrinsics", scene),
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
