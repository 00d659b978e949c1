"""Metric-depth inference CLI (stage 1) on PyTorch, the counterpart of
batrack_tpu/cli/infer_metric_depth.py.

Usage:
    python -m batrack_tpu_torch.cli.infer_metric_depth --img_dir FRAMES --out_dir OUT
        --checkpoint model.safetensors [--arch vitl] [--intrinsics K.npy]
        [--resolution_level N] [--device cuda]

Runs UniDepthV2 over the frames of FRAMES (*.jpg and *.png) and saves one
OUT/<frame>.npz {depth, fov, intrinsics} per frame, the metric input of
align_depth. The released checkpoint (.pth, .bin or .safetensors) loads as
it is. --device defaults to CUDA and raises when CUDA is absent.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--img_dir", required=True, help="directory of *.jpg / *.png frames")
    parser.add_argument("--out_dir", required=True, help="output dir for per-frame .npz files")
    parser.add_argument("--checkpoint", required=True,
                        help="UniDepthV2 checkpoint (v2-vitl14 / v2-vits14)")
    parser.add_argument("--arch", default="vitl", choices=["vitl", "vits"])
    parser.add_argument("--intrinsics", default=None, help="optional .npy (3,3) gt intrinsics")
    parser.add_argument("--resolution_level", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; raises without CUDA)")
    args = parser.parse_args(argv)

    from batrack_tpu_torch.cli.infer_depth import frame_paths
    from batrack_tpu_torch.data.image import read_image
    from batrack_tpu_torch.depth import unidepth
    from batrack_tpu_torch.utils.config import resolve_device

    device = resolve_device(args.device)
    model = unidepth.load_checkpoint(args.checkpoint, args.arch).to(device).eval()
    K_gt = np.load(args.intrinsics) if args.intrinsics else None
    os.makedirs(args.out_dir, exist_ok=True)
    files = frame_paths(args.img_dir)
    if not files:
        print(f"no images in {args.img_dir}")
        return 1
    for f in files:
        out = unidepth.infer(model, read_image(f), intrinsics=K_gt,
                             resolution_level=args.resolution_level,
                             outputs=("depth", "intrinsics"))
        fov = np.rad2deg(2 * np.arctan(out["depth"].shape[-1] / (2 * out["intrinsics"][0, 0])))
        stem = os.path.splitext(os.path.basename(f))[0]
        np.savez(os.path.join(args.out_dir, stem + ".npz"), depth=np.float32(out["depth"]),
                 fov=fov, intrinsics=np.float32(out["intrinsics"]))
        print(f"{stem}: depth [{out['depth'].min():.2f}, {out['depth'].max():.2f}] m, "
              f"fov {fov:.1f} deg")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
