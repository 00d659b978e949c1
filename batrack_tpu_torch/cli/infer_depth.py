"""Relative-depth inference CLI (stage 1) on PyTorch, the counterpart of
batrack_tpu/cli/infer_depth.py.

Usage:
    python -m batrack_tpu_torch.cli.infer_depth --img_dir FRAMES --out_dir OUT
        --checkpoint depth_anything_v2_vitl.pth [--encoder vitl] [--input_size 518]
        [--device cuda]

Runs DepthAnythingV2 over the frames of FRAMES (*.jpg and *.png) and saves one relative
disparity OUT/<frame>.npy (float32, the frame's size) per frame. The
released .pth loads as it is. --device defaults to CUDA and raises when
CUDA is absent.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def frame_paths(img_dir: str):
    """The frames of a directory, as the JAX CLIs list them (*.jpg then
    *.png, sorted together)."""
    return sorted(glob.glob(os.path.join(img_dir, "*.jpg"))
                  + glob.glob(os.path.join(img_dir, "*.png")))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--img_dir", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--checkpoint", required=True, help="depth_anything_v2_*.pth")
    parser.add_argument("--encoder", default="vitl", choices=["vits", "vitb", "vitl"])
    parser.add_argument("--input_size", type=int, default=518)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; raises without CUDA)")
    args = parser.parse_args(argv)

    from batrack_tpu_torch.data.image import read_image
    from batrack_tpu_torch.depth import dpt
    from batrack_tpu_torch.utils.config import resolve_device

    device = resolve_device(args.device)
    model = dpt.load_checkpoint(args.checkpoint, args.encoder).to(device).eval()
    os.makedirs(args.out_dir, exist_ok=True)
    files = frame_paths(args.img_dir)
    for i, path in enumerate(files):
        disp = dpt.infer_depth(model, read_image(path), args.input_size)
        base = os.path.splitext(os.path.basename(path))[0]
        np.save(os.path.join(args.out_dir, base + ".npy"), disp.astype(np.float32))
        if i % 20 == 0:
            print(f"[{i}/{len(files)}] {base}: disp range [{disp.min():.4f}, {disp.max():.4f}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
