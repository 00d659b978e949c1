"""Stage-1 depth-prior benchmark of batrack_tpu_torch: DepthAnythingV2 and
UniDepthV2 forwards per second on one NVIDIA GPU (the port's counterpart of
bench_depth.py).

    python bench_depth_torch.py [--small] [--model {da2,unidepth,both}] [--device cpu]

The port's networks (depth/dpt.py, depth/unidepth.py) with random weights
from seed 0, the released shapes, so the same compute. DA2 at vitl on a
480x854 frame (a DAVIS 480p frame) preprocessed to 518 (vits at 240x427 to
196 with --small): ms per forward by CUDA events over 10 forwards (3 with
--small) after one, in float32 with TF32 allowed, as `infer_depth` runs it.
UniDepthV2 at its default arch (vitl, also with --small) through `infer` at
resolution_level None (0 with --small), over 10 calls (2 with --small)
after one, and again with outputs=("depth", "intrinsics"), the path of the
.npz writer. Runs on CUDA unless --device cpu is given, and raises without
a card. Prints one JSON line per model.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def frame_hw(small: bool):
    return (240, 427) if small else (480, 854)


def da2_input(small: bool):
    """(arch, the input size preprocess resizes to)."""
    return ("vits", 196) if small else ("vitl", 518)


def unidepth_level(small: bool):
    """resolution_level and the network's (h, w) for the frame."""
    from batrack_tpu_torch.depth.unidepth import _infer_shape

    level = 0 if small else None
    return level, list(_infer_shape(frame_hw(small), level)[0])


def seeded(cls, arch, device):
    """cls(arch) with weights from seed 0, in eval mode on `device`."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = cls(arch)
    return model.to(device).eval()


@torch.no_grad()
def bench_da2(small: bool, device) -> dict:
    from batrack_tpu_torch.depth.dpt import DepthAnythingV2, preprocess
    from batrack_tpu_torch.utils.config import allow_tf32
    from batrack_tpu_torch.utils.profiling import device_ms, device_record

    arch, size = da2_input(small)
    img = np.random.default_rng(0).uniform(0, 255, frame_hw(small) + (3,)).astype(np.uint8)
    x = torch.from_numpy(preprocess(img, input_size=size)).to(device)
    model = seeded(DepthAnythingV2, arch, device)
    with allow_tf32():
        ms = device_ms(lambda: model(x), 3 if small else 10, 1, device)
    return {
        "metric": f"da2_{arch}_fps",
        "value": 1000.0 / ms,
        "unit": "frames/s",
        "input": list(x.shape),
        "backend": device.type,
        "device": device_record(device),
        "notes": "network forward at the preprocessed size, TF32 allowed (resize and "
                 "normalisation excluded: host work); ms per forward from CUDA events "
                 "(perf_counter on the CPU).",
    }


def bench_unidepth(small: bool, device) -> dict:
    from batrack_tpu_torch.depth.unidepth import UniDepthV2, infer
    from batrack_tpu_torch.utils.profiling import device_ms, device_record

    level, hw = unidepth_level(small)
    H, W = frame_hw(small)
    img = np.random.default_rng(1).uniform(0, 255, (H, W, 3)).astype(np.uint8)
    model = seeded(UniDepthV2, "vitl", device)
    if infer(model, img, resolution_level=level)["depth"].shape != (H, W):
        raise RuntimeError("UniDepthV2 infer: depth is not at the frame's size")
    reps = 2 if small else 10
    ms_full = device_ms(lambda: infer(model, img, resolution_level=level), reps, 1, device)
    ms_slim = device_ms(lambda: infer(model, img, resolution_level=level,
                                      outputs=("depth", "intrinsics")), reps, 1, device)
    return {
        "metric": "unidepth_vitl_fps",
        "value": 1000.0 / ms_full,
        "value_depth_K_only": 1000.0 / ms_slim,
        "unit": "frames/s",
        "network_hw": hw,
        "backend": device.type,
        "device": device_record(device),
        "notes": "infer() per frame: resize, the network with TF32 allowed, ray generation "
                 "and the outputs copied to the host; value_depth_K_only is the .npz "
                 "writer's path (cli/infer_metric_depth.py: no confidence or points).",
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--small", action="store_true",
                        help="CPU-sized harness run (not a performance number)")
    parser.add_argument("--model", choices=["da2", "unidepth", "both"], default="both")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from batrack_tpu_torch.utils.config import resolve_device

    device = resolve_device(args.device)
    if args.model in ("da2", "both"):
        print(json.dumps(bench_da2(args.small, device)), flush=True)
    if args.model in ("unidepth", "both"):
        print(json.dumps(bench_unidepth(args.small, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
