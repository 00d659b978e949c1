"""Dense global-refinement CLI (stage 3) on PyTorch, the counterpart of
batrack_tpu/cli/run_refine.py.

Usage:
    python -m batrack_tpu_torch.cli.run_refine --result_dir RESULTS [--scenes a b]
        [--grid_size 10] [--niter 200] [--fixed_pose] [--fixed_K] [--device cuda]

Reads RESULTS/<scene>/results.pkl and writes RESULTS/<scene>/results_refined.pkl
(the input's keys plus dmaps_scaled, refined poses and intrinsics). --device
defaults to CUDA and raises when CUDA is absent.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

import torch


def refine_scene(result_path: str, cfg, image_hw=None, verbose=False, device="cuda") -> dict:
    from batrack_tpu_torch.refine import (
        build_refine_data,
        get_results,
        global_alignment_loop,
        init_params,
    )

    with open(result_path, "rb") as f:
        results = pickle.load(f)
    data = build_refine_data(results, align_depth=True, device=device)
    if image_hw is None:
        image_hw = tuple(data.dmaps.shape[-2:])
    params = init_params(data, cfg.grid_size)
    params, loss = global_alignment_loop(params, data, image_hw, cfg, verbose=verbose)
    return get_results(params, data, results, refine_K=not cfg.fixed_K)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--result_dir", type=str, required=True)
    parser.add_argument("--scenes", nargs="*", default=None)
    parser.add_argument("--grid_size", type=int, default=10)
    parser.add_argument("--niter", type=int, default=200)
    parser.add_argument("--fixed_pose", action="store_true")
    parser.add_argument("--fixed_K", action="store_true")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; raises without CUDA)")
    args = parser.parse_args(argv)

    from batrack_tpu_torch.utils.config import RefineConfig, resolve_device

    device = resolve_device(args.device)
    cfg = RefineConfig(grid_size=args.grid_size, niter=args.niter,
                       fixed_pose=args.fixed_pose, fixed_K=args.fixed_K)

    scenes = args.scenes or sorted(os.listdir(args.result_dir))
    for scene in scenes:
        result_path = os.path.join(args.result_dir, scene, "results.pkl")
        if not os.path.exists(result_path):
            print(f"Skipping {scene}: {result_path} not found")
            continue
        print(f"Processing scene: {scene}")
        t0 = time.perf_counter()
        refined = refine_scene(result_path, cfg, verbose=args.verbose, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"{scene}: {cfg.niter} steps in {time.perf_counter() - t0:.2f} s on {device}")
        out = os.path.join(args.result_dir, scene, "results_refined.pkl")
        with open(out, "wb") as f:
            pickle.dump(refined, f)
        print(f"Refined results saved to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
