"""Stage-3 dense-refinement benchmark of batrack_tpu_torch: Adam iterations/s
on one NVIDIA GPU (the port's counterpart of bench_refine.py).

    python bench_refine_torch.py [--small] [--device cpu]

Runs the port's refine/trainer.py::global_alignment_loop (a full autograd
step and Adam per iteration) on bench_refine.py's synthetic Sintel-sized
scene: 50 frames, 400 tracks per frame, S_local = 12, 436x1024, 300
iterations after a warm run of 30 from the same parameters (the loop
leaves its input parameters as they were). --small: 6 frames, 16 tracks,
S_local 4, 32x40, 12 iterations after 4. Runs on CUDA unless --device cpu
is given, and raises without a card. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

SINTEL = {"T": 50, "N": 400, "S_local": 12, "H": 436, "W": 1024, "niter": 300, "warm": 30}
SMALL = {"T": 6, "N": 16, "S_local": 4, "H": 32, "W": 40, "niter": 12, "warm": 4}


def make_results(T, N, S, H, W, rng):
    """Synthetic results.pkl dict: flat scene, smooth scale corruption
    (bench_refine.py's, with the same draws)."""
    gt = 5.0
    trajs_2d = np.stack(
        [rng.uniform(5, W - 5, (T, N, S)), rng.uniform(5, H - 5, (T, N, S))],
        -1,
    ).astype(np.float32)
    trajs_disp = np.full((T, N, S), 1.0 / gt, np.float32)
    trajs = np.concatenate([trajs_2d, trajs_disp[..., None]], -1)
    scales = (1.0 + 0.3 * np.sin(np.arange(T) * 0.7)).astype(np.float32)
    dmaps = np.full((T, H, W, 1), gt, np.float32) * scales.reshape(T, 1, 1, 1)
    cams = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
    return {
        "cams_T_world": cams,
        "intrinsics": np.tile(
            np.asarray([0.6 * W, 0.6 * W, W / 2, H / 2], np.float32), (T, 1)),
        "tstamps": np.arange(T, dtype=float),
        "trajs_2d_disp": trajs,
        "trajs_valid": np.ones((T, N), bool),
        "trajs_static": np.ones((T, N, S), np.float32),
        "trajs_vis": np.ones((T, N, S), np.float32),
        "grid_query_frames": np.arange(T),
        "dmaps": dmaps,
        "dmaps_gt": None,
        "rgbs": None,
    }


def bench(scene: dict, device="cuda") -> dict:
    """The warm run, then the timed run, at `scene` (SINTEL or SMALL)."""
    from batrack_tpu_torch.refine import build_refine_data, global_alignment_loop, init_params
    from batrack_tpu_torch.utils.config import RefineConfig, resolve_device
    from batrack_tpu_torch.utils.profiling import device_record

    device = resolve_device(device)
    cuda = device.type == "cuda"
    T, N, S, H, W = (scene[k] for k in ("T", "N", "S_local", "H", "W"))
    results = make_results(T, N, S, H, W, np.random.default_rng(0))
    data = build_refine_data(results, device=device)
    params = init_params(data, RefineConfig().grid_size)
    global_alignment_loop(params, data, (H, W), RefineConfig(niter=scene["warm"]))

    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    _, loss = global_alignment_loop(params, data, (H, W), RefineConfig(niter=scene["niter"]))
    if cuda:
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    return {
        "metric": "refine_iters_per_s",
        "value": scene["niter"] / seconds,
        "unit": "Adam iterations/s (steady state)",
        "scene": {k: scene[k] for k in ("T", "N", "S_local", "H", "W")},
        "niter": scene["niter"],
        "sec_per_scene": seconds,
        "final_loss": loss,
        "peak_memory_gib": torch.cuda.max_memory_allocated(device) / 2 ** 30 if cuda else None,
        "backend": device.type,
        "device": device_record(device),
        "notes": "full autograd step and Adam per iteration (refine/trainer.py), timed "
                 f"after a warm run of {scene['warm']} from the same parameters; the port "
                 "has no compile, so bench_refine.py's sec_per_scene_incl_compile is "
                 "sec_per_scene. peak_memory_gib over the timed run (null on the CPU): its "
                 "(T, S, N, N) term grows with N squared.",
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--small", action="store_true", help="CPU-sized scene")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    print(json.dumps(bench(SMALL if args.small else SINTEL, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
