"""End-to-end benchmark of batrack_tpu_torch: sparse-SLAM frames/s on one
NVIDIA GPU (the port's counterpart of bench.py).

    python bench_torch.py [--mesh N] [--device cpu]

Measures the port at the davis_demo configuration: 480x640 RGB-D frames of
the synthetic plane scene (utils/synth.py), BUFFER_SIZE=1024, 400 patches
per frame, S_slam=12, the full MDTracker in bf16 (random weights from seed
0: the released shapes, so the same compute), 4 refinement iterations, 64
frames. Runs on CUDA unless --device cpu is given, and raises without a
card. --mesh N runs the multi-device path (BATrack and MDTrackerAdapter
with mesh=get_mesh(N)): N=1 in this process on a one-rank group, N>1 under
`torchrun --nproc_per_node N`, where rank 0 prints.

Prints ONE JSON line with bench.py's keys:
  {"metric", "value", "unit", "vs_baseline", "reference_fps_estimate",
   "config", "backend", "stage_ms", "tracker_gflops_per_call",
   "tracker_gflops_flop_counter", "mfu", "launches_per_append", "device",
   "notes"}

Phase 1 times frames 16-63 with the frame uploads one frame ahead
(BATrack.upload_frame) and one synchronize after the warm-up and one at
the end. Phase 2 times each stage by CUDA events over PROFILE_FRAMES
back-to-back calls on the state phase 1 leaves (which it changes in
place): ingest, the tracker append (input, tracker, gate) and the backend
update. Their sum over one kf_stride period is held against phase 1's
measured ms per kf_stride frames.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

# a guess at the reference on its A40, not a measurement (BASELINE.md)
REFERENCE_FPS_ESTIMATE = 0.5
# one H100 SXM, bf16 dense tensor-core peak (NVIDIA data sheet); the
# tracker runs in bf16, the backend in float32
H100_BF16_FLOPS = 989e12

HT, WD = 480, 640
T, WARMUP_FRAMES, PROFILE_FRAMES = 64, 16, 8


def peak_flops(device):
    """The card's bf16 peak when it is an H100, else None (no peak is
    claimed for another card or the CPU)."""
    if device.type == "cuda" and "H100" in torch.cuda.get_device_name(device):
        return H100_BF16_FLOPS
    return None


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench(cfg, ht: int, wd: int, frames: int, warmup_frames: int, profile_frames: int,
          device="cuda", mesh=None) -> dict:
    """Phases 1 and 2 on `frames` frames of the synthetic scene at ht x wd
    under `cfg`; returns the output line as a dict."""
    from batrack_tpu_torch.ops import launch_counts
    from batrack_tpu_torch.slam import BATrack
    from batrack_tpu_torch.slam.frontend import build_tracker_input, gate_and_append
    from batrack_tpu_torch.slam.ingest import ingest_frame, make_draws
    from batrack_tpu_torch.tracker import MDTrackerAdapter
    from batrack_tpu_torch.utils.config import full_fp32, resolve_device
    from batrack_tpu_torch.utils.flops import tracker_forward_flops_from_params
    from batrack_tpu_torch.utils.profiling import device_ms, device_record
    from batrack_tpu_torch.utils.synth import make_scene
    from torch.utils.flop_counter import FlopCounterMode

    device = resolve_device(device)
    s = cfg.slam
    intr = np.array([500.0, 500.0, wd / 2, ht / 2], np.float32)
    images, depths, _ = make_scene(frames, ht, wd, intr)
    slam = BATrack(cfg, ht, wd, seed=0, device=device, mesh=mesh)
    # backward tracking only when the SLAM window exceeds the tracker's, as
    # the run_slam CLI decides (off at davis_demo: 12 == 12)
    slam.tracker = MDTrackerAdapter(
        cfg.model, seed=0, device=device, mesh=mesh,
        backward_tracking=s.backward_tracking and s.S_slam > cfg.model.S)
    device = slam.device
    ad, dims = slam.tracker, slam.dims

    # ---- phase 1: frames/s, uploads one frame ahead --------------------
    nxt = slam.upload_frame(images[0], depths[0])
    for t in range(warmup_frames):
        cur = nxt
        nxt = slam.upload_frame(images[t + 1], depths[t + 1])
        slam(t, cur[0], cur[1], intr)
    synchronize(device)
    before, appends = launch_counts(), slam.append_count
    t0 = time.perf_counter()
    for t in range(warmup_frames, frames):
        cur = nxt
        if t + 1 < frames:
            nxt = slam.upload_frame(images[t + 1], depths[t + 1])
        slam(t, cur[0], cur[1], intr)
    synchronize(device)
    elapsed = time.perf_counter() - t0
    fps = (frames - warmup_frames) / elapsed
    appends = slam.append_count - appends
    launches = {k: (v - before[k]) / appends for k, v in launch_counts().items()}

    # ---- phase 2: stage ms by CUDA events on the steady-state state ----
    # n - 2 keeps every write inside the buffer; the state changes in place
    n_fixed = slam.n - 2
    img, dep = slam.upload_frame(images[0], depths[0])
    intr_t = torch.as_tensor(intr, device=device)
    draws = make_draws(s.PATCH_GEN, dims.M, dims.ht, dims.wd, slam.generator)

    def run_ingest():
        with full_fp32():
            ingest_frame(slam.state, img, dep, intr_t, n_fixed, slam.counter, dims,
                         patch_gen=s.PATCH_GEN, motion_damping=s.MOTION_DAMPING,
                         mark_valid=False, draws=draws)

    def run_append():
        # BATrack derives the reuse hint from its last append's n, which a
        # repeated append at one n leaves unset (all S frames encoded): set
        # it as the loop has it, so the 2 new frames are encoded
        with full_fp32():
            tin = build_tracker_input(slam.state, n_fixed, dims)
            ad.reuse_hint = s.kf_stride
            tout = ad(tin)
            gate_and_append(slam.state, tin, tout, n_fixed, 0, dims,
                            vis_threshold=s.VIS_THRESHOLD, static_threshold=s.STATIC_THRESHOLD,
                            static_quantile=s.STATIC_QUANTILE, min_track_len=s.MIN_TRACK_LEN,
                            boundary_padding=s.BOUNDARY_PADDING)

    stage_ms = {name: device_ms(fn, profile_frames, 2, device)
                for name, fn in (("ingest", run_ingest), ("tracker_append", run_append),
                                 ("ba_update", slam.update))}
    kf = s.kf_stride
    stage_ms["predicted_ms_per_2frames"] = (kf * stage_ms["ingest"] + stage_ms["tracker_append"]
                                            + kf * stage_ms["ba_update"])
    stage_ms["measured_ms_per_2frames"] = kf * 1000.0 / fps

    # ---- FLOPs and MFU --------------------------------------------------
    # the static branch is computed only for a static merge (off at
    # davis_demo, tracker/adapter.py), so it is not counted
    p = ad.p if (ad.use_static_mask or ad.use_static) else ad.p._replace(static_iters=0)
    flops = tracker_forward_flops_from_params(p, N=dims.n_src * dims.M, H=p.interp_shape[0],
                                              W=p.interp_shape[1], new_frames=kf)["total"]
    with full_fp32():
        tin = build_tracker_input(slam.state, n_fixed, dims)
        ad.reuse_hint = kf
        with FlopCounterMode(display=False) as counter:
            ad(tin)
    peak = peak_flops(device)
    mfu = None if peak is None else flops / kf * fps / peak

    return {
        "metric": "slam_fps_e2e",
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": None,
        "reference_fps_estimate": REFERENCE_FPS_ESTIMATE,
        "config": f"BUFFER_SIZE={s.BUFFER_SIZE}, M={s.PATCHES_PER_FRAME}, S_slam={s.S_slam}, "
                  f"{cfg.model.compute_dtype} tracker, {ht}x{wd}, {frames - warmup_frames} "
                  "steady frames" + (f", mesh of {mesh.size}" if mesh is not None else ""),
        "backend": device.type,
        "stage_ms": stage_ms,
        "tracker_gflops_per_call": flops / 1e9,
        "tracker_gflops_flop_counter": counter.get_total_flops() / 1e9,
        "mfu": mfu,
        "launches_per_append": launches,
        "appends": appends,
        "device": device_record(device),
        "notes": "vs_baseline null: the reference publishes no frames/s (BASELINE.md); "
                 "reference_fps_estimate is a guess, not a measurement. value is frames/s "
                 "over the steady frames after one synchronize, frame uploads one ahead. "
                 "stage_ms are device ms per call from CUDA events around back-to-back calls "
                 "(perf_counter on the CPU), on the state phase 1 leaves; the port has no "
                 "fused ingest+update program, so bench.py's ingest_update_fused has no "
                 "counterpart and predicted_ms_per_2frames is kf_stride x (ingest + "
                 "ba_update) + tracker_append, against measured_ms_per_2frames = kf_stride "
                 "x 1000 / value. tracker_gflops_per_call is the analytic model "
                 "(utils/flops.py) with the static branch left out, as the adapter skips "
                 "it; tracker_gflops_flop_counter is torch.utils.flop_counter over one "
                 "forward, blind to the hand-written kernels K1 and K2 (ctypes launches). "
                 "mfu = analytic flops per frame x value / 989e12 (H100 bf16 dense); null "
                 + ("on the CPU." if device.type != "cuda" else
                    "when the card is not an H100.")
                 + " launches_per_append: the kernels' counters over the timed appends.",
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mesh", type=int, default=0, metavar="N",
                        help="run the multi-device path over N ranks (1: in this process)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from batrack_tpu_torch.utils.config import Config, resolve_device

    device = resolve_device(args.device)
    mesh = None
    if args.mesh:
        from batrack_tpu_torch.parallel import get_mesh, init_distributed

        init_distributed(device)
        mesh = get_mesh(args.mesh, device=device)
    try:
        if device.type == "cuda":
            from batrack_tpu_torch.ops import cuda_build

            cuda_build.build(["corr_sample", "fused_qkv_attention"])
        result = bench(Config(), HT, WD, T, WARMUP_FRAMES, PROFILE_FRAMES, device, mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()
    if mesh is None or mesh.rank == 0:
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
