"""Sparse SLAM CLI (stage 2) on PyTorch, the counterpart of
batrack_tpu/cli/run_slam.py.

Usage:
    python -m batrack_tpu_torch.cli.run_slam --config configs/davis_demo.yaml \
        [--device cuda] data.imagedir=... data.depthdir=... data.savedir=... data.name=...

Hydra-style `a.b=c` overrides are accepted after the flags. Writes, under
data.savedir/data.name, results.pkl, batrack_traj.txt, traj_plot.pdf (when
matplotlib is installed), eval_metrics.txt and, with save_video=true, the
track video <PATCH_GEN>.mp4, and appends to data.savedir/error_sum.txt when
data.gt_traj is set. --device defaults to
CUDA and raises when CUDA is absent.

As in the JAX CLI, slam.distributed joins the torchrun process group
(parallel.init_distributed) and slam.mesh_devices shards the work over a
mesh (get_mesh; under slam.distributed, every rank of the group). Only rank
0 keeps the raw frames and writes artifacts. The streams decode frames
ahead of the loop on worker processes; the loop's wait for each frame is
the timer's "stream" stage.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s")
logger = logging.getLogger(__name__)

PROFILE_FRAMES = (21, 31)  # torch.profiler runs over frames 21-30 with profile_dir


def build_stream(cfg):
    from batrack_tpu_torch.data import (
        dataset_rgbd_stream,
        davis_stream,
        sintel_rgbd_stream,
        tartanair_rgbd_stream,
    )

    d = cfg.data
    depthdir_gt = d.depthdir_gt or d.depthdir
    if (d.depthdir_gt and d.depthdir_gt != d.depthdir
            and d.traj_format not in ("sintel", "tartanair")):
        # the davis/generic streams carry no separate gt-depth channel; a
        # gt depth equal to the prior would corrupt the depth metrics
        raise ValueError(
            f"data.depthdir_gt={d.depthdir_gt!r} differs from data.depthdir "
            f"but traj_format {d.traj_format!r} has no gt-depth channel "
            f"(only sintel/tartanair do)")
    if d.native_prefetch and d.traj_format not in ("sintel", "tartanair"):
        return _native_stream(d)
    if d.traj_format == "sintel":
        return sintel_rgbd_stream(d.imagedir, d.depthdir, depthdir_gt, d.calib, d.stride,
                                  d.skip, d.end, d.input_intrinsics)
    if d.traj_format == "tartanair":
        return tartanair_rgbd_stream(d.imagedir, d.depthdir, depthdir_gt, d.calib, d.stride,
                                     d.skip, d.end)
    if d.traj_format == "davis":
        return davis_stream(d.imagedir, d.depthdir, d.calib, d.stride, d.skip, d.end)
    return dataset_rgbd_stream(d.imagedir, d.depthdir, d.calib, d.stride, d.skip, d.end,
                               mode=d.traj_format)


def _native_stream(d):
    """The prefetching path-list stream (data.native_prefetch) over the
    davis or generic layout."""
    from batrack_tpu_torch.data import native_rgbd_stream
    from batrack_tpu_torch.data.streams import IMG_EXTS, _glob_sorted

    image_list = _glob_sorted(d.imagedir, IMG_EXTS)
    depth_list = _glob_sorted(d.depthdir, ["*.npy"])
    end = d.end if d.end != -1 else len(image_list)
    if d.traj_format == "davis":
        Ks = np.array([np.load(str(k)) for k in _glob_sorted(d.calib, ["*.npy"])])
        Ks = Ks[d.skip:end:d.stride]
        intr = np.stack([Ks[:, 0, 0], Ks[:, 1, 1], Ks[:, 0, 2], Ks[:, 1, 2]], -1)
        intrinsics_fn = lambda t: intr[t]  # noqa: E731
    else:
        fixed = np.array(np.loadtxt(d.calib, delimiter=" ")[:4])
        intrinsics_fn = lambda t: fixed  # noqa: E731
    return native_rgbd_stream(image_list[d.skip:end:d.stride],
                              depth_list[d.skip:end:d.stride], intrinsics_fn)


def _make_mesh(cfg, device):
    """As the JAX CLI: slam.distributed joins the torchrun group; a mesh is
    made only when slam.mesh_devices is set (every rank of that group, or
    that many ranks made in-process); else None."""
    from batrack_tpu_torch.parallel import get_host_chip_mesh, get_mesh, init_distributed

    if cfg.slam.distributed:
        init_distributed(device=device)
    if not cfg.slam.mesh_devices:
        return None
    if cfg.slam.distributed:
        return get_host_chip_mesh(device=device)
    return get_mesh(cfg.slam.mesh_devices, device=device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", default=None, help="YAML config path")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; raises without CUDA)")
    parser.add_argument("overrides", nargs="*", help="key=value overrides")
    args = parser.parse_args(argv)

    from batrack_tpu_torch.utils.config import load_config, resolve_device

    cfg = load_config(args.config, args.overrides)
    device = resolve_device(args.device)
    owns_group = not torch.distributed.is_initialized()
    mesh = _make_mesh(cfg, device)
    try:
        return _run(cfg, args.seed, device, mesh)
    finally:
        if owns_group and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _run(cfg, seed: int, device: torch.device, mesh) -> int:
    from batrack_tpu_torch.slam import BATrack
    from batrack_tpu_torch.tracker import MDTrackerAdapter, load_checkpoint
    from batrack_tpu_torch.utils.evaluation import eval_metrics
    from batrack_tpu_torch.utils.traj import (
        load_traj,
        plot_trajectory,
        save_trajectory_tum_format,
    )
    from batrack_tpu_torch.utils.visualizer import TrackVisualizer

    if mesh is not None:
        logger.info("device mesh: %s", mesh)
    # the process's rank, as the JAX CLI's jax.process_index(): with
    # slam.distributed and no mesh every rank runs the whole loop
    dist = torch.distributed
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    state_dict = None
    if cfg.model.init_dir:
        logger.info("loading tracker checkpoint %s", cfg.model.init_dir)
        state_dict = load_checkpoint(cfg.model.init_dir)

    slam = None
    pending = None
    prof = None
    # raw frames are kept only where results.pkl is written (rank 0): at
    # 900 frames of 480x640 the float stack is ~10 GB of host memory
    keep_frames = cfg.save_results and rank0
    image_list, depth_list, depth_list_gt = [], [], []
    nf = 0
    start = time.time()
    # the loop's wait for each frame after the first is the "stream" stage
    frames = build_stream(cfg)
    try:
        waited = time.perf_counter()
        for t, image, depth, depth_gt, intrinsics in frames:
            waited = time.perf_counter() - waited
            if (isinstance(t, (int, np.integer)) and t == -1) or t == "-1":
                break
            depth = np.clip(depth, 1e-2, 1e2)
            nf += 1
            if keep_frames:
                image_list.append(image)
                depth_list.append(depth)
                depth_list_gt.append(depth_gt)
            if slam is None:
                ht, wd = image.shape[:2]
                slam = BATrack(cfg, ht, wd, seed=seed, device=device, mesh=mesh)
                slam.timer.enabled = True
                if cfg.save_video:
                    slam.visualizer = TrackVisualizer(
                        save_dir=os.path.join(cfg.data.savedir, cfg.data.name),
                        fps=cfg.visualizer.fps, linewidth=cfg.visualizer.linewidth,
                        tracks_leave_trace=cfg.visualizer.tracks_leave_trace)
                slam.tracker = MDTrackerAdapter(
                    cfg.model, state_dict=state_dict,
                    backward_tracking=(cfg.slam.backward_tracking
                                       and cfg.slam.S_slam > cfg.model.S),
                    static_threshold=cfg.slam.STATIC_THRESHOLD, device=device, mesh=mesh)
            else:
                slam.timer.add("stream", waited)
            # one-frame look-ahead: frame t+1's host-to-device copy overlaps
            # frame t's work; the host frame rides along for the host work
            # (sift patches, the track video), which then copies nothing back
            dev_img, dev_depth = slam.upload_frame(image, depth)
            item = (t, dev_img, dev_depth, intrinsics, image)
            if pending is not None:
                if cfg.profile_dir and nf == PROFILE_FRAMES[0]:
                    prof = _start_profile()
                    logger.info("profiler trace -> %s (frames %d-%d)", cfg.profile_dir,
                                PROFILE_FRAMES[0], PROFILE_FRAMES[1] - 1)
                slam(*pending)
                if prof is not None and nf == PROFILE_FRAMES[1]:
                    prof = _stop_profile(prof, cfg.profile_dir, rank0)
            pending = item
            waited = time.perf_counter()
    finally:
        frames.close()

    if slam is None or nf == 0:
        raise SystemExit(
            f"no frames found: check data.imagedir={cfg.data.imagedir!r}, "
            f"data.depthdir={cfg.data.depthdir!r}, skip/stride/end")
    if pending is not None:
        slam(*pending)
    if prof is not None:
        _stop_profile(prof, cfg.profile_dir, rank0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    total = time.time() - start
    logger.info("Total time: %.2f s | FPS: %.2f | s/frame: %.4f", total, nf / total, total / nf)
    logger.info("stage timings:\n%s", slam.timer.report())

    pred_traj = slam.terminate()

    gt_traj = None
    if cfg.data.gt_traj:
        gt_traj = load_traj(cfg.data.gt_traj, cfg.data.traj_format,
                            skip=cfg.data.skip, stride=cfg.data.stride, end=cfg.data.end)

    # every rank runs the same loop; artifacts are written once (rank 0),
    # since concurrent writes to the shared savedir would race
    if not rank0:
        return 0

    outdir = os.path.join(cfg.data.savedir, cfg.data.name)
    os.makedirs(outdir, exist_ok=True)

    if cfg.save_results:
        slam.get_results(rgbs=image_list, dmaps=depth_list, dmaps_gt=depth_list_gt,
                         save_path=os.path.join(outdir, "results.pkl"))
        logger.info("results saved to %s", os.path.join(outdir, "results.pkl"))

    if cfg.save_video and slam.visualizer is not None:
        path = slam.visualizer.save_video(filename=cfg.slam.PATCH_GEN)
        if path:
            logger.info("track video saved to %s", path)

    if cfg.save_trajectory:
        save_trajectory_tum_format(pred_traj, os.path.join(outdir, "batrack_traj.txt"))

    if cfg.save_plot:
        plot_trajectory(pred_traj, gt_traj=gt_traj,
                        title=f"Trajectory Prediction for {cfg.exp_name}",
                        filename=os.path.join(outdir, "traj_plot.pdf"))

    if gt_traj is not None:
        ate, rpe_t, rpe_r = eval_metrics(pred_traj, gt_traj=gt_traj, seq=cfg.exp_name,
                                         filename=os.path.join(outdir, "eval_metrics.txt"))
        with open(os.path.join(cfg.data.savedir, "error_sum.txt"), "a+") as f:
            f.write(
                f"{cfg.data.name:<20} | ATE: {ate:.5f}, RPE trans: {rpe_t:.5f}, "
                f"RPE rot: {rpe_r:.5f}\n{ate:.5f}\n{rpe_t:.5f}\n{rpe_r:.5f}\n")
        logger.info("ATE %.5f | RPE trans %.5f | RPE rot %.5f", ate, rpe_t, rpe_r)
    return 0


def _start_profile():
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir: str, rank0: bool) -> None:
    prof.stop()
    if rank0:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


if __name__ == "__main__":
    raise SystemExit(main())
