"""Multi-GPU scaling of batrack_tpu_torch over 1, 2, 4 and 8 cards (the
port's counterpart of bench_scaling.py).

    python bench_scaling_torch.py [--counts 1,2,4] [--device cpu]

The port runs one process per GPU, so this script starts one torchrun group
per device count n (`python -m torch.distributed.run --standalone
--nproc_per_node n bench_scaling_torch.py --worker ...`); each worker calls
init_distributed() and get_mesh(n), and its rank 0 prints its readings as
one JSON line. The script then prints five JSON lines, one per section of
bench_scaling.py, with that script's keys plus the device record (the
card's name and nvidia-smi's power limit):

  slam_scaling_real_tracker  the BATrack loop with the real MDTracker at
      bench_scaling.py's configuration: 21 frames of the synthetic scene at
      192x256, BUFFER_SIZE 64, 64 grid_grad_8 patches per frame, S_slam 12,
      num_init 12, windows 20/15, BA_EP 0.4, model S 12 on a 192x256 input;
      frames 0-12 warm up (the initialisation's 12 updates at frame 12),
      frames 13-20 are timed. BATrack and MDTrackerAdapter take
      mesh=get_mesh(n) at every n, 1 included, so that every count runs the
      same sharded code and overhead[n] measures the ranks alone; adds
      the kernels' launches per append and the collectives of the timed
      frames.
  tracker_scaling  the MDTracker forward (S 8, 2 iterations, 1 static
      iteration, 96x128, 1024 queries drawn as bench_scaling.py draws them
      from numpy's default_rng(1); weights from seed 0) with the tracks
      sharded over the mesh, in float32 with the kernels K1 and K2; one
      warm-up and 2 timed repetitions, each reported; adds the launches per
      forward (K2 on its kv= route, since the mesh gathers keys).
  collective_bytes  (bench_scaling.py's collective_bytes_hlo) one call of
      parallel.fused_qkv_attention_sharded at B 12, N 2400, C 384, 8 heads,
      bf16, with the elements of its all-gathers counted at the port's
      own dist.all_gather (parallel/mesh.py::collective_counts) against the
      model B*N*2C, and the key mask's N elements where one is gathered;
      then the K/V all-gather alone (and as gather_rows calls it, with its
      concatenation), timed by CUDA events over back-to-back calls, and
      again queued behind a spin kernel (the device's time alone: the host
      issues these calls more slowly than the device runs them), and the
      rate each rank receives, (n-1)/n x bytes / time.
  ba_allreduce_bytes  (bench_scaling.py's ba_psum_bytes_hlo) one
      sharded_slot_slam_update at davis_demo's dims (480x640, BUFFER_SIZE
      1024, 400 patches, S_slam 12, num_init 12, windows 20/15) on a freshly
      initialised state, called as BATrack calls it at its initialisation
      (n = num_init + 1, initialised): every Gauss-Newton pose pass runs
      whatever the state holds. The all-reduce elements counted at
      ba/solver.py::all_reduce_sum against ITER x (72 W^2 + 12 W); the
      update's two all-gathers (its patches and the map filter's keep mask)
      are listed apart.
  collective_cost_model  bench_scaling.py's projection to 2, 4 and 8
      cards, on this machine's inputs: one space block's ms measured on one
      card at N 2400 by CUDA events, and the gather rate that
      collective_bytes measured at that count on the device's time (NVLink's
      data-sheet 450 GB/s each way, labelled nominal, where no count
      measured one). The bytes
      per space block are the gathered K/V array B x N x 2C x 2 bytes, which
      collective_bytes counts; bench_scaling.py's formula leaves out the B
      (frames) axis.

Runs on CUDA unless --device cpu is given, and raises without a card; on
the CPU the groups use gloo, and the ranks share the host's cores. The
counts are those of (1, 2, 4, 8) that the machine has (cards, or CPU
cores); --counts asks for others, must include 1, and raises when a count
exceeds the cards. Unlike bench_scaling.py this script never re-executes
itself on a virtual CPU mesh. Every group runs with OMP_NUM_THREADS=1
unless the caller sets it: torchrun sets it by itself for more than one
process per node, and one rank gets the same.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

COUNTS = (1, 2, 4, 8)
PROJECTED_COUNTS = (2, 4, 8)
# NVLink on an H100 SXM: 900 GB/s to the other cards, 450 GB/s each way
# (NVIDIA data sheet); the cost model's rate where no count measured one
NOMINAL_NVLINK_GBYTES_S = 450.0
BF16_BYTES = 2
# a spin of about 50 ms at the H100's 1.98 GHz: time for the host to queue
# the timed calls before the device reaches them (queued_ms)
SPIN_CYCLES = 100_000_000

# slam_scaling_real_tracker: bench_scaling.py's configuration
SLAM_FRAMES, SLAM_WARM = 21, 13
SLAM_HW = (192, 256)
SLAM_FOCAL = 200.0
SLAM_OVERRIDES = [
    "slam.BUFFER_SIZE=64", "slam.PATCHES_PER_FRAME=64", "slam.PATCH_GEN=grid_grad_8",
    "slam.S_slam=12", "slam.num_init=12", "slam.REMOVAL_WINDOW=20",
    "slam.OPTIMIZATION_WINDOW=15", "slam.BA_EP=0.4",
    "model.S=12", "model.sliding_window_len=12", "model.interp_shape=[192, 256]",
]
# tracker_scaling: bench_scaling.py's window, queries and TrackerParams
TRACKER = {"S": 8, "H": 96, "W": 128, "N": 1024, "reps": 2,
           "params": {"iters": 2, "static_iters": 1, "interp_shape": [96, 128]}}
# collective_bytes and the cost model's space block: the production shapes
GATHER = {"B": 12, "N": 2400, "C": 384, "heads": 8, "reps": 20}
# ba_allreduce_bytes: davis_demo's dims
BA_HW = (480, 640)
BA_OVERRIDES = [
    "slam.BUFFER_SIZE=1024", "slam.PATCHES_PER_FRAME=400", "slam.S_slam=12",
    "slam.num_init=12", "slam.REMOVAL_WINDOW=20", "slam.OPTIMIZATION_WINDOW=15",
]


def sizes() -> dict:
    """The module's configuration, as the workers receive it."""
    return {"slam_frames": SLAM_FRAMES, "slam_warm": SLAM_WARM, "slam_hw": list(SLAM_HW),
            "slam_focal": SLAM_FOCAL, "slam_overrides": SLAM_OVERRIDES, "tracker": TRACKER,
            "gather": GATHER, "ba_hw": list(BA_HW), "ba_overrides": BA_OVERRIDES}


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def queued_ms(fn, reps, device):
    """ms per call of `fn` on the device alone, or None off CUDA: the
    calls are queued behind a spin kernel, so the host is ahead of the
    device when they start and the two CUDA events around them bracket no
    host gap (back-to-back calls that the host issues more slowly than the
    device runs them time the host)."""
    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def launch_delta(before, per=1):
    from batrack_tpu_torch.ops import launch_counts

    return {k: (v - before[k]) / per for k, v in launch_counts().items()}


# ---------------------------------------------------------------- workers
def slam_section(sz, mesh, device):
    """fps over the timed frames, launches per append, the collectives of
    the timed frames."""
    import torch.distributed as dist

    from batrack_tpu_torch.ops import launch_counts
    from batrack_tpu_torch.parallel import collective_counts, reset_collective_counts
    from batrack_tpu_torch.slam import BATrack
    from batrack_tpu_torch.tracker import MDTrackerAdapter
    from batrack_tpu_torch.utils.config import load_config
    from batrack_tpu_torch.utils.synth import make_scene

    cfg = load_config(None, sz["slam_overrides"])
    ht, wd = sz["slam_hw"]
    T, warm, f = sz["slam_frames"], sz["slam_warm"], sz["slam_focal"]
    intr = np.array([f, f, wd / 2, ht / 2], np.float32)
    images, depths, _ = make_scene(T, ht, wd, intr)
    slam = BATrack(cfg, ht, wd, seed=0, device=device, mesh=mesh)
    slam.tracker = MDTrackerAdapter(cfg.model, seed=0, device=device, mesh=mesh)
    for t in range(warm):
        slam(t, images[t], depths[t], intr)
    synchronize(device)
    dist.barrier()
    before, appends = launch_counts(), slam.append_count
    reset_collective_counts()
    t0 = time.perf_counter()
    for t in range(warm, T):
        slam(t, images[t], depths[t], intr)
    synchronize(device)
    elapsed = time.perf_counter() - t0
    appends = slam.append_count - appends
    poses = slam.state.poses[: slam.n].float().cpu()
    if not torch.isfinite(poses).all():
        raise RuntimeError("slam_scaling_real_tracker: non-finite poses")
    return {"fps": (T - warm) / elapsed, "seconds": elapsed, "appends": appends,
            "launches_per_append": launch_delta(before, appends),
            "collectives_timed_frames": collective_counts(),
            "dtype": cfg.model.compute_dtype,
            "shapes": {"S_slam": cfg.slam.S_slam, "M": cfg.slam.PATCHES_PER_FRAME,
                       "interp": list(cfg.model.interp_shape), "frames": T,
                       "tracks_per_append": slam.dims.n_src * slam.dims.M}}


def tracker_inputs(tr, device):
    """bench_scaling.py's window and queries, drawn from default_rng(1)."""
    trng = np.random.default_rng(1)
    S, H, W, N = tr["S"], tr["H"], tr["W"], tr["N"]
    window = trng.uniform(0, 255, (S, 4, H, W)).astype(np.float32)
    window[:, 3] = trng.uniform(2, 6, (S, H, W)).astype(np.float32)
    queries = np.stack([np.zeros(N), trng.uniform(5, W - 5, N), trng.uniform(5, H - 5, N),
                        trng.uniform(2, 6, N)], -1).astype(np.float32)
    return (torch.as_tensor(window, device=device), torch.as_tensor(queries, device=device))


def tracker_section(sz, mesh, device):
    """Seconds of each timed forward and the launches per forward."""
    import torch.distributed as dist

    from batrack_tpu_torch.ops import launch_counts
    from batrack_tpu_torch.tracker.mdtracker import MDTracker, TrackerParams
    from batrack_tpu_torch.utils.config import full_fp32

    tr = sz["tracker"]
    prm = dict(tr["params"])
    prm["interp_shape"] = tuple(prm["interp_shape"])
    p = TrackerParams(S=tr["S"], use_corr_kernel=True, use_attention_kernel=True, **prm)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = MDTracker(p, mesh=mesh)
    model = model.to(device).eval()
    window, queries = tracker_inputs(tr, device)

    def forward():
        return model(window, queries)[0]

    with torch.no_grad(), full_fp32():
        out = forward()
        synchronize(device)
        if not torch.isfinite(out).all():
            raise RuntimeError("tracker_scaling: non-finite tracks")
        dist.barrier()
        before, reps = launch_counts(), []
        for _ in range(tr["reps"]):
            t0 = time.perf_counter()
            forward()
            synchronize(device)
            reps.append(time.perf_counter() - t0)
    return {"sec_per_rep": reps, "sec_per_forward": sum(reps) / len(reps),
            "launches_per_forward": launch_delta(before, len(reps))}


def qkv_inputs(g, mesh, device):
    """This rank's rows of a seeded (B, N, 3C) bf16 qkv, and its key mask:
    None when N divides over the ranks, else False on the padded rows (as
    the tracker passes it)."""
    from batrack_tpu_torch.parallel import shard_rows

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    qkv = torch.randn((g["B"], g["N"], 3 * g["C"]), generator=gen, device=device)
    loc = shard_rows(qkv.to(torch.bfloat16), mesh, 1)
    mask = None
    if g["N"] % mesh.size:
        mask = shard_rows(torch.ones(g["N"], dtype=torch.bool, device=device), mesh)
    return loc, mask


def gather_section(sz, mesh, device):
    """The all-gathers of one sharded attention call, then the K/V gather
    timed alone (dist.all_gather) and as the port calls it (gather_rows:
    the gather and the concatenation)."""
    import torch.distributed as dist

    from batrack_tpu_torch.ops import launch_counts
    from batrack_tpu_torch.parallel import (collective_counts, fused_qkv_attention_sharded,
                                            gather_rows, reset_collective_counts)
    from batrack_tpu_torch.utils.profiling import device_ms

    g = sz["gather"]
    B, C, heads = g["B"], g["C"], g["heads"]
    loc, mask = qkv_inputs(g, mesh, device)
    n_all = loc.shape[1] * mesh.size
    before = launch_counts()
    reset_collective_counts()
    out = fused_qkv_attention_sharded(loc, heads, (C // heads) ** -0.5, mesh, mask)
    synchronize(device)
    counts = collective_counts()
    launches = launch_delta(before)
    if not torch.isfinite(out.float()).all():
        raise RuntimeError("collective_bytes: non-finite attention output")

    kv = loc[..., C:].contiguous()
    parts = [torch.empty_like(kv) for _ in range(mesh.size)]
    times = {}
    for name, fn in (("allgather", lambda: dist.all_gather(parts, kv)),
                     ("gather_rows", lambda: gather_rows(kv, mesh, n_all, 1))):
        dist.barrier()
        times[f"{name}_ms"] = device_ms(fn, g["reps"], 2, device)
        dist.barrier()
        times[f"{name}_device_ms"] = queued_ms(fn, g["reps"], device)
    kv_bytes = B * n_all * 2 * C * BF16_BYTES
    received = (mesh.size - 1) / mesh.size * kv_bytes

    def rate(ms):
        return received / (ms * 1e-3) / 1e9 if mesh.size > 1 and ms is not None else None

    return {"n_all": n_all, "mask_gathered": mask is not None,
            "collectives": counts, "launches": launches, **times,
            "received_bytes": received,
            "receive_gbytes_per_s": rate(times["allgather_ms"]),
            "receive_gbytes_per_s_device": rate(times["allgather_device_ms"])}


def ba_section(sz, mesh, device):
    """The collectives of one patch-sharded backend update."""
    from batrack_tpu_torch.parallel import (collective_counts, reset_collective_counts,
                                            sharded_slot_slam_update)
    from batrack_tpu_torch.slam.state import StaticDims, init_state
    from batrack_tpu_torch.utils.config import full_fp32, load_config

    cfg = load_config(None, sz["ba_overrides"])
    ht, wd = sz["ba_hw"]
    dims = StaticDims.from_config(cfg, ht, wd)
    state = init_state(cfg, ht, wd, device)
    reset_collective_counts()
    with full_fp32():
        sharded_slot_slam_update(state, cfg.slam.num_init + 1, True, dims, cfg.slam, mesh)
    synchronize(device)
    return {"collectives": collective_counts(), "W": dims.window, "ITER": cfg.slam.ITER,
            "M": dims.M, "ring_slots": dims.ring_slots}


def space_block_ms(sz, device):
    """ms of one space block (pre-norm attention with K2 on all N tracks,
    and the MLP) on this device alone, at the tracker's bf16, by CUDA
    events over back-to-back calls."""
    from batrack_tpu_torch.ops import launch_counts
    from batrack_tpu_torch.tracker.blocks import AttnBlock
    from batrack_tpu_torch.utils.profiling import device_ms

    g = sz["gather"]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        block = AttnBlock(g["C"], g["heads"], use_kernel=True)
    block = block.to(device=device, dtype=torch.bfloat16).eval()
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    x = torch.randn((g["B"], g["N"], g["C"]), generator=gen, device=device).to(torch.bfloat16)
    before = launch_counts()
    with torch.no_grad():
        ms = device_ms(lambda: block(x), g["reps"], 2, device)
    return ms, launch_delta(before, g["reps"] + 2)


def worker(sz, device) -> int:
    """One rank of a torchrun group: every section's readings at this
    group's size; rank 0 prints them."""
    import torch.distributed as dist

    from batrack_tpu_torch.parallel import get_mesh, init_distributed
    from batrack_tpu_torch.utils.config import resolve_device

    device = resolve_device(device)
    init_distributed(device)
    n = int(os.environ["WORLD_SIZE"])
    mesh = get_mesh(n, device=device)
    try:
        out = {"worker": n,
               "slam": slam_section(sz, mesh, mesh.device),
               "tracker": tracker_section(sz, mesh, mesh.device),
               "gather": gather_section(sz, mesh, mesh.device),
               "ba": ba_section(sz, mesh, mesh.device)}
        if n == 1:
            out["space_block_ms"], out["space_block_launches"] = space_block_ms(sz, mesh.device)
    finally:
        dist.destroy_process_group()
    if mesh.rank == 0:
        print(json.dumps(out), flush=True)
    return 0


# ---------------------------------------------------------------- parent
def worker_env() -> dict:
    """The groups' environment: OMP_NUM_THREADS=1 unless the caller set
    it, which torchrun sets by itself for more than one process per node;
    one rank gets the same, so that every count runs alike."""
    return {"OMP_NUM_THREADS": "1", **os.environ}


def run_group(n, device, sz) -> dict:
    """One torchrun group of n ranks; its rank 0's readings."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(n), str(Path(__file__).resolve()), "--worker",
           "--device", device.type, "--sizes", json.dumps(sz)]
    r = subprocess.run(cmd, capture_output=True, text=True, env=worker_env())
    if r.returncode != 0:
        raise RuntimeError(f"the group of {n} ranks returned {r.returncode}:\n"
                           f"{r.stdout[-3000:]}\n{r.stderr[-5000:]}")
    lines = [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith('{"worker"')]
    if len(lines) != 1:
        raise RuntimeError(f"the group of {n} ranks printed {len(lines)} reading lines:\n"
                           f"{r.stdout[-3000:]}")
    return lines[0]


def choose_counts(asked, device):
    """The device counts to run: `asked`, else those of COUNTS the machine
    has. Raises when a count exceeds the cards (or, on the CPU, the cores)
    or 1 is missing (every overhead is relative to one device)."""
    have = torch.cuda.device_count() if device.type == "cuda" else os.cpu_count()
    counts = sorted(asked) if asked else [n for n in COUNTS if n <= have]
    if any(n > have for n in counts):
        what = "cards" if device.type == "cuda" else "CPU cores"
        raise RuntimeError(f"counts {counts} ask for more ranks than the {have} {what}")
    if 1 not in counts or any(n < 1 for n in counts):
        raise ValueError(f"counts {counts} must be positive and include 1")
    return counts


def sections(readings, sz, record, device) -> list:
    """The five output lines from each count's readings."""
    from batrack_tpu_torch.utils.config import Config

    counts = sorted(readings)
    backend, shared = device.type, device.type == "cpu"
    one = readings[1]
    fps = {str(n): readings[n]["slam"]["fps"] for n in counts}
    sec = {n: readings[n]["tracker"]["sec_per_forward"] for n in counts}
    tr = sz["tracker"]
    g = sz["gather"]
    lines = [{
        "metric": "slam_scaling_real_tracker",
        "fps": fps,
        "overhead": {str(n): fps["1"] / fps[str(n)] - 1.0 for n in counts if n > 1},
        "backend": backend,
        "shared_compute_mesh": shared,
        "shapes": one["slam"]["shapes"],
        "launches_per_append": {str(n): readings[n]["slam"]["launches_per_append"]
                                for n in counts},
        "collectives_timed_frames": {str(n): readings[n]["slam"]["collectives_timed_frames"]
                                     for n in counts},
        "omp_num_threads": worker_env()["OMP_NUM_THREADS"],
        "device": record,
        "notes": f"the port's BATrack loop with the real MDTracker ({one['slam']['dtype']}, K1; "
                 f"{one['slam']['shapes']['tracks_per_append']} tracks per append stay under "
                 "K2's 1024-track threshold, so space attention runs its plain version on "
                 "the gathered keys): track-sharded tracker and patch-sharded slot BA under "
                 "one process group of n ranks, mesh=get_mesh(n) at every n, 1 included. "
                 f"fps over frames {sz['slam_warm']}-{sz['slam_frames'] - 1} after a "
                 "synchronize, the host clock of rank 0; "
                 "overhead[n] = fps[1] / fps[n] - 1, unrounded. "
                 + ("The ranks share the host's CPU cores (gloo): the numbers show that the "
                    "path runs, not how it scales." if shared else
                    "One process per card, NCCL."),
    }, {
        "metric": "tracker_scaling",
        "sec_per_forward": {str(n): sec[n] for n in counts},
        "sec_per_rep": {str(n): readings[n]["tracker"]["sec_per_rep"] for n in counts},
        "overhead": {str(n): sec[n] / sec[1] - 1.0 for n in counts if n > 1},
        "backend": backend,
        "shared_compute_mesh": shared,
        "shapes": {"S": tr["S"], "H": tr["H"], "W": tr["W"], "N": tr["N"],
                   "iters": tr["params"]["iters"],
                   "static_iters": tr["params"]["static_iters"]},
        "launches_per_forward": {str(n): readings[n]["tracker"]["launches_per_forward"]
                                 for n in counts},
        "k2_kv_launches_per_forward": {
            str(n): readings[n]["tracker"]["launches_per_forward"]["fused_qkv_attention_kv"]
            for n in counts},
        "omp_num_threads": worker_env()["OMP_NUM_THREADS"],
        "device": record,
        "notes": "the MDTracker forward in float32 with K1 and K2 (bench_scaling.py ran the "
                 "JAX package's defaults), the query axis sharded over get_mesh(n) at every "
                 "n: space attention gathers the key/value lanes and runs K2 on its kv= "
                 "route; correlation, flow and time attention stay on the rank's tracks. "
                 "sec_per_rep: each timed forward, from its start to a synchronize; "
                 "overhead from the unrounded means.",
    }]

    per_mesh = {}
    for n in counts:
        rd = readings[n]["gather"]
        ag = rd["collectives"]["all_gather"]
        n_all = rd["n_all"]
        model_kv = g["B"] * n_all * 2 * g["C"]
        mask_el = sum(k for s, k in _shape_elements(ag["shapes"]) if s.startswith("bool"))
        model = model_kv + (n_all if rd["mask_gathered"] else 0)
        per_mesh[str(n)] = {
            "counted_allgather_output_elements": ag["elements"],
            "counted_allgather_calls": ag["calls"],
            "model_full_gather_elements": model_kv,
            "model_mask_elements": n_all if rd["mask_gathered"] else 0,
            "counted_mask_elements": mask_el,
            "counted_over_model": ag["elements"] / model,
            "bf16_mb": model_kv * BF16_BYTES / 1e6,
            "counted_shapes": ag["shapes"],
            "k2_kv_launches": rd["launches"]["fused_qkv_attention_kv"],
            "launches": rd["launches"],
            "allgather_ms": rd["allgather_ms"],
            "gather_rows_ms": rd["gather_rows_ms"],
            "allgather_device_ms": rd["allgather_device_ms"],
            "gather_rows_device_ms": rd["gather_rows_device_ms"],
            "received_mb_per_rank": rd["received_bytes"] / 1e6,
            "receive_gbytes_per_s": rd["receive_gbytes_per_s"],
            "receive_gbytes_per_s_device": rd["receive_gbytes_per_s_device"],
        }
    lines.append({
        "metric": "collective_bytes",
        "shapes": {"B": g["B"], "N": g["N"], "C": g["C"], "heads": g["heads"], "dtype": "bf16"},
        "per_mesh": per_mesh,
        "device": record,
        "notes": "all-gathers of one parallel.fused_qkv_attention_sharded call, counted at "
                 "the port's dist.all_gather (the whole gathered output, as an HLO "
                 "all-gather's shape) against the model B x N x 2C; the JAX function also "
                 "gathers a key mask of N elements at every call, the port only where the "
                 "caller passes one (padded tracks): counted_mask_elements. allgather_ms: "
                 "dist.all_gather of the K/V lanes alone, gather_rows_ms: with the "
                 "concatenation the port does after it, both CUDA events over back-to-back "
                 "calls on rank 0 (the host's rate where it issues them more slowly than "
                 "the device runs them); *_device_ms: the same calls queued behind a spin "
                 "kernel, the device's time alone. receive_gbytes_per_s = (n-1)/n x bytes "
                 "/ allgather_ms, *_device from allgather_device_ms.",
    })

    ba_mesh = {}
    ba = one["ba"]
    W, ITER = ba["W"], ba["ITER"]
    model_ba = ITER * (72 * W * W + 12 * W)
    for n in counts:
        c = readings[n]["ba"]["collectives"]
        ar, ag = c["all_reduce"], c["all_gather"]
        ba_mesh[str(n)] = {
            "counted_allreduce_elements": ar["elements"],
            "counted_allreduce_calls": ar["calls"],
            "model_elements": model_ba,
            "counted_over_model": ar["elements"] / model_ba,
            "f32_kb_per_update": ar["bytes"] / 1e3,
            "counted_shapes": ar["shapes"],
            "allgathers": {"calls": ag["calls"], "elements": ag["elements"],
                           "bytes": ag["bytes"], "shapes": ag["shapes"]},
        }
    lines.append({
        "metric": "ba_allreduce_bytes",
        "shapes": {"W": W, "ITER": ITER, "M": ba["M"], "ring_slots": ba["ring_slots"],
                   "dtype": "f32", "hw": list(sz["ba_hw"])},
        "per_mesh": ba_mesh,
        "state": "a freshly initialised state (slam/state.py::init_state), updated once as "
                 "BATrack updates at its initialisation (n = num_init + 1, initialised)",
        "device": record,
        "notes": "all-reduces of one sharded_slot_slam_update, counted at "
                 "ba/solver.py::all_reduce_sum, against the distributed-Schur model: per "
                 "Gauss-Newton pose pass B (W,W,6,6) + EQE (6W,6W) + vvec (W,6) + Ew (6W) = "
                 "72 W^2 + 12 W elements, ITER pose passes per update; the structure-only "
                 "passes have no collective. bench_scaling.py compiled the update and read "
                 "its HLO; the port executes it. allgathers: the update's patches and the "
                 "map filter's keep mask, which the JAX section does not count.",
    })

    block_ms = one["space_block_ms"]
    m = Config().model
    blocks_per_fwd = m.space_depth * m.I
    N, C, B = g["N"], g["C"], g["B"]
    rates = {}
    for n in counts[1:]:
        g_n = per_mesh[str(n)]
        device_rate = g_n["receive_gbytes_per_s_device"]
        rates[n] = ({"gbytes_per_s": device_rate,
                     "source": "measured, collective_bytes, device time"}
                    if device_rate is not None else
                    {"gbytes_per_s": g_n["receive_gbytes_per_s"],
                     "source": "measured, collective_bytes, back-to-back calls"})
    projection = {}
    for n in PROJECTED_COUNTS:
        rate = rates.get(n, {"gbytes_per_s": NOMINAL_NVLINK_GBYTES_S,
                             "source": "nominal, NVLink data sheet, each way"})
        bytes_per_block = (n - 1) / n * B * N * 2 * C * BF16_BYTES
        t_comm_ms = bytes_per_block / (rate["gbytes_per_s"] * 1e9) * 1e3
        eff = block_ms / (block_ms / n + t_comm_ms) / n
        ba_bytes = (72 * W * W + 12 * W) * 4
        projection[str(n)] = {
            "gather_gbytes_per_s": rate["gbytes_per_s"], "rate_source": rate["source"],
            "allgather_mb_per_space_block": bytes_per_block / 1e6,
            "comm_ms_per_block": t_comm_ms,
            "comm_ms_per_forward": t_comm_ms * blocks_per_fwd,
            "ba_allreduce_kb_per_pose_pass": ba_bytes / 1e3,
            "ba_allreduce_ms_per_pose_pass": ba_bytes / (rate["gbytes_per_s"] * 1e9) * 1e3,
            "tracker_efficiency_unoverlapped": min(1.0, eff),
        }
    lines.append({
        "metric": "collective_cost_model",
        "assumptions": {"N_tracks": N, "hidden": C, "S": B,
                        "space_blocks_per_forward": blocks_per_fwd,
                        "measured_block_ms_1card": block_ms,
                        "space_block_launches": one["space_block_launches"],
                        "gather_rates": {str(n): r for n, r in rates.items()}},
        "projection": projection,
        "device": record,
        "notes": "bench_scaling.py's projection with this machine's inputs: per space block "
                 "each card receives (n-1)/n of the gathered K/V array (B x N x 2C bf16; "
                 "bench_scaling.py's formula omits B); efficiency = block / (block / n + "
                 "comm) / n with no overlap of gather and compute. The block: pre-norm "
                 "attention (K2) and MLP over (B, N, C) in bf16 on one card, CUDA events "
                 "(perf_counter on the CPU). The BA all-reduce per pose pass: 72 W^2 + 12 W "
                 "float32 elements at the same rate.",
    })
    return lines


def _shape_elements(shapes):
    """(shape key, elements of all its calls) for a counter's shapes."""
    for key, calls in shapes.items():
        dims = key[key.index("[") + 1: -1]
        yield key, calls * math.prod(int(d) for d in dims.split(",") if d)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu (gloo)")
    parser.add_argument("--counts", default=None,
                        help="comma-separated device counts (default: those of 1,2,4,8 "
                             "the machine has); must include 1")
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--sizes", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    from batrack_tpu_torch.utils.config import resolve_device

    if args.worker:
        return worker(json.loads(args.sizes), args.device)
    device = resolve_device(args.device)
    asked = [int(c) for c in args.counts.split(",")] if args.counts else None
    counts = choose_counts(asked, device)
    if device.type == "cuda":
        from batrack_tpu_torch.ops import cuda_build

        cuda_build.build(["corr_sample", "fused_qkv_attention"])
    from batrack_tpu_torch.utils.profiling import device_record

    record = device_record(torch.device("cuda", 0) if device.type == "cuda" else device)
    sz = sizes()
    readings = {n: run_group(n, device, sz) for n in counts}
    for line in sections(readings, sz, record, device):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
