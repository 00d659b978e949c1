#!/usr/bin/env python3
"""Smoke run of batrack_tpu_torch on one NVIDIA GPU (H100 class).

    python3 chip_smoke.py [--profile]

Phases, each of which fails the run when it fails:

1. build the hand-written CUDA kernels from batrack_tpu_torch/csrc/ (one
   nvcc per source, all started together);
2. K1 (correlation windows) and K2 (packed-qkv attention) at the davis_demo
   shapes of the sparse-SLAM path (and the other kernels, below), each
   held against its plain PyTorch version on the same inputs with TF32 off
   (K1 on its bf16 maps, K2 in bf16 and in float32), and timed beside its
   plain version, a PyTorch library call where one exists (K2:
   scaled_dot_product_attention on the split-head layout) and the least
   time the card could take (`bound_ms`);
3. full-width MDTracker forwards, kernels against the plain versions, in
   float32 and in bf16, each beside a witness: the plain versions against
   themselves with their outputs jittered by one rounding of their dtype;
4. the main path: BATrack + MDTrackerAdapter at the davis_demo config
   (480x640 frames, 400 patches per frame, full MDTracker, random weights
   from a seed, bf16) over the ported synthetic plane scene. The kernels'
   launch counters are set to 0 just before it and read just after; each
   kernel must have launched. Prints frames/s and per-stage ms; with
   --profile, also device time by kernel over two more frames;
5. the backend on live edges: the same config with the visibility gate at
   0 (random weights put no track over 0.9), so the slot BA, the map filter
   and the ring run on weighted edges; then one backend update on the card
   against the same update on the CPU, beside the CPU update of a jittered
   copy as a witness of the system's conditioning;
6. the multi-device path on one card: a one-rank NCCL group made in this
   process (parallel.get_mesh(1)), BATrack and MDTrackerAdapter with
   mesh= over phase 4's frames (counters set to 0 just before, read just
   after: space attention must take K2's kv= route on every append),
   frames/s and stage ms beside phase 4's, the trajectory of the first 32
   frames held against phase 4's (zero edge weights in both, so this
   holds the ring and BA plumbing, not the tracker); then one tracker
   forward of phase 3's input under the mesh against the single-device
   forward at phase 3's bf16 limits, and the patch-sharded backend update
   on phase 5's live-edge state against phase 5's CPU update within 10x
   phase 5's witness;
7. the user's pipeline through the CLIs: a Sintel-layout dataset of the
   synthetic scene (40 frames 480x640 as PNG with libpng's choice of row
   filters, .npy priors, .dpt ground truth at prior x 1.01, .cam files) in
   a temporary directory, whose frames the port's stream must decode
   bitwise equal to the arrays written (decode ms per frame timed here);
   `cli.run_slam.main` at davis_demo on it, as shipped (K1 and K2 counted
   around the call: 4 and 24 per append; K3, K4 and K1's options 0),
   error_sum.txt equal at its rounding to eval_metrics recomputed from the
   written trajectory; `cli.run_refine.main` (grid 10, 200 steps) and
   `cli.eval_depth.main` with and without --refined. Then stage 3 at the
   same shape (T=40, N=400, S=23) on a synthetic results dict: 8 Adam steps
   in float64 on the card against the CPU within 10x a witness (the CPU
   run of inputs moved by one float64 rounding) and at least 1e-5, and 200
   steps of tests/test_refine.py::test_scale_recovery's configuration in
   float32 held to that test's bar. Prints frames/s, decode ms, the CLI's
   own (unsynchronised) stage ms, ms per Adam step and peak memory; with
   --profile, also device time by kernel over 5 stage-3 steps;
8. the whole demo chain (scripts/demo/*.sh) through the port's CLIs on
   phase 7's 40 frames laid out as DATA/<scene>/*.png: DepthAnythingV2 and
   UniDepthV2 at ViT-L width (weights from a seed, written as the released
   files: .pth and model.safetensors); one forward of each on the card in
   full float32 against the CPU's, within 10x a witness (the CPU forward of
   the input moved by one float32 rounding) and at least 1e-5 relative,
   beside the TF32 forward's gap and both times; `cli.infer_depth`,
   `cli.infer_metric_depth` and `cli.align_depth` (every kernel counter
   must stay 0), the artifacts' schema; `cli.run_slam` at davis_demo on the
   aligned priors (K1 4 and K2 24 per append), `cli.run_refine` at
   run_dense.sh's defaults (grid 12, 300 steps) and `cli.vis_results` (rc 1
   only without rerun-sdk, with its summary). Prints per network ms per
   forward (CUDA events), the CLI's wall time per frame, tokens, TFLOP per
   forward (torch.utils.flop_counter) and TFLOP/s, and peak memory; with
   --profile, device time by kernel over one TF32 forward of each.
9. the keyframe / multi-window path: davis_demo with use_keyframe
   (KEYFRAME_INDEX 5: the shipped 4 can never fire with kf_stride 2),
   S_slam 24 (three sliding windows, K2 with key masks, backward tracking),
   num_init 23 and OPTIMIZATION_WINDOW 24, so the flat BA runs over every
   init frame. a. BATrack + MDTrackerAdapter over 40 frames, counters set
   to 0 just before and read just after: K1 24 and K2 144 launches per
   append (3 windows x 4 iterations x 6 space blocks, forward and
   backward), every K2 launch masked, K3, K4 and K1's options 0; frames/s
   over frames 16-31, synchronised stage ms over 32-39 (with `keyframe`
   and the flat `ba_update`), removals (must be > 0), peak memory; then
   one more append's forward with every K1 launch and the first K2 launch
   of each window's key mask held against the plain versions on the same
   inputs, K1 timed at that shape beside its bound, and K2 with the first
   window's key mask timed beside SDPA with the same boolean mask and the
   bound. b. The same config with the port's OracleTracker (noise 0, no
   kernel runs; checked) for 32 frames: the ATE against the scene's poses
   after Sim(3) alignment under tests/test_slam_e2e.py::test_pose_recovery's
   0.05 and unaligned under twice that (the monocular scale is printed),
   removals, then one flat update on the card against the CPU
   within 10x the jitter witness, and the flat update timed with its block
   sums in float64 (shipped) and in float32, with a profiler split; c. the
   state saved at frame 28 (initialised, after removals; checked), loaded
   into a fresh BATrack on the card and run to the end: the same removals,
   the trajectory within that witness of b's; d. the edge-sharded flat
   update (parallel/sharded_ba.py) on a one-rank group against b's CPU
   update.
10. the DAVIS JPEG demo (scripts/demo/run_demo.sh's journey on DAVIS-shaped
   input): 40 frames of the scene at 480x854 written as JPEG (quality 90)
   into JPEGImages/480p/<scene>, decoded through data/image.py (cv2);
   `cli.infer_depth` and `cli.infer_metric_depth` at ViT-L width (seeded
   weights written as the released files) and `cli.align_depth`, no kernel
   launching; `cli.run_slam` at davis_demo with PATCH_GEN=sift and
   save_video=true: K1 and K2 counted around the call against the code's 4
   and 24 per append, every launch of the first append held against the
   plain versions (K1 1e-4, K2 two bf16 ulps), the patches ingested on one
   frame held equal to generate_patches_sift's output for that frame and
   generator state, the mp4 read back frame by frame; `cli.run_refine` and
   `cli.vis_results`. Prints each network's token grid, ms per forward and
   TFLOP/s at this aspect, sift ms per frame and keypoints kept against
   M=400, the CLI's frames/s (the first append's checks taken out) and
   stage ms (stream wait, sift, track_video), and peak memory.

Phase 4 also prints the tracker forward's TFLOP (utils/flops.py) and
TFLOP/s at its synchronised ms per append.

With --ranks, under torchrun (one process per GPU), it runs only the
multi-device path at the group's world size: a tracker forward held
against the single-device one, the SLAM loop with live edges, timed, and
one patch-sharded backend update and one edge-sharded flat update of its
final state against the CPU updates (README).

With --decode-ab [ROUNDS], it runs only an A/B of the frame decode through
`cli.run_slam.main` at davis_demo (main_decode_ab): phase 7's dataset
written with libpng's row filters and again unfiltered, and per round four
runs in a turning order: `filtered` and `unfiltered` as shipped (the
streams decode ahead on worker processes, data/streams.py::_ahead),
`filtered_threads` (the same look-ahead on as many threads) and
`filtered_inline` (the loop's own thread decodes, as the JAX CLI does).
One warm-up run first is not counted. It records decode ms per frame on
one thread per dataset, and per run frames/s over the whole CLI run and
the CLI timer's unsynchronised host ms per stage ("stream" is the loop's
wait for its next frame, which inline holds the decode), then medians,
and writes them to chiprun_out/decode_ab.json.

Phase 2 also holds K2 with a kv= source (queries of all 2400 tracks, the
shape phase 6 gives it at one rank, and of a quarter of them, one rank of
a 4-way track shard), K3 (vmem_attention, on no path of the JAX package)
and K4 (flash_attention: split-head attention on the same kernel, the
route Attention takes under BATRACK_TPU_ATTN=flash) against their plain
versions, and times them beside scaled_dot_product_attention. It holds
K1's two options, the tensor-core contraction (contract="mxu") and int8
maps (fmap_dtype="int8"), at K1's shapes against their plain versions and
times them; then it drives the path that selects them,
scripts/torch_corr_ab.py, with their launch counters set to 0 just before
and read just after. Last in phase 2, K2 packed, K2 kv= (slim and packed
sources), K3 and K4 are held against their plain versions at the edges of
the bf16 kernel's tiling: query and key counts that leave its 128-query
and 128-key tiles ragged, fewer keys than one tile, and key masks that
mask whole key tiles. Phase 3 adds one bf16 forward under
BATRACK_TPU_ATTN=flash, held against the fused route's forward at the bf16
limits: K4 must launch as often as K2 does there, every time on the split
views in place (its strided counter), and K2 not at all. Phases 4 and 6
check 24 attention launches and 4 K1 launches per append (6 space blocks x
4 iterations, one K1 per iteration), and that K3, K4 and K1's options
launch 0 times. Phase 2 prints, beside K1's bound, the bytes of its in-map
taps and of the resident levels' map copies.

It then prints one {"kernels": [...]} line (phase 9 adds the keyframe
path's launches to K1's and K2's entries, K1's check and timing at that
path's shape under "keyframe_path" and K2's masked ones under "masked";
phase 10 its launches and first-append checks under "davis_jpeg_path"),
the card's name and power limit
(nvidia-smi), and last {"ok": true, "device": {...}}. Without a CUDA device,
or outside a checkout of the repository, it exits non-zero and prints no
result. The sha256 it prints first covers this script and every source of
batrack_tpu_torch/, and ties a run's numbers to a tree.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import hashlib
import importlib.util
import io
import json
import math
import os
import pickle
import shutil
import struct
import subprocess
import sys
import statistics
import tempfile
import time
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM3 bytes/s,
# bf16 tensor-core FLOP/s, float32 FLOP/s outside the tensor cores. The
# special-function units' exp rate is not published: 132 SMs x 16 per clock
# at the card's highest SM clock, 1.98 GHz (nvidia-smi clocks.max.sm, printed
# by main), the fastest the units can run; the data sheet's bf16 rate is
# taken at 1.83 GHz, and at 1.98 GHz (1070e12) it still binds no attention
# bound here, the exponentials do.
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
SFU_OPS_S = 132 * 16 * 1.98e9

# davis_demo shapes of the tracker append (configs/davis_demo.yaml)
S, C, H4, W4, LEVELS, RADIUS = 12, 128, 96, 128, 4, 3
NQ = 6 * 400                      # n_src source frames x PATCHES_PER_FRAME
HIDDEN, HEADS = 384, 8
SHARDS = 4                        # K2 kv=: one rank's queries of a 4-way track shard
SPACE_LAUNCHES = 6 * 4            # K2 per append: 6 space blocks x 4 refinement iterations
CORR_LAUNCHES = 4                 # K1 per append: one per refinement iteration
K3_B = S * HEADS                  # K3: (batch x heads, tracks, head dim) of space attention
FRAMES, STEADY_FROM, STAGE_FROM = 40, 16, 32
HT, WD = 480, 640
INTR = np.array([500.0, 500.0, WD / 2, HT / 2], np.float32)

BA_FRAMES = 20                    # num_init=12: init at frame 12, then 7 updates
FLOW_HEAD_DAMPING = 0.05

# K1 and K2 in float32 are held to 1e-4, K2 in bf16 to two bf16 ulps of its
# output's largest magnitude (bf16_tol). The tracker limits (flow heads
# damped) are about 4x the larger of the kernels' reading and its witness
# on an H100 (PERF.md, PR 1): tracks in px at 480x640. The backend update
# is held to 10x its witness from the same run, and at least 1e-5: random
# tracks make a system whose conditioning changes from frame to frame (the
# witness on the poses went from 2.3e-6 at frame 16 to 8.7e-5 at frame 20).
TOL = {"k1": 1e-4, "k2_f32": 1e-4,
       "tracker_f32": {"tracks": 5e-3, "vis": 1e-3, "dynamic": 1e-4},
       "tracker_bf16": {"tracks": 0.5, "vis": 0.1, "dynamic": 2e-2},
       "ba_witness_factor": 10.0, "ba_floor": 1e-5}


def source_digest() -> str:
    """sha256 over this script, scripts/torch_corr_ab.py (which phase 2
    runs) and every .py/.cu file of batrack_tpu_torch/."""
    root = Path(__file__).resolve().parent
    files = [root / "chip_smoke.py", root / "scripts" / "torch_corr_ab.py"] + sorted(
        p for p in (root / "batrack_tpu_torch").rglob("*") if p.suffix in (".py", ".cu"))
    h = hashlib.sha256()
    for p in files:
        h.update(str(p.relative_to(root)).encode() + b"\0" + p.read_bytes() + b"\0")
    return h.hexdigest()


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps, warmup=2):
    """Device time per call from CUDA events around `reps` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b):
    """Largest absolute difference, in float64 when either side is."""
    dt = torch.float64 if torch.float64 in (a.dtype, b.dtype) else torch.float32
    return (a.to(dt) - b.to(dt)).abs().max().item()


def bf16_tol(ref):
    """Two bf16 ulps (8 significand bits) of the largest magnitude in ref:
    one output rounding apart, with a factor of two to spare."""
    return 2.0 * 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)


def check(name, err, tol):
    ok = err <= tol and math.isfinite(err)
    log(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")


def bound(bytes_moved, op_times):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over their peak rate."""
    t_bytes = bytes_moved / HBM_BYTES_S
    t_ops = max(op_times)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


@contextlib.contextmanager
def plain_kernels(jitter_gen=None):
    """Route the tracker's two kernel call sites to the plain versions. With
    a generator, each output element x becomes x * (1 + e * u), u uniform in
    [-1, 1] and e the machine epsilon of x's dtype: differences of the size
    of the kernels' rounding, to show how far the tracker carries them."""
    from batrack_tpu_torch.ops import attention, corr_kernel
    from batrack_tpu_torch.tracker import blocks, mdtracker

    def jittered(fn):
        if jitter_gen is None:
            return fn

        def run(*args, **kw):
            x = fn(*args, **kw)
            u = torch.rand(x.shape, generator=jitter_gen, device=x.device) * 2 - 1
            return (x.float() * (1 + torch.finfo(x.dtype).eps * u)).to(x.dtype)
        return run

    saved = mdtracker.corr_sample, blocks.fused_qkv_attention
    mdtracker.corr_sample = jittered(corr_kernel.corr_sample_plain)
    blocks.fused_qkv_attention = jittered(attention.fused_qkv_attention_plain)
    try:
        yield
    finally:
        mdtracker.corr_sample, blocks.fused_qkv_attention = saved


# ---------------------------------------------------------------- K1
def k1_taps(shapes, coords, radius):
    """The work every K1 variant must do: the (2r+2)^2 integer taps of each
    window that lie in its level's map, over the levels' (H, W) `shapes`
    (out-of-map taps are zero: the vpu kernels skip them, the mxu kernel
    multiplies zero rows)."""
    off = torch.arange(2 * radius + 2, device=coords.device, dtype=torch.float32)
    taps = 0
    for lvl, (h, w) in enumerate(shapes):
        c = coords / 2.0 ** lvl
        xs = torch.floor(c[..., 0:1]) - radius + off
        ys = torch.floor(c[..., 1:2]) - radius + off
        nx = ((xs >= 0) & (xs < w)).sum(-1)
        ny = ((ys >= 0) & (ys < h)).sum(-1)
        taps += int((nx * ny).sum().item())
    return taps


def k1_bound(pyr, targets, coords, radius, taps, contract="vpu"):
    """(bound_ms, bound_by, bytes) of one K1 call: every input read once (1
    byte per int8 map element, and the (L,) scales), the (2r+1)^2 outputs
    of each window written once; operations are the window products of the
    in-map taps, on the bf16 tensor cores for mxu, and the 2x2 blend and
    scale per output."""
    n_out = targets.shape[0] * targets.shape[1] * len(pyr.shapes) * (2 * radius + 1) ** 2
    nbytes = (pyr.flat.numel() * pyr.flat.element_size() + targets.numel() * 4
              + coords.numel() * 4 + n_out * 4
              + (pyr.scales.numel() * 4 if pyr.scales is not None else 0))
    if contract == "mxu":
        ops = [2 * pyr.C * taps / BF16_FLOPS, 8 * n_out / F32_FLOPS]
    else:
        ops = [(2 * pyr.C * taps + 8 * n_out) / F32_FLOPS]
    return (*bound(nbytes, ops), nbytes)


def phase_k1(dev, gen):
    """K1 on bf16 maps with the float32 contraction (the tracker's), then
    its two options, the tensor-core contraction and int8 maps, at the
    davis_demo shapes against their plain versions (1e-4: exact products,
    sums in another order), each timed beside its plain version and its
    bound. No single PyTorch call computes the windows: no library time."""
    from batrack_tpu_torch.ops.corr import build_pyramid
    from batrack_tpu_torch.ops.corr_kernel import (RES_CHUNK, corr_sample, corr_sample_plain,
                                                   pack_pyramid, resident_levels)
    from batrack_tpu_torch.utils.config import full_fp32

    log(f"[K1] corr_sample: fmaps ({S}, {C}, {H4}, {W4}) x {LEVELS} levels, "
        f"targets ({NQ}, {S}, {C}) f32, coords ({S}, {NQ}, 2)")
    fm = torch.randn((S, C, H4, W4), generator=gen, device=dev)
    targets = torch.randn((NQ, S, C), generator=gen, device=dev)
    # track positions over the map plus a margin: some windows cross the edge
    u = torch.rand((S, NQ, 2), generator=gen, device=dev)
    coords = torch.stack([u[..., 0] * (W4 + 8) - 4, u[..., 1] * (H4 + 8) - 4], -1)
    pyramid = build_pyramid(fm, LEVELS)
    shapes = [tuple(fl.shape[2:]) for fl in pyramid]
    taps = k1_taps(shapes, coords, RADIUS)
    # what the main kernel reads beside the bound's bytes: its in-map taps
    # (256 bytes each, read from shared memory for resident levels and
    # through the L2 for streamed ones) and the copies of the resident
    # levels' maps, one per (frame, chunk of RES_CHUNK tracks)
    resident = resident_levels(shapes, C)
    tap_mb = taps * 2 * C / 1e6
    resident_mb = sum(S * -(-NQ // RES_CHUNK) * h * w * C * 2
                      for (h, w), res in zip(shapes, resident) if res) / 1e6
    entries = []
    for fd, ct, name, line in (("bf16", "vpu", "corr_sample", 52),
                               ("bf16", "mxu", "corr_sample_mxu", 110),
                               ("int8", "vpu", "corr_sample_int8", 72)):
        with full_fp32():
            pyr = pack_pyramid(pyramid, fd)
            out = corr_sample(pyr, targets, coords, RADIUS, contract=ct)
            torch.cuda.synchronize()
            assert out.shape == (NQ, S, LEVELS * (2 * RADIUS + 1) ** 2)
            err = max_err(out, corr_sample_plain(pyr, targets, coords, RADIUS, contract=ct))
            check(f"K1 vs plain, {fd} maps, {ct} contraction", err, TOL["k1"])
            ms = cuda_ms(lambda: corr_sample(pyr, targets, coords, RADIUS, contract=ct), reps=50)
            plain_ms = cuda_ms(lambda: corr_sample_plain(pyr, targets, coords, RADIUS,
                                                         contract=ct), reps=5)
        bound_ms, bound_by, nbytes = k1_bound(pyr, targets, coords, RADIUS, taps, ct)
        log(f"  kernel_ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms null  bound_ms "
            f"{bound_ms:.4f} ({bound_by}: {nbytes / 1e6:.1f} MB, {2 * C * taps / 1e9:.2f} "
            f"GFLOP {'bf16' if ct == 'mxu' else 'f32'})")
        if name == "corr_sample":
            log(f"  tap bytes {tap_mb:.1f} MB (in-map taps x {2 * C} B); levels resident in "
                f"shared memory {resident}, their map copies {resident_mb:.1f} MB")
        entries.append({"name": name, "route": "cuda",
                        "source": "batrack_tpu_torch/csrc/corr_sample.cu",
                        "replaces": f"batrack_tpu/ops/pallas_corr.py:{line}",
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    return entries


def phase_corr_ab(dev):
    """The path that selects K1's options: scripts/torch_corr_ab.py (parity
    of each variant against its plain version, then its times), with the
    variants' launch counters set to 0 just before and read just after."""
    import importlib.util

    from batrack_tpu_torch.ops.corr_kernel import corr_sample

    spec = importlib.util.spec_from_file_location(
        "torch_corr_ab", Path(__file__).resolve().parent / "scripts" / "torch_corr_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    log("[corr A/B] scripts/torch_corr_ab.py, 5 reps")
    corr_sample.mxu_launches = corr_sample.int8_launches = 0
    ab.run(dev, reps=5, log=lambda m: log(f"  {m}"))
    launches = {"corr_sample_mxu": corr_sample.mxu_launches,
                "corr_sample_int8": corr_sample.int8_launches}
    log(f"  launches {launches}")
    if not all(launches.values()):
        raise AssertionError(f"the A/B path did not launch every K1 variant: {launches}")
    return launches


# ---------------------------------------------------------------- K2
def phase_k2(dev, gen):
    import torch.nn.functional as F

    from batrack_tpu_torch.ops.attention import fused_qkv_attention, fused_qkv_attention_plain
    from batrack_tpu_torch.utils.config import full_fp32

    d = HIDDEN // HEADS
    scale = d ** -0.5
    log(f"[K2] fused_qkv_attention: qkv ({S}, {NQ}, {3 * HIDDEN}), {HEADS} heads of d={d}")
    qkv32 = torch.randn((S, NQ, 3 * HIDDEN), generator=gen, device=dev)
    mask = torch.rand((NQ,), generator=gen, device=dev) > 0.2
    errs = {}
    with full_fp32():
        for dt in (torch.bfloat16, torch.float32):
            qkv = qkv32.to(dt)
            for m in (None, mask):
                out = fused_qkv_attention(qkv, HEADS, scale, m)
                torch.cuda.synchronize()
                assert out.shape == (S, NQ, HIDDEN) and out.dtype == dt
                ref = fused_qkv_attention_plain(qkv, HEADS, scale, m)
                err = max_err(out, ref)
                errs[(dt, m is None)] = err
                tol = bf16_tol(ref) if dt == torch.bfloat16 else TOL["k2_f32"]
                check(f"K2 vs plain, {str(dt)[6:]}, key mask {'no' if m is None else 'yes'}",
                      err, tol)
    qkv = qkv32.to(torch.bfloat16)  # the main path: bf16, no key mask (one window)
    ms = cuda_ms(lambda: fused_qkv_attention(qkv, HEADS, scale), reps=30)
    plain_ms = cuda_ms(lambda: fused_qkv_attention_plain(qkv, HEADS, scale), reps=3)
    q, k, v = (x.contiguous() for x in qkv.view(S, NQ, 3, HEADS, d).permute(2, 0, 3, 1, 4))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), reps=30)

    # bound: qkv read once and the output written once, against the QK^T and
    # PV products on the bf16 tensor cores and one exp per logit
    logits = S * HEADS * NQ * NQ
    flops = 4 * logits * d
    nbytes = qkv.numel() * 2 + S * NQ * HIDDEN * 2
    bound_ms, bound_by = bound(nbytes, [flops / BF16_FLOPS, logits / SFU_OPS_S])
    log(f"  kernel_ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms {library_ms:.4f}  "
        f"bound_ms {bound_ms:.4f} ({bound_by}: {flops / 1e9:.1f} GFLOP bf16, "
        f"{logits / 1e6:.0f} M exp, {nbytes / 1e6:.1f} MB)")
    return {"name": "fused_qkv_attention", "route": "cuda",
            "source": "batrack_tpu_torch/csrc/fused_qkv_attention.cu",
            "replaces": "batrack_tpu/ops/pallas_attention.py:22",
            "max_abs_err": errs[(torch.bfloat16, True)], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def attention_bound(n_logits, d, nbytes):
    """bound() of softmax attention: QK^T and PV on the bf16 tensor cores
    and one exponential per logit, against `nbytes` moved. Also returns a
    description of the work."""
    flops = 4 * n_logits * d
    what = f"{flops / 1e9:.1f} GFLOP bf16, {n_logits / 1e6:.0f} M exp, {nbytes / 1e6:.1f} MB"
    return bound(nbytes, [flops / BF16_FLOPS, n_logits / SFU_OPS_S]) + (what,)


# ---------------------------------------------------------------- K2 kv=
def phase_k2_kv(dev, gen):
    import torch.nn.functional as F

    from batrack_tpu_torch.ops.attention import fused_qkv_attention, fused_qkv_attention_plain
    from batrack_tpu_torch.utils.config import full_fp32

    d = HIDDEN // HEADS
    scale = d ** -0.5
    kv32 = torch.randn((S, NQ, 3 * HIDDEN), generator=gen, device=dev)
    mask = torch.rand((NQ,), generator=gen, device=dev) > 0.2
    readings = {}
    # one rank's queries: all NQ tracks at one rank (phase 6's shape), then
    # a quarter of them (one rank of a 4-way track shard)
    for nq in (NQ, NQ // SHARDS):
        log(f"[K2 kv=] fused_qkv_attention(kv=): queries ({S}, {nq}, {3 * HIDDEN}), keys "
            f"and values of all {NQ} tracks, slim ({S}, {NQ}, {2 * HIDDEN}) or packed "
            f"({S}, {NQ}, {3 * HIDDEN})")
        qkv32 = torch.randn((S, nq, 3 * HIDDEN), generator=gen, device=dev)
        errs = {}
        with full_fp32():
            for dt in (torch.bfloat16, torch.float32):
                for source in ("slim", "packed"):
                    qkv = qkv32.to(dt)
                    kv = kv32[..., HIDDEN:].contiguous() if source == "slim" else kv32
                    kv = kv.to(dt)
                    for m in (None, mask):
                        out = fused_qkv_attention(qkv, HEADS, scale, m, kv=kv)
                        torch.cuda.synchronize()
                        assert out.shape == (S, nq, HIDDEN) and out.dtype == dt
                        ref = fused_qkv_attention_plain(qkv, HEADS, scale, m, kv=kv)
                        err = max_err(out, ref)
                        errs[(dt, source, m is None)] = err
                        tol = bf16_tol(ref) if dt == torch.bfloat16 else TOL["k2_f32"]
                        check(f"K2 kv= vs plain, {str(dt)[6:]}, {source} source, key mask "
                              f"{'no' if m is None else 'yes'}", err, tol)
        # the multi-device path's call: bf16, slim gathered source, no key
        # mask (one window, 2400 tracks divide over the ranks)
        qkv = qkv32.to(torch.bfloat16)
        kv = kv32[..., HIDDEN:].to(torch.bfloat16).contiguous()
        ms = cuda_ms(lambda: fused_qkv_attention(qkv, HEADS, scale, kv=kv), reps=30)
        plain_ms = cuda_ms(lambda: fused_qkv_attention_plain(qkv, HEADS, scale, kv=kv), reps=3)
        q = qkv[..., :HIDDEN].reshape(S, nq, HEADS, d).transpose(1, 2).contiguous()
        k, v = (x.contiguous() for x in kv.view(S, NQ, 2, HEADS, d).permute(2, 0, 3, 1, 4))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                             reps=30)

        # bound: the q lanes and the slim source read once, the output
        # written once (the kernel never needs the k/v lanes of qkv)
        nbytes = (S * nq * HIDDEN + kv.numel() + S * nq * HIDDEN) * 2
        bound_ms, bound_by, what = attention_bound(S * HEADS * nq * NQ, d, nbytes)
        log(f"  kernel_ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms {library_ms:.4f}  "
            f"bound_ms {bound_ms:.4f} ({bound_by}: {what})")
        readings[nq] = {"max_abs_err": errs[(torch.bfloat16, "slim", True)], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms}
    # the kernels line reports the shape whose launches it counts (phase 6)
    return {"name": "fused_qkv_attention_kv", "route": "cuda",
            "source": "batrack_tpu_torch/csrc/fused_qkv_attention.cu",
            "replaces": "batrack_tpu/ops/pallas_attention.py:22", **readings[NQ]}


# ---------------------------------------------------------------- K3
def phase_k3(dev, gen):
    import torch.nn.functional as F

    from batrack_tpu_torch.ops.attention import vmem_attention, vmem_attention_plain
    from batrack_tpu_torch.utils.config import full_fp32

    d = HIDDEN // HEADS
    scale = d ** -0.5
    log(f"[K3] vmem_attention: q, k, v ({K3_B}, {NQ}, {d})")
    q32, k32, v32 = (torch.randn((K3_B, NQ, d), generator=gen, device=dev) for _ in range(3))
    errs = {}
    with full_fp32():
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (x.to(dt) for x in (q32, k32, v32))
            out = vmem_attention(q, k, v, scale)
            torch.cuda.synchronize()
            assert out.shape == q.shape and out.dtype == dt
            ref = vmem_attention_plain(q, k, v, scale)
            errs[dt] = max_err(out, ref)
            check(f"K3 vs plain, {str(dt)[6:]}", errs[dt],
                  bf16_tol(ref) if dt == torch.bfloat16 else TOL["k2_f32"])
    q, k, v = (x.to(torch.bfloat16) for x in (q32, k32, v32))
    ms = cuda_ms(lambda: vmem_attention(q, k, v, scale), reps=30)
    plain_ms = cuda_ms(lambda: vmem_attention_plain(q, k, v, scale), reps=3)
    # SDPA's fused kernels take (batch, heads, tokens, dim): one head here
    q4, k4, v4 = q[:, None], k[:, None], v[:, None]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale),
                         reps=30)
    nbytes = 4 * q.numel() * 2  # q, k, v read, the output written
    bound_ms, bound_by, what = attention_bound(K3_B * NQ * NQ, d, nbytes)
    log(f"  kernel_ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms {library_ms:.4f}  "
        f"bound_ms {bound_ms:.4f} ({bound_by}: {what})")
    return {"name": "vmem_attention", "route": "cuda",
            "source": "batrack_tpu_torch/csrc/fused_qkv_attention.cu",
            "replaces": "batrack_tpu/ops/pallas_attention.py:156",
            "max_abs_err": errs[torch.bfloat16], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


# ---------------------------------------------------------------- K4
def split_heads(qkv, heads):
    """q, k, v as (B, heads, N, d) views of the packed (B, N, 3C) qkv: what
    the tracker's split-head route hands K4."""
    B, N, C3 = qkv.shape
    return qkv.view(B, N, 3, heads, C3 // (3 * heads)).permute(2, 0, 3, 1, 4)


def phase_k4(dev, gen):
    import torch.nn.functional as F

    from batrack_tpu_torch.ops.attention import flash_attention, flash_attention_plain
    from batrack_tpu_torch.utils.config import full_fp32

    d = HIDDEN // HEADS
    scale = d ** -0.5
    log(f"[K4] flash_attention: q, k, v ({S}, {HEADS}, {NQ}, {d}), split from a packed qkv "
        "(read in place), and contiguous (one head per batch row)")
    qkv32 = torch.randn((S, NQ, 3 * HIDDEN), generator=gen, device=dev)
    mask = torch.rand((NQ,), generator=gen, device=dev) > 0.2
    errs = {}
    with full_fp32():
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = split_heads(qkv32.to(dt), HEADS)
            for m in (None, mask):
                out = flash_attention(q, k, v, scale, m)
                torch.cuda.synchronize()
                assert out.shape == (S, HEADS, NQ, d) and out.dtype == dt
                ref = flash_attention_plain(q, k, v, scale, m)
                errs[(dt, m is None)] = max_err(out, ref)
                check(f"K4 vs plain, {str(dt)[6:]}, key mask {'no' if m is None else 'yes'}",
                      errs[(dt, m is None)],
                      bf16_tol(ref) if dt == torch.bfloat16 else TOL["k2_f32"])
            # contiguous heads take the folded route: the same kernel on copies
            qc, kc, vc = (x.contiguous() for x in (q, k, v))
            strided = flash_attention.strided_launches
            out = flash_attention(qc, kc, vc, scale, mask)
            torch.cuda.synchronize()
            if flash_attention.strided_launches != strided:
                raise AssertionError("contiguous K4 input took the in-place route")
            ref = flash_attention_plain(qc, kc, vc, scale, mask)
            check(f"K4 vs plain, {str(dt)[6:]}, contiguous heads, key mask yes",
                  max_err(out, ref), bf16_tol(ref) if dt == torch.bfloat16 else TOL["k2_f32"])
    # the tracker's route: bf16, no key mask (one window), the split views
    q, k, v = split_heads(qkv32.to(torch.bfloat16), HEADS)
    strided = flash_attention.strided_launches
    ms = cuda_ms(lambda: flash_attention(q, k, v, scale), reps=30)
    if flash_attention.strided_launches - strided != 32:  # 30 reps + 2 warm-up calls
        raise AssertionError("K4 on the split views did not read them in place")
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    folded_ms = cuda_ms(lambda: flash_attention(qc, kc, vc, scale), reps=30)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, scale), reps=3)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), reps=30)
    nbytes = 4 * S * NQ * HIDDEN * 2  # q, k, v read, the output written
    bound_ms, bound_by, what = attention_bound(S * HEADS * NQ * NQ, d, nbytes)
    log(f"  kernel_ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms {library_ms:.4f}  "
        f"bound_ms {bound_ms:.4f} ({bound_by}: {what}); contiguous heads (one head per "
        f"batch row) {folded_ms:.4f}")
    return {"name": "flash_attention", "route": "cuda",
            "source": "batrack_tpu_torch/csrc/fused_qkv_attention.cu",
            "replaces": "batrack_tpu/tracker/blocks.py:148",
            "max_abs_err": errs[(torch.bfloat16, True)], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


# ---------------------------------------------------------------- tiling edges
def tile_mask(nk, dev, gen):
    """(nk,) bool: 70 % of the keys live at random, with keys 0-127 (the
    bf16 kernel's whole first key tile) and 256-383 (a whole later tile)
    masked; below 129 keys every key is masked (each query then averages
    all nk values, in the kernel as in the plain version)."""
    m = torch.rand((nk,), generator=gen, device=dev) > 0.3
    m[:128] = False
    m[256:384] = False
    return m


def phase_edges(dev, gen):
    """K2 packed, K2 kv=, K3 and K4 against their plain versions where the
    bf16 kernel's tiles are ragged or whole key tiles are masked, in bf16
    (two ulps) and float32 (TOL["k2_f32"]). Returns the largest bf16 error."""
    from batrack_tpu_torch.ops.attention import (flash_attention, flash_attention_plain,
                                                 fused_qkv_attention, fused_qkv_attention_plain,
                                                 vmem_attention, vmem_attention_plain)
    from batrack_tpu_torch.utils.config import full_fp32

    d = HIDDEN // HEADS
    scale = d ** -0.5
    log("[edges] K2, K3 and K4 at ragged 128-query/128-key tiles and masked whole key tiles")
    worst = 0.0
    # (source, queries, keys, heads): packed N=333 and 70, kv= 150 queries
    # against 333 keys and against 37 (fewer than one key tile)
    cases = [(None, 333, 333, 8), (None, 70, 70, 2), ("slim", 150, 333, 8),
             ("packed", 150, 333, 8), ("slim", 150, 37, 8), ("packed", 150, 37, 2)]
    with full_fp32():
        for source, n, nk, heads in cases:
            width = heads * d
            qkv32 = torch.randn((3, n, 3 * width), generator=gen, device=dev)
            kv32 = None if source is None else torch.randn(
                (3, nk, (2 if source == "slim" else 3) * width), generator=gen, device=dev)
            for dt in (torch.bfloat16, torch.float32):
                qkv = qkv32.to(dt)
                kv = None if kv32 is None else kv32.to(dt)
                for m in (None, tile_mask(nk, dev, gen)):
                    out = fused_qkv_attention(qkv, heads, scale, m, kv=kv)
                    torch.cuda.synchronize()
                    assert out.shape == (3, n, width) and out.dtype == dt
                    ref = fused_qkv_attention_plain(qkv, heads, scale, m, kv=kv)
                    err = max_err(out, ref)
                    bf16 = dt == torch.bfloat16
                    worst = max(worst, err) if bf16 else worst
                    check(f"K2 {source or 'packed qkv'} source, {n} queries x {nk} keys, "
                          f"{heads} heads, {str(dt)[6:]}, key mask "
                          f"{'no' if m is None else 'whole tiles'}",
                          err, bf16_tol(ref) if bf16 else TOL["k2_f32"])
                    if source is not None:
                        continue
                    # K4 on the same heads, split (the tracker's flash route)
                    q, k, v = split_heads(qkv, heads)
                    out = flash_attention(q, k, v, scale, m)
                    torch.cuda.synchronize()
                    ref = flash_attention_plain(q, k, v, scale, m)
                    err = max_err(out, ref)
                    worst = max(worst, err) if bf16 else worst
                    check(f"K4, ({q.shape[0]}, {heads}, {n}, {d}), {str(dt)[6:]}, key mask "
                          f"{'no' if m is None else 'whole tiles'}",
                          err, bf16_tol(ref) if bf16 else TOL["k2_f32"])
        for n in (37, 200):
            q32, k32, v32 = (torch.randn((4, n, d), generator=gen, device=dev) for _ in range(3))
            for dt in (torch.bfloat16, torch.float32):
                q, k, v = (x.to(dt) for x in (q32, k32, v32))
                out = vmem_attention(q, k, v, scale)
                torch.cuda.synchronize()
                ref = vmem_attention_plain(q, k, v, scale)
                err = max_err(out, ref)
                bf16 = dt == torch.bfloat16
                worst = max(worst, err) if bf16 else worst
                check(f"K3, N={n}, {str(dt)[6:]}", err,
                      bf16_tol(ref) if bf16 else TOL["k2_f32"])
    return worst


# ---------------------------------------------------------------- tracker
def tracker_input(images, depths, dev, gen):
    """A davis_demo append's tracker input: the first 12 frames, 400
    queries on each even frame, depth read at the query pixel."""
    from batrack_tpu_torch.slam.frontend import TrackerInput

    win = torch.from_numpy(np.concatenate(
        [images[:S].transpose(0, 3, 1, 2), depths[:S, None]], 1)).to(dev)
    sid = torch.arange(0, S, 2, device=dev).repeat_interleave(NQ // (S // 2))
    xy = torch.rand((NQ, 2), generator=gen, device=dev) * torch.tensor(
        [WD - 40.0, HT - 40.0], device=dev) + 20.0
    d = win[sid, 3, xy[:, 1].long(), xy[:, 0].long()]
    queries = torch.cat([sid[:, None].float(), xy, d[:, None]], -1)
    return TrackerInput(win, queries, torch.ones(NQ, dtype=torch.bool, device=dev), 0,
                        torch.arange(S, device=dev))


def damp_flow_heads(model):
    """Scale both flow heads by FLOW_HEAD_DAMPING. Random heads move a track
    by tens of pixels per refinement step, so each step's rounding moves
    where the next one samples; trained heads take small steps."""
    with torch.no_grad():
        for uf in (model.updateformer, model.updateformer_dyn):
            uf.flow_head.weight.mul_(FLOW_HEAD_DAMPING)
            uf.flow_head.bias.mul_(FLOW_HEAD_DAMPING)


def tracker_diffs(ad, tin, gen):
    """Largest |difference| in tracks (px), vis and dynamic of one forward:
    kernels against the plain versions, and the witness, plain versions
    against plain versions with jittered outputs."""
    from batrack_tpu_torch.utils.config import full_fp32

    with full_fp32():
        out, _ = ad.forward(tin.window_rgbd, tin.queries)
        with plain_kernels():
            ref, _ = ad.forward(tin.window_rgbd, tin.queries)
        with plain_kernels(jitter_gen=gen):
            jit, _ = ad.forward(tin.window_rgbd, tin.queries)
    torch.cuda.synchronize()
    assert out.tracks.shape == (S, NQ, 2) and bool(torch.isfinite(out.tracks).all())

    def diffs(a):
        return {k: max_err(getattr(a, k), getattr(ref, k)) for k in ("tracks", "vis", "dynamic")}
    return diffs(out), diffs(jit)


@contextlib.contextmanager
def attention_route(value):
    """BATRACK_TPU_ATTN set to `value` for the block (Attention reads it at
    each call), then restored."""
    saved = os.environ.get("BATRACK_TPU_ATTN")
    os.environ["BATRACK_TPU_ATTN"] = value
    try:
        yield
    finally:
        if saved is None:
            del os.environ["BATRACK_TPU_ATTN"]
        else:
            os.environ["BATRACK_TPU_ATTN"] = saved


def flash_route_check(ad, tin):
    """One forward of `tin` under BATRACK_TPU_ATTN=flash (space attention
    split into heads, K4) against the fused route's forward (K2), at phase
    3's bf16 limits. K4 must launch as often as K2 does on the fused
    forward, each time on the split views in place, and K2 not at all.
    Returns K4's launches."""
    from batrack_tpu_torch.ops.attention import flash_attention, fused_qkv_attention
    from batrack_tpu_torch.utils.config import full_fp32

    with full_fp32():
        fused_qkv_attention.launches = 0
        ref, _ = ad.forward(tin.window_rgbd, tin.queries)
        torch.cuda.synchronize()
        fused = fused_qkv_attention.launches
        fused_qkv_attention.launches = flash_attention.launches = 0
        flash_attention.strided_launches = 0
        with attention_route("flash"):
            out, _ = ad.forward(tin.window_rgbd, tin.queries)
        torch.cuda.synchronize()
    launches = {"flash_attention": flash_attention.launches,
                "flash_attention_strided": flash_attention.strided_launches,
                "fused_qkv_attention": fused_qkv_attention.launches}
    diff = {k: max_err(getattr(out, k), getattr(ref, k)) for k in ("tracks", "vis", "dynamic")}
    log(f"  bfloat16, BATRACK_TPU_ATTN=flash vs fused route {json.dumps(diff)}; launches "
        f"{launches}, K2 on the fused forward {fused}")
    for k, v in diff.items():
        check(f"{k}, flash route vs fused route", v, TOL["tracker_bf16"][k])
    if not (fused and launches["flash_attention"] == fused
            and launches["flash_attention_strided"] == fused
            and launches["fused_qkv_attention"] == 0):
        raise AssertionError(f"the flash route must launch K4 where the fused one launches K2 "
                             f"({fused} times), each on the split views in place, and K2 "
                             f"never: {launches}")
    return launches["flash_attention"]


def phase_tracker(cfg, images, depths, dev, gen):
    """Returns phase 3's input and K4's launches on the flash-route forward."""
    from batrack_tpu_torch.tracker import MDTrackerAdapter

    log("[tracker] full-width MDTracker forwards, kernels vs plain versions (TF32 off)")
    tin = tracker_input(images, depths, dev, gen)
    for dtype, damped in (("float32", False), ("float32", True), ("bfloat16", True)):
        ad = MDTrackerAdapter(dataclasses.replace(cfg.model, compute_dtype=dtype),
                              seed=0, device=dev)
        if damped:
            damp_flow_heads(ad.model)
        kern, wit = tracker_diffs(ad, tin, gen)
        log(f"  {dtype}, flow heads {'x%g' % FLOW_HEAD_DAMPING if damped else 'random'}: "
            f"kernels vs plain {json.dumps(kern)}; witness, plain vs jittered plain "
            f"{json.dumps(wit)}")
        # random heads: printed only, the witness that kernels and jittered
        # plain versions drift apart alike there (PERF.md)
        if damped:
            tol = TOL["tracker_f32" if dtype == "float32" else "tracker_bf16"]
            for k, v in kern.items():
                check(f"{k}, {dtype}, kernels vs plain", v, tol[k])
        if dtype == "bfloat16":
            flash_launches = flash_route_check(ad, tin)
        del ad
    return tin, flash_launches


def mesh_tracker_check(cfg, tin, mesh, gen):
    """One full-width forward of `tin` (cfg.model's dtype, flow heads
    damped) under the mesh, on every rank; rank 0 holds it against the
    single-device forward on its own card at phase 3's bf16 limits, beside
    phase 3's witness. Returns the differences on rank 0, None elsewhere."""
    from batrack_tpu_torch.tracker import MDTrackerAdapter
    from batrack_tpu_torch.utils.config import full_fp32

    ad = MDTrackerAdapter(cfg.model, seed=0, device=mesh.device, mesh=mesh)
    damp_flow_heads(ad.model)
    with full_fp32():
        out, _ = ad.forward(tin.window_rgbd, tin.queries)
    del ad
    if mesh.rank != 0:
        return None
    single = MDTrackerAdapter(cfg.model, seed=0, device=mesh.device)
    damp_flow_heads(single.model)
    with full_fp32():
        ref, _ = single.forward(tin.window_rgbd, tin.queries)
    diff = {k: max_err(getattr(out, k), getattr(ref, k)) for k in ("tracks", "vis", "dynamic")}
    _, wit = tracker_diffs(single, tin, gen)
    log(f"  tracker forward, mesh of {mesh.size} vs one device {json.dumps(diff)}; witness, "
        f"plain vs jittered plain on one device {json.dumps(wit)}")
    for k, v in diff.items():
        check(f"{k}, mesh of {mesh.size} vs one device", v, TOL["tracker_bf16"][k])
    return diff


# ---------------------------------------------------------------- main path
def profile_device(label, fn):
    """Device time by kernel over one call of `fn` from torch.profiler, and
    the device's busy share of the wall time; returns the kernels' events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"[profile] {label}: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f} %), {sum(e.count for e in kernels)} "
        "kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d} x  {e.key[:110]}")
    return kernels


def profile_frames(slam, images, depths, frames):
    """profile_device over `frames` (one append and its updates)."""
    def run():
        for t in frames:
            slam(t, images[t], depths[t], INTR)

    profile_device(f"frames {frames[0]}-{frames[-1]}", run)


OFF_PATH = ("vmem_attention", "flash_attention", "corr_sample_mxu", "corr_sample_int8")


def zero_off_path():
    """Set the counters of the kernels no main path runs to 0: K3, K4 and
    K1's mxu and int8 variants."""
    from batrack_tpu_torch.ops.attention import flash_attention, vmem_attention
    from batrack_tpu_torch.ops.corr_kernel import corr_sample

    vmem_attention.launches = flash_attention.launches = 0
    corr_sample.mxu_launches = corr_sample.int8_launches = 0


def off_path_launches():
    """The counters zero_off_path set; each must still read 0."""
    from batrack_tpu_torch.ops.attention import flash_attention, vmem_attention
    from batrack_tpu_torch.ops.corr_kernel import corr_sample

    launches = dict(zip(OFF_PATH, (vmem_attention.launches, flash_attention.launches,
                                   corr_sample.mxu_launches, corr_sample.int8_launches)))
    if any(launches.values()):
        raise AssertionError(f"K3, K4 or a K1 option launched on a main path: {launches}")
    return launches


def phase_slam(cfg, images, depths, dev, profile=False):
    from batrack_tpu_torch.ops.attention import fused_qkv_attention
    from batrack_tpu_torch.ops.corr_kernel import corr_sample
    from batrack_tpu_torch.slam import BATrack
    from batrack_tpu_torch.tracker import MDTrackerAdapter
    from batrack_tpu_torch.utils.flops import tracker_forward_flops_from_params
    from batrack_tpu_torch.utils.profiling import StageTimer

    s = cfg.slam
    log(f"[slam] BATrack + MDTrackerAdapter, davis_demo: {HT}x{WD}, "
        f"M={s.PATCHES_PER_FRAME}, BUFFER_SIZE={s.BUFFER_SIZE}, S_slam={s.S_slam}, "
        f"kf_stride={s.kf_stride}, {cfg.model.compute_dtype}, {FRAMES} frames")
    slam = BATrack(cfg, HT, WD, seed=0, device=dev)
    slam.tracker = MDTrackerAdapter(
        cfg.model, seed=0, device=dev,
        backward_tracking=s.backward_tracking and s.S_slam > cfg.model.S)
    torch.cuda.reset_peak_memory_stats()

    corr_sample.launches = 0
    fused_qkv_attention.launches = 0
    zero_off_path()
    t0 = time.perf_counter()
    for t in range(STAGE_FROM):
        if t == STEADY_FROM:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        slam(t, images[t], depths[t], INTR)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    poses_at_stage = slam.state.poses[: slam.n].clone()  # phase 6 runs these frames
    slam.timer = StageTimer(enabled=True, sync=True)
    for t in range(STAGE_FROM, FRAMES):
        slam(t, images[t], depths[t], INTR)
    torch.cuda.synchronize()
    launches = {"corr_sample": corr_sample.launches,
                "fused_qkv_attention": fused_qkv_attention.launches, **off_path_launches()}
    appends = slam.append_count
    stage_ms = {k: round(v, 3) for k, v in slam.timer.ms_per_call().items()}
    n_frames = FRAMES
    if profile:
        slam.timer = StageTimer(enabled=False)
        profile_frames(slam, images, depths, [FRAMES, FRAMES + 1])
        n_frames += 2

    poses, tstamps = slam.terminate()
    res = slam.get_results()
    fps = (STAGE_FROM - STEADY_FROM) / (t_end - t_steady)
    log(f"  launches {launches} over {appends} appends")
    log(f"  frames/s {fps:.3f} (frames {STEADY_FROM}-{STAGE_FROM - 1}, after "
        f"{STEADY_FROM} warm-up frames incl. init; whole run {t_end - t0:.1f} s)")
    log(f"  stage ms per call (synchronised, frames {STAGE_FROM}-{FRAMES - 1}): "
        f"{json.dumps(stage_ms)}")
    flops = tracker_forward_flops_from_params(slam.tracker.model, NQ, *cfg.model.interp_shape,
                                              new_frames=s.kf_stride)["total"]
    log(f"  tracker forward: {flops / 1e12:.3f} TFLOP (utils/flops.py, {NQ} tracks, "
        f"{cfg.model.interp_shape[0]}x{cfg.model.interp_shape[1]}, {s.kf_stride} new frames "
        f"encoded), {flops / 1e9 / stage_ms['tracker']:.2f} TFLOP/s at the synchronised "
        f"{stage_ms['tracker']:.3f} ms per append")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    log(f"  edges with weight > 0: {int((slam.state.e_weight[:, 0] > 0).sum())} (random "
        "weights put no track over the visibility gate; [ba] runs live edges)")
    if not (launches["corr_sample"] and launches["fused_qkv_attention"]):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if (launches["fused_qkv_attention"] != SPACE_LAUNCHES * appends
            or launches["corr_sample"] != CORR_LAUNCHES * appends):
        raise AssertionError(f"K2 and K1 launched {launches} over {appends} appends, not "
                             f"{SPACE_LAUNCHES} and {CORR_LAUNCHES} per append")
    if poses.shape != (n_frames, 7) or not np.isfinite(poses).all():
        raise AssertionError(f"trajectory {poses.shape} not finite")
    if not np.allclose(np.linalg.norm(poses[:, 3:], axis=1), 1.0, atol=1e-4):
        raise AssertionError("trajectory quaternions are not unit")
    if (not np.array_equal(tstamps, np.arange(n_frames))
            or res["cams_T_world"].shape != (n_frames, 4, 4)):
        raise AssertionError("results do not cover every frame")
    return launches, fps, poses_at_stage


# ---------------------------------------------------------------- backend
def on_device(state, dev):
    """A copy of a SLAMState on `dev`."""
    from batrack_tpu_torch.slam.state import SLAMState

    return SLAMState(**{f.name: getattr(state, f.name).to(dev, copy=True)
                        for f in dataclasses.fields(state)})


def cpu_updates(before, n, dims, slam_cfg):
    """One backend update on the CPU of `before` and of a copy whose edge
    targets are jittered by one float32 rounding, the witness of the
    system's conditioning: (updated, jittered updated, s per update)."""
    from batrack_tpu_torch.slam.update import slam_update
    from batrack_tpu_torch.utils.config import full_fp32

    cpu, jit = on_device(before, "cpu"), on_device(before, "cpu")
    u = torch.rand(jit.e_target.shape, generator=torch.Generator().manual_seed(1)) * 2 - 1
    jit.e_target.mul_(1 + torch.finfo(torch.float32).eps * u)
    t0 = time.perf_counter()
    with full_fp32():
        for state in (cpu, jit):
            slam_update(state, n, True, dims, slam_cfg)
    return cpu, jit, (time.perf_counter() - t0) / 2


def update_diffs(a, ref, n, M):
    """Largest |difference| of poses and patches, and edge-weight flips."""
    return {"poses": max_err(a.poses[:n].cpu(), ref.poses[:n]),
            "patches": max_err(a.patches[: n * M].cpu(), ref.patches[: n * M]),
            "weight_flips": int(((a.e_weight[:, 0].cpu() > 0) != (ref.e_weight[:, 0] > 0)).sum())}


def check_update(what, got, wit):
    """Poses and patches within 10x the witness, and at least TOL's floor."""
    for k in ("poses", "patches"):
        check(f"{what}, {k}", got[k], max(TOL["ba_floor"], TOL["ba_witness_factor"] * wit[k]))


def phase_ba(cfg, images, depths, dev):
    from batrack_tpu_torch.slam import BATrack
    from batrack_tpu_torch.tracker import MDTrackerAdapter
    from batrack_tpu_torch.utils.profiling import StageTimer

    cfg = copy.deepcopy(cfg)
    cfg.slam.VIS_THRESHOLD = 0.0
    log(f"[ba] davis_demo with VIS_THRESHOLD=0 and flow heads x{FLOW_HEAD_DAMPING}, "
        f"{BA_FRAMES} frames; then one backend update on the card and on the CPU")
    slam = BATrack(cfg, HT, WD, seed=0, device=dev)
    slam.tracker = MDTrackerAdapter(cfg.model, seed=0, device=dev)
    damp_flow_heads(slam.tracker.model)
    steady_from = cfg.slam.num_init + 1  # after the init frame's 12 updates
    for t in range(BA_FRAMES):
        if t == steady_from:
            slam.timer = StageTimer(enabled=True, sync=True)
        slam(t, images[t], depths[t], INTR)
    torch.cuda.synchronize()
    st, n, M = slam.state, slam.n, slam.dims.M
    live = int((st.e_weight[:, 0] > 0).sum())
    live_pose = int((st.e_weight_pose[:, 0] > 0).sum())
    stage_ms = {k: round(v, 3) for k, v in slam.timer.ms_per_call().items()}
    log(f"  edges with weight > 0: {live} (pose weight > 0: {live_pose})")
    log(f"  stage ms per call (synchronised, frames {steady_from}-{BA_FRAMES - 1}): "
        f"{json.dumps(stage_ms)}")
    if live == 0:
        raise AssertionError("no edge passed the gate at VIS_THRESHOLD=0")
    if not bool(torch.isfinite(st.poses[:n]).all()):
        raise AssertionError("poses not finite")

    before = on_device(st, "cpu")
    slam.update()
    cpu, jit, cpu_s = cpu_updates(before, n, slam.dims, cfg.slam)
    got, wit = update_diffs(st, cpu, n, M), update_diffs(jit, cpu, n, M)
    log(f"  one update, card vs CPU {json.dumps(got)}; witness, CPU vs CPU with e_target "
        f"jittered by one float32 rounding {json.dumps(wit)} (CPU update {cpu_s:.1f} s)")
    check_update("backend update, card vs CPU", got, wit)
    return {"before": before, "cpu": cpu, "witness": wit, "n": n, "dims": slam.dims,
            "cfg": cfg}


# ---------------------------------------------------------------- mesh
def phase_mesh(cfg, images, depths, dev, main_fps, main_poses, ba, tin, gen):
    """The multi-device path at one rank: BATrack and MDTrackerAdapter with
    mesh=get_mesh(1) over phase 4's frames; then one tracker forward of
    phase 3's input under the mesh against the single-device forward, and
    the patch-sharded backend update on phase 5's state against its CPU
    update."""
    import torch.distributed as dist

    from batrack_tpu_torch.ops.attention import fused_qkv_attention
    from batrack_tpu_torch.ops.corr_kernel import corr_sample
    from batrack_tpu_torch.parallel import get_mesh, sharded_slot_slam_update
    from batrack_tpu_torch.slam import BATrack
    from batrack_tpu_torch.tracker import MDTrackerAdapter
    from batrack_tpu_torch.utils.config import full_fp32
    from batrack_tpu_torch.utils.profiling import StageTimer

    s = cfg.slam
    mesh = get_mesh(1, device=dev)  # a one-rank NCCL group, made in this process
    try:
        log(f"[mesh] BATrack + MDTrackerAdapter with mesh=get_mesh(1) ({dist.get_backend()}, "
            f"{mesh.size} rank on {mesh.device}), davis_demo, {FRAMES} frames")
        slam = BATrack(cfg, HT, WD, seed=0, device=dev, mesh=mesh)
        slam.tracker = MDTrackerAdapter(
            cfg.model, seed=0, device=dev, mesh=mesh,
            backward_tracking=s.backward_tracking and s.S_slam > cfg.model.S)
        corr_sample.launches = 0
        fused_qkv_attention.launches = 0
        fused_qkv_attention.kv_launches = 0
        zero_off_path()
        for t in range(STAGE_FROM):
            if t == STEADY_FROM:
                torch.cuda.synchronize()
                t_steady = time.perf_counter()
            slam(t, images[t], depths[t], INTR)
        torch.cuda.synchronize()
        fps = (STAGE_FROM - STEADY_FROM) / (time.perf_counter() - t_steady)
        traj_err = max_err(slam.state.poses[: slam.n], main_poses)
        slam.timer = StageTimer(enabled=True, sync=True)
        for t in range(STAGE_FROM, FRAMES):
            slam(t, images[t], depths[t], INTR)
        torch.cuda.synchronize()
        launches = {"corr_sample": corr_sample.launches,
                    "fused_qkv_attention": fused_qkv_attention.launches,
                    "fused_qkv_attention_kv": fused_qkv_attention.kv_launches,
                    **off_path_launches()}
        appends = slam.append_count
        stage_ms = {k: round(v, 3) for k, v in slam.timer.ms_per_call().items()}
        log(f"  launches {launches} over {appends} appends")
        log(f"  frames/s {fps:.3f} (frames {STEADY_FROM}-{STAGE_FROM - 1}); phase 4, same "
            f"frames, no mesh: {main_fps:.3f}")
        log(f"  stage ms per call (synchronised, frames {STAGE_FROM}-{FRAMES - 1}): "
            f"{json.dumps(stage_ms)}")
        if not (launches["corr_sample"] == CORR_LAUNCHES * appends
                and launches["fused_qkv_attention_kv"] == SPACE_LAUNCHES * appends
                and launches["fused_qkv_attention_kv"] == launches["fused_qkv_attention"]):
            raise AssertionError(f"under a mesh every append must run K1 {CORR_LAUNCHES} times, "
                                 f"and K2 with a kv= source {SPACE_LAUNCHES} times and only so: "
                                 f"{launches}")
        # zero edge weights, as in phase 4: the poses are the motion model's,
        # so this holds the mesh path's ring and BA plumbing, not the tracker
        wit = ba["witness"]["poses"]
        tol = max(TOL["ba_floor"], TOL["ba_witness_factor"] * wit)
        check(f"trajectory of {STAGE_FROM} frames, mesh vs phase 4 (limit 10x phase 5's "
              f"witness {wit:.3e})", traj_err, tol)

        # the tracker under the mesh (sharded K1, K2 kv=, gathered output)
        mesh_tracker_check(cfg, tin, mesh, gen)

        # patch-sharded backend update on phase 5's live edges against its CPU update
        n, M = ba["n"], ba["dims"].M
        state = on_device(ba["before"], dev)
        with full_fp32():
            sharded_slot_slam_update(state, n, True, ba["dims"], ba["cfg"].slam, mesh)
        torch.cuda.synchronize()
        got = update_diffs(state, ba["cpu"], n, M)
        log(f"  patch-sharded update on phase 5's state, card vs CPU {json.dumps(got)}")
        check_update("patch-sharded backend update, card vs CPU", got, ba["witness"])
    finally:
        dist.destroy_process_group()
    return launches


# ---------------------------------------------------------------- keyframe / multi-window
# phase 9: davis_demo with keyframe removal (so the flat BA) and S_slam 24,
# twice the model's window: three sliding windows with key masks and the
# backward pass. KEYFRAME_INDEX is 5, not the shipped 4: removal candidates
# are met only on append frames, and with kf_stride 2 only an index that is
# 1 mod 2 can ever fire (slam/system.py warns about the shipped 4). num_init
# is S_slam - 1, not 12: in both packages, and with either BA backend, a BA
# that runs while the append window reaches past the ingested frames turns
# every pose NaN (edges from frames not yet seen carry zero intrinsics, and
# their zero weights times NaN Jacobians poison the pose blocks; ROADMAP C).
KF_S_SLAM, KF_INDEX = 24, 5
# OPTIMIZATION_WINDOW is num_init + 1, not davis_demo's 15: the init
# updates run with t0 = n - OPTIMIZATION_WINDOW (in both packages), so with
# 15 the frames 1-8 of a 24-frame init are never optimised and keep their
# pre-init poses (PERF.md §6)
KF_OPT_WINDOW = KF_S_SLAM
# the oracle run is cut to 32 frames (9 after the init at frame 23) to keep
# phase 9 near 90 s; its checkpoint is taken after the init and the first
# removals
KF_FRAMES, ORACLE_FRAMES = FRAMES, 32
KF_CHECKPOINT_AT = 28
# tests/test_slam_e2e.py::test_pose_recovery's 0.05, held on the trajectory
# after Sim(3) alignment. Unaligned, the oracle run reads just above it (an
# H100 read 0.0503): the trajectory's shape is recovered to 1e-5, its scale
# to about 0.95 of the scene's (PERF.md §6-7), so the raw ATE is held to
# twice the bar
ATE_SIM3_BAR, ATE_BAR = 0.05, 0.1


def keyframe_config():
    from batrack_tpu_torch.utils.config import Config

    cfg = Config()
    cfg.slam.use_keyframe = True
    cfg.slam.KEYFRAME_INDEX = KF_INDEX
    cfg.slam.S_slam = KF_S_SLAM
    cfg.slam.num_init = KF_S_SLAM - 1
    cfg.slam.OPTIMIZATION_WINDOW = KF_OPT_WINDOW
    return cfg


def counter_draws(slam_cfg, dims, dev, seed=0):
    """A BATrack draw hook: frame `counter`'s patch draws from a generator
    seeded by (seed, counter), so that a run resumed from a checkpoint
    draws what the uninterrupted run drew."""
    from batrack_tpu_torch.slam.ingest import make_draws

    def hook(counter):
        g = torch.Generator(device=dev)
        g.manual_seed(seed * 1_000_003 + counter)
        return make_draws(slam_cfg.PATCH_GEN, dims.M, dims.ht, dims.wd, g)
    return hook


def launches_per_append(cfg):
    """(windows, K1, K2) launches per tracker append, from the code: each
    sliding window runs I refinement iterations, each with one K1 launch
    and one K2 launch per space block; the backward pass repeats the
    windows. The static branch is skipped (no static merge)."""
    m, s = cfg.model, cfg.slam
    n_wind = max(1, math.ceil((s.S_slam - m.S // 2) / (m.S // 2)))
    passes = 2 if (s.backward_tracking and s.S_slam > m.S) else 1
    return n_wind, passes * n_wind * m.I, passes * n_wind * m.I * m.space_depth


def ate(poses_tum, poses_gt_w2c):
    """(RMS camera-centre error as tests/test_slam_e2e.py::ate_rmse takes it,
    without alignment; the same after Sim(3) alignment, the evaluation
    protocol's (utils/evaluation.py::umeyama_alignment); the alignment's
    scale; the aligned error of each frame)."""
    from batrack_tpu_torch.geometry import se3
    from batrack_tpu_torch.utils.evaluation import umeyama_alignment

    gt = se3.inv(torch.from_numpy(poses_gt_w2c)).numpy()[:, :3].astype(np.float64)
    est = poses_tum[:, :3].astype(np.float64)
    R, t, scale = umeyama_alignment(est, gt)
    aligned = np.linalg.norm(scale * est @ R.T + t - gt, axis=1)
    raw = np.linalg.norm(est - gt, axis=1)
    return (float(np.sqrt(np.mean(raw ** 2))), float(np.sqrt(np.mean(aligned ** 2))), scale,
            aligned)


def kf_masked_k2(masks, dev, gen):
    """K2 with the key mask of the keyframe path's first window (the
    fewest active keys) at that path's shape, against its plain version,
    beside scaled_dot_product_attention with the same boolean mask and
    the bound of the logits the mask leaves."""
    import torch.nn.functional as F

    from batrack_tpu_torch.ops.attention import fused_qkv_attention, fused_qkv_attention_plain

    shape, mask = min(masks, key=lambda sm: int(sm[1].sum()))
    B, N, C3 = shape
    d = HIDDEN // HEADS
    scale = d ** -0.5
    n_keys = int(mask.sum())
    qkv = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    out = fused_qkv_attention(qkv, HEADS, scale, mask)
    ref = fused_qkv_attention_plain(qkv, HEADS, scale, mask)
    err = max_err(out, ref)
    check(f"K2 masked at the keyframe path's shape ({B}, {N}, {C3}), {n_keys} of {N} keys, "
          "bf16 vs plain", err, bf16_tol(ref))
    ms = cuda_ms(lambda: fused_qkv_attention(qkv, HEADS, scale, mask), reps=30)
    plain_ms = cuda_ms(lambda: fused_qkv_attention_plain(qkv, HEADS, scale, mask), reps=3)
    q, k, v = (x.contiguous() for x in qkv.view(B, N, 3, HEADS, d).permute(2, 0, 3, 1, 4))
    attn_mask = mask[None, None, None, :]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                                                scale=scale), reps=30)
    nbytes = qkv.numel() * 2 + B * N * HIDDEN * 2 + mask.numel()
    bound_ms, bound_by, what = attention_bound(B * HEADS * N * n_keys, d, nbytes)
    log(f"  kernel_ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms (SDPA, same mask) "
        f"{library_ms:.4f}  bound_ms {bound_ms:.4f} ({bound_by}: {what})")
    return {"shape": list(shape), "active_keys": n_keys, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def check_path_kernels(ad, tin):
    """One tracker forward of `tin` (after the main path's counters are
    read) with every K1 launch held against its plain version on the same
    inputs, and K2 on the first launch of each window's key mask, forward
    and backward. Returns K2's (shape, mask) pairs, K1's first inputs and
    the checks."""
    from batrack_tpu_torch.ops.attention import fused_qkv_attention_plain
    from batrack_tpu_torch.ops.corr_kernel import corr_sample_plain
    from batrack_tpu_torch.tracker import blocks, mdtracker
    from batrack_tpu_torch.utils.config import full_fp32

    masks, k1_inputs, checks = [], [], {"k1": [], "k2": []}
    sample, attend = mdtracker.corr_sample, blocks.fused_qkv_attention

    def sampling(pyr, targets, coords, radius):
        out = sample(pyr, targets, coords, radius)
        with full_fp32():
            checks["k1"].append(max_err(out, corr_sample_plain(pyr, targets, coords, radius)))
        if not k1_inputs:
            k1_inputs.extend((pyr, targets, coords, radius))
        return out

    def attending(qkv, heads, scale, key_mask=None, kv=None):
        out = attend(qkv, heads, scale, key_mask, kv)
        if key_mask is not None and not (masks and torch.equal(masks[-1][1], key_mask)):
            masks.append((tuple(qkv.shape), key_mask.clone()))
            ref = fused_qkv_attention_plain(qkv, heads, scale, key_mask, kv)
            checks["k2"].append((max_err(out, ref), bf16_tol(ref)))
        return out

    with patched(mdtracker, "corr_sample", sampling), \
            patched(blocks, "fused_qkv_attention", attending):
        ad(tin)
    torch.cuda.synchronize()
    return masks, k1_inputs, checks


def kf_path_k1(inputs, checks):
    """K1's checks on the keyframe path's own inputs (every launch of one
    append), and its first launch timed beside its plain version and its
    bound at that path's shape."""
    from batrack_tpu_torch.ops.corr_kernel import corr_sample, corr_sample_plain
    from batrack_tpu_torch.utils.config import full_fp32

    pyr, targets, coords, radius = inputs
    err = max(checks)
    check(f"K1 on the keyframe path's inputs, {len(checks)} launches of one append at "
          f"targets {tuple(targets.shape)}, coords {tuple(coords.shape)}, vs plain", err, TOL["k1"])
    with full_fp32():
        ms = cuda_ms(lambda: corr_sample(pyr, targets, coords, radius), reps=30)
        plain_ms = cuda_ms(lambda: corr_sample_plain(pyr, targets, coords, radius), reps=3)
    taps = k1_taps(pyr.shapes, coords, radius)
    bound_ms, bound_by, nbytes = k1_bound(pyr, targets, coords, radius, taps)
    log(f"  kernel_ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms null  bound_ms "
        f"{bound_ms:.4f} ({bound_by}: {nbytes / 1e6:.1f} MB, {2 * pyr.C * taps / 1e9:.2f} "
        "GFLOP f32)")
    return {"shape": list(targets.shape), "launches_checked": len(checks), "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def phase_keyframe(images, depths, poses_gt, dev, gen):
    """Phase 9: a. the keyframe / multi-window path with the MDTracker; b.
    the same config with the oracle tracker (live edges, no kernel), the
    flat BA's trajectory against the scene's and one flat update on the card
    against the CPU; c. a checkpoint half-way through b, resumed on the
    card; d. the edge-sharded flat update on a one-rank group."""
    import torch.distributed as dist

    from batrack_tpu_torch.ops.attention import fused_qkv_attention
    from batrack_tpu_torch.parallel import get_mesh, sharded_slam_update
    from batrack_tpu_torch.slam import BATrack, OracleTracker
    from batrack_tpu_torch.slam.frontend import build_tracker_input
    from batrack_tpu_torch.tracker import MDTrackerAdapter
    from batrack_tpu_torch.utils.config import full_fp32
    from batrack_tpu_torch.utils.profiling import StageTimer

    t_phase = time.perf_counter()
    # ---- a. MDTracker, keyframe removal, three windows, backward pass
    cfg = keyframe_config()
    s = cfg.slam
    n_wind, k1_per, k2_per = launches_per_append(cfg)
    log(f"[keyframe] BATrack + MDTrackerAdapter, davis_demo with use_keyframe "
        f"(KEYFRAME_INDEX={KF_INDEX}), S_slam={s.S_slam} (model S={cfg.model.S}: {n_wind} "
        f"windows with key masks, backward tracking), num_init={s.num_init}, {HT}x{WD}, "
        f"{cfg.model.compute_dtype}, {KF_FRAMES} frames")
    slam = BATrack(cfg, HT, WD, seed=0, device=dev)
    slam.tracker = MDTrackerAdapter(
        cfg.model, seed=0, device=dev,
        backward_tracking=s.backward_tracking and s.S_slam > cfg.model.S)
    if cfg.slam.BA_BACKEND != "flat" or not slam.tracker.backward_tracking:
        raise AssertionError("the keyframe config must run the flat BA and backward tracking")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_all_launches()
    t0 = time.perf_counter()
    for t in range(STAGE_FROM):
        if t == STEADY_FROM:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        slam(t, images[t], depths[t], INTR)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    slam.timer = StageTimer(enabled=True, sync=True)
    for t in range(STAGE_FROM, KF_FRAMES):
        slam(t, images[t], depths[t], INTR)
    torch.cuda.synchronize()
    launches = {**all_launches(), "fused_qkv_attention_masked": fused_qkv_attention.masked_launches}
    off_path_launches()
    appends = slam.append_count
    fps = (STAGE_FROM - STEADY_FROM) / (t_end - t_steady)
    stage_ms = {k: round(v, 3) for k, v in slam.timer.ms_per_call().items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    poses, tstamps = slam.terminate()
    log(f"  launches {launches} over {appends} appends; per append K1 {k1_per} and K2 "
        f"{k2_per}, all masked ({n_wind} windows x I={cfg.model.I} x "
        f"{cfg.model.space_depth} space blocks, forward and backward)")
    log(f"  frames/s {fps:.3f} (frames {STEADY_FROM}-{STAGE_FROM - 1}, which hold the init "
        f"frame {s.num_init} and its 12 updates; whole run {t_end - t0:.1f} s)")
    log(f"  stage ms per call (synchronised, frames {STAGE_FROM}-{KF_FRAMES - 1}): "
        f"{json.dumps(stage_ms)}")
    log(f"  keyframe removals {len(slam.delta)} (n {slam.n} of {slam.counter} frames); peak "
        f"device memory {peak:.2f} GiB")
    if (launches["corr_sample"] != k1_per * appends
            or launches["fused_qkv_attention"] != k2_per * appends
            or launches["fused_qkv_attention_masked"] != launches["fused_qkv_attention"]):
        raise AssertionError(f"K1 and K2 launched {launches} over {appends} appends, not "
                             f"{k1_per} and {k2_per} (all masked) per append")
    if not slam.delta:
        raise AssertionError("no keyframe was removed")
    if poses.shape != (KF_FRAMES, 7) or not np.isfinite(poses).all():
        raise AssertionError(f"trajectory {poses.shape} not finite")
    log("  kernels on the path's own inputs: one more append's forward, K1 held against its "
        "plain version at every launch, K2 at the first launch of each window's key mask")
    masks, k1_inputs, path_checks = check_path_kernels(
        slam.tracker, build_tracker_input(slam.state, slam.n, slam.dims))
    k1_path = kf_path_k1(k1_inputs, path_checks["k1"])
    del k1_inputs
    for i, ((shape, mask), (err, tol)) in enumerate(zip(masks, path_checks["k2"])):
        check(f"K2 masked on the keyframe path's inputs, mask {i} ({int(mask.sum())} of "
              f"{mask.numel()} keys), qkv {shape}, vs plain", err, tol)
    masked = kf_masked_k2(masks, dev, gen)
    masked["path_max_abs_err"] = max(e for e, _ in path_checks["k2"])
    masked["path_masks_checked"] = len(path_checks["k2"])
    result = {"frames_per_s": fps, "stage_ms": stage_ms, "appends": appends,
              "launches": launches, "removals": len(slam.delta), "peak_gib": peak,
              "k1_path": k1_path, "k2_masked": masked}
    del slam
    torch.cuda.empty_cache()

    # ---- b. the oracle tracker: live edges, the flat BA's trajectory
    def oracle_slam():
        ocfg = keyframe_config()
        o = BATrack(ocfg, HT, WD, seed=0, device=dev)
        o.tracker = OracleTracker(poses_gt, INTR, o.dims, device=dev)
        o.draw_hook = counter_draws(ocfg.slam, o.dims, dev)
        return o, ocfg

    log(f"[keyframe] the same config with the port's OracleTracker (noise 0) for "
        f"{ORACLE_FRAMES} frames: no kernel runs here; then a checkpoint at frame "
        f"{KF_CHECKPOINT_AT} resumed on the card, and one flat update card vs CPU")
    slam, ocfg = oracle_slam()
    zero_all_launches()
    slam.timer = StageTimer(enabled=True, sync=True)
    tmp = tempfile.mkdtemp(prefix="batrack_ckpt_")
    ckpt = os.path.join(tmp, "state.npz")
    try:
        for t in range(ORACLE_FRAMES):
            if t == KF_CHECKPOINT_AT:
                if not (slam.is_initialized and slam.delta):
                    raise AssertionError(f"the frame-{t} checkpoint must carry the BA's state "
                                         "and a removal")
                saved = {"n": slam.n, "removals": len(slam.delta)}
                slam.save_state(ckpt)
            slam(t, images[t], depths[t], INTR)
        torch.cuda.synchronize()
        oracle_launches = {**all_launches(),
                           "fused_qkv_attention_masked": fused_qkv_attention.masked_launches}
        if any(oracle_launches.values()):
            raise AssertionError(f"a kernel launched on the oracle run: {oracle_launches}")
        o_poses, _ = slam.terminate()
        err, err_sim3, scale, per_frame = ate(o_poses, poses_gt[:ORACLE_FRAMES])
        ba_ms = slam.timer.ms_per_call().get("ba_update")
        live = int((slam.state.e_weight[:, 0] > 0).sum())
        removed = sorted(slam.delta)
        log(f"  ATE {err:.5f} against the scene's poses (bar {ATE_BAR}, twice "
            f"test_pose_recovery's: the scale is not held), {err_sim3:.3e} after Sim(3) "
            f"alignment (bar {ATE_SIM3_BAR}), the alignment's scale {scale:.5f} (the run's "
            f"scale {1 / scale:.5f} of the scene's); removed frames {removed}, aligned error "
            f"on them {float(per_frame[removed].max()):.3e}, largest {float(per_frame.max()):.3e}"
            f" at frame {int(per_frame.argmax())}; edge-ring overwrites "
            f"{slam.ring_overflow_count}; edges with weight > 0: {live}; stage ms per call "
            f"(synchronised, all frames) "
            f"{json.dumps({k: round(v, 3) for k, v in slam.timer.ms_per_call().items()})}")
        if not (err < ATE_BAR and err_sim3 < ATE_SIM3_BAR and removed
                and o_poses.shape == (ORACLE_FRAMES, 7) and live):
            raise AssertionError(f"oracle run: ATE {err}, {err_sim3} after Sim(3), "
                                 f"{len(removed)} removals, {live} live edges")

        # one flat update on the card against the CPU's, beside the witness
        st, n, M = slam.state, slam.n, slam.dims.M
        before = on_device(st, "cpu")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        slam.update()
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t1
        cpu, jit, cpu_s = cpu_updates(before, n, slam.dims, ocfg.slam)
        got, wit = update_diffs(st, cpu, n, M), update_diffs(jit, cpu, n, M)
        log(f"  one flat update ({card_s * 1e3:.1f} ms on the card), card vs CPU "
            f"{json.dumps(got)}; witness {json.dumps(wit)} (CPU update {cpu_s:.1f} s)")
        check_update("flat backend update, card vs CPU", got, wit)
        accumulation = flat_update_accumulation(before, n, slam.dims, ocfg.slam, dev)

        # ---- c. resume from the checkpoint in a fresh BATrack on the card
        resumed, _ = oracle_slam()
        resumed.load_state(ckpt)
        if not (resumed.is_initialized and {"n": resumed.n, "removals": len(resumed.delta)}
                == saved):
            raise AssertionError(f"the checkpoint loaded n {resumed.n}, {len(resumed.delta)} "
                                 f"removals, initialised {resumed.is_initialized}; saved {saved}")
        for t in range(KF_CHECKPOINT_AT, ORACLE_FRAMES):
            resumed(t, images[t], depths[t], INTR)
        r_poses, _ = resumed.terminate()
        resume_err = float(np.abs(r_poses - o_poses).max())
        log(f"  checkpoint at frame {KF_CHECKPOINT_AT}: n {saved['n']}, {saved['removals']} "
            f"removals, initialised; the resumed run removed {sorted(resumed.delta)}")
        if sorted(resumed.delta) != removed:
            raise AssertionError(f"the resumed run removed {sorted(resumed.delta)}, the "
                                 f"uninterrupted one {removed}")
        check(f"trajectory resumed from the frame-{KF_CHECKPOINT_AT} checkpoint vs the "
              f"uninterrupted run (limit 10x the witness {wit['poses']:.3e})", resume_err,
              max(TOL["ba_floor"], TOL["ba_witness_factor"] * wit["poses"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- d. the edge-sharded flat update on a one-rank group
    mesh = get_mesh(1, device=dev)
    try:
        state = on_device(before, dev)
        with full_fp32():
            sharded_slam_update(state, n, True, slam.dims, ocfg.slam, mesh)
        torch.cuda.synchronize()
        sh_got = update_diffs(state, cpu, n, M)
        log(f"  edge-sharded flat update on get_mesh(1) ({dist.get_backend()}), card vs CPU "
            f"{json.dumps(sh_got)}")
        check_update("edge-sharded flat update, card vs CPU", sh_got, wit)
    finally:
        dist.destroy_process_group()
    result.update(oracle_ate=err, oracle_ate_sim3=err_sim3, oracle_scale=1 / scale,
                  oracle_removed=removed, flat_ba_ms=ba_ms, flat_update_card_s=card_s,
                  flat_update_vs_cpu=got, flat_update_witness=wit,
                  flat_update_accumulation=accumulation, resume_err=resume_err,
                  edge_sharded_vs_cpu=sh_got, seconds=time.perf_counter() - t_phase)
    log(f"  phase 9 took {result['seconds']:.1f} s")
    return result


def flat_update_accumulation(before, n, dims, slam_cfg, dev):
    """The flat backend update of `before` on the card with its block sums
    accumulated in float64 (as shipped, ba/solver.py::accumulation_dtype)
    and in float32: ms per update from CUDA events, in the order f64, f32,
    f32, f64 after one warm-up of each, the two results' largest pose
    difference, and torch.profiler's split of one shipped update."""
    from batrack_tpu_torch.ba import solver
    from batrack_tpu_torch.slam.update import slam_update
    from batrack_tpu_torch.utils.config import full_fp32

    def run(f32):
        state = on_device(before, dev)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with full_fp32(), (patched(solver, "accumulation_dtype", lambda d: d) if f32
                           else contextlib.nullcontext()):
            start.record()
            slam_update(state, n, True, dims, slam_cfg)
            end.record()
        end.synchronize()
        return start.elapsed_time(end), state.poses[:n]

    run(False), run(True)  # warm-up
    times, poses = {False: [], True: []}, {}
    for f32 in (False, True, True, False):
        ms, poses[f32] = run(f32)
        times[f32].append(ms)
    res = {"float64_ms": times[False], "float32_ms": times[True],
           "poses_f64_vs_f32": max_err(poses[False], poses[True])}
    log(f"  flat update, block sums in float64 (shipped) vs float32: {json.dumps(res)}")
    state = on_device(before, dev)
    with full_fp32():
        kernels = profile_device("one flat update (float64 sums)",
                                 lambda: slam_update(state, n, True, dims, slam_cfg))
    index_add = sum(e.self_device_time_total for e in kernels if "indexFunc" in e.key) / 1e3
    res["profile_busy_ms"] = sum(e.self_device_time_total for e in kernels) / 1e3
    res["profile_index_add_ms"] = index_add
    log(f"  index_add_ kernels (indexFunc*) {index_add:.3f} ms of {res['profile_busy_ms']:.3f} "
        "ms device time")
    return res


# ---------------------------------------------------------------- --ranks
def phase_ranks(cfg, images, depths, mesh, gen):
    """The multi-device path at the mesh's world size, one process per
    device (torchrun). First one full-width tracker forward of phase 3's
    input (bf16, flow heads damped) under the mesh, held on rank 0 against
    the single-device forward on its own card, beside phase 3's witness.
    Then BATrack + MDTrackerAdapter with the mesh and live edges as in
    phase 5 (VIS_THRESHOLD=0, flow heads damped) for FRAMES frames:
    frames/s, stage ms and launches on rank 0, and the largest difference
    between the ranks' replicated trajectories. Last, one patch-sharded
    backend update of the final live-edge state at this world size, held
    on rank 0 against the CPU update of the same state within 10x the
    witness of that state (as phase 5), and the edge-sharded flat update
    (parallel/sharded_ba.py) of the same state, held the same way."""
    import torch.distributed as dist

    from batrack_tpu_torch.ops.attention import fused_qkv_attention
    from batrack_tpu_torch.ops.corr_kernel import corr_sample
    from batrack_tpu_torch.parallel import sharded_slam_update, sharded_slot_slam_update
    from batrack_tpu_torch.slam import BATrack
    from batrack_tpu_torch.tracker import MDTrackerAdapter
    from batrack_tpu_torch.utils.config import full_fp32
    from batrack_tpu_torch.utils.profiling import StageTimer

    dev, lead = mesh.device, mesh.rank == 0
    if lead:
        log(f"[ranks] tracker forward under a mesh of {mesh.size} ranks "
            f"({dist.get_backend()}) vs one device, {cfg.model.compute_dtype}, flow heads "
            f"x{FLOW_HEAD_DAMPING}")
    tin = tracker_input(images, depths, dev, gen)  # the same on every rank: same seed
    diff = mesh_tracker_check(cfg, tin, mesh, gen)

    cfg = copy.deepcopy(cfg)
    cfg.slam.VIS_THRESHOLD = 0.0
    if lead:
        log(f"[ranks] BATrack + MDTrackerAdapter, mesh of {mesh.size} ranks, davis_demo with "
            f"VIS_THRESHOLD=0 and flow heads x{FLOW_HEAD_DAMPING}, {FRAMES} frames")
    slam = BATrack(cfg, HT, WD, seed=0, device=dev, mesh=mesh)
    slam.tracker = MDTrackerAdapter(cfg.model, seed=0, device=dev, mesh=mesh)
    damp_flow_heads(slam.tracker.model)
    corr_sample.launches = fused_qkv_attention.launches = fused_qkv_attention.kv_launches = 0
    for t in range(STAGE_FROM):
        if t == STEADY_FROM:
            torch.cuda.synchronize(dev)
            t_steady = time.perf_counter()
        slam(t, images[t], depths[t], INTR)
    torch.cuda.synchronize(dev)
    fps = (STAGE_FROM - STEADY_FROM) / (time.perf_counter() - t_steady)
    slam.timer = StageTimer(enabled=True, sync=True)
    for t in range(STAGE_FROM, FRAMES):
        slam(t, images[t], depths[t], INTR)
    torch.cuda.synchronize(dev)
    launches = {"corr_sample": corr_sample.launches,
                "fused_qkv_attention_kv": fused_qkv_attention.kv_launches,
                "fused_qkv_attention": fused_qkv_attention.launches}

    # the patch-sharded update at this world size (all_reduce of the pose
    # blocks over every rank), on the replicated live-edge state
    n, M = slam.n, slam.dims.M
    before = on_device(slam.state, "cpu")
    state = on_device(before, dev)
    with full_fp32():
        sharded_slot_slam_update(state, n, True, slam.dims, cfg.slam, mesh)
    torch.cuda.synchronize(dev)
    if lead:
        cpu, jit, _ = cpu_updates(before, n, slam.dims, cfg.slam)
        ba_got, ba_wit = update_diffs(state, cpu, n, M), update_diffs(jit, cpu, n, M)
        log(f"  patch-sharded update at {mesh.size} ranks on frame {n}'s live edges, card vs "
            f"CPU {json.dumps(ba_got)}; witness, CPU vs CPU with e_target jittered "
            f"{json.dumps(ba_wit)}")
        check_update(f"patch-sharded backend update at {mesh.size} ranks, card vs CPU",
                     ba_got, ba_wit)

    # the edge-sharded flat update (use_keyframe's backend) of the same state
    # at this world size: one all_reduce of the assembled blocks per step
    flat = dataclasses.replace(cfg.slam, BA_BACKEND="flat")
    state = on_device(before, dev)
    with full_fp32():
        sharded_slam_update(state, n, True, slam.dims, flat, mesh)
    torch.cuda.synchronize(dev)
    if lead:
        cpu, jit, _ = cpu_updates(before, n, slam.dims, flat)
        flat_got, flat_wit = update_diffs(state, cpu, n, M), update_diffs(jit, cpu, n, M)
        log(f"  edge-sharded flat update at {mesh.size} ranks, card vs CPU "
            f"{json.dumps(flat_got)}; witness {json.dumps(flat_wit)}")
        check_update(f"edge-sharded flat update at {mesh.size} ranks, card vs CPU",
                     flat_got, flat_wit)

    poses, _ = slam.terminate()
    mine = torch.from_numpy(poses).to(dev).contiguous()
    parts = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(parts, mine, group=mesh.group)
    rank_spread = max(max_err(p, parts[0]) for p in parts)
    if not lead:
        return None
    result = {"world": mesh.size, "frames_per_s": fps, "launches": launches,
              "appends": slam.append_count, "rank_spread": rank_spread,
              "stage_ms": {k: round(v, 3) for k, v in slam.timer.ms_per_call().items()},
              "live_edges": int((slam.state.e_weight[:, 0] > 0).sum()),
              "tracker_mesh_vs_one_device": diff,
              "ba_update_vs_cpu": ba_got, "ba_update_witness": ba_wit,
              "flat_update_vs_cpu": flat_got, "flat_update_witness": flat_wit}
    log(f"  {json.dumps(result)}")
    if not (np.isfinite(poses).all() and launches["corr_sample"]
            and launches["fused_qkv_attention_kv"] >= slam.append_count):
        raise AssertionError(f"trajectory not finite or a kernel did not launch: {launches}")
    return result


# ---------------------------------------------------------------- the user's pipeline
GT_DEPTH_SCALE = 1.01         # the .dpt ground truth is the prior x 1.01 (tests/test_cli_e2e.py)
REFINE_CHECK_STEPS = 8
REFINE_GT_DEPTH = 5.0         # tests/test_refine.py's flat scene


def write_sintel_dataset(root, images, depths, poses_w2c):
    """The Sintel layout tests/test_cli_e2e.py writes: PNG frames (each row
    filtered as libpng's heuristic picks, as image tools write them), .npy
    priors, .dpt ground-truth depth at the prior x 1.01 and .cam files
    (K and the world-to-camera extrinsics). Returns the directories and the
    uint8 frames written."""
    from batrack_tpu_torch.data.png import write_png
    from batrack_tpu_torch.data.streams import TAG_FLOAT
    from batrack_tpu_torch.geometry import se3

    dirs = {k: root / k for k in ("rgb", "depth", "depth_gt", "cam")}
    for d in dirs.values():
        d.mkdir(parents=True)
    K = np.array([[INTR[0], 0, INTR[2]], [0, INTR[1], INTR[3]], [0, 0, 1]], np.float64)
    w2c = se3.matrix(torch.from_numpy(poses_w2c)).numpy().astype(np.float64)
    frames = np.clip(images, 0, 255).astype(np.uint8)  # BATrack's own conversion
    tag = np.float32(TAG_FLOAT).tobytes()
    for t in range(len(frames)):
        stem = f"frame_{t:04d}"
        write_png(dirs["rgb"] / f"{stem}.png", frames[t])
        np.save(dirs["depth"] / f"{stem}.npy", depths[t])
        gt = (depths[t] * GT_DEPTH_SCALE).astype(np.float32)
        (dirs["depth_gt"] / f"{stem}.dpt").write_bytes(
            tag + struct.pack("<ii", gt.shape[1], gt.shape[0]) + gt.tobytes())
        (dirs["cam"] / f"{stem}.cam").write_bytes(tag + K.tobytes() + w2c[t][:3].tobytes())
    return dirs, frames


@contextlib.contextmanager
def patched(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def phase_pipeline(dev):
    """Phase 7a: the user's pipeline through the CLIs on a Sintel-layout
    dataset written to a temporary directory: run_slam at davis_demo, then
    run_refine (grid 10, 200 steps) and eval_depth with and without
    --refined."""
    import batrack_tpu_torch.refine as refine_pkg
    import batrack_tpu_torch.slam as slam_pkg
    from batrack_tpu_torch.cli import eval_depth, run_refine, run_slam
    from batrack_tpu_torch.data import png, sintel_rgbd_stream
    from batrack_tpu_torch.ops.attention import fused_qkv_attention
    from batrack_tpu_torch.ops.corr_kernel import corr_sample
    from batrack_tpu_torch.utils.config import load_config
    from batrack_tpu_torch.utils.evaluation import eval_metrics
    from batrack_tpu_torch.utils.synth import make_scene
    from batrack_tpu_torch.utils.traj import load_traj, read_tum_file

    config = Path(__file__).resolve().parent / "configs" / "davis_demo.yaml"
    cfg = load_config(str(config))
    images, depths, poses_gt = make_scene(FRAMES, HT, WD, INTR)
    with tempfile.TemporaryDirectory(prefix="batrack_pipeline_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        dirs, frames = write_sintel_dataset(root / "data", images, depths, poses_gt)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        n = 0
        for t, image, _, _, _ in sintel_rgbd_stream(dirs["rgb"], dirs["depth"],
                                                    dirs["depth_gt"], dirs["cam"]):
            if t == -1:
                break
            if image.dtype != np.uint8 or not np.array_equal(image, frames[t]):
                raise AssertionError(f"frame {t}: the stream's decoded PNG differs from the "
                                     "array written")
            n += 1
        if n != FRAMES:
            raise AssertionError(f"the stream yielded {n} frames, not {FRAMES}")
        t_stream = time.perf_counter() - t0
        pngs = sorted(dirs["rgb"].glob("*.png"))
        t0 = time.perf_counter()
        for path in pngs:
            png.read_png_rgb(path)
        decode_ms = 1e3 * (time.perf_counter() - t0) / len(pngs)
        filters = np.zeros(5, np.int64)
        for path in pngs:
            filters += png_row_filters(path)
        log(f"[pipeline] Sintel layout, {FRAMES} frames {HT}x{WD}, written in {t_write:.1f} s "
            f"(row filters None/Sub/Up/Average/Paeth: {filters.tolist()}); the stream decoded "
            f"every frame bitwise equal to the array written ({1e3 * t_stream / FRAMES:.1f} ms "
            f"per frame with its depth, .dpt and .cam); PNG decode alone {decode_ms:.1f} ms per "
            "frame on the host, one thread")

        savedir, name = root / "out", "synth"
        argv = ["--config", str(config), "--device", str(dev), "model.init_dir=",
                f"data.imagedir={dirs['rgb']}", f"data.depthdir={dirs['depth']}",
                f"data.depthdir_gt={dirs['depth_gt']}", f"data.calib={dirs['cam']}",
                f"data.gt_traj={dirs['cam']}", "data.traj_format=sintel",
                f"data.savedir={savedir}", f"data.name={name}"]
        made = []

        class Observed(slam_pkg.BATrack):
            """The CLI's BATrack, kept to read its counts and its own
            (unsynchronised) stage timer; it runs as shipped."""

            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        corr_sample.launches = fused_qkv_attention.launches = 0
        zero_off_path()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with patched(slam_pkg, "BATrack", Observed):
            rc = run_slam.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"corr_sample": corr_sample.launches,
                    "fused_qkv_attention": fused_qkv_attention.launches, **off_path_launches()}
        if rc != 0 or len(made) != 1:
            raise AssertionError(f"run_slam returned {rc} with {len(made)} BATrack")
        slam = made[0]
        appends = slam.append_count
        stage_ms = {k: round(v, 3) for k, v in slam.timer.ms_per_call().items()}
        log(f"  run_slam: launches {launches} over {appends} appends")
        log(f"  run_slam: {FRAMES} frames in {wall:.2f} s, {FRAMES / wall:.3f} frames/s (whole "
            "CLI run as shipped: config, model set-up, decode, SLAM, artifacts)")
        log(f"  run_slam host ms per call as the CLI logs them (unsynchronised: enqueue, and "
            f"\"stream\" is the loop's wait for its next decoded frame; phase 4 gives the "
            f"synchronised stage times): {json.dumps(stage_ms)}")
        log(f"  run_slam peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        if (appends != len(range(0, FRAMES, cfg.slam.kf_stride))
                or launches["corr_sample"] != CORR_LAUNCHES * appends
                or launches["fused_qkv_attention"] != SPACE_LAUNCHES * appends):
            raise AssertionError(f"K1 and K2 launched {launches} over {appends} appends, not "
                                 f"{CORR_LAUNCHES} and {SPACE_LAUNCHES} per append")

        outdir = savedir / name
        pred = read_tum_file(str(outdir / "batrack_traj.txt"))
        again = eval_metrics(pred, gt_traj=load_traj(str(dirs["cam"]), "sintel"))
        err_sum = (savedir / "error_sum.txt").read_text().splitlines()
        log(f"  error_sum.txt: {err_sum[0].strip()}")
        if err_sum[1:4] != [f"{v:.5f}" for v in again]:
            raise AssertionError(f"error_sum.txt {err_sum[1:4]} differs from eval_metrics of "
                                 f"batrack_traj.txt {again}")
        with open(outdir / "results.pkl", "rb") as f:
            res = pickle.load(f)
        if (pred[0].shape != (FRAMES, 7) or not np.isfinite(pred[0]).all()
                or res["cams_T_world"].shape != (FRAMES, 4, 4)
                or res["trajs_2d_disp"].shape != (FRAMES, cfg.slam.PATCHES_PER_FRAME,
                                                  cfg.slam.S_local, 3)
                or not np.array_equal(res["rgbs"], frames.astype(float))):
            raise AssertionError("run_slam's artifacts are not the run's")

        step_ms = []

        def timed_loop(params, data, image_hw, rcfg, verbose=False):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = loop(params, data, image_hw, rcfg, verbose=verbose)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end) / rcfg.niter)
            return out

        loop = refine_pkg.global_alignment_loop
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with patched(refine_pkg, "global_alignment_loop", timed_loop):
            rc = run_refine.main(["--result_dir", str(savedir), "--scenes", name,
                                  "--device", str(dev)])
        stage_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(outdir / "results_refined.pkl", "rb") as f:
            refined = pickle.load(f)
        if (rc != 0 or len(step_ms) != 1 or refined["dmaps_scaled"].shape != (FRAMES, HT, WD, 1)
                or not np.isfinite(refined["dmaps_scaled"]).all()):
            raise AssertionError("run_refine wrote no finite dmaps_scaled of the frames' shape")
        log(f"  run_refine (grid 10, 200 Adam steps, all five losses; T={FRAMES}, "
            f"N={cfg.slam.PATCHES_PER_FRAME}, S={cfg.slam.S_local}): {step_ms[0]:.3f} ms per "
            f"step (CUDA events around the loop), whole stage {stage_s:.2f} s, peak device "
            f"memory {peak:.2f} GiB")
        for flag in ([], ["--refined"]):
            if eval_depth.main(["--result_dir", str(savedir), "--scenes", name] + flag) != 0:
                raise AssertionError(f"eval_depth {flag} failed")
        table = (savedir / "eval_depth.txt").read_text().splitlines()
        vals = [float(v) for ln in table if ln.split("|")[0].strip() in (name, "mean")
                for v in ln.split("|")[1:]]
        if len(vals) != 32 or not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"eval_depth tables not finite: {table}")
    return {"fps": FRAMES / wall, "stage_ms": stage_ms, "decode_ms": decode_ms,
            "appends": appends, "launches": launches, "refine_ms_per_step": step_ms[0],
            "refine_s": stage_s}


def png_row_filters(path):
    """Count of each row filter type (0-4) in an 8-bit RGB PNG."""
    buf = Path(path).read_bytes()
    pos, idat, w = 8, [], 0
    while pos < len(buf):
        length, tag = struct.unpack(">I4s", buf[pos:pos + 8])
        if tag == b"IHDR":
            w = struct.unpack(">I", buf[pos + 8:pos + 12])[0]
        elif tag == b"IDAT":
            idat.append(buf[pos + 8:pos + 8 + length])
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(-1, 1 + 3 * w)
    return np.bincount(raw[:, 0], minlength=5)


def refine_results(rng, T, N, S, scale_errs):
    """A results dict as tests/test_refine.py builds one, at (T, N, S) and
    HT x WD: a flat scene at depth 5, identity poses, visibility and static
    scores at 1, the depth maps off by a scale per frame."""
    xy = np.stack([rng.uniform(5, WD - 5, (T, N, S)), rng.uniform(5, HT - 5, (T, N, S))], -1)
    disp = np.full((T, N, S, 1), 1.0 / REFINE_GT_DEPTH)
    dmaps = np.full((T, HT, WD, 1), REFINE_GT_DEPTH) * np.asarray(scale_errs).reshape(T, 1, 1, 1)
    return {
        "cams_T_world": np.tile(np.eye(4, dtype=np.float32), (T, 1, 1)),
        "intrinsics": np.tile(INTR, (T, 1)),
        "trajs_2d_disp": np.concatenate([xy, disp], -1).astype(np.float32),
        "trajs_static": np.ones((T, N, S), np.float32),
        "trajs_vis": np.ones((T, N, S), np.float32),
        "grid_query_frames": np.arange(T),
        "dmaps": dmaps.astype(np.float32),
        "dmaps_gt": np.full((T, HT, WD, 1), REFINE_GT_DEPTH, np.float32),
    }


def phase_refine(dev, T, N, S, profile=False):
    """Phase 7b: stage-3 numerics at the pipeline's shape. Eight Adam steps
    of every loss in float64 on the card against the CPU, within 10x a
    witness (the CPU run of inputs moved by one float64 rounding) and at
    least 1e-5: in float32 the first steps' signs sit on rounding (Adam
    scales a gradient of rounding noise to the full step), so its witness
    is as large as the steps and the limit could not fail; in float64 the
    witness falls to ~1e-9 and the limit is 1e-5 against steps of ~1e-2.
    Then tests/test_refine.py::test_scale_recovery's configuration for 200
    steps on the card in float32, the production dtype, held to that test's
    bar. With `profile`, also device time by kernel over 5 steps of every
    loss in float32."""
    from batrack_tpu_torch.refine import (
        build_refine_data,
        global_alignment_loop,
        init_params,
        scaled_dmaps,
        total_loss,
    )
    from batrack_tpu_torch.utils.config import RefineConfig
    from batrack_tpu_torch.utils.evaluation import eval_depth_maps

    rng = np.random.default_rng(0)
    res = refine_results(rng, T, N, S, np.linspace(0.8, 1.25, T))
    f64 = np.float64
    jit = {k: np.asarray(v, f64) if k in ("trajs_2d_disp", "dmaps") else v
           for k, v in res.items()}
    for k in ("trajs_2d_disp", "dmaps"):
        jit[k] = jit[k] * (1 + np.finfo(f64).eps * rng.uniform(-1, 1, res[k].shape))
    cfg = RefineConfig(niter=REFINE_CHECK_STEPS)  # grid 10, every loss, pose free

    def run(results, device):
        data = build_refine_data(results, align_depth=True, dtype=f64, device=device)
        params = init_params(data, cfg.grid_size, dtype=f64)
        return global_alignment_loop(params, data, (HT, WD), cfg)[0]

    log(f"[refine] stage 3 at T={T}, N={N}, S={S}, {HT}x{WD}, grid {cfg.grid_size}: "
        f"{REFINE_CHECK_STEPS} Adam steps of every loss in float64, card against CPU")
    run(res, dev)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    card = run(res, dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    cpu = run(res, "cpu")
    cpu_s = time.perf_counter() - t0
    wit = run(jit, "cpu")
    got = {k: max_err(getattr(card, k).cpu(), getattr(cpu, k)) for k in card._fields}
    witness = {k: max_err(getattr(wit, k), getattr(cpu, k)) for k in card._fields}
    init = init_params(build_refine_data(res, align_depth=True, dtype=f64, device="cpu"),
                       cfg.grid_size, dtype=f64)
    moved = {k: max_err(getattr(cpu, k), getattr(init, k)) for k in card._fields}
    log(f"  float64: card {1e3 * card_s / REFINE_CHECK_STEPS:.2f} ms per step incl. data "
        f"set-up, peak device memory {peak:.2f} GiB; CPU {cpu_s / REFINE_CHECK_STEPS:.2f} s "
        f"per step; largest move from init {json.dumps(moved)}")
    log(f"  card vs CPU {json.dumps(got)}; witness {json.dumps(witness)}")
    for k in card._fields:
        check(f"stage 3 after {REFINE_CHECK_STEPS} steps, {k}", got[k],
              max(TOL["ba_floor"], TOL["ba_witness_factor"] * witness[k]))
    if profile:
        data = build_refine_data(res, align_depth=True, device=dev)
        five = dataclasses.replace(cfg, niter=5)
        profile_device("stage 3, 5 Adam steps of every loss", lambda: global_alignment_loop(
            init_params(data, five.grid_size), data, (HT, WD), five))

    res = refine_results(rng, T, N, S, np.linspace(0.6, 1.8, T))
    data = build_refine_data(res, align_depth=False, device=dev)
    rcfg = RefineConfig(grid_size=10, niter=200, lr=0.08, spatial_loss=5.0, inter_frame_loss=0.0,
                        pts_3d_loss=0.0, cam_smooth_vec_loss=0.0, scale_smoothness_loss=0.01,
                        fixed_pose=True, fixed_K=True)
    params = init_params(data, rcfg.grid_size)
    loss0 = float(total_loss(params, data, (HT, WD), rcfg)[0])
    params, loss1 = global_alignment_loop(params, data, (HT, WD), rcfg)
    gt = res["dmaps_gt"][..., 0]
    before = eval_depth_maps(gt, data.dmaps.cpu().numpy(), scaling="none")[0]
    after = eval_depth_maps(gt, scaled_dmaps(params, data).cpu().numpy(), scaling="none")[0]
    log(f"  scale recovery, 200 steps on the card: loss {loss0:.6f} -> {loss1:.6f}, abs_rel "
        f"{before:.4f} -> {after:.4f} (bar: loss x0.3, abs_rel x0.25)")
    if not (loss1 < 0.3 * loss0 and after < 0.25 * before):
        raise AssertionError("stage 3 did not recover the per-frame scales")


# ---------------------------------------------------------------- the demo chain
DEMO_SCENE = "synth"
STAGE1_ARCH = "vitl"
STAGE1_SEED = 0
STAGE1_CHECK_FACTOR, STAGE1_CHECK_FLOOR = 10.0, 1e-5  # x witness, relative
DENSE_GRID, DENSE_NITER = 12, 300                       # scripts/demo/run_dense.sh defaults


def all_launches():
    """Every kernel counter of the port."""
    from batrack_tpu_torch.ops.attention import (flash_attention, fused_qkv_attention,
                                                 vmem_attention)
    from batrack_tpu_torch.ops.corr_kernel import corr_sample

    return {"corr_sample": corr_sample.launches, "corr_sample_mxu": corr_sample.mxu_launches,
            "corr_sample_int8": corr_sample.int8_launches,
            "fused_qkv_attention": fused_qkv_attention.launches,
            "fused_qkv_attention_kv": fused_qkv_attention.kv_launches,
            "vmem_attention": vmem_attention.launches,
            "flash_attention": flash_attention.launches}


def zero_all_launches():
    from batrack_tpu_torch.ops.attention import fused_qkv_attention
    from batrack_tpu_torch.ops.corr_kernel import corr_sample

    corr_sample.launches = fused_qkv_attention.launches = fused_qkv_attention.kv_launches = 0
    fused_qkv_attention.masked_launches = 0
    zero_off_path()


def stage1_networks():
    """DepthAnythingV2 and UniDepthV2 at ViT-L width on the CPU, weights from
    a seed. DA2's last bias is set to 1: random weights otherwise leave every
    disparity at the final ReLU's zero, and the alignment would fit a
    constant."""
    from batrack_tpu_torch.depth import dpt, unidepth

    torch.manual_seed(STAGE1_SEED)
    da2 = dpt.DepthAnythingV2(STAGE1_ARCH).eval()
    with torch.no_grad():
        da2.depth_head.scratch.output_conv2[2].bias.fill_(1.0)
    ud = unidepth.UniDepthV2(STAGE1_ARCH).eval()
    return da2, ud


@contextlib.contextmanager
def timed_forward(cls, events):
    """Record a pair of CUDA events around every forward of `cls`."""
    forward = cls.forward

    def run(self, *a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = forward(self, *a, **kw)
        end.record()
        events.append((start, end))
        return out

    cls.forward = run
    try:
        yield
    finally:
        cls.forward = forward


def forward_flops(model, *inputs):
    """FLOPs of one forward as torch.utils.flop_counter counts them
    (matmuls, convolutions, attention)."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(*inputs)
    return counter.get_total_flops()


def stage1_inputs(frame):
    """Each network's input for one uint8 frame, as its infer function makes it:
    DA2's preprocess (518x686 at 480x640) and UniDepth's normalised,
    linearly resized image at the 2400-patch bound (588x784)."""
    from batrack_tpu_torch.depth import dpt, unidepth
    from batrack_tpu_torch.ops.sampling import resize_linear

    (h, w), _ = unidepth._infer_shape(frame.shape[:2])
    x = (frame.astype(np.float32) / 255.0 - dpt.IMAGENET_MEAN) / dpt.IMAGENET_STD
    return (torch.from_numpy(dpt.preprocess(frame)),
            resize_linear(torch.from_numpy(x[None]), (h, w)))


def network_outputs(out):
    return {"disparity": out} if isinstance(out, torch.Tensor) else {"depth": out["depth"],
                                                                     "K": out["K"]}


def check_network_on_card(name, model, x, dev, profile=False):
    """One full-width forward on the card in full float32 against the CPU's,
    within 10x a witness (the CPU forward of x moved by one float32
    rounding) and at least 1e-5, relative to the largest output; then the
    same forward with TF32, its relative gap from full float32, and the two
    times. With `profile`, device time by kernel over one TF32 forward."""
    from batrack_tpu_torch.utils.config import allow_tf32, full_fp32

    card = copy.deepcopy(model).to(dev)
    xd = x.to(dev)
    with torch.no_grad():
        with full_fp32():
            f32 = {k: v.cpu() for k, v in network_outputs(card(xd)).items()}
            ms_f32 = cuda_ms(lambda: card(xd), reps=3, warmup=1)
        with allow_tf32():
            tf32 = {k: v.cpu() for k, v in network_outputs(card(xd)).items()}
            ms_tf32 = cuda_ms(lambda: card(xd), reps=3, warmup=1)
            if profile:
                profile_device(f"{name} forward, TF32", lambda: card(xd))
    del card
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(1)
    u = torch.rand(x.shape, generator=gen) * 2 - 1
    t0 = time.perf_counter()
    with torch.no_grad():
        cpu = network_outputs(model(x))
        cpu_s = time.perf_counter() - t0
        wit = network_outputs(model(x * (1 + torch.finfo(torch.float32).eps * u)))
    gaps = {}
    for k in cpu:
        scale = cpu[k].abs().max().item()
        got, witness = max_err(f32[k], cpu[k]) / scale, max_err(wit[k], cpu[k]) / scale
        gap = gaps[k] = max_err(tf32[k], f32[k]) / scale
        log(f"  {name} {k} {tuple(cpu[k].shape)}: card float32 vs CPU {got:.3e} relative "
            f"(witness {witness:.3e}); TF32 vs float32 on the card {gap:.3e}")
        check(f"{name} {k}, card vs CPU (relative)", got,
              max(STAGE1_CHECK_FLOOR, STAGE1_CHECK_FACTOR * witness))
        if not torch.isfinite(tf32[k]).all():
            raise AssertionError(f"{name} {k}: the TF32 forward is not finite")
    log(f"  {name} forward: {ms_f32:.2f} ms float32, {ms_tf32:.2f} ms TF32 on the card "
        f"(CUDA events, 3 calls); {cpu_s:.1f} s on the CPU")
    return {"ms_f32": ms_f32, "ms_tf32": ms_tf32, "tf32_gap": gaps}


def run_cli(cli, argv, cls=None):
    """cli.main(argv) timed: (rc, wall s, forward ms per call by CUDA events
    around cls.forward, peak device GiB, stdout)."""
    events, out = [], io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if cls is not None:
            stack.enter_context(timed_forward(cls, events))
        stack.enter_context(contextlib.redirect_stdout(out))
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = [s.elapsed_time(e) for s, e in events]
    return rc, wall, ms, torch.cuda.max_memory_allocated() / 2 ** 30, out.getvalue()


def write_stage1_checkpoints(root):
    """The seeded stage-1 networks (stage1_networks) written under `root`
    as the released files: (da2, ud, DA2 .pth path, UniDepth
    model.safetensors path)."""
    from batrack_tpu_torch.utils.tensorfile import write_safetensors

    da2, ud = stage1_networks()
    da2_ckpt = root / f"depth_anything_v2_{STAGE1_ARCH}.pth"
    ud_ckpt = root / "model.safetensors"
    torch.save(da2.state_dict(), da2_ckpt)
    write_safetensors(ud_ckpt, ud.state_dict())
    return da2, ud, da2_ckpt, ud_ckpt


def run_stage1_clis(dev, img_dir, depth_dir, scene, da2_ckpt, ud_ckpt, stats):
    """cli.infer_depth and cli.infer_metric_depth over the FRAMES frames of
    img_dir into depth_dir (run_mono_depth.sh's layout), each forward timed
    by CUDA events: ms per forward (the median after the first), TFLOP/s
    from stats[name]["tflop"], the CLI's time per frame and peak memory go
    into stats[name]."""
    from batrack_tpu_torch.cli import infer_depth, infer_metric_depth
    from batrack_tpu_torch.depth import dpt, unidepth

    runs = (("infer_depth", infer_depth, dpt.DepthAnythingV2, "DA2",
             ["--encoder", STAGE1_ARCH, "--checkpoint", str(da2_ckpt), "--img_dir", str(img_dir),
              "--out_dir", str(depth_dir / "depthAny_disp" / scene), "--device", str(dev)]),
            ("infer_metric_depth", infer_metric_depth, unidepth.UniDepthV2, "UniDepthV2",
             ["--arch", STAGE1_ARCH, "--checkpoint", str(ud_ckpt), "--img_dir", str(img_dir),
              "--out_dir", str(depth_dir / "unidepthv2" / scene), "--device", str(dev)]))
    for cli_name, cli, cls, name, argv in runs:
        rc, wall, ms, peak, _ = run_cli(cli, argv, cls)
        if rc != 0 or len(ms) != FRAMES:
            raise AssertionError(f"{cli_name} returned {rc} after {len(ms)} forwards")
        st = stats[name]
        steady = statistics.median(ms[1:])
        st.update(ms=steady, first_ms=ms[0], cli_s_per_frame=wall / FRAMES, peak_gib=peak,
                  tflops=st["tflop"] / (steady / 1e3))
        log(f"  {cli_name} ({STAGE1_ARCH}, TF32): {steady:.2f} ms per forward (median of "
            f"{FRAMES - 1} after the first, {ms[0]:.1f} ms; CUDA events around the forward), "
            f"{st['tflops']:.1f} TFLOP/s achieved; whole CLI {wall:.2f} s for {FRAMES} "
            f"frames, {1e3 * wall / FRAMES:.1f} ms per frame (load, decode, preprocess, "
            f"forward, .npy/.npz); peak device memory {peak:.2f} GiB")


def refine_and_view(dev, savedir, scene, shape):
    """cli.run_refine at run_dense.sh's defaults on savedir/scene's
    results.pkl (dmaps_scaled must be finite, (FRAMES,) + shape + (1,)),
    then cli.vis_results on its output (rc 1 only without rerun-sdk, with
    its summary). Returns (refine wall s, peak GiB, vis_results rc,
    vis_results output)."""
    from batrack_tpu_torch.cli import run_refine, vis_results

    rc, wall, _, peak, _ = run_cli(run_refine, [
        "--result_dir", str(savedir), "--grid_size", str(DENSE_GRID), "--scenes", scene,
        "--niter", str(DENSE_NITER), "--device", str(dev)])
    refined = savedir / scene / "results_refined.pkl"
    with open(refined, "rb") as f:
        dense = pickle.load(f)
    if (rc != 0 or dense["dmaps_scaled"].shape != (FRAMES,) + tuple(shape) + (1,)
            or not np.isfinite(dense["dmaps_scaled"]).all()):
        raise AssertionError("run_refine wrote no finite dmaps_scaled of the frames' shape")
    rc, _, _, _, out = run_cli(vis_results, ["--result_path", str(refined)])
    rerun_absent = importlib.util.find_spec("rerun") is None
    if not ((rc == 0 or (rc == 1 and rerun_absent))
            and f"cams_T_world: ({FRAMES}, 4, 4)" in out):
        raise AssertionError(f"vis_results returned {rc} (rerun absent: {rerun_absent}):\n{out}")
    return wall, peak, rc, out


def phase_demo(dev, profile=False):
    """Phase 8: the demo chain through the port's CLIs on phase 7's scene,
    laid out as scripts/demo/*.sh expect: the stage-1 networks at ViT-L
    width (seeded weights written as the released files: DA2 .pth, UniDepth
    .safetensors) held card against CPU, then infer_depth,
    infer_metric_depth and align_depth (no kernel may launch), run_slam at
    davis_demo on the aligned priors (K1 and K2 counted: 4 and 24 per
    append), run_refine at run_dense.sh's defaults and vis_results."""
    import batrack_tpu_torch.slam as slam_pkg
    from batrack_tpu_torch.cli import align_depth, run_slam
    from batrack_tpu_torch.data.png import write_png
    from batrack_tpu_torch.depth import dpt
    from batrack_tpu_torch.utils.config import load_config
    from batrack_tpu_torch.utils.synth import make_scene

    config = Path(__file__).resolve().parent / "configs" / "davis_demo.yaml"
    cfg = load_config(str(config))
    images, _, _ = make_scene(FRAMES, HT, WD, INTR)
    frames = np.clip(images, 0, 255).astype(np.uint8)
    stats = {}
    with tempfile.TemporaryDirectory(prefix="batrack_demo_") as tmp:
        root = Path(tmp)
        img_dir = root / "davis" / DEMO_SCENE
        img_dir.mkdir(parents=True)
        for t in range(FRAMES):
            write_png(img_dir / f"{t:05d}.png", frames[t])
        t0 = time.perf_counter()
        da2, ud, da2_ckpt, ud_ckpt = write_stage1_checkpoints(root)
        n_params = {"DA2": sum(p.numel() for p in da2.parameters()),
                    "UniDepthV2": sum(p.numel() for p in ud.parameters())}
        log(f"[demo] stage-1 networks at {STAGE1_ARCH} width from seed {STAGE1_SEED} "
            f"({n_params['DA2'] / 1e6:.1f} M and {n_params['UniDepthV2'] / 1e6:.1f} M parameters), "
            f"written as {da2_ckpt.name} ({da2_ckpt.stat().st_size / 2 ** 30:.2f} GiB) and "
            f"{ud_ckpt.name} ({ud_ckpt.stat().st_size / 2 ** 30:.2f} GiB) in "
            f"{time.perf_counter() - t0:.1f} s")

        x_da2, x_ud = stage1_inputs(frames[0])
        for name, model, x in (("DA2", da2, x_da2), ("UniDepthV2", ud, x_ud)):
            tokens = (x.shape[1] // dpt.PATCH) * (x.shape[2] // dpt.PATCH) + 1
            card = copy.deepcopy(model).to(dev)
            flops = forward_flops(card, x.to(dev))
            del card
            stats[name] = {"tokens": tokens, "tflop": flops / 1e12, "input": tuple(x.shape[1:3]),
                           **check_network_on_card(name, model, x, dev, profile)}
            log(f"  {name}: input {x.shape[1]}x{x.shape[2]}, {tokens} tokens, "
                f"{flops / 1e12:.3f} TFLOP per forward (torch.utils.flop_counter)")
        del da2, ud, x_da2, x_ud

        depth_dir = root / "Monodepth"
        zero_all_launches()
        run_stage1_clis(dev, img_dir, depth_dir, DEMO_SCENE, da2_ckpt, ud_ckpt, stats)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = align_depth.main(["--data_dir", str(root / "davis"), "--depth_dir",
                                   str(depth_dir), "--save_name", "unidepth_da"])
        log(f"  align_depth: {time.perf_counter() - t0:.2f} s (numpy, host)")
        stage1 = all_launches()
        if rc != 0 or any(stage1.values()):
            raise AssertionError(f"stage 1: align_depth returned {rc}; launches {stage1} "
                                 "(no kernel may launch)")
        log(f"  stage-1 kernel launches {json.dumps(stage1)} (all must be 0)")

        disps = sorted((depth_dir / "depthAny_disp" / DEMO_SCENE).glob("*.npy"))
        metric = sorted((depth_dir / "unidepthv2" / DEMO_SCENE).glob("*.npz"))
        aligned = sorted((depth_dir / "unidepth_da" / DEMO_SCENE).glob("*.npy"))
        Ks = sorted((depth_dir / "unidepth_da_intrinsics" / DEMO_SCENE).glob("*.npy"))
        d0, m0, a0 = np.load(disps[0]), np.load(metric[0]), np.load(aligned[0])
        if (len(disps) != FRAMES or len(metric) != FRAMES or len(aligned) != FRAMES
                or len(Ks) != FRAMES or np.load(Ks[0]).shape != (3, 3)
                or d0.shape != (HT, WD) or not np.isfinite(d0).all() or d0.min() < 0
                or set(m0.files) != {"depth", "fov", "intrinsics"}
                or m0["depth"].shape != (HT, WD) or not (m0["depth"] > 0).all()
                or m0["intrinsics"].shape != (3, 3) or a0.shape != (HT, WD)
                or not np.isfinite(a0).all()):
            raise AssertionError("stage-1 artifacts are not in the stage-2 input schema")
        log(f"  artifacts: {len(disps)} disparities {d0.shape} [{d0.min():.3f}, {d0.max():.3f}], "
            f"{len(metric)} metric .npz (depth [{m0['depth'].min():.2f}, "
            f"{m0['depth'].max():.2f}] m, fov {float(m0['fov']):.1f} deg), {len(aligned)} "
            f"aligned depths [{a0.min():.3f}, {a0.max():.3f}] and shared K")

        savedir, made = root / "out", []

        class Observed(slam_pkg.BATrack):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        argv = ["--config", str(config), "--device", str(dev), "model.init_dir=",
                f"data.imagedir={img_dir}", f"data.savedir={savedir}",
                f"data.depthdir={depth_dir / 'unidepth_da' / DEMO_SCENE}",
                f"data.depthdir_gt={depth_dir / 'unidepth_da' / DEMO_SCENE}",
                f"data.calib={depth_dir / 'unidepth_da_intrinsics' / DEMO_SCENE}",
                f"data.name={DEMO_SCENE}", "save_trajectory=true", "save_plot=true",
                "save_results=true"]
        zero_all_launches()
        with patched(slam_pkg, "BATrack", Observed):
            rc, wall, _, peak, _ = run_cli(run_slam, argv)
        launches = all_launches()
        appends = made[0].append_count if made else 0
        log(f"  run_slam on the aligned priors, {FRAMES} frames: {wall:.2f} s "
            f"({FRAMES / wall:.3f} frames/s), launches {json.dumps(launches)} over {appends} "
            f"appends, peak device memory {peak:.2f} GiB")
        if (rc != 0 or appends != len(range(0, FRAMES, cfg.slam.kf_stride))
                or launches["corr_sample"] != CORR_LAUNCHES * appends
                or launches["fused_qkv_attention"] != SPACE_LAUNCHES * appends):
            raise AssertionError(f"run_slam returned {rc}; K1 and K2 launched {launches} over "
                                 f"{appends} appends, not {CORR_LAUNCHES} and {SPACE_LAUNCHES} "
                                 "per append")
        off_path_launches()
        with open(savedir / DEMO_SCENE / "results.pkl", "rb") as f:
            res = pickle.load(f)
        if res["cams_T_world"].shape != (FRAMES, 4, 4) or not np.isfinite(res["cams_T_world"]).all():
            raise AssertionError("run_slam's results.pkl has no finite trajectory of the frames")

        wall, peak, rc, out = refine_and_view(dev, savedir, DEMO_SCENE, (HT, WD))
        log(f"  run_refine (grid {DENSE_GRID}, {DENSE_NITER} steps): {wall:.2f} s, peak device "
            f"memory {peak:.2f} GiB")
        log(f"  vis_results: rc {rc} (rerun-sdk "
            f"{'absent' if importlib.util.find_spec('rerun') is None else 'present'}); "
            + "; ".join(ln.strip() for ln in out.splitlines() if ln.strip()))
    return stats


# ---------------------------------------------------------------- the DAVIS JPEG demo
# DAVIS 480p frames are 854 wide JPEGs; the streams crop them to 848. The
# tracker resizes every window to interp_shape, so K1 and K2 keep
# davis_demo's shapes; the patch coordinates and the BA's image size change
DAVIS_HT, DAVIS_WD = 480, 854
DAVIS_WD_CROP = DAVIS_WD - DAVIS_WD % 16
DAVIS_SCENE = "synth"
JPEG_QUALITY = 90
SIFT_FRAME = 10        # the frame whose ingested patches are held against generate_patches_sift


def phase_davis_jpeg(dev):
    """Phase 10: scripts/demo/run_demo.sh's journey on DAVIS-shaped JPEG
    frames: FRAMES frames of the synthetic scene at 480x854 written as
    JPEG (quality 90) into JPEGImages/480p/<scene>; infer_depth and
    infer_metric_depth at ViT-L width (seeded weights written as the
    released files) and align_depth, no kernel launching; run_slam at
    davis_demo with PATCH_GEN=sift and save_video=true (K1 and K2 counted
    against the code's 4 and 24 per append, and held against their plain
    versions at every launch of the first append; the patches ingested on
    frame SIFT_FRAME held equal to generate_patches_sift's output for that
    frame and generator state; the mp4 read back frame by frame);
    run_refine at run_dense.sh's defaults and vis_results."""
    import batrack_tpu_torch.slam as slam_pkg
    from batrack_tpu_torch.cli import align_depth, run_slam
    from batrack_tpu_torch.data.image import image_size, read_image, write_jpeg
    from batrack_tpu_torch.depth import dpt
    from batrack_tpu_torch.ops.attention import fused_qkv_attention_plain
    from batrack_tpu_torch.ops.corr_kernel import corr_sample_plain
    from batrack_tpu_torch.slam import system
    from batrack_tpu_torch.slam.ingest import generate_patches_sift
    from batrack_tpu_torch.tracker import blocks, mdtracker
    from batrack_tpu_torch.utils.config import full_fp32, load_config
    from batrack_tpu_torch.utils.synth import make_scene
    from batrack_tpu_torch.utils.visualizer import video_frame_count

    t_phase = time.perf_counter()
    config = Path(__file__).resolve().parent / "configs" / "davis_demo.yaml"
    cfg = load_config(str(config), ["slam.PATCH_GEN=sift"])
    _, k1_per, k2_per = launches_per_append(cfg)
    M = cfg.slam.PATCHES_PER_FRAME
    intr = np.array([500.0, 500.0, DAVIS_WD / 2, DAVIS_HT / 2], np.float32)
    images, _, _ = make_scene(FRAMES, DAVIS_HT, DAVIS_WD, intr)
    frames = np.clip(images, 0, 255).astype(np.uint8)
    del images
    stats = {}
    with tempfile.TemporaryDirectory(prefix="batrack_davis_") as tmp:
        root = Path(tmp)
        data_dir = root / "JPEGImages" / "480p"
        img_dir = data_dir / DAVIS_SCENE
        img_dir.mkdir(parents=True)
        t0 = time.perf_counter()
        for t in range(FRAMES):
            write_jpeg(img_dir / f"{t:05d}.jpg", frames[t], JPEG_QUALITY)
        first = read_image(img_dir / "00000.jpg")
        if not image_size(img_dir / "00000.jpg") == first.shape[:2] == (DAVIS_HT, DAVIS_WD):
            raise AssertionError("the JPEG header's size is not the decoded frame's")
        log(f"[davis jpeg] {FRAMES} frames {DAVIS_HT}x{DAVIS_WD} written as JPEG (quality "
            f"{JPEG_QUALITY}) in {time.perf_counter() - t0:.2f} s; frame 0 decodes "
            f"{np.abs(first.astype(int) - frames[0]).mean():.2f} levels from the array written")
        da2, ud, da2_ckpt, ud_ckpt = write_stage1_checkpoints(root)
        x_da2, x_ud = stage1_inputs(first)
        for name, model, x in (("DA2", da2, x_da2), ("UniDepthV2", ud, x_ud)):
            grid = (x.shape[1] // dpt.PATCH, x.shape[2] // dpt.PATCH)
            card = copy.deepcopy(model).to(dev)
            flops = forward_flops(card, x.to(dev))
            del card
            stats[name] = {"input": list(x.shape[1:3]), "grid": list(grid),
                           "tokens": grid[0] * grid[1] + 1, "tflop": flops / 1e12}
            log(f"  {name}: input {x.shape[1]}x{x.shape[2]}, a {grid[0]}x{grid[1]} patch grid, "
                f"{stats[name]['tokens']} tokens, {flops / 1e12:.3f} TFLOP per forward")
        del da2, ud, x_da2, x_ud
        torch.cuda.empty_cache()

        depth_dir = root / "Monodepth"
        zero_all_launches()
        run_stage1_clis(dev, img_dir, depth_dir, DAVIS_SCENE, da2_ckpt, ud_ckpt, stats)
        with contextlib.redirect_stdout(io.StringIO()):
            rc = align_depth.main(["--data_dir", str(data_dir), "--depth_dir", str(depth_dir),
                                   "--save_name", "unidepth_da"])
        stage1 = all_launches()
        if rc != 0 or any(stage1.values()):
            raise AssertionError(f"stage 1: align_depth returned {rc}; launches {stage1} "
                                 "(no kernel may launch)")
        aligned = sorted((depth_dir / "unidepth_da" / DAVIS_SCENE).glob("*.npy"))
        a0 = np.load(aligned[0])
        if len(aligned) != FRAMES or a0.shape != (DAVIS_HT, DAVIS_WD) or not np.isfinite(a0).all():
            raise AssertionError(f"aligned priors: {len(aligned)} of shape {a0.shape}")
        log(f"  align_depth: {len(aligned)} aligned depths {a0.shape}; stage-1 kernel launches "
            f"{json.dumps(stage1)} (all must be 0)")

        savedir, made, sift_log = root / "out", [], []
        checks, check_s = {"k1": [], "k2": []}, [0.0]
        sample, attend, sift = mdtracker.corr_sample, blocks.fused_qkv_attention, \
            system.generate_patches_sift

        class Observed(slam_pkg.BATrack):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        def recording_sift(image_np, *, M, ht, wd, rng):
            state = copy.deepcopy(rng.bit_generator.state)
            out = sift(image_np, M=M, ht=ht, wd=wd, rng=rng)
            keep = len(sift_log) == SIFT_FRAME
            sift_log.append((image_np.copy() if keep else None, state if keep else None,
                             int((out != np.round(out)).any(1).sum())))
            return out

        def sampling(pyr, targets, coords, radius):
            out = sample(pyr, targets, coords, radius)
            if len(checks["k1"]) < k1_per:  # every launch of the first append
                t = time.perf_counter()
                with full_fp32():
                    checks["k1"].append(max_err(out, corr_sample_plain(pyr, targets, coords,
                                                                       radius)))
                check_s[0] += time.perf_counter() - t
            return out

        def attending(qkv, heads, scale, key_mask=None, kv=None):
            out = attend(qkv, heads, scale, key_mask, kv)
            if len(checks["k2"]) < k2_per:
                t = time.perf_counter()
                ref = fused_qkv_attention_plain(qkv, heads, scale, key_mask, kv)
                checks["k2"].append((max_err(out, ref), bf16_tol(ref), tuple(qkv.shape)))
                check_s[0] += time.perf_counter() - t
            return out

        argv = ["--config", str(config), "--device", str(dev), "model.init_dir=",
                f"data.imagedir={img_dir}", f"data.savedir={savedir}",
                f"data.depthdir={depth_dir / 'unidepth_da' / DAVIS_SCENE}",
                f"data.depthdir_gt={depth_dir / 'unidepth_da' / DAVIS_SCENE}",
                f"data.calib={depth_dir / 'unidepth_da_intrinsics' / DAVIS_SCENE}",
                f"data.name={DAVIS_SCENE}", "slam.PATCH_GEN=sift", "save_video=true",
                "save_trajectory=true", "save_plot=false", "save_results=true"]
        zero_all_launches()
        held = torch.cuda.memory_allocated() / 2 ** 30  # left by what ran before, in the peak
        with patched(slam_pkg, "BATrack", Observed), \
                patched(system, "generate_patches_sift", recording_sift), \
                patched(mdtracker, "corr_sample", sampling), \
                patched(blocks, "fused_qkv_attention", attending):
            rc, wall, _, peak, _ = run_cli(run_slam, argv)
        launches = all_launches()
        off_path_launches()
        slam = made[0] if made else None
        appends = slam.append_count if slam else 0
        if (rc != 0 or appends != len(range(0, FRAMES, cfg.slam.kf_stride))
                or launches["corr_sample"] != k1_per * appends
                or launches["fused_qkv_attention"] != k2_per * appends):
            raise AssertionError(f"run_slam returned {rc}; K1 and K2 launched {launches} over "
                                 f"{appends} appends, not {k1_per} and {k2_per} per append")
        stage_ms = {k: round(v, 3) for k, v in slam.timer.ms_per_call().items()}
        fps = FRAMES / (wall - check_s[0])
        kept = [n for _, _, n in sift_log]
        log(f"  run_slam (davis_demo, PATCH_GEN=sift, save_video=true), {FRAMES} frames "
            f"{slam.dims.ht}x{slam.dims.wd}: {wall:.2f} s, {fps:.3f} frames/s without the first "
            f"append's kernel checks ({check_s[0]:.2f} s); launches {json.dumps(launches)} over "
            f"{appends} appends ({k1_per} and {k2_per} per append from the code); peak device "
            f"memory {peak:.2f} GiB, {held:.2f} GiB of it allocated before the CLI started")
        log(f"  CLI stage ms per call (host clock, unsynchronised): {json.dumps(stage_ms)}")
        log(f"  sift: {stage_ms.get('sift', float('nan')):.2f} ms per frame; keypoints kept per "
            f"frame (non-integer coordinates) min {min(kept)}, median "
            f"{statistics.median(kept)}, max {max(kept)} against M={M}")
        if len(sift_log) != FRAMES or (slam.dims.ht, slam.dims.wd) != (DAVIS_HT, DAVIS_WD_CROP):
            raise AssertionError(f"{len(sift_log)} sift calls for {FRAMES} frames at "
                                 f"{slam.dims.ht}x{slam.dims.wd}")
        img, state, _ = sift_log[SIFT_FRAME]
        rng = np.random.default_rng()
        rng.bit_generator.state = state
        again = generate_patches_sift(img, M=M, ht=slam.dims.ht, wd=slam.dims.wd, rng=rng)
        ingested = slam.state.patches[SIFT_FRAME * M:(SIFT_FRAME + 1) * M, :2].cpu().numpy()
        if not np.array_equal(ingested, again):
            raise AssertionError(f"frame {SIFT_FRAME}: the ingested patches are not "
                                 "generate_patches_sift's output")
        log(f"  frame {SIFT_FRAME}: the {M} ingested patch coordinates equal "
            "generate_patches_sift's output for that frame and generator state")
        k1_err = max(checks["k1"])
        check(f"K1 on the JPEG path's first append, {len(checks['k1'])} launches, vs plain",
              k1_err, TOL["k1"])
        k2_err, k2_tol, k2_shape = max(checks["k2"], key=lambda c: c[0] / c[1])
        check(f"K2 on the JPEG path's first append, {len(checks['k2'])} launches at qkv "
              f"{k2_shape}, bf16 vs plain (worst against its limit)", k2_err, k2_tol)
        if len(checks["k1"]) != k1_per or len(checks["k2"]) != k2_per:
            raise AssertionError(f"checked {len(checks['k1'])} K1 and {len(checks['k2'])} K2 "
                                 "launches on the first append")
        video = savedir / DAVIS_SCENE / "sift.mp4"
        n_video = video_frame_count(video) if video.exists() else 0
        log(f"  {video.name}: {n_video} frames read back (cv2.VideoCapture) of {FRAMES} fed, "
            f"{video.stat().st_size / 2 ** 20:.2f} MiB" if video.exists() else "  no mp4 written")
        if n_video != FRAMES:
            raise AssertionError(f"the track video holds {n_video} frames, not {FRAMES}")
        poses = np.loadtxt(savedir / DAVIS_SCENE / "batrack_traj.txt")
        if poses.shape[0] != FRAMES or not np.isfinite(poses).all():
            raise AssertionError(f"trajectory {poses.shape} not finite")

        wall_refine, peak_refine, rc, _ = refine_and_view(dev, savedir, DAVIS_SCENE,
                                                          (DAVIS_HT, DAVIS_WD_CROP))
        log(f"  run_refine (grid {DENSE_GRID}, {DENSE_NITER} steps): {wall_refine:.2f} s, peak "
            f"device memory {peak_refine:.2f} GiB; vis_results rc {rc}")
    seconds = time.perf_counter() - t_phase
    log(f"  phase 10: {seconds:.1f} s")
    return {"stage1": stats, "frames_per_s": fps, "run_slam_s": wall, "stage_ms": stage_ms,
            "sift_keypoints_kept": {"min": min(kept), "median": statistics.median(kept),
                                    "max": max(kept), "M": M},
            "launches": launches, "appends": appends,
            "k1_first_append": {"max_abs_err": k1_err, "launches_checked": len(checks["k1"])},
            "k2_first_append": {"max_abs_err": k2_err, "tolerance": k2_tol,
                                "launches_checked": len(checks["k2"])},
            "mp4_frames": n_video, "peak_gib": peak, "held_before_gib": held,
            "refine_s": wall_refine,
            "seconds": seconds}


DECODE_VARIANTS = ("filtered", "unfiltered", "filtered_threads", "filtered_inline")


def decode_inline(fn, jobs, workers=0):
    """streams._ahead without look-ahead: each job runs when it is read."""
    for job in jobs:
        yield fn(*job)


def decode_threaded(fn, jobs, workers=2):
    """streams._ahead's look-ahead on a pool of `workers` threads."""
    from batrack_tpu_torch.data.streams import DECODE_AHEAD

    with ThreadPoolExecutor(workers) as pool:
        pending = deque()
        for job in jobs:
            pending.append(pool.submit(fn, *job))
            if len(pending) > DECODE_AHEAD:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


def main_decode_ab(rounds: int) -> int:
    """chip_smoke.py --decode-ab: the A/B described in the module docstring."""
    import batrack_tpu_torch.data.streams as streams
    import batrack_tpu_torch.slam as slam_pkg
    from batrack_tpu_torch.cli import run_slam
    from batrack_tpu_torch.data import png
    from batrack_tpu_torch.utils.synth import make_scene

    lines = []

    def record(obj):
        print(json.dumps(obj), flush=True)
        lines.append(obj)

    config = Path(__file__).resolve().parent / "configs" / "davis_demo.yaml"
    images, depths, poses_gt = make_scene(FRAMES, HT, WD, INTR)
    with tempfile.TemporaryDirectory(prefix="batrack_decode_ab_") as tmp:
        root = Path(tmp)
        _, frames = write_sintel_dataset(root / "filtered", images, depths, poses_gt)
        shutil.copytree(root / "filtered", root / "unfiltered")
        for t, path in enumerate(sorted((root / "unfiltered" / "rgb").glob("*.png"))):
            png.write_png(path, frames[t], filters=0)
        data = {v: root / ("unfiltered" if v == "unfiltered" else "filtered")
                for v in DECODE_VARIANTS}
        for name in ("filtered", "unfiltered"):
            pngs = sorted((root / name / "rgb").glob("*.png"))
            t0 = time.perf_counter()
            for t, path in enumerate(pngs):
                if not np.array_equal(png.read_png_rgb(path), frames[t]):
                    raise AssertionError(f"{path} decodes to another array")
            record({"dataset": name, "row_filters": sum(map(png_row_filters, pngs)).tolist(),
                    "decode_ms_per_frame": 1e3 * (time.perf_counter() - t0) / len(pngs)})

        made = []
        shipped, shipped_ahead = slam_pkg.BATrack, streams._ahead

        class Observed(shipped):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        def run(variant, label):
            d, savedir = data[variant], root / "out"
            argv = ["--config", str(config), "model.init_dir=", f"data.imagedir={d / 'rgb'}",
                    f"data.depthdir={d / 'depth'}", f"data.depthdir_gt={d / 'depth_gt'}",
                    f"data.calib={d / 'cam'}", f"data.gt_traj={d / 'cam'}",
                    "data.traj_format=sintel", f"data.savedir={savedir}", "data.name=synth"]
            streams._ahead = {"filtered_threads": decode_threaded,
                              "filtered_inline": decode_inline}.get(variant, shipped_ahead)
            slam_pkg.BATrack = Observed
            made.clear()
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rc = run_slam.main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                slam_pkg.BATrack, streams._ahead = shipped, shipped_ahead
            if rc != 0 or len(made) != 1:
                raise AssertionError(f"run_slam returned {rc}")
            shutil.rmtree(savedir)
            record({"run": label, "variant": variant, "fps": FRAMES / wall, "wall_s": wall,
                    "stage_ms": {k: round(v, 3) for k, v in made[0].timer.ms_per_call().items()}})

        run("filtered", "warm-up")
        for r in range(rounds):
            order = DECODE_VARIANTS if r % 2 == 0 else DECODE_VARIANTS[::-1]
            for v in order[r % 4:] + order[:r % 4]:
                run(v, f"round {r}")

    runs = [ln for ln in lines if ln.get("run", "").startswith("round")]
    summary = {}
    for v in DECODE_VARIANTS:
        mine = [ln for ln in runs if ln["variant"] == v]
        summary[v] = {"fps_median": statistics.median(ln["fps"] for ln in mine),
                      "fps_all": [round(ln["fps"], 3) for ln in mine],
                      "stage_ms_median": {k: statistics.median(ln["stage_ms"][k] for ln in mine)
                                          for k in mine[0]["stage_ms"]}}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    record({"summary": summary, "card": smi})
    out = Path(__file__).resolve().parent / "chiprun_out" / "decode_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text("\n".join(json.dumps(ln) for ln in lines) + "\n")
    print(smi)
    return 0


def main_ranks() -> int:
    """chip_smoke.py --ranks under torchrun: phase_ranks on every rank."""
    import torch.distributed as dist

    from batrack_tpu_torch.ops import cuda_build
    from batrack_tpu_torch.parallel import get_mesh, init_distributed
    from batrack_tpu_torch.utils.config import Config
    from batrack_tpu_torch.utils.synth import make_scene

    init_distributed()
    mesh = get_mesh()
    try:
        if mesh.rank == 0:
            log(f"source sha256 {source_digest()}; torch {torch.__version__} on "
                f"{mesh.size} x {torch.cuda.get_device_name(mesh.device)}")
            cuda_build.build(["corr_sample", "fused_qkv_attention"])
        dist.barrier()
        images, depths, _ = make_scene(FRAMES, HT, WD, INTR)
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(0)
        result = phase_ranks(Config(), images, depths, mesh, gen)
        if result is not None:
            print(json.dumps(result))
    finally:
        dist.destroy_process_group()
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also trace two SLAM frames, five stage-3 steps and one forward "
                             "of each stage-1 network with torch.profiler")
    parser.add_argument("--ranks", action="store_true",
                        help="run only the multi-device path, one process per GPU: "
                             "torchrun --standalone --nproc_per_node N chip_smoke.py --ranks")
    parser.add_argument("--decode-ab", type=int, metavar="ROUNDS", default=0,
                        help="run only the A/B of the frame decode through the CLI, "
                             "ROUNDS rounds of four runs")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU", file=sys.stderr)
        return 1
    if args.ranks:
        return main_ranks()
    if args.decode_ab:
        return main_decode_ab(args.decode_ab)
    from batrack_tpu_torch.ops import cuda_build
    from batrack_tpu_torch.utils.config import Config
    from batrack_tpu_torch.utils.synth import make_scene

    log(f"source sha256 {source_digest()} (chip_smoke.py, scripts/torch_corr_ab.py, "
        "batrack_tpu_torch/ .py .cu)")

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    max_sm = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip().splitlines()[:1]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs, max SM clock "
        f"{max_sm[0] if max_sm else 'not read'} (SFU_OPS_S assumes 132 SMs at 1980 MHz)")

    t0 = time.perf_counter()
    logs = cuda_build.build(["corr_sample", "fused_qkv_attention"])
    log(f"[build] {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'nothing (up to date)'}")
    for name, text in logs.items():
        fn = "?"
        for ln in text.splitlines():
            if "Function properties for" in ln:
                fn = ln.split("Function properties for ")[1].strip()
                fn = next((k for k in ("attention_bf16_wgmma_kernel", "attention_f32_kernel",
                                       "corr_sample_mxu_kernel", "corr_sample_int8_kernel",
                                       "corr") if k in fn), fn[:40])
            elif "spill" in ln or "Used " in ln or "C75" in ln:
                log(f"  {name} {fn}: {ln.replace('ptxas info    :', '').strip()}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    k1, k1_mxu, k1_int8 = phase_k1(dev, gen)
    ab_launches = phase_corr_ab(dev)
    k2 = phase_k2(dev, gen)
    k2kv = phase_k2_kv(dev, gen)
    k3 = phase_k3(dev, gen)
    k4 = phase_k4(dev, gen)
    phase_edges(dev, gen)

    cfg = Config()  # davis_demo defaults
    images, depths, poses_gt = make_scene(FRAMES + 2, HT, WD, INTR)
    tin, flash_launches = phase_tracker(cfg, images, depths, dev, gen)
    launches, fps, poses_at_stage = phase_slam(cfg, images, depths, dev, args.profile)
    ba = phase_ba(cfg, images, depths, dev)
    mesh_launches = phase_mesh(cfg, images, depths, dev, fps, poses_at_stage, ba, tin, gen)
    phase_pipeline(dev)
    phase_refine(dev, FRAMES, cfg.slam.PATCHES_PER_FRAME, cfg.slam.S_local, args.profile)
    stage1 = phase_demo(dev, args.profile)
    log(f"[stage 1] {json.dumps(stage1)}")
    kf = phase_keyframe(images, depths, poses_gt, dev, gen)
    log(f"[keyframe] {json.dumps(kf)}")
    davis = phase_davis_jpeg(dev)
    log(f"[davis jpeg] {json.dumps(davis)}")

    k1["launches"] = launches["corr_sample"]
    k2["launches"] = launches["fused_qkv_attention"]
    k2kv["launches"] = mesh_launches["fused_qkv_attention_kv"]
    # K3 is on no path: phases 4 and 6 each read 0 (checked there), as do
    # K4 and K1's options, whose launches are those of their own paths: the
    # A/B script (phase 2) and the flash-route tracker forward (phase 3)
    k3["launches"] = launches["vmem_attention"] + mesh_launches["vmem_attention"]
    k1_mxu["launches"] = ab_launches["corr_sample_mxu"]
    k1_int8["launches"] = ab_launches["corr_sample_int8"]
    k4["launches"] = flash_launches
    # phase 9: the keyframe / multi-window path's launches, and K2's masked
    # route timed at that path's shape
    k1["launches_keyframe_path"] = kf["launches"]["corr_sample"]
    k1["keyframe_path"] = kf["k1_path"]
    k2["launches_keyframe_path"] = kf["launches"]["fused_qkv_attention"]
    k2["masked_launches_keyframe_path"] = kf["launches"]["fused_qkv_attention_masked"]
    k2["masked"] = kf["k2_masked"]
    # phase 10: the DAVIS JPEG demo's launches and its first append's checks
    k1["launches_davis_jpeg_path"] = davis["launches"]["corr_sample"]
    k1["davis_jpeg_path"] = davis["k1_first_append"]
    k2["launches_davis_jpeg_path"] = davis["launches"]["fused_qkv_attention"]
    k2["davis_jpeg_path"] = davis["k2_first_append"]
    print(json.dumps({"kernels": [k1, k1_mxu, k1_int8, k2, k2kv, k3, k4]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
