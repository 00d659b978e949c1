#!/usr/bin/env python3
"""Smoke run of batrack_tpu_torch on one NVIDIA GPU (H100 class).

    python3 chip_smoke.py [--profile]

Phases, each of which fails the run when it fails:

1. build the hand-written CUDA kernels from batrack_tpu_torch/csrc/ (one
   nvcc per source, all started together);
2. K1 (correlation windows) and K2 (packed-qkv attention) at the davis_demo
   shapes of the sparse-SLAM path, each held against its plain PyTorch
   version on the same inputs with TF32 off (K1 on its bf16 maps, K2 in
   bf16 and in float32), and timed beside its plain version, a PyTorch
   library call where one exists (K2: scaled_dot_product_attention on the
   split-head layout) and the least time the card could take (`bound_ms`);
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
   copy as a witness of the system's conditioning.

It then prints one {"kernels": [...]} line, the card's name and power limit
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
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM3 bytes/s,
# bf16 tensor-core FLOP/s, float32 FLOP/s outside the tensor cores, and the
# special-function units' exp rate (132 SMs x 16 per clock x 1.83 GHz)
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
SFU_OPS_S = 132 * 16 * 1.83e9

# davis_demo shapes of the tracker append (configs/davis_demo.yaml)
S, C, H4, W4, LEVELS, RADIUS = 12, 128, 96, 128, 4, 3
NQ = 6 * 400                      # n_src source frames x PATCHES_PER_FRAME
HIDDEN, HEADS = 384, 8
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
    """sha256 over this script and every .py/.cu file of batrack_tpu_torch/."""
    root = Path(__file__).resolve().parent
    files = [root / "chip_smoke.py"] + sorted(
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
    return (a.float() - b.float()).abs().max().item()


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

        def run(*args):
            x = fn(*args)
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
def phase_k1(dev, gen):
    from batrack_tpu_torch.ops.corr import build_pyramid
    from batrack_tpu_torch.ops.corr_kernel import corr_sample, corr_sample_plain, pack_pyramid
    from batrack_tpu_torch.utils.config import full_fp32

    log(f"[K1] corr_sample: fmaps ({S}, {C}, {H4}, {W4}) x {LEVELS} levels, "
        f"targets ({NQ}, {S}, {C}) f32, coords ({S}, {NQ}, 2)")
    fm = torch.randn((S, C, H4, W4), generator=gen, device=dev)
    targets = torch.randn((NQ, S, C), generator=gen, device=dev)
    # track positions over the map plus a margin: some windows cross the edge
    u = torch.rand((S, NQ, 2), generator=gen, device=dev)
    coords = torch.stack([u[..., 0] * (W4 + 8) - 4, u[..., 1] * (H4 + 8) - 4], -1)

    # the maps are stored in bf16 whatever the tracker's dtype (pack_pyramid),
    # and targets, coords and output are float32, so K1 has one variant
    with full_fp32():
        pyr = pack_pyramid(build_pyramid(fm, LEVELS))
        out = corr_sample(pyr, targets, coords, RADIUS)
        torch.cuda.synchronize()
        assert out.shape == (NQ, S, LEVELS * (2 * RADIUS + 1) ** 2)
        err = max_err(out, corr_sample_plain(pyr, targets, coords, RADIUS))
        check("K1 vs plain, bf16 maps, float32 sums", err, TOL["k1"])
        ms = cuda_ms(lambda: corr_sample(pyr, targets, coords, RADIUS), reps=50)
        plain_ms = cuda_ms(lambda: corr_sample_plain(pyr, targets, coords, RADIUS), reps=5)

    # bound: every input read once, the output written once; operations are
    # the float32 multiply-adds of the taps that lie in the map (out-of-map
    # taps are zero and skipped) plus the 2x2 blend and scale per output
    D = 2 * RADIUS + 2
    off = torch.arange(D, device=dev, dtype=torch.float32)
    taps = 0
    for lvl, (h, w) in enumerate(pyr.shapes):
        c = coords / 2.0 ** lvl
        xs = torch.floor(c[..., 0:1]) - RADIUS + off
        ys = torch.floor(c[..., 1:2]) - RADIUS + off
        nx = ((xs >= 0) & (xs < w)).sum(-1)
        ny = ((ys >= 0) & (ys < h)).sum(-1)
        taps += int((nx * ny).sum().item())
    n_out = NQ * S * LEVELS * (2 * RADIUS + 1) ** 2
    flops = 2 * C * taps + 8 * n_out
    nbytes = pyr.flat.numel() * 2 + targets.numel() * 4 + coords.numel() * 4 + n_out * 4
    bound_ms, bound_by = bound(nbytes, [flops / F32_FLOPS])
    log(f"  kernel_ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms null  bound_ms "
        f"{bound_ms:.4f} ({bound_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP f32)")
    return {"name": "corr_sample", "route": "cuda",
            "source": "batrack_tpu_torch/csrc/corr_sample.cu",
            "replaces": "batrack_tpu/ops/pallas_corr.py:52",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


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
    ms = cuda_ms(lambda: fused_qkv_attention(qkv, HEADS, scale), reps=10)
    plain_ms = cuda_ms(lambda: fused_qkv_attention_plain(qkv, HEADS, scale), reps=3)
    q, k, v = (x.contiguous() for x in qkv.view(S, NQ, 3, HEADS, d).permute(2, 0, 3, 1, 4))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), reps=10)

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


def phase_tracker(cfg, images, depths, dev, gen):
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
        del ad


# ---------------------------------------------------------------- main path
def profile_frames(slam, images, depths, frames):
    """Device time by kernel over `frames` (one append and its updates) from
    torch.profiler, and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in frames:
            slam(t, images[t], depths[t], INTR)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"[profile] frames {frames[0]}-{frames[-1]}: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f} %), {sum(e.count for e in kernels)} "
        "kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d} x  {e.key[:110]}")


def phase_slam(cfg, images, depths, dev, profile=False):
    from batrack_tpu_torch.ops.attention import fused_qkv_attention
    from batrack_tpu_torch.ops.corr_kernel import corr_sample
    from batrack_tpu_torch.slam import BATrack
    from batrack_tpu_torch.tracker import MDTrackerAdapter
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
    t0 = time.perf_counter()
    for t in range(STAGE_FROM):
        if t == STEADY_FROM:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        slam(t, images[t], depths[t], INTR)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    slam.timer = StageTimer(enabled=True, sync=True)
    for t in range(STAGE_FROM, FRAMES):
        slam(t, images[t], depths[t], INTR)
    torch.cuda.synchronize()
    launches = {"corr_sample": corr_sample.launches,
                "fused_qkv_attention": fused_qkv_attention.launches}
    stage_ms = {k: round(v, 3) for k, v in slam.timer.ms_per_call().items()}
    n_frames = FRAMES
    if profile:
        slam.timer = StageTimer(enabled=False)
        profile_frames(slam, images, depths, [FRAMES, FRAMES + 1])
        n_frames += 2

    poses, tstamps = slam.terminate()
    res = slam.get_results()
    fps = (STAGE_FROM - STEADY_FROM) / (t_end - t_steady)
    log(f"  launches {launches}")
    log(f"  frames/s {fps:.3f} (frames {STEADY_FROM}-{STAGE_FROM - 1}, after "
        f"{STEADY_FROM} warm-up frames incl. init; whole run {t_end - t0:.1f} s)")
    log(f"  stage ms per call (synchronised, frames {STAGE_FROM}-{FRAMES - 1}): "
        f"{json.dumps(stage_ms)}")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    log(f"  edges with weight > 0: {int((slam.state.e_weight[:, 0] > 0).sum())} (random "
        "weights put no track over the visibility gate; [ba] runs live edges)")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if poses.shape != (n_frames, 7) or not np.isfinite(poses).all():
        raise AssertionError(f"trajectory {poses.shape} not finite")
    if not np.allclose(np.linalg.norm(poses[:, 3:], axis=1), 1.0, atol=1e-4):
        raise AssertionError("trajectory quaternions are not unit")
    if (not np.array_equal(tstamps, np.arange(n_frames))
            or res["cams_T_world"].shape != (n_frames, 4, 4)):
        raise AssertionError("results do not cover every frame")
    return launches


# ---------------------------------------------------------------- backend
def phase_ba(cfg, images, depths, dev):
    from batrack_tpu_torch.slam import BATrack
    from batrack_tpu_torch.slam.state import SLAMState
    from batrack_tpu_torch.slam.update import slam_update
    from batrack_tpu_torch.tracker import MDTrackerAdapter
    from batrack_tpu_torch.utils.config import full_fp32
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

    def on_cpu(state):
        return SLAMState(**{f.name: getattr(state, f.name).cpu().clone()
                            for f in dataclasses.fields(state)})

    cpu, jit = on_cpu(st), on_cpu(st)
    u = torch.rand(jit.e_target.shape, generator=torch.Generator().manual_seed(1)) * 2 - 1
    jit.e_target.mul_(1 + torch.finfo(torch.float32).eps * u)
    slam.update()
    card = on_cpu(st)
    t0 = time.perf_counter()
    with full_fp32():
        for state in (cpu, jit):
            slam_update(state, n, True, slam.dims, cfg.slam)
    cpu_s = (time.perf_counter() - t0) / 2

    def diffs(a):
        return {"poses": max_err(a.poses[:n], cpu.poses[:n]),
                "patches": max_err(a.patches[: n * M], cpu.patches[: n * M]),
                "weight_flips": int(((a.e_weight[:, 0] > 0) != (cpu.e_weight[:, 0] > 0)).sum())}
    got, wit = diffs(card), diffs(jit)
    log(f"  one update, card vs CPU {json.dumps(got)}; witness, CPU vs CPU with e_target "
        f"jittered by one float32 rounding {json.dumps(wit)} (CPU update {cpu_s:.1f} s)")
    for k in ("poses", "patches"):
        check(f"backend update, card vs CPU, {k}", got[k],
              max(TOL["ba_floor"], TOL["ba_witness_factor"] * wit[k]))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also trace two SLAM frames with torch.profiler")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU", file=sys.stderr)
        return 1
    from batrack_tpu_torch.ops import cuda_build
    from batrack_tpu_torch.utils.config import Config
    from batrack_tpu_torch.utils.synth import make_scene

    log(f"source sha256 {source_digest()} (chip_smoke.py + batrack_tpu_torch/ .py .cu)")

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = cuda_build.build(["corr_sample", "fused_qkv_attention"])
    log(f"[build] {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'nothing (up to date)'}")
    for name, text in logs.items():
        regs = sorted({ln.split("Used ")[1].split(",")[0] for ln in text.splitlines()
                       if "Used " in ln})
        log(f"  {name}: {regs}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    k1 = phase_k1(dev, gen)
    k2 = phase_k2(dev, gen)

    cfg = Config()  # davis_demo defaults
    images, depths, _ = make_scene(FRAMES + 2, HT, WD, INTR)
    phase_tracker(cfg, images, depths, dev, gen)
    launches = phase_slam(cfg, images, depths, dev, args.profile)
    phase_ba(cfg, images, depths, dev)

    k1["launches"] = launches["corr_sample"]
    k2["launches"] = launches["fused_qkv_attention"]
    print(json.dumps({"kernels": [k1, k2]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
