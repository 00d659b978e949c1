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
   phase 5's witness.

With --ranks, under torchrun (one process per GPU), it runs only the
multi-device path at the group's world size: a tracker forward held
against the single-device one, the SLAM loop with live edges, timed, and
one patch-sharded backend update of its final state against the CPU
update (README).

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
import os
import subprocess
import sys
import time
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
    # the work every variant must do: the (2r+2)^2 integer taps of each
    # window that lie in its level's map (out-of-map taps are zero: the vpu
    # kernels skip them, the mxu kernel multiplies zero rows) and the
    # (2r+1)^2 outputs of each window
    off = torch.arange(2 * RADIUS + 2, device=dev, dtype=torch.float32)
    taps = 0
    for lvl, fl in enumerate(pyramid):
        c = coords / 2.0 ** lvl
        xs = torch.floor(c[..., 0:1]) - RADIUS + off
        ys = torch.floor(c[..., 1:2]) - RADIUS + off
        nx = ((xs >= 0) & (xs < fl.shape[3])).sum(-1)
        ny = ((ys >= 0) & (ys < fl.shape[2])).sum(-1)
        taps += int((nx * ny).sum().item())
    n_out = NQ * S * LEVELS * (2 * RADIUS + 1) ** 2
    # what the main kernel reads beside the bound's bytes: its in-map taps
    # (256 bytes each, read from shared memory for resident levels and
    # through the L2 for streamed ones) and the copies of the resident
    # levels' maps, one per (frame, chunk of RES_CHUNK tracks)
    shapes = [tuple(fl.shape[2:]) for fl in pyramid]
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
        # bound: every input read once (1 byte per int8 map element, and the
        # (L,) scales), the output written once; operations are the window
        # products of the in-map taps, on the bf16 tensor cores for mxu, and
        # the 2x2 blend and scale per output
        nbytes = (pyr.flat.numel() * pyr.flat.element_size() + targets.numel() * 4
                  + coords.numel() * 4 + n_out * 4 + (LEVELS * 4 if fd == "int8" else 0))
        if ct == "mxu":
            ops = [2 * C * taps / BF16_FLOPS, 8 * n_out / F32_FLOPS]
        else:
            ops = [(2 * C * taps + 8 * n_out) / F32_FLOPS]
        bound_ms, bound_by = bound(nbytes, ops)
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
    witness of that state (as phase 5)."""
    import torch.distributed as dist

    from batrack_tpu_torch.ops.attention import fused_qkv_attention
    from batrack_tpu_torch.ops.corr_kernel import corr_sample
    from batrack_tpu_torch.parallel import sharded_slot_slam_update
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
              "ba_update_vs_cpu": ba_got, "ba_update_witness": ba_wit}
    log(f"  {json.dumps(result)}")
    if not (np.isfinite(poses).all() and launches["corr_sample"]
            and launches["fused_qkv_attention_kv"] >= slam.append_count):
        raise AssertionError(f"trajectory not finite or a kernel did not launch: {launches}")
    return result


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
                        help="also trace two SLAM frames with torch.profiler")
    parser.add_argument("--ranks", action="store_true",
                        help="run only the multi-device path, one process per GPU: "
                             "torchrun --standalone --nproc_per_node N chip_smoke.py --ranks")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU", file=sys.stderr)
        return 1
    if args.ranks:
        return main_ranks()
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
    images, depths, _ = make_scene(FRAMES + 2, HT, WD, INTR)
    tin, flash_launches = phase_tracker(cfg, images, depths, dev, gen)
    launches, fps, poses_at_stage = phase_slam(cfg, images, depths, dev, args.profile)
    ba = phase_ba(cfg, images, depths, dev)
    mesh_launches = phase_mesh(cfg, images, depths, dev, fps, poses_at_stage, ba, tin, gen)

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
    print(json.dumps({"kernels": [k1, k1_mxu, k1_int8, k2, k2kv, k3, k4]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
