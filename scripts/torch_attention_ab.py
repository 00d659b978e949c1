"""A/B of the port's attention kernel on one NVIDIA GPU: an earlier tree
against this one, and the bf16 kernel's two softmax paths.

    python scripts/torch_attention_ab.py --parent DIR [--rounds 1]
        [--widths 48,64,96,128 | --keyframe]

DIR is a checkout of the commit to compare with, for example one unpacked
from `git archive` into build/archive/parent (a directory .gitignore
lists). Each round runs the parent and this tree as separate processes in
the order parent, this, this, parent, so that drift in the host's load
falls on both. Each process builds its tree's kernels and measures, at the
davis_demo shape of the space attention (qkv (12, 2400, 1152) bf16, 8
heads of 48):

- host us per K2 call: the host clock over 50 calls enqueued back to back
  (no synchronise between them), beside one scaled_dot_product_attention
  call's on the split-head layout;
- device ms per K2 call (CUDA events, two interleaved readings each) with
  scale > 0 and no key mask, with the scale negated, and with a key mask
  that is true everywhere. In this tree the first takes the bf16 softmax's
  fast path (maximum on raw logits, scale folded into the exponential's
  FMA), the other two its general path (a select per key, then scale,
  maximum and subtract). Each output's distance to the plain version is
  recorded beside two bf16 ulps;
- chip_smoke.py's phase 4, the davis_demo SLAM loop of that tree:
  frames/s and the synchronised stage ms per call.

With --widths each process instead builds the bf16 attention kernel at
every head dim its tree's wrapper takes, records the kernel's ptxas lines
per build (registers, spills, C75xx advisories; from the process that
built them) and measures only kernels, at the davis_demo rows (12, 2400)
with 8 heads of each listed d: K2 packed against one
scaled_dot_product_attention call on the split-head layout, both by CUDA
events, K2's distance to its plain version beside two bf16 ulps; then at
d 48 with key masks: the keyframe path's shape (12, 4800, 1152) with the
first 2400 keys live (phase 9 of chip_smoke.py: the active tracks, a
prefix) and (12, 2400, 1152) with 80 % of the keys live at random (every
key tile mixed), each beside SDPA with the same boolean mask; and the
float32 route at d 48, (8, 1024) queries against a slim kv= source of 1024
keys (bench_scaling_torch.py's tracker section), beside float32 SDPA.

With --keyframe each process instead runs phase 9a of its tree's
chip_smoke.py, the keyframe path (davis_demo with use_keyframe, S_slam 24:
144 masked K2 launches per append), on the same scene and frames: the
synchronised stage ms per call over frames 32-37, then two more appends
with each tracker call under torch.profiler: its wall ms, the device's
busy ms in it (the kernels' self device time) and K2's share of that.

It prints one JSON line per process, then a summary and the card's name
and power limit, and writes all of it to chiprun_out/torch_attention_ab.json
(torch_attention_ab_widths.json with --widths, torch_attention_ab_keyframe.json
with --keyframe).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out" / "torch_attention_ab.json"


def measure(tree: Path) -> dict:
    """The readings above for the tree at `tree`, in this process."""
    sys.path.insert(0, str(tree))
    os.chdir(tree)
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from batrack_tpu_torch.ops import cuda_build
    from batrack_tpu_torch.ops.attention import fused_qkv_attention, fused_qkv_attention_plain
    from batrack_tpu_torch.utils.config import Config, full_fp32
    from batrack_tpu_torch.utils.synth import make_scene

    lines = []

    def log(*a):
        print(*a, file=sys.stderr, flush=True)
        lines.append(" ".join(str(x) for x in a))
    cs.log = log

    cuda_build.build(["corr_sample", "fused_qkv_attention"])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    heads, d = cs.HEADS, cs.HIDDEN // cs.HEADS
    scale = d ** -0.5
    qkv = torch.randn((cs.S, cs.NQ, 3 * cs.HIDDEN), generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = (x.contiguous() for x in qkv.view(cs.S, cs.NQ, 3, heads, d).permute(2, 0, 3, 1, 4))

    def host_us(fn, n=50):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / n * 1e6

    res = {"tree": str(tree),
           "k2_host_us": host_us(lambda: fused_qkv_attention(qkv, heads, scale)),
           "sdpa_host_us": host_us(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))}
    variants = {"fast": (scale, None), "neg_scale": (-scale, None),
                "mask_all_true": (scale, torch.ones(cs.NQ, dtype=torch.bool, device=dev))}
    errs, ms = {}, {name: [] for name in variants}
    with full_fp32():
        for name, (sc, m) in variants.items():
            ref = fused_qkv_attention_plain(qkv, heads, sc, m)
            errs[name] = [cs.max_err(fused_qkv_attention(qkv, heads, sc, m), ref),
                          cs.bf16_tol(ref)]
    for _ in range(2):
        for name, (sc, m) in variants.items():
            ms[name].append(cs.cuda_ms(
                lambda sc=sc, m=m: fused_qkv_attention(qkv, heads, sc, m), reps=30))
    res.update(k2_ms=ms, k2_err_and_tol=errs)
    del qkv, q, k, v
    torch.cuda.empty_cache()

    images, depths, _ = make_scene(cs.FRAMES + 2, cs.HT, cs.WD, cs.INTR)
    launches, fps, _ = cs.phase_slam(Config(), images, depths, dev)
    stage = next(ln for ln in lines if "stage ms per call" in ln)
    res.update(frames_per_s=fps, stage_ms=json.loads(stage.split("): ", 1)[1]),
               launches=launches)
    return res


def measure_widths(tree: Path, dims) -> dict:
    """The --widths readings above for the tree at `tree`, in this process."""
    sys.path.insert(0, str(tree))
    os.chdir(tree)
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from batrack_tpu_torch.ops import cuda_build
    from batrack_tpu_torch.ops.attention import (KERNEL_HEAD_DIMS, fused_qkv_attention,
                                                 fused_qkv_attention_plain)
    from batrack_tpu_torch.utils.config import full_fp32

    cs.log = lambda *a: print(*a, file=sys.stderr, flush=True)
    logs = cuda_build.build([cuda_build.spec("fused_qkv_attention", HEAD_DIM=d)
                             for d in KERNEL_HEAD_DIMS])
    ptxas = {name: [f"{fn[-12:]}: {ln[:160]}" for fn, ln in lines
                    if "attention_bf16_wgmma_kernel" in fn]
             for name, lines in cuda_build.ptxas_lines(logs).items()}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    res = {"tree": str(tree), "ptxas_bf16": ptxas, "k2": {}}

    def reading(qkv, heads, mask=None, kv=None):
        B, N, C3 = qkv.shape
        d = C3 // 3 // heads
        scale = d ** -0.5
        with full_fp32():
            ref = fused_qkv_attention_plain(qkv, heads, scale, mask, kv=kv)
            out = fused_qkv_attention(qkv, heads, scale, mask, kv=kv)
            err = [cs.max_err(out, ref),
                   cs.bf16_tol(ref) if qkv.dtype == torch.bfloat16 else cs.TOL["k2_f32"]]
        q, k, v = (x.contiguous() for x in qkv.view(B, N, 3, heads, d).permute(2, 0, 3, 1, 4))
        if kv is not None:
            k, v = (x.contiguous() for x in kv.view(B, -1, 2, heads, d).permute(2, 0, 3, 1, 4))
        attn_mask = None if mask is None else mask[None, None, None, :]
        ms, sdpa_ms = [], []
        for _ in range(2):
            ms.append(cs.cuda_ms(lambda: fused_qkv_attention(qkv, heads, scale, mask, kv=kv),
                                 reps=30))
            sdpa_ms.append(cs.cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, scale=scale), reps=30))
        return {"ms": ms, "sdpa_ms": sdpa_ms, "err_and_tol": err}

    for d in dims:
        qkv = torch.randn((cs.S, cs.NQ, 3 * cs.HEADS * d), generator=gen, device=dev)
        res["k2"][f"d{d}"] = reading(qkv.to(torch.bfloat16), cs.HEADS)
    qkv = torch.randn((cs.S, 2 * cs.NQ, 3 * cs.HIDDEN), generator=gen, device=dev)
    prefix = torch.arange(2 * cs.NQ, device=dev) < cs.NQ
    res["k2"]["masked_prefix_4800"] = reading(qkv.to(torch.bfloat16), cs.HEADS, prefix)
    qkv = torch.randn((cs.S, cs.NQ, 3 * cs.HIDDEN), generator=gen, device=dev)
    rand = torch.rand((cs.NQ,), generator=gen, device=dev) > 0.2
    res["k2"]["masked_random_2400"] = reading(qkv.to(torch.bfloat16), cs.HEADS, rand)
    # the float32 route at bench_scaling_torch.py's tracker section: (8, 1024)
    # queries against a slim kv= source of 1024 keys
    with full_fp32():
        qkv = torch.randn((cs.SCALING_S, cs.SCALING_TRACKS, 3 * cs.HIDDEN), generator=gen,
                          device=dev)
        kv = torch.randn((cs.SCALING_S, cs.SCALING_TRACKS, 2 * cs.HIDDEN), generator=gen,
                         device=dev)
        res["k2"]["f32_kv_slim_1024"] = reading(qkv, cs.HEADS, kv=kv)
    return res


def measure_keyframe(tree: Path) -> dict:
    """The --keyframe readings above for the tree at `tree`, in this process."""
    sys.path.insert(0, str(tree))
    os.chdir(tree)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from batrack_tpu_torch.ops import cuda_build
    from batrack_tpu_torch.slam import BATrack
    from batrack_tpu_torch.tracker import MDTrackerAdapter
    from batrack_tpu_torch.utils.profiling import StageTimer
    from batrack_tpu_torch.utils.synth import make_scene

    cuda_build.build(["corr_sample", "fused_qkv_attention"])
    dev = torch.device("cuda", 0)
    images, depths, _ = make_scene(cs.FRAMES, cs.HT, cs.WD, cs.INTR)
    cfg = cs.keyframe_config()
    slam = BATrack(cfg, cs.HT, cs.WD, seed=0, device=dev)
    slam.tracker = MDTrackerAdapter(
        cfg.model, seed=0, device=dev,
        backward_tracking=cfg.slam.backward_tracking and cfg.slam.S_slam > cfg.model.S)
    for t in range(cs.STAGE_FROM):
        slam(t, images[t], depths[t], cs.INTR)
    slam.timer = StageTimer(enabled=True, sync=True)
    for t in range(cs.STAGE_FROM, cs.FRAMES - 2):
        slam(t, images[t], depths[t], cs.INTR)
    torch.cuda.synchronize()
    stage_ms = slam.timer.ms_per_call()
    slam.timer = StageTimer()

    calls = []
    plain = type(slam.tracker)

    class Profiled(plain):
        def __call__(self, tin):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = plain.__call__(self, tin)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            calls.append({
                "wall_ms": wall,
                "busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
                "k2_ms": sum(e.self_device_time_total for e in kernels
                             if "attention_bf16_wgmma_kernel" in e.key) / 1e3,
                "k2_launches": sum(e.count for e in kernels
                                   if "attention_bf16_wgmma_kernel" in e.key),
                "launches": sum(e.count for e in kernels)})
            return out

    slam.tracker.__class__ = Profiled
    for t in range(cs.FRAMES - 2, cs.FRAMES):
        slam(t, images[t], depths[t], cs.INTR)
    return {"tree": str(tree), "stage_ms": stage_ms, "profiled_tracker_calls": calls}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, help="checkout of the tree to compare with")
    parser.add_argument("--rounds", type=int, default=1,
                        help="rounds of parent, this, this, parent")
    parser.add_argument("--widths", help="kernels only: K2 at these head dims (comma "
                        "separated) and with key masks, and each build's ptxas lines")
    parser.add_argument("--keyframe", action="store_true",
                        help="the keyframe path (chip_smoke.py phase 9a): tracker stage ms "
                             "and the device's busy share in its calls")
    parser.add_argument("--one", type=Path, help=argparse.SUPPRESS)  # a child process
    args = parser.parse_args()
    dims = [int(d) for d in args.widths.split(",")] if args.widths else None
    mode = ["--widths", args.widths] if dims else (["--keyframe"] if args.keyframe else [])
    import torch

    if not torch.cuda.is_available():
        print("torch_attention_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.one is not None:
        tree = args.one.resolve()
        res = (measure_widths(tree, dims) if dims
               else measure_keyframe(tree) if args.keyframe else measure(tree))
        print(json.dumps(res), flush=True)
        return 0
    if args.parent is None or not (args.parent / "chip_smoke.py").exists():
        parser.error("--parent must name a checkout that holds chip_smoke.py")

    trees = {"parent": args.parent.resolve(), "this": ROOT}
    runs = []
    for which in ["parent", "this", "this", "parent"] * args.rounds:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one",
                               str(trees[which])] + mode,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
            raise SystemExit(f"{which} failed with code {proc.returncode}")
        run = {"which": which, **json.loads(proc.stdout.strip().splitlines()[-1])}
        print(json.dumps(run), flush=True)
        runs.append(run)

    summary = {}
    for which in trees:
        mine = [r for r in runs if r["which"] == which]
        if args.keyframe:
            summary[which] = {
                "tracker_ms": [r["stage_ms"]["tracker"] for r in mine],
                **{key: [c[key] for r in mine for c in r["profiled_tracker_calls"]]
                   for key in ("wall_ms", "busy_ms", "k2_ms", "k2_launches")}}
            continue
        if dims:
            summary[which] = {
                name: {"ms": sum((r["k2"][name]["ms"] for r in mine), []),
                       "sdpa_ms": sum((r["k2"][name]["sdpa_ms"] for r in mine), []),
                       "err_and_tol": [r["k2"][name]["err_and_tol"] for r in mine]}
                for name in mine[0]["k2"]}
            continue
        summary[which] = {
            "frames_per_s": [r["frames_per_s"] for r in mine],
            "tracker_ms": [r["stage_ms"].get("tracker") for r in mine],
            "ba_update_ms": [r["stage_ms"].get("ba_update") for r in mine],
            "k2_host_us": [r["k2_host_us"] for r in mine],
            "sdpa_host_us": [r["sdpa_host_us"] for r in mine],
            **{f"k2_ms_{v}": sum((r["k2_ms"][v] for r in mine), []) for v in mine[0]["k2_ms"]}}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"summary": summary}))
    print(smi)
    out = (OUT.with_name("torch_attention_ab_widths.json") if dims
           else OUT.with_name("torch_attention_ab_keyframe.json") if args.keyframe else OUT)
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"runs": runs, "summary": summary, "card": smi}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
