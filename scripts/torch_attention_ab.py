"""A/B of the port's attention kernel on one NVIDIA GPU: an earlier tree
against this one, and the bf16 kernel's two softmax paths.

    python scripts/torch_attention_ab.py --parent DIR [--rounds 1]

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

It prints one JSON line per process, then a summary and the card's name
and power limit, and writes all of it to chiprun_out/torch_attention_ab.json.
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, help="checkout of the tree to compare with")
    parser.add_argument("--rounds", type=int, default=1,
                        help="rounds of parent, this, this, parent")
    parser.add_argument("--one", type=Path, help=argparse.SUPPRESS)  # a child process
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_attention_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.one is not None:
        print(json.dumps(measure(args.one.resolve())), flush=True)
        return 0
    if args.parent is None or not (args.parent / "chip_smoke.py").exists():
        parser.error("--parent must name a checkout that holds chip_smoke.py")

    trees = {"parent": args.parent.resolve(), "this": ROOT}
    runs = []
    for which in ["parent", "this", "this", "parent"] * args.rounds:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one",
                               str(trees[which])], capture_output=True, text=True, timeout=900)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
            raise SystemExit(f"{which} failed with code {proc.returncode}")
        run = {"which": which, **json.loads(proc.stdout.strip().splitlines()[-1])}
        print(json.dumps(run), flush=True)
        runs.append(run)

    summary = {}
    for which in trees:
        mine = [r for r in runs if r["which"] == which]
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
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps({"runs": runs, "summary": summary, "card": smi}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
