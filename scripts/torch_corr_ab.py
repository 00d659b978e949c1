"""A/B of the correlation kernel K1 on one NVIDIA GPU: its variants in this
tree, or this tree's main kernel against an earlier tree's.

    python scripts/torch_corr_ab.py [--reps 20] [--seed 0]
    python scripts/torch_corr_ab.py --parent DIR [--rounds 1] [--reps 50]

Without --parent it compares K1's variants: bf16 maps with the float32
contraction (bf16/vpu, the tracker's), bf16 maps with the tensor-core
contraction (bf16/mxu) and int8 maps (int8/vpu). It is the counterpart of
scripts/corr_ab.py for batrack_tpu_torch, and the path that selects K1's
two options (no config of either package does). Same shape: S=12 frames,
C=128 channels, 96x128 maps in bf16, N=2400 tracks, radius 3, 4 levels;
random normal maps and targets and coordinates over the map +-4, from the
seed. Each variant's kernel is first held against its plain version on the
same inputs (1e-4: exact products, sums in another order); a mismatch stops
the script before anything is timed. Then each variant is timed with CUDA
events: ms per pyramid (build_pyramid + pack_pyramid + corr_sample, what
corr_ab.py times) and ms per corr_sample call on the packed pyramid, with
its output's largest difference from the bf16/vpu output. Last, the
bf16/vpu kernel is timed on the levels it streams alone and on the levels
it keeps in shared memory alone. corr_ab.py's
`group` and `block_n` axes tune the TPU kernel's track loop for Mosaic and
have no counterpart here.

With --parent, DIR is a checkout of the commit to compare with (for
example one unpacked from `git archive` into build/archive/parent, a
directory .gitignore lists). Each round runs the parent's and this tree's
bf16/vpu kernel as separate processes in the order parent, this, this,
parent, on the same inputs. Each process builds its tree's kernels and
records the kernel's distance to its plain version, device ms per call and
per pyramid (CUDA events, three readings each), and host us per call (the
host clock over 50 calls enqueued back to back, no synchronise between
them). It prints one JSON line per process, then a summary and the card's
name and power limit, and writes all of it to chiprun_out/torch_corr_ab.json.
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
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
OUT = ROOT / "chiprun_out" / "torch_corr_ab.json"

# chip_smoke imports no module of batrack_tpu_torch at its top, so a --one
# child can still import the package of the tree it measures
from chip_smoke import cuda_ms  # noqa: E402

S, C, H, W, N, R, L = 12, 128, 96, 128, 2400, 3, 4
VARIANTS = (("bf16", "vpu"), ("bf16", "mxu"), ("int8", "vpu"))
TOL = 1e-4


def inputs(dev, seed: int):
    """bf16 maps (S, C, H, W), float32 targets (N, S, C) and coords (S, N, 2)."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    fmaps = torch.randn((S, C, H, W), generator=gen, device=dev).to(torch.bfloat16)
    targets = torch.randn((N, S, C), generator=gen, device=dev)
    u = torch.rand((S, N, 2), generator=gen, device=dev)
    coords = torch.stack([u[..., 0] * (W + 8) - 4, u[..., 1] * (H + 8) - 4], -1)
    return fmaps, targets, coords


def run(dev, reps: int = 20, seed: int = 0, log=print) -> list:
    """Parity of every variant, then its times. Returns one dict per variant."""
    from batrack_tpu_torch.ops.corr import build_pyramid
    from batrack_tpu_torch.ops.corr_kernel import corr_sample, corr_sample_plain, pack_pyramid
    from batrack_tpu_torch.utils.config import full_fp32

    fmaps, targets, coords = inputs(dev, seed)
    pyramid = build_pyramid(fmaps, L)
    packed = {fd: pack_pyramid(pyramid, fd) for fd in ("bf16", "int8")}
    outs, errs = {}, {}
    with full_fp32():
        for fd, ct in VARIANTS:
            outs[fd, ct] = corr_sample(packed[fd], targets, coords, R, contract=ct)
            ref = corr_sample_plain(packed[fd], targets, coords, R, contract=ct)
            errs[fd, ct] = (outs[fd, ct] - ref).abs().max().item()
            log(f"parity {fd}/{ct}: max |kernel - plain| {errs[fd, ct]:.3e} (limit {TOL:g})")
            if not errs[fd, ct] <= TOL:
                raise AssertionError(f"{fd}/{ct}: kernel differs from its plain version by "
                                     f"{errs[fd, ct]} > {TOL}; nothing timed")
    rows = []
    for fd, ct in VARIANTS:
        pyr = packed[fd]

        def whole(fd=fd, ct=ct):
            return corr_sample(pack_pyramid(build_pyramid(fmaps, L), fd), targets, coords, R,
                               contract=ct)

        row = {"fmap_dtype": fd, "contract": ct,
               "ms_per_pyramid": cuda_ms(whole, reps),
               "ms_per_sample": cuda_ms(lambda: corr_sample(pyr, targets, coords, R,
                                                            contract=ct), reps),
               "maxdiff_vs_bf16_vpu": (outs[fd, ct] - outs["bf16", "vpu"]).abs().max().item(),
               "err_vs_plain": errs[fd, ct]}
        log(f"{fd:5s} {ct}  {row['ms_per_pyramid']:8.4f} ms/pyramid  "
            f"{row['ms_per_sample']:8.4f} ms/sample  maxdiff={row['maxdiff_vs_bf16_vpu']:.2e}")
        rows.append(row)
    return rows


def by_level_kind(dev, reps: int = 20, seed: int = 0, log=print) -> dict:
    """ms per call of the bf16/vpu kernel on the levels it streams alone and
    on the levels it keeps in shared memory alone (a sub-pyramid of
    consecutive levels, sampled at coords / 2^first so each level sees the
    same windows as in the whole pyramid), beside the whole pyramid."""
    from batrack_tpu_torch.ops.corr import build_pyramid
    from batrack_tpu_torch.ops.corr_kernel import corr_sample, pack_pyramid, resident_levels

    fmaps, targets, coords = inputs(dev, seed)
    pyramid = build_pyramid(fmaps, L)
    resident = resident_levels([tuple(fm.shape[2:]) for fm in pyramid], C)
    first = resident.index(True) if True in resident else L
    parts = {"whole": (0, L), "streamed": (0, first), "resident": (first, L)}
    res = {}
    for name, (lo, hi) in parts.items():
        if lo == hi:
            continue
        pyr = pack_pyramid(pyramid[lo:hi])
        xy = coords / 2.0 ** lo
        res[name] = cuda_ms(lambda: corr_sample(pyr, targets, xy, R), reps)
        log(f"bf16/vpu, levels {lo}-{hi - 1} ({name}): {res[name]:.4f} ms per call")
    return res


def measure(tree: Path, reps: int, seed: int) -> dict:
    """The --parent readings of the bf16/vpu kernel of the tree at `tree`,
    in this process (which must not have imported another tree's package)."""
    sys.path.insert(0, str(tree))
    os.chdir(tree)
    import torch

    from batrack_tpu_torch.ops import cuda_build
    from batrack_tpu_torch.ops.corr import build_pyramid
    from batrack_tpu_torch.ops.corr_kernel import corr_sample, corr_sample_plain, pack_pyramid
    from batrack_tpu_torch.utils.config import full_fp32

    cuda_build.build(["corr_sample"])
    dev = torch.device("cuda", 0)
    fmaps, targets, coords = inputs(dev, seed)
    pyr = pack_pyramid(build_pyramid(fmaps, L))
    with full_fp32():
        err = (corr_sample(pyr, targets, coords, R)
               - corr_sample_plain(pyr, targets, coords, R)).abs().max().item()

    def call():
        return corr_sample(pyr, targets, coords, R)

    def whole():
        return corr_sample(pack_pyramid(build_pyramid(fmaps, L)), targets, coords, R)

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

    before = corr_sample.launches
    res = {"tree": str(tree), "err_vs_plain": err,
           "ms_per_sample": [cuda_ms(call, reps) for _ in range(3)],
           "ms_per_pyramid": [cuda_ms(whole, reps) for _ in range(3)],
           "host_us_per_sample": host_us(call)}
    res["launches"] = corr_sample.launches - before
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=None,
                        help="calls per reading (default 20, or 50 with --parent)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--parent", type=Path, help="checkout of the tree to compare with")
    parser.add_argument("--rounds", type=int, default=1,
                        help="with --parent: rounds of parent, this, this, parent")
    parser.add_argument("--one", type=Path, help=argparse.SUPPRESS)  # a child process
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_corr_ab: no CUDA device; the kernels run only on the GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    if args.one is not None:
        print(json.dumps(measure(args.one.resolve(), args.reps or 50, args.seed)), flush=True)
        return 0
    if args.parent is None:
        reps = args.reps or 20
        print(f"{torch.cuda.get_device_name(0)} ({smi or 'nvidia-smi not read'}); S={S} C={C} "
              f"{H}x{W} N={N} r={R} L={L}, {reps} reps")
        run(torch.device("cuda", 0), reps, args.seed)
        by_level_kind(torch.device("cuda", 0), reps, args.seed)
        return 0
    if not (args.parent / "batrack_tpu_torch").is_dir():
        parser.error("--parent must name a checkout that holds batrack_tpu_torch/")

    trees = {"parent": args.parent.resolve(), "this": ROOT}
    runs = []
    for which in ["parent", "this", "this", "parent"] * args.rounds:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--one", str(trees[which]),
               "--seed", str(args.seed), "--reps", str(args.reps or 50)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
            raise SystemExit(f"{which} failed with code {proc.returncode}")
        run_ = {"which": which, **json.loads(proc.stdout.strip().splitlines()[-1])}
        print(json.dumps(run_), flush=True)
        runs.append(run_)
        if not run_["err_vs_plain"] <= TOL:
            raise SystemExit(f"{which}: kernel differs from its plain version by "
                             f"{run_['err_vs_plain']} > {TOL}")

    summary = {which: {key: [x for r in runs if r["which"] == which
                             for x in (r[key] if isinstance(r[key], list) else [r[key]])]
                       for key in ("ms_per_sample", "ms_per_pyramid", "host_us_per_sample",
                                   "err_vs_plain")}
               for which in trees}
    print(json.dumps({"summary": summary}))
    print(smi)
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps({"runs": runs, "summary": summary, "card": smi}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
