"""A/B of the correlation kernel K1 on one NVIDIA GPU: its variants in this
tree, or one variant of this tree against an earlier tree's.

    python scripts/torch_corr_ab.py [--reps 20] [--seed 0]
    python scripts/torch_corr_ab.py --parent DIR [--variant vpu|mxu|int8] [--rounds 1]
                                    [--reps 50]
    python scripts/torch_corr_ab.py --int8-layouts [--reps 50]

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
its output's largest difference from the bf16/vpu output. Last, each
variant's kernel is timed on the levels it streams alone and on the levels
it keeps in shared memory alone. corr_ab.py's
`group` and `block_n` axes tune the TPU kernel's track loop for Mosaic and
have no counterpart here.

With --parent, DIR is a checkout of the commit to compare with (for
example one unpacked from `git archive` into build/archive/parent, a
directory .gitignore lists). Each round runs the parent's and this tree's
kernel of one variant (--variant: vpu, bf16 maps and the float32 target,
the default; mxu, bf16 maps and the tensor-core contraction; int8, int8
maps) as separate processes in the order parent, this, this, parent, on
the same inputs. Each process builds its tree's kernels and records the
kernel's distance to its plain version, device ms per call and per pyramid
(CUDA events, three readings each), and host us per call (the host clock
over 50 calls enqueued back to back, no synchronise between them). It
prints one JSON line per process, then a summary and the card's name and
power limit, and writes all of it to chiprun_out/torch_corr_ab[_VARIANT].json.

With --int8-layouts it measures the int8 route's shared-memory layout
against two others. The route spends its halved window (one 8 KB box
instead of two) on less shared memory: 12 ring slots (96 KB), so two
blocks share an SM (csrc/corr_sample.cu). The others are built from
copies of this tree's package, each with one edit, in a temporary
directory: one_block (the same ring, the launch's shared memory raised to
120,000 bytes so that one block fits on an SM) and ring24 (24 slots, four
per consumer warp, 192 KB, one block per SM; a bf16 plan no longer fits
beside that ring). Each runs in a process of its own in the order this,
one_block, ring24, ring24, one_block, this, and records the int8 route's
distance to its plain version, the blocks an SM holds, ms per call on the
whole pyramid (three readings) and on the streamed and the resident
levels alone, and beside it this tree's bf16/vpu kernel on the whole
pyramid. Last, it counts the SASS instructions of each instantiation of
this tree's kernel (cuobjdump). It writes
chiprun_out/torch_corr_ab_int8_layouts.json.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
# --variant: (fmap_dtype, contract, launch counter)
BY_NAME = {"vpu": ("bf16", "vpu", "launches"), "mxu": ("bf16", "mxu", "mxu_launches"),
           "int8": ("int8", "vpu", "int8_launches")}
TOL = 1e-4
# --int8-layouts: each layout's edits to a copy of the package, (file under
# batrack_tpu_torch/, old, new)
LAYOUTS = {
    "one_block": [
        ("csrc/corr_sample.cu", "p.region + kExtraBytes,",
         "kInt8 ? 120000 : p.region + kExtraBytes,"),
        ("csrc/corr_sample.cu", "const size_t smem = (size_t)p.region + kExtraBytes;",
         "const size_t smem = p.int8 ? 120000 : (size_t)p.region + kExtraBytes;"),
    ],
    "ring24": [
        ("csrc/corr_sample.cu", "constexpr int kMaxSlots = 12;", "constexpr int kMaxSlots = 24;"),
    ],
}


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
    """ms per call of each variant's kernel on the levels it streams alone
    and on the levels it keeps in shared memory alone (a sub-pyramid of
    consecutive levels, sampled at coords / 2^first so each level sees the
    same windows as in the whole pyramid), beside the whole pyramid."""
    from batrack_tpu_torch.ops.corr import build_pyramid
    from batrack_tpu_torch.ops.corr_kernel import corr_sample, pack_pyramid, resident_levels

    fmaps, targets, coords = inputs(dev, seed)
    pyramid = build_pyramid(fmaps, L)
    res = {}
    for fd, ct in VARIANTS:
        elem = 1 if fd == "int8" else 2
        resident = resident_levels([tuple(fm.shape[2:]) for fm in pyramid], C, elem)
        first = resident.index(True) if True in resident else L
        parts = {"whole": (0, L), "streamed": (0, first), "resident": (first, L)}
        for name, (lo, hi) in parts.items():
            if lo == hi:
                continue
            pyr = pack_pyramid(pyramid[lo:hi], fd)
            xy = coords / 2.0 ** lo
            ms = cuda_ms(lambda: corr_sample(pyr, targets, xy, R, contract=ct), reps)
            res[f"{fd}/{ct} {name}"] = ms
            log(f"{fd}/{ct}, levels {lo}-{hi - 1} ({name}): {ms:.4f} ms per call")
    return res


def measure(tree: Path, reps: int, seed: int, variant: str = "vpu") -> dict:
    """The --parent readings of one variant's kernel of the tree at `tree`,
    in this process (which must not have imported another tree's package)."""
    sys.path.insert(0, str(tree))
    os.chdir(tree)
    import torch

    from batrack_tpu_torch.ops import cuda_build
    from batrack_tpu_torch.ops.corr import build_pyramid
    from batrack_tpu_torch.ops.corr_kernel import corr_sample, corr_sample_plain, pack_pyramid
    from batrack_tpu_torch.utils.config import full_fp32

    fd, ct, counter = BY_NAME[variant]
    cuda_build.build(["corr_sample"])
    dev = torch.device("cuda", 0)
    fmaps, targets, coords = inputs(dev, seed)
    pyr = pack_pyramid(build_pyramid(fmaps, L), fd)
    with full_fp32():
        err = (corr_sample(pyr, targets, coords, R, contract=ct)
               - corr_sample_plain(pyr, targets, coords, R, contract=ct)).abs().max().item()

    def call():
        return corr_sample(pyr, targets, coords, R, contract=ct)

    def whole():
        return corr_sample(pack_pyramid(build_pyramid(fmaps, L), fd), targets, coords, R,
                           contract=ct)

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

    before = getattr(corr_sample, counter)
    res = {"tree": str(tree), "variant": variant, "err_vs_plain": err,
           "ms_per_sample": [cuda_ms(call, reps) for _ in range(3)],
           "ms_per_pyramid": [cuda_ms(whole, reps) for _ in range(3)],
           "host_us_per_sample": host_us(call)}
    res["launches"] = getattr(corr_sample, counter) - before
    return res


def layout_tree(base: Path, layout: str) -> Path:
    """A copy of this tree's package under `base` with the layout's edits."""
    tree = base / layout
    shutil.copytree(ROOT / "batrack_tpu_torch", tree / "batrack_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, old, new in LAYOUTS[layout]:
        path = tree / "batrack_tpu_torch" / name
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{layout}: the edit of {name} no longer applies: {old!r}")
        path.write_text(text.replace(old, new))
    return tree


def measure_layout(tree: Path, layout: str, reps: int, seed: int) -> dict:
    """The --int8-layouts readings of the package at `tree`, in this process
    (which must not have imported another tree's package)."""
    sys.path.insert(0, str(tree))
    import torch

    from batrack_tpu_torch.ops import cuda_build
    from batrack_tpu_torch.ops.corr import build_pyramid
    from batrack_tpu_torch.ops.corr_kernel import (blocks_per_sm, corr_sample, corr_sample_plain,
                                                   pack_pyramid, resident_levels)
    from batrack_tpu_torch.utils.config import full_fp32

    cuda_build.build(["corr_sample"])
    dev = torch.device("cuda", 0)
    fmaps, targets, coords = inputs(dev, seed)
    pyramid = build_pyramid(fmaps, L)
    pyr = pack_pyramid(pyramid, "int8")
    with full_fp32():
        err = (corr_sample(pyr, targets, coords, R)
               - corr_sample_plain(pyr, targets, coords, R)).abs().max().item()
    res = {"layout": layout, "err_vs_plain": err, "blocks_per_sm": blocks_per_sm(pyr),
           "ms_whole": [cuda_ms(lambda: corr_sample(pyr, targets, coords, R), reps)
                        for _ in range(3)]}
    resident = resident_levels([tuple(f.shape[2:]) for f in pyramid], C, 1)
    first = resident.index(True) if True in resident else L
    for name, (lo, hi) in {"streamed": (0, first), "resident": (first, L)}.items():
        if lo < hi:
            sub = pack_pyramid(pyramid[lo:hi], "int8")
            xy = coords / 2.0 ** lo
            res[f"ms_{name}"] = cuda_ms(lambda: corr_sample(sub, targets, xy, R), reps)
    if layout != "ring24":
        bf16 = pack_pyramid(pyramid)
        res["bf16_vpu_ms_whole"] = cuda_ms(lambda: corr_sample(bf16, targets, coords, R), reps)
    return res


def sass_counts(lib: Path) -> dict:
    """SASS instructions of each kernel in a built library, with the most
    frequent opcodes."""
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts = {}
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        ops = collections.Counter(
            m.group(1).split(".")[0]
            for m in re.finditer(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", fn))
        counts[fn.split("\n", 1)[0].strip()] = {"instructions": sum(ops.values()),
                                                "top": ops.most_common(8)}
    return counts


def int8_layouts(reps: int, seed: int, smi: str) -> None:
    """--int8-layouts: each layout in a child process, then the SASS counts."""
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        trees = {"this": ROOT, **{lay: layout_tree(Path(tmp), lay) for lay in LAYOUTS}}
        for layout in ["this", "one_block", "ring24", "ring24", "one_block", "this"]:
            cmd = [sys.executable, str(Path(__file__).resolve()), "--one", str(trees[layout]),
                   "--layout", layout, "--seed", str(seed), "--reps", str(reps)]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            if proc.returncode:
                print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
                raise SystemExit(f"{layout} failed with code {proc.returncode}")
            run_ = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps(run_), flush=True)
            runs.append(run_)
            if not run_["err_vs_plain"] <= TOL:
                raise SystemExit(f"{layout}: kernel differs from its plain version by "
                                 f"{run_['err_vs_plain']} > {TOL}")
    sass = sass_counts(ROOT / "build" / "kernels" / "libcorr_sample.so")
    print(json.dumps({"sass": sass}))
    print(smi)
    out = OUT.with_name(f"{OUT.stem}_int8_layouts.json")
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"runs": runs, "sass": sass, "card": smi}, indent=1))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=None,
                        help="calls per reading (default 20, or 50 with --parent)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--parent", type=Path, help="checkout of the tree to compare with")
    parser.add_argument("--rounds", type=int, default=1,
                        help="with --parent: rounds of parent, this, this, parent")
    parser.add_argument("--variant", choices=sorted(BY_NAME), default="vpu",
                        help="with --parent: the kernel compared (default vpu, the tracker's)")
    parser.add_argument("--int8-layouts", action="store_true",
                        help="measure the int8 route's shared-memory layout against two others")
    parser.add_argument("--one", type=Path, help=argparse.SUPPRESS)  # a child process
    parser.add_argument("--layout", help=argparse.SUPPRESS)  # a child's --int8-layouts layout
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_corr_ab: no CUDA device; the kernels run only on the GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    if args.one is not None:
        tree, reps = args.one.resolve(), args.reps or 50
        res = (measure_layout(tree, args.layout, reps, args.seed) if args.layout
               else measure(tree, reps, args.seed, args.variant))
        print(json.dumps(res), flush=True)
        return 0
    if args.int8_layouts:
        int8_layouts(args.reps or 50, args.seed, smi)
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
               "--seed", str(args.seed), "--reps", str(args.reps or 50),
               "--variant", args.variant]
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
    print(json.dumps({"variant": args.variant, "summary": summary}))
    print(smi)
    out = OUT if args.variant == "vpu" else OUT.with_name(f"{OUT.stem}_{args.variant}.json")
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"variant": args.variant, "runs": runs, "summary": summary,
                               "card": smi}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
