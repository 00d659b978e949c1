"""A/B of the correlation kernel K1's variants on one NVIDIA GPU: bf16 maps
with the float32 contraction (bf16/vpu, the tracker's), bf16 maps with the
tensor-core contraction (bf16/mxu) and int8 maps (int8/vpu).

    python scripts/torch_corr_ab.py [--reps 20] [--seed 0]

The counterpart of scripts/corr_ab.py for batrack_tpu_torch, and the path
that selects K1's two options (no config of either package does). Same
shape: S=12 frames, C=128 channels, 96x128 maps in bf16, N=2400 tracks,
radius 3, 4 levels; random normal maps and targets and coordinates over the
map +-4, from the seed. Each variant's kernel is first held against its
plain version on the same inputs (1e-4: exact products, sums in another
order); a mismatch stops the script before anything is timed. Then each
variant is timed with CUDA events: ms per pyramid (build_pyramid +
pack_pyramid + corr_sample, what corr_ab.py times) and ms per corr_sample
call on the packed pyramid, with its output's largest difference from the
bf16/vpu output. corr_ab.py's `group` and `block_n` axes tune the TPU
kernel's track loop for Mosaic and have no counterpart here.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from batrack_tpu_torch.ops.corr import build_pyramid  # noqa: E402
from batrack_tpu_torch.ops.corr_kernel import (  # noqa: E402
    corr_sample,
    corr_sample_plain,
    pack_pyramid,
)
from batrack_tpu_torch.utils.config import full_fp32  # noqa: E402
from chip_smoke import cuda_ms  # noqa: E402

S, C, H, W, N, R, L = 12, 128, 96, 128, 2400, 3, 4
VARIANTS = (("bf16", "vpu"), ("bf16", "mxu"), ("int8", "vpu"))
TOL = 1e-4


def inputs(dev, seed: int):
    """bf16 maps (S, C, H, W), float32 targets (N, S, C) and coords (S, N, 2)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    fmaps = torch.randn((S, C, H, W), generator=gen, device=dev).to(torch.bfloat16)
    targets = torch.randn((N, S, C), generator=gen, device=dev)
    u = torch.rand((S, N, 2), generator=gen, device=dev)
    coords = torch.stack([u[..., 0] * (W + 8) - 4, u[..., 1] * (H + 8) - 4], -1)
    return fmaps, targets, coords


def run(dev, reps: int = 20, seed: int = 0, log=print) -> list:
    """Parity of every variant, then its times. Returns one dict per variant."""
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_corr_ab: no CUDA device; the kernels run only on the GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} ({smi or 'nvidia-smi not read'}); S={S} C={C} "
          f"{H}x{W} N={N} r={R} L={L}, {args.reps} reps")
    run(torch.device("cuda", 0), args.reps, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
