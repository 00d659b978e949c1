"""Feasibility of the matmul-first correlation on the card (the port's
counterpart of scripts/corr_vol_ab.py).

    python scripts/torch_corr_vol_ab.py [--device cpu]

Times the two rows of the JAX script at its shapes and draws (S 12, C 128,
96x128 maps, N 2400 tracks, 4 levels, numpy's default_rng(0)):

  (a) K1 over the pyramid, as the tracker calls it: the float32 pyramid
      (ops/corr.py::build_pyramid of the bf16 maps) packed once by
      pack_pyramid into one channels-last bf16 buffer, then the bf16-maps,
      float32-contraction route, corr_sample_kernel<3, bf16>. The JAX
      script times its Pallas kernel on the float32 pyramid, with the
      kernel's own padding and cast inside the timed call; here the packing
      is timed apart (pack_ms). K1 is held against its plain version first
      (1e-4), and its launches are counted over the timed calls only;
  (b) the per-level volumes einsum("schw,nsc->snhw") of the bf16 pyramid
      and targets (float32 accumulation, one rounding to bf16), times
      1/sqrt(C), as the JAX script's vols() computes them.

Each row: 3 warm-up calls, then 20 calls between two CUDA events. Prints
the JAX script's two lines, then one JSON line with both times, K1's
launches and error, the bytes bound of K1 (its inputs read once, its
output written once, at 3.35 TB/s) and the volumes' write bound (the
bytes they write at 3.35 TB/s), and the device record. No window gather
from the volumes is timed (the JAX script has none). Runs on CUDA unless
--device cpu is given, and raises without a card.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

S, C, H, W, N, LEVELS, RADIUS = 12, 128, 96, 128, 2400, 4, 3
WARMUP, REPS = 3, 20
K1_TOL = 1e-4
# one H100 SXM's HBM3 rate (NVIDIA data sheet)
HBM_BYTES_S = 3.35e12


def inputs(device):
    """The JAX script's draws: bf16 maps (S, C, H, W) and targets (N, S,
    C), float32 coords (S, N, 2) inside the level-0 map."""
    rng = np.random.default_rng(0)
    fmaps = torch.as_tensor(rng.normal(size=(S, C, H, W))).to(torch.bfloat16)
    targets = torch.as_tensor(rng.normal(size=(N, S, C))).to(torch.bfloat16)
    coords = np.stack([rng.uniform(0, W - 1, (S, N)), rng.uniform(0, H - 1, (S, N))], -1)
    return (fmaps.to(device), targets.to(device),
            torch.as_tensor(coords, dtype=torch.float32, device=device))


def volumes(pyramid_bf16, targets, inv):
    """Row (b): one (S, N, H_l, W_l) bf16 volume per level."""
    return [torch.einsum("schw,nsc->snhw", p, targets) * inv for p in pyramid_bf16]


def volume_bytes(shapes) -> int:
    """Bytes the volumes write: S x N x H_l x W_l bf16 elements per level."""
    return sum(S * N * h * w * 2 for h, w in shapes)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    from batrack_tpu_torch.ops import launch_counts
    from batrack_tpu_torch.ops.corr import build_pyramid
    from batrack_tpu_torch.ops.corr_kernel import corr_sample, corr_sample_plain, pack_pyramid
    from batrack_tpu_torch.utils.config import full_fp32, resolve_device
    from batrack_tpu_torch.utils.profiling import device_ms, device_record

    device = resolve_device(args.device)
    if device.type == "cuda":
        from batrack_tpu_torch.ops import cuda_build

        cuda_build.build(["corr_sample"])
    fmaps, targets, coords = inputs(device)
    inv = 1.0 / math.sqrt(C)
    pyramid = build_pyramid(fmaps.float(), LEVELS)
    shapes = [tuple(p.shape[2:]) for p in pyramid]
    t32 = targets.float()

    with torch.no_grad(), full_fp32():
        pyr = pack_pyramid(pyramid)
        out = corr_sample(pyr, t32, coords, RADIUS)
        err = (out - corr_sample_plain(pyr, t32, coords, RADIUS)).abs().max().item()
        if not err <= K1_TOL:
            raise AssertionError(f"K1 against its plain version: {err} > {K1_TOL}")
        pack_ms = device_ms(lambda: pack_pyramid(pyramid), REPS, WARMUP, device)
        before = launch_counts()
        k1_ms = device_ms(lambda: corr_sample(pyr, t32, coords, RADIUS), REPS, WARMUP, device)
        launches = {k: v - before[k] for k, v in launch_counts().items()}
        print(f"current K1 pyramid gather:     {k1_ms:7.3f} ms", flush=True)

        pyr_bf = [p.to(torch.bfloat16) for p in pyramid]
        vol_ms = device_ms(lambda: volumes(pyr_bf, targets, inv), REPS, WARMUP, device)
        vols = volumes(pyr_bf, targets, inv)
    vol_bytes = sum(v.numel() * v.element_size() for v in vols)
    if vol_bytes != volume_bytes(shapes):
        raise AssertionError(f"the volumes wrote {vol_bytes} bytes, not {volume_bytes(shapes)}")
    print(f"einsum volumes (all levels):   {vol_ms:7.3f} ms "
          f"({vol_bytes / 1e6:.0f} MB written)", flush=True)

    k1_bytes = (pyr.flat.numel() * pyr.flat.element_size() + t32.numel() * 4
                + coords.numel() * 4 + out.numel() * 4)
    print(json.dumps({
        "metric": "corr_vol_ab",
        "shapes": {"S": S, "C": C, "H": H, "W": W, "N": N, "levels": LEVELS,
                   "radius": RADIUS},
        "warmup": WARMUP, "reps": REPS,
        "k1_ms": k1_ms, "k1_pack_ms": pack_ms, "k1_launches": launches["corr_sample"],
        "k1_max_abs_err": err, "k1_tolerance": K1_TOL,
        "k1_route": "float32 pyramid packed once by pack_pyramid (channels-last bf16), "
                    "float32 contraction: corr_sample_kernel<3, bf16>",
        "k1_bytes": k1_bytes, "k1_bound_ms": k1_bytes / HBM_BYTES_S * 1e3,
        "volumes_ms": vol_ms, "volumes_mb_written": vol_bytes / 1e6,
        "volumes_write_bound_ms": vol_bytes / HBM_BYTES_S * 1e3,
        "volumes_over_k1": vol_ms / k1_ms,
        "launches": launches,
        "device": device_record(device),
        "notes": "ms per call from CUDA events around 20 back-to-back calls after 3 "
                 "(perf_counter on the CPU, where K1 is its plain version and counts no "
                 "launch). k1_launches counts the timed calls. k1_bound_ms: K1's inputs "
                 "read once and output written once at 3.35 TB/s; volumes_write_bound_ms: "
                 "the volumes' bytes at 3.35 TB/s. The volumes are not the same function "
                 "as K1: a window gather from them would follow.",
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
