"""Device time of the port's tracker forward by component, at davis_demo's
shapes (the port's counterpart of scripts/tracker_breakdown.py).

    python scripts/torch_tracker_breakdown.py [--device cpu]

Times each hot component of the MDTracker forward standalone (ms per call
from CUDA events: 10 calls after 3 warm-ups, the full forward 5), multiplies
it by its calls per forward, and holds the sum against the full forward;
the residual is the glue (embeddings, layouts, small ops). Rows, on inputs
drawn from numpy's default_rng(0) and weights from seed 0, in bf16:

- the full adapter forward: 2400 tracks, S = 12, a 480x640 RGB-D window,
  as an append of the SLAM loop runs it (the previous append's features
  reused for all but kf_stride frames);
- the UpdateFormer alone (6 time and 6 space blocks, K2 in the space
  blocks);
- the correlation pyramid: build_pyramid, pack_pyramid and K1, per call
  (the tracker builds the pyramid once per forward and launches K1 once
  per refinement iteration);
- fnet on the 2 new frames.

Calls per forward come from one full forward: the change in K1's launch
counter, and a forward hook on the two UpdateFormers (a call of the
dynamic branch's weighted by its time depth over the main one's). The
JAX script's count, I + static_iters for the pyramid and I + static_iters
x time_depth_dyn / time_depth for the UpdateFormer, is printed beside it:
it counts the static branch, which neither adapter runs without a static
merge. Ends with one JSON line of the rows.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

N_TRACKS = 2400  # 400 patches x 6 source frames
HT, WD = 480, 640
REPS, WARMUP, FULL_REPS = 10, 3, 5


def window_and_queries(m, n_tracks: int, ht: int, wd: int, device):
    """The JAX script's seeded RGB-D window (S, 4, ht, wd) and queries
    (n_tracks, 4): [frame, x, y, depth]."""
    rng = np.random.default_rng(0)
    S = m.S
    window = rng.uniform(0, 255, (S, 4, ht, wd)).astype(np.float32)
    window[:, 3] = rng.uniform(2.0, 8.0, (S, ht, wd))
    queries = np.stack([rng.integers(0, S, n_tracks).astype(np.float32),
                        rng.uniform(8, wd - 8, n_tracks), rng.uniform(8, ht - 8, n_tracks),
                        rng.uniform(2.0, 8.0, n_tracks)], -1).astype(np.float32)
    return torch.from_numpy(window).to(device), torch.from_numpy(queries).to(device)


def jax_calls(p):
    """The JAX script's calls per forward: (pyramid, UpdateFormer)."""
    return p.iters + p.static_iters, p.iters + p.static_iters * p.time_depth_dyn / p.time_depth


def calls_per_forward(ad, window, queries, prev=None, reuse: int = 0):
    """(K1 launches, UpdateFormer calls) over one adapter forward: K1's
    counter and forward hooks on the main and dynamic UpdateFormers, a
    dynamic call weighted by time_depth_dyn / time_depth."""
    from batrack_tpu_torch.ops.corr_kernel import corr_sample

    p, calls = ad.p, {"main": 0, "dyn": 0}

    def hook(name):
        def bump(*_):
            calls[name] += 1
        return bump

    hooks = [ad.model.updateformer.register_forward_hook(hook("main")),
             ad.model.updateformer_dyn.register_forward_hook(hook("dyn"))]
    k1 = corr_sample.launches
    try:
        ad.forward(window, queries, prev, reuse)
    finally:
        for h in hooks:
            h.remove()
    return (corr_sample.launches - k1,
            calls["main"] + calls["dyn"] * p.time_depth_dyn / p.time_depth)


@torch.no_grad()
def breakdown(cfg, device="cuda", n_tracks: int = N_TRACKS, ht: int = HT, wd: int = WD,
              reps: int = REPS, warmup: int = WARMUP, full_reps: int = FULL_REPS) -> dict:
    """The rows at `cfg`'s model on `device`; returns the JSON line as a dict."""
    from batrack_tpu_torch.ops.corr import build_pyramid
    from batrack_tpu_torch.ops.corr_kernel import corr_sample, pack_pyramid
    from batrack_tpu_torch.tracker import MDTrackerAdapter
    from batrack_tpu_torch.utils.config import full_fp32, resolve_device
    from batrack_tpu_torch.utils.profiling import device_ms, device_record

    device = resolve_device(device)
    m, kf = cfg.model, cfg.slam.kf_stride
    dtype = getattr(torch, m.compute_dtype)
    ad = MDTrackerAdapter(m, seed=0, device=device)
    p = ad.p
    C, S = p.latent_dim, p.S
    h4, w4 = p.interp_shape[0] // p.stride, p.interp_shape[1] // p.stride
    window, queries = window_and_queries(m, n_tracks, ht, wd, device)
    rng = np.random.default_rng(0)
    rows = []

    def row(name, ms, calls, jax):
        rows.append({"row": name, "ms_per_call": ms, "calls": calls, "jax_calls": jax,
                     "ms": ms * calls})

    with full_fp32():  # as BATrack runs the tracker
        _, prev = ad.forward(window, queries)
        k1_calls, uf_calls = calls_per_forward(ad, window, queries, prev, kf)
        jax_corr, jax_uf = jax_calls(p)
        row("full forward", device_ms(lambda: ad.forward(window, queries, prev, kf), full_reps,
                                      warmup, device), 1, 1)

        x = torch.from_numpy(rng.normal(0, 1, (1, n_tracks, S, p.input_dim)).astype(np.float32))
        x = x.to(device, dtype)
        uf = ad.model.updateformer
        row(f"UpdateFormer ({p.time_depth}t/{p.space_depth}s)",
            device_ms(lambda: uf(x), reps, warmup, device), uf_calls, jax_uf)

        fmaps = torch.from_numpy(rng.normal(0, 1, (S, C, h4, w4)).astype(np.float32))
        fmaps = fmaps.to(device, dtype)
        targets = torch.from_numpy(rng.normal(0, 1, (n_tracks, S, C)).astype(np.float32))
        targets = targets.to(device, dtype).float()
        coords = torch.from_numpy(np.stack([rng.uniform(0, w4, (S, n_tracks)),
                                            rng.uniform(0, h4, (S, n_tracks))],
                                           -1).astype(np.float32)).to(device)

        def corr_call():
            pyr = pack_pyramid(build_pyramid(fmaps, p.corr_levels))
            return corr_sample(pyr, targets, coords, p.corr_radius)

        row("corr pyramid (build + K1)", device_ms(corr_call, reps, warmup, device), k1_calls,
            jax_corr)

        frames = torch.from_numpy(rng.normal(0, 1, (kf, 3) + tuple(p.interp_shape))
                                  .astype(np.float32)).to(device, dtype)
        row(f"fnet ({kf} new frames)", device_ms(lambda: ad.model.fnet(frames), reps, warmup,
                                                 device), 1, 1)

    accounted = sum(r["ms"] for r in rows[1:])
    return {"metric": "tracker_breakdown_ms", "rows": rows, "accounted_ms": accounted,
            "residual_ms": rows[0]["ms"] - accounted, "N": n_tracks, "S": S,
            "grid": [h4, w4], "dtype": m.compute_dtype, "new_frames": kf,
            "backend": device.type, "device": device_record(device)}


def table(result: dict) -> str:
    lines = [f"device={result['device']['name']} dtype={result['dtype']} N={result['N']} "
             f"S={result['S']} grid={result['grid'][0]}x{result['grid'][1]}",
             f"  {'':38s} {'ms/call':>8s}   {'calls':>5s} {'(JAX)':>6s}   {'ms':>8s}"]
    for r in result["rows"]:
        lines.append(f"  {r['row']:38s} {r['ms_per_call']:8.3f} x {r['calls']:5.1f} "
                     f"({r['jax_calls']:4.1f}) = {r['ms']:8.3f}")
    lines.append(f"  {'accounted (components)':38s} {'':8s}   {'':5s} {'':6s}   "
                 f"{result['accounted_ms']:8.3f}")
    lines.append(f"  {'residual (glue/layout/embeds)':38s} {'':8s}   {'':5s} {'':6s}   "
                 f"{result['residual_ms']:8.3f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from batrack_tpu_torch.utils.config import Config, resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        from batrack_tpu_torch.ops import cuda_build

        cuda_build.build(["corr_sample", "fused_qkv_attention"])
    result = breakdown(Config(), device)
    print(table(result))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
