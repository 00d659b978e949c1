"""The port's measurement entry points on the CPU: bench_torch.py,
scripts/torch_tracker_breakdown.py, bench_refine_torch.py and
bench_depth_torch.py against the JAX scripts they port (bench.py,
scripts/tracker_breakdown.py, bench_refine.py, bench_depth.py) and the
JAX package.

- bench_refine_torch's scene is bench_refine.py's, bitwise; its --small
  final loss after 12 Adam steps agrees with batrack_tpu's loop on that
  scene within 1e-3. Both run in float32, and each float32 loop ends about
  1e-3 from the port's float64 loop (Adam's normalised steps amplify the
  rounding of near-zero gradients): 9.7e-4 and 1.1e-3 measured, against
  1.5e-4 between the two.
- bench_torch's function on a tiny config (plain kernels on the CPU)
  gives one JSON line with bench.py's keys, a finite frames/s and a null
  MFU, launches per append read from the counters, and the analytic
  GFLOP of batrack_tpu's FLOP model for the same tracker params.
- The breakdown's calls per forward equal those one adapter forward
  makes, with the static branch off (I and I) and on (the JAX script's
  count).
- bench_depth_torch's network input shapes are the JAX package's.
- Each script runs on CUDA unless told otherwise, and raises without it
  (bench_scaling_torch.py and scripts/torch_corr_vol_ab.py too; their CPU
  runs are in test_torch_scaling.py).
"""

import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from test_cli_e2e import SMALL_OVERRIDES

from batrack_tpu.depth import dpt as jdpt
from batrack_tpu.depth import unidepth as junidepth
from batrack_tpu.refine import build_refine_data as jbuild_refine_data
from batrack_tpu.refine import global_alignment_loop as jglobal_alignment_loop
from batrack_tpu.refine import init_params as jinit_params
from batrack_tpu.tracker.mdtracker import TrackerParams as JTrackerParams
from batrack_tpu.utils import config as jconfig
from batrack_tpu.utils.flops import tracker_forward_flops_from_params as jflops
from batrack_tpu_torch.depth.dpt import preprocess
from batrack_tpu_torch.ops import corr_kernel
from batrack_tpu_torch.tracker import MDTrackerAdapter, mdtracker
from batrack_tpu_torch.tracker.blocks import UpdateFormer
from batrack_tpu_torch.utils.config import load_config

REPO = Path(__file__).resolve().parents[1]
REFINE_TOL = 1e-3  # absolute, on a loss of about 1.79 (module note)


def _load(rel):
    spec = importlib.util.spec_from_file_location(Path(rel).stem, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bench_torch = _load("bench_torch.py")
bench_refine_torch = _load("bench_refine_torch.py")
bench_depth_torch = _load("bench_depth_torch.py")
breakdown = _load("scripts/torch_tracker_breakdown.py")
bench_scaling_torch = _load("bench_scaling_torch.py")
corr_vol_ab = _load("scripts/torch_corr_vol_ab.py")
bench_refine = _load("bench_refine.py")  # the JAX script: numpy at import


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def counted_k1(monkeypatch):
    """The tracker's K1 call site through the plain version, bumping K1's
    launch counter as the kernel's wrapper does on the card."""
    plain = mdtracker.corr_sample

    def bump(*a, **k):
        corr_kernel.corr_sample.launches += 1
        return plain(*a, **k)

    monkeypatch.setattr(mdtracker, "corr_sample", bump)
    monkeypatch.setattr(corr_kernel.corr_sample, "launches", 0)


@pytest.mark.parametrize("scene", ["SMALL", "SINTEL"])
def test_refine_scene_is_bench_refine_scene(scene):
    sc = getattr(bench_refine_torch, scene)
    shape = [sc[k] for k in ("T", "N", "S_local", "H", "W")]
    ours = bench_refine_torch.make_results(*shape, np.random.default_rng(0))
    ref = bench_refine.make_results(*shape, np.random.default_rng(0))
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        if v is None:
            assert ours[k] is None, k
        else:
            assert ours[k].dtype == v.dtype and np.array_equal(ours[k], v), k


def test_refine_small_final_loss_matches_jax():
    sc = bench_refine_torch.SMALL
    res = bench_refine_torch.bench(sc, "cpu")
    assert set(res) >= {"metric", "value", "unit", "scene", "niter", "sec_per_scene",
                        "final_loss", "backend", "device", "peak_memory_gib"}
    assert res["metric"] == "refine_iters_per_s" and res["niter"] == 12
    assert res["backend"] == "cpu" and res["peak_memory_gib"] is None
    T, N, S, H, W = (sc[k] for k in ("T", "N", "S_local", "H", "W"))
    data = jbuild_refine_data(bench_refine.make_results(T, N, S, H, W,
                                                        np.random.default_rng(0)))
    params = jinit_params(data, jconfig.RefineConfig().grid_size)
    _, loss = jglobal_alignment_loop(params, data, (H, W), jconfig.RefineConfig(niter=12))
    assert abs(res["final_loss"] - float(loss)) <= REFINE_TOL, (res["final_loss"], float(loss))


def test_bench_line_on_cpu(counted_k1):
    cfg = load_config(None, SMALL_OVERRIDES)
    res = bench_torch.bench(cfg, 48, 64, 12, 6, 2, "cpu")
    line = json.dumps(res)
    assert "\n" not in line
    res = json.loads(line)
    assert set(res) >= {"metric", "value", "unit", "vs_baseline", "reference_fps_estimate",
                        "config", "backend", "stage_ms", "tracker_gflops_per_call", "mfu",
                        "notes", "tracker_gflops_flop_counter", "launches_per_append",
                        "device"}
    assert res["metric"] == "slam_fps_e2e" and res["backend"] == "cpu"
    assert math.isfinite(res["value"]) and res["value"] > 0
    assert res["mfu"] is None and res["device"] == {"type": "cpu", "name": "cpu", "smi": None}
    assert set(res["stage_ms"]) == {"ingest", "tracker_append", "ba_update",
                                    "predicted_ms_per_2frames", "measured_ms_per_2frames"}
    assert all(math.isfinite(v) and v > 0 for v in res["stage_ms"].values())
    # 3 appends over frames 6-11; one K1 launch per refinement iteration,
    # and no other kernel (32 tracks stay under K2's 1024)
    assert res["appends"] == 3
    assert res["launches_per_append"] == {
        "corr_sample": cfg.model.I, "corr_sample_mxu": 0, "corr_sample_int8": 0,
        "fused_qkv_attention": 0, "fused_qkv_attention_kv": 0, "vmem_attention": 0,
        "flash_attention": 0}
    jp = JTrackerParams.from_config(jconfig.load_config(None, SMALL_OVERRIDES).model)
    s = cfg.slam
    ref = jflops(jp._replace(static_iters=0), N=2 * s.PATCHES_PER_FRAME,
                 H=jp.interp_shape[0], W=jp.interp_shape[1], new_frames=s.kf_stride)["total"]
    assert res["tracker_gflops_per_call"] == pytest.approx(ref / 1e9, rel=1e-12)
    # on the CPU the plain versions are torch ops, which the flop counter sees
    assert res["tracker_gflops_flop_counter"] > 0


@pytest.mark.parametrize("static_merge", [False, True])
def test_breakdown_calls_per_forward(counted_k1, monkeypatch, static_merge):
    overrides = SMALL_OVERRIDES + ["model.static_iters=2"]
    if static_merge:
        overrides.append("model.use_static_mask=true")
    m = load_config(None, overrides).model
    ad = MDTrackerAdapter(m, device="cpu")
    window, queries = breakdown.window_and_queries(m, 24, 48, 64, "cpu")
    calls = []
    forward = UpdateFormer.forward

    def count(self, *a, **k):
        calls.append(len(self.time_blocks))
        return forward(self, *a, **k)

    monkeypatch.setattr(UpdateFormer, "forward", count)
    k1, uf = breakdown.calls_per_forward(ad, window, queries)
    # the same forward, counted by the wrappers
    assert k1 == corr_kernel.corr_sample.launches
    assert uf == sum(t / m.time_depth for t in calls)
    jax_k1, jax_uf = breakdown.jax_calls(ad.p)
    assert (jax_k1, jax_uf) == (m.I + 2, m.I + 2 * m.time_depth_dyn / m.time_depth)
    assert (k1, uf) == ((jax_k1, jax_uf) if static_merge else (m.I, m.I))


@pytest.mark.parametrize("small", [True, False])
def test_depth_input_shapes_match_jax(small):
    H, W = bench_depth_torch.frame_hw(small)
    img = np.random.default_rng(0).uniform(0, 255, (H, W, 3)).astype(np.uint8)
    arch, size = bench_depth_torch.da2_input(small)
    assert (arch, size) == (("vits", 196) if small else ("vitl", 518))
    assert preprocess(img, size).shape == jdpt.preprocess(img, input_size=size).shape
    level, hw = bench_depth_torch.unidepth_level(small)
    assert level == (0 if small else None)
    assert tuple(hw) == tuple(junidepth._infer_shape((H, W), level)[0])


@pytest.mark.parametrize("main", [
    lambda: bench_torch.main([]), lambda: breakdown.main([]),
    lambda: bench_refine_torch.main(["--small"]), lambda: bench_depth_torch.main(["--small"]),
    lambda: bench_scaling_torch.main([]), lambda: corr_vol_ab.main([])],
    ids=["bench_torch", "tracker_breakdown", "bench_refine_torch", "bench_depth_torch",
         "bench_scaling_torch", "torch_corr_vol_ab"])
def test_scripts_default_to_cuda_and_raise_without_it(monkeypatch, main):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main()
