"""The port's scaling measurements on the CPU: bench_scaling_torch.py end
to end over gloo, its collective counts (parallel/mesh.py) against the
collectives XLA compiles for batrack_tpu's sharded programs, and
scripts/torch_corr_vol_ab.py's volumes against scripts/corr_vol_ab.py's.

- bench_scaling_torch.py at shrunk sizes over torchrun groups of 1 and 2
  gloo ranks: five lines with bench_scaling.py's keys, and the collective
  models met exactly.
- Its 2-rank readings hold the counter against batrack_tpu: the all-gather
  elements of one sharded attention call (a padded track axis, a key
  mask) equal those of the all-gathers that batrack_tpu's
  fused_qkv_attention_sharded issues in its compiled HLO on a 2-device CPU
  mesh (interpret=True, compile only); the all-reduce elements of one
  patch-sharded backend update (test_slam_e2e's small config, a fresh
  state) equal ITER x (72 W^2 + 12 W) and the HLO all-reduces of
  batrack_tpu's sharded_slot_slam_update at the same dims. Counts are
  exact.
- The volumes at a small shape equal JAX's within two bf16 ulps of their
  largest magnitude (both round the float32 product to bf16, then
  multiply by 1/sqrt(C) in bf16); their bytes equal the JAX script's sum.

The script's ranks run in their own processes (torchrun), one thread each.
"""

import contextlib
import importlib.util
import io
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
B, N, HEADS, HEAD_DIM = 2, 21, 2, 48   # N odd: the track axis is padded
BA_HW = (48, 64)                        # test_slam_e2e's HT, WD
# test_cli_e2e's SMALL_OVERRIDES with one block per former; the slam part is
# test_slam_e2e.small_config's, which the HLO of the BA is compiled at
SMALL_SLAM = [
    "slam.BUFFER_SIZE=64", "slam.PATCHES_PER_FRAME=16", "slam.PATCH_GEN=grid_grad_4",
    "slam.S_slam=4", "slam.num_init=4", "slam.kf_stride=2", "slam.REMOVAL_WINDOW=6",
    "slam.OPTIMIZATION_WINDOW=5", "slam.MIN_TRACK_LEN=2", "slam.ITER=2", "slam.BA_EP=0.1",
    "slam.backward_tracking=false", "model.S=4", "model.sliding_window_len=4", "model.I=1",
    "model.static_iters=1", "model.interp_shape=[48, 64]", "model.space_depth=1",
    "model.time_depth=1", "model.space_depth_dyn=1", "model.time_depth_dyn=1",
    "model.compute_dtype=float32"]


def _load(rel):
    spec = importlib.util.spec_from_file_location(Path(rel).stem, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scaling_lines():
    """bench_scaling_torch.py's five lines over gloo groups of 1 and 2
    ranks at shrunk sizes (tracks under K2's threshold)."""
    mod = _load("bench_scaling_torch.py")
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.setattr(mod, "SLAM_OVERRIDES", SMALL_SLAM)
        mp.setattr(mod, "SLAM_FRAMES", 7)
        mp.setattr(mod, "SLAM_WARM", 5)   # num_init + 1: the init is warm-up
        mp.setattr(mod, "SLAM_HW", (48, 64))
        mp.setattr(mod, "SLAM_FOCAL", 50.0)
        mp.setattr(mod, "TRACKER", {
            "S": 4, "H": 48, "W": 64, "N": N, "reps": 2,
            "params": {"iters": 1, "static_iters": 1, "interp_shape": [48, 64],
                       "space_depth": 1, "time_depth": 1, "space_depth_dyn": 1,
                       "time_depth_dyn": 1}})
        mp.setattr(mod, "GATHER", {"B": B, "N": N, "C": HEADS * HEAD_DIM, "heads": HEADS,
                                   "reps": 2})
        mp.setattr(mod, "BA_HW", BA_HW)
        mp.setattr(mod, "BA_OVERRIDES", [o for o in SMALL_SLAM if o.startswith("slam.")])
        assert mod.main(["--device", "cpu", "--counts", f"1,{WORLD}"]) == 0
    return [json.loads(ln) for ln in out.getvalue().splitlines()]


def _hlo_elements(txt, op):
    """Elements of every `op` instruction's output in compiled HLO text
    (each member of a tuple output), and the instructions' lines."""
    if f"{op}-start(" in txt:
        raise AssertionError(f"asynchronous {op} in the HLO: its tuple holds the operands too")
    total, lines = 0, []
    for line in txt.splitlines():
        if f" {op}(" not in line:
            continue
        lhs = line.split(f" {op}(", 1)[0].split("=", 1)[1]
        for m in re.finditer(r"([a-z][a-z0-9]*)\[([0-9,]*)\]", lhs):
            total += math.prod(int(d) for d in m.group(2).split(",") if d)
        lines.append(line.strip())
    return total, lines


def test_attention_allgathers_match_jax_hlo(scaling_lines):
    """The K/V lanes (B, N_pad, 2C) and the key mask (N_pad,): the two
    all-gathers inside batrack_tpu's shard_map. The SPMD partitioner's
    gather of the sliced output (out[:, :N] of a padded, sharded array) is
    no collective of the function, and the port's output stays local."""
    import jax
    import jax.numpy as jnp

    from batrack_tpu.parallel import get_mesh as jget_mesh
    from batrack_tpu.parallel.shard_kernels import fused_qkv_attention_sharded as jsharded

    counted = scaling_lines[2]["per_mesh"][str(WORLD)]
    mesh = jget_mesh(WORLD, ("track",))
    C = HEADS * HEAD_DIM

    def f(x, m):
        return jsharded(x, HEADS, HEAD_DIM ** -0.5, mesh, key_mask=m, interpret=True)

    txt = jax.jit(f).lower(jax.ShapeDtypeStruct((B, N, 3 * C), jnp.bfloat16),
                           jax.ShapeDtypeStruct((N,), jnp.bool_)).compile().as_text()
    inside = "\n".join(ln for ln in txt.splitlines() if "shard_map/all_gather" in ln)
    elements, lines = _hlo_elements(inside, "all-gather")
    n_pad = N + (-N) % WORLD
    assert len(lines) == 2 and elements == B * n_pad * 2 * C + n_pad, lines
    assert counted["counted_allgather_calls"] == 2
    assert counted["counted_allgather_output_elements"] == elements
    assert counted["counted_shapes"] == {f"bfloat16[{B},{n_pad},{2 * C}]": 1, f"bool[{n_pad}]": 1}


def test_ba_allreduces_match_model_and_jax_hlo(scaling_lines):
    """ITER Gauss-Newton pose passes, each one all-reduce of B, vvec, EQE
    and Ew; the structure-only passes reduce nothing."""
    import jax
    import jax.numpy as jnp

    from batrack_tpu.parallel import get_mesh as jget_mesh
    from batrack_tpu.parallel.sharded_slot_ba import sharded_slot_slam_update as jupdate
    from batrack_tpu.slam.state import StaticDims as JDims
    from batrack_tpu.slam.state import init_state as jinit_state
    from test_slam_e2e import small_config

    jcfg = small_config()
    counted = scaling_lines[3]["per_mesh"][str(WORLD)]
    dims = JDims.from_config(jcfg, *BA_HW)
    W, ITER = dims.window, jcfg.slam.ITER
    mesh = jget_mesh(WORLD, ("patch",))

    def f(st, n, init):
        return jupdate(st, n, init, dims, jcfg.slam, mesh)

    state = jax.eval_shape(lambda: jinit_state(jcfg, *BA_HW))
    txt = jax.jit(f).lower(state, jax.ShapeDtypeStruct((), jnp.int32),
                           jax.ShapeDtypeStruct((), jnp.bool_)).compile().as_text()
    elements, lines = _hlo_elements(txt, "all-reduce")
    model = ITER * (72 * W * W + 12 * W)
    assert elements == model and len(lines) == ITER, lines
    assert scaling_lines[3]["shapes"]["W"] == W
    assert counted["counted_allreduce_calls"] == ITER
    assert counted["counted_allreduce_elements"] == counted["model_elements"] == model


def test_bench_scaling_on_cpu(scaling_lines):
    lines = scaling_lines
    assert [r["metric"] for r in lines] == [
        "slam_scaling_real_tracker", "tracker_scaling", "collective_bytes",
        "ba_allreduce_bytes", "collective_cost_model"]
    slam, tr, cb, ba, cm = lines
    # bench_scaling.py's keys, plus the port's additions
    assert set(slam) >= {"metric", "fps", "overhead", "backend", "shared_compute_mesh",
                         "shapes", "notes", "launches_per_append", "device"}
    assert set(tr) >= {"metric", "sec_per_forward", "overhead", "backend",
                       "shared_compute_mesh", "shapes", "notes", "sec_per_rep",
                       "k2_kv_launches_per_forward", "device"}
    assert slam["backend"] == "cpu" and slam["shared_compute_mesh"] is True
    for section in (slam["fps"], tr["sec_per_forward"]):
        assert set(section) == {"1", "2"}
        assert all(math.isfinite(v) and v > 0 for v in section.values())
    assert set(slam["overhead"]) == set(tr["overhead"]) == {"2"}
    assert all(len(reps) == 2 for reps in tr["sec_per_rep"].values())
    assert tr["k2_kv_launches_per_forward"] == {"1": 0, "2": 0}
    for n in ("1", "2"):
        g, b = cb["per_mesh"][n], ba["per_mesh"][n]
        assert g["counted_over_model"] == 1 and b["counted_over_model"] == 1
        assert g["counted_mask_elements"] == g["model_mask_elements"] == (0 if n == "1" else 22)
        assert b["counted_allreduce_calls"] == 2
    assert cm["projection"]["2"]["rate_source"].startswith("measured")
    assert cm["projection"]["4"]["rate_source"].startswith("nominal")


def test_volumes_match_jax():
    import jax
    import jax.numpy as jnp

    from batrack_tpu.ops.corr import build_pyramid as jbuild_pyramid
    from batrack_tpu_torch.ops.corr import build_pyramid

    ab = _load("scripts/torch_corr_vol_ab.py")
    S, C, H, W, N = 2, 128, 16, 24, 30
    rng = np.random.default_rng(0)
    fmaps = rng.normal(size=(S, C, H, W)).astype(np.float32)
    targets = rng.normal(size=(N, S, C)).astype(np.float32)
    inv = 1.0 / np.sqrt(C)

    def jvols(fm, tg):  # scripts/corr_vol_ab.py's vols()
        pyr = jbuild_pyramid(fm.astype(jnp.float32), ab.LEVELS)
        return [jnp.einsum("schw,nsc->snhw", p.astype(jnp.bfloat16), tg,
                           preferred_element_type=jnp.float32).astype(jnp.bfloat16) * inv
                for p in pyr]

    ref = jvols(jnp.asarray(fmaps, jnp.bfloat16), jnp.asarray(targets, jnp.bfloat16))
    pyr = build_pyramid(torch.from_numpy(fmaps).to(torch.bfloat16).float(), ab.LEVELS)
    ours = ab.volumes([p.to(torch.bfloat16) for p in pyr],
                      torch.from_numpy(targets).to(torch.bfloat16), inv)
    for o, r in zip(ours, ref):
        r = np.asarray(r.astype(jnp.float32))
        assert o.dtype == torch.bfloat16 and o.shape == r.shape
        tol = 2.0 * 2.0 ** (math.floor(math.log2(np.abs(r).max())) - 7)
        np.testing.assert_allclose(o.float().numpy(), r, atol=tol, rtol=0)
    # the MB figure: the JAX script's sum over its volumes, at the script's shapes
    full = jax.eval_shape(jvols, jax.ShapeDtypeStruct((ab.S, ab.C, ab.H, ab.W), jnp.bfloat16),
                          jax.ShapeDtypeStruct((ab.N, ab.S, ab.C), jnp.bfloat16))
    shapes = [(ab.H >> lvl, ab.W >> lvl) for lvl in range(ab.LEVELS)]
    assert ab.volume_bytes(shapes) == sum(math.prod(v.shape) * 2 for v in full) == 940_032_000
