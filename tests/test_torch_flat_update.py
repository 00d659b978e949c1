"""The flat edge solver and the flat branch of slam_update of
batrack_tpu_torch against batrack_tpu on a SLAM state: a mid-sequence
state of the JAX BATrack with use_keyframe (oracle tracks with 0.3 px
noise on the plane scene of test_slam_e2e, keyframes removed, so the edge
ring holds invalidated and shifted edges), poses perturbed. The synthetic
problems of tests/test_ba.py are in test_torch_flat_ba.py.

Tolerances: float64 at 1e-9 relative (1e-12 absolute) with JAX under
jax.enable_x64(True). float32: the two packages' steps land ~1e-5 apart
on this small-focal scene, each rounding its own way, so the port's
float32 result must be as close to the float64 one as JAX's (2x, or 1e-6)
and within test_torch_ba.py's 1e-4 of JAX's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batrack_tpu.slam import BATrack as JBATrack
from batrack_tpu.slam import OracleTracker, StaticDims as JDims
from batrack_tpu.slam.update import slam_update as jslam_update
from batrack_tpu_torch.slam.state import SLAMState, StaticDims
from batrack_tpu_torch.slam.update import slam_update
from test_slam_e2e import HT, INTR, WD, gt_trajectory, plane_depth, small_config
from test_torch_flat_ba import close64, run_both
from test_torch_slam import _port_cfg
from torch_parity import assert_close


def make_kf_snapshot():
    """(JAX config, dims, n, numpy state) of the JAX BATrack with
    use_keyframe after 14 frames (removals included), poses perturbed."""
    rng = np.random.default_rng(3)
    poses = gt_trajectory(16)
    depths = np.stack([plane_depth(p) for p in poses])
    images = rng.uniform(0, 255, size=(16, HT, WD, 3)).astype(np.float32)
    cfg = small_config()
    cfg.slam.use_keyframe = True
    cfg.slam.KEYFRAME_INDEX = 3
    cfg.slam.KEYFRAME_THRESH = 3.05
    dims = JDims.from_config(cfg, HT, WD)
    slam = JBATrack(cfg, HT, WD, seed=0)
    slam.tracker = OracleTracker(poses, INTR, dims, noise=0.3)
    for i in range(14):
        slam(i, images[i], depths[i], INTR)
    assert slam.delta and cfg.slam.BA_BACKEND == "flat"
    st = {f: np.array(getattr(slam.state, f)) for f in slam.state._fields}
    st["poses"][1:slam.n, :3] += rng.normal(size=(slam.n - 1, 3)).astype(np.float32) * 0.01
    return cfg, dims, slam.n, st


@pytest.fixture(scope="module")
def kf_snapshot():
    return make_kf_snapshot()


def slam_state_problem(cfg, dims, n, st):
    """The flat problem of the snapshot's pose pass (arrays dict, step kw)."""
    Mf = dims.M
    mid = (dims.S_local + 1) // 2 - 1
    arr = dict(poses=st["poses"], patches=st["patches"], monodisp=st["local_targets"][:, mid, 2],
               intrinsics=st["intrinsics"], targets=st["e_target"][:, :2],
               weights=st["e_weight_pose"], ii=st["e_kk"] // Mf, jj=st["e_jj"], kk=st["e_kk"],
               valid=st["e_valid"], t0=max(n - cfg.slam.OPTIMIZATION_WINDOW, 1), n=n,
               base_k=max(n - dims.patch_window, 0) * Mf)
    kw = dict(window=dims.window, patch_window=dims.patch_window, patches_per_frame=Mf,
              bounds=(0.0, 0.0, float(WD), float(HT)), ep=cfg.slam.BA_EP,
              lmbda=cfg.slam.BA_LMBDA, alpha=cfg.slam.BA_ALPHA, loss=cfg.slam.LOSS)
    return arr, kw


@pytest.mark.parametrize("structure_only", [False, True])
def test_flat_step_on_slam_state(kf_snapshot, structure_only):
    """One step on the keyframe run's edge ring (invalidated and shifted
    edges, the patch window past frame 0). float64 at 1e-9 against JAX.
    float32: the scene's Hessian is ~100x smaller than at a real focal
    length and float32 steps of the two packages land ~1e-5 apart, each
    ~7e-6 from the float64 step, in different directions; so the port's
    float32 step must be as close to the float64 step as JAX's (within 2x,
    or 1e-6), and within test_torch_ba.py's 1e-4 of JAX's."""
    arr, kw = slam_state_problem(*kf_snapshot)
    assert arr["base_k"] > 0 and (arr["valid"] == 0).any()
    kw["structure_only"] = structure_only
    a64 = {k: (v.astype(np.float64) if isinstance(v, np.ndarray) and v.dtype == np.float32
               else v) for k, v in arr.items()}
    (p64, q64), (rp64, rq64) = run_both(a64, **kw)
    close64(p64, rp64)
    close64(q64, rq64)
    (p32, q32), (rp32, rq32) = run_both(arr, **kw)
    for port, ref, exact in ((p32, rp32, rp64), (q32, rq32, rq64)):
        assert np.abs(port - exact).max() <= max(2.0 * np.abs(ref - exact).max(), 1e-6)
        assert_close(port, ref, atol=1e-4)
    assert np.abs(rp64 - arr["poses"]).max() > 1e-3 or structure_only


def _updates(cfg, dims, n, st, dtype):
    """(port state, JAX state) after one slam_update of the snapshot, with
    the float fields in `dtype`."""
    st = {k: (v.astype(dtype) if v.dtype == np.float32 else v) for k, v in st.items()}
    with jax.enable_x64(dtype == np.float64):
        jstate = JBATrack(cfg, HT, WD).state._replace(
            **{k: jnp.asarray(v) for k, v in st.items()})
        # eager: the map filter's float32 decisions match the port's there;
        # under jit XLA fuses the reprojection and one edge at the
        # threshold flips (float64 decisions are held equal either way)
        ref = jslam_update(jstate, jnp.asarray(n, jnp.int32), jnp.asarray(True), dims, cfg.slam)
        ref = {k: np.asarray(getattr(ref, k)) for k in ("poses", "patches", "local_targets",
                                                         "e_weight")}
    pcfg = _port_cfg(cfg)
    assert pcfg.slam.BA_BACKEND == "flat"
    state = SLAMState(**{k: torch.from_numpy(v.copy()) for k, v in st.items()})
    slam_update(state, n, True, StaticDims.from_config(pcfg, HT, WD), pcfg.slam)
    return state, ref


@pytest.mark.parametrize("iters", [2, 4])
def test_flat_slam_update_matches_jax(kf_snapshot, iters):
    """One backend update with BA_BACKEND="flat": ITER x dual BA (2, the
    small config's, and the 4x chain of the shipped configs), map
    filtering and the windowed point cloud. float64 at 1e-9 against JAX;
    float32 as close to the float64 update as JAX's (2x, or 1e-6) and
    within test_torch_ba.py's bars of JAX's (poses 1e-5 there on the slot
    solver; 1e-4 here, see test_flat_step_on_slam_state)."""
    cfg, dims, n, st = kf_snapshot
    cfg = copy.deepcopy(cfg)
    cfg.slam.ITER = iters
    s64, r64 = _updates(cfg, dims, n, st, np.float64)
    for k in ("poses", "patches", "local_targets"):
        close64(getattr(s64, k).numpy(), r64[k])
    np.testing.assert_array_equal(s64.e_weight.numpy(), r64["e_weight"])
    s32, r32 = _updates(cfg, dims, n, st, np.float32)
    for k in ("poses", "patches"):
        port, ref, exact = getattr(s32, k).numpy(), r32[k], r64[k]
        assert np.abs(port - exact).max() <= max(2.0 * np.abs(ref - exact).max(), 1e-6), k
        assert_close(port, ref, atol=1e-4)
    np.testing.assert_array_equal(s32.e_weight.numpy(), r32["e_weight"])
