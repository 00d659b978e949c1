"""batrack_tpu_torch.ba and slam_update against batrack_tpu on the same
factor graph: a mid-sequence state of the JAX BATrack (oracle tracks with
0.3 px noise on the synthetic plane scene of test_slam_e2e), poses
perturbed so the solver has work to do. Float32, CPU.

Tolerances: poses 1e-5, patches (disparities) and local targets 1e-4. The
pose blocks are summed with index_add_ where the JAX package multiplies by
one-hot matrices: the same sums in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batrack_tpu.ba import robust_weight as jrobust
from batrack_tpu.ba.slot_solver import SlotGraph as JGraph
from batrack_tpu.ba.slot_solver import slot_ba_iteration as jslot
from batrack_tpu.slam import BATrack as JBATrack
from batrack_tpu.slam import OracleTracker, StaticDims as JDims
from batrack_tpu.slam.update import slam_update as jslam_update
from batrack_tpu_torch.ba import SlotGraph, robust_weight, slot_ba_iteration
from batrack_tpu_torch.slam.state import SLAMState, StaticDims
from batrack_tpu_torch.slam.update import slam_update
from batrack_tpu_torch.utils.config import Config
from test_slam_e2e import HT, INTR, WD, gt_trajectory, plane_depth, small_config
from torch_parity import assert_close, t


@pytest.fixture(scope="module")
def snapshot():
    rng = np.random.default_rng(3)
    poses = gt_trajectory(16)
    depths = np.stack([plane_depth(p) for p in poses])
    images = rng.uniform(0, 255, size=(16, HT, WD, 3)).astype(np.float32)
    cfg = small_config()
    dims = JDims.from_config(cfg, HT, WD)
    slam = JBATrack(cfg, HT, WD, seed=0)
    slam.tracker = OracleTracker(poses, INTR, dims, noise=0.3)
    for i in range(14):
        slam(i, images[i], depths[i], INTR)
    st = {f: np.array(getattr(slam.state, f)) for f in slam.state._fields}
    st["poses"][1:slam.n, :3] += rng.normal(size=(slam.n - 1, 3)).astype(np.float32) * 0.01
    return cfg, dims, slam.n, st


def _port_cfg(cfg):
    pcfg = Config()
    for k, v in vars(cfg.slam).items():
        setattr(pcfg.slam, k, v)
    return pcfg


@pytest.mark.parametrize("structure_only", [False, True])
def test_slot_ba_iteration_matches_jax(snapshot, structure_only):
    cfg, dims, n, st = snapshot
    M, R, NS, S = dims.M, dims.ring_slots, dims.n_src, dims.S_slam
    mid = (dims.S_local + 1) // 2 - 1
    t0 = max(n - cfg.slam.OPTIMIZATION_WINDOW, 1)
    base_k = max(n - dims.patch_window, 0) * M
    kw = dict(window=dims.window, patch_window=dims.patch_window, patches_per_frame=M,
              kf_stride=dims.kf_stride, bounds=(0.0, 0.0, float(WD), float(HT)),
              ep=cfg.slam.BA_EP, lmbda=cfg.slam.BA_LMBDA, alpha=cfg.slam.BA_ALPHA,
              loss=cfg.slam.LOSS, structure_only=structure_only)

    def edges(x):
        return x.reshape((R, NS, M, S) + x.shape[1:])

    args = (st["poses"], st["patches"], st["local_targets"][:, mid, 2], st["intrinsics"])
    g = (edges(st["e_target"])[..., :2], edges(st["e_weight_pose"]), edges(st["e_valid"]),
         st["slot_start"])
    ref = jslot(*map(jnp.asarray, args), JGraph(*map(jnp.asarray, g)),
                jnp.asarray(t0), jnp.asarray(n), jnp.asarray(base_k), **kw)
    out = slot_ba_iteration(*map(t, args), SlotGraph(*map(t, g)), t0, n, base_k, **kw)
    assert_close(out[0], ref[0], atol=1e-5)
    assert_close(out[1], ref[1], atol=1e-4)
    assert np.abs(np.asarray(ref[0]) - st["poses"]).max() > 1e-3 or structure_only


def test_slam_update_matches_jax(snapshot):
    """One full backend update: 2 dual-BA passes, map filtering, windowed
    point-cloud refresh."""
    cfg, dims, n, st = snapshot
    jstate = JBATrack(cfg, HT, WD).state._replace(**{k: jnp.asarray(v) for k, v in st.items()})
    ref = jslam_update(jstate, jnp.asarray(n, jnp.int32), jnp.asarray(True), dims, cfg.slam)
    pcfg = _port_cfg(cfg)
    state = SLAMState(**{k: t(v) for k, v in st.items()})
    slam_update(state, n, True, StaticDims.from_config(pcfg, HT, WD), pcfg.slam)
    assert_close(state.poses, ref.poses, atol=1e-5)
    assert_close(state.patches, ref.patches, atol=1e-4)
    assert_close(state.local_targets, ref.local_targets, atol=1e-4)
    np.testing.assert_array_equal(state.e_weight.numpy(), np.asarray(ref.e_weight))
    np.testing.assert_array_equal(state.e_weight_pose.numpy(), np.asarray(ref.e_weight_pose))


def test_world_trajectories_match_jax(snapshot):
    """The terminal full point-cloud pass behind BATrack.world_trajectories
    (static rows collapse to the BA point, dynamic rows back-project their
    local targets); NaN rows, where the reference dehomogenises unfilled
    targets, must sit in the same places."""
    from batrack_tpu.slam.update import update_point_cloud as jcloud
    from batrack_tpu_torch.slam.update import update_point_cloud

    cfg, dims, n, st = snapshot
    jstate = JBATrack(cfg, HT, WD).state._replace(**{k: jnp.asarray(v) for k, v in st.items()})
    ref = jcloud(jstate, jnp.asarray(n, jnp.int32), dims, window_frames=None, write_world=True)
    pcfg = _port_cfg(cfg)
    state = SLAMState(**{k: t(v) for k, v in st.items()})
    update_point_cloud(state, n, StaticDims.from_config(pcfg, HT, WD), window_frames=None,
                       write_world=True)
    ref_w = np.asarray(ref.trajs_world)
    assert np.nanmax(np.abs(ref_w[: n * dims.M])) > 0
    np.testing.assert_allclose(state.trajs_world.numpy(), ref_w, atol=1e-4, rtol=1e-5)
    assert_close(state.local_targets, ref.local_targets, atol=1e-4)


@pytest.mark.parametrize("loss", ["huber", "cauchy", "trivial"])
def test_robust_weight_matches_jax(rng, loss):
    r = rng.normal(size=200).astype(np.float32) * 3
    assert_close(robust_weight(t(r), loss), jrobust(jnp.asarray(r), loss), atol=1e-6)


def test_damped_solve_redamps_on_failed_cholesky():
    """A system Cholesky rejects gives NaN (JAX's cho_factor result), which
    triggers the 10x re-damp in slot_ba_iteration."""
    from batrack_tpu_torch.ba.slot_solver import _damped_solve

    Sm = -torch.eye(6) * 5.0
    y = torch.ones(6)
    assert torch.isnan(_damped_solve(Sm, y, 0.0, 1e-4)).all()
    x = _damped_solve(torch.eye(6), y, 1.0, 0.0)
    assert_close(x, np.full(6, 0.5, np.float32), atol=1e-7)
