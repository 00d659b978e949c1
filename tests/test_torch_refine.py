"""Stage 3 of batrack_tpu_torch (refine/) against batrack_tpu.refine, in
float64: the prepared data, each loss's value and its gradient with respect
to every parameter (at init, where `_abs0` and `_safe_norm` sit on zero,
and at a random point), 8-step Adam trajectories under both schedules with
the pose frozen and free, and `get_results` with its depth table.

Tolerance: 1e-9 relative, 1e-12 absolute (float64 rounding of the
different summation orders stays near 1e-15; 1e-9 leaves room for the
eight Adam steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batrack_tpu.geometry import se3 as jse3
from batrack_tpu.refine import refine_net as jrn
from batrack_tpu.refine.trainer import global_alignment_loop as jloop
from batrack_tpu.utils.config import RefineConfig as JRefineConfig
from batrack_tpu.utils.evaluation import eval_depth_maps as jeval_depth_maps
from batrack_tpu_torch.refine import refine_net as rn
from batrack_tpu_torch.refine.trainer import global_alignment_loop
from batrack_tpu_torch.utils.config import RefineConfig
from batrack_tpu_torch.utils.evaluation import eval_depth_maps

T, N, S, H, W = 6, 8, 5, 48, 48
GRID = 4
RTOL, ATOL = 1e-9, 1e-12
FIELDS = ("trajs_scales", "frame_scales", "pose_delta", "K")


def make_results(rng):
    xy = rng.uniform(1.0, W - 2.0, (T, N, S, 2))
    xy[0, 0, 0] = [1.0, 1.0]  # inside the |xy| > 5 "flow" gate
    xy[2, 3, 2] = [0.5, 2.0]
    disp = rng.uniform(0.2, 2.0, (T, N, S))
    disp[1, 2, 1] = 5e-3  # below the 1e-2 disparity gate
    ts = np.arange(T, dtype=np.float64)
    xi = np.stack([0.05 * ts, 0.02 * np.sin(ts), 0.01 * ts, 0.02 * np.sin(ts * 0.7),
                   0.015 * np.cos(ts * 0.5) - 0.015, 0.01 * ts], -1)
    with jax.enable_x64(True):
        cams = np.asarray(jse3.matrix(jse3.exp(jnp.asarray(xi, jnp.float64))))
    intr = np.tile(np.array([40.0, 40.5, 24.0, 23.5]), (T, 1))
    intr[:, 0] += 0.25 * np.arange(T)
    dmaps = rng.uniform(0.5, 3.0, (T, H, W, 1))
    return {
        "trajs_2d_disp": np.concatenate([xy, disp[..., None]], -1),
        "dmaps": dmaps,
        "dmaps_gt": dmaps * rng.uniform(0.9, 1.1, dmaps.shape),
        "cams_T_world": cams,
        "grid_query_frames": np.array([0, 2, 5], np.int64),
        "trajs_valid": np.ones((T, N), np.float64),
        "trajs_static": (rng.uniform(0, 1, (T, N, S)) > 0.3).astype(np.float64),
        "trajs_vis": (rng.uniform(0, 1, (T, N, S)) > 0.25).astype(np.float64) * 0.95,
        "intrinsics": intr,
    }


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(7)
    results = make_results(rng)
    with jax.enable_x64(True):
        jdata = jrn.build_refine_data(results, align_depth=True, dtype=np.float64)
    data = rn.build_refine_data(results, align_depth=True, dtype=np.float64, device="cpu")
    point = {
        "trajs_scales": rng.normal(1.0, 0.3, (T, N, S)),
        "frame_scales": rng.normal(1.0, 0.5, (T, GRID, GRID)),
        "pose_delta": rng.normal(0.0, 0.02, (T, 6)),
        "K": np.array([40.3, 40.1, 24.2, 23.4]) / rn.K_SCALE,
    }
    return results, jdata, data, point


def close(port, ref, err_msg=""):
    port = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=RTOL, atol=ATOL, err_msg=err_msg)


def params_pair(jdata, data, point):
    """(JAX params, port params) at init (point None) or at `point`."""
    with jax.enable_x64(True):
        jp = jrn.init_params(jdata, GRID, dtype=jnp.float64)
        if point is not None:
            jp = jrn.RefineParams(**{k: jnp.asarray(v) for k, v in point.items()})
        jp = jax.tree.map(np.asarray, jp)
    p = rn.init_params(data, GRID, dtype=torch.float64)
    if point is not None:
        p = rn.RefineParams(**{k: torch.as_tensor(v) for k, v in point.items()})
    return jp, p


def test_data_prep_matches_jax(case):
    _, jdata, data, _ = case
    for name in rn.RefineData._fields:
        got, ref = getattr(data, name), getattr(jdata, name)
        assert got.dtype in (torch.float64, torch.int64), name
        close(got, ref, name)


LOSSES = {
    "spatial": lambda m, p, d: m.spatial_loss(p, d, (H, W)),
    "inter_frame": lambda m, p, d: m.inter_frame_loss(p, d, (H, W)),
    "inter_frame_local": lambda m, p, d: m.inter_frame_loss_local(p, d, (H, W)),
    "pts_3d": lambda m, p, d: m.pts_3d_loss(p, d, (H, W), False),
    "pts_3d_refine_K": lambda m, p, d: m.pts_3d_loss(p, d, (H, W), True),
    "cam_smooth": lambda m, p, d: m.cam_smooth_loss(p, d),
    "scale_smoothness": lambda m, p, d: m.scale_smoothness_loss(p),
    "total": lambda m, p, d: m.total_loss(p, d, (H, W), m.RefineConfig(fixed_K=False))[0],
}


@pytest.mark.parametrize("at", ["init", "random"])
@pytest.mark.parametrize("loss", sorted(LOSSES))
def test_loss_and_gradients_match_jax(case, loss, at):
    _, jdata, data, point = case
    jp, p = params_pair(jdata, data, point if at == "random" else None)
    fn = LOSSES[loss]
    with jax.enable_x64(True):
        jval, jgrad = jax.jit(jax.value_and_grad(lambda q: fn(jrn, q, jdata)))(
            jax.tree.map(jnp.asarray, jp))
    p = rn.RefineParams(*(t.clone().requires_grad_(True) for t in p))
    val = fn(rn, p, data)
    grads = torch.autograd.grad(val, list(p), allow_unused=True)
    close(val, jval, "value")
    for name, g in zip(FIELDS, grads):
        close(torch.zeros_like(getattr(p, name)) if g is None else g,
              getattr(jgrad, name), name)
    if at == "init" and loss == "scale_smoothness":
        # every neighbour difference is exactly 0 at init: zero subgradient
        assert not grads[1].any()


@pytest.mark.parametrize("fixed_pose", [True, False])
@pytest.mark.parametrize("schedule", ["cosine", "linear"])
def test_adam_trajectory_matches_jax(case, schedule, fixed_pose):
    """8 Adam steps with every loss on, from init."""
    _, jdata, data, _ = case
    kw = dict(grid_size=GRID, niter=8, lr=1e-2, schedule=schedule, fixed_pose=fixed_pose,
              fixed_K=True)
    jp, p = params_pair(jdata, data, None)
    with jax.enable_x64(True):
        jparams, jloss = jloop(jax.tree.map(jnp.asarray, jp), jdata, (H, W), JRefineConfig(**kw))
        jparams = jax.tree.map(np.asarray, jparams)
    params, loss = global_alignment_loop(p, data, (H, W), RefineConfig(**kw))
    for name in FIELDS:
        close(getattr(params, name), getattr(jparams, name), name)
    assert loss == pytest.approx(jloss, rel=RTOL)
    moved = np.abs(params.pose_delta.numpy()).max()
    assert (moved == 0.0) if fixed_pose else (moved > 0.0)


def test_get_results_and_depth_table_match_jax(case):
    results, jdata, data, _ = case
    cfg = dict(grid_size=GRID, niter=4, fixed_K=False)
    jp, p = params_pair(jdata, data, None)
    with jax.enable_x64(True):
        jparams, _ = jloop(jax.tree.map(jnp.asarray, jp), jdata, (H, W), JRefineConfig(**cfg))
        jout = jrn.get_results(jparams, jdata, results, refine_K=True)
    params, _ = global_alignment_loop(p, data, (H, W), RefineConfig(**cfg))
    out = rn.get_results(params, data, results, refine_K=True)
    assert set(out) == set(jout)
    for k in ("final_trajs_2d", "dmaps", "dmaps_scaled", "cams_T_world", "intrinsics"):
        close(out[k], jout[k], k)
    gt = results["dmaps_gt"][..., 0]
    for scaling in ("median", "lstsq", "none"):
        np.testing.assert_allclose(
            eval_depth_maps(gt, out["dmaps_scaled"][..., 0], scaling=scaling),
            jeval_depth_maps(gt, np.asarray(jout["dmaps_scaled"])[..., 0], scaling=scaling),
            rtol=1e-9, atol=1e-12)
