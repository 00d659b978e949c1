"""The whole multi-device sparse-SLAM loop of batrack_tpu_torch at world 2:
BATrack(mesh=) + MDTrackerAdapter(mesh=) on two spawned gloo ranks, in the
setup of test_torch_slice.py (the plane scene of test_slam_e2e.py, its
small config with VIS_THRESHOLD=0, the small float32 ModelConfig, damped
flow heads, JAX's random draws injected, 12 frames).

Held against the port's own single-process loop: poses 1e-3 on the TUM
trajectory, timestamps and edge weights exact, and both ranks end with the
same replicated state. test_torch_mesh_slice_jax.py holds the same run
against batrack_tpu's BATrack(mesh=get_mesh(2)). The ranks import this
module, so it imports no JAX at the top.
"""

import numpy as np
import torch

from batrack_tpu_torch.slam import BATrack
from batrack_tpu_torch.tracker import MDTrackerAdapter
from batrack_tpu_torch.utils.config import ModelConfig
from test_torch_parallel import run_ranks

MODEL = dict(S=4, sliding_window_len=4, I=1, static_iters=1, space_depth=1, time_depth=1,
             space_depth_dyn=1, time_depth_dyn=1, compute_dtype="float32",
             use_pallas_corr=False)
FRAMES = 12


def drive(mesh, cfg, state_dict, scene, draws):
    """The port's loop over the scene: (TUM poses, tstamps, edge weights)."""
    images, depths, intr = scene
    ht, wd = images.shape[1:3]
    ad = MDTrackerAdapter(ModelConfig(**MODEL, interp_shape=(ht, wd)), state_dict=state_dict,
                          device="cpu", mesh=mesh)
    slam = BATrack(cfg, ht, wd, seed=0, device="cpu", mesh=mesh)
    slam.tracker = ad
    slam.draw_hook = lambda counter: tuple(torch.from_numpy(d) for d in draws[counter])
    for i in range(FRAMES):
        slam(i, images[i], depths[i], intr)
    poses, ts = slam.terminate()
    return {"poses": poses, "ts": ts, "e_weight": slam.state.e_weight.numpy(),
            "all_poses": slam.state.poses.numpy()}


def world2_run(tmp_path):
    """The inputs and both ranks' results: (JAX config, port config, weights,
    scene, draws, ranks)."""
    from test_slam_e2e import INTR, gt_trajectory, plane_depth, small_config
    from test_torch_slam import _port_cfg
    from torch_parity import JaxDraws, damp_flow_heads

    rng = np.random.default_rng(3)  # test_torch_slam's scene
    depths = np.stack([plane_depth(p) for p in gt_trajectory(16)])
    images = rng.uniform(0, 255, size=(16,) + depths.shape[1:] + (3,)).astype(np.float32)
    jcfg = small_config()
    jcfg.slam.VIS_THRESHOLD = 0.0
    cfg = _port_cfg(jcfg)
    ht, wd = images.shape[1:3]
    ad = MDTrackerAdapter(ModelConfig(**MODEL, interp_shape=(ht, wd)), seed=0, device="cpu")
    state_dict = {k: v.clone() for k, v in damp_flow_heads(ad.model).state_dict().items()}
    jd = JaxDraws(0, (16, 8))
    draws = [tuple(x.numpy() for x in jd(i)) for i in range(FRAMES)]
    scene = (images[:FRAMES], depths[:FRAMES], INTR)
    ranks = run_ranks(drive, tmp_path, cfg, state_dict, scene, draws)
    return jcfg, cfg, state_dict, scene, draws, ranks


def test_world2_loop_matches_single_process(tmp_path):
    _, cfg, state_dict, scene, draws, ranks = world2_run(tmp_path)
    single = drive(None, cfg, state_dict, scene, draws)
    assert np.abs(single["poses"][-1, :3]).max() > 1e-3  # the loop moved the camera
    assert single["e_weight"].sum() > 0
    for r in ranks:
        np.testing.assert_allclose(r["poses"], single["poses"], atol=1e-3, rtol=0)
        np.testing.assert_array_equal(r["ts"], single["ts"])
        np.testing.assert_array_equal(r["e_weight"], single["e_weight"])
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
