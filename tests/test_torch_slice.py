"""The sparse-SLAM slice of batrack_tpu_torch as a whole against
batrack_tpu: BATrack + MDTrackerAdapter over 12 frames of the plane scene
of tests/test_slam_e2e.py (48x64, small_config()), with the small
ModelConfig of test_slam_e2e.py (S=4, one block per transformer, float32),
the weights carried across and JAX's random draws injected. Tolerance 1e-3
on the TUM poses; edge weights, timestamps and the gated result arrays
exact.
"""

import jax
import jax.numpy as jnp
import numpy as np

from batrack_tpu.slam import BATrack as JBATrack
from batrack_tpu.tracker.adapter import MDTrackerAdapter as JAdapter
from batrack_tpu.tracker.convert import convert_state_dict
from batrack_tpu.utils.config import ModelConfig as JModelConfig
from batrack_tpu_torch.slam import BATrack
from batrack_tpu_torch.tracker import MDTrackerAdapter
from batrack_tpu_torch.utils.config import ModelConfig
from test_slam_e2e import HT, INTR, WD, small_config
from test_torch_slam import _port_cfg, scene  # noqa: F401 (fixture)
from torch_parity import JaxDraws, assert_close, damp_flow_heads

MODEL = dict(S=4, sliding_window_len=4, I=1, static_iters=1, space_depth=1, time_depth=1,
             space_depth_dyn=1, time_depth_dyn=1, interp_shape=(HT, WD),
             compute_dtype="float32")


def test_whole_slice_matches_jax(scene):
    """BATrack + MDTrackerAdapter, 12 frames, against the JAX package.

    Random tracker weights give arbitrary tracks; VIS_THRESHOLD=0 lets them
    into the BA, and the flow heads are damped (torch_parity.damp_flow_heads)
    so the BA stays well conditioned: at full scale the random tracks leave
    it near-singular and float32 rounding grows to 1e-2 in the poses. The
    weights of every edge must agree exactly, so no gate flips between the
    two runs. Patch disparities are not compared: with random tracks they
    are ill-determined, and scaling the port's own tracks by 1 + 1e-6 moves
    them by up to 1e-2 relative after 12 frames while the poses move by
    3e-4; the backend update is held to 1e-4 on them in test_torch_ba."""
    poses_gt, depths, images = scene
    jcfg = small_config()
    jcfg.slam.VIS_THRESHOLD = 0.0
    cfg = _port_cfg(jcfg)

    ad = MDTrackerAdapter(ModelConfig(**MODEL, use_pallas_corr=False), seed=0, device="cpu")
    damp_flow_heads(ad.model)
    sd = {k: v.numpy() for k, v in ad.model.state_dict().items()}
    params = jax.tree.map(jnp.asarray, convert_state_dict(
        sd, time_depth=1, space_depth=1, time_depth_dyn=1, space_depth_dyn=1))

    jslam = JBATrack(jcfg, HT, WD, seed=0)
    jslam.tracker = JAdapter(JModelConfig(**MODEL), params=params)
    slam = BATrack(cfg, HT, WD, seed=0, device="cpu")
    slam.tracker = ad
    slam.draw_hook = JaxDraws(0, (16, 8))
    for i in range(12):
        jslam(i, images[i], depths[i], INTR)
        slam(i, images[i], depths[i], INTR)

    ref_poses, ref_ts = jslam.terminate()
    poses, ts = slam.terminate()
    np.testing.assert_array_equal(ts, ref_ts)
    assert np.abs(ref_poses[-1, :3]).max() > 1e-3  # the loop moved the camera
    assert_close(poses, ref_poses, atol=1e-3)
    np.testing.assert_array_equal(slam.state.e_weight.numpy(), np.asarray(jslam.state.e_weight))
    assert slam.state.e_weight.sum() > 0

    res, jres = slam.get_results(), jslam.get_results()
    assert set(res) == set(jres)
    for k, v in jres.items():
        if v is not None and k not in ("cams_T_world", "trajs_2d_disp"):
            np.testing.assert_array_equal(np.asarray(res[k]), np.asarray(v), err_msg=k)
    assert_close(res["cams_T_world"], jres["cams_T_world"], atol=1e-3)
