"""The world-2 sparse-SLAM loop of test_torch_mesh_slice.py (two spawned
gloo ranks of BATrack(mesh=) + MDTrackerAdapter(mesh=)) against
batrack_tpu's BATrack(mesh=get_mesh(2)) with its mesh-aware adapter on a
2-device CPU mesh, same inputs and weights: timestamps exact, TUM poses
1e-3. A file of its own because the JAX mesh run compiles for about 40 s.
"""

import jax
import jax.numpy as jnp
import numpy as np

from batrack_tpu.parallel import get_mesh as jget_mesh
from batrack_tpu.slam import BATrack as JBATrack
from batrack_tpu.tracker.adapter import MDTrackerAdapter as JAdapter
from batrack_tpu.tracker.convert import convert_state_dict
from batrack_tpu.utils.config import ModelConfig as JModelConfig
from test_torch_mesh_slice import FRAMES, MODEL, world2_run
from test_torch_parallel import WORLD


def test_world2_loop_matches_jax_mesh(tmp_path):
    jcfg, _, state_dict, (images, depths, intr), _, ranks = world2_run(tmp_path)
    ht, wd = images.shape[1:3]
    params = jax.tree.map(jnp.asarray, convert_state_dict(
        {k: v.numpy() for k, v in state_dict.items()},
        time_depth=1, space_depth=1, time_depth_dyn=1, space_depth_dyn=1))
    mesh = jget_mesh(WORLD, ("track",))
    jmodel = {k: v for k, v in MODEL.items() if k != "use_pallas_corr"}
    jslam = JBATrack(jcfg, ht, wd, seed=0, mesh=mesh)
    jslam.tracker = JAdapter(JModelConfig(**jmodel, interp_shape=(ht, wd)), params=params,
                             mesh=mesh)
    for i in range(FRAMES):
        jslam(i, images[i], depths[i], intr)
    ref_poses, ref_ts = jslam.terminate()
    np.testing.assert_array_equal(ranks[0]["ts"], ref_ts)
    np.testing.assert_allclose(ranks[0]["poses"], ref_poses, atol=1e-3, rtol=0)
