"""The patch-sharded backend update of batrack_tpu_torch's multi-device
path (parallel/sharded_slot_ba.py) at world 2, from the snapshot state of
tests/test_torch_ba.py: against batrack_tpu's sharded_slot_slam_update on a
2-device CPU mesh and against the port's single-process update.

The ranks are spawned gloo processes (test_torch_parallel.run_ranks) that
import this module, so it imports no JAX at the top. Tolerances as
test_torch_ba.py holds the single-device update: poses 1e-5, patches and
local targets 1e-4, edge weights exact.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from batrack_tpu_torch.parallel import sharded_slot_slam_update
from batrack_tpu_torch.slam.state import SLAMState, StaticDims
from batrack_tpu_torch.slam.update import slam_update
from test_torch_parallel import WORLD, run_ranks


def _sharded_update(mesh, cfg, n, st, ht, wd):
    state = SLAMState(**{k: torch.from_numpy(v) for k, v in st.items()})
    sharded_slot_slam_update(state, n, True, StaticDims.from_config(cfg, ht, wd), cfg.slam, mesh)
    return {f.name: getattr(state, f.name).numpy() for f in dataclasses.fields(state)}


@pytest.fixture(scope="module")
def update_runs(tmp_path_factory):
    from test_torch_ba import _port_cfg, make_snapshot
    from test_slam_e2e import HT, WD

    jcfg, dims, n, st = make_snapshot()
    ranks = run_ranks(_sharded_update, tmp_path_factory.mktemp("pg"), _port_cfg(jcfg), n, st,
                      HT, WD)
    return jcfg, dims, n, st, ranks


def test_patch_sharded_update_matches_jax_mesh(update_runs):
    """One backend update with the patches split over 2 ranks (one
    all_reduce of the pose blocks per Gauss-Newton step, the map filter
    patch-sharded) against JAX's sharded_slot_slam_update on 2 devices."""
    import jax
    import jax.numpy as jnp

    from batrack_tpu.parallel import get_mesh as jget_mesh
    from batrack_tpu.parallel.sharded_slot_ba import sharded_slot_slam_update as jupdate
    from batrack_tpu.slam import BATrack as JBATrack
    from test_slam_e2e import HT, WD

    jcfg, dims, n, st, ranks = update_runs
    jstate = JBATrack(jcfg, HT, WD).state._replace(**{k: jnp.asarray(v) for k, v in st.items()})
    update = jax.jit(functools.partial(jupdate, dims=dims, cfg=jcfg.slam,
                                       mesh=jget_mesh(WORLD, ("patch",))))
    ref = update(jstate, jnp.asarray(n, jnp.int32), jnp.asarray(True))
    assert np.abs(np.asarray(ref.poses) - st["poses"]).max() > 1e-3  # the update moved
    for r in ranks:
        np.testing.assert_allclose(r["poses"], np.asarray(ref.poses), atol=1e-5, rtol=0)
        np.testing.assert_allclose(r["patches"], np.asarray(ref.patches), atol=1e-4, rtol=0)
        np.testing.assert_allclose(r["local_targets"], np.asarray(ref.local_targets),
                                   atol=1e-4, rtol=0)
        np.testing.assert_array_equal(r["e_weight"], np.asarray(ref.e_weight))
        np.testing.assert_array_equal(r["e_weight_pose"], np.asarray(ref.e_weight_pose))


def test_patch_sharded_update_matches_single_process(update_runs):
    """The same update on the port's single-process path; both ranks end
    with the same replicated state."""
    from test_torch_ba import _port_cfg
    from test_slam_e2e import HT, WD

    jcfg, _, n, st, ranks = update_runs
    pcfg = _port_cfg(jcfg)
    state = SLAMState(**{k: torch.from_numpy(v.copy()) for k, v in st.items()})
    slam_update(state, n, True, StaticDims.from_config(pcfg, HT, WD), pcfg.slam)
    np.testing.assert_allclose(ranks[0]["poses"], state.poses.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ranks[0]["patches"], state.patches.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(ranks[0]["e_weight"], state.e_weight.numpy())
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
