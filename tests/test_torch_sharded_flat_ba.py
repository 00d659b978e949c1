"""The edge-sharded flat backend update of batrack_tpu_torch's
multi-device path (parallel/sharded_ba.py) at world 2, from the keyframe
snapshot of tests/test_torch_flat_update.py (flat solver, removed frames):
against batrack_tpu's sharded_slam_update on a 2-device CPU mesh and
against the port's single-process flat update, plus one
sharded_ba_iteration step against JAX's.

Float64 on both sides (JAX under jax.enable_x64(True)), at 1e-9 relative:
the ranks sum partial blocks in another order, which float32 would blur to
~1e-5 on this small-focal scene (test_torch_flat_update.py). Edge weights
exact. The ranks are spawned gloo processes (test_torch_parallel.run_ranks)
that import this module, so it imports no JAX at the top.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from batrack_tpu_torch.ba import BAProblem
from batrack_tpu_torch.parallel import sharded_ba_iteration, sharded_slam_update
from batrack_tpu_torch.slam.state import SLAMState, StaticDims
from batrack_tpu_torch.slam.update import slam_update
from test_torch_parallel import WORLD, run_ranks


def f64(st):
    return {k: (v.astype(np.float64) if v.dtype == np.float32 else v) for k, v in st.items()}


def _sharded(mesh, cfg, n, st, ht, wd, step):
    state = SLAMState(**{k: torch.from_numpy(v) for k, v in st.items()})
    dims = StaticDims.from_config(cfg, ht, wd)
    out = {}
    if step is not None:  # one sharded_ba_iteration of the pose pass
        prob = BAProblem(**{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                            for k, v in step[0].items()})
        p, q = sharded_ba_iteration(prob, mesh, **step[1])
        out.update(step_poses=p.numpy(), step_patches=q.numpy())
    sharded_slam_update(state, n, True, dims, cfg.slam, mesh)
    out.update({f.name: getattr(state, f.name).numpy() for f in dataclasses.fields(state)})
    return out


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


@pytest.fixture(scope="module")
def update_runs(tmp_path_factory):
    from test_slam_e2e import HT, WD
    from test_torch_flat_update import make_kf_snapshot, slam_state_problem
    from test_torch_slam import _port_cfg

    jcfg, dims, n, st = make_kf_snapshot()
    st = f64(st)
    arr, kw = slam_state_problem(jcfg, dims, n, st)
    ranks = run_ranks(_sharded, tmp_path_factory.mktemp("pg"), _port_cfg(jcfg), n, st, HT, WD,
                      (arr, kw))
    return jcfg, dims, n, st, arr, kw, ranks


def test_edge_sharded_update_matches_jax_mesh(update_runs):
    """One backend update with the edges split over 2 ranks (one
    all_reduce of the blocks per Gauss-Newton step, the map filter on each
    rank's edges) and one sharded step, against JAX's sharded_slam_update
    and sharded_ba_iteration on 2 devices."""
    import jax
    import jax.numpy as jnp

    from batrack_tpu.ba import BAProblem as JProblem
    from batrack_tpu.parallel import get_mesh as jget_mesh
    from batrack_tpu.parallel.sharded_ba import sharded_ba_iteration as jstep
    from batrack_tpu.parallel.sharded_ba import sharded_slam_update as jupdate
    from batrack_tpu.slam import BATrack as JBATrack
    from test_slam_e2e import HT, WD

    jcfg, dims, n, st, arr, kw, ranks = update_runs
    with jax.enable_x64(True):
        mesh = jget_mesh(WORLD, ("edge",))
        jstate = JBATrack(jcfg, HT, WD).state._replace(
            **{k: jnp.asarray(v) for k, v in st.items()})
        update = jax.jit(functools.partial(jupdate, dims=dims, cfg=jcfg.slam, mesh=mesh))
        ref = update(jstate, jnp.asarray(n, jnp.int32), jnp.asarray(True))
        ref = {k: np.asarray(getattr(ref, k)) for k in ref._fields}
        step = jax.jit(functools.partial(jstep, mesh=mesh, **kw))  # eager shard_map: ~60 s
        rstep = step(JProblem(**{k: jnp.asarray(v) for k, v in arr.items()}))
        rstep = [np.asarray(x) for x in rstep]
    assert ref["poses"].dtype == np.float64
    assert np.abs(ref["poses"] - st["poses"]).max() > 1e-3  # the update moved
    for r in ranks:
        for k in ("poses", "patches", "local_targets"):
            _close(r[k], ref[k])
        np.testing.assert_array_equal(r["e_weight"], ref["e_weight"])
        np.testing.assert_array_equal(r["e_weight_pose"], ref["e_weight_pose"])
        _close(r["step_poses"], rstep[0])
        _close(r["step_patches"], rstep[1])


def test_edge_sharded_update_matches_single_process(update_runs):
    """The same update on the port's single-process flat path; both ranks
    end with the same replicated state."""
    from test_slam_e2e import HT, WD
    from test_torch_slam import _port_cfg

    jcfg, _, n, st, _, _, ranks = update_runs
    pcfg = _port_cfg(jcfg)
    assert pcfg.slam.BA_BACKEND == "flat"
    state = SLAMState(**{k: torch.from_numpy(v.copy()) for k, v in st.items()})
    slam_update(state, n, True, StaticDims.from_config(pcfg, HT, WD), pcfg.slam)
    for k in ("poses", "patches", "local_targets"):
        _close(ranks[0][k], getattr(state, k).numpy())
    np.testing.assert_array_equal(ranks[0]["e_weight"], state.e_weight.numpy())
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
