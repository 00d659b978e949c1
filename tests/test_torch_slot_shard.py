"""The slot BA's shard_mode="slots" in batrack_tpu_torch (each rank holds
a contiguous block of ring slots with every patch; B, E, C, w, v and the
edge counts summed by one all_reduce) at world 2 over gloo, one
Gauss-Newton step on the snapshot state of tests/test_torch_ba.py (pose
and structure-only): against the port's unsharded step, and against
batrack_tpu's slot_ba_iteration_fm with shard_mode="slots" under
shard_map on a 2-device CPU mesh, to 1e-5 on poses and depths.

The snapshot has 3 ring slots; both packages split them as 2 + 1, the
JAX side with the slot axis padded by one empty slot (slot_start -1, no
valid edge), as the port's shard_slots pads it.

The ranks are spawned gloo processes (test_torch_parallel.run_ranks) that
import this module, so it imports no JAX at the top.
"""

import numpy as np
import pytest
import torch

from batrack_tpu_torch.ba.slot_solver import SlotGraph, slot_ba_iteration_fm
from batrack_tpu_torch.parallel.sharded_slot_ba import shard_slots
from test_torch_parallel import WORLD, run_ranks

MODES = (False, True)  # structure_only


def _inputs():
    """(fm args, graph fields, t0, n, base_f, kwargs) of one step on the
    snapshot, numpy."""
    from test_slam_e2e import HT, WD
    from test_torch_ba import make_snapshot

    cfg, dims, n, st = make_snapshot()
    M, R, NS, S, Nf = dims.M, dims.ring_slots, dims.n_src, dims.S_slam, dims.N
    mid = (dims.S_local + 1) // 2 - 1

    def edges(x):
        return x.reshape((R, NS, M, S) + x.shape[1:])

    args = (st["poses"], st["patches"].reshape(Nf, M, 3),
            st["local_targets"][:, mid, 2].reshape(Nf, M), st["intrinsics"])
    g = (edges(st["e_target"])[..., :2], edges(st["e_weight_pose"]), edges(st["e_valid"]),
         st["slot_start"])
    kw = dict(window=dims.window, patch_window=dims.patch_window, patches_per_frame=M,
              kf_stride=dims.kf_stride, bounds=(0.0, 0.0, float(WD), float(HT)),
              ep=cfg.slam.BA_EP, lmbda=cfg.slam.BA_LMBDA, alpha=cfg.slam.BA_ALPHA,
              loss=cfg.slam.LOSS)
    t0 = max(n - cfg.slam.OPTIMIZATION_WINDOW, 1)
    return args, g, t0, n, max(n - dims.patch_window, 0), kw


def _port_step(args, g, t0, n, base_f, kw, mesh=None, structure_only=False):
    graph = SlotGraph(*(torch.from_numpy(np.asarray(x)) for x in g))
    if mesh is not None:
        graph = shard_slots(graph, mesh)
    poses, patches = slot_ba_iteration_fm(
        *(torch.from_numpy(np.asarray(a)) for a in args), graph, t0, n, base_f,
        mesh=mesh, structure_only=structure_only, **kw)
    return poses.numpy(), patches.numpy()


def _ranked(mesh, inputs):
    out = {}
    for so in MODES:
        out[f"poses{int(so)}"], out[f"patches{int(so)}"] = _port_step(
            *inputs, mesh=mesh, structure_only=so)
    out["slots"] = np.asarray(shard_slots(SlotGraph(*(torch.from_numpy(np.asarray(x))
                                                       for x in inputs[1])),
                                          mesh).slot_start.numpy())
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs = _inputs()
    return inputs, run_ranks(_ranked, tmp_path_factory.mktemp("pg"), inputs)


def test_slot_sharded_step_matches_unsharded(runs):
    inputs, ranks = runs
    slot_start = inputs[1][3]
    assert len(slot_start) == 3 and (slot_start >= 0).all()
    np.testing.assert_array_equal(ranks[0]["slots"], slot_start[:2])
    np.testing.assert_array_equal(ranks[1]["slots"], [slot_start[2], -1])
    for so in MODES:
        poses, patches = _port_step(*inputs, structure_only=so)
        if not so:
            assert np.abs(poses - inputs[0][0]).max() > 1e-3  # the step moved
        for r in ranks:
            np.testing.assert_allclose(r[f"poses{int(so)}"], poses, atol=1e-5, rtol=0)
            np.testing.assert_allclose(r[f"patches{int(so)}"], patches, atol=1e-5, rtol=0)
        for k in ranks[0]:
            if k != "slots":
                np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def test_slot_sharded_step_matches_jax_mesh(runs):
    import functools

    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from batrack_tpu.ba.slot_solver import SlotGraph as JGraph
    from batrack_tpu.ba.slot_solver import slot_ba_iteration_fm as jstep
    from batrack_tpu.parallel import get_mesh as jget_mesh

    (args, g, t0, n, base_f, kw), ranks = runs
    pad = [np.zeros((1,) + x.shape[1:], x.dtype) for x in g[:3]]
    g_pad = JGraph(*(jnp.asarray(np.concatenate([x, p])) for x, p in zip(g[:3], pad)),
                   slot_start=jnp.asarray(np.concatenate([g[3], [-1]]).astype(g[3].dtype)))
    mesh = jget_mesh(WORLD, ("slot",))
    spec = JGraph(targets=P("slot"), weights=P("slot"), valid=P("slot"), slot_start=P("slot"))
    for so in MODES:
        step = functools.partial(jstep, t0=jnp.asarray(t0), n=jnp.asarray(n),
                                 base_f=jnp.asarray(base_f), structure_only=so,
                                 axis_name="slot", shard_mode="slots", **kw)
        ref = jax.jit(shard_map(
            lambda p, pf, md, intr, gr: step(p, pf, md, intr, gr), mesh=mesh,
            in_specs=(P(), P(), P(), P(), spec), out_specs=(P(), P()), check_vma=False))(
                *map(jnp.asarray, args), g_pad)
        for r in ranks:
            np.testing.assert_allclose(r[f"poses{int(so)}"], np.asarray(ref[0]), atol=1e-5,
                                       rtol=0)
            np.testing.assert_allclose(r[f"patches{int(so)}"], np.asarray(ref[1]), atol=1e-5,
                                       rtol=0)
