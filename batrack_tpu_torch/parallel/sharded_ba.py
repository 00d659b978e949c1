"""Edge-sharded flat bundle adjustment over a process group (counterpart
of batrack_tpu/parallel/sharded_ba.py).

The BA reduction is a sum over edges, so it shards along the edge axis:
each rank takes its slice of the edge arrays (zero-padded to a multiple of
the world size; padded edges are invalid) and assembles partial normal
equations, one all_reduce of the (W,W,6,6)/(W,K,6) blocks and the patch
sums per Gauss-Newton step crosses the ranks (ba/solver.py), and the
small pose solve and the retraction run replicated. No raw edge crosses
ranks. The map filter runs on the rank's edges too, and one all-gather of
its keep mask updates the replicated edge weights.
"""

from __future__ import annotations

from batrack_tpu_torch.ba.solver import BAProblem, ba_iteration
from batrack_tpu_torch.parallel.mesh import Mesh, gather_rows, shard_rows
from batrack_tpu_torch.slam.state import SLAMState, StaticDims
from batrack_tpu_torch.slam.update import (cloud_window_frames, flat_dual_ba, map_filter,
                                           update_point_cloud)
from batrack_tpu_torch.utils.config import SlamConfig

EDGE_FIELDS = ("targets", "weights", "ii", "jj", "kk", "valid")


def sharded_ba_iteration(prob: BAProblem, mesh: Mesh, **ba_kwargs):
    """One Gauss-Newton step with the edge fields of `prob` (all edges, the
    same on every rank) sharded over the mesh."""
    prob = prob._replace(**{f: shard_rows(getattr(prob, f), mesh) for f in EDGE_FIELDS})
    return ba_iteration(prob, mesh=mesh, **ba_kwargs)


def sharded_slam_update(state: SLAMState, n: int, initialized: bool, dims: StaticDims,
                        cfg: SlamConfig, mesh: Mesh) -> None:
    """Full backend update (ITER x dual BA + culling + point cloud) with the
    flat solver, edge-sharded; in place on every rank's replicated state,
    like slam/update.py::slam_update."""
    mid = (dims.S_local + 1) // 2 - 1
    E = state.e_kk.shape[0]
    kk = shard_rows(state.e_kk.long(), mesh)
    jj = shard_rows(state.e_jj.long(), mesh)
    targets = shard_rows(state.e_target[:, :2], mesh)
    state.poses, state.patches = flat_dual_ba(
        state.poses, state.patches, state.local_targets[:, mid, 2], state.intrinsics,
        targets, kk, jj, shard_rows(state.e_valid, mesh), shard_rows(state.e_weight_pose, mesh),
        shard_rows(state.e_weight, mesh), n, initialized, dims, cfg, mesh)

    if cfg.USE_MAP_FILTERING:
        map_filter(state, kk, jj, targets, dims, cfg, gather=lambda x: gather_rows(x, mesh, E))

    update_point_cloud(state, n, dims, window_frames=cloud_window_frames(cfg, dims),
                       write_world=False)
