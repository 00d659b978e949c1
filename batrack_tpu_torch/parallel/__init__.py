"""The multi-device path over torch.distributed (counterpart of
batrack_tpu/parallel/).

One process per GPU, each holding one rank of a process group (torchrun;
`init_distributed`, `get_mesh`). `BATrack(mesh=...)` and
`MDTrackerAdapter(mesh=...)` enter the path. Every rank holds the full,
replicated SLAM state and takes identical frames and random draws; only two
axes are sharded:

* the tracker's tracks (queries): correlation (K1 on the rank's tracks,
  `corr_sample_pyramid_sharded`), the flow embedding, the transformer's time
  blocks and MLPs, and the space-attention queries run on this rank's
  tracks; space attention gathers every rank's key/value lanes and runs K2
  with a `kv=` source (`fused_qkv_attention_sharded`). After each
  refinement step one all-gather of the transformer's output restores the
  full per-track state, so everything that reduces over the track axis runs
  on the full, replicated track set: the sort by first frame, the scrambled
  track-mask/visibility concat and its active count, the space-attention
  key mask, the window hand-off, and downstream the static-score quantile
  of the frontend gate. The light per-track heads after each step (feature
  update, visibility and motion heads) run replicated;
* the slot BA's patches (`sharded_slot_slam_update`): one all_reduce of the
  pose blocks per Gauss-Newton pose step, one all-gather of the patches and
  one of the map filter's keep mask per backend update; or, with the flat
  solver (BA_BACKEND="flat", forced by use_keyframe), the edges
  (`sharded_slam_update`): one all_reduce of the assembled blocks per
  Gauss-Newton step and one all-gather of the keep mask per update.

`collective_counts()` reads the calls, elements and bytes of the two
collectives the package issues (parallel/mesh.py), which bench_scaling_torch.py
holds against the models of the wire volume.

Only rank 0 writes artifacts (`BATrack.get_results(save_path=...)` and
the CLI's files).

The slot BA's other layout, shard_mode="slots" (a block of ring slots per
rank, `sharded_slot_ba.shard_slots`), is there as in the JAX package,
where no caller selects it either.

Deviations from the JAX package: batrack_tpu/parallel/sharded_tracker.py
has no module here, since MDTracker(mesh=) itself shards each refinement
step; `get_host_chip_mesh` is a flat group (parallel/mesh.py).
"""

from batrack_tpu_torch.parallel.mesh import (
    Mesh,
    collective_counts,
    gather_rows,
    get_host_chip_mesh,
    get_mesh,
    init_distributed,
    reset_collective_counts,
    shard_rows,
)
from batrack_tpu_torch.parallel.shard_kernels import (
    corr_sample_pyramid_sharded,
    fused_qkv_attention_sharded,
)
from batrack_tpu_torch.parallel.sharded_ba import sharded_ba_iteration, sharded_slam_update
from batrack_tpu_torch.parallel.sharded_slot_ba import sharded_slot_slam_update

__all__ = [
    "Mesh",
    "collective_counts",
    "corr_sample_pyramid_sharded",
    "fused_qkv_attention_sharded",
    "gather_rows",
    "get_host_chip_mesh",
    "get_mesh",
    "init_distributed",
    "reset_collective_counts",
    "shard_rows",
    "sharded_ba_iteration",
    "sharded_slam_update",
    "sharded_slot_slam_update",
]
