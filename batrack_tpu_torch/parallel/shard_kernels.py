"""Track-sharded wrappers of the kernels K1 and K2 (counterpart of
batrack_tpu/parallel/shard_kernels.py).

* Correlation sampling is per-track work: shard the track axis, keep the
  (small) feature pyramid replicated, no communication.
* Space attention mixes tracks: each rank holds the query rows of its
  tracks and gathers the key/value lanes of every rank once per call (the
  q lanes stay local, a third less than gathering packed rows), then runs
  K2 with a `kv=` source on its local queries against the full keys.

Both pad the track axis to a multiple of the world size; padded tracks are
dead weight (their correlation rows are sliced off by the caller's gather,
and padded keys are masked out of every softmax).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from batrack_tpu_torch.ops.attention import fused_qkv_attention
from batrack_tpu_torch.ops.corr_kernel import CorrPyramid, corr_sample
from batrack_tpu_torch.parallel.mesh import Mesh, gather_rows, shard_rows


def corr_sample_pyramid_sharded(pyramid: CorrPyramid, targets: torch.Tensor,
                                coords: torch.Tensor, radius: int, mesh: Mesh) -> torch.Tensor:
    """K1 on this rank's tracks. targets (N, S, C) and coords (S, N, 2)
    hold every track (replicated); returns this rank's rows
    (ceil(N / world), S, L*(2r+1)^2) of the track axis padded to a multiple
    of the world size, the layout shard_rows gives every other per-track
    array."""
    return corr_sample(pyramid, shard_rows(targets, mesh, 0), shard_rows(coords, mesh, 1),
                       radius)


def fused_qkv_attention_sharded(qkv: torch.Tensor, heads: int, scale: float, mesh: Mesh,
                                key_mask: Optional[torch.Tensor] = None,
                                attend: Callable = fused_qkv_attention) -> torch.Tensor:
    """K2 with the query/track axis sharded over the mesh.

    qkv (B, n_loc, 3C) holds this rank's rows (shard_rows layout); key_mask
    (n_loc,) those rows' keys, False for padded rows, or None when every key
    is live. One all-gather of the key/value lanes qkv[..., C:] (and of the
    mask) gives every rank all keys; the output (B, n_loc, C) stays local.
    attend: K2 or its plain version (the caller's choice, as for one
    device)."""
    C = qkv.shape[-1] // 3
    n_all = qkv.shape[1] * mesh.size
    kv = gather_rows(qkv[..., C:], mesh, n_all, dim=1)
    mask = None if key_mask is None else gather_rows(key_mask, mesh, n_all)
    return attend(qkv, heads, scale, mask, kv=kv)
