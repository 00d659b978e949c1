"""SLAM state checkpoint and resume (counterpart of
batrack_tpu/slam/checkpoint.py).

The whole state plus the host bookkeeping go to one .npz in the JAX
package's layout: `state_<field>` for every SLAMState field (names, order,
shapes and dtypes match the JAX state), and `meta`, a JSON string with n,
counter, append_count, is_initialized, tlist, delta and slot_info. Either
package loads the other's file.
"""

from __future__ import annotations

import dataclasses
import json
from typing import TYPE_CHECKING

import numpy as np
import torch

from batrack_tpu_torch.slam.state import SLAMState

if TYPE_CHECKING:
    from batrack_tpu_torch.slam.system import BATrack

_RING_FIELDS = {"e_kk", "e_jj", "e_target", "e_weight", "e_weight_pose", "e_valid",
                "e_static", "slot_start"}


def save_slam_state(slam: "BATrack", path: str) -> None:
    arrays = {f"state_{f.name}": getattr(slam.state, f.name).cpu().numpy()
              for f in dataclasses.fields(SLAMState)}
    meta = {
        "n": slam.n,
        "counter": slam.counter,
        "append_count": slam.append_count,
        "is_initialized": slam.is_initialized,
        "tlist": [float(t) for t in slam.tlist],
        "delta": {str(t1): [int(t0), np.asarray(dP).tolist()]
                  for t1, (t0, dP) in slam.delta.items()},
        "slot_info": [None if info is None
                      else [int(info["seq"]), [int(s) for s in info["sources"]]]
                      for info in slam._slot_info],
    }
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)


def _ring_pad(k: str, arr: np.ndarray, cur_shape, slot_unit: int, ring_saved: int):
    """A smaller saved edge-ring field padded to the configured capacity,
    or None when it cannot be.

    The ring grows with use_keyframe (+KEYFRAME_RING_EXTRA), so a
    checkpoint saved under a smaller ring gets empty slots appended
    (e_valid 0, slot_start -1, data 0) after the saved ones, whose indices
    (and the restored slot_info) stay valid. Only the leading axis may
    differ, by whole slots of the current per-slot layout: the saved
    element count must be ring_saved x the current slot_unit. As in the
    JAX package, a checkpoint of another kf_stride/S_slam/M whose per-slot
    edge count equals the current one passes this guard (ROADMAP C)."""
    if (arr.shape[1:] != tuple(cur_shape[1:]) or arr.shape[0] >= cur_shape[0]
            or arr.shape[0] != ring_saved * slot_unit or cur_shape[0] % slot_unit):
        return None
    fill = -1 if k == "slot_start" else 0
    pad = np.full((cur_shape[0] - arr.shape[0],) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def load_slam_state(slam: "BATrack", path: str) -> None:
    """Load a checkpoint of either package into `slam`, on its device (under
    a mesh, every rank's device)."""
    data = np.load(path, allow_pickle=False)
    ring_saved = int(data["state_slot_start"].shape[0])
    fields = {}
    for f in dataclasses.fields(SLAMState):
        k = f.name
        arr = data[f"state_{k}"]
        cur = getattr(slam.state, k)
        if arr.shape != tuple(cur.shape):
            migrated = None
            if k in _RING_FIELDS:
                unit = 1 if k == "slot_start" else slam.dims.edges_per_slot
                migrated = _ring_pad(k, arr, cur.shape, unit, ring_saved)
            if migrated is None:
                hint = ""
                if k in _RING_FIELDS:
                    hint = (" (edge-ring capacity differs: it is set by REMOVAL_WINDOW/"
                            "kf_stride and, when use_keyframe is on, +KEYFRAME_RING_EXTRA "
                            "— load with the same slam config the checkpoint was saved "
                            "under)")
                raise ValueError(f"checkpoint field {k} shape {arr.shape} != config shape "
                                 f"{tuple(cur.shape)}{hint}")
            arr = migrated
        fields[k] = torch.from_numpy(np.ascontiguousarray(arr)).to(cur.device)
    slam.state = SLAMState(**fields)
    meta = json.loads(str(data["meta"]))
    slam.n = int(meta["n"])
    slam.counter = int(meta["counter"])
    slam.append_count = int(meta["append_count"])
    slam.is_initialized = bool(meta["is_initialized"])
    slam.tlist = list(meta["tlist"])
    slam.delta = {int(t1): (int(v[0]), np.asarray(v[1], np.float32))
                  for t1, v in meta["delta"].items()}
    # checkpoints older than the slot allocator: rebuild the round-robin
    # state they were written under, modulo the SAVED ring size
    slot_info = meta.get("slot_info")
    R = len(slam._slot_info)
    if slot_info is None:
        slam._slot_info = [None] * R
        for seq in range(max(0, slam.append_count - ring_saved), slam.append_count):
            slam._slot_info[seq % ring_saved] = {"seq": seq, "sources": []}
    else:
        restored = [None if v is None else {"seq": v[0], "sources": list(v[1])}
                    for v in slot_info]
        # after a ring migration the appended empty slots follow the saved ones
        slam._slot_info = restored + [None] * (R - len(restored))
