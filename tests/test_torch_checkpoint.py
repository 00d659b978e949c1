"""SLAM checkpoints across the two packages: batrack_tpu_torch's
save_state/load_state against batrack_tpu's, on the plane scene of
tests/test_slam_e2e.py with use_keyframe (KEYFRAME_INDEX=3, some frames
removed, so the delta dict is not empty), oracle tracks on both sides and
JAX's patch draws injected.

A checkpoint written by either package loads in the other, with the same
arrays and bookkeeping, and the two resumed runs end at the same TUM poses
(1e-3, test_torch_slice.py's bar); both resumes restart the patch draws
from the seed, as the JAX package's load does. The port's own round trip
is exact. The smaller-ring migration pads as the JAX package does; a larger
saved ring and a kf_stride mismatch raise with the ring hint.
"""

import numpy as np
import pytest

from batrack_tpu.slam import BATrack as JBATrack
from batrack_tpu.slam import OracleTracker as JOracle
from batrack_tpu.slam import StaticDims as JDims
from batrack_tpu_torch.slam import BATrack, OracleTracker
from batrack_tpu_torch.slam.state import StaticDims
from test_slam_e2e import HT, INTR, WD, scene, small_config  # noqa: F401 (fixture)
from test_torch_slam import _port_cfg
from torch_parity import JaxDraws, assert_close

# 16 of the scene's 24 frames: the first removal is at frame 6, so the
# checkpoint at frame 8 carries a delta, and four more decisions follow
T_FRAMES, HALF = 16, 8
SHORT = 6  # frames before a save whose only use is its shapes


def kf_config(ring_extra=8):
    return small_config_with(use_keyframe=True, KEYFRAME_INDEX=3, KEYFRAME_THRESH=3.05,
                             KEYFRAME_RING_EXTRA=ring_extra)


def jax_slam(scene, cfg):
    slam = JBATrack(cfg, HT, WD, seed=0)
    slam.tracker = JOracle(scene[0], INTR, JDims.from_config(cfg, HT, WD))
    return slam


def port_slam(scene, cfg):
    cfg = _port_cfg(cfg)
    slam = BATrack(cfg, HT, WD, seed=0, device="cpu")
    slam.tracker = OracleTracker(scene[0], INTR, StaticDims.from_config(cfg, HT, WD),
                                 device="cpu")
    slam.draw_hook = JaxDraws(0, (16, 8))
    return slam


def run(slam, scene, frames):
    _, depths, images = scene
    for i in frames:
        slam(i, images[i], depths[i], INTR)
    return slam


@pytest.fixture(scope="module")
def saved(scene, tmp_path_factory):
    """Each package's checkpoint after HALF frames: (jax path, port path)."""
    d = tmp_path_factory.mktemp("ckpt")
    j = run(jax_slam(scene, kf_config()), scene, range(HALF))
    p = run(port_slam(scene, kf_config()), scene, range(HALF))
    assert j.delta and sorted(j.delta) == sorted(p.delta)
    j.save_state(str(d / "jax.npz"))
    p.save_state(str(d / "port.npz"))
    return str(d / "jax.npz"), str(d / "port.npz")


def test_checkpoint_files_match(saved):
    """Same fields, dtypes and shapes in both files; equal bookkeeping; the
    arrays of the two half runs agree (poses at 1e-3, exact elsewhere but
    for the floats the BA and the cloud write)."""
    import json

    jf, pf = (np.load(p) for p in saved)
    assert list(jf.keys()) == list(pf.keys())
    for k in jf.keys():
        if k == "meta":
            continue
        assert jf[k].dtype == pf[k].dtype and jf[k].shape == pf[k].shape, k
    jm, pm = json.loads(str(jf["meta"])), json.loads(str(pf["meta"]))
    assert jm.keys() == pm.keys()
    for k in ("n", "counter", "append_count", "is_initialized", "tlist", "slot_info"):
        assert jm[k] == pm[k], k
    assert jm["delta"].keys() == pm["delta"].keys()
    for k in ("state_tstamps", "state_e_kk", "state_e_jj", "state_e_valid", "state_slot_start",
              "state_colors"):
        np.testing.assert_array_equal(pf[k], jf[k], err_msg=k)
    assert_close(pf["state_poses"], jf["state_poses"], atol=1e-3)


@pytest.mark.parametrize("source", ["jax", "port"])
def test_checkpoint_crosses_packages(scene, saved, source):
    """The checkpoint of `source` loaded in both packages; both resumed
    runs reach the same poses."""
    path = saved[0] if source == "jax" else saved[1]
    j = jax_slam(scene, kf_config())
    j.load_state(path)
    p = port_slam(scene, kf_config())
    p.load_state(path)
    assert (p.n, p.counter, p.append_count, p.is_initialized) == (
        j.n, j.counter, j.append_count, j.is_initialized)
    assert sorted(p.delta) == sorted(j.delta) and p._slot_info == j._slot_info
    for f in j.state._fields:
        np.testing.assert_array_equal(getattr(p.state, f).numpy(),
                                      np.asarray(getattr(j.state, f)), err_msg=f)
    run(j, scene, range(HALF, T_FRAMES))
    run(p, scene, range(HALF, T_FRAMES))
    ref_poses, ref_ts = j.terminate()
    poses, ts = p.terminate()
    assert poses.shape == (T_FRAMES, 7)
    np.testing.assert_array_equal(ts, ref_ts)
    assert_close(poses, ref_poses, atol=1e-3)


def test_port_round_trip_is_exact(scene, saved, tmp_path):
    p = port_slam(scene, kf_config())
    p.load_state(saved[1])
    p.save_state(str(tmp_path / "again.npz"))
    q = port_slam(scene, kf_config())
    q.load_state(str(tmp_path / "again.npz"))
    for f in ("n", "counter", "append_count", "is_initialized", "tlist", "_slot_info"):
        assert getattr(q, f) == getattr(p, f), f
    assert sorted(q.delta) == sorted(p.delta)
    for t1 in p.delta:
        assert q.delta[t1][0] == p.delta[t1][0]
        np.testing.assert_array_equal(q.delta[t1][1], p.delta[t1][1])
    for f in p.state.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(q.state, f).numpy(), getattr(p.state, f).numpy())


def test_smaller_saved_ring_is_padded_like_jax(scene, tmp_path):
    """A checkpoint of a smaller ring (KEYFRAME_RING_EXTRA 2) loads into the
    configured ring of 8: saved slots kept index for index, empty slots
    appended, the same state as the JAX package's migration; the run
    resumes."""
    old = run(port_slam(scene, kf_config(ring_extra=2)), scene, range(HALF))
    path = str(tmp_path / "old.npz")
    old.save_state(path)
    j = jax_slam(scene, kf_config())
    j.load_state(path)
    p = port_slam(scene, kf_config())
    p.load_state(path)
    R_old = old.state.slot_start.shape[0]
    assert p.state.slot_start.shape[0] > R_old
    assert (p.state.slot_start[R_old:] == -1).all()
    assert len(p._slot_info) == p.dims.ring_slots and p._slot_info == j._slot_info
    for f in j.state._fields:
        np.testing.assert_array_equal(getattr(p.state, f).numpy(),
                                      np.asarray(getattr(j.state, f)), err_msg=f)
    run(p, scene, range(HALF, T_FRAMES))
    assert np.isfinite(p.terminate()[0]).all()


def test_larger_ring_and_kf_stride_mismatch_raise(scene, tmp_path):
    """A larger saved ring raises; so does a kf_stride mismatch whose edge
    count would divide into the new slots (REMOVAL_WINDOW 8: 4 slots x 128
    edges saved, 256-edge slots configured)."""
    big = run(port_slam(scene, kf_config(ring_extra=8)), scene, range(SHORT))
    big.save_state(str(tmp_path / "big.npz"))
    with pytest.raises(ValueError, match="edge-ring capacity"):
        port_slam(scene, kf_config(ring_extra=2)).load_state(str(tmp_path / "big.npz"))

    saver = run(port_slam(scene, small_config_with(REMOVAL_WINDOW=8)), scene, range(SHORT))
    saver.save_state(str(tmp_path / "kf2.npz"))
    cfg_l = small_config_with(REMOVAL_WINDOW=8, kf_stride=1)
    for loader in (port_slam(scene, cfg_l), jax_slam(scene, cfg_l)):
        with pytest.raises(ValueError, match="edge-ring capacity"):
            loader.load_state(str(tmp_path / "kf2.npz"))


def test_ring_guard_quirk_matches_jax(scene, tmp_path):
    """The JAX package's ring guard (slam/checkpoint.py:57-63) checks the
    saved edge count against the CURRENT per-slot size only. With S_slam 4,
    kf_stride 4 and 3 both give one source slot per append (4 // 4 ==
    4 // 3), so a kf_stride-4 checkpoint loads into a kf_stride-3 config
    with a larger ring (REMOVAL_WINDOW 8 -> 12: 2 -> 4 slots), its slots
    reinterpreted. The port keeps the quirk (ROADMAP C): both packages
    load the file to the same state."""
    saver = run(port_slam(scene, small_config_with(kf_stride=4, REMOVAL_WINDOW=8)), scene,
                range(SHORT))
    saver.save_state(str(tmp_path / "kf4.npz"))
    cfg = small_config_with(kf_stride=3, REMOVAL_WINDOW=12)
    j, p = jax_slam(scene, cfg), port_slam(scene, cfg)
    for loader in (j, p):
        loader.load_state(str(tmp_path / "kf4.npz"))
    assert p.state.slot_start.shape[0] == 4 > saver.state.slot_start.shape[0]
    for f in j.state._fields:
        np.testing.assert_array_equal(getattr(p.state, f).numpy(),
                                      np.asarray(getattr(j.state, f)), err_msg=f)


def small_config_with(**slam):
    cfg = small_config()
    for k, v in slam.items():
        setattr(cfg.slam, k, v)
    return cfg
