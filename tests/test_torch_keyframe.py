"""Keyframe removal in batrack_tpu_torch against batrack_tpu: the functions
of slam/keyframe.py on the same state, then whole BATrack runs with
use_keyframe on the plane scene of tests/test_slam_e2e.py (small_config(),
KEYFRAME_INDEX=3), oracle tracks on both sides (the JAX OracleTracker and
the port's, noise 0) and JAX's patch draws injected.

Tolerances: the state shifts, the removal frames, the delta keys and
stale_rows exact; motion magnitudes 1e-5 relative; the delta poses and
the TUM poses after terminate 1e-3 (test_torch_slice.py's bar).
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batrack_tpu.slam import BATrack as JBATrack
from batrack_tpu.slam import OracleTracker as JOracle
from batrack_tpu.slam import StaticDims as JDims
from batrack_tpu.slam import keyframe as jkf
from batrack_tpu_torch.slam import BATrack, OracleTracker
from batrack_tpu_torch.slam import keyframe
from batrack_tpu_torch.slam.state import SLAMState, StaticDims
from test_slam_e2e import HT, INTR, WD, scene, small_config  # noqa: F401 (fixture)
from test_torch_slam import _port_cfg
from torch_parity import JaxDraws, assert_close


T_FRAMES = 16  # of the scene's 24: ten removal decisions (frames 6-10, 12-15)


def kf_config(thresh):
    cfg = small_config()
    cfg.slam.use_keyframe = True
    cfg.slam.KEYFRAME_INDEX = 3
    cfg.slam.KEYFRAME_THRESH = thresh
    return cfg


@pytest.fixture(scope="module")
def kept_state(scene):
    """The JAX BATrack with use_keyframe and no removal after 12 frames:
    (JAX config, dims, n, numpy state)."""
    poses, depths, images = scene
    cfg = kf_config(0.0)
    dims = JDims.from_config(cfg, HT, WD)
    slam = JBATrack(cfg, HT, WD, seed=0)
    slam.tracker = JOracle(poses, INTR, dims)
    for i in range(12):
        slam(i, images[i], depths[i], INTR)
    assert not slam.delta
    return cfg, dims, slam.n, {f: np.array(getattr(slam.state, f)) for f in slam.state._fields}


def _both(kept_state):
    cfg, jdims, n, st = kept_state
    jstate = JBATrack(cfg, HT, WD).state._replace(**{k: jnp.asarray(v) for k, v in st.items()})
    state = SLAMState(**{k: torch.from_numpy(v.copy()) for k, v in st.items()})
    return jstate, state, StaticDims.from_config(_port_cfg(cfg), HT, WD), jdims, n


def test_motion_magnitudes_match_jax(kept_state):
    jstate, state, dims, jdims, n = _both(kept_state)
    k = n - 4
    for i, j in ((k - 1, k), (k + 1, k), (k - 1, k + 2)):
        ref = float(jkf.motion_magnitude(jstate, jnp.asarray(i), jnp.asarray(j), jdims))
        got = float(keyframe.motion_magnitude(state, i, j, dims))
        assert ref > 0.1
        np.testing.assert_allclose(got, ref, rtol=1e-5)
    ref = float(jkf.motion_magnitude_pair(jstate, jnp.asarray(k - 1), jnp.asarray(k + 1),
                                          jnp.asarray(k), jdims))
    got = keyframe.motion_magnitude_pair(state, k - 1, k + 1, k, dims)
    assert got.ndim == 0
    np.testing.assert_allclose(float(got), ref, rtol=1e-5)


@pytest.mark.parametrize("offset", [3, 7])
def test_remove_keyframe_matches_jax(kept_state, offset):
    """Every buffer after deleting frame n - offset: exact (gathers only)."""
    jstate, state, dims, jdims, n = _both(kept_state)
    k = n - offset
    ref = jkf.remove_keyframe(jstate, jnp.asarray(k), jnp.asarray(n), jdims)
    keyframe.remove_keyframe(state, k, dims)
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(state, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert (state.slot_start == -1).all()
    assert (state.tstamps[:n - 1].numpy() == np.r_[np.arange(k), np.arange(k + 1, n)]).all()


@pytest.mark.parametrize("win_idx", [0, 5, 3])
def test_remove_window_frame_matches_jax(kept_state, win_idx):
    jstate, state, dims, jdims, n = _both(kept_state)
    win_idx = min(win_idx, dims.S_slam - 1)
    ref = jkf.remove_window_frame(jstate, jnp.asarray(win_idx), jdims)
    keyframe.remove_window_frame(state, win_idx, dims)
    np.testing.assert_array_equal(state.win_images.numpy(), np.asarray(ref.win_images))
    np.testing.assert_array_equal(state.win_depths.numpy(), np.asarray(ref.win_depths))


def run_pair(scene, thresh, frames=T_FRAMES):
    """JAX and port BATrack with use_keyframe over `frames` frames."""
    poses, depths, images = scene
    jcfg = kf_config(thresh)
    cfg = _port_cfg(kf_config(thresh))
    jslam = JBATrack(jcfg, HT, WD, seed=0)
    jslam.tracker = JOracle(poses, INTR, JDims.from_config(jcfg, HT, WD))
    slam = BATrack(cfg, HT, WD, seed=0, device="cpu")
    assert cfg.slam.BA_BACKEND == "flat"  # use_keyframe forces the flat solver
    slam.tracker = OracleTracker(poses, INTR, StaticDims.from_config(cfg, HT, WD), device="cpu")
    slam.draw_hook = JaxDraws(0, (16, 8))
    for i in range(frames):
        jslam(i, images[i], depths[i], INTR)
        slam(i, images[i], depths[i], INTR)
    return jslam, slam


@pytest.mark.parametrize("thresh", [2.25, 1e6])
def test_keyframe_run_matches_jax(scene, thresh, caplog):
    """2.25 sits between the run's motion magnitudes (their closest, 2.06,
    2.34 and 2.46, are 0.09 or more away), so some candidates are removed
    and some kept; 1e6 removes all."""
    jslam, slam = run_pair(scene, thresh)
    assert sorted(slam.delta) == sorted(jslam.delta)
    assert slam.delta and slam.n == jslam.n and slam.n + len(slam.delta) == T_FRAMES
    if thresh < 1e6:
        assert slam.n > 6  # some candidates were kept (n is 6 when all go)
    for t1, (t0, dP) in jslam.delta.items():
        assert slam.delta[t1][0] == t0
        assert_close(slam.delta[t1][1], np.asarray(dP), atol=1e-3)
    ref_poses, ref_ts = jslam.terminate()
    poses, ts = slam.terminate()
    assert poses.shape == (T_FRAMES, 7)  # removed frames interpolated
    np.testing.assert_array_equal(ts, ref_ts)
    assert_close(poses, ref_poses, atol=1e-3)
    with caplog.at_level(logging.WARNING):
        res, jres = slam.get_results(), jslam.get_results()
    assert any("stale" in r.message for r in caplog.records
               if r.name == "batrack_tpu_torch.slam.system")
    assert set(res) == set(jres)
    np.testing.assert_array_equal(res["stale_rows"], jres["stale_rows"])
    np.testing.assert_array_equal(res["buffer_tstamps"], jres["buffer_tstamps"])
    np.testing.assert_array_equal(res["grid_query_frames"], jres["grid_query_frames"])


def test_keyframe_kept_when_motion_large(scene):
    poses, depths, images = scene
    cfg = _port_cfg(kf_config(0.0))
    slam = BATrack(cfg, HT, WD, seed=0, device="cpu")
    slam.tracker = OracleTracker(poses, INTR, StaticDims.from_config(cfg, HT, WD), device="cpu")
    for i in range(12):
        slam(i, images[i], depths[i], INTR)
    assert slam.n == slam.counter and not slam.delta
    assert "stale_rows" not in slam.get_results()


def test_keyframe_config_warnings(caplog):
    """use_keyframe with the slot backend falls back to the flat solver
    (changing the caller's config, as the JAX package does), and a
    KEYFRAME_INDEX that can never fire with kf_stride=2 warns (davis_demo's
    shipped 4)."""
    cfg = _port_cfg(kf_config(10.0))
    cfg.slam.KEYFRAME_INDEX = 4
    assert cfg.slam.BA_BACKEND == "slot"
    with caplog.at_level(logging.WARNING):
        BATrack(cfg, HT, WD, device="cpu")
    text = " ".join(r.message for r in caplog.records)
    assert cfg.slam.BA_BACKEND == "flat"
    assert "falling back to the flat edge solver" in text
    assert "can never trigger" in text
