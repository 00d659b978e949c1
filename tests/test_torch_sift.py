"""PATCH_GEN="sift" and the track video in batrack_tpu_torch against
batrack_tpu:

* slam/ingest.py::generate_patches_sift bitwise equal to the JAX package's
  for the same frame and seed (both call cv2's SIFT and draw from numpy
  Generators), with keypoints cut to M, with a shortfall padded by random
  points, and on a blank frame (all padding);
* a whole BATrack run on the plane scene of tests/test_slam_e2e.py with
  PATCH_GEN="sift", the oracle tracker and a TrackVisualizer on both
  sides: the same patch coordinates in every buffer row, TUM poses within
  1e-3, and each append's add_track payload within 1e-3 of JAX's
  (targets, weights and static labels in the (S, NS*M) layout);
* utils/visualizer.py::TrackVisualizer: given the same frames and payloads
  (JAX's), the drawn frames are bitwise equal to the JAX visualizer's,
  with static labels and without; the written mp4 reads back with one
  frame per frame added, and a writer cv2 cannot open raises;
* without cv2 both features raise a RuntimeError naming them.
"""

import builtins

import numpy as np
import pytest

from batrack_tpu.slam import BATrack as JBATrack
from batrack_tpu.slam import OracleTracker as JOracle
from batrack_tpu.slam import StaticDims as JDims
from batrack_tpu.slam.ingest import generate_patches_sift as jsift
from batrack_tpu.utils.visualizer import TrackVisualizer as JVisualizer
from batrack_tpu_torch.slam import BATrack, OracleTracker
from batrack_tpu_torch.slam.ingest import generate_patches_sift
from batrack_tpu_torch.utils.visualizer import TrackVisualizer, video_frame_count
from test_slam_e2e import HT, INTR, WD, scene, small_config  # noqa: F401 (fixture)
from test_torch_slam import _port_cfg
from torch_parity import assert_close

cv2 = pytest.importorskip("cv2")
FRAMES = 14


def _frame(seed, h=120, w=160):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    blobs = 120 + 100 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
    img = np.stack([blobs, blobs[::-1], blobs[:, ::-1]], -1) + rng.normal(0, 20, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("M,kind", [(64, "cut"), (4000, "padded"), (50, "blank")])
def test_sift_patches_match_jax(M, kind):
    img = np.full((120, 160, 3), 77, np.uint8) if kind == "blank" else _frame(1)
    got = generate_patches_sift(img, M=M, ht=120, wd=160, rng=np.random.default_rng(5))
    ref = jsift(img, M=M, ht=120, wd=160, rng=np.random.default_rng(5))
    assert got.dtype == ref.dtype == np.float32 and got.shape == (M, 2)
    np.testing.assert_array_equal(got, ref)
    found = len(cv2.SIFT_create().detect(cv2.cvtColor(img, cv2.COLOR_RGB2GRAY), None))
    if kind == "padded":
        assert 0 < found < M
        # the pad's integer points come first, the keypoints after them
        assert (got[0] == np.round(got[0])).all() and (got[-1] != np.round(got[-1])).any()
    elif kind == "blank":
        assert found == 0 and (got == np.round(got)).all()
    else:
        assert found > M
    assert (got >= 16).all() and (got[:, 0] < 160 - 16).all() and (got[:, 1] < 120 - 16).all()


@pytest.fixture(scope="module")
def sift_runs(scene):
    """JAX and port BATrack over FRAMES frames with sift patches, the
    oracle tracker and a visualizer each."""
    poses, depths, images = scene
    jcfg = small_config()
    jcfg.slam.PATCH_GEN = "sift"
    cfg = _port_cfg(jcfg)
    jslam = JBATrack(jcfg, HT, WD, seed=3)
    jslam.tracker = JOracle(poses, INTR, JDims.from_config(jcfg, HT, WD))
    jslam.visualizer = JVisualizer()
    slam = BATrack(cfg, HT, WD, seed=3, device="cpu")
    slam.tracker = OracleTracker(poses, INTR, slam.dims, device="cpu")
    slam.visualizer = TrackVisualizer()
    for i in range(FRAMES):
        jslam(i, images[i], depths[i], INTR)
        slam(i, images[i], depths[i], INTR)
    return jslam, slam


def test_sift_run_matches_jax(sift_runs):
    jslam, slam = sift_runs
    M = slam.dims.M
    rows = slam.n * M
    got = slam.state.patches[:rows, :2].numpy()
    np.testing.assert_array_equal(got, np.asarray(jslam.state.patches)[:rows, :2])
    assert len(np.unique(got, axis=0)) > M  # the frames' patches differ
    poses, ts = slam.terminate()
    ref, ref_ts = jslam.terminate()
    np.testing.assert_array_equal(ts, ref_ts)
    assert_close(poses, ref, atol=1e-3)


def test_track_payloads_match_jax(sift_runs):
    jslam, slam = sift_runs
    vis, jvis = slam.visualizer, jslam.visualizer
    assert len(vis.frames) == len(jvis.frames) == FRAMES
    for a, b in zip(vis.frames, jvis.frames):
        np.testing.assert_array_equal(a, b)
    assert len(vis.tracks) == len(jvis.tracks) == FRAMES // 2
    S, Q = slam.dims.S_slam, slam.dims.n_src * slam.dims.M
    for got, ref in zip(vis.tracks, jvis.tracks):
        assert got["fid"] == ref["fid"] and set(got) == set(ref)
        for k in ("targets", "weights", "static"):
            assert got[k].shape == np.asarray(ref[k]).shape == (S, Q) + ((2,) if k == "targets"
                                                                          else ())
            assert_close(got[k], ref[k], atol=1e-3)
    assert any((np.asarray(r["weights"]) > 0).any() for r in jvis.tracks)


@pytest.mark.parametrize("static", [True, False])
def test_drawn_frames_match_jax(sift_runs, static, tmp_path):
    """The port's visualizer on JAX's frames and payloads draws what JAX's
    draws; the mp4 holds one frame per frame added."""
    jslam, _ = sift_runs
    jvis = jslam.visualizer
    tracks = [{k: v for k, v in t.items() if static or k != "static"} for t in jvis.tracks]
    vis, ref_vis = TrackVisualizer(save_dir=str(tmp_path)), JVisualizer(save_dir=str(tmp_path))
    for v in (vis, ref_vis):
        v.frames = [np.array(f) for f in jvis.frames]  # the JAX one draws on its frames
        v.tracks = tracks
    got, ref = vis.draw_tracks_on_frames(), ref_vis.draw_tracks_on_frames()
    drawn = [not np.array_equal(f, np.asarray(f0)) for f, f0 in zip(got, jvis.frames)]
    assert sum(drawn) >= len(got) // 2
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(vis.frames[0], jvis.frames[0])  # the port draws on copies
    path = vis.save_video("sift")
    assert path == str(tmp_path / "sift.mp4")
    cap = cv2.VideoCapture(path)
    count = 0
    while cap.read()[0]:
        count += 1
    cap.release()
    assert count == video_frame_count(path) == FRAMES


def test_video_writer_and_missing_cv2_raise(tmp_path, monkeypatch):
    vis = TrackVisualizer(save_dir=str(tmp_path))
    assert vis.save_video() is None  # no frame: nothing written, as in JAX
    vis.add_frame(np.zeros((16, 16, 3), np.uint8))

    class Closed:
        def __init__(self, *a):
            pass

        def isOpened(self):
            return False

    monkeypatch.setattr(cv2, "VideoWriter", Closed)
    with pytest.raises(RuntimeError, match="cannot open an mp4v writer"):
        vis.save_video()
    monkeypatch.undo()
    real_import = builtins.__import__

    def no_cv2(name, *args, **kw):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(RuntimeError, match="track video needs OpenCV"):
        vis.save_video()
    with pytest.raises(RuntimeError, match="PATCH_GEN='sift' needs OpenCV"):
        generate_patches_sift(_frame(2), M=8, ht=120, wd=160, rng=np.random.default_rng(0))
