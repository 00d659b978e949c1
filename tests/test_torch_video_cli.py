"""run_slam with save_video=true and PATCH_GEN="sift" in both CLIs, on a
DAVIS-layout JPEG dataset of tests/test_cli_e2e.py's scene (6 frames,
quality 95, per-frame K, its SMALL_OVERRIDES), from one md_tracker.pth
(tests/test_torch_cli.py's JAX random-init checkpoint): both write the same
files, <PATCH_GEN>.mp4 among them, each mp4 holds one frame per frame of
the stream (read back through cv2.VideoCapture), and the TUM poses agree
within 1e-3. The sift patches need no injected draws: both packages draw
from numpy Generators of the same seed.
"""

import os

import cv2
import numpy as np
import pytest

from batrack_tpu.cli import run_slam as jslam_cli
from batrack_tpu.utils.traj import read_tum_file
from batrack_tpu_torch.cli import run_slam
from test_cli_e2e import INTR, SMALL_OVERRIDES, _scene
from test_torch_cli import _jax_random_checkpoint

FRAMES = 6
NAME = "jpeg"


def _frames(path):
    cap = cv2.VideoCapture(str(path))
    count = 0
    while cap.read()[0]:
        count += 1
    cap.release()
    return count


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("video")
    _, depths, images = _scene()
    dirs = {k: root / k for k in ("rgb", "depth", "calib")}
    for d in dirs.values():
        d.mkdir()
    K = np.array([[INTR[0], 0, INTR[2]], [0, INTR[1], INTR[3]], [0, 0, 1]])
    for t in range(FRAMES):
        cv2.imwrite(str(dirs["rgb"] / f"{t:05d}.jpg"), cv2.cvtColor(images[t], cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
        np.save(dirs["depth"] / f"{t:05d}.npy", depths[t])
        np.save(dirs["calib"] / f"{t:05d}.npy", K)
    ckpt = root / "md_tracker.pth"
    _jax_random_checkpoint(str(ckpt), SMALL_OVERRIDES)
    common = [f"data.imagedir={dirs['rgb']}", f"data.depthdir={dirs['depth']}",
              f"data.calib={dirs['calib']}", "data.traj_format=davis", f"data.name={NAME}",
              "save_results=false", "save_trajectory=true", "save_plot=false"] + \
        SMALL_OVERRIDES + [f"model.init_dir={ckpt}", "slam.PATCH_GEN=sift", "save_video=true"]
    out = {"jax": root / "jax", "port": root / "port"}
    assert jslam_cli.main([f"data.savedir={out['jax']}"] + common) == 0
    assert run_slam.main(["--device", "cpu", f"data.savedir={out['port']}"] + common) == 0
    return out


def test_run_slam_save_video_matches_jax(runs):
    jdir, pdir = runs["jax"] / NAME, runs["port"] / NAME
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    assert "sift.mp4" in os.listdir(pdir)
    assert _frames(pdir / "sift.mp4") == _frames(jdir / "sift.mp4") == FRAMES
    pred, ts = read_tum_file(str(pdir / "batrack_traj.txt"))
    ref, ref_ts = read_tum_file(str(jdir / "batrack_traj.txt"))
    assert pred.shape == (FRAMES, 7)
    np.testing.assert_array_equal(ts, ref_ts)
    np.testing.assert_allclose(pred, ref, atol=1e-3)
