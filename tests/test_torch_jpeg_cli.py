"""The port's stage-1 CLIs and align_depth on JPEG frames against the JAX
package's CLIs, on the same saved checkpoints (tests/test_torch_depth_cli.py
makes them) and the same frames: 3 JPEGs of 130x170 (odd sizes, quality
90, 4:2:0). Limits as in that file: the disparity and metric depth 1e-4
relative, K 1e-4 relative, the aligned depths and K bitwise.

UniDepthV2 runs at a 100-patch network input on both sides
(pixels_bounds, patched into each package's `infer`), as the port's demo
chain test does: the CLI's smallest level, 1400 patches, takes over a
minute on the CPU.
"""

import os

import cv2
import numpy as np
import pytest

import batrack_tpu.depth.unidepth as junidepth
from batrack_tpu.cli import align_depth as jalign_cli
from batrack_tpu.cli import infer_depth as jinfer_cli
from batrack_tpu.cli import infer_metric_depth as jmetric_cli
from batrack_tpu_torch.cli import align_depth, infer_depth, infer_metric_depth
from batrack_tpu_torch.depth import unidepth
from test_torch_depth_cli import RTOL, da2_checkpoint, rel_err, unidepth_checkpoint

HW = (130, 170)
SCENE = "clip"


def write_jpegs(img_dir, n, seed):
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:HW[0], 0:HW[1]]
    for i in range(n):
        img = np.stack([(3 * xx + yy + 40 * i) % 256, (5 * yy) % 256, (xx * yy) % 256], -1)
        img = (img // 2 + rng.integers(0, 64, img.shape)).astype(np.uint8)
        cv2.imwrite(os.path.join(img_dir, f"{i:05d}.jpg"), img, [cv2.IMWRITE_JPEG_QUALITY, 90])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("jpeg_stage1")
    write_jpegs(str(root / "data" / SCENE), 3, seed=0)
    da2_checkpoint(root / "da2_vits.pth")
    unidepth_checkpoint(root / "ud_vits.safetensors")
    return root


def test_infer_depth_cli_on_jpeg_matches_jax(files, tmp_path):
    """130x170 frames resize to 126x168 for the network: the JAX CLI runs
    cv2's bicubic with Intel IPP off, the OpenCV path the port's numpy
    replica follows (with IPP on, cv2 moves some values by one level: the
    recorded deviation of depth/cvresize.py, ROADMAP C)."""
    args = ["--img_dir", str(files / "data" / SCENE), "--checkpoint",
            str(files / "da2_vits.pth"), "--encoder", "vits", "--input_size", "126"]
    ipp = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        assert jinfer_cli.main(args + ["--out_dir", str(tmp_path / "jax")]) == 0
    finally:
        cv2.ipp.setUseIPP(ipp)
    assert infer_depth.main(args + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [f"{i:05d}.npy" for i in range(3)]
    for n in names:
        ref, got = np.load(tmp_path / "jax" / n), np.load(tmp_path / "port" / n)
        assert got.shape == ref.shape == HW and got.dtype == np.float32
        assert (got > 0).all() and rel_err(got, ref) < RTOL


def test_infer_metric_depth_cli_on_jpeg_matches_jax(files, tmp_path, monkeypatch):
    for mod in (unidepth, junidepth):
        real = mod.infer
        monkeypatch.setattr(mod, "infer", lambda *a, _real=real, **kw: _real(
            *a, **dict(kw, pixels_bounds=(100, 100))))
    args = ["--img_dir", str(files / "data" / SCENE), "--checkpoint",
            str(files / "ud_vits.safetensors"), "--arch", "vits", "--resolution_level", "0"]
    assert jmetric_cli.main(args + ["--out_dir", str(tmp_path / "jax")]) == 0
    assert infer_metric_depth.main(args + ["--out_dir", str(tmp_path / "port"),
                                           "--device", "cpu"]) == 0
    for i in range(3):
        ref, got = (np.load(tmp_path / d / f"{i:05d}.npz") for d in ("jax", "port"))
        assert got["depth"].shape == HW and (got["depth"] > 0).all()
        assert rel_err(got["depth"], ref["depth"]) < RTOL
        assert rel_err(got["intrinsics"], ref["intrinsics"]) < RTOL
        assert abs(float(got["fov"]) - float(ref["fov"])) < 1e-3


def test_align_depth_cli_on_jpeg_matches_jax(tmp_path):
    """The image size comes from the first JPEG's header in the port and
    from cv2.imread in the JAX package; aligned depths and K are equal."""
    rng = np.random.default_rng(1)
    depth_dir, data_dir = tmp_path / "depth", tmp_path / "data"
    write_jpegs(str(data_dir / SCENE), 1, seed=2)
    mono, metric = depth_dir / "depthAny_disp" / SCENE, depth_dir / "unidepthv2" / SCENE
    for d in (mono, metric):
        d.mkdir(parents=True)
    for i in range(3):
        depth = rng.uniform(1.0, 6.0, HW).astype(np.float32)
        np.save(mono / f"{i:05d}.npy", (1.0 / depth[::2, ::2]) * 1.7 + 0.05)  # half size
        K = np.array([[150.0 + i, 0, 84], [0, 150.0, 63], [0, 0, 1]], np.float32)
        np.savez(metric / f"{i:05d}.npz", depth=depth, intrinsics=K, fov=np.float32(58.0))
    common = ["--depth_dir", str(depth_dir), "--data_dir", str(data_dir)]
    assert jalign_cli.main(common + ["--save_name", "jax"]) == 0
    assert align_depth.main(common + ["--save_name", "port"]) == 0
    for sub in ("", "_intrinsics"):
        ref_dir, got_dir = depth_dir / f"jax{sub}" / SCENE, depth_dir / f"port{sub}" / SCENE
        names = sorted(os.listdir(ref_dir))
        assert names == sorted(os.listdir(got_dir)) and len(names) == 3
        for n in names:
            got = np.load(got_dir / n)
            if not sub:
                assert got.shape == HW
            np.testing.assert_array_equal(got, np.load(ref_dir / n))
