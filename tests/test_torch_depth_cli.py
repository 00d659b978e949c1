"""The port's stage-1 CLIs and its viewer CLI against the JAX package's, on
the same saved checkpoints (the port's seeded vits networks in the released
formats) and PNG frames, then the whole demo chain through the port's CLIs
in the order of tests/test_cli_e2e.py::test_demo_full_chain_sh.

Limits: the disparity and metric depth 1e-4 relative (the networks' limit
in test_torch_depth.py), K 1e-4 relative, the aligned depths and K bitwise.
"""

import importlib.util
import os
import pickle

import cv2
import numpy as np
import pytest
import torch
from test_cli_e2e import SMALL_OVERRIDES
from torch_parity import perturb_

from batrack_tpu.cli import align_depth as jalign_cli
from batrack_tpu.cli import infer_depth as jinfer_cli
from batrack_tpu.cli import infer_metric_depth as jmetric_cli
from batrack_tpu.cli import vis_results as jvis_cli
from batrack_tpu_torch.cli import (align_depth, infer_depth, infer_metric_depth, run_refine,
                                   run_slam, vis_results)
from batrack_tpu_torch.data.png import write_png
from batrack_tpu_torch.depth import dpt, unidepth
from batrack_tpu_torch.utils.tensorfile import write_safetensors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (126, 168)
SCENE = "clip"
RTOL = 1e-4


def rel_err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b).max() / max(np.abs(b).max(), 1e-30))


def da2_checkpoint(path):
    """A seeded vits DepthAnythingV2 in the released .pth layout (final bias
    positive: random weights otherwise leave every disparity at the ReLU's
    zero)."""
    torch.manual_seed(0)
    model = perturb_(dpt.DepthAnythingV2("vits"), seed=1)
    with torch.no_grad():
        model.depth_head.scratch.output_conv2[2].bias.fill_(1.0)
    torch.save(model.state_dict(), path)


def unidepth_checkpoint(path):
    """A seeded vits UniDepthV2 as model.safetensors."""
    torch.manual_seed(0)
    write_safetensors(path, perturb_(unidepth.UniDepthV2("vits"), seed=1).state_dict())


def write_frames(img_dir, n, seed):
    """n random RGB PNG frames of HW, written by the port's encoder."""
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        write_png(os.path.join(img_dir, f"{i:05d}.png"),
                  rng.integers(0, 256, HW + (3,), dtype=np.uint8))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("stage1")
    write_frames(str(root / "data" / SCENE), 2, seed=0)
    da2_checkpoint(root / "da2_vits.pth")
    unidepth_checkpoint(root / "ud_vits.safetensors")
    return root


def test_infer_depth_cli_matches_jax(files, tmp_path):
    img_dir = str(files / "data" / SCENE)
    args = ["--img_dir", img_dir, "--checkpoint", str(files / "da2_vits.pth"),
            "--encoder", "vits", "--input_size", "126"]
    assert jinfer_cli.main(args + ["--out_dir", str(tmp_path / "jax")]) == 0
    assert infer_depth.main(args + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == ["00000.npy", "00001.npy"]
    for n in names:
        ref, got = np.load(tmp_path / "jax" / n), np.load(tmp_path / "port" / n)
        assert got.shape == ref.shape == HW and got.dtype == np.float32
        assert (got > 0).all() and rel_err(got, ref) < RTOL


@pytest.mark.slow
def test_infer_metric_depth_cli_matches_jax(files, tmp_path):
    """At --resolution_level 0 a 126x168 frame is 1376 tokens (the 1400-patch
    bound), well over a minute through both packages on the CPU: slow. The
    network and `infer` parity at a 100-patch bound stay in tier 1
    (test_torch_unidepth_net.py)."""
    img_dir = str(files / "data" / SCENE)
    K = np.array([[150.0, 0, 84], [0, 150.0, 63], [0, 0, 1]], np.float32)
    np.save(tmp_path / "K.npy", K)
    args = ["--img_dir", img_dir, "--checkpoint", str(files / "ud_vits.safetensors"),
            "--arch", "vits", "--resolution_level", "0"]
    for extra, tag in (([], "own"), (["--intrinsics", str(tmp_path / "K.npy")], "given")):
        assert jmetric_cli.main(args + extra + ["--out_dir", str(tmp_path / f"jax_{tag}")]) == 0
        assert infer_metric_depth.main(args + extra + ["--out_dir", str(tmp_path / f"port_{tag}"),
                                                       "--device", "cpu"]) == 0
        for n in ("00000.npz", "00001.npz"):
            ref, got = np.load(tmp_path / f"jax_{tag}" / n), np.load(tmp_path / f"port_{tag}" / n)
            assert set(got.files) == set(ref.files) == {"depth", "fov", "intrinsics"}
            assert got["depth"].shape == HW and (got["depth"] > 0).all()
            assert rel_err(got["depth"], ref["depth"]) < RTOL
            assert rel_err(got["intrinsics"], ref["intrinsics"]) < RTOL
            assert abs(float(got["fov"]) - float(ref["fov"])) < 1e-3
            if tag == "given":
                np.testing.assert_array_equal(got["intrinsics"], K)


def test_align_depth_cli_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    depth_dir, data_dir = tmp_path / "depth", tmp_path / "data"
    for scene in ("a", "b"):
        mono = depth_dir / "depthAny_disp" / scene
        metric = depth_dir / "unidepthv2" / scene
        for d in (mono, metric, data_dir / scene):
            d.mkdir(parents=True)
        write_frames(str(data_dir / scene), 1, seed=2)
        for i in range(3):
            depth = rng.uniform(1.0, 6.0, HW).astype(np.float32)
            np.save(mono / f"{i:04d}.npy", (1.0 / depth) * 1.7 + 0.05)
            K = np.array([[150.0 + i, 0, 84], [0, 150.0, 63], [0, 0, 1]], np.float32)
            np.savez(metric / f"{i:04d}.npz", depth=depth, intrinsics=K, fov=np.float32(58.0))
    common = ["--depth_dir", str(depth_dir), "--data_dir", str(data_dir)]
    assert jalign_cli.main(common + ["--save_name", "jax"]) == 0
    assert align_depth.main(common + ["--save_name", "port"]) == 0
    for scene in ("a", "b"):
        for sub in ("", "_intrinsics"):
            ref_dir, got_dir = depth_dir / f"jax{sub}" / scene, depth_dir / f"port{sub}" / scene
            names = sorted(os.listdir(ref_dir))
            assert names == sorted(os.listdir(got_dir)) and len(names) == 3
            for n in names:
                np.testing.assert_array_equal(np.load(got_dir / n), np.load(ref_dir / n))


def test_vis_results_cli_matches_jax(tmp_path, capsys):
    """rerun-sdk is absent here: both CLIs print the same summary and return
    1 with the same message."""
    rng = np.random.default_rng(3)
    res = {"rgbs": rng.uniform(0, 255, (3,) + HW + (3,)), "dmaps": rng.uniform(1, 2, (3,) + HW),
           "cams_T_world": np.tile(np.eye(4), (3, 1, 1)),
           "intrinsics": np.tile([150.0, 150.0, 84.0, 63.0], (3, 1))}
    path = tmp_path / "results_refined.pkl"
    with open(path, "wb") as f:
        pickle.dump(res, f)
    if importlib.util.find_spec("rerun") is not None:
        pytest.skip("rerun-sdk is installed: the CLIs would open a viewer")
    assert jvis_cli.main(["--result_path", str(path)]) == 1
    ref = capsys.readouterr().out
    assert vis_results.main(["--result_path", str(path)]) == 1
    got = capsys.readouterr().out
    assert got == ref and "cams_T_world: (3, 4, 4)" in got and "rerun-sdk not installed" in got


def test_demo_chain_through_the_port(tmp_path, capsys, monkeypatch):
    """run_mono_depth.sh's three stage-1 CLIs, then run_sparse.sh's run_slam
    (davis_demo + SMALL_OVERRIDES), run_dense.sh's run_refine and
    run_vis.sh's vis_results, all of the port, on 6 frames of 126x168 from
    saved vits checkpoints, with the stage-to-stage file protocol."""
    data_dir, depth_dir, savedir = tmp_path / "davis", tmp_path / "Monodepth", tmp_path / "out"
    write_frames(str(data_dir / SCENE), 6, seed=11)
    da2_checkpoint(tmp_path / "da2_vits.pth")
    unidepth_checkpoint(tmp_path / "ud_vits.safetensors")
    img_dir = str(data_dir / SCENE)
    assert infer_depth.main(["--encoder", "vits", "--checkpoint", str(tmp_path / "da2_vits.pth"),
                             "--img_dir", img_dir, "--out_dir",
                             str(depth_dir / "depthAny_disp" / SCENE), "--input_size", "126",
                             "--device", "cpu"]) == 0
    # a 100-patch network input keeps UniDepth quick here (the CLI's
    # smallest level is 1400 patches); infer itself is the CLI's call
    real_infer = unidepth.infer
    monkeypatch.setattr(unidepth, "infer", lambda *a, **kw: real_infer(
        *a, **dict(kw, pixels_bounds=(100, 100))))
    assert infer_metric_depth.main(["--arch", "vits", "--checkpoint",
                                    str(tmp_path / "ud_vits.safetensors"), "--img_dir", img_dir,
                                    "--out_dir", str(depth_dir / "unidepthv2" / SCENE),
                                    "--resolution_level", "0", "--device", "cpu"]) == 0
    monkeypatch.undo()
    assert align_depth.main(["--data_dir", str(data_dir), "--depth_dir", str(depth_dir),
                             "--save_name", "unidepth_da"]) == 0
    aligned = sorted(os.listdir(depth_dir / "unidepth_da" / SCENE))
    Ks = sorted(os.listdir(depth_dir / "unidepth_da_intrinsics" / SCENE))
    assert len(aligned) == len(Ks) == 6
    assert np.load(depth_dir / "unidepth_da_intrinsics" / SCENE / Ks[0]).shape == (3, 3)
    assert all(np.isfinite(np.load(depth_dir / "unidepth_da" / SCENE / n)).all() for n in aligned)

    assert run_slam.main(["--config", os.path.join(REPO, "configs", "davis_demo.yaml"),
                          "--device", "cpu", f"data.imagedir={img_dir}",
                          f"data.savedir={savedir}",
                          f"data.depthdir={depth_dir / 'unidepth_da' / SCENE}",
                          f"data.depthdir_gt={depth_dir / 'unidepth_da' / SCENE}",
                          f"data.calib={depth_dir / 'unidepth_da_intrinsics' / SCENE}",
                          f"data.name={SCENE}", "save_trajectory=true", "save_plot=false",
                          "save_results=true"] + SMALL_OVERRIDES + ["save_video=false"]) == 0
    assert (savedir / SCENE / "results.pkl").exists()
    assert run_refine.main(["--result_dir", str(savedir), "--grid_size", "8", "--scenes", SCENE,
                            "--niter", "5", "--device", "cpu"]) == 0
    refined = savedir / SCENE / "results_refined.pkl"
    with open(refined, "rb") as f:
        res = pickle.load(f)
    # the stream crops frames to multiples of 16 (112x160 here)
    assert res["dmaps_scaled"].shape == res["dmaps"].shape[:3] + (1,)
    assert res["dmaps_scaled"].shape[0] == 6 and np.isfinite(res["dmaps_scaled"]).all()
    capsys.readouterr()
    assert vis_results.main(["--result_path", str(refined)]) in (0, 1)
    out = capsys.readouterr().out
    assert "rerun" in out.lower() and "cams_T_world: (6, 4, 4)" in out


def test_cli_frames_must_be_png(files, tmp_path):
    """Frames are PNG or JPEG (data/image.py, as the streams read them): a
    JPEG frame goes through the CLI, and one that cv2 cannot read raises
    (test_torch_jpeg_cli.py holds the JPEG CLIs against the JAX CLIs)."""
    img_dir = tmp_path / "frames"
    img_dir.mkdir()
    cv2.imwrite(str(img_dir / "00000.jpg"), np.zeros(HW + (3,), np.uint8))
    args = ["--img_dir", str(img_dir), "--out_dir", str(tmp_path / "o"),
            "--checkpoint", str(files / "da2_vits.pth"), "--encoder", "vits",
            "--input_size", "126", "--device", "cpu"]
    assert infer_depth.main(args) == 0
    assert np.load(tmp_path / "o" / "00000.npy").shape == HW
    (img_dir / "00001.jpg").write_bytes(b"\xff\xd8 not a jpeg")
    with pytest.raises(ValueError, match="cv2 cannot read"):
        infer_depth.main(args)
