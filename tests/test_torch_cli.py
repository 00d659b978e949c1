"""The port's three CLIs against the JAX package's on the same files:
`batrack_tpu_torch.cli.run_slam` against `batrack_tpu.cli.run_slam` on the
synthetic Sintel dataset of tests/test_cli_e2e.py (its writers, 6 frames,
its SMALL_OVERRIDES), then `cli.run_refine` and `cli.eval_depth` of both
packages on the JAX run's results.pkl.

Both run_slam CLIs load one md_tracker.pth (JAX random-init params through
state_dict_from_flax, saved under a {'model': ...} wrapper with a
`module.` prefix; flow heads damped, as in test_torch_slice) and the
port's BATrack takes JAX's random draws
(torch_parity.JaxDraws, patched in here). Limits: TUM poses 1e-3 (as
test_torch_slice), error_sum.txt and the depth tables at their printed
rounding, the frame stacks of results.pkl exact.
"""

import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import batrack_tpu_torch.slam as port_slam
from batrack_tpu.cli import eval_depth as jeval_cli
from batrack_tpu.cli import run_refine as jrefine_cli
from batrack_tpu.cli import run_slam as jslam_cli
from batrack_tpu.slam.frontend import TrackerInput
from batrack_tpu.tracker.adapter import MDTrackerAdapter as JAdapter
from batrack_tpu.utils.config import load_config as jload_config
from batrack_tpu.utils.traj import read_tum_file
from batrack_tpu_torch.cli import eval_depth, run_refine, run_slam
from batrack_tpu_torch.slam.ingest import draw_shapes
from batrack_tpu_torch.tracker import state_dict_from_flax
from batrack_tpu_torch.utils.evaluation import eval_metrics
from batrack_tpu_torch.utils.traj import load_traj
from test_cli_e2e import SMALL_OVERRIDES, _write_sintel
from test_slam_e2e import HT, WD
from torch_parity import JaxDraws

FRAMES = 6
NAME = "synth"


def _jax_random_checkpoint(path, overrides):
    """md_tracker.pth from JAX random-init params, in the released layout."""
    cfg = jload_config(None, overrides)
    ad = JAdapter(cfg.model, seed=0)
    S = cfg.model.S
    ad.init_params(TrackerInput(
        window_rgbd=jnp.ones((S, 4, HT, WD), jnp.float32),
        queries=jnp.tile(jnp.asarray([[0.0, 10.0, 10.0, 3.0]]), (8, 1)),
        query_valid=jnp.ones((8,), bool), win_start=jnp.asarray(0),
        win_tstamps=jnp.arange(S)))
    sd = state_dict_from_flax(jax.tree.map(np.asarray, ad.params))
    # flow heads damped as torch_parity.damp_flow_heads does: random heads
    # amplify float32 rounding into the tracks
    for k in [k for k in sd if ".flow_head." in k]:
        sd[k] = sd[k] * 0.05
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    imdir, ddir, gdir, cdir, _ = _write_sintel(root / "data")
    ckpt = root / "md_tracker.pth"
    _jax_random_checkpoint(str(ckpt), SMALL_OVERRIDES)
    common = [f"data.imagedir={imdir}", f"data.depthdir={ddir}", f"data.depthdir_gt={gdir}",
              f"data.calib={cdir}", f"data.gt_traj={cdir}", "data.traj_format=sintel",
              f"data.end={FRAMES}", f"data.name={NAME}", "save_results=true",
              "save_trajectory=true", "save_plot=false"] + SMALL_OVERRIDES + [
              f"model.init_dir={ckpt}"]
    out = {"jax": root / "jax", "port": root / "port", "cam": cdir}
    assert jslam_cli.main([f"data.savedir={out['jax']}"] + common) == 0

    shape = draw_shapes("grid_grad_4", 16)[1]

    class DrawnBATrack(port_slam.BATrack):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.draw_hook = JaxDraws(0, shape)

    mp = pytest.MonkeyPatch()
    mp.setattr(port_slam, "BATrack", DrawnBATrack)
    try:
        assert run_slam.main(["--device", "cpu", f"data.savedir={out['port']}"] + common) == 0
    finally:
        mp.undo()
    return out


def _pkl(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_run_slam_writes_what_the_jax_cli_writes(runs):
    jdir, pdir = runs["jax"] / NAME, runs["port"] / NAME
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    pred, ts = read_tum_file(str(pdir / "batrack_traj.txt"))
    ref, ref_ts = read_tum_file(str(jdir / "batrack_traj.txt"))
    assert pred.shape == (FRAMES, 7)
    np.testing.assert_array_equal(ts, ref_ts)
    np.testing.assert_allclose(pred, ref, atol=1e-3)

    res, jres = _pkl(pdir / "results.pkl"), _pkl(jdir / "results.pkl")
    assert set(res) == set(jres)
    for k, v in jres.items():
        if k in ("cams_T_world", "trajs_2d_disp"):
            np.testing.assert_allclose(res[k], v, atol=1e-3, err_msg=k)
        elif v is not None:
            np.testing.assert_array_equal(np.asarray(res[k]), np.asarray(v), err_msg=k)
    # the frames went through data/png.py and cv2: equal, and the
    # ground-truth depth channel is the .dpt directory's own
    assert res["rgbs"].shape == (FRAMES, HT, WD, 3)
    assert not np.allclose(res["dmaps"], res["dmaps_gt"])


def test_error_sum_matches_jax_and_the_written_trajectory(runs):
    lines = (runs["port"] / "error_sum.txt").read_text().splitlines()
    jlines = (runs["jax"] / "error_sum.txt").read_text().splitlines()
    assert len(lines) == len(jlines) == 4 and lines[0].startswith(NAME)
    # %.5f fields: within the trajectory limit's reach, and each one equal
    # to the metric recomputed from batrack_traj.txt at its rounding
    np.testing.assert_allclose([float(v) for v in lines[1:]], [float(v) for v in jlines[1:]],
                               atol=1e-3)
    pred = read_tum_file(str(runs["port"] / NAME / "batrack_traj.txt"))
    gt = load_traj(str(runs["cam"]), "sintel", end=FRAMES)
    again = eval_metrics(pred, gt_traj=gt)
    assert [f"{v:.5f}" for v in again] == lines[1:]
    metrics = (runs["port"] / NAME / "eval_metrics.txt").read_text().splitlines()
    assert metrics[2] == f"ATE rmse: {again[0]:.6f}"


@pytest.fixture(scope="module")
def refined(runs, tmp_path_factory):
    """Both stage-3 CLIs (CLI defaults: grid 10, 200 steps) on the JAX
    run's results.pkl, each in a result dir of its own."""
    dirs = {}
    for who, cli, extra in (("jax", jrefine_cli, []), ("port", run_refine, ["--device", "cpu"])):
        d = tmp_path_factory.mktemp(f"refine_{who}")
        (d / NAME).mkdir()
        shutil.copy(runs["jax"] / NAME / "results.pkl", d / NAME / "results.pkl")
        assert cli.main(["--result_dir", str(d)] + extra) == 0
        dirs[who] = d
    return dirs


def test_run_refine_matches_jax(refined):
    got = _pkl(refined["port"] / NAME / "results_refined.pkl")
    ref = _pkl(refined["jax"] / NAME / "results_refined.pkl")
    assert set(got) == set(ref)
    assert got["dmaps_scaled"].shape == (FRAMES, HT, WD, 1)
    for k in ("final_trajs_2d", "dmaps", "intrinsics"):
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    np.testing.assert_allclose(got["dmaps_scaled"], ref["dmaps_scaled"], rtol=1e-3)
    np.testing.assert_allclose(got["cams_T_world"], ref["cams_T_world"], atol=1e-4)


def _table(path):
    """The last table appended to eval_depth.txt."""
    lines = path.read_text().splitlines()
    start = max(i for i, ln in enumerate(lines) if "abs_rel" in ln)
    rows = [ln.split("|") for ln in lines[start:]]
    return [r[0].strip() for r in rows], np.array([[float(v) for v in r[1:]] for r in rows[1:]])


@pytest.mark.parametrize("refined_flag", [False, True])
def test_eval_depth_matches_jax(refined, refined_flag, capsys):
    flag = ["--refined"] if refined_flag else []
    for who, cli in (("jax", jeval_cli), ("port", eval_depth)):
        assert cli.main(["--result_dir", str(refined[who])] + flag) == 0
    out = capsys.readouterr().out
    assert "abs_rel" in out
    names, vals = _table(refined["port"] / "eval_depth.txt")
    jnames, jvals = _table(refined["jax"] / "eval_depth.txt")
    assert names == jnames == ["scene", NAME, "mean"]
    # %8.3f: one unit of the last printed digit at most
    np.testing.assert_allclose(vals, jvals, atol=1.0001e-3)


@pytest.mark.parametrize("distributed,mesh_devices,calls", [
    (False, 0, []),
    (False, 2, ["get_mesh 2"]),
    (True, 0, ["init_distributed"]),
    (True, 4, ["init_distributed", "get_host_chip_mesh"]),
])
def test_run_slam_makes_a_mesh_as_the_jax_cli(monkeypatch, distributed, mesh_devices, calls):
    """slam.distributed joins the process group; a mesh is made only when
    slam.mesh_devices is set (batrack_tpu/cli/run_slam.py:107-165)."""
    import batrack_tpu_torch.parallel as parallel
    from batrack_tpu_torch.utils.config import load_config

    seen = []
    monkeypatch.setattr(parallel, "init_distributed",
                        lambda device=None: seen.append("init_distributed"))
    monkeypatch.setattr(parallel, "get_host_chip_mesh",
                        lambda device=None: seen.append("get_host_chip_mesh") or "mesh")
    monkeypatch.setattr(parallel, "get_mesh",
                        lambda n, device=None: seen.append(f"get_mesh {n}") or "mesh")
    cfg = load_config(None, [f"slam.distributed={distributed}",
                             f"slam.mesh_devices={mesh_devices}"])
    mesh = run_slam._make_mesh(cfg, torch.device("cpu"))
    assert seen == calls
    assert mesh == ("mesh" if mesh_devices else None)
