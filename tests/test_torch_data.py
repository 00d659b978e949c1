"""The port's data, trajectory and evaluation modules and its checkpoint
loader against the JAX package's, on files written here from a seed:

* the streams (Sintel with the nearest-neighbour depth resize, TartanAir,
  DAVIS, generic, and the prefetching path-list stream) yield the same
  frames, bitwise: the port decodes PNG with data/png.py where the JAX
  package calls cv2 and the native library;
* that PNG reader against cv2 on every colour type and bit depth and on
  every row filter and mix of them (written by png.write_png), and the
  decode-ahead on worker processes that every stream reads through;
* `load_traj` for every format and the TUM writer, quaternions equal to
  scipy's (sign included) within 1e-12;
* `eval_metrics` and `eval_depth_maps` within 1e-9;
* `load_checkpoint` against `state_dict_from_flax` of the JAX loader,
  exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import batrack_tpu.data.streams as jstreams
import batrack_tpu.utils.evaluation as jeval
import batrack_tpu.utils.traj as jtraj
from batrack_tpu.geometry import se3 as jse3
from batrack_tpu.tracker.convert import load_checkpoint as jload_checkpoint
from batrack_tpu_torch.data import image, png, streams
from batrack_tpu_torch.geometry import se3
from batrack_tpu_torch.tracker import MDTracker, TrackerParams, load_checkpoint
from batrack_tpu_torch.tracker.convert import state_dict_from_flax
from batrack_tpu_torch.utils import evaluation, traj
from test_data_config import write_sintel_cam, write_sintel_dpt

cv2 = pytest.importorskip("cv2")

T = 5
H0, W0 = 53, 70   # written size; the streams crop to 48 x 64


def _imwrite(path, rgb):
    cv2.imwrite(str(path), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))


def _poses(rng, n):
    """(n, 4, 4) world-to-camera matrices with random rotations."""
    m = np.tile(np.eye(4), (n, 1, 1))
    m[:, :3, :3] = Rotation.random(n, random_state=int(rng.integers(1 << 30))).as_matrix()
    m[:, :3, 3] = rng.normal(0, 1, (n, 3))
    return m


@pytest.fixture
def dataset(tmp_path):
    rng = np.random.default_rng(3)
    d = {k: tmp_path / k for k in ("rgb", "depth", "depth_small", "gt", "cam", "calib", "K")}
    for p in d.values():
        p.mkdir()
    K = np.array([[60.0, 0, 32.5], [0, 61.0, 24.5], [0, 0, 1]])
    w2c = _poses(rng, T)
    for t in range(T):
        _imwrite(d["rgb"] / f"frame_{t:04d}.png",
                 rng.integers(0, 256, (H0, W0, 3)).astype(np.uint8))
        np.save(d["depth"] / f"frame_{t:04d}.npy", rng.uniform(1, 5, (H0, W0)))
        # a prior at another size: the Sintel stream resizes it (nearest)
        np.save(d["depth_small"] / f"frame_{t:04d}.npy", rng.uniform(1, 5, (37, 83)))
        write_sintel_dpt(d["gt"] / f"frame_{t:04d}.dpt", rng.uniform(1, 5, (H0, W0)))
        write_sintel_cam(d["cam"] / f"frame_{t:04d}.cam", K, w2c[t][:3])
        np.save(d["K"] / f"frame_{t:04d}.npy", K * (1 + 0.01 * t))
    np.savetxt(d["calib"] / "calib.txt", np.array([[60.0, 61.0, 32.5, 24.5]]), delimiter=" ")
    d["calib_file"] = d["calib"] / "calib.txt"
    return d


def _assert_same_stream(port, ref):
    port, ref = list(port), list(ref)
    assert len(port) == len(ref) > 1
    for a, b in zip(port, ref):
        assert str(a[0]) == str(b[0])
        for x, y in zip(a[1:], b[1:]):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("depth", ["depth", "depth_small"])
def test_sintel_stream_matches_jax(dataset, depth):
    d = dataset
    args = (d["rgb"], d[depth], d["gt"], d["cam"], 1, 1, -1)
    _assert_same_stream(streams.sintel_rgbd_stream(*args), jstreams.sintel_rgbd_stream(*args))


@pytest.mark.parametrize("kind", ["tartanair", "davis", "generic"])
def test_streams_match_jax(dataset, kind):
    d = dataset
    if kind == "tartanair":
        args = (d["rgb"], d["depth"], d["depth"], d["calib_file"], 2, 0, 4)
        port, ref = streams.tartanair_rgbd_stream(*args), jstreams.tartanair_rgbd_stream(*args)
    elif kind == "davis":
        args = (d["rgb"], d["depth"], d["K"], 1, 1, 4)
        port, ref = streams.davis_stream(*args), jstreams.davis_stream(*args)
    else:
        args = (d["rgb"], d["depth"], d["calib_file"])
        port, ref = streams.dataset_rgbd_stream(*args), jstreams.dataset_rgbd_stream(*args)
    _assert_same_stream(port, ref)


@pytest.mark.parametrize("depth", ["npy", "dpt"])
def test_native_stream_matches_jax_and_python_stream(dataset, depth):
    d = dataset
    imgs = sorted(d["rgb"].glob("*.png"))
    deps = sorted(d["depth" if depth == "npy" else "gt"].glob(f"*.{depth}"))
    intr = lambda t: np.array([60.0, 61.0, 32.5, 24.5]) + t  # noqa: E731
    _assert_same_stream(streams.native_rgbd_stream(imgs, deps, intr),
                        jstreams.native_rgbd_stream(imgs, deps, intr))
    if depth == "dpt":
        return
    # the prefetcher clips depth to [1e-2, 1e2] in float32; the Python
    # stream leaves that to the CLI
    for a, b in zip(streams.native_rgbd_stream(imgs, deps, intr),
                    streams.dataset_rgbd_stream(d["rgb"], d["depth"], d["calib_file"])):
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2].astype(np.float32).astype(float))


def test_native_stream_rejects_a_frame_of_another_size(dataset, tmp_path):
    d = dataset
    imgs = sorted(d["rgb"].glob("*.png"))
    deps = sorted(d["depth"].glob("*.npy"))
    _imwrite(tmp_path / "big.png", np.zeros((H0 + 16, W0, 3), np.uint8))
    np.save(tmp_path / "big.npy", np.ones((H0 + 16, W0)))
    stream = streams.native_rgbd_stream(imgs[:2] + [tmp_path / "big.png"],
                                        deps[:2] + [tmp_path / "big.npy"], lambda t: np.ones(4))
    with pytest.raises(ValueError, match="differs from frame 0"):
        list(stream)


def test_decode_ahead_keeps_order_raises_and_stops():
    """The streams' decode-ahead on worker processes: results in job order,
    a job's exception raised at the reader, and no worker left running,
    also when the reader stops early."""
    assert list(streams._ahead(pow, [(2, k) for k in range(20)])) == [2 ** k for k in range(20)]
    assert list(streams._ahead(pow, [])) == []
    with pytest.raises(ValueError, match="invalid literal"):
        list(streams._ahead(int, [("1",), ("2",), ("x",), ("4",)]))
    it = streams._ahead(pow, [(3, k) for k in range(100)])
    assert [next(it), next(it)] == [1, 3]
    procs = it.gi_frame.f_locals["procs"]
    it.close()
    assert len(procs) == streams.DECODE_WORKERS
    assert all(p.poll() is not None for p in procs)


def _png_cases(tmp_path):
    """PNGs of every colour type and bit depth, written by cv2 (adaptive
    row filters) and by PIL (palettes, 1-bit, grey + alpha)."""
    from PIL import Image

    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:37, 0:53]
    smooth = np.stack([(3 * xx + yy) % 256, (5 * yy) % 256, (xx * yy) % 256], -1)
    img = (smooth // 2 + rng.integers(0, 32, smooth.shape)).astype(np.uint8)
    out = {}
    for lvl in (0, 9):
        out[f"rgb_z{lvl}"] = tmp_path / f"rgb{lvl}.png"
        cv2.imwrite(str(out[f"rgb_z{lvl}"]), img, [cv2.IMWRITE_PNG_COMPRESSION, lvl])
    out["rgb16"] = tmp_path / "rgb16.png"
    cv2.imwrite(str(out["rgb16"]), img.astype(np.uint16) * 257 + 3)
    out["grey16"] = tmp_path / "grey16.png"
    cv2.imwrite(str(out["grey16"]), img[..., 0].astype(np.uint16) * 251)
    pil = {"grey": Image.fromarray(img[..., 0]),
           "grey_alpha": Image.fromarray(img[..., :2], "LA"),
           "rgba": Image.fromarray(np.dstack([img, img[..., :1]]), "RGBA"),
           "palette": Image.fromarray(img).convert("P", palette=Image.ADAPTIVE, colors=200),
           "palette4": Image.fromarray(img).convert("P", palette=Image.ADAPTIVE, colors=16),
           "bits1": Image.fromarray(img[..., 0] > 100)}
    for name, im in pil.items():
        out[name] = tmp_path / f"{name}.png"
        im.save(out[name], bits=4) if name == "palette4" else im.save(out[name], optimize=True)
    return out


def test_png_reader_matches_cv2(tmp_path):
    """data/png.py, the PNG half of the streams' frame reader, against
    cv2.imread + COLOR_BGR2RGB on every case, bitwise, directly and through
    data/image.py, with the header's size; a JPEG is no PNG to it."""
    for name, path in _png_cases(tmp_path).items():
        ref = cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)
        got = png.read_png_rgb(path)
        assert got.dtype == np.uint8, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
        np.testing.assert_array_equal(image.read_image(path), ref, err_msg=name)
        assert image.image_size(path) == ref.shape[:2], name
    cv2.imwrite(str(tmp_path / "a.jpg"), np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png_rgb(tmp_path / "a.jpg")


@pytest.mark.parametrize("filters", ["libpng", 0, 1, 2, 3, 4, "random", "runs"])
def test_png_row_filters_match_cv2(tmp_path, filters):
    """png.write_png with each row filter, libpng's per-row choice, a random
    filter per row and runs of Up rows around Average/Paeth spans: cv2 reads
    back the array written, and so does png.read_png_rgb."""
    rng = np.random.default_rng(4)
    h, w = 45, 61
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([(3 * xx + yy) % 256, (5 * yy) % 256, (xx * yy) % 256], -1)
    img = (smooth // 2 + rng.integers(0, 32, smooth.shape)).astype(np.uint8)
    rows = {"libpng": None, "random": rng.integers(0, 5, h),
            "runs": np.repeat([2, 1, 2, 4, 2, 3, 2, 0, 2], 5)}.get(filters, filters)
    path = tmp_path / "f.png"
    png.write_png(path, img, rows)
    np.testing.assert_array_equal(cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB), img)
    np.testing.assert_array_equal(png.read_png_rgb(path), img)


def test_resize_nearest_matches_cv2():
    rng = np.random.default_rng(2)
    for _ in range(50):
        H, W, h, w = (int(v) for v in rng.integers(1, 300, 4))
        src = rng.random((H, W, 1))
        ref = cv2.resize(src, (w, h), interpolation=cv2.INTER_NEAREST).reshape(h, w, 1)
        np.testing.assert_array_equal(streams.resize_nearest(src, (h, w)), ref)


def test_readers_and_tum_depth(dataset, tmp_path):
    d = dataset
    cam = sorted(d["cam"].iterdir())[1]
    for a, b in zip(streams.cam_read_sintel(str(cam)), jstreams.cam_read_sintel(str(cam))):
        np.testing.assert_array_equal(a, b)
    dpt = sorted(d["gt"].iterdir())[2]
    np.testing.assert_array_equal(streams.sintel_depth_read(str(dpt)),
                                  jstreams.sintel_depth_read(str(dpt)))
    np.savez(tmp_path / "d.npz", depth=np.ones((4, 5)))
    np.testing.assert_array_equal(streams.load_depth_file(tmp_path / "d.npz"),
                                  jstreams.load_depth_file(tmp_path / "d.npz"))
    cv2.imwrite(str(tmp_path / "d.png"),
                np.random.default_rng(5).integers(0, 65536, (4, 5)).astype(np.uint16))
    got = streams.load_depth_file(tmp_path / "d.png", mode="tum")
    assert got.dtype == np.float64 and got.shape == (4, 5, 1)
    np.testing.assert_array_equal(got, jstreams.load_depth_file(tmp_path / "d.png", mode="tum"))


# ---------------------------------------------------------------- trajectories
def test_se3_additions_match_scipy_and_jax():
    """from_matrix (quaternions as scipy's, sign included), act, identity."""
    rng = np.random.default_rng(4)
    m = _poses(rng, 400)
    m[:4, :3, :3] = [np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
                     np.diag([-1.0, -1, 1])]
    q = se3.from_matrix(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(q[:, 3:], Rotation.from_matrix(m[:, :3, :3]).as_quat(),
                               atol=1e-12, rtol=0)
    with jax.enable_x64(True):
        ref = np.asarray(jse3.from_matrix(jnp.asarray(m)))
    np.testing.assert_allclose(q, ref, atol=1e-12, rtol=0)
    np.testing.assert_allclose(se3.matrix(torch.from_numpy(q)).numpy(), m, atol=1e-12)
    pts = rng.normal(0, 1, (400, 3))
    with jax.enable_x64(True):
        ref_pts = np.asarray(jse3.act(jnp.asarray(ref), jnp.asarray(pts)))
        ref_id = np.asarray(jse3.identity((2, 3), jnp.float64))
    np.testing.assert_allclose(se3.act(torch.from_numpy(q), torch.from_numpy(pts)).numpy(),
                               ref_pts, atol=1e-12, rtol=0)
    np.testing.assert_array_equal(se3.identity((2, 3), torch.float64).numpy(), ref_id)


def _write_formats(tmp_path, rng, n=9):
    c2w = np.linalg.inv(_poses(rng, n))
    q = Rotation.from_matrix(c2w[:, :3, :3]).as_quat()
    rows = np.column_stack([np.arange(n) * 0.1, c2w[:, :3, 3], q])
    np.savetxt(tmp_path / "tum.txt", rows)
    np.savetxt(tmp_path / "kitti.txt", c2w[:, :3, :4].reshape(n, 12))
    np.savetxt(tmp_path / "replica.txt", c2w.reshape(n, 16))
    return {"tum": tmp_path / "tum.txt", "tartanair": tmp_path / "tum.txt",
            "kitti": tmp_path / "kitti.txt", "replica": tmp_path / "replica.txt"}


@pytest.mark.parametrize("fmt", ["sintel", "tartanair", "tum", "kitti", "replica"])
def test_load_traj_matches_jax(dataset, tmp_path, fmt):
    files = _write_formats(tmp_path, np.random.default_rng(5))
    path = str(dataset["cam"] if fmt == "sintel" else files[fmt])
    for kw in ({}, {"skip": 1, "end": 4, "stride": 2}):
        got, ts = traj.load_traj(path, fmt, **kw)
        ref, ref_ts = jtraj.load_traj(path, fmt, **kw)
        np.testing.assert_allclose(got, ref, atol=1e-12, rtol=0)
        np.testing.assert_array_equal(ts, ref_ts)


def test_tum_writer_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    poses = np.column_stack([rng.normal(0, 1, (7, 3)), Rotation.random(7, random_state=3)
                             .as_quat()[:, [3, 0, 1, 2]]])
    tstamps = np.arange(7, dtype=float)
    traj.save_trajectory_tum_format((poses, tstamps), str(tmp_path / "a.txt"))
    jtraj.save_trajectory_tum_format((poses, tstamps), str(tmp_path / "b.txt"))
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
    back, ts = traj.read_tum_file(str(tmp_path / "a.txt"))
    np.testing.assert_array_equal(back, poses)
    np.testing.assert_array_equal(ts, tstamps)


# ---------------------------------------------------------------- evaluation
@pytest.mark.parametrize("n_gt", [12, 20])
def test_eval_metrics_match_jax(tmp_path, n_gt):
    """Equal lengths associate by index, unequal by nearest timestamp."""
    rng = np.random.default_rng(n_gt)
    c2w = np.linalg.inv(_poses(rng, n_gt))
    gt = np.column_stack([c2w[:, :3, 3],
                          Rotation.from_matrix(c2w[:, :3, :3]).as_quat()[:, [3, 0, 1, 2]]])
    gt_t = np.arange(n_gt) * (12.0 / n_gt)
    pred = gt[np.round(np.arange(12) * n_gt / 12).astype(int)].copy()
    pred[:, :3] = 1.7 * pred[:, :3] + rng.normal(0, 0.05, (12, 3))
    pred[:, 3:] += rng.normal(0, 0.02, (12, 4))
    pred[:, 3:] /= np.linalg.norm(pred[:, 3:], axis=1, keepdims=True)
    pred_t = np.arange(12, dtype=float)
    got = evaluation.eval_metrics((pred, pred_t), (gt, gt_t), "s", str(tmp_path / "a.txt"))
    ref = jeval.eval_metrics((pred, pred_t), (gt, gt_t), "s", str(tmp_path / "b.txt"))
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
    np.testing.assert_allclose(evaluation.tum_to_matrices(pred), jeval.tum_to_matrices(pred),
                               atol=1e-12, rtol=0)


@pytest.mark.parametrize("scaling", ["median", "lstsq", "none"])
def test_eval_depth_maps_match_jax(scaling):
    rng = np.random.default_rng(8)
    gt = rng.uniform(0.5, 20, (4, 16, 24))
    gt[0, :3] = 0.0      # masked out
    gt[1, :2] = 150.0
    pred = gt * rng.uniform(0.7, 1.4, gt.shape) * 2.0
    np.testing.assert_allclose(evaluation.eval_depth_maps(gt, pred, scaling=scaling),
                               jeval.eval_depth_maps(gt, pred, scaling=scaling),
                               rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------- checkpoint
def test_load_checkpoint_matches_jax_loader(tmp_path):
    depths = dict(space_depth=1, time_depth=1, space_depth_dyn=1, time_depth_dyn=1)
    torch.manual_seed(0)
    sd = MDTracker(TrackerParams(S=4, iters=1, static_iters=1, interp_shape=(32, 48),
                                 **depths)).state_dict()
    path = tmp_path / "md_tracker.pth"
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, path)
    got = load_checkpoint(str(path))
    ref = state_dict_from_flax(jload_checkpoint(str(path), **depths))
    assert set(got) == set(ref) == set(sd)
    for k in ref:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], ref[k]), k
    # strict load into the port's tracker
    model = MDTracker(TrackerParams(S=4, iters=1, static_iters=1, interp_shape=(32, 48),
                                    **depths))
    model.load_state_dict(got, strict=True)
    # a bare state dict loads the same
    torch.save(sd, tmp_path / "bare.pth")
    assert all(torch.equal(a, b) for a, b in
               zip(load_checkpoint(str(tmp_path / "bare.pth")).values(), got.values()))
