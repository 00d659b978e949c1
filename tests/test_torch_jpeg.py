"""JPEG frames in the port against the JAX package's readers:

* data/image.py::read_image on baseline, progressive, greyscale, 4:2:0,
  4:2:2 and 4:4:4 JPEGs at odd sizes, bitwise equal to the JAX package's
  streams._imread_rgb (both call cv2), and image_size from the header equal
  to cv2's shape, Exif orientation included;
* davis_stream, dataset_rgbd_stream and native_rgbd_stream over a JPEG
  directory, bitwise equal to the JAX streams; the JAX native loader
  decodes with libjpeg where the port calls cv2, and the pixels in which
  the two decoders differ are counted (0 on these frames) and asserted;
* a file cv2 cannot read raises, and a frame without cv2 raises a
  RuntimeError naming the feature;
* the 16-bit TUM depth reader (data/png.py::read_png_gray) bitwise equal
  to the JAX package's PIL reader, on PNGs of every row filter;
* Adam7-interlaced PNGs of several colour types and bit depths, equal to
  cv2 (libpng) and PIL.
"""

import builtins
import struct
import zlib

import numpy as np
import pytest

import batrack_tpu.data.streams as jstreams
from batrack_tpu_torch.data import image, png, streams

cv2 = pytest.importorskip("cv2")

H0, W0 = 53, 70   # odd sizes; the streams crop to 48 x 64
T = 4

CASES = {
    "baseline": [],
    "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
    "s444": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
    "s422": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422],
    "s420": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420],
    "grey": None,
}


def _texture(rng, h=H0, w=W0):
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([(3 * xx + yy) % 256, (5 * yy) % 256, (xx * yy) % 256], -1)
    return (smooth // 2 + rng.integers(0, 64, smooth.shape)).astype(np.uint8)


def _write_jpeg(path, rgb, params, quality=90):
    if params is None:
        cv2.imwrite(str(path), rgb[..., 0])
    else:
        cv2.imwrite(str(path), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR),
                    params + [cv2.IMWRITE_JPEG_QUALITY, quality])


def test_write_jpeg_is_cv2s_writer(tmp_path):
    """data/image.py::write_jpeg writes what cv2.imwrite writes from the
    BGR frame at the same quality, byte for byte."""
    rgb = _texture(np.random.default_rng(9))
    image.write_jpeg(tmp_path / "a.jpg", rgb, quality=90)
    cv2.imwrite(str(tmp_path / "b.jpg"), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR),
                [cv2.IMWRITE_JPEG_QUALITY, 90])
    assert (tmp_path / "a.jpg").read_bytes() == (tmp_path / "b.jpg").read_bytes()
    assert image.image_size(tmp_path / "a.jpg") == (H0, W0)


@pytest.mark.parametrize("kind", list(CASES))
@pytest.mark.parametrize("size", [(H0, W0), (17, 9)])
def test_read_image_matches_jax_imread(tmp_path, kind, size):
    rgb = _texture(np.random.default_rng(1), *size)
    path = tmp_path / f"{kind}.jpeg"
    _write_jpeg(path, rgb, CASES[kind])
    got = image.read_image(path)
    ref = jstreams._imread_rgb(path)
    assert got.dtype == np.uint8 and got.shape == size + (3,)
    np.testing.assert_array_equal(got, ref)
    assert image.image_size(path) == cv2.imread(str(path)).shape[:2] == size


@pytest.mark.parametrize("orientation", [1, 3, 6, 8])
def test_image_size_follows_exif_orientation(tmp_path, orientation):
    """cv2.imread turns a frame by its Exif orientation; the header reader
    swaps height and width where cv2 does (5-8)."""
    from PIL import Image

    exif = Image.Exif()
    exif[0x0112] = orientation
    path = tmp_path / "o.jpg"
    Image.fromarray(_texture(np.random.default_rng(2))).save(path, exif=exif, quality=90)
    ref = cv2.imread(str(path))
    assert image.image_size(path) == ref.shape[:2]
    np.testing.assert_array_equal(image.read_image(path), cv2.cvtColor(ref, cv2.COLOR_BGR2RGB))


def test_unreadable_and_missing_decoder_raise(tmp_path, monkeypatch):
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8\xff\xe0 not a jpeg")
    with pytest.raises(ValueError, match="cv2 cannot read"):
        image.read_image(bad)
    with pytest.raises(ValueError, match="not a PNG or JPEG"):
        image.read_image(tmp_path / "x.bmp")
    good = tmp_path / "good.jpg"
    _write_jpeg(good, _texture(np.random.default_rng(3)), [])
    real_import = builtins.__import__

    def no_cv2(name, *args, **kw):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(RuntimeError, match="reading JPEG frames needs OpenCV"):
        image.read_image(good)
    with pytest.raises(RuntimeError, match="writing JPEG frames needs OpenCV"):
        image.write_jpeg(tmp_path / "w.jpg", np.zeros((8, 8, 3), np.uint8))
    assert image.image_size(good) == (H0, W0)  # the header needs no decoder


@pytest.fixture
def jpeg_dir(tmp_path):
    """T JPEG frames of mixed kinds (and suffixes), .npy depths and
    per-frame K, as the DAVIS layout holds them."""
    rng = np.random.default_rng(4)
    d = {k: tmp_path / k for k in ("rgb", "depth", "K", "calib")}
    for p in d.values():
        p.mkdir()
    kinds = list(CASES)
    K = np.array([[60.0, 0, 32.5], [0, 61.0, 24.5], [0, 0, 1]])
    for t in range(T):
        suffix = "jpeg" if t == 2 else "jpg"
        _write_jpeg(d["rgb"] / f"{t:05d}.{suffix}", _texture(rng), CASES[kinds[t % len(kinds)]])
        np.save(d["depth"] / f"{t:05d}.npy", rng.uniform(1, 5, (H0, W0)))
        np.save(d["K"] / f"{t:05d}.npy", K * (1 + 0.01 * t))
    np.savetxt(d["calib"] / "calib.txt", np.array([[60.0, 61.0, 32.5, 24.5]]), delimiter=" ")
    d["calib_file"] = d["calib"] / "calib.txt"
    return d


def _assert_same_stream(port, ref):
    port, ref = list(port), list(ref)
    assert len(port) == len(ref) == T + 1
    for a, b in zip(port, ref):
        assert str(a[0]) == str(b[0])
        for x, y in zip(a[1:], b[1:]):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", ["davis", "generic"])
def test_jpeg_streams_match_jax(jpeg_dir, kind):
    d = jpeg_dir
    if kind == "davis":
        args = (d["rgb"], d["depth"], d["K"])
        port, ref = streams.davis_stream(*args), jstreams.davis_stream(*args)
    else:
        args = (d["rgb"], d["depth"], d["calib_file"])
        port, ref = streams.dataset_rgbd_stream(*args), jstreams.dataset_rgbd_stream(*args)
    _assert_same_stream(port, ref)


def test_native_stream_on_jpeg_matches_jax(jpeg_dir):
    """The JAX package's prefetcher decodes with libjpeg, the port with
    cv2's libjpeg-turbo: the pixels that differ are counted, and every
    other value of the stream is held bitwise."""
    d = jpeg_dir
    imgs = sorted(d["rgb"].glob("*.jp*g"))
    deps = sorted(d["depth"].glob("*.npy"))
    intr = lambda t: np.array([60.0, 61.0, 32.5, 24.5]) + t  # noqa: E731
    port = list(streams.native_rgbd_stream(imgs, deps, intr))
    ref = list(jstreams.native_rgbd_stream(imgs, deps, intr))
    assert len(port) == len(ref) == T + 1
    differing = 0
    for a, b in zip(port, ref):
        assert a[0] == b[0] and a[1].shape == b[1].shape == (48, 64, 3)
        differing += int((a[1] != b[1]).any(-1).sum())
        for x, y in zip(a[2:], b[2:]):
            np.testing.assert_array_equal(x, y)
    assert differing == 0, f"{differing} pixels differ between libjpeg and cv2"
    # and the prefetcher's frames are the Python stream's
    for a, b in zip(port, streams.dataset_rgbd_stream(d["rgb"], d["depth"], d["calib_file"])):
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("filters", [None, 0, 1, 2, 3, 4, "random"])
def test_tum_depth_png_matches_jax(tmp_path, filters):
    """data/png.py's 16-bit greyscale reader through tum_depth_read against
    the JAX package's PIL reader, bitwise, for every row filter (written by
    png.write_png, which cv2 reads back) and for cv2's own writer."""
    rng = np.random.default_rng(6)
    depth = rng.integers(0, 65536, (29, 41)).astype(np.uint16)
    depth[:5] = np.arange(41, dtype=np.uint16) * 1500   # smooth rows as well as noise
    rows = rng.integers(0, 5, 29) if filters == "random" else filters
    path = tmp_path / "d.png"
    png.write_png(path, depth, rows)
    np.testing.assert_array_equal(cv2.imread(str(path), cv2.IMREAD_UNCHANGED), depth)
    got = streams.tum_depth_read(str(path))
    np.testing.assert_array_equal(got, jstreams.tum_depth_read(str(path)))
    np.testing.assert_array_equal(png.read_png_gray(path), depth)
    cv2.imwrite(str(tmp_path / "cv.png"), depth)
    np.testing.assert_array_equal(streams.tum_depth_read(str(tmp_path / "cv.png")),
                                  jstreams.tum_depth_read(str(tmp_path / "cv.png")))
    grey8 = tmp_path / "g8.png"
    cv2.imwrite(str(grey8), (depth >> 8).astype(np.uint8))
    np.testing.assert_array_equal(png.read_png_gray(grey8), (depth >> 8).astype(np.uint8))
    png.write_png(tmp_path / "rgb.png", _texture(rng))
    with pytest.raises(ValueError, match="greyscale"):
        png.read_png_gray(tmp_path / "rgb.png")


def _write_interlaced(path, px, depth, ctype):
    """An Adam7-interlaced PNG of samples px (h, w, channels), every row
    unfiltered: the seven passes one after another, as libpng reads them."""
    h, w, ch = px.shape
    stream = b""
    for x0, y0, dx, dy in png._ADAM7:
        sub = px[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        if depth == 16:
            data = sub.astype(">u2").view(np.uint8).reshape(sub.shape[0], -1)
        elif depth == 8:
            data = sub.reshape(sub.shape[0], -1)
        else:
            bits = ((sub[..., 0][..., None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
            data = np.packbits(bits.reshape(sub.shape[0], -1), axis=1)
        stream += b"".join(b"\x00" + r.tobytes() for r in data)

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 1)
    path.write_bytes(png._SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(stream))
                     + chunk(b"IEND", b""))


@pytest.mark.parametrize("depth,ctype", [(8, 2), (16, 2), (8, 6), (16, 0), (4, 0), (1, 0)])
@pytest.mark.parametrize("size", [(13, 11), (1, 7), (9, 1)])
def test_interlaced_png_matches_cv2(tmp_path, depth, ctype, size):
    from PIL import Image

    rng = np.random.default_rng(8)
    ch = {0: 1, 2: 3, 6: 4}[ctype]
    px = rng.integers(0, 1 << depth, size + (ch,)).astype(np.uint16 if depth == 16 else np.uint8)
    path = tmp_path / "i.png"
    _write_interlaced(path, px, depth, ctype)
    ref = cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(png.read_png_rgb(path), ref)
    np.testing.assert_array_equal(image.read_image(path), ref)
    if ctype == 0 and depth in (8, 16):
        np.testing.assert_array_equal(png.read_png_gray(path), px[..., 0])
        np.testing.assert_array_equal(png.read_png_gray(path), np.array(Image.open(path)))
