"""Dataset streams: generators yielding (t, image, depth, depth_gt, intrinsics).

A copy of batrack_tpu/data/streams.py for this package: Sintel (.cam/.dpt
binary readers), TartanAir, DAVIS (per-frame K .npy) and generic directory
streams, plus the prefetching stream over path lists. Frames are cropped
to multiples of 16 and the stream ends with a t = -1 sentinel.

Frames decode through data/image.py, which gives the RGB uint8 array
cv2.imread + COLOR_BGR2RGB gives: PNG in numpy (data/png.py), JPEG through
cv2 itself, loaded only when a JPEG is read. TUM's 16-bit depth PNGs read
through data/png.py too, and the nearest-neighbour depth resize picks its
source pixels by cv2.INTER_NEAREST's rule in numpy. Every stream decodes
its frames ahead of its reader on worker processes (`_ahead`). The JAX
package's native_rgbd_stream runs the native library's loader
(libpng/libjpeg); this one decodes with data/image.py the same way and
keeps that loader's crop, clip and ordering.
"""

from __future__ import annotations

import os
import subprocess
import sys
from itertools import chain
from pathlib import Path
from typing import Callable, Iterable, Iterator, Tuple

import numpy as np

from batrack_tpu_torch.data import png
from batrack_tpu_torch.data.image import read_image

TAG_FLOAT = 202021.25
TUM_SCALING = 5000.0

IMG_EXTS = ["*.png", "*.jpeg", "*.jpg"]
DECODE_WORKERS = 2         # processes that decode frames ahead of a stream's reader
DECODE_AHEAD = 8           # jobs handed out ahead of the reader (the native loader's queue)
_PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])
DEPTH_RANGE = (1e-2, 1e2)  # native_rgbd_stream's depth clip, in float32


def _ahead(fn: Callable, jobs: Iterable[tuple], workers: int = DECODE_WORKERS) -> Iterator:
    """fn(*job) for each job, in order. The first runs here; the rest are
    dealt round-robin to `workers` worker processes (data/decode_worker.py),
    up to DECODE_AHEAD ahead of the reader, and read back in order. `fn` is
    a module-level function of an importable module. Processes, not
    threads: the PNG decoder's anti-diagonal sweep is about a thousand small
    numpy calls per frame that hold the GIL, so on a thread it stalls the
    SLAM loop's host work, more than decoding inline does
    (`chip_smoke.py --decode-ab`). A job's exception is raised here."""
    # imported here: `python -m` of the worker imports this package first,
    # and must not find the worker module already loaded
    from batrack_tpu_torch.data import decode_worker

    jobs = iter(jobs)
    first = next(jobs, None)
    if first is None:
        return
    path = os.pathsep.join(p for p in (_PACKAGE_ROOT, os.environ.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen([sys.executable, "-m", decode_worker.__name__],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              env=dict(os.environ, PYTHONPATH=path))
             for _ in range(workers)]
    sent = 0

    def hand_out() -> None:
        nonlocal sent
        for job in jobs:
            decode_worker.send(procs[sent % workers].stdin, (fn.__module__, fn.__qualname__, job))
            sent += 1
            return

    try:
        for _ in range(DECODE_AHEAD):
            hand_out()
        yield fn(*first)
        read = 0
        while read < sent:
            answer = decode_worker.receive(procs[read % workers].stdout)
            if answer is None:
                raise RuntimeError(f"decode worker exited (code {procs[read % workers].poll()})")
            read += 1
            hand_out()
            status, value = answer
            if status == "error":
                raise value
            yield value
    finally:
        for p in procs:
            p.kill()
            p.wait()
            p.stdin.close()
            p.stdout.close()


def _decoded(paths) -> Iterator[np.ndarray]:
    """The frames at `paths` as RGB uint8, decoded ahead (`_ahead`)."""
    return _ahead(read_image, [(p,) for p in paths])


def _glob_sorted(d: str, exts) -> list:
    return sorted(chain.from_iterable(Path(d).glob(e) for e in exts))


def resize_nearest(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST) for an
    (H, W) or (H, W, C) array: destination pixel x reads source pixel
    min(floor(x * (1 / (w / W))), W - 1), in float64 as OpenCV computes it.
    Keeps a trailing channel axis (cv2 drops a single one)."""
    H, W = img.shape[:2]
    h, w = out_hw
    sy = np.minimum(np.floor(np.arange(h) * (1.0 / (h / H))).astype(np.int64), H - 1)
    sx = np.minimum(np.floor(np.arange(w) * (1.0 / (w / W))).astype(np.int64), W - 1)
    return img[sy[:, None], sx[None, :]]


def cam_read_sintel(filename: str):
    """Sintel .cam: (K (3,3), extrinsic (3,4))."""
    with open(filename, "rb") as f:
        check = np.fromfile(f, dtype=np.float32, count=1)[0]
        if check != TAG_FLOAT:
            raise ValueError(f"bad .cam tag {check} in {filename}")
        M = np.fromfile(f, dtype="float64", count=9).reshape((3, 3))
        N = np.fromfile(f, dtype="float64", count=12).reshape((3, 4))
    return M, N


def sintel_depth_read(filename: str) -> np.ndarray:
    """Sintel .dpt binary depth."""
    with open(filename, "rb") as f:
        check = np.fromfile(f, dtype=np.float32, count=1)[0]
        if check != TAG_FLOAT:
            raise ValueError(f"bad .dpt tag {check} in {filename}")
        width = np.fromfile(f, dtype=np.int32, count=1)[0]
        height = np.fromfile(f, dtype=np.int32, count=1)[0]
        depth = np.fromfile(f, dtype=np.float32, count=-1).reshape((height, width))
    return depth


def tum_depth_read(filename: str) -> np.ndarray:
    """TUM 16-bit depth PNG -> metres (float64)."""
    return png.read_png_gray(filename) / TUM_SCALING


def load_depth_file(filename: str, mode: str = "sintel") -> np.ndarray:
    """Dispatch on extension; returns (H, W, 1) float64."""
    filename = str(filename)
    if filename.endswith(".npy"):
        depth = np.load(filename)
    elif filename.endswith(".npz"):
        depth = np.load(filename)["depth"]
    elif mode == "sintel":
        depth = sintel_depth_read(filename)
    elif mode in ("tum", "tartanair"):
        depth = tum_depth_read(filename)
    else:
        raise NotImplementedError(filename)
    if depth.ndim == 2:
        depth = depth[..., None]
    return depth.astype(float)


def _crop16(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    return img[: h - h % 16, : w - w % 16]


def _check_lengths(**lists) -> None:
    n = {k: len(v) for k, v in lists.items()}
    if len(set(n.values())) > 1:
        raise ValueError(f"stream inputs differ in length: {n}")


def sintel_rgbd_stream(
    imagedir, depthdir, depthdir_gt, calib_root, stride=1, skip=0, end=-1,
    input_intrinsics=False,
) -> Iterator[Tuple]:
    """Sintel layout; `end` bounds every list, as in the JAX package."""
    stop = None if end == -1 else end
    image_list = _glob_sorted(imagedir, IMG_EXTS)[skip:stop:stride]
    depth_list = _glob_sorted(depthdir, ["*.npy", "*.npz"])[skip:stop:stride]
    depth_list_gt = _glob_sorted(depthdir_gt, ["*.dpt"])[skip:stop:stride]
    _check_lengths(images=image_list, depths=depth_list)

    Ks = None
    if input_intrinsics:
        K_list = _glob_sorted(calib_root, ["*.npy"])
        Ks = np.array([np.load(str(k)) for k in K_list])
        if end == -1:
            end = len(image_list)
        Ks = Ks[skip:end:stride]

    frame = None
    for t, image in enumerate(_decoded(image_list)):
        imfile = image_list[t]
        if Ks is not None:
            K = Ks[0]
        else:
            camfile = os.path.join(
                calib_root, os.path.basename(str(imfile)).replace(".png", ".cam"))
            K, _ = cam_read_sintel(camfile)
        intrinsics = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
        image = _crop16(image)
        depth = _crop16(load_depth_file(depth_list[t]))
        if depth.shape[:2] != image.shape[:2]:
            depth = resize_nearest(depth, image.shape[:2])
        depth_gt = _crop16(load_depth_file(depth_list_gt[t], mode="sintel"))
        frame = (t, image, depth, depth_gt, intrinsics)
        yield frame
    if frame is not None:  # no sentinel for an empty stream (clear error upstream)
        yield (-1,) + frame[1:]


def tartanair_rgbd_stream(
    imagedir, depthdir, depthdir_gt, calib_root, stride=1, skip=0, end=-1
) -> Iterator[Tuple]:
    """TartanAir layout; `end` honoured."""
    calib = np.loadtxt(calib_root, delimiter=" ")
    intrinsics = np.array(calib[:4])

    stop = None if end == -1 else end
    image_list = _glob_sorted(imagedir, IMG_EXTS)[skip:stop:stride]
    depth_list = _glob_sorted(depthdir, ["*.npy", "*.npz"])[skip:stop:stride]
    depth_list_gt = _glob_sorted(depthdir_gt, ["*.npy"])[skip:stop:stride]
    _check_lengths(images=image_list, depths=depth_list)

    frame = None
    for t, image in enumerate(_decoded(image_list)):
        timestamp = Path(str(image_list[t])).stem
        image = _crop16(image)
        depth = _crop16(load_depth_file(depth_list[t]))
        depth_gt = _crop16(load_depth_file(depth_list_gt[t], mode="tartanair"))
        frame = (timestamp, image, depth, depth_gt, intrinsics)
        yield frame
    if frame is not None:
        yield (-1,) + frame[1:]


def davis_stream(imagedir, depthdir, calib_root, stride=1, skip=0, end=-1):
    """DAVIS layout: per-frame K matrices from the alignment stage."""
    image_list = _glob_sorted(imagedir, IMG_EXTS)
    depth_list = _glob_sorted(depthdir, ["*.npy"])
    K_list = _glob_sorted(calib_root, ["*.npy"])
    Ks = np.array([np.load(str(k)) for k in K_list])
    if end == -1:
        end = len(image_list)
    Ks = Ks[skip:end:stride]
    image_list = image_list[skip:end:stride]
    depth_list = depth_list[skip:end:stride]
    _check_lengths(images=image_list, depths=depth_list, intrinsics=Ks)

    frame = None
    for t, image in enumerate(_decoded(image_list)):
        image = _crop16(image)
        intrinsics = np.array([Ks[t, 0, 0], Ks[t, 1, 1], Ks[t, 0, 2], Ks[t, 1, 2]])
        depth = _crop16(load_depth_file(depth_list[t]))
        frame = (t, image, depth, depth, intrinsics)
        yield frame
    if frame is not None:
        yield (-1,) + frame[1:]


def dataset_rgbd_stream(imagedir, depthdir, calib, stride=1, skip=0, end=-1,
                        mode="replica"):
    """Generic fixed-K stream; `end` honoured."""
    calib = np.loadtxt(calib, delimiter=" ")
    intrinsics = np.array(calib[:4])
    stop = None if end == -1 else end
    image_list = _glob_sorted(imagedir, IMG_EXTS)[skip:stop:stride]
    depth_list = _glob_sorted(depthdir, ["*.npy"])[skip:stop:stride]
    _check_lengths(images=image_list, depths=depth_list)

    frame = None
    for t, image in enumerate(_decoded(image_list)):
        image = _crop16(image)
        depth = _crop16(load_depth_file(depth_list[t]))
        frame = (t, image, depth, depth, intrinsics)
        yield frame
    if frame is not None:
        yield (-1,) + frame[1:]


def _prefetch_frame(image_path, depth_path):
    """One frame as the native loader makes it: the image cropped to
    multiples of 16, the depth (.npy or .dpt) read in float32, cut to the
    image's size and clipped to DEPTH_RANGE in float32."""
    image = _crop16(read_image(image_path))
    path = str(depth_path)
    depth = sintel_depth_read(path) if path.endswith(".dpt") else np.load(path)
    depth = np.asarray(depth, np.float32)
    H, W = image.shape[:2]
    if depth.ndim < 2 or depth.shape[0] < H or depth.shape[1] < W:
        raise ValueError(f"{path}: depth {depth.shape} smaller than the frame ({H}, {W})")
    depth = depth.reshape(depth.shape[0], depth.shape[1])[:H, :W]
    return image, np.clip(depth, *np.float32(DEPTH_RANGE))


def native_rgbd_stream(
    image_paths, depth_paths, intrinsics_fn, num_threads: int = DECODE_WORKERS
) -> Iterator[Tuple]:
    """Prefetched RGB-D stream over path lists (image .png, .jpg or .jpeg;
    depth .npy or Sintel .dpt).

    intrinsics_fn(t) -> (4,) per-frame intrinsics. Yields the same tuples as
    the other streams (depth_gt = depth), with decode, crop and clip running
    on `num_threads` worker processes (`_ahead`), and the -1 sentinel at the
    end. Every frame must crop to frame 0's size.
    """
    image_paths, depth_paths = list(image_paths), list(depth_paths)
    _check_lengths(images=image_paths, depths=depth_paths)
    frame = None
    for idx, (image, depth) in enumerate(
            _ahead(_prefetch_frame, zip(image_paths, depth_paths), num_threads)):
        if frame is not None and image.shape != frame[1].shape:
            raise ValueError(f"{image_paths[idx]}: frame {image.shape[:2]} differs from "
                             f"frame 0's {frame[1].shape[:2]}")
        d = depth[..., None].astype(float)
        frame = (idx, image, d, d, np.asarray(intrinsics_fn(idx)))
        yield frame
    if frame is not None:
        yield (-1,) + frame[1:]
