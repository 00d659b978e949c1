"""Dataset streams and binary readers (Sintel/TartanAir/DAVIS/generic)."""

from batrack_tpu_torch.data.streams import (
    cam_read_sintel,
    dataset_rgbd_stream,
    davis_stream,
    load_depth_file,
    native_rgbd_stream,
    sintel_depth_read,
    sintel_rgbd_stream,
    tartanair_rgbd_stream,
)

__all__ = [
    "native_rgbd_stream",
    "sintel_rgbd_stream",
    "tartanair_rgbd_stream",
    "davis_stream",
    "dataset_rgbd_stream",
    "load_depth_file",
    "sintel_depth_read",
    "cam_read_sintel",
]
