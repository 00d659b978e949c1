"""The port's frame reader: an image file as RGB uint8, the array
cv2.imread + COLOR_BGR2RGB gives (the JAX package's streams._imread_rgb).

PNG decodes through data/png.py (zlib and numpy, bitwise equal to cv2 on
every colour type, bit depth and row filter). JPEG decodes through cv2
itself, imported when a JPEG is read, so both packages run the same
decoder; without cv2 a JPEG raises. image_size reads a frame's height and
width from its header, without decoding it; write_jpeg is the matching
writer (cv2's encoder).
"""

from __future__ import annotations

import struct

import numpy as np

from batrack_tpu_torch.data import png

JPEG_SUFFIXES = (".jpg", ".jpeg")
# start-of-frame markers: every SOFn but DHT (C4), JPG (C8) and DAC (CC)
_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}
_EXIF_ORIENTATION = 0x0112


def _suffix(path) -> str:
    s = str(path).lower()
    return s[s.rfind("."):] if "." in s else ""


def _cv2(path, what: str):
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(f"{path}: {what} JPEG frames needs OpenCV (cv2)") from e
    return cv2


def read_image(path) -> np.ndarray:
    """Image file -> (H, W, 3) RGB uint8. PNG or JPEG (by suffix)."""
    suffix = _suffix(path)
    if suffix == ".png":
        return png.read_png_rgb(path)
    if suffix not in JPEG_SUFFIXES:
        raise ValueError(f"{path}: not a PNG or JPEG frame (by its suffix)")
    cv2 = _cv2(path, "reading")
    bgr = cv2.imread(str(path))
    if bgr is None:
        raise ValueError(f"{path}: cv2 cannot read this JPEG")
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def write_jpeg(path, rgb: np.ndarray, quality: int = 90) -> None:
    """(H, W, 3) RGB uint8 -> a baseline JPEG (cv2.imwrite, 4:2:0)."""
    cv2 = _cv2(path, "writing")
    if not cv2.imwrite(str(path), cv2.cvtColor(np.ascontiguousarray(rgb), cv2.COLOR_RGB2BGR),
                       [cv2.IMWRITE_JPEG_QUALITY, int(quality)]):
        raise ValueError(f"{path}: cv2 cannot write this JPEG")


def _exif_transposes(body: bytes) -> bool:
    """True when an APP1 Exif body's orientation (5-8) swaps the axes, as
    cv2.imread applies it."""
    if not body.startswith(b"Exif\x00\x00") or len(body) < 14:
        return False
    tiff = body[6:]
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if order is None:
        return False
    ifd = struct.unpack(order + "I", tiff[4:8])[0]
    if ifd + 2 > len(tiff):
        return False
    count = struct.unpack(order + "H", tiff[ifd:ifd + 2])[0]
    for e in range(count):
        at = ifd + 2 + 12 * e
        if at + 12 > len(tiff):
            break
        tag, kind = struct.unpack(order + "HH", tiff[at:at + 4])
        if tag == _EXIF_ORIENTATION and kind == 3:  # SHORT, stored in the entry
            return struct.unpack(order + "H", tiff[at + 8:at + 10])[0] in (5, 6, 7, 8)
    return False


def _jpeg_size(path):
    """(H, W) from a JPEG's start-of-frame marker, after its Exif
    orientation."""
    with open(path, "rb") as fh:
        buf = fh.read()
    if not buf.startswith(b"\xff\xd8"):
        raise ValueError(f"{path}: not a JPEG file")
    pos, transposed = 2, False
    while pos + 4 <= len(buf):
        if buf[pos] != 0xFF:
            raise ValueError(f"{path}: corrupt JPEG marker at byte {pos}")
        marker = buf[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker in (0x01, *range(0xD0, 0xD8)):  # standalone markers
            pos += 2
            continue
        length = struct.unpack(">H", buf[pos + 2:pos + 4])[0]
        body = buf[pos + 4:pos + 2 + length]
        if marker == 0xE1:
            transposed = transposed or _exif_transposes(body)
        elif marker in _SOF:
            h, w = struct.unpack(">HH", body[1:5])
            return (w, h) if transposed else (h, w)
        elif marker == 0xDA:  # scan data before any frame header
            break
        pos += 2 + length
    raise ValueError(f"{path}: JPEG without a start-of-frame marker")


def image_size(path):
    """(H, W) of a PNG or JPEG frame from its header, as
    cv2.imread(path).shape[:2] gives it."""
    suffix = _suffix(path)
    if suffix == ".png":
        return png.png_size(path)
    if suffix in JPEG_SUFFIXES:
        return _jpeg_size(path)
    raise ValueError(f"{path}: not a PNG or JPEG frame (by its suffix)")
