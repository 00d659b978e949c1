"""PNG decoder on the standard library (zlib) and numpy: the port's image
reader.

The repository's native library decodes with libpng and libjpeg, which the
GPU machines this port targets do not have, so the streams read PNG here:
every colour type and bit depth of non-interlaced PNG, as RGB uint8 the way
cv2.imread + COLOR_BGR2RGB (and libpng's expand, strip_16, strip_alpha and
gray_to_rgb transforms) give it: grey is replicated to RGB, alpha dropped,
16-bit samples cut to their high byte, 1/2/4-bit grey scaled to 0..255 and
palettes looked up. JPEG and interlaced PNG raise. write_png is the
matching 8-bit RGB encoder, with libpng's choice of row filters.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(buf: bytes, path):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(buf):
        length, tag = struct.unpack(">I4s", buf[pos:pos + 8])
        yield tag, buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IEND":
            return
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _paeth(a, b, c):
    """The PNG Paeth predictor of int16 arrays."""
    bc, ac = b - c, a - c
    pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _wavefront(f: np.ndarray, ftype: np.ndarray, above: np.ndarray) -> np.ndarray:
    """Undo any mix of filters on rows f (n, w, bpp) under the decoded row
    `above` (w, bpp). A byte depends on its left (a), upper (b) and
    upper-left (c) neighbours, so pixels are decoded along anti-diagonals.
    Row i is shifted right by i and stored by column (S[i + x + 1, i]
    holds its pixel x; row 0 is `above`, S[i, i] the zero left border):
    every anti-diagonal is then one contiguous column of S, and a, b, c are
    slices of the two columns before it."""
    n, w, bpp = f.shape
    S = np.zeros((n + w + 1, n + 1, bpp), np.int16)
    F = np.zeros_like(S)
    rows = np.arange(n + 1)[:, None]
    cols = rows + np.arange(1, w + 1)[None, :]
    S[1:w + 1, 0] = above
    F[cols[1:], rows[1:]] = f
    ft = ftype.astype(np.intp)[:, None]
    for j in range(2, n + w + 1):
        lo, hi = max(1, j - w), min(n, j - 1)    # rows whose pixel j - i - 1 is in [0, w)
        a, b, c = S[j - 1, lo:hi + 1], S[j - 1, lo - 1:hi], S[j - 2, lo - 1:hi]
        pred = np.choose(ft[lo - 1:hi], (np.zeros_like(a), a, b, (a + b) >> 1, _paeth(a, b, c)))
        S[j, lo:hi + 1] = (F[j, lo:hi + 1] + pred) & 0xFF
    return S[cols[1:], rows[1:]].astype(np.uint8)


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: raw (h, 1 + stride) -> (h, stride) uint8.
    None and Sub rows need only themselves (Sub is a running sum mod 256
    along each byte lane of a pixel) and Up rows the row above (a sum down
    each run of them); Average and Paeth need a sequential sweep, run once
    over the rows from the first to the last of them."""
    ftype = raw[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"bad PNG filter type {int(ftype.max())}")
    w = stride // bpp
    f = raw[:, 1:].reshape(h, w, bpp)
    out = f.copy()
    sub = ftype == 1
    if sub.any():
        out[sub] = np.cumsum(f[sub], axis=1, dtype=np.uint8)
    swept = np.flatnonzero(ftype >= 3)
    lo, hi = (swept[0], swept[-1] + 1) if swept.size else (h, h)
    zero = np.zeros((w, bpp), np.uint8)
    r = 0
    while r < h:
        if r == lo:
            out[lo:hi] = _wavefront(f[lo:hi], ftype[lo:hi], out[lo - 1] if lo else zero)
            r = hi
        elif ftype[r] == 2:  # a run of Up rows: a sum down the run from the row above
            e = r + 1
            while e < h and ftype[e] == 2:
                e += 1
            out[r:e] = np.cumsum(f[r:e], axis=0, dtype=np.uint8) + (out[r - 1] if r else zero)
            r = e
        else:
            r += 1
    return out.reshape(h, stride)


def _unpack(rows: np.ndarray, depth: int, width: int) -> np.ndarray:
    """(h, stride) packed 1/2/4-bit samples (MSB first) -> (h, width)."""
    bits = np.unpackbits(rows, axis=1).reshape(rows.shape[0], -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1).astype(np.uint8)[:, :width]


def read_png_rgb(path) -> np.ndarray:
    """PNG file -> (H, W, 3) RGB uint8."""
    with open(path, "rb") as fh:
        buf = fh.read()
    if not buf.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for tag, body in _chunks(buf, path):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"{path}: unsupported PNG colour type {ctype} / bit depth {depth}")
    if interlace:
        raise NotImplementedError(f"{path}: interlaced PNG is not supported")
    channels = _CHANNELS[ctype]
    stride = (w * channels * depth + 7) // 8
    bpp = max(1, channels * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError(f"{path}: truncated PNG image data")
    rows = _unfilter(raw[: h * (stride + 1)].reshape(h, stride + 1), h, stride, bpp)

    if depth == 16:
        px = rows.reshape(h, w, channels, 2)[..., 0]     # big-endian: high byte first
    elif depth == 8:
        px = rows.reshape(h, w, channels)
    else:  # 1/2/4 bits: grey or palette, one sample per pixel
        px = _unpack(rows, depth, w)[..., None]
        if ctype == 0:
            px = px * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        return palette[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def write_png(path, rgb: np.ndarray, filters=None) -> None:
    """(H, W, 3) uint8 -> 8-bit RGB PNG. `filters` is a filter type 0-4
    for every row, or one per row; by default each row takes the filter
    libpng's adaptive heuristic picks: the least sum of its bytes read as
    signed, the first of equals."""
    h, w, _ = rgb.shape
    x = rgb.reshape(h, w, 3).astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    cand = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - _paeth(a, b, c)])
    cand = (cand & 0xFF).astype(np.uint8).reshape(5, h, 3 * w)
    if filters is None:
        choice = np.abs(cand.view(np.int8).astype(np.int32)).sum(-1).argmin(0)
    else:
        choice = np.broadcast_to(np.asarray(filters, np.intp), (h,))
    rows = np.concatenate([choice[:, None].astype(np.uint8), cand[choice, np.arange(h)]], 1)
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                 + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b""))


def read_image(path) -> np.ndarray:
    """Image file -> (H, W, 3) RGB uint8. PNG only."""
    if str(path).lower().endswith(".png"):
        return read_png_rgb(path)
    raise NotImplementedError(
        f"{path}: only PNG frames are readable here (no JPEG decoder without libjpeg); "
        "convert the frames to PNG")


def image_size(path):
    """(H, W) of an image file from its PNG header. PNG only, as read_image."""
    if not str(path).lower().endswith(".png"):
        read_image(path)
    with open(path, "rb") as fh:
        head = fh.read(24)
    if not head.startswith(_SIGNATURE) or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    w, h = struct.unpack(">II", head[16:24])
    return h, w
