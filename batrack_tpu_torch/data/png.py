"""PNG decoder on the standard library (zlib) and numpy: the PNG half of
the port's frame reader (data/image.py) and its TUM depth reader.

The repository's native library decodes with libpng, which the GPU
machines this port targets do not have. read_png_rgb reads PNG of every
colour type and bit depth, plain or Adam7-interlaced, as RGB uint8 the way
cv2.imread + COLOR_BGR2RGB (and libpng's expand, strip_16, strip_alpha and
gray_to_rgb transforms) give it: grey is replicated to RGB, alpha dropped,
16-bit samples cut to their high byte, 1/2/4-bit grey scaled to 0..255 and
palettes looked up. read_png_gray keeps the samples of an 8- or 16-bit
greyscale PNG (TUM depth maps), as PIL reads them. write_png is the
matching encoder of 8-bit RGB and 16-bit grey, with libpng's choice of row
filters.
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


# Adam7 passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _samples(raw: np.ndarray, w: int, h: int, depth: int, channels: int, path):
    """The first image of w x h pixels in the filtered stream `raw`:
    ((h, w, channels) samples, uint8 or uint16 for 16 bits; bytes used)."""
    stride = (w * channels * depth + 7) // 8
    size = h * (stride + 1)
    if raw.size < size:
        raise ValueError(f"{path}: truncated PNG image data")
    rows = _unfilter(raw[:size].reshape(h, stride + 1), h, stride,
                     max(1, channels * depth // 8))
    if depth == 16:
        px = rows.reshape(h, w * channels, 2)
        px = ((px[..., 0].astype(np.uint16) << 8) | px[..., 1]).reshape(h, w, channels)
    elif depth == 8:
        px = rows.reshape(h, w, channels)
    else:  # 1/2/4 bits: grey or palette, one sample per pixel
        px = _unpack(rows, depth, w)[..., None]
    return px, size


def _decode(path):
    """A PNG file's samples: ((h, w, channels) uint8, or uint16 for 16
    bits; IHDR fields (depth, colour type); palette or None). Interlaced
    (Adam7) images are put together from their seven passes."""
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
    channels = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if not interlace:
        px, _ = _samples(raw, w, h, depth, channels, path)
        return px, (depth, ctype), palette
    px = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw > 0 and ph > 0:
            px[y0::dy, x0::dx], used = _samples(raw, pw, ph, depth, channels, path)
            raw = raw[used:]
    return px, (depth, ctype), palette


def read_png_rgb(path) -> np.ndarray:
    """PNG file -> (H, W, 3) RGB uint8."""
    px, (depth, ctype), palette = _decode(path)
    if depth == 16:
        px = (px >> 8).astype(np.uint8)                  # libpng's strip_16: the high byte
    elif depth < 8 and ctype == 0:
        px = px * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        return palette[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def read_png_gray(path) -> np.ndarray:
    """8- or 16-bit greyscale PNG -> (H, W) uint8 or uint16, its samples
    unchanged (a TUM depth map: metres x 5000 in 16 bits)."""
    px, (depth, ctype), _ = _decode(path)
    if ctype != 0 or depth not in (8, 16):
        raise ValueError(f"{path}: not an 8- or 16-bit greyscale PNG "
                         f"(colour type {ctype}, bit depth {depth})")
    return px[..., 0].copy()


def png_size(path):
    """(H, W) of a PNG file from its header."""
    with open(path, "rb") as fh:
        head = fh.read(24)
    if not head.startswith(_SIGNATURE) or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def write_png(path, image: np.ndarray, filters=None) -> None:
    """(H, W, 3) uint8 -> 8-bit RGB PNG, or (H, W) uint16 -> 16-bit grey
    PNG. `filters` is a filter type 0-4 for every row, or one per row; by
    default each row takes the filter libpng's adaptive heuristic picks:
    the least sum of its bytes read as signed, the first of equals."""
    if image.dtype == np.uint16 and image.ndim == 2:
        h, w = image.shape
        lanes, depth, ctype = 2, 16, 0   # a pixel's two big-endian bytes
        x = image.astype(">u2").view(np.uint8).reshape(h, w, 2).astype(np.int16)
    else:
        h, w, _ = image.shape
        lanes, depth, ctype = 3, 8, 2
        x = image.reshape(h, w, 3).astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    cand = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - _paeth(a, b, c)])
    cand = (cand & 0xFF).astype(np.uint8).reshape(5, h, lanes * w)
    if filters is None:
        choice = np.abs(cand.view(np.int8).astype(np.int32)).sum(-1).argmin(0)
    else:
        choice = np.broadcast_to(np.asarray(filters, np.intp), (h,))
    rows = np.concatenate([choice[:, None].astype(np.uint8), cand[choice, np.arange(h)]], 1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                 + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b""))
