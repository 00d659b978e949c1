"""numpy replicas of the two OpenCV resizes that stage 1 of the JAX package
calls, so that the port computes the same pixels without importing cv2.

- `resize_cubic_u8`: cv2.resize(..., INTER_CUBIC) on uint8 images
  (DepthAnythingV2's preprocess). OpenCV's fixed-point path: cubic
  coefficients (A = -0.75) at the half-pixel source position, computed in
  float32 and rounded to 11-bit integers; a horizontal pass in integers,
  then a vertical pass whose four-tap sum is rounded back to uint8 with
  saturation. Taps past the border repeat the edge pixel; downscaling does
  not antialias. OpenCV's vertical pass runs in float32 lanes where its SIMD
  loop reaches (`_VEC_BYTES` per step) and in integers for the tail; both
  are reproduced.
- `resize_nearest_exact`: cv2.INTER_NEAREST_EXACT (the alignment's
  disparity resize): source index (x * ifx + ifx / 2 - W % 2) >> 16 in
  16.16 fixed point, clamped to the last pixel.

A resize to the input's own size returns a copy, as cv2.resize does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS
_VEC_BYTES = 8


def _cubic_taps(n_in: int, n_out: int):
    """(first source index (n_out,), integer coefficients (n_out, 4))."""
    scale = 1.0 / (float(n_out) / n_in)
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    x = (f - s).astype(np.float32)
    A = np.float32(-0.75)
    one = np.float32(1.0)
    x1, mx = x + one, one - x
    c0 = ((A * x1 - np.float32(5) * A) * x1 + np.float32(8) * A) * x1 - np.float32(4) * A
    c1 = ((A + np.float32(2)) * x - (A + np.float32(3))) * x * x + one
    c2 = ((A + np.float32(2)) * mx - (A + np.float32(3))) * mx * mx + one
    c3 = one - c0 - c1 - c2
    c = np.stack([c0, c1, c2, c3], -1).astype(np.float32)
    ic = np.clip(np.rint(c * np.float32(_COEF_SCALE)), -32768, 32767).astype(np.int64)
    return s.astype(np.int64) - 1, ic


def resize_cubic_u8(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """uint8 (H, W[, C]) -> (h, w[, C]), bitwise cv2.resize INTER_CUBIC."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"resize_cubic_u8 takes uint8, not {img.dtype}")
    H, W = img.shape[:2]
    h, w = size_hw
    if (h, w) == (H, W):
        return img.copy()
    x0, ax = _cubic_taps(W, w)
    y0, ay = _cubic_taps(H, h)
    xi = np.clip(x0[:, None] + np.arange(4), 0, W - 1)            # (w, 4)
    yi = np.clip(y0[:, None] + np.arange(4), 0, H - 1)            # (h, 4)
    src = img.astype(np.int64)
    # horizontal pass over every source row the vertical pass reads
    hor = (src[:, xi] * ax.reshape((w, 4) + (1,) * (img.ndim - 2))).sum(2)   # (H, w[, C])
    rows = hor[yi]                                                # (h, 4, w[, C])
    beta = ay.reshape((h, 4) + (1,) * (img.ndim - 1))
    exact = (rows * beta).sum(1)
    out = (exact + (1 << (2 * _COEF_BITS - 1))) >> (2 * _COEF_BITS)
    # the SIMD loop: float32 lanes, b_k = beta_k / 2^22, summed from the
    # last tap to the first, each product rounded before its add
    lanes = out.reshape(h, -1)
    n_vec = (lanes.shape[1] // _VEC_BYTES) * _VEC_BYTES
    if n_vec:
        r32 = rows.reshape(h, 4, -1)[:, :, :n_vec].astype(np.float32)
        b32 = (ay.astype(np.float32) * np.float32(1.0 / (_COEF_SCALE * _COEF_SCALE)))[:, :, None]
        acc = r32[:, 3] * b32[:, 3]
        for k in (2, 1, 0):
            acc = r32[:, k] * b32[:, k] + acc
        lanes[:, :n_vec] = np.rint(acc)
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_nearest_exact(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """(H, W, ...) -> (h, w, ...), bitwise cv2.resize INTER_NEAREST_EXACT."""
    img = np.asarray(img)
    H, W = img.shape[:2]
    h, w = size_hw
    if (h, w) == (H, W):
        return img.copy()

    def index(n_in, n_out):
        step = ((n_in << 16) + n_out // 2) // n_out
        start = step // 2 - n_in % 2
        return np.minimum((np.arange(n_out, dtype=np.int64) * step + start) >> 16, n_in - 1)

    return img[index(H, h)][:, index(W, w)]
