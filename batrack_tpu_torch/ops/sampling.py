"""Bilinear sampling and patch extraction on torch tensors (counterpart of
batrack_tpu/ops/sampling.py, same conventions):

  * bilinear_sample2d: 4 taps at floor/floor+1, indices clamped to the
    image, weights from the *unclamped* coordinates;
  * patchify: integer window [floor(c) - r, floor(c) + r + 1], taps clamped
    ("border") or zeroed ("zeros") outside the image, then a 2x2 bilinear
    blend of the (2r+2)^2 window down to (2r+1)^2;
  * resize_linear: jax.image.resize(..., method="linear") as two products
    with (n_out, n_in) weight matrices.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _rows(im: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C): one contiguous C-vector per pixel."""
    B, C, H, W = im.shape
    return im.reshape(B, C, H * W).transpose(1, 2)


def _gather_rows(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows (B, HW, C), idx (B, ...) int64 -> (B, ..., C)."""
    B, _, C = rows.shape
    flat = idx.reshape(B, -1)
    out = torch.gather(rows, 1, flat[..., None].expand(B, flat.shape[1], C))
    return out.reshape(idx.shape + (C,))


def bilinear_sample2d(im: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample im (B, C, H, W) at float pixel coords x, y (B, N) -> (B, C, N)."""
    B, C, H, W = im.shape
    x = x.to(im.dtype)
    y = y.to(im.dtype)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    x0c = x0.clamp(0, W - 1).long()
    x1c = x1.clamp(0, W - 1).long()
    y0c = y0.clamp(0, H - 1).long()
    y1c = y1.clamp(0, H - 1).long()

    rows = _rows(im)
    i00 = _gather_rows(rows, y0c * W + x0c)
    i01 = _gather_rows(rows, y0c * W + x1c)
    i10 = _gather_rows(rows, y1c * W + x0c)
    i11 = _gather_rows(rows, y1c * W + x1c)

    w00 = ((x1 - x) * (y1 - y))[..., None]
    w01 = ((x - x0) * (y1 - y))[..., None]
    w10 = ((x1 - x) * (y - y0))[..., None]
    w11 = ((x - x0) * (y - y0))[..., None]
    out = w00 * i00 + w01 * i01 + w10 * i10 + w11 * i11  # (B, N, C)
    return out.transpose(1, 2)


def patchify(
    net: torch.Tensor, coords: torch.Tensor, radius: int,
    padding_mode: str = "border",
) -> torch.Tensor:
    """Bilinear patches around float coords.

    net: (B, C, H, W); coords: (B, N, 2) as (x, y).
    Returns (B, N, C, 2r+1, 2r+1).
    """
    B, C, H, W = net.shape
    r = radius
    D = 2 * r + 2
    x = coords[..., 0]
    y = coords[..., 1]
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()

    off = torch.arange(-r, r + 2, device=net.device)
    ix = (x0[..., None, None] + off[None, :]).expand(x0.shape + (D, D))
    iy = (y0[..., None, None] + off[:, None]).expand(y0.shape + (D, D))
    in_bounds = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    ix = ix.clamp(0, W - 1)
    iy = iy.clamp(0, H - 1)

    patches = _gather_rows(_rows(net), iy * W + ix)  # (B, N, D, D, C)
    if padding_mode == "zeros":
        patches = patches * in_bounds[..., None].to(patches.dtype)
    patches = patches.permute(0, 1, 4, 2, 3)  # (B, N, C, D, D)

    dx = (x - torch.floor(x))[..., None, None, None]
    dy = (y - torch.floor(y))[..., None, None, None]
    d = 2 * r + 1
    x00 = (1 - dy) * (1 - dx) * patches[..., :d, :d]
    x01 = (1 - dy) * dx * patches[..., :d, 1:]
    x10 = dy * (1 - dx) * patches[..., 1:, :d]
    x11 = dy * dx * patches[..., 1:, 1:]
    return x00 + x01 + x10 + x11


def bilinear_sample_per_frame(
    maps: torch.Tensor,       # (S, H, W, C)
    frame_idx: torch.Tensor,  # (N,) int
    xy: torch.Tensor,         # (N, 2) float pixel coords
) -> torch.Tensor:
    """Per-point bilinear sample where each point picks its own frame.
    Returns (N, C) through a flat-index gather (no per-point map copy)."""
    S, H, W, C = maps.shape
    flat = maps.reshape(S * H * W, C)
    x, y = xy[..., 0], xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    base = frame_idx.long() * (H * W)

    def tap(yy, xx):
        yc = yy.clamp(0, H - 1).long()
        xc = xx.clamp(0, W - 1).long()
        return flat[base + yc * W + xc]

    w00 = ((x0 + 1 - x) * (y0 + 1 - y))[:, None]
    w01 = ((x - x0) * (y0 + 1 - y))[:, None]
    w10 = ((x0 + 1 - x) * (y - y0))[:, None]
    w11 = ((x - x0) * (y - y0))[:, None]
    return (
        w00 * tap(y0, x0) + w01 * tap(y0, x0 + 1)
        + w10 * tap(y0 + 1, x0) + w11 * tap(y0 + 1, x0 + 1)
    )


def _linspace(start: float, stop: float, num: int, device,
              dtype=torch.float32) -> torch.Tensor:
    """jnp.linspace's formula: start + i * step, last point exactly stop."""
    if num == 1:
        return torch.full((1,), start, dtype=dtype, device=device)
    step = (stop - start) / (num - 1)
    out = start + torch.arange(num, dtype=dtype, device=device) * step
    out[-1] = stop
    return out


def interpolate_bilinear(im: torch.Tensor, out_hw: tuple, align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize matching torch F.interpolate(mode='bilinear').

    im: (..., C, H, W) -> (..., C, out_h, out_w). Written with explicit
    gathers on the JAX package's formula so both packages agree exactly.
    Sample coordinates are float32, float64 for a float64 image (as
    jnp.linspace gives under jax_enable_x64).
    """
    H, W = im.shape[-2:]
    out_h, out_w = out_hw
    dev = im.device
    cdt = torch.float64 if im.dtype == torch.float64 else torch.float32
    if align_corners:
        ys = _linspace(0.0, H - 1.0, out_h, dev, cdt)
        xs = _linspace(0.0, W - 1.0, out_w, dev, cdt)
    else:
        ys = (torch.arange(out_h, dtype=cdt, device=dev) + 0.5) * (H / out_h) - 0.5
        xs = (torch.arange(out_w, dtype=cdt, device=dev) + 0.5) * (W / out_w) - 0.5
    y0 = torch.floor(ys).clamp(0, H - 1)
    x0 = torch.floor(xs).clamp(0, W - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    wy = (ys - y0).clamp(0.0, 1.0).to(im.dtype)
    wx = (xs - x0).clamp(0.0, 1.0).to(im.dtype)

    top = im.index_select(-2, y0.long())
    bot = im.index_select(-2, y1.long())
    rows = top * (1 - wy)[:, None] + bot * wy[:, None]
    left = rows.index_select(-1, x0.long())
    right = rows.index_select(-1, x1.long())
    return left * (1 - wx) + right * wx


def avg_pool2d(x: torch.Tensor, k: int, stride: int | None = None) -> torch.Tensor:
    """Average pooling over trailing (H, W), VALID windows."""
    stride = stride or k
    lead = x.shape[:-2]
    y = F.avg_pool2d(x.reshape((-1, 1) + x.shape[-2:]), k, stride)
    return y.reshape(lead + y.shape[-2:])


@functools.lru_cache(maxsize=64)
def linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of jax.image.resize(method="linear")
    along one axis, as jax.image.scale_and_translate computes them: a
    triangle kernel at the half-pixel source position, widened by
    n_in / n_out when downscaling (antialias), weights normalised over the
    taps inside the input, rows of samples outside [-0.5, n_in - 0.5]
    zeroed. Computed in float32 with the same operations."""
    f32 = np.float32
    inv = f32(1.0 / (float(n_out) / n_in))
    kernel_scale = max(inv, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.0) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= f32(n_in - 0.5))
    return np.ascontiguousarray(np.where(inside[None, :], w, f32(0.0)).T.astype(f32))


def resize_linear(x: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    """jax.image.resize(x, ..., method="linear") of an NHWC tensor to
    out_hw. An axis whose size does not change is left as it is."""
    for ax, n_out in zip((1, 2), out_hw):
        n_in = x.shape[ax]
        if n_in == n_out:
            continue
        w = torch.from_numpy(linear_resize_matrix(n_in, n_out)).to(x.device, x.dtype)
        x = torch.movedim(torch.tensordot(w, x, dims=([1], [ax])), 0, ax)
    return x
