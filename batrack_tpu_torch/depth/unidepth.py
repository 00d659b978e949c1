"""UniDepthV2 (metric depth + intrinsics) as torch modules, the counterpart
of batrack_tpu/depth/unidepth.py.

Submodules carry the released checkpoint's names (unidepth-v2-vitl14 /
v2-vits14, after `load_checkpoint` strips `module.` and flattens DINOv2's
block chunks): `pixel_encoder.blocks.{i}...`,
`pixel_decoder.camera_layer.aggregate1.kv`,
`pixel_decoder.depth_layer.ups.{i}.up.{1,3}`,
`pixel_decoder.level_embed_layer.{0,2,3}`, ... `state_dict_from_flax` is
the inverse of batrack_tpu's convert_unidepth_checkpoint.

As in the JAX package:
- every LayerNorm of the decoder has eps 1e-6 (Flax's default; the released
  torch model's nn.LayerNorm default is 1e-5);
- the decoder's six self-attention blocks run exact attention unless
  `use_nystrom=True`, which gives the landmark approximation (count-weighted
  segment means, Newton-Schulz pseudo-inverse);
- resizes follow jax.image.resize (ops/sampling.py::resize_linear) and
  torch's bilinear, as there.

Tensors: tokens (B, N, C), images NHWC as in the JAX package, NCHW only
around convolutions.
"""

from __future__ import annotations

import math
import re
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from batrack_tpu_torch.depth.dpt import (ARCHS, IMAGENET_MEAN, IMAGENET_STD, PATCH, DINOv2,
                                         LayerScale, _conv, _dense, _ln, encoder_from_flax)
from batrack_tpu_torch.ops.sampling import _linspace, interpolate_bilinear, resize_linear

# config_v2_vitl14.json
HIDDEN = 512
NUM_HEADS = 8
EXPANSION = 4
DEC_DEPTHS = (6, 0, 0)
CAMERA_DIM = 96
# 1-indexed encoder tap layers per arch (pixel_encoder.output_idx)
OUT_IDX_BY_ARCH = {"vitl": (21, 22, 23, 24), "vits": (9, 10, 11, 12)}
PIXELS_BOUNDS = (1400, 2400)  # patch-count bounds (shape_constraints)
RATIO_BOUNDS = (0.66, 2.0)
NUM_LANDMARKS = 128
LN_EPS = 1e-6
RAY_DIM = CAMERA_DIM + 3  # fourier features of a unit ray, the ray appended


# ---------------------------------------------------------------------------
# functional pieces
# ---------------------------------------------------------------------------

def generate_rays(K: torch.Tensor, hw: Tuple[int, int]):
    """Unit ray directions (B, H*W, 3) and (theta, phi) angles (B, H*W, 2)
    per pixel centre; K: (B, 3, 3) pinhole."""
    H, W = hw
    ys, xs = torch.meshgrid(torch.arange(H, dtype=K.dtype, device=K.device) + 0.5,
                            torch.arange(W, dtype=K.dtype, device=K.device) + 0.5, indexing="ij")
    x = (xs.reshape(-1)[None] - K[:, 0, 2, None]) / K[:, 0, 0, None]
    y = (ys.reshape(-1)[None] - K[:, 1, 2, None]) / K[:, 1, 1, None]
    rays = torch.stack([x, y, torch.ones_like(x)], -1)
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
    theta = torch.atan2(rays[..., 0], rays[..., 2])
    phi = torch.acos(rays[..., 1].clamp(-1.0, 1.0))
    return rays, torch.stack([theta, phi], -1)


def spherical_zbuffer_to_euclidean(sph: torch.Tensor) -> torch.Tensor:
    """(theta, phi, z) -> (x, y, z)."""
    theta, phi, z = sph[..., 0], sph[..., 1], sph[..., 2]
    return torch.stack([z * torch.tan(theta), z / torch.tan(phi) / torch.cos(theta), z], -1)


def fourier_features(x: torch.Tensor, dim: int, max_freq: int) -> torch.Tensor:
    """Log-spaced sin features with the input appended (use_log=True,
    cat_orig=True)."""
    input_dim = x.shape[-1]
    num_bands = dim // input_dim
    scales = 2.0 ** _linspace(0.0, math.log2(max_freq), num_bands, x.device, x.dtype)
    h = torch.sin(x[..., None] * scales * math.pi).reshape(*x.shape[:-1], input_dim * num_bands)
    return torch.cat([h, x], -1)


def flat_interpolate(x: torch.Tensor, old: Tuple[int, int], new: Tuple[int, int]) -> torch.Tensor:
    """(B, old_h*old_w, C) -> (B, new_h*new_w, C), jax.image.resize linear."""
    if tuple(old) == tuple(new):
        return x
    B, _, C = x.shape
    img = resize_linear(x.reshape(B, old[0], old[1], C), tuple(new))
    return img.reshape(B, new[0] * new[1], C)


def sine_pos_embed(hw: Tuple[int, int], dim: int) -> np.ndarray:
    """DETR sine embedding, normalised: (1, H*W, dim), channels
    [y (dim/2), x (dim/2)]."""
    H, W = hw
    npf = dim // 2
    scale = 2 * math.pi
    y = (np.arange(1, H + 1, dtype=np.float32) / (H + 1e-6) * scale)
    x = (np.arange(1, W + 1, dtype=np.float32) / (W + 1e-6) * scale)
    dim_t = 10000.0 ** (2 * (np.arange(npf, dtype=np.float32) // 2) / npf)
    py = np.broadcast_to(y[:, None, None] / dim_t, (H, W, npf))
    px = np.broadcast_to(x[None, :, None] / dim_t, (H, W, npf))

    def interleave(p):
        return np.stack([np.sin(p[..., 0::2]), np.cos(p[..., 1::2])], -1).reshape(H, W, npf)

    pos = np.concatenate([interleave(py), interleave(px)], -1)
    return pos.reshape(1, H * W, dim)


def _upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """NCHW x2, UpsamplingBilinear2d (align_corners=True)."""
    return interpolate_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2), align_corners=True)


def _iterative_pinv(a: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Newton-Schulz Moore-Penrose pseudo-inverse of a row-stochastic matrix
    (Nystromformer eq. 16)."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    z = a.transpose(-1, -2) / (a.abs().sum(-1).amax(-1)[..., None, None]
                               * a.abs().sum(-2).amax(-1)[..., None, None])
    for _ in range(iters):
        az = a @ z
        z = 0.25 * z @ (13 * eye - az @ (15 * eye - az @ (7 * eye - az)))
    return z


def _nystrom_attention(q, k, v, landmarks: int = NUM_LANDMARKS):
    """Nystrom-approximated softmax attention (q, k, v: (B, h, n, d)) with
    count-weighted segment means as landmarks, so a trailing partial
    segment stays unbiased."""
    B, h, n, d = q.shape
    m = min(landmarks, n)
    if m >= n:
        return torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d), -1) @ v
    seg = -(-n // m)
    pad = seg * m - n
    counts = (n - torch.arange(m, device=q.device) * seg).clamp(1, seg).to(q.dtype)
    q_l = F.pad(q, (0, 0, 0, pad)).reshape(B, h, m, seg, d).sum(-2) / counts[:, None]
    k_l = F.pad(k, (0, 0, 0, pad)).reshape(B, h, m, seg, d).sum(-2) / counts[:, None]
    s = 1.0 / math.sqrt(d)
    k1 = torch.softmax(q @ k_l.transpose(-1, -2) * s, -1)
    k2 = torch.softmax(q_l @ k_l.transpose(-1, -2) * s, -1)
    k3 = torch.softmax(q_l @ k.transpose(-1, -2) * s, -1)
    return k1 @ (_iterative_pinv(k2) @ (k3 @ v))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class UDMLP(nn.Module):
    """layers/mlp.py (gated=False): LayerNorm -> Linear -> GELU -> Linear."""

    def __init__(self, dim: int, expansion: int = 4, output_dim: Optional[int] = None):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.proj1 = nn.Linear(dim, int(dim * expansion))
        self.proj2 = nn.Linear(int(dim * expansion), output_dim or dim)

    def forward(self, x):
        return self.proj2(F.gelu(self.proj1(self.norm(x))))


class UDAttentionBlock(nn.Module):
    """layers/attention.py: cross- or self-attention with LayerScale, then
    an MLP. With `nystrom` the attention is the landmark approximation (the
    decoder's self-attention blocks under use_nystrom)."""

    def __init__(self, dim: int, heads: int, expansion: int = 4, nystrom: bool = False):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.nystrom = nystrom
        self.norm_attnx = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm_attnctx = nn.LayerNorm(dim, eps=LN_EPS)
        self.kv = nn.Linear(dim, 2 * dim)
        self.q = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)
        self.ls1 = LayerScale(dim)
        self.mlp = UDMLP(dim, expansion)
        self.ls2 = LayerScale(dim)

    def _heads(self, t):
        B, N, _ = t.shape
        return t.reshape(B, N, self.heads, self.dim // self.heads).transpose(1, 2)

    def forward(self, x, context=None, pos_embed=None, pos_embed_context=None):
        ctx = x if context is None else context
        kv = self.kv(self.norm_attnctx(ctx))
        # torch layout "(kv h d)": k occupies channels [0, dim)
        k, v = self._heads(kv[..., :self.dim]), self._heads(kv[..., self.dim:])
        q = self._heads(self.q(self.norm_attnx(x)))
        if pos_embed is not None:
            q = q + self._heads(pos_embed)
        if pos_embed_context is not None:
            k = k + self._heads(pos_embed_context)
        if self.nystrom:
            o = _nystrom_attention(q, k, v)
        else:
            o = F.scaled_dot_product_attention(q, k, v)
        x = x + self.ls1(self.out(o.transpose(1, 2).reshape(x.shape[0], -1, self.dim)))
        return x + self.ls2(self.mlp(x))


class CvnxtBlock(nn.Module):
    """layers/convnext.py (kernel 7, layer_scale=1.0), NHWC in and out."""

    def __init__(self, dim: int, kernel: int = 7, expansion: int = 4):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, kernel, padding=kernel // 2, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.pwconv1 = nn.Linear(dim, expansion * dim)
        self.pwconv2 = nn.Linear(expansion * dim, dim)
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        h = self.dwconv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        h = self.pwconv2(F.gelu(self.pwconv1(self.norm(h))))
        return x + h * self.gamma


class ConvUpsampleShuffleResidual(nn.Module):
    """layers/upsample.py: 2 ConvNeXt blocks -> (PixelShuffle -> depthwise
    7x7 -> ReLU -> 3x3) + (1x1 -> bilinear x2) residual. (B, H, W, C) ->
    (B, 4HW, C/2)."""

    def __init__(self, dim: int, expansion: int = 4, kernel: int = 7, num_layers: int = 2):
        super().__init__()
        self.convs = nn.ModuleList(CvnxtBlock(dim, kernel, expansion) for _ in range(num_layers))
        self.up = nn.Sequential(nn.PixelShuffle(2),
                                nn.Conv2d(dim // 4, dim // 4, 7, padding=3, groups=dim // 4),
                                nn.ReLU(), nn.Conv2d(dim // 4, dim // 2, 3, padding=1))
        self.residual = nn.Sequential(nn.Conv2d(dim, dim // 2, 1))

    def forward(self, x):
        for conv in self.convs:
            x = conv(x)
        x = x.permute(0, 3, 1, 2)
        out = self.up(x) + _upsample2x_align_corners(self.residual(x))
        return out.flatten(2).transpose(1, 2)


class ListAdapter(nn.Module):
    """decoder.py:13-29: per-input LayerNorm -> Linear -> GELU."""

    def __init__(self, input_dims: Sequence[int], hidden_dim: int):
        super().__init__()
        self.input_adapters = nn.ModuleList(
            nn.Sequential(nn.LayerNorm(d, eps=LN_EPS), nn.Linear(d, hidden_dim), nn.GELU())
            for d in input_dims)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        return [a(x) for a, x in zip(self.input_adapters, xs)]


# ---------------------------------------------------------------------------
# decoder heads
# ---------------------------------------------------------------------------

class CameraHead(nn.Module):
    """decoder.py:32-88: two 1-head cross-attention aggregations of 4 latents
    over the features -> (fx, fy, cx, cy) activations -> K."""

    def __init__(self):
        super().__init__()
        self.project_cls = UDMLP(HIDDEN, 4)
        self.in_features = UDMLP(HIDDEN, 2)
        self.out = UDMLP(HIDDEN, 2, output_dim=1)
        self.aggregate1 = UDAttentionBlock(HIDDEN, 1, EXPANSION)
        self.aggregate2 = UDAttentionBlock(HIDDEN, 1, EXPANSION)
        self.latents_pos = nn.Parameter(torch.randn(1, 4, HIDDEN))

    def forward(self, features, cls_tokens, pos_embed):
        B = cls_tokens.shape[0]
        cls_tokens = self.project_cls(cls_tokens)
        latents_pos = self.latents_pos.expand(B, -1, -1)
        feats = torch.cat([self.in_features(torch.cat(features, 1) + pos_embed), cls_tokens], 1)
        x = self.aggregate1(cls_tokens, context=feats, pos_embed=latents_pos)
        x = self.aggregate2(x, context=feats, pos_embed=latents_pos)
        x = self.out(x)[..., 0]
        K = torch.zeros((B, 3, 3), dtype=x.dtype, device=x.device)
        K[:, 0, 0], K[:, 1, 1] = torch.exp(x[:, 0]), torch.exp(x[:, 1])
        K[:, 0, 2], K[:, 1, 2] = torch.sigmoid(x[:, 2]), torch.sigmoid(x[:, 3])
        K[:, 2, 2] = 1.0
        return K


def _embed_rays(rays, original, shapes):
    """Ray fourier embedding at a feature resolution (decoder.py:112-123)."""
    r = flat_interpolate(rays, original, shapes)
    r = r / torch.linalg.norm(r, dim=-1, keepdim=True)
    return fourier_features(r, CAMERA_DIM, max(shapes) // 2)


class GlobalHead(nn.Module):
    """decoder.py:91-148: scale and shift from 2 cls tokens and the
    ray-conditioned features."""

    def __init__(self):
        super().__init__()
        self.project_cls = UDMLP(HIDDEN, 4)
        self.project_rays = nn.Linear(RAY_DIM, HIDDEN)
        self.in_features = nn.Linear(HIDDEN, HIDDEN)
        self.out = UDMLP(HIDDEN, 2, output_dim=1)
        self.aggregate1 = UDAttentionBlock(HIDDEN, 1, EXPANSION)
        self.aggregate2 = UDAttentionBlock(HIDDEN, 1, EXPANSION)

    def forward(self, features, cls_tokens, rays, original, shapes):
        cls_tokens = self.project_cls(cls_tokens)
        re_ = self.project_rays(_embed_rays(rays, original, shapes)).repeat(1, len(features), 1)
        feats = torch.cat([self.in_features(torch.cat(features, 1) + re_), cls_tokens], 1)
        x = self.aggregate1(cls_tokens, context=feats)
        x = self.aggregate2(x, context=feats)
        x = self.out(x)[..., 0]
        return torch.exp(x[:, 0]).reshape(-1, 1, 1, 1), x[:, 1].reshape(-1, 1, 1, 1)


class DepthHead(nn.Module):
    """decoder.py:151-345: latents from the features, camera prompting, 3
    upsampling levels with ray-conditioned processing, and multi-scale
    depth and confidence MLPs fused by 7x7 reflect-padded convolutions."""

    def __init__(self, nres: int = 4, use_nystrom: bool = False):
        super().__init__()
        nlev = len(DEC_DEPTHS)
        self.rays_layers = nn.ModuleList(nn.Linear(RAY_DIM, HIDDEN // 2 ** i) for i in range(nlev))
        self.features_channel_cat = nn.Linear(nres * HIDDEN, HIDDEN)
        self.to_latents = UDMLP(HIDDEN, 2)
        self.aggregate_16 = UDAttentionBlock(HIDDEN, 1, EXPANSION)
        self.prompt_camera = UDAttentionBlock(HIDDEN, 1, EXPANSION)
        self.process_layers = nn.ModuleList(
            nn.ModuleList(UDAttentionBlock(HIDDEN // 2 ** i, NUM_HEADS // 2 ** i, EXPANSION,
                                           nystrom=use_nystrom)
                          for _ in range(depth))
            for i, depth in enumerate(DEC_DEPTHS))
        self.ups = nn.ModuleList(ConvUpsampleShuffleResidual(HIDDEN // 2 ** i, EXPANSION)
                                 for i in range(nlev))
        self.depth_mlp = nn.ModuleList(UDMLP(HIDDEN // 2 ** (i + 1), 1, output_dim=16)
                                       for i in range(nlev))
        self.confidence_mlp = nn.ModuleList(UDMLP(HIDDEN // 2 ** (i + 1), 1, output_dim=16)
                                            for i in range(nlev))
        self.to_depth = nn.Conv2d(16 * nlev, 1, 7)
        self.to_confidence = nn.Conv2d(16 * nlev, 1, 7)

    def forward(self, features, rays_hr, pos_embed, level_embed, original, shapes):
        B = features[0].shape[0]
        nlev = len(DEC_DEPTHS)
        rays_embeddings = [
            layer(_embed_rays(rays_hr, original, (shapes[0] * 2 ** i, shapes[1] * 2 ** i)))
            for i, layer in enumerate(self.rays_layers)]
        feats_cat = self.features_channel_cat(torch.cat(features, -1))
        latents = feats_cat + self.to_latents(feats_cat)
        latents = self.aggregate_16(latents, context=torch.cat(features, 1),
                                    pos_embed_context=pos_embed + level_embed)
        latents = self.prompt_camera(latents, context=rays_embeddings[0])

        out_features = []
        for i in range(nlev):
            dim = HIDDEN // 2 ** i
            for block in self.process_layers[i]:
                latents = block(latents, pos_embed=rays_embeddings[i])
            h, w = shapes[0] * 2 ** i, shapes[1] * 2 ** i
            latents = self.ups[i]((latents + rays_embeddings[i]).reshape(B, h, w, dim))
            out_features.append(latents.reshape(B, 2 * h, 2 * w, dim // 2))

        def fuse(mlps, conv):
            maps = [interpolate_bilinear(mlps[i](out_features[i]).permute(0, 3, 1, 2),
                                         tuple(original), align_corners=False)
                    for i in reversed(range(nlev))]
            return conv(F.pad(torch.cat(maps, 1), (3, 3, 3, 3), mode="reflect"))[:, 0]

        logdepth = fuse(self.depth_mlp, self.to_depth)
        confidence = torch.sigmoid(fuse(self.confidence_mlp, self.to_confidence))
        return logdepth, confidence, latents


class Decoder(nn.Module):
    """decoder.py:347-585 for the ViT (single-resolution) encoder: camera ->
    rays -> global scale/shift -> depth."""

    def __init__(self, enc_dim: int, nres: int = 4, use_nystrom: bool = False):
        super().__init__()
        self.input_adapter = ListAdapter((enc_dim,) * nres, HIDDEN)
        self.camera_token_adapter = ListAdapter((enc_dim,) * 4, HIDDEN)
        self.global_token_adapter = ListAdapter((enc_dim,) * 2, HIDDEN)
        self.level_embeds = nn.Parameter(torch.randn(nres, HIDDEN))
        self.level_embed_layer = nn.Sequential(nn.Linear(HIDDEN, HIDDEN), nn.GELU(),
                                               nn.Linear(HIDDEN, HIDDEN),
                                               nn.LayerNorm(HIDDEN, eps=LN_EPS))
        self.camera_layer = CameraHead()
        self.global_layer = GlobalHead()
        self.depth_layer = DepthHead(nres, use_nystrom)

    def forward(self, features, camera_cls, global_cls, image_hw, shapes, rays_gt=None):
        B = features[0].shape[0]
        H, W = image_hw
        nres = len(features)
        features = self.input_adapter(features)
        le = self.level_embed_layer(self.level_embeds)
        hw = shapes[0] * shapes[1]
        level_embed = torch.cat([le[i].expand(B, hw, HIDDEN) for i in range(nres)], 1)
        pos_embed = torch.from_numpy(sine_pos_embed(shapes, HIDDEN)).to(
            le.device, le.dtype).repeat(1, nres, 1)

        cam_cls = self.camera_token_adapter(camera_cls)
        K = self.camera_layer(features, torch.cat(cam_cls, 1), pos_embed + level_embed)
        s = max(H, W) / 2
        K = K * torch.tensor([[s, 1, W], [1, s, H], [1, 1, 1]], dtype=K.dtype, device=K.device)
        rays = rays_gt if rays_gt is not None else generate_rays(K, (H, W))[0]

        glob_cls = self.global_token_adapter(global_cls)
        scale, shift = self.global_layer(features, torch.cat(glob_cls, 1), rays, (H, W), shapes)
        logdepth, confidence, depth_features = self.depth_layer(
            features, rays, pos_embed, level_embed, (H, W), shapes)

        # norm in log space, then scale-invariant shift (decoder.py:506-515)
        mu = logdepth.mean((-2, -1), keepdim=True)
        var = ((logdepth - mu) ** 2).mean((-2, -1), keepdim=True)
        depth = torch.exp((logdepth - mu) * torch.rsqrt(var + 1e-5))
        depth = (depth[:, None] + shift) * scale
        depth = F.softplus(depth * 10.0) / 10.0
        return {"depth": depth[:, 0], "confidence": confidence, "K": K,
                "depth_features": depth_features, "rays": rays}


class UniDepthV2(nn.Module):
    """DINOv2/14 encoder + decoder. Takes an ImageNet-normalised (B, H, W, 3)
    image with sides multiples of 14 (`infer` does the shape-constrained
    resize) and optional rays; returns depth, K and confidence at the
    network resolution."""

    def __init__(self, arch: str = "vitl", use_nystrom: bool = False):
        super().__init__()
        self.arch = arch
        self.pixel_encoder = DINOv2(arch, interpolate_offset=0.0)
        self.pixel_decoder = Decoder(ARCHS[arch][0], len(OUT_IDX_BY_ARCH[arch]), use_nystrom)

    def forward(self, x: torch.Tensor, rays_gt: Optional[torch.Tensor] = None):
        B, H, W, _ = x.shape
        shapes = (H // PATCH, W // PATCH)
        outs = self.pixel_encoder(x, [i - 1 for i in OUT_IDX_BY_ARCH[self.arch]])
        features = [t for t, _ in outs]
        cls = [c[:, None] for _, c in outs]
        # camera tokens are the cls of taps 2, 3, 4, 3 and the global head's
        # those of taps 3 and 4 (unidepthv2.py:245-247)
        camera_cls = [cls[1], cls[2], cls[3], cls[2]]
        global_cls = [cls[2], cls[3]]
        return self.pixel_decoder(features, camera_cls, global_cls, (H, W), shapes, rays_gt)


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------

def _infer_shape(hw: Tuple[int, int], resolution_level: Optional[int] = None,
                 pixels_bounds: Tuple[int, int] = PIXELS_BOUNDS):
    """Shape-constrained network resolution (unidepthv2.py:56-93): the patch
    count is set to the level's bound whatever the input size."""
    H, W = hw
    lo, hi = pixels_bounds
    level = 10 if resolution_level is None else min(max(resolution_level, 0), 10)
    bound = lo + math.ceil((hi - lo) * level / 10)
    ratio = W / H
    if not (RATIO_BOUNDS[0] <= ratio <= RATIO_BOUNDS[1]):
        warnings.warn(f"input aspect ratio {ratio:.3f} is outside the training distribution "
                      f"{RATIO_BOUNDS}; metric depth/intrinsics may degrade")
    n = min(max((H / PATCH) * (W / PATCH), bound), bound)
    h = math.ceil(math.sqrt(n / ratio) - 0.5)
    w = math.ceil(h * ratio - 0.5)
    return (h * PATCH, w * PATCH), h * PATCH / H


@torch.no_grad()
def infer(model: UniDepthV2, image: np.ndarray, intrinsics: Optional[np.ndarray] = None,
          resolution_level: Optional[int] = None,
          pixels_bounds: Tuple[int, int] = PIXELS_BOUNDS,
          outputs: Tuple[str, ...] = ("depth", "intrinsics", "confidence", "points")):
    """uint8 RGB (H, W, 3) -> {depth (H, W), intrinsics (3, 3), confidence
    (H, W), points (H, W, 3)} at the original resolution, as numpy arrays.
    `outputs` selects what to compute (depth and intrinsics always). A
    caller's intrinsics come back exactly as given. The network runs on the
    model's device in float32 with TF32 allowed."""
    from batrack_tpu_torch.utils.config import allow_tf32

    dev = next(model.parameters()).device
    H, W = image.shape[:2]
    (h, w), ratio = _infer_shape((H, W), resolution_level, pixels_bounds)
    x = (image.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    img = resize_linear(torch.from_numpy(x[None]).to(dev), (h, w))

    rays = K_exact = None
    if intrinsics is not None:
        K_np = np.asarray(intrinsics, np.float32)[None]
        K_exact = torch.from_numpy(K_np).to(dev)
        K_in = K_np.copy()
        K_in[:, :2] *= ratio
        rays = generate_rays(torch.from_numpy(K_in).to(dev), (h, w))[0]
    with allow_tf32():
        out = model(img, rays)
    depth = interpolate_bilinear(out["depth"][:, None], (H, W), align_corners=False)[:, 0]
    K = out["K"] / torch.tensor([[ratio, 1, ratio], [1, ratio, ratio], [1, 1, 1]],
                                dtype=torch.float32, device=dev)
    K_out = K_exact if K_exact is not None else K
    res = {"depth": depth, "intrinsics": K_out}
    wanted = set(outputs)
    if "confidence" in wanted:
        res["confidence"] = interpolate_bilinear(out["confidence"][:, None], (H, W),
                                                 align_corners=False)[:, 0]
    if "points" in wanted:
        angles = generate_rays(K_out, (H, W))[1].reshape(1, H, W, 2)
        res["points"] = spherical_zbuffer_to_euclidean(torch.cat([angles, depth[..., None]], -1))
    res = {k: v[0].cpu().numpy() for k, v in res.items()}
    if intrinsics is not None:
        res["intrinsics"] = np.asarray(intrinsics)
    return res


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def released_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A released UniDepthV2 state dict in this module's names: `module.`
    stripped, DINOv2's chunked blocks (`pixel_encoder.blocks.<chunk>.<i>.`)
    flattened to `pixel_encoder.blocks.<i>.`."""
    out = {}
    for k, v in sd.items():
        k = k.replace("module.", "")
        out[re.sub(r"(pixel_encoder\.blocks)\.\d+\.(\d+\.)", r"\1.\2", k)] = v
    return out


def load_checkpoint(path, arch: str = "vitl") -> UniDepthV2:
    """A UniDepthV2 with the weights of a released checkpoint (.pth or .bin
    through torch.load, .safetensors through utils/tensorfile.py), loaded
    strictly onto a module made on the meta device, on the CPU."""
    path = str(path)
    if path.endswith(".safetensors"):
        from batrack_tpu_torch.utils.tensorfile import read_safetensors

        sd = read_safetensors(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "model" in sd:
            sd = sd["model"]
    with torch.device("meta"):
        model = UniDepthV2(arch)
    model.load_state_dict(released_state_dict(sd), strict=True, assign=True)
    return model


def _mlp(p, key, out):
    _ln(p["norm"], f"{key}.norm", out)
    _dense(p["proj1"], f"{key}.proj1", out)
    _dense(p["proj2"], f"{key}.proj2", out)


def _attn(p, key, out):
    _ln(p["norm_attnx"], f"{key}.norm_attnx", out)
    _ln(p["norm_attnctx"], f"{key}.norm_attnctx", out)
    _dense(p["kv"], f"{key}.kv", out)
    _dense(p["q"], f"{key}.q", out)
    _dense(p["out"], f"{key}.out", out)
    _mlp(p["mlp"], f"{key}.mlp", out)
    out[f"{key}.ls1.gamma"] = np.asarray(p["ls1_gamma"])
    out[f"{key}.ls2.gamma"] = np.asarray(p["ls2_gamma"])


def _adapter(p, key, n, out):
    for i in range(n):
        _ln(p[f"norm{i}"], f"{key}.input_adapters.{i}.0", out)
        _dense(p[f"proj{i}"], f"{key}.input_adapters.{i}.1", out)


def _cvnxt(p, key, out):
    _conv(p["dwconv"], f"{key}.dwconv", out)
    _ln(p["norm"], f"{key}.norm", out)
    _dense(p["pwconv1"], f"{key}.pwconv1", out)
    _dense(p["pwconv2"], f"{key}.pwconv2", out)
    out[f"{key}.gamma"] = np.asarray(p["gamma"])


def state_dict_from_flax(params, arch: str = "vitl",
                         unused: Dict[str, np.ndarray] = None) -> Dict[str, np.ndarray]:
    """Flax UniDepthV2 params (numpy leaves, the layout
    convert_unidepth_checkpoint produces) -> this module's state dict as
    numpy arrays. `unused` supplies the encoder's mask_token (zeros
    otherwise), which the Flax tree lacks."""
    p = params.get("params", params)
    out: Dict[str, np.ndarray] = {}
    encoder_from_flax(p["pixel_encoder"], "pixel_encoder", ARCHS[arch][1], out)
    dp, d = p["pixel_decoder"], "pixel_decoder"
    _adapter(dp["input_adapter"], f"{d}.input_adapter", len(OUT_IDX_BY_ARCH[arch]), out)
    _adapter(dp["camera_token_adapter"], f"{d}.camera_token_adapter", 4, out)
    _adapter(dp["global_token_adapter"], f"{d}.global_token_adapter", 2, out)
    out[f"{d}.level_embeds"] = np.asarray(dp["level_embeds"])
    _dense(dp["level_embed_0"], f"{d}.level_embed_layer.0", out)
    _dense(dp["level_embed_2"], f"{d}.level_embed_layer.2", out)
    _ln(dp["level_embed_3"], f"{d}.level_embed_layer.3", out)

    cam, c = dp["camera_layer"], f"{d}.camera_layer"
    for name in ("project_cls", "in_features", "out"):
        _mlp(cam[name], f"{c}.{name}", out)
    for name in ("aggregate1", "aggregate2"):
        _attn(cam[name], f"{c}.{name}", out)
    out[f"{c}.latents_pos"] = np.asarray(cam["latents_pos"])

    glob, g = dp["global_layer"], f"{d}.global_layer"
    _mlp(glob["project_cls"], f"{g}.project_cls", out)
    _mlp(glob["out"], f"{g}.out", out)
    _dense(glob["in_features"], f"{g}.in_features", out)
    _dense(glob["project_rays"], f"{g}.project_rays", out)
    for name in ("aggregate1", "aggregate2"):
        _attn(glob[name], f"{g}.{name}", out)

    dh, h = dp["depth_layer"], f"{d}.depth_layer"
    _mlp(dh["to_latents"], f"{h}.to_latents", out)
    _dense(dh["features_channel_cat"], f"{h}.features_channel_cat", out)
    _attn(dh["aggregate_16"], f"{h}.aggregate_16", out)
    _attn(dh["prompt_camera"], f"{h}.prompt_camera", out)
    for i in range(len(DEC_DEPTHS)):
        _dense(dh[f"rays_layer{i}"], f"{h}.rays_layers.{i}", out)
        up, u = dh[f"up{i}"], f"{h}.ups.{i}"
        _cvnxt(up["conv0"], f"{u}.convs.0", out)
        _cvnxt(up["conv1"], f"{u}.convs.1", out)
        _conv(up["up_dw"], f"{u}.up.1", out)
        _conv(up["up_pw"], f"{u}.up.3", out)
        _conv(up["residual"], f"{u}.residual.0", out)
        _mlp(dh[f"depth_mlp{i}"], f"{h}.depth_mlp.{i}", out)
        _mlp(dh[f"confidence_mlp{i}"], f"{h}.confidence_mlp.{i}", out)
        for j in range(DEC_DEPTHS[i]):
            _attn(dh[f"process_{i}_{j}"], f"{h}.process_layers.{i}.{j}", out)
    _conv(dh["to_depth"], f"{h}.to_depth", out)
    _conv(dh["to_confidence"], f"{h}.to_confidence", out)
    if unused:
        out.update({k: np.asarray(v) for k, v in unused.items()})
    return out
