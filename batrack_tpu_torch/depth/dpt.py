"""DepthAnythingV2 (DINOv2 ViT encoder + DPT head) as torch modules, the
counterpart of batrack_tpu/depth/dpt.py.

The submodules carry the names of the released checkpoint
(depth_anything_v2_vit{s,b,l}.pth), so `load_state_dict(strict=True)` takes
that file as it is: `pretrained.blocks.{i}.attn.qkv`,
`pretrained.blocks.{i}.ls1.gamma`, `depth_head.projects.{i}`,
`depth_head.resize_layers.{0,1,3}`,
`depth_head.scratch.refinenet{i}.resConfUnit{1,2}`,
`depth_head.scratch.output_conv2.{0,2}`, ... `refinenet4.resConfUnit1` is
in the checkpoint but never runs (refinenet4 has no skip input), and
DINOv2's `mask_token` is carried and unused at inference.
`state_dict_from_flax` carries the JAX package's Flax parameters the other
way (the inverse of batrack_tpu's convert_da2_checkpoint).

Modules compute in the layouts torch uses (tokens (B, N, C), feature maps
NCHW); the network takes an NHWC image, as the JAX package's does.
Attention runs through F.scaled_dot_product_attention: the JAX package
computes it as plain softmax(QK^T)V, outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from batrack_tpu_torch.depth.cvresize import resize_cubic_u8
from batrack_tpu_torch.ops.sampling import interpolate_bilinear
from batrack_tpu_torch.utils.config import full_fp32

ARCHS = {
    # name: (embed_dim, depth, heads, intermediate layer ids)
    "vits": (384, 12, 6, [2, 5, 8, 11]),
    "vitb": (768, 12, 12, [2, 5, 8, 11]),
    "vitl": (1024, 24, 16, [4, 11, 17, 23]),
}
# per-arch DPT head widths (run_videos_v2.py model_configs)
HEADS = {
    "vits": dict(features=64, out_channels=(48, 96, 192, 384)),
    "vitb": dict(features=128, out_channels=(96, 192, 384, 768)),
    "vitl": dict(features=256, out_channels=(256, 512, 1024, 1024)),
}
PATCH = 14
PRETRAIN_SIDE = 37  # 518 / 14 patches per side at pretraining
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
LN_EPS = 1e-6


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        q, k, v = self.qkv(x).reshape(B, N, 3, self.heads, C // self.heads).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v)
        return self.proj(o.transpose(1, 2).reshape(B, N, C))


class Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    """Pre-norm block with LayerScale (dinov2_layers/block.py)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, PATCH, PATCH)


class DINOv2(nn.Module):
    """ViT trunk with bicubic pos-embed interpolation (dinov2.py:178-211).

    interpolate_offset: DepthAnythingV2's DINOv2 resizes the pos-embed grid
    in scale-factor mode with the historical +0.1 (scale (ph + 0.1) / 37);
    UniDepth's uses 0.0, plain size mode."""

    def __init__(self, arch: str = "vitl", interpolate_offset: float = 0.1):
        super().__init__()
        dim, depth, heads, _ = ARCHS[arch]
        self.arch, self.dim, self.interpolate_offset = arch, dim, interpolate_offset
        self.patch_embed = PatchEmbed(dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, PRETRAIN_SIDE ** 2 + 1, dim))
        self.mask_token = nn.Parameter(torch.zeros(1, dim))
        self.blocks = nn.ModuleList(ViTBlock(dim, heads) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        nn.init.trunc_normal_(self.pos_embed, std=0.02)
        nn.init.normal_(self.cls_token, std=1e-6)
        self._pos_cache = None

    def interpolate_pos_embed(self, ph: int, pw: int) -> torch.Tensor:
        """(1, 1 + ph*pw, C): torch's bicubic (A = -0.75, no antialias) on
        the 37x37 grid, in full float32. Without autograd the result is kept
        for the next call at the same grid, until pos_embed moves or
        changes: the CUDA bicubic kernel takes several ms at ViT-L width."""
        pos = self.pos_embed
        side = PRETRAIN_SIDE
        if (ph, pw) == (side, side):
            return pos
        key = (ph, pw, pos.device, pos.data_ptr(), pos._version)
        if self._pos_cache is not None and self._pos_cache[0] == key \
                and not torch.is_grad_enabled():
            return self._pos_cache[1]
        grid = pos[:, 1:].reshape(1, side, side, self.dim).permute(0, 3, 1, 2)
        with full_fp32():
            if self.interpolate_offset:
                off = self.interpolate_offset
                grid = F.interpolate(grid, scale_factor=((ph + off) / side, (pw + off) / side),
                                     mode="bicubic", align_corners=False)
            else:
                grid = F.interpolate(grid, size=(ph, pw), mode="bicubic", align_corners=False)
        if grid.shape[-2:] != (ph, pw):
            raise ValueError(f"pos-embed resized to {tuple(grid.shape[-2:])}, not {(ph, pw)}")
        out = torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, ph * pw, self.dim)], 1)
        if not torch.is_grad_enabled():
            self._pos_cache = (key, out)
        return out

    def forward(self, x: torch.Tensor, take: Sequence[int]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """x: (B, H, W, 3) normalised. Returns [(tokens (B, N, C), cls (B, C))]
        at the blocks in `take`, final norm applied."""
        B, H, W, _ = x.shape
        ph, pw = H // PATCH, W // PATCH
        tok = self.patch_embed.proj(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        xt = torch.cat([self.cls_token.expand(B, -1, -1), tok], 1) + self.interpolate_pos_embed(ph, pw)
        take = set(int(i) for i in take)
        outs = []
        for i, blk in enumerate(self.blocks):
            xt = blk(xt)
            if i in take:
                outs.append(self.norm(xt))
        return [(o[:, 1:], o[:, 0]) for o in outs]


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    """util/blocks.py:83-130 (align_corners=True upsampling)."""

    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None, out_hw=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        if out_hw is None:
            out_hw = (x.shape[-2] * 2, x.shape[-1] * 2)
        return self.out_conv(interpolate_bilinear(x, tuple(out_hw), align_corners=True))


class _Scratch(nn.Module):
    def __init__(self, features: int, out_channels: Sequence[int]):
        super().__init__()
        for i, c in enumerate(out_channels):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(c, features, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(features))
        self.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(),
                                          nn.Conv2d(32, 1, 1), nn.ReLU())


class DPTHead(nn.Module):
    """dpt.py:38-151 (use_clstoken=False, the DA2 configuration)."""

    def __init__(self, in_channels: int, features: int, out_channels: Sequence[int]):
        super().__init__()
        oc = tuple(out_channels)
        self.projects = nn.ModuleList(nn.Conv2d(in_channels, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1),
        ])
        self.scratch = _Scratch(features, oc)

    def forward(self, feats: List[Tuple[torch.Tensor, torch.Tensor]], ph: int, pw: int):
        outs = []
        for i, (tok, _cls) in enumerate(feats):
            x = tok.transpose(1, 2).reshape(tok.shape[0], tok.shape[2], ph, pw)
            outs.append(self.resize_layers[i](self.projects[i](x)))
        s = self.scratch
        rn = [getattr(s, f"layer{i + 1}_rn")(outs[i]) for i in range(4)]
        p4 = s.refinenet4(rn[3], out_hw=rn[2].shape[-2:])
        p3 = s.refinenet3(p4, rn[2], out_hw=rn[1].shape[-2:])
        p2 = s.refinenet2(p3, rn[1], out_hw=rn[0].shape[-2:])
        p1 = s.refinenet1(p2, rn[0])
        x = s.output_conv1(p1)
        x = interpolate_bilinear(x, (ph * PATCH, pw * PATCH), align_corners=True)
        return s.output_conv2(x)[:, 0]


class DepthAnythingV2(nn.Module):
    """Relative-disparity network (dpt.py:153-220). Takes (B, H, W, 3)
    ImageNet-normalised images with H and W multiples of 14; returns
    relative disparity (B, H, W)."""

    def __init__(self, arch: str = "vitl"):
        super().__init__()
        self.arch = arch
        self.pretrained = DINOv2(arch, interpolate_offset=0.1)
        self.depth_head = DPTHead(ARCHS[arch][0], **HEADS[arch])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph, pw = x.shape[1] // PATCH, x.shape[2] // PATCH
        return self.depth_head(self.pretrained(x, ARCHS[self.arch][3]), ph, pw)


# ---------------------------------------------------------------------------
# preprocessing and inference
# ---------------------------------------------------------------------------

def preprocess_shape(hw: Tuple[int, int], input_size: int = 518) -> Tuple[int, int]:
    """Network input size: the shorter side to input_size, both sides
    rounded to multiples of 14 and at least input_size (dpt.py:189-205)."""
    h, w = hw
    scale = input_size / min(h, w)
    nh = int(np.round(h * scale / 14) * 14)
    nw = int(np.round(w * scale / 14) * 14)
    return max(nh, input_size), max(nw, input_size)


def preprocess(image: np.ndarray, input_size: int = 518) -> np.ndarray:
    """uint8 RGB (H, W, 3) -> normalised (1, H', W', 3): the resize of
    preprocess_shape by OpenCV's uint8 bicubic (depth/cvresize.py), then
    ImageNet normalisation."""
    img = resize_cubic_u8(image, preprocess_shape(image.shape[:2], input_size))
    img = (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    return img[None]


@torch.no_grad()
def infer_depth(model: DepthAnythingV2, image: np.ndarray, input_size: int = 518) -> np.ndarray:
    """Full-resolution relative disparity (H, W) of a uint8 RGB image, on
    the model's device. The network runs in float32 with TF32 allowed for
    matmuls and convolutions."""
    from batrack_tpu_torch.utils.config import allow_tf32

    dev = next(model.parameters()).device
    x = torch.from_numpy(preprocess(image, input_size)).to(dev)
    with allow_tf32():
        disp = model(x)
    h, w = image.shape[:2]
    return interpolate_bilinear(disp, (h, w), align_corners=True)[0].cpu().numpy()


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def load_checkpoint(path, arch: str = "vitl") -> DepthAnythingV2:
    """A DepthAnythingV2 with the weights of a released .pth (strict), on
    the CPU. The module is made on the meta device and takes the file's
    tensors as its parameters: no random init of 300 M weights first."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    with torch.device("meta"):
        model = DepthAnythingV2(arch)
    model.load_state_dict(sd, strict=True, assign=True)
    return model


def _conv(p, key, out, bias=True):
    out[f"{key}.weight"] = np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))
    if bias:
        out[f"{key}.bias"] = np.asarray(p["bias"])


def _convT(p, key, out):
    # inverse of convert_da2_checkpoint's _convT: (kh, kw, in, out) ->
    # (in, out, kh, kw), spatially flipped back
    w = np.transpose(np.asarray(p["kernel"]), (2, 3, 0, 1))
    out[f"{key}.weight"] = np.ascontiguousarray(np.flip(w, axis=(2, 3)))
    out[f"{key}.bias"] = np.asarray(p["bias"])


def _dense(p, key, out):
    out[f"{key}.weight"] = np.transpose(np.asarray(p["kernel"]), (1, 0))
    out[f"{key}.bias"] = np.asarray(p["bias"])


def _ln(p, key, out):
    out[f"{key}.weight"] = np.asarray(p["scale"])
    out[f"{key}.bias"] = np.asarray(p["bias"])


def encoder_from_flax(p, prefix: str, depth: int, out: Dict[str, np.ndarray]) -> None:
    """DINOv2 Flax params -> state-dict entries under `prefix` (mask_token,
    which Flax does not carry, as zeros)."""
    _conv(p["patch_embed"], f"{prefix}.patch_embed.proj", out)
    out[f"{prefix}.cls_token"] = np.asarray(p["cls_token"])
    out[f"{prefix}.pos_embed"] = np.asarray(p["pos_embed"])
    out[f"{prefix}.mask_token"] = np.zeros((1, out[f"{prefix}.cls_token"].shape[-1]), np.float32)
    _ln(p["norm"], f"{prefix}.norm", out)
    for i in range(depth):
        b, q = p[f"block{i}"], f"{prefix}.blocks.{i}"
        _ln(b["norm1"], f"{q}.norm1", out)
        _ln(b["norm2"], f"{q}.norm2", out)
        _dense(b["qkv"], f"{q}.attn.qkv", out)
        _dense(b["proj"], f"{q}.attn.proj", out)
        _dense(b["fc1"], f"{q}.mlp.fc1", out)
        _dense(b["fc2"], f"{q}.mlp.fc2", out)
        out[f"{q}.ls1.gamma"] = np.asarray(b["ls1_gamma"])
        out[f"{q}.ls2.gamma"] = np.asarray(b["ls2_gamma"])


def state_dict_from_flax(params, arch: str = "vitl",
                         unused: Dict[str, np.ndarray] = None) -> Dict[str, np.ndarray]:
    """Flax DepthAnythingV2 params (numpy leaves, the layout
    convert_da2_checkpoint produces) -> this module's state dict as numpy
    arrays. `unused` supplies refinenet4.resConfUnit1, which the Flax tree
    lacks (zeros otherwise), and mask_token."""
    p = params.get("params", params)
    out: Dict[str, np.ndarray] = {}
    encoder_from_flax(p["pretrained"], "pretrained", ARCHS[arch][1], out)
    h = p["depth_head"]
    for i in range(4):
        _conv(h[f"project{i}"], f"depth_head.projects.{i}", out)
    _convT(h["resize0"], "depth_head.resize_layers.0", out)
    _convT(h["resize1"], "depth_head.resize_layers.1", out)
    _conv(h["resize3"], "depth_head.resize_layers.3", out)
    sc = "depth_head.scratch"
    for i in range(4):
        _conv(h[f"layer{i + 1}_rn"], f"{sc}.layer{i + 1}_rn", out, bias=False)
    for i in range(1, 5):
        r = h[f"refinenet{i}"]
        for unit in ("resConfUnit1", "resConfUnit2"):
            if unit in r:
                _conv(r[unit]["conv1"], f"{sc}.refinenet{i}.{unit}.conv1", out)
                _conv(r[unit]["conv2"], f"{sc}.refinenet{i}.{unit}.conv2", out)
        _conv(r["out_conv"], f"{sc}.refinenet{i}.out_conv", out)
    _conv(h["output_conv1"], f"{sc}.output_conv1", out)
    _conv(h["output_conv2_0"], f"{sc}.output_conv2.0", out)
    _conv(h["output_conv2_2"], f"{sc}.output_conv2.2", out)
    features = out[f"{sc}.refinenet4.out_conv.weight"].shape[0]
    for conv in ("conv1", "conv2"):
        key = f"{sc}.refinenet4.resConfUnit1.{conv}"
        out[f"{key}.weight"] = np.zeros((features, features, 3, 3), np.float32)
        out[f"{key}.bias"] = np.zeros((features,), np.float32)
    if unused:
        out.update({k: np.asarray(v) for k, v in unused.items()})
    return out
