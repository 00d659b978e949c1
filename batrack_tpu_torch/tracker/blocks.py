"""Tracker building blocks: conv encoder and factorized transformer
(counterpart of batrack_tpu/tracker/blocks.py).

Parameter names follow the reference modules (cotracker/blocks.py), so the
released md_tracker.pth loads by name. Layouts are PyTorch's NCHW. Each
Linear and Conv2d casts its input to its own weight dtype, as a flax layer
with `dtype` does, so a model cast to bf16 runs bf16 activations while the
coordinate math around it stays float32. Normalisations compute their
statistics in float32.
"""

from __future__ import annotations

import os

import torch
import torch.nn as nn
import torch.nn.functional as F

from batrack_tpu_torch.ops.attention import (flash_attention, fused_qkv_attention,
                                             fused_qkv_attention_plain)
from batrack_tpu_torch.ops.sampling import interpolate_bilinear
from batrack_tpu_torch.parallel.shard_kernels import fused_qkv_attention_sharded


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) over NCHW input."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = xf.var(dim=(2, 3), keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm(elementwise_affine=False) over the last dim."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class GroupNorm1(nn.Module):
    """GroupNorm(1, C) with affine weight/bias on (rows, C) input; eps 1e-6
    (flax's default, which the JAX package and its weights use)."""

    def __init__(self, C: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(C))
        self.bias = nn.Parameter(torch.zeros(C))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = layer_norm(x.float(), self.eps)
        return (y * self.weight.float() + self.bias.float()).to(self.weight.dtype)


class ResidualBlock(nn.Module):
    """Reference ResidualBlock with norm_fn='instance'."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = Conv2d(planes, planes, 3, padding=1)
        self.downsample = (nn.Sequential(Conv2d(in_planes, planes, 1, stride=stride))
                           if stride != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(instance_norm(self.conv1(x)))
        y = F.relu(instance_norm(self.conv2(y)))
        if self.downsample is not None:
            x = instance_norm(self.downsample(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """Four-stage conv pyramid fused at stride 4 (reference BasicEncoder)."""

    def __init__(self, input_dim: int = 3, output_dim: int = 128, stride: int = 4):
        super().__init__()
        self.stride = stride
        self.conv1 = Conv2d(input_dim, 64, 7, stride=2, padding=3)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, 1), ResidualBlock(64, 64, 1))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, 2), ResidualBlock(96, 96, 1))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, 2), ResidualBlock(128, 128, 1))
        self.layer4 = nn.Sequential(ResidualBlock(128, 128, 2), ResidualBlock(128, 128, 1))
        self.conv2 = Conv2d(128 + 128 + 96 + 64, output_dim * 2, 3, padding=1)
        self.conv3 = Conv2d(output_dim * 2, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[-2:]
        out_hw = (H // self.stride, W // self.stride)
        x = F.relu(instance_norm(self.conv1(x)))
        a = self.layer1(x)
        b = self.layer2(a)
        c = self.layer3(b)
        d = self.layer4(c)
        x = torch.cat([interpolate_bilinear(t, out_hw, align_corners=True)
                       for t in (a, b, c, d)], dim=1)
        x = F.relu(instance_norm(self.conv2(x)))
        return self.conv3(x)


class Attention(nn.Module):
    """timm vision_transformer Attention (qkv_bias=True).

    Sequences of at least `kernel_threshold` tokens go through the
    packed-qkv attention kernel K2 when `use_kernel` is set; shorter ones
    (the time blocks) through its plain version, the same function. With
    BATRACK_TPU_ATTN set to anything but "fused" (read at each call, as
    batrack_tpu's Attention reads it), such sequences take the split-head
    route instead: heads split, K4 (flash_attention), heads merged. With a
    `mesh` the sequence axis is sharded over the ranks (the space blocks of
    the multi-device path): x holds this rank's tokens and the keys and
    values of all ranks are gathered (fused_qkv_attention_sharded)."""

    def __init__(self, dim: int, num_heads: int, use_kernel: bool = False,
                 kernel_threshold: int = 1024, mesh=None):
        super().__init__()
        self.num_heads = num_heads
        self.use_kernel = use_kernel
        self.kernel_threshold = kernel_threshold
        self.mesh = mesh
        self.qkv = Linear(dim, dim * 3)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, key_mask=None) -> torch.Tensor:
        """key_mask: optional (N,) bool, of this rank's tokens under a mesh;
        False keys are excluded from the softmax (the reference slices
        inactive tracks out instead)."""
        B, N, C = x.shape
        qkv = self.qkv(x)
        head = C // self.num_heads
        scale = head ** -0.5
        n_all = N if self.mesh is None else N * self.mesh.size
        if self.use_kernel and n_all >= self.kernel_threshold:
            # under a mesh batrack_tpu's split-head route is its dense
            # attention, the same function, so the sharded K2 route stays
            if self.mesh is None and os.environ.get("BATRACK_TPU_ATTN", "fused") != "fused":
                q, k, v = qkv.reshape(B, N, 3, self.num_heads, head).permute(2, 0, 3, 1, 4)
                out = flash_attention(q, k, v, scale, key_mask)
                return self.proj(out.transpose(1, 2).reshape(B, N, C))
            attend = fused_qkv_attention
        else:
            attend = fused_qkv_attention_plain
        if self.mesh is not None:
            out = fused_qkv_attention_sharded(qkv, self.num_heads, scale, self.mesh, key_mask,
                                              attend=attend)
        else:
            out = attend(qkv, self.num_heads, scale, key_mask)
        return self.proj(out)


class Mlp(nn.Module):
    """timm Mlp with tanh-approximate GELU."""

    def __init__(self, in_dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden)
        self.fc2 = Linear(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class AttnBlock(nn.Module):
    """Pre-norm transformer block (reference AttnBlock)."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0,
                 use_kernel: bool = False, kernel_threshold: int = 1024, mesh=None):
        super().__init__()
        self.attn = Attention(hidden_size, num_heads, use_kernel, kernel_threshold, mesh)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio), hidden_size)

    def forward(self, x: torch.Tensor, key_mask=None) -> torch.Tensor:
        x = x + self.attn(layer_norm(x), key_mask)
        return x + self.mlp(layer_norm(x))


class UpdateFormer(nn.Module):
    """Factorized time/space transformer (reference UpdateFormer)."""

    def __init__(self, space_depth: int = 6, time_depth: int = 6,
                 input_dim: int = 456, hidden_size: int = 384, num_heads: int = 8,
                 output_dim: int = 131, mlp_ratio: float = 4.0,
                 add_space_attn: bool = True, use_kernel: bool = False,
                 kernel_threshold: int = 1024, mesh=None):
        super().__init__()
        if add_space_attn and (space_depth > time_depth or time_depth % space_depth):
            raise ValueError(f"space_depth ({space_depth}) must divide time_depth "
                             f"({time_depth}) when add_space_attn is on")
        self.hidden_size = hidden_size
        self.add_space_attn = add_space_attn
        self.interval = time_depth // space_depth if add_space_attn else 0
        self.input_transform = Linear(input_dim, hidden_size)
        self.time_blocks = nn.ModuleList(
            AttnBlock(hidden_size, num_heads, mlp_ratio) for _ in range(time_depth))
        self.space_blocks = nn.ModuleList(
            AttnBlock(hidden_size, num_heads, mlp_ratio, use_kernel, kernel_threshold, mesh)
            for _ in range(space_depth if add_space_attn else 0))
        self.flow_head = Linear(hidden_size, output_dim)

    def forward(self, x: torch.Tensor, key_mask=None) -> torch.Tensor:
        # x: (B, N, T, input_dim); key_mask: optional (N,) active-track mask
        # for the space attention (time attention, MLPs and norms are
        # per-track, so absent tracks cannot leak through them). Under a
        # mesh N is this rank's tracks and only the space blocks communicate
        B, N, T, _ = x.shape
        Hd = self.hidden_size
        x = self.input_transform(x)
        j = 0
        for i, blk in enumerate(self.time_blocks):
            x = blk(x.reshape(B * N, T, Hd)).reshape(B, N, T, Hd)
            if self.add_space_attn and i % self.interval == 0:
                xs = x.transpose(1, 2).reshape(B * T, N, Hd)
                xs = self.space_blocks[j](xs, key_mask)
                x = xs.reshape(B, T, N, Hd).transpose(1, 2)
                j += 1
        return self.flow_head(x)


class MotionLabelMLP(nn.Module):
    """Per-track dynamic-motion logit (reference MotionLabelBlock, mlp_v1).
    The mean runs over the tracker window (pool_S = S): the reference pools
    with AvgPool1d(kernel_size=S)."""

    def __init__(self, in_dim: int = 128, hidden_dim: int = 256, pool_S: int = 12):
        super().__init__()
        self.pool_S = pool_S
        self.network = nn.Module()
        self.network.mlp = Mlp(in_dim, hidden_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, N, S, C) track-major -> (B, N, 1)
        x = self.network.mlp(x)[..., 0][..., : self.pool_S]
        return x.mean(-1, keepdim=True)
