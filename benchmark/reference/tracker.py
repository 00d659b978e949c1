"""Plain float32 MDTracker forward for one sliding window (T == S), the
benchmark's reference for the tracker append.

Written from the architecture (BA-Track's md_tracker.py with the CoTracker
blocks, as the measured program names its weights): a conv encoder with a
Fourier xyz fusion, a 4-level correlation pyramid sampled at radius r, and
`iters` refinement steps of a factorised time/space transformer, then the
visibility and motion-label heads. Weights are a dict by the program's
parameter names; every product runs in float32 with TF32 off, unless
`fp8` asks for the control, which rounds each product's inputs and
outputs and the residual streams (what a bf16 program keeps in bf16) to
float8 e4m3 with one scale per tensor.

It imports nothing of the measured program: no kernel, no plain version of
one, no helper.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn


class TrackerShape(NamedTuple):
    S: int
    stride: int
    latent_dim: int
    hidden_size: int
    num_heads: int
    space_depth: int
    time_depth: int
    space_depth_dyn: int
    time_depth_dyn: int
    corr_levels: int
    corr_radius: int
    iters: int
    interp_shape: tuple

    @property
    def input_dim(self) -> int:
        # flow embedding (130) + correlation (levels x (2r+1)^2) + features + mask/vis
        return 130 + self.corr_levels * (2 * self.corr_radius + 1) ** 2 + self.latent_dim + 2

    @classmethod
    def from_model(cls, m: dict) -> "TrackerShape":
        return cls(S=m["S"], stride=m["model_stride"], latent_dim=m["latent_dim"],
                   hidden_size=m["hidden_size"], num_heads=m["num_heads"],
                   space_depth=m["space_depth"], time_depth=m["time_depth"],
                   space_depth_dyn=m["space_depth_dyn"], time_depth_dyn=m["time_depth_dyn"],
                   corr_levels=m["corr_levels"], corr_radius=m["corr_radius"], iters=m["I"],
                   interp_shape=tuple(m["interp_shape"]))


def param_shapes(p: TrackerShape) -> Dict[str, tuple]:
    """Every weight of the tracker by the program's parameter name, in a
    fixed order."""
    out: Dict[str, tuple] = {}

    def lin(name, cin, cout):
        out[f"{name}.weight"] = (cout, cin)
        out[f"{name}.bias"] = (cout,)

    def conv(name, cin, cout, k):
        out[f"{name}.weight"] = (cout, cin, k, k)
        out[f"{name}.bias"] = (cout,)

    conv("fnet.conv1", 3, 64, 7)
    for layer, cin, cout in ((1, 64, 64), (2, 64, 96), (3, 96, 128), (4, 128, 128)):
        for blk in (0, 1):
            c_in = cin if blk == 0 else cout
            conv(f"fnet.layer{layer}.{blk}.conv1", c_in, cout, 3)
            conv(f"fnet.layer{layer}.{blk}.conv2", cout, cout, 3)
            if layer > 1 and blk == 0:
                conv(f"fnet.layer{layer}.{blk}.downsample.0", c_in, cout, 1)
    conv("fnet.conv2", 128 + 128 + 96 + 64, 2 * p.latent_dim, 3)
    conv("fnet.conv3", 2 * p.latent_dim, p.latent_dim, 1)
    hs = p.hidden_size
    for former, space, time in (("updateformer", p.space_depth, p.time_depth),
                                ("updateformer_dyn", p.space_depth_dyn, p.time_depth_dyn)):
        lin(f"{former}.input_transform", p.input_dim, hs)
        for kind, depth in (("time_blocks", time), ("space_blocks", space)):
            for i in range(depth):
                b = f"{former}.{kind}.{i}"
                lin(f"{b}.attn.qkv", hs, 3 * hs)
                lin(f"{b}.attn.proj", hs, hs)
                lin(f"{b}.mlp.fc1", hs, 4 * hs)
                lin(f"{b}.mlp.fc2", 4 * hs, hs)
        lin(f"{former}.flow_head", hs, p.latent_dim + 3)
    out["norm.weight"] = (p.latent_dim,)
    out["norm.bias"] = (p.latent_dim,)
    lin("ffeat_updater.0", p.latent_dim, p.latent_dim)
    lin("vis_predictor.0", p.latent_dim, 1)
    lin("motion_label_block.network.mlp.fc1", p.latent_dim, 256)
    lin("motion_label_block.network.mlp.fc2", 256, 1)
    conv("embedConv", p.latent_dim + 63, p.latent_dim, 3)
    lin("zeroMLPflow", 3 * 64 + 3, 130)
    return out


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and convolutions, restored on exit."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the whole tensor
    (its largest magnitude maps to 448), returned in float32."""
    s = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Precision:
    """What each product's inputs and outputs are rounded to: nothing
    (float32) or float8 e4m3 (the control)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return round_fp8(x) if self.fp8 else x


# ---- sampling ---------------------------------------------------------------

def bilinear_taps(im: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """im (C, H, W) at float pixel coords x, y (N,) -> (N, C): the 4 taps at
    floor/floor+1 with indices clamped to the image and weights from the
    unclamped coordinates."""
    C, H, W = im.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    rows = im.reshape(C, H * W).T

    def tap(yy, xx):
        return rows[yy.clamp(0, H - 1).long() * W + xx.clamp(0, W - 1).long()]

    return (((x0 + 1 - x) * (y0 + 1 - y))[:, None] * tap(y0, x0)
            + ((x - x0) * (y0 + 1 - y))[:, None] * tap(y0, x0 + 1)
            + ((x0 + 1 - x) * (y - y0))[:, None] * tap(y0 + 1, x0)
            + ((x - x0) * (y - y0))[:, None] * tap(y0 + 1, x0 + 1))


def corr_level(fmap: torch.Tensor, target: torch.Tensor, xy: torch.Tensor, r: int) -> torch.Tensor:
    """Correlation of one frame's tracks with one pyramid level: fmap
    (C, H, W), target (N, C), xy (N, 2) at this level -> (N, (2r+1)^2).
    The volume <target, fmap> is sampled bilinearly at xy + (dx, dy), taps
    outside the map read 0; entry a*(2r+1) + b holds offset (dx, dy) =
    (a - r, b - r), the order the trained weights expect."""
    C, H, W = fmap.shape
    vol = (target @ fmap.reshape(C, H * W)) / math.sqrt(C)       # (N, H*W)
    off = torch.arange(-r, r + 2, device=xy.device)
    x0 = torch.floor(xy[:, 0]).long()
    y0 = torch.floor(xy[:, 1]).long()
    ix = x0[:, None, None] + off[None, None, :]                     # (N, 1, D) cols
    iy = y0[:, None, None] + off[None, :, None]                     # (N, D, 1) rows
    inside = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    idx = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(len(xy), -1)
    D = 2 * r + 2
    g = torch.gather(vol, 1, idx).reshape(-1, D, D) * inside       # (N, rows, cols)
    fx = (xy[:, 0] - torch.floor(xy[:, 0]))[:, None, None]
    fy = (xy[:, 1] - torch.floor(xy[:, 1]))[:, None, None]
    d = D - 1
    out = ((1 - fy) * (1 - fx) * g[:, :d, :d] + (1 - fy) * fx * g[:, :d, 1:]
           + fy * (1 - fx) * g[:, 1:, :d] + fy * fx * g[:, 1:, 1:])  # (N, dy, dx)
    return out.transpose(1, 2).reshape(len(xy), d * d)


# ---- embeddings ---------------------------------------------------------------

def sincos_1d(dim: int, pos) -> np.ndarray:
    omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
    out = np.einsum("m,d->md", np.asarray(pos).reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_2d(dim: int, h: int, w: int) -> np.ndarray:
    gw, gh = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    return np.concatenate([sincos_1d(dim // 2, gw), sincos_1d(dim // 2, gh)], axis=1)


def flow_embedding(xyz: torch.Tensor, C: int = 64) -> torch.Tensor:
    """Per channel, interleaved sin/cos against C/2 frequencies, then the
    coordinates themselves."""
    div = torch.arange(0, C, 2, dtype=torch.float32, device=xyz.device) * (1000.0 / C)
    outs = []
    for i in range(xyz.shape[-1]):
        v = xyz[..., i:i + 1] * div
        outs.append(torch.stack([torch.sin(v), torch.cos(v)], -1).flatten(-2))
    return torch.cat(outs + [xyz], dim=-1)


def fourier_xyz(x: torch.Tensor, n_freqs: int = 10, max_log2: float = 10.0) -> torch.Tensor:
    bands = [float(np.float32(f)) for f in 2.0 ** np.linspace(0.0, max_log2, n_freqs)]
    out = [x]
    for f in bands:
        out += [torch.sin(x * f), torch.cos(x * f)]
    return torch.cat(out, dim=-1)


def scrambled_concat(track_mask: torch.Tensor, vis: torch.Tensor) -> torch.Tensor:
    """The released model's mask/visibility input channels: cat([mask, vis])
    on (S, N) then read as (N, S, 2), which interleaves neighbouring tracks
    and frames (all tracks active). Returns (N, S, 2)."""
    S, N = track_mask.shape
    sc = 2 * np.arange(S)[None, :, None] + np.arange(2)[None, None, :]
    k = torch.as_tensor(2 * np.arange(N)[:, None, None] + sc // S, device=track_mask.device)
    f = torch.as_tensor(sc % S, device=track_mask.device).expand(k.shape)
    return torch.where(k < N, track_mask[f, k.clamp(0, N - 1)], vis[f, (k - N).clamp(0, N - 1)])


# ---- the network ------------------------------------------------------------

class ReferenceTracker:
    """The forward pass on a weight dict (float32 copies of the served
    weights)."""

    def __init__(self, p: TrackerShape, weights: Dict[str, torch.Tensor], fp8: bool = False):
        self.p = p
        self.w = {k: v.float() for k, v in weights.items()}
        self.q = Precision(fp8)

    def lin(self, name, x):
        return self.q(F.linear(self.q(x), self.q(self.w[name + ".weight"]), self.w[name + ".bias"]))

    def conv(self, name, x, stride=1, padding=0):
        return self.q(F.conv2d(self.q(x), self.q(self.w[name + ".weight"]), self.w[name + ".bias"],
                               stride=stride, padding=padding))

    @staticmethod
    def instance_norm(x, eps=1e-5):
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + eps)

    @staticmethod
    def layer_norm(x, eps=1e-6):
        mean = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + eps)

    def residual(self, name, x, stride, down):
        y = F.relu(self.instance_norm(self.conv(f"{name}.conv1", x, stride, 1)))
        y = F.relu(self.instance_norm(self.conv(f"{name}.conv2", y, 1, 1)))
        if down:
            x = self.instance_norm(self.conv(f"{name}.downsample.0", x, stride))
        return self.q(F.relu(x + y))

    def fnet(self, rgbs):
        H, W = rgbs.shape[-2:]
        out_hw = (H // self.p.stride, W // self.p.stride)
        x = F.relu(self.instance_norm(self.conv("fnet.conv1", rgbs, 2, 3)))
        feats = []
        for layer in (1, 2, 3, 4):
            s = 1 if layer == 1 else 2
            x = self.residual(f"fnet.layer{layer}.0", x, s, layer > 1)
            x = self.residual(f"fnet.layer{layer}.1", x, 1, False)
            feats.append(x)
        x = torch.cat([F.interpolate(t, size=out_hw, mode="bilinear", align_corners=True)
                       for t in feats], dim=1)
        x = F.relu(self.instance_norm(self.conv("fnet.conv2", x, 1, 1)))
        return self.conv("fnet.conv3", x)

    def encode(self, rgbs, depths_dn, z_min, z_max):
        """fmaps (F, C, h4, w4) of F frames: rgbs (F, 3, H, W) in [-1, 1],
        depths_dn (F, h4, w4) in grid units, normalised by the (z_min,
        z_max) of the window they were first encoded in."""
        Fn, _, H, W = rgbs.shape
        h4, w4 = H // self.p.stride, W // self.p.stride
        fm = self.fnet(rgbs)
        dev = rgbs.device
        gx = torch.arange(w4, dtype=torch.float32, device=dev)[None, None, :].expand(Fn, h4, w4)
        gy = torch.arange(h4, dtype=torch.float32, device=dev)[None, :, None].expand(Fn, h4, w4)

        def norm01(v, lo, hi):
            return 2.0 * ((v - lo) / torch.clamp(torch.as_tensor(hi - lo), min=1e-12) - 0.5)

        xyz = torch.stack([norm01(gx, 0.0, w4 - 1.0), norm01(gy, 0.0, h4 - 1.0),
                           norm01(depths_dn, z_min, z_max)], -1)
        pe = fourier_xyz(xyz).permute(0, 3, 1, 2)
        return self.conv("embedConv", torch.cat([fm, pe], 1), 1, 1)

    def attention(self, name, x):
        """timm Attention (qkv bias) over (B, L, C), one head at a time."""
        B, L, C = x.shape
        h = self.p.num_heads
        d = C // h
        qkv = self.lin(f"{name}.qkv", x)
        out = torch.empty((B, L, C), dtype=x.dtype, device=x.device)
        for i in range(h):
            q = qkv[..., i * d:(i + 1) * d]
            k = qkv[..., C + i * d:C + (i + 1) * d]
            v = qkv[..., 2 * C + i * d:2 * C + (i + 1) * d]
            logits = (self.q(q) @ self.q(k).transpose(1, 2)) * d ** -0.5
            pr = torch.softmax(logits, dim=-1)
            out[..., i * d:(i + 1) * d] = self.q(pr) @ self.q(v)
        return self.lin(f"{name}.proj", out)

    def block(self, name, x):
        x = self.q(x + self.attention(f"{name}.attn", self.layer_norm(x)))
        y = self.lin(f"{name}.mlp.fc1", self.layer_norm(x))
        return self.q(x + self.lin(f"{name}.mlp.fc2", F.gelu(y, approximate="tanh")))

    def updateformer(self, x):
        """x (N, S, input_dim) -> (N, S, latent + 3): time blocks over S,
        each followed by a space block over N."""
        p = self.p
        N, S, _ = x.shape
        x = self.lin("updateformer.input_transform", x)
        interval = p.time_depth // p.space_depth
        j = 0
        for i in range(p.time_depth):
            x = self.block(f"updateformer.time_blocks.{i}", x)
            if i % interval == 0:
                xs = self.block(f"updateformer.space_blocks.{j}", x.transpose(0, 1))
                x = xs.transpose(0, 1)
                j += 1
        return self.lin("updateformer.flow_head", x)

    def corr(self, pyramid, ffeats, coords):
        """(N, S, L*(2r+1)^2): ffeats (N, S, C), coords (S, N, 2) at level 0."""
        r = self.p.corr_radius
        S = coords.shape[0]
        per_frame = []
        for s in range(S):
            t = self.q(ffeats[:, s])
            per_frame.append(torch.cat([
                corr_level(self.q(fm[s]), t, coords[s] / 2.0 ** lvl, r)
                for lvl, fm in enumerate(pyramid)], dim=-1))
        return torch.stack(per_frame, dim=1)

    @torch.no_grad()
    def forward(self, window_rgbd, queries, fmaps, d_near, d_far):
        """One window. window_rgbd (S, 4, ih, iw) at the model resolution
        (rgb 0..255, metric depth); queries (N, 4) [frame, x, y, depth] in
        model pixels; fmaps (S, C, h4, w4) as the window's frames were
        encoded; d_near, d_far the window's depth range. Returns (tracks
        (S, N, 2) model pixels, depths (S, N), vis (S, N), dynamic (S, N))."""
        p = self.p
        S, _, H, W = window_rgbd.shape
        N = queries.shape[0]
        C = p.latent_dim
        dev = window_rgbd.device
        Dz = float(W // p.stride)
        h4, w4 = H // p.stride, W // p.stride
        first = queries[:, 0].long()
        coords0 = torch.cat([queries[:, 1:3] / float(p.stride),
                             ((queries[:, 3] - d_near) / (d_far - d_near) * Dz)[:, None]], -1)
        # features of each query at its own frame
        feat = _per_frame_taps(fmaps.permute(0, 2, 3, 1), first, coords0[:, :2])
        ffeats = feat[:, None, :].expand(N, S, C).clone()
        t_ids = torch.arange(S, device=dev)
        track_mask = (t_ids[:, None] >= first[None, :]).float()
        order = torch.argsort(first, stable=True)
        concat = scrambled_concat(track_mask[:, order],
                                  torch.full((S, N), 10.0, device=dev))[torch.argsort(order)]
        pyramid = [fmaps]
        for _ in range(p.corr_levels - 1):
            pyramid.append(F.avg_pool2d(pyramid[-1], 2, 2))
        pos_grid = torch.as_tensor(sincos_2d(p.input_dim, h4, w4), dtype=torch.float32,
                                   device=dev).reshape(h4, w4, p.input_dim).permute(2, 0, 1)
        pos = bilinear_taps(pos_grid, coords0[:, 0], coords0[:, 1])           # (N, E)
        times = torch.as_tensor(sincos_1d(p.input_dim, np.linspace(0, p.S - 1, p.S)),
                                dtype=torch.float32, device=dev)
        coords = coords0[None].expand(S, N, 3)
        for _ in range(p.iters):
            fc = self.corr(pyramid, ffeats, coords[..., :2])
            flows = (coords - coords[0:1]).transpose(0, 1)
            x = torch.cat([self.lin("zeroMLPflow", flow_embedding(flows)), fc, ffeats, concat], -1)
            delta = self.updateformer(x + pos[:, None, :] + times[None])
            d_feats = delta[..., 3:]
            normed = self.layer_norm(d_feats) * self.w["norm.weight"] + self.w["norm.bias"]
            ffeats = F.gelu(self.lin("ffeat_updater.0", normed)) + ffeats
            coords = coords + delta[..., :3].transpose(0, 1)
        tracks = coords[..., :2] * float(p.stride)
        depths = coords[..., 2] / Dz * (d_far - d_near) + d_near
        vis = torch.sigmoid(self.lin("vis_predictor.0", ffeats)[..., 0].T)
        m = self.lin("motion_label_block.network.mlp.fc1", ffeats)
        m = self.lin("motion_label_block.network.mlp.fc2", F.gelu(m, approximate="tanh"))
        dyn = torch.sigmoid(m[..., 0][..., :p.S].mean(-1))
        return tracks, depths, vis, dyn[None, :].expand(S, N)


def _per_frame_taps(flat, frame, xy):
    """(N, C) bilinear taps of (S, H, W, C) maps, each point on its own frame."""
    S, H, W, C = flat.shape
    rows = flat.reshape(S * H * W, C)
    x, y = xy[:, 0], xy[:, 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    base = frame * (H * W)

    def tap(yy, xx):
        return rows[base + yy.clamp(0, H - 1).long() * W + xx.clamp(0, W - 1).long()]

    return (((x0 + 1 - x) * (y0 + 1 - y))[:, None] * tap(y0, x0)
            + ((x - x0) * (y0 + 1 - y))[:, None] * tap(y0, x0 + 1)
            + ((x0 + 1 - x) * (y - y0))[:, None] * tap(y0 + 1, x0)
            + ((x - x0) * (y - y0))[:, None] * tap(y0 + 1, x0 + 1))


def window_stats(depth_window: torch.Tensor, stride: int, W: int):
    """The depth normalisation a window fixes for everything encoded in it:
    depth_window (S, ih, iw) metric at the model resolution -> (d_near,
    d_far, grid depths (S, h4, w4) in [0, Dz], z_min, z_max)."""
    ok = depth_window > 0.01
    d_near = torch.where(ok, depth_window, torch.full_like(depth_window, float("inf"))).min()
    d_far = torch.where(ok, depth_window, torch.full_like(depth_window, float("-inf"))).max()
    d_far = torch.maximum(d_far, d_near + 1e-3)
    Dz = float(W // stride)
    dn = (depth_window[:, ::stride, ::stride] - d_near) / (d_far - d_near) * Dz
    return d_near, d_far, dn, dn.min(), dn.max()
