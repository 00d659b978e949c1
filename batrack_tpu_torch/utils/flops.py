"""Analytic FLOP model of the MDTracker forward: a copy of
batrack_tpu/utils/flops.py for this package.

The model counts the matmul, convolution and attention FLOPs from the
architecture itself (md_tracker.py and the CoTracker blocks), so the number
is a property of the network, independent of which kernel executes each op
(PyTorch's FlopCounterMode sees no hand-written kernel). chip_smoke.py
divides it by a forward's time on the card for TFLOP/s.

Convention: 1 multiply-add = 2 FLOPs. Elementwise ops, norms, embeddings
and resizes are not counted (under 1 % of the total).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping


def conv2d(h: int, w: int, cin: int, cout: int, k: int, stride: int = 1) -> float:
    """Output-sized conv FLOPs (2 * MACs)."""
    return 2.0 * (h // stride) * (w // stride) * cin * cout * k * k


def dense(tokens: float, cin: int, cout: int) -> float:
    return 2.0 * tokens * cin * cout


def basic_encoder(H: int, W: int, cin: int = 4, C: int = 128) -> float:
    """BasicEncoder conv pyramid, one frame (tracker/blocks.py::BasicEncoder)."""
    h2, w2 = H // 2, W // 2
    h4, w4 = H // 4, W // 4
    h8, w8 = H // 8, W // 8
    h16, w16 = H // 16, W // 16
    f = conv2d(h2, w2, cin, 64, 7)                       # conv1 (stride applied)
    f += 4 * conv2d(h2, w2, 64, 64, 3)                   # layer1: 2 blocks x 2 convs
    f += conv2d(h4, w4, 64, 96, 3) + conv2d(h4, w4, 96, 96, 3)   # layer2_0
    f += conv2d(h4, w4, 64, 96, 1)                       # shortcut
    f += 2 * conv2d(h4, w4, 96, 96, 3)                   # layer2_1
    f += conv2d(h8, w8, 96, 128, 3) + conv2d(h8, w8, 128, 128, 3)
    f += conv2d(h8, w8, 96, 128, 1)
    f += 2 * conv2d(h8, w8, 128, 128, 3)
    f += conv2d(h16, w16, 128, 128, 3) + conv2d(h16, w16, 128, 128, 3)
    f += conv2d(h16, w16, 128, 128, 1)
    f += 2 * conv2d(h16, w16, 128, 128, 3)
    f += conv2d(h4, w4, 64 + 96 + 128 + 128, 2 * C, 3)   # conv2 on the fused pyramid
    f += conv2d(h4, w4, 2 * C, C, 1)                     # conv3
    return f


def attn_block(batch: float, seqlen: int, C: int, mlp_ratio: float = 4.0) -> float:
    """One AttnBlock: qkv + scores + AV + proj + 2-layer MLP (blocks.py::AttnBlock)."""
    tokens = batch * seqlen
    f = dense(tokens, C, 3 * C)                          # qkv
    f += 2.0 * batch * seqlen * seqlen * C * 2           # QK^T and AV (all heads)
    f += dense(tokens, C, C)                             # proj
    hidden = int(C * mlp_ratio)
    f += dense(tokens, C, hidden) + dense(tokens, hidden, C)
    return f


def updateformer(
    N: int, T: int, input_dim: int, hidden: int, out_dim: int,
    time_depth: int, space_depth: int, mlp_ratio: float = 4.0,
) -> float:
    """Factorised time/space transformer, one call (blocks.py::UpdateFormer)."""
    f = dense(N * T, input_dim, hidden)                  # input_transform
    f += time_depth * attn_block(N, T, hidden, mlp_ratio)
    f += space_depth * attn_block(T, N, hidden, mlp_ratio)
    f += dense(N * T, hidden, out_dim)                   # flow_head
    return f


def corr_sampling(N: int, S: int, levels: int, radius: int, C: int) -> float:
    """Correlation pyramid sampling, one call (ops/corr.py, K1 in ops/corr_kernel.py).

    Per (track, frame, level): (2r+2)^2 channel contractions of length C at
    the integer grid, then a (2r+1)^2 bilinear blend of 4 taps each.
    """
    g = (2 * radius + 2) ** 2
    b = (2 * radius + 1) ** 2
    per_window = 2.0 * g * C + 2.0 * b * 4
    return N * S * levels * per_window


def tracker_forward_flops(
    *,
    N: int,
    S: int,
    H: int,
    W: int,
    latent_dim: int = 128,
    input_dim: int = 456,
    hidden_size: int = 384,
    corr_levels: int = 4,
    corr_radius: int = 3,
    iters: int = 4,
    static_iters: int = 2,
    time_depth: int = 6,
    space_depth: int = 6,
    time_depth_dyn: int = 3,
    space_depth_dyn: int = 3,
    motion_hidden: int = 256,
    new_frames: int = 2,
    stride: int = 4,
) -> Dict[str, float]:
    """Per-forward FLOP breakdown at steady state (one sliding window).

    N: tracks; S: window length; H, W: tracker input resolution
    (md_tracker.py:85 interp_shape); new_frames: frames actually encoded per
    append (the cross-append feature cache reuses the rest).
    Returns a dict of components plus 'total'.
    """
    h4, w4 = H // stride, W // stride
    C = latent_dim
    it_total = iters + static_iters

    fnet = new_frames * basic_encoder(H, W, cin=4, C=C)
    # embedConv fuses fmap + 63-dim Fourier xyz grid (mdtracker.py:203-219)
    embed = new_frames * conv2d(h4, w4, C + 63, C, 3)

    corr = it_total * corr_sampling(N, S, corr_levels, corr_radius, C)
    # flow embedding: sincos(3 dims -> 64 each) + cat -> 195 -> Dense 130
    flow_mlp = it_total * dense(N * S, 3 * 64 + 3, 130)

    main_tf = iters * updateformer(
        N, S, input_dim, hidden_size, C + 3, time_depth, space_depth)
    dyn_tf = static_iters * updateformer(
        N, S, input_dim, hidden_size, C + 3, time_depth_dyn, space_depth_dyn)

    feat_upd = it_total * dense(N * S, C, C)             # ffeat_updater
    heads = dense(N * S, C, 1)                           # vis_predictor
    heads += dense(N * S, C, motion_hidden) + dense(N * S, motion_hidden, 1)

    out = {
        "fnet": fnet,
        "embed_conv": embed,
        "corr_sampling": corr,
        "flow_mlp": flow_mlp,
        "updateformer_main": main_tf,
        "updateformer_dyn": dyn_tf,
        "feat_updater": feat_upd,
        "heads": heads,
    }
    out["total"] = float(sum(out.values()))
    return out


def _depth(state_dict: Mapping, prefix: str) -> int:
    pat = re.compile(re.escape(prefix) + r"\.(\d+)\.")
    return 1 + max((int(m.group(1)) for k in state_dict if (m := pat.match(k))), default=-1)


def tracker_forward_flops_from_params(model, N: int, H: int, W: int, new_frames: int = 2,
                                      params=None) -> Dict[str, float]:
    """Breakdown for the port's MDTracker (or its TrackerParams) at N
    tracks on H x W frames. Given the tracker's state dict instead, the
    widths, depths and motion-head width come from its weights, and what
    weights do not hold (S, stride, iterations, correlation levels and
    radius) from `params` (default TrackerParams())."""
    from batrack_tpu_torch.tracker.mdtracker import TrackerParams

    p = getattr(model, "p", model)
    if isinstance(p, TrackerParams):
        return tracker_forward_flops(
            N=N, S=p.S, H=H, W=W, latent_dim=p.latent_dim, input_dim=p.input_dim,
            hidden_size=p.hidden_size, corr_levels=p.corr_levels,
            corr_radius=p.corr_radius, iters=p.iters, static_iters=p.static_iters,
            time_depth=p.time_depth, space_depth=p.space_depth,
            time_depth_dyn=p.time_depth_dyn, space_depth_dyn=p.space_depth_dyn,
            new_frames=new_frames, stride=p.stride)
    sd, p = model, params or TrackerParams()
    hidden, input_dim = sd["updateformer.input_transform.weight"].shape
    return tracker_forward_flops(
        N=N, S=p.S, H=H, W=W, latent_dim=sd["fnet.conv3.weight"].shape[0],
        input_dim=input_dim, hidden_size=hidden, corr_levels=p.corr_levels,
        corr_radius=p.corr_radius, iters=p.iters, static_iters=p.static_iters,
        time_depth=_depth(sd, "updateformer.time_blocks"),
        space_depth=_depth(sd, "updateformer.space_blocks"),
        time_depth_dyn=_depth(sd, "updateformer_dyn.time_blocks"),
        space_depth_dyn=_depth(sd, "updateformer_dyn.space_blocks"),
        motion_hidden=sd["motion_label_block.network.mlp.fc1.weight"].shape[0],
        new_frames=new_frames, stride=p.stride)
