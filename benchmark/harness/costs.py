"""The yardstick's arithmetic: the card's published peaks, the operations
and bytes of one call of the hand-written kernels K1 and K2, and the
tracker's forward FLOPs (a frozen copy of the port's analytic model in
utils/flops.py, which counts multiply-adds as 2 FLOPs from the
architecture, so that no kernel's choice changes it)."""

from __future__ import annotations

from typing import Dict

# one NVIDIA H100 SXM (data sheet, dense, at the 700 W limit)
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12


def least_time_s(flops: float, nbytes: float) -> float:
    """The roofline's least time for a call: the larger of its operations
    at the bf16 tensor-core peak and its bytes at the HBM bandwidth."""
    return max(flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES_PER_S)


def k1_cost(S: int, N: int, C: int, shapes, radius: int) -> Dict[str, float]:
    """K1 (corr_sample): the bf16 packed pyramid of S frames (levels
    `shapes`, C channels) against N tracks' float32 features (N, S, C) at
    float32 coords (S, N, 2), out (N, S, L*(2r+1)^2) float32. Bytes: every
    input read once and the output written once. Operations: each window's
    (2r+2)^2 taps contracted over C, and the 2x2 blend of each output."""
    L = len(shapes)
    n_out = N * S * L * (2 * radius + 1) ** 2
    map_bytes = 2 * S * C * sum(h * w for h, w in shapes)
    nbytes = map_bytes + 4 * N * S * C + 4 * S * N * 2 + 4 * n_out
    flops = 2.0 * C * N * S * L * (2 * radius + 2) ** 2 + 8.0 * n_out
    return {"flops": flops, "bytes": float(nbytes), "least_s": least_time_s(flops, nbytes)}


def k2_cost(B: int, N: int, heads: int, d: int) -> Dict[str, float]:
    """K2 (fused_qkv_attention) on a packed bf16 (B, N, 3*heads*d) qkv:
    QK^T and PV, 4*B*heads*N^2*d operations; the qkv read once and the
    (B, N, heads*d) output written once."""
    flops = 4.0 * B * heads * N * N * d
    nbytes = 2 * B * N * 3 * heads * d + 2 * B * N * heads * d
    return {"flops": flops, "bytes": float(nbytes), "least_s": least_time_s(flops, nbytes)}


# ---- the tracker's forward FLOPs (frozen copy of utils/flops.py) ----------

def conv2d(h, w, cin, cout, k, stride=1):
    return 2.0 * (h // stride) * (w // stride) * cin * cout * k * k


def dense(tokens, cin, cout):
    return 2.0 * tokens * cin * cout


def basic_encoder(H, W, cin=4, C=128):
    h2, w2, h4, w4 = H // 2, W // 2, H // 4, W // 4
    h8, w8, h16, w16 = H // 8, W // 8, H // 16, W // 16
    f = conv2d(h2, w2, cin, 64, 7)
    f += 4 * conv2d(h2, w2, 64, 64, 3)
    f += conv2d(h4, w4, 64, 96, 3) + conv2d(h4, w4, 96, 96, 3)
    f += conv2d(h4, w4, 64, 96, 1)
    f += 2 * conv2d(h4, w4, 96, 96, 3)
    f += conv2d(h8, w8, 96, 128, 3) + conv2d(h8, w8, 128, 128, 3)
    f += conv2d(h8, w8, 96, 128, 1)
    f += 2 * conv2d(h8, w8, 128, 128, 3)
    f += conv2d(h16, w16, 128, 128, 3) + conv2d(h16, w16, 128, 128, 3)
    f += conv2d(h16, w16, 128, 128, 1)
    f += 2 * conv2d(h16, w16, 128, 128, 3)
    f += conv2d(h4, w4, 64 + 96 + 128 + 128, 2 * C, 3)
    f += conv2d(h4, w4, 2 * C, C, 1)
    return f


def attn_block(batch, seqlen, C, mlp_ratio=4.0):
    tokens = batch * seqlen
    f = dense(tokens, C, 3 * C)
    f += 2.0 * batch * seqlen * seqlen * C * 2
    f += dense(tokens, C, C)
    hidden = int(C * mlp_ratio)
    return f + dense(tokens, C, hidden) + dense(tokens, hidden, C)


def updateformer(N, T, input_dim, hidden, out_dim, time_depth, space_depth, mlp_ratio=4.0):
    f = dense(N * T, input_dim, hidden)
    f += time_depth * attn_block(N, T, hidden, mlp_ratio)
    f += space_depth * attn_block(T, N, hidden, mlp_ratio)
    return f + dense(N * T, hidden, out_dim)


def corr_sampling(N, S, levels, radius, C):
    g = (2 * radius + 2) ** 2
    b = (2 * radius + 1) ** 2
    return N * S * levels * (2.0 * g * C + 2.0 * b * 4)


def tracker_forward_flops(*, N, S, H, W, latent_dim=128, input_dim=456, hidden_size=384,
                          corr_levels=4, corr_radius=3, iters=4, static_iters=2, time_depth=6,
                          space_depth=6, time_depth_dyn=3, space_depth_dyn=3, motion_hidden=256,
                          new_frames=2, stride=4) -> Dict[str, float]:
    h4, w4 = H // stride, W // stride
    C = latent_dim
    it_total = iters + static_iters
    out = {
        "fnet": new_frames * basic_encoder(H, W, cin=4, C=C),
        "embed_conv": new_frames * conv2d(h4, w4, C + 63, C, 3),
        "corr_sampling": it_total * corr_sampling(N, S, corr_levels, corr_radius, C),
        "flow_mlp": it_total * dense(N * S, 3 * 64 + 3, 130),
        "updateformer_main": iters * updateformer(N, S, input_dim, hidden_size, C + 3,
                                                  time_depth, space_depth),
        "updateformer_dyn": static_iters * updateformer(N, S, input_dim, hidden_size, C + 3,
                                                        time_depth_dyn, space_depth_dyn),
        "feat_updater": it_total * dense(N * S, C, C),
        "heads": dense(N * S, C, 1) + dense(N * S, C, motion_hidden) + dense(N * S, motion_hidden, 1),
    }
    out["total"] = float(sum(out.values()))
    return out


def append_flops(model: dict, slam: dict, new_frames: int) -> float:
    """One tracker append at a configuration: S_slam/kf_stride query frames
    of PATCHES_PER_FRAME tracks, the static branch left out (the adapter
    skips it unless a static merge reads it), `new_frames` frames encoded
    (the rest come from the previous append's features)."""
    static = model["static_iters"] if (model["use_static_mask"] or model["use_static"]) else 0
    H, W = model["interp_shape"]
    corr = model["corr_levels"] * (2 * model["corr_radius"] + 1) ** 2
    return tracker_forward_flops(
        N=slam["S_slam"] // slam["kf_stride"] * slam["PATCHES_PER_FRAME"], S=model["S"], H=H, W=W,
        latent_dim=model["latent_dim"], input_dim=130 + corr + model["latent_dim"] + 2,
        hidden_size=model["hidden_size"], corr_levels=model["corr_levels"],
        corr_radius=model["corr_radius"], iters=model["I"], static_iters=static,
        time_depth=model["time_depth"], space_depth=model["space_depth"],
        time_depth_dyn=model["time_depth_dyn"], space_depth_dyn=model["space_depth_dyn"],
        new_frames=new_frames, stride=model["model_stride"])["total"]


def pyramid_shapes(model: dict):
    H, W = model["interp_shape"]
    s = model["model_stride"]
    return [(H // s // 2 ** l, W // s // 2 ** l) for l in range(model["corr_levels"])]

