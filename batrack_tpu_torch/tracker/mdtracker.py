"""MDTracker: motion-decoupled 3D point tracker on PyTorch (counterpart of
batrack_tpu/tracker/mdtracker.py; reference main/frontend/md_tracker.py).

Sliding-window RGB-D transformer tracking with a total-motion branch, a
per-track motion label and a dynamic-component refinement branch. The
correlation windows come from the fused gather-contract of K1
(ops/corr_kernel.py) or its plain S-major version (ops/corr.py); the space
attention goes through K2 (ops/attention.py). Parameter names follow the
reference checkpoint, including its scrambled track_mask/vis concat.

With a `mesh` (the multi-device path, parallel/) the per-track state stays
full and replicated on every rank; each refinement step runs the
correlation, the flow embedding and the transformer on this rank's tracks
only (parallel/mesh.py::shard_rows, padded to a multiple of the world
size) and all-gathers the transformer's output.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from batrack_tpu_torch.ops.corr import build_pyramid, corr_sample_pyramid
from batrack_tpu_torch.ops.corr_kernel import corr_sample, pack_pyramid
from batrack_tpu_torch.ops.embeddings import (
    FourierEmbedder,
    get_1d_sincos_pos_embed_from_grid,
    get_2d_sincos_pos_embed,
    get_3d_embedding,
)
from batrack_tpu_torch.ops.sampling import bilinear_sample2d, bilinear_sample_per_frame
from batrack_tpu_torch.parallel.mesh import gather_rows, shard_rows
from batrack_tpu_torch.parallel.shard_kernels import corr_sample_pyramid_sharded
from batrack_tpu_torch.tracker.blocks import (
    BasicEncoder,
    Conv2d,
    GroupNorm1,
    Linear,
    MotionLabelMLP,
    UpdateFormer,
)
from batrack_tpu_torch.utils.config import ModelConfig
from batrack_tpu_torch.utils.profiling import tracer


class TrackerParams(NamedTuple):
    """Architecture hyperparameters (ModelConfig subset)."""

    S: int = 12
    stride: int = 4
    latent_dim: int = 128
    hidden_size: int = 384
    input_dim: int = 456
    num_heads: int = 8
    space_depth: int = 6
    time_depth: int = 6
    space_depth_dyn: int = 3
    time_depth_dyn: int = 3
    corr_levels: int = 4
    corr_radius: int = 3
    iters: int = 4
    static_iters: int = 2
    add_space_attn: bool = True
    dynamic_mask_detach: bool = True
    use_log_depth: bool = False
    interp_shape: Tuple[int, int] = (384, 512)
    use_corr_kernel: bool = False       # K1 for the correlation windows
    use_attention_kernel: bool = False  # K2 for long space attention
    kernel_threshold: int = 1024        # min track count for K2

    @classmethod
    def from_config(cls, m: ModelConfig) -> "TrackerParams":
        return cls(
            S=m.S, stride=m.model_stride, latent_dim=m.latent_dim,
            hidden_size=m.hidden_size, num_heads=m.num_heads,
            space_depth=m.space_depth, time_depth=m.time_depth,
            space_depth_dyn=m.space_depth_dyn, time_depth_dyn=m.time_depth_dyn,
            corr_levels=m.corr_levels, corr_radius=m.corr_radius, iters=m.I,
            static_iters=m.static_iters, add_space_attn=m.add_space_attn,
            dynamic_mask_detach=m.dynamic_mask_detach,
            use_log_depth=m.use_log_depth, interp_shape=tuple(m.interp_shape),
            use_corr_kernel=m.use_pallas_corr,
            use_attention_kernel=m.use_flash_attention,
        )


def _scrambled_concat(track_mask: torch.Tensor, vis: torch.Tensor, cnt=None) -> torch.Tensor:
    """The reference fix_track_mask=False concat (md_tracker.py:280-285).

    torch.cat([track_mask, vis], dim=2) on (1, S, cnt, 1), then
    permute(0, 2, 1, 3).reshape(cnt, S, 2), interleaves adjacent tracks and
    frames: output row n, frame s, channel c reads logical channel
    k = 2n + (2s+c)//S of the [track_mask | vis] axis at frame (2s+c) % S.
    The reference builds it on the first `cnt` sorted tracks, so callers pass
    columns in sorted order plus the active count; rows n >= cnt are
    garbage, like the reference's absent rows.

    track_mask, vis: (S, N). Returns (N, S, 2).
    """
    S, N = track_mask.shape
    if cnt is None:
        cnt = N
    sc = 2 * np.arange(S)[None, :, None] + np.arange(2)[None, None, :]
    dev = track_mask.device
    k = torch.as_tensor(2 * np.arange(N)[:, None, None] + sc // S, device=dev)
    f = torch.as_tensor(sc % S, device=dev).expand(k.shape)
    tm_val = track_mask[f, k.clamp(0, N - 1)]
    vis_val = vis[f, (k - cnt).clamp(0, N - 1)]
    return torch.where(k < cnt, tm_val, vis_val)


class MDTracker(nn.Module):
    """The tracker network (submodule names mirror the torch checkpoint).

    mesh: optional parallel.mesh.Mesh; the track axis is sharded over it
    (module note)."""

    def __init__(self, p: TrackerParams, mesh=None):
        super().__init__()
        self.p = p
        self.mesh = mesh
        out_dim = p.latent_dim + 3

        def former(space, time):
            return UpdateFormer(
                space_depth=space, time_depth=time, input_dim=p.input_dim,
                hidden_size=p.hidden_size, num_heads=p.num_heads,
                output_dim=out_dim, add_space_attn=p.add_space_attn,
                use_kernel=p.use_attention_kernel,
                kernel_threshold=p.kernel_threshold, mesh=mesh)

        self.fnet = BasicEncoder(output_dim=p.latent_dim, stride=p.stride)
        self.updateformer = former(p.space_depth, p.time_depth)
        self.updateformer_dyn = former(p.space_depth_dyn, p.time_depth_dyn)
        self.norm = GroupNorm1(p.latent_dim)
        self.ffeat_updater = nn.Sequential(Linear(p.latent_dim, p.latent_dim), nn.GELU())
        self.vis_predictor = nn.Sequential(Linear(p.latent_dim, 1))
        self.motion_label_block = MotionLabelMLP(p.latent_dim, 256, pool_S=p.S)
        self.embed3d = FourierEmbedder(input_dim=3, max_freq_log2=10.0, N_freqs=10)
        self.embedConv = Conv2d(p.latent_dim + self.embed3d.out_dim, p.latent_dim, 3, padding=1)
        self.zeroMLPflow = Linear(3 * 64 + 3, 130)

    # ------------------------------------------------------------------
    def depth_process(self, d):
        return torch.log(torch.clamp(d, min=1e-3)) if self.p.use_log_depth else d

    def depth_process_inv(self, d):
        return torch.exp(d) if self.p.use_log_depth else d

    def encode_window(self, rgbs: torch.Tensor, depths_dnG: torch.Tensor,
                      z_stats=None) -> torch.Tensor:
        """fnet + Fourier xyz positional fusion (md_tracker.py:519-546).

        rgbs: (S, 3, H, W) in [-1, 1]; depths_dnG: (S, H/4, W/4) depth in
        [0, Dz] grid units. Returns fmaps (S, C, H/4, W/4). z_stats: the full
        window's (zmin, zmax) when only part of the window is encoded.
        """
        tr = tracer()
        tr.count("tracker.encoded_frames", rgbs.shape[0])
        with tr.span("tracker.encode"):
            S, _, H, W = rgbs.shape
            h4, w4 = H // self.p.stride, W // self.p.stride
            fmaps = self.fnet(rgbs)
            dev = rgbs.device
            gxx = torch.arange(w4, dtype=torch.float32, device=dev)[None, None, :].expand(S, h4, w4)
            gyy = torch.arange(h4, dtype=torch.float32, device=dev)[None, :, None].expand(S, h4, w4)

            def norm01(v, stats=None):
                vmin = v.min() if stats is None else stats[0]
                vmax = v.max() if stats is None else stats[1]
                return 2.0 * ((v - vmin) / torch.clamp(vmax - vmin, min=1e-12) - 0.5)

            xyz = torch.stack([norm01(gxx), norm01(gyy), norm01(depths_dnG, z_stats)], dim=-1)
            featPE = self.embed3d(xyz).permute(0, 3, 1, 2)     # (S, 63, h4, w4)
            return self.embedConv(torch.cat([fmaps, featPE], dim=1))

    # ------------------------------------------------------------------
    def forward_iteration(self, fmaps, coords_init, coords_dyn_init, feat_init,
                          concat, d_near, d_far, Dz: float, key_mask=None,
                          static_iters: Optional[int] = None):
        """One window's iterative refinement (md_tracker.py:181-413).

        fmaps (S, C, h4, w4); coords (S, N, 3) in grid units; feat_init
        (S, N, C); concat (N, S, 2) pre-scrambled mask/vis channels.
        Returns (coord_pred, depth_pred, static_out, vis_logits, dyn_logit,
        iter_preds): iter_preds holds each iteration's coord and depth
        predictions and each static iteration's output, for the training
        losses. The coords are detached at each iteration, as in the JAX
        package and the reference's training graph (md_tracker.py:249).
        """
        p, mesh = self.p, self.mesh
        S, C, h4, w4 = fmaps.shape
        N = coords_init.shape[1]
        dev = fmaps.device
        tr = tracer()
        with tr.span("tracker.pyramid"):
            pyramid = build_pyramid(fmaps, p.corr_levels)
            # corr_nsc(ffeats (N, S, C), coords (S, N, 2)) -> (N', S, LRR) for
            # the N' tracks this rank works on: all of them, or its shard
            if p.use_corr_kernel:
                pyr = pack_pyramid(pyramid)  # bf16, packed once for all iterations

                def corr_nsc(ffeats_ns, cxy):
                    if mesh is not None:
                        return corr_sample_pyramid_sharded(pyr, ffeats_ns.float(), cxy.float(),
                                                           p.corr_radius, mesh)
                    return corr_sample(pyr, ffeats_ns.float(), cxy.float(), p.corr_radius)
            else:
                pyr32 = [fm.float() for fm in pyramid]

                def corr_nsc(ffeats_ns, cxy):
                    if mesh is not None:
                        ffeats_ns, cxy = shard_rows(ffeats_ns, mesh), shard_rows(cxy, mesh, 1)
                    fc = corr_sample_pyramid(pyr32, ffeats_ns.float().transpose(0, 1),
                                             cxy, p.corr_radius)
                    return fc.transpose(0, 1)
        with tr.span("tracker.pos_embed"):
            if mesh is not None and (key_mask is not None or N % mesh.size):
                # this rank's keys; padded tracks are masked out of every softmax
                full = torch.ones(N, dtype=torch.bool, device=dev) if key_mask is None else key_mask
                key_mask = shard_rows(full, mesh)

            # track features stay track-major (N, S, C), the transformer layout
            ffeats = feat_init.transpose(0, 1)
            ffeats_static = ffeats

            with tr.span("tracker.pos_table"):      # the numpy table alone, host
                table = get_2d_sincos_pos_embed(p.input_dim, (h4, w4))
            pos_grid = torch.as_tensor(table, dtype=torch.float32, device=dev).reshape(
                h4, w4, p.input_dim).permute(2, 0, 1)[None]

            def sample_pos(c0):  # (N, 2) grid units -> (N, E)
                return bilinear_sample2d(pos_grid, c0[None, :, 0], c0[None, :, 1])[0].T

            pos_embed = sample_pos(coords_init[0, :, :2])
            pos_embed_static = sample_pos((coords_init - coords_dyn_init)[0, :, :2])
            times_embed = torch.as_tensor(
                get_1d_sincos_pos_embed_from_grid(p.input_dim, np.linspace(0, p.S - 1, p.S)),
                dtype=torch.float32, device=dev)

        def denorm(c):
            out_xy = c[..., :2] * float(p.stride)
            out_d = self.depth_process_inv(c[..., 2] / Dz * (d_far - d_near) + d_near)
            return out_xy, out_d

        def one_iter(coords, ffeats_ns, pe, transformer):
            with tr.span("tracker.corr"):
                fcorrs = corr_nsc(ffeats_ns, coords[..., :2])        # (N', S, LRR)
            with tr.span("tracker.embed"):
                flows = (coords - coords[0:1]).transpose(0, 1)        # (N, S, 3)
                cc = concat
                if mesh is not None:
                    flows, ffeats_ns, cc, pe = (shard_rows(a, mesh)
                                                for a in (flows, ffeats_ns, cc, pe))
                flows_cat = self.zeroMLPflow(get_3d_embedding(flows, 64, cat_coords=True))
                x = torch.cat([flows_cat.float(), fcorrs, ffeats_ns.float(), cc], dim=-1)
                x = x + pe[:, None, :] + times_embed[None, :, :]
            with tr.span("tracker.former"):
                delta = transformer(x[None], key_mask)[0]             # (N', S, C+3)
                if mesh is not None:
                    delta = gather_rows(delta, mesh, N)
            return delta[..., :3].transpose(0, 1), delta[..., 3:]

        # GroupNorm(1, C) runs on flattened (N*S, C) rows, as in the
        # reference; torch Sequential(Linear, GELU) applies exact GELU
        def feat_update(ffeats_ns, d_feats):
            N_, S_, C_ = d_feats.shape
            normed = self.norm(d_feats.reshape(-1, C_)).reshape(N_, S_, C_)
            return self.ffeat_updater(normed) + ffeats_ns

        coords = coords_init
        coord_pred = depth_pred = None
        coord_preds, depth_preds, static_preds = [], [], []
        for _ in range(p.iters):
            coords = coords.detach()
            d_coords, d_feats = one_iter(coords, ffeats, pos_embed, self.updateformer)
            with tr.span("tracker.feat_update"):
                ffeats = feat_update(ffeats, d_feats)
                coords = coords + d_coords
                coord_pred, depth_pred = denorm(coords)
                coord_preds.append(coord_pred)
                depth_preds.append(depth_pred)

        n_static = p.static_iters if static_iters is None else static_iters
        with tr.span("tracker.heads"):
            vis_e = self.vis_predictor(ffeats)[..., 0].T               # (S, N) logits
            dyn_logit = self.motion_label_block(ffeats[None])[0, :, 0]  # (N,)
            dyn_mask = torch.sigmoid(dyn_logit)
            if p.dynamic_mask_detach:
                dyn_mask = dyn_mask.detach()
            coords_total = coords.detach()
            if not n_static:
                out_xy, out_d = denorm(coords_total)
                static_out = torch.cat([out_xy, out_d[..., None]], dim=-1)

        if n_static:
            with tr.span("tracker.static"):
                coords_dyn = coords_dyn_init
                for _ in range(n_static):
                    coords_dyn = coords_dyn.detach()
                    coords_static = (coords_total - coords_dyn).detach()
                    d_coords, d_feats = one_iter(coords_static, ffeats_static, pos_embed_static,
                                                 self.updateformer_dyn)
                    ffeats_static = feat_update(ffeats_static, d_feats)
                    coords_dyn = coords_dyn + d_coords
                    out_xy, out_d = denorm(coords_total - coords_dyn * dyn_mask[None, :, None])
                    static_out = torch.cat([out_xy, out_d[..., None]], dim=-1)
                    static_preds.append(static_out)
        return (coord_pred, depth_pred, static_out, vis_e, dyn_logit,
                (coord_preds, depth_preds, static_preds))

    # ------------------------------------------------------------------
    def forward(self, rgbds: torch.Tensor, queries: torch.Tensor,
                prev_fmaps: Optional[torch.Tensor] = None, reuse: int = 0,
                static_iters: Optional[int] = None, train: bool = False):
        """Full sliding-window forward (md_tracker.py:416-671).

        rgbds (T, 4, H, W) rgb 0..255 + metric depth; queries (N, 4)
        [t, x, y, depth] in pixels. prev_fmaps/reuse: cross-call feature
        cache; the first window reuses prev_fmaps shifted by `reuse` frames
        and encodes only the new ones. static_iters overrides the number of
        static-branch iterations (0 when the caller discards that branch).

        Returns (traj (T, N, 2), depth (T, N), traj_static (T, N, 3),
        vis (T, N) sigmoid, dynamic (T, N) sigmoid, fmaps of the last window).

        train=True appends the JAX package's train_data dict (the
        reference's is_train outputs, md_tracker.py:646-667), stacked over
        windows: inds (n_wind,) numpy, active (n_wind, N), track_mask
        (n_wind, S, N), coords (n_wind, I, S, N, 2), depths (n_wind, I, S,
        N), statics (n_wind, I_static, S, N, 3), vis_logits (n_wind, S, N)
        and dyn_logits (n_wind, N). Gradients flow through the plain
        versions of K1 and K2 (CPU tensors); on the card their wrappers
        raise when autograd records, since the kernels have no backward.
        """
        p = self.p
        tr = tracer()
        with tr.span("tracker.setup"):
            T, _, H, W = rgbds.shape
            N = queries.shape[0]
            S = p.S
            Dz = float(W // p.stride)
            dev = rgbds.device
            f32 = torch.float32

            rgbs = 2.0 * (rgbds[:, :3] / 255.0) - 1.0
            depth_all = self.depth_process(rgbds[:, 3])
            if p.use_log_depth:
                d_near, d_far = depth_all.min(), depth_all.max()
            else:
                ok = depth_all > 0.01
                d_near = torch.where(ok, depth_all, torch.full_like(depth_all, float("inf"))).min()
                d_far = torch.where(ok, depth_all, torch.full_like(depth_all, float("-inf"))).max()
            # constant-depth windows would divide by zero (the reference does)
            d_far = torch.maximum(d_far, d_near + 1e-3)

            first_ind = queries[:, 0].to(torch.int32)
            # the scrambled concat couples adjacent tracks of the sorted layout
            # (sorted by first frame, md_tracker.py:426-431): build it there
            sort_perm = torch.argsort(first_ind, stable=True)
            inv_perm = torch.argsort(sort_perm)

            q_xy = queries[:, 1:3] / float(p.stride)
            q_d = (self.depth_process(queries[:, 3]) - d_near) / (d_far - d_near) * Dz
            coords0 = torch.cat([q_xy, q_d[:, None]], dim=-1)

            n_wind = max(1, int(np.ceil((T - S // 2) / (S // 2))))
            depths_dn = depth_all[:, :: p.stride, :: p.stride]
            depths_dn = (depths_dn - d_near) / (d_far - d_near) * Dz

            traj_e = torch.zeros((T, N, 2), dtype=f32, device=dev)
            depth_e = torch.zeros((T, N), dtype=f32, device=dev)
            static_e = torch.zeros((T, N, 3), dtype=f32, device=dev)
            vis_e = torch.zeros((T, N), dtype=f32, device=dev)
            dyn_e = torch.zeros((T, N), dtype=f32, device=dev)

            coords_init = coords0[None].expand(S, N, 3)
            coords_dyn_init = torch.zeros((S, N, 3), dtype=f32, device=dev)
            vis_init = torch.full((S, N), 10.0, dtype=f32, device=dev)
            feat_init = torch.zeros((S, N, p.latent_dim), dtype=f32, device=dev)
            prev_active = torch.zeros((N,), dtype=torch.bool, device=dev)
            fmaps = None

        train_windows = []
        for w in range(n_wind):
            tr.count("tracker.windows")
            with tr.span("tracker.window"):
                ind = w * (S // 2)
                frame_ids = torch.as_tensor(np.clip(ind + np.arange(S), 0, T - 1), device=dev)
                zwin = depths_dn[frame_ids]
                z_stats = (zwin.min(), zwin.max())
                if fmaps is None and prev_fmaps is not None and reuse >= S:
                    fmaps = prev_fmaps
                elif fmaps is None and prev_fmaps is not None and reuse > 0:
                    new_ids = frame_ids[S - reuse:]
                    fm_new = self.encode_window(rgbs[new_ids], depths_dn[new_ids], z_stats)
                    fmaps = torch.cat([prev_fmaps[reuse:], fm_new], dim=0)
                elif fmaps is None:
                    fmaps = self.encode_window(rgbs[frame_ids], depths_dn[frame_ids])
                else:
                    new_ids = frame_ids[S // 2:]
                    fm_new = self.encode_window(rgbs[new_ids], depths_dn[new_ids], z_stats)
                    fmaps = torch.cat([fmaps[S // 2:], fm_new], dim=0)

                active = first_ind < ind + S
                new = active & ~prev_active

                # features of newly active queries at their own first frame
                rel = (first_ind - ind).clamp(0, S - 1)
                fq = bilinear_sample_per_frame(fmaps.permute(0, 2, 3, 1), rel, coords0[:, :2])
                feat_init = torch.where(new[None, :, None], fq.float()[None].expand(S, N, -1),
                                        feat_init)

                # track mask: real frame, at/after the query's first frame, and
                # not consumed by the previous window (second half only)
                t_ids = torch.as_tensor(ind + np.arange(S), device=dev)
                tm = (t_ids[:, None] >= first_ind[None, :]) & (t_ids < T)[:, None]
                tm = tm & active[None, :]
                if w > 0:
                    second_half = (torch.arange(S, device=dev) >= S // 2)[:, None]
                    tm = tm & (second_half | ~prev_active[None, :])
                track_mask = tm.to(f32)

                cnt = active.to(torch.int64).sum()
                concat = _scrambled_concat(track_mask[:, sort_perm], vis_init[:, sort_perm],
                                           cnt)[inv_perm]
                key_mask = active if n_wind > 1 else None

            coord_p, depth_p, static_p, vis_p, dyn_logit, iter_preds = self.forward_iteration(
                fmaps, coords_init, coords_dyn_init, feat_init, concat,
                d_near, d_far, Dz, key_mask, static_iters)
            with tr.span("tracker.merge"):
                vis_p = vis_p.float()
                dyn_logit = dyn_logit.float()
                if train:
                    cps, dps, sps = iter_preds
                    train_windows.append({
                        "ind": ind, "active": active, "track_mask": track_mask,
                        "coords": torch.stack(cps), "depths": torch.stack(dps),
                        "statics": (torch.stack(sps) if sps
                                    else torch.zeros((0, S, N, 3), dtype=f32, device=dev)),
                        "vis_logits": vis_p, "dyn_logits": dyn_logit,
                    })

                # window results into the global timeline for active queries
                S_live = min(S, T - ind)
                tl = slice(ind, ind + S_live)
                a2 = active[None, :]
                traj_e[tl] = torch.where(a2[..., None], coord_p[:S_live], traj_e[tl])
                depth_e[tl] = torch.where(a2, depth_p[:S_live], depth_e[tl])
                static_e[tl] = torch.where(a2[..., None], static_p[:S_live], static_e[tl])
                vis_e[tl] = torch.where(a2, vis_p[:S_live], vis_e[tl])
                dyn_e[tl] = torch.where(a2, dyn_logit[None, :], dyn_e[tl])

                # hand off window state (md_tracker.py:580-615), including the
                # reference's double /stride on the dynamic component
                if w + 1 < n_wind:
                    half = S // 2
                    new_xy = coord_p[half:] / float(p.stride)
                    new_d = (self.depth_process(depth_p[half:]) - d_near) / (d_far - d_near) * Dz
                    new_coords = torch.cat([new_xy, new_d[..., None]], dim=-1)
                    carried = torch.cat([new_coords, new_coords[-1:].expand(half, N, 3)], dim=0)
                    coords_init = torch.where(active[None, :, None], carried, coords_init)

                    dyn_xy = (new_xy - static_p[half:, :, :2]) / float(p.stride)
                    dyn_d0 = new_d - static_p[half:, :, 2]
                    dyn_d = (self.depth_process(dyn_d0) - d_near) / (d_far - d_near) * Dz
                    new_dyn = torch.cat([dyn_xy, dyn_d[..., None]], dim=-1)
                    carried_dyn = torch.cat([new_dyn, new_dyn[-1:].expand(half, N, 3)], dim=0)
                    coords_dyn_init = torch.where(active[None, :, None], carried_dyn,
                                                  coords_dyn_init)

                    new_vis = vis_p[half:]
                    carried_vis = torch.cat([new_vis, new_vis[-1:].expand(half, N)], dim=0)
                    vis_init = torch.where(active[None, :], carried_vis, vis_init)
                prev_active = active

        outputs = (traj_e, depth_e, static_e, torch.sigmoid(vis_e), torch.sigmoid(dyn_e), fmaps)
        if not train:
            return outputs
        train_data = {"inds": np.asarray([tw["ind"] for tw in train_windows])}
        for k in ("active", "track_mask", "coords", "depths", "statics", "vis_logits",
                  "dyn_logits"):
            train_data[k] = torch.stack([tw[k] for tw in train_windows])
        return outputs + (train_data,)
