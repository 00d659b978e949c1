"""Slot-structured bundle adjustment (counterpart of
batrack_tpu/ba/slot_solver.py).

The factor graph is a ring of dense append blocks; an edge is (slot r,
source slot qs, patch m, target frame s) with
  source frame  i = slot_start[r] + qs * kf_stride
  target frame  j = slot_start[r] + s
  patch id      k = i * M + m.
Per-group (r, qs, s) geometry is tiny; per-edge arrays are component-wise
(R, NS, S, M) tensors. The JAX package reduces groups into pose blocks with
one-hot matmuls (a TPU layout choice); here the same sums are index_add_
into a buffer with one spare row that collects the dropped indices, so the
sums agree to float32 rounding of a different order.

Frame indices that the host knows (t0, n, the depth-window start) are
Python ints.

With a mesh the system shards either axis, as the JAX package's
shard_mode does: "patches" (every caller's choice: each rank holds a
shard of the patches of every frame, parallel/sharded_slot_ba.py) or
"slots" (the function's default, as in JAX: each rank holds a contiguous
block of ring slots with every patch, parallel/sharded_slot_ba.py::
shard_slots).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from batrack_tpu_torch.ba.solver import all_reduce_sum, redamped_solve, robust_weight, segment_sum
from batrack_tpu_torch.geometry import se3
from batrack_tpu_torch.utils.profiling import tracer


class SlotGraph(NamedTuple):
    """Dense factor-graph snapshot (shapes fixed by the config)."""

    targets: torch.Tensor     # (R, NS, M, S, 2) tracked 2D targets
    weights: torch.Tensor     # (R, NS, M, S, 2)
    valid: torch.Tensor       # (R, NS, M, S)
    slot_start: torch.Tensor  # (R,) window start frame per slot; -1 = empty


def _rot(q, v):
    """Rotate component tuple v = (x, y, z) by quaternion components
    q = (qx, qy, qz, qw): v + w t + q x t with t = 2 q x v."""
    qx, qy, qz, qw = q
    vx, vy, vz = v
    tx = 2.0 * (qy * vz - qz * vy)
    ty = 2.0 * (qz * vx - qx * vz)
    tz = 2.0 * (qx * vy - qy * vx)
    ox = vx + qw * tx + (qy * tz - qz * ty)
    oy = vy + qw * ty + (qz * tx - qx * tz)
    oz = vz + qw * tz + (qx * ty - qy * tx)
    return ox, oy, oz


def slot_ba_iteration(
    poses: torch.Tensor,       # (N, 7)
    patches: torch.Tensor,     # (N*M, 3)
    monodisp: torch.Tensor,    # (N*M,)
    intrinsics: torch.Tensor,  # (N, 4)
    graph: SlotGraph,
    t0: int,
    n: int,
    base_k: int,               # first patch id of the depth window
    **kw,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One damped Gauss-Newton step over the dense slot graph (flat-patch
    wrapper of slot_ba_iteration_fm)."""
    Nf = poses.shape[0]
    M = graph.targets.shape[2]
    poses_out, p_fm = slot_ba_iteration_fm(
        poses, patches.reshape(Nf, M, 3), monodisp.reshape(Nf, M),
        intrinsics, graph, t0, n, base_k // M, **kw,
    )
    return poses_out, p_fm.reshape(Nf * M, 3)


def slot_ba_iteration_fm(
    poses: torch.Tensor,        # (N, 7)
    patches_fm: torch.Tensor,   # (N, M, 3) frame-major patch block
    monodisp_fm: torch.Tensor,  # (N, M)
    intrinsics: torch.Tensor,   # (N, 4)
    graph: SlotGraph,
    t0: int,
    n: int,
    base_f: int,                # first frame of the depth window
    *,
    window: int,
    patch_window: int,
    patches_per_frame: int,
    kf_stride: int,
    bounds: Tuple[float, float, float, float],
    ep: float = 10.0,
    lmbda: float = 1e-4,
    lm: float = 1e-4,
    alpha: float = 0.05,
    loss: str = "huber",
    structure_only: bool = False,
    mesh=None,
    shard_mode: str = "slots",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One damped Gauss-Newton step over the dense slot graph.

    With `mesh` set (the JAX package's axis_name), shard_mode says which
    axis of the graph this rank holds a shard of; each reduction is one
    all_reduce of one flat buffer:

      * "slots": the slot axis R (parallel/sharded_slot_ba.py::shard_slots)
        with every patch, so the per-patch pieces E, C, w and the edge
        counts are summed over the ranks with the pose blocks B and v, and
        the prior, Schur complement and solves then run replicated;
      * "patches" (every caller's choice, in both packages): the patch axis
        M of patches_fm, monodisp_fm and the graph, all slots
        (parallel/sharded_slot_ba.py): C, w and E are complete locally;
        only B, v and the Schur terms E Q E^T and E Q w are summed, before
        the replicated pose solve, and the depth update stays local."""
    if shard_mode not in ("slots", "patches"):
        raise ValueError(f"shard_mode={shard_mode!r} (slots or patches)")
    R, NS, M, S, _ = graph.targets.shape
    W = window
    PF = patch_window
    K = PF * M
    Nf = poses.shape[0]
    dtype, dev = poses.dtype, poses.device

    tr = tracer()
    with tr.span("ba.linearize"):
        # ---- per-group geometry (tiny) --------------------------------------
        slot_ok = graph.slot_start >= 0
        i_fr = graph.slot_start[:, None] + torch.arange(NS, device=dev) * kf_stride  # (R, NS)
        j_fr = graph.slot_start[:, None] + torch.arange(S, device=dev)               # (R, S)
        i_cl = i_fr.clamp(0, Nf - 1)
        j_cl = j_fr.clamp(0, Nf - 1)
        Gi = poses[i_cl]                                      # (R, NS, 7)
        Gj = poses[j_cl]                                      # (R, S, 7)
        Gij = se3.mul(Gj[:, None, :, :], se3.inv(Gi)[:, :, None, :])  # (R, NS, S, 7)
        intr_i = intrinsics[i_cl]
        intr_j = intrinsics[j_cl]

        # ---- patch back-projection (per source group, broadcast over s) -----
        P = patches_fm[i_cl]                                  # (R, NS, M, 3)
        xn = (P[..., 0] - intr_i[..., 2:3]) / intr_i[..., 0:1]
        yn = (P[..., 1] - intr_i[..., 3:4]) / intr_i[..., 1:2]
        dsp = P[..., 2]

        g = Gij[..., None]                                    # (R, NS, S, 7, 1)
        tx, ty, tz = g[..., 0, :], g[..., 1, :], g[..., 2, :]
        q = (g[..., 3, :], g[..., 4, :], g[..., 5, :], g[..., 6, :])

        one = torch.ones_like(xn[:, :, None, :])
        Xr, Yr, Zr = _rot(q, (xn[:, :, None, :], yn[:, :, None, :], one))
        H = dsp[:, :, None, :]
        X = Xr + H * tx
        Y = Yr + H * ty
        Z = Zr + H * tz
        H = H.expand(X.shape)

        fx = intr_j[:, None, :, 0, None]                      # (R, 1, S, 1)
        fy = intr_j[:, None, :, 1, None]
        cx = intr_j[:, None, :, 2, None]
        cy = intr_j[:, None, :, 3, None]

        zinv = 1.0 / torch.clamp(Z, min=1e-2)
        x1 = fx * X * zinv + cx
        y1 = fy * Y * zinv + cy

        # ---- residuals + gates ------------------------------------------------
        tgt = graph.targets.movedim(2, 3)                     # (R, NS, S, M, 2)
        wgt = graph.weights.movedim(2, 3)
        val = graph.valid.movedim(2, 3)                       # (R, NS, S, M)

        rx = tgt[..., 0] - x1
        ry = tgt[..., 1] - y1
        v = (Z > 0.2).to(dtype)
        rsq = torch.nan_to_num(rx * rx + ry * ry, nan=float("inf"))
        v = v * (torch.sqrt(rsq) < 250.0)
        v = v * ((x1 > bounds[0]) & (y1 > bounds[1]) & (x1 < bounds[2]) & (y1 < bounds[3]))
        v = v * val * slot_ok[:, None, None, None]
        v = v * torch.isfinite(rx) * torch.isfinite(ry)
        live_i = i_fr[:, :, None, None]
        live_j = j_fr[:, None, :, None]
        v = v * (live_i < n) * (live_j < n)
        # edges whose source patch left the removal window are deleted in the
        # reference (keyframe_simple): gate them out of the pose system too
        v = v * (live_i >= base_f)

        # where() instead of multiplication: 0 * NaN would poison the sums
        gate = v > 0
        zero = torch.zeros((), dtype=dtype, device=dev)
        wx = torch.where(gate, wgt[..., 0] * robust_weight(rx, loss), zero)
        wy = torch.where(gate, wgt[..., 1] * robust_weight(ry, loss), zero)
        rx = torch.where(gate, rx, zero)
        ry = torch.where(gate, ry, zero)

        # ---- Jacobian components (projective_ops.py:83-98, expanded) --------
        big = Z.abs() > 0.2
        d = torch.where(big, 1.0 / torch.where(big, Z, torch.ones_like(Z)), zero)
        d2 = d * d
        zH = torch.zeros_like(H)
        Jj = [
            [fx * d * H, zH, -fx * X * d2 * H,
             -fx * X * Y * d2, fx * d * Z + fx * X * X * d2, -fx * d * Y],
            [zH, fy * d * H, -fy * Y * d2 * H,
             -fy * d * Z - fy * Y * Y * d2, fy * X * Y * d2, fy * d * X],
        ]
        Jz = [fx * d * tx - fx * X * d2 * tz, fy * d * ty - fy * Y * d2 * tz]

        # Ji = -AdjT(Gij) Jj rowwise: [-R^T a_t, -R^T (a_w - t x a_t)]
        qc = (-q[0], -q[1], -q[2], q[3])
        Ji = []
        for c in range(2):
            at = (Jj[c][0], Jj[c][1], Jj[c][2])
            aw = (Jj[c][3], Jj[c][4], Jj[c][5])
            cxp = (
                aw[0] - (ty * at[2] - tz * at[1]),
                aw[1] - (tz * at[0] - tx * at[2]),
                aw[2] - (tx * at[1] - ty * at[0]),
            )
            r1 = _rot(qc, at)
            r2 = _rot(qc, cxp)
            Ji.append([-r1[0], -r1[1], -r1[2], -r2[0], -r2[1], -r2[2]])

        G_ = R * NS * S

        def stk(rows):  # -> (2, 6, G, M)
            return torch.stack(
                [torch.stack([a.expand(R, NS, S, M).reshape(G_, M) for a in row]) for row in rows]
            )

        Ji_t = stk(Ji)
        Jj_t = stk(Jj)
        Jz_t = torch.stack([a.reshape(G_, M) for a in Jz])    # (2, G, M)
        w_t = torch.stack([wx.reshape(G_, M), wy.reshape(G_, M)])
        r_t = torch.stack([rx.reshape(G_, M), ry.reshape(G_, M)])

        wJi = w_t[:, None] * Ji_t
        wJj = w_t[:, None] * Jj_t

        def blocks(A, Bm):
            return torch.einsum("cagm,cbgm->gab", A, Bm)

        Bii = blocks(wJi, Ji_t)
        Bij = blocks(wJi, Jj_t)
        Bji = blocks(wJj, Ji_t)
        Bjj = blocks(wJj, Jj_t)
        vi = torch.einsum("cagm,cgm->ga", wJi, r_t)
        vj = torch.einsum("cagm,cgm->ga", wJj, r_t)
        Eik = torch.einsum("cagm,cgm->gam", wJi, Jz_t)        # (G, 6, M)
        Ejk = torch.einsum("cagm,cgm->gam", wJj, Jz_t)
        Ck = torch.einsum("cgm,cgm->gm", w_t * Jz_t, Jz_t)    # (G, M)
        wk = torch.einsum("cgm,cgm->gm", w_t * Jz_t, r_t)

    with tr.span("ba.assemble"):
        # ---- assembly: segment sums over tiny index sets --------------------
        i_loc = (i_fr - t0)[:, :, None].expand(R, NS, S).reshape(G_)
        j_loc = (j_fr - t0)[:, None, :].expand(R, NS, S).reshape(G_)
        f_loc = (i_fr - base_f)[:, :, None].expand(R, NS, S).reshape(G_)

        def pose_pair(a, b):
            okp = (a >= 0) & (a < W) & (b >= 0) & (b < W)
            return torch.where(okp, a * W + b, torch.full_like(a, W * W))

        pair_ids = torch.cat([
            pose_pair(i_loc, i_loc), pose_pair(i_loc, j_loc),
            pose_pair(j_loc, i_loc), pose_pair(j_loc, j_loc),
        ])
        all_blocks = torch.cat([Bii, Bij, Bji, Bjj]).reshape(4 * G_, 36)
        B = segment_sum(W * W, pair_ids, all_blocks).reshape(W, W, 6, 6)

        def in_win(a):
            return torch.where((a >= 0) & (a < W), a, torch.full_like(a, W))

        vvec = segment_sum(W, torch.cat([in_win(i_loc), in_win(j_loc)]),
                            torch.cat([vi, vj]))               # (W, 6)

        f_ok = (f_loc >= 0) & (f_loc < PF)

        def ek_ids(rows):
            okp = (rows >= 0) & (rows < W) & f_ok
            return torch.where(okp, rows * PF + f_loc, torch.full_like(rows, W * PF))

        ek_pair = torch.cat([ek_ids(i_loc), ek_ids(j_loc)])
        ek_vals = torch.cat([Eik, Ejk]).reshape(2 * G_, 6 * M)
        E_mat = segment_sum(W * PF, ek_pair, ek_vals).reshape(W, PF, 6, M)
        E_mat = E_mat.movedim(2, 3).reshape(W, K, 6)

        f_ids = torch.where(f_ok, f_loc, torch.full_like(f_loc, PF))
        C = segment_sum(PF, f_ids, Ck).reshape(K)
        wvec = segment_sum(PF, f_ids, wk).reshape(K)
        # edge PRESENCE (not gated validity): the reference's unique(kk) counts
        # every edge in the buffers, so a fully gated patch is still pulled to
        # the mono prior
        present = (val * slot_ok[:, None, None, None] * (live_i < n) * (live_j < n)
                   * (live_i >= base_f))
        edge_counts = segment_sum(PF, f_ids, present.reshape(G_, M).to(dtype)).reshape(K)
        if mesh is not None and shard_mode == "slots":
            B, E_mat, C, wvec, vvec, edge_counts = all_reduce_sum(
                mesh, B, E_mat, C, wvec, vvec, edge_counts)

    with tr.span("ba.solve"):
        # ---- prior + Schur + solve ------------------------------------------
        rows_pf = (base_f + torch.arange(PF, device=dev)).clamp(0, Nf - 1)
        disps_k = patches_fm[..., 2][rows_pf].reshape(K)
        sens_k = monodisp_fm[rows_pf].reshape(K)
        mprior = (sens_k > 1e-2).to(dtype)

        C_adj = C + mprior * alpha + lmbda
        w_adj = wvec - mprior * alpha * (disps_k - sens_k)
        has_edge = edge_counts > 0
        Q = 1.0 / C_adj

        if structure_only:
            dZ = Q * w_adj * has_edge
            poses_out = poses
        else:
            E2 = E_mat.transpose(1, 2).reshape(W * 6, K)
            EQE = (E2 * Q[None, :]) @ E2.T
            Ew = E2 @ (Q * w_adj)
            if mesh is not None and shard_mode == "patches":
                B, vvec, EQE, Ew = all_reduce_sum(mesh, B, vvec, EQE, Ew)
            Sm = B.permute(0, 2, 1, 3).reshape(W * 6, W * 6) - EQE
            y = vvec.reshape(W * 6) - Ew

            dx = redamped_solve(Sm, y, ep, lm)
            dX = dx.reshape(W, 6)
            dZ = Q * (w_adj - E2.T @ dx) * has_edge

            free = (torch.arange(W, device=dev) < (n - t0))[:, None]
            dX = torch.where(free, dX, zero)
            full_dx = torch.zeros((Nf, 6), dtype=dtype, device=dev)
            hi = min(Nf, t0 + W)
            full_dx[t0:hi] += dX[: hi - t0]
            poses_out = se3.retr(poses, full_dx)

        hi = min(Nf, base_f + PF)
        disps = patches_fm[..., 2].clone()
        disps[base_f:hi] += dZ.reshape(PF, M)[: hi - base_f]
        patches_out = patches_fm.clone()
        patches_out[..., 2] = disps.clamp(1e-3, 10.0)
        return poses_out, patches_out
