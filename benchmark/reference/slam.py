"""Plain SLAM-loop stages for the benchmark's reference: patch selection,
the motion model, the gate that turns tracks into factor-graph edges, the
dual bundle adjustment over the edge ring, map-point culling, the
point-cloud refresh and the trajectory a sequence ends with.

A frozen copy of the loop's semantics (BA-Track's batrack.py as the
measured program defines it, with its dense ring of append slots), written
over a dict of tensors. It imports nothing of the measured program.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from reference import geometry as g
from reference.tracker import bilinear_taps

REL_MARGIN = 0.15
NUM_EXPAND = 8


class Dims:
    """Sizes the configuration fixes."""

    def __init__(self, slam: dict, ht: int, wd: int):
        self.N = slam["BUFFER_SIZE"]
        self.M = slam["PATCHES_PER_FRAME"]
        self.S = slam["S_slam"]
        self.kf = slam["kf_stride"]
        self.n_src = self.S // self.kf
        self.S_local = 2 * self.S - 1
        self.ring = slam["REMOVAL_WINDOW"] // self.kf
        self.eps = self.n_src * self.M * self.S          # edges per append slot
        self.window = max(slam["OPTIMIZATION_WINDOW"], slam["num_init"]) + 1
        self.patch_window = slam["REMOVAL_WINDOW"]
        self.cloud_frames = min(self.N, max(slam["OPTIMIZATION_WINDOW"] + (self.S_local + 1) // 2,
                                            self.S) + 1)
        self.ht, self.wd = ht, wd
        self.grid = int(slam["PATCH_GEN"].split("_")[-1])


# ---- ingest -----------------------------------------------------------------

def draw_shape(dims: Dims):
    """The two uniform arrays (x, y) one frame's patch selection consumes."""
    num_grid = dims.grid * dims.grid
    return (num_grid, NUM_EXPAND * (dims.M // num_grid))


def select_patches(image: torch.Tensor, ux: torch.Tensor, uy: torch.Tensor, dims: Dims):
    """grid_grad selection: in each grid cell keep the candidates with the
    largest 4x4-pooled gradient magnitude. image (H, W, 3) float."""
    gsz, M = dims.grid, dims.M
    num_grid = gsz * gsz
    keep = M // num_grid
    h_cell, w_cell = dims.ht // gsz, dims.wd // gsz
    gray = image.sum(-1)
    pad = F.pad(gray, (1, 1, 1, 1))
    dx = pad[:-1, 1:] - pad[:-1, :-1]
    dy = pad[1:, :-1] - pad[:-1, :-1]
    grad = F.avg_pool2d(torch.sqrt(dx * dx + dy * dy)[None, None], 4, 4)[0, 0]
    cell = torch.arange(num_grid, device=image.device)
    xg = torch.round((ux * (1 - 2 * REL_MARGIN) + REL_MARGIN) * w_cell
                     + ((cell % gsz).float() * w_cell)[:, None])
    yg = torch.round((uy * (1 - 2 * REL_MARGIN) + REL_MARGIN) * h_cell
                     + ((cell // gsz).float() * h_cell)[:, None])
    score = bilinear_taps(grad[None], (xg / 4.0).reshape(-1), (yg / 4.0).reshape(-1))[:, 0]
    top = torch.argsort(score.reshape(xg.shape), dim=-1, stable=True)[:, -keep:]
    return torch.stack([torch.gather(xg, 1, top).reshape(-1),
                        torch.gather(yg, 1, top).reshape(-1)], -1)


def motion_model(poses: torch.Tensor, n: int, damping: float) -> None:
    if n == 1:
        poses[1] = poses[0]
    elif n > 1:
        P1, P2 = poses[n - 1], poses[n - 2]
        xi = damping * g.se3_log(g.se3_mul(P1, g.se3_inv(P2)))
        poses[n] = g.se3_mul(g.se3_exp(xi), P1)


# ---- the edge ring ---------------------------------------------------------------

class SlotRing:
    """Which ring slot each append writes: the oldest empty slot or slot
    whose source frames all left the removal window; over capacity, the
    oldest slot."""

    def __init__(self, dims: Dims, removal_window: int):
        self.dims, self.removal = dims, removal_window
        self.info: List[Optional[dict]] = [None] * dims.ring
        self.appends = 0

    def alloc(self, n: int) -> int:
        dims, dead = self.dims, n - self.removal
        best, best_seq = None, None
        for i, info in enumerate(self.info):
            if info is None:
                seq = -1
            elif all(s < dead for s in info["sources"]):
                seq = info["seq"]
            else:
                continue
            if best is None or seq < best_seq:
                best, best_seq = i, seq
        if best is None:
            best = min(range(len(self.info)), key=lambda i: self.info[i]["seq"])
        S = min(n, dims.S)
        self.info[best] = {"seq": self.appends,
                           "sources": [n - S + q * dims.kf for q in range(dims.n_src) if q * dims.kf < S]}
        self.appends += 1
        return best


def gate_and_append(st: Dict[str, torch.Tensor], queries, query_valid, win_start: int,
                    tracks, depths, vis, dynamic, n: int, slot: int, dims: Dims, slam: dict):
    """Tracks of one append -> the weights of its slot's edges and the
    local-trajectory rows, in place. queries (NQ, 4) [frame in window, x,
    y, depth]; tracks (S, NQ, 2) image pixels, depths/vis/dynamic (S, NQ)."""
    S_slam, M, kf, n_src, S_local = dims.S, dims.M, dims.kf, dims.n_src, dims.S_local
    dev = tracks.device
    S = min(n, S_slam)
    sid = queries[:, 0].long()
    ar_s = torch.arange(S_slam, device=dev)
    own = ar_s[:, None] == sid[None, :]
    finite = torch.isfinite(tracks).all(-1) & torch.isfinite(depths) & torch.isfinite(vis)
    tracks = torch.where(own[..., None], queries[None, :, 1:3],
                         torch.nan_to_num(tracks, nan=-1e4, posinf=1e4, neginf=-1e4))
    vis = torch.where(own, torch.ones_like(vis), torch.where(finite, torch.nan_to_num(vis),
                                                             torch.zeros_like(vis)))
    depths = torch.nan_to_num(depths, nan=1e-2, posinf=1e2, neginf=1e-2)
    live = (ar_s < S)[:, None] & query_valid[None, :]
    pad = slam["BOUNDARY_PADDING"]
    inside = ((tracks[..., 0] >= pad) & (tracks[..., 0] < dims.wd - pad)
              & (tracks[..., 1] >= pad) & (tracks[..., 1] < dims.ht - pad))
    vis_ok = (vis > slam["VIS_THRESHOLD"]) & inside & live
    static_e = 1.0 - torch.nan_to_num(dynamic, nan=1.0)
    q = torch.nanquantile(torch.where(live, static_e, torch.full_like(static_e, float("nan"))
                                      ).reshape(-1), 1.0 - slam["STATIC_QUANTILE"])
    static = (static_e >= torch.minimum(q, torch.tensor(slam["STATIC_THRESHOLD"], device=dev))) & live
    target = torch.cat([tracks, (1.0 / torch.clamp(depths, min=1e-2))[..., None]], -1)
    weight = vis_ok.float()
    if n >= slam["MIN_TRACK_LEN"]:
        long_enough = (weight > 0).sum(0) >= slam["MIN_TRACK_LEN"]
        weight = weight * long_enough[None, :]
    weight_pose = weight * static.float()

    ii = (win_start + torch.arange(n_src, device=dev) * kf)[:, None, None].expand(n_src, M, S_slam)
    jj = (win_start + ar_s)[None, None, :].expand(n_src, M, S_slam)
    kk = ii * M + torch.arange(M, device=dev)[None, :, None]

    def edge(x):  # (S, NQ, ...) -> (n_src * M * S, ...)
        x = x.movedim(0, 1)
        return x.reshape((n_src, M, S_slam) + x.shape[2:]).reshape((-1,) + x.shape[2:])

    rows = slice(slot * dims.eps, (slot + 1) * dims.eps)
    e_target, e_w, e_wp = edge(target), edge(weight), edge(weight_pose)
    e_valid = edge(live.float())
    st["e_target"][rows] = e_target
    st["e_weight"][rows] = e_w[:, None].expand(-1, 2)
    st["e_weight_pose"][rows] = e_wp[:, None].expand(-1, 2)
    st["e_valid"][rows] = e_valid
    st["e_kk"][rows] = kk.reshape(-1)
    st["e_jj"][rows] = jj.reshape(-1)
    st["slot_start"][slot] = win_start
    # local-trajectory rows: the BA reads their middle column as the depth
    # prior and the point-cloud refresh their weights
    mid = (S_local + 1) // 2 - 1
    lid = (jj - ii + mid).reshape(-1)
    ok = (lid >= 0) & (lid < S_local) & (e_valid > 0)
    k_rows = kk.reshape(-1)[ok] - st["row0"]
    st["local_targets"][k_rows, lid[ok]] = e_target[ok]
    st["local_weights"][k_rows, lid[ok]] = e_w[ok]


# ---- bundle adjustment --------------------------------------------------------

def robust(r):
    s = r * r
    return torch.where(s > 1.0, 1.0 / torch.sqrt(torch.clamp(s, min=1e-24)), torch.ones_like(r))


def damped_solve(A, y, ep, lm):
    A = A + torch.diag(ep + lm * torch.diagonal(A))
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(y[:, None], L)[:, 0]
    return torch.where(info != 0, torch.full_like(x, float("nan")), x)


def slot_edges(targets, weights, valid, slot_start, kf: int):
    """A dense slot graph (R, NS, M, S, ...) as flat edges: source frame i
    = slot_start + qs * kf, target frame j = slot_start + s, patch m."""
    R, NS, M, S = valid.shape
    dev = valid.device
    i = (slot_start[:, None] + torch.arange(NS, device=dev) * kf)[:, :, None, None].expand(R, NS, M, S)
    j = (slot_start[:, None] + torch.arange(S, device=dev))[:, None, None, :].expand(R, NS, M, S)
    m = torch.arange(M, device=dev)[None, None, :, None].expand(R, NS, M, S)
    ok = (slot_start >= 0)[:, None, None, None].expand(R, NS, M, S)
    return {"ii": i.reshape(-1).long(), "jj": j.reshape(-1).long(), "m": m.reshape(-1),
            "targets": targets.reshape(-1, 2), "weights": weights.reshape(-1, 2),
            "valid": valid.reshape(-1), "slot_ok": ok.reshape(-1)}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32's 10-bit mantissa (to nearest, ties away)."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _same(x):
    return x


def _project(poses, patches_fm, intrinsics, e, n: int, base_f: int, dims: Dims):
    """Each edge's reprojection: (present, X (E, 4), Gij, intrinsics of j,
    x1, y1, rx, ry)."""
    Nf = dims.N
    ii, jj = e["ii"], e["jj"]
    i_cl, j_cl = ii.clamp(0, Nf - 1), jj.clamp(0, Nf - 1)
    present = (e["valid"] > 0) & e["slot_ok"] & (ii < n) & (jj < n) & (ii >= base_f)
    P = patches_fm[i_cl, e["m"]]                                               # (E, 3)
    X0 = g.iproj(P, intrinsics[i_cl])
    Gij = g.se3_mul(poses[j_cl], g.se3_inv(poses[i_cl]))
    X = g.se3_act4(Gij, X0)
    fx, fy, cx, cy = intrinsics[j_cl].unbind(-1)
    zi = 1.0 / torch.clamp(X[:, 2], min=1e-2)
    x1, y1 = fx * X[:, 0] * zi + cx, fy * X[:, 1] * zi + cy
    rx, ry = e["targets"][:, 0] - x1, e["targets"][:, 1] - y1
    return present, X, Gij, (fx, fy), x1, y1, rx, ry


def gate(poses, patches_fm, intrinsics, e, n: int, base_f: int, dims: Dims):
    """The edges a step uses: present, in front of the camera, within 250
    px of their target and inside the frame."""
    present, X, _, _, x1, y1, rx, ry = _project(poses, patches_fm, intrinsics, e, n, base_f, dims)
    rsq = torch.nan_to_num(rx * rx + ry * ry, nan=float("inf"))
    return (present & (X[:, 2] > 0.2) & (torch.sqrt(rsq) < 250.0) & (x1 > 0) & (y1 > 0)
            & (x1 < dims.wd) & (y1 < dims.ht) & torch.isfinite(rx) & torch.isfinite(ry))


def assemble(poses, patches_fm, monodisp_fm, intrinsics, e, t0: int, n: int, base_f: int,
             dims: Dims, slam: dict, rnd=_same, ok=None, t_eps: float = 0.0,
             g_eps: float = 0.0) -> dict:
    """The damped Gauss-Newton system of one step over the edges `e`
    (slot_edges), in the inputs' dtype: the pose blocks B (window x
    window), v, the pose-depth blocks E (window*6, K), and per patch of
    frames base_f..base_f+patch_window the depth terms C, Q = 1/C, w (the
    right-hand side, the mono prior in) and whether it has an edge. S = B -
    E Q E^T and y = v - E Q w are the Schur complement. `rnd` rounds the
    inputs of every product (round_tf32: the step in TF32); `ok` gives the
    gate's decisions (default: taken here). The *_abs entries sum the
    terms' magnitudes, the scale of their rounding; v_tm and w_tm sum them
    with each residual's magnitude replaced by its target's and
    projection's, the scale of the residual's own rounding.

    With `t_eps`, also how far a relative translation t_ij rounded by
    t_eps (|t_i| + |t_j|) moves each edge's depth Jacobian Jz and
    projection, first order, summed as the system sums them: w_slack and
    C_slack per patch, E2_slack beside E2, v_slack beside v. An edge from a
    frame to itself has t_ij = 0 and Jz = 0 exactly; rounded, it is noise
    of that size.

    With `g_eps`, the edges whose gate a rounding of g_eps times the gated
    quantity's magnitude could turn (depth at 0.2, residual at 250 px,
    projection at the frame's border) count as possibly in: their terms'
    magnitudes, summed as the system sums them, are C_amb and w_amb per
    patch, E2_amb, B_amb and v_amb."""
    M, Wn, PF, Nf = dims.M, dims.window, dims.patch_window, dims.N
    dev, dt = poses.device, poses.dtype
    ii, jj = e["ii"], e["jj"]
    present, X, Gij, (fx, fy), x1, y1, rx, ry = _project(poses, patches_fm, intrinsics, e, n,
                                                          base_f, dims)
    if ok is None:
        ok = gate(poses, patches_fm, intrinsics, e, n, base_f, dims)
    Xs, Ys, Zs, Hs = X.unbind(-1)
    zero = torch.zeros((), device=dev, dtype=dt)
    w = e["weights"]
    wts = torch.stack([torch.where(ok, w[:, 0] * robust(rx), zero),
                       torch.where(ok, w[:, 1] * robust(ry), zero)], -1)       # (E, 2)
    r = torch.stack([torch.where(ok, rx, zero), torch.where(ok, ry, zero)], -1)

    # Jacobians of the projection: left perturbation of pose j, Ji = -AdjT(Gij) Jj
    # 1/Z on every edge the gate passes (Z > 0.2); finite on the others,
    # whose terms the gate zeroes
    d = 1.0 / Zs.abs().clamp_min(0.1)
    o = torch.zeros_like(d)
    Ja = torch.stack([torch.stack([Hs, o, o, o, Zs, -Ys], -1),
                      torch.stack([o, Hs, o, -Zs, o, Xs], -1),
                      torch.stack([o, o, Hs, Ys, -Xs, o], -1)], -2)               # (E, 3, 6)
    Jp = torch.stack([torch.stack([fx * d, o, -fx * Xs * d * d], -1),
                      torch.stack([o, fy * d, -fy * Ys * d * d], -1)], -2)        # (E, 2, 3)
    Jj = rnd(Jp) @ rnd(Ja)
    qinv = g.quat_conj(Gij[..., 3:7])[:, None, :]
    at, aw = Jj[..., :3], Jj[..., 3:]
    Ji = -torch.cat([g.quat_rotate(qinv, at),
                     g.quat_rotate(qinv, aw - g.cross(Gij[:, None, :3], at))], -1)
    Jz = (rnd(Jp) @ rnd(Gij[:, :3, None]))[..., 0]                               # (E, 2)

    i_loc, j_loc, f_loc = ii - t0, jj - t0, ii - base_f
    k_loc = f_loc * M + e["m"]
    in_i = (i_loc >= 0) & (i_loc < Wn)
    in_j = (j_loc >= 0) & (j_loc < Wn)
    in_k = (f_loc >= 0) & (f_loc < PF)
    K = PF * M

    wJi, wJj = wts[..., None] * Ji, wts[..., None] * Jj
    B = torch.zeros((Wn, Wn, 6, 6), device=dev, dtype=dt)
    v = torch.zeros((Wn, 6), device=dev, dtype=dt)
    E = torch.zeros((Wn, K, 6), device=dev, dtype=dt)
    B_abs, v_abs, E_abs = torch.zeros_like(B), torch.zeros_like(v), torch.zeros_like(E)
    for a, wJa, ina in ((i_loc, wJi, in_i), (j_loc, wJj, in_j)):
        for out, out_abs, idx, x, y, eq in (
                (v, v_abs, (a[ina],), wJa[ina], r[ina], "ecx,ec->ex"),
                (E, E_abs, (a[ina & in_k], k_loc[ina & in_k]), wJa[ina & in_k], Jz[ina & in_k],
                 "ecx,ec->ex")):
            out.index_put_(idx, torch.einsum(eq, rnd(x), rnd(y)), accumulate=True)
            out_abs.index_put_(idx, torch.einsum(eq, x.abs(), y.abs()), accumulate=True)
        for b, Jb, inb in ((i_loc, Ji, in_i), (j_loc, Jj, in_j)):
            mk = ina & inb
            B.index_put_((a[mk], b[mk]), torch.einsum("ecx,ecy->exy", rnd(wJa[mk]), rnd(Jb[mk])),
                         accumulate=True)
            B_abs.index_put_((a[mk], b[mk]), torch.einsum("ecx,ecy->exy", wJa[mk].abs(),
                                                          Jb[mk].abs()), accumulate=True)
    Ck = torch.zeros(K, device=dev, dtype=dt)
    wk = torch.zeros(K, device=dev, dtype=dt)
    counts = torch.zeros(K, device=dev, dtype=dt)
    wJz = rnd(wts * Jz)
    Ck.index_put_((k_loc[in_k],), (wJz * rnd(Jz)).sum(-1)[in_k], accumulate=True)
    wk.index_put_((k_loc[in_k],), (wJz * rnd(r)).sum(-1)[in_k], accumulate=True)
    w_abs = torch.zeros(K, device=dev, dtype=dt)
    w_abs.index_put_((k_loc[in_k],), (wts * Jz * r).abs().sum(-1)[in_k], accumulate=True)
    # the magnitudes of the residual's two parts, target and projection,
    # in place of the residual's: the scale of its rounding
    r_tm = torch.where(ok[:, None], e["targets"].abs() + torch.stack([x1, y1], -1).abs(), zero)
    w_tm = torch.zeros(K, device=dev, dtype=dt)
    w_tm.index_put_((k_loc[in_k],), (wts * Jz).abs().mul(r_tm).sum(-1)[in_k], accumulate=True)
    v_tm = torch.zeros((Wn, 6), device=dev, dtype=dt)
    for a, wJa, ina in ((i_loc, wJi, in_i), (j_loc, wJj, in_j)):
        v_tm.index_put_((a[ina],), torch.einsum("ecx,ec->ex", wJa[ina].abs(), r_tm[ina]),
                        accumulate=True)
    pk = present & in_k
    counts.index_put_((k_loc[pk],), torch.ones_like(k_loc[pk], dtype=dt), accumulate=True)
    slack = {}
    if t_eps:
        Nf_ = poses.shape[0]
        tn = (torch.linalg.vector_norm(poses[ii.clamp(0, Nf_ - 1), :3], dim=-1)
              + torch.linalg.vector_norm(poses[jj.clamp(0, Nf_ - 1), :3], dim=-1))
        dt_ = t_eps * tn
        f = torch.stack([fx, fy], -1)
        XY = torch.stack([Xs, Ys], -1).abs()
        ad = d.abs()[:, None]
        gain = f * ad * (1.0 + XY * ad)                      # of a move of X and Z by one
        dr = gain * (Hs.abs() * dt_)[:, None]                # the projection's move
        dJz = gain * dt_[:, None]                            # the depth Jacobian's
        om = wts.abs()
        for name, val in (("w_slack", om * (Jz.abs() * dr + dJz * (r.abs() + dr))),
                          ("C_slack", om * (2.0 * Jz.abs() + dJz) * dJz)):
            acc = torch.zeros(K, device=dev, dtype=dt)
            acc.index_put_((k_loc[in_k],), val.sum(-1)[in_k], accumulate=True)
            slack[name] = acc
        E_sl = torch.zeros((Wn, K, 6), device=dev, dtype=dt)
        v_sl = torch.zeros((Wn, 6), device=dev, dtype=dt)
        for a, wJa, ina in ((i_loc, wJi, in_i), (j_loc, wJj, in_j)):
            m_ = ina & in_k
            E_sl.index_put_((a[m_], k_loc[m_]), torch.einsum("ecx,ec->ex", wJa[m_].abs(), dJz[m_]),
                            accumulate=True)
            v_sl.index_put_((a[ina],), torch.einsum("ecx,ec->ex", wJa[ina].abs(), dr[ina]),
                            accumulate=True)
        slack["E2_slack"] = E_sl.permute(0, 2, 1).reshape(Wn * 6, K)
        slack["v_slack"] = v_sl.reshape(-1)
    if g_eps:
        slack.update(_ambiguous_terms(present, ok, X, x1, y1, rx, ry, e, (fx, fy), intrinsics[
            jj.clamp(0, poses.shape[0] - 1)], poses, ii, jj, Ji, Jj, Jz, d, g_eps, dims,
            (i_loc, j_loc, k_loc, in_i, in_j, in_k), Wn, K))

    rows_pf = (base_f + torch.arange(PF, device=dev)).clamp(0, Nf - 1)
    disps = patches_fm[rows_pf, :, 2].reshape(K)
    sens = monodisp_fm[rows_pf].reshape(K)
    prior = (sens > 1e-2).to(dt)
    alpha, lmbda = slam["BA_ALPHA"], slam["BA_LMBDA"]
    E2 = E.permute(0, 2, 1).reshape(Wn * 6, K)
    mono = prior * alpha * (disps - sens)
    return {"B": B.permute(0, 2, 1, 3).reshape(Wn * 6, Wn * 6), "v": v.reshape(-1), "E2": E2,
            "B_abs": B_abs.permute(0, 2, 1, 3).reshape(Wn * 6, Wn * 6), "v_abs": v_abs.reshape(-1),
            "E2_abs": E_abs.permute(0, 2, 1).reshape(Wn * 6, K),
            "v_tm": v_tm.reshape(-1), "w_tm": w_tm, **slack,
            "C": Ck + prior * alpha + lmbda, "Q": 1.0 / (Ck + prior * alpha + lmbda),
            "w": wk - mono, "w_abs": w_abs + mono.abs(), "has": counts > 0}


def _ambiguous_terms(present, ok, X, x1, y1, rx, ry, e, f, intr_j, poses, ii, jj, Ji, Jj, Jz, d,
                     g_eps: float, dims: Dims, loc, Wn: int, K: int) -> dict:
    """assemble's C_amb, w_amb, E2_amb, B_amb, v_amb: the magnitudes of the
    terms of the edges whose gate decision lies within g_eps of rounding."""
    Xs, Ys, Zs, Hs = X.unbind(-1)
    fx, fy = f
    cx, cy = intr_j[:, 2], intr_j[:, 3]
    Nf = poses.shape[0]
    tn = (torch.linalg.vector_norm(poses[ii.clamp(0, Nf - 1), :3], dim=-1)
          + torch.linalg.vector_norm(poses[jj.clamp(0, Nf - 1), :3], dim=-1))
    bx = g_eps * (x1.abs() + (fx * Xs * d).abs() + cx.abs())
    by = g_eps * (y1.abs() + (fy * Ys * d).abs() + cy.abs())
    bz = g_eps * (1.0 + Zs.abs() + Hs.abs() * tn + Xs.abs() + Ys.abs())
    tg = e["targets"]
    br = g_eps * (tg.abs().sum(-1) + x1.abs() + y1.abs())
    rr = torch.sqrt(torch.nan_to_num(rx * rx + ry * ry, nan=float("inf")))
    near = (((Zs - 0.2).abs() <= bz) | ((rr - 250.0).abs() <= br)
            | (x1.abs() <= bx) | ((x1 - dims.wd).abs() <= bx)
            | (y1.abs() <= by) | ((y1 - dims.ht).abs() <= by))
    amb = (present & near & (Zs > 0.2 - bz) & torch.isfinite(rr)).to(Zs.dtype)
    w = e["weights"]
    om = torch.stack([w[:, 0] * robust(rx), w[:, 1] * robust(ry)], -1).abs() * amb[:, None]
    r = torch.stack([rx, ry], -1).abs()
    r = torch.where(torch.isfinite(r), r, torch.zeros_like(r))
    i_loc, j_loc, k_loc, in_i, in_j, in_k = loc
    dev, dt = X.device, X.dtype
    out = {"C_amb": torch.zeros(K, device=dev, dtype=dt), "w_amb": torch.zeros(K, device=dev, dtype=dt)}
    out["C_amb"].index_put_((k_loc[in_k],), (om * Jz * Jz).sum(-1)[in_k], accumulate=True)
    out["w_amb"].index_put_((k_loc[in_k],), (om * (Jz * r).abs()).sum(-1)[in_k], accumulate=True)
    E = torch.zeros((Wn, K, 6), device=dev, dtype=dt)
    B = torch.zeros((Wn, Wn, 6, 6), device=dev, dtype=dt)
    v = torch.zeros((Wn, 6), device=dev, dtype=dt)
    for a, Ja, ina in ((i_loc, Ji, in_i), (j_loc, Jj, in_j)):
        oJa = om[..., None] * Ja.abs()
        m_ = ina & in_k
        E.index_put_((a[m_], k_loc[m_]), torch.einsum("ecx,ec->ex", oJa[m_], Jz[m_].abs()),
                     accumulate=True)
        v.index_put_((a[ina],), torch.einsum("ecx,ec->ex", oJa[ina], r[ina]), accumulate=True)
        for b, Jb, inb in ((i_loc, Ji, in_i), (j_loc, Jj, in_j)):
            mk = ina & inb
            B.index_put_((a[mk], b[mk]), torch.einsum("ecx,ecy->exy", oJa[mk], Jb[mk].abs()),
                         accumulate=True)
    out["E2_amb"] = E.permute(0, 2, 1).reshape(Wn * 6, K)
    out["B_amb"] = B.permute(0, 2, 1, 3).reshape(Wn * 6, Wn * 6)
    out["v_amb"] = v.reshape(-1)
    return out


def damped(S, lm: float, ep: float):
    """S + diag(ep + lm * diag(S)), the system the solve factors."""
    return S + torch.diag(ep + lm * torch.diagonal(S))


def ba_step(poses, patches_fm, monodisp_fm, intrinsics, e, t0: int, n: int, base_f: int,
            dims: Dims, slam: dict, structure_only: bool, rnd=_same):
    """One damped Gauss-Newton step (assemble): poses of frames
    t0..t0+window, inverse depths of the patches of frames
    base_f..base_f+patch_window; the structure-only pass holds the poses.
    Returns (poses, patches_fm)."""
    M, Wn, PF, Nf = dims.M, dims.window, dims.patch_window, dims.N
    sy = assemble(poses, patches_fm, monodisp_fm, intrinsics, e, t0, n, base_f, dims, slam, rnd)
    Q, w, E2 = sy["Q"], sy["w"], sy["E2"]
    if structure_only:
        dZ = Q * w * sy["has"]
    else:
        S = sy["B"] - rnd(E2 * Q) @ rnd(E2.T)
        y = sy["v"] - rnd(E2) @ rnd(Q * w)
        dx = damped_solve(S, y, slam["BA_EP"], 1e-4)
        dx = torch.where(torch.isnan(dx).any(), damped_solve(S, y, slam["BA_EP"], 1e-3), dx)
        dZ = Q * (w - rnd(E2.T) @ rnd(dx)) * sy["has"]
        dX = dx.reshape(Wn, 6) * (torch.arange(Wn, device=poses.device) < (n - t0))[:, None]
        full = torch.zeros((Nf, 6), device=poses.device, dtype=poses.dtype)
        hi = min(Nf, t0 + Wn)
        full[t0:hi] = dX[:hi - t0]
        poses = g.se3_retr(poses, full)
    return poses, apply_depths(patches_fm, dZ, base_f, dims)


def apply_depths(patches_fm, dZ, base_f: int, dims: Dims):
    """Inverse depths of the window's patches moved by dZ, every row
    clamped to [1e-3, 10] as the loop clamps them."""
    Nf, PF, M = dims.N, dims.patch_window, dims.M
    hi = min(Nf, base_f + PF)
    d_all = patches_fm[..., 2].clone()
    d_all[base_f:hi] += dZ.reshape(PF, M)[:hi - base_f]
    patches_fm = patches_fm.clone()
    patches_fm[..., 2] = d_all.clamp(1e-3, 10.0)
    return patches_fm


def map_filter(poses, patches, intrinsics, e_kk, e_jj, e_target, e_weight, M: int, th: float):
    """Edges whose reprojection error reaches `th` lose their weight."""
    xy = g.reproject(poses, patches, intrinsics, e_kk // M, e_jj, e_kk)
    keep = (torch.linalg.vector_norm(xy - e_target[:, :2], dim=-1) < th).float()
    return e_weight * keep[:, None]


def refresh_cloud(st, n: int, dims: Dims):
    """Tracks with a positive local weight are static: their local targets
    become the BA point reprojected into the neighbouring frames."""
    M, S_local, Nf, Wf = dims.M, dims.S_local, dims.N, dims.cloud_frames
    mid = (S_local + 1) // 2 - 1
    dev = st["poses"].device
    r0 = min(max(n - Wf, 0), Nf - Wf) * M
    K = Wf * M
    ridx = r0 + torch.arange(K, device=dev)
    loc = ridx - st["row0"]
    ix = ridx // M
    P = g.point_cloud(st["poses"], st["patches"][ridx], st["intrinsics"], ix)
    jj = (ix[:, None] + torch.arange(S_local, device=dev)[None, :] - mid).clamp(0, Nf - 1).reshape(-1)
    X1 = g.se3_act4(st["poses"][jj], P.repeat_interleave(S_local, 0))
    trg = g.proj(X1, st["intrinsics"][jj], depth=True).reshape(K, S_local, 3)
    static = (st["local_weights"][loc].sum(1) > 0) & (ridx < n * M)
    st["local_targets"][loc] = torch.where(static[:, None, None], trg, st["local_targets"][loc])


def trajectory(poses: torch.Tensor) -> np.ndarray:
    """World-to-camera poses (C, 7) -> camera-to-world TUM rows
    [tx ty tz qw qx qy qz]."""
    c2w = g.se3_inv(poses.double().cpu()).numpy()
    return c2w[:, [0, 1, 2, 6, 3, 4, 5]]
