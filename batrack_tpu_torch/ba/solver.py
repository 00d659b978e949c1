"""Bundle adjustment on a flat edge list: robust Gauss-Newton with Schur
elimination (counterpart of batrack_tpu/ba/solver.py, the reference
BA_rgbd_droid of main/backend/ba.py:217-339: robust reweighting, validity
gates, the mono-disparity prior on the depth blocks, a damped Cholesky
with one re-damped retry, clamped retractions).

The edge set has a fixed capacity; unused and removed edges carry
valid=0. Poses [t0, t0 + W) are free, patches [base_k, base_k + K) hold
the depth blocks. The JAX package sums the pose blocks with one-hot
matrix products (a TPU layout choice); here every block sum is an
index_add_ into a buffer with one spare row that collects the dropped
indices, accumulated in float64 (accumulation_dtype): the same sums in
another order. The
Schur product E Q E^T is one dense (6W, K) x (K, 6W) matmul.

This is the solver of use_keyframe, whose frame deletion breaks the slot
solver's dense addressing (ba/slot_solver.py). Frame indices the host
knows (t0, n, base_k) are Python ints.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch
import torch.distributed as dist

from batrack_tpu_torch.geometry import projective, se3


class BAProblem(NamedTuple):
    """One factor-graph snapshot (fixed shapes)."""

    poses: torch.Tensor       # (N, 7) SE3 world-to-camera
    patches: torch.Tensor     # (N*M, 3) [x, y, disp]
    monodisp: torch.Tensor    # (N*M,) mono-depth disparity prior
    intrinsics: torch.Tensor  # (N, 4)
    targets: torch.Tensor     # (E, 2) tracked 2D targets
    weights: torch.Tensor     # (E, 2) confidence weights
    ii: torch.Tensor          # (E,) source frame
    jj: torch.Tensor          # (E,) target frame
    kk: torch.Tensor          # (E,) patch id (global, frame*M + m)
    valid: torch.Tensor       # (E,) edge validity mask (0/1)
    t0: int                   # first free pose (fixedp, ba.py:103)
    n: int                    # frames in use
    base_k: int               # first patch id of the depth window


def robust_weight(r: torch.Tensor, loss: str) -> torch.Tensor:
    """Component-wise robust kernel weight (reference ba.py:81-100)."""
    if loss == "trivial":
        return torch.ones_like(r)
    if loss == "huber":
        s = r * r
        return torch.where(s > 1.0, 1.0 / torch.sqrt(torch.clamp(s, min=1e-24)),
                           torch.ones_like(r))
    if loss == "cauchy":
        return 1.0 / (1.0 + r * r)
    raise NotImplementedError(loss)


def accumulation_dtype(dtype: torch.dtype) -> torch.dtype:
    """The flat solver's block sums accumulate in float64 for float32
    inputs: a float32 index_add_ runs one long sequential sum per bucket,
    which lands about 3x further from the float64 answer than the JAX
    package's blocked one-hot matmul (ROADMAP C); the blocks stay float32."""
    return torch.float64 if dtype == torch.float32 else dtype


def segment_sum(size: int, *pairs: torch.Tensor, acc=None) -> torch.Tensor:
    """Sum the rows of each (ids, vals) pair into `size` bins, accumulated
    in `acc` (default: the values' dtype) and returned in the values'
    dtype; id == size is dropped."""
    vals = pairs[1]
    acc = acc or vals.dtype
    out = torch.zeros((size + 1,) + vals.shape[1:], dtype=acc, device=vals.device)
    for ids, v in zip(pairs[::2], pairs[1::2]):
        out.index_add_(0, ids, v.to(acc))
    return out[:size].to(vals.dtype)


def all_reduce_sum(mesh, *parts: torch.Tensor):
    """The parts summed over the ranks, through one all_reduce of one flat
    buffer (one collective per Gauss-Newton step), counted in
    parallel/mesh.py's collective counts."""
    # parallel/ imports this module: import its counter at the call
    from batrack_tpu_torch.parallel.mesh import count_collective

    flat = torch.cat([p.reshape(-1) for p in parts])
    dist.all_reduce(flat, group=mesh.group)
    count_collective("all_reduce", flat.dtype, flat.shape)
    return tuple(x.view_as(p) for x, p in zip(flat.split([p.numel() for p in parts]), parts))


def damped_solve(Sm: torch.Tensor, y: torch.Tensor, ep: float, lm: float) -> torch.Tensor:
    """Cholesky solve of (Sm + diag(ep + lm * diag(Sm))) x = y; NaN where
    the factorization fails (what the JAX package's cho_factor yields)."""
    A = Sm + torch.diag(ep + lm * torch.diagonal(Sm))
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(y[:, None], L)[:, 0]
    return torch.where(info != 0, torch.full_like(x, float("nan")), x)


def redamped_solve(Sm: torch.Tensor, y: torch.Tensor, ep: float, lm: float) -> torch.Tensor:
    """damped_solve, and again with lm * 10 where the first has a NaN
    (ba.py:324-325). Both solves run, so the host never waits on the card."""
    dx = damped_solve(Sm, y, ep, lm)
    return torch.where(torch.isnan(dx).any(), damped_solve(Sm, y, ep, lm * 10.0), dx)


def ba_iteration(
    prob: BAProblem,
    *,
    window: int,
    patch_window: int,
    patches_per_frame: int,
    bounds: Tuple[float, float, float, float],
    ep: float = 10.0,
    lmbda: float = 1e-4,
    lm: float = 1e-4,
    alpha: float = 0.05,
    loss: str = "huber",
    structure_only: bool = False,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One damped Gauss-Newton step. Returns (poses, patches) updated.

    window: bound W on free poses (>= OPTIMIZATION_WINDOW). patch_window:
    bound (frames) on patches with active edges (>= REMOVAL_WINDOW).
    mesh: the JAX package's axis_name. With it, the edge arrays are this
    rank's shard (parallel/sharded_ba.py) and the assembled blocks B, E, C,
    w, v and the edge counts are summed over the ranks by one all_reduce
    before the replicated solve: only reduced blocks cross ranks, never
    raw edges."""
    W = window
    M = patches_per_frame
    K = patch_window * M
    dtype, dev = prob.poses.dtype, prob.poses.device
    Np, NM = prob.poses.shape[0], prob.patches.shape[0]
    ii, jj, kk = prob.ii.long(), prob.jj.long(), prob.kk.long()

    coords, v, jac = projective.transform(prob.poses, prob.patches, prob.intrinsics,
                                          ii, jj, kk, jacobian=True)
    Ji, Jj, Jz = jac
    r = prob.targets - coords  # (E, 2)

    # validity gates (ba.py:230-242): depth, flow < 250 px, in bounds, edge
    # mask; non-finite targets gate to zero
    rn = torch.linalg.vector_norm(torch.nan_to_num(r, nan=float("inf")), dim=-1)
    v = v * (rn < 250.0)
    in_bounds = ((coords[..., 0] > bounds[0]) & (coords[..., 1] > bounds[1])
                 & (coords[..., 0] < bounds[2]) & (coords[..., 1] < bounds[3]))
    v = v * in_bounds * prob.valid * torch.isfinite(r).all(-1)
    # the reference deletes edges whose source patch left the removal
    # window (keyframe_simple, batrack.py:1020-1024): no pose blocks either
    v = v * (kk >= prob.base_k)

    # where() instead of multiplication: 0 * NaN would poison the sums
    gate = (v > 0)[..., None]
    zero = torch.zeros((), dtype=dtype, device=dev)
    w = torch.where(gate, prob.weights * robust_weight(r, loss), zero)
    r = torch.where(gate, r, zero)

    wJi = w[..., None] * Ji  # (E, 2, 6)
    wJj = w[..., None] * Jj
    jz = Jz[..., 0]          # (E, 2)
    wjz = w * jz

    # local indices; out-of-range ids go to the dropped overflow row
    seg = functools.partial(segment_sum, acc=accumulation_dtype(dtype))

    i_loc = ii - prob.t0
    j_loc = jj - prob.t0
    k_loc = kk - prob.base_k
    k_in = (k_loc >= 0) & (k_loc < K)
    k_id = torch.where(k_in, k_loc, torch.full_like(k_loc, K))
    C = seg(K, k_id, (wjz * jz).sum(-1))
    wvec = seg(K, k_id, (wjz * r).sum(-1))
    # patches with at least one edge PRESENT get an update: the reference's
    # unique(kk) (ba.py:276) counts edges in the buffers, not gated ones, so
    # a patch whose every edge fails the gates still moves to the mono prior
    present = prob.valid * (kk >= prob.base_k)
    edge_counts = seg(K, k_id, present.to(dtype))

    if not structure_only:
        def in_win(a):
            return (a >= 0) & (a < W)

        def pair(a, b):
            return torch.where(in_win(a) & in_win(b), a * W + b, torch.full_like(a, W * W))

        def block(a, b):
            return torch.einsum("eci,ecj->eij", a, b).reshape(-1, 36)

        B = seg(W * W, pair(i_loc, i_loc), block(wJi, Ji), pair(i_loc, j_loc), block(wJi, Jj),
                pair(j_loc, i_loc), block(wJj, Ji), pair(j_loc, j_loc), block(wJj, Jj),
                ).reshape(W, W, 6, 6)

        def pose_patch(a):
            return torch.where(in_win(a) & k_in, a * K + k_loc, torch.full_like(a, W * K))

        E_mat = seg(W * K, pose_patch(i_loc), torch.einsum("eci,ec->ei", wJi, jz),
                    pose_patch(j_loc), torch.einsum("eci,ec->ei", wJj, jz)).reshape(W, K, 6)

        def pose_id(a):
            return torch.where(in_win(a), a, torch.full_like(a, W))

        vvec = seg(W, pose_id(i_loc), torch.einsum("eci,ec->ei", wJi, r),
                   pose_id(j_loc), torch.einsum("eci,ec->ei", wJj, r))
        if mesh is not None:
            B, E_mat, C, wvec, vvec, edge_counts = all_reduce_sum(
                mesh, B, E_mat, C, wvec, vvec, edge_counts)
    elif mesh is not None:
        C, wvec, edge_counts = all_reduce_sum(mesh, C, wvec, edge_counts)

    # mono-disparity prior on the depth blocks (ba.py:294-308); ids past
    # the buffer read its last row (the JAX package's mode="clip")
    patch_ids = prob.base_k + torch.arange(K, device=dev)
    pk = patch_ids.clamp(max=NM - 1)
    disps_k = prob.patches[pk, 2]
    sens_k = prob.monodisp[pk]
    mprior = (sens_k > 1e-2).to(dtype)
    C_adj = C + mprior * alpha + lmbda
    w_adj = wvec - mprior * alpha * (disps_k - sens_k)
    has_edge = edge_counts > 0
    Q = 1.0 / C_adj

    if structure_only:
        dZ = Q * w_adj * has_edge
        poses = prob.poses
    else:
        E2 = E_mat.transpose(1, 2).reshape(W * 6, K)  # [w*6+c, k]
        Sm = B.permute(0, 2, 1, 3).reshape(W * 6, W * 6) - (E2 * Q[None, :]) @ E2.T
        y = vvec.reshape(W * 6) - E2 @ (Q * w_adj)
        dx = redamped_solve(Sm, y, ep, lm)
        dZ = Q * (w_adj - E2.T @ dx) * has_edge

        # retract the free poses [t0, t0 + W) that exist; rows past the
        # buffer are dropped
        free = (torch.arange(W, device=dev) < (prob.n - prob.t0))[:, None]
        dX = torch.where(free, dx.reshape(W, 6), zero)
        full_dx = torch.zeros((Np, 6), dtype=dtype, device=dev)
        hi = min(Np, prob.t0 + W)
        if hi > prob.t0:
            full_dx[prob.t0:hi] = dX[: hi - prob.t0]
        poses = se3.retr(prob.poses, full_dx)

    # retract and clamp the disparities (ba.py:332-333 clamps the whole
    # buffer); ids past the buffer are dropped
    disps = prob.patches[:, 2].clone()
    hi = min(NM, prob.base_k + K)
    if hi > prob.base_k:
        disps[prob.base_k:hi] += dZ[: hi - prob.base_k]
    patches = prob.patches.clone()
    patches[:, 2] = disps.clamp(1e-3, 10.0)
    return poses, patches
