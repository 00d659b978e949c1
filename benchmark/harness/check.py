"""The comparison that decides `correct`: what the timed path produced, at
the timed sizes, against the plain reference (benchmark/reference/), on
frames drawn from the seed (streams.py), once the window has closed and
the program's state is freed. Three numbers, each against the limit in the
configuration's file:

* track_px, vis: the tracker append. The reference rebuilds the append's
  input from the frames and the patch draws (its own patch selection,
  query depths and window, each frame's features encoded under the depth
  statistics of the append that first encoded it, as the cross-append
  cache keeps them) and runs in float32; the numbers are the shares of
  live tracks (visibility logits) further than a quarter pixel (0.25) from
  it, the worst append of the run.
* ba: the backend, followed step by step from the program's own state
  (poses, patches and edges derive from every earlier frame): each read
  Gauss-Newton step of a checked frame against the step the reference
  assembles in float64 from the same inputs, as backward errors (ba_gaps),
  one per pose row and per patch; the number is the largest share, over
  the run's read steps, of a step's rows and patches whose backward error
  passes BA_TAU. The loop stages around the update (ingest, gate, culling,
  the point-cloud refresh, terminate()'s trajectory, each step starting
  where the one before it ended) are held against the program's state by
  themselves: one off by more than LOOP_TOL, a missing update, reads 1.

The control puts the reference in the program's place one precision
below what the configuration states: the tracker in float8 e4m3 for its
bf16, the backend's products in TF32 for its float32 with TF32 off."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from reference import geometry as g
from reference import slam as rs
from reference import tracker as rt

NUMBERS = ("track_px", "vis", "ba")



class Sequence:
    """What the reference works out again for one sequence of one stream:
    the patch draws (the sequence's seeded generator, two uniform arrays a
    frame), the patches they select, and the append history (ring slots,
    which append encoded each window frame)."""

    def __init__(self, seq_seed: int, images: np.ndarray, depths: np.ndarray, config: dict,
                 device):
        self.cfg, self.device = config, device
        self.slam = config["slam"]
        fr = config["frame"]
        self.dims = rs.Dims(self.slam, fr["height"], fr["width"])
        self.images, self.depths = images, depths
        self.intr = torch.tensor(fr["intrinsics"], dtype=torch.float32, device=device)
        self.seed = seq_seed
        self._coords: List[torch.Tensor] = []
        self._gen = torch.Generator(device=device)
        self._gen.manual_seed(seq_seed)

    def frame(self, t: int):
        img = torch.as_tensor(self.images[t], device=self.device).float()
        dep = torch.as_tensor(self.depths[t], device=self.device).float()
        return img, dep

    def patches(self, t: int) -> torch.Tensor:
        """(M, 2) patch centres of frame t."""
        shape = rs.draw_shape(self.dims)
        while len(self._coords) <= t:
            ux = torch.rand(shape, generator=self._gen, device=self.device)
            uy = torch.rand(shape, generator=self._gen, device=self.device)
            img, _ = self.frame(len(self._coords))
            self._coords.append(rs.select_patches(img, ux, uy, self.dims))
        return self._coords[t]

    def history(self, n_target: int):
        """(slot of the append at frame count n_target, per window slot the
        (frame, encoding append) pair)."""
        d = self.dims
        ring = rs.SlotRing(d, self.slam["REMOVAL_WINDOW"])
        last, enc, slot = None, None, None
        for n in range(1, n_target + 1):
            if (n - 1) % d.kf:
                continue
            slot = ring.alloc(n)
            S = min(n, d.S)
            frames = [n - S + s if s < S else n - 1 for s in range(d.S)]
            shift = (n - last if last is not None and last >= d.S and 0 < n - last < d.S
                     else None)
            if shift:
                enc = enc[shift:] + [(f, n) for f in frames[d.S - shift:]]
            else:
                enc = [(f, n) for f in frames]
            last = n
        return slot, enc

    def queries(self, n: int):
        """The append at frame count n: (queries (NQ, 4) [window frame, x, y,
        depth] in image pixels, query_valid (NQ,), window start, window
        frames)."""
        d = self.dims
        S = min(n, d.S)
        qs = torch.arange(d.n_src, device=self.device)
        rows = []
        for q in range(d.n_src):
            f = n - S + q * d.kf
            if f < n:
                xy = self.patches(f)
            else:  # rows of frames not yet ingested hold no patch
                xy = torch.zeros((d.M, 2), device=self.device)
            # the query's depth map: its frame's, the newest for a query
            # past the window
            dep = self.frame(min(f, n - 1))[1]
            depth = rt.bilinear_taps(dep[None], xy[:, 0], xy[:, 1])[:, 0]
            rows.append(torch.cat([torch.full((d.M, 1), float(q * d.kf), device=self.device),
                                   xy, depth[:, None]], -1))
        valid = (qs < (S + d.kf - 1) // d.kf)[:, None].expand(d.n_src, d.M).reshape(-1)
        frames = [n - S + s if s < S else n - 1 for s in range(d.S)]
        return torch.cat(rows), valid, n - S, frames


def resized_window(seq: Sequence, frames, ih: int, iw: int) -> torch.Tensor:
    """(S, 4, ih, iw) rgb 0..255 + metric depth at the model resolution."""
    rgbd = torch.stack([torch.cat([seq.frame(f)[0].permute(2, 0, 1), seq.frame(f)[1][None]])
                        for f in frames])
    return F.interpolate(rgbd, size=(ih, iw), mode="bilinear", align_corners=False)


def reference_append(seq: Sequence, n: int, tracker: rt.ReferenceTracker):
    """The tracker's outputs for the append at frame count n, in image
    pixels: (tracks (S, NQ, 2), depths, vis, dynamic, live (S, NQ))."""
    p = tracker.p
    ih, iw = p.interp_shape
    d = seq.dims
    queries, valid, _, frames = seq.queries(n)
    _, enc = seq.history(n)
    stats = {}
    for a in sorted({a for _, a in enc}):
        S_a = min(a, d.S)
        win_a = [a - S_a + s if s < S_a else a - 1 for s in range(d.S)]
        stats[a] = rt.window_stats(resized_window(seq, win_a, ih, iw)[:, 3], p.stride, iw)
    window = resized_window(seq, frames, ih, iw)
    fmaps = []
    for f, a in enc:
        d_near, d_far, _, z_min, z_max = stats[a]
        rgbd = resized_window(seq, [f], ih, iw)[0]
        dn = (rgbd[3, ::p.stride, ::p.stride] - d_near) / (d_far - d_near) * float(iw // p.stride)
        fmaps.append(tracker.encode(2.0 * (rgbd[None, :3] / 255.0) - 1.0, dn[None], z_min, z_max)[0])
    d_near, d_far = stats[n][0], stats[n][1]
    H, W = d.ht, d.wd
    q = queries.clone()
    q[:, 1] *= iw / W
    q[:, 2] *= ih / H
    tracks, depths, vis, dyn = tracker.forward(window, q, torch.stack(fmaps), d_near, d_far)
    tracks = tracks * torch.tensor([W / iw, H / ih], device=tracks.device)
    S = min(n, d.S)
    live = (torch.arange(d.S, device=tracks.device) < S)[:, None] & valid[None, :]
    return tracks, depths, vis, dyn, live, queries


def reference_gate(seq: Sequence, sample: dict, tracker_out: dict):
    """Ingest and gate of the frame call of `sample`, from the program's
    state before it: the frame's patches, inverse depths and intrinsics,
    the motion model's pose, and for an append the gate of the program's
    tracks (image pixels) into the ring and the local-trajectory rows.
    Returns the state dict the backend update starts from."""
    d, slam = seq.dims, seq.slam
    M = d.M
    st = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in sample["before"].items()}
    st["e_kk"], st["e_jj"] = st["e_kk"].long(), st["e_jj"].long()
    n, t = sample["n"], sample["t"]
    _, dep = seq.frame(t)
    xy = seq.patches(t)
    disp = 1.0 / torch.clamp(rt.bilinear_taps(dep[None], xy[:, 0], xy[:, 1])[:, 0], min=1e-2)
    st["patches"][n * M:(n + 1) * M] = torch.cat([xy, disp[:, None]], -1)
    rs.motion_model(st["poses"], n, slam["MOTION_DAMPING"])
    st["intrinsics"][n] = seq.intr
    n1 = n + 1
    if (n1 - 1) % d.kf == 0:
        queries, valid, win_start, _ = seq.queries(n1)
        slot, _ = seq.history(n1)
        rs.gate_and_append(st, queries, valid, win_start, tracker_out["tracks"],
                           tracker_out["depths"], tracker_out["vis"], tracker_out["dynamic"],
                           n1, slot, d, slam)
    return st


EPS32 = 2.0 ** -24   # float32's unit roundoff: the resolution of a stored pose or depth
R_ROUNDINGS = 8      # roundings a float32 projection carries into its residual
T_ROUNDINGS = 4      # roundings a float32 relative translation t_j - R t_i carries
G_ROUNDINGS = 64     # band of roundings in which two float32 evaluations may gate an edge apart
BA_TAU = 1e-5       # a step's equation is off where its backward error passes this
LOOP_TOL = 1e-3      # a loop stage is off where its relative gap passes this


def unit(P: torch.Tensor) -> torch.Tensor:
    """Poses with their quaternions normalised (in the poses' dtype): a
    float32 quaternion is a unit one only to float32's rounding, and
    composing it with its conjugate in float64 leaves that rounding in the
    translation."""
    q = P[..., 3:7]
    return torch.cat([P[..., :3], q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)], -1)


def pose_resolution(P_in: torch.Tensor, P_out: torch.Tensor) -> torch.Tensor:
    """(F, 6) what float32 poses resolve of the step dx = Log(P_out
    P_in^-1) that a float32 retraction P_out = Exp(dx) P_in made: the
    rotation's components carry the rounding of both quaternions and of
    their product in the retraction (8 roundings of the magnitudes' product
    q_out (x) q_in, the rotation vector being twice the quaternion's); the
    translation's the rounding of both translations, of t_in rotated in
    float32 (4 roundings of its norm) and t_in turned by the rotation's
    own resolution."""
    q_in, q_out = P_in[:, 3:7].abs(), P_out[:, 3:7].abs()
    x1, y1, z1, w1 = q_out.unbind(-1)
    x2, y2, z2, w2 = q_in.unbind(-1)
    qq = torch.stack([w1 * x2 + x1 * w2 + y1 * z2 + z1 * y2,
                      w1 * y2 + x1 * z2 + y1 * w2 + z1 * x2,
                      w1 * z2 + x1 * y2 + y1 * x2 + z1 * w2], -1)
    rot = 8.0 * EPS32 * qq
    t_norm = torch.linalg.vector_norm(P_in[:, :3], dim=-1, keepdim=True)
    trans = (EPS32 * (P_in[:, :3].abs() + P_out[:, :3].abs() + 4.0 * t_norm)
             + torch.linalg.vector_norm(rot, dim=-1, keepdim=True) * t_norm)
    return torch.cat([trans, rot], -1)


def _ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den, 0 where num is 0, NaN where either is NaN."""
    return torch.where(num == 0, num * den, num / den.clamp_min(1e-300))


def ba_gaps(seq: Sequence, call: dict, out_poses: torch.Tensor, out_patches_fm: torch.Tensor):
    """How far one Gauss-Newton step's outputs (the program's, or the
    control's) are from solving the step that the reference assembles in
    float64 from the same inputs, as componentwise backward errors: each
    equation's residual at the outputs against the sum of the magnitudes of
    its terms. Random tracks leave this traffic's systems ill-conditioned
    (depths driven to their clamp, directions left free), so the outputs
    themselves may differ far more than the precision does; backward errors
    do not depend on the conditioning. The gate's decisions are taken in
    float32 from the float32 inputs, as the step takes them.

    Each residual is first reduced by what float32 rounding alone can move
    it, first order: the stored poses and depths (a step smaller than
    their rounding reads 0), each projection (R_ROUNDINGS roundings of its
    magnitude) and each relative translation (T_ROUNDINGS roundings of
    |t_i| + |t_j|; an edge from a frame to itself has an exactly zero
    depth Jacobian, which float32 makes noise of that size, and a patch
    held by nothing else moves by that noise over its damping), and the
    edges whose gate decision lies within G_ROUNDINGS roundings of its
    threshold (the program evaluates the gated quantities in another order
    and may decide them the other way: their whole terms). What is left is
    then divided by the magnitudes of the equation's terms.

    pose: the largest over the rows of the damped reduced system A dx = y
    (the smaller over the solve's two dampings), dx read back from the
    poses as Log(P_out P_in^-1): one per row (of the solve's damping that
    reads better), None in the structure-only pass. disp: one per patch of
    the window with an edge and off the clamp, of C dZ = w - E^T dx (w
    alone in the structure-only pass), dZ read back from the depths.
    Returns (pose, disp)."""
    d, slam = seq.dims, seq.slam
    f64 = torch.float64
    call = {k: v for k, v in call.items() if k != "prev"}
    c32 = {k: (v.float() if torch.is_tensor(v) and v.is_floating_point() else v)
           for k, v in call.items()}
    e32 = rs.slot_edges(c32["targets"], c32["weights"], c32["valid"], c32["slot_start"], d.kf)
    ok = rs.gate(c32["poses"], c32["patches_fm"], c32["intrinsics"], e32, c32["n"], c32["base_f"], d)
    c = {k: (v.to(f64) if torch.is_tensor(v) and v.is_floating_point() else v)
         for k, v in call.items()}
    e = rs.slot_edges(c["targets"], c["weights"], c["valid"], c["slot_start"], d.kf)
    sy = rs.assemble(c["poses"], c["patches_fm"], c["monodisp_fm"], c["intrinsics"], e,
                     c["t0"], c["n"], c["base_f"], d, slam, ok=ok, t_eps=T_ROUNDINGS * EPS32,
                     g_eps=G_ROUNDINGS * EPS32)
    C, w, E2, Q = sy["C"], sy["w"], sy["E2"], sy["Q"]
    E2a, dE = sy["E2_abs"], sy["E2_slack"] + sy["E2_amb"]
    # what rounding can move of w and C (and so of Q)
    dw = R_ROUNDINGS * EPS32 * sy["w_tm"] + sy["w_slack"] + sy["w_amb"]
    dC = sy["C_slack"] + sy["C_amb"]
    pose = None
    rhs, scale, slack = w, sy["w_abs"], dw
    if not c["structure_only"]:
        t0, W = c["t0"], d.window
        hi = min(d.N, t0 + W)
        P_in, P_out = c["poses"][t0:hi], out_poses.to(f64)[t0:hi]
        dx = torch.zeros((W, 6), dtype=f64, device=P_in.device)
        dx[:hi - t0] = g.se3_log(g.se3_mul(unit(P_out), g.se3_inv(unit(P_in))))
        dx = dx.reshape(-1)
        res = torch.zeros((W, 6), dtype=f64, device=P_in.device)
        res[:hi - t0] = pose_resolution(P_in, P_out)
        res = res.reshape(-1)
        adx = dx.abs()
        dQ = Q * Q * dC
        S = sy["B"] - (E2 * Q) @ E2.T
        S_abs = sy["B_abs"] + (E2a * Q) @ E2a.T
        y = sy["v"] - E2 @ (Q * w)
        y_abs = sy["v_abs"] + E2a @ (Q * sy["w_abs"])
        # first-order reach of rounding in S dx and y: E, Q, w and v moved
        dS_dx = (sy["B_amb"] @ adx + dE @ (Q * (E2a.T @ adx)) + E2a @ (Q * (dE.T @ adx))
                 + E2a @ (dQ * (E2a.T @ adx)))
        dy = (R_ROUNDINGS * EPS32 * sy["v_tm"] + sy["v_slack"] + sy["v_amb"] + dE @ (Q * w.abs())
              + E2a @ (dQ * w.abs()) + E2a @ (Q * dw))
        for lm in (1e-4, 1e-3):
            A = rs.damped(S, lm, slam["BA_EP"])
            A_abs = S_abs + torch.diag(slam["BA_EP"] + lm * torch.diagonal(S).abs())
            num = ((A @ dx - y).abs() - A_abs @ res - dS_dx - dy).clamp_min(0.0)
            eta = _ratio(num, A_abs @ adx + y_abs)
            if pose is None or _worst(eta) < _worst(pose):
                pose = eta
        rhs = w - E2.T @ dx
        scale = scale + E2a.T @ adx
        slack = slack + E2a.T @ res + dE.T @ adx
    rows = slice(c["base_f"], min(d.N, c["base_f"] + d.patch_window))
    n_rows = rows.stop - rows.start
    z_in = c["patches_fm"][rows, :, 2].reshape(-1)
    z_out = out_patches_fm[rows, :, 2].to(f64).reshape(-1)
    dZ = z_out - z_in
    k = slice(0, n_rows * d.M)
    rnd = EPS32 * (z_in.abs() + z_out.abs())
    num = ((C[k] * dZ - rhs[k]).abs() - C[k] * rnd - dC[k] * dZ.abs() - slack[k]).clamp_min(0.0)
    eta = _ratio(num, C[k] * dZ.abs() + scale[k])
    clamped = (z_out <= float(np.float32(1e-3))) | (z_out >= 10.0)
    return pose, eta[sy["has"][k] & ~clamped]


def _worst(eta: torch.Tensor) -> float:
    """The largest, infinite where a NaN is."""
    if not eta.numel():
        return 0.0
    return float("inf") if bool(torch.isnan(eta).any()) else float(eta.max())


def reference_ba_low(seq: Sequence, call: dict):
    """The control of the backend: the reference's Gauss-Newton step in
    float32 with every product's inputs rounded to TF32 (the step below
    the configuration's float32 with TF32 off), from the same inputs."""
    c = {k: (v.float() if torch.is_tensor(v) and v.is_floating_point() else v)
         for k, v in call.items()}
    e = rs.slot_edges(c["targets"], c["weights"], c["valid"], c["slot_start"], seq.dims.kf)
    return rs.ba_step(c["poses"], c["patches_fm"], c["monodisp_fm"], c["intrinsics"], e,
                      c["t0"], c["n"], c["base_f"], seq.dims, seq.slam, c["structure_only"],
                      rnd=rs.round_tf32)


def updates_due(sample: dict, slam: dict) -> int:
    n1 = sample["n"] + 1
    if n1 == slam["num_init"] + 1 and not sample["initialized"]:
        return 12
    return 1 if sample["initialized"] else 0


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b|; infinite where either holds a NaN."""
    if not a.numel():
        return 0.0
    d = (a.double() - b.double()).abs()
    return float("inf") if bool(torch.isnan(d).any()) else float(d.max())


TRACK_TOL_PX = 0.25   # a quarter pixel of the frame
VIS_TOL = 0.25        # in the visibility's logit


def _tracker_stats(tracks, vis, ref_tracks, ref_vis) -> Dict[str, float]:
    """track_px: the share of live tracks further than TRACK_TOL_PX from
    the reference's; vis: the share of live visibilities whose logit is
    further than VIS_TOL from the reference's; with the mean and largest
    gaps beside them."""
    err = (tracks.double() - ref_tracks.double()).norm(dim=-1)
    verr = (_logit(vis) - _logit(ref_vis)).abs()
    if bool(torch.isnan(err).any() or torch.isnan(verr).any()):
        return {"track_px": float("inf"), "vis": float("inf")}
    return {"track_px": float((err > TRACK_TOL_PX).double().mean()),
            "vis": float((verr > VIS_TOL).double().mean()),
            "track_mean": float(err.mean()), "track_max": float(err.max()),
            "vis_max": float(verr.max())}


def _logit(v: torch.Tensor) -> torch.Tensor:
    v = v.double().clamp(1e-12, 1 - 1e-12)
    return torch.log(v) - torch.log1p(-v)


def _rel_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest gap relative to the reference's largest magnitude."""
    scale = float(ref.double().abs().max()) if ref.numel() else 0.0
    return _gap(prog, ref) / max(scale, STEP_FLOOR)


# below this a change or a magnitude is compared as it stands
STEP_FLOOR = 1e-6


def loop_gaps(seq: Sequence, s: dict, gate_st: dict) -> Dict[str, float]:
    """The loop's stages around the backend update, each against the
    program's own state: ingest and gate against what the first
    Gauss-Newton step read (or the state after the call where none ran),
    culling and the point-cloud refresh against the state after a call
    with one update, the trajectory terminate() returned, and each read
    step's start against the outputs of the step before it."""
    d, slam = seq.dims, seq.slam
    M = d.M
    n1 = s["n"] + 1
    calls, after = s["ba_calls"], s["after"]
    out = {}
    if calls:
        c0 = calls[0]
        rows = slice(0, n1)
        out["poses_in"] = _rel_gap(c0["poses"][rows], gate_st["poses"][rows])
        out["patches_in"] = _rel_gap(c0["patches_fm"][rows], gate_st["patches"].reshape(d.N, M, 3)[rows])
        e = gate_st
        R = d.ring
        shape = (R, d.n_src, M, d.S)
        w = e["e_weight_pose"] if not c0["structure_only"] else e["e_weight"]
        out["edges_in"] = max(_rel_gap(c0["targets"], e["e_target"][:, :2].reshape(shape + (2,))),
                              _rel_gap(c0["weights"], w.reshape(shape + (2,))),
                              _rel_gap(c0["valid"], e["e_valid"].reshape(shape)))
        mid = (d.S_local + 1) // 2 - 1
        lo, hi = max(n1 - d.patch_window, 0), n1
        mono = e["local_targets"][lo * M - e["row0"]:hi * M - e["row0"], mid, 2]
        out["monodisp_in"] = _rel_gap(c0["monodisp_fm"][lo:hi].reshape(-1), mono)
    else:
        out["poses_out"] = _rel_gap(after["poses"][:n1], gate_st["poses"][:n1])
        out["patches_out"] = _rel_gap(after["patches"][:n1 * M], gate_st["patches"][:n1 * M])
    if updates_due(s, slam) == 1 and len(calls) == 2 * slam["ITER"]:
        last = calls[-1]
        poses, patches = last["out_poses"], last["out_patches_fm"].reshape(-1, 3)
        for key in ("e_weight", "e_weight_pose"):
            ref = rs.map_filter(poses, patches, gate_st["intrinsics"], gate_st["e_kk"],
                                gate_st["e_jj"], gate_st["e_target"], gate_st[key], M,
                                slam["MAP_FILTERING_TH"])
            out["cull"] = max(out.get("cull", 0.0), _rel_gap(after[key], ref))
        cloud = dict(gate_st, poses=poses, patches=patches,
                     local_targets=gate_st["local_targets"].clone())
        rs.refresh_cloud(cloud, n1, d)
        out["cloud"] = _rel_gap(after["local_targets"], cloud["local_targets"])
    if "trajectory" in s:
        out["trajectory"] = float(np.abs(s["trajectory"][0] - rs.trajectory(
            after["poses"][:s["length"]])).max())
    # each step starts from what the step before it returned, also across
    # the updates of an initialisation
    for c in calls:
        if c["prev"] is not None:
            out["chain_poses"] = max(out.get("chain_poses", 0.0), _gap(c["poses"], c["prev"][0]))
            out["chain_patches"] = max(out.get("chain_patches", 0.0),
                                       _gap(c["patches_fm"], c["prev"][1]))
    return out


def compare(samples: List[dict], scene: tuple, config: dict, device, control: bool = False,
            tracker_weights=None, log=None) -> Dict[str, float]:
    """The readings over the checked frames: the program's outputs against
    the reference. With `control`, the control's outputs stand in for the
    program's (the tracker append in float8, each Gauss-Newton step in
    TF32, from the same inputs) and are read the same way; the loop stages
    around them stay the program's. `log` gets one line per frame."""
    shape = rt.TrackerShape.from_model(config["model"])
    ref = rt.ReferenceTracker(shape, tracker_weights)
    low = rt.ReferenceTracker(shape, tracker_weights, fp8=True) if control else None
    out = {k: 0.0 for k in NUMBERS}
    counts = {"appends": 0, "steps": 0, "ends": 0}
    images, depths = scene
    with rt.exact_float32():
        for s in samples:
            seq = Sequence(s["seq_seed"], images, depths, config, device)
            n1 = s["n"] + 1
            line = {"seq": s["seq"], "t": s["t"], "kinds": s["kinds"]}
            prog = s.get("tracker")
            if prog is not None:
                tr, dp, vs, dy, live, _ = reference_append(seq, n1, ref)
                judged = prog
                if control:
                    ctr, _, cvs, _, _, _ = reference_append(seq, n1, low)
                    judged = {"tracks": ctr, "vis": cvs}
                counts["appends"] += 1
                line.update(_tracker_stats(judged["tracks"][live], judged["vis"][live], tr[live],
                                           vs[live]))
                out["track_px"] = max(out["track_px"], line["track_px"])
                out["vis"] = max(out["vis"], line["vis"])
            counts["steps"] += 1
            gate_st = reference_gate(seq, s, prog)
            loop = loop_gaps(seq, s, gate_st)
            line["loop"] = loop
            if any(not v <= LOOP_TOL for v in loop.values()):
                out["ba"] = 1.0
            calls = s["ba_calls"]
            if updates_due(s, seq.slam) and not calls:
                line["missing_update"] = True
                out["ba"] = 1.0
            for c in calls:
                outs = reference_ba_low(seq, c) if control else (c["out_poses"], c["out_patches_fm"])
                pose, disp = ba_gaps(seq, c, *outs)
                eta = disp if pose is None else torch.cat([pose, disp])
                # the share of the step's equations off (a NaN is off), the
                # worst step of the run; the log keeps the worst equation too
                share = float((~(eta <= BA_TAU)).double().mean()) if eta.numel() else 0.0
                line.setdefault("share", []).append(share)
                line.setdefault("worst", []).append(_worst(eta))
                out["ba"] = max(out["ba"], share)
            if "trajectory" in s:
                counts["ends"] += 1
            if log is not None:
                log(line)
    out.update({f"count.{k}": v for k, v in counts.items()})
    return out
