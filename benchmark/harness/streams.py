"""The closed-loop evaluation stream: whole sequences back to back through
the port's online loop (`BATrack.__call__`, an injected `MDTrackerAdapter`
for the appends, `terminate()` at each sequence's end), on the process's
main thread, feeding its next frame when the call returns, with
`upload_frame` one frame ahead.

The stream records, for the window, each frame's completion (a CUDA event
after the call, read once the window has closed) and the host time of its
call; in a traced run also a CUDA event pair around each tracker append
and each backend update, and the host spans the idle gaps are named by.
It copies the state around the frames the check reads (check.py)."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch

SNAPSHOT_FRAMES = 40      # rows of the local-trajectory buffers a step check reads
SNAPSHOT_BACK = 32        # ... starting this many frames before the step
MAX_STEPS = 32            # Gauss-Newton steps of one frame the check reads


@contextlib.contextmanager
def capture_steps(calls: List[dict], stride: int):
    """While one checked frame runs: every `stride`-th Gauss-Newton step of
    the backend (slam/update.py calls `slot_ba_iteration_fm` by its module
    name, once a step) is copied, inputs and outputs and the outputs of the
    step before it, into `calls`. The wrapper is in place for that frame
    only."""
    from batrack_tpu_torch.slam import update

    inner = update.slot_ba_iteration_fm
    seen = [0]
    last: List[Optional[tuple]] = [None]   # the previous step's outputs, copied

    def step(poses, patches_fm, monodisp_fm, intrinsics, graph, t0, n, base_f, **kw):
        out = inner(poses, patches_fm, monodisp_fm, intrinsics, graph, t0, n, base_f, **kw)
        k = seen[0]
        if k % stride == 0 and len(calls) < MAX_STEPS:
            calls.append({
                "poses": poses.clone(), "patches_fm": patches_fm.clone(),
                "monodisp_fm": monodisp_fm.clone(), "intrinsics": intrinsics.clone(),
                "targets": graph.targets.clone(), "weights": graph.weights.clone(),
                "valid": graph.valid.clone(), "slot_start": graph.slot_start.clone(),
                "t0": t0, "n": n, "base_f": base_f, "structure_only": kw["structure_only"],
                "out_poses": out[0].clone(), "out_patches_fm": out[1].clone(),
                # what the step before it returned: each step starts from it
                "prev": last[0]})
        last[0] = ((out[0].clone(), out[1].clone())
                   if (k + 1) % stride == 0 and len(calls) < MAX_STEPS else None)
        seen[0] += 1
        return out

    update.slot_ba_iteration_fm = step
    try:
        yield
    finally:
        update.slot_ba_iteration_fm = inner


class Clock:
    """Marks on the device's clock: a CUDA event recorded on the current
    stream, read once the window has closed; on the CPU (the harness's own
    tests) the host clock after the synchronous work."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def timed_batrack(BATrack):
    """BATrack whose backend updates report to `update_probe` (a CUDA event
    pair and a host span, in a traced run)."""

    class TimedBATrack(BATrack):
        update_probe = None

        def update(self):
            probe = self.update_probe
            if probe is None:
                return super().update()
            start = probe.begin("ba_update")
            super().update()
            probe.end("ba_update", start)

    return TimedBATrack


class Probe:
    """CUDA event pairs and host spans, on in traced runs."""

    def __init__(self, on: bool, clock: Clock):
        self.on, self.clock = on, clock
        self.active = False     # set for the window only
        self.pairs: Dict[str, List] = {"tracker": [], "ba_update": []}
        self.spans: List[tuple] = []

    def begin(self, name):
        if not (self.on and self.active):
            return None
        return self.clock.mark(), time.time_ns()

    def end(self, name, start):
        if start is None:
            return
        self.pairs[name].append((start[0], self.clock.mark()))
        self.spans.append((name, start[1], time.time_ns()))


class TrackerProbe:
    """The injected tracker: the adapter, timed in a traced run, its
    outputs copied when the check reads this append."""

    def __init__(self, adapter, probe: Probe, stream: "Stream"):
        self.adapter, self.probe, self.stream = adapter, probe, stream

    @property
    def reuse_hint(self):
        return self.adapter.reuse_hint

    @reuse_hint.setter
    def reuse_hint(self, value):
        self.adapter.reuse_hint = value

    def __call__(self, tin):
        # frames this append encodes: the window's new ones when BATrack
        # hands the previous append's features on, else all of them
        self.stream.encoded = self.adapter.reuse_hint or tin.window_rgbd.shape[0]
        start = self.probe.begin("tracker")
        out = self.adapter(tin)
        self.probe.end("tracker", start)
        sample = self.stream.sample
        if sample is not None:
            sample["tracker"] = {k: getattr(out, k).detach().clone()
                                 for k in ("tracks", "depths", "vis", "dynamic")}
        return out


class Stream:
    """The closed-loop stream. `env` carries the port's config object,
    frame size, intrinsics, device, the BATrack class and the adapter."""

    def __init__(self, env, plan, images, depths, trace: bool):
        self.env, self.plan = env, plan
        self.images, self.depths = images, depths
        self.probe = Probe(trace, env.clock)
        self.tracker = TrackerProbe(env.adapter, self.probe, self)
        self.seq = -1          # index into plan.lengths
        self.t = 0             # next frame of the current sequence
        self.slam = None
        self.next_frame = None
        self.sample: Optional[dict] = None
        self.samples: List[dict] = []
        self.want = {"append": True, "update": True, "init": True, "end": True}
        self.pending_end: Optional[dict] = None
        self.completions: List = []          # a clock mark after each window frame
        self.host_ms: List[float] = []
        self.encoded = 0                     # frames the current frame's append encoded
        self.frame_encoded: List[int] = []   # per window frame (0: no append)

    # ------------------------------------------------------------------
    def _start_sequence(self):
        if self.slam is not None:
            traj = self.slam.terminate()
            if self.pending_end is not None:
                self.pending_end["trajectory"] = traj
                self.pending_end = None
            self.slam = None
        self.seq += 1
        self.t = 0
        env = self.env
        slam = env.BATrack(env.cfg, env.ht, env.wd, seed=self.plan.seq_seeds[self.seq],
                           device=env.device)
        slam.tracker = self.tracker
        slam.update_probe = self.probe if self.probe.on else None
        self.slam = slam

    def _upload_next(self):
        """The frame after the current one, uploaded ahead: the next
        sequence's first when this one ends."""
        nxt = self.t + 1
        if nxt >= self.plan.lengths[self.seq]:
            nxt = 0
        self.next_frame = self.slam.upload_frame(self.images[nxt], self.depths[nxt])

    def frame(self, ordinal: Optional[int] = None):
        """One frame call: the sequence turnover when one has ended, then
        BATrack.__call__ on the frame uploaded ahead."""
        if self.slam is None or self.t >= self.plan.lengths[self.seq]:
            self._start_sequence()
        if self.next_frame is None:
            self.next_frame = self.slam.upload_frame(self.images[self.t], self.depths[self.t])
        cur = self.next_frame
        self._upload_next()
        self.sample = self._sample_here(ordinal)
        if self.sample is None:
            self.slam(self.t, cur[0], cur[1], self.env.intr)
        else:
            self.sample["before"] = snapshot(self.slam)
            self.sample["ba_calls"] = []
            # an initialisation frame runs num_init updates: read steps of all
            stride = 3 if "init" in self.sample["kinds"] else 1
            with capture_steps(self.sample["ba_calls"], stride):
                self.slam(self.t, cur[0], cur[1], self.env.intr)
            after = snapshot(self.slam, self.sample["before"]["row0"])
            self.sample["after"] = {k: after[k] for k in (
                "poses", "patches", "e_weight", "e_weight_pose", "local_targets")}
            self.samples.append(self.sample)
            self.sample = None
        self.t += 1

    def _sample_here(self, ordinal: Optional[int]) -> Optional[dict]:
        """Whether the check reads this frame: the first append and the
        first update-only frame at or after the plan's ordinals, the first
        initialisation frame and the first sequence end of the window."""
        if ordinal is None:
            return None
        s = self.env.cfg.slam
        t, L = self.t, self.plan.lengths[self.seq]
        kinds = []
        append = t % s.kf_stride == 0
        if self.want["append"] and ordinal >= self.plan.ordinals[0] and append:
            kinds.append("append")
        if (self.want["update"] and ordinal >= self.plan.ordinals[1] and not append
                and t > s.num_init):
            kinds.append("update")
        if self.want["init"] and t == s.num_init:
            kinds.append("init")
        if self.want["end"] and t == L - 1:
            kinds.append("end")
        if not kinds:
            return None
        for k in kinds:
            self.want[k] = False
        sample = {"seq": self.seq, "t": t, "length": L, "kinds": kinds,
                  "seq_seed": self.plan.seq_seeds[self.seq], "n": self.slam.n,
                  "initialized": self.slam.is_initialized}
        if "end" in kinds:
            self.pending_end = sample
        return sample

    # ------------------------------------------------------------------
    def warm(self, dtrace=None):
        """Set-up: the first sequence up to the stream's entry frame (its
        initialisation and reuse appends included), then a sync; the
        profiler's first start."""
        while self.seq < 0 or self.t < self.plan.entry:
            self.frame()
        if dtrace is not None:
            dtrace.warm()
        _sync(self.env.device)

    def window(self, t_start: float, t_end: float, dtrace=None):
        """Frames until the host clock passes t_end; each frame's
        completion is an event recorded after its call. With `dtrace` the
        loop profiles a sub-window of whole frames."""
        self.probe.active = True
        ordinal = 0
        while time.perf_counter() < t_end:
            if dtrace is not None:
                dtrace.between_frames(t_start)
            t0 = time.perf_counter()
            span = time.time_ns()
            self.encoded = 0
            self.frame(ordinal)
            self.host_ms.append((time.perf_counter() - t0) * 1e3)
            self.frame_encoded.append(self.encoded)
            if self.probe.on:
                self.probe.spans.append(("frame", span, time.time_ns()))
            self.completions.append(self.env.clock.mark())
            ordinal += 1
        if dtrace is not None:
            dtrace.finish()
        self.probe.active = False
        _sync(self.env.device)
        if self.pending_end is not None:
            self.pending_end["trajectory"] = self.slam.terminate()
            self.pending_end = None


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def snapshot(slam, row0: Optional[int] = None) -> dict:
    """The state a frame's backend work reads and writes: the pose, patch
    and edge buffers whole, the local-trajectory rows around the frame
    (from row0, or SNAPSHOT_BACK frames back)."""
    st, dims = slam.state, slam.dims
    M = dims.M
    f0 = max(slam.n - SNAPSHOT_BACK, 0) if row0 is None else row0 // M
    f1 = min(f0 + SNAPSHOT_FRAMES, dims.N)
    rows = slice(f0 * M, f1 * M)
    out = {k: getattr(st, k).clone() for k in (
        "poses", "intrinsics", "patches", "e_kk", "e_jj", "e_target", "e_weight",
        "e_weight_pose", "e_valid", "slot_start")}
    out["local_targets"] = st.local_targets[rows].clone()
    out["local_weights"] = st.local_weights[rows].clone()
    out["row0"] = f0 * M
    return out
