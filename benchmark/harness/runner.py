"""One run of one cell: set-up (kernels, weights, the scene, the stream
warmed to its entry frame), the measured window, the reading of the trace, then
the check against the reference once the program's state is freed."""

from __future__ import annotations

import os
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import check, scene, spec, streams, trace, traffic, weights
from reference import tracker as rt

FORBIDDEN = ("jax", "jaxlib", "flax", "batrack_tpu")
TRACE_START, TRACE_LENGTH = 0.5, 2.0   # the traced sub-window: its share of the window in, seconds


def process_start_time() -> float:
    """This process's start on the host's realtime clock (from /proc), so
    that set-up counts the interpreter's start and the imports."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> List[str]:
    """Modules of the JAX package or JAX loaded in this process, by whole
    top-level name (batrack_tpu_torch is not batrack_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def port_config(c: dict):
    """The port's Config object for a configuration file."""
    from batrack_tpu_torch.utils.config import Config, MotionLabelConfig

    cfg = Config()
    for group in ("slam", "model"):
        obj = getattr(cfg, group)
        for k, v in c[group].items():
            if k == "motion_label_block" and isinstance(v, dict):
                v = MotionLabelConfig(**v)
            elif k == "interp_shape":
                v = tuple(v)
            setattr(obj, k, v)
    return cfg


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def launch_counts() -> Dict[str, int]:
    """The port's kernel launch counters (ops.launch_counts(); K1 is
    `corr_sample`, K2 `fused_qkv_attention`)."""
    from batrack_tpu_torch import ops

    return dict(ops.launch_counts())


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
             control: bool = False, t_start: Optional[float] = None, log=None) -> Dict:
    """Runs the cell once; returns the result line's dict and, under
    `_run`, what the metric readers read. With `control` the control's
    outputs stand in for the program's in the check (check.compare), so
    `correct` is the control's, and the program's readings are returned
    beside it under `_program_readings`. `log` gets a dict for each set-up stage's
    end and each frame the check read."""
    log = log or (lambda d: None)
    t_start = process_start_time() if t_start is None else t_start
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    torch.set_num_threads(1)
    from batrack_tpu_torch.slam import BATrack
    from batrack_tpu_torch.tracker import MDTrackerAdapter

    conf, mix = cell.config, cell.traffic
    fr = conf["frame"]
    ht, wd = fr["height"], fr["width"]
    cfg = port_config(conf)
    if dev.type == "cuda":
        from batrack_tpu_torch.ops import cuda_build

        cuda_build.build(["corr_sample", "fused_qkv_attention"])
    log({"setup": "kernels", "s": time.time() - t_start})

    # ---- weights, made on the device and handed to the port ------------
    shape = rt.TrackerShape.from_model(conf["model"])
    wrec = conf["weights"]
    w = weights.make_weights(rt.param_shapes(shape), seed, dev, wrec["flow_head_scale"],
                             wrec["vis_bias"], dtype=getattr(torch, conf["model"]["compute_dtype"]))
    s = conf["slam"]
    adapter = MDTrackerAdapter(cfg.model, state_dict=w, seed=0, device=dev,
                               backward_tracking=s["backward_tracking"] and s["S_slam"] > shape.S)
    log({"setup": "weights", "s": time.time() - t_start})
    clock = streams.Clock(dev)
    env = SimpleNamespace(cfg=cfg, ht=ht, wd=wd, intr=np.asarray(fr["intrinsics"], np.float32),
                          device=dev, BATrack=streams.timed_batrack(BATrack), adapter=adapter,
                          clock=clock)

    # ---- the stream: frames from the seed, warmed to its entry frame ----
    plan = traffic.plan_stream(mix, seed)
    frames = scene.make_scene(max(mix["lengths"]), ht, wd, fr["intrinsics"], plan.scene_seed, dev,
                              conf["scene"]["camera_motion"])
    stream = streams.Stream(env, plan, *frames, traced)
    log({"setup": "scenes", "s": time.time() - t_start})
    dtrace = trace.DeviceTrace(TRACE_START * seconds, min(TRACE_LENGTH, 0.4 * seconds)) \
        if traced and dev.type == "cuda" else None
    stream.warm(dtrace)

    # ---- the window ------------------------------------------------------
    log({"setup": "warm", "entry": plan.entry, "s": time.time() - t_start})
    setup_s = time.time() - t_start
    launches0 = launch_counts()
    start = clock.mark()
    t0 = time.perf_counter()
    stream.window(t0, t0 + seconds, dtrace)
    launches = {k: v - launches0.get(k, 0) for k, v in launch_counts().items()}

    run = SimpleNamespace(seconds=seconds, trace=dtrace, setup_s=setup_s, config=conf,
                          device=dev, host_ms=stream.host_ms, frame_encoded=stream.frame_encoded,
                          launches=launches)
    run.completions = [clock.ms(start, m) for m in stream.completions]
    run.peak_bytes = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    run.pairs = {name: [clock.ms(a, b) for a, b in stream.probe.pairs[name]]
                 for name in ("tracker", "ba_update")}

    metrics = spec.read_metrics(cell.per_layer if traced else cell.end_to_end, run)
    if not traced:
        # what the per-layer readers find without a trace, on standard error only
        log({"untraced": {k: v["value"] for k, v in spec.read_metrics(cell.per_layer, run).items()}})
    attempted = len(stream.host_ms)

    # ---- the check, after the program's state is freed -----------------
    samples = stream.samples
    stream.slam = stream.next_frame = stream.tracker = env = None
    del adapter
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.time()
    readings = check.compare(samples, frames, conf, dev, control=control, tracker_weights=w,
                             log=log)
    log({"check_s": time.time() - t_check})
    program_readings = (check.compare(samples, frames, conf, dev, tracker_weights=w)
                        if control else readings)
    limits = conf["limits"]
    compared = {k: {"value": readings[k], "limit": limits.get(k)} for k in check.NUMBERS}
    correct = (all(v["limit"] is not None and v["value"] <= v["limit"] for v in compared.values())
               and readings["count.appends"] > 0 and readings["count.steps"] > 0)
    found = forbidden_modules()
    device_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                  "count": 1, "memory_peak_bytes": int(run.peak_bytes)}
    if dev.type == "cuda":
        device_rec["power"] = power_limit()
    result = {"correct": bool(correct and not found), "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": device_rec}
    if traced and dtrace is not None:
        device_rec["busy_s"] = dtrace.busy_s()
        device_rec["window_s"] = dtrace.window_s
        result["breakdown"] = {"device_ops": dtrace.top_ops(),
                               "idle_gaps": trace.idle_by_host(dtrace.gaps(), stream.probe.spans)}
    result["check"] = compared
    result["_readings"] = readings
    result["_program_readings"] = program_readings
    result["_found"] = found
    result["_run"] = run
    return result
