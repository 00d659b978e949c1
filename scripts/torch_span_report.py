"""The program's spans over one run of a benchmark cell, on the card.

A stand-in, to be deleted once a `benchmark` PR turns the port's tracer on
in `benchmark/harness/runner.py` and adds the `spans` and `setup_spans`
breakdown keys (PERF.md, Open questions): it patches the harness's
`streams.Stream.__init__` and `trace.DeviceTrace.finish` to reach the
stream and the launch events, so a change to either breaks it.

    python scripts/torch_span_report.py [--workload slam.davis_demo.eval_streams]
        [--seed N] [--seconds 51] [--tracer on|off] [--trace 1|0] [--clock-check] [--cost]

Runs the cell once in this process through the benchmark's own runner
(benchmark/harness/runner.py; with `--trace 1` traced as the benchmark's
traced run is, the device trace over its usual sub-window) with the port's
process tracer (utils/profiling.py::tracer) on from the process's start,
and prints one JSON line:

- `metrics`: the cell's per-layer metrics, as `benchmark/run.py --trace 1`
  prints them (those a run without the device trace can read, with
  `--trace 0`), and `whole_window`: the host ms per append of the
  tracker's glue (its `tracker` spans outside `.encode`, `.corr` and
  `.former`) and of `tracker.former`, and per update of `ba_update`, over
  every window frame (inside the traced sub-window CUPTI inflates them);
- `spans`: the 15 span names with the most self time (the span less its
  children), each with host self-ms per window frame, the device's idle
  seconds inside those self intervals in the traced sub-window, and the
  device operations launched from them per sub-window frame (from the
  profiler's runtime launch events);
- `setup`: `setup_s` split into the runner's stages (kernels, weights,
  scenes, warm-up) and into the spans that ran before the window
  (`setup.kernels`, `tracker.init`, `sequence.init`, warm-up `frame`s);
- `agreement`: the program's `tracker` and `ba_update` spans (host and
  device event pair) against the harness's own wrappers around the same
  calls, per call over the window (`--trace 1`: the wrappers time only
  traced runs), and the spans' host ms inside the profiled sub-window;
- `counters`: the tracer's counters over the run.

`--tracer off` runs the same with the tracer off throughout (it does not
follow the profiler either), for the tracer's cost on `host_ms_per_frame`
and `loop_frames_per_s`. `--clock-check` first times a lone
`torch.cuda._sleep` inside a span on the idle card: the kernel's device
start must fall after the span's start (both on the host's realtime
clock); `--cost` times an off span, an on span and an on span with a CUDA
event pair on this host (`--seconds 0`: those alone, no run). The card's
name and power limit ride along. Each
line is also written to chiprun_out/span_report_<tracer>_t<trace>_<seed>.json.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
LAUNCH_CALLS = ("LaunchKernel", "MemcpyAsync", "MemsetAsync", "cuLaunch")
HEAVY = ("tracker.encode", "tracker.corr", "tracker.former")   # fnet, K1, the UpdateFormer


def host_ms(spans, window):
    """The tracker's glue and UpdateFormer ms per append and the backend's
    host ms per update, over the spans inside `window` (ns pair)."""
    inside = [i for i, s in enumerate(spans) if s is not None
              and window[0] <= s.start_ns and s.end_ns <= window[1]]
    children = defaultdict(list)
    for i in inside:
        children[spans[i].parent].append(i)

    def below(i):
        out, stack = [], [i]
        while stack:
            for k in children[stack.pop()]:
                out.append(k)
                stack.append(k)
        return out

    def ms(i):
        return (spans[i].end_ns - spans[i].start_ns) / 1e6

    appends = [i for i in inside if spans[i].name == "tracker"]
    updates = [i for i in inside if spans[i].name == "ba_update"]
    glue = former = 0.0
    for i in appends:
        under = below(i)
        former += sum(ms(k) for k in under if spans[k].name == "tracker.former")
        # the three do not nest in one another
        glue += ms(i) - sum(ms(k) for k in under if spans[k].name in HEAVY)
    return {"tracker_glue_ms_per_append": glue / len(appends) if appends else None,
            "tracker_former_ms_per_append": former / len(appends) if appends else None,
            "ba_host_ms_per_update": (sum(ms(i) for i in updates) / len(updates)
                                      if updates else None)}


def span_table(spans, window, sub, gaps, launches, k: int = 15):
    """The k names with the most self time inside `window` (ns pair)."""
    from batrack_tpu_torch.utils.profiling import self_intervals
    from harness.spans import covered_ns

    own = dict(enumerate(self_intervals(spans)))
    frames = sum(1 for s in spans if s is not None and s.name == "frame"
                 and window[0] <= s.start_ns and s.end_ns <= window[1])
    sub_frames = sum(1 for s in spans if s is not None and s.name == "frame"
                     and sub[0] <= s.start_ns and s.end_ns <= sub[1])
    rows = defaultdict(lambda: {"self_ms": 0.0, "idle_s": 0.0, "launches": 0, "calls": 0})
    by_name = defaultdict(list)
    for i, cut in own.items():
        s = spans[i]
        if s is None:
            continue
        if window[0] <= s.start_ns and s.end_ns <= window[1]:
            rows[s.name]["self_ms"] += sum(b - a for a, b in cut) / 1e6
            rows[s.name]["calls"] += 1
        if sub[0] <= s.start_ns and s.end_ns <= sub[1]:
            by_name[s.name] += cut
    for name, cut in by_name.items():
        rows[name]["idle_s"] = covered_ns(gaps, cut) / 1e9
        rows[name]["launches"] = sum(bisect.bisect_left(launches, b)
                                     - bisect.bisect_left(launches, a) for a, b in cut)
    out = []
    for name, r in sorted(rows.items(), key=lambda x: -x[1]["self_ms"])[:k]:
        out.append({"span": name, "self_ms_per_frame": r["self_ms"] / max(frames, 1),
                    "calls_per_frame": r["calls"] / max(frames, 1), "idle_s": r["idle_s"],
                    "launches_per_frame": (r["launches"] / sub_frames
                                           if launches and sub_frames else None)})
    return out, frames, sub_frames


def clock_check(reps: int = 5):
    """A span around one `torch.cuda._sleep` on an idle card, profiled:
    the kernel's device start against the span's start and end (ms)."""
    import torch

    from batrack_tpu_torch.utils.profiling import StageTimer

    tm = StageTimer(enabled=True)
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        time.sleep(0.05)
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        with tm.span("sleep"):
            torch.cuda._sleep(2_000_000)
        torch.cuda.synchronize()
        prof.stop()
        span = tm.spans[-1]
        cuda = torch.autograd.DeviceType.CUDA
        starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
                  if e.device_type() == cuda]
        if not starts:
            out.append({"kernel": None})
            continue
        k = min(starts)
        out.append({"after_span_start": k >= span.start_ns,
                    "lag_ms": (k - span.start_ns) / 1e6,
                    "span_ms": (span.end_ns - span.start_ns) / 1e6})
    return out


def span_cost(n: int = 20000):
    """Host us per `with tracer.span(...)`: off, on, on with a CUDA pair."""
    import torch

    from batrack_tpu_torch.utils.profiling import StageTimer

    out = {}
    for label, on, device in (("off", False, False), ("on", True, False),
                              ("on_device", True, True)):
        tm = StageTimer(enabled=on)
        t0 = time.perf_counter()
        for _ in range(n):
            with tm.span("x", device=device):
                pass
        out[label + "_us"] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    return out


def span_report(cell, seed: int, seconds: float, tracer_on: bool, traced: bool = True,
                device: str = "cuda"):
    import torch

    from batrack_tpu_torch.utils import profiling
    from harness import runner, spec, streams, trace

    tr = profiling.tracer()
    tr.reset()
    tr.enabled = tracer_on
    tr.follow_profiler = tracer_on
    made, stages, launches = [], {}, []
    init, finish = streams.Stream.__init__, trace.DeviceTrace.finish

    def keep_stream(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    def keep_launches(self):
        prof = self._prof
        finish(self)
        if prof is not None:
            cpu = torch.autograd.DeviceType.CPU
            launches.extend(e.start_ns() for e in prof.profiler.kineto_results.events()
                            if e.device_type() == cpu
                            and any(c in e.name() for c in LAUNCH_CALLS))

    def log(d):
        if "setup" in d:
            stages[d["setup"]] = d["s"]

    t_start = runner.process_start_time()
    streams.Stream.__init__, trace.DeviceTrace.finish = keep_stream, keep_launches
    try:
        out = runner.run_cell(cell, seed, seconds, traced, device=device, log=log,
                              t_start=t_start)
    finally:
        streams.Stream.__init__, trace.DeviceTrace.finish = init, finish
        tr.enabled = False
    run, stream = out["_run"], made[0]
    layer = spec.read_metrics(cell.per_layer, run)
    result = {"metrics": {k: v["value"] for k, v in layer.items()}, "correct": out["correct"],
              "device": out["device"], "setup_s": run.setup_s, "setup_stages": stages,
              "tracer": "on" if tracer_on else "off", "harness_trace": int(traced)}
    if not tracer_on:
        return result
    tr.resolve()
    spans = tr.spans
    start = int((t_start + run.setup_s) * 1e9)
    frames = [s for s in spans if s is not None and s.name == "frame" and s.start_ns >= start]
    window = (start, max(s.end_ns for s in frames))
    inside = [s for s in spans if s is not None and window[0] <= s.start_ns
              and s.end_ns <= window[1]]
    result.update(window_frames=len(frames), counters=dict(tr.counters),
                  spans_per_frame=len(inside) / len(frames),
                  device_spans_per_frame=sum(1 for i in tr.device_ms
                                             if window[0] <= spans[i].start_ns <= window[1])
                  / len(frames))
    result["whole_window"] = host_ms(spans, window)
    dtrace = run.trace
    if dtrace is not None:
        sub = (dtrace.t0, dtrace.t1)
        table, _, sub_frames = span_table(spans, window, sub, dtrace.gaps(), sorted(launches))
        result.update(sub_window_frames=sub_frames, sub_window_s=dtrace.window_s,
                      launch_events=len(launches))
    else:
        table, _, _ = span_table(spans, window, (0, 0), [], [])
    result["spans"] = table

    def before(name):
        return [s for s in spans if s is not None and s.name == name and s.end_ns < window[0]]

    def total_s(xs):
        return sum(s.end_ns - s.start_ns for s in xs) / 1e9

    warm = before("frame")
    kernels_in_frames = [s for s in before("setup.kernels")
                         if any(f.start_ns <= s.start_ns and s.end_ns <= f.end_ns for f in warm)]
    named = {"setup.kernels": total_s(before("setup.kernels")),
             "tracker.init": total_s(before("tracker.init")),
             "sequence.init": total_s(before("sequence.init")),
             "warm_frames_less_kernels": total_s(warm) - total_s(kernels_in_frames),
             "warm_frames": len(warm)}
    named["rest"] = run.setup_s - (named["setup.kernels"] + named["tracker.init"]
                                   + named["sequence.init"] + named["warm_frames_less_kernels"])
    result["setup_spans"] = named

    def mean(xs):
        return sum(xs) / len(xs) if xs else None

    agree = {}
    probe = stream.probe.spans
    for name in ("tracker", "ba_update"):
        idx = [i for i, s in enumerate(spans) if s is not None and s.name == name
               and window[0] <= s.start_ns and s.end_ns <= window[1]]
        row = {"program_host_ms": mean([(spans[i].end_ns - spans[i].start_ns) / 1e6
                                        for i in idx]),
               "program_device_ms": mean([tr.device_ms[i] for i in idx if i in tr.device_ms]),
               "calls": len(idx)}
        if traced:
            row.update(harness_host_ms=mean([(b - a) / 1e6 for n, a, b in probe if n == name]),
                       harness_device_ms=mean(run.pairs[name]),
                       harness_calls=len(run.pairs[name]))
        if dtrace is not None:
            row["program_host_ms_profiled"] = mean([
                (spans[i].end_ns - spans[i].start_ns) / 1e6 for i in idx
                if dtrace.t0 <= spans[i].start_ns and spans[i].end_ns <= dtrace.t1])
        agree[name] = row
    result["agreement"] = agree
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", default="slam.davis_demo.eval_streams")
    parser.add_argument("--seed", type=int, default=4294970001)
    parser.add_argument("--seconds", type=float, default=51.0)
    parser.add_argument("--tracer", choices=("on", "off"), default="on")
    parser.add_argument("--trace", type=int, choices=(0, 1), default=1,
                        help="the harness's own trace (1: as benchmark/run.py --trace 1)")
    parser.add_argument("--clock-check", action="store_true")
    parser.add_argument("--cost", action="store_true")
    args = parser.parse_args(argv)
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path[:0] = [str(BENCH), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("the span report runs on a CUDA device")
    from harness import runner, spec

    line = {"card": runner.power_limit()}
    if args.clock_check:
        torch.zeros(1, device="cuda")
        line["clock_check"] = clock_check()
    if args.cost:
        line["span_cost"] = span_cost()
    if args.seconds > 0:
        line.update(span_report(spec.load_cell(args.workload), args.seed, args.seconds,
                                args.tracer == "on", bool(args.trace)))
    text = json.dumps(line)
    print(text, flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"span_report_{args.tracer}_t{args.trace}_{args.seed}.json").write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
