"""A whole run of the harness on the CPU at a tiny size (the port's plain
kernel versions stand in for K1 and K2): the reference agrees with the
port; the control (the reference one precision down, standing in for the
program) reads `correct` false; and each fault the cell can have, planted
under the timed path, turns `correct` false. On a card, the control of
each cell at its own size reads `correct` false at the committed limits."""

import json

import bench_paths  # noqa: F401
import pytest
import torch

from harness import runner, spec
from tiny import tiny_cell

SEED = 2 ** 31 + 77
WINDOW = 6.0   # seconds: the tiny mix's window then holds an initialisation and a sequence end


def run(cell, **kw):
    return runner.run_cell(cell, SEED, WINDOW, False, device="cpu", **kw)


@pytest.fixture(scope="module")
def control():
    return run(tiny_cell(), control=True)


def test_the_port_agrees_with_the_reference(control):
    r = control["_program_readings"]
    assert r["count.appends"] > 0 and r["count.steps"] > 0 and r["count.ends"] > 0
    limits = tiny_cell().config["limits"]
    assert all(r[k] <= v for k, v in limits.items()), r


def test_the_control_in_the_programs_place_is_not_correct(control):
    assert not control["correct"], control["check"]


def test_the_backends_control_fails_the_backends_number(control):
    # the TF32 step alone, not only the float8 tracker, is caught
    r, limits = control["_readings"], tiny_cell().config["limits"]
    assert r["ba"] > limits["ba"], r


def _shift_tracks(monkeypatch):
    from batrack_tpu_torch.tracker import adapter as mod

    orig = mod.MDTrackerAdapter.__call__

    def altered(self, tin):
        out = orig(self, tin)
        return out._replace(tracks=out.tracks + 0.5)

    monkeypatch.setattr(mod.MDTrackerAdapter, "__call__", altered)


def _state_unchanged(monkeypatch):
    from batrack_tpu_torch.slam import system

    monkeypatch.setattr(system, "slam_update", lambda *a, **k: None)


def _half_the_tracks(monkeypatch):
    # the tracker computes only the first half of the queries; the rest of
    # its outputs are left at zero
    from batrack_tpu_torch.tracker import adapter as mod

    orig = mod.MDTrackerAdapter.__call__

    def half(self, tin):
        h = tin.queries.shape[0] // 2
        out = orig(self, tin._replace(queries=tin.queries[:h]))
        return type(out)(*(torch.cat([x, torch.zeros_like(x)], dim=1) for x in out))

    monkeypatch.setattr(mod.MDTrackerAdapter, "__call__", half)


def _step_fault(monkeypatch, alter):
    from batrack_tpu_torch.slam import update

    orig = update.slot_ba_iteration_fm

    def step(poses, patches_fm, monodisp_fm, intrinsics, graph, t0, n, base_f, **kw):
        out_poses, out_patches = orig(poses, patches_fm, monodisp_fm, intrinsics, graph, t0, n,
                                      base_f, **kw)
        return out_poses, alter(patches_fm, out_patches, n)

    monkeypatch.setattr(update, "slot_ba_iteration_fm", step)


def _half_the_depth_steps(monkeypatch):
    # every Gauss-Newton step leaves the depths of half the patches unmoved
    def alter(p_in, p_out, n):
        p_out = p_out.clone()
        h = p_out.shape[1] // 2
        p_out[:, :h, 2] = p_in[:, :h, 2]
        return p_out

    _step_fault(monkeypatch, alter)


def _init_steps_altered(monkeypatch):
    # only the initialisation's steps (frame count num_init + 1) go wrong:
    # their depth steps are a tenth short
    num_init = tiny_cell().config["slam"]["num_init"]

    def alter(p_in, p_out, n):
        if n != num_init + 1:
            return p_out
        p_out = p_out.clone()
        p_out[..., 2] = p_in[..., 2] + 0.9 * (p_out[..., 2] - p_in[..., 2])
        return p_out

    _step_fault(monkeypatch, alter)


@pytest.mark.parametrize("fault", [_shift_tracks, _state_unchanged, _half_the_tracks,
                                   _half_the_depth_steps, _init_steps_altered],
                         ids=["answer_altered", "state_unchanged", "half_the_batch",
                              "half_the_depth_steps", "init_steps_altered"])
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = run(tiny_cell())
    assert not out["correct"], out["check"]


CELLS = [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct_at_the_committed_limits_on_a_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs the port's kernels at its own size")
    out = runner.run_cell(spec.load_cell(workload), 2 ** 31 + 1234, 25.0, False, control=True)
    assert out["_program_readings"]["count.steps"] > 0
    assert not out["correct"], out["check"]
