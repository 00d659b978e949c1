"""The yardstick's operation and byte counts: K1 and K2 against numbers
worked by hand at both configurations, the frozen FLOP formula against
the port's utils/flops.py."""

import json

import bench_paths  # noqa: F401
import pytest

from harness import costs, spec

SHAPES = [(96, 128), (48, 64), (24, 32), (12, 16)]   # 384x512 at stride 4, 4 levels


@pytest.mark.parametrize("N", [2400, 1536])
def test_k1_counts_by_hand(N):
    c = costs.k1_cost(12, N, 128, SHAPES, 3)
    cells = 96 * 128 + 48 * 64 + 24 * 32 + 12 * 16          # 16320 positions a frame
    n_out = N * 12 * 4 * 49
    assert c["bytes"] == 2 * 12 * 128 * cells + 4 * N * 12 * 128 + 4 * 12 * N * 2 + 4 * n_out
    assert c["flops"] == 2 * 128 * N * 12 * 4 * 64 + 8 * n_out
    # the bytes bind: 1.9 GFLOP is 2 us at 989e12, 88 MB 26 us at 3.35e12
    assert c["least_s"] == pytest.approx(c["bytes"] / 3.35e12)


def test_k1_bytes_davis_demo():
    # maps 50,135,040 + targets 14,745,600 + coords 230,400 + out 22,579,200
    assert costs.k1_cost(12, 2400, 128, SHAPES, 3)["bytes"] == 87_690_240


def test_k1_bytes_sintel():
    # maps 50,135,040 + targets 9,437,184 + coords 147,456 + out 14,450,688
    assert costs.k1_cost(12, 1536, 128, SHAPES, 3)["bytes"] == 74_170_368


@pytest.mark.parametrize("N,flops,nbytes", [
    (2400, 4 * 12 * 8 * 2400 ** 2 * 48, 2 * 12 * 2400 * 1152 + 2 * 12 * 2400 * 384),
    (1536, 4 * 12 * 8 * 1536 ** 2 * 48, 2 * 12 * 1536 * 1152 + 2 * 12 * 1536 * 384),
])
def test_k2_counts_by_hand(N, flops, nbytes):
    c = costs.k2_cost(12, N, 8, 48)
    assert c["flops"] == flops and c["bytes"] == nbytes
    # davis_demo: 106.2 GFLOP (107.3 us at 989e12) against 88.5 MB (26.4 us): operations bind
    assert c["least_s"] == pytest.approx(max(flops / 989e12, nbytes / 3.35e12))


def test_k2_davis_demo_is_bound_by_operations():
    c = costs.k2_cost(12, 2400, 8, 48)
    assert c["flops"] == 106_168_320_000 and c["bytes"] == 88_473_600
    assert c["least_s"] == pytest.approx(106_168_320_000 / 989e12)


@pytest.mark.parametrize("config", ["davis_demo", "sintel"])
@pytest.mark.parametrize("new_frames", [2, 12])
def test_frozen_flops_equal_the_ports(config, new_frames):
    from batrack_tpu_torch.tracker.mdtracker import TrackerParams
    from batrack_tpu_torch.utils.flops import tracker_forward_flops_from_params

    from harness import runner

    conf = json.loads((spec.BENCH_DIR / "configs" / f"{config}.json").read_text())
    cfg = runner.port_config(conf)
    p = TrackerParams.from_config(cfg.model)._replace(static_iters=0)
    N = cfg.slam.S_slam // cfg.slam.kf_stride * cfg.slam.PATCHES_PER_FRAME
    theirs = tracker_forward_flops_from_params(p, N=N, H=p.interp_shape[0], W=p.interp_shape[1],
                                               new_frames=new_frames)["total"]
    assert costs.append_flops(conf["model"], conf["slam"], new_frames) == theirs
