"""batrack_tpu_torch.slam.OracleTracker against batrack_tpu's on the same
tracker input: the plane scene of tests/test_slam_e2e.py (48x64, true
depth maps in the window), 40 queries over 4 window frames whose global
counters skip (as after a keyframe removal). Without noise, with JAX's
pixel noise injected through `noise_hook` (torch cannot reproduce
jax.random.normal), and with a moving object (dynamic_velocity inside a
region). Tolerance 1e-4 px on the tracks, 1e-5 on depths; visibility and
the dynamic labels exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batrack_tpu.slam import OracleTracker as JOracle
from batrack_tpu.slam import StaticDims as JDims
from batrack_tpu.slam.frontend import TrackerInput as JInput
from batrack_tpu_torch.slam import OracleTracker
from batrack_tpu_torch.slam.frontend import TrackerInput
from batrack_tpu_torch.slam.state import StaticDims
from test_slam_e2e import HT, INTR, WD, gt_trajectory, plane_depth, small_config
from test_torch_slam import _port_cfg
from torch_parity import assert_close, t

NQ = 40
VELOCITY = np.array([0.05, -0.02, 0.01], np.float32)


def tracker_input(rng):
    """numpy fields of one tracker input on the plane scene."""
    poses = gt_trajectory(12)
    tst = np.array([3, 5, 6, 9], np.int32)  # global counters of the window slots
    depth = np.stack([plane_depth(poses[k]) for k in tst])
    rgb = rng.uniform(0, 255, (4, 3, HT, WD)).astype(np.float32)
    q = np.stack([rng.integers(0, 4, NQ).astype(np.float32), rng.uniform(2, WD - 2, NQ),
                  rng.uniform(2, HT - 2, NQ), rng.uniform(3, 6, NQ)], -1).astype(np.float32)
    return poses, dict(window_rgbd=np.concatenate([rgb, depth[:, None]], 1), queries=q,
                       query_valid=np.ones(NQ, bool), win_tstamps=tst)


class JaxNoise:
    """The oracle's draws exactly as the JAX OracleTracker takes them: one
    key split per call, then one split of the subkey (slam/oracle.py)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, shape):
        self.key, sub = jax.random.split(self.key)
        k1, _ = jax.random.split(sub)
        return t(jax.random.normal(k1, shape))


def region(xyz):
    return xyz[:, 0] > 0.5


@pytest.mark.parametrize("kind", ["exact", "noise", "dynamic"])
def test_oracle_matches_jax(kind):
    rng = np.random.default_rng(7)
    poses, fields = tracker_input(rng)
    cfg = small_config()
    jdims = JDims.from_config(cfg, HT, WD)
    dims = StaticDims.from_config(_port_cfg(cfg), HT, WD)
    kw = dict(noise=0.3 if kind == "noise" else 0.0, seed=4)
    jkw, pkw = dict(kw), dict(kw)
    if kind == "dynamic":
        jkw.update(dynamic_velocity=VELOCITY, dynamic_region=region)
        pkw.update(dynamic_velocity=VELOCITY, dynamic_region=region)
    jor = JOracle(poses, INTR, jdims, **jkw)
    por = OracleTracker(poses, INTR, dims, device="cpu", **pkw)
    if kind == "noise":
        por.noise_hook = JaxNoise(4)
    jin = JInput(win_start=jnp.asarray(0), **{k: jnp.asarray(v) for k, v in fields.items()})
    pin = TrackerInput(win_start=0, **{k: t(v) for k, v in fields.items()})
    for _ in range(2):  # the second call takes the second draw
        ref, out = jor(jin), por(pin)
        assert_close(out.tracks, ref.tracks, atol=1e-4)
        assert_close(out.depths, ref.depths, atol=1e-5)
        np.testing.assert_array_equal(out.vis.numpy(), np.asarray(ref.vis))
        np.testing.assert_array_equal(out.dynamic.numpy(), np.asarray(ref.dynamic))
    assert float(out.vis.mean()) > 0.5
    if kind == "dynamic":
        assert 0 < float(out.dynamic[0].mean()) < 1


def test_oracle_noise_from_generator():
    """Without a hook the noise comes from the tracker's torch.Generator:
    seeded, so two trackers agree, and of the configured scale."""
    rng = np.random.default_rng(7)
    poses, fields = tracker_input(rng)
    dims = StaticDims.from_config(_port_cfg(small_config()), HT, WD)
    pin = TrackerInput(win_start=0, **{k: t(v) for k, v in fields.items()})
    exact = OracleTracker(poses, INTR, dims, device="cpu")(pin).tracks
    a = OracleTracker(poses, INTR, dims, noise=0.3, seed=2, device="cpu")(pin).tracks
    b = OracleTracker(poses, INTR, dims, noise=0.3, seed=2, device="cpu")(pin).tracks
    assert torch.equal(a, b)
    assert 0.2 < float((a - exact).std()) < 0.4
