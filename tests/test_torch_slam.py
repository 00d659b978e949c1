"""The frame stages of batrack_tpu_torch's sparse-SLAM slice against
batrack_tpu on the same inputs: patch generators (JAX's random draws
injected), ingest_frame, build_tracker_input and gate_and_append.

Scene and SLAM config: tests/test_slam_e2e.py (48x64 plane scene,
small_config()). Tolerance 1e-5; patch coordinates exact. The whole loop
is in test_torch_slice.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batrack_tpu.slam import BATrack as JBATrack
from batrack_tpu.slam import frontend as jfront
from batrack_tpu.slam import ingest as jingest
from batrack_tpu.slam import OracleTracker, StaticDims as JDims
from batrack_tpu_torch.slam import BATrack, frontend, ingest
from batrack_tpu_torch.slam.state import SLAMState, StaticDims, init_state
from batrack_tpu_torch.utils.config import Config
from test_slam_e2e import HT, INTR, WD, gt_trajectory, plane_depth, small_config
from torch_parity import assert_close, t


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(3)
    poses = gt_trajectory(16)
    depths = np.stack([plane_depth(p) for p in poses])
    images = rng.uniform(0, 255, size=(16, HT, WD, 3)).astype(np.float32)
    return poses, depths, images


def _port_cfg(jcfg):
    cfg = Config()
    for k, v in vars(jcfg.slam).items():
        setattr(cfg.slam, k, v)
    return cfg


def test_grid_grad_patches_match_jax(scene):
    """Same uniforms -> same rounded candidates and the same stable top-k
    (ties between rounded candidates are frequent)."""
    _, _, images = scene
    key = jax.random.PRNGKey(5)
    kx, ky = jax.random.split(key)
    shape = (16, 8)
    img = images[0].round()
    ref = jingest.generate_patches_grid_grad(jnp.asarray(img), key, grid_size=4, M=16,
                                             ht=HT, wd=WD)
    draws = (t(jax.random.uniform(kx, shape)), t(jax.random.uniform(ky, shape)))
    out = ingest.generate_patches_grid_grad(t(img), draws, grid_size=4, M=16, ht=HT, wd=WD)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("patch_gen", ["random", "uniform"])
def test_other_patch_generators_match_jax(scene, patch_gen):
    """ingest_frame with the `random` (JAX's randint draws injected) and
    `uniform` generators, from an empty state."""
    _, depths, images = scene
    jcfg = small_config()
    jcfg.slam.PATCHES_PER_FRAME = 20  # not a square: `uniform` repeats its grid
    jdims = JDims.from_config(jcfg, HT, WD)
    cfg = _port_cfg(jcfg)
    dims = StaticDims.from_config(cfg, HT, WD)
    key = jax.random.PRNGKey(4)
    kx, ky = jax.random.split(key)
    draws = None
    if patch_gen == "random":
        draws = (t(jax.random.randint(kx, (20,), 1, WD - 1)),
                 t(jax.random.randint(ky, (20,), 1, HT - 1)))
    jst, jcoords = jingest.ingest_frame(
        JBATrack(jcfg, HT, WD).state, jnp.asarray(images[0]), jnp.asarray(depths[0]),
        jnp.asarray(INTR), 0, 0, key, jdims, patch_gen=patch_gen, motion_damping=0.5,
        mark_valid=jnp.asarray(True))
    state = init_state(cfg, HT, WD, "cpu")
    coords = ingest.ingest_frame(state, t(images[0]), t(depths[0]), t(INTR), 0, 0, dims,
                                 patch_gen=patch_gen, motion_damping=0.5, mark_valid=True,
                                 draws=draws)
    np.testing.assert_array_equal(coords.numpy(), np.asarray(jcoords))
    for f in ("patches", "patches_valid", "colors"):
        assert_close(getattr(state, f), getattr(jst, f), atol=1e-5)


def test_frame_stages_match_jax(scene):
    """ingest_frame, build_tracker_input and gate_and_append on a JAX
    mid-sequence state with oracle tracker outputs."""
    poses_gt, depths, images = scene
    jcfg = small_config()
    jdims = JDims.from_config(jcfg, HT, WD)
    slam = JBATrack(jcfg, HT, WD, seed=0)
    oracle = OracleTracker(poses_gt, INTR, jdims, noise=0.3)
    slam.tracker = oracle
    for i in range(9):
        slam(i, images[i], depths[i], INTR)
    n = slam.n
    st = {f: np.array(getattr(slam.state, f)) for f in slam.state._fields}
    cfg = _port_cfg(jcfg)
    dims = StaticDims.from_config(cfg, HT, WD)

    key = jax.random.PRNGKey(11)
    kx, ky = jax.random.split(key)
    img = images[9].astype(np.uint8)
    # eager, as the port runs: under jit XLA may fuse the candidate's
    # scale-and-offset into one FMA and round an exact .5 the other way
    jst, jcoords = jingest.ingest_frame(
        slam.state, jnp.asarray(img), jnp.asarray(depths[9]), jnp.asarray(INTR), n, 9, key,
        jdims, patch_gen="grid_grad_4", motion_damping=0.5, mark_valid=jnp.asarray(False))
    state = SLAMState(**{k: t(v) for k, v in st.items()})
    draws = (t(jax.random.uniform(kx, (16, 8))), t(jax.random.uniform(ky, (16, 8))))
    coords = ingest.ingest_frame(state, t(img), t(depths[9]), t(INTR), n, 9, dims,
                                 patch_gen="grid_grad_4", motion_damping=0.5,
                                 mark_valid=False, draws=draws)
    np.testing.assert_array_equal(coords.numpy(), np.asarray(jcoords))
    for f in ("patches", "colors", "poses", "win_images", "win_depths", "tstamps"):
        assert_close(getattr(state, f), getattr(jst, f), atol=1e-5)

    n += 1
    jtin = jax.jit(functools.partial(jfront.build_tracker_input, dims=jdims))(jst, jnp.asarray(n))
    tin = frontend.build_tracker_input(state, n, dims)
    for a, b in zip(tin, jtin):
        assert_close(a if isinstance(a, torch.Tensor) else np.asarray(a), b, atol=1e-5)

    jtout = oracle(jtin)
    tout = frontend.TrackerOutput(*[t(x) for x in jtout])
    kw = dict(vis_threshold=0.9, static_threshold=0.1, static_quantile=0.0,
              min_track_len=2, boundary_padding=2)
    ref = jax.jit(functools.partial(jfront.gate_and_append, dims=jdims, **kw))(
        jst, jtin, jtout, jnp.asarray(n), jnp.asarray(1))
    frontend.gate_and_append(state, tin, tout, n, 1, dims, **kw)
    for f in SLAMState.__dataclass_fields__:
        assert_close(getattr(state, f), getattr(ref, f), atol=1e-5)


def test_ring_slot_allocator_matches_jax():
    """BATrack._alloc_slot on the same append history, including stalls
    (the frame count stops while appends continue) that push the ring over
    capacity and make it overwrite the oldest live slot."""
    jcfg = small_config()
    jslam = JBATrack(jcfg, HT, WD, seed=0)
    slam = BATrack(_port_cfg(jcfg), HT, WD, seed=0, device="cpu")
    history = [1 + 2 * k for k in range(12)] + [23] * 8 + [25 + 2 * k for k in range(10)]
    for n in history:
        picked = []
        for s in (jslam, slam):
            s.n = n
            picked.append(s._alloc_slot())
            s.append_count += 1
        assert picked[0] == picked[1], n
    assert slam.ring_overflow_count == jslam.ring_overflow_count > 0
    assert slam._slot_info == jslam._slot_info

