"""batrack_tpu_torch.ba.solver (the flat edge solver) against batrack_tpu
on tests/test_ba.py's synthetic problem (every patch into every frame,
pose and depth noise, the mono prior, huber), CPU: one Gauss-Newton step
with and without the structure-only pass, the gates (invalid edges, NaN
and corrupted targets), fixed poses, the patch-window offset, the presence
prior, the NaN re-damp and a 4x dual-BA chain. The steps on a SLAM state
and slam_update's flat branch are in test_torch_flat_update.py.

Tolerance: float64 at 1e-9 relative (1e-12 absolute) with JAX under
jax.enable_x64(True), as test_torch_refine does. The pose blocks are
summed with index_add_ where the JAX package multiplies by one-hot
matrices: the same sums in another order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batrack_tpu.ba import BAProblem as JProblem
from batrack_tpu.ba import ba_iteration as jba
from batrack_tpu_torch.ba import BAProblem, ba_iteration
from test_ba import M, N_FRAMES, PATCH_WINDOW, W, make_problem

KW = dict(window=W, patch_window=PATCH_WINDOW, patches_per_frame=M,
          bounds=(0.0, 0.0, 640.0, 360.0), ep=0.01, lmbda=1e-4, alpha=0.05, loss="huber")
INT_FIELDS = ("ii", "jj", "kk")
SCALARS = ("t0", "n", "base_k")


def problem_arrays(dtype=np.float64, seed=0, **noise):
    """tests/test_ba.py's problem as numpy arrays (dict) in `dtype`."""
    prob, _, _, _ = make_problem(np.random.default_rng(seed), alpha=0.05, loss="huber",
                                 **noise)
    return {k: (int(v) if k in SCALARS else
                np.array(v, np.int32 if k in INT_FIELDS else dtype))
            for k, v in prob._asdict().items()}


def port_step(arr, **kw):
    """One port step on the arrays: numpy (poses, patches)."""
    out = ba_iteration(BAProblem(**{k: v if k in SCALARS else torch.from_numpy(v)
                                    for k, v in arr.items()}), **{**KW, **kw})
    return tuple(x.numpy() for x in out)


def jax_step(arr, **kw):
    """One JAX step, jitted (eager op-by-op dispatch takes ~10x longer)."""
    with jax.enable_x64(arr["poses"].dtype == np.float64):
        step = jax.jit(functools.partial(jba, **{**KW, **kw}))
        ref = step(JProblem(**{k: jnp.asarray(v) for k, v in arr.items()}))
        return tuple(np.asarray(x) for x in ref)


def run_both(arr, **kw):
    """One step of each package on the same arrays: (port, jax)."""
    return port_step(arr, **kw), jax_step(arr, **kw)


def close64(port, ref):
    np.testing.assert_allclose(port, ref, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("structure_only", [False, True])
def test_flat_step_matches_jax_float64(structure_only):
    arr = problem_arrays(pose_noise=0.02, depth_noise=0.2)
    (poses, patches), (rp, rq) = run_both(arr, structure_only=structure_only)
    assert poses.dtype == np.float64
    close64(poses, rp)
    close64(patches, rq)
    if structure_only:
        np.testing.assert_array_equal(poses, arr["poses"])
    else:
        assert np.abs(rp - arr["poses"]).max() > 1e-4  # the step moved the poses


def _invalid_edges(arr):
    """Half the edges invalid, their targets corrupted (30 px) or NaN."""
    E = arr["targets"].shape[0]
    bad = np.arange(E) % 2 == 0
    arr["targets"][bad] += 30.0
    arr["targets"][np.arange(E) % 6 == 0] = np.nan
    arr["valid"] = arr["valid"] * (1.0 - bad)
    return arr


def _fixed_poses(arr):
    arr["t0"] = 3
    return arr


def _window_offset(arr):
    arr["base_k"] = 2 * M
    return arr


def _gated_patch(arr):
    """Every edge of patches 0..M-1 of frame 1 fails the flow gate (300 px)
    but stays present: the presence prior must still move those patches."""
    sel = (arr["kk"] >= M) & (arr["kk"] < 2 * M)
    arr["targets"][sel] += 300.0
    return arr


@pytest.mark.parametrize("case", [_invalid_edges, _fixed_poses, _window_offset, _gated_patch],
                         ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize("structure_only", [False, True])
def test_flat_step_cases_match_jax(case, structure_only):
    """The gates, fixed poses, the patch-window offset and the presence
    prior, float64 at 1e-9, plus what each case implies on its own."""
    base = problem_arrays(pose_noise=0.02, depth_noise=0.2)
    arr = case({k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in base.items()})
    (poses, patches), (rp, rq) = run_both(arr, structure_only=structure_only)
    close64(poses, rp)
    close64(patches, rq)
    assert np.isfinite(poses).all() and np.isfinite(patches).all()
    if case is _fixed_poses:  # test_ba.py's bar: retr renormalises the quaternions
        np.testing.assert_allclose(poses[:3], arr["poses"][:3], atol=1e-7)
    if case is _window_offset:
        np.testing.assert_array_equal(patches[:2 * M, 2],
                                      np.clip(arr["patches"][:2 * M, 2], 1e-3, 10.0))
    if case is _gated_patch:
        d0, d1 = arr["patches"][M:2 * M, 2], patches[M:2 * M, 2]
        prior = arr["monodisp"][M:2 * M]
        # C = 0 for these patches: dZ = -alpha/(alpha+lmbda) (d - d_mono)
        assert np.abs(d1 - d0).max() > 1e-3
        assert (np.abs(d1 - prior) < np.abs(d0 - prior)).all()


def test_flat_step_redamps_like_jax():
    """A system whose first damping is not positive definite: JAX's
    cho_factor gives NaN and the step re-solves at lm * 10; the port's
    cholesky_ex must take the same branch. ep is searched on the port
    side for a value where the first solve fails and the second does not
    (the step then equals the step at lm * 10 exactly), then held to JAX.
    window=7 makes every pose row of the system free (t0=1, n=8): an
    unused row would hold ep alone and fail at any damping."""
    arr = problem_arrays(pose_noise=0.02, depth_noise=0.2)
    lm, win = 1.0, N_FRAMES - 1
    chosen = None
    for ep in -np.geomspace(1e-2, 1e6, 60):
        p1, _ = port_step(arr, window=win, ep=float(ep), lm=lm)
        p10, _ = port_step(arr, window=win, ep=float(ep), lm=lm * 10.0)
        p_small, _ = port_step(arr, window=win, ep=float(ep), lm=lm * 1e-3)
        if (np.isfinite(p1).all() and np.array_equal(p1, p10)
                and not np.isfinite(p_small).all()):
            chosen = float(ep)
            break
    assert chosen is not None, "no ep makes the first solve fail and the retry succeed"
    (poses, patches), (rp, rq) = run_both(arr, window=win, ep=chosen, lm=lm)
    close64(poses, rp)
    close64(patches, rq)


def test_flat_dual_ba_chain_float64():
    """4 x (pose step with all weights, structure-only step), float64."""
    arr = problem_arrays(pose_noise=0.02, depth_noise=0.2)
    pp, jp = arr["poses"], arr["poses"]
    pq, jq = arr["patches"], arr["patches"]
    for _ in range(4):
        for so in (False, True):
            pp, pq = port_step({**arr, "poses": pp, "patches": pq}, structure_only=so)
            jp, jq = jax_step({**arr, "poses": jp, "patches": jq}, structure_only=so)
    close64(pp, jp)
    close64(pq, jq)


@pytest.mark.parametrize("acc", [None, torch.float64])
def test_segment_sum_pairs_drop_and_accumulate(acc):
    """segment_sum, the one bucket-sum helper of both solvers: every (ids,
    values) pair lands in one buffer, id == size is dropped, the sum runs in
    `acc` and comes back in the values' dtype."""
    from batrack_tpu_torch.ba.solver import segment_sum

    rng = np.random.default_rng(0)
    size = 5
    ids = [torch.from_numpy(rng.integers(0, size + 1, 40)) for _ in range(2)]
    vals = [torch.from_numpy(rng.standard_normal((40, 3)).astype(np.float32)) for _ in range(2)]
    out = segment_sum(size, ids[0], vals[0], ids[1], vals[1], acc=acc)
    ref = np.zeros((size + 1, 3))
    for i, v in zip(ids, vals):
        np.add.at(ref, i.numpy(), v.numpy().astype(np.float64))
    assert out.dtype == torch.float32 and out.shape == (size, 3)
    np.testing.assert_allclose(out.numpy(), ref[:size], rtol=1e-5, atol=1e-5)
