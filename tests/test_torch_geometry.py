"""batrack_tpu_torch.geometry against batrack_tpu.geometry on the same
inputs (float32, CPU). Tolerance 1e-5, relative where values are large
(Jacobian entries scale with the focal length)."""

import jax.numpy as jnp
import numpy as np
import pytest

from batrack_tpu.geometry import projective as jproj
from batrack_tpu.geometry import se3 as jse3
from batrack_tpu_torch.geometry import projective, se3
from torch_parity import assert_close, j, t


def _poses(rng, n, scale=0.5):
    xi = rng.normal(size=(n, 6)).astype(np.float32) * scale
    return np.asarray(jse3.exp(jnp.asarray(xi))), xi


@pytest.mark.parametrize("op", ["exp", "log", "inv", "mul", "act4", "matrix", "retr"])
def test_se3_matches_jax(rng, op):
    g, xi = _poses(rng, 64)
    g2, xi2 = _poses(rng, 64, 0.3)
    p4 = rng.normal(size=(64, 4)).astype(np.float32)
    if op == "exp":
        port, ref = se3.exp(t(xi)), jse3.exp(j(xi))
    elif op == "log":
        port, ref = se3.log(t(g)), jse3.log(j(g))
    elif op == "inv":
        port, ref = se3.inv(t(g)), jse3.inv(j(g))
    elif op == "mul":
        port, ref = se3.mul(t(g), t(g2)), jse3.mul(j(g), j(g2))
    elif op == "act4":
        port, ref = se3.act4(t(g), t(p4)), jse3.act4(j(g), j(p4))
    elif op == "matrix":
        port, ref = se3.matrix(t(g)), jse3.matrix(j(g))
    else:
        port, ref = se3.retr(t(g), t(xi2)), jse3.retr(j(g), j(xi2))
    assert_close(port, ref, atol=1e-5)


def test_se3_small_angle_branches(rng):
    """Taylor branches (|phi|^2 < 1e-6) agree with the JAX package."""
    xi = rng.normal(size=(32, 6)).astype(np.float32) * 1e-4
    assert_close(se3.exp(t(xi)), jse3.exp(j(xi)), atol=1e-6)
    g = np.asarray(jse3.exp(j(xi)))
    assert_close(se3.log(t(g)), jse3.log(j(g)), atol=1e-6)


def test_transform_and_jacobians_match_jax(rng):
    N, K, E = 6, 40, 80
    poses, _ = _poses(rng, N, 0.2)
    patches = np.concatenate([rng.uniform(5, 60, (K, 2)), rng.uniform(0.2, 1.0, (K, 1))],
                             -1).astype(np.float32)
    intr = np.tile(np.array([60, 60, 32, 24], np.float32), (N, 1))
    ii, jj, kk = rng.integers(0, N, E), rng.integers(0, N, E), rng.integers(0, K, E)
    ref = jproj.transform(j(poses), j(patches), j(intr), j(ii), j(jj), j(kk), jacobian=True)
    out = projective.transform(t(poses), t(patches), t(intr), t(ii), t(jj), t(kk),
                               jacobian=True)
    assert_close(out[0], ref[0], atol=1e-5, rtol=1e-5)
    assert_close(out[1], ref[1], atol=0)
    for a, b in zip(out[2], ref[2]):
        assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_point_cloud_and_proj_match_jax(rng):
    N, K = 5, 30
    poses, _ = _poses(rng, N, 0.2)
    patches = np.concatenate([rng.uniform(5, 60, (K, 2)), rng.uniform(0.2, 1.0, (K, 1))],
                             -1).astype(np.float32)
    intr = np.tile(np.array([60, 60, 32, 24], np.float32), (N, 1))
    ix = rng.integers(0, N, K)
    P = projective.point_cloud(t(poses), t(patches), t(intr), t(ix))
    Pj = jproj.point_cloud(j(poses), j(patches), j(intr), j(ix))
    assert_close(P, Pj, atol=1e-5, rtol=1e-5)
    X = rng.normal(size=(K, 4)).astype(np.float32) + np.array([0, 0, 3, 0], np.float32)
    assert_close(projective.proj(t(X), t(intr[ix]), depth=True),
                 jproj.proj(j(X), j(intr[ix]), depth=True), atol=1e-5, rtol=1e-5)
