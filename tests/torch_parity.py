"""Helpers shared by the tests/test_torch_*.py parity tests: the same numpy
inputs go through the batrack_tpu function (on the CPU) and its
batrack_tpu_torch counterpart (device='cpu')."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from batrack_tpu.tracker.convert import convert_state_dict
from batrack_tpu_torch.tracker.mdtracker import MDTracker, TrackerParams

# small tracker widths: S=4, 32x48 frames, one block per transformer
DEPTHS = dict(space_depth=1, time_depth=1, space_depth_dyn=1, time_depth_dyn=1)
H, W = 32, 48


def t(x, dtype=None):
    """numpy / jax array -> CPU torch tensor."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def j(x):
    """numpy / torch tensor -> jax array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return jnp.asarray(x)


def npy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(port, ref, atol, rtol=0.0):
    np.testing.assert_allclose(npy(port).astype(np.float64),
                               npy(ref).astype(np.float64), atol=atol, rtol=rtol)


class JaxDraws:
    """The patch generator's random arrays exactly as the JAX BATrack draws
    them: one key split per frame (slam/system.py:237), then one split into
    the x and y uniforms (slam/ingest.py:67-69). Set as BATrack.draw_hook."""

    def __init__(self, seed: int, shape):
        self.key = jax.random.PRNGKey(seed)
        self.shape = shape

    def __call__(self, counter):
        self.key, sub = jax.random.split(self.key)
        kx, ky = jax.random.split(sub)
        return (t(jax.random.uniform(kx, self.shape)),
                t(jax.random.uniform(ky, self.shape)))


def damp_flow_heads(model, scale=0.05):
    """Random weights move a track by tens of pixels per refinement step and
    amplify float32 rounding with it (to ~6e-3 px through the static branch
    at full scale); scaling the flow heads keeps the steps small, as trained
    weights do, so the comparison measures the port and not that gain."""
    with torch.no_grad():
        for uf in (model.updateformer, model.updateformer_dyn):
            uf.flow_head.weight.mul_(scale)
            uf.flow_head.bias.mul_(scale)
    return model


def port_model(seed=0, **kw):
    torch.manual_seed(seed)
    p = TrackerParams(S=4, iters=2, static_iters=1, interp_shape=(H, W), **DEPTHS, **kw)
    return damp_flow_heads(MDTracker(p).eval())


def flax_params(model):
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    conv = convert_state_dict(sd, **DEPTHS)
    return jax.tree.map(jnp.asarray, conv), sd


def window(rng, T):
    win = rng.uniform(0, 255, (T, 4, H, W)).astype(np.float32)
    win[:, 3] = rng.uniform(2, 6, (T, H, W))
    return win


def queries(rng, first):
    n = len(first)
    return np.stack([np.asarray(first, np.float32), rng.uniform(5, W - 5, n),
                     rng.uniform(5, H - 5, n), rng.uniform(2, 6, n)], -1).astype(np.float32)


def perturb_(model, seed, scale=0.02, vec_scale=0.1):
    """Move every parameter off its default init by seeded noise (scale for
    matrices and kernels, vec_scale for vectors: biases, norms, layer
    scales), so that parity tests see no weight at exactly 0 or 1. Returns
    the model."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=g) * (scale if p.dim() > 1 else vec_scale))
    return model
