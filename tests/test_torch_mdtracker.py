"""Full MDTracker forward of batrack_tpu_torch against batrack_tpu with the
weights carried across (float32, CPU, small widths; flow heads damped, see
torch_parity.damp_flow_heads). Tolerances: tracks, depths and static
tracks 1e-3 (pixels / metres), visibility and dynamic probability 1e-4."""

import jax
import numpy as np
import pytest
import torch

from batrack_tpu.tracker import mdtracker as jmd
from torch_parity import DEPTHS, H, W, assert_close, flax_params, j, port_model, queries, t, window


@pytest.mark.parametrize("T,first", [(4, [0, 0, 2, 1, 0, 2]),
                                     (8, [0, 0, 1, 4, 6, 3])])
def test_mdtracker_matches_jax(rng, T, first):
    """Full forward: one window (T=4) and two windows with late-appearing
    queries (T=8: key mask, scrambled concat over the active tracks,
    window hand-off)."""
    model = port_model()
    params, _ = flax_params(model)
    win, q = window(rng, T), queries(rng, first)
    with torch.no_grad():
        out = model(t(win), t(q))
    jp = jmd.TrackerParams(S=4, iters=2, static_iters=1, interp_shape=(H, W), **DEPTHS)
    ref = jax.jit(jmd.MDTracker(jp).apply)(params, j(win), j(q))
    for k, tol in enumerate([1e-3, 1e-3, 1e-3, 1e-4, 1e-4]):
        assert_close(out[k], ref[k], atol=tol)
    assert_close(out[5], np.moveaxis(np.asarray(ref[5]), -1, 1), atol=1e-3)


def test_mdtracker_fmap_reuse_matches_jax(rng):
    """Cross-append feature reuse: the first window takes prev_fmaps
    shifted by `reuse` frames and encodes only the new ones."""
    model = port_model()
    params, _ = flax_params(model)
    win, q = window(rng, 4), queries(rng, [0, 2, 0, 2])
    with torch.no_grad():
        prev = model(t(win), t(q))[5]
        win2 = np.concatenate([win[2:], window(rng, 2)])
        out = model(t(win2), t(q), prev, 2)
    jp = jmd.TrackerParams(S=4, iters=2, static_iters=1, interp_shape=(H, W), **DEPTHS)
    apply = jax.jit(jmd.MDTracker(jp).apply, static_argnums=4)
    jprev = apply(params, j(win), j(q))[5]
    ref = apply(params, j(win2), j(q), jprev, 2)
    assert_close(out[0], ref[0], atol=1e-3)
    assert_close(out[3], ref[3], atol=1e-4)

